"""The rest of the port's data layer against the JAX package's on the CPU:
`ElasticResolution`, the oracle-video and codec providers (byte-identical
batches on generated frame trees), the matrix bicubic (`resize_matrix` bit
for bit, `resize_bicubic` and `downscale` atol 1e-6: float32 matmuls in
another order), and the native C++ loader (the port builds csrc/loader into
build/native/; its decode, resize and batches equal the JAX binding's).
The native tests skip only where the JAX package's own library is not
available."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ofa_sr_tpu.data import bicubic as jbic
from ofa_sr_tpu.data import native as jnative
from ofa_sr_tpu.data import providers as jprov
from ofa_sr_tpu_torch.data import bicubic as tbic
from ofa_sr_tpu_torch.data import native as tnative
from ofa_sr_tpu_torch.data import providers as tprov
from test_torch_data import _assert_loaders_equal


def _png(path, h, w, seed):
    rng = np.random.RandomState(seed)
    Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(path)


@pytest.fixture(scope="module")
def video_tree(tmp_path_factory):
    """<root>/{train,val}: frames named 1.png ... 12.png (numeric order is
    not lexical order), two sizes."""
    root = tmp_path_factory.mktemp("video")
    for split, n in (("train", 12), ("val", 3)):
        os.makedirs(root / split)
        for i in range(1, n + 1):
            _png(root / split / ("%d.png" % i), 40 if i % 2 else 44, 52, i)
    return str(root)


@pytest.fixture(scope="module")
def codec_tree(tmp_path_factory):
    """<root>/{train,val}/{image,label}: LR frames at half the HR size."""
    root = tmp_path_factory.mktemp("codec")
    for split, n in (("train", 10), ("val", 2)):
        for sub, size in (("image", (12, 16)), ("label", (24, 32))):
            os.makedirs(root / split / sub)
            for i in range(1, n + 1):
                _png(root / split / sub / ("%d.png" % i), *size, seed=100 * i + size[0])
    return str(root)


def test_elastic_resolution_matches_jax():
    for kw in (dict(image_size_list=[128, 160, 192, 224]), dict(image_size_list=160),
               dict(image_size_list=[128, 140], continuous=True)):
        t, j = tprov.ElasticResolution(**kw), jprov.ElasticResolution(**kw)
        assert t.candidates() == j.candidates()
        assert [t.sample(b, e) for b in range(30) for e in (0, 3, 17)] == \
            [j.sample(b, e) for b in range(30) for e in (0, 3, 17)]
    assert tprov.int2(5) == jprov.int2(5) == [5] and tprov.int2((1, 2)) == [1, 2]


@pytest.mark.parametrize("kw", [dict(), dict(valid_size=3, num_workers=3),
                                dict(num_replicas=2, rank=1)])
def test_oracle_video_provider_matches_jax(video_tree, kw):
    """CenterCrop train and valid frames in numeric order, their PIL x2 / x4,
    shuffled and rank-strided train batches, the valid split and the
    calibration subset."""
    kw = dict(dict(image_size=32, train_batch_size=3, num_workers=1), **kw)
    t, j = tprov.OracleVideoProvider(video_tree, **kw), jprov.OracleVideoProvider(video_tree, **kw)
    assert t._train_ds.paths == j._train_ds.paths
    assert os.path.basename(t._train_ds.paths[1]) == "2.png"
    _assert_loaders_equal(t.train, j.train)
    _assert_loaders_equal(t.valid, j.valid, n=1)
    _assert_loaders_equal(t.test, j.test, n=1)
    _assert_loaders_equal(t.build_sub_train_loader(4, 2), j.build_sub_train_loader(4, 2), n=1)
    assert t.name() == j.name() and t.DEFAULT_PATH == j.DEFAULT_PATH


def test_codec_provider_matches_jax(codec_tree):
    """Paired LR/HR frames, numerically sorted, no transform: "lr" and the
    matching "x2"."""
    kw = dict(image_size=32, train_batch_size=4, num_workers=2)
    t = tprov.CodecDecoderProvider(codec_tree, **kw)
    j = jprov.CodecDecoderProvider(codec_tree, **kw)
    _assert_loaders_equal(t.train, j.train)
    _assert_loaders_equal(t.test, j.test, n=1)
    assert sorted(next(iter(t.train))) == ["image", "lr", "x2"]
    assert t.name() == j.name() and t.DEFAULT_PATH == j.DEFAULT_PATH


def test_default_paths_are_the_jax_packages():
    for name in ("Div2KSetXXProvider", "OracleVideoProvider", "CodecDecoderProvider"):
        assert getattr(tprov, name).DEFAULT_PATH == getattr(jprov, name).DEFAULT_PATH


@pytest.mark.parametrize("sizes", [(96, 48), (48, 96), (37, 12), (720, 360), (5, 5)])
def test_resize_matrix_bit_equal(sizes):
    t, j = tbic.resize_matrix(*sizes), jbic.resize_matrix(*sizes)
    assert t.dtype == j.dtype == np.float32 and np.array_equal(t, j)


def test_resize_bicubic_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(2, 48, 40, 3).astype(np.float32)
    for oh, ow in ((24, 20), (96, 80), (17, 33)):
        np.testing.assert_allclose(tbic.resize_bicubic(torch.from_numpy(x), oh, ow).numpy(),
                                   np.asarray(jbic.resize_bicubic(jnp.asarray(x), oh, ow)),
                                   rtol=0, atol=1e-6)
    hwc = x[0]
    got = tbic.resize_bicubic(torch.from_numpy(hwc), 24, 20)
    assert got.shape == (24, 20, 3)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jbic.resize_bicubic(jnp.asarray(hwc), 24, 20)), rtol=0, atol=1e-6)
    for f in (2, 4):
        np.testing.assert_allclose(tbic.downscale(torch.from_numpy(x), f).numpy(),
                                   np.asarray(jbic.downscale(jnp.asarray(x), f)), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def native_ok():
    if not jnative.native_available():
        pytest.skip("the JAX package's native loader is not available here")
    assert tnative.native_available()
    lib = tnative._lib_path()
    assert lib.startswith(tnative.BUILD_DIR + os.sep) and os.path.isfile(lib)
    return lib


def test_native_decode_and_resize_match_jax(native_ok, tmp_path):
    for i, (h, w) in enumerate(((29, 37), (16, 16))):
        p = str(tmp_path / ("%d.png" % i))
        _png(p, h, w, i)
        got, ref = tnative.decode_image(p), jnative.decode_image(p)
        assert got.dtype == np.float32 and np.array_equal(got, ref)
    jpg = str(tmp_path / "a.jpg")
    Image.fromarray((np.random.RandomState(5).rand(20, 24, 3) * 255).astype(np.uint8)).save(jpg)
    assert np.array_equal(tnative.decode_image(jpg), jnative.decode_image(jpg))
    with pytest.raises(IOError):
        tnative.decode_image(str(tmp_path / "missing.png"))
    src = np.random.RandomState(2).rand(48, 64, 3).astype(np.float32)
    for dh, dw in ((24, 32), (12, 16), (50, 70)):
        assert np.array_equal(tnative.resize_bicubic(src, dh, dw),
                              jnative.resize_bicubic(src, dh, dw))
    np.testing.assert_allclose(tnative.resize_bicubic(src, 24, 32),
                               tbic.resize_bicubic(torch.from_numpy(src), 24, 32).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_native_loader_matches_jax(native_ok, tmp_path):
    paths = []
    for i in range(9):
        paths.append(str(tmp_path / ("img%d.png" % i)))
        _png(paths[-1], 60, 70, i)
    for bs in (4, 3):
        t = tnative.NativeSRLoader(paths, crop=32, batch_size=bs, n_threads=2)
        j = jnative.NativeSRLoader(paths, crop=32, batch_size=bs, n_threads=2)
        assert len(t) == len(j)
        for epoch in (0, 1):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            tb, jb = list(t), list(j)
            assert len(tb) == len(jb) == len(t)
            for a, b in zip(tb, jb):
                assert sorted(a) == sorted(b) == ["image", "x2", "x4"]
                assert all(np.array_equal(a[k], b[k]) for k in a)
        t.close()


def test_div2k_native_provider_matches_jax(native_ok, tmp_path):
    """Div2KSetXXProvider(use_native=True): the train loader is the native
    one, with the JAX package's batches; valid and test stay on PIL."""
    for split, n in (("train", 6), ("val", 2)):
        os.makedirs(tmp_path / split)
        for i in range(n):
            _png(tmp_path / split / ("%d.png" % i), 40, 48, 10 * i)
    kw = dict(image_size=16, train_batch_size=2, num_workers=2, use_native=True)
    t = tprov.Div2KSetXXProvider(str(tmp_path), **kw)
    j = jprov.Div2KSetXXProvider(str(tmp_path), **kw)
    assert isinstance(t.train, tnative.NativeSRLoader)
    assert isinstance(j.train, jnative.NativeSRLoader)
    _assert_loaders_equal(t.train, j.train)
    _assert_loaders_equal(t.test, j.test, n=1)


def test_native_build_failure_is_reported(monkeypatch, tmp_path):
    """Where the library cannot be built, the provider raises with the
    compiler's report (the JAX package falls back to PIL silently)."""
    for split in ("train", "val"):
        os.makedirs(tmp_path / split)
        _png(tmp_path / split / "0.png", 20, 20, 0)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_ERROR", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS + ["-DOFA_NO_SUCH", "-include",
                                                                   "no_such_header.h"])
    with pytest.raises(RuntimeError, match="no_such_header"):
        tprov.Div2KSetXXProvider(str(tmp_path), image_size=8, use_native=True)
    assert not tnative.native_available()
