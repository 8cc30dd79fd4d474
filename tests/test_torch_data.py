"""The port's data path (ofa_sr_tpu_torch/data) against the JAX package's
on the same seeds: every transform draws the same crop, flip and angle; the
synthetic and folder providers give byte-identical numpy batches for two
epochs with shuffling, rank striding over two replicas, drop_last, the
valid split and the BN-calibration subset. Folder data is PNGs written to
tmp_path with PIL; no dataset is downloaded."""

import os
import random

import numpy as np
import pytest
from PIL import Image

from ofa_sr_tpu.data import datasets as jds
from ofa_sr_tpu.data import providers as jprov
from ofa_sr_tpu.data import transforms as jtf
from ofa_sr_tpu_torch.data import datasets as tds
from ofa_sr_tpu_torch.data import providers as tprov
from ofa_sr_tpu_torch.data import transforms as ttf


def _image(seed, w=37, h=29):
    return Image.fromarray(np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8))


def _assert_batches_equal(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
            assert np.array_equal(g[k], r[k]), k


_TRANSFORMS = {
    "RandomCrop": lambda m: m.RandomCrop(16),
    "RandomHorizontalFlip": lambda m: m.RandomHorizontalFlip(),
    "RandomRotation": lambda m: m.RandomRotation(90),
    "CenterCrop": lambda m: m.CenterCrop(15),
    "ModCrop": lambda m: m.ModCrop(4),
    "NineRandomCrop": lambda m: m.NineRandomCrop(12),
    "NineRandomCrop_top_row": lambda m: m.NineRandomCrop(12, full_grid=False),
    "EntropyCrop": lambda m: m.EntropyCrop(10),
    "Scale": lambda m: m.Scale(0.5),
    "Compose": lambda m: m.Compose([m.RandomCrop(20), m.RandomHorizontalFlip(),
                                    m.RandomRotation(90), m.ModCrop(4)]),
}


@pytest.mark.parametrize("name", sorted(_TRANSFORMS))
def test_transform_matches_jax(name):
    """Eight draws per transform, each from its own seed: the same pixels,
    and the generator left in the same state."""
    for seed in range(8):
        img = _image(seed)
        outs = []
        for mod in (jtf, ttf):
            t = _TRANSFORMS[name](mod)
            rng = random.Random(seed)
            wants = isinstance(t, (mod.Compose, mod.RandomCrop, mod.RandomHorizontalFlip,
                                   mod.RandomRotation, mod.NineRandomCrop))
            out = t(img, rng) if wants else t(img)
            outs.append((np.asarray(out), rng.random()))
        assert np.array_equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]


def test_bicubic_and_to_numpy_match_jax():
    img = _image(3, 48, 40)
    for f in (2, 4):
        a, b = jtf.bicubic_downscale_pil(img, f), ttf.bicubic_downscale_pil(img, f)
        assert a.size == b.size == (48 // f, 40 // f)
        assert np.array_equal(ttf.to_numpy(b), jtf.to_numpy(a))
    assert ttf.to_numpy(img).dtype == np.float32


def test_synthetic_dataset_matches_jax():
    for seed, index in ((0, 0), (0, 5), (3, 1)):
        ref = jds.SyntheticSRDataset(8, 24, seed)[index]
        got = tds.SyntheticSRDataset(8, 24, seed)[index]
        _assert_batches_equal([got], [ref])


def test_split_indices_match_jax():
    assert tprov._valid_split_indices(50, 7) == jprov._valid_split_indices(50, 7)
    assert tprov._sub_sample_indices(50, 9) == jprov._sub_sample_indices(50, 9)
    assert tprov.DataProvider.SUB_SEED == jprov.DataProvider.SUB_SEED
    assert tprov.DataProvider.VALID_SEED == jprov.DataProvider.VALID_SEED


def _epochs(loader, n=2):
    out = []
    for epoch in range(n):
        loader.set_epoch(epoch)
        out.append((len(loader), list(loader)))
    return out


def _assert_loaders_equal(got, ref, n=2):
    for (gn, gb), (rn, rb) in zip(_epochs(got, n), _epochs(ref, n)):
        assert gn == rn == len(gb)
        _assert_batches_equal(gb, rb)


@pytest.mark.parametrize("num_replicas,rank", [(1, 0), (2, 0), (2, 1)])
def test_synthetic_provider_batches_match_jax(num_replicas, rank):
    kw = dict(n_train=22, n_valid=3, hr_size=16, train_batch_size=4,
              num_replicas=num_replicas, rank=rank, seed=2)
    t, j = tprov.SyntheticSRProvider(**kw), jprov.SyntheticSRProvider(**kw)
    # shuffled, rank-strided, drop_last: 22 images pad to 22 (1 replica) or
    # 11 a rank, leaving a ragged batch to drop
    _assert_loaders_equal(t.train, j.train)
    _assert_loaders_equal(t.valid, j.valid)
    _assert_loaders_equal(t.build_sub_train_loader(6, 4), j.build_sub_train_loader(6, 4))
    assert t.data_shape == j.data_shape == (16, 16, 3)


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """<root>/train (9 PNGs of two sizes) and <root>/val (3), like DIV2K /
    Set5."""
    root = tmp_path_factory.mktemp("div2k")
    rng = np.random.RandomState(0)
    for split, n in (("train", 9), ("val", 3)):
        os.makedirs(root / split)
        for i in range(n):
            h, w = (40, 52) if i % 2 else (47, 45)
            Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
                root / split / ("%d.png" % i))
    return str(root)


@pytest.mark.parametrize("kw", [dict(), dict(valid_size=3), dict(num_replicas=2, rank=1),
                                dict(num_workers=3)])
def test_folder_provider_batches_match_jax(image_tree, kw):
    """Div2KSetXXProvider: RandomCrop + flip + rotation train batches (and
    their PIL-bicubic x2 / x4), ModCrop(4) test frames at batch 1, the valid
    split and the calibration subset; the thread-pool prefetch too."""
    kw = dict(dict(image_size=16, train_batch_size=2, num_workers=1), **kw)
    t = tprov.Div2KSetXXProvider(image_tree, **kw)
    j = jprov.Div2KSetXXProvider(image_tree, **kw)
    _assert_loaders_equal(t.train, j.train)
    _assert_loaders_equal(t.valid, j.valid, n=1)
    _assert_loaders_equal(t.test, j.test, n=1)
    _assert_loaders_equal(t.build_sub_train_loader(5, 2), j.build_sub_train_loader(5, 2), n=1)
    frame = next(iter(t.test))
    assert frame["image"].shape[1] % 4 == 0 and frame["x4"].shape[1] * 4 == frame["image"].shape[1]


def test_loader_per_batch_setting_and_lists(image_tree, tmp_path):
    """per_batch_setting's kwargs reach every sample of a batch; image
    listing (numeric sort) and the paired dataset match the JAX package."""
    class Sized(tds.SyntheticSRDataset):
        def __getitem__(self, index, rng=None, size=8):
            return {"image": np.full((size, size, 3), index, np.float32)}

    setting = lambda bid, epoch: {"size": 4 + 2 * bid + epoch}  # noqa: E731
    loader = tprov.Loader(Sized(6), 2, per_batch_setting=setting, epoch=1)
    assert [b["image"].shape[1] for b in loader] == [5, 7, 9]

    os.makedirs(tmp_path / "image")
    os.makedirs(tmp_path / "label")
    rng = np.random.RandomState(1)
    for i in (10, 2, 1):
        Image.fromarray(rng.randint(0, 256, (8, 12, 3), np.uint8)).save(tmp_path / "image" / ("%d.png" % i))
        Image.fromarray(rng.randint(0, 256, (16, 24, 3), np.uint8)).save(tmp_path / "label" / ("%d.png" % i))
    root = str(tmp_path)
    assert tds.list_images(root, True) == jds.list_images(root, True)
    assert tds.list_images(root) == jds.list_images(root)
    tp, jp = tds.PairedImageDataset(root), jds.PairedImageDataset(root)
    _assert_batches_equal([tp[i] for i in range(3)], [jp[i] for i in range(3)])
    assert sorted(tp[0]) == ["image", "lr", "x2"]
    with pytest.raises(FileNotFoundError):
        tds.list_images(str(tmp_path / "image" / "none"))


def test_unported_loader_raises(image_tree):
    """The native loader is ported (the name is the test's from before):
    `use_native=True` trains from the port's own build of csrc/loader,
    in build/native/ (tests/test_torch_data_video.py holds its batches to
    the JAX package's), and nothing is refused."""
    from ofa_sr_tpu_torch.data import native as tnative
    if not tnative.native_available():
        pytest.skip("g++ or the zlib / libjpeg headers are missing here")
    t = tprov.Div2KSetXXProvider(image_tree, image_size=16, train_batch_size=2,
                                 use_native=True)
    assert isinstance(t.train, tnative.NativeSRLoader)
    assert tnative._lib_path().startswith(tnative.BUILD_DIR + os.sep)
    b = next(iter(t.train))
    assert b["image"].shape == (2, 16, 16, 3) and b["x4"].shape == (2, 4, 4, 3)
