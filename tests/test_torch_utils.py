"""The port's helpers against the JAX package's on the CPU: the numpy
metrics and `psnr_rgb_device` (ofa_sr_tpu_torch/utils/metrics.py), the
activations and strided convs the classification nets use (ops/),
`get_net_info` and `trace` (utils/profile.py), the media tools and their
CLI (tools/media.py) on small generated trees, and the tutorial at reduced
steps.

Tolerances: metrics 1e-6 (the numpy twins are the same float64 / uint8
arithmetic: equal); activations atol 1e-6; the convs rtol and atol 1e-5
(outputs up to ~20 from unit-normal data and weights);
get_net_info's counts, the media tools' images and scene-cut distances
exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.models import OFAMobileNetS4 as JaxS4
from ofa_sr_tpu.models import OFAMobileNetX4 as JaxX4
from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu.ops import activations as jact
from ofa_sr_tpu.ops import conv as jconv
from ofa_sr_tpu.utils import metrics as jmetrics
from ofa_sr_tpu.utils import profile as jprofile
from ofa_sr_tpu_torch import tutorial
from ofa_sr_tpu_torch import utils as tutils
from ofa_sr_tpu_torch.models import OFAMobileNetS4, OFAMobileNetX4, SearchSpace, uniform_subnet
from ofa_sr_tpu_torch.ops import activations as tact
from ofa_sr_tpu_torch.ops import conv as tconv
from ofa_sr_tpu_torch.search import latency
from ofa_sr_tpu_torch.utils import profile as tprofile

TOL = dict(rtol=0, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread for the module, restored after it: these nets'
    CPU convs gain little from intra-op threads and oversubscribe the CPU
    under parallel test workers (as tests/test_torch_x4.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- metrics ----------------------------------------------------------------------

def _images(seed, shape=(2, 12, 10, 3)):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape) * 1.2 - 0.1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_metrics_match_jax(seed):
    """tensor2img_np, rgb2y_np, rgb2gray_np and psnr_np equal JAX's, batch
    kept, on images that leave [0, 1]."""
    a, b = _images(seed), _images(seed + 10)
    for arr in (a, a[0]):
        assert np.array_equal(tutils.tensor2img_np(arr), jmetrics.tensor2img_np(arr))
        f = tutils.tensor2img_np(arr, np.float32, (-0.1, 1.1))
        np.testing.assert_allclose(f, jmetrics.tensor2img_np(arr, np.float32, (-0.1, 1.1)),
                                   **TOL)
    ia, ib = jmetrics.tensor2img_np(a), jmetrics.tensor2img_np(b)
    assert np.array_equal(tutils.rgb2y_np(ia), jmetrics.rgb2y_np(ia))
    assert np.array_equal(tutils.rgb2gray_np(ia), jmetrics.rgb2gray_np(ia))
    gray = tutils.rgb2gray_np(a)
    assert gray.dtype == np.float32 and np.array_equal(gray, jmetrics.rgb2gray_np(a))
    np.testing.assert_allclose(tutils.psnr_np(ia, ib), jmetrics.psnr_np(ia, ib), **TOL)
    np.testing.assert_allclose(tutils.psnr_np(tutils.rgb2y_np(ia), tutils.rgb2y_np(ib)),
                               jmetrics.psnr_np(jmetrics.rgb2y_np(ia), jmetrics.rgb2y_np(ib)),
                               **TOL)
    assert tutils.psnr_np(ia, ia) == float("inf")


def test_psnr_rgb_device_matches_jax():
    a, b = _images(2), _images(3)
    got = float(tutils.psnr_rgb_device(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, float(jmetrics.psnr_rgb_device(jnp.asarray(a),
                                                                    jnp.asarray(b))), rtol=1e-6)
    assert float(tutils.psnr_rgb_device(torch.from_numpy(a), torch.from_numpy(a))) == np.inf
    # the numpy twin of the same quantity
    ia, ib = tutils.tensor2img_np(a), tutils.tensor2img_np(b)
    np.testing.assert_allclose(got, tutils.psnr_np(ia, ib), rtol=1e-6)


# -- activations and strided convs --------------------------------------------------

@pytest.mark.parametrize("name", sorted(k for k in jact.ACT_FNS if k is not None))
def test_activations_match_jax(name):
    assert set(tact.ACT_FNS) == set(jact.ACT_FNS)
    x = np.linspace(-8, 8, 401, dtype=np.float32)
    np.testing.assert_allclose(tact.apply_act(torch.from_numpy(x), name).numpy(),
                               np.asarray(jact.apply_act(jnp.asarray(x), name)), **TOL)


@pytest.mark.parametrize("k,stride,hw", [(3, 2, 9), (3, 2, 8), (5, 2, 11), (7, 1, 6)])
def test_strided_convs_match_jax(k, stride, hw):
    """Padding k//2 per side at stride 2, odd and even extents (not XLA's
    asymmetric "SAME")."""
    rng = np.random.RandomState(k + hw)
    x = rng.randn(2, hw, hw, 6).astype(np.float32)
    w = rng.randn(k, k, 6, 10).astype(np.float32)
    dw = rng.randn(k, k, 1, 6).astype(np.float32)
    got = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                       stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(jconv.conv2d(x, w, stride=stride)),
                               rtol=1e-5, atol=1e-5)
    got = tconv.depthwise_conv2d(torch.from_numpy(x),
                                 torch.from_numpy(dw.transpose(3, 2, 0, 1).copy()), stride)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jconv.depthwise_conv2d(x, dw, stride=stride)),
                               rtol=1e-5, atol=1e-5)


# -- profile ------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["s4", "x4"])
def test_get_net_info_matches_jax(kind):
    """The full-width supernets: the same dict, the parameter count over
    what JAX's params tree holds (no running statistics)."""
    jcls, tcls = {"s4": (JaxS4, OFAMobileNetS4), "x4": (JaxX4, OFAMobileNetX4)}[kind]
    jnet = jcls(jarch.SearchSpace())
    p, _ = jnet.init(jax.random.PRNGKey(0))
    tnet = tcls(SearchSpace(), device="cpu")
    assert tprofile.get_net_info(tnet) == jprofile.get_net_info(jnet, p)
    if kind == "s4":
        for args in ((7, 6, 2, 2), (3, 3, 2, 1)):
            cfg = uniform_subnet(tnet.space, *args)
            jcfg = jarch.uniform_subnet(jnet.space, *args)
            assert tprofile.get_net_info(tnet, cfg, 720) == \
                jprofile.get_net_info(jnet, p, jcfg, 720)


def test_trace_writes_a_chrome_trace(tmp_path):
    assert tprofile.measure_net_latency is latency.measure_latency
    logdir = str(tmp_path / "trace")
    with tprofile.trace(logdir) as d:
        assert d == logdir
        torch.relu(torch.ones(4, 4) - 2).sum()
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        assert "traceEvents" in json.load(f)


# -- media tools ----------------------------------------------------------------------

def _frames(d, n=6, size=(32, 24), cut_at=3):
    from PIL import Image
    os.makedirs(d)
    rng = np.random.RandomState(0)
    base_a = (rng.rand(size[1], size[0], 3) * 255).astype(np.uint8)
    for i in range(n):
        base = base_a if i < cut_at else 255 - base_a
        noise = rng.randint(-3, 4, base.shape)
        Image.fromarray(np.clip(base.astype(int) + noise, 0, 255).astype(np.uint8)).save(
            os.path.join(d, "%04d.png" % i))
    return str(d)


def _same_images(a, b):
    from PIL import Image
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        assert np.array_equal(np.asarray(Image.open(os.path.join(a, n))),
                              np.asarray(Image.open(os.path.join(b, n)))), n


def test_media_tools_match_jax(tmp_path):
    """yuv decode (the numpy decoder where ffmpeg is absent), split,
    crop, resize and scene cuts: the same files and numbers as JAX's."""
    pytest.importorskip("PIL")
    from ofa_sr_tpu.tools import media as jmedia
    from ofa_sr_tpu_torch.tools import media as tmedia

    frames = _frames(tmp_path / "frames", size=(64, 48))
    w, h, n = 16, 8, 3
    raw = np.random.RandomState(1).randint(0, 256, n * w * h * 3 // 2, dtype=np.uint8)
    yuv = tmp_path / "clip.yuv"
    yuv.write_bytes(raw.tobytes())
    for mod, tag in ((tmedia, "t"), (jmedia, "j")):
        out = tmp_path / tag
        assert mod.yuv_to_png(str(yuv), str(out / "yuv"), width=w, height=h) == n
        assert mod.split_frames(frames, str(out / "split"), train=0.5, test=0.25,
                                bucket_size=1) == {"train": 3, "test": 2, "val": 1}
        assert mod.crop_and_save(frames, str(out / "crop"), size=32) == 6
        assert mod.resize_and_save(frames, str(out / "rs"), factor=4) == 6
    for sub in ("yuv", "split/train", "split/test", "split/val", "crop", "rs"):
        _same_images(str(tmp_path / "t" / sub), str(tmp_path / "j" / sub))
    diffs = tmedia.color_histogram_difference(frames)
    assert diffs == jmedia.color_histogram_difference(frames)
    assert len(diffs) == 5 and int(np.argmax(diffs)) == 2


def test_media_cli(tmp_path, capsys):
    pytest.importorskip("PIL")
    from ofa_sr_tpu_torch.tools import media as tmedia

    frames = _frames(tmp_path / "frames", n=4, cut_at=2)
    tmedia.main(["crop", frames, str(tmp_path / "crop"), "--size", "16"])
    tmedia.main(["resize", frames, str(tmp_path / "rs"), "--factor", "2"])
    tmedia.main(["scene_cuts", frames])
    out = capsys.readouterr().out.split("\n")
    assert out[0] == "4" and out[1] == "4"
    cuts = [float(line.split()[1]) for line in out[2:5]]
    assert int(np.argmax(cuts)) == 1
    assert sorted(os.listdir(tmp_path / "crop")) == sorted(os.listdir(frames))


def test_media_imports_without_pil():
    """Importing the module opens no image library (the GPU machine may
    lack PIL); tests/test_torch_isolation.py checks it in a fresh
    interpreter."""
    import ofa_sr_tpu_torch.tools.media as tmedia
    assert "Image" not in vars(tmedia)


# -- the tutorial -----------------------------------------------------------------------

def test_tutorial_runs_on_the_cpu(tmp_path):
    """Every step at reduced training and predictor sizes: the winner under
    its MACs constraint, the artifact equal to the plain path, the tiled
    frame's shape."""
    out = tutorial.main(["--device", "cpu", "--path", str(tmp_path), "--n_epochs", "1",
                         "--n_predictor_subnets", "16"])
    assert all(np.isfinite(v) for v in out["corners"].values())
    assert out["winner_macs"] > 0 and np.isfinite(out["measured_psnr"])
    assert out["artifact_bytes"] > 0 and out["artifact_max_abs_err_plain"] <= 1e-6
    assert out["deployed_launches"] == {"mbconv": 0, "shuffle_tail": 0}  # CPU: plain versions
    assert out["tiled_shape"][1:] == (72 * 2 ** int(out["winner"][-1]),
                                      88 * 2 ** int(out["winner"][-1]), 3)
    assert os.path.isfile(tmp_path / "checkpoint" / "latest.txt")
