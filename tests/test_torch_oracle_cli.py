"""The port's two oracle-video command-line entry points and the SR
evaluator's `--dataset oracle_video`, against the JAX package's CLIs on the
CPU, from the same weights: the JAX net's init, saved once in each
package's checkpoint format (the port's through the weight bridge) and
loaded by each CLI (`--checkpoint`, `--warmstart`).

Tolerances: each epoch's train loss and PSNR and each validation's loss
and PSNR, as the run managers return them, rtol 2e-3 (Adam steps, as
tests/test_torch_run_manager.py holds them); the teacher's validate-only
PSNR and the evaluator's rtol 1e-5 (float32 forwards, sums in another
order)."""

import os

import jax
import numpy as np
import pytest
from PIL import Image

from ofa_sr_tpu.cli import eval_ofa_net_sr as jeval
from ofa_sr_tpu.cli import train_ofa_net_sr_oracle_video as jovideo
from ofa_sr_tpu.cli import train_teacher_net_sr_oracle_video as jteacher
from ofa_sr_tpu.models import OFAMobileNetS4 as JaxS4
from ofa_sr_tpu.models import OFAMobileNetX4 as JaxX4
from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu.train import SRRunManager as JaxRunManager
from ofa_sr_tpu.train import checkpoint as jckpt
from ofa_sr_tpu_torch.cli import eval_ofa_net_sr as teval
from ofa_sr_tpu_torch.cli import train_ofa_net_sr_oracle_video as tovideo
from ofa_sr_tpu_torch.cli import train_teacher_net_sr_oracle_video as tteacher
from ofa_sr_tpu_torch.train import SRRunManager
from ofa_sr_tpu_torch.train.checkpoint import (
    s4_state_dict_from_jax,
    save_weights,
    x4_state_dict_from_jax,
)
from test_torch_cli import JAX_ONLY, PORT_ONLY

EPOCH_TOL = dict(rtol=2e-3, atol=1e-6)
EVAL_TOL = dict(rtol=1e-5, atol=1e-6)
# 64 synthetic images of 16 px at batch 32: two steps an epoch
SMALL = ["--synthetic", "--image_size", "16", "--base_batch_size", "32"]


@pytest.mark.parametrize("jmod,tmod", [(jteacher, tteacher), (jovideo, tovideo)])
def test_defaults_match_jax(jmod, tmod):
    j, t = vars(jmod.build_args([])), vars(tmod.build_args([]))
    assert set(j) - JAX_ONLY == set(t) - PORT_ONLY
    assert {k: v for k, v in t.items() if k not in PORT_ONLY} == \
        {k: v for k, v in j.items() if k not in JAX_ONLY}
    assert t["device"] == "cuda"


def _weights(tmp, jnet, bridge, seed):
    """The JAX net's init from `seed`, as a JAX and a port weights file."""
    p, s = jnet.init(jax.random.PRNGKey(seed))
    jfile = jckpt.save_weights(str(tmp), p, s, "jax.ckpt")
    tfile = save_weights(str(tmp), bridge(p, s), "port.pth.tar")
    return jfile, tfile


@pytest.fixture
def record(monkeypatch):
    """Each run manager's train_one_epoch and validate results, in order,
    by package."""
    out = {"jax": [], "port": []}
    for key, cls in (("jax", JaxRunManager), ("port", SRRunManager)):
        for name in ("train_one_epoch", "validate"):
            real = getattr(cls, name)

            def wrapped(self, *a, _real=real, _key=key, **k):
                res = _real(self, *a, **k)
                out[_key].append(tuple(float(v) for v in res))
                return res
            monkeypatch.setattr(cls, name, wrapped)
    return out


def test_teacher_oracle_matches_jax(tmp_path, record):
    """Validate-only, then a one-epoch finetune (BN frozen)."""
    jfile, tfile = _weights(tmp_path, JaxS4(jarch.SearchSpace(
        ks_list=[5], expand_list=[3], depth_list=[2], pixel_d_list=[1])),
        s4_state_dict_from_jax, seed=3)
    j = jteacher.main(SMALL + ["--path", str(tmp_path / "j"), "--checkpoint", jfile])
    t = tteacher.main(SMALL + ["--device", "cpu", "--path", str(tmp_path / "t"),
                               "--checkpoint", tfile])
    np.testing.assert_allclose(t, j, **EVAL_TOL)
    ft = ["--finetune", "--n_epochs", "1"]
    j = jteacher.main(SMALL + ft + ["--path", str(tmp_path / "jf"), "--checkpoint", jfile])
    t = tteacher.main(SMALL + ft + ["--device", "cpu", "--path", str(tmp_path / "tf"),
                                    "--checkpoint", tfile])
    assert len(record["port"]) == len(record["jax"]) == 3  # validate; epoch + validate
    np.testing.assert_allclose(record["port"], record["jax"], **EPOCH_TOL)
    np.testing.assert_allclose(t, j, **EPOCH_TOL)
    assert os.path.isfile(tmp_path / "tf" / "checkpoint" / "checkpoint.pth.tar")


def test_oracle_overfit_matches_jax(tmp_path, record):
    """One epoch of one sampled X4 architecture (both trunks' genes; sr mode
    runs the decoder), pinned at every step, BN frozen."""
    jfile, tfile = _weights(tmp_path, JaxX4(jarch.SearchSpace()), x4_state_dict_from_jax, seed=4)
    common = SMALL + ["--n_epochs", "1", "--arch_seed", "11"]
    j = jovideo.main(common + ["--path", str(tmp_path / "j"), "--warmstart", jfile])
    t = tovideo.main(common + ["--device", "cpu", "--path", str(tmp_path / "t"),
                               "--warmstart", tfile])
    assert len(record["port"]) == len(record["jax"]) == 2
    np.testing.assert_allclose(record["port"], record["jax"], **EPOCH_TOL)
    np.testing.assert_allclose(t, j, **EPOCH_TOL)
    with open(tmp_path / "t" / "logs" / "valid_console.txt") as f:
        assert "oracle overfit done" in f.read()


def _png(path, h, w, seed):
    Image.fromarray(np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)).save(path)


def test_oracle_overfit_codec_pairs(tmp_path):
    """--dataset codec: paired LR/HR frames; the default architecture
    (ks7/e3/d2, pixel_d 1) trains on the "x2" the pairs give."""
    for split, n in (("train", 4), ("val", 2)):
        for sub, size in (("image", 8), ("label", 16)):
            os.makedirs(tmp_path / "data" / split / sub)
            for i in range(n):
                _png(tmp_path / "data" / split / sub / ("%d.png" % i), size, size, 7 * i + size)
    best = tovideo.main(["--device", "cpu", "--data_root", str(tmp_path / "data"), "--path",
                         str(tmp_path / "run"), "--n_epochs", "1", "--base_batch_size", "2",
                         "--n_worker", "1"])
    assert np.isfinite(best)


@pytest.fixture(scope="module")
def video_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    for split, n in (("train", 4), ("val", 3)):
        os.makedirs(root / split)
        for i in range(1, n + 1):
            _png(root / split / ("%d.png" % i), 36, 40, i)
    return str(root)


@pytest.mark.parametrize("materialize", [False, True])
def test_eval_oracle_video_matches_jax(tmp_path, video_tree, materialize):
    """`eval_ofa_net_sr --dataset oracle_video` on generated frames (32 px
    center crops), the ks7/e6/d2/pixel_d 2 subnet from the same weights:
    through validate, or the static subnet with --materialize."""
    jfile, tfile = _weights(tmp_path, JaxS4(jarch.SearchSpace()), s4_state_dict_from_jax, seed=5)
    argv = ["--dataset", "oracle_video", "--data_root", video_tree, "--image_size", "32",
            "--n_worker", "1"] + (["--materialize"] if materialize else [])
    j = jeval.main(argv + ["--path", str(tmp_path / "j"), "--checkpoint", jfile])
    t = teval.main(argv + ["--device", "cpu", "--path", str(tmp_path / "t"), "--checkpoint",
                           tfile])
    assert np.isfinite(t)
    np.testing.assert_allclose(t, j, **EVAL_TOL)
