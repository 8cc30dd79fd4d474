"""The port's two command-line entry points end to end on the CPU
(`--synthetic --device cpu`), at the teacher's full width and small images:
the teacher trainer trains, validates, checkpoints, resumes, warm-starts
and runs in bf16; the SR evaluator scores a subnet through `validate` and,
with `--materialize`, through the static subnet (whole, tiled or split over
the ranks), and refuses what is not ported. Their defaults are the JAX
package's."""

import json
import os

import numpy as np
import pytest

from ofa_sr_tpu.cli import eval_ofa_net_sr as jeval
from ofa_sr_tpu.cli import train_teacher_net_sr_simple as jteacher
from ofa_sr_tpu_torch.cli import eval_ofa_net_sr as teval
from ofa_sr_tpu_torch.cli import train_teacher_net_sr_simple as tteacher
from ofa_sr_tpu_torch.ops.kernels import fused_mbconv_infer, fused_shuffle_tail

CPU = ["--synthetic", "--device", "cpu"]
# flags only the JAX package has (XLA execution levers), or only the port
JAX_ONLY = {"remat", "ks_switch", "dw_switch", "dw_align"}
PORT_ONLY = {"device"}


@pytest.mark.parametrize("jmod,tmod", [(jteacher, tteacher), (jeval, teval)])
def test_defaults_match_jax(jmod, tmod):
    j, t = vars(jmod.build_args([])), vars(tmod.build_args([]))
    assert set(j) - JAX_ONLY == set(t) - PORT_ONLY
    assert {k: v for k, v in t.items() if k not in PORT_ONLY} == \
        {k: v for k, v in j.items() if k not in JAX_ONLY}
    assert t["device"] == "cuda"


def _teacher(path, *extra):
    return tteacher.main(CPU + ["--path", str(path), "--image_size", "8", "--warmup_epochs",
                                "0", "--n_epochs", "2", *extra])


def _valid_log(path):
    with open(os.path.join(path, "logs", "valid_console.txt")) as f:
        return f.read()


@pytest.fixture(scope="module")
def teacher_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("teacher")
    return path, _teacher(path, "--bn_mode", "train")


def test_teacher_trains_and_resumes(teacher_run):
    path, best = teacher_run
    assert np.isfinite(best)
    for f in ("checkpoint/latest.txt", "checkpoint/checkpoint.pth.tar",
              "checkpoint/model_best.pth.tar", "logs/train_console.txt", "net_info.txt",
              "run.config"):
        assert os.path.isfile(os.path.join(path, f)), f
    assert "fail to load checkpoint" in _valid_log(path)  # the first run starts fresh
    with open(os.path.join(path, "run.config")) as f:
        cfg = json.load(f)
    assert cfg["bn_frozen"] is False and cfg["n_epochs"] == 2
    _teacher(path, "--bn_mode", "train", "--n_epochs", "3")
    log = _valid_log(path)
    assert "=> loaded checkpoint (epoch 2)" in log and "Epoch 3:" in log and "Epoch 4" not in log
    with open(os.path.join(path, "logs", "train_console.txt")) as f:
        assert [line.split("]")[0] for line in f] == ["Train [1", "Train [2", "Train [3"]


def test_teacher_frozen_bf16_and_warmstart(teacher_run, tmp_path):
    """The default frozen BN in bf16 from a warm start: the teacher's
    checkpoint loads (same space, nothing kept fresh)."""
    best = _teacher(tmp_path, "--n_epochs", "1", "--compute_dtype", "bf16", "--warmstart",
                    str(teacher_run[0] / "checkpoint"))
    assert np.isfinite(best)
    log = _valid_log(tmp_path)
    assert "kept fresh init" not in log and "teacher done" in log
    with open(os.path.join(tmp_path, "run.config")) as f:
        cfg = json.load(f)
    assert cfg["bn_frozen"] is True and cfg["compute_dtype"] == "bf16"


def _eval(path, *extra):
    return teval.main(CPU + ["--path", str(path), "--dataset", "div2k", "--image_size", "32",
                             "--depth", "2", *extra])


def test_eval_validate_and_materialize(teacher_run, tmp_path):
    """From the teacher's checkpoint (most of the full supernet keeps its
    init): validate and the materialized subnet score the same frames, and
    the materialized path's frame log has a PSNR and a time per frame."""
    ckpt = str(teacher_run[0] / "checkpoint")
    fused_mbconv_infer.launches = fused_shuffle_tail.launches = 0
    plain = _eval(tmp_path / "v", "--checkpoint", ckpt)
    frame_log = str(tmp_path / "frames.jsonl")
    mat = _eval(tmp_path / "m", "--checkpoint", ckpt, "--materialize", "--frame_log", frame_log)
    np.testing.assert_allclose(mat, plain, rtol=1e-4)
    with open(frame_log) as f:
        rows = [json.loads(line) for line in f]
    assert [r["frame"] for r in rows] == [0, 1, 2, 3] and all(r["sec"] > 0 for r in rows)
    np.testing.assert_allclose(np.mean([r["psnr"] for r in rows]), mat, rtol=1e-6)
    assert "kept fresh init" in _valid_log(tmp_path / "m")
    # the CPU takes the plain versions: no kernel launched
    assert fused_mbconv_infer.launches == fused_shuffle_tail.launches == 0
    recal = _eval(tmp_path / "r", "--checkpoint", ckpt, "--bn_recalib", "--materialize")
    assert np.isfinite(recal) and recal != mat


@pytest.mark.parametrize("flags,item", [(["--export", "x.bin"], 13), (["--tile", "8"], 10),
                                        (["--tile_mesh"], 10), (["--spatial_mesh"], 10),
                                        (["--x4_autoencoder", "--tile", "8"], 10)])
def test_eval_refuses_unported(tmp_path, flags, item):
    """--export (item 13) is refused. Item 10's options are ported: with
    --materialize each runs (in one process: a world of one; here the 8x8
    LR frames are smaller than a tile's window and run whole, except under
    --spatial_mesh, whose slab runs with zero halos and row bounds) and
    scores the untiled run's mean PSNR-Y within 1e-4 dB. Real tiles and two
    ranks: tests/test_torch_tiled.py."""
    if item == 13:
        with pytest.raises(NotImplementedError, match="item %d" % item):
            _eval(tmp_path, *flags)
        return
    ae = ["--x4_autoencoder"] if "--x4_autoencoder" in flags else []
    whole = _eval(tmp_path / "whole", "--materialize", *ae)
    np.testing.assert_allclose(_eval(tmp_path / "flag", "--materialize", *flags), whole,
                               rtol=0, atol=1e-4)


def test_eval_oracle_video_needs_synthetic(tmp_path):
    """--dataset oracle_video is ported: without --synthetic it reads the
    video frames, and with no tree at the default path it fails there, as
    the JAX CLI does (tests/test_torch_oracle_cli.py evaluates a generated
    tree)."""
    with pytest.raises(FileNotFoundError, match="kaist_paper_video_dataset"):
        teval.main(["--device", "cpu", "--path", str(tmp_path), "--dataset", "oracle_video"])
    # with --synthetic the dataset choice does not matter, as in the JAX CLI
    assert np.isfinite(teval.main(CPU + ["--path", str(tmp_path), "--image_size", "16"]))
