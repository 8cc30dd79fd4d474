"""The port's progressive shrinking (ofa_sr_tpu_torch/train/shrink.py), its
X4 run management and the two X4 command-line paths against the JAX
package on the CPU, from the same weights (the JAX run manager's init,
through the weight bridge) and the same synthetic data.

Tolerances: `validate_grid`'s mean loss and PSNR rtol 1e-4; one epoch of
autoencoder training (Adam, two subnets a step) per-epoch loss and PSNR
rtol 2e-3 as tests/test_torch_run_manager.py holds the S4's; recalibrated
and bucketed validation rtol 1e-5; subnet sampling, bucket padding and the
stage machine's files and resumes exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from ofa_sr_tpu.cli import eval_ofa_net_sr as jeval
from ofa_sr_tpu.cli import train_ofa_net_sr_simple as jshrink_cli
from ofa_sr_tpu.data import SyntheticSRProvider as JaxProvider
from ofa_sr_tpu.models import OFAMobileNetX4 as JaxX4
from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu.train import RunConfig as JaxRunConfig
from ofa_sr_tpu.train import SRRunManager as JaxRunManager
from ofa_sr_tpu.train import run_manager as jrm
from ofa_sr_tpu.train import checkpoint as jckpt
from ofa_sr_tpu.train import shrink as jshrink
from ofa_sr_tpu_torch.cli import eval_ofa_net_sr as teval
from ofa_sr_tpu_torch.cli import train_ofa_net_sr_simple as tshrink_cli
from ofa_sr_tpu_torch.data import SyntheticSRProvider
from ofa_sr_tpu_torch.models import OFAMobileNetX4, SearchSpace
from ofa_sr_tpu_torch.models import reorganize as treorg
from ofa_sr_tpu_torch.train import RunConfig, SRRunManager
from ofa_sr_tpu_torch.train import run_manager as trm
from ofa_sr_tpu_torch.train import shrink as tshrink
from ofa_sr_tpu_torch.train.checkpoint import (
    checkpoint_state_dict,
    load_checkpoint,
    save_checkpoint,
    x4_state_dict_from_jax,
)
from test_torch_cli import JAX_ONLY, PORT_ONLY

SMALL_KW = dict(ks_list=[3, 5], expand_list=[2, 3], depth_list=[1, 2], pixel_d_list=[1, 2],
                n_stages=1, width=8)
PROVIDER_KW = dict(n_train=8, n_valid=2, hr_size=16, train_batch_size=4)
GRID_TOL = dict(rtol=1e-4, atol=1e-6)
EPOCH_TOL = dict(rtol=2e-3, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-6)
CPU = ["--synthetic", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's nets run at sizes where PyTorch's intra-op threads
    cost more than they save (the full-width X4 on 8-16 px images runs 3x
    faster on one thread) and oversubscribe the CPU under parallel test
    workers: one thread for the module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(tmp_path, space_kw=SMALL_KW, **cfg_kw):
    """A JAX X4 run manager and the port's, from the JAX init's weights."""
    kw = dict(n_epochs=1, base_lr=1e-3, train_batch_size=4, print_frequency=1)
    kw.update(cfg_kw)
    jrun = JaxRunManager(str(tmp_path / "jax"), JaxX4(jarch.SearchSpace(**space_kw)),
                         JaxRunConfig(**kw), JaxProvider(**PROVIDER_KW))
    return jrun, _port_manager(tmp_path / "port", jrun, space_kw, **kw)


def _port_manager(path, jrun=None, space_kw=SMALL_KW, **kw):
    net = OFAMobileNetX4(SearchSpace(**space_kw), device="cpu")
    if jrun is not None:
        net.load_state_dict(x4_state_dict_from_jax(jrun.params, jrun.state))
    return SRRunManager(str(path), net, RunConfig(**kw), SyntheticSRProvider(**PROVIDER_KW))


def _manager(path, **cfg_kw):
    kw = dict(n_epochs=1, base_lr=1e-3, train_batch_size=4, print_frequency=1,
              mode="autoencoder")
    kw.update(cfg_kw)
    return _port_manager(path, **kw)


@pytest.mark.parametrize("mode", ["sr", "autoencoder"])
def test_validate_grid_matches_jax(tmp_path, mode):
    jrun, trun = _pair(tmp_path, mode=mode, corner_gate=True)
    for lists in ({}, dict(ks_list=[3], expand_list=[2, 3], depth_list=[1], pixel_d_list=[2])):
        j = jshrink.validate_grid(jrun, **lists)
        t = tshrink.validate_grid(trun, **lists, gate_where="test")
        np.testing.assert_allclose(t[:2], j[:2], **GRID_TOL)
        names = lambda log: [c.split(" ")[0] for c in log.split(", ") if c]  # noqa: E731
        assert names(t[2]) == names(j[2]) and len(names(t[2])) == (16 if not lists else 2)
    with open(tmp_path / "port" / "checkpoint" / "corner_best.json") as f:
        assert set(json.load(f)) == {"K%d-E%d-D%d-PD%d" % c for c in
                                     [(k, e, d, pd) for pd in (1, 2) for d in (1, 2)
                                      for e in (2, 3) for k in (3, 5)]}
    assert tshrink._named_grid_cfgs(trun, {})[0][0] == "K3-E2-D1-PD1"
    assert [c.d for _, c in tshrink._named_grid_cfgs(trun, {})][:1] == [(1, 1)]


def test_autoencoder_epoch_matches_jax(tmp_path):
    """One epoch of autoencoder training (two subnets a step, the sandwich
    rule), then validation plain, bucketed, and after BN recalibration."""
    kw = dict(mode="autoencoder", dynamic_batch_size=2, sandwich_rule=True)
    jrun, trun = _pair(tmp_path, **kw)
    j = jrun.train_one_epoch(0) + jrun.validate()
    t = trun.train_one_epoch(0) + trun.validate()
    np.testing.assert_allclose(t, j, **EPOCH_TOL)
    # the same weights on both sides for the eval paths
    trun.net.load_state_dict(x4_state_dict_from_jax(jrun.params, jrun.state))
    for rc_kw in (dict(eval_bucket=16), dict(bn_recalib_before_eval=True)):
        for run in (jrun, trun):
            for k, v in rc_kw.items():
                setattr(run.run_config, k, v)
        loader = trun.provider.build_sub_train_loader(4, 2)
        np.testing.assert_allclose(trun.validate(recalib_loader=loader),
                                   jrun.validate(recalib_loader=loader), **TOL)
        for run in (jrun, trun):
            for k in rc_kw:
                setattr(run.run_config, k, getattr(RunConfig(), k))


def test_bucket_pad_autoencoder_matches_jax():
    rng = np.random.RandomState(0)
    batch = {"image": rng.rand(1, 12, 20, 3).astype(np.float32),
             "x2": rng.rand(1, 6, 10, 3).astype(np.float32)}
    for pd, mode in ((1, "autoencoder"), (1, "sr")):
        j, t = jrm._bucket_pad(batch, pd, 8, mode), trm._bucket_pad(batch, pd, 8, mode)
        assert j.keys() == t.keys()
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
    assert trm._bucket_pad(batch, 1, 8, "autoencoder")["image"].shape == (1, 16, 24, 3)


@pytest.mark.parametrize("kw", [dict(), dict(sandwich_rule=True, reference_quirks=True)])
def test_sample_archs_x4_match_jax(tmp_path, kw):
    """Both trunks' choices, as the JAX run manager draws them (four stages
    a trunk: the reference quirks need the reference's stage count)."""
    jrun, trun = _pair(tmp_path, dict(SMALL_KW, n_stages=4), dynamic_batch_size=3,
                       mode="autoencoder", **kw)
    for cons in (None, dict(expand_candidates=[3], depth_candidates=[2])):
        _, jd = jrun.sample_archs(1, 50, 7, cons)
        td = trun.sample_archs(1, 50, 7, cons)
        assert [(c.ks, c.e, c.d, c.pixel_d) for c in td] == \
            [(c.ks, c.e, c.d, c.pixel_d) for c in jd]
        assert all(len(c.d) == 8 for c in td)


# -- the stage machine (tests/test_run_manager.py's, on the port's X4) ---------

def _stage(path, task):
    with open(os.path.join(str(path), "%s.stage" % task)) as f:
        return json.load(f)


def test_stage_machine_files_and_finished_resume(tmp_path, monkeypatch):
    rm = _manager(tmp_path)
    loss, psnr, log = tshrink.validate_grid(rm, ks_list=[3], expand_list=[2], depth_list=[1],
                                            pixel_d_list=[1, 2])
    assert "PD1-D1-E2-K3" in log and "PD2-D1-E2-K3" in log and np.isfinite(psnr)
    assert np.isfinite(tshrink.supporting_elastic(rm, "depth"))
    assert _stage(tmp_path, "depth") == {"stage": 1}
    for f in ("checkpoint/depth_stage1.ckpt", "checkpoint/latest.txt",
              "logs/valid_console.txt", "logs/train_console.txt"):
        assert os.path.isfile(tmp_path / f), f
    with open(tmp_path / "logs" / "valid_console.txt") as f:
        log = f.read()
    assert "Elastic depth: [2] -> [2, 1]" in log and "stage 1:" in log
    # a rerun finds the stage finished: no epoch runs, the best stays unset
    ran = []
    monkeypatch.setattr(SRRunManager, "train_one_epoch",
                        lambda self, epoch, *a, **k: ran.append(epoch))
    assert tshrink.supporting_elastic(_manager(tmp_path), "depth") == -1e9
    assert ran == []


def _crash_then_record(monkeypatch, crash_at=1):
    orig = SRRunManager.train_one_epoch

    def crashing(self, epoch, *a, **k):
        if epoch == crash_at:
            raise RuntimeError("simulated crash")
        return orig(self, epoch, *a, **k)

    seen = []

    def recording(self, epoch, *a, **k):
        seen.append(epoch)
        return orig(self, epoch, *a, **k)

    return crashing, recording, seen


def test_shrink_mid_stage_resume(tmp_path, monkeypatch):
    """A run killed mid-stage resumes in a new process at the next epoch of
    the same stage, from that stage's checkpoint, and clears the marker."""
    crashing, recording, seen = _crash_then_record(monkeypatch)
    monkeypatch.setattr(SRRunManager, "train_one_epoch", crashing)
    with pytest.raises(RuntimeError, match="simulated crash"):
        tshrink.supporting_elastic(_manager(tmp_path, n_epochs=2), "depth")
    assert _stage(tmp_path, "depth") == {"stage": 0, "running_stage": 0}
    monkeypatch.setattr(SRRunManager, "train_one_epoch", recording)
    assert np.isfinite(tshrink.supporting_elastic(_manager(tmp_path, n_epochs=2), "depth"))
    assert seen == [1]
    assert _stage(tmp_path, "depth") == {"stage": 1}


def test_shrink_kernel_phase_resume(tmp_path, monkeypatch):
    """The one-stage tasks resume from their per-epoch checkpoint."""
    crashing, recording, seen = _crash_then_record(monkeypatch)
    monkeypatch.setattr(SRRunManager, "train_one_epoch", crashing)
    with pytest.raises(RuntimeError, match="simulated crash"):
        tshrink.supporting_elastic(_manager(tmp_path, n_epochs=2), "kernel")
    monkeypatch.setattr(SRRunManager, "train_one_epoch", recording)
    assert np.isfinite(tshrink.supporting_elastic(_manager(tmp_path, n_epochs=2), "kernel"))
    assert seen == [1] and _stage(tmp_path, "kernel") == {"stage": 1}


def test_expand_stage_reorganizes_in_place(tmp_path, monkeypatch):
    """The expand stage reorganizes both trunks before training, in place:
    the optimizer and its parameters stay the objects they were."""
    calls = []
    real = treorg.reorganize_x4

    def recording(net, expand_ratio_stage=0):
        calls.append(expand_ratio_stage)
        return real(net, expand_ratio_stage)

    monkeypatch.setattr(tshrink, "reorganize_x4", recording)
    rm = _manager(tmp_path)
    opt, params = rm.trainer.opt, [id(p) for p in rm.net.parameters()]
    assert np.isfinite(tshrink.supporting_elastic(rm, "expand"))
    assert calls == [1] and rm.trainer.opt is opt
    assert [id(p) for p in rm.net.parameters()] == params
    assert _stage(tmp_path, "expand") == {"stage": 1}
    assert os.path.isfile(tmp_path / "checkpoint" / "expand_stage1.ckpt")


@pytest.mark.parametrize("content", ["{not json", "[1, 2]"])
def test_corrupt_stage_file_raises(tmp_path, content):
    rm = _manager(tmp_path)
    with open(tmp_path / "depth.stage", "w") as f:
        f.write(content)
    with pytest.raises(RuntimeError, match="delete it"):
        tshrink.supporting_elastic(rm, "depth")
    assert tshrink.load_stage_info(_manager(tmp_path / "fresh"), "depth") == {"stage": 0}


# -- the command-line entry points ----------------------------------------------

def test_shrink_cli_defaults_match_jax():
    j, t = vars(jshrink_cli.build_args([])), vars(tshrink_cli.build_args([]))
    assert set(j) - JAX_ONLY == set(t) - PORT_ONLY
    assert {k: v for k, v in t.items() if k not in PORT_ONLY} == \
        {k: v for k, v in j.items() if k not in JAX_ONLY}
    assert tshrink_cli.TASK_PHASES == jshrink_cli.TASK_PHASES
    assert t["device"] == "cuda"


def _shrink(path, task, phase, *extra):
    """One epoch a stage at full width on 8 px images, two steps an epoch,
    no validation inside a stage (the stage's end validates its grid)."""
    return tshrink_cli.main(CPU + ["--task", task, "--phase", str(phase), "--path", str(path),
                                   "--n_epochs", "1", "--warmup_epochs", "0", "--image_size",
                                   "8", "--base_batch_size", "32", "--validation_frequency",
                                   "2", *extra])


@pytest.fixture(scope="module")
def shrink_runs(tmp_path_factory):
    """The curriculum's first tasks in autoencoder mode, each warm-started
    from the previous one's checkpoint."""
    root = tmp_path_factory.mktemp("shrink")
    prev, out = None, {}
    for task in ("pretrain", "kernel"):
        extra = ["--mode", "autoencoder"] + (["--warmstart", str(prev)] if prev else [])
        out[task] = _shrink(root / task, task, 1, *extra)
        prev = root / task / "checkpoint"
    return root, out


@pytest.mark.parametrize("task,phase", [("depth", 1), ("depth", 2), ("expand", 1),
                                        ("expand", 2), ("pixelshuffle_depth", 1)])
def test_shrink_cli_runs_every_task(shrink_runs, tmp_path, task, phase):
    """Each task after the kernel one, from the kernel task's checkpoint, in
    autoencoder mode: every stage of its phase runs and is recorded."""
    root, best = shrink_runs
    assert all(np.isfinite(v) for v in best.values())
    assert _stage(root / "pretrain", "pretrain") == {"stage": 1}
    out = _shrink(tmp_path, task, phase, "--mode", "autoencoder", "--warmstart",
                  str(root / "kernel" / "checkpoint"))
    assert np.isfinite(out)
    sp = tshrink_cli.TASK_PHASES[(task, phase)]
    dim = {"depth": "depth_list", "expand": "expand_list",
           "pixelshuffle_depth": "pixel_d_list"}[task]
    n_stages = len(sp[dim]) - 1
    assert _stage(tmp_path, task) == {"stage": n_stages}
    assert os.path.isfile(tmp_path / "checkpoint" / ("%s_stage%d.ckpt" % (task, n_stages)))
    with open(tmp_path / "logs" / "valid_console.txt") as f:
        log = f.read()
    assert "warmstart:" in log and "task %s phase %d done" % (task, phase) in log


def test_shrink_cli_sr_mode_kd_and_quirks(shrink_runs, tmp_path):
    """sr mode with KD from a port-native teacher checkpoint (a ks7/e6/d4/pd2
    X4: the pretrain task's), the sandwich rule, corner gating, reference
    quirks and bf16."""
    root, _ = shrink_runs
    out = _shrink(tmp_path, "depth", 1, "--kd_ratio", "1.0", "--kd_teacher",
                  str(root / "pretrain" / "checkpoint"), "--sandwich", "--corner_gate",
                  "--reference_quirks", "--compute_dtype", "bf16")
    assert np.isfinite(out)
    with open(tmp_path / "run.config") as f:
        cfg = json.load(f)
    assert cfg["mode"] == "sr" and cfg["kd_ratio"] == 1.0 and cfg["sandwich_rule"]
    assert os.path.isfile(tmp_path / "checkpoint" / "corner_best.json")


def test_eval_x4_autoencoder(shrink_runs, tmp_path):
    """--x4_autoencoder: validate and the materialized subnet score the same
    frames from the kernel task's checkpoint; the subnet takes HR frames."""
    ckpt = str(shrink_runs[0] / "kernel" / "checkpoint")
    args = CPU + ["--dataset", "div2k", "--image_size", "16", "--x4_autoencoder",
                  "--checkpoint", ckpt]
    plain = teval.main(args + ["--path", str(tmp_path / "v")])
    frame_log = str(tmp_path / "frames.jsonl")
    mat = teval.main(args + ["--path", str(tmp_path / "m"), "--materialize", "--frame_log",
                             frame_log])
    np.testing.assert_allclose(mat, plain, rtol=1e-4)
    unfolded = teval.main(args + ["--path", str(tmp_path / "u"), "--materialize",
                                  "--no_fold_tail"])
    np.testing.assert_allclose(unfolded, mat, rtol=1e-5)
    with open(frame_log) as f:
        assert len(f.readlines()) == 4
    recal = teval.main(args + ["--path", str(tmp_path / "r"), "--bn_recalib"])
    assert np.isfinite(recal) and recal != plain
    # --bn_recalib against JAX's CLI on the same weights (the port's
    # checkpoint through import_torch_x4) and frames: both recalibrate the
    # decoder alone, on the HR image
    sd = checkpoint_state_dict(load_checkpoint(ckpt))
    jfile = jckpt.save_weights(str(tmp_path), *jckpt.import_torch_x4(sd, JaxX4(
        jarch.SearchSpace())), "jax.ckpt")
    jrecal = jeval.main(["--synthetic", "--dataset", "div2k", "--image_size", "16",
                         "--x4_autoencoder", "--bn_recalib", "--checkpoint", jfile,
                         "--path", str(tmp_path / "j")])
    np.testing.assert_allclose(recal, jrecal, **TOL)


def test_kd_teacher_checkpoint_is_port_native(tmp_path):
    """--kd_teacher loads the port's own checkpoint strictly: a checkpoint
    of another net is refused."""
    net = OFAMobileNetX4(SearchSpace(width=8, n_stages=1), device="cpu")
    save_checkpoint(str(tmp_path), {"model": net.state_dict()})
    with pytest.raises(RuntimeError):
        _shrink(tmp_path / "run", "depth", 1, "--kd_ratio", "1.0", "--kd_teacher",
                str(tmp_path))
