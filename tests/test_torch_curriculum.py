"""The port's curriculum script (ofa_sr_tpu_torch/exp/curriculum.py) and its
headline (exp/merge_curriculum_reports.py) against the JAX scripts
(exp/curriculum.py, exp/merge_curriculum_reports.py, loaded from their
files and not edited), on the CPU.

Exact where the work is pure: the image tree pixel for pixel, the phase
table and validation grids, the argv each side hands its CLIs (up to the
port's `--device` and the side's directory name), the headline and the
merge's deltas, the resume gate and sentinel. The bicubic floor within
1e-3 dB; one epoch of the teacher from the same init (the port's, carried
into the JAX script through `import_torch_s4`) within rtol 2e-3 of the JAX
script's PSNR-Y. A whole chain (every phase at full width on 8 px crops)
runs on the port alone: a few steps from a random init diverge between
backends in float32, so it is held to its own files and resume.
"""

import copy
import importlib.util
import json
import math
import os
import types

import numpy as np
import pytest
import torch

from ofa_sr_tpu_torch.exp import curriculum as pcur
from ofa_sr_tpu_torch.exp import merge_curriculum_reports as pmerge
from ofa_sr_tpu_torch.train.shrink import corner_name

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BICUBIC_TOL_DB = 1e-3
TEACHER_RTOL = 2e-3


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(REPO, "exp", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jcur = _load("curriculum")
jmerge = _load("merge_curriculum_reports")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The full-width X4 on 8 px crops runs faster on one thread, and one
    thread a module keeps parallel test workers from oversubscribing the
    CPU; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pixels(root):
    from PIL import Image
    out = {}
    for split in ("train", "val"):
        for name in sorted(os.listdir(os.path.join(root, split))):
            with Image.open(os.path.join(root, split, name)) as im:
                out[(split, name)] = np.asarray(im)
    return out


@pytest.mark.parametrize("style", ["lowpass", "sharp"])
def test_gen_tree_pixel_equal(tmp_path, style):
    pcur.gen_tree(str(tmp_path / "port"), n_train=3, n_val=2, size=48, seed=5, style=style)
    jcur.gen_tree(str(tmp_path / "jax"), n_train=3, n_val=2, size=48, seed=5, style=style)
    port, ref = _pixels(tmp_path / "port"), _pixels(tmp_path / "jax")
    assert sorted(port) == sorted(ref) and len(port) == 5
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k])


@pytest.mark.parametrize("sandwich", [False, True])
def test_phase_table_and_grid_corners(sandwich):
    a = types.SimpleNamespace(sandwich=sandwich, phase_epochs=3, phase_lr=5e-4)
    table = pcur.phase_table(a)
    assert table == jcur.phase_table(a)
    for _, spec in table:
        assert pcur.grid_corners(spec) == jcur.grid_corners(spec)


def _port_args(tmp_path, *extra):
    return pcur.build_parser().parse_args(
        ["--out", str(tmp_path / "out"), "--data_root", str(tmp_path / "data"),
         "--device", "cpu"] + list(extra))


def _jax_args(a, out):
    """The JAX script's namespace for the port's run `a`."""
    cfg = {k: v for k, v in vars(a).items() if k not in ("resume_report", "device")}
    return types.SimpleNamespace(**dict(cfg, out=out, jax_resume_report=None))


def _recorder(calls):
    def main(argv):
        calls.append(list(argv))
        os.makedirs(argv[argv.index("--path") + 1], exist_ok=True)
        return 0.0
    return main


@pytest.mark.parametrize("extra", [
    [],
    ["--pretrain_epochs", "2", "--kd_ratio", "0.5", "--sandwich", "--gate_frequency", "2",
     "--clip_grad_norm", "5", "--seed", "3"],
], ids=["defaults", "kd-sandwich-gate"])
def test_cli_argv_match_jax(tmp_path, monkeypatch, extra):
    from ofa_sr_tpu.cli import train_ofa_net_sr_simple as jshrink
    from ofa_sr_tpu.cli import train_teacher_net_sr_simple as jteacher
    a = _port_args(tmp_path, *extra)
    port_calls, jax_calls = [], []
    monkeypatch.setattr(pcur.train_teacher_net_sr_simple, "main", _recorder(port_calls))
    monkeypatch.setattr(pcur.train_ofa_net_sr_simple, "main", _recorder(port_calls))
    monkeypatch.setattr(pcur, "grid_eval", lambda a, task, path: {})
    monkeypatch.setattr(pcur, "save_init_checkpoint", lambda sd, out_dir: out_dir)
    pcur.run_port_curriculum(a, {"teacher": None, "supernet": None}, {"x2": 0.0, "x4": 0.0})
    monkeypatch.setattr(jteacher, "main", _recorder(jax_calls))
    monkeypatch.setattr(jshrink, "main", _recorder(jax_calls))
    monkeypatch.setattr(jcur, "grid_eval_jax", lambda a, task, path: {})
    monkeypatch.setattr(jcur, "save_init_checkpoint", lambda sd, which, net, out_dir: out_dir)
    monkeypatch.setattr(jcur, "bicubic_baseline", lambda a: {"x2": 0.0, "x4": 0.0})
    jcur.run_jax_curriculum(_jax_args(a, a.out), {"teacher": None, "supernet": None})
    n_phases = 5 + (1 if a.pretrain_epochs else 0)
    assert len(port_calls) == len(jax_calls) == n_phases
    sep = os.sep
    for got, ref in zip(port_calls, jax_calls):
        i = got.index("--device")
        assert got[i + 1] == "cpu"
        got = got[:i] + got[i + 2:]
        assert got == [r.replace(sep + "jax" + sep, sep + "port" + sep) for r in ref]


def _tree(tmp_path, n_train=4, img=32):
    root = str(tmp_path / "data")
    pcur.gen_tree(root, n_train=n_train, n_val=2, size=img, seed=pcur.SEED, style="sharp")
    return root


def test_bicubic_baseline_matches_jax(tmp_path):
    _tree(tmp_path)
    a = _port_args(tmp_path, "--crop", "16", "--bs", "2", "--n_val", "2")
    got, ref = pcur.bicubic_baseline(a), jcur.bicubic_baseline(_jax_args(a, a.out))
    assert sorted(got) == sorted(ref) == ["x2", "x4"]
    for k in ref:
        assert abs(got[k] - ref[k]) <= BICUBIC_TOL_DB, (k, got[k], ref[k])
        assert 10 < got[k] < 60


def test_teacher_one_epoch_matches_jax(tmp_path):
    _tree(tmp_path)
    flags = ["--n_train", "4", "--n_val", "2", "--img", "32", "--crop", "16", "--bs", "2",
             "--teacher_epochs", "1", "--teacher_only", "--style", "sharp"]
    a = _port_args(tmp_path, *flags)
    rep = pcur.main(["--out", a.out, "--data_root", a.data_root, "--device", "cpu"] + flags)
    assert set(rep) >= {"config", "baseline_bicubic", "port", "port_sec", "headline"}
    assert os.path.isfile(os.path.join(a.out, "port", "teacher", "PHASE_DONE.json"))
    jres = jcur.run_jax_curriculum(_jax_args(a, str(tmp_path / "jax_out")),
                                   {"teacher": pcur.make_port_inits(a.seed)["teacher"]})
    got, ref = rep["port"]["teacher"], jres["teacher"]
    assert list(got) == list(ref) == ["K5-E3-D2-PD1"]
    assert math.isfinite(got["K5-E3-D2-PD1"])
    assert got["K5-E3-D2-PD1"] == pytest.approx(ref["K5-E3-D2-PD1"], rel=TEACHER_RTOL)
    assert rep["headline"]["teacher_psnr_x2"] == got["K5-E3-D2-PD1"]


def _halves(path):
    """The JAX and torch halves of a committed merged report."""
    with open(os.path.join(REPO, path)) as f:
        rep = json.load(f)
    common = {"config": rep["config"], "baseline_bicubic": rep["baseline_bicubic"]}
    if rep.get("partial"):
        common["partial"] = True
    jr = dict(common, jax=rep["jax"], jax_sec=rep.get("jax_sec"))
    tr = dict(common, torch=rep["torch"], torch_sec=rep.get("torch_sec"))
    return jr, tr


@pytest.mark.parametrize("path", ["CURRICULUM_r03.json", "CURRICULUM_r04.json",
                                  "CURRICULUM_r05_KD_ABLATION.json"])
def test_headline_and_merge_match_jax(path):
    jr, tr = _halves(path)
    ref = jmerge.merge(copy.deepcopy(jr), copy.deepcopy(tr))
    oracle = ("oracle_delta_mean_db", "oracle_delta_max_abs_db")
    own = pmerge.headline(jr, "jax")
    assert set(own) == set(ref["headline"])
    for k in own:
        if k in oracle:
            assert own[k] is None
        else:
            assert own[k] == ref["headline"][k], k
    pr = {k: v for k, v in tr.items() if k not in ("torch", "torch_sec")}
    pr.update(port=tr["torch"], port_sec=tr.get("torch_sec"))
    got = pmerge.merge(copy.deepcopy(jr), pr)
    assert got["headline"] == ref["headline"]
    assert got["delta_jax_minus_port"] == ref["delta_jax_minus_torch"]
    assert got.get("partial") == ref.get("partial")
    if ref.get("partial"):
        assert got["phases_missing_port"] == ref["phases_missing_torch"]
        assert got["phases_missing_jax"] == ref["phases_missing_jax"]


def test_merge_refuses_other_data():
    jr, tr = _halves("CURRICULUM_r05_KD_ABLATION.json")
    pr = {"config": dict(tr["config"], n_train=1), "baseline_bicubic": tr["baseline_bicubic"],
          "port": tr["torch"]}
    with pytest.raises(SystemExit, match="config mismatch on 'n_train'"):
        pmerge.merge(jr, pr)
    pr = {"config": tr["config"], "port": tr["torch"],
          "baseline_bicubic": dict(tr["baseline_bicubic"], x4=tr["baseline_bicubic"]["x4"] + 1)}
    with pytest.raises(SystemExit, match="bicubic baselines differ"):
        pmerge.merge(jr, pr)


# ---- resume: precedence, unreadable reports, the config gate, the sentinel
# (the cases of tests/test_curriculum_resume.py on the port's functions) ---

# every config key any phase's resume gate reads
_CFG = dict(n_train=64, n_val=8, img=192, crop=96, bs=16, style="sharp",
            clip_grad_norm=0.0, seed=0, teacher_epochs=40, teacher_lr=1e-3,
            pretrain_epochs=98, pretrain_lr=1e-3, phase_epochs=4,
            phase_lr=2.5e-4, kd_ratio=0.0, sandwich=False, gate_frequency=0)


def _args(out, resume=None, **over):
    return types.SimpleNamespace(out=str(out), resume_report=resume, **dict(_CFG, **over))


def _report(phases, side="port", **cfg_over):
    return json.dumps({"config": dict(_CFG, **cfg_over), side: phases})


def _case_no_inputs(tmp):
    assert pcur._resumable_results(_args(tmp)) == {}


def _case_report_trusted(tmp):
    rep = tmp / "CURRICULUM.json"
    rep.write_text(_report({"teacher": {"K5-E3-D2-PD1": 27.37}}))
    assert pcur._resumable_results(_args(tmp, str(rep))) == {"teacher": {"K5-E3-D2-PD1": 27.37}}


def _case_partial_overrides_report(tmp):
    # the out-dir's own partial report (checkpoints intact) wins over an
    # older report's number for the same phase
    rep = tmp / "CURRICULUM.json"
    rep.write_text(_report({"teacher": {"K5-E3-D2-PD1": 27.0},
                            "pretrain": {"K7-E6-D4-PD2": 24.0}}))
    (tmp / "report_partial_port.json").write_text(_report({"pretrain": {"K7-E6-D4-PD2": 24.9}}))
    done = pcur._resumable_results(_args(tmp, str(rep)))
    assert done == {"teacher": {"K5-E3-D2-PD1": 27.0}, "pretrain": {"K7-E6-D4-PD2": 24.9}}


def _case_unreadable_skipped(tmp):
    rep = tmp / "broken.json"
    rep.write_text("{not json")
    (tmp / "report_partial_port.json").write_text(_report({"teacher": {"K5-E3-D2-PD1": 27.37}}))
    assert pcur._resumable_results(_args(tmp, str(rep))) == {"teacher": {"K5-E3-D2-PD1": 27.37}}


def _case_other_side_only(tmp):
    rep = tmp / "jax_only.json"
    rep.write_text(_report({"teacher": {"K5-E3-D2-PD1": 27.36}}, side="jax"))
    assert pcur._resumable_results(_args(tmp, str(rep))) == {}


def _case_config_mismatch_refuses_phase(tmp):
    rep = tmp / "CURRICULUM.json"
    rep.write_text(_report({"teacher": {"K5-E3-D2-PD1": 27.37},
                            "pretrain": {"K7-E6-D4-PD2": 24.9}}, pretrain_epochs=10))
    # the teacher's keys leave out pretrain_epochs: still donated
    assert pcur._resumable_results(_args(tmp, str(rep))) == {"teacher": {"K5-E3-D2-PD1": 27.37}}


def _case_data_mismatch_refuses_all(tmp):
    rep = tmp / "CURRICULUM.json"
    rep.write_text(_report({"teacher": {"K5-E3-D2-PD1": 27.37},
                            "pretrain": {"K7-E6-D4-PD2": 24.9}}, style="lowpass"))
    assert pcur._resumable_results(_args(tmp, str(rep))) == {}


def _case_missing_key_compares_to_default(tmp):
    # a report older than a flag is resumable at the flag's default (kd_ratio
    # 0.0) and refused away from it
    raw = json.loads(_report({"kernel": {"K3-E6-D4-PD2": 24.5}}))
    del raw["config"]["kd_ratio"]
    rep = tmp / "CURRICULUM.json"
    rep.write_text(json.dumps(raw))
    assert "kernel" in pcur._resumable_results(_args(tmp, str(rep)))
    assert pcur._resumable_results(_args(tmp, str(rep), kd_ratio=0.5)) == {}


def _case_dir_alone_incomplete(tmp):
    # the run manager makes checkpoint/ before any save
    os.makedirs(tmp / "checkpoint")
    assert not pcur._phase_complete(str(tmp))


def _case_checkpoint_without_sentinel(tmp):
    os.makedirs(tmp / "checkpoint")
    (tmp / "checkpoint" / "latest.txt").write_text("checkpoint.pth.tar")
    assert not pcur._phase_complete(str(tmp))


def _case_sentinel_and_checkpoint(tmp):
    os.makedirs(tmp / "checkpoint")
    (tmp / "checkpoint" / "latest.txt").write_text("checkpoint.pth.tar")
    pcur._mark_phase_complete(str(tmp), "kernel", {"K3-E6-D4-PD2": 24.5})
    assert pcur._phase_complete(str(tmp))
    with open(tmp / "PHASE_DONE.json") as f:
        assert json.load(f)["task"] == "kernel"


RESUME_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_no_inputs, _case_report_trusted, _case_partial_overrides_report,
    _case_unreadable_skipped, _case_other_side_only, _case_config_mismatch_refuses_phase,
    _case_data_mismatch_refuses_all, _case_missing_key_compares_to_default,
    _case_dir_alone_incomplete, _case_checkpoint_without_sentinel,
    _case_sentinel_and_checkpoint)}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume(tmp_path, case):
    RESUME_CASES[case](tmp_path)


# ---- the whole chain on the port ------------------------------------------

CHAIN = ["--n_train", "4", "--n_val", "2", "--img", "32", "--crop", "8", "--bs", "2",
         "--teacher_epochs", "1", "--pretrain_epochs", "1", "--phase_epochs", "1",
         "--style", "sharp", "--device", "cpu"]


def test_full_chain_and_rerun(tmp_path, monkeypatch):
    out = str(tmp_path / "cur")
    rep = pcur.main(["--out", out] + CHAIN)
    a = pcur.build_parser().parse_args(["--out", out] + CHAIN)
    expect = {"teacher": ["K5-E3-D2-PD1"], "pretrain": ["K7-E6-D4-PD2"]}
    for task, spec in pcur.phase_table(a):
        expect[task] = [corner_name(pd, d, e, k) for k, e, d, pd in pcur.grid_corners(spec)]
    assert {t: sorted(v) for t, v in rep["port"].items()} == \
        {t: sorted(v) for t, v in expect.items()}
    for task, corners in rep["port"].items():
        assert all(math.isfinite(v) for v in corners.values()), (task, corners)
        with open(os.path.join(out, "port", task, "PHASE_DONE.json")) as f:
            assert json.load(f) == {"task": task, "results": corners}
    assert os.path.isfile(os.path.join(out, "port", "expand", "expand.stage"))
    with open(os.path.join(out, "report.json")) as f:
        assert json.load(f)["port"] == rep["port"]
    assert rep["headline"]["final_phase"] == "pixelshuffle_depth"
    assert rep["headline"]["oracle_delta_mean_db"] is None

    def refuse(argv):
        raise AssertionError("the rerun trained: %s" % argv)
    monkeypatch.setattr(pcur.train_teacher_net_sr_simple, "main", refuse)
    monkeypatch.setattr(pcur.train_ofa_net_sr_simple, "main", refuse)
    again = pcur.main(["--out", out, "--resume_report", os.path.join(out, "report.json")]
                      + CHAIN)
    assert again["port"] == rep["port"]
    assert again["headline"] == rep["headline"]


def _jax_phase_dir(src_ckpt, dst_ckpt, jnet):
    """A JAX phase checkpoint directory holding the port's phase checkpoint
    and each of its best_<corner>.pth.tar snapshots, through
    `import_torch_x4`, under the JAX package's names."""
    from ofa_sr_tpu.train import checkpoint as jckpt
    from ofa_sr_tpu_torch.train.checkpoint import checkpoint_state_dict, load_checkpoint

    def imported(src):
        return jckpt.import_torch_x4(checkpoint_state_dict(load_checkpoint(src)), jnet)

    p, s = imported(src_ckpt)
    jckpt.save_checkpoint(dst_ckpt, {"params": p, "state": s})
    for f in sorted(os.listdir(src_ckpt)):
        if f.startswith("best_") and f.endswith(".pth.tar"):
            jckpt.save_weights(dst_ckpt, *imported(os.path.join(src_ckpt, f)),
                               f[:-len(".pth.tar")] + ".ckpt")


def test_gated_chain_scores_snapshots_as_jax(tmp_path):
    """--gate_frequency 1: every shrink phase snapshots each corner of its
    grid as best_<corner>.pth.tar (corner_best.json names them), and
    `grid_eval` scores each corner from its snapshot. One expand snapshot
    is replaced by other weights (its convs scaled by 0.8): the expand grid
    then differs on that corner from the rolling checkpoint's grid and
    agrees with JAX's `grid_eval_jax` on the same files (the checkpoint and
    the snapshots through `import_torch_x4`, as best_<corner>.ckpt) within
    one unit of the third decimal both round to. A checkpoint that leaves
    a tensor of the phase's net at its init (the pretrain's, scored as
    the expand phase) is refused."""
    from ofa_sr_tpu.models import OFAMobileNetX4 as JaxX4
    from ofa_sr_tpu.models import arch as jarch
    from ofa_sr_tpu_torch.train.checkpoint import (checkpoint_state_dict, load_checkpoint,
                                                   save_weights)
    out = str(tmp_path / "cur")
    argv = ["--out", out] + CHAIN + ["--gate_frequency", "1"]
    pcur.main(argv)
    a = pcur.build_parser().parse_args(argv)
    a.data_root = os.path.join(out, "data")
    specs = dict(pcur.phase_table(a))
    for task, spec in specs.items():
        ckpt = os.path.join(out, "port", task, "checkpoint")
        names = [corner_name(pd, d, e, k) for k, e, d, pd in pcur.grid_corners(spec)]
        with open(os.path.join(ckpt, "corner_best.json")) as f:
            assert set(names) <= set(json.load(f)), task
        for n in names:
            assert os.path.isfile(os.path.join(ckpt, "best_%s.pth.tar" % n)), (task, n)

    task, spec = "expand", specs["expand"]
    path = os.path.join(out, "port", task)
    ckpt = os.path.join(path, "checkpoint")
    target = corner_name(*reversed(pcur.grid_corners(spec)[0]))
    best_f = os.path.join(ckpt, "best_%s.pth.tar" % target)
    sd = checkpoint_state_dict(load_checkpoint(best_f))
    save_weights(ckpt, {k: v * 0.8 if v.ndim == 4 else v for k, v in sd.items()},
                 os.path.basename(best_f))
    got = pcur.grid_eval(a, task, path)
    rolling_dir = tmp_path / "rolling" / task
    os.makedirs(rolling_dir / "checkpoint")
    for f in os.listdir(ckpt):
        if not f.startswith("best_"):
            with open(os.path.join(ckpt, f), "rb") as src:
                (rolling_dir / "checkpoint" / f).write_bytes(src.read())
    rolling = pcur.grid_eval(a, task, str(rolling_dir))
    assert sorted(got) == sorted(rolling) and got[target] != rolling[target]

    jspace = jarch.SearchSpace(**{k: spec[k] for k in pcur.PRETRAIN_SPACE})
    jpath = tmp_path / "jax" / task
    _jax_phase_dir(ckpt, str(jpath / "checkpoint"), JaxX4(jspace))
    ref = jcur.grid_eval_jax(_jax_args(a, str(tmp_path / "jax_out")), task, str(jpath))
    assert sorted(ref) == sorted(got)
    for n in ref:
        assert abs(got[n] - ref[n]) <= 1e-3 + 1e-9, (n, got[n], ref[n])

    with pytest.raises(ValueError, match="does not hold every tensor"):
        pcur.grid_eval(a, task, os.path.join(out, "port", "pretrain"))


def test_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        pcur.main(["--out", str(tmp_path / "cur"), "--teacher_only"])
    assert not os.path.exists(tmp_path / "cur")
