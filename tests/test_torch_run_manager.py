"""The port's run management (ofa_sr_tpu_torch/train/run_manager.py,
checkpoint.py, bn_recalib.py and SRTrainer.bucketed_eval_step) against the
JAX package's on the CPU, from the same weights (JAX init, then the weight
bridge) and the same synthetic data.

Tolerances: per-epoch train loss, train PSNR and valid PSNR of two epochs
of the teacher configuration (Adam) rtol 2e-3, as tests/test_torch_train.py
holds Adam trajectories; BN recalibration and the bucketed eval rtol 1e-5 /
atol 1e-6 (float32 means summed in another order); subnet sampling,
checkpoints and lenient loads exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.data import SyntheticSRProvider as JaxProvider
from ofa_sr_tpu.models import OFAMobileNetS4 as JaxS4
from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu.train import RunConfig as JaxRunConfig
from ofa_sr_tpu.train import SRRunManager as JaxRunManager
from ofa_sr_tpu.train import SRTrainer as JaxTrainer
from ofa_sr_tpu.train import bn_recalibrate as jax_bn_recalibrate
from ofa_sr_tpu.train import checkpoint as jckpt
from ofa_sr_tpu.train import run_manager as jrm
from ofa_sr_tpu_torch.data import SyntheticSRProvider
from ofa_sr_tpu_torch.models import (
    OFAMobileNetS4,
    SearchSpace,
    SubnetConfig,
    max_subnet,
    uniform_subnet,
)
from ofa_sr_tpu_torch.train import RunConfig, SRRunManager, SRTrainer, bn_recalibrate
from ofa_sr_tpu_torch.train import checkpoint as tckpt
from ofa_sr_tpu_torch.train import run_manager as trm
from ofa_sr_tpu_torch.train.checkpoint import s4_state_dict_from_jax

SMALL_KW = dict(ks_list=[3, 5, 7], expand_list=[2, 3], depth_list=[1, 2], pixel_d_list=[1, 2],
                n_stages=2, width=8)
TEACHER_KW = dict(ks_list=[5], expand_list=[3], depth_list=[2], pixel_d_list=[1], n_stages=2,
                  width=8)
PROVIDER_KW = dict(n_train=8, n_valid=2, hr_size=16, train_batch_size=4)
EPOCH_TOL = dict(rtol=2e-3, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_net(space_kw=SMALL_KW, seed=0):
    net = JaxS4(jarch.SearchSpace(**space_kw))
    p, s = net.init(jax.random.PRNGKey(seed))
    return net, p, s


def _port_net(p, s, space_kw=SMALL_KW):
    net = OFAMobileNetS4(SearchSpace(**space_kw), device="cpu")
    net.load_state_dict(s4_state_dict_from_jax(p, s))
    return net


def _state_dict_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _manager(path, space_kw=SMALL_KW, **cfg_kw):
    kw = dict(n_epochs=1, base_lr=1e-3, train_batch_size=4, print_frequency=1)
    kw.update(cfg_kw)
    _, p, s = _jax_net(space_kw)
    return SRRunManager(str(path), _port_net(p, s, space_kw), RunConfig(**kw),
                        SyntheticSRProvider(**PROVIDER_KW))


# -- per-epoch parity ---------------------------------------------------------

@pytest.mark.parametrize("bn_frozen", [True, False])
def test_teacher_epochs_match_jax(tmp_path, bn_frozen):
    """Two epochs (one of warmup, one cosine) of the teacher configuration
    at width 8: per-epoch train loss and PSNR, and valid loss and PSNR."""
    kw = dict(n_epochs=1, warmup_epochs=1, base_lr=1e-3, train_batch_size=4,
              bn_frozen=bn_frozen, print_frequency=1)
    jrun = JaxRunManager(str(tmp_path / "jax"), JaxS4(jarch.SearchSpace(**TEACHER_KW)),
                         JaxRunConfig(**kw), JaxProvider(**PROVIDER_KW))
    net = _port_net(jrun.params, jrun.state, TEACHER_KW)
    trun = SRRunManager(str(tmp_path / "port"), net, RunConfig(**kw),
                        SyntheticSRProvider(**PROVIDER_KW))
    for epoch in range(2):
        j = jrun.train_one_epoch(epoch) + jrun.validate()
        t = trun.train_one_epoch(epoch) + trun.validate()
        np.testing.assert_allclose(t, j, err_msg="epoch %d" % epoch, **EPOCH_TOL)
    if bn_frozen:  # the running statistics never moved
        ref = _port_net(*_jax_net(TEACHER_KW)[1:], TEACHER_KW).state_dict()
        assert all(torch.equal(v, ref[k]) for k, v in net.state_dict().items() if "running" in k)


def test_train_loop_logs_and_files_match_jax(tmp_path):
    """train(): the same best PSNR and epochs; net_info.txt (parameter
    count, space), run.config, logs and checkpoint files."""
    jrun = JaxRunManager(str(tmp_path / "jax"), JaxS4(jarch.SearchSpace(**SMALL_KW)),
                         JaxRunConfig(n_epochs=2, base_lr=1e-3, train_batch_size=4),
                         JaxProvider(**PROVIDER_KW))
    trun = SRRunManager(str(tmp_path / "port"), _port_net(jrun.params, jrun.state),
                        RunConfig(n_epochs=2, base_lr=1e-3, train_batch_size=4),
                        SyntheticSRProvider(**PROVIDER_KW))
    np.testing.assert_allclose(trun.train(), jrun.train(), **EPOCH_TOL)
    info = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "net_info.txt") as f:
            info[name] = json.loads(f.read())
    assert info["port"]["param_count"] == info["jax"]["param_count"]
    assert info["port"]["space"]["ks_list"] == info["jax"]["space"]["ks_list"]
    with open(tmp_path / "port" / "run.config") as f:
        assert json.load(f)["n_epochs"] == 2
    for f in ("checkpoint/latest.txt", "checkpoint/checkpoint.pth.tar",
              "checkpoint/model_best.pth.tar", "logs/train_console.txt",
              "logs/valid_console.txt"):
        assert os.path.isfile(tmp_path / "port" / f), f
    with open(tmp_path / "port" / "logs" / "train_console.txt") as f:
        # print_frequency 10 over 2 steps: each epoch logs its last step
        assert sum(line.startswith("Train [") for line in f) == 2


# -- subnet sampling ----------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(sandwich_rule=True), dict(reference_quirks=True),
                                dict(sandwich_rule=True, reference_quirks=True)])
def test_sample_archs_match_jax(tmp_path, kw):
    space_kw = dict(SMALL_KW, n_stages=4)
    cfg = dict(kw, dynamic_batch_size=3)
    jrun = JaxRunManager(str(tmp_path / "jax"), JaxS4(jarch.SearchSpace(**space_kw)),
                         JaxRunConfig(**cfg), JaxProvider(**PROVIDER_KW))
    trun = SRRunManager(str(tmp_path / "port"), OFAMobileNetS4(SearchSpace(**space_kw),
                                                               device="cpu"),
                        RunConfig(**cfg), SyntheticSRProvider(**PROVIDER_KW))
    fixed = uniform_subnet(trun.net.space, 5, 3, 2, 1)
    for cons in (None, dict(ks_candidates=[5, 7], pixel_d_candidates=[1])):
        for epoch, n_batch, i in ((0, 50, 0), (0, 50, 7), (3, 4, 2)):
            _, jd = jrun.sample_archs(epoch, n_batch, i, cons)
            td = trun.sample_archs(epoch, n_batch, i, cons)
            assert [(c.ks, c.e, c.d, c.pixel_d) for c in td] == \
                [(c.ks, c.e, c.d, c.pixel_d) for c in jd]
            assert [c.describe() for c in td] == [c.describe() for c in jd]
    _, jd = jrun.sample_archs(1, 4, 0, None, jarch.uniform_subnet(jrun.net.space, 5, 3, 2, 1))
    td = trun.sample_archs(1, 4, 0, None, fixed)
    assert [(c.ks, c.e, c.d, c.pixel_d) for c in td] == [(c.ks, c.e, c.d, c.pixel_d) for c in jd]


# -- BN recalibration ---------------------------------------------------------

def test_bn_recalibrate_matches_jax():
    """Running statistics become the batch-size-weighted average of each
    batch's mean and biased variance for the subnet's BNs (against JAX and,
    for the first BN, against moments taken here by hand); the statistics
    it never touches, and every weight, keep their values."""
    jnet, p, s = _jax_net()
    rng = np.random.RandomState(3)
    batches = [{"image": rng.rand(n, 16, 16, 3).astype(np.float32)} for n in (4, 2, 3)]
    jcfg = jarch.SubnetConfig(ks=(3, 5, 7, 3), e=(2, 3, 2, 2), d=(1, 2), pixel_d=1)
    js = jax_bn_recalibrate(jnet, p, s, jcfg.to_device(jnet.space), 1, batches)
    ref = s4_state_dict_from_jax(p, js)

    net = _port_net(p, s)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    bn_recalibrate(net, SubnetConfig(ks=jcfg.ks, e=jcfg.e, d=jcfg.d, pixel_d=1), 1, batches)
    got = net.state_dict()
    touched = 0
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), err_msg=k, **TOL)
        if "running" in k and not torch.equal(v, before[k]):
            touched += 1
        elif "running" not in k:
            assert torch.equal(v, before[k]), k
    assert touched > 0
    # untouched: stage 0's second block (d[0] = 1) and the second shuffle conv
    for k in ("blocks.1.mobile_inverted_conv.inverted_bottleneck.bn.running_mean",
              "blocks.5.bn.running_var"):
        assert torch.equal(got[k], before[k]), k
    # the first BN by hand: weighted mean of each batch's moments of its conv
    w = net.dec_first_conv_block.conv.weight.detach()
    means, variances, ns = [], [], []
    for b in batches:
        y = torch.nn.functional.conv2d(torch.from_numpy(b["image"]).permute(0, 3, 1, 2), w,
                                       padding=2)
        means.append(y.mean((0, 2, 3)))
        variances.append(y.var((0, 2, 3), correction=0))
        ns.append(b["image"].shape[0])
    n = sum(ns)
    np.testing.assert_allclose(got["dec_first_conv_block.bn.running_mean"].numpy(),
                               sum(m * k for m, k in zip(means, ns)).numpy() / n, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["dec_first_conv_block.bn.running_var"].numpy(),
                               sum(v * k for v, k in zip(variances, ns)).numpy() / n, rtol=1e-5)
    # the modules' BN settings are back as they were
    bn = net.dec_first_conv_block.bn
    assert bn.momentum == 0.1 and not hasattr(bn, "update_var")


def test_validate_recalib_restores_and_reset_running_statistics(tmp_path):
    rm = _manager(tmp_path, bn_recalib_before_eval=True)
    before = {k: v.clone() for k, v in rm.net.state_dict().items()}
    frame_log = str(tmp_path / "frames.jsonl")
    cfg = max_subnet(rm.net.space)
    plain = rm.validate(cfg)
    recal = rm.validate(cfg, recalib_loader=rm.provider.build_sub_train_loader(4, 2),
                        frame_log=frame_log)
    assert recal != plain and _state_dict_equal(rm.net.state_dict(), before)
    with open(frame_log) as f:
        rows = [json.loads(line) for line in f]
    assert [r["frame"] for r in rows] == [0, 1] and np.isclose(np.mean([r["psnr"] for r in rows]),
                                                              recal[1])
    rm.reset_running_statistics(cfg, n_images=4, batch_size=2)
    assert not _state_dict_equal(rm.net.state_dict(), before)
    assert np.isclose(rm.validate(cfg)[1], recal[1], rtol=1e-6)


# -- bucketed eval ------------------------------------------------------------

@pytest.mark.parametrize("pixel_d", [1, 2])
def test_bucketed_eval_matches_jax(pixel_d):
    """A 5x7 LR frame zero-padded to 8x8: the bucketed step's loss, PSNR-Y
    and valid output against JAX's make_bucketed_eval_step, and against the
    port's own eval step on the unpadded frame; _bucket_pad as JAX's."""
    jnet, p, s = _jax_net()
    rng = np.random.RandomState(pixel_d)
    f = 2 ** pixel_d
    frame = {"image": rng.rand(2, 5 * f, 7 * f, 3).astype(np.float32),
             "x%d" % f: rng.rand(2, 5, 7, 3).astype(np.float32)}
    padded = trm._bucket_pad(frame, pixel_d, 4)
    jpad = jrm._bucket_pad(frame, pixel_d, 4)
    assert sorted(padded) == sorted(jpad)
    for k in jpad:
        assert np.array_equal(padded[k], jpad[k]), k
    jcfg = jarch.sample_subnet(jnet.space, seed=11, pixel_d_candidates=[pixel_d])
    ref = JaxTrainer(jnet, remat=False).make_bucketed_eval_step(pixel_d)(
        p, s, {k: jnp.asarray(v) for k, v in jpad.items()}, jcfg.to_device(jnet.space))
    tr = SRTrainer(_port_net(p, s))
    cfg = SubnetConfig(ks=jcfg.ks, e=jcfg.e, d=jcfg.d, pixel_d=pixel_d)
    batch = {k: (tuple(v) if k == "valid_hw" else torch.from_numpy(v)) for k, v in padded.items()}
    got = tr.bucketed_eval_step(batch, cfg)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), **TOL)
    np.testing.assert_allclose(float(got["psnr"]), float(ref["psnr"]), **TOL)
    valid = (slice(None), slice(0, 5 * f), slice(0, 7 * f))
    np.testing.assert_allclose(got["output"][valid].numpy(), np.asarray(ref["output"])[valid],
                               rtol=1e-4, atol=1e-4)
    plain = tr.eval_step({k: torch.from_numpy(v) for k, v in frame.items()}, cfg)
    np.testing.assert_allclose(float(got["loss"]), float(plain["loss"]), **TOL)
    np.testing.assert_allclose(float(got["psnr"]), float(plain["psnr"]), **TOL)


def test_validate_eval_bucket_matches_jax(tmp_path):
    kw = dict(n_epochs=1, train_batch_size=4, eval_bucket=6)
    jrun = JaxRunManager(str(tmp_path / "jax"), JaxS4(jarch.SearchSpace(**SMALL_KW)),
                         JaxRunConfig(**kw), JaxProvider(**PROVIDER_KW))
    trun = SRRunManager(str(tmp_path / "port"), _port_net(jrun.params, jrun.state),
                        RunConfig(**kw), SyntheticSRProvider(**PROVIDER_KW))
    jcfg = jarch.uniform_subnet(jrun.net.space, 5, 3, 2, 2)
    got = trun.validate(uniform_subnet(trun.net.space, 5, 3, 2, 2))
    np.testing.assert_allclose(got, jrun.validate(jcfg), **TOL)
    trun.run_config.eval_bucket = None
    np.testing.assert_allclose(got, trun.validate(uniform_subnet(trun.net.space, 5, 3, 2, 2)),
                               **TOL)


# -- checkpoints --------------------------------------------------------------

def test_checkpoint_roundtrip_and_resume(tmp_path):
    rm = _manager(tmp_path / "a")
    rm.train()
    rm2 = _manager(tmp_path / "a")
    with torch.no_grad():
        for prm in rm2.net.parameters():
            prm.add_(1.0)
    rm2.load_model()
    assert rm2.start_epoch == 1 and rm2.best_acc == rm.best_acc
    assert _state_dict_equal(rm2.net.state_dict(), rm.net.state_dict())
    s1, s2 = rm.trainer.opt.state_dict(), rm2.trainer.opt.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    for k, st in s1["state"].items():
        assert all(torch.equal(v, s2["state"][k][n]) for n, v in st.items())
    rm2.run_config.n_epochs = 2
    epochs = []
    real = rm2.train_one_epoch
    rm2.train_one_epoch = lambda e, *a: (epochs.append(e), real(e, *a))[1]
    rm2.train()
    assert epochs == [1]
    with open(tmp_path / "a" / "checkpoint" / "latest.txt") as f:
        assert f.read().strip().endswith("checkpoint.pth.tar")
    best = tckpt.load_checkpoint(str(tmp_path / "a" / "checkpoint" / "model_best.pth.tar"))
    assert sorted(best) == ["model"]


def test_missing_checkpoint_is_graceful(tmp_path):
    rm = _manager(tmp_path)
    before = {k: v.clone() for k, v in rm.net.state_dict().items()}
    rm.load_model()
    assert rm.start_epoch == 0 and _state_dict_equal(rm.net.state_dict(), before)
    with open(tmp_path / "logs" / "valid_console.txt") as f:
        assert "fail to load checkpoint" in f.read()


def test_lenient_load_across_spaces_matches_jax(tmp_path):
    """A ks [7] / expand [4] checkpoint into a ks [3, 5, 7] / expand [2, 3]
    net: the first, final, shuffle and output convs load; the transform
    matrices (absent) and the MBConv banks (other widths) keep their init,
    as JAX's load_weights_lenient keeps them."""
    src_kw = dict(SMALL_KW, ks_list=[7], expand_list=[4])
    _, sp, ss = _jax_net(src_kw, seed=1)
    jnet, tp, ts = _jax_net(seed=2)
    jckpt.save_checkpoint(str(tmp_path / "jax"), {"epoch": 0, "params": sp, "state": ss})
    jp, js, jstats = jckpt.load_weights_lenient(str(tmp_path / "jax"), tp, ts)

    src = _port_net(sp, ss, src_kw)
    rm = _manager(tmp_path / "port")
    rm.net.load_state_dict(s4_state_dict_from_jax(tp, ts))
    tckpt.save_checkpoint(str(tmp_path / "src"), {"epoch": 0, "model": src.state_dict()})
    rm.load_weights(str(tmp_path / "src"))
    ref = s4_state_dict_from_jax(jp, js)
    got = rm.net.state_dict()
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    own = {k for k in got if not k.endswith("num_batches_tracked")}
    kept = {k for k in own if not torch.equal(got[k], src.state_dict().get(k, got[k] + 1))}
    assert any(k.endswith("_matrix") for k in kept) and jstats["kept_template"] > 0
    with open(tmp_path / "port" / "logs" / "valid_console.txt") as f:
        assert "kept fresh init" in f.read()
    # a reference .pth.tar: {"state_dict"} under DataParallel's "module."
    net = _port_net(tp, ts)
    torch.save({"state_dict": {"module." + k: v for k, v in src.state_dict().items()}},
               str(tmp_path / "ref.pth.tar"))
    stats = tckpt.load_weights_lenient(str(tmp_path / "ref.pth.tar"), net)
    assert _state_dict_equal(net.state_dict(), got)
    assert stats == {"kept_template": len(kept) + sum(k.endswith("num_batches_tracked")
                                                      and k in kept for k in got),
                     "dropped": 0}


def test_save_frequency_skips_intermediate_epochs(tmp_path):
    saves = []
    rm = _manager(tmp_path, n_epochs=5, validation_frequency=1000, save_frequency=3)
    real = rm.save_model
    rm.save_model = lambda **kw: (saves.append(kw["epoch"]), real(**kw))[1]
    rm.train()
    assert saves == [2, 4]
    with pytest.raises(ValueError):
        RunConfig(save_frequency=0)


def test_gate_corners_writes_files(tmp_path):
    rm = _manager(tmp_path, corner_gate=True, n_epochs=2)
    sp = rm.net.space
    corners = [("max", max_subnet(sp)), ("min", uniform_subnet(sp, 3, 2, 1, 1))]
    rm.train(validate_cfgs=corners)
    ck = tmp_path / "checkpoint"
    for name in ("max", "min"):
        assert tckpt.load_checkpoint(str(ck / ("best_%s.pth.tar" % name))).keys() == {"model"}
    with open(ck / "corner_best.json") as f:
        book = json.load(f)
    assert sorted(book) == ["max", "min"] and book["max"]["where"].startswith("epoch ")
    # no better PSNR: nothing is rewritten; latest.txt stays the rolling one
    stamp = os.path.getmtime(ck / "best_max.pth.tar")
    rm.gate_corners([("max", -1.0)], where="stage 1 end")
    assert os.path.getmtime(ck / "best_max.pth.tar") == stamp
    rm.gate_corners([("new", 1.0)], where="warmstart")
    with open(ck / "corner_best.json") as f:
        assert json.load(f)["new"] == {"psnr": 1.0, "where": "warmstart"}
    with open(ck / "latest.txt") as f:
        assert f.read().strip().endswith("checkpoint.pth.tar")


def test_unported_options_raise(tmp_path):
    _, p, s = _jax_net()
    with pytest.raises(NotImplementedError, match="item 10"):
        SRRunManager(str(tmp_path), _port_net(p, s), RunConfig(),
                     SyntheticSRProvider(**PROVIDER_KW), mesh=object())
    with pytest.raises(NotImplementedError, match="item 9"):
        SRRunManager(str(tmp_path), _port_net(p, s), RunConfig(mode="autoencoder"),
                     SyntheticSRProvider(**PROVIDER_KW))
    with pytest.raises(ValueError):
        trm._compute_dtype_of(RunConfig(compute_dtype="fp8"))
