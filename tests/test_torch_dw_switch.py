"""The masked depthwise levers (`ks_switch`, `dw_switch`, `dw_opts`) of
the port against the JAX package's on the CPU: the plain masked depthwise
(`ops/kernels/dw_masked.py`, the contract of csrc/dw_masked.cu) against
JAX's `_dw_switched` and `ks_switch` branch, forward and gradients, at
the channel bound the port's one lever passes (the sampled width) for each
of JAX's forms; the masked forwards of the S4, the X4 (both modes) and a
narrow MBV3 with each lever against JAX's `apply` with the same lever; the
lever's normalisation and its route (`use_kernels`); the window steps of
`SRTrainer` and `ClsTrainer` with `dw_switch` against JAX's
`make_scan_train_step` with it; a shrink-phase run of `SRRunManager` (JAX
narrows its branches there, `_apply_dw_live`) against JAX's; the CLI flags
against JAX's `perf_config_kw`; and the wrappers counting no launch on CPU
tensors (the kernel itself is held to the plain version on the card by
`chip_smoke.py` phase 2).

Inputs come from numpy seeds; the port's weights cross into JAX through
`import_torch_s4` / `import_torch_x4` (tests/test_torch_scan_trainer.py's
`_twin`, random BN statistics and transform matrices) or come from JAX's
init through `mbv3_state_dict_from_jax` (tests/test_torch_cls_scan_trainer.py's
narrow net). Tolerances:
- the masked depthwise against JAX's branches, y, dx and the gradients of
  the bank and the transform matrices: max |diff| within 1e-6 of the
  tensor's largest magnitude (one depthwise conv after up to two transform
  matrices, float32 sums in another order: y reaches |5| here, and one
  rounding of a 9-term sum of such terms is 5e-7);
- whole masked forwards and running statistics: tests/test_dw_switch.py's
  own, rtol/atol 1e-5 for the SR nets and rtol 1e-4 / atol 1e-5 for MBV3
  (its SE blocks, strides and pooling; JAX measured 2.3e-6 there between
  its two forms);
- the window steps: tests/test_torch_scan_trainer.py's and
  tests/test_torch_cls_scan_trainer.py's (parameters and state rtol 1e-4,
  atol 1e-5, with the Adam "touched" case's atol 2e-5 for the SR window,
  which is Adam with touched masks and KD at once; the window's mean loss
  1e-5);
- the shrink-phase epoch (Adam, 2 steps in one window): rtol 1e-3 / atol
  5e-4, tests/test_dw_switch.py's for its constrained run against the
  masked one (Adam's sqrt(v) normalizer amplifies float32 sums in another
  order where a gradient is near 0);
- the CLI kwargs, the lever's attributes and the launch counts: exact.
"""

import argparse
import concurrent.futures
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ofa_sr_tpu.cli import common as jcli
from ofa_sr_tpu.data import SyntheticSRProvider as JaxProvider
from ofa_sr_tpu.models import OFAMobileNetS4 as JaxS4
from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu.models.layers import _dw_switched, mbconv_init
from ofa_sr_tpu.ops import conv as jconv
from ofa_sr_tpu.ops import elastic as jelastic
from ofa_sr_tpu.train import RunConfig as JaxRunConfig
from ofa_sr_tpu.train import SRRunManager as JaxRunManager
from ofa_sr_tpu.train import SRTrainer as JaxTrainer
from ofa_sr_tpu.train import cls_trainer as jtr
from ofa_sr_tpu.train.touched import cls_touched_mask as jax_cls_touched
from ofa_sr_tpu.train.touched import sr_touched_mask as jax_touched
from ofa_sr_tpu_torch.cli import common as tcli
from ofa_sr_tpu_torch.data import SyntheticSRProvider
from ofa_sr_tpu_torch.models import OFAMobileNetS4, SearchSpace, sample_subnet
from ofa_sr_tpu_torch.models import layers as tlayers
from ofa_sr_tpu_torch.models.layers import set_depthwise_lever
from ofa_sr_tpu_torch.ops import elastic as telastic
from ofa_sr_tpu_torch.ops.kernels import dw_masked as tdw
from ofa_sr_tpu_torch.train import ClsTrainer, RunConfig, SRRunManager, SRTrainer
from ofa_sr_tpu_torch.train.checkpoint import mbv3_state_dict_from_jax, s4_state_dict_from_jax
from ofa_sr_tpu_torch.train.run_manager import depthwise_kw
from test_torch_cls_scan_trainer import _archs, _jarch
from test_torch_cls_scan_trainer import twin as cls_twin
from test_torch_cls_train import batch as cls_batch
from test_torch_cls_train import tbatch
from test_torch_scan_trainer import _bridge, _jcfg, _port_net, _twin

NET_TOL = dict(rtol=1e-5, atol=1e-5)
CLS_NET_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
TOUCHED_STEP_TOL = dict(rtol=1e-4, atol=2e-5)
SHRINK_TOL = dict(rtol=1e-3, atol=5e-4)
# tests/test_dw_switch.py's space: ks 3/5/7 (a 7x7 bank and both transform
# matrices), middle widths {16, 24} at width 8
SMALL_KW = dict(ks_list=[3, 5, 7], expand_list=[2, 3], depth_list=[1, 2],
                pixel_d_list=[1, 2], n_stages=2, width=8)
# the windows' and the shrink phase's: tests/test_scan_trainer.py's SMALL
# (one stage: JAX compiles its branches for each block of a scan step)
WINDOW_KW = dict(ks_list=[3, 5], expand_list=[2, 3], depth_list=[1, 2], pixel_d_list=[1, 2],
                 n_stages=1, width=8)
TEACHER_KW = dict(ks_list=[5], expand_list=[3], depth_list=[2], pixel_d_list=[1],
                  n_stages=1, width=8)
BS, HR = 2, 16
LEVERS = {"dw": dict(dw_switch=True), "project": dict(dw_switch="project"),
          "ks": dict(ks_switch=True), "dw align 8": dict(dw_switch=True, dw_opts={"align": 8})}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def jax_refs():
    """The JAX sides of the window tests and the MBV3 forwards (most of this
    file's time is JAX compiling its depthwise branches), computed in
    threads from the module's start while the tests before them run. Each
    sets its lever on a copy of the net object `cls_twin` caches; a test
    takes its result before it calls `cls_twin` itself."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        yield {"sr window": pool.submit(_jax_sr_window), "cls": pool.submit(_jax_cls)}


def _jax_cls():
    twin = cls_twin("narrow")
    return {"forwards": _jax_cls_forwards(*twin), "window": _jax_cls_window(*twin)}


def _set_jax_lever(jnet, ks_switch=False, dw_switch=False, dw_opts=None):
    """The JAX trainers' assignments (ofa_sr_tpu/train/train_step.py:97-119)."""
    jnet.ks_switch, jnet.dw_switch, jnet.dw_opts = ks_switch, dw_switch, dw_opts


# -- the masked depthwise against JAX's branches ------------------------------------

def _jax_depthwise(mode, stride, align):
    """vjp of JAX's depthwise lever on (bank, matrices, y) at (ks_idx, mid):
    `_dw_switched` ("dw") or the `ks_switch` branch of
    `_masked_mbconv_apply` ("ks", its three lines)."""
    space = jarch.SearchSpace(**SMALL_KW)
    ks_set = sorted(set(space.ks_list))

    def f(p, y, ks_idx, mid, dy):
        def run(w, kt, yy):
            q = {**p, "depth_conv": {**p["depth_conv"], "conv": {"w": w}, "kt": kt}}
            if mode == "dw":
                return _dw_switched(q, yy, space, ks_idx, mid, True, stride,
                                    align=align or None)

            def branch(ks):
                eff = jelastic.transform_kernel_chain(w, kt, space.ks_list, ks, True)
                return lambda z: jconv.depthwise_conv2d(z, eff.astype(w.dtype), stride=stride)
            return lax.switch(ks_idx, [branch(k) for k in ks_set], yy)

        out, vjp = jax.vjp(run, p["depth_conv"]["conv"]["w"], p["depth_conv"]["kt"], y)
        return out, vjp(dy)
    return jax.jit(f)


def _scaled_close(got, ref, what, scaled=1e-6):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= scaled * max(1.0, float(np.abs(ref).max())), (what, err)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", ["dw", "ks"])
def test_masked_depthwise_matches_jax(mode, stride):
    """The plain masked depthwise on the selected candidate (`select_kernel`
    of `kernel_candidates`, the masked step's operand), bounded at the
    width as the port's lever runs it, against JAX's `_dw_switched` (mode
    "dw", with dw_align 0 and 8: its bound rounded up) and its `ks_switch`
    branch (mode "ks": every channel), at widths on the candidate grid 16
    and 24 = C, off it 20, and 0: y, dx and the gradients of the bank and
    both transform matrices, at every kernel size. The activations and
    cotangents are 0 from the width on, as the masked BN leaves them on the
    step's path, which is why every form gives the same values."""
    p, _ = mbconv_init(jax.random.PRNGKey(3), jarch.SearchSpace(**SMALL_KW))
    rng = np.random.RandomState(5)
    c = p["depth_conv"]["conv"]["w"].shape[-1]
    kt = {k: (np.eye(v.shape[0]) + 0.1 * rng.randn(*v.shape)).astype(np.float32)
          for k, v in p["depth_conv"]["kt"].items()}
    p = {**p, "depth_conv": {**p["depth_conv"], "kt": {k: jnp.asarray(v) for k, v in kt.items()}}}
    w_np = np.asarray(p["depth_conv"]["conv"]["w"])
    ho = tdw.out_size(8, 7, stride)
    cases = [(mid, align) for align in ((0, 8) if mode == "dw" else (0,))
             for mid in (0, 16, 20, 24)]
    for align in sorted({a for _, a in cases}):
        jf = _jax_depthwise(mode, stride, align)
        for mid, _ in (cs for cs in cases if cs[1] == align):
            for ks_idx in range(3):
                live = (np.arange(c) < mid).astype(np.float32)
                x = rng.randn(2, 8, 8, c).astype(np.float32) * live
                dy = rng.randn(2, ho, ho, c).astype(np.float32) * live
                out_j, (gw_j, gkt_j, gx_j) = jf(p, jnp.asarray(x), jnp.asarray(ks_idx, jnp.int32),
                                                jnp.asarray(mid, jnp.int32), jnp.asarray(dy))
                wt = torch.from_numpy(np.transpose(w_np, (3, 2, 0, 1)).copy()).requires_grad_()
                mt = {k: torch.from_numpy(v).requires_grad_() for k, v in kt.items()}
                xt = torch.from_numpy(x).requires_grad_()
                kidx = torch.tensor(ks_idx, dtype=torch.int32)
                bound = torch.tensor(mid, dtype=torch.int32)
                sel = telastic.select_kernel(
                    telastic.kernel_candidates(wt, mt, SMALL_KW["ks_list"]), kidx)
                y = tdw.masked_depthwise(xt, sel, kidx, bound, ks_list=SMALL_KW["ks_list"],
                                         stride=stride)
                y.backward(torch.from_numpy(dy))
                what = "%s stride %d mid %d align %d ks_idx %d" % (mode, stride, mid, align, ks_idx)
                _scaled_close(y.detach(), out_j, what + " y")
                _scaled_close(xt.grad, gx_j, what + " dx")
                _scaled_close(wt.grad, np.transpose(np.asarray(gw_j), (3, 2, 0, 1)), what + " dW")
                for k, t in mt.items():
                    _scaled_close(t.grad, gkt_j[k], what + " d" + k)
                assert not y[..., mid:].any() and not xt.grad[..., mid:].any()


EVERY_OPT = {"align": 8, "live": (None, (3,)), "seam": "dus"}


@pytest.mark.parametrize("kw,lever", [
    ({}, False), (dict(ks_switch=True), True), (dict(dw_switch=True), True),
    (dict(dw_switch="dw"), True), (dict(dw_switch="project"), True),
    (dict(ks_switch=True, dw_switch=True, dw_opts=EVERY_OPT), True),
    (dict(dw_opts=EVERY_OPT), False)])
def test_lever_normalised(kw, lever):
    """`set_depthwise_lever` (through `SRTrainer`, as JAX's trainer sets
    its attributes) gives the net its one lever: on for every form of
    `ks_switch` / `dw_switch`, whatever `dw_opts` holds; off by default and
    for `dw_opts` alone, as in JAX."""
    net = OFAMobileNetS4(SearchSpace(**SMALL_KW), device="cpu")
    assert net.dw_lever is False
    SRTrainer(net, **kw)
    assert net.dw_lever is lever


@pytest.mark.parametrize("bad", [dict(dw_switch="branch"), dict(dw_opts={"remat": 1}),
                                 dict(dw_opts={"align": -8})])
def test_lever_refuses_what_jax_would_not_take(bad):
    net = OFAMobileNetS4(SearchSpace(**SMALL_KW), device="cpu")
    with pytest.raises(ValueError):
        set_depthwise_lever(net, **bad)


def test_lever_route_follows_use_kernels(monkeypatch):
    """With the lever, `forward_masked` takes `masked_depthwise` (the kernel
    on a CUDA tensor) when `use_kernels` is on and the plain version when it
    is off, bounded at the width either way, and the two agree; without the
    lever it takes neither."""
    calls = []

    def spy(name, fn):
        def run(x, w, ks_idx, bound, **kw):
            calls.append((name, int(bound)))
            return fn(x, w, ks_idx, bound, **kw)
        monkeypatch.setattr(tlayers, name, run)
    spy("masked_depthwise", tdw.masked_depthwise)
    spy("masked_depthwise_reference", tdw.masked_depthwise_reference)
    net = OFAMobileNetS4(SearchSpace(**SMALL_KW), device="cpu")
    block = net.dec_blocks[0]
    c = block.mobile_inverted_conv.depth_conv.conv.weight.shape[0]
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 6, 6, net.space.width)
                         .astype(np.float32))
    kidx, mid = torch.tensor(1, dtype=torch.int32), torch.tensor(c - 8, dtype=torch.int32)
    ys = {}
    for lever, use_kernels in ((True, True), (True, False), (False, True)):
        with torch.no_grad():
            ys[lever, use_kernels] = block.forward_masked(x, kidx, mid, bn_training=True,
                                                          use_kernels=use_kernels,
                                                          dw_lever=lever)
    assert calls == [("masked_depthwise", c - 8), ("masked_depthwise_reference", c - 8)]
    for y in (ys[True, False], ys[False, True]):
        np.testing.assert_allclose(ys[True, True].numpy(), y.numpy(), **NET_TOL)


def test_wrappers_on_cpu_launch_nothing():
    """The three directions on CPU tensors take the plain version (its
    autograd for dx and dW) and count no launch, f32 and bf16; the
    standalone dgrad and wgrad equal the autograd's."""
    before = [(f.launches, f.launches_bf16) for f in (tdw.dw_masked_forward,
                                                      tdw.dw_masked_dgrad, tdw.dw_masked_wgrad)]
    rng = np.random.RandomState(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.randn(2, 6, 6, 12).astype(np.float32)).to(dtype)
        w = torch.from_numpy(rng.randn(12, 1, 5, 5).astype(np.float32)).to(dtype)
        dy = torch.from_numpy(rng.randn(2, 3, 3, 12).astype(np.float32)).to(dtype)
        kidx, bound = torch.tensor(0, dtype=torch.int32), torch.tensor(7, dtype=torch.int32)
        kw = dict(ks_list=[3, 5], stride=2)
        y = tdw.dw_masked_forward(x, w, kidx, bound, **kw)
        dx = tdw.dw_masked_dgrad(dy, w, kidx, bound, in_hw=(6, 6), **kw)
        dw = tdw.dw_masked_wgrad(x, dy, kidx, bound, bank_ks=5, **kw)
        rx, rw = tdw.masked_depthwise_grads_reference(x, w, kidx, bound, dy, **kw)
        assert y.dtype is dtype and torch.equal(dx, rx) and torch.equal(dw, rw)
        assert not y[..., 7:].any() and not dw[7:].any() and not dw[:, :, 0].any()
        xt = x.clone().requires_grad_()
        tdw.masked_depthwise(xt, w, kidx, bound, **kw).backward(dy)
        assert torch.equal(xt.grad, rx)
    after = [(f.launches, f.launches_bf16) for f in (tdw.dw_masked_forward,
                                                     tdw.dw_masked_dgrad, tdw.dw_masked_wgrad)]
    assert after == before


# -- whole masked forwards -----------------------------------------------------------

def _cfg_with_pixel_d(space, pd, n_trunks):
    return next(c for c in (sample_subnet(space, seed=s, n_trunks=n_trunks) for s in range(100))
                if c.pixel_d == pd)


@pytest.mark.parametrize("kind,mode,levers", [
    ("s4", "sr", ("ks", "dw align 8")),
    ("x4", "sr", ("dw",)),
    ("x4", "autoencoder", ("project",))])
def test_masked_forward_with_lever_matches_jax(kind, mode, levers):
    """`forward_masked` in train-mode BN with each lever set on the net (by
    `SRTrainer`, as JAX's trainer sets it) against JAX's `apply` with the
    same lever: outputs and running statistics, pixel_d 2; the same port
    net without the lever gives the same outputs."""
    n_trunks = 2 if kind == "x4" else 1
    space = SearchSpace(**SMALL_KW)
    kw = {"mode": mode} if kind == "x4" else {}
    cfg = _cfg_with_pixel_d(space, 2, n_trunks)
    rng = np.random.RandomState(7)
    x = rng.rand(BS, *((HR, HR) if mode == "autoencoder" else (HR // 4,) * 2), 3).astype(
        np.float32)
    for name in levers:
        jnet, p, s = _twin(kind, SMALL_KW, seed=1)
        _set_jax_lever(jnet, **LEVERS[name])
        y_j, s_j = jax.jit(jnet.apply, static_argnames=("pixel_d", "training") + tuple(kw))(
            p, s, jnp.asarray(x), _jcfg(cfg).to_device(jnet.space), pixel_d=2, training=True,
            **kw)
        outs = []
        for lever in (LEVERS[name], {}):
            net = _port_net(kind, p, s, SMALL_KW)
            SRTrainer(net, mode=mode, **lever)
            with torch.no_grad():
                outs.append(net.forward_masked(torch.from_numpy(x), cfg.to_device(space), cfg.d,
                                               2, bn_training=True, **kw))
            if lever:
                got = net.state_dict()
                for k, v in _bridge(kind)(p, s_j).items():
                    if not k.endswith("num_batches_tracked"):
                        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                                   **NET_TOL)
        np.testing.assert_allclose(outs[0].numpy(), np.asarray(y_j), err_msg=name, **NET_TOL)
        np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), err_msg=name, **NET_TOL)


CLS_FWD_LEVERS = ("project", "ks")   # dw_switch=True: the window test below


def _cls_fwd_inputs(net):
    return cls_batch(3)["image"], _archs(net, [4])[0]


def _jax_cls_forwards(jnet, p, s, net):
    x, arch = _cls_fwd_inputs(net)
    out = {}
    for name in CLS_FWD_LEVERS:
        jn = copy.copy(jnet)
        _set_jax_lever(jn, **LEVERS[name])
        out[name] = jax.jit(jn.apply, static_argnames=("training",))(
            p, s, jnp.asarray(x), jn.arch_to_device(_jarch(arch)), training=True)
    return out


def test_cls_masked_forward_with_lever_matches_jax(jax_refs):
    """The narrow MBV3 (SE, a stride-2 first block, gated-off blocks whose
    bound is 0) in train-mode BN with dw_switch "project" and ks_switch set
    by `ClsTrainer`, against JAX's `apply` with the same lever: logits and
    running statistics (dw_switch=True: the window test below)."""
    ref = jax_refs["cls"].result()["forwards"]
    for name in CLS_FWD_LEVERS:
        _, p, _, net = cls_twin("narrow")
        x, arch = _cls_fwd_inputs(net)
        jy, js = ref[name]
        ClsTrainer(net, **LEVERS[name])
        with torch.no_grad():
            y = net.forward_masked(torch.from_numpy(x), net.arch_tensor(arch), training=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), err_msg=name, **CLS_NET_TOL)
        got = net.state_dict()
        for k, v in mbv3_state_dict_from_jax(p, js).items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=name + " " + k,
                                           **CLS_NET_TOL)


# -- the window steps ------------------------------------------------------------------

def _batches_np(rng, n):
    """tests/test_torch_scan_trainer.py's `_batch_np`: n stacked batches (one
    for None)."""
    lead = () if n is None else (n,)
    return {k: rng.rand(*lead, BS, HR // f, HR // f, 3).astype(np.float32)
            for k, f in (("image", 1), ("x2", 2), ("x4", 4))}


SR_WINDOW_STEPS, SR_WINDOW_LR = 3, 1e-3


def _jax_sr_window():
    """JAX's side of the SR window test: its inputs, the teacher's, and the
    parameters, state and mean loss after the window."""
    n, lr = SR_WINDOW_STEPS, SR_WINDOW_LR
    rng = np.random.RandomState(0)
    jnet = JaxS4(jarch.SearchSpace(**WINDOW_KW))
    p, s = jax.jit(jnet.init)(jax.random.PRNGKey(0))
    batches = _batches_np(rng, n)
    cfgs = [sample_subnet(SearchSpace(**WINDOW_KW), seed=i) for i in range(n)]
    tnet = JaxS4(jarch.SearchSpace(**TEACHER_KW))
    tp, ts = jax.jit(tnet.init)(jax.random.PRNGKey(7))
    t_cfg = sample_subnet(SearchSpace(**TEACHER_KW), seed=0)
    jtrainer = JaxTrainer(jnet, opt_type="adam", weight_decay=3e-5, kd_ratio=1.0,
                          teacher_net=tnet, dw_switch=True)
    scan = jtrainer.make_scan_train_step(
        n_subnets=1, donate=False, teacher_params=tp, teacher_state=ts,
        teacher_arch=_jcfg(t_cfg).to_device(tnet.space), teacher_pixel_d=1)
    archs = (jax.tree.map(lambda *a: jnp.stack(a), *[_jcfg(c).to_device(jnet.space)
                                                     for c in cfgs]),)
    touched = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(t) for t in xs]),
                           *[jax_touched(jnet, p, [_jcfg(c)]) for c in cfgs])
    p1, s1, _, m = scan(p, s, jtrainer.init_opt_state(p),
                        {k: jnp.asarray(v) for k, v in batches.items()}, archs,
                        jnp.full((n,), lr, jnp.float32), touched)
    return dict(p=p, s=s, batches=batches, cfgs=cfgs, tp=tp, ts=ts, t_cfg=t_cfg,
                after=s4_state_dict_from_jax(p1, s1), loss=float(m["loss"]))


def test_sr_scan_step_with_dw_switch_matches_jax(jax_refs):
    """A window of 3 steps of `SRTrainer(dw_switch=True).make_scan_train_step`
    against JAX's `SRTrainer(dw_switch=True).make_scan_train_step` on the
    same JAX init, batches and subnets: Adam with weight decay, the touched
    masks from the subnets on both sides (a depth-1 subnet leaves a block
    untouched) and a teacher (KD) at once, tests/test_torch_scan_trainer.py's
    three windows in one JAX compile. The lever's values per layer are held
    by the tests above; this one holds its wiring through the trainer, the
    touched masks and the teacher's pass."""
    ref = jax_refs["sr window"].result()
    n, lr = SR_WINDOW_STEPS, SR_WINDOW_LR
    net = _port_net("s4", ref["p"], ref["s"], WINDOW_KW)
    teacher = (_port_net("s4", ref["tp"], ref["ts"], TEACHER_KW), ref["t_cfg"], 1)
    tr = SRTrainer(net, opt_type="adam", weight_decay=3e-5, kd_ratio=1.0, teacher=teacher,
                   dw_switch=True)
    tb = [{k: torch.from_numpy(v[i]) for k, v in ref["batches"].items()} for i in range(n)]
    got = tr.make_scan_train_step(1)(tb, [[c] for c in ref["cfgs"]], [lr] * n)
    assert abs(float(got["loss"]) - ref["loss"]) < 1e-5
    sd = net.state_dict()
    for k, v in ref["after"].items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), err_msg=k, **TOUCHED_STEP_TOL)


CLS_WINDOW_STEPS, CLS_WINDOW_LR = 3, 1e-2


def _cls_window_inputs(net):
    n = CLS_WINDOW_STEPS
    return _archs(net, range(n)), [cls_batch(10 + i) for i in range(n)]


def _jax_cls_window(jnet, p, s, net):
    """JAX's side of the classification window test: the state dict and
    mean loss after the window."""
    n, lr = CLS_WINDOW_STEPS, CLS_WINDOW_LR
    jnet = copy.copy(jnet)
    archs, batches = _cls_window_inputs(net)
    tr_j = jtr.ClsTrainer(jnet, opt_type="sgd", weight_decay=3e-5, remat=False, dw_switch=True)
    scan = tr_j.make_scan_train_step(n_subnets=1)
    stacked = {k: jnp.stack([jnp.asarray(b[k]) for b in batches]) for k in batches[0]}
    dev = [jnet.arch_to_device(_jarch(a)) for a in archs]
    touched = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(t) for t in xs]),
                           *[jax_cls_touched(jnet, p, [_jarch(a)]) for a in archs])
    rngs = jnp.stack([jax.random.PRNGKey(100 + i) for i in range(n)])
    p1, s1, _, m = scan(p, s, tr_j.init_opt_state(p), stacked,
                        (jax.tree.map(lambda *xs: jnp.stack(xs), *dev),),
                        jnp.full((n,), lr, jnp.float32), rngs, touched)
    return dict(after=mbv3_state_dict_from_jax(p1, s1), loss=float(m["loss"]))


def test_cls_scan_step_with_dw_switch_matches_jax(jax_refs):
    """3 SGD steps of one subnet of the narrow MBV3 through
    `ClsTrainer(dw_switch=True).make_scan_train_step` against JAX's
    `ClsTrainer(dw_switch=True).make_scan_train_step`, the touched masks
    from the subnets on both sides."""
    ref = jax_refs["cls"].result()["window"]
    n, lr = CLS_WINDOW_STEPS, CLS_WINDOW_LR
    net = cls_twin("narrow")[3]
    archs, batches = _cls_window_inputs(net)
    tr = ClsTrainer(net, opt_type="sgd", weight_decay=3e-5, dw_switch=True)
    got = tr.make_scan_train_step(1)([tbatch(b) for b in batches], [[a] for a in archs],
                                     [lr] * n)
    assert abs(float(got["loss"]) - ref["loss"]) < 1e-5
    sd = net.state_dict()
    for k, v in ref["after"].items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), err_msg=k, **STEP_TOL)


def test_shrink_phase_run_with_dw_switch_matches_jax(tmp_path):
    """A shrink-phase epoch (constraints expand_candidates [3], the expand
    phase's live list) at dw_switch with steps_per_dispatch 2: JAX narrows
    its compiled branches to the live list (`_apply_dw_live`, net.dw_opts
    {"live": (None, (3,))}); the port's kernel has no branches and takes
    the lists as they are. The same weights and data: the epoch's loss and
    PSNR and the parameters after it."""
    provider_kw = dict(n_train=4, n_valid=1, hr_size=8, train_batch_size=2)
    kw = dict(n_epochs=1, base_lr=1e-2, image_size=8, train_batch_size=2, dw_switch=True,
              steps_per_dispatch=2, validation_frequency=10, print_frequency=100, manual_seed=0)
    cons = {"expand_candidates": [3]}
    jrun = JaxRunManager(str(tmp_path / "jax"), JaxS4(jarch.SearchSpace(**WINDOW_KW)),
                         JaxRunConfig(**kw), JaxProvider(**provider_kw))
    net = _port_net("s4", jrun.params, jrun.state, WINDOW_KW)
    trun = SRRunManager(str(tmp_path / "port"), net, RunConfig(**kw),
                        SyntheticSRProvider(**provider_kw))
    jrun.train(constraints=cons)
    trun.train(constraints=cons)
    assert jrun.trainer.net.dw_opts == {"live": (None, (3,))}
    assert net.dw_lever is True
    sd = net.state_dict()
    for k, v in s4_state_dict_from_jax(jrun.params, jrun.state).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), err_msg=k, **SHRINK_TOL)


# -- the CLI flags ---------------------------------------------------------------------

@pytest.mark.parametrize("argv", [[], ["--ks_switch"], ["--dw_switch"], ["--dw_switch", "dw"],
                                  ["--dw_switch", "project", "--dw_align", "128"],
                                  ["--ks_switch", "--dw_switch", "off", "--dw_align", "8",
                                   "--compute_dtype", "bf16"]])
def test_cli_flags_give_jax_run_config_kwargs(argv):
    """The port's `add_perf_args` / `perf_config_kw` against JAX's on the
    same argv (JAX's `remat` aside, which the port has not), and the
    RunConfig they make handing the trainers JAX's kwargs (JAX
    run_manager.py:212-241), which set the net's one lever."""
    jargs = jcli.add_perf_args(argparse.ArgumentParser()).parse_args(argv)
    targs = tcli.add_perf_args(argparse.ArgumentParser()).parse_args(argv)
    jkw = jcli.perf_config_kw(jargs)
    jkw.pop("remat")
    tkw = tcli.perf_config_kw(targs)
    assert tkw == jkw
    rc = RunConfig(**tkw)
    net = OFAMobileNetS4(SearchSpace(**SMALL_KW), device="cpu")
    dkw = depthwise_kw(rc)
    assert dkw == dict(ks_switch=tkw.get("ks_switch", False),
                       dw_switch=tkw.get("dw_switch", False),
                       dw_opts={"align": tkw["dw_align"]} if "dw_align" in tkw else None)
    SRTrainer(net, **dkw)
    assert net.dw_lever is bool(tkw.get("ks_switch") or tkw.get("dw_switch"))
