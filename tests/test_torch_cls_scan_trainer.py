"""The classification nets' masked form and multi-step training dispatch
against the JAX package on the CPU: the device arch
(`ElasticClassifierNet.arch_vector` / `device_arch` against JAX
`arch_to_device`), the MBConv's masked form with stride, squeeze-excite and
elastic output width (against the port's sliced `forward` and JAX
`_masked_mbconv_apply`), the masked classification forward (against the
sliced forward and JAX `apply`), `cls_touched_mask`,
`ClsTrainer.make_scan_train_step` and `ClsRunManager` at
`steps_per_dispatch` > 1.

On the CPU the window step runs the masked step eagerly (no CUDA graphs);
the card's graphs are held to these same steps by `chip_smoke.py` phase 14.

The nets are tests/test_torch_cls_train.py's narrow ones (two elastic
stages of widths 16 and 24, SE on the second, whose first block has stride
2; ks 3/5, e 2/3, d 1/2; 32 px at batch 8; dropout 0), from the JAX init
with random BN through `mbv3_state_dict_from_jax`, and two elastic-width
variants: MBV3's head with `width_mult_list=[0.65, 1.0]` (the second stage
16 or 24 wide) and Proxyless's head with `[1.0, 1.2]` (the first conv, the
first block and the feature mix elastic too). The published MBV3 with
`width_mult_list=[0.65, 1.0]` runs masked against sliced in the port alone
(64 px, batch 4). Tolerances:
- the device arch and the touched masks: exact;
- one MBConv block (stride 2, SE, elastic out_ch): y, running statistics,
  dx and every parameter gradient rtol/atol 1e-6 against the sliced form
  (the same bits, measured); against JAX max |diff| within 1e-5 of the
  tensor's largest magnitude (float32 sums in another package's order: a
  BN parameter's gradient sums 1,024 rows, 4.3e-6 of its scale measured;
  y and dx within 6e-7);
- whole forwards and running statistics rtol/atol 1e-4 (a dozen layers
  summed in other orders, as tests/test_torch_scan_trainer.py); a
  gated-off block's running statistics exactly unchanged;
- the window steps (3 SGD steps) against JAX `make_scan_train_step` at
  JAX's own test tolerances (tests/test_cls.py: parameters and state rtol
  1e-4, atol 1e-5; the window's mean loss 1e-5), KD "mse" at atol 5e-5
  (KD_MSE_JAX_TOL: the port's eager steps are as far from JAX there), and
  against the port's eager sliced `train_step` over the same steps at rtol
  1e-4, atol 1e-5;
- `ClsRunManager` at steps_per_dispatch 3 against 1: parameters and
  running statistics the same tolerance.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.models import ofa_cls as jcls
from ofa_sr_tpu.models.layers import _masked_mbconv_apply
from ofa_sr_tpu.train import cls_trainer as jtr
from ofa_sr_tpu.train.touched import cls_touched_mask as jax_touched
from ofa_sr_tpu_torch.data import SyntheticClsProvider
from ofa_sr_tpu_torch.models import OFAMobileNetV3
from ofa_sr_tpu_torch.models import ofa_cls as tcls
from ofa_sr_tpu_torch.train import ClsRunManager, ClsTrainer, RunConfig
from ofa_sr_tpu_torch.train.checkpoint import mbv3_state_dict_from_jax
from ofa_sr_tpu_torch.train.optim import GatedOpt
from ofa_sr_tpu_torch.train.touched import cls_touched_mask
from ofa_sr_tpu_torch.utils.common import make_divisible
from test_torch_cls_train import _randomize_bn, batch, narrow_kw, tarch, tbatch

EXACT = dict(rtol=1e-6, atol=1e-6)
SCALED_RTOL = 1e-5
TOL = dict(rtol=1e-4, atol=1e-4)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
# KD "mse" against JAX: tests/test_torch_cls_train.py's atol for this case,
# where the port's eager sliced steps stand as far from JAX's (3.85e-5 past
# STEP_TOL on one depthwise weight, measured, the window 1.2e-7 from them)
KD_MSE_JAX_TOL = dict(rtol=1e-4, atol=5e-5)
LR, N_STEPS = 1e-2, 3
# net kind -> (width_mult_list, head_width_mode)
KINDS = {"narrow": (None, "mbv3"), "mbv3 widths": ([0.65, 1.0], "mbv3"),
         "proxyless widths": ([1.0, 1.2], "proxyless")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(kind, **kw):
    wml, head = KINDS[kind]
    out = narrow_kw(**kw)
    out["width_mult_list"] = wml
    if head == "proxyless":
        out.update(final_expand_width=None, head_width_mode="proxyless")
    return out


def _first_block_outs(kind, net):
    if KINDS[kind][1] == "proxyless":
        return [make_divisible(8 * wm, 8) for wm in net.width_mult_list]
    return list(net.first_conv_widths)


@functools.lru_cache(maxsize=None)
def _jax_init(kind, seed, kw_items):
    k = _kw(kind, **dict(kw_items))
    jnet = jcls.ElasticClassifierNet(**k)
    jnet._first_block_outs = _first_block_outs(kind, jnet)
    p, s = jnet.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 7)
    return jnet, _randomize_bn(p, rng), _randomize_bn(s, rng)


def twin(kind="narrow", seed=0, **kw):
    """(JAX net, params, state with random BN, a new port net from them);
    the JAX init once a (kind, seed, kw)."""
    jnet, p, s = _jax_init(kind, seed, tuple(sorted((k, tuple(v)) for k, v in kw.items())))
    k = _kw(kind, **kw)
    k["stage_specs"] = [tcls.StageSpec(*dataclasses.astuple(sp)) for sp in k["stage_specs"]]
    net = tcls.ElasticClassifierNet(device="cpu", first_block_widths=jnet.first_block_outs, **k)
    net.load_state_dict(mbv3_state_dict_from_jax(p, s))
    return jnet, p, s, net


def _archs(net, seeds, wid=None):
    wids = [wid] if wid is not None else None
    return [net.sample_arch(seed=sd, wid_candidates=wids) for sd in seeds]


def _jarch(a):
    return jcls.ClsArch(ks=a.ks, e=a.e, d=a.d, wid=a.wid)


def _elastic(net):
    return len(net.width_mult_list) > 1


# -- the device arch ---------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
def test_device_arch_matches_jax(kind):
    """`arch_vector` through `device_arch` holds JAX `arch_to_device`'s
    values key for key, and the gate is 1 exactly for a stage's first block
    and the blocks below its depth."""
    jnet, _, _, net = twin(kind)
    for wid in ([0, 1] if _elastic(net) else [None]):
        for a in _archs(net, range(4), wid) + [net.max_arch()]:
            got = net.arch_tensor(a)
            ref = jnet.arch_to_device(_jarch(a))
            assert set(ref) | {"gate"} == set(got)
            for key, v in ref.items():
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(v), err_msg=key)
                assert got[key].dtype == torch.int32
            gate = [int(i == 0 or i < d) for sp, d in zip(net.stage_specs, a.d)
                    for i in range(sp.n_block)]
            assert got["gate"].tolist() == gate


# -- the MBConv's masked form ------------------------------------------------------

def scaled_close(name, got, ref, rel=SCALED_RTOL):
    """max |got - ref| within `rel` of max |ref| (float32 sums of one block
    in another package's order: a few ulps of the tensor's scale)."""
    got, ref = np.asarray(got), np.asarray(ref)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= rel * scale, (name, err, scale)


@pytest.mark.parametrize("ks,e", [(3, 2), (3, 3), (5, 2), (5, 3)])
def test_masked_mbconv_matches_sliced_and_jax(ks, e):
    """The second stage's first block (16 -> 24, stride 2, SE, h_swish) at
    every (ks, e), with an elastic output width of 16 of its 24: the
    masked form against the sliced `forward` and JAX `_masked_mbconv_apply`
    in train-mode BN: y (0 from out_ch on), the running statistics, dx and
    every parameter's gradient (of sum(y * w), w fixed)."""
    jnet, p, s, net = twin("narrow")
    bi = net.space.max_depth  # stage 1, block 0
    in_ch, out_full, stride, act, se, _, _ = net.block_layout()[bi]
    assert stride == 2 and se
    mid = make_divisible(round(in_ch * e), 8)
    se_mid, out_ch = make_divisible(mid // 4, 8), 16
    r = np.random.RandomState(ks * 10 + e)
    x = (0.5 * r.randn(4, 16, 16, in_ch)).astype(np.float32)
    w = r.randn(4, 8, 8, out_full).astype(np.float32)
    dev = {k: torch.tensor(v, dtype=torch.int32) for k, v in
           (("ks", net.space.ks_list.index(ks)), ("mid", mid), ("se_mid", se_mid),
            ("out", out_ch))}
    bn = dict(bn_training=True, act=act, stride=stride)

    def port(masked):
        layer = twin("narrow")[3].blocks[1 + bi].mobile_inverted_conv
        xt = torch.from_numpy(x).requires_grad_()
        if masked:
            y = layer.forward_masked(xt, dev["ks"], dev["mid"], se_mid=dev["se_mid"],
                                     out_ch=dev["out"], **bn)
        else:
            y = torch.nn.functional.pad(layer(xt, ks, mid, out_ch=out_ch, **bn),
                                        (0, out_full - out_ch))
        (y * torch.from_numpy(w)).sum().backward()
        grads = {n: q.grad for n, q in layer.named_parameters()}
        stats = {n: b.clone() for n, b in layer.named_buffers() if "running" in n}
        return y.detach(), xt.grad, grads, stats

    y_m, dx_m, g_m, st_m = port(True)
    y_s, dx_s, g_s, st_s = port(False)
    assert torch.count_nonzero(y_m[..., out_ch:]) == 0
    np.testing.assert_allclose(y_m.numpy(), y_s.numpy(), **EXACT)
    np.testing.assert_allclose(dx_m.numpy(), dx_s.numpy(), **EXACT)
    for n in g_m:
        ref = torch.zeros_like(g_m[n]) if g_s[n] is None else g_s[n]
        np.testing.assert_allclose(g_m[n].numpy(), ref.numpy(), err_msg=n, **EXACT)
    for n in st_m:
        np.testing.assert_allclose(st_m[n].numpy(), st_s[n].numpy(), err_msg=n, **EXACT)

    def jfn(bp, xx):
        y, ns = _masked_mbconv_apply(bp, s["blocks"][bi], xx, jnet.space,
                                     jnp.int32(dev["ks"].item()), jnp.int32(mid), act=act,
                                     training=True, bn_cfg=jnet.bn_cfg, stride=stride,
                                     se_mid=jnp.int32(se_mid), out_ch=jnp.int32(out_ch))
        return jnp.sum(y * w), (y, ns)

    (_, (jy, jns)), (jg, jdx) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        p["blocks"][bi], jnp.asarray(x))
    scaled_close("y", y_m, jy)
    scaled_close("dx", dx_m, jdx)
    # JAX's gradients and state under the port's names, through the bridge
    grads_p = dict(p, blocks=[jg if i == bi else b for i, b in enumerate(p["blocks"])])
    state_s = dict(s, blocks=[jns if i == bi else b for i, b in enumerate(s["blocks"])])
    ref = mbv3_state_dict_from_jax(grads_p, state_s)
    prefix = "blocks.%d.mobile_inverted_conv." % (1 + bi)
    for n in list(g_m) + list(st_m):
        scaled_close(n, (g_m.get(n) if n in g_m else st_m[n]), ref[prefix + n])


# -- the masked classification forward ---------------------------------------------

def _state(net):
    return {k: v.clone() for k, v in net.state_dict().items() if "running" in k}


@pytest.mark.parametrize("bn_training", [True, False])
@pytest.mark.parametrize("kind", list(KINDS))
def test_masked_forward_matches_sliced_and_jax(kind, bn_training):
    """Logits and running statistics of `forward_masked` against the sliced
    forward and JAX `apply` (train-mode BN updating the statistics, or BN
    in eval mode), for subnets with gated-off blocks, at each width index
    of an elastic net; a gated-off block's running statistics unchanged
    exactly."""
    jnet, p, s, _ = twin(kind)
    x = batch(3)["image"]
    archs = [tcls.ClsArch(ks=(5, 3, 3, 5), e=(3, 2, 3, 2), d=(1, 2)),
             tcls.ClsArch(ks=(3, 5, 5, 3), e=(2, 3, 2, 3), d=(2, 1))]
    wids = [0, 1] if len(jnet.width_mult_list) > 1 else [None]
    for a in archs:
        for wid in wids:
            a = dataclasses.replace(a, wid=wid)
            outs = {}
            for form in ("masked", "sliced"):
                net = twin(kind)[3]
                before = _state(net)
                with torch.no_grad():
                    if form == "masked":
                        y = net.forward_masked(torch.from_numpy(x), net.arch_tensor(a),
                                               training=True, bn_training=bn_training)
                    else:
                        y = net(torch.from_numpy(x), a, training=True, bn_training=bn_training)
                outs[form] = (y, _state(net), before)
            (ym, sm, before), (ys, ss, _) = outs["masked"], outs["sliced"]
            np.testing.assert_allclose(ym.numpy(), ys.numpy(), **TOL)
            for k in sm:
                np.testing.assert_allclose(sm[k].numpy(), ss[k].numpy(), err_msg=k, **TOL)
            gated = ["blocks.%d." % (1 + si * 2 + 1) for si, d in enumerate(a.d) if d < 2]
            assert gated
            for k in sm:
                if k.startswith(tuple(gated)):
                    assert torch.equal(sm[k], before[k]), k
            jy, js = jnet.apply(p, s, jnp.asarray(x), jnet.arch_to_device(_jarch(a)),
                                training=True, bn_training=bn_training)
            np.testing.assert_allclose(ym.numpy(), np.asarray(jy), **TOL)
            ref = mbv3_state_dict_from_jax(p, js)
            for k in sm:
                np.testing.assert_allclose(sm[k].numpy(), ref[k].numpy(), err_msg=k, **TOL)


def test_masked_forward_published_mbv3_widths():
    """The published MBV3 with width_mult_list [0.65, 1.0] (10 classes,
    batch 4 at 64 px, tests/test_torch_cls.py's size: the last BNs take 16
    rows; at batch 2 and 32 px they take 2, whose variance turns float32
    noise into 1e-2 of the logits on either form): the masked train-mode
    forward against the sliced one at both width indices, logits and
    running statistics."""
    x = torch.from_numpy(np.random.RandomState(4).rand(4, 64, 64, 3).astype(np.float32))
    net0 = OFAMobileNetV3(n_classes=10, width_mult_list=[0.65, 1.0], dropout_rate=0.0,
                          device="cpu")
    sd = {k: v.clone() for k, v in net0.state_dict().items()}
    for wid in (0, 1):
        a = net0.sample_arch(seed=wid, wid_candidates=[wid])
        res = []
        for form in ("masked", "sliced"):
            net0.load_state_dict(sd)
            with torch.no_grad():
                y = (net0.forward_masked(x, net0.arch_tensor(a), training=True)
                     if form == "masked" else net0(x, a, training=True))
            res.append((y, _state(net0)))
        np.testing.assert_allclose(res[0][0].numpy(), res[1][0].numpy(), **TOL)
        for k in res[0][1]:
            np.testing.assert_allclose(res[0][1][k].numpy(), res[1][1][k].numpy(), err_msg=k,
                                       **TOL)


# -- the touched mask --------------------------------------------------------------

def test_cls_touched_matches_jax():
    """`cls_touched_mask` against JAX's over the port's parameter names,
    for one subnet and four, on a net of depth up to 3 (its kernel sizes
    3/5/7, so the chain's two matrices)."""
    kw = dict(ks_list=(3, 5, 7), depth_list=(1, 2, 3))
    jnet, p, s, net = twin("narrow", **kw)
    n_false = 0
    for k in (1, 4):
        for seed in range(5):
            archs = _archs(net, [10 * seed + j for j in range(k)])
            jt = jax_touched(jnet, p, [_jarch(a) for a in archs])
            full = jax.tree.map(lambda t, a: np.full(np.shape(a), bool(t)), jt, p)
            ref = {n: bool(v.numpy().all()) for n, v in mbv3_state_dict_from_jax(full, s).items()}
            got = cls_touched_mask(net, archs)
            assert sorted(got) == sorted(n for n, _ in net.named_parameters())
            for name, t in got.items():
                assert t == ref[name], (k, seed, name)
            n_false += sum(not t for t in got.values())
    assert n_false > 0


# -- the window step ---------------------------------------------------------------

CASES = {"plain": (None, False), "touched": (None, True), "kd ce": ("ce", True),
         "kd mse": ("mse", True)}


@pytest.fixture(scope="module")
def teacher():
    """(JAX teacher net, params, state, port teacher net): ks5/e3/d2."""
    return twin("narrow", seed=9, ks_list=[5], expand_list=[3], depth_list=[2])


def _jax_window(case, teacher):
    kd, use_touched = CASES[case]
    jnet, p, s, net = twin("narrow")
    archs = _archs(net, range(N_STEPS))
    kw, t_kw = dict(opt_type="sgd", weight_decay=3e-5, kd_ratio=0.5 if kd else 0.0,
                    kd_type=kd or "ce", remat=False), {}
    if kd:
        t_net, tp, ts, _ = teacher
        kw["teacher_net"] = t_net
        t_kw = dict(teacher_params=tp, teacher_state=ts,
                    teacher_arch=t_net.arch_to_device(t_net.max_arch()))
    tr = jtr.ClsTrainer(jnet, **kw)
    scan = tr.make_scan_train_step(n_subnets=1, **t_kw)
    batches = [batch(10 + i) for i in range(N_STEPS)]
    stacked = {k: jnp.stack([jnp.asarray(b[k]) for b in batches]) for k in batches[0]}
    dev = [jnet.arch_to_device(_jarch(a)) for a in archs]
    touched = None
    if use_touched:
        touched = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                               *[jax_touched(jnet, p, [_jarch(a)]) for a in archs])
    rngs = jnp.stack([jax.random.PRNGKey(100 + i) for i in range(N_STEPS)])
    p1, s1, _, m = scan(p, s, tr.init_opt_state(p), stacked,
                        (jax.tree.map(lambda *xs: jnp.stack(xs), *dev),),
                        jnp.full((N_STEPS,), LR, jnp.float32), rngs, touched)
    return p1, s1, float(m["loss"]), archs


def _port_window(case, teacher, archs, *, scan, everything=False):
    kd, _ = CASES[case]
    net = twin("narrow")[3]
    t = (teacher[3], tarch(teacher[3].max_arch())) if kd else None
    tr = ClsTrainer(net, opt_type="sgd", weight_decay=3e-5, kd_ratio=0.5 if kd else 0.0,
                    kd_type=kd or "ce", teacher=t)
    tb = [tbatch(batch(10 + i)) for i in range(N_STEPS)]
    lrs = [LR] * N_STEPS
    if scan:
        touched = None
        if everything:
            touched = [dict.fromkeys((n for n, _ in net.named_parameters()), True)] * N_STEPS
        m = tr.make_scan_train_step(1)(tb, [[a] for a in archs], lrs, touched=touched)
        assert m["losses"].shape == (N_STEPS,) and m["top5s"].shape == (N_STEPS,)
        return net, float(m["loss"])
    losses = [float(tr.train_step(b, [a], lr)["loss"]) for b, a, lr in zip(tb, archs, lrs)]
    return net, float(np.mean(losses))


def _assert_net_matches(net, sd, tol):
    got = net.state_dict()
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **tol)


@pytest.mark.parametrize("case", list(CASES))
def test_scan_step_matches_jax_scan_and_train_step(case, teacher):
    """3 SGD steps of one subnet through `make_scan_train_step` against
    JAX's `make_scan_train_step` on the same weights, batches and subnets:
    "plain" (JAX without a touched mask updates every leaf, so the port
    takes every parameter as touched), "touched" (the masks from the
    subnets on both sides), KD "ce" and "mse" (with touched); then the
    port's window with its own masks against its eager sliced
    `train_step` over the same steps."""
    p1, s1, loss_j, archs = _jax_window(case, teacher)
    net, loss_t = _port_window(case, teacher, archs, scan=True, everything=case == "plain")
    assert abs(loss_t - loss_j) < 1e-5
    _assert_net_matches(net, mbv3_state_dict_from_jax(p1, s1),
                        KD_MSE_JAX_TOL if case == "kd mse" else STEP_TOL)
    net_scan, loss_scan = _port_window(case, teacher, archs, scan=True)
    net_eager, loss_eager = _port_window(case, teacher, archs, scan=False)
    assert abs(loss_scan - loss_eager) < 1e-5
    _assert_net_matches(net_scan, net_eager.state_dict(), STEP_TOL)


def test_scan_step_two_subnets_kd_matches_train_step(teacher):
    """A window of 2 steps of 2 subnets with KD, one gated-off block in a
    subnet and on in the other: the window against the eager sliced
    steps."""
    archs = [[tcls.ClsArch(ks=(5, 3, 3, 5), e=(3, 2, 3, 3), d=(1, 2)),
              tcls.ClsArch(ks=(5, 5, 3, 3), e=(3, 3, 2, 3), d=(2, 1))],
             [tcls.ClsArch(ks=(3, 5, 5, 3), e=(2, 3, 2, 2), d=(2, 2)),
              tcls.ClsArch(ks=(5, 3, 3, 5), e=(3, 2, 3, 3), d=(1, 1))]]
    out = {}
    for scan in (True, False):
        net = twin("narrow")[3]
        tr = ClsTrainer(net, opt_type="sgd", weight_decay=3e-5, kd_ratio=1.0,
                        teacher=(teacher[3], tarch(teacher[3].max_arch())))
        tb = [tbatch(batch(20 + i)) for i in range(2)]
        if scan:
            m = tr.make_scan_train_step(2)(tb, archs, [LR, LR])
            losses, top1 = m["losses"].tolist(), m["top1s"].tolist()
        else:
            ms = [tr.train_step(b, a, LR) for b, a in zip(tb, archs)]
            losses, top1 = [float(m["loss"]) for m in ms], [float(m["top1"]) for m in ms]
        out[scan] = (net, losses, top1)
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=1e-5, atol=1e-6)
    assert out[True][2] == out[False][2]
    _assert_net_matches(out[True][0], out[False][0].state_dict(), STEP_TOL)


# -- the run manager ---------------------------------------------------------------

def _run_manager(tmp, spd, *, n_epochs=1, seed=0):
    net = twin("narrow", seed=seed)[3]
    rc = RunConfig(n_epochs=n_epochs, base_lr=0.05, warmup_epochs=0, opt_type="sgd",
                   weight_decay=3e-5, train_batch_size=8, dynamic_batch_size=2,
                   print_frequency=2, manual_seed=0, steps_per_dispatch=spd)
    provider = SyntheticClsProvider(n_train=40, n_test=8, image_size=32, n_classes=10,
                                    train_batch_size=8, test_batch_size=8)
    return ClsRunManager(str(tmp), net, rc, provider)


def _train_lines(rm):
    with open(rm.path + "/logs/train_console.txt") as f:
        return [line.split(" loss")[0] for line in f if line.startswith("Train")]


def test_run_manager_steps_per_dispatch(tmp_path):
    """An epoch of 5 steps of 2 subnets at steps_per_dispatch 3 (a window
    of 3 and a tail of 2) against the same epoch at 1: parameters and
    running statistics, the epoch's loss, the log lines (print_frequency
    2: after steps 2, 4 and 5 at 1; once a window where a boundary falls
    inside it, steps 3 and 5, at 3). Then each checkpoint resumed at the
    other value for a second epoch: both runs agree."""
    rms = {spd: _run_manager(tmp_path / ("spd%d" % spd), spd) for spd in (1, 3)}
    res = {spd: rm.train_one_epoch(0) for spd, rm in rms.items()}
    np.testing.assert_allclose(res[3], res[1], rtol=1e-5)
    _assert_net_matches(rms[3].net, rms[1].net.state_dict(), STEP_TOL)
    assert _train_lines(rms[1]) == ["Train [1][2/5]", "Train [1][4/5]", "Train [1][5/5]"]
    assert _train_lines(rms[3]) == ["Train [1][3/5]", "Train [1][5/5]"]
    assert isinstance(rms[3].trainer.opt, GatedOpt)
    for rm in rms.values():
        rm.save_model(epoch=0)
    resumed = {}
    for spd, src in ((1, 3), (3, 1)):
        rm = _run_manager(tmp_path / ("spd%d" % src), spd, n_epochs=2, seed=5)
        rm.load_model()
        assert rm.start_epoch == 1
        rm.train_one_epoch(1)
        resumed[spd] = rm
    _assert_net_matches(resumed[3].net, resumed[1].net.state_dict(), STEP_TOL)


def test_scan_step_refuses_mesh_and_bad_windows(tmp_path):
    net = twin("narrow")[3]
    step = ClsTrainer(net).make_scan_train_step(2)
    a = net.sample_arch(seed=0)
    with pytest.raises(ValueError, match="one batch"):
        step([tbatch(batch(0))], [[a]], [LR])
    # a world-1 mesh (no process group) builds the window step, which gives
    # the no-mesh step's numbers
    mesh = types.SimpleNamespace(rank=0, world=1, group=None)
    archs = [[net.sample_arch(seed=i)] for i in range(2)]
    out = {}
    for m in (None, mesh):
        net = twin("narrow")[3]
        got = ClsTrainer(net, mesh=m).make_scan_train_step()(
            [tbatch(batch(i)) for i in range(2)], archs, [LR] * 2)
        out[m is None] = (net.state_dict(), got["losses"], got["top1s"], got["top5s"])
    for a, b in zip(out[True][1:], out[False][1:]):
        assert torch.equal(a, b)
    for k, v in out[True][0].items():
        assert torch.equal(out[False][0][k], v), k
    rm = ClsRunManager(str(tmp_path), net, RunConfig(steps_per_dispatch=2), None, mesh=mesh)
    assert rm.run_config.steps_per_dispatch == 2 and rm.mesh is mesh
