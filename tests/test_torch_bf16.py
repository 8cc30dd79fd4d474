"""The port's bf16 mixed-precision training against the JAX package's
`SRTrainer(compute_dtype=jnp.bfloat16)` on the CPU: the casting rule
(`cast_params_for_compute`), the train-mode forward and its running
statistics, one subnet's gradients, and Adam trajectories of one subnet and
of four with KD (the teacher in float32).

Both packages round to bf16 at the same places: each single op agrees bit
for bit on nearly every element (the first ConvLayer and an MBConv block at
every ks and e on 99.95-100% of elements, the transformed depthwise kernels
exactly), and where two float32 sums round to neighbouring bf16 values the
packages differ by one bf16 ulp. Over a dozen layers those flips compound:
a flipped element moves the BN statistics of its channel, and the next
layers round differently again. So a whole forward is held to a few bf16
ulps of its output's scale, and to a mean error well under one ulp (which a
wrong cast would break: bf16 against float32 differs by as much at the
maximum, and more on average), not to float32's 1e-4. The bounds, at width
16 and two stages, with what this CPU measured against each:
- forward: max |diff| <= 4 ulps of bf16 at the output's largest magnitude
  (measured 2), mean |diff| <= 1/2 ulp there (measured 0.26);
- running statistics: rtol/atol 1e-2 (measured 2.6e-3: a mean over 128 to
  2048 bf16 activations of the layer, where flipped ones move it);
- gradients of one MBConv block (bf16 forward and backward): relative L2
  1e-2 (measured <= 2e-3, mostly bit for bit; bf16 against float32 is
  3.5-10% there), which holds the backward's rounding places;
- gradients of a whole subnet: relative L2 0.5 per parameter. Here the
  noise rules: JAX's own bf16 gradients sit 0.15 (median) to 0.29 (max)
  from its float32 ones at this size, and the port's bf16 ones 0.19 to 0.34
  from JAX's bf16 (a BN backward subtracts the means of bf16 cotangents
  over 32 to 512 pixels, so flipped roundings do not average out);
- Adam steps: loss and PSNR per step rtol 5e-3 (measured 8e-4), a quarter
  of the JAX package's own bf16-against-float32 bound of 2% of the loss
  (tests/test_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu.models.layers import mbconv_apply
from ofa_sr_tpu.train import SRTrainer as JaxTrainer
from ofa_sr_tpu.train import schedules as jsched
from ofa_sr_tpu.train.touched import sr_touched_mask
from ofa_sr_tpu.train.train_step import cast_params_for_compute
from ofa_sr_tpu_torch import entry as tentry
from ofa_sr_tpu_torch.models import OFAMobileNetS4, SearchSpace, sample_subnet
from ofa_sr_tpu_torch.models import layers as tlayers
from ofa_sr_tpu_torch.models.arch import uniform_subnet
from ofa_sr_tpu_torch.ops import conv as tconv
from ofa_sr_tpu_torch.ops import norm as tnorm
from ofa_sr_tpu_torch.train import SRTrainer
from ofa_sr_tpu_torch.train import schedules as tsched
from ofa_sr_tpu_torch.train.checkpoint import s4_state_dict_from_jax
from test_torch_train import (  # noqa: F401  (jax_twin is a fixture)
    N_STEPS,
    SPACE_KW,
    TEACHER_KW,
    _cfg_with_pixel_d,
    _cfgs,
    _port_net,
    _tbatch,
    jax_twin,
)

BF16 = torch.bfloat16
FWD_ULPS_MAX, FWD_ULPS_MEAN = 4.0, 0.5
STATE_TOL = dict(rtol=1e-2, atol=1e-2)
BLOCK_REL = 1e-2
SUBNET_REL = 0.5
STEP_TOL = dict(rtol=5e-3, atol=0)


def _ulp(scale):
    """One bf16 ulp at magnitude `scale` (8 bits of significand)."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def _assert_forward_close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    ulp, d = _ulp(np.abs(ref).max()), np.abs(got - ref)
    assert d.max() <= FWD_ULPS_MAX * ulp, (d.max(), ulp)
    assert d.mean() <= FWD_ULPS_MEAN * ulp, (d.mean(), ulp)


def _assert_state_close(net, p, s):
    ref = s4_state_dict_from_jax(p, s)
    got = net.state_dict()
    for k, v in ref.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **STATE_TOL)


def _bf16_params(p):
    return cast_params_for_compute(p, jnp.bfloat16)


def test_cast_rule_matches_jax(jax_twin, monkeypatch):
    """The port casts exactly the parameters the JAX package casts (the conv
    banks) and keeps the others float32 (BN, transform matrices); at use
    every conv sees bf16 input and weights and every BN a bf16 activation
    with float32 parameters; after a step the masters, their grads and the
    optimizer state are float32 and the loss is within the JAX package's
    own bf16-against-float32 bound (2% of the loss)."""
    _, p, s, _, batch = jax_twin
    flags = jax.tree.map(lambda a: np.full(np.shape(a), a.dtype == jnp.bfloat16, np.float32),
                         _bf16_params(p))
    jax_cast = {k: bool(v.numpy().all()) for k, v in s4_state_dict_from_jax(flags, s).items()}
    net = _port_net(p, s)
    names = dict(net.named_parameters())
    assert {n for n in names if jax_cast[n]} == {n for n in names if n.endswith("conv.weight")}

    seen = {"conv": set(), "bn": set(), "chain": set()}
    real_conv, real_bn, real_chain = tconv.F.conv2d, tnorm.bn_train_fused, tlayers.transform_kernel_chain

    def conv(x, w, *a, **k):
        seen["conv"].add((x.dtype, w.dtype))
        return real_conv(x, w, *a, **k)

    def bn(x, scale, bias, *a, **k):
        seen["bn"].add((x.dtype, scale.dtype, bias.dtype))
        return real_bn(x, scale, bias, *a, **k)

    def chain(w, mats, *a, **k):
        seen["chain"].add((w.dtype,) + tuple(sorted({m.dtype for m in mats.values()}, key=str)))
        return real_chain(w, mats, *a, **k)

    monkeypatch.setattr(tconv.F, "conv2d", conv)
    monkeypatch.setattr(tnorm, "bn_train_fused", bn)
    monkeypatch.setattr(tlayers, "transform_kernel_chain", chain)
    tb = _tbatch(batch)
    cfg = uniform_subnet(net.space, 3, 4, 2, 1)  # ks 3: the 7->5->3 chain runs
    losses = {}
    for cd in (None, BF16):
        tr = SRTrainer(_port_net(p, s), opt_type="adam", weight_decay=3e-5, use_kernels=True,
                       compute_dtype=cd)
        for key in seen:
            seen[key].clear()
        losses[cd] = float(tr.train_step(tb, [cfg], 1e-3)["loss"])
        want = torch.float32 if cd is None else BF16
        assert seen["conv"] == {(want, want)}
        assert seen["bn"] == {(want, torch.float32, torch.float32)}
        assert seen["chain"] == {(want, torch.float32)}
        for n, prm in tr.net.named_parameters():
            assert prm.dtype == torch.float32, n
            assert prm.grad is None or prm.grad.dtype == torch.float32, n
            assert all(v.dtype == torch.float32 for v in tr.opt.state[prm].values()
                       if v.is_floating_point()), n
    assert abs(losses[None] - losses[BF16]) < 0.02 * max(1.0, abs(losses[None]))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("pixel_d", [1, 2])
def test_bf16_train_forward_matches_jax(jax_twin, pixel_d, use_kernels):
    jnet, p, s, _, batch = jax_twin
    seed, cfg = _cfg_with_pixel_d(pixel_d)
    x = batch["x%d" % 2 ** pixel_d]
    y_j, s_j = jnet.apply(_bf16_params(p), s, jnp.asarray(x, jnp.bfloat16),
                          cfg.to_device(jnet.space), pixel_d=pixel_d, training=True)
    net = _port_net(p, s)
    net.train()
    y_t = net(torch.from_numpy(x), sample_subnet(net.space, seed=seed), pixel_d,
              use_kernels=use_kernels, compute_dtype=BF16)
    assert y_t.dtype == BF16 and y_j.dtype == jnp.bfloat16
    _assert_forward_close(y_t.detach().float(), y_j.astype(jnp.float32))
    _assert_state_close(net, p, s_j)


@pytest.fixture(scope="module")
def jax_bf16_grad(jax_twin):
    jtr = JaxTrainer(jax_twin[0], opt_type="sgd", weight_decay=0.0, remat=False,
                     compute_dtype=jnp.bfloat16)
    return jax.jit(jax.grad(lambda p, s, b, a: jtr._subnet_loss(p, s, b, a, None), has_aux=True))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (4, 16, 16, 16)])
@pytest.mark.parametrize("ks,e", [(3, 4), (5, 6), (7, 3)])
def test_bf16_mbconv_block_grads_match_jax(jax_twin, shape, ks, e, use_kernels):
    """One MBConv block in bf16, forward and backward (train-mode BN),
    against jax.vjp of the JAX block on the cast params: output, dx and the
    expand conv's and transform matrices' float32 gradients within
    BLOCK_REL (relative L2), where bf16 against float32 differs by 3.5-10%."""
    jnet, p, s, _, _ = jax_twin
    sp = jnet.space
    rng = np.random.RandomState(sum(shape) + ks)
    x, ct = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    mid = sp.mid_channels(e)

    def f(pb, xx):
        y, _ = mbconv_apply(_bf16_params(pb), s["blocks"][0], xx.astype(jnp.bfloat16), sp,
                            jnp.int32(sorted(sp.ks_list).index(ks)), jnp.int32(mid),
                            training=True, bn_cfg=jnet.bn_cfg)
        return y

    y_j, vjp = jax.vjp(f, p["blocks"][0], jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(ct, jnp.bfloat16))
    net = _port_net(p, s)
    blk = net.blocks[0].mobile_inverted_conv
    xt = torch.from_numpy(x).requires_grad_()
    y_t = blk(xt.to(BF16), ks, mid, bn_training=True, use_kernels=use_kernels, compute_dtype=BF16)
    assert y_t.dtype == BF16
    y_t.backward(torch.from_numpy(ct).to(BF16))
    grads = [(xt.grad, gx_j),
             (blk.inverted_bottleneck.conv.weight.grad,
              np.asarray(gp_j["inverted_bottleneck"]["conv"]["w"]).transpose(3, 2, 0, 1))]
    if ks < 7:
        grads.append((blk.depth_conv.conv.get_parameter("7to5_matrix").grad,
                      gp_j["depth_conv"]["kt"]["7to5"]))
    assert all(g.dtype == torch.float32 for g, _ in grads)
    for got, ref in [(y_t.detach().float(), y_j.astype(jnp.float32))] + grads:
        got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
        assert np.linalg.norm(got - ref) <= BLOCK_REL * np.linalg.norm(ref)


@pytest.fixture(scope="module")
def jax_bf16_grad(jax_twin):
    jtr = JaxTrainer(jax_twin[0], opt_type="sgd", weight_decay=0.0, remat=False,
                     compute_dtype=jnp.bfloat16)
    return jax.jit(jax.grad(lambda p, s, b, a: jtr._subnet_loss(p, s, b, a, None), has_aux=True))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_bf16_subnet_gradients_match_jax(jax_twin, jax_bf16_grad, use_kernels):
    """One subnet's float32 gradients of the bf16 loss against jax.grad's,
    held as the bf16 noise allows (see the module docstring): the same
    parameters get gradients, and each is within SUBNET_REL (relative L2)."""
    jnet, p, s, _, batch = jax_twin
    seed, cfg = _cfg_with_pixel_d(2)
    grads, _ = jax_bf16_grad(p, s, {k: jnp.asarray(v) for k, v in batch.items()},
                             cfg.to_device(jnet.space))
    ref = s4_state_dict_from_jax(grads, s)
    net = _port_net(p, s)
    tr = SRTrainer(net, opt_type="sgd", weight_decay=0.0, use_kernels=use_kernels,
                   compute_dtype=BF16)
    loss, _ = tr._subnet_loss(_tbatch(batch), sample_subnet(net.space, seed=seed), None)
    assert loss.dtype == torch.float32
    loss.backward()
    n_grads = 0
    for name, prm in net.named_parameters():
        r = ref[name].numpy()
        if prm.grad is None:  # not executed: JAX's gradient is exactly zero
            assert not np.any(r), name
            continue
        n_grads += 1
        assert prm.grad.dtype == torch.float32, name
        rel = np.linalg.norm(prm.grad.numpy() - r) / np.linalg.norm(r)
        assert rel <= SUBNET_REL, (name, rel)
    assert n_grads > 0


def _run_jax_bf16(jax_twin, n_subnets, kd_ratio, base_lr=1e-3):
    jnet, p, s, (tnet, tp, ts), batch = jax_twin
    kw = dict(teacher_net=tnet, kd_ratio=kd_ratio) if kd_ratio else {}
    tr = JaxTrainer(jnet, opt_type="adam", weight_decay=3e-5, remat=False,
                    compute_dtype=jnp.bfloat16, **kw)
    opt_state = tr.init_opt_state(p)
    t_cfg = jarch.uniform_subnet(tnet.space, 5, 3, 2, 1)
    step = tr.make_train_step(n_subnets=n_subnets, donate=False, teacher_params=tp,
                              teacher_state=ts, teacher_arch=t_cfg.to_device(tnet.space),
                              teacher_pixel_d=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for i in range(N_STEPS):
        cfgs, _ = _cfgs(i, n_subnets)
        lr = jsched.lr_at_step(base_lr, 0, i, N_STEPS, 1)
        p, s, opt_state, m = step(p, s, opt_state, jb,
                                  tuple(c.to_device(jnet.space) for c in cfgs),
                                  jnp.asarray(lr, jnp.float32), sr_touched_mask(jnet, p, cfgs))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics


def _run_port_bf16(jax_twin, n_subnets, kd_ratio, use_kernels, base_lr=1e-3):
    _, p, s, (_, tp, ts), batch = jax_twin
    net = _port_net(p, s)
    teacher = None
    if kd_ratio:
        t_net = _port_net(tp, ts, TEACHER_KW)
        teacher = (t_net, uniform_subnet(t_net.space, 5, 3, 2, 1), 1)
    tr = SRTrainer(net, opt_type="adam", weight_decay=3e-5, kd_ratio=kd_ratio, teacher=teacher,
                   use_kernels=use_kernels, compute_dtype=BF16)
    tb = _tbatch(batch)
    metrics = []
    for i in range(N_STEPS):
        _, cfgs = _cfgs(i, n_subnets)
        m = tr.train_step(tb, cfgs, tsched.lr_at_step(base_lr, 0, i, N_STEPS, 1))
        metrics.append({k: float(v) for k, v in m.items()})
    for prm in net.parameters():
        assert prm.dtype == torch.float32
    return metrics


@pytest.fixture(scope="module")
def jax_bf16_runs(jax_twin):
    return {"adam1": _run_jax_bf16(jax_twin, 1, 0.0), "adam4kd": _run_jax_bf16(jax_twin, 4, 1.0)}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("run,n_subnets,kd_ratio", [("adam1", 1, 0.0), ("adam4kd", 4, 1.0)])
def test_bf16_adam_steps_match_jax(jax_twin, jax_bf16_runs, run, n_subnets, kd_ratio,
                                   use_kernels):
    jm = jax_bf16_runs[run]
    tm = _run_port_bf16(jax_twin, n_subnets, kd_ratio, use_kernels)
    for key in ("loss", "psnr"):
        np.testing.assert_allclose([m[key] for m in tm], [m[key] for m in jm], **STEP_TOL)


def test_bf16_eval_step_and_entry_train_on_cpu(jax_twin):
    """The eval step casts as the train step does (output in bf16, loss and
    PSNR float32); entry.train passes compute_dtype through, kernels on and
    off agreeing on the CPU (the same plain sums)."""
    _, p, s, _, batch = jax_twin
    tr = SRTrainer(_port_net(p, s), compute_dtype=BF16)
    out = tr.eval_step(_tbatch(batch), sample_subnet(tr.net.space, seed=3))
    assert out["output"].dtype == BF16
    assert out["loss"].dtype == out["psnr"].dtype == torch.float32
    space = SearchSpace(**SPACE_KW)
    runs = {uk: tentry.train(2, n_subnets=2, kd_ratio=1.0, device="cpu", batch_size=2,
                             hr_size=16, use_kernels=uk, compute_dtype=BF16,
                             net=OFAMobileNetS4(space, device="cpu"))
            for uk in (False, True)}
    assert all(np.isfinite(m["loss"]) for r in runs.values() for m in r)
    np.testing.assert_allclose([m["loss"] for m in runs[True]],
                               [m["loss"] for m in runs[False]], **STEP_TOL)
