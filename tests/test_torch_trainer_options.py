"""Trainer behaviours the run manager relies on, held to the JAX package on
the CPU (small search space and weights of tests/test_torch_train.py):

- the bf16 eval step's PSNR-Y is formed in the output's dtype, as JAX's
  `make_eval_step` forms it: the metric on one bf16 prediction agrees with
  JAX's `psnr_y_device` to rtol 1e-6 (both MSEs float32, Y bit for bit);
  the float32 form reads 0.03-0.7 dB apart there, which this catches;
- the bf16 eval-mode forward (running statistics) against JAX's
  `apply(training=False)` on `cast_params_for_compute`, at pixel_d 1 and
  2, to the bf16 forward bounds of tests/test_torch_bf16.py (max 4 ulps,
  mean 1/2 ulp at the output's largest magnitude). So the eval step and
  `make_eval_step` differ only by the forward's bf16 roundings (a bf16 ulp
  near 1 is 2^-7, coarser than the metric's 1/255, so their PSNRs are not
  compared directly);
- `bn_frozen=True` with a `clip_grad_norm` that binds on every step: SGD
  (loss rtol 1e-5, params and BN state atol 1e-5) and Adam (loss and PSNR
  rtol 2e-3) trajectories against JAX's SRTrainer, as
  tests/test_torch_train.py holds the unclipped, unfrozen ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.train import SRTrainer as JaxTrainer
from ofa_sr_tpu.train import schedules as jsched
from ofa_sr_tpu.train.touched import sr_touched_mask
from ofa_sr_tpu.train.train_step import cast_params_for_compute
from ofa_sr_tpu.utils import metrics as jmetrics
from ofa_sr_tpu_torch.models import sample_subnet
from ofa_sr_tpu_torch.train import SRTrainer
from ofa_sr_tpu_torch.train import schedules as tsched
from ofa_sr_tpu_torch.utils import metrics as tmetrics
from test_torch_bf16 import _assert_forward_close
from test_torch_train import (  # noqa: F401  (jax_twin is a fixture)
    LOSS_TOL,
    N_STEPS,
    _assert_state_matches,
    _cfg_with_pixel_d,
    _cfgs,
    _port_net,
    _tbatch,
    jax_twin,
)

BF16 = torch.bfloat16
PSNR_RTOL = 1e-6
CLIP = 0.05


def _in_range(p):
    """The twin's params with an output BN that maps into (0, 1), so PSNR-Y
    sees unclamped pixels."""
    p = dict(p)
    oc = dict(p["dec_final_output_conv_block"])
    oc["bn"] = {"scale": jnp.full_like(oc["bn"]["scale"], 0.05),
                "bias": jnp.full_like(oc["bn"]["bias"], 0.5)}
    p["dec_final_output_conv_block"] = oc
    return p


@pytest.mark.parametrize("noise", [0.002, 0.01, 0.05])
def test_bf16_psnr_y_formed_in_output_dtype(noise):
    rng = np.random.RandomState(int(noise * 1000))
    hr = rng.rand(4, 24, 24, 3).astype(np.float32)
    pred = jnp.asarray(hr + noise * rng.randn(*hr.shape).astype(np.float32), jnp.bfloat16)
    ref = float(jmetrics.psnr_y_device(pred, hr))
    tpred = torch.from_numpy(np.array(pred.astype(jnp.float32))).to(BF16)
    got = tmetrics.psnr_y_device(tpred, torch.from_numpy(hr))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), ref, rtol=PSNR_RTOL)
    f32_form = float(tmetrics.psnr_y_device(tpred.float(), torch.from_numpy(hr)))
    assert abs(f32_form - ref) > 0.03, (f32_form, ref)
    # the Y maps themselves agree bit for bit
    q = jmetrics.quantize_img(pred)
    np.testing.assert_array_equal(
        tmetrics.rgb2y_device(tmetrics.quantize_img(tpred)).float().numpy(),
        np.asarray(jmetrics.rgb2y_device(q).astype(jnp.float32)))


@pytest.fixture(scope="module")
def jax_bf16_eval(jax_twin):
    return jax.jit(JaxTrainer(jax_twin[0], remat=False, compute_dtype=jnp.bfloat16)
                   .make_eval_step())


@pytest.mark.parametrize("pixel_d", [1, 2])
def test_bf16_eval_step_matches_jax(jax_twin, jax_bf16_eval, pixel_d):
    """The eval step's bf16 output against make_eval_step's within the bf16
    forward bounds, and its PSNR-Y and loss exactly those of JAX's metric
    and MSE on that output."""
    jnet, p, s, _, batch = jax_twin
    p = _in_range(p)
    seed, cfg = _cfg_with_pixel_d(pixel_d)
    rng = np.random.RandomState(pixel_d)
    hr = np.clip(rng.rand(*batch["image"].shape), 0, 1).astype(np.float32)
    b = dict(batch, image=hr)
    ref = jax_bf16_eval(p, s, {k: jnp.asarray(v) for k, v in b.items()},
                        cfg.to_device(jnet.space))
    tr = SRTrainer(_port_net(p, s), compute_dtype=BF16)
    got = tr.eval_step(_tbatch(b), sample_subnet(tr.net.space, seed=seed))
    assert got["output"].dtype == BF16 and ref["output"].dtype == jnp.bfloat16
    _assert_forward_close(got["output"].float(), ref["output"].astype(jnp.float32))
    out = jnp.asarray(got["output"].float().numpy(), jnp.bfloat16)
    np.testing.assert_allclose(float(got["psnr"]), float(jmetrics.psnr_y_device(out, hr)),
                               rtol=PSNR_RTOL)
    np.testing.assert_allclose(float(got["loss"]),
                               float(jnp.mean(jnp.square(out.astype(jnp.float32) - hr))),
                               rtol=1e-6)


@pytest.mark.parametrize("pixel_d", [1, 2])
def test_bf16_eval_forward_matches_jax(jax_twin, pixel_d):
    """Eval-mode BN (running statistics) in bf16 at both upscales."""
    jnet, p, s, _, batch = jax_twin
    seed, cfg = _cfg_with_pixel_d(pixel_d)
    x = batch["x%d" % 2 ** pixel_d]
    y_j, s_j = jnet.apply(cast_params_for_compute(p, jnp.bfloat16), s,
                          jnp.asarray(x, jnp.bfloat16), cfg.to_device(jnet.space),
                          pixel_d=pixel_d, training=False)
    net = _port_net(p, s)
    with torch.no_grad():
        y_t = net(torch.from_numpy(x), sample_subnet(net.space, seed=seed), pixel_d,
                  bn_training=False, compute_dtype=BF16)
    assert y_t.dtype == BF16 and y_j.dtype == jnp.bfloat16
    _assert_forward_close(y_t.float(), y_j.astype(jnp.float32))
    _assert_state_matches(net, p, s, dict(rtol=0, atol=0))  # eval mode: stats untouched


def _run_jax(jax_twin, opt_type, base_lr):
    jnet, p, s, _, batch = jax_twin
    tr = JaxTrainer(jnet, opt_type=opt_type, weight_decay=3e-5, remat=False, bn_frozen=True,
                    clip_grad_norm=CLIP)
    opt_state = tr.init_opt_state(p)
    step = tr.make_train_step(n_subnets=1, donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for i in range(N_STEPS):
        cfgs, _ = _cfgs(i, 1)
        lr = jsched.lr_at_step(base_lr, 0, i, N_STEPS, 1)
        p, s, opt_state, m = step(p, s, opt_state, jb, tuple(c.to_device(jnet.space) for c in cfgs),
                                  jnp.asarray(lr, jnp.float32), sr_touched_mask(jnet, p, cfgs))
        metrics.append({k: float(v) for k, v in m.items()})
    return p, s, metrics


def _run_port(jax_twin, opt_type, base_lr, monkeypatch):
    _, p, s, _, batch = jax_twin
    norms = []
    real = torch.nn.utils.clip_grad_norm_

    def clip(params, max_norm, *a, **k):
        norms.append(float(real(params, max_norm, *a, **k)))
        return norms[-1]

    monkeypatch.setattr(torch.nn.utils, "clip_grad_norm_", clip)
    net = _port_net(p, s)
    tr = SRTrainer(net, opt_type=opt_type, weight_decay=3e-5, bn_frozen=True, clip_grad_norm=CLIP)
    tb = _tbatch(batch)
    metrics = []
    for i in range(N_STEPS):
        _, cfgs = _cfgs(i, 1)
        m = tr.train_step(tb, cfgs, tsched.lr_at_step(base_lr, 0, i, N_STEPS, 1))
        metrics.append({k: float(v) for k, v in m.items()})
    return net, metrics, norms


@pytest.mark.parametrize("opt_type,base_lr", [("sgd", 0.05), ("adam", 1e-3)])
def test_frozen_bn_clipped_steps_match_jax(jax_twin, opt_type, base_lr, monkeypatch):
    jp, js, jm = _run_jax(jax_twin, opt_type, base_lr)
    net, tm, norms = _run_port(jax_twin, opt_type, base_lr, monkeypatch)
    assert len(norms) == N_STEPS and min(norms) > 2 * CLIP, norms  # the clip binds
    if opt_type == "sgd":
        np.testing.assert_allclose([m["loss"] for m in tm], [m["loss"] for m in jm], rtol=1e-5)
        _assert_state_matches(net, jp, js, dict(rtol=0, atol=1e-5))
    else:
        for key in ("loss", "psnr"):
            np.testing.assert_allclose([m[key] for m in tm], [m[key] for m in jm], **LOSS_TOL)
    # frozen BN: the running statistics never moved
    _, p, s, _, _ = jax_twin
    ref = _port_net(p, s).state_dict()
    for k, v in net.state_dict().items():
        if "running" in k:
            assert torch.equal(v, ref[k]), k
