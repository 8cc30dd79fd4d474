"""The port's BN-statistics functions and train-mode BatchNorm against the JAX
package on the CPU: the plain versions the wrappers take for CPU tensors
against the Pallas kernels in interpret mode, `bn_train_fused` (an
autograd.Function over those plain sums here) against the JAX custom VJP,
and train-mode `batch_norm_train` against JAX `batch_norm(training=True)`.

Tolerances (float32, other summation orders): moments and running
statistics rtol 1e-5 / atol 1e-6, as tests/test_pallas.py uses; raw column
sums the same on the scale of a moment (atol 1e-6 * N); outputs and
gradients of the fused BN rtol/atol 1e-4. `bn_backward_reference` (the
plain version of the fused backward kernel) and the kernel's own per-column
association of dx are held against `jax.vjp` of the JAX custom VJP. The
CUDA kernels themselves are held against these plain versions on the GPU by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.ops import norm as jnorm
from ofa_sr_tpu.ops.pallas import bn as jbn
from ofa_sr_tpu.ops.pallas import bn_stats as jbs
from ofa_sr_tpu_torch.ops import norm as tnorm
from ofa_sr_tpu_torch.ops.kernels import bn as tbn
from ofa_sr_tpu_torch.ops.kernels import bn_stats as tbs

MOMENT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CHANNELS = [3, 16, 64, 256, 384]


def _sum_tol(n):
    return dict(rtol=1e-5, atol=1e-6 * n)


@pytest.fixture(autouse=True)
def _zero_counters():
    kernels = (tbs.col_sums2, tbs.bn_moments, tbs.bn_bwd_sums, tbs.bn_forward, tbs.bn_backward)
    for k in kernels:
        k.launches = 0
    tbn.bn_train_fused.layout_copies = 0
    yield
    # on the CPU the wrappers never launch a kernel
    assert all(k.launches == 0 for k in kernels)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("n", [37, 1000])
def test_col_sums2_matches_pallas(c, n):
    a, b = _rand((n, c), c + n), _rand((n, c), 2 * c + n, shift=0.5)
    j1, j2 = jbs.col_sums2(jnp.asarray(a), jnp.asarray(b), interpret=True)
    t1, t2 = tbs.col_sums2(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), **_sum_tol(n))
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), **_sum_tol(n))


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("shape", [(2, 5, 7), (3, 17, 13)])
def test_bn_moments_matches_pallas(c, shape):
    x = _rand(shape + (c,), c, scale=1.5, shift=0.3)
    jm, jv = jbs.bn_moments_pallas(jnp.asarray(x), interpret=True)
    tm, tv = tbs.bn_moments(torch.from_numpy(x))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **MOMENT_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    # and the port's plain batch_moments, the CPU branch of train-mode BN
    pm, pv = tnorm.batch_moments(torch.from_numpy(x))
    np.testing.assert_allclose(pm.numpy(), tm.numpy(), **MOMENT_TOL)
    np.testing.assert_allclose(pv.numpy(), tv.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("n", [37, 1000])
def test_bn_bwd_sums_matches_pallas(c, n):
    dy, x = _rand((n, c), c + n), _rand((n, c), 3 * c + n, shift=0.2)
    mean, inv = _rand((c,), c, scale=0.2), np.abs(_rand((c,), c + 1)) + 0.5
    j1, j2 = jbs.bn_bwd_sums(*map(jnp.asarray, (dy, x, mean, inv)), interpret=True)
    t1, t2 = tbs.bn_bwd_sums(*map(torch.from_numpy, (dy, x, mean, inv)))
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), **_sum_tol(n))
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), **_sum_tol(n))


def _bn_backward_case(n, c):
    """NHWC (n, 1, 1, c) x and dy with the saved (scale, mean, inv) of a
    train-mode BN forward, and the JAX VJP's (dx, dscale, dbias) for
    cotangent dy on y and none on the moments."""
    x = _rand((n, 1, 1, c), 5 * c + n, scale=1.3, shift=0.4)
    dy = _rand((n, 1, 1, c), 7 * c + n)
    scale = _rand((c,), c + 11, scale=0.3, shift=1.0)
    bias = _rand((c,), c + 12, scale=0.2)
    eps = 1e-5
    (_, jm, jv), vjp = jax.vjp(lambda x, s, b: jbn.bn_train_fused(x, s, b, eps, True),
                               *map(jnp.asarray, (x, scale, bias)))
    jgrads = vjp((jnp.asarray(dy), jnp.zeros(c, jnp.float32), jnp.zeros(c, jnp.float32)))
    mean = torch.from_numpy(np.array(jm))
    inv = torch.rsqrt(torch.from_numpy(np.array(jv)) + eps)
    return (torch.from_numpy(dy), torch.from_numpy(x), torch.from_numpy(scale), mean, inv,
            [np.asarray(j) for j in jgrads])


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("n", [37, 1000])
def test_bn_backward_reference_matches_jax_vjp(c, n):
    """The fused backward's plain version (what `bn_backward` computes on a
    CPU tensor) against the JAX VJP: dx, dscale, dbias."""
    dy, x, scale, mean, inv, jgrads = _bn_backward_case(n, c)
    got = tbs.bn_backward(dy, x, scale, mean, inv)
    ref = tbs.bn_backward_reference(dy, x, scale, mean, inv)
    for t, r, j in zip(got, ref, jgrads):
        assert torch.equal(t, r)
        np.testing.assert_allclose(t.numpy(), j, **GRAD_TOL)


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("n", [37, 1000])
def test_bn_backward_kernel_association_matches_jax_vjp(c, n):
    """dx as csrc/bn_stats.cu's dx pass forms it, from per-column
    coefficients k = inv*scale, m1 = s1/n, m2 = s2/n:
    dx = k*(dy - m1 - ((x - mean)*inv)*m2), with the sums in float32."""
    dy, x, scale, mean, inv, jgrads = _bn_backward_case(n, c)
    s1, s2 = tbs.bn_bwd_sums(dy.view(n, c), x.view(n, c), mean, inv)
    k, m1, m2 = inv * scale, s1 / n, s2 / n
    dx = k * (dy - m1 - ((x - mean) * inv) * m2)
    np.testing.assert_allclose(dx.numpy(), jgrads[0], **GRAD_TOL)
    np.testing.assert_allclose(s2.numpy(), jgrads[1], **GRAD_TOL)
    np.testing.assert_allclose(s1.numpy(), jgrads[2], **GRAD_TOL)


def test_bn_backward_takes_the_plain_version_only_on_the_cpu():
    a = torch.empty(2, 4, 4, 3, device="meta")
    c = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbs.bn_backward(a, a, c, c, c)


@pytest.mark.parametrize("c", [3, 16, 64])
def test_bn_train_fused_matches_pallas(c):
    """y, mean, var and the gradients wrt x, scale and bias, with cotangents
    on all three outputs (so the moments' own cotangent terms count)."""
    x = _rand((2, 6, 7, c), c, scale=1.3, shift=0.4)
    scale, bias = _rand((c,), c + 1, scale=0.3, shift=1.0), _rand((c,), c + 2, scale=0.2)
    wy, wm, wv = _rand((2, 6, 7, c), c + 3), _rand((c,), c + 4), _rand((c,), c + 5)

    def jloss(x, s, b):
        y, m, v = jbn.bn_train_fused(x, s, b, 1e-5, True)
        return jnp.sum(y * wy) + jnp.sum(m * wm) + jnp.sum(v * wv), (y, m, v)

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (x, scale, bias)))
    xt, st, bt = (torch.from_numpy(a).requires_grad_() for a in (x, scale, bias))
    tout = tbn.bn_train_fused(xt, st, bt, 1e-5)
    loss = ((tout[0] * torch.from_numpy(wy)).sum() + (tout[1] * torch.from_numpy(wm)).sum()
            + (tout[2] * torch.from_numpy(wv)).sum())
    loss.backward()
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **GRAD_TOL)
    for t, j in zip((xt.grad, st.grad, bt.grad), jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD_TOL)
    assert tbn.bn_train_fused.layout_copies == 0


def test_bn_train_fused_copies_a_strided_input():
    """A channels-first tensor seen as NHWC is made row-contiguous (and
    counted); the result equals the contiguous input's."""
    x = torch.from_numpy(_rand((2, 5, 6, 4), 0))
    strided = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not strided.is_contiguous()
    s, b = torch.ones(4), torch.zeros(4)
    y0 = tbn.bn_train_fused(x, s, b)[0]
    y1 = tbn.bn_train_fused(strided, s, b)[0]
    assert tbn.bn_train_fused.layout_copies == 1
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)


@pytest.mark.parametrize("update_var", ["unbiased", "biased"])
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("c", [3, 24])
def test_batch_norm_train_matches_jax(update_var, use_kernels, c):
    x = _rand((2, 5, 6, c), c, scale=2.0, shift=-0.5)
    params = {"scale": _rand((c,), 1, scale=0.3, shift=1.0), "bias": _rand((c,), 2, scale=0.2)}
    state = {"mean": _rand((c,), 3, scale=0.2), "var": np.abs(_rand((c,), 4)) + 0.5}
    jy, js = jnorm.batch_norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
                              {k: jnp.asarray(v) for k, v in state.items()}, training=True,
                              update_var=update_var)
    rm, rv = torch.from_numpy(state["mean"].copy()), torch.from_numpy(state["var"].copy())
    ty = tnorm.batch_norm_train(torch.from_numpy(x), torch.from_numpy(params["scale"]),
                                torch.from_numpy(params["bias"]), rm, rv,
                                update_var=update_var, use_kernels=use_kernels)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **GRAD_TOL)
    np.testing.assert_allclose(rm.numpy(), np.asarray(js["mean"]), **MOMENT_TOL)
    np.testing.assert_allclose(rv.numpy(), np.asarray(js["var"]), **MOMENT_TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_sliced_prefix_matches_jax_mask(use_kernels):
    """Train-mode BN on the active prefix of a wider BN (the port's sliced
    execution) equals JAX's masked BN at full width: same active outputs,
    same active running statistics, inactive statistics unchanged."""
    c, active = 24, 10
    x = _rand((2, 4, 5, c), 7, scale=1.5, shift=0.2)
    scale, bias = _rand((c,), 8, scale=0.3, shift=1.0), _rand((c,), 9, scale=0.2)
    mean0, var0 = _rand((c,), 10, scale=0.2), np.abs(_rand((c,), 11)) + 0.5
    mask = (np.arange(c) < active).astype(np.float32)
    jy, js = jnorm.batch_norm(jnp.asarray(x), {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                              {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)},
                              training=True, mask=jnp.asarray(mask))
    rm, rv = torch.from_numpy(mean0.copy()), torch.from_numpy(var0.copy())
    ty = tnorm.batch_norm_train(torch.from_numpy(x[..., :active]),
                                torch.from_numpy(scale)[:active], torch.from_numpy(bias)[:active],
                                rm[:active], rv[:active], use_kernels=use_kernels)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy)[..., :active], **GRAD_TOL)
    np.testing.assert_allclose(rm.numpy(), np.asarray(js["mean"]), **MOMENT_TOL)
    np.testing.assert_allclose(rv.numpy(), np.asarray(js["var"]), **MOMENT_TOL)
    assert np.array_equal(rm.numpy()[active:], mean0[active:])
    assert np.array_equal(rv.numpy()[active:], var0[active:])


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor that is not on the CPU goes to the kernel, which refuses a
    non-CUDA device: no wrapper falls back to its plain version."""
    a = torch.empty(64, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbs.col_sums2(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        tbs.bn_moments(torch.empty(2, 4, 4, 3, device="meta"))
    c = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbs.bn_bwd_sums(a, a, c, c)
    with pytest.raises(ValueError, match="update_var"):
        tnorm.batch_norm_train(torch.zeros(1, 2, 2, 3), torch.ones(3), torch.zeros(3),
                               torch.zeros(3), torch.ones(3), update_var="neither")


# -- bf16 activations (the trainer's bf16 compute) --------------------------
# Both packages read bf16 operands and accumulate in float32, so the sums and
# moments are held as the float32 ones are; a bf16 dx is rounded once from
# float32 in both, so where the two float32 values straddle a rounding
# boundary they differ by one bf16 ulp: rtol 2^-7 (one ulp of the larger
# value), plus float32 cancellation noise on the O(1) terms (atol 1e-5).
BF16_CHANNELS = [3, 64, 384]
BF16_ULP_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


def _bf16(a):
    """(numpy float32 array of bf16 values, torch bf16, jax bf16) of `a`."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t.float().numpy(), t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("c", BF16_CHANNELS)
@pytest.mark.parametrize("shape", [(2, 5, 7), (8, 11, 13)])  # N 70, 1144: ragged 512-row tiles
def test_bn_moments_bf16_matches_pallas(c, shape):
    _, xt, xj = _bf16(_rand(shape + (c,), c, scale=1.5, shift=0.3))
    jm, jv = jbs.bn_moments_pallas(xj, interpret=True)
    tm, tv = tbs.bn_moments(xt)
    assert tm.dtype == tv.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **MOMENT_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", BF16_CHANNELS)
@pytest.mark.parametrize("n", [37, 1000])
def test_bn_backward_bf16_matches_pallas_and_vjp(c, n):
    """bf16 dy and x: the two sums against the Pallas `bn_bwd_sums` (bf16
    operands, interpret mode), and (dx, dscale, dbias) of
    `bn_backward_reference` against `jax.vjp` of the JAX custom VJP, dx in
    bf16 within one ulp, dscale and dbias float32."""
    xf, xt, xj = _bf16(_rand((n, 1, 1, c), 5 * c + n, scale=1.3, shift=0.4))
    dyf, dyt, dyj = _bf16(_rand((n, 1, 1, c), 7 * c + n))
    scale = _rand((c,), c + 11, scale=0.3, shift=1.0)
    bias = _rand((c,), c + 12, scale=0.2)
    (_, jm, jv), vjp = jax.vjp(lambda x, s, b: jbn.bn_train_fused(x, s, b, 1e-5, True),
                               xj, jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = vjp((dyj, jnp.zeros(c, jnp.float32), jnp.zeros(c, jnp.float32)))
    assert jdx.dtype == jnp.bfloat16
    mean = torch.from_numpy(np.array(jm))
    inv = torch.rsqrt(torch.from_numpy(np.array(jv)) + 1e-5)
    j1, j2 = jbs.bn_bwd_sums(dyj.reshape(n, c), xj.reshape(n, c), jnp.asarray(mean.numpy()),
                             jnp.asarray(inv.numpy()), interpret=True)
    t1, t2 = tbs.bn_bwd_sums(dyt.view(n, c), xt.view(n, c), mean, inv)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), **_sum_tol(n))
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), **_sum_tol(n))
    dx, ds, db = tbs.bn_backward(dyt, xt, torch.from_numpy(scale), mean, inv)
    assert dx.dtype == torch.bfloat16 and ds.dtype == db.dtype == torch.float32
    assert torch.equal(dx, tbs.bn_backward_reference(dyt, xt, torch.from_numpy(scale), mean, inv)[0])
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(jdx.astype(jnp.float32)),
                               **BF16_ULP_TOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), **GRAD_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), **GRAD_TOL)


def test_bn_backward_reference_keeps_dy_dtype():
    """dx comes back in dy's type (one rounding from float32), the sums in
    float32; a float32 dy is unchanged by the rule."""
    dy, x, scale, mean, inv, _ = _bn_backward_case(50, 16)
    dx32, ds32, db32 = tbs.bn_backward_reference(dy, x, scale, mean, inv)
    dx16, ds16, db16 = tbs.bn_backward_reference(dy.bfloat16(), x.bfloat16(), scale, mean, inv)
    assert dx32.dtype == torch.float32 and dx16.dtype == torch.bfloat16
    assert ds16.dtype == db16.dtype == torch.float32
    ref = tbs.bn_backward_reference(dy.bfloat16().float(), x.bfloat16().float(), scale, mean, inv)
    assert torch.equal(dx16, ref[0].bfloat16())


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("c", [3, 64])
def test_bn_train_fused_bf16_matches_pallas(c, use_kernels):
    """Train-mode BN of a bf16 activation with float32 scale and bias, the
    kernels' branch (bn_train_fused) and the plain one, against the JAX
    custom VJP in interpret mode: y and dx bf16 within one ulp, dscale and
    dbias float32, no layout copy."""
    _, xt, xj = _bf16(_rand((2, 6, 7, c), c, scale=1.3, shift=0.4))
    scale, bias = _rand((c,), c + 1, scale=0.3, shift=1.0), _rand((c,), c + 2, scale=0.2)
    _, wyt, wyj = _bf16(_rand((2, 6, 7, c), c + 3))
    (yj, _, _), vjp = jax.vjp(lambda x, s, b: jbn.bn_train_fused(x, s, b, 1e-5, True),
                              xj, jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = vjp((wyj, jnp.zeros(c, jnp.float32), jnp.zeros(c, jnp.float32)))
    xt.requires_grad_()
    st, bt = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
    rm, rv = torch.zeros(c), torch.ones(c)
    yt = tnorm.batch_norm_train(xt, st, bt, rm, rv, use_kernels=use_kernels)
    yt.backward(wyt)
    assert yt.dtype == xt.grad.dtype == torch.bfloat16
    assert st.grad.dtype == bt.grad.dtype == torch.float32
    np.testing.assert_allclose(yt.detach().float().numpy(), np.asarray(yj.astype(jnp.float32)),
                               **BF16_ULP_TOL)
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(jdx.astype(jnp.float32)),
                               **BF16_ULP_TOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jds), **GRAD_TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jdb), **GRAD_TOL)
    assert tbn.bn_train_fused.layout_copies == 0


def test_kernel_dtype_rule():
    """The kernels take float32 or bf16 activations of one type: a bf16 dy
    with a float32 x, and float16, raise before the device is looked at (so
    on the card too, where the C entry points would read the wrong type)."""
    def meta(dtype, *shape):
        return torch.empty(*shape, device="meta", dtype=dtype)

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    assert tbs.kernel_suffix(meta(f32, 4, 3), meta(f32, 4, 3)) == "f32"
    assert tbs.kernel_suffix(meta(bf16, 4, 3), meta(bf16, 4, 3)) == "bf16"
    c = meta(f32, 3)
    for dy, x in [(meta(bf16, 4, 3), meta(f32, 4, 3)), (meta(f32, 4, 3), meta(bf16, 4, 3)),
                  (meta(f16, 4, 3), meta(f16, 4, 3))]:
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            tbs.bn_backward(dy, x, c, c, c)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            tbs.bn_bwd_sums(dy, x, c, c)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            tbs.col_sums2(dy, x)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tbs.bn_moments(meta(f16, 2, 4, 4, 3))
    # the right types get past the rule, to the device check
    with pytest.raises(ValueError, match="CUDA"):
        tbs.bn_backward(meta(bf16, 4, 3), meta(bf16, 4, 3), c, c, c)


# -- the fused train-mode forward (`bn_forward`) ------------------------------
# Against the JAX package: y, mean and var of `bn_train_fused` (Pallas
# moments in interpret mode) and the new running statistics of
# `batch_norm(training=True)` (its Pallas branch where C % 64 == 0, the XLA
# branch otherwise). f32: within 1e-5 (rtol and atol), the moments summed in
# other orders (~1e-7 of O(1) data) and carried through rsqrt, the
# normalize and the EMA. bf16 x: y within one bf16 ulp (each side rounds its
# float32 y once, and the two float32 values may straddle a rounding
# boundary); the moments and running statistics are float32 computed from
# the same bf16 values, so they are held at the f32 bound.
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
FWD_EPS = 1e-5


def _bf16_ulps(a, b):
    """Per-element distance in bf16 steps between two bf16 tensors (the
    bit patterns mapped to a monotonic integer order)."""
    def order(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return (order(a) - order(b)).abs()


def _fwd_case(c, dtype, seed):
    x = _rand((3, 5, 7, c), seed, scale=2.0, shift=-0.5)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    params = {"scale": _rand((c,), seed + 1, scale=0.3, shift=1.0),
              "bias": _rand((c,), seed + 2, scale=0.2)}
    state = {"mean": _rand((c,), seed + 3, scale=0.2), "var": np.abs(_rand((c,), seed + 4)) + 0.5}
    return x, params, state


def _jax_forward(monkeypatch, x, params, state, dtype, momentum, update_var):
    """(y, mean, var) of the JAX `bn_train_fused` and the new state of
    `batch_norm(training=True)`, on x in `dtype`."""
    monkeypatch.setenv("OFA_SR_TPU_PALLAS_BN", "interpret")
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    jy, jm, jv = jbn.bn_train_fused(xj, jnp.asarray(params["scale"]),
                                    jnp.asarray(params["bias"]), FWD_EPS, True)
    _, js = jnorm.batch_norm(xj, {k: jnp.asarray(v) for k, v in params.items()},
                             {k: jnp.asarray(v) for k, v in state.items()}, training=True,
                             momentum=momentum, eps=FWD_EPS, update_var=update_var)
    return jy, jm, jv, js


@pytest.mark.parametrize("update_var", ["unbiased", "biased"])
@pytest.mark.parametrize("momentum", [0.1, 1.0])
@pytest.mark.parametrize("c", [3, 24, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_forward_matches_jax(monkeypatch, dtype, c, momentum, update_var):
    """`bn_forward` on the CPU (its plain version, `bn_forward_reference`):
    y, mean, var, inv and the running statistics updated in place."""
    x, params, state = _fwd_case(c, dtype, c + int(10 * momentum))
    jy, jm, jv, js = _jax_forward(monkeypatch, x, params, state, dtype, momentum, update_var)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    rm, rv = torch.from_numpy(state["mean"].copy()), torch.from_numpy(state["var"].copy())
    y, mean, var, inv = tbs.bn_forward(xt, torch.from_numpy(params["scale"]),
                                       torch.from_numpy(params["bias"]), rm, rv,
                                       momentum=momentum, eps=FWD_EPS, update_var=update_var)
    assert y.dtype == xt.dtype and y.shape == xt.shape
    assert mean.dtype == var.dtype == inv.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FWD_TOL)
    else:
        jyt = torch.from_numpy(np.array(jy.astype(jnp.float32))).to(torch.bfloat16)
        assert int(_bf16_ulps(y, jyt).max()) <= 1
    for got, ref in ((mean, jm), (var, jv), (rm, js["mean"]), (rv, js["var"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)
    np.testing.assert_allclose(inv.numpy(), 1 / np.sqrt(np.asarray(jv, np.float64) + FWD_EPS),
                               **FWD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_forward_updates_a_prefix_view(monkeypatch, dtype):
    """Running statistics handed in as the active prefix of a wider BN's
    buffers (`bn.running_mean[:n]`): the prefix takes the update a whole
    buffer of the same values takes, bit for bit, and matches JAX's masked
    `batch_norm`; the tail stays untouched."""
    c, wide = 24, 40
    x, params, state = _fwd_case(c, dtype, 5)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    s, b = torch.from_numpy(params["scale"]), torch.from_numpy(params["bias"])
    long_m = torch.from_numpy(np.concatenate([state["mean"], _rand((wide - c,), 6)]))
    long_v = torch.from_numpy(np.concatenate([state["var"], np.abs(_rand((wide - c,), 7)) + 1]))
    tail = long_m[c:].clone(), long_v[c:].clone()
    rm, rv = torch.from_numpy(state["mean"].copy()), torch.from_numpy(state["var"].copy())
    kw = dict(momentum=0.1, eps=FWD_EPS, update_var="unbiased")
    y_view = tbs.bn_forward(xt, s, b, long_m[:c], long_v[:c], **kw)[0]
    y_whole = tbs.bn_forward(xt, s, b, rm, rv, **kw)[0]
    assert torch.equal(y_view, y_whole)
    assert torch.equal(long_m[:c], rm) and torch.equal(long_v[:c], rv)
    assert torch.equal(long_m[c:], tail[0]) and torch.equal(long_v[c:], tail[1])
    _, _, _, js = _jax_forward(monkeypatch, x, params, state, dtype, 0.1, "unbiased")
    np.testing.assert_allclose(long_m[:c].numpy(), np.asarray(js["mean"]), **FWD_TOL)
    np.testing.assert_allclose(long_v[:c].numpy(), np.asarray(js["var"]), **FWD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [3, 64])
def test_bn_train_fused_with_running_stats_matches_jax_vjp(dtype, c):
    """`bn_train_fused` handed the running statistics (as the trainer's
    `batch_norm_train(use_kernels=True)` does): its gradients through the
    fused forward against `jax.vjp` of the JAX custom VJP (cotangent on y
    alone), the running statistics updated once, as JAX `batch_norm`'s."""
    x, params, state = _fwd_case(c, dtype, 40 + c)
    jd = getattr(jnp, dtype)
    wy = _rand(x.shape, 50 + c)
    if dtype == "bfloat16":
        wy = torch.from_numpy(wy).to(torch.bfloat16).float().numpy()
    (_, _, _), vjp = jax.vjp(lambda x, s, b: jbn.bn_train_fused(x, s, b, FWD_EPS, True),
                             jnp.asarray(x).astype(jd), jnp.asarray(params["scale"]),
                             jnp.asarray(params["bias"]))
    jgrads = vjp((jnp.asarray(wy).astype(jd), jnp.zeros(c, jnp.float32),
                  jnp.zeros(c, jnp.float32)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    st, bt = (torch.from_numpy(params[k]).requires_grad_() for k in ("scale", "bias"))
    rm, rv = torch.from_numpy(state["mean"].copy()), torch.from_numpy(state["var"].copy())
    y, _, _ = tbn.bn_train_fused(xt, st, bt, FWD_EPS, rm, rv, momentum=0.1)
    y.backward(torch.from_numpy(wy).to(xt.dtype))
    dx = xt.grad.float().numpy()
    jdx = np.asarray(jgrads[0].astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(dx, jdx, **GRAD_TOL)
    else:
        np.testing.assert_allclose(dx, jdx, **BF16_ULP_TOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jgrads[1]), **GRAD_TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jgrads[2]), **GRAD_TOL)
    _, js = jnorm.batch_norm(jnp.asarray(x).astype(jd),
                             {k: jnp.asarray(v) for k, v in params.items()},
                             {k: jnp.asarray(v) for k, v in state.items()}, training=True,
                             eps=FWD_EPS)
    np.testing.assert_allclose(rm.numpy(), np.asarray(js["mean"]), **FWD_TOL)
    np.testing.assert_allclose(rv.numpy(), np.asarray(js["var"]), **FWD_TOL)
    assert tbs.bn_forward.launches == 0 and tbn.bn_train_fused.layout_copies == 0


def test_bn_forward_takes_the_plain_version_only_on_the_cpu():
    """Off the CPU `bn_forward` goes to the kernel, which refuses a
    non-CUDA device; what the kernel does not take is refused first, on
    meta tensors as on the card: float16 x, running statistics of another
    type or length, one running statistic without the other, a strided x.
    momentum=None and an unknown update_var are refused on the CPU too."""
    def meta(dtype, *shape):
        return torch.empty(*shape, device="meta", dtype=dtype)

    f32, bf16 = torch.float32, torch.bfloat16
    v = meta(f32, 3)
    kw = dict(momentum=0.1, eps=FWD_EPS)
    for x in (meta(f32, 2, 4, 4, 3), meta(bf16, 2, 4, 4, 3)):
        with pytest.raises(ValueError, match="CUDA"):
            tbs.bn_forward(x, v, v, v, v, **kw)
        with pytest.raises(ValueError, match="CUDA"):
            tbs.bn_forward(x, v, v, None, None, **kw)
    x = meta(f32, 2, 4, 4, 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tbs.bn_forward(meta(torch.float16, 2, 4, 4, 3), v, v, v, v, **kw)
    with pytest.raises(ValueError, match="running_mean must be a float32"):
        tbs.bn_forward(x, v, v, meta(bf16, 3), v, **kw)
    with pytest.raises(ValueError, match="running_var must be a float32"):
        tbs.bn_forward(x, v, v, v, meta(f32, 4), **kw)
    with pytest.raises(ValueError, match="both running statistics"):
        tbs.bn_forward(x, v, v, v, None, **kw)
    with pytest.raises(ValueError, match="row-contiguous"):
        tbs.bn_forward(meta(f32, 2, 3, 4, 4).permute(0, 2, 3, 1), v, v, v, v, **kw)
    cpu = torch.zeros(2, 2, 2, 3)
    with pytest.raises(ValueError, match="momentum"):
        tbs.bn_forward(cpu, torch.ones(3), torch.zeros(3), None, None, momentum=None)
    with pytest.raises(ValueError, match="update_var"):
        tbs.bn_forward(cpu, torch.ones(3), torch.zeros(3), None, None, momentum=0.1,
                       update_var="neither")
