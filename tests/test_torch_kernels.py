"""The port's kernel wrappers on the CPU (where they take their plain
versions) against the JAX package's kernels as that package runs them on the
CPU, at atol/rtol 1e-4 as in tests/test_pallas.py. The CUDA kernels
themselves are held against these plain versions on the GPU by chip_smoke.py.
The 3xTF32 arithmetic of the shuffle tail and of the MBConv's two 1x1 convs
is emulated here in plain PyTorch and held to the same tolerance, which one
TF32 product misses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.ops.pallas import mbconv as jmb
from ofa_sr_tpu.ops.pallas import shuffle_tail as jst
from ofa_sr_tpu_torch.ops.kernels import mbconv as tmb
from ofa_sr_tpu_torch.ops.kernels import shuffle_tail as tst

TOL = dict(rtol=1e-4, atol=1e-4)


def _mbconv_weights(c, m, ks, seed):
    rng = np.random.RandomState(seed)
    return dict(
        ib_w=rng.randn(c, m).astype(np.float32) * 0.3,
        ib_b=rng.randn(m).astype(np.float32) * 0.5,
        dw_w=rng.randn(ks, ks, m).astype(np.float32) * 0.3,
        dw_b=rng.randn(m).astype(np.float32) * 0.5,
        pl_w=rng.randn(m, c).astype(np.float32) * 0.3,
        pl_b=rng.randn(c).astype(np.float32) * 0.5,
    )


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.fixture(autouse=True)
def _zero_counters():
    tmb.fused_mbconv_infer.launches = 0
    tst.fused_shuffle_tail.launches = 0
    yield
    # on the CPU the wrappers never launch a kernel
    assert tmb.fused_mbconv_infer.launches == 0
    assert tst.fused_shuffle_tail.launches == 0


@pytest.mark.parametrize("ks", [3, 5, 7])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (1, 7, 13, 16), (1, 18, 20, 8)])
def test_mbconv_matches_jax(ks, residual, shape):
    c = shape[-1]
    rng = np.random.RandomState(ks * 7 + shape[1])
    x = rng.randn(*shape).astype(np.float32)
    w = _mbconv_weights(c, 3 * c, ks, seed=ks + shape[2])
    ref = jmb.fused_mbconv_infer(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in w.items()},
                                 residual=residual)
    xt, wt = torch.from_numpy(x), _torch(w)
    got = tmb.fused_mbconv_infer(xt, **wt, residual=residual)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    plain = tmb.mbconv_reference(xt, **wt, residual=residual)
    assert torch.equal(got, plain)


def test_mbconv_matches_pallas_interpret():
    """The Pallas kernel itself (interpret mode) as the reference."""
    rng = np.random.RandomState(5)
    x = rng.randn(1, 16, 16, 8).astype(np.float32)
    w = _mbconv_weights(8, 16, 5, seed=5)
    ref = jmb.fused_mbconv_infer(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in w.items()},
                                 interpret=True)
    got = tmb.fused_mbconv_infer(torch.from_numpy(x), **_torch(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", [(2, 12, 16, 64), (1, 18, 10, 64)])
def test_shuffle_tail_matches_jax(shape):
    rng = np.random.RandomState(shape[1])
    x = rng.rand(*shape).astype(np.float32)
    w = (rng.randn(5, 5, 64, 256) * 0.05).astype(np.float32)
    b = (rng.randn(256) * 0.1).astype(np.float32)
    ref = jst.fused_shuffle_tail(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tst.fused_shuffle_tail(*map(torch.from_numpy, (x, w, b)))
    assert tuple(got.shape) == (shape[0], 2 * shape[1], 2 * shape[2], 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_shuffle_tail_matches_pallas_interpret():
    rng = np.random.RandomState(2)
    x = rng.rand(1, 6, 8, 64).astype(np.float32)
    w = (rng.randn(5, 5, 64, 256) * 0.05).astype(np.float32)
    b = (rng.randn(256) * 0.1).astype(np.float32)
    ref = jst.fused_shuffle_tail(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)
    got = tst.fused_shuffle_tail(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _bf16(a):
    """numpy float32 -> (jnp bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def test_mbconv_bf16_weights_match_pallas_interpret():
    """bf16 weights with a float32 x: the Pallas kernel promotes the weights
    in its dots and returns float32; the port upcasts them (exact), so both
    compute the float32 kernel on the same values (TOL)."""
    rng = np.random.RandomState(6)
    x = rng.randn(1, 16, 16, 8).astype(np.float32)
    w = {k: _bf16(v) for k, v in _mbconv_weights(8, 24, 7, seed=6).items()}
    ref = jmb.fused_mbconv_infer(jnp.asarray(x), **{k: v[0] for k, v in w.items()},
                                 interpret=True)
    got = tmb.fused_mbconv_infer(torch.from_numpy(x), **{k: v[1] for k, v in w.items()})
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    up = tmb.mbconv_reference(torch.from_numpy(x), **{k: v[1].float() for k, v in w.items()})
    assert torch.equal(got, up)


def test_shuffle_tail_bf16_weights_match_pallas_interpret():
    rng = np.random.RandomState(7)
    x = rng.rand(1, 6, 8, 16).astype(np.float32)
    (wj, wt), (bj, bt) = _bf16(rng.randn(5, 5, 16, 64) * 0.05), _bf16(rng.randn(64) * 0.1)
    ref = jst.fused_shuffle_tail(jnp.asarray(x), wj, bj, interpret=True)
    got = tst.fused_shuffle_tail(torch.from_numpy(x), wt, bt)
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert torch.equal(got, tst.shuffle_tail_reference(torch.from_numpy(x), wt.float(), bt.float()))


def test_serving_kernels_refuse_bf16_x_in_both_packages():
    """A bf16 x: Pallas fails storing it into its float32 scratch; the port's
    wrappers raise before either path runs."""
    rng = np.random.RandomState(8)
    x = rng.rand(1, 8, 8, 8).astype(np.float32)
    w = _mbconv_weights(8, 16, 3, seed=8)
    xj, xt = _bf16(x)
    with pytest.raises(ValueError, match="dtype"):
        jmb.fused_mbconv_infer(xj, **{k: jnp.asarray(v) for k, v in w.items()}, interpret=True)
    with pytest.raises(ValueError, match="Pallas kernel refuses"):
        tmb.fused_mbconv_infer(xt, **_torch(w))
    wt, bt = rng.randn(5, 5, 8, 32).astype(np.float32), rng.randn(32).astype(np.float32)
    with pytest.raises(ValueError, match="dtype"):
        jst.fused_shuffle_tail(xj, jnp.asarray(wt), jnp.asarray(bt), interpret=True)
    with pytest.raises(ValueError, match="Pallas kernel refuses"):
        tst.fused_shuffle_tail(xt, torch.from_numpy(wt), torch.from_numpy(bt))


def test_shuffle_tail_channel_order():
    """Distinct per-channel biases with a zero conv: HR channel c at
    sub-pixel (y, x) holds bias[4c + 2y + x]."""
    x = torch.zeros(1, 3, 4, 8)
    w = torch.zeros(5, 5, 8, 32)
    b = torch.arange(32, dtype=torch.float32)
    y = tst.fused_shuffle_tail(x, w, b)
    for c in range(8):
        for sy in range(2):
            for sx in range(2):
                assert torch.all(y[0, sy::2, sx::2, c] == 4 * c + 2 * sy + sx)


def test_wrappers_raise_off_cpu_without_kernel():
    """A tensor on neither the CPU nor a CUDA device gets no plain-version
    fallback: the wrapper raises."""
    x = torch.empty(1, 4, 4, 8, device="meta")
    w = {k: torch.empty(v.shape, device="meta") for k, v in _torch(_mbconv_weights(8, 16, 3, 0)).items()}
    with pytest.raises(ValueError):
        tmb.fused_mbconv_infer(x, **w)
    with pytest.raises(ValueError):
        tst.fused_shuffle_tail(x, torch.empty(5, 5, 8, 32, device="meta"),
                               torch.empty(32, device="meta"))


def _tail_case(shape, seed):
    """The chip_smoke.py phase-2 scales: x ~ U[0, 1), w ~ 0.03 N(0, 1)."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.rand(*shape).astype(np.float32)
    w = (rng.randn(5, 5, c, 4 * c) * 0.03).astype(np.float32)
    b = (rng.randn(4 * c) * 0.1).astype(np.float32)
    ref = np.asarray(jst.shuffle_tail_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    return tuple(map(torch.from_numpy, (x, w, b))), ref


def test_tf32_round():
    """Round to nearest on 10 mantissa bits, ties away from zero; TF32
    values are kept; big + small recovers a float32 to ~2^-22."""
    one_ulp = 2.0 ** -10
    v = torch.tensor([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4,
                      1.0 + 3 * one_ulp / 4, 0.0, 3.0e-3], dtype=torch.float32)
    got = tst.tf32_round(v)
    want = [1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + one_ulp, 0.0]
    assert got[:6].tolist() == want
    assert torch.equal(tst.tf32_round(got), got)
    x = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(np.float32))
    big = tst.tf32_round(x)
    small = tst.tf32_round(x - big)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((big + small - x).abs() / x.abs()).max()) <= 2.0 ** -21


def test_shuffle_tail_3xtf32_emulation_matches_jax():
    """Three TF32 products per multiply-add (the kernel's arithmetic) meet
    the kernels' float32 tolerance at the path's Cin 64."""
    (x, w, b), ref = _tail_case((1, 12, 20, 64), seed=3)
    got = tst.shuffle_tail_3xtf32_emulated(x, w, b)
    assert tuple(got.shape) == (1, 24, 40, 64)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_shuffle_tail_1xtf32_misses_the_tolerance():
    """One TF32 product per multiply-add does not: the reason for three."""
    (x, w, b), ref = _tail_case((1, 12, 20, 64), seed=3)
    one = tst.shuffle_tail_reference(tst.tf32_round(x), tst.tf32_round(w), b)
    err = np.abs(one.numpy() - ref)
    assert (err > TOL["atol"] + TOL["rtol"] * np.abs(ref)).mean() > 0.1


def _one_tf32_mbconv(x, ib_w, ib_b, dw_w, dw_b, pl_w, pl_b, *, residual=True):
    """The composition with one TF32 product per 1x1 multiply-add."""
    from ofa_sr_tpu_torch.ops.activations import relu6
    from ofa_sr_tpu_torch.ops.conv import depthwise_conv2d

    def conv1(u, w):
        return tmb._conv1x1(tst.tf32_round(u), tst.tf32_round(w))

    h = relu6(conv1(x, ib_w) + ib_b)
    h = relu6(depthwise_conv2d(h, dw_w.permute(2, 0, 1)[:, None]) + dw_b)
    y = conv1(h, pl_w) + pl_b
    return y + x if residual else y


@pytest.mark.parametrize("ks", [3, 5, 7])
@pytest.mark.parametrize("residual", [True, False])
def test_mbconv_3xtf32_emulation_matches_jax(ks, residual):
    """Both 1x1 convs as three TF32 products (the kernel's arithmetic) meet
    the kernels' float32 tolerance against the JAX package's reference."""
    rng = np.random.RandomState(10 + ks)
    x = rng.randn(1, 9, 12, 16).astype(np.float32)
    w = _mbconv_weights(16, 96, ks, seed=ks)
    ref = jmb.mbconv_reference(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in w.items()},
                               residual=residual)
    got = tmb.mbconv_3xtf32_emulated(torch.from_numpy(x), **_torch(w), residual=residual)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_mbconv_3xtf32_split_is_needed():
    """Against a float64 composition, three TF32 products err at most 1/8 as
    much as one: the split is what holds the kernel to float32."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(1, 9, 12, 16).astype(np.float32))
    w = _torch(_mbconv_weights(16, 96, 7, seed=4))
    ref = tmb.mbconv_reference(x.double(), **{k: v.double() for k, v in w.items()})
    three = float((tmb.mbconv_3xtf32_emulated(x, **w).double() - ref).abs().max())
    one = float((_one_tf32_mbconv(x, **w).double() - ref).abs().max())
    assert three <= one / 8, (three, one)
