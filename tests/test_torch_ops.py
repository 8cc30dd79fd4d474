"""Per-op parity of the port against the JAX package, on the CPU in float32
(atol 1e-5: the two frameworks sum in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.ops import conv as jconv
from ofa_sr_tpu.ops import elastic as jelastic
from ofa_sr_tpu.ops import norm as jnorm
from ofa_sr_tpu.ops import pixelshuffle as jps
from ofa_sr_tpu.ops.activations import apply_act as japply_act
from ofa_sr_tpu_torch.ops import conv as tconv
from ofa_sr_tpu_torch.ops import elastic as telastic
from ofa_sr_tpu_torch.ops import norm as tnorm
from ofa_sr_tpu_torch.ops import pixelshuffle as tps
from ofa_sr_tpu_torch.ops.activations import apply_act as tapply_act

ATOL = 1e-5


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-5, atol=atol)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1))))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_conv2d_matches_jax(k):
    rng = np.random.RandomState(k)
    x = rng.randn(2, 9, 11, 6).astype(np.float32)
    w = rng.randn(k, k, 6, 10).astype(np.float32) * 0.2
    _close(tconv.conv2d(torch.from_numpy(x), _oihw(w)),
           jconv.conv2d(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("k", [3, 5, 7])
def test_depthwise_conv2d_matches_jax(k):
    rng = np.random.RandomState(10 + k)
    x = rng.randn(2, 8, 13, 12).astype(np.float32)
    w = rng.randn(k, k, 1, 12).astype(np.float32) * 0.2
    _close(tconv.depthwise_conv2d(torch.from_numpy(x), _oihw(w)),
           jconv.depthwise_conv2d(jnp.asarray(x), jnp.asarray(w)))


def test_conv_init_statistics():
    g = torch.Generator().manual_seed(0)
    w = tconv.conv_init(5, 64, 256, generator=g)
    assert w.shape == (256, 64, 5, 5)
    assert abs(float(w.std()) - np.sqrt(2.0 / (25 * 256))) < 2e-3
    d = tconv.depthwise_conv_init(7, 384, generator=g)
    assert d.shape == (384, 1, 7, 7)
    assert abs(float(d.std()) - np.sqrt(2.0 / (49 * 384))) < 2e-3


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_and_unshuffle_match_jax(r):
    rng = np.random.RandomState(r)
    z = rng.randn(2, 5, 7, 4 * r * r).astype(np.float32)
    y = tps.pixel_shuffle(torch.from_numpy(z), r)
    _close(y, jps.pixel_shuffle(jnp.asarray(z), r), atol=0)
    # torch's own PixelShuffle in NCHW is the same channel order
    ref = torch.nn.functional.pixel_shuffle(
        torch.from_numpy(z).permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
    assert torch.equal(y, ref)
    x = rng.randn(2, 4 * r, 6 * r, 5).astype(np.float32)
    _close(tps.pixel_unshuffle(torch.from_numpy(x), r),
           jps.pixel_unshuffle(jnp.asarray(x), r), atol=0)
    assert torch.equal(tps.pixel_shuffle(tps.pixel_unshuffle(torch.from_numpy(x), r), r),
                       torch.from_numpy(x))


def test_eval_batch_norm_matches_jax():
    rng = np.random.RandomState(3)
    c = 24
    x = rng.randn(2, 5, 6, c).astype(np.float32) * 3 + 1
    scale, bias = rng.rand(c).astype(np.float32) + 0.5, rng.randn(c).astype(np.float32)
    mean, var = rng.randn(c).astype(np.float32), rng.rand(c).astype(np.float32) + 0.2
    y_j, _ = jnorm.batch_norm(jnp.asarray(x), {"scale": scale, "bias": bias},
                              {"mean": mean, "var": var}, training=False)
    y_t = tnorm.batch_norm(*map(torch.from_numpy, (x, scale, bias, mean, var)))
    _close(y_t, y_j)


@pytest.mark.parametrize("act", [None, "none", "relu6"])
def test_activations_match_jax(act):
    x = np.linspace(-8, 8, 97).astype(np.float32)
    _close(tapply_act(torch.from_numpy(x), act), japply_act(jnp.asarray(x), act), atol=0)


@pytest.mark.parametrize("identity", [True, False])
@pytest.mark.parametrize("target", [3, 5, 7])
def test_transform_kernel_chain_matches_jax(identity, target):
    ks_list = [3, 5, 7]
    rng = np.random.RandomState(target + 10 * identity)
    w = rng.randn(7, 7, 1, 20).astype(np.float32)
    mats = {"7to5": np.eye(25, dtype=np.float32), "5to3": np.eye(9, dtype=np.float32)}
    if not identity:
        mats = {k: v + 0.1 * rng.randn(*v.shape).astype(np.float32) for k, v in mats.items()}
    j = jelastic.transform_kernel_chain(jnp.asarray(w), {k: jnp.asarray(v) for k, v in mats.items()},
                                        ks_list, target)
    t = telastic.transform_kernel_chain(_oihw(w), {k: torch.from_numpy(v) for k, v in mats.items()},
                                        ks_list, target)
    assert tuple(t.shape) == (20, 1, target, target)
    _close(t, np.transpose(np.asarray(j), (3, 2, 0, 1)))
    # without the transform it is the plain center slice
    j0 = jelastic.transform_kernel_chain(jnp.asarray(w), None, ks_list, target, use_transform=False)
    t0 = telastic.transform_kernel_chain(_oihw(w), None, ks_list, target, use_transform=False)
    _close(t0, np.transpose(np.asarray(j0), (3, 2, 0, 1)), atol=0)
