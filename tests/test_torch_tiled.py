"""Large frames in one process: the port's StaticSubnet with `row_valid`,
the MBConv block's row bounds, the receptive-field radii and overlap-tiled
inference (ofa_sr_tpu_torch/models/materialize.py,
ops/kernels/mbconv.py, train/tiled_infer.py) against the JAX package on
the CPU, from the same weights (the port's nets with random BN
statistics, read into their JAX twins by the weight bridge) and
numpy-seeded frames.

Small space: width 16, one stage of two blocks a trunk, ks 3/5, e 3,
pixel_d 1/2; frames of 12-48 LR rows (autoencoder: 16-320 HR rows).
Tolerances (float32): a row-padded frame through StaticSubnet(row_valid)
against JAX's StaticSubnet(row_valid), the whole output, 1e-4 (a dozen
layers summed in other orders); its valid rows against the port's unpadded
frame 1e-5 (the same sums up to the convs' tiling); the MBConv block's
plain version and its 3xTF32 emulation with row bounds against the JAX
subnet's masked block 1e-4; the radii equal to JAX's; tiled frames against
the full frame 1e-5, and a halo of 1 must differ by more than 1e-4, as the
JAX package's own test requires.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.models import OFAMobileNetS4 as JaxS4
from ofa_sr_tpu.models import OFAMobileNetX4 as JaxX4
from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu.models.materialize import get_active_subnet as jax_get_active_subnet
from ofa_sr_tpu.train import tiled_infer as jtiled
from ofa_sr_tpu.train.checkpoint import import_torch_s4, import_torch_x4
from ofa_sr_tpu_torch.models import (
    OFAMobileNetS4,
    OFAMobileNetX4,
    SearchSpace,
    get_active_subnet,
    sample_subnet,
)
from ofa_sr_tpu_torch.models.arch import uniform_subnet
from ofa_sr_tpu_torch.ops.kernels.mbconv import (
    fused_mbconv_infer,
    mbconv_3xtf32_emulated,
    mbconv_reference,
)
from ofa_sr_tpu_torch.parallel import make_mesh
from ofa_sr_tpu_torch.train import tiled_infer as ttiled

SPACE_KW = dict(ks_list=[3, 5], expand_list=[3], depth_list=[2], pixel_d_list=[1, 2],
                n_stages=1, width=16)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
FRAME_TOL = dict(rtol=1e-5, atol=1e-5)
# (net, mode): the S4, the X4's decoder, the X4's encoder and decoder
KINDS = [("s4", "sr"), ("x4", "sr"), ("x4", "autoencoder")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small frames run faster on one intra-op thread, and do not
    oversubscribe the CPU under parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def twin_nets(seed=0):
    """{"s4", "x4"}: (JAX net, params, state, the port's net), the port's
    seeded with random BN statistics and read into the JAX twin by the
    bridge (`import_torch_s4` / `_x4`, which read reference state dicts)."""
    out = {}
    rng = np.random.RandomState(seed)
    for kind, jcls, tcls, bridge in (("s4", JaxS4, OFAMobileNetS4, import_torch_s4),
                                     ("x4", JaxX4, OFAMobileNetX4, import_torch_x4)):
        tnet = tcls(SearchSpace(**SPACE_KW), device="cpu",
                    generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            for m in tnet.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    n = m.num_features
                    for t, v in ((m.weight, rng.uniform(0.5, 1.5, n)),
                                 (m.bias, rng.randn(n) * 0.2),
                                 (m.running_mean, rng.randn(n) * 0.2),
                                 (m.running_var, rng.uniform(0.5, 1.5, n))):
                        t.copy_(torch.from_numpy(v.astype(np.float32)))
        jnet = jcls(jarch.SearchSpace(**SPACE_KW))
        p, s = bridge(tnet.state_dict(), jnet)
        out[kind] = (jnet, p, s, tnet)
    return out


@pytest.fixture(scope="module")
def nets():
    return twin_nets()


def subnets(nets, kind, mode, pd, fold_tail=True):
    """The JAX and the port's static ks5/e3/d2 subnet at pixel_d `pd`."""
    jnet, p, s, tnet = nets[kind]
    n_trunks = 2 if kind == "x4" else 1
    jcfg = jarch.uniform_subnet(jnet.space, 5, 3, 2, pd, n_trunks=n_trunks)
    tcfg = uniform_subnet(tnet.space, 5, 3, 2, pd, n_trunks=n_trunks)
    return (jax_get_active_subnet(jnet, p, s, jcfg, mode=mode, fold_tail=fold_tail),
            get_active_subnet(tnet, tcfg, mode=mode, fold_tail=fold_tail), tcfg)


def frame(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def run(sub, x, **kw):
    with torch.no_grad():
        return sub(torch.from_numpy(x) if isinstance(x, np.ndarray) else x, **kw)


@pytest.mark.parametrize("fold_tail", [True, False])
@pytest.mark.parametrize("pd", [1, 2])
@pytest.mark.parametrize("kind,mode", KINDS)
def test_row_valid_matches_jax_and_the_unpadded_frame(nets, kind, mode, pd, fold_tail):
    """A frame with pad rows of ones above and below it: the port's
    StaticSubnet(row_valid) against JAX's on the padded frame, and its valid
    rows against the port's unpadded frame."""
    jsub, tsub, _ = subnets(nets, kind, mode, pd, fold_tail)
    ae = mode == "autoencoder"
    unit = 2 ** pd if ae else 1          # row_valid's alignment
    scale = 1 if ae else 2 ** pd         # output rows per input row
    x = frame((1, 8 * unit + (0 if ae else 4), 12, 3), pd)
    top, bottom = unit, 2 * unit
    xp = np.concatenate([np.ones((1, top, 12, 3), np.float32), x,
                         np.ones((1, bottom, 12, 3), np.float32)], axis=1)
    lo, hi = top, top + x.shape[1]
    y_j = jsub(jnp.asarray(xp), row_valid=(jnp.int32(lo), jnp.int32(hi)))
    y_p = run(tsub, xp, row_valid=(lo, hi))
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), **JAX_TOL)
    np.testing.assert_allclose(y_p[:, lo * scale:hi * scale].numpy(), run(tsub, x).numpy(),
                               **FRAME_TOL)
    if ae:
        with pytest.raises(ValueError, match="multiples"):
            run(tsub, xp, row_valid=(lo + 1, hi))


@pytest.mark.parametrize("bounds", [(3, 9), (5, 6), (0, 0), (9, 3), (-4, 40), (0, 12),
                                    (-3, 2), (11, 30)])
def test_mbconv_row_bounds_match_the_jax_masked_block(nets, bounds):
    """One folded MBConv block of the S4 subnet (the kernel's operands) with
    the mid activation zeroed outside the row bounds, against the JAX static
    subnet's block (`_mbconv` with `_row_mask`, plus the identity): the
    plain version, the 3xTF32 emulation, and `fused_mbconv_infer` on the
    CPU, which takes the plain version. Empty bounds and bounds past the
    frame are clipped to it."""
    jnet, p, s, tnet = nets["s4"]
    jcfg = jarch.uniform_subnet(jnet.space, 5, 3, 2, 1)
    jsub = jax_get_active_subnet(jnet, p, s, jcfg)
    tsub = get_active_subnet(tnet, uniform_subnet(tnet.space, 5, 3, 2, 1), use_kernels=True)
    x = frame((2, 12, 10, 16), 7)
    bp = jsub.params["dec_stages"][0][1]
    lo, hi = bounds
    y_j = np.asarray(jsub._mbconv(bp, jnp.asarray(x), row_valid=(lo, hi)) + jnp.asarray(x))
    args = tsub.params["dec_stages"][0][1]["kernel"]
    xt = torch.from_numpy(x)
    ref = mbconv_reference(xt, *args, row_valid=bounds)
    np.testing.assert_allclose(ref.numpy(), y_j, **JAX_TOL)
    np.testing.assert_allclose(mbconv_3xtf32_emulated(xt, *args, row_valid=bounds).numpy(), y_j,
                               **JAX_TOL)
    assert torch.equal(fused_mbconv_infer(xt, *args, row_valid=bounds), ref)
    if bounds == (0, 12):  # the whole frame: the unbounded block
        assert torch.equal(ref, mbconv_reference(xt, *args))


def test_receptive_field_radii_equal_jax():
    """Over subnets sampled from the default space (S4 and X4 lengths) and
    both conv sizes."""
    space, jspace = SearchSpace(), jarch.SearchSpace()
    n = 0
    for seed in range(40):
        for n_trunks in (1, 2):
            cfg = sample_subnet(space, seed=seed, n_trunks=n_trunks)
            jcfg = jarch.sample_subnet(jspace, seed=seed, n_trunks=n_trunks)
            for ks in (3, 5):
                got = ttiled.receptive_field_radius(cfg, space, ks)
                assert got == jtiled.receptive_field_radius(jcfg, jspace, ks)
                if n_trunks == 2:
                    got_ae = ttiled.receptive_field_radius_autoencoder(cfg, space, ks)
                    assert got_ae == jtiled.receptive_field_radius_autoencoder(jcfg, jspace, ks)
                    assert got_ae % 2 ** cfg.pixel_d == 0
                n += 1
    assert n == 160
    assert ttiled._positions(40, 16) == jtiled._positions(40, 16) == [0, 16, 24]


# the tiled frames: (kind, mode, pd, frame shape, tile); the window (tile +
# 2*halo) is smaller than the frame, so every case cuts real tiles
TILED = [("s4", "sr", 1, (1, 40, 44, 3), 8), ("s4", "sr", 2, (1, 40, 44, 3), 12),
         ("x4", "autoencoder", 1, (1, 120, 128, 3), 16),
         ("x4", "autoencoder", 2, (1, 288, 320, 3), 64)]


def _halo(tsub, cfg, mode):
    space = tsub.space
    if mode == "autoencoder":
        return ttiled.receptive_field_radius_autoencoder(cfg, space), 1
    return ttiled.receptive_field_radius(cfg, space), 2 ** cfg.pixel_d


@pytest.mark.parametrize("kind,mode,pd,shape,tile", TILED)
def test_tiled_matches_the_full_frame(nets, kind, mode, pd, shape, tile):
    """tiled_sr_infer with the halo of the receptive-field radius, windows
    clamped inside the frame, against the whole frame; and
    tiled_sr_infer_mesh in one process (a world of one, the window batch
    padded to 3 a chunk) gives tiled_sr_infer's bits."""
    _, tsub, cfg = subnets(nets, kind, mode, pd)
    halo, scale = _halo(tsub, cfg, mode)
    assert tile + 2 * halo <= min(shape[1:3])
    x = torch.from_numpy(frame(shape, 11 + pd))
    full = run(tsub, x)
    with torch.no_grad():
        tiled = ttiled.tiled_sr_infer(tsub, x, tile=tile, halo=halo, scale=scale)
        mesh1 = ttiled.tiled_sr_infer_mesh(tsub, x, tile=tile, halo=halo, scale=scale,
                                           mesh=make_mesh("cpu"), windows_per_device=3)
    assert tiled.shape == full.shape
    np.testing.assert_allclose(tiled.numpy(), full.numpy(), **FRAME_TOL)
    assert torch.equal(mesh1, tiled)


def test_insufficient_halo_differs(nets):
    _, tsub, cfg = subnets(nets, "s4", "sr", 1)
    x = torch.from_numpy(frame((1, 32, 32, 3), 1))
    with torch.no_grad():
        bad = ttiled.tiled_sr_infer(tsub, x, tile=16, halo=1, scale=2)
    assert float((bad - run(tsub, x)).abs().max()) > 1e-4


def test_tiled_windows_match_jax(nets):
    """The clamped windows and their placements are JAX's."""
    x = frame((1, 40, 44, 3), 3)
    jw, jp = jtiled._windows(x, 8, 13)
    tw, tp = ttiled._windows(torch.from_numpy(x), 8, 13)
    assert tp == jp
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
