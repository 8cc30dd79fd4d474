"""The port's S4 supernet and serving path against the JAX package on the CPU,
through the weight bridge, with random BN running statistics so the BN
fold is exercised. Tolerance atol 1e-4 (float32, different summation
orders through a dozen layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.models import OFAMobileNetS4 as JaxS4
from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu.models.materialize import get_active_subnet as jax_get_active_subnet
from ofa_sr_tpu.train.checkpoint import import_torch_s4
from ofa_sr_tpu_torch.entry import entry, serve
from ofa_sr_tpu_torch.models import OFAMobileNetS4, SearchSpace, get_active_subnet, sample_subnet
from ofa_sr_tpu_torch import ops as tops
from ofa_sr_tpu_torch.models.arch import uniform_subnet
from ofa_sr_tpu_torch.ops.kernels import fused_mbconv_infer, fused_shuffle_tail
from ofa_sr_tpu_torch.train.checkpoint import s4_state_dict_from_jax

SPACE_KW = dict(ks_list=[3, 5, 7], expand_list=[3, 4, 6], depth_list=[2, 3],
                pixel_d_list=[1, 2], n_stages=2, width=16)
TOL = dict(rtol=1e-4, atol=1e-4)


def _randomize_bn(tree, rng):
    """Random BN affine params and running stats (mean != 0, var != 1)."""
    if isinstance(tree, list):
        return [_randomize_bn(t, rng) for t in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        n = None if isinstance(v, (dict, list)) else int(np.asarray(v).shape[0])
        if k == "scale" or k == "var":
            out[k] = jnp.asarray(rng.uniform(0.5, 1.5, n).astype(np.float32))
        elif (k == "bias" and "scale" in tree) or k == "mean":
            out[k] = jnp.asarray((rng.randn(n) * 0.2).astype(np.float32))
        else:
            out[k] = _randomize_bn(v, rng)
    return out


@pytest.fixture(scope="module")
def nets():
    """A JAX twin with random BN and random transform matrices, and the
    port's model loaded from it through the bridge."""
    rng = np.random.RandomState(0)
    jnet = JaxS4(jarch.SearchSpace(**SPACE_KW))
    p, s = jnet.init(jax.random.PRNGKey(0))
    p, s = _randomize_bn(p, rng), _randomize_bn(s, rng)
    for bp in p["blocks"]:
        bp["depth_conv"]["kt"] = {
            k: v + jnp.asarray((0.05 * rng.randn(*v.shape)).astype(np.float32))
            for k, v in bp["depth_conv"]["kt"].items()}
    tnet = OFAMobileNetS4(SearchSpace(**SPACE_KW), device="cpu")
    tnet.load_state_dict(s4_state_dict_from_jax(p, s))
    return jnet, p, s, tnet


def _x(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _tree_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for u, v in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_weight_bridge_round_trips(nets):
    jnet, p, s, tnet = nets
    # JAX -> port -> import_torch_s4 gives back the JAX arrays exactly
    p2, s2 = import_torch_s4(tnet.state_dict(), jnet)
    _tree_equal(p2, p)
    _tree_equal(s2, s)
    # port init -> import_torch_s4 -> bridge gives back the port's state_dict
    fresh = OFAMobileNetS4(SearchSpace(**SPACE_KW), device="cpu",
                           generator=torch.Generator().manual_seed(3))
    sd = fresh.state_dict()
    back = s4_state_dict_from_jax(*import_torch_s4(sd, jnet))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_supernet_forward_matches_jax(nets, seed):
    jnet, p, s, tnet = nets
    cfg = jarch.sample_subnet(jnet.space, seed=seed)
    tcfg = sample_subnet(tnet.space, seed=seed)
    assert tcfg == type(tcfg)(*[getattr(cfg, f) for f in ("ks", "e", "d", "pixel_d")])
    for pixel_d in (1, 2):
        x = _x((2, 10, 12, 3), seed)
        y_j, _ = jnet.apply(p, s, jnp.asarray(x), cfg.to_device(jnet.space),
                            pixel_d=pixel_d, training=False)
        with torch.no_grad():
            y_t = tnet(torch.from_numpy(x), tcfg, pixel_d=pixel_d)
        assert tuple(y_t.shape) == (2, 10 * 2 ** pixel_d, 12 * 2 ** pixel_d, 3)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)


@pytest.mark.parametrize("fold_bn,fold_tail,use_kernels", [
    (True, True, False), (True, False, False), (False, True, False), (True, True, True)])
def test_materialized_subnet_matches_jax(nets, fold_bn, fold_tail, use_kernels):
    jnet, p, s, tnet = nets
    fused_mbconv_infer.launches = fused_shuffle_tail.launches = 0
    for seed in (4, 5):
        cfg = jarch.sample_subnet(jnet.space, seed=seed)
        tcfg = sample_subnet(tnet.space, seed=seed)
        x = _x((1, 9, 11, 3), seed)
        jsub = jax_get_active_subnet(jnet, p, s, cfg, fold_bn=fold_bn,
                                     fold_tail=fold_tail, use_pallas=use_kernels)
        tsub = get_active_subnet(tnet, tcfg, fold_bn=fold_bn, fold_tail=fold_tail,
                                 use_kernels=use_kernels)
        assert tsub.fold_tail == jsub.fold_tail
        assert tsub.use_kernels == use_kernels
        with torch.no_grad():
            y_t = tsub(torch.from_numpy(x))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(jsub(jnp.asarray(x))), **TOL)
    assert fused_mbconv_infer.launches == fused_shuffle_tail.launches == 0


def test_kernels_need_folded_bn(nets):
    """Asking for the kernels without the BN fold raises; left to its
    default, use_kernels follows the device and the fold."""
    _, _, _, tnet = nets
    cfg = uniform_subnet(tnet.space, 5, 4, 2, 1)
    with pytest.raises(ValueError, match="fold_bn"):
        get_active_subnet(tnet, cfg, fold_bn=False, use_kernels=True)
    assert not get_active_subnet(tnet, cfg, fold_bn=False).use_kernels
    assert not get_active_subnet(tnet, cfg).use_kernels  # a CPU net
    assert get_active_subnet(tnet, cfg, use_kernels=True).use_kernels


def test_fold_conv_through_shuffle_matches_jax():
    from ofa_sr_tpu.models.materialize import _fold_conv_through_shuffle as jfold
    from ofa_sr_tpu_torch.models.materialize import _fold_conv_through_shuffle as tfold
    rng = np.random.RandomState(0)
    for k in (1, 3, 5):
        w = rng.rand(k, k, 5, 3).astype(np.float32)
        b = rng.rand(3).astype(np.float32)
        wj, bj = jfold(jnp.asarray(w), jnp.asarray(b))
        wt, bt = tfold(torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))),
                       torch.from_numpy(b))
        np.testing.assert_array_equal(wt.numpy(), np.transpose(np.asarray(wj), (3, 2, 0, 1)))
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


def test_unported_modes_raise(nets):
    """An S4 net has no encoder for mode="autoencoder" (the X4's,
    tests/test_torch_x4.py), and an X4-length subnet is refused. row_valid
    is ported (item 10; tests/test_torch_tiled.py holds it to JAX): the
    valid rows of a row-padded frame are the unpadded frame's."""
    _, _, _, tnet = nets
    cfg = uniform_subnet(tnet.space, 5, 4, 2, 1)
    with pytest.raises(ValueError, match="OFAMobileNetX4"):
        get_active_subnet(tnet, cfg, mode="autoencoder")
    with pytest.raises(ValueError, match="n_trunks=1"):
        get_active_subnet(tnet, uniform_subnet(tnet.space, 5, 4, 2, 1, n_trunks=2))
    sub = get_active_subnet(tnet, cfg)
    x = torch.from_numpy(_x((1, 4, 5, 3), 0))
    with torch.no_grad():
        y = sub(torch.cat([x, torch.ones(1, 3, 5, 3)], 1), row_valid=(0, 4))
        torch.testing.assert_close(y[:, :8], sub(x), rtol=1e-5, atol=1e-5)


def test_entry_and_serve_on_cpu():
    fn, args = entry(device="cpu")
    y = fn(*args)
    assert tuple(y.shape) == (16, 96, 96, 3) and bool(torch.isfinite(y).all())
    frames = [_x((1, 6, 10, 3), i) for i in range(2)] + [_x((6, 10, 3), 2)]
    out = serve(frames, device="cpu")
    assert [tuple(o.shape) for o in out] == [(1, 24, 40, 3)] * 3
    # serve is the materialized subnet of its default config
    net = OFAMobileNetS4(SearchSpace(), device="cpu")
    sub = get_active_subnet(net, uniform_subnet(net.space, 7, 6, 2, 2))
    with torch.no_grad():
        torch.testing.assert_close(out[0], sub(torch.from_numpy(frames[0])), rtol=0, atol=0)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        entry()
    with pytest.raises(RuntimeError, match="cuda"):
        serve([_x((1, 4, 4, 3), 0)])
    with pytest.raises(RuntimeError, match="cuda"):
        OFAMobileNetS4(SearchSpace(**SPACE_KW))


@pytest.mark.parametrize("pixel_d", [1, 2])
@pytest.mark.parametrize("hw", [(7, 9), (10, 12)])
def test_bucketed_eval_matches_jax(nets, pixel_d, hw):
    """A frame zero-padded into a 10x12 bucket with valid_hw: the valid
    region equals the unpadded frame's output and JAX's bucketed forward;
    train-mode BN raises."""
    jnet, p, s, tnet = nets
    h, w = hw
    cfg = jarch.sample_subnet(jnet.space, seed=6)
    tcfg = sample_subnet(tnet.space, seed=6)
    x = _x((2, h, w, 3), h)
    padded = np.zeros((2, 10, 12, 3), np.float32)
    padded[:, :h, :w] = x
    f = 2 ** pixel_d
    y_j, _ = jnet.apply(p, s, jnp.asarray(padded), cfg.to_device(jnet.space), pixel_d=pixel_d,
                        valid_hw=jnp.asarray([h, w], jnp.int32))
    with torch.no_grad():
        y_b = tnet(torch.from_numpy(padded), tcfg, pixel_d, valid_hw=(h, w))
        y_u = tnet(torch.from_numpy(x), tcfg, pixel_d)
    assert tuple(y_b.shape) == (2, 10 * f, 12 * f, 3)
    np.testing.assert_allclose(y_b.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(y_b[:, :h * f, :w * f].numpy(), y_u.numpy(), **TOL)
    assert not y_b[:, h * f:].any() and not y_b[:, :, w * f:].any()
    with pytest.raises(ValueError, match="eval-mode"):
        tnet(torch.from_numpy(padded), tcfg, pixel_d, bn_training=True, valid_hw=(h, w))


def test_icnr_init_matches_jax():
    """ICNR shuffle convs: output channel c*4 + s repeats filter c in both
    packages, so conv -> PixelShuffle(2) is a nearest-neighbour upsample at
    init; an ICNR net bridged to JAX gives the JAX forward."""
    space_kw = dict(SPACE_KW, pixel_d_list=[1, 2])
    net = OFAMobileNetS4(SearchSpace(**space_kw), device="cpu", icnr=True,
                         generator=torch.Generator().manual_seed(4))
    jnet = JaxS4(jarch.SearchSpace(**space_kw), icnr=True)
    jp, _ = jnet.init(jax.random.PRNGKey(4))
    plain = OFAMobileNetS4(SearchSpace(**space_kw), device="cpu",
                           generator=torch.Generator().manual_seed(4))
    for i, layer in enumerate(net.shuffle_blocks):
        w = layer.conv.weight.detach()
        w_j = torch.from_numpy(np.array(jp["shuffle_blocks"][i]["conv"]["w"]).transpose(3, 2, 0, 1))
        for t in (w, w_j):
            groups = t.reshape(t.shape[0] // 4, 4, *t.shape[1:])
            assert torch.equal(groups, groups[:, :1].expand_as(groups))
        assert not torch.equal(w, plain.shuffle_blocks[i].conv.weight.detach())
        x = torch.from_numpy(_x((1, 5, 6, w.shape[1]), i))
        y = tops.pixel_shuffle(tops.conv2d(x, w), 2)
        torch.testing.assert_close(y, y[:, ::2, ::2].repeat_interleave(2, 1).repeat_interleave(2, 2),
                                   rtol=0, atol=0)
    jp2, js2 = import_torch_s4(net.state_dict(), JaxS4(jarch.SearchSpace(**space_kw)))
    cfg = jarch.sample_subnet(jnet.space, seed=2)
    x = _x((1, 6, 7, 3), 2)
    for pixel_d in (1, 2):
        y_j, _ = jnet.apply(jp2, js2, jnp.asarray(x), cfg.to_device(jnet.space), pixel_d=pixel_d)
        with torch.no_grad():
            y_t = net(torch.from_numpy(x), sample_subnet(net.space, seed=2), pixel_d)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
