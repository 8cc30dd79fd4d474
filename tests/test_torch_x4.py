"""The port's X4 supernet (learned downscale + SR) against the JAX package on
the CPU, from the same weights (a JAX twin with random BN and transform
matrices, through the weight bridge) and numpy-seeded inputs.

Small space: width 16, two stages of up to 3 blocks a trunk, ks 3/5/7,
e 3/4/6, pixel_d 1/2. Tolerances: float32 forwards, running statistics and
static subnets rtol/atol 1e-4 (two trunks of blocks summed in other
orders); bf16 forwards the bounds of tests/test_torch_bf16.py (a few bf16
ulps at the output's scale, half an ulp on average; running statistics
1e-2), the autoencoder's per half (its docstring says why); the bucketed
eval rtol 1e-5 / atol 1e-6 as tests/test_torch_run_manager.py holds the
S4's; SGD trajectories across a
reorganize: loss rtol 1e-5, parameters and BN statistics atol 1e-5; Adam
trajectories: loss and PSNR rtol 2e-3 (tests/test_torch_train.py's
bounds); the weight bridge and the reorganize's permutations exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.models import OFAMobileNetX4 as JaxX4
from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu.models import reorganize as jreorg
from ofa_sr_tpu.models.materialize import get_active_subnet as jax_get_active_subnet
from ofa_sr_tpu.train import SRTrainer as JaxTrainer
from ofa_sr_tpu.train import schedules as jsched
from ofa_sr_tpu.train.checkpoint import import_torch_x4
from ofa_sr_tpu.train.touched import sr_touched_mask
from ofa_sr_tpu.train.train_step import cast_params_for_compute
from ofa_sr_tpu_torch import entry as tentry
from ofa_sr_tpu_torch.models import OFAMobileNetX4, SearchSpace, get_active_subnet, sample_subnet
from ofa_sr_tpu_torch.models import reorganize as treorg
from ofa_sr_tpu_torch.models.arch import max_subnet, uniform_subnet
from ofa_sr_tpu_torch.ops.kernels import fused_mbconv_infer, fused_shuffle_tail
from ofa_sr_tpu_torch.train import SRTrainer
from ofa_sr_tpu_torch.train import schedules as tsched
from ofa_sr_tpu_torch.train.checkpoint import x4_state_dict_from_jax
from test_torch_bf16 import FWD_ULPS_MAX, FWD_ULPS_MEAN, _assert_forward_close, _ulp
from test_torch_model import _randomize_bn

SPACE_KW = dict(ks_list=[3, 5, 7], expand_list=[3, 4, 6], depth_list=[2, 3],
                pixel_d_list=[1, 2], n_stages=2, width=16)
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_STATE_TOL = dict(rtol=1e-2, atol=1e-2)
BUCKET_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=2e-3, atol=2e-5)
BS, HR, N_STEPS = 2, 16, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's nets run at sizes where PyTorch's intra-op threads
    cost more than they save (the full-width X4 on 8-16 px images runs 3x
    faster on one thread) and oversubscribe the CPU under parallel test
    workers: one thread for the module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twin():
    """A JAX X4 with random BN and transform matrices, and its params."""
    rng = np.random.RandomState(0)
    jnet = JaxX4(jarch.SearchSpace(**SPACE_KW))
    p, s = jnet.init(jax.random.PRNGKey(0))
    p, s = _randomize_bn(p, rng), _randomize_bn(s, rng)
    for key in ("enc_blocks", "dec_blocks"):
        for bp in p[key]:
            bp["depth_conv"]["kt"] = {
                k: v + jnp.asarray((0.05 * rng.randn(*v.shape)).astype(np.float32))
                for k, v in bp["depth_conv"]["kt"].items()}
    return jnet, p, s


def _port(p, s, space_kw=SPACE_KW):
    net = OFAMobileNetX4(SearchSpace(**space_kw), device="cpu")
    net.load_state_dict(x4_state_dict_from_jax(p, s))
    return net


def _x(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _cfgs(seed, space_kw=SPACE_KW):
    """The same X4 subnet from both samplers (both trunks' choices)."""
    j = jarch.sample_subnet(jarch.SearchSpace(**space_kw), seed=seed, n_trunks=2)
    t = sample_subnet(SearchSpace(**space_kw), seed=seed, n_trunks=2)
    assert (j.ks, j.e, j.d, j.pixel_d) == (t.ks, t.e, t.d, t.pixel_d)
    assert len(t.d) == 2 * space_kw["n_stages"]
    return j, t


def _tree_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for u, v in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def _assert_state_matches(net, p, s, tol):
    ref = x4_state_dict_from_jax(p, s)
    got = net.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **tol)


def test_weight_bridge_round_trips(twin):
    jnet, p, s = twin
    p2, s2 = import_torch_x4(_port(p, s).state_dict(), jnet)
    _tree_equal(p2, p)
    _tree_equal(s2, s)
    fresh = OFAMobileNetX4(SearchSpace(**SPACE_KW), device="cpu",
                           generator=torch.Generator().manual_seed(3), icnr=True)
    sd = fresh.state_dict()
    back = x4_state_dict_from_jax(*import_torch_x4(sd, jnet))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # the reference layout: unshuffle convs, encoder and decoder MBConv, shuffle convs
    n_mb = fresh.space.blocks_per_trunk
    assert sd["blocks.0.conv.weight"].shape == (4, 3, 3, 3)
    assert sd["blocks.1.conv.weight"].shape == (4, 16, 3, 3)
    assert "blocks.%d.mobile_inverted_conv.depth_conv.conv.7to5_matrix" % (2 + 2 * n_mb - 1) in sd
    assert sd["blocks.%d.conv.weight" % (2 + 2 * n_mb)].shape == (64, 16, 3, 3)
    # ICNR: the four sub-pixel filters of each shuffle output channel agree
    w = sd["blocks.%d.conv.weight" % (2 + 2 * n_mb)]
    assert torch.equal(w[0::4], w[3::4])


@pytest.mark.parametrize("bn,use_kernels", [("train", False), ("train", True), ("eval", False),
                                            ("frozen", False)])
@pytest.mark.parametrize("mode", ["sr", "autoencoder"])
@pytest.mark.parametrize("pixel_d", [1, 2])
def test_x4_forward_matches_jax(twin, mode, pixel_d, bn, use_kernels):
    """Both modes at pixel_d 1 and 2, with train-mode BN (and its running
    statistics; the kernel path's CPU plain versions too), eval-mode BN
    and frozen BN (a training net with BN in eval mode)."""
    jnet, p, s = twin
    jcfg, tcfg = _cfgs(10 * pixel_d + len(bn))
    hw = HR if mode == "autoencoder" else HR // 2 ** pixel_d
    x = _x((BS, hw, hw, 3), pixel_d)
    training = bn != "eval"
    y_j, s_j = jnet.apply(p, s, jnp.asarray(x), jcfg.to_device(jnet.space), pixel_d=pixel_d,
                          mode=mode, training=training, bn_training=bn == "train")
    net = _port(p, s)
    net.train(training)
    with torch.set_grad_enabled(training):
        y_t = net(torch.from_numpy(x), tcfg, pixel_d, mode=mode, bn_training=bn == "train",
                  use_kernels=use_kernels)
    out_hw = HR if mode == "autoencoder" else hw * 2 ** pixel_d
    assert tuple(y_t.shape) == (BS, out_hw, out_hw, 3)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    _assert_state_matches(net, p, s_j, TOL)
    if mode == "autoencoder" and training:  # encode + decode is the forward
        with torch.no_grad():
            lr = net.encode(torch.from_numpy(x), tcfg, pixel_d, bn_training=False)
            y2 = net.decode(lr, tcfg, pixel_d, bn_training=False)
            y3 = net(torch.from_numpy(x), tcfg, pixel_d, mode=mode, bn_training=False)
        assert tuple(lr.shape) == (BS, HR // 2 ** pixel_d, HR // 2 ** pixel_d, 3)
        assert torch.equal(y2, y3)


@pytest.mark.parametrize("mode", ["sr", "autoencoder"])
@pytest.mark.parametrize("pixel_d", [1, 2])
def test_x4_bf16_forward_matches_jax(twin, mode, pixel_d):
    """Train-mode forward in bf16 mixed precision against the JAX package's
    (`cast_params_for_compute`, the input cast to bf16). The autoencoder
    is two nets deep: the encoder, and the decoder on JAX's encoder output,
    are each held to test_torch_bf16.py's bounds (this CPU measured 0.24 to
    0.31 ulp on average, at most 2.5 ulps); the whole forward, where the
    encoder's flipped roundings feed the decoder, to the two halves' bounds
    summed, 8 ulps and 1 ulp on average (measured at most 5 and 0.67)."""
    jnet, p, s = twin
    jcfg, tcfg = _cfgs(40 + pixel_d)
    hw = HR if mode == "autoencoder" else HR // 2 ** pixel_d
    x = _x((BS, hw, hw, 3), 7)
    pb, arch = cast_params_for_compute(p, jnp.bfloat16), jcfg.to_device(jnet.space)
    xb = jnp.asarray(x, jnp.bfloat16)
    y_j, s_j = jnet.apply(pb, s, xb, arch, pixel_d=pixel_d, mode=mode, training=True)
    net = _port(p, s)
    net.train()
    y_t = net(torch.from_numpy(x), tcfg, pixel_d, mode=mode, compute_dtype=torch.bfloat16)
    assert y_t.dtype == torch.bfloat16 and y_j.dtype == jnp.bfloat16
    ref, got = x4_state_dict_from_jax(p, s_j), net.state_dict()
    for k, v in ref.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **BF16_STATE_TOL)
    if mode == "sr":
        _assert_forward_close(y_t.detach().float(), y_j.astype(jnp.float32))
        return
    got, want = y_t.detach().float().numpy(), np.asarray(y_j.astype(jnp.float32))
    ulp, d = _ulp(np.abs(want).max()), np.abs(got - want)
    lr_j, _ = jnet.encode(pb, s, xb, arch, pixel_d=pixel_d, training=True)
    lr_t = _port(p, s).encode(torch.from_numpy(x), tcfg, pixel_d, bn_training=True,
                              compute_dtype=torch.bfloat16)
    _assert_forward_close(lr_t.detach().float(), lr_j.astype(jnp.float32))
    y_j2, _ = jnet.decode(pb, s, lr_j, arch, pixel_d=pixel_d, training=True)
    lr = torch.from_numpy(np.array(lr_j.astype(jnp.float32))).to(torch.bfloat16)
    y_t2 = _port(p, s).decode(lr, tcfg, pixel_d, bn_training=True, compute_dtype=torch.bfloat16)
    _assert_forward_close(y_t2.detach().float(), y_j2.astype(jnp.float32))
    assert d.max() <= 2 * FWD_ULPS_MAX * ulp and d.mean() <= 2 * FWD_ULPS_MEAN * ulp


def test_subnet_length_and_mode_checked(twin):
    net = _port(*twin[1:])
    x = torch.zeros(1, 8, 8, 3)
    s4_cfg = uniform_subnet(net.space, 5, 4, 2, 1)  # one trunk's choices
    with pytest.raises(ValueError, match="n_trunks=2"):
        net(x, s4_cfg, 1)
    with pytest.raises(ValueError, match="n_trunks=2"):
        get_active_subnet(net, s4_cfg)
    cfg = uniform_subnet(net.space, 5, 4, 2, 1, n_trunks=2)
    with pytest.raises(ValueError, match="mode"):
        net(x, cfg, 1, mode="decoder")
    with pytest.raises(ValueError, match="eval-mode only"):
        net(x, cfg, 1, bn_training=True, valid_hw=(4, 4))
    assert max_subnet(net.space, net.n_trunks).d == (3,) * 4


@pytest.mark.parametrize("fold_bn,fold_tail,use_kernels", [
    (True, True, False), (True, False, False), (False, True, False), (True, True, True)])
@pytest.mark.parametrize("mode", ["sr", "autoencoder"])
def test_static_subnet_matches_jax(twin, mode, fold_bn, fold_tail, use_kernels):
    """StaticSubnet against JAX get_active_subnet. use_kernels on the CPU
    takes the MBConv kernel's plain version; the 3x3 shuffle convs never go
    to the 5x5 tail kernel, so the fold stays on."""
    jnet, p, s = twin
    fused_mbconv_infer.launches = fused_shuffle_tail.launches = 0
    net = _port(p, s)
    for seed in (4, 5):
        jcfg, tcfg = _cfgs(seed)
        hw = 12 if mode == "autoencoder" else 6
        x = _x((1, hw, hw + 4, 3), seed)
        jsub = jax_get_active_subnet(jnet, p, s, jcfg, fold_bn=fold_bn, fold_tail=fold_tail,
                                     mode=mode)
        tsub = get_active_subnet(net, tcfg, fold_bn=fold_bn, fold_tail=fold_tail, mode=mode,
                                 use_kernels=use_kernels)
        assert tsub.fold_tail == jsub.fold_tail == (fold_tail and fold_bn)
        assert not tsub.tail_kernel and all("w_hwio" not in lp for lp in tsub.params["shuffle"])
        assert ("enc_unshuffle_folded" in tsub.params) == (mode == "autoencoder" and
                                                           tsub.fold_tail)
        with torch.no_grad():
            y = tsub(torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), np.asarray(jsub(jnp.asarray(x))), **TOL)
        # the materialized subnet is the supernet's eval forward
        with torch.no_grad():
            y_net = net(torch.from_numpy(x), tcfg, tcfg.pixel_d, mode=mode, bn_training=False)
        np.testing.assert_allclose(y.numpy(), y_net.numpy(), **TOL)
    assert fused_mbconv_infer.launches == fused_shuffle_tail.launches == 0


def test_entry_serve_autoencoder_on_cpu(twin):
    net = _port(*twin[1:])
    cfg = uniform_subnet(net.space, 7, 6, 2, 2, n_trunks=2)
    frames = [_x((1, 12, 16, 3), i) for i in range(2)]
    out = tentry.serve(frames, net=net, cfg=cfg, device="cpu", mode="autoencoder")
    sub = get_active_subnet(net, cfg, mode="autoencoder")
    assert [tuple(o.shape) for o in out] == [(1, 12, 16, 3)] * 2
    with torch.no_grad():
        torch.testing.assert_close(out[1], sub(torch.from_numpy(frames[1])), rtol=0, atol=0)
    sr = tentry.serve(frames, net=net, cfg=cfg, device="cpu")
    assert [tuple(o.shape) for o in sr] == [(1, 48, 64, 3)] * 2


@pytest.mark.parametrize("pixel_d", [1, 2])
def test_bucketed_eval_autoencoder_matches_jax(twin, pixel_d):
    """An HR frame zero-padded into a bucket with valid_hw at the HR size:
    loss, PSNR-Y and the valid region against JAX's bucketed eval step and
    the unpadded frame's eval step."""
    jnet, p, s = twin
    jcfg, tcfg = _cfgs(60 + pixel_d)
    h, w = 12, 8
    hr = _x((BS, h, w, 3), pixel_d)
    padded = np.zeros((BS, 16, 16, 3), np.float32)
    padded[:, :h, :w] = hr
    batch = {"image": padded, "valid_hw": np.asarray([h, w], np.int32)}
    jtr = JaxTrainer(jnet, remat=False, mode="autoencoder")
    j = jtr.make_bucketed_eval_step(tcfg.pixel_d)(
        p, s, {"image": jnp.asarray(padded), "valid_hw": jnp.asarray([h, w])},
        jcfg.to_device(jnet.space))
    tr = SRTrainer(_port(p, s), mode="autoencoder")
    t = tr.bucketed_eval_step({"image": torch.from_numpy(padded), "valid_hw": (h, w)}, tcfg)
    for key in ("loss", "psnr"):
        np.testing.assert_allclose(float(t[key]), float(j[key]), **BUCKET_TOL)
    np.testing.assert_allclose(t["output"].numpy()[:, :h, :w],
                               np.asarray(j["output"])[:, :h, :w], **TOL)
    plain = tr.eval_step({"image": torch.from_numpy(hr)}, tcfg)
    np.testing.assert_allclose(t["output"].numpy()[:, :h, :w], plain["output"].numpy(), **TOL)
    np.testing.assert_allclose(float(t["psnr"]), float(plain["psnr"]), rtol=1e-5)


# -- reorganize ---------------------------------------------------------------

@pytest.mark.parametrize("stage", [0, 1, 2])
def test_reorganize_x4_matches_jax(twin, stage):
    """The port's in-place reorganize gives JAX's permuted params and state
    exactly (stage 0: pure importance order; 1, 2: the forced tails), keeps
    the parameter objects, and the max subnet computes the same function."""
    jnet, p, s = twin
    p2, s2 = jreorg.reorganize_x4(p, s, jnet.space, expand_ratio_stage=stage)
    net = _port(p, s)
    params = [id(q) for q in net.parameters()]
    cfg = max_subnet(net.space, 2)
    x = torch.from_numpy(_x((1, 8, 8, 3), 1))
    with torch.no_grad():
        before = net(x, cfg, 2, mode="autoencoder")
    orders = treorg.reorganize_x4(net, expand_ratio_stage=stage)
    assert [id(q) for q in net.parameters()] == params
    ref = x4_state_dict_from_jax(p2, s2)
    for k, v in net.state_dict().items():
        assert torch.equal(v, ref[k]), k
    assert len(orders) == 2 * net.space.blocks_per_trunk
    assert any((o != np.arange(len(o))).any() for o in orders)
    if stage == 0:
        with torch.no_grad():
            after = net(x, cfg, 2, mode="autoencoder")
        np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=1e-5, atol=1e-5)
    else:  # channels past the stage's width keep their order at the bottom
        target = round(net.space.width * sorted(net.space.expand_list, reverse=True)[stage])
        for o in orders:
            assert sorted(o[:target]) == list(range(target))
            assert list(o[target:]) == list(range(target, len(o)))


def test_zero_last_gamma_matches_jax(twin):
    jnet, p, s = twin
    net = _port(p, s)
    treorg.zero_last_gamma(net)
    ref = x4_state_dict_from_jax(jreorg.zero_last_gamma(jnet, p), s)
    for k, v in net.state_dict().items():
        assert torch.equal(v, ref[k]), k


# -- training in autoencoder mode, across a reorganize -------------------------

TRAIN_KW = dict(ks_list=[3, 5], expand_list=[3, 4], depth_list=[1, 2], pixel_d_list=[1, 2],
                n_stages=1, width=8)
REORG_AT = 1  # reorganize_x4 before this step


@pytest.fixture(scope="module")
def train_twin():
    rng = np.random.RandomState(1)
    jnet = JaxX4(jarch.SearchSpace(**TRAIN_KW))
    p, s = jnet.init(jax.random.PRNGKey(1))
    p, s = _randomize_bn(p, rng), _randomize_bn(s, rng)
    brng = np.random.RandomState(2)
    batch = {k: brng.rand(BS, HR // f, HR // f, 3).astype(np.float32)
             for k, f in (("image", 1), ("x2", 2), ("x4", 4))}
    return jnet, p, s, batch


def _step_seeds():
    """Seeds of the N_STEPS subnets: pixel_d 1, 2, 1."""
    by_pd = {1: [], 2: []}
    for seed in range(100, 200):
        by_pd[sample_subnet(SearchSpace(**TRAIN_KW), seed=seed, n_trunks=2).pixel_d].append(seed)
    return [by_pd[1][0], by_pd[2][0], by_pd[1][1]]


STEP_SEEDS = _step_seeds()


def _step_cfgs(i):
    return _cfgs(STEP_SEEDS[i], TRAIN_KW)


def _run_jax(train_twin, opt_type, base_lr):
    jnet, p, s, batch = train_twin
    tr = JaxTrainer(jnet, opt_type=opt_type, weight_decay=3e-5, remat=False,
                    mode="autoencoder")
    opt_state = tr.init_opt_state(p)
    step = tr.make_train_step(n_subnets=1, donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for i in range(N_STEPS):
        if i == REORG_AT:  # the stage machine's: new params, the same opt_state
            p, s = jreorg.reorganize_x4(p, s, jnet.space, expand_ratio_stage=1)
        jcfg, _ = _step_cfgs(i)
        touched = sr_touched_mask(jnet, p, [jcfg], mode="autoencoder")
        lr = jsched.lr_at_step(base_lr, 0, i, N_STEPS, 1)
        p, s, opt_state, m = step(p, s, opt_state, jb, (jcfg.to_device(jnet.space),),
                                  jnp.asarray(lr, jnp.float32), touched)
        metrics.append({k: float(v) for k, v in m.items()})
    return p, s, metrics


def _run_port(train_twin, opt_type, base_lr):
    jnet, p, s, batch = train_twin
    net = _port(p, s, TRAIN_KW)
    net.train()
    tr = SRTrainer(net, opt_type=opt_type, weight_decay=3e-5, mode="autoencoder")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = []
    for i in range(N_STEPS):
        if i == REORG_AT:
            treorg.reorganize_x4(net, expand_ratio_stage=1)
        _, tcfg = _step_cfgs(i)
        m = tr.train_step(tb, [tcfg], tsched.lr_at_step(base_lr, 0, i, N_STEPS, 1))
        metrics.append({k: float(v) for k, v in m.items()})
    return net, tr, metrics


@pytest.fixture(scope="module")
def trajectories(train_twin):
    return {name: (_run_jax(train_twin, *args), _run_port(train_twin, *args))
            for name, args in {"sgd": ("sgd", 0.05), "adam": ("adam", 1e-3)}.items()}


def test_sgd_steps_across_reorganize_match_jax(trajectories):
    (jp, js, jm), (net, _, tm) = trajectories["sgd"]
    np.testing.assert_allclose([m["loss"] for m in tm], [m["loss"] for m in jm], rtol=1e-5)
    _assert_state_matches(net, jp, js, dict(rtol=0, atol=1e-5))


def test_adam_steps_across_reorganize_match_jax(trajectories):
    """Adam's moments keep their channel order across the reorganize in
    both packages; a rebuilt optimizer would move the steps after it."""
    (jp, js, jm), (net, tr, tm) = trajectories["adam"]
    for key in ("loss", "psnr"):
        np.testing.assert_allclose([m[key] for m in tm], [m[key] for m in jm], **LOSS_TOL)
    assert len(tr.opt.state) > 0
    # the encoder trained: its parameters have optimizer state
    enc = net.enc_blocks[0].mobile_inverted_conv.inverted_bottleneck.conv.weight
    assert tr.opt.state[enc]["step"] == N_STEPS


def test_sr_mode_trains_the_decoder_only(train_twin):
    """X4 in sr mode: the encoder runs no step, gets no grad and no state."""
    jnet, p, s, batch = train_twin
    net = _port(p, s, TRAIN_KW)
    net.train()
    tr = SRTrainer(net, opt_type="adam", mode="sr")
    _, tcfg = _step_cfgs(0)
    m = tr.train_step({k: torch.from_numpy(v) for k, v in batch.items()}, [tcfg], 1e-3)
    assert np.isfinite(float(m["loss"]))
    enc = [q for b in net.unshuffle_blocks + net.enc_blocks + list(net.enc_final_conv_blocks)
           for q in b.parameters()]
    assert enc and all(q.grad is None and not tr.opt.state.get(q) for q in enc)
    assert net.dec_first_conv_block.conv.weight.grad is not None


def test_entry_train_x4_on_cpu():
    space = SearchSpace(**TRAIN_KW)
    for mode in ("sr", "autoencoder"):
        net = OFAMobileNetX4(space, device="cpu")
        out = tentry.train(2, device="cpu", net=net, batch_size=2, hr_size=16, mode=mode)
        assert len(out) == 2 and all(np.isfinite(m["loss"]) for m in out)
