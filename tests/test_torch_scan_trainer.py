"""The port's masked form and its multi-step training dispatch against the
JAX package on the CPU: `SubnetConfig.to_device`, the elastic-kernel
candidates and their one-hot select, masked BN, the masked forwards of the
S4 and the X4 (both modes), `sr_touched_mask`, the gated optimizer,
`SRTrainer.make_scan_train_step` and `RunConfig.steps_per_dispatch`.

On the CPU the window step runs the masked step eagerly (no CUDA graphs);
the card's graphs are held to these same steps by `chip_smoke.py` phase 13.

Inputs come from numpy seeds; the port's seeded weights (with random BN
statistics and transform matrices) cross into JAX through
`import_torch_s4` / `import_torch_x4`, and JAX's results come back
through `s4_state_dict_from_jax` / `x4_state_dict_from_jax`, float32. Tolerances:
the candidates, the select, masked BN and the gated optimizer against
their JAX and torch counterparts 1e-6 (one layer, the same arithmetic in
another order); whole forwards and running statistics rtol/atol 1e-4 (a
dozen layers summed in other orders, as tests/test_torch_train.py); the
window steps against JAX's `make_scan_train_step` on the JAX tests' own
inputs (tests/test_scan_trainer.py: its spaces, PRNG inits, batches and
subnets) at their tolerances (params and state rtol 1e-4, atol 1e-5, with
touched atol 2e-5; the window's mean loss 1e-5), and against the port's
eager `train_step` the same. The touched case's Adam moves a weight by
about lr * g / (|g| + eps), so where a gradient is near eps the two
packages' float32 sums move it apart by a few percent of lr (one element of
1,600 by 2.9e-5 was seen on other weights): its inputs are the JAX test's.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.models import OFAMobileNetS4 as JaxS4
from ofa_sr_tpu.models import OFAMobileNetX4 as JaxX4
from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu.ops import elastic as jelastic
from ofa_sr_tpu.ops import norm as jnorm
from ofa_sr_tpu.train import SRTrainer as JaxTrainer
from ofa_sr_tpu.train.checkpoint import import_torch_s4, import_torch_x4
from ofa_sr_tpu.train.optim import TorchOpt, no_decay_mask
from ofa_sr_tpu.train.touched import sr_touched_mask as jax_touched
from ofa_sr_tpu_torch.data import SyntheticSRProvider
from ofa_sr_tpu_torch.models import OFAMobileNetS4, OFAMobileNetX4, SearchSpace, sample_subnet
from ofa_sr_tpu_torch.models.arch import (
    SubnetConfig,
    reference_quirk_arch_s4,
    reference_quirk_arch_x4,
)
from ofa_sr_tpu_torch.ops import elastic as telastic
from ofa_sr_tpu_torch.ops.norm import batch_norm, batch_norm_train
from ofa_sr_tpu_torch.train import RunConfig, SRRunManager, SRTrainer, build_optimizer
from ofa_sr_tpu_torch.train.checkpoint import s4_state_dict_from_jax, x4_state_dict_from_jax
from ofa_sr_tpu_torch.train.optim import GatedOpt
from ofa_sr_tpu_torch.train.touched import sr_touched_mask

SPACE_KW = dict(ks_list=[3, 5, 7], expand_list=[3, 4, 6], depth_list=[2, 3],
                pixel_d_list=[1, 2], n_stages=2, width=16)
# the spaces of tests/test_scan_trainer.py
SMALL_KW = dict(ks_list=[3, 5], expand_list=[2, 3], depth_list=[1, 2],
                pixel_d_list=[1, 2], n_stages=1, width=8)
TOUCHED_KW = dict(ks_list=[3, 5], expand_list=[3, 4], depth_list=[1, 2],
                  pixel_d_list=[1], n_stages=2, width=16)
TEACHER_KW = dict(ks_list=[5], expand_list=[3], depth_list=[2], pixel_d_list=[1],
                  n_stages=1, width=8)
EXACT = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-4)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
TOUCHED_STEP_TOL = dict(rtol=1e-4, atol=2e-5)
BS, HR = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small nets: one PyTorch thread for the module (faster here, and no
    oversubscription under parallel test workers), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(cfg):
    return jarch.SubnetConfig(ks=cfg.ks, e=cfg.e, d=cfg.d, pixel_d=cfg.pixel_d)


def _bridge(kind):
    return x4_state_dict_from_jax if kind == "x4" else s4_state_dict_from_jax


def _port_net(kind, p, s, space_kw):
    net = (OFAMobileNetX4 if kind == "x4" else OFAMobileNetS4)(SearchSpace(**space_kw),
                                                               device="cpu")
    net.load_state_dict(_bridge(kind)(p, s))
    return net


def _twin(kind, space_kw=SPACE_KW, seed=0, randomize=True):
    """(JAX net, params, state): the port's net seeded `seed`, with random
    BN parameters and statistics and transform matrices off the identity
    (`randomize`), imported into JAX."""
    net = (OFAMobileNetX4 if kind == "x4" else OFAMobileNetS4)(
        SearchSpace(**space_kw), device="cpu", generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    sd = net.state_dict()
    for name, t in sd.items() if randomize else ():
        if name.endswith(("bn.weight", "running_var")):
            t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
        elif name.endswith(("bn.bias", "running_mean")):
            t.copy_(torch.from_numpy((0.2 * rng.randn(*t.shape)).astype(np.float32)))
        elif name.endswith("_matrix"):
            t.add_(torch.from_numpy((0.05 * rng.randn(*t.shape)).astype(np.float32)))
    jnet = (JaxX4 if kind == "x4" else JaxS4)(jarch.SearchSpace(**space_kw))
    p, s = (import_torch_x4 if kind == "x4" else import_torch_s4)(sd, jnet)
    return jnet, p, s


@pytest.fixture(scope="module")
def twins():
    return {kind: _twin(kind) for kind in ("s4", "x4")}


def _assert_state_matches(net, ref, tol):
    got = net.state_dict()
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **tol)


def _batch_np(rng, n=None):
    lead = () if n is None else (n,)
    return {k: rng.rand(*lead, BS, HR // f, HR // f, 3).astype(np.float32)
            for k, f in (("image", 1), ("x2", 2), ("x4", 4))}


@pytest.mark.parametrize("space_kw,n_trunks", [(SPACE_KW, 1), (SPACE_KW, 2), (SMALL_KW, 1)])
def test_to_device_matches_jax(space_kw, n_trunks):
    tsp, jsp = SearchSpace(**space_kw), jarch.SearchSpace(**space_kw)
    for seed in range(5):
        cfg = sample_subnet(tsp, seed=seed, n_trunks=n_trunks)
        got, ref = cfg.to_device(tsp), _jcfg(cfg).to_device(jsp)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == torch.int32, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_kernel_candidates_and_select_match_jax():
    """Candidates against JAX's (HWIO -> OIHW) at 1e-6; the select exact;
    the gradient of a selected kernel against JAX's, reaching only that
    kernel's transform chain (the other matrices' gradients exactly 0)."""
    rng = np.random.RandomState(0)
    ks_list, c = [3, 5, 7], 8
    w = rng.randn(7, 7, 1, c).astype(np.float32)
    mats = {k: (np.eye(n * n) + 0.1 * rng.randn(n * n, n * n)).astype(np.float32)
            for k, n in (("7to5", 5), ("5to3", 3))}
    r = rng.randn(c, 1, 7, 7).astype(np.float32)
    jc = jelastic.kernel_candidates(jnp.asarray(w), {k: jnp.asarray(v) for k, v in mats.items()},
                                    ks_list)
    wt = torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()).requires_grad_()
    mt = {k: torch.from_numpy(v).requires_grad_() for k, v in mats.items()}
    tc = telastic.kernel_candidates(wt, mt, ks_list)
    np.testing.assert_allclose(tc.detach().numpy(),
                               np.transpose(np.asarray(jc), (0, 4, 3, 1, 2)), **EXACT)

    def jloss(w_, m_, idx):
        sel = jelastic.select_kernel(jelastic.kernel_candidates(w_, m_, ks_list), idx)
        return jnp.sum(jnp.transpose(sel, (3, 2, 0, 1)) * r)

    jgrad = jax.jit(jax.grad(jloss, argnums=(0, 1)))
    for idx in range(3):
        sel = telastic.select_kernel(tc, torch.tensor(idx, dtype=torch.int32))
        assert torch.equal(sel, tc[idx])
        for t in [wt, *mt.values()]:
            t.grad = None
        (telastic.select_kernel(telastic.kernel_candidates(wt, mt, ks_list),
                                torch.tensor(idx, dtype=torch.int32)) * torch.from_numpy(r)
         ).sum().backward()
        gw, gm = jgrad(jnp.asarray(w), {k: jnp.asarray(v) for k, v in mats.items()}, idx)
        np.testing.assert_allclose(wt.grad.numpy(),
                                   np.transpose(np.asarray(gw), (3, 2, 0, 1)), **EXACT)
        used = {0: {"7to5", "5to3"}, 1: {"7to5"}, 2: set()}[idx]
        for k, t in mt.items():
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(gm[k]), **EXACT)
            assert bool(t.grad.abs().sum() > 0) == (k in used), (idx, k)
    np.testing.assert_array_equal(
        telastic.channel_mask(torch.tensor(5, dtype=torch.int32), 8).numpy(),
        np.asarray(jelastic.channel_mask(5, 8)))


@pytest.mark.parametrize("mode", ["train plain", "train kernels", "eval"])
def test_masked_bn_matches_jax(mode):
    """y, the running statistics and dx, dscale, dbias of BN with a channel
    mask (active width 10 of 24) against JAX's `batch_norm(mask=...)`; "train
    kernels" is the BN kernels' route (their plain versions on the CPU)."""
    rng = np.random.RandomState(1)
    c, active = 24, 10
    x = (1.5 * rng.randn(2, 4, 4, c) + 0.3).astype(np.float32)
    dy = rng.randn(2, 4, 4, c).astype(np.float32)
    sc, b = rng.uniform(0.5, 1.5, c).astype(np.float32), (0.2 * rng.randn(c)).astype(np.float32)
    rm, rv = (0.2 * rng.randn(c)).astype(np.float32), rng.uniform(0.5, 1.5, c).astype(np.float32)
    training = mode != "eval"
    mask = (np.arange(c) < active).astype(np.float32)

    def f(x_, sc_, b_):
        return jnorm.batch_norm(x_, {"scale": sc_, "bias": b_},
                                {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)},
                                training=training, mask=jnp.asarray(mask))

    (y_j, st_j), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(sc), jnp.asarray(b))
    grads_j = vjp((jnp.asarray(dy), jax.tree.map(jnp.zeros_like, st_j)))
    xt, sct, bt = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, sc, b))
    rmt, rvt = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    act = torch.tensor(active, dtype=torch.int32)
    if training:
        y = batch_norm_train(xt, sct, bt, rmt, rvt, momentum=0.1, eps=1e-5,
                             use_kernels=mode == "train kernels", active=act)
    else:
        y = batch_norm(xt, sct, bt, rmt, rvt, eps=1e-5, active=act)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **EXACT)
    assert not y[..., active:].any()
    np.testing.assert_allclose(rmt.numpy(), np.asarray(st_j["mean"]), **EXACT)
    np.testing.assert_allclose(rvt.numpy(), np.asarray(st_j["var"]), **EXACT)
    np.testing.assert_array_equal(rmt[active:].numpy(), rm[active:])
    for got, ref in zip((xt.grad, sct.grad, bt.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **EXACT)


def _cfg_with_pixel_d(space, pd, n_trunks):
    for seed in range(100):
        cfg = sample_subnet(space, seed=seed, n_trunks=n_trunks)
        if cfg.pixel_d == pd:
            return cfg
    raise AssertionError(pd)


@pytest.mark.parametrize("kind,mode", [("s4", "sr"), ("x4", "sr"), ("x4", "autoencoder")])
@pytest.mark.parametrize("bn_training", [True, False])
def test_masked_forward_matches_jax_and_sliced(twins, kind, mode, bn_training):
    """`forward_masked` (plain BN and the BN kernels' route) against the
    port's sliced forward and JAX's `apply(..., arch=cfg.to_device(space))`:
    outputs and running statistics, pixel_d 1 and 2 in train-mode BN, 2 in
    eval mode."""
    jnet, p, s = twins[kind]
    n_trunks = 2 if kind == "x4" else 1
    space = SearchSpace(**SPACE_KW)
    rng = np.random.RandomState(2)
    kw = {"mode": mode} if kind == "x4" else {}
    for pd in (1, 2) if bn_training else (2,):
        cfg = _cfg_with_pixel_d(space, pd, n_trunks)
        x = rng.rand(BS, *((HR, HR) if mode == "autoencoder" else (HR // 2 ** pd,) * 2),
                     3).astype(np.float32)
        y_j, s_j = jax.jit(jnet.apply, static_argnames=("pixel_d", "training", "bn_training")
                           + tuple(kw))(
            p, s, jnp.asarray(x), _jcfg(cfg).to_device(jnet.space), pixel_d=pd, training=True,
            bn_training=bn_training, **kw)
        ref_state = _bridge(kind)(p, s_j)
        sliced = _port_net(kind, p, s, SPACE_KW)
        y_s = sliced(torch.from_numpy(x), cfg, pd, bn_training=bn_training, **kw).detach()
        for use_kernels in (False, True):
            net = _port_net(kind, p, s, SPACE_KW)
            y_m = net.forward_masked(torch.from_numpy(x), cfg.to_device(space), cfg.d, pd,
                                     bn_training=bn_training, use_kernels=use_kernels,
                                     **kw).detach()
            np.testing.assert_allclose(y_m.numpy(), np.asarray(y_j), **TOL)
            np.testing.assert_allclose(y_m.numpy(), y_s.numpy(), **TOL)
            _assert_state_matches(net, ref_state, TOL)
        _assert_state_matches(sliced, ref_state, TOL)


@pytest.mark.parametrize("kind", ["s4", "x4"])
def test_touched_matches_jax(kind):
    """`sr_touched_mask` against JAX's over the port's parameter names, for
    one subnet and four, each mode, with and without the reference's quirk
    architectures (4 stages a trunk, as the quirks read)."""
    space_kw = dict(SPACE_KW, n_stages=4, width=8, depth_list=[2, 3, 4])
    space, n_trunks = SearchSpace(**space_kw), 2 if kind == "x4" else 1
    jnet, p, s = _twin(kind, space_kw, randomize=False)
    net = (OFAMobileNetX4 if kind == "x4" else OFAMobileNetS4)(space, device="cpu")
    quirk = reference_quirk_arch_x4 if kind == "x4" else reference_quirk_arch_s4
    n_false = 0
    for mode in ("sr", "autoencoder") if kind == "x4" else ("sr",):
        for use_quirk in (False, True):
            for k in (1, 4):
                for seed in range(4):
                    cfgs = [sample_subnet(space, seed=10 * seed + j, n_trunks=n_trunks)
                            for j in range(k)]
                    if use_quirk:
                        cfgs = [quirk(c) for c in cfgs]
                    jt = jax_touched(jnet, p, [_jcfg(c) for c in cfgs], mode=mode)
                    full = jax.tree.map(lambda t, a: np.full(np.shape(a), bool(t)), jt, p)
                    ref = {n: bool(v.numpy().all()) for n, v in _bridge(kind)(full, s).items()}
                    got = sr_touched_mask(net, cfgs, mode)
                    assert sorted(got) == sorted(n for n, _ in net.named_parameters())
                    for name, t in got.items():
                        assert t == ref[name], (mode, use_quirk, k, seed, name)
                    n_false += sum(not t for t in got.values())
    assert n_false > 0


def _grad_views(opt):
    return {id(p): g for p, g in zip(opt.params, opt.grad_views)}


@pytest.mark.parametrize("opt_type", ["adam", "sgd"])
def test_gated_opt_matches_torch_with_none_grads(opt_type):
    """`GatedOpt.step` against torch.optim.Adam / SGD (Nesterov) over 3
    steps whose gradients are None for some parameters (a different set
    each step), weight decay on one group; then the two state_dicts, and
    each loaded into the other."""
    space = SearchSpace(**SPACE_KW)
    a = OFAMobileNetS4(space, device="cpu")
    b = OFAMobileNetS4(space, device="cpu")
    ref, gated = build_optimizer(a, opt_type, 3e-5), GatedOpt(build_optimizer(b, opt_type, 3e-5))
    rng = np.random.RandomState(3)
    params = list(a.parameters())
    for step in range(3):
        grads = [torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                 if i % 4 and (i + step) % 3 else None for i, p in enumerate(params)]
        for net, opt in ((a, ref), (b, gated)):
            opt.zero_grad(set_to_none=True)
            for prm, g in zip(net.parameters(), grads):
                prm.grad = None if g is None else g.clone()
            for group in opt.param_groups:
                group["lr"] = 1e-2
            opt.step()
        for pa, pb in zip(a.parameters(), b.parameters()):
            np.testing.assert_allclose(pb.detach().numpy(), pa.detach().numpy(), **EXACT)
    sd_ref, sd_gated = ref.state_dict(), gated.state_dict()
    assert sorted(sd_ref["state"]) == sorted(sd_gated["state"])
    assert len(sd_ref["state"]) < len(params)
    assert sd_ref["param_groups"] == sd_gated["param_groups"]
    for i, st in sd_ref["state"].items():
        assert sorted(st) == sorted(sd_gated["state"][i])
        for key, v in st.items():
            np.testing.assert_allclose(sd_gated["state"][i][key].numpy(), v.numpy(), **EXACT)
    back = build_optimizer(OFAMobileNetS4(space, device="cpu"), opt_type, 3e-5)
    back.load_state_dict(sd_gated)
    again = GatedOpt(build_optimizer(OFAMobileNetS4(space, device="cpu"), opt_type, 3e-5))
    again.load_state_dict(sd_ref)
    sd_again = again.state_dict()
    for i, st in sd_ref["state"].items():
        for key, v in st.items():
            np.testing.assert_array_equal(sd_again["state"][i][key].numpy(), v.numpy())


@pytest.mark.parametrize("opt_type", ["adam", "sgd"])
def test_gated_opt_matches_jax_torchopt(twins, opt_type):
    """`GatedOpt.update` against JAX `TorchOpt.update(..., touched)` over 3
    steps of random gradients, each step's touched mask from one subnet,
    weight decay 3e-5 on JAX's `no_decay_mask` (the port's groups by name)."""
    jnet, p, s = twins["s4"]
    net = _port_net("s4", p, s, SPACE_KW)
    tx = TorchOpt(opt_type, 3e-5, no_decay_mask(p), momentum=0.9, nesterov=True)
    jstate = tx.init(p)
    update = jax.jit(tx.update)
    gated = GatedOpt(build_optimizer(net, opt_type, 3e-5))
    views = _grad_views(gated)
    names = {id(q): k for k, q in net.named_parameters()}
    rng = np.random.RandomState(4)
    jp = p
    for step in range(3):
        cfg = sample_subnet(net.space, seed=step)
        g = jax.tree.map(lambda a: jnp.asarray(rng.randn(*np.shape(a)).astype(np.float32)), jp)
        touched = jax_touched(jnet, jp, [_jcfg(cfg)])
        jp, jstate = update(jp, g, jstate, 1e-2, touched)
        named_g = s4_state_dict_from_jax(g, s)
        mask = sr_touched_mask(net, [cfg])
        for name, prm in net.named_parameters():
            views[id(prm)].copy_(named_g[name])
        gated.touched.copy_(torch.tensor([mask[names[id(q)]] for q in gated.params]))
        gated.lr.fill_(1e-2)
        gated.update()
    _assert_state_matches(net, s4_state_dict_from_jax(jp, s), EXACT)


def _jax_scan(jtr, p, s, batches, cfgs, lrs, touched=None, **teacher_kw):
    scan = jtr.make_scan_train_step(n_subnets=1, donate=False, **teacher_kw)
    archs = (jax.tree.map(lambda *a: jnp.stack(a),
                          *[_jcfg(c).to_device(jtr.net.space) for c in cfgs]),)
    if touched is not None:
        touched = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *touched)
    p1, s1, _, m = scan(p, s, jtr.init_opt_state(p), {k: jnp.asarray(v) for k, v in
                                                      batches.items()},
                        archs, jnp.asarray(lrs, jnp.float32), touched)
    return p1, s1, float(m["loss"])


def _port_window(kind_kw, p, s, batches, cfgs, lrs, opt_type, *, scan, touched=None,
                 teacher=None, kd_ratio=0.0):
    """The port's window of steps on a net loaded from (p, s): through
    `make_scan_train_step` (`scan`), or step by step through `train_step`.
    Returns the net and the window's mean loss."""
    net = _port_net("s4", p, s, kind_kw)
    tr = SRTrainer(net, opt_type=opt_type, weight_decay=0.0 if opt_type == "sgd" else 3e-5,
                   kd_ratio=kd_ratio, teacher=teacher)
    tb = [{k: torch.from_numpy(v[i]) for k, v in batches.items()} for i in range(len(cfgs))]
    if scan:
        m = tr.make_scan_train_step(1)(tb, [[c] for c in cfgs], lrs, touched=touched)
        return net, float(m["loss"])
    losses = [float(tr.train_step(b, [c], lr)["loss"]) for b, c, lr in zip(tb, cfgs, lrs)]
    return net, float(np.mean(losses))


@pytest.mark.parametrize("case", ["plain", "touched", "kd"])
def test_scan_step_matches_jax_scan_and_train_step(case):
    """The three window tests of tests/test_scan_trainer.py on the port:
    "plain" (SGD; JAX's step without a touched mask updates every leaf, so
    the port's step takes every parameter as touched), "touched" (Adam,
    weight decay, the masks from the subnets on both sides) and "kd" (SGD
    with a teacher, every leaf touched), each against JAX's
    `make_scan_train_step`; then the port's window with its own touched
    masks against its eager `train_step` over the same steps."""
    n = 3
    rng = np.random.RandomState(0 if case != "kd" else 1)
    space_kw = TOUCHED_KW if case == "touched" else SMALL_KW
    jnet = JaxS4(jarch.SearchSpace(**space_kw))
    p, s = jax.jit(jnet.init)(jax.random.PRNGKey(1 if case == "kd" else 0))
    space = SearchSpace(**space_kw)
    if case == "touched":
        one = _batch_np(rng)
        batches = {k: np.broadcast_to(v, (n,) + v.shape).copy() for k, v in one.items()
                   if k != "x4"}
        cfgs = [sample_subnet(space, seed=i) for i in range(n)]
        lrs, opt_type, tol = [1e-3] * n, "adam", TOUCHED_STEP_TOL
    else:
        batches = _batch_np(rng, n)
        cfgs = [sample_subnet(space, seed=i + (10 if case == "kd" else 0)) for i in range(n)]
        lrs, opt_type, tol = [1e-2] * n, "sgd", STEP_TOL
    teacher_kw, teacher, kd_ratio = {}, None, 0.0
    if case == "kd":
        tnet = JaxS4(jarch.SearchSpace(**TEACHER_KW))
        tp, ts = jax.jit(tnet.init)(jax.random.PRNGKey(7))
        t_cfg = sample_subnet(SearchSpace(**TEACHER_KW), seed=0)
        teacher_kw = dict(teacher_params=tp, teacher_state=ts,
                          teacher_arch=_jcfg(t_cfg).to_device(tnet.space), teacher_pixel_d=1)
        teacher, kd_ratio = (_port_net("s4", tp, ts, TEACHER_KW), t_cfg, 1), 1.0
    jtr = JaxTrainer(jnet, opt_type=opt_type, weight_decay=0.0 if opt_type == "sgd" else 3e-5,
                     kd_ratio=kd_ratio, teacher_net=tnet if case == "kd" else None)
    jt = ([jax_touched(jnet, p, [_jcfg(c)]) for c in cfgs] if case == "touched" else None)
    p1, s1, loss_j = _jax_scan(jtr, p, s, batches, cfgs, lrs, jt, **teacher_kw)
    everything = None
    if case != "touched":
        names = [name for name, _ in _port_net("s4", p, s, space_kw).named_parameters()]
        everything = [dict.fromkeys(names, True)] * n
    kw = dict(teacher=teacher, kd_ratio=kd_ratio)
    net, loss_t = _port_window(space_kw, p, s, batches, cfgs, lrs, opt_type, scan=True,
                               touched=everything, **kw)
    assert abs(loss_t - loss_j) < 1e-5
    _assert_state_matches(net, s4_state_dict_from_jax(p1, s1), tol)
    # the port's own semantics: the window against the eager steps
    net_scan, loss_scan = _port_window(space_kw, p, s, batches, cfgs, lrs, opt_type, scan=True,
                                       **kw)
    net_eager, loss_eager = _port_window(space_kw, p, s, batches, cfgs, lrs, opt_type,
                                         scan=False, **kw)
    assert abs(loss_scan - loss_eager) < 1e-5
    _assert_state_matches(net_scan, net_eager.state_dict(), tol)


def _run_manager(tmp, spd, *, n_epochs=1, seed=0):
    space = SearchSpace(**SPACE_KW)
    net = OFAMobileNetS4(space, device="cpu", generator=torch.Generator().manual_seed(seed))
    rc = RunConfig(n_epochs=n_epochs, base_lr=1e-2, opt_type="sgd", weight_decay=3e-5,
                   print_frequency=2, dynamic_batch_size=2, image_size=HR,
                   steps_per_dispatch=spd, manual_seed=0)
    provider = SyntheticSRProvider(n_train=10, n_valid=2, hr_size=HR, train_batch_size=BS)
    return SRRunManager(str(tmp), net, rc, provider)


def _train_lines(rm):
    with open(rm.logs_path + "/train_console.txt") as f:
        return [line.split("\t")[0] for line in f if line.startswith("Train")]


def test_run_manager_steps_per_dispatch(tmp_path):
    """An epoch of 5 steps of 2 subnets at steps_per_dispatch 3 (a window
    of 3 and a tail of 2) against the same epoch at 1: parameters and
    running statistics at STEP_TOL, the epoch's loss, and the log lines
    (print_frequency 2: after steps 2, 4 and 5 at 1; once a window where a
    boundary falls inside it, steps 3 and 5, at 3). Then each checkpoint
    resumed at the other value for a second epoch: the optimizer state
    carries over in torch's layout and both runs agree."""
    rms = {spd: _run_manager(tmp_path / ("spd%d" % spd), spd) for spd in (1, 3)}
    results = {spd: rm.train() for spd, rm in rms.items()}
    assert np.isfinite(list(results.values())).all()
    _assert_state_matches(rms[3].net, rms[1].net.state_dict(), STEP_TOL)
    assert _train_lines(rms[1]) == ["Train [1][2/5]", "Train [1][4/5]", "Train [1][5/5]"]
    assert _train_lines(rms[3]) == ["Train [1][3/5]", "Train [1][5/5]"]
    assert isinstance(rms[3].trainer.opt, GatedOpt)
    saved3 = rms[3].trainer.opt.state_dict()
    resumed = {}
    for spd, src in ((1, 3), (3, 1)):
        rm = _run_manager(tmp_path / ("spd%d" % src), spd, n_epochs=2, seed=5)
        rm.load_model()
        assert rm.start_epoch == 1
        if spd == 1:  # torch's own optimizer holds the gated run's state
            loaded = rm.trainer.opt.state_dict()
            assert sorted(loaded["state"]) == sorted(saved3["state"])
            for i, st in saved3["state"].items():
                np.testing.assert_array_equal(loaded["state"][i]["momentum_buffer"].numpy(),
                                              st["momentum_buffer"].numpy())
        rm.train()
        resumed[spd] = rm
    _assert_state_matches(resumed[3].net, resumed[1].net.state_dict(), STEP_TOL)


def test_scan_step_refuses_mesh_and_bad_windows(tmp_path):
    space = SearchSpace(**SMALL_KW)
    tr = SRTrainer(OFAMobileNetS4(space, device="cpu"), opt_type="sgd")
    step = tr.make_scan_train_step(2)
    cfg = sample_subnet(space, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in _batch_np(np.random.RandomState(0)).items()}
    with pytest.raises(ValueError, match="one batch"):
        step([batch], [[cfg]], [1e-2])
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        RunConfig(steps_per_dispatch=0)
    # a world-1 mesh (no process group) builds the window step, which gives
    # the no-mesh step's numbers
    mesh = types.SimpleNamespace(rank=0, world=1, group=None)
    cfgs = [[sample_subnet(space, seed=i)] for i in range(2)]
    out = {}
    for m in (None, mesh):
        net = OFAMobileNetS4(space, device="cpu", generator=torch.Generator().manual_seed(3))
        got = SRTrainer(net, opt_type="sgd", mesh=m).make_scan_train_step()(
            [batch] * 2, cfgs, [1e-2] * 2)
        out[m is None] = (net.state_dict(), got["losses"], got["psnrs"])
    for a, b in zip(out[True][1:], out[False][1:]):
        assert torch.equal(a, b)
    for k, v in out[True][0].items():
        assert torch.equal(out[False][0][k], v), k
    rm = SRRunManager(str(tmp_path), OFAMobileNetS4(space, device="cpu"),
                      RunConfig(steps_per_dispatch=2), None, mesh=mesh)
    assert rm.run_config.steps_per_dispatch == 2 and rm.mesh is mesh
    assert isinstance(SubnetConfig(ks=(3,), e=(2,), d=(1,), pixel_d=1).to_device(space)["mid"],
                      torch.Tensor)
