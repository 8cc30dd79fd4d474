"""The port's training path against the JAX package on the CPU: train-mode
and frozen-BN forwards with their running statistics, one subnet's
gradients, several SRTrainer steps (JAX side: TorchOpt with
`sr_touched_mask`, the port: torch.optim with grads left None), the metric,
the schedules, the no-decay groups and `entry.train`.

Small search space (width 16, two stages), weights from a JAX twin through
the weight bridge, float32. Tolerances: forwards and running statistics
rtol/atol 1e-4 (a dozen layers summed in other orders); gradients 1e-4;
SGD trajectories params and BN state atol 1e-5; Adam trajectories per-step
loss and PSNR rtol 2e-3 / atol 2e-5 and the eval forward after the steps
rtol 5e-3 / atol 5e-4, as tests/test_train_parity.py holds the JAX package to
the torch reference (Adam's first steps move a weight by about lr*sign(g)
wherever |g| is near 0, so tiny gradient differences show in the params).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.models import OFAMobileNetS4 as JaxS4
from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu.train import SRTrainer as JaxTrainer
from ofa_sr_tpu.train import optim as joptim
from ofa_sr_tpu.train import schedules as jsched
from ofa_sr_tpu.train.touched import sr_touched_mask
from ofa_sr_tpu.utils import metrics as jmetrics
from ofa_sr_tpu_torch import entry as tentry
from ofa_sr_tpu_torch.models import OFAMobileNetS4, SearchSpace, sample_subnet, subnet_seed
from ofa_sr_tpu_torch.models.arch import uniform_subnet
from ofa_sr_tpu_torch.ops import norm as tnorm
from ofa_sr_tpu_torch.train import SRTrainer, param_groups
from ofa_sr_tpu_torch.train import schedules as tsched
from ofa_sr_tpu_torch.train.checkpoint import s4_state_dict_from_jax
from ofa_sr_tpu_torch.utils import metrics as tmetrics

SPACE_KW = dict(ks_list=[3, 5, 7], expand_list=[3, 4, 6], depth_list=[2, 3],
                pixel_d_list=[1, 2], n_stages=2, width=16)
TEACHER_KW = dict(ks_list=[5], expand_list=[3], depth_list=[2], pixel_d_list=[1],
                  n_stages=2, width=16)
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=2e-3, atol=2e-5)
EVAL_TOL = dict(rtol=5e-3, atol=5e-4)
N_STEPS, N_BATCH, BS, HR = 3, 4, 2, 16


def _randomize_bn(tree, rng):
    """Random BN affine params and running stats (mean != 0, var != 1)."""
    if isinstance(tree, list):
        return [_randomize_bn(t, rng) for t in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        n = None if isinstance(v, (dict, list)) else int(np.asarray(v).shape[0])
        if k in ("scale", "var"):
            out[k] = jnp.asarray(rng.uniform(0.5, 1.5, n).astype(np.float32))
        elif (k == "bias" and "scale" in tree) or k == "mean":
            out[k] = jnp.asarray((rng.randn(n) * 0.2).astype(np.float32))
        else:
            out[k] = _randomize_bn(v, rng)
    return out


@pytest.fixture(scope="module")
def jax_twin():
    """JAX net with random BN and transform matrices, its teacher, and one
    batch (numpy-seeded, shared by both packages)."""
    rng = np.random.RandomState(0)
    jnet = JaxS4(jarch.SearchSpace(**SPACE_KW))
    p, s = jnet.init(jax.random.PRNGKey(0))
    p, s = _randomize_bn(p, rng), _randomize_bn(s, rng)
    for bp in p["blocks"]:
        bp["depth_conv"]["kt"] = {
            k: v + jnp.asarray((0.05 * rng.randn(*v.shape)).astype(np.float32))
            for k, v in bp["depth_conv"]["kt"].items()}
    tnet = JaxS4(jarch.SearchSpace(**TEACHER_KW))
    tp, ts = tnet.init(jax.random.PRNGKey(7))
    brng = np.random.RandomState(1)
    batch = {k: brng.rand(BS, HR // f, HR // f, 3).astype(np.float32)
             for k, f in (("image", 1), ("x2", 2), ("x4", 4))}
    return jnet, p, s, (tnet, tp, ts), batch


def _port_net(p, s, space_kw=SPACE_KW):
    net = OFAMobileNetS4(SearchSpace(**space_kw), device="cpu")
    net.load_state_dict(s4_state_dict_from_jax(p, s))
    return net


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _cfgs(step, n_subnets):
    j = [jarch.sample_subnet(jarch.SearchSpace(**SPACE_KW), seed=subnet_seed(0, N_BATCH, step, k))
         for k in range(n_subnets)]
    t = [sample_subnet(SearchSpace(**SPACE_KW), seed=subnet_seed(0, N_BATCH, step, k))
         for k in range(n_subnets)]
    assert [(c.ks, c.e, c.d, c.pixel_d) for c in j] == [(c.ks, c.e, c.d, c.pixel_d) for c in t]
    return j, t


def _assert_state_matches(net, p, s, tol):
    ref = s4_state_dict_from_jax(p, s)
    got = net.state_dict()
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **tol)


def _cfg_with_pixel_d(pd):
    for seed in range(100):
        cfg = jarch.sample_subnet(jarch.SearchSpace(**SPACE_KW), seed=seed)
        if cfg.pixel_d == pd:
            return seed, cfg
    raise AssertionError(pd)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("pixel_d,bn_training", [(1, True), (2, True), (2, False)])
def test_train_forward_matches_jax(jax_twin, pixel_d, bn_training, use_kernels):
    jnet, p, s, _, batch = jax_twin
    seed, cfg = _cfg_with_pixel_d(pixel_d)
    x = batch["x%d" % 2 ** pixel_d]
    y_j, s_j = jnet.apply(p, s, jnp.asarray(x), cfg.to_device(jnet.space), pixel_d=pixel_d,
                          training=True, bn_training=bn_training)
    net = _port_net(p, s)
    net.train()
    y_t = net(torch.from_numpy(x), sample_subnet(net.space, seed=seed), pixel_d,
              bn_training=None if bn_training else False, use_kernels=use_kernels)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    _assert_state_matches(net, p, s_j, TOL)
    if not bn_training:  # frozen BN: the running statistics stay as they were
        _assert_state_matches(net, p, s, dict(rtol=0, atol=0))


@pytest.fixture(scope="module")
def jax_subnet_grad(jax_twin):
    """jit(grad) of the JAX trainer's one-subnet loss, compiled once."""
    jtr = JaxTrainer(jax_twin[0], opt_type="sgd", weight_decay=0.0, remat=False)
    return jax.jit(jax.grad(lambda p, s, b, a: jtr._subnet_loss(p, s, b, a, None), has_aux=True))


@pytest.mark.parametrize("pixel_d", [1, 2])
def test_subnet_gradients_match_jax(jax_twin, jax_subnet_grad, pixel_d):
    jnet, p, s, _, batch = jax_twin
    seed, cfg = _cfg_with_pixel_d(pixel_d)
    grads, _ = jax_subnet_grad(p, s, {k: jnp.asarray(v) for k, v in batch.items()},
                               cfg.to_device(jnet.space))
    ref = s4_state_dict_from_jax(grads, s)
    net = _port_net(p, s)
    tr = SRTrainer(net, opt_type="sgd", weight_decay=0.0)
    loss, _ = tr._subnet_loss(_tbatch(batch), sample_subnet(net.space, seed=seed), None)
    loss.backward()
    n_none = 0
    for name, prm in net.named_parameters():
        if prm.grad is None:  # not executed: JAX's gradient is exactly zero
            n_none += 1
            assert not np.any(ref[name].numpy()), name
        else:
            np.testing.assert_allclose(prm.grad.numpy(), ref[name].numpy(), err_msg=name, **TOL)
    assert n_none > 0


def _run_jax(jax_twin, opt_type, n_subnets, kd_ratio, base_lr):
    jnet, p, s, (tnet, tp, ts), batch = jax_twin
    kw = dict(teacher_net=tnet, kd_ratio=kd_ratio) if kd_ratio else {}
    tr = JaxTrainer(jnet, opt_type=opt_type, weight_decay=3e-5, remat=False, **kw)
    opt_state = tr.init_opt_state(p)
    t_cfg = jarch.uniform_subnet(tnet.space, 5, 3, 2, 1)
    step = tr.make_train_step(n_subnets=n_subnets, donate=False, teacher_params=tp,
                              teacher_state=ts, teacher_arch=t_cfg.to_device(tnet.space),
                              teacher_pixel_d=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics, touched_any = [], None
    for i in range(N_STEPS):
        cfgs, _ = _cfgs(i, n_subnets)
        touched = sr_touched_mask(jnet, p, cfgs)
        touched_any = touched if touched_any is None else jax.tree.map(
            np.logical_or, touched_any, touched)
        lr = jsched.lr_at_step(base_lr, 0, i, N_STEPS, 1)
        p, s, opt_state, m = step(p, s, opt_state, jb, tuple(c.to_device(jnet.space) for c in cfgs),
                                  jnp.asarray(lr, jnp.float32), touched)
        metrics.append({k: float(v) for k, v in m.items()})
    return p, s, metrics, touched, touched_any


def _run_port(jax_twin, opt_type, n_subnets, kd_ratio, base_lr):
    jnet, p, s, (tnet, tp, ts), batch = jax_twin
    net = _port_net(p, s)
    teacher = None
    if kd_ratio:
        t_net = _port_net(tp, ts, TEACHER_KW)
        teacher = (t_net, uniform_subnet(t_net.space, 5, 3, 2, 1), 1)
    tr = SRTrainer(net, opt_type=opt_type, weight_decay=3e-5, kd_ratio=kd_ratio, teacher=teacher)
    tb = _tbatch(batch)
    metrics = []
    for i in range(N_STEPS):
        _, cfgs = _cfgs(i, n_subnets)
        m = tr.train_step(tb, cfgs, tsched.lr_at_step(base_lr, 0, i, N_STEPS, 1))
        metrics.append({k: float(v) for k, v in m.items()})
    return net, tr, metrics


_RUNS = {"sgd1": ("sgd", 1, 0.0, 0.05), "adam1": ("adam", 1, 0.0, 1e-3),
         "adam4kd": ("adam", 4, 1.0, 1e-3)}


@pytest.fixture(scope="module")
def trajectories(jax_twin):
    """Each run of _RUNS through both trainers, once per module."""
    return {name: (_run_jax(jax_twin, *args), _run_port(jax_twin, *args))
            for name, args in _RUNS.items()}


def _touched_by_name(touched, p, s):
    full = jax.tree.map(lambda t, a: np.full(np.shape(a), bool(t)), touched, p)
    return {k: bool(v.numpy().all()) for k, v in s4_state_dict_from_jax(full, s).items()}


def test_sgd_steps_match_jax(jax_twin, trajectories):
    (jp, js, jm, _, _), (net, _, tm) = trajectories["sgd1"]
    np.testing.assert_allclose([m["loss"] for m in tm], [m["loss"] for m in jm], rtol=1e-5)
    _assert_state_matches(net, jp, js, dict(rtol=0, atol=1e-5))


@pytest.mark.parametrize("run", ["adam1", "adam4kd"])
def test_adam_steps_match_jax(jax_twin, trajectories, run):
    jnet, *_ , batch = jax_twin
    (jp, js, jm, _, _), (net, tr, tm) = trajectories[run]
    for key in ("loss", "psnr"):
        np.testing.assert_allclose([m[key] for m in tm], [m[key] for m in jm], **LOSS_TOL)
    cfg = jarch.sample_subnet(jnet.space, seed=999)
    jtr = JaxTrainer(jnet, remat=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_eval = jtr.make_eval_step()(jp, js, jb, cfg.to_device(jnet.space))
    t_eval = tr.eval_step(_tbatch(batch), sample_subnet(net.space, seed=999))
    np.testing.assert_allclose(t_eval["output"].numpy(), np.asarray(j_eval["output"]), **EVAL_TOL)
    np.testing.assert_allclose(float(t_eval["psnr"]), float(j_eval["psnr"]), **LOSS_TOL)


@pytest.mark.parametrize("run", ["sgd1", "adam4kd"])
def test_untouched_params_have_no_grad_and_no_state(jax_twin, trajectories, run):
    """torch's native skip (grad None) reproduces TorchOpt + sr_touched_mask:
    a parameter has a grad after the last step exactly where that step's
    touched mask is set, and optimizer state exactly where any step's is."""
    _, p, s, _, _ = jax_twin
    (_, _, _, touched, touched_any), (net, tr, _) = trajectories[run]
    last, ever = _touched_by_name(touched, p, s), _touched_by_name(touched_any, p, s)
    assert not all(last.values())
    for name, prm in net.named_parameters():
        assert (prm.grad is not None) == last[name], name
        assert bool(tr.opt.state.get(prm)) == ever[name], name


def test_psnr_y_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.rand(2, 9, 11, 3).astype(np.float32) * 1.2 - 0.1
    b = np.clip(a + rng.randn(*a.shape).astype(np.float32) * 0.05, 0, 1)
    got = tmetrics.psnr_y_device(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(float(got), float(jmetrics.psnr_y_device(a, b)), rtol=1e-6)
    mask = np.zeros((1, 9, 11, 1), np.float32)
    mask[:, :6, :7] = 1
    got = tmetrics.psnr_y_device(torch.from_numpy(a), torch.from_numpy(b),
                                 valid_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(jmetrics.psnr_y_device(a, b, valid_mask=mask)),
                               rtol=1e-6)
    assert float(tmetrics.psnr_y_device(torch.from_numpy(a), torch.from_numpy(a))) == np.inf
    # round half to even, as jnp.round
    halves = np.array([0.5, 1.5, 2.5, -0.5], np.float32) / 255.0
    np.testing.assert_array_equal(tmetrics.quantize_img(torch.from_numpy(halves)).numpy(),
                                  np.asarray(jmetrics.quantize_img(halves)))


def test_schedules_match_jax():
    for kw in (dict(), dict(warmup_epochs=2, warmup_lr=1e-4), dict(lr_schedule_type=None)):
        for epoch in range(4):
            for batch in (0, 3, 9):
                assert (tsched.lr_at_step(1e-3, epoch, batch, 10, 5, **kw)
                        == jsched.lr_at_step(1e-3, epoch, batch, 10, 5, **kw))


def test_no_decay_groups_match_jax(jax_twin):
    _, p, s, _, _ = jax_twin
    decayed = _touched_by_name(joptim.no_decay_mask(p), p, s)
    net = _port_net(p, s)
    groups = param_groups(net, 3e-5)
    names = {id(prm): n for n, prm in net.named_parameters()}
    assert groups[0]["weight_decay"] == 3e-5 and groups[1]["weight_decay"] == 0.0
    for group, want in ((groups[0], True), (groups[1], False)):
        for prm in group["params"]:
            assert decayed[names[id(prm)]] == want, names[id(prm)]
    assert any(n.endswith("_matrix") for n in (names[id(q)] for q in groups[0]["params"]))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_train_mode_bn_routing(use_kernels, monkeypatch):
    """With kernels on, every train-mode BN goes through bn_train_fused, the
    C=3 output BN included: 3*sum(d) + pixel_d + 4 calls a subnet."""
    calls = []
    real = tnorm.bn_train_fused

    def counting(x, *a, **k):
        calls.append(x.shape[-1])
        return real(x, *a, **k)

    monkeypatch.setattr(tnorm, "bn_train_fused", counting)
    net = OFAMobileNetS4(SearchSpace(**SPACE_KW), device="cpu")
    cfg = sample_subnet(net.space, seed=3)
    x = torch.rand(1, 6, 6, 3)
    net(x, cfg, cfg.pixel_d, bn_training=True, use_kernels=use_kernels).sum().backward()
    expect = 3 * sum(cfg.d) + cfg.pixel_d + 4 if use_kernels else 0
    assert len(calls) == expect
    if use_kernels:
        assert 3 in calls and 16 in calls


def test_entry_train_on_cpu():
    space = SearchSpace(**SPACE_KW)
    out = {}
    for uk in (False, True):
        net = OFAMobileNetS4(space, device="cpu")
        out[uk] = tentry.train(2, n_subnets=2, kd_ratio=1.0, device="cpu", net=net,
                               batch_size=2, hr_size=16, use_kernels=uk)
        assert len(out[uk]) == 2 and all(np.isfinite(m["loss"]) for m in out[uk])
    # the fused BN (over the plain sums here) and the plain branch agree
    np.testing.assert_allclose([m["loss"] for m in out[True]], [m["loss"] for m in out[False]],
                               rtol=1e-5)
    # the step's subnets follow the seed contract
    assert tentry.step_subnets(space, 1, 2)[1] == sample_subnet(space, seed=subnet_seed(0, 50, 1, 1))
