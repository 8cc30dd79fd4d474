"""The window step under a mesh (`SRTrainer` / `ClsTrainer
.make_scan_train_step` with a process group, and `SRRunManager` /
`ClsRunManager` at `steps_per_dispatch` > 1 with a mesh) against the JAX
package on the CPU, which runs the same global batch in one process.

Two ranks run as two processes over gloo on 127.0.0.1 (`rank_launch.py`,
torchrun's environment), one torch thread each, in one launch whose
results feed the module's fixtures; the run is bounded in time, so a hang
fails. Each rank takes half the rows of every batch; the JAX references
see the whole batches. On the CPU the window step runs its parts eagerly,
with the same collectives the card's graphs capture (`chip_smoke.py`
phase 8 runs those over NCCL).

Nets: the SR windows run tests/test_torch_scan_trainer.py's small space
(width 8, one stage) from the port's seeded init with random BN statistics
and transform matrices, imported into JAX (`_twin`); the classification
window runs tests/test_torch_cls_train.py's narrow net from the JAX init
with random BN (`jax_narrow`), dropout 0.

Tolerances (float32):
- BN with the group and an active width (0, 10 and all 24 of 24 columns),
  the wrappers and train-mode BN's plain and kernel branches with
  autograd, against JAX's masked `batch_norm` and its VJP over the global
  rows: y, running statistics, dx, and dscale, dbias summed over the ranks
  rtol and atol 1e-5 (tests/test_torch_parallel.py's: sums over the
  global rows in another order); the columns past the width exactly 0 (y,
  dx, dscale, dbias) or unchanged (running statistics);
- the windows (3 steps of one subnet) against JAX `make_scan_train_step`
  on the global batches, with JAX's touched masks: the window's mean loss
  within 1e-5 and mean PSNR-Y rtol 2e-3 (tests/test_torch_scan_trainer.py's
  and test_torch_parallel.py's), parameters and running statistics at
  tests/test_torch_scan_trainer.py's step bounds (rtol 1e-4, atol 1e-5;
  Adam atol 2e-5, its touched case's);
- the two ranks' parameters, running statistics and metrics equal bit for
  bit;
- the run managers at steps_per_dispatch 3 (a window of 3 and a tail of
  2) against 1 over two ranks: parameters and running statistics rtol
  1e-4, atol 1e-5, the epoch's loss and metric rtol 1e-5 (the one-process
  tests' bounds), rank 0's log lines those of the one-process window.
"""

import concurrent.futures
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.models import ofa_cls as jcls
from ofa_sr_tpu.ops import norm as jnorm
from ofa_sr_tpu.train import SRTrainer as JaxTrainer
from ofa_sr_tpu.train import cls_trainer as jtr
from ofa_sr_tpu.train.touched import cls_touched_mask as jax_cls_touched
from ofa_sr_tpu.train.touched import sr_touched_mask as jax_sr_touched
from ofa_sr_tpu_torch.models import SearchSpace, sample_subnet
from ofa_sr_tpu_torch.train.checkpoint import (
    mbv3_state_dict_from_jax,
    s4_state_dict_from_jax,
    x4_state_dict_from_jax,
)
from rank_launch import launch
from test_torch_cls_train import batch, jax_narrow, port_narrow
from test_torch_scan_trainer import SMALL_KW, TEACHER_KW, _jcfg, _port_net, _twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
BN_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
ADAM_STEP_TOL = dict(rtol=1e-4, atol=2e-5)
PSNR_RTOL = 2e-3
EPOCH_RTOL = 1e-5
BS, HR, N_STEPS = 4, 16, 3       # global batch, HR size, steps a window
BN_C, BN_ACTIVE = 24, (0, 10, 24)
CLS_LR = 1e-2
# name: (net, mode, optimizer, KD ratio, lr, clip_grad_norm)
# (each JAX window costs ~5-16 s of tracing and compiling here, so the S4
# takes SGD and Adam, plain and KD, and the X4 autoencoder all at once)
SR_CASES = {"s4 sgd kd": ("s4", "sr", "sgd", 1.0, 1e-2, None),
            "s4 adam": ("s4", "sr", "adam", 0.0, 1e-3, None),
            "x4 autoencoder adam kd clip": ("x4", "autoencoder", "adam", 1.0, 1e-3, 0.05)}

# each rank: torchrun's environment (set by `launch`) joins the gloo group;
# argv[1] is the directory the parent and the ranks share
BODY = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from ofa_sr_tpu_torch.data import SyntheticClsProvider, SyntheticSRProvider
from ofa_sr_tpu_torch.ops.kernels import bn_stats
from ofa_sr_tpu_torch.ops.norm import batch_norm_train
from ofa_sr_tpu_torch.parallel import init_distributed, make_mesh, shard_batch
from ofa_sr_tpu_torch.train import (ClsRunManager, ClsTrainer, RunConfig, SRRunManager,
                                    SRTrainer)
rank, world = init_distributed(device="cpu", timeout_s=120)
mesh = make_mesh("cpu")
d = sys.argv[1]
spec = json.load(open(os.path.join(d, "spec.json")))
load = lambda name: torch.load(os.path.join(d, name), weights_only=False)
res = {}

# BN with the group and the active width
z = dict(np.load(os.path.join(d, "bn_in.npz")))
t = {k: torch.from_numpy(v) for k, v in shard_batch({k: z[k] for k in ("x", "dy")},
                                                     mesh).items()}
p = {k: torch.from_numpy(z[k]) for k in ("scale", "bias", "mean", "var")}
kw = dict(momentum=0.1, eps=1e-5)
bn = {}
for m in spec["bn_active"]:
    act = torch.tensor(m, dtype=torch.int32)
    rm, rv = p["mean"].clone(), p["var"].clone()
    y, mean, var, inv = bn_stats.bn_forward(t["x"], p["scale"], p["bias"], rm, rv,
                                            group=mesh.group, active=act, **kw)
    dx, ds, db = bn_stats.bn_backward(t["dy"], t["x"], p["scale"], mean, inv,
                                      group=mesh.group, active=act)
    bn["wrappers_%d" % m] = dict(y=y, rm=rm, rv=rv, dx=dx, ds=ds, db=db)
    for uk in (False, True):
        x = t["x"].clone().requires_grad_()
        s, b = p["scale"].clone().requires_grad_(), p["bias"].clone().requires_grad_()
        rm, rv = p["mean"].clone(), p["var"].clone()
        y = batch_norm_train(x, s, b, rm, rv, use_kernels=uk, group=mesh.group, active=act,
                             **kw)
        y.backward(t["dy"])
        bn["%s_%d" % ("kernels" if uk else "plain", m)] = dict(
            y=y.detach(), rm=rm, rv=rv, dx=x.grad, ds=s.grad, db=b.grad)
np.savez(os.path.join(d, "bn_out_%d.npz" % rank),
         **{"%s/%s" % (r, k): v.numpy() for r, o in bn.items() for k, v in o.items()})

# the SR windows
batches = dict(np.load(os.path.join(d, "sr_batches.npz")))
for name, (kind, mode, opt, kd, lr, clip) in spec["sr_cases"].items():
    net = load("%s.pt" % kind)
    teacher = (load("teacher.pt"), load("teacher_cfg.pt"), 1) if kd else None
    tr = SRTrainer(net, opt_type=opt, weight_decay=3e-5, kd_ratio=kd, teacher=teacher,
                   mode=mode, clip_grad_norm=clip, mesh=mesh)
    rows = [shard_batch({k: torch.from_numpy(v[i]) for k, v in batches.items()}, mesh)
            for i in range(spec["n_steps"])]
    cfgs = load("%s_cfgs.pt" % kind)
    m = tr.make_scan_train_step(1)(rows, [[c] for c in cfgs], [lr] * len(cfgs))
    res[name] = {k: v.tolist() for k, v in m.items()}
    torch.save(net.state_dict(), os.path.join(d, "%s_%d.pt" % (name, rank)))

# the classification window
cls_b = dict(np.load(os.path.join(d, "cls_batches.npz")))
net = load("cls.pt")
tr = ClsTrainer(net, opt_type="sgd", weight_decay=3e-5, mesh=mesh)
rows = [shard_batch({k: torch.from_numpy(v[i]) for k, v in cls_b.items()}, mesh)
        for i in range(spec["n_steps"])]
archs = load("cls_archs.pt")
m = tr.make_scan_train_step(1)(rows, [[a] for a in archs], [spec["cls_lr"]] * len(archs))
res["cls"] = {k: v.tolist() for k, v in m.items()}
torch.save(net.state_dict(), os.path.join(d, "cls_%d.pt" % rank))

# the run managers at steps_per_dispatch 3 and 1 (5 steps of 2 subnets)
for spd in (1, 3):
    rm = SRRunManager(os.path.join(d, "sr_rm%d" % spd), load("rm_s4.pt"), RunConfig(
        n_epochs=1, base_lr=1e-2, opt_type="sgd", weight_decay=3e-5, print_frequency=2,
        dynamic_batch_size=2, image_size=spec["hr"], train_batch_size=spec["bs"],
        steps_per_dispatch=spd, manual_seed=0),
        SyntheticSRProvider(n_train=5 * spec["bs"], n_valid=2, hr_size=spec["hr"],
                            train_batch_size=spec["bs"]), mesh=mesh)
    res["sr_rm%d" % spd] = rm.train_one_epoch(0)
    torch.save(rm.net.state_dict(), os.path.join(d, "sr_rm%d_%d.pt" % (spd, rank)))
    rm = ClsRunManager(os.path.join(d, "cls_rm%d" % spd), load("cls.pt"), RunConfig(
        n_epochs=1, base_lr=0.05, warmup_epochs=0, opt_type="sgd", weight_decay=3e-5,
        train_batch_size=8, dynamic_batch_size=2, print_frequency=2, manual_seed=0,
        steps_per_dispatch=spd),
        SyntheticClsProvider(n_train=40, n_test=8, image_size=32, n_classes=10,
                             train_batch_size=8, test_batch_size=8), mesh=mesh)
    res["cls_rm%d" % spd] = rm.train_one_epoch(0)
    torch.save(rm.net.state_dict(), os.path.join(d, "cls_rm%d_%d.pt" % (spd, rank)))
json.dump(res, open(os.path.join(d, "res_%d.json" % rank), "w"))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift).astype(np.float32)


def _bn_inputs():
    c, shape = BN_C, (WORLD * 2, 5, 6, BN_C)
    return {"x": _rand(shape, 1, scale=2.0, shift=-0.5), "dy": _rand(shape, 2),
            "scale": _rand((c,), 4, scale=0.3, shift=1.0), "bias": _rand((c,), 5, scale=0.2),
            "mean": _rand((c,), 6, scale=0.2), "var": np.abs(_rand((c,), 7)) + 0.5}


def _sr_twins():
    """kind -> (JAX net, params, state, the port net), the S4 teacher, and
    each kind's 3 subnets (both pixel_d among them)."""
    out = {}
    for kind in ("s4", "x4"):
        jnet, p, s = _twin(kind, SMALL_KW)
        out[kind] = (jnet, p, s, _port_net(kind, p, s, SMALL_KW))
    tnet, tp, ts = _twin("s4", TEACHER_KW, seed=7)
    teacher = (tnet, tp, ts, _port_net("s4", tp, ts, TEACHER_KW),
               sample_subnet(SearchSpace(**TEACHER_KW), seed=0))
    space = SearchSpace(**SMALL_KW)
    cfgs = {kind: [sample_subnet(space, seed=i, n_trunks=n) for i in range(N_STEPS)]
            for kind, n in (("s4", 1), ("x4", 2))}
    return out, teacher, cfgs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The twins, the inputs, one two-rank run of BODY and the JAX windows,
    all started in the background (JAX compiles in threads, as the ranks
    run), each a future."""
    d = tmp_path_factory.mktemp("mesh_scan")
    twins, teacher, cfgs = _sr_twins()
    for kind, tw in twins.items():
        torch.save(tw[3], d / ("%s.pt" % kind))
        torch.save(cfgs[kind], d / ("%s_cfgs.pt" % kind))
    torch.save(teacher[3], d / "teacher.pt")
    torch.save(teacher[4], d / "teacher_cfg.pt")
    rm_net = _port_net("s4", *_twin("s4", SMALL_KW, seed=3)[1:], SMALL_KW)
    torch.save(rm_net, d / "rm_s4.pt")
    rng = np.random.RandomState(11)
    sr_batches = {k: rng.rand(N_STEPS, BS, HR // f, HR // f, 3).astype(np.float32)
                  for k, f in (("image", 1), ("x2", 2), ("x4", 4))}
    np.savez(d / "sr_batches.npz", **sr_batches)
    cls = jax_narrow()
    cls_net = port_narrow(cls[1], cls[2])
    cls_archs = [cls_net.sample_arch(seed=i) for i in range(N_STEPS)]
    torch.save(cls_net, d / "cls.pt")
    torch.save(cls_archs, d / "cls_archs.pt")
    cls_batches = [batch(30 + i) for i in range(N_STEPS)]
    np.savez(d / "cls_batches.npz", **{k: np.stack([b[k] for b in cls_batches])
                                       for k in cls_batches[0]})
    bn_in = _bn_inputs()
    np.savez(d / "bn_in.npz", **bn_in)
    with open(d / "spec.json", "w") as f:
        json.dump({"bn_active": list(BN_ACTIVE), "sr_cases": SR_CASES, "n_steps": N_STEPS,
                   "cls_lr": CLS_LR, "bs": BS, "hr": HR}, f)
    script = d / "rank.py"
    script.write_text(BODY)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    out = dict(d=d, twins=twins, teacher=teacher, cfgs=cfgs, sr_batches=sr_batches, cls=cls,
               cls_archs=cls_archs, cls_batches=cls_batches, bn_in=bn_in)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        out["future"] = pool.submit(launch, [sys.executable, str(script), str(d)], WORLD,
                                    timeout=240, env=env, cwd=REPO)
        out["jax"] = {name: pool.submit(_jax_sr_window, out, name) for name in SR_CASES}
        out["jax"]["cls"] = pool.submit(_jax_cls_window, out)
        yield out


def _ranks(setup):
    """The ranks' results, once their run has ended (its error, if it
    failed)."""
    setup["future"].result()
    d = setup["d"]
    return [json.load(open(d / ("res_%d.json" % r))) for r in range(WORLD)]


def _states(setup, name):
    return [torch.load(setup["d"] / ("%s_%d.pt" % (name, r))) for r in range(WORLD)]


def _assert_state(got, ref, tol):
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **tol)


# -- BN with the group and the active width ---------------------------------------

@pytest.mark.parametrize("route", ["wrappers", "plain", "kernels"])
@pytest.mark.parametrize("active", BN_ACTIVE)
def test_masked_bn_over_two_ranks_matches_jax_global_batch(setup, route, active):
    """`bn_forward` / `bn_backward` with the group and the active width
    ("wrappers"), and train-mode BN through autograd on the plain and the
    kernel branch, each rank on half the rows, against JAX's masked
    `batch_norm` and its VJP over all of them: y and dx (the ranks' rows in
    order), the running statistics, dscale and dbias summed over the ranks;
    0 (or unchanged) past the width."""
    z = setup["bn_in"]
    _ranks(setup)
    outs = [np.load(setup["d"] / ("bn_out_%d.npz" % r)) for r in range(WORLD)]
    got = {k: [o["%s_%d/%s" % (route, active, k)] for o in outs]
           for k in ("y", "rm", "rv", "dx", "ds", "db")}
    mask = (np.arange(BN_C) < active).astype(np.float32)

    def f(x, sc, b):
        return jnorm.batch_norm(x, {"scale": sc, "bias": b},
                                {"mean": jnp.asarray(z["mean"]), "var": jnp.asarray(z["var"])},
                                training=True, momentum=0.1, eps=1e-5, mask=jnp.asarray(mask))

    (jy, js), vjp = jax.vjp(f, *(jnp.asarray(z[k]) for k in ("x", "scale", "bias")))
    jdx, jds, jdb = vjp((jnp.asarray(z["dy"]), jax.tree.map(jnp.zeros_like, js)))
    for k in ("rm", "rv"):
        np.testing.assert_array_equal(got[k][0], got[k][1])
    y, dx = np.concatenate(got["y"]), np.concatenate(got["dx"])
    np.testing.assert_allclose(y, np.asarray(jy), **BN_TOL)
    np.testing.assert_allclose(dx, np.asarray(jdx), **BN_TOL)
    np.testing.assert_allclose(got["rm"][0], np.asarray(js["mean"]), **BN_TOL)
    np.testing.assert_allclose(got["rv"][0], np.asarray(js["var"]), **BN_TOL)
    np.testing.assert_allclose(sum(got["ds"]), np.asarray(jds), **BN_TOL)
    np.testing.assert_allclose(sum(got["db"]), np.asarray(jdb), **BN_TOL)
    assert not y[..., active:].any() and not dx[..., active:].any()
    assert not any(a[active:].any() for a in got["ds"] + got["db"])
    np.testing.assert_array_equal(got["rm"][0][active:], z["mean"][active:])
    np.testing.assert_array_equal(got["rv"][0][active:], z["var"][active:])


# -- the windows -------------------------------------------------------------------

def _jax_sr_window(setup, name):
    kind, mode, opt, kd, lr, clip = SR_CASES[name]
    jnet, p, s, _ = setup["twins"][kind]
    cfgs = [_jcfg(c) for c in setup["cfgs"][kind]]
    t_kw, tr_kw = {}, {}
    if kd:
        tnet, tp, ts, _, t_cfg = setup["teacher"]
        tr_kw = dict(teacher_net=tnet)
        t_kw = dict(teacher_params=tp, teacher_state=ts,
                    teacher_arch=_jcfg(t_cfg).to_device(tnet.space), teacher_pixel_d=1)
    tr = JaxTrainer(jnet, opt_type=opt, weight_decay=3e-5, kd_ratio=kd, mode=mode,
                    clip_grad_norm=clip, remat=False, **tr_kw)
    scan = tr.make_scan_train_step(n_subnets=1, donate=False, **t_kw)
    archs = (jax.tree.map(lambda *a: jnp.stack(a), *[c.to_device(jnet.space) for c in cfgs]),)
    touched = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                           *[jax_sr_touched(jnet, p, [c], mode) for c in cfgs])
    p1, s1, _, m = scan(p, s, tr.init_opt_state(p),
                        {k: jnp.asarray(v) for k, v in setup["sr_batches"].items()}, archs,
                        jnp.full((N_STEPS,), lr, jnp.float32), touched)
    bridge = x4_state_dict_from_jax if kind == "x4" else s4_state_dict_from_jax
    return bridge(p1, s1), float(m["loss"]), float(m["psnr"])


def _jax_cls_window(setup):
    jnet, p, s = setup["cls"]
    archs = [jcls.ClsArch(ks=a.ks, e=a.e, d=a.d, wid=a.wid) for a in setup["cls_archs"]]
    tr = jtr.ClsTrainer(jnet, opt_type="sgd", weight_decay=3e-5, remat=False)
    scan = tr.make_scan_train_step(n_subnets=1)
    b = setup["cls_batches"]
    stacked = {k: jnp.stack([jnp.asarray(x[k]) for x in b]) for k in b[0]}
    dev = [jnet.arch_to_device(a) for a in archs]
    touched = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                           *[jax_cls_touched(jnet, p, [a]) for a in archs])
    rngs = jnp.stack([jax.random.PRNGKey(100 + i) for i in range(N_STEPS)])
    p1, s1, _, m = scan(p, s, tr.init_opt_state(p), stacked,
                        (jax.tree.map(lambda *xs: jnp.stack(xs), *dev),),
                        jnp.full((N_STEPS,), CLS_LR, jnp.float32), rngs, touched)
    return mbv3_state_dict_from_jax(p1, s1), {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("name", list(SR_CASES))
def test_sr_window_over_two_ranks_matches_jax_global_batch(setup, name):
    """The S4 and the X4 autoencoder window (3 steps; SGD and Adam, plain
    and KD, the X4 with gradient clipping), each rank on half the rows of every
    batch, against JAX `make_scan_train_step` on the global batches: the
    window's mean loss and PSNR-Y (the global batch's, the same on both
    ranks) and the parameters and running statistics after it."""
    ref, loss_j, psnr_j = setup["jax"][name].result()
    ranks = _ranks(setup)
    assert ranks[0][name] == ranks[1][name]
    assert abs(ranks[0][name]["loss"] - loss_j) < 1e-5
    np.testing.assert_allclose(ranks[0][name]["psnr"], psnr_j, rtol=PSNR_RTOL)
    _assert_state(_states(setup, name)[0], ref,
                  ADAM_STEP_TOL if SR_CASES[name][2] == "adam" else STEP_TOL)


def test_cls_window_over_two_ranks_matches_jax_global_batch(setup):
    """The narrow classification net's window (3 SGD steps of one subnet,
    label smoothing 0.1), each rank on half the rows, against JAX
    `ClsTrainer.make_scan_train_step` on the global batches with JAX's
    touched masks: the window's mean loss, top-1 and top-5 (the global
    batch's), the parameters and running statistics."""
    ref, m = setup["jax"]["cls"].result()
    ranks = _ranks(setup)
    got = ranks[0]["cls"]
    assert got == ranks[1]["cls"]
    assert abs(got["loss"] - m["loss"]) < 1e-5
    for k in ("top1", "top5"):
        np.testing.assert_allclose(got[k], m[k], rtol=1e-5)
    _assert_state(_states(setup, "cls")[0], ref, STEP_TOL)


@pytest.mark.parametrize("name", list(SR_CASES) + ["cls", "sr_rm1", "sr_rm3", "cls_rm1",
                                                    "cls_rm3"])
def test_ranks_end_bit_equal(setup, name):
    """Every rank ends each window and run-manager epoch with the same
    parameters and running statistics, bit for bit."""
    a, b = _states(setup, name)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", ["sr", "cls"])
def test_run_manager_steps_per_dispatch_over_two_ranks(setup, kind):
    """SRRunManager and ClsRunManager over two ranks, an epoch of 5 steps
    of 2 subnets at steps_per_dispatch 3 (a window of 3 and a tail of 2)
    against the same epoch at 1: the epoch's metrics (the global batch's,
    the same on both ranks), the parameters and running statistics; rank 0
    alone writes the logs, their lines the one-process window's (after
    steps 3 and 5 at 3; 2, 4 and 5 at 1)."""
    ranks = _ranks(setup)
    for spd in (1, 3):
        assert ranks[0]["%s_rm%d" % (kind, spd)] == ranks[1]["%s_rm%d" % (kind, spd)]
    np.testing.assert_allclose(ranks[0]["%s_rm3" % kind], ranks[0]["%s_rm1" % kind],
                               rtol=EPOCH_RTOL)
    _assert_state(_states(setup, "%s_rm3" % kind)[0], _states(setup, "%s_rm1" % kind)[0],
                  STEP_TOL)
    for spd, want in ((1, ["2", "4", "5"]), (3, ["3", "5"])):
        with open(setup["d"] / ("%s_rm%d" % (kind, spd)) / "logs" / "train_console.txt") as f:
            lines = [ln for ln in f if ln.startswith("Train")]
        assert [ln.split("]")[1].split("/")[0].lstrip("[") for ln in lines] == want
