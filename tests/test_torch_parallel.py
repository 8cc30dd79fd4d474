"""The port's data parallelism (ofa_sr_tpu_torch/parallel/mesh.py, the BN
wrappers' `group`, SRTrainer, SRRunManager and bn_recalibrate under a mesh)
against the JAX package on the CPU, which runs the same global batch in one
process.

Two ranks run as two processes over gloo on 127.0.0.1
(`rank_launch.py`, torchrun's environment), one torch thread each, every
run bounded in time so that a hang fails; each rank takes half the rows of
the global batch, and the JAX references see the whole batch. Small search
space (width 8, one stage), weights from the JAX twin through the bridge.

Tolerances (float32): BN y, mean, var, running statistics, dx, dscale and
dbias 1e-5 (rtol and atol: sums over the global rows in another order), the
bf16 forms at tests/test_torch_bn.py's bounds (y and dx within one bf16 ulp);
SRTrainer over 2 ranks x half the batch: SGD losses rtol 1e-5 and
parameters atol 1e-5, Adam losses and PSNR rtol 2e-3 (as
tests/test_torch_train.py holds one process), the two ranks' parameters
equal bit for bit; SRRunManager's per-epoch train loss, PSNR and valid PSNR
rtol 2e-3 (tests/test_torch_run_manager.py's), bn_recalibrate 1e-5.
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

from ofa_sr_tpu.data import SyntheticSRProvider as JaxProvider
from ofa_sr_tpu.models import OFAMobileNetS4 as JaxS4
from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu.ops import norm as jnorm
from ofa_sr_tpu.ops.pallas import bn as jbn
from ofa_sr_tpu.train import RunConfig as JaxRunConfig
from ofa_sr_tpu.train import SRRunManager as JaxRunManager
from ofa_sr_tpu.train import SRTrainer as JaxTrainer
from ofa_sr_tpu.train import bn_recalibrate as jax_bn_recalibrate
from ofa_sr_tpu.train import schedules as jsched
from ofa_sr_tpu.train.touched import sr_touched_mask
from ofa_sr_tpu_torch.models import subnet_seed
from ofa_sr_tpu_torch.parallel import Mesh, init_distributed, make_mesh, shard_batch, shard_params
from ofa_sr_tpu_torch.train.checkpoint import s4_state_dict_from_jax
from rank_launch import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ULP_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
LOSS_TOL = dict(rtol=2e-3, atol=2e-5)
EPOCH_TOL = dict(rtol=2e-3, atol=1e-6)
SPACE_KW = dict(ks_list=[3, 5], expand_list=[2, 3], depth_list=[1, 2], pixel_d_list=[1, 2],
                n_stages=1, width=8)
TEACHER_KW = dict(ks_list=[3], expand_list=[2], depth_list=[1], pixel_d_list=[1], n_stages=1,
                  width=8)
N_BATCH, BS, HR = 4, 4, 16       # step seeds' batch count, global batch, HR size
WORLD = 2

# each rank's preamble: torchrun's environment (set by `launch`) joins the
# gloo group; argv[1] is the directory the parent and the ranks share
PREAMBLE = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from ofa_sr_tpu_torch.parallel import init_distributed, make_mesh, shard_batch
rank, world = init_distributed(device="cpu", timeout_s=120)
mesh = make_mesh("cpu")
d = sys.argv[1]
"""


def _run_ranks(tmp_path, body, timeout=240):
    """Run PREAMBLE + body as WORLD ranks; returns their outputs."""
    script = tmp_path / "rank.py"
    script.write_text(PREAMBLE + body)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return launch([sys.executable, str(script), str(tmp_path)], WORLD, timeout=timeout,
                  env=env, cwd=REPO)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift).astype(np.float32)


# -- mesh helpers, one process -------------------------------------------------

def test_mesh_helpers_in_one_process():
    """Without a process group: init_distributed is a no-op (no torchrun
    environment), make_mesh is a world of one, shard_params leaves the
    module, and shard_batch takes rank r's rows of a given world."""
    env = {k: os.environ.pop(k) for k in ("WORLD_SIZE", "RANK") if k in os.environ}
    try:
        assert init_distributed(device="cpu") == (0, 1)
    finally:
        os.environ.update(env)
    mesh = make_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.world) == (None, 0, 1)
    lin = torch.nn.Linear(2, 3)
    before = {k: v.clone() for k, v in lin.state_dict().items()}
    assert shard_params(lin, mesh) is lin
    assert all(torch.equal(before[k], v) for k, v in lin.state_dict().items())
    batch = {"image": np.arange(24).reshape(6, 4), "x2": torch.arange(12).reshape(6, 2)}
    for r in range(3):
        part = shard_batch(batch, Mesh(None, r, 3, torch.device("cpu")))
        np.testing.assert_array_equal(part["image"], batch["image"][2 * r:2 * r + 2])
        assert torch.equal(part["x2"], batch["x2"][2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="split"):
        shard_batch(batch, Mesh(None, 0, 4, torch.device("cpu")))
    with pytest.raises(ValueError, match="together"):
        init_distributed("127.0.0.1:1", 2)


def test_launch_bounds_time_and_reports_failures(tmp_path):
    """A rank that fails ends the run at once and one that hangs at the
    deadline; the error carries every rank's output, and no rank is left
    running."""
    script = tmp_path / "s.py"
    script.write_text("import os, sys, time\nr = int(os.environ['RANK'])\n"
                      "print('rank', r, os.environ['WORLD_SIZE'], os.environ['LOCAL_RANK'])\n"
                      "sys.exit(3) if r == 1 and sys.argv[1] == 'fail' else None\n"
                      "time.sleep(60 if sys.argv[1] != 'ok' else 0)\n")
    outs = launch([sys.executable, str(script), "ok"], 2, timeout=60)
    assert [o.split() for o in outs] == [["rank", "0", "2", "0"], ["rank", "1", "2", "1"]]
    with pytest.raises(RuntimeError, match="a rank failed") as e:
        launch([sys.executable, str(script), "fail"], 2, timeout=60)
    assert "--- rank 1 ---" in str(e.value)
    with pytest.raises(RuntimeError, match="timed out"):
        launch([sys.executable, str(script), "hang"], 2, timeout=2)


# -- SRTrainer over two ranks ----------------------------------------------------

# name: (optimizer, subnets a step, KD ratio, base lr, steps)
RUNS = {"sgd": ("sgd", 1, 0.0, 0.05, 3), "adam": ("adam", 1, 0.0, 1e-3, 3),
        "kd2": ("sgd", 2, 1.0, 0.05, 1)}

TRAIN_BODY = r"""
from ofa_sr_tpu_torch.models import OFAMobileNetS4, SearchSpace, sample_subnet, subnet_seed
from ofa_sr_tpu_torch.models.arch import uniform_subnet
from ofa_sr_tpu_torch.train import SRTrainer, schedules
spec = json.load(open(os.path.join(d, "train_spec.json")))
batch = {k: torch.from_numpy(v) for k, v in shard_batch(dict(np.load(os.path.join(d, "batch.npz"))),
                                                         mesh).items()}
space = SearchSpace(**spec["space"])
res = {}
for name, (opt, n_sub, kd, base_lr, steps) in spec["runs"].items():
    net = OFAMobileNetS4(space, device="cpu")
    net.load_state_dict(torch.load(os.path.join(d, "student.pt")))
    teacher = None
    if kd:
        t_net = OFAMobileNetS4(SearchSpace(**spec["teacher_space"]), device="cpu")
        t_net.load_state_dict(torch.load(os.path.join(d, "teacher.pt")))
        teacher = (t_net, uniform_subnet(t_net.space, 3, 2, 1, 1), 1)
    tr = SRTrainer(net, opt_type=opt, weight_decay=3e-5, kd_ratio=kd, teacher=teacher, mesh=mesh)
    metrics = []
    for i in range(steps):
        cfgs = [sample_subnet(space, seed=subnet_seed(0, spec["n_batch"], i, k))
                for k in range(n_sub)]
        m = tr.train_step(batch, cfgs, schedules.lr_at_step(base_lr, 0, i, steps, 1))
        metrics.append({k: float(v) for k, v in m.items()})
    res[name] = metrics
    torch.save(net.state_dict(), os.path.join(d, "%s_%d.pt" % (name, rank)))
json.dump(res, open(os.path.join(d, "train_%d.json" % rank), "w"))
"""


def _jax_space(kw=SPACE_KW):
    return jarch.SearchSpace(**kw)


@pytest.fixture(scope="module")
def twin():
    """The JAX student and teacher, and the global batch."""
    jnet = JaxS4(_jax_space())
    p, s = jnet.init(jax.random.PRNGKey(0))
    tnet = JaxS4(_jax_space(TEACHER_KW))
    tp, ts = tnet.init(jax.random.PRNGKey(7))
    rng = np.random.RandomState(1)
    batch = {k: rng.rand(BS, HR // f, HR // f, 3).astype(np.float32)
             for k, f in (("image", 1), ("x2", 2), ("x4", 4))}
    return (jnet, p, s), (tnet, tp, ts), batch


@pytest.fixture(scope="module")
def rank_run(twin, tmp_path_factory):
    """One two-rank run of the BN, trainer and run-manager bodies, started
    in the background so that the JAX references compute meanwhile; a
    future of the directory holding the ranks' results."""
    d = tmp_path_factory.mktemp("ranks")
    (jnet, p, s), (tnet, tp, ts), batch = twin
    _bn_inputs(d)
    torch.save(s4_state_dict_from_jax(p, s), d / "student.pt")
    torch.save(s4_state_dict_from_jax(tp, ts), d / "teacher.pt")
    np.savez(d / "batch.npz", **batch)
    with open(d / "train_spec.json", "w") as f:
        json.dump({"space": SPACE_KW, "teacher_space": TEACHER_KW, "runs": RUNS,
                   "n_batch": N_BATCH}, f)
    with open(d / "rm_spec.json", "w") as f:
        json.dump({"space": SPACE_KW, "rm": RM_KW, "provider": PROVIDER_KW}, f)
    np.save(d / "calib.npy", np.random.RandomState(3).rand(2, 4, HR, HR, 3).astype(np.float32))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(_run_ranks, d, BN_BODY + TRAIN_BODY + RM_BODY)
        yield _Done(future, d)


class _Done:
    """The ranks' directory once their run has ended (its error, if it
    failed)."""

    def __init__(self, future, d):
        self.future, self.d = future, d

    def result(self):
        self.future.result()
        return self.d


def _jax_run(twin, opt, n_sub, kd, base_lr, steps):
    (jnet, p, s), (tnet, tp, ts), batch = twin
    kw = dict(teacher_net=tnet, kd_ratio=kd) if kd else {}
    tr = JaxTrainer(jnet, opt_type=opt, weight_decay=3e-5, remat=False, **kw)
    opt_state = tr.init_opt_state(p)
    step = tr.make_train_step(
        n_subnets=n_sub, donate=False, teacher_params=tp, teacher_state=ts,
        teacher_arch=jarch.uniform_subnet(tnet.space, 3, 2, 1, 1).to_device(tnet.space),
        teacher_pixel_d=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for i in range(steps):
        cfgs = [jarch.sample_subnet(jnet.space, seed=subnet_seed(0, N_BATCH, i, k))
                for k in range(n_sub)]
        lr = jsched.lr_at_step(base_lr, 0, i, steps, 1)
        p, s, opt_state, m = step(p, s, opt_state, jb,
                                  tuple(c.to_device(jnet.space) for c in cfgs),
                                  jnp.asarray(lr, jnp.float32), sr_touched_mask(jnet, p, cfgs))
        metrics.append({k: float(v) for k, v in m.items()})
    return p, s, metrics


def _trained(rank_run):
    d = rank_run.result()
    ranks = [json.load(open(d / ("train_%d.json" % r))) for r in range(WORLD)]
    states = {name: [torch.load(d / ("%s_%d.pt" % (name, r))) for r in range(WORLD)]
              for name in RUNS}
    return ranks, states


def test_the_steps_cover_both_pixel_d():
    pds = {jarch.sample_subnet(_jax_space(), seed=subnet_seed(0, N_BATCH, i, 0)).pixel_d
           for i in range(RUNS["sgd"][4])}
    assert pds == {1, 2}


@pytest.mark.parametrize("run", list(RUNS))
def test_trainer_over_two_ranks_matches_jax_global_batch(twin, rank_run, run):
    """SRTrainer with a mesh, each rank on half the batch, against the JAX
    trainer on the whole batch: per-step loss and PSNR-Y (the global
    batch's, the same on both ranks), and the parameters and BN statistics
    after the steps (identical bits on both ranks)."""
    jp, js, jm = _jax_run(twin, *RUNS[run])  # while the ranks run
    ranks, states = _trained(rank_run)
    assert ranks[0][run] == ranks[1][run]
    a, b = states[run]
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    sgd = RUNS[run][0] == "sgd"
    for key in ("loss", "psnr"):
        np.testing.assert_allclose([m[key] for m in ranks[0][run]], [m[key] for m in jm],
                                   **(dict(rtol=1e-5) if sgd and key == "loss" else LOSS_TOL))
    if sgd:
        ref = s4_state_dict_from_jax(jp, js)
        for k, v in ref.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(a[k].numpy(), v.numpy(), rtol=0, atol=1e-5,
                                           err_msg=k)


# -- BN over two ranks ---------------------------------------------------------

BN_SHAPE, BN_C, BN_MOMENTUM, BN_EPS = (4, 5, 6), 24, 0.1, 1e-5

BN_BODY = r"""
from ofa_sr_tpu_torch.ops import norm
from ofa_sr_tpu_torch.ops.kernels import bn as kbn
from ofa_sr_tpu_torch.ops.kernels import bn_stats
g = mesh.group
z = dict(np.load(os.path.join(d, "bn_in.npz")))
t = {k: torch.from_numpy(v) for k, v in shard_batch({k: z[k] for k in ("x", "dy", "w")},
                                                     mesh).items()}
p = {k: torch.from_numpy(z[k]) for k in ("scale", "bias", "mean", "var")}
out = {}
kw = dict(momentum=float(z["momentum"]), eps=float(z["eps"]))
for dt in ("float32", "bfloat16"):
    x, dy = t["x"].to(getattr(torch, dt)), t["dy"].to(getattr(torch, dt))
    rm, rv = p["mean"].clone(), p["var"].clone()
    y, mean, var, inv = bn_stats.bn_forward(x, p["scale"], p["bias"], rm, rv, group=g,
                                            update_var="unbiased", **kw)
    dx, ds, db = bn_stats.bn_backward(dy, x, p["scale"], mean, inv, group=g)
    for k, v in dict(y=y, mean=mean, var=var, rm=rm, rv=rv, dx=dx, ds=ds, db=db).items():
        out["fwd_%s_%s" % (dt, k)] = v.float().numpy()
# train-mode BN with autograd: the plain branch and the fused one (the
# kernels' plain versions here), cotangents on y only, then on the moments
for uk in (False, True):
    x = t["x"].clone().requires_grad_()
    s, b = p["scale"].clone().requires_grad_(), p["bias"].clone().requires_grad_()
    rm, rv = p["mean"].clone(), p["var"].clone()
    y = norm.batch_norm_train(x, s, b, rm, rv, use_kernels=uk, group=g, **kw)
    (y * t["w"]).sum().backward()
    for k, v in dict(y=y, rm=rm, rv=rv, dx=x.grad, ds=s.grad, db=b.grad).items():
        out["train%d_%s" % (uk, k)] = v.detach().numpy()
x = t["x"].clone().requires_grad_()
s, b = p["scale"].clone().requires_grad_(), p["bias"].clone().requires_grad_()
y, m, v = kbn.bn_train_fused(x, s, b, kw["eps"], group=g)
((y * t["w"]).sum() + (m * torch.from_numpy(z["wm"])).sum()
 + (v * torch.from_numpy(z["wv"])).sum()).backward()
for k, val in dict(y=y, dx=x.grad, ds=s.grad, db=b.grad).items():
    out["moments_%s" % k] = val.detach().numpy()
np.savez(os.path.join(d, "bn_out_%d.npz" % rank), **out)
"""


def _bn_inputs(d):
    c = BN_C
    z = {"x": _rand((WORLD * 2,) + BN_SHAPE[1:] + (c,), 1, scale=2.0, shift=-0.5),
         "dy": _rand((WORLD * 2,) + BN_SHAPE[1:] + (c,), 2),
         "w": _rand((WORLD * 2,) + BN_SHAPE[1:] + (c,), 3),
         "scale": _rand((c,), 4, scale=0.3, shift=1.0), "bias": _rand((c,), 5, scale=0.2),
         "mean": _rand((c,), 6, scale=0.2), "var": np.abs(_rand((c,), 7)) + 0.5,
         "wm": _rand((c,), 8), "wv": _rand((c,), 9),
         "momentum": np.float64(BN_MOMENTUM), "eps": np.float64(BN_EPS)}
    # bf16 operands: the same values in both packages
    for k in ("x", "dy"):
        z[k + "_bf16"] = torch.from_numpy(z[k]).to(torch.bfloat16).float().numpy()
    np.savez(d / "bn_in.npz", **z)
    return z


@pytest.fixture(scope="module")
def bn_ranks(rank_run):
    d = rank_run.result()
    return dict(np.load(d / "bn_in.npz")), [dict(np.load(d / ("bn_out_%d.npz" % r)))
                                            for r in range(WORLD)]


def _jax_bn(z, x, dtype, monkeypatch=None):
    """JAX train-mode BN over the global rows: y, the new running statistics
    and (dx, dscale, dbias) by jax.vjp of the custom-VJP fused BN."""
    xj = jnp.asarray(x).astype(dtype)
    params = {"scale": jnp.asarray(z["scale"]), "bias": jnp.asarray(z["bias"])}
    state = {"mean": jnp.asarray(z["mean"]), "var": jnp.asarray(z["var"])}
    jy, js = jnorm.batch_norm(xj, params, state, training=True, momentum=BN_MOMENTUM,
                              eps=BN_EPS, update_var="unbiased")
    (_, jm, jv), vjp = jax.vjp(lambda a, s, b: jbn.bn_train_fused(a, s, b, BN_EPS, True), xj,
                               params["scale"], params["bias"])
    dyj = jnp.asarray(z["dy_bf16" if dtype == jnp.bfloat16 else "dy"]).astype(dtype)
    grads = vjp((dyj, jnp.zeros_like(jm), jnp.zeros_like(jv)))
    return jy, jm, jv, js, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_wrappers_over_two_ranks_match_jax_global_batch(bn_ranks, dtype, monkeypatch):
    """bn_forward / bn_backward with the group, each rank on half the rows,
    against JAX BN over all of them: y and dx (the ranks' rows in order),
    mean, var, the running statistics (the unbiased var over the global
    N), and dscale, dbias summed over the ranks (each rank returns its
    share)."""
    monkeypatch.setenv("OFA_SR_TPU_PALLAS_BN", "interpret")
    z, outs = bn_ranks
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = z["x_bf16"] if dtype == "bfloat16" else z["x"]
    jy, jm, jv, js, (jdx, jds, jdb) = _jax_bn(z, x, jdt)
    got = {k: [o["fwd_%s_%s" % (dtype, k)] for o in outs]
           for k in ("y", "mean", "var", "rm", "rv", "dx", "ds", "db")}
    for k in ("mean", "var", "rm", "rv"):
        np.testing.assert_array_equal(got[k][0], got[k][1])
    tol = BF16_ULP_TOL if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(np.concatenate(got["y"]), np.asarray(jy.astype(jnp.float32)),
                               **tol)
    np.testing.assert_allclose(np.concatenate(got["dx"]), np.asarray(jdx.astype(jnp.float32)),
                               **tol)
    np.testing.assert_allclose(got["mean"][0], np.asarray(jm), **TOL)
    np.testing.assert_allclose(got["var"][0], np.asarray(jv), **TOL)
    np.testing.assert_allclose(got["rm"][0], np.asarray(js["mean"]), **TOL)
    np.testing.assert_allclose(got["rv"][0], np.asarray(js["var"]), **TOL)
    np.testing.assert_allclose(sum(got["ds"]), np.asarray(jds), **TOL)
    np.testing.assert_allclose(sum(got["db"]), np.asarray(jdb), **TOL)


@pytest.mark.parametrize("use_kernels", [0, 1])
def test_batch_norm_train_over_two_ranks_matches_jax(bn_ranks, use_kernels):
    """Train-mode BN with autograd under the group, the plain branch
    (all-reduced E[x^2] - mean^2, the JAX formula) and the fused one:
    y, running statistics, and the gradients of sum(y*w) against JAX's over
    the global rows (dx per rank's rows; dscale, dbias summed)."""
    z, outs = bn_ranks
    c = BN_C
    params = {"scale": jnp.asarray(z["scale"]), "bias": jnp.asarray(z["bias"])}
    state = {"mean": jnp.asarray(z["mean"]), "var": jnp.asarray(z["var"])}

    def loss(x, p):
        y, s = jnorm.batch_norm(x, p, state, training=True, momentum=BN_MOMENTUM, eps=BN_EPS)
        return jnp.sum(y * jnp.asarray(z["w"])), (y, s)

    (_, (jy, js)), (jdx, jdp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z["x"]), params)
    key = "train%d_" % use_kernels
    got = {k: [o[key + k] for o in outs] for k in ("y", "rm", "rv", "dx", "ds", "db")}
    np.testing.assert_allclose(np.concatenate(got["y"]), np.asarray(jy), **TOL)
    np.testing.assert_allclose(np.concatenate(got["dx"]), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(got["rm"][0], np.asarray(js["mean"]), **TOL)
    np.testing.assert_allclose(got["rv"][1], np.asarray(js["var"]), **TOL)
    np.testing.assert_allclose(sum(got["ds"]), np.asarray(jdp["scale"]), **TOL)
    np.testing.assert_allclose(sum(got["db"]), np.asarray(jdp["bias"]), **TOL)
    assert got["ds"][0].shape == (c,)


def test_bn_train_fused_moment_cotangents_over_two_ranks(bn_ranks):
    """bn_train_fused under the group with cotangents on the returned mean
    and var too (their terms all-reduced): the gradients of the global
    batch, against the JAX custom VJP. Each rank's loss takes the moments'
    terms, so the ranks' losses add up to sum(y*w) + W*(sum(m*wm) +
    sum(v*wv)) over the global batch."""
    z, outs = bn_ranks

    def loss(x, s, b):
        y, m, v = jbn.bn_train_fused(x, s, b, BN_EPS, True)
        return (jnp.sum(y * jnp.asarray(z["w"])) + WORLD * jnp.sum(m * jnp.asarray(z["wm"]))
                + WORLD * jnp.sum(v * jnp.asarray(z["wv"])))

    jdx, jds, jdb = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(z["x"]), jnp.asarray(z["scale"]), jnp.asarray(z["bias"]))
    np.testing.assert_allclose(np.concatenate([o["moments_dx"] for o in outs]), np.asarray(jdx),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sum(o["moments_ds"] for o in outs), np.asarray(jds), **TOL)
    np.testing.assert_allclose(sum(o["moments_db"] for o in outs), np.asarray(jdb), **TOL)


# -- SRRunManager and bn_recalibrate over two ranks ------------------------------

RM_KW = dict(n_epochs=1, base_lr=1e-3, train_batch_size=4, print_frequency=1,
             bn_recalib_before_eval=False)
PROVIDER_KW = dict(n_train=8, n_valid=2, hr_size=16, train_batch_size=4)

RM_BODY = r"""
from ofa_sr_tpu_torch.data import SyntheticSRProvider
from ofa_sr_tpu_torch.models import OFAMobileNetS4, SearchSpace, uniform_subnet
from ofa_sr_tpu_torch.train import RunConfig, SRRunManager, bn_recalibrate
spec = json.load(open(os.path.join(d, "rm_spec.json")))
net = OFAMobileNetS4(SearchSpace(**spec["space"]), device="cpu")
state = torch.load(os.path.join(d, "student.pt"))
if rank == 1:  # rank 0's weights must reach every rank
    state = {k: v + 1 if v.is_floating_point() else v for k, v in state.items()}
net.load_state_dict(state)
path = os.path.join(d, "run_%d" % rank)
rm = SRRunManager(path, net, RunConfig(**spec["rm"]), SyntheticSRProvider(**spec["provider"]),
                  mesh=mesh)
tr = rm.train_one_epoch(0)
va = rm.validate()
rm.save_model(epoch=0)
rm.write_log("done", "valid")
cfg = uniform_subnet(net.space, 5, 3, 2, 1)
calib = np.load(os.path.join(d, "calib.npy"))
batches = [{"image": calib[0]}, {"image": calib[1][:3]}]  # 3 rows: whole on each rank
bn_recalibrate(net, cfg, 1, batches, mesh=mesh)
torch.save({k: v for k, v in net.state_dict().items() if "running" in k},
           os.path.join(d, "recal_%d.pt" % rank))
json.dump({"train": tr, "valid": va, "exists": os.path.exists(path)},
          open(os.path.join(d, "rm_%d.json" % rank), "w"))
"""


@pytest.fixture(scope="module")
def run_manager_ranks(rank_run):
    d = rank_run.result()
    return [json.load(open(d / ("rm_%d.json" % r))) for r in range(WORLD)]


def test_run_manager_over_two_ranks_matches_jax(twin, run_manager_ranks, tmp_path):
    """One epoch of SRRunManager(mesh) (rank 1 started from other weights:
    rank 0's are broadcast) against JAX SRRunManager without a mesh on the
    same global batches: train loss, train PSNR, valid loss and PSNR."""
    (jnet, p, s), _, _ = twin
    # its own init is the twin's (PRNGKey(manual_seed = 0))
    jrm = JaxRunManager(str(tmp_path), jnet, JaxRunConfig(**RM_KW), JaxProvider(**PROVIDER_KW))
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(jrm.params),
                                                     jax.tree.leaves(p)))
    jtr = jrm.train_one_epoch(0)
    jva = jrm.validate()
    for r in run_manager_ranks:
        np.testing.assert_allclose(r["train"], jtr, **EPOCH_TOL)
        np.testing.assert_allclose(r["valid"], jva, **EPOCH_TOL)


def test_run_manager_writes_on_rank_zero_only(rank_run, run_manager_ranks):
    d = rank_run.result()
    assert run_manager_ranks[0]["exists"] and not run_manager_ranks[1]["exists"]
    for f in ("checkpoint/checkpoint.pth.tar", "checkpoint/latest.txt", "logs/valid_console.txt",
              "logs/train_console.txt", "net_info.txt", "run.config"):
        assert os.path.isfile(d / "run_0" / f), f
    assert not os.path.exists(d / "run_1")


def test_bn_recalibrate_over_two_ranks_matches_jax(rank_run, run_manager_ranks):
    """bn_recalibrate under the mesh (each rank on half of a calibration
    batch of 4 rows; a batch of 3 rows, which does not split, whole on each
    rank without a collective, as JAX runs an unsharded batch) against JAX's
    on the whole batches, from the same weights: the same statistics on
    both ranks."""
    d = rank_run.result()
    got = [torch.load(d / ("recal_%d.pt" % r)) for r in range(WORLD)]
    assert all(torch.equal(got[0][k], got[1][k]) for k in got[0])
    # the JAX reference starts from the trained weights of rank 0's epoch
    ckpt = torch.load(d / "run_0" / "checkpoint" / "checkpoint.pth.tar")["model"]
    from ofa_sr_tpu.train.checkpoint import import_torch_s4
    jnet = JaxS4(_jax_space())
    jp, js = import_torch_s4(ckpt, jnet)
    cfg = jarch.uniform_subnet(jnet.space, 5, 3, 2, 1)
    calib = np.load(d / "calib.npy")
    batches = [{"image": jnp.asarray(calib[0])}, {"image": jnp.asarray(calib[1][:3])}]
    js2 = jax_bn_recalibrate(jnet, jp, js, cfg.to_device(jnet.space), 1, batches)
    ref = s4_state_dict_from_jax(jp, js2)
    for k, v in got[0].items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), err_msg=k, **TOL)
