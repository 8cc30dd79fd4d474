"""The port's classification training step (ofa_sr_tpu_torch/train/
cls_trainer.py `ClsTrainer`, the loss and metric functions, and
`ElasticClassifierNet.forward`'s `compute_dtype` and `bn_group`) against
the JAX package's `ClsTrainer` on the CPU, from the same weights (the JAX
init with random BN parameters and statistics, through the weight bridge
`mbv3_state_dict_from_jax`) and the same batches.

The net is narrow: two elastic stages of widths 16 and 24 (SE on the
second), first conv 8, head 64 -> 96, 10 classes, ks 3/5, e 2/3, d 1/2;
32 px images at batch 8 (the last BNs normalize over 128 rows); dropout 0,
because the port draws its masks from a torch.Generator and JAX from
`jax.random` (a stated difference). JAX steps take `cls_touched_mask`, the
port's optimizer skips the parameters whose gradient is None: both are
torch's semantics.

Tolerances:
- the loss and metric functions: rtol 1e-6 (float32, the same formulas);
- two SGD steps in float32 (one subnet; two subnets with KD, "ce" and
  "mse"; BN frozen): losses rtol 1e-5, top-1/top-5 exact, every parameter
  and running statistic rtol 1e-5 and atol 5e-5 (float32 sums in another
  order through ~10 layers, then two updates: the update of a block first
  trained in step 2 differs by up to 4.4e-4 of its norm in the KD "mse"
  case, measured, where its inputs already moved apart in step 1; 2e-5 of
  weights ~0.1);
- bf16 (`compute_dtype`): the eval-mode logits bit for bit (both packages
  round at the same places: the casts, each conv and linear product, the
  bias adds); tests/test_torch_bf16.py's bounds for the rest: running
  statistics rtol and atol 1e-2, step losses rtol 5e-3, train-mode logits
  within 4 bf16 ulps of their largest magnitude at the maximum. Their mean
  |diff| is held to 1 ulp there, not to that file's 1/2: train-mode BN
  sums its moments in another order in each package, flipped roundings
  compound over the layers, and the 10 logits of ~0.2 pool 96 features of
  1-4 px a row, so no flip averages out (measured 0.78 ulp; JAX's own bf16
  against its float32 1.86 ulps, which a wrong cast would show).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.models import ofa_cls as jcls
from ofa_sr_tpu.train import cls_trainer as jtr
from ofa_sr_tpu.train.touched import cls_touched_mask
from ofa_sr_tpu.train.train_step import cast_params_for_compute
from ofa_sr_tpu_torch.models import ofa_cls as tcls
from ofa_sr_tpu_torch.train import ClsTrainer, cross_entropy, soft_target_ce, topk_accuracy
from ofa_sr_tpu_torch.train.checkpoint import mbv3_state_dict_from_jax
from test_torch_bf16 import FWD_ULPS_MAX, STATE_TOL, STEP_TOL, _ulp
from test_torch_train import _randomize_bn

FN_TOL = dict(rtol=1e-6, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=5e-5)
B, HW, N_CLASSES, LR = 8, 32, 10, 0.05
TRAIN_LOGITS_ULPS_MEAN = 1.0
SGD_KW = dict(opt_type="sgd", weight_decay=3e-5, momentum=0.9, nesterov=True,
              label_smoothing=0.1)


def narrow_kw(ks_list=(3, 5), expand_list=(2, 3), depth_list=(1, 2)):
    """The narrow classification net of tests/test_mesh_run_manager.py, in
    both packages' constructor terms, without dropout."""
    return dict(n_classes=N_CLASSES,
                stage_specs=[jcls.StageSpec(16, 2, "relu", False, max(depth_list)),
                             jcls.StageSpec(24, 2, "h_swish", True, max(depth_list))],
                first_conv_width=8, first_conv_act="h_swish", first_block_act="relu",
                final_expand_width=64, feature_mix_width=96, ks_list=list(ks_list),
                expand_list=list(expand_list), depth_list=list(depth_list),
                dropout_rate=0.0)


def jax_narrow(seed=0, **kw):
    """(JAX net, params, state with random BN)."""
    net = jcls.ElasticClassifierNet(**narrow_kw(**kw))
    net._first_block_out = net.first_conv_width
    p, s = net.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 7)
    return net, _randomize_bn(p, rng), _randomize_bn(s, rng)


def port_narrow(p, s, **kw):
    k = narrow_kw(**kw)
    k["stage_specs"] = [tcls.StageSpec(*dataclasses.astuple(sp)) for sp in k["stage_specs"]]
    net = tcls.ElasticClassifierNet(device="cpu", **k)
    net.load_state_dict(mbv3_state_dict_from_jax(p, s))
    return net


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(seed=0, b=B, hw=HW):
    r = np.random.RandomState(seed)
    return {"image": r.rand(b, hw, hw, 3).astype(np.float32),
            "label": r.randint(0, N_CLASSES, b).astype(np.int64)}


def tbatch(bt):
    return {k: torch.from_numpy(v) for k, v in bt.items()}


def jbatch(bt):
    return {k: jnp.asarray(v) for k, v in bt.items()}


def tarch(a):
    return tcls.ClsArch(tuple(a.ks), tuple(a.e), tuple(a.d), a.wid)


def assert_state_dict_close(net, p, s, tol=PARAM_TOL, only=None):
    ref = mbv3_state_dict_from_jax(p, s)
    got = net.state_dict()
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if "num_batches" in k or (only is not None and only not in k):
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **tol)


# -- the loss and metric functions ------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    r = np.random.RandomState(1)
    logits = (3 * r.randn(16, 10)).astype(np.float32)
    labels = r.randint(0, 10, 16)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    ref = jtr.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    np.testing.assert_allclose(float(got), float(ref), **FN_TOL)


def test_soft_target_ce_matches_jax():
    r = np.random.RandomState(2)
    logits = (3 * r.randn(16, 10)).astype(np.float32)
    soft = np.array(jax.nn.softmax(jnp.asarray(r.randn(16, 10).astype(np.float32))))
    got = soft_target_ce(torch.from_numpy(logits), torch.from_numpy(soft))
    np.testing.assert_allclose(float(got), float(jtr.soft_target_ce(jnp.asarray(logits),
                                                                    jnp.asarray(soft))),
                               **FN_TOL)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_topk_accuracy_matches_jax(k):
    r = np.random.RandomState(3)
    logits = r.randn(64, 10).astype(np.float32)
    labels = r.randint(0, 10, 64)
    got = topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), k)
    assert float(got) == float(jtr.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels), k))


# -- the training step ------------------------------------------------------------

# each case: the archs of step 1 and step 2 (step 1 skips stage 0's second
# block, step 2 runs it), kd (None, "ce", "mse"), bn_frozen
def _archs(jnet, kind):
    a = jcls.ClsArch(ks=(5, 3, 3, 5), e=(3, 2, 3, 3), d=(1, 2))
    b = jcls.ClsArch(ks=(3, 5, 5, 3), e=(2, 3, 2, 2), d=(2, 2))
    c = jcls.ClsArch(ks=(5, 5, 3, 3), e=(3, 3, 2, 3), d=(1, 1))
    return {"one": [[a], [b]], "two": [[a, c], [b, a]]}[kind]


CASES = {"one subnet": ("one", None, False), "two subnets + KD ce": ("two", "ce", False),
         "two subnets + KD mse": ("two", "mse", False), "bn_frozen": ("one", None, True)}


@pytest.fixture(scope="module")
def teacher():
    """(JAX teacher net, params, state, its arch): ks5/e3/d2 with 10 classes."""
    net, p, s = jax_narrow(seed=3, ks_list=[5], expand_list=[3], depth_list=[2])
    return net, p, s, net.max_arch()


def jax_steps(archs_per_step, kd, bn_frozen, teacher, compute_dtype=None, seed=0):
    jnet, p, s = jax_narrow(seed)
    kw = dict(SGD_KW, kd_ratio=1.0 if kd else 0.0, kd_type=kd or "ce", bn_frozen=bn_frozen,
              compute_dtype=compute_dtype, remat=False)
    t_kw = {}
    if kd:
        t_net, tp, ts, ta = teacher
        kw["teacher_net"] = t_net
        t_kw = dict(teacher_params=tp, teacher_state=ts, teacher_arch=t_net.arch_to_device(ta))
    tr = jtr.ClsTrainer(jnet, **kw)
    opt = tr.init_opt_state(p)
    step = tr.make_train_step(n_subnets=len(archs_per_step[0]), **t_kw)
    metrics = []
    for i, archs in enumerate(archs_per_step):
        dev = tuple(jnet.arch_to_device(a) for a in archs)
        p, s, opt, m = step(p, s, opt, jbatch(batch(i)), dev, jnp.asarray(LR, jnp.float32),
                            jax.random.PRNGKey(i), cls_touched_mask(jnet, p, archs))
        metrics.append({k: float(v) for k, v in m.items()})
    return p, s, metrics


def port_steps(archs_per_step, kd, bn_frozen, teacher, compute_dtype=None, seed=0):
    _, p, s = jax_narrow(seed)
    net = port_narrow(p, s)
    t = None
    if kd:
        t_net, tp, ts, ta = teacher
        t = (port_narrow(tp, ts, ks_list=[5], expand_list=[3], depth_list=[2]), tarch(ta))
    tr = ClsTrainer(net, kd_ratio=1.0 if kd else 0.0, kd_type=kd or "ce", teacher=t,
                    bn_frozen=bn_frozen, compute_dtype=compute_dtype, **SGD_KW)
    metrics = [{k: float(v) for k, v in tr.train_step(tbatch(batch(i)),
                                                      [tarch(a) for a in archs], LR).items()}
               for i, archs in enumerate(archs_per_step)]
    return net, metrics


@pytest.mark.parametrize("case", list(CASES))
def test_two_sgd_steps_match_jax(case, teacher):
    """Losses and accuracies of each step, then every parameter and running
    statistic after the second. Step 1 leaves stage 0's second block
    unused (its gradient None: no decay, no momentum); step 2 trains it."""
    kind, kd, frozen = CASES[case]
    archs = _archs(None, kind)
    jp, js, jm = jax_steps(archs, kd, frozen, teacher)
    net, tm = port_steps(archs, kd, frozen, teacher)
    np.testing.assert_allclose([m["loss"] for m in tm], [m["loss"] for m in jm], **LOSS_TOL)
    for key in ("top1", "top5"):
        assert [m[key] for m in tm] == [m[key] for m in jm], key
    assert_state_dict_close(net, jp, js)


def test_untouched_block_is_skipped():
    """One step in which stage 0's second block does not run: its weights
    keep their values exactly (no weight decay, no momentum buffer)."""
    _, p, s = jax_narrow()
    net = port_narrow(p, s)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    tr = ClsTrainer(net, **SGD_KW)
    tr.train_step(tbatch(batch(0)), [tarch(_archs(None, "one")[0][0])], LR)
    after = net.state_dict()
    block = [k for k in after if k.startswith("blocks.2.")]  # stage 0, second block
    assert block and all(torch.equal(after[k], before[k]) for k in block)
    assert not any(id(p) in {id(q) for q in tr.opt.state} for n, p in net.named_parameters()
                   if n.startswith("blocks.2."))
    assert not torch.equal(after["blocks.1.mobile_inverted_conv.point_linear.conv.weight"],
                           before["blocks.1.mobile_inverted_conv.point_linear.conv.weight"])


def test_eval_step_matches_jax():
    jnet, p, s = jax_narrow()
    net = port_narrow(p, s)
    a = jcls.ClsArch(ks=(5, 3, 3, 5), e=(3, 2, 3, 3), d=(2, 1))
    ref = jtr.ClsTrainer(jnet).make_eval_step()(p, s, jbatch(batch(5)), jnet.arch_to_device(a))
    got = ClsTrainer(net).eval_step(tbatch(batch(5)), tarch(a))
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), **LOSS_TOL)
    assert float(got["top1"]) == float(ref["top1"]) and float(got["top5"]) == float(ref["top5"])


# -- bf16 -------------------------------------------------------------------------

def test_bf16_train_forward_matches_jax():
    """The mixed-precision train-mode forward (JAX: cast_params_for_compute,
    the input cast, the logits cast to float32 by the trainer) and its
    running statistics."""
    jnet, p, s = jax_narrow()
    net = port_narrow(p, s)
    a = jcls.ClsArch(ks=(5, 3, 3, 5), e=(3, 2, 3, 3), d=(2, 2))
    x = batch(6)["image"]
    jy, js = jnet.apply(cast_params_for_compute(p, jnp.bfloat16), s,
                        jnp.asarray(x).astype(jnp.bfloat16), jnet.arch_to_device(a),
                        training=True)
    y = net(torch.from_numpy(x), tarch(a), training=True, compute_dtype=torch.bfloat16)
    assert y.dtype == torch.float32
    ref = np.asarray(jy.astype(jnp.float32))
    ulp, d = _ulp(np.abs(ref).max()), np.abs(y.detach().numpy() - ref)
    assert d.max() <= FWD_ULPS_MAX * ulp, (d.max(), ulp)
    assert d.mean() <= TRAIN_LOGITS_ULPS_MEAN * ulp, (d.mean(), ulp)
    assert_state_dict_close(net, p, js, tol=STATE_TOL, only="running")
    # eval mode, from the same statistics: the same bits
    net = port_narrow(p, s)
    jy, _ = jnet.apply(cast_params_for_compute(p, jnp.bfloat16), s,
                       jnp.asarray(x).astype(jnp.bfloat16), jnet.arch_to_device(a))
    with torch.no_grad():
        y = net(torch.from_numpy(x), tarch(a), compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy.astype(jnp.float32)))


def test_bf16_steps_match_jax(teacher):
    """Two SGD steps of two subnets with KD in bf16: losses, and the
    running statistics after them."""
    archs = _archs(None, "two")
    jp, js, jm = jax_steps(archs, "ce", False, teacher, compute_dtype=jnp.bfloat16)
    net, tm = port_steps(archs, "ce", False, teacher, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose([m["loss"] for m in tm], [m["loss"] for m in jm], **STEP_TOL)
    assert_state_dict_close(net, jp, js, tol=STATE_TOL, only="running")
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_forward_defaults_unchanged():
    """compute_dtype=None and bn_group=None are the forward's defaults:
    the same bits as a call without them, in eval and train mode."""
    _, p, s = jax_narrow()
    net = port_narrow(p, s)
    a = tcls.ClsArch(ks=(5, 3, 3, 5), e=(3, 2, 3, 3), d=(2, 1))
    x = torch.from_numpy(batch(7)["image"])
    with torch.no_grad():
        assert torch.equal(net(x, a), net(x, a, compute_dtype=None, bn_group=None))
        saved = {k: v.clone() for k, v in net.state_dict().items()}
        y1 = net(x, a, training=True)
        net.load_state_dict(saved)
        y2 = net(x, a, training=True, compute_dtype=None, bn_group=None)
    assert torch.equal(y1, y2)
