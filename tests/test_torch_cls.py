"""The port's classification nets (ofa_sr_tpu_torch/models/ofa_cls.py,
materialize_cls.py, net_config.py, search/flops.py `cls_subnet_flops`,
models/export.py `export_cls_subnet`, the weight bridge
`mbv3_state_dict_from_jax`) against the JAX package's on the CPU, at the
published widths (OFAMobileNetV3 and OFAProxylessNASNets, 1000 classes,
runtime elastic width [0.65, 1.0]) on 64 px images, from the same weights
(the JAX init with random BN parameters and statistics as
tests/test_torch_train.py draws them, through the bridge).

Tolerances: logits and running statistics rtol and atol 1e-4, as
tests/test_torch_x4.py holds its forwards (float32 through ~20 blocks of
convs summed in another order; BN in train mode at the last stages
normalizes over 16 rows a channel, which amplifies that noise to ~1e-4 on
logits of ~0.5, so the images are 64 px at batch 4, where the deepest BN
still sees 2x2 pixels, not 32 px, where it sees one); the materialized and specialized subnets against the supernet
1e-4; the exported artifact against the materialized subnet 1e-6; sampled
archs, widths, net.config JSON, MACs and the weight bridge exact.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.models import net_config as jnc
from ofa_sr_tpu.models import ofa_cls as jcls
from ofa_sr_tpu.search import flops as jflops
from ofa_sr_tpu.train import checkpoint as jckpt
from ofa_sr_tpu_torch.models import net_config as tnc
from ofa_sr_tpu_torch.models import ofa_cls as tcls
from ofa_sr_tpu_torch.models.export import export_cls_subnet, load_subnet
from ofa_sr_tpu_torch.models.materialize_cls import get_active_cls_subnet
from ofa_sr_tpu_torch.search import cls_subnet_flops
from ofa_sr_tpu_torch.train.checkpoint import mbv3_state_dict_from_jax
from test_torch_train import _randomize_bn

FAMILIES = ("OFAMobileNetV3", "OFAProxylessNASNets")
WML = [0.65, 1.0]
TOL = dict(rtol=1e-4, atol=1e-4)
EXPORT_TOL = dict(rtol=0, atol=1e-6)
HW, B = 64, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread for the module, restored after it: these nets'
    CPU convs gain little from intra-op threads and oversubscribe the CPU
    under parallel test workers (as tests/test_torch_x4.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """(family, JAX net, params, state, jitted JAX forward, port net)."""
    fam = request.param
    jnet = getattr(jcls, fam)(width_mult_list=WML)
    p, s = jnet.init(jax.random.PRNGKey(FAMILIES.index(fam)))
    rng = np.random.RandomState(7)
    p, s = _randomize_bn(p, rng), _randomize_bn(s, rng)
    tnet = getattr(tcls, fam)(width_mult_list=WML, device="cpu")
    tnet.load_state_dict(mbv3_state_dict_from_jax(p, s))
    fwd = {t: jax.jit(functools.partial(jnet.apply, training=t)) for t in (False, True)}
    return fam, jnet, p, s, fwd, tnet


def _x(seed=0, b=B, hw=HW):
    return np.random.RandomState(seed).rand(b, hw, hw, 3).astype(np.float32)


def _arch(jnet, kind, wid):
    a = jnet.max_arch() if kind == "max" else jnet.sample_arch(seed=kind)
    return dataclasses.replace(a, wid=wid)


def _tarch(a):
    return tcls.ClsArch(a.ks, a.e, a.d, a.wid)


def _close(got, ref, msg="", tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), err_msg=msg, **tol)


# -- construction, sampling, widths ---------------------------------------------

def test_widths_match_jax(pair):
    fam, jnet, _, _, _, tnet = pair
    for attr in ("width_mult_list", "stage_width_lists", "first_conv_widths",
                 "first_block_outs", "feature_mix_widths", "final_expand_width",
                 "feature_mix_width", "n_blocks"):
        assert getattr(tnet, attr) == getattr(jnet, attr), attr
    assert [dataclasses.astuple(s) for s in tnet.stage_specs] == \
        [dataclasses.astuple(s) for s in jnet.stage_specs]
    assert tnet.block_layout() == jnet.block_layout()
    for wid in (0, 1):
        assert tnet.active_block_channels(wid) == jnet.active_block_channels(wid)


def test_sample_arch_matches_jax(pair):
    """The same draws for the same seed and candidates, wid included."""
    _, jnet, _, _, _, tnet = pair
    for kw in (dict(), dict(ks_candidates=[3, 5], depth_candidates=[2]),
               dict(wid_candidates=[0, 1], expand_candidates=[4, 6])):
        for seed in range(4):
            a, b = jnet.sample_arch(seed, **kw), tnet.sample_arch(seed, **kw)
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
            assert a.describe() == b.describe()
    assert dataclasses.astuple(tnet.max_arch()) == dataclasses.astuple(jnet.max_arch())


@pytest.mark.parametrize("kind,wid", [("max", None), (3, 0), (5, 1)])
def test_arch_to_device_matches_jax(pair, kind, wid):
    _, jnet, _, _, _, tnet = pair
    a = _arch(jnet, kind, wid)
    got, ref = tnet.arch_to_device(_tarch(a)), jnet.arch_to_device(a)
    assert got.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k


# -- the forward ----------------------------------------------------------------

@pytest.mark.parametrize("kind,wid", [("max", 1), ("max", 0), (3, 1), (4, 0)])
@pytest.mark.parametrize("training", [False, True])
def test_forward_matches_jax(pair, kind, wid, training):
    """Eval and train-mode logits, and in train mode the running statistics
    (the active channels' updated, the rest kept), against JAX's masked
    forward."""
    fam, jnet, p, s, fwd, tnet = pair
    a = _arch(jnet, kind, wid)
    x = _x(1)
    jy, js = fwd[training](p, s, jnp.asarray(x), jnet.arch_to_device(a))
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    try:
        with torch.no_grad():
            ty = tnet(torch.from_numpy(x), _tarch(a), training=training)
        _close(ty, jy, "%s logits" % fam)
        ref = mbv3_state_dict_from_jax(p, js)
        got = tnet.state_dict()
        for k in ref:
            if "running" in k:
                _close(got[k], ref[k], k)
        moved = [k for k in got if "running" in k and not torch.equal(got[k], before[k])]
        assert bool(moved) == training
    finally:
        tnet.load_state_dict(before)


def test_dropout_needs_a_generator(pair):
    """Dropout runs only in training with a generator (JAX: with a
    dropout_rng); without one the train-mode logits are the eval-dropout
    ones."""
    _, jnet, _, _, _, tnet = pair
    a, x = _tarch(jnet.max_arch()), torch.from_numpy(_x(2, b=2, hw=32))
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    try:
        with torch.no_grad():
            plain = tnet(x, a, training=True)
            tnet.load_state_dict(before)
            dropped = tnet(x, a, training=True,
                           dropout_generator=torch.Generator().manual_seed(0))
            tnet.load_state_dict(before)
            again = tnet(x, a, training=True)
    finally:
        tnet.load_state_dict(before)
    assert torch.equal(plain, again) and not torch.allclose(plain, dropped)


# -- weights, materialize, specialize, net.config -------------------------------

def test_weight_bridge_exact_both_ways(pair):
    """JAX params -> the port's state_dict -> `import_torch_mbv3` gives back
    the JAX tree; the port's own init -> JAX -> the bridge gives back its
    state_dict."""
    fam, jnet, p, s, _, _ = pair
    jp, js = jckpt.import_torch_mbv3(mbv3_state_dict_from_jax(p, s), jnet)
    for a, b in zip(jax.tree.leaves((p, s)), jax.tree.leaves((jp, js))):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    own = getattr(tcls, fam)(width_mult_list=WML, device="cpu",
                             generator=torch.Generator().manual_seed(3)).state_dict()
    back = mbv3_state_dict_from_jax(*jckpt.import_torch_mbv3(own, jnet))
    assert back.keys() == own.keys()
    assert all(torch.equal(back[k], own[k]) for k in own)


@pytest.mark.parametrize("fold_bn", [True, False])
@pytest.mark.parametrize("kind,wid", [("max", 1), (6, 0)])
def test_materialized_matches_jax(pair, kind, wid, fold_bn):
    """StaticClsSubnet against JAX's masked supernet on the same weights
    (JAX's own tests hold its materialized subnet to the masked one)."""
    _, jnet, p, s, fwd, tnet = pair
    a = _arch(jnet, kind, wid)
    x = _x(3)
    jy, _ = fwd[False](p, s, jnp.asarray(x), jnet.arch_to_device(a))
    with torch.no_grad():
        ty = get_active_cls_subnet(tnet, _tarch(a), fold_bn=fold_bn)(torch.from_numpy(x))
    _close(ty, jy, "vs masked")


@pytest.mark.parametrize("kind,wid", [("max", None), (7, 0), (8, 1)])
def test_net_config_matches_jax(pair, kind, wid):
    """get_active_net_config: the same JSON as JAX's."""
    _, jnet, _, _, _, tnet = pair
    a = _arch(jnet, kind, wid)
    got = tnc.get_active_net_config(tnet, _tarch(a))
    assert json.dumps(got, sort_keys=True) == json.dumps(jnc.get_active_net_config(jnet, a),
                                                         sort_keys=True)


@pytest.mark.parametrize("training", [False, True])
def test_specialize_matches_jax(pair, training, tmp_path):
    """specialize's static net against JAX's masked supernet in eval and in
    train mode (logits), its running statistics after a train-mode forward
    against the supernet's sliced as `static_params_from_supernet` slices
    them; JAX's specialized net and `import_torch_static` read the port's
    static state_dict as JAX's own, and the port's reads it back into a net
    loaded from the JSON file (`load_net_config`)."""
    fam, jnet, p, s, fwd, tnet = pair
    a = _arch(jnet, 9, 0)
    ta = _tarch(a)
    x = _x(4)
    static = tnc.specialize(tnet, ta)
    sd = {k: v.clone() for k, v in static.state_dict().items()}
    jstatic, jsp, jss = jnc.specialize(jnet, p, s, a)
    ip, is_ = jnc.import_torch_static(sd, jstatic)
    for u, v in zip(jax.tree.leaves((jsp, jss)), jax.tree.leaves((ip, is_))):
        assert np.array_equal(np.asarray(u), np.asarray(v))
    jy, _ = fwd[training](p, s, jnp.asarray(x), jnet.arch_to_device(a))
    with torch.no_grad():
        ty = static(torch.from_numpy(x), training=training)
    _close(ty, jy, "%s static" % fam)
    if training:
        before = {k: v.clone() for k, v in tnet.state_dict().items()}
        try:
            with torch.no_grad():
                tnet(torch.from_numpy(x), ta, training=True)
            ref = tnc.static_params_from_supernet(tnet, ta)
        finally:
            tnet.load_state_dict(before)
        got = static.state_dict()
        moved = 0
        for k in ref:
            if "running" in k:
                _close(got[k], ref[k], k)
                moved += not torch.equal(got[k], sd[k])
        assert moved
    path = str(tmp_path / "net.config")
    with open(path, "w") as f:
        json.dump(static.config, f)
    rebuilt = tnc.load_net_config(path, device="cpu")
    tnc.import_torch_static({"state_dict": sd}, rebuilt)
    assert all(torch.equal(rebuilt.state_dict()[k], v) for k, v in sd.items())


@pytest.mark.parametrize("name,cfg", [
    ("PoolingLayer", {"name": "PoolingLayer", "pool_type": "avg", "kernel_size": 3,
                      "stride": 2}),
    ("PoolingLayer", {"name": "PoolingLayer", "pool_type": "max", "kernel_size": 3,
                      "stride": 2, "act_func": "relu"}),
    ("ZeroLayer", {"name": "ZeroLayer", "stride": 2}),
    ("DepthConvLayer", {"name": "DepthConvLayer", "in_channels": 8, "out_channels": 12,
                        "kernel_size": 3, "stride": 2, "act_func": "h_swish"}),
    ("ConvLayer", {"name": "ConvLayer", "in_channels": 8, "out_channels": 12, "kernel_size": 3,
                   "stride": 1, "bias": True, "use_bn": True, "act_func": "lrelu"}),
])
def test_registry_layers_match_jax(name, cfg):
    """The registry's other layers, from the same weights (eval mode)."""
    jp, js = jnc.layer_init_from_config(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(0)
    jp = jax.tree.map(lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)), jp)
    layer = tnc.LAYER_REGISTRY[name](cfg, generator=torch.Generator().manual_seed(0))
    sd = {}
    if "conv" in jp:
        sd["conv.weight"] = torch.from_numpy(np.transpose(np.asarray(jp["conv"]["w"]),
                                                          (3, 2, 0, 1)).copy())
        if "b" in jp["conv"]:
            sd["conv.bias"] = torch.tensor(np.asarray(jp["conv"]["b"]))
    for part in ("depth_conv", "point_conv"):
        if part in jp:
            sd[part + ".weight"] = torch.from_numpy(np.transpose(np.asarray(jp[part]["w"]),
                                                                 (3, 2, 0, 1)).copy())
    if "bn" in jp:
        sd.update({"bn.weight": torch.tensor(np.asarray(jp["bn"]["scale"])),
                   "bn.bias": torch.tensor(np.asarray(jp["bn"]["bias"]))})
    layer.load_state_dict(sd, strict=False)
    x = rng.rand(2, 9, 9, 8).astype(np.float32)
    jy, _ = jnc.layer_apply_from_config(jp, js, jnp.asarray(x), cfg)
    with torch.no_grad():
        ty = layer(torch.from_numpy(x))
    assert ty.shape == jy.shape
    _close(ty, jy, name, dict(rtol=0, atol=1e-5))


# -- MACs and the artifact --------------------------------------------------------

def test_cls_subnet_flops_matches_jax(pair):
    _, jnet, _, _, _, tnet = pair
    for kind, wid in (("max", None), (1, 0), (2, 1), (3, None)):
        a = _arch(jnet, kind, wid)
        for size in (224, 160):
            assert cls_subnet_flops(tnet, _tarch(a), size) == \
                jflops.cls_subnet_flops(jnet, a, size)


def test_export_cls_subnet_round_trip(pair, tmp_path):
    """export_cls_subnet -> load_subnet serves the materialized subnet's
    logits."""
    _, jnet, _, _, _, tnet = pair
    a = _tarch(_arch(jnet, 5, 0))
    x = torch.from_numpy(_x(5, b=2))
    path = str(tmp_path / "cls.pt2")
    blob = export_cls_subnet(tnet, a, HW, batch=2, path=path)
    with open(path, "rb") as f:
        assert f.read() == blob
    with torch.no_grad():
        _close(load_subnet(path, device="cpu")(x), get_active_cls_subnet(tnet, a)(x),
               "artifact", EXPORT_TOL)
