"""The port's five classification command-line entry points on the CPU
(`--synthetic --device cpu`) against the JAX package's on the same
arguments and the same weights, each side loading its own checkpoint
format (the port's written through `mbv3_state_dict_from_jax`): the CIFAR
chain (the teacher trainer resuming from a seeded checkpoint, then the
supernet trainer with KD from that teacher) and the ImageNet chain
(`train_ofa_net --task kernel` warm-started with a KD teacher, then
`--task depth --phase 1 --warmstart` from it, then `eval_ofa_net` plain,
`--materialize` and `--export`, then `eval_specialized_net
--supernet_checkpoint --arch_config`), at the published widths on 32 px
images at batch 8.

The same harness in both packages (`_harness`), because at the presets'
LR and step counts the full-width net from a random init on random labels
is chaotic in float32 in either package alone: a 1e-6 relative change of
the port's weights moves its loss by 5.8e-3 after one step and by 0.12
after three (measured), and the two packages' float32 BN gradients differ
by up to ~1e-2 relatively at a step (train-mode BN's E[x^2] - mean^2 over
channels whose mean dwarfs their spread). So each training run is held at
one optimizer step: one synthetic batch an epoch, no warmup epochs in the
kernel task's preset (`TASK_PHASES` is held verbatim separately), every
schedule's LR times 1e-2 (so the evaluated nets stay near their start),
and the chained runs start on both sides from the JAX run before them.
Dropout is 0 (the port's masks come from a torch.Generator, JAX's from
`jax.random`: a stated difference); JAX's `train_ofa_net` runs with
`jax.device_count` at 1, as the port's process is a world of one; the JAX
runs take `--remat off`, an XLA-only flag of no numeric effect.

Tolerances: the returned accuracies exact (whole hits over 32 or 64
images); each tensor of each training run's checkpoint within 2e-2 of what
the run changed it by (measured up to 1e-2), plus 1e-5 of its size; the
evaluators from the same checkpoint exact; the exported artifacts against
the nets they export 1e-6 (tests/test_torch_cls.py's bound).
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from ofa_sr_tpu.cli import eval_ofa_net as jeval
from ofa_sr_tpu.cli import eval_specialized_net as jspec
from ofa_sr_tpu.cli import train_ofa_net as jofa
from ofa_sr_tpu.cli import train_ofa_net_cifar10_simple as jcofa
from ofa_sr_tpu.cli import train_teacher_net_cifar10_simple as jteacher
from ofa_sr_tpu.models import ofa_cls as jcls
from ofa_sr_tpu.train import checkpoint as jckpt
from ofa_sr_tpu.train import cls_run_manager as jcls_rm
from ofa_sr_tpu.train.cls_run_manager import ClsRunManager as JaxClsRunManager
from ofa_sr_tpu.train.run_manager import RunConfig as JaxRunConfig
from ofa_sr_tpu_torch.cli import eval_ofa_net as teval
from ofa_sr_tpu_torch.cli import eval_specialized_net as tspec
from ofa_sr_tpu_torch.cli import train_ofa_net as tofa
from ofa_sr_tpu_torch.cli import train_ofa_net_cifar10_simple as tcofa
from ofa_sr_tpu_torch.cli import train_teacher_net_cifar10_simple as tteacher
from ofa_sr_tpu_torch.data import SyntheticClsProvider
from ofa_sr_tpu_torch.model_zoo import ofa_net, ofa_specialized
from ofa_sr_tpu_torch.models import get_active_cls_subnet
from ofa_sr_tpu_torch.models import ofa_cls as tcls
from ofa_sr_tpu_torch.models.export import load_subnet
from ofa_sr_tpu_torch.train import ClsRunManager, RunConfig
from ofa_sr_tpu_torch.train import checkpoint as tckpt
from ofa_sr_tpu_torch.train import cls_run_manager as tcls_rm
from ofa_sr_tpu_torch.train.checkpoint import mbv3_state_dict_from_jax
from ofa_sr_tpu_torch.train.optim import build_optimizer

PAIRS = [(jteacher, tteacher), (jcofa, tcofa), (jofa, tofa), (jeval, teval), (jspec, tspec)]
JAX_ONLY = {"remat"}
PORT_ONLY = {"device"}
UPDATE_RTOL, FLOOR_RTOL = 2e-2, 1e-5
LR_SCALE = 1e-2
EXPORT_TOL = dict(rtol=1e-6, atol=1e-6)
CPU = ["--synthetic", "--device", "cpu"]
COMMON = ["--synthetic", "--base_batch_size", "8"]
CIFAR = COMMON + ["--image_size", "32", "--warmup_epochs", "0"]
IMAGENET = COMMON + ["--image_size", "32"]


@pytest.mark.parametrize("jmod,tmod", PAIRS, ids=[t.__name__.split(".")[-1] for _, t in PAIRS])
def test_defaults_match_jax(jmod, tmod):
    j, t = vars(jmod.build_args([])), vars(tmod.build_args([]))
    assert set(j) - JAX_ONLY == set(t) - PORT_ONLY
    assert {k: v for k, v in t.items() if k not in PORT_ONLY} == \
        {k: v for k, v in j.items() if k not in JAX_ONLY}
    assert t["device"] == "cuda"


def test_task_phases_match_jax():
    assert tofa.TASK_PHASES == jofa.TASK_PHASES


def _harness(mp):
    """The same harness in both packages: no dropout, JAX at one device,
    every schedule's LR times LR_SCALE, one synthetic training batch an
    epoch, and no warmup epochs in the kernel task's preset, so that each
    training run is one optimizer step (module docstring)."""
    for mod in (jteacher, jcofa, jofa):
        mp.setattr(mod, "OFAMobileNetV3", functools.partial(jcls.OFAMobileNetV3,
                                                            dropout_rate=0.0))
    for mod in (tteacher, tcofa, tofa):
        mp.setattr(mod, "OFAMobileNetV3", functools.partial(tcls.OFAMobileNetV3,
                                                            dropout_rate=0.0))
    mp.setattr(jax, "device_count", lambda *a, **k: 1)
    for mod in (jcls_rm, tcls_rm):
        mp.setattr(mod, "lr_at_step", functools.partial(_scaled_lr, mod.lr_at_step))
    for mod in (jofa, tofa):
        mp.setitem(mod.TASK_PHASES[("kernel", 1)], "warmup_epochs", 0)
    # the port's CIFAR supernet CLI takes the teacher CLI's provider
    for mod in (jteacher, jcofa, jofa, tteacher, tofa):
        mp.setattr(mod, "SyntheticClsProvider",
                   functools.partial(_one_batch_provider, mod.SyntheticClsProvider))


def _one_batch_provider(cls, **kw):
    """The CLI's synthetic provider with one training batch an epoch."""
    return cls(**dict(kw, n_train=kw["train_batch_size"]))


def _scaled_lr(lr_at_step, *a, **k):
    return LR_SCALE * lr_at_step(*a, **k)


def _jax_init(seed, **kw):
    net = jcls.OFAMobileNetV3(dropout_rate=0.0, **kw)
    p, s = net.init(jax.random.PRNGKey(seed))
    return net, p, s


def _save_pair(d, net, p, s, run=False):
    """The same weights as a JAX checkpoint under d/jax and a port one
    under d/port; `run`: as a run's resumable checkpoint at epoch 0 (the
    optimizer state fresh), else weights only."""
    if run:
        rc = JaxRunConfig(opt_type="sgd", weight_decay=3e-5)
        JaxClsRunManager(str(d / "jax"), net, rc, None, init=False, params=p,
                         state=s).save_model(epoch=0)
        tnet = tcls.OFAMobileNetV3(n_classes=net.n_classes, ks_list=net.space.ks_list,
                                   expand_list=net.space.expand_list,
                                   depth_list=net.space.depth_list, device="cpu")
        tnet.load_state_dict(mbv3_state_dict_from_jax(p, s))
        tckpt.save_checkpoint(str(d / "port" / "checkpoint"), {
            "epoch": 0, "best_acc": -1e9, "model": tnet.state_dict(),
            "optimizer": build_optimizer(tnet, "sgd", 3e-5).state_dict()})
        return str(d / "jax" / "checkpoint"), str(d / "port" / "checkpoint")
    jckpt.save_checkpoint(str(d / "jax"), {"params": p, "state": s})
    tckpt.save_checkpoint(str(d / "port"), {"model": mbv3_state_dict_from_jax(p, s)})
    return str(d / "jax"), str(d / "port")


def _jax_state_dict(path, template_net):
    p, s = template_net.init(jax.random.PRNGKey(0))
    ck = jckpt.load_checkpoint(path, template={"params": p, "state": s})
    return mbv3_state_dict_from_jax(ck["params"], ck["state"])


def _assert_checkpoints_close(jdir, tdir, init_dir, template_net, run_template=None):
    """The port run's checkpoint {"model"} against the JAX run's (params,
    state) through the bridge, tensor by tensor: the difference of the two
    within UPDATE_RTOL of what the run changed since `init_dir`'s weights
    (JAX's; `run_template` its net where it differs), plus FLOOR_RTOL of the
    tensor's own size."""
    ref = _jax_state_dict(jdir, template_net)
    init = _jax_state_dict(init_dir, run_template or template_net)
    got = tckpt.load_checkpoint(tdir)["model"]
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if "num_batches" in k:
            continue
        d = float((got[k].double() - v.double()).norm())
        u = float((v.double() - init[k].double()).norm()) if k in init and \
            init[k].shape == v.shape else float(v.double().norm())
        bound = UPDATE_RTOL * u + FLOOR_RTOL * (float(v.double().norm()) + 1.0)
        assert d <= bound, (k, d, u)


def _port_copy(jdir, template_net, out):
    """The JAX checkpoint at `jdir` as a port checkpoint directory `out`."""
    tckpt.save_checkpoint(str(out), {"model": _jax_state_dict(jdir, template_net)})
    return str(out)


@pytest.fixture(scope="module")
def cifar_chain(tmp_path_factory):
    """The teacher trainer resuming at epoch 1 of 2 from a seeded run
    checkpoint, then the elastic-kernel supernet with KD from it (2 subnets
    a step, warm-started from it leniently)."""
    d = tmp_path_factory.mktemp("cifar")
    t_net, p, s = _jax_init(0, n_classes=10, ks_list=[7], expand_list=[6], depth_list=[4])
    _save_pair(d / "teacher", t_net, p, s, run=True)
    _save_pair(d / "teacher_init", t_net, p, s)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _harness(mp)
        for side, mod, extra in (("jax", jteacher, ["--remat", "off"]), ("port", tteacher, CPU)):
            out["teacher", side] = mod.main(CIFAR + extra + [
                "--path", str(d / "teacher" / side), "--n_epochs", "2"])
        # the next run starts from the JAX teacher's weights on both sides
        teacher_ckpt = {"jax": str(d / "teacher" / "jax" / "checkpoint"),
                        "port": _port_copy(d / "teacher" / "jax" / "checkpoint", t_net,
                                           d / "teacher_jax_as_port")}
        for side, mod, extra in (("jax", jcofa, ["--remat", "off"]), ("port", tcofa, CPU)):
            t_ckpt = teacher_ckpt[side]
            out["ofa", side] = mod.main(CIFAR + extra + [
                "--path", str(d / "ofa" / side), "--n_epochs", "1", "--kd_ratio", "1.0",
                "--teacher_ckpt", t_ckpt, "--warmstart", t_ckpt,
                "--dynamic_batch_size", "2"])
    return d, out


def test_cifar_teacher_cli_matches_jax(cifar_chain):
    d, out = cifar_chain
    assert out["teacher", "port"] == out["teacher", "jax"]
    t_net = jcls.OFAMobileNetV3(n_classes=10, ks_list=[7], expand_list=[6], depth_list=[4])
    _assert_checkpoints_close(str(d / "teacher" / "jax" / "checkpoint"),
                              str(d / "teacher" / "port" / "checkpoint"),
                              str(d / "teacher_init" / "jax"), t_net)
    with open(d / "teacher" / "port" / "logs" / "valid_console.txt") as f:
        log = f.read()
    assert "Epoch 2:" in log and "Epoch 1:" not in log  # resumed at epoch 1


def test_cifar_ofa_cli_matches_jax(cifar_chain):
    d, out = cifar_chain
    assert out["ofa", "port"] == out["ofa", "jax"]
    net = jcls.OFAMobileNetV3(n_classes=10, ks_list=[3, 5, 7], expand_list=[6],
                              depth_list=[4])
    t_net = jcls.OFAMobileNetV3(n_classes=10, ks_list=[7], expand_list=[6], depth_list=[4])
    _assert_checkpoints_close(str(d / "ofa" / "jax" / "checkpoint"),
                              str(d / "ofa" / "port" / "checkpoint"),
                              str(d / "teacher" / "jax" / "checkpoint"), net, run_template=t_net)


@pytest.fixture(scope="module")
def imagenet_chain(tmp_path_factory):
    """train_ofa_net --task kernel (warm start and KD teacher from seeded
    checkpoints), then --task depth --phase 1 --warmstart from it."""
    d = tmp_path_factory.mktemp("imagenet")
    net = _jax_init(0, ks_list=[3, 5, 7], expand_list=[6], depth_list=[4])
    w = _save_pair(d / "warm", *net)
    t = _save_pair(d / "t", *_jax_init(1, ks_list=[7], expand_list=[6], depth_list=[4]))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _harness(mp)
        for i, (side, extra) in enumerate((("jax", ["--remat", "off"]), ("port", CPU))):
            mod = (jofa, tofa)[i]
            out["kernel", side] = mod.main(IMAGENET + extra + [
                "--path", str(d / "kernel" / side), "--task", "kernel", "--n_epochs", "1",
                "--warmstart", w[i], "--teacher_ckpt", t[i]])
        # the depth run and the evaluators start from the JAX runs' weights on
        # both sides
        kernel = [str(d / "kernel" / "jax" / "checkpoint"),
                  _port_copy(d / "kernel" / "jax" / "checkpoint", net[0], d / "kernel_as_port")]
        for i, (side, extra) in enumerate((("jax", ["--remat", "off"]), ("port", CPU))):
            out["depth", side] = (jofa, tofa)[i].main(IMAGENET + extra + [
                "--path", str(d / "depth" / side), "--task", "depth", "--phase", "1",
                "--n_epochs", "1", "--warmstart", kernel[i], "--teacher_ckpt", t[i]])
    _port_copy(d / "depth" / "jax" / "checkpoint", net[0], d / "depth_as_port")
    return d, out


def test_train_ofa_net_cli_matches_jax(imagenet_chain):
    d, out = imagenet_chain
    for task, depth_list, init in (("kernel", [4], d / "warm" / "jax"),
                                   ("depth", [3, 4], d / "kernel" / "jax" / "checkpoint")):
        net = jcls.OFAMobileNetV3(ks_list=[3, 5, 7], expand_list=[6], depth_list=depth_list)
        assert out[task, "port"] == out[task, "jax"], task
        _assert_checkpoints_close(str(d / task / "jax" / "checkpoint"),
                                  str(d / task / "port" / "checkpoint"), str(init), net)
    with open(d / "kernel" / "port" / "logs" / "valid_console.txt") as f:
        log = f.read()
    assert "Epoch 1:" in log and "Epoch 2:" not in log


@pytest.mark.parametrize("arch_seed", [3])
def test_eval_ofa_net_cli_matches_jax(imagenet_chain, tmp_path, arch_seed):
    """From the depth run's checkpoint (each package's own): BN recalibrated
    for the subnet, then validate, and --materialize's static subnet; with
    --export the port's artifact, whose logits equal the recalibrated
    materialized subnet's."""
    d, _ = imagenet_chain
    args = ["--synthetic", "--image_size", "32", "--arch_seed", str(arch_seed)]
    ckpt = {"jax": str(d / "depth" / "jax" / "checkpoint"),
            "port": str(d / "depth_as_port")}
    got = {}
    for mode in ("validate", "materialize"):
        extra = ["--materialize"] if mode == "materialize" else []
        j = jeval.main(args + extra + ["--path", str(tmp_path / "j"), "--checkpoint",
                                       ckpt["jax"]])
        got[mode] = teval.main(args + extra + ["--device", "cpu", "--path", str(tmp_path / "t"),
                                               "--checkpoint", ckpt["port"]])
        assert got[mode] == j, mode
    art = str(tmp_path / "sub.pt2")
    assert teval.main(args + ["--device", "cpu", "--path", str(tmp_path / "x"), "--checkpoint",
                              ckpt["port"], "--export", art]) == got["validate"]
    with open(tmp_path / "x" / "logs" / "valid_console.txt") as f:
        assert "exported %s" % art in f.read()
    # the CLI's recalibrated subnet, rebuilt: the artifact serves its logits
    net = ofa_net(checkpoint=ckpt["port"], device="cpu")
    arch = net.max_arch() if arch_seed < 0 else net.sample_arch(seed=arch_seed)
    rm = ClsRunManager(str(tmp_path / "r"), net, RunConfig(), SyntheticClsProvider(
        n_train=64, n_test=32, image_size=32, n_classes=1000, train_batch_size=32,
        test_batch_size=32))
    rm.reset_running_statistics(arch, n_images=64, batch_size=32)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(load_subnet(art, device="cpu")(x).numpy(),
                                   get_active_cls_subnet(net, arch)(x).numpy(), **EXPORT_TOL)


def test_eval_specialized_net_cli_matches_jax(imagenet_chain, tmp_path):
    """--supernet_checkpoint with --arch_config: the subnet sliced out of the
    depth run's supernet, validated; --export writes its artifact."""
    d, _ = imagenet_chain
    arch = {"ks": [5, 3, 7, 3] * 5, "e": [6] * 20, "d": [3, 4, 3, 4, 3]}
    cfg = tmp_path / "arch.json"
    cfg.write_text(json.dumps(arch))
    args = ["--synthetic", "--image_size", "32", "--arch_config", str(cfg)]
    j = jspec.main(args + ["--supernet_checkpoint", str(d / "depth" / "jax" / "checkpoint")])
    art = str(tmp_path / "spec.pt2")
    t = tspec.main(args + ["--device", "cpu", "--supernet_checkpoint",
                           str(d / "depth_as_port"), "--export", art])
    assert t == j
    # the artifact serves the same logits as the static net
    sup = ofa_net(checkpoint=str(d / "depth_as_port"), device="cpu")
    static, _ = ofa_specialized("flops@595M_top1@80.0_finetune@75", supernet=sup,
                                arch=tcls.ClsArch(tuple(arch["ks"]), tuple(arch["e"]),
                                                  tuple(arch["d"])), device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(load_subnet(art, device="cpu")(x).numpy(),
                                   static(x).numpy(), **EXPORT_TOL)
