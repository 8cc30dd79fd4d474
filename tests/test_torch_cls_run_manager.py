"""The port's classification run manager, data and model zoo
(ofa_sr_tpu_torch/train/cls_run_manager.py, bn_recalib.py on a
classification net, data/cls_providers.py, model_zoo.py) against the JAX
package's on the CPU, from the same weights (the JAX init with random BN,
through the weight bridge) and the same data.

The net is tests/test_torch_cls_train.py's narrow one (dropout 0); the
data 32 px synthetic batches of 8, a CIFAR-10 pickle directory and a PNG
class tree that the tests write from a seed.

Tolerances:
- `ClsRunManager` over 2 epochs of 2 SGD steps of 2 subnets: the sampled
  archs exact, per-epoch train loss and top-1 rtol 1e-5, best accuracy
  exact (a mean of whole hits), final parameters and running statistics
  rtol 1e-5 / atol 1e-4 (test_torch_cls_train.py's float32 step noise,
  over twice the steps); resume and `load_weights` exact;
- `reset_running_statistics` against JAX `bn_recalibrate`: rtol and atol
  1e-5;
- the datasets' arrays for the same index and epoch, the ElasticResolution
  sequence, the model zoo's catalog and routing: exact;
- one epoch of `ClsRunManager(mesh=)` over two gloo ranks (half the global
  batch each) against JAX's run on the whole batch: train loss and top-1
  rtol 1e-5, parameters as above, the ranks' parameters equal bit for
  bit.
"""

import dataclasses
import json
import os
import pickle
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu import model_zoo as jzoo
from ofa_sr_tpu.data import cls_providers as jdata
from ofa_sr_tpu.data import providers as jproviders
from ofa_sr_tpu.models import net_config as jnc
from ofa_sr_tpu.train import checkpoint as jckpt
from ofa_sr_tpu.train.cls_run_manager import ClsRunManager as JaxClsRunManager
from ofa_sr_tpu.train.run_manager import RunConfig as JaxRunConfig
from ofa_sr_tpu_torch import model_zoo as tzoo
from ofa_sr_tpu_torch.data import cls_providers as tdata
from ofa_sr_tpu_torch.data import providers as tproviders
from ofa_sr_tpu_torch.models import net_config as tnc
from ofa_sr_tpu_torch.models import ofa_cls as tcls
from ofa_sr_tpu_torch.train import ClsRunManager, RunConfig
from ofa_sr_tpu_torch.train import checkpoint as tckpt
from ofa_sr_tpu_torch.train.checkpoint import mbv3_state_dict_from_jax
from rank_launch import launch
from test_torch_cls_train import jax_narrow, port_narrow, tarch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-4)
RECAL_TOL = dict(rtol=1e-5, atol=1e-5)
RC_KW = dict(n_epochs=2, base_lr=0.05, warmup_epochs=0, opt_type="sgd", weight_decay=3e-5,
             train_batch_size=8, dynamic_batch_size=2, print_frequency=1, manual_seed=0)
PROVIDER_KW = dict(n_train=16, n_test=8, image_size=32, n_classes=10, train_batch_size=8,
                   test_batch_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_weights_close(net, p, s, tol=PARAM_TOL):
    ref, got = mbv3_state_dict_from_jax(p, s), net.state_dict()
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if "num_batches" not in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **tol)


def managers(tmp_path, **rc):
    jnet, p, s = jax_narrow()
    kw = dict(RC_KW, **rc)
    jrm = JaxClsRunManager(str(tmp_path / "jax"), jnet, JaxRunConfig(**kw),
                           jdata.SyntheticClsProvider(**PROVIDER_KW), init=False, params=p,
                           state=s)
    trm = ClsRunManager(str(tmp_path / "port"), port_narrow(p, s), RunConfig(**kw),
                        tdata.SyntheticClsProvider(**PROVIDER_KW))
    return jrm, trm


# -- the run manager --------------------------------------------------------------

@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory):
    """Both managers after train() over 2 epochs (with the per-epoch train
    metrics of each, recorded around train_one_epoch)."""
    tmp = tmp_path_factory.mktemp("cls_rm")
    jrm, trm = managers(tmp)
    for rm in (jrm, trm):
        rm.epoch_metrics = []
        inner = rm.train_one_epoch

        def record(epoch, constraints=None, rm=rm, inner=inner):
            out = inner(epoch, constraints)
            rm.epoch_metrics.append(out)
            return out
        rm.train_one_epoch = record
    return tmp, jrm, trm, jrm.train(), trm.train()


def test_sample_archs_match_jax(tmp_path):
    jrm, trm = managers(tmp_path)
    cons = dict(ks_candidates=[5], depth_candidates=[1, 2])
    for epoch, n_batch, i, c in ((0, 2, 0, None), (1, 2, 1, None), (3, 7, 5, cons)):
        _, jd = jrm.sample_archs(epoch, n_batch, i, c)
        td = trm.sample_archs(epoch, n_batch, i, c)
        assert [dataclasses.astuple(a) for a in td] == [dataclasses.astuple(a) for a in jd]


def test_two_epochs_match_jax(two_epochs):
    """Per-epoch train loss and top-1, the best accuracy, the final
    parameters and running statistics, the files written."""
    tmp, jrm, trm, jbest, tbest = two_epochs
    np.testing.assert_allclose(trm.epoch_metrics, jrm.epoch_metrics, **EPOCH_TOL)
    assert tbest == jbest and trm.best_acc == jrm.best_acc
    assert_weights_close(trm.net, jrm.params, jrm.state)
    for f in ("checkpoint/checkpoint.pth.tar", "checkpoint/latest.txt",
              "checkpoint/model_best.pth.tar", "logs/train_console.txt",
              "logs/valid_console.txt"):
        assert os.path.isfile(tmp / "port" / f), f
    with open(tmp / "port" / "logs" / "train_console.txt") as f:
        assert [line.split("]")[0] for line in f] == ["Train [1", "Train [1", "Train [2",
                                                       "Train [2"]
    np.testing.assert_allclose(trm.validate(), jrm.validate(), **EPOCH_TOL)


def test_resume_and_load_weights(two_epochs, tmp_path):
    """load_model restores the run (net, optimizer, start_epoch, best_acc)
    exactly; load_weights warm-starts leniently, as JAX's does: from a
    ks5/e3/d2 checkpoint the matching tensors come over and the rest keep
    their init."""
    tmp, jrm, trm, _, _ = two_epochs
    _, fresh = managers(tmp_path)
    fresh.load_model(str(tmp / "port" / "checkpoint"))
    assert fresh.start_epoch == 2 and fresh.best_acc == trm.best_acc
    assert all(torch.equal(a, b) for a, b in zip(fresh.net.state_dict().values(),
                                                 trm.net.state_dict().values()))
    assert fresh.trainer.opt.state_dict()["state"].keys() == \
        trm.trainer.opt.state_dict()["state"].keys()
    # nothing to resume: the run starts fresh
    _, empty = managers(tmp_path / "empty")
    empty.load_model()
    assert empty.start_epoch == 0
    # lenient warm start from another space, in both packages
    t_jnet, tp, ts = jax_narrow(seed=3, ks_list=[5], expand_list=[3], depth_list=[2])
    jckpt.save_checkpoint(str(tmp_path / "jt"), {"params": tp, "state": ts})
    tckpt.save_checkpoint(str(tmp_path / "tt"), {"model": mbv3_state_dict_from_jax(tp, ts)})
    jrm2, trm2 = managers(tmp_path / "warm")
    jrm2.load_weights(str(tmp_path / "jt"))
    trm2.load_weights(str(tmp_path / "tt"))
    assert_weights_close(trm2.net, jrm2.params, jrm2.state, tol=dict(rtol=0, atol=0))


def test_reset_running_statistics_matches_jax(tmp_path):
    """ClsRunManager.reset_running_statistics (bn_recalibrate on a
    classification net, no pixel_d) against JAX's, for a sampled arch: the
    touched statistics recalibrated, the rest kept."""
    jrm, trm = managers(tmp_path)
    arch = jrm.net.sample_arch(seed=4)
    jrm.reset_running_statistics(arch, n_images=12, batch_size=8)  # batches of 8 and 4
    trm.reset_running_statistics(tarch(arch), n_images=12, batch_size=8)
    assert_weights_close(trm.net, jrm.params, jrm.state, tol=RECAL_TOL)


# -- the data ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    """A cifar-10-batches-py directory of 4 seeded images a batch file."""
    root = tmp_path_factory.mktemp("cifar")
    base = root / "cifar-10-batches-py"
    base.mkdir()
    r = np.random.RandomState(11)
    for name in ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": r.randint(0, 256, (4, 3072)).astype(np.uint8),
             b"labels": r.randint(0, 10, 4).tolist()}
        with open(base / name, "wb") as f:
            pickle.dump(d, f)
    return str(root)


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """<root>/{train,val}/<class>/*.png: 2 classes, seeded images of
    assorted sizes."""
    from PIL import Image
    root = tmp_path_factory.mktemp("imagenet")
    r = np.random.RandomState(12)
    for split, n in (("train", 5), ("val", 2)):
        for c in ("n01", "n02"):
            d = root / split / c
            d.mkdir(parents=True)
            for i in range(n):
                h, w = r.randint(24, 48), r.randint(24, 48)
                Image.fromarray(r.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
                    d / ("%d.png" % i))
    return str(root)


def _batches(loader, epoch):
    loader.set_epoch(epoch)
    return list(loader)


def assert_batches_equal(tl, jl, epochs=(0, 1)):
    for e in epochs:
        tb, jb = _batches(tl, e), _batches(jl, e)
        assert len(tb) == len(jb) > 0
        for t, j in zip(tb, jb):
            assert t.keys() == j.keys()
            for k in t:
                assert t[k].dtype == j[k].dtype, k
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("image_size", [32, 40])
def test_cifar10_provider_matches_jax(cifar_root, image_size):
    """Pad-4 reflect crop and flip from each sample's rng; at 40 px the PIL
    bicubic resize."""
    kw = dict(root=cifar_root, image_size=image_size, train_batch_size=4, test_batch_size=4,
              num_workers=1)
    tp, jp = tdata.Cifar10Provider(**kw), jdata.Cifar10Provider(**kw)
    assert_batches_equal(tp.train, jp.train)
    assert_batches_equal(tp.test, jp.test, epochs=(0,))
    np.testing.assert_array_equal(tp._train_ds.labels, jp._train_ds.labels)
    for i in (0, 7):
        for ep in (0, 3):
            t = tp._train_ds.__getitem__(i, rng=random.Random(ep * 1_000_003 + i))
            j = jp._train_ds.__getitem__(i, rng=random.Random(ep * 1_000_003 + i))
            np.testing.assert_array_equal(t["image"], j["image"])


def test_imagenet_provider_matches_jax(image_tree):
    """ImageFolderDataset through ImagenetProvider with ElasticResolution:
    the random-resized crop and flip at each batch's drawn size, the
    resize + center crop of the val split, the valid split, the
    calibration subset and assign_active_img_size."""
    sizes = [16, 24, 32]
    kw = dict(root=image_tree, image_size=32, train_batch_size=2, test_batch_size=2,
              num_workers=1)
    tp = tdata.ImagenetProvider(elastic=tproviders.ElasticResolution(sizes), **kw)
    jp = jdata.ImagenetProvider(elastic=jproviders.ElasticResolution(sizes), **kw)
    assert tp._train_ds.samples == jp._train_ds.samples
    assert_batches_equal(tp.train, jp.train)
    assert {b["image"].shape[1] for e in (0, 1) for b in _batches(tp.train, e)} != {32}
    assert_batches_equal(tp.test, jp.test, epochs=(0,))
    assert_batches_equal(tp.build_sub_train_loader(6, 4), jp.build_sub_train_loader(6, 4),
                         epochs=(0,))
    tv = tdata.ImagenetProvider(valid_size=4, **kw)
    jv = jdata.ImagenetProvider(valid_size=4, **kw)
    assert_batches_equal(tv.valid, jv.valid, epochs=(0,))
    assert_batches_equal(tv.train, jv.train, epochs=(2,))
    tv.assign_active_img_size(24)
    jv.assign_active_img_size(24)
    assert_batches_equal(tv.train, jv.train, epochs=(0,))


def test_synthetic_provider_matches_jax():
    tp, jp = tdata.SyntheticClsProvider(**PROVIDER_KW), jdata.SyntheticClsProvider(**PROVIDER_KW)
    assert_batches_equal(tp.train, jp.train)
    assert_batches_equal(tp.test, jp.test, epochs=(0,))
    assert tp.name() == jp.name() == "synthetic_cls"


@pytest.mark.parametrize("continuous", [False, True])
def test_elastic_resolution_sequence_matches_jax(continuous):
    sizes = [128, 160, 192, 224]
    t = tproviders.ElasticResolution(sizes, continuous=continuous)
    j = jproviders.ElasticResolution(sizes, continuous=continuous)
    assert t.candidates() == j.candidates()
    assert [t.sample(b, e) for e in range(3) for b in range(40)] == \
        [j.sample(b, e) for e in range(3) for b in range(40)]


# -- the model zoo ----------------------------------------------------------------

NET_IDS = ("ofa_mbv3_d234_e346_k357_w1.0", "ofa_mbv3_d234_e346_k357_w1.2",
           "ofa_proxyless_d234_e346_k357_w1.3")


def test_catalog_matches_jax():
    assert tzoo.SPECIALIZED_CATALOG == jzoo.SPECIALIZED_CATALOG
    assert len(tzoo.SPECIALIZED_CATALOG) == 50


@pytest.mark.parametrize("net_id", NET_IDS)
def test_ofa_net_ids_match_jax(net_id):
    t, (j, _, _) = tzoo.ofa_net(net_id, device="cpu"), jzoo.ofa_net(net_id)
    assert type(j).__name__ == "ElasticClassifierNet" and t.n_classes == j.n_classes == 1000
    for attr in ("width_mult_list", "stage_width_lists", "first_conv_widths",
                 "feature_mix_widths", "final_expand_width", "n_blocks"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.space.ks_list == [3, 5, 7] and t.space.depth_list == [2, 3, 4]


def test_ofa_net_routing(tmp_path):
    """Unknown ids raise in both packages; the SR ids build the full-width
    S4 and X4; a checkpoint loads strictly: the port's run checkpoint (a
    directory through latest.txt) and a reference state_dict file."""
    for bad in ("ofa_s4_d2_e3", "resnet50"):
        with pytest.raises(ValueError):
            tzoo.ofa_net(bad, device="cpu")
        with pytest.raises(ValueError):
            jzoo.ofa_net(bad)
    s4 = tzoo.ofa_net("ofa_s4_d234_e346_k357_pd12", device="cpu")
    x4 = tzoo.ofa_net("ofa_x4_d234_e346_k357_pd12", device="cpu")
    assert (type(s4).__name__, type(x4).__name__) == ("OFAMobileNetS4", "OFAMobileNetX4")
    assert s4.space.width == 64 and x4.n_trunks == 2
    # a reference-layout state_dict (prefixed as a DataParallel save) in a .pth.tar
    sd = {"module." + k: v + 1 if v.is_floating_point() else v
          for k, v in s4.state_dict().items()}
    torch.save({"state_dict": sd}, tmp_path / "ref.pth.tar")
    got = tzoo.ofa_net("ofa_s4_d234_e346_k357_pd12", checkpoint=str(tmp_path / "ref.pth.tar"),
                       device="cpu")
    assert all(torch.equal(got.state_dict()[k], v) for k, v in
               ((k[len("module."):], v) for k, v in sd.items()))
    net = tzoo.ofa_net(NET_IDS[0], device="cpu")
    with torch.no_grad():
        net.classifier.linear.bias.fill_(0.5)
    tckpt.save_checkpoint(str(tmp_path / "run"), {"epoch": 0, "model": net.state_dict()})
    got = tzoo.ofa_net(NET_IDS[0], checkpoint=str(tmp_path / "run"), device="cpu")
    assert torch.equal(got.classifier.linear.bias, net.classifier.linear.bias)
    with pytest.raises(RuntimeError):  # strict: an MBV3 checkpoint does not fit Proxyless
        tzoo.ofa_net(NET_IDS[2], checkpoint=str(tmp_path / "run"), device="cpu")


def test_ofa_specialized_matches_jax(tmp_path):
    """The three architecture sources: a supernet and an arch, a
    net.config (dict or file, with 'init' weights), and a root mirror with
    run.config's image size; the same net.config and logits as JAX's."""
    nid = "note10_lat@22ms_top1@76.6_finetune@25"
    jnet = jzoo.ofa_net(NET_IDS[0])[0]
    p, s = jnet.init(jax.random.PRNGKey(1))
    tnet = tcls.OFAMobileNetV3(device="cpu")
    tnet.load_state_dict(mbv3_state_dict_from_jax(p, s))
    arch = jnet.sample_arch(seed=2)
    js_net, jsp, jss, jexp = jzoo.ofa_specialized(nid, supernet=(jnet, p, s), arch=arch)
    static, texp = tzoo.ofa_specialized(nid, supernet=tnet, arch=tarch(arch), device="cpu")
    assert texp == jexp and static.config == js_net.config
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        y = static(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(js_net.apply(jsp, jss, jnp.asarray(x))[0]),
                               rtol=1e-4, atol=1e-4)
    # a root mirror: net.config, run.config (image size) and the init weights
    d = tmp_path / nid
    d.mkdir()
    (d / "net.config").write_text(json.dumps(static.config))
    (d / "run.config").write_text(json.dumps({"image_size": 192}))
    torch.save({"state_dict": static.state_dict()}, d / "init")
    mirrored, mexp = tzoo.ofa_specialized(nid, root=str(tmp_path), device="cpu")
    assert mexp["image_size"] == 192 == jzoo.ofa_specialized(nid, root=str(tmp_path))[3][
        "image_size"]
    assert all(torch.equal(a, b) for a, b in zip(mirrored.state_dict().values(),
                                                 static.state_dict().values()))
    from_cfg, _ = tzoo.ofa_specialized(nid, net_config=str(d / "net.config"), device="cpu")
    assert from_cfg.config == tnc.get_active_net_config(tnet, tarch(arch)) == \
        jnc.get_active_net_config(jnet, arch)
    for mod in (tzoo, jzoo):
        with pytest.raises(ValueError):
            mod.ofa_specialized(nid)
        with pytest.raises(ValueError):
            mod.ofa_specialized("no_such_net", net_config=static.config)


# -- two ranks --------------------------------------------------------------------

RANK_BODY = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from ofa_sr_tpu_torch.parallel import init_distributed, make_mesh
rank, world = init_distributed(device="cpu", timeout_s=120)
mesh = make_mesh("cpu")
d = sys.argv[1]
from ofa_sr_tpu_torch.data import SyntheticClsProvider
from ofa_sr_tpu_torch.models import ElasticClassifierNet, StageSpec
from ofa_sr_tpu_torch.train import ClsRunManager, RunConfig
spec = json.load(open(os.path.join(d, "spec.json")))
kw = spec["net"]
kw["stage_specs"] = [StageSpec(*s) for s in kw["stage_specs"]]
net = ElasticClassifierNet(device="cpu", **kw)
state = torch.load(os.path.join(d, "net.pt"))
if rank == 1:  # rank 0's weights must reach every rank
    state = {k: v + 1 if v.is_floating_point() else v for k, v in state.items()}
net.load_state_dict(state)
rm = ClsRunManager(os.path.join(d, "run_%d" % rank), net, RunConfig(**spec["rc"]),
                   SyntheticClsProvider(**spec["provider"]), mesh=mesh)
tr = rm.train_one_epoch(0)
rm.save_model(epoch=0)
torch.save(net.state_dict(), os.path.join(d, "after_%d.pt" % rank))
json.dump({"train": tr, "valid": rm.validate()}, open(os.path.join(d, "out_%d.json" % rank), "w"))
"""


def test_two_ranks_match_jax_global_batch(tmp_path):
    """One epoch of ClsRunManager(mesh=) over two gloo ranks, each on half
    of every global batch of 8 (rank 1 started from other weights: rank 0's
    are broadcast), against JAX's run on the whole batches: the train loss
    and top-1, validation, the parameters, rank 0 alone writing."""
    from test_torch_cls_train import narrow_kw
    jnet, p, s = jax_narrow()
    torch.save(mbv3_state_dict_from_jax(p, s), tmp_path / "net.pt")
    nk = narrow_kw()
    nk["stage_specs"] = [dataclasses.astuple(sp) for sp in nk["stage_specs"]]
    rc = dict(RC_KW, n_epochs=1)
    (tmp_path / "spec.json").write_text(json.dumps({"net": nk, "rc": rc,
                                                    "provider": PROVIDER_KW}))
    script = tmp_path / "rank.py"
    script.write_text(RANK_BODY)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    launch([sys.executable, str(script), str(tmp_path)], 2, timeout=240, env=env)
    jrm = JaxClsRunManager(str(tmp_path / "jax"), jnet, JaxRunConfig(**rc),
                           jdata.SyntheticClsProvider(**PROVIDER_KW), init=False, params=p,
                           state=s)
    jtr = jrm.train_one_epoch(0)
    jva = jrm.validate()
    outs = [json.load(open(tmp_path / ("out_%d.json" % r))) for r in range(2)]
    for o in outs:
        np.testing.assert_allclose(o["train"], jtr, **EPOCH_TOL)
        np.testing.assert_allclose(o["valid"], jva, **EPOCH_TOL)
    after = [torch.load(tmp_path / ("after_%d.pt" % r)) for r in range(2)]
    assert all(torch.equal(after[0][k], after[1][k]) for k in after[0])
    net = port_narrow(p, s)
    net.load_state_dict(after[0])
    assert_weights_close(net, jrm.params, jrm.state)
    assert os.path.isfile(tmp_path / "run_0" / "checkpoint" / "checkpoint.pth.tar")
    assert not os.path.exists(tmp_path / "run_1")
