"""The port's search-and-deploy demo (ofa_sr_tpu_torch/exp/search_deploy_demo.py)
on the CPU: the whole demo on the expand checkpoint of a tiny curriculum
chain in both quality modes; its search against JAX's finder on the port's
table (the same winner), its deployments' recalibrated PSNR-Y against
JAX's run manager on the same weights (rtol 1e-5), and its pure parts
against the JAX package exactly: the decoder MACs against the sum through
JAX's `_conv_macs`, and `lut_efficiency_fn` with `stage_range` against
JAX's on one hand-built table.

On the CPU the host clock times the table, and under parallel test workers
an entry can read several times its time (one run read the smallest
uniform subnet at 2.4x the largest, and the demo refused the budget), so
the demo runs here with `measure_latency_device` counting each call's
FLOPs instead (`_flop_ms`): the same table every run. The stem, final
convs and shuffle stages take most of a small subnet's work, so the demo
runs at a budget of 0.9 of the largest subnet's table time (the default
0.6 admits no subnet at this size: the demo refuses it).
"""

import math
import os

import numpy as np
import pytest
import torch

from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu.search import flops as jflops
from ofa_sr_tpu.search import latency as jlatency
from ofa_sr_tpu_torch.exp import curriculum as pcur
from ofa_sr_tpu_torch.exp import search_deploy_demo as demo
from ofa_sr_tpu_torch.models import SearchSpace
from ofa_sr_tpu_torch.models.arch import sample_subnet
from ofa_sr_tpu_torch.search import latency as platency

CHAIN = ["--n_train", "4", "--n_val", "2", "--img", "32", "--crop", "8", "--bs", "2",
         "--teacher_epochs", "1", "--pretrain_epochs", "1", "--phase_epochs", "1",
         "--style", "sharp", "--device", "cpu"]
DEMO = ["--device", "cpu", "--hr", "16", "--crop", "8", "--constraint_frac", "0.9"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Full-width X4 at 4-16 px: one thread is faster and keeps parallel
    test workers off each other's cores; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("curriculum"))
    pcur.main(["--out", out] + CHAIN)
    return out


def _flop_ms(fn, x, **kw):
    """`measure_latency_device`'s stand-in: one call of `fn`, 1 ms a GFLOP
    of the FLOPs it runs (`FlopCounterMode`), free of the host's load."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(x)
    return counter.get_total_flops() / 1e9


@pytest.fixture(scope="module")
def reports(chain, tmp_path_factory):
    """The demo's report on the chain in each quality mode, and its file."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(platency, "measure_latency_device", _flop_ms)
        for quality in ("macs", "psnr"):
            path = str(tmp_path_factory.mktemp("demo") / "demo.json")
            out[quality] = (demo.main(["--curriculum", chain, "--quality", quality, "--out",
                                       path] + DEMO), path)
    return out


@pytest.mark.parametrize("quality", ["macs", "psnr"])
def test_demo_on_the_chain(reports, quality):
    rep, out = reports[quality]
    assert os.path.isfile(out)
    assert rep["device_name"] == "cpu" and rep["quality"] == quality
    cands = rep["candidates"]
    assert sorted(cands) == ["searched", "uniform_max", "uniform_min"]
    assert cands["searched"]["lut_ms"] <= rep["constraint_ms"]
    assert rep["constraint_ms"] == pytest.approx(0.9 * cands["uniform_max"]["lut_ms"])
    for name, c in cands.items():
        assert math.isfinite(c["psnr_db"]), name
        assert c["true_ms"] > 0 and c["dec_gmacs"] > 0, name
    space = demo.expand_space()
    assert cands["uniform_min"]["dec_gmacs"] < cands["uniform_max"]["dec_gmacs"]
    # the decoder table: a block entry per (ks, e) and the head and tail
    assert len(rep["lut"]) == len(space.ks_list) * len(space.expand_list) + 1
    assert len(rep["history"]) == demo.POPULATIONS[quality][1] + 1


def _jax_dec_macs(jspace, cfg, lr):
    """exp/search_deploy_demo.py's dec_macs, through JAX's `_conv_macs`."""
    w, total = jspace.width, 0
    for si in range(jspace.n_stages, 2 * jspace.n_stages):
        for i in range(cfg.d[si]):
            bi = si * jspace.max_depth + i
            mid = jspace.mid_channels(cfg.e[bi])
            total += (jflops._conv_macs(lr, lr, w, mid, 1)
                      + jflops._conv_macs(lr, lr, mid, mid, cfg.ks[bi], groups=mid)
                      + jflops._conv_macs(lr, lr, mid, w, 1))
    return total


def _spaces():
    space = demo.expand_space()
    kw = dict(ks_list=space.ks_list, expand_list=space.expand_list,
              depth_list=space.depth_list, pixel_d_list=space.pixel_d_list)
    return space, jarch.SearchSpace(**kw)


def test_dec_macs_matches_jax():
    space, jspace = _spaces()
    for seed in range(16):
        cfg = sample_subnet(space, seed=seed, n_trunks=2)
        jcfg = jarch.sample_subnet(jspace, seed=seed, n_trunks=2)
        assert (cfg.ks, cfg.e, cfg.d, cfg.pixel_d) == (jcfg.ks, jcfg.e, jcfg.d, jcfg.pixel_d)
        for lr in (24, 180):
            assert demo.dec_macs(space, cfg, lr) == _jax_dec_macs(jspace, jcfg, lr)


def test_lut_efficiency_stage_range_matches_jax():
    space = SearchSpace()
    jspace = jarch.SearchSpace()
    rng = np.random.RandomState(7)
    hr, w = 96, space.width
    table = platency.LatencyTable()
    for pd in space.pixel_d_list:
        lr = hr // 2 ** pd
        for k in space.ks_list:
            for e in space.expand_list:
                table.set("expanded_conv", [lr, lr, w], [lr, lr, w], float(rng.rand()),
                          kernel=k, expand=e)
        table.set("sr_head_tail", [lr, lr, 3], [hr, hr, 3], float(rng.rand()), pixel_d=pd)
    jtable = jlatency.LatencyTable(dict(table.table))
    for stage_range in ((space.n_stages, 2 * space.n_stages), (0, space.n_stages), None):
        fn = platency.lut_efficiency_fn(table, space, hr_size=hr, n_trunks=2,
                                        stage_range=stage_range)
        jfn = jlatency.lut_efficiency_fn(jtable, jspace, hr_size=hr, n_trunks=2,
                                         stage_range=stage_range)
        for seed in range(16):
            cfg = sample_subnet(space, seed=seed, n_trunks=2)
            assert fn(cfg) == jfn(jarch.sample_subnet(jspace, seed=seed, n_trunks=2))


def test_search_matches_jax_finder(reports):
    """The port's decoder table, loaded into JAX's `LatencyTable`, with
    JAX's `lut_efficiency_fn`, JAX's MACs sum and JAX's `EvolutionFinder`
    at the demo's population and seed: the same budget and the same
    winner as the demo's `--quality macs` search."""
    from ofa_sr_tpu.search import EvolutionFinder as JaxFinder
    rep = reports["macs"][0]
    space, jspace = _spaces()
    hr = rep["hr"]
    lr = hr // 2 ** max(jspace.pixel_d_list)
    jeff = jlatency.lut_efficiency_fn(jlatency.LatencyTable(dict(rep["lut"])), jspace,
                                      hr_size=hr, n_trunks=2,
                                      stage_range=(jspace.n_stages, 2 * jspace.n_stages))
    big = jarch.uniform_subnet(jspace, 7, 6, 4, 2, n_trunks=2)
    constraint = rep["constraint_frac"] * jeff(big)
    assert constraint == rep["constraint_ms"]
    pop, gens = demo.POPULATIONS["macs"]
    winner, _, history = JaxFinder(jspace, efficiency_fn=jeff,
                                   quality_fn=lambda c: _jax_dec_macs(jspace, c, lr),
                                   n_trunks=2, population_size=pop, max_time_budget=gens,
                                   seed=0).run(constraint)
    got = rep["winner"]
    assert (list(winner.ks), list(winner.e), list(winner.d), winner.pixel_d) == \
        (got["ks"], got["e"], got["d"], got["pixel_d"])
    assert history == rep["history"]


def test_deployed_psnr_matches_jax(chain, reports):
    """The three deployments' PSNR-Y after BN recalibration on the train
    split, against JAX's run manager on the same weights (the expand
    checkpoint through `import_torch_x4`) and the same image tree: within
    rtol 1e-5 (the recalibrated statistics agree to ~1e-6 absolute,
    tests/test_torch_run_manager.py)."""
    from ofa_sr_tpu.data import Div2KSetXXProvider as JaxProvider
    from ofa_sr_tpu.models import OFAMobileNetX4 as JaxX4
    from ofa_sr_tpu.train import RunConfig as JaxRunConfig
    from ofa_sr_tpu.train import SRRunManager as JaxRunManager
    from ofa_sr_tpu.train.checkpoint import import_torch_x4
    from ofa_sr_tpu_torch.train.checkpoint import checkpoint_state_dict, load_checkpoint
    rep = reports["macs"][0]
    _, jspace = _spaces()
    crop = int(DEMO[DEMO.index("--crop") + 1])
    provider = JaxProvider(root=os.path.join(chain, "data"), image_size=crop,
                           train_batch_size=4, num_workers=2)
    jnet = JaxX4(jspace)
    sd = checkpoint_state_dict(load_checkpoint(os.path.join(chain, "port", "expand",
                                                            "checkpoint")))
    # the run manager on the imported weights, without drawing an init
    # first (init=False keeps the params and state already set)
    rm = JaxRunManager.__new__(JaxRunManager)
    rm.params, rm.state = import_torch_x4(sd, jnet)
    rm.__init__(os.path.join(chain, "jax_eval"), jnet,
                JaxRunConfig(image_size=crop, manual_seed=0, bn_recalib_before_eval=True),
                provider, init=False)
    w = rep["winner"]
    cfgs = {"uniform_min": jarch.uniform_subnet(jspace, 3, 3, 2, 2, n_trunks=2),
            "uniform_max": jarch.uniform_subnet(jspace, 7, 6, 4, 2, n_trunks=2),
            "searched": jarch.SubnetConfig(ks=tuple(w["ks"]), e=tuple(w["e"]),
                                           d=tuple(w["d"]), pixel_d=w["pixel_d"])}
    for name, cfg in cfgs.items():
        _, ref = rm.validate(cfg, recalib_loader=provider.train)
        got = rep["candidates"][name]["psnr_db"]
        assert got == pytest.approx(float(ref), rel=1e-5), (name, got, ref)


def test_demo_refuses_a_partial_checkpoint(chain, tmp_path):
    """A checkpoint that leaves a tensor of the expand space's X4 at its
    init (the pretrain's: no kernel-transform matrices) is refused, not
    scored as trained."""
    import shutil
    shutil.copytree(os.path.join(chain, "port", "pretrain", "checkpoint"),
                    tmp_path / "port" / "expand" / "checkpoint")
    shutil.copytree(os.path.join(chain, "data"), tmp_path / "data")
    with pytest.raises(ValueError, match="does not hold every tensor"):
        demo.main(["--curriculum", str(tmp_path)] + DEMO)


def test_demo_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        demo.main(["--curriculum", str(tmp_path)])
