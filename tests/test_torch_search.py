"""The port's subnet search (ofa_sr_tpu_torch/search/, entry.search)
against the JAX package's on the CPU.

Tolerances: FLOPs, parameter counts, encodings, the finder's winner, score
and history, the table keys and the slope helpers exact; the predictor's
forward with the JAX weights carried over atol 1e-5 (float32 matmuls in
another order); `fit` from the same start, final loss and predictions rtol
1e-3 after 40 Adam steps (the losses agree to 2e-7 after the first 4; a
longer fit drives the loss toward 0, where the same float32 differences
become a large relative one: 0.4% on a loss of 0.004 after 80 steps). Latency values are
timings: only their keys, counts and sign are compared.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from ofa_sr_tpu.models import OFAMobileNetS4 as JaxS4
from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu.search import AccuracyPredictor as JaxPredictor
from ofa_sr_tpu.search import EvolutionFinder as JaxFinder
from ofa_sr_tpu.search import FLOPsTable as JaxFLOPsTable
from ofa_sr_tpu.search import LatencyTable as JaxLatencyTable
from ofa_sr_tpu.search import encoder as jenc
from ofa_sr_tpu.search import flops as jflops
from ofa_sr_tpu.search import latency as jlat
from ofa_sr_tpu_torch import entry
from ofa_sr_tpu_torch import search as tsearch
from ofa_sr_tpu_torch.data import SyntheticSRProvider
from ofa_sr_tpu_torch.models import (
    OFAMobileNetS4,
    OFAMobileNetX4,
    SearchSpace,
    get_active_subnet,
    sample_subnet,
    uniform_subnet,
)
from ofa_sr_tpu_torch.search import latency as tlat

SPACE = SearchSpace()
JSPACE = jarch.SearchSpace()
TINY_KW = dict(ks_list=[3, 5], expand_list=[2, 3], depth_list=[1, 2], pixel_d_list=[1, 2],
               n_stages=2, width=8)


def _jcfg(cfg):
    return jarch.SubnetConfig(cfg.ks, cfg.e, cfg.d, cfg.pixel_d)


def _fields(cfg):
    return cfg.ks, cfg.e, cfg.d, cfg.pixel_d


def _cfgs(n_trunks=1, n=12):
    return [sample_subnet(SPACE, seed=s, n_trunks=n_trunks) for s in range(n)] + [
        uniform_subnet(SPACE, 7, 6, 4, 2, n_trunks=n_trunks),
        uniform_subnet(SPACE, 3, 3, 2, 1, n_trunks=n_trunks)]


# -- counts and encodings -----------------------------------------------------

@pytest.mark.parametrize("hr", [96, 720, (180, 320)])
def test_flops_params_and_table_match_jax(hr):
    table, jtable = tsearch.FLOPsTable(SPACE, hr_size=96), JaxFLOPsTable(JSPACE, hr_size=96)
    for cfg in _cfgs():
        assert tsearch.s4_subnet_flops(cfg, SPACE, hr_size=hr) == \
            jflops.s4_subnet_flops(_jcfg(cfg), JSPACE, hr_size=hr)
        assert tsearch.s4_subnet_params(cfg, SPACE) == jflops.s4_subnet_params(_jcfg(cfg), JSPACE)
        assert table.predict_efficiency(cfg) == jtable.predict_efficiency(_jcfg(cfg)) == \
            tsearch.s4_subnet_flops(cfg, SPACE)


def test_count_params_closed_form():
    """A fold_bn=False subnet's tensors are the closed form's convs and BN
    scales and biases plus each BN's running mean and variance (the JAX
    test's relation, here exact: the port counts tensors, not the blocks'
    "ks"/"mid" ints)."""
    net = OFAMobileNetS4(SPACE, device="cpu")
    for cfg in (uniform_subnet(SPACE, 5, 4, 3, 1), sample_subnet(SPACE, seed=3)):
        sub = get_active_subnet(net, cfg, fold_bn=False)
        bns = []

        def walk(t):
            if isinstance(t, dict):
                if "mean" in t and "var" in t:
                    bns.append(t)
                for v in t.values():
                    walk(v)
            elif isinstance(t, list):
                for v in t:
                    walk(v)
        walk(sub.params)
        stats = sum(b["mean"].numel() + b["var"].numel() for b in bns)
        assert tsearch.count_params(sub.params) - stats == tsearch.s4_subnet_params(cfg, SPACE)
    small = OFAMobileNetS4(SearchSpace(**TINY_KW), device="cpu")
    assert tsearch.count_params(small) == sum(t.numel() for t in small.state_dict().values())


@pytest.mark.parametrize("n_trunks", [1, 2])
def test_encoders_match_jax(n_trunks):
    for cfg in _cfgs(n_trunks):
        t = tsearch.encode_sr_subnet(cfg, SPACE, n_trunks=n_trunks)
        j = jenc.encode_sr_subnet(_jcfg(cfg), JSPACE, n_trunks=n_trunks)
        assert t.dtype == j.dtype and np.array_equal(t, j)
    rng = np.random.RandomState(0)
    for _ in range(5):
        ks, e = rng.choice([3, 5, 7], 20).tolist(), rng.choice([3, 4, 6], 20).tolist()
        d, size = rng.choice([2, 3, 4], 5).tolist(), int(rng.choice([160, 192, 224]))
        assert np.array_equal(tsearch.encode_cls_arch(ks, e, d, size),
                              jenc.encode_cls_arch(ks, e, d, size))


# -- the finder ----------------------------------------------------------------

def _lut_dict(space, hr):
    """A deterministic block table in the shared key format."""
    t = JaxLatencyTable()
    for i, pd in enumerate(space.pixel_d_list):
        lr = hr // 2 ** pd
        for k in space.ks_list:
            for e in space.expand_list:
                t.set("expanded_conv", [lr, lr, space.width], [lr, lr, space.width],
                      0.01 * k * e / (i + 1), kernel=k, expand=e)
        t.set("sr_head_tail", [lr, lr, 3], [hr, hr, 3], 1.5 - 0.5 * i, pixel_d=pd)
    return t.table


@pytest.mark.parametrize("n_trunks", [1, 2])
def test_evolution_finder_matches_jax(n_trunks):
    """The same seed and functions: the same winner, score and history, and
    the same random stream consumed (S4; X4 with both trunks' genes and the
    decoder billed)."""
    table = _lut_dict(SPACE, 96)
    eff = tsearch.lut_efficiency_fn(tsearch.LatencyTable(dict(table)), SPACE, n_trunks=n_trunks)
    jeff = jlat.lut_efficiency_fn(JaxLatencyTable(dict(table)), JSPACE, n_trunks=n_trunks)
    big = uniform_subnet(SPACE, 7, 6, 4, 2, n_trunks=n_trunks)
    constraint = 0.6 * eff(big)

    def quality(cfg):
        return sum(cfg.ks) + sum(cfg.e) + 10 * sum(cfg.d) + cfg.pixel_d

    finder = tsearch.EvolutionFinder(SPACE, eff, quality, n_trunks=n_trunks,
                                     population_size=16, max_time_budget=6, seed=3)
    jfinder = JaxFinder(JSPACE, jeff, quality, n_trunks=n_trunks, population_size=16,
                        max_time_budget=6, seed=3)
    best, score, hist = finder.run(constraint)
    jbest, jscore, jhist = jfinder.run(constraint)
    assert _fields(best) == _fields(jbest) and score == jscore and hist == jhist
    assert finder.rng.getstate() == jfinder.rng.getstate()
    assert eff(best) <= constraint and hist == sorted(hist)


# -- the predictor -------------------------------------------------------------

def _pairs(n, seed0=0):
    cfgs = [sample_subnet(SPACE, seed=seed0 + i) for i in range(n)]
    feats = np.stack([tsearch.encode_sr_subnet(c, SPACE) for c in cfgs])
    return feats, np.asarray([tsearch.s4_subnet_flops(c, SPACE) / 1e9 for c in cfgs])


def _np_params(jpred):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in jpred.params]


def test_predictor_forward_matches_jax():
    feats, _ = _pairs(40)
    jpred = JaxPredictor(in_dim=feats.shape[1], hidden=64, n_layers=2, seed=1)
    jpred.mu, jpred.sigma = 0.3, 2.0
    pred = tsearch.AccuracyPredictor.from_jax_params(_np_params(jpred), jpred.mu, jpred.sigma,
                                                     device="cpu")
    assert (pred.in_dim, pred.hidden, pred.n_layers) == (feats.shape[1], 64, 2)
    np.testing.assert_allclose(pred.predict(feats), jpred.predict(feats), rtol=0, atol=1e-5)
    # the port's own init: the JAX law, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), zero biases
    own = tsearch.AccuracyPredictor(feats.shape[1], hidden=64, n_layers=2, device="cpu")
    for lin in own.layers:
        bound = 1 / np.sqrt(lin.in_features)
        assert float(lin.weight.detach().abs().max()) <= bound and not lin.bias.any()
    assert own.predict(feats[0]).shape == (1,)


def test_predictor_fit_matches_jax():
    """`fit` from the same start (the JAX init carried over): Adam, the
    epoch permutations and the target normalization as in JAX."""
    feats, targets = _pairs(200)
    jpred = JaxPredictor(in_dim=feats.shape[1], hidden=64, n_layers=2)
    pred = tsearch.AccuracyPredictor.from_jax_params(_np_params(jpred), device="cpu")
    kw = dict(epochs=10, lr=3e-3, batch_size=64, seed=2)
    jloss = jpred.fit(feats, targets, **kw)
    loss = pred.fit(feats, targets, **kw)
    assert (pred.mu, pred.sigma) == (jpred.mu, jpred.sigma)
    np.testing.assert_allclose(loss, jloss, rtol=1e-3)
    test_feats, test_t = _pairs(50, seed0=1000)
    out = pred.predict(test_feats)
    np.testing.assert_allclose(out, jpred.predict(test_feats), rtol=1e-3)
    assert np.corrcoef(out, test_t)[0, 1] > 0.9


# -- latency tables ------------------------------------------------------------

def test_latency_table_keys_and_files_across_packages(tmp_path):
    t, j = tsearch.LatencyTable(), JaxLatencyTable()
    for tab in (t, j):
        tab.set("expanded_conv", [56, 56, 24], [56, 56, 24], 1.25, expand=3, kernel=3)
        tab.set("sr_head_tail", [90, 90, 3], [180, 180, 3], 0.5, pixel_d=1, skip=None)
    assert t.table == j.table
    tp, jp = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    t.save(tp)
    j.save(jp)
    assert JaxLatencyTable(path=tp).table == tsearch.LatencyTable(path=jp).table == t.table
    yml = tmp_path / "table.yaml"
    yml.write_text("# a comment\n" + "".join("%s: %r\n" % kv for kv in t.table.items())
                   + "not a number: x\n")
    assert tsearch.LatencyTable(path=str(yml)).table == JaxLatencyTable(path=str(yml)).table \
        == t.table
    assert t.query("expanded_conv", [56, 56, 24], [56, 56, 24], expand=3, kernel=3) == 1.25


@pytest.mark.parametrize("n_trunks,stage_range", [(1, None), (2, None), (2, (0, 8)),
                                                  (2, (2, 6))])
def test_lut_efficiency_matches_jax(n_trunks, stage_range):
    table = _lut_dict(SPACE, 720)
    fn = tsearch.lut_efficiency_fn(tsearch.LatencyTable(dict(table)), SPACE, hr_size=720,
                                   n_trunks=n_trunks, stage_range=stage_range)
    jfn = jlat.lut_efficiency_fn(JaxLatencyTable(dict(table)), JSPACE, hr_size=720,
                                 n_trunks=n_trunks, stage_range=stage_range)
    for cfg in _cfgs(n_trunks):
        assert fn(cfg) == jfn(_jcfg(cfg))


def _const_ms(*_a, **_k):
    return 1.0


# the CPU tests' windows: 2 and 6 calls, a 1 ms signal. The defaults (16
# and 48 calls, 20 ms) grow the windows up to 256x where the test workers
# share busy cores and the signal drowns
SMALL_WINDOWS = dict(n_small=2, n_big=6, min_signal_s=1e-3)


def test_build_tables_match_jax_keys(monkeypatch):
    """Both table functions on tiny spaces: the port's entries measured on the CPU
    (positive), the JAX package's keys and counts with its timing stubbed
    (its keys do not depend on the times)."""
    monkeypatch.setattr(jlat, "measure_latency_device", _const_ms)
    monkeypatch.setattr(tlat, "measure_latency_device",
                        functools.partial(tlat.measure_latency_device, **SMALL_WINDOWS))
    space1 = dict(ks_list=[3], expand_list=[3], depth_list=[1], pixel_d_list=[1], n_stages=1,
                  width=8)
    jnet = JaxS4(jarch.SearchSpace(**space1))
    p, s = jnet.init(jax.random.PRNGKey(0))
    jt = jlat.build_latency_table(jnet, p, s, jnet.space, hr_size=16)
    net = OFAMobileNetS4(SearchSpace(**space1), device="cpu")
    tt = tsearch.build_latency_table(net, net.space, hr_size=16)
    assert tt.table.keys() == jt.table.keys() and len(tt.table) == 1
    assert all(v > 0 for v in tt.table.values())
    wall = tsearch.build_latency_table(net, net.space, hr_size=16, device_timing=False, iters=3)
    assert wall.table.keys() == jt.table.keys() and all(v > 0 for v in wall.table.values())

    jnet = JaxS4(jarch.SearchSpace(**TINY_KW))
    p, s = jnet.init(jax.random.PRNGKey(0))
    jt = jlat.build_block_latency_table(jnet, p, s, jnet.space, hr_size=16)
    net = OFAMobileNetS4(SearchSpace(**TINY_KW), device="cpu")
    tt = tsearch.build_block_latency_table(net, net.space, hr_size=16)
    # 2 resolutions x (2 ks x 2 e) block entries + 2 head/tail entries
    assert tt.table.keys() == jt.table.keys() and len(tt.table) == 2 * 4 + 2
    assert all(v > 0 for k, v in tt.table.items() if k.startswith("expanded_conv"))
    assert all(v >= 0 for v in tt.table.values())
    eff = tsearch.lut_efficiency_fn(tt, net.space, hr_size=16)
    assert eff(uniform_subnet(net.space, 5, 3, 2, 1)) > eff(uniform_subnet(net.space, 5, 3, 1, 1))


def test_block_table_times_the_subnets_blocks(monkeypatch):
    """Each block entry times one MBConv of a materialized subnet, each
    head/tail entry the minimal subnet; on the X4 the decoder's."""
    calls = []

    def record(fn, x, **kw):
        calls.append(tuple(x.shape))
        with torch.no_grad():
            y = fn(x)
        if y.shape[-1] == 3:  # a whole subnet
            assert y.shape[1] == 16
            return 5.0
        assert y.shape == x.shape
        return 1.0 + 0.01 * len(calls)

    monkeypatch.setattr(tlat, "measure_latency_device", record)
    net = OFAMobileNetX4(SearchSpace(**TINY_KW), device="cpu")
    t = tsearch.build_block_latency_table(net, net.space, hr_size=16)
    assert calls == [(1, 8, 8, 8)] * 4 + [(1, 8, 8, 3)] + [(1, 4, 4, 8)] * 4 + [(1, 4, 4, 3)]
    # head/tail = whole minimal subnet less n_stages * d_min blocks of (k0, e0)
    assert t.query("sr_head_tail", [8, 8, 3], [16, 16, 3], pixel_d=1) == \
        pytest.approx(5.0 - 2 * 1 * 1.01)


def test_measure_latency_cpu_and_no_slope_raises(monkeypatch):
    x = torch.zeros(4, 64)
    w = torch.randn(64, 64)
    assert tsearch.measure_latency_device(lambda t: t @ w, x, min_signal_s=1e-4) > 0
    assert tsearch.measure_latency(lambda t: t @ w, x, warmup=1, iters=3) > 0

    def flat_window(fn, x, n):
        return lambda: 1.0 if n == 16 else 0.9  # the big window "outran" the small one

    monkeypatch.setattr(tlat, "_host_window", flat_window)
    with pytest.raises(RuntimeError, match="no usable slope"):
        tsearch.measure_latency_device(lambda t: t, x)


def test_slope_helpers_match_jax():
    samples = [0.51, -0.2, 0.49, 3.9, 0.5, 0.0, 0.05]
    for kw in ({}, dict(floor_ms=0.1), dict(max_spread=10.0)):
        assert tlat.filter_slope_samples(samples, **kw) == jlat.filter_slope_samples(samples, **kw)
    assert tlat.filter_slope_samples([-1.0, 0.0]) == jlat.filter_slope_samples([-1.0, 0.0])
    for slopes, walls in (([5.2, 24.0, 25.1], [24.8, 26.0]), ([1.0, 2.0], [10.0])):
        assert tlat.select_slope_vs_wall(slopes, walls) == jlat.select_slope_vs_wall(slopes, walls)

    def windows():
        seq = iter([10.0, 12.0, 10.0, 10.0, 10.0, 12.1, 10.0, 11.9, 10.0, 12.0])
        return lambda k: next(seq) + 0 * k
    assert tlat.sample_slopes(windows(), n_small=16, n_big=48) == \
        jlat.sample_slopes(windows(), n_small=16, n_big=48)
    with pytest.raises(RuntimeError, match="non-physical"):
        tlat.sample_slopes(lambda k: 1.0, n_small=1, n_big=2, reps=1)


# -- the search entry point -------------------------------------------------------

def _shape_ms(fn, x, **_kw):
    """A deterministic stand-in for the timing: fn(x) runs once, and the
    'time' grows with the input's size, a whole subnet's 100x a block's."""
    fn(x)
    return x.numel() * (1e-2 if x.shape[-1] == 3 else 1e-4)


def test_entry_search_cpu(monkeypatch):
    """entry.search end to end on a tiny S4 space on the CPU: the table, the
    finder under the constraint, and the three deployments with BN
    recalibration on a synthetic provider. Its timed calls run, with
    deterministic times, so the finder's budget does not depend on the
    load of the cores the tests share."""
    monkeypatch.setattr(tlat, "measure_latency_device", _shape_ms)
    monkeypatch.setattr(entry, "measure_latency_device", _shape_ms)
    net = OFAMobileNetS4(SearchSpace(**TINY_KW), device="cpu")
    provider = SyntheticSRProvider(n_train=8, n_valid=2, hr_size=16, train_batch_size=4)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    rep = entry.search(net, provider, hr_size=16, constraint_frac=0.95, population_size=8,
                       generations=3, device="cpu")
    assert len(rep["lut"]) == 10 and rep["constraint_ms"] > 0
    assert set(rep["candidates"]) == {"uniform_min", "uniform_max", "searched"}
    win = rep["candidates"]["searched"]
    assert win["cfg"] == repr(rep["winner"]) and win["lut_ms"] <= rep["constraint_ms"]
    assert rep["history"] == sorted(rep["history"]) and len(rep["history"]) == 4
    for c in rep["candidates"].values():
        assert c["true_ms"] > 0 and np.isfinite(c["psnr_db"]) and c["trunk_gmacs"] > 0
    # the recalibration is undone after each evaluation
    after = net.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    json.dumps({k: v for k, v in rep.items() if k != "winner"})
    with pytest.raises(ValueError, match="too few random subnets meet"):
        entry.search(net, hr_size=16, constraint_frac=0.01, device="cpu")
    with pytest.raises(ValueError, match="quality"):
        entry.search(net, hr_size=16, quality="psnr", device="cpu")
