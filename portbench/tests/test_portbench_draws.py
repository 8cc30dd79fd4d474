"""The traffic generators: each draws only its phase's candidates, the same
sequence for the same seed, and every pass key in each block."""

import pytest

from portbench import harness
from portbench.traffic import cls_train, sr_train

S4 = harness.load_json(harness.BENCH_DIR + "/configs/ofa_s4.json")
MBV3 = harness.load_json(harness.BENCH_DIR + "/configs/ofa_mbv3.json")


def traffic(name):
    return harness.load_json(harness.BENCH_DIR + "/traffic/%s.json" % name)


@pytest.mark.parametrize("name", ["sr_kernel_phase", "sr_expand_phase"])
def test_sr_draws_only_the_phase_candidates(name):
    t = traffic(name)
    d = sr_train.Draw(S4, t, 2147483901)
    for j in range(300):
        s = d.subnet(j)
        assert len(s["ks"]) == len(s["e"]) == 16 and len(s["d"]) == 4
        assert set(s["ks"]) <= set(t["ks_list"]) and set(s["e"]) <= set(t["expand_list"])
        assert set(s["d"]) <= set(t["depth_list"]) and s["pixel_d"] in t["pixel_d_list"]


@pytest.mark.parametrize("name", ["sr_kernel_phase", "sr_expand_phase"])
def test_sr_draws_repeat_for_a_seed_and_differ_across_seeds(name):
    t = traffic(name)
    a, b, c = (sr_train.Draw(S4, t, s) for s in (7, 7, 8))
    assert [a.subnet(j) for j in range(50)] == [b.subnet(j) for j in range(50)]
    assert [a.subnet(j) for j in range(50)] != [c.subnet(j) for j in range(50)]


def test_sr_expand_blocks_hold_every_pass_key_once():
    t = traffic("sr_expand_phase")
    d = sr_train.Draw(S4, t, 3000000017)
    n = len(d.combos)
    assert n == 81
    for blk in range(3):
        keys = [(tuple(d.subnet(j)["d"]), d.subnet(j)["pixel_d"])
                for j in range(blk * n, (blk + 1) * n)]
        assert sorted(keys) == sorted((tuple(k), p) for k, p in d.combos)


def test_sr_kernel_phase_has_one_pass_key():
    d = sr_train.Draw(S4, traffic("sr_kernel_phase"), 5)
    assert {(tuple(d.subnet(j)["d"]), d.subnet(j)["pixel_d"]) for j in range(100)} == \
        {((4, 4, 4, 4), 2)}


def _cls(seed):
    w = cls_train.Workload.__new__(cls_train.Workload)
    w.cfg, w.traffic, w.seed = MBV3, traffic("cls_expand_phase"), seed
    w.k, w.sizes, w.n_blocks = 4, w.traffic["image_sizes"], 20
    return w


def test_cls_draws_only_the_phase_candidates_and_repeat():
    a, b = _cls(11), _cls(11)
    t = a.traffic
    for i in range(40):
        assert a.subnets(i) == b.subnets(i) and a.size(i) == b.size(i)
        for s in a.subnets(i):
            assert set(s["ks"]) <= set(t["ks_list"]) and set(s["e"]) <= set(t["expand_list"])
            assert set(s["d"]) <= set(t["depth_list"]) and len(s["d"]) == 5
    assert [a.subnets(i) for i in range(5)] != [_cls(12).subnets(i) for i in range(5)]


def test_cls_each_run_of_four_steps_holds_every_size_once():
    w = _cls(4000000019)
    for run in range(10):
        assert sorted(w.size(4 * run + i) for i in range(4)) == [128, 160, 192, 224]
    orders = {tuple(w.size(4 * run + i) for i in range(4)) for run in range(10)}
    assert len(orders) > 1


def test_warmup_covers_the_sequence_keys():
    t = traffic("sr_expand_phase")
    w = sr_train.Workload.__new__(sr_train.Workload)
    w.cfg, w.traffic, w.k = S4, t, t["subnets_per_step"]
    w.draw = sr_train.Draw(S4, t, 99)
    warm = {(tuple(s["d"]), s["pixel_d"]) for i in range(w.warmup_steps())
            for s in w.subnets(i)}
    later = {(tuple(s["d"]), s["pixel_d"]) for i in range(21, 400) for s in w.subnets(i)}
    assert later <= warm and len(warm) == 81
