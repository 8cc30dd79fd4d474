"""The port's subnet sampling draws exactly the JAX package's subnets."""

import random

import pytest

from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu_torch.models import arch as tarch
from ofa_sr_tpu_torch.utils import common as tcommon
from ofa_sr_tpu.utils import common as jcommon

SPACES = [
    dict(),
    dict(ks_list=[3, 5, 7], expand_list=[3, 4, 6], depth_list=[2, 3],
         pixel_d_list=[1, 2], n_stages=2, width=16),
]
CONSTRAINTS = [
    dict(),
    dict(ks_candidates=[7], expand_candidates=[6]),
    dict(ks_candidates=[5, 7], depth_candidates=[3, 4], pixel_d_candidates=[2]),
    dict(expand_candidates=[3, 4], depth_candidates=[2]),
]


def _as_tuple(cfg):
    return (tuple(cfg.ks), tuple(cfg.e), tuple(cfg.d), cfg.pixel_d)


@pytest.mark.parametrize("space_kw", SPACES)
@pytest.mark.parametrize("constraint", CONSTRAINTS)
def test_sample_subnet_matches_jax(space_kw, constraint):
    js, ts = jarch.SearchSpace(**space_kw), tarch.SearchSpace(**space_kw)
    assert ts.mid_candidates() == js.mid_candidates()
    for seed in list(range(40)) + [jarch.subnet_seed(3, 50, 7, 2)]:
        a = jarch.sample_subnet(js, seed=seed, **constraint)
        b = tarch.sample_subnet(ts, seed=seed, **constraint)
        assert _as_tuple(a) == _as_tuple(b), seed


def test_fixed_subnets_and_helpers_match_jax():
    js, ts = jarch.SearchSpace(), tarch.SearchSpace()
    assert _as_tuple(jarch.max_subnet(js)) == _as_tuple(tarch.max_subnet(ts))
    assert (_as_tuple(jarch.uniform_subnet(js, 7, 6, 2, 2))
            == _as_tuple(tarch.uniform_subnet(ts, 7, 6, 2, 2)))
    for args in [(0, 50, 3, 0), (12, 800, 799, 3)]:
        assert jarch.subnet_seed(*args) == tarch.subnet_seed(*args)
    for v in range(1, 400, 7):
        for e in (3, 4, 6, 2.5):
            assert (tcommon.make_divisible(round(v * e), 8)
                    == jcommon.make_divisible(round(v * e), 8))
    for big, small in [(7, 3), (7, 5), (5, 3), (3, 3)]:
        assert (tcommon.sub_filter_start_end(big, small)
                == jcommon.sub_filter_start_end(big, small))
    assert tcommon.get_same_padding((5, 3)) == jcommon.get_same_padding((5, 3))
    assert tcommon.int2list(3, 4) == jcommon.int2list(3, 4)


@pytest.mark.parametrize("space_kw", SPACES)
def test_quirk_archs_and_trunks_match_jax(space_kw):
    """reference_quirk_arch_s4 over sampled S4 subnets; reference_quirk_arch_x4
    and the samplers' n_trunks over two-trunk (X4-shaped) subnets."""
    js, ts = jarch.SearchSpace(**space_kw), tarch.SearchSpace(**space_kw)
    assert _as_tuple(jarch.max_subnet(js, 2)) == _as_tuple(tarch.max_subnet(ts, 2))
    assert (_as_tuple(jarch.uniform_subnet(js, 5, 4, 3, 1, n_trunks=2))
            == _as_tuple(tarch.uniform_subnet(ts, 5, 4, 3, 1, n_trunks=2)))
    x4 = js.n_stages == 4  # the X4 quirk reads 4 + 4 stages
    for seed in range(60):
        a = jarch.sample_subnet(js, seed=seed)
        b = tarch.sample_subnet(ts, seed=seed)
        if x4:
            assert (_as_tuple(jarch.reference_quirk_arch_s4(a))
                    == _as_tuple(tarch.reference_quirk_arch_s4(b)))
        a2 = jarch.sample_subnet(js, seed=seed, n_trunks=2)
        b2 = tarch.sample_subnet(ts, seed=seed, n_trunks=2)
        assert _as_tuple(a2) == _as_tuple(b2)
        assert len(b2.ks) == 2 * ts.blocks_per_trunk and len(b2.d) == 2 * ts.n_stages
        if x4:
            assert (_as_tuple(jarch.reference_quirk_arch_x4(a2))
                    == _as_tuple(tarch.reference_quirk_arch_x4(b2)))
    with pytest.raises(ValueError):
        tarch.reference_quirk_arch_x4(tarch.sample_subnet(ts, seed=0, n_trunks=1)
                                      if ts.n_stages == 4 else tarch.max_subnet(ts))


@pytest.mark.parametrize("constraint", CONSTRAINTS)
def test_sample_subnet_with_rng_matches_jax(constraint):
    """sample_subnet(rng=random.Random(s)) draws from its own generator in
    the same order, leaving the module-level RNG alone, as in JAX."""
    js, ts = jarch.SearchSpace(), tarch.SearchSpace()
    for s in range(40):
        random.seed(1000 + s)
        before = random.getstate()
        a = jarch.sample_subnet(js, n_trunks=2, rng=random.Random(s), **constraint)
        b = tarch.sample_subnet(ts, n_trunks=2, rng=random.Random(s), **constraint)
        assert _as_tuple(a) == _as_tuple(b)
        assert random.getstate() == before
        # a seed beside an rng is ignored in both
        assert _as_tuple(tarch.sample_subnet(ts, seed=5, rng=random.Random(s), n_trunks=2,
                                             **constraint)) == _as_tuple(b)


def test_average_meter_matches_jax():
    rng = random.Random(0)
    jm, tm = jcommon.AverageMeter(), tcommon.AverageMeter()
    for i in range(200):
        if i == 120:
            jm.reset()
            tm.reset()
        val, n = rng.uniform(-3, 3), rng.randint(1, 16)
        jm.update(val, n)
        tm.update(val, n)
        assert (tm.val, tm.sum, tm.count, tm.avg) == (jm.val, jm.sum, jm.count, jm.avg)
