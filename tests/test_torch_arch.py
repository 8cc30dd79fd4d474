"""The port's subnet sampling draws exactly the JAX package's subnets."""

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
