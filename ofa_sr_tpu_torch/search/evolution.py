"""Evolutionary subnet search under an efficiency constraint (counterpart of
ofa_sr_tpu/search/evolution.py).

A random population under the constraint, then per generation: keep the
top `parent_ratio` by quality, add mutations of random parents (per-block
ks and e, per-stage depth, pixel_d, each with `mutate_prob`) and uniform
crossovers, each redrawn until it meets the constraint. Any
(efficiency_fn, quality_fn) pair plugs in: closed-form MACs, a latency
table, a predictor, a measured PSNR.

Plain Python: one `random.Random(seed)` drawn in the JAX package's order,
so the same seed and functions give the same population, winner and
history in both packages. The frozen `SubnetConfig` is the score key.
"""

from __future__ import annotations

import random
from typing import Callable

from ..models.arch import SearchSpace, SubnetConfig


class EvolutionFinder:
    def __init__(self, space: SearchSpace, efficiency_fn: Callable,
                 quality_fn: Callable, *, n_trunks=1,
                 mutate_prob=0.1, population_size=100, max_time_budget=500,
                 parent_ratio=0.25, mutation_ratio=0.5, seed=None):
        self.space = space
        self.n_trunks = n_trunks
        self.efficiency_fn = efficiency_fn  # cfg -> scalar (MACs, ms)
        self.quality_fn = quality_fn        # cfg -> scalar (PSNR, accuracy)
        self.mutate_prob = mutate_prob
        self.population_size = population_size
        self.max_time_budget = max_time_budget
        self.parent_ratio = parent_ratio
        self.mutation_ratio = mutation_ratio
        self.rng = random.Random(seed)

    # -- genetic operators -----------------------------------------------------

    def random_valid(self, constraint):
        while True:
            cfg = self._random()
            if self.efficiency_fn(cfg) <= constraint:
                return cfg

    def _random(self):
        sp = self.space
        n_blocks = sp.blocks_per_trunk * self.n_trunks
        return SubnetConfig(
            ks=tuple(self.rng.choice(sp.ks_list) for _ in range(n_blocks)),
            e=tuple(self.rng.choice(sp.expand_list) for _ in range(n_blocks)),
            d=tuple(self.rng.choice(sp.depth_list)
                    for _ in range(sp.n_stages * self.n_trunks)),
            pixel_d=self.rng.choice(sp.pixel_d_list))

    def mutate(self, cfg: SubnetConfig, constraint):
        sp = self.space
        while True:
            ks, e, d = list(cfg.ks), list(cfg.e), list(cfg.d)
            pixel_d = cfg.pixel_d
            for i in range(len(ks)):
                if self.rng.random() < self.mutate_prob:
                    ks[i] = self.rng.choice(sp.ks_list)
                if self.rng.random() < self.mutate_prob:
                    e[i] = self.rng.choice(sp.expand_list)
            for i in range(len(d)):
                if self.rng.random() < self.mutate_prob:
                    d[i] = self.rng.choice(sp.depth_list)
            if self.rng.random() < self.mutate_prob:
                pixel_d = self.rng.choice(sp.pixel_d_list)
            new = SubnetConfig(tuple(ks), tuple(e), tuple(d), pixel_d)
            if self.efficiency_fn(new) <= constraint:
                return new

    def crossover(self, a: SubnetConfig, b: SubnetConfig, constraint):
        while True:
            ks = tuple(self.rng.choice([x, y]) for x, y in zip(a.ks, b.ks))
            e = tuple(self.rng.choice([x, y]) for x, y in zip(a.e, b.e))
            d = tuple(self.rng.choice([x, y]) for x, y in zip(a.d, b.d))
            pd = self.rng.choice([a.pixel_d, b.pixel_d])
            new = SubnetConfig(ks, e, d, pd)
            if self.efficiency_fn(new) <= constraint:
                return new

    # -- the search loop -------------------------------------------------------

    def run(self, constraint, verbose=False):
        """(best subnet, its quality, the best quality after the initial
        population and after each generation)."""
        n_mut = int(round(self.mutation_ratio * self.population_size))
        n_par = int(round(self.parent_ratio * self.population_size))

        population = [self.random_valid(constraint)
                      for _ in range(self.population_size)]
        scores = {c: self.quality_fn(c) for c in population}
        best = max(population, key=lambda c: scores[c])
        history = [scores[best]]

        for it in range(self.max_time_budget):
            parents = sorted(population, key=lambda c: scores[c],
                             reverse=True)[:n_par]
            if scores[parents[0]] > scores[best]:
                best = parents[0]
            history.append(scores[best])
            if verbose:
                print("iter %d: best %.4f" % (it, scores[best]))

            population = list(parents)
            for _ in range(n_mut):
                child = self.mutate(self.rng.choice(parents), constraint)
                population.append(child)
                scores.setdefault(child, self.quality_fn(child))
            while len(population) < self.population_size:
                child = self.crossover(self.rng.choice(parents),
                                       self.rng.choice(parents), constraint)
                population.append(child)
                scores.setdefault(child, self.quality_fn(child))

        return best, scores[best], history


# the least share of random subnets a search's constraint must admit, and
# the random draws (another stream than the finder's) that estimate it
MIN_CONSTRAINT_SHARE, SHARE_DRAWS = 0.01, 1000


def require_constraint_share(space: SearchSpace, efficiency_fn: Callable, constraint, *,
                             largest: SubnetConfig, smallest: SubnetConfig, n_trunks=1):
    """The share of SHARE_DRAWS random subnets that meet `constraint`.
    The finder draws random subnets until one does, so at a share near 0 it
    would draw for ever: below MIN_CONSTRAINT_SHARE this raises ValueError,
    with the largest and smallest uniform subnets' efficiencies."""
    probe = EvolutionFinder(space, efficiency_fn, None, n_trunks=n_trunks, seed=1)
    share = sum(efficiency_fn(probe._random()) <= constraint
                for _ in range(SHARE_DRAWS)) / SHARE_DRAWS
    if share < MIN_CONSTRAINT_SHARE:
        big, small = efficiency_fn(largest), efficiency_fn(smallest)
        raise ValueError(
            "too few random subnets meet the constraint: a share of %.3g under %.4f ms (%.3g "
            "of the largest uniform subnet's %.4f; the smallest takes %.4f); raise the "
            "constraint's fraction" % (share, constraint, constraint / big, big, small))
    return share
