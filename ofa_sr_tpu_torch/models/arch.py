"""Architecture (subnet) configuration and sampling.

Counterpart of ofa_sr_tpu/models/arch.py. A subnet is an immutable host-side
`SubnetConfig`; the port's sliced forward slices weights by it directly.
`SubnetConfig.to_device` is its device-side encoding (the JAX package's), and
`MaskedArch` the subnet in the masked execution form the graphed training
step runs: kernel-size indices and middle widths as device tensors, depths
and pixel_d on the host. Its `to_dict` / `from_dict` are the JAX package's
JSON schema.

Sampling keeps the reference's exact draw order: `random.seed(subnet_seed)`,
then per-block `random.choice(ks)`, per-block choice(e), per-stage choice(d)
and one choice(pixel_d). The same seed gives the same subnet in both packages.
`n_trunks` counts the elastic trunks (1 for S4; the X4 autoencoder has an
encoder and a decoder trunk); `reference_quirk_arch_s4/x4` map a sampled
subnet to the one the reference networks actually execute.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence

import torch

from ..utils.common import int2list, make_divisible


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Static description of one elastic MBConv trunk's search space."""

    ks_list: Sequence[int] = (3, 5, 7)
    expand_list: Sequence[float] = (3, 4, 6)
    depth_list: Sequence[int] = (2, 3, 4)
    pixel_d_list: Sequence[int] = (1, 2)
    n_stages: int = 4          # elastic MBConv stages per trunk
    width: int = 64            # trunk channel width

    def __post_init__(self):
        object.__setattr__(self, "ks_list", sorted(set(int2list(self.ks_list))))
        object.__setattr__(self, "expand_list", sorted(int2list(self.expand_list)))
        object.__setattr__(self, "depth_list", sorted(int2list(self.depth_list)))
        object.__setattr__(self, "pixel_d_list", sorted(int2list(self.pixel_d_list)))

    @property
    def max_depth(self) -> int:
        return max(self.depth_list)

    @property
    def max_ks(self) -> int:
        return max(self.ks_list)

    @property
    def max_expand(self):
        return max(self.expand_list)

    @property
    def blocks_per_trunk(self) -> int:
        return self.n_stages * self.max_depth

    def mid_channels(self, expand_ratio) -> int:
        """make_divisible(round(in * e), 8), the reference's middle width."""
        return make_divisible(round(self.width * expand_ratio), 8)

    def mid_candidates(self) -> List[int]:
        return [self.mid_channels(e) for e in self.expand_list]


@dataclasses.dataclass(frozen=True)
class SubnetConfig:
    """One sampled subnet. `ks`/`e` are per MBConv block (in network order),
    `d` per stage, `pixel_d` the number of x2 shuffle stages."""

    ks: tuple
    e: tuple
    d: tuple
    pixel_d: int

    def to_device(self, space: SearchSpace, device=None):
        """{"ks_idx", "mid", "depth", "pixel_d"}: int32 tensors on `device`
        (the JAX package's `to_device`): ks as an index into the space's
        ks_list (sorted, so also into `kernel_candidates`' order), e as the
        middle width, make_divisible applied here on the host."""
        ks_set = list(space.ks_list)

        def t(v):
            return torch.tensor(v, dtype=torch.int32, device=device)

        return {"ks_idx": t([ks_set.index(k) for k in self.ks]),
                "mid": t([space.mid_channels(e) for e in self.e]),
                "depth": t(list(self.d)), "pixel_d": t(self.pixel_d)}

    def describe(self) -> str:
        return "ks%s_e%s_d%s_pd%d" % (list(self.ks), list(self.e), list(self.d), self.pixel_d)

    # JSON serialization: the SR side's net.config, the JAX package's schema
    def to_dict(self) -> dict:
        return {"name": "SubnetConfig", "ks": list(self.ks), "e": list(self.e),
                "d": list(self.d), "pixel_d": int(self.pixel_d)}

    @staticmethod
    def from_dict(d: dict) -> "SubnetConfig":
        if d.get("name", "SubnetConfig") != "SubnetConfig":
            raise ValueError("not a SubnetConfig dict: %r" % d.get("name"))
        return SubnetConfig(ks=tuple(d["ks"]), e=tuple(d["e"]), d=tuple(d["d"]),
                            pixel_d=int(d["pixel_d"]))


@dataclasses.dataclass(frozen=True, eq=False)
class MaskedArch:
    """A subnet in the masked execution form (the JAX package's device arch
    with its depths and pixel_d static): `ks_idx` and `mid`, int32 device
    tensors of one entry a block (`SubnetConfig.to_device`'s), are read on
    the device only, so one captured forward serves every kernel size and
    middle width; the depths `d` and `pixel_d` stay host ints, the program
    branches they are in JAX. A net's forward takes it in place of a
    SubnetConfig."""

    ks_idx: torch.Tensor
    mid: torch.Tensor
    d: tuple
    pixel_d: int


def check_n_trunks(space: SearchSpace, cfg, n_trunks: int):
    """Raise unless `cfg` (a SubnetConfig or a MaskedArch) has the lengths of
    a net of `n_trunks` trunks: a subnet sampled for another trunk count
    would index out of range, or feed one trunk's choices to the other."""
    n_blocks, n_stages = space.blocks_per_trunk * n_trunks, space.n_stages * n_trunks
    ks, e = (cfg.ks_idx, cfg.mid) if isinstance(cfg, MaskedArch) else (cfg.ks, cfg.e)
    if (len(ks), len(e), len(cfg.d)) != (n_blocks, n_blocks, n_stages):
        raise ValueError(
            "subnet with %d/%d/%d ks/e/d entries for a net of %d trunk(s), which takes %d/%d/%d:"
            " sample it with n_trunks=%d" % (len(ks), len(e), len(cfg.d), n_trunks,
                                             n_blocks, n_blocks, n_stages, n_trunks))


def max_subnet(space: SearchSpace, n_trunks: int = 1) -> SubnetConfig:
    n_blocks = space.blocks_per_trunk * n_trunks
    return SubnetConfig(
        ks=tuple([space.max_ks] * n_blocks),
        e=tuple([space.max_expand] * n_blocks),
        d=tuple([space.max_depth] * (space.n_stages * n_trunks)),
        pixel_d=max(space.pixel_d_list),
    )


def uniform_subnet(space: SearchSpace, ks, e, d, pixel_d, n_trunks: int = 1) -> SubnetConfig:
    """Broadcast scalars across blocks/stages."""
    n_blocks = space.blocks_per_trunk * n_trunks
    return SubnetConfig(
        ks=tuple(int2list(ks, n_blocks)),
        e=tuple(int2list(e, n_blocks)),
        d=tuple(int2list(d, space.n_stages * n_trunks)),
        pixel_d=pixel_d if not isinstance(pixel_d, (list, tuple)) else pixel_d[0],
    )


def reference_quirk_arch_s4(cfg: SubnetConfig) -> SubnetConfig:
    """The subnet the reference S4 executes for a sampled `cfg`: its
    set_active_subnet inserts pixel_d at position -1 of the depth list, and
    its shuffle loop reads runtime_depth[0], so the stage depths become
    (d0, d1, d2, pixel_d) and the shuffle count min(2, d0)."""
    return SubnetConfig(ks=cfg.ks, e=cfg.e, d=(cfg.d[0], cfg.d[1], cfg.d[2], cfg.pixel_d),
                        pixel_d=min(2, cfg.d[0]))


def reference_quirk_arch_x4(cfg: SubnetConfig) -> SubnetConfig:
    """The subnet the reference X4 executes: both trunks run the stage
    depths (pixel_d, d0, d1, d2) (d3..d7 are sampled but never read); the
    scale factor stays 2^pixel_d."""
    if len(cfg.d) != 8:
        raise ValueError("X4 has 4+4 stages; got %d depths" % len(cfg.d))
    trunk = (cfg.pixel_d, cfg.d[0], cfg.d[1], cfg.d[2])
    return SubnetConfig(ks=cfg.ks, e=cfg.e, d=trunk + trunk, pixel_d=cfg.pixel_d)


def subnet_seed(epoch: int, n_batch: int, batch_idx: int, subnet_idx: int) -> int:
    """The reference's determinism contract:
    int('%d%.3d%.3d' % (epoch * nBatch + i, subnet_idx, 0))."""
    return int("%d%.3d%.3d" % (epoch * n_batch + batch_idx, subnet_idx, 0))


def sample_subnet(
    space: SearchSpace,
    seed: Optional[int] = None,
    n_trunks: int = 1,
    ks_candidates: Optional[Sequence] = None,
    expand_candidates: Optional[Sequence] = None,
    depth_candidates: Optional[Sequence] = None,
    pixel_d_candidates: Optional[Sequence] = None,
    rng: Optional[random.Random] = None,
) -> SubnetConfig:
    """Uniform per-dimension sampling in the reference's draw order: all ks
    draws, then all e draws, then per-stage d draws, then one pixel_d draw.

    Candidate overrides are the `set_constraint` include-lists. Passing
    `seed` reseeds the module-level Python RNG, like `random.seed(seed)` in
    the reference trainer; passing `rng` (a `random.Random`) draws from it
    instead, in the same order, and leaves the module-level RNG alone
    (`seed` is then ignored).
    """
    if rng is None:
        if seed is not None:
            random.seed(seed)
        rng = random

    ks_c = list(ks_candidates) if ks_candidates is not None else list(space.ks_list)
    e_c = list(expand_candidates) if expand_candidates is not None else list(space.expand_list)
    d_c = list(depth_candidates) if depth_candidates is not None else list(space.depth_list)
    p_c = list(pixel_d_candidates) if pixel_d_candidates is not None else list(space.pixel_d_list)

    n_blocks = space.blocks_per_trunk * n_trunks
    ks = [rng.choice(ks_c) for _ in range(n_blocks)]
    e = [rng.choice(e_c) for _ in range(n_blocks)]
    d = [rng.choice(d_c) for _ in range(space.n_stages * n_trunks)]
    pixel_d = rng.choice(p_c)
    return SubnetConfig(ks=tuple(ks), e=tuple(e), d=tuple(d), pixel_d=pixel_d)
