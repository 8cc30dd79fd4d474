"""Entry points of the port.

`entry()` is the counterpart of the JAX package's `__graft_entry__.entry`:
the flagship OFAMobileNetS4 supernet (full search space) in an eval forward
of a sampled subnet at batch 16, 48x48 LR, pixel_d 1.

`serve(frames, ...)` is the serving path: it materializes a static subnet
(default ks7/e6/d2/pixel_d 2, the reference eval envelope) and answers LR
frames one at a time, like the JAX package's
`cli/eval_ofa_net_sr.py --materialize`; with `mode="autoencoder"` an
OFAMobileNetX4 answers HR frames (learned downscale, then SR), as
`--x4_autoencoder --materialize` does.

`train(steps, ...)` is the training path: the bench's training envelopes
(`bench.py` of the JAX package) on the full-width supernet, batch 16 of
96x96 HR frames with their 2x / 4x LR inputs made from a numpy seed, one or
more sampled subnets a step under the reference's seed contract, Adam with
weight decay 3e-5 and, with `kd_ratio > 0`, KD against the bench's teacher
(ks5/e3/d2/pixel_d 1); `compute_dtype=torch.bfloat16` is the JAX bench's
own mixed-precision training (`SRTrainer(compute_dtype=jnp.bfloat16)`).
An OFAMobileNetX4 trains in its `mode` ("sr": the decoder on the LR
inputs; "autoencoder": encoder and decoder on the HR frame), its subnets
sampled with both trunks' choices.

`search(...)` picks a subnet under a latency budget on this device: it
measures a per-block latency table through the serving path (on the card,
the MBConv and shuffle-tail kernels), runs the evolutionary finder under
`constraint_frac` of the largest subnet's table time, and deploys the
winner beside the smallest and largest uniform subnets: their table and
measured ms and, given a provider, their PSNR-Y after BN recalibration.
The JAX package's `exp/search_deploy_demo.py` flow, without its
checkpoint.

All four run on the GPU unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import tempfile
from typing import Iterable, List, Optional

import numpy as np
import torch

from .models.arch import (
    SearchSpace,
    SubnetConfig,
    sample_subnet,
    subnet_seed,
    uniform_subnet,
)
from .models.materialize import get_active_subnet
from .models.ofa_s4 import OFAMobileNetS4
from .models.ofa_x4 import OFAMobileNetX4
from .parallel.mesh import shard_batch, shard_params
from .search.evolution import EvolutionFinder, require_constraint_share
from .search.flops import mbconv_macs
from .search.latency import build_block_latency_table, lut_efficiency_fn, measure_latency_device
from .train.run_manager import RunConfig, SRRunManager
from .train.train_step import SRTrainer
from .utils.device import resolve_device

N_BATCH = 50  # steps per epoch in the subnet seeds: DIV2K's 800 images / 16


def entry(device="cuda"):
    """(fn, example_args): fn(*example_args) is the supernet eval forward."""
    dev = resolve_device(device)
    space = SearchSpace()  # ks 3/5/7, e 3/4/6, d 2/3/4, pixel_d 1/2
    net = OFAMobileNetS4(space, device=dev)
    cfg = sample_subnet(space, seed=0)
    x2 = torch.from_numpy(
        np.random.RandomState(0).rand(16, 48, 48, 3).astype(np.float32)).to(dev)

    def fn(net, x2, cfg):
        with torch.inference_mode():
            return net(x2, cfg, pixel_d=1)

    return fn, (net, x2, cfg)


def _default_net(net, mode, dev, caller):
    """`net`, checked to be on `dev`; by default a seed-0 full-width
    OFAMobileNetS4, or OFAMobileNetX4 for the autoencoder."""
    if net is None:
        return (OFAMobileNetX4 if mode == "autoencoder" else OFAMobileNetS4)(
            SearchSpace(), device=dev)
    if net.device != dev:
        raise ValueError("net is on %s, %s was asked for %s" % (net.device, caller, dev))
    return net


def serve(frames: Iterable, *, net=None, cfg: Optional[SubnetConfig] = None, device="cuda",
          mode: str = "sr") -> List[torch.Tensor]:
    """Super-resolve frames one at a time through a materialized subnet.

    frames: NHWC float arrays or tensors, (1,H,W,3) or (H,W,3): LR frames,
    or with `mode="autoencoder"` HR frames (sides multiples of 2^pixel_d).
    net: the supernet to slice (default: a seed-0 full-width OFAMobileNetS4,
    or OFAMobileNetX4 for the autoencoder, on `device`). cfg: the subnet
    (default ks7/e6/d2/pixel_d 2). On a CUDA device the subnet runs the
    hand-written kernels.
    Returns the HR frames, (1, H*2^pd, W*2^pd, 3) tensors on `device` (the
    input's size in autoencoder mode).
    """
    dev = resolve_device(device)
    net = _default_net(net, mode, dev, "serve")
    if cfg is None:
        cfg = uniform_subnet(net.space, 7, 6, 2, 2, n_trunks=net.n_trunks)
    subnet = get_active_subnet(net, cfg, mode=mode)
    out = []
    with torch.inference_mode():
        for frame in frames:
            x = torch.as_tensor(frame, dtype=torch.float32, device=dev)
            if x.ndim == 3:
                x = x[None]
            out.append(subnet(x.contiguous()))
    return out


def step_subnets(space: SearchSpace, step: int, n_subnets: int,
                 n_trunks: int = 1) -> List[SubnetConfig]:
    """The subnets of training step `step` (epoch 0), in the reference's
    seed contract, for a net of `n_trunks` trunks."""
    return [sample_subnet(space, seed=subnet_seed(0, N_BATCH, step, k), n_trunks=n_trunks)
            for k in range(n_subnets)]


def synthetic_batch(batch_size, hr_size, device, seed=0):
    """{"image", "x2", "x4"}: uniform [0, 1) NHWC frames from a numpy seed."""
    rng = np.random.RandomState(seed)
    sizes = {"image": hr_size, "x2": hr_size // 2, "x4": hr_size // 4}
    return {k: torch.from_numpy(rng.rand(batch_size, s, s, 3).astype(np.float32)).to(device)
            for k, s in sizes.items()}


def kd_teacher(space: SearchSpace, device):
    """The bench's KD teacher at the student's width and stage count:
    (net, its ks5/e3/d2/pixel_d 1 subnet, pixel_d), weights from seed 7."""
    t_space = SearchSpace(ks_list=[5], expand_list=[3], depth_list=[2], pixel_d_list=[1],
                          n_stages=space.n_stages, width=space.width)
    t_net = OFAMobileNetS4(t_space, device=device, generator=torch.Generator().manual_seed(7))
    return t_net, uniform_subnet(t_space, 5, 3, 2, 1), 1


def train(steps: int, *, n_subnets: int = 1, kd_ratio: float = 0.0, device="cuda",
          net=None, batch_size: int = 16, hr_size: int = 96,
          lr: float = 1e-4, use_kernels: Optional[bool] = None,
          compute_dtype: Optional[torch.dtype] = None, mode: str = "sr",
          mesh=None) -> List[dict]:
    """Train `net` (default: a seed-0 full-width OFAMobileNetS4, or
    OFAMobileNetX4 for the autoencoder, on `device`) for `steps` optimizer
    steps of `n_subnets` subnets each, on one synthetic batch, in `mode`.
    On a CUDA net train-mode BN runs the BN-statistics kernels unless
    `use_kernels=False`. `compute_dtype` (None: float32; torch.bfloat16:
    mixed precision, float32 masters) as `SRTrainer`'s. `mesh` (a
    `parallel.Mesh`): data-parallel training, `batch_size` the global batch
    of which each rank trains its rows, from rank 0's weights.
    Returns each step's {"loss", "psnr"} (the global batch's) as floats."""
    dev = resolve_device(device)
    net = _default_net(net, mode, dev, "train")
    teacher = kd_teacher(net.space, dev) if kd_ratio > 0 else None
    trainer = SRTrainer(net, opt_type="adam", weight_decay=3e-5, kd_ratio=kd_ratio,
                        teacher=teacher, use_kernels=use_kernels, compute_dtype=compute_dtype,
                        mode=mode, mesh=mesh)
    batch = synthetic_batch(batch_size, hr_size, dev)
    if mesh is not None:
        shard_params(net, mesh)
        batch = shard_batch(batch, mesh)
    metrics = [trainer.train_step(batch, step_subnets(net.space, i, n_subnets, net.n_trunks), lr)
               for i in range(steps)]
    return [{k: float(v) for k, v in m.items()} for m in metrics]


def search(net=None, provider=None, *, hr_size: int = 720, constraint_frac: float = 0.85,
           quality: str = "macs", population_size: int = 64, generations: int = 30,
           device="cuda") -> dict:
    """Search `net` (default: a seed-0 full-width OFAMobileNetS4 on
    `device`; an OFAMobileNetX4 is searched over its decoder, the trunk sr
    mode runs) for the subnet of most quality within `constraint_frac` of
    the largest uniform subnet's latency, then deploy it.

    The latency is `lut_efficiency_fn` of a block table measured at
    `hr_size` HR output (`build_block_latency_table`). Quality: "macs", the
    trunk's closed-form MACs (every block at the LR size of the largest
    pixel_d), or "psnr", the masked supernet's PSNR-Y on `provider`'s test
    frames (memoized, no recalibration). Deployed: the smallest and the
    largest uniform subnets (at the largest pixel_d) and the winner, each
    with its table ms, the measured ms of the materialized subnet on a
    batch-1 frame at its own LR size, and, given `provider`, its PSNR-Y
    after BN recalibration on `provider.train`.

    The default budget is 0.85 of the largest subnet's time, not the JAX
    demo's 0.6 (an X4 decoder at 96 px): at 720 px the S4's stem, final
    convs and shuffle stages take over half of even its largest subnet's
    time on the H100, and 0.6 leaves next to no subnet under the budget.

    Returns {"constraint_ms", "lut" (the table), "winner" (its
    SubnetConfig), "history" (the finder's best quality by generation),
    "candidates": {"uniform_min", "uniform_max", "searched": {"cfg",
    "lut_ms", "true_ms", "trunk_gmacs"[, "psnr_db"]}}}."""
    dev = resolve_device(device)
    net = _default_net(net, "sr", dev, "search")
    space, n_trunks = net.space, net.n_trunks
    if quality not in ("macs", "psnr") or (quality == "psnr" and provider is None):
        raise ValueError("quality must be 'macs', or 'psnr' with a provider; got %r"
                         % (quality,))
    # 'sr' mode runs the last trunk: the S4's only one, the X4's decoder
    stages = range(space.n_stages * (n_trunks - 1), space.n_stages * n_trunks)
    table = build_block_latency_table(net, space, hr_size=hr_size, trunk_stages=len(stages))
    eff = lut_efficiency_fn(table, space, hr_size=hr_size, n_trunks=n_trunks)
    pd_max = max(space.pixel_d_list)
    lr_macs = hr_size // (2 ** pd_max)

    def trunk_macs(cfg):
        return sum(mbconv_macs(space, lr_macs, cfg.ks[si * space.max_depth + i],
                               cfg.e[si * space.max_depth + i])
                   for si in stages for i in range(cfg.d[si]))

    big = uniform_subnet(space, max(space.ks_list), max(space.expand_list),
                         max(space.depth_list), pd_max, n_trunks=n_trunks)
    small = uniform_subnet(space, min(space.ks_list), min(space.expand_list),
                           min(space.depth_list), pd_max, n_trunks=n_trunks)
    constraint = constraint_frac * eff(big)
    # the finder draws random subnets until one meets the constraint (as in
    # the JAX package): refuse a constraint so tight that it would draw
    # for ever, with another random stream than the finder's
    require_constraint_share(space, eff, constraint, largest=big, smallest=small,
                             n_trunks=n_trunks)

    with tempfile.TemporaryDirectory(prefix="ofa_search_") as tmp:
        rm = None
        if provider is not None:
            rm = SRRunManager(tmp, net, RunConfig(image_size=provider.image_size, manual_seed=0,
                                                  bn_recalib_before_eval=True), provider)
        psnr_cache = {}

        def psnr_quality(cfg):
            if cfg not in psnr_cache:
                psnr_cache[cfg] = rm.validate(cfg)[1]
            return psnr_cache[cfg]

        finder = EvolutionFinder(space, efficiency_fn=eff,
                                 quality_fn=trunk_macs if quality == "macs" else psnr_quality,
                                 n_trunks=n_trunks, population_size=population_size,
                                 max_time_budget=generations, seed=0)
        winner, _, history = finder.run(constraint)

        report = {"constraint_ms": constraint, "lut": dict(table.table), "winner": winner,
                  "history": history, "candidates": {}}
        rng = np.random.RandomState(0)
        for name, cfg in (("uniform_min", small), ("uniform_max", big), ("searched", winner)):
            lr = hr_size // (2 ** cfg.pixel_d)
            x = torch.from_numpy(rng.rand(1, lr, lr, 3).astype(np.float32)).to(dev)
            entry_ = {"cfg": repr(cfg), "lut_ms": eff(cfg),
                      "true_ms": measure_latency_device(get_active_subnet(net, cfg), x),
                      "trunk_gmacs": trunk_macs(cfg) / 1e9}
            if rm is not None:
                entry_["psnr_db"] = rm.validate(cfg, recalib_loader=provider.train)[1]
            report["candidates"][name] = entry_
    return report
