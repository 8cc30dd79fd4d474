"""Search and deploy a trained X4 supernet (counterpart of
exp/search_deploy_demo.py): the train-once, specialize-everywhere story on
the curriculum's expand checkpoint.

Inputs: a curriculum run's directory (`ofa_sr_tpu_torch.exp.curriculum
--out DIR`): its expand-phase checkpoint (`DIR/port/expand/checkpoint`,
ks, e and d all elastic) and its image tree (`DIR/data`). Steps:
1. a per-block latency table of the X4 decoder measured on the device
   (`build_block_latency_table`; on the card the MBConv kernel's launches,
   timed as CUDA-graph replays);
2. `EvolutionFinder` under a budget of `--constraint_frac` of the largest
   uniform subnet's table time, the efficiency the table's sum over the
   decoder's genes (sr mode runs the decoder alone); the quality the
   decoder's closed-form MACs (`--quality macs`) or the masked supernet's
   PSNR-Y on the val frames (`--quality psnr`, memoized, without BN
   recalibration: the role the reference's accuracy predictor plays);
3. the smallest and largest uniform subnets and the winner deployed: PSNR-Y
   after BN recalibration on the train split, table ms, decoder GMACs, and
   the materialized subnet's measured ms (`measure_latency_device`).

Run: python -m ofa_sr_tpu_torch.exp.search_deploy_demo --curriculum DIR [--quality psnr]
       [--device cpu]
Writes a JSON report to --out (default DIR/search_deploy_<quality>.json).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..cli.train_ofa_net_sr_simple import TASK_PHASES
from ..data import Div2KSetXXProvider
from ..models import OFAMobileNetX4, SearchSpace, get_active_subnet
from ..models.arch import uniform_subnet
from ..search import latency
from ..search.evolution import EvolutionFinder, require_constraint_share
from ..search.flops import _conv_macs
from ..train import RunConfig, SRRunManager
from ..utils.device import device_name, resolve_device

POPULATIONS = {"macs": (64, 30), "psnr": (24, 12)}  # (population, generations)


def expand_space():
    spec = TASK_PHASES[("expand", 2)]
    return SearchSpace(ks_list=spec["ks_list"], expand_list=spec["expand_list"],
                       depth_list=spec["depth_list"], pixel_d_list=spec["pixel_d_list"])


def dec_macs(space, cfg, lr):
    """The decoder trunk's MBConv MACs at LR side `lr` (sr mode runs these
    genes alone)."""
    w = space.width
    total = 0
    for si in range(space.n_stages, 2 * space.n_stages):
        for i in range(cfg.d[si]):
            bi = si * space.max_depth + i
            mid = space.mid_channels(cfg.e[bi])
            total += (_conv_macs(lr, lr, w, mid, 1)
                      + _conv_macs(lr, lr, mid, mid, cfg.ks[bi], groups=mid)
                      + _conv_macs(lr, lr, mid, w, 1))
    return total


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--curriculum", required=True,
                    help="a curriculum run's --out directory")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device: the card by default, or 'cpu'")
    ap.add_argument("--hr", type=int, default=96, help="HR side of the latency table")
    ap.add_argument("--crop", type=int, default=32)
    ap.add_argument("--constraint_frac", type=float, default=0.6)
    ap.add_argument("--quality", default="macs", choices=["macs", "psnr"],
                    help="the search objective: the decoder's closed-form MACs, or the "
                         "masked supernet's PSNR-Y on the val frames (memoized)")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    space = expand_space()
    net = OFAMobileNetX4(space, device=dev)
    provider = Div2KSetXXProvider(root=os.path.join(a.curriculum, "data"),
                                  image_size=a.crop, train_batch_size=4, num_workers=2)
    rm = SRRunManager(os.path.join(a.curriculum, "port_eval", "search_deploy"), net,
                      RunConfig(image_size=a.crop, manual_seed=0, bn_recalib_before_eval=True),
                      provider)
    ckpt = os.path.join(a.curriculum, "port", "expand", "checkpoint")
    if rm.load_weights(ckpt)["kept_template"]:
        raise ValueError("%s does not hold every tensor of the expand space's X4: not an "
                         "expand-phase checkpoint" % ckpt)

    print("building the decoder block table on %s" % device_name(dev), flush=True)
    table = latency.build_block_latency_table(net, space, hr_size=a.hr,
                                              trunk_stages=space.n_stages)
    eff = latency.lut_efficiency_fn(table, space, hr_size=a.hr, n_trunks=2,
                                    stage_range=(space.n_stages, 2 * space.n_stages))
    lr = a.hr // (2 ** max(space.pixel_d_list))
    big = uniform_subnet(space, 7, 6, 4, 2, n_trunks=2)
    small = uniform_subnet(space, 3, 3, 2, 2, n_trunks=2)
    constraint = a.constraint_frac * eff(big)
    share = require_constraint_share(space, eff, constraint, largest=big, smallest=small,
                                     n_trunks=2)

    psnr_cache = {}

    def psnr_quality(cfg):
        # the masked supernet's PSNR-Y without recalibration: a proxy, as
        # the reference's accuracy predictor is; recalibration happens once
        # a deployment, below
        if cfg not in psnr_cache:
            psnr_cache[cfg] = rm.validate(cfg)[1]
        return psnr_cache[cfg]

    pop, gens = POPULATIONS[a.quality]
    finder = EvolutionFinder(
        space, efficiency_fn=eff,
        quality_fn=(lambda c: dec_macs(space, c, lr)) if a.quality == "macs" else psnr_quality,
        n_trunks=2, population_size=pop, max_time_budget=gens, seed=0)
    winner, _, history = finder.run(constraint)
    print("winner:", winner.describe(), flush=True)

    report = {"device_name": device_name(dev), "quality": a.quality, "hr": a.hr,
              "constraint_frac": a.constraint_frac, "constraint_ms": constraint,
              "constraint_share": share, "lut": dict(table.table), "winner": winner.to_dict(),
              "history": history, "candidates": {}}
    rng = np.random.RandomState(0)
    for name, cfg in (("uniform_min", small), ("uniform_max", big), ("searched", winner)):
        _, psnr = rm.validate(cfg, recalib_loader=provider.train)
        x = torch.from_numpy(rng.rand(1, lr, lr, 3).astype(np.float32)).to(dev)
        entry = {"cfg": repr(cfg), "lut_ms": eff(cfg), "psnr_db": psnr,
                 "dec_gmacs": dec_macs(space, cfg, lr) / 1e9,
                 "true_ms": latency.measure_latency_device(get_active_subnet(net, cfg), x)}
        report["candidates"][name] = entry
        print(name, entry, flush=True)

    out = a.out or os.path.join(a.curriculum, "search_deploy_%s.json" % a.quality)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
