"""Evaluate a subnet of a trained SR supernet (counterpart of
ofa_sr_tpu/cli/eval_ofa_net_sr.py).

Load a checkpoint leniently (`--checkpoint`), pick a subnet (default ks 7,
e 6, d 2, pixel_d 2), optionally recalibrate its BN statistics
(`--bn_recalib`), and score the test frames at batch 1 with PSNR-Y: through
the run manager's `validate`, or with `--materialize` through the static
subnet (`get_active_subnet`), which on a CUDA net runs the fused MBConv and
shuffle-tail kernels. Materialized frames are timed with CUDA events on
the card; `--frame_log` receives {"frame", "psnr", "sec"} per frame.
`--x4_autoencoder` evaluates an OFAMobileNetX4 in autoencoder mode: the net
takes the HR frame, downscales it and super-resolves it.

Not ported yet, and refused: `--export` (ROADMAP queue 1 item 13),
`--tile` / `--tile_mesh` / `--spatial_mesh` (item 10), and the oracle-video
dataset (item 7) outside `--synthetic`.

Run: python -m ofa_sr_tpu_torch.cli.eval_ofa_net_sr --checkpoint <dir> [--synthetic]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..data import Div2KSetXXProvider
from ..models import (
    OFAMobileNetS4,
    OFAMobileNetX4,
    SearchSpace,
    get_active_subnet,
    uniform_subnet,
)
from ..train import RunConfig, SRRunManager
from ..utils.metrics import psnr_y_device
from .common import add_common_args, make_net, make_sr_provider, set_seeds


def build_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, path="exp/sr/eval", n_epochs=1, base_lr=1e-4, batch_size=1,
                    image_size=720)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--dataset", type=str, default="oracle_video",
                   choices=["oracle_video", "div2k"])
    p.add_argument("--ks", type=int, default=7)
    p.add_argument("--expand", type=int, default=6)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--pixel_d", type=int, default=2)
    p.add_argument("--no_fold_tail", action="store_true",
                   help="with --materialize on the plain path: do not fold the output conv "
                        "through the last pixel shuffle")
    p.add_argument("--materialize", action="store_true",
                   help="slice the static subnet (the deployment path)")
    p.add_argument("--bn_recalib", action="store_true")
    p.add_argument("--export", type=str, default=None, help="not ported yet")
    p.add_argument("--frame_log", type=str, default=None,
                   help="JSONL path for per-frame PSNR (and, materialized, seconds)")
    p.add_argument("--tile", type=int, default=None, help="not ported yet")
    p.add_argument("--tile_mesh", action="store_true", help="not ported yet")
    p.add_argument("--spatial_mesh", action="store_true", help="not ported yet")
    p.add_argument("--x4_autoencoder", action="store_true",
                   help="evaluate an OFAMobileNetX4 in autoencoder mode (learned downscale + "
                        "SR): the net takes the HR frame itself")
    return p.parse_args(argv)


_UNPORTED = (
    ("export", "--export (an AOT serving artifact, models/export.py)", 13),
    ("tile", "--tile (overlap-tiled inference, train/tiled_infer.py)", 10),
    ("tile_mesh", "--tile_mesh", 10),
    ("spatial_mesh", "--spatial_mesh (parallel/spatial.py)", 10),
)


def _refuse_unported(args):
    for attr, what, item in _UNPORTED:
        if getattr(args, attr):
            raise NotImplementedError("%s is not ported yet: ROADMAP queue 1 item %d"
                                      % (what, item))
    if args.dataset == "oracle_video" and not args.synthetic:
        raise NotImplementedError("--dataset oracle_video (OracleVideoProvider) is not "
                                  "ported yet: ROADMAP queue 1 item 7; use --dataset div2k "
                                  "or --synthetic")


def _timed(fn, cuda):
    """(fn(), its seconds): CUDA events on the card, the host clock on the
    CPU."""
    if not cuda:
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def materialized_eval(rm, sub_cfg, args):
    """Mean PSNR-Y of the static subnet over the test frames."""
    net = rm.net
    subnet = get_active_subnet(net, sub_cfg, mode=rm.run_config.mode,
                               fold_tail=not args.no_fold_tail)
    key = "image" if subnet.mode == "autoencoder" else "x%d" % (2 ** sub_cfg.pixel_d)
    cuda = net.device.type == "cuda"
    psnrs, times = [], []
    log_f = open(args.frame_log, "a") if args.frame_log else None
    try:
        with torch.inference_mode():
            for fi, batch in enumerate(rm.provider.test):
                x = torch.from_numpy(batch[key]).to(net.device)
                hr = torch.from_numpy(batch["image"]).to(net.device)
                out, sec = _timed(lambda: subnet(x), cuda)
                p = float(psnr_y_device(out, hr))
                psnrs.append(p)
                times.append(sec)
                if log_f is not None:
                    log_f.write(json.dumps({"frame": fi, "psnr": p, "sec": sec}) + "\n")
    finally:
        if log_f is not None:
            log_f.close()
    # the first frame carries the first calls' set-up
    fps = len(times[1:]) / sum(times[1:]) if len(times) > 1 else 0.0
    rm.write_log("materialized subnet (%s): psnr %.3f  %.1f frames/s"
                 % ("kernels" if subnet.use_kernels else "plain", float(np.mean(psnrs)), fps),
                 "valid")
    return float(np.mean(psnrs))


def main(argv=None):
    args = build_args(argv)
    _refuse_unported(args)
    set_seeds(args.manual_seed)

    space = SearchSpace()
    ae = args.x4_autoencoder
    net = make_net(OFAMobileNetX4 if ae else OFAMobileNetS4, space, args)
    provider = make_sr_provider(args, Div2KSetXXProvider)
    cfg = RunConfig(test_batch_size=1, image_size=args.image_size,
                    bn_recalib_before_eval=args.bn_recalib,
                    mode="autoencoder" if ae else "sr")
    rm = SRRunManager(args.path, net, cfg, provider)
    if args.checkpoint:
        rm.load_weights(args.checkpoint)

    sub_cfg = uniform_subnet(space, args.ks, args.expand, args.depth, args.pixel_d,
                             n_trunks=net.n_trunks)
    if args.bn_recalib:
        rm.reset_running_statistics(sub_cfg, n_images=64, batch_size=16)
    if args.materialize:
        return materialized_eval(rm, sub_cfg, args)

    loss, psnr = rm.validate(sub_cfg, frame_log=args.frame_log)
    rm.write_log("eval %s: loss %.5f psnr %.3f" % (sub_cfg.describe()[:60], loss, psnr), "valid")
    return psnr


if __name__ == "__main__":
    main()
