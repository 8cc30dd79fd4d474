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

Large frames, with `--materialize`, as in the JAX package: `--tile T` runs
each frame as overlapping T-pixel tiles with a halo of the subnet's
receptive-field radius (`train/tiled_infer.py`), `--tile_mesh` splits a
frame's tiles over the ranks, `--spatial_mesh` splits its rows over the
ranks, each with its receptive-field halo (`parallel/spatial.py`). With
`--x4_autoencoder` tile and halo are HR pixels aligned to the
pixel-unshuffle grid. The ranks are the processes torchrun starts
(`torchrun --nproc_per_node=N -m ofa_sr_tpu_torch.cli.eval_ofa_net_sr
--materialize --spatial_mesh ...`); launched plainly, the mesh is this
process alone. Every rank scores the whole frame; rank 0 writes the logs.

`--export PATH` writes the subnet as a serving artifact (`torch.export`
of the materialized plain path with folded BN, models/export.py; served by
`load_subnet`) for the test frames' LR shape, as the JAX package's writes
its StableHLO one (also under `--x4_autoencoder`: the decoder's sr-mode
subnet on the LR frame), then evaluates.

Run: python -m ofa_sr_tpu_torch.cli.eval_ofa_net_sr --checkpoint <dir> [--synthetic]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..data import Div2KSetXXProvider, OracleVideoProvider
from ..models import (
    OFAMobileNetS4,
    OFAMobileNetX4,
    SearchSpace,
    get_active_subnet,
    uniform_subnet,
)
from ..models.export import export_subnet
from ..parallel.spatial import make_spatial_infer
from ..train import RunConfig, SRRunManager
from ..train.tiled_infer import (
    receptive_field_radius,
    receptive_field_radius_autoencoder,
    tiled_sr_infer,
    tiled_sr_infer_mesh,
)
from ..utils.metrics import psnr_y_device
from .common import add_common_args, init_mesh, make_net, make_sr_provider, set_seeds


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
    p.add_argument("--export", type=str, default=None,
                   help="write a serving artifact (torch.export of the BN-folded subnet) for "
                        "the test frames' LR shape, then continue with the evaluation")
    p.add_argument("--frame_log", type=str, default=None,
                   help="JSONL path for per-frame PSNR (and, materialized, seconds)")
    p.add_argument("--tile", type=int, default=None,
                   help="with --materialize: overlap-tiled inference with this LR tile size "
                        "(halo sized to the subnet's receptive field)")
    p.add_argument("--tile_mesh", action="store_true",
                   help="with --tile: split each frame's tiles over the ranks")
    p.add_argument("--spatial_mesh", action="store_true",
                   help="with --materialize: split each frame's rows over the ranks, each "
                        "with its receptive-field halo (parallel/spatial.py; an "
                        "alternative to --tile)")
    p.add_argument("--x4_autoencoder", action="store_true",
                   help="evaluate an OFAMobileNetX4 in autoencoder mode (learned downscale + "
                        "SR): the net takes the HR frame itself")
    return p.parse_args(argv)


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


def frame_infer(subnet, sub_cfg, space, args, mesh):
    """The materialized subnet's frame function under the large-frame
    options: whole frames, `--spatial_mesh`, or `--tile` (`--tile_mesh`),
    with the halo of the subnet's receptive field."""
    ae = subnet.mode == "autoencoder"
    if not (args.spatial_mesh or args.tile):
        return subnet
    sc = 2 ** sub_cfg.pixel_d
    if ae:  # HR-unit halo (and tile) on the pixel-unshuffle grid
        halo, scale = receptive_field_radius_autoencoder(sub_cfg, space), 1
    else:
        halo, scale = receptive_field_radius(sub_cfg, space), sc
    if args.spatial_mesh:
        return make_spatial_infer(subnet, mesh, halo=halo, scale=scale, align=sc if ae else 1)
    tile = -(-args.tile // sc) * sc if ae else args.tile
    if args.tile_mesh:
        return lambda x: tiled_sr_infer_mesh(subnet, x, tile=tile, halo=halo, scale=scale,
                                             mesh=mesh)
    return lambda x: tiled_sr_infer(subnet, x, tile=tile, halo=halo, scale=scale)


def materialized_eval(rm, sub_cfg, args, mesh=None):
    """Mean PSNR-Y of the static subnet over the test frames."""
    net = rm.net
    subnet = get_active_subnet(net, sub_cfg, mode=rm.run_config.mode,
                               fold_tail=not args.no_fold_tail)
    infer = frame_infer(subnet, sub_cfg, net.space, args, mesh)
    key = "image" if subnet.mode == "autoencoder" else "x%d" % (2 ** sub_cfg.pixel_d)
    cuda = net.device.type == "cuda"
    psnrs, times = [], []
    log_f = open(args.frame_log, "a") if args.frame_log and rm.writer else None
    try:
        with torch.inference_mode():
            for fi, batch in enumerate(rm.provider.test):
                x = torch.from_numpy(batch[key]).to(net.device)
                hr = torch.from_numpy(batch["image"]).to(net.device)
                out, sec = _timed(lambda: infer(x), cuda)
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
    set_seeds(args.manual_seed)
    mesh = init_mesh(args)

    space = SearchSpace()
    ae = args.x4_autoencoder
    net = make_net(OFAMobileNetX4 if ae else OFAMobileNetS4, space, args)
    provider = make_sr_provider(
        args, OracleVideoProvider if args.dataset == "oracle_video" else Div2KSetXXProvider)
    cfg = RunConfig(test_batch_size=1, image_size=args.image_size,
                    bn_recalib_before_eval=args.bn_recalib,
                    mode="autoencoder" if ae else "sr")
    rm = SRRunManager(args.path, net, cfg, provider, mesh=mesh)
    if args.checkpoint:
        rm.load_weights(args.checkpoint)

    sub_cfg = uniform_subnet(space, args.ks, args.expand, args.depth, args.pixel_d,
                             n_trunks=net.n_trunks)
    if args.bn_recalib:
        rm.reset_running_statistics(sub_cfg, n_images=64, batch_size=16)
    if args.export and rm.writer:
        lr = next(iter(provider.test))["x%d" % (2 ** sub_cfg.pixel_d)]
        blob = export_subnet(net, sub_cfg, (lr.shape[1], lr.shape[2]), path=args.export)
        rm.write_log("exported %s (%d bytes, input %dx%d)"
                     % (args.export, len(blob), lr.shape[1], lr.shape[2]), "valid")
    if args.materialize:
        return materialized_eval(rm, sub_cfg, args, mesh)

    loss, psnr = rm.validate(sub_cfg, frame_log=args.frame_log)
    rm.write_log("eval %s: loss %.5f psnr %.3f" % (sub_cfg.describe()[:60], loss, psnr), "valid")
    return psnr


if __name__ == "__main__":
    main()
