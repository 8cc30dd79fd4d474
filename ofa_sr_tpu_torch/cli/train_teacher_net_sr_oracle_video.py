"""Validate (or finetune) a finished 2x SR teacher on video frames
(counterpart of ofa_sr_tpu/cli/train_teacher_net_sr_oracle_video.py).

A singleton OFAMobileNetS4 (ks 5, e 3, d 2, pixel_d 1) on the oracle-video
frames (480 px center crops), BN frozen in eval mode: validate-only by
default, `--finetune` trains it (batch 4, Adam 1e-5, 5 epochs).

Run: python -m ofa_sr_tpu_torch.cli.train_teacher_net_sr_oracle_video [--synthetic] [--device cpu]
"""

from __future__ import annotations

import argparse

from ..data import OracleVideoProvider
from ..models import OFAMobileNetS4, SearchSpace
from ..models.arch import max_subnet
from ..train import RunConfig, SRRunManager
from .common import add_common_args, make_net, make_sr_provider, set_seeds


def build_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, path="exp/sr/teacher_oracle_video", n_epochs=5, base_lr=1e-5,
                    batch_size=4, image_size=480)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="teacher checkpoint (dir or file)")
    p.add_argument("--finetune", action="store_true",
                   help="finetune at --image_size instead of validate-only")
    return p.parse_args(argv)


def main(argv=None):
    args = build_args(argv)
    set_seeds(args.manual_seed)

    space = SearchSpace(ks_list=[5], expand_list=[3], depth_list=[2], pixel_d_list=[1])
    net = make_net(OFAMobileNetS4, space, args)
    provider = make_sr_provider(args, OracleVideoProvider)
    cfg = RunConfig(
        n_epochs=args.n_epochs, base_lr=args.base_lr,
        opt_type=args.opt_type, weight_decay=args.weight_decay,
        clip_grad_norm=args.clip_grad_norm or None,
        train_batch_size=args.base_batch_size,
        manual_seed=args.manual_seed, bn_frozen=True,
        image_size=args.image_size, compute_dtype=args.compute_dtype)
    rm = SRRunManager(args.path, net, cfg, provider)
    if args.checkpoint:
        rm.load_weights(args.checkpoint)

    if args.finetune:
        best = rm.train()
        rm.write_log("teacher finetune done: best psnr %.3f" % best, "valid")
        return best
    loss, psnr = rm.validate(max_subnet(space))
    rm.write_log("teacher validate: loss %.5f psnr %.3f" % (loss, psnr), "valid")
    return psnr


if __name__ == "__main__":
    main()
