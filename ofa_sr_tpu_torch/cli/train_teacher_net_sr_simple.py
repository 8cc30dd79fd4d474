"""Train the 2x SR teacher on DIV2K patches (counterpart of
ofa_sr_tpu/cli/train_teacher_net_sr_simple.py).

An OFAMobileNetS4 with singleton elastic lists (ks 5, e 3, d 2, pixel_d 1:
in effect a static net), Adam 1e-3, cosine with 5 warmup epochs, batch 16,
96 px crops, 100 epochs, MSE loss, PSNR-Y validation at batch 1. Resumes
from the run's checkpoint when there is one.

Run: python -m ofa_sr_tpu_torch.cli.train_teacher_net_sr_simple [--synthetic] [--device cpu]
"""

from __future__ import annotations

import argparse

from ..data import Div2KSetXXProvider
from ..models import OFAMobileNetS4, SearchSpace
from ..train import RunConfig, SRRunManager
from .common import add_common_args, make_net, make_sr_provider, perf_config_kw, set_seeds


def build_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p, path="exp/sr/teacher", n_epochs=100, base_lr=1e-3, warmup_epochs=5)
    p.add_argument("--ks", type=int, default=5)
    p.add_argument("--warmstart", type=str, default=None,
                   help="checkpoint dir/file to warm-start weights from")
    p.add_argument("--bn_mode", type=str, default="frozen", choices=["frozen", "train"],
                   help="'frozen' mirrors the reference teacher: every BN in eval mode, so "
                        "the teacher trains with its init running stats. 'train' updates BN "
                        "statistics normally.")
    p.add_argument("--expand", type=int, default=3)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--pixel_d", type=int, default=1)
    return p.parse_args(argv)


def main(argv=None):
    args = build_args(argv)
    set_seeds(args.manual_seed)

    space = SearchSpace(ks_list=[args.ks], expand_list=[args.expand],
                        depth_list=[args.depth], pixel_d_list=[args.pixel_d])
    net = make_net(OFAMobileNetS4, space, args)
    provider = make_sr_provider(args, Div2KSetXXProvider)
    cfg = RunConfig(
        n_epochs=args.n_epochs, base_lr=args.base_lr,
        warmup_epochs=args.warmup_epochs, warmup_lr=args.warmup_lr,
        opt_type=args.opt_type, weight_decay=args.weight_decay,
        clip_grad_norm=args.clip_grad_norm or None,
        train_batch_size=args.base_batch_size,
        validation_frequency=args.validation_frequency,
        print_frequency=args.print_frequency,
        save_frequency=args.save_frequency,
        manual_seed=args.manual_seed, bn_momentum=args.bn_momentum,
        bn_eps=args.bn_eps, image_size=args.image_size,
        bn_frozen=args.bn_mode == "frozen", **perf_config_kw(args))
    rm = SRRunManager(args.path, net, cfg, provider)
    if args.warmstart:
        rm.load_weights(args.warmstart)
    rm.load_model()  # resume if a checkpoint exists
    best = rm.train()
    rm.write_log("teacher done: best psnr %.3f" % best, "valid")
    return best


if __name__ == "__main__":
    main()
