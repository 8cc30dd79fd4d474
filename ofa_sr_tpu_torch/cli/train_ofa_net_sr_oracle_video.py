"""Per-video oracle specialization (counterpart of
ofa_sr_tpu/cli/train_ofa_net_sr_oracle_video.py).

Overfit one architecture of the X4 supernet (sampled with `--arch_seed`,
or uniform from `--ks/--expand/--depth/--pixel_d`) on one video's frames:
448 px, batch 4, Adam 1e-5, 5 epochs, BN frozen in eval mode (the
reference's oracle configuration), on the codec-decoded LR/HR pairs
(`--dataset codec`) or the video frames (`--dataset oracle_video`). Every
training step trains exactly that architecture (`fixed_cfg`), and each
epoch validates it. BN frozen: no BN kernel runs; on the card the MBConv
blocks run through the supernet's convs, not the serving kernels.

Run: python -m ofa_sr_tpu_torch.cli.train_ofa_net_sr_oracle_video [--synthetic] [--device cpu]
"""

from __future__ import annotations

import argparse

from ..data import CodecDecoderProvider, OracleVideoProvider
from ..models import OFAMobileNetX4, SearchSpace, sample_subnet
from ..models.arch import uniform_subnet
from ..train import RunConfig, SRRunManager
from .common import add_common_args, make_net, make_sr_provider, set_seeds


def build_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", type=str, default="one_arch_overfit",
                   choices=["one_arch_overfit"])
    add_common_args(p, path="exp/sr/oracle_video", n_epochs=5, base_lr=1e-5,
                    batch_size=4, image_size=448)
    p.add_argument("--warmstart", type=str, default=None,
                   help="supernet checkpoint to specialize from")
    p.add_argument("--dataset", type=str, default="codec", choices=["codec", "oracle_video"])
    p.add_argument("--arch_seed", type=int, default=None,
                   help="sample the overfit arch with this seed")
    p.add_argument("--ks", type=int, default=7)
    p.add_argument("--expand", type=int, default=3)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--pixel_d", type=int, default=1)
    return p.parse_args(argv)


def main(argv=None):
    args = build_args(argv)
    set_seeds(args.manual_seed)

    space = SearchSpace()  # the full space; one arch is trained
    net = make_net(OFAMobileNetX4, space, args)
    provider_cls = CodecDecoderProvider if args.dataset == "codec" else OracleVideoProvider
    provider = make_sr_provider(args, provider_cls)

    if args.arch_seed is not None:
        cfg_arch = sample_subnet(space, seed=args.arch_seed, n_trunks=2)
    else:
        cfg_arch = uniform_subnet(space, args.ks, args.expand, args.depth, args.pixel_d,
                                  n_trunks=2)

    cfg = RunConfig(
        n_epochs=args.n_epochs, base_lr=args.base_lr,
        opt_type=args.opt_type, weight_decay=args.weight_decay,
        clip_grad_norm=args.clip_grad_norm or None,
        train_batch_size=args.base_batch_size, dynamic_batch_size=1,
        validation_frequency=args.validation_frequency,
        print_frequency=args.print_frequency,
        manual_seed=args.manual_seed, mode="sr", bn_frozen=True,
        bn_momentum=args.bn_momentum, bn_eps=args.bn_eps,
        image_size=args.image_size, compute_dtype=args.compute_dtype)
    rm = SRRunManager(args.path, net, cfg, provider)
    if args.warmstart:
        rm.load_weights(args.warmstart)

    best = rm.train(validate_cfgs=[cfg_arch], fixed_cfg=cfg_arch)
    rm.write_log("oracle overfit done (%s): best psnr %.3f"
                 % (cfg_arch.describe()[:60], best), "valid")
    return best


if __name__ == "__main__":
    main()
