"""Shared CLI plumbing for the port's entry points (counterpart of
ofa_sr_tpu/cli/common.py).

Each script exposes the reference preset as defaults and lets any of them
be overridden; `--synthetic` swaps the dataset for the synthetic provider,
so every entry point runs without an image tree. `--device` (default
`cuda`) picks the card; `--device cpu` runs on the CPU. The JAX package's
XLA-only flags (`--remat`, `--ks_switch`, `--dw_switch`, `--dw_align`) have
no counterpart (ROADMAP queue 1 item 14).
"""

from __future__ import annotations

import argparse
import random

import numpy as np
import torch
from torch import nn

from ..data import SyntheticSRProvider


def add_common_args(parser: argparse.ArgumentParser, *, path, n_epochs,
                    base_lr, warmup_epochs=0, batch_size=16, image_size=96,
                    dynamic_batch_size=1):
    parser.add_argument("--path", type=str, default=path)
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="use the synthetic dataset (no image tree needed)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on: the card by default, or 'cpu'")
    parser.add_argument("--n_epochs", type=int, default=n_epochs)
    parser.add_argument("--base_lr", type=float, default=base_lr)
    parser.add_argument("--warmup_epochs", type=int, default=warmup_epochs)
    parser.add_argument("--warmup_lr", type=float, default=-1)
    parser.add_argument("--base_batch_size", type=int, default=batch_size)
    parser.add_argument("--image_size", type=int, default=image_size)
    parser.add_argument("--opt_type", type=str, default="adam")
    parser.add_argument("--weight_decay", type=float, default=3e-5)
    parser.add_argument("--clip_grad_norm", type=float, default=0,
                        help="global-norm gradient clipping; 0 = off (the reference never "
                             "clips)")
    parser.add_argument("--manual_seed", type=int, default=0)
    parser.add_argument("--validation_frequency", type=int, default=1)
    parser.add_argument("--print_frequency", type=int, default=10)
    parser.add_argument("--save_frequency", type=int, default=1,
                        help="epochs between checkpoint saves on non-validation epochs "
                             "(the final epoch always saves)")
    parser.add_argument("--n_worker", type=int, default=8)
    parser.add_argument("--bn_momentum", type=float, default=0.1)
    parser.add_argument("--bn_eps", type=float, default=1e-5)
    parser.add_argument("--dy_conv_scaling_mode", type=int, default=1, choices=[1],
                        help="1: learned kernel-transform matrices (the only mode the port "
                             "has)")
    parser.add_argument("--kd_ratio", type=float, default=0.0)
    parser.add_argument("--dynamic_batch_size", type=int, default=dynamic_batch_size)
    parser.add_argument("--compute_dtype", type=str, default=None, choices=["f32", "bf16"],
                        help="bf16: mixed precision (float32 master params, BN statistics, "
                             "transform matrices)")
    return parser


def set_seeds(seed: int):
    """The reference preamble: Python's and numpy's global RNGs."""
    random.seed(seed)
    np.random.seed(seed)


def make_net(net_cls, space, args):
    """`net_cls(space)` on args.device, weights from args.manual_seed, every
    BN with --bn_momentum and --bn_eps."""
    net = net_cls(space, device=args.device,
                  generator=torch.Generator().manual_seed(args.manual_seed))
    for m in net.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.momentum, m.eps = args.bn_momentum, args.bn_eps
    return net


def make_sr_provider(args, provider_cls, **kw):
    if args.synthetic:
        return SyntheticSRProvider(n_train=64, n_valid=4, hr_size=args.image_size,
                                   train_batch_size=args.base_batch_size)
    return provider_cls(root=args.data_root, image_size=args.image_size,
                        train_batch_size=args.base_batch_size,
                        num_workers=args.n_worker, **kw)
