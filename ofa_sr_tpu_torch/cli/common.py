"""Shared CLI plumbing for the port's entry points (counterpart of
ofa_sr_tpu/cli/common.py).

Each script exposes the reference preset as defaults and lets any of them
be overridden; `--synthetic` swaps the dataset for the synthetic provider,
so every entry point runs without an image tree. `--device` (default
`cuda`) picks the card; `--device cpu` runs on the CPU. `add_perf_args`
gives the training CLIs the JAX package's `--compute_dtype`, `--ks_switch`,
`--dw_switch [dw|project]` and `--dw_align` (on the CLIs where JAX's
`add_perf_args` has them), and `perf_config_kw` maps them to the RunConfig
as JAX's does. The depthwise levers act in the masked window step
(`RunConfig.steps_per_dispatch` > 1, which these CLIs leave at 1, as JAX's
do); the eager sliced step already runs only the sampled taps and channels.
Its `--remat` is not ported (the steps fit the card's memory without
rematerialization; ROADMAP queue 1 item 14); nor is its `s2d` option: the
trunk in space-to-depth layout, block-diagonal 4x-deep 1x1 contractions
for the TPU's matrix unit (ofa_sr_tpu/train/train_step.py:120-123), which
changes no number; cuDNN and csrc/mbconv.cu take NHWC at any depth, so
the layout buys nothing here.
"""

from __future__ import annotations

import argparse
import random

import numpy as np
import torch
from torch import nn

from ..data import SyntheticSRProvider
from ..parallel.mesh import init_distributed, make_mesh


def add_common_args(parser: argparse.ArgumentParser, *, path, n_epochs,
                    base_lr, warmup_epochs=0, batch_size=16, image_size=96,
                    dynamic_batch_size=1):
    parser.add_argument("--path", type=str, default=path)
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--synthetic", action="store_true",
                        help="use the synthetic dataset (no image tree needed)")
    add_device_arg(parser)
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
    add_perf_args(parser)
    return parser


def add_device_arg(parser: argparse.ArgumentParser):
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on: the card by default, or 'cpu'")
    return parser


def add_perf_args(parser: argparse.ArgumentParser):
    """The precision and depthwise flags of the training CLIs (JAX
    `add_perf_args`, without `--remat`)."""
    parser.add_argument("--compute_dtype", type=str, default=None, choices=["f32", "bf16"],
                        help="bf16: mixed precision (float32 master params, BN statistics, "
                             "transform matrices)")
    parser.add_argument("--ks_switch", action="store_true",
                        help="the masked window step's depthwise (RunConfig."
                             "steps_per_dispatch > 1) runs only the sampled kernel size's "
                             "k x k taps, through the hand-written kernel (exact vs "
                             "masking; the same kernel as --dw_switch, whose channel bound "
                             "changes no value there); the eager sliced step does so "
                             "already")
    parser.add_argument("--dw_switch", nargs="?", const="dw", default="off",
                        choices=["off", "dw", "project"],
                        help="the masked window step's depthwise runs only the sampled "
                             "subnet's taps and channels (exact vs masking; supersedes "
                             "--ks_switch), through the hand-written kernel, which reads "
                             "both on the device: no graph a subnet. 'project' runs as "
                             "'dw': the kernel has no branch seam for it to shrink")
    parser.add_argument("--dw_align", type=int, default=0,
                        help="accepted for the JAX package's command lines: there it "
                             "shares compiled branches between widths; the kernel takes any "
                             "width, so it changes nothing. 0 = off")
    return parser


def perf_config_kw(args):
    """RunConfig kwargs for the precision and depthwise flags (JAX
    `perf_config_kw`, without `remat`)."""
    kw = {"compute_dtype": args.compute_dtype}
    if getattr(args, "ks_switch", False):
        kw["ks_switch"] = True
    dws = getattr(args, "dw_switch", "off")
    if dws and dws != "off":
        kw["dw_switch"] = True if dws == "dw" else dws
    if getattr(args, "dw_align", 0):
        kw["dw_align"] = args.dw_align
    return kw


def seeded(args):
    """The generator a CLI's net draws its weights from: --manual_seed's,
    as the JAX package's run managers init from PRNGKey(manual_seed)."""
    return torch.Generator().manual_seed(args.manual_seed)


def set_seeds(seed: int):
    """The reference preamble: Python's and numpy's global RNGs."""
    random.seed(seed)
    np.random.seed(seed)


def init_mesh(args):
    """The run's mesh: the processes torchrun started (`init_distributed`
    reads its environment; each takes the device of its LOCAL_RANK on
    `--device cuda`), or this process alone, a world of one."""
    init_distributed(device=args.device)
    return make_mesh(args.device)


def make_net(net_cls, space, args):
    """`net_cls(space)` on args.device, weights from args.manual_seed, every
    BN with --bn_momentum and --bn_eps."""
    net = net_cls(space, device=args.device, generator=seeded(args))
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
