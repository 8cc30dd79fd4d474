"""Train the CIFAR-10 elastic-kernel supernet (counterpart of
ofa_sr_tpu/cli/train_ofa_net_cifar10_simple.py, the working form of the
reference's single-host script).

OFAMobileNetV3 with 10 classes and elastic kernel (3/5/7, e6, d4), SGD with
Nesterov momentum, optional KD (`--kd_ratio`, `--teacher_ckpt`: the
teacher CLI's checkpoint, a ks7/e6/d4 net with 10 classes), the gradients
of `--dynamic_batch_size` subnets summed a step, an optional lenient warm
start.

Run: python -m ofa_sr_tpu_torch.cli.train_ofa_net_cifar10_simple [--synthetic] [--device cpu]
"""

from __future__ import annotations

import argparse

from ..models import OFAMobileNetV3
from ..train import ClsRunManager, RunConfig
from ..train.checkpoint import load_weights_strict
from .common import add_device_arg, add_perf_args, perf_config_kw, seeded, set_seeds
from .train_teacher_net_cifar10_simple import cifar_provider


def build_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path", type=str, default="exp/cls/cifar10_ofa_kernel")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    add_device_arg(p)
    p.add_argument("--n_epochs", type=int, default=120)
    p.add_argument("--base_lr", type=float, default=3e-2)
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--base_batch_size", type=int, default=256)
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--dynamic_batch_size", type=int, default=1)
    p.add_argument("--kd_ratio", type=float, default=0.0)
    p.add_argument("--teacher_ckpt", type=str, default=None)
    p.add_argument("--warmstart", type=str, default=None)
    p.add_argument("--manual_seed", type=int, default=0)
    add_perf_args(p)
    return p.parse_args(argv)


def main(argv=None):
    args = build_args(argv)
    set_seeds(args.manual_seed)
    net = OFAMobileNetV3(n_classes=10, ks_list=[3, 5, 7], expand_list=[6], depth_list=[4],
                         device=args.device, generator=seeded(args))
    teacher, kd_ratio = None, args.kd_ratio
    if kd_ratio > 0 and args.teacher_ckpt:
        t_net = OFAMobileNetV3(n_classes=10, ks_list=[7], expand_list=[6], depth_list=[4],
                               device=args.device)
        teacher = (load_weights_strict(args.teacher_ckpt, t_net), t_net.max_arch())
    else:
        kd_ratio = 0.0
    cfg = RunConfig(n_epochs=args.n_epochs, base_lr=args.base_lr,
                    warmup_epochs=args.warmup_epochs, opt_type="sgd", weight_decay=3e-5,
                    train_batch_size=args.base_batch_size,
                    dynamic_batch_size=args.dynamic_batch_size, kd_ratio=kd_ratio,
                    kd_type="ce", manual_seed=args.manual_seed,
                    **perf_config_kw(args))
    rm = ClsRunManager(args.path, net, cfg, cifar_provider(args), teacher=teacher)
    if args.warmstart:
        rm.load_weights(args.warmstart)
    best = rm.train()
    rm.write_log("cifar10 ofa kernel supernet: best top1 %.2f" % best, "valid")
    return best


if __name__ == "__main__":
    main()
