"""Train the CIFAR-10 classification teacher (counterpart of
ofa_sr_tpu/cli/train_teacher_net_cifar10_simple.py).

OFAMobileNetV3 with singleton elastic lists (in effect static, k7/e6/d4 by
default), 10 classes, SGD with Nesterov momentum, label smoothing 0.1,
batch 2048, cosine LR with 5 warmup epochs, 180 epochs. Resumes from the
run's checkpoint when there is one. Its checkpoint is the KD teacher of
`train_ofa_net_cifar10_simple --teacher_ckpt`.

Run: python -m ofa_sr_tpu_torch.cli.train_teacher_net_cifar10_simple [--synthetic] [--device cpu]
"""

from __future__ import annotations

import argparse

from ..data import Cifar10Provider, SyntheticClsProvider
from ..models import OFAMobileNetV3
from ..train import ClsRunManager, RunConfig
from .common import add_device_arg, add_perf_args, perf_config_kw, seeded, set_seeds


def build_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path", type=str, default="exp/cls/cifar10_teacher")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    add_device_arg(p)
    p.add_argument("--n_epochs", type=int, default=180)
    p.add_argument("--base_lr", type=float, default=0.1)
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--base_batch_size", type=int, default=2048)
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--label_smoothing", type=float, default=0.1)
    p.add_argument("--manual_seed", type=int, default=0)
    p.add_argument("--ks", type=int, default=7)
    p.add_argument("--expand", type=int, default=6)
    p.add_argument("--depth", type=int, default=4)
    add_perf_args(p)
    return p.parse_args(argv)


def cifar_provider(args):
    """The synthetic provider (two batches) or CIFAR-10 from --data_root."""
    if args.synthetic:
        return SyntheticClsProvider(n_train=args.base_batch_size * 2, n_test=64,
                                    image_size=args.image_size, n_classes=10,
                                    train_batch_size=args.base_batch_size)
    return Cifar10Provider(root=args.data_root, image_size=args.image_size,
                           train_batch_size=args.base_batch_size)


def main(argv=None):
    args = build_args(argv)
    set_seeds(args.manual_seed)
    net = OFAMobileNetV3(n_classes=10, ks_list=[args.ks], expand_list=[args.expand],
                         depth_list=[args.depth], device=args.device, generator=seeded(args))
    cfg = RunConfig(n_epochs=args.n_epochs, base_lr=args.base_lr,
                    warmup_epochs=args.warmup_epochs, opt_type="sgd", weight_decay=3e-5,
                    train_batch_size=args.base_batch_size, manual_seed=args.manual_seed,
                    **perf_config_kw(args))
    rm = ClsRunManager(args.path, net, cfg, cifar_provider(args),
                       label_smoothing=args.label_smoothing)
    rm.load_model()  # resume if a checkpoint exists
    best = rm.train()
    rm.write_log("cifar10 teacher: best top1 %.2f" % best, "valid")
    return best


if __name__ == "__main__":
    main()
