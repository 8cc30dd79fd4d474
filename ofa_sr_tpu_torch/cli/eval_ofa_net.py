"""Evaluate a (sampled) subnet of a classification OFA supernet
(counterpart of ofa_sr_tpu/cli/eval_ofa_net.py, the reference's
eval_ofa_net.py).

The canonical OFA deployment eval: build the supernet (`model_zoo.ofa_net`,
from `--checkpoint`), pick a subnet (`--arch_seed`; -1: the max subnet),
recalibrate its BN statistics on a calibration subset
(`reset_running_statistics`), then report top-1 / top-5 through the run
manager's `validate`, or with `--materialize` the top-1 of the static
subnet (`get_active_cls_subnet`). `--export PATH` writes the recalibrated
subnet as a serving artifact (`export_cls_subnet`: `torch.export` of the
materialized plain path, served by `models.export.load_subnet`).

Run: python -m ofa_sr_tpu_torch.cli.eval_ofa_net --net ofa_mbv3_d234_e346_k357_w1.0 \
       [--checkpoint <dir>] [--synthetic] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data import Cifar10Provider, ImagenetProvider, SyntheticClsProvider
from ..model_zoo import ofa_net
from ..models import get_active_cls_subnet
from ..models.export import export_cls_subnet
from ..train import ClsRunManager, RunConfig, topk_accuracy
from .common import add_device_arg, set_seeds


def build_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path", type=str, default="exp/cls/eval")
    p.add_argument("--net", type=str, default="ofa_mbv3_d234_e346_k357_w1.0")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--dataset", type=str, default="imagenet", choices=["imagenet", "cifar10"])
    p.add_argument("--synthetic", action="store_true")
    add_device_arg(p)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--arch_seed", type=int, default=0,
                   help="seed for sample_arch; -1 = max subnet")
    p.add_argument("--materialize", action="store_true",
                   help="slice the static subnet (the deployment path)")
    p.add_argument("--manual_seed", type=int, default=0)
    p.add_argument("--export", type=str, default=None,
                   help="write a serving artifact (torch.export) of the BN-recalibrated "
                        "subnet")
    return p.parse_args(argv)


def main(argv=None):
    args = build_args(argv)
    set_seeds(args.manual_seed)
    net = ofa_net(args.net, checkpoint=args.checkpoint, device=args.device)
    if args.synthetic:
        provider = SyntheticClsProvider(n_train=64, n_test=32, image_size=args.image_size,
                                        n_classes=net.n_classes, train_batch_size=32,
                                        test_batch_size=32)
    elif args.dataset == "cifar10":
        provider = Cifar10Provider(root=args.data_root, image_size=args.image_size)
    else:
        provider = ImagenetProvider(root=args.data_root, image_size=args.image_size)

    rm = ClsRunManager(args.path, net, RunConfig(), provider)
    arch = net.max_arch() if args.arch_seed < 0 else net.sample_arch(seed=args.arch_seed)
    # the canonical deployment path: BN recalibration before eval
    rm.reset_running_statistics(arch, n_images=min(2000, 64), batch_size=32)
    if args.export:
        blob = export_cls_subnet(net, arch, args.image_size, path=args.export)
        rm.write_log("exported %s (%d bytes, %dpx)" % (args.export, len(blob), args.image_size),
                     "valid")
    if args.materialize:
        sub = get_active_cls_subnet(net, arch)
        top1s = []
        with torch.no_grad():
            for batch in provider.test:
                x = torch.from_numpy(batch["image"]).to(net.device)
                labels = torch.from_numpy(batch["label"]).to(net.device)
                top1s.append(float(topk_accuracy(sub(x), labels, 1)))
        top1 = float(np.mean(top1s))
        rm.write_log("materialized %s: top1 %.2f" % (arch.describe()[:50], top1), "valid")
        return top1
    loss, top1, top5 = rm.validate(arch)
    rm.write_log("eval %s: loss %.4f top1 %.2f top5 %.2f"
                 % (arch.describe()[:60], loss, top1, top5), "valid")
    return top1


if __name__ == "__main__":
    main()
