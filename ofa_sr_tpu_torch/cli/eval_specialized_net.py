"""Validate a named specialized net from the catalog (counterpart of
ofa_sr_tpu/cli/eval_specialized_net.py, the reference's
eval_specialized_net.py).

Pick a net id from the published catalog (`model_zoo.SPECIALIZED_CATALOG`),
build the specialized architecture from its net.config (`--config_root`: a
local mirror of the reference's download directory; `--net_config`: a
config JSON; or `--supernet_checkpoint` with `--arch_config`: sliced out of
a trained supernet), validate it, and report the measured against the
published top-1. `--export PATH` writes the static net as a serving
artifact (`models.export.export_fn`).

Run: python -m ofa_sr_tpu_torch.cli.eval_specialized_net \
       --net flops@595M_top1@80.0_finetune@75 --net_config x.json [--synthetic] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..data import ImagenetProvider, SyntheticClsProvider
from ..model_zoo import SPECIALIZED_CATALOG, ofa_net, ofa_specialized
from ..models import ClsArch
from ..models.export import export_fn
from ..train import cross_entropy, topk_accuracy
from ..utils.common import AverageMeter
from .common import add_device_arg, set_seeds


def build_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path", type=str, default="exp/cls/eval_specialized")
    p.add_argument("--net", type=str, default="flops@595M_top1@80.0_finetune@75",
                   choices=sorted(SPECIALIZED_CATALOG))
    p.add_argument("--config_root", type=str, default=None,
                   help="local mirror of .torch/ofa_specialized/")
    p.add_argument("--net_config", type=str, default=None, help="net.config JSON path")
    p.add_argument("--init", type=str, default=None,
                   help="reference 'init' weights for the specialized net")
    p.add_argument("--supernet_checkpoint", type=str, default=None,
                   help="supernet checkpoint to slice the subnet from")
    p.add_argument("--arch_config", type=str, default=None,
                   help="JSON with {ks, e, d[, wid]} when slicing from a supernet")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    add_device_arg(p)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--manual_seed", type=int, default=0)
    p.add_argument("--export", type=str, default=None,
                   help="write a serving artifact (torch.export) of the specialized net")
    return p.parse_args(argv)


def main(argv=None):
    args = build_args(argv)
    set_seeds(args.manual_seed)

    supernet = arch = None
    if args.supernet_checkpoint:
        supernet = ofa_net(checkpoint=args.supernet_checkpoint, device=args.device)
        with open(args.arch_config) as f:
            a = json.load(f)
        arch = ClsArch(tuple(a["ks"]), tuple(a["e"]), tuple(a["d"]), a.get("wid"))

    net, expected = ofa_specialized(args.net, root=args.config_root,
                                    net_config=args.net_config, init=args.init,
                                    supernet=supernet, arch=arch, device=args.device)
    image_size = args.image_size or expected["image_size"]
    n_classes = net.config["classifier"]["out_features"]
    if args.synthetic:
        provider = SyntheticClsProvider(n_train=64, n_test=32, image_size=image_size,
                                        n_classes=n_classes, train_batch_size=32,
                                        test_batch_size=32)
    else:
        provider = ImagenetProvider(root=args.data_root, image_size=image_size)

    if args.export:
        blob = export_fn(net, (1, image_size, image_size, 3), device=net.device,
                         path=args.export)
        print("exported %s (%d bytes, %dpx)" % (args.export, len(blob), image_size))

    losses, top1s, top5s = AverageMeter(), AverageMeter(), AverageMeter()
    with torch.no_grad():
        for batch in provider.test:
            x = torch.from_numpy(batch["image"]).to(net.device)
            labels = torch.from_numpy(batch["label"]).to(net.device)
            logits = net(x)
            loss, t1, t5 = torch.stack([cross_entropy(logits, labels),
                                        topk_accuracy(logits, labels, 1),
                                        topk_accuracy(logits, labels, 5)]).tolist()
            n = x.shape[0]
            losses.update(loss, n)
            top1s.update(t1, n)
            top5s.update(t5, n)
    print("%s: measured top1 %.2f top5 %.2f loss %.4f / published %.1f (%s)"
          % (args.net, top1s.avg, top5s.avg, losses.avg, expected["top1"], expected["note"]))
    return top1s.avg


if __name__ == "__main__":
    main()
