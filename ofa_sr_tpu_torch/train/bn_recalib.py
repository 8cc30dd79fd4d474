"""BN recalibration (counterpart of ofa_sr_tpu/train/bn_recalib.py, the
reference's `set_running_statistics`).

For one subnet, run the calibration batches with every BN normalizing by
its batch moments, and set each running statistic the subnet touches to the
batch-size-weighted average of its per-batch mean and biased variance; the
statistics the subnet never touches (channels past a block's active width,
blocks past a stage's depth) keep their values. The other weights do not
change.

As in the JAX package: each batch runs the train-mode forward with
momentum 1 and biased-variance updates from statistics filled with a
sentinel, so after it a touched statistic holds exactly that batch's moment
and an untouched one the sentinel; the weighted sums then keep the original
wherever the sentinel survived. The reference calibrates on the HR image
("image") even for SR nets; pass `input_key` "x2" / "x4" for the input
resolution.
"""

from __future__ import annotations

import torch
from torch import nn

_SENTINEL = 1e30


def bn_recalibrate(net, cfg, pixel_d, batches, *, input_key="image", use_kernels=None):
    """Recalibrate `net`'s running statistics in place for subnet `cfg` at
    `pixel_d` over `batches` (dicts of numpy arrays or tensors)."""
    bns = [m for m in net.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [(m.momentum, m.running_mean.clone(), m.running_var.clone()) for m in bns]
    total, n = None, 0
    try:
        for m in bns:
            m.momentum, m.update_var = 1.0, "biased"
        with torch.no_grad():
            for batch in batches:
                x = torch.as_tensor(batch[input_key]).to(net.device)
                for m in bns:
                    m.running_mean.fill_(_SENTINEL)
                    m.running_var.fill_(_SENTINEL)
                net(x, cfg, pixel_d, bn_training=True, use_kernels=use_kernels)
                w = x.shape[0]
                st = [t * w for m in bns for t in (m.running_mean, m.running_var)]
                total = st if total is None else [a + b for a, b in zip(total, st)]
                n += w
    finally:
        for m, (momentum, mean, var) in zip(bns, saved):
            m.momentum = momentum
            del m.update_var
            m.running_mean.copy_(mean)
            m.running_var.copy_(var)
    if n == 0:
        return
    with torch.no_grad():
        for i, (m, (_, mean, var)) in enumerate(zip(bns, saved)):
            for buf, orig, tot in ((m.running_mean, mean, total[2 * i]),
                                   (m.running_var, var, total[2 * i + 1])):
                avg = tot / n
                buf.copy_(torch.where(avg >= _SENTINEL / 2, orig, avg))
