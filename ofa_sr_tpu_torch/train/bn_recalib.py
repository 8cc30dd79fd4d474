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
resolution. `mode` is the net's forward's ("autoencoder": an X4 net's
encoder and decoder). A classification net (`ElasticClassifierNet`) is
recalibrated for its `ClsArch` with `pixel_d` None, as the JAX package's
classification run manager calls it; `mode` does not apply there.

Under a mesh each rank passes the same global batches and runs its rows of
each (`parallel.shard_batch`) with the moments taken over every rank's rows,
so the statistics are the global batch's, as the JAX package's are under a
sharded jit, and the same on every rank; a batch whose rows do not split
over the ranks runs whole on every rank, without a collective (as JAX runs
an unsharded batch).
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.mesh import shard_batch

_SENTINEL = 1e30


def bn_recalibrate(net, cfg, pixel_d, batches, *, input_key="image", use_kernels=None,
                   mode="sr", mesh=None):
    """Recalibrate `net`'s running statistics in place for subnet `cfg` at
    `pixel_d` (None for a classification net and its ClsArch) over
    `batches` (dicts of numpy arrays or tensors), with the global batches'
    moments under `mesh`."""
    bns = [m for m in net.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [(m.momentum, m.running_mean.clone(), m.running_var.clone()) for m in bns]
    total, n = None, 0
    try:
        for m in bns:
            m.momentum, m.update_var = 1.0, "biased"
        with torch.no_grad():
            for batch in batches:
                x = torch.as_tensor(batch[input_key])
                w, group = x.shape[0], None
                if mesh is not None and mesh.group is not None and w % mesh.world == 0:
                    x, group = shard_batch(x, mesh), mesh.group
                x = x.to(net.device)
                for m in bns:
                    m.running_mean.fill_(_SENTINEL)
                    m.running_var.fill_(_SENTINEL)
                if pixel_d is None:  # a classification net: no pixel_d, no mode
                    net(x, cfg, bn_training=True, use_kernels=use_kernels, bn_group=group)
                else:
                    net(x, cfg, pixel_d, bn_training=True, use_kernels=use_kernels, mode=mode,
                        bn_group=group)
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
