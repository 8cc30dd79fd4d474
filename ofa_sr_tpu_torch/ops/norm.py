"""BatchNorm on NHWC tensors (counterpart of ofa_sr_tpu/ops/norm.py).

- `batch_norm`: eval mode (and the SR trainer's frozen BN): normalizes with
  the running statistics, in float32 (float64 for a float64 x, the
  reference runs of `chip_smoke.py`), with 1/sqrt(var + eps).
- `batch_norm_train`: train mode: normalizes with the batch moments (biased
  variance) and updates the running statistics in place with the torch
  momentum EMA `r = (1 - m) * r + m * batch_stat`, from the unbiased batch
  variance (torch train mode) or the biased one (`update_var="biased"`,
  BN recalibration).

Elastic width, two forms. The sliced forward hands in the active prefix
(`bn.running_mean[:n]` and so on, views of the module's buffers) and only
those channels' statistics change. The masked forward normalizes at max
width and passes `active`, the active width as a device int tensor (JAX's
channel `mask`, which is always a prefix): the statistics are taken at full
width, the running statistics are updated only where c < active, and y is
re-masked to 0 beyond it.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import all_reduce_sum_autograd, world_size
from .elastic import channel_mask
from .kernels.bn import bn_train_fused


def _acc_dtype(x):
    """The statistics' type: float32, or float64 for a float64 x."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _masked(y, active):
    """y with its channels from `active` on set to 0 (y unchanged if None)."""
    if active is None:
        return y
    return y * channel_mask(active, y.shape[-1], y.dtype, y.device)


def batch_norm(x, scale, bias, mean, var, *, eps=1e-5, active=None):
    """(x - mean) / sqrt(var + eps) * scale + bias over the last (channel)
    axis; `active`: the channels from it on come out 0."""
    in_dtype, acc = x.dtype, _acc_dtype(x)
    x = x.to(acc)
    inv = torch.reciprocal(torch.sqrt(var.to(acc) + eps))
    y = (x - mean.to(acc)) * inv * scale.to(acc) + bias.to(acc)
    return _masked(y, active).to(in_dtype)


def batch_moments(x):
    """Per-channel mean and biased variance over (B, H, W) of an NHWC tensor."""
    mean = x.mean(dim=(0, 1, 2))
    var = torch.square(x).mean(dim=(0, 1, 2)) - torch.square(mean)
    return mean, var


def batch_norm_train(x, scale, bias, running_mean, running_var, *, momentum=0.1,
                     eps=1e-5, update_var="unbiased", use_kernels=False, group=None,
                     active=None):
    """Train-mode BN of NHWC `x`; updates `running_mean` / `running_var` in
    place and returns y.

    `active` (a 0-d int32 tensor on x's device: the masked forward's active
    width): the moments are taken over every channel, the running
    statistics change only where c < active, and y is 0 from channel
    `active` on (so no gradient reaches x, scale or bias there).

    `use_kernels` routes the forward (moments, normalize and the running
    statistics' update, one call) and the backward through the
    BN-statistics kernels (`bn_train_fused`, for every channel count);
    otherwise the plain autograd branch runs.

    `group` (a torch.distributed process group, data parallelism): the
    moments are those of every rank's rows, as the JAX package's are over
    a batch sharded under jit; the plain branch forms them from the
    all-reduced (sum x, sum x^2) as E[x^2] - mean^2, the JAX formula, and
    the all-reduce carries their gradient back to every rank.
    """
    if update_var not in ("unbiased", "biased"):
        raise ValueError("update_var must be 'unbiased' or 'biased', got %r" % update_var)
    if use_kernels:
        return bn_train_fused(x, scale, bias, eps, running_mean, running_var,
                              momentum=momentum, update_var=update_var, group=group,
                              active=active)[0]
    acc = _acc_dtype(x)
    xf = x.to(acc)
    n = x.numel() // x.shape[-1]
    if group is None:
        mean, var = batch_moments(xf)
    else:
        n *= world_size(group)
        sums = all_reduce_sum_autograd(
            torch.stack([xf.sum(dim=(0, 1, 2)), torch.square(xf).sum(dim=(0, 1, 2))]), group)
        mean = sums[0] / n
        var = sums[1] / n - torch.square(mean)
    inv = torch.reciprocal(torch.sqrt(var + eps))
    y = _masked((xf - mean) * inv * scale.to(acc) + bias.to(acc), active).to(x.dtype)
    with torch.no_grad():
        var_for_update = var * (n / max(n - 1, 1)) if update_var == "unbiased" else var
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * var_for_update
        if active is not None:
            live = channel_mask(active, x.shape[-1], torch.bool, x.device)
            new_mean = torch.where(live, new_mean, running_mean)
            new_var = torch.where(live, new_var, running_var)
        running_mean.copy_(new_mean)
        running_var.copy_(new_var)
    return y
