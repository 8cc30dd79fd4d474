"""Eval-mode BatchNorm on NHWC tensors (counterpart of the `training=False`
branch of ofa_sr_tpu/ops/norm.py:batch_norm).

Normalizes with the running statistics, in float32, with 1/sqrt(var + eps),
the same arithmetic as the JAX package. Train mode, and the BN-statistics
kernels it uses, belong to the training path and are not ported yet.
"""

from __future__ import annotations

import torch


def batch_norm(x, scale, bias, mean, var, *, eps=1e-5):
    """(x - mean) / sqrt(var + eps) * scale + bias over the last (channel) axis."""
    in_dtype = x.dtype
    x = x.float()
    inv = torch.reciprocal(torch.sqrt(var.float() + eps))
    y = (x - mean.float()) * inv * scale.float() + bias.float()
    return y.to(in_dtype)
