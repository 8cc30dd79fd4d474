"""Train-mode BatchNorm over the BN-statistics kernels: counterpart of
ofa_sr_tpu/ops/pallas/bn.py.

    forward : (y, mean, var, inv) = bn_forward(x, scale, bias, running stats)
              [one kernel call: the moments, inv = rsqrt(var + eps),
               y = (x - mean) * (inv * scale) + bias, and the running
               statistics' momentum EMA in place where they are given]
    backward: (dx, dscale, dbias) = bn_backward(dy, x, scale, mean, inv)
              [one kernel call: s1 = sum dy, s2 = sum dy*xhat, then
               dx = inv*scale*(dy - s1/n - xhat*s2/n), dscale = s2, dbias = s1]

the JAX package's association. The returned (mean, var) carry their own
cotangent terms (dmean/n + dvar*2(x - mean)/n), added in PyTorch, so the op
stays a correct primitive where the moments feed differentiable consumers;
in the trainer they feed only the running-statistics update, which the
forward kernel makes, and those terms are skipped.

x may be float32 or bfloat16 (the trainer's bf16 compute): the moments,
the normalize and dx are computed in float32, y and dx come back in x's type
(the kernels round each once), dscale and dbias in the BN parameters'
float32. Where the moments have cotangents of their own (never in the
trainer) their terms are added to the kernel's dx after it, so a bf16 dx is
then rounded twice.

`active` (a 0-d int32 device tensor, the masked forward's active width):
the running statistics change only below it, y is 0 from it on, and the
backward zeroes what the forward zeroed (dx, dscale and dbias are 0 there),
inside the kernels (`bn_forward` / `bn_backward`'s operand).

The kernels take row-contiguous (N, C) views, so x and dy are made
contiguous with `.contiguous()`: free for an NHWC-contiguous tensor, a copy
otherwise (an `aten::copy_` elementwise kernel in a profile).
`bn_train_fused.layout_copies` counts the tensors that needed that copy.
On a CPU tensor the kernels' plain versions compute the same.
"""

from __future__ import annotations

import torch

from ...parallel.mesh import all_reduce_sum, world_size
from .bn_stats import bn_backward, bn_forward


def _row_contiguous(t):
    if t.is_contiguous():
        return t
    bn_train_fused.layout_copies += 1
    return t.contiguous()


class _BNTrainFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, running_mean, running_var, momentum, update_var,
                group, active):
        x = _row_contiguous(x)
        y, mean, var, inv = bn_forward(x, scale, bias, running_mean, running_var,
                                       momentum=momentum, eps=eps, update_var=update_var,
                                       group=group, active=active)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.group, ctx.active = group, active
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, scale, mean, inv = ctx.saved_tensors
        group = ctx.group
        if dy is not None:
            dx, dscale, dbias = bn_backward(_row_contiguous(dy), x, scale, mean, inv,
                                            group=group, active=ctx.active)
            dscale, dbias = dscale.to(scale.dtype), dbias.to(scale.dtype)
        else:
            dx = torch.zeros_like(x, dtype=torch.float32)
            dscale = dbias = None
        # under a mesh the moments are every rank's, so each rank's rows
        # take the cotangents of all the ranks' uses of them
        n = x.numel() // x.shape[-1] * world_size(group)
        if dmean is not None:
            dx = dx + all_reduce_sum(dmean.clone(), group) / n
        if dvar is not None:
            dx = dx + all_reduce_sum(dvar.clone(), group) * 2.0 * (x.float() - mean) / n
        return dx.to(x.dtype), dscale, dbias, None, None, None, None, None, None, None


def bn_train_fused(x, scale, bias, eps=1e-5, running_mean=None, running_var=None, *,
                   momentum=0.1, update_var="unbiased", group=None, active=None):
    """Train-mode BN over NHWC `x` with the statistics kernels; returns
    (y, mean, var): y in x.dtype, the batch moments (biased var) in float32.
    Differentiable in x, scale and bias. Given `running_mean` and
    `running_var`, the same call updates them in place with the momentum
    EMA, from the unbiased or (`update_var="biased"`) the biased var.
    `group`: the moments are over every rank's rows, forward and backward
    (`bn_forward`, `bn_backward`). `active`: the masked form's active
    width (see the module docstring)."""
    return _BNTrainFused.apply(x, scale, bias, eps, running_mean, running_var, momentum,
                               update_var, group, active)


bn_train_fused.layout_copies = 0
