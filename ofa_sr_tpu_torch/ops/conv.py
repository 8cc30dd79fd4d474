"""Convolutions on NHWC activations with PyTorch-layout (OIHW) weights.

Counterpart of ofa_sr_tpu/ops/conv.py. Activations keep the JAX package's
NHWC layout; the NCHW view handed to `F.conv2d` is a free `permute` of
NHWC-contiguous memory, i.e. a `torch.channels_last` tensor, so PyTorch
returns a channels-last output, which permutes back to NHWC-contiguous
without a copy (the hand-written kernels take it as it is). Weights are
OIHW, the reference state_dict layout.

Init is the reference's he_fout: normal(0, sqrt(2 / (k*k*out_channels))),
drawn from an explicit `torch.Generator`; `icnr_conv_init` is the JAX
package's ICNR init of a conv feeding a PixelShuffle.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def conv_init(kernel_size, in_ch, out_ch, *, generator):
    """he_fout init, OIHW layout, float32 on the generator's device."""
    std = math.sqrt(2.0 / (kernel_size * kernel_size * out_ch))
    return std * torch.randn(out_ch, in_ch, kernel_size, kernel_size,
                             generator=generator, device=generator.device)


def icnr_conv_init(kernel_size, in_ch, out_ch, r=2, *, generator):
    """ICNR init of a conv -> PixelShuffle(r) head (arXiv:1707.02937): he_fout
    for out_ch / r^2 filters, each repeated r^2 times along the output axis,
    so output channel c*r^2 + s holds filter c (pixel_shuffle's channel
    order) and at init the shuffled output is a nearest-neighbour upsample."""
    if out_ch % (r * r):
        raise ValueError("ICNR needs out_ch divisible by r^2; got %d, r=%d" % (out_ch, r))
    w = conv_init(kernel_size, in_ch, out_ch // (r * r), generator=generator)
    return w.repeat_interleave(r * r, dim=0)


def depthwise_conv_init(kernel_size, channels, *, generator):
    """he_fout depthwise kernel bank [C,1,k,k] (torch Conv2d(C, C, groups=C)
    has fan-out k*k*C)."""
    std = math.sqrt(2.0 / (kernel_size * kernel_size * channels))
    return std * torch.randn(channels, 1, kernel_size, kernel_size,
                             generator=generator, device=generator.device)


def conv2d(x, w, stride=1):
    """2D conv, NHWC x OIHW -> NHWC, padding k//2 per side (odd k) at any
    stride: the reference's get_same_padding, not XLA's "SAME", which pads
    a stride-2 conv asymmetrically."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def depthwise_conv2d(x, w, stride=1):
    """Depthwise conv, padding k//2 per side: w is [C,1,k,k], groups = C."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=w.shape[-1] // 2,
                 groups=x.shape[-1])
    return y.permute(0, 2, 3, 1)
