"""Fused conv5x5 + PixelShuffle(2) decoder tail: counterpart of
ofa_sr_tpu/ops/pallas/shuffle_tail.py.

    out[b, 2h+y, 2w+x, c] = b[4c+2y+x]
        + sum_{dy,dx,ci} x[b, h+dy-2, w+dx-2, ci] * w[dy, dx, ci, 4c+2y+x]

with zero padding: a 5x5 SAME conv C -> 4C (+bias), then PixelShuffle(2)
with torch's channel order c*4 + y*2 + x. x: [B,H,W,C] float32; w: (5,5,C,4C)
HWIO; b: (4C,). Returns [B,2H,2W,C].

`fused_shuffle_tail` launches the hand-written kernel in
csrc/shuffle_tail.cu for a CUDA tensor and takes the plain version,
`shuffle_tail_reference`, only for a CPU tensor.
`fused_shuffle_tail.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from ..conv import conv2d
from ..pixelshuffle import pixel_shuffle
from . import _build

KS = 5
R = 2


def shuffle_tail_reference(x, w, b):
    """The plain composition: conv5x5 SAME (+bias) -> PixelShuffle(2)."""
    return pixel_shuffle(conv2d(x, w.permute(3, 2, 0, 1)) + b, R)


def fused_shuffle_tail(x, w, b):
    """conv5x5(C -> 4C, SAME, +bias) + PixelShuffle(2), fused."""
    if x.device.type == "cpu":
        return shuffle_tail_reference(x, w, b)
    bsz, h, wd, cin = x.shape
    cconv = w.shape[-1]
    _build.require_cuda_f32(x.device, x=x, w=w, b=b)
    if (tuple(w.shape) != (KS, KS, cin, cconv) or cconv % (R * R)
            or tuple(b.shape) != (cconv,)):
        raise ValueError("fused_shuffle_tail takes x [B,H,W,C], w (5,5,C,4C'), "
                         "b (4C',); got %s %s %s" % (
                             tuple(x.shape), tuple(w.shape), tuple(b.shape)))
    out = torch.empty(bsz, h * R, wd * R, cconv // (R * R), device=x.device,
                      dtype=torch.float32)
    _build.launch("shuffle_tail", x, w, b, out, bsz, h, wd, cin, cconv)
    fused_shuffle_tail.launches += 1
    return out


fused_shuffle_tail.launches = 0
