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

The kernel multiplies on the tensor cores in 3xTF32: each float32 operand v
is split as big = tf32(v), small = tf32(v - big), and it accumulates
a_small*b_big + a_big*b_small + a_big*b_big in float32.
`shuffle_tail_3xtf32_emulated` is that arithmetic in plain PyTorch, for the
tests only: it shows on the CPU that three products meet the kernels'
float32 tolerance where one TF32 product does not.
"""

from __future__ import annotations

import torch

from ..conv import conv2d
from ..pixelshuffle import pixel_shuffle
from . import _build

KS = 5
R = 2
MAX_CIN = 192   # the kernel keeps all input channels of its halo in shared memory


def shuffle_tail_reference(x, w, b):
    """The plain composition: conv5x5 SAME (+bias) -> PixelShuffle(2)."""
    return pixel_shuffle(conv2d(x, w.permute(3, 2, 0, 1)) + b, R)


def tf32_round(t):
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero (PTX cvt.rna.tf32.f32), still stored as float32."""
    bits = t.float().contiguous().view(torch.int32)
    # add half of the 13 dropped bits' unit to the magnitude, then drop them
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def shuffle_tail_3xtf32_emulated(x, w, b):
    """The kernel's arithmetic: three float32 convolutions of the split
    operands (small*big + big*small + big*big), summed, plus the bias, then
    the shuffle."""
    xb, wb = tf32_round(x), tf32_round(w)
    xs, ws = tf32_round(x - xb), tf32_round(w - wb)

    def conv(u, v):
        return conv2d(u, v.permute(3, 2, 0, 1))

    return pixel_shuffle(conv(xs, wb) + conv(xb, ws) + conv(xb, wb) + b, R)


def fused_shuffle_tail(x, w, b):
    """conv5x5(C -> 4C, SAME, +bias) + PixelShuffle(2), fused."""
    if x.device.type == "cpu":
        return shuffle_tail_reference(x, w, b)
    bsz, h, wd, cin = x.shape
    cconv = w.shape[-1]
    _build.require_cuda_f32(x.device, x=x, w=w, b=b)
    if (tuple(w.shape) != (KS, KS, cin, cconv) or cconv % (R * R) or cin > MAX_CIN
            or tuple(b.shape) != (cconv,) or w.data_ptr() % 16):
        raise ValueError("fused_shuffle_tail takes x [B,H,W,C] with C <= %d, w (5,5,C,4C') "
                         "16-byte aligned, b (4C',); got %s %s %s" % (
                             MAX_CIN, tuple(x.shape), tuple(w.shape), tuple(b.shape)))
    out = torch.empty(bsz, h * R, wd * R, cconv // (R * R), device=x.device,
                      dtype=torch.float32)
    _build.launch("ofa_shuffle_tail_f32", x.device, x, w, b, out, bsz, h, wd, cin, cconv)
    fused_shuffle_tail.launches += 1
    return out


fused_shuffle_tail.launches = 0
