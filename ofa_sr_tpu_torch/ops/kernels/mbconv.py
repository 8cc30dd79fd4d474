"""Fused MBConv inference (BN folded): counterpart of
ofa_sr_tpu/ops/pallas/mbconv.py.

    y = relu6(x @ ib_w + ib_b)                 1x1 expand,   C -> M
    y = relu6(depthwise_k(y, dw_w) + dw_b)     k x k, SAME zero padding of y
    y = y @ pl_w + pl_b (+ x if residual)      1x1 project,  M -> C

x: [B,H,W,C] float32; ib_w [C,M]; ib_b [M]; dw_w [k,k,M]; dw_b [M];
pl_w [M,C]; pl_b [C] (the Pallas kernel's layouts).

`row_valid=(lo, hi)`: the mid activation (after the expand's relu6) is
zeroed outside rows [lo, hi), as the JAX static subnet's `_row_mask` zeroes
it for a row-padded frame or a slab with halos
(ofa_sr_tpu/models/materialize.py `_mbconv`); x, the project and the
residual are not masked. The bounds are clipped to [0, H]; None is (0, H),
the unbounded block.

`fused_mbconv_infer` launches the hand-written kernel in csrc/mbconv.cu for
a CUDA tensor and takes the plain version, `mbconv_reference`, only for a CPU
tensor. The kernel takes any H, W and M, k in {3, 5, 7}, and C a
multiple of 4 up to 64; other inputs raise. `fused_mbconv_infer.launches` counts kernel
launches. As in the Pallas kernel, bf16 weights are taken (upcast to float32,
which is exact, on both paths) and a bf16 x is refused.

The kernel multiplies both 1x1 convs on the tensor cores in 3xTF32 (as the
shuffle tail does): each float32 operand v is split as big = tf32(v),
small = tf32(v - big), and it accumulates a_small*b_big + a_big*b_small +
a_big*b_big in float32. `mbconv_3xtf32_emulated` is that arithmetic in plain
PyTorch, for the tests only.
"""

from __future__ import annotations

import torch

from ..activations import relu6
from ..conv import conv2d, depthwise_conv2d
from . import _build
from .shuffle_tail import tf32_round

KERNEL_SIZES = (3, 5, 7)
MAX_CHANNELS = 64


def _conv1x1(x, w):
    return conv2d(x, w.t()[:, :, None, None])


def row_bounds(row_valid, h):
    """(lo, hi) of `row_valid` clipped to [0, h]; (0, h) for None."""
    if row_valid is None:
        return 0, h
    lo, hi = (min(max(int(v), 0), h) for v in row_valid)
    return lo, hi


def _mask_rows(t, row_valid):
    """t with the rows outside row_valid zeroed (t itself for None)."""
    if row_valid is None:
        return t
    lo, hi = row_bounds(row_valid, t.shape[1])
    rows = torch.arange(t.shape[1], device=t.device)
    return t * ((rows >= lo) & (rows < hi)).to(t.dtype)[None, :, None, None]


def mbconv_reference(x, ib_w, ib_b, dw_w, dw_b, pl_w, pl_b, *, residual=True, row_valid=None):
    """The plain composition with the same semantics."""
    h = _mask_rows(relu6(_conv1x1(x, ib_w) + ib_b), row_valid)
    h = relu6(depthwise_conv2d(h, dw_w.permute(2, 0, 1)[:, None]) + dw_b)
    y = _conv1x1(h, pl_w) + pl_b
    return y + x if residual else y


def mbconv_3xtf32_emulated(x, ib_w, ib_b, dw_w, dw_b, pl_w, pl_b, *, residual=True,
                           row_valid=None):
    """The kernel's arithmetic: the plain composition with each 1x1 conv done
    as three float32 convolutions of the split operands (small*big +
    big*small + big*big), summed."""
    def conv3(u, w):
        ub, wb = tf32_round(u), tf32_round(w)
        us, ws = tf32_round(u - ub), tf32_round(w - wb)
        return _conv1x1(us, wb) + _conv1x1(ub, ws) + _conv1x1(ub, wb)

    h = _mask_rows(relu6(conv3(x, ib_w) + ib_b), row_valid)
    h = relu6(depthwise_conv2d(h, dw_w.permute(2, 0, 1)[:, None]) + dw_b)
    y = conv3(h, pl_w) + pl_b
    return y + x if residual else y


def fused_mbconv_infer(x, ib_w, ib_b, dw_w, dw_b, pl_w, pl_b, *, residual=True,
                       row_valid=None):
    """Fused MBConv on NHWC `x`; returns a new [B,H,W,C] float32 tensor.
    x is float32; the weights float32 or bf16 (taken as float32, exact).
    `row_valid`: (lo, hi), the rows the mid activation keeps."""
    ib_w, ib_b, dw_w, dw_b, pl_w, pl_b = _build.serving_operands(
        "fused_mbconv_infer", x, (ib_w, ib_b, dw_w, dw_b, pl_w, pl_b))
    if x.device.type == "cpu":
        return mbconv_reference(x, ib_w, ib_b, dw_w, dw_b, pl_w, pl_b,
                                residual=residual, row_valid=row_valid)
    b, h, w, c = x.shape
    m, ks = ib_w.shape[1], dw_w.shape[0]
    _build.require_cuda_f32(x.device, x=x, ib_w=ib_w, ib_b=ib_b, dw_w=dw_w,
                            dw_b=dw_b, pl_w=pl_w, pl_b=pl_b)
    if (ks not in KERNEL_SIZES or c % 4 or c > MAX_CHANNELS
            or tuple(ib_w.shape) != (c, m) or tuple(ib_b.shape) != (m,)
            or tuple(dw_w.shape) != (ks, ks, m) or tuple(dw_b.shape) != (m,)
            or tuple(pl_w.shape) != (m, c) or tuple(pl_b.shape) != (c,)):
        raise ValueError(
            "fused_mbconv_infer takes k in %s and C %% 4 == 0, C <= %d with "
            "matching weights; got x %s ib_w %s dw_w %s pl_w %s" % (
                KERNEL_SIZES, MAX_CHANNELS, tuple(x.shape), tuple(ib_w.shape),
                tuple(dw_w.shape), tuple(pl_w.shape)))
    lo, hi = row_bounds(row_valid, h)
    out = torch.empty_like(x)
    _build.launch("ofa_mbconv_f32", x.device, x, ib_w, ib_b, dw_w, dw_b, pl_w, pl_b, out,
                  b, h, w, c, m, ks, int(residual), lo, hi)
    fused_mbconv_infer.launches += 1
    return out


fused_mbconv_infer.launches = 0
