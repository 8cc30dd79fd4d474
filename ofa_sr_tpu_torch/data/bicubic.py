"""Bicubic resize as two matrix products, PIL's resampling filter
(counterpart of ofa_sr_tpu/data/bicubic.py).

The separable, antialiased Keys filter (a = -0.5, support 2, widened by
the scale factor on downscale, PIL's tap-window arithmetic with edge
renormalization) is a dense [out, in] matrix per axis, computed in float64
numpy and cast to float32, bit for bit the JAX package's. A resize is
Y = Wh @ X @ Ww^T over N and C: two `torch.einsum`s on x's device (a
matmul: in the JAX package a plain XLA einsum too, not a Pallas kernel).
Float32 matmuls on the card keep PyTorch's default, TF32 off.

PIL quantizes its coefficients and clips to uint8 on 8-bit images, so the
result can differ from the host PIL path by ~1/255 a pixel; the PIL path
(data/transforms.py) stays the reference for evaluation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _bicubic_filter(x, a=-0.5):
    """Keys cubic kernel, support 2 (PIL's 'bicubic')."""
    x = np.abs(x)
    return np.where(
        x < 1, ((a + 2) * x - (a + 3)) * x * x + 1,
        np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0))


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """PIL-style resampling weights [out_size, in_size]: per output pixel,
    taps over int(center +- support + 0.5), renormalized over the clipped
    window. Cached: treat the result as read-only."""
    support = 2.0
    scale = in_size / out_size
    filterscale = max(scale, 1.0)  # antialias on downscale
    sup = support * filterscale
    W = np.zeros((out_size, in_size), dtype=np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(0, int(center - sup + 0.5))
        xmax = min(in_size, int(center + sup + 0.5))
        taps = np.arange(xmin, xmax)
        w = _bicubic_filter((taps + 0.5 - center) / filterscale)
        W[xx, xmin:xmax] = w / w.sum()
    return W.astype(np.float32)


def resize_bicubic(x, out_h: int, out_w: int):
    """Resize a float32 NHWC (or HWC) tensor to (out_h, out_w) on its
    device."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    wh = torch.from_numpy(resize_matrix(h, out_h)).to(x.device)
    ww = torch.from_numpy(resize_matrix(w, out_w)).to(x.device)
    y = torch.einsum("oh,nhwc->nowc", wh, x)
    y = torch.einsum("ow,nhwc->nhoc", ww, y)
    return y[0] if squeeze else y


def downscale(x, factor: int):
    """The reference's LR transform on the device: size // factor."""
    h, w = x.shape[-3], x.shape[-2]
    return resize_bicubic(x, h // factor, w // factor)
