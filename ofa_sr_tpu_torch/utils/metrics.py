"""PSNR on the Y channel with the reference's uint8 semantics, as tensor ops
on the tensors' own device (counterpart of the device half of
ofa_sr_tpu/utils/metrics.py).

clamp to [0, 1], x255, round, ITU-R 601 Y with a second round, MSE,
20*log10(255/sqrt(mse)); inf where the images are equal. `torch.round`
rounds half to even, as `jnp.round` does.

Each image is quantized and its Y formed in its own dtype, as the JAX
package does: a bf16 prediction has its Y weights rounded to bf16, the
weighted sum taken in float32 and rounded to bf16 once (a dot with float32
accumulation, as XLA computes JAX's bf16 `tensordot`), then /255 and +16 in
bf16. The MSE of a bf16 Y against a float32 target's is float32.
"""

from __future__ import annotations

import math

import torch

# ITU-R 601 RGB->Y weights (the reference's rgb2y)
Y_WEIGHTS = (65.481, 128.553, 24.966)


def quantize_img(x):
    """clamp [0,1] -> x255 -> round, kept in float."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0)


def rgb2y_device(img255, channel_axis=-1):
    """uint8-valued float RGB (0..255) -> rounded Y channel, in img255's
    dtype."""
    w = torch.tensor(Y_WEIGHTS, dtype=img255.dtype).float().tolist()
    r, g, b = torch.unbind(img255.float(), dim=channel_axis)
    y = (r * w[0] + g * w[1] + b * w[2]).to(img255.dtype)
    return torch.round(y / 255.0 + 16.0)


def psnr_y_device(pred, target, channel_axis=-1, valid_mask=None):
    """PSNR-Y of [0,1] images, one scalar tensor. `valid_mask`: optional
    (1, H, W, 1) 0/1 mask; the MSE then averages over valid pixels only."""
    y1 = rgb2y_device(quantize_img(pred), channel_axis)
    y2 = rgb2y_device(quantize_img(target), channel_axis)
    sq = torch.square(y1 - y2)
    if valid_mask is not None:
        m = valid_mask[..., 0]
        mse = (sq * m).sum() / (m.sum() * y1.shape[0])
    else:
        mse = sq.mean()
    psnr = 20.0 * torch.log10(255.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))
    return torch.where(mse == 0, torch.full_like(psnr, math.inf), psnr)
