"""PSNR on the Y channel with the reference's uint8 semantics, as tensor ops
on the tensors' own device, and the numpy twins of the reference's host
helpers (counterpart of ofa_sr_tpu/utils/metrics.py; the numpy half is this
package's own copy).

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

import numpy as np
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


def _y_squared_errors(pred, target, channel_axis):
    y1 = rgb2y_device(quantize_img(pred), channel_axis)
    y2 = rgb2y_device(quantize_img(target), channel_axis)
    return torch.square(y1 - y2)


def psnr_from_mse(mse):
    """20*log10(255/sqrt(mse)) of a Y-channel MSE (0..255 units); inf
    where it is 0."""
    psnr = 20.0 * torch.log10(255.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))
    return torch.where(mse == 0, torch.full_like(psnr, math.inf), psnr)


def psnr_y_device(pred, target, channel_axis=-1, valid_mask=None):
    """PSNR-Y of [0,1] images, one scalar tensor. `valid_mask`: optional
    (1, H, W, 1) 0/1 mask; the MSE then averages over valid pixels only."""
    sq = _y_squared_errors(pred, target, channel_axis)
    if valid_mask is not None:
        m = valid_mask[..., 0]
        mse = (sq * m).sum() / (m.sum() * sq.shape[0])
    else:
        mse = sq.mean()
    return psnr_from_mse(mse)


def y_squared_error_sum(pred, target, channel_axis=-1):
    """(sum of the squared Y errors, their count) of [0,1] images: the
    parts of PSNR-Y's MSE that add over the ranks of a mesh, where each
    holds some of a batch's images (`psnr_from_mse(sum / count)` of the
    totals is the whole batch's PSNR-Y)."""
    sq = _y_squared_errors(pred, target, channel_axis)
    return sq.sum(), sq.numel()


def psnr_rgb_device(pred, target):
    """PSNR of uint8-rounded [0,1] RGB images (no Y conversion), one
    scalar tensor."""
    return psnr_from_mse(torch.square(quantize_img(pred) - quantize_img(target)).mean())


# -- host (numpy) twins of the reference's helpers -----------------------------

def psnr_np(img1, img2):
    """The reference psnr: uint8 images, float64 math."""
    assert img1.dtype == img2.dtype == np.uint8
    mse = np.mean((img1.astype(np.float64) - img2.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * np.log10(255.0 / np.sqrt(mse))


def tensor2img_np(arr, out_type=np.uint8, min_max=(0, 1)):
    """The reference tensor2img_np for HWC (or NHWC, the batch kept) arrays:
    clamp to min_max, scale to [0, 1], and for uint8 x255 and round."""
    a = np.clip(np.asarray(arr, dtype=np.float32), *min_max)
    a = (a - min_max[0]) / (min_max[1] - min_max[0])
    if out_type == np.uint8:
        a = (a * 255.0).round()
    return a.astype(out_type)


def rgb2y_np(img):
    """The reference rgb2y: uint8 RGB -> rounded uint8 Y (ITU-R 601)."""
    assert img.dtype == np.uint8
    y = (np.dot(img[..., :3], list(Y_WEIGHTS)) / 255.0 + 16.0).round()
    return y.astype(np.uint8)


def rgb2gray_np(img):
    """The reference rgb2gray: rounded luma in the image's own dtype."""
    gray = np.dot(img[..., :3], [0.299, 0.587, 0.114]).round()
    return gray.astype(img.dtype)
