"""Pixel shuffle / unshuffle on NHWC tensors with torch.nn.PixelShuffle's
channel order: input channel c*r^2 + y*r + x holds output channel c at
sub-pixel (y, x). Counterpart of ofa_sr_tpu/ops/pixelshuffle.py."""

from __future__ import annotations


def pixel_shuffle(x, r=2):
    """[B,H,W,C*r^2] -> [B,H*r,W*r,C]."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)  # b, h, y, w, x, c
    return x.reshape(b, h * r, w * r, c)


def pixel_unshuffle(x, r=2):
    """[B,H,W,C] -> [B,H/r,W/r,C*r^2]; inverse of pixel_shuffle."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # b, h/r, w/r, c, y, x
    return x.reshape(b, h // r, w // r, c * r * r)
