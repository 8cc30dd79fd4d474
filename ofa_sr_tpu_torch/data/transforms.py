"""Host-side (PIL) image transforms with the reference's exact semantics
(the port's own copy of ofa_sr_tpu/data/transforms.py).

Every random transform takes an explicit `rng: random.Random` and draws
from it with the same calls in the same order as the JAX package, so a seed
gives the same crop, flip and angle in both packages. PIL is imported
inside the functions that use it: the synthetic path runs without it.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img, rng: Optional[random.Random] = None):
        for t in self.transforms:
            img = t(img, rng) if _wants_rng(t) else t(img)
        return img


def _wants_rng(t):
    return isinstance(t, (RandomCrop, RandomHorizontalFlip, RandomRotation,
                          NineRandomCrop))  # EntropyCrop is a NineRandomCrop


class RandomCrop:
    """Random size x size crop (torchvision semantics: uniform top-left over
    the valid positions)."""

    def __init__(self, size: int):
        self.size = int(size)

    def __call__(self, img, rng: random.Random):
        w, h = img.size
        tw = th = self.size
        if w == tw and h == th:
            return img
        i = rng.randint(0, h - th)
        j = rng.randint(0, w - tw)
        return img.crop((j, i, j + tw, i + th))


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, rng: random.Random):
        from PIL import Image
        if rng.random() < self.p:
            return img.transpose(Image.FLIP_LEFT_RIGHT)
        return img


class RandomRotation:
    """Rotate by an angle uniform in [-degrees, degrees] (torchvision
    RandomRotation default: nearest resample, no expand)."""

    def __init__(self, degrees: float = 90.0):
        self.degrees = float(degrees)

    def __call__(self, img, rng: random.Random):
        from PIL import Image
        angle = rng.uniform(-self.degrees, self.degrees)
        return img.rotate(angle, resample=Image.NEAREST, expand=False)


class CenterCrop:
    def __init__(self, size: int):
        self.size = int(size)

    def __call__(self, img):
        w, h = img.size
        tw = th = self.size
        j = int(round((w - tw) / 2.0))
        i = int(round((h - th) / 2.0))
        return img.crop((j, i, j + tw, i + th))


class ModCrop:
    """Crop H, W down to a multiple of `mod` from the top-left, keeping SR
    shapes divisible by 4."""

    def __init__(self, mod: int = 4):
        self.mod = int(mod)

    def __call__(self, img):
        w, h = img.size
        return img.crop((0, 0, w - w % self.mod, h - h % self.mod))


class NineRandomCrop:
    """One size x size crop at a randomly chosen one of nine anchors (4
    corners, 4 edge midpoints, center). `full_grid=False` reproduces the
    reference's selector `random.randint(1, 3)`, which only ever picks the
    top row."""

    def __init__(self, size: int, full_grid: bool = True):
        self.size = int(size)
        self.full_grid = full_grid

    def __call__(self, img, rng: random.Random):
        w, h = img.size
        size = self.size
        rows = (0, int((h - size) / 2), h - size)
        cols = (0, int((w - size) / 2), w - size)
        select = rng.randint(1, 9 if self.full_grid else 3)
        i = rows[(select - 1) // 3]
        j = cols[(select - 1) % 3]
        return img.crop((j, i, j + size, i + size))


class EntropyCrop(NineRandomCrop):
    """The reference's EntropyCrop is a copy of NineRandomCrop (no entropy
    logic); kept under its name."""


class Scale:
    """Scale by a float factor with PIL resampling (default BICUBIC), to
    (int(w * f), int(h * f))."""

    def __init__(self, scale_factor: float, interpolation=None):
        self.scale_factor = scale_factor
        self.interpolation = interpolation

    def __call__(self, img):
        from PIL import Image
        w, h = img.size
        tw, th = int(w * self.scale_factor), int(h * self.scale_factor)
        interp = Image.BICUBIC if self.interpolation is None else self.interpolation
        return img.resize((tw, th), interp)


def bicubic_downscale_pil(img, factor: int):
    """The reference's LR: PIL bicubic at 1/factor."""
    assert factor in (2, 4, 8)
    return Scale(1.0 / factor)(img)


def to_numpy(img) -> np.ndarray:
    """HWC float32 in [0, 1] (torchvision ToTensor's scaling, NHWC here)."""
    return np.asarray(img, dtype=np.float32) / 255.0
