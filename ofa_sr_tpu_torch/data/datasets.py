"""Datasets: map an index to a sample dict of HWC float32 [0, 1] arrays
(the port's own copy of ofa_sr_tpu/data/datasets.py).

Keys are the trainer's batch contract: "image" (HR) and "x2" / "x4" (its
2x / 4x bicubic LR), or "lr" for precomputed pairs. PIL is imported inside
the functions that open images; the synthetic dataset needs only numpy.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional

import numpy as np

from .transforms import bicubic_downscale_pil, to_numpy

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".tif", ".tiff")


def is_image_file(fname: str) -> bool:
    return fname.lower().endswith(IMG_EXTENSIONS)


def list_images(root: str, numeric_sort: bool = False) -> List[str]:
    """Recursive image listing, sorted; `numeric_sort` orders frames by
    their integer file name (video frame dirs)."""
    paths = []
    for r, _, fnames in sorted(os.walk(root)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                paths.append(os.path.join(r, fname))
    if numeric_sort:
        def key(p):
            stem = os.path.splitext(os.path.basename(p))[0]
            try:
                return (0, int(stem))
            except ValueError:
                return (1, stem)
        paths.sort(key=key)
    if not paths:
        raise FileNotFoundError("%s has no valid image file" % root)
    return paths


def _open_rgb(path):
    from PIL import Image
    return Image.open(path).convert("RGB")


class SRImageDataset:
    """HR images on disk; LR made by PIL bicubic at access time. The
    transform (crop/flip/rotation) runs on the HR image first, then the
    2x and 4x downscales are taken from the transformed HR."""

    def __init__(self, root: str, transform=None, numeric_sort: bool = False,
                 factors=(2, 4)):
        self.root = root
        self.transform = transform
        self.paths = list_images(root, numeric_sort)
        self.factors = tuple(factors)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index, rng: Optional[random.Random] = None):
        img = _open_rgb(self.paths[index])
        if self.transform is not None:
            img = self.transform(img, rng)
        out = {"image": to_numpy(img)}
        for f in self.factors:
            out["x%d" % f] = to_numpy(bicubic_downscale_pil(img, f))
        return out


class PairedImageDataset:
    """Precomputed (LR, HR) pairs: `<root>/image/*` the degraded LR frames,
    `<root>/label/*` the HR. The LR is given as "lr" and, when its size is
    HR/2 or HR/4, also as "x2" / "x4"."""

    def __init__(self, root: str, transform=None, numeric_sort: bool = True):
        self.lr_paths = list_images(os.path.join(root, "image"), numeric_sort)
        self.hr_paths = list_images(os.path.join(root, "label"), numeric_sort)
        assert len(self.lr_paths) == len(self.hr_paths), (
            len(self.lr_paths), len(self.hr_paths))
        self.transform = transform

    def __len__(self):
        return len(self.lr_paths)

    def __getitem__(self, index, rng: Optional[random.Random] = None):
        lr = _open_rgb(self.lr_paths[index])
        hr = _open_rgb(self.hr_paths[index])
        if self.transform is not None:
            hr = self.transform(hr, rng)
        hr_np, lr_np = to_numpy(hr), to_numpy(lr)
        out = {"image": hr_np, "lr": lr_np}
        for f in (2, 4):
            if (lr_np.shape[0] * f, lr_np.shape[1] * f) == hr_np.shape[:2]:
                out["x%d" % f] = lr_np
        return out


class SyntheticSRDataset:
    """Deterministic random images: sample `index` draws HR, then each LR,
    from `np.random.RandomState(seed * 100003 + index)`."""

    def __init__(self, n: int = 64, hr_size: int = 96, seed: int = 0,
                 factors=(2, 4)):
        self.n = n
        self.hr_size = hr_size
        self.seed = seed
        self.factors = tuple(factors)

    def __len__(self):
        return self.n

    def __getitem__(self, index, rng: Optional[random.Random] = None):
        r = np.random.RandomState(self.seed * 100003 + index)
        hs = self.hr_size
        out = {"image": r.rand(hs, hs, 3).astype(np.float32)}
        for f in self.factors:
            out["x%d" % f] = r.rand(hs // f, hs // f, 3).astype(np.float32)
        return out
