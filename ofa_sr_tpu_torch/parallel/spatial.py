"""Spatially split full-frame SR inference over the ranks of a mesh:
counterpart of ofa_sr_tpu/parallel/spatial.py.

One frame's rows are split over the ranks; each rank computes an H-slab.
Every rank is handed the whole frame, so each slices its slab and the
receptive-field halo above and below it from its own copy (zeros past the
frame, where JAX's halo exchange, a `ppermute` between devices that each
hold only their slab, has no sender), runs the materialized subnet on
slab + halos with `row_valid` marking the frame's true rows in its local
coordinates, and keeps its centre. The centres are assembled into the
output frame on every rank by the one collective: an all-reduce of a
zero-filled frame into which each rank writes its own rows (gloo on CUDA
has only `all_reduce` and `broadcast`).

Frame edges and row padding: the frame's rows are padded up to a multiple
of the world size (times `align`), and the subnet re-zeroes the rows
outside the true frame before every spatial conv (`StaticSubnet`'s
`row_valid`), so the valid region is window-exact against the unpadded
frame's execution, as in the JAX package.
"""

from __future__ import annotations

import torch

from .mesh import Mesh, all_reduce_sum


def make_spatial_infer(subnet, mesh: Mesh, *, halo: int, scale: int, align: int = 1):
    """Build `run(x, true_h=None) -> (1, true_h*scale, W*scale, C)` running
    `subnet` (a models.materialize.StaticSubnet) H-split over the ranks of
    `mesh`; every rank passes the same frame x (1, H, W, C) and gets the
    whole output.

    `halo` must be at least the subnet's receptive-field radius
    (train/tiled_infer.receptive_field_radius; the autoencoder variant for
    the X4's autoencoder mode). `true_h` marks the real frame rows.
    `align`: slab and halo row alignment; for an autoencoder subnet pass
    2**pixel_d (with scale=1 and the halo in HR pixels), so that slab
    boundaries and halos land on the pixel-unshuffle grid; true_h must then
    be a multiple of `align` (the ModCrop contract)."""
    n, r = mesh.world, mesh.rank
    if halo % align:
        halo += align - halo % align

    def run(x, true_h=None):
        if x.shape[0] != 1:
            raise ValueError("frame-at-a-time inference: x must be (1, H, W, C), got %s"
                             % (tuple(x.shape),))
        if true_h is None:
            true_h = x.shape[1]
        h = pad_rows(x.shape[1], n * align)
        slab = h // n
        # slab + halos; global row g = r*slab - halo + i, zeros past the frame
        start = r * slab - halo
        xh = x.new_zeros((1, slab + 2 * halo) + tuple(x.shape[2:]))
        g0, g1 = max(start, 0), min(start + slab + 2 * halo, x.shape[1])
        if g1 > g0:
            xh[:, g0 - start:g1 - start] = x[:, g0:g1]
        lo = min(max(-start, 0), slab + 2 * halo)
        hi = min(max(true_h - start, 0), slab + 2 * halo)
        y = subnet(xh, row_valid=(lo, hi))
        out = y.new_zeros((1, h * scale) + tuple(y.shape[2:]))
        out[:, r * slab * scale:(r + 1) * slab * scale] = \
            y[:, halo * scale:(halo + slab) * scale]
        all_reduce_sum(out, mesh.group)
        return out[:, :true_h * scale]

    return run


def pad_rows(h: int, n: int) -> int:
    """Rows after padding h up to a multiple of n."""
    return h if h % n == 0 else h + n - h % n
