"""Column reductions for BatchNorm statistics: counterpart of
ofa_sr_tpu/ops/pallas/bn_stats.py.

    col_sums2(a, b)            -> (sum_n a, sum_n a*b)        a, b: (N, C)
    bn_moments(x)              -> (mean, biased var) of NHWC x over (B, H, W)
    bn_bwd_sums(dy, x, m, inv) -> (sum_n dy, sum_n dy*(x - m)*inv)

all accumulated in float32. `bn_moments` is col_sums2(x, x) with
mean = s1/n and var = s2/n - mean^2, the JAX package's formula; on the card
the col_sums2 kernel computes that finalize itself in its second pass.

Each function launches the hand-written kernel in csrc/bn_stats.cu for a
CUDA tensor and takes its plain version (`*_reference`) only for a CPU
tensor. The kernels take row-contiguous float32 (N, C) arrays of any N >= 1
and C >= 1 (no channel-count rule; a C=3 output BN goes through them too);
other inputs raise. `col_sums2.launches` counts the launches of the col_sums2
kernel (from `col_sums2` or `bn_moments`), `bn_moments.launches` those made
by `bn_moments`, and `bn_bwd_sums.launches` those of the backward kernel.

`_lane_fold` / `col_sums2_folded` of the JAX package are not carried over:
they pack narrow channel counts into the TPU's 128-lane rows, and the CUDA
kernel's thread layout already keeps neighbouring threads on neighbouring
addresses at any C.
"""

from __future__ import annotations

import torch

from . import _build

COL_TILE = 256        # threads of a pass-1 block = widest column tile
BLOCKS_PER_SM = 4     # pass-1 blocks aimed at per SM
MIN_ROW_STEPS = 8     # rows a pass-1 thread sums at least
MODE_SUMS2, MODE_MOMENTS, MODE_BWD = 0, 1, 2  # csrc/bn_stats.cu


def col_sums2_reference(a, b):
    a, b = a.float(), b.float()
    return a.sum(0), (a * b).sum(0)


def bn_moments_reference(x):
    flat = x.reshape(-1, x.shape[-1])
    s1, s2 = col_sums2_reference(flat, flat)
    mean = s1 / flat.shape[0]
    return mean, s2 / flat.shape[0] - torch.square(mean)


def bn_bwd_sums_reference(dy, x, mean, inv):
    dy = dy.float()
    xhat = (x.float() - mean) * inv
    return dy.sum(0), (dy * xhat).sum(0)


def _grid(n, c, device):
    """(G, rows per block) of pass 1: about BLOCKS_PER_SM blocks per SM over
    all column tiles, each thread summing at least MIN_ROW_STEPS rows."""
    tiles = -(-c // COL_TILE)
    row_groups = COL_TILE // min(c, COL_TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    g = max(1, min(-(-BLOCKS_PER_SM * sms // tiles),
                   -(-n // (row_groups * MIN_ROW_STEPS))))
    rows = -(-n // g)
    return -(-n // rows), rows


def _launch(mode, a, b, mean=None, inv=None):
    """Both passes of csrc/bn_stats.cu; returns the (2, C) results."""
    n, c = a.shape if a.ndim == 2 else (0, 0)
    if (n < 1 or c < 1 or tuple(b.shape) != (n, c)
            or (mode == MODE_BWD and (tuple(mean.shape) != (c,)
                                      or tuple(inv.shape) != (c,)))):
        raise ValueError("the BN-statistics kernel takes (N, C) arrays with N, C >= 1 "
                         "(and (C,) mean/inv); got %s %s" % (tuple(a.shape), tuple(b.shape)))
    tensors = dict(a=a, b=b)
    if mode == MODE_BWD:
        tensors.update(mean=mean, inv=inv)
    _build.require_cuda_f32(a.device, **tensors)
    g, rows = _grid(n, c, a.device)
    partial = torch.empty(2 * c * g, device=a.device, dtype=torch.float32)
    out = torch.empty(2, c, device=a.device, dtype=torch.float32)
    _build.launch("bn_stats", a, b, mean if mean is not None else 0,
                  inv if inv is not None else 0, partial, out, n, c, g, rows, mode)
    (bn_bwd_sums if mode == MODE_BWD else col_sums2).launches += 1
    return out


def col_sums2(a, b):
    """(sum_n a, sum_n a*b) over the rows of two (N, C) float32 arrays."""
    if a.device.type == "cpu":
        return col_sums2_reference(a, b)
    out = _launch(MODE_SUMS2, a, b)
    return out[0], out[1]


def bn_moments(x):
    """Per-channel (mean, biased var) of an NHWC tensor, one pass over x."""
    if x.device.type == "cpu":
        return bn_moments_reference(x)
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("bn_moments takes a contiguous NHWC tensor; got shape %s "
                         "contiguous=%s" % (tuple(x.shape), x.is_contiguous()))
    flat = x.view(-1, x.shape[-1])
    out = _launch(MODE_MOMENTS, flat, flat)
    bn_moments.launches += 1
    return out[0], out[1]


def bn_bwd_sums(dy, x, mean, inv):
    """(sum_n dy, sum_n dy*xhat) over (N, C) arrays, xhat = (x - mean)*inv
    formed inside the kernel (never written out). mean/inv: (C,)."""
    if dy.device.type == "cpu":
        return bn_bwd_sums_reference(dy, x, mean, inv)
    out = _launch(MODE_BWD, dy, x, mean, inv)
    return out[0], out[1]


col_sums2.launches = 0
bn_moments.launches = 0
bn_bwd_sums.launches = 0
