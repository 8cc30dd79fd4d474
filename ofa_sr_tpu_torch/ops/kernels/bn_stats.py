"""Column reductions for BatchNorm statistics, and the train-mode BN
backward built on them: counterpart of ofa_sr_tpu/ops/pallas/bn_stats.py.

    col_sums2(a, b)            -> (sum_n a, sum_n a*b)        a, b: (N, C)
    bn_moments(x)              -> (mean, biased var) of NHWC x over (B, H, W)
    bn_bwd_sums(dy, x, m, inv) -> (sum_n dy, sum_n dy*(x - m)*inv)
    bn_backward(dy, x, scale, m, inv) -> (dx, dscale, dbias)

all accumulated in float32. `bn_moments` is col_sums2(x, x) with
mean = s1/n and var = s2/n - mean^2, the JAX package's formula; on the card
the col_sums2 kernel computes that finalize itself in its second pass.
`bn_backward` is the backward of train-mode BN with no cotangent on the
moments (ofa_sr_tpu/ops/pallas/bn.py `_bwd`): bn_bwd_sums' two sums, then
dx = inv*scale*(dy - s1/n - xhat*s2/n), dscale = s2, dbias = s1; on the
card one call runs the sums and the dx pass (csrc/bn_stats.cu
`ofa_bn_backward_f32`), where the JAX package leaves dx to XLA's fusion.

Each function launches the hand-written kernel in csrc/bn_stats.cu for a
CUDA tensor and takes its plain version (`*_reference`) only for a CPU
tensor. The kernels take row-contiguous float32 (N, C) arrays of any N >= 1
and C >= 1 (no channel-count rule; a C=3 output BN goes through them too);
other inputs raise. `col_sums2.launches` counts the launches of the col_sums2
kernel (from `col_sums2` or `bn_moments`), `bn_moments.launches` those made
by `bn_moments`, `bn_bwd_sums.launches` those of the sums-only backward
kernel and `bn_backward.launches` those of the fused backward.

A wrapper call is host work the training step waits on (~90 calls a step):
the pass-1 grid is cached per (N, C, device), and each call allocates one
buffer for its results and scratch and makes no other tensor.

`_lane_fold` / `col_sums2_folded` of the JAX package are not carried over:
they pack narrow channel counts into the TPU's 128-lane rows, and the CUDA
kernel's thread layout already keeps neighbouring threads on neighbouring
addresses at any C.
"""

from __future__ import annotations

import functools

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


def bn_backward_reference(dy, x, scale, mean, inv):
    """(dx, dscale, dbias) of train-mode BN, written as the JAX package's VJP
    (ofa_sr_tpu/ops/pallas/bn.py `_bwd`, zero moment cotangents); dy, x with
    channels last, dx in x's shape and float32."""
    c = x.shape[-1]
    n = x.numel() // c
    dyf = dy.float()
    xhat = (x.float() - mean) * inv
    s1, s2 = bn_bwd_sums_reference(dyf.reshape(n, c), x.reshape(n, c), mean, inv)
    dx = (inv * scale.float()) * (dyf - s1 / n - xhat * s2 / n)
    return dx, s2, s1


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _grid(n, c, device):
    """Blocks G of pass 1 along the rows: about BLOCKS_PER_SM blocks per SM
    over all column tiles, each thread summing at least MIN_ROW_STEPS rows
    (a thread takes 4 columns as one float4 where C % 4 == 0)."""
    groups = c // 4 if c % 4 == 0 else c
    tiles = -(-groups // COL_TILE)
    row_groups = COL_TILE // min(groups, COL_TILE)
    g = max(1, min(-(-BLOCKS_PER_SM * _sm_count(device) // tiles),
                   -(-n // (row_groups * MIN_ROW_STEPS))))
    rows = -(-n // g)
    return -(-n // rows)  # no block left without rows


def _check(a, b, **vectors):
    """(N, C) of row-contiguous a and b of one shape, channels last, after
    the checks every call makes; raises on what the kernels do not take."""
    c = a.shape[-1] if a.ndim else 0
    n = a.numel() // c if c else 0
    if (n < 1 or b.shape != a.shape
            or any(v is not None and v.shape != (c,) for v in vectors.values())):
        raise ValueError("the BN kernels take arrays with N, C >= 1 rows and columns, of "
                         "one shape (and (C,) %s); got %s %s" % (
                             "/".join(vectors), tuple(a.shape), tuple(b.shape)))
    _build.require_cuda_f32(a.device, a=a, b=b,
                            **{k: v for k, v in vectors.items() if v is not None})
    return n, c


def _launch(mode, a, b, mean=None, inv=None):
    """Both passes of csrc/bn_stats.cu; returns the two (C,) results. A call
    allocates one buffer, [out (2C) | partials (2CG)], and passes pointers
    into it: tensor views would cost more host time than the small
    launches take on the device."""
    n, c = _check(a, b, mean=mean, inv=inv)
    device = a.device
    g = _grid(n, c, device)
    buf = torch.empty(2 * c * (g + 1), device=device, dtype=torch.float32)
    _build.launch("ofa_col_sums2_f32", device, a, b, mean, inv, buf.data_ptr() + 8 * c, buf,
                  n, c, g, mode)
    (bn_bwd_sums if mode == MODE_BWD else col_sums2).launches += 1
    first, second, _ = buf.split((c, c, 2 * c * g))
    return first, second


def col_sums2(a, b):
    """(sum_n a, sum_n a*b) over the rows of two (N, C) float32 arrays."""
    if a.device.type == "cpu":
        return col_sums2_reference(a, b)
    if a.ndim != 2:
        raise ValueError("col_sums2 takes (N, C) arrays; got %s" % (tuple(a.shape),))
    return _launch(MODE_SUMS2, a, b)


def bn_moments(x):
    """Per-channel (mean, biased var) of an NHWC tensor, one pass over x."""
    if x.device.type == "cpu":
        return bn_moments_reference(x)
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("bn_moments takes a contiguous NHWC tensor; got shape %s "
                         "contiguous=%s" % (tuple(x.shape), x.is_contiguous()))
    out = _launch(MODE_MOMENTS, x, x)
    bn_moments.launches += 1
    return out


def bn_bwd_sums(dy, x, mean, inv):
    """(sum_n dy, sum_n dy*xhat) over (N, C) arrays, xhat = (x - mean)*inv
    formed inside the kernel (never written out). mean/inv: (C,)."""
    if dy.device.type == "cpu":
        return bn_bwd_sums_reference(dy, x, mean, inv)
    if dy.ndim != 2:
        raise ValueError("bn_bwd_sums takes (N, C) arrays; got %s" % (tuple(dy.shape),))
    return _launch(MODE_BWD, dy, x, mean, inv)


def bn_backward(dy, x, scale, mean, inv):
    """(dx, dscale, dbias) of train-mode BN from the saved (x, scale, mean,
    inv) and the output's cotangent dy, in one kernel call: the two column
    sums, then dx with xhat formed in the kernel. dy and x are row-contiguous
    with channels last (an NHWC tensor or its (N, C) view); dx has dy's
    shape. scale, mean, inv: (C,) float32."""
    device = dy.device
    if device.type == "cpu":
        return bn_backward_reference(dy, x, scale, mean, inv)
    n, c = _check(dy, x, mean=mean, inv=inv, scale=scale)
    g = _grid(n, c, device)
    dx = torch.empty_like(dy)
    # [dbias (C) | dscale (C) | coef (3C) | partials (2CG)]: the coefficients
    # start 8C bytes in, 16-byte aligned where the kernel takes float4s
    buf = torch.empty(c * (5 + 2 * g), device=device, dtype=torch.float32)
    p = buf.data_ptr()
    _build.launch("ofa_bn_backward_f32", device, dy, x, scale, mean, inv, p + 20 * c,
                  p + 8 * c, p, dx, n, c, g)
    bn_backward.launches += 1
    dbias, dscale, _ = buf.split((c, c, c * (3 + 2 * g)))
    return dx, dscale, dbias


col_sums2.launches = 0
bn_moments.launches = 0
bn_bwd_sums.launches = 0
bn_backward.launches = 0
