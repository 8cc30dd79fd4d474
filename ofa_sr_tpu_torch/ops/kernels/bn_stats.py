"""Column reductions for BatchNorm statistics, and the train-mode BN
forward and backward built on them: counterpart of
ofa_sr_tpu/ops/pallas/bn_stats.py.

    col_sums2(a, b)            -> (sum_n a, sum_n a*b)        a, b: (N, C)
    bn_moments(x)              -> (mean, biased var) of NHWC x over (B, H, W)
    bn_bwd_sums(dy, x, m, inv) -> (sum_n dy, sum_n dy*(x - m)*inv)
    bn_forward(x, scale, bias, running_mean, running_var, *, momentum, eps,
               update_var)     -> (y, mean, var, inv)
    bn_backward(dy, x, scale, m, inv) -> (dx, dscale, dbias)

all accumulated in float32, from float32 or bfloat16 activations (a, b,
dy, x of one type; the vectors mean, inv, scale, bias and the running
statistics float32). `bn_moments` is col_sums2(x, x) with mean = s1/n and
var = s2/n - mean^2, the JAX package's formula; on the card the col_sums2
kernel computes that finalize itself in its second pass.
`bn_forward` is the whole train-mode BN forward: the moments, then
inv = rsqrt(var + eps) and y = (x - mean)*(inv*scale) + bias (what XLA
fuses after the Pallas moments in ofa_sr_tpu/ops/pallas/bn.py), then the
running statistics' momentum EMA in place (ofa_sr_tpu/ops/norm.py), from
the unbiased or the biased var; on the card one call of three launches
(csrc/bn_stats.cu `ofa_bn_forward_f32` / `_bf16`: pass 1, the finish with
the running statistics, the normalize). y comes back in x's type, rounded
once from float32.
`bn_backward` is the backward of train-mode BN with no cotangent on the
moments (ofa_sr_tpu/ops/pallas/bn.py `_bwd`): bn_bwd_sums' two sums, then
dx = inv*scale*(dy - s1/n - xhat*s2/n), dscale = s2, dbias = s1; on the
card one call runs the sums and the dx pass (csrc/bn_stats.cu
`ofa_bn_backward_f32` / `_bf16`), where the JAX package leaves dx to XLA's
fusion. dx comes back in the activations' type, rounded once from float32
(the JAX VJP's `dx.astype(x.dtype)`); sums and moments are float32.

Each function launches the hand-written kernel in csrc/bn_stats.cu for a
CUDA tensor and takes its plain version (`*_reference`) only for a CPU
tensor. The kernels take row-contiguous (N, C) arrays of any N >= 1 and
C >= 1 (no channel-count rule; a C=3 output BN goes through them too), in
float32 (the `_f32` entry points) or bfloat16 (`_bf16`), the type of the
activations choosing; other inputs raise, among them float16 and a bf16 dy
with a float32 x. `col_sums2.launches` counts the launches of the col_sums2
kernel (from `col_sums2` or `bn_moments`), `bn_moments.launches` those made
by `bn_moments`, `bn_bwd_sums.launches` those of the sums-only backward
kernel, `bn_forward.launches` those of the fused forward and
`bn_backward.launches` those of the fused backward, of both forms; each
wrapper's `launches_bf16` counts its bf16 launches alone.

A wrapper call is host work the training step waits on (~90 calls a step):
the pass-1 grid is cached per (N, C, device), and each call allocates one
buffer for its results and scratch (and its output, for the forward and
the backward) and makes no other tensor.

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
UPDATE_VARS = ("unbiased", "biased")
# the activation types the kernels take: the suffix of their C entry points,
# and the column groups a pass-1 thread reads, widest first (16 bytes, then
# for bf16 4 bytes, then one column: csrc/bn_stats.cu `vec_width`)
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_VEC_WIDTHS = {"f32": (4, 1), "bf16": (8, 2, 1)}


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
    channels last, dx in x's shape and dy's type (one rounding from float32,
    as the JAX VJP's `dx.astype(x.dtype)`), dscale and dbias float32."""
    c = x.shape[-1]
    n = x.numel() // c
    dyf = dy.float()
    xhat = (x.float() - mean) * inv
    s1, s2 = bn_bwd_sums_reference(dyf.reshape(n, c), x.reshape(n, c), mean, inv)
    dx = (inv * scale.float()) * (dyf - s1 / n - xhat * s2 / n)
    return dx.to(dy.dtype), s2, s1


def bn_forward_from_moments(x, scale, bias, running_mean, running_var, mean, var, *,
                            momentum, eps, update_var):
    """The forward's arithmetic after the moments, as PyTorch ops in the
    kernel's association: inv, y (x's type) and the running statistics'
    update in place (skipped where they are None). Returns (y, mean, var,
    inv)."""
    inv = torch.rsqrt(var + eps)
    y = ((x.float() - mean) * (inv * scale.float()) + bias.float()).to(x.dtype)
    if running_mean is not None:
        with torch.no_grad():
            n = x.numel() // x.shape[-1]
            var_for_update = var * (n / max(n - 1, 1)) if update_var == "unbiased" else var
            running_mean.copy_((1 - momentum) * running_mean + momentum * mean)
            running_var.copy_((1 - momentum) * running_var + momentum * var_for_update)
    return y, mean, var, inv


def bn_forward_reference(x, scale, bias, running_mean, running_var, *, momentum, eps,
                         update_var):
    """(y, mean, var, inv) of train-mode BN over NHWC x (channels last),
    updating the running statistics in place: the moments' plain version,
    then `bn_forward_from_moments`."""
    mean, var = bn_moments_reference(x)
    return bn_forward_from_moments(x, scale, bias, running_mean, running_var, mean, var,
                                   momentum=momentum, eps=eps, update_var=update_var)


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _grid(n, c, suffix, device):
    """Blocks G of pass 1 along the rows: about BLOCKS_PER_SM blocks per SM
    over all column tiles, each thread summing at least MIN_ROW_STEPS rows
    (a thread takes v adjacent columns as one load, the widest v of the
    type that divides C)."""
    v = next(v for v in _VEC_WIDTHS[suffix] if c % v == 0)
    groups = c // v
    tiles = -(-groups // COL_TILE)
    row_groups = COL_TILE // min(groups, COL_TILE)
    g = max(1, min(-(-BLOCKS_PER_SM * _sm_count(device) // tiles),
                   -(-n // (row_groups * MIN_ROW_STEPS))))
    rows = -(-n // g)
    return -(-n // rows)  # no block left without rows


def kernel_suffix(*activations):
    """The suffix of the C entry point ("f32" or "bf16") for activations of
    one type, float32 or bfloat16; raises on any other type or a mix."""
    dtype = activations[0].dtype
    if dtype not in KERNEL_DTYPES or any(t.dtype is not dtype for t in activations):
        raise ValueError("the BN kernels take float32 or bfloat16 activations of one type; "
                         "got %s" % ", ".join(str(t.dtype) for t in activations))
    return KERNEL_DTYPES[dtype]


def _check(a, b, **vectors):
    """(N, C, entry-point suffix) of row-contiguous a and b of one shape and
    type, channels last, after the checks every call makes; raises on what
    the kernels do not take."""
    suffix = kernel_suffix(a, b)
    c = a.shape[-1] if a.ndim else 0
    n = a.numel() // c if c else 0
    if (n < 1 or b.shape != a.shape
            or any(v is not None and v.shape != (c,) for v in vectors.values())):
        raise ValueError("the BN kernels take arrays with N, C >= 1 rows and columns, of "
                         "one shape (and (C,) %s); got %s %s" % (
                             "/".join(vectors), tuple(a.shape), tuple(b.shape)))
    _build.require_cuda(a.device, a.dtype, a=a, b=b)
    _build.require_cuda(a.device, torch.float32,
                        **{k: v for k, v in vectors.items() if v is not None})
    return n, c, suffix


def _count(wrapper, suffix):
    wrapper.launches += 1
    if suffix == "bf16":
        wrapper.launches_bf16 += 1


def _launch(mode, a, b, mean=None, inv=None):
    """Both passes of csrc/bn_stats.cu; returns the two (C,) float32 results
    and the entry point's suffix. A call allocates one buffer, [out (2C) |
    partials (2CG)], and passes pointers into it: tensor views would cost
    more host time than the small launches take on the device."""
    n, c, suffix = _check(a, b, mean=mean, inv=inv)
    device = a.device
    g = _grid(n, c, suffix, device)
    buf = torch.empty(2 * c * (g + 1), device=device, dtype=torch.float32)
    _build.launch("ofa_col_sums2_" + suffix, device, a, b, mean, inv, buf.data_ptr() + 8 * c,
                  buf, n, c, g, mode)
    _count(bn_bwd_sums if mode == MODE_BWD else col_sums2, suffix)
    first, second, _ = buf.split((c, c, 2 * c * g))
    return first, second, suffix


def col_sums2(a, b):
    """(sum_n a, sum_n a*b) over the rows of two (N, C) arrays."""
    if a.device.type == "cpu":
        return col_sums2_reference(a, b)
    if a.ndim != 2:
        raise ValueError("col_sums2 takes (N, C) arrays; got %s" % (tuple(a.shape),))
    return _launch(MODE_SUMS2, a, b)[:2]


def bn_moments(x):
    """Per-channel (mean, biased var) of an NHWC tensor, one pass over x."""
    if x.device.type == "cpu":
        return bn_moments_reference(x)
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("bn_moments takes a contiguous NHWC tensor; got shape %s "
                         "contiguous=%s" % (tuple(x.shape), x.is_contiguous()))
    mean, var, suffix = _launch(MODE_MOMENTS, x, x)
    _count(bn_moments, suffix)
    return mean, var


def bn_bwd_sums(dy, x, mean, inv):
    """(sum_n dy, sum_n dy*xhat) over (N, C) arrays, xhat = (x - mean)*inv
    formed inside the kernel (never written out). mean/inv: (C,)."""
    if dy.device.type == "cpu":
        return bn_bwd_sums_reference(dy, x, mean, inv)
    if dy.ndim != 2:
        raise ValueError("bn_bwd_sums takes (N, C) arrays; got %s" % (tuple(dy.shape),))
    return _launch(MODE_BWD, dy, x, mean, inv)[:2]


def bn_forward(x, scale, bias, running_mean, running_var, *, momentum, eps=1e-5,
               update_var="unbiased"):
    """Train-mode BN of row-contiguous, channels-last x (an NHWC tensor or
    its (N, C) view) in one kernel call: (y, mean, var, inv), y in x's
    type and shape, the batch moments (biased var) and inv = rsqrt(var +
    eps) float32 (C,). running_mean and running_var, float32 (C,) tensors
    (prefix views of a wider BN's buffers too) or both None, take
    r = (1 - momentum)*r + momentum*stat in place, from the unbiased var
    (torch train mode) or the biased one (`update_var="biased"`, BN
    recalibration)."""
    if momentum is None:
        raise ValueError("bn_forward takes a float momentum (the EMA), not None")
    if update_var not in UPDATE_VARS:
        raise ValueError("update_var must be 'unbiased' or 'biased', got %r" % (update_var,))
    if (running_mean is None) != (running_var is None):
        raise ValueError("bn_forward takes both running statistics or neither")
    device = x.device
    if device.type == "cpu":
        return bn_forward_reference(x, scale, bias, running_mean, running_var,
                                    momentum=momentum, eps=eps, update_var=update_var)
    suffix = kernel_suffix(x)
    c = x.shape[-1] if x.ndim else 0
    for name, r in (("running_mean", running_mean), ("running_var", running_var)):
        if r is not None and (r.dtype is not torch.float32 or r.shape != (c,)):
            raise ValueError("%s must be a float32 (C,) = (%d,) tensor; got %s %s"
                             % (name, c, r.dtype, tuple(r.shape)))
    if not x.is_contiguous():
        raise ValueError("bn_forward takes a row-contiguous x; got strides %s" % (x.stride(),))
    n, c, suffix = _check(x, x, scale=scale, bias=bias, running_mean=running_mean,
                          running_var=running_var)
    g = _grid(n, c, suffix, device)
    y = torch.empty_like(x)
    # [mean | var | inv | inv*scale (4C) | partials (2CG)]
    buf = torch.empty(c * (4 + 2 * g), device=device, dtype=torch.float32)
    p = buf.data_ptr()
    _build.launch("ofa_bn_forward_" + suffix, device, x, scale, bias, running_mean,
                  running_var, p, p + 16 * c, y, n, c, g, momentum, eps,
                  update_var == "unbiased")
    _count(bn_forward, suffix)
    mean, var, inv, _ = torch.split_with_sizes(buf, (c, c, c, c * (1 + 2 * g)))
    return y, mean, var, inv


def bn_backward(dy, x, scale, mean, inv):
    """(dx, dscale, dbias) of train-mode BN from the saved (x, scale, mean,
    inv) and the output's cotangent dy, in one kernel call: the two column
    sums, then dx with xhat formed in the kernel. dy and x are row-contiguous
    with channels last (an NHWC tensor or its (N, C) view), of one type; dx
    has dy's shape and type. scale, mean, inv: (C,) float32."""
    device = dy.device
    if device.type == "cpu":
        return bn_backward_reference(dy, x, scale, mean, inv)
    n, c, suffix = _check(dy, x, mean=mean, inv=inv, scale=scale)
    g = _grid(n, c, suffix, device)
    dx = torch.empty_like(dy)
    # [dbias (C) | dscale (C) | coef (3C) | partials (2CG)]: the coefficients
    # start 8C bytes in, 16-byte aligned where the kernel takes float4s
    buf = torch.empty(c * (5 + 2 * g), device=device, dtype=torch.float32)
    p = buf.data_ptr()
    _build.launch("ofa_bn_backward_" + suffix, device, dy, x, scale, mean, inv, p + 20 * c,
                  p + 8 * c, p, dx, n, c, g)
    _count(bn_backward, suffix)
    dbias, dscale, _ = buf.split((c, c, c * (3 + 2 * g)))
    return dx, dscale, dbias


for _wrapper in (col_sums2, bn_moments, bn_bwd_sums, bn_forward, bn_backward):
    _wrapper.launches = _wrapper.launches_bf16 = 0
