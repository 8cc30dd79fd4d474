"""Column reductions for BatchNorm statistics, and the train-mode BN
forward and backward built on them: counterpart of
ofa_sr_tpu/ops/pallas/bn_stats.py.

    col_sums2(a, b)            -> (sum_n a, sum_n a*b)        a, b: (N, C)
    bn_moments(x)              -> (mean, biased var) of NHWC x over (B, H, W)
    bn_bwd_sums(dy, x, m, inv) -> (sum_n dy, sum_n dy*(x - m)*inv)
    bn_forward(x, scale, bias, running_mean, running_var, *, momentum, eps,
               update_var)     -> (y, mean, var, inv)
    bn_backward(dy, x, scale, m, inv) -> (dx, dscale, dbias)
    bn_forward_from_sums(x, sums, scale, bias, running stats, *, n_total, ...)
                               -> (y, mean, var, inv)
    bn_backward_from_sums(dy, x, sums, scale, m, inv, *, n_total, active) -> dx

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
`bn_backward.launches` those of the fused backward,
`bn_forward_from_sums.launches` and `bn_backward_from_sums.launches` those
of the two apply entry points; each wrapper's `launches_bf16` counts its
bf16 launches alone. A call under a mesh launches no fused kernel: it
counts under `col_sums2` or `bn_bwd_sums` (pass 1) and the apply entry
point.

Under a mesh (`group`, data parallelism) `bn_forward` and `bn_backward`
take the statistics of every rank's rows, as the JAX package's BN does over
a batch sharded under jit: this rank's column totals (pass 1 and its sums,
`col_sums2` mode 3 or `bn_bwd_sums`), an all-reduce of them across the
ranks (torch.distributed, outside any kernel), then the apply part from
the totals and the global row count (`bn_forward_from_sums`,
`bn_backward_from_sums`), whose arithmetic is the fused call's: at one rank
the same bits. The plain versions take the same group and all-reduce the
same totals.

`bn_forward` and `bn_backward` take an optional `active`, a 0-d int32
tensor on x's device holding the active width of the masked forward (the
JAX package's channel mask, a prefix): the forward's finish launch updates
the running statistics only for c < active and its normalize writes y = 0
from there on; the backward's finish zeroes the sums and dx coefficients
of those columns, so dx, dscale and dbias are 0 there, the gradient of the
re-masked y. The width is read on the device, so a captured CUDA graph
replays the same launches for any width. Without it the launches and bits
are those of the call without the operand. The plain versions take the
same operand. Under a mesh the width goes with the group: the backward's
pass 1 (`col_sums2` mode 2) zeroes this rank's sums from it on before the
all-reduce, and the apply entry points take it as the fused calls do, so
at one rank the mesh route gives the fused call's bits with it too.

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

from ...parallel.mesh import all_reduce_sum, world_size
from . import _build

COL_TILE = 256        # threads of a pass-1 block = widest column tile
BLOCKS_PER_SM = 4     # pass-1 blocks aimed at per SM
MIN_ROW_STEPS = 8     # rows a pass-1 thread sums at least
# csrc/bn_stats.cu's pass-1 modes; MODE_FWD_SUMS is (sum x, sum x*x) read
# once, the forward's totals under a mesh
MODE_SUMS2, MODE_MOMENTS, MODE_BWD, MODE_FWD_SUMS = 0, 1, 2, 3
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


def _live(c, active, device):
    """(C,) bool: the columns below `active` (all of them if None)."""
    return None if active is None else torch.arange(c, device=device) < active


def bn_backward_reference(dy, x, scale, mean, inv, *, group=None, active=None):
    """(dx, dscale, dbias) of train-mode BN, written as the JAX package's VJP
    (ofa_sr_tpu/ops/pallas/bn.py `_bwd`, zero moment cotangents); dy, x with
    channels last, dx in x's shape and dy's type (one rounding from float32,
    as the JAX VJP's `dx.astype(x.dtype)`), dscale and dbias float32.
    `group`: the sums of dx's coefficients are taken over the ranks' rows
    (`bn_backward`'s contract). `active`: the columns from it on take zero
    sums and coefficients, as the kernel's finish writes them."""
    c = x.shape[-1]
    n = x.numel() // c
    s1, s2 = bn_bwd_sums_reference(dy.reshape(n, c), x.reshape(n, c), mean, inv)
    live = _live(c, active, x.device)
    if live is not None:
        s1, s2 = torch.where(live, s1, 0.0), torch.where(live, s2, 0.0)
    dx = bn_backward_from_sums_reference(dy, x, all_reduce_sum(torch.cat([s1, s2]), group),
                                         scale, mean, inv, n_total=n * world_size(group),
                                         live=live)
    return dx, s2, s1


def bn_backward_from_sums_reference(dy, x, sums, scale, mean, inv, *, n_total, live=None):
    """dx of train-mode BN from the totals sums = [sum dy | sum dy*xhat]
    over `n_total` rows (every rank's), for this rank's dy and x; `live`
    (C,) bool: the other columns' coefficient inv*scale is 0."""
    c = x.shape[-1]
    xhat = (x.float() - mean) * inv
    k = inv * scale.float()
    if live is not None:
        k = torch.where(live, k, 0.0)
    dx = k * (dy.float() - sums[:c] / n_total - xhat * sums[c:] / n_total)
    return dx.to(dy.dtype)


def bn_forward_from_moments(x, scale, bias, running_mean, running_var, mean, var, *,
                            momentum, eps, update_var, n_total=None, active=None):
    """The forward's arithmetic after the moments, as PyTorch ops in the
    kernel's association: inv, y (x's type) and the running statistics'
    update in place (skipped where they are None), whose unbiased var
    takes the moments' row count `n_total` (by default x's rows).
    `active`: y is 0 and the running statistics unchanged from that column
    on. Returns (y, mean, var, inv)."""
    inv = torch.rsqrt(var + eps)
    y = (x.float() - mean) * (inv * scale.float()) + bias.float()
    live = _live(x.shape[-1], active, x.device)
    if live is not None:
        y = torch.where(live, y, 0.0)
    y = y.to(x.dtype)
    if running_mean is not None:
        with torch.no_grad():
            n = x.numel() // x.shape[-1] if n_total is None else n_total
            var_for_update = var * (n / max(n - 1, 1)) if update_var == "unbiased" else var
            new_mean = (1 - momentum) * running_mean + momentum * mean
            new_var = (1 - momentum) * running_var + momentum * var_for_update
            if live is not None:
                new_mean = torch.where(live, new_mean, running_mean)
                new_var = torch.where(live, new_var, running_var)
            running_mean.copy_(new_mean)
            running_var.copy_(new_var)
    return y, mean, var, inv


def bn_forward_reference(x, scale, bias, running_mean, running_var, *, momentum, eps,
                         update_var, group=None, active=None):
    """(y, mean, var, inv) of train-mode BN over NHWC x (channels last),
    updating the running statistics in place: the moments' plain version,
    then `bn_forward_from_moments`. `group`: the moments of every rank's
    rows (`bn_forward`'s contract); `active`: the masked form's width."""
    flat = x.reshape(-1, x.shape[-1])
    sums = all_reduce_sum(torch.cat(col_sums2_reference(flat, flat)), group)
    return bn_forward_from_sums_reference(
        x, sums, scale, bias, running_mean, running_var,
        n_total=flat.shape[0] * world_size(group), momentum=momentum, eps=eps,
        update_var=update_var, active=active)


def bn_forward_from_sums_reference(x, sums, scale, bias, running_mean, running_var, *,
                                   n_total, momentum, eps, update_var, active=None):
    """(y, mean, var, inv) of train-mode BN from the totals sums = [sum x |
    sum x*x] over `n_total` rows (every rank's), for this rank's x: mean =
    s1/N, var = s2/N - mean^2, as `bn_moments_reference`; the running
    statistics take N."""
    c = x.shape[-1]
    mean = sums[:c] / n_total
    var = sums[c:] / n_total - torch.square(mean)
    return bn_forward_from_moments(x, scale, bias, running_mean, running_var, mean, var,
                                   momentum=momentum, eps=eps, update_var=update_var,
                                   n_total=n_total, active=active)


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


def _launch(mode, a, b, mean=None, inv=None, active=None):
    """Both passes of csrc/bn_stats.cu; returns the (2C,) float32 results,
    [first | second], and the entry point's suffix. `active` (mode 2, a
    checked width): the sums are 0 from it on. A call allocates one
    buffer, [out (2C) | partials (2CG)], and passes pointers into it: tensor
    views would cost more host time than the small launches take on the
    device."""
    n, c, suffix = _check(a, b, mean=mean, inv=inv)
    device = a.device
    g = _grid(n, c, suffix, device)
    buf = torch.empty(2 * c * (g + 1), device=device, dtype=torch.float32)
    _build.launch("ofa_col_sums2_" + suffix, device, a, b, mean, inv, buf.data_ptr() + 8 * c,
                  buf, n, c, g, mode, active)
    _count(bn_bwd_sums if mode == MODE_BWD else col_sums2, suffix)
    return buf[:2 * c], suffix


def _pair(out):
    c = out.shape[0] // 2
    return out[:c], out[c:]


def col_sums2(a, b):
    """(sum_n a, sum_n a*b) over the rows of two (N, C) arrays."""
    if a.device.type == "cpu":
        return col_sums2_reference(a, b)
    if a.ndim != 2:
        raise ValueError("col_sums2 takes (N, C) arrays; got %s" % (tuple(a.shape),))
    return _pair(_launch(MODE_SUMS2, a, b)[0])


def bn_moments(x):
    """Per-channel (mean, biased var) of an NHWC tensor, one pass over x."""
    if x.device.type == "cpu":
        return bn_moments_reference(x)
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("bn_moments takes a contiguous NHWC tensor; got shape %s "
                         "contiguous=%s" % (tuple(x.shape), x.is_contiguous()))
    out, suffix = _launch(MODE_MOMENTS, x, x)
    _count(bn_moments, suffix)
    return _pair(out)


def bn_bwd_sums(dy, x, mean, inv):
    """(sum_n dy, sum_n dy*xhat) over (N, C) arrays, xhat = (x - mean)*inv
    formed inside the kernel (never written out). mean/inv: (C,)."""
    if dy.device.type == "cpu":
        return bn_bwd_sums_reference(dy, x, mean, inv)
    if dy.ndim != 2:
        raise ValueError("bn_bwd_sums takes (N, C) arrays; got %s" % (tuple(dy.shape),))
    return _pair(_launch(MODE_BWD, dy, x, mean, inv)[0])


def _check_active(active, device):
    """Raise unless `active` is None or a one-element int32 tensor on
    `device` (the kernels read it through a pointer)."""
    if active is not None and not (active.numel() == 1 and active.dtype is torch.int32
                                   and active.device == device):
        raise ValueError("active must be a one-element int32 tensor on %s; got %s %s %s"
                         % (device, active.dtype, tuple(active.shape), active.device))


def bn_forward(x, scale, bias, running_mean, running_var, *, momentum, eps=1e-5,
               update_var="unbiased", group=None, active=None):
    """Train-mode BN of row-contiguous, channels-last x (an NHWC tensor or
    its (N, C) view) in one kernel call: (y, mean, var, inv), y in x's
    type and shape, the batch moments (biased var) and inv = rsqrt(var +
    eps) float32 (C,). running_mean and running_var, float32 (C,) tensors
    (prefix views of a wider BN's buffers too) or both None, take
    r = (1 - momentum)*r + momentum*stat in place, from the unbiased var
    (torch train mode) or the biased one (`update_var="biased"`, BN
    recalibration).

    `group` (a torch.distributed process group; every rank holding as many
    rows): the moments are those of every rank's rows, and the unbiased
    var takes their count. On the card that is two calls with an
    all-reduce of the (2, C) totals between them: pass 1 and its sums
    (`col_sums2`'s mode 3), then `bn_forward_from_sums`; at one rank the
    bits of the call without a group.

    `active` (a one-element int32 tensor on x's device): the masked form's
    active width (module docstring), with or without a group."""
    if momentum is None:
        raise ValueError("bn_forward takes a float momentum (the EMA), not None")
    if update_var not in UPDATE_VARS:
        raise ValueError("update_var must be 'unbiased' or 'biased', got %r" % (update_var,))
    if (running_mean is None) != (running_var is None):
        raise ValueError("bn_forward takes both running statistics or neither")
    device = x.device
    _check_active(active, device)
    if device.type == "cpu":
        return bn_forward_reference(x, scale, bias, running_mean, running_var,
                                    momentum=momentum, eps=eps, update_var=update_var,
                                    group=group, active=active)
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
    if group is not None:
        sums = all_reduce_sum(_launch(MODE_FWD_SUMS, x, x)[0], group)
        return _forward_from_sums(x, sums, scale, bias, running_mean, running_var, n, c,
                                  n * world_size(group), suffix, momentum, eps, update_var,
                                  active)
    g = _grid(n, c, suffix, device)
    y = torch.empty_like(x)
    # [mean | var | inv | inv*scale (4C) | partials (2CG)]
    buf = torch.empty(c * (4 + 2 * g), device=device, dtype=torch.float32)
    p = buf.data_ptr()
    _build.launch("ofa_bn_forward_" + suffix, device, x, scale, bias, running_mean,
                  running_var, p, p + 16 * c, y, n, c, g, momentum, eps,
                  update_var == "unbiased", active)
    _count(bn_forward, suffix)
    mean, var, inv, _ = torch.split_with_sizes(buf, (c, c, c, c * (1 + 2 * g)))
    return y, mean, var, inv


def bn_backward(dy, x, scale, mean, inv, *, group=None, active=None):
    """(dx, dscale, dbias) of train-mode BN from the saved (x, scale, mean,
    inv) and the output's cotangent dy, in one kernel call: the two column
    sums, then dx with xhat formed in the kernel. dy and x are row-contiguous
    with channels last (an NHWC tensor or its (N, C) view), of one type; dx
    has dy's shape and type. scale, mean, inv: (C,) float32.

    `group` (the forward's): dx takes the sums over every rank's rows (an
    all-reduce of the (2, C) totals between this rank's sums, `bn_bwd_sums`,
    and `bn_backward_from_sums`); dscale and dbias stay this rank's sums,
    its share of the parameters' gradient, which the trainer's gradient
    all-reduce adds up with every other parameter's.

    `active` (the forward's): dx, dscale and dbias are 0 from that column
    on, with or without a group."""
    device = dy.device
    _check_active(active, device)
    if device.type == "cpu":
        return bn_backward_reference(dy, x, scale, mean, inv, group=group, active=active)
    n, c, suffix = _check(dy, x, mean=mean, inv=inv, scale=scale)
    if group is not None:
        local = _launch(MODE_BWD, dy, x, mean, inv, active)[0]
        dx = _backward_from_sums(dy, x, all_reduce_sum(local.clone(), group), scale, mean, inv,
                                 n, c, n * world_size(group), suffix, active)
        return dx, local[c:], local[:c]
    g = _grid(n, c, suffix, device)
    dx = torch.empty_like(dy)
    # [dbias (C) | dscale (C) | coef (3C) | partials (2CG)]: the coefficients
    # start 8C bytes in, 16-byte aligned where the kernel takes float4s
    buf = torch.empty(c * (5 + 2 * g), device=device, dtype=torch.float32)
    p = buf.data_ptr()
    _build.launch("ofa_bn_backward_" + suffix, device, dy, x, scale, mean, inv, p + 20 * c,
                  p + 8 * c, p, dx, n, c, g, active)
    _count(bn_backward, suffix)
    dbias, dscale, _ = buf.split((c, c, c * (3 + 2 * g)))
    return dx, dscale, dbias


def _check_total(n, n_total):
    if not n <= n_total < 2 ** 31:
        raise ValueError("n_total (every rank's rows) must be at least this rank's %d and "
                         "below 2**31; got %r" % (n, n_total))


def bn_forward_from_sums(x, sums, scale, bias, running_mean, running_var, *, n_total,
                         momentum, eps=1e-5, update_var="unbiased", active=None):
    """The apply part of `bn_forward` under a mesh: (y, mean, var, inv) for
    this rank's x from `sums` = [sum x | sum x*x] (2C float32) over
    `n_total` rows of every rank, the running statistics updated in place
    (the unbiased var from n_total). One call of two launches on the card
    (csrc/bn_stats.cu `ofa_bn_forward_from_sums_*`: the finish of the fused
    forward on the totals, then its normalize). `active`: `bn_forward`'s
    (the running statistics kept and y 0 from it on)."""
    if update_var not in UPDATE_VARS:
        raise ValueError("update_var must be 'unbiased' or 'biased', got %r" % (update_var,))
    if (running_mean is None) != (running_var is None):
        raise ValueError("bn_forward_from_sums takes both running statistics or neither")
    _check_active(active, x.device)
    if x.device.type == "cpu":
        return bn_forward_from_sums_reference(
            x, sums, scale, bias, running_mean, running_var, n_total=n_total,
            momentum=momentum, eps=eps, update_var=update_var, active=active)
    if not x.is_contiguous():
        raise ValueError("bn_forward_from_sums takes a row-contiguous x; got strides %s"
                         % (x.stride(),))
    n, c, suffix = _check(x, x, scale=scale, bias=bias, running_mean=running_mean,
                          running_var=running_var)
    _check_total(n, n_total)
    _build.require_cuda(x.device, torch.float32, sums=sums)
    if sums.shape != (2 * c,):
        raise ValueError("sums must be (2C,) = (%d,); got %s" % (2 * c, tuple(sums.shape)))
    return _forward_from_sums(x, sums, scale, bias, running_mean, running_var, n, c, n_total,
                              suffix, momentum, eps, update_var, active)


def _forward_from_sums(x, sums, scale, bias, running_mean, running_var, n, c, n_total, suffix,
                       momentum, eps, update_var, active):
    """`bn_forward_from_sums`'s launch on checked operands (`bn_forward`
    under a mesh calls it after its own checks)."""
    y = torch.empty_like(x)
    stats = torch.empty(4 * c, device=x.device, dtype=torch.float32)
    _build.launch("ofa_bn_forward_from_sums_" + suffix, x.device, x, sums, scale, bias,
                  running_mean, running_var, stats, y, n, c, n_total, momentum, eps,
                  update_var == "unbiased", active)
    _count(bn_forward_from_sums, suffix)
    mean, var, inv, _ = stats.split(c)
    return y, mean, var, inv


def bn_backward_from_sums(dy, x, sums, scale, mean, inv, *, n_total, active=None):
    """The apply part of `bn_backward` under a mesh: dx for this rank's dy
    and x from `sums` = [sum dy | sum dy*xhat] (2C float32) over `n_total`
    rows of every rank. One call of two launches on the card
    (csrc/bn_stats.cu `ofa_bn_backward_from_sums_*`: the dx coefficients,
    then the fused backward's dx pass). `active`: `bn_backward`'s (the
    coefficients, so dx, 0 from it on)."""
    _check_active(active, dy.device)
    if dy.device.type == "cpu":
        return bn_backward_from_sums_reference(dy, x, sums, scale, mean, inv, n_total=n_total,
                                               live=_live(x.shape[-1], active, x.device))
    n, c, suffix = _check(dy, x, mean=mean, inv=inv, scale=scale)
    _check_total(n, n_total)
    _build.require_cuda(dy.device, torch.float32, sums=sums)
    if sums.shape != (2 * c,):
        raise ValueError("sums must be (2C,) = (%d,); got %s" % (2 * c, tuple(sums.shape)))
    return _backward_from_sums(dy, x, sums, scale, mean, inv, n, c, n_total, suffix, active)


def _backward_from_sums(dy, x, sums, scale, mean, inv, n, c, n_total, suffix, active):
    """`bn_backward_from_sums`'s launch on checked operands."""
    dx = torch.empty_like(dy)
    coef = torch.empty(3 * c, device=dy.device, dtype=torch.float32)
    _build.launch("ofa_bn_backward_from_sums_" + suffix, dy.device, dy, x, sums, scale, mean,
                  inv, coef, dx, n, c, n_total, active)
    _count(bn_backward_from_sums, suffix)
    return dx


for _wrapper in (col_sums2, bn_moments, bn_bwd_sums, bn_forward, bn_backward,
                 bn_forward_from_sums, bn_backward_from_sums):
    _wrapper.launches = _wrapper.launches_bf16 = 0
