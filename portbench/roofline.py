"""Peaks of the card and the least time of each kernel family's work.

Peaks: NVIDIA's H100 SXM data sheet, dense rates: 3.35 TB/s of HBM3,
989 TFLOP/s bf16 on the tensor cores, 495 TFLOP/s TF32, 67 TFLOP/s float32
on the CUDA cores. A float32 product on the tensor cores as 3xTF32 (three
TF32 products a float32 one, the port's serving kernels) counts three
times its operations at the TF32 rate.

A call's least time is the largest of its bytes over the memory's rate,
its tensor-core operations over their rate, and its CUDA-core operations
over theirs. The bytes count each input read once and each output written
once, for the work these inputs need: the sampled taps and widths, never
the bank's full size. A family's roofline share is the sum of its calls'
least times over the device time of its kernels, so it cannot pass 100%
unless the counts are too high or the time misses work.

The calls each model makes are enumerated from its configuration and the
sampled subnets (`s4_train_calls`, `cls_train_calls`, `s4_serve_calls`).
"""

from __future__ import annotations

from . import flops

HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12

# the kernels of each family, by function name as the profiler reports them
KERNELS = {
    "bn": ("col_partials_kernel", "finish_kernel", "bn_dx_kernel", "bn_fwd_finish_kernel",
           "bn_norm_kernel", "bn_fwd_from_sums_kernel", "bn_bwd_coef_kernel"),
    "dw_masked": ("dw_fwd_kernel", "dw_dgrad_kernel", "dw_wgrad_partial_kernel",
                  "dw_wgrad_finish_kernel"),
    "pw_masked": ("pw_fwd_kernel", "pw_dgrad_kernel", "pw_wgrad_kernel",
                  "pw_wgrad_finish_kernel"),
    "mbconv": ("mbconv_kernel",),
    "shuffle_tail": ("shuffle_tail_kernel",),
}

F32 = 4


class Call:
    """One kernel call's work: bytes moved, tensor-core operations (at
    `tensor_rate`), CUDA-core float32 operations."""

    __slots__ = ("family", "bytes", "tensor_ops", "tensor_rate", "core_ops")

    def __init__(self, family, nbytes, tensor_ops=0.0, tensor_rate=BF16_FLOPS, core_ops=0.0):
        self.family, self.bytes = family, nbytes
        self.tensor_ops, self.tensor_rate, self.core_ops = tensor_ops, tensor_rate, core_ops

    def least_s(self):
        return max(self.bytes / HBM_BYTES_S, self.tensor_ops / self.tensor_rate,
                   self.core_ops / FP32_FLOPS)


def least_s(calls, family):
    return sum(c.least_s() for c in calls if c.family == family)


# -- the training step's calls -------------------------------------------------

def bn_train(rows, c, b):
    """Train-mode BN of a rows x c activation in a type of `b` bytes, both
    directions: forward reads x, writes y (and the running statistics);
    backward reads dy and x, writes dx (and dscale, dbias)."""
    if not rows or not c:
        return []
    return [Call("bn", 2 * rows * c * b + 6 * c * F32),
            Call("bn", 3 * rows * c * b + 5 * c * F32)]


def dw_masked_train(rows_in, rows_out, mid, k, b):
    """The masked depthwise's three directions over the sampled k x k taps
    and the `mid` channels."""
    w = k * k * mid * b
    return [Call("dw_masked", rows_in * mid * b + w + rows_out * mid * b),
            Call("dw_masked", rows_out * mid * b + w + rows_in * mid * b),
            Call("dw_masked", rows_in * mid * b + rows_out * mid * b + w)]


def pw_masked_train(rows, c, mid, b):
    """The masked 1x1 expand (c -> mid) and project (mid -> c) convs, each
    forward, dgrad and wgrad, bounded by the sampled width `mid`; bf16
    operations on the tensor cores (a float32 step's as 3xTF32)."""
    rate, mult = (BF16_FLOPS, 1) if b == 2 else (TF32_FLOPS, 3)
    ops = mult * 2.0 * rows * c * mid
    w = c * mid * b
    a_c, a_m = rows * c * b, rows * mid * b
    calls = []
    for _ in range(2):  # expand, then project: the same bytes either way
        calls += [Call("pw_masked", a_c + w + a_m, ops, rate),   # forward
                  Call("pw_masked", a_m + w + a_c, ops, rate),   # dgrad
                  Call("pw_masked", a_c + a_m + w, ops, rate)]   # wgrad
    return calls


def s4_train_calls(cfg, subnet, batch, hr, b, expand_lever=True):
    """The calls of one subnet's pass (forward and backward) of the S4's
    masked training step: every train-mode BN (3 a block, the first conv,
    the two final convs, each shuffle conv, the output conv), the masked
    depthwise of each block and, under the expand lever, its masked 1x1
    convs. `subnet`: {"ks", "e", "d", "pixel_d"}; `b`: the compute type's
    bytes."""
    w = cfg["width"]
    md = max(cfg["depth_list"])
    lr = hr // 2 ** subnet["pixel_d"]
    rows = batch * lr * lr
    calls = bn_train(rows, w, b)
    for s in range(cfg["n_stages"]):
        for i in range(subnet["d"][s]):
            bi = s * md + i
            mid = flops.make_divisible(round(w * subnet["e"][bi]), 8)
            k = subnet["ks"][bi]
            calls += bn_train(rows, mid, b) + bn_train(rows, mid, b) + bn_train(rows, w, b)
            calls += dw_masked_train(rows, rows, mid, k, b)
            if expand_lever and len(cfg["expand_list"]) > 1:
                calls += pw_masked_train(rows, w, mid, b)
    calls += bn_train(rows, w, b) + bn_train(rows, w, b)
    side = lr
    for _ in range(subnet["pixel_d"]):
        calls += bn_train(batch * side * side, 4 * w, b)
        side *= 2
    calls += bn_train(batch * side * side, 3, b)
    return calls


def cls_train_calls(cfg, arch, batch, res, b):
    """The calls of one subnet's pass of the classification net's masked
    training step: train-mode BN of the first conv, the first block's two
    convs, each block the subnet runs (expand, depthwise, project) and the
    final expand conv; the masked depthwise of each block it runs. A block
    past its stage's depth runs gated off with width 0 and needs no work.
    `arch`: {"ks", "e", "d"}."""
    side = res // 2
    rows = batch * side * side
    w0 = cfg["first_conv_width"]
    fb = cfg.get("first_block_width") or w0
    calls = bn_train(rows, w0, b) + bn_train(rows, w0, b) + bn_train(rows, fb, b)
    in_ch, bi = fb, 0
    for si, (width, stride, _, _, n_block) in enumerate(cfg["stages"]):
        for i in range(n_block):
            st = stride if i == 0 else 1
            if i == 0 or i < arch["d"][si]:
                mid = flops.make_divisible(round(in_ch * arch["e"][bi]), 8)
                out_side = side // st
                r_in, r_out = rows, batch * out_side * out_side
                calls += (bn_train(r_in, mid, b) + bn_train(r_out, mid, b)
                          + bn_train(r_out, width, b))
                calls += dw_masked_train(r_in, r_out, mid, arch["ks"][bi], b)
            if i == 0:
                side //= st
                rows = batch * side * side
            in_ch = width
            bi += 1
    if cfg.get("final_expand_width"):
        calls += bn_train(rows, cfg["final_expand_width"], b)
    else:
        calls += bn_train(rows, cfg["feature_mix_width"], b)
    return calls


# -- the served frame's calls -----------------------------------------------------

def s4_serve_calls(cfg, subnet, h, w_px):
    """The calls of one float32 frame of a materialized S4 subnet at LR
    h x w_px: the fused MBConv of each block (its 1x1 convs as 3xTF32 on
    the tensor cores, its depthwise on the CUDA cores) and the fused 5x5
    conv + pixel shuffle of each shuffle stage (3xTF32)."""
    w = cfg["width"]
    md = max(cfg["depth_list"])
    rows = h * w_px
    calls = []
    for s in range(cfg["n_stages"]):
        for i in range(subnet["d"][s]):
            bi = s * md + i
            mid = flops.make_divisible(round(w * subnet["e"][bi]), 8)
            k = subnet["ks"][bi]
            weights = (w * mid + k * k * mid + mid * w + 2 * mid + w) * F32
            calls.append(Call("mbconv", 2 * rows * w * F32 + weights,
                              3 * 2.0 * rows * w * mid * 2, TF32_FLOPS,
                              2.0 * rows * k * k * mid))
    ck = cfg["conv_ks"]
    for _ in range(subnet["pixel_d"]):
        calls.append(Call("shuffle_tail",
                          rows * w * F32 + ck * ck * w * 4 * w * F32 + 4 * w * F32
                          + rows * 4 * w * F32,
                          3 * 2.0 * rows * w * 4 * w * ck * ck, TF32_FLOPS))
        rows *= 4
    return calls
