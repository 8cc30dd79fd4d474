"""Drive the PyTorch/CUDA port (ofa_sr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure ends the run with a non-zero exit and no result line):
1. The card (nvidia-smi name and power limit), torch / CUDA versions, and
   the build of the hand-written kernels from csrc/ (nvcc, one per source,
   in parallel).
2. Kernel parity on the card: each kernel against its plain PyTorch version
   on the same inputs, at the serving and training paths' shapes and a few
   ragged ones (the fused BN backward `bn_backward`: dx, dscale, dbias; the
   shuffle tail and the MBConv also against float64, each no less accurate
   than its cuDNN float32 composition);
   train-mode BN through the BN kernels (`bn_train_fused`) against the
   plain autograd branch: y, dx, dscale, dbias. Then the bf16 forms of the
   BN kernels (`ofa_col_sums2_bf16`, `ofa_bn_backward_bf16`) the same way on
   bf16 tensors, at every BN shape of the training path plus C = 3, ragged
   C and misaligned rows (sums and moments at the float32 rows' tolerance,
   dx within one bf16 ulp), and float16 or a bf16 dy with a float32 x
   refused on the card.
3. Serving: a full-width OFAMobileNetS4 (seeded he_fout weights, random BN
   statistics) materialized as the ks7/e6/d2/pixel_d 2 subnet serves 8 LR
   180x320 frames (720p out) through `entry.serve`, with every kernel's
   launch count read around that run; the frames are held against the same
   subnet run on the plain (cuDNN) path on the card, and a small frame
   against the same subnet on the CPU. Frame times from CUDA events; device
   time by kernel and the idle share from torch.profiler.
4. The supernet eval forward of `entry.entry` (bs16, 48x48, pixel_d 1),
   held against the same forward on the CPU; then training through
   `entry.train` on the full-width supernet (bs16, 96x96 HR, Adam, weight
   decay 3e-5): 8 one-subnet steps (both pixel_d among their subnets) and 2
   steps of 4 subnets with KD, each BN wrapper's launches (col_sums2,
   bn_moments, bn_backward) read around each run and held to
   3*sum(d) + pixel_d + 4 a subnet (the
   teacher's eval forward launches none); then the same two runs in bf16
   mixed precision (`compute_dtype=torch.bfloat16`, the JAX bench's own
   training envelope), where every BN launch must be a bf16 one, and the
   one-subnet bf16 run once more on the plain path (losses held to the
   kernel path's). Then, outside the counted runs:
   kernel path against plain path (`use_kernels=False`) on the card from the
   same weights (SGD: per-step losses, params after one step), a small step
   card against CPU, ms per step of the float32 and bf16 kernel and plain
   paths (CUDA events, in the order f32 plain, f32 kernels, bf16 kernels,
   bf16 plain, then back), and (profiled in phase 5) the device's idle
   share and top kernels.
5. The run-management path through the port's two command-line entry
   points, in a temporary directory, at full width: the teacher trainer
   (`cli.train_teacher_net_sr_simple`, synthetic data, BN in train mode)
   for 2 epochs of 4 steps with validation, its BN-kernel launches counted
   and held to 3*sum(d) + pixel_d + 4 a step, its checkpoint and log files
   checked; again with 3 epochs, which must resume at epoch 2 and run one;
   once in bf16, where every BN launch must be a bf16 one. Then the SR
   evaluator (`cli.eval_ofa_net_sr --materialize`, ks7/e6/d2/pixel_d 2,
   synthetic 720x720 HR frames: LR 180x180) from the teacher's checkpoint,
   its MBConv and shuffle-tail launches held to sum(d) and pixel_d a frame,
   and its mean PSNR-Y held within 1e-3 dB of the same subnet on the plain
   path. Times: the run manager's ms per step (CUDA events around
   `train_one_epoch`) against `entry.train`'s on the same net and against
   the epoch's data path alone (the loader, and the loader with the copies
   to the card), in alternating rounds; epoch wall seconds; eval ms per
   frame.
6. Per-kernel numbers at the paths' shapes (kernel, plain version, the
   card's least time, and for the BN kernels one PyTorch call computing the
   same function as a yardstick the port never calls), the BN kernels in
   float32 and in bf16. Then the torch.profiler
   sessions of phases 3 and 4, last, because a profiler session leaves the
   launch path slower for the rest of the process: device time and kernels
   per frame and per step, and the BN kernels' own device time. One JSON line of all of it, the
   nvidia-smi line, and the result line {"ok": true, "device": {...}}.

Float32 with TF32 off for cuDNN and matmuls, so the card's numbers compare
with the CPU's, apart from the bf16 training runs; the shuffle-tail and
MBConv kernels' own TF32 products are compensated (3xTF32, float32
accuracy). Exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bn_path_times import bn_train_shapes, time_ms  # noqa: E402
from ofa_sr_tpu_torch.entry import (  # noqa: E402
    entry,
    kd_teacher,
    serve,
    step_subnets,
    synthetic_batch,
    train,
)
from ofa_sr_tpu_torch.cli import eval_ofa_net_sr, train_teacher_net_sr_simple  # noqa: E402
from ofa_sr_tpu_torch.cli.common import make_net, make_sr_provider  # noqa: E402
from ofa_sr_tpu_torch.data import SyntheticSRProvider  # noqa: E402
from ofa_sr_tpu_torch.models import OFAMobileNetS4, SearchSpace, get_active_subnet  # noqa: E402
from ofa_sr_tpu_torch.models.arch import uniform_subnet  # noqa: E402
from ofa_sr_tpu_torch.ops.kernels import _build  # noqa: E402
from ofa_sr_tpu_torch.ops.kernels.bn import bn_train_fused  # noqa: E402
from ofa_sr_tpu_torch.ops.kernels.bn_stats import (  # noqa: E402
    bn_backward,
    bn_backward_reference,
    bn_bwd_sums,
    bn_bwd_sums_reference,
    bn_moments,
    bn_moments_reference,
    col_sums2,
    col_sums2_reference,
)
from ofa_sr_tpu_torch.ops.kernels.mbconv import fused_mbconv_infer, mbconv_reference  # noqa: E402
from ofa_sr_tpu_torch.ops.kernels.shuffle_tail import (  # noqa: E402
    fused_shuffle_tail,
    shuffle_tail_reference,
)
from ofa_sr_tpu_torch.ops.norm import batch_norm_train  # noqa: E402
from ofa_sr_tpu_torch.train import RunConfig, SRRunManager, SRTrainer  # noqa: E402
from ofa_sr_tpu_torch.train.checkpoint import load_weights_lenient  # noqa: E402
from ofa_sr_tpu_torch.utils.metrics import psnr_y_device  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, TF32 on the tensor cores (dense), and HBM3 bandwidth. The shuffle
# tail and the MBConv's 1x1 convs multiply on the tensor cores, 3 TF32
# products a multiply-add (3xTF32); the MBConv's depthwise and the BN
# kernels use the FP32 pipe.
PEAK_F32_FLOPS = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
TOL = dict(rtol=1e-4, atol=1e-4)      # kernel vs plain, float32, other sum order
FRAME_TOL = dict(rtol=1e-3, atol=1e-3)  # whole frames: errors compound over ~14 layers
# column sums of float32 rows (kernel vs plain, each summing ~100 terms in
# sequence at most): |err| <= SUM_RTOL * sum|terms| per column, twice a
# worst-case float32 bound
SUM_RTOL = 2e-5
MOMENT_TOL = dict(rtol=1e-4, atol=5e-5)   # mean / biased var of O(1) data
# the 3xTF32 kernels (shuffle tail, MBConv) against a float64 run of their
# plain version at the path shape: their max abs error at most this many
# times the cuDNN float32 composition's (PERF.md: the tail reads ~0.35x;
# MMAs chained into one truncating accumulator read several times 1x)
F64_RATIO = 1.0
STEP_TOL = dict(rtol=1e-4, atol=1e-5)     # params after one SGD step, kernels vs plain
BF16 = torch.bfloat16
# a bf16 dx, kernel vs plain: each rounds its float32 value once, so where
# the two (summed in other orders) straddle a rounding boundary they differ
# by one bf16 ulp, at most 2^-7 of the value; plus the float32 tolerance
# where dx cancels to near 0
BF16_DX_TOL = dict(rtol=2.0 ** -7, atol=1e-4)
# bf16 training losses, kernel path vs plain path (bf16 roundings flip apart
# over the steps): half the JAX package's own bf16-against-float32 bound of
# 2% of the loss (tests/test_train.py)
BF16_STEP_TOL = dict(rtol=1e-2, atol=0)
# params after one SGD step (lr 0.01), card vs CPU: the convs' weight
# gradients are sums over the batch in cuDNN's order and the CPU's
DEVICE_STEP_TOL = dict(rtol=1e-4, atol=1e-4)
LR_HW = (180, 320)                    # 720p output at 4x
N_FRAMES = 8
BS, HR = 16, 96                       # the training envelope of the JAX bench
TRAIN_STEPS = 8                       # one-subnet steps; steps 0-7 sample both pixel_d
KD_STEPS = 2                          # steps of 4 subnets with KD
STEP_ROUNDS = 3                       # rounds of (plain, kernels, kernels, plain) timing
# the BN wrappers the training path calls, one launch each per train-mode BN
BN_KERNELS = (col_sums2, bn_moments, bn_backward)
# the __global__ functions of csrc/*.cu, as the profiler names them
PORT_KERNELS = ("col_partials_kernel", "finish_kernel", "bn_dx_kernel", "mbconv_kernel",
                "shuffle_tail_kernel")
# the kernels of each BN row, as the profiler names them (the mode is the
# template argument: 1 moments, 2 backward)
# the backward row times `bn_backward`: bn_bwd_sums' sums and dx in one call
BWD_ROW = "bn_bwd_sums+dx (bn_backward)"
BN_ROW_KERNELS = {"col_sums2": ("col_partials_kernel<1,", "finish_kernel<1>"),
                  BWD_ROW: ("col_partials_kernel<2,", "finish_kernel<2>", "bn_dx_kernel")}
# the bf16 forms' rows: the same kernels, instantiated for __nv_bfloat16
# (finish_kernel reads float32 partials and is shared; each step profile
# runs one type only)
BF16_ROWS = {"col_sums2": "col_sums2 (bf16)", BWD_ROW: "bn_bwd_sums+dx (bn_backward, bf16)"}
DEVICE = "cuda"                       # the card; a CPU rehearsal sets "cpu"
# phase 5: the CLIs' synthetic data (cli.common.make_sr_provider: 64
# training images at the batch size, 4 validation frames)
TEACHER_EPOCH_STEPS = 64 // BS
EVAL_HR = 720                         # the evaluator's HR frames: LR 180x180 at pixel_d 2
EVAL_FRAMES = 4
PSNR_TOL_DB = 1e-3                    # evaluator's mean PSNR-Y, kernels vs plain path
RM_ROUNDS = 3                         # rounds of (entry.train, train_one_epoch) timing


def fail(msg):
    print("FAIL: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check_close(name, got, ref, tol):
    err = float((got - ref).abs().max())
    bound = float((tol["atol"] + tol["rtol"] * ref.abs()).min())
    ok = bool(torch.isfinite(got).all()) and bool(
        ((got - ref).abs() <= tol["atol"] + tol["rtol"] * ref.abs()).all())
    print("  %-58s max_abs_err %.3e  (atol %.0e + rtol %.0e*|ref|)  %s"
          % (name, err, tol["atol"], tol["rtol"], "ok" if ok else "FAIL"), flush=True)
    if not ok:
        fail("%s disagrees with its reference (max abs err %.3e, tightest bound %.3e)"
             % (name, err, bound))
    return err


def bound_ms(flops, nbytes, peak=PEAK_F32_FLOPS):
    """(ms of the operations at `peak`, ms of the bytes at the memory rate):
    the least time is the larger of the two."""
    return flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3


def bound_of(weighted):
    """Least time of launches given as [((ops ms, bytes ms), count)], and what
    bounds the larger share of it."""
    total = sum(max(t) * k for t, k in weighted)
    ops = sum(t[0] * k for t, k in weighted if t[0] >= t[1])
    return total, "operations" if 2 * ops >= total else "bytes"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def randn(g, *shape, scale=1.0, device=None):
    return (scale * torch.randn(*shape, generator=g)).to(device or DEVICE)


# -- phase 2: kernels against their plain versions ---------------------------

def mbconv_case(g, shape, m, ks, device="cuda"):
    c = shape[-1]
    x = randn(g, *shape, device=device)
    w = dict(ib_w=randn(g, c, m, scale=0.15, device=device),
             ib_b=randn(g, m, scale=0.5, device=device),
             dw_w=randn(g, ks, ks, m, scale=0.15, device=device),
             dw_b=randn(g, m, scale=0.5, device=device),
             pl_w=randn(g, m, c, scale=0.05, device=device),
             pl_b=randn(g, c, scale=0.5, device=device))
    return x, w


def shuffle_case(g, shape, device="cuda"):
    c = shape[-1]
    x = torch.rand(*shape, generator=g).to(device)
    return x, randn(g, 5, 5, c, 4 * c, scale=0.03, device=device), randn(g, 4 * c, scale=0.1, device=device)


def launched(wrapper, fn, bf16=False):
    """fn()'s result; fails unless it launched `wrapper`'s kernel once (its
    bf16 form when `bf16`, else the float32 one)."""
    before = wrapper.launches, getattr(wrapper, "launches_bf16", 0)
    out = fn()
    if (wrapper.launches, getattr(wrapper, "launches_bf16", 0)) != (before[0] + 1,
                                                                    before[1] + bf16):
        fail("%s did not launch its %s kernel" % (wrapper.__name__, "bf16" if bf16 else "float32"))
    return out


def kernel_parity(g):
    """Returns {kernel: max abs err over the path's shapes}, and the shuffle
    tail's and its plain version's max abs err against a float64 conv at
    the LR path shape."""
    errs = {"mbconv": 0.0, "shuffle_tail": 0.0}
    path = (1,) + LR_HW + (64,)
    # after the path's shapes, what the 15x16 tile and the 16-channel mid
    # chunk leave ragged: M 72 (4.5 chunks) and M 45 (not a multiple of 4:
    # the weights are copied 4 bytes at a time), C 4 (zero-padded to one k8
    # step), a frame smaller than one tile, and B 2 at the path's H and W
    for shape, m, ks, res in [(path, 384, 7, True), (path, 384, 5, True),
                              (path, 384, 3, True), ((1, 7, 13, 64), 192, 5, False),
                              ((2, 18, 20, 64), 256, 3, True), ((1, 181, 37, 16), 48, 7, True),
                              ((1, 37, 50, 64), 72, 7, True), ((1, 37, 50, 32), 45, 5, False),
                              ((1, 23, 41, 4), 24, 7, True), ((2, 5, 6, 8), 48, 7, True),
                              ((2,) + LR_HW + (64,), 384, 7, True)]:
        x, w = mbconv_case(g, shape, m, ks)
        got = launched(fused_mbconv_infer,
                       lambda: fused_mbconv_infer(x, **w, residual=res))
        torch.cuda.synchronize()
        plain = mbconv_reference(x, **w, residual=res)
        err = check_close("mbconv %s M=%d k=%d residual=%s" % (shape, m, ks, res),
                          got, plain, TOL)
        if shape == path:
            errs["mbconv"] = max(errs["mbconv"], err)
        if shape == path and ks == 7:
            ref64 = mbconv_reference(x.double(), **{k: v.double() for k, v in w.items()})
            errs["mbconv_vs_f64"] = f64_check("mbconv %s M=%d k=7" % (shape, m), got, plain,
                                              ref64)
    # x 4 bytes past a 16-byte boundary: the kernel copies its halo 4 bytes
    # at a time
    x, w = mbconv_case(g, (1, 23, 41, 64), 48, 7)
    xm = torch.empty(x.numel() + 1, device=x.device)[1:].view(x.shape).copy_(x)
    got = launched(fused_mbconv_infer, lambda: fused_mbconv_infer(xm, **w))
    torch.cuda.synchronize()
    check_close("mbconv %s M=48 k=7, x not 16-byte aligned" % (tuple(x.shape),), got,
                mbconv_reference(x, **w), TOL)
    # (1, 9, 17, 6): Cin and Cout not multiples of 4, so the kernel loads the
    # halo and stores the output one float at a time
    for shape in [path, (1, 2 * LR_HW[0], 2 * LR_HW[1], 64), (2, 7, 13, 64), (1, 9, 17, 8),
                  (1, 9, 17, 6)]:
        x, w, b = shuffle_case(g, shape)
        got = launched(fused_shuffle_tail, lambda: fused_shuffle_tail(x, w, b))
        torch.cuda.synchronize()
        err = check_close("shuffle_tail %s" % (shape,), got, shuffle_tail_reference(x, w, b), TOL)
        if shape[0] == 1 and shape[-1] == 64 and shape[1] >= LR_HW[0]:
            errs["shuffle_tail"] = max(errs["shuffle_tail"], err)
        if shape == path:
            ref64 = shuffle_tail_reference(x.double(), w.double(), b.double())
            errs["shuffle_tail_vs_f64"] = f64_check(
                "shuffle_tail %s" % (shape,), got, shuffle_tail_reference(x, w, b), ref64)
    serving_bf16_operands(g)
    return errs


def serving_bf16_operands(g):
    """As the Pallas kernels: bf16 weights with a float32 x go through the
    float32 kernel on the weights upcast (exact), and a bf16 x is refused
    without a launch."""
    bf = lambda d: {k: v.to(BF16) for k, v in d.items()}  # noqa: E731
    x, w = mbconv_case(g, (1, 37, 50, 64), 384, 7)
    got = launched(fused_mbconv_infer, lambda: fused_mbconv_infer(x, **bf(w)))
    torch.cuda.synchronize()
    check_close("mbconv (1, 37, 50, 64) M=384 k=7, bf16 weights", got,
                mbconv_reference(x, **{k: v.float() for k, v in bf(w).items()}), TOL)
    xt, wt, bt = shuffle_case(g, (1, 37, 50, 64))
    got = launched(fused_shuffle_tail, lambda: fused_shuffle_tail(xt, wt.to(BF16), bt.to(BF16)))
    torch.cuda.synchronize()
    check_close("shuffle_tail (1, 37, 50, 64), bf16 weights", got,
                shuffle_tail_reference(xt, wt.to(BF16).float(), bt.to(BF16).float()), TOL)
    before = fused_mbconv_infer.launches, fused_shuffle_tail.launches
    for name, fn in (("mbconv", lambda: fused_mbconv_infer(x.to(BF16), **w)),
                     ("shuffle_tail", lambda: fused_shuffle_tail(xt.to(BF16), wt, bt))):
        try:
            fn()
        except ValueError as e:
            print("  refused on the card: %s with a bf16 x (%s)" % (name, str(e)[:60]), flush=True)
            continue
        fail("%s took a bf16 x on the card" % name)
    if (fused_mbconv_infer.launches, fused_shuffle_tail.launches) != before:
        fail("a refused serving-kernel call launched a kernel")


def f64_check(name, got, plain, ref64):
    """The kernel's and the plain (cuDNN f32) version's max abs error against
    a float64 run of the plain version; fails when the kernel's exceeds
    F64_RATIO times the plain version's."""
    kern, pl = (float((t.double() - ref64).abs().max()) for t in (got, plain))
    ok = kern <= F64_RATIO * pl
    print("  %s against float64: max_abs_err kernel %.3e, plain (cuDNN f32) %.3e "
          "(kernel at most %.1fx plain)  %s" % (name, kern, pl, F64_RATIO,
                                                "ok" if ok else "FAIL"), flush=True)
    if not ok:
        fail("%s is less accurate than the cuDNN float32 composition against float64 "
             "(%.3e > %.1f x %.3e)" % (name, kern, F64_RATIO, pl))
    return {"kernel": kern, "plain": pl}


def check_sums(name, got, ref, terms):
    """Column sums: |got - ref| <= SUM_RTOL * sum|terms|, per column."""
    err = float((got - ref).abs().max())
    bound = SUM_RTOL * terms.abs().sum(0)
    ok = bool(torch.isfinite(got).all()) and bool(((got - ref).abs() <= bound).all())
    print("  %-58s max_abs_err %.3e  (%.0e * sum|terms|)  %s"
          % (name, err, SUM_RTOL, "ok" if ok else "FAIL"), flush=True)
    if not ok:
        fail("%s disagrees with its reference (max abs err %.3e)" % (name, err))
    return err


def path_bn_shapes():
    """The training path's distinct BN shapes (the 1-subnet steps' subnets)."""
    space = SearchSpace()
    cfgs = [step_subnets(space, i, 1)[0] for i in range(TRAIN_STEPS)]
    return sorted({s for c in cfgs for s in bn_train_shapes(space, c, BS, HR)})


def offset(t, k):
    """A copy of `t` whose data starts k elements past an allocation (k > 0:
    rows off a 16-byte boundary, so the kernels take narrower loads)."""
    if k == 0:
        return t
    return torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)[k:].view(t.shape).copy_(t)


def bn_parity(g, dtype=torch.float32):
    """The four BN wrappers against their plain versions at the training
    path's shapes and ragged ones, on `dtype` activations (float32, or bf16
    for the bf16 forms, the plain versions reading the same bf16 tensors);
    returns {kernel: max abs err at the path's shapes} (of the moments for
    col_sums2, and of dx for the backward, as the path uses them)."""
    bf16 = dtype is BF16
    tag = " bf16" if bf16 else ""
    key = "_bf16" if bf16 else ""
    errs = {"col_sums2" + key: 0.0, "bn_bwd_sums" + key: 0.0}
    cases = [(s, True, 0) for s in path_bn_shapes()]
    cases += [((n, 1, 1, c), False, 0) for n in (1000, 37) for c in (3, 17, 48)]
    if bf16:
        # C 6: 4-byte loads of 2 columns; C 24: 16-byte loads of 8 at a small
        # C; rows 2 and 4 bytes past a 16-byte boundary at C 64: loads of 1
        # and of 2 columns
        cases += [((1000, 1, 1, 6), False, 0), ((37, 1, 1, 24), False, 0),
                  ((300, 1, 1, 64), False, 1), ((300, 1, 1, 64), False, 2)]
    dx_tol = BF16_DX_TOL if bf16 else TOL
    for shape, on_path, k in cases:
        n, c = int(np.prod(shape[:3])), shape[3]
        a = offset(randn(g, n, c).to(dtype), k)
        b = offset((randn(g, n, c, scale=0.5) + 0.25).to(dtype), k)
        got = launched(col_sums2, lambda: col_sums2(a, b), bf16)
        torch.cuda.synchronize()
        af, bf = a.float(), b.float()
        for i, (u, v, terms) in enumerate(zip(got, col_sums2_reference(a, b), (af, af * bf))):
            check_sums("col_sums2%s s%d %s" % (tag, i + 1, (n, c)), u, v, terms)
        x = offset((1.5 * randn(g, *shape) + 0.3).to(dtype).contiguous(), k)
        got = launched(bn_moments, lambda: bn_moments(x), bf16)
        torch.cuda.synchronize()
        for i, (u, v) in enumerate(zip(got, bn_moments_reference(x))):
            err = check_close("bn_moments%s %s %s" % (tag, ("mean", "var")[i], shape), u, v,
                              MOMENT_TOL)
            if on_path:
                errs["col_sums2" + key] = max(errs["col_sums2" + key], err)
        dy, xf = offset(randn(g, n, c).to(dtype), k), x.view(n, c)
        mean, var = bn_moments_reference(x)
        inv = torch.rsqrt(var + 1e-5)
        got = launched(bn_bwd_sums, lambda: bn_bwd_sums(dy, xf, mean, inv), bf16)
        torch.cuda.synchronize()
        dyf, xhat = dy.float(), (xf.float() - mean) * inv
        for i, (u, v, terms) in enumerate(zip(got, bn_bwd_sums_reference(dy, xf, mean, inv),
                                              (dyf, dyf * xhat))):
            check_sums("bn_bwd_sums%s s%d %s" % (tag, i + 1, (n, c)), u, v, terms)
        # the fused backward, as bn_train_fused calls it (NHWC dy and x)
        scale = (0.5 + torch.rand(c, generator=g)).to(DEVICE)
        dy4 = dy.view(shape)
        dx, ds, db = launched(bn_backward, lambda: bn_backward(dy4, x, scale, mean, inv), bf16)
        torch.cuda.synchronize()
        if dx.dtype is not dtype or ds.dtype is not torch.float32:
            fail("bn_backward%s returned dx %s, dscale %s" % (tag, dx.dtype, ds.dtype))
        dx_p, ds_p, db_p = bn_backward_reference(dy4, x, scale, mean, inv)
        err = check_close("bn_backward%s dx %s" % (tag, shape), dx.float(), dx_p.float(), dx_tol)
        check_sums("bn_backward%s dscale %s" % (tag, (n, c)), ds, ds_p, dyf * xhat)
        check_sums("bn_backward%s dbias %s" % (tag, (n, c)), db, db_p, dyf)
        if on_path:
            errs["bn_bwd_sums" + key] = max(errs["bn_bwd_sums" + key], err)
    return errs


def bn_dtype_rule():
    """The BN wrappers refuse, on the card, activations the kernels do not
    take (float16; a bf16 dy with a float32 x), launching nothing."""
    x16 = torch.zeros(64, 8, device=DEVICE, dtype=torch.float16)
    xb, xf = torch.zeros(64, 8, device=DEVICE, dtype=BF16), torch.zeros(64, 8, device=DEVICE)
    v = torch.ones(8, device=DEVICE)
    before = [(k.launches, k.launches_bf16) for k in BN_KERNELS]
    for name, fn in (("float16 moments", lambda: bn_moments(x16.view(1, 8, 8, 8))),
                     ("float16 backward", lambda: bn_backward(x16, x16, v, v, v)),
                     ("bf16 dy, float32 x", lambda: bn_backward(xb, xf, v, v, v)),
                     ("float32 a, bf16 b", lambda: col_sums2(xf, xb))):
        try:
            fn()
        except ValueError as e:
            print("  refused on the card: %-24s (%s)" % (name, str(e)[:70]), flush=True)
            continue
        fail("the BN wrappers took %s on the card" % name)
    if [(k.launches, k.launches_bf16) for k in BN_KERNELS] != before:
        fail("a refused BN call launched a kernel")


def bn_grad_check(g, dtype=torch.float32):
    """Train-mode BN through the kernels (bn_train_fused) against the plain
    autograd branch on the card: y, dx, dscale, dbias, running stats; on
    bf16 x with float32 scale and bias for the bf16 forms (y and dx within
    one bf16 ulp)."""
    bf16 = dtype is BF16
    shapes = [(BS, 48, 48, 64), (BS, 48, 48, 384), (BS, HR, HR, 3), (BS, 24, 24, 256),
              (2, 5, 7, 17)]
    if bf16:
        shapes = [(BS, 48, 48, 64), (BS, HR, HR, 3), (2, 5, 7, 17)]
    tol = BF16_DX_TOL if bf16 else TOL
    for shape in shapes:
        c = shape[-1]
        x0 = (1.5 * randn(g, *shape) + 0.3).to(dtype)
        w = randn(g, *shape).to(dtype)
        scale0, bias0 = 0.5 + torch.rand(c, generator=g), 0.2 * torch.randn(c, generator=g)
        rm0, rv0 = 0.2 * torch.randn(c, generator=g), 0.5 + torch.rand(c, generator=g)
        out = {}
        for uk in (True, False):
            x = x0.clone().requires_grad_()
            scale, bias = (t.to(x0.device).requires_grad_() for t in (scale0, bias0))
            rm, rv = rm0.to(x0.device), rv0.to(x0.device)
            before = bn_backward.launches, bn_backward.launches_bf16
            y = batch_norm_train(x, scale, bias, rm, rv, use_kernels=uk)
            y.backward(w)
            if uk and x.is_cuda and (bn_backward.launches, bn_backward.launches_bf16) != (
                    before[0] + 1, before[1] + bf16):
                fail("bn_train_fused's backward did not launch bn_backward")
            out[uk] = (y.detach(), x.grad, scale.grad, bias.grad, rm, rv)
        torch.cuda.synchronize()
        (y, dx, ds, db, rm, rv), (y_p, dx_p, ds_p, db_p, rm_p, rv_p) = out[True], out[False]
        if y.dtype is not dtype or dx.dtype is not dtype or ds.dtype is not torch.float32:
            fail("bn_train_fused returned y %s, dx %s, dscale %s" % (y.dtype, dx.dtype, ds.dtype))
        name = "bn_train_fused%s %s" % (" bf16" if bf16 else "", shape)
        check_close(name + " y", y.float(), y_p.float(), tol)
        check_close(name + " dx", dx.float(), dx_p.float(), tol)
        xf, wf = x0.float(), w.float()
        xhat = ((xf - xf.mean((0, 1, 2))) * torch.rsqrt(xf.var((0, 1, 2), correction=0) + 1e-5))
        check_sums(name + " dscale", ds, ds_p, (wf * xhat).reshape(-1, c))
        check_sums(name + " dbias", db, db_p, wf.reshape(-1, c))
        check_close(name + " running_mean", rm, rm_p, MOMENT_TOL)
        check_close(name + " running_var", rv, rv_p, MOMENT_TOL)


# -- phase 3: serving --------------------------------------------------------

def randomize_bn(net, g):
    """Random BN affine parameters and running statistics, so the BN fold
    is exercised (fresh BN would fold to the identity)."""
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                n = mod.num_features
                dev = mod.weight.device
                mod.weight.copy_((0.5 + torch.rand(n, generator=g)).to(dev))
                mod.bias.copy_((0.2 * torch.randn(n, generator=g)).to(dev))
                mod.running_mean.copy_((0.2 * torch.randn(n, generator=g)).to(dev))
                mod.running_var.copy_((0.5 + torch.rand(n, generator=g)).to(dev))


def build_net(device, seed=0):
    net = OFAMobileNetS4(SearchSpace(), device=device,
                         generator=torch.Generator().manual_seed(seed))
    randomize_bn(net, torch.Generator().manual_seed(seed + 1))
    return net


def serving(net, net_cpu, cfg):
    rng = np.random.RandomState(0)
    frames = [rng.rand(1, *LR_HW, 3).astype(np.float32) for _ in range(N_FRAMES)]
    sub_k = get_active_subnet(net, cfg, use_kernels=True)
    sub_p = get_active_subnet(net, cfg, use_kernels=False, fold_tail=False)
    sub_f = get_active_subnet(net, cfg, use_kernels=False)
    assert sub_k.use_kernels and not sub_k.fold_tail and sub_f.fold_tail
    torch.cuda.synchronize()

    # the main path, counted: every kernel launch in this window is serving's
    fused_mbconv_infer.launches = 0
    fused_shuffle_tail.launches = 0
    out = serve(frames, net=net, cfg=cfg, device=net.device)
    torch.cuda.synchronize()
    counts = {"mbconv": fused_mbconv_infer.launches,
              "shuffle_tail": fused_shuffle_tail.launches}

    n_mb = sum(cfg.d)
    expect = {"mbconv": n_mb * N_FRAMES, "shuffle_tail": cfg.pixel_d * N_FRAMES}
    print("  launches during serve(%d frames): %s (expected %s)"
          % (N_FRAMES, counts, expect), flush=True)
    if counts != expect:
        fail("the serving path did not go through the kernels as expected")

    hr = (1, LR_HW[0] * 2 ** cfg.pixel_d, LR_HW[1] * 2 ** cfg.pixel_d, 3)
    with torch.inference_mode():
        for i, (f, y) in enumerate(zip(frames, out)):
            if tuple(y.shape) != hr:
                fail("frame %d has shape %s, expected %s" % (i, tuple(y.shape), hr))
            x = torch.from_numpy(f).to(net.device)
            if i in (0, N_FRAMES - 1):
                check_close("frame %d: kernels vs plain path on the card" % i, y, sub_p(x), FRAME_TOL)
                check_close("frame %d: kernels vs fold_tail plain path" % i, y, sub_f(x), FRAME_TOL)

        # a small frame through the same subnet on the CPU (the port's CPU
        # path is held to the JAX package by the tests)
        small = torch.from_numpy(rng.rand(1, 24, 40, 3).astype(np.float32))
        sub_cpu = get_active_subnet(net_cpu, cfg, use_kernels=False, fold_tail=False)
        check_close("24x40 frame: card kernels vs CPU", sub_k(small.to(net.device)).cpu(),
                    sub_cpu(small), FRAME_TOL)

        xs = [torch.from_numpy(f).to(net.device) for f in frames]
        times = {}
        for name, sub in (("kernels", sub_k), ("plain", sub_p), ("plain_fold_tail", sub_f)):
            times[name] = time_ms(lambda: [sub(x) for x in xs], iters=3, warmup=1) / N_FRAMES
    print("  frame ms (CUDA events, mean of %d frames x 3): %s"
          % (N_FRAMES, {k: round(v, 4) for k, v in times.items()}), flush=True)
    # profiled at the end of the run (see main)
    profiles = [("kernels", lambda: [sub_k(x) for x in xs], N_FRAMES, times["kernels"]),
                ("plain_fold_tail", lambda: [sub_f(x) for x in xs], N_FRAMES,
                 times["plain_fold_tail"])]
    return counts, times, profiles


def device_profile(name, run, n, unit_ms, unit):
    """Device time per `unit` (frame, step) by kernel from torch.profiler over
    run() (n units), and the device's idle share of the time per unit
    measured with CUDA events (`unit_ms`; None: not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.inference_mode(unit == "frame"), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # ranges such as "Optimizer.step#Adam.step" show on the device timeline
    # around the kernels they hold; count only the kernels
    ranges = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key in ranges:
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append({"kernel": e.key[:90], "calls_per_%s" % unit: e.count / n,
                         "ms_per_%s" % unit: us / 1e3 / n})
    key = "ms_per_%s" % unit
    rows.sort(key=lambda r: -r[key])
    busy = sum(r[key] for r in rows)
    if not rows:
        print("  %s: device time not measured (the profiler recorded no CUDA kernel)"
              % name, flush=True)
        return {"path": name, "busy_ms_per_%s" % unit: None, "idle_share": None, "top": [],
                "kernels_per_%s" % unit: None, "port_kernels": []}
    n_kernels = sum(r["calls_per_%s" % unit] for r in rows)
    idle = None if unit_ms is None else 1 - busy / unit_ms
    print("  %s: device busy %.4f of %s ms per %s (idle share %s), %.1f device kernels per %s"
          % (name, busy, "%.4f" % unit_ms if unit_ms else "(not measured)", unit,
             "%.3f" % idle if unit_ms else "not measured", n_kernels, unit), flush=True)
    ours = [r for r in rows if any(k in r["kernel"] for k in PORT_KERNELS)]
    for r in rows[:10] + [r for r in ours if r not in rows[:10]]:
        print("    %8.4f ms  x%-5.1f %s" % (r[key], r["calls_per_%s" % unit], r["kernel"]),
              flush=True)
    return {"path": name, "busy_ms_per_%s" % unit: busy, "idle_share": idle,
            "kernels_per_%s" % unit: n_kernels, "top": rows[:10], "port_kernels": ours}


# -- phase 4: training -------------------------------------------------------

def bn_launches_expected(cfgs):
    """Launches of each BN-statistics wrapper for a step over `cfgs`: one per
    train-mode BN, 3*sum(d) + pixel_d + 4 a subnet."""
    return sum(3 * sum(c.d) + c.pixel_d + 4 for c in cfgs)


def counted_train(steps, **kw):
    """entry.train with the BN-statistics counters read around it: the main
    path's run. Returns (metrics, {kernel: launches, kernel_bf16: its bf16
    launches})."""
    for k in BN_KERNELS:
        k.launches = k.launches_bf16 = 0
    bn_train_fused.layout_copies = 0
    metrics = train(steps, device=DEVICE, **kw)
    torch.cuda.synchronize()
    counts = {k.__name__: k.launches for k in BN_KERNELS}
    counts.update({k.__name__ + "_bf16": k.launches_bf16 for k in BN_KERNELS})
    counts["layout_copies"] = bn_train_fused.layout_copies
    return metrics, counts


def training_main_path(compute_dtype=None):
    """The two training envelopes through entry.train, counted: float32, or
    bf16 mixed precision, where every BN launch is a bf16 one."""
    space = SearchSpace()
    runs = {}
    bf16 = compute_dtype is BF16
    for label, steps, kw in (("1 subnet", TRAIN_STEPS, {}),
                             ("4 subnets + KD", KD_STEPS, dict(n_subnets=4, kd_ratio=1.0))):
        cfgs = [c for i in range(steps) for c in step_subnets(space, i, kw.get("n_subnets", 1))]
        metrics, counts = counted_train(steps, compute_dtype=compute_dtype, **kw)
        expect = bn_launches_expected(cfgs)
        print("  entry.train(%d steps, %s%s): BN-kernel launches %s (expected %d each), "
              "pixel_d %s, losses %s" % (steps, label, ", bf16" if bf16 else "", counts, expect,
                                         sorted({c.pixel_d for c in cfgs}),
                                         [round(m["loss"], 5) for m in metrics]), flush=True)
        if any(counts[k.__name__] != expect for k in BN_KERNELS):
            fail("the training path did not launch each BN kernel once per train-mode BN")
        if any(counts[k.__name__ + "_bf16"] != (expect if bf16 else 0) for k in BN_KERNELS):
            fail("the %s training path launched BN kernels of the other type"
                 % ("bf16" if bf16 else "float32"))
        if not all(np.isfinite(m["loss"]) and np.isfinite(m["psnr"]) for m in metrics):
            fail("non-finite training metrics: %s" % metrics)
        runs[label] = {"steps": steps, "launches": counts, "expected": expect,
                       "metrics": metrics}
    if {c.pixel_d for i in range(TRAIN_STEPS) for c in step_subnets(space, i, 1)} != {1, 2}:
        fail("the one-subnet steps did not sample both pixel_d")
    if bf16:
        # the bf16 step on the plain path, from the same seed-0 weights and batch
        plain = train(TRAIN_STEPS, device=DEVICE, compute_dtype=BF16, use_kernels=False)
        kern = runs["1 subnet"]["metrics"]
        check_close("bf16: %d one-subnet steps, losses: kernel path vs plain path" % TRAIN_STEPS,
                    torch.tensor([m["loss"] for m in kern]),
                    torch.tensor([m["loss"] for m in plain]), BF16_STEP_TOL)
        runs["1 subnet"]["plain_metrics"] = plain
        if runs["1 subnet"]["launches"]["layout_copies"]:
            print("  finding: the bf16 path copied %d BN inputs to row-contiguous layout"
                  % runs["1 subnet"]["launches"]["layout_copies"], flush=True)
    return runs


def train_net(device, seed=0):
    return OFAMobileNetS4(SearchSpace(), device=device,
                          generator=torch.Generator().manual_seed(seed))


def sgd_steps(device, use_kernels, batch, cfg_lists, lr=0.01):
    """SGD steps from seed-0 weights; (losses, params after the first)."""
    net = train_net(device)
    tr = SRTrainer(net, opt_type="sgd", weight_decay=3e-5, use_kernels=use_kernels)
    losses, first = [], None
    for cfgs in cfg_lists:
        losses.append(tr.train_step(batch, cfgs, lr)["loss"])
        if first is None:
            first = {n: p.detach().clone() for n, p in net.named_parameters()}
    return torch.stack(losses), first


def training_checks():
    """Kernel path vs plain path on the card; a small step card vs CPU."""
    space = SearchSpace()
    cfgs = [step_subnets(space, i, 1)[0] for i in (0, 6)]  # pixel_d 1 and 2
    batch = synthetic_batch(BS, HR, DEVICE)
    lk, pk = sgd_steps(DEVICE, True, batch, [[cfgs[0]], [cfgs[1]], [cfgs[0]]])
    lp, pp = sgd_steps(DEVICE, False, batch, [[cfgs[0]], [cfgs[1]], [cfgs[0]]])
    check_close("3 SGD steps, losses: kernel path vs plain path", lk, lp, STEP_TOL)
    err = max(float((pk[n] - pp[n]).abs().max()) for n in pk)
    for n in pk:
        if not bool(torch.isclose(pk[n], pp[n], **STEP_TOL).all()):
            check_close("params after one SGD step: " + n, pk[n], pp[n], STEP_TOL)
    print("  params after one SGD step, kernel path vs plain path: max_abs_err %.3e  ok"
          % err, flush=True)
    small = synthetic_batch(2, 32, "cpu", seed=1)
    lc, pc = sgd_steps(DEVICE, None, {k: v.to(DEVICE) for k, v in small.items()}, [cfgs])
    lh, ph = sgd_steps("cpu", None, small, [cfgs])
    check_close("2-subnet step at bs2 32x32: loss, card kernels vs CPU", lc.cpu(), lh,
                DEVICE_STEP_TOL)
    err = max(float((pc[n].cpu() - ph[n]).abs().max()) for n in pc)
    for n in pc:
        if not bool(torch.isclose(pc[n].cpu(), ph[n], **DEVICE_STEP_TOL).all()):
            check_close("params, card vs CPU: " + n, pc[n].cpu(), ph[n], DEVICE_STEP_TOL)
    print("  params after that step, card vs CPU: max_abs_err %.3e  ok" % err, flush=True)


def timed_steps(run, n_steps):
    """(ms per step on the device timeline from CUDA events, ms per step the
    host spent enqueueing) of one run(); equal when the host is the limit."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return start.elapsed_time(end) / n_steps, host_ms / n_steps


# the timed training paths: (use_kernels, compute_dtype), timed in the order
# of STEP_ORDER and back, STEP_ROUNDS times
STEP_PATHS = {"kernels": (True, None), "plain": (False, None),
              "bf16 kernels": (True, BF16), "bf16 plain": (False, BF16)}
STEP_ORDER = ("plain", "kernels", "bf16 kernels", "bf16 plain")


def step_times():
    """ms per step of the float32 and bf16 kernel and plain paths for both
    envelopes, in STEP_ROUNDS rounds of STEP_ORDER and back; and the runs of
    the one-subnet steps on the float32 paths and the bf16 kernel path, to
    profile at the end."""
    space = SearchSpace()
    batch = synthetic_batch(BS, HR, DEVICE)
    envelopes = {"1 subnet": ([step_subnets(space, i, 1) for i in range(TRAIN_STEPS)], {}),
                 "4 subnets + KD": ([step_subnets(space, i, 4) for i in range(KD_STEPS)],
                                    dict(kd_ratio=1.0))}
    teacher = kd_teacher(space, DEVICE)
    out, profiles = {}, []
    for env, (steps, kw) in envelopes.items():
        trainers = {name: SRTrainer(train_net(DEVICE), use_kernels=uk, compute_dtype=cd,
                                    teacher=teacher if kw else None, **kw)
                    for name, (uk, cd) in STEP_PATHS.items()}

        def run(name, trainers=trainers, steps=steps):  # bound now: profiled later
            for cfgs in steps:
                trainers[name].train_step(batch, cfgs, 1e-4)

        for name in STEP_PATHS:
            run(name)  # warm: cuDNN's algorithm choice, the allocator
        times = {name: [] for name in STEP_PATHS}
        for name in (STEP_ORDER + STEP_ORDER[::-1]) * STEP_ROUNDS:
            times[name].append(timed_steps(lambda: run(name), len(steps)))
        out[env] = {}
        for name in STEP_PATHS:
            ev, host = zip(*times[name])
            out[env][name] = {"ms": list(ev), "host_enqueue_ms": list(host),
                              "median_ms": float(np.median(ev)),
                              "median_host_enqueue_ms": float(np.median(host))}
            print("  %s, %s: ms per step (CUDA events) %s, median %.4f; host enqueue %s"
                  % (env, name, [round(t, 3) for t in ev], np.median(ev),
                     [round(t, 3) for t in host]), flush=True)
        if env == "1 subnet":
            profiles += [("train %s" % name, functools.partial(run, name), len(steps),
                          out[env][name]["median_ms"])
                         for name in ("kernels", "plain", "bf16 kernels")]
    return out, profiles


# -- phase 5: the run-management path through the CLIs ----------------------

def teacher_space():
    """The teacher CLI's search space at its defaults (ks5/e3/d2/pixel_d 1)."""
    return SearchSpace(ks_list=[5], expand_list=[3], depth_list=[2], pixel_d_list=[1])


class EpochTimes:
    """Wraps SRRunManager.train_one_epoch while active, recording each
    epoch's index, (ms per step from CUDA events, host ms per step) and its
    wall seconds."""

    def __init__(self):
        self.epochs = []

    def __enter__(self):
        real = self.real = SRRunManager.train_one_epoch

        def timed_epoch(rm, epoch, *a, **k):
            n = len(rm.provider.train)
            box = []
            t0 = time.perf_counter()
            ms, host_ms = timed_steps(lambda: box.append(real(rm, epoch, *a, **k)), n)
            self.epochs.append({"epoch": epoch, "steps": n, "ms_per_step": ms,
                                "host_ms_per_step": host_ms,
                                "wall_s": time.perf_counter() - t0})
            return box[0]

        SRRunManager.train_one_epoch = timed_epoch
        return self

    def __exit__(self, *exc):
        SRRunManager.train_one_epoch = self.real


def counted_cli(main_fn, argv):
    """main_fn(argv + --device) with every kernel's counters set to 0 just
    before and read just after: a main path's run. Returns (its result,
    {counter: launches}, wall seconds)."""
    for k in BN_KERNELS:
        k.launches = k.launches_bf16 = 0
    fused_mbconv_infer.launches = fused_shuffle_tail.launches = 0
    t0 = time.perf_counter()
    out = main_fn(argv + ["--device", DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in BN_KERNELS}
    counts.update({k.__name__ + "_bf16": k.launches_bf16 for k in BN_KERNELS})
    counts.update(mbconv=fused_mbconv_infer.launches, shuffle_tail=fused_shuffle_tail.launches)
    return out, counts, wall


def check_bn_launches(label, counts, n_steps, bf16):
    cfg = uniform_subnet(teacher_space(), 5, 3, 2, 1)
    expect = n_steps * bn_launches_expected([cfg])
    print("  %s: BN-kernel launches %s (expected %d each%s)"
          % (label, counts, expect, ", all bf16" if bf16 else ""), flush=True)
    if any(counts[k.__name__] != expect for k in BN_KERNELS):
        fail("%s did not launch each BN kernel once per train-mode BN" % label)
    if any(counts[k.__name__ + "_bf16"] != (expect if bf16 else 0) for k in BN_KERNELS):
        fail("%s launched BN kernels of the other type" % label)
    if counts["mbconv"] or counts["shuffle_tail"]:
        fail("%s launched a serving kernel" % label)
    return expect


def teacher_runs(tmp):
    """The teacher CLI: 2 epochs; 3 epochs resumed from the first run's
    checkpoint; 1 epoch in bf16. Returns the record and the checkpoint dir."""
    run_dir = os.path.join(tmp, "teacher")
    base = ["--synthetic", "--bn_mode", "train", "--warmup_epochs", "0"]
    out = {}
    with EpochTimes() as et:
        best, counts, wall = counted_cli(train_teacher_net_sr_simple.main,
                                         base + ["--path", run_dir, "--n_epochs", "2"])
        check_bn_launches("teacher, 2 epochs", counts, 2 * TEACHER_EPOCH_STEPS, False)
        for f in ("checkpoint/latest.txt", "checkpoint/checkpoint.pth.tar",
                  "checkpoint/model_best.pth.tar", "logs/train_console.txt",
                  "logs/valid_console.txt", "net_info.txt", "run.config"):
            if not os.path.isfile(os.path.join(run_dir, f)):
                fail("the teacher run wrote no %s" % f)
        if not np.isfinite(best):
            fail("the teacher run's best PSNR is %s" % best)
        out["f32"] = {"best_psnr": best, "launches": counts, "wall_s": wall,
                      "epochs": list(et.epochs)}
        n0 = len(et.epochs)
        _, counts, wall = counted_cli(train_teacher_net_sr_simple.main,
                                      base + ["--path", run_dir, "--n_epochs", "3"])
        resumed = [e["epoch"] for e in et.epochs[n0:]]
        with open(os.path.join(run_dir, "logs", "valid_console.txt")) as f:
            log = f.read()
        print("  teacher, 3 epochs: resumed epochs %s" % resumed, flush=True)
        if resumed != [2] or "=> loaded checkpoint (epoch 2)" not in log:
            fail("the teacher run did not resume at epoch 2 (ran epochs %s)" % resumed)
        check_bn_launches("teacher, resumed", counts, TEACHER_EPOCH_STEPS, False)
        out["f32_resumed"] = {"launches": counts, "wall_s": wall, "epochs": et.epochs[n0:]}
        n0 = len(et.epochs)
        best, counts, wall = counted_cli(
            train_teacher_net_sr_simple.main,
            base + ["--path", os.path.join(tmp, "teacher_bf16"), "--n_epochs", "1",
                    "--compute_dtype", "bf16"])
        check_bn_launches("teacher, bf16, 1 epoch", counts, TEACHER_EPOCH_STEPS, True)
        if not np.isfinite(best):
            fail("the bf16 teacher run's best PSNR is %s" % best)
        out["bf16"] = {"best_psnr": best, "launches": counts, "wall_s": wall,
                       "epochs": et.epochs[n0:]}
    return out, os.path.join(run_dir, "checkpoint")


def eval_run(tmp, ckpt_dir):
    """The SR evaluator with --materialize from the teacher's checkpoint,
    counted; then the same subnet from the same checkpoint on the plain
    path, scored on the same frames."""
    frame_log = os.path.join(tmp, "frames.jsonl")
    argv = ["--path", os.path.join(tmp, "eval"), "--synthetic", "--dataset", "div2k",
            "--materialize", "--checkpoint", ckpt_dir, "--image_size", str(EVAL_HR),
            "--frame_log", frame_log]
    psnr, counts, wall = counted_cli(eval_ofa_net_sr.main, argv)
    cfg = uniform_subnet(SearchSpace(), 7, 6, 2, 2)
    expect = {"mbconv": sum(cfg.d) * EVAL_FRAMES, "shuffle_tail": cfg.pixel_d * EVAL_FRAMES}
    got = {k: counts[k] for k in expect}
    print("  eval_ofa_net_sr --materialize, %d frames of %dx%d HR: launches %s (expected %s), "
          "mean PSNR-Y %.6f" % (EVAL_FRAMES, EVAL_HR, EVAL_HR, got, expect, psnr), flush=True)
    if got != expect or any(counts[k.__name__] for k in BN_KERNELS):
        fail("the evaluator did not go through the serving kernels as expected")
    with open(frame_log) as f:
        frames = [json.loads(line) for line in f]
    if len(frames) != EVAL_FRAMES or not all(np.isfinite(r["psnr"]) for r in frames):
        fail("the evaluator's frame log: %s" % frames)

    args = eval_ofa_net_sr.build_args(argv + ["--device", DEVICE])
    net = make_net(OFAMobileNetS4, SearchSpace(), args)
    load_weights_lenient(ckpt_dir, net)
    sub = get_active_subnet(net, cfg, use_kernels=False)
    psnrs = []
    with torch.inference_mode():
        for batch in make_sr_provider(args, None).test:
            x = torch.from_numpy(batch["x4"]).to(net.device)
            out = sub(x)
            if tuple(out.shape) != (1, EVAL_HR, EVAL_HR, 3) or not bool(torch.isfinite(out).all()):
                fail("plain-path frame: shape %s" % (tuple(out.shape),))
            psnrs.append(float(psnr_y_device(out, torch.from_numpy(batch["image"]).to(net.device))))
    plain = float(np.mean(psnrs))
    diff = abs(plain - psnr)
    print("  the same subnet on the plain path: mean PSNR-Y %.6f (|diff| %.2e dB, at most %.0e)"
          % (plain, diff, PSNR_TOL_DB), flush=True)
    if not diff <= PSNR_TOL_DB:
        fail("the evaluator's kernel path and plain path differ by %.3e dB" % diff)
    ms = [1e3 * r["sec"] for r in frames]
    return {"launches": counts, "expected": expect, "mean_psnr": psnr, "plain_mean_psnr": plain,
            "frame_ms": ms, "frame_ms_after_first_median": float(np.median(ms[1:])),
            "wall_s": wall}


def run_manager_times(tmp):
    """ms per step of the run manager (CUDA events around train_one_epoch,
    4 steps of the synthetic provider) against entry.train's on the same
    teacher net and batch shape, and of the epoch's data path alone, in
    RM_ROUNDS rounds of alternating order."""
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    net = OFAMobileNetS4(teacher_space(), device=DEVICE, generator=gen())
    rm = SRRunManager(os.path.join(tmp, "timing"), net,
                      RunConfig(n_epochs=2 * RM_ROUNDS + 1, base_lr=1e-3),
                      SyntheticSRProvider(n_train=64, n_valid=4, hr_size=HR,
                                          train_batch_size=BS))
    net_e = OFAMobileNetS4(teacher_space(), device=DEVICE, generator=gen())
    rm.train_one_epoch(0)  # warm both
    train(TEACHER_EPOCH_STEPS, device=DEVICE, net=net_e)
    loader = rm.provider.train
    # the epoch's data path alone: the loader's batches (made on the host),
    # and those batches copied to the card as train_one_epoch copies them
    runs = {"run manager": None,
            "entry.train": functools.partial(train, TEACHER_EPOCH_STEPS, device=DEVICE,
                                             net=net_e),
            "loader": lambda: list(loader),
            "loader + copies": lambda: [rm._to_device(b) for b in loader]}
    times = {name: [] for name in runs}
    for r in range(RM_ROUNDS):
        for name in (runs if r % 2 == 0 else list(runs)[::-1]):
            run = runs[name] or functools.partial(rm.train_one_epoch, r + 1)
            times[name].append(timed_steps(run, TEACHER_EPOCH_STEPS))
    out = {}
    for name, ts in times.items():
        ev, host = zip(*ts)
        out[name] = {"ms": list(ev), "host_ms": list(host), "median_ms": float(np.median(ev)),
                     "median_host_ms": float(np.median(host))}
        print("  %s: ms per step (CUDA events) %s, median %.4f; host %s"
              % (name, [round(t, 3) for t in ev], np.median(ev), [round(t, 3) for t in host]),
              flush=True)
    return out


def cli_phase():
    with tempfile.TemporaryDirectory(prefix="ofa_sr_cli_") as tmp:
        teacher, ckpt_dir = teacher_runs(tmp)
        ev = eval_run(tmp, ckpt_dir)
        times = run_manager_times(tmp)
    return {"teacher": teacher, "eval": ev, "step_times": times}


# -- phase 6: per-kernel numbers at the path's shapes ------------------------

def steady_ms(fn, repeats=3):
    """Median of `repeats` time_ms runs (20 calls each): a call of the BN
    wrappers is mostly host time, and one slow stretch of the host would
    otherwise stand for the shape."""
    return float(np.median([time_ms(fn) for _ in range(repeats)]))


def measure_shape(kernel, plain, flops, nbytes_, launches, unit="frame", library=None,
                  peak=PEAK_F32_FLOPS, ops_ms=None, **info):
    """Kernel, plain and (where given) library ms per launch at one shape
    (median of 3 runs of 20 back-to-back calls),
    beside its bound (`flops` at `peak`, or `ops_ms` where the operations
    run on more than one pipe, or the bytes); `launches` per `unit` (frame
    or step)."""
    t = bound_ms(flops, nbytes_, peak)
    if ops_ms is not None:
        t = (ops_ms, t[1])
    return dict(info, **{"launches_per_" + unit: launches},
                ms_per_launch=steady_ms(kernel), plain_ms_per_launch=steady_ms(plain),
                library_ms_per_launch=steady_ms(library) if library else None,
                bound_ms_per_launch=max(t), flop=flops, bytes=nbytes_, _t=t)


def kernel_row(name, source, replaces, launches, err, shapes, unit="frame", **info):
    """One kernel's line: sums per `unit` over its launches at the path's
    shapes."""
    per = "launches_per_" + unit
    bound, by = bound_of([(s.pop("_t"), s[per]) for s in shapes])
    total = lambda key: sum(s[key] * s[per] for s in shapes)  # noqa: E731
    lib = all(s["library_ms_per_launch"] is not None for s in shapes)
    return dict({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches, per: sum(s[per] for s in shapes),
                 "max_abs_err": err, "ms": total("ms_per_launch"),
                 "plain_ms": total("plain_ms_per_launch"), "bound_ms": bound, "bound_by": by,
                 "library_ms": total("library_ms_per_launch") if lib else None,
                 "per": unit}, **info, per_shape=shapes)


def kernel_numbers(g, cfg, counts, errs):
    """Per serving kernel: time per frame of all its launches at the path's
    shapes (kernel, plain version), with the card's least time for the same
    work. No single PyTorch call computes either function: library_ms is
    null. Both kernels multiply on the tensor cores, 3 TF32 products a
    multiply-add; the bound takes those at the TF32 rate (and the MBConv's
    depthwise at the FP32 rate, the larger of the two), with the bound on
    the FP32 pipe alone beside it."""
    c, m, ks = 64, SearchSpace().mid_channels(6), 7
    x, w = mbconv_case(g, (1,) + LR_HW + (c,), m, ks)
    px = x.numel() // c
    f1x1, fdw = 2 * px * 2 * c * m, 2 * px * ks * ks * m
    mb = measure_shape(
        lambda: fused_mbconv_infer(x, **w), lambda: mbconv_reference(x, **w),
        flops=f1x1 + fdw, nbytes_=nbytes(x, *w.values()) + nbytes(x), launches=sum(cfg.d),
        ops_ms=max(3 * f1x1 / PEAK_TF32, fdw / PEAK_F32_FLOPS) * 1e3,
        shape=list(x.shape), mid=m, ks=ks, conv1x1_flop=f1x1, depthwise_flop=fdw,
        bound_f32_fma_ms=(f1x1 + fdw) / PEAK_F32_FLOPS * 1e3)
    tail = []
    for i in range(cfg.pixel_d):
        x, wt, b = shuffle_case(g, (1, LR_HW[0] * 2 ** i, LR_HW[1] * 2 ** i, c))
        flops = 2 * x.numel() * 25 * 4 * c
        tail.append(measure_shape(
            lambda: fused_shuffle_tail(x, wt, b), lambda: shuffle_tail_reference(x, wt, b),
            flops=3 * flops, nbytes_=nbytes(x, wt, b) + 4 * nbytes(x), launches=1,
            peak=PEAK_TF32, shape=list(x.shape), conv_flop=flops,
            bound_f32_fma_ms=flops / PEAK_F32_FLOPS * 1e3))
    n = mb["launches_per_frame"]
    return [kernel_row("fused_mbconv_infer", "ofa_sr_tpu_torch/csrc/mbconv.cu",
                       "ofa_sr_tpu/ops/pallas/mbconv.py:155", counts["mbconv"],
                       errs["mbconv"], [mb],
                       bound_rate="the larger of the 1x1 convs' 3 TF32 products a "
                       "multiply-add at %.0f TFLOP/s and the depthwise at %.0f TFLOP/s "
                       "(FP32)" % (PEAK_TF32 / 1e12, PEAK_F32_FLOPS / 1e12),
                       bound_f32_fma_ms=n * mb["bound_f32_fma_ms"],
                       max_abs_err_vs_f64=errs["mbconv_vs_f64"]),
            kernel_row("fused_shuffle_tail", "ofa_sr_tpu_torch/csrc/shuffle_tail.cu",
                       "ofa_sr_tpu/ops/pallas/shuffle_tail.py:121", counts["shuffle_tail"],
                       errs["shuffle_tail"], tail,
                       bound_rate="3xTF32: 3 TF32 products per multiply-add at %.0f TFLOP/s"
                       % (PEAK_TF32 / 1e12),
                       bound_f32_fma_ms=sum(s["bound_f32_fma_ms"] for s in tail),
                       max_abs_err_vs_f64=errs["shuffle_tail_vs_f64"])]


def bn_kernel_numbers(g, launches, errs, dtype=torch.float32):
    """Per BN kernel row: time per one-subnet training step of its launches
    at the path's shapes (the subnets of the counted one-subnet steps,
    launches averaged per step), against its plain version, the card's least
    time (bytes), and one PyTorch call computing the same function:
    torch.var_mean for the moments, and aten.native_batch_norm_backward with
    the full output mask (dx, dscale = sum dy*xhat, dbias = sum dy) on the
    channels-last NCHW view for the fused backward, checked here to return
    the plain version's results. The backward row times `bn_backward` as
    bn_train_fused calls it: the sums of the TPU kernel `bn_bwd_sums` and the
    dx that XLA fuses after it, hence its name. `dtype` bf16 gives the bf16
    forms' rows, on bf16 activations (float32 scale, mean and inv), with
    their bf16 launches."""
    bf16 = dtype is BF16
    space = SearchSpace()
    per_step = {}
    for i in range(TRAIN_STEPS):
        for shp in bn_train_shapes(space, step_subnets(space, i, 1)[0], BS, HR):
            per_step[shp] = per_step.get(shp, 0) + 1.0 / TRAIN_STEPS
    mom, bwd = [], []
    library_note = None
    for shp in sorted(per_step):
        n, c = int(np.prod(shp[:3])), shp[3]
        k = per_step[shp]
        x = (1.5 * randn(g, *shp) + 0.3).to(dtype).contiguous()
        mom.append(measure_shape(
            lambda: bn_moments(x), lambda: bn_moments_reference(x),
            flops=3 * n * c, nbytes_=nbytes(x) + 2 * c * 4, launches=k,
            unit="step", library=lambda: torch.var_mean(x, dim=(0, 1, 2), correction=0),
            shape=list(shp)))
        dy = randn(g, *shp).to(dtype)
        mean, var = bn_moments_reference(x)
        inv = torch.rsqrt(var + 1e-5)
        scale = (0.5 + torch.rand(c, generator=g)).to(DEVICE)
        dyf = dy.view(n, c).float()
        nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731  channels-last NCHW view

        def library():
            return torch.ops.aten.native_batch_norm_backward(
                nchw(dy), nchw(x), scale, None, None, mean, inv, True, 1e-5,
                [True, True, True])

        try:
            lib_dx, lib_ds, lib_db = library()
        except RuntimeError as e:  # a yardstick only: the port never calls it
            library_note = "native_batch_norm_backward refused %s input: %s" % (
                dtype, str(e).splitlines()[0][:160])
            print("  " + library_note, flush=True)
            library = None
        ref = bn_backward_reference(dy, x, scale, mean, inv)
        if library is not None:
            xhat = (x.view(n, c).float() - mean) * inv
            check_close("native_batch_norm_backward%s dx %s" % (" bf16" if bf16 else "", shp),
                        lib_dx.permute(0, 2, 3, 1).float(), ref[0].float(),
                        BF16_DX_TOL if bf16 else TOL)
            check_sums("native_batch_norm_backward dscale %s" % (shp,), lib_ds.float(), ref[1],
                       dyf * xhat)
            check_sums("native_batch_norm_backward dbias %s" % (shp,), lib_db.float(), ref[2],
                       dyf)
        bwd.append(measure_shape(
            lambda: bn_backward(dy, x, scale, mean, inv),
            lambda: bn_backward_reference(dy, x, scale, mean, inv),
            flops=11 * n * c, nbytes_=3 * nbytes(dy) + 5 * c * 4, launches=k,
            unit="step", library=library, shape=list(shp)))
    key = "_bf16" if bf16 else ""
    info = dict(unit="step", dtype=str(dtype).replace("torch.", ""))
    if library_note:
        info["library_note"] = library_note
    names = (BF16_ROWS["col_sums2"], BF16_ROWS[BWD_ROW]) if bf16 else ("col_sums2", BWD_ROW)
    return [kernel_row(names[0], "ofa_sr_tpu_torch/csrc/bn_stats.cu",
                       "ofa_sr_tpu/ops/pallas/bn_stats.py:94", launches["col_sums2" + key],
                       errs["col_sums2" + key], mom, wrapper="bn_moments", **info),
            kernel_row(names[1], "ofa_sr_tpu_torch/csrc/bn_stats.cu",
                       "ofa_sr_tpu/ops/pallas/bn_stats.py:196", launches["bn_backward" + key],
                       errs["bn_bwd_sums" + key], bwd, wrapper="bn_backward", **info)]


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script measures the port on a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print("phase 1: card:", smi_line, flush=True)
    print("  torch %s, CUDA %s, python %s" % (torch.__version__, torch.version.cuda,
                                             sys.version.split()[0]), flush=True)
    build_s = _build.build_all()
    print("  kernels built in %.1f s (%s)" % (build_s, _build.BUILD_DIR), flush=True)
    for name, log in sorted(_build.ptxas_log.items()):
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line or \
                    "smem" in line:
                print("  [%s] %s" % (name, line.strip()), flush=True)
    smem_query = _build.load("mbconv").ofa_mbconv_smem_bytes
    smem_query.argtypes, smem_query.restype = [ctypes.c_int] * 2, ctypes.c_int
    mb_smem = {ks: smem_query(64, ks) for ks in (3, 5, 7)}
    print("  [mbconv] dynamic shared memory a block at C 64, by k: %s bytes" % mb_smem,
          flush=True)

    g = torch.Generator().manual_seed(1234)
    print("phase 2: kernel parity on the card", flush=True)
    errs = kernel_parity(g)
    errs.update(bn_parity(g))
    bn_grad_check(g)
    print("phase 2: the BN kernels' bf16 forms", flush=True)
    errs.update(bn_parity(g, BF16))
    bn_grad_check(g, BF16)
    bn_dtype_rule()

    print("phase 3: serving %d frames of %dx%d LR" % ((N_FRAMES,) + LR_HW), flush=True)
    net = build_net(dev)
    net_cpu = build_net("cpu")
    cfg = uniform_subnet(net.space, 7, 6, 2, 2)
    counts, frame_ms, profiles = serving(net, net_cpu, cfg)

    print("phase 4: entry() supernet forward, bs16 48x48, pixel_d 1", flush=True)
    fn, args = entry(device=dev)
    y = fn(*args)
    torch.cuda.synchronize()
    if tuple(y.shape) != (16, 96, 96, 3):
        fail("entry output shape %s" % (tuple(y.shape),))
    fn_cpu, args_cpu = entry(device="cpu")
    check_close("entry forward: card vs CPU", y.cpu(), fn_cpu(*args_cpu), FRAME_TOL)
    entry_ms = time_ms(lambda: fn(*args), iters=5, warmup=1)
    print("  entry forward ms: %.4f" % entry_ms, flush=True)
    del fn, args, y
    print("phase 4: entry.train, bs%d %dx%d HR, full-width supernet" % (BS, HR, HR), flush=True)
    train_runs = training_main_path()
    print("phase 4: entry.train in bf16 mixed precision (compute_dtype=torch.bfloat16)",
          flush=True)
    train_runs_bf16 = training_main_path(BF16)
    bn_counts = {}
    for runs, key in ((train_runs, ""), (train_runs_bf16, "_bf16")):
        for k in BN_KERNELS:
            name = k.__name__ + key
            bn_counts[name] = sum(r["launches"][name] for r in runs.values())
    training_checks()
    step_ms, train_runs_to_profile = step_times()

    print("phase 5: the run-management path through the CLIs (teacher trainer, SR evaluator)",
          flush=True)
    cli = cli_phase()

    print("phase 6: per-kernel numbers", flush=True)
    bn_rows = bn_kernel_numbers(g, bn_counts, errs)
    bn_rows_bf16 = bn_kernel_numbers(g, bn_counts, errs, BF16)
    rows = kernel_numbers(g, cfg, counts, errs) + bn_rows + bn_rows_bf16
    # each row's launches in phase 5's counted CLI runs: the BN rows in the
    # teacher runs of their type, the serving rows in the evaluator's
    t = cli["teacher"]
    for r, n in zip(rows, (cli["eval"]["launches"]["mbconv"],
                           cli["eval"]["launches"]["shuffle_tail"],
                           t["f32"]["launches"]["col_sums2"]
                           + t["f32_resumed"]["launches"]["col_sums2"],
                           t["f32"]["launches"]["bn_backward"]
                           + t["f32_resumed"]["launches"]["bn_backward"],
                           t["bf16"]["launches"]["col_sums2_bf16"],
                           t["bf16"]["launches"]["bn_backward_bf16"])):
        r["launches_cli"] = n
    for r in rows:
        print("  %-20s %d launches (CLIs %d)  %.4f ms/%s  plain %.4f  bound %.4f (%s)  "
              "library %s" % (r["name"], r["launches"], r["launches_cli"], r["ms"], r["per"],
                              r["plain_ms"], r["bound_ms"], r["bound_by"], r["library_ms"]),
              flush=True)
    # last: a torch.profiler session leaves the launch path slower for the
    # rest of the process, so every timing above comes first, and the steps
    # are timed once more after the profiles to show by how much
    print("phase 6: device profiles", flush=True)
    profiles = [device_profile(*p, "frame") for p in profiles]
    train_profiles = [device_profile(*p, "step") for p in train_runs_to_profile]
    by_path = {p["path"]: p for p in train_profiles}
    # the kernels' own device time in the kernel path's step of their type
    for rows_, path in ((bn_rows, "train kernels"), (bn_rows_bf16, "train bf16 kernels")):
        for r, names in zip(rows_, BN_ROW_KERNELS.values()):
            r["device_ms"] = sum(k["ms_per_step"] for k in by_path[path]["port_kernels"]
                                 if any(n in k["kernel"] for n in names))
            print("  %s: %.4f ms per step on the device (bound %.4f)"
                  % (r["name"], r["device_ms"], r["bound_ms"]), flush=True)
    for prof, (name, run, n, _) in zip(train_profiles, train_runs_to_profile):
        after = timed_steps(run, n)
        prof["ms_after_profiling"], prof["host_enqueue_ms_after_profiling"] = after
        print("  %s after the profiles: %.4f ms per step (CUDA events), host enqueue %.4f"
              % ((name,) + after), flush=True)
    print(json.dumps({"kernels": rows, "frame_ms": frame_ms, "frame_profile": profiles,
                      "entry_ms": entry_ms, "train_runs": train_runs,
                      "train_runs_bf16": train_runs_bf16, "step_ms": step_ms,
                      "step_profile": train_profiles, "cli": cli, "build_s": build_s,
                      "mbconv_smem_bytes": mb_smem, "gpu": smi_line}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
