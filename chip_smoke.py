"""Drive the PyTorch/CUDA port (ofa_sr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure ends the run with a non-zero exit and no result line):
1. The card (nvidia-smi name and power limit), torch / CUDA versions, and
   the build of the hand-written kernels from csrc/ (nvcc, one per source,
   in parallel).
2. Kernel parity on the card: each kernel against its plain PyTorch version
   on the same inputs, at the serving path's shapes and a few odd ones.
3. Serving: a full-width OFAMobileNetS4 (seeded he_fout weights, random BN
   statistics) materialized as the ks7/e6/d2/pixel_d 2 subnet serves 8 LR
   180x320 frames (720p out) through `entry.serve`, with every kernel's
   launch count read around that run; the frames are held against the same
   subnet run on the plain (cuDNN) path on the card, and a small frame
   against the same subnet on the CPU. Frame times from CUDA events; device
   time by kernel and the idle share from torch.profiler.
4. The supernet eval forward of `entry.entry` (bs16, 48x48, pixel_d 1),
   held against the same forward on the CPU.
5. One JSON line of per-kernel numbers, the nvidia-smi line, and the result
   line {"ok": true, "device": {...}}.

Float32 throughout with TF32 off, so the card's numbers compare with the
CPU's. Exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ofa_sr_tpu_torch.entry import entry, serve  # noqa: E402
from ofa_sr_tpu_torch.models import OFAMobileNetS4, SearchSpace, get_active_subnet  # noqa: E402
from ofa_sr_tpu_torch.models.arch import uniform_subnet  # noqa: E402
from ofa_sr_tpu_torch.ops.kernels import _build  # noqa: E402
from ofa_sr_tpu_torch.ops.kernels.mbconv import fused_mbconv_infer, mbconv_reference  # noqa: E402
from ofa_sr_tpu_torch.ops.kernels.shuffle_tail import (  # noqa: E402
    fused_shuffle_tail,
    shuffle_tail_reference,
)

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth; the kernels use FP32 FMA only
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL = dict(rtol=1e-4, atol=1e-4)      # kernel vs plain, float32, other sum order
FRAME_TOL = dict(rtol=1e-3, atol=1e-3)  # whole frames: errors compound over ~14 layers
LR_HW = (180, 320)                    # 720p output at 4x
N_FRAMES = 8


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


def time_ms(fn, iters=20, warmup=3):
    """ms per call from CUDA events over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops, nbytes):
    """(ms of the operations at the f32 peak, ms of the bytes at the memory
    rate): the least time is the larger of the two."""
    return flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def bound_of(launches):
    """Least time of a list of (ops ms, bytes ms) launches, and what bounds
    the larger share of it."""
    total = sum(max(t) for t in launches)
    ops = sum(t[0] for t in launches if t[0] >= t[1])
    return total, "operations" if 2 * ops >= total else "bytes"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def randn(g, *shape, scale=1.0, device="cuda"):
    return (scale * torch.randn(*shape, generator=g)).to(device)


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


def launched(wrapper, fn):
    """fn()'s result; fails unless it launched `wrapper`'s kernel once."""
    before = wrapper.launches
    out = fn()
    if wrapper.launches != before + 1:
        fail("%s did not launch its kernel" % wrapper.__name__)
    return out


def kernel_parity(g):
    """Returns {kernel: max abs err over the path's shapes}."""
    errs = {"mbconv": 0.0, "shuffle_tail": 0.0}
    path = (1,) + LR_HW + (64,)
    for shape, m, ks, res in [(path, 384, 7, True), (path, 384, 5, True),
                              (path, 384, 3, True), ((1, 7, 13, 64), 192, 5, False),
                              ((2, 18, 20, 64), 256, 3, True), ((1, 181, 37, 16), 48, 7, True)]:
        x, w = mbconv_case(g, shape, m, ks)
        got = launched(fused_mbconv_infer,
                       lambda: fused_mbconv_infer(x, **w, residual=res))
        torch.cuda.synchronize()
        err = check_close("mbconv %s M=%d k=%d residual=%s" % (shape, m, ks, res),
                          got, mbconv_reference(x, **w, residual=res), TOL)
        if shape == path:
            errs["mbconv"] = max(errs["mbconv"], err)
    for shape in [path, (1, 2 * LR_HW[0], 2 * LR_HW[1], 64), (2, 7, 13, 64), (1, 9, 17, 8)]:
        x, w, b = shuffle_case(g, shape)
        got = launched(fused_shuffle_tail, lambda: fused_shuffle_tail(x, w, b))
        torch.cuda.synchronize()
        err = check_close("shuffle_tail %s" % (shape,), got, shuffle_tail_reference(x, w, b), TOL)
        if shape[0] == 1 and shape[-1] == 64 and shape[1] >= LR_HW[0]:
            errs["shuffle_tail"] = max(errs["shuffle_tail"], err)
    return errs


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
    profiles = [frame_profile("kernels", sub_k, xs, times["kernels"]),
                frame_profile("plain_fold_tail", sub_f, xs, times["plain_fold_tail"])]
    return counts, times, profiles


def frame_profile(name, sub, xs, frame_ms):
    """Device time per frame by kernel (torch.profiler), and the device's
    idle share of the frame time measured with CUDA events (`frame_ms`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for x in xs:
            sub(x)
        torch.cuda.synchronize()
    n = len(xs)
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append({"kernel": e.key[:90], "calls_per_frame": e.count / n,
                         "ms_per_frame": us / 1e3 / n})
    rows.sort(key=lambda r: -r["ms_per_frame"])
    busy = sum(r["ms_per_frame"] for r in rows)
    if not rows:
        print("  %s: device time not measured (the profiler recorded no CUDA kernel)"
              % name, flush=True)
        return {"path": name, "busy_ms_per_frame": None, "idle_share": None, "top": []}
    print("  %s: device busy %.4f of %.4f ms per frame (idle share %.3f)"
          % (name, busy, frame_ms, 1 - busy / frame_ms), flush=True)
    for r in rows[:10]:
        print("    %8.4f ms  x%-5.1f %s" % (r["ms_per_frame"], r["calls_per_frame"],
                                          r["kernel"]), flush=True)
    return {"path": name, "busy_ms_per_frame": busy, "idle_share": 1 - busy / frame_ms,
            "top": rows[:10]}


# -- phase 5: per-kernel numbers at the path's shapes ------------------------

def measure_shape(kernel, plain, flops, nbytes_, launches_per_frame, **info):
    """Kernel and plain ms per launch at one shape, beside its bound."""
    t = bound_ms(flops, nbytes_)
    return dict(info, launches_per_frame=launches_per_frame,
                ms_per_launch=time_ms(kernel), plain_ms_per_launch=time_ms(plain),
                bound_ms_per_launch=max(t), flop=flops, bytes=nbytes_, _t=t)


def kernel_row(name, source, replaces, launches, err, shapes):
    """One kernel's line: per-frame sums over its launches at the path's
    shapes."""
    times = [s.pop("_t") for s in shapes]
    bound, by = bound_of([t for t, s in zip(times, shapes)
                          for _ in range(s["launches_per_frame"])])
    frame = lambda key: sum(s[key] * s["launches_per_frame"] for s in shapes)  # noqa: E731
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "launches_per_frame": sum(s["launches_per_frame"] for s in shapes),
            "max_abs_err": err, "ms": frame("ms_per_launch"),
            "plain_ms": frame("plain_ms_per_launch"), "bound_ms": bound, "bound_by": by,
            "library_ms": None, "per_shape": shapes}


def kernel_numbers(g, cfg, counts, errs):
    """Per kernel: time per frame of all its launches at the path's shapes
    (kernel, plain version), with the card's least time for the same work.
    No single PyTorch call computes either function: library_ms is null."""
    c, m, ks = 64, SearchSpace().mid_channels(6), 7
    x, w = mbconv_case(g, (1,) + LR_HW + (c,), m, ks)
    mb = measure_shape(
        lambda: fused_mbconv_infer(x, **w), lambda: mbconv_reference(x, **w),
        flops=2 * (x.numel() // c) * (c * m + ks * ks * m + m * c),
        nbytes_=nbytes(x, *w.values()) + nbytes(x), launches_per_frame=sum(cfg.d),
        shape=list(x.shape), mid=m, ks=ks)
    tail = []
    for i in range(cfg.pixel_d):
        x, wt, b = shuffle_case(g, (1, LR_HW[0] * 2 ** i, LR_HW[1] * 2 ** i, c))
        tail.append(measure_shape(
            lambda: fused_shuffle_tail(x, wt, b), lambda: shuffle_tail_reference(x, wt, b),
            flops=2 * x.numel() * 25 * 4 * c, nbytes_=nbytes(x, wt, b) + 4 * nbytes(x),
            launches_per_frame=1, shape=list(x.shape)))
    return [kernel_row("fused_mbconv_infer", "ofa_sr_tpu_torch/csrc/mbconv.cu",
                       "ofa_sr_tpu/ops/pallas/mbconv.py:155", counts["mbconv"],
                       errs["mbconv"], [mb]),
            kernel_row("fused_shuffle_tail", "ofa_sr_tpu_torch/csrc/shuffle_tail.cu",
                       "ofa_sr_tpu/ops/pallas/shuffle_tail.py:121", counts["shuffle_tail"],
                       errs["shuffle_tail"], tail)]


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
            if "registers" in line or "spill" in line or "smem" in line:
                print("  [%s] %s" % (name, line.strip()), flush=True)

    g = torch.Generator().manual_seed(1234)
    print("phase 2: kernel parity on the card", flush=True)
    errs = kernel_parity(g)

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

    print("phase 5: per-kernel numbers", flush=True)
    rows = kernel_numbers(g, cfg, counts, errs)
    for r in rows:
        print("  %-20s %d launches  %.4f ms/frame  plain %.4f  bound %.4f (%s)"
              % (r["name"], r["launches"], r["ms"], r["plain_ms"], r["bound_ms"],
                 r["bound_by"]), flush=True)
    print(json.dumps({"kernels": rows, "frame_ms": frame_ms, "frame_profile": profiles,
                      "entry_ms": entry_ms, "build_s": build_s, "gpu": smi_line}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
