"""Time the train-mode BN path of a tree of the PyTorch/CUDA port on one
NVIDIA GPU, to compare two trees (a commit and its parent) in one run.

    python3 bn_path_times.py ROOT            # one tree, in this process
    python3 bn_path_times.py ROOT_A ROOT_B   # A, B, B, A, one process each

ROOT is a checkout of the repo (for a parent commit:
`git archive <commit> | tar -x -C build/parent`); its `ofa_sr_tpu_torch`
is imported and its kernels built from its own sources. Measured at the BN
shapes of the one-subnet training steps of `chip_smoke.py` (bs16, 96x96 HR,
the subnets of steps 0-7, launches averaged per step), through entry points
every tree with bf16 training (`SRTrainer(compute_dtype=...)`) has:
- ms per step back to back (CUDA events over 20 calls a shape) of
  `bn_moments`, of the sums-only `bn_bwd_sums`, of the BN forward as the
  trainer runs it (`batch_norm_train(..., use_kernels=True)`: moments,
  normalize and the running statistics' update; with x, scale and bias
  requiring grad, under `torch.no_grad()`, and on a bf16 x), and of the BN
  backward as the trainer runs it (autograd's backward of `bn_train_fused`,
  no cotangent on the moments);
- ms per one-subnet step on the kernel path, in float32 and in bf16 mixed
  precision (CUDA events, 3 rounds of 8 steps, median), and the device
  kernels and device busy ms per step over 8 steps from torch.profiler.
Each tree prints one JSON line; with two trees a last line holds all four
runs. Exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

TRAIN_STEPS = 8      # the one-subnet steps of chip_smoke.py
BS, HR = 16, 96
ROUNDS = 3
DEVICE = "cuda"      # the card; a CPU rehearsal sets "cpu"


def bn_train_shapes(space, cfg, bs=BS, hr=HR):
    """NHWC shapes of every train-mode BN of one subnet's forward at batch
    `bs` and HR frames of hr x hr, in order."""
    lr = hr // 2 ** cfg.pixel_d
    trunk = (bs, lr, lr, space.width)
    shapes = [trunk]
    for stage in range(space.n_stages):
        for i in range(cfg.d[stage]):
            mid = space.mid_channels(cfg.e[stage * space.max_depth + i])
            shapes += [(bs, lr, lr, mid)] * 2 + [trunk]
    shapes += [trunk] * 2
    shapes += [(bs, lr * 2 ** i, lr * 2 ** i, 4 * space.width) for i in range(cfg.pixel_d)]
    return shapes + [(bs, hr, hr, 3)]


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


def measure(root):
    """This tree's numbers; `root`'s package is imported here, first."""
    sys.path.insert(0, root)
    from ofa_sr_tpu_torch.entry import step_subnets, synthetic_batch
    from ofa_sr_tpu_torch.models import OFAMobileNetS4, SearchSpace
    from ofa_sr_tpu_torch.ops.kernels.bn import bn_train_fused
    from ofa_sr_tpu_torch.ops.kernels.bn_stats import bn_bwd_sums, bn_moments
    from ofa_sr_tpu_torch.ops.norm import batch_norm_train
    from ofa_sr_tpu_torch.train import SRTrainer
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = DEVICE
    space = SearchSpace()
    steps = [step_subnets(space, i, 1) for i in range(TRAIN_STEPS)]
    per_step = {}
    for cfgs in steps:
        for shp in bn_train_shapes(space, cfgs[0]):
            per_step[shp] = per_step.get(shp, 0) + 1.0 / TRAIN_STEPS
    g = torch.Generator().manual_seed(0)
    ms = {"bn_moments": 0.0, "bn_bwd_sums": 0.0, "bn_forward_train": 0.0,
          "bn_forward_train_no_grad": 0.0, "bn_forward_train_bf16": 0.0,
          "bn_backward_autograd": 0.0}
    for shp, k in sorted(per_step.items()):
        n, c = int(np.prod(shp[:3])), shp[3]
        x = (1.5 * torch.randn(*shp, generator=g) + 0.3).to(dev).requires_grad_()
        scale = (0.5 + torch.rand(c, generator=g)).to(dev).requires_grad_()
        bias = torch.zeros(c, device=dev, requires_grad=True)
        dy = torch.randn(*shp, generator=g).to(dev)
        y, mean, var = bn_train_fused(x, scale, bias)
        inv = torch.rsqrt(var.detach() + 1e-5)
        xd, dyf, xf, md = x.detach(), dy.view(n, c), x.detach().view(n, c), mean.detach()
        ms["bn_moments"] += k * time_ms(lambda: bn_moments(xd))
        ms["bn_bwd_sums"] += k * time_ms(lambda: bn_bwd_sums(dyf, xf, md, inv))
        rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        ms["bn_forward_train"] += k * time_ms(
            lambda: batch_norm_train(x, scale, bias, rm, rv, use_kernels=True))
        with torch.no_grad():
            ms["bn_forward_train_no_grad"] += k * time_ms(
                lambda: batch_norm_train(xd, scale, bias, rm, rv, use_kernels=True))
        xb = xd.to(torch.bfloat16).requires_grad_()
        ms["bn_forward_train_bf16"] += k * time_ms(
            lambda: batch_norm_train(xb, scale, bias, rm, rv, use_kernels=True))
        ms["bn_backward_autograd"] += k * time_ms(
            lambda: torch.autograd.grad(y, (x, scale, bias), dy, retain_graph=True))

    batch = synthetic_batch(BS, HR, dev)
    out = {"root": root, "ms_per_step_back_to_back": ms}
    for prefix, compute_dtype in (("", None), ("bf16_", torch.bfloat16)):
        net = OFAMobileNetS4(space, device=dev, generator=torch.Generator().manual_seed(0))
        tr = SRTrainer(net, use_kernels=True, compute_dtype=compute_dtype)

        def run():
            for cfgs in steps:
                tr.train_step(batch, cfgs, 1e-4)

        step_ms = [time_ms(run, iters=1, warmup=1 if r == 0 else 0) / TRAIN_STEPS
                   for r in range(ROUNDS)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        ranges = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
        kernels = busy_us = 0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            if e.device_type == DeviceType.CUDA and e.key not in ranges and us > 0:
                kernels += e.count
                busy_us += us
        out.update({prefix + "step_ms": step_ms,
                    prefix + "step_ms_median": float(np.median(step_ms)),
                    prefix + "device_kernels_per_step": kernels / TRAIN_STEPS or None,
                    prefix + "device_busy_ms_per_step": busy_us / 1e3 / TRAIN_STEPS or None})
    return out


def main(roots):
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this script times a GPU",
              file=sys.stderr)
        sys.exit(1)
    roots = [os.path.abspath(r) for r in roots]
    if len(roots) == 1:
        print(json.dumps(measure(roots[0])), flush=True)
        return
    runs = []
    for root in (roots[0], roots[1], roots[1], roots[0]):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                           capture_output=True, text=True, timeout=600)
        sys.stderr.write(p.stderr)
        if p.returncode != 0:
            print("FAIL: %s exited %d" % (root, p.returncode), file=sys.stderr)
            sys.exit(1)
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"order": [r["root"] for r in runs], "runs": runs, "gpu": smi}))


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    main(sys.argv[1:])
