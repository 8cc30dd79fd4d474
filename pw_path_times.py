"""Time the masked 1x1 kernel (csrc/pw_masked.cu, the expand lever's) of a
tree of the PyTorch/CUDA port on one NVIDIA GPU, to compare two trees (a
commit and its parent) in one run.

    python3 pw_path_times.py ROOT            # one tree, in this process
    python3 pw_path_times.py ROOT_A ROOT_B   # A, B, B, A, one process each

ROOT is a checkout of the repo (for a parent commit:
`git archive <commit> | tar -x -C build/parent`); its `ofa_sr_tpu_torch`
is imported and its `csrc/pw_masked.cu` built alone from its own source.
Measured at the shapes of the graphed one-subnet S4 window of
`chip_smoke.py` phase 13 (bench.py's 16 steps, bs16, LR 48 or 24, Cin =
Cout = 64, the bank width 384, each block's sampled mid; 12.75 blocks a
step, each launching every direction twice, the expand's and the
project's), through the wrappers every tree with the lever has
(`pw_masked_forward`, `pw_masked_dgrad`, `pw_masked_wgrad`):
- device ms per step of each direction, float32 and bf16: 20 calls of the
  wrapper captured into one CUDA graph and its replays timed with CUDA
  events (no host time), each call after a read of a 128 MB buffer that
  leaves none of its operands in the 50 MB L2 (as in the training step,
  where other kernels run between them; the reads' own graph is timed
  alone and taken off), summed over the shapes by their launches a step;
- the same back to back (CUDA events over 20 eager calls a shape), where
  the wrapper's host work shows.
Each tree prints one JSON line; with two trees a last line holds all four
runs and the card's name and power limit. Exits non-zero when no CUDA
device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

SPD = 16              # chip_smoke.py's one-subnet window
BS, HR = 16, 96
CALLS = 20
ROUNDS = 3
FLUSH_BYTES = 128 << 20   # read between two calls: more than the L2 holds
DEVICE = "cuda"       # the card; a CPU rehearsal sets "cpu"


def path_shapes(space, sample_subnet, subnet_seed):
    """{(LR side, mid): blocks a step} of the graphed one-subnet window
    (chip_smoke.py `pw_path_shapes`: bench.py's eight subnets cycled over
    SPD steps)."""
    eight = [sample_subnet(space, seed=subnet_seed(0, 50, i, 0)) for i in range(8)]
    per = {}
    for i in range(SPD):
        cfg = eight[i % 8]
        lr = HR // 2 ** cfg.pixel_d
        for stage in range(space.n_stages):
            for j in range(cfg.d[stage]):
                key = (lr, space.mid_channels(cfg.e[stage * space.max_depth + j]))
                per[key] = per.get(key, 0) + 1.0 / SPD
    return per


def eager_ms(fn):
    """ms per call from CUDA events over CALLS back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS


def graph_ms(fn):
    """ms of one replay of a CUDA graph of fn() (after two warm-up calls on
    a side stream), the median of ROUNDS replays timed with CUDA events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn):
    """Device ms a call of fn: CALLS calls in one CUDA graph, each after a
    read of FLUSH_BYTES, whose own graph is timed alone and taken off."""
    buf = torch.empty(FLUSH_BYTES // 4, device=DEVICE)
    out = torch.empty((), device=DEVICE)

    def flush():
        torch.sum(buf, dim=0, out=out)

    def both():
        for _ in range(CALLS):
            flush()
            fn()

    t = graph_ms(both) - graph_ms(lambda: [flush() for _ in range(CALLS)])
    del buf
    return t / CALLS


def build_pw_masked(_build):
    """Build and load csrc/pw_masked.cu of this tree alone; its seconds."""
    import ctypes
    import time

    t0 = time.perf_counter()
    with _build._lock:
        err = _build._finish("pw_masked", _build._start("pw_masked"))
        if err:
            raise RuntimeError(err)
        lib = ctypes.CDLL(_build._lib_path("pw_masked")[1])
        _build._declare("pw_masked", lib)
        _build._libs["pw_masked"] = lib
    return time.perf_counter() - t0


def measure(root):
    """This tree's numbers; `root`'s package is imported here, first."""
    sys.path.insert(0, root)
    from ofa_sr_tpu_torch.models import SearchSpace
    from ofa_sr_tpu_torch.models.arch import sample_subnet, subnet_seed
    from ofa_sr_tpu_torch.ops.kernels import _build
    from ofa_sr_tpu_torch.ops.kernels.pw_masked import (
        pw_masked_dgrad,
        pw_masked_forward,
        pw_masked_wgrad,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": root, "build_s": build_pw_masked(_build)}
    space = SearchSpace()
    c, big = space.width, space.mid_channels(max(space.expand_list))
    shapes = path_shapes(space, sample_subnet, subnet_seed)
    g = torch.Generator().manual_seed(0)
    for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        dev_ms = {"forward": 0.0, "dgrad": 0.0, "wgrad": 0.0}
        b2b_ms = dict(dev_ms)
        for (lr, mid), k in sorted(shapes.items()):
            rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(  # noqa: E731
                DEVICE, dtype)
            x, dz = rnd(BS, lr, lr, c), rnd(BS, lr, lr, c)
            h, dy = rnd(BS, lr, lr, big), rnd(BS, lr, lr, big)
            we, wp = rnd(big, c, 1, 1, scale=c ** -0.5), rnd(c, big, 1, 1, scale=big ** -0.5)
            bt = torch.tensor(mid, dtype=torch.int32, device=DEVICE)
            for name, fns in (
                    ("forward", (lambda: pw_masked_forward(x, we, bt, side="expand"),
                                 lambda: pw_masked_forward(h, wp, bt, side="project"))),
                    ("dgrad", (lambda: pw_masked_dgrad(dy, we, bt, side="expand"),
                               lambda: pw_masked_dgrad(dz, wp, bt, side="project"))),
                    ("wgrad", (lambda: pw_masked_wgrad(x, dy, bt, side="expand"),
                               lambda: pw_masked_wgrad(h, dz, bt, side="project")))):
                for fn in fns:
                    dev_ms[name] += k * device_ms(fn)
                    b2b_ms[name] += k * eager_ms(fn)
        out[key + "_device_ms_per_step"] = dev_ms
        out[key + "_device_ms_per_step_sum"] = sum(dev_ms.values())
        out[key + "_back_to_back_ms_per_step"] = b2b_ms
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
