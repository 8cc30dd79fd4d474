"""The run-to-run spread of `chip_smoke.py` phase 14 (b)'s Proxyless float32
parity window on one NVIDIA GPU.

    python3 cls_parity_spread.py [REPEATS]     # default 3

Phase 14 (b) holds each parameter tensor of the graphed classification
window that strays past STEP_TOL from its reference path to the float64
sliced window: its distance from the float64 change (relative L2) within
the reference path's own distance plus CLS_UPDATE_RTOL. Float32 at full
width is chaotic over a window, so both distances are draws. This script
runs Proxyless's one-subnet window (phase 14 (b)'s subnets, batches and
SGD, 1 step and 4 steps) on each path, graphed, eager masked, eager sliced
and the eager sliced steps without the BN kernels (`use_kernels=False`),
REPEATS times with cuDNN's default algorithms and twice with its
deterministic ones, and prints per run the per-step losses, the largest
and the median distance over the tensors, the first block's depthwise
weight's, and the six farthest tensors; then, for every graphed run
against every eager sliced run of the same cuDNN mode, phase 14 (b)'s check
as `chip_smoke.hold_to` makes it: the worst margin (distance less bound;
above 0 fails) and its tensor. Last, against the float64 sliced window:
the float64 masked one (the same window code run eagerly in float64, plain
path; it holds the lr in float32, as the window does) and the float64
sliced one at that float32 lr: whether the two forms part by more than
that rounding of the lr, grown over the window, parts the sliced form
from itself. Exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import gc
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402
from ofa_sr_tpu_torch.train.cls_trainer import ClsTrainer  # noqa: E402

FAMILY = cs.OFAProxylessNASNets
FIRST_DW = "blocks.0.mobile_inverted_conv.depth_conv.conv.weight"
PATHS = ("graphed", "eager masked", "eager sliced", "plain sliced")


def window(n_steps):
    """Phase 14 (b)'s one-subnet window and batches, cut to `n_steps`."""
    probe = cs.cls_train_net(FAMILY, "cpu", 41)
    archs = [[probe.sample_arch(seed=cs.subnet_seed(0, cs.CLS_SPD, i, 0),
                                depth_candidates=[2, 3])] for i in range(cs.CLS_SPD)]
    return archs[:n_steps], [cs.cls_batch(50 + i) for i in range(n_steps)]


def trainer(net, use_kernels):
    return ClsTrainer(net, opt_type="sgd", weight_decay=3e-5, momentum=0.9, nesterov=True,
                      label_smoothing=0.1, use_kernels=use_kernels)


def own_run(path, archs, batches):
    """The paths `chip_smoke.cls_window_run` has no switch for: "plain
    sliced" (float32, train_step, BN without the kernels), "float64
    masked" (the window code run eagerly in float64 on the plain path; its
    flat gradient buffers take the default dtype, float64 for the run) and
    "float64 sliced, float32 lr" (train_step in float64 at the lr the
    window holds)."""
    f64 = path.startswith("float64")
    net = cs.cls_train_net(FAMILY, cs.DEVICE, 41, dropout_rate=0.0)
    if f64:
        net.double()
        batches = [dict(b, image=b["image"].double()) for b in batches]
    w0 = {k: p.detach().clone() for k, p in net.named_parameters()}
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64 if f64 else dtype)
    try:
        tr = trainer(net, False)
        lr = cs.CLS_PARITY_LR
        if path == "float64 sliced, float32 lr":
            lr = float(torch.tensor(lr, dtype=torch.float32))
        lrs = [lr] * len(archs)
        if path == "float64 masked":
            step = tr.make_scan_train_step(1)
            step.cache.cuda = False
            losses = step(batches, archs, lrs)["losses"].tolist()
        else:
            losses = [float(tr.train_step(b, a, lr)["loss"]) for b, a, lr in
                      zip(batches, archs, lrs)]
    finally:
        torch.set_default_dtype(dtype)
    torch.cuda.synchronize()
    return {"losses": torch.tensor(losses, dtype=torch.float64), "w0": w0,
            "params": {k: p.detach().clone() for k, p in net.named_parameters()}}


def run(path, archs, batches):
    out = (own_run(path, archs, batches) if path.startswith(("plain", "float64 "))
           else cs.cls_window_run(path, FAMILY, archs, batches))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def distances(r, r64):
    """Each tensor's distance from the float64 window's change, relative
    (inf where float64 leaves it as it was and this run does not)."""
    out = {}
    for n, p in r["params"].items():
        size = float((r64["params"][n] - r["w0"][n].double()).norm())
        dist = float((p.double() - r64["params"][n]).norm())
        out[n] = dist / size if size else (float("inf") if dist else 0.0)
    return out


def report(tag, r, r64):
    d = distances(r, r64)
    moved = {n: v for n, v in d.items() if v != float("inf")}
    vals = sorted(moved.values())
    top = sorted(moved.items(), key=lambda kv: -kv[1])[:6]
    print("%-22s losses %s | max %.3e, median %.3e, first depthwise %.4f | farthest %s; "
          "%d tensors moved where float64 left them"
          % (tag, ["%.7f" % x for x in r["losses"].tolist()], vals[-1], vals[len(vals) // 2],
             d[FIRST_DW], [(n.replace("mobile_inverted_conv.", ""), round(v, 4))
                           for n, v in top], len(d) - len(moved)), flush=True)
    return d


def check_margin(g, gd, s, sd):
    """chip_smoke.hold_to's float32 parameter check, graphed `g` against
    eager sliced `s` (beside_ref): the worst (distance - bound, tensor,
    distance, the reference's distance, bound), None where every tensor is
    within STEP_TOL."""
    worst = None
    for n, t in g["params"].items():
        if bool(torch.isclose(t, s["params"][n], **cs.STEP_TOL).all()):
            continue
        bound = cs.CLS_UPDATE_RTOL + (sd[n] if sd[n] > cs.CLS_UPDATE_RTOL else 0.0)
        m = (gd[n] - bound, n, round(gd[n], 4), round(sd[n], 4), round(bound, 4))
        if worst is None or m[0] > worst[0]:
            worst = m
    return worst


def main():
    if not torch.cuda.is_available():
        sys.exit("cls_parity_spread.py: no CUDA device")
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    for n_steps in (1, 4):
        archs, batches = window(n_steps)
        r64 = cs.cls_window_run("float64", FAMILY, archs, batches)
        print("== %d step(s); float64 sliced losses %s" % (n_steps, r64["losses"].tolist()),
              flush=True)
        runs = {}
        for det in (False, True):
            with (cs.deterministic_cudnn() if det else cs.contextlib.nullcontext()):
                for path in PATHS:
                    reps = 1 if n_steps == 1 else (2 if det else repeats)
                    for k in range(reps):
                        tag = "%s%s #%d" % (path, ", det" if det else "", k)
                        r = run(path, archs, batches)
                        runs[tag] = (r, report(tag, r, r64))
        for gt, (g, gd) in runs.items():
            for st, (s, sd) in runs.items():
                if gt.startswith("graphed") and st.startswith("eager sliced") and \
                        ("det" in gt) == ("det" in st):
                    print("  check %s against %s: worst margin %s"
                          % (gt, st, check_margin(g, gd, s, sd)), flush=True)
        for path in ("float64 masked", "float64 sliced, float32 lr"):
            m64 = run(path, archs, batches)
            d = {n: v for n, v in distances(m64, r64).items() if v != float("inf")}
            top = sorted(d.items(), key=lambda kv: -kv[1])[:3]
            print("  %s against float64 sliced: losses %.3e apart at most; the median tensor "
                  "%.3e of its change, the first depthwise %.3e, the farthest %s"
                  % (path, float((m64["losses"] - r64["losses"]).abs().max()),
                     sorted(d.values())[len(d) // 2], d[FIRST_DW],
                     [(n, "%.3e" % v) for n, v in top]), flush=True)
        del runs, r64, m64
    print("took %.1f s" % (time.perf_counter() - t0), flush=True)


if __name__ == "__main__":
    main()
