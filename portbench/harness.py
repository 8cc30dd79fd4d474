"""What every cell of the benchmark shares: finding a cell's files by name,
the seeded initial state drawn on the device, the profiler's trace reduced
to kernel times, the device's busy share and the breakdown, and the
result line.

Nothing here imports the program (`ofa_sr_tpu_torch`); the traffic kinds
(`portbench/traffic/<kind>.py`) drive it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import re
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "ofa_sr_tpu")


# -- finding a cell's pieces by name -------------------------------------------

def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_entry(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError("no workload %r in BENCHMARK.json (has %s)"
                   % (name, [w["name"] for w in bench["workloads"]]))


def config_of(bench, cell):
    """(the configuration's entry, its file's contents)."""
    for c in bench["configs"]:
        if c["name"] == cell["config"]:
            return c, load_json(os.path.join(ROOT, c["file"]))
    raise KeyError("no config %r in BENCHMARK.json" % cell["config"])


def traffic_of(cell):
    """The traffic mix's parameters: `traffic/<name>.json`."""
    return load_json(os.path.join(BENCH_DIR, "traffic", cell["traffic"] + ".json"))


def limits_of(cell):
    """The limits of the numbers `correct` compares: `limits/<cell>.json`."""
    return load_json(os.path.join(BENCH_DIR, "limits", cell["name"] + ".json"))


def kind_module(kind):
    """The generator module a traffic file's `kind` names."""
    return importlib.import_module("portbench.traffic." + kind)


def load_reader(name):
    """The reader module of per-layer metric `name` (`metrics/<name>.py`)."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric, cell_name, e2e_of_cell):
    """Whether a metric entry is reported in a cell: by its `workloads`
    list, else (a per-layer metric) wherever the end-to-end metric it moves
    is reported."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_of_cell
    return True


def cell_metrics(bench, cell_name):
    """(end-to-end entries, per-layer entries) reported in a cell."""
    e2e = [m for m in bench["end_to_end"] if applies(m, cell_name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, cell_name, names)]
    return e2e, per_layer


# -- the seeded initial state ---------------------------------------------------

def _init_scale(name, shape):
    """(kind, scale) of one entry of a state dict, by the published init of
    its kind: he_fout for conv banks (normal(0, sqrt(2 / (k*k*out)))),
    1/sqrt(in) for a linear layer, BN's weight near 1 and its bias, mean
    and variance near their published starts but not at them, transform
    matrices near the identity, biases small."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked":
        return "keep", 0.0
    if name.endswith("_matrix"):
        return "eye", 0.05 / shape[0] ** 0.5
    if len(shape) == 4:
        return "normal", math.sqrt(2.0 / (shape[2] * shape[3] * shape[0]))
    if len(shape) == 2:
        return "normal", 1.0 / math.sqrt(shape[1])
    parent = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else ""
    if parent == "bn" or ".bn." in name or name.startswith("bn."):
        return {"weight": ("one", 0.1), "bias": ("normal", 0.1), "running_mean": ("normal", 0.1),
                "running_var": ("var", 0.25)}[leaf]
    return "normal", 0.01


def seeded_state(shapes, seed, device):
    """{name: tensor} for `shapes` ({name: (shape, dtype)}, a state dict's
    entries) drawn on `device` from `seed` in one call of one
    `torch.Generator` there, in the order of the names, then shaped by
    `_init_scale`. The same seed gives the same tensors, whatever order the
    program registers its modules in."""
    import torch
    shapes = dict(sorted(shapes.items()))
    float_names = [n for n, (s, d) in shapes.items() if d.is_floating_point]
    total = sum(math.prod(shapes[n][0]) for n in float_names)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, dtype) in shapes.items():
        if not dtype.is_floating_point:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        kind, s = _init_scale(name, shape)
        if kind == "eye":
            t = torch.eye(shape[0], device=device) + s * z
        elif kind == "one":
            t = 1.0 + s * z
        elif kind == "var":
            t = 1.0 + s * torch.tanh(z)
        else:
            t = s * z
        out[name] = t.to(dtype).contiguous()
    return out


def state_shapes(module):
    return {k: (tuple(v.shape), v.dtype) for k, v in module.state_dict().items()}


# -- the traced window --------------------------------------------------------

def _merge(intervals):
    """The union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _short(name, n=64):
    return re.sub(r"[^A-Za-z0-9_.:<>,]", "_", name)[:n]


class Trace:
    """A traced window reduced to what the readers take: the device
    operations (name, start ns, duration ns), the seconds in which one ran
    (`busy_s`), the window's host-clock length (`window_s`), the device
    time of the kernels whose function name matches, and the breakdown."""

    def __init__(self, device_ops, runtime, window_s):
        self.ops = device_ops          # [(name, start_ns, dur_ns, correlation)]
        self.runtime = runtime         # correlation -> host call name
        self.window_s = window_s
        busy = _merge([(s, s + d) for _, s, d, _ in device_ops])
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        self._busy = busy

    def kernel_s(self, names):
        """Device seconds of the operations whose function is one of
        `names` (the whole identifier, so `finish_kernel` is not
        `bn_fwd_finish_kernel`)."""
        pat = re.compile(r"(?<![A-Za-z0-9_])(%s)(?![A-Za-z0-9_])" % "|".join(map(re.escape, names)))
        return sum(d for n, _, d, _ in self.ops if pat.search(n)) / 1e9

    def breakdown(self, n=10):
        by = {}
        for name, _, d, _ in self.ops:
            by[name] = by.get(name, 0) + d
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        # each idle gap, named by the host call that launched the operation
        # that ended it
        starts = {}
        for name, s, _, corr in self.ops:
            starts.setdefault(s, corr)
        gaps = []
        for (s0, e0), (s1, _) in zip(self._busy, self._busy[1:]):
            gaps.append((self.runtime.get(starts.get(s1), "unknown"), (s1 - e0) / 1e9))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[_short(k), v / 1e9] for k, v in top],
                "idle_gaps": [[_short(k), v] for k, v in gaps[:n]]}


def trace_window(fn, sync, cuda=True):
    """Run `fn()` under `torch.profiler` (host, and the device where
    `cuda`), `sync()` at both ends, and reduce the trace. Returns (fn's
    result, Trace)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window_s = time.perf_counter() - t0
    ops, runtime = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:  # kernels, copies, sets
            corr = getattr(e, "linked_correlation_id", lambda: 0)() or e.correlation_id()
            ops.append((e.name(), e.start_ns(), e.duration_ns(), corr))
        elif e.name().startswith("cuda"):  # the runtime call that launched them
            runtime[e.correlation_id()] = e.name()
    return out, Trace(ops, runtime, window_s)


# -- the result -----------------------------------------------------------------

def forbidden_modules():
    """The modules of JAX or the JAX package loaded in this process, by
    whole top-level names."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(count, peak_bytes=None):
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}
    if peak_bytes is not None:
        info["memory_peak_bytes"] = int(peak_bytes)
    return info


def judge(checks):
    """True when every number is finite and within its limit."""
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def emit(result, checks):
    """Print each compared number beside its limit as the last lines on
    standard error, then the result as the last line of standard output,
    with the checks under a key of their own, last."""
    for name, value, limit in checks:
        print("check %s %r limit %r %s" % (name, value, limit,
                                            "ok" if value <= limit else "FAIL"),
              file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    print(json.dumps(line))
    sys.stdout.flush()
