"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration file and traffic mix; the mix's `kind` names the generator
module (`portbench/traffic/<kind>.py`) that drives the program; each
per-layer metric is read by `portbench/metrics/<name>.py`. With `--trace
0` the line holds the cell's end-to-end metrics, with `--trace 1` its
per-layer ones, read after the untraced window from a traced window of the
traffic's `trace_windows` more windows. See README.md.
"""

import time

T0 = time.perf_counter()  # the set-up's start: before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ.setdefault("USE_FLAX", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


class Context:
    """What a per-layer metric's reader takes: the cell, the untraced
    window's host-clock record (`window`), the traced window (`trace`), the
    set-up's record with the program's counters (`setup`)."""

    def __init__(self, cell, window, trace, calls, setup):
        self.cell, self.window, self.trace, self.setup = cell, window, trace, setup
        self._calls = calls

    def roofline_pct(self, family):
        """100 x the least time of the family's work in the traced window
        over its kernels' device time there; None where none of them ran."""
        from portbench import roofline
        spent = self.trace.kernel_s(roofline.KERNELS[family])
        if spent <= 0:
            return None
        return 100.0 * roofline.least_s(self._calls, family) / spent


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    bench = harness.load_benchmark()
    cell = harness.cell_entry(bench, args.workload)
    _, cfg = harness.config_of(bench, cell)
    traffic = harness.traffic_of(cell)
    limits = harness.limits_of(cell)
    e2e, per_layer = harness.cell_metrics(bench, cell["name"])

    import torch
    t_torch = time.perf_counter() - T0
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print("portbench: the cell %s needs %d CUDA device(s); torch.cuda.is_available() is %s, "
              "device_count() %d" % (cell["name"], cell["chips"], torch.cuda.is_available(),
                                     torch.cuda.device_count() if torch.cuda.is_available()
                                     else 0), file=sys.stderr)
        return 3
    # float32 is float32: cuDNN and cuBLAS take no TF32 shortcut
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    kind = harness.kind_module(traffic["kind"])
    work = kind.Workload(cell, cfg, traffic, args.seed & 0xFFFFFFFFFFFF, "cuda")
    work.setup_info.update(import_torch_s=t_torch, inputs_s=time.perf_counter() - T0 - t_torch)
    work.setup()
    setup_s = time.perf_counter() - T0
    window = work.window(args.seconds)
    trace = calls = None
    if args.trace:
        trace, calls = work.traced(traffic.get("trace_windows", 0))
    peak = work.peak_bytes()
    print(json.dumps({"setup": dict(work.setup_info, setup_s=setup_s,
                                    captures_in_window=window.get("captures_in_window"))}))
    found = harness.forbidden_modules()
    if found:
        print("portbench: the run loaded %s" % found, file=sys.stderr)
        return 4
    work.release()
    checks = work.check(limits)

    if args.trace:
        ctx = Context(cell, window, trace, calls, dict(work.setup_info, setup_s=setup_s))
        metrics = {}
        for m in per_layer:
            value = harness.load_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(kind.end_to_end(window), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    device = harness.device_info(cell["chips"], peak)
    result = {"correct": harness.judge(checks), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": device}
    if args.trace:
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = trace.breakdown()
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
