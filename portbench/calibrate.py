"""Readings of the numbers `correct` compares, for setting their limits:
the program's on each seed, and the control's (the plain reference one
precision below the configuration's, put in the program's place), in one
process, without a measured window. Not run by the benchmark's own runs.

    python3 -m portbench.calibrate --workload <name> --seeds 11,12,13 [--control 3]

Prints one JSON line a seed: {"seed", "program": {name: value}} and, on
the first `--control` seeds, "control": {name: value}.
"""

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = harness.load_benchmark()
    cell = harness.cell_entry(bench, args.workload)
    _, cfg = harness.config_of(bench, cell)
    traffic = harness.traffic_of(cell)
    kind = harness.kind_module(traffic["kind"])
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        work = kind.Workload(cell, cfg, traffic, seed & 0xFFFFFFFFFFFF, "cuda")
        work.setup()
        if hasattr(work, "answer_all"):
            work.answer_all()
        work.release()
        line = {"seed": seed, "program": dict(work.readings())}
        if i < args.control:
            line["control"] = dict(work.control())
        print(json.dumps(line), flush=True)
        del work
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
