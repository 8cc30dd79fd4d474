"""On the card: each cell runs through the command as the benchmark's
check runs it, briefly, and comes out correct; the control at the cell's
own size comes out not correct. Skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, card):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", "2147483647", "--seconds", "2", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cell_size(cell, card):
    out = subprocess.run([sys.executable, "-m", "portbench.calibrate", "--workload", cell,
                          "--seeds", "2147483646"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    control = json.loads(out.stdout.strip().splitlines()[-1])["control"]
    limits = harness.limits_of(harness.cell_entry(BENCH, cell))
    assert not harness.judge([(n, v, limits[n]) for n, v in control.items() if n in limits]), \
        control
