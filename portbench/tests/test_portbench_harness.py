"""The harness finds every piece by name, BENCHMARK.json keeps to the
benchmark's contract, the reader modules agree with their entries, the
trace reduces as it should and the result line has exactly its keys."""

import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "portbench.run"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                     "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {"setup_s"} <= {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_pieces_by_name(cell):
    entry = harness.cell_entry(BENCH, cell)
    _, cfg = harness.config_of(BENCH, entry)
    traffic = harness.traffic_of(entry)
    kind = harness.kind_module(traffic["kind"])
    assert hasattr(kind, "Workload") and hasattr(kind, "end_to_end")
    limits = harness.limits_of(entry)
    assert limits and all(v > 0 for v in limits.values())
    e2e, per_layer = harness.cell_metrics(BENCH, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_reader_declares_its_entry(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    mod = harness.load_reader(metric)
    assert (mod.UNIT, mod.BETTER, mod.LAYER, mod.MOVES) == (
        entry["unit"], entry["better"], entry["layer"], entry["moves"])
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(entry["workloads"]) <= cells


def test_config_files_hold_their_sources():
    for c in BENCH["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["source"].startswith(c["source"])


class _Ctx:
    def __init__(self, trace):
        self.trace = trace


def test_trace_reduction_merges_and_matches_whole_names():
    ops = [("void ns::finish_kernel<1>(float*)", 0, 100, 1),
           ("void ns::bn_fwd_finish_kernel(float*)", 50, 100, 2),
           ("void ns::dw_fwd_kernel<bf16>(x)", 400, 100, 3)]
    t = harness.Trace(ops, {1: "cudaLaunchKernel", 3: "cudaGraphLaunch"}, 1e-6)
    assert t.busy_s == pytest.approx(250e-9)
    assert t.kernel_s(["finish_kernel"]) == pytest.approx(100e-9)
    assert t.kernel_s(["finish_kernel", "bn_fwd_finish_kernel"]) == pytest.approx(200e-9)
    b = t.breakdown()
    assert b["idle_gaps"] == [["cudaGraphLaunch", pytest.approx(250e-9)]]
    assert len(b["device_ops"]) == 3
    idle = harness.load_reader("idle_pct.train")
    assert idle.read(_Ctx(t)) == pytest.approx(75.0)


def test_result_line_has_exactly_the_contract_keys(capsys):
    checks = [("loss_gap", 0.001, 0.01)]
    result = {"correct": harness.judge(checks), "attempted": 3, "failed": 0,
              "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
              "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                         "memory_peak_bytes": 1}}
    harness.emit(result, checks)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["checks"] == {"loss_gap": {"value": 0.001, "limit": 0.01}}
    assert err.strip().splitlines()[-1].startswith("check loss_gap")


def test_judge_fails_a_number_past_its_limit_or_not_finite():
    assert harness.judge([("a", 0.5, 1.0)])
    assert not harness.judge([("a", 1.5, 1.0)])
    assert not harness.judge([("a", float("nan"), 1.0)])


def test_seeded_state_repeats_and_ignores_order():
    import torch
    shapes = {"b.conv.weight": ((8, 4, 3, 3), torch.float32), "a.bn.weight": ((8,), torch.float32),
              "a.bn.num_batches_tracked": ((), torch.int64)}
    s1 = harness.seeded_state(shapes, 2 ** 33 + 5, "cpu")
    s2 = harness.seeded_state(dict(reversed(list(shapes.items()))), 2 ** 33 + 5, "cpu")
    assert all(torch.equal(s1[k], s2[k]) for k in shapes)
    assert not torch.equal(s1["b.conv.weight"],
                           harness.seeded_state(shapes, 6, "cpu")["b.conv.weight"])
