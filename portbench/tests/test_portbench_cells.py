"""Every cell of BENCHMARK.json at a tiny size on the CPU, through the plain
paths: a whole run ends in one result line with the contract's keys and
reads correct; the traced run's line carries the breakdown."""
import json

import pytest

from portbench import harness
from portbench.tests.conftest import run_tiny

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell):
    result = run_tiny(cell)
    line = json.loads(harness.result_line(result))
    assert list(line) == KEYS
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    limits = harness.read_json(f"{harness.BENCH_DIR}/limits/{cell}.json")
    assert set(line["checks"]) == set(limits)
    expected = {m["name"] for m in harness.metrics_for(harness.load_benchmark(), cell, False)}
    assert set(line["metrics"]) == expected
    for metric in line["metrics"].values():
        assert metric["value"] > 0 and metric["unit"]
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": 0}


def test_traced_run_has_breakdown_and_host_spans():
    result = run_tiny("radio_goal", trace=True)
    line = json.loads(harness.result_line(result))
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert line["correct"] is True
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # Spans only: the device metrics need a card and report nothing here.
    assert set(line["metrics"]) == {"mesh_ms.goal", "sampler_ms.goal"}
    assert line["device"]["busy_s"] == 0.0 and line["device"]["window_s"] > 0
