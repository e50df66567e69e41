"""A configuration, a traffic mix, a cell and a metric are found by name from
new files plus new entries in BENCHMARK.json, with no file of the benchmark
edited; and a checkout without the program yields no result."""
import json
import os
import shutil
import subprocess
import sys

from portbench import harness
from portbench.tests.conftest import SEED

NEW_METRIC = '''"""Goals completed in the window."""


def read(run):
    return float(run.counts.get("goal", 0)) or None
'''


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns(".out", ".cache", "__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root


def _run(root, cell, pythonpath):
    code = f"""
import json, time, torch
from portbench import harness
from portbench.tests.conftest import tiny
res = harness.run_cell({cell!r}, {SEED}, 1.0, False, torch.device("cpu"), time.perf_counter(),
                       tiny({cell!r}))
print(harness.result_line(res))
"""
    return subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": pythonpath, "OMP_NUM_THREADS": "2"})


def test_new_files_and_entries_add_a_cell(tmp_path):
    root = _copy(tmp_path)
    bench_dir = root / "portbench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    config = json.loads((bench_dir / "configs" / "mindmap_radio_b16.json").read_text())
    (bench_dir / "configs" / "radio_copy.json").write_text(json.dumps(config))
    traffic = json.loads((bench_dir / "traffic" / "goals_ddim10.json").read_text())
    traffic["inference_steps"] = 5
    (bench_dir / "traffic" / "goals_ddim5.json").write_text(json.dumps(traffic))
    (bench_dir / "limits" / "copy_goal.json").write_text(
        (bench_dir / "limits" / "radio_goal.json").read_text())
    (bench_dir / "metrics" / "goals_done.py").write_text(NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "radio_copy", "source": "https://example.org/radio_copy",
                             "file": "portbench/configs/radio_copy.json", "reduced": [],
                             "why": "a test configuration"})
    bench["workloads"].append({"name": "copy_goal", "config": "radio_copy",
                               "traffic": "goals_ddim5", "chips": 1, "why": "a test cell"})
    bench["end_to_end"].append({"name": "goals_done", "unit": "goals", "better": "higher",
                                "bound": 0.1, "source": "host_clock", "workloads": ["copy_goal"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for path, data in before.items():
        assert path.read_bytes() == data  # nothing edited, only added

    out = _run(root, "copy_goal", f"{root}{os.pathsep}{harness.ROOT}")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "goals_done"}


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    root = _copy(tmp_path)
    out = _run(root, "radio_goal", str(root))
    assert out.returncode != 0
    assert "nvblox_mindmap_torch" in out.stderr
    assert '"correct"' not in out.stdout
