"""Runs one cell of ``BENCHMARK.json`` once and builds its result line.

Everything that belongs to one configuration, traffic mix or metric is found
by name:

- ``BENCHMARK.json``'s configuration entry names its file (the widths);
- a traffic mix is ``traffic/<traffic>.json``, whose ``driver`` names the
  general generator under ``drivers/`` that runs it;
- a metric is ``metrics/<name>.py``, whose ``read(run)`` returns its value
  or None when the run holds nothing to read;
- the limits that decide ``correct`` are ``limits/<cell>.json``.

A driver module has ``setup(run)``, ``window(run, state)``,
``release(run, state)`` and ``check(run, state)``; see ``Run`` for what it
reads and fills.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from portbench import idle

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
OUT_DIR = os.path.join(BENCH_DIR, ".out")
FORBIDDEN = ("jax", "jaxlib", "flax", "nvblox_mindmap_tpu")


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return read_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_metric(name: str):
    """The reader module ``metrics/<name>.py`` (metric names hold dots)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def deep_update(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        out[k] = deep_update(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


class Run:
    """One run of one cell: its inputs and what the driver and the readers
    share.

    Set by the harness: ``cell``, ``config`` (the configuration file),
    ``traffic`` (the traffic file), ``seed``, ``seconds``, ``trace``,
    ``device``. Filled by the driver: ``latencies`` (seconds per unit, by
    kind: "goal", "step", "train_step"), ``counts`` (completed units by
    kind, plus "samples"), ``attempted`` / ``failed``, ``flops`` (by kind,
    one unit's), ``flash_calls`` (the flash calls of the profiled part) and
    ``flash_bound_s`` (the sum of their bounds), ``window_s``, ``notes``
    (sizes and counts a reader of the output should see). Filled by the
    harness: ``setup_s``, ``untraced`` (the latencies outside the
    profiler), ``spans`` (host seconds by span name, traced runs),
    ``events`` (the profiled part's Chrome trace events, traced runs).
    """

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
                 trace: bool, device, start: float):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.start = start
        self.latencies: Dict[str, List[float]] = {}
        self.untraced: Dict[str, List[float]] = {}
        self.counts: Dict[str, int] = {}
        self.attempted = 0
        self.failed = 0
        self.flops: Dict[str, float] = {}
        self.flash_calls: List[Any] = []
        self.flash_bound_s = 0.0
        self.spans: Dict[str, List[float]] = {}
        self.events: Optional[List[dict]] = None
        self.window_s: Optional[float] = None
        self.setup_s: Optional[float] = None
        self.notes: Dict[str, Any] = {}
        self.profiling = False
        self._profiler = None
        self._window_range = None
        self._traced_units = 0
        self._window_start = None

    # --- the driver's clock ------------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open_window(self) -> None:
        """Opens the window; a traced run's profiler starts first (its start
        takes seconds), so that the window's own time excludes it."""
        if self.trace:
            self._start_profiler()
        self.sync()
        self._window_start = time.perf_counter()

    def more(self) -> bool:
        """Whether the window is still open (``seconds`` since it opened)."""
        return time.perf_counter() - self._window_start < self.seconds

    def close_window(self) -> None:
        self.sync()
        self.window_s = time.perf_counter() - self._window_start
        self._stop_profiler()

    @contextlib.contextmanager
    def unit(self, kind: str):
        """Time one unit of work (a goal, a sim step, a train step) from the
        call until the device has finished it. In a traced run the profiler
        covers the window's first ``trace_units`` units."""
        t0 = time.perf_counter()
        yield
        self.sync()
        dt = time.perf_counter() - t0
        self.latencies.setdefault(kind, []).append(dt)
        if not self.profiling:
            self.untraced.setdefault(kind, []).append(dt)
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if self.profiling:
            self._traced_units += 1
            if self._traced_units >= self.traffic["trace_units"]:
                self._stop_profiler()

    def warm_up(self, fn: Callable[[], None]) -> int:
        """Call ``fn`` (one unit, or one cycle of units) until its times
        settle, within the traffic's ``warmup_least`` / ``warmup_most`` calls
        and ``settle_tolerance``."""
        tr = self.traffic
        return settle(fn, self.sync, tr["warmup_least"], tr["warmup_most"],
                      tr["settle_tolerance"])

    # --- spans -------------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str):
        """A host-clock span around a call into a layer, synchronized at both
        ends, and a profiler range of the same name (traced runs only)."""
        if not self.trace:
            yield
            return
        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(idle.SPAN_PREFIX + name):
            yield
            self.sync()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def wrap_span(self, name: str, fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped

    # --- the profiler ------------------------------------------------------------
    def _start_profiler(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.__enter__()
        self._window_range = torch.profiler.record_function(idle.WINDOW)
        self._window_range.__enter__()
        self.profiling = True

    def _stop_profiler(self) -> None:
        if not self.profiling:
            return
        self.sync()
        self._window_range.__exit__(None, None, None)
        self.profiling = False
        self._profiler.__exit__(None, None, None)

    def read_trace(self) -> None:
        if self._profiler is None:
            return
        os.makedirs(OUT_DIR, exist_ok=True)
        path = os.path.join(OUT_DIR, f"trace-{self.cell['name']}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        try:
            self.events = idle.load(path)
        finally:
            os.remove(path)


def settle(fn: Callable[[], None], sync: Callable[[], None], least: int, most: int,
           tolerance: float) -> int:
    """Call ``fn`` until the last three calls' times lie within
    ``tolerance`` of their median (at least ``least`` calls, at most
    ``most``). Returns the number of calls."""
    times: List[float] = []
    while len(times) < most:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
        last = times[-3:]
        if len(times) >= least and len(last) == 3:
            med = statistics.median(last)
            if (max(last) - min(last)) <= tolerance * med:
                break
    return len(times)


def cell_entries(bench: dict, cell: str) -> dict:
    """The cell's workload, configuration, traffic and limits, by name."""
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    w = work[cell]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return {
        "workload": w,
        "config": deep_update(read_json(os.path.join(ROOT, config["file"])),
                              {"name": config["name"]}),
        "traffic": read_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")),
        "limits": read_json(os.path.join(BENCH_DIR, "limits", f"{cell}.json")),
    }


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number that has a limit, beside it; a number the driver did not
    give reads infinite."""
    return {k: {"value": numbers.get(k, math.inf), "limit": v} for k, v in limits.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def prepare(cell: str, seed: int, seconds: float, trace: bool, device, start: float,
            overrides: Optional[dict] = None):
    """(run, driver, state, entries) of one cell after its set-up; the
    window has not opened. ``overrides`` (tests only) are merged into the
    configuration and traffic files."""
    entries = cell_entries(load_benchmark(), cell)
    overrides = overrides or {}
    config = deep_update(entries["config"], overrides.get("config", {}))
    traffic = deep_update(entries["traffic"], overrides.get("traffic", {}))
    run = Run(entries["workload"], config, traffic, seed, seconds, trace, device, start)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    state = driver.setup(run)
    gc.collect()
    run.sync()
    run.setup_s = time.perf_counter() - start
    return run, driver, state, entries


def measure(run, driver, state) -> int:
    """The window, then the device's memory peak (returned) before the
    program's state is freed, then the trace's events."""
    driver.window(run, state)
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    driver.release(run, state)
    run.read_trace()
    return peak


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device, start: float,
             overrides: Optional[dict] = None) -> dict:
    """Set up, measure and check one cell; returns the result line's object
    (and its ``notes``, which the line leaves out)."""
    run, driver, state, entries = prepare(cell, seed, seconds, trace, device, start, overrides)
    memory_peak = measure(run, driver, state)
    bench = load_benchmark()
    metrics = {}
    for m in metrics_for(bench, cell, trace):
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": False, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device_info}
    if trace and run.events is not None:
        busy, length = idle.busy_and_window_s(run.events)
        device_info.update(busy_s=busy, window_s=length)
        result["breakdown"] = idle.breakdown(run.events)
    run.events = None

    numbers = driver.check(run, state)
    checks = judge(numbers, entries["limits"])
    run.notes["uncompared"] = {k: v for k, v in numbers.items() if k not in checks}
    result["correct"] = run.failed == 0 and passed(checks)
    result["checks"] = checks
    result["notes"] = run.notes
    return result


def result_line(result: dict) -> str:
    """The last line of a run's output: the result without its notes, its
    checks last."""
    line = {k: v for k, v in result.items() if k not in ("notes", "checks")}
    line["checks"] = result["checks"]
    return json.dumps(line)
