"""Readings from a torch.profiler Chrome trace: the device's busy time as the
union of its operations' intervals, the idle share of the traced window,
device time under a host range, and the breakdown of the run's last line.

Times in a Chrome trace are microseconds. Device operations are the events
of categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; the benchmark's
host spans are ``user_annotation`` events whose names start with
``SPAN_PREFIX``. Overlapping device operations (several streams) count once.
"""
from __future__ import annotations

import bisect
import json
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "portbench."
WINDOW = SPAN_PREFIX + "window"
TOP = 10

Interval = Tuple[float, float]


def load(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def device_ops(events: Iterable[dict]) -> List[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def clipped_length(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged(intervals))


def window(events: Iterable[dict], name: str = WINDOW) -> Interval:
    """(start, end) of the host range ``name`` (its first instance)."""
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") == name:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    raise ValueError(f"the trace holds no range {name!r}")


def _intervals(ops: Iterable[dict]) -> List[Interval]:
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in ops]


def busy_and_window_s(events: List[dict]) -> Tuple[float, float]:
    """(seconds in which a device operation ran within the traced window,
    the window's length in seconds)."""
    lo, hi = window(events)
    return clipped_length(_intervals(device_ops(events)), lo, hi) / 1e6, (hi - lo) / 1e6


def idle_share(events: List[dict]) -> float:
    busy, length = busy_and_window_s(events)
    return 1.0 - busy / length


def idle_share_percent(run) -> Optional[float]:
    """The reader of every cell's ``idle_share.<kind>`` metric: the traced
    window's idle share in percent; None without a card's trace."""
    if run.events is None or run.device.type != "cuda":
        return None
    return 100.0 * idle_share(run.events)


def range_device_s(events: List[dict], name: str) -> Optional[float]:
    """Device seconds of the operations launched inside the host ranges
    called ``name``: each operation is tied to its launch by the trace's
    correlation id, and the launch's time must lie in one of the ranges.
    None when the trace has no such range."""
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") == name]
    if not ranges:
        return None
    ranges.sort()
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launches[corr] = float(e["ts"])

    starts = [lo for lo, _ in ranges]

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ranges[i][1]

    ops = [e for e in device_ops(events)
           if inside(launches.get((e.get("args") or {}).get("correlation"), -1.0))]
    return clipped_length(_intervals(ops), -float("inf"), float("inf")) / 1e6


def _spans(events: Iterable[dict]) -> List[Tuple[float, float, str]]:
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX)
            and e.get("name") != WINDOW]


def breakdown(events: List[dict]) -> Dict[str, list]:
    """The window's device operations that took most time, summed by name,
    and its longest idle gaps, each named by the innermost benchmark span
    the host was in at the gap's middle ("window" outside every span)."""
    lo, hi = window(events)
    by_name: Dict[str, float] = {}
    ops = [e for e in device_ops(events) if lo <= float(e["ts"]) <= hi]
    for e in ops:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) / 1e6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    busy = merged(_intervals(ops))
    gaps, t = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > t:
            gaps.append((t, min(a, hi)))
        t = max(t, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    spans = _spans(events)
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        around = [s for s in spans if s[0] <= mid <= s[1]]
        label = min(around, key=lambda s: s[1] - s[0])[2] if around else "window"
        named.append([label[len(SPAN_PREFIX):] if label != "window" else label, (b - a) / 1e6])
    return {"device_ops": [[n, s] for n, s in top_ops], "idle_gaps": named}
