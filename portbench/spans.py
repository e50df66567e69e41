"""Readings of the program's own spans in a traced run's Chrome trace, and
the split of a traced window's device-idle time by those spans.

The port names its phases with ``nvblox_mindmap_torch.utils.timers.span``:
``record_function`` ranges called ``mindmap/<path>`` (``user_annotation``
events), which never wait for the device. A child span lies inside its
parent in time on the thread that opens both. A device operation
(``idle.DEVICE_CATS``) belongs to the spans its launch lay in, tied to the
launch by the trace's correlation id. Times in the trace are microseconds;
the readers give milliseconds.

    python3 -m portbench.spans --workload <cell> --seed <n> [--seconds <s>] [--units <n>]

from the root of a checkout makes one traced run of a cell on the card
(``--units`` units traced, the traffic's ``trace_units`` without it) and
prints its ``idle_split`` as one JSON line; it checks no output.
"""
from __future__ import annotations

import bisect
import json
import sys
from typing import Dict, Iterable, List, Optional

from portbench import idle

PREFIX = "mindmap/"
# The runtime calls by which the host waits for the card. cudaDeviceSynchronize
# is left out: only the benchmark's own spans and units call it.
SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy")
# The split's name for idle time while the host was outside every span.
OUTSIDE = "outside"


def on_card(run) -> bool:
    """Whether ``run`` holds a card's trace (the readers give None otherwise)."""
    return run.events is not None and run.device.type == "cuda"


def ranges(events: Iterable[dict], name: str) -> List[idle.Interval]:
    """Sorted (start, end) of every span ``PREFIX + name``."""
    full = PREFIX + name
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") == full)


def _container(spans: List[idle.Interval]):
    """A function of (start, end) that tells whether one of the sorted,
    disjoint ``spans`` holds that interval."""
    starts = [lo for lo, _ in spans]

    def holds(lo: float, hi: float) -> bool:
        i = bisect.bisect_right(starts, lo) - 1
        return i >= 0 and hi <= spans[i][1]

    return holds


def within(events: List[dict], name: str, parent: str) -> List[idle.Interval]:
    """The spans ``name`` that lie inside a span ``parent``."""
    holds = _container(ranges(events, parent))
    return [(lo, hi) for lo, hi in ranges(events, name) if holds(lo, hi)]


def per(total: float, count: int) -> Optional[float]:
    return total / count if count else None


def mean_ms(events: List[dict], name: str) -> Optional[float]:
    """Mean host duration of the spans ``name``."""
    spans = ranges(events, name)
    return per(sum(hi - lo for lo, hi in spans) / 1e3, len(spans))


def child_ms_per(events: List[dict], name: str, parent: str) -> Optional[float]:
    """Host ms of the spans ``name`` inside the spans ``parent``, per
    ``parent``."""
    total = sum(hi - lo for lo, hi in within(events, name, parent))
    return per(total / 1e3, len(ranges(events, parent)))


def self_ms_per(events: List[dict], parent: str, children: Iterable[str]) -> Optional[float]:
    """Host ms per span ``parent`` outside its spans ``children``."""
    outer = ranges(events, parent)
    total = sum(hi - lo for lo, hi in outer)
    for child in children:
        total -= sum(hi - lo for lo, hi in within(events, child, parent))
    return per(total / 1e3, len(outer))


def launched_ops(events: List[dict], name: str) -> List[dict]:
    """The device operations launched inside a span ``name``."""
    holds = _container(ranges(events, name))
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in idle.LAUNCH_CATS and corr is not None:
            launches[corr] = float(e["ts"])
    out = []
    for e in idle.device_ops(events):
        t = launches.get((e.get("args") or {}).get("correlation"))
        if t is not None and holds(t, t):
            out.append(e)
    return out


def launches_per(events: List[dict], name: str) -> Optional[float]:
    """Device operations launched per span ``name``."""
    return per(float(len(launched_ops(events, name))), len(ranges(events, name)))


def device_ms_per(events: List[dict], name: str) -> Optional[float]:
    """Device ms (the union of the operations' intervals) of the operations
    launched inside the spans ``name``, per span."""
    busy = idle.merged((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in launched_ops(events, name))
    return per(sum(hi - lo for lo, hi in busy) / 1e3, len(ranges(events, name)))


def syncs_per(events: List[dict], parent: str) -> Optional[float]:
    """Host waits on the card (``SYNCS``) issued inside the spans
    ``parent``, per span."""
    outer = ranges(events, parent)
    holds = _container(outer)
    calls = [e for e in events if e.get("cat") == "cuda_runtime" and e.get("name") in SYNCS
             and holds(float(e["ts"]), float(e["ts"]))]
    return per(float(len(calls)), len(outer))


def idle_split(events: List[dict]) -> Dict[str, float]:
    """Seconds of device-idle time in the traced window (``idle.WINDOW``)
    by the innermost span the host was in: the shortest ``mindmap/`` span
    that holds the instant, named without ``PREFIX``; ``OUTSIDE`` where the
    host was in none."""
    lo, hi = idle.window(events)
    busy = idle.merged((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in idle.device_ops(events))
    gaps, t = [], lo
    for a, b in busy + [(hi, hi)]:
        if min(a, hi) > t:
            gaps.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(PREFIX):])
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith(PREFIX))
    marks = sorted({lo, hi} | {x for s in spans for x in s[:2] if lo < x < hi})
    gap_ends = [b for _, b in gaps]
    split: Dict[str, float] = {}
    active, nxt = [], 0
    for a, b in zip(marks, marks[1:]):
        while nxt < len(spans) and spans[nxt][0] <= a:
            active.append(spans[nxt])
            nxt += 1
        active = [s for s in active if s[1] > a]
        label = min(active, key=lambda s: s[1] - s[0])[2] if active else OUTSIDE
        i = bisect.bisect_right(gap_ends, a)
        while i < len(gaps) and gaps[i][0] < b:
            split[label] = split.get(label, 0.0) + (min(gaps[i][1], b)
                                                    - max(gaps[i][0], a)) / 1e6
            i += 1
    return split


def main() -> int:
    import argparse

    import portbench.run  # noqa: F401 (the benchmark's environment: caches, host threads)

    parser = argparse.ArgumentParser(description="One traced run's device-idle split by span")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--units", type=int, default=None)
    args = parser.parse_args()

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(portbench.run.HOST_THREADS)
    overrides = {} if args.units is None else {"traffic": {"trace_units": args.units}}
    run, driver, state, _ = harness.prepare(args.workload, args.seed, args.seconds, True,
                                            torch.device("cuda", 0), portbench.run.START,
                                            overrides)
    harness.measure(run, driver, state)
    split = idle_split(run.events)
    busy, length = idle.busy_and_window_s(run.events)
    idle_s = sum(split.values())
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "units": run.traffic["trace_units"],
        "window_s": length, "idle_share": 1.0 - busy / length, "idle_s": idle_s,
        "split_percent": {k: 100.0 * v / idle_s for k, v in
                          sorted(split.items(), key=lambda kv: -kv[1])}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
