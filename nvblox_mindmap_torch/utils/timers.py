"""Hierarchical named timers (host clock).

Port of ``nvblox_mindmap_tpu/utils/timers.py``. Timers are named with
'/'-separated paths ("step/train/compute"); the registry accumulates count,
total, last and max and renders an aligned status report.

Device work is asynchronous, so a host clock around it measures the time to
enqueue it. Where the JAX package asks its callers to wait on their arrays,
a ``Timer(name, synchronize=True)`` synchronizes the CUDA device when it
starts and stops, so it measures the work done.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List

import torch


class _TimerRecord:
    __slots__ = ("count", "total", "last", "max", "recent")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.last = 0.0
        self.max = 0.0
        self.recent = collections.deque(maxlen=RECENT)

    def update(self, dt: float):
        self.count += 1
        self.total += dt
        self.last = dt
        self.max = max(self.max, dt)
        self.recent.append(dt)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


RECENT = 1024  # durations kept per timer, for percentiles
_REGISTRY: Dict[str, _TimerRecord] = {}


def _synchronize():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Context manager / manual timer recording into the global registry."""

    def __init__(self, name: str, synchronize: bool = False):
        self.name = name
        self.synchronize = synchronize
        self._start = time.perf_counter()
        self._stopped = False

    def __enter__(self) -> "Timer":
        if self.synchronize:
            _synchronize()
        self._start = time.perf_counter()
        self._stopped = False
        return self

    def stop(self):
        if self._stopped:
            return
        if self.synchronize:
            _synchronize()
        dt = time.perf_counter() - self._start
        _REGISTRY.setdefault(self.name, _TimerRecord()).update(dt)
        self._stopped = True

    def __exit__(self, *exc):
        self.stop()
        return False


def timer_names() -> List[str]:
    return sorted(_REGISTRY)


def timer_samples(name: str) -> List[float]:
    """The last ``RECENT`` durations (seconds) of timer ``name``, oldest first."""
    rec = _REGISTRY.get(name)
    return [] if rec is None else list(rec.recent)


def reset_timers():
    _REGISTRY.clear()


def timer_status_string() -> str:
    lines = ["timer name\tcount\ttotal(s)\tmean(s)\tlast(s)\tmax(s)"]
    for name in timer_names():
        rec = _REGISTRY[name]
        lines.append(
            f"{name}\t{rec.count}\t{rec.total:.4f}\t{rec.mean:.4f}"
            f"\t{rec.last:.4f}\t{rec.max:.4f}"
        )
    return "\n".join(lines)
