"""Hierarchical named timers (host clock).

Port of ``nvblox_mindmap_tpu/utils/timers.py``. Timers are named with
'/'-separated paths ("step/train/compute"); the registry accumulates count,
total, last and max and renders an aligned status report.

Device work is asynchronous, so a host clock around it measures the time to
enqueue it. Where the JAX package asks its callers to wait on their arrays,
a ``Timer(name, synchronize=True)`` synchronizes the CUDA device when it
starts and stops, so it measures the work done. ``ProfilerTrace`` records
the device's own timeline.
"""
from __future__ import annotations

import collections
import os
import socket
import time
from typing import Dict, List, Optional

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


def get_last_time(name: str) -> float:
    rec = _REGISTRY.get(name)
    return rec.last if rec else 0.0


def get_mean_time(name: str) -> float:
    rec = _REGISTRY.get(name)
    return rec.mean if rec else 0.0


def get_total_time(name: str) -> float:
    rec = _REGISTRY.get(name)
    return rec.total if rec else 0.0


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


def print_timers():
    print(timer_status_string())


class ProfilerTrace:
    """A ``torch.profiler`` trace of the work inside the context (the
    counterpart of the JAX package's ``jax.profiler`` trace): host
    activity, and the CUDA kernels too where a card is present. On exit it
    writes a Chrome trace (JSON, viewable in Perfetto or chrome://tracing)
    into ``log_dir`` and keeps its path in ``path``. Usage:

        with ProfilerTrace("/tmp/trace") as trace:
            train_step(...)
        print(trace.path)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path: Optional[str] = None
        self._profiler = None

    def __enter__(self) -> "ProfilerTrace":
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._profiler.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(
            self.log_dir, f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json")
        self._profiler.export_chrome_trace(self.path)
        return False
