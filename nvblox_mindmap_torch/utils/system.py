"""System monitoring helpers: the port's own copy of
``nvblox_mindmap_tpu/utils/system.py`` (upstream
``mindmap/common_utils/system.py``).

The JAX module's ``enable_compilation_cache`` sets XLA's persistent
compilation cache; eager PyTorch compiles nothing ahead, so it has no
counterpart here.
"""
from __future__ import annotations

import os


def get_shmem_usage_mb(path: str = "/dev/shm") -> float:
    """Shared-memory usage in MB (loader-queue monitoring)."""
    try:
        total = 0
        for root, _, files in os.walk(path):
            for fn in files:
                try:
                    total += os.path.getsize(os.path.join(root, fn))
                except OSError:
                    pass
        return total / 1e6
    except OSError:
        return 0.0


def get_process_memory_mb() -> float:
    """Resident memory of this process in MB."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1e3
    except OSError:
        pass
    return 0.0
