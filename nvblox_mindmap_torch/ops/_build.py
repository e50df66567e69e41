"""Build and load the package's CUDA kernels (``csrc/*.cu``) with nvcc, and
its host C helpers (``csrc/*.c``) with the system C compiler.

Each source compiles on its own into a shared library with a plain C
interface, which ``ctypes`` loads. Libraries land in ``build/`` beside the
package (listed in ``.gitignore``), named by a hash of their source, so an
edited kernel never loads a stale build. Nothing here runs at import time:
the first launch of a kernel builds it, or ``build_all`` builds every kernel
at once (one nvcc process each, started together); ``load_host`` builds a
host helper at its first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, List, Tuple

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LOADED: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from csrc/ at first "
            "use and need the CUDA toolkit"
        )
    return nvcc


def find_cc() -> str:
    for cc in (os.environ.get("CC"), "cc", "gcc"):
        if cc and shutil.which(cc):
            return shutil.which(cc)
    raise RuntimeError(
        "no C compiler (cc or gcc) found: the host helpers are built from "
        "csrc/*.c at first use"
    )


def library_path(name: str, ext: str = ".cu") -> str:
    with open(os.path.join(CSRC_DIR, name + ext), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start_build(name: str) -> Tuple[subprocess.Popen, str]:
    """Start nvcc for one kernel, writing to a temporary file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_build(name: str, started: Tuple[subprocess.Popen, str],
                  ext: str = ".cu") -> str:
    proc, tmp = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{'nvcc' if ext == '.cu' else 'cc'} failed for "
                           f"csrc/{name}{ext}:\n{out}")
    os.replace(tmp, library_path(name, ext))
    return out


def build_all() -> Dict[str, str]:
    """Build every kernel that is not built yet, in parallel.

    Returns nvcc's output (register and shared-memory use) per kernel built.
    """
    procs = {n: _start_build(n) for n in kernel_names()
             if not os.path.exists(library_path(n))}
    return {n: _finish_build(n, p) for n, p in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(path)
        _LOADED[name] = lib
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The host helper ``csrc/{name}.c``'s library, built first if needed."""
    key = name + ".c"
    lib = _LOADED.get(key)
    if lib is None:
        path = library_path(name, ".c")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_cc(), "-O2", "-shared", "-fPIC", "-o", tmp,
                   os.path.join(CSRC_DIR, name + ".c")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            _finish_build(name, (proc, tmp), ".c")
        lib = ctypes.CDLL(path)
        _LOADED[key] = lib
    return lib
