"""Dataset comparison (upstream: tests/utils/comparisons.py).

The port's own copy of ``nvblox_mindmap_tpu/data/comparisons.py``:
``datasets_are_close`` compares two demo directories item by item within a
tolerance (upstream pins generated datasets against stored baselines with
it; here it also serves datagen regression checks). Items are read through
the port's own readers (``data/item_io``: PNG without imageio, zstd
pickles without zstandard).
"""
from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

from nvblox_mindmap_torch.data.item_io import decode_png, unpickle_zst


def _compare_arrays(a, b, rtol, atol) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    return np.allclose(a.astype(np.float64), b.astype(np.float64), rtol=rtol,
                       atol=atol)


def compare_item(path_a: str, path_b: str, rtol: float, atol: float) -> bool:
    ext = path_a.rsplit(".", 1)[-1]
    if ext == "npy":
        return _compare_arrays(np.load(path_a), np.load(path_b), rtol, atol)
    if ext == "png":
        return _compare_arrays(decode_png(path_a), decode_png(path_b), rtol, atol)
    if ext == "zst":
        a, b = unpickle_zst(path_a), unpickle_zst(path_b)
        if a["channel_length"] != b["channel_length"]:
            return False
        return _compare_arrays(a["vertices"], b["vertices"], rtol, atol) and (
            _compare_arrays(a["features"], b["features"], rtol, atol)
        )
    # Unknown item: byte equality.
    with open(path_a, "rb") as fa, open(path_b, "rb") as fb:
        return fa.read() == fb.read()


def datasets_are_close(
    demo_dir_a: str,
    demo_dir_b: str,
    rtol: float = 1e-4,
    atol: float = 1e-3,
) -> Tuple[bool, List[str]]:
    """Compare two demo dirs item-by-item; returns (close, mismatched items)."""
    names_a = sorted(os.path.basename(p) for p in glob.glob(f"{demo_dir_a}/*"))
    names_b = sorted(os.path.basename(p) for p in glob.glob(f"{demo_dir_b}/*"))
    mismatches: List[str] = []
    if names_a != names_b:
        missing = set(names_a).symmetric_difference(names_b)
        mismatches.extend(sorted(missing))
    for name in sorted(set(names_a) & set(names_b)):
        if not compare_item(
            os.path.join(demo_dir_a, name), os.path.join(demo_dir_b, name),
            rtol, atol,
        ):
            mismatches.append(name)
    return len(mismatches) == 0, mismatches
