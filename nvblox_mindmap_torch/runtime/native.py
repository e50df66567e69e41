"""The item decoder's API, on the port's own decoder.

Port of ``nvblox_mindmap_tpu/runtime/native.py``, whose functions bind a
C++ library built against libzstd and libpng (``runtime/decoder.cpp``). A
machine with PyTorch need not have libpng, so the port does not build that
library: the same functions run on ``data/item_io.py`` (PNG chunks inflated
with ``zlib`` and unfiltered by ``csrc/png_unfilter.c``, zstd through the
system ``libzstd.so.1``, pickles through a numpy-only unpickler).

The port's own modules call ``data/item_io.py`` directly; this module is
the JAX package's decoder API for code written against it (and the thread
pool of ``decode_png_batch``). Its ``decode_png`` and ``decode_zstd_pickle``
are item_io's functions themselves, not copies, so the two surfaces cannot
drift apart.

``decode_png_batch`` decodes on a pool of threads: the file reads,
``zlib.decompress`` and the ctypes unfilter release the GIL. As in the JAX
package it gives None for a missing or corrupt entry and leaves the entries
around it intact. Nothing falls back to another decoder: a missing library
or compiler raises, naming it.
"""
from __future__ import annotations

import concurrent.futures
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np

from nvblox_mindmap_torch.data import item_io
from nvblox_mindmap_torch.ops import _build

# What a missing, truncated or corrupt PNG raises in item_io.
_BAD_ENTRY = (OSError, ValueError, NotImplementedError, zlib.error, struct.error)


def ensure_built(force: bool = False) -> bool:
    """Build the PNG unfilter (``csrc/png_unfilter.c``) into the package's
    ``build/`` unless it is built, or again with ``force``. Returns True;
    a missing C compiler or a failed build raises."""
    _build.build_host("png_unfilter", force=force)
    return True


def native_available() -> bool:
    """Whether libzstd and the PNG unfilter load in this process."""
    try:
        item_io._zstd()
        _build.load_host("png_unfilter")
    except (RuntimeError, OSError):
        return False
    return True


# A zstd-compressed pickle of numpy arrays and builtin values.
decode_zstd_pickle = item_io.unpickle_zst
# A PNG as (H, W[, C]) uint8, or uint16 for 16-bit gray (depth).
decode_png = item_io.decode_png


def _decode_or_none(path: str) -> Optional[np.ndarray]:
    try:
        return item_io.decode_png(path)
    except _BAD_ENTRY:
        return None


def decode_png_batch(paths: Sequence[str], n_threads: int = 4
                     ) -> List[Optional[np.ndarray]]:
    """Decode many PNGs on ``n_threads`` threads, in order.

    Returns None for entries that could not be decoded (missing or corrupt
    files); valid entries around them are unaffected.
    """
    _build.load_host("png_unfilter")  # a missing compiler raises here, once
    if n_threads <= 1 or len(paths) <= 1:
        return [_decode_or_none(p) for p in paths]
    with concurrent.futures.ThreadPoolExecutor(min(n_threads, len(paths))) as pool:
        return list(pool.map(_decode_or_none, paths))
