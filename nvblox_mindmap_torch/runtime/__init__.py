"""The item decoder's API (``runtime.native``): PNGs one by one or on a
thread pool, zstd pickles, and the build of its host helper."""
from nvblox_mindmap_torch.runtime.native import (
    decode_png,
    decode_png_batch,
    decode_zstd_pickle,
    ensure_built,
    native_available,
)

__all__ = [
    "decode_png",
    "decode_png_batch",
    "decode_zstd_pickle",
    "ensure_built",
    "native_available",
]
