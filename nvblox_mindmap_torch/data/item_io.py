"""Reading and writing dataset items without imageio, PIL or zstandard.

The port's counterpart of the JAX package's item readers
(``nvblox_mindmap_tpu/data/dataset.py:81-117``, ``unpickle_zst`` /
``pickle_zst`` / ``_load_item``, and ``runtime/native.py:89-141``,
``decode_png``), which go through ``zstandard``, ``imageio`` or a
libzstd / libpng C++ library. The port uses only what a machine with
PyTorch has besides:

- **PNG** (8-bit gray, gray + alpha, RGB, RGBA; 16-bit gray, the depth
  images): chunks parsed here, the image data inflated with Python's
  ``zlib``, and the scanline filters undone by ``csrc/png_unfilter.c``,
  built with the system C compiler at first use (every PNG filter but
  None and Up is a serial walk along the row). The writer emits the Up
  filter on every row, which numpy computes whole.
- **zstd**: the system ``libzstd.so.1`` through ``ctypes``. Frames written
  by ``zstandard``'s stream writer carry no content size, so reading runs
  libzstd's streaming decompressor over the first frame, as ``zstandard``'s
  ``stream_reader`` does; writing is one ``ZSTD_compress`` call.
- **Pickles** of vertex features are read by an unpickler that resolves
  only numpy's array reconstruction and a few builtin types: an item file
  cannot run code.

No reader falls back to another: an unsupported PNG, a corrupt file or a
missing library raises, naming what is wrong.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import io
import os
import pickle
import struct
import zlib
from typing import Any, Dict, Optional

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (palette images are not read).
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_CHANNELS_PNG = {1: 0, 2: 4, 3: 2, 4: 6}
ZSTD_LIBRARY = "libzstd.so.1"
ZSTD_LEVEL = 1  # the JAX package's pickle_zst level


# ---------------------------------------------------------------- PNG


def _unfilter():
    from nvblox_mindmap_torch.ops import _build

    fn = _build.load_host("png_unfilter").png_unfilter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


_UNFILTER = None


def decode_png_bytes(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A PNG's pixels: (H, W) for gray, else (H, W, C); uint8, or uint16 for
    16-bit gray (the values as written, native byte order)."""
    global _UNFILTER
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{name}: truncated {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{name}: no IHDR or IDAT chunk")
    width, height, depth, color, _, _, interlace = header
    channels = _PNG_CHANNELS.get(color)
    if channels is None or interlace != 0 or depth not in (8, 16) or (depth == 16 and
                                                                      channels != 1):
        raise NotImplementedError(
            f"{name}: PNG colour type {color}, bit depth {depth}, interlace "
            f"{interlace} is not read (8-bit gray / gray+alpha / RGB / RGBA and "
            "16-bit gray, not interlaced)")
    bpp = channels * depth // 8
    rowbytes = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (rowbytes + 1):
        raise ValueError(f"{name}: {len(raw)} bytes of image data, expected "
                         f"{height * (rowbytes + 1)}")
    out = np.empty((height, rowbytes), np.uint8)
    if _UNFILTER is None:
        _UNFILTER = _unfilter()
    bad_row = _UNFILTER(raw, out.ctypes.data, height, rowbytes, bpp)
    if bad_row:
        raise ValueError(f"{name}: row {bad_row - 1} has an unknown filter type")
    if depth == 16:
        pixels = out.view(">u2").astype(np.uint16).reshape(height, width)
    else:
        pixels = out.reshape(height, width, channels)
        if channels == 1:
            pixels = pixels[..., 0]
    return pixels


def decode_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png_bytes(f.read(), path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png_bytes(image: np.ndarray, compress_level: int = 6) -> bytes:
    """uint8 (H, W) / (H, W, 2|3|4) or uint16 (H, W) -> PNG bytes, every row
    Up-filtered."""
    image = np.asarray(image)
    if image.dtype == np.uint16 and image.ndim == 2:
        depth, rows = 16, image.astype(">u2").view(np.uint8).reshape(image.shape[0], -1)
        channels = 1
    elif image.dtype == np.uint8 and image.ndim in (2, 3):
        depth = 8
        channels = 1 if image.ndim == 2 else image.shape[2]
        rows = image.reshape(image.shape[0], -1)
    else:
        raise TypeError(f"PNG images are uint8 (H, W[, C]) or uint16 (H, W), got "
                        f"{image.dtype} {image.shape}")
    if channels not in _CHANNELS_PNG:
        raise ValueError(f"PNG images have 1-4 channels, got {channels}")
    height, width = image.shape[:2]
    filtered = np.empty((height, rows.shape[1] + 1), np.uint8)
    filtered[:, 0] = 2  # Up
    filtered[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=filtered[1:, 1:])  # wraps mod 256
    header = struct.pack(">IIBBBBB", width, height, depth, _CHANNELS_PNG[channels], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), compress_level))
            + _chunk(b"IEND", b""))


def encode_png(path: str, image: np.ndarray, compress_level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png_bytes(image, compress_level))


# ---------------------------------------------------------------- zstd


class _Buffer(ctypes.Structure):
    # ZSTD_inBuffer / ZSTD_outBuffer: {pointer, size, pos}
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


_ZSTD = None


def _zstd():
    global _ZSTD
    if _ZSTD is None:
        try:
            lib = ctypes.CDLL(ZSTD_LIBRARY)
        except OSError:
            found = ctypes.util.find_library("zstd")
            if found is None:
                raise RuntimeError(
                    f"{ZSTD_LIBRARY} (the zstd system library) was not found: it "
                    "reads and writes the .zst vertex-feature items") from None
            lib = ctypes.CDLL(found)
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_createDCtx.restype = ctypes.c_void_p
        lib.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Buffer),
                                              ctypes.POINTER(_Buffer)]
        lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        lib.ZSTD_DStreamOutSize.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                      ctypes.c_size_t, ctypes.c_int]
        lib.ZSTD_compress.restype = ctypes.c_size_t
        _ZSTD = lib
    return _ZSTD


def _zstd_check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"{what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def zstd_decompress(data: bytes, name: str = "<bytes>") -> memoryview:
    """The first zstd frame of ``data``, decompressed."""
    lib = _zstd()
    src = ctypes.c_char_p(data)
    inb = _Buffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
    out = bytearray(max(int(lib.ZSTD_DStreamOutSize()), 2 * len(data)))
    done = 0
    dctx = lib.ZSTD_createDCtx()
    try:
        while True:
            view = (ctypes.c_char * (len(out) - done)).from_buffer(out, done)
            outb = _Buffer(ctypes.addressof(view), len(view), 0)
            left = _zstd_check(lib, lib.ZSTD_decompressStream(dctx, outb, inb), name)
            done += outb.pos
            del view  # the bytearray may not grow while a view exports it
            if left == 0:  # the frame is complete
                return memoryview(out)[:done]
            if inb.pos == inb.size and done < len(out):
                raise ValueError(f"{name}: truncated zstd frame")
            if done == len(out):
                out.extend(bytes(len(out)))
    finally:
        lib.ZSTD_freeDCtx(dctx)


def zstd_compress(data: bytes, level: int = ZSTD_LEVEL) -> bytes:
    lib = _zstd()
    cap = lib.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(cap)
    n = _zstd_check(lib, lib.ZSTD_compress(dst, cap, data, len(data), level),
                    "zstd compress")
    return dst.raw[:n]


# ---------------------------------------------------------------- pickles


_SAFE_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"), ("numpy._core.numeric", "_frombuffer"),
}
_SAFE_BUILTINS = {"int", "float", "bool", "complex", "str", "bytes", "bytearray", "tuple",
                  "list", "dict", "set", "frozenset", "slice", "range"}


class ArrayUnpickler(pickle.Unpickler):
    """Resolves numpy's array reconstruction and builtin value types only."""

    def find_class(self, module: str, name: str):
        if (module, name) in _SAFE_GLOBALS or (module == "builtins" and name in _SAFE_BUILTINS):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"item pickles may hold numpy arrays and builtin "
                                     f"values only, not {module}.{name}")


def unpickle_zst(path: str) -> Any:
    with open(path, "rb") as f:
        data = zstd_decompress(f.read(), path)
    return ArrayUnpickler(io.BytesIO(data)).load()


def pickle_zst(obj: Any, path: str) -> None:
    with open(path, "wb") as f:
        f.write(zstd_compress(pickle.dumps(obj)))


# ---------------------------------------------------------------- items


def load_item(path: str):
    """One dataset item as the JAX package's ``_load_item`` gives it: ``.npy``
    and ``.png`` as float32 arrays, ``.zst`` vertex features as a dict of
    float32 ``vertices`` / ``features`` and the int ``channel_length``."""
    ext = os.path.basename(path).split(".")[-1]
    if ext == "npy":
        return np.load(path).astype(np.float32)
    if ext == "png":
        return decode_png(path).astype(np.float32)
    if ext == "zst":
        sample = unpickle_zst(path)
        return {
            "vertices": np.asarray(sample["vertices"], dtype=np.float32),
            "features": np.asarray(sample["features"], dtype=np.float32),
            "channel_length": int(sample["channel_length"]),
        }
    raise ValueError(f"Unsupported item extension: {path}")


def decoder_route() -> Dict[str, Optional[str]]:
    """Which decoders this process uses (for reports)."""
    from nvblox_mindmap_torch.ops import _build

    lib = _zstd()
    return {"png": f"zlib {zlib.ZLIB_RUNTIME_VERSION} + csrc/png_unfilter.c "
                   f"({os.path.basename(_build.library_path('png_unfilter', '.c'))})",
            "zst": f"ctypes {getattr(lib, '_name', ZSTD_LIBRARY)}",
            "pickle": "ArrayUnpickler (numpy arrays and builtins only)"}
