"""Benchmark the zstd decode of a feature-mesh item (reference:
scripts/benchmark_decompression.py).

Port of ``nvblox_mindmap_tpu/scripts/benchmark_decompression.py``, on the
port's own zstd route (``data/item_io.py``: the system ``libzstd.so.1``
through ctypes; no ``zstandard`` module). The dataset's hot loop decodes one
zstd-pickled vertex dict per sample; this measures the ratio and the decode
time per compression level at a given size::

    python -m nvblox_mindmap_torch.scripts.benchmark_decompression \\
        --n_vertices 2048 --channels 768
"""
from __future__ import annotations

import argparse
import io
import pickle
import time

import numpy as np

from nvblox_mindmap_torch.data.item_io import ArrayUnpickler, zstd_compress, zstd_decompress


def benchmark(n_vertices: int = 2048, channels: int = 768, levels=(1, 3, 9),
              repeats: int = 20):
    rng = np.random.default_rng(0)
    payload = {
        "vertices": rng.normal(size=(n_vertices, 3)).astype(np.float16),
        "features": rng.normal(size=(n_vertices, channels)).astype(np.float16),
        "channel_length": channels,
    }
    raw = pickle.dumps(payload)
    results = {}
    for level in levels:
        blob = zstd_compress(raw, level=level)
        t0 = time.perf_counter()
        for _ in range(repeats):
            ArrayUnpickler(io.BytesIO(zstd_decompress(blob))).load()
        dt = (time.perf_counter() - t0) / repeats
        results[level] = {
            "compressed_mb": len(blob) / 1e6,
            "ratio": len(raw) / len(blob),
            "decode_ms": dt * 1000,
            "decode_gbps": len(raw) / dt / 1e9,
        }
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_vertices", type=int, default=2048)
    parser.add_argument("--channels", type=int, default=768)
    args = parser.parse_args(argv)
    results = benchmark(args.n_vertices, args.channels)
    for level, stats in results.items():
        print(
            f"level {level}: {stats['compressed_mb']:.2f} MB "
            f"(x{stats['ratio']:.2f}), {stats['decode_ms']:.2f} ms, "
            f"{stats['decode_gbps']:.2f} GB/s"
        )
    return results


if __name__ == "__main__":
    main()
