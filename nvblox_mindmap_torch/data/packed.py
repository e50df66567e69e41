"""Packed epochs: materialize the real data path once, train card-fed.

Port of ``nvblox_mindmap_tpu/data/packed.py``. At the app's flagship the
streaming loader sets the pace of training from disk: PNG / zstd decode,
keypose windows and back-projection are host work, and a step waits on its
batch most of the time (``PERF.md`` §5). The answer has two halves:

1. **Materialize** (once, host only): run the production loader and write
   its batches to one flat ``.npy`` per key, uncompressed, so that
   ``np.load(mmap_mode="r")`` maps them without a copy. RGB that is exactly
   uint8/255 (the loader's ``RgbTransformer`` output) is packed as uint8;
   every other key keeps the loader's dtype. The files are byte for byte
   those the JAX package writes from the same batches, so either package
   reads the other's epoch.
2. **Stage to the device** (once per run): upload the epoch into device
   memory as whole ``(N, B, ...)`` tensors (one pinned host copy and one
   upload per key) and hand the trainer batch ``i`` as a view of them: no
   host work and no copy per step. uint8 RGB stays uint8 on the card;
   ``prepare_inputs`` divides it by 255 there. With a process group each
   rank stages only its own rows of each batch.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from nvblox_mindmap_torch.parallel.mesh import DataMesh, make_data_mesh

_META = "packed_meta.json"

# Fixed-size .npy 2.0 header (magic 6 + version 2 + len 4 + text 244 = 256
# bytes, a multiple of 64 as the format recommends): the leading dimension
# is unknown until the last batch lands, so the header is written as a
# placeholder and rewritten in place on finalize; its fixed size makes that
# rewrite safe however many digits the final N has.
_HEADER_TEXT_LEN = 244


def _write_npy_header(f, dtype: np.dtype, shape: tuple) -> None:
    text = repr({
        "descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
        "fortran_order": False,
        "shape": tuple(int(s) for s in shape),
    })
    if len(text) >= _HEADER_TEXT_LEN:
        raise ValueError(f"npy header too long: {text}")
    text = text + " " * (_HEADER_TEXT_LEN - len(text) - 1) + "\n"
    f.write(b"\x93NUMPY" + bytes([2, 0]))
    f.write(np.uint32(_HEADER_TEXT_LEN).tobytes())
    f.write(text.encode("latin1"))


def _is_exact_uint8_rgb(key: str, arr: np.ndarray) -> bool:
    """True when the float array is exactly uint8/255 (RgbTransformer output)."""
    if "rgb" not in key or arr.dtype != np.float32:
        return False
    if arr.size == 0 or float(arr.min()) < 0.0 or float(arr.max()) > 1.0:
        return False
    scaled = arr * 255.0
    return bool(np.array_equal(scaled, np.round(scaled)))


def materialize_packed_epoch(
    batches: Iterable[Dict[str, Any]],
    path: str,
    num_batches: Optional[int] = None,
) -> Dict[str, Any]:
    """Write loader batches to a packed-epoch directory.

    ``batches``: any iterable of model-input batch dicts (numpy), all of one
    structure and shape (training loaders drop the tail batch). At most
    ``num_batches`` are written. Returns the metadata (also written to
    ``packed_meta.json``): per key its dtype on disk, whether it is uint8
    RGB and its batch shape; the keys whose value is None; the batch count.
    """
    os.makedirs(path, exist_ok=True)
    writers: Dict[str, Any] = {}
    meta: Dict[str, Any] = {"keys": {}, "none_keys": [], "num_batches": 0}
    shapes: Dict[str, tuple] = {}
    n = 0
    try:
        for batch in batches:
            if num_batches is not None and n >= num_batches:
                break
            for key, value in batch.items():
                if value is None:
                    if n == 0:
                        meta["none_keys"].append(key)
                    elif key not in meta["none_keys"]:
                        raise AssertionError(f"{key} became None mid-epoch")
                    continue
                arr = np.asarray(value)
                if n == 0:
                    rgb_u8 = _is_exact_uint8_rgb(key, arr)
                    meta["keys"][key] = {
                        "dtype": "uint8" if rgb_u8 else str(arr.dtype),
                        "rgb_uint8": rgb_u8,
                        "batch_shape": list(arr.shape),
                    }
                    shapes[key] = arr.shape
                    writers[key] = open(os.path.join(path, f"{key}.npy"), "wb")
                    _write_npy_header(writers[key], meta["keys"][key]["dtype"],
                                      (0,) + arr.shape)
                elif arr.shape != shapes[key]:
                    raise AssertionError(
                        f"{key}: shape {arr.shape} != first batch {shapes[key]} "
                        "(pack training loaders with drop_last=True)")
                if meta["keys"][key]["rgb_uint8"]:
                    # The uint8 decision is made on batch 0; every later batch
                    # must stay on the 1/255 grid or the cast would corrupt it
                    # (np.round(1.2*255) = 306 wraps to 50 as uint8).
                    if n > 0 and not _is_exact_uint8_rgb(key, arr):
                        raise ValueError(
                            f"{key}: batch {n} is not exactly uint8/255 while "
                            "batch 0 was; uint8 rgb packing needs every batch "
                            "on the 1/255 grid (disable photometric transforms "
                            "or pack as float32)")
                    arr = np.round(arr * 255.0).astype(np.uint8)
                writers[key].write(np.ascontiguousarray(arr).tobytes())
            n += 1
    finally:
        for f in writers.values():
            f.close()
    if n == 0:
        raise ValueError("no batches to pack")
    meta["num_batches"] = n
    for key in writers:
        with open(os.path.join(path, f"{key}.npy"), "r+b") as g:
            _write_npy_header(g, meta["keys"][key]["dtype"], (n,) + shapes[key])
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class PackedEpoch:
    """Zero-copy view over a packed-epoch directory (mmap'd .npy per key)."""

    def __init__(self, path: str):
        with open(os.path.join(path, _META)) as f:
            self.meta = json.load(f)
        self.path = path
        self.arrays: Dict[str, np.ndarray] = {
            key: np.load(os.path.join(path, f"{key}.npy"), mmap_mode="r")
            for key in self.meta["keys"]
        }
        for key, arr in self.arrays.items():
            expect = (self.meta["num_batches"],) + tuple(self.meta["keys"][key]["batch_shape"])
            if arr.shape != expect:
                raise ValueError(f"{key}: on-disk shape {arr.shape} != meta {expect}")

    def __len__(self) -> int:
        return int(self.meta["num_batches"])

    def batch(self, i: int, decode_rgb: bool = True) -> Dict[str, Any]:
        """Batch ``i`` as numpy (host) arrays; rgb back to float32 [0,1]."""
        out: Dict[str, Any] = {k: None for k in self.meta["none_keys"]}
        for key, arr in self.arrays.items():
            v = np.asarray(arr[i])
            if decode_rgb and self.meta["keys"][key]["rgb_uint8"]:
                v = v.astype(np.float32) / 255.0
            out[key] = v
        return out


def stage_to_device(
    packed: PackedEpoch,
    indices: Optional[Sequence[int]] = None,
    mesh: Optional[DataMesh] = None,
) -> Dict[str, Any]:
    """Upload packed batches into device memory as (N, B', ...) tensors.

    ``mesh`` (default ``make_data_mesh()``: the card, which must be there)
    names the device and, with a process group, the rank whose rows of each
    batch are staged (B' = B / world size). Per key the batches are copied
    once from the mmap into one host buffer (pinned on CUDA) and uploaded
    in one transfer. uint8 rgb stays uint8.
    """
    mesh = make_data_mesh() if mesh is None else mesh
    idx = np.asarray(indices if indices is not None else range(len(packed)))
    staged: Dict[str, Any] = {k: None for k in packed.meta["none_keys"]}
    for key, arr in packed.arrays.items():
        B = arr.shape[1]
        if B % mesh.world_size:
            raise ValueError(f"{key}: batch of {B} rows does not split into "
                             f"{mesh.world_size} ranks")
        b = B // mesh.world_size
        rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
        host = torch.empty((len(idx), b) + arr.shape[2:],
                           dtype=torch.from_numpy(np.empty(0, arr.dtype)).dtype,
                           pin_memory=mesh.device.type == "cuda")
        out = host.numpy()
        for j, i in enumerate(idx):
            out[j] = arr[i, rows]
        staged[key] = host.to(mesh.device)
    staged["__num_batches__"] = len(idx)
    return staged


class PackedDeviceLoader:
    """A loader over a device-staged packed epoch.

    It has the interface ``Trainer.run_training`` reads (``__len__``,
    ``__iter__``, ``sampler`` = None, ``set_epoch``); its batches are views
    of the staged tensors, so the trainer copies nothing per step.
    Shuffling permutes the batch order per epoch, from
    ``np.random.default_rng([seed, epoch])`` as the JAX package does; the
    composition of each batch is fixed when the epoch is packed.
    """

    sampler = None  # run_training pins the epoch through set_epoch

    def __init__(
        self,
        packed: "PackedEpoch | str",
        mesh: Optional[DataMesh] = None,
        shuffle: bool = True,
        seed: int = 0,
        indices: Optional[Sequence[int]] = None,
    ):
        if isinstance(packed, str):
            packed = PackedEpoch(packed)
        self._staged = stage_to_device(packed, indices=indices, mesh=mesh)
        self._n = self._staged["__num_batches__"]
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return self._n

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle stream to an absolute epoch index, so a resumed
        run replays the orders the uninterrupted run used (plain iteration
        counts epochs itself)."""
        self._epoch = int(epoch)

    def __iter__(self):
        order = np.arange(self._n)
        if self._shuffle:
            order = np.random.default_rng([self._seed, self._epoch]).permutation(self._n)
        self._epoch += 1
        for i in order:
            yield device_batch(self._staged, int(i))


def device_batch(staged: Dict[str, Any], step: int) -> Dict[str, Any]:
    """Batch ``step % N`` as views of the staged tensors (no copy)."""
    i = step % staged["__num_batches__"]
    return {k: (None if v is None else v[i]) for k, v in staged.items()
            if k != "__num_batches__"}
