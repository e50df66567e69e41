"""Checkpoints (torch), with the JAX package's reproducibility contract.

Port of ``nvblox_mindmap_tpu/training/checkpoint.py``:

- ``best.ckpt`` / ``last.ckpt`` hold the model's ``state_dict``, the
  optimizer's state, ``iter`` and ``best_loss``, written with ``torch.save``
  to a temporary file and renamed into place. ``last.ckpt`` records the
  running best, so a later worse evaluation cannot replace ``best.ckpt``
  after a resume. Reading takes tensors only (``weights_only=True``).
- ``training_args.json`` freezes the run's arguments beside them.

``read_jax_checkpoint`` reads a checkpoint of the JAX package: an outer
pickle of plain values whose ``params`` field holds the flax parameter tree
in flax's msgpack encoding. A small msgpack decoder here reads it (neither
flax nor the ``msgpack`` package is needed) and returns the nested dict of
numpy arrays that ``flax.serialization.msgpack_restore`` returns, ready for
``models.weights.load_flax_params``; ``msgpack_serialize`` writes the bytes
that ``flax.serialization.msgpack_serialize`` writes for such a tree.
``read_params_tree`` gives the flax tree of either package's checkpoint
file (the port's through ``models.weights.state_dict_to_flax``). ``read_jax_opt_state`` reads its
``opt_state`` field, a pickle of optax's state objects, without optax: a
restricted unpickler maps each optax state class onto a plain stand-in of
the same fields (``ScaleByAdamState``, ``ScaleByScheduleState``,
``MaskedState``, ``EmptyState``, ``MultiStepsState``, ``MaskedNode``),
resolves numpy's array reconstruction and refuses every other global.
``training.optimizer.Optimizer.load_optax_state`` takes the Adam moments,
the update count and a pending accumulation from it. Only unpickle
checkpoints this project wrote: the outer pickle is read as it is.
"""
from __future__ import annotations

import collections
import io
import json
import os
import pickle
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from nvblox_mindmap_torch.data.item_io import ArrayUnpickler

TRAINING_ARGUMENT_FILE_NAME = "training_args.json"


def save_checkpoint_file(path: str, state_dict: Dict[str, torch.Tensor],
                         optimizer_state: Dict[str, Any], step: int,
                         loss: Optional[float]) -> None:
    payload = {
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
        "optimizer": optimizer_state,
        "iter": int(step),
        "best_loss": None if loss is None else float(loss),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint_file(path: str, map_location: Any = "cpu") -> Dict[str, Any]:
    """{"state_dict", "optimizer", "iter", "best_loss"} of a port checkpoint."""
    return torch.load(path, map_location=map_location, weights_only=True)


def save_checkpoint(
    checkpoint_dir: str,
    state_dict: Dict[str, torch.Tensor],
    optimizer_state: Dict[str, Any],
    step: int,
    new_loss: Optional[float],
    best_loss: Optional[float],
) -> Optional[float]:
    """Save last.ckpt always; best.ckpt when the loss improves. Returns the
    updated best loss."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    if new_loss is not None and (best_loss is None or new_loss <= best_loss):
        best_loss = new_loss
        save_checkpoint_file(os.path.join(checkpoint_dir, "best.ckpt"), state_dict,
                             optimizer_state, step, best_loss)
    save_checkpoint_file(os.path.join(checkpoint_dir, "last.ckpt"), state_dict,
                         optimizer_state, step, best_loss)
    return best_loss


def save_training_args(checkpoint_dir: str, args_dict: Dict) -> None:
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, TRAINING_ARGUMENT_FILE_NAME)
    with open(path, "w") as f:
        json.dump(args_dict, f, indent=2, default=str)


def load_training_args(checkpoint_path: str) -> Optional[Dict]:
    """Given a checkpoint file path, load the sibling frozen args if present."""
    args_path = os.path.join(os.path.dirname(checkpoint_path), TRAINING_ARGUMENT_FILE_NAME)
    if not os.path.isfile(args_path):
        return None
    with open(args_path) as f:
        return json.load(f)


def is_jax_checkpoint(path: str) -> bool:
    """A port checkpoint is a zip archive (``torch.save``); the JAX
    package's is a bare pickle."""
    with open(path, "rb") as f:
        return f.read(4) != b"PK\x03\x04"


def read_jax_checkpoint(path: str) -> Tuple[Dict[str, Any], int, Optional[float]]:
    """(flax params tree, iter, best_loss) of a JAX package ``.ckpt``."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return msgpack_restore(payload["params"]), payload["iter"], payload["best_loss"]


def read_params_tree(path: str) -> Dict[str, Any]:
    """The flax parameter tree of a checkpoint file of either package."""
    if is_jax_checkpoint(path):
        return read_jax_checkpoint(path)[0]
    from nvblox_mindmap_torch.models.weights import state_dict_to_flax

    return state_dict_to_flax(load_checkpoint_file(path)["state_dict"])


# Plain stand-ins for optax's state classes (NamedTuples in optax, pickled
# as the class and its fields), by class name.
OPTAX_STATES = {
    name: collections.namedtuple(name, fields)
    for name, fields in (
        ("ScaleByAdamState", ("count", "mu", "nu")),
        ("ScaleByScheduleState", ("count",)),
        ("MaskedState", ("inner_state",)),
        ("EmptyState", ()),
        ("MaskedNode", ()),
        ("MultiStepsState", ("mini_step", "gradient_step", "inner_opt_state", "acc_grads",
                             "skip_state")),
    )
}


class _OptaxStateUnpickler(ArrayUnpickler):
    """numpy arrays, builtin values and optax's state classes, as stand-ins."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] == "optax":
            if name in OPTAX_STATES:
                return OPTAX_STATES[name]
            raise pickle.UnpicklingError(f"optax state class {module}.{name} is not read")
        return super().find_class(module, name)


def read_jax_opt_state(path: str) -> Optional[Any]:
    """The optax state of a JAX package ``.ckpt`` as a tree of the
    ``OPTAX_STATES`` stand-ins and numpy arrays; None when the file holds
    none (the committed fixtures pickle ``None``)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return _OptaxStateUnpickler(io.BytesIO(payload["opt_state"])).load()


# ---------------------------------------------------------------- msgpack
# The subset of msgpack that flax writes: nil, bools, ints, floats, str,
# bin, arrays, maps, and ext types 1 (ndarray), 2 (complex), 3 (numpy
# scalar), each of whose payloads is itself msgpack.

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _decode(data: bytes, pos: int) -> Tuple[Any, int]:
    b = data[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _decode_map(data, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _decode_array(data, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return data[pos:pos + n].decode(), pos + n
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    sized = {0xC4: 1, 0xC5: 2, 0xC6: 4, 0xD9: 1, 0xDA: 2, 0xDB: 4,
             0xDC: 2, 0xDD: 4, 0xDE: 2, 0xDF: 4, 0xC7: 1, 0xC8: 2, 0xC9: 4}
    if b in sized:
        width = sized[b]
        n = int.from_bytes(data[pos:pos + width], "big")
        pos += width
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(data[pos:pos + n]), pos + n
        if b in (0xD9, 0xDA, 0xDB):
            return data[pos:pos + n].decode(), pos + n
        if b in (0xDC, 0xDD):
            return _decode_array(data, pos, n)
        if b in (0xDE, 0xDF):
            return _decode_map(data, pos, n)
        return _ext(data[pos], data[pos + 1:pos + 1 + n]), pos + 1 + n
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
             0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
        fmt = fixed[b]
        n = struct.calcsize(fmt)
        return struct.unpack_from(fmt, data, pos)[0], pos + n
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        n = fixext[b]
        return _ext(data[pos], data[pos + 1:pos + 1 + n]), pos + 1 + n
    raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at {pos - 1}")


def _decode_array(data: bytes, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        item, pos = _decode(data, pos)
        out.append(item)
    return out, pos


def _decode_map(data: bytes, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        key, pos = _decode(data, pos)
        out[key], pos = _decode(data, pos)
    return out, pos


def _unpack(data: bytes) -> Any:
    value, end = _decode(data, 0)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} trailing bytes")
    return value


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _unpack(data)
    if dtype_name == "bfloat16":
        raise NotImplementedError("bfloat16 arrays in a flax checkpoint are not read")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape, order="C")


def _ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        real, imag = _unpack(data)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack: unknown ext type {code}")


# flax.serialization.MAX_CHUNK_SIZE: flax writes larger arrays in chunks.
MAX_CHUNK_SIZE = 2 ** 30


def _unchunk(tree: Any) -> Any:
    """flax writes arrays over ``MAX_CHUNK_SIZE`` bytes as
    {"__msgpack_chunked_array__", "shape", "chunks"} dicts (tuples as
    {"0": ..., "1": ...})."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        def as_tuple(d):
            return tuple(d[str(i)] for i in range(len(d)))

        return np.concatenate(as_tuple(tree["chunks"])).reshape(as_tuple(tree["shape"]))
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(encoded: bytes) -> Any:
    """What ``flax.serialization.msgpack_restore`` returns for ``encoded``."""
    return _unchunk(_unpack(encoded))


def _encode(obj: Any, out: bytearray) -> None:
    """msgpack, as the ``msgpack`` package packs with ``use_bin_type`` and
    flax's ext hook (arrays: ext 1, numpy scalars: ext 3)."""
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(obj + 0x100)
        elif obj >= 0:
            for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                   (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
                if obj <= top:
                    out += bytes([code]) + struct.pack(fmt, obj)
                    break
        else:
            for code, fmt, low in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                                   (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
                if obj >= low:
                    out += bytes([code]) + struct.pack(fmt, obj)
                    break
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode()
        _header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _header(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _encode(item, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        # flax copies the tree with jax's sorted keys, then builds the
        # chunked form of large arrays in its own order.
        for key in obj if isinstance(obj, _InOrder) else sorted(obj):
            _encode(key, out)
            _encode(obj[key], out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        array = np.asarray(obj)
        if array.dtype.hasobject or array.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not serialized")
        payload = bytearray()
        _encode((array.shape, array.dtype.name, array.tobytes("C")), payload)
        _encode_ext(out, _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR,
                    payload)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def _header(out: bytearray, n: int, fix: Optional[int], fix_limit: int, codes) -> None:
    """A length header: the fix form below ``fix_limit``, else 8 / 16 / 32 bits."""
    if fix is not None and n < fix_limit:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} is too large")


def _encode_ext(out: bytearray, code: int, payload: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixed:
        out.append(fixed[len(payload)])
    else:
        _header(out, len(payload), None, 0, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += payload


class _InOrder(dict):
    """A dict that ``_encode`` writes in insertion order."""


def _chunk(array: np.ndarray) -> _InOrder:
    """flax's chunked form of ``array``: its flat elements in runs of
    ``MAX_CHUNK_SIZE`` bytes (tuples as {"0": ..., "1": ...})."""
    def as_dict(items):
        return _InOrder((str(i), item) for i, item in enumerate(items))

    size = max(1, int(MAX_CHUNK_SIZE / array.dtype.itemsize))
    flat = array.reshape(-1)
    return _InOrder((("__msgpack_chunked_array__", True), ("shape", as_dict(array.shape)),
                     ("chunks", as_dict(flat[i:i + size] for i in range(0, flat.size, size)))))


def _chunk_leaves(tree: Any) -> Any:
    """The arrays over ``MAX_CHUNK_SIZE`` bytes in their chunked form where
    flax chunks them: the tree itself and the values of dicts (an array in
    a list is written whole)."""
    if isinstance(tree, np.ndarray):
        return _chunk(tree) if tree.nbytes > MAX_CHUNK_SIZE else tree
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) if isinstance(v, (dict, np.ndarray)) else v
                for k, v in tree.items()}
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """What ``flax.serialization.msgpack_serialize`` writes for ``tree``
    (nested dicts of numpy arrays and Python values; dict keys sorted, as
    flax's copy of the tree sorts them; arrays over ``MAX_CHUNK_SIZE``
    bytes in flax's chunked form)."""
    out = bytearray()
    _encode(_chunk_leaves(tree), out)
    return bytes(out)
