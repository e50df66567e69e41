"""Asynchronous checkpoint backend (torch): ``--checkpoint_backend orbax``.

The port's counterpart of ``nvblox_mindmap_tpu/training/orbax_checkpoint.py``,
with its contract: ``best/`` and ``last/`` are directories, ``last`` records
the running best, a NaN best loss reads back as None, and a save returns
before the bytes are written (``wait`` blocks until they are). The flag
keeps the name ``orbax`` because the command line is shared with the JAX
app.

It is built on ``torch.distributed.checkpoint``: ``async_save`` copies the
state to host memory and writes it on a background thread, each rank its
own file, into ``<name>.tmp``; once the write has finished (at the next save
or at ``wait``) rank 0 moves it to ``<name>``, so a directory under its own
name is always whole. Every rank enters ``save``, as the JAX package's
collective orbax save; with a process group the checkpointer talks over a
gloo group of its own, so its background collectives never interleave with
the trainer's. ``restore`` loads into the caller's tensors in place.

``restore`` also reads a directory that the JAX package's backend wrote
(orbax's ``PyTreeCheckpointHandler``, which stores each array as a zarr v2
array in an OCDBT key-value store through ``tensorstore``), without
tensorstore: ``read_orbax_tree`` parses the layout in Python, any zstd
through ``data.item_io``'s binding of ``libzstd.so.1``. The layout read:

- ``_METADATA``: JSON, each leaf's tree path (``key_metadata``) and kind
  (an array, a scalar, or an empty value that was not written);
- ``manifest.ocdbt``: the OCDBT manifest (format version 0, one manifest
  file): its config and the versions of the B-tree; the newest version's
  root is read;
- B-tree nodes (magic ``0x0cdb20de``, version 0, zstd or raw) in data files
  under the directory: interior nodes point at children by (file, offset,
  length) and carry a common key prefix per subtree; leaves hold values
  inline or by reference into a data file;
- the keys ``<dotted path>/.zarray`` (zarr v2 JSON: shape, chunks, dtype,
  C order, zstd or no compressor) and ``<dotted path>/<i.j...>`` (chunks).

The params come back through the flax -> torch weight bridge, the optimizer
state (optax's, as the JAX trainer saves it) into the port's optimizer
state, a NaN best loss as None. Anything else in the layout (another OCDBT
version or manifest kind, zarr v3, a codec, filter or dtype not listed, a
missing chunk) raises and names what it found; no partial tree is returned.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from nvblox_mindmap_torch.parallel.multihost import barrier, get_rank, is_distributed


class OrbaxCheckpointer:
    def __init__(self, checkpoint_dir: str, async_write: bool = True):
        self.checkpoint_dir = os.path.abspath(checkpoint_dir)
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.async_write = async_write
        self._group = dist.new_group(backend="gloo") if is_distributed() else None
        self._pending: List[Tuple[Any, str]] = []  # (future, name) being written

    def _path(self, name: str) -> str:
        return os.path.join(self.checkpoint_dir, name)

    def save(self, name: str, params: Dict[str, Any], opt_state: Dict[str, Any], step: int,
             loss: Optional[float]):
        """Write ``name/``: ``params`` (e.g. a ``state_dict``), ``opt_state``
        (nested dicts of tensors and numbers), ``iter`` and ``best_loss``."""
        payload = {
            "params": dict(params),
            "opt_state": opt_state,
            "meta": {"iter": int(step),
                     "best_loss": float("nan") if loss is None else float(loss)},
        }
        self.wait()  # one write at a time
        tmp = self._path(name) + ".tmp"
        if get_rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        barrier("checkpoint-tmp")  # no rank writes into tmp before it is empty
        if self.async_write:
            future = dcp.async_save(payload, checkpoint_id=tmp, process_group=self._group)
        else:
            dcp.save(payload, checkpoint_id=tmp, process_group=self._group)
            future = None
        self._pending.append((future, name))
        if future is None:
            self.wait()

    def save_best_and_last(self, params, opt_state, step: int, new_loss: Optional[float],
                           best_loss: Optional[float]) -> Optional[float]:
        if new_loss is not None and (best_loss is None or new_loss <= best_loss):
            best_loss = new_loss
            self.save("best", params, opt_state, step, best_loss)
        # last records the running best (reference checkpoint.py:42-50).
        self.save("last", params, opt_state, step, best_loss)
        return best_loss

    def restore(self, name: str, params_template: Dict[str, Any],
                opt_state_template: Dict[str, Any]) -> Tuple[Any, Any, int, Optional[float]]:
        """Load ``name/`` into the templates' tensors in place (a model's
        ``state_dict`` restores the model itself); returns (params,
        opt_state, iter, best_loss). A directory of the JAX package's backend
        loads the same way: ``params_template`` must then be a model's
        ``state_dict`` and ``opt_state_template`` its ``Optimizer.
        tensor_state()``."""
        self.wait()
        barrier("checkpoint-restore")  # rank 0 has moved every write into place
        path = self._path(name)
        if not os.path.isfile(os.path.join(path, ".metadata")):
            if os.path.isfile(os.path.join(path, "_METADATA")):
                return restore_jax_orbax(path, params_template, opt_state_template)
            raise FileNotFoundError(f"{path}: no checkpoint of this backend (.metadata) "
                                    "or of the JAX package's (_METADATA)")
        target = {
            "params": dict(params_template),
            "opt_state": opt_state_template,
            "meta": {"iter": 0, "best_loss": 0.0},
        }
        dcp.load(target, checkpoint_id=path, process_group=self._group)
        best = target["meta"]["best_loss"]
        best = None if (best is None or math.isnan(best)) else float(best)
        return target["params"], target["opt_state"], int(target["meta"]["iter"]), best

    def wait(self):
        """Block until pending saves are written and moved into place."""
        pending, self._pending = self._pending, []
        for future, name in pending:
            if future is not None:
                future.result()
            if get_rank() == 0:
                final = self._path(name)
                shutil.rmtree(final, ignore_errors=True)
                os.replace(final + ".tmp", final)


# ---------------------------------------------------------------- JAX-written directories


def restore_jax_orbax(path: str, params_template: Dict[str, Any],
                      opt_state_template: Dict[str, Any]) -> Tuple[Any, Any, int, Optional[float]]:
    """Load a JAX-written orbax directory into a model's ``state_dict`` and
    an ``Optimizer.tensor_state()`` in place; returns (params, opt_state,
    iter, best_loss) as ``OrbaxCheckpointer.restore`` does."""
    from nvblox_mindmap_torch.models.weights import flax_to_state_dict
    from nvblox_mindmap_torch.training.optimizer import fill_tensor_state_from_optax

    tree = read_orbax_tree(path)
    params = flax_to_state_dict(tree["params"])
    missing = sorted(set(params_template) - set(params))
    unexpected = sorted(set(params) - set(params_template))
    if missing or unexpected:
        raise KeyError(f"{path}: params do not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    for key, value in params.items():
        if value.shape != params_template[key].shape:
            raise ValueError(f"{path}: {key} {tuple(value.shape)} != model "
                             f"{tuple(params_template[key].shape)}")
    with torch.no_grad():
        for key, value in params.items():
            params_template[key].copy_(value)
        fill_tensor_state_from_optax(opt_state_template, _as_optax(tree["opt_state"]))
    best = tree["meta"]["best_loss"]
    best = None if (best is None or math.isnan(best)) else float(best)
    return params_template, opt_state_template, int(tree["meta"]["iter"]), best


def _as_optax(tree: Any) -> Any:
    """An optax state as orbax stores it (nested dicts by field name, chains
    as sequences) -> the ``OPTAX_STATES`` stand-ins of
    ``training.checkpoint``."""
    from nvblox_mindmap_torch.training.checkpoint import OPTAX_STATES

    if isinstance(tree, (list, tuple)):
        return tuple(_as_optax(item) for item in tree)
    if not isinstance(tree, dict):
        return tree
    for cls in OPTAX_STATES.values():
        if cls._fields and set(cls._fields) == set(tree):
            return cls(**{k: _as_optax(v) for k, v in tree.items()})
    return {k: _as_optax(v) for k, v in tree.items()}


def read_orbax_tree(path: str) -> Dict[str, Any]:
    """The pytree of a directory written by orbax's ``PyTreeCheckpointHandler``
    (OCDBT + zarr v2): nested dicts (sequences as tuples) of numpy arrays,
    Python scalars and the empty values orbax did not write."""
    with open(os.path.join(path, "_METADATA")) as f:
        metadata = json.load(f)
    if not metadata.get("use_ocdbt") or metadata.get("use_zarr3"):
        raise ValueError(f"{path}: orbax layout use_ocdbt={metadata.get('use_ocdbt')}, "
                         f"use_zarr3={metadata.get('use_zarr3')} is not read (only OCDBT "
                         "with zarr v2)")
    store = dict(read_ocdbt(path))
    root: Dict[Any, Any] = {}
    for entry in metadata["tree_metadata"].values():
        keys = entry["key_metadata"]
        value_type = entry["value_metadata"]["value_type"]
        if value_type in ("jax.Array", "np.ndarray", "scalar"):
            value = _read_zarr(store, ".".join(str(k["key"]) for k in keys), path)
            if value_type == "scalar":
                value = value.item()
        elif value_type in _EMPTY_VALUES and entry["value_metadata"].get("skip_deserialize"):
            value = _EMPTY_VALUES[value_type]
        else:
            raise ValueError(f"{path}: leaf {[k['key'] for k in keys]} has value type "
                             f"{value_type!r}, which is not read")
        node = root
        for key in keys[:-1]:
            node = node.setdefault(key["key"], {})
        node[keys[-1]["key"]] = value
    return _sequences(root, metadata["tree_metadata"])


_EMPTY_VALUES = {"None": None, "Tuple": ()}  # empty leaves orbax records, not writes


def _sequences(root: Dict[Any, Any], tree_metadata: Dict[str, Any]) -> Dict[str, Any]:
    """Turn the nodes whose children orbax keyed by sequence index
    (``key_type`` 1) into tuples."""
    indexed = set()
    for entry in tree_metadata.values():
        keys = entry["key_metadata"]
        for depth, key in enumerate(keys):
            if key["key_type"] == 1:
                indexed.add(tuple(k["key"] for k in keys[:depth]))

    def walk(node, prefix):
        if not isinstance(node, dict):
            return node
        children = {k: walk(v, prefix + (k,)) for k, v in node.items()}
        if prefix in indexed:
            return tuple(children[k] for k in sorted(children, key=int))
        return children

    return walk(root, ())


def _read_zarr(store: Dict[str, bytes], name: str, path: str) -> np.ndarray:
    """A zarr v2 array of the key-value store."""
    from nvblox_mindmap_torch.data.item_io import zstd_decompress

    key = f"{name}/.zarray"
    if key not in store:
        raise KeyError(f"{path}: no array {name!r} in the OCDBT store")
    meta = json.loads(store[key])
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{path}: {name}: zarr compressor {compressor} is not read")
    if meta.get("filters") or meta.get("order", "C") != "C" or meta.get("zarr_format") != 2:
        raise ValueError(f"{path}: {name}: zarr filters {meta.get('filters')}, order "
                         f"{meta.get('order')}, format {meta.get('zarr_format')} are not read")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError as e:
        raise ValueError(f"{path}: {name}: zarr dtype {meta['dtype']!r} is not read") from e
    if dtype.hasobject or dtype.fields:
        raise ValueError(f"{path}: {name}: zarr dtype {meta['dtype']!r} is not read")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*[len(g) for g in grid]) if shape else [()]:
        chunk_key = f"{name}/{sep.join(str(i) for i in index) if index else '0'}"
        if chunk_key not in store:
            raise KeyError(f"{path}: {name}: chunk {chunk_key!r} is missing")
        data = store[chunk_key]
        if compressor is not None:
            data = zstd_decompress(data, chunk_key)
        chunk = np.frombuffer(bytes(data), dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


# --- OCDBT (tensorstore's B-tree key-value store), format version 0

_MANIFEST_MAGIC, _NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
_MISSING = 2 ** 64 - 1  # offset / length of an empty tree


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def byte(self) -> int:
        self.pos += 1
        return self.data[self.pos - 1]

    def bytes(self, n: int) -> bytes:
        self.pos += n
        if self.pos > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        return self.data[self.pos - n:self.pos]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _decode_block(data: bytes, magic: int, what: str) -> _Reader:
    """The body of a manifest or node: magic (big-endian u32), length (u64),
    format version 0, compression (0 none, 1 zstd), body, crc32c."""
    from nvblox_mindmap_torch.data.item_io import zstd_decompress

    if len(data) < 18 or struct.unpack(">I", data[:4])[0] != magic:
        raise ValueError(f"{what}: not an OCDBT block (magic {data[:4].hex()})")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise ValueError(f"{what}: length field {length} != {len(data)} bytes")
    header = _Reader(data, what)
    header.pos = 12
    version, compression = header.varint(), header.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version} is not read (only 0)")
    body = data[header.pos:-4]
    if compression == 1:
        body = bytes(zstd_decompress(body, what))
    elif compression != 0:
        raise ValueError(f"{what}: OCDBT compression {compression} is not read")
    return _Reader(body, what)


def _data_file_table(r: _Reader) -> List[str]:
    """Relative paths of the data files a manifest or node refers to:
    prefix-compressed path strings, each a base path and a relative path."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        prev = prev[:prefix[i]] + r.bytes(suffix[i])
        paths.append(prev.decode())
    del base  # base path + relative path: the whole string is the file's path
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for i in range(n):
        prev = prev[:prefix[i]] + r.bytes(suffix[i])
        keys.append(prev)
    return keys, common


class _Files:
    """Byte ranges of the store's data files (paths relative to its root)."""

    def __init__(self, root: str):
        self.root = root

    def read(self, name: str, offset: int, length: int) -> bytes:
        with open(os.path.join(self.root, name), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{name}: a reference to {length} bytes at {offset} passes "
                             "the file's end")
        return data


def read_ocdbt(root: str) -> Iterator[Tuple[str, bytes]]:
    """Every (key, value) of the newest version of the OCDBT store at
    ``root``."""
    files = _Files(root)
    with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
        r = _decode_block(f.read(), _MANIFEST_MAGIC, os.path.join(root, "manifest.ocdbt"))
    r.bytes(16)  # uuid
    kind = r.varint()
    if kind != 0:
        raise ValueError(f"{root}: OCDBT manifest kind {kind} is not read (only 0, single)")
    r.varint()  # max_inline_value_bytes
    r.varint()  # max_decoded_node_bytes
    r.byte()  # version_tree_arity_log2
    compression = r.varint()
    if compression == 1:
        r.bytes(4)  # zstd level
    elif compression != 0:
        raise ValueError(f"{root}: OCDBT compression method {compression} is not read")
    paths = _data_file_table(r)
    n = r.varint()
    generation = r.varints(n)
    height = [r.byte() for _ in range(n)]
    file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
    if not n:
        raise ValueError(f"{root}: the OCDBT manifest holds no version")
    newest = int(np.argmax(generation))
    if offset[newest] == _MISSING:
        return
    yield from _walk(files, paths[file_id[newest]], offset[newest], length[newest],
                     height[newest], b"")


def _walk(files: _Files, name: str, offset: int, length: int, height: int,
          prefix: bytes) -> Iterator[Tuple[str, bytes]]:
    what = f"{name}@{offset}"
    r = _decode_block(files.read(name, offset, length), _NODE_MAGIC, what)
    if r.byte() != height:
        raise ValueError(f"{what}: B-tree node height differs from its reference")
    paths = _data_file_table(r)
    n = r.varint()
    keys, common = _keys(r, n, interior=height > 0)
    if height > 0:
        file_id, child_offset, child_length = r.varints(n), r.varints(n), r.varints(n)
        for i in range(n):
            yield from _walk(files, paths[file_id[i]], child_offset[i], child_length[i],
                             height - 1, prefix + keys[i][:common[i]])
        return
    sizes = r.varints(n)
    kinds = [r.byte() for _ in range(n)]
    if any(k not in (0, 1) for k in kinds):
        raise ValueError(f"{what}: OCDBT value kinds {sorted(set(kinds))} are not read")
    indirect = [i for i in range(n) if kinds[i] == 1]
    refs = dict(zip(indirect, zip(r.varints(len(indirect)), r.varints(len(indirect)))))
    for i in range(n):
        if kinds[i] == 1:
            value = files.read(paths[refs[i][0]], refs[i][1], sizes[i])
        else:
            value = r.bytes(sizes[i])
        yield (prefix + keys[i]).decode(), value
