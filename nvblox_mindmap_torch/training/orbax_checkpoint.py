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

The JAX package's orbax directories hold OCDBT / zarr arrays written
through ``tensorstore``, which this package does not read: restoring one
raises, saying so.
"""
from __future__ import annotations

import math
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from nvblox_mindmap_torch.parallel.multihost import barrier, get_rank, is_distributed

# Files of a directory written by orbax (OCDBT through tensorstore).
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


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
        opt_state, iter, best_loss)."""
        self.wait()
        barrier("checkpoint-restore")  # rank 0 has moved every write into place
        path = self._path(name)
        if not os.path.isfile(os.path.join(path, ".metadata")):
            if any(os.path.exists(os.path.join(path, f)) for f in _ORBAX_MARKERS):
                raise NotImplementedError(
                    f"{path} was written by the JAX package's orbax backend: its arrays "
                    "are OCDBT / zarr files written through tensorstore, which "
                    "nvblox_mindmap_torch does not read; resume from the JAX package's "
                    "msgpack checkpoint (--checkpoint_backend msgpack) instead")
            raise FileNotFoundError(f"{path}: no checkpoint of this backend (.metadata)")
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
