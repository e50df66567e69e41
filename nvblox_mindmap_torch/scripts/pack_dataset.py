"""Materialize a packed training epoch: the offline half of card-fed training.

Port of ``nvblox_mindmap_tpu/scripts/pack_dataset.py``. Runs the production
data path (the training app's ``build_loaders``: decode, keypose windows,
transforms, vertex sampling) and writes its batches to a packed-epoch
directory (``data/packed.py``: one mmap-able ``.npy`` per key and
``packed_meta.json``, the JAX package's bytes). Train from it with
``run_training --packed_dataset <out>``: the epoch is staged on the card once
and every step takes a view of it. Host only: it touches no device.

Usage::

    python -m nvblox_mindmap_torch.scripts.pack_dataset \\
        --dataset <demos> --task cube_stacking --data_type mesh \\
        --feature_type rgb --demos_train 0-7 --batch_size 32 \\
        --packed_out /tmp/packed [--packed_num_batches 64]
"""
from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any, Dict, Iterator

from nvblox_mindmap_torch.utils.config import TrainingAppArgs, parse_args

logger = logging.getLogger("nvblox_mindmap_torch.pack_dataset")


@dataclasses.dataclass
class PackDatasetArgs(TrainingAppArgs):
    packed_out: str = "/tmp/packed_epoch"
    # 0 packs exactly one epoch; >0 packs that many batches (cycling the
    # loader across epochs, each with its own transform draws).
    packed_num_batches: int = 0


def loader_batches(loader, n: int) -> Iterator[Dict[str, Any]]:
    """The first ``n`` batches of ``loader``'s epochs, one epoch after another."""
    written = 0
    while written < n:
        for batch in loader:  # each epoch redraws transforms
            if written >= n:
                return
            yield batch
            written += 1


def main(argv=None) -> Dict[str, Any]:
    """Pack the epoch; returns its metadata (``packed_meta.json``)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(message)s")
    args = parse_args(PackDatasetArgs, argv)
    if args.task is None:
        raise ValueError("--task is required")
    if args.dataset is None:
        raise ValueError("--dataset is required")

    from nvblox_mindmap_torch.apps.run_training import build_loaders
    from nvblox_mindmap_torch.data.packed import materialize_packed_epoch
    from nvblox_mindmap_torch.embodiments.registry import make_embodiment_for_task

    train_loader, _, _ = build_loaders(args, make_embodiment_for_task(args.task),
                                       skip_val=True)
    n = args.packed_num_batches or len(train_loader)
    meta = materialize_packed_epoch(loader_batches(train_loader, n), args.packed_out,
                                    num_batches=n)
    logger.info("packed %d batches -> %s\n%s", meta["num_batches"], args.packed_out,
                json.dumps(meta, indent=1))
    return meta


if __name__ == "__main__":
    main()
