"""Checkpoint inspection tools (upstream: scripts/print_checkpoint_iters.py,
extract_fpn_from_model.py).

Port of ``nvblox_mindmap_tpu/scripts/checkpoint_tools.py``. Both commands
read either package's checkpoint file: the JAX package's pickled ``.ckpt``
(flax msgpack parameters) and the port's ``torch.save`` ``.ckpt``.

- ``info <ckpt>``: prints ``iter`` and ``best_loss``.
- ``extract <ckpt> <subtree> <out>``: writes the parameter subtree at a
  '/'-path (e.g. ``encoder/feature_extractor/fpn``) as flax msgpack bytes,
  which the JAX package's ``load_subtree`` (and this module's) reads. A
  port checkpoint's parameters go through the weight bridge the other way
  (``models.weights.state_dict_to_flax``) first.

Usage::

    python -m nvblox_mindmap_torch.scripts.checkpoint_tools info best.ckpt
    python -m nvblox_mindmap_torch.scripts.checkpoint_tools extract best.ckpt \\
        encoder/feature_extractor/fpn fpn.msgpack
"""
from __future__ import annotations

import argparse
import pickle
from typing import Any, Optional, Tuple

from nvblox_mindmap_torch.training.checkpoint import (
    is_jax_checkpoint,
    load_checkpoint_file,
    msgpack_restore,
    msgpack_serialize,
    read_params_tree,
)


def print_checkpoint_info(path: str) -> Tuple[int, Optional[float]]:
    if is_jax_checkpoint(path):
        with open(path, "rb") as f:
            payload = pickle.load(f)
    else:
        payload = load_checkpoint_file(path)
    print(f"{path}: iter={payload['iter']} best_loss={payload['best_loss']}")
    return payload["iter"], payload["best_loss"]


def extract_subtree(path: str, subtree: str, output_path: str) -> None:
    """Write the params subtree at ``subtree`` ('/'-path) to its own file."""
    node = read_params_tree(path)
    for key in subtree.split("/"):
        if key not in node:
            raise KeyError(f"{key} not in {sorted(node)}")
        node = node[key]
    with open(output_path, "wb") as f:
        f.write(msgpack_serialize(node))
    print(f"Wrote {subtree} -> {output_path}")


def load_subtree(path: str) -> Any:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_info = sub.add_parser("info")
    p_info.add_argument("checkpoint")
    p_extract = sub.add_parser("extract")
    p_extract.add_argument("checkpoint")
    p_extract.add_argument("subtree")
    p_extract.add_argument("output")
    args = parser.parse_args(argv)
    if args.cmd == "info":
        print_checkpoint_info(args.checkpoint)
    else:
        extract_subtree(args.checkpoint, args.subtree, args.output)


if __name__ == "__main__":
    main()
