"""Tar / untar demo directories (reference: scripts/tar_demos.py,
untar_demos.py) - used for shipping test-baseline datasets.

Port of ``nvblox_mindmap_tpu/scripts/tar_demos.py``::

    python -m nvblox_mindmap_torch.scripts.tar_demos tar --dataset <ds> --demos 0-3 \\
        --output_dir tars/
    python -m nvblox_mindmap_torch.scripts.tar_demos untar --dataset tars/ --output_dir <ds>
"""
from __future__ import annotations

import argparse
import os
import tarfile
from typing import List

from nvblox_mindmap_torch.data.dataset import get_demo_paths


def tar_demos(dataset_path: str, demos: str, output_dir: str) -> List[str]:
    """One .tar per demo dir; returns the written paths."""
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for demo_path in get_demo_paths(dataset_path, demos):
        name = os.path.basename(demo_path)
        out = os.path.join(output_dir, f"{name}.tar")
        with tarfile.open(out, "w") as tar:
            tar.add(demo_path, arcname=name)
        written.append(out)
    return written


def untar_demos(tar_dir: str, output_dir: str) -> List[str]:
    """Extract every demo tar in tar_dir into output_dir."""
    os.makedirs(output_dir, exist_ok=True)
    extracted = []
    for fname in sorted(os.listdir(tar_dir)):
        if not fname.endswith(".tar"):
            continue
        with tarfile.open(os.path.join(tar_dir, fname)) as tar:
            tar.extractall(output_dir, filter="data")
        extracted.append(os.path.join(output_dir, fname[: -len(".tar")]))
    return extracted


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=["tar", "untar"])
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--demos", default="0")
    parser.add_argument("--output_dir", required=True)
    args = parser.parse_args(argv)
    if args.mode == "tar":
        print(tar_demos(args.dataset, args.demos, args.output_dir))
    else:
        print(untar_demos(args.dataset, args.output_dir))


if __name__ == "__main__":
    main()
