"""Precompute feature images for every RGB frame of a dataset.

Port of ``nvblox_mindmap_tpu/scripts/extract_image_features.py`` (upstream:
scripts/extract_image_features.py). Batches a camera's ``<idx>.<cam>_rgb.png``
frames through the extractor and writes ``<idx>.<cam>_features.npy`` (fp16,
(h, w, C)) beside them. PNGs are decoded by ``data.item_io``. As in the JAX
script, the extractor's parameters are a random initialization (the flax
initialisers, drawn from torch's generator seeded 0, where JAX uses
``PRNGKey(0)``): the two packages' files agree for ``--feature_type rgb``,
which has no parameters. Runs on ``--device`` (default cuda).

    python -m nvblox_mindmap_torch.scripts.extract_image_features \\
        --dataset <demos> --demos 0-3 --feature_type clip_resnet50_fpn --camera wrist
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from nvblox_mindmap_torch.data.dataset import get_demo_paths
from nvblox_mindmap_torch.data.item_io import decode_png
from nvblox_mindmap_torch.device import resolve_device
from nvblox_mindmap_torch.models.feature_extractors import (
    FeatureExtractorType,
    make_feature_extractor,
)
from nvblox_mindmap_torch.models.layers import init_as_flax_


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--demos", default="0")
    parser.add_argument("--feature_type", default="rgb")
    parser.add_argument("--feature_image_size", type=int, default=32)
    parser.add_argument("--camera", default="wrist")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    size = (args.feature_image_size, args.feature_image_size)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        module = init_as_flax_(make_feature_extractor(FeatureExtractorType(args.feature_type),
                                                      feature_image_size=size))
    module = module.to(device).eval()

    for demo_path in get_demo_paths(args.dataset, args.demos):
        frames = sorted(
            glob.glob(os.path.join(demo_path, f"*.{args.camera}_rgb.png")),
            key=lambda p: int(os.path.basename(p).split(".")[0]),
        )
        for i in range(0, len(frames), args.batch_size):
            chunk = frames[i:i + args.batch_size]
            rgb = np.stack([decode_png(p).astype(np.float32) / 255.0 for p in chunk])
            with torch.no_grad():
                feats = module(torch.from_numpy(rgb).to(device)).cpu().numpy()
            for path, feat in zip(chunk, feats):
                idx = os.path.basename(path).split(".")[0]
                np.save(os.path.join(demo_path, f"{idx}.{args.camera}_features.npy"),
                        feat.astype(np.float16))
        print(f"Extracted features for {len(frames)} frames in {demo_path}")


if __name__ == "__main__":
    main()
