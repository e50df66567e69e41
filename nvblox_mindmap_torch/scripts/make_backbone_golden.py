"""Produce ALL golden backbone fixtures into tests/test_data/backbones/.

Port of ``nvblox_mindmap_tpu/scripts/make_backbone_golden.py``. One
command, run on a machine WITH torch-hub egress::

    python -m nvblox_mindmap_torch.scripts.make_backbone_golden

then commit the produced ``tests/test_data/backbones/<type>.npz`` +
``<type>_golden.npz`` pairs; the golden-fixture tests of both packages
un-skip when they exist.

This wraps ``convert_backbone_weights`` (download the hub checkpoint ->
convert to the flax-layout npz -> record the torch activations) for the
three pretrained extractor types. On a host without egress every type
fails at its download and the command exits 1, naming egress. The
reference's baselines are stored ``.zst`` activation tensors in
``mindmap/tests/test_data/`` (reference:
mindmap/tests/test_feature_extraction.py:15-50), shipped as Git-LFS pointer
stubs, so the fixtures are regenerated from the hub checkpoints instead.
"""
from __future__ import annotations

import argparse
import os
import traceback

from nvblox_mindmap_torch.models.feature_extractors import FeatureExtractorType
from nvblox_mindmap_torch.scripts.convert_backbone_weights import (
    convert,
    write_golden,
)

GOLDEN_TYPES = (
    FeatureExtractorType.RADIO_V25_B,
    FeatureExtractorType.DINO_V2_VITS14,
    FeatureExtractorType.CLIP_RESNET50_FPN,
)


def default_output_dir() -> str:
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(repo_root, "tests", "test_data", "backbones")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--output", default=default_output_dir(),
        help="fixture directory (default: tests/test_data/backbones/)",
    )
    ap.add_argument(
        "--feature_types", nargs="*", type=FeatureExtractorType,
        default=list(GOLDEN_TYPES),
    )
    ap.add_argument("--target_grid", type=int, default=32)
    ap.add_argument("--image_hw", type=int, default=256)
    args = ap.parse_args(argv)

    from nvblox_mindmap_torch.models.weight_conversion import save_variables_npz

    os.makedirs(args.output, exist_ok=True)
    failures = []
    for feature_type in args.feature_types:
        try:
            print(f"[{feature_type.value}] downloading + converting ...")
            variables, torch_model = convert(feature_type, args.target_grid)
            weights_path = os.path.join(
                args.output, f"{feature_type.value}.npz"
            )
            save_variables_npz(weights_path, variables)
            golden_path = os.path.join(
                args.output, f"{feature_type.value}_golden.npz"
            )
            write_golden(
                feature_type, torch_model, golden_path, image_hw=args.image_hw
            )
            print(f"[{feature_type.value}] wrote {weights_path} and "
                  f"{golden_path}")
        except Exception:
            traceback.print_exc()
            failures.append(feature_type.value)
    if failures:
        print(f"FAILED for: {', '.join(failures)} (need torch-hub egress?)")
        return 1
    print("All golden fixtures written; run "
          "`pytest tests/test_backbone_golden.py` to pin them.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
