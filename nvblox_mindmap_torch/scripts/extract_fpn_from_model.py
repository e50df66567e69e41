"""Extract the trained CLIP FPN neck from a policy checkpoint.

Port of ``nvblox_mindmap_tpu/scripts/extract_fpn_from_model.py`` (upstream:
scripts/extract_fpn_from_model.py). The FPN is the only trainable part of
the CLIP_RESNET50_FPN extractor; after training it serves as the mapping
extractor's neck: ``make_feature_fn`` / ``--backbone_weights`` take the npz
written here, a flax-layout ``params/fpn`` tree with the frozen trunk beside
it under ``params/backbone`` (the JAX package's layout, so either package
reads it). The checkpoint may be either package's ``.ckpt``.

    python -m nvblox_mindmap_torch.scripts.extract_fpn_from_model \\
        --model_path train_logs/checkpoints/<ts>/best.ckpt --output_path fpn.npz
"""
from __future__ import annotations

import argparse
from typing import Dict

from nvblox_mindmap_torch.models.weight_conversion import save_variables_npz
from nvblox_mindmap_torch.training.checkpoint import read_params_tree


def extract_fpn_weights(model_path: str, output_path: str) -> Dict:
    params = read_params_tree(model_path)
    try:
        fx = params["encoder"]["feature_extractor"]
        fpn = fx["fpn"]
    except KeyError as e:
        raise KeyError(
            "checkpoint has no encoder/feature_extractor/fpn subtree - was it "
            "trained with --feature_type clip_resnet50_fpn and an rgbd data "
            f"type? (missing {e})"
        ) from e
    variables = {"params": {"fpn": fpn}}
    if "backbone" in fx:
        # The frozen trunk beside it: the npz alone serves --backbone_weights.
        variables["params"]["backbone"] = fx["backbone"]
    save_variables_npz(output_path, variables)
    print(f"wrote FPN weights to {output_path}")
    return variables


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    extract_fpn_weights(args.model_path, args.output_path)


if __name__ == "__main__":
    main()
