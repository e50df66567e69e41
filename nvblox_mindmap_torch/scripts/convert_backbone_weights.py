"""Offline torch-hub checkpoint -> converted flax-layout .npz (+ golden
fixture).

Port of ``nvblox_mindmap_tpu/scripts/convert_backbone_weights.py``, on the
port's converters (``models/weight_conversion.py``): the ``.npz`` is the
flax parameter tree with '/'-joined keys, which both packages read. Run on
a machine WITH torch-hub access::

    python -m nvblox_mindmap_torch.scripts.convert_backbone_weights \
        --feature_type radio_v25_b --output weights/ --write_golden

Produces <output>/<type>.npz for --backbone_weights everywhere and (with
--write_golden) <type>_golden.npz, the torch activations that
``tests/test_torch_runtime_tools.py`` and ``tests/test_backbone_golden.py``
pin the extractors to.

(reference: mindmap/image_processing/feature_extraction.py:360-370 RADIO hub
load, :473-476 CLIP RN50, :531-535 DINOv2; the reference downloads at app
startup, this converts once, offline.)
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from nvblox_mindmap_torch.models.feature_extractors import FeatureExtractorType
from nvblox_mindmap_torch.models.weight_conversion import (
    convert_clip_resnet_weights,
    convert_radio_vit_weights,
    convert_torch_vit_weights,
    interpolate_pos_embed,
    save_variables_npz,
)


def _torch_state(model):
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def convert(feature_type: FeatureExtractorType, target_grid: int = 32):
    """Download + convert one backbone; returns (variables, torch_model)."""
    import torch

    if feature_type == FeatureExtractorType.RADIO_V25_B:
        model = torch.hub.load(
            "NVlabs/RADIO", "radio_model", version="radio_v2.5-b",
            progress=True, pretrained=True, skip_validation=True,
        ).eval()
        out = convert_radio_vit_weights(_torch_state(model), depth=12,
                                        num_heads=12)
        out["params"] = interpolate_pos_embed(out["params"], target_grid)
        return out, model
    if feature_type == FeatureExtractorType.DINO_V2_VITS14:
        model = torch.hub.load(
            "facebookresearch/dinov2", "dinov2_vits14"
        ).eval()
        params = convert_torch_vit_weights(
            _torch_state(model), depth=12, num_heads=6, num_prefix_tokens=1
        )
        params = interpolate_pos_embed(params, target_grid)
        return {"params": params}, model
    if feature_type == FeatureExtractorType.CLIP_RESNET50_FPN:
        import clip

        model, _ = clip.load("RN50", device="cpu")
        visual = model.visual.float().eval()
        converted = convert_clip_resnet_weights(_torch_state(visual))
        return {"params": {"backbone": converted["params"]}}, visual
    raise ValueError(f"no conversion needed/supported for {feature_type}")


def write_golden(feature_type: FeatureExtractorType, torch_model, path: str,
                 image_hw: int = 256):
    """Store (input, torch activations) so the flax forward can be pinned.

    ViT types pin the full spatial-feature output under ``expected``. CLIP
    pins the FROZEN trunk's 5 intermediate feature maps under
    ``expected_trunk_0..4`` (the FPN neck is trainable and has no reference
    weights to pin, reference feature_extraction.py:434-442); the golden
    harness applies ModifiedResNetFeatures alone for those fixtures.
    """
    import torch

    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (1, image_hw, image_hw, 3)).astype(np.float32)
    bchw = torch.from_numpy(rgb).permute(0, 3, 1, 2)
    with torch.no_grad():
        if feature_type == FeatureExtractorType.RADIO_V25_B:
            _, feats = torch_model(bchw)  # (1, N, C)
            g = int(round(np.sqrt(feats.shape[1])))
            np.savez(path, rgb=rgb,
                     expected=feats.reshape(1, g, g, -1).numpy())
        elif feature_type == FeatureExtractorType.DINO_V2_VITS14:
            feats = torch_model.forward_features(bchw)["x_norm_patchtokens"]
            g = int(round(np.sqrt(feats.shape[1])))
            np.savez(path, rgb=rgb,
                     expected=feats.reshape(1, g, g, -1).numpy())
        elif feature_type == FeatureExtractorType.CLIP_RESNET50_FPN:
            # CLIP preprocessing (mean/std as in ClipResNet50Fpn), then the
            # trunk taps the reference FPN consumes (feature_extraction.py
            # :402-422 surgery): stem relu3 output + layer1..4 outputs.
            mean = torch.tensor([0.48145466, 0.4578275, 0.40821073])
            std = torch.tensor([0.26862954, 0.26130258, 0.27577711])
            x = (bchw - mean.view(1, 3, 1, 1)) / std.view(1, 3, 1, 1)
            v = torch_model  # clip .visual (ModifiedResNet)
            x = torch.relu(v.bn1(v.conv1(x)))
            x = torch.relu(v.bn2(v.conv2(x)))
            x0 = torch.relu(v.bn3(v.conv3(x)))
            x = v.avgpool(x0)
            feats = [x0]
            for layer in (v.layer1, v.layer2, v.layer3, v.layer4):
                x = layer(x)
                feats.append(x)
            arrays = {
                f"expected_trunk_{i}": f.permute(0, 2, 3, 1).numpy()
                for i, f in enumerate(feats)
            }
            np.savez(path, rgb=rgb, **arrays)
        else:
            raise ValueError(f"golden fixture unsupported for {feature_type}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--feature_type", required=True,
                    type=FeatureExtractorType)
    ap.add_argument("--output", required=True)
    ap.add_argument("--target_grid", type=int, default=32,
                    help="patch grid to resample pos_embed to "
                         "(32 = 512px inputs at patch 16)")
    ap.add_argument("--write_golden", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.output, exist_ok=True)
    variables, torch_model = convert(args.feature_type, args.target_grid)
    out_path = os.path.join(args.output, f"{args.feature_type.value}.npz")
    save_variables_npz(out_path, variables)
    print(f"wrote {out_path}")
    if args.write_golden:
        golden = os.path.join(
            args.output, f"{args.feature_type.value}_golden.npz"
        )
        write_golden(args.feature_type, torch_model, golden)
        print(f"wrote {golden}")


if __name__ == "__main__":
    main()
