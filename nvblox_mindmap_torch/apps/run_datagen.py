"""Datagen app: fuse recorded RGB-D episodes into per-frame feature meshes.

The port's counterpart of ``nvblox_mindmap_tpu/apps/run_datagen.py``
(upstream ``mindmap/run_isaaclab_datagen.py``). Upstream replays HDF5 demos
inside Isaac Lab and fuses nvblox maps as it goes; here the boundary is the
recorded frame stream (``<idx>.<cam>_{rgb,depth,semantic}.png``, pose and
intrinsics ``.npy``, ``robot_state.npy``). Per frame: decay, feature
extraction, TSDF / color / feature integration on the card, then the
``<idx>.nvblox_vertex_features.zst`` item that the training app reads.
Each part has its timer (``datagen/{decay,compute_features,integrate,
export_mesh}``), synchronized with the card so that it measures the work.

Usage::

    python -m nvblox_mindmap_torch.apps.run_datagen --task cube_stacking \\
        --dataset <path> --demos_datagen 0-9 --feature_type radio_v25_b \\
        --backbone_weights <radio.npz> --image_size 512,512

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
card.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import List, Optional

import numpy as np

from nvblox_mindmap_torch.closed_loop.environment import (
    ReplayEnvironment,
    dynamic_mask_from_segmentation,
)
from nvblox_mindmap_torch.data.dataset import DemoOutcome, get_demo_paths
from nvblox_mindmap_torch.device import DeviceLike, resolve_device
from nvblox_mindmap_torch.embodiments.base import EmbodimentType
from nvblox_mindmap_torch.embodiments.registry import make_embodiment_for_task
from nvblox_mindmap_torch.geometry.np_rotations import pose7_to_matrix
from nvblox_mindmap_torch.image.conversions import add_depth_noise as add_noise
from nvblox_mindmap_torch.mapping.constants import MapperId, MappingConfig
from nvblox_mindmap_torch.mapping.mapper import (
    Mapper,
    nvblox_integrate,
    save_feature_mesh_to_disk,
)
from nvblox_mindmap_torch.models.feature_extractors import get_feature_dim
from nvblox_mindmap_torch.models.pretrained import make_feature_fn
from nvblox_mindmap_torch.utils.config import DataGenAppArgs, parse_args
from nvblox_mindmap_torch.utils.timers import Timer, timer_status_string

logger = logging.getLogger("nvblox_mindmap_torch.run_datagen")


def process_demo(
    demo_path: str,
    embodiment,
    mapping_config: MappingConfig,
    feature_fn,
    save_serialized_map: bool = False,
    max_num_steps: int = -1,
    include_dynamic: bool = False,
    add_depth_noise: bool = False,
    noise_rng: Optional[np.random.Generator] = None,
    device: DeviceLike = None,
) -> Mapper:
    """Fuse one demo's frames on ``device`` (default ``cuda``); write the
    per-frame feature meshes. Returns the mapper in its final state."""
    prefixes = ["wrist"] if embodiment.embodiment_type == EmbodimentType.ARM else ["pov"]
    env = ReplayEnvironment(demo_path, embodiment, prefixes)
    # The dynamic map's feature pool is only allocated when needed.
    mapper = (Mapper.dual(mapping_config, device) if include_dynamic
              else Mapper({MapperId.STATIC: mapping_config}, device))
    n = env.num_frames if max_num_steps < 0 else min(env.num_frames, max_num_steps)
    env.reset()
    for t in range(n):
        env.t = t
        with Timer("datagen/decay", synchronize=True):
            mapper.decay()
        for frame in env.get_cameras().values():
            depth = frame.depth
            if add_depth_noise:
                # Sensor-like robustness augmentation (upstream
                # run_isaaclab_datagen --add_depth_noise).
                depth = add_noise(depth, noise_rng)
            with Timer("datagen/compute_features", synchronize=True):
                features = feature_fn(frame.rgb)
            dynamic_mask = dynamic_mask_from_segmentation(
                frame.segmentation, env.semantic_id_to_class,
                mapping_config.dynamic_class_labels)
            with Timer("datagen/integrate", synchronize=True):
                nvblox_integrate(mapper, mapping_config, depth, features, frame.intrinsics,
                                 pose7_to_matrix(frame.pose7), frame.rgb,
                                 dynamic_mask=dynamic_mask, include_dynamic=include_dynamic)
        with Timer("datagen/export_mesh", synchronize=True):
            save_feature_mesh_to_disk(
                mapper, os.path.join(demo_path, f"{t}.nvblox_vertex_features.zst"),
                include_dynamic=include_dynamic)
    if save_serialized_map:
        # Upstream's naming (*.nvblox_map_static.nvblx); one map per demo,
        # its end state: the per-frame meshes hold the history.
        mapper.save_map(os.path.join(demo_path, "nvblox_map_static.nvblx"), MapperId.STATIC)
        if include_dynamic:
            mapper.save_map(os.path.join(demo_path, "nvblox_map_dynamic.nvblx"),
                            MapperId.DYNAMIC)
    # Mark success if no outcome file exists yet.
    outcome_path = os.path.join(demo_path, "demo_successful.npy")
    if not os.path.exists(outcome_path):
        np.save(outcome_path, np.asarray(DemoOutcome.SUCCESS.value))
    logger.info("Fused %d frames for %s", n, demo_path)
    return mapper


def make_mapping_feature_fn(feature_type, upscaled_size, backbone_weights=None,
                            feature_image_size=(32, 32), device: DeviceLike = None):
    """(H, W, 3) [0, 1] -> upscaled (Hf, Wf, F) feature extractor on
    ``device``. Non-RGB extractors need a converted pretrained checkpoint
    (``models/pretrained.py``); running them randomly initialized is
    refused."""
    return make_feature_fn(feature_type, output_size=upscaled_size,
                           backbone_weights=backbone_weights,
                           feature_image_size=feature_image_size, device=device)


def main(argv: Optional[List[str]] = None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(message)s")
    args = parse_args(DataGenAppArgs, argv)
    if args.task is None:
        raise ValueError("--task is required")
    dataset = args.output_dir or args.dataset
    if dataset is None:
        raise ValueError("--output_dir or --dataset is required")
    device = resolve_device(None if args.device == "cuda" else args.device)

    embodiment = make_embodiment_for_task(args.task)
    mapping_config = MappingConfig.for_task(
        args.task,
        feature_dim=get_feature_dim(args.feature_type),
        voxel_size_m=args.voxel_size_m,
        projective_appearance_integrator_measurement_weight=(
            args.projective_appearance_integrator_measurement_weight),
    ).scaled_for_image_size(tuple(args.image_size))
    if args.max_num_attempts != 5:
        logger.warning("--max_num_attempts has no effect: replay datagen is deterministic "
                       "(sim-side retries happen on the simulator's host)")
    feature_fn = make_mapping_feature_fn(
        args.feature_type, mapping_config.upscaled_feature_image_size,
        backbone_weights=args.backbone_weights,
        feature_image_size=tuple(args.feature_image_size), device=device)
    noise_rng = np.random.default_rng(args.seed)
    for demo_path in get_demo_paths(dataset, args.demos_datagen):
        process_demo(
            demo_path, embodiment, mapping_config, feature_fn,
            save_serialized_map=args.save_serialized_nvblox_map_to_disk,
            max_num_steps=args.max_num_steps,
            include_dynamic=args.include_dynamic,
            add_depth_noise=args.add_depth_noise,
            noise_rng=noise_rng,
            device=device,
        )
    if args.validate_demos_with_gt_poses:
        # GT-keypose validation pass (upstream run_isaaclab_datagen
        # validate_demos_with_gt_poses): demos whose keyposes cannot be
        # executed are marked FAILED_GT_EVAL and left out of training.
        from nvblox_mindmap_torch.apps.run_validate_demos import main as validate

        validate(argv=["--device", args.device], task=args.task, dataset=dataset,
                 demos=args.demos_datagen)
    logger.info("\n%s", timer_status_string())


if __name__ == "__main__":
    main(sys.argv[1:])
