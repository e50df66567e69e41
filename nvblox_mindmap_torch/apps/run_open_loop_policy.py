"""Open-loop policy app: the port's counterpart of
``nvblox_mindmap_tpu/apps/run_open_loop_policy.py`` (upstream
``mindmap/run_open_loop_policy.py``).

Loads a recorded dataset, predicts each sample's keypose and reports the
evaluation metrics against the ground truth (distance error, rotation
geodesic error, openness L1), averaged over the samples.

The model is built as the training app builds it for ``best.ckpt``: the
frozen ``training_args.json`` overlays the command line, the model config
comes from those args (its vertex-feature width from the dataset's first
item), and the checkpoint reader takes a port-written or a JAX-written
``.ckpt``. While the app runs, flash attention is the process-wide
attention impl (the previous one is restored afterwards), so every sample
goes through the flash kernels. A run with ``--ply_output_dir`` is the
exception: its attention cloud needs the cross-attention weights, which no
flash path materializes, so it samples with eager attention (and logs so).

Each sample ``i`` is predicted with the full stochastic DDPM sampler from
the noise of seed ``i`` (``sampler_noise``: a ``torch.Generator`` on the
model's device), as the JAX app draws it from ``PRNGKey(i)``. The loader is
iterated once, from its first epoch.

Usage::

    python -m nvblox_mindmap_torch.apps.run_open_loop_policy --task cube_stacking \\
        --dataset <path> --demos_open_loop 0-3 --only_sample_keyposes 1 \\
        --checkpoint <dir>/best.ckpt [--ply_output_dir <dir>]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
card.
"""
from __future__ import annotations

import json
import logging
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from nvblox_mindmap_torch.apps.run_training import resolve_keypose_params, vertex_feature_dim
from nvblox_mindmap_torch.data.dataset import SamplingWeightingType
from nvblox_mindmap_torch.data.loader import get_data_loader_by_data_type
from nvblox_mindmap_torch.device import resolve_device
from nvblox_mindmap_torch.embodiments.registry import make_embodiment_for_task
from nvblox_mindmap_torch.mapping.constants import get_workspace_bounds
from nvblox_mindmap_torch.models.converter import (
    apply_inference_settings,
    convert_to_flash_attention,
)
from nvblox_mindmap_torch.models.diffuser_actor import (
    DiffuserActor,
    prepare_inputs,
    sample_trajectory,
)
from nvblox_mindmap_torch.models.loss import compute_metrics
from nvblox_mindmap_torch.ops.attention import (
    get_default_attention_impl,
    set_default_attention_impl,
)
from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig
from nvblox_mindmap_torch.utils.config import (
    OpenLoopAppArgs,
    model_config_from_args,
    parse_args,
    update_model_args_from_checkpoint,
)
from nvblox_mindmap_torch.visualization.visualizer import (
    attention_to_colors,
    save_feature_pointcloud_ply,
    save_pointcloud_ply,
)

logger = logging.getLogger("nvblox_mindmap_torch.run_open_loop_policy")


def sampler_noise(seed: int, num_steps: int, shape: Tuple[int, ...],
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sampler's draws for one integer seed: the initial trajectory
    (*shape, 9) and the per-step noise (num_steps, *shape, 9), from a
    ``torch.Generator`` on ``device`` seeded with it."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    init = torch.randn(tuple(shape) + (9,), generator=gen, device=device)
    steps = torch.randn((num_steps,) + tuple(shape) + (9,), generator=gen, device=device)
    return init, steps


def make_infer_fn(model: DiffuserActor, bounds):
    """The inference function ``infer(batch, seeds)`` ->
    (trajectory (R, L, G, 8), head_yaw or None, mean cross-attention weights
    or None): the stochastic DDPM sampler at the training timestep count, as
    the JAX app's. ``batch`` is one sample (batch size 1, host arrays);
    ``seeds`` is an int or a sequence of R ints: the sample is predicted once
    per seed, as the rows of one sampler call, each row from that seed's
    ``sampler_noise``."""
    cfg = model.config
    device = model.device
    num_steps = len(cfg.schedules()[0].timesteps(None))
    shape = (1, cfg.prediction_horizon, cfg.ngrippers)

    def infer(batch: Dict[str, Any], seeds: Union[int, Sequence[int]]):
        seeds = [seeds] if isinstance(seeds, (int, np.integer)) else list(seeds)
        rows = len(seeds)
        if rows > 1:
            batch = {k: None if v is None else np.repeat(np.asarray(v), rows, axis=0)
                     for k, v in batch.items()}
        prepared = prepare_inputs(batch, bounds, cfg, device=device)
        # sampler_noise is looked up at call time, so a caller may swap the
        # noise source for the whole module.
        draws = [sampler_noise(s, num_steps, shape, device) for s in seeds]
        init = torch.cat([d[0] for d in draws], dim=0)
        steps = torch.cat([d[1] for d in draws], dim=1)
        return sample_trajectory(model, prepared, bounds, init_noise=init, step_noise=steps)

    return infer


def run_inference(infer, model: DiffuserActor, batch: Dict[str, Any], seed: int
                  ) -> Dict[str, Any]:
    """One inference call + metrics vs the ground-truth keypose."""
    cfg = model.config
    traj, head_yaw, weights = infer(batch, seed)

    def on_device(x):
        return None if x is None else torch.as_tensor(np.asarray(x), device=traj.device)

    metrics = compute_metrics(
        traj, head_yaw, on_device(batch["gt_gripper_pred"]), on_device(batch.get("gt_head_yaw")),
        predict_head_yaw=cfg.predict_head_yaw, rotation_form="quaternion")
    return {
        "trajectory": traj.cpu().numpy(),
        # None under flash attention (no weights are materialized).
        "attention_weights": None if weights is None else weights.cpu().numpy(),
        "metrics": {k: v.cpu().numpy() for k, v in metrics.items()},
    }


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the app; returns the mean of each metric over the samples (NaN
    as None)."""
    previous_impl = get_default_attention_impl()
    try:
        return _run(argv)
    finally:
        set_default_attention_impl(previous_impl)


def _run(argv: Optional[List[str]]) -> Dict[str, Any]:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(message)s")
    cli_args = parse_args(OpenLoopAppArgs, argv)
    args = update_model_args_from_checkpoint(cli_args)
    if args.task is None or args.dataset is None:
        raise ValueError("--task and --dataset are required")
    device = resolve_device(None if args.device == "cuda" else args.device)

    embodiment = make_embodiment_for_task(args.task)
    extra, mode = resolve_keypose_params(args)
    loader, _ = get_data_loader_by_data_type(
        embodiment=embodiment,
        dataset_path=args.dataset,
        demos=args.demos_open_loop,
        num_workers=0,
        batch_size=1,
        use_keyposes=bool(args.use_keyposes),
        data_type=args.data_type,
        only_sample_keyposes=bool(args.only_sample_keyposes),
        extra_keyposes_around_grasp_events=extra,
        keypose_detection_mode=mode,
        include_failed_demos=False,
        sampling_weighting_type=SamplingWeightingType.NONE,
        num_history=args.num_history,
        prediction_horizon=args.prediction_horizon,
        add_external_cam=args.add_external_cam,
        num_vertices_to_sample=args.num_vertices_to_sample,
        vertex_sampling_method=args.vertex_sampling_method,
        rgbd_min_depth_threshold=args.rgbd_min_depth_threshold,
        seed=args.seed,
    )

    cfg = model_config_from_args(args, vertex_feature_dim=vertex_feature_dim(loader.dataset))
    bounds = get_workspace_bounds(args.task)
    trainer = Trainer(cfg, TrainerConfig(save_checkpoint=False), bounds, device=device)
    if args.checkpoint:
        trainer.load_checkpoint(str(args.checkpoint))
    else:
        logger.warning("No checkpoint given; evaluating a random-init model.")
        trainer.init_state()
    model = trainer.model
    model.eval()
    if args.ply_output_dir:
        set_default_attention_impl("eager")
        logger.info("--ply_output_dir: sampling with eager attention (the attention cloud "
                    "needs the cross-attention weights, which the flash kernels do not "
                    "materialize)")
    elif apply_inference_settings(convert_to_flash_attention()):
        raise AssertionError("convert_to_flash_attention returned sampler settings")

    metric_sums: Dict[str, np.ndarray] = {}
    count = 0
    infer = make_infer_fn(model, bounds)
    pca_projection = None
    for i, batch in enumerate(loader):
        result = run_inference(infer, model, batch, i)
        if args.ply_output_dir and batch.get("vertices") is not None:
            pca_projection = _export_sample_ply(args.ply_output_dir, i, batch, result,
                                                pca_projection)
        for k, v in result["metrics"].items():
            metric_sums[k] = metric_sums.get(k, 0.0) + v
        count += 1
    means = {k: (v / count).tolist() for k, v in metric_sums.items()}

    # Strict JSON: NaN is not valid JSON; vector metrics (lists) are
    # sanitized element-wise.
    def _no_nan(v):
        if isinstance(v, float) and v != v:
            return None
        if isinstance(v, list):
            return [_no_nan(x) for x in v]
        return v

    means = {k: _no_nan(v) for k, v in means.items()}
    logger.info("Open-loop metrics over %d samples:\n%s", count,
                json.dumps(means, indent=2, default=str))
    return means


def _export_sample_ply(output_dir, idx, batch, result, pca_projection):
    """Write feature-PCA and attention-colored context clouds + prediction."""
    os.makedirs(output_dir, exist_ok=True)
    vertices = np.asarray(batch["vertices"][0])
    features = np.asarray(batch["vertex_features"][0])
    pca_projection = save_feature_pointcloud_ply(
        os.path.join(output_dir, f"sample_{idx:04d}_features.ply"), vertices, features,
        pca_projection)
    if result["attention_weights"] is not None:
        weights = np.asarray(result["attention_weights"])[0].mean(axis=0)
        # The weights cover the context tokens; for mesh mode that is the
        # vertex set.
        n = min(len(weights), len(vertices))
        save_pointcloud_ply(os.path.join(output_dir, f"sample_{idx:04d}_attention.ply"),
                            vertices[:n], attention_to_colors(weights[:n]))
    pred = np.asarray(result["trajectory"])[0, :, :, :3].reshape(-1, 3)
    save_pointcloud_ply(os.path.join(output_dir, f"sample_{idx:04d}_prediction.ply"), pred)
    return pca_projection


if __name__ == "__main__":
    main(sys.argv[1:])
