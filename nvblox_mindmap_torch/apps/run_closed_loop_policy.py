"""Closed-loop policy app: the port's counterpart of
``nvblox_mindmap_tpu/apps/run_closed_loop_policy.py`` (upstream
``mindmap/run_closed_loop_policy.py``).

Runs the trained policy (or the ground-truth keyposes) against an
environment. Without a simulator bridge, the built-in environments are:

- ``replay``: a recorded demo played back (the policy's map updates and goal
  requests run on recorded observations; no physics);
- ``scene``: the scene world rebuilt from the demo's ``scene.json`` (real
  cameras, object physics), judged by the task's evaluator;
- ``kinematic``: the scene world where the demo has a ``scene.json``, else a
  kinematic world seeded from the demo's first robot state with the GT
  keyposes as success waypoints.

Loading the model follows the training app's route for ``best.ckpt``: the
frozen ``training_args.json`` overlays the command line, the model config
comes from those args, and the checkpoint reader takes a port-written or a
JAX-written ``.ckpt``. While the app runs, flash attention is the
process-wide attention impl (the previous one is restored afterwards), so
every goal goes through the flash kernels. Serving samples with DDIM
deterministically or DDPM stochastically, from the policy's seeded
``torch.Generator``.

Usage::

    python -m nvblox_mindmap_torch.apps.run_closed_loop_policy --task cube_stacking \\
        --dataset <path> --demos_closed_loop 0-3 --checkpoint <dir>/best.ckpt \\
        --serving_scheduler ddim --serving_num_inference_steps 10

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
card.
"""
from __future__ import annotations

import logging
import sys
from typing import Any, Dict, List, Optional

from nvblox_mindmap_torch.apps.run_training import resolve_keypose_params
from nvblox_mindmap_torch.closed_loop.environment import (
    KinematicEnvironment,
    ReplayEnvironment,
)
from nvblox_mindmap_torch.closed_loop.evaluators import make_evaluator_for_task
from nvblox_mindmap_torch.closed_loop.policies import (
    GroundTruthPolicy,
    NvbloxDiffuserActorPolicy,
)
from nvblox_mindmap_torch.closed_loop.runner import ClosedLoopConfig, run_closed_loop_policy
from nvblox_mindmap_torch.closed_loop.scripted import env_from_scene_json
from nvblox_mindmap_torch.data.dataset import get_demo_paths
from nvblox_mindmap_torch.device import resolve_device
from nvblox_mindmap_torch.embodiments.base import EmbodimentType
from nvblox_mindmap_torch.embodiments.registry import make_embodiment_for_task
from nvblox_mindmap_torch.mapping.constants import MappingConfig, get_workspace_bounds
from nvblox_mindmap_torch.models.converter import (
    apply_inference_settings,
    convert_to_flash_attention,
)
from nvblox_mindmap_torch.models.feature_extractors import get_feature_dim
from nvblox_mindmap_torch.models.pretrained import make_feature_fn
from nvblox_mindmap_torch.ops.attention import (
    get_default_attention_impl,
    set_default_attention_impl,
)
from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig
from nvblox_mindmap_torch.utils.config import (
    ClosedLoopAppArgs,
    model_config_from_args,
    parse_args,
    update_model_args_from_checkpoint,
)

logger = logging.getLogger("nvblox_mindmap_torch.run_closed_loop_policy")

SUCCESS_SENTINEL = "CLOSED_LOOP_POLICY: ALL DEMOS SUCCESSFUL"


def main(argv: Optional[List[str]] = None, environment: str = "kinematic") -> Dict[str, Any]:
    """Run the app; returns the evaluator's summary."""
    previous_impl = get_default_attention_impl()
    try:
        return _run(argv, environment)
    finally:
        set_default_attention_impl(previous_impl)


def _run(argv: Optional[List[str]], environment: str) -> Dict[str, Any]:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(message)s")
    cli_args = parse_args(ClosedLoopAppArgs, argv)
    args = update_model_args_from_checkpoint(cli_args)
    if args.task is None or args.dataset is None:
        raise ValueError("--task and --dataset are required")
    device = resolve_device(None if args.device == "cuda" else args.device)

    embodiment = make_embodiment_for_task(args.task)
    extra, mode = resolve_keypose_params(args)
    bounds = get_workspace_bounds(args.task)
    feature_dim = get_feature_dim(args.feature_type)
    mapping_config = MappingConfig.for_task(
        args.task, feature_dim=feature_dim, voxel_size_m=args.voxel_size_m,
    ).scaled_for_image_size(tuple(args.image_size))

    demo_paths = get_demo_paths(args.dataset, args.demos_closed_loop)
    use_gt_policy = args.demo_mode in ("execute_gt_goals", "gt")

    model = feature_fn = None
    if not use_gt_policy:
        # Live mapping runs the feature extractor every sim step; a non-RGB
        # extractor needs converted pretrained weights (make_feature_fn
        # refuses to run one randomly initialized).
        if args.data_type in ("mesh", "rgbd_and_mesh"):
            feature_fn = make_feature_fn(
                args.feature_type, output_size=mapping_config.upscaled_feature_image_size,
                backbone_weights=args.backbone_weights,
                feature_image_size=tuple(args.feature_image_size), device=device)
        cfg = model_config_from_args(args, vertex_feature_dim=feature_dim)
        trainer = Trainer(cfg, TrainerConfig(batch_size=1, save_checkpoint=False), bounds,
                          device=device)
        if args.checkpoint:
            trainer.load_checkpoint(str(args.checkpoint))
        else:
            logger.warning("No checkpoint; running a random-init policy.")
            trainer.init_state()
        model = trainer.model
        model.eval()
        if apply_inference_settings(convert_to_flash_attention()):
            raise AssertionError("convert_to_flash_attention returned sampler settings")
        logger.info("serving sampler: %s, %s inference steps", args.serving_scheduler,
                    args.serving_num_inference_steps or cfg.diffusion_timesteps)

    def gt_goals_for(demo_path):
        return GroundTruthPolicy.from_demo(demo_path, embodiment, extra, mode)

    def make_env(demo_path):
        if environment == "replay":
            prefixes = (["wrist"] if embodiment.embodiment_type == EmbodimentType.ARM
                        else ["pov"])
            return ReplayEnvironment(demo_path, embodiment, prefixes)
        if environment in ("scene", "kinematic"):
            # Demos recorded in the scene world carry a scene.json; rebuilding
            # that world gives real cameras and object physics, so the task
            # evaluator judges actual task semantics.
            scene_env = env_from_scene_json(demo_path)
            if scene_env is not None:
                return scene_env
            if environment == "scene":
                raise FileNotFoundError(
                    f"environment='scene' requires {demo_path}/scene.json "
                    "(demos recorded via closed_loop/scripted.py)")
        gt = gt_goals_for(demo_path)
        return KinematicEnvironment(embodiment, gt.goals[0], [g[:3] for g in gt.goals[1:]])

    def make_policy(demo_path):
        if use_gt_policy:
            return gt_goals_for(demo_path)
        return NvbloxDiffuserActorPolicy(
            model, embodiment, mapping_config, bounds,
            num_vertices_to_sample=args.num_vertices_to_sample,
            vertex_sampling_method=args.vertex_sampling_method,
            feature_fn=feature_fn,
            num_history=args.num_history,
            seed=args.seed,
            include_dynamic=args.include_dynamic,
            num_prediction_samples=args.prediction_samples,
            num_inference_steps=args.serving_num_inference_steps,
            scheduler_kind=args.serving_scheduler,
            timestep_spacing=args.serving_timestep_spacing,
            # DDIM serves deterministically (eta = 0); DDPM keeps upstream's
            # stochastic sampling.
            stochastic_sampling=(args.serving_scheduler == "ddpm"),
            device=device,
        )

    # The probe env (does the environment expose object poses?) serves the
    # first attempt (the runner resets each episode anyway).
    probe = make_env(demo_paths[0]) if demo_paths else None
    probe_cache = {} if probe is None else {demo_paths[0]: probe}
    has_object_state = bool(probe is not None and probe.get_object_poses())

    def make_env_once(demo_path):
        cached = probe_cache.pop(demo_path, None)
        return cached if cached is not None else make_env(demo_path)

    # Scene-world demos may use other object counts and sizes than the Isaac
    # task defaults: the evaluator takes them from the probe scene.
    task_params = {}
    if probe is not None and hasattr(probe, "object_half"):
        names = [n for n in probe.get_object_poses() if n.startswith("cube_")]
        if names:
            task_params = {"num_cubes": len(names),
                           "cube_side_length": 2.0 * probe.object_half}
    evaluator = make_evaluator_for_task(args.task, eval_file_path=args.eval_file_path,
                                        env_has_object_state=has_object_state,
                                        task_params=task_params)
    config = ClosedLoopConfig(
        max_num_steps_to_goal=args.max_num_steps_to_goal,
        num_retries=args.num_retries,
        max_intermediate_distance_m=args.max_intermediate_distance_m,
        terminate_after_n_steps=args.terminate_after_n_steps,
    )
    summary = run_closed_loop_policy(make_env_once, make_policy, embodiment, evaluator,
                                     demo_names=demo_paths, config=config,
                                     eval_file_path=args.eval_file_path)
    if summary["success_rate"] == 1.0:
        # Scanned by end-to-end harnesses (upstream run_closed_loop_policy.py:129-131).
        print(SUCCESS_SENTINEL)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
