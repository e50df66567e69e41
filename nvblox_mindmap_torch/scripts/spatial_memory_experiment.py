"""Spatial-memory experiment on the port: MESH (fused map) beats RGBD when
the target leaves the field of view.

The port's counterpart of ``nvblox_mindmap_tpu/scripts/spatial_memory_experiment.py``.
It tests upstream's headline claim (README.md:31-47, "act on things it has
seen in the past"; model_cards/model_overview.md:40-44): a policy
conditioned on the reconstructed feature map retains goal accuracy after
the camera looks away from the target, while a policy conditioned on
instantaneous RGB-D cannot.

Protocol (scene world, closed_loop/scene.py):
1. Record N scripted pick-and-place demos where the camera sees the cubes
   for the first few frames, then PANS AWAY for the rest of the episode.
   The expert approaches the pick from a FIXED staging pose, so the gripper
   history carries no information about the (randomized) cube position: at
   the pick keypose the policy must read its observation.
2. Train two policies identically except for data_type: "mesh" (datagen-fused
   feature map) vs "rgbd" (instantaneous camera point cloud).
3. Evaluate open-loop keypose error ON THE PICK KEYPOSES (targets within a
   cube-half of the randomized cube_2). Post-pan, the rgbd observation is
   IDENTICAL across scenes with different cube positions: its best possible
   prediction is the mean training position (an information-theoretic floor,
   not a capacity issue). The mesh observation still contains the cube.

Predictions run through the flash kernels. A keypose's ``eval_seeds``
samples are the rows of one sampler call, each from the noise of its own
seed (``apps/run_open_loop_policy.sampler_noise``); the estimator is the
JAX package's, the mean of independent draws.

Run: python -m nvblox_mindmap_torch.scripts.spatial_memory_experiment
     [--out /tmp/spatial_memory] [--num_demos 32] [--train_iters 12000]
     [--device cpu]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
card. Budget note (from the JAX package's runs): 1500 iters / 8 demos
leaves even FIXED keyposes at ~0.10 m error; sanity-check a fixed keypose
before reading anything into the mesh-vs-rgbd comparison.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import Dict, List

import numpy as np

from nvblox_mindmap_torch.apps.run_datagen import make_mapping_feature_fn, process_demo
from nvblox_mindmap_torch.apps.run_open_loop_policy import make_infer_fn
from nvblox_mindmap_torch.apps.run_training import main as train_main
from nvblox_mindmap_torch.closed_loop.evaluators import CubeStackingEvaluator
from nvblox_mindmap_torch.closed_loop.policies import NvbloxDiffuserActorPolicy
from nvblox_mindmap_torch.closed_loop.runner import ClosedLoopConfig, run_closed_loop_policy
from nvblox_mindmap_torch.closed_loop.scene import look_at_pose7
from nvblox_mindmap_torch.closed_loop.scripted import (
    env_from_scene_json,
    generate_cube_stacking_demos,
    make_cube_stacking_env,
    write_scene_json,
)
from nvblox_mindmap_torch.data.dataset import SamplingWeightingType
from nvblox_mindmap_torch.data.item_io import decode_png
from nvblox_mindmap_torch.data.keyposes import KeyposeDetectionMode
from nvblox_mindmap_torch.data.loader import get_data_loader_by_data_type
from nvblox_mindmap_torch.data.vertex_sampling import VertexSamplingMethod
from nvblox_mindmap_torch.device import DeviceLike, resolve_device
from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
from nvblox_mindmap_torch.mapping.constants import MappingConfig, get_workspace_bounds
from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActorConfig
from nvblox_mindmap_torch.scripts.task_success_experiment import flash_attention
from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig

CUBE_HALF = 0.04
STAGING = (0.5, 0.0, 0.22)
# Camera pans between these view targets over steps [PAN_START, PAN_END).
EYE = (0.5, -0.85, 0.55)
TARGET_SCENE = (0.5, 0.0, 0.05)
TARGET_AWAY = (-0.4, -1.1, 0.3)  # empty table corner: context, no cubes
PAN_START, PAN_END = 2, 5
# The place target (cube_1) is FIXED across scenes so the pick is the ONLY
# observation-dependent keypose: everything except "where is cube_2" is
# learnable from the gripper history alone, which isolates the
# spatial-memory question (can the policy find the remembered cube?) from
# general scene-understanding capacity at small data scale.
FIXED_CUBE1_XY = (0.62, 0.17)


def panning_camera_factory(env):
    """Camera schedule: observe the scene briefly, then pan away for good."""

    def camera_pose_fn(step: int) -> Dict[str, np.ndarray]:
        a = np.clip((step - PAN_START) / (PAN_END - PAN_START), 0.0, 1.0)
        target = (1 - a) * np.asarray(TARGET_SCENE) + a * np.asarray(TARGET_AWAY)
        return {"wrist": look_at_pose7(EYE, target)}

    return camera_pose_fn


def generate_panning_demos(dataset_dir: str, num_demos: int, seed: int = 100,
                           image_size: int = 64) -> List[str]:
    demos = generate_cube_stacking_demos(
        dataset_dir,
        num_demos,
        seed=seed,
        num_cubes=2,
        cube_half=CUBE_HALF,
        image_size=image_size,
        camera_pose_fn_factory=panning_camera_factory,
        approach_from=STAGING,
        fixed_positions={"cube_1": np.asarray(FIXED_CUBE1_XY)},
    )
    # Sanity: the pan actually removes the cubes from view - every frame
    # after PAN_END has zero cube-labelled pixels (ids 2..199 are objects).
    # The semantic PNGs are read through the port's own decoder.
    for demo in demos:
        segs = sorted(
            glob.glob(os.path.join(demo, "*.wrist_semantic.png")),
            key=lambda p: int(os.path.basename(p).split(".")[0]),
        )
        assert len(segs) > PAN_END + 2
        for path in segs[PAN_END + 1:]:
            seg = decode_png(path)
            cube_px = ((seg >= 2) & (seg < 200)).sum()
            assert cube_px == 0, (
                f"cubes still visible post-pan: {path} ({cube_px} px)"
            )
        early = decode_png(segs[0])
        assert ((early >= 2) & (early < 200)).sum() > 4, "cubes never seen"
    return demos


def fuse_demos(demo_dirs: List[str], device: DeviceLike = None) -> None:
    # Note the decay override inside _mapping_config: remembered surfaces
    # must stay alive while the camera is away; the task default
    # (0.98/frame) is tuned for continuous re-observation.
    cfg = _mapping_config()
    feature_fn = make_mapping_feature_fn("rgb", cfg.upscaled_feature_image_size, device=device)
    for d in demo_dirs:
        process_demo(d, ArmEmbodiment(), cfg, feature_fn, device=device)


def train_policy(dataset_dir: str, log_dir: str, data_type: str,
                 num_demos: int, train_iters: int, seed: int = 0,
                 embedding_dim: int = 72, batch_size: int = 32,
                 device: str = "cuda") -> str:
    train_main(
        [
            "--dataset", dataset_dir,
            "--task", "cube_stacking",
            "--data_type", data_type,
            "--feature_type", "rgb",
            "--demos_train", f"0-{num_demos - 1}",
            "--demos_valset", "0",
            "--embedding_dim", str(embedding_dim),
            # Production timestep count: a 25-step schedule leaves the
            # conditional DDPM sampler visibly wider; eval noise would
            # swamp the mesh-vs-rgbd gap this experiment shows.
            "--diffusion_timesteps", "100",
            "--fps_subsampling_factor", "4",
            "--num_vertices_to_sample", "512",
            "--image_size", "64,64",
            "--feature_image_size", "16,16",
            "--batch_size", str(batch_size),
            "--batch_size_val", "4",
            "--train_iters", str(train_iters),
            "--val_freq", str(train_iters),
            # Balance grasp/release flip samples (upstream cli/args.py:262):
            # the pick keypose this experiment scores is flip-adjacent, so
            # both arms (mesh and rgbd) learn it at equal sample budgets.
            "--sampling_weighting_type", "gripper_state_change",
            "--num_batches_per_test_eval", "1",
            "--skip_train_val", "1",
            "--base_log_dir", log_dir,
            "--seed", str(seed),
            "--device", str(device),
        ]
    )
    ckpts = sorted(
        {os.path.realpath(p) for p in glob.glob(
            os.path.join(log_dir, "checkpoints", "*", "last.ckpt"))}
    )
    assert len(ckpts) == 1, ckpts
    return ckpts[0]


def model_config(data_type: str, embedding_dim: int = 72) -> DiffuserActorConfig:
    """The experiment's model: width ``embedding_dim``, 8 heads, RGB
    features (16x16 image tokens for rgbd), DDPM-100, FPS factor 4."""
    return DiffuserActorConfig(
        embedding_dim=embedding_dim,
        num_attn_heads=8,
        data_type=data_type,
        feature_type="rgb",
        feature_image_size=(16, 16),
        vertex_feature_dim=3,
        diffusion_timesteps=100,
        fps_subsampling_factor=4,
    )


def load_policy_model(checkpoint: str, data_type: str, embedding_dim: int = 72,
                      device: DeviceLike = None):
    """The experiment's model in eval mode on ``device``, from a port-written
    or a JAX-written checkpoint."""
    trainer = Trainer(model_config(data_type, embedding_dim),
                      TrainerConfig(save_checkpoint=False),
                      get_workspace_bounds("cube_stacking"), device=device)
    trainer.load_checkpoint(checkpoint)
    trainer.model.eval()
    return trainer.model


def eval_pick_keypose_error(dataset_dir: str, demo_dirs: List[str],
                            checkpoint: str, data_type: str,
                            embedding_dim: int = 72,
                            eval_seeds: int = 5,
                            device: DeviceLike = None) -> Dict:
    """Open-loop error restricted to pick keyposes (targets at cube_2)."""
    model = load_policy_model(checkpoint, data_type, embedding_dim, device=device)
    bounds = get_workspace_bounds("cube_stacking")
    embodiment = ArmEmbodiment()
    infer = make_infer_fn(model, bounds)

    pick_errors, all_errors = [], []
    with flash_attention():
        for idx, demo in enumerate(demo_dirs):
            with open(os.path.join(demo, "scene.json")) as f:
                cube2 = np.asarray(json.load(f)["objects"]["cube_2"])
            loader, _ = get_data_loader_by_data_type(
                embodiment=embodiment,
                dataset_path=dataset_dir,
                demos=str(idx),
                num_workers=0,
                batch_size=1,
                use_keyposes=True,
                data_type=data_type,
                only_sample_keyposes=True,
                # MUST match the training app's task defaults
                # (embodiments/registry.py TASK_TO_* tables): evaluating
                # against a different keypose set scores the model on
                # targets it was never trained to predict.
                extra_keyposes_around_grasp_events=[5],
                keypose_detection_mode=(
                    KeyposeDetectionMode.HIGHEST_Z_BETWEEN_GRASP
                ),
                include_failed_demos=False,
                sampling_weighting_type=SamplingWeightingType.NONE,
                num_history=3,
                prediction_horizon=1,
                num_vertices_to_sample=512,
                # MUST match the training app default (utils/config.py):
                # the model was trained on randomly subsampled vertex sets.
                vertex_sampling_method=(
                    VertexSamplingMethod.RANDOM_WITHOUT_REPLACEMENT
                ),
                seed=0,
            )
            for i, batch in enumerate(loader):
                # Error of the multi-seed MEAN prediction: isolates what the
                # policy KNOWS (its conditional mean) from stochastic-DDPM
                # sampler width, which is identical machinery for both data
                # types.
                traj, _, _ = infer(batch, [1000 * s + idx * 31 + i for s in range(eval_seeds)])
                pred = traj[:, 0, 0, :3].cpu().numpy().mean(axis=0)
                gt = np.asarray(batch["gt_gripper_pred"])[0, 0, 0, :3]
                err = float(np.linalg.norm(pred - gt))
                all_errors.append(err)
                if np.linalg.norm(gt - cube2) < CUBE_HALF:
                    pick_errors.append(err)
    assert pick_errors, "no pick keyposes found in the evaluated demos"
    return {
        "data_type": data_type,
        "pick_keypose_error_m": float(np.mean(pick_errors)),
        "num_pick_keyposes": len(pick_errors),
        "all_keypose_error_m": float(np.mean(all_errors)),
        "num_keyposes": len(all_errors),
    }


def refresh_scene_jsons(dataset: str, num_demos: int, seed: int) -> None:
    """Re-write scene.json for already-recorded demos (envs are deterministic
    in seed), picking up the serialized panning-camera schedule."""
    for d in range(num_demos):
        demo = os.path.join(dataset, f"demo_{d:05d}")
        env = make_cube_stacking_env(
            seed + d, num_cubes=2, cube_half=CUBE_HALF, image_size=64,
            fixed_positions={"cube_1": np.asarray(FIXED_CUBE1_XY)},
        )
        env.camera_pose_fn = panning_camera_factory(env)
        env.steps = len(
            glob.glob(os.path.join(demo, "*.wrist_rgb.png"))
        )
        write_scene_json(demo, env)


def closed_loop_memory_eval(out_dir: str, data_type: str,
                            num_demos: int = 6, embedding_dim: int = 72,
                            seed: int = 100, device: DeviceLike = None) -> Dict:
    """Closed-loop rollouts on panning scenes: the camera looks away after
    the first frames, so the policy must act on remembered geometry
    (scripted pan -> online fusion -> diffusion goals ->
    CubeStackingEvaluator judging object state). The mesh policy can
    succeed; the rgbd policy has no information about the cube position
    once the pan completes."""
    dataset = os.path.join(out_dir, "demos")
    refresh_scene_jsons(dataset, num_demos, seed)
    ckpts = sorted({os.path.realpath(p) for p in glob.glob(os.path.join(
        out_dir, f"logs_{data_type}", "checkpoints", "*", "last.ckpt"))})
    assert len(ckpts) == 1, ckpts
    model = load_policy_model(ckpts[0], data_type, embedding_dim, device=device)
    embodiment = ArmEmbodiment()
    bounds = get_workspace_bounds("cube_stacking")

    def make_env(demo_path):
        env = env_from_scene_json(demo_path)
        with open(os.path.join(demo_path, "scene.json")) as f:
            assert env is not None and "camera_schedule" in f.read()
        return env

    mapping = _mapping_config()

    def make_policy(demo_path):
        return NvbloxDiffuserActorPolicy(
            model, embodiment, mapping, bounds,
            num_vertices_to_sample=512, seed=7, device=model.device,
        )

    evaluator = CubeStackingEvaluator(
        num_cubes=2, cube_side_length=2 * CUBE_HALF
    )
    demos = [os.path.join(dataset, f"demo_{d:05d}") for d in range(num_demos)]
    with flash_attention():
        summary = run_closed_loop_policy(
            make_env, make_policy, embodiment, evaluator, demo_names=demos,
            config=ClosedLoopConfig(
                max_num_steps=220, max_num_steps_to_goal=30, num_retries=2
            ),
        )
    return {"data_type": data_type, **summary}


def _mapping_config() -> MappingConfig:
    cfg = MappingConfig.for_task(
        "cube_stacking", feature_dim=3, voxel_size_m=0.02,
        max_feature_pages=512,
    ).scaled_for_image_size((64, 64))
    # Only the decay is experiment-specific: remembered surfaces must stay
    # alive while the camera is panned away (task default 0.98/frame is
    # tuned for continuous re-observation).
    return dataclasses.replace(cfg, tsdf_decay_factor=0.999)


def mean_predictor_floor(demo_dirs: List[str]) -> float:
    """Error the best scene-blind predictor (the training-set mean cube_2
    position) achieves on the pick keyposes: the information-theoretic
    floor a post-pan RGBD policy cannot beat."""
    cubes = []
    for demo in demo_dirs:
        with open(os.path.join(demo, "scene.json")) as f:
            cubes.append(np.asarray(json.load(f)["objects"]["cube_2"])[:3])
    cubes = np.stack(cubes)
    return float(
        np.mean(np.linalg.norm(cubes - cubes.mean(axis=0, keepdims=True),
                               axis=1))
    )


def run_experiment(out_dir: str, num_demos: int = 32, train_iters: int = 12000,
                   seed: int = 100, embedding_dim: int = 72,
                   batch_size: int = 32, eval_seeds: int = 5,
                   device=None) -> Dict:
    device = resolve_device(device)
    dataset = os.path.join(out_dir, "demos")
    demos = [
        os.path.join(dataset, f"demo_{d:05d}") for d in range(num_demos)
    ]
    # Resume: demo generation + fusion are deterministic in (seed, N); skip
    # them when every demo already carries a scene.json and fused meshes.
    if not all(
        os.path.exists(os.path.join(d, "scene.json"))
        and glob.glob(os.path.join(d, "*.nvblox_vertex_features.zst"))
        for d in demos
    ):
        demos = generate_panning_demos(dataset, num_demos, seed=seed)
        fuse_demos(demos, device=device)
    results = {}
    for data_type in ("mesh", "rgbd"):
        ckpt = train_policy(
            dataset, os.path.join(out_dir, f"logs_{data_type}"), data_type,
            num_demos, train_iters, embedding_dim=embedding_dim,
            batch_size=batch_size, device=device.type,
        )
        results[data_type] = eval_pick_keypose_error(
            dataset, demos, ckpt, data_type, embedding_dim=embedding_dim,
            eval_seeds=eval_seeds, device=device,
        )
    mesh_err = results["mesh"]["pick_keypose_error_m"]
    rgbd_err = results["rgbd"]["pick_keypose_error_m"]
    results["summary"] = {
        "mesh_pick_error_m": mesh_err,
        "rgbd_pick_error_m": rgbd_err,
        "rgbd_over_mesh_error_ratio": rgbd_err / max(mesh_err, 1e-9),
        # A scene-blind predictor's floor: rgbd should sit AT it post-pan,
        # mesh should beat it (it can still see the cube in the map).
        "mean_predictor_floor_m": mean_predictor_floor(demos),
        "num_demos": num_demos,
        "train_iters": train_iters,
        "embedding_dim": embedding_dim,
    }
    with open(os.path.join(out_dir, "spatial_memory_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="/tmp/spatial_memory")
    p.add_argument("--num_demos", type=int, default=32)
    p.add_argument("--train_iters", type=int, default=12000)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--embedding_dim", type=int, default=72)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--eval_seeds", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--closed_loop_demos", type=int, default=0,
                   help="after open-loop eval, run N closed-loop panning "
                        "scenes per arm (0 = skip)")
    p.add_argument("--only_closed_loop", action="store_true",
                   help="skip gen/train/eval; run closed-loop against the "
                        "checkpoints already under --out")
    args = p.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    if args.only_closed_loop:
        results = {}
        for data_type in ("mesh", "rgbd"):
            results[data_type] = closed_loop_memory_eval(
                args.out, data_type, num_demos=args.closed_loop_demos or 6,
                embedding_dim=args.embedding_dim, seed=args.seed, device=device,
            )
        path = os.path.join(args.out, "spatial_memory_results.json")
        if os.path.exists(path):
            with open(path) as f:
                merged = json.load(f)
        else:
            merged = {}
        merged["closed_loop"] = results
        with open(path, "w") as f:
            json.dump(merged, f, indent=2, default=str)
        print(json.dumps(results, indent=2, default=str))
        return
    results = run_experiment(args.out, args.num_demos, args.train_iters,
                             args.seed, args.embedding_dim, args.batch_size,
                             args.eval_seeds, device=device)
    if args.closed_loop_demos > 0:
        results["closed_loop"] = {
            data_type: closed_loop_memory_eval(
                args.out, data_type, num_demos=args.closed_loop_demos,
                embedding_dim=args.embedding_dim, seed=args.seed, device=device,
            )
            for data_type in ("mesh", "rgbd")
        }
        with open(os.path.join(args.out, "spatial_memory_results.json"),
                  "w") as f:
            json.dump(results, f, indent=2, default=str)
    print(json.dumps(results, indent=2, default=str))


if __name__ == "__main__":
    main()
