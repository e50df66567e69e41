"""Trained-policy task success in the scene world, end to end, on the port.

The port's counterpart of ``nvblox_mindmap_tpu/scripts/task_success_experiment.py``:
the capability chain upstream runs across three apps
(``run_isaaclab_datagen.py`` -> ``run_training.py`` ->
``closed_loop_policy.py:242-317``), here for any of the four tasks:
scripted expert demos in the scene world -> datagen fusion -> the training
app -> ``NvbloxDiffuserActorPolicy`` with live mapping -> the task's
object-state evaluator judging success.

Stages are resumable (artifacts persist under --out):
    gen        record + fuse N scripted demos for --task
               (+ --recovery_demos slip-and-recover expert demos)
    dagger     roll out the TRAINED policy on fresh scenes, expert takes
               over mid-episode; harvest + fuse --dagger_demos on-policy
               corrective demos (run after an initial 'train')
    train      train the diffusion policy with the production task defaults
               (include appended demos via --recovery_demos/--dagger_demos)
    openloop   per-keypose open-loop error against the TRAINING keypose set
    closedloop closed-loop rollout + task-evaluator summary (JSON to stdout
               and <out>/closed_loop_summary.json)
    heldout    closed-loop on freshly randomized scenes (disjoint seed)
    all        everything except heldout

Training notes (from the JAX package's runs of this chain):
  - The keypose set is part of the learning problem; open-loop eval uses the
    same per-task defaults the training app resolves (embodiments/registry.py).
  - sampling_weighting_type=gripper_state_change (upstream cli/args.py:262)
    balances the grasp/release flip samples; with uniform sampling at this
    data scale the release-keypose openness stays undertrained.

Goals and open-loop samples run through the flash kernels (the process-wide
attention impl is "flash" while those stages run, restored after them).
Open-loop samples draw their noise per seed through
``apps/run_open_loop_policy.sampler_noise``, the three seeds of a keypose as
the rows of one sampler call.

Run: python -m nvblox_mindmap_torch.scripts.task_success_experiment all
     [--task cube_stacking] [--out /tmp/task_success] [--num_demos 8]
     [--train_iters 8000] [--device cpu]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
card. Artifacts land under <out>/<task>/ (appended automatically), so
switching --task never resumes from another task's demos or checkpoint.
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from nvblox_mindmap_torch.apps.run_datagen import make_mapping_feature_fn, process_demo
from nvblox_mindmap_torch.apps.run_open_loop_policy import make_infer_fn
from nvblox_mindmap_torch.apps.run_training import main as train_main
from nvblox_mindmap_torch.apps.run_training import resolve_keypose_params
from nvblox_mindmap_torch.closed_loop import scripted
from nvblox_mindmap_torch.closed_loop.evaluators import make_evaluator_for_task
from nvblox_mindmap_torch.closed_loop.policies import NvbloxDiffuserActorPolicy
from nvblox_mindmap_torch.closed_loop.runner import ClosedLoopConfig, run_closed_loop_policy
from nvblox_mindmap_torch.data.dataset import SamplingWeightingType
from nvblox_mindmap_torch.data.loader import get_data_loader_by_data_type
from nvblox_mindmap_torch.data.vertex_sampling import VertexSamplingMethod
from nvblox_mindmap_torch.device import DeviceLike, resolve_device
from nvblox_mindmap_torch.embodiments.base import EmbodimentType
from nvblox_mindmap_torch.embodiments.registry import make_embodiment_for_task
from nvblox_mindmap_torch.mapping.constants import MappingConfig, get_workspace_bounds
from nvblox_mindmap_torch.models.converter import (
    apply_inference_settings,
    convert_to_flash_attention,
)
from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActorConfig
from nvblox_mindmap_torch.ops.attention import (
    get_default_attention_impl,
    set_default_attention_impl,
)
from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig
from nvblox_mindmap_torch.utils.config import TrainingAppArgs

CUBE_HALF = 0.04
N_VERTICES = 512
EMB = 72
TIMESTEPS = 100
FPS_SUBSAMPLING = 4
DEFAULT_TASK = "cube_stacking"
OPEN_LOOP_SEEDS = 3  # predictions averaged per keypose


@contextlib.contextmanager
def flash_attention():
    """Flash attention as the process-wide impl for the block, then the
    previous impl again."""
    previous = get_default_attention_impl()
    if apply_inference_settings(convert_to_flash_attention()):
        raise AssertionError("convert_to_flash_attention returned sampler settings")
    try:
        yield
    finally:
        set_default_attention_impl(previous)


def _generator_for_task(task: str):
    return {
        "cube_stacking": lambda ds, n, seed: scripted.generate_cube_stacking_demos(
            ds, num_demos=n, seed=seed, cube_half=CUBE_HALF
        ),
        "mug_in_drawer": lambda ds, n, seed: scripted.generate_mug_in_drawer_demos(
            ds, num_demos=n, seed=seed
        ),
        "drill_in_box": lambda ds, n, seed: scripted.generate_drill_in_box_demos(
            ds, num_demos=n, seed=seed
        ),
        "stick_in_bin": lambda ds, n, seed: scripted.generate_stick_in_bin_demos(
            ds, num_demos=n, seed=seed
        ),
    }[task]


def _embodiment_for_task(task: str):
    return make_embodiment_for_task(task)


def _evaluator_for_task(task: str):
    task_params = None
    if task == "cube_stacking":
        task_params = {"num_cubes": 2, "cube_side_length": 2 * CUBE_HALF}
    return make_evaluator_for_task(task, task_params=task_params)


def _fused(demo: str) -> bool:
    return bool(os.path.exists(os.path.join(demo, "scene.json"))
                and glob.glob(os.path.join(demo, "*.nvblox_vertex_features.zst")))


def gen_and_fuse(out: str, num_demos: int, seed: int,
                 task: str = DEFAULT_TASK,
                 recovery_demos: int = 0,
                 device: DeviceLike = None) -> List[str]:
    """Record ``num_demos`` expert demos (+ ``recovery_demos``) under
    ``<out>/ds`` and fuse their feature meshes on ``device``."""
    if recovery_demos:
        # Recovery scenes draw from their own seed range; keep it disjoint
        # from both the standard training scenes and the held-out eval
        # scenes (a --seed near HELDOUT_SEED-1000 would otherwise record
        # correctives on the exact scenes heldout_eval measures on).
        _assert_disjoint_seed_ranges(
            (seed, num_demos), (seed + 1000, recovery_demos),
            (HELDOUT_SEED, num_demos),
        )
    ds = os.path.join(out, "ds")
    total = num_demos + recovery_demos
    # Resume: generation + fusion are deterministic in (seed, N); skip when
    # every demo already carries a scene.json and fused meshes.
    expected = [os.path.join(ds, f"demo_{d:05d}") for d in range(total)]
    if all(_fused(d) for d in expected):
        return expected
    demos = _generator_for_task(task)(ds, num_demos, seed)
    if recovery_demos:
        # Slip-and-recover demos appended after the standard set, on scenes
        # disjoint from it (seed offset): (off-nominal state -> corrective
        # expert action) coverage.
        assert task == "cube_stacking", (
            "recovery demos are implemented for cube_stacking"
        )
        demos += scripted.generate_cube_stacking_recovery_demos(
            ds, recovery_demos, seed=seed + 1000, cube_half=CUBE_HALF,
            start_index=num_demos,
        )
    cfg = mapping_config(task)
    feature_fn = make_mapping_feature_fn("rgb", cfg.upscaled_feature_image_size, device=device)
    embodiment = _embodiment_for_task(task)
    for d in demos:
        process_demo(d, embodiment, cfg, feature_fn, device=device)
    return demos


def mapping_config(task: str = DEFAULT_TASK) -> MappingConfig:
    """The closed-loop app's config for 64x64 scene-world cameras."""
    return MappingConfig.for_task(
        task, feature_dim=3, voxel_size_m=0.02, max_feature_pages=512,
    ).scaled_for_image_size((64, 64))


DAGGER_SEED_OFFSET = 5000  # harvest scenes disjoint from train AND heldout


def dagger_gen(out: str, num_demos: int, checkpoint: str,
               dagger_demos: int, seed: int,
               task: str = DEFAULT_TASK,
               recovery_demos: int = 0,
               device: DeviceLike = None) -> List[str]:
    """Harvest on-policy corrective demos (the trained policy drives, the
    scripted expert takes over) and fuse them into the dataset.

    Demos land at indices [num_demos + recovery_demos, ... + dagger_demos)
    so a subsequent ``train --dagger_demos N`` picks them up via the widened
    --demos_train range. Rollout scenes use seed + DAGGER_SEED_OFFSET,
    disjoint from the training scenes and from HELDOUT_SEED.
    """
    assert task == "cube_stacking", (
        "dagger harvesting is implemented for cube_stacking"
    )
    ds = os.path.join(out, "ds")
    start = num_demos + recovery_demos
    expected = [
        os.path.join(ds, f"demo_{start + i:05d}")
        for i in range(dagger_demos)
    ]
    # Multi-round aggregation (the DAgger loop): demos already harvested by
    # earlier rounds are kept, and only the missing TAIL is rolled out, with
    # the CURRENT checkpoint, so each round's correctives target the states
    # the latest policy drifts to. Fresh scene seeds advance past the
    # existing demos (scenes are seeded harvest_seed + i in the generator).
    fused_flags = [_fused(d) for d in expected]
    n_existing = next(
        (i for i, f in enumerate(fused_flags) if not f), dagger_demos
    )
    assert not any(fused_flags[n_existing:]), (
        f"non-contiguous dagger demos under {ds}: {fused_flags}; remove the "
        "partial tail and re-run"
    )
    harvest_seed = seed + DAGGER_SEED_OFFSET + n_existing
    _assert_disjoint_seed_ranges(
        (seed, num_demos), (HELDOUT_SEED, num_demos),
        (harvest_seed, dagger_demos - n_existing),
    )
    if n_existing == dagger_demos:
        return expected
    model, _, bounds = load_model(checkpoint, task, device=device)
    embodiment = _embodiment_for_task(task)
    cfg = mapping_config(task)

    def make_policy():
        return NvbloxDiffuserActorPolicy(
            model, embodiment, cfg, bounds,
            num_vertices_to_sample=N_VERTICES, seed=7, device=model.device,
        )

    with flash_attention():
        demos, stats = scripted.generate_cube_stacking_dagger_demos(
            ds, dagger_demos - n_existing, make_policy, seed=harvest_seed,
            cube_half=CUBE_HALF, start_index=start + n_existing,
        )
    stats_path = os.path.join(out, "dagger_rollout_stats.json")
    if n_existing and os.path.exists(stats_path):
        with open(stats_path) as f:
            stats = json.load(f) + stats  # aggregate across rounds
    with open(stats_path, "w") as f:
        json.dump(stats, f, indent=2)
    print(json.dumps(stats, indent=2))
    feature_fn = make_mapping_feature_fn("rgb", cfg.upscaled_feature_image_size,
                                         device=model.device)
    for d in demos:
        process_demo(d, embodiment, cfg, feature_fn, device=model.device)
    return demos


def _assert_disjoint_seed_ranges(*ranges: Tuple[int, int]) -> None:
    """Each (start, n) scene-seed range must not overlap any other: an
    overlap silently evaluates on training (or harvest) scenes and inflates
    the generalization metric."""
    spans = [(s, s + max(n, 1)) for s, n in ranges]
    for i, (a0, a1) in enumerate(spans):
        for b0, b1 in spans[i + 1:]:
            assert a1 <= b0 or b1 <= a0, (
                f"scene-seed ranges overlap: {spans}; pick a --seed so "
                f"train/heldout/dagger scene seeds are disjoint"
            )


def train(out: str, num_demos: int, iters: int,
          task: str = DEFAULT_TASK,
          apply_geometry_noise: bool = False,
          pos_noise_stddev_m: float = 0.01,
          rot_noise_stddev_deg: float = 0.01,
          extra_demos: int = 0,
          balance_sources: bool = False,
          apply_random_transforms: bool = False,
          device: str = "cuda") -> str:
    """Train through the port's training app on ``device`` ("cuda" or
    "cpu"); returns the newest ``last.ckpt``.

    ``extra_demos``: appended recovery/dagger demos (indices >= num_demos)
    to include in --demos_train, the mixed expert+corrective dataset.
    ``balance_sources``: give the expert demos and the corrective demos equal
    total sampling mass (data/loader.py balance_demo_groups); N correctives
    otherwise dilute the nominal data N:num_demos.
    ``apply_random_transforms``: upstream's train-time SE(2) scene
    augmentation (cli/args.py:80-83; +-0.1 m xy translation + +-90 deg z yaw
    applied consistently to vertices, history, and targets), which defeats
    absolute-position memorization."""
    log_dir = os.path.join(out, "logs")
    noise_args = []
    if apply_random_transforms:
        noise_args += ["--apply_random_transforms", "1"]
    if balance_sources:
        assert extra_demos > 0, "--balance_sources needs corrective demos"
        noise_args += [
            "--balance_demo_groups",
            f"0-{num_demos - 1},{num_demos}-{num_demos + extra_demos - 1}",
        ]
    if apply_geometry_noise:
        # DART-style robustification (upstream cli/args.py:84-90): Gaussian
        # SE3 noise on the gripper HISTORY + mesh vertices, clean targets.
        noise_args += [
            "--apply_geometry_noise", "1",
            "--pos_noise_stddev_m", str(pos_noise_stddev_m),
            "--rot_noise_stddev_deg", str(rot_noise_stddev_deg),
        ]
    train_main(noise_args + [
        "--dataset", os.path.join(out, "ds"),
        "--task", task,
        "--data_type", "mesh",
        "--feature_type", "rgb",
        "--demos_train", f"0-{num_demos + extra_demos - 1}",
        "--demos_valset", "0",
        "--embedding_dim", str(EMB),
        "--diffusion_timesteps", str(TIMESTEPS),
        "--fps_subsampling_factor", str(FPS_SUBSAMPLING),
        "--num_vertices_to_sample", str(N_VERTICES),
        "--batch_size", "16",
        "--batch_size_val", "4",
        "--train_iters", str(iters),
        "--val_freq", "1000",
        "--num_batches_per_test_eval", "1",
        "--skip_train_val", "1",
        "--sampling_weighting_type", "gripper_state_change",
        "--base_log_dir", log_dir,
        "--seed", "0",
        "--device", str(device),
    ])
    return latest_checkpoint(out)


def latest_checkpoint(out: str) -> str:
    ckpts = sorted({os.path.realpath(p) for p in glob.glob(
        os.path.join(out, "logs", "checkpoints", "*", "last.ckpt"))})
    assert ckpts, f"no checkpoint under {out}/logs"
    return ckpts[-1]


def load_model(checkpoint: str, task: str = DEFAULT_TASK, device: DeviceLike = None
               ) -> Tuple:
    """(model in eval mode on ``device``, its config, the task's workspace
    bounds) from a port-written or a JAX-written checkpoint."""
    embodiment = _embodiment_for_task(task)
    cfg = DiffuserActorConfig(
        embedding_dim=EMB, num_attn_heads=8, data_type="mesh", feature_type="rgb",
        vertex_feature_dim=3,
        diffusion_timesteps=TIMESTEPS,
        fps_subsampling_factor=FPS_SUBSAMPLING,
        ngrippers=embodiment.num_grippers,
        predict_head_yaw=(
            embodiment.embodiment_type == EmbodimentType.HUMANOID
        ),
    )
    bounds = get_workspace_bounds(task)
    trainer = Trainer(cfg, TrainerConfig(batch_size=1, save_checkpoint=False), bounds,
                      device=device)
    trainer.load_checkpoint(checkpoint)
    model = trainer.model
    model.eval()
    return model, cfg, bounds


def open_loop_eval(out: str, num_demos: int, checkpoint: str,
                   task: str = DEFAULT_TASK, device: DeviceLike = None) -> Dict:
    """Per-keypose open-loop error against the TRAINING keypose set: each
    keypose's prediction is the mean of OPEN_LOOP_SEEDS samples (seeds
    97 * s + i for keypose i)."""
    model, cfg, bounds = load_model(checkpoint, task, device=device)
    infer = make_infer_fn(model, bounds)
    args = TrainingAppArgs(task=task)
    extra, mode = resolve_keypose_params(args)
    loader, _ = get_data_loader_by_data_type(
        embodiment=_embodiment_for_task(task),
        dataset_path=os.path.join(out, "ds"),
        demos=f"0-{num_demos - 1}",
        num_workers=0, batch_size=1, use_keyposes=True, data_type="mesh",
        only_sample_keyposes=True,
        extra_keyposes_around_grasp_events=extra,
        keypose_detection_mode=mode,
        include_failed_demos=False,
        sampling_weighting_type=SamplingWeightingType.NONE,
        num_history=3, prediction_horizon=1,
        num_vertices_to_sample=N_VERTICES,
        vertex_sampling_method=(
            VertexSamplingMethod.RANDOM_WITHOUT_REPLACEMENT
        ),
        seed=0, drop_last=False,
    )
    errors, openness_correct = [], []
    with flash_attention():
        for i, batch in enumerate(loader):
            # (num_grippers, 8) per seed: mean over grippers of the
            # seed-mean position error; openness accuracy over every
            # gripper slot.
            traj, _, _ = infer(batch, [97 * s + i for s in range(OPEN_LOOP_SEEDS)])
            pred = traj[:, 0].cpu().numpy().mean(axis=0)
            gt = np.asarray(batch["gt_gripper_pred"])[0, 0]
            errors.append(float(np.mean(
                np.linalg.norm(pred[:, :3] - gt[:, :3], axis=-1)
            )))
            openness_correct.extend(
                (pred[:, 7] >= 0.5) == (gt[:, 7] >= 0.5)
            )
    result = {
        "task": task,
        "mean_keypose_error_m": float(np.mean(errors)),
        "median_keypose_error_m": float(np.median(errors)),
        "openness_accuracy": float(np.mean(openness_correct)),
        "num_keyposes": len(errors),
        "keypose_errors_m": errors,
    }
    print(json.dumps(result, indent=2))
    return result


def closed_loop(out: str, num_demos: int, checkpoint: str,
                demos_subset: Optional[List[int]] = None,
                task: str = DEFAULT_TASK,
                prediction_samples: int = 1,
                ds_subdir: str = "ds",
                summary_name: str = "closed_loop_summary.json",
                num_inference_steps: Optional[int] = None,
                scheduler: str = "ddpm",
                timestep_spacing: str = "leading",
                clip_sample: Optional[bool] = None,
                device: DeviceLike = None) -> Dict:
    """Closed-loop rollouts of the policy on the demos' scenes, judged by the
    task's evaluator. ``scheduler``/``num_inference_steps`` select the
    reverse-diffusion sampler: the defaults reproduce upstream's closed-loop
    protocol (full stochastic DDPM at the training timestep count);
    ``--scheduler ddim --num_inference_steps 10`` is the serving mode
    upstream ships DDPM->DDIM conversion for (diffuser_actor/converter.py:51+)."""
    model, cfg, bounds = load_model(checkpoint, task, device=device)
    embodiment = _embodiment_for_task(task)
    ds = os.path.join(out, ds_subdir)
    indices = demos_subset or list(range(num_demos))
    demos = [os.path.join(ds, f"demo_{i:05d}") for i in indices]

    def make_env(demo_path):
        env = scripted.env_from_scene_json(demo_path)
        assert env is not None, f"{demo_path} has no scene.json"
        return env

    def make_policy(demo_path):
        return NvbloxDiffuserActorPolicy(
            model, embodiment, mapping_config(task), bounds,
            num_vertices_to_sample=N_VERTICES, seed=3,
            num_prediction_samples=prediction_samples,
            num_inference_steps=num_inference_steps,
            scheduler_kind=scheduler,
            timestep_spacing=timestep_spacing,
            clip_sample=clip_sample,
            # DDIM's deterministic (eta=0) variant is the serving config;
            # DDPM keeps upstream's stochastic sampling.
            stochastic_sampling=(scheduler == "ddpm"),
            device=model.device,
        )

    evaluator = _evaluator_for_task(task)
    # Step budgets: 220 suffices for the arm tasks; the humanoid demos are
    # longer (two-handed reach + head turns) and their ground-truth chains
    # validate at 500.
    max_steps = (
        500 if embodiment.embodiment_type == EmbodimentType.HUMANOID else 220
    )
    with flash_attention():
        summary = run_closed_loop_policy(
            make_env, make_policy, embodiment, evaluator, demo_names=demos,
            config=ClosedLoopConfig(
                max_num_steps=max_steps, max_num_steps_to_goal=30, num_retries=2
            ),
        )
    summary = {"task": task, **summary}
    print(json.dumps(summary, indent=2, default=str))
    with open(os.path.join(out, summary_name), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    return summary


HELDOUT_SEED = 1234  # disjoint from the training-scene seed (21)


def heldout_eval(out: str, num_demos: int, checkpoint: str,
                 task: str = DEFAULT_TASK,
                 prediction_samples: int = 1,
                 train_seed: int = 21,
                 num_inference_steps: Optional[int] = None,
                 scheduler: str = "ddpm",
                 timestep_spacing: str = "leading",
                 device: DeviceLike = None) -> Dict:
    """Closed-loop success on FRESHLY RANDOMIZED scenes (generalization).

    Upstream's closed-loop protocol replays the training demos' initial
    states (closed_loop_policy.py:242-317); this stage instead draws object
    placements with a disjoint generator seed and judges with the same
    object-state evaluator and retry budget. Scene generation reuses the
    scripted-expert generator (whose expert demo is ignored); only
    scene.json is needed to reset the world, so no fusion pass runs.
    """
    _assert_disjoint_seed_ranges(
        (train_seed, num_demos), (HELDOUT_SEED, num_demos)
    )
    hds = os.path.join(out, "heldout_ds")
    expected = [
        os.path.join(hds, f"demo_{d:05d}") for d in range(num_demos)
    ]
    if not all(
        os.path.exists(os.path.join(d, "scene.json")) for d in expected
    ):
        _generator_for_task(task)(hds, num_demos, HELDOUT_SEED)
    suffix = "" if scheduler == "ddpm" else f"_{scheduler}"
    return closed_loop(
        out, num_demos, checkpoint, task=task,
        prediction_samples=prediction_samples, ds_subdir="heldout_ds",
        summary_name=f"heldout_closed_loop_summary{suffix}.json",
        num_inference_steps=num_inference_steps, scheduler=scheduler,
        timestep_spacing=timestep_spacing, device=device,
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("stage", choices=[
        "gen", "dagger", "train", "openloop", "closedloop", "heldout",
        "all"])
    p.add_argument("--task", default=DEFAULT_TASK, choices=[
        "cube_stacking", "mug_in_drawer", "drill_in_box", "stick_in_bin"])
    p.add_argument("--out", default="/tmp/task_success")
    p.add_argument("--num_demos", type=int, default=8)
    p.add_argument("--train_iters", type=int, default=8000)
    p.add_argument("--seed", type=int, default=21)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument(
        "--apply_geometry_noise", type=int, default=0,
        help="Train with Gaussian SE3 noise on gripper history + vertices "
        "(GT targets stay clean), upstream's apply_geometry_noise "
        "(cli/args.py:84-90); counters closed-loop exposure drift",
    )
    p.add_argument("--pos_noise_stddev_m", type=float, default=0.01)
    p.add_argument("--rot_noise_stddev_deg", type=float, default=0.01)
    p.add_argument(
        "--apply_random_transforms", type=int, default=0,
        help="Train with upstream's SE(2) scene augmentation "
        "(cli/args.py:80-83): a shared random +-0.1 m xy shift + +-90 deg z "
        "yaw per sample, applied consistently to vertices/history/targets",
    )
    p.add_argument(
        "--prediction_samples", type=int, default=1,
        help="K>1 enables consensus goal prediction (K samples as one batch "
        "per goal; policies.aggregate_trajectory_samples)",
    )
    p.add_argument(
        "--recovery_demos", type=int, default=0,
        help="slip-and-recover expert demos appended after the standard set "
        "(gen stage) and included in training (train stage); "
        "scripted.generate_cube_stacking_recovery_demos",
    )
    p.add_argument(
        "--dagger_demos", type=int, default=0,
        help="on-policy corrective demos harvested by the 'dagger' stage "
        "(trained policy drives, expert takes over; "
        "scripted.generate_cube_stacking_dagger_demos) and included in "
        "training by the 'train' stage",
    )
    p.add_argument(
        "--balance_sources", type=int, default=0,
        help="1 = equal total sampling mass for the expert demos vs the "
        "recovery/dagger correctives during 'train' (loader "
        "balance_demo_groups)",
    )
    p.add_argument(
        "--scheduler", default="ddpm", choices=["ddpm", "ddim"],
        help="reverse-diffusion sampler for closedloop/heldout: ddpm "
        "(upstream protocol, stochastic, training timestep count) or ddim "
        "(serving mode; pair with --num_inference_steps 10)",
    )
    p.add_argument(
        "--num_inference_steps", type=int, default=0,
        help="denoising steps for closedloop/heldout (0 = the training "
        "timestep count)",
    )
    p.add_argument(
        "--timestep_spacing", default="leading",
        choices=["leading", "trailing"],
        help="few-step timestep spacing for closedloop/heldout: leading "
        "(diffusers/upstream parity) or trailing (starts the chain at "
        "t=T-1 where the init really is pure noise)",
    )
    args = p.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    # Namespace all artifacts by task: the gen-stage resume check and
    # latest_checkpoint() would otherwise silently reuse a previous task's
    # demos/checkpoint when --task changes under the same --out.
    if os.path.basename(os.path.normpath(args.out)) != args.task:
        args.out = os.path.join(args.out, args.task)
    os.makedirs(args.out, exist_ok=True)
    if args.stage in ("gen", "all"):
        gen_and_fuse(args.out, args.num_demos, args.seed, args.task,
                     recovery_demos=args.recovery_demos, device=device)
    if args.stage == "dagger":
        # Harvest with the CURRENT checkpoint (the pre-dagger policy) before
        # any mixed retrain overwrites latest_checkpoint's pick.
        dagger_gen(args.out, args.num_demos, latest_checkpoint(args.out),
                   args.dagger_demos, args.seed, task=args.task,
                   recovery_demos=args.recovery_demos, device=device)
    if args.stage in ("train", "all"):
        train(args.out, args.num_demos, args.train_iters, args.task,
              apply_geometry_noise=bool(args.apply_geometry_noise),
              pos_noise_stddev_m=args.pos_noise_stddev_m,
              rot_noise_stddev_deg=args.rot_noise_stddev_deg,
              extra_demos=args.recovery_demos + args.dagger_demos,
              balance_sources=bool(args.balance_sources),
              apply_random_transforms=bool(args.apply_random_transforms),
              device=device.type)
    if args.stage in ("openloop", "all"):
        open_loop_eval(
            args.out, args.num_demos, latest_checkpoint(args.out), args.task, device=device
        )
    steps = args.num_inference_steps or None
    if args.stage in ("closedloop", "all"):
        suffix = "" if args.scheduler == "ddpm" else f"_{args.scheduler}"
        closed_loop(
            args.out, args.num_demos, latest_checkpoint(args.out),
            task=args.task, prediction_samples=args.prediction_samples,
            summary_name=f"closed_loop_summary{suffix}.json",
            num_inference_steps=steps, scheduler=args.scheduler,
            timestep_spacing=args.timestep_spacing, device=device,
        )
    if args.stage == "heldout":
        heldout_eval(
            args.out, args.num_demos, latest_checkpoint(args.out),
            task=args.task, prediction_samples=args.prediction_samples,
            train_seed=args.seed,
            num_inference_steps=steps, scheduler=args.scheduler,
            timestep_spacing=args.timestep_spacing, device=device,
        )


if __name__ == "__main__":
    main()
