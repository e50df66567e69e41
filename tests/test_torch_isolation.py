"""The torch port stands alone: no JAX, no flax, nothing of the JAX package.

- A subprocess that blocks ``jax`` imports the port and runs small mesh and
  rgbd_and_mesh keypose predictions, a train step, an eval batch and a
  checkpoint round trip, and two mapping steps plus a goal of the
  closed-loop policy on the CPU, then checks which modules were loaded.
- A second subprocess, with ``jax``, ``flax``, ``optax``, ``zstandard``,
  ``imageio``, ``PIL``, ``wandb`` and ``matplotlib`` blocked, writes demos in
  the reference layout with the port's writer and trains on them through
  the port's training app (``--device cpu``), then resumes from its
  ``last.ckpt``; packs them (``scripts/pack_dataset``), trains from the
  packed epoch with the asynchronous checkpoint backend, resumes from its
  ``last/`` and serves a batch over two CPU devices.
- A third, with the same modules blocked, records a cube_stacking demo in
  the port's scene world and runs the datagen, validate-demos and
  closed-loop apps on it (``--device cpu``; the closed loop in its
  ground-truth and policy modes).
- A fourth, with the same modules blocked, runs a demo-set generator per
  embodiment (cube_stacking, drill_in_box), the task-success experiment's
  ``gen`` and ``openloop`` stages (``--device cpu``, at a small width), and
  the open-loop app with and without ``--ply_output_dir``.
- A fifth, with the same modules and ``orbax`` / ``tensorstore`` blocked,
  trains a CLIP rgbd_and_mesh model one step (the FPN moves, the trunk does
  not), runs the three checkpoint scripts on its ``best.ckpt`` and on a
  dataset, samples a language model through the flash op, and restores an
  orbax directory that the JAX package wrote (in this process, before).
- A sixth, with ``jax``, ``flax``, ``imageio``, ``matplotlib`` and ``wandb``
  blocked, writes a map with the port and runs ``visualize_nvblox_tensors``,
  ``generate_reconstruction_figures``, ``convert_maps_usd`` (``--device cpu``)
  and ``video_from_depth`` on it.
- A seventh, with those modules, ``h5py`` and CLIP's loader blocked, runs an
  episode through the bridge, the Isaac Lab adapter over a stand-in env,
  the humanoid hand, the decoder API, the new scripts and the workflow
  specs (the HDF5 tools raise naming h5py; the golden recipe exits 1).
- An eighth, with ``jax``, the reference readers, ``matplotlib`` and
  ``wandb`` blocked, runs the attention variants, the goal-gripper query,
  the rotations and the package exports, the 1D rotary code, the timers,
  ``ProfilerTrace``, flax's chunked msgpack form and the bench-table
  renderer's ``--check``.
- The simulator host's modules import with torch blocked.
- A scan of the port's sources and ``chip_smoke.py`` for such imports.
- Entry points called without a device on a machine without CUDA raise
  rather than fall back to the CPU (the packed loader and serving too,
  unless a CPU device is named; the map tools and the probe too).
"""
import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "nvblox_mindmap_tpu")

SMALL_PATH = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
import torch
from nvblox_mindmap_torch.models.converter import (
    apply_inference_settings, convert_diffusion_scheduler, convert_to_flash_attention)
from nvblox_mindmap_torch.models.diffuser_actor import (
    DiffuserActor, DiffuserActorConfig, prepare_inputs, sample_trajectory)

cfg = DiffuserActorConfig(embedding_dim=24, num_attn_heads=4, vertex_feature_dim=8,
                          diffusion_timesteps=10, fps_subsampling_factor=4)
torch.manual_seed(0)
model = DiffuserActor(cfg, device="cpu")
rng = np.random.default_rng(0)
q = rng.normal(size=(1, 3, 1, 4))
q /= np.linalg.norm(q, axis=-1, keepdims=True)
batch = {
    "gripper_history": np.concatenate(
        [rng.uniform(0, 1, (1, 3, 1, 3)), q, np.ones((1, 3, 1, 1))], -1).astype(np.float32),
    "vertices": rng.uniform(0, 1, (1, 32, 3)).astype(np.float32),
    "vertex_features": rng.normal(size=(1, 32, 8)).astype(np.float32),
}
bounds = np.asarray([[0, 0, 0], [1, 1, 1]], np.float32)
prepared = prepare_inputs(batch, bounds, cfg, device="cpu")
kw = apply_inference_settings(dict(convert_to_flash_attention(), **convert_diffusion_scheduler(5)))
traj, _, weights = sample_trajectory(model, prepared, bounds,
                                     generator=torch.Generator().manual_seed(0), **kw)
assert traj.shape == (1, 1, 1, 8) and bool(torch.isfinite(traj).all()) and weights is None

# Training, with the flash impl still installed: a train step, an eval batch,
# a checkpoint round trip.
import os
import tempfile
from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig

batch["gt_gripper_pred"] = batch["gripper_history"][:, -1:]
ckpt_dir = tempfile.mkdtemp()
tcfg = TrainerConfig(checkpoint_dir=ckpt_dir, eval_num_inference_steps=3)
trainer = Trainer(cfg, tcfg, bounds, device="cpu")
trainer.init_state()
assert bool(torch.isfinite(trainer.train_one_step(batch, 0)["total"]))
loss, metrics = trainer.evaluate_nsteps([batch], 0, 1, "val")
assert np.isfinite(loss) and np.isfinite(metrics["rot_error_deg"])
trainer._save_best_and_last(0, loss, None)
restored = Trainer(cfg, tcfg, bounds, device="cpu")
assert restored.load_checkpoint(os.path.join(ckpt_dir, "best.ckpt")) == (0, loss)
assert all(torch.equal(a, b) for a, b in zip(trainer.model.state_dict().values(),
                                             restored.model.state_dict().values()))

# rgbd_and_mesh through a registry ViT (DINOv2 geometry, 2x2 patch grid,
# random weights) with uint8 images; the backbone-checkpoint modules import.
import nvblox_mindmap_torch.models.pretrained  # noqa: F401
cfg = DiffuserActorConfig(embedding_dim=24, num_attn_heads=4, vertex_feature_dim=8,
                          data_type="rgbd_and_mesh", feature_type="dino_v2_vits14",
                          feature_image_size=(2, 2), diffusion_timesteps=10,
                          fps_subsampling_factor=4)
model = DiffuserActor(cfg, device="cpu")
batch["rgbs"] = rng.integers(0, 256, (1, 2, 28, 28, 3)).astype(np.uint8)
batch["pcds"] = rng.uniform(0, 1, (1, 2, 28, 28, 3)).astype(np.float32)
batch["pcd_valid_mask"] = np.ones((1, 2, 28, 28), bool)
prepared = prepare_inputs(batch, bounds, cfg, device="cpu")
traj, _, _ = sample_trajectory(model, prepared, bounds,
                               generator=torch.Generator().manual_seed(0), **kw)
assert traj.shape == (1, 1, 1, 8) and bool(torch.isfinite(traj).all())
# Live mapping and the closed-loop policy: two sim steps into a 0.05 m map,
# then a goal from the mesh model above.
from nvblox_mindmap_torch.closed_loop.environment import CameraFrame, EnvironmentBase
from nvblox_mindmap_torch.closed_loop.policies import NvbloxDiffuserActorPolicy
from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
from nvblox_mindmap_torch.mapping.constants import MappingConfig


class Wall(EnvironmentBase):
    semantic_id_to_class = {1: "robot"}

    def get_policy_state(self):
        return np.asarray([0.5, 0.5, 0.5, 1, 0, 0, 0, 0], np.float32)

    def get_cameras(self):
        seg = np.zeros((32, 32), np.int32)
        seg[:8, :8] = 1
        K = np.asarray([[32.0, 0, 16], [0, 32.0, 16], [0, 0, 1]], np.float32)
        return {"cam": CameraFrame(np.full((32, 32, 3), 0.5, np.float32),
                                   np.full((32, 32), 0.8, np.float32), K,
                                   np.asarray([0.5, 0.5, 0, 1, 0, 0, 0]), seg)}


cfg = DiffuserActorConfig(embedding_dim=24, num_attn_heads=4, vertex_feature_dim=3,
                          diffusion_timesteps=10, fps_subsampling_factor=4)
mapping = MappingConfig(voxel_size_m=0.05, aabb_min_m=(0, 0, 0), aabb_max_m=(1, 1, 1),
                        min_integration_distance_m=0.1, feature_dim=3, max_feature_pages=64,
                        upscaled_feature_image_size=(32, 32), dynamic_class_labels=("robot",),
                        static_mask_erosion_iterations=1, valid_depth_mask_erosion_iterations=1)
policy = NvbloxDiffuserActorPolicy(DiffuserActor(cfg, device="cpu"), ArmEmbodiment(), mapping,
                                   bounds, num_vertices_to_sample=32, num_inference_steps=3,
                                   scheduler_kind="ddim", stochastic_sampling=False,
                                   device="cpu")
env = Wall()
policy.step(env)
policy.step(env)
goals = policy.get_new_goal(env)
assert len(goals) == 1 and goals[0].shape == (8,) and np.isfinite(goals[0]).all()
assert policy.mapper.last_crossing_count > 32
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in {FORBIDDEN})
print("LOADED", loaded)
"""


def test_port_runs_with_jax_blocked():
    code = SMALL_PATH.replace("{FORBIDDEN}", repr(set(FORBIDDEN)))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


APP_PATH = r"""
import sys
for name in ("jax", "flax", "optax", "zstandard", "imageio", "PIL", "wandb", "matplotlib"):
    sys.modules[name] = None  # any import of it now raises ImportError
import os
import tempfile
import numpy as np
from nvblox_mindmap_torch.apps import run_training as app
from nvblox_mindmap_torch.data.writer import DemoWriter

root = tempfile.mkdtemp()
rng = np.random.default_rng(0)
n = 90
t = np.linspace(0, 1, n)
pos = np.stack([0.3 + 0.3 * t, 0.1 * np.sin(2 * np.pi * t), 0.2 + 0.3 * np.sin(np.pi * t)], 1)
jaws = np.full((n, 2), 0.04)
jaws[40:46] = 0.04 - (np.arange(40, 46)[:, None] - 39) * 0.005
jaws[46:80] = 0.01
jaws[80:86] = 0.01 + (np.arange(80, 86)[:, None] - 79) * 0.005
K = np.asarray([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32)
for d in range(2):
    writer = DemoWriter(os.path.join(root, f"demo_0000{d}"))
    for i in range(n):
        writer.write_robot_state(i, np.concatenate([pos[i], [1.0, 0, 0, 0], jaws[i]]))
        writer.write_camera_frame(i, "wrist", rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
                                  0.8 + 0.05 * rng.uniform(size=(16, 16)),
                                  np.asarray([0.3, 0, 0.9, 0, 1, 0, 0]), K)
        writer.write_vertex_features(i, rng.uniform(-0.2, 0.9, (40, 3)),
                                     rng.uniform(0, 1, (40, 3)))
    writer.write_outcome(1)
argv = ["--task", "cube_stacking", "--data_type", "rgbd_and_mesh", "--feature_type", "rgb",
        "--feature_image_size", "2,2", "--embedding_dim", "24", "--diffusion_timesteps", "5",
        "--fps_subsampling_factor", "4", "--num_vertices_to_sample", "16", "--device", "cpu",
        "--dataset", root, "--demos_train", "0", "--demos_valset", "1", "--batch_size", "4",
        "--batch_size_val", "4", "--train_iters", "2", "--val_freq", "2",
        "--num_batches_per_test_eval", "1", "--skip_train_val", "1", "--num_workers", "2",
        "--base_log_dir", os.path.join(root, "logs")]
result = app.main(argv)
names = sorted(os.listdir(result["checkpoint_dir"]))
assert {"best.ckpt", "last.ckpt", "training_args.json"} <= set(names), names
assert np.isfinite(result["best_loss"])
last = os.path.join(result["checkpoint_dir"], "last.ckpt")
resumed = app.main(argv[:-1] + [os.path.join(root, "logs2"), "--checkpoint", last,
                                "--train_iters", "3"])
# As the JAX app does, the run resumes at the saved iteration (1): steps 1-2.
assert resumed["start_iter"] == 1 and resumed["trainer"].optimizer.count == 2 + 2
# A packed epoch, the asynchronous checkpoint backend, and batched serving.
import torch
from nvblox_mindmap_torch.data.packed import PackedEpoch
from nvblox_mindmap_torch.models.converter import convert_diffusion_scheduler
from nvblox_mindmap_torch.parallel.serving import make_sharded_infer_fn
from nvblox_mindmap_torch.scripts import pack_dataset

packed = os.path.join(root, "packed")
pack_dataset.main(argv + ["--packed_out", packed, "--packed_num_batches", "2"])
run = argv[:-1] + [os.path.join(root, "logs3"), "--packed_dataset", packed,
                   "--checkpoint_backend", "orbax"]
result = app.main(run)
last = os.path.join(result["checkpoint_dir"], "last")
assert os.path.isdir(last)
resumed = app.main(run + ["--checkpoint", last, "--train_iters", "3"])
assert resumed["start_iter"] == 1
model = resumed["trainer"].model
infer = make_sharded_infer_fn(model, app.get_workspace_bounds("cube_stacking"), ["cpu", "cpu"],
                              **convert_diffusion_scheduler(2))
traj, _, _ = infer(model.state_dict(), PackedEpoch(packed).batch(0),
                   generator=torch.Generator().manual_seed(0))
assert traj.shape == (4, 1, 1, 8) and bool(torch.isfinite(traj).all())
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in {FORBIDDEN})
print("LOADED", loaded)
"""


def test_training_app_runs_without_the_reference_readers():
    blocked = FORBIDDEN + ("zstandard", "imageio", "PIL", "wandb", "matplotlib")
    code = APP_PATH.replace("{FORBIDDEN}", repr(set(blocked)))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


LOOP_APPS = r"""
import sys
for name in ("jax", "flax", "optax", "zstandard", "imageio", "PIL", "wandb", "matplotlib"):
    sys.modules[name] = None  # any import of it now raises ImportError
import os
import tempfile
import numpy as np
from nvblox_mindmap_torch.apps import run_closed_loop_policy, run_datagen, run_validate_demos
from nvblox_mindmap_torch.closed_loop import scripted

root = tempfile.mkdtemp()
demo = os.path.join(root, "demo_00000")
env = scripted.make_cube_stacking_env(0, image_size=32)
n = scripted.record_scripted_demo(demo, env, scripted.scripted_stack_goals(env.initial_objects,
                                                                          0.04))
scripted.write_scene_json(demo, env)
common = ["--task", "cube_stacking", "--dataset", root, "--device", "cpu",
          "--image_size", "32,32", "--voxel_size_m", "0.04", "--feature_type", "rgb"]
run_datagen.main(common + ["--demos_datagen", "0", "--max_num_steps", "4",
                           "--save_serialized_nvblox_map_to_disk", "1"])
assert os.path.exists(os.path.join(demo, "3.nvblox_vertex_features.zst"))
assert run_validate_demos.main(common[:6] + ["--demos_closed_loop", "0"]) == {demo: True}
summary = run_closed_loop_policy.main(common + ["--demo_mode", "execute_gt_goals"], "scene")
assert summary["success_rate"] == 1.0, summary
summary = run_closed_loop_policy.main(common + [
    "--data_type", "mesh", "--embedding_dim", "24", "--diffusion_timesteps", "5",
    "--fps_subsampling_factor", "4", "--num_vertices_to_sample", "32",
    "--serving_scheduler", "ddim", "--serving_num_inference_steps", "2",
    "--max_num_steps_to_goal", "2", "--terminate_after_n_steps", "5"], "scene")
assert summary["num_demos"] == 1
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in {FORBIDDEN})
print("LOADED", loaded)
"""


def test_loop_apps_run_without_the_reference_readers():
    blocked = FORBIDDEN + ("zstandard", "imageio", "PIL", "wandb", "matplotlib")
    code = LOOP_APPS.replace("{FORBIDDEN}", repr(set(blocked)))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


EXPERIMENTS = r"""
import sys
for name in ("jax", "flax", "optax", "zstandard", "imageio", "PIL", "wandb", "matplotlib"):
    sys.modules[name] = None  # any import of it now raises ImportError
import glob
import os
import tempfile
import numpy as np
import torch
from nvblox_mindmap_torch.apps import run_open_loop_policy
from nvblox_mindmap_torch.closed_loop import scripted
from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActorConfig
from nvblox_mindmap_torch.scripts import spatial_memory_experiment  # noqa: F401
from nvblox_mindmap_torch.scripts import task_success_experiment as exp
from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig

# Thousands of tiny ops: one intra-op thread is fastest, and keeps parallel
# test workers from oversubscribing cores.
torch.set_num_threads(1)
root = tempfile.mkdtemp()
# A demo-set generator per embodiment.
scripted.generate_cube_stacking_demos(os.path.join(root, "arm"), 1, seed=3, image_size=32)
(humanoid,) = scripted.generate_drill_in_box_demos(os.path.join(root, "h"), 1, seed=3,
                                                   image_size=32)
assert np.load(os.path.join(humanoid, "0.robot_state.npy")).shape == (37,)
# The experiment's gen and openloop stages, at a small width (the stages read
# the module's model constants), from a checkpoint of that width.
exp.EMB, exp.TIMESTEPS, exp.N_VERTICES = 24, 5, 64
out = os.path.join(root, "exp")
common = ["--out", out, "--num_demos", "1", "--device", "cpu"]
exp.main(["gen"] + common)
cfg = DiffuserActorConfig(embedding_dim=24, data_type="mesh", feature_type="rgb",
                          vertex_feature_dim=3, diffusion_timesteps=5, fps_subsampling_factor=4)
trainer = Trainer(cfg, TrainerConfig(checkpoint_dir=os.path.join(
    out, "cube_stacking", "logs", "checkpoints", "run")),
    exp.get_workspace_bounds("cube_stacking"), device="cpu")
trainer.init_state()
trainer._save_best_and_last(0, 1.0, None)
exp.main(["openloop"] + common)
# The open-loop app on the stage's dataset, then with its three clouds.
argv = ["--dataset", os.path.join(out, "cube_stacking", "ds"), "--task", "cube_stacking",
        "--demos_open_loop", "0", "--checkpoint", exp.latest_checkpoint(
            os.path.join(out, "cube_stacking")), "--device", "cpu", "--data_type", "mesh",
        "--feature_type", "rgb", "--embedding_dim", "24", "--diffusion_timesteps", "5",
        "--num_vertices_to_sample", "64", "--only_sample_keyposes", "1"]
assert np.isfinite(run_open_loop_policy.main(argv)["distance_m"])
ply = os.path.join(root, "ply")
run_open_loop_policy.main(argv + ["--ply_output_dir", ply])
for kind in ("features", "attention", "prediction"):
    assert glob.glob(os.path.join(ply, f"sample_0000_{kind}.ply")), kind
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in {FORBIDDEN})
print("LOADED", loaded)
"""


def test_experiments_run_without_the_reference_readers():
    blocked = FORBIDDEN + ("zstandard", "imageio", "PIL", "wandb", "matplotlib")
    code = EXPERIMENTS.replace("{FORBIDDEN}", repr(set(blocked)))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


CLIP_LANGUAGE = r"""
import sys
for name in ("jax", "flax", "optax", "orbax", "tensorstore", "zstandard", "imageio", "PIL",
             "wandb", "matplotlib"):
    sys.modules[name] = None  # any import of it now raises ImportError
import os
import tempfile
import numpy as np
import torch
from nvblox_mindmap_torch.data.writer import DemoWriter
from nvblox_mindmap_torch.models.converter import (
    apply_inference_settings, convert_diffusion_scheduler, convert_to_flash_attention)
from nvblox_mindmap_torch.models.diffuser_actor import (
    DiffuserActorConfig, prepare_inputs, sample_trajectory)
from nvblox_mindmap_torch.models.pretrained import make_feature_fn
from nvblox_mindmap_torch.scripts import (
    checkpoint_tools, extract_fpn_from_model, extract_image_features)
from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)
root = tempfile.mkdtemp()
rng = np.random.default_rng(0)
bounds = np.asarray([[0, 0, 0], [1, 1, 1]], np.float32)
q = rng.normal(size=(2, 3, 1, 4))
q /= np.linalg.norm(q, axis=-1, keepdims=True)
history = np.concatenate([rng.uniform(0, 1, (2, 3, 1, 3)), q, np.ones((2, 3, 1, 1))], -1)
batch = {"gripper_history": history.astype(np.float32),
         "gt_gripper_pred": history[:, -1:].astype(np.float32),
         "rgbs": rng.integers(0, 256, (2, 1, 32, 32, 3)).astype(np.uint8),
         "pcds": rng.uniform(0, 1, (2, 1, 32, 32, 3)).astype(np.float32),
         "vertices": rng.uniform(0, 1, (2, 16, 3)).astype(np.float32),
         "vertex_features": rng.normal(size=(2, 16, 120)).astype(np.float32)}
# CLIP: one train step moves the FPN and leaves the trunk.
cfg = DiffuserActorConfig(embedding_dim=24, num_attn_heads=4, vertex_feature_dim=120,
                          data_type="rgbd_and_mesh", feature_type="clip_resnet50_fpn",
                          feature_image_size=(4, 4), diffusion_timesteps=10,
                          fps_subsampling_factor=4)
trainer = Trainer(cfg, TrainerConfig(checkpoint_dir=os.path.join(root, "ckpt")), bounds,
                  device="cpu")
trainer.init_state()
before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
assert bool(torch.isfinite(trainer.train_one_step(batch, 0)["total"]))
after = trainer.model.state_dict()
assert all(torch.equal(after[k], v) for k, v in before.items() if ".backbone." in k)
assert not torch.equal(after["encoder.feature_extractor.fpn.layer_2.weight"],
                       before["encoder.feature_extractor.fpn.layer_2.weight"])
trainer._save_best_and_last(0, 1.0, None)
best = os.path.join(root, "ckpt", "best.ckpt")
# The three scripts.
assert checkpoint_tools.print_checkpoint_info(best) == (0, 1.0)
checkpoint_tools.main(["extract", best, "encoder/feature_extractor/fpn",
                       os.path.join(root, "fpn.msgpack")])
assert "inner_2" in checkpoint_tools.load_subtree(os.path.join(root, "fpn.msgpack"))
npz = os.path.join(root, "fpn.npz")
extract_fpn_from_model.main(["--model_path", best, "--output_path", npz])
frame = rng.uniform(size=(32, 32, 3)).astype(np.float32)
features = make_feature_fn("clip_resnet50_fpn", (8, 8), npz, (4, 4), device="cpu")(frame)
assert features.shape == (8, 8, 120) and bool(torch.isfinite(features).all())
writer = DemoWriter(os.path.join(root, "ds", "demo_00000"))
K = np.asarray([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32)
writer.write_camera_frame(0, "wrist", rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
                          np.full((16, 16), 0.8), np.asarray([0, 0, 1, 1, 0, 0, 0]), K)
extract_image_features.main(["--dataset", os.path.join(root, "ds"), "--feature_type",
                             "clip_resnet50_fpn", "--feature_image_size", "4", "--device", "cpu"])
assert np.load(os.path.join(root, "ds", "demo_00000", "0.wrist_features.npy")).shape == (4, 4, 120)
# Language, through the flash op.
cfg = DiffuserActorConfig(embedding_dim=24, num_attn_heads=4, vertex_feature_dim=120,
                          use_instruction=True, lang_enhanced=True, diffusion_timesteps=10,
                          fps_subsampling_factor=4)
torch.manual_seed(0)
from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActor
model = DiffuserActor(cfg, device="cpu")
batch["instruction"] = rng.normal(size=(2, 53, 512)).astype(np.float32)
kw = apply_inference_settings(dict(convert_to_flash_attention(), **convert_diffusion_scheduler(3)))
traj, _, _ = sample_trajectory(model, prepare_inputs(batch, bounds, cfg, device="cpu"), bounds,
                               generator=torch.Generator().manual_seed(0), **kw)
assert traj.shape == (2, 1, 1, 8) and bool(torch.isfinite(traj).all())
# A JAX-written orbax directory, without tensorstore.
cfg = DiffuserActorConfig(embedding_dim=24, num_attn_heads=4, vertex_feature_dim=8,
                          diffusion_timesteps=100, fps_subsampling_factor=4)
trainer = Trainer(cfg, TrainerConfig(), bounds, device="cpu")
assert trainer.load_checkpoint(sys.argv[1]) == (3, 0.5)
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in {FORBIDDEN})
print("LOADED", loaded)
"""


def test_clip_language_scripts_and_jax_orbax_run_without_jax(tmp_path):
    from nvblox_mindmap_tpu.training import trainer as jtrainer
    from nvblox_mindmap_tpu.training.orbax_checkpoint import OrbaxCheckpointer
    from tests.test_torch_model_parity import configs
    from tests.test_torch_training import SMALL, mesh_batch

    jcfg, _ = configs(8, **SMALL)
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(batch_size=2),
                          np.asarray([[0, 0, 0], [1, 1, 1]], np.float32))
    params, opt_state = jt.init_state(mesh_batch(np.random.default_rng(0)))
    jckpt = OrbaxCheckpointer(str(tmp_path), async_write=False)
    jckpt.save("last", params, opt_state, 3, 0.5)
    blocked = FORBIDDEN + ("zstandard", "imageio", "PIL", "wandb", "matplotlib")
    code = CLIP_LANGUAGE.replace("{FORBIDDEN}", repr(set(blocked)))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "last")], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


RECONSTRUCTION = r"""
import sys
for name in {FORBIDDEN}:
    sys.modules[name] = None  # any import of it now raises ImportError
import glob
import os
import tempfile
import numpy as np
import torch
from nvblox_mindmap_torch.data.item_io import decode_png, encode_png
from nvblox_mindmap_torch.mapping.constants import MapperId, MappingConfig
from nvblox_mindmap_torch.mapping.mapper import Mapper
from nvblox_mindmap_torch.scripts import (
    convert_maps_usd, generate_reconstruction_figures, video_from_depth,
    visualize_nvblox_tensors)

root = tempfile.mkdtemp()
cfg = MappingConfig(voxel_size_m=0.02, aabb_min_m=(-0.5, -0.5, 0.5), aabb_max_m=(0.5, 0.5, 1.5),
                    min_integration_distance_m=0.1, feature_dim=4, max_feature_pages=256)
mapper = Mapper({MapperId.STATIC: cfg}, device="cpu")
K = np.asarray([[64.0, 0, 32], [0, 64.0, 32], [0, 0, 1]], np.float32)
rng = np.random.default_rng(0)
depth = (1.0 + 0.02 * rng.standard_normal((64, 64))).astype(np.float32)
mapper.add_depth_frame(depth, np.eye(4), K)
mapper.add_color_frame(rng.uniform(size=(64, 64, 3)), np.eye(4), K)
mapper.add_feature_frame(rng.uniform(size=(64, 64, 4)).astype(np.float32), np.eye(4), K)
path = os.path.join(root, "0000.nvblox_map_static.nvblx")
mapper.save_map(path)
visualize_nvblox_tensors.main(["--map", path, "--output_dir", os.path.join(root, "viz"),
                               "--device", "cpu"])
assert decode_png(os.path.join(root, "viz", "tsdf_slice_0.png")).ndim == 3
assert os.path.getsize(os.path.join(root, "viz", "surface.ply")) > 0
generate_reconstruction_figures.main(["--map_path", path, "--output_dir",
                                      os.path.join(root, "figs"), "--device", "cpu"])
for kind in ("color_mesh", "feature_cubes_mesh"):
    assert decode_png(os.path.join(root, "figs", f"0000_{kind}.png")).shape[2] == 3
convert_maps_usd.main(["--input_dir", root, "--device", "cpu"])
with open(os.path.join(root, "0000.nvblox_map_static.usda")) as f:
    assert f.read().startswith("#usda 1.0")
os.makedirs(os.path.join(root, "depth"))
for i in range(3):
    encode_png(os.path.join(root, "depth", f"{i}.wrist_depth.png"),
               rng.integers(300, 2000, (16, 16)).astype(np.uint16))
video_from_depth.main([os.path.join(root, "depth"), os.path.join(root, "out", "d.mp4")])
assert len(glob.glob(os.path.join(root, "out", "d_*.png"))) == 3
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in {FORBIDDEN})
print("LOADED", loaded)
"""


def test_reconstruction_tools_run_without_jax_imageio_matplotlib_wandb():
    blocked = FORBIDDEN + ("imageio", "matplotlib", "wandb")
    code = RECONSTRUCTION.replace("{FORBIDDEN}", repr(set(blocked)))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


BRIDGES_AND_TOOLS = r"""
import sys
for name in {FORBIDDEN}:
    sys.modules[name] = None  # any import of it now raises ImportError
import io
import json
import os
import tempfile
import numpy as np
import torch
from nvblox_mindmap_torch.closed_loop.environment import CameraFrame, KinematicEnvironment
from nvblox_mindmap_torch.closed_loop.evaluators import BasicEvaluator
from nvblox_mindmap_torch.closed_loop.isaaclab_adapter import IsaacLabEnvironment
from nvblox_mindmap_torch.closed_loop.policies import GroundTruthPolicy
from nvblox_mindmap_torch.closed_loop.remote_env import (
    RemoteEnvironment, decode_message, encode_message, serve_environment)
from nvblox_mindmap_torch.closed_loop.runner import ClosedLoopConfig, run_one_episode
from nvblox_mindmap_torch.data.item_io import encode_png
from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
from nvblox_mindmap_torch.embodiments.humanoid_hand import HumanoidAction, HumanoidController
from nvblox_mindmap_torch.runtime import decode_png_batch, native_available
from nvblox_mindmap_torch.scripts import (
    benchmark_decompression, convert_backbone_weights, hdf5_tools, make_backbone_golden,
    plot_humanoid_keyposes, publish_closed_loop_eval, tar_demos)
from nvblox_mindmap_torch.workflows.submit import make_e2e_workflow

root = tempfile.mkdtemp()
# An episode through the bridge, and a message through the codec.
state = lambda pos: np.asarray([*pos, 1, 0, 0, 0, 0], np.float32)
world = KinematicEnvironment(ArmEmbodiment(), state([0, 0, 0.3]), [np.asarray([0.2, 0, 0.3])])
server = serve_environment(world, port=0)
try:
    remote = RemoteEnvironment("127.0.0.1", server.port, timeout_s=5)
    evaluator = BasicEvaluator()
    evaluator.start_demo("demo_0")
    assert run_one_episode(remote, GroundTruthPolicy(state([0.2, 0, 0.3])[None]),
                           ArmEmbodiment(), evaluator, ClosedLoopConfig(max_num_steps=20))
    remote.close()
finally:
    server.stop()
assert decode_message(encode_message({"a": np.bool_(True)})) == {"a": True}


# The adapter over a stand-in env; the 37-d action round trip.
class Env:
    def __init__(self):
        self.actions = []
        self.unwrapped = self

    def step(self, action):
        self.actions.append(action)

    def reset(self):
        pass


class Camera:
    def get_rgb(self):
        return np.full((4, 4, 3), 200, np.uint8)

    def get_depth(self):
        return np.ones((4, 4), np.float32)

    def get_intrinsics(self):
        return np.eye(3, dtype=np.float32)

    def get_pose(self):
        return np.zeros(3, np.float32), np.asarray([1, 0, 0, 0], np.float32)


env = Env()
adapter = IsaacLabEnvironment(env, ArmEmbodiment(), {"wrist": Camera()},
                              robot_state_fn=lambda e: np.asarray([0.3, 0, 0.3, 1, 0, 0, 0,
                                                                   0.04, 0.04], np.float32))
adapter.step(None)
assert env.actions[0].shape == (1, 8) and env.actions[0].device.type == "cpu"
assert adapter.get_cameras()["wrist"].rgb.max() <= 1.0
goal = np.zeros(17, np.float32)
goal[3] = goal[11] = 1.0
flat = HumanoidController()(goal).to_tensor()
assert HumanoidAction.from_tensor(flat).to_tensor().tobytes() == flat.tobytes()

# The runtime, the scripts and the workflow specs.
demo = os.path.join(root, "ds", "demo_00000")
os.makedirs(demo)
rng = np.random.default_rng(0)
for i in range(3):
    encode_png(os.path.join(demo, f"{i}.pov_rgb.png"), rng.integers(0, 256, (8, 8, 3),
                                                                   dtype=np.uint8))
assert native_available()
frames = decode_png_batch([os.path.join(demo, f"{i}.pov_rgb.png") for i in range(4)], 2)
assert frames[3] is None and all(f.shape == (8, 8, 3) for f in frames[:3])
assert set(benchmark_decompression.benchmark(32, 8, (1,), 1)[1]) >= {"ratio", "decode_ms"}
t = np.linspace(0, 1, 60)
states = np.zeros((60, 37), np.float32)
states[:, 2] = states[:, 20] = 0.3 + 0.1 * np.sin(6 * t)
states[:, 3] = states[:, 21] = 1.0
states[20:40, 8:11] = -1.2
states[:, 36] = 0.3 * np.sin(4 * t)
for i, s in enumerate(states):
    np.save(os.path.join(demo, f"{i}.robot_state.npy"), s)
plot_humanoid_keyposes.analyze_demo(demo, os.path.join(root, "plots"))
assert os.path.exists(os.path.join(root, "plots", "demo_00000_keyposes.png"))
assert tar_demos.tar_demos(os.path.join(root, "ds"), "0", os.path.join(root, "tars"))
with open(os.path.join(root, "eval.json"), "w") as f:
    json.dump({"num_demos": 1, "num_successes": 1, "success_rate": 1.0}, f)
publish_closed_loop_eval.render_report([os.path.join(root, "eval.json")],
                                       os.path.join(root, "report.html"))
assert len(make_e2e_workflow("cube_stacking", "d.hdf5", root)["stages"]) == 3
try:
    hdf5_tools.list_demos(os.path.join(root, "d.hdf5"))
    raise AssertionError("hdf5_tools ran without h5py")
except ImportError as e:
    assert "h5py" in str(e)
torch.hub.load = lambda *a, **k: (_ for _ in ()).throw(OSError("offline"))
assert make_backbone_golden.main(["--output", os.path.join(root, "golden")]) == 1
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in {FORBIDDEN})
print("LOADED", loaded)
"""


def test_bridges_runtime_and_scripts_run_without_jax_and_optional_modules():
    """The bridge, the adapter, the humanoid hand, the decoder API, the new
    scripts and the workflow specs with jax, the reference readers,
    matplotlib, h5py and CLIP's loader blocked (the HDF5 tools then raise
    naming h5py; the golden recipe exits 1 at the hub)."""
    blocked = FORBIDDEN + ("zstandard", "imageio", "PIL", "matplotlib", "wandb", "h5py",
                           "clip")
    code = BRIDGES_AND_TOOLS.replace("{FORBIDDEN}", repr(set(blocked)))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


API_SURFACE = r"""
import sys
for name in {FORBIDDEN}:
    sys.modules[name] = None  # any import of it now raises ImportError
import json
import tempfile
import numpy as np
import torch
from nvblox_mindmap_torch.data.data_types import DataType, includes_nvblox
from nvblox_mindmap_torch.embodiments import ArmEmbodiment, EmbodimentType
from nvblox_mindmap_torch.geometry import (
    axis_angle_to_matrix, axis_angle_to_quaternion, euler_angles_to_matrix,
    matrix_to_euler_angles, quaternion_apply)
from nvblox_mindmap_torch.geometry.rotations import matrix_to_axis_angle
from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActor, DiffuserActorConfig
from nvblox_mindmap_torch.models.layers import MultiheadAttention
from nvblox_mindmap_torch.ops.positional import rotary_pe_1d
from nvblox_mindmap_torch.scripts import render_bench_table
from nvblox_mindmap_torch.training import checkpoint
from nvblox_mindmap_torch.utils.logging_utils import MetricLogger
from nvblox_mindmap_torch.utils.timers import ProfilerTrace, Timer, get_mean_time, print_timers

torch.manual_seed(0)
x = torch.randn(2, 5, 24)
mha = MultiheadAttention(24, 4, slot_competition=True, gate_attn=True)
out, q, k, v = mha(x, x, x, k_mem=x, v_mem=x, mem_mask=torch.ones(2, 5), return_kv=True)
assert out.shape == (2, 5, 24) and q.shape == (2, 5, 4, 6)
model = DiffuserActor(DiffuserActorConfig(embedding_dim=24, num_attn_heads=4,
                                          vertex_feature_dim=8), device="cpu")
with torch.no_grad():
    feats, pos = model.encoder.encode_goal_gripper(
        torch.rand(2, 8), torch.randn(2, 16, 24), torch.rand(2, 16, 3), impl="flash")
assert feats.shape == (2, 1, 24) and pos.shape == (2, 1, 24, 2)
R = euler_angles_to_matrix(torch.rand(4, 3), "ZYX")
assert torch.allclose(euler_angles_to_matrix(matrix_to_euler_angles(R, "ZYX"), "ZYX"), R,
                      atol=1e-5)
aa = torch.rand(4, 3)
assert torch.allclose(matrix_to_axis_angle(axis_angle_to_matrix(aa)), aa, atol=1e-4)
assert quaternion_apply(axis_angle_to_quaternion(aa), torch.rand(4, 3)).shape == (4, 3)
assert rotary_pe_1d(torch.arange(5.0), 24).shape == (5, 24, 2)
assert includes_nvblox(DataType.MESH) and not includes_nvblox(DataType.RGBD)
assert ArmEmbodiment().embodiment_type == EmbodimentType.ARM
checkpoint.MAX_CHUNK_SIZE = 16
data = checkpoint.msgpack_serialize({"w": np.arange(20, dtype=np.float32)})
assert b"__msgpack_chunked_array__" in data
assert np.array_equal(checkpoint.msgpack_restore(data)["w"], np.arange(20, dtype=np.float32))
with Timer("t"):
    pass
assert get_mean_time("t") > 0
MetricLogger().log_timings(0, ["t"])
print_timers()
with ProfilerTrace(tempfile.mkdtemp()) as trace:
    torch.ones(3) + 1
with open(trace.path) as f:
    assert json.load(f)["traceEvents"]
assert render_bench_table.main(["--check"]) == 0
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in {FORBIDDEN})
print("LOADED", loaded)
"""


def test_api_surface_runs_without_jax():
    """The attention variants, the goal-gripper query, the rotations and the
    package exports, the 1D rotary code, the timers and the profiler trace,
    flax's chunked msgpack form and the bench-table renderer with jax, the
    reference readers, matplotlib and wandb blocked."""
    blocked = FORBIDDEN + ("zstandard", "imageio", "PIL", "matplotlib", "wandb")
    code = API_SURFACE.replace("{FORBIDDEN}", repr(set(blocked)))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def test_sim_host_modules_import_without_torch():
    """The simulator host of the bridge serves a scene world without torch:
    its modules, and the packages they sit in, import with torch blocked."""
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "import nvblox_mindmap_torch.closed_loop.remote_env\n"
            "import nvblox_mindmap_torch.closed_loop.scripted\n"
            "import nvblox_mindmap_torch.geometry.np_rotations\n"
            "import nvblox_mindmap_torch.embodiments\n"
            "import nvblox_mindmap_torch.geometry as g\n"
            "assert 'quaternion_apply' in g.__all__\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "compare_flash_kernels.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "nvblox_mindmap_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return paths


def test_sources_import_nothing_of_jax():
    offenders = []
    sources = _port_sources()
    assert len(sources) > 10
    for module in ("training/trainer.py", "training/optimizer.py", "training/checkpoint.py",
                   "models/loss.py", "utils/timers.py", "data/sampler.py", "data/item_io.py",
                   "data/item_names.py", "data/data_types.py", "data/keyposes.py",
                   "data/transforms.py", "data/dataset.py", "data/batching.py",
                   "data/loader.py", "data/writer.py", "embodiments/base.py",
                   "embodiments/arm.py", "embodiments/humanoid.py", "embodiments/registry.py",
                   "utils/config.py", "utils/logging_utils.py", "apps/run_training.py",
                   "apps/run_datagen.py", "apps/run_validate_demos.py",
                   "apps/run_closed_loop_policy.py", "closed_loop/goals.py",
                   "closed_loop/scene.py", "closed_loop/scripted.py",
                   "closed_loop/evaluators.py", "closed_loop/runner.py",
                   "image/conversions.py", "image/pca.py", "visualization/visualizer.py",
                   "utils/system.py", "apps/run_open_loop_policy.py",
                   "scripts/task_success_experiment.py",
                   "scripts/spatial_memory_experiment.py", "parallel/mesh.py",
                   "parallel/multihost.py", "parallel/serving.py", "data/packed.py",
                   "scripts/pack_dataset.py", "training/orbax_checkpoint.py",
                   "models/clip_resnet_fpn.py", "scripts/checkpoint_tools.py",
                   "scripts/extract_fpn_from_model.py",
                   "scripts/extract_image_features.py", "mapping/surface_nets.py",
                   "geometry/pointcloud_utils.py", "visualization/paper_utils.py",
                   "visualization/turbo_colormap.py", "data/comparisons.py",
                   "scripts/visualize_nvblox_tensors.py",
                   "scripts/generate_reconstruction_figures.py", "scripts/convert_maps_usd.py",
                   "scripts/make_mp4_from_dataset.py", "scripts/video_from_depth.py",
                   "scripts/visualize_keyposes.py", "scripts/place_grounding_probe.py",
                   "closed_loop/remote_env.py", "closed_loop/isaaclab_adapter.py",
                   "embodiments/humanoid_hand.py", "runtime/__init__.py", "runtime/native.py",
                   "workflows/__init__.py", "workflows/submit.py", "apps/__init__.py",
                   "scripts/benchmark_decompression.py", "scripts/tar_demos.py",
                   "scripts/publish_closed_loop_eval.py", "scripts/hdf5_tools.py",
                   "scripts/plot_humanoid_keyposes.py", "scripts/convert_backbone_weights.py",
                   "scripts/make_backbone_golden.py", "scripts/render_bench_table.py",
                   "geometry/__init__.py", "geometry/rotations.py",
                   "embodiments/__init__.py", "ops/positional.py", "models/layers.py",
                   "models/encoder.py"):
        assert os.path.join(ROOT, "nvblox_mindmap_torch", module) in sources, module
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
            # The reference readers: the port reads its items without them.
            offenders += [(path, n) for n in names
                          if n.split(".")[0] in ("zstandard", "imageio", "PIL")]
    assert offenders == []


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch, tmp_path):
    from nvblox_mindmap_torch.models.diffuser_actor import (
        DiffuserActor,
        DiffuserActorConfig,
        prepare_inputs,
    )
    from nvblox_mindmap_torch.closed_loop.policies import NvbloxDiffuserActorPolicy
    from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
    from nvblox_mindmap_torch.mapping.constants import MapperId, MappingConfig
    from nvblox_mindmap_torch.mapping.mapper import Mapper
    from nvblox_mindmap_torch.mapping.voxel_grid import create_state
    from nvblox_mindmap_torch.models.pretrained import build_backbone, make_feature_fn
    from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DiffuserActorConfig(embedding_dim=24, num_attn_heads=4, vertex_feature_dim=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffuserActor(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_inputs({"gripper_history": np.zeros((1, 3, 1, 8), np.float32)},
                       np.zeros((2, 3), np.float32), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_backbone("rgb", feature_image_size=(4, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainerConfig(), np.zeros((2, 3), np.float32))
    mapping = MappingConfig(voxel_size_m=0.1, aabb_min_m=(0, 0, 0), aabb_max_m=(1, 1, 1),
                            feature_dim=3, max_feature_pages=4)
    bounds = np.asarray([[0, 0, 0], [1, 1, 1]], np.float32)
    for entry in (lambda: Mapper({MapperId.STATIC: mapping}), lambda: Mapper.dual(mapping),
                  lambda: create_state(mapping), lambda: make_feature_fn("rgb", (8, 8))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    model = DiffuserActor(dataclasses.replace(cfg, vertex_feature_dim=3), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NvbloxDiffuserActorPolicy(model, ArmEmbodiment(), mapping, bounds)
    assert DiffuserActor(cfg, device="cpu").device == torch.device("cpu")
    rgb = build_backbone("rgb", feature_image_size=(4, 4), device="cpu")
    assert rgb(torch.zeros(1, 16, 16, 3)).shape == (1, 4, 4, 3)
    from nvblox_mindmap_torch.apps import (
        run_closed_loop_policy,
        run_datagen,
        run_open_loop_policy,
        run_validate_demos,
    )

    for app in (run_closed_loop_policy, run_datagen, run_validate_demos, run_open_loop_policy):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            app.main(["--task", "cube_stacking", "--dataset", "/nonexistent"])
    policy = NvbloxDiffuserActorPolicy(model, ArmEmbodiment(), mapping, bounds, device="cpu")
    assert policy.mapper.states[MapperId.STATIC].tsdf.device == torch.device("cpu")
    assert make_feature_fn("rgb", (8, 8), device="cpu")(np.zeros((4, 4, 3))).shape == (8, 8, 3)
    from nvblox_mindmap_torch.data.packed import PackedDeviceLoader, materialize_packed_epoch
    from nvblox_mindmap_torch.parallel.mesh import make_data_mesh
    from nvblox_mindmap_torch.parallel.serving import make_sharded_infer_fn

    packed = str(tmp_path / "packed")
    materialize_packed_epoch([{"vertices": np.zeros((2, 4, 3), np.float32)}], packed)
    for entry in (make_data_mesh, lambda: PackedDeviceLoader(packed),
                  lambda: make_sharded_infer_fn(model, bounds)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    loader = PackedDeviceLoader(packed, mesh=make_data_mesh("cpu"))
    assert next(iter(loader))["vertices"].device == torch.device("cpu")
    assert make_sharded_infer_fn(model, bounds, ["cpu"]).copies == 0
    # The map tools: each loads the map (or the model) on the card unless told.
    from nvblox_mindmap_torch.mapping.voxel_grid import get_voxel_center_grids
    from nvblox_mindmap_torch.scripts import (
        convert_maps_usd,
        generate_reconstruction_figures,
        place_grounding_probe,
        visualize_nvblox_tensors,
    )
    from nvblox_mindmap_torch.visualization.paper_utils import convert_maps_to_usd

    maps = tmp_path / "maps"
    maps.mkdir()
    map_path = str(maps / "0000.nvblox_map_static.nvblx")
    Mapper({MapperId.STATIC: mapping}, device="cpu").save_map(map_path)
    fixture = os.path.join(ROOT, "tests", "test_data", "task_success", "cube_stacking",
                           "last.ckpt")
    for entry in (lambda: get_voxel_center_grids(mapping),
                  lambda: Mapper.from_file(map_path),
                  lambda: convert_maps_to_usd(str(maps)),
                  lambda: convert_maps_usd.main(["--input_dir", str(maps)]),
                  lambda: visualize_nvblox_tensors.main(["--map", map_path, "--output_dir",
                                                         str(tmp_path / "v")]),
                  lambda: generate_reconstruction_figures.main(
                      ["--map_path", map_path, "--output_dir", str(tmp_path / "f")]),
                  lambda: place_grounding_probe.main(["--checkpoint", fixture,
                                                      "--scenes", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert get_voxel_center_grids(mapping, "cpu").device == torch.device("cpu")


def test_chip_smoke_refuses_without_cuda():
    """With no CUDA device the script exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
