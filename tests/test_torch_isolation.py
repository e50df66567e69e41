"""The torch port stands alone: no JAX, no flax, nothing of the JAX package.

- A subprocess that blocks ``jax`` imports the port and runs small mesh and
  rgbd_and_mesh keypose predictions, a train step, an eval batch and a
  checkpoint round trip, and two mapping steps plus a goal of the
  closed-loop policy on the CPU, then checks which modules were loaded.
- A second subprocess, with ``jax``, ``flax``, ``optax``, ``zstandard``,
  ``imageio``, ``PIL``, ``wandb`` and ``matplotlib`` blocked, writes demos in
  the reference layout with the port's writer and trains on them through
  the port's training app (``--device cpu``), then resumes from its
  ``last.ckpt``.
- A third, with the same modules blocked, records a cube_stacking demo in
  the port's scene world and runs the datagen, validate-demos and
  closed-loop apps on it (``--device cpu``; the closed loop in its
  ground-truth and policy modes).
- A fourth, with the same modules blocked, runs a demo-set generator per
  embodiment (cube_stacking, drill_in_box), the task-success experiment's
  ``gen`` and ``openloop`` stages (``--device cpu``, at a small width), and
  the open-loop app with and without ``--ply_output_dir``.
- A scan of the port's sources and ``chip_smoke.py`` for such imports.
- Entry points called without a device on a machine without CUDA raise
  rather than fall back to the CPU.
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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nvblox_mindmap_tpu")

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
                   "scripts/spatial_memory_experiment.py"):
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


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
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


def test_chip_smoke_refuses_without_cuda():
    """With no CUDA device the script exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
