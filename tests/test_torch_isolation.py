"""The torch port stands alone: no JAX, no flax, nothing of the JAX package.

- A subprocess that blocks ``jax`` imports the port and runs small mesh and
  rgbd_and_mesh keypose predictions and two mapping steps plus a goal of
  the closed-loop policy on the CPU, then checks which modules were loaded.
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
from nvblox_mindmap_torch.embodiments.codecs import ArmEmbodiment
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


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "nvblox_mindmap_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return paths


def test_sources_import_nothing_of_jax():
    offenders = []
    sources = _port_sources()
    assert len(sources) > 10
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
    assert offenders == []


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    from nvblox_mindmap_torch.models.diffuser_actor import (
        DiffuserActor,
        DiffuserActorConfig,
        prepare_inputs,
    )
    from nvblox_mindmap_torch.closed_loop.policies import NvbloxDiffuserActorPolicy
    from nvblox_mindmap_torch.embodiments.codecs import ArmEmbodiment
    from nvblox_mindmap_torch.mapping.constants import MapperId, MappingConfig
    from nvblox_mindmap_torch.mapping.mapper import Mapper
    from nvblox_mindmap_torch.mapping.voxel_grid import create_state
    from nvblox_mindmap_torch.models.pretrained import build_backbone, make_feature_fn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DiffuserActorConfig(embedding_dim=24, num_attn_heads=4, vertex_feature_dim=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffuserActor(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_inputs({"gripper_history": np.zeros((1, 3, 1, 8), np.float32)},
                       np.zeros((2, 3), np.float32), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_backbone("rgb", feature_image_size=(4, 4))
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
