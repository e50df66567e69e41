"""The torch port stands alone: no JAX, no flax, nothing of the JAX package.

- A subprocess that blocks ``jax`` imports the port and runs small mesh and
  rgbd_and_mesh keypose predictions on the CPU, then checks which modules
  were loaded.
- A scan of the port's sources and ``chip_smoke.py`` for such imports.
- Entry points called without a device on a machine without CUDA raise
  rather than fall back to the CPU.
"""
import ast
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
    from nvblox_mindmap_torch.models.pretrained import build_backbone

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DiffuserActorConfig(embedding_dim=24, num_attn_heads=4, vertex_feature_dim=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffuserActor(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_inputs({"gripper_history": np.zeros((1, 3, 1, 8), np.float32)},
                       np.zeros((2, 3), np.float32), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_backbone("rgb", feature_image_size=(4, 4))
    assert DiffuserActor(cfg, device="cpu").device == torch.device("cpu")
    rgb = build_backbone("rgb", feature_image_size=(4, 4), device="cpu")
    assert rgb(torch.zeros(1, 16, 16, 3)).shape == (1, 4, 4, 3)


def test_chip_smoke_refuses_without_cuda():
    """With no CUDA device the script exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
