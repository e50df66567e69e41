"""Helpers of the card tests (``tests/test_torch_cuda.py``,
``tests/test_torch_cuda_apps.py``): launch counts, the attention impl for a
block, the plain-version check of every flash shape a block launched, and
the full-width model at small inputs. Imports no JAX, so the card tests run
with ``--noconftest`` on a machine without it.
"""
import contextlib
from unittest import mock

import numpy as np
import torch

from nvblox_mindmap_torch.models.converter import (
    apply_inference_settings,
    convert_to_flash_attention,
)
from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActor, DiffuserActorConfig
from nvblox_mindmap_torch.ops import flash_attention as fa
from nvblox_mindmap_torch.ops import fps as fps_ops
from nvblox_mindmap_torch.ops.attention import (
    get_default_attention_impl,
    set_default_attention_impl,
)
from nvblox_mindmap_torch.ops.integrate_pool import integrate_pool

DEVICE = "cuda"
SPLIT, TILE = fa.KERNELS
BOUNDS = np.asarray([[-0.37, -0.75, -0.13], [0.95, 0.75, 0.65]], np.float32)
VERTICES = 256
# Flash against eager attention: whole trajectories, one denoiser pass (fp32
# sums in other orders).
TRAJ_ATOL = 5e-3
DENOISE_ATOL = 1e-4


def per_goal(T, goals=1):
    """Flash launches of ``goals`` goals, samples or eval batches of a T-step
    sampler."""
    return {SPLIT: goals * (3 + 2 * T), TILE: goals * 8 * T}


@contextlib.contextmanager
def launches():
    """Yields a dict that, when the block ends, holds each flash kernel's
    launches in it, the flash wrapper's calls under ``calls``, the FPS
    kernel's launches under ``fps`` and the pool kernel's under
    ``integrate_pool``."""
    flash, calls = dict(fa.KERNEL_LAUNCHES), fa.flash_attention.launches
    fps, pool = fps_ops.farthest_point_sampling.launches, integrate_pool.launches
    out = {}
    yield out
    torch.cuda.synchronize()
    out.update({k: n - flash[k] for k, n in fa.KERNEL_LAUNCHES.items()},
               calls=fa.flash_attention.launches - calls,
               fps=fps_ops.farthest_point_sampling.launches - fps,
               integrate_pool=integrate_pool.launches - pool)


def flash(counts):
    """The flash kernels' launches of a ``launches()`` dict."""
    return {k: counts[k] for k in fa.KERNELS}


@contextlib.contextmanager
def attention(impl):
    """``impl`` as the process-wide attention in the block ("flash" through
    ``apply_inference_settings``), then the previous impl again."""
    previous = get_default_attention_impl()
    set_default_attention_impl("eager")
    if impl == "flash":
        assert not apply_inference_settings(convert_to_flash_attention())
    try:
        yield
    finally:
        set_default_attention_impl(previous)


@contextlib.contextmanager
def held_shapes():
    """Within the block every flash launch's (B, H, L, S, D, masked) is
    recorded, a replayed CUDA graph's through ``fa.REPLAYED``; on leaving, the
    recorded and replayed launches must be every launch the kernels counted,
    and each shape is held against the plain version on random inputs."""
    shapes, recorded, run_kernel = set(), [0], fa.run_kernel
    before, replayed = sum(fa.KERNEL_LAUNCHES.values()), fa.REPLAYED.copy()

    def recording(name, q, k, v, key_padding_mask=None):
        if q.shape[2] > 0:
            shapes.add((*q.shape[:3], k.shape[2], q.shape[3], key_padding_mask is not None))
            recorded[0] += not torch.cuda.is_current_stream_capturing()
        return run_kernel(name, q, k, v, key_padding_mask)

    with mock.patch.object(fa, "run_kernel", recording):
        yield
    new = fa.REPLAYED - replayed
    shapes.update((*c.q_shape[:3], c.keys, c.q_shape[3], c.valid_keys is not None) for c in new)
    launched = sum(fa.KERNEL_LAUNCHES.values()) - before
    assert launched > 0 and recorded[0] + sum(new.values()) == launched
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    for B, H, L, S, D, masked in sorted(shapes):
        q = torch.randn(B, H, L, D, device=DEVICE, generator=gen) * D**-0.5
        k, v = (torch.randn(B, H, S, D, device=DEVICE, generator=gen) for _ in range(2))
        mask = torch.rand(B, S, device=DEVICE, generator=gen) > 0.2 if masked else None
        torch.testing.assert_close(fa.flash_attention(q, k, v, mask),
                                   fa.flash_attention_reference(q, k, v, mask),
                                   rtol=0, atol=2e-5, msg=str((B, H, L, S, D, masked)))


def assert_trajectory(traj, B, grippers=1):
    """(B, 1, grippers, 8), finite, unit quaternions, openness in [0, 1]."""
    traj = torch.as_tensor(traj)
    assert traj.shape == (B, 1, grippers, 8) and bool(torch.isfinite(traj).all())
    assert bool(((traj[..., 3:7].norm(dim=-1) - 1).abs() < 1e-4).all())
    assert bool(((traj[..., 7] >= 0) & (traj[..., 7] <= 1)).all())


def flagship(data_type="mesh", **extra):
    """Width 120 over 8 heads (D = 15) and FPS to a fifth, as the cells run
    it; VERTICES 16-d vertices; with rgbd_and_mesh 2 cameras at 64x64 through
    the RADIO ViT-B/16 (4x4 tokens each)."""
    cfg = DiffuserActorConfig(
        embedding_dim=120, num_attn_heads=8, data_type=data_type,
        feature_type="radio_v25_b" if data_type == "rgbd_and_mesh" else "rgb",
        feature_image_size=(4, 4), vertex_feature_dim=16, diffusion_timesteps=100,
        fps_subsampling_factor=5, **extra)
    torch.manual_seed(0)
    return DiffuserActor(cfg, device=DEVICE)


def batch_of(B, data_type="mesh", seed=0):
    """Inputs inside the workspace; with cameras, depth holes under a tenth
    of the 16x16 pixel blocks, returned beside the batch."""
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(B, 3, 1, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    batch = {"gripper_history": np.concatenate(
                 [rng.uniform(-0.3, 0.6, (B, 3, 1, 3)), quat, rng.integers(0, 2, (B, 3, 1, 1))],
                 -1).astype(np.float32),
             "vertices": rng.uniform(-0.3, 0.6, (B, VERTICES, 3)).astype(np.float32),
             "vertex_features": rng.normal(size=(B, VERTICES, 16)).astype(np.float32),
             "vertices_valid_mask": np.ones((B, VERTICES), bool)}
    holes = rng.uniform(size=(B, 2, 4, 4)) < 0.1
    if data_type == "rgbd_and_mesh":
        batch["rgbs"] = rng.uniform(0, 1, (B, 2, 64, 64, 3)).astype(np.float32)
        batch["pcds"] = rng.uniform(BOUNDS[0], BOUNDS[1], (B, 2, 64, 64, 3)).astype(np.float32)
        batch["pcd_valid_mask"] = ~holes.repeat(16, axis=2).repeat(16, axis=3)
    return batch, holes
