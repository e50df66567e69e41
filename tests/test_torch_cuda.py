"""Torch port on the card: the CUDA kernels against their plain version,
and the plain-torch paths (ViT, image encoding, the mapper, a train step) on
the card against the same code on the CPU.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere. This file
imports neither JAX nor the JAX package, so it runs on a machine without
them; there, skip the JAX-importing ``tests/conftest.py``:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: fp32 atol 2e-5, kernel vs plain version (the same function with
another summation order; the tile kernel's 3xTF32 products keep fp32
accuracy); model outputs atol 5e-3 flash vs eager, the JAX package's own
swap-test bound. The bf16 ViT on the card vs the port on the CPU: mean abs
<= 1e-2 and max abs <= 0.1, the bound that holds the port to the JAX
package (``tests/test_torch_image_path.py``): the two round bf16 at other
places. The mapper: fp32 fields and surface vertices 1e-5, fp16 pools and
surface features 1e-3 (``tests/test_torch_mapping.py``'s bounds). A train
step: the loss rtol 1e-5, gradients rtol 1e-3 / atol 1e-5 (fp32 without
TF32 on both, other summation orders through forward and backward). The FPS
kernel: its picks and running distances equal to the bit the eager loop's on
the card.
"""
import collections
import contextlib

import numpy as np
import pytest
import torch

from nvblox_mindmap_torch.ops import flash_attention as fa
from nvblox_mindmap_torch.ops import fps as fps_ops
from cuda_helpers import (
    BOUNDS,
    DENOISE_ATOL,
    TRAJ_ATOL,
    VERTICES,
    assert_trajectory,
    attention,
    batch_of,
    flagship,
    flash,
    launches,
    per_goal,
)

pytestmark = pytest.mark.cuda
ATOL = 2e-5
SPLIT, TILE = fa.KERNELS


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc) to build and run the kernels")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, B, H, L, S, D, masked):
    q = torch.randn(B, H, L, D, device="cuda", generator=gen) * D**-0.5
    k = torch.randn(B, H, S, D, device="cuda", generator=gen)
    v = torch.randn(B, H, S, D, device="cuda", generator=gen)
    mask = None
    if masked:
        mask = torch.rand(B, S, device="cuda", generator=gen) > 0.3
        mask[0] = False  # a fully masked batch element
    return q, k, v, mask


@pytest.mark.parametrize(
    "B,H,L,S,D,masked",
    [
        # Path shapes: encoder / denoiser cross-attention and self-attention.
        (1, 8, 3, 2048, 15, False),
        (8, 8, 1, 2048, 15, True),
        (8, 8, 410, 410, 15, True),
        (2, 8, 129, 129, 9, True),
        # L around the split kernel's limit of 8.
        (2, 8, 2, 2048, 15, True),
        (2, 8, 6, 2048, 15, True),
        (2, 8, 8, 2048, 15, True),
        (2, 8, 9, 2048, 15, True),
        # S below one split, not a multiple of the split size, S = 1.
        (2, 4, 3, 100, 15, True),
        (2, 4, 2, 1000, 15, True),
        (2, 4, 6, 2047, 9, True),
        (2, 4, 1, 1, 15, False),
        (2, 4, 20, 1, 15, False),
        # The flagship rgbd_and_mesh path: 4096 context tokens, 1 + 819 FPS.
        (1, 8, 3, 4096, 15, False),
        (8, 8, 1, 4096, 15, True),
        (1, 8, 820, 820, 15, True),
        (8, 8, 820, 820, 15, True),
        # Head dims 9, 15, 32, 64 on both kernels.
        (2, 3, 5, 700, 9, True),
        (2, 3, 100, 130, 33, True),
        (1, 12, 70, 200, 32, True),
        (1, 12, 4, 600, 32, True),
        (1, 12, 65, 197, 64, True),
        (1, 12, 8, 1500, 64, True),
        (1, 1, 1, 1, 1, False),
        # Grids of 2+ blocks per SM: the tile kernel's one-pair blocks.
        (8, 12, 100, 300, 64, True),
        (8, 12, 70, 200, 32, True),
        # Head dims up to 128, and above: chunks of 128 over blockIdx.z.
        (1, 12, 65, 197, 128, True),
        (1, 12, 8, 1500, 128, True),
        (2, 3, 100, 130, 100, True),
        (1, 8, 3, 3072, 144, False),
        (1, 8, 1, 3072, 192, True),
        (1, 8, 615, 615, 256, True),
        (2, 3, 70, 130, 250, True),
        (2, 3, 5, 700, 390, True),
        # The training app's one-camera flagship: 3072 context tokens, 1 + 614.
        (32, 8, 3, 3072, 15, False),
        (32, 8, 1, 3072, 15, True),
        (32, 8, 615, 615, 15, True),
    ],
)
def test_kernel_matches_plain_version(gen, B, H, L, S, D, masked):
    q, k, v, mask = _inputs(gen, B, H, L, S, D, masked)
    with launches() as counts:
        out = fa.flash_attention(q, k, v, mask)
    ref = fa.flash_attention_reference(q, k, v, mask)
    assert counts["calls"] == counts[fa.kernel_for(L)] == 1
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)
    if masked:
        assert bool((out[0] == 0).all())


@pytest.mark.parametrize("name", [SPLIT, TILE])
@pytest.mark.parametrize("D", [9, 15, 32, 64, 128, 144, 192, 256])
@pytest.mark.parametrize("L,S", [(1, 333), (8, 2048), (3, 64)])
def test_each_kernel_at_every_head_dim(gen, name, D, L, S):
    q, k, v, mask = _inputs(gen, 2, 3, L, S, D, masked=True)
    out = fa.run_kernel(name, q, k, v, mask)
    ref = fa.flash_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)
    assert bool((out[0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("L,S,D", [(3, 2048, 64), (410, 410, 64), (1, 600, 128),
                                   (100, 300, 128), (3, 600, 192), (100, 300, 256)])
def test_16_bit_inputs(gen, dtype, L, S, D):
    """16-bit q, k, v: computed in fp32, returned in q's dtype; within one
    rounding of the plain version's (also fp32) result."""
    q, k, v, mask = _inputs(gen, 2, 4, L, S, D, masked=True)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    out = fa.flash_attention(q, k, v, mask)
    ref = fa.flash_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=torch.finfo(dtype).eps,
                               atol=ATOL)
    assert bool((out[0] == 0).all())


@pytest.mark.parametrize("L", [3, 410])
def test_one_split_wholly_masked(gen, L):
    """Keys 0-255 (the first split at S = 2048) masked in every batch
    element; the other splits carry the valid keys."""
    q, k, v, _ = _inputs(gen, 2, 8, L, 2048, 15, masked=False)
    mask = torch.rand(2, 2048, device="cuda", generator=gen) > 0.3
    mask[:, :256] = False
    out = fa.flash_attention(q, k, v, mask)
    ref = fa.flash_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("L", [1, 3, 820])
def test_chunks_wholly_masked_at_4096_keys(gen, L):
    """At S = 4096 each split-kernel block walks two chunks of 256 keys:
    block 0's first chunk and block 1's second are masked."""
    q, k, v, _ = _inputs(gen, 2, 8, L, 4096, 15, masked=False)
    mask = torch.rand(2, 4096, device="cuda", generator=gen) > 0.3
    mask[:, :256] = False
    mask[:, 768:1024] = False
    out = fa.flash_attention(q, k, v, mask)
    ref = fa.flash_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("L,S,D", [(1, 2048, 15), (6, 2048, 15), (410, 410, 15),
                                   (20, 300, 64), (4, 256, 64), (3, 500, 192),
                                   (40, 200, 256)])
def test_transposed_views_in_and_out(gen, L, S, D):
    """(B, T, H, D) tensors passed as .transpose(1, 2) views: no copy, and
    the output comes back in the caller's (B, L, H, D) layout."""
    B, H = 2, 8
    q = torch.randn(B, L, H, D, device="cuda", generator=gen) * D**-0.5
    kv = torch.randn(B, S, 2, H, D, device="cuda", generator=gen)  # fused k/v
    mask = torch.rand(B, S, device="cuda", generator=gen) > 0.3
    qt, kt, vt = q.transpose(1, 2), kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    assert not kt.is_contiguous() and not vt.is_contiguous()
    assert L == 1 or not qt.is_contiguous()
    out = fa.flash_attention(qt, kt, vt, mask)
    ref = fa.flash_attention_reference(qt.contiguous(), kt.contiguous(),
                                       vt.contiguous(), mask)
    torch.cuda.synchronize()
    assert out.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)


def test_wrapper_raises_instead_of_falling_back(gen):
    z = torch.zeros(1, 1, 2, 8, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_attention(z.double(), z.double(), z.double())
    with pytest.raises(ValueError, match="unit-stride"):
        t = torch.zeros(1, 2, 3, 16, device="cuda")[..., ::2]
        fa.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention(z, z.cpu(), z)
    with pytest.raises(ValueError, match="queries"):
        w = torch.zeros(1, 1, 9, 8, device="cuda")
        fa.run_kernel(SPLIT, w, w, w)


# Flash against eager attention through whole predictions: the full-width
# mesh and rgbd_and_mesh models (tests/cuda_helpers.flagship) under DDPM-100
# and DDIM-10 at B = 1 and 8, and the committed humanoid fixtures' width (72,
# two grippers, head yaw) at B = 2.
FLASH_PATH_CASES = [("humanoid_w72", "ddim10", 2)] + [
    (data_type, sampler, B) for data_type in ("mesh", "rgbd_and_mesh")
    for sampler, B in (("ddpm100", 1), ("ddim10", 1), ("ddim10", 8))]
FLASH_PATH_SAMPLERS = {
    "ddpm100": dict(num_inference_steps=100, scheduler_kind="ddpm", stochastic=True),
    "ddim10": dict(num_inference_steps=10, scheduler_kind="ddim", stochastic=False)}


def _humanoid_w72(B):
    from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActor, DiffuserActorConfig

    cfg = DiffuserActorConfig(embedding_dim=72, num_attn_heads=8, vertex_feature_dim=3,
                              diffusion_timesteps=100, fps_subsampling_factor=4,
                              ngrippers=2, predict_head_yaw=True)
    torch.manual_seed(0)
    model = DiffuserActor(cfg)
    rng = np.random.default_rng(0)
    quat = rng.normal(size=(B, 3, 2, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    batch = {
        "gripper_history": np.concatenate(
            [rng.uniform(0, 1, (B, 3, 2, 3)), quat, np.ones((B, 3, 2, 1))], -1
        ).astype(np.float32),
        "vertices": rng.uniform(0, 1, (B, 512, 3)).astype(np.float32),
        "vertex_features": rng.uniform(0, 1, (B, 512, 3)).astype(np.float32),
    }
    return model, batch, np.asarray([[0, 0, 0], [1, 1, 1]], np.float32)


@pytest.mark.parametrize("data_type,sampler,B", FLASH_PATH_CASES)
def test_model_flash_path_matches_eager_on_cuda(gen, data_type, sampler, B):
    """One denoiser pass and whole predictions, flash against eager: the
    context and FPS token counts, depth holes masking their image tokens, 3 +
    2T split and 8T tile launches, attention weights only on the eager path,
    valid poses."""
    from nvblox_mindmap_torch.models.diffuser_actor import prepare_inputs, sample_trajectory

    sampler = FLASH_PATH_SAMPLERS[sampler]
    T = sampler["num_inference_steps"]
    if data_type == "humanoid_w72":
        (model, batch, bounds), context, holes = _humanoid_w72(B), 512, None
    else:
        model, (batch, holes), bounds = flagship(data_type), batch_of(B, data_type), BOUNDS
        cameras = data_type == "rgbd_and_mesh"
        context, holes = VERTICES + 32 * cameras, holes if cameras else None
    cfg = model.config
    prepared = prepare_inputs(batch, bounds, cfg)
    G = cfg.ngrippers
    noise = dict(init_noise=torch.randn((B, 1, G, 9), device="cuda", generator=gen),
                 step_noise=torch.randn((T, B, 1, G, 9), device="cuda", generator=gen))
    with torch.no_grad():
        fixed = model.encode_prepared(prepared, impl="eager")
        assert (fixed["context_feats"].shape[1], fixed["fps_feats"].shape[1]) == (
            context, context // cfg.fps_subsampling_factor)
        if holes is not None:
            image_mask = fixed["context_mask"][:, :32].cpu().numpy()
            assert np.array_equal(image_mask, ~holes.reshape(B, 32)) and holes.any()
        t_first = torch.full((B,), 99.0, device="cuda")
        eps = {}
        for impl in ("eager", "flash"):
            with attention(impl):
                eps[impl] = model.denoise(noise["init_noise"], t_first, fixed)[0]
    torch.testing.assert_close(eps["flash"], eps["eager"], rtol=0, atol=DENOISE_ATOL)
    with attention("eager"):
        eager = sample_trajectory(model, prepared, bounds, **noise, **sampler)
    with attention("flash"), launches() as counts:
        traj, head_yaw, weights = sample_trajectory(model, prepared, bounds, **noise, **sampler)
    assert counts["calls"] == 3 + 10 * T and flash(counts) == per_goal(T)
    assert eager[2] is not None and weights is None
    assert_trajectory(traj, B, G)
    torch.testing.assert_close(traj, eager[0], rtol=0, atol=TRAJ_ATOL)
    assert (head_yaw is None) == (eager[1] is None) == (not cfg.predict_head_yaw)
    if head_yaw is not None:
        torch.testing.assert_close(head_yaw, eager[1], rtol=0, atol=TRAJ_ATOL)


def _assert_bf16_close(out, ref):
    diff = (out.float().cpu() - ref.float()).abs()
    assert diff.mean().item() <= 1e-2 and diff.max().item() <= 0.1, (diff.mean(), diff.max())


def _vit(feature_type):
    from nvblox_mindmap_torch.models.feature_extractors import (
        NORMALIZATION,
        VitFeatureExtractor,
    )

    geometry = {"radio_v25_b": dict(patch_size=16, width=768, num_heads=12),
                "dino_v2_vits14": dict(patch_size=14, width=384, num_heads=6,
                                       use_layer_scale=True)}[feature_type]
    return VitFeatureExtractor(depth=2, feature_image_size=(4, 4), num_prefix_tokens=1,
                               mean_std=NORMALIZATION[feature_type], **geometry)


@pytest.mark.parametrize("feature_type", ["radio_v25_b", "dino_v2_vits14"])
def test_vit_on_cuda_matches_cpu(gen, feature_type):
    """Published widths, depth 2, a 4x4 patch grid, 2 images."""
    import copy

    torch.manual_seed(0)
    cpu = _vit(feature_type)
    rgb = torch.rand(2, 72, 72, 3)
    ref = cpu(rgb)
    out = copy.deepcopy(cpu).to("cuda")(rgb.to("cuda"))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _assert_bf16_close(out, ref)


def test_encode_images_on_cuda_matches_cpu(gen):
    """rgbd_and_mesh at RADIO geometry (depth 2), 2 cameras at 64x64 with an
    invalid region, embedding 120."""
    import copy

    from nvblox_mindmap_torch.models.diffuser_actor import (
        DiffuserActor,
        DiffuserActorConfig,
        prepare_inputs,
    )

    cfg = DiffuserActorConfig(data_type="rgbd_and_mesh", feature_type="radio_v25_b",
                              feature_image_size=(4, 4), vertex_feature_dim=8)
    torch.manual_seed(0)
    cpu = DiffuserActor(cfg, device="cpu")
    cpu.encoder.feature_extractor = _vit("radio_v25_b")
    rng = np.random.default_rng(0)
    valid = np.ones((2, 2, 64, 64), bool)
    valid[:, 0, :16] = False
    batch = {"gripper_history": np.zeros((2, 3, 1, 8), np.float32),
             "rgbs": rng.uniform(0, 1, (2, 2, 64, 64, 3)).astype(np.float32),
             "pcds": rng.uniform(0, 1, (2, 2, 64, 64, 3)).astype(np.float32),
             "pcd_valid_mask": valid}
    batch["gripper_history"][..., 3] = 1.0
    bounds = np.asarray([[0, 0, 0], [1, 1, 1]], np.float32)
    outs = []
    for model, device in ((cpu, "cpu"), (copy.deepcopy(cpu).to("cuda"), "cuda")):
        prep = prepare_inputs(batch, bounds, cfg, device=device)
        with torch.no_grad():
            outs.append(model.encoder.encode_images(prep["rgbs"], prep["pcds"],
                                                    prep["pcd_valid_mask"]))
    (feats, pos, mask), (feats_c, pos_c, mask_c) = outs
    assert feats_c.shape == feats.shape == (2, 32, 120)
    _assert_bf16_close(feats_c, feats)
    torch.testing.assert_close(pos_c.cpu(), pos, rtol=0, atol=1e-5)
    assert torch.equal(mask_c.cpu(), mask) and not bool(mask.all())


@pytest.mark.parametrize("include_dynamic", [False, True])
def test_mapper_on_cuda_matches_cpu(gen, include_dynamic):
    """Three frames of a relief at 0.05 m voxels, 48x48 depth and a 96x96
    feature image, through the recipe with a dynamic mask, then the
    surface: the card equals the CPU (fp32 1e-5, fp16 pools 1e-3; all
    elementwise IEEE ops and integer scans)."""
    from nvblox_mindmap_torch.mapping.constants import MappingConfig
    from nvblox_mindmap_torch.mapping.mapper import (
        Mapper,
        get_vertices_and_features,
        nvblox_integrate,
    )
    from nvblox_mindmap_torch.mapping.voxel_grid import state_to_numpy

    cfg = MappingConfig(voxel_size_m=0.05, aabb_min_m=(-0.6, -0.6, 0.4),
                        aabb_max_m=(0.6, 0.6, 1.6), min_integration_distance_m=0.1,
                        feature_dim=8, max_feature_pages=128,
                        static_mask_erosion_iterations=1, dynamic_mask_erosion_iterations=1,
                        valid_depth_mask_erosion_iterations=1, dynamic_class_labels=("robot",))
    mappers = {d: (Mapper.dual(cfg, device=d) if include_dynamic else Mapper({0: cfg}, device=d))
               for d in ("cpu", "cuda")}
    rng = np.random.default_rng(1)
    size = 48
    K = np.asarray([[40.0, 0, 24], [0, 40.0, 24], [0, 0, 1]], np.float32)
    vv, uu = np.mgrid[0:size, 0:size] / size
    frames = 3
    with launches() as counts:
        for i in range(frames):
            depth = (1.0 + 0.15 * np.sin(5 * uu + i) * np.cos(3 * vv)).astype(np.float32)
            depth[rng.uniform(size=depth.shape) < 0.05] = 0.0
            T = np.eye(4, dtype=np.float32)
            T[:3, 3] = rng.uniform(-0.05, 0.05, 3)
            feats = rng.normal(size=(2 * size, 2 * size, 8)).astype(np.float32)
            rgb = rng.uniform(size=(size, size, 3)).astype(np.float32)
            robot = np.zeros((size, size), bool)
            robot[10:30, 5 + 5 * i:20 + 5 * i] = True
            for mapper in mappers.values():
                mapper.decay()
                nvblox_integrate(mapper, cfg, depth, feats, K, T, rgb, robot, include_dynamic)
    # The card's color and feature updates went through the pool kernel: two
    # launches a frame and map (the CPU mapper runs the plain version).
    assert counts["integrate_pool"] == 2 * frames * len(mappers["cuda"].states)
    for mid in mappers["cpu"].states:
        ref = state_to_numpy(mappers["cpu"].states[mid])
        out = state_to_numpy(mappers["cuda"].states[mid])
        for name, value in ref.items():
            atol = 1e-3 if value.dtype == np.float16 else 1e-5
            np.testing.assert_allclose(out[name].astype(np.float64), value.astype(np.float64),
                                       atol=atol, rtol=0, err_msg=name)
        v, f = get_vertices_and_features(mappers["cpu"], mid, remove_zero_features=True)
        vc, fc = get_vertices_and_features(mappers["cuda"], mid, remove_zero_features=True)
        assert vc.shape == v.shape and len(v) > 50
        np.testing.assert_allclose(vc, v, atol=1e-5, rtol=0)
        np.testing.assert_allclose(fc, f, atol=1e-3, rtol=0)


# ------------------------------------------------------- the pool kernel

# ``csrc/integrate_pool.cu`` against the plain version run on the same CUDA
# tensors, compared bit for bit (-0 and +0 apart). The map is 1/16 m voxels
# from origins on that grid, so every voxel centre is exact in fp32; the
# first frame's camera sits at the origin looking down +z with f = 16 and
# c = 24 over a 48x48 image: voxels at z = 1 project to u = i + 16.5 (rintf's
# half-way case), at z = 0.5 to u = 2i + 9 (i = 19 on the image's last
# column, i = 20 past it), at z = 0.25 partly off the image, at z = 0 onto
# the 1e-6 guard, and below behind the camera. The later frames move and
# turn the camera, with decay in between.
POOL_SIZE = 48
POOL_LIVE = 24  # of 40 pages over 36 blocks: the rest free, reclaimed ones stale


def _pool_config(C):
    from nvblox_mindmap_torch.mapping.constants import MappingConfig

    return MappingConfig(voxel_size_m=0.0625, aabb_min_m=(-0.5, -0.5, -0.53125),
                         aabb_max_m=(1.0, 1.0, 1.46875), min_integration_distance_m=0.1,
                         feature_dim=C, max_feature_pages=40)


def _pool_state(gen, C):
    """A random map: live pages on distinct blocks, free pages with stale rows
    and zero weights, -0 in about 5% of the pool."""
    cfg = _pool_config(C)
    X, Y, Z = cfg.grid_shape
    P, slots = cfg.max_feature_pages, cfg.block_size**3

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    n_blocks = int(np.prod(cfg.block_grid_shape))
    page_to_block = torch.full((P,), -1, dtype=torch.int32, device="cuda")
    pages = torch.randperm(P, generator=gen, device="cuda")[:POOL_LIVE]
    page_to_block[pages] = torch.randperm(n_blocks, generator=gen, device="cuda")[
        :POOL_LIVE].to(torch.int32)
    pool = torch.randn(P, slots, C, generator=gen, device="cuda").half()
    pool[rand(P, slots, C) < 0.05] = -0.0
    live = (page_to_block >= 0)[:, None]
    pool_weight = 3 * rand(P, slots) * (rand(P, slots) > 0.3) * live
    tsdf = (2 * rand(X, Y, Z) - 1) * cfg.truncation_distance_m
    weight = rand(X, Y, Z) * (rand(X, Y, Z) > 0.4)
    return cfg, pool, pool_weight, page_to_block, tsdf, weight


def _pool_frame(gen, C, dtype, masked, i):
    image = torch.randn(POOL_SIZE, POOL_SIZE, C, generator=gen, device="cuda").to(dtype)
    image[torch.rand(image.shape, generator=gen, device="cuda") < 0.05] = -0.0
    mask = None
    if masked:
        mask = torch.rand(POOL_SIZE, POOL_SIZE, generator=gen, device="cuda") > 0.3
    T = torch.eye(4, dtype=torch.float64)
    if i > 0:  # a turn about a random axis and a shift
        axis = torch.randn(3, generator=gen, device="cuda").double().cpu()
        angle = 0.1 * i
        kx, ky, kz = (axis / axis.norm()).tolist()
        cross = torch.tensor([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]], dtype=torch.float64)
        T[:3, :3] = (torch.eye(3, dtype=torch.float64) + np.sin(angle) * cross
                     + (1 - np.cos(angle)) * cross @ cross)
        T[:3, 3] = torch.tensor([0.05, -0.03, 0.02]) * i
    K = torch.tensor([[16.0, 0, 24], [0, 16.0, 24], [0, 0, 1]])
    return image, T.float().to("cuda"), K.to("cuda"), mask


def _assert_bits_equal(out, ref, what):
    bits = {torch.float16: torch.int16, torch.float32: torch.int32}[out.dtype]
    differ = out.view(bits) != ref.view(bits)
    assert not bool(differ.any()), f"{what}: {int(differ.sum())} of {out.numel()} differ"


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [3, 8, 120, 768])
def test_pool_kernel_equals_plain_version(gen, C, dtype, masked):
    """Three frames: pool and weights equal to the bit the plain version's on
    the card after each, one launch a call, updated in place."""
    from nvblox_mindmap_torch.mapping import voxel_grid as vg

    cfg, pool, pool_weight, page_to_block, tsdf, weight = _pool_state(gen, C)
    ref_pool, ref_weight = pool.clone(), pool_weight.clone()
    for i in range(3):
        if i:
            pool_weight = vg._decay_pool_weight(pool_weight, cfg)
            ref_weight = vg._decay_pool_weight(ref_weight, cfg)
        image, T, K, mask = _pool_frame(gen, C, dtype, masked, i)
        args = (page_to_block, tsdf, weight, image, T, K, mask, cfg, 0.7)
        before_pool, before_weight = ref_pool, ref_weight
        ref_pool, ref_weight = vg._integrate_pool_reference(ref_pool, ref_weight, *args)
        with launches() as counts:
            out = vg._integrate_pool(pool, pool_weight, *args)
        assert counts["integrate_pool"] == 1
        assert out[0] is pool and out[1] is pool_weight
        _assert_bits_equal(pool, ref_pool, f"pool, frame {i}")
        _assert_bits_equal(pool_weight, ref_weight, f"weights, frame {i}")
        # The frame measured voxels and rewrote rows.
        assert bool((ref_weight > before_weight).any())
        assert bool((ref_pool.view(torch.int16) != before_pool.view(torch.int16)).any())


def test_pool_kernel_non_finite_pixels(gen):
    """Inf and NaN pixels: the plain version's NaN reaches every weighted
    voxel that reads such a pixel, measured or not; the kernel's too."""
    from nvblox_mindmap_torch.mapping import voxel_grid as vg

    cfg, pool, pool_weight, page_to_block, tsdf, weight = _pool_state(gen, 8)
    image, T, K, mask = _pool_frame(gen, 8, torch.float32, False, 1)
    image[::7, ::5, 2] = float("inf")
    image[3::11, ::3, 5] = float("nan")
    args = (page_to_block, tsdf, weight, image, T, K, mask, cfg, 1.0)
    ref_pool, ref_weight = vg._integrate_pool_reference(pool.clone(), pool_weight.clone(), *args)
    vg._integrate_pool(pool, pool_weight, *args)
    nan = ref_pool.isnan()
    assert bool(nan.any()) and torch.equal(pool.isnan(), nan)
    _assert_bits_equal(pool[~nan], ref_pool[~nan], "pool")
    _assert_bits_equal(pool_weight, ref_weight, "weights")


def test_pool_kernel_donation_through_the_functional_api(gen):
    """``integrate_features`` / ``integrate_color`` / ``fuse_frame`` return
    the input state's pool, updated in place, equal to the plain version."""
    from nvblox_mindmap_torch.mapping import voxel_grid as vg

    cfg, pool, pool_weight, page_to_block, tsdf, weight = _pool_state(gen, 120)
    state = vg.create_state(cfg, "cuda")
    state = vg.VoxelGridState(
        tsdf=tsdf, weight=weight, page_table=state.page_table, page_to_block=state.page_to_block,
        num_pages=state.num_pages, feat=pool, feat_weight=torch.zeros_like(pool_weight),
        color=pool[..., :3].contiguous(), color_weight=torch.zeros_like(pool_weight))
    image, T, K, mask = _pool_frame(gen, 120, torch.float16, True, 0)
    rgb = torch.rand(POOL_SIZE, POOL_SIZE, 3, generator=gen, device="cuda")
    for name, update, pool_name in (
            ("integrate_features", lambda s: vg.integrate_features(s, cfg, image, T, K, mask),
             "feat"),
            ("integrate_color", lambda s: vg.integrate_color(s, cfg, rgb, T, K), "color")):
        plain = vg.allocate_pages(state, cfg)
        ref = vg._integrate_pool_reference(
            getattr(plain, pool_name).clone(), getattr(plain, pool_name + "_weight"),
            plain.page_to_block, plain.tsdf, plain.weight,
            image if pool_name == "feat" else rgb, T, K, mask if pool_name == "feat" else None,
            cfg, cfg.projective_appearance_integrator_measurement_weight
            if pool_name == "feat" else 1.0)
        donated = getattr(state, pool_name)
        with launches() as counts:
            state = update(state)
        assert counts["integrate_pool"] == 1, name
        assert getattr(state, pool_name) is donated, name
        _assert_bits_equal(getattr(state, pool_name), ref[0], name)
        _assert_bits_equal(getattr(state, pool_name + "_weight"), ref[1], name)
    depth = torch.full((POOL_SIZE, POOL_SIZE), 0.75, device="cuda")
    donated = state.feat
    with launches() as counts:
        fused = vg.fuse_frame(state, cfg, depth, image, T, K, K, feature_mask=mask)
    assert counts["integrate_pool"] == 1 and fused.feat is donated


def test_pool_kernel_raises_instead_of_falling_back(gen):
    from nvblox_mindmap_torch.mapping import voxel_grid as vg
    from nvblox_mindmap_torch.ops.integrate_pool import integrate_pool

    cfg, pool, pool_weight, page_to_block, tsdf, weight = _pool_state(gen, 8)
    image, T, K, mask = _pool_frame(gen, 8, torch.float32, True, 0)
    rest = (T, K, mask, cfg, 1.0)
    with launches() as counts:
        with pytest.raises(TypeError, match="fp16, bf16 or fp32 image"):
            vg._integrate_pool(pool, pool_weight, page_to_block, tsdf, weight, image.double(),
                               *rest)
        with pytest.raises(TypeError, match="fp16 pool"):
            vg._integrate_pool(pool.float(), pool_weight, page_to_block, tsdf, weight, image,
                               *rest)
        with pytest.raises(ValueError, match="contiguous image"):
            integrate_pool(pool, pool_weight, page_to_block, tsdf, weight,
                           image.transpose(0, 1), *rest)
        with pytest.raises(ValueError, match=r"\(H, W, 8\)"):
            vg._integrate_pool(pool, pool_weight, page_to_block, tsdf, weight, image[..., :4],
                               *rest)
        with pytest.raises(ValueError, match="every tensor"):
            vg._integrate_pool(pool, pool_weight, page_to_block, tsdf, weight, image, T.cpu(),
                               K, mask, cfg, 1.0)
    assert counts["integrate_pool"] == 0


# ------------------------------------------------------------------ training


def test_flash_refuses_under_grad_on_cuda(gen):
    """The kernels have no backward: under autograd they raise and launch
    nothing."""
    q = torch.randn(2, 8, 3, 15, device="cuda", generator=gen).requires_grad_()
    k = torch.randn(2, 8, 64, 15, device="cuda", generator=gen)
    with launches() as counts:
        for call in (lambda: fa.flash_attention(q, k, k), lambda: fa.run_kernel(SPLIT, q, k, k),
                     lambda: fa.run_kernel(TILE, q, k, k)):
            with pytest.raises(RuntimeError, match="no backward"):
                call()
    assert not any(flash(counts).values())
    with torch.no_grad():
        out = fa.flash_attention(q, k, k)
    torch.testing.assert_close(out, fa.flash_attention_reference(q.detach(), k, k),
                               rtol=0, atol=ATOL)


def test_train_step_on_cuda_matches_cpu(gen):
    """A small train step on the card with the flash impl installed: no
    kernel launch, the CPU's loss and gradients (fp32 summation orders);
    then an eval batch launches both kernels."""
    from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActorConfig
    from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig

    cfg = DiffuserActorConfig(embedding_dim=72, num_attn_heads=8, vertex_feature_dim=3,
                              diffusion_timesteps=100, fps_subsampling_factor=4)
    rng = np.random.default_rng(1)
    quat = rng.normal(size=(2, 4, 1, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    poses = np.concatenate([rng.uniform(0, 1, (2, 4, 1, 3)), quat,
                            rng.integers(0, 2, (2, 4, 1, 1))], -1).astype(np.float32)
    batch = {"gripper_history": poses[:, :3], "gt_gripper_pred": poses[:, 3:],
             "vertices": rng.uniform(0, 1, (2, 256, 3)).astype(np.float32),
             "vertex_features": rng.uniform(0, 1, (2, 256, 3)).astype(np.float32)}
    bounds = np.asarray([[0, 0, 0], [1, 1, 1]], np.float32)
    noise = torch.from_numpy(rng.normal(size=(2, 1, 1, 9)).astype(np.float32))
    timesteps = torch.from_numpy(rng.integers(0, 100, 2))
    trainers = {d: Trainer(cfg, TrainerConfig(), bounds, device=d) for d in ("cuda", "cpu")}
    with attention("flash"):
        losses = {}
        with launches() as counts:
            for device, trainer in trainers.items():
                trainer.init_state()
                losses[device] = trainer.compute_loss_and_grads(batch, 0, noise.to(device),
                                                                timesteps.to(device))
        assert counts["calls"] == 0 and not any(flash(counts).values())
        torch.testing.assert_close(losses["cuda"]["total"].cpu(), losses["cpu"]["total"],
                                   rtol=1e-5, atol=0)
        cpu_params = dict(trainers["cpu"].model.named_parameters())
        for name, p in trainers["cuda"].model.named_parameters():
            ref = cpu_params[name].grad
            if ref is None:
                assert p.grad is None, name
                continue
            torch.testing.assert_close(p.grad.cpu(), ref, rtol=1e-3, atol=1e-5, msg=name)
        trainers["cuda"].optimizer.step()
        with launches() as counts:
            trainers["cuda"].eval_step(batch, generator=torch.Generator("cuda").manual_seed(0))
        assert flash(counts) == per_goal(10)


def test_clip_fpn_train_step_repeats_bit_for_bit_on_cuda(gen):
    """The same CLIP rgbd_and_mesh train step twice on the card, from the same
    weights, batch, noise and timesteps: the same losses and bit-equal
    gradients (the trainer asks cuDNN for its deterministic algorithms; the
    FPN's weight gradients otherwise sum in a varying order)."""
    from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActorConfig
    from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig

    B, size = 16, 128
    cfg = DiffuserActorConfig(data_type="rgbd_and_mesh", feature_type="clip_resnet50_fpn",
                              feature_image_size=(16, 16), vertex_feature_dim=120)
    bounds = np.asarray([[0, 0, 0], [1, 1, 1]], np.float32)
    quat = torch.randn((B, 4, 1, 4), generator=gen, device="cuda")
    poses = torch.cat([torch.rand((B, 4, 1, 3), generator=gen, device="cuda"),
                       quat / quat.norm(dim=-1, keepdim=True),
                       torch.randint(0, 2, (B, 4, 1, 1), generator=gen, device="cuda")], -1)
    batch = {"gripper_history": poses[:, :3], "gt_gripper_pred": poses[:, 3:],
             "vertices": torch.rand((B, 256, 3), generator=gen, device="cuda"),
             "vertex_features": torch.randn((B, 256, 120), generator=gen, device="cuda"),
             "vertices_valid_mask": torch.ones((B, 256), dtype=torch.bool, device="cuda"),
             "rgbs": torch.rand((B, 1, size, size, 3), generator=gen, device="cuda"),
             "pcds": torch.rand((B, 1, size, size, 3), generator=gen, device="cuda"),
             "pcd_valid_mask": torch.ones((B, 1, size, size), dtype=torch.bool, device="cuda")}
    noise = torch.randn((B, 1, 1, 9), generator=gen, device="cuda")
    timesteps = torch.randint(0, 100, (B,), generator=gen, device="cuda")
    trainer = Trainer(cfg, TrainerConfig(batch_size=B), bounds, device="cuda")
    trainer.init_state()
    runs = []
    for _ in range(2):
        losses = trainer.compute_loss_and_grads(batch, 0, noise, timesteps)
        grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()
                 if p.grad is not None}
        trainer.model.zero_grad(set_to_none=True)
        runs.append((losses, grads))
    (losses_a, grads_a), (losses_b, grads_b) = runs
    assert any(n.startswith("encoder.feature_extractor.fpn") for n in grads_a)
    assert all(torch.equal(losses_a[k], losses_b[k]) for k in losses_a)
    assert grads_a.keys() == grads_b.keys()
    assert all(torch.equal(grads_a[n], grads_b[n]) for n in grads_a)


# ---------------------------------------------------------------- FPS kernel


def _fps_points(gen, B, N, C, valid=0.7):
    """Normal features with about 1 - ``valid`` of the tokens zeroed, as
    ``Encoder.run_fps`` zeroes invalid ones: exact ties."""
    points = torch.randn(B, N, C, device="cuda", generator=gen)
    keep = torch.rand(B, N, device="cuda", generator=gen) < valid
    return torch.where(keep[..., None], points, 0.0)


def _assert_fps_equal(points, K, start_idx=0):
    ref_idx, ref_dist = fps_ops.farthest_point_sampling_reference(points, K, start_idx)
    idx, dist = fps_ops.run_kernel(points, K, start_idx)
    torch.cuda.synchronize()
    assert torch.equal(idx, ref_idx), int((idx != ref_idx).sum())
    torch.testing.assert_close(dist, ref_dist, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize(
    "B,N,C,K",
    [
        # The cells: goals and loops (B = 1), training (B = 32), and the
        # flagship's 4096 tokens (a cluster of 9, above the portable 8).
        (1, 3072, 120, 614),
        (32, 3072, 120, 614),
        (1, 4096, 120, 819),
        (8, 3072, 120, 614),
        # The fixtures' small widths (72, 24) and lanes below a warp.
        (1, 645, 72, 129),
        (3, 300, 24, 60),
        (2, 50, 3, 10),
        (4, 64, 9, 16),
        # Either side of C = 128, from which ATen reads float4 (dim0 >= 128),
        # rows 16-byte aligned or not.
        (2, 1000, 127, 200),
        (2, 1000, 128, 200),
        (2, 1000, 129, 200),
        (4, 777, 256, 100),
        (2, 1000, 130, 200),
        (2, 300, 131, 40),
        # K = N and K = 1; N and C off every tile; one point per row.
        (3, 1001, 37, 1001),
        (2, 100, 120, 1),
        (16, 1, 120, 1),
        # Most of each slice streamed from L2 at every pick; a row so wide
        # that 16 blocks' candidate vectors leave no room, so fewer blocks
        # stream all of it.
        (2, 30000, 64, 40),
        (1, 12000, 2000, 16),
    ],
)
def test_fps_kernel_equals_eager(gen, B, N, C, K):
    _assert_fps_equal(_fps_points(gen, B, N, C), K)


def test_fps_kernel_edge_rows(gen):
    """An all-zero row (every distance ties at 0), a row of duplicates, a
    start index other than 0, and a NaN coordinate (NaN wins every argmax)."""
    points = _fps_points(gen, 4, 500, 120)
    points[0] = 0.0
    points[1] = points[1, :5].repeat(100, 1)
    points[3, 17, 40] = float("nan")
    _assert_fps_equal(points, 100)
    _assert_fps_equal(points, 100, start_idx=321)


def test_fps_kernel_launches_once_per_call(gen):
    points = _fps_points(gen, 2, 3072, 120)
    with launches() as counts:
        for _ in range(3):
            idx = fps_ops.farthest_point_sampling(points, 614)
    assert counts["fps"] == 3
    assert torch.equal(idx, fps_ops.farthest_point_sampling_reference(points, 614)[0])
    from nvblox_mindmap_torch.models.encoder import Encoder

    enc = Encoder(embedding_dim=120, fps_subsampling_factor=5, data_type="mesh").cuda()
    mask = torch.ones(2, 3072, dtype=torch.bool, device="cuda")
    with launches() as counts:
        enc.run_fps(points, torch.zeros(2, 3072, 3, device="cuda"), mask)
    assert counts["fps"] == 1


def test_fps_kernel_without_distances_stores_none(gen):
    """The program's calls ask for no running distances: the same picks,
    one launch, and no (B, N) output."""
    points = _fps_points(gen, 3, 3072, 120)
    with launches() as counts:
        idx, dist = fps_ops.run_kernel(points, 614, with_distances=False)
    assert dist is None and counts["fps"] == 1
    assert torch.equal(idx, fps_ops.farthest_point_sampling_reference(points, 614)[0])


def test_fps_kernel_raises_instead_of_falling_back(gen):
    points = _fps_points(gen, 2, 100, 120)
    with launches() as counts:
        with pytest.raises(TypeError, match="float32"):
            fps_ops.farthest_point_sampling(points.double(), 10)
        with pytest.raises(ValueError, match="contiguous"):
            fps_ops.farthest_point_sampling(points.transpose(1, 2), 10)
        with pytest.raises(ValueError, match="num_samples"):
            fps_ops.farthest_point_sampling(points, 101)
        with pytest.raises(ValueError, match="start_idx"):
            fps_ops.farthest_point_sampling(points, 10, start_idx=100)
        with pytest.raises(ValueError, match="one warp"):  # ATen sums 8 rows of 120 over 64 lanes
            fps_ops.farthest_point_sampling(points[:1, :8].contiguous(), 2)
    assert counts["fps"] == 0


# ------------------------------------------------- the sampler's CUDA graph

# The denoiser loop captured as a CUDA graph and replayed, against the same
# loop run eagerly (``_graph_applies`` patched to False): the same bits, the
# same flash launches per call. Shapes: radio_goal's (B = 1, 3072 keys, FPS
# to 614, 768-d vertex features, DDIM-10), stochastic DDPM-100, the GR1
# humanoid's two hands and head yaw, a B = 8 batch.
SAMPLER_CASES = {
    "radio_goal": dict(config={}, B=1, sampler=dict(num_inference_steps=10,
                                                    scheduler_kind="ddim", stochastic=False)),
    "ddpm100_stochastic": dict(config={}, B=1, sampler=dict(num_inference_steps=None,
                                                            scheduler_kind="ddpm",
                                                            stochastic=True)),
    "gr1_two_hands_head_yaw": dict(config=dict(ngrippers=2, predict_head_yaw=True), B=1,
                                   sampler=dict(num_inference_steps=10, scheduler_kind="ddim",
                                                stochastic=False)),
    "batch_8": dict(config={}, B=8, sampler=dict(num_inference_steps=10,
                                                 scheduler_kind="ddim", stochastic=False)),
}
GOAL_KEYS = 3072


def _sampler_model(**config):
    from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActor, DiffuserActorConfig

    torch.manual_seed(0)
    return DiffuserActor(DiffuserActorConfig(**config))


def _sampler_inputs(model, gen, B, sampler):
    """A prepared batch over ``GOAL_KEYS`` mesh vertices (a tenth masked
    out) and the sampler's noise."""
    from nvblox_mindmap_torch.models.diffuser_actor import prepare_inputs, sampler_noise

    cfg = model.config
    G = cfg.ngrippers
    quat = torch.randn((B, cfg.nhist, G, 4), generator=gen, device="cuda")
    batch = {
        "gripper_history": torch.cat(
            [torch.rand((B, cfg.nhist, G, 3), generator=gen, device="cuda"),
             quat / quat.norm(dim=-1, keepdim=True),
             torch.ones((B, cfg.nhist, G, 1), device="cuda")], -1),
        "vertices": torch.rand((B, GOAL_KEYS, 3), generator=gen, device="cuda"),
        "vertex_features": torch.randn((B, GOAL_KEYS, cfg.vertex_feature_dim),
                                       generator=gen, device="cuda"),
        "vertices_valid_mask": torch.rand((B, GOAL_KEYS), generator=gen, device="cuda") > 0.1,
    }
    bounds = np.asarray([[0, 0, 0], [1, 1, 1]], np.float32)
    steps = cfg.schedules(kind=sampler["scheduler_kind"])[0].timesteps(
        sampler["num_inference_steps"]).shape[0]
    init, step = sampler_noise(cfg, B, steps, sampler["stochastic"], gen, "cuda")
    return prepare_inputs(batch, bounds, cfg), bounds, dict(init_noise=init, step_noise=step)


def _counted_call(model, inputs, sampler, eager=False):
    """One ``sample_trajectory`` call: its outputs, and what it added to the
    flash counters and to the sampler's path counters."""
    from unittest import mock

    from nvblox_mindmap_torch.models import diffuser_actor as da

    prepared, bounds, noise = inputs
    counters = ("graph_captures", "graph_replays", "eager_calls")
    before = [getattr(da.sample_trajectory, c) for c in counters]
    eager_only = mock.patch.object(da, "_graph_applies", lambda *a: False)
    with eager_only if eager else contextlib.nullcontext(), launches() as counts:
        out = da.sample_trajectory(model, prepared, bounds, **sampler, **noise)
    paths = {c: getattr(da.sample_trajectory, c) - b for c, b in zip(counters, before)}
    return out, counts["calls"], flash(counts), paths


def _assert_same_bits(a, b):
    assert a[2] is None and b[2] is None
    assert torch.equal(a[0], b[0])
    assert (a[1] is None) == (b[1] is None)
    assert a[1] is None or torch.equal(a[1], b[1])


@pytest.fixture
def flash_impl():
    with attention("flash"):
        yield


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_graph_equals_eager_loop(gen, flash_impl, case):
    """Capture, then replays on the same and on new inputs: each call equal
    to the eager loop's to the bit, with the eager loop's flash launches;
    the returned tensors are the caller's (a later replay leaves them)."""
    spec = SAMPLER_CASES[case]
    model = _sampler_model(**spec["config"])
    first = _sampler_inputs(model, gen, spec["B"], spec["sampler"])
    second = _sampler_inputs(model, gen, spec["B"], spec["sampler"])
    T = len(model.config.schedules()[0].timesteps(spec["sampler"]["num_inference_steps"]))
    calls = 3 + 10 * T
    kernels = {SPLIT: 3 + 2 * T, TILE: 8 * T}

    eager_a = _counted_call(model, first, spec["sampler"], eager=True)
    eager_b = _counted_call(model, second, spec["sampler"], eager=True)
    captured = _counted_call(model, first, spec["sampler"])
    replay_a = _counted_call(model, first, spec["sampler"])
    replay_b = _counted_call(model, second, spec["sampler"])
    for call in (eager_a, eager_b, captured, replay_a, replay_b):
        assert call[1] == calls and call[2] == kernels
    assert eager_a[3] == eager_b[3] == dict(graph_captures=0, graph_replays=0, eager_calls=1)
    assert captured[3] == dict(graph_captures=1, graph_replays=0, eager_calls=0)
    assert replay_a[3] == replay_b[3] == dict(graph_captures=0, graph_replays=1, eager_calls=0)
    _assert_same_bits(captured[0], eager_a[0])
    _assert_same_bits(replay_a[0], eager_a[0])
    _assert_same_bits(replay_b[0], eager_b[0])
    assert not torch.equal(eager_a[0][0], eager_b[0][0])
    if model.config.predict_head_yaw:
        assert replay_b[0][1].shape == (spec["B"], 1, 1)


def test_sampler_graph_captures_again_on_new_storage_and_tf32(gen, flash_impl):
    """A key names the parameters' storage and the TF32 flags: new storage,
    or TF32 switched on, captures again, and the replay still equals the
    eager loop."""
    spec = SAMPLER_CASES["radio_goal"]
    model = _sampler_model()
    inputs = _sampler_inputs(model, gen, 1, spec["sampler"])
    _counted_call(model, inputs, spec["sampler"])
    assert _counted_call(model, inputs, spec["sampler"])[3]["graph_replays"] == 1
    for p in model.head.parameters():
        p.data = p.data.clone()
    assert _counted_call(model, inputs, spec["sampler"])[3]["graph_captures"] == 1
    replay = _counted_call(model, inputs, spec["sampler"])
    assert replay[3]["graph_replays"] == 1
    _assert_same_bits(replay[0], _counted_call(model, inputs, spec["sampler"], eager=True)[0])
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not saved
        assert _counted_call(model, inputs, spec["sampler"])[3]["graph_captures"] == 1
        replay = _counted_call(model, inputs, spec["sampler"])
        assert replay[3]["graph_replays"] == 1
        _assert_same_bits(replay[0],
                          _counted_call(model, inputs, spec["sampler"], eager=True)[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert _counted_call(model, inputs, spec["sampler"])[3]["graph_replays"] == 1


def test_sampler_graph_leaves_flop_counter_the_eager_loop(gen, flash_impl):
    """Under ``FlopCounterMode`` the loop runs eagerly, with a graph of the
    same key cached or not: the same count either way."""
    from torch.utils.flop_counter import FlopCounterMode

    spec = SAMPLER_CASES["radio_goal"]
    model = _sampler_model()
    inputs = _sampler_inputs(model, gen, 1, spec["sampler"])
    counts = []
    for _ in range(2):
        with FlopCounterMode(display=False) as counter:
            call = _counted_call(model, inputs, spec["sampler"])
        assert call[3] == dict(graph_captures=0, graph_replays=0, eager_calls=1)
        counts.append(counter.get_total_flops())
        _counted_call(model, inputs, spec["sampler"])  # capture, then replay
    assert counts[0] == counts[1] > 0


def test_sampler_graph_replays_the_calls_it_listed(gen, flash_impl):
    """A replay counts, in ``fa.REPLAYED``, the very calls that the eager
    loop launches: each kernel, q's shape, the keys, q's element size and
    the mask's valid keys (a tenth of the vertices masked out)."""
    from unittest import mock

    spec = SAMPLER_CASES["radio_goal"]
    model = _sampler_model()
    inputs = _sampler_inputs(model, gen, 1, spec["sampler"])
    eager = []
    run_kernel = fa.run_kernel

    def listing(name, q, k, v, key_padding_mask=None):
        eager.append(fa.KernelCall(name, tuple(q.shape), k.shape[2], q.element_size(),
                                   None if key_padding_mask is None
                                   else int(key_padding_mask.sum())))
        return run_kernel(name, q, k, v, key_padding_mask)

    with mock.patch.object(fa, "run_kernel", listing):
        _counted_call(model, inputs, spec["sampler"], eager=True)
    _counted_call(model, inputs, spec["sampler"])  # capture
    before = fa.REPLAYED.copy()
    _counted_call(model, inputs, spec["sampler"])
    replayed = fa.REPLAYED - before
    denoiser = collections.Counter(eager[3:])  # the encoder's 3 calls run eagerly
    assert replayed == denoiser
    assert any(call.valid_keys is not None and call.valid_keys < call.keys
               for call in replayed)


def test_sampler_graph_counts_per_thread_in_sharded_serving(gen, flash_impl):
    """``make_sharded_infer_fn`` over two replicas on one card runs its
    shards in two threads, whose warm-ups and replays run at once (their
    captures one after the other): each call counts both shards' launches
    and no more, and equals the eager loop's call to the bit."""
    from unittest import mock

    from nvblox_mindmap_torch.models import diffuser_actor as da
    from nvblox_mindmap_torch.models.diffuser_actor import sampler_noise
    from nvblox_mindmap_torch.parallel.serving import make_sharded_infer_fn

    model = _sampler_model()
    cfg, B = model.config, 2
    quat = torch.randn((B, cfg.nhist, 1, 4), generator=gen, device="cuda")
    batch = {
        "gripper_history": torch.cat(
            [torch.rand((B, cfg.nhist, 1, 3), generator=gen, device="cuda"),
             quat / quat.norm(dim=-1, keepdim=True),
             torch.ones((B, cfg.nhist, 1, 1), device="cuda")], -1),
        "vertices": torch.rand((B, GOAL_KEYS, 3), generator=gen, device="cuda"),
        "vertex_features": torch.randn((B, GOAL_KEYS, cfg.vertex_feature_dim),
                                       generator=gen, device="cuda"),
    }
    bounds = np.asarray([[0, 0, 0], [1, 1, 1]], np.float32)
    infer = make_sharded_infer_fn(model, bounds, ["cuda:0", "cuda:0"],
                                  num_inference_steps=10, scheduler_kind="ddim")
    params = model.state_dict()
    init, _ = sampler_noise(cfg, B, 10, False, gen, "cuda")

    def call(eager=False):
        before = (da.sample_trajectory.graph_captures, da.sample_trajectory.graph_replays)
        patch = mock.patch.object(da, "_graph_applies", lambda *a: False)
        with patch if eager else contextlib.nullcontext(), launches() as counts:
            out = infer(params, batch, init_noise=init)
        return (out, counts["calls"], flash(counts),
                da.sample_trajectory.graph_captures - before[0],
                da.sample_trajectory.graph_replays - before[1])

    eager = call(eager=True)
    expected = (2 * (3 + 10 * 10), {SPLIT: 2 * (3 + 2 * 10), TILE: 2 * 8 * 10})
    for captures, replays in ((2, 0), (0, 2), (0, 2)):
        out, calls, by_kernel, got_captures, got_replays = call()
        assert (calls, by_kernel) == expected
        assert (got_captures, got_replays) == (captures, replays)
        assert torch.equal(out[0], eager[0][0])
    assert (eager[1], eager[2]) == expected
