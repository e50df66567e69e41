"""Torch port on the card: the CUDA kernels against their plain version,
and the plain-torch paths (ViT, image encoding, the mapper) on the card
against the same code on the CPU.

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
surface features 1e-3 (``tests/test_torch_mapping.py``'s bounds).
"""
import numpy as np
import pytest
import torch

from nvblox_mindmap_torch.ops import flash_attention as fa

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
    ],
)
def test_kernel_matches_plain_version(gen, B, H, L, S, D, masked):
    q, k, v, mask = _inputs(gen, B, H, L, S, D, masked)
    name = fa.kernel_for(L)
    before = fa.flash_attention.launches
    before_kernel = fa.KERNEL_LAUNCHES[name]
    out = fa.flash_attention(q, k, v, mask)
    ref = fa.flash_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert fa.KERNEL_LAUNCHES[name] == before_kernel + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)
    if masked:
        assert bool((out[0] == 0).all())


@pytest.mark.parametrize("name", [SPLIT, TILE])
@pytest.mark.parametrize("D", [9, 15, 32, 64])
@pytest.mark.parametrize("L,S", [(1, 333), (8, 2048), (3, 64)])
def test_each_kernel_at_every_head_dim(gen, name, D, L, S):
    q, k, v, mask = _inputs(gen, 2, 3, L, S, D, masked=True)
    out = fa.run_kernel(name, q, k, v, mask)
    ref = fa.flash_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)
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
                                   (20, 300, 64), (4, 256, 64)])
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
    with pytest.raises(ValueError, match="head dims"):
        w = torch.zeros(1, 1, 2, 65, device="cuda")
        fa.flash_attention(w, w, w)
    with pytest.raises(ValueError, match="unit-stride"):
        t = torch.zeros(1, 2, 3, 16, device="cuda")[..., ::2]
        fa.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention(z, z.cpu(), z)
    with pytest.raises(ValueError, match="queries"):
        w = torch.zeros(1, 1, 9, 8, device="cuda")
        fa.run_kernel(SPLIT, w, w, w)


def test_model_flash_path_matches_eager_on_cuda(gen):
    from nvblox_mindmap_torch.models.converter import (
        apply_inference_settings,
        convert_to_flash_attention,
    )
    from nvblox_mindmap_torch.models.diffuser_actor import (
        DiffuserActor,
        DiffuserActorConfig,
        prepare_inputs,
        sample_trajectory,
    )
    from nvblox_mindmap_torch.ops.attention import set_default_attention_impl

    cfg = DiffuserActorConfig(embedding_dim=72, num_attn_heads=8, vertex_feature_dim=3,
                              diffusion_timesteps=100, fps_subsampling_factor=4,
                              ngrippers=2, predict_head_yaw=True)
    torch.manual_seed(0)
    model = DiffuserActor(cfg)
    rng = np.random.default_rng(0)
    quat = rng.normal(size=(2, 3, 2, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    batch = {
        "gripper_history": np.concatenate(
            [rng.uniform(0, 1, (2, 3, 2, 3)), quat, np.ones((2, 3, 2, 1))], -1
        ).astype(np.float32),
        "vertices": rng.uniform(0, 1, (2, 512, 3)).astype(np.float32),
        "vertex_features": rng.uniform(0, 1, (2, 512, 3)).astype(np.float32),
    }
    bounds = np.asarray([[0, 0, 0], [1, 1, 1]], np.float32)
    prepared = prepare_inputs(batch, bounds, cfg)
    init = torch.randn((2, 1, 2, 9), device="cuda", generator=gen)
    kw = dict(num_inference_steps=10, scheduler_kind="ddim", stochastic=False,
              init_noise=init)
    try:
        set_default_attention_impl("eager")
        eager = sample_trajectory(model, prepared, bounds, **kw)
        apply_inference_settings(convert_to_flash_attention())
        before = fa.flash_attention.launches
        before_split = fa.KERNEL_LAUNCHES[SPLIT]
        flash = sample_trajectory(model, prepared, bounds, **kw)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches - before == 3 + 10 * 10
        # Encoder cross (3) and denoiser cross (2 per step) have L <= 8.
        assert fa.KERNEL_LAUNCHES[SPLIT] - before_split == 3 + 2 * 10
    finally:
        set_default_attention_impl("eager")
    assert flash[2] is None and eager[2] is not None
    torch.testing.assert_close(flash[0], eager[0], rtol=0, atol=5e-3)
    torch.testing.assert_close(flash[1], eager[1], rtol=0, atol=5e-3)


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
    for i in range(3):
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
