"""The pool update's dispatch and the pool kernel's launch checks, on the CPU.

On CPU tensors ``voxel_grid._integrate_pool`` runs the plain version and
launches nothing; the kernel's wrapper refuses CPU tensors. Its argument
checks and its layout choice (``ops.integrate_pool.launch_params``) are a
pure function of the tensors' dtypes, shapes, contiguity and alignment,
held here. The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py -k pool_kernel``); the plain version to the JAX
package in ``tests/test_torch_mapping.py``.
"""
import pytest
import torch

from nvblox_mindmap_torch.mapping import voxel_grid as vg
from nvblox_mindmap_torch.mapping.constants import MappingConfig
from nvblox_mindmap_torch.ops import integrate_pool as ip

H = W = 12


def _config(C):
    return MappingConfig(voxel_size_m=0.0625, aabb_min_m=(-0.5, -0.5, -0.53125),
                         aabb_max_m=(0.5, 0.5, 0.46875), min_integration_distance_m=0.1,
                         feature_dim=C, max_feature_pages=6)


def _args(C=8, dtype=torch.float16, masked=True, seed=0):
    """(pool, pool_weight, page_to_block, tsdf, weight, image, T_WC, K, mask):
    a 16^3 map of 8 blocks, 4 of 6 pages live."""
    g = torch.Generator().manual_seed(seed)
    cfg = _config(C)
    X, Y, Z = cfg.grid_shape
    P, slots = cfg.max_feature_pages, cfg.block_size**3
    page_to_block = torch.tensor([3, -1, 0, 7, -1, 5], dtype=torch.int32)
    pool = torch.randn(P, slots, C, generator=g).half()
    pool_weight = torch.rand(P, slots, generator=g) * (page_to_block >= 0)[:, None]
    tsdf = (2 * torch.rand(X, Y, Z, generator=g) - 1) * cfg.truncation_distance_m
    weight = torch.rand(X, Y, Z, generator=g)
    image = torch.randn(H, W, C, generator=g).to(dtype)
    T = torch.eye(4)
    K = torch.tensor([[8.0, 0, 6], [0, 8.0, 6], [0, 0, 1]])
    mask = torch.rand(H, W, generator=g) > 0.2 if masked else None
    return cfg, [pool, pool_weight, page_to_block, tsdf, weight, image, T, K, mask]


def _params(cfg, args):
    return ip.launch_params(*args, cfg.block_size)


@pytest.mark.parametrize("C,dtype,lanes", [
    (3, torch.float32, 1),  # the color pool
    (8, torch.float16, 1),
    (56, torch.float16, 1),  # below 64 channels: a thread a row
    (64, torch.float16, 8),
    (100, torch.float16, 1),  # not a multiple of 8
    (120, torch.float16, 16),  # CLIP: 15 chunks
    (120, torch.bfloat16, 16),
    (256, torch.float16, 32),
    (768, torch.float16, 32),  # RADIO: 96 chunks, 3 a lane
    (768, torch.float32, 32),
])
def test_launch_params_lanes_follow_the_row(C, dtype, lanes):
    cfg, args = _args(C, dtype)
    assert _params(cfg, args) == ip.LaunchParams(lanes, ip.IMAGE_KINDS[dtype])


def test_launch_params_unaligned_image_takes_a_thread_a_row():
    cfg, args = _args(128)
    store = torch.randn(H * W * 128 + 1).half()
    args[5] = store[1:].view(H, W, 128)  # contiguous, 2 bytes off a 16-byte boundary
    assert _params(cfg, args).lanes == 1
    args[5] = store[:-1].view(H, W, 128)
    assert _params(cfg, args).lanes == 16


def _set(i, value):
    def edit(cfg, args):
        args[i] = value(args[i]) if callable(value) else value
    return edit


@pytest.mark.parametrize("edit,error,match", [
    (_set(0, lambda t: t.float()), TypeError, "fp16 pool"),
    (_set(1, lambda t: t.double()), TypeError, "fp32 pool weights"),
    (_set(2, lambda t: t.long()), TypeError, "int32 page table"),
    (_set(3, lambda t: t.half()), TypeError, "fp32 TSDF"),
    (_set(5, lambda t: t.double()), TypeError, "fp16, bf16 or fp32 image"),
    (_set(5, lambda t: (t * 10).to(torch.uint8)), TypeError, "fp16, bf16 or fp32 image"),
    (_set(6, lambda t: t.double()), TypeError, "fp32 T_WC and K"),
    (_set(8, lambda t: t.float()), TypeError, "bool mask"),
    (_set(0, lambda t: t[:, :100]), ValueError, r"\(P, 512, C\)"),
    (_set(1, lambda t: t[:4]), ValueError, "pool weights"),
    (_set(2, lambda t: t[:4]), ValueError, "page_to_block"),
    (_set(3, lambda t: t[:12]), ValueError, "one grid"),
    (_set(5, lambda t: t[..., :4]), ValueError, r"\(H, W, 8\)"),
    (_set(5, lambda t: t[0]), ValueError, r"\(H, W, 8\)"),
    (_set(6, lambda t: t[:3]), ValueError, r"T_WC must be \(4, 4\)"),
    (_set(7, lambda t: t[:2]), ValueError, r"K must be \(3, 3\)"),
    (_set(8, lambda t: t[:5]), ValueError, "the mask must be"),
    (_set(5, lambda t: t.transpose(0, 1)), ValueError, "contiguous image"),
    (_set(6, lambda t: t.t()), ValueError, "contiguous T_WC"),
    (_set(0, lambda t: t.transpose(0, 1).contiguous().transpose(0, 1)), ValueError,
     "contiguous pool"),
])
def test_launch_params_refuses(edit, error, match):
    cfg, args = _args()
    edit(cfg, args)
    with pytest.raises(error, match=match):
        _params(cfg, args)


def test_launch_params_refuses_pages_over_512_voxels():
    cfg, args = _args()
    with pytest.raises(ValueError, match="at most 512 voxels"):
        ip.launch_params(*args, 9)


@pytest.mark.parametrize("masked", [False, True])
def test_cpu_tensors_run_the_plain_version(masked):
    """On the CPU ``_integrate_pool`` is the plain version: new tensors, the
    inputs kept, no launch."""
    cfg, args = _args(masked=masked)
    before = [None if t is None else t.clone() for t in args]
    launches = ip.integrate_pool.launches
    pool, pool_weight = vg._integrate_pool(*args, cfg, 0.7)
    ref_pool, ref_weight = vg._integrate_pool_reference(*before, cfg, 0.7)
    assert ip.integrate_pool.launches == launches
    assert torch.equal(pool.view(torch.int16), ref_pool.view(torch.int16))
    assert torch.equal(pool_weight, ref_weight)
    assert pool is not args[0] and pool_weight is not args[1]
    for t, b in zip(args, before):
        assert t is None or torch.equal(t, b)
    # The frame measured voxels and left the free pages alone.
    assert bool((pool_weight > args[1]).any())
    free = args[2] < 0
    assert torch.equal(pool[free], args[0][free]) and not bool(pool_weight[free].any())


def test_wrapper_refuses_cpu_tensors():
    cfg, args = _args()
    launches = ip.integrate_pool.launches
    with pytest.raises(ValueError, match="runs on cuda"):
        ip.integrate_pool(*args, cfg, 1.0)
    assert ip.integrate_pool.launches == launches
