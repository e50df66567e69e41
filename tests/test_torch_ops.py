"""Torch port vs the JAX package: schedulers, positional codes, rotations,
normalization and FPS.

Inputs are numpy arrays from fixed seeds, fed to both sides. Tolerances:
fp32 elementwise math agrees to a few ulps (atol 1e-6 on O(1) values, 2e-6
through trig and square roots, 1e-5 where a sum of rotated products or a
sine of a large argument adds up ulps); the scheduler tables are identical (both are
float64 numpy cast to float32); FPS indices must be identical.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvblox_mindmap_tpu.geometry import rotations as jrot
from nvblox_mindmap_tpu.models import normalization as jnorm
from nvblox_mindmap_tpu.ops import fps as jfps
from nvblox_mindmap_tpu.ops import positional as jpos
from nvblox_mindmap_tpu.ops import schedulers as jsched
from nvblox_mindmap_torch.geometry import rotations as trot
from nvblox_mindmap_torch.models import normalization as tnorm
from nvblox_mindmap_torch.ops import fps as tfps
from nvblox_mindmap_torch.ops import positional as tpos
from nvblox_mindmap_torch.ops import schedulers as tsched

BOUNDS = np.asarray([[-0.37, -0.75, -0.13], [0.95, 0.75, 0.65]], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------- schedulers


@pytest.mark.parametrize("schedule", ["scaled_linear", "squaredcos_cap_v2"])
def test_schedule_tables_identical(schedule):
    j = jsched.make_schedule(schedule, 100)
    t = tsched.make_schedule(schedule, 100)
    np.testing.assert_array_equal(t.betas, np.asarray(j.betas))
    np.testing.assert_array_equal(t.alphas_cumprod, np.asarray(j.alphas_cumprod))


@pytest.mark.parametrize("spacing", ["leading", "trailing"])
@pytest.mark.parametrize("n", [None, 3, 10, 20, 100])
def test_timesteps_identical(spacing, n):
    j = jsched.make_schedule("scaled_linear", 100)
    t = tsched.make_schedule("scaled_linear", 100)
    np.testing.assert_array_equal(t.timesteps(n, spacing), np.asarray(j.timesteps(n, spacing)))


def test_unknown_spacing_raises():
    with pytest.raises(ValueError, match="spacing"):
        tsched.make_schedule("scaled_linear", 100).timesteps(10, "middle")


@pytest.mark.parametrize("kind", ["ddpm", "ddim"])
@pytest.mark.parametrize("schedule", ["scaled_linear", "squaredcos_cap_v2"])
@pytest.mark.parametrize("clip", [True, False])
def test_step_matches_jax_with_injected_noise(kind, schedule, clip):
    """DDIM: clipped x0 with raw eps; DDPM: fixed_small variance, no noise
    at t = 0. The JAX side draws its noise from the key; the same draw is
    handed to the torch step."""
    rng = np.random.default_rng(0)
    j = jsched.make_schedule(schedule, 100, kind=kind, clip_sample=clip)
    t = tsched.make_schedule(schedule, 100, kind=kind, clip_sample=clip)
    shape = (3, 1, 2, 6)
    sample = rng.normal(size=shape).astype(np.float32) * 2
    eps = rng.normal(size=shape).astype(np.float32)
    for step, prev in [(99, 89), (50, 40), (9, -1), (0, -10), (1, 0), (0, -1)]:
        key = jax.random.PRNGKey(step)
        ref = j.step(jnp.asarray(eps), jnp.asarray(step), jnp.asarray(sample),
                     key=key, prev_t=jnp.asarray(prev))
        noise = np.asarray(jax.random.normal(key, shape, dtype=jnp.float32))
        out = t.step(_t(eps), step, _t(sample), noise=_t(noise), prev_t=prev)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6, rtol=1e-6)
        det = t.step(_t(eps), step, _t(sample), noise=None, prev_t=prev)
        ref_det = j.step(jnp.asarray(eps), jnp.asarray(step), jnp.asarray(sample),
                         key=None, prev_t=jnp.asarray(prev))
        np.testing.assert_allclose(det.numpy(), np.asarray(ref_det), atol=2e-6, rtol=1e-6)


# ---------------------------------------------------------------- positional


def test_sinusoidal_pos_emb_matches_jax():
    # Arguments reach 99 rad, where one fp32 ulp is 7.6e-6: XLA's and
    # torch's sin/cos may differ by about that much.
    x = np.asarray([0, 1, 7, 42, 99], np.float32)
    for dim in (24, 72, 120):
        np.testing.assert_allclose(
            tpos.sinusoidal_pos_emb(_t(x), dim).numpy(),
            np.asarray(jpos.sinusoidal_pos_emb(jnp.asarray(x), dim)), atol=1e-5,
        )


@pytest.mark.parametrize("dim", [24, 72, 120])
def test_rotary_pe_3d_and_apply_match_jax(dim):
    rng = np.random.default_rng(dim)
    xyz = rng.uniform(-1, 1, size=(2, 17, 3)).astype(np.float32)
    x = rng.normal(size=(2, 17, dim)).astype(np.float32)
    code_j = jpos.rotary_pe_3d(jnp.asarray(xyz), dim)
    code_t = tpos.rotary_pe_3d(_t(xyz), dim)
    np.testing.assert_allclose(code_t.numpy(), np.asarray(code_j), atol=2e-6)
    np.testing.assert_allclose(
        tpos.apply_rotary_code(_t(x), code_t).numpy(),
        np.asarray(jpos.apply_rotary_code(jnp.asarray(x), code_j)), atol=1e-5,
    )


def test_rotary_pe_3d_rejects_bad_width():
    with pytest.raises(ValueError, match="divisible by 6"):
        tpos.rotary_pe_3d(torch.zeros(1, 2, 3), 20)


# ---------------------------------------------------------------- rotations


def _rotation_matrices(rng):
    quats = _unit_quats(rng, 64)
    special = np.asarray([
        [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
        [0.5, 0.5, 0.5, 0.5], [0, 0.70710677, 0.70710677, 0],
        [0.70710677, 0, 0, 0.70710677],
    ], np.float32)  # 180-degree turns and exact ties between candidates
    return np.asarray(jrot.quaternion_to_matrix(jnp.asarray(np.concatenate([quats, special]))))


def test_quaternion_matrix_round_trip_matches_jax():
    rng = np.random.default_rng(2)
    q = _unit_quats(rng, 64)
    np.testing.assert_allclose(trot.quaternion_to_matrix(_t(q)).numpy(),
                               np.asarray(jrot.quaternion_to_matrix(jnp.asarray(q))),
                               atol=1e-6)
    m = _rotation_matrices(rng)
    # Same branch (argmax, first index on ties, 0.1 floor) => same sign.
    np.testing.assert_allclose(trot.matrix_to_quaternion(_t(m)).numpy(),
                               np.asarray(jrot.matrix_to_quaternion(jnp.asarray(m))),
                               atol=1e-6)


def test_6d_conversions_match_jax():
    rng = np.random.default_rng(3)
    m = _rotation_matrices(rng)
    d6 = np.asarray(jrot.matrix_to_rotation_6d(jnp.asarray(m)))
    np.testing.assert_array_equal(trot.matrix_to_rotation_6d(_t(m)).numpy(), d6)
    noisy = (d6 + rng.normal(size=d6.shape) * 0.3).astype(np.float32)
    np.testing.assert_allclose(trot.rotation_6d_to_matrix(_t(noisy)).numpy(),
                               np.asarray(jrot.rotation_6d_to_matrix(jnp.asarray(noisy))),
                               atol=2e-6)


def test_quaternion_multiply_invert_match_jax():
    rng = np.random.default_rng(4)
    a, b = _unit_quats(rng, 32), _unit_quats(rng, 32)
    np.testing.assert_allclose(
        trot.quaternion_multiply(trot.quaternion_invert(_t(a)), _t(b)).numpy(),
        np.asarray(jrot.quaternion_multiply(jrot.quaternion_invert(jnp.asarray(a)),
                                            jnp.asarray(b))),
        atol=1e-6,
    )
    np.testing.assert_allclose(trot.normalise_quat(_t(a * 3)).numpy(),
                               np.asarray(jrot.normalise_quat(jnp.asarray(a * 3))), atol=1e-7)


# ---------------------------------------------------------------- normalization


@pytest.mark.parametrize("param,fmt", [("6D", "wxyz"), ("6D", "xyzw"),
                                       ("6D_from_query", "wxyz")])
def test_normalize_unnormalize_trajectory_match_jax(param, fmt):
    rng = np.random.default_rng(5)
    pos = rng.uniform(-0.5, 1.0, size=(3, 4, 2, 3)).astype(np.float32)
    traj = np.concatenate([pos, _unit_quats(rng, 24).reshape(3, 4, 2, 4)], -1)
    ref = jnorm.normalize_trajectory(jnp.asarray(traj), jnp.asarray(BOUNDS), param, fmt)
    out = tnorm.normalize_trajectory(_t(traj), _t(BOUNDS), param, fmt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)

    logits = rng.normal(size=(3, 4, 2, 1)).astype(np.float32)
    noisy = np.concatenate(
        [np.asarray(ref) + rng.normal(size=ref.shape).astype(np.float32) * 0.2, logits], -1
    ).astype(np.float32)
    ref_u = jnorm.unnormalize_trajectory(jnp.asarray(noisy), jnp.asarray(BOUNDS), param, fmt)
    out_u = tnorm.unnormalize_trajectory(_t(noisy), _t(BOUNDS), param, fmt)
    np.testing.assert_allclose(out_u.numpy(), np.asarray(ref_u), atol=2e-6)


def test_normalize_pos_mask_matches_jax():
    rng = np.random.default_rng(6)
    pos = rng.uniform(-1.2, 1.2, size=(2, 50, 3)).astype(np.float32)
    ref, ref_valid = jnorm.normalize_pos(jnp.asarray(pos), jnp.asarray(BOUNDS))
    out, valid = tnorm.normalize_pos(_t(pos), _t(BOUNDS))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert 0 < valid.sum() < valid.numel()


# ---------------------------------------------------------------- FPS


def test_fps_identical_indices_with_ties():
    """Zeroed (invalid) tokens tie at identical distances; both sides pick
    the first index, so the selections are identical."""
    rng = np.random.default_rng(7)
    points = rng.normal(size=(3, 64, 12)).astype(np.float32)
    points[0, 10:40] = 0.0  # a block of identical zero tokens
    points[1, ::3] = 0.0
    points[2] = np.repeat(points[2, :8], 8, axis=0)  # every point duplicated
    ref = np.asarray(jfps.farthest_point_sampling(jnp.asarray(points), 16))
    out = tfps.farthest_point_sampling(_t(points), 16)
    np.testing.assert_array_equal(out.numpy(), ref)
    gathered = tfps.gather_points(_t(points), out)
    np.testing.assert_array_equal(
        gathered.numpy(),
        np.asarray(jfps.gather_points(jnp.asarray(points), jnp.asarray(ref))),
    )


def test_fps_single_sample_and_bounds():
    points = torch.zeros(2, 5, 3)
    np.testing.assert_array_equal(tfps.farthest_point_sampling(points, 1).numpy(), [[0], [0]])
    with pytest.raises(ValueError):
        tfps.farthest_point_sampling(points, 6)


def test_fps_cpu_points_take_the_plain_loop(monkeypatch):
    """CPU points run the eager loop and never reach the kernel or its
    launch counter."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("CPU points reached the CUDA kernel")

    monkeypatch.setattr(tfps, "run_kernel", no_kernel)
    points = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 40, 7)).astype(np.float32))
    before = tfps.farthest_point_sampling.launches
    idx = tfps.farthest_point_sampling(points, 9, start_idx=4)
    ref_idx, ref_dist = tfps.farthest_point_sampling_reference(points, 9, 4)
    np.testing.assert_array_equal(idx.numpy(), ref_idx.numpy())
    assert tfps.farthest_point_sampling.launches == before
    # The plain version's running distances: each point's least squared
    # distance to the first K - 1 picks (the last pick is never folded in).
    picked = points[torch.arange(2)[:, None], ref_idx[:, :-1]]
    expect = ((points[:, :, None] - picked[:, None]) ** 2).sum(-1).min(-1).values
    np.testing.assert_allclose(ref_dist.numpy(), expect.numpy(), rtol=1e-6)


@pytest.mark.parametrize(
    "rows,C,lanes,vec",
    [
        (32 * 3072, 120, 32, False),  # the cells' feature width
        (16, 64, 32, False),
        (15, 63, 32, False),
        (512 * 3, 72, 32, False),  # the fixtures' width
        (3 * 300, 24, 16, False),
        (100, 9, 8, False),
        (100, 3, 2, False),
        (100, 1, 1, False),
        (1000, 127, 32, False),
        (1000, 128, 32, True),  # float4 reads from C = 128 on (dim0 >= 128)
        (1000, 8160, 32, True),
    ],
)
def test_fps_sum_lanes_follow_aten(rows, C, lanes, vec):
    """ATen's CUDA sum over C: lanes per row and float4 reads, from its
    setReduceConfig (Reduce.cuh)."""
    assert tfps.sum_lanes(rows, C) == (lanes, vec)


@pytest.mark.parametrize("rows,C", [(8, 120), (1, 64), (15, 4000), (10**5, 8192)])
def test_fps_sum_lanes_refuse_more_than_a_warp(rows, C):
    with pytest.raises(ValueError, match="one warp"):
        tfps.sum_lanes(rows, C)


def test_fps_launch_params_at_the_cells():
    """A 3072 x 120 row (the benchmark's cells) sits on chip in 8 blocks of
    384 points, one point a thread; the batch does not change the launch.
    The flagship's 4096 x 120 row takes the 9 blocks that hold it; a row too
    large for 16 keeps what fits on chip and streams the rest; a small row
    takes one block."""
    lp = tfps.launch_params(32, 3072, 120, 614)
    assert (lp.lanes, lp.vec, lp.cluster, lp.threads, lp.per_block, lp.resident) == (
        32, False, 8, 384, 384, 384)
    assert lp == tfps.launch_params(1, 3072, 120, 614)
    flagship = tfps.launch_params(1, 4096, 120, 819)
    assert (flagship.cluster, flagship.per_block, flagship.threads) == (9, 456, 480)
    assert flagship.resident == flagship.per_block
    large = tfps.launch_params(2, 30000, 64, 40)
    assert large.cluster == tfps.MAX_CLUSTER and 0 < large.resident < large.per_block
    small = tfps.launch_params(3, 64, 12, 16)
    assert (small.lanes, small.cluster, small.threads, small.resident) == (8, 1, 64, 64)
    # K = 1 sums nothing, so no ATen order constrains it.
    assert tfps.launch_params(1, 8, 120, 1).lanes == 1
    with pytest.raises(ValueError, match="one warp"):
        tfps.launch_params(1, 8, 120, 2)


@pytest.mark.parametrize("N", [1, 31, 439, 3072, 4096, 5000, 30000])
@pytest.mark.parametrize("C", [3, 72, 120, 131, 1024, 2000, 4000])
def test_fps_launch_params_fit_the_card(N, C):
    lp = tfps.launch_params(2, N, C, min(N, 2))
    assert 1 <= lp.cluster <= tfps.MAX_CLUSTER
    assert (lp.cluster - 1) * lp.per_block < N <= lp.cluster * lp.per_block
    assert lp.threads % 32 == 0 and 32 <= lp.threads <= tfps.MAX_THREADS
    assert lp.stride % 2 == 1 and lp.resident <= lp.stride <= lp.resident + 1
    assert lp.resident <= lp.per_block
    assert lp.smem_bytes <= tfps.SMEM_BYTES
    assert lp.smem_bytes == (4 * C * lp.stride + 4 * lp.per_block
                             + 8 * lp.cluster * tfps.sel_floats(lp.lanes, lp.vec, C)
                             + tfps.BEST_BYTES * (tfps.MAX_WARPS + 2 * lp.cluster))
    # A slice that fits keeps all of itself on chip: here, where six blocks
    # hold the row beside their two picks' worth of six candidate vectors.
    if 4 * N * (C + 1) + 6 * 2 * 6 * 4 * C < 6 * tfps.SMEM_BYTES:
        assert lp.resident == lp.per_block


def test_fps_launch_params_wide_rows_stream_over_fewer_blocks():
    """Where 16 blocks' candidate vectors leave no room for a slice's running
    distances (C = 2000), the row goes over the most blocks that do, every
    point read from global memory at each pick."""
    assert tfps._room(12000, 2000, 32, True, tfps.MAX_CLUSTER) < 0
    lp = tfps.launch_params(1, 12000, 2000, 16)
    assert lp.vec and 1 < lp.cluster < tfps.MAX_CLUSTER
    assert tfps._room(12000, 2000, 32, True, lp.cluster) >= 0
    assert tfps._room(12000, 2000, 32, True, lp.cluster + 1) < 0
    assert lp.resident < lp.per_block and lp.smem_bytes <= tfps.SMEM_BYTES
