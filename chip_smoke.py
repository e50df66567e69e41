#!/usr/bin/env python3
"""Drive the torch port's keypose-prediction path on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the package from ``nvblox_mindmap_torch/csrc``
   (one nvcc process per source, started together);
3. holds each flash-attention kernel (``flash_attention_split`` for L <= 8
   queries, ``flash_attention_tile`` above) against their plain torch version
   on the card at every shape the keypose paths give it, on (B, L, H, D)
   transposed views, and with fully masked batch elements and wholly masked
   key chunks; times kernel, plain version, one library call for the same
   function (a yardstick the port never calls) and the least time the card
   could take (``bound_ms``); and times both kernels at L = 1..8 (phase
   ``threshold``: the measurement behind the split kernel's limit);
4. times the RADIO ViT-B/16 backbone's forward (phase ``vit``) at the
   flagship's 2 cameras x 512x512, for batch 1 and 8, beside its bound;
5. runs keypose prediction at full width (embedding 120, 8 heads, seeded
   random weights) through the flash kernels, on two paths: mesh-only
   (2048 vertices x 768-d features) and the flagship ``rgbd_and_mesh`` of
   the JAX package's ``bench.py`` (the same mesh plus 2 cameras at 512x512
   through the RADIO ViT-B/16 geometry: 4096 context tokens). Each path
   runs DDPM-100 at batch 1, DDIM-10 at batch 1 and batch 8. Each run's
   flash calls must be exactly 3 + 10*T: 3 + 2*T through the split kernel
   (encoder and denoiser cross-attention) and 8*T through the tile kernel
   (self-attention). Its trajectory must match the eager attention path on
   the card with the same noise (atol 5e-3); FPS is timed at both context
   sizes;
6. prints one JSON line of per-kernel numbers, then ``{"ok": true, ...}`` as
   the last line.

Any failure raises, and the script exits non-zero without the last line.
It exits non-zero as well when no CUDA device is present or the package is
not beside it.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, TF32
# and bf16 on the tensor cores (dense), HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Full-width configurations of the JAX package's bench.py: mesh-only and the
# flagship rgbd_and_mesh (2 cameras at 512x512 through RADIO ViT-B/16, whose
# 32x32 patch grid gives 1024 image tokens per camera).
EMBEDDING = 120
HEADS = 8
VERTICES = 2048
FEATURE_DIM = 768
FPS_FACTOR = 5
CAMERAS = 2
IMAGE = 512
PATCHES = 32
CONTEXT = {"mesh": VERTICES, "rgbd_and_mesh": VERTICES + CAMERAS * PATCHES * PATCHES}
WORKSPACE = [[-0.37, -0.75, -0.13], [0.95, 0.75, 0.65]]
# Share of the flagship's image patches under a depth hole; the valid share
# of its image tokens must come out within IMAGE_VALID_ATOL of 1 - HOLE_SHARE.
HOLE_SHARE = 0.1
IMAGE_VALID_ATOL = 0.05
TRAJ_ATOL = 5e-3
DENOISE_ATOL = 1e-4  # fp32 eps, kernel vs einsum/softmax summation order
KERNEL_ATOL = 2e-5


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def gpu_time_ms(fn, reps=20, iters=5):
    """Device time of one ``fn()`` call: a CUDA graph of ``reps`` calls,
    replayed ``iters`` times between CUDA events, after a warm-up."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def host_ms(fn):
    """Wall time of one ``fn()`` call that ends in a device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def quartiles(times):
    """(p50, q1, q3) of a list of times."""
    q1, p50, q3 = statistics.quantiles(times, n=4)
    return p50, q1, q3


BACKBONE_RANGE = "feature_extractor_forward"


def profile(fn, wall_ms, backbone=None):
    """Kernel time of one ``fn()`` call from torch.profiler (device events
    only), its share of ``wall_ms`` (the unprofiled p50), and the top kernels.
    With ``backbone`` (a module), the device time of the kernels its forward
    launched, from a profiler range that hooks open and close around it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    fn()
    torch.cuda.synchronize()
    hooks = []
    if backbone is not None:
        ranges = []
        hooks = [
            backbone.register_forward_pre_hook(
                lambda *_: ranges.append(record_function(BACKBONE_RANGE).__enter__())),
            backbone.register_forward_hook(lambda *_: ranges.pop().__exit__(None, None, None)),
        ]
    try:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for hook in hooks:
            hook.remove()
    events = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
               if e.device_type == DeviceType.CUDA and e.key != BACKBONE_RANGE]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    flash = [k for k in kernels if "flash_split_kernel" in k[0] or "flash_tile_kernel" in k[0]]
    out = dict(device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
               device_launches=sum(k[2] for k in kernels),
               flash_kernels_ms=sum(k[1] for k in flash),
               flash_kernels_launches=sum(k[2] for k in flash),
               top=[dict(name=n[:80], ms=ms, count=c) for n, ms, c in kernels[:10]])
    if backbone is not None:
        backbone_ms = sum(e.device_time_total / 1e3 for e in events
                          if e.key == BACKBONE_RANGE and e.device_type == DeviceType.CPU)
        out.update(backbone_device_ms=backbone_ms, backbone_share=backbone_ms / busy_ms)
    return out


def attention_bound(B, H, L, S, D, masked, kernel):
    """(bound_ms, bound_by): the larger of the FLOPs 4*B*H*L*S*D at the peak
    of the units the kernel uses (the split kernel: fp32 FMA; the tile
    kernel: TF32 tensor cores, its 3xTF32 counted as three products) and
    each input read once and the output written once at the HBM rate."""
    flops = 4.0 * B * H * L * S * D
    nbytes = 4.0 * (2 * B * H * L * D + 2 * B * H * S * D) + (B * S if masked else 0)
    if kernel == "flash_attention_tile":
        t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
    else:
        t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def vit_bound(vit, images):
    """(bound_ms, bound_by, flops) of one ViT forward over ``images`` images:
    its matrix products (patch embedding, q/k/v/out and MLP projections,
    attention logits and weighted sums) at the bf16 tensor-core peak, against
    the images read, the fp32 parameters read once and the fp32 features
    written at the HBM rate."""
    width = vit.width
    grid = vit.feature_image_size[0] * vit.feature_image_size[1]
    tokens = grid + vit.num_prefix_tokens
    hidden = vit.mlp1[0].out_features
    per_layer = 2 * tokens * width * (4 * width + 2 * hidden) + 4 * tokens * tokens * width
    patch_in = 3 * vit.patch_size**2
    flops = images * (len(vit.attn) * per_layer + 2 * grid * patch_in * width)
    nbytes = (4 * images * IMAGE * IMAGE * 3 + 4 * sum(p.numel() for p in vit.parameters())
              + 4 * images * grid * width)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return bound + (flops,)


def check_kernels():
    """Phase 3: flash kernels vs plain version at every path shape."""
    import torch
    import torch.nn.functional as F

    from nvblox_mindmap_torch.ops import flash_attention as fa

    # (what, B, H, L, S, D, masked). D=15: full width (E=120, 8 heads):
    # encoder gripper cross-attention (L=3 arm, 6 humanoid) over 2048
    # vertices, denoiser cross-attention (L=1 arm, 2 humanoid) with the
    # context mask, self-attention over 1 + 409 FPS tokens; the flagship's
    # over its 4096 context tokens and 1 + 819 FPS tokens. D=9: the
    # committed fixtures (E=72): 512 vertices, 128 FPS tokens.
    flagship_self = 1 + CONTEXT["rgbd_and_mesh"] // FPS_FACTOR
    shapes = []
    for B in (1, 8):
        shapes += [
            ("flagship_encoder_cross", B, HEADS, 3, CONTEXT["rgbd_and_mesh"], 15, False),
            ("flagship_denoiser_cross", B, HEADS, 1, CONTEXT["rgbd_and_mesh"], 15, True),
            ("flagship_self", B, HEADS, flagship_self, flagship_self, 15, True),
            ("encoder_cross", B, HEADS, 3, VERTICES, 15, False),
            ("encoder_cross_humanoid", B, HEADS, 6, VERTICES, 15, False),
            ("denoiser_cross", B, HEADS, 1, VERTICES, 15, True),
            ("denoiser_cross_humanoid", B, HEADS, 2, VERTICES, 15, True),
            ("self", B, HEADS, 410, 410, 15, True),
            ("fixture_encoder_cross", B, HEADS, 3, 512, 9, False),
            ("fixture_denoiser_cross", B, HEADS, 1, 512, 9, True),
            ("fixture_self", B, HEADS, 129, 129, 9, True),
            ("fixture_self_humanoid", B, HEADS, 130, 130, 9, True),
        ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for what, B, H, L, S, D, masked in shapes:
        q = torch.randn(B, H, L, D, device="cuda", generator=gen) * D**-0.5
        k = torch.randn(B, H, S, D, device="cuda", generator=gen)
        v = torch.randn(B, H, S, D, device="cuda", generator=gen)
        mask = None
        if masked:
            mask = torch.rand(B, S, device="cuda", generator=gen) > 0.2
        kernel = fa.kernel_for(L)
        out = fa.flash_attention(q, k, v, mask)
        ref = fa.flash_attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"{what} B={B}: {kernel} vs plain {err} > {KERNEL_ATOL}")
        sdpa_mask = None if mask is None else mask[:, None, None, :]
        kernel_ms = gpu_time_ms(lambda: fa.flash_attention(q, k, v, mask))
        plain_ms = gpu_time_ms(lambda: fa.flash_attention_reference(q, k, v, mask))
        library_ms = gpu_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask, scale=1.0))
        bound_ms, bound_by = attention_bound(B, H, L, S, D, masked, kernel)
        row = dict(what=what, kernel=kernel, B=B, H=H, L=L, S=S, D=D, masked=masked,
                   max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        results[(what, B)] = row
        phase("kernel_check", **row)

    def held(what, out, ref):
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"{what}: kernel vs plain {err} > {KERNEL_ATOL}")
        return err

    # A batch element with no valid key must come out as exact zeros, on
    # both kernels.
    for L, S in ((410, 410), (1, VERTICES)):
        B, D = 2, 15
        q = torch.randn(B, HEADS, L, D, device="cuda", generator=gen)
        k = torch.randn(B, HEADS, S, D, device="cuda", generator=gen)
        v = torch.randn(B, HEADS, S, D, device="cuda", generator=gen)
        mask = torch.ones(B, S, dtype=torch.bool, device="cuda")
        mask[0] = False
        out = fa.flash_attention(q, k, v, mask)
        err = held("fully masked", out, fa.flash_attention_reference(q, k, v, mask))
        if not bool((out[0] == 0).all()) or not bool((out[1] != 0).any()):
            raise AssertionError(f"L={L}: fully masked batch element is not exactly zero")
        phase("kernel_check_fully_masked", kernel=fa.kernel_for(L), L=L, S=S,
              max_abs_err=err, masked_element_exact_zero=True)
        results[("fully_masked", L)] = dict(kernel=fa.kernel_for(L), max_abs_err=err)

    # Wholly masked key chunks of the split kernel: at S = 2048 the first
    # block's one chunk (keys 0-255); at S = 4096, where each block walks
    # two chunks of 256, block 0's first chunk and block 1's second.
    for S, masked_ranges in ((VERTICES, ((0, 256),)), (CONTEXT["rgbd_and_mesh"],
                                                       ((0, 256), (768, 1024)))):
        B, L, D = 2, 1, 15
        q = torch.randn(B, HEADS, L, D, device="cuda", generator=gen)
        k = torch.randn(B, HEADS, S, D, device="cuda", generator=gen)
        v = torch.randn(B, HEADS, S, D, device="cuda", generator=gen)
        mask = torch.rand(B, S, device="cuda", generator=gen) > 0.2
        for lo, hi in masked_ranges:
            mask[:, lo:hi] = False
        err = held(f"masked split S={S}", fa.flash_attention(q, k, v, mask),
                   fa.flash_attention_reference(q, k, v, mask))
        phase("kernel_check_masked_split", kernel=fa.kernel_for(L), L=L, S=S,
              masked_keys=masked_ranges, max_abs_err=err)
        results[("masked_split", S)] = dict(kernel=fa.kernel_for(L), max_abs_err=err)

    # (B, T, H, D) tensors as .transpose(1, 2) views, as multi_head_attention
    # passes them: no copy in, the output in the caller's layout.
    for what, L, S in (("denoiser_cross", 1, VERTICES), ("encoder_cross", 3, VERTICES),
                       ("self", 410, 410), ("flagship_self", flagship_self, flagship_self)):
        B, D = 2, 15
        q = torch.randn(B, L, HEADS, D, device="cuda", generator=gen) * D**-0.5
        k = torch.randn(B, S, HEADS, D, device="cuda", generator=gen)
        v = torch.randn(B, S, HEADS, D, device="cuda", generator=gen)
        mask = torch.rand(B, S, device="cuda", generator=gen) > 0.2
        views = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        out = fa.flash_attention(*views, mask)
        err = held(f"strided {what}", out, fa.flash_attention_reference(
            *(t.contiguous() for t in views), mask))
        if not out.transpose(1, 2).is_contiguous():
            raise AssertionError(f"strided {what}: output not in the (B, L, H, D) layout")
        phase("kernel_check_strided", what=what, kernel=fa.kernel_for(L), B=B, L=L,
              S=S, D=D, max_abs_err=err, output_in_caller_layout=True)
        results[("strided", what)] = dict(kernel=fa.kernel_for(L), max_abs_err=err)
    return results


def measure_threshold():
    """Both kernels at L = 1..8 queries (B=1, H=8, D=15, masked) over the
    path's key counts: which serves few queries faster."""
    import torch

    from nvblox_mindmap_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    for S in (410, VERTICES):
        for L in (1, 2, 4, 6, 8):
            q = torch.randn(1, HEADS, L, 15, device="cuda", generator=gen) * 15**-0.5
            k = torch.randn(1, HEADS, S, 15, device="cuda", generator=gen)
            v = torch.randn(1, HEADS, S, 15, device="cuda", generator=gen)
            mask = torch.rand(1, S, device="cuda", generator=gen) > 0.2
            ms = {name: gpu_time_ms(lambda name=name: fa.run_kernel(name, q, k, v, mask))
                  for name in fa.KERNELS}
            phase("threshold", L=L, S=S, D=15, **{f"{n}_ms": t for n, t in ms.items()})


def make_batch(B, data_type, seed=0):
    """The bench.py inputs: gripper history, mesh and, for rgbd_and_mesh,
    2 cameras of RGB-D at 512x512. Unlike bench.py's, the points lie inside
    the workspace (bench.py draws z below its floor, so about a fifth of
    the pixels fail the bounds check and the 16x16 AND-pool masks every
    image token); depth holes invalidate ``HOLE_SHARE`` of the 16x16 pixel
    blocks under the patches."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def pose8(shape):
        pos = rng.uniform(-0.3, 0.6, size=shape + (3,))
        quat = rng.normal(size=shape + (4,))
        quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
        close = rng.integers(0, 2, size=shape + (1,)).astype(np.float64)
        return np.concatenate([pos, quat, close], -1).astype(np.float32)

    batch = {
        "gripper_history": pose8((B, 3, 1)),
        "vertices": rng.uniform(-0.3, 0.6, size=(B, VERTICES, 3)).astype(np.float32),
        "vertex_features": rng.normal(size=(B, VERTICES, FEATURE_DIM)).astype(np.float32),
        "vertices_valid_mask": np.ones((B, VERTICES), dtype=bool),
    }
    if data_type == "rgbd_and_mesh":
        shape = (B, CAMERAS, IMAGE, IMAGE)
        lo, hi = np.asarray(WORKSPACE)
        batch["rgbs"] = rng.uniform(0, 1, size=shape + (3,)).astype(np.float32)
        batch["pcds"] = rng.uniform(lo, hi, size=shape + (3,)).astype(np.float32)
        holes = rng.uniform(size=(B, CAMERAS, PATCHES, PATCHES)) < HOLE_SHARE
        block = IMAGE // PATCHES
        batch["pcd_valid_mask"] = ~holes.repeat(block, axis=2).repeat(block, axis=3)
    return batch


def model_config(data_type):
    from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActorConfig

    return DiffuserActorConfig(
        embedding_dim=EMBEDDING, num_attn_heads=HEADS, data_type=data_type,
        feature_type="radio_v25_b" if data_type == "rgbd_and_mesh" else "rgb",
        feature_image_size=(PATCHES, PATCHES), vertex_feature_dim=FEATURE_DIM,
        diffusion_timesteps=100, fps_subsampling_factor=FPS_FACTOR,
    )


def measure_vit():
    """Phase 4: the RADIO ViT-B/16 forward (random weights) over 2 cameras
    at 512x512, batch 1 and 8: device time (CUDA-graph replay), host-clock
    time of an eager call, and the bound."""
    import torch

    from nvblox_mindmap_torch.models.feature_extractors import make_feature_extractor

    torch.manual_seed(0)
    vit = make_feature_extractor("radio_v25_b", (PATCHES, PATCHES)).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for B in (1, 8):
        images = B * CAMERAS
        rgb = torch.rand(images, IMAGE, IMAGE, 3, device="cuda", generator=gen)
        feats = vit(rgb)
        torch.cuda.synchronize()
        if feats.shape != (images, PATCHES, PATCHES, vit.width) or feats.dtype != torch.float32:
            raise AssertionError(f"ViT output {tuple(feats.shape)} {feats.dtype}")
        if not bool(torch.isfinite(feats).all()):
            raise AssertionError("ViT output is not finite")
        device_ms = gpu_time_ms(lambda: vit(rgb), reps=5, iters=3)
        eager_ms, q1, q3 = quartiles([host_ms(lambda: vit(rgb)) for _ in range(10)])
        bound_ms, bound_by, flops = vit_bound(vit, images)
        phase("vit", B=B, images=images, tokens=PATCHES * PATCHES + vit.num_prefix_tokens,
              device_ms=device_ms, host_p50_ms=eager_ms, host_q1_ms=q1, host_q3_ms=q3,
              flops=flops, bound_ms=bound_ms, bound_by=bound_by,
              bound_share=bound_ms / device_ms, tflops_per_s=flops / device_ms / 1e9)


def run_slice(data_type, reps):
    """Phase 5: full-width keypose prediction through the kernels, on the
    mesh-only or the flagship path; ``reps`` is (DDPM-100, DDIM-10) host-clock
    repetitions per attention impl. Returns each kernel's launches."""
    import numpy as np
    import torch

    from nvblox_mindmap_torch.models.converter import (
        apply_inference_settings,
        convert_diffusion_scheduler,
        convert_to_flash_attention,
    )
    from nvblox_mindmap_torch.models.diffuser_actor import (
        DiffuserActor,
        prepare_inputs,
        sample_trajectory,
    )
    from nvblox_mindmap_torch.ops import flash_attention as fa
    from nvblox_mindmap_torch.ops.attention import set_default_attention_impl
    from nvblox_mindmap_torch.ops.fps import farthest_point_sampling

    cfg = model_config(data_type)
    torch.manual_seed(0)
    model = DiffuserActor(cfg, device="cuda")
    backbone = getattr(model.encoder, "feature_extractor", None)
    bounds = np.asarray(WORKSPACE, dtype=np.float32)
    ddpm_reps, ddim_reps = reps
    runs = [
        ("ddpm100_b1", 1, dict(num_inference_steps=100, scheduler_kind="ddpm",
                               stochastic=True), ddpm_reps),
        ("ddim10_b1", 1, convert_diffusion_scheduler(10), ddim_reps),
        ("ddim10_b8", 8, convert_diffusion_scheduler(10), ddim_reps),
    ]
    launches_total = dict.fromkeys(fa.KERNELS, 0)
    results = {}
    for name, B, sampler, reps in runs:
        prepared = prepare_inputs(make_batch(B, data_type), bounds, cfg, device="cuda")
        T = sampler["num_inference_steps"]
        gen = torch.Generator(device="cuda").manual_seed(1)
        init_noise = torch.randn((B, 1, 1, 9), generator=gen, device="cuda")
        step_noise = torch.randn((T, B, 1, 1, 9), generator=gen, device="cuda")

        def predict():
            return sample_trajectory(model, prepared, bounds, init_noise=init_noise,
                                     step_noise=step_noise, **sampler)

        # One denoiser pass, eager vs flash attention, on the same inputs.
        set_default_attention_impl("eager")
        with torch.no_grad():
            fixed = model.encode_prepared(prepared)
            shape = (fixed["context_feats"].shape[1], fixed["fps_feats"].shape[1])
            if shape != (CONTEXT[data_type], CONTEXT[data_type] // FPS_FACTOR):
                raise AssertionError(f"{name}: context and FPS tokens {shape}")
            image_valid_share = None
            if data_type == "rgbd_and_mesh":
                image_tokens = fixed["context_mask"][:, :CAMERAS * PATCHES * PATCHES]
                image_valid_share = image_tokens.float().mean().item()
                if not abs(image_valid_share - (1 - HOLE_SHARE)) <= IMAGE_VALID_ATOL:
                    raise AssertionError(f"{name}: {image_valid_share} of the image tokens "
                                         f"valid, expected {1 - HOLE_SHARE}")
            t_first = torch.full((B,), 99.0, device="cuda")
            eps_eager = model.denoise(init_noise, t_first, fixed)[0]
            set_default_attention_impl("flash")
            eps_flash = model.denoise(init_noise, t_first, fixed)[0]
        eps_err = (eps_flash - eps_eager).abs().max().item()
        if not eps_err <= DENOISE_ATOL:
            raise AssertionError(f"{name}: flash vs eager denoiser {eps_err} > {DENOISE_ATOL}")

        set_default_attention_impl("eager")
        traj_eager, _, weights_eager = predict()
        if weights_eager is None:
            raise AssertionError("eager path returned no attention weights")

        rest = apply_inference_settings(convert_to_flash_attention())
        if rest:
            raise AssertionError(f"unexpected sampler settings {rest}")
        fa.flash_attention.launches = 0
        fa.KERNEL_LAUNCHES.update(dict.fromkeys(fa.KERNELS, 0))
        traj, head_yaw, weights = predict()
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches
        by_kernel = dict(fa.KERNEL_LAUNCHES)
        expected = {"flash_attention_split": 3 + 2 * T, "flash_attention_tile": 8 * T}
        if launches != 3 + 10 * T or by_kernel != expected:
            raise AssertionError(f"{name}: {launches} flash calls {by_kernel}, expected "
                                 f"{3 + 10 * T} {expected}")
        for kernel, n in by_kernel.items():
            launches_total[kernel] += n
        if weights is not None:
            raise AssertionError("flash path materialized attention weights")
        if traj.shape != (B, 1, 1, 8) or not bool(torch.isfinite(traj).all()):
            raise AssertionError(f"{name}: bad trajectory {traj.shape}")
        quat_norm = traj[..., 3:7].norm(dim=-1)
        if not bool(((quat_norm - 1).abs() < 1e-4).all()):
            raise AssertionError(f"{name}: quaternions are not unit")
        if not bool(((traj[..., 7] >= 0) & (traj[..., 7] <= 1)).all()):
            raise AssertionError(f"{name}: openness outside [0, 1]")
        err = (traj - traj_eager).abs().max().item()
        if not err <= TRAJ_ATOL:
            raise AssertionError(f"{name}: flash vs eager trajectory {err} > {TRAJ_ATOL}")

        # Host clock around whole predictions, flash and eager attention in
        # turns (the order alternating), so both see the same host noise.
        times = {"flash": [], "eager": []}
        for i in range(reps):
            for impl in (("flash", "eager") if i % 2 == 0 else ("eager", "flash")):
                set_default_attention_impl(impl)
                times[impl].append(host_ms(predict))
        set_default_attention_impl("flash")
        p50_flash, q1_flash, q3_flash = quartiles(times["flash"])
        p50_eager, q1_eager, q3_eager = quartiles(times["eager"])
        results[name] = dict(B=B, steps=T, context_tokens=fixed["context_feats"].shape[1],
                             self_attention_tokens=1 + fixed["fps_feats"].shape[1],
                             image_valid_share=image_valid_share,
                             launches=launches, launches_by_kernel=by_kernel,
                             denoiser_max_abs_err_vs_eager=eps_err,
                             max_abs_err_vs_eager=err, reps=reps,
                             p50_ms=p50_flash, q1_ms=q1_flash, q3_ms=q3_flash,
                             p50_ms_eager_attention=p50_eager,
                             q1_ms_eager_attention=q1_eager,
                             q3_ms_eager_attention=q3_eager)
        if name == "ddim10_b1":
            results[name]["profile"] = profile(predict, p50_flash, backbone)
        phase("slice", path=data_type, run=name, **results[name])

    # Feature-space FPS at the path's context size: N // 5 samples.
    N = CONTEXT[data_type]
    for B in (1, 8):
        feats = torch.randn(B, N, EMBEDDING, device="cuda")
        k = N // FPS_FACTOR
        fps_ms, q1, q3 = quartiles([host_ms(lambda: farthest_point_sampling(feats, k))
                                    for _ in range(10)])
        phase("fps", path=data_type, B=B, N=N, C=EMBEDDING, samples=k, p50_ms=fps_ms,
              q1_ms=q1, q3_ms=q3)
    set_default_attention_impl("eager")
    return launches_total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "nvblox_mindmap_torch")):
        print("chip_smoke: run it from the repository root", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from nvblox_mindmap_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    phase("build", seconds=time.perf_counter() - t0, kernels=sorted(built),
          ptxas=[line.strip() for out in built.values() for line in out.splitlines()
                 if "registers" in line])

    checks = check_kernels()
    measure_threshold()
    measure_vit()
    launches = {}
    for data_type, reps in (("mesh", (6, 30)), ("rgbd_and_mesh", (8, 40))):
        path_launches = run_slice(data_type, reps)
        for kernel, n in path_launches.items():
            launches[kernel] = launches.get(kernel, 0) + n

    # Each kernel at the flagship shape it serves most; beside it, its time
    # at the mesh path's shape, which the line reported before the flagship
    # was ported.
    main_shapes = {
        "flash_attention_split": (("flagship_denoiser_cross", 1),
                                  "flagship denoiser cross-attention B=1 H=8 L=1 S=4096 "
                                  "D=15 masked", ("denoiser_cross", 1),
                                  "mesh denoiser cross-attention B=1 H=8 L=1 S=2048 D=15 "
                                  "masked"),
        "flash_attention_tile": (("flagship_self", 1),
                                 "flagship self-attention B=1 H=8 L=S=820 D=15 masked",
                                 ("self", 1),
                                 "mesh self-attention B=1 H=8 L=S=410 D=15 masked"),
    }
    entries = []
    for kernel, (key, shape, mesh_key, mesh_shape) in main_shapes.items():
        row = checks[key]
        entries.append({
            "name": kernel,
            "route": "cuda",
            "source": f"nvblox_mindmap_torch/csrc/{kernel}.cu",
            "replaces": "nvblox_mindmap_tpu/ops/flash_attention.py:43",
            "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in checks.values()
                               if r["kernel"] == kernel),
            "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": shape,
            "mesh_path_ms": checks[mesh_key]["kernel_ms"],
            "mesh_path_shape": mesh_shape,
        })
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
