#!/usr/bin/env python3
"""Kernel-alone measurements of the torch port on one NVIDIA GPU: the tables
of PERF.md §6.

Correctness of the port's paths and apps on the card is held by the card
tests (``tests/test_torch_cuda.py``, ``tests/test_torch_cuda_apps.py``);
end-to-end times by the benchmark (``portbench/``). This script times the
hand-written kernels and the few modules whose device time §6 reports, each
on its own, after holding it to its plain version; then it runs the
program's main paths once, untimed, to count their launches and hold every
shape they give the kernels.

Run from the root of the repository: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the package from ``nvblox_mindmap_torch/csrc``
   (phase ``build``: one nvcc process per source, started together);
3. holds each flash-attention kernel (``flash_attention_split`` for L <= 8
   queries, ``flash_attention_tile`` above) against its plain torch version
   at every shape the keypose paths give it, and times kernel, plain version,
   one library call for the same function (a yardstick the port never calls)
   and the least time the card could take (``bound_ms``), at head dims 9, 15,
   64, 128, 144, 192 and 256, for bf16 inputs, at the language layers'
   shapes over a 53-token instruction and at the goal-gripper query (phase
   ``kernel_check``); fully masked batch elements come out as exact zeros,
   wholly masked key chunks and (B, L, H, D) transposed views match the plain
   version (phases ``kernel_check_fully_masked``, ``kernel_check_masked_split``,
   ``kernel_check_strided``);
4. holds the FPS kernel (``csrc/fps.cu``) to the eager loop, picks and running
   distances bit for bit, one launch a call, and times both beside the
   kernel's bound at the cells', the flagship's and the fixtures' shapes
   (phase ``fps_kernel``);
5. holds the pool update (``csrc/integrate_pool.cu``) to its plain version,
   pool and weights bit for bit, one launch a call, and times both beside
   the kernel's byte bound for the 768-d and 120-d feature pools and the
   color pool at 512x512 over a map of 395 live pages (phase
   ``integrate_pool_kernel``);
6. times both flash kernels at L = 1..8 (phase ``threshold``: the measurement
   behind the split kernel's limit);
7. times the RADIO ViT-B/16 backbone's forward at 2 cameras x 512x512, batch
   1 and 8, beside its bound (phase ``vit``);
8. times ``sample_trajectory`` at the goal cells' shapes (B = 1, 3072 keys,
   DDIM-10), the eager denoiser loop against its CUDA graph replay, bit for
   bit and launch for launch (phase ``sampler_graph``);
9. holds the CLIP ResNet-50 FPN extractor (a seeded random trunk converted
   by the port's converter, with an FPN) on the card against the CPU, times
   it at B = 2 and 32 beside its FLOP bound (IEEE fp32, and with TF32
   allowed), and checks that one backward pass reaches only the FPN levels
   that res3 reads (phase ``clip_extractor``);
10. runs the main paths at full width on random inputs, untimed, each with
    the launch counters set to 0 at its start: ``sample_trajectory``
    (DDIM-10, B = 1 and 8) on the mesh and the rgbd_and_mesh models against
    eager attention, two closed-loop policy steps and one goal over 2
    cameras, one train step and one eval batch at the train batch; each
    path's flash, FPS and pool-update launches are held to their expected
    counts, and every flash shape they launched that phase ``kernel_check``
    did not hold is held and timed now (phase ``main_paths``);
11. prints one JSON line of per-kernel numbers, ``{"kernels": [...]}``, whose
    ``launches`` are the main paths' launches of each kernel (in all and by
    path), then ``{"ok": true, ...}`` as the last line.

Any failure raises, and the script exits non-zero without the last line.
It exits non-zero as well when no CUDA device is present or the package is
not beside it: a copy of the script on its own refuses to run.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, TF32
# and bf16 on the tensor cores (dense), HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Full-width shapes: embedding 120 over 8 heads (D = 15), 2048 mesh
# vertices of 768-d features, FPS to a fifth; the flagship's 2 cameras at
# 512x512 through RADIO ViT-B/16, whose 32x32 patch grid gives 1024 image
# tokens per camera.
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
TRAIN_BATCH = 32
# The one-camera flagship of the apps and the benchmark's cells: 1024 image
# tokens + 2048 vertices, 1 + 614 tokens in self-attention.
APP_CONTEXT = VERTICES + PATCHES * PATCHES
APP_SELF = 1 + APP_CONTEXT // FPS_FACTOR
KERNEL_ATOL = 2e-5
WIDE_HEAD_DIMS = (144, 192, 256)
# The spatial-memory rgbd model: one 64x64 camera through 16x16 RGB tokens,
# FPS factor 4.
SM_RGBD_CONTEXT = 16 * 16
SM_RGBD_SELF = 1 + SM_RGBD_CONTEXT // 4
INSTRUCTION_TOKENS = 53  # 3D Diffuser Actor's padded CLIP-text length


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


def attention_bound(B, H, L, S, D, masked, kernel, elem_bytes=4):
    """(bound_ms, bound_by): the larger of the FLOPs 4*B*H*L*S*D at the peak
    of the units the kernel uses (the split kernel: fp32 FMA; the tile
    kernel: TF32 tensor cores, its 3xTF32 counted as three products) and
    each input read once and the output written once at the HBM rate
    (``elem_bytes`` per element of q, k, v and the output)."""
    flops = 4.0 * B * H * L * S * D
    nbytes = elem_bytes * (2 * B * H * L * D + 2 * B * H * S * D) + (B * S if masked else 0)
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


def kernel_row(what, B, H, L, S, D, masked, gen):
    """One ``kernel_check`` row: the kernel that serves L queries against its
    plain version on random inputs of this shape (a random key mask when
    ``masked``; bf16 when ``what`` ends in ``_bf16``), then the kernel, the
    plain version and SDPA timed beside the bound."""
    import torch
    import torch.nn.functional as F

    from nvblox_mindmap_torch.ops import flash_attention as fa

    dtype = torch.bfloat16 if what.endswith("_bf16") else torch.float32
    q = (torch.randn(B, H, L, D, device="cuda", generator=gen) * D**-0.5).to(dtype)
    k = torch.randn(B, H, S, D, device="cuda", generator=gen).to(dtype)
    v = torch.randn(B, H, S, D, device="cuda", generator=gen).to(dtype)
    mask = None
    if masked:
        mask = torch.rand(B, S, device="cuda", generator=gen) > 0.2
    kernel = fa.kernel_for(L)
    out = fa.flash_attention(q, k, v, mask)
    ref = fa.flash_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    if out.dtype != dtype:
        raise AssertionError(f"{what}: output {out.dtype}, expected {dtype}")
    err = (out.float() - ref.float()).abs().max().item()
    # 16-bit outputs: the fp32 results, each rounded once to the dtype.
    atol = KERNEL_ATOL + torch.finfo(dtype).eps * ref.float().abs().max().item() * (
        dtype != torch.float32)
    if not err <= atol:
        raise AssertionError(f"{what} B={B}: {kernel} vs plain {err} > {atol}")
    sdpa_mask = None if mask is None else mask[:, None, None, :]
    kernel_ms = gpu_time_ms(lambda: fa.flash_attention(q, k, v, mask))
    plain_ms = gpu_time_ms(lambda: fa.flash_attention_reference(q, k, v, mask))
    library_ms = gpu_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=sdpa_mask, scale=1.0))
    bound_ms, bound_by = attention_bound(B, H, L, S, D, masked, kernel,
                                         elem_bytes=q.element_size())
    row = dict(what=what, kernel=kernel, B=B, H=H, L=L, S=S, D=D, masked=masked,
               dtype=str(dtype).split(".")[-1], max_abs_err=err, atol=atol,
               kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    phase("kernel_check", **row)
    return row


def check_kernels():
    """Phase ``kernel_check``: flash kernels vs plain version at every path shape."""
    import torch

    from nvblox_mindmap_torch.ops import flash_attention as fa

    # (what, B, H, L, S, D, masked). D=15: full width (E=120, 8 heads):
    # encoder gripper cross-attention (L=3 arm, 6 humanoid) over 2048
    # vertices, denoiser cross-attention (L=1 arm, 2 humanoid) with the
    # context mask, self-attention over 1 + 409 FPS tokens; the flagship's
    # over its 4096 context tokens and 1 + 819 FPS tokens, and its goal-gripper
    # query (L=1, no mask; encode_goal_gripper). D=9: the committed fixtures
    # (E=72): 512 vertices, 128 FPS tokens.
    flagship_self = 1 + CONTEXT["rgbd_and_mesh"] // FPS_FACTOR
    # The flagship's shapes at the train batch, which every eval batch runs.
    shapes = [
        ("flagship_encoder_cross", TRAIN_BATCH, HEADS, 3, CONTEXT["rgbd_and_mesh"], 15, False),
        ("flagship_denoiser_cross", TRAIN_BATCH, HEADS, 1, CONTEXT["rgbd_and_mesh"], 15, True),
        ("flagship_self", TRAIN_BATCH, HEADS, flagship_self, flagship_self, 15, True),
    ]
    # The training app's one-camera flagship (3072 context tokens, 1 + 614
    # in self-attention), at an eval batch and at one prediction.
    for B in (1, TRAIN_BATCH):
        shapes += [
            ("app_encoder_cross", B, HEADS, 3, APP_CONTEXT, 15, False),
            ("app_denoiser_cross", B, HEADS, 1, APP_CONTEXT, 15, True),
            ("app_self", B, HEADS, APP_SELF, APP_SELF, 15, True),
        ]
    # Head dims 64 and 128, fp32; and 16-bit inputs at the ViT's attention
    # shape (1025 tokens, 12 heads of 64).
    shapes += [
        ("d64_cross", 8, HEADS, 3, VERTICES, 64, False),
        ("d64_self", 8, HEADS, 410, 410, 64, True),
        ("d128_cross", 8, HEADS, 1, VERTICES, 128, True),
        ("d128_self", 8, HEADS, 410, 410, 128, True),
        ("vit_self_bf16", 2, 12, 1025, 1025, 64, False),
    ]
    # Head dims above 128 (chunks of 128 over blockIdx.z), both kernels,
    # masked and unmasked.
    for D in WIDE_HEAD_DIMS:
        shapes += [
            (f"d{D}_cross", 8, HEADS, 3, VERTICES, D, False),
            (f"d{D}_cross_masked", 8, HEADS, 1, VERTICES, D, True),
            (f"d{D}_self", 8, HEADS, 410, 410, D, False),
            (f"d{D}_self_masked", 8, HEADS, 410, 410, D, True),
        ]
    for B in (1, 8):
        shapes += [
            ("flagship_encoder_cross", B, HEADS, 3, CONTEXT["rgbd_and_mesh"], 15, False),
            ("flagship_denoiser_cross", B, HEADS, 1, CONTEXT["rgbd_and_mesh"], 15, True),
            ("flagship_self", B, HEADS, flagship_self, flagship_self, 15, True),
            ("flagship_goal_cross", B, HEADS, 1, CONTEXT["rgbd_and_mesh"], 15, False),
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
    # The committed fixtures' humanoid cross-attention (2 grippers: L = 6
    # history queries, 2 denoiser queries over 512 vertices), one goal of
    # the task-success experiment; the arm fixtures' shapes at B = 3, the
    # spatial-memory experiment's three seeds per keypose; and its
    # rgbd model (one 64x64 camera, 16x16 RGB tokens, 1 + 64 FPS tokens) at
    # B = 1 and 3.
    shapes += [
        ("fixture_encoder_cross_humanoid", 1, HEADS, 6, 512, 9, False),
        ("fixture_denoiser_cross_humanoid", 1, HEADS, 2, 512, 9, True),
        ("fixture_encoder_cross", 3, HEADS, 3, 512, 9, False),
        ("fixture_denoiser_cross", 3, HEADS, 1, 512, 9, True),
        ("fixture_self", 3, HEADS, 129, 129, 9, True),
    ]
    for B in (1, 3):
        shapes += [
            ("rgbd_encoder_cross", B, HEADS, 3, SM_RGBD_CONTEXT, 9, False),
            ("rgbd_denoiser_cross", B, HEADS, 1, SM_RGBD_CONTEXT, 9, True),
            ("rgbd_self", B, HEADS, SM_RGBD_SELF, SM_RGBD_SELF, 9, True),
        ]
    # The language layers over a 53-token instruction: the
    # flagship's 4096 context tokens cross-attending to it (vl_attention),
    # the trajectory query (traj_lang_attention) and the 820 self-attention
    # tokens (the interleaved cross layers); unmasked as the model runs
    # them, and masked; at B = 1 and 8.
    for B in (1, 8):
        for suffix, masked in (("", False), ("_masked", True)):
            shapes += [
                (f"language_vl_cross{suffix}", B, HEADS, CONTEXT["rgbd_and_mesh"],
                 INSTRUCTION_TOKENS, 15, masked),
                (f"language_traj_cross{suffix}", B, HEADS, 1, INSTRUCTION_TOKENS, 15, masked),
                (f"language_self_cross{suffix}", B, HEADS, flagship_self, INSTRUCTION_TOKENS,
                 15, masked),
            ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for what, B, H, L, S, D, masked in shapes:
        results[(what, B)] = kernel_row(what, B, H, L, S, D, masked, gen)

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



def measure_vit():
    """Phase ``vit``: the RADIO ViT-B/16 forward (random weights) over 2 cameras
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



# Feature-space FPS (csrc/fps.cu) at the shapes the paths give it: the
# benchmark cells' 3072 x 120 rows at B = 1 (goals, loops) and B = 32
# (training), the flagship's 4096 tokens, the trained fixtures' width 72.
FPS_SHAPES = (("cells_goal", 1, 3072, 120, 614), ("cells_train", 32, 3072, 120, 614),
              ("flagship", 1, 4096, 120, 819), ("fixture", 1, 512, 72, 128))


def fps_bound(B, N, C, K):
    """(bound_ms, bound_by): the larger of the K - 1 picks' 3*B*N*C fp32
    operations each (difference, square, sum) at the fp32 peak and the
    points read once and the picks written once at the HBM rate."""
    t_ops = (K - 1) * 3.0 * B * N * C / PEAK_FP32_FLOPS * 1e3
    t_bytes = (4.0 * B * N * C + 8.0 * B * K) / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def event_ms(fn, reps):
    """Device time of one ``fn()`` call between CUDA events, over ``reps``
    calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_fps_kernel():
    """Phase ``fps_kernel``: at each of ``FPS_SHAPES`` the kernel's picks and
    running distances equal the eager loop's on the card, one launch a call;
    its time beside its bound and the eager loop's. Returns the rows."""
    import torch

    from nvblox_mindmap_torch.ops import fps

    gen = torch.Generator(device="cuda").manual_seed(20)
    rows = {}
    for name, B, N, C, K in FPS_SHAPES:
        points = torch.randn(B, N, C, device="cuda", generator=gen)
        keep = torch.rand(B, N, device="cuda", generator=gen) < 0.9  # zeroed tokens tie
        points = torch.where(keep[..., None], points, 0.0)
        ref_idx, ref_dist = fps.farthest_point_sampling_reference(points, K)
        before = fps.farthest_point_sampling.launches
        idx = fps.farthest_point_sampling(points, K)
        launches = fps.farthest_point_sampling.launches - before
        dist = fps.run_kernel(points, K)[1]
        if not (torch.equal(idx, ref_idx) and torch.equal(dist, ref_dist)) or launches != 1:
            raise AssertionError(f"fps_kernel {name}: {int((idx != ref_idx).sum())} picks "
                                 f"differ from eager, {launches} launches")
        kernel_ms = event_ms(lambda: fps.farthest_point_sampling(points, K), 20)
        plain_ms = event_ms(lambda: fps.farthest_point_sampling_reference(points, K), 3)
        bound_ms, bound_by = fps_bound(B, N, C, K)
        lp = fps.launch_params(B, N, C, K)
        rows[name] = dict(B=B, N=N, C=C, K=K, picks_equal=True, distances_equal=True,
                          launches_per_call=launches, kernel_ms=kernel_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / kernel_ms,
                          speedup=plain_ms / kernel_ms, cluster=lp.cluster,
                          threads=lp.threads, per_block=lp.per_block, resident=lp.resident)
        phase("fps_kernel", shape=name, **rows[name])
    return rows


# The pool update at the cells' widths: RADIO's 768-d and CLIP's 120-d
# feature pools from a 512x512 fp16 feature image, and the 3-channel color
# pool from a 512x512 fp32 RGB image, over cube_stacking's map (1 cm voxels,
# 1024 pages) of a table and a wall seen by a camera tilted down at it.
POOL_SHAPES = (("radio_features", 768, "float16"), ("clip_features", 120, "float16"),
               ("color", 3, "float32"))
POOL_EYES = ((-0.3, 0.0, 0.45), (-0.28, 0.03, 0.46), (-0.26, 0.06, 0.47))


def look_at(eye, target):
    """(4, 4) camera-to-world pose at ``eye`` looking at ``target``, +y down."""
    import numpy as np

    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    z = (target - eye) / np.linalg.norm(target - eye)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, np.cross(z, x), z, eye
    return T


def planes_depth(T, K, planes):
    """(IMAGE, IMAGE) z-depth of the nearest of ``planes`` ((n, d): n . p = d)."""
    import numpy as np

    v, u = np.mgrid[0:IMAGE, 0:IMAGE].astype(np.float64)
    rays = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u)], -1)
    rays = rays @ T[:3, :3].T
    depth = np.full((IMAGE, IMAGE), np.inf)
    for n, d in planes:
        n = np.asarray(n, np.float64)
        along = rays @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (d - T[:3, 3] @ n) / along
        depth = np.minimum(depth, np.where(t > 0, t, np.inf))
    return np.where(np.isfinite(depth), depth, 0.0).astype(np.float32)


def pool_scene(C, image_dtype, gen):
    """A map after two frames of the table scene (TSDF, pages and pool weights
    through the plain version), and the third frame: (config, pool,
    pool_weight, the update's other arguments)."""
    import torch

    from nvblox_mindmap_torch.mapping import voxel_grid as vg
    from nvblox_mindmap_torch.mapping.constants import MappingConfig, Tasks
    from nvblox_mindmap_torch.ops.masks import get_border_mask

    cfg = MappingConfig.for_task(Tasks.CUBE_STACKING, feature_dim=C)
    K = torch.tensor([[400.0, 0, IMAGE / 2], [0, 400.0, IMAGE / 2], [0, 0, 1]], device="cuda")
    mask = get_border_mask((IMAGE, IMAGE), cfg.feature_mask_border_percent, device="cuda")
    state = vg.create_state(cfg, "cuda")
    dtype = getattr(torch, image_dtype)
    for i, eye in enumerate(POOL_EYES):
        T_np = look_at(eye, (0.45, 0.0, 0.0))
        depth = planes_depth(T_np, K.cpu().numpy(), [((0, 0, 1), 0.0), ((-1, 0, 0), -0.9)])
        T = torch.as_tensor(T_np, dtype=torch.float32, device="cuda")
        state = vg.decay(state, cfg)
        state = vg.integrate_depth(state, cfg, torch.as_tensor(depth, device="cuda"), T, K)
        state = vg.allocate_pages(state, cfg)
        image = torch.rand(IMAGE, IMAGE, C, device="cuda", generator=gen).to(dtype)
        args = (state.page_to_block, state.tsdf, state.weight, image, T, K, mask, cfg, 1.0)
        if i < len(POOL_EYES) - 1:
            feat, feat_weight = vg._integrate_pool_reference(
                torch.rand(state.feat.shape[:2] + (C,), device="cuda", generator=gen).half()
                if i == 0 else state.feat, state.feat_weight, *args)
            state.feat, state.feat_weight = feat, feat_weight
    return cfg, state.feat, state.feat_weight, args


def check_pool_kernel():
    """Phase ``integrate_pool_kernel``: at each of ``POOL_SHAPES`` the kernel's
    pool and weights equal the plain version's on the card to the bit, one
    launch a call; its time beside its bound and the plain version's.
    Returns the rows."""
    import torch

    from nvblox_mindmap_torch.mapping import voxel_grid as vg
    from nvblox_mindmap_torch.ops import integrate_pool as ip

    gen = torch.Generator(device="cuda").manual_seed(25)
    rows = {}
    for name, C, image_dtype in POOL_SHAPES:
        cfg, pool, pool_weight, args = pool_scene(C, image_dtype, gen)
        ref_pool, ref_weight = vg._integrate_pool_reference(pool, pool_weight, *args)
        out_pool, out_weight = pool.clone(), pool_weight.clone()
        before = ip.integrate_pool.launches
        vg._integrate_pool(out_pool, out_weight, *args)
        launches = ip.integrate_pool.launches - before
        torch.cuda.synchronize()
        equal = (torch.equal(out_pool.view(torch.int16), ref_pool.view(torch.int16))
                 and torch.equal(out_weight.view(torch.int32), ref_weight.view(torch.int32)))
        if not equal or launches != 1:
            raise AssertionError(
                f"integrate_pool_kernel {name}: "
                f"{int((out_pool.view(torch.int16) != ref_pool.view(torch.int16)).sum())} pool "
                f"and {int((out_weight != ref_weight).sum())} weight entries differ, "
                f"{launches} launches")
        live = args[0] >= 0
        measured = int((ref_weight > pool_weight).sum())
        rewritten = int(((ref_weight > 0) & live[:, None]).sum())
        live_voxels = int(live.sum()) * pool.shape[1]
        kernel_ms = gpu_time_ms(lambda: vg._integrate_pool(out_pool, out_weight, *args))
        plain_ms = event_ms(lambda: vg._integrate_pool_reference(pool, pool_weight, *args), 5)
        # The bytes the update needs: each measured voxel's pool row read and
        # written and its image row read; each live voxel's TSDF and weight
        # read and its pool weight read and written; the page table.
        image_bytes = args[3].element_size()
        needed = (measured * C * (2 + 2 + image_bytes) + 16 * live_voxels
                  + 4 * args[0].numel())
        bound_ms = needed / PEAK_BYTES_PER_S * 1e3
        lp = ip.launch_params(out_pool, out_weight, *args[:7], cfg.block_size)
        rows[name] = dict(C=C, image=image_dtype, pages=int(live.numel()),
                          live_pages=int(live.sum()), measured_voxels=measured,
                          rewritten_rows=rewritten, bits_equal=True, launches_per_call=launches,
                          kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by="bytes", share=bound_ms / kernel_ms,
                          speedup=plain_ms / kernel_ms, lanes=lp.lanes)
        phase("integrate_pool_kernel", shape=name, **rows[name])
        del pool, pool_weight, ref_pool, ref_weight, out_pool, out_weight, args
        torch.cuda.empty_cache()
    return rows


GOAL_KEYS = APP_CONTEXT  # the goal cells' context
SAMPLER_GRAPH_REPS = 20


def model_config(data_type):
    """The flagship model at full width: mesh-only, or with 2 cameras through
    the RADIO ViT-B/16."""
    from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActorConfig

    return DiffuserActorConfig(
        embedding_dim=EMBEDDING, num_attn_heads=HEADS, data_type=data_type,
        feature_type="radio_v25_b" if data_type == "rgbd_and_mesh" else "rgb",
        feature_image_size=(PATCHES, PATCHES), vertex_feature_dim=FEATURE_DIM,
        diffusion_timesteps=100, fps_subsampling_factor=FPS_FACTOR)


def make_batch(B, data_type, vertices=VERTICES, seed=0):
    """Random inputs inside the workspace: gripper history, a ground-truth
    keypose, ``vertices`` 768-d mesh vertices and, for rgbd_and_mesh, 2
    cameras of RGB-D at 512x512 with depth holes under a tenth of the 16x16
    pixel blocks."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def poses(n):
        quat = rng.normal(size=(B, n, 1, 4))
        quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
        return np.concatenate([rng.uniform(-0.3, 0.6, (B, n, 1, 3)), quat,
                               rng.integers(0, 2, (B, n, 1, 1))], -1).astype(np.float32)

    batch = {"gripper_history": poses(3), "gt_gripper_pred": poses(1),
             "vertices": rng.uniform(-0.3, 0.6, (B, vertices, 3)).astype(np.float32),
             "vertex_features": rng.normal(size=(B, vertices, FEATURE_DIM)).astype(np.float32),
             "vertices_valid_mask": np.ones((B, vertices), dtype=bool)}
    if data_type == "rgbd_and_mesh":
        shape = (B, CAMERAS, IMAGE, IMAGE)
        batch["rgbs"] = rng.uniform(0, 1, shape + (3,)).astype(np.float32)
        batch["pcds"] = rng.uniform(*WORKSPACE, shape + (3,)).astype(np.float32)
        holes = rng.uniform(size=(B, CAMERAS, PATCHES, PATCHES)) < 0.1
        block = IMAGE // PATCHES
        batch["pcd_valid_mask"] = ~holes.repeat(block, axis=2).repeat(block, axis=3)
    return batch


def measure_sampler_graph(reps=SAMPLER_GRAPH_REPS):
    """Phase ``sampler_graph``: ``sample_trajectory`` at the goal cells'
    denoiser shapes (B = 1, 3072 context keys, FPS to 614, DDIM-10, flash
    attention; a mesh model over 3072 768-d vertices gives the denoiser the
    same shapes as the cells' rgbd_and_mesh model), the eager loop against
    its CUDA graph replay in turns: host ms of whole calls (each ending in a
    synchronize), the capture's ms, the replay's device ms alone (CUDA
    events), each call's trajectory equal to the eager loop's to the bit,
    and 3 + 10*T flash calls (3 + 2*T split, 8*T tile) on both paths."""
    import contextlib
    from unittest import mock

    import numpy as np
    import torch

    from nvblox_mindmap_torch.models import diffuser_actor as da
    from nvblox_mindmap_torch.models.converter import (
        apply_inference_settings,
        convert_diffusion_scheduler,
        convert_to_flash_attention,
    )
    from nvblox_mindmap_torch.ops import flash_attention as fa
    from nvblox_mindmap_torch.ops.attention import set_default_attention_impl

    torch.manual_seed(0)
    model = da.DiffuserActor(model_config("mesh"), device="cuda")
    bounds = np.asarray(WORKSPACE, dtype=np.float32)
    prepared = da.prepare_inputs(make_batch(1, "mesh", vertices=GOAL_KEYS), bounds,
                                 model.config, device="cuda")
    sampler = convert_diffusion_scheduler(10)
    T = sampler["num_inference_steps"]
    init = torch.randn((1, 1, 1, 9), generator=torch.Generator(device="cuda").manual_seed(4),
                       device="cuda")
    rest = apply_inference_settings(convert_to_flash_attention())
    if rest:
        raise AssertionError(f"unexpected sampler settings {rest}")

    def predict():
        return da.sample_trajectory(model, prepared, bounds, init_noise=init, **sampler)

    def eager_only():
        return mock.patch.object(da, "_graph_applies", lambda *a: False)

    with eager_only():
        eager = predict()
    counters = ("graph_captures", "graph_replays", "eager_calls")
    before = [getattr(da.sample_trajectory, c) for c in counters]
    out = {}
    capture_ms = host_ms(lambda: out.update(traj=predict()[0]))
    if not torch.equal(out["traj"], eager[0]):
        raise AssertionError("sampler_graph: the capture's trajectory differs from eager")
    expected = {"flash_attention_split": 3 + 2 * T, "flash_attention_tile": 8 * T}
    times = {"eager": [], "graph": []}
    for i in range(reps):
        for path in (("graph", "eager") if i % 2 == 0 else ("eager", "graph")):
            calls, by_kernel = fa.flash_attention.launches, dict(fa.KERNEL_LAUNCHES)
            with eager_only() if path == "eager" else contextlib.nullcontext():
                times[path].append(host_ms(lambda: out.update(traj=predict()[0])))
            calls = fa.flash_attention.launches - calls
            by_kernel = {k: n - by_kernel[k] for k, n in fa.KERNEL_LAUNCHES.items()}
            if calls != 3 + 10 * T or by_kernel != expected:
                raise AssertionError(f"sampler_graph: {path} made {calls} flash calls "
                                     f"{by_kernel}, expected {3 + 10 * T} {expected}")
            if not torch.equal(out["traj"], eager[0]):
                raise AssertionError(f"sampler_graph: the {path} trajectory differs from eager")
    paths = [getattr(da.sample_trajectory, c) - b for c, b in zip(counters, before)]
    if paths != [1, reps, reps]:
        raise AssertionError(f"sampler_graph: captures, replays, eager calls {paths}, "
                             f"expected [1, {reps}, {reps}]")
    (graph,) = [entry.graph for entry in da._GRAPHS[model].values()]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    set_default_attention_impl("eager")
    summary = {path: dict(zip(("p50_ms", "q1_ms", "q3_ms"), quartiles(t)))
               for path, t in times.items()}
    phase("sampler_graph", B=1, context_keys=GOAL_KEYS, steps=T, reps=reps,
          capture_ms=capture_ms, replay_device_ms=start.elapsed_time(end) / reps,
          eager=summary["eager"], graph=summary["graph"],
          speedup=summary["eager"]["p50_ms"] / summary["graph"]["p50_ms"],
          launches_per_call=3 + 10 * T, launches_by_kernel=expected,
          bit_equal_to_eager=True)


CLIP_FEATURES = 120  # the FPN's channels: the vertex features of a CLIP dataset
CLIP_TIMED_BATCHES = (CAMERAS, TRAIN_BATCH)  # the flagship's 2 cameras; a train batch
# Card vs CPU, both IEEE fp32 (TF32 off in the extractor's convolutions):
# the features within CLIP_REL_ATOL of their largest magnitude, the FPN's
# gradients within CLIP_GRAD_REL_ATOL of each tensor's largest entry.
CLIP_REL_ATOL = 1e-4
CLIP_GRAD_REL_ATOL = 1e-4
CLIP_DEAD_LEVELS = ("inner_0", "inner_1", "layer_0", "layer_1", "layer_3", "layer_4")


def save_random_clip(path, seed=12):
    """A seeded random CLIP RN50 visual trunk as CLIP's torch state dict
    (``visual.`` keys, BatchNorm running statistics calibrated on the card
    over 8 random CLIP-normalized images so that each BatchNorm's output is
    normalized, an attention-pool key the converter skips), converted by the
    port's converter, with a fresh FPN beside it, saved as the flax-layout
    ``.npz``."""
    import numpy as np
    import torch

    from nvblox_mindmap_torch.models.clip_resnet_fpn import (
        CLIP_MEAN,
        CLIP_STD,
        FeaturePyramidNetwork,
        FrozenBatchNorm,
        ModifiedResNetFeatures,
    )
    from nvblox_mindmap_torch.models.layers import init_as_flax_
    from nvblox_mindmap_torch.models.weight_conversion import (
        convert_clip_resnet_weights,
        save_variables_npz,
    )
    from nvblox_mindmap_torch.models.weights import state_dict_to_flax

    torch.manual_seed(seed)
    trunk = init_as_flax_(ModifiedResNetFeatures())
    fpn = init_as_flax_(FeaturePyramidNetwork(trunk.out_channels(), CLIP_FEATURES))

    def calibrate(bn, args):
        x = args[0]
        bn.mean.data = x.mean((0, 2, 3))
        bn.var.data = x.var((0, 2, 3))

    hooks = [m.register_forward_pre_hook(calibrate) for m in trunk.modules()
             if isinstance(m, FrozenBatchNorm)]
    images = torch.rand(8, 3, 8 * PATCHES, 8 * PATCHES)
    mean, std = (torch.tensor(v)[:, None, None] for v in (CLIP_MEAN, CLIP_STD))
    with torch.no_grad():
        trunk.to("cuda")((images.to("cuda") - mean.to("cuda")) / std.to("cuda"))
    for hook in hooks:
        hook.remove()
    trunk.cpu()
    sd = {}
    for name, p in trunk.named_parameters():
        module, _, leaf = name.rpartition(".")
        module = module.replace("downsample_conv", "downsample.0").replace(
            "downsample_bn", "downsample.1")
        if module.startswith("layer"):
            module = module.replace("_", ".", 1)
        leaf = {"mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
        sd[f"visual.{module}.{leaf}"] = p.detach().numpy()
    sd["visual.attnpool.c_proj.weight"] = np.zeros((1024, 2048), np.float32)
    params = {"backbone": convert_clip_resnet_weights(sd)["params"],
              "fpn": state_dict_to_flax(fpn.state_dict())}
    save_variables_npz(path, {"params": params})


def clip_bound(module, B):
    """(bound_ms, bound_by, flops) of the extractor over B images: the
    multiply-adds of every convolution it runs (the trunk's, from hooks on
    this input; the FPN's laterals 2-4 and its res3 output) at the fp32
    (non-tensor-core) peak, against the images read, the parameters read
    once and the features written at the HBM rate."""
    import torch

    flops = []

    def count(conv, args, out):
        flops.append(2 * out.numel() * conv.in_channels * conv.kernel_size[0]
                     * conv.kernel_size[1] // conv.groups)

    hooks = [m.register_forward_hook(count) for m in module.backbone.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        feats = module.trunk(torch.zeros(B, IMAGE, IMAGE, 3, device="cuda"))
    for hook in hooks:
        hook.remove()
    h, w = feats[2].shape[-2:]
    for i in (2, 3, 4):
        flops.append(2 * feats[i].numel() * CLIP_FEATURES)
    flops.append(2 * B * h * w * CLIP_FEATURES * CLIP_FEATURES * 9)
    total = sum(flops)
    live = [p for n, p in module.named_parameters()
            if not (n.startswith("fpn.") and n.split(".")[1] in CLIP_DEAD_LEVELS)]
    nbytes = 4 * (B * IMAGE * IMAGE * 3 + sum(p.numel() for p in live)
                  + B * h * w * CLIP_FEATURES)
    t_ops = total / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return bound + (total,)


def measure_clip(npz):
    """Phase ``clip_extractor``: the CLIP extractor (the .npz's trunk and
    FPN) on the card against itself on the CPU, same weights and input; its
    device time at B = 2 and 32 beside its FLOP bound, and beside the same
    module with TF32 allowed in its convolutions; one backward pass: no
    gradient on the trunk or the FPN levels res3 does not read, the others'
    equal to the CPU's."""
    import contextlib
    from unittest import mock

    import torch

    from nvblox_mindmap_torch.models import clip_resnet_fpn
    from nvblox_mindmap_torch.models.pretrained import build_backbone

    t_phase = time.perf_counter()
    size = (PATCHES, PATCHES)
    cpu = build_backbone("clip_resnet50_fpn", npz, size, device="cpu")
    card = build_backbone("clip_resnet50_fpn", npz, size, device="cuda")
    gen = torch.Generator().manual_seed(13)
    rgb = torch.rand(CAMERAS, IMAGE, IMAGE, 3, generator=gen)
    weights = torch.randn(CAMERAS, PATCHES, PATCHES, CLIP_FEATURES, generator=gen)

    def loss(module, device):
        return (module(rgb.to(device)) * weights.to(device)).sum()

    with torch.no_grad():
        ref = cpu(rgb)
        out = card(rgb.cuda()).cpu()
    if out.shape != (CAMERAS, PATCHES, PATCHES, CLIP_FEATURES):
        raise AssertionError(f"clip_extractor: output {tuple(out.shape)}")
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    if not (err <= CLIP_REL_ATOL * scale and bool(torch.isfinite(out).all())):
        raise AssertionError(f"clip_extractor: card vs CPU {err} > {CLIP_REL_ATOL} x {scale}")
    loss(cpu, "cpu").backward()
    loss(card, "cuda").backward()
    grad_err, trained = 0.0, 0
    for (name, p_cpu), p in zip(cpu.named_parameters(), card.parameters()):
        dead = name.startswith("fpn.") and name.split(".")[1] in CLIP_DEAD_LEVELS
        if name.startswith("backbone.") or dead:
            if p.grad is not None or p_cpu.grad is not None:
                raise AssertionError(f"clip_extractor: {name} got a gradient")
            continue
        g = p.grad.cpu()
        rel = (g - p_cpu.grad).abs().max().item() / p_cpu.grad.abs().max().item()
        if not (rel <= CLIP_GRAD_REL_ATOL and g.abs().max().item() > 0):
            raise AssertionError(f"clip_extractor: {name} gradient card vs CPU {rel}")
        grad_err, trained = max(grad_err, rel), trained + 1
    if trained != 8:  # inner_2..4 and layer_2, weight and bias
        raise AssertionError(f"clip_extractor: {trained} FPN tensors got gradients")
    del cpu

    timings = []
    for B in CLIP_TIMED_BATCHES:
        x = torch.rand(B, IMAGE, IMAGE, 3, device="cuda")
        with torch.no_grad():
            device_ms = gpu_time_ms(lambda: card(x), reps=3, iters=3)
            before = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = True
            try:
                with mock.patch.object(clip_resnet_fpn, "fp32_convolutions",
                                       contextlib.nullcontext):
                    tf32_ms = gpu_time_ms(lambda: card(x), reps=3, iters=3)
            finally:
                torch.backends.cudnn.allow_tf32 = before
        bound_ms, bound_by, flops = clip_bound(card, B)
        timings.append(dict(B=B, input=8 * PATCHES, device_ms=device_ms, tf32_ms=tf32_ms,
                            flops=flops, flops_per_image=flops / B, bound_ms=bound_ms,
                            bound_by=bound_by, bound_share=bound_ms / device_ms,
                            tflops_per_s=flops / device_ms / 1e9))
    del card
    torch.cuda.empty_cache()
    phase("clip_extractor", feature_image_size=list(size), precision="fp32 (TF32 off)",
          card_vs_cpu_max_abs_err=err, feature_max_abs=scale, rel_atol=CLIP_REL_ATOL,
          fpn_grad_card_vs_cpu_rel_err=grad_err, fpn_tensors_with_grad=trained,
          trunk_and_unread_levels_without_grad=True, timings=timings,
          seconds=time.perf_counter() - t_phase)


TRAJ_ATOL = 5e-3  # flash against eager attention, whole trajectories
PATH_STEPS = 10  # DDIM-10: the cells' sampler


@contextlib.contextmanager
def main_path(name, counts, shapes):
    """Within the block the kernels' launches count from 0, and every flash
    launch's (B, H, L, S, D, masked) goes into ``shapes`` (a replayed CUDA
    graph's through ``fa.REPLAYED``). On leaving, ``counts[name]`` holds the
    block's launches by kernel, ``fps`` and ``integrate_pool``, and the
    launches recorded and replayed must be every flash launch counted."""
    from unittest import mock

    import torch

    from nvblox_mindmap_torch.ops import flash_attention as fa
    from nvblox_mindmap_torch.ops.fps import farthest_point_sampling
    from nvblox_mindmap_torch.ops.integrate_pool import integrate_pool

    fa.flash_attention.launches = farthest_point_sampling.launches = 0
    integrate_pool.launches = 0
    fa.KERNEL_LAUNCHES.update(dict.fromkeys(fa.KERNELS, 0))
    recorded, replayed, run_kernel = [0], fa.REPLAYED.copy(), fa.run_kernel

    def recording(kernel, q, k, v, key_padding_mask=None):
        if q.shape[2] > 0:  # run_kernel launches nothing for no queries
            shapes.add((*q.shape[:3], k.shape[2], q.shape[3], key_padding_mask is not None))
            recorded[0] += not torch.cuda.is_current_stream_capturing()
        return run_kernel(kernel, q, k, v, key_padding_mask)

    with mock.patch.object(fa, "run_kernel", recording):
        yield
    torch.cuda.synchronize()
    new = fa.REPLAYED - replayed
    shapes.update((*c.q_shape[:3], c.keys, c.q_shape[3], c.valid_keys is not None) for c in new)
    counts[name] = dict(fa.KERNEL_LAUNCHES, fps=farthest_point_sampling.launches,
                        integrate_pool=integrate_pool.launches)
    if recorded[0] + sum(new.values()) != sum(fa.KERNEL_LAUNCHES.values()):
        raise AssertionError(f"{name}: {recorded[0]} launches recorded, {sum(new.values())} "
                             f"replayed, {fa.KERNEL_LAUNCHES} counted")


def plane_environment():
    """Both cameras looking straight down at the table plane z = 0 from 0.6
    and 0.7 m, random RGB, and the arm's policy state above it."""
    import numpy as np

    from nvblox_mindmap_torch.closed_loop.environment import CameraFrame, EnvironmentBase

    rng = np.random.default_rng(7)
    f = 400.0
    K = np.asarray([[f, 0, IMAGE / 2], [0, f, IMAGE / 2], [0, 0, 1]], np.float32)
    frames = {name: CameraFrame(
        rng.uniform(0, 1, (IMAGE, IMAGE, 3)).astype(np.float32),
        np.full((IMAGE, IMAGE), height, np.float32), K,
        np.asarray([x, y, height, 0, 1, 0, 0], np.float32))  # +z looks down
        for name, x, y, height in (("front", 0.3, 0.0, 0.6), ("side", 0.4, 0.1, 0.7))}

    class Plane(EnvironmentBase):
        def get_cameras(self):
            return frames

        def get_policy_state(self):
            return np.asarray([0.30, 0.0, 0.40, 0, 1, 0, 0, 0], np.float32)

    return Plane()


def check_main_paths(checks):
    """Phase ``main_paths``, untimed: the program's entry points at full width
    on random inputs, each path's launches counted from 0 (``main_path``):
    ``sample_trajectory`` (DDIM-10, B = 1 and 8) on the mesh and the
    rgbd_and_mesh models against eager attention; one closed-loop policy
    goal over 2 cameras of a plane; one train step of the rgbd_and_mesh
    model at the train batch and one eval batch. Every flash shape they
    launched that no ``kernel_check`` row holds is held against the plain
    version and timed (``kernel_check`` rows, what = ``path_shape``).
    Returns each path's launches by kernel and ``fps``."""
    import numpy as np
    import torch

    from nvblox_mindmap_torch.closed_loop.policies import NvbloxDiffuserActorPolicy
    from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
    from nvblox_mindmap_torch.mapping.constants import MappingConfig, Tasks
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
    from nvblox_mindmap_torch.models.pretrained import backbone_feature_fn
    from nvblox_mindmap_torch.ops import flash_attention as fa
    from nvblox_mindmap_torch.ops.attention import set_default_attention_impl
    from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig

    T = PATH_STEPS
    per_call = {"flash_attention_split": 3 + 2 * T, "flash_attention_tile": 8 * T}
    bounds = np.asarray(WORKSPACE, np.float32)
    sampler = convert_diffusion_scheduler(T)
    counts, shapes = {}, set()

    def expect(name, fps, flash=per_call, pool=0):
        got = counts[name]
        if ({k: got[k] for k in fa.KERNELS} != flash or got["fps"] != fps
                or got["integrate_pool"] != pool):
            raise AssertionError(f"{name}: launches {got}, expected {flash}, {fps} FPS and "
                                 f"{pool} pool updates")

    for data_type in ("mesh", "rgbd_and_mesh"):
        torch.manual_seed(0)
        model = DiffuserActor(model_config(data_type), device="cuda")
        for B in (1, 8):
            prepared = prepare_inputs(make_batch(B, data_type), bounds, model.config,
                                      device="cuda")
            init = torch.randn((B, 1, 1, 9), device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(1))
            set_default_attention_impl("eager")
            eager = sample_trajectory(model, prepared, bounds, init_noise=init, **sampler)[0]
            if apply_inference_settings(convert_to_flash_attention()):
                raise AssertionError("unexpected sampler settings")
            name = f"predict_{data_type}_b{B}"
            with main_path(name, counts, shapes):
                traj = sample_trajectory(model, prepared, bounds, init_noise=init, **sampler)[0]
            expect(name, fps=1)
            err = (traj - eager).abs().max().item()
            if traj.shape != (B, 1, 1, 8) or not err <= TRAJ_ATOL:
                raise AssertionError(f"{name}: {tuple(traj.shape)}, flash vs eager {err}")

    # The closed loop on the rgbd_and_mesh model: the policy maps 2 sim
    # steps, then one goal.
    mapping = MappingConfig.for_task(Tasks.DRILL_IN_BOX, feature_dim=FEATURE_DIM).\
        scaled_for_image_size((IMAGE, IMAGE))
    policy = NvbloxDiffuserActorPolicy(
        model, ArmEmbodiment(), mapping, bounds, num_vertices_to_sample=VERTICES,
        feature_fn=backbone_feature_fn(model.encoder.feature_extractor, (IMAGE, IMAGE)),
        num_inference_steps=T, scheduler_kind="ddim", stochastic_sampling=False,
        device="cuda")
    env = plane_environment()
    with main_path("closed_loop_steps", counts, shapes):
        for _ in range(2):
            policy.step(env)
    # Each camera frame updates the color and the feature pool.
    expect("closed_loop_steps", fps=0, flash=dict.fromkeys(fa.KERNELS, 0), pool=2 * 2 * 2)
    with main_path("closed_loop_goal", counts, shapes):
        (goal,) = policy.get_new_goal(env)
    expect("closed_loop_goal", fps=1)
    if goal.shape != (8,) or not np.isfinite(goal).all():
        raise AssertionError(f"closed_loop_goal: {goal}")
    surface = len(policy.mesh_vertices()[0])
    del policy, model
    torch.cuda.empty_cache()

    # Training: the step launches no flash kernel, the eval batch a goal's.
    trainer = Trainer(model_config("rgbd_and_mesh"), TrainerConfig(), bounds, device="cuda")
    trainer.init_state()
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in make_batch(TRAIN_BATCH, "rgbd_and_mesh", seed=2).items()}
    with main_path("train_step", counts, shapes):
        loss = float(trainer.train_one_step(batch, 0)["total"])
    expect("train_step", fps=1, flash=dict.fromkeys(fa.KERNELS, 0))
    with main_path("eval_batch", counts, shapes):
        trainer.eval_step(batch, generator=torch.Generator("cuda").manual_seed(0))
    expect("eval_batch", fps=1)
    if not np.isfinite(loss):
        raise AssertionError(f"train_step: loss {loss}")
    set_default_attention_impl("eager")
    del trainer, batch
    torch.cuda.empty_cache()

    held = {(r["B"], r["H"], r["L"], r["S"], r["D"], r["masked"]) for r in checks.values()
            if "B" in r and r.get("dtype") == "float32"}
    gen = torch.Generator(device="cuda").manual_seed(4)
    for shape in sorted(shapes - held):
        checks[("path_shape", shape)] = kernel_row("path_shape", *shape, gen)
    phase("main_paths", steps=T, launches=counts, surface_vertices=surface,
          vertices_sampled=VERTICES, train_batch=TRAIN_BATCH, train_loss=loss,
          shapes=[dict(zip(("B", "H", "L", "S", "D", "masked"), s)) for s in sorted(shapes)],
          shapes_not_in_kernel_check=len(shapes - held))
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "nvblox_mindmap_torch")):
        print(f"chip_smoke: nvblox_mindmap_torch/ is not beside {__file__}: run the copy "
              "at the repository root", file=sys.stderr)
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
    fps_rows = check_fps_kernel()
    pool_rows = check_pool_kernel()
    measure_threshold()
    measure_vit()
    measure_sampler_graph()
    with tempfile.TemporaryDirectory(prefix="mindmap_clip_") as work:
        npz = os.path.join(work, "clip_resnet50_fpn.npz")
        save_random_clip(npz)
        measure_clip(npz)
    paths = check_main_paths(checks)

    # Each kernel at the flagship shape it serves most; beside it, its time
    # at the mesh path's, the apps' and the trained fixtures' shapes.
    main_shapes = {
        "flash_attention_split": (
            ("flagship_denoiser_cross", 1),
            "flagship denoiser cross-attention B=1 H=8 L=1 S=4096 D=15 masked",
            ("denoiser_cross", 1), "mesh denoiser cross-attention B=1 H=8 L=1 S=2048 D=15 masked",
            ("app_denoiser_cross", TRAIN_BATCH),
            f"training app eval denoiser cross-attention B={TRAIN_BATCH} H=8 L=1 "
            f"S={APP_CONTEXT} D=15 masked",
            ("fixture_denoiser_cross", 1),
            "fixture denoiser cross-attention B=1 H=8 L=1 S=512 D=9 masked"),
        "flash_attention_tile": (
            ("flagship_self", 1), "flagship self-attention B=1 H=8 L=S=820 D=15 masked",
            ("self", 1), "mesh self-attention B=1 H=8 L=S=410 D=15 masked",
            ("app_self", TRAIN_BATCH),
            f"training app eval self-attention B={TRAIN_BATCH} H=8 L=S={APP_SELF} D=15 masked",
            ("fixture_self", 1), "fixture self-attention B=1 H=8 L=S=129 D=9 masked"),
    }
    entries = []
    for kernel, (key, shape, mesh_key, mesh_shape, app_key, app_shape, fixture_key,
                 fixture_shape) in main_shapes.items():
        row = checks[key]
        entries.append({
            "name": kernel,
            "route": "cuda",
            "source": f"nvblox_mindmap_torch/csrc/{kernel}.cu",
            "replaces": "nvblox_mindmap_tpu/ops/flash_attention.py:43",
            "launches": sum(n[kernel] for n in paths.values()),
            "launches_by_path": {path: n[kernel] for path, n in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in checks.values()
                               if r["kernel"] == kernel
                               and r.get("dtype", "float32") == "float32"),
            "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": shape,
            "mesh_path_ms": checks[mesh_key]["kernel_ms"],
            "mesh_path_shape": mesh_shape,
            "app_path_ms": checks[app_key]["kernel_ms"],
            "app_path_shape": app_shape,
            "closed_loop_app_ms": checks[(app_key[0], 1)]["kernel_ms"],
            "closed_loop_app_shape": app_shape.replace("training app eval", "closed-loop app")
                                              .replace(f"B={TRAIN_BATCH}", "B=1"),
            "fixture_path_ms": checks[fixture_key]["kernel_ms"],
            "fixture_path_shape": fixture_shape,
        })
    entries[0].update(goal_gripper_ms=checks[("flagship_goal_cross", 1)]["kernel_ms"],
                      goal_gripper_shape="flagship encode_goal_gripper B=1 H=8 L=1 S=4096 "
                                         "D=15 unmasked")
    entries.append({
        "name": "fps",
        "route": "cuda",
        "source": "nvblox_mindmap_torch/csrc/fps.cu",
        "replaces": "none: nvblox_mindmap_tpu/ops/fps.py is a lax.scan that XLA compiles",
        "launches": sum(n["fps"] for n in paths.values()),
        "launches_by_path": {path: n["fps"] for path, n in paths.items()},
        "picks_equal_to_eager": all(r["picks_equal"] for r in fps_rows.values()),
        **{f"{name}_{key}": row[key] for name, row in fps_rows.items()
           for key in ("kernel_ms", "plain_ms", "bound_ms", "share")},
    })
    entries.append({
        "name": "integrate_pool",
        "route": "cuda",
        "source": "nvblox_mindmap_torch/csrc/integrate_pool.cu",
        "replaces": "none: nvblox_mindmap_tpu/mapping/voxel_grid.py:_integrate_pool is XLA ops",
        "launches": sum(n["integrate_pool"] for n in paths.values()),
        "launches_by_path": {path: n["integrate_pool"] for path, n in paths.items()},
        "bits_equal_to_plain": all(r["bits_equal"] for r in pool_rows.values()),
        **{f"{name}_{key}": row[key] for name, row in pool_rows.items()
           for key in ("kernel_ms", "plain_ms", "bound_ms", "share")},
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
