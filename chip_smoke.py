#!/usr/bin/env python3
"""Drive the torch port's keypose prediction, live mapping, closed-loop
policy, training, its training, open-loop, datagen and closed-loop apps,
and the task-success and spatial-memory experiments with the committed
trained policies, on one NVIDIA GPU.

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
   could take (``bound_ms``), at head dims 64, 128, 144, 192 and 256 and
   for bf16 inputs too; and times both kernels at L = 1..8 (phase ``threshold``: the
   measurement behind the split kernel's limit);
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
6. holds the port's mapper on the card to the same code on the CPU (phase
   ``mapper_check``: 2 cm voxels, 32-d features, 128x128 frames of the scene
   below), and times one map update (``fuse_frame``: decay, TSDF, page
   allocation, 768-d feature fusion) at the configuration of the JAX
   package's fusion bench, the drill_in_box box at 1 cm (136x152x80 voxels),
   1024 pages, 512x512 frames, beside its byte bound, with each of its ops
   on its own (phases ``fusion``, ``fusion_ops``);
7. drives the closed-loop policy (``NvbloxDiffuserActorPolicy``) at full
   size: the flagship model, a RADIO ViT-B/16 mapping feature function
   upscaled to 512x512x768, that map, 2 cameras at 512x512 over an
   analytically rendered scene (a table, boxes, and a box labelled
   ``robot`` that the dynamic mask keeps out of the map), DDIM-10 at batch
   1 and 2048 sampled vertices. It times sim steps (feature function and
   fusion per camera) and goals (mesh extraction, vertex sampling,
   back-projection, prediction), profiles one of each, checks that every
   goal launches 3 + 10*T flash calls and that a goal through the kernels
   matches eager attention (phase ``closed_loop``);
8. trains the flagship on the card (phase ``train``): ``Trainer`` at
   ``bench.py``'s train width (``rgbd_and_mesh``, B = 32, random weights),
   with the flash impl installed as the process-wide default. After one
   update every trainable parameter the path reads gets a finite, non-zero
   gradient; 2 warm-up and 8 timed steps launch no flash kernel and leave
   the frozen backbone bit-equal; their p50, samples/s, device busy and
   idle share, peak memory and FLOPs (``FlopCounterMode``); each eval batch (``evaluate_nsteps``, DDIM-10)
   launches 3 + 2*10 split and 8*10 tile calls; ``run_training`` saves a
   checkpoint, a new trainer loads it, and one step from it equals one step
   of the trainer that went on; 20 steps on one fixed batch, noise and
   timesteps lower the loss; one step of the mesh path at full width and
   B = 2 gives the card's loss and gradients on the CPU too;
9. runs the training app (``apps/run_training.py``, phase ``train_app``) on
   an on-disk dataset that the port's writer puts in a temporary directory:
   cube_stacking, ``rgbd_and_mesh`` with the ego camera at 512x512 (the app
   takes one camera with a mesh), 2048 of 4096 stored 768-d vertex features,
   B = 32, a seeded random RADIO ViT-B/16 saved as the ``--backbone_weights``
   .npz. Each of two runs (``--num_workers`` 0 and 4) takes 6 train steps
   (no flash launch) and one eval batch (3 + 2*10 split, 8*10 tile calls)
   and writes best.ckpt, last.ckpt and training_args.json; best.ckpt,
   rebuilt through the frozen args, predicts one keypose through both
   kernels. It times the loader per worker count and in its parts, the
   app-fed step and its batch wait, and the card's idle share. Then the
   open-loop app (``apps/run_open_loop_policy.py``, phase
   ``open_loop_app``) runs on that dataset with best.ckpt (its frozen args
   sampling the keyposes only): the validation demo's keyposes, DDPM-100,
   each sample 3 + 2*100 split and 8*100 tile calls, finite metrics, one
   sample through the kernels against eager attention (atol 5e-3), its
   idle share; then one sample with ``--ply_output_dir`` writes the
   feature, attention and prediction clouds;
10. records one cube_stacking demo with the port's scripted expert in the
   port's scene world at 512x512 (the table camera as 'wrist', with
   segmentation and a scene.json) and runs the datagen app
   (``apps/run_datagen.py``, phase ``datagen_app``) on it: the task's
   mapping config scaled for 512, 768-d features from the seeded random
   RADIO ViT-B/16 .npz, 12 frames, the serialized map. Every frame's item
   must read back with 768-d fp16 features and the map file must reload
   equal to the live map, bit for bit. It prints the per-part times per
   frame and the card's idle share;
11. runs the closed-loop app (``apps/run_closed_loop_policy.py``, phase
   ``closed_loop_app``) on that demo in the scene world with the training
   app's best.ckpt: the app's flagship (``rgbd_and_mesh``, the ego camera at
   512, 2048 sampled 768-d vertices, RADIO mapping features: 3072 context
   tokens, 615 in self-attention), DDIM-10, 4 steps to a goal, 24 steps.
   Every goal must launch 3 + 2*10 split and 8*10 tile calls, a goal through
   the kernels must match eager attention and the eval file must be written;
   then the ground-truth goals on the same demo must stack the cubes
   (success 1.0). It prints sim-step and goal times, the step's parts (the
   scene render apart) and the idle share;
12. side by side with 13, one worker process per task (each is
   host-bound), runs the task-success experiment's ``closed_loop`` stage (phase
   ``task_success``) for each of the four committed trained fixtures
   (``tests/test_data/task_success/<task>/last.ckpt``: width 72, 8 heads,
   512 sampled vertices) on 4 of the 8 scenes the port's generator
   rebuilds from seed 21: cube_stacking at DDPM-100, mug_in_drawer at
   DDIM-10, drill_in_box at DDIM-10 with trailing spacing, stick_in_bin at
   DDPM-20. Each task must succeed in at least one scene (cube_stacking:
   at least half a lifted cube per scene) and every goal must launch
   3 + 2*T split and 8*T tile calls; it prints the success rate, goal and
   episode times;
13. generates and fuses three panning demos (seed 100, 64x64) and runs
   ``eval_pick_keypose_error`` of the committed spatial-memory fixtures
   (phase ``spatial_memory``): mesh under 0.06 m, rgbd over 0.08 m and
   over twice the mesh error; each keypose's 3 seeds are one DDPM-100
   call of 3 rows;
14. holds against the plain version every flash shape that the open-loop
   app, task-success and spatial-memory phases gave the kernels and no
   earlier row held (``kernel_check`` rows ``path_shape``; phase
   ``path_shapes`` lists them all);
15. prints one JSON line of per-kernel numbers, then ``{"ok": true, ...}``
   as the last line.

Any failure raises, and the script exits non-zero without the last line.
It exits non-zero as well when no CUDA device is present or the package is
not beside it: a copy of the script on its own refuses to run.
"""
from __future__ import annotations

import json
import os
import shutil
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
TRAIN_BATCH = 32  # bench.py's train_step_ms_b32_flagship
# The training app's flagship: one (ego) camera, since the app refuses
# --add_external_cam with rgbd_and_mesh; 1024 image tokens + 2048 vertices.
APP_CONTEXT = VERTICES + PATCHES * PATCHES
APP_SELF = 1 + APP_CONTEXT // FPS_FACTOR
DENOISE_ATOL = 1e-4  # fp32 eps, kernel vs einsum/softmax summation order
KERNEL_ATOL = 2e-5
WIDE_HEAD_DIMS = (144, 192, 256)
# The spatial-memory rgbd model: one 64x64 camera through 16x16 RGB tokens,
# FPS factor 4.
SM_RGBD_CONTEXT = 16 * 16
SM_RGBD_SELF = 1 + SM_RGBD_CONTEXT // 4


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def flash_counts():
    from nvblox_mindmap_torch.ops import flash_attention as fa

    return dict(fa.KERNEL_LAUNCHES)


def reset_flash_counts():
    from nvblox_mindmap_torch.ops import flash_attention as fa

    fa.flash_attention.launches = 0
    fa.KERNEL_LAUNCHES.update(dict.fromkeys(fa.KERNELS, 0))


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
    """Phase 3: flash kernels vs plain version at every path shape."""
    import torch

    from nvblox_mindmap_torch.ops import flash_attention as fa

    # (what, B, H, L, S, D, masked). D=15: full width (E=120, 8 heads):
    # encoder gripper cross-attention (L=3 arm, 6 humanoid) over 2048
    # vertices, denoiser cross-attention (L=1 arm, 2 humanoid) with the
    # context mask, self-attention over 1 + 409 FPS tokens; the flagship's
    # over its 4096 context tokens and 1 + 819 FPS tokens. D=9: the
    # committed fixtures (E=72): 512 vertices, 128 FPS tokens.
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
    # the task_success phase; the arm fixtures' shapes at B = 3, the
    # spatial_memory phase's three seeds per keypose; and the spatial-memory
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
        reset_flash_counts()
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


# --------------------------------------------------------------------------
# Live mapping and the closed loop
# --------------------------------------------------------------------------

# The closed loop's scene: a table top (z = 0) over the drill_in_box box,
# three boxes on it, and one box labelled "robot" (the task's dynamic
# class): (min corner, max corner, RGB, label id).
SCENE_BOXES = (
    ((-0.30, -0.70, -0.05), (0.90, 0.70, 0.00), (0.55, 0.45, 0.35), 1),
    ((0.05, -0.40, 0.00), (0.25, -0.18, 0.14), (0.80, 0.20, 0.20), 2),
    ((0.35, 0.05, 0.00), (0.52, 0.28, 0.22), (0.20, 0.70, 0.30), 3),
    ((0.55, -0.20, 0.00), (0.75, 0.02, 0.09), (0.20, 0.30, 0.80), 4),
    ((0.00, 0.30, 0.00), (0.16, 0.46, 0.48), (0.60, 0.60, 0.60), 9),
)
SCENE_LABELS = {0: "background", 1: "table", 2: "box_a", 3: "box_b", 4: "box_c", 9: "robot"}
# Camera positions, each looking at the middle of the table.
SCENE_CAMERAS = {"front": (1.25, 0.05, 0.85), "side": (0.35, -1.05, 0.80)}
SCENE_TARGET = (0.30, 0.0, 0.05)
FOCAL = 400.0  # px at 512x512
MAP_FEATURES = 768
MAP_PAGES = 1024
CLOSED_LOOP_STEPS = 10  # DDIM-10
# Card vs CPU: every map field within MAP_ATOL on all but MAP_TIE_SHARE of
# its entries (a voxel centre on a half-pixel tie may round to the next
# pixel); surface vertices within MAP_ATOL; their features, which blend two
# TSDF endpoints by the crossing position, within MAP_FEATURE_ATOL.
MAP_ATOL = 1e-5
MAP_FEATURE_ATOL = 1e-3
MAP_TIE_SHARE = 1e-3


def look_at_pose7(eye, target):
    """(7,) position + wxyz quaternion of a camera at ``eye`` whose +z looks
    at ``target``, +y pointing down."""
    import numpy as np

    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    z = (target - eye) / np.linalg.norm(target - eye)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z], axis=1)
    # Shepperd's method on a proper rotation.
    t = np.trace(R)
    if t > 0:
        s = 2.0 * np.sqrt(t + 1.0)
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0)
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return np.concatenate([eye, np.asarray(q) / np.linalg.norm(q)]).astype(np.float32)


def render_camera(pose7, size):
    """(rgb (H, W, 3) float32, depth (H, W), K, segmentation): ray casting
    against the scene's boxes; a ray that hits nothing has depth 0."""
    import numpy as np

    from nvblox_mindmap_torch.geometry.np_rotations import pose7_to_matrix

    f = FOCAL * size / IMAGE
    K = np.asarray([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)
    T = pose7_to_matrix(pose7).astype(np.float64)
    v, u = np.mgrid[0:size, 0:size].astype(np.float64)
    rays_cam = np.stack([(u - size / 2) / f, (v - size / 2) / f, np.ones_like(u)], -1)
    rays = rays_cam @ T[:3, :3].T  # camera z = 1 along each ray: t is the depth
    origin = T[:3, 3]
    depth = np.full((size, size), np.inf)
    rgb = np.zeros((size, size, 3))
    seg = np.zeros((size, size), np.int32)
    face_shade = np.asarray([0.8, 0.65, 1.0])  # by the axis of the face hit
    with np.errstate(divide="ignore", invalid="ignore"):
        for lo, hi, color, label in SCENE_BOXES:
            t1 = (np.asarray(lo) - origin) / rays
            t2 = (np.asarray(hi) - origin) / rays
            enter = np.nan_to_num(np.minimum(t1, t2), nan=-np.inf)
            leave = np.nan_to_num(np.maximum(t1, t2), nan=np.inf)
            near, far = enter.max(axis=-1), leave.min(axis=-1)
            hit = (near <= far) & (near > 0) & (near < depth)
            depth[hit] = near[hit]
            shade = face_shade[enter.argmax(axis=-1)][..., None]
            rgb[hit] = (np.asarray(color) * shade)[hit]
            seg[hit] = label
    depth[~np.isfinite(depth)] = 0.0
    return rgb.astype(np.float32), depth.astype(np.float32), K, seg


def scene_environment(size):
    """The closed loop's environment: the scene through both cameras at
    ``size`` x ``size``, and the arm's policy state above the table."""
    import numpy as np

    from nvblox_mindmap_torch.closed_loop.environment import CameraFrame, EnvironmentBase

    class Scene(EnvironmentBase):
        semantic_id_to_class = SCENE_LABELS

        def __init__(self):
            self.frames = {}
            for name, eye in SCENE_CAMERAS.items():
                pose7 = look_at_pose7(eye, SCENE_TARGET)
                rgb, depth, K, seg = render_camera(pose7, size)
                self.frames[name] = CameraFrame(rgb, depth, K, pose7, seg)

        def get_cameras(self):
            return self.frames

        def get_policy_state(self):
            # pos3 + quat4 (gripper pointing down) + closedness
            return np.asarray([0.30, 0.0, 0.40, 0, 1, 0, 0, 0], np.float32)

    return Scene()


def mapping_config(voxel_size_m=None, feature_dim=MAP_FEATURES, pages=MAP_PAGES, image=IMAGE):
    from nvblox_mindmap_torch.mapping.constants import MappingConfig, Tasks

    return MappingConfig.for_task(Tasks.DRILL_IN_BOX, feature_dim=feature_dim,
                                  voxel_size_m=voxel_size_m,
                                  max_feature_pages=pages).scaled_for_image_size((image, image))


def check_mapper():
    """The mapper on the card against the same code on the CPU: 3 frames of
    the scene at 128x128 through the recipe (decay, depth, color, 32-d
    features, the dynamic mask), then the extracted surface."""
    import numpy as np
    import torch

    from nvblox_mindmap_torch.closed_loop.environment import dynamic_mask_from_segmentation
    from nvblox_mindmap_torch.geometry.np_rotations import pose7_to_matrix
    from nvblox_mindmap_torch.mapping.constants import MapperId
    from nvblox_mindmap_torch.mapping.mapper import Mapper, nvblox_integrate
    from nvblox_mindmap_torch.mapping.voxel_grid import state_to_numpy

    size, features = 128, 32
    cfg = mapping_config(voxel_size_m=0.02, feature_dim=features, pages=512, image=size)
    env = scene_environment(size)
    mappers = {d: Mapper({MapperId.STATIC: cfg}, device=d) for d in ("cuda", "cpu")}
    rng = np.random.default_rng(5)
    frames = list(env.get_cameras().values())
    for i in range(3):
        frame = frames[i % len(frames)]
        feats = rng.normal(size=(size, size, features)).astype(np.float32)
        dynamic = dynamic_mask_from_segmentation(frame.segmentation, SCENE_LABELS,
                                                 cfg.dynamic_class_labels)
        for mapper in mappers.values():
            mapper.decay()
            nvblox_integrate(mapper, cfg, frame.depth, feats, frame.intrinsics,
                             pose7_to_matrix(frame.pose7), frame.rgb, dynamic, False)
    torch.cuda.synchronize()
    card, host = (state_to_numpy(mappers[d].states[MapperId.STATIC]) for d in ("cuda", "cpu"))
    for name in ("page_table", "page_to_block", "num_pages"):
        if not np.array_equal(card[name], host[name]):
            raise AssertionError(f"mapper_check: {name} differs between card and CPU")
    off = {}
    for name in ("tsdf", "weight", "feat_weight", "color_weight", "feat", "color"):
        a, b = card[name].astype(np.float32), host[name].astype(np.float32)
        bad = ~np.isclose(a, b, atol=MAP_ATOL, rtol=0)
        off[name] = dict(entries=int(bad.sum()), exact=bool(np.array_equal(card[name], host[name])),
                         max_abs_err=float(np.abs(a - b).max()))
        if bad.mean() > MAP_TIE_SHARE:
            raise AssertionError(f"mapper_check: {name} differs on {bad.mean():.2e} of entries")
    meshes = {}
    for d, mapper in mappers.items():
        mapper.update_feature_mesh(MapperId.STATIC)
        v, f, valid = mapper.get_feature_mesh(MapperId.STATIC)
        meshes[d] = (mapper.last_crossing_count, v[valid].cpu().numpy(), f[valid].cpu().numpy())
    (count, v_card, f_card), (count_cpu, v_cpu, f_cpu) = meshes["cuda"], meshes["cpu"]
    if count != count_cpu or v_card.shape != v_cpu.shape or count < 1000:
        raise AssertionError(f"mapper_check: {count} vs {count_cpu} surface crossings")
    vertex_err = float(np.abs(v_card - v_cpu).max())
    feature_err = float(np.abs(f_card - f_cpu).max())
    if not (vertex_err <= MAP_ATOL and feature_err <= MAP_FEATURE_ATOL):
        raise AssertionError(f"mapper_check: vertices {vertex_err}, features {feature_err}")
    phase("mapper_check", grid=list(cfg.grid_shape), voxel_size_m=cfg.voxel_size_m,
          feature_dim=features, frames=3, image=size, pages=int(card["num_pages"]),
          crossings=count, vertex_max_abs_err=vertex_err, feature_max_abs_err=feature_err,
          fields=off)


def fusion_bytes(cfg, image, pages):
    """Bytes one ``fuse_frame`` must move with ``pages`` pool pages: the
    TSDF and weights read and written, the depth image read, the fp16 pool
    read and written, its fp32 weights (features and color) read and
    written, and a feature row gathered for every pool voxel."""
    X, Y, Z = cfg.grid_shape
    slots = pages * cfg.block_size**3
    return (2 * 2 * 4 * X * Y * Z + 4 * image * image + 2 * 2 * slots * cfg.feature_dim
            + 2 * 2 * 4 * slots + 2 * slots * cfg.feature_dim)


def measure_fusion(frames=20):
    """``fuse_frame`` at the JAX package's fusion-bench configuration: host
    clock per frame, device busy time from the profiler, the byte bound;
    then each op of the frame on its own."""
    import numpy as np
    import torch

    from nvblox_mindmap_torch.mapping import voxel_grid as vg

    cfg = mapping_config()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = vg.create_state(cfg, device="cuda")
    depth = 0.5 + 1.5 * torch.rand((IMAGE, IMAGE), generator=gen, device="cuda")
    feats = torch.randn((IMAGE, IMAGE, MAP_FEATURES), generator=gen, device="cuda").half()
    T = torch.eye(4, device="cuda")
    K = torch.tensor([[400.0, 0, 256], [0, 400.0, 256], [0, 0, 1]], device="cuda")
    holder = {"state": state}

    def fuse():
        holder["state"] = vg.fuse_frame(holder["state"], cfg, depth, feats, T, K, K)

    for _ in range(3):
        fuse()
    torch.cuda.reset_peak_memory_stats()
    times = [host_ms(fuse) for _ in range(frames)]
    p50, q1, q3 = quartiles(times)
    prof = profile(fuse, p50)
    pages = int(holder["state"].num_pages)
    X, Y, Z = cfg.grid_shape
    bound_ms = fusion_bytes(cfg, IMAGE, cfg.max_feature_pages) / PEAK_BYTES_PER_S * 1e3
    bound_live_ms = fusion_bytes(cfg, IMAGE, pages) / PEAK_BYTES_PER_S * 1e3
    phase("fusion", grid=[X, Y, Z], voxels=X * Y * Z, feature_dim=MAP_FEATURES,
          max_pages=cfg.max_feature_pages, live_pages=pages, image=IMAGE, frames=frames,
          p50_ms=p50, q1_ms=q1, q3_ms=q3, hz=1e3 / p50,
          peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
          bound_bytes=fusion_bytes(cfg, IMAGE, cfg.max_feature_pages), bound_ms=bound_ms,
          bound_by="bytes", bound_share_of_busy=bound_ms / prof["device_busy_ms"],
          bound_live_pages_ms=bound_live_ms, profile=prof)

    # Each op alone on the same map, with the bytes it must move.
    s = holder["state"]
    slots = cfg.max_feature_pages * cfg.block_size**3
    F = cfg.feature_dim
    V = X * Y * Z
    mesh_budget = 65536
    ops = {
        "decay": (lambda: vg.decay(s, cfg), 2 * 2 * 4 * V + 2 * 2 * 2 * 4 * slots),
        "integrate_depth": (lambda: vg.integrate_depth(s, cfg, depth, T, K),
                            2 * 2 * 4 * V + 4 * IMAGE * IMAGE),
        "allocate_pages": (lambda: vg.allocate_pages(s, cfg), 2 * 4 * V + 2 * 2 * 2 * 4 * slots),
        "integrate_features_pool": (
            lambda: vg._integrate_pool(s.feat, s.feat_weight, s.page_to_block, s.tsdf, s.weight,
                                       feats, T, K, None, cfg, 1.0),
            3 * 2 * slots * F + 2 * 2 * 4 * slots + 2 * 4 * slots),
        "extract_surface_vertices": (
            lambda: vg.extract_surface_vertices(s, cfg, mesh_budget, return_count=True),
            2 * 4 * V + mesh_budget * 4 * (3 + F) + 2 * 2 * mesh_budget * F),
    }
    for name, (fn, nbytes) in ops.items():
        fn()
        op_times = [host_ms(fn) for _ in range(10)]
        op_p50, op_q1, op_q3 = quartiles(op_times)
        op_prof = profile(fn, op_p50)
        op_bound = nbytes / PEAK_BYTES_PER_S * 1e3
        phase("fusion_ops", op=name, p50_ms=op_p50, q1_ms=op_q1, q3_ms=op_q3,
              device_busy_ms=op_prof["device_busy_ms"],
              device_launches=op_prof["device_launches"], bound_bytes=nbytes,
              bound_ms=op_bound, bound_share_of_busy=op_bound / op_prof["device_busy_ms"],
              top=op_prof["top"][:3])
    del holder, s, state, feats
    torch.cuda.empty_cache()


def run_closed_loop(steps=6, goals=4, parts_reps=4):
    """Phase 7: ``NvbloxDiffuserActorPolicy`` at full size on the card.
    Returns each kernel's launches over the timed goals."""
    import numpy as np
    import torch

    from nvblox_mindmap_torch.closed_loop.environment import dynamic_mask_from_segmentation
    from nvblox_mindmap_torch.closed_loop.policies import NvbloxDiffuserActorPolicy
    from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
    from nvblox_mindmap_torch.geometry.np_rotations import pose7_to_matrix
    from nvblox_mindmap_torch.mapping.mapper import nvblox_integrate
    from nvblox_mindmap_torch.models.converter import (
        apply_inference_settings,
        convert_to_flash_attention,
    )
    from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActor, prepare_inputs
    from nvblox_mindmap_torch.models.feature_extractors import make_feature_extractor
    from nvblox_mindmap_torch.models.pretrained import backbone_feature_fn
    from nvblox_mindmap_torch.ops import flash_attention as fa
    from nvblox_mindmap_torch.ops.attention import set_default_attention_impl

    torch.manual_seed(0)
    model = DiffuserActor(model_config("rgbd_and_mesh"), device="cuda")
    vit = make_feature_extractor("radio_v25_b", (PATCHES, PATCHES)).to("cuda")
    cfg = mapping_config()
    policy = NvbloxDiffuserActorPolicy(
        model, ArmEmbodiment(), cfg, np.asarray(WORKSPACE, np.float32),
        num_vertices_to_sample=VERTICES, feature_fn=backbone_feature_fn(vit, (IMAGE, IMAGE)),
        seed=0, num_inference_steps=CLOSED_LOOP_STEPS, scheduler_kind="ddim",
        stochastic_sampling=False, device="cuda")
    env = scene_environment(IMAGE)
    cameras = env.get_cameras()

    # Sim steps: the map fills.
    for _ in range(2):
        policy.step(env)
    step_times = [host_ms(lambda: policy.step(env)) for _ in range(steps)]
    step_p50, step_q1, step_q3 = quartiles(step_times)
    parts = {"decay": [], "feature_fn": [], "integrate_frame": []}
    for _ in range(parts_reps):
        parts["decay"].append(host_ms(policy.mapper.decay))
        for frame in cameras.values():
            holder = {}
            parts["feature_fn"].append(host_ms(
                lambda: holder.update(f=policy.feature_fn(frame.rgb))))
            dynamic = dynamic_mask_from_segmentation(frame.segmentation, SCENE_LABELS,
                                                     cfg.dynamic_class_labels)
            parts["integrate_frame"].append(host_ms(lambda: nvblox_integrate(
                policy.mapper, cfg, frame.depth, holder["f"], frame.intrinsics,
                pose7_to_matrix(frame.pose7), frame.rgb, dynamic, False)))
    step_profile = profile(lambda: policy.step(env), step_p50, vit)

    # One goal's inputs: the surface must hold more vertices than the budget.
    policy._update_history(env)
    vertices, features = policy.mesh_vertices()
    if len(vertices) < VERTICES or features.shape[1] != MAP_FEATURES:
        raise AssertionError(f"closed_loop: {vertices.shape} surface vertices, need "
                             f">= {VERTICES} of {MAP_FEATURES}-d")
    batch = policy._model_inputs(env)
    if not bool(batch["vertices_valid_mask"].all()):
        raise AssertionError("closed_loop: vertex sampling padded instead of downsampling")
    with torch.no_grad():
        fixed = model.encode_prepared(prepare_inputs(batch, policy.bounds, model.config,
                                                     device="cuda"))
    image_valid_share = fixed["context_mask"][:, :CAMERAS * PATCHES * PATCHES].float().mean().item()
    init = torch.randn((1, 1, 1, 9), generator=torch.Generator(device="cuda").manual_seed(4),
                       device="cuda")
    set_default_attention_impl("eager")
    traj_eager, _ = policy.predict(batch, init)
    rest = apply_inference_settings(convert_to_flash_attention())
    if rest:
        raise AssertionError(f"unexpected sampler settings {rest}")
    traj_flash, _ = policy.predict(batch, init)
    err = float(np.abs(traj_flash - traj_eager).max())
    if not err <= TRAJ_ATOL:
        raise AssertionError(f"closed_loop: flash vs eager goal {err} > {TRAJ_ATOL}")

    # The main path: whole goals through the kernels, counted.
    reset_flash_counts()
    goal_times, goal_states = [], []
    for _ in range(goals):
        goal_times.append(host_ms(lambda: goal_states.append(policy.get_new_goal(env))))
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    by_kernel = dict(fa.KERNEL_LAUNCHES)
    T = CLOSED_LOOP_STEPS
    expected = {"flash_attention_split": goals * (3 + 2 * T),
                "flash_attention_tile": goals * 8 * T}
    if launches != goals * (3 + 10 * T) or by_kernel != expected:
        raise AssertionError(f"closed_loop: {launches} flash calls {by_kernel} over {goals} "
                             f"goals, expected {expected}")
    for states in goal_states:
        if len(states) != 1 or states[0].shape != (8,) or not np.isfinite(states[0]).all():
            raise AssertionError(f"closed_loop: bad goal {states}")
    goal_p50, goal_q1, goal_q3 = quartiles(goal_times)

    goal_parts = {"mesh_extraction": [], "vertex_sampling": [], "backprojection": [],
                  "prediction": []}
    for _ in range(parts_reps):
        holder = {}
        goal_parts["mesh_extraction"].append(host_ms(
            lambda: holder.update(mesh=policy.mesh_vertices())))
        goal_parts["vertex_sampling"].append(host_ms(
            lambda: policy.sample_vertices(*holder["mesh"])))
        goal_parts["backprojection"].append(host_ms(lambda: policy.camera_inputs(env)))
        goal_parts["prediction"].append(host_ms(lambda: policy.predict(batch)))
    goal_profile = profile(lambda: policy.get_new_goal(env), goal_p50,
                           model.encoder.feature_extractor)
    set_default_attention_impl("eager")

    def summary(times):
        p50, q1, q3 = quartiles(times)
        return dict(p50_ms=p50, q1_ms=q1, q3_ms=q3)

    phase("closed_loop", model="rgbd_and_mesh", cameras=len(cameras), image=IMAGE,
          map_grid=list(cfg.grid_shape), map_feature_dim=MAP_FEATURES, map_pages=MAP_PAGES,
          live_pages=int(policy.mapper.states[0].num_pages),
          surface_crossings=policy.mapper.last_crossing_count,
          surface_vertices=len(vertices), mesh_budget=policy._mesh_budget,
          vertices_sampled=VERTICES, image_valid_share=image_valid_share,
          sampler="ddim10", goals=goals, launches=launches, launches_by_kernel=by_kernel,
          launches_per_goal=launches // goals, flash_vs_eager_max_abs_err=err,
          step=dict(p50_ms=step_p50, q1_ms=step_q1, q3_ms=step_q3, reps=steps,
                    parts={k: summary(v) for k, v in parts.items()}, profile=step_profile),
          goal=dict(p50_ms=goal_p50, q1_ms=goal_q1, q3_ms=goal_q3, reps=goals,
                    parts={k: summary(v) for k, v in goal_parts.items()},
                    profile=goal_profile))
    return by_kernel


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

TRAIN_TIMED_STEPS = 8
LEARN_STEPS = 20
EVAL_BATCHES = 2
EVAL_STEPS = 10  # DDIM-10, TrainerConfig's eval sampler
# Card vs CPU, one train step of the mesh path (fp32 on both, no TF32; the
# summation orders differ): the loss within TRAIN_LOSS_RTOL relative, each
# gradient within TRAIN_GRAD_RTOL of its largest entry on the CPU.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3
# A step from the reloaded checkpoint vs the same step of the trainer that
# went on: the same loss; parameters within RESUME_ATOL (the backward's
# atomic scatter-adds may sum in another order).
RESUME_ATOL = 1e-6
UNREAD_PARAMETERS = {"encoder.goal_gripper_embed"}  # no keypose path reads it


def train_batch(B, data_type, seed):
    """``make_batch`` plus a ground-truth keypose inside the workspace."""
    import numpy as np

    batch = make_batch(B, data_type, seed)
    rng = np.random.default_rng(seed + 10_000)
    quat = rng.normal(size=(B, 1, 1, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    batch["gt_gripper_pred"] = np.concatenate(
        [rng.uniform(-0.3, 0.6, (B, 1, 1, 3)), quat, rng.integers(0, 2, (B, 1, 1, 1))],
        -1).astype(np.float32)
    return batch


class PoolLoader:
    """Batches of ``batch_size`` samples from a host pool, in the order of a
    ``WeightedEpochSampler``: what ``run_training`` iterates."""

    def __init__(self, pool, batch_size, sampler):
        self.pool, self.batch_size, self.sampler = pool, batch_size, sampler

    def __len__(self):
        return len(self.sampler) // self.batch_size

    def __iter__(self):
        order = list(self.sampler)
        for i in range(len(self)):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield {k: v[idx] for k, v in self.pool.items()}


def check_train_card_vs_cpu():
    """One train step of the mesh path at full width, B = 2, on the card and
    on the CPU from the same weights, batch, noise and timesteps. Feature-
    space FPS is a chain of argmaxes whose near-ties an ulp can flip
    (ROADMAP.md), so the CPU step takes the card's picks; how many of its
    own picks differ is reported."""
    import numpy as np
    import torch

    from nvblox_mindmap_torch.models import encoder
    from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig

    cfg = model_config("mesh")
    bounds = np.asarray(WORKSPACE, np.float32)
    trainers = {d: Trainer(cfg, TrainerConfig(), bounds, device=d) for d in ("cuda", "cpu")}
    for trainer in trainers.values():
        trainer.init_state()
    batch = train_batch(2, "mesh", seed=5)
    rng = np.random.default_rng(6)
    noise = torch.from_numpy(rng.normal(size=(2, 1, 1, 9)).astype(np.float32))
    timesteps = torch.from_numpy(rng.integers(0, cfg.diffusion_timesteps, 2))
    real_fps = encoder.farthest_point_sampling
    picks = {}

    def record(points, k, start_idx=0):
        picks["card"] = real_fps(points, k, start_idx)
        return picks["card"]

    def replay(points, k, start_idx=0):
        picks["cpu"] = real_fps(points, k, start_idx)
        return picks["card"].cpu()

    losses = {}
    try:
        for device, fps in (("cuda", record), ("cpu", replay)):
            encoder.farthest_point_sampling = fps
            losses[device] = trainers[device].compute_loss_and_grads(
                batch, 0, noise.to(device), timesteps.to(device))
    finally:
        encoder.farthest_point_sampling = real_fps
    card, host = (float(losses[d]["total"]) for d in ("cuda", "cpu"))
    loss_err = abs(card - host) / abs(host)
    worst, worst_name = 0.0, None
    params = {d: dict(t.model.named_parameters()) for d, t in trainers.items()}
    for name, p in params["cpu"].items():
        if p.grad is None:
            continue
        g = params["cuda"][name].grad.cpu()
        err = float((g - p.grad).abs().max() / p.grad.abs().max().clamp_min(1e-30))
        if err > worst:
            worst, worst_name = err, name
    fps_differ = int((picks["card"].cpu() != picks["cpu"]).sum())
    if not (loss_err <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"train card vs CPU: loss {loss_err}, gradient {worst_name} {worst}")
    return dict(B=2, loss_card=card, loss_cpu=host, loss_rel_err=loss_err,
                grad_max_rel_err=worst, grad_worst=worst_name, loss_rtol=TRAIN_LOSS_RTOL,
                grad_rtol=TRAIN_GRAD_RTOL, fps_picks=int(picks["card"].numel()),
                fps_picks_differing_on_cpu=fps_differ)


def run_training_phase(smi):
    """Phase 8: the flagship trained on the card. Returns each kernel's
    launches over the main path (train steps, then eval batches), and the
    train step's p50 (ms) with the batch resident on the card."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from nvblox_mindmap_torch.data.sampler import WeightedEpochSampler
    from nvblox_mindmap_torch.models.converter import (
        apply_inference_settings,
        convert_to_flash_attention,
    )
    from nvblox_mindmap_torch.ops.attention import set_default_attention_impl
    from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig

    cfg = model_config("rgbd_and_mesh")
    bounds = np.asarray(WORKSPACE, np.float32)
    B = TRAIN_BATCH
    ckpt_dir = os.path.join(ROOT, "nvblox_mindmap_torch", "build", "train_checkpoints")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    # run_training below takes steps 200 and 201, then evaluates and saves.
    tcfg = TrainerConfig(batch_size=B, train_iters=202, checkpoint_dir=ckpt_dir, val_freq=2,
                         skip_train_val=True, num_batches_per_test_eval=1,
                         eval_num_inference_steps=EVAL_STEPS)
    trainer = Trainer(cfg, tcfg, bounds, device="cuda")
    model, optimizer = trainer.init_state()
    host = [train_batch(B, "rgbd_and_mesh", seed) for seed in (0, 1)]
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in b.items()} for b in host]
    backbone = model.encoder.feature_extractor
    backbone_before = [p.detach().clone() for p in backbone.parameters()]
    named = dict(model.named_parameters())
    trainable = {n for n, p in named.items() if p.requires_grad}
    sizes = dict(trainable_parameters=sum(named[n].numel() for n in trainable),
                 frozen_parameters=sum(p.numel() for p in backbone.parameters()))
    # Inference's flash default stays installed: the train step must not use it.
    if apply_inference_settings(convert_to_flash_attention()):
        raise AssertionError("unexpected sampler settings")

    # The main path: train steps, then eval batches.
    reset_flash_counts()
    for step in (0, 1):  # warm-up
        trainer.train_one_step(batches[step % 2], step)
    # At init AdaLN's zero modulation cuts the gradient of everything that
    # only conditions it (the timestep and gripper-history encoders), as in
    # the JAX package; after an update every read parameter must get one.
    losses = trainer.compute_loss_and_grads(batches[0], 2)
    no_grad = {n for n in trainable if named[n].grad is None}
    if no_grad != UNREAD_PARAMETERS:
        raise AssertionError(f"train: no gradient for {sorted(no_grad)}")
    bad = [n for n in trainable - no_grad
           if not bool(torch.isfinite(named[n].grad).all()) or not bool(named[n].grad.any())]
    if bad or not bool(torch.isfinite(losses["total"])):
        raise AssertionError(f"train: non-finite or zero gradients {bad}")
    optimizer.step()
    optimizer.zero_grad()
    torch.cuda.reset_peak_memory_stats()
    times, step_losses = [], []
    for step in range(3, 3 + TRAIN_TIMED_STEPS):
        times.append(host_ms(lambda: step_losses.append(
            float(trainer.train_one_step(batches[step % 2], step)["total"]))))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train_counts = flash_counts()
    if any(train_counts.values()):
        raise AssertionError(f"train steps launched flash kernels {train_counts}")
    if not all(np.isfinite(step_losses)):
        raise AssertionError(f"train: losses {step_losses}")
    p50, q1, q3 = quartiles(times)
    prof = profile(lambda: trainer.train_one_step(batches[0], 100), p50,
                   trainer.model.encoder.feature_extractor)
    with FlopCounterMode(display=False) as counter:
        trainer.train_one_step(batches[1], 101)
    flops = counter.get_total_flops()
    if not all(torch.equal(a, b) for a, b in zip(backbone_before, backbone.parameters())):
        raise AssertionError("train: the frozen backbone changed")
    del model, optimizer, named, backbone, backbone_before

    # Eval batches through both kernels: 3 + 2*T split and 8*T tile each.
    per_batch = {"flash_attention_split": 3 + 2 * EVAL_STEPS,
                 "flash_attention_tile": 8 * EVAL_STEPS}
    mean_loss, metrics = trainer.evaluate_nsteps(batches, 102, EVAL_BATCHES, "val")
    launches = flash_counts()
    if launches != {k: EVAL_BATCHES * n for k, n in per_batch.items()}:
        raise AssertionError(f"eval: {launches} flash launches for {EVAL_BATCHES} batches")
    if not (np.isfinite(mean_loss) and all(np.isfinite(v).all() for v in metrics.values())):
        raise AssertionError(f"eval: loss {mean_loss}, metrics {metrics}")
    eval_times = []
    for i in range(4):
        reset_flash_counts()
        eval_times.append(host_ms(
            lambda: trainer.evaluate_nsteps([batches[i % 2]], 103 + i, 1, "val")))
        if flash_counts() != per_batch:
            raise AssertionError(f"eval batch: {flash_counts()} flash launches")
        for kernel, n in flash_counts().items():
            launches[kernel] += n
    eval_p50, eval_q1, eval_q3 = quartiles(eval_times)

    # run_training: 2 steps from a sampled pool, then an eval and best/last
    # checkpoints; a new trainer resumes from last.ckpt.
    pool = {k: np.concatenate([host[0][k], host[1][k]]) for k in host[0]}
    sampler = WeightedEpochSampler(np.ones(2 * B), replacement=False, seed=0)
    reset_flash_counts()
    best_loss = trainer.run_training(PoolLoader(pool, B, sampler), [batches[0]], start_iter=200)
    if flash_counts() != per_batch:
        raise AssertionError(f"run_training: {flash_counts()} flash launches")
    for kernel, n in flash_counts().items():
        launches[kernel] += n
    resumed = Trainer(cfg, tcfg, bounds, device="cuda")
    step, loaded_best = resumed.load_checkpoint(os.path.join(ckpt_dir, "last.ckpt"))
    if (step, loaded_best) != (201, best_loss):
        raise AssertionError(f"resume: iter {step}, best {loaded_best}, expected 201, {best_loss}")
    went_on = float(trainer.train_one_step(batches[1], step + 1)["total"])
    from_ckpt = float(resumed.train_one_step(batches[1], step + 1)["total"])
    with torch.no_grad():
        resume_err = max(float((a - b).abs().max()) for a, b in
                         zip(trainer.model.parameters(), resumed.model.parameters()))
    if went_on != from_ckpt or not resume_err <= RESUME_ATOL:
        raise AssertionError(f"resume: loss {from_ckpt} vs {went_on}, parameters {resume_err}")
    ckpt_mb = os.path.getsize(os.path.join(ckpt_dir, "last.ckpt")) / 1e6
    del resumed
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # Learning: one batch, fixed noise and timesteps, a fresh model.
    gen = torch.Generator(device="cuda").manual_seed(7)
    noise = torch.randn((B, 1, 1, 9), generator=gen, device="cuda")
    timesteps = torch.randint(0, cfg.diffusion_timesteps, (B,), generator=gen, device="cuda")
    learner = Trainer(cfg, tcfg, bounds, device="cuda")
    learner.init_state()
    curve = [float(learner.train_one_step(batches[0], s, noise, timesteps)["total"])
             for s in range(LEARN_STEPS + 1)]
    if not curve[-1] < curve[0]:
        raise AssertionError(f"learning: loss {curve[0]} -> {curve[-1]} after {LEARN_STEPS} steps")
    del learner, trainer
    set_default_attention_impl("eager")
    torch.cuda.empty_cache()

    card_vs_cpu = check_train_card_vs_cpu()
    phase("train", card=smi, model="rgbd_and_mesh", batch=B, cameras=CAMERAS, image=IMAGE,
          vertices=VERTICES, context_tokens=CONTEXT["rgbd_and_mesh"], **sizes,
          step=dict(p50_ms=p50, q1_ms=q1, q3_ms=q3, reps=TRAIN_TIMED_STEPS,
                    samples_per_s=B / p50 * 1e3, peak_memory_gb=peak_gb,
                    flops=flops, tflops_per_s=flops / p50 / 1e9,
                    fp32_peak_share=flops / p50 * 1e3 / PEAK_FP32_FLOPS,
                    flash_launches=train_counts, losses=step_losses, profile=prof),
          eval_batch=dict(p50_ms=eval_p50, q1_ms=eval_q1, q3_ms=eval_q3, reps=len(eval_times),
                          sampler=f"ddim{EVAL_STEPS}", launches_per_batch=per_batch,
                          mean_loss=mean_loss, rot_error_deg=float(metrics["rot_error_deg"]),
                          distance_m=float(metrics["distance_m"])),
          resume=dict(iter=step, best_loss=best_loss, loss=from_ckpt,
                      parameter_max_abs_err=resume_err, checkpoint_mb=ckpt_mb),
          learning=dict(steps=LEARN_STEPS, first_loss=curve[0], last_loss=curve[-1],
                        curve=curve[::5]),
          backbone_bit_equal=True, card_vs_cpu=card_vs_cpu)
    return launches, p50

# --------------------------------------------------------------------------
# The training app on an on-disk dataset
# --------------------------------------------------------------------------

APP_TASK = "cube_stacking"
APP_FRAMES = 48
APP_STORED_VERTICES = 4096  # per frame on disk; VertexSampler draws VERTICES
APP_TRAIN_ITERS = 6  # then one validation batch
APP_LOADER_EPOCHS = 2  # of 3 batches: 2 train demos of 48 frames
APP_VIEWS = 6  # distinct wrist-camera renders, cycled over the frames
APP_WORKERS = (0, 4)


def scripted_pick(n=APP_FRAMES):
    """(n, 9) arm robot states: descend, grasp (frames 12-17), carry over an
    arch, lower, release (36-41), lift. The keypose estimator finds both
    grasp events, the arch's top and the frames 5 around the grasps."""
    import numpy as np

    i = np.arange(n, dtype=np.float64)
    x = np.interp(i, [0, 12, 18, 35, n - 1], [0.40, 0.45, 0.45, 0.60, 0.60])
    y = np.interp(i, [0, 12, 18, 35, n - 1], [-0.15, -0.10, -0.10, 0.15, 0.15])
    z = np.interp(i, [0, 12, 18, 35, 41, n - 1], [0.30, 0.08, 0.08, 0.12, 0.12, 0.30])
    arch = (i > 18) & (i < 35)
    z[arch] += 0.25 * np.sin(np.pi * (i[arch] - 18) / 17)
    jaw = np.interp(i, [0, 12, 17, 36, 41, n - 1], [0.04, 0.04, 0.01, 0.01, 0.04, 0.04])
    quat = np.tile([0.0, 1.0, 0.0, 0.0], (n, 1))  # gripper pointing down
    return np.concatenate([x[:, None], y[:, None], z[:, None], quat,
                           jaw[:, None], jaw[:, None]], 1).astype(np.float32)


def wrist_camera(state):
    """The ego camera 0.25 m above the end effector, looking down and ahead."""
    eye = state[:3] + [0.0, 0.0, 0.25]
    return look_at_pose7(eye, [eye[0] + 0.15, eye[1], 0.0])


def write_app_dataset(root, seed=0):
    """Two train and one val demo of ``APP_FRAMES`` frames in the reference
    layout, written with the port's ``DemoWriter``: the ego camera's RGB
    and depth at 512x512 over the analytic scene (inside cube_stacking's
    workspace), its pose and intrinsics, the robot state, and
    ``APP_STORED_VERTICES`` surface points of the frame with 768-d fp16
    features. Returns (bytes written, seconds)."""
    import numpy as np

    from nvblox_mindmap_torch.data.batching import _backproject_np
    from nvblox_mindmap_torch.data.writer import DemoWriter

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    states = scripted_pick()
    views = {}
    for d in range(3):
        writer = DemoWriter(os.path.join(root, f"demo_{d:05d}"), png_compress_level=1)
        for i, state in enumerate(states):
            view = i * APP_VIEWS // APP_FRAMES
            if view not in views:
                pose7 = wrist_camera(states[view * APP_FRAMES // APP_VIEWS])
                rgb, depth, K, _ = render_camera(pose7, IMAGE)
                points = _backproject_np(depth[None], K, pose7[None, :3], pose7[None, 3:])[0]
                views[view] = (pose7, rgb, depth, K, points.reshape(-1, 3)[depth.reshape(-1) > 0])
            pose7, rgb, depth, K, points = views[view]
            writer.write_robot_state(i, state)
            writer.write_camera_frame(i, "wrist", rgb, depth, pose7, K)
            pick = rng.choice(len(points), APP_STORED_VERTICES, replace=False)
            writer.write_vertex_features(
                i, points[pick], rng.standard_normal((APP_STORED_VERTICES, FEATURE_DIM),
                                                     np.float32))
        writer.write_outcome(1)
    size = sum(os.path.getsize(os.path.join(dirpath, f))
               for dirpath, _, files in os.walk(root) for f in files)
    return size, time.perf_counter() - t0


def save_random_backbone(path):
    """The seeded random RADIO ViT-B/16 as a converted ``.npz`` (the flax
    layout of ``weight_conversion.save_variables_npz``); returns the module."""
    import numpy as np
    import torch

    from nvblox_mindmap_torch.models.feature_extractors import make_feature_extractor
    from nvblox_mindmap_torch.models.weight_conversion import save_variables_npz
    from nvblox_mindmap_torch.models.weights import flax_paths

    torch.manual_seed(11)
    vit = make_feature_extractor("radio_v25_b", (PATCHES, PATCHES))
    heads = vit.width // 64
    params = dict(vit.named_parameters())
    tree = {}
    for name, flax_path in flax_paths(vit).items():
        w = params[name].detach().numpy()
        leaf, parent = flax_path[-1], flax_path[-2] if len(flax_path) > 1 else ""
        if leaf == "kernel" and w.ndim == 4:  # Conv (out, in, kh, kw) -> (kh, kw, in, out)
            w = w.transpose(2, 3, 1, 0)
        elif leaf == "kernel" and parent in ("query", "key", "value"):  # -> (E, H, D)
            w = w.T.reshape(w.shape[1], heads, -1)
        elif leaf == "kernel" and parent == "out":  # -> (H, D, E)
            w = w.T.reshape(heads, -1, w.shape[0])
        elif leaf == "kernel":
            w = w.T
        elif leaf == "bias" and parent in ("query", "key", "value"):
            w = w.reshape(heads, -1)
        node = tree
        for part in flax_path[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(w)
    save_variables_npz(path, {"params": tree})
    return vit


def loader_parts(loader, samples=8):
    """ms per batch of ``TRAIN_BATCH`` for each part of the host pipeline,
    on this thread: PNG decode of the RGB and the depth item, the zstd
    pickle of vertex features, the vertex draw, then a whole batch of
    samples, its collation and its unpacking (back-projection included)."""
    import numpy as np

    from nvblox_mindmap_torch.data import batching, item_io
    from nvblox_mindmap_torch.data.item_names import NVBLOX_VERTEX_FEATURES_ITEM_NAME

    ds = loader.dataset
    info = ds.demo_info[ds.demo_paths[0]]
    rgb, depth = info["wrist_rgb.png"], info["wrist_depth.png"]
    zst = info[NVBLOX_VERTEX_FEATURES_ITEM_NAME]
    sampler = ds.transforms[NVBLOX_VERTEX_FEATURES_ITEM_NAME][-1]

    def per_batch(fn, n=samples):
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        return (time.perf_counter() - t0) / n * TRAIN_BATCH * 1e3

    meshes = [item_io.load_item(zst[i]) for i in range(samples)]
    parts = dict(
        decode_rgb_ms=per_batch(lambda i: item_io.decode_png(rgb[i])),
        decode_depth_ms=per_batch(lambda i: item_io.decode_png(depth[i])),
        decode_zst_ms=per_batch(lambda i: item_io.load_item(zst[i])),
        vertex_draw_ms=per_batch(lambda i: sampler(dict(meshes[i]))),
    )
    t0 = time.perf_counter()
    batch = [ds[i] for i in range(TRAIN_BATCH)]
    parts["samples_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    collated = batching.collate_batch(batch)
    parts["collate_ms"] = (time.perf_counter() - t0) * 1e3
    cams = batching._structure_depth_items(
        ds.embodiment.get_camera_item_names_by_encoding_method(False)["depth"])
    pose = collated[cams[0]["pose"]]
    t0 = time.perf_counter()
    batching._backproject_np(collated[cams[0]["depth"]], collated[cams[0]["intrinsics"]],
                             pose[:, :3], pose[:, 3:])
    parts["backprojection_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batching.unpack_batch(ds.embodiment, collated, loader.data_type, False, 0.0)
    parts["unpack_ms"] = (time.perf_counter() - t0) * 1e3
    del meshes, batch, collated
    return {k: float(np.round(v, 3)) for k, v in parts.items()}


def host_libraries():
    """What this host offers for the dataset's items: the system zstd and
    PNG libraries, a C compiler, and which of the reference's Python
    readers (never used by the port) are installed."""
    import ctypes.util
    import importlib.util

    return dict(
        libzstd=ctypes.util.find_library("zstd"), libpng=ctypes.util.find_library("png16"),
        cc=shutil.which("cc") or shutil.which("gcc"),
        python_modules={name: importlib.util.find_spec(name) is not None
                        for name in ("zstandard", "imageio", "PIL", "wandb", "matplotlib")})


def loader_epochs(loader, epochs=APP_LOADER_EPOCHS):
    """Host-clock ms per batch of whole epochs of ``loader`` taken with
    nothing else running (the epoch's wall time over its batches: the
    pipeline's fill and its rate)."""
    per_batch = []
    for _ in range(epochs):
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        per_batch.append((time.perf_counter() - t0) * 1e3 / n)
    return per_batch


def run_train_app(resident_step_ms, keep_dir):
    """Phase 9: the training app (``apps/run_training.py``) on an on-disk
    dataset at the app's flagship width. Returns each kernel's launches over
    the main path (the app runs and the prediction from best.ckpt); copies
    best.ckpt and training_args.json into ``keep_dir`` for the closed-loop
    app."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from nvblox_mindmap_torch.apps import run_training as app
    from nvblox_mindmap_torch.data import item_io
    from nvblox_mindmap_torch.mapping.constants import get_workspace_bounds
    from nvblox_mindmap_torch.models.converter import (
        apply_inference_settings,
        convert_diffusion_scheduler,
        convert_to_flash_attention,
    )
    from nvblox_mindmap_torch.models.diffuser_actor import prepare_inputs, sample_trajectory
    from nvblox_mindmap_torch.ops.attention import set_default_attention_impl
    from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig
    from nvblox_mindmap_torch.utils import config, timers

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="mindmap_train_app_")
    try:
        data = os.path.join(root, "dataset")
        dataset_bytes, write_s = write_app_dataset(data)
        npz = os.path.join(root, "radio_v25_b.npz")
        save_random_backbone(npz)
        per_batch = {"flash_attention_split": 3 + 2 * EVAL_STEPS,
                     "flash_attention_tile": 8 * EVAL_STEPS}
        flags = ["--dataset", data, "--task", APP_TASK, "--data_type", "rgbd_and_mesh",
                 "--feature_type", "radio_v25_b", "--feature_image_size",
                 f"{PATCHES},{PATCHES}", "--embedding_dim", str(EMBEDDING),
                 "--batch_size", str(TRAIN_BATCH), "--batch_size_val", str(TRAIN_BATCH),
                 "--num_vertices_to_sample", str(VERTICES), "--demos_train", "0-1",
                 "--demos_valset", "2", "--train_iters", str(APP_TRAIN_ITERS),
                 "--val_freq", str(APP_TRAIN_ITERS), "--num_batches_per_test_eval", "1",
                 "--skip_train_val", "1", "--backbone_weights", npz,
                 "--print_progress_freq", "1", "--print_timers_freq", "1000000"]
        runs, launches, result = {}, dict.fromkeys(per_batch, 0), None
        for workers in APP_WORKERS:
            timers.reset_timers()
            reset_flash_counts()
            result = app.main(flags + ["--num_workers", str(workers), "--base_log_dir",
                                       os.path.join(root, f"logs_{workers}")])
            torch.cuda.synchronize()
            counts = flash_counts()
            # APP_TRAIN_ITERS train steps launch nothing, the one eval batch
            # launches 3 + 2*T split and 8*T tile calls.
            if counts != per_batch:
                raise AssertionError(f"train_app (num_workers={workers}): {counts} flash "
                                     f"launches, expected {per_batch}")
            for kernel, n in counts.items():
                launches[kernel] += n
            ckpt_dir = result["checkpoint_dir"]
            written = sorted(os.listdir(ckpt_dir))
            if not {"best.ckpt", "last.ckpt", "training_args.json"} <= set(written):
                raise AssertionError(f"train_app: {ckpt_dir} holds {written}")
            if not np.isfinite(result["best_loss"]):
                raise AssertionError(f"train_app: validation loss {result['best_loss']}")
            # Step 0 warms up; each later step is its batch's wait plus its step.
            load = [t * 1e3 for t in timers.timer_samples("step/load_batch")[1:]]
            train = [t * 1e3 for t in timers.timer_samples("step/train")[1:]]
            fed = [a + b for a, b in zip(load, train)]
            runs[workers] = dict(
                num_workers=workers, steps=APP_TRAIN_ITERS, val_loss=result["best_loss"],
                # The mean beside the p50: the pool refills at every epoch
                # start, a stall that a p50 over few steps leaves out.
                step_p50_ms=statistics.median(fed), step_mean_ms=statistics.mean(fed),
                step_ms=fed,
                load_batch_p50_ms=statistics.median(load),
                train_p50_ms=statistics.median(train),
                load_batch_share=sum(load) / sum(fed),
                samples_per_s=TRAIN_BATCH / statistics.median(fed) * 1e3,
                eval_batch_ms=1e3 * timers.timer_samples("step/eval/inference")[-1],
                checkpoints=written)
        trainer = result["trainer"]
        model_cfg = trainer.model.config
        if (model_cfg.data_type, model_cfg.vertex_feature_dim) != ("rgbd_and_mesh", FEATURE_DIM):
            raise AssertionError(f"train_app: model config {model_cfg}")

        # The loader on its own, per num_workers, and its parts on one thread.
        args = config.parse_args(config.TrainingAppArgs, flags)
        loaders = {}
        for workers in APP_WORKERS:
            loader = app.build_loaders(dataclasses.replace(args, num_workers=workers),
                                       app.make_embodiment_for_task(APP_TASK))[0]
            times = loader_epochs(loader)
            loaders[workers] = dict(num_workers=workers, batches_per_epoch=len(loader),
                                    epochs=len(times), batch_ms=times,
                                    batch_p50_ms=statistics.median(times))
        train_loader, _, val_loader = app.build_loaders(args,
                                                        app.make_embodiment_for_task(APP_TASK))
        parts = loader_parts(train_loader)

        # Device busy time over 3 app-fed steps (num_workers = 4) against
        # their host-clock time: the idle share.
        trainer.config = dataclasses.replace(trainer.config, train_iters=APP_TRAIN_ITERS + 3,
                                             save_checkpoint=False)
        train_loader.num_workers = APP_WORKERS[-1]
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.run_training(train_loader, val_loader, start_iter=APP_TRAIN_ITERS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        del trainer, result

        # A fresh process's path: the frozen args rebuild the model from
        # best.ckpt, and it predicts one keypose (DDIM-10, B = 1).
        best = os.path.join(ckpt_dir, "best.ckpt")
        cli = config.parse_args(config.TrainingAppArgs,
                                ["--checkpoint", best, "--task", APP_TASK, "--dataset", data,
                                 "--embedding_dim", "24", "--data_type", "mesh"])
        frozen = config.update_model_args_from_checkpoint(cli)
        if frozen.embedding_dim != EMBEDDING:
            raise AssertionError(f"train_app: the overlay gave width {frozen.embedding_dim}")
        cfg = config.model_config_from_args(
            frozen, vertex_feature_dim=app.vertex_feature_dim(val_loader.dataset))
        bounds = get_workspace_bounds(APP_TASK)
        predictor = Trainer(cfg, TrainerConfig(), bounds, device="cuda")
        predictor.load_checkpoint(best)
        batch = next(iter(val_loader))
        one = {k: None if v is None else v[:1] for k, v in batch.items()}
        prepared = prepare_inputs(one, bounds, cfg, device="cuda")
        with torch.no_grad():
            fixed = predictor.model.encode_prepared(prepared, impl="eager")
        tokens = (fixed["context_feats"].shape[1], 1 + fixed["fps_feats"].shape[1])
        if tokens != (APP_CONTEXT, APP_SELF):
            raise AssertionError(f"train_app: context and self-attention tokens {tokens}")
        gen = torch.Generator(device="cuda").manual_seed(5)
        init = torch.randn((1, 1, 1, 9), generator=gen, device="cuda")
        sampler = convert_diffusion_scheduler(EVAL_STEPS)
        set_default_attention_impl("eager")
        traj_eager, _, _ = sample_trajectory(predictor.model, prepared, bounds,
                                             init_noise=init, **sampler)
        apply_inference_settings(convert_to_flash_attention())
        reset_flash_counts()
        traj, _, _ = sample_trajectory(predictor.model, prepared, bounds, init_noise=init,
                                       **sampler)
        torch.cuda.synchronize()
        counts = flash_counts()
        set_default_attention_impl("eager")
        if counts != per_batch:
            raise AssertionError(f"train_app prediction: {counts} flash launches")
        for kernel, n in counts.items():
            launches[kernel] += n
        err = (traj - traj_eager).abs().max().item()
        if traj.shape != (1, 1, 1, 8) or not bool(torch.isfinite(traj).all()) or not (
                err <= TRAJ_ATOL):
            raise AssertionError(f"train_app prediction: {traj.shape}, flash vs eager {err}")
        del predictor, fixed
        torch.cuda.empty_cache()
        for name in ("best.ckpt", "training_args.json"):
            shutil.copy(os.path.join(ckpt_dir, name), keep_dir)
        # The open-loop app on this dataset and checkpoint, before both go.
        add_launches(launches, run_open_loop_app(data, ckpt_dir))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase("train_app", task=APP_TASK, data_type="rgbd_and_mesh", cameras=1, image=IMAGE,
          batch=TRAIN_BATCH, vertices=VERTICES, stored_vertices=APP_STORED_VERTICES,
          feature_dim=FEATURE_DIM, context_tokens=APP_CONTEXT, self_attention_tokens=APP_SELF,
          demos=dict(train=2, val=1, frames=APP_FRAMES), dataset_mb=dataset_bytes / 1e6,
          dataset_write_s=write_s, decoders=item_io.decoder_route(),
          host_libraries=host_libraries(),
          app_runs=list(runs.values()), loader=list(loaders.values()),
          loader_parts_per_batch=parts, resident_step_p50_ms=resident_step_ms,
          idle=dict(steps=3, wall_ms=wall_ms, device_busy_ms=busy_ms,
                    device_idle_share=1 - busy_ms / wall_ms),
          launches_per_eval_batch=per_batch, prediction=dict(
              sampler=f"ddim{EVAL_STEPS}", launches=counts, flash_vs_eager_max_abs_err=err,
              frozen_args=dict(embedding_dim=frozen.embedding_dim,
                               data_type=config.DataType(frozen.data_type).value)),
          seconds=time.perf_counter() - t_phase)
    return launches


# --------------------------------------------------------------------------
# The datagen and closed-loop apps on a demo recorded in the scene world
# --------------------------------------------------------------------------

LOOP_TASK = "cube_stacking"
LOOP_CUBE_HALF = 0.04  # the scene world's cubes (scripts/task_success_experiment.py)
DATAGEN_FRAMES = 12  # --max_num_steps of the datagen app
IDLE_FRAMES = 4  # datagen frames profiled for the idle share
LOOP_STEPS = 24  # --terminate_after_n_steps of the policy run
LOOP_STEPS_TO_GOAL = 4  # --max_num_steps_to_goal: several goals in LOOP_STEPS


def summary_ms(times):
    """p50 / q1 / q3 (ms) and the count of a list of ms."""
    if len(times) < 2:
        return dict(p50_ms=times[0] if times else None, reps=len(times))
    p50, q1, q3 = quartiles(times)
    return dict(p50_ms=p50, q1_ms=q1, q3_ms=q3, reps=len(times))


def record_loop_demo(root):
    """One cube_stacking demo of the port's scripted expert in the port's
    scene world at IMAGE x IMAGE (the table camera recorded as 'wrist', with
    segmentation) and its scene.json; the expert's stack is checked by the
    task's evaluator. Returns (demo path, frames, seconds)."""
    from nvblox_mindmap_torch.closed_loop import scripted
    from nvblox_mindmap_torch.closed_loop.evaluators import CubeStackingEvaluator

    t0 = time.perf_counter()
    env = scripted.make_cube_stacking_env(0, cube_half=LOOP_CUBE_HALF, image_size=IMAGE)
    goals = scripted.scripted_stack_goals(env.initial_objects, LOOP_CUBE_HALF)
    demo = os.path.join(root, "demo_00000")
    evaluator = CubeStackingEvaluator(num_cubes=2, cube_side_length=2 * LOOP_CUBE_HALF)
    evaluator.start_demo("demo_00000", env)
    frames = scripted.record_scripted_demo(demo, env, goals)
    scripted.write_scene_json(demo, env)
    evaluator.evaluate_step(env)
    if not evaluator.current_success or frames <= DATAGEN_FRAMES:
        raise AssertionError(f"record: the expert's demo ({frames} frames) did not stack")
    return demo, frames, time.perf_counter() - t0


def run_datagen_app(root, npz):
    """Phase 10: ``apps/run_datagen.py`` on a recorded demo at the task's
    mapping config scaled for IMAGE, 768-d RADIO features, the serialized
    map written. Returns the demo's path."""
    from unittest import mock

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from nvblox_mindmap_torch.apps import run_datagen as app
    from nvblox_mindmap_torch.data import item_io
    from nvblox_mindmap_torch.embodiments.registry import make_embodiment_for_task
    from nvblox_mindmap_torch.mapping.constants import MapperId, MappingConfig
    from nvblox_mindmap_torch.mapping.mapper import Mapper
    from nvblox_mindmap_torch.mapping.voxel_grid import state_to_numpy
    from nvblox_mindmap_torch.utils import timers

    t_phase = time.perf_counter()
    demo, frames, record_s = record_loop_demo(root)
    live = {}
    real = app.process_demo

    def keep_mapper(*args, **kwargs):
        live["mapper"] = real(*args, **kwargs)
        return live["mapper"]

    flags = ["--task", LOOP_TASK, "--dataset", root, "--demos_datagen", "0",
             "--feature_type", "radio_v25_b", "--backbone_weights", npz,
             "--feature_image_size", f"{PATCHES},{PATCHES}", "--image_size", f"{IMAGE},{IMAGE}",
             "--max_num_steps", str(DATAGEN_FRAMES), "--save_serialized_nvblox_map_to_disk", "1",
             "--validate_demos_with_gt_poses", "1"]
    timers.reset_timers()
    with mock.patch.object(app, "process_demo", keep_mapper):
        app_ms = host_ms(lambda: app.main(flags))
    parts = {name.split("/")[1]: summary_ms([t * 1e3 for t in timers.timer_samples(name)])
             for name in ("datagen/decay", "datagen/compute_features", "datagen/integrate",
                          "datagen/export_mesh")}
    if any(p["reps"] != DATAGEN_FRAMES for p in parts.values()):
        raise AssertionError(f"datagen_app: timers {parts}")

    # Every frame's item reads back through the dataset's reader, fp16 768-d.
    vertices = []
    for t in range(DATAGEN_FRAMES):
        path = os.path.join(demo, f"{t}.nvblox_vertex_features.zst")
        raw = item_io.unpickle_zst(path)
        item = item_io.load_item(path)
        n = len(raw["vertices"])
        if (raw["vertices"].dtype, raw["features"].dtype) != (np.float16, np.float16) or (
                raw["features"].shape != (n, FEATURE_DIM) or raw["channel_length"] != FEATURE_DIM
                or item["features"].shape != (n, FEATURE_DIM) or n == 0
                or not np.isfinite(item["features"]).all()):
            raise AssertionError(f"datagen_app: frame {t} item {raw['vertices'].shape} "
                                 f"{raw['features'].dtype} {raw['features'].shape}")
        vertices.append(n)
    if os.path.exists(os.path.join(demo, f"{DATAGEN_FRAMES}.nvblox_vertex_features.zst")):
        raise AssertionError("datagen_app: --max_num_steps was not held")

    # The serialized map reloads equal to the live state, bit for bit.
    mapper = live["mapper"]
    loaded = Mapper.from_file(os.path.join(demo, "nvblox_map_static.nvblx"), device="cuda")
    if loaded.configs != mapper.configs:
        raise AssertionError("datagen_app: the map file's config differs")
    live_state = state_to_numpy(mapper.states[MapperId.STATIC])
    file_state = state_to_numpy(loaded.states[MapperId.STATIC])
    for name, value in live_state.items():
        if value.dtype != file_state[name].dtype or not np.array_equal(value, file_state[name]):
            raise AssertionError(f"datagen_app: the reloaded map's {name} differs")
    map_mb = os.path.getsize(os.path.join(demo, "nvblox_map_static.nvblx")) / 1e6
    cfg = mapper.configs[MapperId.STATIC]
    live_pages = int(live_state["num_pages"])
    outcome = int(np.load(os.path.join(demo, "demo_successful.npy")))
    del loaded, live, mapper, live_state, file_state
    torch.cuda.empty_cache()

    # Device busy time over IDLE_FRAMES frames of process_demo against their
    # host-clock time: the idle share (the feature extractor built outside).
    mapping = MappingConfig.for_task(LOOP_TASK, feature_dim=FEATURE_DIM).scaled_for_image_size(
        (IMAGE, IMAGE))
    feature_fn = app.make_mapping_feature_fn("radio_v25_b", mapping.upscaled_feature_image_size,
                                             npz, (PATCHES, PATCHES), device="cuda")
    embodiment = make_embodiment_for_task(LOOP_TASK)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_ms = host_ms(lambda: real(demo, embodiment, mapping, feature_fn,
                                       max_num_steps=IDLE_FRAMES, device="cuda"))
    busy_ms = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    del feature_fn
    torch.cuda.empty_cache()
    phase("datagen_app", task=LOOP_TASK, image=IMAGE, recorded_frames=frames,
          record_s=record_s, fused_frames=DATAGEN_FRAMES, feature_dim=FEATURE_DIM,
          map_grid=list(cfg.grid_shape), voxel_size_m=cfg.voxel_size_m,
          map_pages=cfg.max_feature_pages, live_pages=live_pages,
          erosions=dict(static=cfg.static_mask_erosion_iterations,
                        valid_depth=cfg.valid_depth_mask_erosion_iterations),
          vertices_per_frame=vertices, app_ms=app_ms, parts_per_frame=parts,
          map_mb=map_mb, map_reloads_bit_for_bit=True, gt_validation_outcome=outcome,
          idle=dict(frames=IDLE_FRAMES, wall_ms=wall_ms, device_busy_ms=busy_ms,
                    device_idle_share=1 - busy_ms / wall_ms),
          seconds=time.perf_counter() - t_phase)
    return demo


def run_closed_loop_app(root, checkpoint, npz):
    """Phase 11: ``apps/run_closed_loop_policy.py`` on the recorded demo in
    the scene world, with the training app's best.ckpt: the app's flagship
    (rgbd_and_mesh, the ego camera at IMAGE, 2048 sampled 768-d vertices,
    RADIO mapping features), DDIM-10. Then the ground-truth goals on the
    same demo. Returns each kernel's launches over the policy run."""
    import collections
    import contextlib
    import json
    from unittest import mock

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from nvblox_mindmap_torch.apps import run_closed_loop_policy as app
    from nvblox_mindmap_torch.closed_loop import policies, scene
    from nvblox_mindmap_torch.mapping.mapper import Mapper
    from nvblox_mindmap_torch.models.converter import (
        apply_inference_settings,
        convert_to_flash_attention,
    )
    from nvblox_mindmap_torch.models.diffuser_actor import prepare_inputs
    from nvblox_mindmap_torch.ops.attention import set_default_attention_impl

    t_phase = time.perf_counter()
    times = collections.defaultdict(list)
    last = {}

    def timed(name, fn, keep=False):
        def wrapper(*args, **kwargs):
            if keep:
                last.update(policy=args[0], env=args[1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    idle = {}

    def profiled(fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
            idle.update(wall_ms=wall, device_busy_ms=busy, device_idle_share=1 - busy / wall)
            return out
        return wrapper

    def feature_fns(make):
        def wrapper(*args, **kwargs):
            return timed("feature_fn", make(*args, **kwargs))
        return wrapper

    eval_path = os.path.join(root, "closed_loop_eval.json")
    flags = ["--task", LOOP_TASK, "--dataset", root, "--demos_closed_loop", "0"]
    policy_flags = flags + [
        "--checkpoint", checkpoint, "--backbone_weights", npz,
        "--serving_scheduler", "ddim", "--serving_num_inference_steps", str(CLOSED_LOOP_STEPS),
        "--max_num_steps_to_goal", str(LOOP_STEPS_TO_GOAL),
        "--terminate_after_n_steps", str(LOOP_STEPS), "--eval_file_path", eval_path]
    Policy, World = policies.NvbloxDiffuserActorPolicy, scene.SceneKinematicEnvironment
    with contextlib.ExitStack() as patches:
        for owner, name, value in (
                (World, "get_cameras", timed("render", World.get_cameras)),
                (World, "step", timed("env_step", World.step)),
                (Policy, "step", timed("sim_step", Policy.step)),
                (Policy, "get_new_goal", timed("goal", Policy.get_new_goal, keep=True)),
                (Mapper, "decay", timed("decay", Mapper.decay)),
                (policies, "nvblox_integrate", timed("integrate", policies.nvblox_integrate)),
                (app, "make_feature_fn", feature_fns(app.make_feature_fn)),
                (app, "run_closed_loop_policy", profiled(app.run_closed_loop_policy))):
            patches.enter_context(mock.patch.object(owner, name, value))
        reset_flash_counts()
        app_ms = host_ms(lambda: last.update(summary=app.main(policy_flags, "scene")))
        counts = flash_counts()
    goals = len(times["goal"])
    T = CLOSED_LOOP_STEPS
    expected = {"flash_attention_split": goals * (3 + 2 * T),
                "flash_attention_tile": goals * 8 * T}
    if goals < 3 or counts != expected:
        raise AssertionError(f"closed_loop_app: {counts} flash launches over {goals} goals, "
                             f"expected {expected}")
    summary = last["summary"]
    with open(eval_path) as f:
        eval_file = json.load(f)
    if summary["num_demos"] != 1 or "summary" not in eval_file:
        raise AssertionError(f"closed_loop_app: summary {summary}, eval file {list(eval_file)}")

    # One goal of the app's policy through the kernels vs eager attention,
    # and its token counts: the app's flagship.
    policy, env = last["policy"], last["env"]
    batch = policy._model_inputs(env)
    with torch.no_grad():
        fixed = policy.model.encode_prepared(
            prepare_inputs(batch, policy.bounds, policy.model.config, device="cuda"),
            impl="eager")
    tokens = (fixed["context_feats"].shape[1], 1 + fixed["fps_feats"].shape[1])
    if tokens != (APP_CONTEXT, APP_SELF):
        raise AssertionError(f"closed_loop_app: context and self-attention tokens {tokens}")
    init = torch.randn((1, 1, 1, 9), generator=torch.Generator(device="cuda").manual_seed(6),
                       device="cuda")
    set_default_attention_impl("eager")
    traj_eager, _ = policy.predict(batch, init)
    apply_inference_settings(convert_to_flash_attention())
    traj_flash, _ = policy.predict(batch, init)
    set_default_attention_impl("eager")
    err = float(np.abs(traj_flash - traj_eager).max())
    if not (err <= TRAJ_ATOL and np.isfinite(traj_flash).all()):
        raise AssertionError(f"closed_loop_app: flash vs eager goal {err} > {TRAJ_ATOL}")
    del policy, env, last["policy"], last["env"], fixed
    torch.cuda.empty_cache()

    # The ground-truth goals on the same demo re-earn the task's success.
    gt_path = os.path.join(root, "closed_loop_gt_eval.json")
    gt_ms = host_ms(lambda: last.update(gt=app.main(
        flags + ["--demo_mode", "execute_gt_goals", "--eval_file_path", gt_path], "scene")))
    gt = last["gt"]
    if gt["success_rate"] != 1.0 or gt["mean_num_stacked_cubes"] < 2 or not os.path.exists(
            gt_path):
        raise AssertionError(f"closed_loop_app: ground-truth goals {gt}")
    steps = len(times["sim_step"])
    phase("closed_loop_app", task=LOOP_TASK, model="rgbd_and_mesh", cameras=1, image=IMAGE,
          context_tokens=tokens[0], self_attention_tokens=tokens[1], vertices=VERTICES,
          feature_dim=FEATURE_DIM, sampler=f"ddim{T}", steps=steps, goals=goals,
          launches=counts, launches_per_goal={k: n // goals for k, n in counts.items()},
          flash_vs_eager_max_abs_err=err, summary=summary, app_ms=app_ms,
          sim_step=dict(summary_ms(times["sim_step"]),
                        parts={k: summary_ms(times[k]) for k in
                               ("render", "decay", "feature_fn", "integrate", "env_step")}),
          goal=summary_ms(times["goal"]), idle=idle,
          gt=dict(summary=gt, app_ms=gt_ms), seconds=time.perf_counter() - t_phase)
    return counts


# --------------------------------------------------------------------------
# The open-loop app and the paper's two experiments with trained weights
# --------------------------------------------------------------------------

OPEN_LOOP_DEMO = "2"  # train_app's validation demo
OPEN_LOOP_STEPS = 100  # the app's sampler: DDPM at the training timestep count
# (task, closed_loop sampler options, denoising steps per goal): the
# protocols of tests/test_task_success.py:116-170.
TASK_SUCCESS = (
    ("cube_stacking", {}, 100),
    ("mug_in_drawer", dict(num_inference_steps=10, scheduler="ddim"), 10),
    ("drill_in_box", dict(num_inference_steps=10, scheduler="ddim", timestep_spacing="trailing"),
     10),
    ("stick_in_bin", dict(num_inference_steps=20, scheduler="ddpm"), 20),
)
TASK_SUCCESS_SEED = 21  # the fixtures' training scenes
TASK_SUCCESS_DEMOS = 8
TASK_SUCCESS_SUBSET = [0, 1, 2, 3]
SPATIAL_MEMORY_SEED = 100
SPATIAL_MEMORY_DEMOS = 3
SPATIAL_MEMORY_SEEDS = 3  # eval_seeds: the rows of one sampler call per keypose
FIXTURES = os.path.join(ROOT, "tests", "test_data")
# The flash shapes (B, H, L, S, D, masked) the new phases gave the kernels.
PATH_SHAPES = set()


def per_sample(T):
    """Flash launches of one sample or goal of a T-step sampler."""
    return {"flash_attention_split": 3 + 2 * T, "flash_attention_tile": 8 * T}


def add_launches(total, counts):
    for kernel, n in counts.items():
        total[kernel] = total.get(kernel, 0) + n


class recording_shapes:
    """Within the block, every kernel launch's (B, H, L, S, D, masked) goes
    into PATH_SHAPES (the kernels themselves run as before). On leaving, the
    launches recorded must equal the launches the kernels counted, so a
    recorder that the path went round fails the run."""

    def __enter__(self):
        from nvblox_mindmap_torch.ops import flash_attention as fa

        self.fa, self.original = fa, fa.run_kernel
        self.recorded, self.before = 0, sum(fa.KERNEL_LAUNCHES.values())

        def recording(name, q, k, v, key_padding_mask=None):
            B, H, L, D = q.shape
            if L > 0:  # run_kernel launches nothing for no queries
                PATH_SHAPES.add((B, H, L, k.shape[2], D, key_padding_mask is not None))
                self.recorded += 1
            return self.original(name, q, k, v, key_padding_mask)

        fa.run_kernel = recording
        return self

    def __exit__(self, exc_type, *exc):
        self.fa.run_kernel = self.original
        launched = sum(self.fa.KERNEL_LAUNCHES.values()) - self.before
        if exc_type is None and (launched == 0 or self.recorded != launched):
            raise AssertionError(f"recording_shapes: {self.recorded} of {launched} "
                                 "kernel launches recorded")
        return False


def ply_vertex_count(path):
    with open(path) as f:
        header = []
        for line in f:
            header.append(line.strip())
            if line.strip() == "end_header":
                break
        body = sum(1 for line in f if line.strip())
    count = int(next(h for h in header if h.startswith("element vertex")).split()[-1])
    if count != body:
        raise AssertionError(f"{path}: header says {count} vertices, body has {body}")
    return count


def run_open_loop_app(data, ckpt_dir):
    """Phase ``open_loop_app``: ``apps/run_open_loop_policy.py`` on
    train_app's dataset with its best.ckpt: the app's flagship
    (rgbd_and_mesh, the ego camera at IMAGE, 2048 of 4096 768-d vertices,
    width 120, 8 heads), DDPM-100 over the validation demo's keyposes. Then
    one sample with ``--ply_output_dir``. Returns each kernel's launches over
    the app's run."""
    import itertools
    import json
    from unittest import mock

    import numpy as np
    import torch

    from nvblox_mindmap_torch.apps import run_open_loop_policy as app
    from nvblox_mindmap_torch.mapping.constants import get_workspace_bounds
    from nvblox_mindmap_torch.models.converter import (
        apply_inference_settings,
        convert_to_flash_attention,
    )
    from nvblox_mindmap_torch.models.diffuser_actor import prepare_inputs
    from nvblox_mindmap_torch.ops.attention import set_default_attention_impl

    t_phase = time.perf_counter()
    # For ModelArgs the checkpoint's frozen args win over the command line,
    # and only_sample_keyposes is one of them: beside a link to best.ckpt,
    # frozen args that sample the keyposes only.
    frozen_dir = os.path.join(os.path.dirname(data), "open_loop_checkpoint")
    os.makedirs(frozen_dir)
    os.symlink(os.path.join(ckpt_dir, "best.ckpt"), os.path.join(frozen_dir, "best.ckpt"))
    with open(os.path.join(ckpt_dir, "training_args.json")) as f:
        frozen = json.load(f)
    frozen["only_sample_keyposes"] = True
    with open(os.path.join(frozen_dir, "training_args.json"), "w") as f:
        json.dump(frozen, f)
    argv = ["--dataset", data, "--task", APP_TASK, "--demos_open_loop", OPEN_LOOP_DEMO,
            "--only_sample_keyposes", "1", "--checkpoint",
            os.path.join(frozen_dir, "best.ckpt")]

    samples = []
    run_inference = app.run_inference

    def timed(infer, model, batch, seed):
        before = flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_inference(infer, model, batch, seed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = flash_counts()
        samples.append(dict(ms=ms, launches={k: after[k] - before[k] for k in after},
                            infer=infer, model=model, batch=batch, seed=seed,
                            trajectory=out["trajectory"]))
        return out

    reset_flash_counts()
    with mock.patch.object(app, "run_inference", timed), recording_shapes():
        means = app.main(argv)
    counts = flash_counts()
    n = len(samples)
    expected = per_sample(OPEN_LOOP_STEPS)
    if n < 2 or any(x["launches"] != expected for x in samples) or counts != {
            k: n * v for k, v in expected.items()}:
        raise AssertionError(f"open_loop_app: {counts} flash launches over {n} samples, "
                             f"each {[x['launches'] for x in samples]}, expected {expected}")
    values = [v for m in means.values() for v in (m if isinstance(m, list) else [m])]
    if any(v is None or not np.isfinite(v) for v in values):
        raise AssertionError(f"open_loop_app: metrics {means}")

    # One sample through the kernels vs eager attention with the same noise,
    # its token counts (the app's flagship), and its device idle share.
    first = samples[0]
    infer, model, batch, seed = first["infer"], first["model"], first["batch"], first["seed"]
    with torch.no_grad():
        fixed = model.encode_prepared(prepare_inputs(batch, get_workspace_bounds(APP_TASK), model.config,
                                                     device="cuda"), impl="eager")
    tokens = (fixed["context_feats"].shape[1], 1 + fixed["fps_feats"].shape[1])
    if tokens != (APP_CONTEXT, APP_SELF):
        raise AssertionError(f"open_loop_app: context and self-attention tokens {tokens}")
    del fixed
    set_default_attention_impl("eager")
    traj_eager = infer(batch, seed)[0].cpu().numpy()
    apply_inference_settings(convert_to_flash_attention())
    err = float(np.abs(first["trajectory"] - traj_eager).max())
    if not (err <= TRAJ_ATOL and np.isfinite(first["trajectory"]).all()):
        raise AssertionError(f"open_loop_app: flash vs eager sample {err} > {TRAJ_ATOL}")
    times = [x["ms"] for x in samples]
    prof = profile(lambda: infer(batch, seed), statistics.median(times))
    set_default_attention_impl("eager")

    # --ply_output_dir on the first sample: eager attention, three clouds.
    class FirstSample:
        def __init__(self, loader):
            self.loader, self.dataset = loader, loader.dataset

        def __iter__(self):
            return itertools.islice(iter(self.loader), 1)

    make_loader = app.get_data_loader_by_data_type

    def first_sample(*args, **kwargs):
        loader, sampler = make_loader(*args, **kwargs)
        return FirstSample(loader), sampler

    ply = os.path.join(os.path.dirname(data), "open_loop_ply")
    reset_flash_counts()
    with mock.patch.object(app, "get_data_loader_by_data_type", first_sample):
        ply_ms = host_ms(lambda: app.main(argv + ["--ply_output_dir", ply]))
    ply_counts = flash_counts()
    clouds = {name: ply_vertex_count(os.path.join(ply, name)) for name in sorted(os.listdir(ply))}
    want = {"sample_0000_features.ply": VERTICES, "sample_0000_attention.ply": VERTICES,
            "sample_0000_prediction.ply": 1}
    if clouds != want or any(ply_counts.values()):
        raise AssertionError(f"open_loop_app --ply_output_dir: clouds {clouds}, "
                             f"flash launches {ply_counts}")
    del samples, first, infer, model, batch
    torch.cuda.empty_cache()
    phase("open_loop_app", task=APP_TASK, model="rgbd_and_mesh", cameras=1, image=IMAGE,
          context_tokens=tokens[0], self_attention_tokens=tokens[1], vertices=VERTICES,
          feature_dim=FEATURE_DIM, sampler=f"ddpm{OPEN_LOOP_STEPS}", demos=OPEN_LOOP_DEMO,
          samples=n, launches=counts, launches_per_sample=expected,
          flash_vs_eager_max_abs_err=err, means=means, sample=summary_ms(times),
          profile=prof, ply=dict(clouds=clouds, ms=ply_ms, flash_launches=ply_counts),
          seconds=time.perf_counter() - t_phase)
    return counts


def init_worker(workers):
    """A worker process of ``run_experiments``: the parent's matmul flags,
    the machine's cores shared among the workers, and the worker's output
    on stderr (stdout's phase lines are the parent's)."""
    threads = str(max(1, (os.cpu_count() or 1) // workers))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = threads
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    import torch

    torch.set_num_threads(int(threads))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def task_success_one(task, serving, T):
    """One task of phase ``task_success``: the committed trained fixture of
    the task (width 72, 8 heads, 512 sampled vertices) through the
    task-success experiment's ``closed_loop`` stage on 4 of the 8 scenes
    that the port's generator rebuilds (seed 21), with the sampler of the
    task's slow test. The bar of those tests: success in at least one
    scene, and at least half a lifted cube per scene on cube_stacking.
    Returns the phase's row, the task's launches and the flash shapes."""
    from unittest import mock

    import torch

    from nvblox_mindmap_torch.closed_loop import policies, runner
    from nvblox_mindmap_torch.scripts import task_success_experiment as exp

    t_task = time.perf_counter()
    root = tempfile.mkdtemp(prefix=f"mindmap_task_success_{task}_")
    try:
        t0 = time.perf_counter()
        exp._generator_for_task(task)(os.path.join(root, "ds"), TASK_SUCCESS_DEMOS,
                                      TASK_SUCCESS_SEED)
        gen_s = time.perf_counter() - t0
        times = {"goal": [], "episode": []}

        def timed(name, fn):
            def wrapper(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = fn(*args, **kwargs)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
                return result
            return wrapper

        Policy = policies.NvbloxDiffuserActorPolicy
        reset_flash_counts()
        with mock.patch.object(Policy, "get_new_goal", timed("goal", Policy.get_new_goal)), \
                mock.patch.object(runner, "run_one_episode",
                                  timed("episode", runner.run_one_episode)), \
                recording_shapes():
            summary = exp.closed_loop(
                root, TASK_SUCCESS_DEMOS, os.path.join(FIXTURES, "task_success", task,
                                                       "last.ckpt"),
                demos_subset=TASK_SUCCESS_SUBSET, task=task, device="cuda", **serving)
        counts = flash_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    goals = len(times["goal"])
    expected = {k: goals * v for k, v in per_sample(T).items()}
    if counts != expected:
        raise AssertionError(f"task_success {task}: {counts} flash launches over "
                             f"{goals} goals, expected {expected}")
    if summary["num_demos"] != len(TASK_SUCCESS_SUBSET) or not summary["success_rate"] > 0:
        raise AssertionError(f"task_success {task}: {summary}")
    if task == "cube_stacking" and not summary["mean_num_lifted_cubes"] >= 0.5:
        raise AssertionError(f"task_success {task}: {summary}")
    sampler = f"{serving.get('scheduler', 'ddpm')}{T}" + (
        f"_{serving['timestep_spacing']}" if "timestep_spacing" in serving else "")
    row = dict(task=task, fixture=f"tests/test_data/task_success/{task}/last.ckpt",
               scenes=TASK_SUCCESS_SUBSET, seed=TASK_SUCCESS_SEED, sampler=sampler,
               success_rate=summary["success_rate"],
               num_successes=summary.get("num_successes"),
               summary=summary, goals=goals, launches=counts,
               launches_per_goal=per_sample(T), goal=summary_ms(times["goal"]),
               episodes=len(times["episode"]),
               episode=summary_ms(times["episode"]), generate_s=gen_s,
               seconds=time.perf_counter() - t_task)
    return row, counts, sorted(PATH_SHAPES)


def spatial_memory_one():
    """Phase ``spatial_memory``: three panning demos (seed 100, 64x64)
    generated and fused by the port, then ``eval_pick_keypose_error`` of
    the committed mesh and rgbd fixtures (width 72, DDPM-100, 3 seeds per
    keypose as the rows of one sampler call). The bar of
    tests/test_spatial_memory.py:188-192: mesh < 0.06 m, rgbd > 0.08 m and
    rgbd > 2x mesh. Returns the phase's fields, the launches over the
    evaluations and the flash shapes."""
    from unittest import mock

    import torch

    from nvblox_mindmap_torch.scripts import spatial_memory_experiment as sm

    t_phase = time.perf_counter()
    launches = {}
    results = {}
    root = tempfile.mkdtemp(prefix="mindmap_spatial_memory_")
    try:
        ds = os.path.join(root, "demos")
        t0 = time.perf_counter()
        demos = sm.generate_panning_demos(ds, SPATIAL_MEMORY_DEMOS, seed=SPATIAL_MEMORY_SEED,
                                          image_size=64)
        sm.fuse_demos(demos, device="cuda")
        gen_fuse_s = time.perf_counter() - t0
        for data_type in ("mesh", "rgbd"):
            calls = []
            make = sm.make_infer_fn

            def counting(model, bounds, make=make, calls=calls):
                infer = make(model, bounds)

                def wrapper(batch, seeds):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = infer(batch, seeds)
                    torch.cuda.synchronize()
                    calls.append((time.perf_counter() - t0) * 1e3)
                    return out
                return wrapper

            reset_flash_counts()
            with mock.patch.object(sm, "make_infer_fn", counting), recording_shapes():
                res = sm.eval_pick_keypose_error(
                    ds, demos, os.path.join(FIXTURES, "spatial_memory", f"{data_type}_last.ckpt"),
                    data_type, embedding_dim=72, eval_seeds=SPATIAL_MEMORY_SEEDS, device="cuda")
            counts = flash_counts()
            expected = {k: len(calls) * v for k, v in per_sample(OPEN_LOOP_STEPS).items()}
            if counts != expected:
                raise AssertionError(f"spatial_memory {data_type}: {counts} flash launches over "
                                     f"{len(calls)} keyposes, expected {expected}")
            add_launches(launches, counts)
            results[data_type] = dict(res, launches=counts, sample=summary_ms(calls))
        floor = sm.mean_predictor_floor(demos)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    mesh, rgbd = (results[t]["pick_keypose_error_m"] for t in ("mesh", "rgbd"))
    if not (mesh < 0.06 and rgbd > 0.08 and rgbd > 2.0 * mesh):
        raise AssertionError(f"spatial_memory: mesh {mesh} m, rgbd {rgbd} m (floor {floor})")
    fields = dict(demos=SPATIAL_MEMORY_DEMOS, seed=SPATIAL_MEMORY_SEED, image=64,
                  eval_seeds=SPATIAL_MEMORY_SEEDS, sampler=f"ddpm{OPEN_LOOP_STEPS}",
                  mesh_pick_error_m=mesh, rgbd_pick_error_m=rgbd, rgbd_over_mesh=rgbd / mesh,
                  mean_predictor_floor_m=floor, results=results, generate_and_fuse_s=gen_fuse_s,
                  seconds=time.perf_counter() - t_phase)
    return fields, launches, sorted(PATH_SHAPES)


def run_experiments():
    """Phases ``task_success`` (one worker process per task) and
    ``spatial_memory`` (a fifth), side by side in spawned workers. Each is
    host-bound (the scene world's render, the samplers' dispatch: the card
    idles ~0.9 of the time), so together they take about the time of the
    longest; their host times are measured with the others running.
    Returns each kernel's launches over all five."""
    import concurrent.futures
    import multiprocessing

    workers = len(TASK_SUCCESS) + 1
    launches = {}
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=init_worker, initargs=(workers,)) as pool:
        tasks = [pool.submit(task_success_one, *task) for task in TASK_SUCCESS]
        spatial = pool.submit(spatial_memory_one)
        for future in tasks:
            row, counts, shapes = future.result()
            add_launches(launches, counts)
            PATH_SHAPES.update(map(tuple, shapes))
            phase("task_success", workers=workers, **row)
        fields, counts, shapes = spatial.result()
    add_launches(launches, counts)
    PATH_SHAPES.update(map(tuple, shapes))
    phase("spatial_memory", workers=workers, **fields)
    return launches


def check_path_shapes(checks):
    """Every shape the new phases gave the kernels that no kernel_check row
    has held yet: held against the plain version now (phase
    ``kernel_check``, what = ``path_shape``)."""
    import torch

    held = {(r["B"], r["H"], r["L"], r["S"], r["D"], r["masked"]) for r in checks.values()
            if "B" in r and r.get("dtype") == "float32"}
    gen = torch.Generator(device="cuda").manual_seed(4)
    for shape in sorted(PATH_SHAPES - held):
        checks[("path_shape", shape)] = kernel_row("path_shape", *shape, gen)
    return sorted(PATH_SHAPES)


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
    measure_threshold()
    measure_vit()
    launches = {}
    for data_type, reps in (("mesh", (4, 20)), ("rgbd_and_mesh", (6, 24))):
        path_launches = run_slice(data_type, reps)
        for kernel, n in path_launches.items():
            launches[kernel] = launches.get(kernel, 0) + n
    check_mapper()
    measure_fusion()
    for kernel, n in run_closed_loop().items():
        launches[kernel] = launches.get(kernel, 0) + n
    train_launches, resident_step_ms = run_training_phase(smi)
    for kernel, n in train_launches.items():
        launches[kernel] = launches.get(kernel, 0) + n
    work = tempfile.mkdtemp(prefix="mindmap_loop_")
    try:
        for kernel, n in run_train_app(resident_step_ms, work).items():
            launches[kernel] = launches.get(kernel, 0) + n
        npz = os.path.join(work, "radio_v25_b.npz")
        save_random_backbone(npz)
        dataset = os.path.join(work, "dataset")
        run_datagen_app(dataset, npz)
        for kernel, n in run_closed_loop_app(dataset, os.path.join(work, "best.ckpt"),
                                             npz).items():
            launches[kernel] = launches.get(kernel, 0) + n
    finally:
        shutil.rmtree(work, ignore_errors=True)
    add_launches(launches, run_experiments())
    phase("path_shapes", shapes=[dict(zip(("B", "H", "L", "S", "D", "masked"), shape))
                                 for shape in check_path_shapes(checks)])

    # Each kernel at the flagship shape it serves most; beside it, its time
    # at the mesh path's shape, which the line reported before the flagship
    # was ported.
    main_shapes = {
        "flash_attention_split": (("flagship_denoiser_cross", 1),
                                  "flagship denoiser cross-attention B=1 H=8 L=1 S=4096 "
                                  "D=15 masked", ("denoiser_cross", 1),
                                  "mesh denoiser cross-attention B=1 H=8 L=1 S=2048 D=15 "
                                  "masked", ("app_denoiser_cross", TRAIN_BATCH),
                                  f"training app eval denoiser cross-attention B={TRAIN_BATCH} "
                                  f"H=8 L=1 S={APP_CONTEXT} D=15 masked"),
        "flash_attention_tile": (("flagship_self", 1),
                                 "flagship self-attention B=1 H=8 L=S=820 D=15 masked",
                                 ("self", 1),
                                 "mesh self-attention B=1 H=8 L=S=410 D=15 masked",
                                 ("app_self", TRAIN_BATCH),
                                 f"training app eval self-attention B={TRAIN_BATCH} H=8 "
                                 f"L=S={APP_SELF} D=15 masked"),
    }
    entries = []
    # And at the trained fixtures' shape (width 72: D = 9), which the
    # task_success and spatial_memory phases serve.
    fixture_shapes = {
        "flash_attention_split": (("fixture_denoiser_cross", 1), "fixture denoiser "
                                  "cross-attention B=1 H=8 L=1 S=512 D=9 masked"),
        "flash_attention_tile": (("fixture_self", 1), "fixture self-attention B=1 H=8 "
                                 "L=S=129 D=9 masked"),
    }
    for kernel, (key, shape, mesh_key, mesh_shape, app_key, app_shape) in main_shapes.items():
        fixture_key, fixture_shape = fixture_shapes[kernel]
        row = checks[key]
        entries.append({
            "name": kernel,
            "route": "cuda",
            "source": f"nvblox_mindmap_torch/csrc/{kernel}.cu",
            "replaces": "nvblox_mindmap_tpu/ops/flash_attention.py:43",
            "launches": launches[kernel],
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
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
