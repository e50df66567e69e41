#!/usr/bin/env python3
"""Drive the torch port's keypose prediction, live mapping, closed-loop
policy, training, its training, open-loop, datagen and closed-loop apps,
the task-success and spatial-memory experiments and the place-grounding
probe with the committed trained policies, training from a packed epoch and
under torchrun, batched serving, the CLIP ResNet-50 FPN extractor through
the loop, the language layers, the map's triangle mesh, dense views and
the visualization, USD, video and dataset tools, the closed loop through the
simulator bridge with the Isaac Lab adapter served over it, and the decoder
API, demo tools and workflow specs, and the rest of the JAX package's
public surface (the goal-gripper query, the attention variants, the
profiler trace, the rotations), on one NVIDIA GPU.

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
   for bf16 inputs too, and at the language layers' shapes over a 53-token
   instruction (L = 4096, 1 and 820, masked and unmasked, B = 1 and 8);
   and times both kernels at L = 1..8 (phase ``threshold``: the
   measurement behind the split kernel's limit); holds the FPS kernel
   (``csrc/fps.cu``) to the eager loop on the card, picks and running
   distances bit for bit, one launch a call, and times both beside the
   kernel's bound at the cells', the flagship's and the fixtures' shapes
   (phase ``fps_kernel``; the closed-loop and train phases check one FPS
   launch a goal and a step);
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
   matches eager attention (phase ``closed_loop``); then times
   ``sample_trajectory`` at the goal cells' shapes (B = 1, 3072 keys,
   DDIM-10), the eager denoiser loop against its CUDA graph replay, bit
   for bit and launch for launch (phase ``sampler_graph``);
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
   feature, attention and prediction clouds. Then phase ``packed_train``:
   ``scripts/pack_dataset`` packs 4 batches of that dataset (each equal to
   the streaming loader's, bit for bit), they are staged on the card, a
   step from a staged batch is held to the host-fed step, the app trains
   20 steps from the packed epoch (no flash launch) and evaluates one
   batch (3 + 2*10, 8*10); it prints the materialize and staging seconds,
   the bytes per key, the packed-fed step against the device-only step
   of the same model, the batch wait and idle shares, and an asynchronous
   save of the trainer's state (its return and write times) restored bit
   for bit. Then the torchrun run of phase ``ddp`` starts (12);
10. side by side with 11, with the torchrun run of 12 and with 17-19 in
   this process, one worker process per task (each is host-bound), runs
   the task-success experiment's ``closed_loop`` stage (phase
   ``task_success``) for each of the four committed trained fixtures
   (``tests/test_data/task_success/<task>/last.ckpt``: width 72, 8 heads,
   512 sampled vertices) on 4 of the 8 scenes the port's generator
   rebuilds from seed 21: cube_stacking at DDPM-100, mug_in_drawer at
   DDIM-10, drill_in_box at DDIM-10 with trailing spacing, stick_in_bin at
   DDPM-20. Each task must succeed in at least one scene (cube_stacking:
   at least half a lifted cube per scene) and every goal must launch
   3 + 2*T split and 8*T tile calls; it prints the success rate, goal and
   episode times;
11. generates and fuses three panning demos (seed 100, 64x64) and runs
   ``eval_pick_keypose_error`` of the committed spatial-memory fixtures
   (phase ``spatial_memory``): mesh under 0.06 m, rgbd over 0.08 m and
   over twice the mesh error; each keypose's 3 seeds are one DDPM-100
   call of 3 rows; and, in a sixth worker, runs
   ``scripts/place_grounding_probe`` with the committed cube_stacking
   fixture over 8 fresh scenes (phase ``place_grounding``: every goal
   3 + 2*100 split and 8*100 tile launches; it prints the summary's
   slopes, correlations and release errors);
12. waits for the torchrun run (phase ``ddp``): the packed app run again
   under ``python -m torch.distributed.run --nproc_per_node 1`` (NCCL, world
   size 1) with ``--checkpoint_backend orbax``; its losses must equal the
   in-process run's within 1e-5 relative, its validation loss, distance and
   rotation error the in-process run's as printed (6 decimals), its
   ``last/`` must load at the
   last step with the in-process run's parameters (DDP_PARAM_ATOL), and a
   run resumed from it must continue from its iteration. At one rank the
   validation check holds the launch and the printed line: both runs take
   the trainer's one eval path (``shard_batch`` and the sampler noise of
   ``_eval_noise``) on the card, but nothing is split over ranks here; the
   split of an eval batch over ranks is held under gloo on the CPU
   (``tests/test_torch_parallel.py``);
13. records one cube_stacking demo with the port's scripted expert in the
   port's scene world at 512x512 (the table camera as 'wrist', with
   segmentation and a scene.json) and runs the datagen app
   (``apps/run_datagen.py``, phase ``datagen_app``) on it: the task's
   mapping config scaled for 512, 768-d features from the seeded random
   RADIO ViT-B/16 .npz, 12 frames, the serialized map. Every frame's item
   must read back with 768-d fp16 features and the map file must reload
   equal to the live map, bit for bit. It prints the per-part times per
   frame and the card's idle share. Then phase ``reconstruction`` reads
   that map file on the card: ``Mapper.update_color_mesh`` with the device
   and the host backend must give the same vertex and triangle counts
   (printed against the budgets), vertices within 1e-5, colors within
   1e-6 and the same triangle set; the same file on the CPU must give the
   card's mesh (vertices within 1e-6) and dense views exactly; it prints
   host-clock p50s of the device and the numpy Surface Nets, each
   backend's whole ``update_color_mesh`` and the dense views
   (``features_dense`` at 768-d, ``colors_dense``, ``tsdf_dense``) beside
   their byte bounds, and peak memory; runs ``visualize_nvblox_tensors``,
   ``generate_reconstruction_figures``, ``convert_maps_usd``,
   ``make_mp4_from_dataset`` (rgb and depth), ``video_from_depth`` and
   ``visualize_keyposes`` on the demo, decoding every PNG they write; and
   ``datasets_are_close`` must hold the demo close to a copy of itself and
   not to a copy with one item changed;
14. runs the closed-loop app (``apps/run_closed_loop_policy.py``, phase
   ``closed_loop_app``) on that demo in the scene world with the training
   app's best.ckpt: the app's flagship (``rgbd_and_mesh``, the ego camera at
   512, 2048 sampled 768-d vertices, RADIO mapping features: 3072 context
   tokens, 615 in self-attention), DDIM-10, 4 steps to a goal, 24 steps.
   Every goal must launch 3 + 2*10 split and 8*10 tile calls, a goal through
   the kernels must match eager attention and the eval file must be written;
   then the ground-truth goals on the same demo must stack the cubes
   (success 1.0). It prints sim-step and goal times, the step's parts (the
   scene render apart) and the idle share. Then phase ``remote_loop`` runs
   the same app, demo, checkpoint and backbone with its world behind the
   port's simulator bridge: a spawned sim host (no torch) serves the demo's
   scene world on loopback through ``serve_environment`` and the app steps a
   ``RemoteEnvironment``. Its goals must equal the in-process run's bit for
   bit, its success too, and every goal launch 23 + 80 flash calls; it
   prints the sim step through the bridge beside the in-process one, the
   bridge's own ms and MB per step, the goal p50 and the idle share; then
   ``IsaacLabEnvironment`` over a recording stand-in gym env, arm and
   humanoid, served through the bridge a few steps each: every action a CPU
   (1, 8) / (1, 37) tensor, the 37-d ones round-tripping through
   ``HumanoidAction``. Then phase ``runtime_tools`` (host work):
   ``runtime.decode_png_batch`` over the demo's PNGs at 1 / 4 / 8 threads
   equal to one-by-one decoding, ``decode_zstd_pickle`` on its items,
   ``benchmark_decompression`` at its defaults, ``tar_demos`` there and
   back with every byte equal, the HTML report of the eval file,
   ``plot_humanoid_keyposes`` on a demo of the port's humanoid recorder,
   ``hdf5_tools`` and the workflow specs;
15. serves 8 flagship requests per call (phase ``serving``): the flagship
   model (2 cameras, 4096 context and 820 self-attention tokens) through
   ``parallel/serving.make_sharded_infer_fn``, DDIM-10: the p50 per call,
   keyposes per second and the idle share; each call 3 + 2*10 split and
   8*10 tile launches, flash vs eager within 5e-3, each row within 1e-4 of
   the same request served alone, the parameters copied once;
16. holds against the plain version every flash shape that the open-loop
   app, task-success and spatial-memory phases gave the kernels and no
   earlier row held (``kernel_check`` rows ``path_shape``; phase
   ``path_shapes`` lists them all);
17. holds the CLIP ResNet-50 FPN extractor (phase ``clip_extractor``: a
   seeded random CLIP RN50 trunk converted by the port's converter, with an
   FPN) on the card against the CPU, times it at B = 2 and 32 beside its
   FLOP bound (IEEE fp32, and with TF32 allowed), and checks that one
   backward pass reaches only the FPN levels that res3 reads;
18. runs the loop with ``--feature_type clip_resnet50_fpn`` (phase
   ``clip_loop``): the datagen app writes 120-d features for every frame
   of three 512x512 demos; the training app trains the app's flagship
   (B = 32) 8 steps with the FPN training, the trunk bit for bit, and
   evaluates one batch (23 + 80 launches); ``extract_fpn_from_model`` takes
   best.ckpt's FPN into an .npz whose ``make_feature_fn`` gives the trained
   extractor's features; the closed-loop app runs best.ckpt in the replay
   world, every goal 23 + 80 launches;
19. predicts with the flagship (2 cameras, 4096 context and 820
   self-attention tokens) with ``use_instruction`` and ``lang_enhanced`` and
   a (B, 53, 512) instruction (phase ``language``), DDIM-10 at B = 1 and 8:
   33 split + 132 tile launches per prediction, flash against eager
   attention (atol 5e-3) from one encoding and where the FPS picks of the
   two encodings agree;
20. runs the rest of the JAX package's public surface on the card (phase
   ``api_surface``): the flagship's ``Encoder.encode_goal_gripper`` at
   B = 1 and 8 (3 split launches per call, flash against eager within
   5e-3, p50s), ``MultiheadAttention`` with each variant (slot competition,
   gated memory with and without its mask, ``return_kv``) under the flash
   impl with no launch and the CPU's result, a ``ProfilerTrace`` of one
   flagship DDIM-10 prediction naming each kernel as often as its counter
   (23 + 80), and the rotation conversions against the CPU;
21. prints one JSON line of per-kernel numbers, then ``{"ok": true, ...}``
   as the last line.

Any failure raises, and the script exits non-zero without the last line.
It exits non-zero as well when no CUDA device is present or the package is
not beside it: a copy of the script on its own refuses to run.
"""
from __future__ import annotations

import json
import math
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


def fps_launches():
    """The FPS kernel's launches in this process since the last reset."""
    from nvblox_mindmap_torch.ops.fps import farthest_point_sampling

    return farthest_point_sampling.launches


def reset_fps_launches(to=0):
    from nvblox_mindmap_torch.ops.fps import farthest_point_sampling

    farthest_point_sampling.launches = to


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


def device_events(prof):
    """The device's own work in a profile's ``key_averages()``: kernels,
    copies and memsets. A ``record_function`` range (``BACKBONE_RANGE``,
    the program's ``mindmap/`` spans) shows there too, as a device-side
    annotation whose time is the whole range's: those are left out."""
    from torch.autograd import DeviceType

    from nvblox_mindmap_torch.utils.timers import SPAN_PREFIX

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and e.key != BACKBONE_RANGE and not e.key.startswith(SPAN_PREFIX)]


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
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in device_events(prof)]
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
    # over its 4096 context tokens and 1 + 819 FPS tokens, and its goal-gripper
    # query (L=1, no mask; phase api_surface). D=9: the committed fixtures
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
    # The language layers over a 53-token instruction (phase language): the
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

    # Feature-space FPS at the path's context size: N // 5 samples. These
    # timing calls are not the path's: the count goes back to the path's.
    path_fps = fps_launches()
    N = CONTEXT[data_type]
    for B in (1, 8):
        feats = torch.randn(B, N, EMBEDDING, device="cuda")
        k = N // FPS_FACTOR
        fps_ms, q1, q3 = quartiles([host_ms(lambda: farthest_point_sampling(feats, k))
                                    for _ in range(10)])
        phase("fps", path=data_type, B=B, N=N, C=EMBEDDING, samples=k, p50_ms=fps_ms,
              q1_ms=q1, q3_ms=q3)
    reset_fps_launches(path_fps)
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
    from nvblox_mindmap_torch.ops.fps import farthest_point_sampling

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
    fps_before = farthest_point_sampling.launches
    goal_times, goal_states = [], []
    for _ in range(goals):
        goal_times.append(host_ms(lambda: goal_states.append(policy.get_new_goal(env))))
    torch.cuda.synchronize()
    fps_calls = farthest_point_sampling.launches - fps_before
    if fps_calls != goals:
        raise AssertionError(f"closed_loop: {fps_calls} FPS kernel launches over {goals} "
                             "goals, expected one a goal")
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
          fps_launches_per_goal=fps_calls // goals,
          step=dict(p50_ms=step_p50, q1_ms=step_q1, q3_ms=step_q3, reps=steps,
                    parts={k: summary(v) for k, v in parts.items()}, profile=step_profile),
          goal=dict(p50_ms=goal_p50, q1_ms=goal_q1, q3_ms=goal_q3, reps=goals,
                    parts={k: summary(v) for k, v in goal_parts.items()},
                    profile=goal_profile))
    return by_kernel


# The goal cells' context: one camera's 1024 image tokens and 2048 vertices.
GOAL_KEYS = APP_CONTEXT
SAMPLER_GRAPH_REPS = 20


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

    rng = np.random.default_rng(0)
    batch = make_batch(1, "mesh")
    batch.update(vertices=rng.uniform(-0.3, 0.6, size=(1, GOAL_KEYS, 3)).astype(np.float32),
                 vertex_features=rng.normal(size=(1, GOAL_KEYS, FEATURE_DIM)).astype(np.float32),
                 vertices_valid_mask=np.ones((1, GOAL_KEYS), dtype=bool))
    torch.manual_seed(0)
    model = da.DiffuserActor(model_config("mesh"), device="cuda")
    bounds = np.asarray(WORKSPACE, dtype=np.float32)
    prepared = da.prepare_inputs(batch, bounds, model.config, device="cuda")
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
            reset_flash_counts()
            with eager_only() if path == "eager" else contextlib.nullcontext():
                times[path].append(host_ms(lambda: out.update(traj=predict()[0])))
            if (fa.flash_attention.launches != 3 + 10 * T
                    or dict(fa.KERNEL_LAUNCHES) != expected):
                raise AssertionError(f"sampler_graph: {path} made {fa.flash_attention.launches}"
                                     f" flash calls {dict(fa.KERNEL_LAUNCHES)}, expected "
                                     f"{3 + 10 * T} {expected}")
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
    from nvblox_mindmap_torch.ops.fps import farthest_point_sampling
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
    fps_before = farthest_point_sampling.launches
    for step in range(3, 3 + TRAIN_TIMED_STEPS):
        times.append(host_ms(lambda: step_losses.append(
            float(trainer.train_one_step(batches[step % 2], step)["total"]))))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fps_calls = farthest_point_sampling.launches - fps_before
    if fps_calls != TRAIN_TIMED_STEPS:
        raise AssertionError(f"train: {fps_calls} FPS kernel launches over "
                             f"{TRAIN_TIMED_STEPS} steps, expected one a step")
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
                    flash_launches=train_counts,
                    fps_launches_per_step=fps_calls // TRAIN_TIMED_STEPS,
                    losses=step_losses, profile=prof),
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


def write_app_dataset(root, seed=0, vertex_features=True):
    """Two train and one val demo of ``APP_FRAMES`` frames in the reference
    layout, written with the port's ``DemoWriter``: the ego camera's RGB
    and depth at 512x512 over the analytic scene (inside cube_stacking's
    workspace), its pose and intrinsics, the robot state, and (unless the
    datagen app is to write them) ``APP_STORED_VERTICES`` surface points of
    the frame with 768-d fp16 features. Returns (bytes written, seconds)."""
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
            if not vertex_features:
                continue
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
    import torch

    from nvblox_mindmap_torch.models.feature_extractors import make_feature_extractor
    from nvblox_mindmap_torch.models.weight_conversion import save_variables_npz
    from nvblox_mindmap_torch.models.weights import state_dict_to_flax

    torch.manual_seed(11)
    vit = make_feature_extractor("radio_v25_b", (PATCHES, PATCHES))
    save_variables_npz(path, {"params": state_dict_to_flax(vit.state_dict())})
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
                        for name in ("zstandard", "imageio", "PIL", "wandb", "matplotlib",
                                     "h5py")})


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
    the main path (the app runs and the prediction from best.ckpt) and the
    started run of phase ``ddp`` (``finish_ddp``); copies best.ckpt and
    training_args.json into ``keep_dir`` for the closed-loop app."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
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
    # Under keep_dir: the torchrun run of phase ddp reads the dataset and
    # its packed epoch after this function returns.
    root = tempfile.mkdtemp(prefix="mindmap_train_app_", dir=keep_dir)
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
    busy_ms = sum(e.self_device_time_total / 1e3 for e in device_events(prof))
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
    # The open-loop app on this dataset and checkpoint; then training from a
    # packed epoch of it, which starts the torchrun run.
    add_launches(launches, run_open_loop_app(data, ckpt_dir))
    packed_launches, ddp = run_packed_train(root, flags)
    add_launches(launches, packed_launches)
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
    return launches, ddp


# --------------------------------------------------------------------------
# Training fed from a packed epoch, data-parallel training, batched serving
# --------------------------------------------------------------------------

PACKED_BATCHES = 4  # bench.py's _bench_train_e2e packs a few batches too
PACKED_STEPS = 20  # of the packed-fed app run; its last step evaluates once
RESIDENT_STEPS = 8  # the same model on one staged batch: the device-only step
DDP_TIMEOUT_S = 420
# The torchrun run vs the in-process run, both on the card: the backward's
# atomic scatter-adds may sum in another order (RESUME_ATOL), so the losses
# are held relative, not bit for bit; and Adam steps a gradient that is zero
# up to rounding (the attention k-projection biases, a few single weights)
# by up to the app's learning rate (1e-4) whatever its sign: parameters
# within two such steps, and at most DDP_APART_SHARE of them beyond
# RESUME_ATOL.
DDP_LOSS_RTOL = 1e-5
DDP_PARAM_ATOL = 2e-4
DDP_APART_SHARE = 1e-3
SERVING_BATCH = 8
SERVING_CALLS = 10
LOSS_LINE = r"step (\d+)/\d+ \(epoch \d+\): total (-?[0-9.]+)"
# The trainer's validation line: step, loss, distance (m), rotation error (deg).
VAL_LINE = r"\[val\] step (\d+): loss (\S+), distance (\S+) m, rot err (\S+) deg"
VAL_PRINT_ATOL = 1e-6  # the line prints 6 decimals


def val_lines(text):
    """step -> (loss, distance, rotation error) of every validation line."""
    import re

    return {int(m[0]): tuple(float(v) for v in m[1:]) for m in re.findall(VAL_LINE, text)}


class loss_lines:
    """Within the block, the train losses that the trainer logs (step ->
    total), read from its progress lines as a torchrun run's are, and its
    validation lines (``val``: step -> loss, distance, rotation error)."""

    def __enter__(self):
        import logging
        import re

        class Handler(logging.Handler):
            def emit(handler, record):
                message = record.getMessage()
                match = re.search(LOSS_LINE, message)
                if match:
                    self.losses[int(match.group(1))] = float(match.group(2))
                self.val.update(val_lines(message))

        self.losses, self.val, self.handler = {}, {}, Handler()
        self.logger = logging.getLogger("nvblox_mindmap_torch.trainer")
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        return False


def run_packed_train(root, flags):
    """Phase ``packed_train``: ``scripts/pack_dataset`` materializes
    ``PACKED_BATCHES`` batches of the training app's loader; each equals the
    streaming loader's batch bit for bit; they are staged on the card; a
    step from a staged batch is held to the host-fed step on the same batch;
    the app trains ``PACKED_STEPS`` steps from the packed epoch (no flash
    launch) and evaluates one batch (23 + 80); then the device-only step of
    the same model and the idle share of packed-fed steps; an asynchronous
    save of its state restores bit for bit. Then it starts the torchrun run
    of phase ``ddp``. Returns each kernel's launches and that run."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from nvblox_mindmap_torch.apps import run_training as app
    from nvblox_mindmap_torch.data.packed import (
        PackedDeviceLoader,
        PackedEpoch,
        device_batch,
        stage_to_device,
    )
    from nvblox_mindmap_torch.scripts import pack_dataset
    from nvblox_mindmap_torch.training.orbax_checkpoint import OrbaxCheckpointer
    from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig
    from nvblox_mindmap_torch.utils import config, timers

    t_phase = time.perf_counter()
    per_batch = per_sample(EVAL_STEPS)
    launches = dict.fromkeys(per_batch, 0)
    packed = os.path.join(root, "packed")
    pack_flags = flags + ["--num_workers", str(APP_WORKERS[-1])]
    t0 = time.perf_counter()
    meta = pack_dataset.main(pack_flags + ["--packed_out", packed, "--packed_num_batches",
                                           str(PACKED_BATCHES)])
    materialize_s = time.perf_counter() - t0
    batch_bytes = {k: int(np.prod(v["batch_shape"])) * np.dtype(v["dtype"]).itemsize
                   for k, v in meta["keys"].items()}

    # Each packed batch is the streaming loader's (rgb back through /255).
    args = config.parse_args(pack_dataset.PackDatasetArgs, pack_flags)
    loader = app.build_loaders(args, app.make_embodiment_for_task(APP_TASK), skip_val=True)[0]
    stream = list(pack_dataset.loader_batches(loader, PACKED_BATCHES))
    epoch = PackedEpoch(packed)
    for i, host in enumerate(stream):
        got = epoch.batch(i)
        for k, v in host.items():
            same = got[k] is None if v is None else (
                got[k].dtype == v.dtype and np.array_equal(got[k], v))
            if not same:
                raise AssertionError(f"packed_train: batch {i} key {k} differs from the loader")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged_loader = PackedDeviceLoader(epoch, seed=0)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0

    # One step from a staged batch vs the host-fed step on the same batch
    # (uint8 RGB divided by 255 on the card vs float RGB from the loader).
    model_cfg = config.model_config_from_args(args, vertex_feature_dim=FEATURE_DIM)
    bounds = app.get_workspace_bounds(APP_TASK)
    staged0 = device_batch(stage_to_device(epoch, indices=[0]), 0)
    trainer = Trainer(model_cfg, TrainerConfig(batch_size=TRAIN_BATCH), bounds, device="cuda",
                      backbone_weights=args.backbone_weights)
    first = []
    for batch in (stream[0], staged0):
        trainer.init_state()
        first.append(float(trainer.train_one_step(batch, 0)["total"]))
    first_err = abs(first[0] - first[1])
    if first[0] != first[1]:  # the same inputs once on the card: bit for bit
        raise AssertionError(f"packed_train: first step {first[1]} (staged) vs {first[0]}")
    del trainer, staged0

    # The app, fed from the packed epoch.
    logs = os.path.join(root, "packed_logs")
    run_flags = flags + ["--packed_dataset", packed, "--train_iters", str(PACKED_STEPS),
                         "--val_freq", str(PACKED_STEPS)]
    timers.reset_timers()
    reset_flash_counts()
    with loss_lines() as run_losses:
        result = app.main(run_flags + ["--base_log_dir", logs])
    torch.cuda.synchronize()
    counts = flash_counts()
    if counts != per_batch:
        raise AssertionError(f"packed_train: {counts} flash launches, expected {per_batch}")
    add_launches(launches, counts)
    load = [t * 1e3 for t in timers.timer_samples("step/load_batch")[1:]]
    train = [t * 1e3 for t in timers.timer_samples("step/train")[1:]]
    fed = [a + b for a, b in zip(load, train)]
    fed_p50, fed_q1, fed_q3 = quartiles(fed)
    if sorted(run_losses.losses) != list(range(PACKED_STEPS)) or not all(
            np.isfinite(list(run_losses.losses.values()))):
        raise AssertionError(f"packed_train: logged losses {run_losses.losses}")
    trainer = result["trainer"]

    # The device-only step of the same model: one staged batch, resident.
    resident_batch = next(iter(staged_loader))
    resident = [host_ms(lambda: trainer.train_one_step(resident_batch, PACKED_STEPS + i))
                for i in range(RESIDENT_STEPS)]
    resident_p50 = statistics.median(resident[1:])

    # Device busy time over 3 packed-fed steps against their host-clock time.
    trainer.config = dataclasses.replace(trainer.config, train_iters=PACKED_STEPS + 3,
                                         save_checkpoint=False, val_freq=10 ** 9)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_training(staged_loader, None, start_iter=PACKED_STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total / 1e3 for e in device_events(prof))
    del staged_loader

    # The asynchronous backend at the flagship's size: save, wait, restore.
    ckptr = OrbaxCheckpointer(os.path.join(root, "orbax"))
    state, opt_state = trainer.model.state_dict(), trainer.optimizer.tensor_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckptr.save("last", state, opt_state, PACKED_STEPS, result["best_loss"])
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckptr.wait()
    wait_s = time.perf_counter() - t0
    restored = Trainer(model_cfg, trainer.config, bounds, device="cuda")
    restored.init_state()
    _, restored_opt, step, best = ckptr.restore("last", restored.model.state_dict(),
                                                restored.optimizer.tensor_state())
    restored.optimizer.load_tensor_state(restored_opt)
    if (step, best, restored.optimizer.count) != (PACKED_STEPS, result["best_loss"],
                                                  trainer.optimizer.count):
        raise AssertionError(f"packed_train: restored iter {step}, best {best}, count "
                             f"{restored.optimizer.count}")
    for name, value in restored.model.state_dict().items():
        if not torch.equal(value, state[name]):
            raise AssertionError(f"packed_train: restored {name} differs")
    for kind in ("exp_avg", "exp_avg_sq"):
        for name, value in restored_opt[kind].items():
            if not torch.equal(value, opt_state[kind][name]):
                raise AssertionError(f"packed_train: restored {kind} of {name} differs")
    ckpt_mb = sum(os.path.getsize(os.path.join(dirpath, f))
                  for dirpath, _, files in os.walk(os.path.join(root, "orbax"))
                  for f in files) / 1e6
    del restored, trainer, result
    torch.cuda.empty_cache()

    phase("packed_train", task=APP_TASK, batch=TRAIN_BATCH, packed_batches=meta["num_batches"],
          materialize_s=materialize_s, stage_s=stage_s,
          batch_bytes=batch_bytes, batch_mb=sum(batch_bytes.values()) / 1e6,
          staged_mb=sum(batch_bytes.values()) * meta["num_batches"] / 1e6,
          rgb_dtype=meta["keys"]["rgbs"]["dtype"], batches_equal_loader=len(stream),
          first_step_loss=dict(host_fed=first[0], staged=first[1], abs_diff=first_err,
                               bit_equal=first[0] == first[1]),
          steps=PACKED_STEPS, step_p50_ms=fed_p50, step_q1_ms=fed_q1, step_q3_ms=fed_q3,
          step_mean_ms=statistics.mean(fed), load_batch_p50_ms=statistics.median(load),
          train_p50_ms=statistics.median(train), load_batch_share=sum(load) / sum(fed),
          samples_per_s=TRAIN_BATCH / fed_p50 * 1e3, resident_step_p50_ms=resident_p50,
          resident_step_ms=resident, vs_device_only=resident_p50 / fed_p50,
          idle=dict(steps=3, wall_ms=wall_ms, device_busy_ms=busy_ms,
                    device_idle_share=1 - busy_ms / wall_ms),
          launches=dict(per_train_step=0, per_eval_batch=per_batch, run=counts),
          async_checkpoint=dict(mb=ckpt_mb, save_returns_s=save_s, wait_s=wait_s,
                                restored_bit_equal=True),
          seconds=time.perf_counter() - t_phase)
    if sorted(run_losses.val) != [PACKED_STEPS - 1]:
        raise AssertionError(f"packed_train: validation lines {run_losses.val}")
    ddp = start_ddp(root, run_flags, run_losses.losses,
                    os.path.join(logs, "checkpoints", "latest", "last.ckpt"), run_losses.val)
    return launches, ddp


def start_ddp(root, run_flags, losses, last_ckpt, val):
    """Start phase ``ddp``: the packed app run again under ``python -m
    torch.distributed.run`` (one rank: NCCL for the gradient all-reduce,
    gloo for the asynchronous checkpoint) with ``--checkpoint_backend
    orbax``, in a subprocess of its own session, its output to a file.
    ``finish_ddp`` waits for it and holds it to the in-process run
    (``losses``, ``last_ckpt``, the validation line ``val``)."""
    logs = os.path.join(root, "ddp_logs")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", "-m", "nvblox_mindmap_torch.apps.run_training"] + run_flags + [
           "--checkpoint_backend", "orbax", "--base_log_dir", logs]
    log = os.path.join(root, "ddp.log")
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                                stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
    return dict(proc=proc, t0=time.perf_counter(), root=root, logs=logs, log=log,
                run_flags=run_flags, losses=losses, last_ckpt=last_ckpt, val=val)


def stop_ddp(run):
    """Kill the torchrun run's whole session (its agent and worker)."""
    import signal

    if run is not None and run["proc"].poll() is None:
        os.killpg(run["proc"].pid, signal.SIGKILL)
        run["proc"].wait()


def finish_ddp(run):
    """Phase ``ddp``, once the torchrun run has ended: its losses must equal
    the in-process run's within DDP_LOSS_RTOL; its ``last/`` must load, at
    the last step, within DDP_PARAM_ATOL of the in-process run's
    ``last.ckpt``; a run resumed from it (in-process, without an
    evaluation) must continue from its iteration. Returns each kernel's
    launches (none: the resumed steps train)."""
    import re

    import torch

    from nvblox_mindmap_torch.apps import run_training as app
    from nvblox_mindmap_torch.training.checkpoint import load_checkpoint_file

    t_phase = time.perf_counter()
    root, logs, run_flags, losses = run["root"], run["logs"], run["run_flags"], run["losses"]
    try:
        code = run["proc"].wait(timeout=max(1.0, DDP_TIMEOUT_S - (t_phase - run["t0"])))
    finally:
        stop_ddp(run)
    run_s = time.perf_counter() - run["t0"]
    with open(run["log"]) as f:
        output = f.read()
    if code != 0:
        raise AssertionError(f"ddp: torchrun exited {code}:\n{output[-4000:]}")
    ddp_losses = {int(s): float(v) for s, v in re.findall(LOSS_LINE, output)}
    if sorted(ddp_losses) != sorted(losses):
        raise AssertionError(f"ddp: logged steps {sorted(ddp_losses)}")
    loss_err = max(abs(ddp_losses[s] - losses[s]) / abs(losses[s]) for s in losses)
    if not loss_err <= DDP_LOSS_RTOL:
        raise AssertionError(f"ddp: losses {ddp_losses} vs {losses}")
    # The validation lines, as printed: at one rank both runs take the same
    # eval path, so this holds the launch and the print, not a split.
    ddp_val = val_lines(output)
    if sorted(ddp_val) != sorted(run["val"]):
        raise AssertionError(f"ddp: validation lines {ddp_val} vs {run['val']}")
    val_err = max(abs(a - b) - DDP_LOSS_RTOL * abs(b) for s in ddp_val
                  for a, b in zip(ddp_val[s], run["val"][s]))
    if not val_err <= VAL_PRINT_ATOL:
        raise AssertionError(f"ddp: validation {ddp_val} vs the in-process {run['val']}")
    ckpt_dir = os.path.realpath(os.path.join(logs, "checkpoints", "latest"))
    written = sorted(os.listdir(ckpt_dir))
    if not {"best", "last", "training_args.json"} <= set(written):
        raise AssertionError(f"ddp: {ckpt_dir} holds {written}")

    # Resume from last/ (in this process, one rank): it continues at its
    # iteration, and trains only (no evaluation, no flash launch).
    reset_flash_counts()
    result = app.main(run_flags + ["--checkpoint_backend", "orbax", "--checkpoint",
                                   os.path.join(ckpt_dir, "last"), "--train_iters",
                                   str(PACKED_STEPS + 2), "--val_freq", str(10 ** 9),
                                   "--base_log_dir", os.path.join(root, "resume_logs")])
    torch.cuda.synchronize()
    counts = flash_counts()
    if any(counts.values()):
        raise AssertionError(f"ddp resume: {counts} flash launches, expected none")
    if (result["start_iter"], result["trainer"].optimizer.count) != (
            PACKED_STEPS - 1, PACKED_STEPS + 3):
        raise AssertionError(f"ddp resume: start {result['start_iter']}, updates "
                             f"{result['trainer'].optimizer.count}")
    from nvblox_mindmap_torch.training.trainer import Trainer

    restored = Trainer(result["trainer"].model_config, result["trainer"].config,
                       app.get_workspace_bounds(APP_TASK), device="cuda")
    step, best = restored.load_checkpoint(os.path.join(ckpt_dir, "last"))
    reference = load_checkpoint_file(run["last_ckpt"])
    if step != reference["iter"] or not abs(best - reference["best_loss"]) <= (
            DDP_LOSS_RTOL * abs(reference["best_loss"])):
        raise AssertionError(f"ddp: last/ at {step}, best {best}; in-process {reference['iter']}, "
                             f"{reference['best_loss']}")
    diffs = {name: (value.cpu() - reference["state_dict"][name]).abs()
             for name, value in restored.model.state_dict().items()}
    param_err = max(float(d.max()) for d in diffs.values())
    apart = sum(int((d > RESUME_ATOL).sum()) for d in diffs.values())
    apart_share = apart / sum(d.numel() for d in diffs.values())
    if not (param_err <= DDP_PARAM_ATOL and apart_share <= DDP_APART_SHARE):
        raise AssertionError(f"ddp: last/ parameters up to {param_err} from the in-process "
                             f"run's, {apart} elements beyond {RESUME_ATOL}")
    del restored, result
    torch.cuda.empty_cache()
    phase("ddp", launcher="torch.distributed.run --standalone --nproc_per_node 1",
          backend="cpu:gloo,cuda:nccl", world_size=1, steps=PACKED_STEPS, run_s=run_s,
          side_by_side_with="task_success, spatial_memory",
          losses_max_rel_diff=loss_err, losses_bit_equal=ddp_losses == losses,
          validation=dict(torchrun=ddp_val, in_process=run["val"],
                          equal_as_printed=ddp_val == run["val"]),
          checkpoint_backend="orbax", written=written, last_iter=step,
          last_params_max_abs_diff=param_err, last_params_apart=apart,
          last_params_apart_share=apart_share, best_loss=best,
          resumed=dict(start_iter=PACKED_STEPS - 1, updates=PACKED_STEPS + 3, launches=counts),
          seconds=time.perf_counter() - t_phase)
    return counts


def run_serving():
    """Phase ``serving``: flagship prediction (2 cameras, 4096 context and 820
    self-attention tokens, random weights) served at B = SERVING_BATCH,
    DDIM-10, through ``parallel/serving.make_sharded_infer_fn`` on the card:
    p50 and quartiles per call, keyposes per second, 23 + 80 launches per
    call, the idle share; flash vs eager within TRAJ_ATOL, each row against
    a B = 1 call with that row's noise within DENOISE_ATOL, the parameters
    copied once over the calls. Returns each kernel's launches."""
    import numpy as np
    import torch

    from nvblox_mindmap_torch.models.converter import (
        apply_inference_settings,
        convert_diffusion_scheduler,
        convert_to_flash_attention,
    )
    from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActor
    from nvblox_mindmap_torch.ops.attention import set_default_attention_impl
    from nvblox_mindmap_torch.parallel.serving import make_sharded_infer_fn

    t_phase = time.perf_counter()
    torch.manual_seed(0)
    model = DiffuserActor(model_config("rgbd_and_mesh"), device="cuda")
    bounds = np.asarray(WORKSPACE, dtype=np.float32)
    batch = make_batch(SERVING_BATCH, "rgbd_and_mesh", seed=8)
    params = model.state_dict()
    gen = torch.Generator(device="cuda").manual_seed(9)
    init = torch.randn((SERVING_BATCH, 1, 1, 9), generator=gen, device="cuda")
    apply_inference_settings(convert_to_flash_attention())
    infer = make_sharded_infer_fn(model, bounds, **convert_diffusion_scheduler(EVAL_STEPS))
    traj = infer(params, batch, init_noise=init)[0]  # warm-up and the parameter copy
    reset_flash_counts()
    times = [host_ms(lambda: infer(params, batch, init_noise=init))
             for _ in range(SERVING_CALLS)]
    counts = flash_counts()
    expected = {k: n * SERVING_CALLS for k, n in per_sample(EVAL_STEPS).items()}
    if counts != expected:
        raise AssertionError(f"serving: {counts} flash launches, expected {expected}")
    p50, q1, q3 = quartiles(times)
    busy = profile(lambda: infer(params, batch, init_noise=init), p50)
    if traj.shape != (SERVING_BATCH, 1, 1, 8) or not bool(torch.isfinite(traj).all()):
        raise AssertionError(f"serving: trajectory {tuple(traj.shape)}")
    rows_err = max((infer(params, {k: v[i:i + 1] for k, v in batch.items()},
                          init_noise=init[i:i + 1])[0] - traj[i:i + 1]).abs().max().item()
                   for i in range(SERVING_BATCH))
    set_default_attention_impl("eager")
    eager_err = (infer(params, batch, init_noise=init)[0] - traj).abs().max().item()
    if not rows_err <= DENOISE_ATOL or not eager_err <= TRAJ_ATOL:
        raise AssertionError(f"serving: rows vs B=1 {rows_err}, flash vs eager {eager_err}")
    if infer.copies != 1:
        raise AssertionError(f"serving: parameters copied {infer.copies} times")
    del model, infer
    torch.cuda.empty_cache()
    phase("serving", model="rgbd_and_mesh", cameras=CAMERAS, image=IMAGE,
          context_tokens=CONTEXT["rgbd_and_mesh"],
          self_attention_tokens=1 + CONTEXT["rgbd_and_mesh"] // FPS_FACTOR,
          batch=SERVING_BATCH, sampler=f"ddim{EVAL_STEPS}", devices=1, calls=SERVING_CALLS,
          call_p50_ms=p50, call_q1_ms=q1, call_q3_ms=q3, call_ms=times,
          keyposes_per_s=SERVING_BATCH * 1e3 / p50, launches=counts,
          launches_per_call=per_sample(EVAL_STEPS), parameter_copies=1,
          rows_vs_b1_max_abs_err=rows_err, flash_vs_eager_max_abs_err=eager_err,
          device_busy_ms=busy["device_busy_ms"], device_idle_share=busy["device_idle_share"],
          seconds=time.perf_counter() - t_phase)
    return counts


GOAL_BATCHES = (1, 8)
GOAL_REPS = 20  # host-clock calls per attention impl
VARIANT_QUERIES = 1 + CONTEXT["rgbd_and_mesh"] // FPS_FACTOR  # the flagship's self-attention
VARIANT_MEMORY = 256
VARIANT_ATOL = 1e-4  # fp32 card vs CPU, softmax sums over 4096 keys in other orders
ROTATIONS = 1024
ROTATION_ATOL = 1e-4  # fp32 card vs CPU: sin / atan2 / acos ulps, steep near +-1
EULER_CONVENTIONS = ("XYZ", "XZY", "YXZ", "YZX", "ZXY", "ZYX",
                     "XYX", "XZX", "YXY", "YZY", "ZXZ", "ZYZ")


def trace_kernel_counts(path):
    """Launches of each flash kernel in a Chrome trace (its kernel events)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"flash_attention_split": sum("flash_split_kernel" in n for n in names),
            "flash_attention_tile": sum("flash_tile_kernel" in n for n in names)}


def run_api_surface():
    """Phase ``api_surface``: the rest of the JAX package's public surface on
    the card. ``Encoder.encode_goal_gripper`` of the flagship (E = 120, 8
    heads, 4096 context tokens) at B = 1 and 8: 3 split launches per call
    (L = 1, no mask), flash within TRAJ_ATOL of eager, p50 per impl;
    ``MultiheadAttention`` with each variant (slot competition, gated memory
    with and without its mask, ``return_kv``) under the flash impl on the
    card against the same module on the CPU, with no launch; a
    ``ProfilerTrace`` around one flagship DDIM-10 prediction, whose trace
    must name both kernels as often as the counters (23 + 80); the rotation
    conversions on the card against the CPU over every Euler convention.
    Returns each kernel's launches."""
    import copy

    import numpy as np
    import torch

    from nvblox_mindmap_torch.geometry import rotations
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
    from nvblox_mindmap_torch.models.layers import MultiheadAttention
    from nvblox_mindmap_torch.ops.attention import set_default_attention_impl
    from nvblox_mindmap_torch.ops.positional import rotary_pe_3d
    from nvblox_mindmap_torch.utils.timers import ProfilerTrace

    t_phase = time.perf_counter()
    launches = {}
    torch.manual_seed(0)
    model = DiffuserActor(model_config("rgbd_and_mesh"), device="cuda")
    N = CONTEXT["rgbd_and_mesh"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    lo, hi = torch.tensor(WORKSPACE, device="cuda")
    goal_rows = []
    for B in GOAL_BATCHES:
        # The goal's pose (B, 8): xyz in the workspace (its code), the rest unread.
        args = (torch.cat([lo + (hi - lo) * torch.rand(B, 3, device="cuda", generator=gen),
                           torch.rand(B, 5, device="cuda", generator=gen)], dim=1),
                torch.randn(B, N, EMBEDDING, device="cuda", generator=gen),
                lo + (hi - lo) * torch.rand(B, N, 3, device="cuda", generator=gen))

        def call(impl):
            with torch.no_grad():
                return model.encoder.encode_goal_gripper(*args, impl=impl)

        eager = call("eager")
        reset_flash_counts()
        flash = call("flash")
        torch.cuda.synchronize()
        counts = flash_counts()
        if counts != {"flash_attention_split": 3, "flash_attention_tile": 0}:
            raise AssertionError(f"encode_goal_gripper B={B}: {counts} flash launches")
        add_launches(launches, counts)
        if (flash[0].shape != (B, 1, EMBEDDING) or flash[1].shape != (B, 1, EMBEDDING, 2)
                or not bool(torch.isfinite(flash[0]).all())):
            raise AssertionError(f"encode_goal_gripper B={B}: {tuple(flash[0].shape)}")
        err = max((a - b).abs().max().item() for a, b in zip(flash, eager))
        if not err <= TRAJ_ATOL:
            raise AssertionError(f"encode_goal_gripper B={B}: flash vs eager {err}")
        times = {"flash": [], "eager": []}
        for i in range(GOAL_REPS):
            for impl in (("flash", "eager") if i % 2 == 0 else ("eager", "flash")):
                times[impl].append(host_ms(lambda: call(impl)))
        p50, q1, q3 = quartiles(times["flash"])
        p50_eager, q1_eager, q3_eager = quartiles(times["eager"])
        goal_rows.append(dict(B=B, context_tokens=N, launches=counts,
                              max_abs_err_vs_eager=err, p50_ms=p50, q1_ms=q1, q3_ms=q3,
                              p50_ms_eager_attention=p50_eager, q1_ms_eager_attention=q1_eager,
                              q3_ms_eager_attention=q3_eager))

    # The attention variants under the flash impl: the eager path on the
    # card, no kernel launch, the CPU's result.
    cpu_gen = torch.Generator().manual_seed(12)
    query = torch.randn(1, VARIANT_QUERIES, EMBEDDING, generator=cpu_gen)
    context = torch.randn(1, N, EMBEDDING, generator=cpu_gen)
    key_mask = torch.rand(1, N, generator=cpu_gen) < 0.1
    codes = (rotary_pe_3d(torch.rand(1, VARIANT_QUERIES, 3, generator=cpu_gen), EMBEDDING),
             rotary_pe_3d(torch.rand(1, N, 3, generator=cpu_gen), EMBEDDING))
    memory = torch.randn(1, VARIANT_MEMORY, EMBEDDING, generator=cpu_gen)
    mem_mask = (torch.rand(1, VARIANT_MEMORY, generator=cpu_gen) > 0.3).float()
    variants = {
        "slot_competition": (dict(slot_competition=True), {}),
        "gate_memory": (dict(gate_attn=True), dict(k_mem=memory, v_mem=memory)),
        "gate_memory_mem_mask": (dict(gate_attn=True),
                                 dict(k_mem=memory, v_mem=memory, mem_mask=mem_mask)),
        "return_kv": ({}, dict(return_kv=True)),
    }
    def on(device, tree):
        if isinstance(tree, torch.Tensor):
            return tree.to(device)
        if isinstance(tree, tuple):
            return tuple(on(device, t) for t in tree)
        if isinstance(tree, dict):
            return {k: on(device, v) for k, v in tree.items()}
        return tree

    variant_rows = []
    set_default_attention_impl("flash")
    for name, (fields, call_args) in variants.items():
        torch.manual_seed(13)
        cpu_module = MultiheadAttention(EMBEDDING, HEADS, **fields)
        card_module = copy.deepcopy(cpu_module).to("cuda")
        args = (query, context, context)
        kwargs = dict(rotary_codes=codes, key_padding_mask=key_mask, **call_args)
        with torch.no_grad():
            reset_flash_counts()
            on_card = card_module(*on("cuda", args), **on("cuda", kwargs))
            torch.cuda.synchronize()
            counts = flash_counts()
            on_cpu = cpu_module(*args, **kwargs)
        if any(counts.values()):
            raise AssertionError(f"MultiheadAttention {name}: {counts} flash launches")
        err = max((a.cpu() - b).abs().max().item() for a, b in zip(on_card, on_cpu)
                  if a is not None)
        if not err <= VARIANT_ATOL:
            raise AssertionError(f"MultiheadAttention {name}: card vs CPU {err}")
        variant_rows.append(dict(variant=name, L=VARIANT_QUERIES, S=N, launches=counts,
                                 outputs=len(on_card), card_vs_cpu_max_abs_err=err))
    set_default_attention_impl("eager")

    # One flagship DDIM-10 prediction inside a ProfilerTrace.
    bounds = np.asarray(WORKSPACE, dtype=np.float32)
    prepared = prepare_inputs(make_batch(1, "rgbd_and_mesh", seed=14), bounds,
                              model.config, device="cuda")
    sampler = convert_diffusion_scheduler(EVAL_STEPS)
    init = torch.randn((1, 1, 1, 9), device="cuda", generator=gen)
    apply_inference_settings(convert_to_flash_attention())

    def predict():
        return sample_trajectory(model, prepared, bounds, init_noise=init, **sampler)

    predict()  # warm-up
    trace_dir = tempfile.mkdtemp(prefix="mindmap_trace_")
    try:
        reset_flash_counts()
        with ProfilerTrace(trace_dir) as trace:
            traj = predict()[0]
        counts = flash_counts()
        in_trace = trace_kernel_counts(trace.path)
        trace_mb = os.path.getsize(trace.path) / 1e6
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    set_default_attention_impl("eager")
    expected = per_sample(EVAL_STEPS)
    if counts != expected or in_trace != expected:
        raise AssertionError(f"profiler trace: counters {counts}, trace {in_trace}, "
                             f"expected {expected}")
    if traj.shape != (1, 1, 1, 8) or not bool(torch.isfinite(traj).all()):
        raise AssertionError(f"profiler trace: trajectory {tuple(traj.shape)}")
    add_launches(launches, counts)
    del model
    torch.cuda.empty_cache()

    # The rotation conversions on the card against the CPU.
    quats = torch.randn(ROTATIONS, 4, generator=cpu_gen)
    quats = quats / quats.norm(dim=-1, keepdim=True)
    points = torch.randn(ROTATIONS, 3, generator=cpu_gen)
    axis_angle = torch.randn(ROTATIONS, 3, generator=cpu_gen)
    angles = (torch.rand(ROTATIONS, 3, generator=cpu_gen) * 2 - 1) * math.pi
    matrices = rotations.quaternion_to_matrix(quats)
    calls = {
        "quaternion_apply": lambda d: rotations.quaternion_apply(quats.to(d), points.to(d)),
        "axis_angle_to_quaternion": lambda d: rotations.axis_angle_to_quaternion(
            axis_angle.to(d)),
        "axis_angle_to_matrix": lambda d: rotations.axis_angle_to_matrix(axis_angle.to(d)),
        "matrix_to_axis_angle": lambda d: rotations.matrix_to_axis_angle(matrices.to(d)),
    }
    for convention in EULER_CONVENTIONS:
        calls[f"euler_angles_to_matrix_{convention}"] = (
            lambda d, c=convention: rotations.euler_angles_to_matrix(angles.to(d), c))
        calls[f"matrix_to_euler_angles_{convention}"] = (
            lambda d, c=convention: rotations.matrix_to_euler_angles(matrices.to(d), c))
    rotation_err = {name: (fn("cuda").cpu() - fn("cpu")).abs().max().item()
                    for name, fn in calls.items()}
    worst = max(rotation_err, key=rotation_err.get)
    if not rotation_err[worst] <= ROTATION_ATOL:
        raise AssertionError(f"rotations: {worst} card vs CPU {rotation_err[worst]}")
    phase("api_surface", goal_gripper=goal_rows, attention_variants=variant_rows,
          profiler_trace=dict(sampler=f"ddim{EVAL_STEPS}", launches=counts,
                              trace_kernel_events=in_trace, trace_mb=trace_mb),
          rotations=dict(samples=ROTATIONS, conventions=len(EULER_CONVENTIONS),
                         max_abs_err=rotation_err[worst], worst=worst),
          launches=launches, seconds=time.perf_counter() - t_phase)
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
    busy_ms = sum(e.self_device_time_total / 1e3 for e in device_events(prof))
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


# Phase reconstruction: Mapper.update_color_mesh's budgets, the JAX test's
# bars between its device and host backends (tests/test_surface_nets.py:
# 124-134), and the card against the CPU: the mesh's vertices within a few
# ulps, everything else equal.
RECON_BUDGETS = (65536, 262144)
RECON_VERTEX_ATOL = 1e-5
RECON_COLOR_ATOL = 1e-6
RECON_CARD_CPU_ATOL = 1e-6
RECON_REPS = 10  # host-clock reps of each device op
RECON_HOST_REPS = 3  # of the numpy Surface Nets and the whole update_color_mesh


def timed_reps(fn, reps):
    """summary_ms of ``reps`` host-clock calls of ``fn`` (each ending in a
    synchronize), after one warm-up call."""
    host_ms(fn)
    return summary_ms([host_ms(fn) for _ in range(reps)])


def png_shapes(paths):
    """Every PNG decodes through the port's reader; their distinct shapes."""
    from nvblox_mindmap_torch.data.item_io import decode_png

    if not paths:
        raise AssertionError("reconstruction: no PNG written")
    shapes = {decode_png(p).shape for p in paths}
    return sorted(shapes)


def run_reconstruction(dataset, demo, work):
    """Phase ``reconstruction``, on the datagen app's map file (768-d RADIO
    features, the color layer integrated): the color triangle mesh through
    ``Mapper.update_color_mesh`` on the card with the device backend and the
    host backend (the same counts, vertices within 1e-5, colors within
    1e-6, the same triangle set), the same file's map on the CPU (mesh and
    dense views against the card's), host-clock p50s of the device Surface
    Nets, the numpy one, each backend's whole ``update_color_mesh`` and the
    dense views (``features_dense`` at 768-d, ``colors_dense``,
    ``tsdf_dense``) beside their byte bounds, peak memory; then the
    visualization, USD, video and keypose scripts on the demo (each output
    decoded), and ``datasets_are_close`` on the demo against a copy of
    itself (true) and a copy with one item changed (false)."""
    import numpy as np
    import torch

    from nvblox_mindmap_torch.data.comparisons import datasets_are_close
    from nvblox_mindmap_torch.mapping import voxel_grid as vg
    from nvblox_mindmap_torch.mapping.constants import MapperId
    from nvblox_mindmap_torch.mapping.mapper import Mapper
    from nvblox_mindmap_torch.mapping.surface_nets import surface_nets
    from nvblox_mindmap_torch.scripts import (
        convert_maps_usd,
        generate_reconstruction_figures,
        make_mp4_from_dataset,
        video_from_depth,
        visualize_keyposes,
        visualize_nvblox_tensors,
    )

    t_phase = time.perf_counter()
    map_path = os.path.join(demo, "nvblox_map_static.nvblx")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    card = Mapper.from_file(map_path, device="cuda")
    cfg = card.configs[MapperId.STATIC]
    state = card.states[MapperId.STATIC]
    X, Y, Z = cfg.grid_shape
    F = cfg.feature_dim
    live_pages = int(state.num_pages)
    out = vg.extract_surface_mesh_device(state, cfg, *RECON_BUDGETS)
    n_vertices, n_triangles = int(out[5]), int(out[6])
    del out
    meshes = {}
    for backend in ("device", "host"):
        card.update_color_mesh(backend=backend, max_vertices=RECON_BUDGETS[0],
                               max_triangles=RECON_BUDGETS[1])
        meshes[backend] = card.get_color_mesh()
    (dv, dt, dc), (hv, ht, hc) = meshes["device"], meshes["host"]

    def tri_set(t):
        return set(map(tuple, np.sort(t, axis=1)))

    if not (len(dv) == len(hv) == n_vertices <= RECON_BUDGETS[0]
            and len(dt) == len(ht) == n_triangles <= RECON_BUDGETS[1] and n_triangles > 0):
        raise AssertionError(f"reconstruction: device {len(dv)} / {len(dt)}, host {len(hv)} / "
                             f"{len(ht)}, counted {n_vertices} / {n_triangles}")
    vertex_err = float(np.abs(dv - hv).max())
    color_err = float(np.abs(dc - hc).max())
    if (vertex_err > RECON_VERTEX_ATOL or color_err > RECON_COLOR_ATOL
            or tri_set(dt) != tri_set(ht) or not (dc > 0).any()):
        raise AssertionError(f"reconstruction: device vs host vertices {vertex_err}, colors "
                             f"{color_err}, triangle sets equal {tri_set(dt) == tri_set(ht)}")

    # The same file's map on the CPU: its device-backend mesh and dense views.
    cpu = Mapper.from_file(map_path, device="cpu")
    cpu.update_color_mesh(backend="device", max_vertices=RECON_BUDGETS[0],
                          max_triangles=RECON_BUDGETS[1])
    cv, ct, cc = cpu.get_color_mesh()
    card_cpu = {"vertices": float(np.abs(dv - cv).max()) if len(cv) == len(dv) else None,
                "triangles_equal": bool(np.array_equal(dt, ct)),
                "colors_equal": bool(np.array_equal(dc, cc))}
    for view in ("tsdf", "colors", "features"):
        on_card = getattr(card, f"{view}_dense")()
        on_cpu = getattr(cpu, f"{view}_dense")().to("cuda")
        card_cpu[view] = float((on_card - on_cpu).abs().max())
        del on_card, on_cpu
    del cpu
    if (card_cpu["vertices"] is None or card_cpu["vertices"] > RECON_CARD_CPU_ATOL
            or not (card_cpu["triangles_equal"] and card_cpu["colors_equal"])
            or any(card_cpu[v] != 0 for v in ("tsdf", "colors", "features"))):
        raise AssertionError(f"reconstruction: card vs CPU {card_cpu}")
    torch.cuda.empty_cache()

    # Host-clock times, each ending in a synchronize.
    tsdf_host, weight_host = state.tsdf.cpu().numpy(), state.weight.cpu().numpy()
    origin = np.asarray(cfg.aabb_min_m, np.float64)
    times = {
        "surface_nets_device": timed_reps(
            lambda: vg.extract_surface_mesh_device(state, cfg, *RECON_BUDGETS), RECON_REPS),
        "surface_nets_host": timed_reps(
            lambda: surface_nets(tsdf_host, weight_host, cfg.voxel_size_m, origin,
                                 truncation=cfg.truncation_distance_m), RECON_HOST_REPS),
    }
    for backend in ("device", "host"):
        times[f"update_color_mesh_{backend}"] = timed_reps(
            lambda: card.update_color_mesh(backend=backend, max_vertices=RECON_BUDGETS[0],
                                           max_triangles=RECON_BUDGETS[1]), RECON_HOST_REPS)
    voxels = X * Y * Z
    page_bytes = live_pages * cfg.block_size**3
    table_bytes = 4 * len(state.page_table.reshape(-1))
    dense_bytes = {  # each input read once (the live pages), each output written once
        "features": voxels * F * 4 + page_bytes * (2 * F + 4) + table_bytes,
        "colors": voxels * 3 * 4 + page_bytes * (2 * 3 + 4) + table_bytes,
        "tsdf": voxels * 4 * 3,
    }
    dense = {}
    peak = torch.cuda.max_memory_allocated()  # the phase's so far
    for view, nbytes in dense_bytes.items():
        fn = getattr(card, f"{view}_dense")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        shape = tuple(fn().shape)
        view_peak = torch.cuda.max_memory_allocated()
        peak = max(peak, view_peak)
        t = timed_reps(fn, RECON_REPS)
        dense[view] = dict(shape=list(shape), bytes=nbytes,
                           bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                           bound_share=nbytes / PEAK_BYTES_PER_S * 1e3 / t["p50_ms"],
                           peak_extra_gb=(view_peak - before) / 1e9, **t)
    del card, state
    torch.cuda.empty_cache()

    # The scripts, on the card's default device, outputs under work/.
    scripts = {}
    root = os.path.join(work, "reconstruction")
    frames = len([f for f in os.listdir(demo) if f.endswith(".wrist_rgb.png")])

    def run(name, fn):
        t0 = time.perf_counter()
        result = fn()
        scripts[name] = dict(seconds=time.perf_counter() - t0, **result)

    def viz():
        d = os.path.join(root, "viz")
        visualize_nvblox_tensors.main(["--map", map_path, "--output_dir", d])
        return dict(slices=png_shapes(sorted(glob_files(d, "tsdf_slice_*.png"))),
                    surface_vertices=ply_vertex_count(os.path.join(d, "surface.ply")))

    def figures():
        d = os.path.join(root, "figs")
        generate_reconstruction_figures.main(["--map_path", map_path, "--output_dir", d])
        shapes = png_shapes([os.path.join(d, f"nvblox_map_static_{kind}.png")
                             for kind in ("color_mesh", "feature_cubes_mesh")])
        if len(shapes) != 1 or not os.path.exists(os.path.join(d, "pca_params.npz")):
            raise AssertionError(f"reconstruction: figures {shapes}")
        return dict(figures=shapes)

    def usd():
        d = os.path.join(root, "usd")
        os.makedirs(d)
        os.symlink(map_path, os.path.join(d, "nvblox_map_static.nvblx"))
        convert_maps_usd.main(["--input_dir", d])
        path = os.path.join(d, "nvblox_map_static.usda")
        with open(path) as f:
            head = f.read(64)
        if not head.startswith("#usda 1.0"):
            raise AssertionError(f"reconstruction: {path} starts {head!r}")
        return dict(usda_mb=os.path.getsize(path) / 1e6)

    def video(modality):
        d = os.path.join(root, "mp4")
        make_mp4_from_dataset.main(["--dataset", dataset, "--demos", "0", "--camera", "wrist",
                                    "--modality", modality, "--output_dir", d])
        paths = glob_files(d, f"demo_00000_wrist_{modality}_*.png")
        if len(paths) != frames:
            raise AssertionError(f"reconstruction: {len(paths)} {modality} frames of {frames}")
        return dict(frames=len(paths), shapes=png_shapes(paths))

    def depth_video():
        d = os.path.join(root, "depth")
        video_from_depth.main([demo, os.path.join(d, "wrist_depth.mp4"), "--pattern",
                               "*.wrist_depth.png"])
        paths = glob_files(d, "wrist_depth_*.png")
        if len(paths) != frames:
            raise AssertionError(f"reconstruction: {len(paths)} depth frames of {frames}")
        return dict(frames=len(paths), shapes=png_shapes(paths))

    def keyposes():
        d = os.path.join(root, "keyposes")
        visualize_keyposes.main(["--dataset", dataset, "--demos", "0", "--task", LOOP_TASK,
                                 "--output_dir", d])
        n = ply_vertex_count(os.path.join(d, "demo_00000_keyposes.ply"))
        if n != frames:
            raise AssertionError(f"reconstruction: keypose cloud of {n} of {frames} frames")
        return dict(points=n)

    run("visualize_nvblox_tensors", viz)
    run("generate_reconstruction_figures", figures)
    run("convert_maps_usd", usd)
    run("make_mp4_from_dataset_rgb", lambda: video("rgb"))
    run("make_mp4_from_dataset_depth", lambda: video("depth"))
    run("video_from_depth", depth_video)
    run("visualize_keyposes", keyposes)

    # datasets_are_close: the demo against a linked copy, then with one item
    # written anew, changed.
    copy = os.path.join(root, "copy", os.path.basename(demo))
    shutil.copytree(demo, copy, copy_function=os.link)
    t0 = time.perf_counter()
    same = datasets_are_close(demo, copy)
    compare_s = time.perf_counter() - t0
    item = os.path.join(copy, "0.robot_state.npy")
    robot_state = np.load(item)
    os.remove(item)
    np.save(item, robot_state + 0.01)
    changed = datasets_are_close(demo, copy)
    if same != (True, []) or changed != (False, ["0.robot_state.npy"]):
        raise AssertionError(f"reconstruction: datasets_are_close {same}, {changed}")
    shutil.rmtree(root, ignore_errors=True)

    phase("reconstruction", map=os.path.relpath(map_path, dataset), grid=[X, Y, Z],
          voxel_size_m=cfg.voxel_size_m, feature_dim=F, pages=cfg.max_feature_pages,
          live_pages=live_pages, vertices=n_vertices, triangles=n_triangles,
          budgets=dict(vertices=RECON_BUDGETS[0], triangles=RECON_BUDGETS[1]),
          device_vs_host=dict(vertices_max_abs_err=vertex_err, colors_max_abs_err=color_err,
                              triangle_sets_equal=True),
          card_vs_cpu=card_cpu, times=times, dense=dense, peak_gb=peak / 1e9, scripts=scripts,
          datasets_are_close=dict(same=same[0], changed=changed[0], mismatched=changed[1],
                                  compare_s=compare_s),
          seconds=time.perf_counter() - t_phase)


def glob_files(directory, pattern):
    import glob

    return sorted(glob.glob(os.path.join(directory, pattern)))


def run_closed_loop_app(root, checkpoint, npz):
    """Phase 11: ``apps/run_closed_loop_policy.py`` on the recorded demo in
    the scene world, with the training app's best.ckpt: the app's flagship
    (rgbd_and_mesh, the ego camera at IMAGE, 2048 sampled 768-d vertices,
    RADIO mapping features), DDIM-10. Then the ground-truth goals on the
    same demo. Returns each kernel's launches over the policy run, and the
    run's goals, summary and sim-step p50 (for phase ``remote_loop``)."""
    import collections
    import contextlib
    import json
    from unittest import mock

    import numpy as np
    import torch
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
    predicted = []

    def timed(name, fn, keep=False):
        def wrapper(*args, **kwargs):
            if keep:
                last.update(policy=args[0], env=args[1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            if keep:
                predicted.append([np.array(g, copy=True) for g in out])
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
            busy = sum(e.self_device_time_total / 1e3 for e in device_events(prof))
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
    return counts, dict(goals=predicted, summary=summary,
                        sim_step_p50_ms=statistics.median(times["sim_step"]),
                        render_p50_ms=statistics.median(times["render"]))


# Phase remote_loop: the closed-loop app's flagship through the simulator
# bridge, its sim host a spawned process that serves the scene world.
REMOTE_TIMEOUT_S = 120  # any one bridge call, and the sim host's start and end
ADAPTER_STEPS = 4  # served adapter steps per embodiment


def serve_scene_world(demo, conn):
    """The sim host of phase ``remote_loop`` (a spawned process): the scene
    world of ``demo`` served through the port's ``serve_environment`` on
    loopback, port 0; sends (port, the world's object half extents), then,
    once the client has closed the bridge, the seconds the world spent in
    each method and whether torch was imported (it must not be: the sim
    host never touches the card)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    sys.path.insert(0, ROOT)
    from nvblox_mindmap_torch.closed_loop.remote_env import serve_environment
    from nvblox_mindmap_torch.closed_loop.scripted import env_from_scene_json

    world = env_from_scene_json(demo)
    seconds, calls = {}, {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
                calls[name] = calls.get(name, 0) + 1
        return wrapper

    for name in ("reset", "step", "get_robot_state", "get_policy_state", "get_cameras",
                 "get_object_poses", "is_success"):
        setattr(world, name, timed(name, getattr(world, name)))
    server = serve_environment(world, port=0)
    try:
        conn.send((server.port, getattr(world, "object_half", None)))
        stopped = server.wait(timeout=1800)
    finally:
        server.stop()
    conn.send(dict(stopped=stopped, seconds=seconds, calls=calls,
                   torch_imported="torch" in sys.modules))
    conn.close()


class StandInGymEnv:
    """A recording stand-in for an Isaac Lab gym env (the surface
    ``IsaacLabEnvironment`` steps): it keeps every action it is stepped
    with, and the robot's eef poses, jaws or hand joints and head follow the
    action. Its state lives in torch tensors on the CPU, as a simulator's
    would."""

    def __init__(self, humanoid):
        import torch

        self.unwrapped = self.scene = self
        self.humanoid = humanoid
        self.actions = []
        self.resets = 0
        self.state = torch.zeros(37 if humanoid else 9)
        self.state[3] = 1.0
        if humanoid:
            self.state[21] = 1.0

    def reset_to(self, state, env_ids, is_relative):
        self.resets += 1

    def reset(self):
        self.resets += 1

    def step(self, action):
        from nvblox_mindmap_torch.embodiments.humanoid_hand import HumanoidJointIndices

        self.actions.append(action)
        flat = action.reshape(-1)
        if not self.humanoid:
            self.state[:7] = flat[:7]
            self.state[7:9] = 0.0 if float(flat[7]) < 0 else 0.04
            return
        hands = flat[15:37]
        self.state[0:7], self.state[18:25], self.state[36] = flat[0:7], flat[7:14], flat[14]
        self.state[7:18] = hands[HumanoidJointIndices.left_joints_in_combined_hands_tensor_indices]
        self.state[25:36] = hands[
            HumanoidJointIndices.right_joints_in_combined_hands_tensor_indices]


def drive_served_adapters():
    """``IsaacLabEnvironment`` over the recording stand-in, for each
    embodiment, served through the port's bridge (a thread of this process)
    and driven by a ``RemoteEnvironment`` for ADAPTER_STEPS steps: every
    recorded action is a CPU float32 (1, 8) or (1, 37) tensor and a 37-d one
    round-trips through ``HumanoidAction.from_tensor`` exactly. Cameras,
    labels and object poses through the adapter are held to the JAX
    package's on the CPU (``tests/test_torch_bridges.py``)."""
    import numpy as np
    import torch

    from nvblox_mindmap_torch.closed_loop.isaaclab_adapter import IsaacLabEnvironment
    from nvblox_mindmap_torch.closed_loop.remote_env import RemoteEnvironment, serve_environment
    from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
    from nvblox_mindmap_torch.embodiments.humanoid import HumanoidEmbodiment
    from nvblox_mindmap_torch.embodiments.humanoid_hand import HumanoidAction

    rng = np.random.default_rng(31)
    out = {}
    for name, humanoid in (("arm", False), ("humanoid", True)):
        gym_env = StandInGymEnv(humanoid)
        adapter = IsaacLabEnvironment(
            gym_env, HumanoidEmbodiment() if humanoid else ArmEmbodiment(), {},
            robot_state_fn=lambda env: env.state, initial_state={"demo": 0})
        server = serve_environment(adapter, port=0)
        try:
            remote = RemoteEnvironment("127.0.0.1", server.port, timeout_s=REMOTE_TIMEOUT_S)
            remote.reset()
            remote.step(None)
            for _ in range(ADAPTER_STEPS):
                goal = rng.uniform(-0.5, 0.5, 17 if humanoid else 8).astype(np.float32)
                for q in ((3, 7), (11, 15)) if humanoid else ((3, 7),):
                    goal[q[0]:q[1]] /= np.linalg.norm(goal[q[0]:q[1]])
                closed = (7, 15) if humanoid else (7,)
                goal[list(closed)] = rng.uniform(0, 1, len(closed))
                remote.step(goal)
            state = remote.get_policy_state()
            remote.close()
            server.wait(REMOTE_TIMEOUT_S)
        finally:
            server.stop()
        width = 37 if humanoid else 8
        bad = [a for a in gym_env.actions if not (
            isinstance(a, torch.Tensor) and a.device.type == "cpu"
            and a.dtype == torch.float32 and tuple(a.shape) == (1, width))]
        round_trip = all(HumanoidAction.from_tensor(a[0].numpy()).to_tensor().tobytes()
                         == a[0].numpy().tobytes() for a in gym_env.actions) if humanoid else None
        if (bad or len(gym_env.actions) != ADAPTER_STEPS + 1 or gym_env.resets != 1
                or round_trip is False or state.shape != ((17,) if humanoid else (8,))):
            raise AssertionError(f"remote_loop: served {name} adapter: {len(bad)} bad actions "
                                 f"of {len(gym_env.actions)}, round trip {round_trip}, "
                                 f"state {state.shape}")
        out[name] = dict(actions=len(gym_env.actions), action_shape=[1, width],
                         action_device="cpu", round_trip_exact=round_trip,
                         bridge_calls=remote.calls,
                         bridge_mb=(remote.bytes_sent + remote.bytes_received) / 1e6)
    return out


def run_remote_loop(root, checkpoint, npz, in_process):
    """Phase ``remote_loop``: the closed-loop app's flagship (as phase 11,
    same demo, best.ckpt and backbone .npz) on the card, its world a
    ``RemoteEnvironment``: a spawned sim host serves the demo's scene world
    on loopback. The goals must equal ``in_process``'s (phase 11's) bit for
    bit, the success too, and every goal launch 23 + 80 flash calls. Then
    the Isaac Lab adapter served through the bridge (``drive_served_adapters``).
    Returns each kernel's launches."""
    import collections
    import contextlib
    import multiprocessing
    from unittest import mock

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from nvblox_mindmap_torch.apps import run_closed_loop_policy as app
    from nvblox_mindmap_torch.closed_loop import policies
    from nvblox_mindmap_torch.closed_loop.remote_env import RemoteEnvironment

    t_phase = time.perf_counter()
    demo = glob_files(root, "demo_*")[0]
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    host = ctx.Process(target=serve_scene_world, args=(demo, child_conn), daemon=True)
    host.start()
    try:
        if not conn.poll(REMOTE_TIMEOUT_S):
            raise AssertionError("remote_loop: the sim host did not start")
        port, object_half = conn.recv()
        remotes, times, goals, idle = [], collections.defaultdict(list), [], {}
        call_s = collections.defaultdict(float)
        real_call = RemoteEnvironment._call

        def remote_world(demo_path):
            env = RemoteEnvironment("127.0.0.1", port, timeout_s=REMOTE_TIMEOUT_S)
            if object_half is not None:  # what the app reads of a scene world
                env.object_half = object_half
            remotes.append(env)
            return env

        def timed_call(self, method, **kwargs):
            t0 = time.perf_counter()
            try:
                return real_call(self, method, **kwargs)
            finally:
                call_s[method] += time.perf_counter() - t0

        def timed(name, fn, keep=False):
            def wrapper(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
                if keep:
                    goals.append([np.array(g, copy=True) for g in out])
                return out
            return wrapper

        def profiled(fn):
            def wrapper(*args, **kwargs):
                torch.cuda.synchronize()
                with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    out = fn(*args, **kwargs)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                busy = sum(e.self_device_time_total / 1e3 for e in device_events(prof))
                idle.update(wall_ms=wall, device_busy_ms=busy, device_idle_share=1 - busy / wall)
                return out
            return wrapper

        eval_path = os.path.join(root, "remote_loop_eval.json")
        flags = ["--task", LOOP_TASK, "--dataset", root, "--demos_closed_loop", "0",
                 "--checkpoint", checkpoint, "--backbone_weights", npz,
                 "--serving_scheduler", "ddim", "--serving_num_inference_steps",
                 str(CLOSED_LOOP_STEPS), "--max_num_steps_to_goal", str(LOOP_STEPS_TO_GOAL),
                 "--terminate_after_n_steps", str(LOOP_STEPS), "--eval_file_path", eval_path]
        Policy = policies.NvbloxDiffuserActorPolicy
        with contextlib.ExitStack() as patches:
            for owner, name, value in (
                    (app, "env_from_scene_json", remote_world),
                    (RemoteEnvironment, "_call", timed_call),
                    (Policy, "step", timed("sim_step", Policy.step)),
                    (Policy, "get_new_goal", timed("goal", Policy.get_new_goal, keep=True)),
                    (app, "run_closed_loop_policy", profiled(app.run_closed_loop_policy))):
                patches.enter_context(mock.patch.object(owner, name, value))
            reset_flash_counts()
            app_ms = host_ms(lambda: times["summary"].append(app.main(flags, "scene")))
            counts = flash_counts()
        for env in remotes:
            env.close()
        if not conn.poll(REMOTE_TIMEOUT_S):
            raise AssertionError("remote_loop: the sim host did not stop")
        host_stats = conn.recv()
        host.join(REMOTE_TIMEOUT_S)
    finally:
        if host.is_alive():
            host.terminate()
            host.join()
    summary = times.pop("summary")[0]
    n_goals = len(goals)
    T = CLOSED_LOOP_STEPS
    expected = {"flash_attention_split": n_goals * (3 + 2 * T),
                "flash_attention_tile": n_goals * 8 * T}
    if n_goals < 3 or counts != expected:
        raise AssertionError(f"remote_loop: {counts} flash launches over {n_goals} goals, "
                             f"expected {expected}")
    if host.exitcode != 0 or not host_stats["stopped"] or host_stats["torch_imported"]:
        raise AssertionError(f"remote_loop: sim host exit {host.exitcode}, {host_stats}")
    if len(remotes) != 1:
        raise AssertionError(f"remote_loop: {len(remotes)} bridge connections, expected 1")
    ref_goals = in_process["goals"]
    equal = len(goals) == len(ref_goals) and all(
        len(a) == len(b) and all(x.dtype == y.dtype and x.tobytes() == y.tobytes()
                                 for x, y in zip(a, b)) for a, b in zip(goals, ref_goals))
    if not equal:
        diff = [float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(goals, ref_goals)]
        raise AssertionError(f"remote_loop: {len(goals)} goals vs {len(ref_goals)} in process, "
                             f"max abs diff per goal {diff}")
    if (summary["success_rate"], summary.get("outcomes")) != (
            in_process["summary"]["success_rate"], in_process["summary"].get("outcomes")):
        raise AssertionError(f"remote_loop: summary {summary} vs {in_process['summary']}")
    remote = remotes[0]
    steps = len(times["sim_step"])
    env_s = sum(host_stats["seconds"].values())
    bridge_s = sum(call_s.values()) - env_s
    adapters = drive_served_adapters()
    phase("remote_loop", task=LOOP_TASK, model="rgbd_and_mesh", image=IMAGE, vertices=VERTICES,
          feature_dim=FEATURE_DIM, sampler=f"ddim{T}", transport="tcp loopback",
          sim_host="spawned process, scene world, no torch", steps=steps, goals=n_goals,
          goals_equal_in_process=True, success_rate=summary["success_rate"],
          launches=counts, launches_per_goal={k: n // n_goals for k, n in counts.items()},
          app_ms=app_ms,
          sim_step=dict(summary_ms(times["sim_step"]),
                        in_process_p50_ms=in_process["sim_step_p50_ms"],
                        in_process_render_p50_ms=in_process["render_p50_ms"]),
          bridge=dict(calls=remote.calls, calls_per_step=remote.calls / steps,
                      mb_sent=remote.bytes_sent / 1e6, mb_received=remote.bytes_received / 1e6,
                      mb_per_step=(remote.bytes_sent + remote.bytes_received) / 1e6 / steps,
                      round_trip_s={k: v for k, v in call_s.items()},
                      sim_host_s=host_stats["seconds"], sim_host_calls=host_stats["calls"],
                      own_ms_per_step=bridge_s * 1e3 / steps),
          goal=summary_ms(times["goal"]), idle=idle, adapters=adapters,
          seconds=time.perf_counter() - t_phase)
    return counts


# Phase runtime_tools: the decoder API, the demo tools and the workflow specs
# on the datagen demo and the closed-loop app's eval file (host work).
DECODE_THREADS = (1, 4, 8)


def tree_digest(root):
    """relative path -> sha256 of every file under ``root``."""
    import hashlib

    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            digest = hashlib.sha256()
            with open(path, "rb") as fh:
                for block in iter(lambda: fh.read(1 << 24), b""):
                    digest.update(block)
            out[os.path.relpath(path, root)] = digest.hexdigest()
    return out


def run_runtime_tools(dataset, work):
    """Phase ``runtime_tools``: ``runtime.decode_png_batch`` over the datagen
    demo's PNGs at 1 / 4 / 8 threads (equal to ``item_io.decode_png`` one by
    one; ms per PNG), ``decode_zstd_pickle`` against ``item_io.unpickle_zst``
    on its items, ``benchmark_decompression`` at its defaults, ``tar_demos``
    there and back (every file's bytes equal), the HTML report of the
    closed-loop app's eval file, ``plot_humanoid_keyposes`` on a demo of the
    port's humanoid recorder (the indices equal the embodiment's, the PNG
    decoded), ``hdf5_tools`` (or its refusal without h5py) and the workflow
    specs written and read back."""
    import json

    import numpy as np

    from nvblox_mindmap_torch import runtime
    from nvblox_mindmap_torch.closed_loop import scripted
    from nvblox_mindmap_torch.data import item_io
    from nvblox_mindmap_torch.data.keyposes import KeyposeDetectionMode
    from nvblox_mindmap_torch.embodiments.humanoid import HumanoidEmbodiment
    from nvblox_mindmap_torch.scripts import (
        benchmark_decompression,
        hdf5_tools,
        plot_humanoid_keyposes,
        publish_closed_loop_eval,
        tar_demos,
    )
    from nvblox_mindmap_torch.workflows import submit

    t_phase = time.perf_counter()
    demo = glob_files(dataset, "demo_*")[0]
    if not (runtime.ensure_built() and runtime.native_available()):
        raise AssertionError("runtime_tools: the decoder's libraries do not load")
    pngs = glob_files(demo, "*.png")
    t0 = time.perf_counter()
    serial = [item_io.decode_png(p) for p in pngs]
    decode_ms = {"serial": (time.perf_counter() - t0) * 1e3 / len(pngs)}
    for threads in DECODE_THREADS:
        t0 = time.perf_counter()
        batch = runtime.decode_png_batch(pngs + [os.path.join(demo, "missing.png")], threads)
        decode_ms[threads] = (time.perf_counter() - t0) * 1e3 / len(pngs)
        if batch[-1] is not None or any(
                b is None or b.dtype != a.dtype or not np.array_equal(a, b)
                for a, b in zip(serial, batch)):
            raise AssertionError(f"runtime_tools: decode_png_batch at {threads} threads differs")
    items = glob_files(demo, "*.zst")
    for path in items:
        ours, ref = runtime.decode_zstd_pickle(path), item_io.unpickle_zst(path)
        if sorted(ours) != sorted(ref) or not all(
                np.array_equal(ours[k], ref[k]) for k in ("vertices", "features")):
            raise AssertionError(f"runtime_tools: decode_zstd_pickle differs on {path}")

    t0 = time.perf_counter()
    bench = benchmark_decompression.main([])
    bench_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    tars = tar_demos.tar_demos(dataset, "0", os.path.join(work, "tars"))
    untarred = tar_demos.untar_demos(os.path.join(work, "tars"), os.path.join(work, "untarred"))
    source, copy = tree_digest(demo), tree_digest(untarred[0])
    if source != copy or len(tars) != 1:
        raise AssertionError(f"runtime_tools: untarred demo differs ({len(source)} files, "
                             f"{len(copy)} back)")
    tar_mb = os.path.getsize(tars[0]) / 1e6
    tar_s = time.perf_counter() - t0
    shutil.rmtree(os.path.join(work, "tars"))
    shutil.rmtree(os.path.join(work, "untarred"))

    eval_path = os.path.join(dataset, "closed_loop_eval.json")
    with open(eval_path) as f:
        summary = json.load(f)["summary"]
    report = publish_closed_loop_eval.render_report([eval_path], os.path.join(work, "report",
                                                                              "index.html"))
    with open(report) as f:
        html = f.read()
    if f"{summary.get('success_rate', 0):.2%}" not in html:
        raise AssertionError("runtime_tools: the report lacks the success rate")

    t0 = time.perf_counter()
    humanoid = os.path.join(work, "humanoid")
    (demo_h,) = scripted.generate_drill_in_box_demos(humanoid, num_demos=1, seed=0,
                                                     image_size=64)
    keyposes = plot_humanoid_keyposes.analyze_demo(demo_h, os.path.join(work, "plots"))
    expected = HumanoidEmbodiment().extract_keypose_indices(
        plot_humanoid_keyposes.load_robot_states(demo_h), [],
        KeyposeDetectionMode.HIGHEST_Z_OF_VERTICAL_MOTION_AND_HEAD_TURN)
    figure = item_io.decode_png(os.path.join(work, "plots",
                                             f"{os.path.basename(demo_h)}_keyposes.png"))
    if (not np.array_equal(keyposes, expected) or len(keyposes) < 3
            or figure.shape != plot_humanoid_keyposes.FIGURE_HW + (3,)):
        raise AssertionError(f"runtime_tools: keyposes {keyposes}, figure {figure.shape}")
    plot_s = time.perf_counter() - t0

    hdf5 = "absent"
    try:
        import h5py
    except ImportError:
        try:
            hdf5_tools.list_demos(os.path.join(work, "none.hdf5"))
        except ImportError as e:
            if "h5py" not in str(e):
                raise
    else:
        path = os.path.join(work, "demos.hdf5")
        with h5py.File(path, "w") as f:
            for i in range(3):
                f.create_group(f"data/demo_{i}").create_dataset("actions", data=np.full(4, i))
        hdf5_tools.merge_hdf5_files([path, path], os.path.join(work, "merged.hdf5"))
        hdf5 = hdf5_tools.list_demos(os.path.join(work, "merged.hdf5"))
        if len(hdf5) != 6:
            raise AssertionError(f"runtime_tools: merged {hdf5}")

    specs = {}
    for name, workflow in (
            ("e2e", submit.make_e2e_workflow(LOOP_TASK, "demos.hdf5", work)),
            ("train_and_eval", submit.make_train_and_eval_workflow(LOOP_TASK, dataset, "0",
                                                                   "0", work))):
        path = submit.write_workflow(workflow, os.path.join(work, f"{name}.json"))
        with open(path) as f:
            if json.load(f) != workflow:
                raise AssertionError(f"runtime_tools: workflow {name} did not read back")
        specs[name] = [s["command_line"] for s in workflow["stages"]]
    phase("runtime_tools", demo_pngs=len(pngs), png_shapes=sorted({a.shape for a in serial}),
          decode_ms_per_png=decode_ms, decode_batches_equal_serial=True,
          zstd_items_equal=len(items), decompression=bench, decompression_s=bench_s,
          tar=dict(files=len(source), mb=tar_mb, seconds=tar_s, bytes_equal=True),
          report_bytes=len(html), humanoid_keyposes=[int(k) for k in keyposes],
          keypose_figure=list(figure.shape), keypose_s=plot_s, hdf5=hdf5, workflows=specs,
          seconds=time.perf_counter() - t_phase)


# --------------------------------------------------------------------------
# The CLIP ResNet-50 FPN extractor and the language layers
# --------------------------------------------------------------------------

CLIP_FEATURES = 120  # the FPN's channels: the vertex features of a CLIP dataset
CLIP_TIMED_BATCHES = (CAMERAS, TRAIN_BATCH)  # the flagship's 2 cameras; a train batch
# Card vs CPU, both IEEE fp32 (TF32 off in the extractor's convolutions):
# the features within CLIP_REL_ATOL of their largest magnitude, the FPN's
# gradients within CLIP_GRAD_REL_ATOL of each tensor's largest entry.
CLIP_REL_ATOL = 1e-4
CLIP_GRAD_REL_ATOL = 1e-4
CLIP_TRAIN_ITERS = 8  # then one validation batch
CLIP_PROFILED_STEPS = (6, 7)  # steps 1-5 timed, these two profiled
CLIP_DEAD_LEVELS = ("inner_0", "inner_1", "layer_0", "layer_1", "layer_3", "layer_4")
INSTRUCTION_TOKENS = 53  # 3D Diffuser Actor's padded CLIP-text length
INSTRUCTION_DIM = 512
LANGUAGE_REPS = (8, 6)  # host-clock predictions per impl at B = 1 and B = 8


def save_random_clip(path, seed=12):
    """A seeded random CLIP RN50 visual trunk as CLIP's torch state dict
    (``visual.`` keys, BatchNorm running statistics calibrated on the card
    over 8 random CLIP-normalized images so that each BatchNorm's output is
    normalized, an attention-pool key the converter skips), converted by the port's converter, with a fresh
    FPN beside it, saved as the flax-layout ``.npz``."""
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


class step_profile:
    """Within the block, the calls of ``Trainer.train_one_step`` numbered
    ``profiled`` (from 0) are profiled on the card: the device busy time
    over the calls' host-clock time. The profiler's own start and stop are
    in those calls' step times: time the other steps."""

    def __init__(self, profiled):
        self.profiled = set(profiled)

    def __enter__(self):
        from unittest import mock

        import torch
        from torch.profiler import ProfilerActivity, profile as torch_profile

        from nvblox_mindmap_torch.training.trainer import Trainer

        self.calls, self.wall_ms, self.busy_ms = 0, 0.0, 0.0
        real = Trainer.train_one_step

        def wrapper(trainer, *args, **kwargs):
            self.calls += 1
            if self.calls - 1 not in self.profiled:
                return real(trainer, *args, **kwargs)
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = real(trainer, *args, **kwargs)
                torch.cuda.synchronize()
                self.wall_ms += (time.perf_counter() - t0) * 1e3
            self.busy_ms += sum(e.self_device_time_total / 1e3 for e in device_events(prof))
            return out

        self.patch = mock.patch.object(Trainer, "train_one_step", wrapper)
        self.patch.__enter__()
        return self

    def __exit__(self, *exc):
        self.patch.__exit__(*exc)
        return False

    def fields(self):
        return dict(steps=sorted(self.profiled), wall_ms=self.wall_ms,
                    device_busy_ms=self.busy_ms,
                    device_idle_share=1 - self.busy_ms / self.wall_ms)


def run_clip_loop(work, npz):
    """Phase ``clip_loop``: the loop with ``--feature_type clip_resnet50_fpn``
    at the app's flagship (cube_stacking, the ego camera at IMAGE: 32x32 res3
    tokens, 2048 of the stored 120-d vertices; B = 32). The datagen app
    writes every frame's 120-d vertex features of the app dataset's three
    demos through the CLIP .npz; the training app trains on them
    ``CLIP_TRAIN_ITERS`` steps with the FPN training, then evaluates one
    batch; ``scripts/extract_fpn_from_model`` takes best.ckpt's FPN and
    trunk into an .npz, whose ``make_feature_fn`` gives the trained
    extractor's features; the closed-loop app runs best.ckpt with those
    mapping features on the validation demo's frames (the replay world),
    DDIM-10. Returns each kernel's launches."""
    import collections
    import contextlib
    from unittest import mock

    import numpy as np
    import torch

    from nvblox_mindmap_torch.apps import run_closed_loop_policy as loop_app
    from nvblox_mindmap_torch.apps import run_datagen as datagen_app
    from nvblox_mindmap_torch.apps import run_training as train_app
    from nvblox_mindmap_torch.closed_loop import policies
    from nvblox_mindmap_torch.data import item_io
    from nvblox_mindmap_torch.models.clip_resnet_fpn import ClipResNet50Fpn
    from nvblox_mindmap_torch.models.feature_extractors import resize_bilinear
    from nvblox_mindmap_torch.models.pretrained import make_feature_fn
    from nvblox_mindmap_torch.models.weight_conversion import load_variables_npz
    from nvblox_mindmap_torch.models.weights import flax_to_state_dict
    from nvblox_mindmap_torch.scripts import extract_fpn_from_model
    from nvblox_mindmap_torch.training.checkpoint import load_checkpoint_file
    from nvblox_mindmap_torch.utils import timers

    t_phase = time.perf_counter()
    root = os.path.join(work, "clip_loop")
    data = os.path.join(root, "dataset")
    dataset_bytes, write_s = write_app_dataset(data, vertex_features=False)

    # Datagen: every frame of the three demos, 120-d CLIP features.
    timers.reset_timers()
    datagen_ms = host_ms(lambda: datagen_app.main([
        "--task", APP_TASK, "--dataset", data, "--demos_datagen", "0-2",
        "--feature_type", "clip_resnet50_fpn", "--backbone_weights", npz,
        "--feature_image_size", f"{PATCHES},{PATCHES}", "--image_size", f"{IMAGE},{IMAGE}"]))
    frames = 3 * APP_FRAMES
    parts = {name.split("/")[1]: summary_ms([t * 1e3 for t in timers.timer_samples(name)])
             for name in ("datagen/decay", "datagen/compute_features", "datagen/integrate",
                          "datagen/export_mesh")}
    if any(p["reps"] != frames for p in parts.values()):
        raise AssertionError(f"clip_loop datagen: timers {parts}")
    vertices = []
    for d in range(3):
        for t in range(APP_FRAMES):
            item = item_io.load_item(os.path.join(data, f"demo_{d:05d}",
                                                  f"{t}.nvblox_vertex_features.zst"))
            n = len(item["vertices"])
            if item["features"].shape != (n, CLIP_FEATURES) or n == 0 or not np.isfinite(
                    item["features"]).all():
                raise AssertionError(f"clip_loop datagen: demo {d} frame {t} features "
                                     f"{item['features'].shape}")
            vertices.append(n)

    # Training: the FPN trains, the trunk stays.
    per_batch = {"flash_attention_split": 3 + 2 * EVAL_STEPS,
                 "flash_attention_tile": 8 * EVAL_STEPS}
    flags = ["--dataset", data, "--task", APP_TASK, "--data_type", "rgbd_and_mesh",
             "--feature_type", "clip_resnet50_fpn", "--feature_image_size",
             f"{PATCHES},{PATCHES}", "--embedding_dim", str(EMBEDDING),
             "--batch_size", str(TRAIN_BATCH), "--batch_size_val", str(TRAIN_BATCH),
             "--num_vertices_to_sample", str(VERTICES), "--demos_train", "0-1",
             "--demos_valset", "2", "--train_iters", str(CLIP_TRAIN_ITERS),
             "--val_freq", str(CLIP_TRAIN_ITERS), "--num_batches_per_test_eval", "1",
             "--skip_train_val", "1", "--backbone_weights", npz, "--num_workers", "4",
             "--print_progress_freq", "1", "--print_timers_freq", "1000000",
             "--base_log_dir", os.path.join(root, "logs")]
    timers.reset_timers()
    reset_flash_counts()
    torch.cuda.reset_peak_memory_stats()
    with step_profile(CLIP_PROFILED_STEPS) as steps:
        result = train_app.main(flags)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = flash_counts()
    if counts != per_batch:
        raise AssertionError(f"clip_loop train: {counts} flash launches, expected {per_batch}")
    launches = dict(counts)
    # Step 0 warms up; the profiled steps carry the profiler's own cost.
    timed_steps = slice(1, min(CLIP_PROFILED_STEPS))
    load = [t * 1e3 for t in timers.timer_samples("step/load_batch")[timed_steps]]
    train = [t * 1e3 for t in timers.timer_samples("step/train")[timed_steps]]
    fed = [a + b for a, b in zip(load, train)]
    best = os.path.join(result["checkpoint_dir"], "best.ckpt")
    if not np.isfinite(result["best_loss"]) or not os.path.exists(best):
        raise AssertionError(f"clip_loop train: {result['best_loss']}, {best}")
    state = load_checkpoint_file(best)["state_dict"]
    start = flax_to_state_dict(load_variables_npz(npz)["params"])
    prefix = "encoder.feature_extractor."
    for name, value in start.items():
        if name.startswith("backbone.") and not torch.equal(state[prefix + name], value):
            raise AssertionError(f"clip_loop train: the trunk's {name} changed")
    moved = sorted(name for name, value in start.items() if name.startswith("fpn.")
                   and not torch.equal(state[prefix + name], value))
    if not any(".layer_2." in n for n in moved) or len(moved) < 8:
        raise AssertionError(f"clip_loop train: the FPN moved only in {moved}")

    # The trained FPN (and the trunk) out of best.ckpt, into the mapping
    # feature function: the trained extractor's features on one frame.
    fpn_npz = os.path.join(root, "fpn.npz")
    extract_fpn_from_model.main(["--model_path", best, "--output_path", fpn_npz])
    extractor = ClipResNet50Fpn((PATCHES, PATCHES))
    extractor.load_state_dict({k[len(prefix):]: v for k, v in state.items()
                               if k.startswith(prefix)})
    extractor.to("cuda")
    frame = item_io.decode_png(os.path.join(data, "demo_00002", "0.wrist_rgb.png"))
    frame = torch.from_numpy(frame.astype(np.float32) / 255.0).cuda()
    feature_fn = make_feature_fn("clip_resnet50_fpn", (IMAGE, IMAGE), fpn_npz,
                                 (PATCHES, PATCHES), device="cuda")
    with torch.no_grad():
        want = resize_bilinear(extractor(frame[None]), (IMAGE, IMAGE))[0]
        got = feature_fn(frame)
    extract_err = (got - want).abs().max().item()
    if not extract_err <= 1e-5 * max(1.0, want.abs().max().item()):
        raise AssertionError(f"clip_loop extract: make_feature_fn vs the trained extractor "
                             f"{extract_err}")
    del extractor, feature_fn, state
    torch.cuda.empty_cache()

    # The closed-loop app: best.ckpt, the trained FPN's mapping features.
    times = collections.defaultdict(list)

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    Policy = policies.NvbloxDiffuserActorPolicy
    with contextlib.ExitStack() as patches:
        for owner, name, value in ((Policy, "step", timed("sim_step", Policy.step)),
                                   (Policy, "get_new_goal", timed("goal", Policy.get_new_goal))):
            patches.enter_context(mock.patch.object(owner, name, value))
        reset_flash_counts()
        summary = loop_app.main([
            "--task", APP_TASK, "--dataset", data, "--demos_closed_loop", "2",
            "--data_type", "rgbd_and_mesh", "--feature_type", "clip_resnet50_fpn",
            "--checkpoint", best, "--backbone_weights", fpn_npz,
            "--serving_scheduler", "ddim", "--serving_num_inference_steps",
            str(CLOSED_LOOP_STEPS), "--max_num_steps_to_goal", str(LOOP_STEPS_TO_GOAL),
            "--terminate_after_n_steps", str(LOOP_STEPS),
            "--eval_file_path", os.path.join(root, "closed_loop_eval.json")], "replay")
        loop_counts = flash_counts()
    goals = len(times["goal"])
    T = CLOSED_LOOP_STEPS
    expected = {"flash_attention_split": goals * (3 + 2 * T),
                "flash_attention_tile": goals * 8 * T}
    if goals < 3 or loop_counts != expected:
        raise AssertionError(f"clip_loop closed loop: {loop_counts} over {goals} goals, "
                             f"expected {expected}")
    add_launches(launches, loop_counts)
    phase("clip_loop", task=APP_TASK, feature_type="clip_resnet50_fpn", cameras=1,
          image=IMAGE, batch=TRAIN_BATCH, vertices=VERTICES, feature_dim=CLIP_FEATURES,
          context_tokens=APP_CONTEXT, self_attention_tokens=APP_SELF,
          dataset=dict(demos=3, frames=APP_FRAMES, mb=dataset_bytes / 1e6, write_s=write_s),
          datagen=dict(frames=frames, app_ms=datagen_ms, parts_per_frame=parts,
                       vertices_per_frame=dict(p50=statistics.median(vertices),
                                               min=min(vertices), max=max(vertices))),
          train=dict(steps=CLIP_TRAIN_ITERS, val_loss=result["best_loss"],
                     step_p50_ms=statistics.median(fed), step_ms=fed,
                     load_batch_p50_ms=statistics.median(load),
                     train_p50_ms=statistics.median(train), idle=steps.fields(),
                     peak_memory_gb=peak_gb, fpn_tensors_moved=len(moved),
                     trunk_bit_for_bit=True, launches_per_eval_batch=counts),
          extract=dict(make_feature_fn_vs_trained_max_abs_err=extract_err),
          closed_loop=dict(world="replay", sampler=f"ddim{T}", goals=goals,
                           launches=loop_counts, summary=summary,
                           sim_step=summary_ms(times["sim_step"]), goal=summary_ms(times["goal"])),
          seconds=time.perf_counter() - t_phase)
    return launches


def language_expected(T):
    """Flash launches of one prediction of the language model: split 3
    (gripper history) + 2 per step (denoiser cross) + 1 per step
    (trajectory -> instruction); tile 2 (vision -> instruction) + 8 per
    step (self-attention) + 5 per step (the interleaved cross layers to the
    instruction: 3 + 1 + 1)."""
    return {"flash_attention_split": 3 + 3 * T, "flash_attention_tile": 2 + 13 * T}


def run_language():
    """Phase ``language``: the flagship prediction (rgbd_and_mesh, 2 cameras,
    4096 context and 820 self-attention tokens) with ``use_instruction`` and
    ``lang_enhanced`` and a (B, 53, 512) instruction of random features,
    DDIM-10 at B = 1 and 8: flash against eager attention (atol 5e-3), the
    launches of each kernel, the host-clock p50 of each impl and, at B = 1,
    the profile. Returns each kernel's launches."""
    import dataclasses
    from unittest import mock

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
    from nvblox_mindmap_torch.ops.attention import set_default_attention_impl

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(model_config("rgbd_and_mesh"), use_instruction=True,
                              lang_enhanced=True)
    torch.manual_seed(0)
    model = DiffuserActor(cfg, device="cuda")
    bounds = np.asarray(WORKSPACE, dtype=np.float32)
    sampler = convert_diffusion_scheduler(CLOSED_LOOP_STEPS)
    T = sampler["num_inference_steps"]
    launches = {}
    for B, reps in zip((1, 8), LANGUAGE_REPS):
        batch = make_batch(B, "rgbd_and_mesh", seed=7)
        batch["instruction"] = np.random.default_rng(8).normal(
            size=(B, INSTRUCTION_TOKENS, INSTRUCTION_DIM)).astype(np.float32)
        prepared = prepare_inputs(batch, bounds, cfg, device="cuda")
        init = torch.randn((B, 1, 1, 9), generator=torch.Generator(device="cuda").manual_seed(9),
                           device="cuda")

        def predict():
            return sample_trajectory(model, prepared, bounds, init_noise=init, **sampler)[0]

        # The encoder under each impl: vision -> instruction attention moves
        # the context features (to ~1e-6), and FPS over them can then pick
        # another token at a near-tie, so the denoising is compared from
        # one (eager) encoding, and whole predictions where the picks agree.
        encoded = {}
        with torch.no_grad():
            for impl in ("eager", "flash"):
                set_default_attention_impl(impl)
                encoded[impl] = model.encode_prepared(prepared)
        fixed = encoded["eager"]
        tokens = (fixed["context_feats"].shape[1], 1 + fixed["fps_feats"].shape[1],
                  fixed["instr_feats"].shape[1])
        if tokens != (CONTEXT["rgbd_and_mesh"], 1 + CONTEXT["rgbd_and_mesh"] // FPS_FACTOR,
                      INSTRUCTION_TOKENS):
            raise AssertionError(f"language: tokens {tokens}")
        context_err = (encoded["flash"]["context_feats"] - fixed["context_feats"]).abs().max()
        if not context_err.item() <= DENOISE_ATOL:
            raise AssertionError(f"language B={B}: flash vs eager context {context_err}")
        same_picks = (encoded["flash"]["fps_pos"] == fixed["fps_pos"]).flatten(1).all(1)
        set_default_attention_impl("eager")
        traj_eager = predict()
        with mock.patch.object(model, "encode_prepared", lambda *a, **k: fixed):
            shared_eager = predict()
            set_default_attention_impl("flash")
            shared_flash = predict()
        denoise_err = (shared_flash - shared_eager).abs().max().item()
        if not denoise_err <= TRAJ_ATOL:
            raise AssertionError(f"language B={B}: flash vs eager from one encoding "
                                 f"{denoise_err} > {TRAJ_ATOL}")
        apply_inference_settings(convert_to_flash_attention())
        reset_flash_counts()
        traj = predict()
        torch.cuda.synchronize()
        counts = flash_counts()
        if counts != language_expected(T):
            raise AssertionError(f"language B={B}: {counts}, expected {language_expected(T)}")
        add_launches(launches, counts)
        rows_err = (traj - traj_eager).abs().flatten(1).amax(1)
        err = rows_err.max().item()
        agreed_err = rows_err[same_picks].max().item() if bool(same_picks.any()) else 0.0
        if traj.shape != (B, 1, 1, 8) or not bool(torch.isfinite(traj).all()) or not (
                agreed_err <= TRAJ_ATOL):
            raise AssertionError(f"language B={B}: {tuple(traj.shape)}, flash vs eager "
                                 f"{agreed_err} where the FPS picks agree")
        times = {"flash": [], "eager": []}
        for i in range(reps):
            for impl in (("flash", "eager") if i % 2 == 0 else ("eager", "flash")):
                set_default_attention_impl(impl)
                times[impl].append(host_ms(predict))
        set_default_attention_impl("flash")
        fields = dict(B=B, steps=T, context_tokens=tokens[0], self_attention_tokens=tokens[1],
                      instruction_tokens=tokens[2], launches=counts,
                      context_flash_vs_eager_max_abs_err=context_err.item(),
                      fps_picks_agree=same_picks.tolist(),
                      flash_vs_eager_from_one_encoding_max_abs_err=denoise_err,
                      flash_vs_eager_max_abs_err=err,
                      flash_vs_eager_where_picks_agree_max_abs_err=agreed_err,
                      flash=summary_ms(times["flash"]), eager=summary_ms(times["eager"]))
        if B == 1:
            fields["profile"] = profile(predict, fields["flash"]["p50_ms"])
        set_default_attention_impl("eager")
        phase("language", **fields)
    del model
    torch.cuda.empty_cache()
    phase("language_done", seconds=time.perf_counter() - t_phase)
    return launches


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
# scripts/place_grounding_probe: its summary fits slopes to 4 released
# scenes or more, and a scene may end with no release (1 of 4 did on the
# card), so 8 scenes; the cube fixture samples DDPM at its 100 training
# timesteps.
PROBE_FIXTURE = os.path.join(FIXTURES, "task_success", "cube_stacking", "last.ckpt")
PROBE_SCENES = 8
PROBE_STEPS = 100
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
    into PATH_SHAPES (the kernels themselves run as before). A launch into a
    CUDA graph under capture runs nothing and counts nothing; each replay of
    the graph counts the calls it replays (``fa.REPLAYED``), whose shapes
    are added too. On leaving, the launches recorded and replayed must equal
    the launches the kernels counted, so a recorder that the path went round
    fails the run."""

    def __enter__(self):
        import torch

        from nvblox_mindmap_torch.ops import flash_attention as fa

        self.fa, self.original = fa, fa.run_kernel
        self.recorded, self.before = 0, sum(fa.KERNEL_LAUNCHES.values())
        self.replayed = dict(fa.REPLAYED)

        def recording(name, q, k, v, key_padding_mask=None):
            B, H, L, D = q.shape
            if L > 0:  # run_kernel launches nothing for no queries
                PATH_SHAPES.add((B, H, L, k.shape[2], D, key_padding_mask is not None))
                self.recorded += not torch.cuda.is_current_stream_capturing()
            return self.original(name, q, k, v, key_padding_mask)

        fa.run_kernel = recording
        return self

    def __exit__(self, exc_type, *exc):
        self.fa.run_kernel = self.original
        replayed = {call: n - self.replayed.get(call, 0)
                    for call, n in self.fa.REPLAYED.items()
                    if n > self.replayed.get(call, 0)}
        PATH_SHAPES.update((*call.q_shape[:3], call.keys, call.q_shape[3],
                            call.valid_keys is not None) for call in replayed)
        recorded = self.recorded + sum(replayed.values())
        launched = sum(self.fa.KERNEL_LAUNCHES.values()) - self.before
        if exc_type is None and (launched == 0 or recorded != launched):
            raise AssertionError(f"recording_shapes: {recorded} of {launched} "
                                 "kernel launches recorded or replayed")
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
        reset_fps_launches()
        with mock.patch.object(Policy, "get_new_goal", timed("goal", Policy.get_new_goal)), \
                mock.patch.object(runner, "run_one_episode",
                                  timed("episode", runner.run_one_episode)), \
                recording_shapes():
            summary = exp.closed_loop(
                root, TASK_SUCCESS_DEMOS, os.path.join(FIXTURES, "task_success", task,
                                                       "last.ckpt"),
                demos_subset=TASK_SUCCESS_SUBSET, task=task, device="cuda", **serving)
        counts = flash_counts()
        fps_n = fps_launches()
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
               launches_per_goal=per_sample(T), fps_launches=fps_n,
               goal=summary_ms(times["goal"]),
               episodes=len(times["episode"]),
               episode=summary_ms(times["episode"]), generate_s=gen_s,
               seconds=time.perf_counter() - t_task)
    return row, dict(counts, fps=fps_n), sorted(PATH_SHAPES)


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
    reset_fps_launches()
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
                  fps_launches=fps_launches(), seconds=time.perf_counter() - t_phase)
    return fields, dict(launches, fps=fps_launches()), sorted(PATH_SHAPES)


def probe_one():
    """Phase ``place_grounding``: ``scripts/place_grounding_probe`` (its
    ``main``, on the card) with the committed cube_stacking fixture over
    PROBE_SCENES fresh scenes (seeds 9000 on): the scripted expert through
    the lift, then the policy's goals (DDPM-100, the flash kernels) until it
    commands a release. Every goal must launch 3 + 2*T split and 8*T tile
    calls. Returns the phase's fields, the launches and the flash shapes."""
    from unittest import mock

    import torch

    from nvblox_mindmap_torch.closed_loop import policies
    from nvblox_mindmap_torch.scripts import place_grounding_probe as probe

    t_phase = time.perf_counter()
    goal_ms = []
    Policy = policies.NvbloxDiffuserActorPolicy
    real = Policy.get_new_goal

    def timed(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        goals = real(self, *args, **kwargs)
        torch.cuda.synchronize()
        goal_ms.append((time.perf_counter() - t0) * 1e3)
        return goals

    root = tempfile.mkdtemp(prefix="mindmap_probe_")
    try:
        out = os.path.join(root, "place_grounding.json")
        reset_flash_counts()
        reset_fps_launches()
        with mock.patch.object(Policy, "get_new_goal", timed), recording_shapes():
            probe.main(["--checkpoint", PROBE_FIXTURE, "--scenes", str(PROBE_SCENES),
                        "--out", out])
        counts = flash_counts()
        fps_n = fps_launches()
        with open(out) as f:
            result = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    expected = {k: len(goal_ms) * v for k, v in per_sample(PROBE_STEPS).items()}
    if counts != expected or not goal_ms:
        raise AssertionError(f"place_grounding: {counts} flash launches over {len(goal_ms)} "
                             f"goals, expected {expected}")
    summary, rows = result["summary"], result["rows"]
    if summary["num_scenes"] != PROBE_SCENES or len(rows) != PROBE_SCENES or not all(
            map(math.isfinite, r["cube_1_xy"] + (r["release_xy"] or []))
            for r in rows):
        raise AssertionError(f"place_grounding: {result}")
    fields = dict(fixture=os.path.relpath(PROBE_FIXTURE, ROOT), scenes=PROBE_SCENES,
                  seed_base=9000, sampler=f"ddpm{PROBE_STEPS}", **summary, rows=rows,
                  goals=len(goal_ms), goal=summary_ms(goal_ms), launches=counts,
                  launches_per_goal=per_sample(PROBE_STEPS), fps_launches=fps_n,
                  seconds=time.perf_counter() - t_phase)
    return fields, dict(counts, fps=fps_n), sorted(PATH_SHAPES)


def run_experiments(beside=None):
    """Phases ``task_success`` (one worker process per task),
    ``spatial_memory`` (a fifth) and ``place_grounding`` (a sixth), side by
    side in spawned workers. Each is host-bound (the scene world's render,
    the samplers' dispatch: the card idles ~0.9 of the time), so together
    they take about the time of the longest; their host times are measured
    with the others running, and with ``beside()``, which this process runs
    meanwhile. Returns each kernel's launches over all six (the FPS
    kernel's under ``fps``), and what ``beside`` returned."""
    import concurrent.futures
    import multiprocessing

    workers = len(TASK_SUCCESS) + 2
    launches = {}
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=init_worker, initargs=(workers,)) as pool:
        tasks = [pool.submit(task_success_one, *task) for task in TASK_SUCCESS]
        spatial = pool.submit(spatial_memory_one)
        probe = pool.submit(probe_one)
        beside_result = beside() if beside is not None else None
        for future in tasks:
            row, counts, shapes = future.result()
            add_launches(launches, counts)
            PATH_SHAPES.update(map(tuple, shapes))
            phase("task_success", workers=workers, **row)
        for name, future in (("spatial_memory", spatial), ("place_grounding", probe)):
            fields, counts, shapes = future.result()
            add_launches(launches, counts)
            PATH_SHAPES.update(map(tuple, shapes))
            phase(name, workers=workers, **fields)
    return launches, beside_result


def run_clip_and_language(work):
    """Phases ``clip_extractor``, ``clip_loop`` and ``language``, on a
    seeded random CLIP .npz under ``work``. Returns each kernel's
    launches."""
    npz = os.path.join(work, "clip_resnet50_fpn.npz")
    save_random_clip(npz)
    measure_clip(npz)
    launches = run_clip_loop(work, npz)
    add_launches(launches, run_language())
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
    fps_rows = check_fps_kernel()
    measure_threshold()
    measure_vit()
    # The FPS kernel's launches on each main path, from 0 at the path's
    # start (check_fps_kernel's own calls are not among them).
    fps_by_path = {}

    def counting_fps(path, fn, *args, **kwargs):
        reset_fps_launches()
        result = fn(*args, **kwargs)
        fps_by_path[path] = fps_by_path.get(path, 0) + fps_launches()
        return result

    launches = {}
    for data_type, reps in (("mesh", (4, 20)), ("rgbd_and_mesh", (6, 24))):
        path_launches = counting_fps(f"predict_{data_type}", run_slice, data_type, reps)
        for kernel, n in path_launches.items():
            launches[kernel] = launches.get(kernel, 0) + n
    check_mapper()
    measure_fusion()
    for kernel, n in counting_fps("closed_loop", run_closed_loop).items():
        launches[kernel] = launches.get(kernel, 0) + n
    measure_sampler_graph()
    train_launches, resident_step_ms = counting_fps("train", run_training_phase, smi)
    for kernel, n in train_launches.items():
        launches[kernel] = launches.get(kernel, 0) + n
    work = tempfile.mkdtemp(prefix="mindmap_loop_")
    ddp = None
    try:
        app_launches, ddp = counting_fps("train_app", run_train_app, resident_step_ms, work)
        add_launches(launches, app_launches)
        # The task-success and spatial-memory workers are host-bound: the
        # torchrun run of phase ddp, and in this process the CLIP and
        # language phases, run beside them. This process's FPS launches
        # meanwhile are the CLIP and language phases'; the workers count
        # their own.
        experiment_launches, clip_launches = counting_fps(
            "clip_and_language", run_experiments, beside=lambda: run_clip_and_language(work))
        fps_by_path["experiments"] = experiment_launches.pop("fps")
        add_launches(launches, experiment_launches)
        add_launches(launches, clip_launches)
        add_launches(launches, finish_ddp(ddp))
        npz = os.path.join(work, "radio_v25_b.npz")
        save_random_backbone(npz)
        dataset = os.path.join(work, "dataset")
        demo = counting_fps("datagen_app", run_datagen_app, dataset, npz)
        run_reconstruction(dataset, demo, work)
        loop_launches, in_process = counting_fps(
            "closed_loop_app", run_closed_loop_app, dataset, os.path.join(work, "best.ckpt"),
            npz)
        add_launches(launches, loop_launches)
        add_launches(launches, counting_fps(
            "remote_loop", run_remote_loop, dataset, os.path.join(work, "best.ckpt"), npz,
            in_process))
        run_runtime_tools(dataset, work)
    finally:
        stop_ddp(ddp)
        shutil.rmtree(work, ignore_errors=True)
    add_launches(launches, counting_fps("serving", run_serving))
    add_launches(launches, counting_fps("api_surface", run_api_surface))
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
    entries.append({
        "name": "fps",
        "route": "cuda",
        "source": "nvblox_mindmap_torch/csrc/fps.cu",
        "replaces": "none: nvblox_mindmap_tpu/ops/fps.py is a lax.scan that XLA compiles",
        "launches": sum(fps_by_path.values()),
        "launches_by_path": fps_by_path,
        "picks_equal_to_eager": all(r["picks_equal"] for r in fps_rows.values()),
        **{f"{name}_{key}": row[key] for name, row in fps_rows.items()
           for key in ("kernel_ms", "plain_ms", "bound_ms", "share")},
    })
    split_entry = next(e for e in entries if e["name"] == "flash_attention_split")
    split_entry.update(goal_gripper_ms=checks[("flagship_goal_cross", 1)]["kernel_ms"],
                       goal_gripper_shape="flagship encode_goal_gripper B=1 H=8 L=1 S=4096 "
                                          "D=15 unmasked")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
