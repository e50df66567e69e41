"""Torch port on the card: its sampler, trainer, apps, experiments and public
surface run end to end on the card at the smallest sizes that exercise them,
each held to eager attention, to the same code on the CPU, to itself
reloaded, or to the bar its experiment sets.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere. The
file imports neither JAX nor the JAX package; run it on a machine without
them, with the JAX-importing ``tests/conftest.py`` skipped:

    python -m pytest tests/test_torch_cuda_apps.py -q --noconftest

Tolerances and helpers are ``tests/cuda_helpers.py``'s: flash against eager
attention 5e-3 for trajectories and 1e-4 for one denoiser pass, the kernels
against their plain version 2e-5. Every flash shape that the apps and
experiments launch is held against the plain version (``held_shapes``).
Counts: a DDIM-10 goal, sample or eval batch launches 3 + 2*10 split and
8*10 tile kernels (a CUDA graph replay counts what its capture launched), a
train step none, a goal one FPS kernel.
"""
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from nvblox_mindmap_torch.models.converter import convert_diffusion_scheduler
from nvblox_mindmap_torch.models.diffuser_actor import prepare_inputs, sample_trajectory
from nvblox_mindmap_torch.ops.attention import set_default_attention_impl
from cuda_helpers import (
    BOUNDS,
    DENOISE_ATOL,
    DEVICE,
    SPLIT,
    TILE,
    TRAJ_ATOL,
    VERTICES,
    assert_trajectory,
    attention,
    batch_of,
    flagship,
    flash,
    held_shapes,
    launches,
    per_goal,
)

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "test_data")
LOOP_FIXTURE = os.path.join(FIXTURES, "task_success", "cube_stacking", "last.ckpt")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc) to build and run the kernels")


# ------------------------------------------------ predictions through the kernels


def test_serving_rows_equal_single_requests(card):
    """Eight requests per call through ``make_sharded_infer_fn``: each row as
    the request served alone, flash as eager, the parameters copied once."""
    from nvblox_mindmap_torch.parallel.serving import make_sharded_infer_fn

    model = flagship()
    batch, _ = batch_of(8, seed=8)
    params = model.state_dict()
    init = torch.randn((8, 1, 1, 9), generator=torch.Generator(DEVICE).manual_seed(9),
                       device=DEVICE)
    with attention("flash"):
        infer = make_sharded_infer_fn(model, BOUNDS, [DEVICE], **convert_diffusion_scheduler(10))
        traj = infer(params, batch, init_noise=init)[0]
        with launches() as counts:
            for _ in range(2):
                infer(params, batch, init_noise=init)
        rows = [infer(params, {k: v[i:i + 1] for k, v in batch.items()},
                      init_noise=init[i:i + 1])[0] for i in range(8)]
        set_default_attention_impl("eager")
        eager = infer(params, batch, init_noise=init)[0]
    assert flash(counts) == per_goal(10, goals=2)
    assert_trajectory(traj, 8)
    torch.testing.assert_close(torch.cat(rows), traj, rtol=0, atol=DENOISE_ATOL)
    torch.testing.assert_close(eager, traj, rtol=0, atol=TRAJ_ATOL)
    assert infer.copies == 1


@pytest.mark.parametrize("B", [1, 8])
def test_language_model_through_the_kernels(card, B):
    """``use_instruction`` and ``lang_enhanced`` over a (B, 53, 512)
    instruction: per DDIM-10 prediction 3 + 3*T split and 2 + 13*T tile
    launches. Vision -> instruction attention moves the context features to
    ~1e-6, which can flip an FPS pick at a near-tie: the denoising is held
    from one encoding, whole predictions where the picks agree."""
    model = flagship(use_instruction=True, lang_enhanced=True)
    batch, _ = batch_of(B, seed=7)
    batch["instruction"] = np.random.default_rng(8).normal(size=(B, 53, 512)).astype(np.float32)
    prepared = prepare_inputs(batch, BOUNDS, model.config, device=DEVICE)
    sampler = convert_diffusion_scheduler(10)
    init = torch.randn((B, 1, 1, 9), generator=torch.Generator(DEVICE).manual_seed(9),
                       device=DEVICE)

    def predict():
        return sample_trajectory(model, prepared, BOUNDS, init_noise=init, **sampler)[0]

    encoded = {}
    with torch.no_grad():
        for impl in ("eager", "flash"):
            with attention(impl):
                encoded[impl] = model.encode_prepared(prepared)
    fixed = encoded["eager"]
    assert (fixed["context_feats"].shape[1], 1 + fixed["fps_feats"].shape[1],
            fixed["instr_feats"].shape[1]) == (VERTICES, 1 + VERTICES // 5, 53)
    torch.testing.assert_close(encoded["flash"]["context_feats"], fixed["context_feats"],
                               rtol=0, atol=DENOISE_ATOL)
    same_picks = (encoded["flash"]["fps_pos"] == fixed["fps_pos"]).flatten(1).all(1)
    shared = {}
    with mock.patch.object(model, "encode_prepared", lambda *a, **k: fixed):
        for impl in ("eager", "flash"):
            with attention(impl):
                shared[impl] = predict()
    torch.testing.assert_close(shared["flash"], shared["eager"], rtol=0, atol=TRAJ_ATOL)
    with attention("eager"):
        eager = predict()
    with attention("flash"), launches() as counts:
        traj = predict()
    assert flash(counts) == {SPLIT: 3 + 3 * 10, TILE: 2 + 13 * 10}
    assert_trajectory(traj, B)
    assert bool(((traj - eager).abs().flatten(1).amax(1)[same_picks] <= TRAJ_ATOL).all())


def test_peract_policy_replays_its_loop_bit_equal(card):
    """3D Diffuser Actor's PerAct configuration at its smallest size, built as
    the open-loop app builds it: ``rgbd`` over the CLIP ResNet-50 FPN, four
    64x64 cameras (256 tokens, FPS to 51), a (1, 53, 512) instruction, xyzw
    quaternions, stochastic DDPM-100 through ``make_infer_fn``. One capture
    for the goal shape, whose static inputs hold the instruction's features
    and the step noise; each replay, on other instructions and seeds, equals
    the eager loop to the bit, with its flash launches: per goal 3 + 3*T
    split (the history, then per step the cross-attention and the
    trajectory-to-instruction layer) and 2 + 8*T tile (the vision-language
    layers, then the self-attention stack)."""
    from nvblox_mindmap_torch.apps.run_open_loop_policy import make_infer_fn
    from nvblox_mindmap_torch.models import diffuser_actor as da
    from nvblox_mindmap_torch.utils.config import ModelArgs, model_config_from_args

    args = ModelArgs(data_type="rgbd", feature_type="clip_resnet50_fpn", image_size=(64, 64),
                     feature_image_size=(8, 8), use_instruction=1, lang_enhanced=0,
                     embedding_dim=120, num_vis_ins_attn_layers=2, fps_subsampling_factor=5,
                     num_history=3, diffusion_timesteps=100, rotation_parametrization="6D",
                     quaternion_format="xyzw")
    torch.manual_seed(0)
    model = da.DiffuserActor(model_config_from_args(args), device=DEVICE)
    T = 100

    def goal_batch(seed):
        rng = np.random.default_rng(seed)
        quat = rng.normal(size=(1, 3, 1, 4))
        quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
        return {
            "rgbs": rng.integers(0, 256, (1, 4, 64, 64, 3), dtype=np.uint8),
            "pcds": rng.uniform(BOUNDS[0], BOUNDS[1], (1, 4, 64, 64, 3)).astype(np.float32),
            "gripper_history": np.concatenate(
                [rng.uniform(BOUNDS[0], BOUNDS[1], (1, 3, 1, 3)), quat,
                 rng.integers(0, 2, (1, 3, 1, 1))], -1).astype(np.float32),
            "instruction": rng.normal(size=(1, 53, 512)).astype(np.float32),
        }

    paths = ("graph_captures", "graph_replays", "eager_calls")

    def call(batch, seed, eager=False):
        before = [getattr(da.sample_trajectory, p) for p in paths]
        patch = mock.patch.object(da, "_graph_applies", lambda *a: False)
        with patch if eager else contextlib.nullcontext(), launches() as counts:
            traj = infer(batch, seed)[0]
        return traj, flash(counts), tuple(getattr(da.sample_trajectory, p) - b
                                          for p, b in zip(paths, before))

    first, second = goal_batch(1), goal_batch(2)
    with attention("flash"):
        infer = make_infer_fn(model, BOUNDS)
        eager_a, eager_b = call(first, 11, eager=True), call(second, 12, eager=True)
        captured = call(first, 11)
        replay_a, replay_b = call(first, 11), call(second, 12)
    kernels = {SPLIT: 3 + 3 * T, TILE: 2 + 8 * T}
    assert [c[1] for c in (eager_a, eager_b, captured, replay_a, replay_b)] == [kernels] * 5
    assert eager_a[2] == eager_b[2] == (0, 0, 1)
    assert captured[2] == (1, 0, 0) and replay_a[2] == replay_b[2] == (0, 1, 0)
    for got, want in ((captured, eager_a), (replay_a, eager_a), (replay_b, eager_b)):
        assert torch.equal(got[0], want[0])
    assert not torch.equal(eager_a[0], eager_b[0])
    assert_trajectory(eager_a[0], 1)
    (entry,) = da._GRAPHS[model].values()
    assert entry.inputs["instr_feats"].shape == (1, 53, 120)
    assert entry.inputs["fps_feats"].shape == (1, 51, 120)
    assert entry.noise.shape == (T, 1, 1, 1, 9)


# ------------------------------------------------------------ the public surface


@pytest.mark.parametrize("B", [1, 8])
def test_goal_gripper_query_through_the_split_kernel(card, B):
    """``Encoder.encode_goal_gripper`` over 4096 keys: one split launch per
    layer (L = 1, unmasked), flash as eager."""
    model = flagship()
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    lo, hi = torch.tensor(BOUNDS, device=DEVICE)
    args = (torch.cat([lo + (hi - lo) * torch.rand(B, 3, device=DEVICE, generator=gen),
                       torch.rand(B, 5, device=DEVICE, generator=gen)], dim=1),
            torch.randn(B, 4096, 120, device=DEVICE, generator=gen),
            lo + (hi - lo) * torch.rand(B, 4096, 3, device=DEVICE, generator=gen))
    with torch.no_grad():
        eager = model.encoder.encode_goal_gripper(*args, impl="eager")
        with launches() as counts:
            out = model.encoder.encode_goal_gripper(*args, impl="flash")
    assert flash(counts) == {SPLIT: 3, TILE: 0}
    assert out[0].shape == (B, 1, 120) and out[1].shape == (B, 1, 120, 2)
    assert bool(torch.isfinite(out[0]).all())
    for a, b in zip(out, eager):
        torch.testing.assert_close(a, b, rtol=0, atol=TRAJ_ATOL)


@pytest.mark.parametrize("variant", ["slot_competition", "gate_memory", "gate_memory_mem_mask",
                                     "return_kv"])
def test_attention_variants_take_the_eager_path(card, variant):
    """Under the flash impl a ``MultiheadAttention`` variant launches no
    kernel and gives the CPU's result (821 queries over 4096 keys)."""
    import copy

    from nvblox_mindmap_torch.models.layers import MultiheadAttention
    from nvblox_mindmap_torch.ops.positional import rotary_pe_3d

    gen = torch.Generator().manual_seed(12)
    query, context = torch.randn(1, 821, 120, generator=gen), torch.randn(1, 4096, 120,
                                                                          generator=gen)
    memory = torch.randn(1, 256, 120, generator=gen)
    kwargs = dict(rotary_codes=(rotary_pe_3d(torch.rand(1, 821, 3, generator=gen), 120),
                                rotary_pe_3d(torch.rand(1, 4096, 3, generator=gen), 120)),
                  key_padding_mask=torch.rand(1, 4096, generator=gen) < 0.1)
    fields, extra = {
        "slot_competition": (dict(slot_competition=True), {}),
        "gate_memory": (dict(gate_attn=True), dict(k_mem=memory, v_mem=memory)),
        "gate_memory_mem_mask": (dict(gate_attn=True), dict(
            k_mem=memory, v_mem=memory,
            mem_mask=(torch.rand(1, 256, generator=gen) > 0.3).float())),
        "return_kv": ({}, dict(return_kv=True)),
    }[variant]
    kwargs.update(extra)
    torch.manual_seed(13)
    cpu_module = MultiheadAttention(120, 8, **fields)
    card_module = copy.deepcopy(cpu_module).to(DEVICE)

    def on_card(x):
        if isinstance(x, tuple):
            return tuple(on_card(t) for t in x)
        return x.to(DEVICE) if isinstance(x, torch.Tensor) else x

    with torch.no_grad(), attention("flash"), launches() as counts:
        out = card_module(*(on_card(x) for x in (query, context, context)),
                          **{k: on_card(v) for k, v in kwargs.items()})
    ref = cpu_module(query, context, context, **kwargs)
    assert not any(flash(counts).values())
    for a, b in zip(out, ref):
        if a is not None:
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)


def test_profiler_trace_names_each_kernel(card, tmp_path):
    """A ``ProfilerTrace`` of one DDIM-10 prediction: its Chrome trace names
    each kernel as often as the counters do."""
    from nvblox_mindmap_torch.utils.timers import ProfilerTrace

    model = flagship()
    prepared = prepare_inputs(batch_of(1, seed=14)[0], BOUNDS, model.config, device=DEVICE)
    init = torch.randn((1, 1, 1, 9), device=DEVICE)
    with attention("flash"):
        predict = lambda: sample_trajectory(model, prepared, BOUNDS, init_noise=init,  # noqa
                                            **convert_diffusion_scheduler(10))[0]
        predict()  # the capture
        with launches() as counts, ProfilerTrace(str(tmp_path)) as trace:
            traj = predict()
    with open(trace.path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    in_trace = {SPLIT: sum("flash_split_kernel" in n for n in names),
                TILE: sum("flash_tile_kernel" in n for n in names)}
    assert flash(counts) == in_trace == per_goal(10)
    assert_trajectory(traj, 1)


def test_rotations_match_the_cpu(card):
    from nvblox_mindmap_torch.geometry import rotations

    gen = torch.Generator().manual_seed(12)
    quats = torch.randn(1024, 4, generator=gen)
    quats /= quats.norm(dim=-1, keepdim=True)
    points, axis_angle = torch.randn(1024, 3, generator=gen), torch.randn(1024, 3, generator=gen)
    angles = (torch.rand(1024, 3, generator=gen) * 2 - 1) * math.pi
    matrices = rotations.quaternion_to_matrix(quats)
    calls = [lambda d: rotations.quaternion_apply(quats.to(d), points.to(d)),
             lambda d: rotations.axis_angle_to_quaternion(axis_angle.to(d)),
             lambda d: rotations.axis_angle_to_matrix(axis_angle.to(d)),
             lambda d: rotations.matrix_to_axis_angle(matrices.to(d))]
    for c in ("XYZ", "XZY", "YXZ", "YZX", "ZXY", "ZYX", "XYX", "XZX", "YXY", "YZY", "ZXZ",
              "ZYZ"):
        calls += [lambda d, c=c: rotations.euler_angles_to_matrix(angles.to(d), c),
                  lambda d, c=c: rotations.matrix_to_euler_angles(matrices.to(d), c)]
    for call in calls:
        torch.testing.assert_close(call(DEVICE).cpu(), call("cpu"), rtol=0, atol=1e-4)


# --------------------------------------------------------------------- training


def train_batch(B, seed):
    batch, _ = batch_of(B, seed=seed)
    rng = np.random.default_rng(seed + 10_000)
    quat = rng.normal(size=(B, 1, 1, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    batch["gt_gripper_pred"] = np.concatenate(
        [rng.uniform(-0.3, 0.6, (B, 1, 1, 3)), quat, rng.integers(0, 2, (B, 1, 1, 1))],
        -1).astype(np.float32)
    return batch


def test_trainer_on_the_card(card, tmp_path):
    """With the flash impl installed: after one update every parameter a
    keypose path reads gets a finite, non-zero gradient; steps launch no
    flash kernel and one FPS kernel each; eval batches launch 23 + 80 each;
    ``run_training`` saves, a new trainer resumes at its iteration and its
    next step equals the trainer that went on; 20 steps on one batch, noise
    and timesteps lower the loss."""
    from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig

    cfg = flagship().config
    tcfg = TrainerConfig(batch_size=4, train_iters=202, checkpoint_dir=str(tmp_path), val_freq=2,
                         skip_train_val=True, num_batches_per_test_eval=1,
                         eval_num_inference_steps=10)
    trainer = Trainer(cfg, tcfg, BOUNDS, device=DEVICE)
    model, optimizer = trainer.init_state()
    host = [train_batch(4, seed) for seed in (0, 1)]
    batches = [{k: torch.as_tensor(v, device=DEVICE) for k, v in b.items()} for b in host]
    named = dict(model.named_parameters())
    trainable = {n for n, p in named.items() if p.requires_grad}
    with attention("flash"):
        with launches() as counts:
            steps = [float(trainer.train_one_step(batches[s % 2], s)["total"]) for s in range(3)]
        assert flash(counts) == {SPLIT: 0, TILE: 0} and counts["fps"] == 3
        assert np.isfinite(steps).all()
        losses = trainer.compute_loss_and_grads(batches[0], 3)
        no_grad = {n for n in trainable if named[n].grad is None}
        assert no_grad == {"encoder.goal_gripper_embed"}
        assert bool(torch.isfinite(losses["total"]))
        for n in trainable - no_grad:
            assert bool(torch.isfinite(named[n].grad).all()) and bool(named[n].grad.any()), n
        optimizer.step()
        optimizer.zero_grad()
        with launches() as counts:
            mean_loss, metrics = trainer.evaluate_nsteps(batches, 4, 2, "val")
        assert flash(counts) == per_goal(10, goals=2)
        assert np.isfinite(mean_loss) and all(np.isfinite(v).all() for v in metrics.values())
        with launches() as counts:
            best = trainer.run_training(host, [batches[0]], start_iter=200)
        assert flash(counts) == per_goal(10)
        resumed = Trainer(cfg, tcfg, BOUNDS, device=DEVICE)
        assert resumed.load_checkpoint(str(tmp_path / "last.ckpt")) == (201, best)
        assert (float(trainer.train_one_step(batches[1], 202)["total"])
                == float(resumed.train_one_step(batches[1], 202)["total"]))
        for a, b in zip(trainer.model.parameters(), resumed.model.parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    noise = torch.randn((4, 1, 1, 9), generator=gen, device=DEVICE)
    timesteps = torch.randint(0, 100, (4,), generator=gen, device=DEVICE)
    learner = Trainer(cfg, tcfg, BOUNDS, device=DEVICE)
    learner.init_state()
    curve = [float(learner.train_one_step(batches[0], s, noise, timesteps)["total"])
             for s in range(21)]
    assert curve[-1] < curve[0]


# ------------------------------------------- the training, open-loop and packed apps

APP = ["--task", "cube_stacking", "--data_type", "rgbd_and_mesh", "--feature_type", "radio_v25_b",
       "--image_size", "64,64", "--feature_image_size", "4,4", "--embedding_dim", "120",
       "--batch_size", "8", "--batch_size_val", "8", "--num_vertices_to_sample", "256",
       "--demos_train", "0-1", "--demos_valset", "2", "--num_batches_per_test_eval", "1",
       "--skip_train_val", "1", "--print_progress_freq", "1", "--print_timers_freq", "1000000",
       "--device", DEVICE]
APP_TOKENS = (256 + 16, 1 + (256 + 16) // 5)  # context; self-attention
LOSS_LINE = r"step (\d+)/\d+ \(epoch \d+\): total (-?[0-9.]+)"
VAL_LINE = r"\[val\] step (\d+): loss (\S+), distance (\S+) m, rot err (\S+) deg"


def logged(text):
    """The trainer's logged train losses (step -> total) and validation lines
    (step -> loss, distance, rotation error), as printed."""
    import re

    return ({int(s): float(v) for s, v in re.findall(LOSS_LINE, text)},
            {int(m[0]): tuple(map(float, m[1:])) for m in re.findall(VAL_LINE, text)})


@contextlib.contextmanager
def trainer_log():
    import logging

    lines, handler = [], logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger("nvblox_mindmap_torch.trainer")
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        yield lines
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


@pytest.fixture(scope="module")
def demos(card, tmp_path_factory):
    """Three cube_stacking demos of the port's scripted expert at 64x64."""
    from nvblox_mindmap_torch.closed_loop import scripted

    root = str(tmp_path_factory.mktemp("demos"))
    scripted.generate_cube_stacking_demos(root, 3, seed=11, image_size=64)
    return root


@pytest.fixture(scope="module")
def app_runs(demos, tmp_path_factory):
    """A seeded random RADIO ViT-B/16 saved as the backbone .npz, the datagen
    app's 768-d vertex features on a copy of the demos, then the training
    app on them at 0 and 4 loader workers: (the app's flags, workers ->
    (result, launches))."""
    from nvblox_mindmap_torch.apps import run_datagen, run_training
    from nvblox_mindmap_torch.models.feature_extractors import make_feature_extractor
    from nvblox_mindmap_torch.models.weight_conversion import save_variables_npz
    from nvblox_mindmap_torch.models.weights import state_dict_to_flax

    root = tmp_path_factory.mktemp("radio")
    ds, npz = str(root / "ds"), str(root / "radio_v25_b.npz")
    torch.manual_seed(11)
    vit = make_feature_extractor("radio_v25_b", (4, 4))
    save_variables_npz(npz, {"params": state_dict_to_flax(vit.state_dict())})
    shutil.copytree(demos, ds)
    run_datagen.main(["--task", "cube_stacking", "--dataset", ds, "--demos_datagen", "0-2",
                      "--feature_type", "radio_v25_b", "--backbone_weights", npz,
                      "--feature_image_size", "4,4", "--image_size", "64,64", "--device", DEVICE])
    flags, runs = APP + ["--dataset", ds, "--backbone_weights", npz], {}
    for workers in (0, 4):
        with launches() as counts:
            result = run_training.main(flags + ["--train_iters", "4", "--val_freq", "4",
                                                "--num_workers", str(workers),
                                                "--base_log_dir", f"{ds}_logs_{workers}"])
        runs[workers] = result, counts
    return flags, runs


def test_training_app_on_the_card(app_runs):
    """Each run: 4 train steps with no flash launch and one eval batch, its
    checkpoints and a finite validation loss, the dataset's feature width."""
    for workers, (result, counts) in app_runs[1].items():
        assert flash(counts) == per_goal(10), workers
        assert {"best.ckpt", "last.ckpt", "training_args.json"} <= set(
            os.listdir(result["checkpoint_dir"]))
        assert np.isfinite(result["best_loss"])
        cfg = result["trainer"].model.config
        assert (cfg.data_type, cfg.vertex_feature_dim) == ("rgbd_and_mesh", 768)


def test_model_from_best_predicts_through_the_kernels(app_runs):
    """A fresh process's path: the frozen args override the command line's
    width and data type, the model loads best.ckpt and predicts a
    validation keypose through both kernels as eager attention does."""
    from nvblox_mindmap_torch.apps import run_training as app
    from nvblox_mindmap_torch.mapping.constants import get_workspace_bounds
    from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig
    from nvblox_mindmap_torch.utils import config

    flags, runs = app_runs
    ds = flags[flags.index("--dataset") + 1]
    best = os.path.join(runs[0][0]["checkpoint_dir"], "best.ckpt")
    frozen = config.update_model_args_from_checkpoint(config.parse_args(
        config.TrainingAppArgs, ["--checkpoint", best, "--task", "cube_stacking", "--dataset", ds,
                                 "--embedding_dim", "24", "--data_type", "mesh"]))
    assert (frozen.embedding_dim, config.DataType(frozen.data_type).value) == (
        120, "rgbd_and_mesh")
    args = config.parse_args(config.TrainingAppArgs, flags)
    val_loader = app.build_loaders(args, app.make_embodiment_for_task("cube_stacking"))[2]
    cfg = config.model_config_from_args(
        frozen, vertex_feature_dim=app.vertex_feature_dim(val_loader.dataset))
    bounds = get_workspace_bounds("cube_stacking")
    predictor = Trainer(cfg, TrainerConfig(), bounds, device=DEVICE)
    predictor.load_checkpoint(best)
    batch = next(iter(val_loader))
    prepared = prepare_inputs({k: None if v is None else v[:1] for k, v in batch.items()},
                              bounds, cfg, device=DEVICE)
    with torch.no_grad():
        fixed = predictor.model.encode_prepared(prepared, impl="eager")
    assert (fixed["context_feats"].shape[1], 1 + fixed["fps_feats"].shape[1]) == APP_TOKENS
    kw = dict(init_noise=torch.randn((1, 1, 1, 9), generator=torch.Generator(DEVICE).manual_seed(5),
                                     device=DEVICE), **convert_diffusion_scheduler(10))
    with attention("eager"):
        eager = sample_trajectory(predictor.model, prepared, bounds, **kw)[0]
    with attention("flash"), launches() as counts:
        traj = sample_trajectory(predictor.model, prepared, bounds, **kw)[0]
    assert flash(counts) == per_goal(10)
    assert traj.shape == (1, 1, 1, 8) and bool(torch.isfinite(traj).all())
    torch.testing.assert_close(traj, eager, rtol=0, atol=TRAJ_ATOL)


def ply_vertex_count(path):
    with open(path) as f:
        text = f.read().split("end_header\n")
    count = int(next(h for h in text[0].splitlines() if h.startswith("element vertex")).split()[-1])
    assert count == len([line for line in text[1].splitlines() if line.strip()]), path
    return count


def test_open_loop_app_on_the_card(app_runs, tmp_path):
    """The validation demo's keyposes from best.ckpt (frozen args sampling the
    keyposes only), DDPM-100: each sample 203 + 800 launches, finite
    metrics, the first sample as eager attention gives it; then one sample
    with ``--ply_output_dir`` writes the three clouds with eager attention."""
    import itertools

    from nvblox_mindmap_torch.apps import run_open_loop_policy as app
    from nvblox_mindmap_torch.mapping.constants import get_workspace_bounds

    flags, runs = app_runs
    ds = flags[flags.index("--dataset") + 1]
    ckpt_dir = runs[0][0]["checkpoint_dir"]
    os.symlink(os.path.join(ckpt_dir, "best.ckpt"), tmp_path / "best.ckpt")
    with open(os.path.join(ckpt_dir, "training_args.json")) as f:
        frozen = dict(json.load(f), only_sample_keyposes=True)
    with open(tmp_path / "training_args.json", "w") as f:
        json.dump(frozen, f)
    argv = ["--dataset", ds, "--task", "cube_stacking", "--demos_open_loop", "2",
            "--only_sample_keyposes", "1", "--checkpoint", str(tmp_path / "best.ckpt"),
            "--device", DEVICE]
    samples, run_inference = [], app.run_inference

    def counted(infer, model, batch, seed):
        with launches() as counts:
            out = run_inference(infer, model, batch, seed)
        samples.append((counts, infer, model, batch, seed, out["trajectory"]))
        return out

    with mock.patch.object(app, "run_inference", counted), held_shapes():
        means = app.main(argv)
    assert len(samples) >= 2 and all(flash(s[0]) == per_goal(100) for s in samples)
    values = [v for m in means.values() for v in (m if isinstance(m, list) else [m])]
    assert all(v is not None and np.isfinite(v) for v in values), means
    _, infer, model, batch, seed, traj = samples[0]
    with torch.no_grad():
        fixed = model.encode_prepared(prepare_inputs(
            batch, get_workspace_bounds("cube_stacking"), model.config, device=DEVICE),
            impl="eager")
    assert (fixed["context_feats"].shape[1], 1 + fixed["fps_feats"].shape[1]) == APP_TOKENS
    with attention("eager"):
        eager = infer(batch, seed)[0].cpu().numpy()
    assert np.isfinite(traj).all() and np.abs(traj - eager).max() <= TRAJ_ATOL

    make_loader = app.get_data_loader_by_data_type

    class FirstSample:
        def __init__(self, loader):
            self.loader, self.dataset = loader, loader.dataset

        def __iter__(self):
            return itertools.islice(iter(self.loader), 1)

    def first_sample(*args, **kwargs):
        loader, sampler = make_loader(*args, **kwargs)
        return FirstSample(loader), sampler

    ply = tmp_path / "ply"
    with mock.patch.object(app, "get_data_loader_by_data_type", first_sample), \
            launches() as counts:
        app.main(argv + ["--ply_output_dir", str(ply)])
    assert {n: ply_vertex_count(ply / n) for n in sorted(os.listdir(ply))} == {
        "sample_0000_attention.ply": 256, "sample_0000_features.ply": 256,
        "sample_0000_prediction.ply": 1}
    assert not any(flash(counts).values())


@pytest.fixture(scope="module")
def packed_run(app_runs, tmp_path_factory):
    """``scripts/pack_dataset`` packs 4 batches of the app's loader; the app
    trains 6 steps from the packed epoch and evaluates once."""
    from nvblox_mindmap_torch.apps import run_training as app
    from nvblox_mindmap_torch.scripts import pack_dataset
    from nvblox_mindmap_torch.utils import config

    root = tmp_path_factory.mktemp("packed")
    flags = app_runs[0]
    pack_flags = flags + ["--num_workers", "4"]
    packed = str(root / "epoch")
    pack_dataset.main(pack_flags + ["--packed_out", packed, "--packed_num_batches", "4"])
    args = config.parse_args(pack_dataset.PackDatasetArgs, pack_flags)
    loader = app.build_loaders(args, app.make_embodiment_for_task("cube_stacking"),
                               skip_val=True)[0]
    stream = list(pack_dataset.loader_batches(loader, 4))
    run_flags = flags + ["--packed_dataset", packed, "--train_iters", "6", "--val_freq", "6"]
    with launches() as counts, trainer_log() as lines:
        result = app.main(run_flags + ["--base_log_dir", str(root / "logs")])
    return dict(root=root, packed=packed, args=args, stream=stream, run_flags=run_flags,
                result=result, counts=counts, logged=logged("\n".join(lines)),
                last=str(root / "logs" / "checkpoints" / "latest" / "last.ckpt"))


def test_packed_training_on_the_card(packed_run):
    """Each packed batch is the streaming loader's; a step from a staged batch
    equals the host-fed step bit for bit; the packed-fed app trains without a
    flash launch, evaluates once, logs every step; an asynchronous orbax save
    of its state restores bit for bit."""
    from nvblox_mindmap_torch.apps import run_training as app
    from nvblox_mindmap_torch.data.packed import PackedEpoch, device_batch, stage_to_device
    from nvblox_mindmap_torch.parallel.mesh import make_data_mesh
    from nvblox_mindmap_torch.training.orbax_checkpoint import OrbaxCheckpointer
    from nvblox_mindmap_torch.training.trainer import Trainer, TrainerConfig
    from nvblox_mindmap_torch.utils import config

    run = packed_run
    epoch = PackedEpoch(run["packed"])
    for i, host in enumerate(run["stream"]):
        got = epoch.batch(i)
        for k, v in host.items():
            assert got[k] is None if v is None else (
                got[k].dtype == v.dtype and np.array_equal(got[k], v)), (i, k)
    model_cfg = config.model_config_from_args(run["args"], vertex_feature_dim=768)
    bounds = app.get_workspace_bounds("cube_stacking")
    trainer = Trainer(model_cfg, TrainerConfig(batch_size=8), bounds, device=DEVICE,
                      backbone_weights=run["args"].backbone_weights)
    first = []
    staged = stage_to_device(epoch, indices=[0], mesh=make_data_mesh(DEVICE))
    for batch in (run["stream"][0], device_batch(staged, 0)):
        trainer.init_state()
        first.append(float(trainer.train_one_step(batch, 0)["total"]))
    assert first[0] == first[1]
    losses, val = run["logged"]
    assert flash(run["counts"]) == per_goal(10)
    assert sorted(losses) == list(range(6)) and np.isfinite(list(losses.values())).all()
    assert sorted(val) == [5]
    trainer, best = run["result"]["trainer"], run["result"]["best_loss"]
    ckptr = OrbaxCheckpointer(str(run["root"] / "orbax"))
    state, opt_state = trainer.model.state_dict(), trainer.optimizer.tensor_state()
    ckptr.save("last", state, opt_state, 6, best)
    ckptr.wait()
    restored = Trainer(model_cfg, trainer.config, bounds, device=DEVICE)
    restored.init_state()
    _, restored_opt, step, got_best = ckptr.restore("last", restored.model.state_dict(),
                                                    restored.optimizer.tensor_state())
    restored.optimizer.load_tensor_state(restored_opt)
    assert (step, got_best, restored.optimizer.count) == (6, best, trainer.optimizer.count)
    for name, value in restored.model.state_dict().items():
        assert torch.equal(value, state[name]), name
    for kind in ("exp_avg", "exp_avg_sq"):
        for name, value in restored_opt[kind].items():
            assert torch.equal(value, opt_state[kind][name]), (kind, name)


def test_torchrun_training_equals_in_process(packed_run):
    """The packed app run again under ``torch.distributed.run`` (one rank,
    ``--checkpoint_backend orbax``): its losses within 1e-5 of the in-process
    run's and its validation line as printed; its ``last/`` holds the
    in-process parameters within two Adam steps of a rounding-level gradient
    (2e-4; at most 1e-3 of them beyond 1e-6); a run resumed from it goes on
    at its iteration, training only."""
    from nvblox_mindmap_torch.apps import run_training as app
    from nvblox_mindmap_torch.training.checkpoint import load_checkpoint_file
    from nvblox_mindmap_torch.training.trainer import Trainer

    run, root = packed_run, packed_run["root"]
    logs = str(root / "ddp_logs")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         "-m", "nvblox_mindmap_torch.apps.run_training"] + run["run_flags"] + [
            "--checkpoint_backend", "orbax", "--base_log_dir", logs],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=420)
    output = proc.stdout + proc.stderr
    assert proc.returncode == 0, output[-4000:]
    (losses, val), (in_process, in_process_val) = logged(output), run["logged"]
    assert sorted(losses) == sorted(in_process)
    for s, loss in in_process.items():
        assert abs(losses[s] - loss) <= 1e-5 * abs(loss), (s, losses[s], loss)
    assert sorted(val) == sorted(in_process_val)
    for s, row in in_process_val.items():
        for a, b in zip(val[s], row):
            assert abs(a - b) <= 1e-5 * abs(b) + 1e-6, (s, val[s], row)
    ckpt_dir = os.path.realpath(os.path.join(logs, "checkpoints", "latest"))
    assert {"best", "last", "training_args.json"} <= set(os.listdir(ckpt_dir))
    with launches() as counts:
        result = app.main(run["run_flags"] + [
            "--checkpoint_backend", "orbax", "--checkpoint", os.path.join(ckpt_dir, "last"),
            "--train_iters", "8", "--val_freq", str(10**9),
            "--base_log_dir", str(root / "resume_logs")])
    assert not any(flash(counts).values())
    assert (result["start_iter"], result["trainer"].optimizer.count) == (5, 9)
    restored = Trainer(result["trainer"].model_config, result["trainer"].config,
                       app.get_workspace_bounds("cube_stacking"), device=DEVICE)
    step, best = restored.load_checkpoint(os.path.join(ckpt_dir, "last"))
    reference = load_checkpoint_file(run["last"])
    assert step == reference["iter"]
    assert abs(best - reference["best_loss"]) <= 1e-5 * abs(reference["best_loss"])
    diffs = [(v.cpu() - reference["state_dict"][n]).abs()
             for n, v in restored.model.state_dict().items()]
    assert max(float(d.max()) for d in diffs) <= 2e-4
    assert sum(int((d > 1e-6).sum()) for d in diffs) <= 1e-3 * sum(d.numel() for d in diffs)


# ------------------------------------------------- the closed loop and the bridge

LOOP = ["--task", "cube_stacking", "--demos_closed_loop", "0", "--checkpoint", LOOP_FIXTURE,
        "--data_type", "mesh", "--feature_type", "rgb", "--embedding_dim", "72",
        "--fps_subsampling_factor", "4", "--diffusion_timesteps", "100",
        "--num_vertices_to_sample", "512", "--image_size", "64,64", "--voxel_size_m", "0.02",
        "--seed", "3", "--serving_scheduler", "ddim", "--serving_num_inference_steps", "10",
        "--max_num_steps_to_goal", "4", "--terminate_after_n_steps", "24", "--device", DEVICE]


@pytest.fixture(scope="module")
def loop_demo(card, tmp_path_factory):
    """One cube_stacking demo of the scripted expert (which must stack) with
    its scene.json, at 64x64."""
    from nvblox_mindmap_torch.closed_loop import scripted

    root = str(tmp_path_factory.mktemp("loop"))
    (demo,) = scripted.generate_cube_stacking_demos(root, 1, seed=11, image_size=64)
    assert len([f for f in os.listdir(demo) if f.endswith(".wrist_rgb.png")]) > 12
    return root


def run_loop(argv, world="scene", patches=()):
    """The closed-loop app with the goals of ``Policy.get_new_goal`` kept:
    (summary, goals, launches, the last goal's policy and world)."""
    from nvblox_mindmap_torch.apps import run_closed_loop_policy as app
    from nvblox_mindmap_torch.closed_loop.policies import NvbloxDiffuserActorPolicy as Policy

    goals, last, get_new_goal = [], {}, Policy.get_new_goal

    def recording(policy, env, *args, **kwargs):
        out = get_new_goal(policy, env, *args, **kwargs)
        last.update(policy=policy, env=env)
        goals.append([np.array(g, copy=True) for g in out])
        return out

    with contextlib.ExitStack() as stack:
        for patch in ((Policy, "get_new_goal", recording),) + tuple(patches):
            stack.enter_context(mock.patch.object(*patch))
        with launches() as counts:
            summary = app.main(argv, world)
    return summary, goals, counts, last


@pytest.fixture(scope="module")
def closed_loop_run(loop_demo):
    eval_path = os.path.join(loop_demo, "closed_loop_eval.json")
    return run_loop(LOOP + ["--dataset", loop_demo, "--eval_file_path", eval_path]) + (eval_path,)


def test_closed_loop_app_on_the_card(closed_loop_run):
    """The committed cube fixture through the app in the scene world: every
    goal 23 + 80 flash launches and one FPS launch, the eval file; then the
    last goal's inputs: a surface of more vertices than it samples, its
    token counts, and a goal through the kernels as eager attention gives."""
    summary, goals, counts, last, eval_path = closed_loop_run
    assert len(goals) >= 3 and flash(counts) == per_goal(10, len(goals))
    assert counts["fps"] == len(goals)
    with open(eval_path) as f:
        assert summary["num_demos"] == 1 and "summary" in json.load(f)
    assert all(len(g) == 1 and g[0].shape == (8,) and np.isfinite(g[0]).all() for g in goals)
    policy, env = last["policy"], last["env"]
    assert len(policy.mesh_vertices()[0]) >= 512
    batch = policy._model_inputs(env)
    assert bool(np.asarray(batch["vertices_valid_mask"]).all())
    with torch.no_grad():
        fixed = policy.model.encode_prepared(prepare_inputs(
            batch, policy.bounds, policy.model.config, device=DEVICE), impl="eager")
    assert (fixed["context_feats"].shape[1], 1 + fixed["fps_feats"].shape[1]) == (512, 129)
    init = torch.randn((1, 1, 1, 9), generator=torch.Generator(DEVICE).manual_seed(6),
                       device=DEVICE)
    traj = {}
    for impl in ("eager", "flash"):
        with attention(impl):
            traj[impl] = policy.predict(batch, init)[0]
    assert np.isfinite(traj["flash"]).all()
    assert np.abs(traj["flash"] - traj["eager"]).max() <= TRAJ_ATOL


def test_ground_truth_goals_stack_the_cubes(loop_demo, tmp_path):
    from nvblox_mindmap_torch.apps import run_closed_loop_policy as app

    path = str(tmp_path / "gt.json")
    gt = app.main(["--task", "cube_stacking", "--dataset", loop_demo, "--demos_closed_loop", "0",
                   "--demo_mode", "execute_gt_goals", "--eval_file_path", path,
                   "--device", DEVICE], "scene")
    assert gt["success_rate"] == 1.0 and gt["mean_num_stacked_cubes"] >= 2
    assert os.path.exists(path)


SIM_HOST = """
import json, sys
from nvblox_mindmap_torch.closed_loop.remote_env import serve_environment
from nvblox_mindmap_torch.closed_loop.scripted import env_from_scene_json
world = env_from_scene_json(sys.argv[1])
server = serve_environment(world, port=0)
print(json.dumps([server.port, getattr(world, "object_half", None)]), flush=True)
try:
    stopped = server.wait(timeout=600)
finally:
    server.stop()
print(json.dumps({"stopped": stopped, "torch": "torch" in sys.modules}), flush=True)
"""


def test_remote_loop_equals_in_process(closed_loop_run, loop_demo, tmp_path):
    """The same app and demo with its world behind the simulator bridge: a sim
    host process that never imports torch serves the scene world on
    loopback; one connection, the in-process run's goals bit for bit, its
    success, its launches."""
    import select

    from nvblox_mindmap_torch.apps import run_closed_loop_policy as app
    from nvblox_mindmap_torch.closed_loop.remote_env import RemoteEnvironment

    host = subprocess.Popen([sys.executable, "-c", SIM_HOST, os.path.join(loop_demo, "demo_00000")],
                            cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                                               PYTHONPATH=ROOT),
                            stdout=subprocess.PIPE, text=True)
    try:
        assert select.select([host.stdout], [], [], 120)[0], "the sim host did not start"
        port, object_half = json.loads(host.stdout.readline())
        remotes = []

        def remote_world(demo):
            env = RemoteEnvironment("127.0.0.1", port, timeout_s=120)
            if object_half is not None:  # what the app reads of a scene world
                env.object_half = object_half
            remotes.append(env)
            return env

        summary, goals, counts, _ = run_loop(
            LOOP + ["--dataset", loop_demo, "--eval_file_path", str(tmp_path / "remote.json")],
            patches=[(app, "env_from_scene_json", remote_world)])
        for env in remotes:
            env.close()
        out, _ = host.communicate(timeout=120)
    finally:
        host.kill()
    assert host.returncode == 0 and json.loads(out) == {"stopped": True, "torch": False}
    in_process, in_goals = closed_loop_run[0], closed_loop_run[1]
    assert len(remotes) == 1 and len(goals) == len(in_goals) >= 3
    assert flash(counts) == per_goal(10, len(goals))
    for a, b in zip(goals, in_goals):
        assert len(a) == len(b) and all(x.dtype == y.dtype and x.tobytes() == y.tobytes()
                                        for x, y in zip(a, b))
    assert (summary["success_rate"], summary.get("outcomes")) == (
        in_process["success_rate"], in_process.get("outcomes"))


class StandInGymEnv:
    """A recording stand-in for an Isaac Lab gym env: it keeps every action
    and moves the robot's eef poses, jaws or hand joints and head to it; its
    state lives in CPU tensors, as a simulator's would."""

    def __init__(self, humanoid):
        self.unwrapped = self.scene = self
        self.humanoid, self.actions, self.resets = humanoid, [], 0
        self.state = torch.zeros(37 if humanoid else 9)
        self.state[3] = 1.0
        if humanoid:
            self.state[21] = 1.0

    def reset_to(self, state, env_ids, is_relative):
        self.resets += 1

    def reset(self):
        self.resets += 1

    def step(self, action):
        from nvblox_mindmap_torch.embodiments.humanoid_hand import HumanoidJointIndices as J

        self.actions.append(action)
        flat = action.reshape(-1)
        if not self.humanoid:
            self.state[:7] = flat[:7]
            self.state[7:9] = 0.0 if float(flat[7]) < 0 else 0.04
            return
        hands = flat[15:37]
        self.state[0:7], self.state[18:25], self.state[36] = flat[0:7], flat[7:14], flat[14]
        self.state[7:18] = hands[J.left_joints_in_combined_hands_tensor_indices]
        self.state[25:36] = hands[J.right_joints_in_combined_hands_tensor_indices]


@pytest.mark.parametrize("humanoid", [False, True])
def test_isaaclab_adapter_served_through_the_bridge(card, humanoid):
    """``IsaacLabEnvironment`` over the stand-in, served through the bridge and
    stepped by a ``RemoteEnvironment``: every action a CPU float32 (1, 8) or
    (1, 37) tensor, a 37-d one round-tripping through ``HumanoidAction``."""
    from nvblox_mindmap_torch.closed_loop.isaaclab_adapter import IsaacLabEnvironment
    from nvblox_mindmap_torch.closed_loop.remote_env import RemoteEnvironment, serve_environment
    from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
    from nvblox_mindmap_torch.embodiments.humanoid import HumanoidEmbodiment
    from nvblox_mindmap_torch.embodiments.humanoid_hand import HumanoidAction

    rng = np.random.default_rng(31)
    gym_env = StandInGymEnv(humanoid)
    adapter = IsaacLabEnvironment(gym_env, HumanoidEmbodiment() if humanoid else ArmEmbodiment(),
                                  {}, robot_state_fn=lambda env: env.state,
                                  initial_state={"demo": 0})
    server = serve_environment(adapter, port=0)
    try:
        remote = RemoteEnvironment("127.0.0.1", server.port, timeout_s=120)
        remote.reset()
        remote.step(None)
        for _ in range(4):
            goal = rng.uniform(-0.5, 0.5, 17 if humanoid else 8).astype(np.float32)
            for lo, hi in ((3, 7), (11, 15)) if humanoid else ((3, 7),):
                goal[lo:hi] /= np.linalg.norm(goal[lo:hi])
            closed = [7, 15] if humanoid else [7]
            goal[closed] = rng.uniform(0, 1, len(closed))
            remote.step(goal)
        state = remote.get_policy_state()
        remote.close()
        server.wait(120)
    finally:
        server.stop()
    width = 37 if humanoid else 8
    assert len(gym_env.actions) == 5 and gym_env.resets == 1
    assert state.shape == ((17,) if humanoid else (8,))
    for a in gym_env.actions:
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert a.dtype == torch.float32 and tuple(a.shape) == (1, width)
        if humanoid:
            x = a[0].numpy()
            assert HumanoidAction.from_tensor(x).to_tensor().tobytes() == x.tobytes()


# ------------------------------------------- datagen, the map's mesh and the tools


@pytest.fixture(scope="module")
def datagen_run(loop_demo, tmp_path_factory):
    """The datagen app on a copy of the loop demo: 12 frames, the serialized
    map, the ground-truth validation; (dataset, demo, the live mapper)."""
    from nvblox_mindmap_torch.apps import run_datagen as app

    ds = str(tmp_path_factory.mktemp("datagen"))
    demo = os.path.join(ds, "demo_00000")
    shutil.copytree(os.path.join(loop_demo, "demo_00000"), demo)
    live, process_demo = [], app.process_demo
    with mock.patch.object(app, "process_demo",
                           lambda *a, **k: live.append(process_demo(*a, **k)) or live[-1]):
        app.main(["--task", "cube_stacking", "--dataset", ds, "--demos_datagen", "0",
                  "--feature_type", "rgb", "--image_size", "64,64", "--max_num_steps", "12",
                  "--save_serialized_nvblox_map_to_disk", "1",
                  "--validate_demos_with_gt_poses", "1", "--device", DEVICE])
    return ds, demo, live[0]


def test_datagen_app_on_the_card(datagen_run):
    """Every frame's item reads back fp16 with the features' width, no item
    past ``--max_num_steps``, and the map file reloads to the live map."""
    from nvblox_mindmap_torch.data import item_io
    from nvblox_mindmap_torch.mapping.constants import MapperId
    from nvblox_mindmap_torch.mapping.mapper import Mapper
    from nvblox_mindmap_torch.mapping.voxel_grid import state_to_numpy

    _, demo, mapper = datagen_run
    for t in range(12):
        path = os.path.join(demo, f"{t}.nvblox_vertex_features.zst")
        raw, item = item_io.unpickle_zst(path), item_io.load_item(path)
        n = len(raw["vertices"])
        assert n > 0 and raw["channel_length"] == 3
        assert raw["vertices"].dtype == raw["features"].dtype == np.float16
        assert raw["features"].shape == item["features"].shape == (n, 3)
        assert np.isfinite(item["features"]).all()
    assert not os.path.exists(os.path.join(demo, "12.nvblox_vertex_features.zst"))
    loaded = Mapper.from_file(os.path.join(demo, "nvblox_map_static.nvblx"), device=DEVICE)
    assert loaded.configs == mapper.configs
    live, read = (state_to_numpy(m.states[MapperId.STATIC]) for m in (mapper, loaded))
    for name, value in live.items():
        assert value.dtype == read[name].dtype and np.array_equal(value, read[name]), name


def test_map_mesh_views_and_scripts_on_the_card(datagen_run, tmp_path):
    """``update_color_mesh`` with the device and the host backend: the same
    counts within the budgets, vertices 1e-5, colors 1e-6, the same
    triangles; the file's map on the CPU: the same mesh and dense views;
    then the map, video and keypose scripts, each output decoded, and
    ``datasets_are_close``."""
    from nvblox_mindmap_torch.data.comparisons import datasets_are_close
    from nvblox_mindmap_torch.data.item_io import decode_png
    from nvblox_mindmap_torch.mapping import voxel_grid as vg
    from nvblox_mindmap_torch.mapping.constants import MapperId
    from nvblox_mindmap_torch.mapping.mapper import Mapper
    from nvblox_mindmap_torch.scripts import (
        convert_maps_usd,
        generate_reconstruction_figures,
        make_mp4_from_dataset,
        video_from_depth,
        visualize_keyposes,
        visualize_nvblox_tensors,
    )

    ds, demo, _ = datagen_run
    map_path = os.path.join(demo, "nvblox_map_static.nvblx")
    card, budgets = Mapper.from_file(map_path, device=DEVICE), dict(max_vertices=65536,
                                                                    max_triangles=262144)
    out = vg.extract_surface_mesh_device(card.states[MapperId.STATIC],
                                         card.configs[MapperId.STATIC], 65536, 262144)
    counts = (int(out[5]), int(out[6]))
    meshes = {}
    for backend in ("device", "host"):
        card.update_color_mesh(backend=backend, **budgets)
        meshes[backend] = card.get_color_mesh()
    (dv, dt, dc), (hv, ht, hc) = meshes["device"], meshes["host"]
    assert (len(dv), len(dt)) == (len(hv), len(ht)) == counts and counts[1] > 0
    np.testing.assert_allclose(dv, hv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dc, hc, rtol=0, atol=1e-6)
    assert set(map(tuple, np.sort(dt, 1))) == set(map(tuple, np.sort(ht, 1))) and (dc > 0).any()
    cpu = Mapper.from_file(map_path, device="cpu")
    cpu.update_color_mesh(backend="device", **budgets)
    cv, ct, cc = cpu.get_color_mesh()
    assert cv.shape == dv.shape and np.array_equal(ct, dt) and np.array_equal(cc, dc)
    np.testing.assert_allclose(cv, dv, rtol=0, atol=1e-6)
    for view in ("tsdf", "colors", "features"):
        assert torch.equal(getattr(card, f"{view}_dense")().cpu(), getattr(cpu, f"{view}_dense")())

    def pngs(directory, pattern, count=None):
        import glob

        paths = sorted(glob.glob(os.path.join(directory, pattern)))
        assert paths and (count is None or len(paths) == count), (pattern, len(paths))
        return {decode_png(p).shape for p in paths}

    frames = len([f for f in os.listdir(demo) if f.endswith(".wrist_rgb.png")])
    visualize_nvblox_tensors.main(["--map", map_path, "--output_dir", str(tmp_path / "viz"),
                                   "--device", DEVICE])
    pngs(tmp_path / "viz", "tsdf_slice_*.png")
    assert ply_vertex_count(tmp_path / "viz" / "surface.ply") > 0
    generate_reconstruction_figures.main(["--map_path", map_path, "--output_dir",
                                          str(tmp_path / "figs"), "--device", DEVICE])
    assert len(pngs(tmp_path / "figs", "nvblox_map_static_*_mesh.png", 2)) == 1
    assert os.path.exists(tmp_path / "figs" / "pca_params.npz")
    os.makedirs(tmp_path / "usd")
    os.symlink(map_path, tmp_path / "usd" / "nvblox_map_static.nvblx")
    convert_maps_usd.main(["--input_dir", str(tmp_path / "usd"), "--device", DEVICE])
    with open(tmp_path / "usd" / "nvblox_map_static.usda") as f:
        assert f.read(64).startswith("#usda 1.0")
    for modality in ("rgb", "depth"):
        make_mp4_from_dataset.main(["--dataset", ds, "--demos", "0", "--camera", "wrist",
                                    "--modality", modality, "--output_dir", str(tmp_path / "mp4")])
        pngs(tmp_path / "mp4", f"demo_00000_wrist_{modality}_*.png", frames)
    video_from_depth.main([demo, str(tmp_path / "depth" / "wrist_depth.mp4"), "--pattern",
                           "*.wrist_depth.png"])
    pngs(tmp_path / "depth", "wrist_depth_*.png", frames)
    visualize_keyposes.main(["--dataset", ds, "--demos", "0", "--task", "cube_stacking",
                             "--output_dir", str(tmp_path / "keyposes")])
    assert ply_vertex_count(tmp_path / "keyposes" / "demo_00000_keyposes.ply") == frames
    copy = tmp_path / "copy" / "demo_00000"
    shutil.copytree(demo, copy, copy_function=os.link)
    assert datasets_are_close(demo, str(copy)) == (True, [])
    state = np.load(copy / "0.robot_state.npy")
    os.remove(copy / "0.robot_state.npy")
    np.save(copy / "0.robot_state.npy", state + 0.01)
    assert datasets_are_close(demo, str(copy)) == (False, ["0.robot_state.npy"])


def test_runtime_tools_on_the_card(datagen_run, closed_loop_run, tmp_path):
    """The decoder API against the port's readers (PNGs at 1 / 4 / 8 threads,
    a missing file as None; the zstd items), tar there and back, the HTML
    report, the humanoid keypose plot, ``hdf5_tools`` (or its refusal
    without h5py) and the workflow specs read back."""
    import glob
    import hashlib
    import pathlib

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

    ds, demo, _ = datagen_run
    assert runtime.ensure_built() and runtime.native_available()
    paths = sorted(glob.glob(os.path.join(demo, "*.png")))
    serial = [item_io.decode_png(p) for p in paths]
    for threads in (1, 4, 8):
        batch = runtime.decode_png_batch(paths + [os.path.join(demo, "missing.png")], threads)
        assert batch[-1] is None
        assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(serial, batch))
    for path in glob.glob(os.path.join(demo, "*.zst")):
        ours, ref = runtime.decode_zstd_pickle(path), item_io.unpickle_zst(path)
        assert sorted(ours) == sorted(ref)
        assert all(np.array_equal(ours[k], ref[k]) for k in ("vertices", "features"))
    benchmark_decompression.main([])

    def digest(root):
        return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
                for p in pathlib.Path(root).rglob("*") if p.is_file()}

    tars = tar_demos.tar_demos(ds, "0", str(tmp_path / "tars"))
    untarred = tar_demos.untar_demos(str(tmp_path / "tars"), str(tmp_path / "untarred"))
    assert len(tars) == 1 and digest(demo) == digest(untarred[0])
    eval_path = closed_loop_run[-1]
    with open(eval_path) as f:
        summary = json.load(f)["summary"]
    report = publish_closed_loop_eval.render_report([eval_path], str(tmp_path / "report.html"))
    with open(report) as f:
        assert f"{summary.get('success_rate', 0):.2%}" in f.read()
    (humanoid,) = scripted.generate_drill_in_box_demos(str(tmp_path / "humanoid"), num_demos=1,
                                                       seed=0, image_size=64)
    keyposes = plot_humanoid_keyposes.analyze_demo(humanoid, str(tmp_path / "plots"))
    expected = HumanoidEmbodiment().extract_keypose_indices(
        plot_humanoid_keyposes.load_robot_states(humanoid), [],
        KeyposeDetectionMode.HIGHEST_Z_OF_VERTICAL_MOTION_AND_HEAD_TURN)
    figure = item_io.decode_png(str(tmp_path / "plots" /
                                    f"{os.path.basename(humanoid)}_keyposes.png"))
    assert np.array_equal(keyposes, expected) and len(keyposes) >= 3
    assert figure.shape == plot_humanoid_keyposes.FIGURE_HW + (3,)
    try:
        import h5py
    except ImportError:
        with pytest.raises(ImportError, match="h5py"):
            hdf5_tools.list_demos(str(tmp_path / "none.hdf5"))
    else:
        with h5py.File(tmp_path / "demos.hdf5", "w") as f:
            for i in range(3):
                f.create_group(f"data/demo_{i}").create_dataset("actions", data=np.full(4, i))
        hdf5_tools.merge_hdf5_files([str(tmp_path / "demos.hdf5")] * 2,
                                    str(tmp_path / "merged.hdf5"))
        assert len(hdf5_tools.list_demos(str(tmp_path / "merged.hdf5"))) == 6
    for name, workflow in (
            ("e2e", submit.make_e2e_workflow("cube_stacking", "demos.hdf5", str(tmp_path))),
            ("train_and_eval", submit.make_train_and_eval_workflow(
                "cube_stacking", ds, "0", "0", str(tmp_path)))):
        with open(submit.write_workflow(workflow, str(tmp_path / f"{name}.json"))) as f:
            assert json.load(f) == workflow


# ----------------------------------------------------------------- the CLIP loop


def test_clip_loop_on_the_card(demos, tmp_path):
    """``--feature_type clip_resnet50_fpn`` through the loop, on a seeded
    random CLIP trunk with an FPN: the datagen app's 120-d features for every
    frame; the training app trains the FPN and not the trunk, and evaluates
    once; ``extract_fpn_from_model``'s .npz gives the trained extractor's
    features; the closed-loop app runs best.ckpt in the replay world."""
    import glob

    import chip_smoke
    from nvblox_mindmap_torch.apps import run_datagen, run_training
    from nvblox_mindmap_torch.data import item_io
    from nvblox_mindmap_torch.models.clip_resnet_fpn import ClipResNet50Fpn
    from nvblox_mindmap_torch.models.feature_extractors import resize_bilinear
    from nvblox_mindmap_torch.models.pretrained import make_feature_fn
    from nvblox_mindmap_torch.models.weight_conversion import load_variables_npz
    from nvblox_mindmap_torch.models.weights import flax_to_state_dict
    from nvblox_mindmap_torch.scripts import extract_fpn_from_model
    from nvblox_mindmap_torch.training.checkpoint import load_checkpoint_file

    npz, ds = str(tmp_path / "clip.npz"), str(tmp_path / "ds")
    chip_smoke.save_random_clip(npz)
    shutil.copytree(demos, ds)
    clip = ["--feature_type", "clip_resnet50_fpn", "--feature_image_size", "8,8",
            "--image_size", "64,64", "--device", DEVICE]
    run_datagen.main(["--task", "cube_stacking", "--dataset", ds, "--demos_datagen", "0-2",
                      "--backbone_weights", npz] + clip)
    for path in glob.glob(os.path.join(ds, "demo_*", "*.png")):
        if path.endswith(".wrist_rgb.png"):
            item = item_io.load_item(path.replace("wrist_rgb.png", "nvblox_vertex_features.zst"))
            n = len(item["vertices"])
            assert n > 0 and item["features"].shape == (n, 120), path
            assert np.isfinite(item["features"]).all()
    app = [{"radio_v25_b": "clip_resnet50_fpn", "4,4": "8,8"}.get(a, a) for a in APP]
    with launches() as counts:
        result = run_training.main(app + ["--dataset", ds, "--train_iters", "4", "--val_freq", "4",
                                          "--backbone_weights", npz, "--num_workers", "4",
                                          "--base_log_dir", str(tmp_path / "logs")])
    assert flash(counts) == per_goal(10) and np.isfinite(result["best_loss"])
    best = os.path.join(result["checkpoint_dir"], "best.ckpt")
    state = load_checkpoint_file(best)["state_dict"]
    prefix = "encoder.feature_extractor."
    moved = []
    for name, value in flax_to_state_dict(load_variables_npz(npz)["params"]).items():
        if name.startswith("backbone."):
            assert torch.equal(state[prefix + name], value), name
        elif not torch.equal(state[prefix + name], value):
            moved.append(name)
    assert len(moved) >= 8 and any(".layer_2." in n for n in moved), moved
    fpn_npz = str(tmp_path / "fpn.npz")
    extract_fpn_from_model.main(["--model_path", best, "--output_path", fpn_npz])
    extractor = ClipResNet50Fpn((8, 8))
    extractor.load_state_dict({k[len(prefix):]: v for k, v in state.items()
                               if k.startswith(prefix)})
    frame = item_io.decode_png(os.path.join(ds, "demo_00002", "0.wrist_rgb.png"))
    frame = torch.from_numpy(frame.astype(np.float32) / 255.0).to(DEVICE)
    feature_fn = make_feature_fn("clip_resnet50_fpn", (64, 64), fpn_npz, (8, 8), device=DEVICE)
    with torch.no_grad():
        want = resize_bilinear(extractor.to(DEVICE)(frame[None]), (64, 64))[0]
        got = feature_fn(frame)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * max(1.0, want.abs().max().item()))
    _, goals, counts, _ = run_loop(
        ["--task", "cube_stacking", "--dataset", ds, "--demos_closed_loop", "2",
         "--data_type", "rgbd_and_mesh", "--checkpoint", best, "--backbone_weights", fpn_npz,
         "--serving_scheduler", "ddim", "--serving_num_inference_steps", "10",
         "--max_num_steps_to_goal", "4", "--terminate_after_n_steps", "24",
         "--eval_file_path", str(tmp_path / "eval.json")] + clip, world="replay")
    assert len(goals) >= 3 and flash(counts) == per_goal(10, len(goals))


# -------------------------------------------- the paper's experiments, trained weights

TASK_SUCCESS = {  # closed_loop sampler options, denoising steps: tests/test_task_success.py's
    "cube_stacking": ({}, 100),
    "mug_in_drawer": (dict(num_inference_steps=10, scheduler="ddim"), 10),
    "drill_in_box": (dict(num_inference_steps=10, scheduler="ddim", timestep_spacing="trailing"),
                     10),
    "stick_in_bin": (dict(num_inference_steps=20, scheduler="ddpm"), 20),
}


def counting_goals():
    from nvblox_mindmap_torch.closed_loop.policies import NvbloxDiffuserActorPolicy as Policy

    goals, get_new_goal = [], Policy.get_new_goal

    def counted(*args, **kwargs):
        goals.append(1)
        return get_new_goal(*args, **kwargs)

    return goals, mock.patch.object(Policy, "get_new_goal", counted)


@pytest.mark.parametrize("task", sorted(TASK_SUCCESS))
def test_task_success_on_the_card(card, task, tmp_path, record_testsuite_property):
    """The committed trained fixture of each task through the task-success
    experiment's closed loop on 4 of its training scenes (seed 21): success
    in at least one, at least half a lifted cube per scene on cube_stacking.
    The rate is a property of the junit record's test suite."""
    from nvblox_mindmap_torch.scripts import task_success_experiment as exp

    serving, T = TASK_SUCCESS[task]
    exp._generator_for_task(task)(str(tmp_path / "ds"), 4, 21)
    goals, patch = counting_goals()
    with held_shapes(), patch, launches() as counts:
        summary = exp.closed_loop(str(tmp_path), 4, os.path.join(
            FIXTURES, "task_success", task, "last.ckpt"), demos_subset=[0, 1, 2, 3], task=task,
            device=DEVICE, **serving)
    record_testsuite_property(f"{task}_success_rate", summary["success_rate"])
    assert flash(counts) == per_goal(T, len(goals))
    assert summary["num_demos"] == 4 and summary["success_rate"] > 0, summary
    assert task != "cube_stacking" or summary["mean_num_lifted_cubes"] >= 0.5, summary


def test_spatial_memory_on_the_card(card, tmp_path, record_testsuite_property):
    """Three panning demos (seed 100, 64x64) fused on the card; the committed
    mesh policy finds the remembered cube (< 0.06 m), the rgbd policy misses
    it (> 0.08 m, over twice the mesh error); each keypose one DDPM-100 call
    of 3 seeds. Both errors are properties of the junit record's test suite."""
    from nvblox_mindmap_torch.scripts import spatial_memory_experiment as sm

    demos = sm.generate_panning_demos(str(tmp_path), 3, seed=100, image_size=64)
    sm.fuse_demos(demos, device=DEVICE)
    errors = {}
    for data_type in ("mesh", "rgbd"):
        calls, make_infer_fn = [], sm.make_infer_fn

        def counted(model, bounds):
            infer = make_infer_fn(model, bounds)
            return lambda batch, seeds: calls.append(1) or infer(batch, seeds)

        with held_shapes(), mock.patch.object(sm, "make_infer_fn", counted), \
                launches() as counts:
            errors[data_type] = sm.eval_pick_keypose_error(
                str(tmp_path), demos, os.path.join(FIXTURES, "spatial_memory",
                                                   f"{data_type}_last.ckpt"),
                data_type, embedding_dim=72, eval_seeds=3, device=DEVICE)["pick_keypose_error_m"]
        assert calls and flash(counts) == per_goal(100, len(calls))
        record_testsuite_property(f"{data_type}_pick_keypose_error_m", errors[data_type])
    assert errors["mesh"] < 0.06 and errors["rgbd"] > 0.08, errors
    assert errors["rgbd"] > 2.0 * errors["mesh"], errors


def test_place_grounding_probe_on_the_card(card, tmp_path):
    """``scripts/place_grounding_probe`` with the committed cube fixture over
    8 fresh scenes: every goal 203 + 800 launches, a finite row per scene."""
    from nvblox_mindmap_torch.scripts import place_grounding_probe as probe

    goals, patch = counting_goals()
    with held_shapes(), patch, launches() as counts:
        probe.main(["--checkpoint", LOOP_FIXTURE, "--scenes", "8", "--out",
                    str(tmp_path / "probe.json"), "--device", DEVICE])
    assert goals and flash(counts) == per_goal(100, len(goals))
    with open(tmp_path / "probe.json") as f:
        result = json.load(f)
    assert result["summary"]["num_scenes"] == 8 and len(result["rows"]) == 8
    assert all(math.isfinite(v) for r in result["rows"]
               for v in r["cube_1_xy"] + (r["release_xy"] or []))
