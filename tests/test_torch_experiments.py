"""Torch port vs the JAX package: the task-success and spatial-memory
experiments (``scripts/task_success_experiment.py``,
``scripts/spatial_memory_experiment.py``).

- The stage plumbing: the seed-range guards, the train stage's flags, the
  stage dispatch and the per-task output directory of ``main``, and its
  refusal without a card (``tests/test_dagger.py:161-200``).
- ``open_loop_eval`` on the first panning demo below (a two-cube
  cube_stacking demo that the port generated and fused), with the committed
  cube_stacking task-success fixture: the port's per-keypose errors against
  the JAX function's on the same dataset, the port fed the JAX noise of
  each seed (``PRNGKey(97 * s + i)``). Tolerance 1e-4.
- The spatial-memory checks of ``tests/test_spatial_memory.py:53-146`` on
  the port's panning demos: post-pan RGB-D is scene-independent, the fused
  map remembers the cube, ``scene.json`` restores the panning camera; the
  port's panning demos equal the JAX package's. One module-scoped set of
  panning demos serves both evaluations and these checks.
- ``eval_pick_keypose_error`` on one panning demo with the committed
  spatial-memory rgbd fixture, the port fed the JAX noise of
  each seed (``PRNGKey(1000 * s + 31 * idx + i)``). Tolerance 1e-4.

To keep them cheap, the two evaluations run over the first keyposes of
their demo (``KEYPOSES``, which include the pick keyposes of the panning
demo): each is a 100-step DDPM sample of a width-72 model per seed.

The ``slow`` tests hold the port's own chain to the bars of
``tests/test_task_success.py:112-207`` and
``tests/test_spatial_memory.py:149-193``: the port's generators, runner,
policy and evaluators with the committed fixtures.
"""
import glob
import itertools
import json
import os

import numpy as np
import pytest
import torch

import jax

from nvblox_mindmap_tpu.apps import run_open_loop_policy as japp
from nvblox_mindmap_tpu.data import loader as jloader
from nvblox_mindmap_tpu.scripts import spatial_memory_experiment as jsm
from nvblox_mindmap_tpu.scripts import task_success_experiment as jexp
from nvblox_mindmap_torch.apps import run_open_loop_policy as topen
from nvblox_mindmap_torch.data.item_io import decode_png, unpickle_zst
from nvblox_mindmap_torch.scripts import spatial_memory_experiment as tsm
from nvblox_mindmap_torch.scripts import task_success_experiment as texp
from tests.test_torch_generators import assert_demos_equal
from tests.test_torch_model_parity import (  # noqa: F401 (one_torch_thread: autouse fixture)
    jax_sampler_noise,
    one_torch_thread,
)

DATA = os.path.join(os.path.dirname(__file__), "test_data")
ERROR_ATOL = 1e-4
KEYPOSES = 3


def fixture(path):
    return os.path.join(DATA, path)


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(topen, "sampler_noise", lambda seed, steps, shape, device:
                        jax_sampler_noise(jax.random.PRNGKey(seed), steps, shape))


@pytest.fixture
def first_keyposes(monkeypatch):
    """Both packages' loaders yield only the first KEYPOSES samples."""
    def cut(make):
        def wrapper(*args, **kwargs):
            loader, sampler = make(*args, **kwargs)
            return list(itertools.islice(loader, KEYPOSES)), sampler
        return wrapper

    monkeypatch.setattr(jloader, "get_data_loader_by_data_type",
                        cut(jloader.get_data_loader_by_data_type))
    for module in (texp, tsm):
        monkeypatch.setattr(module, "get_data_loader_by_data_type",
                            cut(module.get_data_loader_by_data_type))


# ------------------------------------------------------------------ stages


def test_experiment_seed_range_guard():
    texp._assert_disjoint_seed_ranges((21, 8), (1234, 8), (5021, 16))
    with pytest.raises(AssertionError):
        texp._assert_disjoint_seed_ranges((1230, 8), (1234, 8))


def test_recovery_seed_range_guarded_before_generation(tmp_path):
    with pytest.raises(AssertionError, match="overlap"):
        texp.gen_and_fuse(str(tmp_path), num_demos=8, seed=234, task="cube_stacking",
                          recovery_demos=8, device="cpu")
    assert not (tmp_path / "ds").exists()  # failed fast, no work done


def test_experiment_train_stage_flag_plumbing(monkeypatch, tmp_path):
    """Every augmentation flag reaches the training app together, as in the
    JAX stage, and the device goes with them."""
    captured = {}
    for module in (texp, jexp):
        monkeypatch.setattr(module, "latest_checkpoint", lambda out: "dummy.ckpt")
    monkeypatch.setattr(texp, "train_main", lambda argv: captured.update(port=argv))
    monkeypatch.setattr("nvblox_mindmap_tpu.apps.run_training.main",
                        lambda argv: captured.update(jax=argv))
    kwargs = dict(num_demos=8, iters=100, apply_geometry_noise=True, pos_noise_stddev_m=0.02,
                  extra_demos=16, balance_sources=True, apply_random_transforms=True)
    texp.train(str(tmp_path), device="cpu", **kwargs)
    jexp.train(str(tmp_path), **kwargs)
    assert captured["port"] == captured["jax"] + ["--device", "cpu"]
    argv = captured["port"]
    assert argv[argv.index("--apply_random_transforms") + 1] == "1"
    assert argv[argv.index("--balance_demo_groups") + 1] == "0-7,8-23"
    assert argv[argv.index("--demos_train") + 1] == "0-23"


def test_main_dispatches_stages_per_task(monkeypatch, tmp_path):
    calls = []
    for name in ("gen_and_fuse", "dagger_gen", "train", "open_loop_eval", "closed_loop",
                 "heldout_eval"):
        monkeypatch.setattr(texp, name, lambda *a, name=name, **k: calls.append((name, a, k)))
    monkeypatch.setattr(texp, "latest_checkpoint", lambda out: "ckpt")
    texp.main(["all", "--task", "stick_in_bin", "--out", str(tmp_path), "--device", "cpu"])
    assert [c[0] for c in calls] == ["gen_and_fuse", "train", "open_loop_eval", "closed_loop"]
    out = str(tmp_path / "stick_in_bin")
    assert os.path.isdir(out)
    assert all(c[1][0] == out for c in calls)
    assert calls[1][2]["device"] == "cpu"
    assert all(c[2]["device"] == torch.device("cpu") for c in calls if c[0] != "train")
    calls.clear()
    texp.main(["closedloop", "--out", str(tmp_path), "--device", "cpu", "--scheduler", "ddim",
               "--num_inference_steps", "10", "--timestep_spacing", "trailing"])
    ((name, args, kwargs),) = calls
    assert args[0] == str(tmp_path / "cube_stacking")
    assert kwargs["summary_name"] == "closed_loop_summary_ddim.json"
    assert (kwargs["num_inference_steps"], kwargs["scheduler"], kwargs["timestep_spacing"]) == (
        10, "ddim", "trailing")


def test_experiments_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texp.main(["gen", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsm.main(["--out", str(tmp_path)])
    assert os.listdir(tmp_path) == []


# ------------------------------------------------------------------ open loop


def test_open_loop_eval_matches_jax(panning_demos, monkeypatch, jax_noise, first_keyposes):
    out, demos, _ = panning_demos
    assert glob.glob(os.path.join(demos[0], "*.nvblox_vertex_features.zst"))
    ckpt = fixture("task_success/cube_stacking/last.ckpt")
    # The JAX predictions, (num_grippers, 8) per call, to rebuild its
    # per-keypose errors.
    preds = []
    make = japp.make_infer_fn

    def recording(model, bounds):
        infer = make(model, bounds)

        def wrapped(params, batch, key):
            result = infer(params, batch, key)
            preds.append(np.asarray(result[0])[0, 0])
            return result
        return wrapped

    monkeypatch.setattr(japp, "make_infer_fn", recording)
    ref = jexp.open_loop_eval(out, 1, ckpt)
    res = texp.open_loop_eval(out, 1, ckpt, device="cpu")
    seeds = texp.OPEN_LOOP_SEEDS
    assert res["num_keyposes"] == ref["num_keyposes"] == KEYPOSES
    assert len(preds) == KEYPOSES * seeds
    gts = [np.asarray(b["gt_gripper_pred"])[0, 0] for b in _batches(out)]
    jerr = [float(np.mean(np.linalg.norm(
        np.mean(preds[seeds * i:seeds * (i + 1)], axis=0)[:, :3] - gts[i][:, :3], axis=-1)))
        for i in range(KEYPOSES)]
    np.testing.assert_allclose(res["keypose_errors_m"], jerr, atol=ERROR_ATOL, rtol=0)
    for key in ("mean_keypose_error_m", "median_keypose_error_m", "openness_accuracy"):
        assert res[key] == pytest.approx(ref[key], abs=ERROR_ATOL), key


def _batches(out):
    """The port's open-loop batches of ``open_loop_eval`` (as loaded)."""
    from nvblox_mindmap_torch.apps.run_training import resolve_keypose_params
    from nvblox_mindmap_torch.data.dataset import SamplingWeightingType
    from nvblox_mindmap_torch.data.vertex_sampling import VertexSamplingMethod
    from nvblox_mindmap_torch.utils.config import TrainingAppArgs

    extra, mode = resolve_keypose_params(TrainingAppArgs(task="cube_stacking"))
    loader, _ = texp.get_data_loader_by_data_type(
        embodiment=texp._embodiment_for_task("cube_stacking"),
        dataset_path=os.path.join(out, "ds"), demos="0", num_workers=0, batch_size=1,
        use_keyposes=True, data_type="mesh", only_sample_keyposes=True,
        extra_keyposes_around_grasp_events=extra, keypose_detection_mode=mode,
        include_failed_demos=False, sampling_weighting_type=SamplingWeightingType.NONE,
        num_history=3, prediction_horizon=1, num_vertices_to_sample=texp.N_VERTICES,
        vertex_sampling_method=VertexSamplingMethod.RANDOM_WITHOUT_REPLACEMENT, seed=0,
        drop_last=False)
    return loader


# ------------------------------------------------------------------ spatial memory


@pytest.fixture(scope="module")
def panning_demos(tmp_path_factory):
    """The port's panning demos in ``<root>/ds``, fused (the dataset of
    both evaluations), and the JAX package's from the same seeds."""
    root = tmp_path_factory.mktemp("spatial_mem")
    # Two demos whose randomized cube positions differ (seeds 100, 101);
    # generate_panning_demos asserts the pan removes every cube pixel.
    demos = tsm.generate_panning_demos(str(root / "ds"), 2, seed=100, image_size=64)
    ref = jsm.generate_panning_demos(str(root / "jax"), 2, seed=100, image_size=64)
    tsm.fuse_demos(demos, device="cpu")
    return str(root), demos, ref


def _cube2_position(demo):
    with open(os.path.join(demo, "scene.json")) as f:
        return np.asarray(json.load(f)["objects"]["cube_2"])[:3]


def _final_frame_index(demo):
    frames = glob.glob(os.path.join(demo, "*.wrist_rgb.png"))
    return max(int(os.path.basename(p).split(".")[0]) for p in frames)


def test_panning_demos_match_jax(panning_demos):
    _, demos, ref = panning_demos
    for d, j in zip(demos, ref):
        assert_demos_equal(d, j, fused=True)
    assert tsm.mean_predictor_floor(demos) == jsm.mean_predictor_floor(ref)


def test_post_pan_rgbd_is_scene_independent(panning_demos):
    """Post-pan RGB-D frames are pixel-identical across scenes with
    different cube placements (up to the moving robot-marker pixels)."""
    _, (a, b), _ = panning_demos
    assert np.linalg.norm(_cube2_position(a) - _cube2_position(b)) > 0.05
    t = tsm.PAN_END + 2
    for item in ("wrist_rgb.png", "wrist_depth.png"):
        fa = decode_png(os.path.join(a, f"{t}.{item}"))
        fb = decode_png(os.path.join(b, f"{t}.{item}"))
        sa = decode_png(os.path.join(a, f"{t}.wrist_semantic.png"))
        sb = decode_png(os.path.join(b, f"{t}.wrist_semantic.png"))
        static = (sa < 200) & (sb < 200)
        diff = fa[static].astype(np.int64) - fb[static].astype(np.int64)
        assert np.abs(diff).max() == 0, item


def test_fused_map_remembers_cube_after_pan(panning_demos):
    _, demos, _ = panning_demos
    for demo in demos:
        cube2 = _cube2_position(demo)
        mesh = unpickle_zst(os.path.join(
            demo, f"{_final_frame_index(demo)}.nvblox_vertex_features.zst"))
        vertices = np.asarray(mesh["vertices"], np.float32)
        near = np.linalg.norm(vertices - cube2[None, :], axis=1) < 0.08
        assert near.sum() >= 5, f"fused map lost the remembered cube ({near.sum()})"
    a, b = demos
    mesh_b = unpickle_zst(os.path.join(
        b, f"{_final_frame_index(b)}.nvblox_vertex_features.zst"))
    verts_b = np.asarray(mesh_b["vertices"], np.float32)
    above = verts_b[:, 2] > 0.02
    assert (np.linalg.norm(verts_b[above] - _cube2_position(a)[None], axis=1) < 0.05).sum() == 0


def test_scene_json_restores_panning_camera(panning_demos):
    _, demos, _ = panning_demos
    demo = demos[0]
    env = tsm.env_from_scene_json(demo)
    env.reset()
    for t in (0, tsm.PAN_END + 3):
        env.steps = t
        rendered = env.get_cameras()["wrist"].rgb
        recorded = decode_png(os.path.join(demo, f"{t}.wrist_rgb.png")).astype(np.float32) / 255.0
        static = decode_png(os.path.join(demo, f"{t}.wrist_semantic.png")) < 200
        static &= env.get_cameras()["wrist"].segmentation < 200
        assert np.abs(rendered[static] - recorded[static]).max() < 2.5 / 255.0
    # refresh_scene_jsons re-writes the JAX package's scene.json text.
    before = open(os.path.join(demo, "scene.json")).read()
    tsm.refresh_scene_jsons(os.path.dirname(demo), 1, 100)
    assert open(os.path.join(demo, "scene.json")).read() == before


def test_eval_pick_keypose_error_matches_jax(panning_demos, jax_noise, first_keyposes):
    """The rgbd fixture (its image path; ``open_loop_eval`` above holds a
    mesh model through the same sampler)."""
    root, demos, _ = panning_demos
    ds = os.path.join(root, "ds")
    data_type = "rgbd"
    ckpt = fixture(f"spatial_memory/{data_type}_last.ckpt")
    ref = jsm.eval_pick_keypose_error(ds, demos[:1], ckpt, data_type, eval_seeds=3)
    out = tsm.eval_pick_keypose_error(ds, demos[:1], ckpt, data_type, eval_seeds=3,
                                      device="cpu")
    assert out["num_keyposes"] == ref["num_keyposes"] == KEYPOSES
    assert out["num_pick_keyposes"] == ref["num_pick_keyposes"] >= 1
    for key in ("pick_keypose_error_m", "all_keypose_error_m"):
        assert out[key] == pytest.approx(ref[key], abs=ERROR_ATOL), key


# ------------------------------------------------------------------ slow bars


def _task_fixture(task):
    return fixture(f"task_success/{task}/last.ckpt")


@pytest.mark.slow
@pytest.mark.parametrize("task", ["cube_stacking", "mug_in_drawer", "drill_in_box",
                                  "stick_in_bin"])
def test_port_trained_policy_closed_loop_task_success(tmp_path, task):
    """``tests/test_task_success.py::test_trained_policy_closed_loop_task_success``
    on the port's chain: its generators rebuild the fixture's scenes (seed
    21), its runner, policy (DDPM-100) and evaluator judge them."""
    texp._generator_for_task(task)(str(tmp_path / "ds"), 8, 21)
    summary = texp.closed_loop(str(tmp_path), 8, _task_fixture(task), demos_subset=[0, 1, 2, 3],
                               task=task, device="cpu")
    assert summary["num_demos"] == 4
    assert summary["success_rate"] > 0, summary
    if task == "cube_stacking":
        assert summary["mean_num_lifted_cubes"] >= 0.5, summary


@pytest.mark.slow
@pytest.mark.parametrize("task,serving", [
    ("mug_in_drawer", dict(num_inference_steps=10, scheduler="ddim")),
    ("drill_in_box", dict(num_inference_steps=10, scheduler="ddim",
                          timestep_spacing="trailing")),
    ("stick_in_bin", dict(num_inference_steps=20, scheduler="ddpm")),
])
def test_port_trained_policy_closed_loop_fewstep_serving(tmp_path, task, serving):
    """``tests/test_task_success.py::test_trained_policy_closed_loop_fewstep_serving``
    on the port's chain."""
    texp._generator_for_task(task)(str(tmp_path / "ds"), 8, 21)
    summary = texp.closed_loop(str(tmp_path), 8, _task_fixture(task), demos_subset=[0, 1, 2, 3],
                               task=task, summary_name="closed_loop_summary_ddim.json",
                               device="cpu", **serving)
    assert summary["num_demos"] == 4
    assert summary["success_rate"] > 0, summary


@pytest.mark.slow
def test_port_trained_mesh_policy_beats_rgbd_on_remembered_pick(tmp_path):
    """``tests/test_spatial_memory.py::test_trained_mesh_policy_beats_rgbd_on_remembered_pick``
    on the port's chain: its panning demos, fusion and open-loop sampler."""
    ds = tmp_path / "demos"
    demos = tsm.generate_panning_demos(str(ds), 3, seed=100, image_size=64)
    tsm.fuse_demos(demos, device="cpu")
    mesh = tsm.eval_pick_keypose_error(str(ds), demos, fixture("spatial_memory/mesh_last.ckpt"),
                                       "mesh", eval_seeds=3, device="cpu")
    rgbd = tsm.eval_pick_keypose_error(str(ds), demos, fixture("spatial_memory/rgbd_last.ckpt"),
                                       "rgbd", eval_seeds=3, device="cpu")
    floor = tsm.mean_predictor_floor(demos)
    print(f"mesh={mesh['pick_keypose_error_m']:.3f} rgbd={rgbd['pick_keypose_error_m']:.3f} "
          f"floor~{floor:.3f}")
    assert mesh["pick_keypose_error_m"] < 0.06, mesh
    assert rgbd["pick_keypose_error_m"] > 0.08, rgbd
    assert rgbd["pick_keypose_error_m"] > 2.0 * mesh["pick_keypose_error_m"], (mesh, rgbd)
