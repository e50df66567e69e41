"""Torch port vs the JAX package: the decoder API, the cluster workflows
and the remaining scripts.

- ``runtime``: ``decode_png`` / ``decode_png_batch`` (1 and 4 threads) /
  ``decode_zstd_pickle`` give the JAX runtime's arrays on the same files
  (written by imageio and the JAX package's ``pickle_zst``); a missing and a
  corrupt entry give None with the entries around them intact; the
  unfilter builds into the port's ``build/``.
- ``benchmark_decompression`` at a small size, on the port's libzstd (its
  frames read back by ``zstandard``; the default level keeps the item
  writer's bytes).
- ``tar_demos`` (members and bytes), ``publish_closed_loop_eval`` (the same
  HTML) and ``hdf5_tools`` (skipped only without h5py; without it the port
  raises naming it) against JAX's.
- ``plot_humanoid_keyposes``: the keypose indices equal JAX's on the same
  humanoid demos (a synthetic one and one of the port's recorder), and the
  figure decodes at matplotlib's size with a line per keypose.
- ``workflows.submit``: the specs equal JAX's but for the accelerator key,
  the module paths and the torchrun launch of a multi-GPU training stage.
- ``convert_backbone_weights``: the port's ``.npz`` and golden file equal
  JAX's, array by array, for a local stand-in CLIP trunk; the offline golden
  rehearsal (stand-in -> golden -> the port's trunk at the JAX harness's
  tolerance); ``make_backbone_golden`` reaching the hub for RADIO and DINOv2
  and exiting 1 offline; the golden-fixture test, which un-skips when
  ``tests/test_data/backbones/`` holds fixtures.
"""
import functools
import json
import os
import sys
import tarfile
import types

import numpy as np
import pytest
import torch

from nvblox_mindmap_tpu import runtime as jruntime
from nvblox_mindmap_tpu.data.dataset import pickle_zst as jax_pickle_zst
from nvblox_mindmap_tpu.models import weight_conversion as jconversion
from nvblox_mindmap_tpu.scripts import convert_backbone_weights as jconvert
from nvblox_mindmap_tpu.scripts import hdf5_tools as jhdf5
from nvblox_mindmap_tpu.scripts import plot_humanoid_keyposes as jplot
from nvblox_mindmap_tpu.scripts import publish_closed_loop_eval as jpublish
from nvblox_mindmap_tpu.scripts import tar_demos as jtar
from nvblox_mindmap_tpu.workflows import submit as jsubmit
from nvblox_mindmap_torch import runtime as truntime
from nvblox_mindmap_torch.data import item_io
from nvblox_mindmap_torch.models import weight_conversion as tconversion
from nvblox_mindmap_torch.models.feature_extractors import FeatureExtractorType
from nvblox_mindmap_torch.ops import _build
from nvblox_mindmap_torch.scripts import benchmark_decompression as tbench
from nvblox_mindmap_torch.scripts import convert_backbone_weights as tconvert
from nvblox_mindmap_torch.scripts import hdf5_tools as thdf5
from nvblox_mindmap_torch.scripts import make_backbone_golden as tgolden
from nvblox_mindmap_torch.scripts import plot_humanoid_keyposes as tplot
from nvblox_mindmap_torch.scripts import publish_closed_loop_eval as tpublish
from nvblox_mindmap_torch.scripts import tar_demos as ttar
from nvblox_mindmap_torch.workflows import submit as tsubmit
from tests.test_data_pipeline import write_arm_demo
from tests.test_humanoid import write_humanoid_demo
from tests.test_weight_conversion import TorchModifiedResNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "test_data", "backbones")
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073])
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711])


# ------------------------------------------------------------------ runtime


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    import imageio.v2 as imageio

    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(2)
    arrays = {
        "rgb.png": rng.integers(0, 256, (32, 48, 3)).astype(np.uint8),
        "rgba.png": rng.integers(0, 256, (16, 8, 4)).astype(np.uint8),
        "gray.png": rng.integers(0, 256, (9, 13)).astype(np.uint8),
        "depth.png": rng.integers(0, 5000, (32, 32)).astype(np.uint16),
    }
    for name, array in arrays.items():
        imageio.imwrite(str(root / name), array)
    (root / "bad.png").write_bytes(b"\x89PNG\r\n\x1a\nthis is not a real png")
    return root, arrays


def test_runtime_decodes_the_jax_runtimes_arrays(image_files):
    root, arrays = image_files
    assert jruntime.ensure_built() and truntime.ensure_built() and truntime.native_available()
    assert os.path.exists(_build.library_path("png_unfilter", ".c"))
    paths = [str(root / name) for name in arrays]
    for path, array in zip(paths, arrays.values()):
        ours = truntime.decode_png(path)
        ref = jruntime.decode_png(path)
        assert ours.dtype == ref.dtype == array.dtype and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(ours, array)
    for threads in (1, 4):
        ours = truntime.decode_png_batch(paths, n_threads=threads)
        ref = jruntime.decode_png_batch(paths, n_threads=threads)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_runtime_batch_gives_none_for_missing_and_corrupt_entries(image_files):
    root, arrays = image_files
    paths = [str(root / "rgb.png"), str(root / "bad.png"), str(root / "missing.png"),
             str(root / "depth.png")]
    for threads in (1, 4):
        ours = truntime.decode_png_batch(paths, n_threads=threads)
        ref = jruntime.decode_png_batch(paths, n_threads=threads)
        assert ours[1] is None and ours[2] is None and ref[1] is None and ref[2] is None
        np.testing.assert_array_equal(ours[0], arrays["rgb.png"])
        np.testing.assert_array_equal(ours[3], arrays["depth.png"])
    with pytest.raises(ValueError):
        truntime.decode_png(str(root / "bad.png"))  # one by one, a bad file raises


def test_runtime_decodes_the_jax_packages_zstd_pickles(tmp_path):
    rng = np.random.default_rng(0)
    obj = {"vertices": rng.normal(size=(64, 3)).astype(np.float16),
           "features": rng.normal(size=(64, 8)).astype(np.float16), "channel_length": 8}
    path = str(tmp_path / "x.zst")
    jax_pickle_zst(obj, path)
    ours, ref = truntime.decode_zstd_pickle(path), jruntime.decode_zstd_pickle(path)
    assert ours["channel_length"] == ref["channel_length"] == 8
    for key in ("vertices", "features"):
        assert ours[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(ours[key], ref[key])
    np.testing.assert_array_equal(ours["features"], item_io.unpickle_zst(path)["features"])


# ------------------------------------------------------------------ scripts


def test_benchmark_decompression_on_libzstd():
    import zstandard

    results = tbench.benchmark(n_vertices=64, channels=8, levels=(1, 3), repeats=2)
    assert set(results) == {1, 3}
    for stats in results.values():
        assert set(stats) == {"compressed_mb", "ratio", "decode_ms", "decode_gbps"}
        assert stats["ratio"] > 0.9 and stats["decode_ms"] > 0
    raw = np.random.default_rng(4).integers(0, 256, 1000, np.uint8).tobytes() + bytes(5000)
    for level in (1, 3, 9):
        blob = item_io.zstd_compress(raw, level=level)
        assert zstandard.ZstdDecompressor().decompress(blob) == raw
    # The item writer's default level is unchanged.
    assert item_io.zstd_compress(raw) == item_io.zstd_compress(raw, level=item_io.ZSTD_LEVEL)
    assert item_io.ZSTD_LEVEL == 1


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_tar_demos_equal_jax(tmp_path):
    src = tmp_path / "src"
    write_arm_demo(str(src / "demo_00000"), seed=0, n_vertices=20)
    write_arm_demo(str(src / "demo_00001"), seed=1, n_vertices=20)
    out = {}
    for side, module in (("port", ttar), ("jax", jtar)):
        tars = module.tar_demos(str(src), "0-1", str(tmp_path / side / "tars"))
        assert [os.path.basename(t) for t in tars] == ["demo_00000.tar", "demo_00001.tar"]
        members = []
        for t in tars:
            with tarfile.open(t) as tar:
                members.append(sorted(m.name for m in tar.getmembers()))
        extracted = module.untar_demos(str(tmp_path / side / "tars"), str(tmp_path / side / "out"))
        out[side] = (members, [os.path.basename(e) for e in extracted],
                     _tree_bytes(str(tmp_path / side / "out")))
    assert out["port"] == out["jax"]
    assert out["port"][2] == _tree_bytes(str(src))


def test_publish_report_equals_jax(tmp_path):
    paths = []
    for i, (n, ok) in enumerate(((2, 1), (3, 3))):
        path = str(tmp_path / f"eval_{i}.json")
        with open(path, "w") as f:
            json.dump({"num_demos": n, "num_successes": ok, "success_rate": ok / n,
                       "outcomes": {f"demo_{d}": d < ok for d in range(n)}}, f)
        paths.append(path)
    videos = tmp_path / "videos"
    videos.mkdir()
    (videos / "demo_0.mp4").write_bytes(b"")
    html = {}
    for side, module in (("port", tpublish), ("jax", jpublish)):
        out = module.render_report(paths, str(tmp_path / side / "report.html"), str(videos))
        with open(out) as f:
            html[side] = f.read()
    assert html["port"] == html["jax"] and "50.00%" in html["port"]


def test_hdf5_tools_equal_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    a = str(tmp_path / "a.hdf5")
    with h5py.File(a, "w") as f:
        data = f.create_group("data")
        data.attrs["env_name"] = "test"
        for i in (0, 1, 2, 10):
            g = data.create_group(f"demo_{i}")
            g.create_dataset("actions", data=np.full((5, 7), i, dtype=np.float32))
            g.create_dataset("initial_state", data=np.arange(3) + i)
    assert thdf5.list_demos(a) == jhdf5.list_demos(a) == ["demo_0", "demo_1", "demo_2",
                                                          "demo_10"]
    contents = {}
    for side, module in (("port", thdf5), ("jax", jhdf5)):
        single = str(tmp_path / f"{side}_single.hdf5")
        module.extract_single_demo(a, "demo_10", single)
        merged = str(tmp_path / f"{side}_merged.hdf5")
        module.merge_hdf5_files([a, single], merged)
        rows = []
        for path in (single, merged):
            with h5py.File(path) as f:
                rows.append((dict(f["data"].attrs), {
                    name: {k: f["data"][name][k][()].tolist() for k in f["data"][name]}
                    for name in f["data"]}))
        contents[side] = rows
    assert contents["port"] == contents["jax"]
    assert len(contents["port"][1][1]) == 5


def test_hdf5_tools_name_h5py_when_it_is_absent(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        thdf5.list_demos(str(tmp_path / "a.hdf5"))


def _recorded_humanoid_demo(root):
    """A drill_in_box demo of the port's generator (HumanoidDemoRecorder)."""
    from nvblox_mindmap_torch.closed_loop import scripted

    (demo,) = scripted.generate_drill_in_box_demos(str(root), num_demos=1, seed=0,
                                                   image_size=16)
    return demo


def test_plot_humanoid_keyposes_equals_jax(tmp_path):
    from nvblox_mindmap_torch.data.item_io import decode_png

    synthetic = str(tmp_path / "synthetic" / "demo_00000")
    write_humanoid_demo(synthetic)
    recorded = _recorded_humanoid_demo(tmp_path / "recorded")
    for demo in (synthetic, recorded):
        ours = tplot.analyze_demo(demo, str(tmp_path / "plots"))
        ref = jplot.analyze_demo(demo, plot=False)
        assert len(ours) > 2
        np.testing.assert_array_equal(ours, ref)
        figure = decode_png(str(tmp_path / "plots" / f"{os.path.basename(demo)}_keyposes.png"))
        assert figure.shape == (800, 1000, 3)
        # A light-red column per keypose (those on the first and last frame
        # lie under the panel's frame), and both series colours drawn.
        red = np.all(figure == tplot.KEYPOSE_COLOR, axis=-1)
        assert red.any(axis=0).sum() >= len(np.unique(ours)) - 2
        for color in tplot.SERIES_COLORS:
            assert np.all(figure == color, axis=-1).sum() > 100
    # The command line walks a dataset root.
    found = tplot.main(["--demo_path", str(tmp_path / "synthetic")])
    assert list(found) == [synthetic]


# ------------------------------------------------------------------ workflows


def _as_port_spec(spec):
    """A JAX spec with the port's accelerator key, module paths and, for a
    training stage of more than one GPU, the torchrun launch."""
    spec = json.loads(json.dumps(spec).replace("tpu_chips", "gpus")
                      .replace("nvblox_mindmap_tpu", "nvblox_mindmap_torch"))
    gpus = spec["resources"]["gpus"]
    if spec["kind"] == "training" and gpus > 1:
        command = spec["command"]
        spec["command"] = command[:2] + ["torch.distributed.run", "--standalone",
                                         "--nproc_per_node", str(gpus), "-m"] + command[2:]
    spec["command_line"] = None
    return spec


@pytest.mark.parametrize("make", [
    lambda m: m.make_datagen_workflow("cube_stacking", "/demos.hdf5", "/out", "0-3", ["--x"]),
    lambda m: m.make_training_workflow("drill_in_box", "/data", "0-9", ["--batch_size", "8"]),
    lambda m: m.make_evaluation_workflow("mug_in_drawer", "/data", "/c/best.ckpt", "2"),
    lambda m: m.make_train_and_eval_workflow("mug_in_drawer", "/data", "0-5", "6-9", "/ckpt"),
    lambda m: m.make_e2e_workflow("cube_stacking", "/demos.hdf5", "/work"),
], ids=["datagen", "training", "evaluation", "train_and_eval", "e2e"])
def test_workflow_specs_equal_jax(make, tmp_path):
    ours, ref = make(tsubmit), make(jsubmit)
    assert len(ours["stages"]) == len(ref["stages"])
    for stage, jstage in zip(ours["stages"], ref["stages"]):
        assert stage["command_line"] == " ".join(stage["command"])
        assert dict(stage, command_line=None) == _as_port_spec(jstage)
    path = tsubmit.write_workflow(ours, str(tmp_path / "wf.json"))
    with open(path) as f:
        assert json.load(f) == ours


def test_workflow_stage_gpus():
    one = tsubmit.WorkflowStage("t", "training", ["--task", "x"], gpus=1).to_spec()
    assert one["command"][:3] == ["python", "-m", "nvblox_mindmap_torch.apps.run_training"]
    four = tsubmit.WorkflowStage("t", "training", [], gpus=4).to_spec()
    assert four["resources"]["gpus"] == 4 and "--nproc_per_node 4 -m" in four["command_line"]
    assert tsubmit.STAGE_RESOURCES["training"]["gpus"] == jsubmit.STAGE_RESOURCES[
        "training"]["tpu_chips"] == 2


# ------------------------------------------------------------------ backbone weights


def _stand_in_clip(layers=(1, 1, 1, 1), width=8, seed=3):
    torch.manual_seed(seed)
    visual = TorchModifiedResNet(layers, width).eval()
    with torch.no_grad():
        for m in visual.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    return visual


def test_convert_backbone_weights_writes_the_jax_npz(tmp_path, monkeypatch):
    """Both scripts' ``main`` on the same stand-in trunk (CLIP's ``load``
    replaced by it; the converters told its layers): the weights and golden
    files are equal, array by array."""
    visual = _stand_in_clip()
    fake_clip = types.ModuleType("clip")
    fake_clip.load = lambda name, device="cpu": (types.SimpleNamespace(visual=visual), None)
    monkeypatch.setitem(sys.modules, "clip", fake_clip)
    monkeypatch.setattr(tconvert, "convert_clip_resnet_weights", functools.partial(
        tconversion.convert_clip_resnet_weights, layers=(1, 1, 1, 1)))
    monkeypatch.setattr(jconvert, "convert_clip_resnet_weights", functools.partial(
        jconversion.convert_clip_resnet_weights, layers=(1, 1, 1, 1)))
    for side, module in (("port", tconvert), ("jax", jconvert)):
        module.main(["--feature_type", "clip_resnet50_fpn", "--output", str(tmp_path / side),
                     "--write_golden"])
    for name in ("clip_resnet50_fpn.npz", "clip_resnet50_fpn_golden.npz"):
        ours, ref = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert sorted(ours.files) == sorted(ref.files) and len(ours.files) >= 6
        for key in ref.files:
            assert ours[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def verify_golden_fixture(feature_type, golden, weights, **module_kwargs):
    """The port's extractor against a golden file: the CLIP trunk's five
    taps, or a ViT's spatial features, within 0.08 of the reference's
    largest magnitude (the JAX harness's bar)."""
    from nvblox_mindmap_torch.models.clip_resnet_fpn import ModifiedResNetFeatures
    from nvblox_mindmap_torch.models.feature_extractors import make_feature_extractor
    from nvblox_mindmap_torch.models.pretrained import (
        _clip_trunk,
        _mean_std_from,
        _num_prefix_tokens_from,
        load_backbone_npz,
    )
    from nvblox_mindmap_torch.models.weights import load_flax_params

    data = np.load(golden)
    loaded = load_backbone_npz(weights)
    params = loaded["params"]
    if feature_type == FeatureExtractorType.CLIP_RESNET50_FPN:
        trunk = ModifiedResNetFeatures(**module_kwargs)
        load_flax_params(trunk, _clip_trunk(params))
        x = ((np.asarray(data["rgb"]) - CLIP_MEAN) / CLIP_STD).astype(np.float32)
        with torch.no_grad():
            feats = trunk(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert len(feats) == 5
        for i, ours in enumerate(feats):
            ref = np.asarray(data[f"expected_trunk_{i}"])
            ours = ours.permute(0, 2, 3, 1).numpy()
            assert ours.shape == ref.shape
            err = np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-6)
            assert err < 0.08, (i, err)
        return
    grid = tuple(int(s) for s in data["expected"].shape[1:3])
    if "pos_embed" in params:  # resample to the fixture's patch grid
        params = tconversion.interpolate_pos_embed(params, grid[0])
    module = make_feature_extractor(feature_type, feature_image_size=grid,
                                    mean_std=_mean_std_from(loaded),
                                    num_prefix_tokens=_num_prefix_tokens_from(params))
    load_flax_params(module, params)
    with torch.no_grad():
        ours = module(torch.from_numpy(np.asarray(data["rgb"], np.float32))).float().numpy()
    ref = np.asarray(data["expected"])
    err = np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err < 0.08, err


def test_golden_recipe_rehearsal_on_the_port(tmp_path):
    """The fixture recipe without egress: a stand-in CLIP trunk plays the
    hub checkpoint, the port's write_golden records its taps, the port's
    converter writes the npz, and the port's trunk reproduces the taps."""
    layers, width = (1, 1, 1, 1), 8
    visual = _stand_in_clip(layers, width)
    golden = str(tmp_path / "clip_resnet50_fpn_golden.npz")
    tconvert.write_golden(FeatureExtractorType.CLIP_RESNET50_FPN, visual, golden, image_hw=32)
    state = {"visual." + k: v.numpy() for k, v in visual.state_dict().items()}
    variables = tconversion.convert_clip_resnet_weights(state, layers=layers)
    weights = str(tmp_path / "clip_resnet50_fpn.npz")
    tconversion.save_variables_npz(weights, {"params": {"backbone": variables["params"]}})
    verify_golden_fixture(FeatureExtractorType.CLIP_RESNET50_FPN, golden, weights,
                          layers=layers, width=width)


def test_make_backbone_golden_exits_1_offline(tmp_path, monkeypatch, capsys):
    hub_calls = []

    def offline_hub_load(*args, **kwargs):
        hub_calls.append(args[0] if args else kwargs)
        raise OSError("no egress to torch hub on this host")

    monkeypatch.setattr(torch.hub, "load", offline_hub_load)
    monkeypatch.setitem(sys.modules, "clip", None)  # CLIP's loader is absent too
    assert tgolden.main(["--output", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    for feature_type in tgolden.GOLDEN_TYPES:
        assert feature_type.value in out.split("FAILED for:")[-1]
    assert hub_calls == ["NVlabs/RADIO", "facebookresearch/dinov2"]
    assert "egress" in out
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("feature_type", list(tgolden.GOLDEN_TYPES), ids=lambda t: t.value)
def test_golden_activation_fixture_on_the_port(feature_type):
    """The port's extractor against activations of the real hub checkpoint,
    once ``scripts/make_backbone_golden`` has written them into
    tests/test_data/backbones/ on a host with egress."""
    golden = os.path.join(GOLDEN_DIR, f"{feature_type.value}_golden.npz")
    weights = os.path.join(GOLDEN_DIR, f"{feature_type.value}.npz")
    if not (os.path.exists(golden) and os.path.exists(weights)):
        pytest.skip(f"no golden fixture for {feature_type.value} (expected {golden}; "
                    "produce it with scripts/make_backbone_golden on a host with egress)")
    verify_golden_fixture(feature_type, golden, weights)
