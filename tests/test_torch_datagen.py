"""Torch port vs the JAX package: datagen and map persistence.

``apps/run_datagen.py``'s ``process_demo`` and ``main`` of both packages
fuse the same JAX-written cube_stacking demo (64x64, RGB features, the
mapping config of ``tests/test_task_success.py:23-47``). Maps written by
``save_map`` load across, and the writer's semantic items and
``add_depth_noise`` match.

Each package integrates its own map, and before each frame's export the
port's map is held to the JAX app's (``assert_states_match``, the bounds of
``tests/test_torch_mapping.py``) and then replaced by it, as
``tests/test_torch_closed_loop.py`` does before each goal. Maps integrated
apart do not give the same vertex count: XLA's CPU dot fuses the TSDF's
weighted average into an FMA, so a voxel at the truncation distance comes
out one ulp above it in one package and one below in the other, and
crosses the ``|tsdf| < truncation`` test of the extraction (26 of 3329
crossings at frame 4 of this demo; ``ROADMAP.md`` section 3). From one map,
every frame's item has the same vertex count; the stored fp16 vertices
agree within ``VERTEX_ATOL`` = 1e-3 and the fp16 features within
``FEATURE_ATOL`` = 2e-3 (the extraction's own FMA differences, ~1e-7,
then one fp16 rounding: at most one fp16 ulp at these magnitudes). A map
file the JAX package wrote loads into the port bit for bit, and the port's
own map file round-trips bit for bit.
"""
import dataclasses
import io
import os
import pickle
import shutil
import types

import numpy as np
import pytest

import imageio.v2 as imageio

from nvblox_mindmap_tpu.apps import run_datagen as jdatagen
from nvblox_mindmap_tpu.closed_loop.scripted import generate_cube_stacking_demos
from nvblox_mindmap_tpu.data.writer import DemoWriter as JaxWriter
from nvblox_mindmap_tpu.embodiments.arm import ArmEmbodiment as JaxArm
from nvblox_mindmap_tpu.embodiments.registry import Tasks as JaxTasks
from nvblox_mindmap_tpu.image import conversions as jconv
from nvblox_mindmap_tpu.mapping import mapper as jmapper
from nvblox_mindmap_tpu.mapping.constants import MapperId as JaxMapperId
from nvblox_mindmap_tpu.mapping.constants import MappingConfig as JaxMappingConfig
from nvblox_mindmap_torch.apps import run_datagen as tdatagen
from nvblox_mindmap_torch.data.item_io import decode_png, unpickle_zst
from nvblox_mindmap_torch.data.writer import DemoWriter
from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
from nvblox_mindmap_torch.image import conversions as tconv
from nvblox_mindmap_torch.mapping import mapper as tmapper
from nvblox_mindmap_torch.mapping.constants import MapperId, MappingConfig
from nvblox_mindmap_torch.mapping.voxel_grid import state_from_numpy, state_to_numpy
from nvblox_mindmap_torch.utils import timers
from tests.test_torch_mapping import assert_states_match
from tests.test_torch_model_parity import one_torch_thread  # noqa: F401 (autouse fixture)

VERTEX_ATOL = 1e-3
FEATURE_ATOL = 2e-3
FRAMES = 12


def jax_mapping_config():
    """``tests/test_task_success.py``'s datagen config."""
    cfg = JaxMappingConfig.for_task(JaxTasks.CUBE_STACKING, feature_dim=3, voxel_size_m=0.02,
                                    max_feature_pages=512)
    return dataclasses.replace(cfg, upscaled_feature_image_size=(64, 64),
                               static_mask_erosion_iterations=2,
                               valid_depth_mask_erosion_iterations=2)


def port_config(jcfg):
    return MappingConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    root = tmp_path_factory.mktemp("datagen")
    (path,) = generate_cube_stacking_demos(str(root / "src"), 1, seed=2, cube_half=0.04)
    return path


def _copy(demo, dst):
    shutil.copytree(demo, dst)
    return str(dst)


def _items(path, n):
    return [unpickle_zst(os.path.join(path, f"{t}.nvblox_vertex_features.zst"))
            for t in range(n)]


@pytest.fixture
def one_map_per_frame(monkeypatch):
    """Record the JAX app's maps at each export; hold the port's map to the
    recorded one at the same export, then replace it (module docstring)."""
    recorded, replayed = [], []
    jsave, tsave = jdatagen.save_feature_mesh_to_disk, tdatagen.save_feature_mesh_to_disk

    def record(mapper, path, **kw):
        # A host copy: the JAX mapper donates its state's buffers.
        recorded.append({mid: types.SimpleNamespace(**state_to_numpy(state))
                         for mid, state in mapper.states.items()})
        return jsave(mapper, path, **kw)

    def replay(mapper, path, **kw):
        ref = recorded[len(replayed)]
        assert sorted(ref) == sorted(mapper.states)
        for mid, state in ref.items():
            assert_states_match(mapper.states[mid], state, f"frame {len(replayed)} map {mid}")
            mapper.states[mid] = state_from_numpy(vars(state), mapper.device)
        replayed.append(path)
        return tsave(mapper, path, **kw)

    monkeypatch.setattr(jdatagen, "save_feature_mesh_to_disk", record)
    monkeypatch.setattr(tdatagen, "save_feature_mesh_to_disk", replay)
    return recorded, replayed


def assert_items_close(out, ref):
    assert len(out) == len(ref)
    for t, (a, b) in enumerate(zip(out, ref)):
        assert a["channel_length"] == b["channel_length"], t
        assert a["vertices"].dtype == b["vertices"].dtype == np.float16, t
        assert a["features"].dtype == b["features"].dtype == np.float16, t
        assert a["vertices"].shape == b["vertices"].shape, (t, a["vertices"].shape,
                                                            b["vertices"].shape)
        np.testing.assert_allclose(a["vertices"].astype(np.float32),
                                   b["vertices"].astype(np.float32), atol=VERTEX_ATOL,
                                   rtol=0, err_msg=f"frame {t} vertices")
        np.testing.assert_allclose(a["features"].astype(np.float32),
                                   b["features"].astype(np.float32), atol=FEATURE_ATOL,
                                   rtol=0, err_msg=f"frame {t} features")
    assert sum(len(a["vertices"]) for a in out) > 100


@pytest.mark.parametrize("include_dynamic,noise", [(False, False), (True, True)])
def test_process_demo_matches_jax(demo, tmp_path, include_dynamic, noise, one_map_per_frame):
    """Per-frame items and the end maps (STATIC, and DYNAMIC with the robot
    marker's pixels), with and without depth noise from one seed."""
    jcfg = jax_mapping_config()
    jdir, tdir = _copy(demo, tmp_path / "jax"), _copy(demo, tmp_path / "port")
    os.remove(os.path.join(jdir, "demo_successful.npy"))
    os.remove(os.path.join(tdir, "demo_successful.npy"))
    jmap = jdatagen.process_demo(
        jdir, JaxArm(), jcfg, jdatagen.make_mapping_feature_fn("rgb", (64, 64)),
        save_serialized_map=True, max_num_steps=FRAMES, include_dynamic=include_dynamic,
        add_depth_noise=noise, noise_rng=np.random.default_rng(5))
    timers.reset_timers()
    tmap = tdatagen.process_demo(
        tdir, ArmEmbodiment(), port_config(jcfg),
        tdatagen.make_mapping_feature_fn("rgb", (64, 64), device="cpu"),
        save_serialized_map=True, max_num_steps=FRAMES, include_dynamic=include_dynamic,
        add_depth_noise=noise, noise_rng=np.random.default_rng(5), device="cpu")
    assert jmap is None  # the JAX function returns nothing; the port returns its mapper
    assert len(one_map_per_frame[1]) == FRAMES
    assert_items_close(_items(tdir, FRAMES), _items(jdir, FRAMES))
    assert not os.path.exists(os.path.join(tdir, f"{FRAMES}.nvblox_vertex_features.zst"))
    for name in ("datagen/decay", "datagen/compute_features", "datagen/integrate",
                 "datagen/export_mesh"):
        assert len(timers.timer_samples(name)) >= FRAMES, name
    assert int(np.load(os.path.join(tdir, "demo_successful.npy"))) == 1
    ids = [("static", MapperId.STATIC)] + ([("dynamic", MapperId.DYNAMIC)]
                                           if include_dynamic else [])
    for name, mid in ids:
        # The last frame's JAX map became the port's: the two files hold it.
        path = f"nvblox_map_{name}.nvblx"
        ref = state_to_numpy(tmapper.Mapper.from_file(os.path.join(jdir, path), mid,
                                                      device="cpu").states[mid])
        out = state_to_numpy(tmapper.Mapper.from_file(os.path.join(tdir, path), mid,
                                                      device="cpu").states[mid])
        for field in ref:
            np.testing.assert_array_equal(out[field], ref[field], err_msg=f"{name} {field}")
    if include_dynamic:
        assert float(tmap.states[MapperId.DYNAMIC].weight.max()) > 0


def test_jax_map_loads_into_port_bit_for_bit(demo, tmp_path):
    """``Mapper.from_file`` and ``load_from_file`` of a JAX-written map: the
    JAX state's every array and its config, as the port's ``MappingConfig``."""
    jcfg = jax_mapping_config()
    jdir = _copy(demo, tmp_path / "jax")
    m = jmapper.Mapper({JaxMapperId.STATIC: jcfg})
    env_frames = 4
    from nvblox_mindmap_tpu.closed_loop.environment import ReplayEnvironment
    from nvblox_mindmap_tpu.geometry.np_rotations import pose7_to_matrix

    env = ReplayEnvironment(jdir, JaxArm(), ["wrist"])
    for t in range(env_frames):
        env.t = t
        frame = env.get_cameras()["wrist"]
        m.decay()
        jmapper.nvblox_integrate(m, jcfg, frame.depth, frame.rgb, frame.intrinsics,
                                 pose7_to_matrix(frame.pose7), frame.rgb, None, False)
    path = os.path.join(jdir, "map.nvblx")
    m.save_map(path)
    ref = state_to_numpy(m.states[JaxMapperId.STATIC])
    assert ref["num_pages"] > 0
    loaded = tmapper.Mapper.from_file(path, device="cpu")
    assert loaded.configs[MapperId.STATIC] == port_config(jcfg)
    assert type(loaded.configs[MapperId.STATIC]) is MappingConfig
    dual = tmapper.Mapper.dual(MappingConfig(voxel_size_m=0.2, aabb_min_m=(0, 0, 0),
                                             aabb_max_m=(1, 1, 1), feature_dim=3,
                                             max_feature_pages=4), device="cpu")
    dual.load_from_file(path, MapperId.DYNAMIC)
    for mapper, mid in ((loaded, MapperId.STATIC), (dual, MapperId.DYNAMIC)):
        out = state_to_numpy(mapper.states[mid])
        for name, value in ref.items():
            assert out[name].dtype == value.dtype, name
            np.testing.assert_array_equal(out[name], value, err_msg=name)
    assert dual.configs[MapperId.DYNAMIC] == port_config(jcfg)


def test_port_map_round_trips_bit_for_bit(demo, tmp_path):
    tdir = _copy(demo, tmp_path / "port")
    mapper = tdatagen.process_demo(
        tdir, ArmEmbodiment(), port_config(jax_mapping_config()),
        tdatagen.make_mapping_feature_fn("rgb", (64, 64), device="cpu"),
        save_serialized_map=True, max_num_steps=3, device="cpu")
    path = os.path.join(tdir, "nvblox_map_static.nvblx")
    loaded = tmapper.Mapper.from_file(path, device="cpu")
    assert loaded.configs == mapper.configs
    ref, out = state_to_numpy(mapper.states[MapperId.STATIC]), state_to_numpy(
        loaded.states[MapperId.STATIC])
    for name in ref:
        assert out[name].dtype == ref[name].dtype
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    # The map reloads to the same surface.
    a = tmapper.get_vertices_and_features(mapper, remove_zero_features=True)
    b = tmapper.get_vertices_and_features(loaded, remove_zero_features=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_map_reader_refuses_other_classes(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    path = tmp_path / "evil.nvblx"
    path.write_bytes(pickle.dumps({"config": Evil(), "state": {}}))
    with pytest.raises(pickle.UnpicklingError, match="system"):
        tmapper.Mapper.from_file(str(path), device="cpu")
    path.write_bytes(pickle.dumps({"config": {"voxel_size_m": 0.1}, "state": {}}))
    with pytest.raises(ValueError, match="MappingConfig"):
        tmapper.read_map_file(str(path))
    buf = io.BytesIO()
    pickle.dump({"config": port_config(jax_mapping_config()), "state": {}}, buf)
    assert isinstance(tmapper._MapUnpickler(io.BytesIO(buf.getvalue())).load()["config"],
                      MappingConfig)


def test_datagen_app_matches_jax(demo, tmp_path, one_map_per_frame):
    """``main`` of both apps, GT validation included: the same items, map
    and outcome; the port prints its per-part timers."""
    for pkg in ("jax", "port"):
        _copy(demo, tmp_path / pkg / "demo_00000")
    argv = ["--task", "cube_stacking", "--demos_datagen", "0", "--feature_type", "rgb",
            "--image_size", "64,64", "--voxel_size_m", "0.02", "--max_num_steps", "6",
            "--save_serialized_nvblox_map_to_disk", "1"]
    jdatagen.main(argv + ["--dataset", str(tmp_path / "jax")])
    timers.reset_timers()
    tdatagen.main(argv + ["--dataset", str(tmp_path / "port"), "--device", "cpu"])
    jdir, tdir = (str(tmp_path / pkg / "demo_00000") for pkg in ("jax", "port"))
    assert_items_close(_items(tdir, 6), _items(jdir, 6))
    assert int(np.load(os.path.join(tdir, "demo_successful.npy"))) == int(
        np.load(os.path.join(jdir, "demo_successful.npy")))
    loaded = tmapper.Mapper.from_file(os.path.join(jdir, "nvblox_map_static.nvblx"),
                                      device="cpu")
    ours = tmapper.Mapper.from_file(os.path.join(tdir, "nvblox_map_static.nvblx"),
                                    device="cpu")
    assert ours.configs == loaded.configs
    ref, out = (state_to_numpy(m.states[MapperId.STATIC]) for m in (loaded, ours))
    for field in ref:
        np.testing.assert_array_equal(out[field], ref[field], err_msg=field)
    assert timers.timer_samples("datagen/integrate")
    with pytest.raises(ValueError, match="--task"):
        tdatagen.main(["--dataset", str(tmp_path), "--device", "cpu"])


def test_add_depth_noise_matches_jax():
    depth = np.random.default_rng(0).uniform(0.2, 2.0, (32, 40)).astype(np.float32)
    out = tconv.add_depth_noise(depth, np.random.default_rng(9))
    ref = jconv.add_depth_noise(depth, np.random.default_rng(9))
    assert out.dtype == ref.dtype == np.float32 and (out == 0).any()
    np.testing.assert_array_equal(out, ref)
    for name in ("convert_rgb_to_model_input", "convert_model_input_to_rgb",
                 "depth_to_uint16", "uint16_to_depth"):
        x = np.random.default_rng(1).uniform(0, 3, (4, 5, 3)).astype(np.float32)
        if name == "convert_rgb_to_model_input":
            x = (x * 80).astype(np.uint8)
        np.testing.assert_array_equal(getattr(tconv, name)(x), getattr(jconv, name)(x))


@pytest.mark.parametrize("max_label", [200, 300])
def test_semantic_items_match_jax_writer(tmp_path, max_label):
    """uint8 labels, or uint16 where an id exceeds 255; the labels map."""
    seg = np.random.default_rng(max_label).integers(0, max_label + 1, (16, 24))
    labels = {0: "background", max_label: "robot_arm"}
    for writer in (DemoWriter(str(tmp_path / "port")), JaxWriter(str(tmp_path / "jax"))):
        writer.write_semantic(3, "wrist", seg)
        writer.write_semantic_labels(labels)
    out = decode_png(str(tmp_path / "port" / "3.wrist_semantic.png"))
    ref = np.asarray(imageio.imread(tmp_path / "jax" / "3.wrist_semantic.png"))
    assert out.dtype == ref.dtype == (np.uint8 if max_label < 256 else np.uint16)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, seg)
    assert ((tmp_path / "port" / "semantic_labels.json").read_text()
            == (tmp_path / "jax" / "semantic_labels.json").read_text())
    with pytest.raises(ValueError, match="label image"):
        DemoWriter(str(tmp_path / "port")).write_semantic(0, "wrist", seg[None])
