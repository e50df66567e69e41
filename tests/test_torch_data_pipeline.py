"""Torch port vs the JAX package: the on-disk data pipeline.

Each module of the port's pipeline is held to the JAX module on the same
files and seeds: item I/O (the port's numpy + zlib PNG codec and ctypes
libzstd against ``imageio`` and ``zstandard``, both ways), keypose
detection in every mode on arm and humanoid states, the embodiment codecs
and task tables, every transform, ``collate_batch`` + ``unpack_batch``, and
whole epochs of the loader. Demos are written by the JAX package's test
writers (``write_arm_demo``, ``write_humanoid_demo``, through imageio and
zstandard) and by the port's ``DemoWriter``.

Tolerances: everything bit-equal (the same numpy draws in the same order,
the same arithmetic), except ``unpack_batch`` against its JAX counterpart,
held within 1e-6 (float32 back-projection through BLAS, whose blocking may
differ between the two calls).
"""
import os
import pickle

import imageio.v2 as imageio
import numpy as np
import pytest
import zstandard

from nvblox_mindmap_tpu.data import batching as jbatching
from nvblox_mindmap_tpu.data import dataset as jdataset
from nvblox_mindmap_tpu.data import loader as jloader
from nvblox_mindmap_tpu.data import transforms as jtransforms
from nvblox_mindmap_tpu.data.keyposes import KeyposeDetectionMode as JMode
from nvblox_mindmap_tpu.data.vertex_sampling import VertexSamplingMethod as JMethod
from nvblox_mindmap_tpu.embodiments import registry as jregistry
from nvblox_mindmap_torch.data import batching as tbatching
from nvblox_mindmap_torch.data import dataset as tdataset
from nvblox_mindmap_torch.data import item_io
from nvblox_mindmap_torch.data import loader as tloader
from nvblox_mindmap_torch.data import transforms as ttransforms
from nvblox_mindmap_torch.data.keyposes import KeyposeDetectionMode as TMode
from nvblox_mindmap_torch.data.vertex_sampling import VertexSamplingMethod as TMethod
from nvblox_mindmap_torch.data.writer import DemoWriter
from nvblox_mindmap_torch.embodiments import registry as tregistry
from tests.test_data_pipeline import write_arm_demo
from tests.test_humanoid import make_humanoid_robot_states, write_humanoid_demo

ARM_FRAMES = 100  # the grasp closes over frames 40-45 and opens over 80-85
HUMANOID_FRAMES = 160


@pytest.fixture(scope="module")
def arm_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("arm")
    for i in range(3):
        write_arm_demo(str(root / f"demo_0000{i}"), n_frames=ARM_FRAMES, n_vertices=80,
                       seed=i, outcome=0 if i == 2 else 1)
    return str(root)


@pytest.fixture(scope="module")
def humanoid_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("humanoid")
    for i in range(2):
        write_humanoid_demo(str(root / f"demo_0000{i}"), n_frames=HUMANOID_FRAMES, seed=i)
    return str(root)


def assert_same(a, b, path=""):
    """Bit-equal nested batches: the same keys, dtypes, shapes and bytes."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), path
        for k in b:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (tuple, list)) and not all(np.isscalar(x) for x in b):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif b is None or isinstance(b, (int, float, str)):
        assert a == b, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape,
                                                           b.shape)
        assert np.array_equal(a, b, equal_nan=True), path


# ------------------------------------------------------------------ item I/O


def test_item_io_reads_what_imageio_and_zstandard_wrote(arm_dir, humanoid_dir):
    for demo in (os.path.join(arm_dir, "demo_00000"), os.path.join(humanoid_dir, "demo_00001")):
        names = sorted(os.listdir(demo))
        pngs = [n for n in names if n.endswith(".png")][:40]
        assert any("rgb" in n for n in pngs) and any("depth" in n for n in pngs)
        for name in pngs:
            path = os.path.join(demo, name)
            assert_same(item_io.decode_png(path), np.asarray(imageio.imread(path)), name)
        for name in [n for n in names if n.endswith(".zst")][:10]:
            path = os.path.join(demo, name)
            with open(path, "rb") as f:
                raw = zstandard.ZstdDecompressor().stream_reader(f).read()
            with open(path, "rb") as f:
                assert bytes(item_io.zstd_decompress(f.read())) == raw
            assert_same(item_io.load_item(path), jdataset._load_item(path), name)
            assert_same(item_io.unpickle_zst(path), jdataset.unpickle_zst(path), name)


def test_imageio_and_zstandard_read_what_the_port_wrote(tmp_path):
    rng = np.random.default_rng(4)
    smooth = np.cumsum(rng.integers(0, 3, (24, 40, 3)), axis=1).astype(np.uint8)
    images = {"rgb": smooth, "rgba": rng.integers(0, 256, (9, 7, 4), dtype=np.uint8),
              "gray": rng.integers(0, 256, (5, 13), dtype=np.uint8),
              "gray_alpha": rng.integers(0, 256, (6, 5, 2), dtype=np.uint8),
              "depth": rng.integers(0, 65536, (17, 21)).astype(np.uint16)}
    for name, image in images.items():
        path = str(tmp_path / f"{name}.png")
        item_io.encode_png(path, image)
        assert_same(np.asarray(imageio.imread(path)), image, name)
        assert_same(item_io.decode_png(path), image, name)
    obj = {"vertices": rng.normal(size=(50, 3)).astype(np.float16),
           "features": rng.normal(size=(50, 768)).astype(np.float16), "channel_length": 768}
    path = str(tmp_path / "v.zst")
    item_io.pickle_zst(obj, path)
    with open(path, "rb") as f:
        assert_same(pickle.load(zstandard.ZstdDecompressor().stream_reader(f)), obj)
    assert_same(jdataset.unpickle_zst(path), obj)


def test_item_io_refuses_what_it_does_not_read(tmp_path, monkeypatch):
    path = str(tmp_path / "evil.zst")
    with open(path, "wb") as f:
        f.write(zstandard.ZstdCompressor().compress(pickle.dumps(os.system)))
    with pytest.raises(pickle.UnpicklingError, match="numpy arrays and builtin"):
        item_io.unpickle_zst(path)
    png = str(tmp_path / "rgb16.png")
    imageio.imwrite(png, np.zeros((4, 4, 3), np.uint8))
    with open(png, "rb") as f:
        data = bytearray(f.read())
    data[24] = 16  # IHDR bit depth: 16-bit RGB is not read
    with pytest.raises(NotImplementedError, match="bit depth 16"):
        item_io.decode_png_bytes(bytes(data), png)
    with pytest.raises(ValueError, match="not a PNG"):
        item_io.decode_png_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="truncated"):
        item_io.zstd_decompress(zstandard.ZstdCompressor().compress(bytes(1000))[:-4])
    monkeypatch.setattr(item_io, "_ZSTD", None)
    monkeypatch.setattr(item_io, "ZSTD_LIBRARY", "libzstd-missing.so.0")
    monkeypatch.setattr(item_io.ctypes.util, "find_library", lambda name: None)
    with pytest.raises(RuntimeError, match="zstd system library"):
        item_io.zstd_compress(b"x")


def test_jax_reader_reads_the_port_writer(tmp_path):
    """A demo written by the port's DemoWriter loads through the JAX
    package's loader and the port's into the same batches."""
    src = tmp_path / "ref" / "demo_00000"
    write_arm_demo(str(src), n_frames=ARM_FRAMES, n_vertices=40, seed=0)
    writer = DemoWriter(str(tmp_path / "port" / "demo_00000"))
    for i in range(ARM_FRAMES):
        item = lambda name: str(src / f"{i}.{name}")  # noqa: E731
        writer.write_robot_state(i, np.load(item("robot_state.npy")))
        rgb = np.asarray(imageio.imread(item("wrist_rgb.png")))
        depth_m = np.asarray(imageio.imread(item("wrist_depth.png"))) / 1000.0
        writer.write_camera_frame(i, "wrist", rgb, depth_m + 1e-4, np.load(item("wrist_pose.npy")),
                                  np.load(item("wrist_intrinsics.npy")))
        mesh = jdataset.unpickle_zst(item("nvblox_vertex_features.zst"))
        writer.write_vertex_features(i, mesh["vertices"], mesh["features"])
    writer.write_outcome(1)
    for name in os.listdir(src):  # the same items, value for value
        ours = str(tmp_path / "port" / "demo_00000" / name)
        assert_same(item_io.load_item(ours), jdataset._load_item(str(src / name)), name)
    kw = loader_kwargs("rgbd_and_mesh", "arm", "uniform", num_vertices_to_sample=16)
    ref = jloader.get_data_loader_by_data_type(
        **jax_args(kw, jregistry.make_embodiment_for_task(jregistry.Tasks.CUBE_STACKING)),
        dataset_path=str(tmp_path / "port"), demos="0", num_workers=1)[0]
    ours = tloader.get_data_loader_by_data_type(
        **kw, embodiment=tregistry.make_embodiment_for_task("cube_stacking"),
        dataset_path=str(tmp_path / "port"), demos="0", num_workers=1)[0]
    for a, b in zip(ours, ref):
        assert_same(a, b)


# ------------------------------------------------------------------ keyposes, embodiments


@pytest.mark.parametrize("mode", [m.value for m in JMode])
@pytest.mark.parametrize("task", ["cube_stacking", "drill_in_box"])
def test_keyposes_match_jax(arm_dir, task, mode):
    if task == "cube_stacking":
        states = jdataset.DemoDataset.load_robot_states(os.path.join(arm_dir, "demo_00001"))
    else:
        states = make_humanoid_robot_states(HUMANOID_FRAMES)
    jemb = jregistry.make_embodiment_for_task(jregistry.Tasks(task))
    temb = tregistry.make_embodiment_for_task(task)
    for extra in ([], [5], [5, 15]):
        try:
            ref = jemb.extract_keypose_indices(states, extra, JMode(mode))
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                temb.extract_keypose_indices(states, extra, TMode(mode))
            continue
        out = temb.extract_keypose_indices(states, extra, TMode(mode))
        assert_same(out, ref)
        assert out[0] == 0 and out[-1] == len(states) - 1 and len(out) > 2


def test_embodiments_and_task_tables_match_jax(arm_dir):
    arm = jdataset.DemoDataset.load_robot_states(os.path.join(arm_dir, "demo_00000"))
    humanoid = make_humanoid_robot_states(HUMANOID_FRAMES)
    for task in jregistry.Tasks:
        jemb = jregistry.make_embodiment_for_task(task)
        temb = tregistry.make_embodiment_for_task(task.value)
        states = arm if jemb.robot_state_size == 9 else humanoid
        for attr in ("robot_state_size", "policy_state_size", "num_grippers",
                     "predict_head_yaw"):
            assert getattr(temb, attr) == getattr(jemb, attr), attr
        for use_keyposes in (True, False):
            assert_same(temb.policy_states_from_robot_states(states, use_keyposes),
                        jemb.policy_states_from_robot_states(states, use_keyposes))
        assert_same(temb.get_grasp_events(states), jemb.get_grasp_events(states))
        for external in (False, True):
            assert (temb.get_camera_item_names_by_encoding_method(external)
                    == jemb.get_camera_item_names_by_encoding_method(external))
        assert tregistry.task_predicts_head_yaw(task.value) == jregistry.task_predicts_head_yaw(task)
        for table in ("TASK_TO_GYM_ID", "TASK_TO_EXTRA_KEYPOSES_AROUND_GRASP_EVENTS",
                      "TASK_TO_KEYPOSE_DETECTION_MODE", "TASK_TO_EMBODIMENT_TYPE"):
            a, b = getattr(tregistry, table)[task.value], getattr(jregistry, table)[task]
            assert getattr(a, "value", a) == getattr(b, "value", b), table


# ------------------------------------------------------------------ transforms, batching


def test_transforms_match_jax():
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (8, 9, 3)).astype(np.float32)
    depth = rng.integers(0, 3000, (8, 9)).astype(np.float32)
    assert_same(ttransforms.RgbTransformer()(rgb), jtransforms.RgbTransformer()(rgb))
    assert_same(ttransforms.DepthTransformer()(depth), jtransforms.DepthTransformer()(depth))
    for size in (3, 8, 17):
        sample = rng.normal(size=(5, size)).astype(np.float32)
        t, q = rng.normal(size=3), rng.normal(size=4)
        q /= np.linalg.norm(q)
        assert_same(ttransforms.apply_transform_to_sample(sample, t, q),
                    jtransforms.apply_transform_to_sample(sample, t, q))
    ranges = ([-0.1, -0.1, 0.0], [0.1, 0.1, 0.0]), ([0.0, 0.0, -90.0], [0.0, 0.0, 90.0])

    def mesh():
        return {"vertices": rng.normal(size=(40, 3)).astype(np.float32),
                "features": rng.normal(size=(40, 6)).astype(np.float32), "channel_length": 6}

    for seed in range(3):
        states = rng.normal(size=(3, 8)).astype(np.float32)
        m = mesh()
        pairs = [(ttransforms.GeometryAugmentor(*ranges, rng=np.random.default_rng(seed)),
                  jtransforms.GeometryAugmentor(*ranges, rng=np.random.default_rng(seed))),
                 (ttransforms.GeometryNoiser(0.01, 2.0, rng=np.random.default_rng(seed)),
                  jtransforms.GeometryNoiser(0.01, 2.0, rng=np.random.default_rng(seed)))]
        for tt, jt in pairs:
            for _ in range(2):
                tt.reset(), jt.reset()
                assert_same(tt(states.copy()), jt(states.copy()))
                assert_same(tt(dict(m, vertices=m["vertices"].copy())),
                            jt(dict(m, vertices=m["vertices"].copy())))
        for method in JMethod:
            for n in (16, 40, 64):
                if method == JMethod.NONE and n != 40:
                    continue
                tt = ttransforms.VertexSampler(n, TMethod(method.value),
                                               rng=np.random.default_rng(seed))
                jt = jtransforms.VertexSampler(n, method, rng=np.random.default_rng(seed))
                assert_same(tt(dict(m)), jt(dict(m)))


def test_collate_and_unpack_match_jax(arm_dir, humanoid_dir):
    for task, root, demos in (("cube_stacking", arm_dir, "0-1"), ("drill_in_box", humanoid_dir,
                                                                   "0")):
        for data_type in ("mesh", "rgbd", "rgbd_and_mesh"):
            kw = loader_kwargs(data_type, "arm" if task == "cube_stacking" else "humanoid",
                               "none")
            jemb = jregistry.make_embodiment_for_task(jregistry.Tasks(task))
            temb = tregistry.make_embodiment_for_task(task)
            ds = tloader.get_data_loader_by_data_type(
                **kw, embodiment=temb, dataset_path=root, demos=demos, num_workers=1)[0].dataset
            samples = [ds[i] for i in (0, 7, 33, 50)]
            out = tbatching.collate_batch(samples)
            ref = jbatching.collate_batch(samples)
            assert_same(out, ref)
            for threshold in (0.0, 0.86):
                unpacked = tbatching.unpack_batch(temb, out, data_type, False, threshold)
                expected = jbatching.unpack_batch(jemb, ref, data_type, False, threshold)
                assert sorted(unpacked) == sorted(expected)
                for k, v in expected.items():
                    if v is None:
                        assert unpacked[k] is None, k
                        continue
                    assert unpacked[k].dtype == v.dtype and unpacked[k].shape == v.shape, k
                    np.testing.assert_allclose(unpacked[k], v, rtol=0, atol=1e-6, err_msg=k)


# ------------------------------------------------------------------ the loader


def loader_kwargs(data_type, embodiment, weighting, **extra):
    kw = dict(
        batch_size=4,
        use_keyposes=True,
        data_type=data_type,
        only_sample_keyposes=False,
        extra_keyposes_around_grasp_events=[5],
        keypose_detection_mode=("highest_z_between_grasp" if embodiment == "arm"
                                else "highest_z_of_vertical_motion_and_head_turn"),
        include_failed_demos=False,
        sampling_weighting_type=weighting,
        num_history=3,
        prediction_horizon=1,
        num_vertices_to_sample=32,
        vertex_sampling_method="random_without_replacement",
        rgbd_min_depth_threshold=0.1,
        seed=3,
    )
    kw.update(extra)
    return port_args(kw)


def port_args(kw):
    out = dict(kw)
    out["data_type"] = tdataset_type(kw["data_type"])
    out["keypose_detection_mode"] = TMode(kw["keypose_detection_mode"])
    out["sampling_weighting_type"] = tdataset.SamplingWeightingType(kw["sampling_weighting_type"])
    out["vertex_sampling_method"] = TMethod(kw["vertex_sampling_method"])
    return out


def tdataset_type(value):
    from nvblox_mindmap_torch.data.data_types import DataType

    return DataType(getattr(value, "value", value))


def jax_args(kw, embodiment):
    from nvblox_mindmap_tpu.data.data_types import DataType

    out = dict(kw, embodiment=embodiment)
    out["data_type"] = DataType(kw["data_type"].value)
    out["keypose_detection_mode"] = JMode(kw["keypose_detection_mode"].value)
    out["sampling_weighting_type"] = jdataset.SamplingWeightingType(
        kw["sampling_weighting_type"].value)
    out["vertex_sampling_method"] = JMethod(kw["vertex_sampling_method"].value)
    return out


LOADER_CASES = {
    # name: (task, data type, weighting, num_workers, extra loader kwargs)
    "mesh_arm_1worker_uniform": ("cube_stacking", "mesh", "uniform", 1, {}),
    "rgbd_arm_2workers_gripper_change": ("cube_stacking", "rgbd", "gripper_state_change", 2, {}),
    "flagship_arm_2workers_uniform_shard": ("cube_stacking", "rgbd_and_mesh", "uniform", 2,
                                            dict(num_shards=2, shard_index=1)),
    "mesh_arm_2workers_augmented_balanced": (
        "cube_stacking", "mesh", "gripper_state_change", 2,
        dict(balance_demo_groups="0,1", apply_random_transforms=True,
             apply_geometry_noise=True, pos_noise_stddev_m=0.01, rot_noise_stddev_deg=1.0,
             random_translation_range_m=([-0.1, -0.1, 0.0], [0.1, 0.1, 0.0]),
             random_rpy_range_deg=([0.0, 0.0, -90.0], [0.0, 0.0, 90.0]))),
    "mesh_humanoid_1worker_gripper_change": ("drill_in_box", "mesh", "gripper_state_change", 1,
                                             {}),
    "flagship_humanoid_2workers_sequential_shard": (
        "drill_in_box", "rgbd_and_mesh", "none", 2, dict(num_shards=2, shard_index=0,
                                                         drop_last=False)),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_epochs_match_jax(arm_dir, humanoid_dir, case):
    """Two whole epochs (the pool's worker streams are seeded per epoch; the
    sampler's by ``set_epoch``) give the JAX loader's batches bit for bit."""
    task, data_type, weighting, workers, extra = LOADER_CASES[case]
    embodiment = "arm" if task == "cube_stacking" else "humanoid"
    root, demos = (arm_dir, "0-2") if embodiment == "arm" else (humanoid_dir, "0-1")
    kw = loader_kwargs(data_type, embodiment, weighting, **extra)
    ours, our_sampler = tloader.get_data_loader_by_data_type(
        **kw, embodiment=tregistry.make_embodiment_for_task(task), dataset_path=root,
        demos=demos, num_workers=workers)
    ref, ref_sampler = jloader.get_data_loader_by_data_type(
        **jax_args(kw, jregistry.make_embodiment_for_task(jregistry.Tasks(task))),
        dataset_path=root, demos=demos, num_workers=workers)
    assert len(ours) == len(ref) > 0
    for epoch in range(2):
        for sampler in (our_sampler, ref_sampler):
            if sampler is not None:
                sampler.set_epoch(epoch)
        n = 0
        for a, b in zip(ours, ref):
            assert_same(a, b, f"epoch {epoch} batch {n}")
            n += 1
        assert n == len(ref)


def test_loader_without_augmentations_matches_jax(arm_dir):
    kw = loader_kwargs("rgbd_and_mesh", "arm", "uniform")
    kw.pop("only_sample_keyposes")
    jkw = jax_args(kw, jregistry.make_embodiment_for_task(jregistry.Tasks.CUBE_STACKING))
    ours, _ = tloader.get_data_loader_without_augmentations(
        **kw, embodiment=tregistry.make_embodiment_for_task("cube_stacking"),
        dataset_path=arm_dir, demos="0-1", num_workers=2)
    ref, _ = jloader.get_data_loader_without_augmentations(**jkw, dataset_path=arm_dir,
                                                             demos="0-1", num_workers=2)
    assert not ours.drop_last
    for a, b in zip(ours, ref):
        assert_same(a, b)
