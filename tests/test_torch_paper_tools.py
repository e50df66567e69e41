"""Torch port vs the JAX package: the paper-figure, USD and video tools,
dataset comparison, the geometry helpers and the place-grounding probe.

The JAX package writes the inputs: a fused wall map (``tests/test_paper_utils.py``'s
``fused_wall_mapper``, saved with its ``save_map`` and read by the port
through ``Mapper.from_file(..., device="cpu")``), a demo of the reference
layout (``tests/test_data_pipeline.write_arm_demo``: 32x32 RGB, uint16 depth
PNGs), and numpy arrays from a seed. Each tool of both packages then runs on
the same inputs.

Tolerances: the ``paper_utils`` arrays, the ``.usda`` text, the scripts'
PNG pixels, PLY files and the PCA cache equal the JAX package's exactly (the
color mesh from one map equals JAX's bit for bit,
``tests/test_torch_reconstruction.py``), except the surface cloud of
``visualize_nvblox_tensors``: its vertices and features come from
``extract_surface_vertices``, which XLA's CPU dot rounds in another order
(``tests/test_torch_mapping.py``: 1e-5), so its PLY is held to 1e-5 in the
coordinates and one level in the uint8 colors. ``pointcloud_utils``' rotations
to 1e-5 (fp32, an SVD by another library); the turbo table uint8-equal to
matplotlib's.

The probe: ``summarize`` on fixed rows equals JAX's; one probe scene runs on
the CPU (about 5 s) and rebuilds the JAX package's scene, but its release is
not compared: the two policies draw their sampler noise from different
generators.
"""
import glob
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

import imageio.v2 as imageio
import jax.numpy as jnp

from nvblox_mindmap_tpu.data import comparisons as jcmp
from nvblox_mindmap_tpu.geometry import pointcloud_utils as jpc
from nvblox_mindmap_tpu.scripts import place_grounding_probe as jprobe
from nvblox_mindmap_tpu.visualization import paper_utils as jpu
from nvblox_mindmap_tpu.visualization import visualizer as jviz
from nvblox_mindmap_torch.data import comparisons as tcmp
from nvblox_mindmap_torch.data.item_io import decode_png
from nvblox_mindmap_torch.geometry import pointcloud_utils as tpc
from nvblox_mindmap_torch.mapping.mapper import Mapper
from nvblox_mindmap_torch.scripts import place_grounding_probe as tprobe
from nvblox_mindmap_torch.visualization import paper_utils as tpu
from nvblox_mindmap_torch.visualization import visualizer as tviz
from nvblox_mindmap_torch.visualization.turbo_colormap import turbo
from tests.test_data_pipeline import write_arm_demo
from tests.test_paper_utils import fused_wall_mapper
from tests.test_torch_model_parity import one_torch_thread  # noqa: F401 (autouse fixture)

ROTATION_ATOL = 1e-5
SURFACE_ATOL = 1e-5
CUBE_FIXTURE = os.path.join(os.path.dirname(__file__), "test_data", "task_success",
                            "cube_stacking", "last.ckpt")


@pytest.fixture(scope="module")
def wall(tmp_path_factory):
    """The JAX package's fused wall mapper and its map file."""
    mapper, cfg = fused_wall_mapper()
    root = tmp_path_factory.mktemp("wall")
    path = str(root / "0001.nvblox_map_static.nvblx")
    mapper.save_map(path)
    return mapper, path


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """A demo of the reference layout, written by the JAX package's helper."""
    root = tmp_path_factory.mktemp("ds")
    write_arm_demo(str(root / "demo_00000"), seed=0)
    return str(root)


def port_mapper(path):
    return Mapper.from_file(path, device="cpu")


def pixels(path):
    return decode_png(str(path))


def assert_same_pngs(jax_paths, port_paths):
    assert len(jax_paths) == len(port_paths) > 0
    for j, t in zip(jax_paths, port_paths):
        a, b = pixels(j), pixels(t)
        assert a.dtype == b.dtype and np.array_equal(a, b), (j, t)


# --------------------------------------------------------------- paper_utils


def test_pca_specification_and_colors_equal_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(200, 16)).astype(np.float32)
    feats[:10] = 0.0
    jspec, tspec = jpu.get_pca_specification(feats), tpu.get_pca_specification(feats)
    for field in ("projection_matrix", "lower_bound", "upper_bound"):
        assert np.array_equal(getattr(jspec, field), getattr(tspec, field))
    jcol, _ = jpu.colors_from_features(feats, jspec)
    tcol, spec = tpu.colors_from_features(feats, tspec)
    assert spec is tspec and np.array_equal(jcol, tcol)
    with pytest.raises(ValueError):
        tpu.get_pca_specification(np.zeros((5, 4), np.float32))


def test_surface_voxels_cube_mesh_normals_and_usda_equal_jax(wall):
    jmap, path = wall
    tmap = port_mapper(path)
    for j, t in zip(jpu.get_surface_voxels(jmap), tpu.get_surface_voxels(tmap)):
        assert j.dtype == t.dtype and np.array_equal(j, t) and len(t) > 50
    jmesh = jpu.get_feature_cubes_mesh(jmap)
    tmesh = tpu.get_feature_cubes_mesh(tmap)
    for j, t in zip(jmesh[:3], tmesh[:3]):
        assert j.dtype == t.dtype and np.array_equal(j, t)
    vertices, triangles, colors, _ = tmesh
    assert np.array_equal(jpu.compute_vertex_normals(vertices, triangles),
                          tpu.compute_vertex_normals(vertices, triangles))
    text = tpu.usda_from_mesh(vertices, triangles, colors)
    assert text == jpu.usda_from_mesh(vertices, triangles, colors)
    assert text.startswith("#usda 1.0") and 'def Mesh "reconstruction"' in text
    assert tpu.usda_from_mesh(vertices, triangles) == jpu.usda_from_mesh(vertices, triangles)


def test_convert_maps_to_usd_equals_jax(wall, tmp_path):
    _, path = wall
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        for i in range(2):
            shutil.copy(path, tmp_path / side / f"{i:04d}.nvblox_map_static.nvblx")
    jout = jpu.convert_maps_to_usd(str(tmp_path / "jax"))
    tout = tpu.convert_maps_to_usd(str(tmp_path / "port"), device="cpu")
    assert [os.path.basename(p) for p in jout] == [os.path.basename(p) for p in tout]
    for j, t in zip(jout, tout):
        with open(j) as fj, open(t) as ft:
            assert fj.read() == ft.read()
    with pytest.raises(FileNotFoundError):
        tpu.convert_maps_to_usd(str(tmp_path / "port"), pattern="*no_such*", device="cpu")


# --------------------------------------------------------------- geometry


def test_pointcloud_utils_equal_jax():
    rng = np.random.default_rng(1)
    m = rng.normal(size=(5, 3, 3)).astype(np.float32)
    j = np.asarray(jpc.orthonormalize_by_gram_schmidt(jnp.asarray(m)))
    t = tpc.orthonormalize_by_gram_schmidt(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(t, j, atol=ROTATION_ATOL)
    np.testing.assert_allclose(t @ np.swapaxes(t, -1, -2), np.broadcast_to(np.eye(3), t.shape),
                               atol=ROTATION_ATOL)
    p2 = rng.normal(size=(4, 20, 3)).astype(np.float32)
    R = np.asarray([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(4)])
    R[:, :, 0] *= np.sign(np.linalg.det(R))[:, None]  # proper rotations
    p1 = (p2 @ np.swapaxes(R, -1, -2) + 0.5).astype(np.float32)
    c1, c2 = p1.mean(1) + 0.01, p2.mean(1) - 0.02
    for centers in ((None, None), (c1, c2)):
        jargs = [None if c is None else jnp.asarray(c) for c in centers]
        targs = [None if c is None else torch.from_numpy(c) for c in centers]
        j = np.asarray(jpc.rotation_from_svd(jnp.asarray(p1), jnp.asarray(p2), *jargs))
        t = tpc.rotation_from_svd(torch.from_numpy(p1), torch.from_numpy(p2), *targs).numpy()
        np.testing.assert_allclose(t, j, atol=ROTATION_ATOL)
        np.testing.assert_allclose(np.linalg.det(t), 1.0, atol=ROTATION_ATOL)
        if centers[0] is None:  # about the centroids the fit recovers R
            np.testing.assert_allclose(t, R, atol=ROTATION_ATOL)
    bounds = np.asarray([[0.0, -1.0, 0.5], [1.0, 1.0, 2.0]])
    assert np.array_equal(jpc.sample_ghost_points_grid(bounds, 4),
                          tpc.sample_ghost_points_grid(bounds, 4))
    assert np.array_equal(
        jpc.sample_ghost_points_uniform_cube(bounds, 50, np.random.default_rng(3)),
        tpc.sample_ghost_points_uniform_cube(bounds, 50, np.random.default_rng(3)))
    j = jpc.sample_ghost_points_uniform_sphere([0.5, 0.0, 1.0], 0.4, bounds, 64,
                                               np.random.default_rng(4))
    t = tpc.sample_ghost_points_uniform_sphere([0.5, 0.0, 1.0], 0.4, bounds, 64,
                                               np.random.default_rng(4))
    assert t.shape == (64, 3) and np.array_equal(j, t)


# --------------------------------------------------------------- visualizer


def test_tensor_visualizer_pngs_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    values = {"feat": rng.uniform(size=(5, 8, 8)),
              "rgb": rng.uniform(-1, 2, size=(3, 6, 7, 3)),
              "ranged": rng.uniform(10, 20, size=(4, 8, 8, 1))}
    for side, cls in (("jax", jviz.TensorVisualizer), ("port", tviz.TensorVisualizer)):
        viz = cls(output_dir=str(tmp_path / side))
        viz.register_tensor("feat", (5, 8, 8), nrow=2)
        viz.enable()
        viz.set("feat", values["feat"])
        viz.set("rgb", values["rgb"])
        viz.set("ranged", values["ranged"], value_range=(10, 20))
        viz.flush(step=3, prefix="train_")
        viz.disable()
        viz.set("feat", np.zeros((4, 8, 8)))
        viz.flush(step=4)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    assert_same_pngs([tmp_path / "jax" / n for n in names], [tmp_path / "port" / n for n in names])


def test_tensor_visualizer_wandb_is_imported_only_when_asked(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "wandb", None)  # absent
    viz = tviz.TensorVisualizer(output_dir=str(tmp_path))
    viz.enable()
    viz.set("x", np.zeros((1, 4, 4)))
    viz.flush(step=0)
    assert os.path.exists(tmp_path / "x_0.png")
    viz = tviz.TensorVisualizer(output_dir=str(tmp_path), use_wandb=True)
    viz.enable()
    viz.set("x", np.zeros((1, 4, 4)))
    with pytest.raises(ImportError, match="wandb"):
        viz.flush(step=1)


def test_video_writer_frames_equal_jax(tmp_path, caplog):
    """JAX's writer writes these frame PNGs when no mp4 codec is found (as
    here); the port always does, and says so once in its log."""
    rng = np.random.default_rng(0)
    frames = [rng.uniform(-0.2, 1.2, (16, 20, 3)), rng.integers(0, 256, (16, 20, 3),
                                                                dtype=np.uint8),
              rng.uniform(0, 1, (16, 20))]
    jw, tw = jviz.VideoWriter(str(tmp_path / "j" / "out.mp4"), fps=5), \
        tviz.VideoWriter(str(tmp_path / "t" / "out.mp4"), fps=5)
    for f in frames:
        jw.add_frame(f)
        tw.add_frame(f)
    expected = [f.copy() for f in jw.frames]
    jw.close()
    with caplog.at_level("INFO", logger="nvblox_mindmap_torch.visualization"):
        tw.close()
    port = sorted(glob.glob(str(tmp_path / "t" / "out_*.png")))
    assert [os.path.basename(p) for p in port] == [f"out_{i:05d}.png" for i in range(3)]
    for path, frame in zip(port, expected):
        assert np.array_equal(pixels(path), frame)
    jax_frames = sorted(glob.glob(str(tmp_path / "j" / "out_*.png")))
    if not os.path.exists(tmp_path / "j" / "out.mp4"):
        assert_same_pngs(jax_frames, port)
    notes = [r for r in caplog.records if "not an mp4" in r.getMessage()]
    assert len(notes) == 1 and tw.frames == []
    tw.close()  # nothing left: no second note
    assert len([r for r in caplog.records if "not an mp4" in r.getMessage()]) == 1


def test_turbo_table_equals_matplotlib():
    import matplotlib

    rng = np.random.default_rng(0)
    cmap = matplotlib.colormaps["turbo"]
    for x in (rng.uniform(-0.1, 1.1, (40, 50)).astype(np.float32),
              np.linspace(0.0, 1.0, 4097),
              np.asarray([0.0, 1.0, np.nan, np.nextafter(1.0, 0.0), -1e-9, 2.0])):
        want = (cmap(x)[..., :3] * 255).astype(np.uint8)
        got = (turbo(x) * 255).astype(np.uint8)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(turbo(np.linspace(0.0, 1.0, 256)),
                          cmap(np.linspace(0.0, 1.0, 256))[:, :3])


# --------------------------------------------------------------- comparisons


@pytest.mark.parametrize("change", ["none", "npy", "png", "zst", "missing", "other_bytes"])
def test_datasets_are_close_equals_jax(demo, tmp_path, change):
    """Both packages' verdict and mismatch list on a demo against a copy of
    itself with one item changed (or none)."""
    from nvblox_mindmap_torch.data.item_io import pickle_zst

    ref, b = str(tmp_path / "ref"), str(tmp_path / "b")
    for d in (ref, b):
        shutil.copytree(os.path.join(demo, "demo_00000"), d)
        pickle_zst({"vertices": np.zeros((4, 3), np.float16),
                    "features": np.ones((4, 2), np.float16), "channel_length": 2},
                   os.path.join(d, "0.nvblox_vertex_features.zst"))
        with open(os.path.join(d, "notes.txt"), "w") as f:
            f.write("a")
    if change == "npy":
        state = np.load(os.path.join(b, "3.robot_state.npy"))
        np.save(os.path.join(b, "3.robot_state.npy"), state + 0.01)
    elif change == "png":
        img = decode_png(os.path.join(b, "5.wrist_rgb.png"))
        img[0, 0] = (img[0, 0].astype(int) + 128) % 256
        imageio.imwrite(os.path.join(b, "5.wrist_rgb.png"), img)
    elif change == "zst":
        pickle_zst({"vertices": np.zeros((4, 3), np.float16),
                    "features": np.full((4, 2), 1.5, np.float16), "channel_length": 2},
                   os.path.join(b, "0.nvblox_vertex_features.zst"))
    elif change == "missing":
        os.remove(os.path.join(b, "7.wrist_pose.npy"))
    elif change == "other_bytes":
        with open(os.path.join(b, "notes.txt"), "w") as f:
            f.write("b")
    tres = tcmp.datasets_are_close(ref, b)
    assert tres == jcmp.datasets_are_close(ref, b)
    assert tres[0] == (change == "none") and len(tres[1]) == (change != "none")


# --------------------------------------------------------------- scripts


def test_visualize_nvblox_tensors_equals_jax(wall, tmp_path):
    from nvblox_mindmap_tpu.scripts import visualize_nvblox_tensors as jscript
    from nvblox_mindmap_torch.scripts import visualize_nvblox_tensors as tscript

    _, path = wall
    jscript.main(["--map", path, "--output_dir", str(tmp_path / "j"), "--num_slices", "5"])
    tscript.main(["--map", path, "--output_dir", str(tmp_path / "t"), "--num_slices", "5",
                  "--device", "cpu"])
    names = [f"tsdf_slice_{i}.png" for i in range(5)]
    assert_same_pngs([tmp_path / "j" / n for n in names], [tmp_path / "t" / n for n in names])
    jply, tply = ((tmp_path / s / "surface.ply").read_text().splitlines() for s in "jt")
    assert len(jply) == len(tply) > 50
    header = jply.index("end_header") + 1
    assert jply[:header] == tply[:header]
    jrows = np.asarray([r.split() for r in jply[header:]], np.float64)
    trows = np.asarray([r.split() for r in tply[header:]], np.float64)
    np.testing.assert_allclose(trows[:, :3], jrows[:, :3], atol=SURFACE_ATOL)
    np.testing.assert_allclose(trows[:, 3:], jrows[:, 3:], atol=1)


def test_generate_reconstruction_figures_equals_jax(wall, tmp_path):
    from nvblox_mindmap_tpu.scripts import generate_reconstruction_figures as jscript
    from nvblox_mindmap_torch.scripts import generate_reconstruction_figures as tscript

    _, path = wall
    for side, main, extra in (("j", jscript.main, []), ("t", tscript.main, ["--device", "cpu"])):
        main(["--map_path", path, "--output_dir", str(tmp_path / side), "--elev", "50"] + extra)
    names = ["0001_color_mesh.png", "0001_feature_cubes_mesh.png"]
    assert_same_pngs([tmp_path / "j" / n for n in names], [tmp_path / "t" / n for n in names])
    jspec, tspec = np.load(tmp_path / "j" / "pca_params.npz"), np.load(
        tmp_path / "t" / "pca_params.npz")
    assert sorted(jspec.files) == sorted(tspec.files)
    assert all(np.array_equal(jspec[k], tspec[k]) for k in jspec.files)
    color = pixels(tmp_path / "t" / names[0])
    assert color.shape == pixels(tmp_path / "t" / names[1]).shape
    assert (~np.all(color == 255, axis=-1)).sum() > 100
    # A second run reuses the cached basis.
    tscript.main(["--map_path", path, "--output_dir", str(tmp_path / "t"), "--elev", "50",
                  "--device", "cpu"])
    assert_same_pngs([tmp_path / "j" / n for n in names], [tmp_path / "t" / n for n in names])


def test_convert_maps_usd_script_equals_jax(wall, tmp_path):
    from nvblox_mindmap_tpu.scripts import convert_maps_usd as jscript
    from nvblox_mindmap_torch.scripts import convert_maps_usd as tscript

    _, path = wall
    for side in "jt":
        os.makedirs(tmp_path / side)
        shutil.copy(path, tmp_path / side / "0003.nvblox_map_static.nvblx")
    jscript.main(["--input_dir", str(tmp_path / "j")])
    tscript.main(["--input_dir", str(tmp_path / "t"), "--device", "cpu"])
    name = "0003.nvblox_map_static.usda"
    assert (tmp_path / "j" / name).read_text() == (tmp_path / "t" / name).read_text()
    with pytest.raises(ValueError, match="does not exist"):
        tscript.main(["--input_dir", str(tmp_path / "none"), "--device", "cpu"])


@pytest.mark.parametrize("modality", ["rgb", "depth"])
def test_make_mp4_from_dataset_equals_jax(demo, tmp_path, modality):
    from nvblox_mindmap_tpu.scripts import make_mp4_from_dataset as jscript
    from nvblox_mindmap_torch.scripts import make_mp4_from_dataset as tscript

    for side, main in (("j", jscript.main), ("t", tscript.main)):
        main(["--dataset", demo, "--demos", "0", "--modality", modality,
              "--output_dir", str(tmp_path / side), "--fps", "10"])
    jframes = sorted(glob.glob(str(tmp_path / "j" / f"demo_00000_wrist_{modality}_*.png")))
    tframes = sorted(glob.glob(str(tmp_path / "t" / f"demo_00000_wrist_{modality}_*.png")))
    assert len(tframes) == 120
    assert_same_pngs(jframes, tframes)


def test_video_from_depth_equals_jax(tmp_path):
    from nvblox_mindmap_tpu.scripts import video_from_depth as jscript
    from nvblox_mindmap_torch.scripts import video_from_depth as tscript

    src = tmp_path / "depth"
    os.makedirs(src)
    rng = np.random.default_rng(0)
    for i in range(4):
        depth = (1000 + 100 * i + rng.integers(0, 800, (24, 32))).astype(np.uint16)
        depth[4:12, 6:20] = 500
        imageio.imwrite(str(src / f"{i}.wrist_depth.png"), depth)
    np.save(src / "frame_a.npy", np.full((1, 8, 8), np.nan, np.float32))  # not globbed
    for side, main in (("j", jscript.main), ("t", tscript.main)):
        main([str(src), str(tmp_path / side / "depth.mp4"), "--pattern", "*depth.png",
              "--max_depth_m", "1.6"])
    tframes = sorted(glob.glob(str(tmp_path / "t" / "depth_*.png")))
    assert len(tframes) == 4 and pixels(tframes[0]).shape == (24, 32, 3)
    assert_same_pngs(sorted(glob.glob(str(tmp_path / "j" / "depth_*.png"))), tframes)
    # Raw float frames, when no PNG matches.
    npy = tmp_path / "npy"
    os.makedirs(npy)
    for i in range(2):
        np.save(npy / f"frame_{i}.npy", rng.uniform(0.2, 4.0, (1, 10, 12)).astype(np.float32))
    for side, main in (("jn", jscript.main), ("tn", tscript.main)):
        main([str(npy), str(tmp_path / side / "d.mp4")])
    assert_same_pngs(sorted(glob.glob(str(tmp_path / "jn" / "d_*.png"))),
                     sorted(glob.glob(str(tmp_path / "tn" / "d_*.png"))))
    with pytest.raises(ValueError, match="no depth frames"):
        tscript.main([str(tmp_path / "t"), str(tmp_path / "x.mp4"), "--pattern", "*.none"])


def test_visualize_keyposes_equals_jax(demo, tmp_path):
    from nvblox_mindmap_tpu.embodiments.registry import Tasks as JaxTasks
    from nvblox_mindmap_tpu.scripts import visualize_keyposes as jscript
    from nvblox_mindmap_torch.embodiments.registry import Tasks
    from nvblox_mindmap_torch.scripts import visualize_keyposes as tscript

    (j,) = jscript.export_keyposes(demo, "0", JaxTasks("cube_stacking"), str(tmp_path / "j"))
    (t,) = tscript.export_keyposes(demo, "0", Tasks("cube_stacking"), str(tmp_path / "t"))
    with open(j) as fj, open(t) as ft:
        text = ft.read()
        assert text == fj.read()
    # Gray trajectory rows and colored keypose rows.
    assert "153 153 153" in text and re.search(r" (229 25 25|0 204 0)\n", text)
    tscript.main(["--dataset", demo, "--task", "cube_stacking", "--output_dir",
                  str(tmp_path / "m")])
    assert os.path.exists(tmp_path / "m" / "demo_00000_keyposes.ply")


# --------------------------------------------------------------- the probe


@pytest.mark.parametrize("released", [5, 3])
def test_probe_summarize_equals_jax(released):
    rng = np.random.default_rng(released)
    rows = []
    for i in range(6):
        target = rng.uniform(0.3, 0.7, 2)
        pred = None if i >= released else target * 0.2 + rng.normal(0, 0.01, 2) + 0.4
        rows.append({"seed": i, "cube_1_xy": target.tolist(),
                     "release_xy": None if pred is None else pred.tolist(),
                     "release_error_m": None if pred is None
                     else float(np.linalg.norm(pred - target))})
    j, t = jprobe.summarize(rows), tprobe.summarize(rows)
    assert t == j
    assert ("slope_x" in t) == (released >= 4) and t["num_released"] == released
    humanoid = [{"drill_xy": r["cube_1_xy"], "pick_xy": r["release_xy"],
                 "pick_error_m": r["release_error_m"]} for r in rows]
    assert tprobe.summarize(humanoid, "drill_xy", "pick_xy", "pick_error_m") == \
        jprobe.summarize(humanoid, "drill_xy", "pick_xy", "pick_error_m")


def test_probe_scene_runs_on_the_cpu(tmp_path):
    """One scene of the probe through the script's ``main`` on the cube
    fixture (DDPM-100, the flash impl's plain version on the CPU): the scene
    is the JAX package's (same seed, same support cube), the expert hands
    over with the cube held (asserted inside), and the policy's first release
    goal lies in the task's workspace."""
    from nvblox_mindmap_tpu.closed_loop.scripted import make_cube_stacking_env

    out = str(tmp_path / "probe.json")
    tprobe.main(["--checkpoint", CUBE_FIXTURE, "--scenes", "1", "--out", out,
                 "--device", "cpu"])
    with open(out) as f:
        result = json.load(f)
    (row,) = result["rows"]
    env = make_cube_stacking_env(9000, num_cubes=2, cube_half=0.04)
    assert row["seed"] == 9000
    assert row["cube_1_xy"] == np.asarray(env.initial_objects["cube_1"][:2],
                                          np.float64).tolist()
    assert set(row) == {"seed", "cube_1_xy", "release_xy", "release_error_m",
                        "policy_goals_until_release"}
    assert row["release_xy"] is not None and row["policy_goals_until_release"] >= 1
    x, y = row["release_xy"]
    assert 0.2 < x < 0.8 and -0.35 < y < 0.35
    assert result["summary"] == tprobe.summarize(result["rows"])
