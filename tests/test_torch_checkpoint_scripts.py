"""Torch port vs the JAX package: the checkpoint tools, the FPN extractor
script and the image-feature precompute script.

Each script reads both packages' checkpoints, and what it writes is what the
JAX package's counterpart writes (or reads): ``checkpoint_tools extract``
the same flax msgpack bytes, which JAX's ``load_subtree`` reads;
``extract_fpn_from_model`` the same npz, which JAX's ``load_backbone_npz``
reads and whose FPN, served through ``make_feature_fn``, gives the trained
extractor's features; ``extract_image_features`` the same fp16 files for
``--feature_type rgb`` (the one extractor without random parameters).

Tolerances: bytes and arrays equal, except the rgb feature files: atol
1e-3 (fp16 of bilinear resizes that sum their weights in another order).
"""
import glob
import os

import numpy as np
import pytest
import torch

import jax

from nvblox_mindmap_tpu.models import pretrained as jpre
from nvblox_mindmap_tpu.scripts import checkpoint_tools as jtools
from nvblox_mindmap_tpu.scripts import extract_fpn_from_model as jfpn
from nvblox_mindmap_tpu.scripts import extract_image_features as jfeatures
from nvblox_mindmap_tpu.training.checkpoint import save_checkpoint_file as jax_save
from nvblox_mindmap_torch.data.writer import DemoWriter
from nvblox_mindmap_torch.models import pretrained as tpre
from nvblox_mindmap_torch.models.diffuser_actor import DiffuserActor, DiffuserActorConfig
from nvblox_mindmap_torch.models.weight_conversion import load_variables_npz
from nvblox_mindmap_torch.models.weights import flax_to_state_dict, state_dict_to_flax
from nvblox_mindmap_torch.scripts import checkpoint_tools as ttools
from nvblox_mindmap_torch.scripts import extract_fpn_from_model as tfpn
from nvblox_mindmap_torch.scripts import extract_image_features as tfeatures
from nvblox_mindmap_torch.training.checkpoint import read_jax_checkpoint, save_checkpoint_file
from tests.test_torch_fixture_parity import DATA
from tests.test_torch_model_parity import one_torch_thread  # noqa: F401 (autouse fixture)

JAX_CKPT = os.path.join(DATA, "task_success/cube_stacking/last.ckpt")


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def assert_trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y)), path


@pytest.fixture(scope="module")
def clip_ckpts(tmp_path_factory):
    """A small rgbd_and_mesh CLIP policy (random weights, seed 0) saved by
    each package: (port best.ckpt, JAX-format .ckpt, the model)."""
    root = tmp_path_factory.mktemp("clip_ckpts")
    cfg = DiffuserActorConfig(data_type="rgbd_and_mesh", feature_type="clip_resnet50_fpn",
                              feature_image_size=(4, 4), embedding_dim=24, num_attn_heads=4,
                              vertex_feature_dim=8)
    torch.manual_seed(0)
    model = DiffuserActor(cfg, device="cpu")
    with torch.no_grad():  # a trained-looking FPN: biases away from zero
        for p in model.encoder.feature_extractor.fpn.parameters():
            p.add_(0.01 * torch.randn_like(p))
    port = str(root / "best.ckpt")
    save_checkpoint_file(port, model.state_dict(), {}, 12, 0.25)
    jax_path = str(root / "jax_best.ckpt")
    jax_save(jax_path, state_dict_to_flax(model.state_dict()), None, 12, 0.25)
    return port, jax_path, model


@pytest.mark.parametrize("fields", [
    dict(data_type="mesh", use_instruction=True, lang_enhanced=True),
    dict(data_type="rgbd_and_mesh", feature_type="radio_v25_b", feature_image_size=(2, 2)),
    dict(data_type="rgbd", feature_type="dino_v2_vits14", feature_image_size=(2, 2)),
    dict(data_type="rgbd_and_mesh", feature_type="clip_resnet50_fpn", feature_image_size=(4, 4)),
], ids=["language", "radio", "dino", "clip"])
def test_state_dict_to_flax_inverts_the_bridge(fields):
    """The port's parameters as the flax tree (what the scripts write for a
    port checkpoint) go back through the bridge to the same tensors, and
    load strictly: every layer kind (Dense, Conv, LayerNorm, the ViT's
    DenseGeneral kernels and LayerScale lists, CLIP's BatchNorm)."""
    cfg = DiffuserActorConfig(embedding_dim=24, num_attn_heads=4, vertex_feature_dim=8,
                              **fields)
    torch.manual_seed(0)
    model = DiffuserActor(cfg, device="cpu")
    state = model.state_dict()
    back = flax_to_state_dict(state_dict_to_flax(state))
    assert sorted(back) == sorted(state)
    for name, value in state.items():
        assert torch.equal(back[name], value), name


def test_checkpoint_info_reads_both_packages(clip_ckpts, capsys):
    port, jax_path, _ = clip_ckpts
    assert ttools.print_checkpoint_info(JAX_CKPT) == jtools.print_checkpoint_info(JAX_CKPT)
    assert ttools.print_checkpoint_info(port) == (12, 0.25)
    assert f"{port}: iter=12 best_loss=0.25" in capsys.readouterr().out


def test_extract_subtree_both_ways(clip_ckpts, tmp_path):
    """From the JAX fixture: the port writes flax's bytes and each package
    reads the other's file. From the port's checkpoint: JAX's reader takes
    the subtree, equal to the model's weights through the bridge."""
    subtree = "encoder/gripper_context_head/attn_0"
    ours, theirs = str(tmp_path / "ours.msgpack"), str(tmp_path / "theirs.msgpack")
    ttools.main(["extract", JAX_CKPT, subtree, ours])
    jtools.main(["extract", JAX_CKPT, subtree, theirs])
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    want = read_jax_checkpoint(JAX_CKPT)[0]["encoder"]["gripper_context_head"]["attn_0"]
    assert_trees_equal(jtools.load_subtree(ours), want)
    assert_trees_equal(ttools.load_subtree(theirs), want)

    port, _, model = clip_ckpts
    ttools.main(["extract", port, "encoder/feature_extractor/fpn", ours])
    fpn = state_dict_to_flax(model.state_dict())["encoder"]["feature_extractor"]["fpn"]
    assert_trees_equal(jtools.load_subtree(ours), fpn)
    with pytest.raises(KeyError, match="feature_extractor not in"):
        ttools.extract_subtree(JAX_CKPT, "encoder/feature_extractor/fpn", ours)


def test_extract_fpn_from_model_both_ways(clip_ckpts, tmp_path):
    """JAX's script and the port's on the JAX-format checkpoint, and the
    port's on its own ``best.ckpt``: one npz (params/fpn + params/backbone).
    It feeds ``make_feature_fn`` of both packages, and the port's gives the
    trained model's own extractor's features."""
    port, jax_path, model = clip_ckpts
    paths = {k: str(tmp_path / f"{k}.npz") for k in ("jax", "port_from_jax", "port")}
    jfpn.main(["--model_path", jax_path, "--output_path", paths["jax"]])
    tfpn.main(["--model_path", jax_path, "--output_path", paths["port_from_jax"]])
    tfpn.extract_fpn_weights(port, paths["port"])
    want = load_variables_npz(paths["jax"])
    assert sorted(want["params"]) == ["backbone", "fpn"]
    for key in ("port_from_jax", "port"):
        assert_trees_equal(load_variables_npz(paths[key]), want)
    assert_trees_equal(jpre.load_backbone_npz(paths["port"]), want)

    frame = np.random.default_rng(3).uniform(size=(40, 40, 3)).astype(np.float32)
    feature_fn = tpre.make_feature_fn("clip_resnet50_fpn", (4, 4), paths["port"], (4, 4),
                                      device="cpu")
    with torch.no_grad():
        expected = model.encoder.feature_extractor(torch.from_numpy(frame)[None])[0]
    torch.testing.assert_close(feature_fn(frame), expected, atol=0, rtol=0)
    ref = jpre.make_feature_fn("clip_resnet50_fpn", (4, 4), paths["port"], (4, 4))(frame)
    np.testing.assert_allclose(feature_fn(frame).numpy(), np.asarray(ref), atol=1e-4, rtol=0)

    with pytest.raises(KeyError, match="no encoder/feature_extractor/fpn subtree"):
        tfpn.extract_fpn_weights(JAX_CKPT, str(tmp_path / "none.npz"))


def write_rgb_demos(root, n_demos=2, frames=3, size=20):
    rng = np.random.default_rng(5)
    K = np.asarray([[20.0, 0, 10], [0, 20.0, 10], [0, 0, 1]], np.float32)
    for d in range(n_demos):
        writer = DemoWriter(os.path.join(root, f"demo_{d:05d}"))
        for i in range(frames):
            writer.write_camera_frame(i, "wrist", rng.integers(0, 256, (size, size, 3),
                                                               dtype=np.uint8),
                                      np.full((size, size), 0.8), np.asarray(
                                          [0, 0, 1, 1, 0, 0, 0]), K)


def feature_files(root):
    return {os.path.relpath(p, root): np.load(p)
            for p in sorted(glob.glob(os.path.join(root, "*", "*_features.npy")))}


def test_extract_image_features_matches_jax(tmp_path):
    root = str(tmp_path / "demos")
    write_rgb_demos(root)
    args = ["--dataset", root, "--demos", "0-1", "--feature_type", "rgb",
            "--feature_image_size", "8", "--batch_size", "2"]
    jfeatures.main(args)
    ref = feature_files(root)
    for path in ref:
        os.remove(os.path.join(root, path))
    tfeatures.main(args + ["--device", "cpu"])
    out = feature_files(root)
    assert sorted(out) == sorted(ref) and len(out) == 6
    for path, value in out.items():
        assert value.dtype == np.float16 and value.shape == (8, 8, 3)
        np.testing.assert_allclose(value.astype(np.float32), ref[path].astype(np.float32),
                                   atol=1e-3, rtol=0, err_msg=path)
    tfeatures.main(["--dataset", root, "--demos", "0", "--feature_type", "clip_resnet50_fpn",
                    "--feature_image_size", "4", "--device", "cpu"])
    clip = feature_files(root)["demo_00000/0.wrist_features.npy"]
    assert clip.dtype == np.float16 and clip.shape == (4, 4, 120) and np.isfinite(clip).all()
