"""Runs with the timed path broken underneath read ``correct`` false: the
harness's look for a chip skipped (the CPU, tiny sizes), the rest of a run
driven as it is."""
import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers import closed_loop
from portbench.tests.conftest import run_tiny


@pytest.mark.parametrize("cell", ["radio_goal", "clip_loop", "radio_loop"])
def test_altered_goal_is_caught(monkeypatch, cell):
    from nvblox_mindmap_torch.closed_loop import policies

    sample = policies.sample_trajectory

    def altered(*args, **kwargs):
        traj, head_yaw, weights = sample(*args, **kwargs)
        return traj + 1e-2, head_yaw, weights

    monkeypatch.setattr(policies, "sample_trajectory", altered)
    assert run_tiny(cell)["correct"] is False


@pytest.mark.parametrize("cell", ["clip_loop", "radio_loop"])
def test_sim_step_that_leaves_the_map_unchanged_is_caught(monkeypatch, cell):
    from nvblox_mindmap_torch.closed_loop import policies

    monkeypatch.setattr(policies.NvbloxDiffuserActorPolicy, "step", lambda self, env: None)
    assert run_tiny(cell)["correct"] is False


@pytest.mark.parametrize("cell", ["radio_goal", "clip_loop", "radio_loop"])
def test_altered_features_are_caught(monkeypatch, cell):
    from nvblox_mindmap_torch.models import pretrained

    make = pretrained.backbone_feature_fn

    def altered(*args, **kwargs):
        fn = make(*args, **kwargs)
        return lambda rgb: fn(rgb) + 200.0  # past every cell's feature and mesh limits

    monkeypatch.setattr(pretrained, "backbone_feature_fn", altered)
    result = run_tiny(cell)
    assert result["correct"] is False
    checks = result["checks"]
    assert checks["features_gap"]["value"] > checks["features_gap"]["limit"]
    assert checks["mesh_gap"]["value"] > checks["mesh_gap"]["limit"]


@pytest.mark.parametrize("cell, caught", [("radio_goal", True), ("radio_loop", True),
                                          ("clip_loop", False)])
def test_one_goal_off_is_caught_where_the_widest_gap_is_compared(cell, caught):
    """One of 13 compared goals 1e-2 off: the median passes it, the widest
    gap (compared in the RADIO cells) does not."""
    goals = list(range(13))
    traj = np.zeros(8)
    program = {"trajs": {g: traj + (1e-2 if g == 5 else 0.0) for g in goals},
               "mesh": None, "features": None}
    reference = {"trajs": {g: traj for g in goals}, "mesh": None, "features": None}
    numbers = closed_loop.gaps(program, reference, goals)
    numbers.update(mesh_gap=0.0, features_gap=0.0)
    limits = harness.read_json(f"{harness.BENCH_DIR}/limits/{cell}.json")
    assert numbers["goal_gap"] == 0.0
    assert harness.passed(harness.judge(numbers, limits)) is not caught


def test_denoiser_step_that_returns_its_state_is_caught(monkeypatch):
    from nvblox_mindmap_torch.ops import schedulers

    monkeypatch.setattr(schedulers.DiffusionSchedule, "step",
                        lambda self, pred, t, sample, **kwargs: sample)
    assert run_tiny("radio_goal")["correct"] is False


def test_train_step_that_leaves_the_parameters_unchanged_is_caught(monkeypatch):
    from nvblox_mindmap_torch.training import optimizer

    monkeypatch.setattr(optimizer.Optimizer, "step", lambda self: True)
    result = run_tiny("radio_train")
    assert result["correct"] is False
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_backbone_that_trains_is_caught(monkeypatch):
    from nvblox_mindmap_torch.training import trainer

    step = trainer.Trainer.train_one_step

    def training_the_backbone(self, *args, **kwargs):
        losses = step(self, *args, **kwargs)
        with torch.no_grad():
            next(self.model.encoder.feature_extractor.parameters()).add_(1e-3)
        return losses

    monkeypatch.setattr(trainer.Trainer, "train_one_step", training_the_backbone)
    result = run_tiny("radio_train")
    assert result["correct"] is False
    assert result["checks"]["backbone_changed"]["value"] > 0


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    from nvblox_mindmap_torch.training import trainer

    loss = trainer.diffusion_train_loss

    def half(model, prepared, noise, timesteps, **kwargs):
        rows = noise.shape[0] // 2
        cut = {k: (v[:rows] if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] ==
                   noise.shape[0] else v) for k, v in prepared.items()}
        return loss(model, cut, noise[:rows], timesteps[:rows], **kwargs)

    monkeypatch.setattr(trainer, "diffusion_train_loss", half)
    assert run_tiny("radio_train")["correct"] is False
