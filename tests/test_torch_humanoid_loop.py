"""The GR1T2 humanoid's closed loop on the port's normal path, at a small
size on the CPU: ``portbench``'s ``gr1_drill_loop`` cell (the
``drill_in_box`` model from ``model_config_from_args``,
``NvbloxDiffuserActorPolicy`` with ``HumanoidEmbodiment``, the pov camera
over the head's sweep and both hands reaching) at width 24, 64x64 frames,
6 sweep frames, 4 cm voxels and seeded weights.

- The episode's goals (both hands and the head yaw), its last surface and
  its features match the plain reference's replay
  (``portbench/reference/humanoid_replay.py``).
- The hands, labelled ``robot``, leave no surface in the static map, and do
  when they are not masked.
- ``policy/step/robot_mask`` opens once per camera frame; the mapper's
  counters equal the mesh's own counts.
"""
import json
import time

import numpy as np
import pytest
import torch

from nvblox_mindmap_torch.closed_loop import policies
from nvblox_mindmap_torch.embodiments.humanoid import HumanoidEmbodiment
from nvblox_mindmap_torch.mapping.constants import MapperId
from nvblox_mindmap_torch.models.pretrained import backbone_feature_fn
from nvblox_mindmap_torch.utils import timers
from portbench import harness, scene_humanoid
from portbench.drivers import common, humanoid_loop

SEED = 2**31 + 2022
CELL = "gr1_drill_loop"
FRAMES = 6
STEPS_PER_GOAL = 2
STEPS = 3 * FRAMES // 2  # 9 sim steps, 4 goals, over every sweep frame
VOXEL = 0.04
SIZE = 64
OVERRIDES = {
    "config": {"image_size": SIZE, "num_vertices_to_sample": 64,
               "model": {"embedding_dim": 24, "feature_image_size": [4, 4]},
               "mapping": {"voxel_size_m": VOXEL, "max_feature_pages": 96}},
    "traffic": {"frames": FRAMES, "steps_per_goal": STEPS_PER_GOAL, "noise_bank": 64,
                "warmup_least": 1, "warmup_most": 1, "compare_goals": 3},
}
# The program's and the reference's goals differ by float32 rounding only:
# the program's attention on the CPU is the flash kernels' plain version,
# the reference's the eager product, which sum in other orders (goals apart
# by ~2e-6 at this size); DDIM-10 and the unnormalization carry that to the
# goal unamplified, far under a decimetre-scale or 1e-2 rad error. Map and
# features come from the same float32 arithmetic in the same order: equal.
LIMITS = {"goal_gap": 1e-4, "goal_gap_max": 1e-4, "mesh_gap": 0.0, "features_gap": 0.0}


def spans(trace_path):
    """{name after the prefix: [(start, end)]} of the trace's spans."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith(timers.SPAN_PREFIX):
            out.setdefault(name[len(timers.SPAN_PREFIX):], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


@pytest.fixture(scope="module")
def episode(tmp_path_factory):
    """The cell's set-up (one warm-up cycle), then sim steps and goals under
    the profiler up to ``STEPS``; the mapper's counters and mesh, the
    trace's spans, the model and frames; then the check's numbers."""
    torch.set_num_threads(2)
    run, driver, st, _ = harness.prepare(CELL, SEED, 1.0, False, torch.device("cpu"),
                                         time.perf_counter(), OVERRIDES)
    st.window_goal0 = st.goals
    steps_before = st.steps
    with timers.ProfilerTrace(str(tmp_path_factory.mktemp("trace"))) as trace:
        while st.steps < STEPS:
            driver.cycle_step(st, STEPS_PER_GOAL)
    mapper = st.policy.mapper
    out = {
        "traced_steps": st.steps - steps_before,
        "spans": spans(trace.path),
        "counted": list(st.counted),
        "goals": st.goals,
        "last_mesh": st.last_mesh,
        "surface_vertices": mapper.surface_vertices[MapperId.STATIC],
        "live_pages": mapper.live_pages[MapperId.STATIC],
        "num_pages": int(mapper.states[MapperId.STATIC].num_pages),
        "model": st.model,
        "mapping": st.mapping,
        "frames": st.frames,
        "states": st.states,
        "config": run.config,
    }
    driver.release(run, st)
    out["checks"] = driver.check(run, st)
    return out


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_episode_matches_the_reference_replay(episode, name):
    assert episode["checks"]["goals_compared"] >= 3
    assert episode["checks"][name] <= LIMITS[name]


def hand_vertices(mapper, states) -> int:
    """Static-map surface vertices inside any frame's hand box grown by one
    voxel (a surface vertex lies within a voxel of its surface)."""
    mapper.update_feature_mesh(MapperId.STATIC)
    vertices, _, valid = mapper.get_feature_mesh(MapperId.STATIC)
    v = vertices[valid].numpy()
    inside = np.zeros(len(v), bool)
    for state in states:
        for lo, hi, _, _ in scene_humanoid.hand_boxes(state):
            inside |= np.all((v > np.asarray(lo) - VOXEL) & (v < np.asarray(hi) + VOXEL), axis=1)
    return int(inside.sum())


@pytest.mark.parametrize("masked", [True, False])
def test_hands_stay_out_of_the_static_map(episode, masked):
    """Every sweep frame fused through ``policy.step``: with the hands'
    label the task's dynamic class, no surface vertex lies in any hand box;
    with it renamed (no mask), the hands' faces are in the map."""
    model, frames, states = episode["model"], episode["frames"], episode["states"]
    policy = policies.NvbloxDiffuserActorPolicy(
        model, HumanoidEmbodiment(), episode["mapping"],
        common.workspace(episode["config"]), num_vertices_to_sample=64,
        feature_fn=backbone_feature_fn(model.encoder.feature_extractor, (SIZE, SIZE)),
        device="cpu")
    env = humanoid_loop.Env(frames, states)
    if not masked:
        env.semantic_id_to_class = {**scene_humanoid.LABELS, scene_humanoid.ROBOT: "hand"}
    assert all((f.segmentation == scene_humanoid.ROBOT).any() for f in frames)
    for i in range(len(frames)):
        env.at(i)
        policy.step(env)
    count = hand_vertices(policy.mapper, states)
    assert count == 0 if masked else count > 0


def test_robot_mask_span_opens_once_per_camera_frame(episode):
    found = episode["spans"]
    masks = found["policy/step/robot_mask"]
    assert len(masks) == len(found["policy/step"]) == episode["traced_steps"]
    assert all(any(lo <= a and b <= hi for lo, hi in found["policy/step"]) for a, b in masks)


@pytest.mark.parametrize("counter", ["surface_vertices", "live_pages"])
def test_counters_equal_the_mesh_counts(episode, counter):
    expected = {"surface_vertices": len(episode["last_mesh"][0]),
                "live_pages": episode["num_pages"]}[counter]
    assert episode[counter] == expected > 0
    # One reading a goal, the last goal's equal to the mapper's.
    goal, vertices, pages = episode["counted"][-1]
    assert len(episode["counted"]) == episode["goals"] and goal == episode["goals"] - 1
    assert {"surface_vertices": vertices, "live_pages": pages}[counter] == expected
