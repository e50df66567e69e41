"""3D Diffuser Actor's PerAct policy on the port's prediction path, at a small
size on the CPU: ``portbench``'s ``peract_goal_ddpm100`` cell (the model
from ``ModelArgs`` and ``model_config_from_args`` with ``rgbd`` over the CLIP
ResNet-50 FPN, four cameras, a (1, 53, 512) instruction, xyzw quaternions;
goals through the open-loop app's ``make_infer_fn`` with stochastic DDPM)
at 64x64 images and 8x8 features (256 context tokens, FPS to 51), 5
diffusion timesteps, 4 keyframes and seeded weights.

- The goals and the extractor's features match the plain reference's replay
  (``portbench/reference/predict_replay.py``), and so does the encoder's
  every output on one goal's batch.
- ``encoder/language`` opens once per goal inside ``model/encode``; the
  encoder's counters read the context and the FPS token counts.
"""
import json
import time

import numpy as np
import pytest
import torch

from nvblox_mindmap_torch.models.diffuser_actor import prepare_inputs
from nvblox_mindmap_torch.utils import timers
from portbench import harness
from portbench.drivers import common, predict

SEED = 2**31 + 2026
CELL = "peract_goal_ddpm100"
SIZE, FEATURES, CAMERAS, TOKENS = 64, 8, 4, 53
CONTEXT = CAMERAS * FEATURES * FEATURES  # 256
KEPT = CONTEXT // 5  # 51
TRACED_GOALS = 2
OVERRIDES = {
    "config": {"image_size": SIZE,
               "model": {"feature_image_size": [FEATURES, FEATURES], "diffusion_timesteps": 5}},
    "traffic": {"frames": 4, "instructions": 3, "warmup_least": 1, "warmup_most": 1,
                "compare_goals": 3},
}
# The program's and the reference's goals differ by float32 rounding only:
# the program's attention on the CPU is the flash kernels' plain version,
# the reference's the eager product, which sum in other orders (~1e-7 on
# the goal at this size); five DDPM steps carry that to the goal without
# amplifying it, far under a centimetre or 1e-3 of a unit quaternion. The
# extractor is the same IEEE float32 arithmetic in the same order: equal.
LIMITS = {"goal_gap": 1e-5, "goal_gap_max": 1e-5, "features_gap": 0.0}
# Encoder outputs of O(1) magnitude after sums of 120 products and softmaxes
# over 53 or 256 keys, summed in other orders on the two sides: 1e-5.
ENCODER_ATOL = 1e-5


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
def cell(tmp_path_factory):
    """The cell's set-up (one warm-up goal), then goals under the profiler;
    the trace's spans, the model and the inputs; then the check's numbers."""
    torch.set_num_threads(2)
    run, driver, st, _ = harness.prepare(CELL, SEED, 1.0, False, torch.device("cpu"),
                                         time.perf_counter(), OVERRIDES)
    st.window_goal0 = st.goals
    with timers.ProfilerTrace(str(tmp_path_factory.mktemp("trace"))) as trace:
        for _ in range(TRACED_GOALS):
            driver.goal(run, st)
    out = {"spans": spans(trace.path), "counted": list(st.counted), "model": st.model,
           "frames": st.frames, "instructions": st.instructions, "config": run.config,
           "run": run}
    driver.window(run, st)  # the harness's window: at least two more goals
    driver.release(run, st)
    out["checks"] = driver.check(run, st)
    out["goals"] = st.goals
    return out


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_goals_match_the_reference_replay(cell, name):
    assert cell["checks"]["goals_compared"] >= 3
    assert cell["checks"][name] <= LIMITS[name]


ENCODER_OUTPUTS = ("context_feats", "context", "context_mask", "instr_feats",
                   "adaln_gripper_feats", "fps_feats", "fps_pos", "fps_mask")


@pytest.fixture(scope="module")
def encoded(cell):
    """The program's and the reference's encoder outputs on goal 1's batch."""
    from portbench.reference.models import diffuser_actor as ref

    config, frames = cell["config"], cell["frames"]
    batch = dict(frames[1], instruction=cell["instructions"][1])
    bounds = common.workspace(config)
    with torch.no_grad():
        model = cell["model"]
        program = model.encode_prepared(prepare_inputs(batch, bounds, model.config,
                                                       device="cpu"))
        reference_model = common.build_model(ref.DiffuserActor, ref.DiffuserActorConfig, config,
                                             SEED, torch.device("cpu"))
        reference = reference_model.encode_prepared(
            ref.prepare_inputs(batch, bounds, reference_model.config, device="cpu"))
    return program, reference


@pytest.mark.parametrize("name", ENCODER_OUTPUTS)
def test_encoder_matches_the_reference(encoded, name):
    program, reference = encoded
    assert program[name].shape == reference[name].shape
    if program[name].dtype == torch.bool:
        assert torch.equal(program[name], reference[name])
    else:
        torch.testing.assert_close(program[name], reference[name], rtol=0, atol=ENCODER_ATOL)


def test_encoder_shapes_are_the_configuration_s(encoded):
    program, _ = encoded
    assert program["context_feats"].shape == (1, CONTEXT, 120)
    assert program["instr_feats"].shape == (1, TOKENS, 120)
    assert program["fps_feats"].shape == (1, KEPT, 120)
    assert bool(program["context_mask"].any()) and not bool(program["context_mask"].all())


def test_the_model_is_the_app_s(cell):
    cfg = cell["model"].config
    assert (cfg.data_type, cfg.feature_type.value, cfg.use_instruction, cfg.lang_enhanced,
            cfg.quaternion_format, cfg.diffusion_timesteps) == (
        "rgbd", "clip_resnet50_fpn", True, False, "xyzw", 5)
    assert not hasattr(cell["model"].encoder, "reconstruction_encoder")


def test_language_span_opens_once_per_goal_inside_the_encoding(cell):
    found = cell["spans"]
    language, encode = found["encoder/language"], found["model/encode"]
    assert len(language) == len(encode) == TRACED_GOALS
    assert all(any(lo <= a and b <= hi for lo, hi in encode) for a, b in language)
    # The image tokens' backbone runs before the language layers, FPS after.
    for (a, _), (b, _), (c, _) in zip(found["encoder/backbone"], language, found["encoder/fps"]):
        assert a < b < c


@pytest.mark.parametrize("counter,value", [("context_tokens", CONTEXT), ("fps_kept", KEPT)])
def test_counters_read_the_token_counts(cell, counter, value):
    i = predict.COUNTERS.index(counter)
    assert [c[i] for c in cell["counted"]] == [value] * len(cell["counted"])
    assert cell["run"].counters[counter] == [value] * len(cell["run"].counters[counter])
    reader = harness.load_metric(f"{counter}.goal")
    assert reader.read(cell["run"]) == float(value)


def test_goals_read_each_keyframe_and_instruction_in_turn(cell):
    frames, instructions = cell["frames"], cell["instructions"]
    assert len(frames) == 4 and len(instructions) == 3
    frame = frames[0]
    assert frame["rgbs"].shape == (1, CAMERAS, SIZE, SIZE, 3) and frame["rgbs"].dtype == np.uint8
    assert frame["pcds"].shape == (1, CAMERAS, SIZE, SIZE, 3)
    assert frame["pcds"].dtype == np.float32
    quat = frame["gripper_history"][..., 3:7]
    assert frame["gripper_history"].shape == (1, 3, 1, 8)
    np.testing.assert_allclose(np.linalg.norm(quat, axis=-1), 1.0, rtol=1e-6)
    assert instructions[0].shape == (1, TOKENS, 512)
    assert not np.array_equal(frames[0]["rgbs"], frames[1]["rgbs"])
    assert cell["goals"] >= 1 + TRACED_GOALS + 2
