"""Torch port vs the JAX package: the simulator bridge, the Isaac Lab
adapter and the humanoid hand.

- The codec: ``encode_message`` gives the same bytes in both packages for a
  message with every tag (arrays of several dtypes and layouts, numpy
  scalars, ``np.bool_``), each package decodes the other's bytes, and both
  refuse the same malformed payloads.
- Episodes across packages: a JAX ``EnvironmentServer`` over a JAX
  ``KinematicEnvironment`` driven by the port's ``RemoteEnvironment``,
  runner and ground-truth policy, and the reverse, give the episode of
  the JAX client on the JAX server (every observed state bit for bit, the
  success, the served world's final state).
- The adapter: the port's and JAX's ``IsaacLabEnvironment``, each over its
  own copy of ``tests/test_isaaclab_adapter.py``'s stand-ins, record equal
  actions (CPU ``(1, 8)`` / ``(1, 37)`` tensors), frames, label maps,
  object poses, success and warning; the config surgery and
  ``compare_states`` (its log included) agree; the port's adapter served
  by the port's bridge answers a JAX client.
- ``HumanoidAction`` / ``HumanoidController`` equal to JAX's, and the 37-d
  round trip exact.
- The port's server survives garbage, malformed requests and ``np.bool_``,
  turns CPU tensors into numpy and refuses a tensor on another device,
  naming the field; ``stop`` releases the port with an idle client.

Every socket has a timeout of a few seconds and every server is stopped in
``finally`` (there is no pytest-timeout here).
"""
import copy
import logging
import pickle
import socket
import struct
import time

import numpy as np
import pytest
import torch

from nvblox_mindmap_tpu.closed_loop import environment as jenv
from nvblox_mindmap_tpu.closed_loop import isaaclab_adapter as jadapter
from nvblox_mindmap_tpu.closed_loop import policies as jpolicies
from nvblox_mindmap_tpu.closed_loop import remote_env as jremote
from nvblox_mindmap_tpu.closed_loop import runner as jrunner
from nvblox_mindmap_tpu.closed_loop.evaluators import BasicEvaluator as JBasicEvaluator
from nvblox_mindmap_tpu.embodiments import humanoid_hand as jhand
from nvblox_mindmap_tpu.embodiments.arm import ArmEmbodiment as JArm
from nvblox_mindmap_tpu.embodiments.base import EmbodimentType as JEmbodimentType
from nvblox_mindmap_tpu.embodiments.humanoid import HumanoidEmbodiment as JHumanoid
from nvblox_mindmap_torch.closed_loop import environment as tenv
from nvblox_mindmap_torch.closed_loop import isaaclab_adapter as tadapter
from nvblox_mindmap_torch.closed_loop import policies as tpolicies
from nvblox_mindmap_torch.closed_loop import remote_env as tremote
from nvblox_mindmap_torch.closed_loop import runner as trunner
from nvblox_mindmap_torch.closed_loop.evaluators import BasicEvaluator as TBasicEvaluator
from nvblox_mindmap_torch.embodiments import humanoid_hand as thand
from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment as TArm
from nvblox_mindmap_torch.embodiments.base import EmbodimentType as TEmbodimentType
from nvblox_mindmap_torch.embodiments.humanoid import HumanoidEmbodiment as THumanoid
from tests import test_isaaclab_adapter as mocks
from tests.test_closed_loop import arm_state

TIMEOUT_S = 5.0


def every_tag_message(rng):
    """A message holding each tag of the codec, numpy scalars and arrays of
    several dtypes, byte orders and layouts."""
    image = rng.uniform(0, 1, (6, 7, 3)).astype(np.float32)
    return {
        "method": "step",
        "kwargs": {"goal": rng.normal(size=8).astype(np.float32)},
        "scalars": [None, True, False, np.bool_(True), np.bool_(False), 3, -2 ** 62,
                    np.int64(7), np.uint8(200), np.int32(-5), 2.5, np.float32(0.1),
                    np.float64(-1e300), float("inf"), "text ünïcode", "", b"raw\x00bytes", b""],
        "tuple": (1, "two", 3.0),
        "arrays": {
            "f4": image,
            "strided": image[::2, 1::3, ::-1],  # made contiguous by the encoder
            "u1": rng.integers(0, 256, (5, 4), dtype=np.uint8),
            "u2": rng.integers(0, 65535, (3, 3), dtype=np.uint16),
            "i8": rng.integers(-10, 10, 9).astype(np.int64),
            "bool": rng.uniform(size=(2, 3)) < 0.5,
            "f8_big_endian": rng.normal(size=4).astype(">f8"),
            "f2": rng.normal(size=(2, 2)).astype(np.float16),
            "scalar": np.asarray(1.5, np.float32),
            "empty": np.zeros((0, 3), np.float32),
        },
        "nested": {"a": [{"b": [None, {"c": np.arange(3)}]}]},
    }


def assert_same(a, b):
    """Equal decoded values: arrays by dtype, shape and bytes."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b


def test_encode_message_gives_the_jax_bytes_and_each_decodes_the_other():
    msg = every_tag_message(np.random.default_rng(0))
    port_bytes = tremote.encode_message(msg)
    assert port_bytes == jremote.encode_message(msg)
    assert_same(tremote.decode_message(port_bytes), jremote.decode_message(port_bytes))
    decoded = tremote.decode_message(port_bytes)
    assert decoded["scalars"][3] is True and decoded["scalars"][7] == 7
    assert decoded["arrays"]["f8_big_endian"].dtype.str == ">f8"
    np.testing.assert_array_equal(decoded["arrays"]["strided"], msg["arrays"]["strided"])
    # Both encode the decoded message to the same bytes again.
    assert tremote.encode_message(decoded) == port_bytes


def _bad_payloads():
    dt = b"|O"
    object_array = (b"a" + struct.pack("!I", len(dt)) + dt + struct.pack("!I", 1)
                    + struct.pack("!I", 1) + struct.pack("!Q", 8) + bytes(8))
    dt = b"<f4"
    huge = (b"a" + struct.pack("!I", len(dt)) + dt + struct.pack("!I", 1)
            + struct.pack("!I", 1) + struct.pack("!Q", (1 << 30) + 1))
    good = tremote.encode_message({"x": np.arange(3)})
    return {
        "pickle": pickle.dumps({"method": "reset"}),
        "object dtype": object_array,
        "too large": huge,
        "truncated": good[:-2],
        "trailing": good + b"N",
        "unknown tag": b"Z",
    }


@pytest.mark.parametrize("name", sorted(_bad_payloads()))
def test_both_codecs_refuse_the_same_payloads(name):
    payload = _bad_payloads()[name]
    for decode in (tremote.decode_message, jremote.decode_message):
        with pytest.raises(ValueError):
            decode(payload)


def test_both_codecs_refuse_the_same_objects():
    for obj in ({"cb": lambda: None}, {1: "int key"}, torch.zeros(2), {"s": {1, 2}}):
        for encode in (tremote.encode_message, jremote.encode_message):
            with pytest.raises(TypeError):
                encode(obj)


# ------------------------------------------------------------------ episodes


def _recording(client_cls):
    class Recording(client_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.observed = []

        def get_policy_state(self):
            state = super().get_policy_state()
            self.observed.append(np.array(state, copy=True))
            return state

    return Recording


SIDES = {
    "port": dict(env=tenv.KinematicEnvironment, arm=TArm, server=tremote.EnvironmentServer,
                 client=_recording(tremote.RemoteEnvironment), policy=tpolicies.GroundTruthPolicy,
                 evaluator=TBasicEvaluator, runner=trunner),
    "jax": dict(env=jenv.KinematicEnvironment, arm=JArm, server=jremote.EnvironmentServer,
                client=_recording(jremote.RemoteEnvironment), policy=jpolicies.GroundTruthPolicy,
                evaluator=JBasicEvaluator, runner=jrunner),
}
WAYPOINTS = [np.asarray([0.25, 0.0, 0.3]), np.asarray([0.25, 0.2, 0.15])]
OBJECTS = {"cube": np.asarray([0.25, 0.2, 0.12])}


def run_bridged_episode(server_side, client_side):
    """One episode of the client side's runner and GT policy against the
    server side's kinematic world through the bridge: (states observed by
    the client, success, the world's final state and objects)."""
    s, c = SIDES[server_side], SIDES[client_side]
    goals = [arm_state(WAYPOINTS[0]), arm_state(WAYPOINTS[1], closed=1.0)]
    world = s["env"](s["arm"](), arm_state([0, 0, 0.3]), WAYPOINTS, max_step_m=0.05,
                     objects=OBJECTS)
    server = s["server"](world, port=0).start()
    try:
        remote = c["client"]("127.0.0.1", server.port, timeout_s=TIMEOUT_S)
        evaluator = c["evaluator"]()
        evaluator.start_demo("demo_0")
        success = c["runner"].run_one_episode(
            remote, c["policy"](np.stack(goals)), c["arm"](), evaluator,
            c["runner"].ClosedLoopConfig(max_num_steps=100))
        remote.close()
        server._thread.join(TIMEOUT_S)  # close() shuts the server down
        assert not server._thread.is_alive()
    finally:
        server.stop()
    return remote.observed, success, world.get_robot_state(), world.get_object_poses()


def test_episodes_across_packages_equal_the_jax_episode():
    reference = run_bridged_episode("jax", "jax")
    assert reference[1] and len(reference[0]) >= 10
    for server_side, client_side in (("jax", "port"), ("port", "jax"), ("port", "port")):
        observed, success, final, objects = run_bridged_episode(server_side, client_side)
        assert success == reference[1]
        assert len(observed) == len(reference[0])
        for a, b in zip(observed, reference[0]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        np.testing.assert_array_equal(final, reference[2])
        assert_same(objects, reference[3])


# ------------------------------------------------------------------ the adapter


class HumanoidGymEnv(mocks.MockGymEnv):
    """The JAX test's stand-in with a 37-d humanoid robot state: both eefs
    follow the commanded poses, the hands the commanded joints."""

    def __init__(self):
        super().__init__()
        self.state = np.zeros(37, np.float32)
        self.state[3] = self.state[21] = 1.0
        self.state[36] = 0.2

    def step(self, action):
        flat = np.asarray(action).reshape(-1)
        self.actions.append(flat.copy())
        hands = flat[15:37]
        self.state[0:7] = flat[0:7]
        self.state[18:25] = flat[7:14]
        self.state[7:18] = hands[jhand.HumanoidJointIndices
                                 .left_joints_in_combined_hands_tensor_indices]
        self.state[25:36] = hands[jhand.HumanoidJointIndices
                                  .right_joints_in_combined_hands_tensor_indices]
        self.state[36] = flat[14]


def make_adapters(humanoid=False, initial_state=None):
    """(stand-in env, adapter) for the port and for JAX, each over its own
    copy of the stand-ins."""
    out = {}
    for side, module, embodiment in (
            ("port", tadapter, THumanoid() if humanoid else TArm()),
            ("jax", jadapter, JHumanoid() if humanoid else JArm())):
        env = HumanoidGymEnv() if humanoid else mocks.MockGymEnv()
        state_fn = (lambda e: e.state.copy()) if humanoid else mocks.robot_state_fn
        out[side] = (env, module.IsaacLabEnvironment(
            env, embodiment, camera_handlers={"pov" if humanoid else "wrist": mocks.MockCamera()},
            robot_state_fn=state_fn, initial_state=copy.deepcopy(initial_state)))
    return out


def drive(adapter, goals):
    """The adapter's whole surface over a few steps; what it returned."""
    adapter.reset()
    seen = {"states": [], "frames": []}
    for goal in goals:
        adapter.step(goal)
        seen["states"].append(adapter.get_policy_state())
        frames = adapter.get_cameras()
        seen["frames"].append({name: {k: getattr(f, k) for k in (
            "rgb", "depth", "intrinsics", "pose7", "segmentation")}
            for name, f in frames.items()})
    seen["labels"] = adapter.semantic_id_to_class
    seen["poses"] = adapter.get_object_poses()
    seen["success"] = adapter.is_success()
    return seen


def humanoid_goals(rng, n=4):
    goals = []
    for _ in range(n):
        g = rng.normal(size=17).astype(np.float32)
        g[3:7] /= np.linalg.norm(g[3:7])
        g[11:15] /= np.linalg.norm(g[11:15])
        g[7], g[15] = rng.uniform(0, 1, 2)
        g[16] = rng.uniform(-4, 4)  # wrapped into [-pi, pi) by HumanoidAction
        goals.append(g)
    return goals


@pytest.mark.parametrize("humanoid", [False, True], ids=["arm", "humanoid"])
def test_adapters_record_equal_actions_frames_and_state(humanoid):
    rng = np.random.default_rng(3)
    if humanoid:
        goals = [None] + humanoid_goals(rng)
    else:
        goals = [None, np.asarray([0.5, 0.0, 0.2, 1, 0, 0, 0, 1.0], np.float32),
                 np.asarray([0.4, 0.1, 0.3, 0, 1, 0, 0, 0.2], np.float32)]
    adapters = make_adapters(humanoid, initial_state={"seed": 0})
    seen = {side: drive(adapter, goals) for side, (_, adapter) in adapters.items()}
    assert_same(seen["port"], seen["jax"])
    (port_env, _), (jax_env, _) = adapters["port"], adapters["jax"]
    width = 37 if humanoid else 8
    assert len(port_env.actions) == len(goals)
    for a, b in zip(port_env.actions, jax_env.actions):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (width,)
    assert port_env.unwrapped.reset_to_calls == jax_env.unwrapped.reset_to_calls


def test_adapter_steps_with_cpu_batch_tensors():
    """The action reaches the env as a CPU (1, n) float32 tensor in both
    packages; the 37-d one round-trips through HumanoidAction exactly."""
    for humanoid, width in ((False, 8), (True, 37)):
        received = {}
        for side, (env, adapter) in make_adapters(humanoid).items():
            env.step = lambda action, side=side: received.setdefault(side, []).append(action)
            goal = humanoid_goals(np.random.default_rng(1), 1)[0] if humanoid else \
                np.asarray([0.5, 0.0, 0.2, 1, 0, 0, 0, 1.0], np.float32)
            adapter.step(goal)
        for side in ("port", "jax"):
            (action,) = received[side]
            assert isinstance(action, torch.Tensor) and action.device.type == "cpu"
            assert action.shape == (1, width) and action.dtype == torch.float32
        assert torch.equal(received["port"][0], received["jax"][0])
        if humanoid:
            flat = received["port"][0][0].numpy()
            back = thand.HumanoidAction.from_tensor(flat).to_tensor(include_head_yaw=True)
            assert back.tobytes() == flat.tobytes()


def test_success_and_the_missing_term_warning_agree(caplog):
    messages = {}
    for side, (env, adapter) in make_adapters().items():
        assert adapter.is_success() is False
        env.unwrapped.termination_manager.value = np.asarray([True])
        assert adapter.is_success() is True
        adapter.success_fn = lambda e: np.bool_(False)
        assert adapter.is_success() is False
        adapter.success_fn = None
        del env.unwrapped.termination_manager
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            assert adapter.is_success() is False
            assert adapter.is_success() is False  # warned once
        messages[side] = [r.getMessage() for r in caplog.records]
    assert len(messages["port"]) == 1 and messages["port"] == messages["jax"]


def _cfg_tree(obj):
    if isinstance(obj, mocks._Ns):
        return {k: _cfg_tree(v) for k, v in vars(obj).items()}
    if isinstance(obj, dict):
        return {k: _cfg_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_cfg_tree(v) for v in obj]
    return obj


@pytest.mark.parametrize("embodiment,absolute,render", [
    ("arm", True, "deterministic"), ("arm", True, "default"), ("arm", False, "high_quality"),
    ("humanoid", True, "default"), ("humanoid", False, "deterministic")])
def test_config_surgery_agrees(embodiment, absolute, render):
    out = {}
    for side, module, types in (("port", tadapter, TEmbodimentType),
                                ("jax", jadapter, JEmbodimentType)):
        kind = types.ARM if embodiment == "arm" else types.HUMANOID
        out[side] = _cfg_tree(module.update_env_cfg_for_perceptive_il(
            mocks._mock_arm_env_cfg(), kind, absolute_mode=absolute, render_settings=render))
    assert out["port"] == out["jax"]


def test_config_surgery_refusals_agree():
    for module, types in ((tadapter, TEmbodimentType), (jadapter, JEmbodimentType)):
        with pytest.raises(AssertionError, match="same offset"):
            module.update_env_cfg_for_perceptive_il(
                mocks._mock_arm_env_cfg(eef_offset=(0.0, 0.0, 0.0)), types.ARM)
        with pytest.raises(ValueError, match="render settings"):
            module.update_env_cfg_for_perceptive_il(mocks._mock_arm_env_cfg(), types.HUMANOID,
                                                    render_settings="fancy")
        with pytest.raises(ImportError):  # the recording camera needs Isaac Lab
            module.update_env_cfg_for_perceptive_il(
                mocks._mock_arm_env_cfg(), types.HUMANOID,
                record_camera_params={"focal_length": 24.0, "position": (0, 0, 1),
                                      "rotation": (1, 0, 0, 0)})


def test_compare_states_agrees_with_its_log():
    rng = np.random.default_rng(5)
    dataset = {
        "articulation": {"robot": {"joint_position": rng.normal(size=(3, 9)),
                                   "grip": rng.normal(size=(3, 1))}},
        "rigid_object": {"cube": {"root_pose": rng.normal(size=(3, 7))},
                         "mug": {"root_pose": rng.normal(size=(3, 7))}},
    }
    for index in range(3):
        runtime = {
            "articulation": {"robot": {
                "joint_position": torch.from_numpy(dataset["articulation"]["robot"][
                    "joint_position"][index] + rng.normal(scale=0.08, size=9)),
                "grip": torch.from_numpy(dataset["articulation"]["robot"]["grip"][index:index + 1]
                                         + 0.2)}},
            "rigid_object": {"cube": {"root_pose": dataset["rigid_object"]["cube"]["root_pose"][
                index][None] + rng.normal(scale=0.08, size=(1, 7))}},
        }
        port = tadapter.compare_states(dataset, runtime, action_index=index)
        assert port == jadapter.compare_states(dataset, runtime, action_index=index)
        assert not port[0] and "Dataset:" in port[1]
    bad = {"articulation": {"robot": {"joint_position": np.zeros(5)}}, "rigid_object": {}}
    for module in (tadapter, jadapter):
        with pytest.raises(ValueError, match="don't match"):
            module.compare_states(dataset, bad, action_index=0)


def test_port_adapter_served_by_the_port_bridge_answers_a_jax_client():
    env, adapter = make_adapters()["port"]
    server = tremote.EnvironmentServer(adapter, port=0).start()
    try:
        remote = jremote.RemoteEnvironment("127.0.0.1", server.port, timeout_s=TIMEOUT_S)
        remote.reset()
        remote.step(np.asarray([0.5, 0.0, 0.2, 1, 0, 0, 0, 1.0], np.float32))
        np.testing.assert_allclose(remote.get_policy_state()[:3], [0.5, 0.0, 0.2], atol=1e-6)
        frame = remote.get_cameras()["wrist"]
        assert frame.segmentation.dtype == np.uint16 and frame.rgb.max() <= 1.0
        assert "robot_arm" in remote.semantic_id_to_class.values()
        assert set(remote.get_object_poses()) == {"cube_1", "cube_2"}
        assert remote.is_success() is False
        remote.close()
    finally:
        server.stop()
    assert isinstance(env.actions[0], np.ndarray) and env.actions[0].shape == (8,)


def test_sim_host_entry_points_raise_off_the_sim_host():
    with pytest.raises(ImportError, match="Isaac Lab"):
        tadapter.make_isaaclab_environment("cube_stacking", "x.hdf5", "demo_0")
    for task in ("cube_stacking", "mug_in_drawer", "drill_in_box", "stick_in_bin"):
        with pytest.raises(ImportError, match="sim-host"):
            tadapter.task_outcome_fn(task)


# ------------------------------------------------------------------ the humanoid hand


def test_humanoid_hand_equals_jax_and_round_trips():
    ji, ti = jhand.HumanoidJointIndices, thand.HumanoidJointIndices
    for name in ("num_joints_per_hand", "hand_joint_name_to_idx_map",
                 "left_hand_name_to_idx_map", "right_hand_name_to_idx_map",
                 "within_hand_joint_name_to_idx_map",
                 "left_joints_in_combined_hands_tensor_indices",
                 "right_joints_in_combined_hands_tensor_indices"):
        assert getattr(ti, name) == getattr(ji, name), name
    assert thand.CLOSED_HAND_JOINT_STATES == jhand.CLOSED_HAND_JOINT_STATES
    assert thand.OPEN_HAND_JOINT_STATES == jhand.OPEN_HAND_JOINT_STATES
    rng = np.random.default_rng(7)
    joints = rng.uniform(-1.6, 0.2, (6, thand.NUM_HAND_JOINTS)).astype(np.float32)
    prox, names = thand.get_tensor_of_proximal_joints(joints)
    jprox, jnames = jhand.get_tensor_of_proximal_joints(joints)
    assert names == jnames and prox.tobytes() == jprox.tobytes()
    for row in prox:
        assert (thand.is_hand_closed_instantaneous_from_proximal_joint_states(row)
                == jhand.is_hand_closed_instantaneous_from_proximal_joint_states(row))
        assert (thand.is_hand_open_instantaneous_from_proximal_joint_states(row)
                == jhand.is_hand_open_instantaneous_from_proximal_joint_states(row))
    tctl, jctl = thand.HumanoidController(), jhand.HumanoidController()
    for state in humanoid_goals(rng, 8):
        action, jaction = tctl(state), jctl(state)
        tensor = action.to_tensor(include_head_yaw=True)
        assert tensor.tobytes() == jaction.to_tensor(include_head_yaw=True).tobytes()
        assert (action.to_tensor(include_head_yaw=False).tobytes()
                == jaction.to_tensor(include_head_yaw=False).tobytes())
        assert -np.pi <= action.head_yaw_rad[0] < np.pi
        back = thand.HumanoidAction.from_tensor(tensor)
        jback = jhand.HumanoidAction.from_tensor(tensor)
        for field in ("W_t_W_LeftEef", "q_wxyz_W_LeftEef", "left_hand_joint_states",
                      "W_t_W_RightEef", "q_wxyz_W_RightEef", "right_hand_joint_states",
                      "head_yaw_rad"):
            assert getattr(back, field).tobytes() == getattr(action, field).tobytes(), field
            assert getattr(back, field).tobytes() == getattr(jback, field).tobytes(), field
        assert back.to_tensor().tobytes() == tensor.tobytes()
    np.testing.assert_array_equal(
        tadapter.humanoid_action_from_policy_state(state),
        jadapter.humanoid_action_from_policy_state(state))
    arm = np.asarray([0.4, 0.1, 0.3, 1, 0, 0, 0, 0.9], np.float32)
    np.testing.assert_array_equal(tadapter.arm_action_from_policy_state(arm),
                                  jadapter.arm_action_from_policy_state(arm))


# ------------------------------------------------------------------ the port's server


class _ArrayEnv(tenv.EnvironmentBase):
    """Answers with np.bool_ success, CPU tensors, or a tensor on the meta
    device (which the server must refuse, naming the field)."""

    def __init__(self):
        self.seg_device = "cpu"

    def reset(self):
        pass

    def step(self, goal):
        pass

    def get_robot_state(self):
        return torch.arange(8, dtype=torch.float32)

    def get_policy_state(self):
        return np.zeros(8, np.float32)

    def get_cameras(self):
        seg = torch.ones((4, 4), dtype=torch.int32, device=self.seg_device)
        return {"cam": tenv.CameraFrame(torch.zeros((4, 4, 3)), np.ones((4, 4), np.float32),
                                        np.eye(3, dtype=np.float32), np.zeros(7, np.float32),
                                        seg)}

    def is_success(self):
        return np.bool_(True)


def _raw_client(port):
    sock = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT_S)
    sock.settimeout(TIMEOUT_S)
    return sock


def test_port_server_survives_bad_requests_and_refuses_card_tensors():
    env = _ArrayEnv()
    server = tremote.EnvironmentServer(env, port=0).start()
    try:
        # A garbage client must not end the server.
        raw = _raw_client(server.port)
        raw.sendall(struct.pack("<q", 12) + b"notamessage!")
        raw.close()
        time.sleep(0.3)
        # Malformed requests get an error reply; the connection stays.
        raw = _raw_client(server.port)
        for request in ([1, 2], "just a string", {"kwargs": {}}, {"method": "fly"}):
            tremote._send_msg(raw, request)
            reply = tremote._recv_msg(raw)
            assert "error" in reply, request
        raw.close()
        time.sleep(0.3)
        client = tremote.RemoteEnvironment("127.0.0.1", server.port, timeout_s=TIMEOUT_S)
        assert client.is_success() is True  # np.bool_ round-trips
        state = client.get_robot_state()  # a CPU tensor arrives as numpy
        assert state.dtype == np.float32 and np.array_equal(state, np.arange(8))
        frame = client.get_cameras()["cam"]
        assert frame.segmentation.dtype == np.int32 and frame.rgb.shape == (4, 4, 3)
        env.seg_device = "meta"
        with pytest.raises(RuntimeError, match="cam.segmentation: a tensor on meta"):
            client.get_cameras()
        assert client.calls == 4 and client.bytes_sent > 0 and client.bytes_received > 0
        # stop() ends the server with this client connected and idle.
        server.stop()
    finally:
        server.stop()
    probe = socket.socket()
    probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    probe.bind(("127.0.0.1", server.port))  # the port is released
    probe.close()


def test_client_refuses_a_goal_on_another_device():
    env = _ArrayEnv()
    server = tremote.EnvironmentServer(env, port=0).start()
    try:
        client = tremote.RemoteEnvironment("127.0.0.1", server.port, timeout_s=TIMEOUT_S)
        client.step(torch.zeros(8))  # a CPU tensor goal is sent as numpy
        with pytest.raises(TypeError, match="goal: a tensor on meta"):
            client.step(torch.zeros(8, device="meta"))
        client.close()
    finally:
        server.stop()
    assert tremote.serve_environment.__defaults__[0] == "127.0.0.1"
