"""Demo dataset reader (host-side, numpy) for the recorded Isaac Lab format.

The port's own copy of ``nvblox_mindmap_tpu/data/dataset.py``, its items
read by ``data/item_io.py``. It reads upstream's on-disk demo layout
(``mindmap/data_loading/dataset.py``):

    <dataset>/demo_00000/
        <idx>.<cam>_rgb.png          uint8 HWC
        <idx>.<cam>_depth.png        uint16 millimeters
        <idx>.<cam>_pose.npy         (7,) pos + quat
        <idx>.<cam>_intrinsics.npy   (3, 3)
        <idx>.robot_state.npy        embodiment robot state
        <idx>.nvblox_vertex_features.zst   zstd-pickled
            {"vertices": f16 (N, 3), "features": f16 (N, C), "channel_length"}
        demo_successful.npy          DemoOutcome int

Keypose indices are extracted at load time by the embodiment's estimator;
history/future windows edge-pad (first index repeats backwards, last repeats
forwards). Gripper-state-change weighted sampling and global-index routing
follow upstream.
"""
from __future__ import annotations

import enum
import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nvblox_mindmap_torch.data.item_names import (
    GT_POLICY_STATE_PRED_ITEM_NAME,
    IS_KEYPOSE_ITEM_NAME,
    NVBLOX_VERTEX_FEATURES_ITEM_NAME,
    POLICY_STATE_HISTORY_ITEM_NAME,
)
from nvblox_mindmap_torch.data.item_io import load_item, pickle_zst, unpickle_zst  # noqa: F401
from nvblox_mindmap_torch.data.keyposes import KeyposeDetectionMode
from nvblox_mindmap_torch.embodiments.base import EmbodimentBase

DEMO_PATH_NUM_DIGITS = 5


class DemoOutcome(enum.Enum):
    SUCCESS = 1
    FAILED_DATAGEN = 0
    FAILED_GT_EVAL = -1


class SamplingWeightingType(str, enum.Enum):
    NONE = "none"
    UNIFORM = "uniform"
    GRIPPER_STATE_CHANGE = "gripper_state_change"


def get_indices_from_range_str(multi_range_str: str) -> List[int]:
    """Parse "0-5 7 9-11" -> [0,1,2,3,4,5,7,9,10,11]."""
    indices: List[int] = []
    for range_str in str(multi_range_str).split(" "):
        if "-" in range_str:
            start, end = map(int, range_str.split("-"))
            assert start <= end
            indices.extend(range(start, end + 1))
        else:
            indices.append(int(range_str))
    return sorted(indices)


def get_demo_name(demo_index: int, num_digits: Optional[int] = None) -> str:
    if num_digits is None:
        return f"demo_{demo_index}"
    return f"demo_{str(demo_index).zfill(num_digits)}"


def get_demo_paths(dataset_path: str, demos: str) -> List[str]:
    return sorted(
        os.path.join(dataset_path, get_demo_name(i, DEMO_PATH_NUM_DIGITS))
        for i in get_indices_from_range_str(demos)
    )


class DemoDataset:
    """File-per-item dataset over one or more demo directories."""

    def __init__(
        self,
        dataset_path: str,
        demos: str,
        embodiment: EmbodimentBase,
        item_names: Sequence[str],
        transforms: Optional[Dict[str, list]] = None,
        only_sample_keyposes: bool = False,
        include_failed_demos: bool = False,
        num_history: int = 3,
        prediction_horizon: int = 1,
        use_keyposes: bool = True,
        extra_keyposes_around_grasp_events: Sequence[int] = (),
        keypose_detection_mode: KeyposeDetectionMode = KeyposeDetectionMode.NONE,
    ):
        self.item_names = list(item_names)
        self.transforms = transforms or {}
        self.only_sample_keyposes = only_sample_keyposes
        self.num_history = num_history
        self.prediction_horizon = prediction_horizon
        self.use_keyposes = use_keyposes
        self.embodiment = embodiment
        self.excluded_datasets = 0
        self.demo_info: Dict[str, Dict] = {}
        # Stateful transforms (GeometryAugmentor/Noiser/VertexSampler) share
        # numpy Generators, which are NOT thread-safe; any path using
        # ``self.transforms`` (plain __getitem__) is serialized. Parallel
        # fetch goes through ``getitem_with_transforms`` with per-worker
        # transform clones (see DataLoader._worker_transforms).
        import threading

        self._getitem_lock = threading.Lock()

        for demo_path in get_demo_paths(dataset_path, demos):
            assert os.path.exists(demo_path), f"Missing demo dir: {demo_path}"
            if not include_failed_demos and not self.is_demo_successful(demo_path):
                self.excluded_datasets += 1
                continue

            robot_states = self.load_robot_states(demo_path)
            keypose_indices = embodiment.extract_keypose_indices(
                robot_states, extra_keyposes_around_grasp_events, keypose_detection_mode
            )
            policy_states = embodiment.policy_states_from_robot_states(
                robot_states, use_keyposes
            )
            if only_sample_keyposes:
                policy_states = policy_states[keypose_indices]

            info = {
                "policy_states": policy_states,
                "keypose_indices": np.asarray(keypose_indices),
                "num_samples": len(policy_states),
            }
            for item_name in self.item_names:
                if item_name.startswith("runtime_"):
                    continue
                paths = glob.glob(os.path.join(demo_path, "*." + item_name))
                assert paths, f"No samples of {item_name} in {demo_path}"
                paths = sorted(
                    paths, key=lambda p: int(os.path.basename(p).split(".")[0])
                )
                if only_sample_keyposes:
                    is_keypose = np.zeros(len(paths), dtype=bool)
                    is_keypose[info["keypose_indices"]] = True
                    paths = [p for p, k in zip(paths, is_keypose) if k]
                assert len(paths) == info["num_samples"], (
                    f"{item_name}: {len(paths)} != {info['num_samples']}"
                )
                info[item_name] = paths
            self.demo_info[demo_path] = info

        self.demo_paths = list(self.demo_info.keys())
        self._cum_sizes = np.cumsum(
            [self.demo_info[p]["num_samples"] for p in self.demo_paths]
        )
        self.total_number_of_samples = int(self._cum_sizes[-1]) if len(
            self._cum_sizes
        ) else 0

    # --- demo loading --------------------------------------------------------
    @staticmethod
    def is_demo_successful(demo_path: str) -> bool:
        outcome = DemoOutcome(int(np.load(os.path.join(demo_path, "demo_successful.npy"))))
        return outcome == DemoOutcome.SUCCESS

    @staticmethod
    def load_robot_states(demo_path: str) -> np.ndarray:
        files = sorted(
            glob.glob(os.path.join(demo_path, "*.robot_state.npy")),
            key=lambda p: int(os.path.basename(p).split(".")[0]),
        )
        if not files:
            # Legacy naming.
            files = sorted(
                glob.glob(os.path.join(demo_path, "*.gripper_state.npy")),
                key=lambda p: int(os.path.basename(p).split(".")[0]),
            )
        assert files, f"No robot states in {demo_path}"
        return np.stack([np.load(p, allow_pickle=True) for p in files]).astype(
            np.float32
        )

    # --- index routing -------------------------------------------------------
    def __len__(self) -> int:
        return self.total_number_of_samples

    def locate(self, global_idx: int) -> Tuple[str, int]:
        """Global index -> (demo path, sample index within demo)."""
        assert 0 <= global_idx < self.total_number_of_samples
        demo_idx = int(np.searchsorted(self._cum_sizes, global_idx, side="right"))
        start = 0 if demo_idx == 0 else int(self._cum_sizes[demo_idx - 1])
        return self.demo_paths[demo_idx], global_idx - start

    # --- history / future windows -------------------------------------------
    def get_policy_state_history(
        self, sample_idx: int, candidate_indices: np.ndarray, policy_states: np.ndarray
    ) -> np.ndarray:
        """num_history states up to and including sample_idx, edge-padded."""
        hist = candidate_indices[candidate_indices <= sample_idx][-self.num_history :]
        missing = self.num_history - hist.shape[0]
        if missing > 0:
            hist = np.concatenate([np.zeros(missing, dtype=int), hist])
        return policy_states[hist]

    def get_policy_state_future(
        self, sample_idx: int, candidate_indices: np.ndarray, policy_states: np.ndarray
    ) -> np.ndarray:
        """prediction_horizon states after sample_idx, edge-padded."""
        fut = candidate_indices[candidate_indices > sample_idx][
            : self.prediction_horizon
        ]
        missing = self.prediction_horizon - fut.shape[0]
        if missing > 0:
            fut = np.concatenate(
                [fut, np.full(missing, candidate_indices[-1], dtype=int)]
            )
        return policy_states[fut]

    # --- retrieval -----------------------------------------------------------
    def __getitem__(self, global_idx: int) -> Dict:
        with self._getitem_lock:
            return self._getitem_unlocked(global_idx)

    def getitem_with_transforms(self, global_idx: int, transforms: Dict) -> Dict:
        """Lock-free fetch with a caller-OWNED transform stack.

        ``demo_info`` is read-only after __init__ and ``load_item`` is pure,
        so concurrent fetches are safe as long as each caller brings its own
        (exclusively used) transforms - the per-worker clones DataLoader
        makes. The shared-``self.transforms`` path stays serialized above.
        """
        return self._getitem_unlocked(global_idx, transforms)

    def _getitem_unlocked(
        self, global_idx: int, transforms: Optional[Dict] = None
    ) -> Dict:
        if transforms is None:
            transforms = self.transforms
        demo_path, sample_idx = self.locate(global_idx)
        info = self.demo_info[demo_path]
        policy_states = info["policy_states"]
        keypose_indices = info["keypose_indices"]

        if self.use_keyposes:
            if self.only_sample_keyposes:
                candidates = np.arange(len(keypose_indices))
            else:
                candidates = keypose_indices
        else:
            candidates = np.arange(info["num_samples"])

        for stack in transforms.values():
            for t in stack:
                t.reset()

        sample: Dict = {}
        for item_name in self.item_names:
            if item_name == POLICY_STATE_HISTORY_ITEM_NAME:
                value = self.get_policy_state_history(
                    sample_idx, candidates, policy_states
                )
            elif item_name == GT_POLICY_STATE_PRED_ITEM_NAME:
                value = self.get_policy_state_future(
                    sample_idx, candidates, policy_states
                )
            elif item_name == IS_KEYPOSE_ITEM_NAME:
                value = np.asarray(
                    True if self.only_sample_keyposes else sample_idx in keypose_indices
                )
            else:
                value = load_item(info[item_name][sample_idx])
            for transform in transforms.get(item_name, []):
                value = transform(value)
            sample[item_name] = value
        return sample

    # --- sample weighting ----------------------------------------------------
    def get_sample_weights(
        self, weighting: SamplingWeightingType, use_keyposes: bool
    ) -> np.ndarray:
        if weighting == SamplingWeightingType.UNIFORM:
            return np.ones(self.total_number_of_samples)
        if weighting == SamplingWeightingType.GRIPPER_STATE_CHANGE:
            return self._gripper_state_change_weights()
        raise NotImplementedError(weighting)

    def _gripper_state_change_weights(self) -> np.ndarray:
        """Inverse-frequency weights over has-gripper-state-change classes."""
        has_change = np.empty(self.total_number_of_samples, dtype=bool)
        for global_idx in range(self.total_number_of_samples):
            demo_path, sample_idx = self.locate(global_idx)
            info = self.demo_info[demo_path]
            if self.use_keyposes:
                candidates = (
                    np.arange(len(info["keypose_indices"]))
                    if self.only_sample_keyposes
                    else info["keypose_indices"]
                )
            else:
                candidates = np.arange(info["num_samples"])
            hist = self.get_policy_state_history(
                sample_idx, candidates, info["policy_states"]
            )
            fut = self.get_policy_state_future(
                sample_idx, candidates, info["policy_states"]
            )
            # Closedness via the embodiment codec: upstream compares the LAST
            # column (dataset.py:227-256), which is gripper openness for the
            # arm but head yaw for the humanoid, putting ~every humanoid
            # sample in the "change" class. The JAX package's improvement;
            # identical to upstream for the single-gripper arm.
            hist_closed = self.embodiment.split_gripper_tensor(hist[None])[
                0, :, :, 7
            ]
            fut_closed = self.embodiment.split_gripper_tensor(fut[None])[
                0, :, :, 7
            ]
            if self.use_keyposes:
                # Keypose mode: change between previous and next keypose
                # (upstream dataset.py:227-237).
                has_change[global_idx] = bool(
                    np.any(hist_closed[-1] != fut_closed[0])
                )
            else:
                openness = np.concatenate([hist_closed, fut_closed], axis=0)
                has_change[global_idx] = any(
                    len(np.unique(openness[:, g])) > 1
                    for g in range(openness.shape[1])
                )
        counts = np.asarray(
            [(~has_change).sum(), has_change.sum()], dtype=np.float64
        )
        assert np.all(counts != 0), "Found no samples in at least one class."
        class_weights = 1.0 / counts
        return class_weights[has_change.astype(int)]
