"""Keypose detection from robot-state trajectories (host-side numpy).

The port's own copy of ``nvblox_mindmap_tpu/data/keyposes.py`` (upstream
``mindmap/embodiments/keypose_estimation_base.py`` and ``keyposes/*``):
keyposes are grasp-event boundaries, extra frames around grasps, and
per-mode height extrema; the first and last frames are always keyposes. The
gripper openness signal is re-derived from grasp intervals (closed at grasp
end - 1, open at grasp start + 1). Everything works on plain (N, ...) numpy
arrays.
"""
from __future__ import annotations

import enum
from typing import Callable, List, Sequence, Tuple

import numpy as np


class KeyposeDetectionMode(str, enum.Enum):
    NONE = "none"
    HIGHEST_Z_BETWEEN_GRASP = "highest_z_between_grasp"
    HIGHEST_Z_OF_VERTICAL_MOTION = "highest_z_of_vertical_motion"
    HIGHEST_Z_OF_VERTICAL_MOTION_AND_HEAD_TURN = "highest_z_of_vertical_motion_and_head_turn"


def has_highest_z_of_vertical_motion(mode: KeyposeDetectionMode) -> bool:
    return mode in (
        KeyposeDetectionMode.HIGHEST_Z_OF_VERTICAL_MOTION,
        KeyposeDetectionMode.HIGHEST_Z_OF_VERTICAL_MOTION_AND_HEAD_TURN,
    )


def has_head_turn_events(mode: KeyposeDetectionMode) -> bool:
    return mode == KeyposeDetectionMode.HIGHEST_Z_OF_VERTICAL_MOTION_AND_HEAD_TURN


def ensure_first_and_last_frames_are_keyposes(
    keypose_indices: np.ndarray, num_frames: int
) -> np.ndarray:
    keypose_list = list(keypose_indices)
    if len(keypose_list) == 0 or keypose_list[-1] != num_frames - 1:
        keypose_list.append(num_frames - 1)
    if keypose_list[0] != 0:
        keypose_list.insert(0, 0)
    return np.asarray(keypose_list)


def get_grasp_events(
    gripper_pos: np.ndarray,
    gripper_speed_threshold: float,
    is_gripper_open: Callable[[np.ndarray], bool],
    smoothing_kernel_size: int = 2,
) -> Tuple[List[Tuple[int, int]], np.ndarray]:
    """Detect grasp intervals and per-frame openness.

    Args:
        gripper_pos: (N, M) positions of the M gripper parts over time.
        gripper_speed_threshold: minimum jaw-norm speed counted as motion.
        is_gripper_open: predicate on a single (M,) jaw-position row.

    Returns:
        (grasp_intervals [(start, end)...], gripper_open (N,) 0/1 array).
    """
    gripper_pos = np.asarray(gripper_pos, dtype=np.float64)
    norm = np.linalg.norm(gripper_pos, axis=1)
    speed = np.abs(np.diff(norm, n=1))
    if speed.size:
        speed[0] = speed[-1] = 0.0
    kernel = np.ones(smoothing_kernel_size) / smoothing_kernel_size
    speed = np.convolve(speed, kernel)

    pos_change_mask = speed > gripper_speed_threshold
    mask_diff = np.diff(pos_change_mask, prepend=0, append=0)
    start_indices = np.where(mask_diff == 1)[0]
    end_indices = list(np.where(mask_diff == -1)[0])
    if len(end_indices) < len(start_indices):
        end_indices.append(len(gripper_pos) - 1)
    assert len(end_indices) == len(start_indices)
    grasp_intervals = list(zip(start_indices, end_indices))

    gripper_open = np.zeros(len(gripper_pos))
    current_open = bool(is_gripper_open(gripper_pos[0, :]))
    prev_end = 0
    for interval in grasp_intervals:
        if current_open:
            # Closes at the last frame of the grasp event (-1 margin).
            next_end = max(interval[1] - 1, 0)
        else:
            # Opens at the first frame of the release event (+1 margin).
            next_end = min(interval[0] + 1, len(gripper_open))
        gripper_open[prev_end:next_end] = current_open
        prev_end = next_end
        current_open = not current_open
    gripper_open[prev_end:] = current_open
    return grasp_intervals, gripper_open


def get_extra_keypose_indices_around_intervals(
    grasp_intervals: Sequence[Tuple[int, int]],
    extra_keyposes_around_grasp_events: Sequence[int],
    length: int,
) -> List[int]:
    extra = []
    for index in extra_keyposes_around_grasp_events:
        for interval in grasp_intervals:
            before = interval[0] - index
            after = interval[1] + index
            if before >= 0:
                extra.append(before)
            if after < length:
                extra.append(after)
    return extra


def get_highest_z_between_grasps(
    grasp_intervals: Sequence[Tuple[int, int]], eef_pos: np.ndarray
) -> List[int]:
    """Largest-z local peak between consecutive grasp events (margin 2)."""
    from scipy.signal import find_peaks

    eef_pos = np.asarray(eef_pos)
    maxz_indices = []
    margin = 2
    for i in range(len(grasp_intervals) - 1):
        idx = grasp_intervals[i][1]
        next_idx = grasp_intervals[i + 1][0]
        local_z = eef_pos[idx + margin : next_idx - margin][:, 2]
        peaks = find_peaks(local_z)[0]
        if len(peaks) > 0:
            best = margin + idx + peaks[np.argsort(local_z[peaks])[-1]]
            maxz_indices.append(int(best))
    return maxz_indices


def get_highest_z_of_vertical_motion(
    grasp_intervals: Sequence[Tuple[int, int]],
    eef_pos: np.ndarray,
    window_size: int = 5,
    min_vertical_motion_ratio: float = 0.6,
    min_vertical_motion_interval_length: int = 2,
    min_between_grasp_interval: int = 50,
    min_vertical_diff_m: float | None = 0.05,
) -> Tuple[List[int], np.ndarray]:
    """Highest point of each vertical-motion segment between grasp events."""
    eef_pos = np.asarray(eef_pos, dtype=np.float64)
    velocities = np.diff(eef_pos, axis=0)
    vnorm = np.linalg.norm(velocities, axis=1)
    vnorm[vnorm <= 1e-6] = 1e-6
    ratio = np.abs(velocities[:, 2] / vnorm)

    smoothed = np.empty_like(ratio)
    for i in range(len(ratio)):
        lo = max(0, i - window_size)
        hi = min(len(ratio), i + window_size + 1)
        smoothed[i] = np.mean(ratio[lo:hi])
    vertical_mask = smoothed > min_vertical_motion_ratio

    # Split segments at direction changes.
    for i in range(1, len(vertical_mask) - 1):
        if vertical_mask[i]:
            prev_dz = eef_pos[i][2] - eef_pos[i - 1][2]
            next_dz = eef_pos[i + 1][2] - eef_pos[i][2]
            if prev_dz * next_dz < 0:
                vertical_mask[i] = False

    # Contiguous vertical segments.
    segments = []
    start = None
    for i in range(len(vertical_mask)):
        if vertical_mask[i] and start is None:
            start = i
        elif not vertical_mask[i] and start is not None:
            if i - start > min_vertical_motion_interval_length:
                segments.append((start, i))
            start = None
    if start is not None:
        segments.append((start, len(vertical_mask)))

    if len(grasp_intervals) == 0:
        return [], vertical_mask

    filtered = []
    for gi in range(-1, len(grasp_intervals)):
        end_last = 0 if gi == -1 else grasp_intervals[gi][1]
        start_next = (
            len(eef_pos)
            if gi == len(grasp_intervals) - 1
            else grasp_intervals[gi + 1][0]
        )
        if start_next - end_last < min_between_grasp_interval:
            continue
        ups, downs = [], []
        for seg_start, seg_end in segments:
            # seg_end <= len(vertical_mask) == len(eef_pos) - 1, so this is
            # always a valid index (upstream's indexing).
            dz = abs(eef_pos[seg_end][2] - eef_pos[seg_start][2])
            if min_vertical_diff_m is not None and dz < min_vertical_diff_m:
                continue
            if eef_pos[seg_end][2] > eef_pos[seg_start][2]:
                if end_last <= seg_end < start_next:
                    ups.append(seg_end)
            else:
                if end_last <= seg_start < start_next:
                    downs.append(seg_start)
        if ups:
            filtered.append(int(ups[0]))
        if downs:
            filtered.append(int(downs[-1]))
    return filtered, vertical_mask


# With a single grasp interval the condition end-of-first < idx <
# start-of-last is unsatisfiable, so every vertical-motion keypose is
# dropped, as upstream does (keypose_estimation_base.py:314-332).
def select_indices_between_grasps(
    indices: Sequence[int], grasp_intervals: Sequence[Tuple[int, int]]
) -> List[int]:
    return [
        idx
        for idx in indices
        if grasp_intervals[0][1] < idx < grasp_intervals[-1][0]
    ]


def get_extra_keyposes_between_indices(
    indices: Sequence[int], min_interval_distance: int, fractions: Sequence[float]
) -> List[int]:
    extra = []
    sorted_indices = sorted(indices)
    for i in range(0, len(sorted_indices) - 1, 2):
        last_end = sorted_indices[i]
        next_start = sorted_indices[i + 1]
        dist = next_start - last_end
        if dist > min_interval_distance:
            for fraction in fractions:
                assert 0 < fraction < 1
                extra.append(int(last_end + fraction * dist))
    return extra


def get_previous_keypose(keypose_indices: Sequence[int], current_idx: int) -> int:
    prev = sorted(i for i in keypose_indices if i < current_idx)
    return prev[-1] if prev else 0


def intervals_to_indices(intervals: Sequence[Tuple[int, int]]) -> np.ndarray:
    if len(intervals) == 0:
        return np.asarray([], dtype=np.int64)
    return np.concatenate(intervals)


def combine_indices(*args: Sequence[int]) -> np.ndarray:
    parts = [np.asarray(a, dtype=np.int64).reshape(-1) for a in args]
    if not parts:
        return np.asarray([], dtype=np.int32)
    return np.unique(np.sort(np.concatenate(parts))).astype(np.int32)
