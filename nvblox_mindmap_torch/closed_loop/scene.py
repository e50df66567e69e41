"""Synthetic box-world scene: renderer + kinematic environment with cameras.

The port's own copy of ``nvblox_mindmap_tpu/closed_loop/scene.py``. Upstream
renders its closed-loop observations with Isaac Lab's tiled cameras over the
task scenes (``mindmap/tasks/stack_cube_franka/stack_env_cfg.py``,
``mindmap/isaaclab_utils/isaaclab_camera_handler.py``). This module is the
hermetic equivalent: an analytic ray / AABB caster over named boxes (table,
objects, a robot-arm marker) that produces the ``CameraFrame`` contract the
policies consume: metric depth along the camera +z axis (the convention
``ops/backprojection`` inverts), RGB in [0, 1], and integer semantic label
images with an id -> class map, so the dynamic ('robot_arm') masking path
runs end to end.

``SceneKinematicEnvironment`` closes the loop without a simulator: scripted
demos -> datagen fusion -> training -> live mapping + diffusion ->
task-evaluator success. The renderer is float64 host numpy by design: it
stands in for the external simulator, not for the device path, and gives the
JAX package's images bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from nvblox_mindmap_torch.closed_loop.environment import (
    CameraFrame,
    KinematicEnvironment,
)
from nvblox_mindmap_torch.embodiments.base import EmbodimentType
from nvblox_mindmap_torch.geometry.np_rotations import (
    matrix_to_quat,
    quat_to_matrix,
)

# Per-hit-face brightness so box faces are visually distinct (a stand-in for
# lighting; keeps flat-color boxes from merging into one blob in RGB).
_FACE_SHADE = np.asarray([0.75, 0.9, 1.0])


@dataclasses.dataclass
class Box:
    """Axis-aligned box: name + center + half extents + color + semantic id."""

    name: str
    center: np.ndarray  # (3,)
    half_extents: np.ndarray  # (3,)
    color: np.ndarray  # (3,) in [0, 1]
    semantic_id: int = 0

    def __post_init__(self):
        self.center = np.asarray(self.center, dtype=np.float64)
        self.half_extents = np.asarray(self.half_extents, dtype=np.float64)
        self.color = np.asarray(self.color, dtype=np.float64)


def look_at_pose7(
    eye, target, up=(0.0, 0.0, 1.0)
) -> np.ndarray:
    """Camera-to-world pose7 (pos + wxyz) looking from eye at target.

    Camera convention matches ops/backprojection.py: +z forward (optical
    axis), +x right, +y down in the image.
    """
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    norm = np.linalg.norm(fwd)
    assert norm > 1e-9, "look_at: eye and target coincide"
    z_cam = fwd / norm
    up = np.asarray(up, dtype=np.float64)
    x_cam = np.cross(z_cam, up)
    x_norm = np.linalg.norm(x_cam)
    if x_norm < 1e-9:  # looking straight along up: pick an arbitrary right
        x_cam = np.cross(z_cam, np.asarray([1.0, 0.0, 0.0]))
        x_norm = np.linalg.norm(x_cam)
    x_cam = x_cam / x_norm
    y_cam = np.cross(z_cam, x_cam)
    rot = np.stack([x_cam, y_cam, z_cam], axis=1)  # columns = camera axes
    return np.concatenate([eye, matrix_to_quat(rot)]).astype(np.float32)


def render_boxes(
    boxes: List[Box],
    pose7: np.ndarray,
    intrinsics: np.ndarray,
    height: int,
    width: int,
    background_color=(0.12, 0.12, 0.14),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ray-cast boxes from a pinhole camera.

    Returns (rgb (H, W, 3) float32 in [0, 1], depth (H, W) float32 meters
    along camera +z with 0 = no hit, seg (H, W) int32 semantic ids with
    0 = background).
    """
    pose7 = np.asarray(pose7, dtype=np.float64)
    K = np.asarray(intrinsics, dtype=np.float64)
    origin = pose7[:3]
    rot = quat_to_matrix(pose7[3:7])

    ii, jj = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
    # Rays scaled so the parameter t IS the camera-z depth (d_cam.z == 1),
    # the same convention backproject_depth inverts (backprojection.py:41-53).
    d_cam = np.stack(
        [
            (ii + 0.0 - K[0, 2]) / K[0, 0],
            (jj + 0.0 - K[1, 2]) / K[1, 1],
            np.ones_like(ii, dtype=np.float64),
        ],
        axis=-1,
    )
    d_world = d_cam @ rot.T  # (H, W, 3)

    depth = np.full((height, width), np.inf)
    rgb = np.empty((height, width, 3), dtype=np.float64)
    rgb[:] = np.asarray(background_color)
    seg = np.zeros((height, width), dtype=np.int32)

    with np.errstate(divide="ignore", invalid="ignore"):
        inv_d = 1.0 / d_world  # inf where a component is 0 - slab-safe
    for box in boxes:
        bmin = box.center - box.half_extents
        bmax = box.center + box.half_extents
        t0 = (bmin - origin) * inv_d  # (H, W, 3)
        t1 = (bmax - origin) * inv_d
        t_lo = np.minimum(t0, t1)
        t_hi = np.maximum(t0, t1)
        # A zero direction component yields (-inf, inf) slabs when the origin
        # is inside that slab and (inf, inf)/(-inf, -inf) when outside; the
        # max/min below then rejects the ray - exactly the slab test.
        t_near = np.nanmax(t_lo, axis=-1)
        t_far = np.nanmin(t_hi, axis=-1)
        hit = (t_near <= t_far) & (t_near > 1e-6) & (t_near < depth)
        if not hit.any():
            continue
        # Which axis's slab produced t_near -> hit face -> shade.
        face_axis = np.argmax(np.where(np.isfinite(t_lo), t_lo, -np.inf),
                              axis=-1)
        shade = _FACE_SHADE[face_axis]
        depth = np.where(hit, t_near, depth)
        rgb = np.where(hit[..., None], box.color * shade[..., None], rgb)
        seg = np.where(hit, np.int32(box.semantic_id), seg)

    depth = np.where(np.isfinite(depth), depth, 0.0)
    return (
        rgb.astype(np.float32),
        depth.astype(np.float32),
        seg,
    )


# Semantic ids for the scene classes (0 is background by convention).
SEM_BACKGROUND = 0
SEM_TABLE = 1
SEM_OBJECT_BASE = 2  # object i gets SEM_OBJECT_BASE + i
SEM_ROBOT = 200

_CUBE_COLORS = np.asarray(
    [[0.85, 0.2, 0.2], [0.2, 0.45, 0.85], [0.95, 0.8, 0.2], [0.3, 0.8, 0.35]]
)


class SceneKinematicEnvironment(KinematicEnvironment):
    """KinematicEnvironment whose cameras render the actual scene.

    Adds to the base class:
    - a static table slab plus one box per named object (objects move with
      the grasp kinematics, so the render always reflects object state);
    - a robot-arm marker box at the end-effector, labelled 'robot_arm' (the
      task configs' dynamic class, mapping/constants.py) so live mapping
      exercises dynamic masking exactly like the Isaac boundary;
    - settle-on-release gravity: a released object falls onto the highest
      support below it (table or another object). This makes the
      CubeStackingEvaluator's z-separation heuristic physically meaningful
      in this world - floating cubes would otherwise over-count stacks (see
      the deliberate-parity note in evaluators.py _num_stacked_cubes).
    - a camera schedule: ``camera_pose_fn(step) -> {name: pose7}``; default
      is a static table camera looking at the workspace center.
    """

    def __init__(
        self,
        embodiment,
        initial_state: np.ndarray,
        objects: Dict[str, np.ndarray],
        object_half_extents=0.04,
        table_center=(0.5, 0.0, -0.025),
        table_half_extents=(0.45, 0.5, 0.025),
        camera_pose_fn: Optional[Callable[[int], Dict[str, np.ndarray]]] = None,
        image_size: int = 64,
        focal_px: Optional[float] = None,
        render_robot_marker: bool = True,
        waypoints: Optional[List[np.ndarray]] = None,
        max_step_m: float = 0.05,
        grasp_radius_m: float = 0.06,
        fixed_objects: Optional[List[str]] = None,
        object_colors: Optional[Dict[str, np.ndarray]] = None,
        robot_class_name: Optional[str] = None,
        head_position: Optional[np.ndarray] = None,
        head_base_yaw: float = 0.0,
        head_look_distance_m: float = 0.7,
        head_look_z_m: Optional[float] = None,
        max_head_yaw_step_rad: float = 0.1,
    ):
        super().__init__(
            embodiment,
            initial_state,
            waypoints or [],
            max_step_m=max_step_m,
            image_size=image_size,
            objects=objects,
            grasp_radius_m=grasp_radius_m,
            fixed_objects=fixed_objects,
            max_head_yaw_step_rad=max_head_yaw_step_rad,
        )
        # Uniform scalar half extent (cube tasks) or a per-object map of
        # (3,) half extents (mug + drawer-bottom scenes have mixed sizes).
        if isinstance(object_half_extents, dict):
            missing = set(self.initial_objects) - set(object_half_extents)
            assert not missing, f"objects without half extents: {missing}"
            self.object_half_map = {
                k: np.broadcast_to(
                    np.asarray(v, dtype=np.float64), (3,)
                ).copy()
                for k, v in object_half_extents.items()
            }
            # Scalar fallback used by cube-task consumers (evaluator probe);
            # per-object scenes should read object_half_map instead.
            self.object_half = float(
                np.median([h.max() for h in self.object_half_map.values()])
            )
        else:
            self.object_half = float(object_half_extents)
            self.object_half_map = {
                name: np.full(3, self.object_half)
                for name in self.initial_objects
            }
        self.object_colors = {
            k: np.asarray(v, dtype=np.float64)
            for k, v in (object_colors or {}).items()
        }
        self.table = Box(
            "table",
            np.asarray(table_center),
            np.asarray(table_half_extents),
            color=np.asarray([0.45, 0.33, 0.22]),
            semantic_id=SEM_TABLE,
        )
        self.render_robot_marker = render_robot_marker
        self._object_ids = {
            name: SEM_OBJECT_BASE + i
            for i, name in enumerate(sorted(self.initial_objects))
        }
        self._is_humanoid = (
            embodiment.embodiment_type == EmbodimentType.HUMANOID
        )
        # The dynamic semantic class name the task's mapping config masks out
        # (mapping/constants.py dynamic_class_labels: arm tasks use
        # 'robot_arm', GR1 tasks use 'robot').
        self.robot_class_name = robot_class_name or (
            "robot" if self._is_humanoid else "robot_arm"
        )
        # Humanoid head rig: the pov camera sits at head_position and its
        # view direction follows the policy state's head yaw (state[16],
        # rotation about world z from head_base_yaw). This is what couples
        # head-turn keyposes to what the policy actually observes, mirroring
        # the GR1's head-mounted camera (reference humanoid observation.py).
        table_c = np.asarray(table_center, dtype=np.float64)
        if head_position is None:
            head_position = table_c + np.asarray([0.0, -0.75, 0.65])
        self.head_position = np.asarray(head_position, dtype=np.float64)
        self.head_base_yaw = float(head_base_yaw)
        self.head_look_distance_m = float(head_look_distance_m)
        # Default gaze height: just above the table top.
        self.head_look_z_m = float(
            head_look_z_m
            if head_look_z_m is not None
            else table_c[2] + np.asarray(table_half_extents)[2] + 0.03
        )
        # Remembered for scene.json serialization: a factory-installed fn on
        # a humanoid cannot be captured post-hoc (the default pov rig is
        # state-dependent and is instead rebuilt from the head-rig keys).
        self._custom_camera_fn = camera_pose_fn is not None
        if camera_pose_fn is None:
            if self._is_humanoid:
                external_pose = look_at_pose7(
                    eye=table_c + np.asarray([0.0, -1.1, 0.9]),
                    target=table_c + np.asarray([0.0, 0.0, 0.1]),
                )

                def camera_pose_fn(step: int) -> Dict[str, np.ndarray]:
                    return {
                        "pov": self._pov_pose_from_head_yaw(),
                        "external": external_pose,
                    }

            else:
                table_pose = look_at_pose7(
                    eye=(0.5, -0.85, 0.55),
                    target=(0.5, 0.0, 0.05),
                )

                # Physically a table-mounted view, but recorded under the arm
                # dataset contract's 'wrist' item names (embodiments/arm.py
                # WRIST_ITEMS) so replay/datagen/training consume it unchanged.
                def camera_pose_fn(step: int) -> Dict[str, np.ndarray]:
                    return {"wrist": table_pose}

        self.camera_pose_fn = camera_pose_fn
        self.focal_px = float(focal_px if focal_px is not None else image_size)

    def _pov_pose_from_head_yaw(self) -> np.ndarray:
        """Head camera pose from the current head yaw (humanoid only).

        The camera sits at ``head_position`` and looks at the tabletop point
        ``head_look_distance_m`` away in the yaw direction: yaw 0 looks along
        +y (toward the table from the default head placement); positive yaw
        turns left (counter-clockwise about world +z).
        """
        yaw = self.head_base_yaw + (
            float(self.state[16]) if self._is_humanoid else 0.0
        )
        target = np.asarray(
            [
                self.head_position[0] - np.sin(yaw) * self.head_look_distance_m,
                self.head_position[1] + np.cos(yaw) * self.head_look_distance_m,
                self.head_look_z_m,
            ]
        )
        return look_at_pose7(eye=self.head_position, target=target)

    @property
    def semantic_id_to_class(self) -> Dict[int, str]:
        ids = {
            SEM_BACKGROUND: "background",
            SEM_TABLE: "table",
            SEM_ROBOT: self.robot_class_name,
        }
        ids.update({v: k for k, v in self._object_ids.items()})
        return ids

    # --- physics: settle released objects -----------------------------------
    def _support_top_below(self, name: str) -> float:
        """Top z of the highest support under object ``name`` (table top or
        another object overlapping in xy)."""
        pos = self.objects[name][:3]
        half = self.object_half_map[name]
        top = self.table.center[2] + self.table.half_extents[2]
        for other, pose in self.objects.items():
            if other == name:
                continue
            other_half = self.object_half_map[other]
            xy_overlap = np.all(
                np.abs(pose[:2] - pos[:2]) < half[:2] + other_half[:2] - 1e-6
            )
            # A support is any xy-overlapping object whose top is at or below
            # the released object's TOP (not its center): a release that
            # interpenetrates the support would otherwise skip it and
            # teleport through to the table, co-located with the support - a
            # real engine resolves the overlap upward and settles on top.
            below = pose[2] + other_half[2] <= pos[2] + half[2] + 1e-6
            if xy_overlap and below:
                top = max(top, float(pose[2] + other_half[2]))
        return top

    def _update_grasp(self) -> None:
        held_before = dict(self._held)
        super()._update_grasp()
        for slot, name in held_before.items():
            if self._held.get(slot) != name:
                # Released: drop onto the highest support below.
                self.objects[name][2] = (
                    self._support_top_below(name)
                    + self.object_half_map[name][2]
                )

    # --- rendering ------------------------------------------------------------
    def _scene_boxes(self) -> List[Box]:
        boxes = [self.table]
        for i, (name, pose) in enumerate(sorted(self.objects.items())):
            boxes.append(
                Box(
                    name,
                    pose[:3],
                    self.object_half_map[name],
                    color=self.object_colors.get(
                        name, _CUBE_COLORS[i % len(_CUBE_COLORS)]
                    ),
                    semantic_id=self._object_ids[name],
                )
            )
        if self.render_robot_marker:
            for pos_slice, _ in self._gripper_slots():
                eef = self.state[pos_slice].astype(np.float64)
                boxes.append(
                    Box(
                        self.robot_class_name,
                        eef + np.asarray([0.0, 0.0, 0.035]),
                        np.asarray([0.015, 0.015, 0.035]),
                        color=np.asarray([0.75, 0.75, 0.78]),
                        semantic_id=SEM_ROBOT,
                    )
                )
        return boxes

    def get_cameras(self) -> Dict[str, CameraFrame]:
        H = W = self.image_size
        f = self.focal_px
        intr = np.asarray(
            [[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float32
        )
        boxes = self._scene_boxes()
        frames = {}
        for name, pose7 in self.camera_pose_fn(self.steps).items():
            rgb, depth, seg = render_boxes(boxes, pose7, intr, H, W)
            frames[name] = CameraFrame(
                rgb, depth, intr, np.asarray(pose7, np.float32), seg
            )
        return frames
