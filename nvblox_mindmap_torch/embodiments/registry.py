"""Task registry: embodiment per task and per-task keypose defaults.

The port's own copy of ``nvblox_mindmap_tpu/embodiments/registry.py``
(upstream ``mindmap/tasks/tasks.py``, ``embodiments/task_to_embodiment.py``,
``keyposes/task_to_default_keypose_params.py``,
``model_utils/task_to_predict_head_yaw.py``). ``Tasks`` is the enum of
``mapping/constants.py``: the port has one.
"""
from __future__ import annotations

from nvblox_mindmap_torch.data.keyposes import KeyposeDetectionMode
from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
from nvblox_mindmap_torch.embodiments.base import EmbodimentBase, EmbodimentType
from nvblox_mindmap_torch.embodiments.humanoid import HumanoidEmbodiment
from nvblox_mindmap_torch.mapping.constants import Tasks

# Isaac Lab gym ids (for the sim boundary).
TASK_TO_GYM_ID = {
    Tasks.CUBE_STACKING: "Isaac-Stack-Cube-Franka-With-Cams-IK-Rel-v0",
    Tasks.MUG_IN_DRAWER: "Isaac-Mug-in-Drawer-Franka-v0",
    Tasks.DRILL_IN_BOX: "Isaac-Drill-In-Box-GR1T2-Right-v0",
    Tasks.STICK_IN_BIN: "Isaac-Stick-In-Bin-GR1T2-Right-v0",
}

TASK_TO_EMBODIMENT_TYPE = {
    Tasks.CUBE_STACKING: EmbodimentType.ARM,
    Tasks.MUG_IN_DRAWER: EmbodimentType.ARM,
    Tasks.DRILL_IN_BOX: EmbodimentType.HUMANOID,
    Tasks.STICK_IN_BIN: EmbodimentType.HUMANOID,
}

TASK_TO_EXTRA_KEYPOSES_AROUND_GRASP_EVENTS = {
    Tasks.CUBE_STACKING: [5],
    Tasks.MUG_IN_DRAWER: [5, 15],
    Tasks.DRILL_IN_BOX: [5, 15],
    Tasks.STICK_IN_BIN: [5, 15],
}

TASK_TO_KEYPOSE_DETECTION_MODE = {
    Tasks.CUBE_STACKING: KeyposeDetectionMode.HIGHEST_Z_BETWEEN_GRASP,
    Tasks.MUG_IN_DRAWER: KeyposeDetectionMode.HIGHEST_Z_OF_VERTICAL_MOTION,
    Tasks.DRILL_IN_BOX: KeyposeDetectionMode.HIGHEST_Z_OF_VERTICAL_MOTION_AND_HEAD_TURN,
    Tasks.STICK_IN_BIN: KeyposeDetectionMode.HIGHEST_Z_OF_VERTICAL_MOTION_AND_HEAD_TURN,
}


def get_embodiment_type_from_task(task: Tasks) -> EmbodimentType:
    return TASK_TO_EMBODIMENT_TYPE[Tasks(task)]


def make_embodiment_for_task(task: Tasks) -> EmbodimentBase:
    """The arm for cube stacking and mug in drawer, the humanoid for drill
    in box and stick in bin."""
    if get_embodiment_type_from_task(task) == EmbodimentType.ARM:
        return ArmEmbodiment()
    return HumanoidEmbodiment()


def task_predicts_head_yaw(task: Tasks) -> bool:
    return get_embodiment_type_from_task(task) == EmbodimentType.HUMANOID
