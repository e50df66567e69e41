from nvblox_mindmap_torch.embodiments.base import EmbodimentBase, EmbodimentType
from nvblox_mindmap_torch.embodiments.arm import ArmEmbodiment
from nvblox_mindmap_torch.embodiments.humanoid import HumanoidEmbodiment
from nvblox_mindmap_torch.embodiments.registry import (
    get_embodiment_type_from_task,
    make_embodiment_for_task,
)

__all__ = [
    "ArmEmbodiment",
    "EmbodimentBase",
    "EmbodimentType",
    "HumanoidEmbodiment",
    "get_embodiment_type_from_task",
    "make_embodiment_for_task",
]
