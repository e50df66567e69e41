"""Host ms per sim step of the robot's dynamic mask: its construction from
the frame's label image and its copy to the card (the program's
``policy/step/robot_mask`` spans inside ``policy/step``). It is a profiled
host time: the profiler charges a cost to every aten op. None where the
program has no such span."""
from portbench import spans


def read(run):
    if not spans.on_card(run) or not spans.ranges(run.events, "policy/step/robot_mask"):
        return None
    return spans.child_ms_per(run.events, "policy/step/robot_mask", "policy/step")
