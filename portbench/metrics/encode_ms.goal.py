"""Host ms per traced goal of the model's encoder pass (the program's
``model/encode`` spans inside ``policy/goal``: backbone, mesh tokens,
gripper history, FPS). It is a profiled host time: the profiler charges a
cost to every aten op, so it reads 1.5-2.2x the untraced host time and
weighs the op count more than the untraced program does.
``sampler_step_launches.goal`` is the reading the profiler's cost does not
move."""
from portbench import spans


def read(run):
    if not spans.on_card(run):
        return None
    return spans.child_ms_per(run.events, "model/encode", "policy/goal")
