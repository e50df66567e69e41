"""Host ms per traced goal in the policy outside the mesh and the
prediction (``policy/goal`` less its ``policy/goal/mesh`` and
``policy/goal/predict`` spans): the history, vertex sampling, camera
inputs and the policy states. It is a profiled host time: the profiler
charges a cost to every aten op, so it reads 1.5-2.2x the untraced host
time and weighs the op count more than the untraced program does.
``sampler_step_launches.goal`` is the reading the profiler's cost does not
move."""
from portbench import spans


def read(run):
    if not spans.on_card(run):
        return None
    return spans.self_ms_per(run.events, "policy/goal",
                             ("policy/goal/mesh", "policy/goal/predict"))
