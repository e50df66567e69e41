"""Mean host time of one denoiser step (the program's ``sampler/step``
span: the denoiser's dispatch and both scheduler steps) in the traced
goals; the span does not wait for the card. It is a profiled host time:
the profiler charges a cost to every aten op, so it reads 1.5-2.2x the
untraced host time and weighs the op count more than the untraced program
does. ``sampler_step_launches.goal`` is the reading the profiler's cost
does not move."""
from portbench import spans


def read(run):
    return spans.mean_ms(run.events, "sampler/step") if spans.on_card(run) else None
