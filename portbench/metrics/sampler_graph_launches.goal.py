"""Device operations (kernels, copies, memsets) that one replay of the
denoiser loop's CUDA graph runs (the program's ``sampler/graph`` span: a
replay's operations carry the correlation id of its launch): the T steps'
operations and the replay's copies, which ``sampler_step_launches.goal``
counted a step on the eager loop. None where no goal replayed a graph."""
from portbench import spans


def read(run):
    return spans.launches_per(run.events, "sampler/graph") if spans.on_card(run) else None
