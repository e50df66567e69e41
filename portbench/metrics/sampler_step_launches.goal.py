"""Device operations (kernels, copies, memsets) launched per denoiser step
(the program's ``sampler/step`` span): a count the host's noise does not
move, which fusion or a CUDA graph lowers."""
from portbench import spans


def read(run):
    return spans.launches_per(run.events, "sampler/step") if spans.on_card(run) else None
