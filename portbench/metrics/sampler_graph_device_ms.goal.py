"""Device ms of one replay of the denoiser loop's CUDA graph (the union of
the operations launched inside the program's ``sampler/graph`` spans, per
span): the work of the T denoiser steps once the host no longer paces them.
None where no goal replayed a graph."""
from portbench import spans


def read(run):
    return spans.device_ms_per(run.events, "sampler/graph") if spans.on_card(run) else None
