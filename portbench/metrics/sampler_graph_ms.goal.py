"""Mean host time of one replay of the denoiser loop's CUDA graph (the
program's ``sampler/graph`` span: the copies into the graph's inputs, the
replay's launch and the clones of its outputs) in the traced goals; the
span does not wait for the card. A profiled host time, like
``sampler_step_ms.goal``, which it takes over where goals replay the loop
(that reader finds no ``sampler/step`` there). None where no goal replayed
a graph."""
from portbench import spans


def read(run):
    return spans.mean_ms(run.events, "sampler/graph") if spans.on_card(run) else None
