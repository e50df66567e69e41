"""One goal's FLOPs (counted once in set-up by ``FlopCounterMode`` on the
eager attention path, the same work as the kernels') over the mean goal
time of the traced run outside the profiler, as a share of the card's dense
16-bit peak (``roofline.mfu_percent``)."""
from portbench import roofline


def read(run):
    return roofline.mfu_percent(run, "goal")
