"""One train step's FLOPs (``FlopCounterMode``, counted once in set-up)
over the mean step time of the traced run outside the profiler, as a share
of the card's dense 16-bit peak (``roofline.mfu_percent``)."""
from portbench import roofline


def read(run):
    return roofline.mfu_percent(run, "train_step")
