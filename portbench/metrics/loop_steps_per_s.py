"""Sim steps completed over the whole window of a closed-loop episode,
including the goals that interrupt them."""


def read(run):
    steps = run.counts.get("step")
    return steps / run.window_s if steps else None
