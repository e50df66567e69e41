"""Samples of every completed train step over the whole window, which ends
in a synchronize."""


def read(run):
    samples = run.counts.get("samples")
    return samples / run.window_s if samples else None
