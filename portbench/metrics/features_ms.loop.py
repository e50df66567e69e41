"""Mean host time per sim step of the mapping feature function (the
backbone and the upscale to the integration size), from the span around
it."""
import statistics


def read(run):
    spans = run.spans.get("features")
    return statistics.fmean(spans) * 1e3 if spans else None
