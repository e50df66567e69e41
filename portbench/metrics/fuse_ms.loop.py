"""Mean host time per camera frame of ``nvblox_integrate`` (depth, color
and feature fusion), from the span around it."""
import statistics


def read(run):
    spans = run.spans.get("fuse")
    return statistics.fmean(spans) * 1e3 if spans else None
