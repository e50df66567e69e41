"""Device ms per traced train step of the operations launched inside the
frozen extractor's forward (a profiler range its forward hooks open and
close)."""
from portbench import idle


def read(run):
    if run.events is None or run.device.type != "cuda":
        return None
    seconds = idle.range_device_s(run.events, idle.SPAN_PREFIX + "backbone")
    return None if seconds is None else seconds * 1e3 / run.traffic["trace_units"]
