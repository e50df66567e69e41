"""Device ms per traced train step of the operations launched inside FPS
(a profiler range around ``Encoder.run_fps``)."""
from portbench import idle


def read(run):
    if run.events is None or run.device.type != "cuda":
        return None
    seconds = idle.range_device_s(run.events, idle.SPAN_PREFIX + "fps")
    return None if seconds is None else seconds * 1e3 / run.traffic["trace_units"]
