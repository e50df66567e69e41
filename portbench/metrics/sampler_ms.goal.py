"""Mean host time per goal of ``sample_trajectory`` (encoding and the
denoiser loop), from the span around it."""
import statistics


def read(run):
    spans = run.spans.get("sampler")
    return statistics.fmean(spans) * 1e3 if spans else None
