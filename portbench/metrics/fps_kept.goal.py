"""Mean over the window's goals of the tokens that FPS kept for the
denoiser's self-attention (the encoder's counter ``fps_kept``, read after
each goal). None where the program has no such counter."""
import statistics


def read(run):
    counts = getattr(run, "counters", {}).get("fps_kept")
    return float(statistics.fmean(counts)) if counts else None
