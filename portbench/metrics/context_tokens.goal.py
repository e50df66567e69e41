"""Mean over the window's goals of the context tokens that the encoder
attends over (the encoder's counter ``context_tokens``, read after each
goal). None where the program has no such counter."""
import statistics


def read(run):
    counts = getattr(run, "counters", {}).get("context_tokens")
    return float(statistics.fmean(counts)) if counts else None
