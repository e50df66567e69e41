"""Mean over the window's goals of the static map's feature pages in use
(the mapper's counter ``live_pages``, read beside the crossing count at
each surface extraction). None where the program has no such counter."""
import statistics


def read(run):
    counts = getattr(run, "counters", {}).get("live_pages")
    return float(statistics.fmean(counts)) if counts else None
