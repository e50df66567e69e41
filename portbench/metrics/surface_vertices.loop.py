"""Mean over the window's goals of the static map's surface vertices that
crossed to the host (the mapper's counter ``surface_vertices``, taken in
``get_vertices_and_features``). None where the program has no such
counter."""
import statistics


def read(run):
    counts = getattr(run, "counters", {}).get("surface_vertices")
    return float(statistics.fmean(counts)) if counts else None
