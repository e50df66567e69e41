"""Mean host time per goal of the surface extraction and its copy to the
host (``mesh_vertices``: ``update_feature_mesh`` and
``get_vertices_and_features``), from the span around it."""
import statistics


def read(run):
    spans = run.spans.get("mesh")
    return statistics.fmean(spans) * 1e3 if spans else None
