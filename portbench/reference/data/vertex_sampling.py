"""Mesh-vertex subsampling to a fixed token count (host-side numpy).

A copy of ``nvblox_mindmap_tpu/data/vertex_sampling.py`` (upstream
``mindmap/data_loading/vertex_sampling.py``): samples are always brought to
exactly N vertices, by downsampling with the chosen method or by zero
padding with a validity mask. It runs on the host with a numpy generator,
so one seed draws the same vertices here and in the JAX package.
"""
from __future__ import annotations

import enum
from typing import Optional, Tuple

import numpy as np


class VertexSamplingMethod(str, enum.Enum):
    RANDOM_WITHOUT_REPLACEMENT = "random_without_replacement"
    RANDOM_WITH_REPLACEMENT = "random_with_replacement"
    LOWEST = "lowest"
    NONE = "none"


def sample_to_n_vertices(
    vertices: np.ndarray,
    features: np.ndarray,
    desired_num_vertices: Optional[int],
    method: VertexSamplingMethod,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (vertices (M, 3), features (M, C), valid_mask (M,))."""
    if vertices.ndim != 2 or features.ndim != 2 or vertices.shape[0] != features.shape[0]:
        raise ValueError(f"vertices {vertices.shape} and features {features.shape} "
                         "must be (N, 3) and (N, C)")
    n = vertices.shape[0]
    if method == VertexSamplingMethod.NONE or n == desired_num_vertices:
        return vertices, features, np.ones(n, dtype=bool)
    if rng is None:
        rng = np.random.default_rng()

    if n > desired_num_vertices:
        if method == VertexSamplingMethod.RANDOM_WITHOUT_REPLACEMENT:
            idx = rng.permutation(n)[:desired_num_vertices]
        elif method == VertexSamplingMethod.RANDOM_WITH_REPLACEMENT:
            idx = rng.integers(0, n, size=desired_num_vertices)
        elif method == VertexSamplingMethod.LOWEST:
            # Upstream sorts by negative z, i.e. selects the *highest* z
            # despite the name.
            idx = np.argsort(-vertices[:, 2])[:desired_num_vertices]
        else:
            raise ValueError(f"Unknown vertex sampling method: {method}")
        return vertices[idx], features[idx], np.ones(desired_num_vertices, dtype=bool)

    # Pad with zeros.
    pad = desired_num_vertices - n
    vertices_out = np.concatenate(
        [vertices, np.zeros((pad, vertices.shape[1]), dtype=vertices.dtype)])
    features_out = np.concatenate(
        [features, np.zeros((pad, features.shape[1]), dtype=features.dtype)])
    valid = np.ones(desired_num_vertices, dtype=bool)
    valid[n:] = False
    return vertices_out, features_out, valid
