"""PCA projection of high-dim features to RGB for visualization.

The port's own copy of ``nvblox_mindmap_tpu/image/pca.py`` (upstream
``mindmap/image_processing/pca.py``), host numpy as there. Fit a 3-component PCA basis on
(N, C) features and map to [0, 1] RGB; the returned projection can be reused
so colors are stable across frames.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np


class PcaProjection(NamedTuple):
    mean: np.ndarray  # (C,)
    components: np.ndarray  # (C, 3)
    lo: np.ndarray  # (3,) per-channel min used for normalization
    hi: np.ndarray  # (3,)


def fit_pca(features: np.ndarray, num_components: int = 3) -> PcaProjection:
    """Fit a PCA basis on (N, C) features.

    Reference semantics (image_processing/pca.py:54-68): zero rows (padded /
    never-integrated features) are excluded from the basis fit; projection
    at apply time is UNcentered (mean stays 0 in the returned projection,
    pinned by tests/test_reference_image_parity.py); display bounds are the
    1%/99% quantiles of all rows' projections. The basis comes from an
    eigendecomposition of the C x C covariance - same components as an SVD
    of the (N, C) matrix at a fraction of the time/memory for dataset-scale
    fits.
    """
    features = np.asarray(features, dtype=np.float64)
    valid = ~np.all(features == 0, axis=-1)
    nonzero = features[valid] if valid.any() else features
    mean = nonzero.mean(axis=0)
    centered = nonzero - mean
    cov = centered.T @ centered  # (C, C)
    eigvals, eigvecs = np.linalg.eigh(cov)
    components = eigvecs[:, ::-1][:, :num_components]  # descending variance
    eigvals_desc = eigvals[::-1][:num_components]
    if components.shape[1] < num_components:
        # eigh of the CxC covariance always yields C eigenvectors, so this
        # branch fires only when the feature dim C < num_components (not on
        # few samples): zero-pad so apply_pca's (..., 3) reshape stays valid.
        pad = num_components - components.shape[1]
        components = np.concatenate(
            [components, np.zeros((components.shape[0], pad))], axis=1
        )
        eigvals_desc = np.concatenate([eigvals_desc, np.zeros(pad)])
    # Rank-deficient fits (fewer valid samples than C) produce ~0-eigenvalue
    # noise directions; zero them so they don't inject noise into the RGB.
    tol = max(eigvals_desc[0], 0.0) * 1e-10 + 1e-30
    components = components * (eigvals_desc > tol)[None, :]
    projected = features @ components  # uncentered, like the reference
    lo = np.quantile(projected, 0.01, axis=0)
    hi = np.quantile(projected, 0.99, axis=0)
    return PcaProjection(np.zeros_like(mean), components, lo, hi)


def apply_pca(
    features: np.ndarray, projection: PcaProjection
) -> np.ndarray:
    """(N, C) or (H, W, C) features -> same leading shape + 3 RGB in [0, 1]."""
    shape = features.shape
    flat = np.asarray(features, dtype=np.float64).reshape(-1, shape[-1])
    projected = (flat - projection.mean) @ projection.components
    denom = np.where(projection.hi - projection.lo > 1e-12,
                     projection.hi - projection.lo, 1.0)
    rgb = np.clip((projected - projection.lo) / denom, 0.0, 1.0)
    return rgb.reshape(shape[:-1] + (3,)).astype(np.float32)


def apply_pca_return_projection(
    features: np.ndarray, projection: Optional[PcaProjection] = None
) -> Tuple[np.ndarray, PcaProjection]:
    """Fit (if needed) and apply; returns (rgb, projection)."""
    flat = np.asarray(features).reshape(-1, features.shape[-1])
    if projection is None:
        projection = fit_pca(flat)
    return apply_pca(features, projection), projection
