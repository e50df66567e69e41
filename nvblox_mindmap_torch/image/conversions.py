"""Image conversions: the port's own copy of
``nvblox_mindmap_tpu/image/conversions.py`` (upstream
``mindmap/image_processing/image_conversions.py``, ``depth_noise.py``)."""
from __future__ import annotations

import numpy as np

from nvblox_mindmap_torch.mapping.constants import DEPTH_SCALE_FACTOR


def convert_rgb_to_model_input(image: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] HWC -> float32 [0, 1] HWC."""
    return np.asarray(image, dtype=np.float32) / 255.0


def convert_model_input_to_rgb(image: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(image) * 255.0, 0, 255).astype(np.uint8)


def depth_to_uint16(depth_m: np.ndarray) -> np.ndarray:
    """Metric depth -> uint16 millimeter storage format."""
    return np.clip(depth_m * DEPTH_SCALE_FACTOR, 0, 65535).astype(np.uint16)


def uint16_to_depth(depth_u16: np.ndarray) -> np.ndarray:
    return np.asarray(depth_u16, dtype=np.float32) / DEPTH_SCALE_FACTOR


def add_depth_noise(
    depth_m: np.ndarray,
    rng: np.random.Generator,
    stddev_fraction: float = 0.005,
    dropout_prob: float = 0.002,
) -> np.ndarray:
    """Sensor-like depth noise: multiplicative Gaussian + random dropouts.

    (upstream ``image_processing/depth_noise.py``, an optional datagen
    augmentation). The draws come from the caller's explicit numpy
    generator: the same generator state gives the JAX package's noise.
    """
    noise = rng.normal(1.0, stddev_fraction, size=depth_m.shape)
    out = depth_m * noise
    dropout = rng.uniform(size=depth_m.shape) < dropout_prob
    return np.where(dropout, 0.0, out).astype(np.float32)
