"""Host-side image helpers of the port (a copy of the part of
``triad_tpu/data/images.py`` the synthetic datasets need; decoding and
augmentation wait for the file-backed datasets). Images are HWC float32,
as in the JAX package."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def imagenet_normalize(img: np.ndarray) -> np.ndarray:
    """img (H, W, 3) in [0,1] -> normalized float32."""
    return ((img - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def clean_image(img: np.ndarray) -> np.ndarray:
    """Reference clean_transform (dataset.py:47-51): just normalize."""
    return imagenet_normalize(img)
