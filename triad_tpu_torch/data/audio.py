"""Host-side audio helpers of the port (a copy of the part of
``triad_tpu/data/audio.py`` the retrieval eval needs; decoding waits for
the file-backed datasets)."""

from __future__ import annotations

import numpy as np


def pad_or_trim(audio: np.ndarray, num_samples: int, dtype=np.float32) -> np.ndarray:
    """Zero-pad (reference collate, dataset.py:264-276) or trim to a fixed
    length. dtype=np.int16 keeps packed storage audio at wire width."""
    out = np.zeros(num_samples, dtype)
    n = min(len(audio), num_samples)
    out[:n] = audio[:n]
    return out
