"""Host-side video frame decode: the port's copy of
``triad_tpu/data/video.py``.

Replaces the reference's torchcodec path (dataset.py:91-135): pick ONE
uniformly-random frame of the clip (the reference's ``sample_fps`` arg is
accepted-but-ignored, dataset.py:91-95 — we drop it), /255, bilinear
resize to 224, optional augmentation, clamp, ImageNet normalize.

Backend: OpenCV (cv2.VideoCapture) when available, else the ffmpeg
binary. Both gated; failures raise and the dataset layer converts them
to the reference's zero-frame sentinel (dataset.py:205-207).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from triad_tpu_torch.data.images import augment_av_frame, imagenet_normalize, resize_bilinear


def _decode_random_frame_cv2(path: str, rng: np.random.Generator) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(str(path))
    try:
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if n <= 0:
            ok, frame = cap.read()
            if not ok:
                raise RuntimeError(f"no frames in {path}")
        else:
            idx = int(rng.integers(0, n))
            cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
            ok, frame = cap.read()
            if not ok:  # seek can fail near EOF; fall back to frame 0
                cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
                ok, frame = cap.read()
                if not ok:
                    raise RuntimeError(f"decode failed for {path}")
        return frame[:, :, ::-1].astype(np.float32) / 255.0  # BGR -> RGB
    finally:
        cap.release()


def _decode_random_frame_native(
    path: str, rng: np.random.Generator
) -> np.ndarray:
    """Native demux + libavcodec decode (data/mp4.py), no cv2."""
    from triad_tpu_torch.data.mp4 import extract_random_frame

    rgb = extract_random_frame(path, rng)
    return rgb.astype(np.float32) / 255.0


def load_video_frame(
    path: str,
    rng: Optional[np.random.Generator] = None,
    size: int = 224,
    apply_augmentation: bool = True,
) -> np.ndarray:
    """One random frame -> (size, size, 3) normalized float32.

    Matches reference load_and_preprocess_video (dataset.py:91-135):
    random frame, /255, bilinear resize, augment (train) or not (eval),
    clamp, ImageNet normalize. Decode order: native demux+libavcodec
    (framework-owned, one FFI call), cv2 fallback for anything it
    can't handle.
    """
    rng = rng or np.random.default_rng()
    try:
        from triad_tpu_torch.data import native

        if not native.available() or not hasattr(
            native._load(), "avdec_decode_video_frame"
        ):
            raise ValueError("native video decode unavailable")
        frame = _decode_random_frame_native(path, rng)
    except Exception:  # noqa: BLE001 — cv2 handles the long tail
        frame = _decode_random_frame_cv2(path, rng)
    frame = resize_bilinear(frame, size)
    if apply_augmentation:
        return augment_av_frame(frame, rng)
    return imagenet_normalize(np.clip(frame, 0.0, 1.0))
