"""On-device augmentation: the host ships raw uint8 frames (and int16
audio) with per-sample draw parameters, and the augment math runs on the
device as plain torch ops. The port's counterpart of
``triad_tpu/data/device_aug.py`` (there ``jax.jit`` of ``jnp`` code, not
a Pallas kernel), with the same math: the AV path is
``images.apply_av_batch`` (flip, brightness, contrast about the
per-image mean, saturation, clip, ImageNet normalize), the TV path is
``images.apply_tv_image`` (flip, integer translate with zero fill, the
three jitter ops in the drawn order, normalize).

Parameters are drawn on the host with the same (seed, epoch, batch, idx)
keys as every other augmentation path (exact resume); shipping uint8
instead of normalized float32 cuts the image bytes 4x, int16 audio the
audio bytes 2x.

The ``device_ingest_*`` callables are what a ``pipeline.Prefetcher``
runs on its side stream once a batch is on the device. They take numpy
arrays or tensors; numpy arrays are moved to ``device`` (default: the
device of the batch's tensors, else ``"cuda"``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from triad_tpu_torch.data.images import IMAGENET_MEAN, IMAGENET_STD


def av_param_arrays(params: List[dict]) -> Dict[str, np.ndarray]:
    """draw_av_params dicts -> plain arrays for device transfer."""
    return {
        "aug_flip": np.array([p["flip"] for p in params], np.bool_),
        "aug_brightness": np.array(
            [p["brightness"] for p in params], np.float32
        ),
        "aug_contrast": np.array([p["contrast"] for p in params], np.float32),
        "aug_saturation": np.array(
            [p["saturation"] for p in params], np.float32
        ),
    }


def tv_param_arrays(params: List[dict]) -> Dict[str, np.ndarray]:
    """draw_tv_params dicts -> plain arrays for device transfer."""
    return {
        "aug_flip": np.array([p["flip"] for p in params], np.bool_),
        "aug_dx": np.array([p["dx"] for p in params], np.int32),
        "aug_dy": np.array([p["dy"] for p in params], np.int32),
        "aug_perm": np.array([p["perm"] for p in params], np.int32),
        "aug_factors": np.array(
            [p["factors"] for p in params], np.float32
        ),
    }


def _normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def _image_mean(x: torch.Tensor) -> torch.Tensor:
    """Per-image, per-channel mean over (H, W), summed in float64 and
    rounded once, as the host path's ``images.image_mean``."""
    return x.mean(dim=(1, 2), keepdim=True, dtype=torch.float64).to(torch.float32)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as numpy rounds it: a divisor held as a CPU scalar
    makes CUDA multiply by its reciprocal, one float32 rounding off the
    quotient in ~2% of the elements."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


def device_augment_av(frames_u8, flip, brightness, contrast, saturation):
    """(B, H, W, 3) uint8 + per-sample params -> normalized float32, on
    the tensors' device.

    Identity factors (1.0 / flip=False) make every op a no-op, so one
    sequence of ops covers all draw combinations.
    """
    x = _div(frames_u8.to(torch.float32), 255.0)
    x = torch.where(_col(flip), x.flip(2), x)
    x = x * _col(brightness)
    mean = _image_mean(x)
    x = (x - mean) * _col(contrast) + mean
    gray = x.mean(dim=3, keepdim=True)
    s = _col(saturation)
    x = x * s + gray * (1.0 - s)
    x = x.clamp(0.0, 1.0)
    return _normalize(x)


def audio_i16_to_f32(a16: torch.Tensor) -> torch.Tensor:
    return _div(a16.to(torch.float32), 32767.0)


_TV_MAX_SHIFT = 32  # >= round(0.1 * image_size) for 224-class inputs


def device_augment_tv(frames_u8, flip, dx, dy, perm, factors):
    """(B, H, W, 3) uint8 + draw_tv_params arrays -> normalized float32.

    Same math as images.apply_tv_image (reference LocalCaptionDataset
    transform, dataset.py:32-44): hflip, integer translate with zero
    fill, the three jitter ops applied in the drawn ORDER (perm[k] = op
    applied k-th with factors[k]), ImageNet normalize. The translate
    reads each sample's window of a zero-padded copy at its own offset
    (one gather; a start past the padding is clamped, as JAX's
    dynamic_slice clamps it); the ordered jitter evaluates the three
    candidate ops per stage and selects.
    """
    x = _div(frames_u8.to(torch.float32), 255.0)
    x = torch.where(_col(flip), x.flip(2), x)

    b, h, w = x.shape[0], x.shape[1], x.shape[2]
    pad = _TV_MAX_SHIFT
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    # out[y, x] = img[y - dy, x - dx], zero outside (images._translate)
    y0 = (pad - dy.to(torch.int64)).clamp(0, 2 * pad)
    x0 = (pad - dx.to(torch.int64)).clamp(0, 2 * pad)
    rows = y0[:, None] + torch.arange(h, device=x.device)[None, :]
    cols = x0[:, None] + torch.arange(w, device=x.device)[None, :]
    bi = torch.arange(b, device=x.device)[:, None, None]
    x = xp[bi, rows[:, :, None], cols[:, None, :]]

    for k in range(3):
        f = _col(factors[:, k])
        sel = _col(perm[:, k])
        bright = (x * f).clamp(0.0, 1.0)
        gray = (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]
        gmean = _image_mean(gray)
        contr = (f * x + (1.0 - f) * gmean).clamp(0.0, 1.0)
        sat = (f * x + (1.0 - f) * gray).clamp(0.0, 1.0)
        x = torch.where(sel == 0, bright, torch.where(sel == 1, contr, sat))
    return _normalize(x)


def _device_of(batch: Dict, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    for v in batch.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cuda")


def _put(v, device: torch.device):
    """A numpy array or tensor on ``device`` (non-blocking from pinned
    memory); anything else passes through."""
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(v)
    if isinstance(v, torch.Tensor):
        return v.to(device, non_blocking=True)
    return v


def device_put(batch: Dict, device: Optional[str] = None) -> Dict:
    """Every array of ``batch`` on the device, nothing computed."""
    dev = _device_of(batch, device)
    return {k: _put(v, dev) for k, v in batch.items()}


def device_ingest_tv(batch: Dict, device: Optional[str] = None) -> Dict:
    """Prefetcher ``device_put`` callable for raw TV batches: uint8
    frames + draw params + pre-tokenized ids at wire width; augment
    math on the device. Passes host-augmented batches through (moved)."""
    if "frames_u8" not in batch:
        return device_put(batch, device)
    dev = _device_of(batch, device)
    frames, flip, dx, dy, perm, factors, ids, mask = (_put(batch[k], dev) for k in (
        "frames_u8", "aug_flip", "aug_dx", "aug_dy", "aug_perm", "aug_factors",
        "token_ids", "text_mask"))
    out = {
        "images": device_augment_tv(frames, flip, dx, dy, perm, factors),
        "token_ids": ids,
        "text_mask": mask,
    }
    if "captions" in batch:
        out["captions"] = batch["captions"]
    return out


def device_ingest_av(batch: Dict, device: Optional[str] = None) -> Dict:
    """Prefetcher ``device_put`` callable for raw AV batches: uint8
    frames + int16 audio + params at wire width (4x / 2x fewer
    host-to-device bytes than fp32), augmented and converted on the
    device. Passes already-augmented batches through (moved)."""
    if "frames_u8" not in batch:
        return device_put(batch, device)
    dev = _device_of(batch, device)
    frames, flip, bright, contr, sat = (_put(batch[k], dev) for k in (
        "frames_u8", "aug_flip", "aug_brightness", "aug_contrast", "aug_saturation"))
    images = device_augment_av(frames, flip, bright, contr, sat)
    if "audio_i16" in batch:
        audio = audio_i16_to_f32(_put(batch["audio_i16"], dev))
    else:
        audio = _put(batch["audio"], dev)
    out = {"images": images, "audio": audio}
    if "video_paths" in batch:
        out["video_paths"] = batch["video_paths"]
    return out
