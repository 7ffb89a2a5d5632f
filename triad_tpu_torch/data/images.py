"""Host-side image decode + augmentation in numpy (HWC float32): the
port's copy of ``triad_tpu/data/images.py`` (bit-equal outputs for the
same inputs and draws).

Replaces the reference's torchvision/torch augmentation with numpy
equivalents producing the same distributions:

* TV path (reference dataset.py:32-44, LocalCaptionDataset transform):
  RandomHorizontalFlip, RandomAffine(translate 0.1), ColorJitter
  (brightness/contrast/saturation 0.2), ImageNet normalize. No resize —
  the reference assumes pre-sized 224x224 images on disk; we bilinear-
  resize if needed (strictly more robust).
* AV path (reference dataset.py:91-135, load_and_preprocess_video):
  /255, bilinear resize to 224, hflip p=0.5, brightness U(0.6,1.4) p=0.8
  with nested contrast p=0.5 and saturation p=0.5, clamp [0,1],
  ImageNet normalize — replicated operation-for-operation.

Output layout is HWC (NHWC batches), as in the JAX package; the models
of the port take NHWC images too.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def imagenet_normalize(img: np.ndarray) -> np.ndarray:
    """img (H, W, 3) in [0,1] -> normalized float32."""
    return ((img - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize (align_corners=False semantics, matching
    torch.nn.functional.interpolate at dataset.py:98-100)."""
    h, w = img.shape[:2]
    if h == size and w == size:
        return img.astype(np.float32)
    try:
        import cv2

        return cv2.resize(
            img.astype(np.float32), (size, size), interpolation=cv2.INTER_LINEAR
        )
    except ImportError:
        # numpy fallback: half-pixel-center bilinear.
        ys = (np.arange(size) + 0.5) * h / size - 0.5
        xs = (np.arange(size) + 0.5) * w / size - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x1 = np.clip(x0 + 1, 0, w - 1)
        wy = np.clip(ys - y0, 0, 1)[:, None, None]
        wx = np.clip(xs - x0, 0, 1)[None, :, None]
        img = img.astype(np.float32)
        top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
        bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
        return (top * (1 - wy) + bot * wy).astype(np.float32)


def load_image(path: str, size: int = 224) -> np.ndarray:
    """Decode to RGB float32 [0,1] (H, W, 3), resized to ``size``."""
    from PIL import Image

    with Image.open(path) as im:
        img = np.asarray(im.convert("RGB"), np.float32) / 255.0
    return resize_bilinear(img, size)


# ---------------------------------------------------------------------------
# AV-path augmentation (dataset.py:104-126, exact replica)
# ---------------------------------------------------------------------------


def image_mean(img: np.ndarray, axis) -> np.ndarray:
    """Per-channel mean over the pixel axes, summed in float64 and rounded
    once to float32.

    The one departure from the JAX package's copy, which takes numpy's
    float32 mean: over axes that are not the innermost, numpy sums in
    float32 one pixel after another, and on uint8-quantized pixels the
    rounding errors add up with a bias: up to 6e-6 off the exact mean of a
    224^2 image, 2.4e-4 after the contrast factor and the ImageNet
    normalize. The device path (data/device_aug.py) sums in its own order,
    so both take the exact sum, and the host and device batches agree to
    float32 rounding at every image size."""
    return img.mean(axis=axis, keepdims=True, dtype=np.float64).astype(np.float32)



def draw_av_params(rng: np.random.Generator) -> dict:
    """The AV augmentation's random draws (exact reference sequence,
    dataset.py:104-126), separated from the pixel math so a batch can
    be augmented with vectorized numpy (apply_av_batch)."""
    p = {"flip": rng.random() < 0.5, "brightness": 1.0, "contrast": 1.0,
         "saturation": 1.0}
    if rng.random() < 0.8:
        p["brightness"] = float(rng.uniform(0.6, 1.4))
        if rng.random() < 0.5:
            p["contrast"] = float(rng.uniform(0.6, 1.4))
        if rng.random() < 0.5:
            p["saturation"] = float(rng.uniform(0.6, 1.4))
    return p


def augment_av_frame(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """img (H, W, 3) in [0,1]; returns augmented, clamped, normalized.

    Exact replica of the reference recipe (dataset.py:104-126): hflip
    p=0.5; brightness U(0.6,1.4) p=0.8 with nested contrast p=0.5 and
    saturation p=0.5; clamp; ImageNet normalize."""
    p = draw_av_params(rng)
    if p["flip"]:
        img = img[:, ::-1]
    img = img * p["brightness"]
    if p["contrast"] != 1.0:
        mean = image_mean(img, (0, 1))
        img = (img - mean) * p["contrast"] + mean
    if p["saturation"] != 1.0:
        gray = img.mean(axis=2, keepdims=True)
        img = img * p["saturation"] + gray * (1 - p["saturation"])
    img = np.clip(img, 0.0, 1.0)  # dataset.py:132
    return imagenet_normalize(img)


def apply_av_batch(imgs: np.ndarray, params: list) -> np.ndarray:
    """Batched AV augmentation: imgs (B, H, W, 3) in [0,1], one
    draw_av_params dict per row. Same math as augment_av_frame applied
    with ~8 vectorized passes instead of ~8*B small ones (the per-item
    path is GIL-bound at chip-rate ingest). Returns normalized float32.
    """
    imgs = np.asarray(imgs, np.float32)
    flip = np.array([p["flip"] for p in params])
    if flip.any():
        imgs = imgs.copy()
        imgs[flip] = imgs[flip, :, ::-1]
    b = np.array([p["brightness"] for p in params], np.float32)
    imgs = imgs * b[:, None, None, None]
    cf = np.array([p["contrast"] for p in params], np.float32)
    if (cf != 1.0).any():
        mean = image_mean(imgs, (1, 2))
        cfb = cf[:, None, None, None]
        imgs = (imgs - mean) * cfb + mean
    sf = np.array([p["saturation"] for p in params], np.float32)
    if (sf != 1.0).any():
        gray = imgs.mean(axis=3, keepdims=True)
        sfb = sf[:, None, None, None]
        imgs = imgs * sfb + gray * (1 - sfb)
    np.clip(imgs, 0.0, 1.0, out=imgs)
    imgs -= IMAGENET_MEAN
    imgs /= IMAGENET_STD
    return imgs


# ---------------------------------------------------------------------------
# TV-path augmentation (dataset.py:32-44 semantics)
# ---------------------------------------------------------------------------


def _adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(img * factor, 0.0, 1.0)


def _adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    # torchvision blends with the mean of the grayscale image.
    gray_mean = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).mean()
    return np.clip(factor * img + (1 - factor) * gray_mean, 0.0, 1.0)


def _adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (
        0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    )[..., None]
    return np.clip(factor * img + (1 - factor) * gray, 0.0, 1.0)


def _translate(img: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """Integer translation with zero fill (RandomAffine translate)."""
    out = np.zeros_like(img)
    h, w = img.shape[:2]
    ys = slice(max(dy, 0), min(h + dy, h))
    xs = slice(max(dx, 0), min(w + dx, w))
    ys_src = slice(max(-dy, 0), min(h - dy, h))
    xs_src = slice(max(-dx, 0), min(w - dx, w))
    out[ys, xs] = img[ys_src, xs_src]
    return out


def draw_tv_params(rng: np.random.Generator, h: int, w: int) -> dict:
    """Draw the TV augmentation parameters, consuming ``rng`` in EXACTLY
    the order ``augment_tv_image`` historically did (flip, dx, dy,
    permutation, then one factor per APPLIED op) — so a params-based
    apply (host batched or on-device) reproduces the per-item path
    draw-for-draw. perm[k] = op index applied k-th (0 brightness,
    1 contrast, 2 saturation); factors[k] = its factor."""
    flip = bool(rng.random() < 0.5)
    dx = int(round(rng.uniform(-0.1, 0.1) * w))
    dy = int(round(rng.uniform(-0.1, 0.1) * h))
    perm = rng.permutation(3)
    factors = [float(rng.uniform(0.8, 1.2)) for _ in perm]
    return {
        "flip": flip, "dx": dx, "dy": dy,
        "perm": [int(i) for i in perm], "factors": factors,
    }


def apply_tv_image(img: np.ndarray, p: dict) -> np.ndarray:
    """Apply draw_tv_params output to an (H, W, 3) [0,1] image — the
    same math as the historical in-place path, normalized float32."""
    if p["flip"]:
        img = img[:, ::-1]
    img = _translate(img, p["dx"], p["dy"])
    ops = (_adjust_brightness, _adjust_contrast, _adjust_saturation)
    for op_idx, f in zip(p["perm"], p["factors"]):
        img = ops[op_idx](img, f)
    return imagenet_normalize(img)


def augment_tv_image(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Reference LocalCaptionDataset train transform (dataset.py:32-44):
    hflip p=0.5, translate U(-0.1, 0.1) of the size, color jitter 0.2
    (random order, as torchvision does), ImageNet normalize."""
    h, w = img.shape[:2]
    return apply_tv_image(img, draw_tv_params(rng, h, w))


def clean_image(img: np.ndarray) -> np.ndarray:
    """Reference clean_transform (dataset.py:47-51): just normalize."""
    return imagenet_normalize(img)
