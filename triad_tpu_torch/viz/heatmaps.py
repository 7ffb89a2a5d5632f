"""Dense grounding visualization (host-side): the port's copy of
``triad_tpu/viz/heatmaps.py``.

Port of the reference's visualization semantics
(the reference's src/viz.py), preserved quirks and all:

  * patch sims are **squared before** upsampling (viz.py:62) and the
    normalized heatmap is **squared again** before colormapping
    (viz.py:76) — double squaring is intentional contrast shaping;
  * custom transparent->blue->red->yellow colormap (viz.py:21-27);
  * alpha-blend 0.30 onto the de-normalized frame (viz.py:73-82);
  * sims come from the *normalized* inference path
    (model.compute_similarity_matrix — pairwise_similarity here), NOT
    the unnormalized training sims (SURVEY §7.3 item 4);
  * attention video: one frame per audio token at fps=50 (~20 ms hop,
    viz.py:84-146); original audio muxed in via ffmpeg when available,
    silent fallback otherwise (viz.py:140-143).

The model-facing surface is a pair of visualizer classes mirroring the
reference API (AudioVisualizer / TextVisualizer) that consume an
``encode-and-similarity`` callback, keeping them framework-pure.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from triad_tpu_torch.data.images import IMAGENET_MEAN, IMAGENET_STD

# transparent -> blue -> red -> yellow (viz.py:21-27)
_CMAP_COLORS = np.array(
    [
        [0.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 1.0, 0.5],
        [1.0, 0.0, 0.0, 0.7],
        [1.0, 1.0, 0.0, 1.0],
    ],
    np.float32,
)


def _colormap(x: np.ndarray) -> np.ndarray:
    """Piecewise-linear RGBA colormap over [0,1] (matplotlib
    LinearSegmentedColormap.from_list equivalent for 4 stops)."""
    x = np.clip(x, 0.0, 1.0)
    idx = np.clip((x * 3).astype(np.int32), 0, 2)
    frac = x * 3 - idx
    lo = _CMAP_COLORS[idx]
    hi = _CMAP_COLORS[idx + 1]
    return lo + (hi - lo) * frac[..., None]


def denormalize_frame(frame: np.ndarray) -> np.ndarray:
    """ImageNet-normalized (H, W, 3) -> uint8 RGB (viz.py:110-114)."""
    img = frame * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def patches_to_heatmaps(
    patch_attention: np.ndarray, grid: int, image_size: int
) -> np.ndarray:
    """(N, P) token-level sims -> (N, H, W) pixel heatmaps: reshape to
    the patch grid, square, bilinear-upsample (viz.py:58-71)."""
    from triad_tpu_torch.data.images import resize_bilinear

    n = patch_attention.shape[0]
    patches = patch_attention.reshape(n, grid, grid) ** 2
    resized = []
    for p in patches:
        r = resize_bilinear(p[..., None], image_size)
        resized.append(r[..., 0] if r.ndim == 3 else r)  # cv2 squeezes 1-ch
    return np.stack(resized)


def overlay_heatmap(
    frame_rgb: np.ndarray, heatmap: np.ndarray, alpha: float = 0.30
) -> np.ndarray:
    """Min-max normalize, square again, colormap, alpha blend
    (viz.py:73-82)."""
    h = (heatmap - heatmap.min()) / (heatmap.max() - heatmap.min() + 1e-8)
    h = h * h
    colored = (_colormap(h)[..., :3] * 255).astype(np.uint8)
    return ((1 - alpha) * frame_rgb + alpha * colored).astype(np.uint8)


def _validate_inputs(frame: np.ndarray, audio: Optional[np.ndarray]) -> None:
    """Input-range guards (viz.py:29-36)."""
    assert -3 <= frame.min() <= 3, f"Frame min {frame.min()} outside normalized range"
    assert -3 <= frame.max() <= 3, f"Frame max {frame.max()} outside normalized range"
    if audio is not None:
        assert -2 <= audio.min() <= 2, f"Audio min {audio.min()} outside typical range"
        assert -2 <= audio.max() <= 2, f"Audio max {audio.max()} outside typical range"


def _token_grid_figure(
    frame_rgb: np.ndarray,
    heatmaps: np.ndarray,
    titles: Sequence[str],
    output_path: Optional[str],
):
    """Subplot grid of per-token overlays (viz.py:148-224 / 306-343):
    matplotlib's figure where matplotlib is installed (returns the
    figure), else ``_token_grid_image`` (returns the PIL image)."""
    try:
        import matplotlib
    except ImportError:
        return _token_grid_image(frame_rgb, heatmaps, titles, output_path)

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = heatmaps.shape[0]
    cols = min(4, n)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4.5 * cols, 4.5 * rows))
    axes = np.atleast_1d(axes).flatten()
    for i in range(n):
        axes[i].imshow(overlay_heatmap(frame_rgb, heatmaps[i]))
        axes[i].set_title(titles[i])
        axes[i].axis("off")
    for ax in axes[n:]:
        ax.axis("off")
    plt.tight_layout()
    if output_path:
        plt.savefig(output_path)
        plt.close(fig)
    return fig


TITLE_ROWS = 16  # pixel rows above each tile of _token_grid_image for its title


def _token_grid_image(
    frame_rgb: np.ndarray,
    heatmaps: np.ndarray,
    titles: Sequence[str],
    output_path: Optional[str],
):
    """The same grid without matplotlib: up to 4 overlays a row, each at
    the frame's own size under a white title band drawn by PIL, no
    resampling (the tiles are ``overlay_heatmap``'s pixels)."""
    from PIL import Image, ImageDraw

    n = heatmaps.shape[0]
    cols = min(4, n)
    rows = (n + cols - 1) // cols
    h, w = frame_rgb.shape[:2]
    canvas = np.full((rows * (h + TITLE_ROWS), cols * w, 3), 255, np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        top = r * (h + TITLE_ROWS) + TITLE_ROWS
        canvas[top:top + h, c * w:(c + 1) * w] = overlay_heatmap(frame_rgb, heatmaps[i])
    img = Image.fromarray(canvas)
    draw = ImageDraw.Draw(img)
    for i, title in enumerate(titles[:n]):
        r, c = divmod(i, cols)
        draw.text((c * w + 2, r * (h + TITLE_ROWS) + 2), str(title), fill=(0, 0, 0))
    if output_path:
        img.save(output_path)
    return img


class AudioVisualizer:
    """Audio-token attention overlays and videos (viz.py:11-235).

    ``similarity_fn(frame (1,H,W,3), audio (1,T)) -> (Na, Nv)`` must
    produce the normalized inference-path sims (pairwise_similarity of
    the encoded tokens).
    """

    def __init__(self, patch_size: int = 14, image_size: int = 224):
        self.patch_size = patch_size
        self.image_size = image_size
        self.num_patches = image_size // patch_size

    def get_attention_maps(self, similarity_fn, frame, audio) -> np.ndarray:
        _validate_inputs(frame, audio)
        sims = np.asarray(
            similarity_fn(frame[None], audio[None]), np.float32
        )
        return patches_to_heatmaps(sims, self.num_patches, self.image_size)

    def plot_audio_token_attentions(
        self,
        similarity_fn,
        frame: np.ndarray,
        audio: np.ndarray,
        output_path: Optional[str] = None,
        num_tokens_to_show: int = 5,
    ):
        """Evenly-spaced audio tokens -> overlay grid PNG (viz.py:148-224)."""
        heatmaps = self.get_attention_maps(similarity_fn, frame, audio)
        na = heatmaps.shape[0]
        if na == 0:
            print("No audio tokens found!")
            return None
        n_show = min(num_tokens_to_show, na)
        sel = np.linspace(0, na - 1, n_show).astype(int)
        frame_rgb = denormalize_frame(frame)
        return _token_grid_figure(
            frame_rgb,
            heatmaps[sel],
            [f"Audio token {i}" for i in sel],
            output_path,
        )

    def make_attention_video(
        self,
        similarity_fn,
        frame: np.ndarray,
        audio: np.ndarray,
        output_path: str,
        video_path: Optional[str] = None,
        fps: int = 50,
    ) -> str:
        """One overlay frame per audio token -> mp4 with the audio
        muxed in (viz.py:84-146). Writer order: fully-native H.264+AAC
        authoring when libx264 is linked (data/mp4.write_video_mp4 —
        the reference's codecs, no cv2 temp file), else cv2 mp4v + mux:
        ffmpeg copying the source track when available (reference
        parity, viz.py:128-137), else the framework's own MP4 muxer
        writing ``audio`` as an AAC/PCM track (data/mp4.py), else
        silent (viz.py:140-143). Returns the writer that wrote the file:
        "native h264", "cv2 mp4v + ffmpeg", "cv2 mp4v + native mux" or
        "cv2 mp4v, silent".
        """
        import cv2

        heatmaps = self.get_attention_maps(similarity_fn, frame, audio)
        frame_rgb = denormalize_frame(frame)
        out = Path(output_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        try:
            from triad_tpu_torch.data import native
            from triad_tpu_torch.data.mp4 import write_video_mp4

            if native.h264_supported():
                overlays = np.stack(
                    [overlay_heatmap(frame_rgb, hm) for hm in heatmaps]
                )
                write_video_mp4(
                    str(out), overlays, fps=fps,
                    audio=np.asarray(audio, np.float32), sample_rate=16_000,
                )
                return "native h264"
        except Exception as e:  # noqa: BLE001 — viz must never crash training
            print("native H.264 authoring failed, cv2 fallback:", e)
        temp = str(out.with_suffix(".temp.mp4"))
        writer = cv2.VideoWriter(
            temp, cv2.VideoWriter_fourcc(*"mp4v"), fps,
            (self.image_size, self.image_size),
        )
        for hm in heatmaps:
            overlay = overlay_heatmap(frame_rgb, hm)
            writer.write(overlay[:, :, ::-1])  # RGB -> BGR
        writer.release()
        if video_path is not None and shutil.which("ffmpeg"):
            try:
                subprocess.run(
                    [
                        "ffmpeg", "-v", "error", "-y",
                        "-i", temp, "-i", str(video_path),
                        "-map", "0:v", "-map", "1:a",
                        "-c:v", "copy", "-c:a", "aac", str(out),
                    ],
                    check=True, capture_output=True,
                )
                Path(temp).unlink()
                return "cv2 mp4v + ffmpeg"
            except subprocess.CalledProcessError as e:
                print("ffmpeg mux failed, silent fallback:", e.stderr.decode())
        try:
            from triad_tpu_torch.data import native
            from triad_tpu_torch.data.mp4 import mux_mp4

            if native.available():
                mux_mp4(str(out), temp, np.asarray(audio, np.float32), 16_000)
                Path(temp).unlink()
                return "cv2 mp4v + native mux"
        except Exception as e:  # noqa: BLE001 — viz must never crash training
            print("native mux failed, silent fallback:", e)
        Path(temp).rename(out)
        return "cv2 mp4v, silent"


class TextVisualizer:
    """Per-text-token attention overlays (viz.py:237-343).

    ``similarity_fn(frame (1,H,W,3), text) -> (sims (Nt, Nv), tokens)``
    with sims already truncated to valid tokens (viz.py:271-272) and
    tokens the surface strings.
    """

    def __init__(self, patch_size: int = 14, image_size: int = 224):
        self.patch_size = patch_size
        self.image_size = image_size
        self.num_patches = image_size // patch_size

    def plot_token_attentions(
        self,
        similarity_fn,
        frame: np.ndarray,
        text: str,
        output_path: Optional[str] = None,
    ):
        _validate_inputs(frame, None)
        sims, tokens = similarity_fn(frame[None], text)
        sims = np.asarray(sims, np.float32)
        heatmaps = patches_to_heatmaps(sims, self.num_patches, self.image_size)
        frame_rgb = denormalize_frame(frame)
        titles = [f"Token: {t}" for t in tokens]
        return _token_grid_figure(frame_rgb, heatmaps, titles, output_path)
