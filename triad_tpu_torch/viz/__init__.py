"""Grounding visualization of the port (mirrors ``triad_tpu/viz``)."""

from triad_tpu_torch.viz.heatmaps import (
    AudioVisualizer,
    TextVisualizer,
    denormalize_frame,
    overlay_heatmap,
    patches_to_heatmaps,
)

__all__ = [
    "AudioVisualizer",
    "TextVisualizer",
    "denormalize_frame",
    "overlay_heatmap",
    "patches_to_heatmaps",
]
