"""Logging, profiling and numerical guards of the port (mirrors
``triad_tpu/utils``)."""

from triad_tpu_torch.utils.debug import (
    enable_nan_debugging,
    nonfinite_paths,
    skip_nonfinite_updates,
    tree_all_finite,
)
from triad_tpu_torch.utils.logging import MetricsLogger
from triad_tpu_torch.utils.profiling import StepTimer, profile_trace

__all__ = [
    "MetricsLogger",
    "StepTimer",
    "enable_nan_debugging",
    "nonfinite_paths",
    "profile_trace",
    "skip_nonfinite_updates",
    "tree_all_finite",
]
