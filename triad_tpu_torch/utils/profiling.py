"""Profiling / tracing hooks (the port's ``triad_tpu/utils/profiling.py``).

``profile_trace`` wraps a region with ``torch.profiler`` and writes a
Chrome trace (``trace.json``) into its directory; ``StepTimer`` gives
the step time and clips/sec of the device that runs the steps.

A train step of the port returns once its kernels are queued, before the
card has run them, so a host clock read after each step measures the
launch rate, not the card's. On a CUDA device ``StepTimer.tick`` records
a CUDA event on the current stream instead (no synchronisation), and
``metrics`` waits for the newest event once, at the log cadence: the
time between two consecutive events is the time the card took from the
end of one step to the end of the next, host stalls included.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True):
    """torch.profiler over the region (CPU, and CUDA when a card is
    present); the Chrome trace goes to ``logdir/trace.json``. A no-op
    when disabled or when the profiler cannot start."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 — a machine without CUPTI refuses the tracer
        print(f"profiler unavailable: {e}")
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Rolling step time + throughput over the last ``window`` steps.

    ``device``: a CUDA device times the card (events, see the module
    docstring); None or a CPU device times the host clock, as the JAX
    copy does. ``restart()`` forgets the last tick, so that work between
    steps (validation, a checkpoint) is not counted as a step. Every
    measured step is kept in ``history`` as (label, seconds)."""

    def __init__(self, window: int = 50, device=None):
        import torch

        self.window = window
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._times: List[float] = []
        self._last = None  # the previous tick: a CUDA event or a host time
        self._pending: List[Tuple[object, object, Optional[str]]] = []
        self.history: List[Tuple[Optional[str], float]] = []

    def tick(self, label: Optional[str] = None) -> None:
        if self._cuda:
            import torch

            now = torch.cuda.Event(enable_timing=True)
            now.record()
            if self._last is not None:
                self._pending.append((self._last, now, label))
        else:
            now = time.perf_counter()
            if self._last is not None:
                self._add(now - self._last, label)
        self._last = now

    def restart(self) -> None:
        self._last = None

    def _add(self, seconds: float, label: Optional[str]) -> None:
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        self.history.append((label, seconds))

    def _resolve(self) -> None:
        if not self._pending:
            return
        self._pending[-1][1].synchronize()
        for start, end, label in self._pending:
            self._add(start.elapsed_time(end) / 1e3, label)
        self._pending = []

    def metrics(self, clips_per_step: int) -> Dict[str, float]:
        self._resolve()
        if not self._times:
            return {}
        mean = sum(self._times) / len(self._times)
        return {
            "step_time_ms": mean * 1e3,
            "clips_per_sec": clips_per_step / mean,
        }
