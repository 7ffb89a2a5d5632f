"""What the profiler's trace of a window says: the device's busy time
(the union of every kernel, memcpy and memset interval), its idle gaps
labelled by the host-side event running meanwhile (where the trace holds
the host's ops), and each kernel's device time by name.

``harness.window`` marks a traced window twice: a host-side span
(``record_function``), which a trace of the host's ops holds, and two
marker kernels (``torch.cuda._sleep``'s) at each end, which a trace of
the card's activity alone holds. The span gives the bounds where it is
in the trace, else the first and the last marker's starts (two at each
end, so that one lost record moves neither)."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

MARKER = "spin_kernel"
WINDOW = "benchmark.window"


def mark() -> None:
    """Two marker kernels, one end of a traced window."""
    import torch

    torch.cuda._sleep(1)
    torch.cuda._sleep(1)


@dataclass
class Digest:
    window_s: float  # the traced window
    busy_s: float
    kernels: int  # device kernels (memcpy and memset not counted)
    by_name: Dict[str, float] = field(default_factory=dict)  # kernel name -> device s
    counts: Dict[str, int] = field(default_factory=dict)
    transfers: Dict[str, float] = field(default_factory=dict)  # memcpy / memset name -> s
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # the longest idle gaps

    def seconds(self, patterns, case: bool = False) -> float:
        """Device seconds of the kernels whose name holds any pattern."""
        def hit(name):
            n = name if case else name.lower()
            return any((p if case else p.lower()) in n for p in patterns)

        return sum(s for n, s in self.by_name.items() if hit(n))


def _annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else e.name() == WINDOW


def digest(prof, host_s: float, top_gaps: int = 10) -> Digest:
    """The trace's digest; ``host_s``, the window's length on the host's
    clock, checks that the markers found span it."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    span = [e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if span:
        w0, w1 = span[0].start_ns(), span[0].end_ns()
    else:
        marks = sorted(e.start_ns() for e in events
                       if e.device_type() == DeviceType.CUDA and MARKER in e.name())
        if len(marks) < 2 or (marks[-1] - marks[0]) * 1e-9 < 0.5 * host_s:
            raise RuntimeError(f"the trace's {len(marks)} {MARKER!r} marker kernels do not "
                               f"bound a window of {host_s:.3f} s")
        w0, w1 = marks[0], marks[-1]
    dev_s, dev_e, host = [], [], []
    by_name, counts, transfers = defaultdict(float), defaultdict(int), defaultdict(float)
    kernels = 0
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # record_function ranges are mirrored onto the device's timeline
            # as annotations: they are no device work
            if s + d <= w0 or s >= w1 or d <= 0 or _annotation(e) or MARKER in e.name():
                continue
            dev_s.append(max(s, w0))
            dev_e.append(min(s + d, w1))
            name = e.name()
            if not name.startswith(("Memcpy", "Memset")):
                kernels += 1
                by_name[name] += d * 1e-9
                counts[name] += 1
            else:
                transfers[name] += d * 1e-9
        elif e.name() != WINDOW and w0 <= s < w1:
            host.append((s, s + d, e.name()))
    busy, gaps = 0.0, []
    if dev_s:
        order = np.argsort(dev_s)
        st = np.asarray(dev_s, dtype=np.int64)[order]
        en = np.maximum.accumulate(np.asarray(dev_e, dtype=np.int64)[order])
        new = np.ones(len(st), dtype=bool)
        new[1:] = st[1:] > en[:-1]
        seg_start = st[new]
        seg_end = np.append(en[np.flatnonzero(new)[1:] - 1], en[-1])
        busy = float((seg_end - seg_start).sum()) * 1e-9
        idle_start = np.concatenate([[w0], seg_end])
        idle_end = np.concatenate([seg_start, [w1]])
        length = idle_end - idle_start
        hs = np.asarray([h[0] for h in host], dtype=np.int64)
        he = np.asarray([h[1] for h in host], dtype=np.int64)
        for i in np.argsort(-length)[:top_gaps]:
            if length[i] <= 0:
                break
            mid = (idle_start[i] + idle_end[i]) // 2
            cover = np.flatnonzero((hs <= mid) & (he >= mid)) if len(hs) else []
            label = host[cover[np.argmax(hs[cover])]][2] if len(cover) else "no host event"
            gaps.append((label, float(length[i]) * 1e-9))
    return Digest((w1 - w0) * 1e-9, busy, kernels, dict(by_name), dict(counts), dict(transfers),
                  gaps)


def top_ops(d: Digest, n: int = 10) -> List[Tuple[str, float]]:
    return [(name[:160], s) for name, s in
            sorted(d.by_name.items(), key=lambda kv: -kv[1])[:n]]
