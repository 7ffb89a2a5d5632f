"""The trace's digest on a made-up trace: the window between the marker
kernels or within the host-side span, the union of device intervals (a side stream's kernel
counted once), the idle gaps labelled by the host's op meanwhile; and the
readers that take the device's idle share and the step's MFU from it and
from the untraced window."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

import devtrace
import harness


class _Event:
    def __init__(self, name, start, length, device=DeviceType.CUDA):
        self._n, self._s, self._d, self._t = name, start, length, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def end_ns(self):
        return self._s + self._d

    def device_type(self):
        return self._t

    def is_user_annotation(self):
        return False


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


EVENTS = [
    _Event("void at::native::spin_kernel(long)", 0, 5),
    _Event("gemm", 100, 200),
    _Event("side_stream_gemm", 200, 300),  # overlaps gemm
    _Event("Memcpy DtoD (Device -> Device)", 700, 100),
    _Event("direct_copy_kernel", 900, 100),
    _Event("void at::native::spin_kernel(long)", 2000, 5),
    _Event("outside", 2500, 100),
    _Event("aten::mm", 450, 300, DeviceType.CPU),
    _Event("cudaMalloc", 1200, 500, DeviceType.CPU),
]


def test_digest():
    d = devtrace.digest(_prof(EVENTS), 2000e-9)
    assert d.window_s == pytest.approx(2000e-9)
    assert d.busy_s == pytest.approx(600e-9)  # [100, 500], [700, 800], [900, 1000]
    assert d.kernels == 3 and "outside" not in d.by_name
    assert d.transfers == {"Memcpy DtoD (Device -> Device)": pytest.approx(100e-9)}
    assert [name for name, _ in d.gaps] == ["cudaMalloc", "aten::mm", "no host event",
                                            "no host event"]
    assert d.gaps[0][1] == pytest.approx(1000e-9)
    assert d.seconds(("COPY",)) == pytest.approx(100e-9)
    # 300 ns busy a traced step against the untraced window's 400 ns a step
    ctx = SimpleNamespace(digest=d, steps=2, untraced=SimpleNamespace(steps=3, seconds=1200e-9))
    assert harness.load_metric("device_idle_pct").read(ctx) == pytest.approx(25.0)
    assert harness.load_metric("launches_per_step").read(ctx) == pytest.approx(1.5)
    assert harness.load_metric("copy_ms_per_step").read(ctx) == pytest.approx(1e-4)


def test_digest_needs_markers_that_span_the_window():
    with pytest.raises(RuntimeError, match="marker"):
        devtrace.digest(_prof(EVENTS[1:]), 2000e-9)
    with pytest.raises(RuntimeError, match="marker"):
        devtrace.digest(_prof(EVENTS), 10e-6)


def test_the_host_span_bounds_a_trace_of_host_ops():
    span = _Event(devtrace.WINDOW, 50, 1000, DeviceType.CPU)
    d = devtrace.digest(_prof(EVENTS + [span]), 0.0)
    assert d.window_s == pytest.approx(1000e-9)
    assert d.busy_s == pytest.approx(600e-9)


def test_step_mfu_reads_the_untraced_window():
    import costs

    cell = harness.load_cell("perf-joint-b64")
    m = cell.config["model"]
    kept = [list(range(m["hubert"]["num_layers"]))] * 3
    ctx = SimpleNamespace(config=m, traffic=cell.traffic,
                          untraced=SimpleNamespace(steps=3, seconds=2.0, kept=kept))
    want = 300.0 * costs.step_flops(m, cell.traffic, len(kept[0])) / (costs.PEAK_BF16 * 2.0)
    assert harness.load_metric("step_mfu").read(ctx) == pytest.approx(want)
