"""The port's utils (metrics logger, step timer, NaN guards) and viz
(heatmaps, overlays, the token-grid figure, the two visualizers) against
the JAX package's on the CPU. Every comparison is exact: the JSONL lines
as text, the heatmaps and figures as numpy arrays, bit for bit."""

import json
import sys
import time

import numpy as np
import pytest
import torch


def _records():
    return [
        ({"train_loss": np.float32(1.25), "epoch": 3, "phase": "full_joint",
          "lr": 1e-4, "flag": True, "none": None, "arr": np.array(2.5, np.float32),
          "t": torch.tensor(0.75), "obj": (1, 2)}, 7),
        ({"val_train_loss": 0.5}, None),
        ({"global_step": 4, "x": np.int64(9)}, 12),
    ]


def test_metrics_logger_lines_equal_jax(tmp_path):
    from triad_tpu.utils.logging import MetricsLogger as JaxLogger
    from triad_tpu_torch.utils.logging import MetricsLogger

    for cls, out in ((JaxLogger, tmp_path / "jax"), (MetricsLogger, tmp_path / "port")):
        logger = cls(str(out))
        for record, step in _records():
            logger.log(record, step=step)
        logger.log_image("viz_av_0", "/x/av_0.png", step=5)
        logger.log_video("viz_av_0_attention", "/x/av_0_attention.mp4", step=5)
        logger.log_image("viz_tv_0", "/x/tv_0.png")
        logger.close()
    got = (tmp_path / "port" / "metrics.jsonl").read_text()
    want = (tmp_path / "jax" / "metrics.jsonl").read_text()
    assert got == want and len(got.splitlines()) == 6


def test_metrics_logger_primary_is_rank_zero(tmp_path, monkeypatch):
    """Only rank 0 of an initialized torch.distributed writes metrics."""
    from triad_tpu_torch.utils.logging import MetricsLogger

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    logger = MetricsLogger(str(tmp_path))
    logger.log({"a": 1.0}, step=0)
    logger.close()
    assert (tmp_path / "metrics.jsonl").exists() is False


def test_step_timer_host_clock():
    from triad_tpu_torch.utils import StepTimer

    timer = StepTimer(window=2)
    assert timer.metrics(8) == {}
    for label in ("av_focus", "av_focus", "tv_warmup", "tv_warmup"):
        time.sleep(0.01)
        timer.tick(label)
    m = timer.metrics(8)
    assert [label for label, _ in timer.history] == ["av_focus", "tv_warmup", "tv_warmup"]
    assert all(s >= 0.01 for _, s in timer.history)
    window = [s for _, s in timer.history[-2:]]  # the window holds the last 2
    assert m["step_time_ms"] == pytest.approx(sum(window) / 2 * 1e3)
    assert m["clips_per_sec"] == pytest.approx(8 / (sum(window) / 2))
    timer.restart()
    timer.tick("full_joint")  # no interval: the last tick was forgotten
    assert len(timer.history) == 3


def test_nan_guards_match_jax():
    import jax.numpy as jnp

    from triad_tpu.utils import debug as J
    from triad_tpu_torch.utils import (nonfinite_paths, skip_nonfinite_updates,
                                       tree_all_finite)

    rng = np.random.default_rng(0)
    good = {"a": rng.normal(size=(3, 2)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32),
            "steps": np.arange(3, dtype=np.int32)}
    bad = dict(good, b=np.array([1.0, np.nan, 2.0, np.inf], np.float32))
    for tree in (good, bad):
        named = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
        jtree = {k: jnp.asarray(v) for k, v in tree.items()}
        assert bool(tree_all_finite(named)) == bool(J.tree_all_finite(jtree))
        assert nonfinite_paths(named) == J.nonfinite_paths(jtree)
        assert nonfinite_paths(list(named.items())) == J.nonfinite_paths(jtree)
        floats = {k: v for k, v in named.items() if v.is_floating_point()}
        gated, ok = skip_nonfinite_updates(floats)
        jgated, jok = J.skip_nonfinite_updates({k: jtree[k] for k in floats})
        assert bool(ok) == bool(jok)
        for k in floats:
            np.testing.assert_array_equal(gated[k].numpy(), np.asarray(jgated[k]))


def test_enable_nan_debugging():
    from triad_tpu_torch.utils import enable_nan_debugging

    try:
        enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        with pytest.raises(NotImplementedError, match="jax_debug_infs"):
            enable_nan_debugging(infs=True)
    finally:
        enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def _viz_inputs():
    rng = np.random.default_rng(1)
    frame = np.clip(rng.normal(size=(56, 56, 3)), -2.5, 2.5).astype(np.float32)
    sims = rng.normal(size=(5, 16)).astype(np.float32)
    return frame, sims


def test_heatmaps_bit_equal_jax():
    from triad_tpu.viz import heatmaps as J
    from triad_tpu_torch.viz import heatmaps as P

    frame, sims = _viz_inputs()
    hm, jhm = P.patches_to_heatmaps(sims, 4, 56), J.patches_to_heatmaps(sims, 4, 56)
    np.testing.assert_array_equal(hm, jhm)
    rgb = P.denormalize_frame(frame)
    np.testing.assert_array_equal(rgb, J.denormalize_frame(frame))
    for h in hm:
        np.testing.assert_array_equal(P.overlay_heatmap(rgb, h), J.overlay_heatmap(rgb, h))
    np.testing.assert_array_equal(P._colormap(np.linspace(-0.5, 1.5, 101)),
                                  J._colormap(np.linspace(-0.5, 1.5, 101)))


def _canvas(fig):
    import matplotlib.pyplot as plt

    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return out


def test_token_grid_figure_bit_equal_jax():
    from triad_tpu.viz import heatmaps as J
    from triad_tpu_torch.viz import heatmaps as P

    frame, sims = _viz_inputs()
    hm = P.patches_to_heatmaps(sims, 4, 56)
    rgb = P.denormalize_frame(frame)
    titles = [f"Token: t{i}" for i in range(len(hm))]
    got = _canvas(P._token_grid_figure(rgb, hm, titles, None))
    want = _canvas(J._token_grid_figure(rgb, hm, titles, None))
    np.testing.assert_array_equal(got, want)


def test_token_grid_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is not installed the grid is drawn by PIL: each
    tile is overlay_heatmap's pixels, under a title band."""
    from PIL import Image

    from triad_tpu_torch.viz import heatmaps as P

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    frame, sims = _viz_inputs()
    hm = P.patches_to_heatmaps(sims, 4, 56)
    rgb = P.denormalize_frame(frame)
    out = tmp_path / "grid.png"
    img = P._token_grid_figure(rgb, hm, [f"t{i}" for i in range(5)], str(out))
    arr = np.asarray(Image.open(out))
    np.testing.assert_array_equal(arr, np.asarray(img))
    band = P.TITLE_ROWS
    assert arr.shape == (2 * (56 + band), 4 * 56, 3)
    for i in range(5):
        r, c = divmod(i, 4)
        top = r * (56 + band) + band
        np.testing.assert_array_equal(arr[top:top + 56, c * 56:(c + 1) * 56],
                                      P.overlay_heatmap(rgb, hm[i]))


def test_visualizers_write_files(tmp_path):
    from triad_tpu_torch.viz import AudioVisualizer, TextVisualizer

    frame, _ = _viz_inputs()
    audio = (np.random.default_rng(2).normal(size=1600) * 0.1).astype(np.float32)
    rng = np.random.default_rng(3)

    def sim_av(f, a):
        assert f.shape == (1, 56, 56, 3) and a.shape == (1, 1600)
        return rng.normal(size=(7, 16)).astype(np.float32)

    def sim_tv(f, text):
        tokens = text.split()
        return rng.normal(size=(len(tokens), 16)).astype(np.float32), tokens

    av = AudioVisualizer(patch_size=14, image_size=56)
    av.plot_audio_token_attentions(sim_av, frame, audio, str(tmp_path / "av.png"),
                                   num_tokens_to_show=3)
    writer = av.make_attention_video(sim_av, frame, audio, str(tmp_path / "av.mp4"))
    assert writer in ("native h264", "cv2 mp4v + native mux", "cv2 mp4v, silent")
    TextVisualizer(patch_size=14, image_size=56).plot_token_attentions(
        sim_tv, frame, "a red ball", str(tmp_path / "tv.png"))
    for name in ("av.png", "av.mp4", "tv.png"):
        assert (tmp_path / name).stat().st_size > 0, name
    assert not list(tmp_path.glob("*.temp.mp4"))


def test_profile_trace_writes_chrome_trace(tmp_path):
    from triad_tpu_torch.utils import profile_trace

    with profile_trace(str(tmp_path / "profile")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    assert trace["traceEvents"]
