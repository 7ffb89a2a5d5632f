"""The GroupNorm statistics of HuBERT's conv_0 as csrc/frontend.cu takes
them: the "xt" layout's Gram pass (pallas_frontend.py:_stats_gram_kernel)
in fp64, through its plain twin ``conv0_stats_gram_plain`` (the kernel's
block order and precision), on the CPU.

The twin is held against the JAX Gram pass (Pallas in interpret mode, the
contraction at HIGHEST precision) at rtol 1e-4 / atol 1e-5, as
tests/test_torch_ops.py holds the port's stats, and against the fp32
conv_0 recompute ``conv0_stats_plain``: both take the same sums, the twin
in fp64, the JAX pass and the recompute in fp32 (sums of up to 8000 terms:
a few fp32 ulps of the sum each)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _w0(seed=0):
    """conv_0's weight in torch's Conv1d layout (512, 1, 10), He-scaled."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(512, 1, 10)) * (2 / 10) ** 0.5).astype(np.float32)


def _wave(b, t, seed):
    return np.random.default_rng(seed).normal(size=(b, t)).astype(np.float32)


def _jax_xt_stats(wave, w0):
    """pallas_frontend.conv0_stats(wave_layout="xt") on the waveform laid
    out as tests/test_torch_ops.py lays it out: (B, 16, U), row j holding
    tap j of each 10-sample pair-row (rows 10-15 zero), U long enough for
    the last block's load."""
    from triad_tpu.ops.pallas_frontend import conv0_stats, make_g2_weight_xt, stats_block

    b, t = wave.shape
    m0 = (t - 10) // 5 + 1
    n_pairs = (m0 + 1) // 2
    tb = stats_block(n_pairs, 2048, "xt")
    u = max(-(-t // 10), -(-n_pairs // tb) * tb + 128)
    x10 = np.zeros((b, u * 10), np.float32)
    x10[:, :t] = wave
    xt = np.pad(x10.reshape(b, u, 10).transpose(0, 2, 1), ((0, 0), (0, 6), (0, 0)))
    w = jnp.asarray(w0.reshape(512, 10).T)  # (10, 512): flax's (k, in, out) without in
    mean, var = conv0_stats(jnp.asarray(xt), make_g2_weight_xt(w), m0, interpret=True,
                            wave_layout="xt")
    return np.asarray(mean), np.asarray(var)


# (b, t): m0 = 1599 (odd, inside one 2048-step block), 4096 (two whole
# blocks), 5999 (odd, three blocks, the last ragged), 7999 (four blocks,
# the last ragged)
SHAPES = [(2, 8000), (2, 20487), (2, 30001), (1, 40000)]


@pytest.mark.parametrize("b,t", SHAPES)
def test_gram_twin_matches_jax_xt_pass(b, t):
    from triad_tpu_torch.ops.frontend import STATS_STEPS, conv0_stats_gram_plain

    wave, w0 = _wave(b, t, 1), _w0()
    m0 = (t - 10) // 5 + 1
    assert (m0 > STATS_STEPS) == (t > 8000)
    rm, rv = _jax_xt_stats(wave, w0)
    mean, var = conv0_stats_gram_plain(_t(wave), _t(w0))
    assert mean.dtype == var.dtype == torch.float32 and mean.shape == (b, 512)
    np.testing.assert_allclose(mean.numpy(), rm, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), rv, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,t", SHAPES)
def test_gram_twin_matches_recompute(b, t):
    """The fp32 recompute sums y and y^2 over every step: its error is a
    few fp32 ulps of sum y^2, so 1e-5 of the largest variance (the mean
    against the same scale's root)."""
    from triad_tpu_torch.ops.frontend import conv0_stats_gram_plain, conv0_stats_plain

    wave, w0 = _t(_wave(b, t, 2)), _t(_w0(1))
    mean, var = conv0_stats_gram_plain(wave, w0)
    rm, rv = conv0_stats_plain(wave, w0)
    scale = float(rv.max())
    assert float((mean - rm).abs().max()) <= 1e-5 * scale ** 0.5
    assert float((var - rv).abs().max()) <= 1e-5 * scale


def test_truncated_view_is_read_in_place():
    """The stack hands the stats a truncated view (T % 10 != 0, batch
    stride T): the same stats as from a contiguous copy, bit for bit, and
    the JAX pass's on that copy."""
    from triad_tpu_torch.ops.frontend import _wave_rows, conv0_stats_gram_plain

    full = _t(_wave(2, 12347, 3))
    view = full[:, :12340]
    assert not view.is_contiguous() and _wave_rows(view).data_ptr() == view.data_ptr()
    w0 = _w0(2)
    got = conv0_stats_gram_plain(view, _t(w0))
    want = conv0_stats_gram_plain(view.contiguous(), _t(w0))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    rm, rv = _jax_xt_stats(view.contiguous().numpy(), w0)
    np.testing.assert_allclose(got[0].numpy(), rm, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), rv, rtol=1e-4, atol=1e-5)


def test_culprit_rows_give_positive_variances():
    """The two audio rows whose GroupNorm variance went negative in the TPU
    Gram pass at default (bf16) precision (docs/evidence/
    nan_fe_xt_mechanism.log), normalised as the model normalises them: in
    fp64 every variance stays > 0 and agrees with the fp32 recompute."""
    from triad_tpu_torch.models.hubert import normalize_waveform
    from triad_tpu_torch.ops.frontend import conv0_stats_gram_plain, conv0_stats_plain

    path = os.path.join(os.path.dirname(__file__), "..", "docs", "evidence",
                        "nan_culprit_audio_rows.npz")
    wave = normalize_waveform(_t(np.load(path)["av_audio"]))
    w0 = _t(_w0())
    mean, var = conv0_stats_gram_plain(wave, w0)
    assert float(var.min()) > 0.0
    rm, rv = conv0_stats_plain(wave, w0)
    scale = float(rv.max())
    assert float((mean - rm).abs().max()) <= 1e-5 * scale ** 0.5
    assert float((var - rv).abs().max()) <= 1e-5 * scale


def test_constants_match_the_kernel_source():
    """The twin's block size and partial width and the wrapper's table
    size are the kernels'; the probe's variant edits still find their
    lines."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.ops.frontend import GELU_TABLE, GRAM_PARTS, STATS_STEPS
    from triad_tpu_torch.tools import kernel_probe

    src = (kernels.CSRC / "frontend.cu").read_text()
    assert f"constexpr int ST_T = {STATS_STEPS};" in src
    assert "constexpr int TAPS = 10;" in src
    assert GRAM_PARTS == 10 * 11 // 2 + 10
    assert "constexpr int LUT_N = 1 << 16;" in src and GELU_TABLE == 1 << 16
    for _, pairs in kernel_probe.CONV0_VARIANTS + kernel_probe.STATS_VARIANTS:
        for old, _ in pairs:
            assert src.count(old) == 1, old
