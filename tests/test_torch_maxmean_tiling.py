"""The max-mean backward kernels' own order, on the CPU.

``ops.maxmean.maxmean_dq_tiled_plain`` and ``maxmean_dk_tiled_plain`` walk
the dQ and dK kernels' tiles in their order: 64 resident rows, streamed
tiles of 64 rows (32 for split fp32 features), D padded with zero chunks
(the output's D is split between two warpgroups, each of which sums a
tile's sims over all of D); dts rounded to bf16 hi + lo
before an fp32 product summed tile by tile. They are held against
``triad_tpu.ops.pallas_maxmean``'s backward (``_backward``, both Pallas
passes in interpret mode, on Nq padded to 128 as its wrapper pads it) at
1e-4 of the largest output, the card tests' tolerance: dts as hi + lo
carries ~16 mantissa bits, and the sums run in another order.

The reference recomputes the first argmax from its own sims, while the
kernels read the forward's; the inputs keep every row's maximum more than
2e-5 above its runner-up and every sim more than 2e-5 from clamp_min (in
float64), so the routing and the clamp window are the same on both sides.

Inputs come from numpy with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from triad_tpu_torch import kernels

REL = 1e-4
TEMP = 1.5
BQ, BK = 3, 2
MARGIN = 2e-5


def _inputs(nq, nk, d, dtype, seed):
    """q (BQ, nq, d), k (BK, nk, d) in dtype (numpy normals rounded to it),
    a query mask with a half-masked and a mostly masked clip, g_clip and
    g_nn."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy((rng.standard_normal((BQ, nq, d)) * 0.3).astype(np.float32)).to(dtype)
    k = torch.from_numpy((rng.standard_normal((BK, nk, d)) * 0.3).astype(np.float32)).to(dtype)
    mask = np.ones((BQ, nq), np.float32)
    mask[0, nq // 2:] = 0.0
    mask[-1, 5:] = 0.0
    g_clip = (rng.standard_normal((BQ, BK)) / BQ).astype(np.float32)
    return q, k, torch.from_numpy(mask), torch.from_numpy(g_clip), 0.05


def _pallas_backward(q, k, coeff, clamp_min, g_clip, g_nn):
    """(dq, dk) fp32 of pallas_maxmean._backward in interpret mode, its
    query rows padded to 128 with zero rows of zero coefficient."""
    from triad_tpu.ops.pallas_maxmean import _backward, _pick_tile, _round_up

    nq = q.shape[1]
    pad = _round_up(nq, 128) - nq
    jdt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    qp = np.pad(q.float().numpy(), ((0, 0), (0, pad), (0, 0)))
    cp = np.pad(coeff.numpy(), ((0, 0), (0, pad)))
    with pltpu.force_tpu_interpret_mode():
        dq, dk = _backward(jnp.asarray(qp, jdt), jnp.asarray(k.float().numpy(), jdt),
                           jnp.float32(TEMP), jnp.asarray(cp), clamp_min, _pick_tile(BQ, 8),
                           jnp.asarray(g_clip.numpy()), jnp.float32(g_nn))
    return np.asarray(dq)[:, :nq], np.asarray(dk)


def _close(got, ref, name):
    got = got.numpy()
    assert got.shape == ref.shape and np.isfinite(got).all(), name
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * float(np.abs(ref).max()),
                               err_msg=name)


@pytest.mark.parametrize("nq,nk,d,dtype,clamp_min", [
    (37, 64, 64, torch.bfloat16, -2.0),
    (64, 128, 128, torch.float32, -60.0),
    (37, 128, 128, torch.float32, -2.0),
    (64, 64, 64, torch.bfloat16, -60.0),
    (37, 64, 192, torch.bfloat16, -2.0),
])
def test_tiled_order_matches_pallas(nq, nk, d, dtype, clamp_min):
    """Ragged (37) and whole (64) row tiles with a query mask, Nk 64 and
    128, D 64, 128 and 192 (a zero chunk of padding), bf16 and split fp32
    features, a clamp window inside the sims' range (-2) and one wider
    than it (-60)."""
    from triad_tpu_torch.ops import maxmean as MM

    q, k, mask, g_clip, g_nn = _inputs(nq, nk, d, dtype, seed=nq + nk + d)
    coeff = MM.coefficients(BQ, nq, mask, "cpu")
    ts = torch.einsum("iqd,jkd->ijqk", q.double(), k.double()) * TEMP
    top = ts.topk(2, dim=3).values
    assert float((top[..., 0] - top[..., 1]).min()) > MARGIN
    assert float((ts - clamp_min).abs().min()) > MARGIN
    amax = ts.argmax(dim=3).to(torch.int32)
    ref_dq, ref_dk = _pallas_backward(q, k, coeff, clamp_min, g_clip, g_nn)
    args = (q, k, torch.tensor(TEMP), coeff, clamp_min, amax, g_clip, torch.tensor(g_nn))
    _close(MM.maxmean_dq_tiled_plain(*args), ref_dq, "dq")
    _close(MM.maxmean_dk_tiled_plain(*args), ref_dk, "dk")


def test_tiling_matches_the_kernel_source():
    """The tiled twins' constants are the kernels': 64 resident rows,
    streamed tiles of 64 rows (32 split), the D split by chunks_per_half,
    each output warpgroup's sims over all of D (SIM_WG = 0); and the probe's
    variant edits still find their lines."""
    from triad_tpu_torch.ops import maxmean as MM
    from triad_tpu_torch.tools import kernel_probe

    src = (kernels.CSRC / "maxmean.cu").read_text()
    assert f"constexpr int BW_ROWS = {MM.ROWS};" in src
    assert "constexpr int stream_rows() { return SPLIT ? 32 : 64; }" in src
    assert (MM.stream_rows(True), MM.stream_rows(False)) == (32, 64)
    assert "return d <= 128 ? 1 : d <= 256 ? 2 : 4;" in src
    assert [MM.chunks_per_half(d) for d in (64, 128, 192, 256, 320, 512)] == [1, 1, 2, 2, 4, 4]
    assert "constexpr int SIM_WG = 0;" in src
    for _, pairs in kernel_probe.MAXMEAN_VARIANTS:
        for old, _ in pairs:
            assert old in src, old
