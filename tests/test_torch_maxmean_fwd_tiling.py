"""The max-mean forward kernel's own order, on the CPU.

``ops.maxmean.maxmean_fwd_tiled_plain`` walks the forward kernel's tiles:
64-row query tiles of one clip (rows past Nq zero), the key clips in
order, 128-key tiles (keys past Nk out of the max), the sims over all of
D (padded with zero chunks, bf16 hi + lo for fp32 features), a running
first argmax per row, and per (query tile, i, j) one partial of each sum,
the partials summed over the tiles as the wrapper sums the kernel's. It
is held against ``triad_tpu.ops.pallas_maxmean._forward`` (the Pallas
forward in interpret mode, on Nq padded to 128 as its wrapper pads it) at
1e-4 of each output's largest magnitude, the card tests' tolerance: the
sums run in another order. The first argmax of every row is held against
``maxmean_plain``'s, which the reference does not return.

The inputs keep every row's maximum more than 2e-5 above its runner-up
and every sim more than 2e-5 from clamp_min (in float64), so the routing
and the clamp window are the same on both sides. Inputs come from numpy
with a seed.
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


def _inputs(nq, nk, d, dtype, masked, seed):
    """q (BQ, nq, d), k (BK, nk, d) in dtype (numpy normals rounded to
    it) and the (BQ, nq) query mask: a half-masked and a mostly masked clip,
    or none."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy((rng.standard_normal((BQ, nq, d)) * 0.3).astype(np.float32)).to(dtype)
    k = torch.from_numpy((rng.standard_normal((BK, nk, d)) * 0.3).astype(np.float32)).to(dtype)
    if not masked:
        return q, k, None
    mask = np.ones((BQ, nq), np.float32)
    mask[0, nq // 2:] = 0.0
    mask[-1, 5:] = 0.0
    return q, k, torch.from_numpy(mask)


def _pallas_forward(q, k, coeff, clamp_min):
    """(clip, nonneg, tsq) of pallas_maxmean._forward in interpret mode,
    its query rows padded to 128 with zero rows of zero coefficient."""
    from triad_tpu.ops.pallas_maxmean import _forward, _pick_tile, _round_up

    nq = q.shape[1]
    pad = _round_up(nq, 128) - nq
    jdt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    qp = np.pad(q.float().numpy(), ((0, 0), (0, pad), (0, 0)))
    cp = np.pad(coeff.numpy(), ((0, 0), (0, pad)))
    with pltpu.force_tpu_interpret_mode():
        out = _forward(jnp.asarray(qp, jdt), jnp.asarray(k.float().numpy(), jdt),
                       jnp.float32(TEMP), jnp.asarray(cp), clamp_min, _pick_tile(BQ, 8))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("nq,nk,d,dtype,masked,clamp_min,seed", [
    (1, 64, 64, torch.bfloat16, False, -2.0, 1),
    (37, 128, 512, torch.bfloat16, True, -60.0, 2),
    (130, 64, 64, torch.float32, True, -2.0, 3),
    (37, 64, 512, torch.float32, False, -2.0, 4),
    (130, 128, 64, torch.bfloat16, True, -2.0, 6),
    (1, 128, 512, torch.float32, True, -60.0, 7),
    (64, 64, 192, torch.bfloat16, False, -2.0, 8),
    (65, 128, 128, torch.float32, True, -2.0, 9),
    (129, 64, 256, torch.bfloat16, True, -60.0, 10),
    (63, 128, 64, torch.float32, False, -60.0, 11),
    (2, 64, 448, torch.bfloat16, True, -2.0, 12),
])
def test_tiled_forward_matches_pallas(nq, nk, d, dtype, masked, clamp_min, seed):
    """Nq 1, 2, 37, 63, 64, 65, 129 and 130 (one tile, ragged tiles,
    exactly one full tile, one row past it), Nk 64 and 128, D 64, 128, 192,
    256 and 448 (zero chunks of padding) and 512, bf16 and split fp32 features, a
    masked and an unmasked mean, a clamp window inside the sims' range (-2)
    and one wider than it (-60)."""
    from triad_tpu_torch.ops import maxmean as MM

    q, k, mask = _inputs(nq, nk, d, dtype, masked, seed)
    coeff = MM.coefficients(BQ, nq, mask, "cpu")
    ts = torch.einsum("iqd,jkd->ijqk", q.double(), k.double()) * TEMP
    top = ts.topk(2, dim=3).values
    assert float((top[..., 0] - top[..., 1]).min()) > MARGIN
    assert float((ts - clamp_min).abs().min()) > MARGIN
    temp = torch.tensor(TEMP)
    got = MM.maxmean_fwd_tiled_plain(q, k, temp, coeff, clamp_min)
    for name, g, r in zip(("clip", "nonneg", "tsq"), got[:3],
                          _pallas_forward(q, k, coeff, clamp_min)):
        g = g.numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=0, atol=REL * max(float(np.abs(r).max()), 1e-30),
                                   err_msg=name)
    assert torch.equal(got[3], MM.maxmean_plain(q, k, temp, coeff, clamp_min)[3])


def test_forward_tiling_matches_the_kernel_source():
    """The tiled twin's constants are the forward kernel's: 64-row query
    items and 128-key sim tiles; the kernel writes one partial of each sum
    per (query tile, pair) for the wrapper to add; and the probe's variant
    edits still find their lines, each once."""
    from triad_tpu_torch.ops import maxmean as MM
    from triad_tpu_torch.tools import kernel_probe

    src = (kernels.CSRC / "maxmean.cu").read_text()
    assert f"constexpr int FW_KEYS = {MM.FWD_KEYS};" in src
    assert f"constexpr int BW_ROWS = {MM.ROWS};" in src
    assert "float* out = a.part + (((long long)tile * a.bq + i) * a.bk + j) * 3;" in src
    for _, pairs in kernel_probe.MAXMEAN_FWD_VARIANTS:
        for old, _ in pairs:
            assert src.count(old) == 1, old
    for old, _ in kernel_probe.TS_EDITS:
        assert src.count(old) == 1, old
