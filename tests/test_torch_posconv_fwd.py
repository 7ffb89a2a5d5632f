"""The positional conv's forward and dX on the CPU at the shapes where the
card kernel has edges, and the kernel's operand layout.

``pos_conv_plain`` and ``pos_conv_dx_plain`` (the twins the kernel is held
against on the card) through ``pos_conv_gelu`` against
``triad_tpu.ops.pallas_posconv.pos_conv_gelu`` with the Pallas kernel in
interpret mode, forward and the input's VJP, at narrow widths (C = 96, 2
groups of 48, K = 16): N = 1, N < K, a row count no 64-row tile divides.

The kernel reads its input window as planes of 8 channels (a row of a
plane is 16 bytes) and the weight as ``_kernel_weight`` lays it out,
W[g][k][p][o][e]; each wgmma reads A (64 rows x 16 input channels) from
window row r + tap of two planes and B (48 outputs x 16 inputs) from two
planes of the tap's block. ``_kernel_gemm`` walks those addresses in numpy
(512-row pieces, 64-row tiles, 4-tap stages) and must give the plain
conv's sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triad_tpu.ops.pallas_posconv import pos_conv_gelu as jax_pos_conv_gelu
from triad_tpu_torch.ops import posconv as P

C, G, K = 96, 2, 16


def _case(b, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, n, C)) * 0.5).astype(np.float32)
    w = (rng.normal(size=(K, C // G, C)) * (1.0 / (K * C // G)) ** 0.5).astype(np.float32)
    bias = (rng.normal(size=C) * 0.1).astype(np.float32)
    dy = rng.normal(size=(b, n, C)).astype(np.float32)
    wt = np.ascontiguousarray(w.transpose(2, 1, 0))  # torch's (C, C / G, K)
    return x, w, bias, dy, wt


@pytest.mark.parametrize("b,n", [(2, 1), (3, 9), (1, 130)])
def test_forward_and_dx_match_pallas(b, n):
    x, w, bias, dy, wt = _case(b, n, n + 11)
    out, vjp = jax.vjp(lambda x: jax_pos_conv_gelu(x, w, bias, G, "erf", True), x)
    (ref_dx,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    got = P.pos_conv_gelu(xt, torch.from_numpy(wt), torch.from_numpy(bias), G)
    got.backward(torch.from_numpy(dy))
    out, ref_dx = np.asarray(out), np.asarray(ref_dx)
    # fp32 sums over taps and channels in another order
    assert np.abs(got.detach().numpy() - out).max() <= 1e-5 * max(np.abs(out).max(), 1e-6)
    assert np.abs(xt.grad.numpy() - ref_dx).max() <= 1e-5 * max(np.abs(ref_dx).max(), 1e-6)
    # the primal alone (no autograd) takes the GELU in the kernel's epilogue
    with torch.no_grad():
        primal = P.pos_conv_gelu(torch.from_numpy(x), torch.from_numpy(wt),
                                 torch.from_numpy(bias), G)
    assert np.abs(primal.numpy() - out).max() <= 1e-5 * max(np.abs(out).max(), 1e-6)


ROWS, TILE, TAPS = 512, 64, 4  # posconv.cu: PC_ROWS, a wgmma's rows, PC_TAPS


def _kernel_gemm(x, wk, left):
    """out[b, t, g * 48 + o] = sum over taps and inputs, with the kernel's
    operands: the window of each 512-row piece as planes [p][row][e] (zeros
    outside [0, N)), the weight as _kernel_weight's [g][k][p][o][e]; A of
    (tile row r, tap, k-step kk) is rows r + tap .. + 63 of planes 2 kk and
    2 kk + 1, B the tap's planes 2 kk and 2 kk + 1."""
    b, n, c = x.shape
    groups, k = wk.shape[0], wk.shape[1]
    planes = 48 // 8
    out = np.zeros((b, n, c), np.float64)
    for t0 in range(0, n, ROWS):
        rows = ROWS + k - 1
        src = np.arange(rows) + t0 - left
        ok = (src >= 0) & (src < n)
        win = np.zeros((b, rows, c))
        win[:, ok] = x[:, src[ok]]
        for g in range(groups):
            pl = win[:, :, g * 48:(g + 1) * 48].reshape(b, rows, planes, 8).transpose(0, 2, 1, 3)
            for r in range(0, ROWS, TILE):
                acc = np.zeros((b, TILE, 48))
                for s in range(0, k, TAPS):
                    for tap in range(s, s + TAPS):
                        for kk in range(planes // 2):
                            a = np.concatenate([pl[:, 2 * kk + h, r + tap:r + tap + TILE]
                                                for h in range(2)], axis=-1)  # (b, 64, 16)
                            bm = np.concatenate([wk[g, tap, 2 * kk + h] for h in range(2)],
                                                axis=-1)  # (48 outputs, 16 inputs)
                            acc += a @ bm.T
                last = min(n, t0 + r + TILE)
                if last > t0 + r:
                    out[:, t0 + r:last, g * 48:(g + 1) * 48] = acc[:, :last - t0 - r]
    return out


@pytest.mark.parametrize("n,dx", [(1, False), (9, True), (130, False), (600, True)])
def test_kernel_layout_gives_the_conv(n, dx):
    """N = 1, N < K, one piece of several tiles, two 512-row pieces; the
    forward's and dX's weights and left paddings."""
    b = 2
    x, _, _, _, wt = _case(b, n, n + 29)
    w = torch.from_numpy(wt)
    wk = (P._flip_weight if dx else P._conv_weight)(w, G)
    got = _kernel_gemm(x.astype(np.float64), P._kernel_weight(wk).double().numpy(),
                       P._left(K, dx))
    want = P._plain(torch.from_numpy(x), wk.to(torch.bfloat16).float(), None, P._left(K, dx),
                    "id").double().numpy()
    assert P._kernel_weight(wk).shape == (G, K, 6, 48, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_probe_edits_match_the_kernel():
    """The forward probe's edited copies still find the lines they edit in
    csrc/posconv.cu, each once."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.tools import kernel_probe

    src = (kernels.CSRC / "posconv.cu").read_text()
    for _, pairs in kernel_probe.POSCONV_FWD_VARIANTS:
        for old, _ in pairs:
            assert src.count(old) == 1, old
