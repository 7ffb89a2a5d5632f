"""The positional conv's dW on the CPU at the shapes where the card kernel
has edges: ``pos_conv_dw_plain`` (the twin the kernel is held against on
the card) through ``pos_conv_gelu``'s backward, against
``triad_tpu.ops.pallas_posconv.pos_conv_gelu``'s VJP with the Pallas dW
kernel in interpret mode, at narrow widths (C = 96, 2 groups of 48, K =
16): N = 1, N < K, a row count no 64-row tile divides. Also: the probe
that times the dW kernel without its copies still finds the line it
edits in ``csrc/posconv.cu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triad_tpu.ops.pallas_posconv import pos_conv_gelu as jax_pos_conv_gelu
from triad_tpu_torch.ops.posconv import pos_conv_dw_plain, pos_conv_gelu


@pytest.mark.parametrize("b,n", [(2, 1), (3, 9), (2, 40), (1, 130)])
def test_dw_matches_pallas(b, n):
    c, g, k = 96, 2, 16
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(b, n, c)) * 0.5).astype(np.float32)
    w = (rng.normal(size=(k, c // g, c)) * (1.0 / (k * c // g)) ** 0.5).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    dy = rng.normal(size=(b, n, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda w: jax_pos_conv_gelu(x, w, bias, g, "erf", True), w)
    (ref,) = vjp(jnp.asarray(dy))
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))).requires_grad_()
    pos_conv_gelu(torch.from_numpy(x), wt, torch.from_numpy(bias), g).backward(
        torch.from_numpy(dy))
    got = wt.grad.numpy().transpose(2, 1, 0)
    ref = np.asarray(ref)
    # fp32 sums over the rows in another order
    assert np.abs(got - ref).max() <= 2e-4 * max(np.abs(ref).max(), 1e-6)


def test_dw_plain_is_the_row_sum():
    """dW[o, i, k] = sum over rows of dz[t, o] x[t - K/2 + k, i] in one
    group, from an explicit loop in float64."""
    rng = np.random.default_rng(5)
    b, n, c, k = 2, 7, 48, 8
    x = rng.normal(size=(b, n, c))
    dz = rng.normal(size=(b, n, c))
    want = np.zeros((c, c, k))
    for kk in range(k):
        for t in range(n):
            s = t - k // 2 + kk
            if 0 <= s < n:
                want[:, :, kk] += np.einsum("bo,bi->oi", dz[:, t], x[:, s])
    got = pos_conv_dw_plain(torch.from_numpy(x).float(), torch.from_numpy(dz).float(), 1, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_probe_edit_matches_the_kernel():
    from triad_tpu_torch import kernels
    from triad_tpu_torch.tools import kernel_probe

    src = (kernels.CSRC / "posconv.cu").read_text()
    for old, _ in kernel_probe.EDITS[0][0]:
        assert src.count(old) == 1, old
