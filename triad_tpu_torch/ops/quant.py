"""The int8 matmul of the opt-in serving mode (the port of
``triad_tpu/ops/quant.py``), used by ``models/quantize.py`` to run the
eval forward with every Dense product in int8:

* weights: symmetric per-output-channel scales (max-abs / 127),
  quantized on the fly, so checkpoints stay fp32;
* activations: symmetric per-row (per-token) dynamic scales.

Rounding is half to even (``torch.round``, as ``jnp.round``), scales are
floored at 1e-12, and the result is fp32. The int8 x int8 -> int32
product is a library GEMM, as in the JAX package (XLA's ``dot_general``
there, outside any Pallas kernel): ``torch._int_mm`` on a CUDA tensor,
padded to its limits (more than 16 rows; K and N multiples of 8) with
zeros, which add nothing to the sums. Its plain version on a CPU tensor
(``int8_matmul_plain``) sums in float64, exact for these operands, so
both give the same int32 sums.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["int8_dense", "int8_matmul", "int8_matmul_plain", "quantize_rows",
           "quantize_weight"]


def _symmetric(x: torch.Tensor):
    # 127 as a device tensor: a divisor held as a CPU scalar makes CUDA
    # multiply by its reciprocal, one fp32 rounding off the quotient.
    top = torch.tensor(127.0, dtype=x.dtype, device=x.device)
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / top, min=1e-12)
    return torch.round(x / scale).to(torch.int8), scale


def quantize_weight(weight: torch.Tensor):
    """(N, K) float weight in torch's (out, in) layout -> (int8 weight,
    (N, 1) float scales): one scale per output channel, as the JAX
    package's (1, N) scales of its (K, N) kernel."""
    return _symmetric(weight)


def quantize_rows(x: torch.Tensor):
    """(..., K) float activations -> (int8 x, (..., 1) float scales):
    symmetric per-row (per-token) dynamic quantization."""
    return _symmetric(x)


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32. Each product is at
    most 127^2 and K stays far below 2^53 / 127^2, so float64 sums every
    one exactly, in any order."""
    return (a.to(torch.float64) @ b.to(torch.float64).T).to(torch.int32)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32: ``torch._int_mm`` on
    CUDA tensors (B handed over column-major), the plain version on CPU
    tensors. On the card the operands are padded with zeros to more than
    16 rows and to K and N multiples of 8; it never falls back."""
    if a.device.type != "cuda":
        return int8_matmul_plain(a, b)
    m, k = a.shape
    n = b.shape[0]
    pk, pn, pm = -k % 8, -n % 8, max(17 - m, 0)
    a = F.pad(a, (0, pk, 0, pm)) if pk or pm else a
    b = F.pad(b, (0, pk, 0, pn)) if pk or pn else b
    out = torch._int_mm(a.contiguous(), b.contiguous().T)
    return out[:m, :n] if pm or pn else out


def int8_dense(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x W^T (+ bias) with the contraction in int8; ``weight`` is (N,
    K). Inputs are float (any dtype); the output is fp32. The int32 sums
    are exact, so the only error is the two roundings."""
    wq, w_scale = quantize_weight(weight.to(torch.float32))
    xq, x_scale = quantize_rows(x.to(torch.float32))
    k = x.shape[-1]
    y = int8_matmul(xq.reshape(-1, k), wq).to(torch.float32)
    y = y.reshape(*x.shape[:-1], wq.shape[0])
    y = y * x_scale * w_scale.reshape(-1)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y
