"""Fused transformer MLP forward (inference, no dropout).

Mirrors ``triad_tpu/ops/pallas_mlp.py:fused_mlp`` at ``p_drop = 0``:
y = gelu(x W1 + b1) W2 + b2 with fp32 accumulation, GELU in fp32 and
the hidden activation rounded to the weights' dtype before the second
product. Weights take torch's Linear layout here: w1 (Dh, Din), w2
(Dout, Dh) (the JAX function takes their transposes).

``fused_mlp`` launches ``csrc/fused_mlp.cu`` for a CUDA tensor and runs
``fused_mlp_plain`` for a CPU tensor; a CUDA tensor the kernel does not
take raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from triad_tpu_torch import kernels

GELU_FORMS = ("erf", "tanh")
KERNEL_DOUT = (256, 512, 768, 1024)


def _check_form(form: str) -> None:
    if form not in GELU_FORMS:
        raise ValueError(f"unknown GELU form {form!r} (expected {GELU_FORMS})")


def gelu(x: torch.Tensor, form: str) -> torch.Tensor:
    _check_form(form)
    return F.gelu(x, approximate="tanh" if form == "tanh" else "none")


def fused_mlp_plain(x, w1, b1, w2, b2, form: str = "erf") -> torch.Tensor:
    f32 = torch.float32
    h = x.to(f32) @ w1.to(f32).t() + b1.to(f32)
    g = gelu(h, form).to(w2.dtype)
    y = g.to(f32) @ w2.to(f32).t() + b2.to(f32)
    return y.to(x.dtype)


def fused_mlp(x, w1, b1, w2, b2, form: str = "erf") -> torch.Tensor:
    """x (..., Din) -> (..., Dout); w1 (Dh, Din), b1 (Dh,), w2 (Dout, Dh),
    b2 (Dout,), all in the compute dtype."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2, form)
    _check_form(form)
    kernels.require_cuda("fused_mlp", x, w1, b1, w2, b2, dtype=torch.bfloat16)
    w1, b1, w2, b2 = (t.contiguous() for t in (w1, b1, w2, b2))
    din = x.shape[-1]
    dh, dout = w1.shape[0], w2.shape[0]
    if din % 128 or dh % 16 or dout not in KERNEL_DOUT:
        raise ValueError(
            f"fused_mlp kernel: needs Din % 128 == 0, Dh % 16 == 0 and Dout in "
            f"{KERNEL_DOUT}, got {din}/{dh}/{dout}"
        )
    lead = x.shape[:-1]
    x2 = x.reshape(-1, din).contiguous()
    y = torch.empty((x2.shape[0], dout), dtype=x.dtype, device=x.device)
    kernels.call(
        "fused_mlp", x2.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), y.data_ptr(), x2.shape[0], din, dh, dout,
        int(form == "tanh"), kernels.stream_ptr(y),
    )
    kernels.LAUNCHES["fused_mlp"] += 1
    return y.reshape(*lead, dout)
