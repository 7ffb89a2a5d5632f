"""Fused transformer MLP with activation dropout, forward and backward.

Mirrors ``triad_tpu/ops/pallas_mlp.py:fused_mlp``: y = dropout(gelu(x W1
+ b1)) W2 + b2 with fp32 accumulation, GELU in fp32, a kept value times
1 / (1 - p) in fp32, and the hidden activation rounded to the weights'
dtype before the second product. The keep mask is ``ops/dropout.py``'s
at (row b * N + t, hidden unit), stream 0. Weights take torch's Linear
layout here: w1 (Dh, Din), w2 (Dout, Dh) (the JAX function takes their
transposes).

``fused_mlp`` and ``fused_mlp_bwd`` launch ``csrc/fused_mlp.cu`` for a
CUDA tensor and run ``fused_mlp_plain`` / ``fused_mlp_bwd_plain`` for a
CPU tensor; a CUDA tensor the kernel does not take raises. ``FusedMlp``
is the autograd Function over the pair.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from triad_tpu_torch import kernels
from triad_tpu_torch.ops import dropout

GELU_FORMS = ("erf", "tanh")
KERNEL_DOUT = (256, 512, 768, 1024)


def _check_form(form: str) -> None:
    if form not in GELU_FORMS:
        raise ValueError(f"unknown GELU form {form!r} (expected {GELU_FORMS})")


def gelu(x: torch.Tensor, form: str) -> torch.Tensor:
    _check_form(form)
    return F.gelu(x, approximate="tanh" if form == "tanh" else "none")


def mlp_keep(rows: int, dh: int, seed: int, p_drop: float, device, row0: int = 0) -> torch.Tensor:
    """The (rows, Dh) keep mask of the MLP's activation dropout, rows
    counted from global row ``row0``."""
    return dropout.keep_mask(seed, 0, rows, dh, p_drop, device, row0)


def fused_mlp_plain(x, w1, b1, w2, b2, form: str = "erf", seed: int = 0,
                    p_drop: float = 0.0, b0: int = 0) -> torch.Tensor:
    f32 = torch.float32
    h = x.to(f32) @ w1.to(f32).t() + b1.to(f32)
    g = gelu(h, form)
    keep = mlp_keep(h[..., 0].numel(), h.shape[-1], seed, p_drop, x.device,
                    dropout.row_offset(x, b0))
    g = dropout.apply_keep(g, keep.reshape(g.shape), p_drop).to(w2.dtype)
    y = g.to(f32) @ w2.to(f32).t() + b2.to(f32)
    return y.to(x.dtype)


def fused_mlp(x, w1, b1, w2, b2, form: str = "erf", seed: int = 0,
              p_drop: float = 0.0, b0: int = 0) -> torch.Tensor:
    """x (B, ..., Din) -> (B, ..., Dout); w1 (Dh, Din), b1 (Dh,), w2 (Dout,
    Dh), b2 (Dout,), all in the compute dtype; activation dropout at rate
    ``p_drop`` from the int32 ``seed``, for global batch rows b0 .. b0 + B
    - 1."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2, form, seed, p_drop, b0)
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
    m = x2.shape[0]
    y = torch.empty((m, dout), dtype=x.dtype, device=x.device)
    g = torch.empty((m, dh), dtype=x.dtype, device=x.device)  # GEMM 1 -> GEMM 2, transient
    kernels.call(
        "fused_mlp", x2.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), y.data_ptr(), g.data_ptr(), m, din, dh, dout,
        int(form == "tanh"), *kernels.dropout_args(seed, p_drop, dropout.row_offset(x, b0)),
        kernels.stream_ptr(y),
    )
    kernels.LAUNCHES["fused_mlp"] += 1
    return y.reshape(*lead, dout)


# ---------------------------------------------------------------------------
# Backward (pallas_mlp._bwd_call / _fused_mlp_bwd)
# ---------------------------------------------------------------------------

KERNEL_BWD_DIN = (768,)  # the width of the ViT and HuBERT, the only one on a path


def gelu_grad(h: torch.Tensor, form: str) -> torch.Tensor:
    """d gelu / dh in fp32 (pallas_mlp._gelu_tanh_grad / _gelu_grad)."""
    _check_form(form)
    h = h.to(torch.float32)
    if form == "tanh":
        t = torch.tanh(0.7978845608028654 * (h + 0.044715 * h * h * h))
        du = 0.7978845608028654 * (1.0 + 3.0 * 0.044715 * h * h)
        return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * du
    cdf = 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))
    return cdf + h * torch.exp(-0.5 * h * h) * 0.3989422804014327


def fused_mlp_bwd_plain(x, w1, b1, w2, dy, form: str = "erf", seed: int = 0,
                        p_drop: float = 0.0, b0: int = 0):
    """_bwd_kernel's body: recompute h = x W1^T + b1 and g = gelu(h) in
    fp32; dg = dy W2 (fp32); replay the keep mask: g and dg times keep /
    (1 - p); dh = dg gelu'(h); dx = dh W1 with dh rounded to the weights'
    dtype first. Returns (dx, dh, g) in x's dtype, g the dropped GELU
    output."""
    f32 = torch.float32
    h = x.to(f32) @ w1.to(f32).t() + b1.to(f32)
    keep = mlp_keep(h[..., 0].numel(), h.shape[-1], seed, p_drop, x.device,
                    dropout.row_offset(x, b0)).reshape(h.shape)
    dg = dropout.apply_keep(dy.to(f32) @ w2.to(f32), keep, p_drop)
    dh = dg * gelu_grad(h, form)
    dx = dh.to(w1.dtype).to(f32) @ w1.to(f32)
    g = dropout.apply_keep(gelu(h, form), keep, p_drop)
    return dx.to(x.dtype), dh.to(x.dtype), g.to(x.dtype)


def fused_mlp_bwd(x, w1, b1, w2, dy, form: str = "erf", seed: int = 0, p_drop: float = 0.0,
                  b0: int = 0):
    """(dx, dh, g) for x (..., Din), dy (..., Dout): the plain version for
    a CPU tensor, csrc/fused_mlp.cu's backward kernel for a CUDA one; seed,
    p_drop and b0 are the forward's."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(x, w1, b1, w2, dy, form, seed, p_drop, b0)
    _check_form(form)
    kernels.require_cuda("fused_mlp_bwd", x, w1, b1, w2, dy, dtype=torch.bfloat16)
    w1, b1, w2 = (t.contiguous() for t in (w1, b1, w2))
    din = x.shape[-1]
    dh, dout = w1.shape[0], w2.shape[0]
    if din not in KERNEL_BWD_DIN or dh % 16 or dout % 128:
        raise ValueError(
            f"fused_mlp_bwd kernel: needs Din in {KERNEL_BWD_DIN}, Dh % 16 == 0 and "
            f"Dout % 128 == 0, got {din}/{dh}/{dout}"
        )
    lead = x.shape[:-1]
    x2 = x.reshape(-1, din).contiguous()
    dy2 = dy.reshape(-1, dout).contiguous()
    m = x2.shape[0]
    dx = torch.empty((m, din), dtype=x.dtype, device=x.device)
    dhid, g = (torch.empty((m, dh), dtype=x.dtype, device=x.device) for _ in range(2))
    # dy W2 and dh W1 contract over the weights' rows: the kernels take
    # both weights K-major, so W1 and W2 are transposed once a call.
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    kernels.call(
        "fused_mlp_bwd", x2.data_ptr(), w1.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
        w2t.data_ptr(), dy2.data_ptr(), dx.data_ptr(), dhid.data_ptr(), g.data_ptr(), m, din,
        dh, dout, int(form == "tanh"),
        *kernels.dropout_args(seed, p_drop, dropout.row_offset(x, b0)), kernels.stream_ptr(dx),
    )
    kernels.LAUNCHES["fused_mlp_bwd"] += 1
    return dx.reshape(*lead, din), dhid.reshape(*lead, dh), g.reshape(*lead, dh)


def weight_grad(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a^T b for a (M, P) and b (M, Q) in their own dtype, rounded once to
    dtype: pallas_mlp._fused_mlp_bwd's einsum with preferred_element_type=
    f32. On the card, bf16 operands go to bf16 tensor cores with an fp32
    output (torch.mm's out_dtype), so cuBLAS sums and reduces any split-K
    partials in fp32: the product of the operands' exact fp32 upcasts up
    to the order of the sums. Elsewhere the operands multiply in their
    own dtype (fp32 in the CPU parity tests, as before; the CPU's bf16
    product also sums in fp32)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a.t(), b, out_dtype=torch.float32).to(dtype)
    return (a.t() @ b).to(dtype)


class FusedMlp(torch.autograd.Function):
    """fused_mlp with _fused_mlp_bwd's VJP: the kernels give dx, dh and the
    dropped g (the mask replayed from the seed); the weight gradients dW1
    = dh^T x and dW2 = dy^T g are plain products (weight_grad), db1 and db2
    fp32 sums, formed only for the inputs that need a gradient (the frozen
    ViT base needs none).
    Apply as FusedMlp.apply(x, w1, b1, w2, b2, form, seed, p_drop, b0)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, form, seed=0, p_drop=0.0, b0=0):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.args, ctx.b2_dtype = (form, int(seed), float(p_drop), int(b0)), b2.dtype
        return fused_mlp(x, w1, b1, w2, b2, *ctx.args)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dh, g = fused_mlp_bwd(x, w1, b1, w2, dy, *ctx.args)
        f32 = torch.float32
        dy2, dh2, x2, g2 = (t.reshape(-1, t.shape[-1]) for t in (dy, dh, x, g))
        dw1 = weight_grad(dh2, x2, w1.dtype) if need[1] else None
        db1 = dh2.sum(dim=0, dtype=f32).to(b1.dtype) if need[2] else None
        dw2 = weight_grad(dy2, g2, w2.dtype) if need[3] else None
        db2 = dy2.sum(dim=0, dtype=f32).to(ctx.b2_dtype) if need[4] else None
        return dx if need[0] else None, dw1, db1, dw2, db2, None, None, None, None
