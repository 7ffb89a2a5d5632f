"""Fused dropout + residual add + LayerNorm, forward and backward.

Mirrors ``triad_tpu/ops/pallas_ln.py:fused_dropout_add_ln``:
y = LN(x + keep * h / (1 - p)) * scale + bias over the last dim, with
the sum, mean, two-pass variance and rstd in fp32 and y in x's dtype.
The keep mask is ``ops/dropout.py``'s at (row b * N + t, channel),
stream 0. The backward recomputes the statistics from x, h and the
replayed mask and gives dx = ds, dh = ds * keep / (1 - p) and the scale
and bias gradients (sums over rows in fp32).

``dropout_add_ln`` and ``dropout_add_ln_bwd`` launch ``csrc/layernorm.cu``
for a CUDA tensor and run their ``*_plain`` twins for a CPU tensor; a
CUDA tensor the kernel does not take raises. ``fused_dropout_add_ln`` is
the differentiable function (``DropoutAddLN``).
"""

from __future__ import annotations

import torch

from triad_tpu_torch import kernels
from triad_tpu_torch.ops import dropout

KERNEL_WIDTHS = (768,)  # HuBERT's width, the only one on a path


def ln_keep(rows: int, c: int, seed: int, p_drop: float, device, row0: int = 0) -> torch.Tensor:
    """The (rows, C) keep mask of the hidden dropout, rows counted from
    global row ``row0``."""
    return dropout.keep_mask(seed, 0, rows, c, p_drop, device, row0)


def _sum_input(x, h, seed, p_drop, b0=0):
    c = x.shape[-1]
    keep = ln_keep(x.numel() // c, c, seed, p_drop, x.device,
                   dropout.row_offset(x, b0)).reshape(x.shape)
    return x.to(torch.float32) + dropout.apply_keep(h.to(torch.float32), keep, p_drop), keep


def _normalize(s, eps):
    mean = s.mean(dim=-1, keepdim=True)
    var = (s - mean).square().mean(dim=-1, keepdim=True)
    return (s - mean) * torch.rsqrt(var + eps)


def dropout_add_ln_plain(x, h, scale, bias, eps: float, seed: int = 0,
                         p_drop: float = 0.0, b0: int = 0) -> torch.Tensor:
    """_fwd_kernel's body: x, h (B, ..., C); scale, bias (C,) -> y in x's
    dtype."""
    s, _ = _sum_input(x, h, seed, p_drop, b0)
    y = _normalize(s, eps) * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype)


def dropout_add_ln_bwd_plain(x, h, scale, dy, eps: float, seed: int = 0, p_drop: float = 0.0,
                             b0: int = 0):
    """_bwd_kernel's body, written out in fp32: dyh = dy scale, ds = rstd
    (dyh - mean(dyh) - xhat mean(dyh xhat)), dx = ds, dh = ds keep / (1 -
    p), dscale = sum(dy xhat), dbias = sum(dy) over rows. Returns (dx, dh)
    in x's dtype and (dscale, dbias) in fp32."""
    s, keep = _sum_input(x, h, seed, p_drop, b0)
    mean = s.mean(dim=-1, keepdim=True)
    var = (s - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (s - mean) * rstd
    g = dy.to(torch.float32)
    dyh = g * scale.to(torch.float32)
    m1 = dyh.mean(dim=-1, keepdim=True)
    m2 = (dyh * xhat).mean(dim=-1, keepdim=True)
    ds = rstd * (dyh - m1 - xhat * m2)
    dh = dropout.apply_keep(ds, keep, p_drop)
    c = x.shape[-1]
    dscale = (g * xhat).reshape(-1, c).sum(dim=0)
    dbias = g.reshape(-1, c).sum(dim=0)
    return ds.to(x.dtype), dh.to(x.dtype), dscale, dbias


def _check(name, x, h, scale, *more):
    kernels.require_cuda(name, x, h, *more, dtype=torch.bfloat16)
    kernels.require_cuda(name, x, scale)
    c = x.shape[-1]
    if c not in KERNEL_WIDTHS or h.shape != x.shape:
        raise ValueError(f"{name} kernel: needs x and h of one shape with C in {KERNEL_WIDTHS}, "
                         f"got {tuple(x.shape)} / {tuple(h.shape)}")
    return c, x.numel() // c


def dropout_add_ln(x, h, scale, bias, eps: float, seed: int = 0,
                   p_drop: float = 0.0, b0: int = 0) -> torch.Tensor:
    """y = LN(x + dropout(h)) * scale + bias: the plain version for a CPU
    tensor, csrc/layernorm.cu for a CUDA one (bf16 x and h, fp32 scale
    and bias); the dropout draws for global batch rows b0 .. b0 + B - 1."""
    if x.device.type == "cpu":
        return dropout_add_ln_plain(x, h, scale, bias, eps, seed, p_drop, b0)
    c, rows = _check("layernorm", x, h, scale)
    x, h = x.contiguous(), h.contiguous()
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(x)
    kernels.call("layernorm_fwd", x.data_ptr(), h.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), y.data_ptr(), rows, c, float(eps),
                 *kernels.dropout_args(seed, p_drop, dropout.row_offset(x, b0)),
                 kernels.stream_ptr(y))
    kernels.LAUNCHES["layernorm"] += 1
    return y


def dropout_add_ln_bwd(x, h, scale, dy, eps: float, seed: int = 0, p_drop: float = 0.0,
                       b0: int = 0):
    """(dx, dh, dscale, dbias): the plain version for a CPU tensor, the
    backward kernel of csrc/layernorm.cu for a CUDA one, which writes one
    fp32 row of scale and bias partials per block; their sum over blocks
    is taken here."""
    if x.device.type == "cpu":
        return dropout_add_ln_bwd_plain(x, h, scale, dy, eps, seed, p_drop, b0)
    c, rows = _check("layernorm_bwd", x, h, scale, dy)
    x, h, dy = x.contiguous(), h.contiguous(), dy.contiguous()
    scale = scale.to(torch.float32).contiguous()
    dx, dh = torch.empty_like(x), torch.empty_like(x)
    blocks = kernels.library().triad_layernorm_bwd_blocks(rows)
    parts = torch.empty((2, blocks, c), dtype=torch.float32, device=x.device)
    kernels.call("layernorm_bwd", x.data_ptr(), h.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), dh.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
                 rows, c, blocks, float(eps),
                 *kernels.dropout_args(seed, p_drop, dropout.row_offset(x, b0)),
                 kernels.stream_ptr(dx))
    kernels.LAUNCHES["layernorm_bwd"] += 1
    dscale, dbias = parts.sum(dim=1)
    return dx, dh, dscale, dbias


class DropoutAddLN(torch.autograd.Function):
    """fused_dropout_add_ln's custom VJP: saves x, h and scale, and the
    backward replays the mask from the seed."""

    @staticmethod
    def forward(ctx, x, h, scale, bias, seed, p_drop, eps, b0=0):
        ctx.save_for_backward(x, h, scale)
        ctx.args = (float(eps), int(seed), float(p_drop), int(b0))
        ctx.dtypes = (scale.dtype, bias.dtype)
        return dropout_add_ln(x, h, scale, bias, ctx.args[0], *ctx.args[1:])

    @staticmethod
    def backward(ctx, dy):
        x, h, scale = ctx.saved_tensors
        dx, dh, dscale, dbias = dropout_add_ln_bwd(x, h, scale, dy, *ctx.args)
        return (dx, dh, dscale.to(ctx.dtypes[0]), dbias.to(ctx.dtypes[1]),
                None, None, None, None)


def fused_dropout_add_ln(x, h, scale, bias, seed: int, p_drop: float, eps: float, b0: int = 0):
    """LN(x + dropout(h, p_drop)) * scale + bias, differentiable (the JAX
    function's argument order). x, h (B, T, C); scale, bias (C,); seed:
    int32 (unused at p_drop = 0); b0: the global index of x's first batch
    row."""
    return DropoutAddLN.apply(x, h, scale, bias, seed, p_drop, eps, b0)
