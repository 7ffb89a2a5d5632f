"""HuBERT conv waveform frontend: waveform (B, T) -> tokens (B, T', 512).

Mirrors ``triad_tpu/ops/pallas_frontend.py``: the GroupNorm statistics
pass ``conv0_stats`` and the ``monolithic_frontend`` stack (conv_0 ->
GroupNorm affine -> GELU -> 6 x (stride-2 conv -> GELU)), with the TPU
kernel's rounding points: conv_0 on bf16 operands with fp32
accumulation, the affine in fp32 rounded to bf16, every GELU in fp32 on
a bf16 value and rounded to bf16, the stride-2 convs on bf16 operands
with fp32 accumulation. The statistics are fp32 over every conv_0 step,
from the fp32 waveform, with the variance clamped at 0 (the TPU rounds'
NaN: ``pallas_frontend.py:379-398``).

Three wrappers, each launching its kernel from ``csrc/frontend.cu`` for a
CUDA tensor and running its ``*_plain`` twin for a CPU tensor:
``conv0_stats``, ``conv0_norm_gelu`` and ``conv_s2_gelu``. ``frontend``
chains them. Conv weights take torch's Conv1d layout (Cout, Cin, k).

The gradient (``frontend_vjp``, ``pallas_frontend.monolithic_frontend_vjp``)
runs the kernels forward and, in the backward, differentiates the plain
composition recomputed in the output dtype (``recompute_frontend``,
``pallas_frontend.reference_frontend`` with ``compute_dtype = out_dtype``,
as ``_mf_bwd`` does): bf16 convolutions with fp32 GroupNorm statistics in
training. The JAX package computes this backward outside any kernel, so
it stays plain here too. The waveform takes no gradient.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from triad_tpu_torch import kernels
from triad_tpu_torch.ops.mlp import _check_form, gelu

# HuBERT-base frontend geometry, the only one the kernels take.
KERNELS = (10, 3, 3, 3, 3, 2, 2)
STRIDES = (5, 2, 2, 2, 2, 2, 2)
C = 512
GN_EPS = 1e-5


def num_tokens(t: int) -> int:
    for k, s in zip(KERNELS, STRIDES):
        t = (t - k) // s + 1
    return t


def _bf16_exact(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, held in fp32 (products of two such values are
    exact in fp32, so an fp32 conv on them equals a bf16 conv with fp32
    accumulation)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _conv_fp32(x, w, stride):
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv1d(x, w, stride=stride)


def _m0(t: int) -> int:
    return (t - KERNELS[0]) // STRIDES[0] + 1


# ------------------------------------------------------------------ stats


def conv0_stats_plain(wave, w0) -> Tuple[torch.Tensor, torch.Tensor]:
    y = _conv_fp32(wave.to(torch.float32)[:, None, :], w0.to(torch.float32), STRIDES[0])
    mean = y.mean(dim=-1)
    var = torch.clamp((y * y).mean(dim=-1) - mean * mean, min=0.0)
    return mean, var


def conv0_stats(wave, w0) -> Tuple[torch.Tensor, torch.Tensor]:
    """wave (B, T) fp32, w0 (512, 1, 10) -> (mean, var), each (B, 512)
    fp32, over all conv_0 output steps."""
    if wave.device.type == "cpu":
        return conv0_stats_plain(wave, w0)
    kernels.require_cuda("conv0_stats", wave, w0)
    b, t = wave.shape
    m0 = _m0(t)
    wave = wave.to(torch.float32).contiguous()
    w0k = w0.reshape(C, KERNELS[0]).t().to(torch.float32).contiguous()
    s = torch.zeros((b, C), dtype=torch.float32, device=wave.device)
    sq = torch.zeros_like(s)
    kernels.call(
        "frontend_stats", wave.data_ptr(), wave.stride(0), w0k.data_ptr(),
        s.data_ptr(), sq.data_ptr(), b, m0, kernels.stream_ptr(s),
    )
    kernels.LAUNCHES["frontend_stats"] += 1
    mean = s / m0
    return mean, torch.clamp(sq / m0 - mean * mean, min=0.0)


# ------------------------------------------------------------------ conv_0


def conv0_norm_gelu_plain(wave, w0, scale, bias, form: str) -> torch.Tensor:
    y = _conv_fp32(_bf16_exact(wave)[:, None, :], _bf16_exact(w0), STRIDES[0])
    z = (y * scale[:, :, None] + bias[:, :, None]).to(torch.bfloat16)
    return gelu(z.to(torch.float32), form).to(torch.bfloat16).transpose(1, 2)


def conv0_norm_gelu(wave, w0, scale, bias, form: str = "tanh") -> torch.Tensor:
    """conv_0 (bf16 operands) -> affine (scale, bias: (B, 512) fp32, the
    GroupNorm folded with its statistics) -> bf16 -> GELU -> (B, T0, 512)
    bf16."""
    if wave.device.type == "cpu":
        return conv0_norm_gelu_plain(wave, w0, scale, bias, form)
    _check_form(form)
    kernels.require_cuda("conv0_norm_gelu", wave, w0, scale, bias)
    b, t = wave.shape
    m0 = _m0(t)
    wave = wave.to(torch.float32).contiguous()
    w0k = w0.reshape(C, KERNELS[0]).t().to(torch.float32).contiguous()
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    y = torch.empty((b, m0, C), dtype=torch.bfloat16, device=wave.device)
    kernels.call(
        "frontend_conv0", wave.data_ptr(), wave.stride(0), w0k.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), y.data_ptr(), b, m0,
        int(form == "tanh"), kernels.stream_ptr(y),
    )
    kernels.LAUNCHES["frontend_conv0"] += 1
    return y


# ------------------------------------------------------------ stride-2 conv


def conv_s2_gelu_plain(x, w, form: str) -> torch.Tensor:
    y = _conv_fp32(x.to(torch.float32).transpose(1, 2), _bf16_exact(w), 2)
    y = y.to(torch.bfloat16).to(torch.float32)
    return gelu(y, form).to(torch.bfloat16).transpose(1, 2)


def conv_s2_gelu(x, w, form: str = "tanh") -> torch.Tensor:
    """x (B, T, 512) bf16 (already activated), w (512, 512, k) ->
    gelu(bf16(conv(x, w, stride 2))) as (B, T', 512) bf16."""
    if x.device.type == "cpu":
        return conv_s2_gelu_plain(x, w, form)
    _check_form(form)
    kernels.require_cuda("conv_s2_gelu", x, w)
    if x.dtype != torch.bfloat16 or x.shape[-1] != C or w.shape[:2] != (C, C):
        raise ValueError(
            f"conv_s2_gelu kernel: needs bf16 (B, T, {C}) input and "
            f"({C}, {C}, k) weight, got {x.dtype} {tuple(x.shape)} / {tuple(w.shape)}"
        )
    b, tin, _ = x.shape
    k = w.shape[2]
    tout = (tin - k) // 2 + 1
    x = x.contiguous()
    wk = w.permute(2, 1, 0).reshape(k * C, C).to(torch.bfloat16).contiguous()
    y = torch.empty((b, tout, C), dtype=torch.bfloat16, device=x.device)
    kernels.call(
        "frontend_conv", x.data_ptr(), tin, wk.data_ptr(), y.data_ptr(), b,
        tout, k, int(form == "tanh"), kernels.stream_ptr(y),
    )
    kernels.LAUNCHES["frontend_conv"] += 1
    return y


# ------------------------------------------------------------------ stack


def check_geometry(w0, ws: Sequence[torch.Tensor]) -> None:
    shapes = [tuple(w0.shape)] + [tuple(w.shape) for w in ws]
    want = [(C, 1, KERNELS[0])] + [(C, C, k) for k in KERNELS[1:]]
    if shapes != want:
        raise ValueError(
            "the frontend kernels take the HuBERT-base geometry only "
            f"(kernels {KERNELS}, strides {STRIDES}, {C} channels); got {shapes}"
        )


def _stack(wave, w0, gn_scale, gn_bias, ws, form, out_dtype, stats, conv0, conv):
    check_geometry(w0, ws)
    t = wave.shape[1]
    wave = wave[:, : t - t % 10]
    mean, var = stats(wave, w0)
    scale = torch.rsqrt(var + GN_EPS) * gn_scale.to(torch.float32)[None, :]
    bias = gn_bias.to(torch.float32)[None, :] - mean * scale
    x = conv0(wave, w0, scale, bias, form)
    for w in ws:
        x = conv(x, w, form)
    return x.to(out_dtype)


def frontend(wave, w0, gn_scale, gn_bias, ws, form: str = "tanh",
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """wave (B, T) -> (B, num_tokens(T), 512): the whole frontend through
    the three wrappers (kernels on CUDA, plain twins on the CPU).
    w0 (512, 1, 10); gn_scale, gn_bias (512,); ws: six (512, 512, k)."""
    return _stack(wave, w0, gn_scale, gn_bias, ws, form, out_dtype,
                  conv0_stats, conv0_norm_gelu, conv_s2_gelu)


def reference_frontend(wave, w0, gn_scale, gn_bias, ws, form: str = "tanh",
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """The same stack on the plain twins only, on any device (the
    comparison target for the kernels on the card)."""
    return _stack(wave, w0, gn_scale, gn_bias, ws, form, out_dtype,
                  conv0_stats_plain, conv0_norm_gelu_plain, conv_s2_gelu_plain)


# ------------------------------------------------------------- gradient


def recompute_frontend(wave, w0, gn_scale, gn_bias, ws, form: str, dtype) -> torch.Tensor:
    """pallas_frontend.reference_frontend with compute_dtype = dtype, on the
    whole waveform: conv_0 on dtype operands, GroupNorm with fp32 mean and
    (two-pass) variance, the affine in fp32 rounded to dtype, then GELU in
    fp32 rounded to dtype before each stride-2 conv and after the last.
    Differentiable; the backward of frontend_vjp."""
    y = F.conv1d(wave.to(dtype)[:, None, :], w0.to(dtype), stride=STRIDES[0]).to(torch.float32)
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + GN_EPS)
    y = (y * gn_scale.to(torch.float32)[:, None] + gn_bias.to(torch.float32)[:, None]).to(dtype)
    for w in ws:
        y = gelu(y.to(torch.float32), form).to(dtype)
        y = F.conv1d(y, w.to(dtype), stride=2)
    return gelu(y.to(torch.float32), form).to(dtype).transpose(1, 2)


class FrontendVjp(torch.autograd.Function):
    """monolithic_frontend_vjp: the kernels forward; the backward recomputes
    the plain composition in the output dtype and differentiates it with
    torch.autograd.grad. Apply as FrontendVjp.apply(wave, w0, gn_scale,
    gn_bias, form, out_dtype, *ws)."""

    @staticmethod
    def forward(ctx, wave, w0, gn_scale, gn_bias, form, out_dtype, *ws):
        ctx.save_for_backward(wave, w0, gn_scale, gn_bias, *ws)
        ctx.form, ctx.out_dtype = form, out_dtype
        return frontend(wave, w0, gn_scale, gn_bias, ws, form, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        wave, *params = ctx.saved_tensors
        need = ctx.needs_input_grad[1:4] + ctx.needs_input_grad[6:]
        leaves = [p.detach().requires_grad_(n) for p, n in zip(params, need)]
        wanted = [leaf for leaf in leaves if leaf.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                out = recompute_frontend(wave.detach(), *leaves[:3], leaves[3:], ctx.form,
                                         ctx.out_dtype)
                grads = iter(torch.autograd.grad(out, wanted, dy.to(out.dtype)))
        got = [next(grads) if leaf.requires_grad else None for leaf in leaves]
        return (None, *got[:3], None, None, *got[3:])


def frontend_vjp(wave, w0, gn_scale, gn_bias, ws, form: str = "tanh",
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """frontend with a gradient for the weights (FrontendVjp)."""
    return FrontendVjp.apply(wave, w0, gn_scale, gn_bias, form, out_dtype, *ws)
