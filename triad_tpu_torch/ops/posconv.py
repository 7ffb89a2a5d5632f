"""HuBERT's positional grouped conv + GELU, forward and backward.

Mirrors ``triad_tpu/ops/pallas_posconv.py:pos_conv_gelu``:
GELU(grouped_conv1d(x, w, b)) on the packed (B, N, C) layout with SAME
padding and the even-kernel trailing trim (output t reads x[t - K//2 ..
t - K//2 + K)), bf16 operands with fp32 accumulation, the bias added in
fp32, exact GELU. Its custom VJP saves the pre-activation z (rounded to
x's dtype); the backward forms dz = dy gelu'(z) and db = sum(dz) as plain
ops, dX as the same conv over dz with the flipped, co/ci-swapped weight
(left padding K - 1 - K//2, zero bias, no activation) and dW as a
reduction over every row. The weight takes torch's Conv1d layout (C,
C / groups, K).

Three wrappers, each launching ``csrc/posconv.cu`` for a CUDA tensor and
running its ``*_plain`` twin for a CPU tensor: ``pos_conv`` (the
forward), ``pos_conv_dx`` and ``pos_conv_dw``. ``pos_conv_gelu`` is the
differentiable function (``PosConvGelu``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from triad_tpu_torch import kernels
from triad_tpu_torch.ops.mlp import gelu, gelu_grad

KERNEL_CPG = 48  # channels per group the kernels take (HuBERT: 768 / 16)
_ACTS = ("id", "erf")


def _conv_weight(w, groups):
    """(C, CPG, K) torch weight -> W[g][k][i][o] (G, K, CPG_in, CPG_out)."""
    c, cpg, k = w.shape
    return w.reshape(groups, c // groups, cpg, k).permute(0, 3, 2, 1)


def _flip_weight(w, groups):
    """dX weight: W'[g][k'][o][i] = w[g*CPG + o, i, K-1-k'] (input channel
    o, output channel i), pallas_posconv._prep_w_flip."""
    c, cpg, k = w.shape
    return w.reshape(groups, c // groups, cpg, k).flip(-1).permute(0, 3, 1, 2)


def _kernel_weight(wk):
    """W[g][k][i][o] -> the forward kernel's B operand, (G, K, CPG / 8,
    CPG_out, 8) bf16: W[g][k][p][o][e] for input channel 8 p + e, so that
    8 outputs x 8 inputs of a tap are 128 contiguous bytes (a wgmma core
    matrix)."""
    g, k, cin, cout = wk.shape
    return wk.reshape(g, k, cin // 8, 8, cout).transpose(3, 4).to(torch.bfloat16).contiguous()


def _left(k: int, dx: bool) -> int:
    return k - 1 - k // 2 if dx else k // 2


def _plain(x, wk, bias, left: int, act: str):
    """out[t, o] = act(sum_k sum_i x[t - left + k, g*CPG + i] W[g][k][i][o]
    + bias) in fp32 from exact upcasts (TF32 off), rounded to x's dtype."""
    g, k, cin, cout = wk.shape
    b, n, _ = x.shape
    w = wk.permute(0, 3, 2, 1).reshape(g * cout, cin, k).to(torch.float32)
    xp = F.pad(x.to(torch.float32).transpose(1, 2), (left, k - 1 - left))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        z = F.conv1d(xp, w, groups=g)
    if bias is not None:
        z = z + bias.to(torch.float32)[None, :, None]
    if act == "erf":
        z = gelu(z, "erf")
    return z.transpose(1, 2).to(x.dtype)


def pos_conv_plain(x, w, bias, groups: int, act: str = "erf"):
    return _plain(x, _conv_weight(w, groups), bias, _left(w.shape[-1], False), act)


def pos_conv_dx_plain(dz, w, groups: int):
    return _plain(dz, _flip_weight(w, groups), None, _left(w.shape[-1], True), "id")


def pos_conv_dw_plain(x, dz, groups: int, k: int):
    """dW (C, CPG, K) fp32 = sum over rows of dz[t, o] x[t - K//2 + k, i]."""
    left = _left(k, False)
    xp = F.pad(x.to(torch.float32).transpose(1, 2), (left, k - 1 - left))
    c = x.shape[-1]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return torch.nn.grad.conv1d_weight(xp, (c, c // groups, k),
                                           dz.to(torch.float32).transpose(1, 2), groups=groups)


def _check(name, x, w, groups):
    kernels.require_cuda(name, x, w, dtype=torch.bfloat16)
    c, cpg, k = w.shape
    if x.shape[-1] != c or cpg * groups != c or cpg != KERNEL_CPG or k % 8:
        raise ValueError(f"{name} kernel: needs {KERNEL_CPG} channels per group and K % 8 == 0, "
                         f"got x {tuple(x.shape)}, w {tuple(w.shape)}, groups {groups}")


def _launch(name, x, wk, bias, left: int, act: str):
    b, n, c = x.shape
    k = wk.shape[1]
    x = x.contiguous()
    if x.data_ptr() % 16:  # a TMA base
        x = x.clone()
    wk = _kernel_weight(wk)
    if bias is not None:
        bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    kernels.call("posconv", x.data_ptr(), wk.data_ptr(), None if bias is None else bias.data_ptr(),
                 out.data_ptr(), b, n, n, c, k, left, _ACTS.index(act), kernels.stream_ptr(out))
    kernels.LAUNCHES[name] += 1
    return out


def pos_conv(x, w, bias, groups: int, act: str = "erf"):
    """act(grouped conv(x, w) + bias): x (B, N, C), w (C, C / groups, K),
    bias (C,) or None -> (B, N, C) in x's dtype. act "id" or "erf"."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r} (expected {_ACTS})")
    if x.device.type == "cpu":
        return pos_conv_plain(x, w, bias, groups, act)
    _check("posconv", x, w, groups)
    return _launch("posconv", x, _conv_weight(w, groups), bias, _left(w.shape[-1], False), act)


def pos_conv_dx(dz, w, groups: int):
    """dX of the conv: the forward kernel over dz with the flipped weight."""
    if dz.device.type == "cpu":
        return pos_conv_dx_plain(dz, w, groups)
    _check("posconv_dx", dz, w, groups)
    return _launch("posconv_dx", dz, _flip_weight(w, groups), None, _left(w.shape[-1], True),
                   "id")


def pos_conv_dw(x, dz, groups: int, k: int):
    """dW (C, C / groups, K) fp32 of the conv from x and dz (B, N, C)."""
    if x.device.type == "cpu":
        return pos_conv_dw_plain(x, dz, groups, k)
    kernels.require_cuda("posconv_dw", x, dz, dtype=torch.bfloat16)
    b, n, c = x.shape
    if dz.shape != x.shape or c != groups * KERNEL_CPG or k % 8:
        raise ValueError(f"posconv_dw kernel: needs x and dz of one shape, {KERNEL_CPG} channels "
                         f"per group and K % 8 == 0, got {tuple(x.shape)} / {tuple(dz.shape)}, "
                         f"groups {groups}, K {k}")
    x, dz = x.contiguous(), dz.contiguous()
    x, dz = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, dz))  # TMA bases
    dw = torch.empty((c, KERNEL_CPG, k), dtype=torch.float32, device=x.device)
    kernels.call("posconv_dw", x.data_ptr(), dz.data_ptr(), dw.data_ptr(), b, n, c, k,
                 _left(k, False), kernels.stream_ptr(dw))
    kernels.LAUNCHES["posconv_dw"] += 1
    return dw


class PosConvGelu(torch.autograd.Function):
    """pos_conv_gelu's custom VJP (pallas_posconv._pc_fwd / _pc_bwd):
    saves x, w and z; dz and db are plain ops, dX and dW kernels."""

    @staticmethod
    def forward(ctx, x, w, bias, groups):
        z = pos_conv(x, w, bias, groups, "id")
        ctx.save_for_backward(x, w, z)
        ctx.groups, ctx.bias_dtype = groups, bias.dtype
        return gelu(z.to(torch.float32), "erf").to(z.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, z = ctx.saved_tensors
        dz = (dy.to(torch.float32) * gelu_grad(z, "erf")).to(z.dtype)
        db = dz.to(torch.float32).sum(dim=(0, 1)).to(ctx.bias_dtype)
        need = ctx.needs_input_grad
        dx = pos_conv_dx(dz, w, ctx.groups).to(x.dtype) if need[0] else None
        dw = pos_conv_dw(x, dz, ctx.groups, w.shape[-1]).to(w.dtype) if need[1] else None
        return dx, dw, db if need[2] else None, None


def pos_conv_gelu(x, w, bias, groups: int):
    """GELU(grouped conv(x, w) + bias), SAME padding with the even-kernel
    trim: x (B, N, C), w (C, C / groups, K), bias (C,) fp32. Differentiable
    when grad is enabled (the VJP saves z); otherwise the kernel applies
    the GELU in its epilogue, as the TPU kernel's primal does."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, bias)):
        return PosConvGelu.apply(x, w, bias, groups)
    return pos_conv(x, w, bias, groups, "erf")
