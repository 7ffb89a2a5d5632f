"""HuBERT's frontend after conv_0 with the input activation fused into each
stride-2 conv, and that activation as a pass of its own.

Mirrors ``triad_tpu/ops/pallas_conv.py``: ``fused_frontend_conv`` (y =
conv_s2(prologue(x[:, :t_logical]), w), prologue None, "gelu" or
"norm_gelu") and ``pallas_activation`` (here ``frontend_activation``),
with their numerics: the prologue in fp32, (x - mean) * rstd * scale +
bias then the exact GELU, rounded to the input dtype before the products;
fp32 accumulation; the output in the input dtype.

``fused_frontend_conv_fwd`` and ``frontend_activation_fwd`` launch
``csrc/frontend_conv.cu`` for a CUDA tensor and run the plain twins
(``*_plain``) for a CPU tensor; a CUDA tensor the kernel does not take
raises. The TPU kernel's row alignment (``align8``, margins,
``min_input_alloc``) is Mosaic's and is not carried over: the port passes
logical lengths and returns exactly ``out_rows(t_logical, k)`` rows,
which equal the TPU kernel's real rows.

Neither TPU kernel has a backward kernel: their custom VJPs recompute
through the XLA composition. ``FusedFrontendConv`` and
``FrontendActivation`` do the same with the plain twins (autograd through
them, in fp32 on values rounded where the forward rounds). Conv weights
take torch's Conv1d layout (Cout, Cin, k); x is (B, T, C) as in the JAX
package; mean and rstd are (B, 1, C), scale and bias (C,).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from triad_tpu_torch import kernels

PROLOGUES = (None, "gelu", "norm_gelu")
KERNEL_TAPS = (2, 3)  # the stride-2 layers after conv_0


def out_rows(t_logical: int, k: int) -> int:
    """Logical VALID stride-2 output length."""
    return (t_logical - k) // 2 + 1


def identity_stats(b: int, c: int, device=None):
    """(mean, rstd, scale, bias) for a prologue that reads no stats
    ("gelu"): zeros, ones, ones, zeros of the norm's shapes."""
    f32 = torch.float32
    return (torch.zeros((b, 1, c), dtype=f32, device=device),
            torch.ones((b, 1, c), dtype=f32, device=device),
            torch.ones((c,), dtype=f32, device=device),
            torch.zeros((c,), dtype=f32, device=device))


def _check_prologue(prologue: Optional[str]) -> None:
    if prologue not in PROLOGUES:
        raise ValueError(f"unknown prologue {prologue!r} (expected {PROLOGUES})")


def _apply_prologue(x, prologue, mean, rstd, scale, bias):
    """pallas_conv._apply_prologue on fp32 values."""
    f32 = torch.float32
    if prologue == "norm_gelu":
        x = (x - mean.to(f32)) * rstd.to(f32) * scale.to(f32) + bias.to(f32)
    if prologue is not None:
        x = F.gelu(x)
    return x


def _conv_s2_fp32(x, w):
    """x (B, T, Cin), w (Cout, Cin, k), both fp32 -> (B, T', Cout) fp32 with
    TF32 off: on values rounded to bf16 every product is exact, as on the
    tensor cores."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv1d(x.transpose(1, 2), w, stride=2).transpose(1, 2)


def fused_frontend_conv_plain(x, w, mean, rstd, scale, bias, t_logical: int,
                              prologue: Optional[str]) -> torch.Tensor:
    """pallas_conv._reference: the prologue on x[:, :t_logical] in fp32,
    rounded to x's dtype, the conv on those values and w in x's dtype with
    fp32 accumulation, rounded to x's dtype. Differentiable."""
    f32 = torch.float32
    xa = _apply_prologue(x[:, :t_logical].to(f32), prologue, mean, rstd, scale, bias)
    y = _conv_s2_fp32(xa.to(x.dtype).to(f32), w.to(x.dtype).to(f32))
    return y.to(x.dtype)


def _flat_stats(t: torch.Tensor, n: int, device) -> torch.Tensor:
    """t as n contiguous fp32 values on device, 16-byte aligned (the conv
    kernel reads them 4 at a time)."""
    t = t.to(device=device, dtype=torch.float32).reshape(n).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_frontend_conv_fwd(x, w, mean, rstd, scale, bias, t_logical: int,
                            prologue: Optional[str]) -> torch.Tensor:
    """x (B, T >= t_logical, Cin), w (Cout, Cin, k), k in {2, 3} -> (B,
    out_rows(t_logical, k), Cout) in x's dtype: the kernel on the card
    (bf16, Cin a multiple of 64, Cout of 256), the twin on the CPU."""
    _check_prologue(prologue)
    b, t, cin = x.shape
    cout, wcin, k = w.shape
    if wcin != cin or k not in KERNEL_TAPS or not k <= t_logical <= t:
        raise ValueError(f"fused_frontend_conv: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"t_logical {t_logical} (k in {KERNEL_TAPS}, k <= t_logical <= T)")
    if x.device.type == "cpu":
        return fused_frontend_conv_plain(x, w, mean, rstd, scale, bias, t_logical, prologue)
    kernels.require_cuda("fused_frontend_conv", x, w)
    if x.dtype != torch.bfloat16 or cin % 64 or cout % 256:
        raise ValueError(f"fused_frontend_conv kernel: needs bf16 x with Cin % 64 == 0 and "
                         f"Cout % 256 == 0, got {x.dtype} Cin {cin} Cout {cout}")
    if x.stride(2) != 1 or x.stride(1) != cin or x.stride(0) % 8 or x.data_ptr() % 16:
        x = x[:, :t_logical].contiguous()
    tout = out_rows(t_logical, k)
    # (Cout, k * Cin): output channel, then tap, then input channel
    wk = w.permute(0, 2, 1).reshape(cout, k * cin).to(torch.bfloat16).contiguous()
    stats = [_flat_stats(s, b * cin, x.device) for s in (mean, rstd)]
    affine = [_flat_stats(s, cin, x.device) for s in (scale, bias)]
    y = torch.empty((b, tout, cout), dtype=x.dtype, device=x.device)
    kernels.call("frontend_conv_fused", x.data_ptr(), x.stride(0), cin, wk.data_ptr(), cout,
                 y.data_ptr(), b, tout, k, PROLOGUES.index(prologue),
                 *(s.data_ptr() for s in stats + affine), kernels.stream_ptr(y))
    kernels.LAUNCHES["fused_frontend_conv"] += 1
    return y


def frontend_activation_plain(x, mean, rstd, scale, bias, act: str) -> torch.Tensor:
    """pallas_conv._act_reference: the prologue in fp32, cast to x's dtype."""
    return _apply_prologue(x.to(torch.float32), act, mean, rstd, scale, bias).to(x.dtype)


def frontend_activation_fwd(x, mean, rstd, scale, bias, act: str) -> torch.Tensor:
    """x (B, T, C) -> act(x) in x's dtype: the kernel on the card (bf16, C
    a multiple of 8), the twin on the CPU."""
    if act not in PROLOGUES[1:]:
        raise ValueError(f"unknown activation {act!r} (expected gelu or norm_gelu)")
    if x.device.type == "cpu":
        return frontend_activation_plain(x, mean, rstd, scale, bias, act)
    kernels.require_cuda("frontend_activation", x, dtype=torch.bfloat16)
    b, t, c = x.shape
    if c % 8:
        raise ValueError(f"frontend_activation kernel: C {c} not a multiple of 8")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel moves 16-byte vectors
        x = x.clone()
    stats = [_flat_stats(s, b * c, x.device) for s in (mean, rstd)]
    affine = [_flat_stats(s, c, x.device) for s in (scale, bias)]
    y = torch.empty_like(x)
    kernels.call("frontend_act", x.data_ptr(), y.data_ptr(), b, t, c, PROLOGUES.index(act),
                 *(s.data_ptr() for s in stats + affine), kernels.stream_ptr(y))
    kernels.LAUNCHES["frontend_activation"] += 1
    return y


def _recompute_grads(ctx, fn, dy):
    """The VJP of fn (a plain twin) at the saved inputs, for the inputs
    that need a gradient (pallas_conv's _bwd / _act_bwd)."""
    leaves = [t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [leaf for leaf in leaves if leaf.requires_grad]
    grads = iter(())
    if wanted:
        with torch.enable_grad():
            out = fn(*leaves)
            # a prologue that reads no stats leaves them unused: no gradient
            grads = iter(torch.autograd.grad(out, wanted, dy.to(out.dtype), allow_unused=True))
    return [next(grads) if leaf.requires_grad else None for leaf in leaves]


class FusedFrontendConv(torch.autograd.Function):
    """fused_frontend_conv's custom VJP: the kernel forward; the backward
    differentiates fused_frontend_conv_plain recomputed from the inputs.
    apply(x, w, mean, rstd, scale, bias, t_logical, prologue)."""

    @staticmethod
    def forward(ctx, x, w, mean, rstd, scale, bias, t_logical, prologue):
        ctx.save_for_backward(x, w, mean, rstd, scale, bias)
        ctx.args = (t_logical, prologue)
        return fused_frontend_conv_fwd(x, w, mean, rstd, scale, bias, t_logical, prologue)

    @staticmethod
    def backward(ctx, dy):
        t_logical, prologue = ctx.args
        grads = _recompute_grads(
            ctx, lambda *a: fused_frontend_conv_plain(*a, t_logical, prologue), dy)
        return (*grads, None, None)


class FrontendActivation(torch.autograd.Function):
    """pallas_activation's custom VJP: the kernel forward, the backward
    through frontend_activation_plain. apply(x, mean, rstd, scale, bias, act)."""

    @staticmethod
    def forward(ctx, x, mean, rstd, scale, bias, act):
        ctx.save_for_backward(x, mean, rstd, scale, bias)
        ctx.act = act
        return frontend_activation_fwd(x, mean, rstd, scale, bias, act)

    @staticmethod
    def backward(ctx, dy):
        act = ctx.act
        grads = _recompute_grads(ctx, lambda *a: frontend_activation_plain(*a, act), dy)
        return (*grads, None)


def fused_frontend_conv(x, w, mean, rstd, scale, bias, t_logical: int,
                        prologue: Optional[str]) -> torch.Tensor:
    """y = conv1d_valid_s2(prologue(x[:, :t_logical]), w), differentiable
    in every tensor argument (FusedFrontendConv)."""
    return FusedFrontendConv.apply(x, w, mean, rstd, scale, bias, int(t_logical), prologue)


def frontend_activation(x, mean, rstd, scale, bias, act: str) -> torch.Tensor:
    """pallas_activation: "gelu" or "norm_gelu" as one pass, differentiable
    (FrontendActivation)."""
    return FrontendActivation.apply(x, mean, rstd, scale, bias, act)
