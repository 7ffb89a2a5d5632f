"""Attention: the packed and merged eval kernels, the packed training
kernels (forward and backward) and the plain masked softmax attention.

Mirrors ``triad_tpu/ops/pallas_attention.py`` (``fused_attention_eval``
and ``fused_attention_eval_merged``, both running ``_head_eval``;
``fused_attention_packed``, running ``_head_fwd`` / ``_head_bwd``) and
the XLA branch of ``triad_tpu/models/layers.py:dot_product_attention``.

``attention_eval`` / ``attention_eval_merged`` launch
``csrc/attention_eval.cu``, and ``attention_train`` (an autograd
Function) ``csrc/attention_train.cu``, for a CUDA tensor; a CPU tensor
runs the plain version (``*_plain``). There is no fallback from one to
the other: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from triad_tpu_torch import kernels

HEAD_DIM = 64  # the eval kernels slice heads as 64-wide column windows


def _key_mask(mask: Optional[torch.Tensor], b: int, n: int, device) -> torch.Tensor:
    if mask is None:
        return torch.ones((b, n), dtype=torch.float32, device=device)
    return mask.reshape(b, n).to(device=device, dtype=torch.float32).contiguous()


def attention_eval_plain(q, k, v, mask, sm_scale: float) -> torch.Tensor:
    """_head_eval for every head: q (B, Nq, H*64), k/v (B, Nk, H*64),
    mask (B, Nk) fp32 (1 = attend) -> (B, Nq, H*64) in q's dtype.

    fp32 scores, key bias (1 - mask) * -1e30, fp32 exp against the row
    max, e rounded to v's dtype before e.V (fp32 accumulation), output
    times 1 / (fp32 row sum)."""
    b, nq, hd = q.shape
    nk = k.shape[1]
    h = hd // HEAD_DIM

    def heads(x, n):
        return x.reshape(b, n, h, HEAD_DIM).transpose(1, 2).to(torch.float32)

    bias = (1.0 - mask.to(torch.float32)) * -1e30
    s = heads(q, nq) @ heads(k, nk).transpose(-1, -2) * sm_scale
    s = s + bias[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = e.sum(dim=-1, keepdim=True)
    o = (e.to(v.dtype).to(torch.float32) @ heads(v, nk)) * (1.0 / denom)
    return o.transpose(1, 2).reshape(b, nq, hd).to(q.dtype)


def _launch(name, q, k, v, mask, out, nq, nk, h, sm_scale):
    """q/k/v/out: (B, N, width) views with unit column stride."""
    b = out.shape[0]
    max_keys = kernels.library().triad_attention_eval_max_keys()
    if nk > max_keys:
        raise ValueError(f"{name}: {nk} keys > the kernel's {max_keys}")
    kernels.call(
        "attention_eval", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr(), out.data_ptr(), b, h, nq, nk,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        mask.stride(0), float(sm_scale), kernels.stream_ptr(out),
    )
    kernels.LAUNCHES[name] += 1


def attention_eval(q, k, v, mask=None, sm_scale: Optional[float] = None):
    """Packed-layout eval attention (pallas_attention.fused_attention_eval
    with ragged N): q (B, Nq, H*64), k/v (B, Nk, H*64) -> (B, Nq, H*64)."""
    b, nq, hd = q.shape
    nk = k.shape[1]
    if hd % HEAD_DIM:
        raise ValueError(f"packed width {hd} not a multiple of {HEAD_DIM}")
    scale = 1.0 / math.sqrt(HEAD_DIM) if sm_scale is None else sm_scale
    key_mask = _key_mask(mask, b, nk, q.device)
    if q.device.type == "cpu":
        return attention_eval_plain(q, k, v, key_mask, scale)
    kernels.require_cuda("attention_eval", q, k, v, dtype=torch.bfloat16)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    _launch("attention_eval", q, k, v, key_mask, out, nq, nk, hd // HEAD_DIM, scale)
    return out


def attention_eval_merged(qkv, mask=None, sm_scale: Optional[float] = None):
    """Merged-qkv eval attention (fused_attention_eval_merged with ragged
    N): qkv (B, N, 3*H*64) with q|k|v at column offsets 0, C, 2C ->
    (B, N, H*64)."""
    b, n, hd3 = qkv.shape
    hd = hd3 // 3
    if hd * 3 != hd3 or hd % HEAD_DIM:
        raise ValueError(f"bad merged width {hd3} (not 3*H*{HEAD_DIM})")
    scale = 1.0 / math.sqrt(HEAD_DIM) if sm_scale is None else sm_scale
    key_mask = _key_mask(mask, b, n, qkv.device)
    if qkv.device.type == "cpu":
        q, k, v = qkv.split(hd, dim=-1)
        return attention_eval_plain(q, k, v, key_mask, scale)
    kernels.require_cuda("attention_eval_merged", qkv, dtype=torch.bfloat16)
    qkv = qkv.contiguous()
    q, k, v = qkv.split(hd, dim=-1)  # views: row stride 3C, offsets 0/C/2C
    out = torch.empty((b, n, hd), dtype=qkv.dtype, device=qkv.device)
    _launch("attention_eval_merged", q, k, v, key_mask, out, n, n, hd // HEAD_DIM, scale)
    return out


def masked_attention(q, k, v, mask, dtype, scores_dtype=torch.float32, probs_dropout=None):
    """The XLA branch of triad_tpu.models.layers.dot_product_attention.

    q, k, v: (B, N, H, Dh); mask: optional (B, 1, 1, Nk) bool (True =
    attend). fp32 scores: finfo(fp32).min on masked keys and an fp32
    softmax cast to ``dtype``. bf16 scores: -1e4 on masked keys, a
    bf16 max-subtracted exp (exp itself in fp32) and bf16 probs.
    ``probs_dropout``: optional function applied to the probs."""
    depth = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(depth), dtype=dtype)
    qs = (q * scale).transpose(1, 2)  # (B, H, Nq, Dh)
    kt = k.permute(0, 2, 3, 1)  # (B, H, Dh, Nk)
    vh = v.transpose(1, 2)
    if scores_dtype == torch.float32:
        scores = (qs @ kt).to(torch.float32)
        if mask is not None:
            scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(dtype)
    else:
        scores = (qs @ kt).to(scores_dtype)
        if mask is not None:
            scores = scores.masked_fill(~mask, -1e4)
        m = scores.amax(dim=-1, keepdim=True).detach()
        e = torch.exp((scores - m).to(torch.float32)).to(dtype)
        probs = e / e.sum(dim=-1, keepdim=True).to(dtype)
    if probs_dropout is not None:
        probs = probs_dropout(probs)
    return (probs @ vh).transpose(1, 2)


# ---------------------------------------------------------------------------
# Training attention (pallas_attention.fused_attention_packed at p = 0)
# ---------------------------------------------------------------------------


def _train_heads(x, h):
    b, n, _ = x.shape
    return x.reshape(b, n, h, HEAD_DIM).transpose(1, 2).to(torch.float32)


def _train_probs(q, k, mask, sm_scale):
    """_head_fwd's fp32 P per head: softmax(q k^T s + (1 - mask) * -1e30)."""
    h = q.shape[-1] // HEAD_DIM
    bias = (1.0 - mask.to(torch.float32)) * -1e30
    s = _train_heads(q, h) @ _train_heads(k, h).transpose(-1, -2) * sm_scale
    s = s + bias[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _train_packed(x, like):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d).to(like.dtype)


def attention_train_plain(q, k, v, mask, sm_scale: float) -> torch.Tensor:
    """_head_fwd for every head at p = 0: q (B, Nq, H*64), k/v (B, Nk,
    H*64), mask (B, Nk) fp32 -> (B, Nq, H*64) in q's dtype. fp32 scores
    and softmax, P normalised in fp32 and then rounded to v's dtype
    before P.V (fp32 accumulation)."""
    p = _train_probs(q, k, mask, sm_scale)
    o = p.to(v.dtype).to(torch.float32) @ _train_heads(v, q.shape[-1] // HEAD_DIM)
    return _train_packed(o, q)


def attention_train_bwd_plain(q, k, v, mask, do, sm_scale: float):
    """_head_bwd for every head at p = 0, written out in fp32 (not
    autograd): dP = dO V^T, dV = P^T dO, di = rowsum(dP * P), dS = P (dP
    - di), dQ = dS K s, dK = dS^T Q s. Returns (dq, dk, dv) in the dtypes
    of q, k, v."""
    h = q.shape[-1] // HEAD_DIM
    p = _train_probs(q, k, mask, sm_scale)
    dof = _train_heads(do, h)
    dp = dof @ _train_heads(v, h).transpose(-1, -2)
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = ds @ _train_heads(k, h) * sm_scale
    dk = ds.transpose(-1, -2) @ _train_heads(q, h) * sm_scale
    return _train_packed(dq, q), _train_packed(dk, k), _train_packed(dv, v)


def _train_launch_args(name, q, k, v, mask):
    """(b, h, n, mask): the kernel's shape arguments and the key mask as
    a contiguous (B, N) fp32 tensor on q's device."""
    kernels.require_cuda(name, q, k, v, dtype=torch.bfloat16)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: the kernel takes self-attention shapes, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, n, hd = q.shape
    max_keys = kernels.library().triad_attention_train_max_keys()
    if n > max_keys:
        raise ValueError(f"{name}: {n} keys > the kernel's {max_keys}")
    return b, hd // HEAD_DIM, n, _key_mask(mask, b, n, q.device)


def attention_train_fwd(q, k, v, mask, sm_scale: float) -> torch.Tensor:
    """Forward of the training attention: the plain version for a CPU
    tensor, csrc/attention_train.cu for a CUDA one. mask: (B, Nk) key
    mask (1 = attend)."""
    if q.device.type == "cpu":
        return attention_train_plain(q, k, v, mask, sm_scale)
    b, h, n, mask = _train_launch_args("attention_train", q, k, v, mask)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    kernels.call("attention_train_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr(), out.data_ptr(), b, h, n, float(sm_scale),
                 kernels.stream_ptr(out))
    kernels.LAUNCHES["attention_train"] += 1
    return out


def attention_train_bwd(q, k, v, mask, do, sm_scale: float):
    """(dq, dk, dv) of the training attention: the plain version for a
    CPU tensor, the two backward kernels of csrc/attention_train.cu for
    a CUDA one (with a (3, B, H, N) fp32 scratch of row stats). One call
    adds one to the count and launches both kernels (rows, then
    columns)."""
    if q.device.type == "cpu":
        return attention_train_bwd_plain(q, k, v, mask, do, sm_scale)
    b, h, n, mask = _train_launch_args("attention_train_bwd", q, k, v, mask)
    kernels.require_cuda("attention_train_bwd", q, do, dtype=torch.bfloat16)
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty((3, b, h, n), dtype=torch.float32, device=q.device)
    kernels.call("attention_train_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                 stats[2].data_ptr(), b, h, n, float(sm_scale), kernels.stream_ptr(dq))
    kernels.LAUNCHES["attention_train_bwd"] += 1
    return dq, dk, dv


class AttentionTrain(torch.autograd.Function):
    """fused_attention_packed's custom VJP: the backward recomputes P from
    q, k and the mask (no probabilities are saved)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, sm_scale):
        ctx.save_for_backward(q, k, v, mask)
        ctx.sm_scale = sm_scale
        return attention_train_fwd(q, k, v, mask, sm_scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = attention_train_bwd(q, k, v, mask, do, ctx.sm_scale)
        return dq, dk, dv, None, None


def attention_train(q, k, v, mask=None, seed=0, p_drop: float = 0.0,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable packed training attention (fused_attention_packed
    with ragged N): q (B, Nq, H*64), k/v (B, Nk, H*64), mask (B, Nk) key
    mask (1 = attend) -> (B, Nq, H*64). ``seed`` and ``p_drop`` are the
    TPU kernel's dropout arguments; only p_drop = 0 is ported."""
    del seed  # draws no bits at p_drop = 0
    if p_drop > 0.0:
        raise NotImplementedError(
            "attention_train with p_drop > 0 (in-kernel attention dropout) is not "
            "ported to triad_tpu_torch yet (ROADMAP.md slice 3)")
    b, _, hd = q.shape
    if hd % HEAD_DIM:
        raise ValueError(f"packed width {hd} not a multiple of {HEAD_DIM}")
    scale = 1.0 / math.sqrt(HEAD_DIM) if sm_scale is None else sm_scale
    return AttentionTrain.apply(q, k, v, _key_mask(mask, b, k.shape[1], q.device), scale)
