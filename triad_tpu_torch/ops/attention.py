"""Inference attention: the packed and merged eval kernels and the plain
masked softmax attention.

Mirrors ``triad_tpu/ops/pallas_attention.py`` (``fused_attention_eval``
and ``fused_attention_eval_merged``, both running ``_head_eval``) and the
XLA branch of ``triad_tpu/models/layers.py:dot_product_attention``.

``attention_eval`` / ``attention_eval_merged`` launch
``csrc/attention_eval.cu`` for a CUDA tensor and run
``attention_eval_plain`` for a CPU tensor. There is no fallback from one
to the other: a CUDA tensor the kernel does not take raises.
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


def masked_attention(q, k, v, mask, dtype, scores_dtype=torch.float32):
    """The XLA branch of triad_tpu.models.layers.dot_product_attention.

    q, k, v: (B, N, H, Dh); mask: optional (B, 1, 1, Nk) bool (True =
    attend). fp32 scores: finfo(fp32).min on masked keys and an fp32
    softmax cast to ``dtype``. bf16 scores: -1e4 on masked keys, a
    bf16 max-subtracted exp (exp itself in fp32) and bf16 probs."""
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
        return (probs @ vh).transpose(1, 2)
    scores = (qs @ kt).to(scores_dtype)
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e4)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp((scores - m).to(torch.float32)).to(dtype)
    probs = e / e.sum(dim=-1, keepdim=True).to(dtype)
    return (probs @ vh).transpose(1, 2)
