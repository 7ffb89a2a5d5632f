"""Flash attention, forward and backward: the "flash" attention route.

Mirrors ``triad_tpu/models/layers.py:flash_dot_product_attention``, which
pads N to a multiple of 128 with masked keys, turns the key mask into
segment ids and calls JAX's library kernel
``jax.experimental.pallas.ops.tpu.flash_attention`` (forward ``:395-558``,
backward ``:265-316``, dK/dV ``:796-938``, dQ ``:1146-1260``) with blocks
of ``min(512, round_up(N, 128))`` keys and queries.

Numerics of the library kernel, kept by the twin and the CUDA kernels:
S = q.k^T accumulated in fp32, times ``sm_scale``, plus ``MASK_VALUE``
(-0.7 * the largest fp32) on a masked or padded key. Forward: the row max
m and the fp32 exp against it; within one block (N padded to at most 512)
P = exp(S - m) / l, rounded to v's dtype before P.V; over several blocks
the online recurrence: bf16(exp(S - m_next)).V with the accumulator
scaled by l_corr / l_next and o_curr by 1 / l_next. The forward keeps m
and l per row. Backward: di = rowsum(O * dO) in fp32 from the rounded O;
P = exp(S - m) * (1 / l); dV = bf16(P)^T dO; dS = (dO V^T - di) * P *
sm_scale; dK = bf16(dS)^T Q; dQ = bf16(dS) K. A row whose keys are all
masked is uniform over the 128-padded key count, whose padded keys carry
zero k and v.

``flash_attention`` is the autograd Function's entry point on (B, H, N,
64) views. For a CPU tensor it runs the plain twins (``flash_fwd_plain``,
``flash_bwd_plain``); for a CUDA tensor it launches
``csrc/attention_flash.cu`` (its forward, and di + dK/dV + dQ kernels in
one backward call) or raises: there is no path from one to the other. It
takes the lengths the JAX adapter takes (a 128-padded N of at most 512, or
a multiple of 512) and raises a ValueError elsewhere, as the reference
fails there; the kernels themselves have no key cap.

The kernels load q, k, v and dO by TMA: ``tma_plan`` gives each view's
tensor map (dims, byte strides, box), which the C side encodes as it is.
They walk 64-key tiles with an online softmax and round the un-normalised
exp(S - m) to bf16; ``flash_fwd_tiled_plain`` is that order, for tests.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from triad_tpu_torch import kernels
from triad_tpu_torch.ops.attention import (
    HEAD_DIM,
    _addressable,
    _heads_major,
    _key_mask,
    _strides,
)

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # the library's DEFAULT_MASK_VALUE
KEY_PAD = 128  # the adapter pads N to a multiple of 128 with masked keys
BLOCK = 512  # the adapter's block: min(512, the padded N)
TILE = 64  # rows of the kernels' tiles: the TMA box and the key tiles the forward walks


def padded_length(n: int) -> int:
    """The adapter's padded N; raises where the library kernel would (its
    blocks must divide the padded N)."""
    n_pad = -(-n // KEY_PAD) * KEY_PAD
    if n_pad > BLOCK and n_pad % BLOCK:
        raise ValueError(f"flash attention: N = {n} pads to {n_pad}, which the reference's "
                         f"{BLOCK}-row blocks do not divide")
    return n_pad


def _scores(q, k, key_mask, sm_scale):
    """fp32 S = q.k^T * sm_scale + MASK_VALUE on masked keys, over the real
    keys; q (B, H, Nq, 64), k (B, H, Nk, 64), key_mask (B, Nk) or None."""
    f32 = torch.float32
    s = q.to(f32) @ k.to(f32).transpose(-1, -2) * sm_scale
    if key_mask is None:
        return s
    bias = torch.where(key_mask.to(torch.bool), 0.0, MASK_VALUE).to(f32)
    return s + bias[:, None, None, :]


def flash_fwd_plain(q, k, v, key_mask: Optional[torch.Tensor], sm_scale: float):
    """The library forward on (B, H, N, 64) tensors: (O in q's dtype, l, m)
    with l and m fp32 (B, H, N). Keys are padded to the adapter's length
    (zero k and v, masked) and walked in its blocks."""
    b, h, n, _ = q.shape
    n_pad = padded_length(n)
    block = min(BLOCK, n_pad)
    f32 = torch.float32
    keep = torch.ones((b, n), dtype=torch.bool) if key_mask is None else key_mask.to(torch.bool)
    keep = torch.nn.functional.pad(keep.to(q.device), (0, n_pad - n))
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, n_pad - n)) for x in (k, v))
    if block == n_pad:
        s = _scores(q, kp, keep, sm_scale)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        l = p.sum(dim=-1)
        p = p / l[..., None]
        o = p.to(v.dtype).to(f32) @ vp.to(f32)
        return o.to(q.dtype), l, m
    m = torch.full((b, h, n), float("-inf"), dtype=f32, device=q.device)
    l = torch.zeros((b, h, n), dtype=f32, device=q.device)
    acc = torch.zeros((b, h, n, HEAD_DIM), dtype=f32, device=q.device)
    for j in range(0, n_pad, block):
        s = _scores(q, kp[:, :, j:j + block], keep[:, j:j + block], sm_scale)
        m_next = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_next[..., None])
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(dim=-1) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        acc = acc * (l_corr * inv)[..., None]
        o_curr = p.to(v.dtype).to(f32) @ vp[:, :, j:j + block].to(f32)
        acc = acc + o_curr * inv[..., None]
        m, l = m_next, l_next
    return acc.to(q.dtype), l, m


def flash_fwd_tiled_plain(q, k, v, key_mask: Optional[torch.Tensor], sm_scale: float,
                          tile: int = TILE):
    """The forward kernel's own rounding order on (B, H, N, 64) tensors,
    for tests: an online softmax over key tiles of ``tile`` keys (running
    max m, sum l; the accumulator times exp(m - m_next) at each tile), the
    un-normalised exp(S - m_next) rounded to v's dtype before P.V, the
    adapter's padded keys counted in l alone, O = acc * (1 / l). Returns
    (O in q's dtype, l, m) as flash_fwd_plain does."""
    b, h, n, _ = q.shape
    f32 = torch.float32
    m = torch.full((b, h, n), float("-inf"), dtype=f32, device=q.device)
    l = torch.zeros((b, h, n), dtype=f32, device=q.device)
    acc = torch.zeros((b, h, n, HEAD_DIM), dtype=f32, device=q.device)
    for j in range(0, n, tile):
        mask = None if key_mask is None else key_mask[:, j:j + tile]
        s = _scores(q, k[:, :, j:j + tile], mask, sm_scale)
        m_next = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p.to(v.dtype).to(f32) @ v[:, :, j:j + tile].to(f32)
        m = m_next
    l = l + (padded_length(n) - n) * torch.exp(MASK_VALUE - m)
    return (acc * (1.0 / l)[..., None]).to(q.dtype), l, m


def flash_bwd_plain(q, k, v, key_mask, o, l, m, do, sm_scale: float):
    """The library backward: (dq, dk, dv) in the dtypes of q, k, v. The
    padded keys add nothing here (zero k and v; their gradients are
    dropped), so only the real keys are formed; they count through l."""
    f32 = torch.float32
    di = (o.to(f32) * do.to(f32)).sum(dim=-1)
    p = torch.exp(_scores(q, k, key_mask, sm_scale) - m[..., None]) * (1.0 / l)[..., None]
    dv = p.to(do.dtype).to(f32).transpose(-1, -2) @ do.to(f32)
    dp = do.to(f32) @ v.to(f32).transpose(-1, -2)
    ds = (dp - di[..., None]) * p * sm_scale
    dk = ds.to(q.dtype).to(f32).transpose(-1, -2) @ q.to(f32)
    dq = ds.to(k.dtype).to(f32) @ k.to(f32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tma_plan(x: torch.Tensor):
    """The tensor map through which the kernels load a (B, H, N, 64) bf16
    view: (dims, byte strides, box), innermost first. dims (64, N, H, B);
    the byte strides of rows, heads and batches (a dim of size 1 is never
    stepped and takes the packed stride); box (64, TILE, 1, 1), 128 bytes a
    row, the 128-byte swizzle's width. Raises where TMA cannot address the
    view: columns not unit-strided, a base not 16-byte aligned, a stride
    not a multiple of 16 bytes or of 2^40 bytes or more (``_addressable``
    copies such a view first)."""
    b, h, n, d = x.shape
    size = x.element_size()
    if d != HEAD_DIM or d * size != 128 or x.stride(3) != 1:
        raise ValueError(f"tma_plan: rows of {HEAD_DIM} contiguous 2-byte elements, got "
                         f"{tuple(x.shape)} {x.dtype} with strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError("tma_plan: the base address is not 16-byte aligned")
    strides, packed = [], d * size
    for dim, stride in zip((n, h, b), (x.stride(2), x.stride(1), x.stride(0))):
        byte_stride = stride * size if dim > 1 else packed
        if byte_stride % 16 or not 0 < byte_stride < 2 ** 40:
            raise ValueError(f"tma_plan: a byte stride of {byte_stride} (strides {x.stride()})")
        strides.append(byte_stride)
        packed = byte_stride * dim
    return (d, n, h, b), tuple(strides), (d, TILE, 1, 1)


def _plans(*views):
    """The C array of tma_plan per view: dims (4), byte strides (3) and the
    box's rows, 8 longs each."""
    flat = []
    for x in views:
        dims, strides, box = tma_plan(x)
        flat += [*dims, *strides, box[1]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _check(name, q, k, v):
    kernels.require_cuda(name, q, k, v, dtype=torch.bfloat16)
    if k.shape != q.shape or v.shape != q.shape or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes self-attention shapes with heads of "
                         f"{HEAD_DIM}, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


def flash_attention_fwd(q, k, v, key_mask, sm_scale: float):
    """(O, l, m) of (B, H, N, 64) views: the twin for a CPU tensor, the
    forward kernel for a CUDA one (O as a (B, H, N, 64) view of (B, N, H,
    64) memory, so the caller's transpose back is free)."""
    n_soft = padded_length(q.shape[2])
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, key_mask, sm_scale)
    _check("flash_attention", q, k, v)
    b, h, n, _ = q.shape
    q, k, v = (_addressable(x) for x in (q, k, v))
    mask = _key_mask(key_mask, b, n, q.device)
    out = _heads_major(q)
    lm = torch.empty((2, b, h, n), dtype=torch.float32, device=q.device)
    kernels.call("flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr(), out.data_ptr(), lm[0].data_ptr(),
                 lm[1].data_ptr(), _strides(out), _plans(q, k, v), b, h, n, n_soft,
                 float(sm_scale), kernels.stream_ptr(out))
    kernels.LAUNCHES["flash_attention"] += 1
    return out, lm[0], lm[1]


def flash_attention_bwd(q, k, v, key_mask, o, l, m, do, sm_scale: float):
    """(dq, dk, dv) of flash_attention_fwd: the twin for a CPU tensor; for
    a CUDA one the backward call (di, then the dK/dV and dQ kernels),
    counted once, with the gradients in the (B, N, H, 64) layout."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, key_mask, o, l, m, do, sm_scale)
    _check("flash_attention_bwd", q, k, v)
    kernels.require_cuda("flash_attention_bwd", q, o, do, dtype=torch.bfloat16)
    b, h, n, _ = q.shape
    q, k, v, o, do = (_addressable(x) for x in (q, k, v, o, do))
    l, m = l.contiguous(), m.contiguous()
    mask = _key_mask(key_mask, b, n, q.device)
    grads = [_heads_major(x) for x in (q, k, v)]
    di = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    kernels.call("flash_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr(), o.data_ptr(), do.data_ptr(),
                 l.data_ptr(), m.data_ptr(), di.data_ptr(), *(g.data_ptr() for g in grads),
                 _strides(o, do, *grads), _plans(q, k, v, do), b, h, n, float(sm_scale),
                 kernels.stream_ptr(do))
    kernels.LAUNCHES["flash_attention_bwd"] += 1
    return tuple(grads)


class FlashAttention(torch.autograd.Function):
    """The library's custom VJP: the forward saves O, l and m; the backward
    recomputes P tile by tile from them. apply(q, k, v, key_mask, sm_scale)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, sm_scale):
        o, l, m = flash_attention_fwd(q, k, v, key_mask, sm_scale)
        ctx.save_for_backward(q, k, v, key_mask, o, l, m)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, o, l, m = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, key_mask, o, l, m, do, ctx.sm_scale), None, None)


def flash_attention(q, k, v, key_mask: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention on (B, H, N, 64) views: softmax(q k^T
    * sm_scale) v over the keys that ``key_mask`` (B, N, 1 = attend) keeps,
    with the library kernel's numerics (module docstring). Output in q's
    dtype, (B, H, N, 64)."""
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the flash kernels take heads of {HEAD_DIM}, got {q.shape[-1]}")
    scale = HEAD_DIM ** -0.5 if sm_scale is None else float(sm_scale)
    return FlashAttention.apply(q, k, v, key_mask, scale)
