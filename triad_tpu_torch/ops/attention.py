"""Attention: the packed and merged eval kernels, the training kernels
(forward and backward) on the strided, packed and merged layouts, and the
plain masked softmax attention.

Mirrors ``triad_tpu/ops/pallas_attention.py`` (``fused_attention_eval``
and ``fused_attention_eval_merged``, both running ``_head_eval``;
``fused_attention_eval_pair`` and ``fused_attention_eval_merged_pair``,
running ``_head_pair_eval`` on head pairs and ``_head_eval`` on an odd
last head;
``fused_attention``, ``fused_attention_packed`` and
``fused_attention_packed_merged``, running ``_head_fwd`` / ``_head_bwd``)
and the XLA branch of ``triad_tpu/models/layers.py:dot_product_attention``.

``attention_eval`` / ``attention_eval_merged`` and their pair variants
launch ``csrc/attention_eval.cu``, and ``attention_train_strided`` (on (B, H, N,
64) views; ``attention_train`` passes it the heads of packed projections)
and ``attention_train_merged`` (one d(qkv) cotangent)
``csrc/attention_train.cu``, for a CUDA tensor; a CPU tensor runs the
plain version (``*_plain``, ``heads_train_*plain``). There is no fallback from one to
the other: a CUDA tensor the kernel does not take raises. Neither kernel
caps the number of keys: any N >= 1 runs on the card, as on the CPU. The
training attention's dropout keep mask is ``ops/dropout.py``'s, keyed by
(seed, (b0 + b) * H + h) at (query, key), in the kernels and the plain
versions alike (b0: the global index of the first batch row, 0 in one
process).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from triad_tpu_torch import kernels
from triad_tpu_torch.ops import dropout

HEAD_DIM = 64  # the eval kernels slice heads as 64-wide column windows


def _key_mask(mask: Optional[torch.Tensor], b: int, n: int, device) -> torch.Tensor:
    if mask is None:
        return torch.ones((b, n), dtype=torch.float32, device=device)
    return mask.reshape(b, n).to(device=device, dtype=torch.float32).contiguous()


def attention_eval_plain(q, k, v, mask, sm_scale: float, nk_soft: Optional[int] = None):
    """_head_eval for every head: q (B, Nq, H*64), k/v (B, Nk, H*64),
    mask (B, Nk) fp32 (1 = attend) -> (B, Nq, H*64) in q's dtype.

    fp32 scores, key bias (1 - mask) * -1e30, fp32 exp against the row
    max, e rounded to v's dtype before e.V (fp32 accumulation), output
    times 1 / (fp32 row sum). ``nk_soft`` (>= Nk, default Nk): keys in the
    softmax, those past Nk with zero k and v and a -1e30 bias, as the JAX
    adapter pads them (they count only in a row whose keys are all
    masked)."""
    b, nq, hd = q.shape
    nk = k.shape[1]
    h = hd // HEAD_DIM
    pad = (nk_soft or nk) - nk
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (k, v))
    mask = torch.nn.functional.pad(mask.to(torch.float32), (0, pad))

    def heads(x, n):
        return x.reshape(b, n, h, HEAD_DIM).transpose(1, 2).to(torch.float32)

    bias = (1.0 - mask) * -1e30
    s = heads(q, nq) @ heads(k, nk + pad).transpose(-1, -2) * sm_scale
    s = s + bias[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = e.sum(dim=-1, keepdim=True)
    o = (e.to(v.dtype).to(torch.float32) @ heads(v, nk + pad)) * (1.0 / denom)
    return o.transpose(1, 2).reshape(b, nq, hd).to(q.dtype)


PAIR_KEY_PAD = 128  # the pair adapter pads keys to a multiple of 128


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def attention_eval_pair_plain(q, k, v, mask, sm_scale: float) -> torch.Tensor:
    """fused_attention_eval_pair as the JAX adapter calls it
    (layers.py:262-283): keys padded to a multiple of 128 with zero k and
    v and a -1e30 bias, which count in the softmax (a row whose keys are
    all masked averages over the padded count too). Heads in pairs run
    _head_pair_eval: e rounded to v's dtype before both e.V and the row
    sum (fp32 accumulation), output o / sum. An odd last head runs
    _head_eval (attention_eval_plain's numerics). q (B, Nq, H*64), k/v
    (B, Nk, H*64), mask (B, Nk) fp32 -> (B, Nq, H*64) in q's dtype."""
    b, nq, hd = q.shape
    nk = k.shape[1]
    h = hd // HEAD_DIM
    pad = _round_up(nk, PAIR_KEY_PAD) - nk
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (k, v))
    bias = (1.0 - torch.nn.functional.pad(mask.to(torch.float32), (0, pad))) * -1e30
    f32 = torch.float32
    s = _heads(q, h).to(f32) @ _heads(k, h).to(f32).transpose(-1, -2) * sm_scale
    s = s + bias[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    eb = e.to(v.dtype).to(f32)
    o = eb @ _heads(v, h).to(f32)
    paired = 2 * (h // 2)
    out = torch.cat([o[:, :paired] / eb[:, :paired].sum(dim=-1, keepdim=True),
                     o[:, paired:] * (1.0 / e[:, paired:].sum(dim=-1, keepdim=True))], dim=1)
    return _packed(out).to(q.dtype)


def _launch(name, q, k, v, mask, out, nq, nk, h, sm_scale, pair=False, nk_soft=None):
    """q/k/v/out: (B, N, width) views with unit column stride; mask: the
    (B, nk) key mask as given (None: every key attends). ``pair``: the
    head-pair numerics on every head of a pair, and keys padded to a
    multiple of 128 in the softmax, as attention_eval_pair_plain;
    ``nk_soft``: the softmax's key count otherwise (default nk)."""
    b = out.shape[0]
    nk_soft = _round_up(nk, PAIR_KEY_PAD) if pair else nk_soft or nk
    if mask is not None:
        mask = _key_mask(mask, b, nk, out.device)
    kernels.call(
        "attention_eval", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), b, h, nq, nk, nk_soft,
        2 * (h // 2) if pair else 0, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        0 if mask is None else mask.stride(0), float(sm_scale), kernels.stream_ptr(out),
    )
    kernels.LAUNCHES[name] += 1


def _refuse_grad(name, *tensors):
    """The eval kernels have no VJP (the Pallas ones have none either, and
    JAX refuses to differentiate them): refuse, on the CPU and the card
    alike, rather than hand autograd an output that drops the gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        train = "fused_packed_merged" if "merged" in name else "fused_packed"
        raise RuntimeError(f"{name} is an eval kernel with no backward: an input requires "
                           f"grad; train with attention_impl {train!r}, or run under "
                           f"torch.no_grad() / inference_mode()")


def attention_eval(q, k, v, mask=None, sm_scale: Optional[float] = None):
    """Packed-layout eval attention (pallas_attention.fused_attention_eval
    behind the JAX adapter, ragged N): q (B, Nq, H*64), k/v (B, Nk, H*64)
    -> (B, Nq, H*64). With a key mask the softmax counts the adapter's
    128-padded keys (models/layers.py:packed_dot_product_attention,
    eval_pad "hbm"), which shows only in a row whose keys are all masked;
    without one the padded keys weigh nothing and are not counted."""
    _refuse_grad("attention_eval", q, k, v)
    b, nq, hd = q.shape
    nk = k.shape[1]
    if hd % HEAD_DIM:
        raise ValueError(f"packed width {hd} not a multiple of {HEAD_DIM}")
    scale = _scale(sm_scale)
    nk_soft = nk if mask is None else _round_up(nk, PAIR_KEY_PAD)
    if q.device.type == "cpu":
        return attention_eval_plain(q, k, v, _key_mask(mask, b, nk, q.device), scale, nk_soft)
    kernels.require_cuda("attention_eval", q, k, v, dtype=torch.bfloat16)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    _launch("attention_eval", q, k, v, mask, out, nq, nk, hd // HEAD_DIM, scale,
            nk_soft=nk_soft)
    return out


def attention_eval_merged(qkv, mask=None, sm_scale: Optional[float] = None):
    """Merged-qkv eval attention (fused_attention_eval_merged with ragged
    N): qkv (B, N, 3*H*64) with q|k|v at column offsets 0, C, 2C ->
    (B, N, H*64)."""
    _refuse_grad("attention_eval_merged", qkv)
    b, n, hd3 = qkv.shape
    hd = hd3 // 3
    if hd * 3 != hd3 or hd % HEAD_DIM:
        raise ValueError(f"bad merged width {hd3} (not 3*H*{HEAD_DIM})")
    scale = _scale(sm_scale)
    if qkv.device.type == "cpu":
        q, k, v = qkv.split(hd, dim=-1)
        return attention_eval_plain(q, k, v, _key_mask(mask, b, n, qkv.device), scale)
    kernels.require_cuda("attention_eval_merged", qkv, dtype=torch.bfloat16)
    qkv = qkv.contiguous()
    q, k, v = qkv.split(hd, dim=-1)  # views: row stride 3C, offsets 0/C/2C
    out = torch.empty((b, n, hd), dtype=qkv.dtype, device=qkv.device)
    _launch("attention_eval_merged", q, k, v, mask, out, n, n, hd // HEAD_DIM, scale)
    return out


def attention_eval_pair(q, k, v, mask=None, sm_scale: Optional[float] = None):
    """Head-pair packed eval attention (fused_attention_eval_pair behind the
    JAX adapter's padding): q (B, Nq, H*64), k/v (B, Nk, H*64) -> (B, Nq,
    H*64). Ragged N in, the padded keys' softmax share reproduced in the
    kernel (attention_eval_pair_plain)."""
    _refuse_grad("attention_eval_pair", q, k, v)
    b, nq, hd = q.shape
    nk = k.shape[1]
    if hd % HEAD_DIM:
        raise ValueError(f"packed width {hd} not a multiple of {HEAD_DIM}")
    scale = _scale(sm_scale)
    if q.device.type == "cpu":
        return attention_eval_pair_plain(q, k, v, _key_mask(mask, b, nk, q.device), scale)
    kernels.require_cuda("attention_eval_pair", q, k, v, dtype=torch.bfloat16)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    _launch("attention_eval_pair", q, k, v, mask, out, nq, nk, hd // HEAD_DIM, scale,
            pair=True)
    return out


def attention_eval_merged_pair(qkv, mask=None, sm_scale: Optional[float] = None):
    """Head-pair merged-qkv eval attention (fused_attention_eval_merged_pair
    behind the adapter's padding): qkv (B, N, 3*H*64) -> (B, N, H*64)."""
    _refuse_grad("attention_eval_merged_pair", qkv)
    b, n, hd3 = qkv.shape
    hd = hd3 // 3
    if hd * 3 != hd3 or hd % HEAD_DIM:
        raise ValueError(f"bad merged width {hd3} (not 3*H*{HEAD_DIM})")
    scale = _scale(sm_scale)
    if qkv.device.type == "cpu":
        return attention_eval_pair_plain(*qkv.split(hd, dim=-1), _key_mask(mask, b, n, qkv.device),
                                         scale)
    kernels.require_cuda("attention_eval_merged_pair", qkv, dtype=torch.bfloat16)
    qkv = qkv.contiguous()
    q, k, v = qkv.split(hd, dim=-1)
    out = torch.empty((b, n, hd), dtype=qkv.dtype, device=qkv.device)
    _launch("attention_eval_merged_pair", q, k, v, mask, out, n, n, hd // HEAD_DIM, scale,
            pair=True)
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
# Training attention: one math (_head_fwd / _head_bwd), three layouts
# ---------------------------------------------------------------------------
#
# pallas_attention.py runs the same per-head bodies on three layouts:
# fused_attention on strided (B, H, T, D) tensors, fused_attention_packed on
# packed (B, N, H*64) projections and fused_attention_packed_merged on one
# merged (B, N, 3*H*64) qkv tensor. Here every layout is seen as (B, H, N,
# 64) views: the plain twins compute on those views, and the kernels of
# csrc/attention_train.cu take each view's (batch, head, row) strides. The
# keep mask depends on (seed, b * H + h, query, key) only, so the three
# layouts give the same outputs on the same inputs and seed.


def _heads(x, h):
    """(B, N, h*64) -> its (B, h, N, 64) view (no copy)."""
    return x.unflatten(-1, (h, HEAD_DIM)).transpose(1, 2)


def _packed(x):
    """(B, h, N, 64) -> (B, N, h*64)."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _train_scores(q, k, mask, sm_scale):
    """_head_fwd's fp32 S per head: q k^T s + (1 - mask) * -1e30."""
    bias = (1.0 - mask.to(torch.float32)) * -1e30
    s = q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2) * sm_scale
    return s + bias[:, None, None, :]


def _train_probs(q, k, mask, sm_scale):
    """_head_fwd's fp32 P per head: softmax(q k^T s + (1 - mask) * -1e30)."""
    s = _train_scores(q, k, mask, sm_scale)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def train_row_stats_plain(q, k, mask, sm_scale: float) -> torch.Tensor:
    """The row statistics the training forward kernel hands its backward:
    (2, B, H, N) fp32, [0] the row max m of S (with the key bias), [1] the
    row sum l of exp(S - m), so P = exp(S - m) / l. q, k: (B, H, N, 64)
    views; mask (B, N)."""
    s = _train_scores(q, k, mask, sm_scale)
    m = s.amax(dim=-1)
    return torch.stack([m, torch.exp(s - m[..., None]).sum(dim=-1)])


def _train_bwd_terms(q, k, v, mask, do, sm_scale, seed, p_drop, b0=0):
    """_head_bwd's fp32 P, keep mask and dP = (dO V^T) * keep / (1 - p)
    per head, on (B, H, N, 64) views."""
    b, h, nq, _ = q.shape
    p = _train_probs(q, k, mask, sm_scale)
    keep = attention_keep(b, h, nq, k.shape[2], seed, p_drop, q.device, b0)
    dp = dropout.apply_keep(do.to(torch.float32) @ v.to(torch.float32).transpose(-1, -2), keep,
                            p_drop)
    return p, keep, dp


def _rowsum_dp_p(dp, p):
    """di = rowsum(dP * P) as the dQ kernel sums it: the fp32 products and
    their sum in fp64, rounded once to fp32 (where _head_bwd sums in fp32:
    attention_train.cu says why)."""
    return (dp.to(torch.float64) * p.to(torch.float64)).sum(dim=-1).to(torch.float32)


def train_di_plain(q, k, v, mask, do, sm_scale: float, seed: int = 0,
                   p_drop: float = 0.0, b0: int = 0) -> torch.Tensor:
    """The (B, H, N) fp32 di = rowsum(dP * P) of _head_bwd (:208) that the
    training dQ kernel writes for its dK/dV kernel, on (B, H, N, 64)
    views."""
    p, _, dp = _train_bwd_terms(q, k, v, mask, do, sm_scale, seed, p_drop, b0)
    return _rowsum_dp_p(dp, p)


def attention_keep(b: int, h: int, nq: int, nk: int, seed: int, p_drop: float, device,
                   b0: int = 0):
    """The (B, H, Nq, Nk) keep mask of the training attention (stream
    (b0 + b) * H + h, row = query, col = key; b0 the global index of the
    first batch row)."""
    keep = dropout.keep_mask(seed, list(range(b0 * h, (b0 + b) * h)), nq, nk, p_drop, device)
    return keep.reshape(b, h, nq, nk)


def heads_train_plain(q, k, v, mask, sm_scale: float, seed: int = 0,
                      p_drop: float = 0.0, b0: int = 0) -> torch.Tensor:
    """_head_fwd for every head: q (B, H, Nq, 64), k/v (B, H, Nk, 64) of any
    strides, mask (B, Nk) fp32 -> (B, H, Nq, 64) fp32. fp32 scores and
    softmax, P normalised in fp32, D = P * keep / (1 - p) in fp32 and then
    rounded to v's dtype before D.V (fp32 accumulation)."""
    b, h, nq, _ = q.shape
    p = _train_probs(q, k, mask, sm_scale)
    p = dropout.apply_keep(p, attention_keep(b, h, nq, k.shape[2], seed, p_drop, q.device, b0),
                           p_drop)
    return p.to(v.dtype).to(torch.float32) @ v.to(torch.float32)


def heads_train_bwd_plain(q, k, v, mask, do, sm_scale: float, seed: int = 0,
                          p_drop: float = 0.0, b0: int = 0):
    """_head_bwd for every head, written out in fp32 (not autograd), on
    (B, H, N, 64) views: dD = dO V^T, dP = dD * keep / (1 - p), D = P *
    keep / (1 - p), dV = D^T dO, di = rowsum(dP * P) (summed in fp64, as
    the kernel sums it), dS = P (dP - di), dQ = dS K s, dK = dS^T Q s.
    Returns fp32 (dq, dk, dv)."""
    f32 = torch.float32
    p, keep, dp = _train_bwd_terms(q, k, v, mask, do, sm_scale, seed, p_drop, b0)
    dv = dropout.apply_keep(p, keep, p_drop).transpose(-1, -2) @ do.to(f32)
    ds = p * (dp - _rowsum_dp_p(dp, p)[..., None])
    dq = ds @ k.to(f32) * sm_scale
    dk = ds.transpose(-1, -2) @ q.to(f32) * sm_scale
    return dq, dk, dv


def attention_train_plain(q, k, v, mask, sm_scale: float, seed: int = 0,
                          p_drop: float = 0.0, b0: int = 0) -> torch.Tensor:
    """The packed layout: q (B, Nq, H*64), k/v (B, Nk, H*64), mask (B, Nk)
    fp32 -> (B, Nq, H*64) in q's dtype (heads_train_plain)."""
    h = q.shape[-1] // HEAD_DIM
    o = heads_train_plain(_heads(q, h), _heads(k, h), _heads(v, h), mask, sm_scale, seed,
                          p_drop, b0)
    return _packed(o).to(q.dtype)


def attention_train_bwd_plain(q, k, v, mask, do, sm_scale: float, seed: int = 0,
                              p_drop: float = 0.0, b0: int = 0):
    """(dq, dk, dv) of the packed layout in the dtypes of q, k, v."""
    h = q.shape[-1] // HEAD_DIM
    grads = heads_train_bwd_plain(*(_heads(x, h) for x in (q, k, v)), mask, _heads(do, h),
                                  sm_scale, seed, p_drop, b0)
    return tuple(_packed(g).to(x.dtype) for g, x in zip(grads, (q, k, v)))


def attention_train_merged_plain(qkv, mask, sm_scale: float, seed: int = 0,
                                 p_drop: float = 0.0, b0: int = 0) -> torch.Tensor:
    """The merged layout (fused_attention_packed_merged): qkv (B, N, 3C)
    with q|k|v at column offsets 0, C, 2C -> (B, N, C) in qkv's dtype."""
    return attention_train_plain(*qkv.chunk(3, dim=-1), mask, sm_scale, seed, p_drop, b0)


def attention_train_merged_bwd_plain(qkv, mask, do, sm_scale: float, seed: int = 0,
                                     p_drop: float = 0.0, b0: int = 0) -> torch.Tensor:
    """The one merged d(qkv) (B, N, 3C) in qkv's dtype."""
    grads = attention_train_bwd_plain(*qkv.chunk(3, dim=-1), mask, do, sm_scale, seed, p_drop,
                                      b0)
    return torch.cat(grads, dim=-1)


def _addressable(x: torch.Tensor) -> torch.Tensor:
    """x itself if the kernels can address it (unit column stride, every
    stride a multiple of 8 elements, a 16-byte aligned base), else a
    contiguous copy."""
    if x.stride(-1) == 1 and all(s % 8 == 0 for s in x.stride()[:-1]) \
            and x.data_ptr() % 16 == 0:
        return x
    return x.contiguous()


def _strides(*views):
    """The (batch, head, row) element strides of (B, H, N, 64) views, as
    the C array the kernels take (a row stride must fit in 32 bits)."""
    if any(x.stride(2) >= 2 ** 31 for x in views):
        raise ValueError("attention_train: a row stride of 2^31 elements or more")
    flat = [s for x in views for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _train_launch_args(name, q, k, v, mask):
    """Check (B, H, N, 64) views for the kernels (bf16 on one CUDA device,
    self-attention shapes; any N) and return the key mask as a contiguous
    (B, N) fp32 tensor on q's device."""
    kernels.require_cuda(name, q, k, v, dtype=torch.bfloat16)
    if k.shape != q.shape or v.shape != q.shape or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes self-attention shapes with heads of "
                         f"{HEAD_DIM}, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return _key_mask(mask, q.shape[0], q.shape[2], q.device)


def _train_fwd_kernel(name, q, k, v, out, mask, sm_scale, seed, p_drop, b0=0):
    """csrc/attention_train.cu forward on (B, H, N, 64) views; out written
    through its own view. Returns what the backward kernels take: the
    (2, B, H, N) fp32 row stats (m, l)."""
    mask = _train_launch_args(name, q, k, v, mask)
    b, h, n, _ = q.shape
    stats = torch.empty((2, b, h, n), dtype=torch.float32, device=q.device)
    kernels.call("attention_train_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr(), out.data_ptr(), stats.data_ptr(), _strides(q, k, v, out), b,
                 h, n, float(sm_scale), *kernels.dropout_args(seed, p_drop, b0 * h),
                 kernels.stream_ptr(out))
    kernels.LAUNCHES[name] += 1
    return stats


def _train_bwd_kernel(name, q, k, v, do, dq, dk, dv, mask, saved, sm_scale, seed, p_drop,
                      b0=0):
    """The two backward kernels (dQ with di = rowsum(dP * P), then dK/dV) on
    (B, H, N, 64) views, from the row stats the forward saved, with a (B,
    H, N) fp32 di scratch and, with dropout, the keep bits' scratch (B H N
    ceil(N / 64) 2 words: N^2 / 8 bytes per head); one count per call."""
    mask = _train_launch_args(name, q, k, v, mask)
    b, h, n, _ = q.shape
    if not isinstance(saved, torch.Tensor) or saved.shape != (2, b, h, n) \
            or saved.dtype != torch.float32:
        raise ValueError(f"{name}: needs what the forward saved: the (2, {b}, {h}, {n}) fp32 "
                         f"row stats")
    kernels.require_cuda(name, q, do, dtype=torch.bfloat16)
    kernels.require_cuda(name, q, saved)
    stats = saved.contiguous()
    di = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    kbits = None
    if p_drop > 0:
        kbits = torch.empty((b * h * n * -(-n // 64) * 2,), dtype=torch.int32, device=q.device)
    kernels.call("attention_train_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr(), do.data_ptr(), stats.data_ptr(), di.data_ptr(),
                 None if kbits is None else kbits.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), _strides(q, k, v, do, dq, dk, dv), b, h, n, float(sm_scale),
                 *kernels.dropout_args(seed, p_drop, b0 * h), kernels.stream_ptr(dq))
    kernels.LAUNCHES[name] += 1


def _heads_major(x: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, N, 64) tensor like x, laid out as (B, N, H, 64)."""
    b, h, n, d = x.shape
    return torch.empty((b, n, h, d), dtype=x.dtype, device=x.device).transpose(1, 2)


def attention_train_strided_fwd(q, k, v, mask, sm_scale: float, seed: int = 0,
                                p_drop: float = 0.0, count: str = "attention_train_strided",
                                b0: int = 0):
    """(out, saved): the forward on (B, H, N, 64) views of any strides the
    kernels can address (fused_attention's (B, H, T, D) tensors, or the
    heads of packed (B, N, H*64) projections: no copy). A CPU tensor runs
    heads_train_plain and saves None; a CUDA one runs the kernel, counted
    under ``count`` in kernels.LAUNCHES, and saves what the backward
    kernels take (train_row_stats_plain's row stats). On the card ``out`` is a (B,
    H, N, 64) view of (B, N, H, 64) memory, the packed layout, which
    _packed reshapes with no copy."""
    if q.device.type == "cpu":
        return heads_train_plain(q, k, v, mask, sm_scale, seed, p_drop, b0).to(q.dtype), None
    q, k, v = (_addressable(x) for x in (q, k, v))
    out = _heads_major(q)
    return out, _train_fwd_kernel(count, q, k, v, out, mask, sm_scale, seed, p_drop, b0)


def attention_train_strided_bwd(q, k, v, mask, do, sm_scale: float, seed: int = 0,
                                p_drop: float = 0.0, count: str = "attention_train_strided_bwd",
                                saved=None, b0: int = 0):
    """(dq, dk, dv) of attention_train_strided_fwd in the dtypes of q, k, v
    (on the card in the forward output's layout); seed and p_drop are the
    forward's, and so is ``saved``, which the kernels need (a CPU tensor
    runs heads_train_bwd_plain, which recomputes everything)."""
    if q.device.type == "cpu":
        grads = heads_train_bwd_plain(q, k, v, mask, do, sm_scale, seed, p_drop, b0)
        return tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v)))
    q, k, v, do = (_addressable(x) for x in (q, k, v, do))
    grads = [_heads_major(x) for x in (q, k, v)]
    _train_bwd_kernel(count, q, k, v, do, *grads, mask, saved, sm_scale, seed, p_drop, b0)
    return tuple(grads)


def attention_train_fwd(q, k, v, mask, sm_scale: float, seed: int = 0, p_drop: float = 0.0,
                        b0: int = 0):
    """Packed forward (fused_attention_packed): q (B, Nq, H*64), k/v (B, Nk,
    H*64) -> (out (B, Nq, H*64), saved), through the heads' views. mask:
    (B, Nk) key mask (1 = attend); seed, p_drop: the attention dropout;
    saved: as attention_train_strided_fwd; b0: the global index of the
    first batch row (the dropout streams)."""
    h = q.shape[-1] // HEAD_DIM
    out, saved = attention_train_strided_fwd(*(_heads(x, h) for x in (q, k, v)), mask, sm_scale,
                                             seed, p_drop, "attention_train", b0)
    return _packed(out), saved


def attention_train_bwd(q, k, v, mask, do, sm_scale: float, seed: int = 0,
                        p_drop: float = 0.0, saved=None, b0: int = 0):
    """(dq, dk, dv) of the packed layout; seed, p_drop and (on the card)
    ``saved`` are the forward's."""
    h = q.shape[-1] // HEAD_DIM
    grads = attention_train_strided_bwd(*(_heads(x, h) for x in (q, k, v)), mask, _heads(do, h),
                                        sm_scale, seed, p_drop, "attention_train_bwd", saved,
                                        b0)
    return tuple(_packed(g) for g in grads)


def attention_train_merged_fwd(qkv, mask, sm_scale: float, seed: int = 0, p_drop: float = 0.0,
                               b0: int = 0):
    """Merged forward (fused_attention_packed_merged): q, k, v read at
    column offsets 0, C, 2C of one (B, N, 3C) tensor -> (out (B, N, C),
    saved); saved: as attention_train_strided_fwd."""
    if qkv.device.type == "cpu":
        return attention_train_merged_plain(qkv, mask, sm_scale, seed, p_drop, b0), None
    qkv = _addressable(qkv)
    b, n, c3 = qkv.shape
    h = c3 // 3 // HEAD_DIM
    out = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    return out, _train_fwd_kernel("attention_train_merged",
                                  *(_heads(x, h) for x in (*qkv.chunk(3, dim=-1), out)), mask,
                                  sm_scale, seed, p_drop, b0)


def attention_train_merged_bwd(qkv, mask, do, sm_scale: float, seed: int = 0,
                               p_drop: float = 0.0, saved=None, b0: int = 0) -> torch.Tensor:
    """The one merged d(qkv) (B, N, 3C): the backward kernels write dq, dk
    and dv at column offsets 0, C and 2C of it, from what the forward
    saved."""
    if qkv.device.type == "cpu":
        return attention_train_merged_bwd_plain(qkv, mask, do, sm_scale, seed, p_drop, b0)
    qkv, do = _addressable(qkv), _addressable(do)
    dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
    h = qkv.shape[-1] // 3 // HEAD_DIM
    views = (*qkv.chunk(3, dim=-1), do, *dqkv.chunk(3, dim=-1))
    _train_bwd_kernel("attention_train_merged_bwd", *(_heads(x, h) for x in views), mask, saved,
                      sm_scale, seed, p_drop, b0)
    return dqkv


class AttentionTrain(torch.autograd.Function):
    """The custom VJP on (B, H, N, 64) views: the backward recomputes P from
    the inputs, the mask and the forward's row stats (m, l), forms di =
    rowsum(dP * P) itself, and replays the dropout mask from the seed (no
    probabilities or masks are saved; on the CPU nothing but the inputs).
    apply(q, k, v, mask, sm_scale, seed, p_drop, count, b0): the kernels
    count under ``count`` and ``count + "_bwd"``."""

    @staticmethod
    def forward(ctx, q, k, v, mask, sm_scale, seed, p_drop, count, b0=0):
        ctx.args = (sm_scale, seed, p_drop, count, b0)
        out, saved = attention_train_strided_fwd(q, k, v, mask, sm_scale, seed, p_drop, count,
                                                 b0)
        ctx.save_for_backward(q, k, v, mask, saved)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, saved = ctx.saved_tensors
        sm_scale, seed, p_drop, count, b0 = ctx.args
        grads = attention_train_strided_bwd(q, k, v, mask, do, sm_scale, seed, p_drop,
                                            f"{count}_bwd", saved, b0)
        return (*grads, None, None, None, None, None, None)


class AttentionTrainMerged(torch.autograd.Function):
    """The merged layout's VJP, whose one cotangent is the (B, N, 3C)
    d(qkv) the backward kernels fill from what the forward saved.
    apply(qkv, mask, sm_scale, seed, p_drop, b0)."""

    @staticmethod
    def forward(ctx, qkv, mask, sm_scale, seed, p_drop, b0=0):
        ctx.args = (sm_scale, seed, p_drop)
        ctx.b0 = b0
        out, saved = attention_train_merged_fwd(qkv, mask, sm_scale, seed, p_drop, b0)
        ctx.save_for_backward(qkv, mask, saved)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, mask, saved = ctx.saved_tensors
        return (attention_train_merged_bwd(qkv, mask, do, *ctx.args, saved, ctx.b0), None, None,
                None, None, None)


def _scale(sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(HEAD_DIM) if sm_scale is None else float(sm_scale)


def attention_train_strided(q, k, v, mask=None, seed: int = 0, p_drop: float = 0.0,
                            sm_scale: Optional[float] = None,
                            count: str = "attention_train_strided", b0: int = 0) -> torch.Tensor:
    """Differentiable training attention (fused_attention with ragged T) on
    (B, H, T, 64) views of any strides, mask (B, T) key mask (1 = attend)
    -> (B, H, T, 64), with attention dropout at rate ``p_drop`` drawn from
    the int32 ``seed`` for global batch rows b0 .. b0 + B - 1; the kernels
    count under ``count``."""
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the training kernels take heads of {HEAD_DIM}, got {q.shape[-1]}")
    return AttentionTrain.apply(q, k, v, _key_mask(mask, q.shape[0], k.shape[2], q.device),
                                _scale(sm_scale), int(seed), float(p_drop), count, int(b0))


def attention_train(q, k, v, mask=None, seed: int = 0, p_drop: float = 0.0,
                    sm_scale: Optional[float] = None, b0: int = 0) -> torch.Tensor:
    """Differentiable packed training attention (fused_attention_packed
    with ragged N): q (B, Nq, H*64), k/v (B, Nk, H*64), mask (B, Nk) ->
    (B, Nq, H*64): attention_train_strided on the heads' views."""
    hd = q.shape[-1]
    if hd % HEAD_DIM:
        raise ValueError(f"packed width {hd} not a multiple of {HEAD_DIM}")
    h = hd // HEAD_DIM
    return _packed(attention_train_strided(*(_heads(x, h) for x in (q, k, v)), mask, seed, p_drop,
                                           sm_scale, "attention_train", b0))


def attention_train_merged(qkv, mask=None, seed: int = 0, p_drop: float = 0.0,
                           sm_scale: Optional[float] = None, b0: int = 0) -> torch.Tensor:
    """Differentiable merged-qkv training attention
    (fused_attention_packed_merged with ragged N): qkv (B, N, 3*H*64) ->
    (B, N, H*64), with one d(qkv) cotangent."""
    b, n, hd3 = qkv.shape
    if hd3 % (3 * HEAD_DIM):
        raise ValueError(f"bad merged width {hd3} (not 3*H*{HEAD_DIM})")
    return AttentionTrainMerged.apply(qkv, _key_mask(mask, b, n, qkv.device), _scale(sm_scale),
                                      int(seed), float(p_drop), int(b0))
