"""Token similarities (mirrors ``triad_tpu/ops/similarity.py`` and the
pair scorer of ``triad_tpu/serve/export.py``): the inference-path
pairwise sims and retrieval scores, and the training path's cross-batch
max-mean aggregation with its hand-written backward (and, for
``implementation="pallas"``, the max-mean kernels of ``ops/maxmean.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from triad_tpu_torch.ops.maxmean import coefficients, maxmean_aggregate


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize semantics: x / max(||x||, eps)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


def pairwise_similarity(feats1, feats2, temperature) -> torch.Tensor:
    """(B, N1, D), (B, N2, D) -> (B, N1, N2) fp32: both sides L2-normalized,
    multiplied by the temperature."""
    f1 = l2_normalize(feats1.to(torch.float32))
    f2 = l2_normalize(feats2.to(torch.float32))
    return (f1 @ f2.transpose(1, 2)) * temperature.to(torch.float32)


def pair_scores(q_tokens, q_mask, k_tokens, k_mask, inv_temp) -> torch.Tensor:
    """Max-mean retrieval scores (serve/export.py:_pair_scores_fn):
    (q, Nq, D), (q, Nq), (k, Nk, D), (k, Nk) -> (q, k) fp32. Token sims
    times 1/T, max over unmasked key tokens, masked mean over query
    tokens (count clamped at 1)."""
    f32 = torch.float32
    sims = torch.einsum("qnd,kmd->qnkm", q_tokens.to(f32), k_tokens.to(f32)) * inv_temp
    sims = sims.masked_fill(~(k_mask[None, None] > 0), torch.finfo(f32).min)
    mx = sims.amax(dim=3)  # (q, Nq, k)
    counts = torch.clamp(q_mask.to(f32).sum(dim=1), min=1.0)
    return (mx * q_mask.to(f32)[:, :, None]).sum(dim=1) / counts[:, None]


def diag_token_sims(query, key, temperature) -> torch.Tensor:
    """Positive-pair (i == i) token sims (similarity.py:141): (B, Nq, Nk)
    fp32, unnormalized, times the temperature, at "highest"."""
    q, k = _volume_operands(query, key, "highest")
    return _sims("bqd,bkd->bqk", q, k, torch.float32) * temperature.to(torch.float32)


# ---------------------------------------------------------------------------
# Training aggregation (triad_tpu/ops/similarity.py:aggregate_crossbatch)
# ---------------------------------------------------------------------------


class AggregateOut(NamedTuple):
    """clip_sims (Bq, Bk) fp32 (rows queries, columns keys);
    nonneg_sq_sum () fp32, the sum of clamp(ts, clamp_min, 0)^2 over the
    whole (Bq, Bk, Nq, Nk) volume; volume_numel () fp32, its size;
    diag_token_sims (Bq, Nq, Nk) fp32, the token sims of the positive
    pairs (or None)."""

    clip_sims: torch.Tensor
    nonneg_sq_sum: torch.Tensor
    volume_numel: torch.Tensor
    diag_token_sims: Optional[torch.Tensor]


def _volume_pet(name: str) -> torch.dtype:
    """Storage dtype of the token-sim volume (config ``volume_dtype``):
    the products accumulate in fp32 either way; "bfloat16" rounds the
    stored volume."""
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"unknown volume_dtype {name!r}")
    return getattr(torch, name)


def _volume_operands(query, key, precision: str):
    """(q, k) for the token-sim products (similarity.py:62-81): bf16 pairs
    stay bf16 (their products are exact in the fp32 accumulator);
    otherwise "highest" computes in fp32 and "default" keeps the
    features' dtype. fp32 products run at torch's global matmul precision
    (TF32 off for parity)."""
    if precision == "highest" and query.dtype == key.dtype == torch.bfloat16:
        return query, key
    keep = query.dtype if precision != "highest" else torch.float32
    return query.to(keep), key.to(keep)


def _sims(eq: str, a, b, dtype: torch.dtype) -> torch.Tensor:
    """einsum with fp32 accumulation of exact products, stored in
    ``dtype`` (JAX's preferred_element_type)."""
    if dtype == torch.bfloat16 and a.dtype == b.dtype == torch.bfloat16:
        return torch.einsum(eq, a, b)
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32)).to(dtype)


def _masked_mean_over_queries(max_sims, query_mask):
    """Mean over the last (query-token) axis; with a (Bq, Nq) mask, the
    reference TV mean: masked sum / clamp(count, 1e-7)."""
    if query_mask is None:
        return max_sims.mean(dim=-1)
    mask = query_mask.to(torch.float32)[:, None, :]
    return (max_sims * mask).sum(dim=-1) / mask.sum(dim=-1).clamp(min=1e-7)


def _chunk_sizes(bk: int, chunk_size: int):
    chunk = min(chunk_size, bk)
    while bk % chunk:
        chunk -= 1
    return chunk, bk // chunk


def _chunk_fwd(q, k_chunk, temp, coeff, clamp_min, vdt):
    """One key chunk: (clip (Bq, chunk), sum of clamp^2)."""
    ts = _sims("iqd,jkd->ijqk", q, k_chunk, vdt).to(torch.float32) * temp
    clip = (ts.amax(dim=3) * coeff[:, None, :]).sum(dim=-1)
    clamped = ts.clamp(clamp_min, 0.0)
    return clip, (clamped * clamped).sum()


class MaxMeanChunked(torch.autograd.Function):
    """_maxmean_chunked_vjp: forward over key-batch chunks; the backward
    recomputes each chunk's token sims at the forward's volume dtype (so
    the max routing matches the forward's bit for bit), splits the max
    gradient evenly among ties (ts == max, as jnp.max's VJP does, never
    one argmax), adds the clamp window's 2 ts, and forms dq, dk and dT
    with no residual volume kept. q, k are the resolved volume operands;
    coeff (Bq, Nq) is the per-query mean weight (1/Nq or mask/count)."""

    @staticmethod
    def forward(ctx, q, k, temperature, coeff, clamp_min, chunk_size, vdt):
        chunk, nchunks = _chunk_sizes(k.shape[0], chunk_size)
        temp = temperature.to(torch.float32)
        clips, nonneg = [], torch.zeros((), dtype=torch.float32, device=q.device)
        for c in range(nchunks):
            clip, nn_sum = _chunk_fwd(q, k[c * chunk:(c + 1) * chunk], temp, coeff,
                                      clamp_min, vdt)
            clips.append(clip)
            nonneg = nonneg + nn_sum
        ctx.save_for_backward(q, k, temperature, coeff)
        ctx.conf = (clamp_min, chunk, nchunks, vdt)
        return torch.cat(clips, dim=1), nonneg

    @staticmethod
    def backward(ctx, g_clip, g_nn):
        q, k, temperature, coeff = ctx.saved_tensors
        clamp_min, chunk, nchunks, vdt = ctx.conf
        f32 = torch.float32
        temp = temperature.to(f32)
        g_clip, g_nn = g_clip.to(f32), g_nn.to(f32)
        dq = torch.zeros(q.shape, dtype=f32, device=q.device)
        dtemp = torch.zeros((), dtype=f32, device=q.device)
        dks = []
        for c in range(nchunks):
            k_c = k[c * chunk:(c + 1) * chunk]
            ts = _sims("iqd,jkd->ijqk", q, k_c, vdt).to(f32) * temp
            eq = (ts == ts.amax(dim=3, keepdim=True)).to(f32)
            g_max = g_clip[:, c * chunk:(c + 1) * chunk, None] * coeff[:, None, :]
            dts = eq * (g_max / eq.sum(dim=3))[..., None]
            active = (ts > clamp_min) & (ts < 0.0)
            dts = dts + g_nn * 2.0 * torch.where(active, ts, torch.zeros((), dtype=f32,
                                                                          device=ts.device))
            dtemp = dtemp + (dts * ts).sum() / temp
            dts_op = (dts * temp).to(q.dtype)
            dq = dq + _sims("ijqk,jkd->iqd", dts_op, k_c, f32)
            dks.append(_sims("ijqk,iqd->jkd", dts_op, q, f32))
        return (dq.to(q.dtype), torch.cat(dks).to(k.dtype), dtemp.to(temperature.dtype),
                None, None, None, None)


def aggregate_crossbatch(query, key, temperature, *, clamp_min: float, query_mask=None,
                         implementation: str = "dense", chunk_size: int = 8,
                         compute_diag: bool = True, precision: str = "highest",
                         volume_dtype: str = "float32") -> AggregateOut:
    """Cross-batch max-mean aggregation (similarity.py:433-497).

    query (Bq, Nq, D) audio or text tokens (rows of clip_sims); key
    (Bk, Nk, D) visual tokens (columns); temperature a scalar
    (multiplied); query_mask optional (Bq, Nq) for the TV masked mean.
    implementation "dense" materializes the volume (autograd through
    amax, which splits ties evenly); "chunked" walks key chunks under
    activation checkpointing; "chunked_unrolled" is "chunked" (the JAX
    package unrolls the chunks' scan, which changes only how XLA
    schedules them; eager torch has no scan to unroll, and the JAX values
    differ from "chunked" only by fp32 reassociation); "chunked_vjp" is
    MaxMeanChunked; "pallas"
    is ops/maxmean.py's MaxMeanKernel (the max-mean kernels on the card,
    first-argmax routing; Nk and D multiples of 128; volume_dtype float32
    only)."""
    vdt = _volume_pet(volume_dtype)
    bq, nq, _ = query.shape
    bk, nk = key.shape[0], key.shape[1]
    q, k = _volume_operands(query, key, precision)
    temp = temperature.to(torch.float32)
    if implementation == "dense":
        ts = _sims("iqd,jkd->ijqk", q, k, vdt).to(torch.float32) * temp
        clip = _masked_mean_over_queries(ts.amax(dim=3), query_mask)
        clamped = ts.clamp(clamp_min, 0.0)
        nonneg = (clamped * clamped).sum()
    elif implementation in ("chunked", "chunked_unrolled", "chunked_vjp"):
        coeff = coefficients(bq, nq, query_mask, q.device)
        if implementation == "chunked_vjp":
            clip, nonneg = MaxMeanChunked.apply(q, k, temperature, coeff, clamp_min,
                                                chunk_size, vdt)
        else:
            from torch.utils.checkpoint import checkpoint

            chunk, nchunks = _chunk_sizes(bk, chunk_size)
            parts = [checkpoint(_chunk_fwd, q, k[c * chunk:(c + 1) * chunk], temp, coeff,
                                clamp_min, vdt, use_reentrant=False)
                     for c in range(nchunks)]
            clip = torch.cat([p[0] for p in parts], dim=1)
            nonneg = sum(p[1] for p in parts)
    elif implementation == "pallas":
        # pallas_maxmean.aggregate_pallas: the max-mean kernels on the
        # features as they come (no precision resolution), the diagonal at
        # "highest" as diag_token_sims computes it.
        if volume_dtype != "float32":
            raise ValueError("volume_dtype is only supported by the XLA implementations "
                             "(the pallas kernel is retired)")
        clip, nonneg = maxmean_aggregate(query, key, temperature, clamp_min, query_mask)
        q, k = _volume_operands(query, key, "highest")
        compute_diag = compute_diag and bq == bk
    else:
        raise ValueError(f"Unknown implementation {implementation!r}")
    numel = torch.tensor(float(bq * bk * nq * nk), dtype=torch.float32, device=q.device)
    diag = _sims("bqd,bkd->bqk", q, k, torch.float32) * temp if compute_diag else None
    return AggregateOut(clip, nonneg, numel, diag)
