"""Inference-path similarities (mirrors the serving parts of
``triad_tpu/ops/similarity.py`` and ``triad_tpu/serve/export.py``)."""

from __future__ import annotations

import torch


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
