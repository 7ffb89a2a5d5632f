"""Contrastive losses, regularizers and similarity statistics (mirrors
``triad_tpu/ops/losses.py``): fp32 functions over projected token
features.

Reference quirks kept on purpose, as in the JAX package: training token
sims are unnormalized and multiplied by the temperature; only the "too
low" branch of the temperature calibration is live; the TV
non-negativity and sparsity terms include padded text tokens.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from triad_tpu_torch.config import LossConfig
from triad_tpu_torch.ops.similarity import AggregateOut, aggregate_crossbatch


class AVLossOut(NamedTuple):
    total: torch.Tensor
    contrastive: torch.Tensor
    reg: torch.Tensor
    smooth: torch.Tensor
    stats: Dict[str, torch.Tensor]


class TVLossOut(NamedTuple):
    total: torch.Tensor
    contrastive: torch.Tensor
    reg: torch.Tensor
    stats: Dict[str, torch.Tensor]


def _std_unbiased(x: torch.Tensor) -> torch.Tensor:
    """torch.Tensor.std() semantics (Bessel-corrected), count clamped at 1."""
    n = x.numel()
    return torch.sqrt(((x - x.mean()) ** 2).sum() / max(n - 1, 1))


def symmetric_infonce(clip_sims: torch.Tensor) -> torch.Tensor:
    """Symmetric cross-entropy over the (B, B) clip sims with diagonal labels."""
    rows = torch.diagonal(F.log_softmax(clip_sims, dim=1))
    cols = torch.diagonal(F.log_softmax(clip_sims.t(), dim=1))
    return (-rows - cols).mean() / 2.0


def similarity_stats(clip_sims: torch.Tensor, prefix: str) -> Dict[str, torch.Tensor]:
    """pos/neg mean and std, separation, hardest negative."""
    b = clip_sims.shape[0]
    pos = torch.diagonal(clip_sims)
    offdiag = 1.0 - torch.eye(b, dtype=clip_sims.dtype, device=clip_sims.device)
    n_neg = b * b - b
    neg_mean = (clip_sims * offdiag).sum() / n_neg
    neg_std = torch.sqrt((((clip_sims - neg_mean) ** 2) * offdiag).sum() / max(n_neg - 1, 1))
    hardest = torch.where(offdiag > 0, clip_sims, torch.full_like(clip_sims, -torch.inf)).max()
    pos_mean = pos.mean()
    return {
        f"{prefix}_pos_sim_mean": pos_mean,
        f"{prefix}_pos_sim_std": _std_unbiased(pos),
        f"{prefix}_neg_sim_mean": neg_mean,
        f"{prefix}_neg_sim_std": neg_std,
        f"{prefix}_separation": pos_mean - neg_mean,
        f"{prefix}_hardest_negative": hardest,
    }


def temperature_calibration(temperature: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    """max(0, log(low) - log(T))^2, the only live branch."""
    t = temperature.to(torch.float32)
    low = torch.log(torch.tensor(cfg.temp_cal_low, dtype=torch.float32, device=t.device))
    return torch.clamp(low - torch.log(t), min=0.0) ** 2


def temporal_smoothness(diag_token_sims: torch.Tensor) -> torch.Tensor:
    """Mean squared first difference along audio time, (B, Na, Nv)."""
    diffs = diag_token_sims[:, 1:, :] - diag_token_sims[:, :-1, :]
    return (diffs * diffs).mean()


def patch_sparsity(diag_token_sims: torch.Tensor, threshold: float) -> torch.Tensor:
    """Softmax over patches per text token, mass per patch summed over
    tokens / Nt (padded tokens included), squared excess over the
    threshold, meaned."""
    probs = torch.softmax(diag_token_sims, dim=-1)
    fraction = probs.sum(dim=1) / diag_token_sims.shape[1]
    excess = F.relu(fraction - threshold)
    return (excess * excess).mean()


def _aggregate(query, key, temperature, cfg: LossConfig, clamp_min, query_mask=None):
    return aggregate_crossbatch(
        query, key, temperature, clamp_min=clamp_min, query_mask=query_mask,
        implementation=cfg.implementation, chunk_size=cfg.chunk_size,
        precision=cfg.matmul_precision, volume_dtype=cfg.volume_dtype,
    )


def av_loss_from_aggregate(agg: AggregateOut, temperature, cfg: LossConfig) -> AVLossOut:
    contrastive = symmetric_infonce(agg.clip_sims)
    l_nonneg = agg.nonneg_sq_sum / agg.volume_numel
    l_smooth = temporal_smoothness(agg.diag_token_sims)
    reg = (cfg.temp_cal_weight * temperature_calibration(temperature, cfg)
           + cfg.av_nonneg_weight * l_nonneg + cfg.smooth_weight * l_smooth)
    return AVLossOut(contrastive + reg, contrastive, reg, cfg.smooth_weight * l_smooth,
                     similarity_stats(agg.clip_sims, "av"))


def av_loss(audio_feats, visual_feats, temperature, cfg: LossConfig) -> AVLossOut:
    """AV loss from projected tokens: audio (B, Na, D), visual (B, Nv, D)."""
    agg = _aggregate(audio_feats, visual_feats, temperature, cfg, cfg.av_nonneg_clamp_min)
    return av_loss_from_aggregate(agg, temperature, cfg)


def tv_loss_from_aggregate(agg: AggregateOut, cfg: LossConfig) -> TVLossOut:
    contrastive = symmetric_infonce(agg.clip_sims)
    l_nonneg = agg.nonneg_sq_sum / agg.volume_numel
    l_sparsity = patch_sparsity(agg.diag_token_sims, cfg.patch_sparsity_threshold)
    reg = cfg.tv_nonneg_weight * l_nonneg + cfg.patch_sparsity_weight * l_sparsity
    return TVLossOut(contrastive + reg, contrastive, reg, similarity_stats(agg.clip_sims, "tv"))


def tv_loss(text_feats, visual_feats, text_mask, temperature, cfg: LossConfig) -> TVLossOut:
    """TV loss from projected tokens: text (B, Nt, D), visual (B, Nv, D),
    text_mask (B, Nt) 1 = valid (masks the clip-level mean only)."""
    agg = _aggregate(text_feats, visual_feats, temperature, cfg, cfg.tv_nonneg_clamp_min,
                     text_mask)
    return tv_loss_from_aggregate(agg, cfg)
