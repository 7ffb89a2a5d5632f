"""The plain reference of the two contrastive losses over projected token
features: cross-batch max-mean clip similarities of unnormalised token
sims times the temperature, symmetric InfoNCE, the non-negativity,
temperature-calibration, temporal-smoothness (AV) and patch-sparsity (TV)
regularisers, as the configuration's loss section weights them. The AV
volume is formed in blocks of key rows so that it fits."""

from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def _infonce(clip):
    rows = torch.diagonal(F.log_softmax(clip, dim=1))
    cols = torch.diagonal(F.log_softmax(clip.t(), dim=1))
    return (-rows - cols).mean() / 2.0


def _aggregate(P, query, key, temp, clamp_min, stored, query_mask=None, block=8):
    """(clip sims (Bq, Bk), mean of clamp(ts, clamp_min, 0)^2, diagonal token
    sims (B, Nq, Nk)); ``stored`` is the configuration's volume dtype (the
    reference keeps fp32; the control rounds a bf16 volume lower)."""
    bq, nq, _ = query.shape
    bk, nk, _ = key.shape
    if query_mask is None:
        coeff = torch.full((bq, nq), 1.0 / nq, dtype=F32, device=query.device)
    else:
        m = query_mask.to(F32)
        coeff = m / m.sum(dim=1, keepdim=True).clamp(min=1e-7)
    clips, nonneg = [], 0.0
    for j in range(0, bk, block):
        ts = P.volume(P.einsum("iqd,jkd->ijqk", query, key[j:j + block]), stored) * temp
        clips.append((ts.amax(dim=3) * coeff[:, None, :]).sum(dim=-1))
        nonneg = nonneg + ts.clamp(clamp_min, 0.0).square().sum()
    diag = P.einsum("bqd,bkd->bqk", query, key) * temp
    return torch.cat(clips, dim=1), nonneg / float(bq * bk * nq * nk), diag


def av_loss(P, audio, visual, temp, loss_cfg: dict):
    clip, nonneg, diag = _aggregate(P, audio, visual, temp, loss_cfg["av_nonneg_clamp_min"],
                                    loss_cfg["volume_dtype"])
    calib = torch.clamp(torch.log(torch.tensor(loss_cfg["temp_cal_low"], device=temp.device))
                        - torch.log(temp), min=0.0) ** 2
    d = diag[:, 1:, :] - diag[:, :-1, :]
    smooth = (d * d).mean()
    return (_infonce(clip) + loss_cfg["temp_cal_weight"] * calib
            + loss_cfg["av_nonneg_weight"] * nonneg + loss_cfg["smooth_weight"] * smooth)


def tv_loss(P, text, visual, mask, temp, loss_cfg: dict):
    clip, nonneg, diag = _aggregate(P, text, visual, temp, loss_cfg["tv_nonneg_clamp_min"],
                                    loss_cfg["volume_dtype"], mask)
    probs = torch.softmax(diag, dim=-1)
    excess = F.relu(probs.sum(dim=1) / diag.shape[1] - loss_cfg["patch_sparsity_threshold"])
    return (_infonce(clip) + loss_cfg["tv_nonneg_weight"] * nonneg
            + loss_cfg["patch_sparsity_weight"] * (excess * excess).mean())
