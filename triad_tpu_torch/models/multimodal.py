"""The combined tri-modal model (mirrors ``triad_tpu/models/multimodal.py``):
ViT / HuBERT / DistilBERT backbones, each followed by a projection head
into the shared ``embedding_dim`` token space, and a learnable scalar
temperature. Backbones and heads run in ``cfg.compute_dtype``; parameters
stay in ``cfg.param_dtype``. The ViT base is frozen (only its LoRA
factors take gradients).

Training mode (``train=True``) takes a ``torch.Generator`` for its random
draws: patch dropout on the visual tokens, DistilBERT's dropouts and
HuBERT's plain dropouts and SpecAugment; HuBERT also takes an
``ops.dropout.HostSeeds`` for its kernel seeds and layerdrop."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from triad_tpu_torch.config import ModelConfig
from triad_tpu_torch.models.distilbert import DistilBertModel
from triad_tpu_torch.models.hubert import HubertModel, normalize_waveform
from triad_tpu_torch.models.layers import ProjectionHead, patch_dropout_mask
from triad_tpu_torch.models.vit import DinoViT
from triad_tpu_torch.ops.dropout import HostSeeds
from triad_tpu_torch.ops.similarity import pairwise_similarity


def _needs(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("training mode draws dropout bits: pass a torch.Generator")
    return generator


class TriadModel(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        c = cfg
        kw = dict(dtype=getattr(torch, c.compute_dtype), param_dtype=getattr(torch, c.param_dtype),
                  device=device)
        self.visual_backbone = DinoViT(c.vit, use_lora=True, **kw)
        self.visual_projection = ProjectionHead(c.vit.hidden_size, c.embedding_dim, **kw)
        self.audio_backbone = HubertModel(c.hubert, **kw)
        self.audio_projection = ProjectionHead(c.hubert.hidden_size, c.embedding_dim, **kw)
        self.text_backbone = DistilBertModel(c.text, **kw)
        self.text_projection = ProjectionHead(c.text.hidden_size, c.embedding_dim, **kw)
        self.temperature = nn.Parameter(
            torch.tensor(c.temperature_init, dtype=torch.float32, device=device))
        self.visual_backbone.freeze_non_lora()
        self.cfg = cfg

    def encode_visual(self, images: torch.Tensor, train: bool = False,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images (B, H, W, 3) -> (B, Nv, D) projected patch tokens. In
        training, patch dropout after the projection zeroes each token
        with probability ``visual_dropout_prob`` (multimodal.py:101-116)."""
        feats = self.visual_projection(self.visual_backbone.get_patch_tokens(images))
        rate = self.cfg.visual_dropout_prob
        if train and rate > 0:
            keep = patch_dropout_mask(_needs(generator), feats.shape[:2], rate, feats.device)
            feats = feats * keep[..., None].to(feats.dtype)
        return feats

    def encode_audio(self, audio: torch.Tensor, train: bool = False,
                     generator: Optional[torch.Generator] = None,
                     seeds: Optional[HostSeeds] = None) -> torch.Tensor:
        """audio (B, T) raw 16 kHz waveform -> (B, Na, D); training runs
        HuBERT's dropouts, SpecAugment and layerdrop from ``generator`` and
        ``seeds``."""
        if self.cfg.hubert.normalize_waveform:
            audio = normalize_waveform(audio)
        gen = _needs(generator) if train else None
        return self.audio_projection(self.audio_backbone(audio, gen, seeds if train else None))

    def encode_text(self, token_ids, attention_mask, train: bool = False,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """token_ids, attention_mask (B, Nt) -> (B, Nt, D); training runs
        DistilBERT's dropouts from ``generator``."""
        gen = _needs(generator) if train else None
        return self.text_projection(self.text_backbone(token_ids, attention_mask, gen))

    def forward(self, images, audio, token_ids, attention_mask) -> Dict[str, torch.Tensor]:
        return {
            "visual": self.encode_visual(images),
            "audio": self.encode_audio(audio),
            "text": self.encode_text(token_ids, attention_mask),
        }

    def inference_forward(
        self,
        images: Optional[torch.Tensor] = None,
        audio: Optional[torch.Tensor] = None,
        token_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Any subset of modalities -> features + normalized pairwise sims."""
        if images is None and audio is None and token_ids is None:
            raise ValueError("At least one modality must be provided")
        out: Dict[str, torch.Tensor] = {}
        if images is not None:
            out["visual_feats"] = self.encode_visual(images)
        if audio is not None:
            out["audio_feats"] = self.encode_audio(audio)
        if token_ids is not None:
            out["text_feats"] = self.encode_text(token_ids, attention_mask)
        t = self.temperature
        pairs = (
            ("vis_text_sim_matrix", "text_feats", "visual_feats"),
            ("vis_audio_sim_matrix", "audio_feats", "visual_feats"),
            ("text_audio_sim_matrix", "text_feats", "audio_feats"),
        )
        for name, a, b in pairs:
            if a in out and b in out:
                out[name] = pairwise_similarity(out[a], out[b], t)
        return out
