"""The combined tri-modal model, eval only (mirrors
``triad_tpu/models/multimodal.py``): ViT / HuBERT / DistilBERT backbones,
each followed by a projection head into the shared ``embedding_dim``
token space, and a learnable scalar temperature. Backbones and heads run
in ``cfg.compute_dtype``; parameters stay in ``cfg.param_dtype``."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from triad_tpu.core.config import ModelConfig
from triad_tpu_torch.models.distilbert import DistilBertModel
from triad_tpu_torch.models.hubert import HubertModel, normalize_waveform
from triad_tpu_torch.models.layers import ProjectionHead
from triad_tpu_torch.models.vit import DinoViT
from triad_tpu_torch.ops.similarity import pairwise_similarity


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
        self.cfg = cfg

    def encode_visual(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) -> (B, Nv, D) projected patch tokens."""
        return self.visual_projection(self.visual_backbone.get_patch_tokens(images))

    def encode_audio(self, audio: torch.Tensor) -> torch.Tensor:
        """audio (B, T) raw 16 kHz waveform -> (B, Na, D)."""
        if self.cfg.hubert.normalize_waveform:
            audio = normalize_waveform(audio)
        return self.audio_projection(self.audio_backbone(audio))

    def encode_text(self, token_ids, attention_mask) -> torch.Tensor:
        """token_ids, attention_mask (B, Nt) -> (B, Nt, D)."""
        return self.text_projection(self.text_backbone(token_ids, attention_mask))

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
