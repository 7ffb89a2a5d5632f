"""A live TriadModel behind the serving methods of the JAX package's
``ServingBundle`` (``serve/base.py``), which ``serve/server.py`` serves.
Arrays go in and out as numpy; the model runs under
``torch.inference_mode()`` on ``device``, the card unless the caller
asks for the CPU. Without a ``state_dict`` the weights are random, drawn
from seed 0."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from triad_tpu_torch.config import ModelConfig
from triad_tpu_torch.models.convert import init_triad_model
from triad_tpu_torch.models.multimodal import TriadModel
from triad_tpu_torch.ops.similarity import pair_scores
from triad_tpu_torch.serve.base import ServingBase


class ServingModel(ServingBase):
    def __init__(
        self,
        cfg: ModelConfig,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        device="cuda",
        audio_num_samples: int = 160_000,
        max_text_tokens: int = 128,
        tokenizer=None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingModel: no CUDA device (pass device='cpu' to serve "
                               "from the CPU)")
        if state_dict is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            self.model = init_triad_model(cfg, gen, device=self.device)
        else:
            self.model = TriadModel(cfg, device=self.device)
            self.model.load_state_dict(state_dict)
        self.model.eval()
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.meta = {
            "format": "triad_tpu_torch.serve/1",
            "device": str(self.device),
            "device_name": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
            "temperature": float(self.model.temperature.detach()),
            "embedding_dim": cfg.embedding_dim,
            "audio_num_samples": audio_num_samples,
            "image_size": cfg.vit.image_size,
            "max_text_tokens": max_text_tokens,
            "model_config": dataclasses.asdict(cfg),
        }

    def _embed_audio(self, audio):
        return self.model.encode_audio(audio)

    def _embed_visual(self, images):
        return self.model.encode_visual(images)

    def _embed_text(self, ids, mask):
        return self.model.encode_text(ids.long(), mask)

    def _pair_scores(self, q_tokens, q_mask, k_tokens, k_mask, inv_temp):
        return pair_scores(q_tokens, q_mask, k_tokens, k_mask, inv_temp)
