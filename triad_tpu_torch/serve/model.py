"""A live TriadModel behind the serving methods of
``triad_tpu.serve.export.ServingBundle`` (embed_audio, embed_visual,
embed_text_ids, embed_texts, pair_scores, meta), so the JAX package's
HTTP handler serves it unchanged. Arrays go in and out as numpy; the
model runs under ``torch.inference_mode()`` on ``device``. Without a
``state_dict`` the weights are random, drawn from seed 0."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from triad_tpu_torch.config import ModelConfig
from triad_tpu_torch.models.convert import init_triad_model
from triad_tpu_torch.models.multimodal import TriadModel
from triad_tpu_torch.ops.similarity import pair_scores


class ServingModel:
    def __init__(
        self,
        cfg: ModelConfig,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        device="cpu",
        audio_num_samples: int = 160_000,
        max_text_tokens: int = 128,
        tokenizer=None,
    ):
        self.device = torch.device(device)
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

    def _in(self, a, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(self.device)

    @staticmethod
    def _out(t: torch.Tensor) -> np.ndarray:
        return t.to(torch.float32).cpu().numpy()

    @staticmethod
    def _check_shape(what, got, want):
        if tuple(got[1:]) != want:
            raise ValueError(f"{what}: want (b, {', '.join(map(str, want))}), got {got}")

    @torch.inference_mode()
    def embed_audio(self, audio: np.ndarray) -> np.ndarray:
        """(b, audio_num_samples) waveform -> (b, Na, D)."""
        self._check_shape("audio", np.shape(audio), (self.meta["audio_num_samples"],))
        return self._out(self.model.encode_audio(self._in(audio, np.float32)))

    @torch.inference_mode()
    def embed_visual(self, images: np.ndarray) -> np.ndarray:
        """(b, H, W, 3) frames -> (b, Nv, D)."""
        h = self.meta["image_size"]
        self._check_shape("images", np.shape(images), (h, h, 3))
        return self._out(self.model.encode_visual(self._in(images, np.float32)))

    @torch.inference_mode()
    def embed_text_ids(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """(b, Nt) ids + mask -> (b, Nt, D)."""
        return self._out(self.model.encode_text(self._in(ids, np.int64),
                                                self._in(mask, np.float32)))

    def embed_texts(self, texts) -> Dict[str, np.ndarray]:
        if self.tokenizer is None:
            raise ValueError("no tokenizer configured — pass token ids")
        n = self.meta["max_text_tokens"]
        ids, mask = self.tokenizer.encode_batch(list(texts), max_length=n, pad_to=n)
        return {"tokens": self.embed_text_ids(ids, mask),
                "mask": np.asarray(mask, np.float32)}

    @torch.inference_mode()
    def pair_scores(self, q_tokens, q_mask, k_tokens, k_mask,
                    temperature: Optional[float] = None) -> np.ndarray:
        temp = self.meta["temperature"] if temperature is None else temperature
        f32 = np.float32
        return self._out(pair_scores(
            self._in(q_tokens, f32), self._in(q_mask, f32),
            self._in(k_tokens, f32), self._in(k_mask, f32), 1.0 / temp,
        ))
