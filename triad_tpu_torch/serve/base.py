"""The serving contract that ``serve/server.py`` serves, without a model:
the numpy-in / numpy-out methods of the JAX package's ``ServingBundle``
(embed_audio, embed_visual, embed_text_ids, embed_texts, pair_scores,
meta). ``ServingModel`` (a live TriadModel) and ``ServingBundle`` (an
export bundle's programs) fill in the tensor calls; this module imports
no model code, so a bundle serves without it."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


class ServingBase:
    """A subclass sets ``device``, ``meta`` (audio_num_samples,
    image_size, max_text_tokens, temperature) and ``tokenizer`` (or
    None), and supplies ``_embed_audio``, ``_embed_visual``,
    ``_embed_text`` (int32 ids) and ``_pair_scores`` on tensors of
    ``device``. Tokens come out as fp32."""

    device: torch.device
    meta: dict
    tokenizer = None
    no_tokenizer = "no tokenizer configured — pass token ids"

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
        return self._out(self._embed_audio(self._in(audio, np.float32)))

    @torch.inference_mode()
    def embed_visual(self, images: np.ndarray) -> np.ndarray:
        """(b, H, W, 3) frames -> (b, Nv, D)."""
        h = self.meta["image_size"]
        self._check_shape("images", np.shape(images), (h, h, 3))
        return self._out(self._embed_visual(self._in(images, np.float32)))

    @torch.inference_mode()
    def embed_text_ids(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """(b, Nt) int32 ids + mask -> (b, Nt, D)."""
        return self._out(self._embed_text(self._in(ids, np.int32), self._in(mask, np.float32)))

    def embed_texts(self, texts) -> Dict[str, np.ndarray]:
        if self.tokenizer is None:
            raise ValueError(self.no_tokenizer)
        n = self.meta["max_text_tokens"]
        ids, mask = self.tokenizer.encode_batch(list(texts), max_length=n, pad_to=n)
        return {"tokens": self.embed_text_ids(ids, mask), "mask": np.asarray(mask, np.float32)}

    @torch.inference_mode()
    def pair_scores(self, q_tokens, q_mask, k_tokens, k_mask,
                    temperature: Optional[float] = None) -> np.ndarray:
        temp = self.meta["temperature"] if temperature is None else temperature
        f32 = np.float32
        return self._out(self._pair_scores(self._in(q_tokens, f32), self._in(q_mask, f32),
                                           self._in(k_tokens, f32), self._in(k_mask, f32),
                                           1.0 / temp))
