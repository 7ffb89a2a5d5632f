"""Ahead-of-time export of the serving surface (the port of
``triad_tpu/serve/export.py``, on ``torch.export``).

The bundle holds the traced programs, so serving needs no model code, no
config dataclasses and no checkpoint restore:

  bundle/
    meta.json                    shapes, temperature, model config, platforms
    vocab.txt                    WordPiece vocab (text endpoint tokenization)
    embed_audio.<platform>.pt2   (b, T) waveform         -> (b, Na, D) tokens
    embed_visual.<platform>.pt2  (b, H, W, 3) frames     -> (b, Nv, D) tokens
    embed_text.<platform>.pt2    (b, Nt) int32 ids + mask -> (b, Nt, D) tokens
    pair_scores.<platform>.pt2   (q, Nq, D) x (k, Nk, D) tokens -> (q, k) scores

Each endpoint is one ``torch.export`` program for each platform ("cpu",
"cuda"), saved with ``torch.export.save``. The embeddings take a symbolic
batch (``torch.export.Dim``, traced at 2 so that neither 0 nor 1 is
specialised), ``pair_scores`` four free dims (q, k, Nq, Nk). The weights
are parameters of the programs; the model is traced in eval mode, so
dropout is dead. The impl knobs are forced to the plain routes first
(``parallel/tp.py:resolve_xla_impls``): a bundle launches no hand-written
kernel, as the JAX bundle runs no Pallas kernel, and an explicit kernel
knob raises. Each platform's program is traced on its own device (the
int8 product takes ``torch._int_mm`` on the card and the plain sums on
the CPU); exporting for "cuda" without a card raises.

A bundle is read by the torch version that wrote it (``meta.json``'s
``torch_version``); ``torch.export``'s file format is not promised across
versions.

``pair_scores`` is the retrieval aggregator: token sims / temperature, max
over unmasked key tokens (masked ones at ``finfo(float32).min``), masked
mean over query tokens. Normalization stays the caller's job, as in
``eval/retrieval.py``: the server L2-normalizes AV features and passes TV
features raw.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from triad_tpu_torch.serve.base import ServingBase

FORMAT = "triad_tpu_torch.serve/1"
PLATFORMS = ("cpu", "cuda")
ENDPOINTS = ("embed_audio", "embed_visual", "embed_text", "pair_scores")


class _PairScores(torch.nn.Module):
    """(q, Nq, D), (q, Nq), (k, Nk, D), (k, Nk), () -> (q, k): JAX's
    ``_pair_scores_fn``, ported as ``ops/similarity.py:pair_scores``."""

    def forward(self, q_tokens, q_mask, k_tokens, k_mask, inv_temp):
        from triad_tpu_torch.ops.similarity import pair_scores

        return pair_scores(q_tokens, q_mask, k_tokens, k_mask, inv_temp)


# The submodules each TriadModel encode method reads.
_PARTS = {
    "encode_audio": ("audio_backbone", "audio_projection"),
    "encode_visual": ("visual_backbone", "visual_projection"),
    "encode_text": ("text_backbone", "text_projection"),
}


class _Encode(torch.nn.Module):
    """One encode method of a TriadModel at eval, in the int8 serving mode
    if asked (``models/quantize.py``). It holds only the submodules the
    method reads, so each program carries only its own encoder's weights;
    the method runs with this module as its ``self``."""

    def __init__(self, model, method: str, int8: bool):
        super().__init__()
        for name in _PARTS[method]:
            setattr(self, name, getattr(model, name))
        self.cfg, self.method, self.int8 = model.cfg, method, int8

    def forward(self, *args):
        from triad_tpu_torch.models.multimodal import TriadModel
        from triad_tpu_torch.models.quantize import int8_interception

        with int8_interception() if self.int8 else contextlib.nullcontext():
            return getattr(TriadModel, self.method)(self, *args)


def export_bundle(
    params_or_model: Any,
    model_cfg,
    out_dir: str,
    *,
    audio_num_samples: int,
    max_text_tokens: int,
    vocab: Optional[Dict[str, int]] = None,
    int8: bool = False,
    platforms=PLATFORMS,
) -> Path:
    """Write the serving surface of ``params_or_model`` (a TriadModel or
    its state_dict) to ``out_dir``: one program per endpoint and
    platform, the vocab and ``meta.json``. Prints each platform's
    seconds."""
    from torch.export import Dim, export

    from triad_tpu_torch.models.multimodal import TriadModel
    from triad_tpu_torch.parallel.tp import resolve_xla_impls

    model_cfg = resolve_xla_impls(model_cfg)
    platforms = tuple(platforms)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"platforms must be a non-empty subset of {PLATFORMS}, got {platforms}")
    if "cuda" in platforms and not torch.cuda.is_available():
        raise RuntimeError("export_bundle: platform 'cuda' asked for, but there is no CUDA device")
    state = (params_or_model.state_dict() if isinstance(params_or_model, torch.nn.Module)
             else params_or_model)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    h, nt, d = model_cfg.vit.image_size, max_text_tokens, model_cfg.embedding_dim
    f32 = torch.float32
    b = Dim("b", min=1)
    q, k, nq, nk = Dim("q", min=1), Dim("k", min=1), Dim("nq", min=1), Dim("nk", min=1)
    for platform in platforms:
        t0 = time.perf_counter()
        dev = torch.device(platform)
        model = TriadModel(model_cfg, device=dev)
        model.load_state_dict(state)
        model.eval().requires_grad_(False)
        programs = {
            "embed_audio": (_Encode(model, "encode_audio", int8),
                            (torch.zeros(2, audio_num_samples, dtype=f32, device=dev),),
                            {"args": ({0: b},)}),
            "embed_visual": (_Encode(model, "encode_visual", int8),
                             (torch.zeros(2, h, h, 3, dtype=f32, device=dev),),
                             {"args": ({0: b},)}),
            "embed_text": (_Encode(model, "encode_text", int8),
                           (torch.ones(2, nt, dtype=torch.int32, device=dev),
                            torch.ones(2, nt, dtype=f32, device=dev)),
                           {"args": ({0: b}, {0: b})}),
            # distinct sizes, none 0 or 1, so no two dims are taken as equal
            "pair_scores": (_PairScores(),
                            (torch.zeros(2, 4, d, dtype=f32, device=dev),
                             torch.ones(2, 4, dtype=f32, device=dev),
                             torch.zeros(3, 5, d, dtype=f32, device=dev),
                             torch.ones(3, 5, dtype=f32, device=dev),
                             torch.tensor(1.0, dtype=f32, device=dev)),
                            ({0: q, 1: nq}, {0: q, 1: nq}, {0: k, 1: nk}, {0: k, 1: nk}, None)),
        }
        for name, (module, args, dims) in programs.items():
            program = export(module, args, dynamic_shapes=dims, strict=False)
            torch.export.save(program, str(out / f"{name}.{platform}.pt2"))
        del model, programs
        print(f"exported the {platform} programs ({', '.join(ENDPOINTS)}) in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)

    if vocab:
        ordered = sorted(vocab.items(), key=lambda kv: kv[1])
        (out / "vocab.txt").write_text("\n".join(t for t, _ in ordered) + "\n", encoding="utf-8")
    meta = {
        "format": FORMAT,
        "platforms": list(platforms),
        "int8": int8,
        "temperature": float(state["temperature"]),
        "embedding_dim": d,
        "audio_num_samples": audio_num_samples,
        "image_size": h,
        "max_text_tokens": nt,
        "model_config": dataclasses.asdict(model_cfg),
        "torch_version": torch.__version__,
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=2))
    return out


class ServingBundle(ServingBase):
    """A loaded export bundle: the serving methods of ``serve/base.py``
    (embed_audio, embed_visual, embed_text_ids, embed_texts, pair_scores,
    meta) on the bundle's programs for ``device``, the card unless the
    caller asks for the CPU. Loading imports no model code. Arrays go in
    and out as numpy; tokens come out as fp32."""

    no_tokenizer = "bundle has no vocab.txt — pass token ids"

    def __init__(self, path: str, device="cuda"):
        self.path = Path(path)
        self.meta = json.loads((self.path / "meta.json").read_text())
        self.device = torch.device(device)
        platform = self.device.type
        if platform not in self.meta["platforms"]:
            raise ValueError(f"bundle {self.path} holds the platforms {self.meta['platforms']}, "
                             f"not {platform!r}")
        if platform == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingBundle: no CUDA device (pass device='cpu' to serve the "
                               "bundle's CPU programs)")
        self._fns = {name: torch.export.load(str(self.path / f"{name}.{platform}.pt2")).module()
                     for name in ENDPOINTS}
        self.tokenizer = None
        vocab_file = self.path / "vocab.txt"
        if vocab_file.exists():
            from triad_tpu_torch.data.tokenizer import WordPieceTokenizer

            self.tokenizer = WordPieceTokenizer.from_vocab_file(str(vocab_file))

    def _embed_audio(self, audio):
        return self._fns["embed_audio"](audio)

    def _embed_visual(self, images):
        return self._fns["embed_visual"](images)

    def _embed_text(self, ids, mask):
        return self._fns["embed_text"](ids, mask)

    def _pair_scores(self, q_tokens, q_mask, k_tokens, k_mask, inv_temp):
        return self._fns["pair_scores"](
            q_tokens, q_mask, k_tokens, k_mask,
            torch.tensor(inv_temp, dtype=torch.float32, device=self.device))
