"""Pretrained backbones from on-disk HF snapshots and torch.hub files (the
port of ``triad_tpu/models/hf_import.py``), read with torch, numpy and
json alone: no ``transformers`` and no ``safetensors``.

The reference fetches its backbones at startup: HF ``hubert-base-ls960``
(reference model.py:29-30), HF DistilBERT (model.py:79-80), and torch.hub
``dinov2_vitb14_reg`` (model.py:218). Those fetches leave on disk:

- an **HF snapshot directory** per hub backbone: ``config.json`` plus
  ``model.safetensors`` (or shards under ``model.safetensors.index.json``)
  or ``pytorch_model.bin``;
- a **torch.hub ``.pth`` state dict** for DINOv2 (DinoVisionTransformer
  names, fused qkv).

``read_snapshot`` resolves the weight files in ``from_pretrained``'s
order, and names the tensors as ``AutoModel`` loads them: HF's renames of
legacy keys (LayerNorm ``gamma`` / ``beta``; weight-norm ``weight_g`` /
``weight_v``), then its base-model prefix rule (a file whose keys start
with the prefix is a task model's: only the prefixed keys are kept, the
prefix stripped; head keys such as ``vocab_projector.*`` or
``lm_head.*`` fall away). ``models/weights.py`` then ports them; a tensor
the architecture needs that the files lack raises, naming it.

``init_model_from_pretrained`` is the Trainer's entry: the port's model
with each named backbone loaded over its seeded draw. DINOv2's
``pos_embed`` is never interpolated, as in the JAX package: a hub file made at 518 px
(1370 positions) fails the shape check at ``image_size`` 224 (257).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from triad_tpu_torch.config import ModelConfig

# model_type -> (the AutoModel class, its base_model_prefix)
MODEL_TYPES = {
    "hubert": ("HubertModel", "hubert"),
    "distilbert": ("DistilBertModel", "distilbert"),
    "dinov2_with_registers": ("Dinov2WithRegistersModel", "dinov2_with_registers"),
}

_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
                       "I64": torch.int64}


def _upcast(t: torch.Tensor) -> torch.Tensor:
    """Floats to fp32, as ``from_pretrained`` into an fp32 model."""
    return t.float() if t.is_floating_point() else t


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file: an 8-byte little-endian header length, the
    JSON header (name -> dtype, shape, data_offsets into the buffer that
    follows; ``__metadata__`` skipped), then the buffer. F32, F16, BF16
    and I64; floats come back as fp32."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which the "
                             f"reader does not take ({sorted(_SAFETENSORS_DTYPES)})")
        start, end = info["data_offsets"]
        size = torch.empty((), dtype=dtype).element_size()
        if (end - start) != size * int(np.prod(info["shape"], dtype=np.int64)):
            raise ValueError(f"{path}: tensor {name!r} spans {end - start} bytes, not its "
                             f"shape {info['shape']} x {size}")
        t = (torch.frombuffer(buf, dtype=dtype, count=(end - start) // size, offset=start)
             if end > start else torch.empty(0, dtype=dtype))
        out[name] = _upcast(t.reshape(info["shape"]))
    return out


def _read_bin(path: str) -> Dict[str, torch.Tensor]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _upcast(v) for k, v in state.items()}


def _read_weights(path: str) -> Dict[str, torch.Tensor]:
    """The snapshot's tensors, from the first of ``from_pretrained``'s
    files that exists: model.safetensors, its sharded index,
    pytorch_model.bin."""
    for name, reader in (("model.safetensors", read_safetensors),
                         ("model.safetensors.index.json", read_safetensors),
                         ("pytorch_model.bin", _read_bin)):
        file = os.path.join(path, name)
        if not os.path.isfile(file):
            continue
        if not name.endswith(".index.json"):
            return reader(file)
        with open(file) as f:
            weight_map = json.load(f)["weight_map"]
        state: Dict[str, torch.Tensor] = {}
        for shard in sorted(set(weight_map.values())):
            state.update(reader(os.path.join(path, shard)))
        return state
    raise FileNotFoundError(f"{path} holds no model.safetensors, model.safetensors.index.json "
                            f"or pytorch_model.bin")


def _fix_key(key: str) -> str:
    """HF's renames of legacy names on load (PreTrainedModel.
    _fix_state_dict_key_on_load, with torch's parametrized weight norm)."""
    for old, new in (("LayerNorm.beta", "LayerNorm.bias"), ("LayerNorm.gamma", "LayerNorm.weight")):
        if key.endswith(old):
            return key[: -len(old)] + new
    for old, new in (("weight_g", "parametrizations.weight.original0"),
                     ("weight_v", "parametrizations.weight.original1")):
        if key.endswith(old):
            return key[: -len(old)] + new
    return key


def hf_names(state: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """Tensors named as ``AutoModel`` loads them into the base model: the
    renames, then the prefix rule (keys are tested before the renames,
    as HF does)."""
    fixed = {_fix_key(k): v for k, v in state.items()}
    if any(k.startswith(prefix) for k in state):
        dot = prefix + "."
        return {k[len(dot):]: v for k, v in fixed.items() if k.startswith(dot)}
    return fixed


def read_snapshot(path: str) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """An HF snapshot directory -> (config.json as a dict, its tensors under
    the base model's names)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"HF snapshot directory not found: {path}")
    cfg_file = os.path.join(path, "config.json")
    if not os.path.exists(cfg_file):
        raise FileNotFoundError(f"{path} has no config.json — not an HF snapshot directory")
    with open(cfg_file) as f:
        config = json.load(f)
    model_type = config.get("model_type")
    if model_type not in MODEL_TYPES:
        raise ValueError(f"{path}: config.json has model_type {model_type!r}, not one of "
                         f"{sorted(MODEL_TYPES)}")
    return config, hf_names(_read_weights(path), MODEL_TYPES[model_type][1])


def _load_hf_dir(path: str, expect_class: str):
    """The snapshot's config and tensors, checked to be ``expect_class``'s
    by its model_type."""
    config, state = read_snapshot(path)
    got = MODEL_TYPES[config["model_type"]][0]
    if got != expect_class:
        raise ValueError(
            f"{path} resolved to {got}, expected {expect_class} — "
            f"backbone directories mixed up?"
        )
    return config, state


def _check_architecture(what: str, path: str, pairs) -> None:
    for ours, theirs in pairs:
        if ours != theirs:
            raise ValueError(
                f"{what} snapshot {path} architecture mismatch: "
                f"config says {theirs}, model config says {ours}"
            )


def load_hubert_snapshot(path: str, cfg: ModelConfig) -> Dict[str, Any]:
    """HF snapshot dir (e.g. facebook/hubert-base-ls960) -> HubertModel
    params."""
    from triad_tpu_torch.models.weights import hf_field, port_hubert

    config, state = _load_hf_dir(path, "HubertModel")
    h = cfg.hubert
    _check_architecture("HuBERT", path, (
        (h.hidden_size, hf_field(config, "hidden_size")),
        (h.num_layers, hf_field(config, "num_hidden_layers")),
        (tuple(h.conv_dim), tuple(hf_field(config, "conv_dim"))),
    ))
    return port_hubert(state, config)


def load_distilbert_snapshot(path: str, cfg: ModelConfig) -> Dict[str, Any]:
    """HF snapshot dir (e.g. distilbert-base-uncased) -> DistilBertModel
    params."""
    from triad_tpu_torch.models.weights import hf_field, port_distilbert

    config, state = _load_hf_dir(path, "DistilBertModel")
    t = cfg.text
    _check_architecture("DistilBERT", path, (
        (t.hidden_size, hf_field(config, "dim")),
        (t.num_layers, hf_field(config, "n_layers")),
        (t.vocab_size, hf_field(config, "vocab_size")),
    ))
    return port_distilbert(state, config)


def _unwrap_hub_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """Accept the wrappers torch.hub / dinov2-release checkpoints use:
    a plain state dict, or one nested under ``model``/``state_dict``/
    ``teacher``, with an optional ``backbone.`` key prefix."""
    for wrapper in ("model", "state_dict", "teacher"):
        inner = state.get(wrapper)
        if isinstance(inner, dict) and inner:
            state = inner
            break
    if any(k.startswith("backbone.") for k in state):
        state = {
            k[len("backbone."):]: v
            for k, v in state.items()
            if k.startswith("backbone.")
        }
    return state


def load_dinov2_snapshot(path: str, cfg: ModelConfig) -> Dict[str, Any]:
    """DINOv2 weights -> DinoViT params, from either source layout:

    - a torch.hub ``.pth`` **file** (the reference's actual source,
      model.py:218): plain DinoVisionTransformer names with fused qkv;
    - an HF snapshot **directory** (facebook/dinov2-with-registers-base
      layout: separate q/k/v, ``Dinov2WithRegistersModel``).

    When ``cfg.vit.lora_rank > 0`` and the source carries no LoRA
    factors (pretrained backbones never do), fresh peft-equivalent
    factors are created (A he-uniform, B zero => adapter starts as a
    no-op), matching :func:`triad_tpu_torch.models.weights.port_dinov2`.
    """
    from triad_tpu_torch.models.weights import add_fresh_lora, hf_field, port_dinov2

    rank = cfg.vit.lora_rank
    if os.path.isfile(path):
        from triad_tpu_torch.models.reference_import import _dinov2_from_reference

        state = torch.load(path, map_location="cpu", weights_only=True)
        state = _unwrap_hub_state(dict(state))
        if "cls_token" not in state:
            raise ValueError(
                f"{path} does not look like a DINOv2 state dict "
                f"(no cls_token key; first keys: {sorted(state)[:5]})"
            )
        params = _dinov2_from_reference(state, cfg)
        if rank > 0:
            add_fresh_lora(params, cfg.vit.num_layers, rank)
        return params

    config, state = _load_hf_dir(path, "Dinov2WithRegistersModel")
    v = cfg.vit
    _check_architecture("DINOv2", path, (
        (v.hidden_size, hf_field(config, "hidden_size")),
        (v.num_layers, hf_field(config, "num_hidden_layers")),
        (v.patch_size, hf_field(config, "patch_size")),
    ))
    return port_dinov2(state, config, lora_rank=rank)


def _check_subtree(name: str, got: Dict[str, torch.Tensor],
                   want: Dict[str, torch.Tensor]) -> None:
    """The ported subtree must have exactly the model's names and shapes
    under ``name`` — a config/snapshot mismatch must fail loudly at load
    time, not as a shape error deep inside the first step."""
    g = {k: tuple(v.shape) for k, v in got.items()}
    w = {k: tuple(v.shape) for k, v in want.items() if k.startswith(name + ".")}
    if g.keys() != w.keys():
        missing = sorted(w.keys() - g.keys())[:3]
        extra = sorted(g.keys() - w.keys())[:3]
        raise ValueError(
            f"{name}: ported tree structure mismatch "
            f"(missing {missing}, unexpected {extra})"
        )
    bad = [k for k in w if g[k] != w[k]]
    if bad:
        k = bad[0]
        raise ValueError(
            f"{name}: shape mismatch at {k}: ported {g[k]}, model wants "
            f"{w[k]} (+{len(bad) - 1} more)"
        )


def init_model_from_pretrained(
    cfg: ModelConfig,
    generator: torch.Generator,
    device=None,
    hubert_path: Optional[str] = None,
    text_path: Optional[str] = None,
    vit_path: Optional[str] = None,
    reference_checkpoint: Optional[str] = None,
):
    """A TriadModel on ``device`` with pretrained backbones, built once.

    Mirrors the reference's startup: pretrained backbones, freshly
    initialized projection heads and temperature (model.py:331-353), the
    fresh part drawn by ``convert.init_triad_model`` from ``generator``
    (on its device), as a run without pretrained weights draws it; each
    named backbone is then loaded over its draw. ``reference_checkpoint``
    (a trained reference ``.pt``) overrides the per-backbone paths — it
    carries the heads and temperature too, and nothing is drawn.
    """
    from triad_tpu_torch.models.convert import flax_to_torch, init_triad_model, tree_to_state
    from triad_tpu_torch.models.multimodal import TriadModel

    if reference_checkpoint is not None:
        from triad_tpu_torch.models.reference_import import load_reference_checkpoint

        model = TriadModel(cfg, device=device)
        tree = load_reference_checkpoint(reference_checkpoint, cfg)
        model.load_state_dict(flax_to_torch(tree, cfg))
        return model.eval()

    model = init_triad_model(cfg, generator, device=device)
    want = TriadModel(cfg, device="meta").state_dict()
    for key, path, loader in (
        ("audio_backbone", hubert_path, load_hubert_snapshot),
        ("text_backbone", text_path, load_distilbert_snapshot),
        ("visual_backbone", vit_path, load_dinov2_snapshot),
    ):
        if path is None:
            continue
        ported = tree_to_state({key: loader(path, cfg)})
        _check_subtree(key, ported, want)
        model.load_state_dict(ported, strict=False)
    return model


def init_params_from_pretrained(
    cfg: ModelConfig,
    generator: torch.Generator,
    hubert_path: Optional[str] = None,
    text_path: Optional[str] = None,
    vit_path: Optional[str] = None,
    reference_checkpoint: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """The state_dict of ``init_model_from_pretrained``'s model, built on
    the generator's device."""
    return init_model_from_pretrained(
        cfg, generator, generator.device, hubert_path=hubert_path, text_path=text_path,
        vit_path=vit_path, reference_checkpoint=reference_checkpoint,
    ).state_dict()
