"""Pretrained-weight files written from a seed in their published layouts,
at any width, with torch alone (its own safetensors writer; no
``transformers``): what the importers of ``models/hf_import.py`` and
``models/reference_import.py`` read, where the real files are not at hand.

- ``write_snapshot``: an HF snapshot directory (``config.json`` plus
  ``model.safetensors``, shards under ``model.safetensors.index.json``, or
  ``pytorch_model.bin``) of ``HubertModel``, ``DistilBertModel`` or
  ``Dinov2WithRegistersModel``; with the task model's base-model prefix
  and head keys (``HubertForCTC``, ``DistilBertForMaskedLM``,
  ``Dinov2WithRegistersForImageClassification``) if asked, HuBERT's
  positional-conv factors under the legacy ``weight_g`` / ``weight_v``
  names if asked, in fp32, fp16 or bf16;
- ``write_hub_dinov2``: the torch.hub ``dinov2_vitb14_reg`` state dict
  (DinoVisionTransformer names, fused qkv, a mask_token), plain or wrapped
  (``model``, or ``teacher`` with ``backbone.`` keys);
- ``write_reference_checkpoint``: a reference trainer's ``.pt``:
  ``model_state_dict`` behind ``_orig_mod.`` with HF HuBERT and DistilBERT
  sub-states, a peft-wrapped hub DINOv2 carrying LoRA factors, the three
  projection heads and ``temperature``, beside optimizer entries.

Every tensor is ``draw(seed, name, shape)``: a normal draw from a torch
generator keyed on the seed and the tensor's name (scaled, and offset by
one for norm weights and LayerScales), so a reader can recompute any one
tensor alone. The CPU tests hold these files to ``transformers``
(tests/test_torch_hf_layout.py); chip_smoke.py phase 18 writes them at
full width on the card's host.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, Optional

import torch

from triad_tpu_torch.config import DistilBertConfig, HubertConfig, ModelConfig, ViTConfig

_DTYPE_NAMES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
                torch.int64: "I64"}
POS_CONV = "encoder.pos_conv_embed.conv."


def draw(seed: int, name: str, shape, scale: float = 0.02, offset: float = 0.0) -> torch.Tensor:
    """offset + scale * N(0, 1) of ``shape`` (fp32), from a generator keyed
    on (seed, name) alone."""
    g = torch.Generator().manual_seed((seed * 1_000_003 + zlib.crc32(name.encode())) % 2 ** 63)
    return torch.randn(tuple(shape), generator=g) * scale + offset


def _fill(seed: int, shapes: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """A state dict of draws: norm weights, LayerScales and the pos conv's
    g around one, the rest around zero."""
    out = {}
    for name, shape in shapes.items():
        ones = (name.endswith(("norm.weight", "norm1.weight", "norm2.weight", "LayerNorm.weight",
                               "layernorm.weight", "lambda1", "gamma"))
                or name.endswith("original0") or name.endswith("weight_g"))
        out[name] = draw(seed, name, shape, offset=1.0 if ones else 0.0)
    return out


# ---------------------------------------------------------------------------
# HF names and config.json of each backbone
# ---------------------------------------------------------------------------


def hubert_shapes(c: HubertConfig) -> Dict[str, tuple]:
    """HF HubertModel's tensors (group-norm frontend, weight-normed pos
    conv under its parametrization names; masked_spec_embed iff
    ``mask_time_prob`` > 0, HF's rule)."""
    s: Dict[str, tuple] = {}
    if c.mask_time_prob > 0:
        s["masked_spec_embed"] = (c.hidden_size,)
    cin = 1
    for i, (dim, k) in enumerate(zip(c.conv_dim, c.conv_kernel)):
        p = f"feature_extractor.conv_layers.{i}."
        s[p + "conv.weight"] = (dim, cin, k)
        if c.conv_bias:
            s[p + "conv.bias"] = (dim,)
        if i == 0:
            s[p + "layer_norm.weight"] = s[p + "layer_norm.bias"] = (dim,)
        cin = dim
    h = c.hidden_size
    s["feature_projection.layer_norm.weight"] = s["feature_projection.layer_norm.bias"] = (cin,)
    s["feature_projection.projection.weight"] = (h, cin)
    s["feature_projection.projection.bias"] = (h,)
    s[POS_CONV + "bias"] = (h,)
    s[POS_CONV + "parametrizations.weight.original0"] = (1, 1, c.num_conv_pos_embeddings)
    s[POS_CONV + "parametrizations.weight.original1"] = (
        h, h // c.num_conv_pos_embedding_groups, c.num_conv_pos_embeddings)
    s["encoder.layer_norm.weight"] = s["encoder.layer_norm.bias"] = (h,)
    for i in range(c.num_layers):
        p = f"encoder.layers.{i}."
        for name in ("k_proj", "v_proj", "q_proj", "out_proj"):
            s[f"{p}attention.{name}.weight"], s[f"{p}attention.{name}.bias"] = (h, h), (h,)
        s[p + "layer_norm.weight"] = s[p + "layer_norm.bias"] = (h,)
        s[p + "feed_forward.intermediate_dense.weight"] = (c.intermediate_size, h)
        s[p + "feed_forward.intermediate_dense.bias"] = (c.intermediate_size,)
        s[p + "feed_forward.output_dense.weight"] = (h, c.intermediate_size)
        s[p + "feed_forward.output_dense.bias"] = (h,)
        s[p + "final_layer_norm.weight"] = s[p + "final_layer_norm.bias"] = (h,)
    return s


def distilbert_shapes(c: DistilBertConfig) -> Dict[str, tuple]:
    h = c.hidden_size
    s: Dict[str, tuple] = {
        "embeddings.word_embeddings.weight": (c.vocab_size, h),
        "embeddings.position_embeddings.weight": (c.max_position_embeddings, h),
        "embeddings.LayerNorm.weight": (h,), "embeddings.LayerNorm.bias": (h,),
    }
    for i in range(c.num_layers):
        p = f"transformer.layer.{i}."
        for name in ("q_lin", "k_lin", "v_lin", "out_lin"):
            s[f"{p}attention.{name}.weight"], s[f"{p}attention.{name}.bias"] = (h, h), (h,)
        s[p + "sa_layer_norm.weight"] = s[p + "sa_layer_norm.bias"] = (h,)
        s[p + "ffn.lin1.weight"], s[p + "ffn.lin1.bias"] = (c.intermediate_size, h), (
            c.intermediate_size,)
        s[p + "ffn.lin2.weight"], s[p + "ffn.lin2.bias"] = (h, c.intermediate_size), (h,)
        s[p + "output_layer_norm.weight"] = s[p + "output_layer_norm.bias"] = (h,)
    return s


def dinov2_shapes(c: ViTConfig) -> Dict[str, tuple]:
    """HF Dinov2WithRegistersModel's tensors (separate q/k/v)."""
    h, f = c.hidden_size, int(c.hidden_size * c.mlp_ratio)
    s: Dict[str, tuple] = {
        "embeddings.cls_token": (1, 1, h), "embeddings.mask_token": (1, h),
        "embeddings.register_tokens": (1, c.num_register_tokens, h),
        "embeddings.position_embeddings": (1, 1 + c.num_patches, h),
        "embeddings.patch_embeddings.projection.weight": (h, 3, c.patch_size, c.patch_size),
        "embeddings.patch_embeddings.projection.bias": (h,),
    }
    for i in range(c.num_layers):
        p = f"encoder.layer.{i}."
        s[p + "norm1.weight"] = s[p + "norm1.bias"] = (h,)
        for name in ("query", "key", "value"):
            s[f"{p}attention.attention.{name}.weight"] = (h, h)
            s[f"{p}attention.attention.{name}.bias"] = (h,)
        s[p + "attention.output.dense.weight"], s[p + "attention.output.dense.bias"] = (h, h), (h,)
        s[p + "layer_scale1.lambda1"] = (h,)
        s[p + "norm2.weight"] = s[p + "norm2.bias"] = (h,)
        s[p + "mlp.fc1.weight"], s[p + "mlp.fc1.bias"] = (f, h), (f,)
        s[p + "mlp.fc2.weight"], s[p + "mlp.fc2.bias"] = (h, f), (h,)
        s[p + "layer_scale2.lambda1"] = (h,)
    s["layernorm.weight"] = s["layernorm.bias"] = (h,)
    return s


def hf_config(model_type: str, c, architecture: Optional[str] = None) -> dict:
    """The snapshot's config.json, every architecture field written out."""
    if model_type == "hubert":
        d = {"hidden_size": c.hidden_size, "num_hidden_layers": c.num_layers,
             "num_attention_heads": c.num_heads, "intermediate_size": c.intermediate_size,
             "conv_dim": list(c.conv_dim), "conv_kernel": list(c.conv_kernel),
             "conv_stride": list(c.conv_stride), "conv_bias": c.conv_bias,
             "num_feat_extract_layers": len(c.conv_dim),
             "num_conv_pos_embeddings": c.num_conv_pos_embeddings,
             "num_conv_pos_embedding_groups": c.num_conv_pos_embedding_groups,
             "feat_extract_norm": "group", "do_stable_layer_norm": False,
             "layer_norm_eps": c.layer_norm_eps, "mask_time_prob": c.mask_time_prob,
             "mask_feature_prob": 0.0, "hidden_act": "gelu", "vocab_size": 32}
        base = "HubertModel"
    elif model_type == "distilbert":
        d = {"vocab_size": c.vocab_size, "dim": c.hidden_size, "n_layers": c.num_layers,
             "n_heads": c.num_heads, "hidden_dim": c.intermediate_size,
             "max_position_embeddings": c.max_position_embeddings, "activation": "gelu",
             "sinusoidal_pos_embds": False}
        base = "DistilBertModel"
    else:
        d = {"hidden_size": c.hidden_size, "num_hidden_layers": c.num_layers,
             "num_attention_heads": c.num_heads, "mlp_ratio": c.mlp_ratio,
             "image_size": c.image_size, "patch_size": c.patch_size,
             "num_register_tokens": c.num_register_tokens, "layer_norm_eps": c.layer_norm_eps,
             "layerscale_value": 1.0, "qkv_bias": c.qkv_bias, "hidden_act": "gelu",
             "use_swiglu_ffn": False}
        base = "Dinov2WithRegistersModel"
    return {"model_type": model_type, "architectures": [architecture or base], **d}


# (task class, base-model prefix, head tensors) of each model_type
TASK_MODELS = {
    "hubert": ("HubertForCTC", "hubert", lambda c: {"lm_head.weight": (32, c.hidden_size),
                                                    "lm_head.bias": (32,)}),
    "distilbert": ("DistilBertForMaskedLM", "distilbert", lambda c: {
        "vocab_transform.weight": (c.hidden_size, c.hidden_size),
        "vocab_transform.bias": (c.hidden_size,),
        "vocab_layer_norm.weight": (c.hidden_size,), "vocab_layer_norm.bias": (c.hidden_size,),
        "vocab_projector.weight": (c.vocab_size, c.hidden_size),
        "vocab_projector.bias": (c.vocab_size,)}),
    "dinov2_with_registers": (
        "Dinov2WithRegistersForImageClassification", "dinov2_with_registers",
        lambda c: {"classifier.weight": (2, 2 * c.hidden_size), "classifier.bias": (2,)}),
}
_SHAPES = {"hubert": hubert_shapes, "distilbert": distilbert_shapes,
           "dinov2_with_registers": dinov2_shapes}


def backbone_state(model_type: str, c, seed: int) -> Dict[str, torch.Tensor]:
    """The backbone's HF tensors, drawn from ``seed``."""
    return _fill(seed, _SHAPES[model_type](c))


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------


def write_safetensors(path: str, state: Dict[str, torch.Tensor]) -> int:
    """A ``.safetensors`` file (8-byte little-endian header length, the
    JSON header padded to 8 bytes, the tensors' bytes in header order);
    returns its size in bytes."""
    header: Dict[str, dict] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, t in state.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in state.values():
            if t.numel():
                f.write(t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(raw) + offset


def write_snapshot(path: str, model_type: str, c, seed: int, fmt: str = "safetensors",
                   task: bool = False, legacy_weight_norm: bool = False,
                   dtype: torch.dtype = torch.float32) -> int:
    """An HF snapshot directory of ``model_type`` ("hubert", "distilbert",
    "dinov2_with_registers") at ``c``'s widths. ``fmt``: "safetensors",
    "sharded" (two safetensors files and their index) or "bin".
    ``task``: the task model's file (base-model prefix, head tensors).
    Returns the bytes written."""
    state = backbone_state(model_type, c, seed)
    if legacy_weight_norm and model_type == "hubert":
        for new, old in (("parametrizations.weight.original0", "weight_g"),
                         ("parametrizations.weight.original1", "weight_v")):
            state[POS_CONV + old] = state.pop(POS_CONV + new)
    architecture = None
    if task:
        architecture, prefix, heads = TASK_MODELS[model_type]
        state = {f"{prefix}.{k}": v for k, v in state.items()}
        state.update(_fill(seed, heads(c)))
    state = {k: v.to(dtype) for k, v in state.items()}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(model_type, c, architecture), f, indent=2)
    if fmt == "bin":
        torch.save(state, os.path.join(path, "pytorch_model.bin"))
        return os.path.getsize(os.path.join(path, "pytorch_model.bin"))
    if fmt == "safetensors":
        return write_safetensors(os.path.join(path, "model.safetensors"), state)
    if fmt != "sharded":
        raise ValueError(f"unknown snapshot format {fmt!r}")
    names, shards = list(state), 2
    per = -(-len(names) // shards)
    weight_map, total, written = {}, 0, 0
    for i in range(shards):
        file = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        part = {k: state[k] for k in names[i * per:(i + 1) * per]}
        written += write_safetensors(os.path.join(path, file), part)
        total += sum(t.numel() * t.element_size() for t in part.values())
        weight_map.update({k: file for k in part})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return written


def hub_dinov2_state(c: ViTConfig, seed: int) -> Dict[str, torch.Tensor]:
    """torch.hub DinoVisionTransformer names (fused qkv), drawn from the HF
    tensors of the same seed, so a hub file and an HF snapshot of one seed
    hold the same weights."""
    hf = backbone_state("dinov2_with_registers", c, seed)
    s = {"cls_token": hf["embeddings.cls_token"],
         "register_tokens": hf["embeddings.register_tokens"],
         "pos_embed": hf["embeddings.position_embeddings"],
         "mask_token": hf["embeddings.mask_token"],
         "patch_embed.proj.weight": hf["embeddings.patch_embeddings.projection.weight"],
         "patch_embed.proj.bias": hf["embeddings.patch_embeddings.projection.bias"],
         "norm.weight": hf["layernorm.weight"], "norm.bias": hf["layernorm.bias"]}
    for i in range(c.num_layers):
        p, q = f"blocks.{i}.", f"encoder.layer.{i}."
        a = q + "attention.attention."
        for leaf in ("weight", "bias"):
            s[p + "attn.qkv." + leaf] = torch.cat(
                [hf[f"{a}{n}.{leaf}"] for n in ("query", "key", "value")])
            s[p + "attn.proj." + leaf] = hf[q + "attention.output.dense." + leaf]
            for ours, theirs in (("norm1", "norm1"), ("norm2", "norm2"), ("mlp.fc1", "mlp.fc1"),
                                 ("mlp.fc2", "mlp.fc2")):
                s[f"{p}{ours}.{leaf}"] = hf[f"{q}{theirs}.{leaf}"]
        s[p + "ls1.gamma"] = hf[q + "layer_scale1.lambda1"]
        s[p + "ls2.gamma"] = hf[q + "layer_scale2.lambda1"]
    return s


def write_hub_dinov2(path: str, c: ViTConfig, seed: int, wrap: Optional[str] = None) -> int:
    """The torch.hub ``.pth``; ``wrap`` None, "model" or "teacher" (the
    last with ``backbone.`` keys). Returns the bytes written."""
    state = hub_dinov2_state(c, seed)
    if wrap == "model":
        state = {"model": state}
    elif wrap == "teacher":
        state = {"teacher": {f"backbone.{k}": v for k, v in state.items()}}
    elif wrap is not None:
        raise ValueError(f"unknown wrapper {wrap!r}")
    torch.save(state, path)
    return os.path.getsize(path)


def reference_state(cfg: ModelConfig, seed: int) -> Dict[str, torch.Tensor]:
    """A reference MultiModalModel's state dict (train.py:398-437), behind
    torch.compile's ``_orig_mod.``: HF HuBERT, HF DistilBERT, the peft-
    wrapped hub DINOv2 with trained LoRA factors on qkv and proj, the
    three projection heads and ``temperature``."""
    s: Dict[str, torch.Tensor] = {}
    for k, v in backbone_state("hubert", cfg.hubert, seed).items():
        s["audio_embedder.hubert." + k] = v
    for k, v in backbone_state("distilbert", cfg.text, seed).items():
        s["text_embedder.encoder." + k] = v
    rank = cfg.vit.lora_rank
    for k, v in hub_dinov2_state(cfg.vit, seed).items():
        name = k
        for layer in (".attn.qkv.", ".attn.proj."):
            if layer in k and rank > 0:
                name = k.replace(layer, layer + "base_layer.")
        s["visual_embedder.model.base_model.model." + name] = v
    lora = {}
    for i in range(cfg.vit.num_layers):
        for layer, out in (("qkv", 3 * cfg.vit.hidden_size), ("proj", cfg.vit.hidden_size)):
            p = f"visual_embedder.model.base_model.model.blocks.{i}.attn.{layer}."
            if rank > 0:
                lora[p + "lora_A.default.weight"] = (rank, cfg.vit.hidden_size)
                lora[p + "lora_B.default.weight"] = (out, rank)
    s.update(_fill(seed, lora))
    heads = {}
    for head, hidden in (("audio_embedder.", cfg.hubert.hidden_size),
                         ("text_embedder.", cfg.text.hidden_size),
                         ("visual_embedder.", cfg.vit.hidden_size)):
        d = cfg.embedding_dim
        heads.update({head + "projection1.weight": (d, hidden), head + "projection1.bias": (d,),
                      head + "layer_norm.weight": (d,), head + "layer_norm.bias": (d,),
                      head + "projection2.weight": (d, d), head + "projection2.bias": (d,)})
    s.update(_fill(seed, heads))
    s["temperature"] = draw(seed, "temperature", (), scale=0.1, offset=1.0)
    return {"_orig_mod." + k: v for k, v in s.items()}


def write_reference_checkpoint(path: str, cfg: ModelConfig, seed: int) -> int:
    """A reference ``checkpoint_epoch{E}_step{S}.pt``; returns its bytes."""
    torch.save({"epoch": 3, "global_step": 1200, "model_state_dict": reference_state(cfg, seed),
                "optimizer_state_dict": {"state": {}, "param_groups": []},
                "best_val_loss": 1.5}, path)
    return os.path.getsize(path)
