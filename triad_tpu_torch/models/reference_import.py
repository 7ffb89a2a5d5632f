"""Import a trained reference checkpoint as the JAX package's param tree
(the port of ``triad_tpu/models/reference_import.py``).

The reference saves monolithic torch dicts (train.py:398-437) whose
``model_state_dict`` contains the full MultiModalModel: HF HuBERT under
``audio_embedder.hubert.*``, HF DistilBERT under
``text_embedder.encoder.*``, a peft-wrapped torch.hub DINOv2 under
``visual_embedder.model.*`` (fused qkv + LoRA factors), the three
projection heads, and the ``temperature`` scalar — possibly all behind a
``_orig_mod.`` prefix from torch.compile (train.py:443-454).

``port_reference_state_dict`` maps that tree onto TriadModel params
(``models/convert.py:flax_to_torch`` makes them the port's state_dict).
The HF sub-states are mapped by name through ``models/weights.py``, which
also materialises HuBERT's weight-normed positional conv (either naming
of its factors). The JAX package loads them into ``transformers`` modules
built from config instead. The DINOv2 part is mapped name by name (hub
layout: blocks.N.{norm1,attn.qkv,attn.proj,ls1,norm2,mlp.fc1,mlp.fc2,ls2},
cls_token/pos_embed/register_tokens/patch_embed/norm), accepting both
peft-wrapped (``base_model.model.`` + ``.base_layer`` +
``lora_A/lora_B.default``) and plain names.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from triad_tpu_torch.config import ModelConfig
from triad_tpu_torch.models.weights import _Reader


def strip_compile_prefix(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Remove torch.compile's ``_orig_mod.`` prefix (train.py:443-454)."""
    return {
        (k[len("_orig_mod."):] if k.startswith("_orig_mod.") else k): v
        for k, v in state_dict.items()
    }


def _subdict(state: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {
        k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)
    }


def _projection_head(state: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """projection1 -> LayerNorm -> projection2 (model.py:32-34 pattern)."""
    t = _Reader(state, "reference checkpoint")
    return {
        "projection1": t.dense(prefix + "projection1."),
        "layer_norm": t.norm(prefix + "layer_norm."),
        "projection2": t.dense(prefix + "projection2."),
    }


def _dinov2_from_reference(
    vstate: Dict[str, Any], cfg: ModelConfig
) -> Dict[str, Any]:
    """torch.hub DINOv2 (optionally peft-wrapped) -> DinoViT params."""
    # Unwrap peft prefixes.
    s: Dict[str, Any] = {}
    for k, v in vstate.items():
        k = k.replace("base_model.model.", "")
        k = k.replace(".base_layer", "")
        s[k] = v
    t = _Reader(s, "DINOv2")

    params: Dict[str, Any] = {
        "cls_token": t("cls_token"),
        "register_tokens": t("register_tokens"),
        "pos_embed": t("pos_embed"),
        "patch_embed": {
            "kernel": t("patch_embed.proj.weight").transpose(2, 3, 1, 0),
            "bias": t("patch_embed.proj.bias"),
        },
        "norm": t.norm("norm."),
    }
    # DINOv2 hub pos_embed covers CLS+patches; with registers the
    # register tokens carry no positional embedding — same as ours.
    for i in range(cfg.vit.num_layers):
        p = f"blocks.{i}."
        qkv, proj = t.dense(p + "attn.qkv."), t.dense(p + "attn.proj.")
        for dense, name in ((qkv, "attn.qkv."), (proj, "attn.proj.")):
            if t.has(p + name + "lora_A.default.weight"):
                dense["lora_a"] = t(p + name + "lora_A.default.weight").T
                dense["lora_b"] = t(p + name + "lora_B.default.weight").T
        params[f"block_{i}"] = {
            "norm1": t.norm(p + "norm1."),
            "attn": {"qkv": qkv, "proj": proj},
            "ls1": {"gamma": t(p + "ls1.gamma")},
            "norm2": t.norm(p + "norm2."),
            "mlp": {"fc1": t.dense(p + "mlp.fc1."), "fc2": t.dense(p + "mlp.fc2.")},
            "ls2": {"gamma": t(p + "ls2.gamma")},
        }
    return params


def port_reference_state_dict(
    state_dict: Dict[str, Any], cfg: ModelConfig
) -> Dict[str, Any]:
    """Reference MultiModalModel state dict -> TriadModel param tree. The
    HF sub-states are read as the JAX package builds their modules: from
    the model config, with HF's other defaults (so HuBERT's
    masked_spec_embed is expected: mask_time_prob defaults to 0.05)."""
    from triad_tpu_torch.models.weights import port_distilbert, port_hubert

    state = strip_compile_prefix(state_dict)
    h = cfg.hubert
    hubert_config = {"model_type": "hubert", "num_hidden_layers": h.num_layers,
                     "conv_dim": list(h.conv_dim), "conv_bias": h.conv_bias}
    text_config = {"model_type": "distilbert", "n_layers": cfg.text.num_layers}
    temperature = _Reader(state, "reference checkpoint").tensor("temperature")
    return {
        "audio_backbone": port_hubert(_subdict(state, "audio_embedder.hubert."), hubert_config),
        "audio_projection": _projection_head(state, "audio_embedder."),
        "text_backbone": port_distilbert(_subdict(state, "text_embedder.encoder."),
                                         text_config),
        "text_projection": _projection_head(state, "text_embedder."),
        "visual_backbone": _dinov2_from_reference(
            _subdict(state, "visual_embedder.model."), cfg
        ),
        "visual_projection": _projection_head(state, "visual_embedder."),
        "temperature": np.asarray(temperature.numpy()).reshape(()),
    }


def load_reference_checkpoint(path: str, cfg: ModelConfig) -> Dict[str, Any]:
    """Load a reference ``checkpoint_epoch{E}_step{S}.pt`` file and port
    its model weights. The file is the reference trainer's pickle (its
    optimizer and scheduler states beside the weights), so it is
    unpickled in full, as the JAX package does: load only files you
    trust."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = payload.get("model_state_dict", payload)
    return port_reference_state_dict(state_dict, cfg)
