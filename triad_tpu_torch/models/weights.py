"""Pretrained HF weights as the JAX package's param trees (the port of
``triad_tpu/models/weights.py``).

The JAX functions take an HF torch module; these take what such a module
is loaded from: a flat dict of tensors under the names ``AutoModel``
gives them (``hf_import.py`` reads snapshot files into that form) and the
snapshot's ``config.json`` as a dict. Each returns the same nested numpy
tree the JAX function returns, so ``models/convert.py:flax_to_torch``
turns it into the port's state_dict and the JAX trees hold it leaf for
leaf. Conventions, as there:

  torch Linear weight (out, in)        -> kernel (in, out)
  torch Conv1d weight (out, in/g, k)   -> kernel (k, in/g, out)
  torch Conv2d weight (out, in, kh,kw) -> kernel (kh, kw, in, out)
  torch LayerNorm/GroupNorm weight     -> scale

Every tensor is read on the CPU in fp32 (a bf16 or fp16 file is upcast,
as ``from_pretrained`` into an fp32 model does). HuBERT's weight-normed
positional conv is materialised here with ``torch._weight_norm(v, g, 2)``
on the CPU in fp32: what HF's ``.weight`` hands the JAX port.

A tensor the architecture needs that the dict lacks raises, naming it.
This departs from HF, which would draw it at random (and the JAX port
inherits that draw, which no other process can reproduce).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# The HF config classes' defaults for the fields read here: a
# ``save_pretrained`` config.json holds only the fields that differ.
HF_DEFAULTS = {
    "hubert": {"hidden_size": 768, "num_hidden_layers": 12, "conv_dim": [512] * 7,
               "conv_bias": False, "mask_time_prob": 0.05, "mask_feature_prob": 0.0},
    "distilbert": {"dim": 768, "n_layers": 6, "vocab_size": 30522},
    "dinov2_with_registers": {"hidden_size": 768, "num_hidden_layers": 12, "patch_size": 16},
}

POS_CONV = "encoder.pos_conv_embed.conv."


def hf_field(config: Mapping[str, Any], name: str):
    """A field of an HF config.json dict, or its class default."""
    if name in config:
        return config[name]
    return HF_DEFAULTS[config["model_type"]][name]


class _Reader:
    """Named fp32 numpy views of a flat tensor dict; a missing name raises."""

    def __init__(self, state: Mapping[str, Any], what: str):
        self.state, self.what = state, what

    def has(self, name: str) -> bool:
        return name in self.state

    def tensor(self, name: str) -> torch.Tensor:
        if name not in self.state:
            raise ValueError(
                f"{self.what}: the weights have no {name!r}, which the architecture needs "
                f"(HF would draw it at random; the port refuses)")
        t = self.state[name]
        t = t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))
        return t.detach().to("cpu", torch.float32)

    def __call__(self, name: str) -> np.ndarray:
        return self.tensor(name).numpy()

    def dense(self, prefix: str) -> Dict[str, np.ndarray]:
        return {"kernel": self(prefix + "weight").T, "bias": self(prefix + "bias")}

    def norm(self, prefix: str) -> Dict[str, np.ndarray]:
        return {"scale": self(prefix + "weight"), "bias": self(prefix + "bias")}


# ---------------------------------------------------------------------------
# DistilBERT
# ---------------------------------------------------------------------------


def port_distilbert(state: Mapping[str, Any], config: Mapping[str, Any]) -> Dict[str, Any]:
    """HF ``DistilBertModel`` tensors -> the DistilBertModel param tree."""
    t = _Reader(state, "DistilBERT")
    params: Dict[str, Any] = {
        "word_embeddings": t("embeddings.word_embeddings.weight"),
        "position_embeddings": t("embeddings.position_embeddings.weight"),
        "emb_layer_norm": t.norm("embeddings.LayerNorm."),
    }
    for i in range(hf_field(config, "n_layers")):
        p = f"transformer.layer.{i}."
        params[f"layer_{i}"] = {
            "attention": {name: t.dense(f"{p}attention.{name}.")
                          for name in ("q_lin", "k_lin", "v_lin", "out_lin")},
            "sa_layer_norm": t.norm(p + "sa_layer_norm."),
            "ffn": {"fc1": t.dense(p + "ffn.lin1."), "fc2": t.dense(p + "ffn.lin2.")},
            "output_layer_norm": t.norm(p + "output_layer_norm."),
        }
    return params


# ---------------------------------------------------------------------------
# DINOv2 with registers
# ---------------------------------------------------------------------------


def he_uniform(shape, seed: int) -> np.ndarray:
    """A fresh LoRA A factor, (in, rank): the JAX port's draw
    (``weights.py:_he_uniform``), so both packages start bit-equal."""
    rng = np.random.default_rng(seed)
    fan_in = shape[0]
    limit = np.sqrt(6.0 / fan_in)
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def add_fresh_lora(params: Dict[str, Any], num_layers: int, rank: int) -> None:
    """Peft-equivalent fresh factors on every block's qkv (A seed 0) and
    proj (A seed 1000 + i) that lacks them: A he-uniform, B zero, so the
    adapter starts as a no-op."""
    for i in range(num_layers):
        attn = params[f"block_{i}"]["attn"]
        for name, seed in (("qkv", 0), ("proj", 1000 + i)):
            dense = attn[name]
            if "lora_a" not in dense:
                d_in, d_out = dense["kernel"].shape
                dense["lora_a"] = he_uniform((d_in, rank), seed=seed)
                dense["lora_b"] = np.zeros((rank, d_out), np.float32)


def port_dinov2(state: Mapping[str, Any], config: Mapping[str, Any],
                lora_rank: int = 0) -> Dict[str, Any]:
    """HF ``Dinov2WithRegistersModel`` tensors -> the DinoViT param tree,
    q/k/v fused into one (in, 3 out) kernel. ``lora_rank > 0`` adds fresh
    LoRA factors (``add_fresh_lora``)."""
    t = _Reader(state, "DINOv2")
    params: Dict[str, Any] = {
        "cls_token": t("embeddings.cls_token"),
        "register_tokens": t("embeddings.register_tokens"),
        "pos_embed": t("embeddings.position_embeddings"),
        "patch_embed": {
            "kernel": t("embeddings.patch_embeddings.projection.weight").transpose(2, 3, 1, 0),
            "bias": t("embeddings.patch_embeddings.projection.bias"),
        },
    }
    n = hf_field(config, "num_hidden_layers")
    for i in range(n):
        p = f"encoder.layer.{i}."
        a = p + "attention.attention."
        qkv = [t.dense(f"{a}{name}.") for name in ("query", "key", "value")]
        params[f"block_{i}"] = {
            "norm1": t.norm(p + "norm1."),
            "attn": {
                "qkv": {"kernel": np.concatenate([d["kernel"] for d in qkv], axis=1),
                        "bias": np.concatenate([d["bias"] for d in qkv])},
                "proj": t.dense(p + "attention.output.dense."),
            },
            "ls1": {"gamma": t(p + "layer_scale1.lambda1")},
            "norm2": t.norm(p + "norm2."),
            "mlp": {"fc1": t.dense(p + "mlp.fc1."), "fc2": t.dense(p + "mlp.fc2.")},
            "ls2": {"gamma": t(p + "layer_scale2.lambda1")},
        }
    params["norm"] = t.norm("layernorm.")
    if lora_rank > 0:
        add_fresh_lora(params, n, lora_rank)
    return params


# ---------------------------------------------------------------------------
# HuBERT
# ---------------------------------------------------------------------------


def pos_conv_weight(t: _Reader) -> torch.Tensor:
    """The positional conv's weight from its weight-norm factors (g, v):
    ``parametrizations.weight.original0 / original1`` or the legacy
    ``weight_g / weight_v``, as torch._weight_norm(v, g, dim=2) in fp32 on
    the CPU. Never on the card: there the norm reduces in another order."""
    pairs = (("parametrizations.weight.original0", "parametrizations.weight.original1"),
             ("weight_g", "weight_v"))
    g_name, v_name = next((p for p in pairs if t.has(POS_CONV + p[0]) or t.has(POS_CONV + p[1])),
                          pairs[0])  # neither: the modern names, which then raise
    return torch._weight_norm(t.tensor(POS_CONV + v_name), t.tensor(POS_CONV + g_name), 2)


def port_hubert(state: Mapping[str, Any], config: Mapping[str, Any]) -> Dict[str, Any]:
    """HF ``HubertModel`` tensors (base config: a group norm on conv_0)
    -> the HubertModel param tree."""
    t = _Reader(state, "HuBERT")
    fe: Dict[str, Any] = {}
    for i in range(len(hf_field(config, "conv_dim"))):
        p = f"feature_extractor.conv_layers.{i}."
        entry: Dict[str, np.ndarray] = {"kernel": t(p + "conv.weight").transpose(2, 1, 0)}
        if hf_field(config, "conv_bias"):
            entry["bias"] = t(p + "conv.bias")
        fe[f"conv_{i}"] = entry
        if i == 0:
            fe["group_norm"] = t.norm(p + "layer_norm.")
    params: Dict[str, Any] = {
        "feature_extractor": fe,
        "feature_projection_norm": t.norm("feature_projection.layer_norm."),
        "feature_projection": t.dense("feature_projection.projection."),
        "pos_conv_embed": {"conv": {
            "kernel": pos_conv_weight(t).numpy().transpose(2, 1, 0),
            "bias": t(POS_CONV + "bias"),
        }},
        "encoder_layer_norm": t.norm("encoder.layer_norm."),
    }
    # HF creates the vector iff mask_time_prob > 0 or mask_feature_prob > 0
    # (HubertModel.__init__), and the JAX port copies it when it exists.
    if hf_field(config, "mask_time_prob") > 0 or hf_field(config, "mask_feature_prob") > 0:
        params["masked_spec_embed"] = t("masked_spec_embed")
    for i in range(hf_field(config, "num_hidden_layers")):
        p = f"encoder.layers.{i}."
        params[f"layer_{i}"] = {
            "attention": {name: t.dense(f"{p}attention.{name}.")
                          for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm": t.norm(p + "layer_norm."),
            "intermediate_dense": t.dense(p + "feed_forward.intermediate_dense."),
            "output_dense": t.dense(p + "feed_forward.output_dense."),
            "final_layer_norm": t.norm(p + "final_layer_norm."),
        }
    return params
