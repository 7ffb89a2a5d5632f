"""The parameters of the tri-modal model, by state-dict name and shape, as
the published architectures and the configuration give them, and the
seed-made weights that both the program and the reference start from.

The weights are drawn on the device by one ``torch.randn`` of a
generator seeded from the run's seed, and cut into the leaves in the
order of :func:`param_shapes`: matrices and convolutions normal with std
1 / sqrt(fan in), embeddings and tokens normal(0.02), norms' scales 1 +
normal(0.05), biases and LoRA B normal(0.02) (a run past its first steps,
where every leaf has a gradient), LoRA A normal with std sqrt(2 / fan
in), LayerScale at the configuration's init, the SpecAugment vector
normal(0.5), the temperature at the configuration's init.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def _dense(name, fin, fout, bias=True):
    out = [(name + ".weight", (fout, fin))]
    return out + [(name + ".bias", (fout,))] if bias else out


def _ln(name, d):
    return [(name + ".weight", (d,)), (name + ".bias", (d,))]


def _projection(pre, d_in, d):
    return (_dense(pre + ".projection1", d_in, d) + _ln(pre + ".layer_norm", d)
            + _dense(pre + ".projection2", d, d))


def param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    v, h, t, e = cfg["vit"], cfg["hubert"], cfg["text"], cfg["embedding_dim"]
    out = []
    d, p = v["hidden_size"], v["patch_size"]
    npatch = (v["image_size"] // p) ** 2
    pre = "visual_backbone"
    out += [(pre + ".patch_embed.weight", (d, 3, p, p)), (pre + ".patch_embed.bias", (d,)),
            (pre + ".cls_token", (1, 1, d)),
            (pre + ".register_tokens", (1, v["num_register_tokens"], d)),
            (pre + ".pos_embed", (1, 1 + npatch, d))]
    mlp = int(d * v["mlp_ratio"])
    r = v["lora_rank"]
    for i in range(v["num_layers"]):
        b = f"{pre}.blocks.{i}"
        out += _ln(b + ".norm1", d)
        for name, fout in (("qkv", 3 * d), ("proj", d)):
            out += [(f"{b}.attn.{name}.weight", (fout, d)), (f"{b}.attn.{name}.bias", (fout,)),
                    (f"{b}.attn.{name}.lora_a", (r, d)), (f"{b}.attn.{name}.lora_b", (fout, r))]
        out += [(b + ".ls1.gamma", (d,))] + _ln(b + ".norm2", d)
        out += _dense(b + ".mlp.fc1", d, mlp) + _dense(b + ".mlp.fc2", mlp, d)
        out += [(b + ".ls2.gamma", (d,))]
    out += _ln(pre + ".norm", d) + _projection("visual_projection", d, e)

    pre = "audio_backbone"
    d, dims = h["hidden_size"], (1,) + tuple(h["conv_dim"])
    for i, k in enumerate(h["conv_kernel"]):
        out += [(f"{pre}.feature_extractor.convs.{i}.weight", (dims[i + 1], dims[i], k))]
        if h["conv_bias"]:
            out += [(f"{pre}.feature_extractor.convs.{i}.bias", (dims[i + 1],))]
    out += _ln(pre + ".feature_extractor.group_norm", dims[1])
    out += _ln(pre + ".feature_projection_norm", dims[-1])
    out += _dense(pre + ".feature_projection", dims[-1], d)
    if h["mask_time_prob"] > 0:
        out += [(pre + ".masked_spec_embed", (d,))]
    g = h["num_conv_pos_embedding_groups"]
    out += [(pre + ".pos_conv_embed.conv.weight", (d, d // g, h["num_conv_pos_embeddings"])),
            (pre + ".pos_conv_embed.conv.bias", (d,))]
    out += _ln(pre + ".encoder_layer_norm", d)
    for i in range(h["num_layers"]):
        b = f"{pre}.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += _dense(f"{b}.attention.{name}", d, d)
        out += _ln(b + ".layer_norm", d)
        out += _dense(b + ".intermediate_dense", d, h["intermediate_size"])
        out += _dense(b + ".output_dense", h["intermediate_size"], d)
        out += _ln(b + ".final_layer_norm", d)
    out += _projection("audio_projection", d, e)

    pre = "text_backbone"
    d = t["hidden_size"]
    out += [(pre + ".word_embeddings", (t["vocab_size"], d)),
            (pre + ".position_embeddings", (t["max_position_embeddings"], d))]
    out += _ln(pre + ".emb_layer_norm", d)
    for i in range(t["num_layers"]):
        b = f"{pre}.layers.{i}"
        for name in ("q_lin", "k_lin", "v_lin", "out_lin"):
            out += _dense(f"{b}.attention.{name}", d, d)
        out += _ln(b + ".sa_layer_norm", d)
        out += _dense(b + ".ffn.fc1", d, t["intermediate_size"])
        out += _dense(b + ".ffn.fc2", t["intermediate_size"], d)
        out += _ln(b + ".output_layer_norm", d)
    out += _projection("text_projection", d, e)
    out += [("temperature", ())]
    return out


def derived_seed(seed: int, purpose: int) -> int:
    """A 63-bit generator seed for one use of the run's seed."""
    key = np.random.SeedSequence([int(seed), purpose]).generate_state(1, dtype=np.uint64)[0]
    return int(key) & (2 ** 63 - 1)


WEIGHTS, BATCHES = 1, 2


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(cfg)
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, WEIGHTS))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape), size in zip(shapes, sizes):
        z = flat[at:at + size].view(shape)
        at += size
        leaf = name.rsplit(".", 1)[-1]
        if name == "temperature":
            w = torch.full(shape, cfg["temperature_init"], device=device)
        elif leaf == "gamma":
            w = torch.full(shape, cfg["vit"]["layerscale_init"], device=device)
        elif leaf in ("pos_embed", "word_embeddings", "position_embeddings", "cls_token",
                      "register_tokens", "bias", "lora_b"):
            w = z * 0.02
        elif leaf == "masked_spec_embed":
            w = z * 0.5
        elif leaf == "lora_a":
            w = z * math.sqrt(2.0 / shape[1])
        elif leaf == "weight" and len(shape) >= 2:
            w = z / math.sqrt(math.prod(shape[1:]))
        elif leaf == "weight":
            w = 1.0 + 0.05 * z
        else:
            raise KeyError(f"no init rule for {name}")
        out[name] = w.clone()
    return out
