"""Parameters between the JAX package's Flax tree and the port's
``state_dict``, and a torch-native random init.

Names map one to one: a Flax path joins with "." after ``block_<i>``,
``layer_<i>`` and ``conv_<i>`` become ``blocks.<i>``, ``layers.<i>`` and
``convs.<i>`` (nn.ModuleList), and the leaf ``kernel`` / ``scale``
becomes ``weight``. Leaves change layout where the two frameworks differ:

  Dense kernel (in, out)          <-> Linear weight (out, in)
  1-D conv kernel (k, in/g, out)  <-> Conv1d weight (out, in/g, k)
  2-D conv kernel HWIO            <-> Conv2d weight OIHW
  lora_a (in, r), lora_b (r, out) <-> lora_a (r, in), lora_b (out, r)

HuBERT keeps its separate q/k/v projections in both packages (the merged
eval kernel concatenates them at use).
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from triad_tpu_torch.config import ModelConfig
from triad_tpu_torch.models.multimodal import TriadModel

_LIST_ITEM = re.compile(r"^(block|layer|conv)_(\d+)$")
_LIST_NAMES = {"block": "blocks", "layer": "layers", "conv": "convs"}
_FLAX_ITEM = {v: k for k, v in _LIST_NAMES.items()}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_layout(leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf in ("lora_a", "lora_b"):
        return a.T
    if leaf == "kernel":
        return {2: lambda x: x.T,
                3: lambda x: x.transpose(2, 1, 0),
                4: lambda x: x.transpose(3, 2, 0, 1)}[a.ndim](a)
    return a


def _to_flax_layout(leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf in ("lora_a", "lora_b"):
        return a.T
    if leaf == "kernel":
        return {2: lambda x: x.T,
                3: lambda x: x.transpose(2, 1, 0),
                4: lambda x: x.transpose(2, 3, 1, 0)}[a.ndim](a)
    return a


def flax_to_torch(params: Any, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of arrays) -> TriadModel state_dict
    (fp32 CPU tensors), checked against the model ``cfg`` describes."""
    out = tree_to_state(params)
    _check_same(TriadModel(cfg, device="meta").state_dict(), out)
    return out


def tree_to_state(params: Any) -> Dict[str, torch.Tensor]:
    """A Flax param tree, or a part of one under its top-level keys, ->
    state_dict entries (fp32 CPU tensors), unchecked."""
    out = {}
    for path, value in _flatten(params):
        parts = []
        for p in path[:-1]:
            m = _LIST_ITEM.match(p)
            parts += [_LIST_NAMES[m[1]], m[2]] if m else [p]
        leaf = path[-1]
        parts.append({"kernel": "weight", "scale": "weight"}.get(leaf, leaf))
        a = _to_torch_layout(leaf, np.asarray(value, dtype=np.float32))
        out[".".join(parts)] = torch.from_numpy(a.copy(order="C"))
    return out


def torch_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """TriadModel state_dict -> Flax param tree of fp32 numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        path = []
        i = 0
        while i < len(parts) - 1:
            if parts[i] in _FLAX_ITEM and parts[i + 1].isdigit():
                path.append(f"{_FLAX_ITEM[parts[i]]}_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        a = value.detach().to("cpu", torch.float32).numpy()
        leaf = parts[-1]
        if leaf == "weight":
            leaf = "kernel" if a.ndim >= 2 else "scale"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = _to_flax_layout(leaf, a).copy(order="C")
    return tree


def _check_same(want, got):
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"param trees differ: missing {missing[:5]}, unexpected {extra[:5]}")
    for k, v in want.items():
        if tuple(v.shape) != tuple(got[k].shape):
            raise ValueError(f"{k}: shape {tuple(got[k].shape)} != {tuple(v.shape)}")


_NORMAL_002 = ("pos_embed", "word_embeddings", "position_embeddings")
_ZEROS = ("bias", "lora_b", "cls_token", "register_tokens")


@torch.no_grad()
def init_triad_model(cfg: ModelConfig, generator: torch.Generator, device=None) -> TriadModel:
    """A TriadModel with random weights drawn from ``generator``, with the
    JAX package's init families: Dense/conv weights normal with std
    1/sqrt(fan_in) (Flax's lecun_normal, untruncated here), LoRA A
    He-uniform and B zero (the adapter starts as a no-op), norms one and
    zero, embeddings normal(0.02), LayerScale ``layerscale_init``,
    temperature ``temperature_init``."""
    model = TriadModel(cfg, device=device)
    gdev = generator.device

    def randn(shape):
        return torch.randn(shape, generator=generator, device=gdev)

    def rand(shape):
        return torch.rand(shape, generator=generator, device=gdev)

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(p.shape)
        if name == "temperature":
            val = torch.tensor(cfg.temperature_init)
        elif leaf in _ZEROS:
            val = torch.zeros(shape)
        elif leaf == "gamma":
            val = torch.full(shape, cfg.vit.layerscale_init)
        elif leaf in _NORMAL_002:
            val = randn(shape) * 0.02
        elif leaf == "masked_spec_embed":
            val = rand(shape)
        elif leaf == "lora_a":
            bound = (6.0 / shape[1]) ** 0.5
            val = (rand(shape) * 2 - 1) * bound
        elif leaf == "weight" and p.ndim >= 2:
            fan_in = p[0].numel()
            val = randn(shape) / fan_in ** 0.5
        elif leaf == "weight":
            val = torch.ones(shape)
        else:
            raise KeyError(f"no init rule for {name}")
        p.copy_(val.to(p.device, p.dtype))
    return model.eval()
