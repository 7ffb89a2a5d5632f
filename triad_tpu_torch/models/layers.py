"""Shared building blocks of the port's encoders (mirrors
``triad_tpu/models/layers.py``).

Dtype policy as in the JAX package: parameters stay in ``param_dtype``
(fp32) and every module casts them and its input to its compute
``dtype`` at use. Linear weights take torch's (out, in) layout; the
converter in ``models/convert.py`` transposes the Flax (in, out) kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from triad_tpu_torch.models.quantize import int8_active
from triad_tpu_torch.ops.attention import (
    attention_eval,
    attention_eval_merged,
    attention_eval_merged_pair,
    attention_eval_pair,
    attention_train,
    attention_train_merged,
    attention_train_strided,
    masked_attention,
)
from triad_tpu_torch.ops import quant
from triad_tpu_torch.ops.flash_attention import flash_attention
from triad_tpu_torch.ops.mlp import FusedMlp, gelu


def not_ported(option: str, reference: str):
    """An impl value the port does not run: raise, never fall back.
    ``reference`` names what the option runs in the JAX package (a TPU
    kernel's function, or an XLA lowering); ROADMAP.md lists what is left."""
    return NotImplementedError(
        f"{option} is not ported to triad_tpu_torch: it runs {reference} in the JAX "
        f"package (see ROADMAP.md)"
    )


class Dense(nn.Linear):
    """nn.Dense: y = x W^T + b, computed in ``dtype`` (params cast); in
    the int8 serving mode (``models/quantize.py``) the int8 product, cast
    to the input's dtype."""

    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        if int8_active():
            return quant.int8_dense(x, self.weight, self.bias).to(x.dtype)
        d = self.compute_dtype
        b = None if self.bias is None else self.bias.to(d)
        return F.linear(x.to(d), self.weight.to(d), b)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm: statistics and affine in fp32, output in ``dtype``."""

    def __init__(self, dim, eps, dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__(dim, eps=eps, device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        f32 = torch.float32
        y = F.layer_norm(x.to(f32), self.normalized_shape, self.weight.to(f32),
                         self.bias.to(f32), self.eps)
        return y.to(self.compute_dtype)


class LoRALinear(nn.Module):
    """LoRADense: y = x W^T + b + (alpha / r) x A^T B^T (peft shapes:
    lora_a (r, in), lora_b (out, r)).

    "folded" (layers.py:497-500): W + s * B A is formed in the param
    dtype, cast to ``dtype``, one product. "separate": x W^T + s (x A^T)
    B^T in ``dtype``. In the int8 serving mode either form runs the int8
    product of W + s B A, folded in fp32, cast to the input's dtype
    (quantize.py:56-66 of the JAX package)."""

    def __init__(self, in_features, out_features, rank=0, alpha=16.0, bias=True,
                 dtype=torch.float32, param_dtype=torch.float32,
                 lora_compute="folded", device=None):
        super().__init__()
        if lora_compute not in ("folded", "separate"):
            raise ValueError(f"unknown lora_compute {lora_compute!r}")
        kw = dict(device=device, dtype=param_dtype)
        self.weight = nn.Parameter(torch.empty(out_features, in_features, **kw))
        self.bias = nn.Parameter(torch.zeros(out_features, **kw)) if bias else None
        self.rank, self.alpha = rank, alpha
        if rank > 0:
            self.lora_a = nn.Parameter(torch.empty(rank, in_features, **kw))
            self.lora_b = nn.Parameter(torch.zeros(out_features, rank, **kw))
        self.compute_dtype = dtype
        self.lora_compute = lora_compute

    def forward(self, x):
        if int8_active():
            w = self.weight.to(torch.float32)
            if self.rank > 0:
                w = w + (self.alpha / self.rank) * (self.lora_b.to(torch.float32)
                                                    @ self.lora_a.to(torch.float32))
            return quant.int8_dense(x, w, self.bias).to(x.dtype)
        d = self.compute_dtype
        x = x.to(d)
        if self.rank > 0 and self.lora_compute == "folded":
            w = self.weight + (self.alpha / self.rank) * (self.lora_b @ self.lora_a)
            y = F.linear(x, w.to(d))
        else:
            y = F.linear(x, self.weight.to(d))
            if self.rank > 0:
                s = torch.tensor(self.alpha / self.rank, dtype=d)
                y = y + s * F.linear(F.linear(x, self.lora_a.to(d)), self.lora_b.to(d))
        if self.bias is not None:
            y = y + self.bias.to(d)
        return y


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]):
    """nn.Dropout as Flax applies it: keep with probability 1 - rate, kept
    values divided by 1 - rate. ``generator`` None means deterministic
    (eval): x is returned as it is."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def patch_dropout_mask(generator: torch.Generator, shape, drop_rate: float,
                       device=None) -> torch.Tensor:
    """Bernoulli(1 - drop_rate) keep mask for token dropout
    (layers.py:639-651): dropped tokens are zeroed, not removed."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - drop_rate


def mlp_forward(x, fc1: Dense, fc2: Dense, impl: str, gelu_form: str, rate: float = 0.0,
                seed: int = 0, generator: Optional[torch.Generator] = None):
    """fc2(dropout(gelu(fc1(x)))). impl "fused" runs ops.mlp.FusedMlp (the
    CUDA kernels on the card, forward and backward) with ``gelu_form`` and
    the in-kernel activation dropout at ``rate`` from the int32 ``seed``;
    "xla" runs the two Dense layers around an exact GELU and a plain
    dropout from ``generator``, as the JAX package's unfused path does."""
    if impl == "fused":
        d = fc1.compute_dtype
        return FusedMlp.apply(x.to(d), fc1.weight.to(d), fc1.bias.to(d), fc2.weight.to(d),
                              fc2.bias.to(d), gelu_form, seed, rate)
    return fc2(dropout(gelu(fc1(x), "erf"), rate, generator))


class Mlp(nn.Module):
    """Dense -> GELU -> Dense (see mlp_forward)."""

    def __init__(self, in_features, hidden_features, out_features,
                 dtype=torch.float32, param_dtype=torch.float32, impl="xla",
                 gelu_form="erf", device=None):
        super().__init__()
        if impl not in ("xla", "fused"):
            raise ValueError(f"unknown mlp impl {impl!r}")
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.fc1 = Dense(in_features, hidden_features, **kw)
        self.fc2 = Dense(hidden_features, out_features, **kw)
        self.impl, self.gelu_form = impl, gelu_form

    def forward(self, x):
        return mlp_forward(x, self.fc1, self.fc2, self.impl, self.gelu_form)


class ProjectionHead(nn.Module):
    """Linear(hidden -> 512) -> LayerNorm(eps 1e-5) -> Linear(512 -> 512)."""

    def __init__(self, in_features, embedding_dim=512, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.projection1 = Dense(in_features, embedding_dim, **kw)
        self.layer_norm = LayerNorm(embedding_dim, 1e-5, **kw)
        self.projection2 = Dense(embedding_dim, embedding_dim, **kw)

    def forward(self, x):
        return self.projection2(self.layer_norm(self.projection1(x)))


def dot_product_attention(q, k, v, mask: Optional[torch.Tensor], dtype,
                          scores_dtype=torch.float32, impl: str = "xla",
                          probs_dropout=None, dropout_rate: float = 0.0, dropout_seed: int = 0):
    """Attention dispatch of layers.py:99-211 and 385-450.

    q, k, v: (B, N, H, Dh); mask: optional (B, 1, 1, Nk) bool. impl
    "xla": plain masked softmax, with ``probs_dropout`` (a function of
    the probs) when given; "packed": the packed eval kernel on the
    (B, N, H*Dh) layout, "packed_pair" its head-pair variant; "flash":
    the flash kernels on the (B, H, N, Dh) views (differentiable); "fused"
    (fused_attention, on the (B, H, N, Dh) views) and "fused_packed"
    (fused_attention_packed): the training kernels (differentiable, ragged
    N, so ``attention_pad`` stays ignored)
    with their in-kernel dropout at ``dropout_rate`` from the int32
    ``dropout_seed``. "flash", "packed" and "packed_pair" given a live
    ``probs_dropout`` run the plain masked softmax with it, as the JAX
    dispatch does (those kernels have no dropout); "fused" and
    "fused_packed" given one raise. The merged impls take one qkv tensor:
    see merged_attention."""
    if impl == "xla" or (impl in ("flash", "packed", "packed_pair")
                         and probs_dropout is not None):
        return masked_attention(q, k, v, mask, dtype, scores_dtype, probs_dropout)
    if probs_dropout is not None:
        raise not_ported(f"attention impl {impl!r} with a plain attention dropout",
                         "the kernels' own dropout (dropout_rate, dropout_seed)")
    b, n, h, d = q.shape
    key_mask = None if mask is None else mask.reshape(b, n)
    if impl in ("fused", "fused_packed", "packed", "packed_pair", "flash") and d != 64:
        raise ValueError(f"the attention kernels need head_dim 64, got {d}")
    if impl == "fused":
        out = attention_train_strided(
            *(x.to(dtype).transpose(1, 2) for x in (q, k, v)), key_mask, dropout_seed,
            dropout_rate, 1.0 / d ** 0.5,
        )
        return out.transpose(1, 2)
    if impl == "fused_packed":
        out = attention_train(
            *(x.reshape(b, n, h * d).to(dtype) for x in (q, k, v)), key_mask, dropout_seed,
            dropout_rate, 1.0 / d ** 0.5,
        )
        return out.reshape(b, n, h, d)
    if impl in ("packed", "packed_pair"):
        fn = attention_eval_pair if impl == "packed_pair" else attention_eval
        out = fn(*(x.reshape(b, n, h * d).to(dtype) for x in (q, k, v)), key_mask,
                 1.0 / d ** 0.5)
        return out.reshape(b, n, h, d)
    if impl == "flash":
        out = flash_attention(*(x.to(dtype).transpose(1, 2) for x in (q, k, v)), key_mask,
                              1.0 / d ** 0.5)
        return out.transpose(1, 2)
    raise ValueError(f"unknown attention impl {impl!r} (the merged impls take one qkv "
                     f"tensor: merged_attention)")


MERGED_IMPLS = ("packed_merged", "fused_packed_merged", "packed_merged_pair")  # one qkv input


def merged_attention(qkv, dtype, train: bool, dropout_rate: float = 0.0,
                     dropout_seed: int = 0, pair: bool = False):
    """merged_packed_dot_product_attention (layers.py:286-382) with ragged N
    and no key mask: qkv (B, N, 3*H*64) -> (B, N, H*64). ``train``: the
    differentiable merged training kernel with its in-kernel dropout (the
    JAX ``differentiable`` flag, so a dropout-free caller still gets
    d(qkv)); else the merged eval kernel, its head-pair variant if
    ``pair``."""
    qkv = qkv.to(dtype)
    if train:
        return attention_train_merged(qkv, None, dropout_seed, dropout_rate)
    if pair:
        return attention_eval_merged_pair(qkv)
    return attention_eval_merged(qkv)
