"""HuBERT-base audio encoder, eval only (mirrors
``triad_tpu/models/hubert.py``; no SpecAugment, no layerdrop):

  7-layer conv waveform frontend (GroupNorm on conv_0, GELU after each)
  -> LayerNorm -> Dense(512 -> 768) -> + grouped positional conv
  (kernel 128, 16 groups, trailing trim for an even kernel, GELU)
  -> LayerNorm -> post-LN transformer layers

``frontend_impl="monolithic"`` runs the frontend kernels
(``ops/frontend.py``); ``"conv"`` runs plain convolutions in the compute
dtype with exact GELU. ``attention_impl="packed"`` runs the packed eval
kernel; ``mlp_impl="auto"`` runs the fused MLP kernel on a CUDA tensor
and the plain Dense/GELU/Dense elsewhere, as the JAX package picks its
Pallas kernel on the accelerator only.

The training-kernel options of ``perf_train_model_config()`` (packed
training attention, the Pallas positional conv) build the same
parameters, so a text-visual training run can carry HuBERT; running
HuBERT with them raises NotImplementedError (ROADMAP.md slice 3).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from triad_tpu_torch.config import HubertConfig
from triad_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    dot_product_attention,
    mlp_forward,
    not_ported,
)
from triad_tpu_torch.ops.attention import HEAD_DIM, attention_eval_merged
from triad_tpu_torch.ops.frontend import frontend
from triad_tpu_torch.ops.mlp import gelu


def normalize_waveform(audio: torch.Tensor) -> torch.Tensor:
    """Per padded row zero-mean / unit-variance, eps 1e-7 in the sqrt."""
    audio = audio.to(torch.float32)
    mean = audio.mean(dim=-1, keepdim=True)
    var = audio.var(dim=-1, unbiased=False, keepdim=True)
    return (audio - mean) / torch.sqrt(var + 1e-7)


class ChannelNorm(nn.Module):
    """GroupNorm with one group per channel (conv_0's norm), params only:
    the frontend applies it with full-sequence statistics."""

    def __init__(self, dim, param_dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=param_dtype))


class ConvFeatureEncoder(nn.Module):
    """(B, T) waveform -> (B, T', conv_dim[-1]) frame features."""

    def __init__(self, cfg: HubertConfig, dtype, param_dtype, device=None):
        super().__init__()
        c = cfg
        if c.frontend_impl in ("pallas", "conv_act"):
            raise not_ported(f"frontend_impl {c.frontend_impl!r}", "Queue 2 item 6")
        if c.frontend_impl not in ("conv", "monolithic"):
            raise not_ported(f"frontend_impl {c.frontend_impl!r}", "Queue 1 item 3")
        if c.frontend_impl == "monolithic" and c.conv_bias:
            raise ValueError("monolithic frontend: no conv bias")
        dims = (1,) + tuple(c.conv_dim)
        self.convs = nn.ModuleList(
            nn.Conv1d(dims[i], dims[i + 1], k, stride=s, bias=c.conv_bias,
                      device=device, dtype=param_dtype)
            for i, (k, s) in enumerate(zip(c.conv_kernel, c.conv_stride))
        )
        self.group_norm = ChannelNorm(c.conv_dim[0], param_dtype, device)
        self.cfg, self.dtype = cfg, dtype

    def forward(self, audio):
        c, d = self.cfg, self.dtype
        if c.frontend_impl == "monolithic":
            return frontend(
                audio, self.convs[0].weight, self.group_norm.weight, self.group_norm.bias,
                [conv.weight for conv in self.convs[1:]], form=c.frontend_gelu, out_dtype=d,
            )

        def conv(i, x):
            m = self.convs[i]
            b = None if m.bias is None else m.bias.to(d)
            return F.conv1d(x, m.weight.to(d), b, stride=m.stride)

        y0 = conv(0, audio.to(d)[:, None, :])  # (B, C, T0)
        yf = y0.to(torch.float32)
        mean = yf.mean(dim=-1, keepdim=True)
        var = (yf * yf).mean(dim=-1, keepdim=True) - mean * mean
        gn = self.group_norm
        x = (yf - mean) * torch.rsqrt(var + 1e-5)
        x = (x * gn.weight.to(torch.float32)[:, None] + gn.bias.to(torch.float32)[:, None]).to(d)
        x = gelu(x, "erf")
        for i in range(1, len(self.convs)):
            x = gelu(conv(i, x), "erf")
        return x.transpose(1, 2)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: HubertConfig, dtype, param_dtype, device=None):
        super().__init__()
        c = cfg
        if c.posconv_impl not in ("conv", "pallas"):
            raise ValueError(f"unknown posconv_impl {c.posconv_impl!r}")
        k = c.num_conv_pos_embeddings
        self.conv = nn.Conv1d(c.hidden_size, c.hidden_size, k, padding=k // 2,
                              groups=c.num_conv_pos_embedding_groups, device=device,
                              dtype=param_dtype)
        self.dtype = dtype

    def forward(self, x):
        d, m = self.dtype, self.conv
        h = F.conv1d(x.to(d).transpose(1, 2), m.weight.to(d), m.bias.to(d),
                     padding=m.padding, groups=m.groups)
        if m.kernel_size[0] % 2 == 0:
            h = h[:, :, :-1]  # HubertSamePadLayer
        return gelu(h, "erf").transpose(1, 2)


class HubertSelfAttention(nn.Module):
    def __init__(self, cfg: HubertConfig, dtype, param_dtype, device=None):
        super().__init__()
        c = cfg
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.q_proj = Dense(c.hidden_size, c.hidden_size, **kw)
        self.k_proj = Dense(c.hidden_size, c.hidden_size, **kw)
        self.v_proj = Dense(c.hidden_size, c.hidden_size, **kw)
        self.out_proj = Dense(c.hidden_size, c.hidden_size, **kw)
        impl = c.attention_impl
        if impl in ("packed_pair", "packed_merged_pair"):
            raise not_ported(f"HuBERT attention_impl {impl!r}", "Queue 2 item 6")
        if impl == "packed_merged" and c.hidden_size // c.num_heads != HEAD_DIM:
            raise ValueError(f"merged attention kernels require head_dim {HEAD_DIM}")
        # "auto" is XLA at eval (the fused kernel is chosen only while
        # attention dropout is live, in training).
        self.impl = "xla" if impl == "auto" else impl
        self.cfg, self.dtype = cfg, dtype

    def forward(self, x):
        c, d = self.cfg, self.dtype
        b, n, _ = x.shape
        if self.impl == "packed_merged":
            w = torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight])
            bias = torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias])
            qkv = F.linear(x.to(d), w.to(d), bias.to(d))
            return self.out_proj(attention_eval_merged(qkv))
        hd = c.hidden_size // c.num_heads
        q, k, v = (p(x).reshape(b, n, c.num_heads, hd)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        out = dot_product_attention(
            q, k, v, None, d, scores_dtype=getattr(torch, c.attention_scores_dtype),
            impl=self.impl,
        )
        return self.out_proj(out.reshape(b, n, c.hidden_size))


class HubertEncoderLayer(nn.Module):
    """Post-LN block: LN(x + attn(x)) then LN(x + mlp(x))."""

    def __init__(self, cfg: HubertConfig, dtype, param_dtype, device=None):
        super().__init__()
        c = cfg
        if c.ln_impl == "fused":
            raise not_ported("ln_impl 'fused'", "Queue 2 item 3")
        if c.ln_impl not in ("auto", "xla"):
            raise ValueError(f"unknown ln_impl {c.ln_impl!r}")
        if c.mlp_impl not in ("auto", "xla", "fused"):
            raise ValueError(f"unknown mlp_impl {c.mlp_impl!r}")
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.attention = HubertSelfAttention(c, **kw)
        self.layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.intermediate_dense = Dense(c.hidden_size, c.intermediate_size, **kw)
        self.output_dense = Dense(c.intermediate_size, c.hidden_size, **kw)
        self.final_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.cfg = cfg

    def forward(self, x):
        x = self.layer_norm(x + self.attention(x))
        impl = self.cfg.mlp_impl
        if impl == "auto":
            impl = "fused" if x.device.type == "cuda" else "xla"
        return self.final_layer_norm(x + mlp_forward(
            x, self.intermediate_dense, self.output_dense, impl, self.cfg.mlp_gelu))


class HubertModel(nn.Module):
    """(B, T) normalized waveform -> (B, T', hidden) last hidden state."""

    def __init__(self, cfg: HubertConfig, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        c = cfg
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.feature_extractor = ConvFeatureEncoder(c, **kw)
        self.feature_projection_norm = LayerNorm(c.conv_dim[-1], c.layer_norm_eps, **kw)
        self.feature_projection = Dense(c.conv_dim[-1], c.hidden_size, **kw)
        if c.mask_time_prob > 0:
            # Training-only SpecAugment vector; kept so checkpoints map 1:1.
            self.masked_spec_embed = nn.Parameter(
                torch.empty(c.hidden_size, device=device, dtype=param_dtype))
        self.pos_conv_embed = PositionalConvEmbedding(c, **kw)
        self.encoder_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.layers = nn.ModuleList(HubertEncoderLayer(c, **kw) for _ in range(c.num_layers))
        self.cfg = cfg

    def forward(self, audio):
        c = self.cfg
        if c.attention_impl in ("fused", "fused_packed", "fused_packed_merged"):
            raise not_ported(f"HuBERT attention_impl {c.attention_impl!r} (training kernel)",
                             "slice 3")
        if c.posconv_impl == "pallas":
            raise not_ported("posconv_impl 'pallas'", "Queue 2 item 4")
        x = self.feature_extractor(audio)
        x = self.feature_projection(self.feature_projection_norm(x))
        x = self.encoder_layer_norm(x + self.pos_conv_embed(x))
        for layer in self.layers:
            x = layer(x)
        return x
