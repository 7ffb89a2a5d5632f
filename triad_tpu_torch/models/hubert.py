"""HuBERT-base audio encoder, eval and training (mirrors
``triad_tpu/models/hubert.py``):

  7-layer conv waveform frontend (GroupNorm on conv_0, GELU after each)
  -> LayerNorm -> Dense(512 -> 768) [-> feat_proj dropout -> SpecAugment]
  -> + grouped positional conv (kernel 128, 16 groups, trailing trim for
  an even kernel, GELU) -> LayerNorm [-> dropout] -> post-LN transformer
  layers [each skipped with probability layerdrop]

``frontend_impl="monolithic"`` runs the frontend kernels
(``ops/frontend.py``, with a recompute backward); ``"conv"`` runs plain
convolutions in the compute dtype with exact GELU; ``"pallas"`` runs each
conv after conv_0 with its input's norm / GELU fused in
(``ops/frontend_conv.py:fused_frontend_conv``) and ``"conv_act"`` plain
convs with each norm / GELU as a pass of its own
(``frontend_activation``); conv_0 and its GroupNorm stats stay plain in
both, as in the JAX package. ``"matmul"``, ``"block_matmul"`` and
``"phase"`` are the JAX package's XLA lowerings (im2col products, block
products, an even/odd phase split) of the same VALID convs on the same
``conv_i`` parameters, so they run the ``"conv"`` route; ``"phase"``
first cuts the waveform to a multiple of 10 samples, as its phase split
does, and refuses a conv bias. ``posconv_impl="pallas"`` runs the
positional conv kernels (``ops/posconv.py``). Attention: ``"packed"`` the
packed eval kernel, ``"packed_pair"`` its head-pair variant; ``"fused"``
(strided) and ``"fused_packed"`` the training kernels with in-kernel
attention dropout; ``"packed_merged"`` / ``"fused_packed_merged"`` /
``"packed_merged_pair"`` one (C, 3C) product of the concatenated q/k/v
weights feeding the merged kernels (the eval kernel, or its head-pair
variant, at eval; the training kernel in training).

Training mode takes a ``torch.Generator`` (SpecAugment and the plain
dropouts) and an ``ops.dropout.HostSeeds`` (the int32 seed of each kernel
call site, and the layerdrop draws, on the host). The "auto" rules are
the JAX ones with "on a CUDA tensor" for "on a TPU backend":
``mlp_impl`` takes the fused MLP kernel on a CUDA tensor; ``ln_impl``
takes the fused dropout + add + LayerNorm kernel while training with
live hidden dropout on a CUDA tensor; ``attention_impl`` takes the
strided training kernel ("fused") while training with live attention
dropout on a CUDA tensor, and so do "packed" and "packed_pair" then.
Elsewhere they run plain ops. An explicit kernel impl takes the kernel
route everywhere (its plain twin on the CPU). Layerdrop skips a dropped
layer's compute (JAX computes and discards it): its parameters get no
gradient, which the optimizer bank treats as zero, as the JAX step's
gradient is.

``remat`` (hubert.py:895-957): "chunked_conv" (the default) runs the
frontend in two passes of checkpointed chunks on the routes that are not
one program by design (``ConvFeatureEncoder._chunked``); "conv" and
"full" checkpoint the whole frontend, whatever its impl; "full" also each
encoder layer, replaying its dropout draws in the recompute
(``_checkpointed_layer``); any other value checkpoints nothing.

Under tensor parallelism (``parallel/tp.py``) the attention runs on the
rank's heads (its attention dropout draws the full head extent and keeps
the rank's heads) and the MLP on its hidden columns.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from triad_tpu_torch.config import HubertConfig
from triad_tpu_torch.models.layers import (
    MERGED_IMPLS,
    Dense,
    LayerNorm,
    dot_product_attention,
    dropout,
    merged_attention,
    mlp_forward,
    not_ported,
)
from triad_tpu_torch.models.quantize import int8_active
from triad_tpu_torch.ops.attention import HEAD_DIM
from triad_tpu_torch.ops.dropout import HostSeeds, global_rand, global_randint, replay_generator
from triad_tpu_torch.ops.frontend import frontend_vjp
from triad_tpu_torch.ops.frontend_conv import (
    frontend_activation,
    fused_frontend_conv,
    identity_stats,
    out_rows,
)
from triad_tpu_torch.ops.layernorm import fused_dropout_add_ln
from triad_tpu_torch.ops.mlp import gelu
from triad_tpu_torch.ops.posconv import pos_conv_gelu


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
        if c.frontend_impl not in ("conv", "monolithic", "pallas", "conv_act", "matmul",
                                   "block_matmul", "phase"):
            raise ValueError(f"unknown frontend_impl {c.frontend_impl!r}")
        if c.frontend_impl in ("monolithic", "pallas", "phase") and c.conv_bias:
            raise ValueError(f"{c.frontend_impl} frontend: no conv bias")
        if c.frontend_impl == "pallas" and any(
                s != 2 or k not in (2, 3) for k, s in zip(c.conv_kernel[1:], c.conv_stride[1:])):
            raise ValueError("pallas frontend requires stride-2 convs of kernel 2 or 3 after "
                             "conv_0")
        dims = (1,) + tuple(c.conv_dim)
        self.convs = nn.ModuleList(
            nn.Conv1d(dims[i], dims[i + 1], k, stride=s, bias=c.conv_bias,
                      device=device, dtype=param_dtype)
            for i, (k, s) in enumerate(zip(c.conv_kernel, c.conv_stride))
        )
        self.group_norm = ChannelNorm(c.conv_dim[0], param_dtype, device)
        self.cfg, self.dtype = cfg, dtype

    def _weights(self):
        """The frontend's tensors as this forward reads them: (conv weights,
        conv biases, GroupNorm weight, GroupNorm bias). Under FSDP these
        are the gathered weights the parent's pre-hook swapped in; the
        checkpointed chunks take them as arguments, so a recompute in the
        backward reads what the forward read, not the slices the post-hook
        put back."""
        return ([m.weight for m in self.convs], [m.bias for m in self.convs],
                self.group_norm.weight, self.group_norm.bias)

    def _conv(self, i, x, ws):
        """conv_i in the compute dtype on (B, C, T) x."""
        b = ws[1][i]
        return F.conv1d(x, ws[0][i].to(self.dtype), None if b is None else b.to(self.dtype),
                        stride=self.convs[i].stride)

    def conv0(self, audio, ws):
        """First conv, before its norm: (B, T) -> (B, conv_dim[0], T0) in
        the compute dtype (hubert.py:conv0, channels first)."""
        return self._conv(0, audio.to(self.dtype)[:, None, :], ws)

    @staticmethod
    def stats(y0):
        """Per-(batch, channel) mean and biased variance of conv_0's output
        (B, C, T0) over time, fp32, var = E[y^2] - mean^2: (B, C, 1) each."""
        yf = y0.to(torch.float32)
        mean = yf.mean(dim=-1, keepdim=True)
        return mean, (yf * yf).mean(dim=-1, keepdim=True) - mean * mean

    def tail(self, y0, mean, var, ws):
        """The GroupNorm with the given statistics, GELU, then conv_1..n
        each followed by GELU: (B, C, T0) -> (B, T', conv_dim[-1]).
        "conv_act" runs the norm / GELU passes through frontend_activation
        (hubert.py:_conv_act_tail); the other routes plain ops."""
        d = self.dtype
        gw, gb = ws[2].to(torch.float32), ws[3].to(torch.float32)
        if self.cfg.frontend_impl == "conv_act":
            x = frontend_activation(y0.transpose(1, 2), mean.transpose(1, 2),
                                    torch.rsqrt(var + 1e-5).transpose(1, 2), gw, gb,
                                    "norm_gelu")
            for i in range(1, len(self.convs)):
                x = self._conv(i, x.transpose(1, 2), ws).transpose(1, 2)
                x = frontend_activation(x, *identity_stats(x.shape[0], x.shape[-1], x.device),
                                        "gelu")
            return x
        x = (y0.to(torch.float32) - mean) * torch.rsqrt(var + 1e-5)
        x = gelu((x * gw[:, None] + gb[:, None]).to(d), "erf")
        for i in range(1, len(self.convs)):
            x = gelu(self._conv(i, x, ws), "erf")
        return x.transpose(1, 2)

    def chunked(self) -> bool:
        """hubert.py:895-902: remat "chunked_conv" runs the two-pass chunked
        frontend, except on the frontends that are one program by design."""
        return self.cfg.remat == "chunked_conv" and self.cfg.frontend_impl not in (
            "pallas", "monolithic", "phase")

    def forward(self, audio):
        c, d = self.cfg, self.dtype
        if c.frontend_impl == "phase":
            audio = audio[:, :audio.shape[1] - audio.shape[1] % 10]
        if c.frontend_impl == "monolithic":
            return frontend_vjp(
                audio, self.convs[0].weight, self.group_norm.weight, self.group_norm.bias,
                [conv.weight for conv in self.convs[1:]], form=c.frontend_gelu, out_dtype=d,
            )
        ws = self._weights()
        if self.chunked():
            return self._chunked(audio, ws)
        y0 = self.conv0(audio, ws)
        mean, var = self.stats(y0)
        if c.frontend_impl == "pallas":
            gn = self.group_norm
            stats = (mean.transpose(1, 2), torch.rsqrt(var + 1e-5).transpose(1, 2),
                     gn.weight, gn.bias)
            return self._pallas_tail(y0.transpose(1, 2), stats)
        return self.tail(y0, mean, var, ws)

    def _sums(self, audio, ws):
        """Pass A's chunk: the fp32 sums of conv_0's output and of its
        square over time, (B, C, 1) each."""
        y = self.conv0(audio, ws).to(torch.float32)
        return y.sum(dim=-1, keepdim=True), (y * y).sum(dim=-1, keepdim=True)

    def _block(self, audio, mean, var, ws):
        """Pass B's block: the frontend of one receptive window."""
        return self.tail(self.conv0(audio, ws), mean, var, ws)

    def _chunked(self, audio, ws):
        """HubertModel._chunked_frontend (hubert.py:821-880): the two-pass
        chunked frontend. The only coupling over time is the GroupNorm's
        full-sequence statistics, so pass A streams conv_0 over waveform
        chunks of ``frontend_chunk_tokens * stride_tail`` conv_0 steps,
        summing y and y^2 in fp32, and pass B runs each block of
        ``frontend_chunk_tokens`` tokens over its receptive window (conv_0
        again, the norm with the global statistics, conv_1..n: VALID
        convs, so the blocks are exact). Where autograd will differentiate
        through them, each chunk and each block runs under a checkpoint
        (JAX's nn.checkpoint): the backward recomputes it, so only the
        waveform, the statistics and the blocks' outputs stay alive. The
        statistics carry gradient into conv_0 through pass A."""
        c = self.cfg
        k0, s0 = c.conv_kernel[0], c.conv_stride[0]
        t0_len = (audio.shape[1] - k0) // s0 + 1
        stride_tail = math.prod(c.conv_stride[1:])
        receptive_tail = 1
        for k, s in zip(reversed(c.conv_kernel[1:]), reversed(c.conv_stride[1:])):
            receptive_tail = (receptive_tail - 1) * s + k
        total_tokens = c.num_audio_tokens(audio.shape[1])
        if _grad_needed(audio, *ws[0], *ws[1], *ws[2:]):
            def run(fn, *args):
                return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            def run(fn, *args):
                return fn(*args)

        chunk0 = min(c.frontend_chunk_tokens * stride_tail, t0_len)
        total = total_sq = 0.0
        u0 = 0
        while u0 < t0_len:
            u1 = min(t0_len, u0 + chunk0)
            s, sq = run(self._sums, audio[:, u0 * s0:(u1 - 1) * s0 + k0], ws)
            total, total_sq = total + s, total_sq + sq
            u0 = u1
        mean = total / t0_len
        var = total_sq / t0_len - mean * mean

        chunk_t = min(c.frontend_chunk_tokens, total_tokens)
        outs = []
        t0 = 0
        while t0 < total_tokens:
            t1 = min(total_tokens, t0 + chunk_t)
            v0, v1 = t0 * stride_tail, (t1 - 1) * stride_tail + receptive_tail
            outs.append(run(self._block, audio[:, v0 * s0:(v1 - 1) * s0 + k0], mean, var, ws))
            t0 = t1
        return torch.cat(outs, dim=1)

    def _pallas_tail(self, x, stats):
        """hubert.py:_pallas_tail: x (B, T0, C) conv_0's output; each conv
        after it reads its input through the fused prologue (conv_1: the
        GroupNorm with ``stats`` = (mean, rstd, scale, bias), then GELU;
        later ones GELU), and the last GELU is plain."""
        prologue, t_log = "norm_gelu", x.shape[1]
        for m in self.convs[1:]:
            x = fused_frontend_conv(x, m.weight, *stats, t_log, prologue)
            t_log = out_rows(t_log, m.kernel_size[0])
            prologue, stats = "gelu", identity_stats(x.shape[0], x.shape[-1], x.device)
        return gelu(x, "erf")


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
        self.dtype, self.impl = dtype, c.posconv_impl

    def forward(self, x):
        d, m = self.dtype, self.conv
        if self.impl == "pallas":
            return pos_conv_gelu(x.to(d), m.weight.to(d), m.bias, m.groups).to(d)
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
        if impl in MERGED_IMPLS and c.hidden_size // c.num_heads != HEAD_DIM:
            raise ValueError(f"merged attention kernels require head_dim {HEAD_DIM}")
        self.cfg, self.dtype = cfg, dtype

    def forward(self, x, generator: Optional[torch.Generator] = None,
                seeds: Optional[HostSeeds] = None):
        c, d = self.cfg, self.dtype
        b, n, _ = x.shape
        impl = c.attention_impl
        train = generator is not None
        rate = c.attention_dropout if train else 0.0
        if self.q_proj.tp is not None and impl != "xla" and (
                impl != "auto" or (rate > 0.0 and x.is_cuda)):  # a kernel on the rank's heads
            raise not_ported(f"attention_impl {impl!r} on a tensor-parallel shard",
                             "the XLA attention (parallel/tp.py:resolve_xla_impls)")
        if impl in MERGED_IMPLS:
            if int8_active():
                # The merged qkv product below takes raw weights: the int8
                # mode would silently run the layer's largest products in
                # float. Raise instead (hubert.py:576-587).
                raise ValueError(
                    "hubert attention_impl=packed_merged bypasses the "
                    "int8 Dense interception (raw qkv matmul); use the "
                    "xla impls for int8 serving (models/quantize.py)"
                )
            # One (C, 3C) product (hubert.py:596-619); gradients reach
            # q_proj, k_proj and v_proj through the concatenation.
            w = torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight])
            bias = torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias])
            qkv = F.linear(x.to(d), w.to(d), bias.to(d))
            seed = seeds.seed() if rate > 0.0 else 0
            return self.out_proj(merged_attention(qkv, d, train, rate, seed,
                                                  pair=impl == "packed_merged_pair",
                                                  dropout_b0=seeds.b0(b) if rate > 0.0 else 0))
        on_cuda = x.device.type == "cuda"
        if impl == "auto" or (impl in ("packed", "packed_pair") and rate > 0.0):
            impl = "fused" if rate > 0.0 and on_cuda else "xla"
        hd = c.hidden_size // c.num_heads
        heads = self.q_proj.out_features // hd  # this rank's heads under tensor parallelism
        q, k, v = (p(x).reshape(b, n, heads, hd)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        if impl in ("fused", "fused_packed", "fused_packed_merged"):
            seed = seeds.seed() if rate > 0.0 else 0
            out = dot_product_attention(q, k, v, None, d, impl=impl, dropout_rate=rate,
                                        dropout_seed=seed,
                                        dropout_b0=seeds.b0(b) if rate > 0.0 else 0)
        else:
            probs_dropout = None
            if rate > 0.0:
                split = None if self.q_proj.tp is None else (1, *self.q_proj.tp.split)

                def probs_dropout(p):
                    return dropout(p, rate, generator, split)
            out = dot_product_attention(
                q, k, v, None, d, scores_dtype=getattr(torch, c.attention_scores_dtype),
                impl=impl, probs_dropout=probs_dropout,
            )
        return self.out_proj(out.reshape(b, n, heads * hd))


class HubertEncoderLayer(nn.Module):
    """Post-LN block: LN(x + attn(x)) then LN(x + mlp(x))."""

    def __init__(self, cfg: HubertConfig, dtype, param_dtype, device=None):
        super().__init__()
        c = cfg
        if c.ln_impl not in ("auto", "xla", "fused"):
            raise ValueError(f"unknown ln_impl {c.ln_impl!r}")
        if c.mlp_impl not in ("auto", "xla", "fused"):
            raise ValueError(f"unknown mlp_impl {c.mlp_impl!r}")
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.attention = HubertSelfAttention(c, **kw)
        self.layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.intermediate_dense = Dense(c.hidden_size, c.intermediate_size, **kw)
        self.output_dense = Dense(c.intermediate_size, c.hidden_size, **kw)
        self.final_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.cfg, self.dtype = cfg, dtype

    def _residual_ln(self, ln: LayerNorm, x, h, generator, seeds):
        """LN(x + dropout(h, hidden_dropout)): the fused kernel or plain ops."""
        c = self.cfg
        rate = c.hidden_dropout if generator is not None else 0.0
        impl = c.ln_impl
        if impl == "auto":
            impl = "fused" if rate > 0.0 and x.device.type == "cuda" else "xla"
        if impl == "fused":
            seed = seeds.seed() if rate > 0.0 else 0
            return fused_dropout_add_ln(x.to(self.dtype), h.to(self.dtype), ln.weight, ln.bias,
                                        seed, rate, c.layer_norm_eps,
                                        seeds.b0(x.shape[0]) if rate > 0.0 else 0)
        return ln(x + dropout(h, rate, generator))

    def forward(self, x, generator: Optional[torch.Generator] = None,
                seeds: Optional[HostSeeds] = None):
        c = self.cfg
        x = self._residual_ln(self.layer_norm, x, self.attention(x, generator, seeds),
                              generator, seeds)
        rate = c.activation_dropout if generator is not None else 0.0
        impl = c.mlp_impl
        if impl == "auto":
            impl = "fused" if x.device.type == "cuda" else "xla"
        live = impl == "fused" and rate > 0.0
        seed = seeds.seed() if live else 0
        h = mlp_forward(x, self.intermediate_dense, self.output_dense, impl, c.mlp_gelu, rate,
                        seed, generator, seeds.b0(x.shape[0]) if live else 0)
        return self._residual_ln(self.final_layer_norm, x, h, generator, seeds)


def spec_augment_time_mask(x: torch.Tensor, masked_embed: torch.Tensor,
                           generator: torch.Generator, mask_prob: float, mask_length: int,
                           min_masks: int) -> torch.Tensor:
    """hubert.py:_spec_augment_time_mask (HF _compute_mask_indices time
    masking): per batch row max(min_masks, floor(mask_prob T / L + U[0,
    1))) spans of L = min(mask_length, T) steps, starts uniform over [0, T
    - L], overlaps allowed; masked steps take ``masked_embed``."""
    b, t, _ = x.shape
    length = min(mask_length, t)
    mean_spans = mask_prob * t / length
    max_spans = max(min_masks, int(np.ceil(mean_spans)) + 1)
    dev = x.device
    eps = global_rand((b,), generator, dev)
    num_spans = torch.clamp(torch.floor(mean_spans + eps).to(torch.int64), min=min_masks)
    starts = global_randint(max(1, t - length + 1), (b, max_spans), generator, dev)
    active = torch.arange(max_spans, device=dev)[None, :] < num_spans[:, None]
    pos = torch.arange(t, device=dev)[None, None, :]
    in_span = (pos >= starts[..., None]) & (pos < starts[..., None] + length)
    time_mask = (in_span & active[..., None]).any(dim=1)
    return torch.where(time_mask[..., None], masked_embed.to(x.dtype), x)


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

    def forward(self, audio, generator: Optional[torch.Generator] = None,
                seeds: Optional[HostSeeds] = None):
        """Eval without ``generator``; training with it and ``seeds``."""
        c = self.cfg
        train = generator is not None
        if train and seeds is None:
            raise ValueError("HuBERT training draws kernel seeds and layerdrop on the host: "
                             "pass seeds (ops.dropout.HostSeeds)")
        if c.remat in ("conv", "full") and _grad_needed(
                audio, *self.feature_extractor.parameters()):
            # nn.remat(ConvFeatureEncoder): the whole frontend, whatever its
            # impl, recomputed in the backward.
            x = checkpoint(self.feature_extractor, audio, use_reentrant=False)
        else:
            x = self.feature_extractor(audio)
        x = self.feature_projection(self.feature_projection_norm(x))
        x = dropout(x, c.feat_proj_dropout, generator)
        if train and c.mask_time_prob > 0 and c.apply_spec_augment:
            x = spec_augment_time_mask(x, self.masked_spec_embed, generator, c.mask_time_prob,
                                       c.mask_time_length, c.mask_time_min_masks)
        x = self.encoder_layer_norm(x + self.pos_conv_embed(x))
        x = dropout(x, c.hidden_dropout, generator)
        for layer in self.layers:
            if train and c.layerdrop > 0 and seeds.uniform() < c.layerdrop:
                continue  # LayerDrop: one draw per layer for the whole batch
            if c.remat == "full" and _grad_needed(x, *layer.parameters()):
                x = _checkpointed_layer(layer, x, generator, seeds)
            else:
                x = layer(x, generator, seeds)
        return x


def _grad_needed(*tensors) -> bool:
    """Will autograd differentiate through these? Only then is a
    checkpoint worth its recompute (an eval forward, a frozen encoder and
    torch.export's trace take none)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _checkpointed_layer(layer, x, generator, seeds):
    """``layer(x, generator, seeds)`` under a checkpoint (remat "full",
    hubert.py:954-957) whose recompute draws what the forward drew: the
    plain dropouts take an explicit generator, which the checkpoint's
    preserve_rng_state does not restore, and the kernels take seeds from
    the host stream, which would move on. So the generator's state and the
    stream's position are noted before the call, and the recompute runs on
    a generator set to that state and a stream at that position; the
    forward's own draws advance the live ones as without remat."""
    if generator is None:
        return checkpoint(layer, x, None, None, use_reentrant=False)
    state, site = generator.get_state(), seeds.site
    calls = []

    def run(x):
        if calls:  # the recompute in the backward
            return layer(x, replay_generator(generator, state), seeds.at(site))
        calls.append(1)
        return layer(x, generator, seeds)

    return checkpoint(run, x, use_reentrant=False)
