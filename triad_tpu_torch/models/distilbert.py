"""DistilBERT text encoder, eval only (mirrors
``triad_tpu/models/distilbert.py``): word + learned position embeddings,
LayerNorm(1e-12), then post-LN blocks MHA -> LN(x + attn) -> FFN ->
LN(x + ffn). Padded keys are masked in the attention scores."""

from __future__ import annotations

import torch
import torch.nn as nn

from triad_tpu.core.config import DistilBertConfig
from triad_tpu_torch.models.layers import Dense, LayerNorm, Mlp, dot_product_attention


class DistilBertAttention(nn.Module):
    def __init__(self, cfg: DistilBertConfig, dtype, param_dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        c = cfg
        self.q_lin = Dense(c.hidden_size, c.hidden_size, **kw)
        self.k_lin = Dense(c.hidden_size, c.hidden_size, **kw)
        self.v_lin = Dense(c.hidden_size, c.hidden_size, **kw)
        self.out_lin = Dense(c.hidden_size, c.hidden_size, **kw)
        self.cfg, self.dtype = cfg, dtype

    def forward(self, x, attn_mask):
        c = self.cfg
        b, n, _ = x.shape
        hd = c.hidden_size // c.num_heads
        q, k, v = (lin(x).reshape(b, n, c.num_heads, hd)
                   for lin in (self.q_lin, self.k_lin, self.v_lin))
        mask = None if attn_mask is None else attn_mask.to(torch.bool)[:, None, None, :]
        out = dot_product_attention(
            q, k, v, mask, self.dtype,
            scores_dtype=getattr(torch, c.attention_scores_dtype),
            impl=c.attention_impl,
        )
        return self.out_lin(out.reshape(b, n, c.hidden_size))


class DistilBertBlock(nn.Module):
    def __init__(self, cfg: DistilBertConfig, dtype, param_dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        c = cfg
        self.attention = DistilBertAttention(c, **kw)
        self.sa_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.ffn = Mlp(c.hidden_size, c.intermediate_size, c.hidden_size, **kw)
        self.output_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)

    def forward(self, x, attn_mask):
        x = self.sa_layer_norm(x + self.attention(x, attn_mask))
        return self.output_layer_norm(x + self.ffn(x))


class DistilBertModel(nn.Module):
    """(B, N) token ids [+ (B, N) attention mask] -> (B, N, hidden)."""

    def __init__(self, cfg: DistilBertConfig, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        c = cfg
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        pkw = dict(device=device, dtype=param_dtype)
        self.word_embeddings = nn.Parameter(torch.empty(c.vocab_size, c.hidden_size, **pkw))
        self.position_embeddings = nn.Parameter(
            torch.empty(c.max_position_embeddings, c.hidden_size, **pkw))
        self.emb_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.layers = nn.ModuleList(DistilBertBlock(c, **kw) for _ in range(c.num_layers))
        self.cfg, self.dtype = cfg, dtype

    def forward(self, input_ids, attention_mask=None):
        n = input_ids.shape[1]
        x = self.word_embeddings[input_ids.long()] + self.position_embeddings[None, :n]
        x = self.emb_layer_norm(x.to(self.dtype))
        for layer in self.layers:
            x = layer(x, attention_mask)
        return x
