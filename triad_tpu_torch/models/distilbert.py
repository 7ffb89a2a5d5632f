"""DistilBERT text encoder (mirrors ``triad_tpu/models/distilbert.py``):
word + learned position embeddings, LayerNorm(1e-12), then post-LN blocks
MHA -> LN(x + attn) -> FFN -> LN(x + ffn). Padded keys are masked in the
attention scores.

Training mode is a ``torch.Generator`` passed to ``forward``: it drives
the embedding, attention-probs and FFN-output dropouts of HF DistilBERT
(``config.dropout`` / ``config.attention_dropout``). Without one the
model is deterministic (eval). ``attention_impl="fused"`` runs the
strided training kernel with the key mask and its in-kernel attention
dropout, whose int32 seeds come from an ``ops.dropout.HostSeeds``, as in
HuBERT; ``"packed"`` and ``"packed_pair"`` run the eval kernels with the
key mask (eval only).

Under tensor parallelism (``parallel/tp.py``) the attention runs on the
rank's heads and the word embeddings on the rank's vocabulary rows."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from triad_tpu_torch.config import DistilBertConfig
from triad_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    Mlp,
    dot_product_attention,
    dropout,
    not_ported,
)
from triad_tpu_torch.ops.dropout import HostSeeds
from triad_tpu_torch.parallel import collectives as C


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

    def forward(self, x, attn_mask, generator=None, seeds: Optional[HostSeeds] = None):
        c = self.cfg
        b, n, _ = x.shape
        hd = c.hidden_size // c.num_heads
        heads = self.q_lin.out_features // hd  # this rank's heads under tensor parallelism
        q, k, v = (lin(x).reshape(b, n, heads, hd)
                   for lin in (self.q_lin, self.k_lin, self.v_lin))
        mask = None if attn_mask is None else attn_mask.to(torch.bool)[:, None, None, :]
        if self.q_lin.tp is not None and c.attention_impl != "xla":
            raise not_ported(f"attention_impl {c.attention_impl!r} on a tensor-parallel shard",
                             "the XLA attention (parallel/tp.py:resolve_xla_impls)")
        if c.attention_impl == "fused":  # distilbert.py:54-60
            rate = c.attention_dropout if generator is not None else 0.0
            if rate > 0.0 and seeds is None:
                raise ValueError("the fused attention draws its dropout seed on the host: "
                                 "pass seeds (ops.dropout.HostSeeds)")
            out = dot_product_attention(q, k, v, mask, self.dtype, impl="fused",
                                        dropout_rate=rate,
                                        dropout_seed=seeds.seed() if rate > 0.0 else 0,
                                        dropout_b0=seeds.b0(b) if rate > 0.0 else 0)
            return self.out_lin(out.reshape(b, n, heads * hd))
        probs_dropout = None
        if generator is not None and c.attention_dropout > 0:
            split = None if self.q_lin.tp is None else (1, *self.q_lin.tp.split)

            def probs_dropout(p):
                return dropout(p, c.attention_dropout, generator, split)
        out = dot_product_attention(
            q, k, v, mask, self.dtype,
            scores_dtype=getattr(torch, c.attention_scores_dtype),
            impl=c.attention_impl, probs_dropout=probs_dropout,
        )
        return self.out_lin(out.reshape(b, n, heads * hd))


class DistilBertBlock(nn.Module):
    def __init__(self, cfg: DistilBertConfig, dtype, param_dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        c = cfg
        self.attention = DistilBertAttention(c, **kw)
        self.sa_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.ffn = Mlp(c.hidden_size, c.intermediate_size, c.hidden_size, **kw)
        self.output_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.cfg = cfg

    def forward(self, x, attn_mask, generator=None, seeds: Optional[HostSeeds] = None):
        x = self.sa_layer_norm(x + self.attention(x, attn_mask, generator, seeds))
        return self.output_layer_norm(x + dropout(self.ffn(x), self.cfg.dropout, generator))


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
        self.vocab_shard = None  # (first row, rows, model group) of a vocabulary shard

    def set_vocab_shard(self, index: int, rows: int, group) -> None:
        """Hold rows [index * rows, (index + 1) * rows) of the vocabulary
        (the caller cuts the table, ``parallel/tp.py:shard_model``)."""
        self.vocab_shard = (index * rows, rows, group)

    def _embed(self, ids):
        """The word embeddings of ``ids``; on a vocabulary shard, this
        rank's rows (the other ids zeroed) summed over the model group."""
        if self.vocab_shard is None:
            return self.word_embeddings[ids]
        first, rows, group = self.vocab_shard
        local = ids - first
        held = (local >= 0) & (local < rows)
        emb = self.word_embeddings[torch.where(held, local, 0)] * held[..., None]
        return C.reduce_from_model(emb, group)

    def forward(self, input_ids, attention_mask=None, generator=None,
                seeds: Optional[HostSeeds] = None):
        n = input_ids.shape[1]
        x = self._embed(input_ids.long()) + self.position_embeddings[None, :n]
        x = dropout(self.emb_layer_norm(x.to(self.dtype)), self.cfg.dropout, generator)
        for layer in self.layers:
            x = layer(x, attention_mask, generator, seeds)
        return x
