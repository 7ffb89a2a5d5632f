"""The plain reference of the three encoders and their projection heads:
fp32 PyTorch on a dict of weights keyed by the model's state-dict names,
written from the published architectures (DINOv2 ViT-B/14 with registers
and LoRA, HuBERT Base, DistilBERT base) and the configuration's stated
choices (GELU forms, dropout rates, SpecAugment, layerdrop).

Every product goes through a :class:`Precision`: "fp32" (TF32 off, set by
the caller) for the reference, "fp8" for the control, which rounds both
operands of every product to float8 e4m3 with a per-tensor scale in the
forward pass (straight through in the backward).

The random draws of one micro step come from :class:`StepDraws`: the
torch generator's draws at the whole batch's shapes, in the order the
step makes them, and the host stream's kernel seeds and layerdrop; the
encoders take the rows of one block of the batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from reference import draws as D

F32 = torch.float32


class Precision:
    """The arithmetic of the products: "fp32" or "fp8" (e4m3 operands).

    ``volume`` rounds a stored token-sim volume: in "fp8" to e4m3 where the
    configuration stores it in bf16 (the next lower precision), unrounded
    otherwise."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x
        with torch.no_grad():
            s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
            r = (x.detach() / s).to(torch.float8_e4m3fn).to(F32) * s
        return x + (r - x).detach()

    def volume(self, x: torch.Tensor, stored: str) -> torch.Tensor:
        return self.q(x) if stored == "bfloat16" else x

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))

    def conv1d(self, x, w, b=None, **kw):
        return F.conv1d(self.q(x), self.q(w), b, **kw)

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.q(x), self.q(w), b, **kw)


def gelu(x, form: str):
    return F.gelu(x, approximate="tanh" if form == "tanh" else "none")


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def dense(P: Precision, W, name: str, x):
    return P.linear(x, W[name + ".weight"], W.get(name + ".bias"))


def projection(P, W, prefix, x):
    x = dense(P, W, prefix + ".projection1", x)
    x = layer_norm(x, W[prefix + ".layer_norm.weight"], W[prefix + ".layer_norm.bias"], 1e-5)
    return dense(P, W, prefix + ".projection2", x)


def softmax_attention(P, q, k, v, heads: int, key_mask=None, keep=None, rate=0.0):
    """q, k, v (B, N, C) -> (B, N, C): softmax(q k^T / sqrt(dh)) v per head,
    padded keys masked, the probabilities dropped by ``keep`` (B, H, N, N)."""
    b, n, c = q.shape
    dh = c // heads
    qh, kh, vh = (t.reshape(b, n, heads, dh).transpose(1, 2) for t in (q, k, v))
    s = P.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(dh)
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], torch.finfo(F32).min)
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = torch.where(keep, p / (1.0 - rate), torch.zeros((), dtype=F32, device=p.device))
    return P.matmul(p, vh).transpose(1, 2).reshape(b, n, c)


# ---------------------------------------------------------------- draws


@dataclass
class LayerSeeds:
    attention: int
    ln1: int
    mlp: int
    ln2: int


class StepDraws:
    """Every draw of one joint micro step at global step ``global_step``
    (batch sizes ``b_av``, ``b_tv``; token counts from the model config)."""

    def __init__(self, cfg: dict, seed: int, global_step: int, b_av: int, b_tv: int,
                 n_audio: int, n_text: int, device):
        vit, hub, txt = cfg["vit"], cfg["hubert"], cfg["text"]
        if txt["attention_impl"] != "xla":
            raise NotImplementedError("the reference draws DistilBERT's attention dropout "
                                      "from the generator (attention_impl 'xla')")
        g = torch.Generator(device=device).manual_seed(D.generator_seed(seed, global_step))
        n_patch = (vit["image_size"] // vit["patch_size"]) ** 2
        pv, ph = cfg["visual_dropout_prob"], hub["hidden_dropout"]
        dev = device

        def rand(shape):
            return torch.rand(shape, generator=g, device=dev)

        self.patch_av = rand((b_av, n_patch)) < 1.0 - pv if pv > 0 else None
        self.spec = None
        if hub["mask_time_prob"] > 0 and hub["apply_spec_augment"]:
            length = min(hub["mask_time_length"], n_audio)
            mean_spans = hub["mask_time_prob"] * n_audio / length
            max_spans = max(hub["mask_time_min_masks"], int(np.ceil(mean_spans)) + 1)
            eps = rand((b_av,))
            starts = torch.randint(0, max(1, n_audio - length + 1), (b_av, max_spans),
                                   generator=g, device=dev)
            spans = torch.clamp(torch.floor(mean_spans + eps).to(torch.int64),
                                min=hub["mask_time_min_masks"])
            active = torch.arange(max_spans, device=dev)[None, :] < spans[:, None]
            pos = torch.arange(n_audio, device=dev)[None, None, :]
            inside = (pos >= starts[..., None]) & (pos < starts[..., None] + length)
            self.spec = (inside & active[..., None]).any(dim=1)  # (B, N) masked steps
        if hub["feat_proj_dropout"] > 0:
            raise NotImplementedError("feat_proj_dropout > 0")
        self.audio_keep = rand((b_av, n_audio, hub["hidden_size"])) < 1.0 - ph if ph > 0 else None
        self.patch_tv = rand((b_tv, n_patch)) < 1.0 - pv if pv > 0 else None
        pt, pa = txt["dropout"], txt["attention_dropout"]
        c, h = txt["hidden_size"], txt["num_heads"]
        self.text_emb = rand((b_tv, n_text, c)) < 1.0 - pt if pt > 0 else None
        self.text_layers = []
        for _ in range(txt["num_layers"]):
            probs = rand((b_tv, h, n_text, n_text)) < 1.0 - pa if pa > 0 else None
            ffn = rand((b_tv, n_text, c)) < 1.0 - pt if pt > 0 else None
            self.text_layers.append((probs, ffn))
        hs = D.HostSeeds(seed, global_step)
        self.layers: List[Optional[LayerSeeds]] = []
        for _ in range(hub["num_layers"]):
            if hub["layerdrop"] > 0 and hs.uniform() < hub["layerdrop"]:
                self.layers.append(None)
                continue
            self.layers.append(LayerSeeds(
                hs.seed() if hub["attention_dropout"] > 0 else 0,
                hs.seed() if hub["hidden_dropout"] > 0 else 0,
                hs.seed() if hub["activation_dropout"] > 0 else 0,
                hs.seed() if hub["hidden_dropout"] > 0 else 0))


def _rows(t, lo, hi):
    return None if t is None else t[lo:hi]


# ------------------------------------------------------------------ ViT


def vit_patch_tokens(P, W, cfg: dict, images):
    """(B, H, W, 3) -> (B, P, 768): DINOv2 with registers, LoRA folded."""
    c = cfg["vit"]
    pre = "visual_backbone"
    b = images.shape[0]
    x = P.conv2d(images.permute(0, 3, 1, 2), W[pre + ".patch_embed.weight"],
                 W[pre + ".patch_embed.bias"], stride=c["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    d = c["hidden_size"]
    x = torch.cat([W[pre + ".cls_token"].expand(b, 1, d), x], dim=1) + W[pre + ".pos_embed"]
    regs = W[pre + ".register_tokens"].expand(b, c["num_register_tokens"], d)
    x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
    s = c["lora_alpha"] / c["lora_rank"]
    form = c["mlp_gelu"] if c["mlp_impl"] == "fused" else "erf"
    eps = c["layer_norm_eps"]

    def lora(name, x):
        w = W[name + ".weight"] + s * (W[name + ".lora_b"] @ W[name + ".lora_a"])
        return P.linear(x, w, W[name + ".bias"])

    for i in range(c["num_layers"]):
        blk = f"{pre}.blocks.{i}"
        h = layer_norm(x, W[blk + ".norm1.weight"], W[blk + ".norm1.bias"], eps)
        q, k, v = lora(blk + ".attn.qkv", h).split(d, dim=-1)
        a = lora(blk + ".attn.proj", softmax_attention(P, q, k, v, c["num_heads"]))
        x = x + a * W[blk + ".ls1.gamma"]
        h = layer_norm(x, W[blk + ".norm2.weight"], W[blk + ".norm2.bias"], eps)
        h = dense(P, W, blk + ".mlp.fc2", gelu(dense(P, W, blk + ".mlp.fc1", h), form))
        x = x + h * W[blk + ".ls2.gamma"]
    x = layer_norm(x, W[pre + ".norm.weight"], W[pre + ".norm.bias"], eps)
    return x[:, 1 + c["num_register_tokens"]:]


def encode_visual(P, W, cfg, images, patch_keep):
    feats = projection(P, W, "visual_projection", vit_patch_tokens(P, W, cfg, images))
    if patch_keep is not None:
        feats = feats * patch_keep[..., None].to(F32)
    return feats


# --------------------------------------------------------------- HuBERT


def frontend(P, W, cfg: dict, wave):
    """(B, T) normalised waveform -> (B, T', 512)."""
    c = cfg["hubert"]
    pre = "audio_backbone.feature_extractor"
    form = c["frontend_gelu"] if c["frontend_impl"] == "monolithic" else "erf"
    if c["frontend_impl"] == "monolithic":
        wave = wave[:, :wave.shape[1] - wave.shape[1] % 10]
    y = P.conv1d(wave[:, None, :], W[pre + ".convs.0.weight"], W.get(pre + ".convs.0.bias"),
                 stride=c["conv_stride"][0])
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + 1e-5)
    y = gelu(y * W[pre + ".group_norm.weight"][:, None] + W[pre + ".group_norm.bias"][:, None],
             form)
    for i in range(1, len(c["conv_kernel"])):
        y = gelu(P.conv1d(y, W[f"{pre}.convs.{i}.weight"], W.get(f"{pre}.convs.{i}.bias"),
                          stride=c["conv_stride"][i]), form)
    return y.transpose(1, 2)


def _lnw(W, name):
    return W[name + ".weight"], W[name + ".bias"]


def hubert_layer(P, W, cfg, i, x, seeds: LayerSeeds, lo: int):
    """One post-LN layer on rows lo .. lo + B of the batch: every dropout by
    the kernels' keep rule from the layer's seeds."""
    c = cfg["hubert"]
    pre = f"audio_backbone.layers.{i}"
    b, n, d = x.shape
    h = c["num_heads"]
    eps = c["layer_norm_eps"]
    pa, pm, ph = c["attention_dropout"], c["activation_dropout"], c["hidden_dropout"]
    dev = x.device
    q, k, v = (dense(P, W, f"{pre}.attention.{p}_proj", x) for p in "qkv")
    keep = None
    if pa > 0:
        keep = D.keep_mask(seeds.attention, range(lo * h, (lo + b) * h), n, n, pa,
                           dev).reshape(b, h, n, n)
    a = dense(P, W, pre + ".attention.out_proj", softmax_attention(P, q, k, v, h, None, keep, pa))

    def residual_ln(x, y, seed, name):
        if ph > 0:
            y = D.apply_keep(y, D.keep_mask(seed, [0], b * n, d, ph, dev, lo * n)[0]
                             .reshape(b, n, d), ph)
        return layer_norm(x + y, *_lnw(W, name), eps)

    x = residual_ln(x, a, seeds.ln1, pre + ".layer_norm")
    form = c["mlp_gelu"] if c["mlp_impl"] in ("auto", "fused") else "erf"
    g = gelu(dense(P, W, pre + ".intermediate_dense", x), form)
    if pm > 0:
        dh = g.shape[-1]
        g = D.apply_keep(g, D.keep_mask(seeds.mlp, [0], b * n, dh, pm, dev, lo * n)[0]
                         .reshape(b, n, dh), pm)
    y = dense(P, W, pre + ".output_dense", g)
    return residual_ln(x, y, seeds.ln2, pre + ".final_layer_norm")


def encode_audio(P, W, cfg, audio, dr: StepDraws, lo: int):
    c = cfg["hubert"]
    pre = "audio_backbone"
    hi = lo + audio.shape[0]
    mean = audio.mean(dim=-1, keepdim=True)
    var = audio.var(dim=-1, unbiased=False, keepdim=True)
    wave = (audio - mean) / torch.sqrt(var + 1e-7)
    x = frontend(P, W, cfg, wave)
    x = layer_norm(x, *_lnw(W, pre + ".feature_projection_norm"), c["layer_norm_eps"])
    x = dense(P, W, pre + ".feature_projection", x)
    spec = _rows(dr.spec, lo, hi)
    if spec is not None:
        x = torch.where(spec[..., None], W[pre + ".masked_spec_embed"], x)
    pw, pb = W[pre + ".pos_conv_embed.conv.weight"], W[pre + ".pos_conv_embed.conv.bias"]
    kpos = pw.shape[-1]
    pc = P.conv1d(x.transpose(1, 2), pw, pb, padding=kpos // 2,
                  groups=c["num_conv_pos_embedding_groups"])
    if kpos % 2 == 0:
        pc = pc[:, :, :-1]
    x = x + gelu(pc, "erf").transpose(1, 2)
    x = layer_norm(x, *_lnw(W, pre + ".encoder_layer_norm"), c["layer_norm_eps"])
    keep = _rows(dr.audio_keep, lo, hi)
    if keep is not None:
        x = torch.where(keep, x / (1.0 - c["hidden_dropout"]), torch.zeros((), device=x.device))
    for i, seeds in enumerate(dr.layers):
        if seeds is not None:
            x = hubert_layer(P, W, cfg, i, x, seeds, lo)
    return projection(P, W, "audio_projection", x)


# ----------------------------------------------------------- DistilBERT


def encode_text(P, W, cfg, ids, mask, dr: StepDraws, lo: int):
    c = cfg["text"]
    pre = "text_backbone"
    hi = lo + ids.shape[0]
    n = ids.shape[1]
    eps = c["layer_norm_eps"]
    pt, pa = c["dropout"], c["attention_dropout"]
    zero = torch.zeros((), device=ids.device)

    def drop(x, keep, p):
        return x if keep is None else torch.where(keep, x / (1.0 - p), zero)

    x = W[pre + ".word_embeddings"][ids.long()] + W[pre + ".position_embeddings"][None, :n]
    x = drop(layer_norm(x, *_lnw(W, pre + ".emb_layer_norm"), eps), _rows(dr.text_emb, lo, hi),
             pt)
    key_mask = mask > 0
    for i, (probs_keep, ffn_keep) in enumerate(dr.text_layers):
        lp = f"{pre}.layers.{i}"
        q, k, v = (dense(P, W, f"{lp}.attention.{p}_lin", x) for p in "qkv")
        a = softmax_attention(P, q, k, v, c["num_heads"], key_mask, _rows(probs_keep, lo, hi),
                              pa)
        x = layer_norm(x + dense(P, W, lp + ".attention.out_lin", a),
                       *_lnw(W, lp + ".sa_layer_norm"), eps)
        h = dense(P, W, lp + ".ffn.fc2", gelu(dense(P, W, lp + ".ffn.fc1", x), "erf"))
        x = layer_norm(x + drop(h, _rows(ffn_keep, lo, hi), pt),
                       *_lnw(W, lp + ".output_layer_norm"), eps)
    return projection(P, W, "text_projection", x)


def encoders(P: Precision, W: Dict[str, torch.Tensor], cfg: dict, av: dict, tv: dict,
             dr: StepDraws, lo: int, hi: int, lo_t: int, hi_t: int):
    """The four token sets of rows [lo, hi) of the AV batch and [lo_t, hi_t)
    of the TV batch: (visual_av, audio, visual_tv, text)."""
    out = {}
    if hi > lo:
        out["visual_av"] = encode_visual(P, W, cfg, av["images"][lo:hi],
                                         _rows(dr.patch_av, lo, hi))
        out["audio"] = encode_audio(P, W, cfg, av["audio"][lo:hi], dr, lo)
    if hi_t > lo_t:
        out["visual_tv"] = encode_visual(P, W, cfg, tv["images"][lo_t:hi_t],
                                         _rows(dr.patch_tv, lo_t, hi_t))
        out["text"] = encode_text(P, W, cfg, tv["token_ids"][lo_t:hi_t],
                                  tv["text_mask"][lo_t:hi_t], dr, lo_t)
    return out
