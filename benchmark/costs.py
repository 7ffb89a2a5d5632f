"""Operations and bytes from shapes, against the card's published peaks.

The first part is a frozen copy of the port's smoke script's arithmetic
(``chip_smoke.py``: ``cost``, ``attention_costs``, ``mlp_fwd_cost``, the
fused MLP backward's bound, ``stats_cost``). The second counts the
operations one joint training micro step needs, for the whole step's
share of the peak (``step_mfu``):

* forward of the three encoders at the shapes the step ran: HuBERT's
  conv frontend, feature projection, positional conv and the layers
  layerdrop kept; the ViT at all its tokens (patch dropout zeroes
  outputs and drops none); DistilBERT at every padded position; the
  projection heads; both losses' token-sim products and their diagonals;
* backward: dX through every layer a gradient crosses and dW only for
  trainable weights (the frozen ViT base takes none, its LoRA factors
  count as their own rank-r products); the waveform takes no dX;
* not counted: recompute (remat, the loss's chunked backward) and
  elementwise work. Products in fp32 count against the bf16 peak too.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense.
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
PEAK_FP64 = 67e12


def cost(flops, nbytes, peak=PEAK_BF16):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of the operations over their peak rate and the bytes (each
    input read once, each output written once) over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_costs(b, n, h=12):
    """(forward, backward) bounds of the training attention at (b, h, n,
    64): 2 and 5 products of N x N x 64 per head; bytes: q, k, v and the
    key mask in, out out forward; q, k, v, dout and the mask in, dq, dk,
    dv out backward."""
    act = b * n * h * 64 * 2
    return (cost(4 * b * h * n * n * 64, 4 * act + b * n * 4),
            cost(10 * b * h * n * n * 64, 7 * act + b * n * 4))


def mlp_fwd_cost(m):
    return cost(4 * m * 768 * 3072, (2 * m * 768 + 2 * 768 * 3072 + 3072 + 768) * 2)


def mlp_bwd_cost(m):
    """The fused MLP backward kernels' bound: h recomputed, dy W2 and dh W1
    (three products); x, dy, w1, w2 in, dx, dh and g out."""
    return cost(6 * m * 768 * 3072, (3 * m * 768 + 2 * m * 3072 + 2 * 768 * 3072) * 2)


def stats_cost(b, t):
    """The GroupNorm stats' bound: the waveform and w0 read once, (mean,
    var) written, and the Gram pass's work, 65 fp64 multiply-adds a conv_0
    step."""
    m0 = (t - 10) // 5 + 1
    return cost(2 * 65 * b * m0, b * t * 4 + 512 * 10 * 4 + 2 * b * 512 * 4, PEAK_FP64)


# ------------------------------------------------------------- the step


def _linear(m, fin, fout):
    return 2 * m * fin * fout


def _encoder_layer(m, b, n, d, dh_mlp):
    """(projection and MLP products, attention products) of one transformer
    layer over b sequences of n tokens (m = b n)."""
    return 4 * _linear(m, d, d) + 2 * _linear(m, d, dh_mlp), 2 * 2 * b * n * n * d


def vit_flops(cfg: dict, b: int) -> float:
    """Forward + backward of the ViT over b images: dX everywhere a gradient
    crosses (not into the patch embedding, nor into the first block's qkv
    input, which nothing trainable precedes), dW only of the LoRA
    factors."""
    v = cfg["vit"]
    d = v["hidden_size"]
    npatch = (v["image_size"] // v["patch_size"]) ** 2
    n = 1 + v["num_register_tokens"] + npatch
    m = b * n
    lin, att = _encoder_layer(m, b, n, d, int(d * v["mlp_ratio"]))
    r = v["lora_rank"]
    # The folded LoRA forward is one product with W + s B A (in lin); the
    # factors' dW are rank-r products on qkv and proj.
    lora = sum(2 * m * r * (d + fout) for fout in (3 * d, d))
    per_layer = (lin + att) + (lin + 2 * att) + lora
    patch = _linear(b * npatch, 3 * v["patch_size"] ** 2, d)
    return v["num_layers"] * per_layer - _linear(m, d, 3 * d) + patch


def frontend_tokens(h: dict, samples: int):
    """The frontend's output length after each conv."""
    t, lengths = samples, []
    for k, s in zip(h["conv_kernel"], h["conv_stride"]):
        t = (t - k) // s + 1
        lengths.append(t)
    return lengths


def hubert_flops(cfg: dict, b: int, samples: int, kept: int) -> float:
    """Forward + backward (dX and dW) of HuBERT over b clips with ``kept``
    layers run; conv_0 takes no dX."""
    h = cfg["hubert"]
    d = h["hidden_size"]
    lengths = frontend_tokens(h, samples)
    dims = (1,) + tuple(h["conv_dim"])
    convs = [2 * b * t * dims[i] * dims[i + 1] * k
             for i, (t, k) in enumerate(zip(lengths, h["conv_kernel"]))]
    frontend = 2 * convs[0] + 3 * sum(convs[1:])
    n = lengths[-1]
    m = b * n
    proj = 3 * _linear(m, dims[-1], d)
    g = h["num_conv_pos_embedding_groups"]
    posconv = 3 * 2 * m * d * (d // g) * h["num_conv_pos_embeddings"]
    lin, att = _encoder_layer(m, b, n, d, h["intermediate_size"])
    return frontend + proj + posconv + kept * (3 * lin + 3 * att)


def text_flops(cfg: dict, b: int, n: int) -> float:
    t = cfg["text"]
    lin, att = _encoder_layer(b * n, b, n, t["hidden_size"], t["intermediate_size"])
    return t["num_layers"] * 3 * (lin + att)


def head_flops(cfg: dict, m: int, d_in: int) -> float:
    e = cfg["embedding_dim"]
    return 3 * (_linear(m, d_in, e) + _linear(m, e, e))


def loss_flops(bq: int, bk: int, nq: int, nk: int, e: int) -> float:
    """Token sims of every pair and their two gradients, and the diagonal's
    sims and their two gradients."""
    return 3 * 2 * bq * bk * nq * nk * e + 3 * 2 * bq * nq * nk * e


def step_flops(cfg: dict, traffic: dict, kept: int) -> float:
    """One joint micro step with ``kept`` HuBERT layers run."""
    v, h, e = cfg["vit"], cfg["hubert"], cfg["embedding_dim"]
    ba, bt, nt = traffic["batch_av"], traffic["batch_tv"], traffic["text_tokens"]
    npatch = (v["image_size"] // v["patch_size"]) ** 2
    na = frontend_tokens(h, traffic["audio_samples"])[-1]
    return (vit_flops(cfg, ba) + vit_flops(cfg, bt)
            + head_flops(cfg, (ba + bt) * npatch, v["hidden_size"])
            + hubert_flops(cfg, ba, traffic["audio_samples"], kept)
            + head_flops(cfg, ba * na, h["hidden_size"])
            + text_flops(cfg, bt, nt) + head_flops(cfg, bt * nt, cfg["text"]["hidden_size"])
            + loss_flops(ba, ba, na, npatch, e) + loss_flops(bt, bt, nt, npatch, e))
