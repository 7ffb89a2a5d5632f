"""The head-pair eval attention of the port against the JAX package, on the
CPU, at small sizes: the plain twins of ``attention_eval_pair`` and
``attention_eval_merged_pair`` against ``fused_attention_eval_pair`` and
``fused_attention_eval_merged_pair`` (Pallas in interpret mode, behind the
JAX adapters that pad queries to 8 and keys to 128), and the three
encoders with the pair impls against the JAX modules on shared parameters.

Inputs come from numpy with a seed; the port's wrappers run their plain
twins (the tensors lie on the CPU). fp32 with TF32 off.

Tolerances: fp32 1e-5 absolute on outputs of magnitude below 1 (summation
order only); bf16 one bf16 ulp of the output's largest magnitude (the two
sides round the same fp32 values, whose sums differ in order), and the
pair twin differs from the JAX pair kernel in fewer elements than the
non-pair twin does (the pair numerics: the row sum of the rounded
probabilities and a true division). Encoders 1e-4 of the largest output
(fp32 throughout). Cases cover an odd head count (the last head takes
``_head_eval``), masked keys, and a row whose keys are all masked (the
padded keys count in its softmax).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from triad_tpu.core.config import perf_eval_model_config

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BF16_ULP = 2.0 ** -7  # relative spacing of bf16 values in [1, 2)


def _inputs(b, n, h, mask_kind, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, n, h, 64)).astype(np.float32) * 0.5 for _ in range(3))
    valid = np.ones((b, n), np.float32)
    if mask_kind in ("keys", "all"):
        valid[0, n - 5:] = 0.0
    if mask_kind == "all":
        valid[-1] = 0.0  # every key of the last row masked
    return q, k, v, valid


def _jax_pair(q, k, v, valid, dtype, merged):
    from triad_tpu.models.layers import (
        merged_packed_dot_product_attention,
        packed_dot_product_attention,
    )

    b, n, h, _ = q.shape
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        if merged:
            qkv = jnp.concatenate([x.reshape(b, n, h * 64) for x in (jq, jk, jv)], axis=-1)
            out = merged_packed_dot_product_attention(qkv, jnp.asarray(valid), dtype, 64,
                                                      pair=True)
        else:
            mask = jnp.asarray(valid)[:, None, None, :].astype(bool)
            out = packed_dot_product_attention(jq, jk, jv, mask, dtype, pair=True)
    return np.asarray(jnp.asarray(out, jnp.float32)).reshape(b, n, h * 64)


def _port(q, k, v, valid, dtype, merged, pair=True):
    from triad_tpu_torch.ops import attention as A

    b, n, h, _ = q.shape
    tq, tk, tv = (torch.from_numpy(x.reshape(b, n, h * 64)).to(dtype) for x in (q, k, v))
    mask = torch.from_numpy(valid)
    if merged:
        qkv = torch.cat([tq, tk, tv], dim=-1)
        fn = A.attention_eval_merged_pair if pair else A.attention_eval_merged
        return fn(qkv, mask).float().numpy()
    fn = A.attention_eval_pair if pair else A.attention_eval
    return fn(tq, tk, tv, mask).float().numpy()


CASES = [
    # (batch, tokens, heads, mask, merged)
    (2, 99, 3, "keys", False),   # odd heads, ragged keys 99 -> 128
    (2, 40, 2, "all", False),    # an all-masked row
    (2, 130, 4, "none", False),  # keys 130 -> 256
    (2, 99, 3, "keys", True),
    (3, 64, 2, "all", True),
]


@pytest.mark.parametrize("b,n,h,mask_kind,merged", CASES)
def test_twins_match_pallas_fp32(b, n, h, mask_kind, merged):
    q, k, v, valid = _inputs(b, n, h, mask_kind, seed=n + h)
    ref = _jax_pair(q, k, v, valid, jnp.float32, merged)
    got = _port(q, k, v, valid, torch.float32, merged)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,n,h,mask_kind,merged", CASES[:3] + CASES[4:])
def test_twins_match_pallas_bf16(b, n, h, mask_kind, merged):
    """Within one bf16 ulp of the output's largest magnitude, and nearer
    the JAX pair kernel than the non-pair twin on the same inputs."""
    q, k, v, valid = _inputs(b, n, h, mask_kind, seed=n + h + 1)
    ref = _jax_pair(q, k, v, valid, jnp.bfloat16, merged)
    got = _port(q, k, v, valid, torch.bfloat16, merged)
    assert np.abs(got - ref).max() <= BF16_ULP * np.abs(ref).max()
    single = _port(q, k, v, valid, torch.bfloat16, merged, pair=False)
    assert (got != ref).sum() < (single != ref).sum()


def test_all_masked_row_averages_over_padded_keys():
    """The adapter's 128-padded keys count in a row whose keys are all
    masked: its output is sum(v) / 128, not the mean over the real keys."""
    q, k, v, valid = _inputs(1, 40, 2, "all", seed=3)
    got = _port(q, k, v, valid, torch.float32, merged=False)
    want = v[0].reshape(40, 128).sum(axis=0) / 128
    np.testing.assert_allclose(got[0], np.broadcast_to(want, (40, 128)), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_head_all_masked_row_matches_pallas(dtype):
    """The single-head eval attention ("packed") behind the JAX adapter
    (eval_pad "hbm": keys padded to 128) at N = 37 with masked keys and a
    row whose keys are all masked: the port counts the padded keys in that
    row's softmax too, sum(v) / 128 (fp32 1e-5; bf16 one ulp, as above)."""
    from triad_tpu.models.layers import packed_dot_product_attention

    q, k, v, valid = _inputs(2, 37, 2, "all", seed=37)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = packed_dot_product_attention(
            *(jnp.asarray(x, jd) for x in (q, k, v)),
            jnp.asarray(valid)[:, None, None, :].astype(bool), jd)
    ref = np.asarray(jnp.asarray(ref, jnp.float32)).reshape(2, 37, 128)
    got = _port(q, k, v, valid, td, merged=False, pair=False)
    tol = 1e-5 if dtype == "float32" else BF16_ULP * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    np.testing.assert_allclose(got[-1, 0], v[-1].reshape(37, 128).sum(axis=0) / 128,
                               rtol=0, atol=tol)


def test_distilbert_all_masked_row_matches_jax():
    """DistilBERT on the single-head "packed" eval attention at 37 tokens,
    one caption wholly masked: encode_text against the JAX module."""
    from triad_tpu.models import TriadModel as JaxTriad

    cfg = pair_model_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, attention_impl="packed"))
    jm, params, model = build_models(cfg)
    rng = np.random.default_rng(9)
    mask = np.ones((2, 37), np.float32)
    mask[1] = 0.0
    args = (rng.integers(1, 100, size=(2, 37)).astype(np.int32), mask)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda *a: jm.apply({"params": params}, *a,
                                          method=JaxTriad.encode_text))(*args)
    with torch.inference_mode():
        got = model.encode_text(*(torch.from_numpy(a) for a in args))
    _close(got, ref)


def pair_model_config():
    """perf_eval_model_config() with the pair impls and the "pallas"
    frontend, narrowed: hidden 192 in 3 heads of 64 (odd, so the last
    head takes the single-head path), 2 layers, a 3-layer 32-channel conv
    frontend (kernels 10, 3, 2, strides 5, 2, 2), 28 px images, fp32."""
    base = perf_eval_model_config()
    return dataclasses.replace(
        base,
        embedding_dim=64,
        compute_dtype="float32",
        vit=dataclasses.replace(base.vit, image_size=28, hidden_size=192, num_heads=3,
                                num_layers=2, mlp_ratio=2.0,
                                attention_impl="packed_merged_pair"),
        hubert=dataclasses.replace(base.hubert, hidden_size=192, num_heads=3, num_layers=2,
                                   intermediate_size=256, num_conv_pos_embeddings=16,
                                   num_conv_pos_embedding_groups=4, conv_dim=(32, 32, 32),
                                   conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                                   frontend_impl="pallas", attention_impl="packed_pair"),
        text=dataclasses.replace(base.text, vocab_size=100, hidden_size=192, num_heads=3,
                                 num_layers=2, intermediate_size=256,
                                 max_position_embeddings=64, attention_impl="packed_pair"),
    )


def build_models(cfg, seed=0):
    """(JAX TriadModel, its params, the port's TriadModel): the port's own
    init, LoRA B factors randomised, handed to JAX through models/convert.py."""
    from triad_tpu.models import TriadModel as JaxTriad
    from triad_tpu_torch.models.convert import init_triad_model, torch_to_flax

    model = init_triad_model(cfg, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    return JaxTriad(cfg), params, model


def _close(got, ref, rel=1e-4):
    got = got.detach().to(torch.float32).numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


@pytest.mark.parametrize("encoder,impl", [
    ("audio", "packed_pair"),
    ("audio", "packed_merged_pair"),
    ("visual", "packed_merged_pair"),
    ("text", "packed_pair"),
])
def test_encoders_match_jax(encoder, impl):
    """encode_audio / encode_visual / encode_text at eval with the pair
    impls (HuBERT on the "pallas" frontend, 2000 samples -> 99 tokens),
    DistilBERT with its key mask."""
    from triad_tpu.models import TriadModel as JaxTriad

    cfg = pair_model_config()
    if encoder == "audio":
        cfg = dataclasses.replace(cfg, hubert=dataclasses.replace(cfg.hubert,
                                                                  attention_impl=impl))
    jm, params, model = build_models(cfg)
    rng = np.random.default_rng(5)
    if encoder == "audio":
        args = ((rng.normal(size=(2, 2000)) * 0.1).astype(np.float32),)
        method, port = JaxTriad.encode_audio, model.encode_audio
    elif encoder == "visual":
        args = (rng.normal(size=(2, 28, 28, 3)).astype(np.float32),)
        method, port = JaxTriad.encode_visual, model.encode_visual
    else:
        mask = np.ones((2, 12), np.float32)
        mask[1, 7:] = 0.0
        args = (rng.integers(1, 100, size=(2, 12)).astype(np.int32), mask)
        method, port = JaxTriad.encode_text, model.encode_text
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda *a: jm.apply({"params": params}, *a, method=method))(*args)
    with torch.inference_mode():
        got = port(*(torch.from_numpy(a) for a in args))
    _close(got, ref)
