"""The port's int8 serving mode (triad_tpu_torch/ops/quant.py,
models/quantize.py) against the JAX package's (tests/test_quant.py): the
quantized product's numerics, its int32 sums exact on integers, which
products run int8 (count, order and (K, N) equal to JAX's on the
plain-XLA config and on a fused-kernel config, JAX's ``int8_dense``
wrapped at runtime), the whole model's int8 embeddings against JAX's int8
embeddings on the same weights and against the port's own float ones,
retrieval ranks kept, and HuBERT's merged-qkv raise.

Tolerances: int8_dense against JAX's 1e-6 relative (the same roundings
in fp32); the visual and text int8 embeddings against JAX's within 1e-5
(their float inputs agree to ~1e-6, and no activation rounds the other
way there); the audio ones at token cosine > 0.999, mean > 0.9999:
HuBERT's float frontend differs from JAX's by ~2e-6, so a few activations
land on the other side of an int8 rounding boundary and move a token by
up to one quantum per product (measured: min 0.99989, mean 0.999996);
float vs int8 as tests/test_quant.py (cosine > 0.995, clip sims 0.02)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_multimodal import small_model_config
from tests.test_torch_hf_import import port_cfg
from triad_tpu_torch.models.quantize import int8_active, int8_interception
from triad_tpu_torch.ops import quant


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def test_int8_dense_close_to_fp_and_to_jax():
    from triad_tpu.ops.quant import int8_dense as jax_int8_dense

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 768)).astype(np.float32)
    w = rng.normal(size=(768, 512)).astype(np.float32) * 0.02
    b = rng.normal(size=(512,)).astype(np.float32)
    y_q = quant.int8_dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                           torch.from_numpy(b)).numpy()
    y_fp = x @ w + b
    assert y_q.dtype == np.float32
    assert _cos(y_fp, y_q) > 0.9995
    assert np.abs(y_q - y_fp).max() < 0.15
    y_jax = np.asarray(jax_int8_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(y_q, y_jax, rtol=1e-6, atol=1e-6)


def test_int32_sums_exact_on_integers():
    """Pre-quantized integers round-trip exactly: the only error of
    int8_dense is rounding, never accumulation; the plain product equals
    numpy's int64 sums."""
    rng = np.random.default_rng(1)
    xi = rng.integers(-126, 127, size=(8, 256)).astype(np.float32)
    wi = rng.integers(-126, 127, size=(256, 16)).astype(np.float32)
    xi[:, 0] = 127.0
    wi[0, :] = 127.0
    y_q = quant.int8_dense(torch.from_numpy(xi), torch.from_numpy(wi.T.copy())).numpy()
    np.testing.assert_array_equal(y_q, xi @ wi)
    a = rng.integers(-127, 128, size=(37, 3072), dtype=np.int8)
    b = rng.integers(-127, 128, size=(24, 3072), dtype=np.int8)
    got = quant.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


def _fused_config():
    """Kernel routes that take raw weights: the fused MLP in the ViT and
    HuBERT, the merged-qkv eval attention in the ViT (its qkv product
    still runs as a LoRA Dense)."""
    m = small_model_config(visual_dropout_prob=0.0)
    return dataclasses.replace(
        m, vit=dataclasses.replace(m.vit, mlp_impl="fused", attention_impl="packed_merged",
                                   hidden_size=128, num_heads=2),  # the kernels' head_dim 64
        hubert=dataclasses.replace(m.hubert, mlp_impl="fused"))


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 28, 28, 3)).astype(np.float32),
            (rng.normal(size=(b, 1600)) * 0.1).astype(np.float32),
            rng.integers(1, 100, size=(b, 8)).astype(np.int32),
            np.ones((b, 8), np.float32))


def _port_model(cfg, lora_seed=None):
    from triad_tpu_torch.models.convert import init_triad_model

    model = init_triad_model(port_cfg(cfg), torch.Generator().manual_seed(0))
    if lora_seed is not None:  # a trained adapter: B nonzero, so LoRA folds in
        g = torch.Generator().manual_seed(lora_seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("lora_b"):
                    p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return model


def _port_out(model, batch, int8):
    with torch.no_grad():
        if not int8:
            return model(*(torch.from_numpy(b) for b in batch))
        with int8_interception():
            assert int8_active()
            return model(*(torch.from_numpy(b) for b in batch))


def _jax_out(cfg, model, batch, int8):
    from triad_tpu.models import TriadModel
    from triad_tpu.models.quantize import int8_interception as jax_int8
    from triad_tpu_torch.models.convert import torch_to_flax

    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    with pltpu.force_tpu_interpret_mode():
        if not int8:
            return TriadModel(cfg).apply({"params": params}, *map(jnp.asarray, batch))
        with jax_int8():
            return TriadModel(cfg).apply({"params": params}, *map(jnp.asarray, batch))


@pytest.mark.parametrize("which", ["xla", "fused"])
def test_int8_products_match_jax(monkeypatch, which):
    """The same products run int8, in the same order, with the same (K,
    N): the JAX interceptor's calls against the port's flagged forwards."""
    import triad_tpu.models.quantize as jax_quantize

    cfg = small_model_config(visual_dropout_prob=0.0) if which == "xla" else _fused_config()
    model = _port_model(cfg)
    calls = {"jax": [], "port": []}
    jax_fn, port_fn = jax_quantize.int8_dense, quant.int8_dense

    def jax_wrapped(x, kernel, bias=None):
        calls["jax"].append(tuple(kernel.shape))
        return jax_fn(x, kernel, bias)

    def port_wrapped(x, weight, bias=None):
        calls["port"].append(tuple(weight.shape[::-1]))
        return port_fn(x, weight, bias)

    monkeypatch.setattr(jax_quantize, "int8_dense", jax_wrapped)
    monkeypatch.setattr(quant, "int8_dense", port_wrapped)
    _jax_out(cfg, model, _batch(), int8=True)
    _port_out(model, _batch(), int8=True)
    assert calls["port"] == calls["jax"]
    # 2 ViT layers x (qkv, proj) [+ fc1, fc2 unfused] + 2 head products per
    # encoder; HuBERT's feature projection and 4 attention products a layer
    # [+ 2 unfused FFN]; DistilBERT's 6 a layer
    n_ffn = 2 * 2 * 2 if which == "xla" else 0
    assert len(calls["jax"]) == 2 * 2 + 2 + 1 + 2 * 4 + 2 + 2 * 6 + 2 + n_ffn


@pytest.mark.parametrize("which", ["xla", "fused"])
def test_int8_embeddings_match_jax_int8(which):
    cfg = small_model_config(visual_dropout_prob=0.0) if which == "xla" else _fused_config()
    model = _port_model(cfg, lora_seed=1)
    got = _port_out(model, _batch(), int8=True)
    want = _jax_out(cfg, model, _batch(), int8=True)
    for key in ("visual", "text"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-5,
                                   err_msg=key)
    g, w = got["audio"].numpy(), np.asarray(want["audio"])
    assert g.shape == w.shape
    cos = [_cos(a, b) for a, b in zip(g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1]))]
    assert min(cos) > 0.999 and np.mean(cos) > 0.9999, (min(cos), np.mean(cos))


def test_whole_model_int8_embeddings_close():
    model = _port_model(small_model_config(visual_dropout_prob=0.0))
    out_fp, out_q = _port_out(model, _batch(), False), _port_out(model, _batch(), True)
    for key in ("audio", "visual", "text"):
        c = _cos(out_fp[key].numpy(), out_q[key].numpy())
        assert c > 0.995, f"{key} embedding cosine {c}"


def test_int8_preserves_retrieval_ranks():
    """int8 must not change retrieval ordering: max-mean clip sims over a
    batch of 4, on a model whose LoRA adapters are nonzero (the LoRA
    branch folds them in)."""
    model = _port_model(small_model_config(visual_dropout_prob=0.0), lora_seed=2)
    batch = _batch(3, b=4)

    def clip_sims(out):
        a = out["audio"].numpy().astype(np.float32)
        v = out["visual"].numpy().astype(np.float32)
        a /= np.linalg.norm(a, axis=-1, keepdims=True) + 1e-12
        v /= np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12
        return np.einsum("qtd,csd->qcts", a, v).max(-1).mean(-1)

    s_fp = clip_sims(_port_out(model, batch, False))
    s_q = clip_sims(_port_out(model, batch, True))
    assert (s_fp.argsort(-1) == s_q.argsort(-1)).all()
    np.testing.assert_allclose(s_q, s_fp, atol=0.02)


def test_merged_qkv_raises_under_int8():
    """HuBERT's merged-qkv impls take raw weights: both packages raise
    rather than run them in float under the int8 mode."""
    from triad_tpu.models import TriadModel
    from triad_tpu.models.quantize import int8_interception as jax_int8
    from triad_tpu_torch.models.convert import torch_to_flax

    m = small_model_config()
    cfg = dataclasses.replace(m, hubert=dataclasses.replace(
        m.hubert, attention_impl="packed_merged", hidden_size=128, num_heads=2,
        intermediate_size=64))
    audio = (np.random.default_rng(0).normal(size=(1, 1600)) * 0.1).astype(np.float32)
    model = _port_model(cfg)
    with int8_interception(), pytest.raises(ValueError, match="bypasses the int8") as port_err:
        with torch.no_grad():
            model.encode_audio(torch.from_numpy(audio))
    assert not int8_active()
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    with jax_int8(), pytest.raises(ValueError) as jax_err:
        TriadModel(cfg).apply({"params": params}, jnp.asarray(audio),
                              method=TriadModel.encode_audio)
    assert str(port_err.value) == str(jax_err.value)


def test_int8_mode_stays_in_the_callers_thread():
    """The int8 flag is the caller's own: a Dense forward in another
    thread, run while the caller holds the context, stays float, and
    nesting the context restores the outer state on exit."""
    import threading

    from triad_tpu_torch.models.layers import Dense

    layer = Dense(16, 8)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32))
    with torch.no_grad():
        want_fp = layer(x)
        seen = {}
        with int8_interception():
            want_q = layer(x)
            worker = threading.Thread(
                target=lambda: seen.update(active=int8_active(), y=layer(x)))
            worker.start()
            worker.join()
            with int8_interception():
                pass
            assert int8_active()
        assert not int8_active()
    assert seen["active"] is False
    assert torch.equal(seen["y"], want_fp)
    assert not torch.equal(want_q, want_fp)
