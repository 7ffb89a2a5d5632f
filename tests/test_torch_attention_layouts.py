"""The strided and merged layouts of the port's training attention against
the JAX package, on the CPU, at small sizes: the plain twins against
``fused_attention`` (strided (B, H, T, D)) and ``fused_attention_packed_merged``
(one (B, N, 3C) qkv tensor) at p = 0 in interpret mode, and at p = 0.1
against an XLA composition fed the port's keep mask (the TPU kernels draw
from the core PRNG, which nothing reproduces); the three layouts against
each other at one seed; and the encoders that route to them (HuBERT's
"fused" and "fused_packed_merged", the ViT's "fused" and
"fused_packed_merged", DistilBERT's "fused" with its key mask) in training
mode against the JAX modules on shared parameters, every rate at 0.

Inputs come from numpy with a seed; the port's wrappers run their plain
twins (the tensors lie on the CPU). fp32 with TF32 off.

Tolerances, relative to the reference's largest magnitude: 1e-4, fp32
throughout and summation order only (plus 5e-6 absolute for leaves whose
gradient is zero up to rounding, as the key-projection bias: softmax does
not see a per-row shift). The three layouts agree bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, N, H = 2, 37, 2  # ragged N, 2 heads of 64


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _close(got, ref, rel, name="", atol=0.0):
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(float(np.abs(ref).max()), 1e-30)
                               + atol, err_msg=name)


def _inputs(seed=0):
    """qkv (B, N, 3 * H * 64), dO (B, N, H * 64) and a key mask with a
    masked key and a ragged tail."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, N, 3 * H * 64)).astype(np.float32)
    do = rng.normal(size=(B, N, H * 64)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[0, 3] = 0.0
    mask[1, 25:] = 0.0
    return qkv, do, mask


def _heads(a):
    """(B, N, H * 64) -> (B, H, N, 64)."""
    return np.ascontiguousarray(a.reshape(B, N, H, 64).transpose(0, 2, 1, 3))


class TestAgainstPallas:
    def test_strided_matches_fused_attention(self):
        from triad_tpu.ops.pallas_attention import fused_attention
        from triad_tpu_torch.ops.attention import attention_train_strided

        qkv, do, mask = _inputs()
        q, k, v = (_heads(a) for a in np.split(qkv, 3, axis=-1))

        def f(q, k, v):
            return fused_attention(q, k, v, jnp.asarray(mask), jnp.zeros((), jnp.int32), 0.0,
                                   0.125)

        with pltpu.force_tpu_interpret_mode():
            ref, vjp = jax.vjp(f, q, k, v)
            refs = vjp(jnp.asarray(_heads(do)))
        leaves = [_t(a, True) for a in (q, k, v)]
        out = attention_train_strided(*leaves, _t(mask), 0, 0.0, 0.125)
        out.backward(_t(_heads(do)))
        _close(out, ref, 1e-4, "o")
        for name, leaf, r in zip(("dq", "dk", "dv"), leaves, refs):
            _close(leaf.grad, r, 1e-4, name)

    def test_merged_matches_fused_attention_packed_merged(self):
        from triad_tpu.ops.pallas_attention import fused_attention_packed_merged
        from triad_tpu_torch.ops.attention import attention_train_merged

        qkv, do, mask = _inputs(1)

        def f(qkv):
            return fused_attention_packed_merged(qkv, jnp.asarray(mask), jnp.zeros((), jnp.int32),
                                                 0.0, 0.125)

        with pltpu.force_tpu_interpret_mode():
            ref, vjp = jax.vjp(f, qkv)
            (dref,) = vjp(jnp.asarray(do))
        leaf = _t(qkv, True)
        out = attention_train_merged(leaf, _t(mask), 0, 0.0, 0.125)
        out.backward(_t(do))
        _close(out, ref, 1e-4, "o")
        _close(leaf.grad, dref, 1e-4, "dqkv")


def _masked_composition(keep, mask, p):
    """_head_fwd as an XLA composition on (B, H, N, 64) operands with the
    port's keep mask and the kernels' -1e30 key bias."""
    bias = jnp.asarray((1.0 - mask) * -1e30)[:, None, None, :]

    def f(q, k, v):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * 0.125 + bias
        probs = jax.nn.softmax(s, axis=-1)
        dropped = jnp.where(keep, probs * np.float32(1 / (1 - p)), 0.0)
        return jnp.einsum("bhqk,bhkd->bhqd", dropped, v)

    return f


class TestDropout:
    P, SEED = 0.1, 11

    def _reference(self, seed):
        from triad_tpu_torch.ops.attention import attention_keep

        qkv, do, mask = _inputs(seed)
        q, k, v = (_heads(a) for a in np.split(qkv, 3, axis=-1))
        keep = attention_keep(B, H, N, N, self.SEED, self.P, "cpu").numpy()
        ref, vjp = jax.vjp(_masked_composition(keep, mask, self.P), q, k, v)
        return qkv, do, mask, ref, vjp(jnp.asarray(_heads(do)))

    def test_strided_matches_masked_composition(self):
        from triad_tpu_torch.ops.attention import attention_train_strided

        qkv, do, mask, ref, refs = self._reference(2)
        leaves = [_t(_heads(a), True) for a in np.split(qkv, 3, axis=-1)]
        out = attention_train_strided(*leaves, _t(mask), self.SEED, self.P, 0.125)
        out.backward(_t(_heads(do)))
        _close(out, ref, 1e-4, "o")
        for name, leaf, r in zip(("dq", "dk", "dv"), leaves, refs):
            _close(leaf.grad, r, 1e-4, name)

    def test_merged_matches_masked_composition(self):
        from triad_tpu_torch.ops.attention import attention_train_merged

        qkv, do, mask, ref, refs = self._reference(3)
        leaf = _t(qkv, True)
        out = attention_train_merged(leaf, _t(mask), self.SEED, self.P, 0.125)
        out.backward(_t(do))
        packed = lambda a: np.asarray(a).transpose(0, 2, 1, 3).reshape(B, N, H * 64)  # noqa: E731
        _close(out, packed(ref), 1e-4, "o")
        _close(leaf.grad, np.concatenate([packed(r) for r in refs], axis=-1), 1e-4, "dqkv")

    def test_three_layouts_agree(self):
        """strided == packed == merged at one seed, values and gradients,
        bit for bit (one keep mask, one math)."""
        from triad_tpu_torch.ops.attention import (
            attention_train,
            attention_train_merged,
            attention_train_strided,
        )

        qkv, do, mask = _inputs(4)
        merged = _t(qkv, True)
        packed = [_t(a, True) for a in np.split(qkv, 3, axis=-1)]
        strided = [_t(_heads(a), True) for a in np.split(qkv, 3, axis=-1)]
        outs = [
            attention_train_merged(merged, _t(mask), self.SEED, self.P),
            attention_train(*packed, _t(mask), self.SEED, self.P),
            attention_train_strided(*strided, _t(mask), self.SEED, self.P).transpose(1, 2)
            .reshape(B, N, H * 64),
        ]
        for out in outs:
            out.backward(_t(do))
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
        grads_packed = torch.cat([x.grad for x in packed], dim=-1)
        grads_strided = torch.cat([x.grad.transpose(1, 2).reshape(B, N, H * 64)
                                   for x in strided], dim=-1)
        assert torch.equal(merged.grad, grads_packed) and torch.equal(merged.grad, grads_strided)

    def test_kernel_wrappers_take_the_twins_arguments(self):
        """Each kernel wrapper (forward and backward, packed, strided and
        merged) given CPU tensors returns its plain twin's values bit for
        bit: the wrappers pass their arguments through in the twins' order.
        A forward on the CPU saves nothing for the backward."""
        from triad_tpu_torch.ops import attention as A

        qkv, do, mask = (_t(a) for a in _inputs(5))
        q, k, v = qkv.chunk(3, dim=-1)
        hq, hk, hv, hdo = (x.unflatten(-1, (H, 64)).transpose(1, 2) for x in (q, k, v, do))
        args = (0.125, self.SEED, self.P)
        forwards = [A.attention_train_fwd(q, k, v, mask, *args),
                    A.attention_train_strided_fwd(hq, hk, hv, mask, *args),
                    A.attention_train_merged_fwd(qkv, mask, *args)]
        assert all(saved is None for _, saved in forwards)
        pairs = [
            (forwards[0][0], A.attention_train_plain(q, k, v, mask, *args)),
            (A.attention_train_bwd(q, k, v, mask, do, *args),
             A.attention_train_bwd_plain(q, k, v, mask, do, *args)),
            (forwards[1][0], A.heads_train_plain(hq, hk, hv, mask, *args)),
            (A.attention_train_strided_bwd(hq, hk, hv, mask, hdo, *args),
             A.heads_train_bwd_plain(hq, hk, hv, mask, hdo, *args)),
            (forwards[2][0], A.attention_train_merged_plain(qkv, mask, *args)),
            (A.attention_train_merged_bwd(qkv, mask, do, *args),
             A.attention_train_merged_bwd_plain(qkv, mask, do, *args)),
        ]
        for got, ref in pairs:
            got, ref = ((x,) if isinstance(x, torch.Tensor) else x for x in (got, ref))
            assert len(got) == len(ref)
            assert all(torch.equal(a, b) for a, b in zip(got, ref))


# ---------------------------------------------------------------------------
# The encoders in training mode against the JAX modules
# ---------------------------------------------------------------------------


def _encoder_config(section, impl):
    """The narrow fp32 TriadModel of tests/test_torch_models.py, one layer
    per encoder and a 2-layer conv frontend, with the training attention
    impl set in one encoder and every rate at 0 (the interpret mode has no
    TPU PRNG)."""
    from tests.test_torch_models import narrow_perf_config

    cfg = narrow_perf_config("float32")
    vit = dataclasses.replace(cfg.vit, attention_impl="xla", mlp_impl="xla", num_layers=1)
    hubert = dataclasses.replace(
        cfg.hubert, attention_impl="xla", mlp_impl="xla", frontend_impl="conv",
        posconv_impl="conv", ln_impl="xla", hidden_dropout=0.0, activation_dropout=0.0,
        attention_dropout=0.0, layerdrop=0.0, apply_spec_augment=False, num_layers=1,
        conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2))
    text = dataclasses.replace(cfg.text, attention_impl="xla", dropout=0.0,
                               attention_dropout=0.0, num_layers=1)
    subs = {"vit": vit, "hubert": hubert, "text": text}
    subs[section] = dataclasses.replace(subs[section], attention_impl=impl)
    return dataclasses.replace(cfg, visual_dropout_prob=0.0, **subs)


@pytest.mark.parametrize("section,impl", [
    ("hubert", "fused"), ("hubert", "fused_packed_merged"), ("vit", "fused"),
    ("vit", "fused_packed_merged"), ("text", "fused"),
])
def test_encoder_training_matches_jax(section, impl):
    """encode_audio / encode_visual / encode_text in training mode: the
    features and every gradient the port forms (the ViT base is frozen in
    the port) against the JAX TriadModel's with its Pallas kernels in
    interpret mode; HuBERT's merged gradients land on q_proj, k_proj and
    v_proj."""
    from triad_tpu.models import TriadModel as JaxTriad
    from triad_tpu_torch.models.convert import init_triad_model, torch_to_flax
    from triad_tpu_torch.ops.dropout import HostSeeds

    cfg = _encoder_config(section, impl)
    model = init_triad_model(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    rng = np.random.default_rng(5)
    mask = np.ones((2, 10), np.float32)
    mask[1, 6:] = 0.0
    args = {
        "vit": (rng.normal(size=(2, 28, 28, 3)).astype(np.float32),),
        "hubert": ((rng.normal(size=(2, 1000)) * 0.1).astype(np.float32),),
        "text": (rng.integers(1, 100, size=(2, 10)).astype(np.int32), mask),
    }[section]
    method = {"vit": "encode_visual", "hubert": "encode_audio", "text": "encode_text"}[section]

    targs = [torch.from_numpy(a) for a in args]
    extra = (HostSeeds(1, 0),) if section in ("hubert", "text") else ()
    out = getattr(model, method)(*targs, True, torch.Generator().manual_seed(1), *extra)
    r = rng.normal(size=out.shape).astype(np.float32)
    out.backward(_t(r))

    @jax.jit
    def features_and_vjp(params, r):
        def f(params):
            return JaxTriad(cfg).apply({"params": params}, *map(jnp.asarray, args), True,
                                       method=method, rngs={"dropout": jax.random.key(0)})

        ref, vjp = jax.vjp(f, params)
        return ref, vjp(r)[0]

    with pltpu.force_tpu_interpret_mode():
        ref, gref = features_and_vjp(params, jnp.asarray(r))
    _close(out, ref, 1e-4, "features")
    prefix = {"vit": "visual_", "hubert": "audio_", "text": "text_"}[section]
    seen = set()
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        seen.add(name)
        got, want = torch_to_flax({name: p.grad}), gref  # the JAX layout of the leaf
        while isinstance(got, dict):
            key = next(iter(got))
            got, want = got[key], want[key]
        _close(got, want, 1e-4, name, atol=5e-6)
    assert any(n.startswith(prefix) for n in seen)
    if section == "hubert":
        for proj in ("q_proj", "k_proj", "v_proj"):
            assert f"audio_backbone.layers.0.attention.{proj}.weight" in seen, proj
