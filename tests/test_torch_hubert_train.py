"""HuBERT's training path in the port against the JAX package, on the CPU,
at small sizes: the twins of the three new kernels (dropout + add +
LayerNorm, the positional grouped conv, and the dropout forms of the
training attention and the fused MLP), the frontend's recompute
backward, and HubertModel in training mode, plus SpecAugment and
layerdrop.

Inputs come from numpy with a seed. The JAX Pallas kernels run in
interpret mode; the port's wrappers run their plain twins (the tensors
lie on the CPU). At p > 0 the two sides take the same random numbers:
the port's keep mask (ops/dropout.py) goes to JAX as a numpy array, and
the JAX side is the XLA composition with that mask (the TPU kernels draw
from the core PRNG, which nothing reproduces). fp32 with TF32 off.

Tolerances, relative to the reference's largest magnitude:
  kernels' twins, HuBERT   1e-4: fp32 throughout, summation order only
                           (2e-4 for the posconv gradients, sums of
                           6144-term products in another order; 5e-6
                           absolute more for the key-projection bias,
                           whose gradient is zero up to rounding: softmax
                           does not see a per-row shift).
  frontend output          2e-2: both frontends round to bf16 between
                           layers, the port also its fp32 output; a
                           flipped rounding moves a value by one bf16
                           ulp (2^-8 of its magnitude) and the layers
                           after it spread that.
  frontend gradients       1e-4: both recompute the same fp32 composition
                           from the same inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from triad_tpu.core.config import HubertConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _close(got, ref, rel, name="", atol=0.0):
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(float(np.abs(ref).max()), 1e-30)
                               + atol, err_msg=name)


# ---------------------------------------------------------------------------
# dropout + add + LayerNorm (pallas_ln.fused_dropout_add_ln)
# ---------------------------------------------------------------------------


class TestDropoutAddLN:
    def _inputs(self, c=128):
        rng = np.random.default_rng(0)
        x, h, dy = (rng.normal(size=(2, 37, c)).astype(np.float32) for _ in range(3))
        scale = (rng.normal(size=c) * 0.3 + 1.0).astype(np.float32)
        bias = (rng.normal(size=c) * 0.1).astype(np.float32)
        return x, h, scale, bias, dy

    def _port(self, x, h, scale, bias, dy, p):
        from triad_tpu_torch.ops.layernorm import fused_dropout_add_ln

        leaves = [_t(a, grad=True) for a in (x, h, scale, bias)]
        y = fused_dropout_add_ln(*leaves, 7, p, 1e-5)
        y.backward(_t(dy))
        return y, [leaf.grad for leaf in leaves]

    def test_p0_matches_pallas(self):
        from triad_tpu.ops.pallas_ln import fused_dropout_add_ln

        x, h, scale, bias, dy = self._inputs()

        def f(x, h, scale, bias):
            return fused_dropout_add_ln(x, h, scale, bias, jnp.int32(0), 0.0, 1e-5)

        with pltpu.force_tpu_interpret_mode():
            ref, vjp = jax.vjp(f, x, h, scale, bias)
            refs = vjp(jnp.asarray(dy))
        y, grads = self._port(x, h, scale, bias, dy, 0.0)
        _close(y, ref, 1e-4, "y")
        for name, g, r in zip(("dx", "dh", "dscale", "dbias"), grads, refs):
            _close(g, r, 1e-4, name)

    def test_dropout_matches_masked_composition(self):
        from triad_tpu_torch.ops.layernorm import ln_keep

        x, h, scale, bias, dy = self._inputs()
        p = 0.1
        keep = ln_keep(2 * 37, 128, 7, p, "cpu").reshape(x.shape).numpy()
        assert 0.8 < keep.mean() < 0.97

        def f(x, h, scale, bias):
            s = x + jnp.where(keep, h * np.float32(1 / (1 - p)), 0.0)
            mean = jnp.mean(s, -1, keepdims=True)
            var = jnp.mean(jnp.square(s - mean), -1, keepdims=True)
            return (s - mean) * jax.lax.rsqrt(var + 1e-5) * scale + bias

        ref, vjp = jax.vjp(f, x, h, scale, bias)
        refs = vjp(jnp.asarray(dy))
        y, grads = self._port(x, h, scale, bias, dy, p)
        _close(y, ref, 1e-4, "y")
        for name, g, r in zip(("dx", "dh", "dscale", "dbias"), grads, refs):
            _close(g, r, 1e-4, name)
        # dropped positions pass no gradient to h
        assert float(grads[1].detach().numpy()[~keep].__abs__().max()) == 0.0


# ---------------------------------------------------------------------------
# positional grouped conv (pallas_posconv.pos_conv_gelu)
# ---------------------------------------------------------------------------


class TestPosConv:
    @pytest.mark.parametrize("b,n,c,g,k", [(2, 37, 64, 4, 16), (1, 24, 768, 16, 128)])
    def test_matches_pallas(self, b, n, c, g, k):
        """Values and gradients; (1, 24, 768, 16, 128) is HuBERT's group
        geometry (48 channels per group, K = 128) on a short N < K."""
        from triad_tpu.ops.pallas_posconv import pos_conv_gelu as jax_pos_conv_gelu
        from triad_tpu_torch.ops.posconv import pos_conv_gelu

        rng = np.random.default_rng(k)
        cpg = c // g
        x = (rng.normal(size=(b, n, c)) * 0.5).astype(np.float32)
        w = (rng.normal(size=(k, cpg, c)) * (1.0 / (k * cpg)) ** 0.5).astype(np.float32)
        bias = (rng.normal(size=c) * 0.1).astype(np.float32)
        dy = rng.normal(size=(b, n, c)).astype(np.float32)

        def f(x, w, bias):
            return jax_pos_conv_gelu(x, w, bias, g, "erf", True)

        ref, vjp = jax.vjp(f, x, w, bias)
        refs = vjp(jnp.asarray(dy))
        # torch's Conv1d layout: (C, C / g, K)
        leaves = [_t(x, True), _t(np.ascontiguousarray(w.transpose(2, 1, 0)), True), _t(bias, True)]
        y = pos_conv_gelu(*leaves, g)
        y.backward(_t(dy))
        _close(y, ref, 1e-4, "y")
        _close(leaves[0].grad, refs[0], 2e-4, "dx")
        _close(leaves[1].grad.numpy().transpose(2, 1, 0), refs[1], 2e-4, "dw")
        _close(leaves[2].grad, refs[2], 2e-4, "db")

    def test_primal_without_grad_equals_vjp_forward(self):
        """Without a gradient the GELU runs in the kernel's epilogue on the
        fp32 sum; with one it runs on z rounded to the input dtype (the
        VJP's saved pre-activation). In fp32 the two agree."""
        from triad_tpu_torch.ops.posconv import pos_conv_gelu

        rng = np.random.default_rng(3)
        x = _t(rng.normal(size=(2, 21, 64)).astype(np.float32))
        w = _t((rng.normal(size=(64, 16, 16)) * 0.06).astype(np.float32))
        bias = _t((rng.normal(size=64) * 0.1).astype(np.float32))
        with torch.no_grad():
            plain = pos_conv_gelu(x, w, bias, 4)
        vjp = pos_conv_gelu(x.clone().requires_grad_(), w, bias, 4)
        torch.testing.assert_close(vjp.detach(), plain, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# attention and MLP: dropout forms and HuBERT's unmasked N
# ---------------------------------------------------------------------------


def _attention_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, n, 128)).astype(np.float32) for _ in range(4)]


class TestAttentionDropout:
    def test_matches_masked_composition(self):
        """p = 0.1: _head_fwd / _head_bwd as an XLA composition with the
        port's mask, values and dq, dk, dv (no key mask, ragged N)."""
        from triad_tpu_torch.ops.attention import attention_keep, attention_train

        p, n = 0.1, 37
        q, k, v, do = _attention_inputs(n)
        keep = attention_keep(2, 2, n, n, 11, p, "cpu").numpy()

        def f(q, k, v):
            def heads(a):
                return a.reshape(2, n, 2, 64).transpose(0, 2, 1, 3)

            s = jnp.einsum("bhqd,bhkd->bhqk", heads(q), heads(k)) * 0.125
            probs = jax.nn.softmax(s, axis=-1)
            dropped = jnp.where(keep, probs * np.float32(1 / (1 - p)), 0.0)
            o = jnp.einsum("bhqk,bhkd->bhqd", dropped, heads(v))
            return o.transpose(0, 2, 1, 3).reshape(2, n, 128)

        ref, vjp = jax.vjp(f, q, k, v)
        refs = vjp(jnp.asarray(do))
        leaves = [_t(a, True) for a in (q, k, v)]
        out = attention_train(*leaves, None, 11, p, 0.125)
        out.backward(_t(do))
        _close(out, ref, 1e-4, "o")
        for name, leaf, r in zip(("dq", "dk", "dv"), leaves, refs):
            _close(leaf.grad, r, 1e-4, name)

    def test_unmasked_hubert_n_matches_pallas(self):
        """p = 0 against fused_attention_packed with an all-ones key mask,
        as HuBERT calls it (N = 49, not a multiple of 8)."""
        from triad_tpu.ops.pallas_attention import fused_attention_packed
        from triad_tpu_torch.ops.attention import attention_train

        n = 49
        q, k, v, do = _attention_inputs(n, 1)

        def f(q, k, v):
            return fused_attention_packed(q, k, v, jnp.ones((2, n), jnp.float32),
                                          jnp.zeros((), jnp.int32), 0.0, 0.125)

        with pltpu.force_tpu_interpret_mode():
            ref, vjp = jax.vjp(f, q, k, v)
            refs = vjp(jnp.asarray(do))
        leaves = [_t(a, True) for a in (q, k, v)]
        out = attention_train(*leaves)
        out.backward(_t(do))
        _close(out, ref, 1e-4, "o")
        for name, leaf, r in zip(("dq", "dk", "dv"), leaves, refs):
            _close(leaf.grad, r, 1e-4, name)


def _mlp_inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 13, 64)).astype(np.float32)
    w1 = (rng.normal(size=(64, 256)) / 8).astype(np.float32)
    b1 = (rng.normal(size=256) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(256, 64)) / 16).astype(np.float32)
    b2 = (rng.normal(size=64) * 0.1).astype(np.float32)
    dy = rng.normal(size=(2, 13, 64)).astype(np.float32)
    return x, w1, b1, w2, b2, dy


def _port_mlp(x, w1, b1, w2, b2, dy, form, seed, p):
    from triad_tpu_torch.ops.mlp import FusedMlp

    leaves = [_t(a, True) for a in (x, w1.T, b1, w2.T, b2)]  # torch's Linear layout
    y = FusedMlp.apply(*leaves, form, seed, p)
    y.backward(_t(dy))
    grads = [leaf.grad.numpy() for leaf in leaves]
    grads[1], grads[3] = grads[1].T, grads[3].T
    return y, grads


class TestMlpDropout:
    def test_matches_masked_composition(self):
        """p = 0.1, tanh GELU: fc1 -> GELU -> keep / (1 - p) -> fc2 as an XLA
        composition with the port's mask; y, dx, dW1, db1, dW2, db2."""
        from triad_tpu.ops.pallas_mlp import _gelu_tanh
        from triad_tpu_torch.ops.mlp import mlp_keep

        x, w1, b1, w2, b2, dy = _mlp_inputs()
        p = 0.1
        keep = mlp_keep(2 * 13, 256, 21, p, "cpu").reshape(2, 13, 256).numpy()

        def f(x, w1, b1, w2, b2):
            g = _gelu_tanh(x @ w1 + b1)
            return jnp.where(keep, g * np.float32(1 / (1 - p)), 0.0) @ w2 + b2

        ref, vjp = jax.vjp(f, x, w1, b1, w2, b2)
        refs = vjp(jnp.asarray(dy))
        y, grads = _port_mlp(x, w1, b1, w2, b2, dy, "tanh", 21, p)
        _close(y, ref, 1e-4, "y")
        for name, g, r in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, refs):
            _close(g, r, 1e-4, name)

    def test_p0_matches_pallas(self):
        from triad_tpu.ops.pallas_mlp import fused_mlp

        x, w1, b1, w2, b2, dy = _mlp_inputs(4)

        def f(x, w1, b1, w2, b2):
            return fused_mlp(x, w1, b1, w2, b2, jnp.zeros((), jnp.int32), 0.0, "tanh")

        with pltpu.force_tpu_interpret_mode():
            ref, vjp = jax.vjp(f, x, w1, b1, w2, b2)
            refs = vjp(jnp.asarray(dy))
        y, grads = _port_mlp(x, w1, b1, w2, b2, dy, "tanh", 0, 0.0)
        _close(y, ref, 1e-4, "y")
        for name, g, r in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, refs):
            _close(g, r, 1e-4, name)


# ---------------------------------------------------------------------------
# the frontend's recompute backward (pallas_frontend.monolithic_frontend_vjp)
# ---------------------------------------------------------------------------


def test_frontend_vjp_matches_pallas():
    from triad_tpu.ops.pallas_frontend import monolithic_frontend_vjp
    from triad_tpu_torch.ops.frontend import KERNELS, frontend_vjp

    rng = np.random.default_rng(5)
    wave = rng.normal(size=(2, 1600)).astype(np.float32)
    w0 = (rng.normal(size=(10, 1, 512)) * (2 / 10) ** 0.5).astype(np.float32)
    gs = (rng.normal(size=512) * 0.2 + 1.0).astype(np.float32)
    gb = (rng.normal(size=512) * 0.1).astype(np.float32)
    ws = [(rng.normal(size=(k, 512, 512)) * (2 / (k * 512)) ** 0.5).astype(np.float32)
          for k in KERNELS[1:]]

    def f(w0, gs, gb, ws):
        return monolithic_frontend_vjp(jnp.asarray(wave), w0, gs, gb, ws, 64, jnp.float32,
                                       "tanh", "x10")

    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(f, w0, gs, gb, ws)
    dy = rng.normal(size=ref.shape).astype(np.float32)
    refs = vjp(jnp.asarray(dy))
    # torch's Conv1d layout (Cout, Cin, k)
    leaves = [_t(np.ascontiguousarray(w0.transpose(2, 1, 0)), True), _t(gs, True), _t(gb, True)]
    wl = [_t(np.ascontiguousarray(w.transpose(2, 1, 0)), True) for w in ws]
    out = frontend_vjp(_t(wave), *leaves, wl, "tanh", torch.float32)
    out.backward(_t(dy))
    _close(out, ref, 2e-2, "out")
    _close(leaves[0].grad.numpy().transpose(2, 1, 0), refs[0], 1e-4, "dw0")
    _close(leaves[1].grad, refs[1], 1e-4, "dscale")
    _close(leaves[2].grad, refs[2], 1e-4, "dbias")
    for i, (leaf, r) in enumerate(zip(wl, refs[3])):
        _close(leaf.grad.numpy().transpose(2, 1, 0), r, 1e-4, f"dw{i + 1}")


# ---------------------------------------------------------------------------
# HubertModel in training mode
# ---------------------------------------------------------------------------


def hubert_train_config(**kw):
    """2 layers, hidden 128, 2 heads of 64, intermediate 256, posconv K = 16
    with 4 groups, a 2-layer conv frontend; the training kernels forced
    and every rate at 0."""
    base = dict(
        hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
        conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2),
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        attention_impl="fused_packed", mlp_impl="fused", mlp_gelu="tanh", ln_impl="fused",
        posconv_impl="pallas", frontend_impl="conv",
        hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0, layerdrop=0.0,
        apply_spec_augment=False,
    )
    base.update(kw)
    return HubertConfig(**base)


def _port_hubert(cfg, seed=0):
    from triad_tpu_torch.config import HubertConfig as PortHubertConfig
    from triad_tpu_torch.models.hubert import HubertModel

    model = HubertModel(PortHubertConfig(**dataclasses.asdict(cfg)))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1 + (1.0 if "norm" in name else 0.0))
    return model


def _train_args(seed=1, step=0):
    from triad_tpu_torch.ops.dropout import HostSeeds

    return torch.Generator().manual_seed(seed), HostSeeds(seed, step)


def test_hubert_training_matches_jax():
    """Training mode, every rate 0, the fused impls forced: the output and
    every parameter's gradient against JAX HubertModel(deterministic=False)
    with its Pallas kernels in interpret mode."""
    from triad_tpu.models.hubert import HubertModel as JaxHubert
    from triad_tpu_torch.models.convert import torch_to_flax

    cfg = hubert_train_config()
    model = _port_hubert(cfg)
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    rng = np.random.default_rng(6)
    audio = rng.normal(size=(2, 1000)).astype(np.float32)
    r = None

    def f(params):
        return JaxHubert(cfg).apply({"params": params}, jnp.asarray(audio), False,
                                    rngs={"dropout": jax.random.key(0)})

    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(f, params)
        r = rng.normal(size=ref.shape).astype(np.float32)
        (gref,) = vjp(jnp.asarray(r))
    out = model(_t(audio), *_train_args())
    out.backward(_t(r))
    _close(out, ref, 1e-4, "hidden")
    n = 0
    for name, p in model.named_parameters():
        tree = torch_to_flax({name: p.grad if p.grad is not None else torch.zeros_like(p)})
        got, want = tree, gref
        while isinstance(got, dict):
            key = next(iter(got))
            got, want = got[key], want[key]
        _close(got, want, 1e-4, name, atol=5e-6)
        n += p.grad is not None
    assert n == len(list(model.parameters())) - 1  # all but the unused masked_spec_embed


def test_hubert_live_dropout_is_seeded():
    """Live rates on the CPU (plain dropouts, the kernels' twins): the same
    (generator, seeds) give the same output, another seed another one,
    and eval differs from training."""
    cfg = hubert_train_config(hidden_dropout=0.1, activation_dropout=0.1,
                              attention_dropout=0.1, apply_spec_augment=True)
    model = _port_hubert(cfg)
    audio = _t(np.random.default_rng(7).normal(size=(2, 1000)).astype(np.float32))
    with torch.no_grad():
        a, b, c = (model(audio, *_train_args(s)) for s in (1, 1, 2))
        ev = model(audio)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a, ev)


class TestSpecAugment:
    def test_spans(self):
        """Masked steps come in spans of 10 (overlaps only lengthen a
        run), every row has at least min_masks = 2 spans' worth of
        start draws active, and masked rows equal the embedding."""
        from triad_tpu_torch.models.hubert import spec_augment_time_mask

        b, t, d = 64, 499, 8
        x = torch.zeros(b, t, d)
        embed = torch.arange(1, d + 1, dtype=torch.float32)
        y = spec_augment_time_mask(x, embed, torch.Generator().manual_seed(0), 0.05, 10, 2)
        masked = (y != 0).any(-1)
        assert torch.equal(y[masked], embed.expand(int(masked.sum()), d))
        counts = masked.sum(-1)
        assert int(counts.min()) >= 10
        for row in masked:
            runs, run = [], 0
            for m in row.tolist() + [False]:
                if m:
                    run += 1
                elif run:
                    runs.append(run)
                    run = 0
            assert runs and min(runs) >= 10
        # mean spans: 0.05 * 499 / 10 = 2.495 -> 2 or 3 spans per row
        assert 10 <= float(counts.float().mean()) <= 30

    def test_min_masks(self):
        """mask_prob 1e-3 gives floor(0.05 + U) = 0 spans: min_masks = 2
        spans of 10 each, so 10 to 20 masked steps per row (overlap)."""
        from triad_tpu_torch.models.hubert import spec_augment_time_mask

        x = torch.zeros(256, 499, 1)
        y = spec_augment_time_mask(x, torch.ones(1), torch.Generator().manual_seed(1), 1e-3, 10, 2)
        counts = (y[..., 0] != 0).sum(-1)
        assert int(counts.min()) >= 10 and int(counts.max()) <= 20
        assert float((counts == 20).float().mean()) > 0.9  # two disjoint spans mostly


def test_layerdrop_rate_and_skip():
    """layerdrop 1 skips every layer (the output is the encoder LayerNorm's);
    layerdrop 0.5 runs each layer in about half the steps."""
    model = _port_hubert(hubert_train_config(num_layers=2, layerdrop=1.0))
    audio = _t(np.random.default_rng(8).normal(size=(1, 400)).astype(np.float32))
    runs = []
    for layer in model.layers:
        layer.register_forward_hook(lambda *_: runs.append(1))
    with torch.no_grad():
        out = model(audio, *_train_args())
        x = model.feature_projection(model.feature_projection_norm(model.feature_extractor(audio)))
        torch.testing.assert_close(out, model.encoder_layer_norm(x + model.pos_conv_embed(x)))
    assert not runs
    model.cfg = dataclasses.replace(model.cfg, layerdrop=0.5)
    with torch.no_grad():
        for step in range(100):
            model(audio, *_train_args(3, step))
    n = 2 * 100
    assert abs(len(runs) / n - 0.5) < 4 * (0.25 / n) ** 0.5
