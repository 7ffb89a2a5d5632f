"""HuBERT's remat policies in the port against the JAX package, on the CPU:
the two-pass chunked frontend ("chunked_conv", the default) on the
"conv", "matmul" and "conv_act" frontends, "conv" (the whole frontend
checkpointed) and "full" (each encoder layer too), and "full" in training
with every dropout live against "none".

The model: HuBERT-base's seven-conv frontend (kernels 10, 3, 3, 3, 3, 2,
2, strides 5, 2, ...: 64 samples of conv_0 a token, a receptive window
of 79) at 32 channels, 2 layers of hidden 32. A 0.5 s clip (8000 samples,
24 tokens) at ``frontend_chunk_tokens`` 5: pass A runs 5 chunks of conv_0
(320, 320, 320, 320, 319 steps), pass B 5 blocks (5, 5, 5, 5, 4 tokens),
so both passes take several chunks and a short last one. Parameters are
drawn from a seed and carried to JAX by ``models/convert.py``. fp32, TF32
off.

Tolerances: the output within 1e-5 of the reference's largest magnitude,
each parameter gradient (conv_0 and the GroupNorm included) within 1e-4
of its largest magnitude plus 1e-6 (fp32; only the order of sums
differs), the key-projection biases, whose gradient is 0 up to rounding,
plus 5e-6. JAX cannot differentiate its chunked "conv_act" on the CPU
(interpret-mode Pallas does not partial-eval under jax.checkpoint,
tests/test_encoders.py), so the port's chunked "conv_act" is held to
JAX's chunked "conv", which computes the same function. "full" with live
dropout (plain dropouts from the generator, and the dropout kernels'
twins from the host seeds) gives gradients bit-equal to "none".
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triad_tpu.core.config import HubertConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KERNELS, STRIDES = (10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2)
SAMPLES, CHUNK = 8000, 5


def _config(impl="conv", remat="chunked_conv", **kw):
    return HubertConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                        conv_dim=(32,) * 7, conv_kernel=KERNELS, conv_stride=STRIDES,
                        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                        frontend_impl=impl, remat=remat, frontend_chunk_tokens=CHUNK, **kw)


def _port(cfg):
    from triad_tpu_torch.config import HubertConfig as PortHubertConfig
    from triad_tpu_torch.models.hubert import HubertModel

    model = HubertModel(PortHubertConfig(**dataclasses.asdict(cfg)))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1
                        + (1.0 if "norm" in name else 0.0))
    return model


def _inputs(cfg, b=2):
    rng = np.random.default_rng(7)
    audio = rng.normal(size=(b, SAMPLES)).astype(np.float32)
    r = rng.normal(size=(b, cfg.num_audio_tokens(SAMPLES), cfg.hidden_size)).astype(np.float32)
    return audio, r


def _jax_out_and_grads(cfg, model, audio, r):
    from triad_tpu.models.hubert import HubertModel as JaxHubert
    from triad_tpu_torch.models.convert import torch_to_flax

    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))

    def f(p):
        out = JaxHubert(cfg).apply({"params": p}, jnp.asarray(audio))
        return jnp.sum(out * r), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return np.asarray(out), grads


def _hold(model, out, ref_out, ref_grads):
    from triad_tpu_torch.models.convert import torch_to_flax

    got = out.detach().numpy()
    assert got.shape == ref_out.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref_out, rtol=0, atol=1e-5 * float(np.abs(ref_out).max()))
    checked = []
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        g, want = torch_to_flax({name: p.grad}), ref_grads
        while isinstance(g, dict):
            key = next(iter(g))
            g, want = g[key], want[key]
        want = np.asarray(want)
        # the key-projection bias's gradient is 0 up to rounding (softmax
        # does not see a per-row shift): 5e-6 absolute, as
        # tests/test_torch_frontend_conv.py holds it
        floor = 5e-6 if name.endswith("k_proj.bias") else 1e-6
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-4 * np.abs(want).max() + floor,
                                   err_msg=name)
        checked.append(name)
    assert len(checked) == len(list(model.parameters())) - 1  # all but masked_spec_embed
    assert "feature_extractor.convs.0.weight" in checked
    assert "feature_extractor.group_norm.weight" in checked


def _count_calls(monkeypatch, name):
    from triad_tpu_torch.models.hubert import ConvFeatureEncoder

    calls = []
    fn = getattr(ConvFeatureEncoder, name)

    def counted(self, *args):
        calls.append(args[0].shape[-1])
        return fn(self, *args)

    monkeypatch.setattr(ConvFeatureEncoder, name, counted)
    return calls


def test_chunk_geometry():
    """HuBERT-base's tail: stride 64, receptive window 79, 499 tokens in
    160000 samples (hubert.py:840-848); this file's clip: 24 tokens."""
    from triad_tpu_torch.config import HubertConfig as PortHubertConfig

    base = PortHubertConfig()
    assert base.num_audio_tokens(160_000) == 499
    assert _config().num_audio_tokens(SAMPLES) == 24


@pytest.mark.parametrize("impl,ref_impl", [("conv", "conv"), ("matmul", "matmul"),
                                           ("conv_act", "conv")])
def test_chunked_frontend_matches_jax(impl, ref_impl, monkeypatch):
    """The chunked frontend of ``impl``: the model's output and every
    parameter gradient of <out, r> against JAX's chunked ``ref_impl``.
    Pass A reads 5 waveform chunks, the last one short; pass B 5 blocks,
    the last of 4 tokens; each runs again in the backward."""
    cfg = _config(impl)
    model = _port(cfg)
    audio, r = _inputs(cfg)
    ref_out, ref_grads = _jax_out_and_grads(_config(ref_impl), model, audio, r)
    sums, blocks = _count_calls(monkeypatch, "_sums"), _count_calls(monkeypatch, "_block")
    out = model(torch.from_numpy(audio))
    # conv_0 steps of each chunk: ((samples - 10) // 5 + 1 of 1599, cut in 320s)
    assert [(t - 10) // 5 + 1 for t in sums] == [320, 320, 320, 320, 319]
    assert len(blocks) == 5
    out.backward(torch.from_numpy(r))
    assert len(sums) == 10 and len(blocks) == 10  # each recomputed in the backward
    _hold(model, out, ref_out, ref_grads)


def test_chunked_eval_is_not_checkpointed(monkeypatch):
    """Without autograd the chunks run once each, as plain calls, and
    give the whole frontend's output (JAX keeps the chunked route at eval
    too, hubert.py:903-908)."""
    cfg = _config()
    model = _port(cfg)
    audio = torch.from_numpy(_inputs(cfg)[0])
    blocks = _count_calls(monkeypatch, "_block")
    with torch.no_grad():
        got = model(audio)
        model.cfg = model.feature_extractor.cfg = dataclasses.replace(model.cfg, remat="none")
        whole = model(audio)
    assert len(blocks) == 5
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                               atol=1e-5 * float(whole.abs().max()))


@pytest.mark.parametrize("remat", ["conv", "full", "none"])
def test_remat_policies_match_jax(remat):
    """remat "conv" (the whole frontend under one checkpoint), "full" (and
    each layer) and "none" against JAX at the same policy."""
    cfg = _config(remat=remat)
    model = _port(cfg)
    audio, r = _inputs(cfg)
    ref_out, ref_grads = _jax_out_and_grads(cfg, model, audio, r)
    out = model(torch.from_numpy(audio))
    out.backward(torch.from_numpy(r))
    _hold(model, out, ref_out, ref_grads)


def _live(kernels):
    """Every dropout live, SpecAugment and layerdrop included; with
    ``kernels`` the dropout kernels' twins (strided training attention,
    fused MLP, dropout + add + LayerNorm; heads of 64) draw from the host
    seeds, else the plain dropouts from the generator."""
    kw = dict(hidden_dropout=0.1, activation_dropout=0.1, attention_dropout=0.1,
              feat_proj_dropout=0.1, layerdrop=0.3, mask_time_prob=0.2, mask_time_length=2)
    if kernels:
        kw.update(hidden_size=128, num_heads=2, intermediate_size=256, attention_impl="fused",
                  mlp_impl="fused", ln_impl="fused")
    return lambda remat: dataclasses.replace(_config(remat=remat), **kw)


def _train_grads(cfg, remat_layer=None):
    """One training forward and backward at HostSeeds(5, 3) and a seeded
    generator; every parameter's gradient."""
    from triad_tpu_torch.ops.dropout import HostSeeds

    model = _port(cfg)
    if remat_layer is not None:
        for layer in model.layers:
            layer.forward = remat_layer(layer.forward)
    audio, r = _inputs(cfg)
    out = model(torch.from_numpy(audio), torch.Generator().manual_seed(11), HostSeeds(5, 3))
    out.backward(torch.from_numpy(r))
    return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("kernels", [False, True], ids=["plain_dropouts", "dropout_kernels"])
def test_full_remat_replays_dropout(kernels):
    """remat "full" in training with every dropout live: each layer's
    recompute draws the masks its forward drew, so every gradient is
    bit-equal to the step at "none". A checkpoint that does not replay
    them (the same layers under torch.utils.checkpoint alone) draws
    others in the recompute and changes the gradients."""
    from torch.utils.checkpoint import checkpoint

    cfg = _live(kernels)
    none, full = _train_grads(cfg("none")), _train_grads(cfg("full"))
    assert set(none) == set(full) and len(none) > 20
    for name in none:
        assert torch.equal(none[name], full[name]), name

    def plain(fwd):
        return lambda x, g, s: checkpoint(fwd, x, g, s, use_reentrant=False)

    naive = _train_grads(cfg("none"), plain)
    assert any(not torch.equal(none[n], naive[n]) for n in none if "layers." in n)
