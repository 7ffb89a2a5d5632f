"""The "flash" attention route of the port against the JAX package, on the
CPU, at small sizes: ``ops.flash_attention.flash_attention`` (its plain
twins here: the tensors lie on the CPU) against
``triad_tpu.models.layers.flash_dot_product_attention`` (JAX's library
Pallas kernel in interpret mode, behind the adapter that pads N to a
multiple of 128), forward and ``jax.vjp`` gradients; then the three
encoders on "flash" at eval, and in training mode with every rate at 0
(the gradients through the flash backward, the ViT's LoRA factors
included) against the JAX modules on shared parameters; and the encoders
whose live attention dropout sends "flash" to the plain attention, as the
JAX dispatch does.

Inputs come from numpy with a seed. Tolerances, relative to the
reference's largest magnitude:
- bf16 kernel-level: one bf16 ulp (2^-7). Both sides round the same fp32
  values at the same points (the twin walks the library's own 512-key
  blocks); what differs is the order of the fp32 sums and the last bit of
  exp, which can flip a bf16 rounding of P, dS or the output.
- fp32 kernel-level: 1e-5 (summation order only).
- encoders: 1e-4, fp32 throughout (as tests/test_torch_attention_layouts.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_attention_layouts import _encoder_config
from tests.test_torch_attention_layouts import \
    test_encoder_training_matches_jax as _training_matches_jax
from tests.test_torch_pair_attention import _close, build_models, pair_model_config

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BF16_ULP = 2.0 ** -7


def _inputs(b, n, h, mask_kind, seed):
    """q, k, v, dO as (B, N, H, 64) fp32 and a (B, N) bool key mask: "keys"
    masks the back half of row 0, "all" also every key of the last row."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, n, h, 64)).astype(np.float32) for _ in range(4))
    valid = np.ones((b, n), bool)
    if mask_kind in ("keys", "all"):
        valid[0, n // 2:] = False
    if mask_kind == "all":
        valid[-1] = False
    return q, k, v, do, valid


def _jax_flash(q, k, v, do, valid, masked, dtype):
    """(out, dq, dk, dv) of flash_dot_product_attention, (B, N, H, 64) fp32."""
    from triad_tpu.models.layers import flash_dot_product_attention

    mask = jnp.asarray(valid)[:, None, None, :] if masked else None

    def f(q, k, v):
        return flash_dot_product_attention(q, k, v, mask, dtype)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
        grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in (out, *grads)]


def _port_flash(q, k, v, do, valid, masked, dtype):
    """The same through the port's flash_attention on the (B, H, N, 64)
    views and its autograd backward."""
    from triad_tpu_torch.ops.flash_attention import flash_attention

    tq, tk, tv = (torch.from_numpy(x).to(dtype).transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    out = flash_attention(tq, tk, tv, torch.from_numpy(valid) if masked else None)
    out.backward(torch.from_numpy(do).to(dtype).transpose(1, 2))
    return [x.detach().transpose(1, 2).float().numpy() for x in (out, tq.grad, tk.grad, tv.grad)]


def _assert_close(got, ref, rel):
    for name, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
        assert g.shape == r.shape and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=0, atol=rel * float(np.abs(r).max()),
                                   err_msg=name)


@pytest.mark.parametrize("mask_kind", ["none", "keys", "all"])
@pytest.mark.parametrize("n", [37, 128, 261, 1000])
def test_twin_matches_library_bf16(n, mask_kind):
    """Forward and gradients in bf16 at ragged N (37 -> 128, 261 -> 384),
    an exact 128, and N = 1000 (two 512-key blocks: the online rescale);
    masked keys and a row whose keys are all masked."""
    b, h = (2, 2) if n < 1000 else (2, 1)
    q, k, v, do, valid = _inputs(b, n, h, mask_kind, seed=n)
    masked = mask_kind != "none"
    ref = _jax_flash(q, k, v, do, valid, masked, jnp.bfloat16)
    got = _port_flash(q, k, v, do, valid, masked, torch.bfloat16)
    _assert_close(got, ref, BF16_ULP)


@pytest.mark.parametrize("n", [37, 1000])
def test_twin_matches_library_fp32(n):
    """fp32 (no rounding of P or dS), an all-masked row."""
    q, k, v, do, valid = _inputs(2, n, 1, "all", seed=n + 1)
    ref = _jax_flash(q, k, v, do, valid, True, jnp.float32)
    got = _port_flash(q, k, v, do, valid, True, torch.float32)
    _assert_close(got, ref, 1e-5)


def test_all_masked_row_averages_over_padded_keys():
    """A row whose keys are all masked is uniform over the 128-padded key
    count (the padded keys carry zero v): sum(v) / 128 at N = 40."""
    from triad_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, _, valid = _inputs(2, 40, 1, "all", seed=3)
    out = flash_attention(*(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)),
                          torch.from_numpy(valid))
    want = v[-1, :, 0].sum(axis=0) / 128
    np.testing.assert_allclose(out[-1, 0].numpy(), np.broadcast_to(want, (40, 64)), atol=1e-6)


def test_lengths_the_reference_refuses_raise():
    """N = 600 pads to 640, which the adapter's 512-row blocks do not divide:
    the JAX function fails, and the port raises a ValueError (CPU and card
    alike) instead of computing a case the reference lacks."""
    from triad_tpu.models.layers import flash_dot_product_attention
    from triad_tpu_torch.ops.flash_attention import flash_attention

    x = np.zeros((1, 600, 1, 64), np.float32)
    with pytest.raises(Exception):
        with pltpu.force_tpu_interpret_mode():
            flash_dot_product_attention(*(jnp.asarray(x),) * 3, None, jnp.float32)
    with pytest.raises(ValueError, match="600"):
        flash_attention(*(torch.from_numpy(x).transpose(1, 2),) * 3)
    m = torch.empty((1, 1, 600, 64), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="600"):
        flash_attention(m, m, m)


def flash_model_config():
    """pair_model_config() (hidden 192 in 3 heads of 64, 2 layers, fp32)
    with "flash" in all three encoders."""
    cfg = pair_model_config()
    return dataclasses.replace(
        cfg,
        vit=dataclasses.replace(cfg.vit, attention_impl="flash"),
        hubert=dataclasses.replace(cfg.hubert, attention_impl="flash"),
        text=dataclasses.replace(cfg.text, attention_impl="flash"),
    )


@pytest.mark.parametrize("encoder", ["audio", "visual", "text"])
def test_encoders_match_jax_at_eval(encoder):
    """encode_audio (2000 samples -> 99 tokens), encode_visual and
    encode_text (DistilBERT with its key mask) at eval on "flash"."""
    from triad_tpu.models import TriadModel as JaxTriad

    jm, params, model = build_models(flash_model_config())
    rng = np.random.default_rng(7)
    if encoder == "audio":
        args = ((rng.normal(size=(2, 2000)) * 0.1).astype(np.float32),)
    elif encoder == "visual":
        args = (rng.normal(size=(2, 28, 28, 3)).astype(np.float32),)
    else:
        mask = np.ones((2, 12), np.float32)
        mask[1, 7:] = 0.0
        args = (rng.integers(1, 100, size=(2, 12)).astype(np.int32), mask)
    method = getattr(JaxTriad, f"encode_{encoder}")
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda *a: jm.apply({"params": params}, *a, method=method))(*args)
    with torch.inference_mode():
        got = getattr(model, f"encode_{encoder}")(*(torch.from_numpy(a) for a in args))
    _close(got, ref)


@pytest.mark.parametrize("section", ["vit", "hubert", "text"])
def test_encoder_training_matches_jax(section):
    """Training mode, every rate at 0, so the JAX modules take the flash
    kernel too: features and every gradient the port forms, through the
    flash backward (the ViT's LoRA factors, HuBERT's and DistilBERT's
    projections), against jax.vjp of the JAX TriadModel."""
    _training_matches_jax(section, "flash")


@pytest.mark.parametrize("section", ["hubert", "text"])
def test_live_attention_dropout_takes_the_plain_attention(section):
    """HuBERT and DistilBERT on "flash" in training with attention dropout
    0.1: the JAX modules run (their dispatch sends a live dropout to the
    XLA composition), and the port's features equal its own "xla" run
    under the same generator, bit for bit, and are finite."""
    from triad_tpu.models import TriadModel as JaxTriad
    from triad_tpu_torch.models.convert import init_triad_model, torch_to_flax
    from triad_tpu_torch.ops.dropout import HostSeeds

    rng = np.random.default_rng(11)
    mask = np.ones((2, 10), np.float32)
    mask[1, 6:] = 0.0
    args = {"hubert": ((rng.normal(size=(2, 1000)) * 0.1).astype(np.float32),),
            "text": (rng.integers(1, 100, size=(2, 10)).astype(np.int32), mask)}[section]
    method = {"hubert": "encode_audio", "text": "encode_text"}[section]

    def features(impl):
        cfg = _encoder_config(section, impl)
        sub = dataclasses.replace(getattr(cfg, section), attention_dropout=0.1)
        cfg = dataclasses.replace(cfg, **{section: sub})
        model = init_triad_model(cfg, torch.Generator().manual_seed(0))
        out = getattr(model, method)(*(torch.from_numpy(a) for a in args), True,
                                     torch.Generator().manual_seed(1), HostSeeds(1, 0))
        return cfg, model, out

    cfg, model, flash = features("flash")
    _, _, xla = features("xla")
    assert bool(torch.isfinite(flash).all())
    assert torch.equal(flash, xla)
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    ref = JaxTriad(cfg).apply({"params": params}, *map(jnp.asarray, args), True,
                              method=method, rngs={"dropout": jax.random.key(0)})
    assert np.isfinite(np.asarray(ref)).all()
