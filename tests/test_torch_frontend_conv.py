"""The fused frontend conv and the frontend activation of the port against
the JAX package, on the CPU, at small sizes: the plain twins of
``fused_frontend_conv`` (k 2 and 3, each prologue, a ragged logical
length inside a larger allocation) and ``frontend_activation`` against
``pallas_conv.fused_frontend_conv`` and ``pallas_activation`` in interpret
mode, their gradients against ``jax.grad`` through the custom VJPs, and
HuBERT's "pallas" and "conv_act" frontends against the JAX HubertModel,
outputs and parameter gradients.

Inputs come from numpy with a seed; the port's wrappers run their plain
twins (the tensors lie on the CPU). fp32 with TF32 off. Tolerances:
1e-4 of the reference's largest magnitude (fp32 throughout, summation
order only), as the JAX package's own frontend test.
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

B, C, COUT = 2, 32, 32


def _close(got, ref, rel=1e-4):
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def _conv_inputs(k, t_logical, seed):
    """x with rows past t_logical (an allocation as the TPU kernel wants
    it; those rows are never read), w in JAX's (k, C, Cout) layout, stats
    and the affine."""
    from triad_tpu.ops.pallas_conv import min_input_alloc

    rng = np.random.default_rng(seed)
    t_alloc = max(min_input_alloc(t_logical, k), t_logical + 3)
    x = rng.normal(size=(B, t_alloc, C)).astype(np.float32)
    w = (rng.normal(size=(k, C, COUT)) * 0.2).astype(np.float32)
    mean = (rng.normal(size=(B, 1, C)) * 0.3).astype(np.float32)
    rstd = rng.uniform(0.5, 2.0, size=(B, 1, C)).astype(np.float32)
    scale = (rng.normal(size=(C,)) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    return x, w, mean, rstd, scale, bias


def _torch_args(x, w, mean, rstd, scale, bias, grad=False):
    """The port's arguments: w in Conv1d's (Cout, C, k) layout."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in
          (x, w.transpose(2, 1, 0), mean, rstd, scale, bias)]
    return [t.requires_grad_(grad) for t in ts]


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("prologue", [None, "gelu", "norm_gelu"])
def test_fused_conv_matches_pallas(k, prologue):
    from triad_tpu.ops.pallas_conv import fused_frontend_conv as jax_conv
    from triad_tpu.ops.pallas_conv import out_rows
    from triad_tpu_torch.ops.frontend_conv import fused_frontend_conv

    t_logical = 37
    args = _conv_inputs(k, t_logical, seed=10 * k + len(prologue or ""))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_conv(*(jnp.asarray(a) for a in args), t_logical, prologue, 8)
    t_out = out_rows(t_logical, k)
    got = fused_frontend_conv(*_torch_args(*args), t_logical, prologue)
    _close(got, np.asarray(ref)[:, :t_out])


@pytest.mark.parametrize("act", ["gelu", "norm_gelu"])
def test_activation_matches_pallas(act):
    from triad_tpu.ops.pallas_conv import pallas_activation
    from triad_tpu_torch.ops.frontend_conv import frontend_activation

    x, _, mean, rstd, scale, bias = _conv_inputs(3, 37, seed=4)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_activation(*(jnp.asarray(a) for a in (x, mean, rstd, scale, bias)), act, 16)
    got = frontend_activation(*(torch.from_numpy(a) for a in (x, mean, rstd, scale, bias)), act)
    _close(got, ref)


@pytest.mark.parametrize("k,prologue", [(3, "norm_gelu"), (2, "gelu")])
def test_fused_conv_gradients_match_jax(k, prologue):
    """Every argument's gradient of <y, r> against jax.grad through the
    custom VJP (its XLA recompute)."""
    from triad_tpu.ops.pallas_conv import fused_frontend_conv as jax_conv
    from triad_tpu.ops.pallas_conv import out_rows
    from triad_tpu_torch.ops.frontend_conv import fused_frontend_conv

    t_logical = 29
    args = _conv_inputs(k, t_logical, seed=7 + k)
    r = np.random.default_rng(8).normal(size=(B, out_rows(t_logical, k), COUT)).astype(
        np.float32)

    def f(*a):
        y = jax_conv(*a, t_logical, prologue, 8)
        return jnp.sum(y[:, :r.shape[1]] * r)

    with pltpu.force_tpu_interpret_mode():
        refs = jax.grad(f, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in args))
    leaves = _torch_args(*args, grad=True)
    (fused_frontend_conv(*leaves, t_logical, prologue) * torch.from_numpy(r)).sum().backward()
    for i, (leaf, ref) in enumerate(zip(leaves, refs)):
        ref = np.asarray(ref)
        if i == 1:
            ref = ref.transpose(2, 1, 0)
        if prologue == "gelu" and i >= 2:
            assert leaf.grad is None or float(leaf.grad.abs().max()) == 0.0
            continue
        _close(leaf.grad, ref)


@pytest.mark.parametrize("act", ["gelu", "norm_gelu"])
def test_activation_gradients_match_jax(act):
    from triad_tpu.ops.pallas_conv import pallas_activation
    from triad_tpu_torch.ops.frontend_conv import frontend_activation

    x, _, mean, rstd, scale, bias = _conv_inputs(3, 37, seed=12)
    args = (x, mean, rstd, scale, bias)
    r = np.random.default_rng(13).normal(size=x.shape).astype(np.float32)

    def f(*a):
        return jnp.sum(pallas_activation(*a, act, 16) * r)

    with pltpu.force_tpu_interpret_mode():
        refs = jax.grad(f, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    (frontend_activation(*leaves, act) * torch.from_numpy(r)).sum().backward()
    for i, (leaf, ref) in enumerate(zip(leaves, refs)):
        if act == "gelu" and i >= 1:
            assert leaf.grad is None or float(leaf.grad.abs().max()) == 0.0
            continue
        _close(leaf.grad, ref)


def test_out_rows_and_identity_stats():
    from triad_tpu.ops import pallas_conv as jax_pc
    from triad_tpu_torch.ops import frontend_conv as fc

    for t in (31999, 15999, 7999, 3999, 1999, 999, 37):
        for k in (2, 3):
            assert fc.out_rows(t, k) == jax_pc.out_rows(t, k)
    for got, want in zip(fc.identity_stats(3, 8), jax_pc.identity_stats(3, 8)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def frontend_config(impl):
    """2 layers, hidden 32, 4 heads, a 3-layer 32-channel conv frontend
    (kernels 10, 3, 2, strides 5, 2, 2) on ``impl``. remat "none": the JAX
    package's chunked remat of "conv_act" cannot differentiate interpret-
    mode Pallas (as its own test notes); tests/test_torch_remat.py holds
    the chunked routes."""
    return HubertConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                        conv_dim=(32, 32, 32), conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                        frontend_impl=impl, remat="none")


@pytest.mark.parametrize("impl", ["pallas", "conv_act"])
def test_hubert_frontends_match_jax(impl):
    """HubertModel at eval on the "pallas" or "conv_act" frontend: the
    output and every parameter's gradient of <out, r> against the JAX
    HubertModel on the same parameters (its kernels in interpret mode,
    their custom VJPs recomputing through XLA)."""
    from triad_tpu.models.hubert import HubertModel as JaxHubert
    from triad_tpu_torch.config import HubertConfig as PortHubertConfig
    from triad_tpu_torch.models.convert import torch_to_flax
    from triad_tpu_torch.models.hubert import HubertModel

    cfg = frontend_config(impl)
    model = HubertModel(PortHubertConfig(**dataclasses.asdict(cfg)))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1
                        + (1.0 if "norm" in name else 0.0))
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    rng = np.random.default_rng(6)
    audio = rng.normal(size=(2, 1000)).astype(np.float32)

    r = rng.normal(size=(2, cfg.num_audio_tokens(1000), cfg.hidden_size)).astype(np.float32)

    def f(p):
        out = JaxHubert(cfg).apply({"params": p}, jnp.asarray(audio))
        return jnp.sum(out * r), out

    with pltpu.force_tpu_interpret_mode():
        (_, ref), gref = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    out = model(torch.from_numpy(audio))
    out.backward(torch.from_numpy(r))
    _close(out, ref)
    checked = 0
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        got, want = torch_to_flax({name: p.grad}), gref
        while isinstance(got, dict):
            key = next(iter(got))
            got, want = got[key], want[key]
        # 5e-6 absolute more: the key-projection bias's gradient is zero up
        # to rounding (softmax does not see a per-row shift)
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 5e-6,
                                   err_msg=name)
        checked += 1
    assert checked == len(list(model.parameters())) - 1  # all but masked_spec_embed
