"""The port's training attention past 512 keys (the kernels have no key cap)
against the JAX package, on the CPU, at N = 600 and N = 1000 (B = 1, two
heads of 64): values and dq, dk, dv in the packed, strided and merged
layouts, with one masked key and with a fully masked row.

At p = 0 the references are ``fused_attention_packed`` (packed and merged
operands) and ``fused_attention`` (strided) in interpret mode; at p = 0.1
the masked XLA composition fed ``attention_keep``'s mask (the TPU kernels
draw from the core PRNG, which nothing reproduces). Also: the row
statistics the forward kernel saves for its backward and the di =
rowsum(dP * P) its dQ kernel hands the dK/dV kernel
(``train_row_stats_plain``, ``train_di_plain``) against float64.

Inputs come from numpy with a seed; the port's wrappers run their plain
twins (the tensors lie on the CPU). fp32 with TF32 off. Tolerance: 1e-4 of
the reference's largest magnitude (fp32 throughout, summation order only);
the stats 1e-5 relative (fp32 products of 64 terms and sums of up to 1000).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, H, P, SEED = 1, 2, 0.1, 11
LENGTHS = (600, 1000)
MASKS = ("one_key", "all_keys")
LAYOUTS = ("packed", "strided", "merged")


def _close(got, ref, name):
    got = got.detach().to(torch.float32).numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * max(float(np.abs(ref).max()), 1e-30),
                               err_msg=name)


def _inputs(n, masked):
    """qkv (B, n, 3 * H * 64), dO (B, n, H * 64) and the key mask: one
    masked key, or every key masked (uniform weights)."""
    rng = np.random.default_rng(n)
    qkv = rng.normal(size=(B, n, 3 * H * 64)).astype(np.float32)
    do = rng.normal(size=(B, n, H * 64)).astype(np.float32)
    mask = np.ones((B, n), np.float32)
    if masked == "one_key":
        mask[0, n // 3] = 0.0
    else:
        mask[:] = 0.0
    return qkv, do, mask


def _heads(a):
    """(B, n, H * 64) -> (B, H, n, 64)."""
    b, n, _ = a.shape
    return np.ascontiguousarray(a.reshape(b, n, H, 64).transpose(0, 2, 1, 3))


@functools.lru_cache(maxsize=None)
def _jax_fns():
    """Jitted (o, dq, dk, dv) of the three references, the key mask (and
    keep mask) as arguments, so each shape compiles once."""
    from triad_tpu.ops.pallas_attention import fused_attention, fused_attention_packed

    seed = jnp.zeros((), jnp.int32)

    def with_grads(f, do, *x):
        o, vjp = jax.vjp(f, *x)
        return (o, *vjp(do))

    def composition(q, k, v, mask, keep, do):
        """_head_fwd as an XLA composition on (B, H, n, 64) operands with
        the port's keep mask and the kernels' -1e30 key bias."""
        bias = ((1.0 - mask) * -1e30)[:, None, None, :]

        def f(q, k, v):
            s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * 0.125 + bias
            probs = jax.nn.softmax(s, axis=-1)
            dropped = jnp.where(keep, probs * np.float32(1 / (1 - P)), 0.0)
            return jnp.einsum("bhqk,bhkd->bhqd", dropped, v)

        return with_grads(f, do, q, k, v)

    def packed(q, k, v, mask, do):
        return with_grads(lambda *x: fused_attention_packed(*x, mask, seed, 0.0, 0.125), do,
                          q, k, v)

    def strided(q, k, v, mask, do):
        return with_grads(lambda *x: fused_attention(*x, mask, seed, 0.0, 0.125), do, q, k, v)

    return jax.jit(composition), jax.jit(packed), jax.jit(strided)


@functools.lru_cache(maxsize=None)
def _keep(n):
    from triad_tpu_torch.ops.attention import attention_keep

    return attention_keep(B, H, n, n, SEED, P, "cpu").numpy()


@functools.lru_cache(maxsize=None)
def _reference(n, masked, p, strided):
    """(o, dq, dk, dv) of the JAX reference as (B, H, n, 64) arrays: the
    masked composition at p > 0, else fused_attention (``strided``) or
    fused_attention_packed in interpret mode."""
    composition, packed, strided_fn = _jax_fns()
    qkv, do, mask = _inputs(n, masked)
    q, k, v = np.split(qkv, 3, axis=-1)
    if p > 0:
        return composition(*(_heads(a) for a in (q, k, v)), mask, _keep(n), _heads(do))
    with pltpu.force_tpu_interpret_mode():
        if strided:
            return strided_fn(*(_heads(a) for a in (q, k, v)), mask, _heads(do))
        return tuple(_heads(np.asarray(a)) for a in packed(q, k, v, mask, do))


def _port(n, masked, p, layout):
    """(o, dq, dk, dv) of the port's differentiable training attention in
    ``layout``, as (B, H, n, 64) arrays."""
    from triad_tpu_torch.ops.attention import (
        attention_train,
        attention_train_merged,
        attention_train_strided,
    )

    qkv, do, mask = _inputs(n, masked)
    seed = SEED if p > 0 else 0
    if layout == "merged":
        leaf = torch.from_numpy(qkv).requires_grad_()
        out = attention_train_merged(leaf, torch.from_numpy(mask), seed, p, 0.125)
        out.backward(torch.from_numpy(do))
        grads = leaf.grad.chunk(3, dim=-1)
    elif layout == "packed":
        leaves = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
                  for a in np.split(qkv, 3, axis=-1)]
        out = attention_train(*leaves, torch.from_numpy(mask), seed, p, 0.125)
        out.backward(torch.from_numpy(do))
        grads = [x.grad for x in leaves]
    else:
        leaves = [torch.from_numpy(_heads(a)).requires_grad_() for a in np.split(qkv, 3, axis=-1)]
        out = attention_train_strided(*leaves, torch.from_numpy(mask), seed, p, 0.125)
        out.backward(torch.from_numpy(_heads(do)))
        return (out, *(x.grad for x in leaves))
    unpack = lambda t: t.unflatten(-1, (H, 64)).transpose(1, 2)  # noqa: E731
    return (unpack(out), *(unpack(g) for g in grads))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("p", [0.0, P])
@pytest.mark.parametrize("masked", MASKS)
@pytest.mark.parametrize("n", LENGTHS)
def test_matches_jax(n, masked, p, layout):
    got = _port(n, masked, p, layout)
    ref = _reference(n, masked, p, p == 0 and layout == "strided")
    for name, g, r in zip(("o", "dq", "dk", "dv"), got, ref):
        _close(g, r, f"{layout} n={n} {masked} p={p} {name}")


@pytest.mark.parametrize("masked", MASKS)
@pytest.mark.parametrize("n", LENGTHS)
def test_row_stats_plain(n, masked):
    """(m, l) against float64: m the row max of S with the key bias, l the
    sum of exp(S - m), so exp(S - m) / l is the forward's P."""
    from triad_tpu_torch.ops.attention import train_row_stats_plain

    qkv, _, mask = _inputs(n, masked)
    q, k, _ = (_heads(a) for a in np.split(qkv, 3, axis=-1))
    got = train_row_stats_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(mask),
                                0.125)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) * 0.125
    s = s + ((1.0 - mask) * -1e30)[:, None, None, :]
    m = s.max(axis=-1)
    l = np.exp(s - m[..., None]).sum(axis=-1)
    assert got.shape == (2, B, H, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), m, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), l, rtol=1e-5)
    if masked == "all_keys":
        np.testing.assert_array_equal(got[1].numpy(), np.float32(n))


@pytest.mark.parametrize("p", [0.0, P])
@pytest.mark.parametrize("n", LENGTHS)
def test_di_plain(n, p):
    """train_di_plain: di = rowsum(dP * P) of _head_bwd (:208), which the
    dQ kernel forms in its first pass and hands the dK/dV kernel, against
    float64 (dP = dO V^T keep / (1 - p))."""
    from triad_tpu_torch.ops.attention import train_di_plain

    qkv, do, mask = _inputs(n, "one_key")
    q, k, v = (torch.from_numpy(_heads(a)) for a in np.split(qkv, 3, axis=-1))
    tmask = torch.from_numpy(mask)
    got = train_di_plain(q, k, v, tmask, torch.from_numpy(_heads(do)), 0.125, SEED, p)
    assert got.shape == (B, H, n) and got.dtype == torch.float32
    s = np.einsum("bhqd,bhkd->bhqk", q.numpy().astype(np.float64),
                  k.numpy().astype(np.float64)) * 0.125
    s = s + ((1.0 - mask) * -1e30)[:, None, None, :]
    e = np.exp(s - s.max(axis=-1, keepdims=True))
    probs = e / e.sum(axis=-1, keepdims=True)
    dp = np.einsum("bhqd,bhkd->bhqk", _heads(do).astype(np.float64),
                   v.numpy().astype(np.float64))
    dp = np.where(_keep(n), dp / (1 - P), 0.0) if p > 0 else dp
    _close(got, (dp * probs).sum(-1), f"di n={n} p={p}")


@pytest.mark.parametrize("p", [0.0, P])
def test_one_key_gives_exact_zero_dq_dk(p):
    """With one key, P = 1, so di = rowsum(dP * P) is dP itself and dS = P
    (dP - di) is exactly 0, as in _head_bwd: the plain backward's dq and dk
    are exactly zero (the card tests hold the kernels to that, with a
    tolerance of 0 there)."""
    from triad_tpu_torch.ops.attention import heads_train_bwd_plain, train_di_plain

    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, H, 1, 64)).astype(np.float32))
                   for _ in range(4))
    mask = torch.ones((B, 1))
    di = train_di_plain(q, k, v, mask, do, 0.125, SEED, p)
    dq, dk, dv = heads_train_bwd_plain(q, k, v, mask, do, 0.125, SEED, p)
    dp = (do * v).sum(-1, dtype=torch.float64).to(torch.float32)
    keep = _keep(1)[..., 0]
    if p > 0:
        dp = torch.from_numpy(np.where(keep, dp.numpy() / np.float32(1 - P), 0.0))
    _close(di, dp, f"di p={p}")
    assert torch.equal(dq, torch.zeros_like(dq)) and torch.equal(dk, torch.zeros_like(dk))
    assert bool(torch.isfinite(dv).all())
