"""The port's training ops against the JAX package, on the CPU, at small
sizes: the packed training attention (values and dq/dk/dv), the fused-MLP
backward, the cross-batch max-mean aggregation (dense, chunked and the
hand-written chunked_vjp, including bf16 volumes and max ties) and the
losses. Inputs come from numpy with a seed; the JAX Pallas kernels run in
interpret mode; the port's wrappers run their plain versions (the
tensors lie on the CPU). fp32 with TF32 off unless a test says bf16.

Tolerances, relative to the largest magnitude of the reference:
  attention, MLP      1e-4: fp32 throughout, summation order only.
  aggregation, loss   1e-5: fp32 sums in another order (the volume's max
                      routing is the same: the test features make equal
                      sims bit-equal in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _close(got, ref, rel):
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(float(np.abs(ref).max()), 1e-30))


class TestAttentionTrain:
    def _inputs(self):
        rng = np.random.default_rng(0)
        b, n, hd = 2, 37, 128  # ragged N, 2 heads of 64
        q, k, v, do = (rng.normal(size=(b, n, hd)).astype(np.float32) for _ in range(4))
        mask = np.ones((b, n), np.float32)
        mask[0, :3] = 0.0
        mask[1, 20:] = 0.0
        return q, k, v, do, mask

    def test_values_and_grads_match_pallas(self):
        from triad_tpu.ops.pallas_attention import fused_attention_packed
        from triad_tpu_torch.ops.attention import attention_train

        q, k, v, do, mask = self._inputs()

        def f(q, k, v):
            return fused_attention_packed(q, k, v, jnp.asarray(mask), jnp.zeros((), jnp.int32),
                                          0.0, 0.125)

        with pltpu.force_tpu_interpret_mode():
            ref, vjp = jax.vjp(f, q, k, v)
            refs = vjp(jnp.asarray(do))
        qt, kt, vt = (_t(a, grad=True) for a in (q, k, v))
        out = attention_train(qt, kt, vt, _t(mask), 0, 0.0, 0.125)
        out.backward(_t(do))
        _close(out, ref, 1e-4)
        for got, r in zip((qt.grad, kt.grad, vt.grad), refs):
            _close(got, r, 1e-4)

    def test_bwd_plain_matches_autograd_of_plain(self):
        from triad_tpu_torch.ops.attention import attention_train_bwd_plain, attention_train_plain

        q, k, v, do, mask = (torch.from_numpy(a).double() for a in self._inputs())
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        attention_train_plain(*leaves, mask, 0.125).backward(do)
        for got, leaf in zip(attention_train_bwd_plain(q, k, v, mask, do, 0.125), leaves):
            # the plain pair computes in fp32 from float64 inputs
            _close(got, leaf.grad.float().numpy(), 1e-5)

    def test_fully_masked_row_is_uniform(self):
        from triad_tpu_torch.ops.attention import attention_train

        rng = np.random.default_rng(1)
        q, k, v = (_t(rng.normal(size=(1, 9, 64)).astype(np.float32)) for _ in range(3))
        out = attention_train(q, k, v, torch.zeros(1, 9))
        torch.testing.assert_close(out, v.mean(dim=1, keepdim=True).expand_as(out))

    def test_dropout_not_ported(self):
        """The dropout form is ported: at p_drop > 0 the output is the
        masked composition with ops/dropout.py's keep mask (held to JAX in
        tests/test_torch_hubert_train.py), and the mask changes with the
        seed."""
        from triad_tpu_torch.ops.attention import attention_keep, attention_train

        rng = np.random.default_rng(2)
        q, k, v = (_t(rng.normal(size=(1, 9, 64)).astype(np.float32)) for _ in range(3))
        keep = attention_keep(1, 1, 9, 9, 3, 0.5, "cpu")[0, 0]
        probs = torch.softmax(q[0] @ k[0].T * 0.125, dim=-1)
        want = torch.where(keep, probs * 2.0, torch.zeros(())) @ v[0]
        got = attention_train(q, k, v, None, 3, 0.5, 0.125)
        _close(got[0], want.numpy(), 1e-5)
        assert not torch.equal(got, attention_train(q, k, v, None, 4, 0.5, 0.125))


class TestFusedMlpBwd:
    @pytest.mark.parametrize("form", ["erf", "tanh"])
    def test_grads_match_pallas_vjp(self, form):
        from triad_tpu.ops.pallas_mlp import fused_mlp as jax_fused_mlp
        from triad_tpu_torch.ops.mlp import FusedMlp

        rng = np.random.default_rng(3)
        x = rng.normal(size=(2, 9, 64)).astype(np.float32)
        w1 = (rng.normal(size=(64, 128)) / 8).astype(np.float32)
        b1 = (rng.normal(size=(128,)) * 0.1).astype(np.float32)
        w2 = (rng.normal(size=(128, 64)) / 11).astype(np.float32)
        b2 = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
        dy = rng.normal(size=(2, 9, 64)).astype(np.float32)

        def f(x, w1, b1, w2, b2):
            return jax_fused_mlp(x, w1, b1, w2, b2, jnp.zeros((), jnp.int32), 0.0, form)

        with pltpu.force_tpu_interpret_mode():
            ref, vjp = jax.vjp(f, x, w1, b1, w2, b2)
            refs = vjp(jnp.asarray(dy))
        # the port takes torch's Linear layout: (out, in)
        leaves = [_t(a, grad=True) for a in (x, w1.T, b1, w2.T, b2)]
        y = FusedMlp.apply(*leaves, form)
        y.backward(_t(dy))
        _close(y, ref, 1e-4)
        for got, r, transpose in zip((leaf.grad for leaf in leaves), refs,
                                     (False, True, False, True, False)):
            _close(got.t() if transpose else got, r, 1e-4)

    def test_frozen_weights_get_no_grad(self):
        from triad_tpu_torch.ops.mlp import FusedMlp

        x = torch.randn(2, 3, 32, requires_grad=True)
        w1, b1, w2, b2 = torch.randn(64, 32), torch.randn(64), torch.randn(32, 64), torch.randn(32)
        FusedMlp.apply(x, w1, b1, w2, b2, "tanh").sum().backward()
        assert x.grad is not None and w1.grad is None and w2.grad is None


def _agg_inputs(seed, bq=4, bk=4, nq=5, nk=6, d=16, exact=False):
    rng = np.random.default_rng(seed)
    if exact:
        # multiples of 1/4 in [-3/4, 3/4]: every dot product (and its
        # partial sums) is exact in fp32 and bf16, so equal sims are
        # bit-equal in both packages and ties route the same way.
        q = rng.integers(-3, 4, size=(bq, nq, d)).astype(np.float32) / 4
        k = rng.integers(-3, 4, size=(bk, nk, d)).astype(np.float32) / 4
    else:
        q = rng.normal(size=(bq, nq, d)).astype(np.float32)
        k = rng.normal(size=(bk, nk, d)).astype(np.float32)
    mask = np.ones((bq, nq), np.float32)
    mask[1, 3:] = 0.0
    w = rng.normal(size=(bq, bk)).astype(np.float32)
    return q, k, mask, w


def _agg_pair(q, k, mask, w, impl, dtype="float32", volume="float32", precision="highest",
              clamp_min=-1.0, temp=1.5):
    """(JAX, port) pairs of (clip_sims, nonneg sum, diag, dq, dk, dT) for
    the scalar sum(clip * w) + 0.3 * nonneg."""
    from triad_tpu.ops.similarity import aggregate_crossbatch as jagg
    from triad_tpu_torch.ops.similarity import aggregate_crossbatch

    kw = dict(clamp_min=clamp_min, implementation=impl, chunk_size=2, precision=precision,
              volume_dtype=volume)
    jdt = jnp.dtype(dtype)

    def jloss(q, k, t):
        out = jagg(q, k, t, query_mask=None if mask is None else jnp.asarray(mask), **kw)
        return jnp.sum(out.clip_sims * w) + 0.3 * out.nonneg_sq_sum, out

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.float32(temp))
    tdt = getattr(torch, dtype)
    qt, kt = (_t(a).to(tdt).requires_grad_() for a in (q, k))
    tt = torch.tensor(temp, requires_grad=True)
    out = aggregate_crossbatch(qt, kt, tt, query_mask=None if mask is None else _t(mask), **kw)
    ((out.clip_sims * _t(w)).sum() + 0.3 * out.nonneg_sq_sum).backward()
    jax_side = (jo.clip_sims, jo.nonneg_sq_sum, jo.diag_token_sims, *jg)
    port_side = (out.clip_sims, out.nonneg_sq_sum, out.diag_token_sims, qt.grad, kt.grad,
                 tt.grad)
    return jax_side, port_side


class TestAggregate:
    @pytest.mark.parametrize("impl", ["dense", "chunked", "chunked_vjp"])
    @pytest.mark.parametrize("masked", [False, True])
    def test_matches_jax(self, impl, masked):
        q, k, mask, w = _agg_inputs(4)
        jax_side, port_side = _agg_pair(q, k, mask if masked else None, w, impl)
        for got, ref in zip(port_side, jax_side):
            _close(got, ref, 1e-5)

    @pytest.mark.parametrize("impl", ["dense", "chunked_vjp"])
    def test_bf16_volume_with_ties(self, impl):
        """perf_train_loss_config's path: bf16 features, "default"
        precision, bf16 volume. Exact features make ties common; both
        packages split the max gradient evenly among them. dq/dk/dT are
        fp32 sums of bf16-rounded operands in another order: 1e-3."""
        q, k, mask, w = _agg_inputs(5, exact=True)
        jax_side, port_side = _agg_pair(q, k, mask, w, impl, dtype="bfloat16",
                                        volume="bfloat16", precision="default", clamp_min=-2.0)
        for i, (got, ref) in enumerate(zip(port_side, jax_side)):
            _close(got, ref, 1e-5 if i < 3 else 1e-3)

    def test_tie_gradient_is_split(self):
        """Duplicated key tokens make every max over them a tie: the
        gradient is split evenly between the two copies (the JAX VJP's
        eq / count), never routed to one argmax."""
        q, k, mask, w = _agg_inputs(6)
        k[:, 1] = k[:, 0]
        jax_side, port_side = _agg_pair(q, k, mask, w, "chunked_vjp")
        dk = port_side[4].numpy()
        np.testing.assert_array_equal(dk[:, 0], dk[:, 1])
        _close(port_side[4], jax_side[4], 1e-5)

    def test_pallas_not_ported(self):
        """The "pallas" aggregation is ported (tests/test_torch_maxmean.py
        holds it to the JAX kernel); it keeps the reference's refusals: Nk
        and D multiples of 128, and no bf16 volume."""
        from triad_tpu_torch.ops.similarity import aggregate_crossbatch

        x = torch.zeros(2, 3, 4)
        with pytest.raises(ValueError, match="multiples of 128"):
            aggregate_crossbatch(x, x, torch.tensor(1.0), clamp_min=-1.0,
                                 implementation="pallas")
        y = torch.zeros(2, 128, 128)
        with pytest.raises(ValueError, match="volume_dtype"):
            aggregate_crossbatch(y, y, torch.tensor(1.0), clamp_min=-1.0,
                                 implementation="pallas", volume_dtype="bfloat16")


class TestLosses:
    def _feats(self, seed, nq):
        rng = np.random.default_rng(seed)
        a = rng.normal(size=(3, nq, 8)).astype(np.float32) * 0.5
        v = rng.normal(size=(3, 6, 8)).astype(np.float32) * 0.5
        mask = np.ones((3, nq), np.float32)
        mask[2, nq // 2:] = 0.0
        return a, v, mask

    @pytest.mark.parametrize("kind", ["tv", "av"])
    def test_matches_jax_and_oracle(self, kind):
        from triad_tpu.core.config import LossConfig
        from triad_tpu.ops import losses as jl
        from triad_tpu_torch.ops import losses as tl
        from tests import torch_oracle as oracle

        cfg = LossConfig()
        a, v, mask = self._feats(7, 5)
        temp = np.float32(0.8)  # below temp_cal_low: the calibration term is live
        if kind == "tv":
            ref = jl.tv_loss(a, v, jnp.asarray(mask), jnp.float32(temp), cfg)
            got = tl.tv_loss(_t(a), _t(v), _t(mask), torch.tensor(temp), cfg)
            orc = oracle.oracle_tv_loss(_t(a), _t(v), _t(mask), torch.tensor(temp))
        else:
            ref = jl.av_loss(a, v, jnp.float32(temp), cfg)
            got = tl.av_loss(_t(a), _t(v), torch.tensor(temp), cfg)
            orc = oracle.oracle_av_loss(_t(a), _t(v), torch.tensor(temp))
            _close(got.smooth, ref.smooth, 1e-5)
            _close(got.smooth, orc["smooth"].numpy(), 1e-5)
        for name in ("total", "contrastive", "reg"):
            _close(getattr(got, name), getattr(ref, name), 1e-5)
            _close(getattr(got, name), orc[name].numpy(), 1e-5)
        assert sorted(got.stats) == sorted(ref.stats)
        for key, val in got.stats.items():
            _close(val, ref.stats[key], 1e-5)
        for key, val in oracle.oracle_stats(orc["clip_sims"], kind).items():
            _close(got.stats[key], np.float32(val), 1e-5)
