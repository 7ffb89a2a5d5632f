"""The port's "chunked_unrolled" aggregation and the fused MLP's weight
gradients, on the CPU, at small sizes.

"chunked_unrolled" is the aggregation of perf_eval_loss_config(). The JAX
package runs it as the chunked math with the chunks' scan unrolled
(triad_tpu/ops/similarity.py:457-458); the port runs it as "chunked".
Here the port's aggregate_crossbatch, av_loss and tv_loss under
"chunked_unrolled" are held to the JAX package's on the same numpy
inputs, values and gradients, at fp32 and at bf16 volume, with chunks of
2 and 3, and one av_loss + tv_loss runs under perf_eval_loss_config()
itself.

Tolerances, relative to the largest magnitude of the JAX value:
  fp32 features       1e-5: fp32 sums in another order (tests/
                      test_torch_train_ops.py's bound; the JAX package
                      holds "chunked_unrolled" to "chunked" at rtol 1e-6,
                      tests/test_losses.py:394-415, between two XLA runs).
  bf16 volume         values 1e-5, gradients 1e-3: exact features (every
                      sim exact in bf16, so ties route alike), gradients
                      fp32 sums of bf16-rounded operands in another order
                      (TestAggregate.test_bf16_volume_with_ties's bounds).

FusedMlp's weight gradients are formed from bf16 operands on bf16
tensor cores on the card: at bf16 they must lie within 1 bf16 ulp of the
largest magnitude of the product of the fp32 upcasts, and at fp32 they
must equal that product bit for bit. Last, the edited copies of
csrc/fused_mlp.cu that tools/kernel_probe.py builds must still find the
text they replace.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, rel):
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(float(np.abs(ref).max()), 1e-30))


def _features(seed, bq, bk, nq, nk, d, exact):
    rng = np.random.default_rng(seed)
    if exact:
        # multiples of 1/4: every sim and its partial sums exact in bf16
        q = rng.integers(-3, 4, size=(bq, nq, d)).astype(np.float32) / 4
        k = rng.integers(-3, 4, size=(bk, nk, d)).astype(np.float32) / 4
    else:
        q = rng.normal(size=(bq, nq, d)).astype(np.float32) * 0.5
        k = rng.normal(size=(bk, nk, d)).astype(np.float32) * 0.5
    mask = np.ones((bq, nq), np.float32)
    mask[-1, nq // 2:] = 0.0
    return q, k, mask


# (dtype, volume_dtype, precision, exact features, value bound, gradient bound)
SETTINGS = {
    "fp32": ("float32", "float32", "highest", False, 1e-5, 1e-5),
    "bf16_volume": ("bfloat16", "bfloat16", "default", True, 1e-5, 1e-3),
}


def _configs(chunk, setting):
    from triad_tpu.core.config import LossConfig as JaxLossConfig
    from triad_tpu_torch.config import LossConfig

    _, volume, precision, *_ = SETTINGS[setting]
    kw = dict(implementation="chunked_unrolled", chunk_size=chunk, matmul_precision=precision,
              volume_dtype=volume)
    return JaxLossConfig(**kw), LossConfig(**kw)


class TestAggregateUnrolled:
    @pytest.mark.parametrize("chunk", [2, 3])
    @pytest.mark.parametrize("setting", sorted(SETTINGS))
    @pytest.mark.parametrize("masked", [False, True])
    def test_matches_jax(self, chunk, setting, masked):
        from triad_tpu.ops.similarity import aggregate_crossbatch as jagg
        from triad_tpu_torch.ops.similarity import aggregate_crossbatch

        dtype, volume, precision, exact, rel_v, rel_g = SETTINGS[setting]
        q, k, mask = _features(4, 4, 4, 6, 7, 16, exact)
        w = np.random.default_rng(5).normal(size=(4, 4)).astype(np.float32)
        kw = dict(clamp_min=-1.0, implementation="chunked_unrolled", chunk_size=chunk,
                  precision=precision, volume_dtype=volume)
        m = mask if masked else None

        def jloss(q, k, t):
            out = jagg(q, k, t, query_mask=None if m is None else jnp.asarray(m), **kw)
            return jnp.sum(out.clip_sims * w) + 0.3 * out.nonneg_sq_sum, out

        jdt = jnp.dtype(dtype)
        (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.float32(1.5))
        qt, kt = (_t(a).to(getattr(torch, dtype)).requires_grad_() for a in (q, k))
        tt = torch.tensor(1.5, requires_grad=True)
        out = aggregate_crossbatch(qt, kt, tt, query_mask=None if m is None else _t(m), **kw)
        ((out.clip_sims * _t(w)).sum() + 0.3 * out.nonneg_sq_sum).backward()
        for got, ref in zip((out.clip_sims, out.nonneg_sq_sum, out.diag_token_sims),
                            (jo.clip_sims, jo.nonneg_sq_sum, jo.diag_token_sims)):
            _close(got, ref, rel_v)
        for got, ref in zip((qt.grad, kt.grad, tt.grad), jg):
            _close(got, ref, rel_g)

    def test_equals_chunked(self):
        """In the port the two names are one computation: bit-equal
        values and gradients."""
        from triad_tpu_torch.ops.similarity import aggregate_crossbatch

        q, k, mask = _features(6, 3, 3, 5, 4, 8, False)

        def run(impl):
            qt, kt = (_t(a).requires_grad_() for a in (q, k))
            tt = torch.tensor(0.9, requires_grad=True)
            out = aggregate_crossbatch(qt, kt, tt, clamp_min=-1.0, query_mask=_t(mask),
                                       implementation=impl, chunk_size=2)
            (out.clip_sims.square().sum() + out.nonneg_sq_sum).backward()
            return out.clip_sims, out.nonneg_sq_sum, qt.grad, kt.grad, tt.grad

        for a, b in zip(run("chunked"), run("chunked_unrolled")):
            assert torch.equal(a, b)


class TestLossesUnrolled:
    @pytest.mark.parametrize("chunk", [2, 3])
    @pytest.mark.parametrize("setting", sorted(SETTINGS))
    @pytest.mark.parametrize("kind", ["av", "tv"])
    def test_matches_jax(self, chunk, setting, kind):
        from triad_tpu.ops import losses as jl
        from triad_tpu_torch.ops import losses as tl

        dtype, _, _, exact, rel_v, rel_g = SETTINGS[setting]
        jcfg, cfg = _configs(chunk, setting)
        a, v, mask = _features(7, 5, 5, 6, 4, 8, exact)
        temp = np.float32(0.8)  # below temp_cal_low: the calibration term is live
        jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

        def jtotal(a, v, t):
            if kind == "tv":
                return jl.tv_loss(a, v, jnp.asarray(mask), t, jcfg).total
            return jl.av_loss(a, v, t, jcfg).total

        ref, jg = jax.value_and_grad(jtotal, argnums=(0, 1, 2))(
            jnp.asarray(a, jdt), jnp.asarray(v, jdt), jnp.float32(temp))
        at, vt = (_t(x).to(tdt).requires_grad_() for x in (a, v))
        tt = torch.tensor(temp, requires_grad=True)
        if kind == "tv":
            got = tl.tv_loss(at, vt, _t(mask), tt, cfg).total
        else:
            got = tl.av_loss(at, vt, tt, cfg).total
        got.backward()
        _close(got, ref, rel_v)
        for g, r in zip((at.grad, vt.grad, tt.grad), jg):
            _close(g, r, rel_g)

    def test_perf_eval_loss_config_runs(self):
        """av_loss and tv_loss under perf_eval_loss_config() itself (bf16
        features, "default" precision, bf16 volumes, chunks of 32): they
        run, and every output equals the JAX package's."""
        from triad_tpu.core.config import perf_eval_loss_config as jax_eval_cfg
        from triad_tpu.ops import losses as jl
        from triad_tpu_torch.config import perf_eval_loss_config
        from triad_tpu_torch.ops import losses as tl

        cfg, jcfg = perf_eval_loss_config(), jax_eval_cfg()
        assert cfg.implementation == "chunked_unrolled"
        a, v, mask = _features(8, 6, 6, 7, 5, 16, True)
        temp = np.float32(1.2)
        ab, vb = (_t(x).to(torch.bfloat16) for x in (a, v))
        ja, jv = (jnp.asarray(x, jnp.bfloat16) for x in (a, v))
        got_av = tl.av_loss(ab, vb, torch.tensor(temp), cfg)
        ref_av = jl.av_loss(ja, jv, jnp.float32(temp), jcfg)
        got_tv = tl.tv_loss(ab, vb, _t(mask), torch.tensor(temp), cfg)
        ref_tv = jl.tv_loss(ja, jv, jnp.asarray(mask), jnp.float32(temp), jcfg)
        for got, ref in ((got_av, ref_av), (got_tv, ref_tv)):
            for name in ("total", "contrastive", "reg"):
                _close(getattr(got, name), getattr(ref, name), 1e-5)
            assert sorted(got.stats) == sorted(ref.stats)
            for key, val in got.stats.items():
                _close(val, ref.stats[key], 1e-5)
        _close(got_av.smooth, ref_av.smooth, 1e-5)


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


class TestFusedMlpWeightGrads:
    def _run(self, dtype, form, p_drop):
        from triad_tpu_torch.ops import mlp as M

        rng = np.random.default_rng(21)
        din, dh, m = 48, 96, 37
        arrays = (rng.normal(size=(m, din)), rng.normal(size=(dh, din)) / 7,
                  rng.normal(size=(dh,)) * 0.1, rng.normal(size=(din, dh)) / 10,
                  rng.normal(size=(din,)) * 0.1, rng.normal(size=(m, din)))
        x, w1, b1, w2, b2, dy = (_t(a.astype(np.float32)).to(dtype) for a in arrays)
        leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
        M.FusedMlp.apply(*leaves, form, 5, p_drop).backward(dy)
        # the fp32-upcast formula on the kernels' own dh and g
        _, dh_, g = M.fused_mlp_bwd(x, w1, b1, w2, dy, form, 5, p_drop)
        f32 = torch.float32
        refs = ((dh_.to(f32).t() @ x.to(f32)).to(dtype), dh_.to(f32).sum(0).to(dtype),
                (dy.to(f32).t() @ g.to(f32)).to(dtype), dy.to(f32).sum(0).to(dtype))
        return [leaf.grad for leaf in leaves[1:]], refs

    @pytest.mark.parametrize("form,p_drop", [("tanh", 0.0), ("erf", 0.1)])
    def test_bf16_within_one_ulp(self, form, p_drop):
        grads, refs = self._run(torch.bfloat16, form, p_drop)
        for name, got, ref in zip(("dW1", "db1", "dW2", "db2"), grads, refs):
            assert got.dtype == torch.bfloat16 and got.shape == ref.shape, name
            mx = float(ref.float().abs().max())
            err = float((got.float() - ref.float()).abs().max())
            assert err <= _bf16_ulp(mx), (name, err, mx)

    @pytest.mark.parametrize("form,p_drop", [("tanh", 0.0), ("erf", 0.1)])
    def test_fp32_bit_equal(self, form, p_drop):
        grads, refs = self._run(torch.float32, form, p_drop)
        for name, got, ref in zip(("dW1", "db1", "dW2", "db2"), grads, refs):
            assert torch.equal(got, ref), name


@pytest.mark.parametrize("variant", [0, 1, 2, 3, 4, 5, 6])
def test_probe_variants_match_the_kernel(variant):
    """Each edited copy that tools/kernel_probe.py fused_mlp builds replaces
    text that csrc/fused_mlp.cu holds exactly once."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.tools import kernel_probe

    assert len(kernel_probe.MLP_VARIANTS) == 7
    src = (kernels.CSRC / "fused_mlp.cu").read_text()
    for old, _ in kernel_probe.MLP_VARIANTS[variant][1]:
        assert src.count(old) == 1, old
