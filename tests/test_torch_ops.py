"""The port's kernel modules (triad_tpu_torch/ops) against the JAX package
on the same numpy inputs, on the CPU. The JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them; the port's
wrappers run their plain PyTorch twins (the tensors lie on the CPU).

Everything is fp32 with TF32 off. Tolerances: 1e-4 x max|ref| for
attention and the MLP (fp32 summation order only); 0.05 x max|ref| for
the frontend, which rounds to bf16 inside the JAX kernel (as
tests/test_pallas_frontend.py:69 bounds it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestAttentionEval:
    def test_packed_ragged_with_mask(self):
        from triad_tpu.ops.pallas_attention import fused_attention_eval
        from triad_tpu_torch.ops.attention import attention_eval

        rng = np.random.default_rng(0)
        b, n, hd = 2, 37, 128
        q, k, v = (rng.normal(size=(b, n, hd)).astype(np.float32) for _ in range(3))
        mask = np.ones((b, n), np.float32)
        mask[1, 20:] = 0.0
        mask[0, :3] = 0.0
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(fused_attention_eval(q, k, v, jnp.asarray(mask), 0.125))
        got = attention_eval(_t(q), _t(k), _t(v), _t(mask), 0.125).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())

    def test_merged(self):
        from triad_tpu.ops.pallas_attention import fused_attention_eval_merged
        from triad_tpu_torch.ops.attention import attention_eval_merged

        rng = np.random.default_rng(1)
        b, n = 2, 37
        qkv = rng.normal(size=(b, n, 3 * 128)).astype(np.float32)
        mask = np.ones((b, n), np.float32)
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(fused_attention_eval_merged(qkv, jnp.asarray(mask), 0.125))
        got = attention_eval_merged(_t(qkv)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())

    @pytest.mark.parametrize("scores", ["float32", "bfloat16"])
    def test_masked_attention_matches_xla_branch(self, scores):
        """layers.dot_product_attention's XLA body: finfo.min mask and an
        fp32 softmax, or -1e4 and the bf16 max-subtracted exp (fp32 in
        and out here, so only the score branch differs)."""
        from triad_tpu.models.layers import dot_product_attention
        from triad_tpu_torch.ops.attention import masked_attention

        rng = np.random.default_rng(2)
        q, k, v = (rng.normal(size=(2, 9, 2, 16)).astype(np.float32) for _ in range(3))
        mask = np.ones((2, 1, 1, 9), bool)
        mask[1, ..., 5:] = False
        ref = np.asarray(dot_product_attention(
            q, k, v, jnp.asarray(mask), jnp.float32, scores_dtype=jnp.dtype(scores)))
        got = masked_attention(_t(q), _t(k), _t(v), _t(mask), torch.float32,
                               getattr(torch, scores)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


class TestFusedMlp:
    @pytest.mark.parametrize("form", ["erf", "tanh"])
    def test_matches_pallas_kernel(self, form):
        from triad_tpu.ops.pallas_mlp import fused_mlp as jax_fused_mlp
        from triad_tpu_torch.ops.mlp import fused_mlp

        rng = np.random.default_rng(3)
        x = rng.normal(size=(2, 9, 64)).astype(np.float32)
        w1 = (rng.normal(size=(64, 128)) / 8).astype(np.float32)
        b1 = (rng.normal(size=(128,)) * 0.1).astype(np.float32)
        w2 = (rng.normal(size=(128, 64)) / 11).astype(np.float32)
        b2 = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jax_fused_mlp(x, w1, b1, w2, b2, jnp.zeros((), jnp.int32),
                                           0.0, form))
        # the port takes torch's Linear layout: (out, in)
        got = fused_mlp(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2), form).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())

    def test_unknown_gelu_raises(self):
        from triad_tpu_torch.ops.mlp import fused_mlp

        x = torch.zeros(1, 2, 32)
        with pytest.raises(ValueError):
            fused_mlp(x, torch.zeros(32, 32), torch.zeros(32), torch.zeros(32, 32),
                      torch.zeros(32), "relu")


def _frontend_weights(seed=0):
    rng = np.random.default_rng(seed)
    w0 = (rng.normal(size=(10, 1, 512)) * (2 / 10) ** 0.5).astype(np.float32)
    gs = (rng.normal(size=(512,)) * 0.2 + 1.0).astype(np.float32)
    gb = (rng.normal(size=(512,)) * 0.1).astype(np.float32)
    ws = [(rng.normal(size=(k, 512, 512)) * (2 / (k * 512)) ** 0.5).astype(np.float32)
          for k in (3, 3, 3, 3, 2, 2)]
    return w0, gs, gb, ws


class TestFrontend:
    def test_monolithic_xt(self):
        from triad_tpu.ops.pallas_frontend import monolithic_frontend
        from triad_tpu_torch.ops.frontend import frontend, num_tokens

        rng = np.random.default_rng(4)
        wave = rng.normal(size=(1, 8000)).astype(np.float32)
        w0, gs, gb, ws = _frontend_weights()
        ref = np.asarray(monolithic_frontend(
            wave, w0, gs, gb, ws, tb=8, out_dtype=jnp.float32, interpret=True,
            gelu="tanh", wave_layout="xt"))
        # Flax (k, in, out) conv kernels -> torch Conv1d (out, in, k)
        got = frontend(_t(wave), _t(w0.transpose(2, 1, 0)), _t(gs), _t(gb),
                       [_t(w.transpose(2, 1, 0)) for w in ws], "tanh",
                       out_dtype=torch.float32).numpy()
        assert got.shape == ref.shape == (1, num_tokens(8000), 512)
        tol = 0.05 * float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, atol=tol)
        assert float(np.abs(got - ref).mean()) < tol / 30

    def test_stats_match_gram_pass(self):
        """conv0_stats: fp32 over every step, var clamped at 0 (the JAX
        xt Gram pass at HIGHEST precision is the same quantity)."""
        from triad_tpu.ops.pallas_frontend import conv0_stats as jax_stats
        from triad_tpu.ops.pallas_frontend import make_g2_weight_xt
        from triad_tpu_torch.ops.frontend import conv0_stats

        rng = np.random.default_rng(5)
        wave = rng.normal(size=(2, 8000)).astype(np.float32)
        w0, *_ = _frontend_weights()
        m0 = (8000 - 10) // 5 + 1
        u = 1024
        x10 = np.zeros((2, u * 10), np.float32)
        x10[:, :8000] = wave
        xt = np.pad(x10.reshape(2, u, 10).transpose(0, 2, 1), ((0, 0), (0, 6), (0, 0)))
        rm, rv = jax_stats(jnp.asarray(xt), make_g2_weight_xt(jnp.asarray(w0.reshape(10, 512))),
                           m0, interpret=True, wave_layout="xt")
        mean, var = conv0_stats(_t(wave), _t(w0.transpose(2, 1, 0)))
        np.testing.assert_allclose(mean.numpy(), np.asarray(rm), atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(var.numpy(), np.asarray(rv), atol=1e-5, rtol=1e-4)
        assert float(var.min()) >= 0.0

    def test_nan_culprit_rows_stay_finite(self):
        """The two audio rows whose GroupNorm variance went negative in the
        TPU stats pass at default precision (docs/evidence/
        nan_fe_xt_mechanism.log) give nonnegative fp32 variances and finite
        tokens here (random frontend weights of the real geometry)."""
        import os

        from triad_tpu_torch.models.hubert import normalize_waveform
        from triad_tpu_torch.ops.frontend import conv0_stats, frontend

        path = os.path.join(os.path.dirname(__file__), "..", "docs", "evidence",
                            "nan_culprit_audio_rows.npz")
        wave = normalize_waveform(_t(np.load(path)["av_audio"]))
        w0, gs, gb, ws = _frontend_weights()
        w0, ws = _t(w0.transpose(2, 1, 0)), [_t(w.transpose(2, 1, 0)) for w in ws]
        _, var = conv0_stats(wave, w0)
        assert float(var.min()) > 0.0
        out = frontend(wave, w0, _t(gs), _t(gb), ws, "tanh")
        assert out.shape == (2, 499, 512)
        assert bool(torch.isfinite(out.float()).all())


class TestSimilarity:
    def test_pair_scores_match_export_fn(self):
        from triad_tpu.serve.export import _pair_scores_fn
        from triad_tpu_torch.ops.similarity import pair_scores

        rng = np.random.default_rng(6)
        q = rng.normal(size=(3, 5, 16)).astype(np.float32)
        qm = (rng.random((3, 5)) > 0.3).astype(np.float32)
        qm[2] = 0.0  # empty query: count clamps at 1
        k = rng.normal(size=(4, 6, 16)).astype(np.float32)
        km = (rng.random((4, 6)) > 0.3).astype(np.float32)
        km[:, 0] = 1.0
        ref = np.asarray(_pair_scores_fn(q, qm, k, km, np.float32(1 / 1.5)))
        got = pair_scores(_t(q), _t(qm), _t(k), _t(km), 1 / 1.5).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)

    def test_pairwise_similarity(self):
        from triad_tpu.ops.similarity import pairwise_similarity as jax_pairwise
        from triad_tpu_torch.ops.similarity import pairwise_similarity

        rng = np.random.default_rng(7)
        a = rng.normal(size=(2, 5, 16)).astype(np.float32)
        b = rng.normal(size=(2, 7, 16)).astype(np.float32)
        ref = np.asarray(jax_pairwise(a, b, jnp.float32(1.5)))
        got = pairwise_similarity(_t(a), _t(b), torch.tensor(1.5)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
