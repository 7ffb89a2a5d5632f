"""The port's CUDA kernels against their plain PyTorch twins, on the card,
at the shapes the serving and training paths give them (B=8: HuBERT 499
tokens, ViT 261 tokens, 10 s of 16 kHz audio), plus ragged and masked
edge cases.

Needs an NVIDIA GPU and nvcc; skips elsewhere. On a machine with the
card and no JAX (tests/conftest.py imports JAX, hence --noconftest):
    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py

Tolerances compare bf16 kernels with bf16 plain versions that round at
the same points; what differs is the fp32 summation order, which can
flip a bf16 rounding of an intermediate. Each bound is stated per test
relative to the largest magnitude of the plain result.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dev, seed, scale=1.0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
        dev, dtype
    )


def _max_err(got, ref):
    return float((got.float() - ref.float()).abs().max()), float(ref.float().abs().max())


class TestAttention:
    # 2 bf16 ulps (2^-7 each) of the output's largest magnitude.
    TOL = 2 * 2.0 ** -7

    @pytest.mark.parametrize("b,n", [(8, 499), (2, 37), (1, 512)])
    def test_packed(self, dev, b, n):
        from triad_tpu_torch.ops.attention import attention_eval, attention_eval_plain

        q, k, v = (_randn((b, n, 768), dev, s) for s in (1, 2, 3))
        mask = torch.ones((b, n), device=dev)
        mask[-1, n // 2:] = 0.0
        got = attention_eval(q, k, v, mask)
        torch.cuda.synchronize()
        err, mx = _max_err(got, attention_eval_plain(q, k, v, mask, 0.125))
        assert err <= self.TOL * mx, (err, mx)

    @pytest.mark.parametrize("b,n", [(8, 261), (3, 70)])
    def test_merged(self, dev, b, n):
        from triad_tpu_torch.ops.attention import attention_eval_merged, attention_eval_plain

        qkv = _randn((b, n, 3 * 768), dev, 4)
        got = attention_eval_merged(qkv)
        torch.cuda.synchronize()
        q, k, v = qkv.split(768, dim=-1)
        ref = attention_eval_plain(q, k, v, torch.ones((b, n), device=dev), 0.125)
        err, mx = _max_err(got, ref)
        assert err <= self.TOL * mx, (err, mx)


class TestMlp:
    # Hidden activations (3072 per row) are rounded to bf16 in both; a
    # flipped rounding moves y by ~1 ulp of one term. 2 bf16 ulps of max.
    TOL = 2 * 2.0 ** -7

    @staticmethod
    def _weights(dev, dout=768):
        return (_randn((3072, 768), dev, 6, 768 ** -0.5), _randn((3072,), dev, 7, 0.1),
                _randn((dout, 3072), dev, 8, 3072 ** -0.5), _randn((dout,), dev, 9, 0.1))

    # 1 row to 64 x 499: one tile, a tile and one row either side of 128,
    # serving's 8 x 128 and 8 x 261, and the train steps' largest M.
    @pytest.mark.parametrize("m", [8 * 499, 8 * 261, 45, 1, 127, 129, 8 * 128, 64 * 499])
    @pytest.mark.parametrize("form", ["tanh", "erf"])
    def test_matches_plain(self, dev, m, form):
        from triad_tpu_torch.ops.mlp import fused_mlp, fused_mlp_plain

        x = _randn((m, 768), dev, 5)
        w1, b1, w2, b2 = self._weights(dev)
        got = fused_mlp(x, w1, b1, w2, b2, form)
        torch.cuda.synchronize()
        err, mx = _max_err(got, fused_mlp_plain(x, w1, b1, w2, b2, form))
        assert err <= self.TOL * mx, (err, mx)

    @pytest.mark.parametrize("dout", [256, 512, 1024])
    @pytest.mark.parametrize("m", [129, 8 * 261])
    def test_other_widths(self, dev, dout, m):
        from triad_tpu_torch.ops.mlp import fused_mlp, fused_mlp_plain

        x = _randn((m, 768), dev, 10)
        w1, b1, w2, b2 = self._weights(dev, dout)
        got = fused_mlp(x, w1, b1, w2, b2, "tanh", 3, 0.1)
        torch.cuda.synchronize()
        err, mx = _max_err(got, fused_mlp_plain(x, w1, b1, w2, b2, "tanh", 3, 0.1))
        assert err <= self.TOL * mx, (err, mx)

    @pytest.mark.parametrize("m", [1, 8 * 261, 64 * 499])
    def test_repeats_bit_for_bit(self, dev, m):
        """No atomics and no split of K: two calls on the same inputs give
        the same bits, forward and backward."""
        from triad_tpu_torch.ops.mlp import fused_mlp, fused_mlp_bwd

        x, dy = _randn((m, 768), dev, 11), _randn((m, 768), dev, 12)
        w1, b1, w2, b2 = self._weights(dev)
        assert torch.equal(fused_mlp(x, w1, b1, w2, b2, "tanh", 9, 0.1),
                           fused_mlp(x, w1, b1, w2, b2, "tanh", 9, 0.1))
        for a, b in zip(fused_mlp_bwd(x, w1, b1, w2, dy, "erf", 9, 0.1),
                        fused_mlp_bwd(x, w1, b1, w2, dy, "erf", 9, 0.1)):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("p", [0.0, 0.1])
    def test_autograd_weight_grads(self, dev, p):
        """FusedMlp on the card: both kernels launch once, dx matches the
        twin's, and dW1 = dh^T x, dW2 = dy^T g (bf16 tensor cores) lie
        within 2 bf16 ulps of the largest magnitude of the product of the
        fp32 upcasts of the same dh, g; db1, db2 fp32 sums, the same."""
        from triad_tpu_torch import kernels
        from triad_tpu_torch.ops import mlp as M

        x, dy = _randn((8, 261, 768), dev, 13), _randn((8, 261, 768), dev, 14)
        leaves = [t.clone().requires_grad_() for t in (x, *self._weights(dev))]
        kernels.reset_launches()
        M.FusedMlp.apply(*leaves, "tanh", 21, p).backward(dy)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["fused_mlp"] == 1 and kernels.LAUNCHES["fused_mlp_bwd"] == 1
        w1, b1, w2 = (leaf.detach() for leaf in leaves[1:4])
        dx, dh, g = M.fused_mlp_bwd(x, w1, b1, w2, dy, "tanh", 21, p)
        f32 = torch.float32
        dh2, g2, x2, dy2 = (t.reshape(-1, t.shape[-1]).to(f32) for t in (dh, g, x, dy))
        refs = (dx, dh2.t() @ x2, dh2.sum(0), dy2.t() @ g2, dy2.sum(0))
        for name, leaf, ref in zip(("dx", "dW1", "db1", "dW2", "db2"), leaves, refs):
            err, mx = _max_err(leaf.grad, ref)
            assert err <= self.TOL * mx, (name, err, mx)


def _frontend_weights(dev):
    from triad_tpu_torch.ops.frontend import KERNELS

    rng = np.random.default_rng(11)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    w0 = f(rng.standard_normal((512, 1, 10)) * (2 / 10) ** 0.5)
    gs = f(rng.standard_normal(512) * 0.2 + 1.0)
    gb = f(rng.standard_normal(512) * 0.1)
    ws = [f(rng.standard_normal((512, 512, k)) * (2 / (k * 512)) ** 0.5) for k in KERNELS[1:]]
    return w0, gs, gb, ws


# (b, t) of the conv_0 and stats cases: B 1, 8 and 64 (serving, the
# kernel phase, the train steps) at T = 400 (m0 = 79), 12345 (a ragged
# last tile and block), 160000 (10 s) and 320000 (20 s, m0 = 63999).
FRONTEND_SHAPES = [(b, t) for b in (1, 8, 64) for t in (400, 12345, 160000, 320000)]


def _conv0_case(dev, b, t):
    from triad_tpu_torch.ops.frontend import GN_EPS, conv0_stats_plain

    w0, gs, gb, _ = _frontend_weights(dev)
    wave = _randn((b, t), dev, 12, dtype=torch.float32)
    mean, var = conv0_stats_plain(wave, w0)
    scale = torch.rsqrt(var + GN_EPS) * gs
    return wave, w0, scale, gb - mean * scale


class TestFrontend:
    # conv_0: bf16 products summed in fp32 in another order (the tensor
    # cores' in place of an fma chain) can flip one bf16 rounding of z and
    # of the output: 2 bf16 ulps of the largest output.
    CONV0_TOL = 2 * 2.0 ** -7

    def test_stats(self, dev):
        from triad_tpu_torch.ops.frontend import conv0_stats, conv0_stats_plain

        w0, *_ = _frontend_weights(dev)
        wave = _randn((8, 160000), dev, 12, dtype=torch.float32)
        mean, var = conv0_stats(wave, w0)
        torch.cuda.synchronize()
        rm, rv = conv0_stats_plain(wave, w0)
        # fp32 sums of 31999 terms in another order: 1e-4 relative.
        assert float((mean - rm).abs().max()) <= 1e-4 * float(rv.sqrt().max())
        assert float((var - rv).abs().max()) <= 1e-4 * float(rv.max())
        assert float(var.min()) >= 0.0

    @pytest.mark.parametrize("b,t", FRONTEND_SHAPES)
    def test_stats_shapes(self, dev, b, t):
        """Against the fp32 recompute at 1e-4 (as test_stats) and against
        the Gram twin, whose fp64 sums of the same exact products differ
        from the kernel's in order only: an fp32 ulp, 1e-6 relative."""
        from triad_tpu_torch.ops.frontend import (
            conv0_stats,
            conv0_stats_gram_plain,
            conv0_stats_plain,
        )

        w0, *_ = _frontend_weights(dev)
        wave = _randn((b, t), dev, 21, dtype=torch.float32)
        mean, var = conv0_stats(wave, w0)
        torch.cuda.synchronize()
        for (rm, rv), tol in ((conv0_stats_plain(wave, w0), 1e-4),
                              (conv0_stats_gram_plain(wave, w0), 1e-6)):
            assert float((mean - rm).abs().max()) <= tol * float(rv.sqrt().max())
            assert float((var - rv).abs().max()) <= tol * float(rv.max())
        assert float(var.min()) > 0.0

    @pytest.mark.parametrize("form", ["tanh", "erf"])
    @pytest.mark.parametrize("b,t", FRONTEND_SHAPES)
    def test_conv0_shapes(self, dev, b, t, form):
        from triad_tpu_torch.ops.frontend import conv0_norm_gelu, conv0_norm_gelu_plain

        wave, w0, scale, bias = _conv0_case(dev, b, t)
        got = conv0_norm_gelu(wave, w0, scale, bias, form)
        torch.cuda.synchronize()
        assert got.shape == (b, (t - 10) // 5 + 1, 512) and got.is_contiguous()
        # the twin a few rows at a time (its fp32 intermediates at B = 64,
        # 20 s take 8 GB each)
        err = mx = 0.0
        for r in range(0, b, 8):
            ref = conv0_norm_gelu_plain(wave[r:r + 8], w0, scale[r:r + 8], bias[r:r + 8], form)
            e, m = _max_err(got[r:r + 8], ref)
            err, mx = max(err, e), max(mx, m)
            del ref
        assert err <= self.CONV0_TOL * mx, (err, mx)

    def test_strided_waveform_views(self, dev):
        """Truncated views (T % 10 != 0, as the stack passes it) with a
        batch stride of two rows, one of them starting 7 samples into its
        row: both kernels read them in place and return what they return
        for a contiguous copy, bit for bit."""
        from triad_tpu_torch.ops.frontend import conv0_norm_gelu, conv0_stats

        _, w0, scale, bias = _conv0_case(dev, 3, 400)
        full = _randn((3, 2, 80007), dev, 22, dtype=torch.float32)
        for view in (full[:, 0, :80000], full[:, 1, 7:]):
            assert not view.is_contiguous()
            copy = view.contiguous()
            for x, y in zip(conv0_stats(view, w0), conv0_stats(copy, w0)):
                assert torch.equal(x, y)
            for form in ("tanh", "erf"):
                assert torch.equal(conv0_norm_gelu(view, w0, scale, bias, form),
                                   conv0_norm_gelu(copy, w0, scale, bias, form))

    @pytest.mark.parametrize("b", [1, 64])
    def test_repeat_bit_for_bit(self, dev, b):
        """No atomics: two calls of each kernel return the same bits."""
        from triad_tpu_torch.ops.frontend import conv0_norm_gelu, conv0_stats

        wave, w0, scale, bias = _conv0_case(dev, b, 160000)
        first, second = conv0_stats(wave, w0), conv0_stats(wave, w0)
        assert all(torch.equal(x, y) for x, y in zip(first, second))
        assert torch.equal(conv0_norm_gelu(wave, w0, scale, bias, "tanh"),
                           conv0_norm_gelu(wave, w0, scale, bias, "tanh"))

    @pytest.mark.parametrize("b,t", [(8, 160000), (1, 12345)])
    def test_stack(self, dev, b, t):
        from triad_tpu_torch.ops.frontend import frontend, num_tokens, reference_frontend

        w0, gs, gb, ws = _frontend_weights(dev)
        wave = _randn((b, t), dev, 13, dtype=torch.float32)
        got = frontend(wave, w0, gs, gb, ws, "tanh")
        torch.cuda.synchronize()
        ref = reference_frontend(wave, w0, gs, gb, ws, "tanh")
        assert got.shape == ref.shape == (b, num_tokens(t), 512)
        # 7 layers, each rounding to bf16: a flip early moves later
        # values by ~1 ulp; bound 4 bf16 ulps of the max, mean far lower.
        err, mx = _max_err(got, ref)
        assert err <= 4 * 2.0 ** -7 * mx, (err, mx)
        assert float((got.float() - ref.float()).abs().mean()) <= 2.0 ** -7 * mx / 16

    def test_nan_culprit_rows(self, dev):
        """The audio rows behind the TPU rounds' GroupNorm NaN
        (docs/evidence/nan_culprit_audio_rows.npz) through the kernels: the
        stats positive and within an fp32 ulp (1e-6) of the Gram twin."""
        import os

        from triad_tpu_torch.models.hubert import normalize_waveform
        from triad_tpu_torch.ops.frontend import conv0_stats, conv0_stats_gram_plain, frontend

        path = os.path.join(os.path.dirname(__file__), "..", "docs", "evidence",
                            "nan_culprit_audio_rows.npz")
        wave = normalize_waveform(torch.from_numpy(np.load(path)["av_audio"]).to(dev))
        w0, gs, gb, ws = _frontend_weights(dev)
        mean, var = conv0_stats(wave, w0)
        out = frontend(wave, w0, gs, gb, ws, "tanh")
        torch.cuda.synchronize()
        assert float(var.min()) > 0.0
        rm, rv = conv0_stats_gram_plain(wave, w0)
        assert float((mean - rm).abs().max()) <= 1e-6 * float(rv.sqrt().max())
        assert float((var - rv).abs().max()) <= 1e-6 * float(rv.max())
        assert bool(torch.isfinite(out.float()).all())


class TestAttentionTrain:
    # Forward: both round the same fp32 P to bf16; an fp32 summation-order
    # difference can flip one rounding, ~1 ulp of one term. Backward: the
    # kernels carry the fp32 P and dS as bf16 hi + lo halves (~2^-16
    # relative) and sum in another order; each output rounds once to
    # bf16. Both: 2 bf16 ulps of the largest output.
    TOL = 2 * 2.0 ** -7

    @pytest.mark.parametrize("b,n", [(8, 261), (2, 37), (1, 512)])
    def test_fwd_bwd(self, dev, b, n):
        from triad_tpu_torch.ops import attention as A

        q, k, v, do = (_randn((b, n, 768), dev, s) for s in (21, 22, 23, 24))
        mask = torch.ones((b, n), device=dev)
        mask[0, 3] = 0.0          # one masked key
        mask[-1, n // 2:] = 0.0   # a ragged key tail
        if b == 2:
            mask[1] = 0.0         # a fully masked row: uniform weights
        got, saved = A.attention_train_fwd(q, k, v, mask, 0.125)
        torch.cuda.synchronize()
        err, mx = _max_err(got, A.attention_train_plain(q, k, v, mask, 0.125))
        assert err <= self.TOL * mx, ("fwd", err, mx)
        grads = A.attention_train_bwd(q, k, v, mask, do, 0.125, saved=saved)
        torch.cuda.synchronize()
        refs = A.attention_train_bwd_plain(q, k, v, mask, do, 0.125)
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            err, mx = _max_err(g, r)
            assert err <= self.TOL * mx, (name, err, mx)

    def test_mask_forms(self, dev):
        """The wrappers take the key mask in any dtype and on any device,
        as attention_train does: a bool mask on the CPU gives the fp32
        mask's result on the card."""
        from triad_tpu_torch.ops import attention as A

        q, k, v, do = (_randn((2, 37, 128), dev, s) for s in (41, 42, 43, 44))
        mask = torch.ones((2, 37), device=dev)
        mask[1, 20:] = 0.0
        bool_mask = mask.bool().cpu()
        out_b, st_b = A.attention_train_fwd(q, k, v, bool_mask, 0.125)
        out, st = A.attention_train_fwd(q, k, v, mask, 0.125)
        assert torch.equal(out_b, out) and all(map(torch.equal, st_b, st))
        for g, r in zip(A.attention_train_bwd(q, k, v, bool_mask, do, 0.125, saved=st_b),
                        A.attention_train_bwd(q, k, v, mask, do, 0.125, saved=st)):
            assert torch.equal(g, r)

    def test_autograd_counts_launches(self, dev):
        from triad_tpu_torch import kernels
        from triad_tpu_torch.ops.attention import attention_train

        q, k, v = (_randn((2, 37, 128), dev, s).requires_grad_() for s in (25, 26, 27))
        kernels.reset_launches()
        attention_train(q, k, v).float().sum().backward()
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["attention_train"] == 1
        assert kernels.LAUNCHES["attention_train_bwd"] == 1
        assert q.grad.shape == q.shape and bool(torch.isfinite(q.grad.float()).all())


class TestMlpBwd:
    # dh rounds to bf16 from an fp32 dg summed in another order (a flipped
    # rounding moves one element by 1 ulp); dx sums 3072 bf16(dh) W1
    # products. 2 bf16 ulps of each output's largest magnitude.
    TOL = 2 * 2.0 ** -7

    @pytest.mark.parametrize("m", [8 * 261, 45, 1, 127, 129, 64 * 499])
    @pytest.mark.parametrize("form", ["tanh", "erf"])
    def test_matches_plain(self, dev, m, form):
        from triad_tpu_torch.ops.mlp import fused_mlp_bwd, fused_mlp_bwd_plain

        x = _randn((m, 768), dev, 31)
        w1 = _randn((3072, 768), dev, 32, 768 ** -0.5)
        b1 = _randn((3072,), dev, 33, 0.1)
        w2 = _randn((768, 3072), dev, 34, 3072 ** -0.5)
        dy = _randn((m, 768), dev, 35)
        got = fused_mlp_bwd(x, w1, b1, w2, dy, form)
        torch.cuda.synchronize()
        for name, g, r in zip(("dx", "dh", "g"), got, fused_mlp_bwd_plain(x, w1, b1, w2, dy, form)):
            err, mx = _max_err(g, r)
            assert err <= self.TOL * mx, (name, err, mx)


class TestAttentionTrainDropout:
    # As TestAttentionTrain: the kernels and the twin draw the same keep
    # mask (ops/dropout.py), so dropout changes no rounding point; a kernel
    # that drew or replayed another mask would miss by whole values. 2 bf16
    # ulps of the largest output.
    TOL = 2 * 2.0 ** -7

    @pytest.mark.parametrize("b,n", [(8, 499), (2, 37)])
    @pytest.mark.parametrize("p", [0.0, 0.1])
    def test_fwd_bwd(self, dev, b, n, p):
        from triad_tpu_torch.ops import attention as A

        q, k, v, do = (_randn((b, n, 768), dev, s) for s in (51, 52, 53, 54))
        keys = torch.ones((b, n), device=dev)
        got, saved = A.attention_train_fwd(q, k, v, keys, 0.125, 1234, p)
        torch.cuda.synchronize()
        err, mx = _max_err(got, A.attention_train_plain(q, k, v, keys, 0.125, 1234, p))
        assert err <= self.TOL * mx, ("fwd", err, mx)
        grads = A.attention_train_bwd(q, k, v, keys, do, 0.125, 1234, p, saved)
        torch.cuda.synchronize()
        refs = A.attention_train_bwd_plain(q, k, v, keys, do, 0.125, 1234, p)
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            err, mx = _max_err(g, r)
            assert err <= self.TOL * mx, (name, err, mx)


class TestMlpDropout:
    # As TestMlp / TestMlpBwd, with the same keep mask in both. 2 bf16
    # ulps of each output's largest magnitude.
    TOL = 2 * 2.0 ** -7

    @pytest.mark.parametrize("m", [8 * 499, 45, 1, 127, 129, 64 * 499])
    @pytest.mark.parametrize("form", ["tanh", "erf"])
    def test_fwd_bwd(self, dev, m, form):
        from triad_tpu_torch.ops import mlp as M

        x, dy = _randn((m, 768), dev, 61), _randn((m, 768), dev, 62)
        w1 = _randn((3072, 768), dev, 63, 768 ** -0.5)
        b1 = _randn((3072,), dev, 64, 0.1)
        w2 = _randn((768, 3072), dev, 65, 3072 ** -0.5)
        b2 = _randn((768,), dev, 66, 0.1)
        got = M.fused_mlp(x, w1, b1, w2, b2, form, 77, 0.1)
        torch.cuda.synchronize()
        err, mx = _max_err(got, M.fused_mlp_plain(x, w1, b1, w2, b2, form, 77, 0.1))
        assert err <= self.TOL * mx, ("y", err, mx)
        got = M.fused_mlp_bwd(x, w1, b1, w2, dy, form, 77, 0.1)
        torch.cuda.synchronize()
        for name, g, r in zip(("dx", "dh", "g"), got,
                              M.fused_mlp_bwd_plain(x, w1, b1, w2, dy, form, 77, 0.1)):
            err, mx = _max_err(g, r)
            assert err <= self.TOL * mx, (name, err, mx)


class TestLayerNorm:
    # y, dx, dh round once to bf16 from fp32 values that differ only in
    # summation order: 2 bf16 ulps of the largest magnitude. dscale and
    # dbias are fp32 sums over the rows in another order: 1e-4 of max.
    TOL = 2 * 2.0 ** -7

    @pytest.mark.parametrize("m", [8 * 499, 45])
    @pytest.mark.parametrize("p", [0.0, 0.1])
    def test_fwd_bwd(self, dev, m, p):
        from triad_tpu_torch.ops import layernorm as L

        x, h, dy = (_randn((m, 768), dev, s) for s in (71, 72, 73))
        scale = _randn((768,), dev, 74, 0.2, torch.float32) + 1.0
        bias = _randn((768,), dev, 75, 0.1, torch.float32)
        got = L.dropout_add_ln(x, h, scale, bias, 1e-5, 99, p)
        torch.cuda.synchronize()
        err, mx = _max_err(got, L.dropout_add_ln_plain(x, h, scale, bias, 1e-5, 99, p))
        assert err <= self.TOL * mx, ("y", err, mx)
        got = L.dropout_add_ln_bwd(x, h, scale, dy, 1e-5, 99, p)
        torch.cuda.synchronize()
        refs = L.dropout_add_ln_bwd_plain(x, h, scale, dy, 1e-5, 99, p)
        for name, g, r, tol in zip(("dx", "dh", "dscale", "dbias"), got, refs,
                                   (self.TOL, self.TOL, 1e-4, 1e-4)):
            err, mx = _max_err(g, r)
            assert err <= tol * mx, (name, err, mx)


class TestDropoutAtBatchOffset:
    """The three dropout kernels for batch rows b0 = 32 .. 39 of a global
    batch (a data-parallel rank's rows): outputs against the twins at the
    same b0 (2 bf16 ulps, as above), the keep masks bit for bit, and
    another mask than at b0 = 0."""

    TOL = 2 * 2.0 ** -7
    B0 = 32

    def test_attention(self, dev):
        from triad_tpu_torch.ops import attention as A

        b, n = 8, 499
        q, k, v, do = (_randn((b, n, 768), dev, s) for s in (81, 82, 83, 84))
        keys = torch.ones((b, n), device=dev)
        got, saved = A.attention_train_fwd(q, k, v, keys, 0.125, 1234, 0.1, self.B0)
        err, mx = _max_err(got, A.attention_train_plain(q, k, v, keys, 0.125, 1234, 0.1,
                                                        self.B0))
        assert err <= self.TOL * mx, ("fwd", err, mx)
        grads = A.attention_train_bwd(q, k, v, keys, do, 0.125, 1234, 0.1, saved, self.B0)
        refs = A.attention_train_bwd_plain(q, k, v, keys, do, 0.125, 1234, 0.1, self.B0)
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            err, mx = _max_err(g, r)
            assert err <= self.TOL * mx, (name, err, mx)
        # the mask itself: q = k = 0 gives P = 1 / 64, and V_h = I makes
        # each head's output the dropped D = P keep / (1 - p).
        zeros = torch.zeros((b, 64, 768), device=dev, dtype=torch.bfloat16)
        eye = torch.eye(64, device=dev, dtype=torch.bfloat16).repeat(b, 1, 12)
        d, _ = A.attention_train_fwd(zeros, zeros, eye, torch.ones((b, 64), device=dev), 0.125,
                                     1234, 0.1, self.B0)
        kept = d.reshape(b, 64, 12, 64).permute(0, 2, 1, 3) != 0
        keep = A.attention_keep(b, 12, 64, 64, 1234, 0.1, dev, self.B0)
        assert torch.equal(kept, keep)
        assert not torch.equal(keep, A.attention_keep(b, 12, 64, 64, 1234, 0.1, dev))

    def test_mlp(self, dev):
        from triad_tpu_torch.ops import mlp as M

        x, dy = _randn((8, 499, 768), dev, 85), _randn((8, 499, 768), dev, 86)
        w1 = _randn((3072, 768), dev, 87, 768 ** -0.5)
        b1 = _randn((3072,), dev, 88, 0.1)
        w2 = _randn((768, 3072), dev, 89, 3072 ** -0.5)
        b2 = _randn((768,), dev, 90, 0.1)
        got = M.fused_mlp(x, w1, b1, w2, b2, "tanh", 77, 0.1, self.B0)
        err, mx = _max_err(got, M.fused_mlp_plain(x, w1, b1, w2, b2, "tanh", 77, 0.1, self.B0))
        assert err <= self.TOL * mx, ("y", err, mx)
        got = M.fused_mlp_bwd(x, w1, b1, w2, dy, "tanh", 77, 0.1, self.B0)
        refs = M.fused_mlp_bwd_plain(x, w1, b1, w2, dy, "tanh", 77, 0.1, self.B0)
        for name, g, r in zip(("dx", "dh", "g"), got, refs):
            err, mx = _max_err(g, r)
            assert err <= self.TOL * mx, (name, err, mx)
        keep = M.mlp_keep(8 * 499, 3072, 77, 0.1, dev, self.B0 * 499).reshape(8, 499, 3072)
        assert torch.equal(got[2] != 0, keep & (refs[2] != 0))  # g: the dropped GELU
        assert not torch.equal(keep, M.mlp_keep(8 * 499, 3072, 77, 0.1, dev).reshape(keep.shape))

    def test_layernorm(self, dev):
        from triad_tpu_torch.ops import layernorm as L

        x, h, dy = (_randn((8, 499, 768), dev, s) for s in (91, 92, 93))
        scale = _randn((768,), dev, 94, 0.2, torch.float32) + 1.0
        bias = _randn((768,), dev, 95, 0.1, torch.float32)
        got = L.dropout_add_ln(x, h, scale, bias, 1e-5, 99, 0.1, self.B0)
        err, mx = _max_err(got, L.dropout_add_ln_plain(x, h, scale, bias, 1e-5, 99, 0.1,
                                                       self.B0))
        assert err <= self.TOL * mx, ("y", err, mx)
        got = L.dropout_add_ln_bwd(x, h, scale, dy, 1e-5, 99, 0.1, self.B0)
        refs = L.dropout_add_ln_bwd_plain(x, h, scale, dy, 1e-5, 99, 0.1, self.B0)
        for name, g, r, tol in zip(("dx", "dh", "dscale", "dbias"), got, refs,
                                   (self.TOL, self.TOL, 1e-4, 1e-4)):
            err, mx = _max_err(g, r)
            assert err <= tol * mx, (name, err, mx)
        keep = L.ln_keep(8 * 499, 768, 99, 0.1, dev, self.B0 * 499).reshape(x.shape)
        assert torch.equal(got[1] != 0, keep & (refs[1] != 0))  # dh: the dropped ds
        assert not torch.equal(keep, L.ln_keep(8 * 499, 768, 99, 0.1, dev).reshape(x.shape))


class TestPosConv:
    # Forward and dX: exact bf16 products summed in fp32 (6144 terms per
    # output) in another order, one rounding to bf16: 2 bf16 ulps of max.
    # dW: fp32 sums over every row in another order: 1e-4 of max.
    TOL = 2 * 2.0 ** -7

    @pytest.mark.parametrize("b,n", [(2, 499), (1, 24)])
    def test_fwd_dx_dw(self, dev, b, n):
        from triad_tpu_torch.ops import posconv as P

        x, dz = _randn((b, n, 768), dev, 81), _randn((b, n, 768), dev, 82)
        w = _randn((768, 48, 128), dev, 83, (48 * 128) ** -0.5)
        bias = _randn((768,), dev, 84, 0.1, torch.float32)
        for act in ("erf", "id"):
            got = P.pos_conv(x, w, bias, 16, act)
            torch.cuda.synchronize()
            err, mx = _max_err(got, P.pos_conv_plain(x, w, bias, 16, act))
            assert err <= self.TOL * mx, (act, err, mx)
        got = P.pos_conv_dx(dz, w, 16)
        torch.cuda.synchronize()
        err, mx = _max_err(got, P.pos_conv_dx_plain(dz, w, 16))
        assert err <= self.TOL * mx, ("dx", err, mx)
        got = P.pos_conv_dw(x, dz, 16, 128)
        torch.cuda.synchronize()
        err, mx = _max_err(got, P.pos_conv_dw_plain(x, dz, 16, 128))
        assert err <= 1e-4 * mx, ("dw", err, mx)

    # dW alone at the shapes its design has edges at: one block per (16
    # taps, group) reduces every row in 128-row tiles, so a batch of any
    # size, a last tile that N does not fill, N < K (every x window partly
    # outside [0, N)), N = 1, K not a multiple of 16 (a block whose last
    # taps are past K), and the train steps' (64, 499).
    @pytest.mark.parametrize("b,n,k", [(1, 24, 128), (2, 499, 128), (3, 499, 128), (7, 130, 128),
                                       (2, 37, 128), (1, 1, 128), (64, 499, 128), (2, 61, 24)])
    def test_dw(self, dev, b, n, k):
        from triad_tpu_torch.ops import posconv as P

        x, dz = _randn((b, n, 768), dev, 87), _randn((b, n, 768), dev, 88)
        got = P.pos_conv_dw(x, dz, 16, k)
        torch.cuda.synchronize()
        err, mx = _max_err(got, P.pos_conv_dw_plain(x, dz, 16, k))
        assert got.shape == (768, 48, k)
        assert err <= 1e-4 * mx, (err, mx)

    # Forward and dX at the edges of the kernel's 512-row pieces and 64-row
    # tiles: N = 1, N < K, one row either side of a tile, HuBERT's 499 at
    # the train steps' B = 64, and 20 s clips (N = 1000: two pieces).
    @pytest.mark.parametrize("b,n", [(1, 1), (3, 40), (1, 127), (3, 128), (1, 129),
                                     (64, 499), (3, 1000)])
    def test_fwd_dx_shapes(self, dev, b, n):
        from triad_tpu_torch.ops import posconv as P

        x, dz = _randn((b, n, 768), dev, 91), _randn((b, n, 768), dev, 92)
        w = _randn((768, 48, 128), dev, 93, (48 * 128) ** -0.5)
        bias = _randn((768,), dev, 94, 0.1, torch.float32)
        for act, bb in (("erf", bias), ("id", bias), ("id", None)):
            got = P.pos_conv(x, w, bb, 16, act)
            torch.cuda.synchronize()
            err, mx = _max_err(got, P.pos_conv_plain(x, w, bb, 16, act))
            assert err <= self.TOL * mx, (act, bb is None, err, mx)
        got = P.pos_conv_dx(dz, w, 16)
        torch.cuda.synchronize()
        err, mx = _max_err(got, P.pos_conv_dx_plain(dz, w, 16))
        assert err <= self.TOL * mx, ("dx", err, mx)

    def test_fwd_is_deterministic(self, dev):
        """One fixed order per sum: the forward twice gives bit-equal
        outputs."""
        from triad_tpu_torch.ops import posconv as P

        x = _randn((7, 499, 768), dev, 95)
        w = _randn((768, 48, 128), dev, 96, (48 * 128) ** -0.5)
        first, second = (P.pos_conv(x, w, None, 16, "erf") for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(first, second)

    def test_dw_is_deterministic(self, dev):
        """No atomics, one fixed order per sum: the same call twice gives
        bit-equal dW."""
        from triad_tpu_torch.ops import posconv as P

        x, dz = _randn((7, 499, 768), dev, 89), _randn((7, 499, 768), dev, 90)
        first = P.pos_conv_dw(x, dz, 16, 128)
        second = P.pos_conv_dw(x, dz, 16, 128)
        torch.cuda.synchronize()
        assert torch.equal(first, second)

    def test_autograd_counts_launches(self, dev):
        from triad_tpu_torch import kernels
        from triad_tpu_torch.ops.posconv import pos_conv_gelu

        x = _randn((2, 37, 768), dev, 85).requires_grad_()
        w = _randn((768, 48, 128), dev, 86, 0.01).requires_grad_()
        bias = torch.zeros(768, device=dev, requires_grad=True)
        kernels.reset_launches()
        pos_conv_gelu(x, w, bias, 16).float().sum().backward()
        torch.cuda.synchronize()
        assert [kernels.LAUNCHES[k] for k in ("posconv", "posconv_dx", "posconv_dw")] == [1, 1, 1]
        assert bool(torch.isfinite(w.grad.float()).all()) and x.grad.shape == x.shape


class TestAttentionLayouts:
    # The strided, packed and merged layouts are three sets of strides to
    # the same kernels with the same keep mask (seed, b * H + h, query,
    # key): on the same values and seed they agree bit for bit, forward and
    # backward. Against the twin: 2 bf16 ulps of the largest output, as
    # TestAttentionTrain.
    TOL = 2 * 2.0 ** -7

    @pytest.mark.parametrize("b,n,p", [(2, 37, 0.1), (4, 499, 0.1), (3, 261, 0.0)])
    def test_layouts_agree(self, dev, b, n, p):
        from triad_tpu_torch.ops import attention as A

        qkv, do = _randn((b, n, 2304), dev, 61), _randn((b, n, 768), dev, 62)
        q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
        heads = lambda t: t.view(b, n, 12, 64).transpose(1, 2)  # noqa: E731
        unheads = lambda t: t.transpose(1, 2).reshape(b, n, 768)  # noqa: E731
        mask = torch.ones((b, n), device=dev)
        packed, saved = A.attention_train_fwd(q, k, v, mask, 0.125, 77, p)
        strided, _ = A.attention_train_strided_fwd(heads(q), heads(k), heads(v), mask, 0.125, 77,
                                                   p)
        merged, _ = A.attention_train_merged_fwd(qkv, mask, 0.125, 77, p)
        torch.cuda.synchronize()
        assert torch.equal(unheads(strided), packed) and torch.equal(merged, packed)
        err, mx = _max_err(merged, A.attention_train_merged_plain(qkv, mask, 0.125, 77, p))
        assert err <= self.TOL * mx, ("fwd", err, mx)
        g_packed = A.attention_train_bwd(q, k, v, mask, do, 0.125, 77, p, saved)
        g_strided = A.attention_train_strided_bwd(heads(q), heads(k), heads(v), mask, heads(do),
                                                  0.125, 77, p, saved=saved)
        g_merged = A.attention_train_merged_bwd(qkv, mask, do, 0.125, 77, p, saved)
        torch.cuda.synchronize()
        assert torch.equal(torch.cat(g_packed, dim=-1), g_merged)
        assert all(torch.equal(unheads(s), g) for s, g in zip(g_strided, g_packed))
        ref = A.attention_train_merged_bwd_plain(qkv, mask, do, 0.125, 77, p)
        for name, g, r in zip(("dq", "dk", "dv"), g_merged.chunk(3, -1), ref.chunk(3, -1)):
            err, mx = _max_err(g, r)
            assert err <= self.TOL * mx, (name, err, mx)

    def test_strided_takes_any_strides(self, dev):
        """A contiguous (B, H, T, 64) tensor and a permuted view of (B, T,
        H, 64) projections give the same values; the output and gradients
        come as views of (B, T, H, 64) memory either way; a key mask is
        honoured."""
        from triad_tpu_torch.ops import attention as A

        q, k, v, do = (_randn((2, 45, 4, 64), dev, s) for s in (63, 64, 65, 66))
        mask = torch.ones((2, 45), device=dev)
        mask[1, 30:] = 0.0
        views = [t.transpose(1, 2) for t in (q, k, v, do)]
        dense = [t.contiguous() for t in views]
        out_v, st_v = A.attention_train_strided_fwd(*views[:3], mask, 0.125)
        out_d, st_d = A.attention_train_strided_fwd(*dense[:3], mask, 0.125)
        assert out_v.stride() == out_d.stride() == views[0].stride()
        assert torch.equal(out_v, out_d) and all(map(torch.equal, st_v, st_d))
        gv = A.attention_train_strided_bwd(*views[:3], mask, views[3], 0.125, saved=st_v)
        gd = A.attention_train_strided_bwd(*dense[:3], mask, dense[3], 0.125, saved=st_d)
        assert all(torch.equal(a, b) and a.stride() == views[0].stride() for a, b in zip(gv, gd))
        err, mx = _max_err(out_v, A.heads_train_plain(*views[:3], mask, 0.125).to(q.dtype))
        assert err <= self.TOL * mx, (err, mx)

    def test_autograd_counts_launches(self, dev):
        from triad_tpu_torch import kernels
        from triad_tpu_torch.ops.attention import attention_train_merged, attention_train_strided

        qkv = _randn((2, 37, 384), dev, 67).requires_grad_()
        q, k, v = (_randn((2, 2, 37, 64), dev, s).requires_grad_() for s in (68, 69, 70))
        kernels.reset_launches()
        attention_train_merged(qkv, None, 5, 0.1).float().sum().backward()
        attention_train_strided(q, k, v, None, 5, 0.1).float().sum().backward()
        torch.cuda.synchronize()
        for name in ("attention_train_merged", "attention_train_merged_bwd",
                     "attention_train_strided", "attention_train_strided_bwd"):
            assert kernels.LAUNCHES[name] == 1, name
        assert qkv.grad.shape == qkv.shape and bool(torch.isfinite(qkv.grad.float()).all())
        assert q.grad.shape == q.shape and bool(torch.isfinite(q.grad.float()).all())


class TestAttentionTrainAnyLength:
    """The training kernels at any N (nothing in them scales with N, so no
    key cap): against their twins, the three layouts bit-equal, what the
    forward saves (the (2, B, H, N) row stats) against
    train_row_stats_plain, and two identical calls bit-equal. Tolerances
    as TestAttentionTrain (2 bf16 ulps of the largest output); the row
    stats are fp32 sums in another order (1e-5 relative)."""

    TOL = 2 * 2.0 ** -7

    @pytest.mark.parametrize("n", [1, 63, 64, 65, 128, 261, 499, 512, 513, 1000, 1024])
    @pytest.mark.parametrize("p", [0.0, 0.1])
    def test_layouts_match_twin(self, dev, n, p):
        from triad_tpu_torch.ops import attention as A

        b, h = 2, 4
        c = h * 64
        qkv, do = _randn((b, n, 3 * c), dev, 71), _randn((b, n, c), dev, 72)
        q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
        heads = lambda t: t.view(b, n, h, 64).transpose(1, 2)  # noqa: E731
        unheads = lambda t: t.transpose(1, 2).reshape(b, n, c)  # noqa: E731
        mask = torch.ones((b, n), device=dev)
        mask[0, n // 3] = 0.0 if n > 1 else 1.0  # one masked key
        mask[1, n // 2:] = 0.0                    # a ragged tail (all keys at n = 1)
        packed, saved = A.attention_train_fwd(q, k, v, mask, 0.125, 77, p)
        strided, st_s = A.attention_train_strided_fwd(heads(q), heads(k), heads(v), mask, 0.125,
                                                      77, p)
        merged, st_m = A.attention_train_merged_fwd(qkv, mask, 0.125, 77, p)
        again, _ = A.attention_train_fwd(q, k, v, mask, 0.125, 77, p)
        torch.cuda.synchronize()
        assert torch.equal(unheads(strided), packed) and torch.equal(merged, packed)
        assert torch.equal(again, packed)
        assert torch.equal(st_s, saved) and torch.equal(st_m, saved)
        err, mx = _max_err(packed, A.attention_train_plain(q, k, v, mask, 0.125, 77, p))
        assert err <= self.TOL * mx, ("fwd", err, mx)
        torch.testing.assert_close(saved, A.train_row_stats_plain(heads(q), heads(k), mask, 0.125),
                                   rtol=1e-5, atol=1e-5)
        g_packed = torch.cat(A.attention_train_bwd(q, k, v, mask, do, 0.125, 77, p, saved), -1)
        g_strided = torch.cat([unheads(g) for g in A.attention_train_strided_bwd(
            heads(q), heads(k), heads(v), mask, heads(do), 0.125, 77, p, saved=saved)], -1)
        g_merged = A.attention_train_merged_bwd(qkv, mask, do, 0.125, 77, p, saved)
        g_again = A.attention_train_merged_bwd(qkv, mask, do, 0.125, 77, p, saved)
        torch.cuda.synchronize()
        assert torch.equal(g_strided, g_packed) and torch.equal(g_merged, g_packed)
        assert torch.equal(g_again, g_merged)
        refs = A.attention_train_merged_bwd_plain(qkv, mask, do, 0.125, 77, p)
        for name, g, r in zip(("dq", "dk", "dv"), g_merged.chunk(3, -1), refs.chunk(3, -1)):
            err, mx = _max_err(g, r)
            assert err <= self.TOL * mx, (name, err, mx)

    @pytest.mark.parametrize("n", [37, 1000])
    def test_fully_masked_row_is_uniform(self, dev, n):
        from triad_tpu_torch.ops import attention as A

        q, k, v = (_randn((2, n, 128), dev, s) for s in (73, 74, 75))
        mask = torch.ones((2, n), device=dev)
        mask[1] = 0.0
        got, _ = A.attention_train_fwd(q, k, v, mask, 0.125)
        want = v[1].float().mean(dim=0, keepdim=True).expand(n, -1)
        err, mx = _max_err(got[1], want)
        assert err <= self.TOL * mx, (err, mx)

    def test_backward_needs_what_the_forward_saved(self, dev):
        from triad_tpu_torch.ops import attention as A

        q, k, v, do = (_randn((1, 37, 64), dev, s) for s in (76, 77, 78, 79))
        with pytest.raises(ValueError, match="forward saved"):
            A.attention_train_bwd(q, k, v, None, do, 0.125)


def _grid(shape, dev, seed, dtype=torch.bfloat16):
    """Values k / 4 for integers k in [-4, 4]: exact in bf16, and every sum
    of 512 products of two of them is exact in fp32 in any order, so the
    kernels and the twin see the same sims bit for bit (same maxima, same
    first argmax on ties, same clamp window)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-4, 5, size=shape).astype(np.float32) / 4).to(dev, dtype)


class TestMaxMean:
    # Sims are exact on _grid inputs; the clip sums and the clamp^2 / window
    # sums are fp32 sums in another order; dQ and dK take dts as bf16 hi +
    # lo halves (~2^-17 relative) and sum in another order: 1e-4 of each
    # output's largest magnitude.
    TOL = 1e-4

    @pytest.mark.parametrize("bq,bk,nq,nk,d,masked", [(3, 2, 37, 128, 128, True),
                                                      (4, 3, 499, 256, 512, False),
                                                      (5, 4, 32, 256, 512, True)])
    def test_matches_plain(self, dev, bq, bk, nq, nk, d, masked):
        from triad_tpu_torch.ops import maxmean as MM

        q, k = _grid((bq, nq, d), dev, 71), _grid((bk, nk, d), dev, 72)
        mask = None
        if masked:
            mask = torch.ones((bq, nq), device=dev)
            mask[0, nq // 2:] = 0.0
        coeff = MM.coefficients(bq, nq, mask, dev)
        temp = torch.tensor(1.5, device=dev)
        got = MM.maxmean_fwd(q, k, temp, coeff, -20.0)
        ref = MM.maxmean_plain(q, k, temp, coeff, -20.0)
        torch.cuda.synchronize()
        assert torch.equal(got[3], ref[3])  # the first argmax of every row
        for name, g, r in zip(("clip", "nonneg", "tsq"), got[:3], ref[:3]):
            err, mx = _max_err(g, r)
            assert err <= self.TOL * mx, (name, err, mx)
        g_clip = _randn((bq, bk), dev, 73, dtype=torch.float32)
        g_nn = torch.tensor(0.37, device=dev)
        args = (q, k, temp, coeff, -20.0, ref[3], g_clip, g_nn)
        refs = MM.maxmean_dq_plain(*args), MM.maxmean_dk_plain(*args)
        for name, g, r in zip(("dq", "dk"), (MM.maxmean_dq(*args), MM.maxmean_dk(*args)), refs):
            err, mx = _max_err(g, r)
            assert err <= self.TOL * mx, (name, err, mx)

    def test_fp32_features_split(self, dev):
        """fp32 features run as bf16 hi + lo halves: sims at fp32 level, not
        bf16 (a bf16-rounded run would miss by ~1e-3 of the largest clip)."""
        from triad_tpu_torch.ops import maxmean as MM

        q = _randn((2, 40, 128), dev, 74, 0.3, torch.float32)
        k = _randn((3, 128, 128), dev, 75, 0.3, torch.float32)
        coeff = MM.coefficients(2, 40, None, dev)
        temp = torch.tensor(1.5, device=dev)
        got, ref = MM.maxmean_fwd(q, k, temp, coeff, -2.0), MM.maxmean_plain(q, k, temp, coeff, -2.0)
        for name, g, r in zip(("clip", "nonneg"), got[:2], ref[:2]):
            err, mx = _max_err(g, r)
            assert err <= self.TOL * mx, (name, err, mx)
        args = (q, k, temp, coeff, -2.0, ref[3], _randn((2, 3), dev, 76, dtype=torch.float32),
                torch.tensor(0.5, device=dev))
        for name, g, r in zip(("dq", "dk"), (MM.maxmean_dq(*args), MM.maxmean_dk(*args)),
                              (MM.maxmean_dq_plain(*args), MM.maxmean_dk_plain(*args))):
            err, mx = _max_err(g, r)
            assert err <= self.TOL * mx, (name, err, mx)

    @staticmethod
    def _backward_case(dev, bq, bk, nq, nk, d, masked, seed):
        """The backward's arguments on _grid inputs, the twin's argmax."""
        from triad_tpu_torch.ops import maxmean as MM

        q, k = _grid((bq, nq, d), dev, seed), _grid((bk, nk, d), dev, seed + 1)
        mask = None
        if masked:
            mask = torch.ones((bq, nq), device=dev)
            mask[1::2, nq * 3 // 4:] = 0.0
        coeff = MM.coefficients(bq, nq, mask, dev)
        temp = torch.tensor(1.5, device=dev)
        amax = MM.maxmean_plain(q, k, temp, coeff, -20.0)[3]
        g_clip = _randn((bq, bk), dev, seed + 2, dtype=torch.float32)
        return q, k, temp, coeff, -20.0, amax, g_clip, torch.tensor(0.37, device=dev)

    @pytest.mark.parametrize("bq,bk,nq,nk,d,masked", [
        (2, 2, 1, 64, 64, False),      # one query row: 2 dQ row tiles, 2 dK key tiles
        (3, 2, 63, 128, 256, True),    # a row tile one short
        (3, 2, 65, 64, 512, False),    # one row past a tile
        (64, 64, 32, 256, 512, True),  # the TV loss's shape: 64 dQ row tiles, fewer than SMs
        (20, 36, 499, 256, 512, False),  # 160 dQ row tiles, 144 dK key tiles: more than SMs
        (2, 3, 40, 192, 192, True),    # D padded with a zero chunk
    ])
    def test_backward_shapes(self, dev, bq, bk, nq, nk, d, masked):
        """dQ and dK against the twins at ragged Nq (1, 63, 65, 499), the TV
        shape with a mask, D 64, 192, 256 and 512, and grids with fewer
        and more row tiles than the card has SMs."""
        from triad_tpu_torch.ops import maxmean as MM

        args = self._backward_case(dev, bq, bk, nq, nk, d, masked, 81)
        refs = MM.maxmean_dq_plain(*args), MM.maxmean_dk_plain(*args)
        for name, g, r in zip(("dq", "dk"), (MM.maxmean_dq(*args), MM.maxmean_dk(*args)), refs):
            torch.cuda.synchronize()
            err, mx = _max_err(g, r)
            assert err <= self.TOL * mx, (name, err, mx)

    @pytest.mark.parametrize("nq", [37, 499])
    def test_fp32_split_d512(self, dev, nq):
        """Split fp32 features at D = 512 (32-row streamed tiles, one ring
        stage): dQ and dK against the twins, fed the twin's argmax."""
        from triad_tpu_torch.ops import maxmean as MM

        q = _randn((3, nq, 512), dev, 84, 0.05, torch.float32)
        k = _randn((2, 128, 512), dev, 85, 0.05, torch.float32)
        coeff = MM.coefficients(3, nq, None, dev)
        temp = torch.tensor(1.5, device=dev)
        amax = MM.maxmean_plain(q, k, temp, coeff, -2.0)[3]
        args = (q, k, temp, coeff, -2.0, amax, _randn((3, 2), dev, 86, dtype=torch.float32),
                torch.tensor(0.5, device=dev))
        for name, g, r in zip(("dq", "dk"), (MM.maxmean_dq(*args), MM.maxmean_dk(*args)),
                              (MM.maxmean_dq_plain(*args), MM.maxmean_dk_plain(*args))):
            torch.cuda.synchronize()
            err, mx = _max_err(g, r)
            assert err <= self.TOL * mx, (name, err, mx)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_backward_repeats_bit_for_bit(self, dev, dtype):
        """No atomics, sums in a fixed order: two runs of dQ and of dK at
        the AV shape are bit-equal."""
        from triad_tpu_torch.ops import maxmean as MM

        args = list(self._backward_case(dev, 64, 64, 499, 256, 512, False, 87))
        args[:2] = [x.to(dtype) for x in args[:2]]
        for fn in (MM.maxmean_dq, MM.maxmean_dk):
            a, b = fn(*args), fn(*args)
            torch.cuda.synchronize()
            assert torch.equal(a, b), fn.__name__

    @pytest.mark.parametrize("bq,bk,nq,nk,d,masked,dtype", [
        (2, 3, 1, 64, 64, False, torch.bfloat16),     # one query row, D padded with a zero chunk
        (3, 2, 63, 256, 192, True, torch.bfloat16),   # a tile one row short, D 192
        (4, 5, 64, 1024, 512, False, torch.bfloat16),  # a whole tile, 16 key tiles a clip
        (5, 3, 65, 64, 512, True, torch.float32),     # split at D = 512: one item a block
        (3, 2, 499, 64, 192, False, torch.float32),   # split at D 192: two items a block
        (20, 37, 499, 256, 512, False, torch.bfloat16),  # 80 blocks: 4 ranges of 10, 10, 10, 7
        (64, 64, 32, 256, 512, True, torch.bfloat16),  # the TV loss: 8 ranges of 8 key clips
        (7, 13, 32, 128, 512, True, torch.bfloat16),  # 4 blocks: a range per key clip
    ])
    def test_forward_shapes(self, dev, bq, bk, nq, nk, d, masked, dtype):
        """The forward kernel against the twin at ragged Nq (1, 63, 65,
        499), whole tiles, Nk 64 to 1024, D 64, 192 and 512, Bq != Bk, a
        masked mean, split fp32 features, and key-clip ranges that do and
        do not divide Bk. _grid's sims are exact and tie often: the first
        argmax of every row equals the twin's."""
        from triad_tpu_torch.ops import maxmean as MM

        q, k = _grid((bq, nq, d), dev, 91, dtype), _grid((bk, nk, d), dev, 92, dtype)
        mask = None
        if masked:
            mask = torch.ones((bq, nq), device=dev)
            mask[1::2, nq * 3 // 4:] = 0.0
        coeff = MM.coefficients(bq, nq, mask, dev)
        temp = torch.tensor(1.5, device=dev)
        got = MM.maxmean_fwd(q, k, temp, coeff, -20.0)
        ref = MM.maxmean_plain(q, k, temp, coeff, -20.0)
        torch.cuda.synchronize()
        assert torch.equal(got[3], ref[3])
        for name, g, r in zip(("clip", "nonneg", "tsq"), got[:3], ref[:3]):
            err, mx = _max_err(g, r)
            assert err <= self.TOL * mx, (name, err, mx)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_forward_repeats_bit_for_bit(self, dev, dtype):
        """No atomics: two forward runs at the AV shape are bit-equal."""
        from triad_tpu_torch.ops import maxmean as MM

        q = _randn((64, 499, 512), dev, 88, 0.05, dtype)
        k = _randn((64, 256, 512), dev, 89, 0.05, dtype)
        coeff = MM.coefficients(64, 499, None, dev)
        temp = torch.tensor(10.0, device=dev)
        a, b = (MM.maxmean_fwd(q, k, temp, coeff, -60.0) for _ in range(2))
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x, y)

    def test_autograd_counts_launches(self, dev):
        from triad_tpu_torch import kernels
        from triad_tpu_torch.ops.similarity import aggregate_crossbatch

        q = _grid((2, 37, 128), dev, 77).requires_grad_()
        k = _grid((2, 128, 128), dev, 78).requires_grad_()
        temp = torch.tensor(1.5, device=dev, requires_grad=True)
        kernels.reset_launches()
        agg = aggregate_crossbatch(q, k, temp, clamp_min=-20.0, implementation="pallas")
        (agg.clip_sims.sum() + agg.nonneg_sq_sum).backward()
        torch.cuda.synchronize()
        for name in ("maxmean", "maxmean_dq", "maxmean_dk"):
            assert kernels.LAUNCHES[name] == 1, name
        assert q.grad.dtype == torch.bfloat16 and bool(torch.isfinite(temp.grad))


class TestPairAttention:
    # Both round the same fp32 e to bf16 and sum the rounded values; an
    # fp32 summation-order difference can flip an output rounding. 2 bf16
    # ulps of the output's largest magnitude.
    TOL = 2 * 2.0 ** -7

    @pytest.mark.parametrize("b,n,h,all_masked", [(8, 499, 12, False), (8, 128, 12, False),
                                                  (2, 37, 3, True), (1, 512, 12, False)])
    def test_packed(self, dev, b, n, h, all_masked):
        from triad_tpu_torch.ops.attention import attention_eval_pair, attention_eval_pair_plain

        q, k, v = (_randn((b, n, h * 64), dev, s) for s in (1, 2, 3))
        mask = torch.ones((b, n), device=dev)
        mask[-1, n // 2:] = 0.0
        if all_masked:
            mask[0] = 0.0  # the padded keys count in this row's softmax
        got = attention_eval_pair(q, k, v, mask)
        torch.cuda.synchronize()
        err, mx = _max_err(got, attention_eval_pair_plain(q, k, v, mask, 0.125))
        assert err <= self.TOL * mx, (err, mx)

    @pytest.mark.parametrize("b,n,h", [(8, 261, 12), (3, 70, 3)])
    def test_merged(self, dev, b, n, h):
        from triad_tpu_torch.ops.attention import (
            attention_eval_merged_pair,
            attention_eval_pair_plain,
        )

        qkv = _randn((b, n, 3 * h * 64), dev, 4)
        got = attention_eval_merged_pair(qkv)
        torch.cuda.synchronize()
        ref = attention_eval_pair_plain(*qkv.split(h * 64, dim=-1), torch.ones((b, n), device=dev),
                                        0.125)
        err, mx = _max_err(got, ref)
        assert err <= self.TOL * mx, (err, mx)


class TestFrontendConv:
    # Both round the same fp32 prologue to bf16 (the kernel without fma
    # contraction) and sum exact bf16 products in fp32 in another order,
    # then round once: 2 bf16 ulps of the output's largest magnitude.
    TOL = 2 * 2.0 ** -7

    def _inputs(self, dev, b, t, k, seed, t_alloc=None):
        x = _randn((b, t_alloc or t, 512), dev, seed)
        w = _randn((512, 512, k), dev, seed + 1, (2 / (k * 512)) ** 0.5, torch.float32)
        mean = _randn((b, 1, 512), dev, seed + 2, 0.3, torch.float32)
        rstd = _randn((b, 1, 512), dev, seed + 3, 0.2, torch.float32).abs() + 0.5
        scale = _randn((512,), dev, seed + 4, 0.3, torch.float32) + 1.0
        bias = _randn((512,), dev, seed + 5, 0.1, torch.float32)
        return x, w, mean, rstd, scale, bias

    @pytest.mark.parametrize("b,t,k,prologue", [(8, 31999, 3, "norm_gelu"), (8, 7999, 3, "gelu"),
                                                (8, 999, 2, "gelu"), (3, 77, 2, None)])
    def test_fused_conv(self, dev, b, t, k, prologue):
        from triad_tpu_torch.ops.frontend_conv import (
            fused_frontend_conv_fwd,
            fused_frontend_conv_plain,
        )

        args = self._inputs(dev, b, t, k, 20)
        got = fused_frontend_conv_fwd(*args, t, prologue)
        torch.cuda.synchronize()
        ref = fused_frontend_conv_plain(*args, t, prologue)
        assert got.shape == ref.shape
        err, mx = _max_err(got, ref)
        assert err <= self.TOL * mx, (err, mx)

    def test_fused_conv_logical_rows(self, dev):
        """A logical length inside a larger allocation: rows past it are
        never read (NaN there changes nothing)."""
        from triad_tpu_torch.ops.frontend_conv import (
            fused_frontend_conv_fwd,
            fused_frontend_conv_plain,
        )

        x, *rest = self._inputs(dev, 2, 101, 3, 30, t_alloc=140)
        x[:, 101:] = float("nan")
        got = fused_frontend_conv_fwd(x, *rest, 101, "norm_gelu")
        torch.cuda.synchronize()
        ref = fused_frontend_conv_plain(x, *rest, 101, "norm_gelu")
        assert bool(torch.isfinite(got.float()).all())
        err, mx = _max_err(got, ref)
        assert err <= self.TOL * mx, (err, mx)

    @pytest.mark.parametrize("act", ["gelu", "norm_gelu"])
    def test_activation(self, dev, act):
        from triad_tpu_torch.ops.frontend_conv import (
            frontend_activation_fwd,
            frontend_activation_plain,
        )

        x, _, mean, rstd, scale, bias = self._inputs(dev, 8, 31999, 3, 40)
        got = frontend_activation_fwd(x, mean, rstd, scale, bias, act)
        torch.cuda.synchronize()
        err, mx = _max_err(got, frontend_activation_plain(x, mean, rstd, scale, bias, act))
        # one rounding of the same fp32 value (erff against torch's erf)
        assert err <= 2.0 ** -7 * mx, (err, mx)

    # Ragged shapes: one row, a row count that a block's 16 rows do not
    # divide, and 768 channels (96 16-byte slots: a 192-thread block).
    @pytest.mark.parametrize("act", ["gelu", "norm_gelu"])
    @pytest.mark.parametrize("b,t,c", [(1, 1, 512), (3, 77, 512), (2, 1000, 768)])
    def test_activation_ragged(self, dev, b, t, c, act):
        from triad_tpu_torch.ops.frontend_conv import (
            frontend_activation_fwd,
            frontend_activation_plain,
        )

        x = _randn((b, t, c), dev, 45)
        mean = _randn((b, 1, c), dev, 46, 0.3, torch.float32)
        rstd = _randn((b, 1, c), dev, 47, 0.2, torch.float32).abs() + 0.5
        scale = _randn((c,), dev, 48, 0.3, torch.float32) + 1.0
        bias = _randn((c,), dev, 49, 0.1, torch.float32)
        got = frontend_activation_fwd(x, mean, rstd, scale, bias, act)
        torch.cuda.synchronize()
        ref = frontend_activation_plain(x, mean, rstd, scale, bias, act)
        assert got.shape == ref.shape
        err, mx = _max_err(got, ref)
        # one rounding of the same fp32 value (erff against torch's erf)
        assert err <= 2.0 ** -7 * mx, (err, mx)

    def test_autograd_counts_launches(self, dev):
        from triad_tpu_torch import kernels
        from triad_tpu_torch.ops.frontend_conv import frontend_activation, fused_frontend_conv

        x, w, mean, rstd, scale, bias = self._inputs(dev, 2, 99, 3, 50)
        leaves = [t.detach().clone().requires_grad_() for t in (x, w, mean, rstd, scale, bias)]
        kernels.reset_launches()
        y = fused_frontend_conv(*leaves, 99, "norm_gelu")
        z = frontend_activation(y, mean, rstd, scale, bias, "gelu")
        z.float().square().sum().backward()
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["fused_frontend_conv"] == 1
        assert kernels.LAUNCHES["frontend_activation"] == 1
        assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in leaves)


class TestFlashAttention:
    # The kernel walks 64-key tiles with an online softmax, the twin the
    # library's 512-key blocks: the bf16 roundings of P (and so of O, dS and
    # the gradients) differ here and there by an ulp. 2 bf16 ulps of each
    # output's largest magnitude.
    TOL = 2 * 2.0 ** -7
    # Every length the wrapper takes in this range: ragged and whole 64-row
    # tiles, one key, the 128 and 512 boundaries, the old 512-key cap.
    LENGTHS = (1, 37, 64, 65, 128, 261, 499, 512, 999, 1000, 1024, 2048)

    @staticmethod
    def _inputs(dev, b, n, mask_kind, seed, layout="bnhd", h=12):
        """(B, H, N, 64) views as the encoders pass them: of (B, N, H, 64)
        tensors ("bnhd"), or q, k, v sliced out of one fused (B, N, 3, H,
        64) qkv tensor ("qkv": row stride 3 H 64); dO, and a key mask (None,
        masked keys in row 0, or also row -1 with every key masked)."""
        if layout == "qkv":
            qkv = _randn((b, n, 3, h, 64), dev, seed)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            do = _randn((b, n, h, 64), dev, seed + 3).transpose(1, 2)
        else:
            q, k, v, do = (_randn((b, n, h, 64), dev, seed + i).transpose(1, 2)
                           for i in range(4))
        mask = None
        if mask_kind != "none":
            mask = torch.ones((b, n), device=dev)
            mask[0, n * 3 // 4:] = 0.0
            if mask_kind == "all":
                mask[-1] = 0.0
        return q, k, v, do, mask

    def _check(self, dev, b, n, mask_kind, layout, h):
        from triad_tpu_torch.ops.flash_attention import (
            flash_attention_bwd,
            flash_attention_fwd,
            flash_bwd_plain,
            flash_fwd_plain,
        )

        q, k, v, do, mask = self._inputs(dev, b, n, mask_kind, 70, layout, h=h)
        o, l, m = flash_attention_fwd(q, k, v, mask, 0.125)
        torch.cuda.synchronize()
        o_ref, l_ref, m_ref = flash_fwd_plain(q, k, v, mask, 0.125)
        err, mx = _max_err(o, o_ref)
        assert err <= self.TOL * mx, ("out", err, mx)
        torch.testing.assert_close(m, m_ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(l, l_ref, rtol=1e-5, atol=0)
        grads = flash_attention_bwd(q, k, v, mask, o, l, m, do, 0.125)
        torch.cuda.synchronize()
        # One key and no mask: P = 1, so the exact dS = P (dP - di) and with
        # it dq and dk are 0. Kernel and twin both return the fp32 rounding
        # of dP - di, where dP = dO . V and di sum the same 64 products in
        # other orders; a tolerance relative to the twin's own largest
        # value (that noise) cannot hold it. Bound each row of dS by a few
        # fp32 eps times the 64 terms' magnitude sum, sum_d |dO_d V_d|,
        # then dq = dS K sm_scale and dk = dS Q sm_scale by |K| and |Q|.
        exact_zero = n == 1 and mask is None
        noise = (4 * torch.finfo(torch.float32).eps * 64 * 0.125
                 * float((do.float() * v.float()).abs().sum(-1).max()))
        for name, g, r, other in zip(("dq", "dk", "dv"), grads,
                                     flash_bwd_plain(q, k, v, mask, o, l, m, do, 0.125),
                                     (k, q, None)):
            err, mx = _max_err(g, r)
            if exact_zero and other is not None:
                bound = noise * float(other.float().abs().max())
                assert err <= bound and float(g.float().abs().max()) <= bound, (name, err, bound)
            else:
                assert err <= self.TOL * mx, (name, err, mx)

    @pytest.mark.parametrize("layout", ["bnhd", "qkv"])
    @pytest.mark.parametrize("mask_kind", ["none", "keys", "all"])
    @pytest.mark.parametrize("n", LENGTHS)
    def test_fwd_bwd(self, dev, n, mask_kind, layout):
        self._check(dev, 2, n, mask_kind, layout, 3)

    # Twelve heads, as the encoders run them. The cases of 144, 192 and 384
    # items (128-row tiles of a head) give the card's 132 persistent blocks
    # a second item or more: the ring's stage and phase carried from one
    # item to the next, the resident buffer's barrier parity.
    @pytest.mark.parametrize("layout", ["bnhd", "qkv"])
    @pytest.mark.parametrize("b,n,mask_kind", [
        (4, 261, "none"), (2, 499, "none"), (4, 128, "all"), (2, 37, "keys"), (2, 1000, "all"),
        (1, 1024, "none"), (2, 2048, "keys"),
    ])
    def test_fwd_bwd_twelve_heads(self, dev, b, n, mask_kind, layout):
        self._check(dev, b, n, mask_kind, layout, 12)

    def test_backward_is_deterministic(self, dev):
        """No atomics: the same backward twice gives bit-equal dq, dk, dv
        (fused-qkv views, an all-masked row, N past the old key cap)."""
        from triad_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

        q, k, v, do, mask = self._inputs(dev, 4, 1000, "all", 75, "qkv")
        o, l, m = flash_attention_fwd(q, k, v, mask, 0.125)
        first = flash_attention_bwd(q, k, v, mask, o, l, m, do, 0.125)
        second = flash_attention_bwd(q, k, v, mask, o, l, m, do, 0.125)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), first, second):
            assert torch.equal(a, b), name

    def test_autograd_counts_launches(self, dev):
        from triad_tpu_torch import kernels
        from triad_tpu_torch.ops.flash_attention import flash_attention

        q, k, v, do, mask = self._inputs(dev, 2, 99, "keys", 80)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        kernels.reset_launches()
        flash_attention(*leaves, mask).backward(do)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["flash_attention"] == 1
        assert kernels.LAUNCHES["flash_attention_bwd"] == 1
        assert all(t.grad is not None and bool(torch.isfinite(t.grad.float()).all())
                   for t in leaves)


class TestEvalAttentionRefusesGrad:
    @pytest.mark.parametrize("name", ["attention_eval", "attention_eval_pair",
                                      "attention_eval_merged", "attention_eval_merged_pair"])
    def test_raises_under_autograd(self, dev, name):
        """The eval kernels have no backward: an input that requires grad
        raises instead of an output that silently drops the gradient; under
        no_grad the kernel runs."""
        from triad_tpu_torch.ops import attention as A

        x = _randn((2, 37, 2304 if "merged" in name else 768), dev, 90)
        args = (x,) if "merged" in name else (x, x, x)
        with torch.no_grad():
            assert bool(torch.isfinite(getattr(A, name)(*args).float()).all())
        x.requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            getattr(A, name)(*args)


class TestEvalAttentionAnyLength:
    """The eval attention in its four modes at any N (nothing in the kernel
    scales with N, so no key cap), H = 3 (the pair modes' odd last head
    takes the single-head numbers), with masked keys and, in the last batch
    row, every key masked (its softmax uniform over the keys it counts, the
    128-padded ones too in the pair modes): 2 bf16 ulps of the twin's
    largest output, as TestAttention."""

    TOL = 2 * 2.0 ** -7

    @pytest.mark.parametrize("n", [1, 37, 128, 261, 499, 512, 513, 999, 1000, 2048])
    @pytest.mark.parametrize("mode", ["packed", "merged", "pair", "merged_pair"])
    def test_matches_twin(self, dev, mode, n):
        from triad_tpu_torch.ops import attention as A

        b, h = 3, 3
        qkv = _randn((b, n, 3 * h * 64), dev, 100 + n)
        q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
        mask = torch.ones((b, n), device=dev)
        mask[0, n // 3] = 0.0 if n > 1 else 1.0  # one masked key
        mask[1, n // 2:] = 0.0                    # a ragged tail (all keys at n = 1)
        mask[2] = 0.0                             # every key masked
        if mode == "packed":
            got, ref = A.attention_eval(q, k, v, mask), A.attention_eval_plain(
                q, k, v, mask, 0.125, -(-n // 128) * 128)
        elif mode == "merged":
            got, ref = A.attention_eval_merged(qkv, mask), A.attention_eval_plain(
                q, k, v, mask, 0.125)
        elif mode == "pair":
            got, ref = A.attention_eval_pair(q, k, v, mask), A.attention_eval_pair_plain(
                q, k, v, mask, 0.125)
        else:
            got, ref = A.attention_eval_merged_pair(qkv, mask), A.attention_eval_pair_plain(
                q, k, v, mask, 0.125)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (b, n, h * 64)
        err, mx = _max_err(got, ref)
        assert err <= self.TOL * mx, (err, mx)

    @pytest.mark.parametrize("mode", ["packed", "merged", "pair", "merged_pair"])
    def test_no_mask(self, dev, mode):
        """No key mask (the ViT's merged call): every key attends, at N =
        999, past the old 512-key cap."""
        from triad_tpu_torch.ops import attention as A

        b, n, h = 2, 999, 12
        qkv = _randn((b, n, 3 * h * 64), dev, 99)
        q, k, v = qkv.chunk(3, dim=-1)
        ones = torch.ones((b, n), device=dev)
        pair = mode.endswith("pair")
        if mode.startswith("merged"):
            got = (A.attention_eval_merged_pair if pair else A.attention_eval_merged)(qkv)
        else:
            got = (A.attention_eval_pair if pair else A.attention_eval)(*(t.contiguous()
                                                                          for t in (q, k, v)))
        torch.cuda.synchronize()
        ref = (A.attention_eval_pair_plain(q, k, v, ones, 0.125) if pair
               else A.attention_eval_plain(q, k, v, ones, 0.125))
        err, mx = _max_err(got, ref)
        assert err <= self.TOL * mx, (err, mx)


class TestConvGemm:
    """conv_s2.cuh's TMA + wgmma GEMM through both callers: frontend.cu's
    conv + GELU epilogue (conv_s2_gelu, both GELU forms) and
    frontend_conv.cu's fused input prologue (none, "gelu", "norm_gelu"), at
    k 2 and 3, batch 1, 8 and 64, ragged output lengths (odd T; tout not a
    multiple of the 128-row tile). Both sides sum exact bf16 products in
    fp32 in another order and round once (the GELU epilogue rounds to bf16
    before its GELU and after): 2 bf16 ulps of the twin's largest output,
    as TestFrontendConv."""

    TOL = 2 * 2.0 ** -7

    @pytest.mark.parametrize("b,t,k,form", [(1, 77, 2, "tanh"), (8, 1999, 2, "erf"),
                                            (1, 12345, 3, "erf"), (8, 31999, 3, "tanh"),
                                            (64, 31999, 3, "erf"), (64, 7999, 2, "tanh")])
    def test_conv_gelu(self, dev, b, t, k, form):
        from triad_tpu_torch.ops.frontend import conv_s2_gelu, conv_s2_gelu_plain

        x = _randn((b, t, 512), dev, 110 + k)
        w = _randn((512, 512, k), dev, 111, (2 / (k * 512)) ** 0.5, torch.float32)
        got = conv_s2_gelu(x, w, form)
        torch.cuda.synchronize()
        ref = conv_s2_gelu_plain(x, w, form)
        assert got.shape == ref.shape == (b, (t - k) // 2 + 1, 512)
        err, mx = _max_err(got, ref)
        assert err <= self.TOL * mx, (err, mx)

    @pytest.mark.parametrize("b,t,k,prologue", [
        (1, 77, 2, None), (1, 1001, 3, "norm_gelu"), (8, 1999, 2, "gelu"),
        (8, 15999, 3, None), (64, 31999, 3, "norm_gelu"), (64, 7999, 2, "gelu"),
        (64, 3999, 3, None)])
    def test_fused_conv(self, dev, b, t, k, prologue):
        from triad_tpu_torch.ops.frontend_conv import (
            fused_frontend_conv_fwd,
            fused_frontend_conv_plain,
        )

        x = _randn((b, t, 512), dev, 120 + k)
        w = _randn((512, 512, k), dev, 121, (2 / (k * 512)) ** 0.5, torch.float32)
        mean = _randn((b, 1, 512), dev, 122, 0.3, torch.float32)
        rstd = _randn((b, 1, 512), dev, 123, 0.2, torch.float32).abs() + 0.5
        scale = _randn((512,), dev, 124, 0.3, torch.float32) + 1.0
        bias = _randn((512,), dev, 125, 0.1, torch.float32)
        args = (x, w, mean, rstd, scale, bias, t, prologue)
        got = fused_frontend_conv_fwd(*args)
        torch.cuda.synchronize()
        ref = fused_frontend_conv_plain(*args)
        assert got.shape == ref.shape
        err, mx = _max_err(got, ref)
        assert err <= self.TOL * mx, (err, mx)
