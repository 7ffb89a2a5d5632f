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

    @pytest.mark.parametrize("m", [8 * 499, 8 * 261, 45])
    @pytest.mark.parametrize("form", ["tanh", "erf"])
    def test_matches_plain(self, dev, m, form):
        from triad_tpu_torch.ops.mlp import fused_mlp, fused_mlp_plain

        x = _randn((m, 768), dev, 5)
        w1 = _randn((3072, 768), dev, 6, 768 ** -0.5)
        b1 = _randn((3072,), dev, 7, 0.1)
        w2 = _randn((768, 3072), dev, 8, 3072 ** -0.5)
        b2 = _randn((768,), dev, 9, 0.1)
        got = fused_mlp(x, w1, b1, w2, b2, form)
        torch.cuda.synchronize()
        err, mx = _max_err(got, fused_mlp_plain(x, w1, b1, w2, b2, form))
        assert err <= self.TOL * mx, (err, mx)


def _frontend_weights(dev):
    from triad_tpu_torch.ops.frontend import KERNELS

    rng = np.random.default_rng(11)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    w0 = f(rng.standard_normal((512, 1, 10)) * (2 / 10) ** 0.5)
    gs = f(rng.standard_normal(512) * 0.2 + 1.0)
    gb = f(rng.standard_normal(512) * 0.1)
    ws = [f(rng.standard_normal((512, 512, k)) * (2 / (k * 512)) ** 0.5) for k in KERNELS[1:]]
    return w0, gs, gb, ws


class TestFrontend:
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
        (docs/evidence/nan_culprit_audio_rows.npz) through the kernels."""
        import os

        from triad_tpu_torch.models.hubert import normalize_waveform
        from triad_tpu_torch.ops.frontend import conv0_stats, frontend

        path = os.path.join(os.path.dirname(__file__), "..", "docs", "evidence",
                            "nan_culprit_audio_rows.npz")
        wave = normalize_waveform(torch.from_numpy(np.load(path)["av_audio"]).to(dev))
        w0, gs, gb, ws = _frontend_weights(dev)
        _, var = conv0_stats(wave, w0)
        out = frontend(wave, w0, gs, gb, ws, "tanh")
        torch.cuda.synchronize()
        assert float(var.min()) > 0.0
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

    @pytest.mark.parametrize("m", [8 * 261, 45])
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

    @pytest.mark.parametrize("m", [8 * 499, 45])
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
