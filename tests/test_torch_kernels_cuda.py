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
        got = A.attention_train_fwd(q, k, v, mask, 0.125)
        torch.cuda.synchronize()
        err, mx = _max_err(got, A.attention_train_plain(q, k, v, mask, 0.125))
        assert err <= self.TOL * mx, ("fwd", err, mx)
        grads = A.attention_train_bwd(q, k, v, mask, do, 0.125)
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
        assert torch.equal(A.attention_train_fwd(q, k, v, bool_mask, 0.125),
                           A.attention_train_fwd(q, k, v, mask, 0.125))
        for g, r in zip(A.attention_train_bwd(q, k, v, bool_mask, do, 0.125),
                        A.attention_train_bwd(q, k, v, mask, do, 0.125)):
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
        got = A.attention_train_fwd(q, k, v, keys, 0.125, 1234, p)
        torch.cuda.synchronize()
        err, mx = _max_err(got, A.attention_train_plain(q, k, v, keys, 0.125, 1234, p))
        assert err <= self.TOL * mx, ("fwd", err, mx)
        grads = A.attention_train_bwd(q, k, v, keys, do, 0.125, 1234, p)
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
