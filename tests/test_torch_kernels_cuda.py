"""The port's CUDA kernels against their plain PyTorch twins, on the card,
at the shapes the serving path gives them (perf_eval_model_config at
B=8: HuBERT 499 tokens, ViT 261 tokens, 10 s of 16 kHz audio).

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
