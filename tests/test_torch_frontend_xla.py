"""HuBERT's XLA frontends in the port ("matmul", "block_matmul", "phase":
the port's plain conv route on the same conv_i parameters, "phase" on
the waveform cut to a multiple of 10 samples) against the JAX package's
ConvFeatureEncoder and HubertModel with the same impl, which computes
them as products, on the CPU at small sizes.

The frontend has HuBERT's kernel / stride pattern (10, 3, 3, 3, 3, 2, 2 /
5, 2, 2, 2, 2, 2, 2) at 16 or 32 channels, on 1600 to 3200 samples,
including lengths that are not multiples of 10 (the "phase" frontend cuts
them to one; 2407 ends 7 samples past a multiple, so there conv_0 gives
one window fewer than a conv would). Parameters are drawn from a seed,
inputs from numpy with a seed. fp32 with TF32 off; JAX at "highest"
matmul precision (tests/conftest.py). Tolerance: 1e-5 of the reference's
largest magnitude, absolute (fp32 throughout: the products' summation
order differs, nothing else).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triad_tpu.core.config import HubertConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REL = 1e-5
KERNELS = (10, 3, 3, 3, 3, 2, 2)
STRIDES = (5, 2, 2, 2, 2, 2, 2)


def _close(got, ref, rel=REL):
    got = got.detach().to(torch.float32).numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def _config(impl, channels=32, conv_bias=False, **kw):
    return HubertConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                        conv_dim=(channels,) * 7, conv_kernel=KERNELS, conv_stride=STRIDES,
                        conv_bias=conv_bias, num_conv_pos_embeddings=16,
                        num_conv_pos_embedding_groups=4, frontend_impl=impl, **kw)


def _models(cfg, seed=0):
    """The port's HubertModel on ``cfg`` with parameters drawn from
    ``seed`` (norm scales about 1), and the same parameters as the JAX
    package's tree."""
    from triad_tpu_torch.config import HubertConfig as PortHubertConfig
    from triad_tpu_torch.models.convert import torch_to_flax
    from triad_tpu_torch.models.hubert import HubertModel

    model = HubertModel(PortHubertConfig(**dataclasses.asdict(cfg)))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1
                        + (1.0 if "norm" in name else 0.0))
    model.eval()
    return model, jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))


def _audio(b, t, seed):
    return np.random.default_rng(seed).normal(size=(b, t)).astype(np.float32)


CASES = [
    ("matmul", 32, False, 3200),
    ("matmul", 16, True, 2407),
    ("block_matmul", 32, False, 3200),
    ("block_matmul", 16, True, 1603),
    ("phase", 32, False, 3200),
    ("phase", 16, False, 1600),
    ("phase", 32, False, 2407),
    ("phase", 16, False, 1603),
]


@pytest.mark.parametrize("impl,channels,conv_bias,t", CASES)
def test_frontend_matches_jax(impl, channels, conv_bias, t):
    """ConvFeatureEncoder alone: (2, t) waveform -> (2, T', C) features."""
    from triad_tpu.models.hubert import ConvFeatureEncoder as JaxFrontend

    cfg = _config(impl, channels, conv_bias)
    model, params = _models(cfg, seed=t)
    audio = _audio(2, t, seed=t + 1)
    ref = jax.jit(JaxFrontend(cfg).apply)({"params": params["feature_extractor"]},
                                          jnp.asarray(audio))
    with torch.inference_mode():
        got = model.feature_extractor(torch.from_numpy(audio))
    _close(got, ref)


def test_phase_cuts_to_tens():
    """The phase frontend's length is that of the first multiple of 10
    samples (conv_0 at 2407 samples gives 479 windows, 480 as a conv);
    "matmul" and "block_matmul" give the conv's."""
    from triad_tpu_torch.config import HubertConfig as PortHubertConfig
    from triad_tpu_torch.models.hubert import ConvFeatureEncoder

    audio = torch.from_numpy(_audio(1, 2407, 3))
    lengths = {}
    for impl in ("conv", "matmul", "block_matmul", "phase"):
        fe = ConvFeatureEncoder(PortHubertConfig(**dataclasses.asdict(_config(impl, 16))),
                                torch.float32, torch.float32)
        with torch.inference_mode():
            lengths[impl] = fe(audio).shape[1]
    conv_len = _config("conv").num_audio_tokens(2407)
    assert lengths == {"conv": conv_len, "matmul": conv_len, "block_matmul": conv_len,
                       "phase": _config("conv").num_audio_tokens(2400)}


@pytest.mark.parametrize("impl", ["matmul", "block_matmul", "phase"])
def test_hubert_model_matches_jax(impl):
    """One whole HubertModel eval forward per impl against the JAX
    HubertModel with the same impl (its default remat, "chunked_conv",
    which runs "matmul" and "block_matmul" chunk by chunk there)."""
    from triad_tpu.models.hubert import HubertModel as JaxHubert

    cfg = _config(impl)
    model, params = _models(cfg, seed=5)
    audio = _audio(2, 3200, seed=6)
    ref = jax.jit(JaxHubert(cfg).apply)({"params": params}, jnp.asarray(audio))
    with torch.inference_mode():
        got = model(torch.from_numpy(audio))
    _close(got, ref)


def test_phase_refuses_conv_bias():
    from triad_tpu_torch.config import HubertConfig as PortHubertConfig
    from triad_tpu_torch.models.hubert import ConvFeatureEncoder

    with pytest.raises(ValueError, match="phase frontend: no conv bias"):
        ConvFeatureEncoder(PortHubertConfig(**dataclasses.asdict(_config("phase", 16, True))),
                           torch.float32, torch.float32)
