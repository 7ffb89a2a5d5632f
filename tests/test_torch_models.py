"""The port's encoders and TriadModel against the JAX package, on the CPU,
on a narrow variant of perf_eval_model_config(): hidden 128, 2 heads of
64 (the merged eval kernel needs head_dim 64), 2 layers, intermediate
256, the full 512-channel HuBERT conv geometry (the monolithic frontend
requires it), 28 px images and 8000 audio samples. Every perf knob stays
on: merged/packed eval attention, fused tanh MLP in the ViT, the
monolithic tanh frontend, bf16 softmax scores.

Weights come from the JAX init through models/convert.py, with the LoRA
B factors randomised so the folded adapter is exercised. The JAX Pallas
kernels run in interpret mode; the port runs its plain twins.

Tolerances, relative to max|ref| (bf16 runs: tests/test_torch_models_bf16.py):
  float32, no audio  1e-4: fp32 throughout, summation order only.
  float32, audio     1e-2: the frontend rounds to bf16 inside both
           packages' kernels at the same points; an fp32 summation-order
           difference can flip one of those roundings, moving a frame by
           one bf16 ulp (2^-8 relative), which the layers after it spread.
  bfloat16           5e-2: bf16 activations round at different places in
           XLA and PyTorch (matmul and bias fused or not, bf16
           reductions), ~1 bf16 ulp per op through 2 layers per encoder.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from triad_tpu.core.config import perf_eval_model_config

AUDIO_KEYS = ("audio", "audio_feats", "vis_audio_sim_matrix", "text_audio_sim_matrix")


def tolerance(dtype, key):
    if dtype == "bfloat16":
        return 5e-2
    return 1e-2 if key in AUDIO_KEYS else 1e-4


def narrow_perf_config(compute_dtype):
    base = perf_eval_model_config()
    return dataclasses.replace(
        base,
        embedding_dim=64,
        compute_dtype=compute_dtype,
        vit=dataclasses.replace(base.vit, image_size=28, hidden_size=128, num_heads=2,
                                num_layers=2, mlp_ratio=2.0),
        hubert=dataclasses.replace(base.hubert, hidden_size=128, num_heads=2, num_layers=2,
                                   intermediate_size=256, num_conv_pos_embeddings=16,
                                   num_conv_pos_embedding_groups=4),
        text=dataclasses.replace(base.text, vocab_size=100, hidden_size=128, num_heads=2,
                                 num_layers=2, intermediate_size=256,
                                 max_position_embeddings=64),
    )


def build_pair(compute_dtype):
    """(JAX TriadModel, its params, the port's TriadModel, inputs): the
    port's own init with random LoRA B factors, handed to JAX through
    models/convert.py."""
    from triad_tpu.models import TriadModel as JaxTriad
    from triad_tpu_torch.models.convert import init_triad_model, torch_to_flax

    cfg = narrow_perf_config(compute_dtype)
    model = init_triad_model(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    rng = np.random.default_rng(2)
    mask = np.ones((2, 10), np.float32)
    mask[1, 6:] = 0.0
    inputs = {
        "images": rng.normal(size=(2, 28, 28, 3)).astype(np.float32),
        "audio": (rng.normal(size=(2, 8000)) * 0.1).astype(np.float32),
        "ids": rng.integers(1, 100, size=(2, 10)).astype(np.int32),
        "mask": mask,
    }
    return JaxTriad(cfg), params, model, inputs


def _jax(jm, params, method, *args):
    with pltpu.force_tpu_interpret_mode():
        out = jm.apply({"params": params}, *args, method=method)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), out)


def _close(got, ref, tol):
    got = got.detach().to(torch.float32).numpy()
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=tol * float(np.abs(ref).max()))


def check_backbone(pair, enc, dtype):
    """One backbone alone (before its projection head)."""
    from triad_tpu.models.hubert import normalize_waveform as jax_norm
    from triad_tpu_torch.models.hubert import normalize_waveform

    jm, params, model, x = pair
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    with torch.inference_mode():
        if enc == "visual":
            ref = _jax(jm, params, lambda m, i: m.visual_backbone(i), x["images"])
            got = model.visual_backbone(t["images"])
        elif enc == "audio":
            ref = _jax(jm, params, lambda m, a: m.audio_backbone(jax_norm(a)), x["audio"])
            got = model.audio_backbone(normalize_waveform(t["audio"]))
        else:
            ref = _jax(jm, params, lambda m, i, k: m.text_backbone(i, k), x["ids"], x["mask"])
            got = model.text_backbone(t["ids"], t["mask"])
    _close(got, ref, tolerance(dtype, enc))


def check_inference_forward(pair, dtype):
    """TriadModel.inference_forward: encode_visual / encode_audio /
    encode_text features and the three temperature-scaled sim matrices."""
    from triad_tpu.models import TriadModel as JaxTriad

    jm, params, model, x = pair
    keys = ("images", "audio", "ids", "mask")
    ref = _jax(jm, params, JaxTriad.inference_forward, *(x[k] for k in keys))
    with torch.inference_mode():
        got = model.inference_forward(*(torch.from_numpy(x[k]) for k in keys))
    assert sorted(got) == sorted(ref)
    for key in ref:
        _close(got[key], ref[key], tolerance(dtype, key))


@pytest.fixture(scope="module")
def pair_f32():
    return build_pair("float32")


@pytest.mark.parametrize("enc", ["visual", "audio", "text"])
def test_backbone(pair_f32, enc):
    check_backbone(pair_f32, enc, "float32")


def test_inference_forward(pair_f32):
    check_inference_forward(pair_f32, "float32")


@pytest.mark.parametrize("section,field,a,b", [
    ("hubert", "attention_impl", "packed", "packed_merged"),
    ("vit", "lora_compute", "folded", "separate"),
])
def test_equivalent_impls(section, field, a, b):
    """Impl values with the same semantics give the same encoder output
    from one state_dict (fp32, plain twins on the CPU; 1e-5 of max)."""
    from triad_tpu_torch.models.convert import init_triad_model
    from triad_tpu_torch.models.multimodal import TriadModel

    base = narrow_perf_config("float32")
    sd = None
    outs = []
    for value in (a, b):
        sub = dataclasses.replace(getattr(base, section), **{field: value})
        cfg = dataclasses.replace(base, **{section: sub})
        if sd is None:
            model = init_triad_model(cfg, torch.Generator().manual_seed(4))
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if name.endswith("lora_b"):
                        p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(5))
            sd = model.state_dict()
        else:
            model = TriadModel(cfg)
            model.load_state_dict(sd)
        rng = np.random.default_rng(6)
        with torch.inference_mode():
            if section == "hubert":
                x = torch.from_numpy((rng.normal(size=(2, 8000)) * 0.1).astype(np.float32))
                outs.append(model.encode_audio(x))
            else:
                x = torch.from_numpy(rng.normal(size=(2, 28, 28, 3)).astype(np.float32))
                outs.append(model.encode_visual(x))
    torch.testing.assert_close(outs[1], outs[0], rtol=0,
                               atol=1e-5 * float(outs[0].abs().max()))
