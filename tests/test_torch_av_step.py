"""The port's audio-visual and joint train steps, and its eval loss,
against the jitted JAX step on the CPU.

The steps run the narrow perf_train_model_config() of
tests/test_torch_train_step.py (hidden 128, 2 heads of 64, 2 layers per
encoder) with HuBERT's training kernels forced (fused_packed attention,
the fused MLP, the fused dropout + add + LayerNorm, the Pallas positional
conv at K = 16, 4 groups), the plain conv frontend (the monolithic one
rounds to bf16 inside both packages' kernels; its gradient has its own
test in tests/test_torch_hubert_train.py), every dropout at 0 and every
group unfrozen, 8000 audio samples. The JAX Pallas kernels run in
interpret mode, the port's wrappers their plain versions.

Tolerances as tests/test_torch_train_step.py: metrics and gradients 1e-4
of each leaf's largest magnitude plus 1e-6 absolute (leaves whose
gradient is zero up to rounding, as the key biases), updated parameters
2 lr + 1e-6 (Adam's first step moves a leaf by lr * (sign(g) + weight
decay)); the learning-rate metrics 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_train_step import _at, _batch, _to_flax, narrow_train_config
from triad_tpu.core.config import OptimConfig, perf_train_loss_config

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

W_AV, W_TV = 0.7, 0.3


def av_train_config():
    cfg = narrow_train_config("float32")
    return dataclasses.replace(cfg, hubert=dataclasses.replace(
        cfg.hubert, frontend_impl="conv", mlp_impl="fused", ln_impl="fused",
        hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0, layerdrop=0.0,
        apply_spec_augment=False))


def _av_batch():
    rng = np.random.default_rng(3)
    return {"images": rng.normal(size=(2, 28, 28, 3)).astype(np.float32),
            "audio": (rng.normal(size=(2, 8000)) * 0.1).astype(np.float32)}


def _setup(accum):
    from triad_tpu_torch.models.convert import init_triad_model, torch_to_flax

    cfg = av_train_config()
    loss_cfg = dataclasses.replace(perf_train_loss_config(), volume_dtype="float32")
    ocfg = OptimConfig(gradient_accumulation_steps=accum, unfreeze_audio_step=0,
                       unfreeze_text_step=0)
    model = init_triad_model(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    return cfg, loss_cfg, ocfg, model, params


def _run_pair(mode):
    """The JAX step's state and metrics after each of 2 micro steps
    (accumulation 2), and the port's, from the same weights and batches."""
    import triad_tpu.train as JT
    from triad_tpu_torch.train.optim import OptimizerBank
    from triad_tpu_torch.train.step import StepFactory, TrainState

    cfg, loss_cfg, ocfg, model, params = _setup(accum=2)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    av, tv = _av_batch(), _batch()
    jbank = JT.OptimizerBank(ocfg, JT.ParamPartition(params), total_updates=20)
    jstep = jax.jit(JT.StepFactory(cfg, loss_cfg, ocfg, jbank).make_step(mode))
    jstate = JT.init_train_state(params, jbank, jax.random.key(1))
    jav = {k: jnp.asarray(v) for k, v in av.items()}
    jtv = {k: jnp.asarray(v) for k, v in tv.items()}
    state = TrainState(model, OptimizerBank(ocfg, model, total_updates=20), 0, 1)
    step = StepFactory(loss_cfg, ocfg).make_step(mode)
    tav = {k: torch.from_numpy(v) for k, v in av.items()}
    ttv = {k: torch.from_numpy(v) for k, v in tv.items()}
    runs = []
    for _ in range(2):
        with pltpu.force_tpu_interpret_mode():
            jstate, jm = jstep(jstate, jav, jtv, jnp.float32(W_AV), jnp.float32(W_TV))
        state, m = step(state, tav, ttv, W_AV, W_TV)
        grads = {n: None if p.grad is None else p.grad.clone()
                 for n, p in model.named_parameters()}
        runs.append((jstate, jm, m, grads,
                     {n: p.detach().clone() for n, p in model.named_parameters()}))
    return init, runs


@pytest.fixture(scope="module", params=["av", "joint"])
def pair(request):
    return request.param, _run_pair(request.param)


def test_step_metrics_match(pair):
    mode, (_, runs) = pair
    for jstate, jm, m, _, _ in runs:
        assert sorted(m) == sorted(jm)
        assert ("loss_tv" in m) == (mode == "joint") and "loss_av" in m
        for key, ref in jm.items():
            ref = float(ref)
            tol = 1e-5 * abs(ref) if key.startswith("lr_") else 1e-4 * abs(ref) + 1e-5
            assert abs(float(m[key]) - ref) <= tol, (key, m[key], ref)


def test_step_grads_match(pair):
    """Every leaf's gradient after micro step 0, HuBERT's included (the
    audio group is unfrozen); the ViT base takes none in either."""
    mode, (init, runs) = pair
    jstate, _, _, grads, _ = runs[0]
    live = set()
    for name in init:
        path, _ = _to_flax(name, init[name])
        ref = _at(jstate.grad_accum, path)
        got = grads[name]
        if got is None:
            np.testing.assert_array_equal(ref, np.zeros_like(ref), err_msg=name)
            continue
        live.add(name.split(".")[0])
        np.testing.assert_allclose(_to_flax(name, got)[1], ref, rtol=0,
                                   atol=1e-4 * float(np.abs(ref).max()) + 1e-6, err_msg=name)
    want = {"audio_backbone", "audio_projection", "visual_backbone", "visual_projection",
            "temperature"}
    if mode == "joint":
        want |= {"text_backbone", "text_projection"}
    assert live == want


def test_step_updates_params(pair):
    mode, (init, runs) = pair
    for name, p in runs[0][4].items():
        assert torch.equal(p, init[name]), name
    jstate, jm, _, _, after = runs[1]
    bound = 2 * max(float(jm[f"lr_{g}"]) for g in ("others", "audio", "text", "vit_lora")) + 1e-6
    moved = set()
    for name, p in after.items():
        path, got = _to_flax(name, p)
        np.testing.assert_allclose(got, _at(jstate.params, path), rtol=0, atol=bound,
                                   err_msg=name)
        if not torch.equal(p, init[name]):
            moved.add(name)
    assert any(n.startswith("audio_backbone.pos_conv_embed") for n in moved)
    assert any(n.startswith("audio_backbone.feature_extractor") for n in moved)
    assert not any(n.startswith("visual_backbone") and "lora" not in n for n in moved)


def test_eval_loss_matches():
    """make_eval_loss("joint"): no dropout, no update; the metrics of the
    JAX eval step."""
    import triad_tpu.train as JT
    from triad_tpu_torch.train.optim import OptimizerBank
    from triad_tpu_torch.train.step import StepFactory

    cfg, loss_cfg, ocfg, model, params = _setup(accum=1)
    jbank = JT.OptimizerBank(ocfg, JT.ParamPartition(params), total_updates=20)
    jeval = jax.jit(JT.StepFactory(cfg, loss_cfg, ocfg, jbank).make_eval_loss("joint"))
    av, tv = _av_batch(), _batch()
    with pltpu.force_tpu_interpret_mode():
        jm = jeval(params, {k: jnp.asarray(v) for k, v in av.items()},
                   {k: jnp.asarray(v) for k, v in tv.items()}, jnp.float32(W_AV),
                   jnp.float32(W_TV))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    OptimizerBank(ocfg, model, total_updates=20)
    m = StepFactory(loss_cfg, ocfg).make_eval_loss("joint")(
        model, {k: torch.from_numpy(v) for k, v in av.items()},
        {k: torch.from_numpy(v) for k, v in tv.items()}, W_AV, W_TV)
    assert sorted(m) == sorted(jm)
    for key, ref in jm.items():
        assert abs(float(m[key]) - float(ref)) <= 1e-4 * abs(float(ref)) + 1e-5, key
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]) and p.grad is None, name


def test_av_step_with_live_dropout_runs():
    """HuBERT's dropouts, SpecAugment and layerdrop live (the perf_train
    rates) through the "av" step on the CPU: finite metrics, seeded by
    (seed, global_step)."""
    from triad_tpu_torch.models.convert import init_triad_model
    from triad_tpu_torch.train.optim import OptimizerBank
    from triad_tpu_torch.train.step import StepFactory, TrainState

    base = narrow_train_config("float32")
    cfg = dataclasses.replace(base, hubert=dataclasses.replace(
        base.hubert, frontend_impl="conv", mlp_impl="fused", ln_impl="fused"))
    ocfg = OptimConfig(gradient_accumulation_steps=1, unfreeze_audio_step=0)
    losses = []
    for _ in range(2):
        model = init_triad_model(cfg, torch.Generator().manual_seed(0))
        state = TrainState(model, OptimizerBank(ocfg, model, total_updates=20), 0, 5)
        step = StepFactory(perf_train_loss_config(), ocfg).make_step("av")
        av = {k: torch.from_numpy(v) for k, v in _av_batch().items()}
        state, m = step(state, av, None)
        assert all(np.isfinite(float(v)) for v in m.values())
        losses.append(float(m["loss_av"]))
    assert losses[0] == losses[1]
