"""The port's optimizer bank and text-visual train step against the JAX
package, on the CPU, and the live-dropout checks.

The step runs a narrow perf_train_model_config(): hidden 128, 2 heads of
64, 2 layers, 28 px images, a 2-layer DistilBERT, every dropout at 0,
unfreeze_text_step 0, perf_train_loss_config() (chunked_vjp). Weights
come from the port's init with random LoRA B factors, handed to JAX
through models/convert.py. The JAX Pallas kernels run in interpret mode,
the port's wrappers their plain versions.

Tolerances:
  bank, fp32              1e-5 relative: the same AdamW arithmetic in
                          another order.
  step metrics and grads  1e-4 of each leaf's largest magnitude (fp32,
                          summation order; the fp32 volume keeps the max
                          routing identical), plus 1e-6 absolute for leaves
                          whose gradient is zero up to rounding (the key
                          biases: softmax does not see a per-row shift).
  updated parameters      2 lr + 1e-6 absolute: Adam's first step moves
                          each leaf by lr * (sign(g) + weight decay), so a
                          gradient that is zero up to rounding may take
                          either sign in the two packages.
  bf16 step               5e-2 of the loss and of the largest clip-sim
                          statistic, and a per-group gradient cosine above
                          0.99: bf16
                          activations round at other places in XLA and
                          PyTorch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from jax.experimental.pallas import tpu as pltpu

from triad_tpu.core.config import OptimConfig, perf_train_loss_config, perf_train_model_config

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Optimizer bank
# ---------------------------------------------------------------------------

_SHAPES = {
    "visual_backbone.weight": (4, 3), "visual_backbone.lora_a": (2, 3),
    "audio_backbone.weight": (5,), "audio_projection.weight": (3, 2),
    "text_backbone.weight": (4, 2), "text_projection.weight": (3,),
}


class _Tree(nn.Module):
    def __init__(self, values):
        super().__init__()
        for name in ("visual_backbone", "audio_backbone", "audio_projection",
                     "text_backbone", "text_projection"):
            setattr(self, name, nn.Module())
        for name, v in values.items():
            mod, leaf = name.split(".") if "." in name else (None, name)
            holder = getattr(self, mod) if mod else self
            holder.register_parameter(leaf, nn.Parameter(torch.from_numpy(v.copy())))


def _jax_tree(values):
    tree = {}
    for name, v in values.items():
        parts = name.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


def test_bank_matches_jax_over_micro_steps():
    """26 micro steps, accumulation 2, text unfreezing mid-window (micro
    step 9), audio never, clipping active (audio/text grads ~50x): lrs,
    beta1, grad norms and every parameter after each update."""
    from triad_tpu.train import optim as J
    from triad_tpu_torch.train.optim import OptimizerBank

    rng = np.random.default_rng(0)
    values = {k: rng.normal(size=s).astype(np.float32) for k, s in _SHAPES.items()}
    values["temperature"] = np.array(1.5, np.float32)
    cfg = OptimConfig(learning_rate=1e-2, gradient_accumulation_steps=2,
                      unfreeze_audio_step=100, unfreeze_text_step=9, unfreeze_vit_step=4)
    model = _Tree(values)
    bank = OptimizerBank(cfg, model, total_updates=12)
    params = _jax_tree(values)
    part = J.ParamPartition(params)
    jbank = J.OptimizerBank(cfg, part, total_updates=12)
    opt = jbank.init(params)
    acc = jax.tree.map(jnp.zeros_like, params)
    for s in range(26):
        grads = {k: (rng.normal(size=np.shape(v)) * (50.0 if k.startswith(("audio", "text"))
                                                      else 1.0)).astype(np.float32)
                 for k, v in values.items()}
        g = jax.tree.map(lambda x: x / 2, _jax_tree(grads))
        acc = jax.tree.map(jnp.add, acc, J.gate_grads(g, part, cfg, jnp.int32(s)))
        bank.set_trainable(s)
        for name, p in model.named_parameters():
            if p.requires_grad:
                add = torch.from_numpy(np.asarray(grads[name] / 2, np.float32))
                p.grad = add if p.grad is None else p.grad + add
        if (s + 1) % 2:
            continue
        clipped, jnorms = J.clip_grads(acc, part, cfg)
        updates, opt, jlrs = jbank.update(clipped, opt, params, jnp.int32(s))
        params = jax.tree.map(jnp.add, params, updates)
        acc = jax.tree.map(jnp.zeros_like, acc)
        norms, lrs = bank.clip_grads(), bank.update(s)
        bank.zero_grad()
        for key in jnorms:
            np.testing.assert_allclose(float(norms[key]), float(jnorms[key]), rtol=1e-5)
        for key in jlrs:
            np.testing.assert_allclose(lrs[key], float(jlrs[key]), rtol=1e-5)
        for grp in ("others", "vit_lora") + (("text",) if s >= 9 else ()):
            count = bank.counts[grp] - 1  # beta1 of the update just applied
            cycle = 12 - {"others": 0, "vit_lora": 4, "text": 9}[grp]
            want = float(J.onecycle_momentum(cfg, cycle)(count))
            got = bank.opts[grp].param_groups[0]["betas"][0]
            np.testing.assert_allclose(got, want, rtol=1e-6)
        got_params = {n: p.detach().numpy() for n, p in model.named_parameters()}
        for name in got_params:
            node = params
            for part_name in name.split("."):
                node = node[part_name]
            np.testing.assert_allclose(got_params[name], np.asarray(node), rtol=1e-5, atol=1e-7)
    # the ViT base and the still-gated audio backbone never moved, and no
    # AdamW state exists for the gated group
    np.testing.assert_array_equal(model.visual_backbone.weight.detach().numpy(),
                                  values["visual_backbone.weight"])
    np.testing.assert_array_equal(model.audio_backbone.weight.detach().numpy(),
                                  values["audio_backbone.weight"])
    assert not bank.opts["audio"].state


def test_bank_refuses_low_precision_moments():
    from triad_tpu_torch.train.optim import OptimizerBank

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        OptimizerBank(OptimConfig(mu_dtype="bfloat16"), nn.Linear(2, 2), 10)


# ---------------------------------------------------------------------------
# The text-visual step
# ---------------------------------------------------------------------------


def narrow_train_config(compute_dtype):
    base = perf_train_model_config()
    return dataclasses.replace(
        base, embedding_dim=64, compute_dtype=compute_dtype, visual_dropout_prob=0.0,
        vit=dataclasses.replace(base.vit, image_size=28, hidden_size=128, num_heads=2,
                                num_layers=2, mlp_ratio=2.0),
        hubert=dataclasses.replace(base.hubert, hidden_size=128, num_heads=2, num_layers=2,
                                   intermediate_size=256, num_conv_pos_embeddings=16,
                                   num_conv_pos_embedding_groups=4),
        text=dataclasses.replace(base.text, vocab_size=100, hidden_size=128, num_heads=2,
                                 num_layers=2, intermediate_size=256,
                                 max_position_embeddings=64, dropout=0.0,
                                 attention_dropout=0.0),
    )


def _batch():
    rng = np.random.default_rng(2)
    return {
        "images": rng.normal(size=(2, 28, 28, 3)).astype(np.float32),
        "token_ids": rng.integers(1, 100, size=(2, 8)).astype(np.int32),
        "text_mask": np.array([[1] * 8, [1] * 6 + [0] * 2], np.float32),
    }


def _run_pair(compute_dtype, volume_dtype, accum):
    """The JAX step's state and metrics after each of ``accum`` micro
    steps, and the port's, from the same weights and batch."""
    import triad_tpu.train as JT
    from triad_tpu_torch.models.convert import init_triad_model, torch_to_flax
    from triad_tpu_torch.train.optim import OptimizerBank
    from triad_tpu_torch.train.step import StepFactory, TrainState

    cfg = narrow_train_config(compute_dtype)
    loss_cfg = dataclasses.replace(perf_train_loss_config(), volume_dtype=volume_dtype)
    ocfg = OptimConfig(gradient_accumulation_steps=accum, unfreeze_text_step=0)
    model = init_triad_model(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    batch = _batch()
    jbank = JT.OptimizerBank(ocfg, JT.ParamPartition(params), total_updates=20)
    jstep = jax.jit(JT.StepFactory(cfg, loss_cfg, ocfg, jbank).make_step("tv"))
    jstate = JT.init_train_state(params, jbank, jax.random.key(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    one = jnp.float32(1.0)
    state = TrainState(model, OptimizerBank(ocfg, model, total_updates=20), 0, 1)
    step = StepFactory(loss_cfg, ocfg).make_step("tv")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = []
    for _ in range(accum):
        with pltpu.force_tpu_interpret_mode():
            jstate, jm = jstep(jstate, None, jb, one, one)
        state, m = step(state, None, tb)
        grads = {n: None if p.grad is None else p.grad.clone()
                 for n, p in model.named_parameters()}
        runs.append((jstate, jm, m, grads,
                     {n: p.detach().clone() for n, p in model.named_parameters()}))
    return cfg, init, runs


def _to_flax(name, t):
    """(The Flax path of a state-dict name, t in the Flax layout.)"""
    from triad_tpu_torch.models.convert import torch_to_flax

    node, path = torch_to_flax({name: t.detach().to(torch.float32)}), []
    while isinstance(node, dict):
        path.append(next(iter(node)))
        node = node[path[-1]]
    return path, node


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree, np.float32)


@pytest.fixture(scope="module")
def fp32_pair():
    return _run_pair("float32", "float32", accum=2)


def test_tv_step_metrics_match(fp32_pair):
    _, _, runs = fp32_pair
    for jstate, jm, m, _, _ in runs:
        assert sorted(m) == sorted(jm)
        for key, ref in jm.items():
            ref = float(ref)
            tol = 1e-5 * abs(ref) if key.startswith("lr_") else 1e-4 * abs(ref) + 1e-5
            assert abs(float(m[key]) - ref) <= tol, (key, m[key], ref)


def test_tv_step_grads_match(fp32_pair):
    """Every leaf's accumulated gradient after micro step 0 (the JAX
    state's grad_accum, gated; the port's .grad, None where gated)."""
    _, init, runs = fp32_pair
    jstate, _, _, grads, _ = runs[0]
    n_live = 0
    for name in init:
        path, _ = _to_flax(name, init[name])
        ref = _at(jstate.grad_accum, path)
        got = grads[name]
        if got is None:
            np.testing.assert_array_equal(ref, np.zeros_like(ref), err_msg=name)
            continue
        n_live += 1
        np.testing.assert_allclose(_to_flax(name, got)[1], ref, rtol=0,
                                   atol=1e-4 * float(np.abs(ref).max()) + 1e-6, err_msg=name)
    assert n_live > 0


def test_tv_step_updates_params(fp32_pair):
    """Micro step 0 of an accumulation of 2 leaves every parameter as it
    was; micro step 1 updates the trained groups like the JAX step, and
    the ViT base and the still-gated audio backbone stay bit-equal."""
    _, init, runs = fp32_pair
    for name, p in runs[0][4].items():
        assert torch.equal(p, init[name]), name
    jstate, jm, _, _, after = runs[1]
    bound = 2 * max(float(jm[f"lr_{g}"]) for g in ("others", "text", "vit_lora")) + 1e-6
    moved = 0
    for name, p in after.items():
        path, got = _to_flax(name, p)
        np.testing.assert_allclose(got, _at(jstate.params, path), rtol=0, atol=bound,
                                   err_msg=name)
        frozen = name.startswith("audio_backbone") or (
            name.startswith("visual_backbone") and "lora" not in name)
        if frozen:
            assert torch.equal(p, init[name]), name
        else:
            moved += int(not torch.equal(p, init[name]))
    assert moved > 0
    assert float(jm["lr_others"]) > 0.0


def test_tv_step_without_accumulation_equals_two_micro_steps(fp32_pair):
    """Accumulating the same batch twice is one step on its gradient."""
    _, _, runs = fp32_pair
    for name, p in _run_pair_port_only(accum=1).items():
        torch.testing.assert_close(p, runs[1][4][name], rtol=0, atol=1e-6)


def _run_pair_port_only(accum):
    from triad_tpu_torch.models.convert import init_triad_model
    from triad_tpu_torch.train.optim import OptimizerBank
    from triad_tpu_torch.train.step import StepFactory, TrainState

    cfg = narrow_train_config("float32")
    loss_cfg = dataclasses.replace(perf_train_loss_config(), volume_dtype="float32")
    ocfg = OptimConfig(gradient_accumulation_steps=accum, unfreeze_text_step=0)
    model = init_triad_model(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    state = TrainState(model, OptimizerBank(ocfg, model, total_updates=20), 0, 1)
    step = StepFactory(loss_cfg, ocfg).make_step("tv")
    step(state, None, {k: torch.from_numpy(v) for k, v in _batch().items()})
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_tv_step_bf16():
    """bf16 compute with the full perf_train_loss_config (bf16 volume)."""
    from triad_tpu_torch.train.optim import label_for_path

    _, init, runs = _run_pair("bfloat16", "bfloat16", accum=2)
    jstate, jm, m, grads, _ = runs[0]
    stats = [k for k in jm if k.startswith("tv_")]
    scale = max(abs(float(jm[k])) for k in stats)  # the clip sims' magnitude
    for key in stats + ["loss_tv"]:
        ref = float(jm[key])
        bound = 5e-2 * (abs(ref) if key == "loss_tv" else scale)
        assert abs(float(m[key]) - ref) <= bound, (key, m[key], ref)
    by_group = {}
    for name, g in grads.items():
        if g is None:
            continue
        path, got = _to_flax(name, g)
        ref = _at(jstate.grad_accum, path)
        a, b = by_group.setdefault(label_for_path(name), ([], []))
        a.append(got.ravel())
        b.append(ref.ravel())
    assert set(by_group) == {"others", "text", "vit_lora"}
    for grp, (a, b) in by_group.items():
        a, b = np.concatenate(a), np.concatenate(b)
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos > 0.99, (grp, cos)


def test_unported_steps_raise():
    """Every curriculum step is ported now ("av" and "joint" are held to
    JAX in tests/test_torch_av_step.py); an unknown mode raises."""
    from triad_tpu.core.config import LossConfig
    from triad_tpu_torch.train.step import StepFactory

    factory = StepFactory(LossConfig(), OptimConfig())
    for mode in ("av", "tv", "joint"):
        assert callable(factory.make_step(mode)) and callable(factory.make_eval_loss(mode))
    with pytest.raises(ValueError, match="mode"):
        factory.make_step("audio")


# ---------------------------------------------------------------------------
# Live dropout (the two frameworks draw different bits: rates and seeds)
# ---------------------------------------------------------------------------


class TestDropout:
    def test_keep_rate_and_scale(self):
        from triad_tpu_torch.models.layers import dropout

        x = torch.ones(200_000)
        y = dropout(x, 0.1, torch.Generator().manual_seed(0))
        kept = y != 0
        assert abs(float(kept.float().mean()) - 0.9) < 0.005
        torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
        assert dropout(x, 0.1, None) is x

    def test_patch_dropout_rate(self):
        from triad_tpu_torch.models.layers import patch_dropout_mask

        keep = patch_dropout_mask(torch.Generator().manual_seed(0), (64, 256), 0.25)
        assert abs(float(keep.float().mean()) - 0.75) < 0.01

    def test_seeded_and_distinct(self):
        from triad_tpu_torch.models.convert import init_triad_model

        cfg = dataclasses.replace(narrow_train_config("float32"), visual_dropout_prob=0.25,
                                  text=dataclasses.replace(narrow_train_config("float32").text,
                                                           dropout=0.1, attention_dropout=0.1))
        model = init_triad_model(cfg, torch.Generator().manual_seed(0))
        b = {k: torch.from_numpy(v) for k, v in _batch().items()}

        def run(seed):
            g = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                return (model.encode_visual(b["images"], True, g),
                        model.encode_text(b["token_ids"], b["text_mask"], True, g))

        (v1, t1), (v2, t2), (v3, t3) = run(5), run(5), run(6)
        assert torch.equal(v1, v2) and torch.equal(t1, t2)
        assert not torch.equal(v1, v3) and not torch.equal(t1, t3)
        dropped = (v1.abs().sum(-1) == 0).float().mean()  # 8 tokens: rate tested above
        assert 0.0 < float(dropped) < 1.0
        with torch.no_grad():
            ev = model.encode_text(b["token_ids"], b["text_mask"])
        assert not torch.equal(t1, ev)

    def test_step_generator(self):
        from triad_tpu_torch.train.step import step_generator

        a = torch.rand(4, generator=step_generator(1, 3, "cpu"))
        assert torch.equal(a, torch.rand(4, generator=step_generator(1, 3, "cpu")))
        assert not torch.equal(a, torch.rand(4, generator=step_generator(1, 4, "cpu")))
        assert not torch.equal(a, torch.rand(4, generator=step_generator(2, 3, "cpu")))
