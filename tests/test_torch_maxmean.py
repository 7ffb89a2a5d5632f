"""The port's max-mean aggregation (``aggregate_crossbatch(implementation=
"pallas")``, ops/maxmean.py) against the JAX package's Pallas kernel
(``pallas_maxmean``) in interpret mode, on the CPU, at small sizes: the
clip sims, the non-negativity sum, and dQ, dK and dT through the AV and
TV losses; the first-argmax routing of a tie; the reference's refusals;
one narrow joint train step under the loss=pallas configuration against
the jitted JAX step; and the port's copies of ``apply_train_knobs`` and
``configs/default.yaml``.

Inputs come from numpy with a seed; the port's wrappers run their plain
twins (the tensors lie on the CPU). fp32 with TF32 off.

Tolerances, relative to the reference's largest magnitude: 1e-5 for the
aggregation and the loss gradients (fp32 sums in another order; the
test features keep every row's maximum apart from the runner-up, so the
routing is the same); the train step as tests/test_torch_av_step.py
(1e-4 plus 1e-6 absolute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from triad_tpu.core import config as JC

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BQ, BK, NK, D, TEMP = 3, 2, 128, 128, 1.5


def _close(got, ref, rel, name=""):
    got = got.detach().to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(float(np.abs(ref).max()), 1e-30),
                               err_msg=name)


def _feats(nq, seed, masked, bq=BQ):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(bq, nq, D)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(BK, NK, D)) * 0.3).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((bq, nq), np.float32)
        mask[0, nq // 2:] = 0.0
        mask[-1, 3:] = 0.0
    return q, k, mask


@pytest.mark.parametrize("nq,masked,clamp_min", [(37, False, -60.0), (20, True, -2.0)])
def test_aggregate_matches_pallas(nq, masked, clamp_min):
    """AV (unmasked) and TV (masked) shapes with Nq not a multiple of 128:
    clip sims, the clamp^2 sum and the real-token volume size (no
    diagonal: Bq != Bk, in both)."""
    from triad_tpu.ops.similarity import aggregate_crossbatch as jax_agg
    from triad_tpu_torch.ops.similarity import aggregate_crossbatch

    q, k, mask = _feats(nq, 0, masked)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_agg(jnp.asarray(q), jnp.asarray(k), jnp.float32(TEMP), clamp_min=clamp_min,
                      query_mask=None if mask is None else jnp.asarray(mask),
                      implementation="pallas")
    got = aggregate_crossbatch(torch.from_numpy(q), torch.from_numpy(k), torch.tensor(TEMP),
                               clamp_min=clamp_min,
                               query_mask=None if mask is None else torch.from_numpy(mask),
                               implementation="pallas")
    _close(got.clip_sims, ref.clip_sims, 1e-5, "clip")
    _close(got.nonneg_sq_sum, ref.nonneg_sq_sum, 1e-5, "nonneg")
    _close(got.volume_numel, ref.volume_numel, 0.0, "numel")
    assert ref.diag_token_sims is None and got.diag_token_sims is None  # Bq != Bk


def _loss_grads(loss, q, k, mask, cfg):
    """dQ, dK, dT of the JAX loss (Pallas in interpret mode) and the port's."""
    from triad_tpu.ops import av_loss as jax_av, tv_loss as jax_tv
    from triad_tpu_torch.config import LossConfig
    from triad_tpu_torch.ops.losses import av_loss, tv_loss

    def f(q, k, t):
        if loss == "av":
            return jax_av(q, k, t, cfg).total
        return jax_tv(q, k, jnp.asarray(mask), t, cfg).total

    with pltpu.force_tpu_interpret_mode():
        ref_total, refs = jax.value_and_grad(f, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.float32(TEMP))
    port_cfg = LossConfig(**dataclasses.asdict(cfg))
    leaves = [torch.from_numpy(q).requires_grad_(), torch.from_numpy(k).requires_grad_(),
              torch.tensor(TEMP, requires_grad=True)]
    if loss == "av":
        total = av_loss(*leaves, port_cfg).total
    else:
        total = tv_loss(leaves[0], leaves[1], torch.from_numpy(mask), leaves[2], port_cfg).total
    total.backward()
    return (ref_total, refs), (total, [x.grad for x in leaves])


@pytest.mark.parametrize("loss", ["av", "tv"])
def test_loss_grads_match_pallas(loss):
    """jax.grad of av_loss / tv_loss with implementation="pallas" (the clip
    sims, the nonneg regulariser and, for AV, the smoothness term over the
    diagonal): the loss, dQ, dK and dT."""
    cfg = JC.LossConfig(implementation="pallas", chunk_size=32, matmul_precision="default",
                        tv_nonneg_clamp_min=-2.0, av_nonneg_clamp_min=-3.0)
    q, k, mask = _feats(37, 1, True, bq=BK)  # the losses' diagonal needs Bq == Bk
    (ref_total, refs), (total, grads) = _loss_grads(loss, q, k, mask, cfg)
    _close(total, ref_total, 1e-5, "loss")
    for name, g, r in zip(("dq", "dk", "dT"), grads, refs):
        _close(g, r, 1e-5, name)


def test_tie_routes_to_the_first_argmax():
    """Two equal key tokens make every max over them an exact tie: the
    Pallas kernel and the port route the whole gradient to the first one
    (the second gets only the clamp window's share), where the chunked_vjp
    aggregation (XLA's rule) splits it evenly."""
    from triad_tpu.ops.similarity import aggregate_crossbatch as jax_agg
    from triad_tpu_torch.ops.similarity import aggregate_crossbatch

    q, k, _ = _feats(20, 2, False)
    k[:, 1] = k[:, 0]
    q[:, :, :] += k[0, 0] * 2.0  # make key 0 (and its copy) every row's max in clip 0
    g_clip = np.arange(BQ * BK, dtype=np.float32).reshape(BQ, BK) / 7.0 + 0.5

    def jf(q, k):
        agg = jax_agg(q, k, jnp.float32(TEMP), clamp_min=-60.0, implementation="pallas",
                      compute_diag=False)
        return jnp.sum(agg.clip_sims * g_clip)

    with pltpu.force_tpu_interpret_mode():
        jdq, jdk = jax.grad(jf, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))

    def port(impl):
        leaves = [torch.from_numpy(q).requires_grad_(), torch.from_numpy(k).requires_grad_()]
        agg = aggregate_crossbatch(*leaves, torch.tensor(TEMP), clamp_min=-60.0,
                                   implementation=impl, compute_diag=False)
        (agg.clip_sims * torch.from_numpy(g_clip)).sum().backward()
        return [x.grad for x in leaves]

    dq, dk = port("pallas")
    _close(dq, jdq, 1e-5, "dq")
    _close(dk, jdk, 1e-5, "dk")
    # clip 0: key 0 takes every row's gradient, its copy none
    assert float(dk[0, 0].abs().sum()) > 0.0 and float(dk[0, 1].abs().sum()) == 0.0
    _, dk_split = port("chunked_vjp")
    torch.testing.assert_close(dk_split[0, 0], dk_split[0, 1])
    assert not torch.allclose(dk_split[0, 0], dk[0, 0])


@pytest.mark.parametrize("nk,d,volume", [(100, 128, "float32"), (128, 96, "float32"),
                                         (128, 128, "bfloat16")])
def test_refusals_match_the_reference(nk, d, volume):
    """Nk and D must be multiples of 128 and the volume float32, in both."""
    from triad_tpu.ops.similarity import aggregate_crossbatch as jax_agg
    from triad_tpu_torch.ops.similarity import aggregate_crossbatch

    q = np.zeros((2, 5, d), np.float32)
    k = np.zeros((2, nk, d), np.float32)
    with pytest.raises(ValueError):
        jax_agg(jnp.asarray(q), jnp.asarray(k), jnp.float32(1.0), clamp_min=-1.0,
                implementation="pallas", volume_dtype=volume)
    with pytest.raises(ValueError):
        aggregate_crossbatch(torch.from_numpy(q), torch.from_numpy(k), torch.tensor(1.0),
                             clamp_min=-1.0, implementation="pallas", volume_dtype=volume)


# ---------------------------------------------------------------------------
# A joint step under loss=pallas, the mqkv + vitmq model
# ---------------------------------------------------------------------------


def test_joint_step_matches_jax():
    """One joint micro step of a narrow apply_train_knobs(.., "mqkv,vitmq")
    model (merged-qkv training attention in HuBERT and the ViT; 256 patches
    of a 32^2 image at patch size 2 and a 128-d embedding, as the kernel's
    Nk and D need multiples of 128) under LossConfig(implementation=
    "pallas", chunk_size=32, matmul_precision="default"), every rate at 0:
    the metrics and every gradient against the jitted JAX step."""
    import triad_tpu.train as JT
    from tests.test_torch_av_step import av_train_config
    from tests.test_torch_train_step import _at, _to_flax
    from triad_tpu_torch.config import LossConfig
    from triad_tpu_torch.config import apply_train_knobs as port_knobs
    from triad_tpu_torch.models.convert import init_triad_model, torch_to_flax
    from triad_tpu_torch.train.optim import OptimizerBank
    from triad_tpu_torch.train.step import StepFactory, TrainState

    base = av_train_config()
    base = dataclasses.replace(
        base, embedding_dim=128,
        vit=dataclasses.replace(base.vit, image_size=32, patch_size=2, num_layers=1),
        hubert=dataclasses.replace(base.hubert, num_layers=1),
        text=dataclasses.replace(base.text, num_layers=1))
    cfg = JC.apply_train_knobs(base, "mqkv,vitmq")
    assert cfg.hubert.attention_impl == cfg.vit.attention_impl == "fused_packed_merged"
    jloss = JC.LossConfig(implementation="pallas", chunk_size=32, matmul_precision="default")
    ocfg = JC.OptimConfig(gradient_accumulation_steps=2, unfreeze_audio_step=0,
                          unfreeze_text_step=0)
    model = init_triad_model(port_knobs(base, "mqkv,vitmq"), torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    params = jax.tree.map(jnp.asarray, torch_to_flax(model.state_dict()))
    rng = np.random.default_rng(3)
    av = {"images": rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
          "audio": (rng.normal(size=(2, 8000)) * 0.1).astype(np.float32)}
    tv = {"images": rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
          "token_ids": rng.integers(1, 100, size=(2, 8)).astype(np.int32),
          "text_mask": np.array([[1] * 8, [1] * 6 + [0] * 2], np.float32)}
    jbank = JT.OptimizerBank(ocfg, JT.ParamPartition(params), total_updates=20)
    jstep = jax.jit(JT.StepFactory(cfg, jloss, ocfg, jbank).make_step("joint"))
    jstate = JT.init_train_state(params, jbank, jax.random.key(1))
    with pltpu.force_tpu_interpret_mode():
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in av.items()},
                           {k: jnp.asarray(v) for k, v in tv.items()}, jnp.float32(0.7),
                           jnp.float32(0.3))
    # micro step 0 of 2: no update yet, the gradients stay in .grad
    state = TrainState(model, OptimizerBank(ocfg, model, total_updates=20), 0, 1)
    step = StepFactory(LossConfig(**dataclasses.asdict(jloss)), ocfg).make_step("joint")
    state, m = step(state, {k: torch.from_numpy(v) for k, v in av.items()},
                    {k: torch.from_numpy(v) for k, v in tv.items()}, 0.7, 0.3)
    assert sorted(m) == sorted(jm)
    for key, ref in jm.items():
        ref = float(ref)
        assert abs(float(m[key]) - ref) <= 1e-4 * abs(ref) + 1e-5, (key, m[key], ref)
    live = {n for n, p in model.named_parameters() if p.grad is not None}
    for proj in ("q_proj", "k_proj", "v_proj"):
        assert f"audio_backbone.layers.0.attention.{proj}.weight" in live, proj
    assert any("attn.qkv.lora_a" in n for n in live)
    for name, p in model.named_parameters():
        path, _ = _to_flax(name, p)
        ref = _at(jstate.grad_accum, path)
        if p.grad is None:
            np.testing.assert_array_equal(ref, np.zeros_like(ref), err_msg=name)
            continue
        np.testing.assert_allclose(_to_flax(name, p.grad)[1], ref, rtol=0,
                                   atol=1e-4 * float(np.abs(ref).max()) + 1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# The port's copies of apply_train_knobs and configs/default.yaml
# ---------------------------------------------------------------------------


JAX_KNOBS = ("perf", "tanh", "pkattn", "mqkv", "vitpk", "vitmq", "monofe", "posconv", "wave640",
             "wavext", "rematconv", "noremat", "mlprows2", "mlprows4", "attnpad", "pad128",
             "lorasep", "vitrows2")  # the known set of triad_tpu/core/config.py:apply_train_knobs
UNREAD_KNOBS = ("wave640", "wavext", "attnpad", "pad128", "mlprows2", "mlprows4", "vitrows2")


@pytest.mark.parametrize("knobs", ["perf", "mqkv,vitmq", "perf,mqkv,vitmq", "tanh,pkattn,mqkv",
                                   "lorasep,vitpk,pkattn", "monofe,posconv,tanh,vitmq",
                                   "rematconv", "perf,noremat", "rematconv,noremat,mqkv"])
def test_apply_train_knobs_equals_jax(knobs):
    from triad_tpu_torch import config as PC

    for jbase, pbase in ((JC.ModelConfig(), PC.ModelConfig()),
                         (JC.perf_train_model_config(), PC.perf_train_model_config())):
        assert dataclasses.asdict(JC.apply_train_knobs(jbase, knobs)) == dataclasses.asdict(
            PC.apply_train_knobs(pbase, knobs))
    with pytest.raises(ValueError, match="unknown train knobs"):
        PC.apply_train_knobs(PC.ModelConfig(), knobs + ",nosuchknob")


@pytest.mark.parametrize("knob", [k for k in JAX_KNOBS if k != "perf"])
def test_knob_table_equals_jax(knob):
    """Each row of the port's knob table sets the fields JAX's
    apply_train_knobs sets for that knob, those the port refuses included."""
    from triad_tpu_torch import config as PC

    assert set(PC._KNOBS) == set(JAX_KNOBS)
    hubert, vit = PC._KNOBS[knob]
    for base in (JC.ModelConfig(), JC.perf_train_model_config()):
        want = dataclasses.replace(base, hubert=dataclasses.replace(base.hubert, **hubert),
                                   vit=dataclasses.replace(base.vit, **vit))
        assert JC.apply_train_knobs(base, knob) == want


@pytest.mark.parametrize("knob", UNREAD_KNOBS)
def test_unread_knobs_raise(knob):
    """A knob that only sets a field the port ignores raises, alone or in a
    set, instead of running a model identical to the baseline."""
    from triad_tpu_torch import config as PC
    from triad_tpu_torch.models import IGNORED_TPU_KNOBS

    hubert, vit = PC._KNOBS[knob]
    assert set(hubert) | set(vit) <= set(IGNORED_TPU_KNOBS)
    for knobs in (knob, f"perf,{knob},mqkv"):
        with pytest.raises(NotImplementedError, match=knob):
            PC.apply_train_knobs(PC.ModelConfig(), knobs)


def test_default_yaml_equals_the_ports_dict():
    """configs/default.yaml, loaded as the JAX CLI loads it, equals the
    port's dict literal, and both build the same Config."""
    import os

    import yaml

    from triad_tpu.cli.train import _deep_update
    from triad_tpu_torch.config import DEFAULT_TRAIN_CONFIG, default_train_config

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs", "default.yaml")
    with open(path) as f:
        loaded = yaml.safe_load(f)
    assert loaded == DEFAULT_TRAIN_CONFIG
    base = JC.Config().to_dict()
    _deep_update(base, loaded)
    assert JC.Config.from_dict(base).to_dict() == default_train_config().to_dict()
