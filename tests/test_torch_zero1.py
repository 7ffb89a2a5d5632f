"""The port's world-2 joint step (``StepFactory(mesh=...)``, ZeRO-1 by
default) on the CPU:

(c) the dry-run model of ``__graft_entry__.py:_small_model_cfg`` at
    dropout 0 (loss "chunked", chunk 2, every group unfrozen), its
    parameters carried over from JAX's ``init_triad_model(cfg, key(0))``,
    against JAX's single-device step on the concatenated B = 16 batch:
    metrics within 1e-5 of their magnitude (plus 1e-6 for those near 0),
    updated parameters within 1e-5;
(d) a narrow model whose HuBERT runs the training kernels' plain twins
    (packed attention, fused MLP, dropout + add + LayerNorm; heads of 64)
    with every dropout live, patch dropout, SpecAugment and layerdrop
    included: the ZeRO-1 step against the replicated one, both at world
    2, and against the one-process step, within 1e-5 relative (only the
    order of the cross-rank sums, and of products over fewer rows,
    differs; the attention key biases, whose gradient is 0 up to rounding,
    within two Adam steps); each rank's moments sliced by
    ``shard_largest_dim``.

One gloo world of 2 CPU processes (``tests/torch_dp_worker.py``), started
once for the file, runs both steps.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dp_worker import _step_run, computed_once, spawn_world
from triad_tpu.core.config import (
    Config,
    DistilBertConfig,
    HubertConfig,
    LossConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
    ViTConfig,
    perf_train_model_config,
)

B = 16
W_AV, W_TV = 0.7, 0.3
_UNFROZEN = OptimConfig(gradient_accumulation_steps=1, unfreeze_audio_step=0,
                        unfreeze_text_step=0, unfreeze_vit_step=0)
_LOWP = dataclasses.replace(_UNFROZEN, mu_dtype="bfloat16", nu_dtype="bfloat16")


def _dryrun_model():
    return ModelConfig(
        embedding_dim=32, compute_dtype="float32", visual_dropout_prob=0.0,
        vit=ViTConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=4),
        hubert=HubertConfig(
            hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0,
            feat_proj_dropout=0.0, layerdrop=0.0, apply_spec_augment=False),
        text=DistilBertConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                              intermediate_size=64, max_position_embeddings=64, dropout=0.0,
                              attention_dropout=0.0),
    )


def _live_model():
    """Heads of 64, HuBERT on the training kernels' twins, every dropout live."""
    base = perf_train_model_config()
    return dataclasses.replace(
        base, embedding_dim=64, compute_dtype="float32", visual_dropout_prob=0.25,
        vit=dataclasses.replace(base.vit, image_size=28, hidden_size=128, num_heads=2,
                                num_layers=2, mlp_ratio=2.0),
        hubert=dataclasses.replace(
            base.hubert, hidden_size=128, num_heads=2, num_layers=2, intermediate_size=256,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2), frontend_impl="conv", mlp_impl="fused", ln_impl="fused", hidden_dropout=0.1,
            activation_dropout=0.1, attention_dropout=0.1, feat_proj_dropout=0.1,
            layerdrop=0.3, mask_time_prob=0.2, mask_time_length=3),
        text=dataclasses.replace(base.text, vocab_size=128, hidden_size=128, num_heads=2,
                                 num_layers=2, intermediate_size=256,
                                 max_position_embeddings=64, dropout=0.1,
                                 attention_dropout=0.1),
    )


def _batches(audio):
    rng = np.random.default_rng(0)
    av = {"images": rng.normal(size=(B, 28, 28, 3)).astype(np.float32),
          "audio": (rng.normal(size=(B, audio)) * 0.3).astype(np.float32)}
    mask = np.ones((B, 8), np.float32)
    mask[1::2, 6:] = 0.0
    tv = {"images": rng.normal(size=(B, 28, 28, 3)).astype(np.float32),
          "token_ids": rng.integers(1, 128, size=(B, 8)).astype(np.int32),
          "text_mask": mask}
    return av, tv


def _spec(model_cfg, loss_cfg, state, av, tv, seed, optim=_UNFROZEN):
    cfg = Config(model=model_cfg, loss=loss_cfg, train=TrainConfig(optim=optim))
    return {"config": dataclasses.asdict(cfg), "state": state, "seed": seed,
            "av": {k: torch.from_numpy(v) for k, v in av.items()},
            "tv": {k: torch.from_numpy(v) for k, v in tv.items()}, "w_av": W_AV, "w_tv": W_TV}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return computed_once(tmp_path_factory, "torch_zero1", _compute)


def _compute(workdir):
    """The world-2 results of both steps, the JAX dry-run step (metrics and
    parameters), and the one-process live step (metrics and parameters)."""
    import triad_tpu.train as JT
    from triad_tpu.models import init_triad_model
    from triad_tpu_torch.models.convert import flax_to_torch, init_triad_model as port_init

    # (c) the dry-run model from JAX's init
    cfg = _dryrun_model()
    loss_cfg = LossConfig(implementation="chunked", chunk_size=2)
    params = init_triad_model(cfg, jax.random.key(0))
    av, tv = _batches(800)
    torch.save(_spec(cfg, loss_cfg, flax_to_torch(params, _port(cfg)), av, tv, 2),
               workdir / "dryrun.pt")
    # (d) the live-dropout model from the port's init
    live = _live_model()
    model = port_init(_port(live), torch.Generator().manual_seed(3))
    lav, ltv = _batches(1600)
    torch.save(_spec(live, loss_cfg, model.state_dict(), lav, ltv, 5), workdir / "live.pt")
    # (e) the live model with bf16 Adam moments
    torch.save(_spec(live, loss_cfg, model.state_dict(), lav, ltv, 5, _LOWP), workdir / "lowp.pt")

    errors = []

    def world2():
        try:
            spawn_world("steps", 2, workdir)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    ranks = threading.Thread(target=world2)  # the ranks run beside JAX's step
    ranks.start()
    jbank = JT.OptimizerBank(_UNFROZEN, JT.ParamPartition(params), total_updates=100)
    jstate = JT.init_train_state(params, jbank, jax.random.key(1))
    jstep = jax.jit(JT.StepFactory(cfg, loss_cfg, _UNFROZEN, jbank).make_step("joint"))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in av.items()},
                       {k: jnp.asarray(v) for k, v in tv.items()}, jnp.float32(W_AV),
                       jnp.float32(W_TV))
    m1, p1, _ = _step_run(workdir, 0, 1, "live", zero1=False, mesh_on=False)
    _, q1, lowp_bank = _step_run(workdir, 0, 1, "lowp", zero1=False, mesh_on=False)
    ranks.join()
    if errors:
        raise errors[0]
    got = dict(np.load(workdir / "steps-2.npz"))
    lowp = {"params": {n: p.numpy() for n, p in q1.items()},
            "moments": {f"{name}/{k}": opt.state[p][k] for g, opt in lowp_bank.opts.items()
                        for name, p in zip(lowp_bank.names[g], lowp_bank.groups[g])
                        for k in ("exp_avg", "exp_avg_sq")},
            "slices": [torch.load(workdir / f"lowp-slices-{r}.pt") for r in range(2)]}
    return (got, (jax.tree.map(np.asarray, jstate.params), {k: float(v) for k, v in jm.items()}),
            ({k: float(v) for k, v in m1.items()}, {n: p.numpy() for n, p in p1.items()}), lowp)


def _port(jax_model_cfg):
    from triad_tpu_torch.config import ModelConfig as PortModel
    from triad_tpu_torch.config import _from_dict

    return _from_dict(PortModel, dataclasses.asdict(jax_model_cfg))


def _flax_leaf(tree, name, like):
    from triad_tpu_torch.models.convert import torch_to_flax

    node, path = torch_to_flax({name: torch.zeros(like.shape)}), []
    while isinstance(node, dict):
        path.append(next(iter(node)))
        node = node[path[-1]]
    for key in path:
        tree = tree[key]
    return np.asarray(tree, np.float32), node.shape


def _flax_layout(name, value):
    from triad_tpu_torch.models.convert import torch_to_flax

    node = torch_to_flax({name: torch.from_numpy(value)})
    while isinstance(node, dict):
        node = node[next(iter(node))]
    return np.asarray(node)


def test_dryrun_step_matches_jax(world):
    got, (jparams, jm), *_ = world
    checked = 0
    for key, ref in jm.items():
        mine = got.get(f"dryrun/zero1/metric/{key}")
        assert mine is not None, key
        ref = float(ref)
        assert abs(float(mine) - ref) <= 1e-5 * abs(ref) + 1e-6, (key, float(mine), ref)
        checked += 1
    assert checked >= 20
    names = [k.split("/", 3)[3] for k in got if k.startswith("dryrun/zero1/param/")]
    assert len(names) > 100
    for name in names:
        mine = _flax_layout(name, got[f"dryrun/zero1/param/{name}"])
        ref, _ = _flax_leaf(jparams, name, mine)
        np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-5, err_msg=name)


def test_zero1_shards_moments(world):
    got = world[0]
    assert int(got["live/zero1/moments_checked"]) > 50
    assert int(got["live/zero1/moment_bytes"]) < int(got["live/replicated/moment_bytes"])


@pytest.mark.parametrize("other", ["replicated", "one_process"])
def test_live_dropout_zero1_step(world, other):
    """With every dropout live, the ZeRO-1 world-2 step gives the
    replicated world-2 step's and the one-process step's metrics and
    parameters (each rank's rows draw what one process draws for them)."""
    got, _, (m1, p1), _ = world
    if other == "replicated":
        ref_m = {k.split("/", 3)[3]: float(v) for k, v in got.items()
                 if k.startswith("live/replicated/metric/")}
        ref_p = {k.split("/", 3)[3]: v for k, v in got.items()
                 if k.startswith("live/replicated/param/")}
    else:
        ref_m, ref_p = m1, p1
    assert len(ref_m) >= 20 and len(ref_p) > 100
    for key, ref in ref_m.items():
        mine = float(got[f"live/zero1/metric/{key}"])
        assert abs(mine - ref) <= 1e-5 * abs(ref) + 1e-7, (key, mine, ref)
    # A key bias's gradient is 0 up to rounding (the softmax ignores it),
    # so Adam's first step moves it by about lr at the sign of the rounding
    # noise, which a product over fewer rows may flip: those leaves are held
    # to two steps' width.
    step = 2 * max(ref_m[f"lr_{g}"] for g in ("others", "audio", "text", "vit_lora"))
    for name, ref in ref_p.items():
        mine = got[f"live/zero1/param/{name}"]
        if other == "one_process" and name.endswith(("k_proj.bias", "k_lin.bias")):
            np.testing.assert_allclose(mine, ref, rtol=0, atol=step, err_msg=name)
        else:
            np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-7, err_msg=name)


def test_zero1_bf16_moments(world):
    """(e) the live step with bf16 Adam moments under ZeRO-1 at world 2:
    each rank's moment slices are bf16; the checkpoint's gather
    (``full_state_dicts``, C.gather_rows over gloo) returns whole bf16
    moments equal bit for bit to the ranks' slices in rank order; against
    the one-process bf16 step the parameters within 1e-5 relative plus
    2^-7 of the largest lr (a moment that rounds to the other bf16 neighbour
    moves its update by about 2^-8 lr; the key biases within two steps, as
    above) and the moments within two bf16 ulps of each leaf's largest (the
    key biases' moments, of rounding noise, not compared)."""
    got, _, _, lowp = world
    slices, moments = lowp["slices"], lowp["moments"]
    names = sorted(moments)
    assert len(names) > 200
    sharded = 0
    for key in names:
        assert str(got[f"lowp/whole_dtype/{key}"]) == "torch.bfloat16", key
        whole = torch.from_numpy(got[f"lowp/whole/{key}"]).view(torch.bfloat16)
        parts = [slices[r][key] for r in range(2)]
        assert all(t.dtype == torch.bfloat16 for t in parts), key
        if parts[0].shape == whole.shape:
            assert torch.equal(parts[0], whole) and torch.equal(parts[1], whole), key
        else:
            dim = next(d for d, (a, b) in enumerate(zip(parts[0].shape, whole.shape)) if a != b)
            assert torch.equal(torch.cat(parts, dim), whole), key
            sharded += 1
        ref = moments[key].to(torch.float32)
        assert moments[key].dtype == torch.bfloat16
        if key.split("/")[0].endswith(("k_proj.bias", "k_lin.bias")):
            continue  # moments of rounding noise
        ulp = 2.0 ** (np.floor(np.log2(max(float(ref.abs().max()), 2.0 ** -126))) - 7)
        assert float((whole.to(torch.float32) - ref).abs().max()) <= 2 * ulp, key
    assert sharded > 50
    lr = max(float(got[f"lowp/zero1/metric/lr_{g}"]) for g in ("others", "audio", "text",
                                                                 "vit_lora"))
    for name, ref in lowp["params"].items():
        mine = got[f"lowp/zero1/param/{name}"]
        atol = 2 * lr if name.endswith(("k_proj.bias", "k_lin.bias")) else 2.0 ** -7 * lr + 1e-7
        np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=atol, err_msg=name)
