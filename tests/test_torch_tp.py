"""The port's tensor parallelism (``triad_tpu_torch/parallel/tp.py``) on the
CPU, against the JAX package:

(a) ``tp_param_specs`` equals JAX's ``tp_param_specs`` leaf for leaf after
    ``models/convert.py``'s name and layout map (the Megatron rules, and
    tp = 7, where nothing divides); a split inside a head raises; the
    ZeRO-1 x TP moment specs equal JAX's ``zero1_state_shardings``; the
    rank-to-coordinate maps of ``make_dp_tp_mesh`` and
    ``make_multislice_tp_mesh`` are JAX's device grids.
(b) One joint step of a narrow model (heads of 8, every dropout off, fp32)
    under each layout, as gloo worlds of CPU processes, against JAX's
    jitted single-device step on the same parameters and global batch:
    loss rtol 2e-5, every updated parameter rtol 5e-5, atol 1e-5 (JAX's
    own bounds, tests/test_tp.py). Layouts: tp 2 (world 2), dp 2 x tp 2
    (world 4) without and with ZeRO-1, TP x multi-slice 2 x 1 x 2.
(c) The same worlds with every dropout live (attention, activation,
    hidden, feature projection, layerdrop, SpecAugment, patch dropout)
    against the port's one-process step: metrics within 1e-5 relative,
    parameters within 1e-5 relative (the attention key biases, whose
    gradient is 0 up to rounding, within two Adam steps).
(d) A bf16 column-parallel Dense, GELU and a row-parallel Dense at tp 2
    (the bf16 path, which the fp32 steps above do not take) against the
    one-process bf16 layers and the fp32 result.

The worlds (``tests/torch_dp_worker.py``, case "layouts") run once a
session for this file and tests/test_torch_fsdp.py together.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tests.torch_dp_worker import LAYOUTS, bf16_pair, computed_once, layout_run, spawn_world
from triad_tpu.core.config import (
    Config,
    DistilBertConfig,
    HubertConfig,
    LossConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
    ViTConfig,
)

B = 8
W_AV, W_TV = 0.7, 0.3
TP_LAYOUTS = ("tp2", "dp2tp2", "dp2tp2_zero1", "tp2_slices")
LOSS = LossConfig(implementation="chunked", chunk_size=2)


def _optim(accum=1):
    return OptimConfig(gradient_accumulation_steps=accum, unfreeze_audio_step=0,
                       unfreeze_text_step=0, unfreeze_vit_step=0)


# HuBERT's frontend chunks: 800 samples give 79 tokens, so its chunked
# frontend (the default remat, on the "conv" frontend the layouts resolve
# to) runs 5 blocks of up to 16 tokens, each again in the backward; FSDP
# shards conv_1's weight (3072 elements), which the blocks read gathered.
CHUNK = 16
BLOCKS = -(-79 // CHUNK)


def model_config(live=False):
    """The narrow model: heads of 8 in every encoder (4 heads, 2 a rank at
    tp 2), a vocabulary of 128 (64 rows a rank); dropouts off, or live."""
    r = 0.1 if live else 0.0
    return ModelConfig(
        embedding_dim=32, compute_dtype="float32", visual_dropout_prob=0.25 if live else 0.0,
        vit=ViTConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=4),
        hubert=HubertConfig(
            hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2),
            frontend_chunk_tokens=CHUNK, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, hidden_dropout=r, activation_dropout=r, attention_dropout=r, feat_proj_dropout=r,
            layerdrop=0.3 if live else 0.0, apply_spec_augment=live,
            mask_time_prob=0.2 if live else 0.05, mask_time_length=3),
        text=DistilBertConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                              intermediate_size=64, max_position_embeddings=64, dropout=r,
                              attention_dropout=r),
    )


def port(jax_cfg):
    """The port's copy of a JAX config dataclass, with the impl knobs
    resolved to the plain route (as the Trainer resolves them)."""
    from triad_tpu_torch.config import ModelConfig as PortModel
    from triad_tpu_torch.config import _from_dict
    from triad_tpu_torch.parallel.tp import resolve_xla_impls

    return resolve_xla_impls(_from_dict(PortModel, dataclasses.asdict(jax_cfg)))


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        av = {"images": rng.normal(size=(B, 28, 28, 3)).astype(np.float32),
              "audio": (rng.normal(size=(B, 800)) * 0.3).astype(np.float32)}
        mask = np.ones((B, 8), np.float32)
        mask[1::2, 6:] = 0.0
        tv = {"images": rng.normal(size=(B, 28, 28, 3)).astype(np.float32),
              "token_ids": rng.integers(1, 128, size=(B, 8)).astype(np.int32),
              "text_mask": mask}
        out.append((av, tv))
    return out


def _spec(model_cfg, state, batches, accum, layouts):
    cfg = Config(model=model_cfg, loss=LOSS, train=TrainConfig(optim=_optim(accum)))
    d = dataclasses.asdict(cfg)
    d["model"] = dataclasses.asdict(port(model_cfg))
    return {"config": d, "state": state, "seed": 5, "w_av": W_AV, "w_tv": W_TV,
            "layouts": layouts,
            "batches": [({k: torch.from_numpy(v) for k, v in av.items()},
                         {k: torch.from_numpy(v) for k, v in tv.items()}) for av, tv in batches]}


def _jax_steps(params, batches, accum):
    import triad_tpu.train as JT

    ocfg = _optim(accum)
    bank = JT.OptimizerBank(ocfg, JT.ParamPartition(params), total_updates=100)
    state = JT.init_train_state(params, bank, jax.random.key(1))
    step = jax.jit(JT.StepFactory(model_config(), LOSS, ocfg, bank).make_step("joint"))
    for av, tv in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in av.items()},
                        {k: jnp.asarray(v) for k, v in tv.items()}, jnp.float32(W_AV),
                        jnp.float32(W_TV))
    from triad_tpu_torch.models.convert import tree_to_state

    return ({k: float(v) for k, v in m.items()},
            {n: t.numpy() for n, t in tree_to_state(jax.tree.map(np.asarray, state.params)).items()})


def _compute(workdir):
    """Every layout's world results (keys "exact": one step against JAX;
    "accum2": two micro steps, accumulation 2; "live": dropouts live
    against one process), JAX's references and the one-process live run."""
    from triad_tpu.models import init_triad_model
    from triad_tpu_torch.models.convert import flax_to_torch, init_triad_model as port_init

    cfg = model_config()
    params = init_triad_model(cfg, jax.random.key(0))
    state = flax_to_torch(params, port(cfg))
    exact, accum2 = _batches(1, 0), _batches(2, 1)
    torch.save(_spec(cfg, state, exact, 1, [k for k in LAYOUTS]), workdir / "exact.pt")
    torch.save(_spec(cfg, state, accum2, 2, ["fsdp"]), workdir / "accum2.pt")
    live = model_config(live=True)
    live_state = port_init(port(live), torch.Generator().manual_seed(3)).state_dict()
    torch.save(_spec(live, live_state, _batches(1, 2), 1, [k for k in LAYOUTS]),
               workdir / "live.pt")
    g = torch.Generator().manual_seed(7)
    torch.save([torch.randn(s, generator=g) * a for s, a in (
        ((4, 33, 64), 1.0), ((128, 64), 0.125), ((128,), 0.1), ((64, 128), 0.09), ((64,), 0.1))],
        workdir / "bf16_pair.pt")

    errors = []

    def world(n):
        try:
            spawn_world("layouts", n, workdir)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    ranks = [threading.Thread(target=world, args=(n,)) for n in (2, 4)]
    for t in ranks:  # the ranks run beside JAX's steps
        t.start()
    refs = {"exact": _jax_steps(params, exact, 1), "accum2": _jax_steps(params, accum2, 2)}
    m1, p1, b1, mb1 = layout_run(workdir, "live", None)
    refs["live"] = (m1, {n: p.numpy() for n, p in p1.items()})
    pair = torch.load(workdir / "bf16_pair.pt")
    refs["bf16_pair"] = [t.numpy() for t in bf16_pair(*pair)] + [
        t.numpy() for t in _fp32_pair(*pair)]
    for t in ranks:
        t.join()
    if errors:
        raise errors[0]
    got = {}
    for n in (2, 4):
        got.update(np.load(workdir / f"layouts-{n}.npz"))
    return {"got": got, "refs": refs, "one_process_bytes": (b1, mb1)}


def _fp32_pair(x, w1, b1, w2, b2):
    x = x.clone().requires_grad_()
    y = torch.nn.functional.linear(torch.nn.functional.gelu(
        torch.nn.functional.linear(x, w1, b1)), w2, b2)
    (y ** 2).sum().backward()
    return y.detach(), x.grad


@pytest.fixture(scope="module")
def layout_worlds(tmp_path_factory):
    return computed_once(tmp_path_factory, "torch_tp_layouts", _compute)


def _results(worlds, key, layout):
    got = worlds["got"]
    pre = f"{key}/{layout}/"
    metrics = {k[len(pre) + 7:]: float(v) for k, v in got.items()
               if k.startswith(pre + "metric/")}
    params = {k[len(pre) + 6:]: v for k, v in got.items() if k.startswith(pre + "param/")}
    return metrics, params


def held_loss_to_jax(worlds, key, layout):
    metrics, _ = _results(worlds, key, layout)
    ref, _ = worlds["refs"][key]
    np.testing.assert_allclose(metrics["train_loss"], ref["train_loss"], rtol=2e-5)
    for k in ("loss_av", "loss_tv", "temperature"):
        np.testing.assert_allclose(metrics[k], ref[k], rtol=2e-5, err_msg=k)


def held_params_to_jax(worlds, key, layout):
    _, params = _results(worlds, key, layout)
    _, ref = worlds["refs"][key]
    assert sorted(params) == sorted(ref) and len(ref) > 100
    for name, want in ref.items():
        np.testing.assert_allclose(params[name], want, rtol=5e-5, atol=1e-5, err_msg=name)


def held_to_one_process(worlds, layout):
    """Dropouts live: the layout's metrics and parameters against the
    one-process step's."""
    metrics, params = _results(worlds, "live", layout)
    ref_m, ref_p = worlds["refs"]["live"]
    assert len(ref_m) >= 20 and sorted(params) == sorted(ref_p)
    for k, ref in ref_m.items():
        assert abs(metrics[k] - ref) <= 1e-5 * abs(ref) + 1e-7, (k, metrics[k], ref)
    # A key bias's gradient is 0 up to rounding (the softmax ignores it), so
    # Adam's first step moves it by about lr at the sign of the rounding
    # noise (tests/test_torch_zero1.py).
    step = 2 * max(ref_m[f"lr_{g}"] for g in ("others", "audio", "text", "vit_lora"))
    for name, ref in ref_p.items():
        if name.endswith(("k_proj.bias", "k_lin.bias")):
            np.testing.assert_allclose(params[name], ref, rtol=0, atol=step, err_msg=name)
        else:
            np.testing.assert_allclose(params[name], ref, rtol=1e-5, atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# (a) specs and meshes
# ---------------------------------------------------------------------------


def _jax_params():
    from triad_tpu.models import init_triad_model

    return init_triad_model(model_config(), jax.random.key(0))


def _port_model():
    from triad_tpu_torch.models.convert import init_triad_model

    return init_triad_model(port(model_config()), torch.Generator().manual_seed(0))


def jax_specs_by_name(tree):
    """{state-dict name: PartitionSpec entries, trailing Nones dropped} of a
    params-shaped tree of PartitionSpecs."""
    from triad_tpu_torch.models.convert import _LIST_ITEM, _LIST_NAMES

    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda s: isinstance(s, P))
    for path, spec in flat:
        keys = [p.key for p in path]
        parts = []
        for k in keys[:-1]:
            m = _LIST_ITEM.match(k)
            parts += [_LIST_NAMES[m[1]], m[2]] if m else [k]
        parts.append({"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1]))
        out[".".join(parts)] = _strip(tuple(spec))
    return out


def _strip(entries):
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def port_specs_in_flax_layout(specs):
    """{name: a torch-layout spec over the Flax leaf's dims, trailing Nones
    dropped}."""
    from triad_tpu_torch.models.convert import flax_dims

    out = {}
    for name, spec in specs.items():
        entries = [None] * len(spec)
        for i, j in enumerate(flax_dims(name, len(spec))):
            entries[j] = spec[i]
        out[name] = _strip(entries)
    return out


def fake_world(monkeypatch, n, rank=0):
    """Mesh arithmetic of an n-process world in this one process (no
    process group: no collective runs)."""
    from triad_tpu_torch.parallel import collectives as C

    monkeypatch.setattr(C, "world", lambda group=None: n)
    monkeypatch.setattr(C, "rank", lambda group=None: rank)


@pytest.mark.parametrize("tp", [2, 7])
def test_tp_specs_match_jax(tp):
    """tp 2: the Megatron rules; tp 7: nothing divides, all replicated."""
    from triad_tpu.parallel.tp import tp_param_specs as jax_specs
    from triad_tpu_torch.parallel.tp import tp_param_specs, tp_state_shardings

    want = jax_specs_by_name(jax_specs(_jax_params(), tp))
    specs = tp_param_specs(_port_model(), tp)
    assert tp_state_shardings(specs) == {"params": specs, "grads": specs, "moments": specs}
    got = port_specs_in_flax_layout(specs)
    assert sorted(got) == sorted(want)
    assert got == want
    sharded = [n for n, s in got.items() if s]
    if tp == 7:
        assert not sharded
    else:
        assert got["audio_backbone.layers.0.attention.q_proj.weight"] == (None, "model")
        assert got["audio_backbone.layers.0.attention.out_proj.weight"] == ("model",)
        assert got["text_backbone.word_embeddings"] == ("model",)
        assert got["visual_backbone.blocks.0.attn.qkv.weight"] == ()
        assert len(sharded) >= 40


def test_head_split_raises(monkeypatch):
    """hidden 32 divides by 8, 4 heads do not: not ported, never replicated
    in silence."""
    from triad_tpu_torch.parallel.tp import make_dp_tp_mesh, shard_model, tp_param_specs

    fake_world(monkeypatch, 8)
    model = _port_model()
    with pytest.raises(NotImplementedError, match="GSPMD"):
        shard_model(model, make_dp_tp_mesh(8, 8), tp_param_specs(model, 8))


def test_zero1_tp_moment_specs_match_jax(monkeypatch):
    """dp 4 x tp 2: each moment keeps its parameter's Megatron spec and
    shards its largest free dim over 'data' (JAX's extend_with_data)."""
    from jax.tree_util import DictKey, GetAttrKey, SequenceKey

    import triad_tpu.train as JT
    from triad_tpu.parallel.tp import make_dp_tp_mesh as jax_mesh
    from triad_tpu.parallel.tp import tp_param_specs as jax_specs
    from triad_tpu.parallel.zero import zero1_state_shardings as jax_zero1
    from triad_tpu_torch.parallel.tp import make_dp_tp_mesh, tp_param_specs
    from triad_tpu_torch.parallel.zero import zero1_moment_specs

    params = _jax_params()
    partition = JT.ParamPartition(params)
    bank = JT.OptimizerBank(_optim(2), partition, total_updates=100)
    state = JT.init_train_state(params, bank, jax.random.key(1))
    sh = jax_zero1(state, jax_mesh(8, 2), "data", param_specs=jax_specs(params, 2),
                   partition=partition)
    names = list(jax_specs_by_name(jax.tree.map(lambda _: P(), params)))
    flat_names = dict(zip(range(len(partition.paths)), names))
    want = {}
    for path, s in jax.tree_util.tree_flatten_with_path(sh.opt)[0]:
        group = field = None
        for k in path:
            if isinstance(k, DictKey) and k.key in partition.group_indices:
                group = k.key
            elif isinstance(k, GetAttrKey) and k.name in ("mu", "nu"):
                field = k.name
            elif field is not None and isinstance(k, SequenceKey):
                want[(field, flat_names[partition.group_indices[group][k.idx]])] = _strip(s.spec)
                break
    assert len(want) > 100

    fake_world(monkeypatch, 8)
    model = _port_model()
    got = zero1_moment_specs(model, make_dp_tp_mesh(8, 2), "data", tp_param_specs(model, 2))
    got = port_specs_in_flax_layout(got)
    both = 0
    for (field, name), spec in want.items():
        assert got[name] == spec, (field, name, got[name], spec)
        both += {"data", "model"} <= set(spec)
    assert both > 10
    assert got["audio_backbone.layers.0.attention.q_proj.weight"] == ("data", "model")


@pytest.mark.parametrize("kind", ["dp_tp", "multislice_tp"])
def test_mesh_coordinates_match_jax(monkeypatch, kind):
    """Rank r sits where device r sits in JAX's device grid."""
    from triad_tpu.parallel.tp import make_dp_tp_mesh as jax_dp_tp
    from triad_tpu.parallel.tp import make_multislice_tp_mesh as jax_slices
    from triad_tpu_torch.parallel.tp import make_dp_tp_mesh, make_multislice_tp_mesh

    jmesh = jax_dp_tp(8, 2) if kind == "dp_tp" else jax_slices(2, 2, 2)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    first = min(d.id for d in jax.devices())
    for r in range(8):
        fake_world(monkeypatch, 8, r)
        mesh = make_dp_tp_mesh(8, 2) if kind == "dp_tp" else make_multislice_tp_mesh(2, 2, 2)
        assert mesh.axis_names == tuple(jmesh.axis_names)
        where = tuple(int(i) for i in np.argwhere(ids == first + r)[0])
        assert tuple(mesh.coords[a] for a in mesh.axis_names) == where, r


# ---------------------------------------------------------------------------
# (b) steps against JAX, (c) live dropout against one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", TP_LAYOUTS)
def test_tp_step_loss_matches_jax(layout_worlds, layout):
    held_loss_to_jax(layout_worlds, "exact", layout)


@pytest.mark.parametrize("layout", TP_LAYOUTS)
def test_tp_step_params_match_jax(layout_worlds, layout):
    held_params_to_jax(layout_worlds, "exact", layout)


@pytest.mark.parametrize("layout", TP_LAYOUTS)
def test_tp_live_dropout_step_matches_one_process(layout_worlds, layout):
    held_to_one_process(layout_worlds, layout)


def test_tp_storage(layout_worlds):
    """Each rank holds its Megatron slices (less than one process's
    parameters); ZeRO-1 x TP divides the moments by the data size too."""
    got = layout_worlds["got"]
    params_1, moments_1 = layout_worlds["one_process_bytes"]
    tp = list(got["exact/dp2tp2/param_bytes"])
    assert len(tp) == 4 and max(tp) < 0.8 * params_1
    plain = list(got["exact/dp2tp2/moment_bytes"])
    zero1 = list(got["exact/dp2tp2_zero1/moment_bytes"])
    assert max(plain) < 0.8 * moments_1 and max(zero1) < 0.6 * max(plain)


def test_chunked_frontend_ran(layout_worlds):
    """Every layout's step, and the one-process step, ran HuBERT's chunked
    frontend: BLOCKS pass-B blocks a micro step, each again in the
    backward's recompute."""
    got = layout_worlds["got"]
    runs = {k: v for k, v in got.items() if k.endswith("/metric/frontend_blocks")}
    assert len(runs) >= 2 * len(LAYOUTS)
    for key, n in runs.items():
        steps = 2 if key.startswith("accum2/") else 1
        assert float(n) == 2 * BLOCKS * steps, key
    assert layout_worlds["refs"]["live"][0]["frontend_blocks"] == 2 * BLOCKS


def test_bf16_column_row_pair(layout_worlds):
    """A bf16 column-parallel Dense, GELU, a row-parallel Dense at tp 2
    (the row partials and the column input's gradient summed in fp32 and
    rounded once) lie as close to the fp32 result as the one-process bf16
    layers do, and within one bf16 rounding of them."""
    got = layout_worlds["got"]
    y1, dx1, y32, dx32 = layout_worlds["refs"]["bf16_pair"]
    y2, dx2 = got["bf16_pair/y"], got["bf16_pair/dx"]
    for tp, one, exact in ((y2, y1, y32), (dx2, dx1, dx32)):
        scale = np.abs(exact).max()
        assert np.abs(tp - exact).max() <= 1.25 * np.abs(one - exact).max() + 1e-3 * scale
        assert np.abs(tp - one).max() <= 2 ** -7 * scale
