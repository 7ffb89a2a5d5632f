"""The port's weight importers (triad_tpu_torch/models/hf_import.py and
weights.py) against the JAX package's on HF snapshots that
``transformers`` writes here: tests/test_hf_import.py's eight cases,
each leaf ``np.array_equal`` to the JAX tree (fresh LoRA factors
included), then both weight-norm namings, a bf16 file, prefixed keys with
head keys, the port's safetensors reader against ``safetensors``, the
missing-key raise, and the port's HuBERT from a snapshot against the HF
forward at the JAX test's rtol 1e-3 / atol 5e-5 (fp32 on both sides)."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tests.test_hf_import import _hub_pth_state, _small_cfg, hf_models  # noqa: F401
from triad_tpu.models import hf_import as jax_hf
from triad_tpu_torch.config import ModelConfig
from triad_tpu_torch.models import hf_import


def port_cfg(jax_cfg) -> ModelConfig:
    """The port's ModelConfig of a JAX one (field-equal copies)."""
    from triad_tpu_torch.config import Config

    return Config.from_dict({"model": dataclasses.asdict(jax_cfg)}).model


def assert_trees_equal(got, want):
    """Same paths, every leaf bit-equal (np.array_equal, dtype fp32)."""
    g = {"/".join(map(str, p)): np.asarray(x)
         for p, x in jax.tree_util.tree_leaves_with_path(got)}
    w = {"/".join(map(str, p)): np.asarray(x)
         for p, x in jax.tree_util.tree_leaves_with_path(want)}
    assert g.keys() == w.keys(), (sorted(g.keys() ^ w.keys()))[:5]
    for k, v in w.items():
        assert g[k].dtype == np.float32, k
        assert g[k].shape == v.shape and np.array_equal(g[k], v), k


def _both(loader, path, cfg):
    return (getattr(hf_import, loader)(str(path), port_cfg(cfg)),
            getattr(jax_hf, loader)(str(path), cfg))


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
def test_hubert_snapshot_roundtrip(hf_models, tmp_path, safe):
    hub, _, _ = hf_models
    hub.save_pretrained(tmp_path / "h", safe_serialization=safe)
    assert_trees_equal(*_both("load_hubert_snapshot", tmp_path / "h", _small_cfg()))


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
def test_distilbert_snapshot_roundtrip(hf_models, tmp_path, safe):
    _, db, _ = hf_models
    db.save_pretrained(tmp_path / "t", safe_serialization=safe)
    assert_trees_equal(*_both("load_distilbert_snapshot", tmp_path / "t", _small_cfg()))


def test_sharded_safetensors_snapshot(hf_models, tmp_path):
    _, db, _ = hf_models
    d = tmp_path / "distilbert_sharded"
    db.save_pretrained(d, safe_serialization=True, max_shard_size="50KB")
    assert os.path.exists(d / "model.safetensors.index.json")
    assert_trees_equal(*_both("load_distilbert_snapshot", d, _small_cfg()))


def test_dinov2_hf_snapshot(hf_models, tmp_path):
    _, _, vit = hf_models
    vit.save_pretrained(tmp_path / "v", safe_serialization=True)
    got, want = _both("load_dinov2_snapshot", tmp_path / "v", _small_cfg())
    assert "lora_a" in got["block_0"]["attn"]["qkv"]
    assert_trees_equal(got, want)


@pytest.mark.parametrize(
    "wrap", [None, "model", "teacher+backbone"],
    ids=["plain", "model-wrapped", "teacher-backbone"],
)
def test_dinov2_hub_pth(hf_models, tmp_path, wrap):
    _, _, vit = hf_models
    state = _hub_pth_state(vit)
    if wrap == "model":
        state = {"model": state}
    elif wrap == "teacher+backbone":
        state = {"teacher": {f"backbone.{k}": v for k, v in state.items()}}
    path = tmp_path / "dinov2_vitb14_reg_pretrain.pth"
    torch.save(state, path)
    assert_trees_equal(*_both("load_dinov2_snapshot", path, _small_cfg()))


def test_init_params_from_pretrained_full_tree(hf_models, tmp_path):
    """One call builds the full state_dict: the three backbones equal
    the JAX importers' trees, the rest is the seeded fresh init, and the
    model runs."""
    from triad_tpu_torch.models.convert import init_triad_model, tree_to_state
    from triad_tpu_torch.models.multimodal import TriadModel

    hub, db, vit = hf_models
    hub.save_pretrained(tmp_path / "h", safe_serialization=True)
    db.save_pretrained(tmp_path / "t", safe_serialization=True)
    torch.save(_hub_pth_state(vit), tmp_path / "v.pth")
    jcfg, cfg = _small_cfg(), port_cfg(_small_cfg())
    state = hf_import.init_params_from_pretrained(
        cfg, torch.Generator().manual_seed(3), hubert_path=str(tmp_path / "h"),
        text_path=str(tmp_path / "t"), vit_path=str(tmp_path / "v.pth"))
    want = tree_to_state({
        "audio_backbone": jax_hf.load_hubert_snapshot(str(tmp_path / "h"), jcfg),
        "text_backbone": jax_hf.load_distilbert_snapshot(str(tmp_path / "t"), jcfg),
        "visual_backbone": jax_hf.load_dinov2_snapshot(str(tmp_path / "v.pth"), jcfg),
    })
    fresh = init_triad_model(cfg, torch.Generator().manual_seed(3)).state_dict()
    assert state.keys() == fresh.keys()
    for k, v in state.items():
        assert torch.equal(v, want.get(k, fresh[k])), k
    model = TriadModel(cfg)
    model.load_state_dict(state)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        out = model(torch.from_numpy(rng.normal(size=(1, 28, 28, 3)).astype(np.float32)),
                    torch.from_numpy(rng.normal(size=(1, 1600)).astype(np.float32)),
                    torch.from_numpy(rng.integers(1, 100, size=(1, 6))),
                    torch.ones(1, 6))
    for k, v in out.items():
        assert torch.isfinite(v).all(), k


def _hubert_from_tree(cfg, params):
    from triad_tpu_torch.models.convert import tree_to_state
    from triad_tpu_torch.models.hubert import HubertModel

    model = HubertModel(cfg.hubert).eval()
    model.load_state_dict(tree_to_state(params))
    return model


def test_forward_parity_through_snapshot(hf_models, tmp_path):
    """The port's HuBERT loaded from the snapshot reproduces the HF torch
    forward (rtol 1e-3, atol 5e-5, as the JAX test)."""
    hub, _, _ = hf_models
    hub.save_pretrained(tmp_path / "h", safe_serialization=True)
    cfg = port_cfg(_small_cfg())
    model = _hubert_from_tree(cfg, hf_import.load_hubert_snapshot(str(tmp_path / "h"), cfg))
    audio = np.random.default_rng(2).normal(size=(2, 1600)).astype(np.float32)
    with torch.no_grad():
        ref = hub(torch.from_numpy(audio)).last_hidden_state.numpy()
        ours = model(torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=5e-5)


def test_mismatch_raises(hf_models, tmp_path):
    hub, db, _ = hf_models
    db.save_pretrained(tmp_path / "t", safe_serialization=True)
    cfg = port_cfg(_small_cfg())
    wrong = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_layers=3))
    with pytest.raises(ValueError, match="mismatch"):
        hf_import.load_distilbert_snapshot(str(tmp_path / "t"), wrong)
    hub.save_pretrained(tmp_path / "h", safe_serialization=True)
    with pytest.raises(ValueError, match="expected DistilBertModel"):
        hf_import.load_distilbert_snapshot(str(tmp_path / "h"), cfg)


def _rewrite_safetensors(d, edit):
    from safetensors.torch import load_file, save_file

    f = os.path.join(d, "model.safetensors")
    state = edit(load_file(f))
    save_file({k: v.contiguous() for k, v in state.items()}, f, metadata={"format": "pt"})


@pytest.mark.parametrize("naming", ["parametrizations", "weight_g_v"])
def test_weight_norm_namings(hf_models, tmp_path, naming):
    """The positional conv's factors under either name: the port's tree
    equals the JAX one (HF renames the legacy names on load)."""
    hub, _, _ = hf_models
    d = tmp_path / "h"
    hub.save_pretrained(d, safe_serialization=True)
    if naming == "weight_g_v":
        def legacy(state):
            p = "encoder.pos_conv_embed.conv."
            state[p + "weight_g"] = state.pop(p + "parametrizations.weight.original0")
            state[p + "weight_v"] = state.pop(p + "parametrizations.weight.original1")
            return state
        _rewrite_safetensors(d, legacy)
    got, want = _both("load_hubert_snapshot", d, _small_cfg())
    assert_trees_equal(got, want)
    np.testing.assert_array_equal(
        got["pos_conv_embed"]["conv"]["kernel"],
        hub.encoder.pos_conv_embed.conv.weight.detach().numpy().transpose(2, 1, 0))


@pytest.mark.parametrize("backbone", ["hubert", "distilbert"])
def test_bf16_safetensors(hf_models, tmp_path, backbone):
    """A bf16 file is upcast to fp32, as from_pretrained into an fp32
    model: equal to the JAX tree (the pos conv's norm taken after)."""
    import copy

    hub, db, _ = hf_models
    model = copy.deepcopy(hub if backbone == "hubert" else db).to(torch.bfloat16)
    model.save_pretrained(tmp_path / "b", safe_serialization=True)
    loader = "load_hubert_snapshot" if backbone == "hubert" else "load_distilbert_snapshot"
    assert_trees_equal(*_both(loader, tmp_path / "b", _small_cfg()))


@pytest.mark.parametrize("task", ["DistilBertForMaskedLM", "HubertForCTC"])
def test_prefixed_keys_and_head_keys(hf_models, tmp_path, task):
    """A task model's snapshot (``distilbert.`` / ``hubert.`` prefixes,
    vocab_* / lm_head keys): AutoModel strips the prefix and drops the
    heads; so does the port."""
    import copy

    import transformers

    hub, db, _ = hf_models
    base = db if task.startswith("Distil") else hub
    cfg = copy.deepcopy(base.config)
    if task == "HubertForCTC":
        cfg.vocab_size = 12
    model = getattr(transformers, task)(cfg).eval()
    getattr(model, model.base_model_prefix).load_state_dict(base.state_dict())
    model.save_pretrained(tmp_path / "m", safe_serialization=True)
    from safetensors.torch import load_file

    keys = load_file(str(tmp_path / "m" / "model.safetensors")).keys()
    assert any(k.startswith(model.base_model_prefix + ".") for k in keys)
    assert any(not k.startswith(model.base_model_prefix + ".") for k in keys)
    loader = "load_distilbert_snapshot" if task.startswith("Distil") else "load_hubert_snapshot"
    assert_trees_equal(*_both(loader, tmp_path / "m", _small_cfg()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64],
                         ids=["F32", "F16", "BF16", "I64"])
def test_safetensors_reader(tmp_path, dtype):
    """read_safetensors against safetensors.torch.load_file: the same
    names, shapes and values (floats as fp32), empty and scalar tensors
    included, the __metadata__ entry skipped."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    state = {"a": torch.randn(3, 5, generator=g), "b.c": torch.randn(7, generator=g) * 100,
             "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4)}
    state = {k: (v.round() if dtype == torch.int64 else v).to(dtype) for k, v in state.items()}
    f = tmp_path / "x.safetensors"
    save_file(state, str(f), metadata={"format": "pt"})
    got, want = hf_import.read_safetensors(str(f)), load_file(str(f))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == (torch.int64 if dtype == torch.int64 else torch.float32), k
        assert got[k].shape == v.shape and torch.equal(got[k], v.to(got[k].dtype)), k


def test_missing_key_raises(hf_models, tmp_path):
    """A tensor the architecture needs that the snapshot lacks raises,
    naming it (HF would draw it at random)."""
    _, db, _ = hf_models
    d = tmp_path / "t"
    db.save_pretrained(d, safe_serialization=True)
    name = "transformer.layer.1.ffn.lin2.weight"
    _rewrite_safetensors(d, lambda s: {k: v for k, v in s.items() if k != name})
    with pytest.raises(ValueError, match=name.replace(".", r"\.")):
        hf_import.load_distilbert_snapshot(str(d), port_cfg(_small_cfg()))
