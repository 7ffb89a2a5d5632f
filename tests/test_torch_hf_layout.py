"""The files triad_tpu_torch/tools/hf_layout.py writes are the published
layouts: each HF snapshot loads in ``transformers.AutoModel.
from_pretrained(local_files_only=True)`` as the named class with no
missing or mismatched key and no unexpected one but a task file's heads
(which its task class takes, with no key left over), and holds the
writer's tensors exactly; on every file (snapshots, torch.hub ``.pth`` in its three
wrappings, a reference ``.pt``) the JAX importers and the port's give
equal trees, leaf for leaf. Also: the config defaults the port assumes
for a field a config.json leaves out are ``transformers``'."""

import dataclasses

import pytest
import torch

from tests.test_hf_import import _small_cfg
from tests.test_torch_hf_import import assert_trees_equal, port_cfg
from triad_tpu.models import hf_import as jax_hf
from triad_tpu.models import reference_import as jax_ref
from triad_tpu_torch.models import hf_import, reference_import
from triad_tpu_torch.tools import hf_layout

CLASSES = {"hubert": "HubertModel", "distilbert": "DistilBertModel",
           "dinov2_with_registers": "Dinov2WithRegistersModel"}
LOADERS = {"hubert": "load_hubert_snapshot", "distilbert": "load_distilbert_snapshot",
           "dinov2_with_registers": "load_dinov2_snapshot"}


def _sub(cfg, model_type):
    return {"hubert": cfg.hubert, "distilbert": cfg.text,
            "dinov2_with_registers": cfg.vit}[model_type]


def test_defaults_are_transformers():
    import transformers

    from triad_tpu_torch.models.weights import HF_DEFAULTS

    for model_type, fields in HF_DEFAULTS.items():
        hf = transformers.AutoConfig.for_model(model_type)
        for name, value in fields.items():
            got = getattr(hf, name)
            assert (list(got) if isinstance(got, (list, tuple)) else got) == value, name


CASES = [
    ("hubert", "safetensors", False, False, torch.float32),
    ("hubert", "sharded", False, True, torch.float32),
    ("hubert", "bin", True, False, torch.float32),
    ("hubert", "safetensors", True, True, torch.bfloat16),
    ("distilbert", "safetensors", False, False, torch.float32),
    ("distilbert", "bin", True, False, torch.float32),
    ("distilbert", "sharded", False, False, torch.float16),
    ("dinov2_with_registers", "safetensors", False, False, torch.float32),
    ("dinov2_with_registers", "bin", True, False, torch.float32),
]


@pytest.mark.parametrize("model_type,fmt,task,legacy,dtype", CASES, ids=[
    f"{m}-{f}{'-task' if t else ''}{'-weight_g_v' if lg else ''}-{str(d)[6:]}"
    for m, f, t, lg, d in CASES])
def test_snapshot_loads_in_transformers(tmp_path, model_type, fmt, task, legacy, dtype):
    from transformers import AutoModel

    jcfg = _small_cfg()
    cfg = port_cfg(jcfg)
    d = str(tmp_path / "snap")
    hf_layout.write_snapshot(d, model_type, _sub(cfg, model_type), seed=4, fmt=fmt, task=task,
                             legacy_weight_norm=legacy, dtype=dtype)
    hf, info = AutoModel.from_pretrained(d, local_files_only=True, output_loading_info=True)
    assert type(hf).__name__ == CLASSES[model_type]
    heads = set()
    if task:  # the task class takes every key; AutoModel leaves exactly the heads
        import transformers

        name, _, head_shapes = hf_layout.TASK_MODELS[model_type]
        model, task_info = getattr(transformers, name).from_pretrained(
            d, local_files_only=True, output_loading_info=True)
        assert not task_info["missing_keys"] and not task_info["unexpected_keys"], task_info
        heads = set(head_shapes(_sub(cfg, model_type)))
    assert not info["missing_keys"] and set(info["unexpected_keys"]) == heads, info
    assert not info["mismatched_keys"], info
    want = {k: v.to(dtype).float()
            for k, v in hf_layout.backbone_state(model_type, _sub(cfg, model_type), 4).items()}
    got = hf.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    loader = LOADERS[model_type]
    assert_trees_equal(getattr(hf_import, loader)(d, cfg), getattr(jax_hf, loader)(d, jcfg))


@pytest.mark.parametrize("wrap", [None, "model", "teacher"])
def test_hub_dinov2_file(tmp_path, wrap):
    """The hub file of a seed: the JAX and port importers agree, and it
    holds the weights of the HF snapshot of the same seed."""
    jcfg = _small_cfg()
    cfg = port_cfg(jcfg)
    path = str(tmp_path / "dinov2_vitb14_reg4_pretrain.pth")
    hf_layout.write_hub_dinov2(path, cfg.vit, seed=6, wrap=wrap)
    got = hf_import.load_dinov2_snapshot(path, cfg)
    assert_trees_equal(got, jax_hf.load_dinov2_snapshot(path, jcfg))
    hf_layout.write_snapshot(str(tmp_path / "snap"), "dinov2_with_registers", cfg.vit, seed=6)
    assert_trees_equal(got, hf_import.load_dinov2_snapshot(str(tmp_path / "snap"), cfg))


def test_reference_checkpoint_file(tmp_path):
    jcfg = dataclasses.replace(_small_cfg(), embedding_dim=24)
    cfg = port_cfg(jcfg)
    path = str(tmp_path / "checkpoint_epoch3_step1200.pt")
    hf_layout.write_reference_checkpoint(path, cfg, seed=8)
    got = reference_import.load_reference_checkpoint(path, cfg)
    assert got["visual_backbone"]["block_0"]["attn"]["qkv"]["lora_b"].any()
    assert_trees_equal(got, jax_ref.load_reference_checkpoint(path, jcfg))
