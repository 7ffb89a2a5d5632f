"""The port's reference-checkpoint import
(triad_tpu_torch/models/reference_import.py) against the JAX package's,
on tests/test_reference_import.py's synthetic reference state (HF HuBERT
+ HF DistilBERT + a peft-wrapped hub-layout DINOv2 with LoRA factors
+ projections + temperature, behind ``_orig_mod.``): the trees equal
leaf for leaf, from the state dict and from a saved ``.pt``; the port's
TriadModel on them matches the JAX forward (fp32 on both sides; rtol
1e-4, atol 1e-5 of the outputs); a missing tensor raises, naming it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_multimodal import small_model_config
from tests.test_reference_import import reference_checkpoint  # noqa: F401
from tests.test_torch_hf_import import assert_trees_equal, port_cfg
from triad_tpu.models import reference_import as jax_ref
from triad_tpu_torch.models import reference_import


def _cfg():
    cfg = small_model_config()
    return dataclasses.replace(
        cfg,
        hubert=dataclasses.replace(
            cfg.hubert, conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2)
        ),
        text=dataclasses.replace(cfg.text, vocab_size=100),
    )


def test_state_dict_tree_equals_jax(reference_checkpoint):  # noqa: F811
    state, _ = reference_checkpoint
    got = reference_import.port_reference_state_dict(state, port_cfg(_cfg()))
    want = jax_ref.port_reference_state_dict(state, _cfg())
    assert "lora_a" in got["visual_backbone"]["block_1"]["attn"]["proj"]
    assert_trees_equal(got, want)
    assert float(got["temperature"]) == pytest.approx(1.7)


def test_saved_pt_behind_orig_mod(reference_checkpoint, tmp_path):  # noqa: F811
    """A reference ``checkpoint_epoch*_step*.pt``: the model state behind
    ``_orig_mod.`` under ``model_state_dict``, beside the trainer's other
    entries."""
    state, _ = reference_checkpoint
    assert all(k.startswith("_orig_mod.") for k in state)
    path = tmp_path / "checkpoint_epoch1_step40.pt"
    torch.save({"epoch": 1, "step": 40, "model_state_dict": state,
                "optimizer_state_dict": {"state": {}, "param_groups": []}}, path)
    assert_trees_equal(reference_import.load_reference_checkpoint(str(path), port_cfg(_cfg())),
                       jax_ref.load_reference_checkpoint(str(path), _cfg()))


def test_forward_matches_jax(reference_checkpoint):  # noqa: F811
    from triad_tpu.models import TriadModel as JaxTriad
    from triad_tpu_torch.models.convert import flax_to_torch
    from triad_tpu_torch.models.multimodal import TriadModel

    state, _ = reference_checkpoint
    cfg = port_cfg(_cfg())
    tree = reference_import.port_reference_state_dict(state, cfg)
    model = TriadModel(cfg)
    model.load_state_dict(flax_to_torch(tree, cfg))
    rng = np.random.default_rng(1)
    batch = (rng.normal(size=(2, 28, 28, 3)).astype(np.float32),
             rng.normal(size=(2, 1600)).astype(np.float32),
             rng.integers(1, 100, size=(2, 6)).astype(np.int32),
             np.ones((2, 6), np.float32))
    with torch.no_grad():
        got = model(*(torch.from_numpy(b) for b in batch))
    want = JaxTriad(_cfg()).apply(
        {"params": jax.tree.map(jnp.asarray, jax_ref.port_reference_state_dict(state, _cfg()))},
        *(jnp.asarray(b) for b in batch))
    for k in ("visual", "audio", "text"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_missing_tensor_raises(reference_checkpoint):  # noqa: F811
    state, _ = reference_checkpoint
    name = "_orig_mod.visual_embedder.model.base_model.model.blocks.1.ls2.gamma"
    broken = {k: v for k, v in state.items() if k != name}
    with pytest.raises(ValueError, match=r"blocks\.1\.ls2\.gamma"):
        reference_import.port_reference_state_dict(broken, port_cfg(_cfg()))
