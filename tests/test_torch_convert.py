"""The port's parameter bridge (models/convert.py), its JAX-free imports,
and its refusals: impl values the port does not have raise, and a CUDA
request on a machine without the card fails instead of running the
plain versions."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_multimodal import small_model_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_params():
    from triad_tpu.models import init_triad_model

    cfg = small_model_config()
    return cfg, init_triad_model(cfg, jax.random.key(0))


class TestConvert:
    def test_flax_torch_flax_round_trip_is_exact(self, jax_params):
        from triad_tpu_torch.models.convert import flax_to_torch, torch_to_flax

        cfg, params = jax_params
        back = _flat(torch_to_flax(flax_to_torch(params, cfg)))
        want = _flat(params)
        assert sorted(back) == sorted(want)
        for k in want:
            assert back[k].shape == want[k].shape, k
            np.testing.assert_array_equal(back[k], want[k], err_msg=str(k))

    def test_torch_init_matches_jax_tree_and_round_trips(self, jax_params):
        """The torch-native init yields the JAX tree (paths and shapes),
        and torch -> flax -> torch is exact."""
        from triad_tpu_torch.models.convert import (
            flax_to_torch,
            init_triad_model,
            torch_to_flax,
        )

        cfg, params = jax_params
        model = init_triad_model(cfg, torch.Generator().manual_seed(3))
        tree = torch_to_flax(model.state_dict())
        got = {k: v.shape for k, v in _flat(tree).items()}
        assert got == {k: v.shape for k, v in _flat(params).items()}
        sd = flax_to_torch(tree, cfg)
        for k, v in model.state_dict().items():
            torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
        assert float(model.temperature.detach()) == pytest.approx(cfg.temperature_init)

    def test_layouts(self, jax_params):
        """Dense (in, out) -> (out, in); conv (k, in/g, out) -> (out, in/g,
        k); HWIO -> OIHW; LoRA factors transposed to peft shapes."""
        from triad_tpu_torch.models.convert import flax_to_torch

        cfg, params = jax_params
        sd = flax_to_torch(params, cfg)
        vb = params["visual_backbone"]
        q = vb["block_0"]["attn"]["qkv"]
        np.testing.assert_array_equal(sd["visual_backbone.blocks.0.attn.qkv.weight"].numpy(),
                                      np.asarray(q["kernel"]).T)
        np.testing.assert_array_equal(sd["visual_backbone.blocks.0.attn.qkv.lora_a"].numpy(),
                                      np.asarray(q["lora_a"]).T)
        pe = np.asarray(vb["patch_embed"]["kernel"])
        np.testing.assert_array_equal(sd["visual_backbone.patch_embed.weight"].numpy(),
                                      pe.transpose(3, 2, 0, 1))
        pc = np.asarray(params["audio_backbone"]["pos_conv_embed"]["conv"]["kernel"])
        np.testing.assert_array_equal(
            sd["audio_backbone.pos_conv_embed.conv.weight"].numpy(), pc.transpose(2, 1, 0))
        c1 = np.asarray(params["audio_backbone"]["feature_extractor"]["conv_1"]["kernel"])
        np.testing.assert_array_equal(
            sd["audio_backbone.feature_extractor.convs.1.weight"].numpy(), c1.transpose(2, 1, 0))


def test_package_imports_without_jax():
    """triad_tpu_torch and its serving stack import with jax and flax
    blocked (the machine with the card has neither)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'orbax'):\n"
        "    sys.modules[m] = None\n"
        "import triad_tpu_torch, triad_tpu_torch.kernels\n"
        "import triad_tpu_torch.serve.server, triad_tpu_torch.serve.model\n"
        "import triad_tpu_torch.cli.serve, triad_tpu_torch.models.convert\n"
        "import triad_tpu_torch.ops.frontend, triad_tpu_torch.ops.similarity\n"
        "bad = [m for m, v in sys.modules.items()\n"
        "       if v is not None and m.split('.')[0] in ('jax', 'flax', 'jaxlib')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


_PORTED_TRAINING_IMPLS = {
    ("hubert", "attention_impl", "fused_packed"),
    ("hubert", "posconv_impl", "pallas"),
    ("hubert", "ln_impl", "fused"),
}


def _check_runs_in_training(field, value):
    """A HuBERT of 2 heads of 64 (the packed kernel's head width) with the
    option set trains on the CPU through the kernel's plain twin: finite
    features, and a gradient reaches the parameters the option touches."""
    from triad_tpu_torch.config import ModelConfig
    from triad_tpu_torch.models.convert import init_triad_model
    from triad_tpu_torch.ops.dropout import HostSeeds

    port_cfg = ModelConfig(**{k: v for k, v in dataclasses.asdict(small_model_config()).items()
                              if k not in ("vit", "hubert", "text")})
    hub = dataclasses.replace(port_cfg.hubert, hidden_size=128, num_heads=2,
                              intermediate_size=64, conv_dim=(16, 16), conv_kernel=(10, 3),
                              conv_stride=(5, 2), num_conv_pos_embeddings=16,
                              num_conv_pos_embedding_groups=4, layerdrop=0.0,
                              **{field: value})
    model = init_triad_model(dataclasses.replace(port_cfg, hubert=hub),
                             torch.Generator().manual_seed(0))
    audio = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 400)).astype(np.float32))
    feats = model.encode_audio(audio, True, torch.Generator().manual_seed(1), HostSeeds(1, 0))
    assert bool(torch.isfinite(feats).all())
    feats.square().sum().backward()
    touched = {"attention_impl": "attention.q_proj.weight", "posconv_impl": "pos_conv_embed.conv",
               "ln_impl": "final_layer_norm.weight"}[field]
    grads = [p.grad for n, p in model.audio_backbone.named_parameters() if touched in n]
    assert grads and all(g is not None and bool(g.abs().sum() > 0) for g in grads)


class TestRefusals:
    def test_cli_without_cuda_refuses(self, monkeypatch):
        from triad_tpu_torch.cli import serve

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit, match="no CUDA device"):
            serve.main(["--random-init"])

    def test_kernel_wrappers_do_not_run_plain_off_cpu(self):
        """A tensor that is not on the CPU goes to the kernel or raises;
        here it raises (meta tensors stand in for a device)."""
        from triad_tpu_torch.ops import attention, frontend, mlp

        m = lambda *s: torch.empty(*s, device="meta", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA"):
            attention.attention_eval(m(1, 8, 64), m(1, 8, 64), m(1, 8, 64))
        with pytest.raises(ValueError, match="CUDA"):
            attention.attention_eval_merged(m(1, 8, 192))
        with pytest.raises(ValueError, match="CUDA"):
            mlp.fused_mlp(m(1, 8, 64), m(128, 64), m(128), m(64, 128), m(64))
        with pytest.raises(ValueError, match="CUDA"):
            frontend.conv_s2_gelu(m(1, 9, 512), m(512, 512, 3))
        from triad_tpu_torch.ops import layernorm, posconv

        with pytest.raises(ValueError, match="CUDA"):
            layernorm.dropout_add_ln(m(1, 8, 768), m(1, 8, 768), m(768), m(768), 1e-5)
        with pytest.raises(ValueError, match="CUDA"):
            posconv.pos_conv(m(1, 8, 768), m(768, 48, 128), None, 16)
        with pytest.raises(ValueError, match="CUDA"):
            posconv.pos_conv_dw(m(1, 8, 768), m(1, 8, 768), 16, 128)

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        from triad_tpu_torch import kernels

        monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc"):
            kernels._nvcc()

    @pytest.mark.parametrize("section,field,value", [
        ("vit", "attention_impl", "fused"),
        ("vit", "attention_impl", "fused_packed_merged"),
        ("vit", "attention_impl", "packed_merged_pair"),
        ("hubert", "attention_impl", "fused"),
        ("hubert", "attention_impl", "fused_packed"),
        ("hubert", "attention_impl", "packed_pair"),
        ("hubert", "frontend_impl", "pallas"),
        ("hubert", "frontend_impl", "conv_act"),
        ("hubert", "frontend_impl", "phase"),
        ("hubert", "frontend_impl", "matmul"),
        ("hubert", "posconv_impl", "pallas"),
        ("hubert", "ln_impl", "fused"),
    ])
    def test_unported_impls_raise(self, section, field, value):
        """Unported impl values raise; the three HuBERT training options
        that this port now has (fused_packed attention, the posconv and
        fused LayerNorm kernels) run in training mode instead."""
        from triad_tpu_torch.models.multimodal import TriadModel

        cfg = small_model_config()
        if (section, field, value) in _PORTED_TRAINING_IMPLS:
            _check_runs_in_training(field, value)
            return
        sub = dataclasses.replace(getattr(cfg, section), **{field: value})
        # The model builds and HuBERT raises when it runs, or the model
        # does not build.
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            model = TriadModel(dataclasses.replace(cfg, **{section: sub}), device="meta")
            model.encode_audio(torch.zeros(1, 400, device="meta"))

    def test_flash_attention_raises(self):
        from triad_tpu_torch.models.layers import dot_product_attention

        q = torch.zeros(1, 4, 2, 64)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            dot_product_attention(q, q, q, None, torch.float32, impl="flash")

    @pytest.mark.parametrize("impl", ["flash", "packed", "packed_pair", "fused_packed"])
    def test_attention_dropout_needs_xla(self, impl):
        """Live attention dropout runs on "xla" only; any other impl raises
        rather than falling back to the plain attention."""
        from triad_tpu_torch.models.layers import dot_product_attention

        q = torch.zeros(1, 4, 2, 64)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            dot_product_attention(q, q, q, None, torch.float32, impl=impl,
                                  probs_dropout=lambda p: p)

    def test_ignored_tpu_knobs_are_config_fields(self):
        from triad_tpu.core.config import HubertConfig, ViTConfig
        from triad_tpu_torch.models import IGNORED_TPU_KNOBS

        fields = {f.name for c in (ViTConfig, HubertConfig) for f in dataclasses.fields(c)}
        assert set(IGNORED_TPU_KNOBS) <= fields
