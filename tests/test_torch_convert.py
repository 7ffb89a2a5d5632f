"""The port's parameter bridge (models/convert.py), its JAX-free imports,
and its refusals: impl values the port does not have raise, and a CUDA
request on a machine without the card fails instead of running the
plain versions."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
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

    def test_pallas_frontend_tree_converts(self):
        """A Flax tree of a JAX model on frontend_impl="pallas" (its conv_<i>
        after conv_0 are bias-free _ConvParams kernels (k, C, Cout)) converts,
        round-trips exactly and computes the same audio features."""
        from jax.experimental.pallas import tpu as pltpu

        from triad_tpu.models import TriadModel as JaxTriad
        from triad_tpu.models import init_triad_model
        from triad_tpu_torch.models.convert import flax_to_torch, torch_to_flax
        from triad_tpu_torch.models.multimodal import TriadModel

        cfg = small_model_config()
        cfg = dataclasses.replace(cfg, hubert=dataclasses.replace(cfg.hubert,
                                                                  frontend_impl="pallas"))
        with pltpu.force_tpu_interpret_mode():  # the init traces the kernel
            shapes = jax.eval_shape(lambda key: init_triad_model(cfg, key), jax.random.key(1))
        rng = np.random.default_rng(1)
        params = jax.tree.map(
            lambda s: (rng.normal(size=s.shape) * 0.2).astype(np.float32), shapes)
        fe = params["audio_backbone"]["feature_extractor"]
        assert sorted(fe["conv_1"]) == ["kernel"]
        sd = flax_to_torch(params, cfg)
        back = _flat(torch_to_flax(sd))
        for k, v in _flat(params).items():
            np.testing.assert_array_equal(back[k], v, err_msg=str(k))
        model = TriadModel(cfg)
        model.load_state_dict(sd)
        audio = np.random.default_rng(2).normal(size=(2, 400)).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            ref = jax.jit(lambda p, a: JaxTriad(cfg).apply({"params": p}, a,
                                                           method=JaxTriad.encode_audio))(
                params, jnp.asarray(audio))
        with torch.inference_mode():
            got = model.encode_audio(torch.from_numpy(audio)).numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                                   atol=1e-4 * float(np.abs(np.asarray(ref)).max()))


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
    ("hubert", "attention_impl", "fused"),
    ("hubert", "attention_impl", "fused_packed"),
    ("hubert", "posconv_impl", "pallas"),
    ("hubert", "ln_impl", "fused"),
    ("vit", "attention_impl", "fused"),
    ("vit", "attention_impl", "fused_packed_merged"),
}


# Eval-only kernels (the head-pair eval attention, the fused frontend conv
# and the frontend activation) and the XLA frontends ("phase", "matmul"):
# they run at eval.
_PORTED_EVAL_IMPLS = {
    ("vit", "attention_impl", "packed_merged_pair"),
    ("hubert", "attention_impl", "packed_pair"),
    ("hubert", "frontend_impl", "pallas"),
    ("hubert", "frontend_impl", "conv_act"),
    ("hubert", "frontend_impl", "phase"),
    ("hubert", "frontend_impl", "matmul"),
}


def _check_runs_at_eval(section, field, value):
    """A ViT or HuBERT of 2 heads of 64 (the pair kernels' head width) with
    the option set runs at eval on the CPU through the kernel's plain twin:
    features of the expected shape, finite."""
    from triad_tpu_torch.config import ModelConfig
    from triad_tpu_torch.models.convert import init_triad_model

    port_cfg = ModelConfig(**{k: v for k, v in dataclasses.asdict(small_model_config()).items()
                              if k not in ("vit", "hubert", "text")})
    rng = np.random.default_rng(0)
    if section == "vit":
        vit = dataclasses.replace(port_cfg.vit, image_size=28, hidden_size=128, num_heads=2,
                                  num_layers=2, mlp_ratio=0.5, **{field: value})
        model = init_triad_model(dataclasses.replace(port_cfg, vit=vit),
                                 torch.Generator().manual_seed(0))
        images = torch.from_numpy(rng.normal(size=(2, 28, 28, 3)).astype(np.float32))
        with torch.inference_mode():
            feats = model.encode_visual(images)
        want = (2, vit.num_patches, port_cfg.embedding_dim)
    else:
        hub = dataclasses.replace(port_cfg.hubert, hidden_size=128, num_heads=2,
                                  intermediate_size=64, conv_dim=(32, 32), conv_kernel=(10, 3),
                                  conv_stride=(5, 2), num_conv_pos_embeddings=16,
                                  num_conv_pos_embedding_groups=4, **{field: value})
        model = init_triad_model(dataclasses.replace(port_cfg, hubert=hub),
                                 torch.Generator().manual_seed(0))
        audio = torch.from_numpy(rng.normal(size=(2, 400)).astype(np.float32))
        with torch.inference_mode():
            feats = model.encode_audio(audio)
        want = (2, hub.num_audio_tokens(400), port_cfg.embedding_dim)
    assert tuple(feats.shape) == want
    assert bool(torch.isfinite(feats).all())


def _check_runs_in_training(section, field, value):
    """A HuBERT or ViT of 2 heads of 64 (the training kernels' head width)
    with the option set trains on the CPU through the kernel's plain twin:
    finite features, and a gradient reaches the parameters the option
    touches."""
    from triad_tpu_torch.config import ModelConfig
    from triad_tpu_torch.models.convert import init_triad_model
    from triad_tpu_torch.ops.dropout import HostSeeds

    port_cfg = ModelConfig(**{k: v for k, v in dataclasses.asdict(small_model_config()).items()
                              if k not in ("vit", "hubert", "text")})
    rng = np.random.default_rng(0)
    if section == "vit":
        vit = dataclasses.replace(port_cfg.vit, image_size=28, hidden_size=128, num_heads=2,
                                  num_layers=2, mlp_ratio=0.5, **{field: value})
        model = init_triad_model(dataclasses.replace(port_cfg, vit=vit),
                                 torch.Generator().manual_seed(0))
        with torch.no_grad():  # lora_b starts at zero: give lora_a a gradient path
            for name, p in model.named_parameters():
                if name.endswith("lora_b"):
                    p.normal_(0.0, 0.05)
        images = torch.from_numpy(rng.normal(size=(2, 28, 28, 3)).astype(np.float32))
        feats = model.encode_visual(images, True, torch.Generator().manual_seed(1))
        backbone, touched = model.visual_backbone, "attn.qkv.lora_"
    else:
        hub = dataclasses.replace(port_cfg.hubert, hidden_size=128, num_heads=2,
                                  intermediate_size=64, conv_dim=(16, 16), conv_kernel=(10, 3),
                                  conv_stride=(5, 2), num_conv_pos_embeddings=16,
                                  num_conv_pos_embedding_groups=4, layerdrop=0.0,
                                  **{field: value})
        model = init_triad_model(dataclasses.replace(port_cfg, hubert=hub),
                                 torch.Generator().manual_seed(0))
        audio = torch.from_numpy(rng.normal(size=(2, 400)).astype(np.float32))
        feats = model.encode_audio(audio, True, torch.Generator().manual_seed(1),
                                   HostSeeds(1, 0))
        backbone = model.audio_backbone
        touched = {"attention_impl": "attention.q_proj.weight",
                   "posconv_impl": "pos_conv_embed.conv",
                   "ln_impl": "final_layer_norm.weight"}[field]
    assert bool(torch.isfinite(feats).all())
    feats.square().sum().backward()
    grads = [p.grad for n, p in backbone.named_parameters() if touched in n]
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
        from triad_tpu_torch.ops.flash_attention import flash_attention

        with pytest.raises(ValueError, match="CUDA"):
            flash_attention(m(1, 2, 37, 64), m(1, 2, 37, 64), m(1, 2, 37, 64))

    @pytest.mark.parametrize("name", ["attention_eval", "attention_eval_pair",
                                      "attention_eval_merged", "attention_eval_merged_pair"])
    def test_eval_attention_refuses_autograd(self, name):
        """The eval kernels have no backward (the Pallas ones have no VJP):
        each wrapper raises, on the CPU as on the card, when grad is enabled
        and an input requires it, naming the training impl; under no_grad
        it runs, and a tensor without requires_grad runs anyway."""
        from triad_tpu_torch.ops import attention as A

        x = torch.randn(2, 37, 384 if "merged" in name else 128)
        args = (x,) if "merged" in name else (x, x, x)
        fn = getattr(A, name)
        assert fn(*args).shape[-1] == 128
        x.requires_grad_()
        with torch.no_grad():
            fn(*args)
        train = "fused_packed_merged" if "merged" in name else "fused_packed"
        with pytest.raises(RuntimeError, match=f"no backward.*'{train}'"):
            fn(*args)

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
        """Unported impl values raise; the training options that this port
        now has (HuBERT's fused and fused_packed attention, the posconv and
        fused LayerNorm kernels; the ViT's fused and fused_packed_merged
        attention) run in training mode instead, and the eval options it
        now has (the head-pair attention, the "pallas", "conv_act", "phase"
        and "matmul" frontends) run at eval."""
        from triad_tpu_torch.models.multimodal import TriadModel

        cfg = small_model_config()
        if (section, field, value) in _PORTED_TRAINING_IMPLS:
            _check_runs_in_training(section, field, value)
            return
        if (section, field, value) in _PORTED_EVAL_IMPLS:
            _check_runs_at_eval(section, field, value)
            return
        sub = dataclasses.replace(getattr(cfg, section), **{field: value})
        # The model builds and HuBERT raises when it runs, or the model
        # does not build.
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            model = TriadModel(dataclasses.replace(cfg, **{section: sub}), device="meta")
            model.encode_audio(torch.zeros(1, 400, device="meta"))

    def test_flash_attention_raises(self):
        """"flash" runs (the flash kernels' plain twins on the CPU) and
        equals ops.flash_attention on the (B, H, N, 64) views; it raises
        only at a length the reference refuses (N = 600 pads to 640, which
        the library's 512-row blocks do not divide)."""
        from triad_tpu_torch.models.layers import dot_product_attention
        from triad_tpu_torch.ops.flash_attention import flash_attention

        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.normal(size=(2, 37, 2, 64)).astype(np.float32))
                   for _ in range(3))
        mask = torch.ones((2, 1, 1, 37), dtype=torch.bool)
        mask[1, ..., 20:] = False
        got = dot_product_attention(q, k, v, mask, torch.float32, impl="flash")
        want = flash_attention(*(x.transpose(1, 2) for x in (q, k, v)), mask.reshape(2, 37))
        assert torch.equal(got, want.transpose(1, 2))
        z = torch.zeros(1, 600, 1, 64)
        with pytest.raises(ValueError, match="600"):
            dot_product_attention(z, z, z, None, torch.float32, impl="flash")

    @pytest.mark.parametrize("impl", ["flash", "packed", "packed_pair", "fused_packed"])
    def test_attention_dropout_needs_xla(self, impl):
        """A live plain attention dropout runs the "xla" composition for
        "flash", "packed" and "packed_pair", as the JAX dispatch does (those
        kernels have no dropout; layers.py:422-427): bit-equal to "xla" under
        the same generator state. The training kernels draw their own
        dropout and raise when handed a plain one."""
        from triad_tpu_torch.models.layers import dot_product_attention, dropout

        rng = np.random.default_rng(1)
        q, k, v = (torch.from_numpy(rng.normal(size=(1, 4, 2, 64)).astype(np.float32))
                   for _ in range(3))

        def run(name):
            gen = torch.Generator().manual_seed(3)
            return dot_product_attention(q, k, v, None, torch.float32, impl=name,
                                         probs_dropout=lambda p: dropout(p, 0.5, gen))

        if impl == "fused_packed":
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                run(impl)
            return
        assert torch.equal(run(impl), run("xla"))

    def test_ignored_tpu_knobs_are_config_fields(self):
        from triad_tpu.core.config import HubertConfig, ViTConfig
        from triad_tpu_torch.models import IGNORED_TPU_KNOBS

        fields = {f.name for c in (ViTConfig, HubertConfig) for f in dataclasses.fields(c)}
        assert set(IGNORED_TPU_KNOBS) <= fields
