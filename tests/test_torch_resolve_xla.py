"""The port's ``resolve_xla_impls`` (triad_tpu_torch/parallel/tp.py)
against the JAX package's (triad_tpu/parallel/tp.py) on every preset:
ModelConfig(), perf_eval, perf_train, each knob of apply_train_knobs and
each value of every impl knob. Either both return equal configs (as
dicts, field for field) or both raise a ValueError with the same text."""

import dataclasses

import pytest

from triad_tpu.core import config as jax_config
from triad_tpu.parallel.tp import resolve_xla_impls as jax_resolve

KNOBS = ("perf", "tanh", "pkattn", "mqkv", "vitpk", "vitmq", "monofe", "posconv", "wave640",
         "wavext", "rematconv", "noremat", "mlprows2", "mlprows4", "attnpad", "pad128",
         "lorasep", "vitrows2")
IMPLS = {
    ("vit", "attention_impl"): ("xla", "auto", "fused", "fused_packed", "packed_merged",
                                "fused_packed_merged", "packed_merged_pair", "flash"),
    ("vit", "mlp_impl"): ("xla", "auto", "fused"),
    ("hubert", "attention_impl"): ("auto", "xla", "fused", "packed", "packed_pair", "flash"),
    ("hubert", "mlp_impl"): ("auto", "xla", "fused"),
    ("hubert", "ln_impl"): ("auto", "xla", "fused"),
    ("hubert", "frontend_impl"): ("conv", "matmul", "block_matmul", "phase", "monolithic",
                                  "pallas", "conv_act", "auto"),
    ("hubert", "posconv_impl"): ("conv", "pallas", "auto"),
    ("text", "attention_impl"): ("xla", "auto", "fused", "packed"),
}


def _presets():
    base = jax_config.ModelConfig()
    out = [("default", base), ("perf_eval", jax_config.perf_eval_model_config()),
           ("perf_train", jax_config.perf_train_model_config())]
    out += [(f"knob:{k}", jax_config.apply_train_knobs(base, k)) for k in KNOBS]
    for (section, field), values in IMPLS.items():
        for v in values:
            sub = dataclasses.replace(getattr(base, section), **{field: v})
            out.append((f"{section}.{field}={v}", dataclasses.replace(base, **{section: sub})))
    return out


def _outcome(resolve, cfg):
    try:
        return "ok", dataclasses.asdict(resolve(cfg))
    except ValueError as e:
        return "ValueError", str(e)


@pytest.mark.parametrize("name,cfg", _presets(), ids=[n for n, _ in _presets()])
def test_resolve_xla_impls_matches_jax(name, cfg):
    from triad_tpu_torch.config import Config
    from triad_tpu_torch.parallel.tp import resolve_xla_impls

    port_cfg = Config.from_dict({"model": dataclasses.asdict(cfg)}).model
    assert _outcome(resolve_xla_impls, port_cfg) == _outcome(jax_resolve, cfg)


def test_presets_resolve_as_expected():
    """ModelConfig() exports (HuBERT's "auto" knobs become "xla"); the two
    tuned presets are refused, each on its first kernel knob."""
    from triad_tpu_torch.config import ModelConfig, perf_eval_model_config, \
        perf_train_model_config
    from triad_tpu_torch.parallel.tp import resolve_xla_impls

    h = resolve_xla_impls(ModelConfig()).hubert
    assert (h.attention_impl, h.mlp_impl, h.ln_impl, h.frontend_impl, h.posconv_impl) == \
        ("xla", "xla", "xla", "conv", "conv")
    with pytest.raises(ValueError, match=r"vit\.attention_impl='packed_merged'"):
        resolve_xla_impls(perf_eval_model_config())
    with pytest.raises(ValueError, match=r"vit\.attention_impl='fused_packed'"):
        resolve_xla_impls(perf_train_model_config())
