"""Tensor parallelism (mirrors ``triad_tpu/parallel/tp.py``).

Ported so far: ``resolve_xla_impls``, which puts every impl knob of a
ModelConfig on the plain (XLA in the JAX package) route. In the JAX
package a tensor-parallel mesh and the serving export both need it; in
the port the serving export does (``serve/export.py``): a bundle runs no
hand-written kernel. The mesh and the Megatron sharding rules
(``make_dp_tp_mesh``, ``tp_param_specs``, ``tp_state_shardings``) are
still to port, with FSDP (``parallel/fsdp.py``; ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

from triad_tpu_torch.config import ModelConfig

# What "auto" resolves to, and what an explicit value may be, per knob.
_XLA_VALUE = {
    "attention_impl": "xla",
    "mlp_impl": "xla",
    "ln_impl": "xla",
    "frontend_impl": "conv",
    "posconv_impl": "conv",
}
_ALLOWED = {
    "attention_impl": {"xla"},
    "mlp_impl": {"xla"},
    "ln_impl": {"xla"},
    "frontend_impl": {"conv", "matmul"},
    "posconv_impl": {"conv"},
}


def resolve_xla_impls(model_cfg: ModelConfig) -> ModelConfig:
    """ModelConfig with every impl knob on the plain route: "auto" knobs
    resolve to "xla" (or "conv"); an explicit kernel knob raises the JAX
    package's ValueError, word for word (there a kernel call is opaque to
    the SPMD partitioner and pins an exported bundle to one platform)."""

    def fix(sub, name: str):
        updates = {}
        for knob, ok in _ALLOWED.items():
            v = getattr(sub, knob, None)
            if v is None:
                continue
            if v == "auto":
                updates[knob] = _XLA_VALUE[knob]
            elif v not in ok:
                raise ValueError(
                    f"mesh.tp > 1 requires XLA impls; {name}.{knob}={v!r} "
                    f"is a pallas path (allowed: {sorted(ok)} or 'auto')"
                )
        return dataclasses.replace(sub, **updates) if updates else sub

    return dataclasses.replace(
        model_cfg,
        vit=fix(model_cfg.vit, "vit"),
        hubert=fix(model_cfg.hubert, "hubert"),
        text=fix(model_cfg.text, "text"),
    )
