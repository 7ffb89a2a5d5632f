"""The config tree of the port: the JAX package's frozen dataclasses and
its tuned presets, shared by import. ``triad_tpu/core/config.py`` imports
no JAX (ROADMAP.md: host code without JAX is shared, not copied); every
module of the port takes its configs from here."""

from triad_tpu.core.config import (  # noqa: F401
    Config,
    DistilBertConfig,
    HubertConfig,
    LossConfig,
    ModelConfig,
    OptimConfig,
    ViTConfig,
    perf_eval_model_config,
    perf_train_loss_config,
    perf_train_model_config,
)
