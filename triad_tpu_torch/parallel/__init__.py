"""Parallelism of the port (mirrors ``triad_tpu/parallel``): data
parallelism over ``torch.distributed`` processes (the meshes, the
distributed losses with gathered or ring negatives, ZeRO-1, the
multi-process launch), tensor parallelism (Megatron column / row shards,
``tp.py``), FSDP (gather-on-use parameters, ``fsdp.py``) and their
composition with ZeRO-1 and the multi-slice mesh.

The names are exported lazily: the model layers import
``parallel.collectives``, and ``tp.py`` imports the model layers."""

import importlib

_EXPORTS = {
    "fetch": "distributed",
    "global_batch_from_local": "distributed",
    "initialize_from_env": "distributed",
    "process_shard": "distributed",
    "put_global_tree": "distributed",
    "distributed_av_loss": "dp",
    "distributed_tv_loss": "dp",
    "make_mesh": "dp",
    "fsdp_param_specs": "fsdp",
    "make_dp_tp_mesh": "tp",
    "make_multislice_tp_mesh": "tp",
    "resolve_xla_impls": "tp",
    "tp_param_specs": "tp",
    "tp_state_shardings": "tp",
    "apply_zero1": "zero",
    "zero1_state_shardings": "zero",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
