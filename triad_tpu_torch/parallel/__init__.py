"""Parallelism of the port (mirrors ``triad_tpu/parallel``). Only
``tp.resolve_xla_impls`` is ported so far: the serving export
(``serve/export.py``) applies it. The meshes, the data-parallel loss
collectives and the dp / tp / fsdp / zero1 shardings are still to port
(ROADMAP.md)."""

from triad_tpu_torch.parallel.tp import resolve_xla_impls

__all__ = ["resolve_xla_impls"]
