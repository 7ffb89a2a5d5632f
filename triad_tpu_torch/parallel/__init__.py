"""Parallelism of the port (mirrors ``triad_tpu/parallel``): data
parallelism over ``torch.distributed`` processes (the meshes, the
distributed losses with gathered or ring negatives, ZeRO-1, the
multi-process launch) and ``tp.resolve_xla_impls``, which the serving
export applies. Tensor parallelism and FSDP are still to port
(ROADMAP.md)."""

from triad_tpu_torch.parallel.distributed import (
    fetch,
    global_batch_from_local,
    initialize_from_env,
    process_shard,
    put_global_tree,
)
from triad_tpu_torch.parallel.dp import (
    distributed_av_loss,
    distributed_tv_loss,
    make_mesh,
)
from triad_tpu_torch.parallel.tp import resolve_xla_impls
from triad_tpu_torch.parallel.zero import (
    apply_zero1,
    zero1_state_shardings,
)

__all__ = [
    "distributed_av_loss",
    "distributed_tv_loss",
    "make_mesh",
    "apply_zero1",
    "zero1_state_shardings",
    "fetch",
    "global_batch_from_local",
    "initialize_from_env",
    "process_shard",
    "put_global_tree",
    "resolve_xla_impls",
]
