"""Multi-process runs (the port of ``triad_tpu/parallel/distributed.py``):
one process per device, all in every collective.

  * ``initialize_from_env()`` brings up ``torch.distributed`` from the JAX
    package's ``TRIAD_COORDINATOR`` / ``TRIAD_NUM_PROCESSES`` /
    ``TRIAD_PROCESS_ID`` or from torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``. The
    backend is ``TRIAD_DIST_BACKEND``, else "nccl" for a CUDA device and
    "gloo" for the CPU: never switched behind the caller's back.
  * ``process_shard(mesh, axis)`` is (data index, data size) for the
    loaders: every process runs the same sampler (seed, epoch, batch) and
    decodes only its rows of each global batch, so data order and resume
    are the one-process ones. The ranks of a tensor-parallel group share
    a data index, so they load the same rows.
  * ``put_global_tree`` broadcasts rank 0's parameters and buffers, so no
    rank starts apart; ``fetch`` brings every rank's rows to the host;
    ``global_batch_from_local`` checks a rank's rows against the global
    batch.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from triad_tpu_torch.parallel import collectives as C


def _env_int(name: str) -> int:
    try:
        return int(os.environ[name])
    except (KeyError, ValueError) as e:
        raise ValueError(f"initialize_from_env: {name} must be set to an integer") from e


def backend_for(device) -> str:
    """TRIAD_DIST_BACKEND, else "nccl" for a CUDA device, "gloo" for the CPU."""
    name = os.environ.get("TRIAD_DIST_BACKEND")
    if name:
        return name
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_from_env(device="cuda", timeout_s: float = 1800.0) -> Tuple[int, int]:
    """Initialize ``torch.distributed`` when the environment names a world;
    return (rank, world). Without one (no TRIAD_COORDINATOR, no
    MASTER_ADDR) this is one process: (0, 1), nothing initialized. Safe to
    call again (returns the current state). On "cuda" the process takes
    device LOCAL_RANK % device_count (LOCAL_RANK defaults to the rank)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coord = os.environ.get("TRIAD_COORDINATOR")
    if coord:
        world, rank = _env_int("TRIAD_NUM_PROCESSES"), _env_int("TRIAD_PROCESS_ID")
        init = f"tcp://{coord}"
    elif os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
        init = "env://"
    else:
        return 0, 1
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_from_env: no CUDA device (pass device='cpu' to run "
                               "on the CPU)")
        torch.cuda.set_device(process_device(device, rank))
    dist.init_process_group(backend_for(device), init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world


def process_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """This process's device: "cuda" is cuda:(LOCAL_RANK % device_count)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", C.rank() if rank is None else rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def process_shard(mesh=None, axis="data") -> Optional[Tuple[int, int]]:
    """The loaders' row-slice selector: (data index, data size) over the
    mesh's data ``axis`` (a name or a tuple), or (rank, world) without a
    mesh; None when there is one slice."""
    index, size = ((mesh.index(axis), mesh.axis_size(axis)) if mesh is not None
                   else (C.rank(), C.world()))
    return (index, size) if size > 1 else None


def coordination_barrier(name: str) -> None:
    """Every process waits here for the others (no-op in one process).
    ``name`` says which barrier a hung run waits at."""
    if C.world() > 1:
        try:
            dist.barrier()
        except RuntimeError as e:
            raise RuntimeError(f"barrier {name!r}: {e}") from e


def fetch(x: torch.Tensor) -> np.ndarray:
    """Every rank's rows of x (dim 0), concatenated in rank order, as
    numpy on every rank."""
    return C.gather_rows(x.detach()).cpu().numpy()


@torch.no_grad()
def put_global_tree(tree):
    """Rank 0's values on every rank, in place: a module's parameters and
    buffers, or a dict of tensors. Returns ``tree``."""
    tensors = (list(tree.parameters()) + list(tree.buffers())
               if isinstance(tree, torch.nn.Module) else list(tree.values()))
    for t in tensors:
        C.broadcast_(t.data if isinstance(t, torch.nn.Parameter) else t, 0)
    return tree


def global_batch_from_local(mesh, local, batch_size: int, axis="data"):
    """This rank's rows of a global batch of ``batch_size``, after a shape
    check: they number batch_size over the size of the data ``axis``."""
    rows = next(iter(local.values())).shape[0] if isinstance(local, dict) else local.shape[0]
    n = mesh.axis_size(axis)
    if batch_size % n or rows * n != batch_size:
        raise ValueError(f"{rows} local rows on a data axis of {n} make no global batch of "
                         f"{batch_size}")
    return local
