"""ZeRO-1: the AdamW moments sharded over the data axis (the port of
``triad_tpu/parallel/zero.py``).

Every rank of a data-parallel run would hold the same fp32 moments. Here
each rank keeps the moments of one slice of each large parameter and
updates only that slice:

  * gradients are still reduced in full over the ranks (the clip norms
    need them, as in JAX);
  * the bank's AdamW for a sharded parameter steps a view of the rank's
    slice of it (``Shard.of``), with the moments of that slice only;
    AdamW is elementwise, so the slice's update is the one-process
    update of those elements;
  * the updated slices are all-gathered back into the replicated
    parameter.

Rule per tensor (``shard_largest_dim``, as in JAX): the largest dim that
the axis size divides and that is at least that size; a tensor with none
(biases too small, scalars) keeps replicated moments. The bank
(``train/optim.py``) takes the shards as its storage; its checkpoints
gather them into whole AdamW states (``OptimizerBank.full_state_dicts``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from triad_tpu_torch.parallel.dp import Axis, Mesh


@dataclass(frozen=True)
class Shard:
    """A rank's slice of a tensor: ``length`` entries of ``dim`` from
    ``start``."""

    dim: int
    start: int
    length: int

    def of(self, t: torch.Tensor) -> torch.Tensor:
        return t.narrow(self.dim, self.start, self.length)


def shard_largest_dim(x, mesh: Mesh, axis: Axis = "data") -> Optional[int]:
    """The dim of x ZeRO-1 shards over ``axis`` (None: replicated)."""
    n = mesh.axis_size(axis)
    shape = tuple(getattr(x, "shape", ()))
    best = None
    for d, s in enumerate(shape):
        if s % n == 0 and s >= n and (best is None or s > shape[best]):
            best = d
    return best


def zero1_state_shardings(model: torch.nn.Module, mesh: Mesh,
                          axis: Axis = "data") -> Dict[str, Shard]:
    """This rank's Shard of each parameter whose moments ZeRO-1 shards, by
    state-dict name (none in one process: nothing to split)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return {}
    out = {}
    for name, p in model.named_parameters():
        dim = shard_largest_dim(p, mesh, axis)
        if dim is not None:
            length = p.shape[dim] // n
            out[name] = Shard(dim, mesh.rank * length, length)
    return out


def apply_zero1(bank, mesh: Mesh, axis: Axis = "data"):
    """Give an OptimizerBank (before its first update) ZeRO-1 storage:
    each sharded parameter's AdamW state holds this rank's slice only."""
    bank.set_shards(zero1_state_shardings(bank.model, mesh, axis), mesh.group)
    return bank
