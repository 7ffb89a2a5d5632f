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
  * the updated slices are all-gathered back over the data axes.

Rule per tensor (``shard_largest_dim``, as in JAX): the largest dim that
the axis size divides and that is at least that size; a tensor with none
(biases too small, scalars) keeps replicated moments.

Composed with tensor parallelism or FSDP (``param_specs``, the specs of
``parallel/tp.py`` / ``parallel/fsdp.py``): a moment inherits its
parameter's spec and also shards its largest spec-free dim (of the Flax
leaf's shape, as JAX decides it) over the data axes; a parameter already
sharded over them (FSDP) keeps its moments with its slice. The rank's
``Shard`` is then a slice of its slice of the parameter. The bank keys
the moments on parameter names, so JAX's ``partition`` argument has no
counterpart here.

The bank (``train/optim.py``) takes the shards as its storage; its
checkpoints gather them into whole AdamW states
(``OptimizerBank.full_state_dicts``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from triad_tpu_torch.models.convert import flax_dims
from triad_tpu_torch.parallel.dp import Axis, Mesh, _group, _names
from triad_tpu_torch.parallel.tp import Spec, flax_leaf, to_torch_spec, whole_shape


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


def extend_with_data(name: str, shape, base: Spec, mesh: Mesh, axis: Axis = "data") -> Spec:
    """The moment spec of the whole parameter ``name`` of torch ``shape``
    whose own spec is ``base``: ``axis`` on the largest spec-free dim of
    the Flax shape that the axis size divides; a base already using
    ``axis`` is kept (JAX's ``extend_with_data``)."""
    names = set(_names(axis))
    base = tuple(base) + (None,) * (len(shape) - len(base))
    used = {a for e in base if e is not None for a in _names(e)}
    if used & names:
        return base
    n = mesh.axis_size(axis)
    _, _, fshape = flax_leaf(name, tuple(shape))
    entries = [None] * len(shape)
    for i, j in enumerate(flax_dims(name, len(shape))):
        entries[j] = base[i]
    best = None
    for d, s in enumerate(fshape):
        if entries[d] is None and s % n == 0 and s >= n:
            if best is None or s > fshape[best]:
                best = d
    if best is not None:
        entries[best] = axis
    return to_torch_spec(name, len(shape), entries)


def zero1_moment_specs(model: torch.nn.Module, mesh: Mesh, axis: Axis,
                       param_specs: Dict[str, Spec]) -> Dict[str, Spec]:
    """{name: torch-layout spec of the parameter's AdamW moments} under
    ZeRO-1 x TP / FSDP (the model's parameters may be slices already:
    their whole shapes come from their specs)."""
    out = {}
    for name, p in model.named_parameters():
        base = param_specs.get(name, ())
        out[name] = extend_with_data(name, whole_shape(p.shape, base, mesh), base, mesh, axis)
    return out


def zero1_state_shardings(model: torch.nn.Module, mesh: Mesh, axis: Axis = "data",
                          param_specs: Optional[Dict[str, Spec]] = None) -> Dict[str, Shard]:
    """This rank's Shard of each parameter (of the rank's slice of it,
    under ``param_specs``) whose moments ZeRO-1 shards, by state-dict
    name (none where the axis is of size 1: nothing to split)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return {}
    out = {}
    if param_specs is None:
        for name, p in model.named_parameters():
            dim = shard_largest_dim(p, mesh, axis)
            if dim is not None:
                length = p.shape[dim] // n
                out[name] = Shard(dim, mesh.index(axis) * length, length)
        return out
    moments = zero1_moment_specs(model, mesh, axis, param_specs)
    for name, p in model.named_parameters():
        base = tuple(param_specs.get(name, ())) + (None,) * p.ndim
        for d, e in enumerate(moments[name]):
            if e is not None and base[d] is None:
                length = p.shape[d] // n
                out[name] = Shard(d, mesh.index(axis) * length, length)
    return out


def apply_zero1(bank, mesh: Mesh, axis: Axis = "data", param_specs=None):
    """Give an OptimizerBank (before its first update) ZeRO-1 storage:
    each sharded parameter's AdamW state holds this rank's slice only."""
    bank.set_shards(zero1_state_shardings(bank.model, mesh, axis, param_specs),
                    _group(mesh, axis))
    return bank
