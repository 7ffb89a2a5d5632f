"""FSDP-style (ZeRO-3) parameter sharding over the 'data' axis (the port
of ``triad_tpu/parallel/fsdp.py``).

Every large parameter is stored sharded over 'data': each rank holds its
slice of the leaf as the parameter (``parallel/tp.py:shard_model`` cuts
it). At use, a forward pre-hook all-gathers the slices along the spec's
dim (``collectives.all_gather``, whose backward reduce-scatters: a
slice's gradient is the sum over the data ranks), and the forward's
post-hook puts the slice back. The gathered weight lives from its gather
until the backward has used it (autograd holds it for the weight's
products): at peak a rank holds each gathered leaf of an encoder once,
as a replicated run holds it. Re-gathering in the backward is not done.

Rules (JAX's, decided on the Flax leaf's shape and written in the torch
layout, ``models/convert.py:flax_dims``): shard the largest spec-free dim
that the data size divides, only for leaves of at least ``min_size``
elements; extends the tensor-parallel base specs. The data axis is 'data'
alone, so on a multi-slice mesh the shards stay inside a slice and
replicate over 'replica' (the gradients of a slice are all-reduced over
'replica' after the backward, ``train/optim.py``).

Like tensor parallelism, FSDP runs the plain impls
(``parallel/tp.py:resolve_xla_impls``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch.nn as nn

from triad_tpu_torch.models.convert import flax_dims
from triad_tpu_torch.parallel import collectives as C
from triad_tpu_torch.parallel.dp import Mesh
from triad_tpu_torch.parallel.tp import Spec, _axis_in, flax_leaf, to_torch_spec

# Convs whose weights their parent's forward reads (F.conv1d / F.conv2d).
_READ_BY_PARENT = (nn.Conv1d, nn.Conv2d)


def fsdp_param_specs(model: nn.Module, mesh: Mesh, data_axis: str = "data",
                     base_specs: Optional[Dict[str, Spec]] = None,
                     min_size: int = 1024) -> Dict[str, Spec]:
    """{state-dict name: torch-layout spec} with each large leaf's largest
    spec-free divisible dim (of its Flax shape) sharded over
    ``data_axis``, extending ``base_specs`` (the TP specs): a leaf already
    sharded over ``data_axis`` or with no free divisible dim keeps its
    base spec."""
    n = mesh.axis_size(data_axis)
    base_specs = base_specs or {}
    out = {}
    for name, p in model.named_parameters():
        _, _, shape = flax_leaf(name, tuple(p.shape))
        base = tuple(base_specs.get(name, ()))
        base += (None,) * (p.ndim - len(base))
        out[name] = base
        if int(np.prod(shape or (1,))) < min_size or _axis_in(base, data_axis) is not None:
            continue
        entries = [None] * p.ndim  # the base over the Flax dims
        for i, j in enumerate(flax_dims(name, p.ndim)):
            entries[j] = base[i]
        best = None
        for d, s in enumerate(shape):
            if entries[d] is None and s % n == 0 and s >= n:
                if best is None or s > shape[best]:
                    best = d
        if best is not None:
            entries[best] = data_axis
            out[name] = to_torch_spec(name, p.ndim, entries)
    return out


def _user(modules: Dict[str, nn.Module], prefix: str) -> str:
    """The module whose forward reads the parameters of module ``prefix``:
    itself, or its nearest ancestor that is neither a conv nor a module
    without a forward of its own (a ModuleList, HuBERT's ChannelNorm)."""
    while prefix and (isinstance(modules[prefix], _READ_BY_PARENT)
                      or type(modules[prefix]).forward is nn.Module.forward):
        prefix = prefix.rsplit(".", 1)[0] if "." in prefix else ""
    return prefix


def gather_on_use(model: nn.Module, mesh: Mesh, specs: Dict[str, Spec],
                  data_axis: str = "data") -> None:
    """Hooks that all-gather each ``data_axis``-sharded parameter (already
    this rank's slice) before the forward of the module that reads it, and
    put the slice back after."""
    if data_axis not in mesh.shape:
        return
    group = mesh.group_of(data_axis)
    modules = dict(model.named_modules())
    leaves: Dict[str, list] = {}
    for name, _ in model.named_parameters():
        dim = _axis_in(specs.get(name, ()), data_axis)
        if dim is None:
            continue
        prefix, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        leaves.setdefault(_user(modules, prefix), []).append((modules[prefix], leaf, dim))
    for user, held in leaves.items():
        _hook(modules[user], held, group)


def _hook(module: nn.Module, held, group) -> None:
    slices = []

    def gather(mod, args):
        for owner, leaf, dim in held:
            shard = owner._parameters[leaf]
            slices.append(shard)
            owner._parameters[leaf] = C.all_gather(shard, group, dim)

    def restore(mod, args, out):
        for (owner, leaf, _), shard in zip(held, slices):
            owner._parameters[leaf] = shard
        slices.clear()
        return out

    module.register_forward_pre_hook(gather)
    module.register_forward_hook(restore)
