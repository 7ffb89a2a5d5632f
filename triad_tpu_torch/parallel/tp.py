"""Tensor (model) parallelism over a ('data', 'model') mesh (the port of
``triad_tpu/parallel/tp.py``).

The JAX package leaves the model code untouched and lets GSPMD insert the
collectives. Here the sharded layers run them themselves, by Megatron-LM's
column / row split (arXiv:1909.08053), over the group of the mesh's
``model`` axis (``parallel/collectives.py``'s conjugate pair):

  * COLUMN-parallel (``q_proj``/``k_proj``/``v_proj``, ``q_lin``/
    ``k_lin``/``v_lin``, ``intermediate_dense``, ``fc1``): each rank
    holds rows of the torch weight (out, in), so its columns of the
    output, and the slice of the bias; its input's gradient is summed
    over ``model`` (Megatron's "copy to the model region",
    ``models/layers.py:_ColumnParallel``).
    The attention runs on the rank's heads.
  * ROW-parallel (``out_proj``/``out_lin``, ``output_dense``, ``fc2``):
    each rank holds columns of the weight (the input dim); the partial
    products are summed over ``model`` in fp32 and cast once, then the
    replicated bias is added (``models/layers.py:Dense``).
  * ``word_embeddings``: vocabulary-sharded. Each rank looks up its own
    rows, zeroes the ids it does not hold and the lookups are summed over
    ``model``.
  * Everything else replicates: the ViT's fused ``qkv`` / ``proj`` with
    their LoRA (the fused (D, 3D) layout interleaves q|k|v, so a split
    would not align with the heads), the norms, the convs, the heads and
    ``temperature``.

A leaf whose dim ``tp`` does not divide replicates, as in JAX. A split
that cuts a head (hidden % tp == 0, num_heads % tp != 0), where GSPMD
would re-gather the activations, raises ``not_ported``.

The specs (``tp_param_specs``) are the JAX package's rules leaf for leaf,
decided on each leaf's Flax name and shape and written in the torch
layout (``models/convert.py:flax_dims``): a spec is a tuple with one
entry a dim, None or a mesh axis. Features leave the encoders replicated
over ``model``, so the losses run over the data axes only
(``parallel/dp.py``). The batch is sharded over the data axes: both ranks
of a model group hold the same rows.

The hand-written kernels do not take a shard (as a ``pallas_call`` is
opaque to GSPMD), so a tensor-parallel or FSDP run resolves every impl
knob to the plain route first (``resolve_xla_impls``): "auto" knobs
resolve, explicit kernel knobs raise. The serving export applies it too
(``serve/export.py``): a bundle runs no hand-written kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch.nn as nn

from triad_tpu_torch.config import ModelConfig
from triad_tpu_torch.models.convert import flax_dims
from triad_tpu_torch.models.layers import Dense, not_ported
from triad_tpu_torch.parallel import collectives as C
from triad_tpu_torch.parallel.dp import Mesh

Spec = Tuple  # one entry a dim: None or a mesh axis name (or a tuple of names)

# parents whose Flax 'kernel' shards the OUTPUT (last) dim / 'bias' dim 0
_COLUMN_PARALLEL = frozenset({
    "q_proj", "k_proj", "v_proj",          # HuBERT attention
    "q_lin", "k_lin", "v_lin",             # DistilBERT attention
    "intermediate_dense",                  # HuBERT MLP in
    "fc1",                                 # DistilBERT FFN / ViT MLP in
})
# parents whose Flax 'kernel' shards the INPUT (contraction) dim
_ROW_PARALLEL = frozenset({
    "out_proj", "out_lin",                 # attention output
    "output_dense",                        # HuBERT MLP out
    "fc2",                                 # DistilBERT FFN / ViT MLP out
})
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


def make_dp_tp_mesh(num_devices: Optional[int] = None, tp: int = 1, data_axis: str = "data",
                    model_axis: str = "model", group=None) -> Mesh:
    """(num_devices / tp, tp) mesh over the process group; 'model' is the
    minor axis, so a model-parallel group is tp consecutive ranks."""
    if num_devices is None:
        num_devices = C.world(group)
    if num_devices % tp:
        raise ValueError(f"num_devices={num_devices} not divisible by tp={tp}")
    return Mesh({data_axis: num_devices // tp, model_axis: tp}, group)


def make_multislice_tp_mesh(num_slices: int, data_per_slice: int, tp: int,
                            replica_axis: str = "replica", data_axis: str = "data",
                            model_axis: str = "model", group=None) -> Mesh:
    """(num_slices, data_per_slice, tp) mesh: the batch and the losses
    ride the (replica, data) axes, the Megatron shards 'model' (minor);
    every model-parallel group stays inside one slice."""
    n = num_slices * data_per_slice * tp
    have = C.world(group)
    if have < n:
        raise ValueError(f"need {n} devices for {num_slices}x{data_per_slice}x{tp}, have {have}")
    return Mesh({replica_axis: num_slices, data_axis: data_per_slice, model_axis: tp}, group)


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


def flax_leaf(name: str, shape) -> Tuple[Optional[str], str, Tuple[int, ...]]:
    """(parent, leaf, shape) of the Flax leaf of state-dict entry ``name``
    of the given torch shape (``models/convert.py``'s name map)."""
    parts = name.split(".")
    leaf = parts[-1]
    if leaf == "weight":
        leaf = "kernel" if len(shape) >= 2 else "scale"
    perm = flax_dims(name, len(shape))
    flax_shape = [0] * len(shape)
    for i, j in enumerate(perm):
        flax_shape[j] = shape[i]
    return (parts[-2] if len(parts) >= 2 else None), leaf, tuple(flax_shape)


def to_torch_spec(name: str, ndim: int, flax_spec) -> Spec:
    """A spec over the Flax leaf's dims, written over the torch dims."""
    entries = list(flax_spec) + [None] * (ndim - len(flax_spec))
    return tuple(entries[j] for j in flax_dims(name, ndim))


def tp_param_specs(model: nn.Module, tp: int, model_axis: str = "model") -> Dict[str, Spec]:
    """{state-dict name: torch-layout spec} of the Megatron rules (module
    docstring) for a model of whole tensors. Leaves that don't divide by
    ``tp`` replicate (spec of Nones)."""

    def flax_spec(parent, leaf, shape):
        def divisible(dim: int) -> bool:
            return len(shape) > dim and shape[dim] % tp == 0

        if parent in _COLUMN_PARALLEL:
            if leaf == "kernel" and divisible(len(shape) - 1):
                return (None,) * (len(shape) - 1) + (model_axis,)
            if leaf == "bias" and divisible(0):
                return (model_axis,)
        elif parent in _ROW_PARALLEL:
            if leaf == "kernel" and divisible(0):
                return (model_axis,) + (None,) * (len(shape) - 1)
        elif leaf == "word_embeddings" and divisible(0):
            return (model_axis, None)
        return ()

    out = {}
    for name, p in model.named_parameters():
        parent, leaf, shape = flax_leaf(name, tuple(p.shape))
        out[name] = to_torch_spec(name, p.ndim, flax_spec(parent, leaf, shape))
    return out


def tp_state_shardings(param_specs: Dict[str, Spec]) -> Dict[str, Dict[str, Spec]]:
    """The layout of each part of a TrainState under tensor parallelism:
    the parameters and their accumulated gradients carry the TP specs. The
    AdamW moments of a sharded parameter are held with its slice (each
    rank's AdamW steps its slice; JAX replicates them without ZeRO-1, and
    AdamW being elementwise, the values are the same). ZeRO-1 on top:
    ``parallel/zero.py:zero1_state_shardings(..., param_specs=...)``."""
    specs = dict(param_specs)
    return {"params": specs, "grads": dict(specs), "moments": dict(specs)}


def _axis_in(spec: Spec, axis: str) -> Optional[int]:
    """The dim of ``spec`` that holds ``axis`` (None: none does)."""
    for d, e in enumerate(spec):
        if e is not None and axis in ((e,) if isinstance(e, str) else tuple(e)):
            return d
    return None


def check_heads(model_cfg: ModelConfig, tp: int) -> None:
    """Raise ``not_ported`` where ``tp`` splits an encoder's projections
    (hidden % tp == 0) but not its heads: GSPMD would re-gather there. The
    ViT's attention stays whole at any tp."""
    for name in ("hubert", "text"):
        c = getattr(model_cfg, name)
        if tp > 1 and c.hidden_size % tp == 0 and c.num_heads % tp:
            raise not_ported(f"mesh.tp={tp} on {name}'s {c.num_heads} heads (a split inside "
                             "a head)", "GSPMD's re-gather of the head-split activations")


def shard_model(model: nn.Module, mesh: Mesh, specs: Dict[str, Spec],
                model_axis: str = "model", data_axis: str = "data") -> nn.Module:
    """Lay a model of whole tensors out by ``specs`` on this rank, in
    place: every sharded parameter becomes this rank's slice of it; the
    layers of a ``model_axis`` spec run tensor-parallel (Dense column / row,
    the vocabulary-sharded word embeddings); the leaves of a ``data_axis``
    spec are gathered at use (``parallel/fsdp.py:gather_on_use``)."""
    from triad_tpu_torch.parallel.fsdp import gather_on_use

    modules = dict(model.named_modules())
    tp = mesh.axis_size(model_axis) if model_axis in mesh.shape else 1
    check_heads(model.cfg, tp)
    group = mesh.group_of(model_axis) if model_axis in mesh.shape else C.SINGLE
    index = mesh.index(model_axis) if model_axis in mesh.shape else 0
    for name, p in list(model.named_parameters()):
        spec = specs.get(name, ())
        if not any(e is not None for e in spec):
            continue
        prefix, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        owner = modules[prefix]
        d = _axis_in(spec, model_axis)
        if d is not None:
            if isinstance(owner, Dense) and leaf == "weight":
                owner.set_tensor_parallel("column" if d == 0 else "row", index, tp, group)
            elif leaf == "word_embeddings":
                owner.set_vocab_shard(index, p.shape[0] // tp, group)
            elif not (isinstance(owner, Dense) and leaf == "bias"):
                raise not_ported(f"a {model_axis!r} shard of {name}", "GSPMD's partitioning")
        local = mesh.local(p.detach(), spec).clone()
        owner._parameters[leaf] = nn.Parameter(local, requires_grad=p.requires_grad)
    gather_on_use(model, mesh, specs, data_axis)
    return model


def whole_shape(shape, spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """The whole tensor's shape from a slice's ``shape`` and its spec."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(int(s) * (mesh.axis_size(e) if e is not None else 1)
                 for s, e in zip(shape, spec))
