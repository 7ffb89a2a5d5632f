"""The differentiable collectives of the data-parallel losses
(``parallel/dp.py``), over a ``torch.distributed`` process group.

The JAX package gets these from ``shard_map``: ``all_gather`` transposes
to a reduce-scatter, ``psum`` to a psum of the cotangents, ``ppermute`` to
the inverse permutation. Here they are autograd Functions, under one
convention: every rank runs its backward from the replicated loss with
the cotangent 1 / world (``train/step.py`` scales by it), so the gradient
a rank gets for a tensor it holds is the global loss's gradient for it,
and the gradients of replicated parameters sum over ranks to the global
one.

  all_gather    tiled along a dim; backward: the reduce-scatter of the
                cotangents (this rank's slice of their sum)
  all_reduce    sum; backward: the all-reduce of the cotangents
  all_max       max, no gradient (the logsumexp shift)
  ring_shift    send to rank + 1, receive from rank - 1; backward: the
                reverse hop

and Megatron's "reduce from the model region" of tensor parallelism
(arXiv:1909.08053), over the group of a mesh's ``model`` axis:

  reduce_from_model  the all-reduce; backward: identity (the output of a
                     row-parallel layer: each rank holds a partial sum)

Its conjugate, "copy to the model region" (identity; backward: the
all-reduce of the cotangents), is fused into the column-parallel layer's
product (``models/layers.py:_ColumnParallel``), so that the sum of the
ranks' partial input gradients runs on fp32 partials and rounds once.

With no process group (one process) every collective is the identity; a
process group of one still runs them (so a world of one exercises the
backend). ``SINGLE`` is the group of a mesh axis (or axes) of size 1, over
which every collective is the identity and runs nothing.

The backend is the caller's (``parallel/distributed.py``). gloo takes
CUDA tensors in all_reduce, broadcast, all_gather and reduce_scatter, not
in send / recv (``GLOO_CUDA_OPS``, as ``tools/gloo_probe.py`` found them
on the card):
the ring's send / recv of a CUDA tensor goes through a pinned host copy
here, in ``_run``. NCCL never takes that path.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

GLOO_CUDA_OPS = ("all_reduce", "broadcast", "all_gather",
                 "reduce_scatter")  # gloo's ops on CUDA tensors


class _Single:
    """The group of one process (a mesh's size-1 axes): nothing to talk to."""

    def __repr__(self):
        return "SINGLE"


SINGLE = _Single()


def world(group=None) -> int:
    """The group's size, 1 without a process group."""
    return dist.get_world_size(group) if _active(group) else 1


def rank(group=None) -> int:
    """This process's rank in the group, 0 without a process group."""
    return dist.get_rank(group) if _active(group) else 0


def _active(group=None) -> bool:
    return group is not SINGLE and dist.is_initialized()


def collective_device(group=None) -> torch.device:
    """Where a small host-made tensor goes for a collective: NCCL takes
    only CUDA tensors (the current device), gloo the CPU."""
    if _active(group) and dist.get_backend(group) == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _staged(op: str, x: torch.Tensor, group) -> bool:
    """Does ``op`` on ``x`` go through a pinned host copy? Only under gloo,
    for a CUDA tensor and an op gloo does not run on CUDA tensors."""
    return (x.is_cuda and op not in GLOO_CUDA_OPS
            and dist.get_backend(group) == dist.Backend.GLOO)


def _host(x: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x)
    return buf


def _run(op: str, x: torch.Tensor, group, fn: Callable[[torch.Tensor], torch.Tensor]):
    """fn(x) on the device, or on a pinned host copy where gloo needs one,
    the result moved back to x's device."""
    if not _staged(op, x, group):
        return fn(x)
    return fn(_host(x)).to(x.device)


def all_reduce_(x: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """In-place all-reduce (no autograd)."""
    if _active(group):
        dist.all_reduce(x, op=op, group=group)
    return x


def broadcast_(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In-place broadcast from global rank ``src`` (no autograd)."""
    if _active(group):
        dist.broadcast(x, src, group=group)
    return x


def gather_rows(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's x concatenated along ``dim`` in rank order (no
    autograd)."""
    if not _active(group):
        return x
    n = world(group)

    def gather(t):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    return _run("all_gather", x, group, gather)


def reduce_scatter(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """This rank's slice along ``dim`` (slices in rank order) of the sum
    over ranks of x (no autograd)."""
    if not _active(group):
        return x
    n = world(group)

    def scatter(t):
        t = t.movedim(dim, 0).contiguous()
        out = t.new_empty((t.shape[0] // n,) + t.shape[1:])
        dist.reduce_scatter_tensor(out, t, group=group)
        return out.movedim(0, dim).contiguous()

    return _run("reduce_scatter", x, group, scatter)


def _shift(x: torch.Tensor, step: int, group) -> torch.Tensor:
    """x sent ``step`` ranks ahead; what the rank ``step`` behind sent."""
    n = world(group)
    if n == 1:
        return x
    me = rank(group)
    dst, src = (me + step) % n, (me - step) % n

    def exchange(t):
        t = t.contiguous()
        out = torch.empty_like(t)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, dist.get_global_rank(group, dst) if group else dst, group),
            dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src) if group else src,
                       group),
        ])
        for r in reqs:
            r.wait()
        return out

    return _run("send_recv", x, group, exchange)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_rows(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), group=ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -1, ctx.group), None


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Differentiable tiled all-gather along ``dim`` (every rank's slices
    in rank order)."""
    return _AllGather.apply(x, group, dim) if _active(group) else x


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum over ranks."""
    return _AllReduce.apply(x, group) if _active(group) else x


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: all-reduce forward, identity backward. The caller
    sums in fp32 (``models/layers.py:Dense``'s row-parallel partials)."""
    return _ReduceFromModel.apply(x, group) if _active(group) else x


def all_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """Max over ranks of a detached copy (no gradient)."""
    return all_reduce_(x.detach().clone(), dist.ReduceOp.MAX, group)


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable one-hop ring shift: this rank gets rank - 1's x."""
    return _RingShift.apply(x, group) if world(group) > 1 else x

