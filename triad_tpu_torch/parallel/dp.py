"""Data-parallel training losses with all-gathered or ring-passed in-batch
negatives (the port of ``triad_tpu/parallel/dp.py``).

Each rank holds its rows of the global batch. The training semantics are
the one-process ones, the symmetric InfoNCE over the full global (B, B)
clip-sim matrix, while the O(B^2 Na Nv) aggregation is split by rows:

  * each rank all-gathers the (small, projected) visual key tokens and
    computes only its row block of clip sims (local queries x global
    keys); ``LossConfig.negatives="ring"`` passes the key shards one hop
    around the ring instead (``_ring_aggregate``), the same values;
  * the row CE is local; the column CE takes a distributed logsumexp
    (max and sum over ranks); the regularizer sums and the statistics
    are summed over ranks.

Gradients flow through ``parallel/collectives.py``'s differentiable
collectives. Every scalar returned is replicated over the ranks and equal
to the one-process value on the concatenated batch up to the order of
the cross-rank sums.

A ``Mesh`` is the process group seen as the JAX mesh's axes: ranks
replica-major (a multi-slice mesh's rank r is slice r // d, chip r % d),
the last axis minor. The losses' collectives run over ``axis`` only (the
data axes): under tensor parallelism each ``model`` rank of a data
index holds the same rows and computes the same replicated loss.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from triad_tpu_torch.config import LossConfig
from triad_tpu_torch.ops.losses import (
    AVLossOut,
    TVLossOut,
    patch_sparsity,
    temperature_calibration,
)
from triad_tpu_torch.ops.similarity import aggregate_crossbatch, diag_token_sims
from triad_tpu_torch.parallel import collectives as C

Axis = Union[str, Tuple[str, ...]]


class Mesh:
    """Named axes over a process group (None: the default group): ``shape``
    maps each axis name to its size, in mesh order; their product is the
    group's size (1 without a process group). Ranks lie in mesh order, the
    last axis minor: rank r of a (data, model) mesh of tp = 2 is (data
    r // 2, model r % 2), as ``make_dp_tp_mesh`` orders the JAX devices.

    The process group of every coset of every subset of the axes of size >
    1 is made here, on every rank, in one order (``torch.distributed``
    needs every rank in every ``new_group`` call); ``group_of(axes)`` is
    this rank's. Axes of size 1 talk to no one (``collectives.SINGLE``)."""

    def __init__(self, shape: Dict[str, int], group=None):
        self.shape = dict(shape)
        self.group = group
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        if self.size != C.world(group):
            raise ValueError(f"a mesh of {self.size} devices {self.shape} over a process group "
                             f"of {C.world(group)} processes")
        self.coords = dict(zip(self.axis_names, _unravel(C.rank(group), self.shape.values())))
        self._groups = {}
        live = tuple(a for a in self.axis_names if self.shape[a] > 1)
        if len(live) > 1 and C._active(group):
            members = (torch.distributed.get_process_group_ranks(group) if group is not None
                       else list(range(self.size)))
            for k in range(1, len(live)):
                for subset in itertools.combinations(live, k):
                    for ranks in self._cosets(subset):
                        pg = torch.distributed.new_group([members[r] for r in ranks])
                        if self.rank in ranks:
                            self._groups[subset] = pg

    def _cosets(self, subset):
        """Each coset of ``subset``: the flat ranks that share the other
        axes' coordinates, ascending (so in ``index(subset)`` order)."""
        dims = list(self.shape.values())
        cosets = {}
        for r in range(self.size):
            c = _unravel(r, dims)
            key = tuple(x for a, x in zip(self.axis_names, c) if a not in subset)
            cosets.setdefault(key, []).append(r)
        return [cosets[k] for k in sorted(cosets)]

    @property
    def rank(self) -> int:
        """This process's flat index (the last axis minor)."""
        return C.rank(self.group)

    def axis_size(self, axis: Axis) -> int:
        return math.prod(self.shape[a] for a in _names(axis))

    def index(self, axis: Axis) -> int:
        """This rank's flat index over ``axis`` (a name or a tuple of
        names, the first major)."""
        i = 0
        for a in _names(axis):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group_of(self, axis: Axis):
        """The process group of this rank's coset of ``axis``: the mesh's
        group when the axis spans every axis of size > 1 (so a mesh of one
        still runs its collectives), else ``SINGLE`` when it spans none."""
        live = tuple(a for a in self.axis_names if a in _names(axis) and self.shape[a] > 1)
        if live == tuple(a for a in self.axis_names if self.shape[a] > 1):
            return self.group
        if not live:
            return C.SINGLE
        return self._groups[live]

    # -- tensors laid out by a spec: one entry per dim, None or an axis ----

    def local(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's slice of a whole tensor laid out by ``spec``."""
        for d, e in enumerate(spec or ()):
            if e is not None:
                n = t.shape[d] // self.axis_size(e)
                t = t.narrow(d, self.index(e) * n, n)
        return t

    def whole(self, t: torch.Tensor, spec) -> torch.Tensor:
        """The whole tensor from every rank's slice of it (a collective:
        every rank of each sharded axis calls it)."""
        for d, e in enumerate(spec or ()):
            if e is not None:
                t = C.gather_rows(t, self.group_of(e), d)
        return t

    def __repr__(self):
        return f"Mesh({self.shape})"


def _unravel(r: int, dims) -> Tuple[int, ...]:
    out = []
    for n in reversed(list(dims)):
        out.append(r % n)
        r //= n
    return tuple(reversed(out))


def _names(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _group(mesh: Mesh, axis: Axis):
    """The process group of collectives over ``axis``: this rank's coset
    of it. A tuple axis is taken in mesh order (the gathered rows' order)."""
    names = _names(axis)
    if any(a not in mesh.shape for a in names):
        raise ValueError(f"axis {axis!r} not in mesh axes {mesh.axis_names}")
    if list(names) != [a for a in mesh.axis_names if a in names]:
        raise ValueError(f"collectives over {axis!r} on {mesh}: the port takes a tuple axis in "
                         "mesh order")
    return mesh.group_of(axis)


def make_mesh(num_devices: Optional[int] = None, axis: str = "data", group=None) -> Mesh:
    """A one-axis mesh over the process group (num_devices: its size;
    None takes the group's)."""
    n = C.world(group) if num_devices is None else num_devices
    return Mesh({axis: n}, group)


def make_multislice_mesh(num_slices: int, devices_per_slice: Optional[int] = None,
                         axes: Sequence[str] = ("replica", "data"), group=None) -> Mesh:
    """A (num_slices, devices_per_slice) mesh, replica-major: rank r is
    slice r // devices_per_slice, chip r % devices_per_slice."""
    if devices_per_slice is None:
        devices_per_slice = C.world(group) // num_slices
    return Mesh({axes[0]: num_slices, axes[1]: devices_per_slice}, group)


# ---------------------------------------------------------------------------
# Distributed pieces (each rank's rows; the collectives span the axis)
# ---------------------------------------------------------------------------


def _local_diag(clip_block: torch.Tensor, mesh: Mesh, axis: Axis):
    b_l = clip_block.shape[0]
    rows = torch.arange(b_l, device=clip_block.device)
    return rows, mesh.index(axis) * b_l + rows


def _distributed_symmetric_infonce(clip_block: torch.Tensor, mesh: Mesh, axis: Axis):
    """Symmetric CE over the global matrix from per-rank row blocks.
    clip_block: (B_l, B), local query rows x global key columns. Returns
    (contrastive loss replicated, diag_vals (B_l,) local)."""
    group = _group(mesh, axis)
    b = clip_block.shape[1]
    rows, cols = _local_diag(clip_block, mesh, axis)
    diag_vals = clip_block[rows, cols]
    # a2v (rows): full columns are local.
    row_loss_sum = (torch.logsumexp(clip_block, dim=1) - diag_vals).sum()
    # v2a (columns): the logsumexp over every rank's rows; the max shift
    # carries no gradient (it cancels).
    col_max = C.all_max(clip_block.detach().amax(dim=0), group)
    sumexp = C.all_reduce(torch.exp(clip_block - col_max[None, :]).sum(dim=0), group)
    col_lse = torch.log(sumexp) + col_max
    col_loss_sum = (col_lse[cols] - diag_vals).sum()
    contrastive = (C.all_reduce(row_loss_sum, group)
                   + C.all_reduce(col_loss_sum, group)) / (2.0 * b)
    return contrastive, diag_vals


@torch.no_grad()
def _distributed_stats(clip_block: torch.Tensor, diag_vals: torch.Tensor, mesh: Mesh,
                       axis: Axis, prefix: str) -> Dict[str, torch.Tensor]:
    """pos / neg mean and std (Bessel), separation, hardest negative over
    the global matrix (ops.losses.similarity_stats); no gradient."""
    group = _group(mesh, axis)
    clip, diag = clip_block.detach(), diag_vals.detach()
    b = clip.shape[1]
    rows, cols = _local_diag(clip, mesh, axis)
    offdiag = torch.ones_like(clip)
    offdiag[rows, cols] = 0.0
    n_neg = b * b - b
    pos_sum, neg_sum = C.all_reduce_(torch.stack([diag.sum(), (clip * offdiag).sum()]),
                                     group=group)
    pos_mean, neg_mean = pos_sum / b, neg_sum / n_neg
    pos_sq, neg_sq = C.all_reduce_(torch.stack([
        ((diag - pos_mean) ** 2).sum(), (((clip - neg_mean) ** 2) * offdiag).sum()]),
        group=group)
    hardest = C.all_max(torch.where(offdiag > 0, clip, -torch.inf).amax(), group)
    return {
        f"{prefix}_pos_sim_mean": pos_mean,
        f"{prefix}_pos_sim_std": torch.sqrt(pos_sq / max(b - 1, 1)),
        f"{prefix}_neg_sim_mean": neg_mean,
        f"{prefix}_neg_sim_std": torch.sqrt(neg_sq / max(n_neg - 1, 1)),
        f"{prefix}_separation": pos_mean - neg_mean,
        f"{prefix}_hardest_negative": hardest,
    }


def _implementation(cfg: LossConfig) -> str:
    return "chunked" if cfg.implementation == "dense" else cfg.implementation


def _aggregate(query, key, temperature, cfg: LossConfig, clamp_min: float, query_mask):
    return aggregate_crossbatch(
        query, key, temperature, clamp_min=clamp_min, query_mask=query_mask,
        implementation=_implementation(cfg), chunk_size=cfg.chunk_size, compute_diag=False,
        precision=cfg.matmul_precision, volume_dtype=cfg.volume_dtype)


def _ring_aggregate(query, key_local, temperature, cfg: LossConfig, clamp_min: float,
                    query_mask, mesh: Mesh, axis: Axis):
    """(clip_sims (B_l, B), sum of clamp^2 over the rank's rows): the local
    row block by a ring pass of the key shards. At step s a rank holds the
    shard of rank (rank - s) mod n, so column block j comes from step
    (rank - j) mod n. The same values as the all-gather path. One mesh
    axis only (the JAX error on a multi-slice mesh)."""
    if isinstance(axis, tuple):
        raise ValueError(
            "negatives='ring' supports a single mesh axis; use "
            "'all_gather' on multi-slice (tuple-axis) meshes"
        )
    group = _group(mesh, axis)
    n, me = mesh.axis_size(axis), mesh.index(axis)
    buf, blocks, nonneg = key_local, [], []
    for s in range(n):
        if s:
            buf = C.ring_shift(buf, group)
        agg = _aggregate(query, buf, temperature, cfg, clamp_min, query_mask)
        blocks.append(agg.clip_sims)
        nonneg.append(agg.nonneg_sq_sum)
    clip = torch.cat([blocks[(me - j) % n] for j in range(n)], dim=1)
    return clip, torch.stack(nonneg).sum()


def _negatives(query, key, temperature, cfg: LossConfig, clamp_min: float, query_mask,
               mesh: Mesh, axis: Axis):
    if cfg.negatives == "ring":
        return _ring_aggregate(query, key, temperature, cfg, clamp_min, query_mask, mesh, axis)
    if cfg.negatives != "all_gather":
        raise ValueError(f"unknown negatives {cfg.negatives!r}")
    agg = _aggregate(query, C.all_gather(key, _group(mesh, axis)), temperature, cfg, clamp_min,
                     query_mask)
    return agg.clip_sims, agg.nonneg_sq_sum


def _f32(*factors) -> torch.Tensor:
    """The product of the factors in fp32, left to right (jnp.float32(B) *
    B * Na * Nv)."""
    out = torch.tensor(float(factors[0]), dtype=torch.float32)
    for f in factors[1:]:
        out = out * f
    return out


def _av_loss_shard(audio, visual, temperature, cfg: LossConfig, mesh: Mesh,
                   axis: Axis) -> AVLossOut:
    """One rank's AV loss body: audio (B_l, Na, D), visual (B_l, Nv, D)."""
    group = _group(mesh, axis)
    b_l, na, _ = audio.shape
    nv = visual.shape[1]
    b = mesh.axis_size(axis) * b_l
    clip, nonneg = _negatives(audio, visual, temperature, cfg, cfg.av_nonneg_clamp_min, None,
                              mesh, axis)
    contrastive, diag_vals = _distributed_symmetric_infonce(clip, mesh, axis)
    dev = clip.device
    l_nonneg = C.all_reduce(nonneg, group) / _f32(b, b, na, nv).to(dev)
    diag_ts = diag_token_sims(audio, visual, temperature)  # positive pairs are local
    smooth_sum = ((diag_ts[:, 1:, :] - diag_ts[:, :-1, :]) ** 2).sum()
    l_smooth = C.all_reduce(smooth_sum, group) / _f32(b, na - 1, nv).to(dev)
    reg = (cfg.temp_cal_weight * temperature_calibration(temperature, cfg)
           + cfg.av_nonneg_weight * l_nonneg + cfg.smooth_weight * l_smooth)
    stats = _distributed_stats(clip, diag_vals, mesh, axis, "av")
    return AVLossOut(contrastive + reg, contrastive, reg, cfg.smooth_weight * l_smooth, stats)


def _tv_loss_shard(text, visual, text_mask, temperature, cfg: LossConfig, mesh: Mesh,
                   axis: Axis) -> TVLossOut:
    """One rank's TV loss body: text (B_l, Nt, D), visual (B_l, Nv, D),
    text_mask (B_l, Nt)."""
    group = _group(mesh, axis)
    b_l, nt, _ = text.shape
    nv = visual.shape[1]
    b = mesh.axis_size(axis) * b_l
    clip, nonneg = _negatives(text, visual, temperature, cfg, cfg.tv_nonneg_clamp_min,
                              text_mask, mesh, axis)
    contrastive, diag_vals = _distributed_symmetric_infonce(clip, mesh, axis)
    l_nonneg = C.all_reduce(nonneg, group) / _f32(b, b, nt, nv).to(clip.device)
    # patch sparsity: the global batch's mean of the per-pair excess^2.
    sparsity = patch_sparsity(diag_token_sims(text, visual, temperature),
                              cfg.patch_sparsity_threshold)
    l_sparsity = C.all_reduce(sparsity * b_l, group) / b
    reg = cfg.tv_nonneg_weight * l_nonneg + cfg.patch_sparsity_weight * l_sparsity
    stats = _distributed_stats(clip, diag_vals, mesh, axis, "tv")
    return TVLossOut(contrastive + reg, contrastive, reg, stats)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def distributed_av_loss(audio_feats, visual_feats, temperature, cfg: LossConfig, mesh: Mesh,
                        axis: Axis = "data") -> AVLossOut:
    """The global AV loss from this rank's rows of the batch-sharded
    features (the ranks' rows in rank order make the global batch); every
    output replicated. A tuple ``axis`` (a multi-slice mesh) gathers the
    negatives across slices too."""
    return _av_loss_shard(audio_feats, visual_feats, temperature, cfg, mesh, axis)


def distributed_tv_loss(text_feats, visual_feats, text_mask, temperature, cfg: LossConfig,
                        mesh: Mesh, axis: Axis = "data") -> TVLossOut:
    """The global TV loss from this rank's rows (see distributed_av_loss)."""
    return _tv_loss_shard(text_feats, visual_feats, text_mask, temperature, cfg, mesh, axis)
