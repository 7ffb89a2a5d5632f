"""Cross-batch max-mean aggregation through the max-mean kernels (mirrors
``triad_tpu/ops/pallas_maxmean.py``): ``maxmean_aggregate`` is
``aggregate_crossbatch(implementation="pallas")``'s clip sims and
non-negativity sum.

For query clip i, key clip j: ts = <q_ia, k_jv> * T, clip[i, j] = sum_a
coeff[i, a] * max_v ts, nonneg = sum clamp(ts, clamp_min, 0)^2 over the
whole (Bq, Bk, Nq, Nk) volume; coeff is 1/Nq, or mask/count with a query
mask. The backward recomputes ts and routes the max's gradient to the
FIRST argmax over keys (the TPU kernel's rule, ``pallas_maxmean.py:18-21``),
adds 2 ts g_nonneg inside the open window (clamp_min, 0), and gets dT
from the forward's sums with no extra pass (``_maxmean_bwd`` :413-428).
The first-argmax routing is this aggregation's, not ``chunked_vjp``'s,
which splits ties evenly as the XLA path does (``ops/similarity.py``).

A CUDA tensor runs ``csrc/maxmean.cu`` (a forward, a dQ and a dK kernel;
``maxmean_fwd``, ``maxmean_dq``, ``maxmean_dk``); a CPU tensor runs the
plain twins (``maxmean_plain``, ``maxmean_dq_plain``, ``maxmean_dk_plain``),
which route to the first argmax too. The forward keeps every query row's first argmax as an
int32 (Bq, Bk, Nq) residual for the backward. ``maxmean_fwd_tiled_plain``,
``maxmean_dq_tiled_plain`` and ``maxmean_dk_tiled_plain`` walk the kernels'
tiles in their order (for tests; nothing on the main path calls them).
"""

from __future__ import annotations

from typing import Optional

import torch

from triad_tpu_torch import kernels

LANE = 128  # the reference's Nk and D granularity (pallas_maxmean.py:453)
MAX_D = 512  # the kernels' widest feature


def coefficients(bq: int, nq: int, query_mask: Optional[torch.Tensor], device) -> torch.Tensor:
    """The (Bq, Nq) fp32 query weights: 1/Nq, or mask / max(count, 1e-7)."""
    if query_mask is None:
        return torch.full((bq, nq), 1.0 / nq, dtype=torch.float32, device=device)
    m = query_mask.to(device=device, dtype=torch.float32)
    return m / m.sum(dim=1, keepdim=True).clamp(min=1e-7)


def _key_chunk(bq: int, bk: int, nq: int, nk: int) -> int:
    """Key clips per chunk of the plain twins: about 2^26 sims at a time."""
    return max(1, min(bk, (1 << 26) // max(bq * nq * nk, 1)))


def _ts(qf, kf, temp):
    return torch.einsum("iqd,jkd->ijqk", qf, kf) * temp


def maxmean_plain(q, k, temperature, coeff, clamp_min: float):
    """The forward in fp32 (q, k of any float dtype, products in fp32):
    (clip (Bq, Bk), nonneg (), tsq (), amax (Bq, Bk, Nq) int32), with tsq
    the sum of ts^2 inside the open window and amax the first argmax over
    keys."""
    f32 = torch.float32
    qf, kf, t = q.to(f32), k.to(f32), temperature.to(f32)
    bq, nq, _ = q.shape
    bk, nk, _ = k.shape
    chunk = _key_chunk(bq, bk, nq, nk)
    clips, amaxes = [], []
    nonneg = torch.zeros((), dtype=f32, device=q.device)
    tsq = torch.zeros((), dtype=f32, device=q.device)
    for j0 in range(0, bk, chunk):
        ts = _ts(qf, kf[j0:j0 + chunk], t)
        arg = ts.argmax(dim=3)  # the first maximal key
        clips.append((ts.gather(3, arg[..., None])[..., 0] * coeff[:, None, :]).sum(dim=-1))
        amaxes.append(arg.to(torch.int32))
        clamped = ts.clamp(clamp_min, 0.0)
        nonneg = nonneg + (clamped * clamped).sum()
        active = (ts > clamp_min) & (ts < 0.0)
        tsq = tsq + torch.where(active, ts * ts, torch.zeros((), dtype=f32, device=ts.device)).sum()
    return torch.cat(clips, dim=1), nonneg, tsq, torch.cat(amaxes, dim=1)


def _dts_chunks(q, k, temperature, coeff, clamp_min: float, amax, g_clip, g_nn):
    """(fp32 K of the chunk, dts) per chunk of key clips: dts = (onehot(amax)
    g_clip coeff + window 2 ts g_nn) T, as _dts_for_pair (:195) computes it."""
    f32 = torch.float32
    qf, kf, t = q.to(f32), k.to(f32), temperature.to(f32)
    g_clip, g_nn = g_clip.to(f32), g_nn.to(f32)
    bq, nq, _ = q.shape
    bk, nk, _ = k.shape
    chunk = _key_chunk(bq, bk, nq, nk)
    keys = torch.arange(nk, device=q.device)
    zero = torch.zeros((), dtype=f32, device=q.device)
    for j0 in range(0, bk, chunk):
        kc = kf[j0:j0 + chunk]
        ts = _ts(qf, kc, t)
        onehot = keys == amax[:, j0:j0 + chunk, :, None].long()
        g_max = g_clip[:, j0:j0 + chunk, None] * coeff[:, None, :]
        active = (ts > clamp_min) & (ts < 0.0)
        dts = torch.where(onehot, g_max[..., None], zero) + torch.where(active, 2.0 * ts * g_nn,
                                                                        zero)
        yield kc, dts * t


def maxmean_dq_plain(q, k, temperature, coeff, clamp_min: float, amax, g_clip, g_nn):
    """dq (Bq, Nq, D) fp32 = sum_j dts K_j, written out (not autograd)."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for kc, dts in _dts_chunks(q, k, temperature, coeff, clamp_min, amax, g_clip, g_nn):
        dq = dq + torch.einsum("ijqk,jkd->iqd", dts, kc)
    return dq


def maxmean_dk_plain(q, k, temperature, coeff, clamp_min: float, amax, g_clip, g_nn):
    """dk (Bk, Nk, D) fp32 = sum_i dts^T Q_i, written out (not autograd)."""
    qf = q.to(torch.float32)
    return torch.cat([torch.einsum("ijqk,iqd->jkd", dts, qf) for _, dts in
                      _dts_chunks(q, k, temperature, coeff, clamp_min, amax, g_clip, g_nn)])


# ---------------------------------------------------------------------------
# The backward kernels' order (csrc/maxmean.cu), for tests
# ---------------------------------------------------------------------------

ROWS = 64  # rows of a backward kernel's resident tile (BW_ROWS)


def stream_rows(split: bool) -> int:
    """Rows of a backward kernel's streamed tile (stream_rows): 64, or 32
    for split fp32 features."""
    return 32 if split else 64


def chunks_per_half(d: int) -> int:
    """The 64-column chunks of D each consumer warpgroup owns
    (chunks_per_half); D is padded with zero chunks to twice that."""
    return 1 if d <= 128 else 2 if d <= 256 else 4


def _tiled_halves(x: torch.Tensor, rows: int):
    """(hi, lo) of x as fp32 values, rows padded with zeros to a multiple
    of ``rows`` and D with zero chunks (lo zero for bf16 features)."""
    hi, lo = _halves(x)
    n, d = x.shape[1], x.shape[2]
    pad = (0, 128 * chunks_per_half(d) - d, 0, -n % rows)
    hi = torch.nn.functional.pad(hi.to(torch.float32), pad)
    lo = torch.zeros_like(hi) if lo is None else torch.nn.functional.pad(lo.to(torch.float32), pad)
    return hi, lo


def _tiled_sims(r_hi, r_lo, t_hi, t_lo):
    """A tile's sims as the kernels sum them, over all of D: hh + lh +
    hl."""
    return (r_hi @ t_hi.transpose(-1, -2) + r_lo @ t_hi.transpose(-1, -2)
            + r_hi @ t_lo.transpose(-1, -2))


def _tiled_dts(s, is_max, g_max, temp, g_nn, clamp_min: float):
    """dts of a tile (dts_of), rounded to bf16 hi and lo halves (fp32
    values)."""
    ts = s * temp
    zero = torch.zeros((), dtype=torch.float32)
    v = torch.where(is_max, g_max, zero)
    v = v + torch.where((ts > clamp_min) & (ts < 0.0), 2.0 * ts * g_nn, zero)
    v = v * temp
    hi = v.to(torch.bfloat16).to(torch.float32)
    return hi, (v - hi).to(torch.bfloat16).to(torch.float32)


def _tiled_scalars(coeff, amax, g_clip, nq_pad):
    """amax (-1 past Nq) and g_clip coeff (0 past Nq), (Bq, Bk, nq_pad)."""
    nq = coeff.shape[1]
    am = torch.nn.functional.pad(amax.to(torch.int64), (0, nq_pad - nq), value=-1)
    g = torch.nn.functional.pad(g_clip.to(torch.float32)[:, :, None]
                                * coeff.to(torch.float32)[:, None, :], (0, nq_pad - nq))
    return am, g


def maxmean_dq_tiled_plain(q, k, temperature, coeff, clamp_min: float, amax, g_clip, g_nn):
    """dq in the dQ kernel's order, on CPU tensors: for every 64-row tile
    of every query clip (all at once), the key tiles of clip 0, 1, ... in
    order; per tile the sims over all of D, dts rounded to bf16 hi + lo,
    and dq += hi K + lo K (+ hi K_lo for fp32 features) in fp32.
    Uses nothing of the main path."""
    split = q.dtype == torch.float32
    kt = stream_rows(split)
    qh, ql = _tiled_halves(q, ROWS)
    kh, kl = _tiled_halves(k, kt)
    temp = temperature.to(torch.float32)
    g_nn = g_nn.to(torch.float32)
    am, g = _tiled_scalars(coeff, amax, g_clip, qh.shape[1])
    acc = torch.zeros_like(qh)
    for j in range(k.shape[0]):
        for k0 in range(0, k.shape[1], kt):
            th, tl = kh[j, k0:k0 + kt], kl[j, k0:k0 + kt]
            s = _tiled_sims(qh, ql, th, tl)  # (Bq, rows, kt)
            is_max = am[:, j, :, None] == torch.arange(k0, k0 + kt)
            hi, lo = _tiled_dts(s, is_max, g[:, j, :, None], temp, g_nn, clamp_min)
            acc = acc + (hi @ th + lo @ th + hi @ tl)
    return acc[:, :q.shape[1], :q.shape[2]]


def maxmean_dk_tiled_plain(q, k, temperature, coeff, clamp_min: float, amax, g_clip, g_nn):
    """dk in the dK kernel's order, on CPU tensors: for every 64-key tile
    of every key clip (all at once), the query tiles of clip 0, 1, ... in
    order (rows past Nq zero); per tile the sims S^T over all of D, dts^T
    rounded to bf16 hi + lo, and dk += hi Q + lo Q (+ hi Q_lo) in fp32.
    Uses nothing of the main path."""
    split = q.dtype == torch.float32
    kt = stream_rows(split)
    qh, ql = _tiled_halves(q, kt)
    kh, kl = _tiled_halves(k, ROWS)
    temp = temperature.to(torch.float32)
    g_nn = g_nn.to(torch.float32)
    am, g = _tiled_scalars(coeff, amax, g_clip, qh.shape[1])
    keys = torch.arange(k.shape[1])[None, :, None]
    acc = torch.zeros_like(kh)
    for i in range(q.shape[0]):
        for q0 in range(0, qh.shape[1], kt):
            th, tl = qh[i, q0:q0 + kt], ql[i, q0:q0 + kt]
            s = _tiled_sims(kh, kl, th, tl)  # (Bk, Nk, kt)
            is_max = am[i, :, None, q0:q0 + kt] == keys
            hi, lo = _tiled_dts(s, is_max, g[i, :, None, q0:q0 + kt], temp, g_nn, clamp_min)
            acc = acc + (hi @ th + lo @ th + hi @ tl)
    return acc[:, :, :k.shape[2]]


FWD_KEYS = 128  # keys of a forward sim tile (FW_KEYS)


def maxmean_fwd_tiled_plain(q, k, temperature, coeff, clamp_min: float):
    """(clip, nonneg, tsq, amax) in the forward kernel's order, on CPU
    tensors: for every 64-row query tile of every clip (all at once; rows
    past Nq zero), the key clips in order, their 128-key tiles in order
    (keys past Nk zero, and out of the max); per tile the sims over all of
    D (hh + lh + hl), the rows' running max (an earlier tile keeps a tie,
    and within a tile the first key) and the tile's clamp^2 and window
    ts^2 sums; per (tile, i, j) one partial of each, the clip partial the
    sum of coeff max over the tile's rows; then, as maxmean_fwd adds
    them, the partials summed over the tiles, nonneg and tsq then over
    the pairs. The kernel's ranges of key clips (grid.y) change none of
    this: each (tile, i, j) is one warpgroup's. Uses nothing of the main
    path."""
    f32 = torch.float32
    bq, nq, _ = q.shape
    bk, nk, _ = k.shape
    qh, ql = _tiled_halves(q, ROWS)
    kh, kl = _tiled_halves(k, FWD_KEYS)
    ntq = qh.shape[1] // ROWS
    temp = temperature.to(f32)
    cf = torch.nn.functional.pad(coeff.to(f32), (0, ntq * ROWS - nq))
    part = torch.zeros((ntq, bq, bk, 3), dtype=f32)
    amax = torch.zeros((bq, bk, nq), dtype=torch.int32)
    for j in range(bk):
        best = torch.full((bq, ntq * ROWS), float("-inf"))
        arg = torch.zeros((bq, ntq * ROWS), dtype=torch.int64)
        nn = torch.zeros((bq, ntq))
        tsq = torch.zeros((bq, ntq))
        for k0 in range(0, nk, FWD_KEYS):
            ts = _tiled_sims(qh, ql, kh[j, k0:k0 + FWD_KEYS], kl[j, k0:k0 + FWD_KEYS]) * temp
            c = ts.clamp(clamp_min, 0.0)
            window = (ts > clamp_min) & (ts < 0.0)
            nn = nn + (c * c).reshape(bq, ntq, -1).sum(-1)
            tsq = tsq + torch.where(window, ts * ts, 0.0).reshape(bq, ntq, -1).sum(-1)
            ts = ts.masked_fill(torch.arange(k0, k0 + FWD_KEYS) >= nk, float("-inf"))
            tile_arg = ts.argmax(dim=2)  # the first maximal key of the tile
            tile_max = ts.gather(2, tile_arg[..., None])[..., 0]
            take = tile_max > best
            best = torch.where(take, tile_max, best)
            arg = torch.where(take, tile_arg + k0, arg)
        amax[:, j] = arg[:, :nq].to(torch.int32)
        part[:, :, j, 0] = (cf * best).reshape(bq, ntq, ROWS).sum(-1).T
        part[:, :, j, 1] = nn.T
        part[:, :, j, 2] = tsq.T
    summed = part.sum(dim=0)
    nonneg, tsq = summed[..., 1:].sum(dim=(0, 1))
    return summed[..., 0], nonneg, tsq, amax


# ---------------------------------------------------------------------------
# The kernels (csrc/maxmean.cu)
# ---------------------------------------------------------------------------


def _halves(x: torch.Tensor):
    """(hi, lo) bf16 operands: a bf16 tensor is its own hi (lo None); an
    fp32 one splits into hi = bf16(x) and lo = bf16(x - hi)."""
    x = x.contiguous()
    if x.dtype == torch.bfloat16:
        return x, None
    if x.dtype != torch.float32:
        raise TypeError(f"maxmean: the CUDA kernels take bf16 or fp32, got {x.dtype}")
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(torch.float32)).to(torch.bfloat16)


def _kernel_args(name, q, k, temperature, coeff):
    """The leading C arguments: the halves of q and k, coeff, and the
    temperature as an fp32 device scalar (never read back to the host)."""
    kernels.require_cuda(name, q, k, coeff)
    bq, nq, d = q.shape
    bk, nk, dk = k.shape
    if dk != d or nk % 64 or d % 64 or d > MAX_D:
        raise ValueError(f"{name}: the kernels take Nk a multiple of 64 and D a multiple of 64 "
                         f"up to {MAX_D}, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q.dtype != k.dtype:
        raise TypeError(f"{name}: q {q.dtype} and k {k.dtype}")
    qh, ql = _halves(q)
    kh, kl = _halves(k)
    temp = temperature.to(device=q.device, dtype=torch.float32).reshape(1).contiguous()
    coeff = coeff.to(torch.float32).contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    keep = (qh, ql, kh, kl, temp, coeff)  # alive until the launch is queued
    return keep, [ptr(qh), ptr(ql), ptr(kh), ptr(kl), coeff.data_ptr(), temp.data_ptr()], (
        bq, bk, nq, nk, d)


def maxmean_fwd(q, k, temperature, coeff, clamp_min: float):
    """(clip, nonneg, tsq, amax) as maxmean_plain: the twin for a CPU
    tensor, the forward kernel for a CUDA one. The kernel writes amax and
    one partial of each sum per (64-row query tile, pair); they are added
    here, over the tiles, then nonneg and tsq over the pairs: torch's
    reductions, a fixed order (no atomics), so runs repeat bit for bit.
    The kernel leaves its clip argument unwritten."""
    if q.device.type == "cpu":
        return maxmean_plain(q, k, temperature, coeff, clamp_min)
    _keep, args, (bq, bk, nq, nk, d) = _kernel_args("maxmean", q, k, temperature, coeff)
    dev = q.device
    amax = torch.empty((bq, bk, nq), dtype=torch.int32, device=dev)
    partials = torch.empty((-(-nq // ROWS), bq, bk, 3), dtype=torch.float32, device=dev)
    kernels.call("maxmean_fwd", *args, None, amax.data_ptr(), partials.data_ptr(),
                 bq, bk, nq, nk, d, float(clamp_min), kernels.stream_ptr(amax))
    kernels.LAUNCHES["maxmean"] += 1
    summed = partials.sum(dim=0)
    nonneg, tsq = summed[..., 1:].sum(dim=(0, 1))
    return summed[..., 0], nonneg, tsq, amax


def _bwd_kernel(name, q, k, temperature, coeff, clamp_min, amax, g_clip, g_nn, out_shape):
    _keep, args, (bq, bk, nq, nk, d) = _kernel_args(name, q, k, temperature, coeff)
    g_clip = g_clip.to(torch.float32).contiguous()
    g_nn = g_nn.to(device=q.device, dtype=torch.float32).reshape(1).contiguous()
    amax = amax.to(torch.int32).contiguous()
    out = torch.empty(out_shape, dtype=torch.float32, device=q.device)
    kernels.call(name, *args, g_clip.data_ptr(), g_nn.data_ptr(), amax.data_ptr(),
                 out.data_ptr(), bq, bk, nq, nk, d, float(clamp_min), kernels.stream_ptr(out))
    kernels.LAUNCHES[name] += 1
    return out


def maxmean_dq(q, k, temperature, coeff, clamp_min: float, amax, g_clip, g_nn):
    """dq (Bq, Nq, D) fp32 from the dQ kernel (CUDA tensors only)."""
    return _bwd_kernel("maxmean_dq", q, k, temperature, coeff, clamp_min, amax, g_clip, g_nn,
                       q.shape)


def maxmean_dk(q, k, temperature, coeff, clamp_min: float, amax, g_clip, g_nn):
    """dk (Bk, Nk, D) fp32 from the dK kernel (CUDA tensors only)."""
    return _bwd_kernel("maxmean_dk", q, k, temperature, coeff, clamp_min, amax, g_clip, g_nn,
                       k.shape)


def maxmean_bwd(q, k, temperature, coeff, clamp_min: float, amax, g_clip, g_nn):
    """(dq, dk) fp32: the twins for a CPU tensor, the dQ and dK kernels for
    a CUDA one."""
    args = (q, k, temperature, coeff, clamp_min, amax, g_clip, g_nn)
    if q.device.type == "cpu":
        return maxmean_dq_plain(*args), maxmean_dk_plain(*args)
    return maxmean_dq(*args), maxmean_dk(*args)


class MaxMeanKernel(torch.autograd.Function):
    """pallas_maxmean._maxmean's custom VJP: forward (clip, nonneg); the
    backward recomputes ts (no volume is kept, only the int32 argmax) and
    returns dq, dk and dT = sum g_clip clip / T + g_nonneg 2 tsq / T."""

    @staticmethod
    def forward(ctx, q, k, temperature, coeff, clamp_min):
        clip, nonneg, tsq, amax = maxmean_fwd(q, k, temperature, coeff, clamp_min)
        ctx.save_for_backward(q, k, temperature, coeff, clip, tsq, amax)
        ctx.clamp_min = clamp_min
        return clip, nonneg

    @staticmethod
    def backward(ctx, g_clip, g_nn):
        q, k, temperature, coeff, clip, tsq, amax = ctx.saved_tensors
        f32 = torch.float32
        if g_clip is None:
            g_clip = torch.zeros_like(clip)
        if g_nn is None:
            g_nn = torch.zeros((), dtype=f32, device=clip.device)
        dq, dk = maxmean_bwd(q, k, temperature, coeff, ctx.clamp_min, amax, g_clip, g_nn)
        temp = temperature.to(f32)
        dtemp = (g_clip.to(f32) * clip).sum() / temp + g_nn.to(f32) * 2.0 * tsq / temp
        return (dq.to(q.dtype), dk.to(k.dtype), dtemp.to(temperature.dtype).reshape(
            temperature.shape), None, None)


def maxmean_aggregate(query, key, temperature, clamp_min: float,
                      query_mask: Optional[torch.Tensor] = None):
    """(clip_sims (Bq, Bk) fp32, nonneg_sq_sum () fp32) of
    maxmean_aggregate_pallas: query (Bq, Nq, D) of any Nq, key (Bk, Nk, D)
    with Nk and D multiples of 128, cast to the query's dtype."""
    bq, nq, d = query.shape
    nk = key.shape[1]
    if nk % LANE or d % LANE:
        raise ValueError(f"Nk ({nk}) and D ({d}) must be multiples of {LANE}")
    if key.dtype != query.dtype:
        key = key.to(query.dtype)
    coeff = coefficients(bq, nq, query_mask, query.device)
    return MaxMeanKernel.apply(query, key, temperature, coeff, float(clamp_min))
