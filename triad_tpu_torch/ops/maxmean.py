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
int32 (Bq, Bk, Nq) residual for the backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from triad_tpu_torch import kernels

LANE = 128  # the reference's Nk and D granularity (pallas_maxmean.py:453)
MAX_D = 512  # the kernels' widest feature (8 accumulator blocks per warp)


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
    tensor, the forward kernel for a CUDA one (the pairs' partial sums
    added in a fixed order)."""
    if q.device.type == "cpu":
        return maxmean_plain(q, k, temperature, coeff, clamp_min)
    _keep, args, (bq, bk, nq, nk, d) = _kernel_args("maxmean", q, k, temperature, coeff)
    dev = q.device
    clip = torch.empty((bq, bk), dtype=torch.float32, device=dev)
    amax = torch.empty((bq, bk, nq), dtype=torch.int32, device=dev)
    partials = torch.empty((bq * bk, 2), dtype=torch.float32, device=dev)
    kernels.call("maxmean_fwd", *args, clip.data_ptr(), amax.data_ptr(), partials.data_ptr(),
                 bq, bk, nq, nk, d, float(clamp_min), kernels.stream_ptr(clip))
    kernels.LAUNCHES["maxmean"] += 1
    nonneg, tsq = partials.sum(dim=0)
    return clip, nonneg, tsq, amax


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
