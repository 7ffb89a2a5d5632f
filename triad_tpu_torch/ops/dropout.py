"""The keep mask of the dropout kernels, and the seeds they take.

The TPU kernels draw their keep bits from the core PRNG
(``triad_tpu/ops/pallas_attention.py:_keep_mask``), which nothing else
can reproduce. The port's three dropout kernels (training attention,
fused MLP, dropout + add + LayerNorm) draw from one counter-based hash
instead, Philox4x32-10, written once in ``csrc/common.cuh``
(``triad::keep_bits``) and once here in torch (:func:`keep_bits`). The
bits are a function of coordinates, not of loop order:

  key     (seed, stream)
  counter (col // 4, row, 0, 0); output word col % 4

so a backward kernel that tiles differently from its forward replays the
same mask, and the plain twin draws the same mask as the kernel on any
device. Streams and coordinates per kernel:

  attention        stream = (b0 + b) * H + h, row = query, col = key
  MLP              stream = 0, row = (b0 + b) * N + t, col = hidden unit
  add + LayerNorm  stream = 0, row = (b0 + b) * N + t, col = channel

where b0 is the global index of the process's first batch row (0 in one
process): a data-parallel rank draws for its rows what one process
draws for the same rows of the global batch.

The keep rule is the JAX one: keep iff bits >= floor(p * 2^32), and a
kept value is multiplied by the fp32 value of 1 / (1 - p).

Each kernel call site takes an int32 seed drawn on the host
(:class:`HostSeeds`), so no seed is ever read back from the card.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def threshold(p: float) -> int:
    """The uint32 keep threshold: keep iff bits >= threshold(p)."""
    return min(int(p * (1 << 32)), (1 << 32) - 1)


def keep_scale(p: float) -> float:
    """1 / (1 - p) as the kernels multiply by it (rounded to fp32)."""
    return float(np.float32(1.0 / (1.0 - p)))


def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) 32-bit halves of m * a for a constant m < 2^32 and an int64
    tensor a of uint32 values, in 16-bit limbs so no int64 product
    overflows (torch has no uint32 multiply)."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    a_hi, a_lo = a >> 16, a & 0xFFFF
    mid = a_hi * m_lo + a_lo * m_hi  # < 2^33
    low = (mid & 0xFFFF) * 65536 + a_lo * m_lo  # < 2^49
    lo = low & _MASK32
    hi = a_hi * m_hi + (mid >> 16) + (low >> 32)
    return hi & _MASK32, lo


def philox4x32_10(c0, c1, k0, k1):
    """Philox4x32-10 of counter (c0, c1, 0, 0) under key (k0, k1): int64
    tensors of uint32 values (broadcast together) -> the four output
    words."""
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0 = torch.as_tensor(k0, dtype=torch.int64, device=c0.device)
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=c0.device)
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_bits(seed: int, stream: Union[int, Sequence[int], torch.Tensor], rows: int,
              cols: int, device=None, row0: int = 0) -> torch.Tensor:
    """The uint32 bits (as int64) at (stream, row0 + row, col): shape (rows,
    cols) for one stream, (S, rows, cols) for S streams."""
    one = isinstance(stream, int)
    s = torch.as_tensor([stream] if one else stream, dtype=torch.int64, device=device)
    s = (s & _MASK32).reshape(-1, 1, 1)
    quads = (cols + 3) // 4
    c0 = torch.arange(quads, dtype=torch.int64, device=device).reshape(1, 1, quads)
    c1 = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device).reshape(1, rows, 1)
    c1 = c1 & _MASK32
    c0, c1 = torch.broadcast_tensors(c0, c1)
    words = philox4x32_10(c0, c1, int(seed) & _MASK32, s)
    bits = torch.stack(words, dim=-1).reshape(s.shape[0], rows, quads * 4)[..., :cols]
    return bits[0] if one else bits


def keep_mask(seed: int, stream, rows: int, cols: int, p: float, device=None,
              row0: int = 0) -> torch.Tensor:
    """Bool keep mask, keep iff bits >= floor(p * 2^32) (all True at p = 0)."""
    if p <= 0.0:
        shape = (rows, cols) if isinstance(stream, int) else (len(stream), rows, cols)
        return torch.ones(shape, dtype=torch.bool, device=device)
    return keep_bits(seed, stream, rows, cols, device, row0) >= threshold(p)


def row_offset(x: torch.Tensor, b0: int) -> int:
    """The first global row of a (B, ..., C) operand whose batch starts at
    global row b0: b0 times the rows of one batch item."""
    return b0 * math.prod(x.shape[1:-1])


def apply_keep(x: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """where(keep, x * fp32(1 / (1 - p)), 0) in x's dtype (identity at p = 0)."""
    if p <= 0.0:
        return x
    return torch.where(keep, x * keep_scale(p), torch.zeros((), dtype=x.dtype, device=x.device))


class HostSeeds:
    """A host stream of random numbers for one training micro step: the
    int32 seed of each kernel call site and the layerdrop draws, each from
    ``np.random.SeedSequence([seed, global_step, site])`` with ``site``
    counting the draws. The same on every data-parallel rank; ``shard``
    (data index, data size) gives each kernel its batch offset
    (:meth:`b0`)."""

    def __init__(self, seed: int, global_step: int, shard: Tuple[int, int] = (0, 1)):
        self.key = (int(seed), int(global_step))
        self.site = 0
        self.shard = shard

    def b0(self, batch: int) -> int:
        """The global index of the first of this rank's ``batch`` rows."""
        return self.shard[0] * batch

    def _words(self, n: int) -> np.ndarray:
        words = np.random.SeedSequence([*self.key, self.site]).generate_state(n)
        self.site += 1
        return words

    def seed(self) -> int:
        """An int32 kernel seed in [0, 2^31 - 1)."""
        return int(self._words(1)[0]) % 0x7FFFFFFF

    def at(self, site: int) -> "HostSeeds":
        """A copy of this stream positioned at ``site``: it draws again what
        this one drew from there."""
        other = HostSeeds(*self.key, shard=self.shard)
        other.site = site
        return other

    def uniform(self) -> float:
        """A float in [0, 1)."""
        hi, lo = (int(w) for w in self._words(2))
        return ((hi >> 5) * 67108864.0 + (lo >> 6)) / 9007199254740992.0


class ShardGenerator(torch.Generator):
    """The plain draws' generator of one data-parallel rank: ``shard`` =
    (data index, data size). :func:`global_rand` and :func:`global_randint`
    draw at the global batch's shape and keep this rank's rows, so each
    rank draws what one process draws for the same global rows, and every
    rank's generator advances alike (a tensor-parallel group's ranks hold
    the same rows and draw the same)."""

    def __new__(cls, device, shard: Tuple[int, int] = (0, 1)):
        gen = super().__new__(cls, device=device)
        gen.shard = shard
        return gen

    def __init__(self, device, shard: Tuple[int, int] = (0, 1)):
        pass


def replay_generator(generator: torch.Generator, state: torch.Tensor) -> torch.Generator:
    """A new generator of ``generator``'s kind, device (and shard) set to
    ``state``: it draws again what ``generator`` drew from that state."""
    if isinstance(generator, ShardGenerator):
        other = ShardGenerator(generator.device, generator.shard)
    else:
        other = torch.Generator(device=generator.device)
    other.set_state(state)
    return other


def _rows(shape, generator, draw, split=None):
    """draw() at the global shape, this rank's part kept: its rows of the
    global batch and, with ``split`` = (dim, index, parts), slice ``index``
    of ``parts`` along ``dim`` (a tensor-parallel rank's heads or hidden
    columns, drawn at their full extent)."""
    rank, world = getattr(generator, "shard", (0, 1))
    shape = list(shape)
    shape[0] *= world
    if split is not None:
        dim, index, parts = split
        n = shape[dim]
        shape[dim] = n * parts
    out = draw(tuple(shape))
    if world > 1:
        out = out.narrow(0, rank * (shape[0] // world), shape[0] // world)
    if split is not None:
        out = out.narrow(dim, index * n, n)
    return out


def global_rand(shape, generator: torch.Generator, device=None, split=None) -> torch.Tensor:
    """torch.rand of a (B, ...) batch's draws, keyed on global rows (and,
    with ``split``, on the full extent of a split dim)."""
    return _rows(shape, generator,
                 lambda s: torch.rand(s, generator=generator, device=device), split)


def global_randint(high: int, shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """torch.randint(0, high) of a (B, ...) batch's draws, keyed on global rows."""
    return _rows(shape, generator,
                 lambda s: torch.randint(0, high, s, generator=generator, device=device))
