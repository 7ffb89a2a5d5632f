"""Every random draw and schedule a training step of the program makes,
re-derived from the run's seed (frozen copies; nothing here imports the
program).

* The kernels' dropout keep bits: Philox4x32-10 of counter (col // 4,
  row, 0, 0) under key (seed, stream), output word col % 4; keep iff
  bits >= floor(p * 2^32), kept values times fp32(1 / (1 - p)).
* The host stream of a micro step (kernel seeds and layerdrop draws):
  ``np.random.SeedSequence([seed, global_step, site])`` with ``site``
  counting the draws.
* The micro step's torch generator: seeded with
  ``SeedSequence([seed, global_step]).generate_state(1, uint64)[0]``
  masked to 63 bits.
* The optimizer's OneCycle learning rate and beta1, and Adam's bias
  corrections (1 - beta^count in fp32).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def threshold(p: float) -> int:
    return min(int(p * (1 << 32)), (1 << 32) - 1)


def keep_scale(p: float) -> float:
    return float(np.float32(1.0 / (1.0 - p)))


def _mulhilo(m: int, a: torch.Tensor):
    m_hi, m_lo = m >> 16, m & 0xFFFF
    a_hi, a_lo = a >> 16, a & 0xFFFF
    mid = a_hi * m_lo + a_lo * m_hi
    low = (mid & 0xFFFF) * 65536 + a_lo * m_lo
    hi = a_hi * m_hi + (mid >> 16) + (low >> 32)
    return hi & _MASK32, low & _MASK32


def _philox(c0, c1, k0: int, k1):
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(seed: int, streams, rows: int, cols: int, p: float, device,
              row0: int = 0) -> torch.Tensor:
    """(S, rows, cols) bool keep mask of the streams ``streams`` (a list of
    ints) at rows row0 .. row0 + rows."""
    s = torch.as_tensor(list(streams), dtype=torch.int64, device=device)
    if p <= 0.0:
        return torch.ones((s.numel(), rows, cols), dtype=torch.bool, device=device)
    k1 = (s & _MASK32).reshape(-1, 1, 1)
    quads = (cols + 3) // 4
    c0 = torch.arange(quads, dtype=torch.int64, device=device).reshape(1, 1, quads)
    c1 = (torch.arange(row0, row0 + rows, dtype=torch.int64, device=device) & _MASK32)
    c0, c1 = torch.broadcast_tensors(c0, c1.reshape(1, rows, 1))
    words = _philox(c0.expand(s.numel(), rows, quads), c1.expand(s.numel(), rows, quads),
                    int(seed) & _MASK32, k1)
    bits = torch.stack(words, dim=-1).reshape(s.numel(), rows, quads * 4)[..., :cols]
    return bits >= threshold(p)


def apply_keep(x: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    if p <= 0.0:
        return x
    return torch.where(keep, x * keep_scale(p), torch.zeros((), dtype=x.dtype, device=x.device))


class HostSeeds:
    """The host stream of one micro step: kernel seeds and layerdrop draws."""

    def __init__(self, seed: int, global_step: int):
        self.key = (int(seed), int(global_step))
        self.site = 0

    def _words(self, n: int) -> np.ndarray:
        words = np.random.SeedSequence([*self.key, self.site]).generate_state(n)
        self.site += 1
        return words

    def seed(self) -> int:
        return int(self._words(1)[0]) % 0x7FFFFFFF

    def uniform(self) -> float:
        hi, lo = (int(w) for w in self._words(2))
        return ((hi >> 5) * 67108864.0 + (lo >> 6)) / 9007199254740992.0


def generator_seed(seed: int, global_step: int) -> int:
    key = np.random.SeedSequence([seed, global_step]).generate_state(1, dtype=np.uint64)[0]
    return int(key) & (2 ** 63 - 1)


def kept_layers(seed: int, global_step: int, num_layers: int, layerdrop: float,
                seeds_per_layer: int):
    """HuBERT's layerdrop at one micro step: the indices of the layers that
    run, drawing ``seeds_per_layer`` kernel seeds in each of them after
    its draw (the host stream's order)."""
    hs = HostSeeds(seed, global_step)
    kept = []
    for i in range(num_layers):
        if layerdrop > 0 and hs.uniform() < layerdrop:
            continue
        kept.append(i)
        for _ in range(seeds_per_layer):
            hs.seed()
    return kept


# ------------------------------------------------------------ optimizer


def _annealing_cos(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def _phases(optim: dict, cycle_steps: int):
    total = max(1, cycle_steps)
    warm_end = max(optim["pct_start"] * total - 1, 1e-8)
    return warm_end, max(total - 1, warm_end + 1e-8)


def _pct(count, warm_end, anneal_end):
    if count <= warm_end:
        return True, min(max(count / warm_end, 0.0), 1.0)
    return False, min(max((count - warm_end) / (anneal_end - warm_end), 0.0), 1.0)


def onecycle_lr(optim: dict, peak_scale: float, cycle_steps: int, count: int) -> float:
    max_lr = optim["learning_rate"] * peak_scale
    initial = max_lr / optim["div_factor"]
    min_lr = initial / optim["final_div_factor"]
    warm, pct = _pct(count, *_phases(optim, cycle_steps))
    return _annealing_cos(initial, max_lr, pct) if warm else _annealing_cos(max_lr, min_lr, pct)


def onecycle_beta1(optim: dict, cycle_steps: int, count: int) -> float:
    if not optim["cycle_momentum"]:
        return optim["b1"]
    base, top = optim["base_momentum"], optim["max_momentum"]
    warm, pct = _pct(count, *_phases(optim, cycle_steps))
    return _annealing_cos(top, base, pct) if warm else _annealing_cos(base, top, pct)


def bias_correction(beta: float, count: int) -> float:
    return float(np.float32(1.0) - np.power(np.float32(beta), np.float32(count)))
