"""The comparison that decides ``correct`` for a training cell.

Both sides give, for the micro steps the check follows: each micro
step's AV and TV loss, each leaf's gradient and its norm as the optimizer
gets it at the first update (clipped; the program's worked out from
Adam's first moment), and each leaf's change after the last update. Four
numbers come of them:

  loss_gap    the largest |program - reference| / |reference| over the
              micro steps' losses
  grad_gap    the largest over leaves of the gap between the two gradient
              norms, over the larger of the reference leaf's norm and the
              median leaf's
  grad_err    the largest over leaves of the norm of the difference of
              the two first gradients themselves, over the larger of the
              reference leaf's norm and the median leaf's: the first update's
              gradient is taken before any update, so rounding is not yet
              amplified, and a wrong direction shows at first order where a
              gap of norms shows it only at second
  change_gap  the same as grad_gap for the norms of the leaves' changes, over the
              leaves whose reference gradient reaches a thousandth of the
              median leaf's at some update (a leaf whose gradient is nought
              to rounding, as a key's bias under softmax, moves by
              round-off alone)

and a steadier one beside them, ``loss_gap_first``: the first micro
step's losses, before any update (Adam's first, sign-like step turns
gradient components that are nought to rounding into steps of the
learning rate either way, so the later losses follow the two sides' own
trajectories). The numbers named in ``limits/<cell>.json`` are held to
their limits; ``PERF.md`` gives the readings each limit was set from.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

NUMBERS = ("loss_gap_first", "loss_gap", "grad_gap", "grad_err", "change_gap")


def _finite(x: float) -> float:
    """NaN reads as infinitely far (a comparison with NaN is always false)."""
    return x if x == x else float("inf")


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names):
    """[(gap, name)] of each leaf: the gap of the two norms over the larger
    of the reference leaf's and the median leaf's."""
    names = list(names)
    if not names:
        return [(float("inf"), "no leaves")]
    floor = statistics.median(ref.get(n, 0.0) for n in names)
    return [(_finite(abs(prog.get(n, 0.0) - ref.get(n, 0.0))
                     / max(ref.get(n, 0.0), floor, 1e-30)), n) for n in names]


def _leaf_errors(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], names):
    """[(error, name)] of each leaf: the norm of the difference of the two
    tensors over the larger of the reference leaf's norm and the median
    leaf's (a leaf a side lacks counts as zeros there)."""
    names = list(names)
    if not names or not ref:
        return [(float("inf"), "no leaves")]

    def norm(t):
        return 0.0 if t is None else float(t.norm())

    norms = {n: norm(ref.get(n)) for n in names}
    floor = statistics.median(norms.values())
    out = []
    for n in names:
        p, r = prog.get(n), ref.get(n)
        diff = norm(p) if r is None else norms[n] if p is None else float((p - r).norm())
        out.append((_finite(diff / max(norms[n], floor, 1e-30)), n))
    return out


def numbers(prog: dict, ref: dict) -> Dict[str, Tuple[float, str]]:
    """{number: (value, where)} of the program's readings against the
    reference's."""
    out = {}
    gaps = []
    for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"])):
        for side, pv, rv in (("av", p[0], r[0]), ("tv", p[1], r[1])):
            gaps.append((_finite(abs(pv - rv) / max(abs(rv), 1e-30)), f"micro step {i} {side}"))
    if len(prog["losses"]) != len(ref["losses"]) or not gaps:
        out["loss_gap"] = (float("inf"), "micro steps differ")
    else:
        out["loss_gap"] = max(gaps)
        out["loss_gap_first"] = max(gaps[:2])
    if "loss_gap_first" not in out:
        out["loss_gap_first"] = out["loss_gap"]
    leaves = sorted(set(ref["trainable"]))
    out["grad_gap"] = max(_leaf_gaps(prog["first_grad"], ref["first_grad"], leaves))
    out["grad_err"] = max(_leaf_errors(prog["first_grads"], ref["first_grads"], leaves))
    gmax = ref["grad_max"]
    floor = statistics.median(gmax.get(n, 0.0) for n in leaves) if leaves else 0.0
    moving = [n for n in leaves if gmax.get(n, 0.0) >= 1e-3 * floor]
    out["change_gap"] = max(_leaf_gaps(prog["change"], ref["change"], moving))
    return {k: out[k] for k in NUMBERS}


def judge(nums: Dict[str, Tuple[float, str]], limits: Dict[str, float]) -> Tuple[bool, List[str]]:
    """(correct, lines): each number that has a limit beside it."""
    ok, lines = True, []
    for k in (k for k in NUMBERS if k in limits):
        v, where = nums[k]
        good = v <= limits[k]
        ok &= good
        lines.append(f"{k} {v:.6g} limit {limits[k]:.6g} ({where}){'' if good else ' FAILED'}")
    return ok, lines
