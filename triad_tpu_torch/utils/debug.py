"""Numerical-safety utilities (the port's ``triad_tpu/utils/debug.py``,
on named tensors: a state dict, ``named_parameters()`` or any mapping of
names to tensors).

* ``enable_nan_debugging()`` — ``torch.autograd.set_detect_anomaly``:
  the backward raises at the op that produced a NaN (the counterpart of
  jax_debug_nans; there is no switch for infs).
* ``tree_all_finite(named)`` — one device bool: every floating entry is
  finite, without a host sync.
* ``nonfinite_paths(named)`` — host side: the names of the tensors that
  hold a non-finite value.
* ``skip_nonfinite_updates(named)`` — zero every update when any entry
  is non-finite (skip-bad-step protection; off by default, as in the
  reference).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple, Union

import torch

Named = Union[Mapping[str, torch.Tensor], Iterable[Tuple[str, torch.Tensor]]]


def _items(named: Named) -> List[Tuple[str, torch.Tensor]]:
    return list(named.items()) if isinstance(named, Mapping) else list(named)


def enable_nan_debugging(nans: bool = True, infs: bool = False) -> None:
    if infs:
        raise NotImplementedError(
            "torch has no inf trap: enable_nan_debugging(infs=True) (jax_debug_infs in the "
            "JAX package) is not ported to triad_tpu_torch")
    torch.autograd.set_detect_anomaly(nans)


def tree_all_finite(named: Named) -> torch.Tensor:
    """0-dim bool tensor: every floating entry is finite (stays on the
    device of the tensors)."""
    flags = [torch.isfinite(t.to(torch.float32)).all()
             for _, t in _items(named) if t.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack([f.to(flags[0].device) for f in flags]).all()


def nonfinite_paths(named: Named) -> List[str]:
    """Names of the floating tensors with a non-finite entry."""
    return [name for name, t in _items(named)
            if t.is_floating_point() and not bool(torch.isfinite(t).all())]


def skip_nonfinite_updates(named: Named) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(gated updates, was_finite): every update zeroed when any entry is
    non-finite, so a bad batch skips the step instead of poisoning the
    parameters."""
    items = _items(named)
    ok = tree_all_finite(items)
    return {name: torch.where(ok.to(u.device), u, torch.zeros_like(u)) for name, u in items}, ok
