"""Faults planted under the timed path, for the checks that ``correct``
catches them (``tests/test_bench_faults.py`` on the CPU; ``calibrate.py``
reads them on the card at the cells' own sizes).

Each is a function of the built step that returns a broken step:

* ``unchanged``: the step computes and then returns its state unchanged
  (the parameters put back as they were);
* ``half_batch``: half of each batch left out, the losses' means taken
  over the rest;
* ``altered_update``: one leaf's update altered where the optimizer
  produces it (doubled, as a fused update that adds its step twice).

A one-chip cell has no exchange between chips to leave out.
"""

from __future__ import annotations

import torch


def unchanged(step):
    def broken(state, av, tv, w_av, w_tv):
        before = [p.detach().clone() for p in state.model.parameters()]
        state, m = step(state, av, tv, w_av, w_tv)
        with torch.no_grad():
            for p, b in zip(state.model.parameters(), before):
                p.copy_(b)
        return state, m

    return broken


def half_batch(step):
    def broken(state, av, tv, w_av, w_tv):
        av = {k: v[: v.shape[0] // 2] for k, v in av.items()}
        tv = {k: v[: v.shape[0] // 2] for k, v in tv.items()}
        return step(state, av, tv, w_av, w_tv)

    return broken


def altered_update(step, leaf: str = "audio_backbone.layers.0.attention.q_proj.weight"):
    def broken(state, av, tv, w_av, w_tv):
        p = dict(state.model.named_parameters())[leaf]
        before = p.detach().clone()
        state, m = step(state, av, tv, w_av, w_tv)
        with torch.no_grad():
            p.add_(p - before)
        return state, m

    return broken


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered_update": altered_update}
