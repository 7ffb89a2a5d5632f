"""Four-group optimizer bank with staged unfreezing and delayed OneCycle
(mirrors ``triad_tpu/train/optim.py``, which reproduces the reference
trainer's torch AdamW + OneCycleLR(cycle_momentum=True) bank):

* groups by state-dict name: "audio" (HuBERT backbone), "text"
  (DistilBERT backbone), "vit_lora" (the ViT's LoRA factors),
  "vit_frozen" (the ViT base, never optimized) and "others" (projection
  heads and temperature, trained from step 0);
* one :class:`Adam` per group (decoupled weight decay, moments stored in
  ``mu_dtype`` / ``nu_dtype``) at the group's OneCycle cosine
  schedule (per-group peak scale, cycle shortened by the group's unfreeze
  step; vit_lora trains from step 0 on its shortened cycle), beta1
  cycled 0.95 -> 0.85 -> 0.95 along it;
* unfreeze gates compared with the *micro* step: before its step a
  backbone has ``requires_grad`` False and its AdamW never steps, so its
  moments start fresh at unfreeze, while the schedules advance per update;
* global-norm 10.0 clipping over audio_* and over text_*, after gating.

Data-parallel (``mesh``): the micro steps accumulate each rank's share in
``.grad``; ``all_reduce_grads`` sums it over the data axes once per update
window, before the group norms and the clip, which so see the full
gradients, as in JAX. With ``zero1`` (``parallel/zero.py``) each AdamW
holds and updates only this rank's slice of each large parameter, and
the slices are all-gathered back after the step. ``counts`` and the
schedules stay on the host, alike on every rank.

Sharded parameters (``param_specs``: tensor parallelism, FSDP): each rank
holds and steps its slice. A TP slice's gradient, like a replicated
parameter's, is summed over the data axes; an FSDP slice's arrives summed
over 'data' (its gather's backward) and is summed over the other data
axes ('replica'). The group norms and the clip sum each element's square
once: a rank counts a leaf's squares only where its coordinates on the
axes the leaf is not sharded over are 0, and one all-reduce sums them.

The schedule is set on each param group before each step rather than
through ``OneCycleLR``: the JAX bank clamps at the cycle's end and for
cycles shorter than one warm-up step, where ``OneCycleLR`` raises or
takes another phase. Groups that are on step with zero gradients where
nothing reached a parameter, as the JAX bank's zero-filled tree does.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn as nn

from triad_tpu_torch.config import OptimConfig
from triad_tpu_torch.parallel import collectives as C
from triad_tpu_torch.parallel.dp import _names

GROUPS = ("others", "audio", "text", "vit_lora")
FROZEN_GROUP = "vit_frozen"
_CLIP_SUBTREES = (("audio_backbone", "audio_projection"), ("text_backbone", "text_projection"))


def label_for_path(name: str) -> str:
    """Group label of a TriadModel state-dict name."""
    if name.startswith("audio_backbone"):
        return "audio"
    if name.startswith("text_backbone"):
        return "text"
    if name.startswith("visual_backbone"):
        return "vit_lora" if "lora" in name.rsplit(".", 1)[-1] else FROZEN_GROUP
    return "others"


def _annealing_cos(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def _phases(cfg: OptimConfig, cycle_steps: int):
    total = max(1, cycle_steps)
    warm_end = max(cfg.pct_start * total - 1, 1e-8)
    return warm_end, max(total - 1, warm_end + 1e-8)


def onecycle(cfg: OptimConfig, peak_scale: float, cycle_steps: int) -> Callable[[int], float]:
    """OneCycleLR's cosine lr (milestones pct * total - 1 and total - 1),
    clamped at its minimum past the cycle's end."""
    max_lr = cfg.learning_rate * peak_scale
    initial = max_lr / cfg.div_factor
    min_lr = initial / cfg.final_div_factor
    warm_end, anneal_end = _phases(cfg, cycle_steps)

    def schedule(count: int) -> float:
        if count <= warm_end:
            return _annealing_cos(initial, max_lr, min(max(count / warm_end, 0.0), 1.0))
        pct = min(max((count - warm_end) / (anneal_end - warm_end), 0.0), 1.0)
        return _annealing_cos(max_lr, min_lr, pct)

    return schedule


def onecycle_momentum(cfg: OptimConfig, cycle_steps: int) -> Callable[[int], float]:
    """OneCycleLR's beta1: max_momentum -> base_momentum over the warm-up,
    back to max_momentum over the anneal."""
    warm_end, anneal_end = _phases(cfg, cycle_steps)
    base, top = cfg.base_momentum, cfg.max_momentum

    def schedule(count: int) -> float:
        if count <= warm_end:
            return _annealing_cos(top, base, min(max(count / warm_end, 0.0), 1.0))
        pct = min(max((count - warm_end) / (anneal_end - warm_end), 0.0), 1.0)
        return _annealing_cos(base, top, pct)

    return schedule


def _f32(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    """fp32 views of a list: the tensors themselves where they are fp32
    (so in-place updates reach them), fp32 copies elsewhere."""
    return [t if t.dtype == torch.float32 else t.to(torch.float32) for t in ts]


def _bias_correction(beta: float, steps: List[float]) -> List[float]:
    """1 - beta^count for each parameter's count, in fp32 as JAX forms it."""
    one, b = np.float32(1.0), np.float32(beta)
    return [float(one - np.power(b, np.float32(c))) for c in steps]


class Adam(torch.optim.Optimizer):
    """Adam with decoupled weight decay whose moments are stored in their
    own dtypes: the bank's optimizer for every moment dtype (fp32 and bf16
    alike take this path). ``torch.optim.AdamW`` keeps its moments in the
    parameter's dtype, so it cannot hold bf16 moments of fp32 parameters.

    ``cycled`` (the default route, ``scale_by_cycled_adam`` then
    ``cycled_adamw``'s decay and -lr, optim.py:180-247): in fp32,
    m = b1 m + (1 - b1) g stored in ``mu_dtype``, v = b2 v + (1 - b2) g^2
    stored in ``nu_dtype``, and the update is taken from the stored,
    rounded moments. Otherwise ``optax.adamw(mu_dtype=...)``'s
    ``scale_by_adam`` (optim.py:395-410): v stays fp32 whatever
    ``nu_dtype``, m = (1 - b1) g + b1 m in fp32 with b1 rounded to
    ``mu_dtype`` (optax's decay is a weakly typed float, so b1 m is a
    ``mu_dtype`` product, whose excess precision XLA keeps under jit: the
    product itself is not rounded), the update is taken from the unrounded
    fp32 m, and m is cast to ``mu_dtype`` for storage only. Both then step
    p += -lr ((m / bc1) / (sqrt(v / bc2) + eps) + weight_decay p), with
    bc = 1 - beta^count in fp32.

    The state keys are torch AdamW's ("exp_avg", "exp_avg_sq", "step", a
    CPU fp32 count), so ZeRO-1's views, the checkpoints and their restores
    read it as before; ``load_state_dict`` puts the moments back in the
    configured dtypes (``Optimizer.load_state_dict`` casts every floating
    state to its parameter's dtype)."""

    def __init__(self, params, lr: float, betas, eps: float, weight_decay: float,
                 mu_dtype=torch.float32, nu_dtype=torch.float32, cycled: bool = True):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype, self.cycled = mu_dtype, cycled
        self.nu_dtype = nu_dtype if cycled else torch.float32

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for key, dtype in (("exp_avg", self.mu_dtype), ("exp_avg_sq", self.nu_dtype)):
                if key in st:
                    st[key] = st[key].to(dtype)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if ps:
                self._step_group(group, ps)

    def _step_group(self, group, ps: List[torch.Tensor]) -> None:
        lr, (b1, b2), eps, wd = group["lr"], group["betas"], group["eps"], group["weight_decay"]
        states = [self.state[p] for p in ps]
        for p, st in zip(ps, states):
            if not st:
                st["step"] = torch.tensor(0.0, dtype=torch.float32)
                st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                st["exp_avg_sq"] = torch.zeros_like(p, dtype=self.nu_dtype)
            st["step"] += 1
        steps = [float(st["step"]) for st in states]
        g = _f32([p.grad for p in ps])
        ms = [st["exp_avg"] for st in states]
        vs = [st["exp_avg_sq"] for st in states]
        # the second moment: b2 v + (1 - b2) g^2 in fp32, stored in its dtype
        v = _f32(vs)
        gg = torch._foreach_mul(g, g)
        torch._foreach_mul_(gg, 1.0 - b2)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, gg)
        del gg
        _store(vs, v)
        # the first moment
        low = self.mu_dtype != torch.float32
        if self.cycled or not low:
            m = _f32(ms)
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
        else:  # optax: (1 - b1) g plus b1 m, b1 rounded to mu_dtype, in fp32
            m = torch._foreach_mul(g, 1.0 - b1)
            b1m = _f32(ms)
            torch._foreach_mul_(b1m, float(torch.tensor(b1, dtype=self.mu_dtype)))
            torch._foreach_add_(m, b1m)
            del b1m
        _store(ms, m)
        if self.cycled:  # the update reads the stored moments
            m, v = _f32(ms), _f32(vs)
        u = torch._foreach_div(v, _bias_correction(b2, steps))
        torch._foreach_sqrt_(u)
        torch._foreach_add_(u, eps)
        mh = torch._foreach_div(m, _bias_correction(b1, steps))
        torch._foreach_div_(mh, u)
        del u, m, v
        if wd:
            torch._foreach_add_(mh, torch._foreach_mul(ps, wd))
        torch._foreach_mul_(mh, -lr)
        torch._foreach_add_(ps, mh)


def _store(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    """Write fp32 values into the stored moments, rounding to their dtype
    (nothing to do where they are the same tensors)."""
    for d, s in zip(dst, src):
        if d is not s:
            d.copy_(s)


def _sumsq(grads: List[torch.Tensor], device) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=device)
    for g in grads:
        total = total + g.to(torch.float32).square().sum()
    return total


def _norm(grads: List[torch.Tensor], device) -> torch.Tensor:
    return _sumsq(grads, device).sqrt()


_MOMENTS = ("exp_avg", "exp_avg_sq")


class OptimizerBank:
    """4x AdamW with per-group delayed OneCycle schedules over a model's
    parameters (grouped by ``label_for_path``). ``mesh``: a data-parallel
    run's mesh (``parallel/dp.py``); ``zero1`` shards the moments over
    ``mesh_axis``; ``param_specs`` ({name: spec}, ``parallel/tp.py``) lays
    out the model's parameters, which are this rank's slices already."""

    def __init__(self, cfg: OptimConfig, model: nn.Module, total_updates: int, mesh=None,
                 mesh_axis="data", zero1: bool = False, param_specs=None):
        self.cfg, self.model = cfg, model
        self.named = list(model.named_parameters())
        self.device = self.named[0][1].device
        self.groups: Dict[str, List[nn.Parameter]] = {g: [] for g in GROUPS + (FROZEN_GROUP,)}
        self.names: Dict[str, List[str]] = {g: [] for g in self.groups}
        for name, p in self.named:
            self.groups[label_for_path(name)].append(p)
            self.names[label_for_path(name)].append(name)
        cycles = {
            "others": total_updates,
            "audio": total_updates - cfg.unfreeze_audio_step,
            "text": total_updates - cfg.unfreeze_text_step,
            "vit_lora": total_updates - cfg.unfreeze_vit_step,
        }
        scales = {"others": cfg.lr_scale_others, "audio": cfg.lr_scale_audio,
                  "text": cfg.lr_scale_text, "vit_lora": cfg.lr_scale_vit_lora}
        self.schedules = {g: onecycle(cfg, scales[g], cycles[g]) for g in GROUPS}
        self.momentum = {g: onecycle_momentum(cfg, cycles[g]) for g in GROUPS}
        self.mesh, self.mesh_axis = mesh, mesh_axis
        self.specs = {n: tuple(s) for n, s in (param_specs or {}).items()
                      if any(e is not None for e in s)}
        self.set_shards({}, None)
        if zero1 and mesh is not None:
            from triad_tpu_torch.parallel.zero import apply_zero1

            apply_zero1(self, mesh, mesh_axis, param_specs)
        self.counts = {g: 0 for g in GROUPS}  # applied updates per group

    def set_shards(self, shards: Dict[str, Any], group=None) -> None:
        """(Re)build the AdamW bank: a parameter named in ``shards`` (ZeRO-1,
        ``parallel/zero.py``) is stepped through a view of this rank's
        slice, with that slice's moments, gathered back over ``group``; the
        rest in full."""
        self.shards, self.zero_group = dict(shards), group
        cfg = self.cfg
        self.storage = {
            g: [p if n not in self.shards
                else nn.Parameter(self.shards[n].of(p.data), requires_grad=False)
                for n, p in zip(self.names[g], self.groups[g])]
            for g in GROUPS
        }
        self.opts = {
            g: Adam(self.storage[g], lr=0.0, betas=(cfg.b1, cfg.b2), eps=cfg.eps,
                    weight_decay=cfg.weight_decay, mu_dtype=getattr(torch, cfg.mu_dtype),
                    nu_dtype=getattr(torch, cfg.nu_dtype), cycled=cfg.cycle_momentum)
            for g in GROUPS if self.groups[g]
        }

    def _sum_axes(self, name: str):
        """The data axes over which ``name``'s gradient is summed: those its
        spec does not shard (an FSDP slice's gradient is summed over
        'data' already)."""
        used = {a for e in self.specs.get(name, ()) if e is not None for a in _names(e)}
        return tuple(a for a in _names(self.mesh_axis) if a not in used)

    @torch.no_grad()
    def all_reduce_grads(self) -> None:
        """Sum every .grad over its data axes, in place (one all-reduce per
        group of ranks and dtype, over the flattened gradients)."""
        if self.mesh is None:
            return
        by: Dict[Any, List[torch.Tensor]] = {}
        for n, p in self.named:
            if p.grad is not None:
                by.setdefault((self._sum_axes(n), str(p.grad.dtype)), []).append(p.grad)
        for (axes, _), same in sorted(by.items()):
            flat = C.all_reduce_(torch.cat([g.reshape(-1) for g in same]),
                                 group=self.mesh.group_of(axes))
            for g, part in zip(same, flat.split([g.numel() for g in same])):
                g.copy_(part.view_as(g))

    def summed_grads(self) -> Dict[str, torch.Tensor]:
        """Each .grad summed over the ranks, whole (copies; collectives in a
        data-parallel run): the one-process run's accumulated gradient."""
        out = {}
        for n, p in self.named:
            if p.grad is not None:
                g = p.grad.detach().clone()
                if self.mesh is not None:
                    g = C.all_reduce_(g, group=self.mesh.group_of(self._sum_axes(n)))
                    g = self.mesh.whole(g, self.specs.get(n))
                out[n] = g
        return out

    def load_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """Set .grad from whole summed gradients (summed_grads'): this rank's
        slice where it is the first of the ranks they are summed over, zeros
        elsewhere (None where none was saved)."""
        for n, p in self.named:
            g = grads.get(n)
            if g is None:
                p.grad = None
                continue
            if self.mesh is not None:
                first = self.mesh.index(self._sum_axes(n)) == 0
                g = self.mesh.local(g, self.specs.get(n)) if first else None
            p.grad = torch.zeros_like(p) if g is None else g.to(p.device, p.dtype)

    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with whole tensors (sharded parameters
        gathered: a collective, every rank calls it)."""
        return {k: self.mesh.whole(v, self.specs[k]) if k in self.specs else v
                for k, v in self.model.state_dict().items()}

    def load_model_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a state dict of whole tensors, keeping this rank's slices."""
        self.model.load_state_dict({k: self.mesh.local(v, self.specs[k]) if k in self.specs
                                    else v for k, v in state.items()})

    def moment_bytes(self) -> int:
        """Bytes of AdamW moments this rank holds."""
        return sum(st[k].numel() * st[k].element_size()
                   for opt in self.opts.values() for st in opt.state.values()
                   for k in _MOMENTS if k in st)

    def _moments(self, g: str, state_dict, fn):
        """A copy of group g's AdamW state dict with fn(moment, name)
        applied to the moments of its sharded parameters."""
        sd = {"state": {i: dict(st) for i, st in state_dict["state"].items()},
              "param_groups": state_dict["param_groups"]}
        for i, st in sd["state"].items():
            name = self.names[g][int(i)]
            if name in self.shards or name in self.specs:
                for k in _MOMENTS:
                    st[k] = fn(st[k], name)
        return sd

    def full_state_dicts(self) -> Dict[str, Any]:
        """Each group's AdamW state dict with whole moments: ZeRO-1 slices
        and the slices of sharded parameters gathered from every rank (a
        collective: every rank calls it)."""
        def whole(t, name):
            if name in self.shards:
                t = C.gather_rows(t, self.zero_group, self.shards[name].dim)
            return self.mesh.whole(t, self.specs.get(name))

        return {g: self._moments(g, opt.state_dict(), whole) for g, opt in self.opts.items()}

    def load_full_state_dicts(self, state_dicts: Dict[str, Any]) -> None:
        """Load whole AdamW state dicts (a one-process checkpoint's, or
        full_state_dicts'), keeping this rank's slices."""
        if set(state_dicts) != set(self.opts):
            raise ValueError(f"checkpoint optimizer groups {sorted(state_dicts)} != "
                             f"{sorted(self.opts)}")

        def local(t, name):
            t = self.mesh.local(t, self.specs.get(name))
            if name in self.shards:
                t = self.shards[name].of(t)
            return t.contiguous()

        for g, opt in self.opts.items():
            opt.load_state_dict(self._moments(g, state_dicts[g], local))

    def gates(self, global_step: int) -> Dict[str, bool]:
        """Which groups train at this micro step (others and vit_lora always)."""
        return {"others": True, "audio": global_step >= self.cfg.unfreeze_audio_step,
                "text": global_step >= self.cfg.unfreeze_text_step, "vit_lora": True}

    def set_trainable(self, global_step: int) -> None:
        """requires_grad per the gates: the torch form of gate_grads."""
        for g, on in self.gates(global_step).items():
            for p in self.groups[g]:
                p.requires_grad_(on)
        for p in self.groups[FROZEN_GROUP]:
            p.requires_grad_(False)

    def _owned(self, name: str) -> bool:
        """Does this rank count ``name``'s squares in a norm? Where its
        coordinates on the axes the leaf is not sharded over are 0."""
        used = {a for e in self.specs.get(name, ()) if e is not None for a in _names(e)}
        return all(self.mesh.coords[a] == 0 for a in self.mesh.axis_names if a not in used)

    def clip_grads(self) -> Dict[str, torch.Tensor]:
        """Per-group grad norms (metrics) and the audio / text subtree
        clipping, in place on the accumulated .grad."""
        groups = {f"grad_norm_{'vit' if g == FROZEN_GROUP else g}": self.names[g]
                  for g in self.groups}
        subtrees = [[n for n, _ in self.named if n.startswith(prefixes)]
                    for prefixes in _CLIP_SUBTREES]
        grad = dict((n, p.grad) for n, p in self.named if p.grad is not None)
        if self.specs:  # sharded leaves: each element's square once, summed over the mesh
            def sumsq(names):
                return _sumsq([grad[n] for n in names if n in grad and self._owned(n)],
                              self.device)

            sums = C.all_reduce_(torch.stack([sumsq(ns) for ns in [*groups.values(), *subtrees]]),
                                 group=self.mesh.group)
            norms = list(sums.sqrt())
        else:
            norms = [_norm([grad[n] for n in ns if n in grad], self.device)
                     for ns in [*groups.values(), *subtrees]]
        metrics = dict(zip(groups, norms))
        for names, norm in zip(subtrees, norms[len(groups):]):
            coef = torch.clamp(self.cfg.clip_norm / (norm + 1e-6), max=1.0)
            for n in names:
                if n in grad:
                    grad[n].mul_(coef.to(grad[n].dtype))
        return metrics

    def update(self, global_step: int) -> Dict[str, float]:
        """One optimizer update at micro step ``global_step``; returns the
        lr each group's schedule gives (its lr metric)."""
        metrics = {}
        for g, on in self.gates(global_step).items():
            count = self.counts[g]
            lr = self.schedules[g](count)
            metrics[f"lr_{g}"] = lr
            if not on or g not in self.opts:
                continue
            for name, p, st in zip(self.names[g], self.groups[g], self.storage[g]):
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                if st is not p:
                    st.grad = self.shards[name].of(p.grad)
            b1 = self.momentum[g](count) if self.cfg.cycle_momentum else self.cfg.b1
            for group in self.opts[g].param_groups:
                group["lr"], group["betas"] = lr, (b1, self.cfg.b2)
            self.opts[g].step()
            self._gather_slices(g)
            self.counts[g] = count + 1
        return metrics

    @torch.no_grad()
    def _gather_slices(self, g: str) -> None:
        """The updated ZeRO-1 slices of group g back into the parameters
        (this rank's slices of them, under ``param_specs``) over the data
        axes."""
        for name, p, st in zip(self.names[g], self.groups[g], self.storage[g]):
            if st is not p:
                p.data.copy_(C.gather_rows(st.data, self.zero_group, self.shards[name].dim))

    def zero_grad(self) -> None:
        for _, p in self.named:
            p.grad = None
        for sts in self.storage.values():
            for st in sts:
                st.grad = None
