"""The plain reference of the joint training step: micro steps of the
phase-weighted AV + TV loss, gradients accumulated over the configured
micro steps, the audio and text subtrees clipped to the global norm, and
one decoupled-weight-decay Adam per group at its OneCycle learning rate
and beta1, every gated group past its unfreeze step.

The batch does not fit in fp32 at once, so a micro step runs in blocks of
rows: the encoders' outputs first without gradient, then the losses on
them with gradient (which gives the gradient of every token feature),
then each block again with gradient, its backward seeded with its rows'
feature gradients. Every block draws the same random numbers it drew the
first time (they are drawn once per micro step, at the batch's shapes).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from reference import draws as D
from reference import losses as L
from reference import model as M

GROUPS = ("others", "audio", "text", "vit_lora")
CLIP_PREFIXES = (("audio_backbone", "audio_projection"), ("text_backbone", "text_projection"))


def group_of(name: str) -> str:
    if name.startswith("audio_backbone"):
        return "audio"
    if name.startswith("text_backbone"):
        return "text"
    if name.startswith("visual_backbone"):
        return "vit_lora" if "lora" in name.rsplit(".", 1)[-1] else "vit_frozen"
    return "others"


def gates(optim: dict, global_step: int) -> Dict[str, bool]:
    return {"others": True, "audio": global_step >= optim["unfreeze_audio_step"],
            "text": global_step >= optim["unfreeze_text_step"], "vit_lora": True}


def cycles(optim: dict, total_updates: int) -> Dict[str, int]:
    return {"others": total_updates, "audio": total_updates - optim["unfreeze_audio_step"],
            "text": total_updates - optim["unfreeze_text_step"],
            "vit_lora": total_updates - optim["unfreeze_vit_step"]}


def lr_scale(optim: dict, group: str) -> float:
    return optim[f"lr_scale_{group}"]


class Adam:
    """Decoupled weight decay Adam of one group (fp32 moments)."""

    def __init__(self):
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.n: Dict[str, int] = {}

    @torch.no_grad()
    def step(self, W, grads, names, lr, b1, b2, eps, wd):
        for name in names:
            p = W[name]
            g = grads.get(name)
            if g is None:
                g = torch.zeros_like(p)
            if name not in self.m:
                self.m[name], self.v[name], self.n[name] = (torch.zeros_like(p),
                                                            torch.zeros_like(p), 0)
            self.n[name] += 1
            m = self.m[name].mul_(b1).add_(g * (1.0 - b1))
            v = self.v[name].mul_(b2).add_(g * g * (1.0 - b2))
            u = (m / D.bias_correction(b1, self.n[name])) / (
                torch.sqrt(v / D.bias_correction(b2, self.n[name])) + eps)
            p.add_((u + wd * p) * -lr)


def _blocks(n: int, block: int):
    return [(i, min(n, i + block)) for i in range(0, n, block)]


def micro_step(P, W, cfg, loss_cfg, av, tv, w_av, w_tv, seed, global_step, trainable, grads,
               scale, block):
    """One micro step: adds scale * the gradient of every trainable leaf to
    ``grads``; returns (loss_av, loss_tv)."""
    b_av, b_tv = av["audio"].shape[0], tv["token_ids"].shape[0]
    h = cfg["hubert"]
    n_audio = h_tokens(h, av["audio"].shape[1])
    dev = av["audio"].device
    dr = M.StepDraws(cfg, seed, global_step, b_av, b_tv, n_audio, tv["token_ids"].shape[1], dev)
    rows = list(zip(_blocks(b_av, block), _blocks(b_tv, block)))
    with torch.no_grad():
        parts = [M.encoders(P, W, cfg, av, tv, dr, lo, hi, lt, ht)
                 for (lo, hi), (lt, ht) in rows]
    feats = {k: torch.cat([p[k] for p in parts]).requires_grad_() for k in parts[0]}
    del parts
    temp = W["temperature"].detach().clone().requires_grad_()
    with torch.enable_grad():
        lav = L.av_loss(P, feats["audio"], feats["visual_av"], temp, loss_cfg)
        ltv = L.tv_loss(P, feats["text"], feats["visual_tv"], tv["text_mask"], temp, loss_cfg)
        ((w_av * lav + w_tv * ltv) * scale).backward()
    if "temperature" in trainable:
        _add(grads, "temperature", temp.grad)
    fgrad = {k: v.grad for k, v in feats.items()}
    del feats
    leaves = {n: (W[n].detach().requires_grad_() if n in trainable else W[n]) for n in W}
    for (lo, hi), (lt, ht) in rows:
        with torch.enable_grad():
            out = M.encoders(P, leaves, cfg, av, tv, dr, lo, hi, lt, ht)
            keys = list(out)
            got = [fgrad[k][lo:hi] if k in ("audio", "visual_av") else fgrad[k][lt:ht]
                   for k in keys]
            torch.autograd.backward([out[k] for k in keys], got)
        del out
    for n in trainable:
        if n != "temperature" and leaves[n].grad is not None:
            _add(grads, n, leaves[n].grad)
    return float(lav.detach()), float(ltv.detach())


def h_tokens(h: dict, samples: int) -> int:
    t = samples
    if h["frontend_impl"] == "monolithic":
        t -= t % 10
    for k, s in zip(h["conv_kernel"], h["conv_stride"]):
        t = (t - k) // s + 1
    return t


def _add(grads, name, g):
    if name in grads:
        grads[name] += g
    else:
        grads[name] = g.detach().clone()


def _norm(gs: List[torch.Tensor]) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=gs[0].device) if gs else torch.zeros(())
    for g in gs:
        total = total + g.float().square().sum()
    return total.sqrt()


def run(P, W: Dict[str, torch.Tensor], cfg: dict, loss_cfg: dict, optim: dict, batches,
        w_av: float, w_tv: float, seed: int, start_step: int, counts: Dict[str, int],
        total_updates: int, micro_steps: int, block: int):
    """``micro_steps`` micro steps from ``start_step`` on ``batches`` (a list
    of (av, tv) dicts, one a micro step), updating W in place. Returns
    {"losses": [(av, tv)], "first_grad": {name: norm}, "first_grads": {name:
    the first update's gradient, on the host}, "grad_max": {name:
    largest gradient norm over the updates}, "change": {name: norm of its
    change}, "trainable": [names], "updates": count}."""
    accum = optim["gradient_accumulation_steps"]
    adams = {g: Adam() for g in GROUPS}
    counts = dict(counts)
    losses, first, first_grads, grad_max = [], None, {}, {}
    grads: Dict[str, torch.Tensor] = {}
    names = {g: [n for n in W if group_of(n) == g] for g in GROUPS}
    cyc = cycles(optim, total_updates)
    updates = 0
    seen = set()
    start = {n: W[n].detach().clone() for g in GROUPS for n in names[g]}
    for i in range(micro_steps):
        gs = start_step + i
        on = gates(optim, gs)
        trainable = {n for g in GROUPS if on[g] for n in names[g]}
        seen |= trainable
        av, tv = batches[i]
        losses.append(micro_step(P, W, cfg, loss_cfg, av, tv, w_av, w_tv, seed, gs, trainable,
                                 grads, 1.0 / accum, block))
        if (gs + 1) % accum:
            continue
        for prefixes in CLIP_PREFIXES:
            sub = [n for n in grads if n.startswith(prefixes)]
            norm = _norm([grads[n] for n in sub])
            coef = torch.clamp(optim["clip_norm"] / (norm + 1e-6), max=1.0)
            for n in sub:
                grads[n] = grads[n] * coef
        norms = {n: float(g.float().norm()) for n, g in grads.items()}
        if first is None:
            first = norms
            first_grads = {n: g.float().cpu() for n, g in grads.items()}
        for n, v in norms.items():
            grad_max[n] = max(grad_max.get(n, 0.0), v)
        for g in GROUPS:
            count = counts[g]
            if on[g] and names[g]:
                lr = D.onecycle_lr(optim, lr_scale(optim, g), cyc[g], count)
                b1 = D.onecycle_beta1(optim, cyc[g], count)
                adams[g].step(W, grads, names[g], lr, b1, optim["b2"], optim["eps"],
                              optim["weight_decay"])
                counts[g] = count + 1
        grads = {}
        updates += 1
    change = {n: float((W[n] - w0).float().norm()) for n, w0 in start.items()}
    return {"losses": losses, "first_grad": first or {}, "first_grads": first_grads,
            "grad_max": grad_max,
            "change": change, "trainable": sorted(seen), "updates": updates}
