"""Train steps (mirrors ``triad_tpu/train/step.py``): forward with live
dropout, the phase-weighted loss, backward, gradient accumulation, and
at each accumulation boundary the per-group grad norms, the audio / text
subtree clip and the 4-group AdamW update.

Three step variants, one per curriculum phase: "av" (av_focus: the
audio-visual batch only), "tv" (tv_warmup: the text-visual batch only)
and "joint" (weighted_joint / full_joint: both, weighted by w_av and
w_tv). Each micro step draws its randomness from (seed, global_step), the
counterpart of ``jax.random.fold_in(state.rng, state.global_step)``: a
``torch.Generator`` for the plain dropouts, patch dropout and SpecAugment,
and an ``ops.dropout.HostSeeds`` for the int32 seed of each kernel call
site and HuBERT's layerdrop (host draws, so no seed is read back from
the card). The two frameworks' bits differ. Metrics come back as scalars
with the JAX step's keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from triad_tpu_torch.config import LossConfig, OptimConfig
from triad_tpu_torch.models.multimodal import TriadModel
from triad_tpu_torch.ops.dropout import HostSeeds
from triad_tpu_torch.ops.losses import av_loss, tv_loss
from triad_tpu_torch.train.optim import GROUPS, OptimizerBank

_NORM_GROUPS = ("others", "audio", "text", "vit_lora", "vit")
MODES = ("av", "tv", "joint")


@dataclass
class TrainState:
    """What a step mutates: the model's parameters (in place), the bank's
    AdamW states and counts, the micro step, and the dropout seed.
    Accumulated gradients live in the parameters' ``.grad``."""

    model: TriadModel
    bank: OptimizerBank
    global_step: int = 0
    seed: int = 0


def step_generator(seed: int, global_step: int, device) -> torch.Generator:
    """The micro step's dropout generator, keyed on (seed, global_step)."""
    key = np.random.SeedSequence([seed, global_step]).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(key) & (2 ** 63 - 1))


def _batches(mode: str, av_batch, tv_batch):
    if mode not in MODES:
        raise ValueError(f"unknown step mode {mode!r} (expected {MODES})")
    return (av_batch if mode in ("av", "joint") else None,
            tv_batch if mode in ("tv", "joint") else None)


class StepFactory:
    """Builds the per-phase train steps for a TriadModel (the model and
    its bank travel in the TrainState)."""

    def __init__(self, loss_cfg: LossConfig, optim_cfg: OptimConfig):
        self.loss_cfg, self.optim_cfg = loss_cfg, optim_cfg

    def compute_losses(self, model: TriadModel, av_batch, tv_batch,
                       generator: Optional[torch.Generator], w_av=1.0, w_tv=1.0,
                       train: bool = True, seeds: Optional[HostSeeds] = None,
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Phase-weighted total loss and the metrics dict.

        av_batch: {"images": (B, H, W, 3), "audio": (B, T)}; tv_batch:
        {"images": (B, H, W, 3), "token_ids": (B, Nt), "text_mask": (B,
        Nt)}; on the model's device, either may be None."""
        temp = model.temperature
        metrics: Dict[str, torch.Tensor] = {"temperature": temp.detach().clone()}
        total = torch.zeros((), dtype=torch.float32, device=temp.device)
        if av_batch is not None:
            visual = model.encode_visual(av_batch["images"], train, generator)
            audio = model.encode_audio(av_batch["audio"], train, generator, seeds)
            av = av_loss(audio, visual, temp, self.loss_cfg)
            total = total + w_av * av.total
            metrics.update({k: v.detach() for k, v in av.stats.items()})
            metrics.update(loss_av=av.total.detach(), av_contrastive_loss=av.contrastive.detach(),
                           av_reg_loss=av.reg.detach(), av_smooth_loss=av.smooth.detach())
        if tv_batch is not None:
            visual = model.encode_visual(tv_batch["images"], train, generator)
            text = model.encode_text(tv_batch["token_ids"], tv_batch["text_mask"], train,
                                     generator)
            tv = tv_loss(text, visual, tv_batch["text_mask"], temp, self.loss_cfg)
            total = total + w_tv * tv.total
            metrics.update({k: v.detach() for k, v in tv.stats.items()})
            metrics.update(loss_tv=tv.total.detach(),
                           tv_contrastive_loss=tv.contrastive.detach())
        metrics["train_loss"] = total.detach()
        return total, metrics

    def make_step(self, mode: str):
        """mode "av" | "tv" | "joint" -> step(state, av_batch, tv_batch,
        w_av, w_tv) -> (state, metrics). The batch a mode does not use may
        be None."""
        _batches(mode, None, None)
        accum = self.optim_cfg.gradient_accumulation_steps

        def step(state: TrainState, av_batch, tv_batch, w_av=1.0, w_tv=1.0):
            av_batch, tv_batch = _batches(mode, av_batch, tv_batch)
            gs = state.global_step
            state.bank.set_trainable(gs)
            gen = step_generator(state.seed, gs, state.model.temperature.device)
            seeds = HostSeeds(state.seed, gs)
            total, metrics = self.compute_losses(state.model, av_batch, tv_batch, gen, w_av,
                                                 w_tv, seeds=seeds)
            # loss / accum before backward; .grad accumulates the micro steps.
            (total / accum if accum > 1 else total).backward()
            if (gs + 1) % accum == 0:
                metrics.update(state.bank.clip_grads())
                metrics.update(state.bank.update(gs))
                state.bank.zero_grad()
            else:
                metrics.update({f"grad_norm_{n}": 0.0 for n in _NORM_GROUPS})
                metrics.update({f"lr_{g}": 0.0 for g in GROUPS})
            metrics["global_step"] = gs
            state.global_step = gs + 1
            return state, metrics

        return step

    def make_eval_loss(self, mode: str):
        """Validation loss (no dropout, no update): eval_step(model,
        av_batch, tv_batch, w_av, w_tv) -> metrics."""
        _batches(mode, None, None)

        @torch.no_grad()
        def eval_step(model: TriadModel, av_batch, tv_batch, w_av=1.0, w_tv=1.0):
            av_batch, tv_batch = _batches(mode, av_batch, tv_batch)
            _, metrics = self.compute_losses(model, av_batch, tv_batch, None, w_av, w_tv,
                                             train=False)
            return metrics

        return eval_step
