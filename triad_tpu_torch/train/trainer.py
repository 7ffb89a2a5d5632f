"""The training orchestrator (reference MultiModalTrainer, train.py:43-1146):
the port of ``triad_tpu/train/trainer.py``.

Owns: data loaders (real reference-layout datasets or synthetic),
curriculum phases, the per-phase train steps, validation, 1000-way
retrieval, grounding visualization, checkpoint/autoresume with mid-epoch
exactness, and JSONL/wandb metrics.

Curriculum (train.py:880-905): epoch-indexed
  av_focus -> tv_warmup -> weighted_joint (AV weight start->end) -> full_joint.

Periodic hooks (train.py:1108-1120): viz every ``vis_every`` steps,
checkpoint every ``save_every_steps`` (mid-epoch cursor saved), validate
+ retrieval every ``validation_frequency``; per-epoch validation with
best-model tracking (train.py:1129-1144).

The Trainer runs on ``device`` ("cuda" unless the caller asks for "cpu";
without a card it raises). It builds the model, the optimizer bank and
the three steps once, feeds the steps through the pinned-memory
``Prefetcher`` with the device augmentation (``data/device_aug.py``), and
keeps each step's loss on the device until the epoch ends. Two
departures from the JAX Trainer, both for exact resume across processes:
the segment hop at an epoch's start draws from ``random.Random`` keyed on
(seed, epoch), not from the process's global ``random``; and the
checkpoint holds the accumulated gradients (``train/checkpoint.py``).
The multi-device mesh and multi-process runs raise ``not_ported``,
naming the JAX route. ``config.pretrained`` starts the model from HF
snapshots, a torch.hub DINOv2 file or a reference checkpoint
(``models/hf_import.py:init_model_from_pretrained``).
"""

from __future__ import annotations

import random
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from triad_tpu_torch.config import Config
from triad_tpu_torch.data import (
    AVLoader,
    AudioVisualDataset,
    FlatAudioVisualDataset,
    LocalCaptionDataset,
    Prefetcher,
    SyntheticAVDataset,
    SyntheticTVDataset,
    TVLoader,
    WordPieceTokenizer,
)
from triad_tpu_torch.data.device_aug import device_ingest_av, device_ingest_tv
from triad_tpu_torch.eval.retrieval import (
    av_retrieval_metrics,
    embed_av_subset,
    embed_tv_subset,
    select_subset_indices,
    tv_retrieval_metrics,
)
from triad_tpu_torch.models.convert import init_triad_model
from triad_tpu_torch.models.layers import not_ported
from triad_tpu_torch.ops.similarity import pairwise_similarity
from triad_tpu_torch.train.checkpoint import (
    CheckpointManager,
    HostProgress,
    warn_on_config_mismatch,
)
from triad_tpu_torch.train.optim import OptimizerBank
from triad_tpu_torch.train.step import MODES, StepFactory, TrainState
from triad_tpu_torch.utils import MetricsLogger, StepTimer
from triad_tpu_torch.viz import AudioVisualizer, TextVisualizer


def _open_av_root(root: str, image_size: int, segmented: bool):
    """AV dataset from a data root: TriadPack shards (a ``.tpack`` file
    or a directory containing them — the pre-decoded path,
    data/packed.py) or the reference's mp4 folder layouts."""
    from triad_tpu_torch.data.packed import PackedAVDataset

    p = Path(root)
    if p.suffix == ".tpack" or (p.is_dir() and any(p.glob("*.tpack"))):
        ds = PackedAVDataset(root, segmented=segmented)
        if ds.image_size != image_size:
            raise ValueError(
                f"packed shard image_size {ds.image_size} != configured "
                f"{image_size}"
            )
        return ds
    if segmented:
        return AudioVisualDataset(root, image_size=image_size)
    return FlatAudioVisualDataset(root, image_size=image_size)


def _check_routes(config: Config) -> None:
    """The JAX Trainer's routes this port does not run yet."""
    import torch.distributed as dist

    n_dev = config.mesh.num_devices or 1
    if n_dev > 1:
        raise not_ported(
            f"mesh.num_devices={n_dev} (a multi-device mesh)",
            "triad_tpu/parallel's data-parallel mesh with its dp / tp / fsdp / zero1 "
            "shardings (train/trainer.py:204-296)")
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise not_ported(
            f"a multi-process run (torch.distributed world size {dist.get_world_size()})",
            "parallel/distributed.py:process_shard, the per-process row-slices of each "
            "global batch (train/trainer.py:182, :470)")


class Trainer:
    def __init__(self, config: Config, force_new_training: bool = False, device=None):
        self.device = torch.device(device or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device (pass device='cpu' to train on the CPU)")
        _check_routes(config)
        self.config = config
        tc = config.train
        self.output_dir = Path(tc.output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.metrics = MetricsLogger(
            str(self.output_dir),
            use_wandb=tc.use_wandb,
            project_name=tc.project_name,
            config=config.to_dict(),
        )
        # Seconds of each hook (validate, retrieval, viz) and of a resume.
        self.timings: Dict[str, List[float]] = {
            "validate": [], "retrieval": [], "viz": [], "restore": []}
        self.video_writer: Optional[str] = None

        # -- data ------------------------------------------------------
        dc = config.data
        grounded_spec = None
        if dc.synthetic_grounded:
            from triad_tpu_torch.data.datasets import GroundedSyntheticSpec

            grounded_spec = GroundedSyntheticSpec(
                num_classes=dc.synthetic_grounded_classes,
                image_size=dc.image_size,
                patch_size=config.model.vit.patch_size,
                sample_rate=dc.sample_rate,
            )

        def _synth_av(size: int, seed: int = 0):
            secs = dc.audio_num_samples / dc.sample_rate
            if grounded_spec is not None:
                from triad_tpu_torch.data.datasets import GroundedSyntheticAVDataset

                return GroundedSyntheticAVDataset(
                    size=size, audio_seconds=secs, spec=grounded_spec,
                    seed=seed,
                )
            return SyntheticAVDataset(
                size=size, image_size=dc.image_size, audio_seconds=secs,
                seed=seed,
            )

        def _synth_tv(size: int, seed: int = 0):
            if grounded_spec is not None:
                from triad_tpu_torch.data.datasets import GroundedSyntheticTVDataset

                return GroundedSyntheticTVDataset(
                    size=size, spec=grounded_spec, seed=seed
                )
            return SyntheticTVDataset(
                size=size, image_size=dc.image_size, seed=seed
            )

        if dc.audio_visual_data_root:
            self.av_dataset = _open_av_root(
                dc.audio_visual_data_root, dc.image_size, segmented=True
            )
        else:
            self.av_dataset = _synth_av(dc.synthetic_av_size)
        if dc.text_dataset_path:
            self.tv_dataset = LocalCaptionDataset(
                dc.text_dataset_path, image_size=dc.image_size
            )
        else:
            self.tv_dataset = _synth_tv(dc.synthetic_tv_size)

        self.val_av_dataset = None
        if dc.audio_visual_val_data_root:
            self.val_av_dataset = _open_av_root(
                dc.audio_visual_val_data_root, dc.image_size, segmented=False
            )
        elif not dc.audio_visual_data_root:
            self.val_av_dataset = _synth_av(
                max(8, dc.synthetic_av_size // 4), seed=1
            )
        self.val_tv_dataset = None
        if dc.text_dataset_val_path:
            self.val_tv_dataset = LocalCaptionDataset(
                dc.text_dataset_val_path, image_size=dc.image_size, augment=False
            )
        elif not dc.text_dataset_path:
            self.val_tv_dataset = _synth_tv(
                max(8, dc.synthetic_tv_size // 4), seed=1
            )

        if dc.tokenizer_vocab:
            self.tokenizer = WordPieceTokenizer.from_vocab_file(dc.tokenizer_vocab)
        else:
            corpus = [
                self.tv_dataset.__getitem__(i, apply_augmentation=False)[1]
                for i in range(min(len(self.tv_dataset), 2000))
            ]
            self.tokenizer = WordPieceTokenizer.build_from_corpus(corpus)
            self.metrics.info(
                f"Built corpus tokenizer with {len(self.tokenizer.vocab)} entries "
                "(pass data.tokenizer_vocab for the pretrained vocab)"
            )

        self.av_loader = AVLoader(
            self.av_dataset, dc.batch_size_av, dc.audio_num_samples,
            seed=tc.seed, num_workers=dc.num_workers,
            worker_mode=dc.worker_mode,
            unique_videos=dc.unique_videos
            and hasattr(self.av_dataset, "video_files"),
            device_augment=dc.device_augment,
        )
        self.tv_loader = TVLoader(
            self.tv_dataset, self.tokenizer, dc.batch_size_tv,
            max_text_tokens=dc.max_text_tokens, seed=tc.seed,
            num_workers=dc.num_workers, worker_mode=dc.worker_mode,
            device_augment=dc.device_augment,
        )

        # -- model / optimizer / steps ----------------------------------
        generator = torch.Generator(device=self.device).manual_seed(tc.seed)
        if config.pretrained.any():
            # Pretrained backbones from on-disk snapshots (the
            # reference's startup fetches, model.py:29-30, 79-80, 218)
            # or a full trained reference checkpoint; a checkpoint of this
            # run, if any, is restored over them below.
            from triad_tpu_torch.models.hf_import import init_model_from_pretrained

            pre = config.pretrained
            self.model = init_model_from_pretrained(
                config.model, generator, self.device, hubert_path=pre.hubert,
                text_path=pre.text, vit_path=pre.vit,
                reference_checkpoint=pre.reference_checkpoint,
            )
            self.metrics.info(
                "Loaded pretrained weights: "
                + ", ".join(
                    f"{k}={v}" for k, v in (
                        ("hubert", pre.hubert), ("text", pre.text),
                        ("vit", pre.vit),
                        ("reference", pre.reference_checkpoint),
                    ) if v
                )
            )
        else:
            self.model = init_triad_model(config.model, generator, device=self.device)
        self.steps_per_epoch = tc.steps_per_epoch or max(
            len(self.av_loader), len(self.tv_loader)
        )
        self.total_updates = (
            self.steps_per_epoch * tc.num_epochs
        ) // tc.optim.gradient_accumulation_steps
        self.bank = OptimizerBank(tc.optim, self.model, self.total_updates)
        self.factory = StepFactory(config.loss, tc.optim)
        # The dropout seed: the JAX Trainer's state rng is key(seed + 1).
        self.state = TrainState(self.model, self.bank, 0, tc.seed + 1)
        self._steps = {mode: self.factory.make_step(mode) for mode in MODES}
        self._eval_steps = {mode: self.factory.make_eval_loss(mode) for mode in MODES}

        # Retrieval-eval encoders, built once (trainer.py:420-443): the
        # model's eval path on the trainer's device, fed CPU tensors.
        @torch.inference_mode()
        def _enc_av(images, audio):
            return (self.model.encode_audio(audio.to(self.device)),
                    self.model.encode_visual(images.to(self.device)))

        @torch.inference_mode()
        def _enc_tv(images, ids, mask):
            return (self.model.encode_text(ids.to(self.device), mask.to(self.device)),
                    self.model.encode_visual(images.to(self.device)))

        self._enc_av, self._enc_tv = _enc_av, _enc_tv

        # -- progress / resume ----------------------------------------
        self.progress = HostProgress()
        self.ckpt = CheckpointManager(
            str(self.output_dir / "checkpoints"),
            async_save=tc.async_checkpointing,
        )
        if not force_new_training and self.ckpt.latest_step() is not None:
            self._resume()

        self.audio_viz = AudioVisualizer(
            patch_size=config.model.vit.patch_size,
            image_size=config.model.vit.image_size,
        )
        self.text_viz = TextVisualizer(
            patch_size=config.model.vit.patch_size,
            image_size=config.model.vit.image_size,
        )
        self._vis_samples_av = self._cache_vis_samples_av(tc.num_vis_samples_av)
        self._vis_samples_tv = self._cache_vis_samples_tv(tc.num_vis_samples_tv)
        self.timer = StepTimer(device=self.device)
        self.metrics.info(
            f"Trainer ready: {self.steps_per_epoch} steps/epoch, "
            f"{self.total_updates} total updates"
        )

    # ------------------------------------------------------------------
    # Phases (train.py:880-905)
    # ------------------------------------------------------------------

    def phase_for_epoch(self, epoch: int) -> Tuple[str, float, float]:
        tc = self.config.train
        if epoch < tc.av_focus_epochs:
            return "av_focus", 1.0, 0.0
        if epoch < tc.av_focus_epochs + tc.tv_warmup_epochs:
            return "tv_warmup", 0.0, 1.0
        joint_start = tc.av_focus_epochs + tc.tv_warmup_epochs
        if epoch < joint_start + tc.weighted_joint_epochs:
            progress = (epoch - joint_start) / tc.weighted_joint_epochs
            w_av = tc.av_weight_start - progress * (
                tc.av_weight_start - tc.av_weight_end
            )
            return "weighted_joint", w_av, 1.0 - w_av
        return "full_joint", 1.0, 1.0

    @staticmethod
    def _mode(phase: str) -> str:
        return {"av_focus": "av", "tv_warmup": "tv"}.get(phase, "joint")

    # ------------------------------------------------------------------
    # Train loop (train.py:876-1146)
    # ------------------------------------------------------------------

    def train(self) -> None:
        tc = self.config.train
        for epoch in range(self.progress.epoch, tc.num_epochs):
            phase, w_av, w_tv = self.phase_for_epoch(epoch)
            self.metrics.info(f"Epoch {epoch} phase={phase} w_av={w_av:.2f}")

            if self.progress.current_batch_idx == 0:
                # keyed on (seed, epoch): a resumed run hops as the
                # uninterrupted one did
                self.av_dataset.switch_segment(random.Random((tc.seed << 32) + epoch))
                self.progress.dataset_segment = getattr(
                    self.av_dataset, "current_segment", 0
                )

            start_batch = self.progress.current_batch_idx
            # Background prefetch: a thread assembles the next batches and
            # copies them to the device from pinned memory on a side
            # stream, running the device augmentation there, while the
            # device runs the current step (replaces the reference's
            # DataLoader worker prefetch, train.py:157-181).
            av_iter = tv_iter = None
            if phase != "tv_warmup":
                av_iter = Prefetcher(
                    self._cycling_iter(self.av_loader, epoch, start_batch),
                    prefetch=self.config.data.prefetch,
                    device_put=self._device_av, device=self.device,
                )
            if phase != "av_focus":
                tv_iter = Prefetcher(
                    self._cycling_iter(self.tv_loader, epoch, start_batch),
                    prefetch=self.config.data.prefetch,
                    device_put=self._device_tv, device=self.device,
                )
            step_fn = self._steps[self._mode(phase)]
            epoch_losses = []
            self.timer.restart()

            # Optional torch.profiler trace of the first profile_steps
            # steps of the first trained epoch (SURVEY §5 tracing hook).
            profile_left = (
                self.config.train.profile_steps
                if epoch == self.progress.epoch
                else 0
            )
            if profile_left > 0:
                from triad_tpu_torch.utils import profile_trace

                self._prof = profile_trace(str(self.output_dir / "profile"))
                self._prof.__enter__()

            try:
                for batch_idx in range(start_batch, self.steps_per_epoch):
                    av_batch = next(av_iter) if av_iter is not None else None
                    tv_batch = next(tv_iter) if tv_iter is not None else None
                    self.state, metrics = step_fn(self.state, av_batch, tv_batch, w_av, w_tv)
                    self.timer.tick(phase)
                    if profile_left > 0:
                        profile_left -= 1
                        if profile_left == 0:
                            if self.device.type == "cuda":
                                torch.cuda.synchronize(self.device)
                            self._prof.__exit__(None, None, None)
                    gs = int(self.progress.global_step)
                    if batch_idx % 10 == 0 or batch_idx == self.steps_per_epoch - 1:
                        host = self._fetch_metrics(metrics)
                        host.update(
                            epoch=epoch, training_phase=phase,
                            av_weight=w_av, tv_weight=w_tv,
                        )
                        host.update(
                            self.timer.metrics(
                                self.config.data.batch_size_av
                                + self.config.data.batch_size_tv
                            )
                        )
                        self.metrics.log(host, step=gs)
                    # Keep the loss as a device scalar: a per-step float()
                    # here would wait for every step to finish on the
                    # device. One stacked fetch happens at epoch end.
                    epoch_losses.append(metrics["train_loss"])

                    self.progress.global_step += 1
                    hooked = False
                    if gs > 0 and gs % tc.vis_every == 0:
                        self.visualize_samples(epoch)
                        hooked = True
                    if gs > 0 and gs % tc.save_every_steps == 0:
                        self.progress.epoch = epoch
                        self.progress.current_batch_idx = batch_idx + 1
                        self.save_checkpoint()
                        hooked = True
                    if gs > 0 and gs % tc.validation_frequency == 0:
                        self.validate(phase)
                        self.eval_1000_way_retrieval()
                        hooked = True
                    if hooked:
                        self.timer.restart()
            finally:
                for it in (av_iter, tv_iter):
                    if it is not None:
                        it.close()
            mean_loss = (
                float(torch.stack(epoch_losses).mean())
                if epoch_losses
                else float("nan")
            )
            self.metrics.info(f"Epoch {epoch} done, mean loss {mean_loss:.4f}")

            val = self.validate(phase)
            self.eval_1000_way_retrieval()
            is_best = False
            if val is not None and val < self.progress.best_loss:
                self.progress.best_loss = val
                is_best = True
                self.metrics.info(f"New best val loss {val:.4f}")
            self.progress.epoch = epoch + 1
            self.progress.current_batch_idx = 0
            self.save_checkpoint(is_best=is_best)
        # Drain the async checkpoint writer before returning, so its
        # thread never races interpreter shutdown.
        self.ckpt.wait_until_finished()
        self.metrics.info("Training complete!")

    @staticmethod
    def _fetch_metrics(metrics: Dict) -> Dict[str, float]:
        """Fetch a dict of device scalars with ONE transfer (a float() per
        entry would wait on the device once each)."""
        keys = [k for k, v in metrics.items()
                if isinstance(v, torch.Tensor) and v.ndim == 0]
        host: Dict[str, float] = {}
        if keys:
            vals = torch.stack([metrics[k].to(torch.float32) for k in keys]).cpu()
            host = dict(zip(keys, vals.tolist()))
        for k, v in metrics.items():
            if k not in host:
                host[k] = v
        return host

    # ------------------------------------------------------------------
    # Data plumbing
    # ------------------------------------------------------------------

    def _cycling_iter(self, loader, epoch: int, start_batch: int) -> Iterator:
        # ``start_batch`` counts TRAINER batches; with steps_per_epoch >
        # len(loader) the uninterrupted run cycles into later loader
        # epochs mid-trainer-epoch, so a resume cursor can lie at or
        # past len(loader) — normalize it into (loader epoch, batch) or
        # the first loader.epoch() comes back empty and a resumed run
        # would diverge from (or crash out of) the uninterrupted one.
        n = len(loader)
        if n > 0:
            epoch += start_batch // n
            start_batch %= n

        def gen():
            e, b = epoch, start_batch
            while True:
                yielded = False
                for item in loader.epoch(e, b):
                    yielded = True
                    yield item
                if not yielded and b == 0:
                    raise RuntimeError("empty loader")
                e, b = e + 1, 0

        return gen()

    def _device_av(self, batch) -> Dict[str, torch.Tensor]:
        return device_ingest_av(batch, device=self.device)

    def _device_tv(self, batch) -> Dict[str, torch.Tensor]:
        return device_ingest_tv(batch, device=self.device)

    # ------------------------------------------------------------------
    # Checkpointing (train.py:382-525)
    # ------------------------------------------------------------------

    def save_checkpoint(self, is_best: bool = False) -> None:
        self.ckpt.save(
            step=self.progress.global_step,
            train_state=self.state,
            progress=self.progress,
            config_dict=self.config.to_dict(),
            is_best=is_best,
        )
        self.metrics.info(
            f"Saved checkpoint at step {self.progress.global_step}"
            + (" (best)" if is_best else "")
        )

    def _resume(self) -> None:
        t0 = time.perf_counter()
        state, progress, saved_cfg, _ = self.ckpt.restore(self.state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings["restore"].append(time.perf_counter() - t0)
        self.state = state
        self.progress = progress
        warn_on_config_mismatch(
            saved_cfg.get("train", {}), self.config.to_dict().get("train", {}),
            logger=self.metrics.info,
        )
        if hasattr(self.av_dataset, "set_segment"):
            self.av_dataset.set_segment(progress.dataset_segment)
        self.metrics.info(
            f"Resumed from step {progress.global_step} "
            f"(epoch {progress.epoch}, batch {progress.current_batch_idx}) in "
            f"{self.timings['restore'][-1]:.3f} s"
        )

    # ------------------------------------------------------------------
    # Validation (train.py:710-832)
    # ------------------------------------------------------------------

    def validate(
        self, phase: str, max_batches: Optional[int] = None
    ) -> Optional[float]:
        """Phase-aware validation. The reference iterates each val
        loader fully and INDEPENDENTLY (train.py:710-832: all AV val
        batches, then all TV val batches, then the phase-weighted sum
        of the two means) — pairing them in lockstep would silently
        drop the longer set's tail. ``max_batches`` caps each loader
        separately."""
        t0 = time.perf_counter()
        _, w_av, w_tv = self.phase_for_epoch(max(self.progress.epoch, 0))
        mode = self._mode(phase)
        limit = max_batches if max_batches is not None else 10**9

        def _run_leg(leg_mode: str, loader, device_fn) -> Dict[str, list]:
            eval_fn = self._eval_steps[leg_mode]
            totals: Dict[str, list] = {}
            try:
                for count, batch in enumerate(iter(loader)):
                    if count >= limit:
                        break
                    b = device_fn(batch)
                    m = eval_fn(
                        self.model,
                        b if leg_mode == "av" else None,
                        b if leg_mode == "tv" else None,
                        w_av, w_tv,
                    )
                    m = self._fetch_metrics(m)
                    for k, v in m.items():
                        totals.setdefault(k, []).append(v)
            finally:
                loader.pool.close()
            return totals

        av_totals: Dict[str, list] = {}
        tv_totals: Dict[str, list] = {}
        if self.val_av_dataset is not None and mode in ("av", "joint"):
            av_loader = AVLoader(
                self.val_av_dataset, self.config.data.batch_size_av,
                self.config.data.audio_num_samples, shuffle=False,
                augment=False, num_workers=self.config.data.num_workers,
            )
            av_totals = _run_leg("av", av_loader, self._device_av)
        if self.val_tv_dataset is not None and mode in ("tv", "joint"):
            tv_loader = TVLoader(
                self.val_tv_dataset, self.tokenizer,
                self.config.data.batch_size_tv,
                max_text_tokens=self.config.data.max_text_tokens,
                shuffle=False, augment=False,
                num_workers=self.config.data.num_workers,
            )
            tv_totals = _run_leg("tv", tv_loader, self._device_tv)
        if not av_totals and not tv_totals:
            return None

        avg: Dict[str, float] = {}
        for totals in (av_totals, tv_totals):
            for k, v in totals.items():
                if k in ("train_loss", "temperature"):
                    continue
                avg[f"val_{k}"] = float(np.mean(v))
        # Phase-weighted total over the per-leg means (each leg's
        # train_loss already carries its phase weight: the eval step
        # computes w_av*av.total / w_tv*tv.total for a single-pair
        # batch).
        leg_means = [
            float(np.mean(t["train_loss"]))
            for t in (av_totals, tv_totals)
            if "train_loss" in t
        ]
        avg["val_train_loss"] = float(np.sum(leg_means))
        temps = (
            av_totals.get("temperature") or tv_totals.get("temperature")
        )
        if temps:
            avg["val_temperature"] = float(np.mean(temps))
        self.metrics.log(avg, step=self.progress.global_step)
        self.timings["validate"].append(time.perf_counter() - t0)
        return avg.get("val_train_loss")

    # ------------------------------------------------------------------
    # Retrieval eval (train.py:835-874 -> eval/retrieval.py)
    # ------------------------------------------------------------------

    def eval_1000_way_retrieval(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        out: Dict[str, float] = {}
        temp = float(self.model.temperature.detach())
        subset_size = min(
            self.config.train.retrieval_subset_size,
            len(self.val_av_dataset or []) or 10**9,
            len(self.val_tv_dataset or []) or 10**9,
        )
        if self.val_av_dataset is not None:
            indices = select_subset_indices(
                len(self.val_av_dataset),
                str(self.output_dir / "retrieval_subset_av.json"),
                subset_size,
            )
            a, am, v = embed_av_subset(
                self._enc_av, self.val_av_dataset, indices,
                self.config.data.audio_num_samples,
                num_tokens_fn=self.config.model.hubert.num_audio_tokens,
            )
            out.update(av_retrieval_metrics(a, am, v, temp, self.device))
        if self.val_tv_dataset is not None:
            indices = select_subset_indices(
                len(self.val_tv_dataset),
                str(self.output_dir / "retrieval_subset_tv.json"),
                subset_size,
            )
            t, tm, v = embed_tv_subset(
                self._enc_tv, self.val_tv_dataset, indices, self.tokenizer,
                self.config.data.max_text_tokens,
            )
            out.update(tv_retrieval_metrics(t, tm, v, temp, self.device))
        if out:
            self.metrics.log(
                {f"retrieval_{k}": v for k, v in out.items()},
                step=self.progress.global_step,
            )
        self.timings["retrieval"].append(time.perf_counter() - t0)
        return out

    # ------------------------------------------------------------------
    # Visualization hook (train.py:550-708)
    # ------------------------------------------------------------------

    def _cache_vis_samples_av(self, n: int):
        ds = self.val_av_dataset or self.av_dataset
        n = min(n, len(ds))
        items = [ds.__getitem__(i, apply_augmentation=False) for i in range(n)]
        return items

    def _cache_vis_samples_tv(self, n: int):
        ds = self.val_tv_dataset or self.tv_dataset
        n = min(n, len(ds))
        return [ds.__getitem__(i, apply_augmentation=False) for i in range(n)]

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(self.device)

    def visualize_samples(self, epoch: int, max_samples: int = 4) -> None:
        from triad_tpu_torch.data.audio import pad_or_trim

        t0 = time.perf_counter()
        phase, _, _ = self.phase_for_epoch(epoch)
        viz_dir = self.output_dir / "viz" / f"epoch_{epoch}"
        viz_dir.mkdir(parents=True, exist_ok=True)
        model = self.model

        @torch.inference_mode()
        def sim_av(frame, audio):
            a = model.encode_audio(self._on_device(audio))
            v = model.encode_visual(self._on_device(frame))
            return pairwise_similarity(a, v, model.temperature)[0].cpu().numpy()

        if phase != "tv_warmup":
            for i, item in enumerate(self._vis_samples_av[:max_samples]):
                audio = pad_or_trim(
                    item["audio"], self.config.data.audio_num_samples
                )
                self.audio_viz.plot_audio_token_attentions(
                    sim_av, item["video_frames"], audio,
                    str(viz_dir / f"av_{i}.png"), num_tokens_to_show=8,
                )
                self.metrics.log_image(
                    f"viz_av_{i}", str(viz_dir / f"av_{i}.png"),
                    step=self.progress.global_step,
                )
                if i == 0:
                    # attention mp4 with the original audio muxed when the
                    # source file + ffmpeg exist (train.py:658-680).
                    src = item.get("video_path")
                    self.video_writer = self.audio_viz.make_attention_video(
                        sim_av, item["video_frames"], audio,
                        str(viz_dir / "av_0_attention.mp4"),
                        video_path=src if src and not str(src).startswith("synthetic") else None,
                    )
                    self.metrics.log_video(
                        "viz_av_0_attention",
                        str(viz_dir / "av_0_attention.mp4"),
                        step=self.progress.global_step,
                    )

        @torch.inference_mode()
        def sim_tv(frame, text):
            ids, mask = self.tokenizer.encode_batch(
                [text], max_length=self.config.data.max_text_tokens,
                pad_to=self.config.data.max_text_tokens,
            )
            t = model.encode_text(self._on_device(ids), self._on_device(mask))
            v = model.encode_visual(self._on_device(frame))
            sims = pairwise_similarity(t, v, model.temperature)[0].cpu().numpy()
            n_valid = int(mask.sum())
            tokens = self.tokenizer.tokenize(text)[:n_valid]
            return sims[:n_valid], tokens

        if phase != "av_focus":
            for i, (img, caption) in enumerate(self._vis_samples_tv[:max_samples]):
                if not caption:
                    continue
                self.text_viz.plot_token_attentions(
                    sim_tv, img, caption, str(viz_dir / f"tv_{i}.png")
                )
                self.metrics.log_image(
                    f"viz_tv_{i}", str(viz_dir / f"tv_{i}.png"),
                    step=self.progress.global_step,
                )
        self.timings["viz"].append(time.perf_counter() - t0)
        self.metrics.info(f"Wrote visualizations to {viz_dir}")
