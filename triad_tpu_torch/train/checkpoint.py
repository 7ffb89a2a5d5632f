"""Checkpoints with the reference's resume-exactness contract (the port
of ``triad_tpu/train/checkpoint.py``, torch files in place of Orbax).

The reference persists a monolithic torch dict (train.py:398-437): model,
4 optimizers + schedulers + per-group step counters, epoch / global step
/ mid-epoch batch offset, dataset segment, full RNG state, best loss,
config, and cached viz samples; autoresume picks the latest by filename
parse (train.py:382-396) and restores everything, then fast-forwards the
dataloaders batch-by-batch (train.py:914-926).

Here a checkpoint is a directory ``ckpts/<step>/`` holding
  * ``state.pt`` (``torch.save``): the model's state dict, each group's
    AdamW state dict, ``OptimizerBank.counts``, ``TrainState.global_step``
    and ``seed``, and the ``.grad`` of every parameter that holds one (a
    save inside a gradient-accumulation window resumes exactly);
  * ``meta.json``: the host progress (epoch, batch cursor, dataset
    segment, best loss), the config and any extra entries.
Both are written into a hidden temporary directory that is renamed into
place, so a killed process never leaves tensors without their metadata,
nor a half-written step that ``latest_step`` would pick: the rename is
the commit, as Orbax's ``Composite`` save is (no fsync: a kill of the
process is covered, a power loss is not). Data-order exactness needs no
RNG blob: the loaders derive their permutation and draws from (seed,
epoch, batch, idx) and jump to the batch cursor in O(1)
(``data/pipeline.py``); the dropout draws come from (seed, global_step)
(``train/step.py``).

``best/`` holds the best checkpoint apart from the ``max_to_keep``
collection: a hard link of the step's ``state.pt`` (a copy where the
file system has no links) and its ``meta.json``.

A data-parallel run writes the files a one-process run writes: every
rank gathers the ZeRO-1 moment slices and the tensor-parallel and FSDP
slices of the parameters, their moments and gradients into whole tensors
and sums its share of the accumulated gradients with the others'; rank 0
alone writes and commits, and the others wait at a barrier. A restore
loads the whole state on every rank and keeps each rank's slices (by the
live run's layout), with the summed gradients on the first rank of the
ranks they are summed over (zeros elsewhere: the next reduction adds
them), so a run resumes in any world size, ``tp`` or ``fsdp``.

The port reads only its own checkpoints: the Orbax checkpoints of JAX
runs would need JAX to read (ROADMAP.md, the weight importers).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from triad_tpu_torch.parallel import collectives as C
from triad_tpu_torch.parallel.distributed import coordination_barrier

STATE_FILE, META_FILE = "state.pt", "meta.json"


@dataclasses.dataclass
class HostProgress:
    """Host-side training cursor (reference train.py:469-473)."""

    epoch: int = 0
    global_step: int = 0
    current_batch_idx: int = 0
    dataset_segment: int = 0
    best_loss: float = float("inf")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HostProgress":
        return cls(**d)


def _to_host(x):
    """Tensors of a nested state dict copied to the host (a detached copy
    even of a CPU tensor, so later in-place updates do not reach it)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def state_payload(train_state) -> Dict[str, Any]:
    """What a checkpoint holds of a TrainState (``train/step.py``), copied
    to the host: whole AdamW states and the gradients summed over the
    ranks (a collective in a data-parallel run: every rank calls it)."""
    bank = train_state.bank
    return _to_host({
        "model": bank.model_state_dict(),
        "opts": bank.full_state_dicts(),
        "counts": dict(bank.counts),
        "grads": bank.summed_grads(),
        "global_step": int(train_state.global_step),
        "seed": int(train_state.seed),
    })


def load_payload(train_state, payload: Dict[str, Any]):
    """Load a checkpoint's payload into a live TrainState, in place, on
    its device; parameters without a saved gradient get ``.grad`` None.
    A data-parallel rank keeps its slices; the saved gradients go to the
    first rank of those they are summed over, zeros to the others."""
    bank = train_state.bank
    bank.load_model_state_dict(payload["model"])
    bank.load_full_state_dicts(payload["opts"])
    bank.counts = dict(payload["counts"])
    bank.load_grads(payload["grads"])
    train_state.global_step = int(payload["global_step"])
    train_state.seed = int(payload["seed"])
    return train_state


class CheckpointManager:
    """Latest/best checkpoint management for a TrainState + host progress.

    ``async_save=True``: ``save`` copies the state to the host and returns;
    a thread writes the files, commits the step by rename and collects
    old steps. One write is in flight at a time (a new save waits for the
    last); ``wait_until_finished``, ``latest_step``, ``restore`` and
    ``close`` drain it first, and re-raise its error. ``timings`` holds,
    per save, the seconds of its blocking part and of its write.

    In a data-parallel run every rank makes the manager and calls save
    (the state is gathered from all of them); rank 0 writes, and every
    rank meets the others at a barrier once the write has committed (in
    ``wait_until_finished`` for an async save)."""

    def __init__(
        self, directory: str, max_to_keep: int = 3, async_save: bool = False
    ):
        self.primary = C.rank() == 0
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self._steps_dir = self.directory / "ckpts"
        self._steps_dir.mkdir(exist_ok=True)
        self._best_dir = self.directory / "best"
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False  # a save whose commit the ranks have not met at
        self.timings: List[Dict[str, float]] = []

    # -- save -----------------------------------------------------------

    def save(
        self,
        step: int,
        train_state: Any,
        progress: HostProgress,
        config_dict: Dict[str, Any],
        extra: Optional[Dict[str, Any]] = None,
        is_best: bool = False,
    ) -> None:
        self.wait_until_finished()
        t0 = time.perf_counter()
        meta = {
            "progress": progress.to_dict(),
            "config": config_dict,
            "extra": extra or {},
        }
        payload = state_payload(train_state)
        timing = {"step": step, "block_s": 0.0, "write_s": 0.0}
        self.timings.append(timing)
        if not self.primary:  # rank 0 writes; meet it once it has committed
            self._pending = True
            if not self.async_save:
                self.wait_until_finished()
            return
        if not self.async_save:
            self._write(step, payload, meta, is_best, timing)
            self._pending = True
            self.wait_until_finished()
            timing["block_s"] = time.perf_counter() - t0
            return
        timing["block_s"] = time.perf_counter() - t0
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, payload, meta, is_best, timing),
            name=f"checkpoint-{step}", daemon=True)
        self._thread.start()
        self._pending = True

    def _write_guarded(self, *args) -> None:
        try:
            self._write(*args)
        except Exception as e:  # noqa: BLE001 — re-raised by wait_until_finished
            self._error = e

    def _write(self, step: int, payload, meta, is_best: bool, timing) -> None:
        t0 = time.perf_counter()
        final = self._steps_dir / str(step)
        tmp = self._steps_dir / f".tmp-{step}-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(payload, tmp / STATE_FILE)
        (tmp / META_FILE).write_text(json.dumps(meta, indent=2))
        _replace_dir(tmp, final)
        self._collect()
        if is_best:
            self._save_best(final, meta)
        timing["write_s"] = time.perf_counter() - t0

    def _save_best(self, step_dir: Path, meta: Dict[str, Any]) -> None:
        tmp = self.directory / f".tmp-best-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        try:
            os.link(step_dir / STATE_FILE, tmp / STATE_FILE)
        except OSError:
            shutil.copy2(step_dir / STATE_FILE, tmp / STATE_FILE)
        (tmp / META_FILE).write_text(json.dumps(meta, indent=2))
        _replace_dir(tmp, self._best_dir)

    def _collect(self) -> None:
        """Keep the newest ``max_to_keep`` steps (best/ is apart)."""
        if self.max_to_keep is None:
            return
        steps = self.all_steps()
        for step in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(self._steps_dir / str(step), ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Block until any in-flight async save has committed — call
        before process exit so the writer thread never races interpreter
        shutdown."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            coordination_barrier("checkpoint committed")
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("an async checkpoint save failed") from err

    # -- restore --------------------------------------------------------

    def all_steps(self) -> List[int]:
        """Committed steps, oldest first (temporary directories are not
        steps)."""
        return sorted(int(p.name) for p in self._steps_dir.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read_meta(self, step: int) -> Dict[str, Any]:
        return json.loads((self._steps_dir / str(step) / META_FILE).read_text())

    def _load(self, directory: Path, train_state) -> Dict[str, Any]:
        # Read to the host: load_state_dict moves each tensor to its
        # parameter's device, and keeps AdamW's step counts on the host
        # where torch keeps them (a step count on the card would make
        # every update read it back).
        payload = torch.load(directory / STATE_FILE, map_location="cpu", weights_only=True)
        load_payload(train_state, payload)
        return json.loads((directory / META_FILE).read_text())

    def restore(
        self, train_state: Any, step: Optional[int] = None
    ) -> Tuple[Any, HostProgress, Dict[str, Any], Dict[str, Any]]:
        """Returns (train_state, progress, config_dict, extra).

        ``train_state`` is the live TrainState; the checkpoint is loaded
        into it in place, on the device its model lives on."""
        self.wait_until_finished()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        directory = self._steps_dir / str(step)
        if not directory.is_dir():
            raise FileNotFoundError(f"no checkpoint of step {step} in {self.directory}")
        meta = self._load(directory, train_state)
        # Config travels inside the checkpoint (train.py:427, 475-498):
        # the caller compares against its live config and warns.
        return (
            train_state,
            HostProgress.from_dict(meta["progress"]),
            meta["config"],
            meta.get("extra", {}),
        )

    def restore_best(self, train_state: Any):
        self.wait_until_finished()
        meta = self._load(self._best_dir, train_state)
        return train_state, HostProgress.from_dict(meta["progress"]), meta["config"]

    def close(self) -> None:
        self.wait_until_finished()


def _replace_dir(src: Path, dst: Path) -> None:
    """Rename ``src`` to ``dst``; an existing ``dst`` is moved aside first
    and removed after, so ``dst`` is never half-written."""
    old = None
    if dst.exists():
        old = dst.with_name(f".old-{dst.name}-{os.getpid()}")
        shutil.rmtree(old, ignore_errors=True)
        os.rename(dst, old)
    os.rename(src, dst)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def read_run_meta(run_dir: str) -> Dict[str, Any]:
    """Latest checkpoint's metadata (progress/config/extra) of a run
    directory, without constructing a TrainState — the CLI entry points'
    config-discovery path (eval)."""
    mgr = CheckpointManager(str(Path(run_dir) / "checkpoints"))
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {run_dir}")
    try:
        return mgr._read_meta(step)
    finally:
        mgr.close()


def warn_on_config_mismatch(
    saved: Dict[str, Any], live: Dict[str, Any], logger=print
) -> None:
    """Phase/config mismatch warnings on resume (train.py:475-498)."""
    keys = set(saved) | set(live)
    for k in sorted(keys):
        if saved.get(k) != live.get(k):
            logger(
                f"WARNING: config mismatch on resume: {k!r} "
                f"checkpoint={saved.get(k)!r} current={live.get(k)!r}"
            )
