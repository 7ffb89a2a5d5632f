"""Metrics/observability: JSONL + file log + optional wandb (the port's
copy of ``triad_tpu/utils/logging.py``).

The reference logs per-step dicts to wandb and a training.log file
(train.py:144-149, 1047-1092). Here every metric dict is appended to a
JSONL file (machine-readable, survives without network), mirrored to
python logging, and forwarded to wandb when the package and a run are
available (gated import). The one change from the JAX copy: the primary
process is rank 0 of ``torch.distributed`` when it is initialized, else
this process.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, Optional


def _to_jsonable(v: Any) -> Any:
    try:
        import numpy as np

        if isinstance(v, (np.generic,)):
            return v.item()
        if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
            return float(v.item())
    except Exception:  # noqa: BLE001
        pass
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    return str(v)


def process_rank() -> int:
    """This process's rank in ``torch.distributed``, 0 when it is not
    initialized."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class MetricsLogger:
    def __init__(
        self,
        output_dir: str,
        use_wandb: bool = False,
        project_name: str = "triad-tpu",
        run_name: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
    ):
        # Multi-process runs: metrics/artifacts are host-side effects —
        # only process 0 writes (every process computes the identical
        # device-side values; N copies of the same JSONL line are noise
        # at best and interleaved-write corruption at worst).
        try:
            self._primary = process_rank() == 0
        except Exception:  # noqa: BLE001 — logger must never hard-fail
            self._primary = True

        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl_path = self.output_dir / "metrics.jsonl"
        self._jsonl = (
            open(self.jsonl_path, "a", buffering=1) if self._primary
            else open(os.devnull, "w")
        )

        if self._primary:
            logging.basicConfig(
                filename=str(self.output_dir / "training.log"),
                level=logging.INFO,
                format="%(asctime)s - %(message)s",
            )
        self.logger = logging.getLogger("triad_tpu")

        self._wandb = None
        if use_wandb and self._primary:
            try:
                import wandb

                if wandb.run is None:
                    wandb.init(project=project_name, name=run_name, config=config)
                self._wandb = wandb
            except ImportError:
                self.logger.info("wandb not available; JSONL metrics only")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {k: _to_jsonable(v) for k, v in metrics.items()}
        if step is not None:
            record.setdefault("global_step", step)
        self._jsonl.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(record)

    def log_image(self, name: str, path: str,
                  step: Optional[int] = None) -> None:
        """Mirror a viz PNG into wandb (reference train.py:674-680,
        696-702 pushes heatmap images via wandb.Image). JSONL records
        the artifact path either way."""
        record: Dict[str, Any] = {f"{name}_path": str(path)}
        if step is not None:
            record["global_step"] = step
        self._jsonl.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log({name: self._wandb.Image(str(path))})

    def log_video(self, name: str, path: str,
                  step: Optional[int] = None) -> None:
        """Mirror an attention video into wandb (train.py:676-678)."""
        record: Dict[str, Any] = {f"{name}_path": str(path)}
        if step is not None:
            record["global_step"] = step
        self._jsonl.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log({name: self._wandb.Video(str(path))})

    def info(self, msg: str) -> None:
        self.logger.info(msg)
        if self._primary:
            print(msg, flush=True)

    def close(self) -> None:
        self._jsonl.close()
