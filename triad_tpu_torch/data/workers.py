"""Decode-worker pools for the input pipeline: the port's copy of
``triad_tpu/data/workers.py``.

The reference gets decode parallelism from torch DataLoader worker
*processes* (train.py:157-181: 10 workers). The thread pool used by the
loaders is fine when decode releases the GIL (PIL/ffmpeg C code) but
GIL-bound for pure-Python work; this module provides a persistent
process pool with the same ``map(indices) -> items`` surface so the
loaders can scale sample decode across host cores (SURVEY §7.3 item 5:
5k clips/sec of decode is a host-side problem).

The dataset object is shipped once to each worker at pool start
(spawn context — safe with a CUDA context in the parent, which fork
would corrupt); per-batch traffic is only (index, augment) tuples out
and pickled numpy items back.
"""

from __future__ import annotations

import multiprocessing as mp
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Sequence

import numpy as np

_WORKER_DATASET: Any = None


def _init_worker(dataset: Any) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _load_item(args) -> Any:
    idx, augment, seed = args
    rng = None if seed is None else np.random.default_rng(seed)
    return _WORKER_DATASET.__getitem__(
        int(idx), apply_augmentation=augment, rng=rng
    )


class WorkerPool:
    """Persistent decode pool: ``mode`` = "thread" (default; in-process,
    zero copy) or "process" (spawned workers; true CPU parallelism for
    python-heavy decode). Both preserve input order."""

    def __init__(self, dataset: Any, num_workers: int, mode: str = "thread"):
        if mode not in ("thread", "process"):
            raise ValueError(f"unknown worker mode {mode!r}")
        self.dataset = dataset
        self.num_workers = max(1, num_workers)
        self.mode = mode
        self._pool = None

    def _ensure(self):
        if self._pool is None:
            if self.mode == "process":
                ctx = mp.get_context("spawn")
                self._pool = ctx.Pool(
                    self.num_workers,
                    initializer=_init_worker,
                    initargs=(self.dataset,),
                )
            else:
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        return self._pool

    def map(self, indices: Sequence[int], augment: bool,
            seeds: Optional[Sequence] = None) -> List[Any]:
        """``seeds``: optional per-item augmentation-RNG seeds (any
        np.random.default_rng-accepted seed, e.g. (seed, epoch, batch,
        idx) tuples) — deterministic augmentation for exact resume."""
        pool = self._ensure()
        if seeds is None:
            seeds = [None] * len(indices)
        args = [(int(i), augment, s) for i, s in zip(indices, seeds)]
        if self.mode == "process":
            return pool.map(_load_item, args)
        # Thread mode: bind the dataset locally (the module global would
        # be racy across concurrently-prefetching loaders).
        ds = self.dataset

        def load(a):
            idx, aug, seed = a
            rng = None if seed is None else np.random.default_rng(seed)
            return ds.__getitem__(idx, apply_augmentation=aug, rng=rng)

        return list(pool.map(load, args))

    def close(self) -> None:
        if self._pool is None:
            return
        if self.mode == "process":
            self._pool.terminate()
            self._pool.join()
        else:
            self._pool.shutdown(wait=False)
        self._pool = None

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass
