"""triad_tpu_torch — the PyTorch + CUDA port of triad_tpu, for one NVIDIA
H100 (sm_90a).

The JAX package ``triad_tpu`` stays the reference; this package imports
``torch`` and nothing of ``jax``, ``flax`` or ``triad_tpu``: it keeps its
own copies of the host code it needs (the config dataclasses, the
WordPiece tokenizer, the HTTP handler).

Layout (mirrors ``triad_tpu``):
  config.py   the config dataclasses and presets
  kernels.py  nvcc build of csrc/*.cu into one ctypes library, launch counts
  csrc/       hand-written CUDA kernels (eval attention with its head-pair
              mode, training attention with dropout, fused MLP forward and
              backward with dropout, dropout + add + LayerNorm, the
              positional grouped conv, the frontend, the frontend conv with
              its input activation fused, the max-mean aggregation)
  ops/        kernel wrappers with their plain PyTorch twins, the dropout
              keep mask, similarity and max-mean aggregation, losses
  models/     nn.Module encoders, TriadModel, the Flax <-> torch converter
  train/      the 4-group optimizer bank, the train steps, checkpoints
              (torch files, exact mid-epoch resume) and the Trainer
  serve/      ServingModel and the HTTP server
  data/       the host data layer: decode, datasets, TriadPack shards,
              loaders, the pinned-memory prefetcher, device augmentation
  eval/       the 1000-way cross-modal retrieval
  utils/      the metrics logger, the step timer and profiler trace, the
              NaN guards
  viz/        the grounding heatmaps and the attention video
  cli/        ``python -m triad_tpu_torch.cli.{train,eval,serve}``

Ported so far (ROADMAP.md): the serving (eval) path, the three train
steps of the curriculum ("av", "tv", "joint"), the 1000-way retrieval
eval, the host data layer and the Trainer with its checkpoints, viz and
the train / eval commands; every TPU kernel of the JAX package has its
CUDA counterpart.
"""

__version__ = "0.1.0"
