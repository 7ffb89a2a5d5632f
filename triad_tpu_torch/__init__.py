"""triad_tpu_torch — the PyTorch + CUDA port of triad_tpu, for one NVIDIA
H100 (sm_90a).

The JAX package ``triad_tpu`` stays the reference; this package imports
``torch`` and nothing of ``jax``, ``flax`` or ``triad_tpu``: it keeps its
own copies of the host code it needs (the config dataclasses, the
WordPiece tokenizer, the HTTP handler).

Layout (mirrors ``triad_tpu``):
  config.py   the config dataclasses and presets
  kernels.py  nvcc build of csrc/*.cu into one ctypes library, launch counts
  csrc/       hand-written CUDA kernels (eval and training attention with
              dropout, fused MLP forward and backward with dropout, dropout +
              add + LayerNorm, the positional grouped conv, the frontend)
  ops/        kernel wrappers with their plain PyTorch twins, the dropout
              keep mask, similarity and max-mean aggregation, losses
  models/     nn.Module encoders, TriadModel, the Flax <-> torch converter
  train/      the 4-group optimizer bank and the train steps
  serve/      ServingModel and the HTTP server
  data/       the WordPiece tokenizer
  cli/        ``python -m triad_tpu_torch.cli.serve``

Ported so far (ROADMAP.md): the serving (eval) path and the three train
steps of the curriculum ("av", "tv", "joint").
"""

__version__ = "0.1.0"
