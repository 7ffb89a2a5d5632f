"""triad_tpu_torch — the PyTorch + CUDA port of triad_tpu, for one NVIDIA
H100 (sm_90a).

The JAX package ``triad_tpu`` stays the reference; this package imports
``torch`` and never ``jax`` or ``flax``. It shares the JAX package's
host code that imports no JAX: ``triad_tpu.core.config`` (the config
dataclasses), ``triad_tpu.data.tokenizer`` and the HTTP handler of
``triad_tpu.serve.server``.

Layout (mirrors ``triad_tpu``):
  kernels.py  nvcc build of csrc/*.cu into one ctypes library, launch counts
  csrc/       hand-written CUDA kernels (eval attention, fused MLP, frontend)
  ops/        kernel wrappers with their plain PyTorch twins, similarity
  models/     nn.Module encoders, TriadModel, the Flax <-> torch converter
  serve/      ServingModel and the HTTP server
  cli/        ``python -m triad_tpu_torch.cli.serve``

This first slice is the serving (eval) path; training is not ported yet
(ROADMAP.md).
"""

__version__ = "0.1.0"
