"""triad_tpu_torch — the PyTorch + CUDA port of triad_tpu, for one NVIDIA
H100 (sm_90a).

The JAX package ``triad_tpu`` stays the reference; this package imports
``torch`` and never ``jax`` or ``flax``. It shares the JAX package's
host code that imports no JAX: ``triad_tpu.core.config`` (the config
dataclasses, through ``triad_tpu_torch.config``),
``triad_tpu.data.tokenizer`` and the HTTP handler of
``triad_tpu.serve.server``.

Layout (mirrors ``triad_tpu``):
  config.py   the config dataclasses and presets, shared by import
  kernels.py  nvcc build of csrc/*.cu into one ctypes library, launch counts
  csrc/       hand-written CUDA kernels (eval and training attention, fused
              MLP forward and backward, frontend)
  ops/        kernel wrappers with their plain PyTorch twins, similarity
              and max-mean aggregation, losses
  models/     nn.Module encoders, TriadModel, the Flax <-> torch converter
  train/      the 4-group optimizer bank and the train steps
  serve/      ServingModel and the HTTP server
  cli/        ``python -m triad_tpu_torch.cli.serve``

Ported so far (ROADMAP.md): the serving (eval) path, and training's
text-visual step. HuBERT's training mode, and with it the audio-visual
and joint steps, is not ported yet.
"""

__version__ = "0.1.0"
