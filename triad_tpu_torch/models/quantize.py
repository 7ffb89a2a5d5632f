"""Opt-in int8 serving mode (the port of ``triad_tpu/models/quantize.py``):
run a trained TriadModel with every Dense product in int8, without
touching model code or checkpoints.

While ``int8_interception()`` is active, ``models/layers.py:Dense`` and
``LoRALinear`` run ``ops/quant.py:int8_dense`` (LoRA folded into the
weight first in fp32) and cast the result back to their input's dtype:
the products the JAX package's interceptor swaps (its ``nn.Dense`` and
``LoRADense`` calls). A flag that those two forwards read stands in for
Flax's method interception; nothing of torch is patched. The flag is a
context variable, so only the forwards run in the caller's own thread
(or task) inside the context go int8: another thread's forward, say a
server's, stays float. Attention
score/value contractions and the conv frontends stay in float, and so do
routes that hand raw weights to a kernel, as in the JAX package: the
fused MLP and HuBERT's merged qkv (which raises rather than run float
while int8 is asked for).

Usage::

    from triad_tpu_torch.models.quantize import int8_interception

    with int8_interception(), torch.inference_mode():
        out = model.inference_forward(images, audio, ids, mask)
"""

from __future__ import annotations

import contextlib
import contextvars

__all__ = ["int8_active", "int8_interception"]

_active_depth = contextvars.ContextVar("int8_active_depth", default=0)


def int8_active() -> bool:
    """True inside an int8_interception() context.

    Model code whose products CANNOT be intercepted (raw weights feeding
    kernels, e.g. HuBERT's merged-qkv attention) checks this to raise
    loudly instead of silently shrinking the int8 coverage."""
    return _active_depth.get() > 0


@contextlib.contextmanager
def int8_interception():
    """Context manager: every Dense / LoRALinear product run inside it
    runs in int8 (dynamic per-token activations, per-channel weights)."""
    token = _active_depth.set(_active_depth.get() + 1)
    try:
        yield
    finally:
        _active_depth.reset(token)
