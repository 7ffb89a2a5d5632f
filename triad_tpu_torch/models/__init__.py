"""nn.Module encoders of the port (mirroring ``triad_tpu/models``).

Configs are the port's copies of the JAX package's dataclasses
(``triad_tpu_torch.config``). Some of their fields choose TPU tilings,
not semantics; the port accepts them and ignores them
(IGNORED_TPU_KNOBS, defined in ``triad_tpu_torch/config.py``).
"""

from triad_tpu_torch.config import IGNORED_TPU_KNOBS  # noqa: F401
