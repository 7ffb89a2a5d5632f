"""nn.Module encoders of the port (mirroring ``triad_tpu/models``).

Configs are the JAX package's dataclasses (``triad_tpu.core.config``,
through ``triad_tpu_torch.config``), used as they are. Some of their fields choose TPU tilings, not
semantics; the port accepts them and ignores them (IGNORED_TPU_KNOBS).
"""

# Config fields that only choose a TPU tiling or layout (VMEM block rows,
# token padding, waveform wire layout, frontend block size). They do not
# change what a model computes, and the CUDA kernels choose their own
# tiles, so the port reads none of them.
IGNORED_TPU_KNOBS = (
    "frontend_wave_layout",
    "frontend_tb",
    "mlp_block_rows",
    "ln_block_rows",
    "attention_pad",
)
