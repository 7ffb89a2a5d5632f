"""copy_ms_per_step: device ms of the copies and casts in the traced
window, over its steps: the kernels whose name holds one of PATTERNS
(case ignored): PyTorch's copy kernel, which every ``.to(dtype)``,
``.contiguous()`` and ``copy_`` runs, its batched copy under
``torch.cat``, and the memcpy engine's device-to-device copies. Moves
samples_per_s."""

PATTERNS = ("direct_copy_kernel", "CatArrayBatchedCopy")


def read(run):
    if not run.steps:
        return None
    d = run.digest
    ms = 1e3 * (d.seconds(PATTERNS) + sum(
        s for name, s in d.transfers.items() if "dtod" in name.lower()))
    return ms / run.steps if ms > 0 else None
