"""device_idle_pct: the share of the run's own (untraced) window in which
no kernel, memcpy or memset ran on the card: one less the device's busy
time a step (the union of the traced window's device intervals, over its
steps) over the untraced window's time a step. A trace slows the host
that launches the kernels, not the kernels, so the traced window's own
idle share (``device.busy_s`` against ``device.window_s``) reads higher.
Moves samples_per_s."""


def read(run):
    d, w = run.digest, run.untraced
    if d.busy_s <= 0 or not run.steps or not w.steps or w.seconds <= 0:
        return None
    idle = 100.0 * (1.0 - (d.busy_s / run.steps) / (w.seconds / w.steps))
    if idle <= 0:
        run.log(f"device_idle_pct: {d.busy_s / run.steps:.4f} s busy a traced step, over the "
                f"untraced step's {w.seconds / w.steps:.4f} s: not read")
        return None
    return idle
