"""step_mfu: the whole joint micro step's share of the card's bf16 peak.

The operations every step of the untraced window needed
(``costs.step_flops`` at the traffic's shapes, with the HuBERT layers its
layerdrop kept), over the peak times that window's seconds on the host's
clock: the run's own rate, which a profiler would slow. Moves
samples_per_s."""

import costs


def read(run):
    w = run.untraced
    if not w.steps or w.seconds <= 0:
        return None
    flops = sum(costs.step_flops(run.config, run.traffic, len(kept)) for kept in w.kept)
    return 100.0 * flops / (costs.PEAK_BF16 * w.seconds)
