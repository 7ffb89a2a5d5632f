"""Readings the correctness limits are set from, on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--fault-seeds 7,8,9]

For each seed of ``--seeds`` the program's sound readings (set-up and the
checked micro steps, as a run makes them, no window) against the fp32
reference; for each of ``--control-seeds`` the control (the reference in
float8 e4m3 products) against it; for each of ``--fault-seeds`` every
fault of ``faults.py`` planted under the program. One line of JSON per
reading, on standard output. One process: the kernels are built and
loaded once.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import check  # noqa: E402
import faults  # noqa: E402
import harness  # noqa: E402


def _program(cell, seed, device, breaker=None):
    state, step, ring, prog = harness.prepare(cell, seed, device, breaker)
    del state, step, ring
    gc.collect()
    torch.cuda.empty_cache()
    return prog


def _emit(cell, kind, seed, nums, t0, extra=None):
    row = {"cell": cell.name, "kind": kind, "seed": seed, "seconds": round(time.time() - t0, 1),
           **{k: v for k, (v, _) in nums.items()}, "where": {k: w for k, (_, w) in nums.items()}}
    row.update(extra or {})
    print(json.dumps(row), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    from triad_tpu_torch import kernels

    kernels.library()
    for seed in ints(args.seeds):
        t0 = time.time()
        prog = _program(cell, seed, device)
        ref = harness.reference_readings(cell, seed, device)
        _emit(cell, "program", seed, check.numbers(prog, ref), t0, {"losses": prog["losses"]})
    for seed in ints(args.control_seeds):
        t0 = time.time()
        ref = harness.reference_readings(cell, seed, device)
        ctl = harness.reference_readings(cell, seed, device, "fp8")
        _emit(cell, "control", seed, check.numbers(ctl, ref), t0)
    for seed in ints(args.fault_seeds):
        ref = harness.reference_readings(cell, seed, device)
        for name, breaker in faults.FAULTS.items():
            t0 = time.time()
            prog = _program(cell, seed, device, breaker)
            _emit(cell, "fault:" + name, seed, check.numbers(prog, ref), t0)


if __name__ == "__main__":
    main()
