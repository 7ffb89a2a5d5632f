"""Retrieval evaluation CLI (the port of ``triad_tpu/cli/eval.py``): load
a run's checkpoint, run the 1000-way cross-modal retrieval (R@1/5/10/20,
A<->V and T<->V) and print/save the metrics — the reference's
eval_1000_way_retrieval surface (train.py:835-874) as a standalone
command. The config comes from the checkpoint's metadata.

  python -m triad_tpu_torch.cli.eval --run-dir ./outputs_triad_tpu [--best] [--out m.json]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None):
    """Print (and with ``--out`` write) the metrics; returns them."""
    from triad_tpu_torch.cli.common import add_device_arg, resolve_device

    parser = argparse.ArgumentParser(description="1000-way retrieval eval")
    parser.add_argument("--run-dir", required=True, help="training output dir")
    parser.add_argument(
        "--best", action="store_true", help="evaluate the best checkpoint"
    )
    parser.add_argument("--out", help="write metrics JSON here")
    add_device_arg(parser)

    args = parser.parse_args(argv)
    device = resolve_device(args)

    from triad_tpu_torch.config import Config
    from triad_tpu_torch.train.checkpoint import read_run_meta
    from triad_tpu_torch.train.trainer import Trainer

    # Config travels inside the checkpoint metadata.
    meta = read_run_meta(args.run_dir)
    config = Config.from_dict(meta["config"])

    trainer = Trainer(config, force_new_training=False, device=device)
    if args.best:
        state, _, _ = trainer.ckpt.restore_best(trainer.state)
        trainer.state = state
    metrics = trainer.eval_1000_way_retrieval()
    print(json.dumps(metrics, indent=2, sort_keys=True))
    if args.out:
        Path(args.out).write_text(json.dumps(metrics, indent=2, sort_keys=True))
    return metrics


if __name__ == "__main__":
    main()
