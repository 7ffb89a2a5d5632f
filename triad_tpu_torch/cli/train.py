"""Training CLI (the port of ``triad_tpu/cli/train.py``): a YAML/JSON
config file + dotted overrides, synthetic-data mode for smoke runs.

  python -m triad_tpu_torch.cli.train --config cfg.json
  python -m triad_tpu_torch.cli.train --synthetic --steps 5 --output-dir /tmp/run
  python -m triad_tpu_torch.cli.train --set train.num_epochs=3 data.batch_size_av=16
  python -m triad_tpu_torch.cli.train --device cpu --synthetic --steps 2 ...

Trains on the card unless ``--device cpu`` is given. A run resumes from
the latest checkpoint in its output directory unless ``--force-new``.
``--synthetic`` clears the config's data paths, so the synthetic
datasets are used whatever the config file names.

Data-parallel: one process per device, with ``mesh.num_devices`` set to
their number, launched by torchrun or by the JAX package's variables:

  python -m torch.distributed.run --nproc_per_node 2 -m triad_tpu_torch.cli.train \
      --config cfg.json --set mesh.num_devices=2
  TRIAD_COORDINATOR=host:port TRIAD_NUM_PROCESSES=2 TRIAD_PROCESS_ID=<i> \
      python -m triad_tpu_torch.cli.train --config cfg.json --set mesh.num_devices=2

``TRIAD_DIST_BACKEND`` names the backend (default nccl on the card, gloo
with ``--device cpu``). Every process writes to one output directory,
through rank 0 (``parallel/distributed.py``). Tensor parallelism and FSDP
take the same launch: ``--set mesh.num_devices=2 mesh.tp=2`` (add
``mesh.num_slices=2`` at four processes for the (replica, data, model)
mesh) or ``--set mesh.num_devices=2 mesh.fsdp=true``.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict

_DATA_PATHS = ("audio_visual_data_root", "text_dataset_path", "audio_visual_val_data_root",
               "text_dataset_val_path")


def load_config_file(path: str) -> Dict[str, Any]:
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path) as f:
            return yaml.safe_load(f)
    with open(path) as f:
        return json.load(f)


def apply_overrides(cfg_dict: Dict[str, Any], overrides) -> Dict[str, Any]:
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        if not _:
            raise ValueError(f"override must be key=value, got {ov!r}")
        node = cfg_dict
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node[parts[-1]] = value
    return cfg_dict


def build_config(args) -> "Config":
    from triad_tpu_torch.config import Config

    cfg_dict = load_config_file(args.config) if args.config else {}
    cfg_dict = apply_overrides(cfg_dict, args.set)
    if args.output_dir:
        cfg_dict.setdefault("train", {})["output_dir"] = args.output_dir
    if args.steps:
        cfg_dict.setdefault("train", {})["steps_per_epoch"] = args.steps
    if getattr(args, "synthetic", False):
        cfg_dict.setdefault("data", {}).update({k: None for k in _DATA_PATHS})
    base = Config().to_dict()
    _deep_update(base, cfg_dict)
    return Config.from_dict(base)


def _deep_update(base: Dict[str, Any], new: Dict[str, Any]) -> None:
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v


def main(argv=None):
    """Train; returns the Trainer (its state, metrics and timings)."""
    from triad_tpu_torch.cli.common import add_device_arg, resolve_device

    parser = argparse.ArgumentParser(description="Train the triad_tpu_torch model")
    parser.add_argument("--config", help="YAML/JSON config file")
    parser.add_argument(
        "--set", nargs="*", metavar="KEY=VALUE",
        help="dotted config overrides, e.g. train.num_epochs=3",
    )
    parser.add_argument("--output-dir", help="output directory override")
    parser.add_argument(
        "--synthetic", action="store_true",
        help="use synthetic data (the config's data paths are ignored)",
    )
    parser.add_argument("--steps", type=int, help="steps per epoch override")
    parser.add_argument(
        "--force-new", action="store_true", help="ignore existing checkpoints"
    )
    add_device_arg(parser)

    args = parser.parse_args(argv)
    device = resolve_device(args)
    config = build_config(args)
    from triad_tpu_torch.parallel.distributed import initialize_from_env, process_device
    from triad_tpu_torch.train.trainer import Trainer

    initialize_from_env(device)
    trainer = Trainer(config, force_new_training=args.force_new,
                      device=process_device(device))
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
