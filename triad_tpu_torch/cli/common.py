"""Shared CLI plumbing: the device flag (the port's ``--device`` in place
of the JAX package's ``--platform``)."""

from __future__ import annotations

import argparse

import torch


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the model runs: cuda (default; fails without a card) or cpu",
    )


def resolve_device(args: argparse.Namespace) -> str:
    """The device an entry point runs on; ``cuda`` without a card raises
    rather than carrying on on the CPU."""
    device = getattr(args, "device", None) or "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    return device
