"""Export a trained run to a self-contained serving bundle (the port of
``triad_tpu/cli/export.py``).

  python -m triad_tpu_torch.cli.export --run-dir ./outputs_triad_tpu \
      --out ./bundle [--best] [--int8] [--platforms cpu,cuda]

  # smoke mode (no checkpoint):
  python -m triad_tpu_torch.cli.export --random-init [--config cfg.yaml] --out ./bundle

The bundle (``serve/export.py``) carries one ``torch.export`` program per
endpoint and platform (audio / visual / text embedding with a symbolic
batch, and the retrieval pair scorer), the WordPiece vocab and metadata;
serve it with ``python -m triad_tpu_torch.cli.serve --bundle ./bundle``.
``--run-dir`` restores the run's latest checkpoint (``--best``: its
``best/``) through the Trainer, with the run's tokenizer; ``--random-init``
draws the weights from a generator seeded 0 on the device, with a
placeholder vocab. A config with an explicit kernel knob (e.g.
``perf_train_model_config()``) is refused, as in the JAX package: a bundle
runs no hand-written kernel. The weights are restored or drawn on the card
unless ``--device cpu`` is given; exporting for "cuda" needs a card.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Export; returns the bundle's path."""
    from triad_tpu_torch.cli.common import add_device_arg, resolve_device

    p = argparse.ArgumentParser(description="export a serving bundle")
    p.add_argument("--run-dir", help="training output dir (checkpoint)")
    p.add_argument(
        "--random-init", action="store_true",
        help="fresh parameters instead of a checkpoint (smoke mode)",
    )
    p.add_argument("--config", help="YAML/JSON config (with --random-init)")
    p.add_argument("--out", required=True, help="bundle output dir")
    p.add_argument(
        "--best", action="store_true",
        help="export the best checkpoint instead of the latest",
    )
    p.add_argument("--int8", action="store_true",
                   help="int8 serving mode for Dense matmuls")
    p.add_argument(
        "--platforms", default="cpu,cuda",
        help="comma-separated platforms to trace for (default cpu,cuda)",
    )
    add_device_arg(p)

    args = p.parse_args(argv)
    if not args.run_dir and not args.random_init:
        p.error("--run-dir or --random-init is required")
    device = resolve_device(args)

    import torch

    from triad_tpu_torch.config import Config
    from triad_tpu_torch.parallel.tp import resolve_xla_impls
    from triad_tpu_torch.serve.export import export_bundle

    if args.run_dir:
        from triad_tpu_torch.train.checkpoint import read_run_meta

        config = Config.from_dict(read_run_meta(args.run_dir)["config"])
    elif args.config:
        from triad_tpu_torch.cli.train import load_config_file

        config = Config.from_dict(load_config_file(args.config))
    else:
        config = Config()
    # Refuse a config with a kernel knob before building anything.
    resolve_xla_impls(config.model)
    if args.run_dir:
        from triad_tpu_torch.train.trainer import Trainer

        trainer = Trainer(config, force_new_training=False, device=device)
        if args.best:
            trainer.ckpt.restore_best(trainer.state)
        model, vocab = trainer.model, trainer.tokenizer.vocab
    else:
        from triad_tpu_torch.data.tokenizer import WordPieceTokenizer
        from triad_tpu_torch.models.convert import init_triad_model

        model = init_triad_model(config.model, torch.Generator(device=device).manual_seed(0),
                                 device=device)
        vocab = WordPieceTokenizer.build_from_corpus(
            ["a placeholder vocabulary for smoke exports"]
        ).vocab

    out = export_bundle(
        model,
        config.model,
        args.out,
        audio_num_samples=config.data.audio_num_samples,
        max_text_tokens=config.data.max_text_tokens,
        vocab=vocab,
        int8=args.int8,
        platforms=tuple(args.platforms.split(",")),
    )
    print(f"exported serving bundle -> {out}")
    return out


if __name__ == "__main__":
    main()
