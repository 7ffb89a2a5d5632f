"""Tri-modal inference CLI (the port of ``triad_tpu/cli/infer.py``): the
reference's generic ``model.forward`` surface (model.py:610-637) as a
standalone command — any subset of {image, media/audio, text} in,
per-modality token features plus all pairwise normalized similarity
matrices (including text<->audio) out.

  python -m triad_tpu_torch.cli.infer --run-dir ./outputs_triad_tpu \
      --image frame.jpg --media clip.mp4 --text "a dog barking" \
      --out sims.json

``--image`` accepts an image file (the reference's forward takes a
frame *path*, model.py:614-622); ``--media`` extracts the audio track of
a wav/mp4 (``data/audio.py:extract_audio``). ``--run-dir`` restores a
run's latest checkpoint through the Trainer; ``--random-init`` runs with
fresh parameters drawn from a generator seeded 0 (smoke mode, no
checkpoint needed; ``--config`` a YAML/JSON Config file). ``--int8`` runs
the Dense products in the int8 serving mode (``models/quantize.py``).
Feature arrays (fp32) go to ``--features-npz``; the JSON output carries
shapes and similarity-matrix summaries. Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path


def main(argv=None):
    """Print (and with ``--out`` write) the summary; returns it."""
    from triad_tpu_torch.cli.common import add_device_arg, resolve_device

    parser = argparse.ArgumentParser(description="tri-modal inference")
    parser.add_argument("--run-dir", help="training output dir (checkpoint)")
    parser.add_argument(
        "--random-init", action="store_true",
        help="fresh parameters instead of a checkpoint (smoke mode)",
    )
    parser.add_argument(
        "--config", help="YAML/JSON config file (with --random-init)"
    )
    parser.add_argument("--image", help="image file (jpg/png)")
    parser.add_argument("--media", help="wav/mp4 whose audio track to use")
    parser.add_argument("--text", help="caption text")
    parser.add_argument("--int8", action="store_true",
                        help="int8 serving mode for Dense matmuls")
    parser.add_argument("--out", help="write the JSON summary here")
    parser.add_argument("--features-npz", help="write feature arrays here")
    add_device_arg(parser)

    args = parser.parse_args(argv)
    if not (args.image or args.media or args.text):
        parser.error("at least one of --image/--media/--text is required")
    if not args.run_dir and not args.random_init:
        parser.error("--run-dir or --random-init is required")
    device = resolve_device(args)

    import numpy as np
    import torch

    from triad_tpu_torch.config import Config

    if args.run_dir:
        from triad_tpu_torch.train.checkpoint import read_run_meta
        from triad_tpu_torch.train.trainer import Trainer

        config = Config.from_dict(read_run_meta(args.run_dir)["config"])
        trainer = Trainer(config, force_new_training=False, device=device)
        model, tokenizer = trainer.model, trainer.tokenizer
    else:
        from triad_tpu_torch.data.tokenizer import WordPieceTokenizer
        from triad_tpu_torch.models.convert import init_triad_model

        if args.config:
            from triad_tpu_torch.cli.train import load_config_file

            config = Config.from_dict(load_config_file(args.config))
        else:
            config = Config()
        model = init_triad_model(config.model, torch.Generator(device=device).manual_seed(0),
                                 device=device)
        tokenizer = WordPieceTokenizer.build_from_corpus([args.text or "a"])

    images = audio = token_ids = attention_mask = None
    if args.image:
        from triad_tpu_torch.data.images import clean_image, load_image

        img = load_image(args.image, config.data.image_size)
        images = torch.from_numpy(clean_image(img)[None]).to(device)
    if args.media:
        from triad_tpu_torch.data.audio import extract_audio, pad_or_trim

        wav = pad_or_trim(extract_audio(args.media), config.data.audio_num_samples)
        audio = torch.from_numpy(wav[None]).to(device)
    if args.text:
        ids, mask = tokenizer.encode_batch(
            [args.text], max_length=config.data.max_text_tokens,
            pad_to=config.data.max_text_tokens,
        )
        token_ids = torch.as_tensor(np.asarray(ids)).to(device)
        attention_mask = torch.as_tensor(np.asarray(mask), dtype=torch.float32).to(device)

    if args.int8:
        from triad_tpu_torch.models.quantize import int8_interception

        mode = int8_interception()
    else:
        mode = contextlib.nullcontext()
    with mode, torch.inference_mode():
        out = model.inference_forward(images=images, audio=audio, token_ids=token_ids,
                                      attention_mask=attention_mask)
    out = {k: v.float().cpu().numpy() for k, v in out.items()}

    summary = {}
    for k, v in out.items():
        entry = {"shape": list(v.shape)}
        if k.endswith("_sim_matrix"):
            entry.update(
                mean=float(v.mean()), max=float(v.max()), min=float(v.min())
            )
        summary[k] = entry
    text = json.dumps(summary, indent=2, sort_keys=True)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    if args.features_npz:
        np.savez(args.features_npz, **out)
    return summary


if __name__ == "__main__":
    main()
