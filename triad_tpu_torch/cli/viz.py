"""Visualization CLI (the port of ``triad_tpu/cli/viz.py``): dense
grounding heatmaps for an image + audio/text pair using a trained
checkpoint — the reference's viz surface (viz.py:345-379 quick tests +
train.py:635-708 hooks) as a command.

  python -m triad_tpu_torch.cli.viz --run-dir ./out --image img.jpg \
      --text "a dog playing in the park" --out-dir ./viz_out
  python -m triad_tpu_torch.cli.viz --run-dir ./out --video clip.mp4 \
      --out-dir ./viz_out            # audio-visual attention png + mp4
  python -m triad_tpu_torch.cli.viz --smoke --out-dir ./viz_out
      # reference-style quick test: random-weight model, white frame,
      # 440 Hz sine + caption (viz.py:345-373)

``--video`` takes one frame (``data/video.py:load_video_frame``: cv2 where
the native decoder is not built) and the audio track
(``data/audio.py:extract_audio``: the native PCM reader for 'sowt' / 'twos'
tracks). Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    from triad_tpu_torch.cli.common import add_device_arg, resolve_device

    parser = argparse.ArgumentParser(description="grounding visualization")
    parser.add_argument("--run-dir", help="training output dir (checkpointed model)")
    parser.add_argument("--image", help="image file for text-visual viz")
    parser.add_argument("--video", help="video file for audio-visual viz")
    parser.add_argument("--text", help="caption for text-visual viz")
    parser.add_argument("--out-dir", default="./viz_out")
    parser.add_argument(
        "--smoke", action="store_true",
        help="random-weight smoke test (no checkpoint needed)",
    )
    add_device_arg(parser)

    args = parser.parse_args(argv)
    device = resolve_device(args)

    import torch

    from triad_tpu_torch.config import Config
    from triad_tpu_torch.data import WordPieceTokenizer, load_image
    from triad_tpu_torch.data.audio import extract_audio, pad_or_trim
    from triad_tpu_torch.data.images import clean_image
    from triad_tpu_torch.ops.similarity import pairwise_similarity
    from triad_tpu_torch.viz import AudioVisualizer, TextVisualizer

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.smoke:
        from triad_tpu_torch.config import (
            DistilBertConfig, HubertConfig, ModelConfig, ViTConfig,
        )
        from triad_tpu_torch.models.convert import init_triad_model

        config = Config(
            model=ModelConfig(
                embedding_dim=64, compute_dtype="float32",
                vit=ViTConfig(hidden_size=64, num_layers=2, num_heads=4),
                hubert=HubertConfig(
                    hidden_size=64, num_layers=2, num_heads=4,
                    intermediate_size=128,
                ),
                text=DistilBertConfig(
                    vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
                    intermediate_size=128,
                ),
            )
        )
        model = init_triad_model(config.model, torch.Generator(device=device).manual_seed(0),
                                 device=device)
        vocab = {w: i for i, w in enumerate(
            ["[PAD]", "[UNK]", "a", "dog", "playing", "in", "the", "park"]
        )}
        tokenizer = WordPieceTokenizer(vocab)
        audio_samples = 16331
    else:
        if not args.run_dir:
            raise SystemExit("--run-dir required (or use --smoke)")
        from triad_tpu_torch.train.checkpoint import read_run_meta
        from triad_tpu_torch.train.trainer import Trainer

        config = Config.from_dict(read_run_meta(args.run_dir)["config"])
        trainer = Trainer(config, force_new_training=False, device=device)
        model, tokenizer = trainer.model, trainer.tokenizer
        audio_samples = config.data.audio_num_samples

    def on_device(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    @torch.inference_mode()
    def sim_av(frame, audio):
        a = model.encode_audio(on_device(audio))
        v = model.encode_visual(on_device(frame))
        return pairwise_similarity(a, v, model.temperature)[0].float().cpu().numpy()

    @torch.inference_mode()
    def sim_tv(frame, text):
        ids, mask = tokenizer.encode_batch([text], max_length=128, pad_to=128)
        t = model.encode_text(on_device(ids), on_device(np.asarray(mask, np.float32)))
        v = model.encode_visual(on_device(frame))
        sims = pairwise_similarity(t, v, model.temperature)[0].float().cpu().numpy()
        n = int(np.asarray(mask).sum())
        return sims[:n], tokenizer.tokenize(text)[:n]

    image_size = config.model.vit.image_size
    patch_size = config.model.vit.patch_size

    if args.smoke or args.video:
        av_viz = AudioVisualizer(patch_size, image_size)
        if args.smoke:
            frame = clean_image(np.ones((image_size, image_size, 3), np.float32))
            t = np.linspace(0, 2 * np.pi, audio_samples).astype(np.float32)
            audio = np.sin(2 * np.pi * 440 * t)
            video_path = None
        else:
            from triad_tpu_torch.data.video import load_video_frame

            frame = load_video_frame(
                args.video, size=image_size, apply_augmentation=False
            )
            audio = pad_or_trim(extract_audio(args.video), audio_samples)
            video_path = args.video
        av_viz.plot_audio_token_attentions(
            sim_av, frame, audio, str(out_dir / "audio_attention.png"),
            num_tokens_to_show=8,
        )
        writer = av_viz.make_attention_video(
            sim_av, frame, audio, str(out_dir / "audio_attention.mp4"),
            video_path=video_path, fps=5 if args.smoke else 50,
        )
        print(f"Wrote audio-visual attention artifacts to {out_dir} ({writer})")

    if args.smoke or (args.image and args.text):
        tv_viz = TextVisualizer(patch_size, image_size)
        if args.smoke:
            frame = clean_image(np.ones((image_size, image_size, 3), np.float32))
            text = "a dog playing in the park"
        else:
            frame = clean_image(load_image(args.image, image_size))
            text = args.text
        tv_viz.plot_token_attentions(
            sim_tv, frame, text, str(out_dir / "text_attention.png")
        )
        print(f"Wrote text-visual attention to {out_dir}")


if __name__ == "__main__":
    main()
