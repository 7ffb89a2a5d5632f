"""The port's infer and viz commands on the CPU (tests/test_cli.py:62-110
through the port): ``cli.infer --random-init`` prints the JAX command's
summary keys and shapes (every pairwise sim matrix, text<->audio
included), with and without ``--int8``; ``cli.infer --run-dir`` on a port
run directory writes the features JAX's ``inference_forward`` computes
on the same weights and inputs (fp32 on both sides; rtol 1e-4, atol
1e-5); ``cli.viz`` with ``--smoke``, ``--image`` / ``--text`` and
``--video`` (an mp4 written by cv2 and muxed with 'sowt' PCM audio by
``data/mp4.py:mux_mp4``) writes its files."""

import dataclasses
import json
import wave

import numpy as np
import pytest

from tests.test_multimodal import small_model_config
from tests.test_trainer import tiny_config


def _config_file(tmp_path):
    from triad_tpu.core.config import Config, DataConfig

    cfg = Config(model=small_model_config(),
                 data=DataConfig(image_size=28, audio_num_samples=1600, max_text_tokens=8))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg.to_dict()))
    return str(path)


def _image(tmp_path):
    import cv2

    path = tmp_path / "img.jpg"
    rng = np.random.default_rng(0)
    cv2.imwrite(str(path), rng.integers(0, 255, size=(32, 32, 3)).astype(np.uint8))
    return str(path)


def _pcm(n, seed=1):
    t = np.arange(n) / 16000.0
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=n)).astype(np.float32)


def _wav(tmp_path, n=1600):
    path = tmp_path / "clip.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((_pcm(n) * 32767).astype("<i2").tobytes())
    return str(path)


def write_mp4(path, n_frames, size, audio, fps=25):
    """An mp4 as the card can write one: frames by cv2.VideoWriter (mp4v),
    then ``mux_mp4`` adds ``audio`` as 'sowt' 16-bit PCM at 16 kHz."""
    import cv2

    from triad_tpu_torch.data.mp4 import mux_mp4

    silent = str(path) + ".video.mp4"
    writer = cv2.VideoWriter(silent, cv2.VideoWriter_fourcc(*"mp4v"), fps, (size, size))
    rng = np.random.default_rng(2)
    for _ in range(n_frames):
        writer.write(rng.integers(0, 255, size=(size, size, 3)).astype(np.uint8))
    writer.release()
    mux_mp4(str(path), silent, audio, 16000, audio_codec="sowt")
    return str(path)


def test_infer_random_init_summary_matches_jax(tmp_path, capsys):
    """All three modalities: the port's summary has the JAX command's keys
    and shapes, and its sim-matrix summaries are finite; --int8 too."""
    from triad_tpu.cli.infer import main as jax_infer
    from triad_tpu_torch.cli.infer import main as infer

    args = ["--random-init", "--config", _config_file(tmp_path), "--image", _image(tmp_path),
            "--media", _wav(tmp_path), "--text", "a dog"]
    jax_infer(args + ["--out", str(tmp_path / "jax.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    npz = tmp_path / "feats.npz"
    got = infer(args + ["--device", "cpu", "--out", str(tmp_path / "port.json"),
                        "--features-npz", str(npz)])
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert set(got) == set(want) >= {"vis_text_sim_matrix", "vis_audio_sim_matrix",
                                     "text_audio_sim_matrix"}
    for k in want:
        assert got[k]["shape"] == want[k]["shape"], k
        assert set(got[k]) == set(want[k]), k
        assert all(np.isfinite(v) for key, v in got[k].items() if key != "shape"), k
    feats = np.load(npz)
    assert feats["visual_feats"].shape[-1] == 32 and feats["visual_feats"].dtype == np.float32
    q = infer(args + ["--device", "cpu", "--int8"])
    assert {k: v["shape"] for k, v in q.items()} == {k: v["shape"] for k, v in got.items()}
    assert "{" in capsys.readouterr().out


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A port run directory: cli.train, 2 steps on the tiny synthetic
    config, on the CPU. DistilBERT takes 128 positions: viz encodes its
    caption at 128 tokens, as the JAX command does."""
    from triad_tpu_torch.cli import train as train_cli

    tmp = tmp_path_factory.mktemp("run")
    cfg = tmp / "tiny.json"
    d = dataclasses.asdict(tiny_config(tmp))
    d["model"]["text"]["max_position_embeddings"] = 128
    cfg.write_text(json.dumps(d))
    run = tmp / "cli_run"
    train_cli.main(["--device", "cpu", "--synthetic", "--steps", "2", "--config", str(cfg),
                    "--output-dir", str(run), "--force-new"])
    return run


def test_infer_run_dir_matches_jax_inference_forward(run_dir, tmp_path):
    import jax
    import jax.numpy as jnp

    from triad_tpu.models import TriadModel as JaxTriad
    from triad_tpu_torch.cli.infer import main as infer
    from triad_tpu_torch.config import Config
    from triad_tpu_torch.data.audio import extract_audio, pad_or_trim
    from triad_tpu_torch.data.images import clean_image, load_image
    from triad_tpu_torch.models.convert import torch_to_flax
    from triad_tpu_torch.train.checkpoint import read_run_meta
    from triad_tpu_torch.train.trainer import Trainer

    img, wav, text = _image(tmp_path), _wav(tmp_path, 2000), "a photo of a dog"
    npz = tmp_path / "feats.npz"
    summary = infer(["--run-dir", str(run_dir), "--device", "cpu", "--image", img,
                     "--media", wav, "--text", text, "--features-npz", str(npz)])
    assert {"vis_text_sim_matrix", "vis_audio_sim_matrix", "text_audio_sim_matrix"} <= set(
        summary)
    got = dict(np.load(npz))

    config = Config.from_dict(read_run_meta(str(run_dir))["config"])
    trainer = Trainer(config, force_new_training=False, device="cpu")
    assert trainer.progress.global_step == 2
    params = jax.tree.map(jnp.asarray, torch_to_flax(trainer.model.state_dict()))
    ids, mask = trainer.tokenizer.encode_batch([text], max_length=config.data.max_text_tokens,
                                               pad_to=config.data.max_text_tokens)
    jcfg_model = _jax_model_config(config)
    want = JaxTriad(jcfg_model).apply(
        {"params": params},
        images=jnp.asarray(clean_image(load_image(img, config.data.image_size))[None]),
        audio=jnp.asarray(pad_or_trim(extract_audio(wav), config.data.audio_num_samples)[None]),
        token_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask, jnp.float32),
        method=JaxTriad.inference_forward)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-4, atol=1e-5, err_msg=k)


def _jax_model_config(port_config):
    from triad_tpu.core.config import Config as JaxConfig

    return JaxConfig.from_dict(port_config.to_dict()).model


def test_viz_smoke(tmp_path):
    from triad_tpu_torch.cli.viz import main as viz

    viz(["--smoke", "--device", "cpu", "--out-dir", str(tmp_path / "v")])
    for name in ("audio_attention.png", "audio_attention.mp4", "text_attention.png"):
        assert (tmp_path / "v" / name).stat().st_size > 0, name


def test_viz_run_dir_image_text_and_video(run_dir, tmp_path):
    import cv2

    from triad_tpu_torch.cli.viz import main as viz
    from triad_tpu_torch.data.audio import extract_audio

    viz(["--run-dir", str(run_dir), "--device", "cpu", "--image", _image(tmp_path),
         "--text", "a dog in the park", "--out-dir", str(tmp_path / "tv")])
    assert (tmp_path / "tv" / "text_attention.png").stat().st_size > 0
    assert not (tmp_path / "tv" / "audio_attention.png").exists()

    audio = _pcm(1600)
    mp4 = write_mp4(tmp_path / "clip.mp4", 5, 32, audio)
    decoded = extract_audio(mp4)  # the native 'sowt' reader: the muxed samples, as int16
    np.testing.assert_allclose(decoded, np.round(audio * 32767) / 32768, atol=2 / 32768)
    viz(["--run-dir", str(run_dir), "--device", "cpu", "--video", mp4,
         "--out-dir", str(tmp_path / "av")])
    assert (tmp_path / "av" / "audio_attention.png").stat().st_size > 0
    cap = cv2.VideoCapture(str(tmp_path / "av" / "audio_attention.mp4"))
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape[2] == 3
