"""The port's host data modules against the JAX package's, on the CPU, at
small sizes: images (resize, the AV and TV draws and their apply, decode),
audio (resample, WAV decode, pad/trim), the native entry points (the
port's own build against the JAX package's), MP4 demux and authoring, and
the file-backed datasets. Inputs come from numpy seeds.

Bit-equal everywhere but in one place: the AV augmentation's per-image
mean, which the port sums in float64 (``images.image_mean``; the JAX
package takes numpy's float32 mean, which drifts on quantized pixels).
That function is held to a float64 recompute of the same recipe, and to
the JAX package's within the JAX mean's own float32 error.
"""

import os
import wave

import numpy as np
import pytest

from triad_tpu.data import audio as JA
from triad_tpu.data import images as JI
from triad_tpu.data import native as JN
from triad_tpu_torch.data import audio as PA
from triad_tpu_torch.data import images as PI
from triad_tpu_torch.data import native as PN


def _img(seed, h=32, w=32):
    return np.random.default_rng(seed).uniform(0, 1, size=(h, w, 3)).astype(np.float32)


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


# --------------------------------------------------------------------------- images


@pytest.mark.parametrize("hw,size", [((32, 32), 32), ((48, 40), 32), ((20, 28), 32)])
def test_resize_bilinear_equals_jax(hw, size):
    img = _img(1, *hw)
    np.testing.assert_array_equal(PI.resize_bilinear(img, size), JI.resize_bilinear(img, size))


def test_resize_bilinear_numpy_fallback_equals_jax(monkeypatch):
    """Without cv2 both packages take the same half-pixel numpy path."""
    import builtins

    real = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("cv2 hidden")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    img = _img(2, 45, 37)
    got = PI.resize_bilinear(img, 32)
    np.testing.assert_array_equal(got, JI.resize_bilinear(img, 32))
    assert got.shape == (32, 32, 3)


@pytest.mark.parametrize("seed", range(4))
def test_draws_equal_jax(seed):
    key = (seed, 1, 2, 3)
    assert PI.draw_av_params(np.random.default_rng(key)) == JI.draw_av_params(
        np.random.default_rng(key))
    assert PI.draw_tv_params(np.random.default_rng(key), 32, 32) == JI.draw_tv_params(
        np.random.default_rng(key), 32, 32)


@pytest.mark.parametrize("seed", range(4))
def test_tv_augmentation_equals_jax(seed):
    img = _img(10 + seed)
    p = JI.draw_tv_params(np.random.default_rng(seed), 32, 32)
    np.testing.assert_array_equal(PI.apply_tv_image(img, p), JI.apply_tv_image(img, p))
    np.testing.assert_array_equal(PI.augment_tv_image(img, np.random.default_rng(seed)),
                                  JI.augment_tv_image(img, np.random.default_rng(seed)))
    np.testing.assert_array_equal(PI.clean_image(img), JI.clean_image(img))


def _av_float64(imgs, params):
    """The AV recipe (reference dataset.py:104-126) in float64, params as
    the float32 the batched path takes."""
    out = []
    for img, p in zip(imgs.astype(np.float64), params):
        img = img[:, ::-1] if p["flip"] else img
        img = img * np.float32(p["brightness"])
        c, s = np.float32(p["contrast"]), np.float32(p["saturation"])
        mean = img.mean(axis=(0, 1), keepdims=True)
        img = (img - mean) * c + mean
        gray = img.mean(axis=2, keepdims=True)
        img = np.clip(img * s + gray * (1 - s), 0, 1)
        out.append((img - PI.IMAGENET_MEAN) / PI.IMAGENET_STD)
    return np.stack(out)


@pytest.mark.parametrize("size", [32, 224])
def test_av_augmentation_against_float64_and_jax(size):
    """The port's batched and per-item AV paths are the recipe to float32
    rounding (the float64 recompute within 2e-6, 8 float32 ulps of the
    largest value); the JAX package's differ by its float32 mean's drift
    (measured: <= 5e-6 at 32^2, 2.4e-4 at 224^2)."""
    imgs = _u8(size, (8, size, size, 3)).astype(np.float32) / 255.0
    params = [PI.draw_av_params(np.random.default_rng((size, 0, 0, i))) for i in range(8)]
    got = PI.apply_av_batch(imgs, params)
    want = _av_float64(imgs, params)
    assert np.abs(got - want).max() <= 2e-6
    for i in range(8):
        one = PI.augment_av_frame(imgs[i], np.random.default_rng((size, 0, 0, i)))
        assert np.abs(one - want[i]).max() <= 2e-6
        jax_one = JI.augment_av_frame(imgs[i], np.random.default_rng((size, 0, 0, i)))
        assert np.abs(one - jax_one).max() <= (1e-5 if size == 32 else 5e-4)
    jax_err = np.abs(got - JI.apply_av_batch(imgs, params)).max()
    assert jax_err <= (1e-5 if size == 32 else 5e-4), jax_err


def test_image_mean_is_the_rounded_float64_mean():
    imgs = _u8(3, (4, 64, 64, 3)).astype(np.float32) / 255.0 * np.float32(1.3)
    exact = imgs.astype(np.float64).mean(axis=(1, 2), keepdims=True)
    np.testing.assert_array_equal(PI.image_mean(imgs, (1, 2)), exact.astype(np.float32))


def test_load_image_equals_jax(tmp_path):
    from PIL import Image

    path = str(tmp_path / "a.png")
    Image.fromarray(_u8(4, (40, 30, 3))).save(path)
    np.testing.assert_array_equal(PI.load_image(path, 32), JI.load_image(path, 32))


# --------------------------------------------------------------------------- audio


@pytest.mark.parametrize("sr", [16_000, 22_050, 48_000])
def test_resample_equals_jax(sr):
    x = np.random.default_rng(sr).standard_normal(sr // 10).astype(np.float32)
    np.testing.assert_array_equal(PA.resample(x, sr), JA.resample(x, sr))
    np.testing.assert_array_equal(PA.resample_preferred(x, sr), JA.resample_preferred(x, sr))


def _write_wav(path, sr, samples):
    from scipy.io import wavfile

    wavfile.write(path, sr, samples)


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float32])
def test_load_wav_equals_jax(tmp_path, dtype):
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.9, 0.9, size=(1600, 2))
    if dtype == np.int16:
        x = (x * 32767).astype(np.int16)
    elif dtype == np.int32:
        x = (x * 2 ** 31).astype(np.int32)
    else:
        x = x.astype(np.float32)
    path = str(tmp_path / "a.wav")
    _write_wav(path, 16_000, x)
    got, sr = PA.load_wav(path)
    want, jsr = JA.load_wav(path)
    assert sr == jsr == 16_000 and got.shape == (1600,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(PA.extract_audio(path), JA.extract_audio(path))


def test_extract_audio_resamples_and_falls_back(tmp_path, capsys):
    path = str(tmp_path / "b.wav")
    _write_wav(path, 8_000, (np.sin(np.arange(800) / 5.0) * 20000).astype(np.int16))
    got = PA.extract_audio(path)
    np.testing.assert_array_equal(got, JA.extract_audio(path))
    assert got.shape == (1600,)
    missing = PA.extract_audio(str(tmp_path / "none.wav"))
    np.testing.assert_array_equal(missing, JA.extract_audio(str(tmp_path / "none.wav")))
    assert missing.shape == (PA.FALLBACK_NUM_SAMPLES,) and not missing.any()


@pytest.mark.parametrize("n", [1000, 1600, 2500])
def test_pad_or_trim_equals_jax(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    for dtype in (np.float32, np.int16):
        np.testing.assert_array_equal(PA.pad_or_trim(x, 1600, dtype),
                                      JA.pad_or_trim(x, 1600, dtype))


# --------------------------------------------------------------------------- native


def test_native_builds_into_the_ports_build_directory():
    """The port builds the library itself (g++ is here: no skip), into
    its own keyed directory, never into native/."""
    assert PN.available(), PN.load_error
    path = PN.library_path()
    assert path.exists()
    assert path.parent.parent.name == "_build" and path.parent.parent.parent.name == (
        "triad_tpu_torch")
    assert PN.library_path() == path  # the key is stable


def test_native_build_is_locked_and_atomic(tmp_path, monkeypatch):
    """Two builds into an empty build root at once: one make runs, the
    other waits on the lock and finds the library in place."""
    import threading

    from triad_tpu_torch.data import native

    monkeypatch.setattr(native, "_BUILD_ROOT", tmp_path)
    calls = []
    real_run = native.subprocess.run

    def counted(cmd, **kw):
        calls.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", counted)
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(native.build())) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1 and calls[0][-1].startswith("TARGET=")
    assert paths[0] == paths[1] and paths[0].exists()
    assert not [p for p in paths[0].parent.iterdir() if p.name.endswith(".tmp")]


@pytest.fixture(scope="module")
def both_native():
    assert PN.available(), PN.load_error
    assert JN.available()
    return PN, JN


def test_native_resample_and_normalize_equal_jax(both_native):
    x = np.random.default_rng(6).standard_normal(4410).astype(np.float32)
    np.testing.assert_array_equal(PN.resample(x, 44_100, 16_000), JN.resample(x, 44_100, 16_000))
    np.testing.assert_array_equal(PN.normalize_pad_waveform(x, 6000),
                                  JN.normalize_pad_waveform(x, 6000))
    img = _u8(7, (40, 52, 3))
    for norm in (True, False):
        np.testing.assert_array_equal(PN.resize_normalize_image(img, 32, norm),
                                      JN.resize_normalize_image(img, 32, norm))


def test_native_wav_equal_jax(both_native, tmp_path):
    x = (np.random.default_rng(8).uniform(-1, 1, size=(1600, 2)) * 30000).astype(np.int16)
    path = str(tmp_path / "c.wav")
    _write_wav(path, 32_000, x)
    data = open(path, "rb").read()
    for ch in (0, 1):
        got, sr = PN.decode_wav(data, ch)
        want, jsr = JN.decode_wav(data, ch)
        assert sr == jsr
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(PN._decode_wav_py(data, ch)[0], JN._decode_wav_py(data, ch)[0])
    np.testing.assert_array_equal(PN.load_wav(path), JN.load_wav(path))
    with pytest.raises(ValueError):
        PN.decode_wav(b"not a wav file at all.........")


# --------------------------------------------------------------------------- MP4


@pytest.fixture(scope="module")
def cv2_mp4(tmp_path_factory):
    """A real mp4v video (8 frames, 64x48 @ 10 fps) written by cv2."""
    import cv2

    path = tmp_path_factory.mktemp("mp4") / "vid_1_2.mp4"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    assert w.isOpened()
    for i in range(8):
        w.write(np.full((48, 64, 3), i * 25, np.uint8))
    w.release()
    return str(path)


def _demux(mod, path):
    with mod.Mp4File.from_path(path) as f:
        tracks = f.tracks
        return tracks, [f.sample_table(i) for i in range(len(tracks))], [
            f.sync_samples(i) for i in range(len(tracks))], [
            f.decoder_config(i) for i in range(len(tracks))]


def _assert_demux_equal(a, b):
    assert [t.__dict__ for t in a[0]] == [t.__dict__ for t in b[0]]
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])
    for x, y in zip(a[2], b[2]):
        np.testing.assert_array_equal(x, y)
    assert a[3] == b[3]


def test_mp4_demux_and_pcm_mux_equal_jax(cv2_mp4, tmp_path):
    from triad_tpu.data import mp4 as JM
    from triad_tpu_torch.data import mp4 as PM

    _assert_demux_equal(_demux(PM, cv2_mp4), _demux(JM, cv2_mp4))
    audio = np.sin(np.arange(1600) / 9.0).astype(np.float32) * 0.5
    PM.mux_mp4(str(tmp_path / "p.mp4"), cv2_mp4, audio, 16_000, audio_codec="sowt")
    JM.mux_mp4(str(tmp_path / "j.mp4"), cv2_mp4, audio, 16_000, audio_codec="sowt")
    assert open(tmp_path / "p.mp4", "rb").read() == open(tmp_path / "j.mp4", "rb").read()
    got, sr = PM.extract_audio_pcm(str(tmp_path / "j.mp4"))
    want, _ = JM.extract_audio_pcm(str(tmp_path / "p.mp4"))
    assert sr == 16_000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(PA.extract_audio(str(tmp_path / "p.mp4")),
                                  JA.extract_audio(str(tmp_path / "p.mp4")))


def test_mp4_codecs_equal_jax_where_avcodec(cv2_mp4, tmp_path):
    """The libavcodec paths (AAC mux and decode, frame decode, H.264
    authoring) where the Makefile's probe found libavcodec."""
    from triad_tpu.data import mp4 as JM
    from triad_tpu.data import video as JV
    from triad_tpu_torch.data import mp4 as PM
    from triad_tpu_torch.data import video as PV

    assert PN.avdec_supported() == JN.avdec_supported()
    if not PN.avdec_supported():
        pytest.skip("the Makefile's probe found no libavcodec")
    audio = np.sin(np.arange(4096) / 7.0).astype(np.float32) * 0.5
    PM.mux_mp4(str(tmp_path / "a.mp4"), cv2_mp4, audio, 16_000, audio_codec="mp4a")
    got, sr = PM.extract_audio_track(str(tmp_path / "a.mp4"))
    want, jsr = JM.extract_audio_track(str(tmp_path / "a.mp4"))
    assert sr == jsr
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        PM.extract_random_frame(cv2_mp4, np.random.default_rng(3)),
        JM.extract_random_frame(cv2_mp4, np.random.default_rng(3)))
    np.testing.assert_array_equal(
        PV.load_video_frame(cv2_mp4, np.random.default_rng(4), 32, False),
        JV.load_video_frame(cv2_mp4, np.random.default_rng(4), 32, False))
    aug = PV.load_video_frame(cv2_mp4, np.random.default_rng(4), 32, True)
    assert np.abs(aug - JV.load_video_frame(cv2_mp4, np.random.default_rng(4), 32, True)).max(
    ) <= 1e-5  # the AV augmentation's mean (module docstring)
    if PN.h264_supported():
        frames = _u8(9, (6, 32, 48, 3))
        PM.write_video_mp4(str(tmp_path / "h.mp4"), frames, fps=6, audio=audio)
        _assert_demux_equal(_demux(PM, str(tmp_path / "h.mp4")),
                            _demux(JM, str(tmp_path / "h.mp4")))
        with PM.Mp4File.from_path(str(tmp_path / "h.mp4")) as pf, JM.Mp4File.from_path(
                str(tmp_path / "h.mp4")) as jf:
            np.testing.assert_array_equal(pf.decode_frame(0, 4), jf.decode_frame(0, 4))


# --------------------------------------------------------------------------- datasets


@pytest.fixture(scope="module")
def caption_root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("captions")
    for d in range(2):
        os.makedirs(root / f"d{d}")
        for i in range(3):
            Image.fromarray(_u8(20 + 3 * d + i, (32, 32, 3))).save(root / f"d{d}" / f"{i}.jpg")
            (root / f"d{d}" / f"{i}.txt").write_text(f"a dog {d} runs {i}\n")
    Image.fromarray(_u8(30, (40, 36, 3))).save(root / "d1" / "big.jpg")
    (root / "d1" / "big.txt").write_text("an off size image")
    return str(root)


def test_caption_dataset_equals_jax(caption_root):
    from triad_tpu.data.datasets import LocalCaptionDataset as J
    from triad_tpu_torch.data.datasets import LocalCaptionDataset as P

    p, j = P(caption_root, image_size=32), J(caption_root, image_size=32)
    assert len(p) == len(j) == 7
    for i in range(len(p)):
        for aug in (True, False):
            (pi, pc) = p.__getitem__(i, aug, np.random.default_rng(i))
            (ji, jc) = j.__getitem__(i, aug, np.random.default_rng(i))
            assert pc == jc
            np.testing.assert_array_equal(pi, ji)
        pr, jr = p.raw_item(i), j.raw_item(i)
        assert pr["caption"] == jr["caption"] and pr["image_u8"].dtype == np.uint8
        np.testing.assert_array_equal(pr["image_u8"], jr["image_u8"])


def test_av_folder_datasets_equal_jax(cv2_mp4, tmp_path):
    """The MP4-folder datasets on a segment layout and a flat one (decode
    through native demux and cv2 or libavcodec, whichever the JAX package
    takes on this machine)."""
    import shutil

    from triad_tpu.data import datasets as JD
    from triad_tpu_torch.data import datasets as PD

    for seg in (3, 7):
        os.makedirs(tmp_path / "seg" / f"segment_{seg}")
        shutil.copy(cv2_mp4, tmp_path / "seg" / f"segment_{seg}" / "v_1.mp4")
    os.makedirs(tmp_path / "flat")
    shutil.copy(cv2_mp4, tmp_path / "flat" / "a.mp4")
    shutil.copy(cv2_mp4, tmp_path / "flat" / "b.mp4")
    pairs = [(PD.AudioVisualDataset(str(tmp_path / "seg"), 32),
              JD.AudioVisualDataset(str(tmp_path / "seg"), 32)),
             (PD.FlatAudioVisualDataset(str(tmp_path / "flat"), 32),
              JD.FlatAudioVisualDataset(str(tmp_path / "flat"), 32))]
    import random

    for p, j in pairs:
        p.switch_segment(random.Random(1))
        j.switch_segment(random.Random(1))
        assert p.current_segment == j.current_segment and len(p) == len(j)
        for i in range(len(p)):
            a = p.__getitem__(i, True, np.random.default_rng(i))
            b = j.__getitem__(i, True, np.random.default_rng(i))
            assert a["video_path"] == b["video_path"]
            # the AV augmentation's mean (module docstring)
            assert np.abs(a["video_frames"] - b["video_frames"]).max() <= 1e-5
            np.testing.assert_array_equal(a["audio"], b["audio"])


def test_synthetic_datasets_equal_jax():
    from triad_tpu.data import datasets as JD
    from triad_tpu_torch.data import datasets as PD

    p, j = PD.SyntheticAVDataset(4, 32, 0.1, seed=3), JD.SyntheticAVDataset(4, 32, 0.1, seed=3)
    for i in range(4):
        a, b = p[i], j[i]
        np.testing.assert_array_equal(a["video_frames"], b["video_frames"])
        np.testing.assert_array_equal(a["audio"], b["audio"])
    assert PD.SyntheticTVDataset(4, 32, 2).captions() == JD.SyntheticTVDataset(4, 32, 2).captions()


def test_wav_module_roundtrip(tmp_path):
    """decode_wav's stdlib fallback reads what the stdlib writes."""
    path = str(tmp_path / "d.wav")
    x = (np.arange(320) * 97 % 2000 - 1000).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes(x.tobytes())
    got, sr = PN._decode_wav_py(open(path, "rb").read())
    assert sr == 16_000
    np.testing.assert_array_equal(got, x.astype(np.float32) / 32768.0)
