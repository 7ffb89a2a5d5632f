"""Host-side audio utilities: decode, resample to 16 kHz, fixed-shape pad.
The port's copy of ``triad_tpu/data/audio.py``.

Replaces the reference's torchaudio path (dataset.py:80-89:
torchaudio.load -> Resample(sr, 16000) -> channel 0; failure -> a
16331-sample zero vector). Decode backends are gated on availability:
WAV via scipy, anything else via the ffmpeg binary when present.
Resampling uses scipy's polyphase filter (same family as torchaudio's
kaiser-windowed sinc).
"""

from __future__ import annotations

import shutil
import subprocess
from fractions import Fraction
from pathlib import Path
from typing import Tuple

import numpy as np

TARGET_SR = 16_000
# Reference failure sentinel: ~1.02 s of silence (dataset.py:89).
FALLBACK_NUM_SAMPLES = 16_331


def resample(audio: np.ndarray, orig_sr: int, target_sr: int = TARGET_SR) -> np.ndarray:
    if orig_sr == target_sr:
        return audio.astype(np.float32)
    from scipy.signal import resample_poly

    frac = Fraction(target_sr, orig_sr).limit_denominator(1000)
    out = resample_poly(audio.astype(np.float64), frac.numerator, frac.denominator)
    return out.astype(np.float32)


def resample_preferred(
    audio: np.ndarray, orig_sr: int, target_sr: int = TARGET_SR
) -> np.ndarray:
    """Native kaiser-sinc resampler when the C++ library is built
    (native/triad_data.cc), scipy polyphase otherwise."""
    from triad_tpu_torch.data import native

    if native.available():
        return native.resample(audio, orig_sr, target_sr)
    return resample(audio, orig_sr, target_sr)


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """WAV -> (mono float32 channel 0, sample_rate). Prefers the native
    demuxer (native/triad_data.cc wav_decode_channel: PCM 16/24/32 +
    float32, truncation-tolerant); scipy fallback."""
    from triad_tpu_torch.data import native

    if native.available():
        with open(path, "rb") as f:
            return native.decode_wav(f.read(), 0)
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data[:, 0]  # channel 0 (dataset.py:86)
    return data, sr


def _ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def load_audio_ffmpeg(path: str, target_sr: int = TARGET_SR) -> np.ndarray:
    """Decode any container's audio track to mono float32 at target_sr."""
    cmd = [
        "ffmpeg", "-v", "error", "-i", str(path),
        "-f", "f32le", "-acodec", "pcm_f32le", "-ac", "1",
        "-ar", str(target_sr), "pipe:1",
    ]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, np.float32).copy()


def extract_audio(path: str, target_sr: int = TARGET_SR) -> np.ndarray:
    """Audio track of a media file as mono float32 @ target_sr.

    Mirrors the reference's per-sample fault tolerance (dataset.py:87-89):
    any failure returns the silence sentinel so the batch survives.
    """
    try:
        p = Path(path)
        if p.suffix.lower() == ".wav":
            data, sr = load_wav(str(p))
            return resample_preferred(data, sr, target_sr)
        if p.suffix.lower() in (".mp4", ".m4a", ".mov"):
            # Native demux (native/mp4.cc) + native decode: PCM
            # directly, AAC via the linked libavcodec
            # (native/avdecode.cc). ffmpeg-binary fallback below only
            # for codecs neither covers.
            from triad_tpu_torch.data import native
            from triad_tpu_torch.data.mp4 import extract_audio_track

            if native.available():
                try:
                    data, sr = extract_audio_track(str(p))
                    return resample_preferred(data, sr, target_sr)
                except ValueError:
                    pass  # unsupported codec — try ffmpeg
        if _ffmpeg_available():
            return load_audio_ffmpeg(str(p), target_sr)
        raise RuntimeError(
            f"No decoder for {p.suffix!r} (ffmpeg not available)"
        )
    except Exception as e:  # noqa: BLE001 — reference swallows all errors
        print(f"Failed to load audio from {path}: {e}")
        return np.zeros(FALLBACK_NUM_SAMPLES, np.float32)


def pad_or_trim(audio: np.ndarray, num_samples: int, dtype=np.float32) -> np.ndarray:
    """Zero-pad (reference collate, dataset.py:264-276) or trim to the
    fixed length the train and eval steps take. dtype=np.int16 keeps
    packed storage audio at wire width for the device-ingest path."""
    out = np.zeros(num_samples, dtype)
    n = min(len(audio), num_samples)
    out[:n] = audio[:n]
    return out
