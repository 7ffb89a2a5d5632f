"""ctypes bindings for the native data-ops library (``native/*.cc``): the
port's copy of ``triad_tpu/data/native.py``, with the same entry points
and the same numpy/scipy fallback in each.

The library is built from the repo's own sources with the repo's
Makefile, but never into ``native/``: :func:`build` runs
``make -s -C native TARGET=<path>`` into
``triad_tpu_torch/_build/native-<key>/libtriad_data.so`` (git-ignored).
The key hashes the sources, the Makefile and this machine's CPU model and
flags, because the Makefile compiles with ``-march=native``: a library
built on one machine and copied to another (a checkout copied as it is
on disk) is never loaded there. An ``fcntl`` lock serialises concurrent
builds (test workers), and the finished library is moved into place
with a rename, so no process loads a half-written file. The build runs at
first use, never at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
_lib: Optional[ctypes.CDLL] = None
_tried = False
_load_lock = threading.Lock()
# Why the library did not load (None while it has not been tried or loaded).
load_error: Optional[str] = None


def _cpu_model() -> str:
    """This machine's CPU model and feature flags (``/proc/cpuinfo``)."""
    found = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("model name", "flags", "Features") and key not in found:
                    found[key] = " ".join(sorted(value.split()))
    except OSError:
        pass
    return " | ".join([platform.machine()] + [found[k] for k in sorted(found)])


def library_path() -> Path:
    """Where this machine's build of the library lives."""
    digest = hashlib.sha256()
    for src in sorted(_NATIVE_DIR.glob("*.cc")) + [_NATIVE_DIR / "Makefile"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(_cpu_model().encode())
    return _BUILD_ROOT / f"native-{digest.hexdigest()[:16]}" / "libtriad_data.so"


def build() -> Path:
    """Build the library for this machine unless it is there; returns its
    path. Raises when ``make`` fails."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not path.exists():
                tmp = path.parent / f"libtriad_data.{os.getpid()}.tmp"
                made = subprocess.run(
                    ["make", "-s", "-C", str(_NATIVE_DIR), f"TARGET={tmp}"],
                    capture_output=True, text=True,
                )
                if made.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"make failed ({made.returncode}): {made.stderr.strip()[-2000:]}"
                    )
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def _load() -> Optional[ctypes.CDLL]:
    # Fast path only on success: `_tried` may be set while another
    # thread is still mid-load, so it is only consulted under the lock.
    if _lib is not None:
        return _lib
    with _load_lock:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib, _tried, load_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
        lib.resample_output_length.restype = ctypes.c_int64
        lib.resample_output_length.argtypes = [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ]
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.resample_kaiser.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int32,
            f32p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_double,
        ]
        lib.normalize_pad_waveform.argtypes = [
            f32p, ctypes.c_int64, f32p, ctypes.c_int64,
        ]
        lib.resize_normalize_u8.argtypes = [
            u8p, ctypes.c_int32, ctypes.c_int32,
            f32p, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.wav_info.restype = ctypes.c_int32
        lib.wav_info.argtypes = [
            u8p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.wav_decode_channel.restype = ctypes.c_int64
        lib.wav_decode_channel.argtypes = [
            u8p, ctypes.c_int64, f32p, ctypes.c_int64, ctypes.c_int32,
        ]
        # MP4 demuxer (native/mp4.cc)
        lib.mp4_open.restype = ctypes.c_void_p
        lib.mp4_open.argtypes = [u8p, ctypes.c_int64]
        lib.mp4_close.argtypes = [ctypes.c_void_p]
        lib.mp4_num_tracks.restype = ctypes.c_int32
        lib.mp4_num_tracks.argtypes = [ctypes.c_void_p]
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.mp4_track_info.restype = ctypes.c_int32
        lib.mp4_track_info.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, u32p, u32p, u32p, i64p, i64p,
            i32p, i32p, i32p, i32p, i32p, i64p, i32p,
        ]
        lib.mp4_track_edit.restype = ctypes.c_int32
        lib.mp4_track_edit.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i64p, i64p,
        ]
        lib.mp4_sample_range.restype = ctypes.c_int32
        lib.mp4_sample_range.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, i64p, i64p,
        ]
        lib.mp4_sync_samples.restype = ctypes.c_int64
        lib.mp4_sync_samples.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i64p, ctypes.c_int64,
        ]
        lib.mp4_decoder_config.restype = ctypes.c_int64
        lib.mp4_decoder_config.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, u8p, ctypes.c_int64,
        ]
        lib.mp4_track_total_bytes.restype = ctypes.c_int64
        lib.mp4_track_total_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.mp4_sample_table.restype = ctypes.c_int64
        lib.mp4_sample_table.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i64p, i64p, ctypes.c_int64,
        ]
        # Compressed-codec decode (native/avdecode.cc, links the system
        # libavcodec — present only when the build probe found headers).
        if hasattr(lib, "avdec_decode_aac"):
            lib.avdec_available.restype = ctypes.c_int32
            lib.avdec_decode_aac.restype = ctypes.c_int64
            lib.avdec_decode_aac.argtypes = [
                u8p, i64p, i64p, ctypes.c_int64, u8p, ctypes.c_int64,
                ctypes.c_int32, f32p, ctypes.c_int64, i32p,
            ]
            lib.avdec_decode_video_frame.restype = ctypes.c_int32
            lib.avdec_decode_video_frame.argtypes = [
                u8p, i64p, i64p, ctypes.c_int64, u8p, ctypes.c_int64,
                ctypes.c_uint32, u8p, ctypes.c_int32, ctypes.c_int32,
            ]
            lib.avdec_encode_aac.restype = ctypes.c_int64
            lib.avdec_encode_aac.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int32, u8p, ctypes.c_int64,
                i64p, ctypes.c_int64, u8p, ctypes.c_int64, i64p,
            ]
            lib.avdec_encode_h264.restype = ctypes.c_int64
            lib.avdec_encode_h264.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, u8p, ctypes.c_int64,
                i64p, u8p, ctypes.c_int64, u8p, ctypes.c_int64, i64p,
            ]
        lib.mp4_decode_pcm.restype = ctypes.c_int64
        lib.mp4_decode_pcm.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, f32p, ctypes.c_int64,
            ctypes.c_int32,
        ]
        _lib = lib
        load_error = None
    except Exception as e:  # noqa: BLE001 — fall back to numpy paths
        load_error = f"{type(e).__name__}: {e}"
        print(f"native triad_data unavailable ({load_error}); using numpy fallbacks")
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resample(audio: np.ndarray, orig_sr: int, target_sr: int,
             width: int = 16, beta: float = 14.77) -> np.ndarray:
    """Kaiser-windowed sinc resample (native), scipy polyphase fallback."""
    lib = _load()
    if lib is None:
        from triad_tpu_torch.data.audio import resample as scipy_resample

        return scipy_resample(audio, orig_sr, target_sr)
    audio = np.ascontiguousarray(audio, np.float32)
    n_out = lib.resample_output_length(len(audio), orig_sr, target_sr)
    out = np.empty(n_out, np.float32)
    lib.resample_kaiser(
        _f32p(audio), len(audio), orig_sr, _f32p(out), n_out, target_sr,
        width, beta,
    )
    return out


def normalize_pad_waveform(audio: np.ndarray, num_samples: int) -> np.ndarray:
    """Fused zero-mean/unit-var (over the padded row, eps 1e-7 — the HF
    processor quirk, reference model.py:56-62) + pad/trim to the static
    length. Numpy fallback reproduces the same math."""
    lib = _load()
    audio = np.ascontiguousarray(audio, np.float32)
    if lib is None:
        from triad_tpu_torch.data.audio import pad_or_trim

        padded = pad_or_trim(audio, num_samples)
        mean = padded.mean()
        var = padded.var()
        return ((padded - mean) / np.sqrt(var + 1e-7)).astype(np.float32)
    out = np.empty(num_samples, np.float32)
    lib.normalize_pad_waveform(_f32p(audio), len(audio), _f32p(out), num_samples)
    return out


def resize_normalize_image(img_u8: np.ndarray, size: int,
                           normalize: bool = True) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (size, size, 3), bilinear + ImageNet
    normalize, fused natively; numpy/cv2 fallback."""
    lib = _load()
    if lib is None:
        from triad_tpu_torch.data.images import imagenet_normalize, resize_bilinear

        img = img_u8.astype(np.float32) / 255.0
        img = resize_bilinear(img, size)
        return imagenet_normalize(img) if normalize else img
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w = img_u8.shape[:2]
    out = np.empty((size, size, 3), np.float32)
    lib.resize_normalize_u8(
        img_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        _f32p(out), size, 1 if normalize else 0,
    )
    return out


def decode_wav(data: bytes, channel: int = 0):
    """RIFF/WAVE -> (float32 samples in [-1, 1], sample_rate).

    Native demuxer (PCM 16/24/32 + IEEE float32, incl. extensible
    headers; tolerates truncated data chunks). Fallback: the stdlib
    ``wave`` module (PCM only). The reference gets this from
    torchaudio/libavcodec (dataset.py:83-86) and takes channel 0.
    """
    lib = _load()
    if lib is None:
        return _decode_wav_py(data, channel)
    buf = np.frombuffer(data, np.uint8)
    u8 = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    sr = ctypes.c_int32()
    ch = ctypes.c_int32()
    frames = ctypes.c_int64()
    rc = lib.wav_info(u8, len(buf), ctypes.byref(sr), ctypes.byref(ch),
                      ctypes.byref(frames))
    if rc != 0:
        raise ValueError(f"invalid or unsupported WAV (code {rc})")
    out = np.empty(frames.value, np.float32)
    n = lib.wav_decode_channel(u8, len(buf), _f32p(out), frames.value, channel)
    if n < 0:
        raise ValueError(f"WAV decode failed (code {n})")
    return out[:n], sr.value


def _decode_wav_py(data: bytes, channel: int = 0):
    import io
    import wave

    with wave.open(io.BytesIO(data)) as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    return np.ascontiguousarray(x.reshape(-1, ch)[:, channel]), sr


def avdec_supported() -> bool:
    """True when the native library was built against libavcodec
    (AAC/H.264 decode + AAC encode entry points present)."""
    lib = _load()
    return lib is not None and hasattr(lib, "avdec_decode_aac")


def encode_aac(pcm: np.ndarray, sample_rate: int):
    """Mono float32 PCM -> (access-unit list, AudioSpecificConfig bytes)
    via the linked libavcodec AAC-LC encoder (native/avdecode.cc). Used
    by the mp4a muxer path (the reference's attention videos carry AAC,
    viz.py:128-137)."""
    import ctypes as ct

    lib = _load()
    if lib is None or not hasattr(lib, "avdec_encode_aac"):
        raise RuntimeError("libavcodec-backed native library unavailable")
    pcm = np.ascontiguousarray(pcm, np.float32)
    max_aus = len(pcm) // 1024 + 8
    out = np.empty(len(pcm) * 4 + 65536, np.uint8)
    sizes = np.empty(max_aus, np.int64)
    asc = np.empty(64, np.uint8)
    asc_len = ct.c_int64(0)
    n = lib.avdec_encode_aac(
        _f32p(pcm), len(pcm), sample_rate,
        out.ctypes.data_as(ct.POINTER(ct.c_uint8)), len(out),
        sizes.ctypes.data_as(ct.POINTER(ct.c_int64)), max_aus,
        asc.ctypes.data_as(ct.POINTER(ct.c_uint8)), 64, ct.byref(asc_len),
    )
    if n < 0:
        raise RuntimeError(f"AAC encode failed (code {n})")
    aus, pos = [], 0
    for i in range(n):
        aus.append(out[pos : pos + int(sizes[i])].tobytes())
        pos += int(sizes[i])
    return aus, asc[: asc_len.value].tobytes()


def h264_supported() -> bool:
    """True when the linked libavcodec carries an H.264 ENCODER
    (libx264) — decode support comes with avdec_supported()."""
    lib = _load()
    if lib is None or not hasattr(lib, "avdec_encode_h264"):
        return False
    global _h264_probe
    if _h264_probe is None:
        # Cheap 2-frame probe: the entry point exists even when the
        # system libavcodec was built without libx264.
        try:
            encode_h264(np.zeros((2, 16, 16, 3), np.uint8), fps=4)
            _h264_probe = True
        except RuntimeError:
            _h264_probe = False
    return _h264_probe


_h264_probe: "bool | None" = None


def encode_h264(frames: np.ndarray, fps: int, gop: int = 12):
    """(N,H,W,3) uint8 RGB -> (access-unit list, keyframe-flag array,
    avcC bytes) via the linked libx264 (native/avdecode.cc). AUs are
    AVCC length-prefixed, ready for an 'avc1' MP4 track — the codec of
    real AudioSet media (reference decodes it via torchcodec,
    dataset.py:91-95)."""
    import ctypes as ct

    lib = _load()
    if lib is None or not hasattr(lib, "avdec_encode_h264"):
        raise RuntimeError("libavcodec-backed native library unavailable")
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (N,H,W,3) uint8, got {frames.shape}")
    n_frames, h, w = frames.shape[:3]
    if w % 2 or h % 2:
        raise ValueError("H.264 yuv420p needs even width/height")
    max_aus = n_frames + 8
    out = np.empty(frames.nbytes + (1 << 20), np.uint8)
    sizes = np.empty(max_aus, np.int64)
    keys = np.zeros(max_aus, np.uint8)
    avcc = np.empty(4096, np.uint8)
    avcc_len = ct.c_int64(0)
    u8p = ct.POINTER(ct.c_uint8)
    n = lib.avdec_encode_h264(
        frames.ctypes.data_as(u8p), n_frames, w, h, fps, gop,
        out.ctypes.data_as(u8p), len(out),
        sizes.ctypes.data_as(ct.POINTER(ct.c_int64)),
        keys.ctypes.data_as(u8p), max_aus,
        avcc.ctypes.data_as(u8p), len(avcc), ct.byref(avcc_len),
    )
    if n < 0:
        raise RuntimeError(f"H.264 encode failed (code {n})")
    aus, pos = [], 0
    for i in range(n):
        aus.append(out[pos : pos + int(sizes[i])].tobytes())
        pos += int(sizes[i])
    return aus, keys[:n].copy(), avcc[: avcc_len.value].tobytes()


def load_wav(path, target_sr: int = 16_000, channel: int = 0) -> np.ndarray:
    """File -> mono float32 at ``target_sr`` (demux + decode + kaiser
    resample — the reference's extract_audio_from_video semantics for
    audio-file inputs, dataset.py:80-89)."""
    with open(path, "rb") as f:
        samples, sr = decode_wav(f.read(), channel)
    if sr != target_sr:
        samples = resample(samples, sr, target_sr)
    return samples
