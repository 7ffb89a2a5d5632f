"""Build, load and count the port's hand-written CUDA kernels.

All sources under ``triad_tpu_torch/csrc/`` compile with ``nvcc`` into
one shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), which ``ctypes`` loads. The build happens at first
use, into ``triad_tpu_torch/_build/`` (git-ignored), keyed by a hash of
the sources, so a fresh checkout builds everything from the repo alone.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`call` raises when that is not 0.

``LAUNCHES`` counts kernel launches per wrapper name. A wrapper adds one
where it launches its kernel and nowhere else; :func:`reset_launches`
zeroes the counts, so a caller can show that a run went through the
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {
    "attention_eval": 0,
    "attention_eval_merged": 0,
    "fused_mlp": 0,
    "frontend_stats": 0,
    "frontend_conv0": 0,
    "frontend_conv": 0,
}

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "triad_attention_eval": [_VP] * 5 + [_I] * 4 + [_LL] * 9 + [_F, _VP],
    "triad_attention_eval_max_keys": [],
    "triad_fused_mlp": [_VP] * 6 + [_I] * 5 + [_VP],
    "triad_frontend_stats": [_VP, _LL, _VP, _VP, _VP, _I, _I, _VP],
    "triad_frontend_conv0": [_VP, _LL] + [_VP] * 4 + [_I] * 3 + [_VP],
    "triad_frontend_conv": [_VP, _I, _VP, _VP] + [_I] * 4 + [_VP],
}

_lock = threading.Lock()
_lib = None
build_log = ""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> Path:
    """Compile csrc/*.cu into _build/libtriad_kernels-<hash>.so (once)."""
    global build_log
    digest = hashlib.sha256()
    for p in _sources():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"libtriad_kernels-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(p) for p in _sources() if p.suffix == ".cu"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = _I
            _lib = lib
    return _lib


def call(name: str, *args) -> None:
    """Run C entry point ``triad_<name>``; raise on a nonzero cudaError_t."""
    err = getattr(library(), f"triad_{name}")(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor, dtype=None) -> None:
    """Raise unless a kernel's inputs all lie on one CUDA device (and, if
    ``dtype`` is given, all have that dtype)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got {dev}")
    for t in tensors:
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
