"""Build, load and count the port's hand-written CUDA kernels.

All sources under ``triad_tpu_torch/csrc/`` compile with ``nvcc`` (one
process per source, in parallel) into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), which
``ctypes`` loads. The build happens at first
use, into ``triad_tpu_torch/_build/`` (git-ignored), keyed by a hash of
the sources, so a fresh checkout builds everything from the repo alone.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`call` raises when that is not 0.

``LAUNCHES`` counts kernel launches per wrapper name. A wrapper adds one
where it launches its kernel and nowhere else; a wrapper whose entry
point runs two grids (``attention_train_bwd``: rows, then columns) adds
one per call. :func:`reset_launches` zeroes the counts, so a caller can
show that a run went through the kernels.
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

from triad_tpu_torch.ops.dropout import keep_scale, threshold

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {
    "attention_eval": 0,
    "attention_eval_merged": 0,
    "fused_mlp": 0,
    "frontend_stats": 0,
    "frontend_conv0": 0,
    "frontend_conv": 0,
    "attention_train": 0,
    "attention_train_bwd": 0,
    "fused_mlp_bwd": 0,
    "layernorm": 0,
    "layernorm_bwd": 0,
    "posconv": 0,
    "posconv_dx": 0,
    "posconv_dw": 0,
}

_VP, _I, _LL, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_uint
_DROP = [_U, _U, _F, _I]  # seed, threshold, keep scale, active (dropout_args)
_SIGNATURES = {
    "triad_attention_eval": [_VP] * 5 + [_I] * 4 + [_LL] * 9 + [_F, _VP],
    "triad_attention_eval_max_keys": [],
    "triad_attention_train_fwd": [_VP] * 5 + [_I] * 3 + [_F] + _DROP + [_VP],
    "triad_attention_train_bwd": [_VP] * 11 + [_I] * 3 + [_F] + _DROP + [_VP],
    "triad_attention_train_max_keys": [],
    "triad_fused_mlp": [_VP] * 6 + [_I] * 5 + _DROP + [_VP],
    "triad_fused_mlp_bwd": [_VP] * 8 + [_I] * 5 + _DROP + [_VP],
    "triad_frontend_stats": [_VP, _LL, _VP, _VP, _VP, _I, _I, _VP],
    "triad_frontend_conv0": [_VP, _LL] + [_VP] * 4 + [_I] * 3 + [_VP],
    "triad_frontend_conv": [_VP, _I, _VP, _VP] + [_I] * 4 + [_VP],
    "triad_layernorm_fwd": [_VP] * 5 + [_I] * 2 + [_F] + _DROP + [_VP],
    "triad_layernorm_bwd": [_VP] * 8 + [_I] * 3 + [_F] + _DROP + [_VP],
    "triad_layernorm_bwd_blocks": [_I],
    "triad_posconv": [_VP] * 4 + [_I] * 7 + [_VP],
    "triad_posconv_dw": [_VP] * 3 + [_I] * 5 + [_VP],
}

_lock = threading.Lock()
_lib = None
build_log = ""


def dropout_args(seed: int, p: float):
    """The C arguments of a dropout kernel: (seed, threshold, 1 / (1 - p),
    active), with the keep rule of ops/dropout.py."""
    if p <= 0.0:
        return 0, 0, 1.0, 0
    return int(seed) & 0xFFFFFFFF, threshold(p), keep_scale(p), 1


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
    nvcc = _nvcc()
    # One nvcc per source, all at once, then one link.
    objs, procs = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [(proc, proc.communicate()[0]) for proc in procs]
    build_log = "".join(log for _, log in logs)
    failed = [proc.returncode for proc, _ in logs if proc.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        failed = [link.returncode] if link.returncode != 0 else []
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{build_log}")
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
