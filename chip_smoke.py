"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA
kernels from triad_tpu_torch/csrc, checks each against its plain PyTorch
twin at the shapes of the serving and training paths, serves the
full-width perf_eval_model_config() TriadModel (random weights from a
seed) over HTTP and checks the answers, then trains the full-width
text-visual, joint and audio-visual steps of perf_train_model_config()
for a few steps each.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the last line):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. nvcc build of the kernels (one nvcc per source, in parallel);
  3. each kernel vs its plain twin on the card in bf16: max abs error
     against a stated bound, median time of the kernel, of the twin and
     of one PyTorch library call computing the same function where there
     is one (CUDA events), and the least time the card could take (the
     larger of the bytes over 3.35 TB/s and the operations over the
     tensor-core or fp32 peak); the training kernels at B = 8 and at the
     train steps' B = 64, the dropout kernels at p = 0.1 with the twin
     drawing the same keep mask;
  4. the server on an ephemeral port answers /healthz, embed audio
     (2 x 10 s), image (2 x 224^2), text (token ids) and /v1/score
     (av, tv); shapes and finiteness are checked, and the served
     embeddings are held against a float32 CPU run of the same weights;
  5. every serving kernel's launch count rose during phase 4's requests;
  6. the text-visual train step (perf_train_model_config +
     perf_train_loss_config, no accumulation) at B = 64 images of 224^2
     and 32 text tokens: 2 warm-up and 3 timed steps, every loss finite,
     the LoRA factors, projection heads and temperature moved, the ViT
     base and the still-gated DistilBERT and HuBERT bit-unchanged, and
     every training kernel launched during the steps (counts zeroed just
     before them), then a torch.profiler kernel split of one more step
     (the top rows printed, all of them in chiprun_out/train_profile.txt);
  7. one step's loss and per-group gradients at B = 4 (dropouts off,
     DistilBERT unfrozen) on the card in bf16 against the same weights
     in float32 on the CPU;
  8. the joint step (perf_train_model_config + perf_train_loss_config,
     every group unfrozen, no accumulation) at B = 64 clips of 10 s of
     16 kHz audio, 64 images of 224^2 and 32 text tokens with every
     HuBERT dropout live: 2 warm-up and 3 timed steps, every loss finite,
     every HuBERT parameter (frontend and positional conv included)
     moved, the ViT base bit-unchanged, every HuBERT training kernel
     launched during the steps (counts zeroed just before them), the
     peak device memory, a torch.profiler kernel split of one more step
     (chiprun_out/joint_profile.txt); then two audio-visual steps;
  9. one joint step's loss and per-group gradients at B = 4 with every
     rate at 0, the card in bf16 against the same weights in float32 on
     the CPU, the audio group included.
The line before the last is one JSON object with one entry per kernel:
its launches in the paths that run it (phases 4, 6 and 8, each counted
from zero), and its error, times and bound at its main case of phase 3
(the shape the train steps give it, else the first), with every shape of
phase 3 under "cases". The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 8  # batch of the kernel comparisons
TXT = 24  # text tokens in the served request
TRAIN_B, TRAIN_TXT, REF_B = 64, 32, 4  # train batch, its text tokens, reference batch
AUDIO = 160_000  # 10 s of 16 kHz audio
P_DROP = 0.1  # HuBERT's attention, activation and hidden dropout
BF16_ULP = 2.0 ** -7
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32
# outside them, HBM bandwidth.
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def phase(msg):
    print(f"== {msg}", flush=True)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def randn(shape, seed, scale=1.0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


def time_fns(fns, reps=20, warmup=3):
    """Median ms of each function, timed in turns with CUDA events."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for t, fn in zip(times, fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            t.append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def cost(flops, nbytes, peak=PEAK_BF16):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of the operations over their peak rate and the bytes (each
    input read once, each output written once) over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(got, ref):
    """(max abs error, its bound's base): over several outputs, the one
    whose error is largest against its own largest magnitude."""
    g = [got] if isinstance(got, torch.Tensor) else list(got)
    r = [ref] if isinstance(ref, torch.Tensor) else list(ref)
    pairs = [(float((a.float() - b.float()).abs().max()), float(b.float().abs().max()))
             for a, b in zip(g, r)]
    return max(pairs, key=lambda p: p[0] / max(p[1], 1e-30))


def compare(results, name, shape, kernel_fn, plain_fn, tol_rel, bound, library_fn=None,
            main=False):
    """Kernel vs plain twin: error against tol_rel of the largest output,
    times of kernel, twin and library call, and the bound (from cost)."""
    got = kernel_fn()
    torch.cuda.synchronize()
    ref = plain_fn()
    err, mx = max_err(got, ref)
    tol = tol_rel * mx
    fns = [kernel_fn, plain_fn] + ([library_fn] if library_fn is not None else [])
    ms, plain_ms, *lib = time_fns(fns)
    library_ms = lib[0] if lib else None
    bound_ms, bound_by = bound
    ok = err <= tol
    lib_txt = "-" if library_ms is None else f"{library_ms:.4f}"
    print(f"  {name:20s} {str(shape):32s} err {err:.4g} (tol {tol:.4g}) kernel {ms:.4f} "
          f"plain {plain_ms:.4f} library {lib_txt} bound {bound_ms:.4f} ({bound_by}) ms  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} at {shape} disagrees with its plain version")
    results.append({"name": name, "shape": list(shape), "max_abs_err": err, "tol": tol,
                    "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "main": main})


KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "attention_eval": ("triad_tpu_torch/csrc/attention_eval.cu",
                       "triad_tpu/ops/pallas_attention.py:366"),
    "attention_eval_merged": ("triad_tpu_torch/csrc/attention_eval.cu",
                              "triad_tpu/ops/pallas_attention.py:680"),
    "fused_mlp": ("triad_tpu_torch/csrc/fused_mlp.cu", "triad_tpu/ops/pallas_mlp.py:174"),
    "frontend_stats": ("triad_tpu_torch/csrc/frontend.cu",
                       "triad_tpu/ops/pallas_frontend.py:324"),
    "frontend_conv0": ("triad_tpu_torch/csrc/frontend.cu",
                       "triad_tpu/ops/pallas_frontend.py:471"),
    "frontend_conv": ("triad_tpu_torch/csrc/frontend.cu",
                      "triad_tpu/ops/pallas_frontend.py:208"),
    "attention_train": ("triad_tpu_torch/csrc/attention_train.cu",
                        "triad_tpu/ops/pallas_attention.py:575"),
    "attention_train_bwd": ("triad_tpu_torch/csrc/attention_train.cu",
                            "triad_tpu/ops/pallas_attention.py:585"),
    "fused_mlp_bwd": ("triad_tpu_torch/csrc/fused_mlp.cu", "triad_tpu/ops/pallas_mlp.py:204"),
    "layernorm": ("triad_tpu_torch/csrc/layernorm.cu", "triad_tpu/ops/pallas_ln.py:128"),
    "layernorm_bwd": ("triad_tpu_torch/csrc/layernorm.cu", "triad_tpu/ops/pallas_ln.py:148"),
    "posconv": ("triad_tpu_torch/csrc/posconv.cu", "triad_tpu/ops/pallas_posconv.py:170"),
    "posconv_dx": ("triad_tpu_torch/csrc/posconv.cu", "triad_tpu/ops/pallas_posconv.py:170"),
    "posconv_dw": ("triad_tpu_torch/csrc/posconv.cu", "triad_tpu/ops/pallas_posconv.py:285"),
}
SERVE_KERNELS = ("attention_eval", "attention_eval_merged", "fused_mlp", "frontend_stats",
                 "frontend_conv0", "frontend_conv")
TV_KERNELS = ("attention_train", "attention_train_bwd", "fused_mlp", "fused_mlp_bwd")
JOINT_KERNELS = TV_KERNELS + ("layernorm", "layernorm_bwd", "posconv", "posconv_dx",
                              "posconv_dw", "frontend_stats", "frontend_conv0", "frontend_conv")


def _sdpa(q, k, v):
    """F.scaled_dot_product_attention at p = 0 on the (B, H, N, 64) views
    of packed (B, N, H*64) tensors: the library call beside attention."""
    import torch.nn.functional as F

    def heads(x):
        b, n, hd = x.shape
        return x.view(b, n, hd // 64, 64).transpose(1, 2)

    return F.scaled_dot_product_attention(heads(q), heads(k), heads(v))


def _sdpa_bwd(q, k, v, do):
    """The library call beside the attention backward: SDPA's autograd
    backward (its forward run once, outside the timed call)."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = _sdpa(*leaves)
    g = do.view(out.shape[0], out.shape[2], out.shape[1], 64).transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def _ln_bwd_library(x, h, scale, bias, dy):
    import torch.nn.functional as F

    leaves = [t.detach().clone().requires_grad_() for t in (x, h, scale, bias)]
    out = F.layer_norm(leaves[0] + leaves[1], (x.shape[-1],), leaves[2], leaves[3], 1e-5)
    return lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)


def attention_cases(res, A, b, n, seed0, p, main=False):
    """Training attention forward and backward at (b, n, 768), dropout p."""
    q, k, v, do = (randn((b, n, 768), s) for s in range(seed0, seed0 + 4))
    keys = torch.ones((b, n), device="cuda")
    h, act = 12, b * n * 768 * 2
    compare(res, "attention_train", (b, n, 768, f"p={p}"),
            lambda: A.attention_train_fwd(q, k, v, keys, 0.125, 1234, p),
            lambda: A.attention_train_plain(q, k, v, keys, 0.125, 1234, p), 2 * BF16_ULP,
            cost(4 * b * h * n * n * 64, 4 * act + b * n * 4), lambda: _sdpa(q, k, v), main)
    compare(res, "attention_train_bwd", (b, n, 768, f"p={p}"),
            lambda: A.attention_train_bwd(q, k, v, keys, do, 0.125, 1234, p),
            lambda: A.attention_train_bwd_plain(q, k, v, keys, do, 0.125, 1234, p),
            2 * BF16_ULP, cost(10 * b * h * n * n * 64, 7 * act + b * n * 4),
            _sdpa_bwd(q, k, v, do), main)


def mlp_bwd_case(res, M, w, b, n, seed, form, p, main=False):
    w1, b1, w2, _ = w
    x, dy = randn((b, n, 768), seed), randn((b, n, 768), seed + 1)
    m = b * n
    compare(res, "fused_mlp_bwd", (b, n, 768, form, f"p={p}"),
            lambda: M.fused_mlp_bwd(x, w1, b1, w2, dy, form, 77, p),
            lambda: M.fused_mlp_bwd_plain(x, w1, b1, w2, dy, form, 77, p), 2 * BF16_ULP,
            cost(6 * m * 768 * 3072, (3 * m * 768 + 2 * m * 3072 + 2 * 768 * 3072) * 2),
            None, main)


def mlp_fwd_cost(m):
    return cost(4 * m * 768 * 3072, (2 * m * 768 + 2 * 768 * 3072 + 3072 + 768) * 2)


def kernel_phase():
    import torch.nn.functional as F

    from triad_tpu_torch.ops import attention as A
    from triad_tpu_torch.ops import frontend as FE
    from triad_tpu_torch.ops import layernorm as L
    from triad_tpu_torch.ops import mlp as M
    from triad_tpu_torch.ops import posconv as P

    res = []
    # attention: HuBERT packed (B, 499, 768), ViT merged (B, 261, 2304);
    # 2 bf16 ulps of the largest output.
    q, k, v = (randn((B, 499, 768), s) for s in (1, 2, 3))
    mask = torch.ones((B, 499), device="cuda")
    compare(res, "attention_eval", (B, 499, 768),
            lambda: A.attention_eval(q, k, v, mask),
            lambda: A.attention_eval_plain(q, k, v, mask, 0.125), 2 * BF16_ULP,
            cost(4 * B * 12 * 499 ** 2 * 64, 4 * B * 499 * 768 * 2 + B * 499 * 4),
            lambda: _sdpa(q, k, v))
    qkv = randn((B, 261, 2304), 4)
    ones = torch.ones((B, 261), device="cuda")
    compare(res, "attention_eval_merged", (B, 261, 2304),
            lambda: A.attention_eval_merged(qkv),
            lambda: A.attention_eval_plain(*qkv.split(768, dim=-1), ones, 0.125),
            2 * BF16_ULP, cost(4 * B * 12 * 261 ** 2 * 64, B * 261 * (2304 + 768) * 2),
            lambda: _sdpa(*qkv.split(768, dim=-1)))
    # fused MLP at both token counts and both GELU forms; 2 ulps. No one
    # library call computes fc1 + GELU + fc2.
    w1 = randn((3072, 768), 6, 768 ** -0.5)
    b1 = randn((3072,), 7, 0.1)
    w2 = randn((768, 3072), 8, 3072 ** -0.5)
    b2 = randn((768,), 9, 0.1)
    for n in (499, 261):
        x = randn((B, n, 768), 5)
        for form in ("tanh", "erf"):
            compare(res, "fused_mlp", (B, n, 768, form),
                    lambda: M.fused_mlp(x, w1, b1, w2, b2, form),
                    lambda: M.fused_mlp_plain(x, w1, b1, w2, b2, form), 2 * BF16_ULP,
                    mlp_fwd_cost(B * n))
    # frontend at (B, 160000): stats (fp32 sums in another order, 1e-4
    # of the largest variance), conv_0 and the stride-2 conv (2 ulps).
    # conv_0 runs on fp32 cores (peak 67 TFLOP/s).
    rng = np.random.default_rng(11)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to("cuda")
    w0 = f(rng.standard_normal((512, 1, 10)) * (2 / 10) ** 0.5)
    gs = f(rng.standard_normal(512) * 0.2 + 1.0)
    gb = f(rng.standard_normal(512) * 0.1)
    ws = [f(rng.standard_normal((512, 512, kk)) * (2 / (kk * 512)) ** 0.5)
          for kk in FE.KERNELS[1:]]
    wave = randn((B, AUDIO), 12, dtype=torch.float32)
    m0 = (AUDIO - 10) // 5 + 1
    compare(res, "frontend_stats", (B, AUDIO), lambda: FE.conv0_stats(wave, w0),
            lambda: FE.conv0_stats_plain(wave, w0), 1e-4,
            cost(2 * B * m0 * 512 * 11, B * AUDIO * 4 + 2 * B * 512 * 4, PEAK_FP32))
    mean, var = FE.conv0_stats_plain(wave, w0)
    scale = torch.rsqrt(var + FE.GN_EPS) * gs
    bias = gb - mean * scale
    compare(res, "frontend_conv0", (B, AUDIO),
            lambda: FE.conv0_norm_gelu(wave, w0, scale, bias, "tanh"),
            lambda: FE.conv0_norm_gelu_plain(wave, w0, scale, bias, "tanh"), 2 * BF16_ULP,
            cost(2 * B * m0 * 512 * 10, B * AUDIO * 4 + B * m0 * 512 * 2, PEAK_FP32))
    x1 = FE.conv0_norm_gelu_plain(wave, w0, scale, bias, "tanh")
    t1 = (x1.shape[1] - 3) // 2 + 1
    x1t, w1b = x1.transpose(1, 2).contiguous(), ws[0].to(torch.bfloat16)
    compare(res, "frontend_conv", (B, x1.shape[1], 512, "k3"),
            lambda: FE.conv_s2_gelu(x1, ws[0], "tanh"),
            lambda: FE.conv_s2_gelu_plain(x1, ws[0], "tanh"), 2 * BF16_ULP,
            cost(2 * B * t1 * 512 * 512 * 3, (B * (x1.shape[1] + t1) * 512 + 3 * 512 ** 2) * 2),
            lambda: F.conv1d(x1t, w1b, stride=2))
    # the whole stack, 7 bf16 layers: 4 ulps
    compare(res, "frontend (stack)", (B, AUDIO),
            lambda: FE.frontend(wave, w0, gs, gb, ws, "tanh"),
            lambda: FE.reference_frontend(wave, w0, gs, gb, ws, "tanh"), 4 * BF16_ULP,
            cost(2 * B * m0 * 512 * 10, B * AUDIO * 4 + B * 499 * 512 * 2, PEAK_FP32))
    # training kernels at the ViT's shapes (p = 0), at B and at the train
    # steps' batch. Attention forward: both round the same fp32 P (or D)
    # to bf16; backward: the kernels carry fp32 P and dS as bf16 hi + lo
    # halves; MLP backward: dh rounds to bf16 from an fp32 dg summed in
    # another order. 2 bf16 ulps of each output's largest magnitude.
    wmlp = (w1, b1, w2, b2)
    for b in (B, TRAIN_B):
        attention_cases(res, A, b, 261, 13, 0.0)
        for form in ("tanh", "erf"):
            mlp_bwd_case(res, M, wmlp, b, 261, 17, form, 0.0)
    # HuBERT's training shapes with its dropouts live, p = 0.1: the twins
    # draw the same keep mask, so a kernel that drew or replayed another
    # mask misses by whole values. Same bounds.
    for b in (B, TRAIN_B):
        main = b == TRAIN_B
        attention_cases(res, A, b, 499, 21, P_DROP, main)
        x = randn((b, 499, 768), 25)
        compare(res, "fused_mlp", (b, 499, 768, "tanh", f"p={P_DROP}"),
                lambda: M.fused_mlp(x, w1, b1, w2, b2, "tanh", 77, P_DROP),
                lambda: M.fused_mlp_plain(x, w1, b1, w2, b2, "tanh", 77, P_DROP),
                2 * BF16_ULP, mlp_fwd_cost(b * 499), None, main)
        mlp_bwd_case(res, M, wmlp, b, 499, 26, "tanh", P_DROP, main)
    # dropout + add + LayerNorm, fp32 stats: y, dx and dh round once to
    # bf16 (2 ulps); dscale and dbias are fp32 sums over the rows in
    # another order: the 2-ulp bound of the largest output covers them
    # (their error is ~1e-6 relative). Library: F.layer_norm(x + h) and
    # its autograd backward.
    gamma = randn((768,), 31, 0.2, torch.float32) + 1.0
    beta = randn((768,), 32, 0.1, torch.float32)
    for b in (B, TRAIN_B):
        x, hh, dy = (randn((b, 499, 768), s) for s in (33, 34, 35))
        act = b * 499 * 768 * 2
        g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
        for p in (0.0, P_DROP):
            main = b == TRAIN_B and p > 0
            compare(res, "layernorm", (b, 499, 768, f"p={p}"),
                    lambda: L.dropout_add_ln(x, hh, gamma, beta, 1e-5, 99, p),
                    lambda: L.dropout_add_ln_plain(x, hh, gamma, beta, 1e-5, 99, p),
                    2 * BF16_ULP, cost(10 * b * 499 * 768, 3 * act + 2 * 768 * 4, PEAK_FP32),
                    lambda: F.layer_norm(x + hh, (768,), g16, b16, 1e-5), main)
            compare(res, "layernorm_bwd", (b, 499, 768, f"p={p}"),
                    lambda: L.dropout_add_ln_bwd(x, hh, gamma, dy, 1e-5, 99, p),
                    lambda: L.dropout_add_ln_bwd_plain(x, hh, gamma, dy, 1e-5, 99, p),
                    2 * BF16_ULP, cost(20 * b * 499 * 768, 5 * act + 3 * 768 * 4, PEAK_FP32),
                    _ln_bwd_library(x, hh, g16, b16, dy), main)
    # the positional grouped conv, K = 128, 16 groups of 48: forward and dX
    # sum 6144 exact bf16 products in fp32 in another order and round once
    # (2 ulps); dW sums over every row in fp32 in another order (1e-4 of
    # the largest). Library: cuDNN's grouped conv1d, its input gradient and
    # its weight gradient (torch.nn.grad), on the (B, C, N) layout.
    wpc = randn((768, 48, 128), 41, (48 * 128) ** -0.5)
    bpc = randn((768,), 42, 0.1, torch.float32)
    bpc16 = bpc.to(torch.bfloat16)
    for b in (B, TRAIN_B):
        x, dz = randn((b, 499, 768), 43), randn((b, 499, 768), 44)
        flops = 2 * b * 499 * 768 * 128 * 48
        io = (2 * b * 499 * 768 + 768 * 48 * 128) * 2
        xt, gout = x.transpose(1, 2).contiguous(), F.pad(dz.transpose(1, 2), (0, 1)).contiguous()
        main = b == TRAIN_B
        compare(res, "posconv", (b, 499, 768, "erf"),
                lambda: P.pos_conv(x, wpc, bpc, 16, "erf"),
                lambda: P.pos_conv_plain(x, wpc, bpc, 16, "erf"), 2 * BF16_ULP,
                cost(flops, io), lambda: F.conv1d(xt, wpc, bpc16, padding=64, groups=16), main)
        compare(res, "posconv_dx", (b, 499, 768),
                lambda: P.pos_conv_dx(dz, wpc, 16), lambda: P.pos_conv_dx_plain(dz, wpc, 16),
                2 * BF16_ULP, cost(flops, io),
                lambda: torch.nn.grad.conv1d_input(xt.shape, wpc, gout, padding=64, groups=16),
                main)
        compare(res, "posconv_dw", (b, 499, 768),
                lambda: P.pos_conv_dw(x, dz, 16, 128),
                lambda: P.pos_conv_dw_plain(x, dz, 16, 128), 1e-4,
                cost(flops, 4 * b * 499 * 768 + 768 * 48 * 128 * 4),
                lambda: torch.nn.grad.conv1d_weight(xt, wpc.shape, gout, padding=64, groups=16),
                main)
    return res


def _post(url, body, content_type):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            fail(f"{url}: HTTP {r.status}")
        data = r.read()
        if r.headers.get("Content-Type") == "application/x-npy":
            return np.load(io.BytesIO(data), allow_pickle=False)
        return json.loads(data)


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def check(name, arr, shape):
    arr = np.asarray(arr, np.float32)
    if arr.shape != shape:
        fail(f"{name}: shape {arr.shape} != {shape}")
    if not np.isfinite(arr).all():
        fail(f"{name}: non-finite values")
    print(f"  {name:22s} {arr.shape} finite, |max| {float(np.abs(arr).max()):.4g}", flush=True)
    return arr


def serve_phase(serving):
    from triad_tpu_torch.serve.server import make_server

    srv = make_server(serving, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    rng = np.random.default_rng(1)
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
            if r.status != 200 or health.get("status") != "ok":
                fail("/healthz")
        print(f"  /healthz ok ({health['device_name']})", flush=True)
        audio = (rng.standard_normal((2, 160_000)) * 0.1).astype(np.float32)
        images = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
        ids = rng.integers(1, 30_000, size=(2, TXT)).astype(np.int32)
        mask = np.ones((2, TXT), np.float32)
        mask[1, TXT // 2:] = 0.0
        a = check("embed/audio", _post(base + "/v1/embed/audio", _npy(audio),
                                       "application/x-npy"), (2, 499, 512))
        v = check("embed/image", _post(base + "/v1/embed/image", _npy(images),
                                       "application/x-npy"), (2, 256, 512))
        t = check("embed/text (ids)", _post(base + "/v1/embed/text", json.dumps(
            {"ids": ids.tolist(), "mask": mask.tolist()}).encode(),
            "application/json")["tokens"], (2, TXT, 512))
        for direction, (qt, qm) in (("av", (a, np.ones((2, 499), np.float32))),
                                    ("tv", (t, mask))):
            body = {"query": {"tokens": qt.tolist(), "mask": qm.tolist()},
                    "key": {"tokens": v.tolist(), "mask": np.ones((2, 256)).tolist()},
                    "direction": direction}
            check(f"score ({direction})", _post(base + "/v1/score", json.dumps(body).encode(),
                                                "application/json")["scores"], (2, 2))
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    return audio, images, ids, mask, a, v, t


def reference_phase(serving, audio, images, ids, mask, a, v, t):
    """Served embeddings vs the same weights in float32 on the CPU (plain
    twins there). Per-token cosine similarity must exceed 0.99: the
    card runs bf16 with tanh GELUs, the CPU fp32 with erf in HuBERT's
    MLP, so agreement is at bf16 level, not bitwise."""
    import dataclasses

    from triad_tpu_torch.models.multimodal import TriadModel

    cfg = dataclasses.replace(serving.cfg, compute_dtype="float32")
    ref = TriadModel(cfg, device="cpu")
    ref.load_state_dict({k: p.cpu() for k, p in serving.model.state_dict().items()})
    ref.eval()
    with torch.inference_mode():
        outs = {
            "audio": (a[:1], ref.encode_audio(torch.from_numpy(audio[:1]))),
            "image": (v[:1], ref.encode_visual(torch.from_numpy(images[:1]))),
            "text": (t, ref.encode_text(torch.from_numpy(ids).long(), torch.from_numpy(mask))),
        }
    for name, (got, want) in outs.items():
        want = want.numpy()
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        print(f"  {name:6s} vs fp32 CPU: min token cosine {float(cos.min()):.5f}, "
              f"max abs err {float(np.abs(got - want).max()):.4g} "
              f"(|ref| max {float(np.abs(want).max()):.4g})", flush=True)
        if not cos.min() > 0.99:
            fail(f"{name} embeddings disagree with the fp32 CPU reference")


def _train_batch(b, seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, TRAIN_TXT), np.float32)
    mask[1::2, TRAIN_TXT * 3 // 4:] = 0.0  # every other caption padded
    return {
        "images": torch.from_numpy(rng.standard_normal((b, 224, 224, 3), dtype=np.float32)),
        "token_ids": torch.from_numpy(rng.integers(1, 30_000, size=(b, TRAIN_TXT))),
        "text_mask": torch.from_numpy(mask),
    }


def _av_batch(b, seed):
    rng = np.random.default_rng(seed)
    return {
        "images": torch.from_numpy(rng.standard_normal((b, 224, 224, 3), dtype=np.float32)),
        "audio": torch.from_numpy(rng.standard_normal((b, AUDIO), dtype=np.float32) * 0.1),
    }


def _step_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _new_state(ocfg, seed):
    from triad_tpu_torch.config import perf_train_model_config
    from triad_tpu_torch.models.convert import init_triad_model
    from triad_tpu_torch.train.optim import OptimizerBank
    from triad_tpu_torch.train.step import TrainState

    model = init_triad_model(perf_train_model_config(),
                             torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    return TrainState(model, OptimizerBank(ocfg, model, total_updates=1000), 0, 1)


def _run_steps(step, state, batches, loss_keys, n, warmup):
    """n steps; returns the median ms of the steps after ``warmup``."""
    times = []
    for i in range(n):
        (state, m), ms = _step_ms(lambda: step(state, *batches))
        losses = {k: float(m[k]) for k in loss_keys}
        print(f"  step {i} ({'warm-up' if i < warmup else 'timed'}): "
              + "  ".join(f"{k} {v:.6f}" for k, v in losses.items()) + f"  {ms:.3f} ms",
              flush=True)
        for k, v in losses.items():
            if not np.isfinite(v):
                fail(f"train step {i}: {k} {v}")
        if i >= warmup:
            times.append(ms)
    return statistics.median(times) if times else None


def _check_launches(launches, names, path):
    print(f"  launches during the steps: {launches}", flush=True)
    for name in names:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the {path} steps")


def train_phase():
    """The full-width text-visual step; returns the model, the launch
    counts of the steps and the median ms of the timed steps."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.config import OptimConfig, perf_train_loss_config
    from triad_tpu_torch.train.step import StepFactory

    ocfg = OptimConfig(gradient_accumulation_steps=1)
    state = _new_state(ocfg, 0)
    model = state.model
    step = StepFactory(perf_train_loss_config(), ocfg).make_step("tv")
    batch = {k: v.cuda() for k, v in _train_batch(TRAIN_B, 3).items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    kernels.reset_launches()
    step_ms = _run_steps(step, state, (None, batch), ("loss_tv",), 5, 2)
    launches = dict(kernels.LAUNCHES)
    for name, p in model.named_parameters():
        changed = not torch.equal(p, before[name])
        must_move = "lora_" in name or name.startswith(
            ("visual_projection", "text_projection", "temperature"))
        must_stay = name.startswith(("visual_backbone", "text_backbone", "audio_backbone")) \
            and "lora_" not in name
        if must_move and not changed:
            fail(f"{name} did not move in training")
        if must_stay and changed:
            fail(f"{name} (frozen or gated) changed in training")
    print("  LoRA factors, projection heads and temperature moved; ViT base, "
          "DistilBERT and HuBERT bit-unchanged", flush=True)
    _check_launches(launches, TV_KERNELS, "text-visual")
    profile_step(lambda: step(state, None, batch), "train_profile.txt")
    return model, launches, step_ms


def joint_phase():
    """The full-width joint step with every group unfrozen and HuBERT's
    dropouts live, then two audio-visual steps; returns the model, the
    launch counts of the joint steps, the median ms and the peak memory."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.config import OptimConfig, perf_train_loss_config
    from triad_tpu_torch.train.step import StepFactory

    # Unfreeze every group: the bank gates by requires_grad, so a gated
    # audio group would launch no HuBERT backward kernel.
    ocfg = OptimConfig(gradient_accumulation_steps=1, unfreeze_audio_step=0,
                       unfreeze_text_step=0, unfreeze_vit_step=0)
    state = _new_state(ocfg, 1)
    model = state.model
    factory = StepFactory(perf_train_loss_config(), ocfg)
    step = factory.make_step("joint")
    av = {k: v.cuda() for k, v in _av_batch(TRAIN_B, 5).items()}
    tv = {k: v.cuda() for k, v in _train_batch(TRAIN_B, 6).items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step_ms = _run_steps(step, state, (av, tv, 0.5, 0.5), ("loss_av", "loss_tv"), 5, 2)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"  median of 3 timed joint steps: {step_ms:.3f} ms; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB (max_memory_allocated)", flush=True)
    moved = 0
    for name, p in model.named_parameters():
        changed = not torch.equal(p, before[name])
        if name.startswith("audio_backbone") and not changed:
            fail(f"{name} did not move in the joint steps")
        if name.startswith("visual_backbone") and "lora_" not in name and changed:
            fail(f"{name} (the frozen ViT base) changed in training")
        moved += changed
    print(f"  {moved} parameter tensors moved, every HuBERT one among them (frontend and "
          "positional conv included); ViT base bit-unchanged", flush=True)
    _check_launches(launches, JOINT_KERNELS, "joint")
    profile_step(lambda: step(state, av, tv, 0.5, 0.5), "joint_profile.txt")
    phase("8b. two audio-visual steps")
    _run_steps(factory.make_step("av"), state, (av, None), ("loss_av",), 2, 2)
    return model, launches, step_ms, peak


def profile_step(fn, filename):
    """torch.profiler over one step: kernel self device time by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, ms = _step_ms(fn)
    # kernels only: a CPU op's row also carries its kernels' device time
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in rows) / 1e3
    lines = [f"step {ms:.3f} ms (CUDA events), kernel self device time {total:.3f} ms "
             f"({100 * total / ms:.1f}% busy)"]
    lines += [f"{e.self_device_time_total / 1e3:10.4f} ms {e.count:6d}x  {e.key[:110]}"
              for e in rows[:80]]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", filename), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join("  " + line for line in lines[:25]), flush=True)


def train_reference_phase(model, groups, av_batch, tv_batch):
    """One step's loss and per-group gradients at B = REF_B with every
    dropout off (train=False) and the given groups trainable: the card in
    bf16 against the same weights in float32 on the CPU (plain versions
    there). The loss must agree to 5e-2 relative (a bf16 pass through 12
    + 6 layers, HuBERT's bf16 frontend, and the squared-sim regularisers)
    and each group's gradient at cosine > 0.99."""
    import dataclasses

    from triad_tpu_torch.config import OptimConfig, perf_train_loss_config
    from triad_tpu_torch.models.multimodal import TriadModel
    from triad_tpu_torch.train.optim import label_for_path
    from triad_tpu_torch.train.step import StepFactory

    # HuBERT's mlp_impl "auto" takes the fused MLP (tanh GELU) on the card
    # and the plain erf-GELU MLP on the CPU: the reference takes the fused
    # MLP's fp32 twin, so both sides compute the same function.
    cfg = dataclasses.replace(model.cfg, compute_dtype="float32", hubert=dataclasses.replace(
        model.cfg.hubert, mlp_impl="fused"))
    ref = TriadModel(cfg, device="cpu")
    ref.load_state_dict({k: p.detach().cpu() for k, p in model.state_dict().items()})
    factory = StepFactory(perf_train_loss_config(), OptimConfig())

    def loss_and_grads(m, device):
        for name, p in m.named_parameters():
            p.requires_grad_(label_for_path(name) in groups)
            p.grad = None
        on = [None if b is None else {k: v.to(device) for k, v in b.items()}
              for b in (av_batch, tv_batch)]
        total, _ = factory.compute_losses(m, *on, None, train=False)
        total.backward()
        grads = {g: {} for g in groups}
        for name, p in m.named_parameters():
            if p.grad is not None:
                grads[label_for_path(name)][name] = p.grad.detach().double().cpu().ravel()
        return float(total.detach()), grads

    def cosine(a, b):
        return float(a @ b / (a.norm() * b.norm()))

    loss, by_name = loss_and_grads(model, "cuda")
    ref_loss, ref_by_name = loss_and_grads(ref, "cpu")
    rel = abs(loss - ref_loss) / abs(ref_loss)
    print(f"  loss bf16 card {loss:.6f} vs fp32 CPU {ref_loss:.6f} (rel {rel:.3g}, bound 5e-2)",
          flush=True)
    if not rel < 5e-2:
        fail("training loss disagrees with the fp32 CPU reference")
    for g, want_named in ref_by_name.items():
        want = torch.cat(list(want_named.values()))
        cos = cosine(torch.cat([by_name[g][n] for n in want_named]), want)
        # the tensor that carries the most of the difference, for diagnosis
        worst = max(want_named, key=lambda n: float((by_name[g][n] - want_named[n]).norm()))
        share = float((by_name[g][worst] - want_named[worst]).norm()) / float(
            (torch.cat([by_name[g][n] for n in want_named]) - want).norm())
        print(f"  grad {g:8s} cosine {cos:.6f} over {want.numel()} values (largest difference: "
              f"{worst}, cosine {cosine(by_name[g][worst], want_named[worst]):.4f}, "
              f"{100 * share:.0f}% of the difference norm)", flush=True)
        if not cos > 0.99:
            fail(f"{g} gradients disagree with the fp32 CPU reference")


def _kernel_entry(name, results, launches_by_path):
    src, replaces = KERNELS[name]
    cases = [r for r in results if r["name"] == name]
    head = next((r for r in cases if r["main"]), cases[0])
    keys = ("shape", "max_abs_err", "tol", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": sum(counts[name] for counts in launches_by_path.values()),
        "launches_by_path": {path: counts[name] for path, counts in launches_by_path.items()},
        **{k: head[k] for k in keys[1:]}, "shape": head["shape"],
        "cases": [{k: r[k] for k in keys} for r in cases],
    }


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    from triad_tpu_torch import kernels
    from triad_tpu_torch.cli.serve import load_config
    from triad_tpu_torch.serve.model import ServingModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    phase("2. build")
    path = kernels.build()
    kernels.library()
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    print(f"  built {os.path.relpath(path, ROOT)}", flush=True)

    phase("3. kernels vs plain (bf16, CUDA events, median of 20)")
    results = kernel_phase()

    phase("4. serve perf_eval_model_config() at full width")
    serving = ServingModel(load_config("perf_eval"), None, "cuda", AUDIO, 128)
    n_params = sum(p.numel() for p in serving.model.parameters())
    print(f"  {n_params} parameters, random init from seed 0", flush=True)
    kernels.reset_launches()
    served = serve_phase(serving)
    serve_launches = dict(kernels.LAUNCHES)
    print(f"  launches during the requests: {serve_launches}", flush=True)
    reference_phase(serving, *served)

    phase("5. launch counts")
    for name in SERVE_KERNELS:
        if serve_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the serving path")
    del serving
    torch.cuda.empty_cache()

    phase(f"6. text-visual train step, perf_train_model_config() at full width, B = {TRAIN_B}")
    model, tv_launches, tv_ms = train_phase()
    print(f"  median of 3 timed steps: {tv_ms:.3f} ms", flush=True)

    phase(f"7. text-visual train step at B = {REF_B}: bf16 card vs fp32 CPU")
    train_reference_phase(model, ("others", "text", "vit_lora"), None, _train_batch(REF_B, 4))
    del model
    torch.cuda.empty_cache()

    phase(f"8. joint train step, perf_train_model_config() at full width, B = {TRAIN_B}, "
          f"{AUDIO} samples, dropouts live")
    model, joint_launches, joint_ms, peak = joint_phase()

    phase(f"9. joint train step at B = {REF_B}, rates 0: bf16 card vs fp32 CPU")
    train_reference_phase(model, ("others", "audio", "text", "vit_lora"), _av_batch(REF_B, 7),
                          _train_batch(REF_B, 8))

    by_path = {"serve": serve_launches, "train_tv": tv_launches, "train_joint": joint_launches}
    kernels_json = [_kernel_entry(name, results, by_path) for name in KERNELS]
    print(json.dumps({"kernels": kernels_json, "train_step_ms": tv_ms, "joint_step_ms": joint_ms,
                      "joint_peak_bytes": peak}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
