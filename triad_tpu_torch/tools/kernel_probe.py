"""Ten measurements behind PERF.md's notes on the eval attention, the
training attention's di, the flash kernels, the positional conv's dW and
forward, the frontend activation, the fused MLP, the max-mean backward
and forward and HuBERT's conv_0 and its GroupNorm stats, on one CUDA
card, from the repo root:

    python3 triad_tpu_torch/tools/kernel_probe.py eval
    python3 triad_tpu_torch/tools/kernel_probe.py di
    python3 triad_tpu_torch/tools/kernel_probe.py flash
    python3 triad_tpu_torch/tools/kernel_probe.py posconv_dw
    python3 triad_tpu_torch/tools/kernel_probe.py activation
    python3 triad_tpu_torch/tools/kernel_probe.py fused_mlp
    python3 triad_tpu_torch/tools/kernel_probe.py maxmean
    python3 triad_tpu_torch/tools/kernel_probe.py maxmean_fwd
    python3 triad_tpu_torch/tools/kernel_probe.py posconv_fwd
    python3 triad_tpu_torch/tools/kernel_probe.py frontend

eval  what holds the eval attention back against SDPA. (1) Waves: its
      device ms at HuBERT's (B, 499, 768) for B = 1 .. 16, beside the
      grid's blocks and the waves they make (blocks per SM from the
      kernel's registers in the build log and its shared memory), and
      SDPA's; a kernel bound by whole waves of equal blocks steps up where
      a new wave starts and stays flat between. (2) Passes: the flash
      forward (csrc/attention_flash.cu: the same tiles, one pass, an online
      softmax) against the eval kernel (two passes) at (8, N) for N = 261,
      499, 1000 on the same inputs; device ms as chip_smoke.py's
      device_ms takes them.
di    what the precision of di = rowsum(dP * P) does to the training
      attention's dS, dq and dk. For each call: di summed in fp32 in the dQ
      kernel's tile order (each lane of a quad fma-accumulates its columns
      tile by tile, then the quad's xor-shuffle sum), in fp32 by a
      reduction tree (torch.sum), and in fp64 from the fp32 products (what
      the kernel does); from each, dS = P (dP - di) in fp32 and dq, dk in
      fp64; each against float64 throughout. Printed per call: the largest
      di error over the row's sum of |P dP|, the rows' cancellation
      (sum of P |dP| over sum of P |dP - di|: median and largest), and the
      relative error norm of dq and dk (and of the kernel's own bf16
      output). Inputs: phase 3's (64, 499, 768) p = 0.1 case, the
      attention calls of phase 8's first joint step (B = 64, dropouts live:
      the first 4 rows of each), and those of phase 9's B = 4 step on the
      weights phase 8 trained (which also prints phase 9's cosines).
flash what holds the flash kernels back against SDPA. (1) A B sweep at
      (B, 12, 261, 64) and (B, 12, 1000, 64): device ms of the flash
      forward and backward (csrc/attention_flash.cu) and of SDPA's forward
      and autograd backward on the same inputs, beside the items (128-row
      tiles of a head) and the waves they make on one block per SM. (2)
      The backward's split into its three kernels (di, dK/dV, dQ): self
      device time by kernel name under torch.profiler over 20 calls at
      (64, 261) and (8, 1000).
posconv_dw  what holds the positional conv's dW kernel back against
      torch.nn.grad.conv1d_weight. (1) A B sweep at (B, 499, 768), K = 128,
      16 groups of 48: device ms of the kernel and of conv1d_weight on the
      same inputs, and the kernel's TFLOP/s. (2) The share of its time
      that is copying: an edited copy of csrc/posconv.cu (built on its own
      into _build/probe/) whose dW kernel stages its first row tiles only
      and runs every later tile's products on them (EDITS below names the
      lines edited); its device ms beside the kernel's at each B. (3) The
      SM clock and power draw (nvidia-smi) while the kernel and the edited
      copy run. (4) VARIANTS, copies of the kernel with other constants
      (stages, rows per tile), timed beside it at (64, 499, 768) and held
      bit-equal to it.
activation  the frontend activation against the card's copy rate: device
      ms of "gelu" and "norm_gelu" (csrc/frontend_conv.cu) at (8, T, 512)
      for the frontend's row counts T, beside F.gelu and a plain
      y.copy_(x) on the same input, and each one's rate in GB/s (the
      input read once and the output written once); then ACT_VARIANTS,
      copies of the kernel with other constants (rows in flight), timed
      beside it at (8, 31999, 512) and held bit-equal to it.
fused_mlp  the fused MLP's forward and backward (csrc/fused_mlp.cu) at
      (B, N, 768 -> 3072 -> 768), tanh GELU, p = 0.1, for serving's and
      the train steps' row counts (8 x 128 .. 96 x 499): device ms,
      TFLOP/s and share of the bound (chip_smoke.py's), the cuBLAS
      composition at p = 0 beside them, and what the hidden activation's
      trip through device memory costs (one copy of g's bytes: its write
      by GEMM 1 and read by GEMM 2) as a share of the forward; at (64,
      499) the profiler's split of each call into its two grids,
      MLP_VARIANTS (copies of csrc/fused_mlp.cu with one text edit each:
      the epilogue plain or skipped, other widest tiles) timed beside the
      kernel, dW1 as ops/mlp.py:weight_grad forms it against the bf16-out
      product and the product of fp32 upcasts, the backward wrapper's
      transposes of W1 and W2, and the SM clock and power draw under load.
maxmean  the max-mean backward kernels (csrc/maxmean.cu) at phase 3's AV
      and TV shapes (D = 512, bf16): device ms of dQ and dK, TFLOP/s of
      their three product passes (the sims, then dts hi and lo times K or
      Q) and their share of the bf16 peak, the profiler's split of a call;
      MAXMEAN_VARIANTS (copies of csrc/maxmean.cu with one text edit each:
      how the two consumer warpgroups share the sim tile, the streamed
      tile's rows) timed beside the kernel and compared with its output;
      the SM clock and power draw under load.
maxmean_fwd  the max-mean forward (csrc/maxmean.cu) at phase 3's AV and
      TV shapes on grid features and the AV shape on real features: device
      ms, TFLOP/s and share of the bf16 peak, the key-clip ranges of its
      grid, the profiler's split of a call (the kernel, the clip sum, the
      wrapper's sums); MAXMEAN_FWD_VARIANTS (copies of csrc/maxmean.cu with
      one text edit each: 64-row items, a shorter ring, each chunk's
      products drained, no key ranges) timed beside the kernel and held
      bit-equal to it; the SM clock and power draw under load; then
      TS_EDITS, a copy in which the forward, dQ and dK kernels each write
      one tile of raw sims (real features, bf16 and split fp32): are the
      backward's recomputed sims the forward's, bit for bit?
posconv_fwd  the positional conv's forward and dX (csrc/posconv.cu) at
      (B, N, 768), K = 128, 16 groups, for (8, 499), (64, 499) and (8,
      1000): device ms, TFLOP/s, share of the bound and blocks, beside the
      mma.sync dW kernel (the same products) and cuDNN's grouped conv1d;
      the profiler's split at (64, 499); POSCONV_FWD_VARIANTS (copies of
      csrc/posconv.cu with one text edit each: (b) the outputs as wgmma's
      M, no epilogue, each stage's products drained, other rings, 256-row
      pieces) timed beside the kernel and held to its bits; the SM clock
      and power draw under load.
frontend  conv_0 and its GroupNorm stats (csrc/frontend.cu) at (B,
      160000) for B = 1, 8, 64: device ms of each wrapper beside its bound
      (chip_smoke.py's) and its library composition, and the profiler's
      split of a call (each wrapper's two grids); CONV0_VARIANTS (copies
      of csrc/frontend.cu with one text edit each: the stores cut, what
      the arithmetic costs; the GELU cut, what the stores cost; both; the
      GELU computed per element in place of the table; the lookups free
      of bank conflicts, timing only; other warp grids and tile heights;
      each copy's ptxas registers and spills) and STATS_VARIANTS (other
      block sizes) timed beside the kernels at B = 8 and 64, conv_0's held
      to the kernel's bits, the stats' largest difference from the
      kernel's given; the SM clock and power draw under load.
"""

import ctypes
import os
import re
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

cs.fail = lambda msg: print("WOULD FAIL: " + msg, flush=True)


def _registers(log, kernel):
    """Registers per thread of a kernel, from the -Xptxas -v build log."""
    name = None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name = hit.group(1)
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name and kernel in name:
            return int(hit.group(1))
    return None


def eval_probe():
    from triad_tpu_torch import kernels
    from triad_tpu_torch.ops import attention as A
    from triad_tpu_torch.ops import flash_attention as FA

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    regs = _registers(kernels.build_log, "attention_eval_kernel")
    smem = 2 * 5 * 64 * 64 + 4 * 2 * 64  # attention_eval.cu's SMEM
    per_sm = None
    if regs:
        warp_regs = -(-regs * 32 // 256) * 256
        per_sm = min(65536 // (4 * warp_regs), 233472 // (smem + 1024), 16)
    print(f"attention_eval_kernel: {regs} registers, {smem} B of shared memory: {per_sm} "
          f"blocks per SM, {sms} SMs", flush=True)
    for b in range(1, 17):
        q, k, v = (cs.randn((b, 499, 768), s) for s in (1, 2, 3))
        ones = torch.ones((b, 499), device="cuda")
        blocks = 8 * 12 * b
        waves = f"{blocks / (per_sm * sms):.2f}" if per_sm else "?"
        print(f"WAVES B {b:2d} blocks {blocks:4d} waves {waves}: eval "
              f"{cs.device_ms(lambda: A.attention_eval(q, k, v, ones)):.4f} SDPA "
              f"{cs.device_ms(lambda: cs._sdpa(q, k, v)):.4f} device ms", flush=True)
    for n in (261, 499, 1000):
        q, k, v = (cs.randn((8, n, 768), s) for s in (4, 5, 6))
        ones = torch.ones((8, n), device="cuda")
        heads = [t.view(8, n, 12, 64).transpose(1, 2) for t in (q, k, v)]
        got = A.attention_eval(q, k, v, ones)
        ref = FA.flash_attention_fwd(*heads, None, 0.125)[0].transpose(1, 2).reshape(8, n, 768)
        err = float((got.float() - ref.float()).abs().max())
        two = cs.device_ms(lambda: A.attention_eval(q, k, v, ones))
        one = cs.device_ms(lambda: FA.flash_attention_fwd(*heads, None, 0.125))
        print(f"PASSES (8, {n}, 768): eval (two passes) {two:.4f} flash forward (one pass) "
              f"{one:.4f} device ms, ratio {two / one:.3f}; outputs differ by {err:.3g}",
              flush=True)


def _tile_order_sum(p, dp):
    """rowsum(dp * p) as the dQ kernel's fp32 variant sums it: column c =
    64 t + 8 j + 2 l + e goes to lane l of the row's quad, which
    fma-accumulates its columns in (t, j, e) order in fp32; then the quad
    adds its four sums by two xor shuffles."""
    n = p.shape[-1]
    pad = -n % 64
    p, dp = (torch.nn.functional.pad(x, (0, pad)) for x in (p, dp))
    t = (n + pad) // 64
    lanes = lambda x: x.unflatten(-1, (t, 8, 4, 2)).movedim(-2, -4).flatten(-3)  # noqa: E731
    p, dp = lanes(p), lanes(dp)  # (..., 4 lanes, 16 t columns)
    acc = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    for i in range(p.shape[-1]):  # fma: an exact product, one rounding
        acc = (acc.double() + p[..., i].double() * dp[..., i].double()).float()
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def _rel(x, ref):
    return float((x - ref).norm() / ref.norm().clamp_min(1e-300))


def di_effect(A, q, k, v, mask, do, sm_scale, seed, p_drop, kernel=None):
    """The di variants' errors on (B, H, N, 64) views; kernel: the
    kernel's (dq, dk) in the same layout, or None."""
    f64 = torch.float64
    b, h, n, _ = q.shape
    q64, k64, v64, do64 = (x.to(f64) for x in (q, k, v, do))
    mask = torch.ones((b, k.shape[2]), device=q.device) if mask is None else mask
    s = q64 @ k64.transpose(-1, -2) * sm_scale + ((1.0 - mask.to(f64)) * -1e30)[:, None, None]
    p64 = torch.softmax(s, dim=-1)
    dp64 = do64 @ v64.transpose(-1, -2)
    if p_drop > 0:
        keep = A.attention_keep(b, h, n, k.shape[2], seed, p_drop, q.device)
        dp64 = torch.where(keep, dp64 / (1 - p_drop), 0.0)
    di64 = (dp64 * p64).sum(-1)
    ds64 = p64 * (dp64 - di64[..., None])
    dq64, dk64 = ds64 @ k64 * sm_scale, ds64.transpose(-1, -2) @ q64 * sm_scale
    p32, _, dp32 = A._train_bwd_terms(q, k, v, mask, do, sm_scale, seed, p_drop)
    scale = (p64 * dp64).abs().sum(-1).clamp_min(1e-300)
    cancel = scale / (p64 * (dp64 - di64[..., None]).abs()).sum(-1).clamp_min(1e-300)
    out = {"cancel_median": float(cancel.median()), "cancel_max": float(cancel.max())}
    for name, di in (("tile fp32", _tile_order_sum(p32, dp32)),
                     ("tree fp32", (dp32 * p32).sum(-1)),
                     ("fp64", (dp32.to(f64) * p32.to(f64)).sum(-1).float())):
        ds = p32 * (dp32 - di[..., None])
        out[name] = (float(((di.to(f64) - di64).abs() / scale).max()),
                     _rel(ds.to(f64) @ k64 * sm_scale, dq64),
                     _rel(ds.to(f64).transpose(-1, -2) @ q64 * sm_scale, dk64))
    if kernel is not None:
        out["kernel"] = (None, _rel(kernel[0].to(f64), dq64), _rel(kernel[1].to(f64), dk64))
    return out


def _line(label, r):
    parts = [f"{name}: di {v[0]:.3g} dq {v[1]:.3g} dk {v[2]:.3g}" if v[0] is not None
             else f"{name}: dq {v[1]:.3g} dk {v[2]:.3g}"
             for name, v in r.items() if isinstance(v, tuple)]
    return (f"DI {label}: cancellation median {r['cancel_median']:.3g} max "
            f"{r['cancel_max']:.4g}; " + "; ".join(parts))


def _summary(label, rows):
    if not rows:
        return
    for name in ("tile fp32", "tree fp32", "fp64", "kernel"):
        if name not in rows[0]:
            continue
        dq = [r[name][1] for r in rows]
        dk = [r[name][2] for r in rows]
        print(f"DI SUMMARY {label} ({len(rows)} calls) {name}: dq rel error median "
              f"{statistics.median(dq):.3g} max {max(dq):.3g}; dk median "
              f"{statistics.median(dk):.3g} max {max(dk):.3g}", flush=True)
    print(f"DI SUMMARY {label}: cancellation max {max(r['cancel_max'] for r in rows):.4g}",
          flush=True)


class _Capture:
    """Wraps the training attention's backward entry points: while
    ``rows`` (how many batch rows to analyse) is set, each CUDA call's
    first rows are analysed after it runs."""

    def __init__(self, A):
        self.A, self.rows, self.out = A, None, []
        self.strided, self.merged = A.attention_train_strided_bwd, A.attention_train_merged_bwd
        A.attention_train_strided_bwd, A.attention_train_merged_bwd = self._strided, self._merged

    def _take(self, q, k, v, mask, do, sm_scale, seed, p_drop, kernel):
        if self.rows is None or not q.is_cuda:
            return
        r = slice(0, self.rows)
        sub = lambda x: None if x is None else x[r]  # noqa: E731
        label = f"call {len(self.out)} {tuple(q.shape)} p={p_drop}"
        res = di_effect(self.A, *(sub(x) for x in (q, k, v, mask, do)), sm_scale, seed, p_drop,
                        tuple(sub(g) for g in kernel))
        print(_line(label, res), flush=True)
        self.out.append(res)

    def _strided(self, q, k, v, mask, do, sm_scale, seed=0, p_drop=0.0,
                 count="attention_train_strided_bwd", saved=None):
        grads = self.strided(q, k, v, mask, do, sm_scale, seed, p_drop, count, saved)
        self._take(q, k, v, mask, do, sm_scale, seed, p_drop, grads[:2])
        return grads

    def _merged(self, qkv, mask, do, sm_scale, seed=0, p_drop=0.0, saved=None):
        dqkv = self.merged(qkv, mask, do, sm_scale, seed, p_drop, saved)
        h = qkv.shape[-1] // 3 // 64
        heads = lambda t: t.unflatten(-1, (h, 64)).transpose(1, 2)  # noqa: E731
        q, k, v = (heads(t) for t in qkv.chunk(3, -1))
        dq, dk, _ = (heads(t) for t in dqkv.chunk(3, -1))
        self._take(q, k, v, mask, heads(do), sm_scale, seed, p_drop, (dq, dk))
        return dqkv


def di_probe():
    from triad_tpu_torch.config import OptimConfig, perf_train_loss_config
    from triad_tpu_torch.ops import attention as A
    from triad_tpu_torch.train.optim import GROUPS
    from triad_tpu_torch.train.step import StepFactory

    # phase 3's inputs, 4 rows at a time (each chunk draws its keep mask
    # as a batch of 4)
    b, n, p = cs.TRAIN_B, 499, cs.P_DROP
    q, k, v, do = (cs.randn((b, n, 768), s).view(b, n, 12, 64).transpose(1, 2)
                   for s in range(21, 25))
    keys = torch.ones((4, n), device="cuda")
    rows = [di_effect(A, *(x[r0:r0 + 4] for x in (q, k, v)), keys, do[r0:r0 + 4], 0.125, 1234, p)
            for r0 in range(0, b, 4)]
    print(_line(f"phase 3 inputs ({b}, {n}, 768) p={p}, rows 0-3", rows[0]), flush=True)
    _summary(f"phase 3 inputs ({b}, {n}, 768) p={p}", rows)
    del q, k, v, do
    # one joint step as phase 8 takes it (its first), every call analysed
    cap = _Capture(A)
    ocfg = OptimConfig(gradient_accumulation_steps=1, unfreeze_audio_step=0,
                       unfreeze_text_step=0, unfreeze_vit_step=0)
    state = cs._new_state(ocfg, 1)
    step = StepFactory(perf_train_loss_config(), ocfg).make_step("joint")
    av = {k: v.cuda() for k, v in cs._av_batch(cs.TRAIN_B, 5).items()}
    tv = {k: v.cuda() for k, v in cs._train_batch(cs.TRAIN_B, 6).items()}
    cap.rows = 4
    step(state, av, tv, 0.5, 0.5)
    torch.cuda.synchronize()
    cap.rows = None
    _summary("phase 8's first joint step, B = 64 (rows 0-3 of each call)", cap.out)
    del state, step, av, tv
    # phase 8 as chip_smoke.py runs it, then phase 9 on its weights
    model, *_ = cs.joint_phase()
    cap.out, cap.rows = [], 4
    cs.train_reference_phase(model, GROUPS, cs._av_batch(cs.REF_B, 7),
                             cs._train_batch(cs.REF_B, 8))
    _summary("phase 9, the B = 4 step on the trained weights", cap.out)


def flash_probe():
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from triad_tpu_torch.ops import flash_attention as FA

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def inputs(b, n):
        return [cs.randn((b, n, 12, 64), 41 + i).transpose(1, 2) for i in range(4)]

    for n, batches in ((261, (8, 16, 32, 64, 96)), (1000, (1, 2, 4, 8, 16))):
        for b in batches:
            q, k, v, do = inputs(b, n)
            o, l, m = FA.flash_attention_fwd(q, k, v, None, 0.125)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves)
            items = b * 12 * -(-n // 128)
            times = [cs.device_ms(fn) for fn in (
                lambda: FA.flash_attention_fwd(q, k, v, None, 0.125),
                lambda: FA.flash_attention_bwd(q, k, v, None, o, l, m, do, 0.125),
                lambda: F.scaled_dot_product_attention(q, k, v),
                lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))]
            print(f"SWEEP (B, 12, {n}, 64) B {b:3d} items {items:5d} waves {items / sms:6.2f}: "
                  f"flash fwd {times[0]:.4f} bwd {times[1]:.4f}, SDPA fwd {times[2]:.4f} "
                  f"bwd {times[3]:.4f} device ms", flush=True)
    for b, n in ((64, 261), (8, 1000)):
        q, k, v, do = inputs(b, n)
        o, l, m = FA.flash_attention_fwd(q, k, v, None, 0.125)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                FA.flash_attention_bwd(q, k, v, None, o, l, m, do, 0.125)
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 20e3) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        total = sum(t for _, t in rows)
        parts = "; ".join(f"{name[:40]} {t:.4f} ms ({100 * t / total:.1f}%)"
                          for name, t in sorted(rows, key=lambda r: -r[1]))
        print(f"SPLIT backward ({b}, 12, {n}, 64): {total:.4f} device ms per call: {parts}",
              flush=True)


# The edit that stops the dW kernel's copies after its first row tiles:
# the (what, by what) replacements, and the condition under which the
# edited kernel still copies or waits for a copy, which the edited source
# defines as PROBE_STAGE.
EDITS = (
    # the TMA ring: the prologue fills the 4 slots once, no slot is refilled
    # and no later tile waits for one
    ((("hp::mbar_wait(&full[s], parity);", "if (PROBE_STAGE) hp::mbar_wait(&full[s], parity);"),
      ("if (tid == 0 && it + DW_STAGES < ntiles) {",
       "if (tid == 0 && it + DW_STAGES < ntiles && PROBE_STAGE) {")),
     "(it < DW_STAGES)"),
)


# Variants of the dW kernel built from csrc/posconv.cu by replacing its
# constants: (name, replacements). Each sums every row in the kernel's
# order, so its dW is bit-equal to the kernel's.
_STAGES = "constexpr int DW_STAGES = 6;"
VARIANTS = (
    ("as built", ()),
    ("64-row tiles", (("constexpr int DW_ROWS = 128;", "constexpr int DW_ROWS = 64;"),)),
    ("4 stages", ((_STAGES, "constexpr int DW_STAGES = 4;"),)),
)


def _edited_lib(source, name):
    """Where _edited_libs builds the copy of csrc/source called name."""
    from triad_tpu_torch import kernels

    stem = re.sub(r"\W+", "_", f"{source}_{name}")
    return kernels.BUILD_DIR / "probe" / f"lib{stem}.so"


def _edited_libs(source, entry, argtypes, variants, report=None):
    """Copies of csrc/<source>, each with its (what, by what) replacements
    and a line of defines first, built alone and at once into
    _build/probe/; returns each one's ctypes entry point, by name.
    variants: (name, replacements, defines). report: print each copy's
    ptxas registers and spills of the kernels whose name holds it."""
    from triad_tpu_torch import kernels

    base = (kernels.CSRC / source).read_text()
    out = kernels.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    flags = [f for f in kernels.NVCC_FLAGS if report or f not in ("-Xptxas", "-v")]
    procs = {}
    for name, pairs, define in variants:
        src = base
        for old, new in pairs:
            if old not in src:
                raise SystemExit(f"kernel_probe: {old!r} is not in csrc/{source}")
            src = src.replace(old, new)
        lib = _edited_lib(source, name)
        lib.with_suffix(".cu").write_text(define + src)
        procs[name] = (lib, subprocess.Popen(
            [kernels._nvcc(), *flags, "-I", str(kernels.CSRC), "-shared", "-o", str(lib),
             str(lib.with_suffix(".cu"))], stdout=subprocess.PIPE if report else None,
            stderr=subprocess.STDOUT if report else None, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0] or ""
        if proc.returncode != 0:
            raise SystemExit(f"kernel_probe: the {name!r} copy of csrc/{source} did not build")
        kernel = ""
        for line in log.splitlines():
            hit = re.search(r"Compiling entry function '([^']+)'", line)
            kernel = hit.group(1) if hit else kernel
            if report and report in kernel and ("registers" in line or "spill" in line):
                print(f"PTXAS {name}: {kernel[-48:]} {line.strip()[-90:]}", flush=True)
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


_DW_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ACT_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 5)


def _nocopy_variant():
    """The dW kernel with its copies cut after the first tiles (EDITS), as
    a variant of _edited_libs."""
    from triad_tpu_torch import kernels

    src = (kernels.CSRC / "posconv.cu").read_text()
    for pairs, first in EDITS:
        if all(old in src for old, _ in pairs):
            return ("without copies", pairs, f"#define PROBE_STAGE {first}\n")
    raise SystemExit("kernel_probe: no edit of EDITS matches csrc/posconv.cu")


def _under_load(fn, seconds=1.5):
    """nvidia-smi's SM clock and power draw while fn runs back to back for
    about ``seconds`` (the calls queued first, the query made while the
    card works through them)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    for _ in range(max(1, int(seconds * 1e3 / max(start.elapsed_time(end), 1e-3)))):
        fn()
    time.sleep(0.5)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    torch.cuda.synchronize()
    return smi


def posconv_dw_probe():
    import torch.nn.functional as F

    from triad_tpu_torch import kernels
    from triad_tpu_torch.ops import posconv as P

    def launcher(fn, x, dz, dw, b):
        def run():
            err = fn(x.data_ptr(), dz.data_ptr(), dw.data_ptr(), b, 499, 768, 128, 64,
                     kernels.stream_ptr(dw))
            if err:
                raise RuntimeError(f"edited posconv_dw: cudaError_t {err}")
        return run

    libs = _edited_libs("posconv.cu", "triad_posconv_dw", _DW_ARGS,
                        [_nocopy_variant()] + [(name, pairs, "") for name, pairs in VARIANTS])
    nocopy = libs["without copies"]
    for b in (8, 16, 32, 64, 96):
        x, dz = cs.randn((b, 499, 768), 43), cs.randn((b, 499, 768), 44)
        xt = x.transpose(1, 2).contiguous()
        gout = F.pad(dz.transpose(1, 2), (0, 1)).contiguous()
        dw = torch.empty((768, 48, 128), dtype=torch.float32, device="cuda")
        flops = 2 * b * 499 * 768 * 128 * 48
        kern = cs.device_ms(lambda: P.pos_conv_dw(x, dz, 16, 128))
        lib = cs.device_ms(lambda: torch.nn.grad.conv1d_weight(xt, (768, 48, 128), gout,
                                                               padding=64, groups=16))
        cut = cs.device_ms(launcher(nocopy, x, dz, dw, b))
        print(f"DW (B, 499, 768) B {b:3d}: kernel {kern:.4f} ({flops / kern / 1e9:.1f} TFLOP/s) "
              f"conv1d_weight {lib:.4f} ({lib / kern:.3f}x the kernel's speed) device ms; "
              f"without copies after the first tiles {cut:.4f} ms ({100 * cut / kern:.1f}% of the "
              f"kernel's time)", flush=True)
    b = 64
    x, dz = cs.randn((b, 499, 768), 43), cs.randn((b, 499, 768), 44)
    dw = torch.empty((768, 48, 128), dtype=torch.float32, device="cuda")
    want = P.pos_conv_dw(x, dz, 16, 128)
    print(f"LOAD (64, 499, 768): kernel under load: clocks.sm, power.draw "
          f"{_under_load(lambda: P.pos_conv_dw(x, dz, 16, 128))}; without copies "
          f"{_under_load(launcher(nocopy, x, dz, dw, b))}", flush=True)
    for name, _ in VARIANTS:
        run = launcher(libs[name], x, dz, dw, b)
        run()
        got = dw
        print(f"VARIANT (64, 499, 768) {name}: {cs.device_ms(run):.4f} device ms (kernel "
              f"{cs.device_ms(lambda: P.pos_conv_dw(x, dz, 16, 128)):.4f}); bit-equal to the "
              f"kernel: {torch.equal(got, want)}", flush=True)


# Variants of the activation kernel built from csrc/frontend_conv.cu by
# replacing its constants: (name, replacements). Each computes every
# element as the kernel does, so its output is bit-equal to the kernel's.
ACT_VARIANTS = (
    ("as built", ()),
    ("8 rows in flight", (("constexpr int ACT_UNROLL = 4;", "constexpr int ACT_UNROLL = 8;"),)),
    ("2 rows in flight", (("constexpr int ACT_UNROLL = 4;", "constexpr int ACT_UNROLL = 2;"),)),
)


def activation_probe():
    import torch.nn.functional as F

    from triad_tpu_torch import kernels
    from triad_tpu_torch.ops import frontend_conv as FC

    b, c = 8, 512
    stats = (cs.randn((b, 1, c), 55, 0.3, torch.float32),
             cs.randn((b, 1, c), 56, 0.2, torch.float32).abs() + 0.5,
             cs.randn((c,), 57, 0.3, torch.float32) + 1.0, cs.randn((c,), 58, 0.1, torch.float32))
    for t in (999, 1999, 3999, 7999, 15999, 31999):
        x = cs.randn((b, t, c), 61)
        y = torch.empty_like(x)
        gb = 2 * x.numel() * x.element_size() / 1e6  # read once, written once: GB per ms
        times = [cs.device_ms(fn) for fn in (
            lambda: FC.frontend_activation_fwd(x, *stats, "gelu"),
            lambda: FC.frontend_activation_fwd(x, *stats, "norm_gelu"),
            lambda: F.gelu(x), lambda: y.copy_(x))]
        print(f"ACT (8, {t}, 512): " + "; ".join(
            f"{name} {ms:.4f} device ms ({gb / ms:.0f} GB/s)"
            for name, ms in zip(("gelu", "norm_gelu", "F.gelu", "copy"), times)), flush=True)
    libs = _edited_libs("frontend_conv.cu", "triad_frontend_act", _ACT_ARGS,
                        [(name, pairs, "") for name, pairs in ACT_VARIANTS])
    x = cs.randn((b, 31999, c), 61)
    y = torch.empty_like(x)
    flat = [s.reshape(-1).contiguous() for s in stats]
    for name, _ in ACT_VARIANTS:
        for mode, act in ((1, "gelu"), (2, "norm_gelu")):
            def run(fn=libs[name], mode=mode):
                err = fn(x.data_ptr(), y.data_ptr(), b, 31999, c, mode,
                         *(s.data_ptr() for s in flat), kernels.stream_ptr(y))
                if err:
                    raise RuntimeError(f"edited frontend_act: cudaError_t {err}")
            run()
            same = torch.equal(y, FC.frontend_activation_fwd(x, *stats, act))
            kern = cs.device_ms(lambda: FC.frontend_activation_fwd(x, *stats, act))
            print(f"ACT VARIANT (8, 31999, 512) {act} {name}: {cs.device_ms(run):.4f} device ms "
                  f"(kernel {kern:.4f}, F.gelu {cs.device_ms(lambda: F.gelu(x)):.4f}); bit-equal "
                  f"to the kernel: {same}", flush=True)


def _split(fn, calls=10):
    """Self device ms per call of each kernel fn launches, by name, under
    torch.profiler over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / (calls * 1e3)) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return "; ".join(f"{name[:48]} {t:.4f}" for name, t in sorted(rows, key=lambda r: -r[1]))


# Variants of the fused MLP built from csrc/fused_mlp.cu by replacing a
# line: (name, replacements). "plain epilogue" stores every tile's sums
# as bf16 with the bias and nothing else (no GELU, GELU', mask or second
# output): what the epilogues' arithmetic costs; "no epilogue" skips the
# epilogue (the products alone). Their outputs differ; the tile and block
# variants' are bit-equal.
MLP_VARIANTS = (
    ("as built", ()),
    ("plain epilogue", (("epilogue_any<BN, MODE>(d0, d1, p,",
                         "epilogue_any<BN, EPI_LINEAR>(d0, d1, p,"),)),
    ("no epilogue", (("epilogue_any<BN, MODE>(d0, d1, p,",
                      "if (p.m < 0) epilogue_any<BN, MODE>(d0, d1, p,"),)),
    ("GEMM 1 at BN 256", (("WIDEST_GELU = 128", "WIDEST_GELU = 256"),)),
    ("one-product GEMMs at BN 128", (("WIDEST_LINEAR = 256", "WIDEST_LINEAR = 128"),)),
    ("dual kernel at BN 64", (("WIDEST_DGELU = 128", "WIDEST_DGELU = 64"),)),
    ("GEMM 1 on two consumer warpgroups", (("constexpr int GELU_CONSUMERS = 3;",
                                            "constexpr int GELU_CONSUMERS = 2;"),)),
)


def _mlp_runner(fn, x, w1, b1, w2, b2, dy, p, backward):
    """A call of an edited copy's entry point on phase 3's operands."""
    from triad_tpu_torch import kernels

    m, din = x.shape[0] * x.shape[1], x.shape[-1]
    dh, dout = w1.shape[0], w2.shape[0]
    y = torch.empty((m, dout), dtype=x.dtype, device="cuda")
    g, dhid, dx = (torch.empty((m, n), dtype=x.dtype, device="cuda") for n in (dh, dh, din))
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    drop = kernels.dropout_args(77, p)

    def run():
        if backward:
            err = fn(x.data_ptr(), w1.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
                     dy.data_ptr(), dx.data_ptr(), dhid.data_ptr(), g.data_ptr(), m, din, dh,
                     dout, 1, *drop, kernels.stream_ptr(x))
        else:
            err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                     y.data_ptr(), g.data_ptr(), m, din, dh, dout, 1, *drop,
                     kernels.stream_ptr(x))
        if err:
            raise RuntimeError(f"edited fused_mlp: cudaError_t {err}")
        return (dx, dhid, g) if backward else y
    return run


def fused_mlp_probe():
    from triad_tpu_torch import kernels
    from triad_tpu_torch.ops import mlp as M

    w1, b1 = cs.randn((3072, 768), 6, 768 ** -0.5), cs.randn((3072,), 7, 0.1)
    w2, b2 = cs.randn((768, 3072), 8, 3072 ** -0.5), cs.randn((768,), 9, 0.1)
    for b, n in ((8, 128), (8, 261), (8, 499), (64, 261), (64, 499), (96, 499)):
        m = b * n
        x, dy = cs.randn((b, n, 768), 25), cs.randn((b, n, 768), 26)
        g = torch.empty((m, 3072), dtype=torch.bfloat16, device="cuda")
        g2 = torch.empty_like(g)
        fwd_bound, _ = cs.mlp_fwd_cost(m)
        bwd_bound = 6 * m * 768 * 3072 / cs.PEAK_BF16 * 1e3
        times = [cs.device_ms(fn) for fn in (
            lambda: M.fused_mlp(x, w1, b1, w2, b2, "tanh", 77, cs.P_DROP),
            lambda: M.fused_mlp_bwd(x, w1, b1, w2, dy, "tanh", 77, cs.P_DROP),
            cs.mlp_fwd_composition(x, w1, b1, w2, b2, "tanh"),
            cs.mlp_bwd_composition(x, w1, b1, w2, dy, "tanh"),
            lambda: g2.copy_(g))]
        fwd, bwd, cfwd, cbwd, trip = times
        print(f"MLP ({b}, {n}, 768) M {m:6d} tanh p={cs.P_DROP}: forward {fwd:.4f} device ms "
              f"({4 * m * 768 * 3072 / fwd / 1e9:.1f} TFLOP/s, {100 * fwd_bound / fwd:.1f}% of "
              f"the bound {fwd_bound:.4f}); backward {bwd:.4f} ({6 * m * 768 * 3072 / bwd / 1e9:.1f}"
              f" TFLOP/s, {100 * bwd_bound / bwd:.1f}% of {bwd_bound:.4f}); composition at p = 0: "
              f"forward {cfwd:.4f}, backward {cbwd:.4f}; g round trip (one copy of g's bytes) "
              f"{trip:.4f} ms, {100 * trip / fwd:.1f}% of the forward", flush=True)
    x, dy = cs.randn((64, 499, 768), 25), cs.randn((64, 499, 768), 26)
    fwd = lambda: M.fused_mlp(x, w1, b1, w2, b2, "tanh", 77, cs.P_DROP)  # noqa: E731
    bwd = lambda: M.fused_mlp_bwd(x, w1, b1, w2, dy, "tanh", 77, cs.P_DROP)  # noqa: E731
    for p in (0.0, cs.P_DROP):
        print(f"SPLIT p={p} forward (64, 499, 768), ms per call: "
              f"{_split(lambda: M.fused_mlp(x, w1, b1, w2, b2, 'tanh', 77, p))}", flush=True)
        print(f"SPLIT p={p} backward (64, 499, 768), ms per call: "
              f"{_split(lambda: M.fused_mlp_bwd(x, w1, b1, w2, dy, 'tanh', 77, p))}", flush=True)
    fwd_fns = _edited_libs("fused_mlp.cu", "triad_fused_mlp", kernels._SIGNATURES[
        "triad_fused_mlp"], [(name, pairs, "") for name, pairs in MLP_VARIANTS])
    bwd_fns = {}
    for name, _ in MLP_VARIANTS:
        bwd_fns[name] = ctypes.CDLL(str(_edited_lib("fused_mlp.cu", name))).triad_fused_mlp_bwd
        bwd_fns[name].argtypes = kernels._SIGNATURES["triad_fused_mlp_bwd"]
        bwd_fns[name].restype = ctypes.c_int
    want = fwd(), bwd()
    for name, _ in MLP_VARIANTS:
        runs = [_mlp_runner(fns[name], x, w1, b1, w2, b2, dy, cs.P_DROP, backward)
                for fns, backward in ((fwd_fns, False), (bwd_fns, True))]
        same = [torch.equal(runs[0](), want[0].reshape(-1, 768)),
                all(torch.equal(a, b.reshape(a.shape)) for a, b in zip(runs[1](), want[1]))]
        print(f"VARIANT (64, 499, 768) {name}: forward {cs.device_ms(runs[0]):.4f} backward "
              f"{cs.device_ms(runs[1]):.4f} device ms (kernel {cs.device_ms(fwd):.4f} / "
              f"{cs.device_ms(bwd):.4f}); bit-equal to the kernel: {same}", flush=True)
    f32, dh2 = torch.float32, cs.randn((64 * 499, 3072), 27)
    x2 = x.reshape(-1, 768)
    times = [cs.device_ms(fn) for fn in (
        lambda: M.weight_grad(dh2, x2, torch.bfloat16),
        lambda: (dh2.t() @ x2),
        lambda: (dh2.to(f32).t() @ x2.to(f32)).to(torch.bfloat16))]
    print(f"WGRAD dW1 = dh^T x at (64, 499): weight_grad (bf16, fp32 out) {times[0]:.4f}, bf16 "
          f"out {times[1]:.4f}, the fp32 upcasts (TF32 off) {times[2]:.4f} device ms", flush=True)
    print(f"TRANSPOSES of W1 and W2 (the backward wrapper's): "
          f"{cs.device_ms(lambda: (w1.t().contiguous(), w2.t().contiguous())):.4f} device ms",
          flush=True)
    print(f"LOAD (64, 499, 768): clocks.sm, power.draw: forward {_under_load(fwd)}; backward "
          f"{_under_load(bwd)}", flush=True)


# Variants of the max-mean backward built from csrc/maxmean.cu by
# replacing a line: (name, replacements). The kernel as built is design
# (a): each output warpgroup computes a tile's whole sim tile and dts
# itself (4 product passes). "sims warpgroup" is design (c): a third
# consumer warpgroup computes each tile's sims and dts once (3 passes) and
# the two output warpgroups read dts from shared memory. "32-row tiles"
# streams 32-row tiles for bf16 features too (4 stages at D = 512 instead
# of 2). On phase 3's inputs every sim is exact, so all of them give the
# kernel's bits.
_SIMS = "constexpr int SIM_WG = 0;"
_ROWS32 = ("constexpr int stream_rows() { return SPLIT ? 32 : 64; }",
           "constexpr int stream_rows() { return 32; }")
MAXMEAN_VARIANTS = (
    ("as built", ()),
    ("sims warpgroup", ((_SIMS, "constexpr int SIM_WG = 1;"),)),
    ("32-row tiles", (_ROWS32,)),
)


def _maxmean_runner(fn, args, dq):
    """A call of an edited copy's dQ (or dK) entry point on the arguments
    of ops/maxmean.py:maxmean_dq."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.ops import maxmean as MM

    q, k, temp, coeff, clamp_min, amax, g_clip, g_nn = args
    keep, ptrs, (bq, bk, nq, nk, d) = MM._kernel_args("maxmean", q, k, temp, coeff)
    g_nn = g_nn.reshape(1).contiguous()
    out = torch.empty(q.shape if dq else k.shape, dtype=torch.float32, device="cuda")

    def run():
        err = fn(*ptrs, g_clip.data_ptr(), g_nn.data_ptr(), amax.data_ptr(), out.data_ptr(), bq,
                 bk, nq, nk, d, float(clamp_min), kernels.stream_ptr(out))
        if err:
            raise RuntimeError(f"edited maxmean: cudaError_t {err}")
        return out
    run.keep = keep
    return run


def _maxmean_args(nq, masked, clamp_min):
    """phase 3's max-mean backward arguments at (64 x nq) x (64 x 256), D =
    512 (chip_smoke.py:maxmean_cases' inputs)."""
    from triad_tpu_torch.ops import maxmean as MM

    q, k = cs.grid((64, nq, 512), 91, False), cs.grid((64, 256, 512), 92, True)
    mask = None
    if masked:
        mask = torch.ones((64, nq), device="cuda")
        mask[1::2, nq * 3 // 4:] = 0.0
    coeff = MM.coefficients(64, nq, mask, "cuda")
    temp = torch.tensor(1.5, device="cuda")
    amax = MM.maxmean_plain(q, k, temp, coeff, clamp_min)[3]
    return (q, k, temp, coeff, clamp_min, amax, cs.randn((64, 64), 93, 1.0 / 64, torch.float32),
            torch.tensor(0.01, device="cuda"))


def maxmean_probe():
    from triad_tpu_torch import kernels
    from triad_tpu_torch.ops import maxmean as MM

    cases = (("AV (64 x 499) x (64 x 256)", _maxmean_args(499, False, -60.0)),
             ("TV (64 x 32 masked) x (64 x 256)", _maxmean_args(32, True, -20.0)))
    for label, args in cases:
        q, k = args[0], args[1]
        ops = 2 * q.shape[0] * k.shape[0] * q.shape[1] * k.shape[1] * q.shape[2]
        for name, fn in (("dQ", MM.maxmean_dq), ("dK", MM.maxmean_dk)):
            ms = cs.device_ms(lambda: fn(*args))
            print(f"MAXMEAN {label} {name}: {ms:.4f} device ms, {3 * ops / ms / 1e9:.1f} TFLOP/s "
                  f"of its three product passes ({100 * 3 * ops / cs.PEAK_BF16 * 1e3 / ms:.1f}% "
                  f"of their {3 * ops / cs.PEAK_BF16 * 1e3:.4f} ms at the bf16 peak)", flush=True)
        print(f"SPLIT {label}, ms per call: "
              f"{_split(lambda: (MM.maxmean_dq(*args), MM.maxmean_dk(*args)))}", flush=True)
    fns = {"triad_maxmean_dq": _edited_libs(
        "maxmean.cu", "triad_maxmean_dq", kernels._SIGNATURES["triad_maxmean_dq"],
        [(name, pairs, "") for name, pairs in MAXMEAN_VARIANTS])}
    fns["triad_maxmean_dk"] = {}
    for name in fns["triad_maxmean_dq"]:
        fn = ctypes.CDLL(str(_edited_lib("maxmean.cu", name))).triad_maxmean_dk
        fn.argtypes = kernels._SIGNATURES["triad_maxmean_dk"]
        fn.restype = ctypes.c_int
        fns["triad_maxmean_dk"][name] = fn
    for label, args in cases:
        want = MM.maxmean_dq(*args), MM.maxmean_dk(*args)
        for name, _ in MAXMEAN_VARIANTS:
            runs = [_maxmean_runner(fns[entry][name], args, dq)
                    for entry, dq in (("triad_maxmean_dq", True), ("triad_maxmean_dk", False))]
            outs = [run().clone() for run in runs]
            errs = [cs.max_err(o, w) for o, w in zip(outs, want)]
            print(f"VARIANT {label} {name}: dQ {cs.device_ms(runs[0]):.4f} dK "
                  f"{cs.device_ms(runs[1]):.4f} device ms (kernel "
                  f"{cs.device_ms(lambda: MM.maxmean_dq(*args)):.4f} / "
                  f"{cs.device_ms(lambda: MM.maxmean_dk(*args)):.4f}); bit-equal to the kernel: "
                  f"{[torch.equal(o, w) for o, w in zip(outs, want)]}, largest difference over "
                  f"the largest output {[e / max(m, 1e-30) for e, m in errs]}", flush=True)
    args = cases[0][1]
    print(f"LOAD AV: clocks.sm, power.draw: dQ {_under_load(lambda: MM.maxmean_dq(*args))}; dK "
          f"{_under_load(lambda: MM.maxmean_dk(*args))}", flush=True)


# Variants of the max-mean forward built from csrc/maxmean.cu by
# replacing a line: (name, replacements). As built, a block holds two
# 64-row items (128 query rows) that share each 128-key stage, and each
# warpgroup folds a sim tile while the next one's products run. "64-row
# items" gives a block one item (twice the blocks, each streaming all of
# K); "64-key tiles" m64n64 products on 64-key stages (4 or 8 of them);
# "6 stages" and "3 stages" other rings; "folds not overlapped" waits for every chunk's products
# before going on (no fold overlaps a product); "one key range" never
# cuts the key clips (the TV shape then runs 32 blocks). Every variant
# sums each sim in the kernel's order, so its outputs are bit-equal to the
# kernel's.
_FWD_CONS = "static constexpr int CONS = SPLIT && NC == 8 ? 1 : 2;"
_FWD_STAGES = "constexpr int FW_MAX_STAGES = 4;"
_FWD_64_KEYS = (("constexpr int FW_KEYS = 128;", "constexpr int FW_KEYS = 64;"),
                ("  wgmma_m64n128k16(d, desc_sw128(a), desc_sw128(b), accumulate);",
                 "  wgmma_m64n64k16(d, desc_sw128(a), desc_sw128(b), accumulate);"))
MAXMEAN_FWD_VARIANTS = (
    ("as built", ()),
    ("64-row items", ((_FWD_CONS, "static constexpr int CONS = 1;"),)),
    ("64-key tiles", _FWD_64_KEYS),
    ("64-key tiles, 8 stages", _FWD_64_KEYS + ((_FWD_STAGES, "constexpr int FW_MAX_STAGES = 8;"),)),
    ("6 stages", ((_FWD_STAGES, "constexpr int FW_MAX_STAGES = 6;"),)),
    ("3 stages", ((_FWD_STAGES, "constexpr int FW_MAX_STAGES = 3;"),)),
    ("folds not overlapped", (("      wgmma_wait<1>();\n      if (t == 0) mbar_arrive(&s.empty[pending]);",
                               "      wgmma_wait<0>();\n      if (t == 0) mbar_arrive(&s.empty[pending]);"),)),
    ("one key range", (("  if (blocks < sms) ranges", "  if (blocks < 0) ranges"),)),
)


def _maxmean_fwd_runner(fn, q, k, temp, coeff, clamp_min):
    """A call of an edited copy's forward entry point on the arguments of
    ops/maxmean.py:maxmean_fwd; returns (clip, amax, partials), clip the
    partials summed over the query tiles as the wrapper sums them."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.ops import maxmean as MM

    keep, ptrs, (bq, bk, nq, nk, d) = MM._kernel_args("maxmean", q, k, temp, coeff)
    amax = torch.empty((bq, bk, nq), dtype=torch.int32, device="cuda")
    part = torch.empty((-(-nq // MM.ROWS), bq, bk, 3), dtype=torch.float32, device="cuda")

    def run():
        err = fn(*ptrs, None, amax.data_ptr(), part.data_ptr(), bq, bk, nq, nk, d,
                 float(clamp_min), kernels.stream_ptr(amax))
        if err:
            raise RuntimeError(f"edited maxmean forward: cudaError_t {err}")
        return part[..., 0].sum(dim=0), amax, part
    run.keep = keep
    return run


def _maxmean_fwd_cases():
    """phase 3's forward inputs: the AV and TV shapes on grid features, and
    the AV shape on real L2-normalised features (chip_smoke.py)."""
    import numpy as np

    from triad_tpu_torch.ops import maxmean as MM

    cases = []
    for label, nq, masked, cm in (("AV (64 x 499) x (64 x 256)", 499, False, -60.0),
                                  ("TV (64 x 32 masked) x (64 x 256)", 32, True, -20.0)):
        q, k = cs.grid((64, nq, 512), 91, False), cs.grid((64, 256, 512), 92, True)
        mask = None
        if masked:
            mask = torch.ones((64, nq), device="cuda")
            mask[1::2, nq * 3 // 4:] = 0.0
        cases.append((label, (q, k, torch.tensor(1.5, device="cuda"),
                              MM.coefficients(64, nq, mask, "cuda"), cm)))
    rng = np.random.default_rng(94)
    q, k = (torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)), dim=-1).to("cuda", torch.bfloat16)
        for shape in ((64, 499, 512), (64, 256, 512)))
    cases.append(("AV real features", (q, k, torch.tensor(10.0, device="cuda"),
                                       MM.coefficients(64, 499, None, "cuda"), -60.0)))
    return cases


# An edited copy of csrc/maxmean.cu in which the forward, the dQ and the
# dK kernel each write the raw sims of one tile to a device buffer: query
# rows 0-63 of clip 0 against keys 0-63 of clip 0 (block (0, 0), first
# warpgroup, first tile; the forward's at a grid of two key tiles a
# block), read back by probe_read. Are the backward's
# recomputed sims the forward's, bit for bit?
_TS_STORE = """
        for (int jj = 0; jj < NCOL / 8; ++jj)
          for (int e = 0; e < 4; ++e)
            g_probe[BASE + (pr + 8 * (e >> 1)) * 64 + 8 * jj + pc + (e & 1)] = sv[4 * jj + e];
      }
"""
TS_EDITS = (
    ("    after(f, n);\n    wgmma_wait<0>();\n    fence_regs(sb);\n",
     "    after(f, n);\n"
     "    if (n == 1 && blockIdx.x == 0 && blockIdx.y == 0 && wg == 0) {\n"
     "        const int pr = warp * 16 + (lane >> 2), pc = col;\n"
     + _TS_STORE.replace("NCOL", "64").replace("BASE", "0").replace("sv", "sa")
     + "    wgmma_wait<0>();\n    fence_regs(sb);\n"),
    ("      tile_sims<SPLIT, NC>(sv, s, tile);\n",
     "      tile_sims<SPLIT, NC>(sv, s, tile);\n"
     "      if (blockIdx.x == 0 && blockIdx.y == 0 && wg == 0 && tt == 0) {\n"
     "        const int pr = (t >> 5) * 16 + ((t & 31) >> 2), pc = 2 * (t & 3);\n"
     + _TS_STORE.replace("NCOL", "L::KT").replace("BASE", "(DQ ? 4096 : 8192)")),
)
TS_DEFINES = ("__device__ float g_probe[3 * 4096];\n"
              "extern \"C\" int probe_read(void* dst) {\n"
              "  return (int)cudaMemcpyFromSymbol(dst, g_probe, sizeof(g_probe));\n}\n")


def _ts_check():
    """The edited copy's tile of sims from the forward, the dQ and the dK
    kernel on real features, (4 x 499) x (4 x 256), D 512, as bf16 and as
    split fp32 features: bit-equal?"""
    import numpy as np

    from triad_tpu_torch import kernels
    from triad_tpu_torch.ops import maxmean as MM

    rng = np.random.default_rng(96)
    q, k = (torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)), dim=-1).to("cuda")
        for shape in ((4, 499, 512), (4, 256, 512)))
    cases = [("(4 x 499) x (4 x 256) real features", (
        q, k, torch.tensor(10.0, device="cuda"), MM.coefficients(4, 499, None, "cuda"), -60.0))]

    fns = _edited_libs("maxmean.cu", "triad_maxmean_fwd", kernels._SIGNATURES[
        "triad_maxmean_fwd"], [("sims", TS_EDITS, TS_DEFINES)])
    lib = ctypes.CDLL(str(_edited_lib("maxmean.cu", "sims")))
    lib.probe_read.argtypes = [ctypes.c_void_p]
    bwd = {}
    for entry in ("triad_maxmean_dq", "triad_maxmean_dk"):
        bwd[entry] = getattr(lib, entry)
        bwd[entry].argtypes = kernels._SIGNATURES[entry]
        bwd[entry].restype = ctypes.c_int
    for label, args in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k = args[0].to(dtype), args[1].to(dtype)
            rest = args[2:]
            amax = _maxmean_fwd_runner(fns["sims"], q, k, *rest)()[1]
            bargs = (q, k, *rest, amax, cs.randn((4, 4), 93, 1.0 / 4, torch.float32),
                     torch.tensor(0.01, device="cuda"))
            _maxmean_runner(bwd["triad_maxmean_dq"], bargs, True)()
            _maxmean_runner(bwd["triad_maxmean_dk"], bargs, False)()
            buf = torch.zeros(3 * 4096, dtype=torch.float32)
            torch.cuda.synchronize()
            lib.probe_read(buf.data_ptr())
            fwd, dq, dk = buf.view(3, 64, 64)
            kt = MM.stream_rows(dtype == torch.float32)
            print(f"TS {label} {dtype}: forward == dQ's recomputed sims (64 x {kt}): "
                  f"{torch.equal(fwd[:, :kt], dq[:, :kt])}; == dK's (transposed, {kt} x 64): "
                  f"{torch.equal(fwd[:kt].T, dk[:, :kt])}; largest difference "
                  f"{float((fwd[:, :kt] - dq[:, :kt]).abs().max()):.3g} / "
                  f"{float((fwd[:kt].T - dk[:, :kt]).abs().max()):.3g}", flush=True)


def maxmean_fwd_probe():
    from triad_tpu_torch import kernels
    from triad_tpu_torch.ops import maxmean as MM

    cases = _maxmean_fwd_cases()
    for label, args in cases:
        q, k = args[0], args[1]
        ops = 2 * q.shape[0] * k.shape[0] * q.shape[1] * k.shape[1] * q.shape[2]
        ms = cs.device_ms(lambda: MM.maxmean_fwd(*args))
        print(f"MAXMEAN_FWD {label}: {ms:.4f} device ms, {ops / ms / 1e9:.1f} TFLOP/s "
              f"({100 * ops / cs.PEAK_BF16 * 1e3 / ms:.1f}% of its "
              f"{ops / cs.PEAK_BF16 * 1e3:.4f} ms at the bf16 peak)", flush=True)
        print(f"SPLIT {label}, ms per call: {_split(lambda: MM.maxmean_fwd(*args))}", flush=True)
    fns = _edited_libs("maxmean.cu", "triad_maxmean_fwd", kernels._SIGNATURES[
        "triad_maxmean_fwd"], [(name, pairs, "") for name, pairs in MAXMEAN_FWD_VARIANTS])
    for label, args in cases:
        want = MM.maxmean_fwd(*args)
        kernel_ms = cs.device_ms(lambda: MM.maxmean_fwd(*args))
        for name, _ in MAXMEAN_FWD_VARIANTS:
            run = _maxmean_fwd_runner(fns[name], *args)
            clip, amax, _ = (t.clone() for t in run())
            print(f"VARIANT {label} {name}: {cs.device_ms(run):.4f} device ms (kernel "
                  f"{kernel_ms:.4f}); clip and amax bit-equal to the kernel's: "
                  f"{torch.equal(clip, want[0]) and torch.equal(amax, want[3])}", flush=True)
    args = cases[0][1]
    print(f"LOAD AV: clocks.sm, power.draw: {_under_load(lambda: MM.maxmean_fwd(*args))}",
          flush=True)
    _ts_check()


# Variants of the positional conv's forward built from csrc/posconv.cu by
# replacing text: (name, replacements). As built, design (a): output
# rows as wgmma's M, m64n48k16 per 64-row tile. "(b) outputs as M" runs
# out^T = W^T . X^T, the 48 outputs padded to 64 as M and 256 rows as N
# (m64n256k16: a quarter of its products wasted, a third of (a)'s
# shared-memory reads per operation): _PC_B, put before (a)'s main loop,
# which it leaves unreached. "no epilogue" stores nothing (the
# bias, activation, staging and stores left out: the products alone);
# "stages drained" waits for each stage's products before the next stage
# (none in flight across a stage wait); "8 taps a stage" and "4 stages"
# other rings; "2 tiles a warpgroup" 256-row pieces (twice the blocks,
# each streaming the group's weights). The rings' outputs are bit-equal to
# the kernel's. The repo's mma.sync design of the same products, posconv
# dW, is timed beside them in the POSCONV lines.
_PC_STAGES = "constexpr int PC_STAGES = 6;"
_PC_A = "  // Per stage: wait for it; per tap and 16 input channels, one product a\n"
# Design (b): A the tap's block (64 output rows, of which 48 are real: rows
# 48-63 read the next bytes and are dropped), B the consumer's 256 window
# rows from row0 + tap, 128 sums a thread; the tile transposed through
# shared memory in the epilogue.
_PC_B = """  {
    static_assert(PC_TILES == 4, "(b) takes a consumer's 256 rows as one N");
    float acc[128];
#pragma unroll
    for (int e = 0; e < 128; ++e) acc[e] = 0.0f;
    int stage = 0, phase = 0, prev = 0;
    hp::mbar_wait(win_full, 0);
    for (int s = 0; s < nst; ++s) {
      hp::mbar_wait(&full[stage], phase);
      hp::fence_regs(acc);
      hp::wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < PC_TAPS; ++tap)
#pragma unroll
        for (int kk = 0; kk < NB; ++kk)
          hp::wgmma_m64n256k16(acc, taps(stage, tap, kk), window(row0 + s * PC_TAPS + tap, kk), 1);
      hp::wgmma_commit();
      if (s > 0) {
        hp::wgmma_wait<1>();
        if (t == 0) hp::mbar_arrive(&empty[prev]);
      }
      prev = stage;
      pc_advance(stage, phase);
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    float bv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      bv[h] = bias != nullptr && r + 8 * h < CPG ? bias[g * CPG + r + 8 * h] : 0.0f;
#pragma unroll
    for (int tt = 0; tt < PC_TILES; ++tt) {
#pragma unroll
      for (int jj = 8 * tt; jj < 8 * tt + 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = r + 8 * (e >> 1);
          if (o < CPG)
            so[(8 * (jj - 8 * tt) + col + (e & 1)) * CPG + o] =
                __float2bfloat16_rn(activate(acc[4 * jj + e] + bv[e >> 1]));
        }
      store(tt);
    }
    return;
  }
"""
POSCONV_FWD_VARIANTS = (
    ("as built", ()),
    ("(b) outputs as M", ((_PC_A, _PC_B + _PC_A),)),
    ("no epilogue", (("      if (tr + row < nout)", "      if (tr + row < 0)"),)),
    ("stages drained", (("      hp::wgmma_wait<1>();", "      hp::wgmma_wait<0>();"),)),
    ("8 taps a stage", (("constexpr int PC_TAPS = 4;", "constexpr int PC_TAPS = 8;"),
                        (_PC_STAGES, "constexpr int PC_STAGES = 3;"))),
    ("4 stages", ((_PC_STAGES, "constexpr int PC_STAGES = 4;"),)),
    ("2 tiles a warpgroup", (("constexpr int PC_ROWS = 512;", "constexpr int PC_ROWS = 256;"),)),
)


def _posconv_runner(fn, x, wk, bias, left, act):
    """A call of an edited copy's entry point as ops/posconv.py:_launch
    makes it."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.ops import posconv as P

    b, n, c = x.shape
    wk = P._kernel_weight(wk)
    out = torch.empty_like(x)

    def run():
        err = fn(x.data_ptr(), wk.data_ptr(), None if bias is None else bias.data_ptr(),
                 out.data_ptr(), b, n, n, c, wk.shape[1], left, act, kernels.stream_ptr(out))
        if err:
            raise RuntimeError(f"edited posconv: cudaError_t {err}")
        return out
    return run


def posconv_fwd_probe():
    import torch.nn.functional as F

    from triad_tpu_torch import kernels
    from triad_tpu_torch.ops import posconv as P

    w = cs.randn((768, 48, 128), 41, (48 * 128) ** -0.5)
    bias = cs.randn((768,), 42, 0.1, torch.float32)
    for b, n in ((8, 499), (64, 499), (8, 1000)):
        x = cs.randn((b, n, 768), 43)
        xt = x.transpose(1, 2).contiguous()
        flops = 2 * b * n * 768 * 128 * 48
        bound = flops / cs.PEAK_BF16 * 1e3
        fwd, dx, dw, lib = (cs.device_ms(fn) for fn in (
            lambda: P.pos_conv(x, w, bias, 16, "erf"), lambda: P.pos_conv_dx(x, w, 16),
            lambda: P.pos_conv_dw(x, x, 16, 128),
            lambda: F.conv1d(xt, w, bias.to(torch.bfloat16), padding=64, groups=16)))
        print(f"POSCONV ({b}, {n}, 768) K 128: forward {fwd:.4f}, dX {dx:.4f} device ms "
              f"({flops / fwd / 1e9:.1f} / {flops / dx / 1e9:.1f} TFLOP/s, {100 * bound / fwd:.1f}"
              f"% / {100 * bound / dx:.1f}% of the bound {bound:.4f}); blocks "
              f"{-(-n // 512) * 16 * b}; the mma.sync dW of the same products {dw:.4f}; "
              f"cuDNN grouped conv1d {lib:.4f}", flush=True)
    x = cs.randn((64, 499, 768), 43)
    print(f"SPLIT forward (64, 499, 768), ms per call: "
          f"{_split(lambda: P.pos_conv(x, w, bias, 16, 'erf'))}", flush=True)
    fns = _edited_libs("posconv.cu", "triad_posconv", kernels._SIGNATURES["triad_posconv"],
                       [(name, pairs, "") for name, pairs in POSCONV_FWD_VARIANTS])
    want = P.pos_conv(x, w, bias, 16, "erf")
    kernel_ms = cs.device_ms(lambda: P.pos_conv(x, w, bias, 16, "erf"))
    for name, _ in POSCONV_FWD_VARIANTS:
        run = _posconv_runner(fns[name], x, P._conv_weight(w, 16), bias, P._left(128, False), 1)
        same = torch.equal(run().clone(), want)
        print(f"VARIANT (64, 499, 768) {name}: {cs.device_ms(run):.4f} device ms (kernel "
              f"{kernel_ms:.4f}); bit-equal to the kernel: {same}", flush=True)
    print(f"LOAD (64, 499, 768): clocks.sm, power.draw: "
          f"{_under_load(lambda: P.pos_conv(x, w, bias, 16, 'erf'))}", flush=True)


# Variants of conv_0 built from csrc/frontend.cu by replacing a line:
# (name, replacements). The tile, block and "per-element GELU" variants
# write the kernel's bits; "no stores" and "no GELU" do not (the first
# writes nothing, the second bf16(y * scale + bias)).
_C0_STORE = "        if (s + r < nt)\n"
_C0_NO_STORES = (_C0_STORE, "        if (s + r < nt && m0 < 0)\n")
_C0_NT = "constexpr int C0_NT = 8;  "
_C0_ROWG = "constexpr int C0_ROWG = 2;"
_C0_TMAX = "constexpr int C0_TMAX = 512;"
_C0_LOOKUP = "  return uint32_t(lut[z & 0xffffu]) | uint32_t(lut[z >> 16]) << 16;"
_C0_NO_GELU = (_C0_LOOKUP, "  return z;")
CONV0_VARIANTS = (
    ("as built", ()),
    ("no stores", (_C0_NO_STORES,)),
    ("no GELU", (_C0_NO_GELU,)),
    ("no GELU, no stores", (_C0_NO_GELU, _C0_NO_STORES)),
    # triad::gelu per element, the table left unread
    ("per-element GELU", ((_C0_LOOKUP, "  return gelu_bits<true>(z & 0xffffu) | "
                                       "gelu_bits<true>(z >> 16) << 16;"),)),
    # timing only (other outputs): each lane's lookups in its own bank
    ("lookups without bank conflicts", ((_C0_LOOKUP, "  return uint32_t(lut[(z & 1) | lane_bank()]) "
                                         "| uint32_t(lut[(z >> 16 & 1) | lane_bank()]) << 16;"),)),
    ("8 warps (one a channel slab)", ((_C0_ROWG, "constexpr int C0_ROWG = 1;"),)),
    ("32 warps of 32 channels", ((_C0_NT, "constexpr int C0_NT = 4;  "),)),
    ("32 warps (four a slab)", ((_C0_ROWG, "constexpr int C0_ROWG = 4;"),)),
    ("tiles of 256 steps at most", ((_C0_TMAX, "constexpr int C0_TMAX = 256;"),)),
    ("tiles of 1024 steps at most", ((_C0_TMAX, "constexpr int C0_TMAX = 1024;"),)),
)
# Variants of the Gram pass: other steps or threads a block (the sums in
# another fp64 order).
STATS_VARIANTS = (
    ("as built", ()),
    ("1024 steps a block", (("constexpr int ST_T = 2048;", "constexpr int ST_T = 1024;"),)),
    ("256 threads", (("constexpr int ST_THREADS = 128;", "constexpr int ST_THREADS = 256;"),)),
)


def frontend_probe():
    from triad_tpu_torch import kernels
    from triad_tpu_torch.ops import frontend as FE

    import numpy as np

    rng = np.random.default_rng(11)
    w0 = torch.from_numpy((rng.standard_normal((512, 1, 10)) * 0.45).astype(np.float32)).cuda()
    gs = cs.randn((512,), 16, 0.2, torch.float32) + 1.0
    gb = cs.randn((512,), 17, 0.1, torch.float32)
    t = cs.AUDIO
    m0 = (t - 10) // 5 + 1
    cases = {}
    for b in (1, 8, 64):
        wave = cs.randn((b, t), 12, dtype=torch.float32)
        mean, var = FE.conv0_stats_plain(wave, w0)
        scale = torch.rsqrt(var + FE.GN_EPS) * gs
        bias = gb - mean * scale
        cases[b] = (wave, scale, bias)
        st = cs.device_ms(lambda: FE.conv0_stats(wave, w0))
        st_comp = cs.device_ms(cs.stats_composition(wave, w0))
        c0 = cs.device_ms(lambda: FE.conv0_norm_gelu(wave, w0, scale, bias, "tanh"))
        c0_erf = cs.device_ms(lambda: FE.conv0_norm_gelu(wave, w0, scale, bias, "erf"))
        c0_comp = cs.device_ms(cs.conv0_composition(wave, w0, scale, bias, "tanh"))
        st_bound = cs.stats_cost(b, t)[0]
        c0_bound = cs.cost(2 * b * m0 * 512 * 10, b * t * 4 + 512 * 10 * 4 + b * m0 * 512 * 2)[0]
        print(f"FRONTEND ({b}, {t}): stats {st:.4f} device ms ({100 * st_bound / st:.1f}% of the "
              f"bound {st_bound:.4f}; composition {st_comp:.4f}); conv_0 tanh {c0:.4f}, erf "
              f"{c0_erf:.4f} ({100 * c0_bound / c0:.1f}% of the bound {c0_bound:.4f}; "
              f"composition {c0_comp:.4f}; {b * m0 * 512 * 2 / c0 / 1e6:.0f} GB/s written)",
              flush=True)
    for b in (8, 64):
        wave, scale, bias = cases[b]
        print(f"SPLIT ({b}, {t}) stats, ms per call: {_split(lambda: FE.conv0_stats(wave, w0))}; "
              f"conv_0: {_split(lambda: FE.conv0_norm_gelu(wave, w0, scale, bias, 'tanh'))}",
              flush=True)
    # one build of every copy (conv_0's and the stats' variants at once);
    # the stats' entry point taken from the same libraries
    lane_bank = ("__device__ __forceinline__ unsigned lane_bank() { return (threadIdx.x & 31) << 1; "
                 "}\n")
    c0_fns = _edited_libs("frontend.cu", "triad_frontend_conv0",
                          kernels._SIGNATURES["triad_frontend_conv0"],
                          [(name, pairs, lane_bank) for name, pairs in CONV0_VARIANTS]
                          + [("stats " + name, pairs, "") for name, pairs in STATS_VARIANTS],
                          report="conv0")
    st_fns = {}
    for name, _ in STATS_VARIANTS:
        fn = ctypes.CDLL(str(_edited_lib("frontend.cu", "stats " + name))).triad_frontend_stats
        fn.argtypes, fn.restype = kernels._SIGNATURES["triad_frontend_stats"], ctypes.c_int
        st_fns["stats " + name] = fn
    w0k = FE._taps(w0)
    for b in (8, 64):
        wave, scale, bias = cases[b]
        want = FE.conv0_norm_gelu(wave, w0, scale, bias, "tanh")
        kernel_ms = cs.device_ms(lambda: FE.conv0_norm_gelu(wave, w0, scale, bias, "tanh"))
        y = torch.empty_like(want)
        table = torch.empty(FE.GELU_TABLE, dtype=torch.int16, device="cuda")
        for name, _ in CONV0_VARIANTS:
            def launch(fn=c0_fns[name]):
                err = fn(wave.data_ptr(), wave.stride(0), w0k.data_ptr(), scale.data_ptr(),
                         bias.data_ptr(), table.data_ptr(), y.data_ptr(), b, m0, 1,
                         kernels.stream_ptr(y))
                if err:
                    raise RuntimeError(f"edited conv_0: cudaError_t {err}")

            def run():
                y.zero_()
                launch()
            run()
            same = torch.equal(y, want)
            print(f"CONV0 VARIANT ({b}, {t}) {name}: {cs.device_ms(launch):.4f} device ms (kernel "
                  f"{kernel_ms:.4f}); bit-equal to the kernel: {same}", flush=True)
        mean, var = FE.conv0_stats(wave, w0)
        kernel_ms = cs.device_ms(lambda: FE.conv0_stats(wave, w0))
        nb = -(-m0 // 1024)  # the most blocks a variant has
        part = torch.empty((b, nb, FE.GRAM_PARTS), dtype=torch.float64, device="cuda")
        vm, vv = torch.empty_like(mean), torch.empty_like(var)
        for name, _ in STATS_VARIANTS:
            def launch(fn=st_fns["stats " + name]):
                err = fn(wave.data_ptr(), wave.stride(0), w0k.data_ptr(), part.data_ptr(),
                         vm.data_ptr(), vv.data_ptr(), b, m0, kernels.stream_ptr(vm))
                if err:
                    raise RuntimeError(f"edited stats: cudaError_t {err}")
            launch()
            gap = float((vv - var).abs().max()) / float(var.max())
            print(f"STATS VARIANT ({b}, {t}) {name}: {cs.device_ms(launch):.4f} device ms (kernel "
                  f"{kernel_ms:.4f}); var differs from the kernel's by {gap:.3g} of the largest",
                  flush=True)
    wave, scale, bias = cases[64]
    print(f"LOAD (64, {t}): clocks.sm, power.draw: conv_0 "
          f"{_under_load(lambda: FE.conv0_norm_gelu(wave, w0, scale, bias, 'tanh'))}; stats "
          f"{_under_load(lambda: FE.conv0_stats(wave, w0))}", flush=True)


def main(argv):
    if argv not in (["eval"], ["di"], ["flash"], ["posconv_dw"], ["activation"],
                    ["fused_mlp"], ["maxmean"], ["maxmean_fwd"], ["posconv_fwd"],
                    ["frontend"]):
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    from triad_tpu_torch import kernels

    kernels.build()
    kernels.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    {"eval": eval_probe, "di": di_probe, "flash": flash_probe, "posconv_dw": posconv_dw_probe,
     "activation": activation_probe, "fused_mlp": fused_mlp_probe,
     "maxmean": maxmean_probe, "maxmean_fwd": maxmean_fwd_probe,
     "posconv_fwd": posconv_fwd_probe, "frontend": frontend_probe}[argv[0]]()


if __name__ == "__main__":
    main(sys.argv[1:])
