"""Three measurements behind PERF.md's notes on the eval attention, the
training attention's di and the flash kernels, on one CUDA card, from the
repo root:

    python3 triad_tpu_torch/tools/kernel_probe.py eval
    python3 triad_tpu_torch/tools/kernel_probe.py di
    python3 triad_tpu_torch/tools/kernel_probe.py flash

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
"""

import os
import re
import statistics
import subprocess
import sys

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


def main(argv):
    if argv not in (["eval"], ["di"], ["flash"]):
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    from triad_tpu_torch import kernels

    kernels.build()
    kernels.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    {"eval": eval_probe, "di": di_probe, "flash": flash_probe}[argv[0]]()


if __name__ == "__main__":
    main(sys.argv[1:])
