"""Run-to-run reproducibility of the train steps, and chip_smoke.py's
B = 4 reference checks on the weights the steps train, for one or more
checkouts of this repo, on one CUDA card.

    python3 triad_tpu_torch/tools/reference_ab.py TREE:MODE [TREE:MODE ...]

Each TREE:MODE runs in a fresh process that builds TREE's kernels and
imports TREE/chip_smoke.py (so an older checkout, unpacked with
``git archive``, runs its own code); a failed check prints "WOULD FAIL"
and the run goes on. Modes:

  probe    one audio-visual forward + backward of the joint path's model
           (perf_train_model_config(), seed 1, B = 64, dropouts live) twice
           on the same weights and batch, with cudnn.deterministic off and
           on: are the loss and every gradient bit-equal? (and, where the
           tree has them, the max-mean kernels on real features and the
           frontend stats twice);
  joint    phase 8 (the joint steps) then phase 9 (the B = 4 reference on
           the trained weights), with a digest of the trained weights;
           joint@SEED starts phase 8 from init seed SEED instead of 1;
  knobs    phase 11 then the B = 4 reference on the trained weights and on
           the seeded weights of seeds 1, 2 and 3;
  default  phase 10 then its B = 4 reference on the trained weights;
  attention  phase 3's training-attention cases (packed at B = 8 and 64,
           N = 261 at p = 0 and 499 at p = 0.1; strided and merged at the
           shapes of phases 10 and 11; and (8, 1000) p = 0.1, which a tree
           with a key cap refuses): each against its twin, with kernel,
           twin, SDPA and bound times, as chip_smoke.py prints them;
  kernels  phase 3 of this tree's chip_smoke.py on the checkout's
           kernels, only the cases of the eval attention (its four modes,
           (8, 999) and (8, 1000) included, which a tree with a key cap
           refuses), the fused MLP forward and backward (every case,
           the cuBLAS composition beside them), the stride-2 conv GEMM's
           two callers, the training
           attention, the flash forward and backward (the fused-qkv
           case included), the positional conv (forward, dX, dW), the
           frontend activation, the max-mean forward, dQ and dK (the
           backward's composition beside them) and conv_0 and its
           GroupNorm stats (their compositions beside them): synchronised
           and device ms as phase 3 prints them, and a digest of each
           output; conv_0's output at (8, 160000) is also held against
           the first tree's of the call (the share of elements whose bits
           differ); run it on two trees in turns (parent, change, change,
           parent) to compare them in one call; kernels@NAME+NAME... only
           the cases of those names (e.g. kernels@maxmean+posconv+posconv_dx,
           kernels@frontend_stats+frontend_conv0);
  flash    the flash forward and backward cases of ``kernels`` alone,
           after the flash kernels' ptxas registers and spills and their
           SASS counts (HGMMA, UTMALDG, highest register) in the
           checkout's build: for trees that differ in the flash kernels;
  tv_flash phase 14 of the checkout's chip_smoke.py (the text-visual step
           with the ViT on "flash", B = 64): ms per step and the
           torch.profiler split of one more step (its top rows);
  tv       phase 6 of the checkout's chip_smoke.py (the text-visual step,
           B = 64): ms per step and its profiler split (the top rows);
  mm_shapes  which products launch the joint step's GEMM kernels: one
           joint step of phase 8 under torch.profiler with record_shapes,
           each kernel that a matrix-product op launched summed by (op,
           input shapes, kernel name), beside the step's largest kernels.
"""

import hashlib
import importlib.util
import os
import re
import subprocess
import sys
import time

GROUPS = ("others", "audio", "text", "vit_lora")


def digest(model):
    h = hashlib.sha256()
    for _, p in model.named_parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def probe(cs, torch):
    from triad_tpu_torch.config import OptimConfig, perf_train_loss_config
    from triad_tpu_torch.ops.dropout import HostSeeds
    from triad_tpu_torch.train.step import StepFactory

    ocfg = OptimConfig(gradient_accumulation_steps=1, unfreeze_audio_step=0,
                       unfreeze_text_step=0, unfreeze_vit_step=0)
    state = cs._new_state(ocfg, 1)
    model = state.model
    state.bank.set_trainable(0)
    factory = StepFactory(perf_train_loss_config(), ocfg)
    av = {k: v.cuda() for k, v in cs._av_batch(cs.TRAIN_B, 5).items()}

    def once():
        for p in model.parameters():
            p.grad = None
        gen = torch.Generator(device="cuda").manual_seed(123)
        total, _ = factory.compute_losses(model, av, None, gen, seeds=HostSeeds(1, 0))
        total.backward()
        return total.detach().clone(), {n: p.grad.clone() for n, p in model.named_parameters()
                                        if p.grad is not None}

    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        l1, g1 = once()
        l2, g2 = once()
        diff = [n for n in g1 if not torch.equal(g1[n], g2[n])]
        print(f"PROBE cudnn.deterministic={det}: AV loss {float(l1):.9f} / {float(l2):.9f} equal "
              f"{torch.equal(l1, l2)}; {len(diff)} of {len(g1)} gradients differ: {diff[:6]}",
              flush=True)
    torch.backends.cudnn.deterministic = False
    if hasattr(cs, "maxmean_real_case"):
        import numpy as np

        from triad_tpu_torch.ops import frontend as FE
        from triad_tpu_torch.ops import maxmean as MM

        cs.maxmean_real_case([], MM, 64, 64, 499, 256, 512, -60.0)
        rng = np.random.default_rng(11)
        w0 = torch.from_numpy((rng.standard_normal((512, 1, 10)) * 0.45).astype(np.float32))
        wave = cs.randn((8, cs.AUDIO), 12, dtype=torch.float32)
        a, b = FE.conv0_stats(wave, w0.cuda()), FE.conv0_stats(wave, w0.cuda())
        r = FE.conv0_stats_plain(wave, w0.cuda())
        print("STATS equal across calls", all(torch.equal(x, y) for x, y in zip(a, b)),
              "err vs plain", [cs.max_err(x, y) for x, y in zip(a, r)], flush=True)


def attention(cs):
    from triad_tpu_torch.ops import attention as A

    res = []
    for b in (cs.B, cs.TRAIN_B):
        cs.attention_cases(res, A, b, 261, 13, 0.0)
    for b in (cs.B, cs.TRAIN_B):
        cs.attention_cases(res, A, b, 499, 21, cs.P_DROP)
    cs.attention_layout_cases(res, A, cs.DEFAULT_B, 499, cs.P_DROP, 101, strided_main=True,
                              merged_main=None)
    cs.attention_layout_cases(res, A, cs.TRAIN_B, 499, cs.P_DROP, 103, merged_main=True)
    cs.attention_layout_cases(res, A, cs.TRAIN_B, 261, 0.0, 105, strided_main=None)
    try:
        cs.attention_cases(res, A, cs.B, 1000, 27, cs.P_DROP)
    except ValueError as e:
        print(f"  attention_train (8, 1000, 768, p={cs.P_DROP}) raises: {e}", flush=True)


# The redesigned kernels (eval attention, fused MLP, conv GEMM, flash,
# posconv forward, dX and dW, the frontend activation, the max-mean
# forward, dQ and dK, conv_0 and its stats) and the training attention,
# by the names chip_smoke.py's phase 3 gives their cases.
AB_KERNELS = ("attention_eval", "attention_eval_merged", "attention_eval_pair",
              "attention_eval_merged_pair", "fused_mlp", "fused_mlp_bwd", "frontend_conv",
              "fused_frontend_conv",
              "attention_train", "attention_train_bwd", "attention_train_strided",
              "attention_train_strided_bwd", "attention_train_merged",
              "attention_train_merged_bwd", "flash_attention", "flash_attention_bwd",
              "posconv", "posconv_dx", "posconv_dw", "frontend_activation", "maxmean",
              "maxmean_dq", "maxmean_dk", "frontend_stats", "frontend_conv0")
FLASH_KERNELS = ("flash_attention", "flash_attention_bwd")


def _here_chip_smoke():
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_chip_smoke_here", here)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.fail = lambda msg: print("WOULD FAIL: " + msg, flush=True)
    return cs


def flash_build(path):
    """The flash kernels' lines of the checkout's ptxas report and their
    SASS counts, as THIS tree's chip_smoke.py phase 2 prints them."""
    from triad_tpu_torch import kernels

    cs = _here_chip_smoke()
    kernel = ""
    for line in kernels.build_log.splitlines():
        named = re.search(r"function '([^']+)'", line)
        if "Compiling entry function" in line:
            kernel = cs._kernel_name(line.split("'")[1])
        elif named and "flash" in named.group(1):
            print(f"  {cs._kernel_name(named.group(1))}: {line.strip()}", flush=True)
        elif kernel.startswith("flash") and ("registers" in line or "spill" in line):
            print(f"  {kernel}: {line.strip()}", flush=True)
    cs.SASS_KERNELS = {k: v for k, v in cs.SASS_KERNELS.items() if k.startswith("flash")}
    cs.sass_check(path)


# conv_0's output of the call's first tree, for the later trees' runs.
FIRST_CONV0 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "_build",
                           "ab_first_conv0.pt")


def _against_first_tree(out):
    """The share of out's elements whose bits differ from the first tree's
    output of the same case in this call (saved by the first run)."""
    import torch

    if not os.path.exists(FIRST_CONV0):
        os.makedirs(os.path.dirname(FIRST_CONV0), exist_ok=True)
        torch.save(out.cpu(), FIRST_CONV0)
        return
    first = torch.load(FIRST_CONV0).to(out.device)
    diff = first.view(torch.int16) != out.view(torch.int16)
    print(f"CONV0 vs the first tree's output: {int(diff.sum())} of {diff.numel()} elements "
          f"differ ({100 * float(diff.float().mean()):.4f}%)", flush=True)


def kernel_times(names=AB_KERNELS):
    """Phase 3 (kernel_phase) of THIS tree's chip_smoke.py, run on the
    checkout's kernels (its triad_tpu_torch is the one already imported),
    restricted to the cases of names: the same inputs, twins and
    tolerances for every checkout, one case table, and a digest of each
    case's kernel output (bit-equal outputs across trees read the same). A
    case whose kernel raises (a tree with a key cap) is printed as such."""
    import torch
    cs = _here_chip_smoke()
    compare = cs.compare

    def only(results, name, shape, *args, **kwargs):
        if name not in names:
            return
        try:
            compare(results, name, shape, *args, **kwargs)
        except ValueError as e:
            print(f"KERNEL {name:28s} {str(shape):34s} raises: {e}", flush=True)
            return
        r = results[-1]
        got = args[0]()
        h = hashlib.sha256()
        for t in [got] if isinstance(got, torch.Tensor) else got:
            h.update(t.detach().float().cpu().numpy().tobytes())
        print(f"KERNEL {name:28s} {str(shape):34s} sync {r['ms']:.4f} device "
              f"{r['device_ms']:.4f} ms digest {h.hexdigest()[:16]}", flush=True)
        if name == "frontend_conv0" and tuple(shape) == (cs.B, cs.AUDIO):
            _against_first_tree(got)

    cs.compare = only
    cs.kernel_phase()


# The ops that launch matrix-product kernels themselves (aten::matmul and
# aten::linear reach them through these).
MM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def mm_shapes(cs, torch):
    """Which products launch the joint step's GEMM kernels: one joint step
    (phase 8's state, batches and step, after one warm-up step) under
    torch.profiler with record_shapes; each kernel a matrix-product op
    launched, summed by (op, input shapes, kernel), the 20 largest by
    device time, and the step's 8 largest kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    from triad_tpu_torch.config import OptimConfig, perf_train_loss_config
    from triad_tpu_torch.train.step import StepFactory

    ocfg = OptimConfig(gradient_accumulation_steps=1, unfreeze_audio_step=0,
                       unfreeze_text_step=0, unfreeze_vit_step=0)
    state = cs._new_state(ocfg, 1)
    step = StepFactory(perf_train_loss_config(), ocfg).make_step("joint")
    av = {k: v.cuda() for k, v in cs._av_batch(cs.TRAIN_B, 5).items()}
    tv = {k: v.cuda() for k, v in cs._train_batch(cs.TRAIN_B, 6).items()}
    step(state, av, tv, 0.5, 0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(state, av, tv, 0.5, 0.5)
        torch.cuda.synchronize()
    by_op, by_kernel = {}, {}
    for e in prof.events():
        for k in e.kernels:
            by_kernel[k.name] = by_kernel.get(k.name, 0.0) + k.duration
            if e.name in MM_OPS:
                key = (e.name, str(e.input_shapes), k.name)
                ms, n = by_op.get(key, (0.0, 0))
                by_op[key] = (ms + k.duration, n + 1)
    for (op, shapes, kernel), (us, n) in sorted(by_op.items(), key=lambda r: -r[1][0])[:20]:
        print(f"MM {us / 1e3:9.4f} ms {n:4d}x {op} {shapes} -> {kernel[:90]}", flush=True)
    for kernel, us in sorted(by_kernel.items(), key=lambda r: -r[1])[:8]:
        print(f"KERNEL {us / 1e3:9.4f} ms {kernel[:110]}", flush=True)


def tv_flash(cs):
    """Phase 14 of the checkout's chip_smoke.py: the TV step with the ViT
    on "flash" at B = 64 (2 warm-up and 3 timed steps, then a profiled
    one, whose top kernel rows train_phase prints)."""
    import dataclasses

    from triad_tpu_torch.config import perf_train_model_config

    cfg = perf_train_model_config()
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, attention_impl="flash"))
    _, launches, ms = cs.train_phase(cfg, cs.FLASH_TV_KERNELS, "tv_flash_profile.txt")
    print(f"TV_FLASH step {ms:.3f} ms; flash launches {launches['flash_attention']} + "
          f"{launches['flash_attention_bwd']}", flush=True)


def one(root, mode):
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    cs.fail = lambda msg: print("WOULD FAIL: " + msg, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from triad_tpu_torch import kernels

    path = kernels.build()
    kernels.library()
    print(f"=== {mode} in {root}", flush=True)
    t0 = time.time()
    if mode == "probe":
        probe(cs, torch)
    elif mode == "attention":
        attention(cs)
    elif mode.partition("@")[0] == "kernels":
        names = mode.partition("@")[2]
        kernel_times(tuple(names.split("+")) if names else AB_KERNELS)
    elif mode == "flash":
        flash_build(path)
        kernel_times(FLASH_KERNELS)
    elif mode == "tv_flash":
        tv_flash(cs)
    elif mode == "mm_shapes":
        mm_shapes(cs, torch)
    elif mode == "tv":
        _, _, ms = cs.train_phase()
        print(f"TV step {ms:.3f} ms", flush=True)
    elif mode.partition("@")[0] == "joint":
        seed = int(mode.partition("@")[2] or 1)
        new_state = cs._new_state
        cs._new_state = lambda ocfg, _, model_cfg=None: new_state(ocfg, seed, model_cfg)
        model, *_ = cs.joint_phase()
        print("DIGEST joint", digest(model), flush=True)
        cs.train_reference_phase(model, GROUPS, cs._av_batch(4, 7), cs._train_batch(4, 8))
    elif mode == "knobs":
        from triad_tpu_torch.models.convert import init_triad_model

        model, loss_cfg, *_ = cs.knobs_phase()
        print("DIGEST knobs", digest(model), flush=True)
        print("REF trained", flush=True)
        cs.train_reference_phase(model, GROUPS, cs._av_batch(4, 15), cs._train_batch(4, 16),
                                 loss_cfg, {})
        del model
        for seed in (1, 2, 3):
            print(f"REF seed {seed}", flush=True)
            m = init_triad_model(cs.model_cfg_knobs(),
                                 torch.Generator(device="cuda").manual_seed(seed), device="cuda")
            cs.train_reference_phase(m, GROUPS, cs._av_batch(4, 15), cs._train_batch(4, 16),
                                     loss_cfg, {})
            del m
    elif mode == "default":
        model, loss_cfg, *_ = cs.default_phase()
        print("DIGEST default", digest(model), flush=True)
        cs.train_reference_phase(model, GROUPS, cs._av_batch(4, 13),
                                 cs._train_batch(4, 14, 128), loss_cfg, {"attention_impl": "fused"})
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    print(f"ELAPSED {mode} {time.time() - t0:.1f} s", flush=True)


def main(argv):
    if len(argv) == 3 and argv[0] == "--one":
        return one(os.path.abspath(argv[1]), argv[2])
    if not argv:
        raise SystemExit(__doc__)
    if os.path.exists(FIRST_CONV0):
        os.remove(FIRST_CONV0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for spec in argv:
        tree, mode = spec.rsplit(":", 1)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree, mode])


if __name__ == "__main__":
    main(sys.argv[1:])
