"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA
kernels from triad_tpu_torch/csrc, checks each against its plain PyTorch
twin at the shapes of the serving and training paths, serves the
full-width perf_eval_model_config() TriadModel (random weights from a
seed) over HTTP and checks the answers, then trains the full-width
text-visual, joint and audio-visual steps of perf_train_model_config(),
the joint step of configs/default.yaml and the joint step of the
mqkv + vitmq + loss=pallas set for a few steps each, runs the
1000-way retrieval eval on the head-pair attention and the fused frontend,
feeds the joint step from files on disk through the port's data layer,
trains the whole curriculum through the Trainer's train / eval commands,
killed mid-epoch and resumed bit for bit, exports the serving bundle
and serves it, trains data-parallel (NCCL at world size 1, two gloo
ranks of cli.train against one process), tensor-parallel and FSDP, and
runs HuBERT's remat policies, bf16 Adam moments and the Trainer from an
MP4 folder.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the last line):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. nvcc build of the kernels (one nvcc per source, in parallel), each
     kernel's registers and spills, and the SASS of the stride-2 conv GEMM,
     of the fused MLP's GEMMs, of the flash forward, dK/dV and dQ kernels,
     of the max-mean forward, dQ and dK kernels and of the positional
     conv's forward holding wgmma (HGMMA) and TMA (UTMALDG) instructions;
  3. each kernel vs its plain twin on the card in bf16: max abs error
     against a stated bound, median time of the kernel, of the twin and
     of one PyTorch library call computing the same function where there
     is one (CUDA events, one call from an idle card, 20 turns; 5-19 for a
     call of 50 ms or more, a twin or library call; beside the fused
     MLP, which no one call computes, the cuBLAS composition at p = 0,
     printed as "composition"), the kernel's and
     the library call's device time per call (CUDA events around calls
     queued behind a sleep kernel, so the wrapper's host work is left out),
     the wrapper's host time per call (host clock
     from an idle card to the call's return), and the least time the card
     could take (the
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
     the CPU, the audio group included: on the weights phase 8 trained
     (the loss held, the group cosines printed) and, 9b, on the weights
     phase 8 started from (seed 1; every group held);
 10. configs/default.yaml's joint step (ModelConfig(): HuBERT's chunked
     frontend; the chunked loss at "highest", lr 1e-4, accumulation 4,
     every group unfrozen) at
     B = 22 clips of 10 s and 22 captions of 128 tokens with every
     dropout live: 2 warm-up and 4 timed micro steps (one accumulation
     boundary), every HuBERT parameter moved, HuBERT's strided attention
     and erf fused MLP launched and the packed attention not, the peak
     memory, a profiler split in default_profile.txt; then one B = 4
     step with every rate 0 and HuBERT's attention forced to "fused" on
     the weights phase 10 trained, against fp32 on the CPU;
 11. the mqkv + vitmq + loss=pallas joint step (merged-qkv attention in
     HuBERT and the ViT, the max-mean kernels in the AV and TV losses) at
     B = 64, as phase 8, with its split in knobs_profile.txt; then its
     B = 4 step at rates 0 in training mode against fp32 on the CPU: on
     the weights phase 11 trained (11b: the loss, and a witness that holds
     the max-mean kernels to their twins on the card's own features; the
     group cosines printed) and on those it started from (11c: every
     group held);
 12. the 1000-way retrieval eval (eval_1000_way_retrieval) of
     perf_eval_model_config() with the head-pair attention in all three
     encoders and HuBERT's "pallas" frontend, random weights from a seed:
     400 AV items (4-10 s clips padded to 10 s) and 400 TV items
     (captions up to 128 tokens) embedded at batch 8 and scored in four
     directions, every kernel of the path launched (counts zeroed just
     before it) and the single-head eval attention and the monolithic
     frontend not; the same eval leg by leg, timed, to the same recalls;
     the "conv_act" frontend on the same weights (its AV leg, the
     activation kernel launched) against the "pallas" one within 4 bf16
     ulps; 8 items against fp32 on the CPU (token cosine > 0.99); and
     score_matrix on the card against the CPU's (1e-4 of the scale).
 13. flash eval: perf_eval_model_config() with attention_impl "flash" in
     all three encoders, served over HTTP at B = 8 (10 s clips, 224^2
     images, 128-token captions): flash_attention launched once per layer
     of each encode call (12, 12 and 6) and the eval attention kernels
     not at all, the encode calls timed (in turns with the same weights on
     perf_eval_model_config()'s own impls), and the answers against fp32 on
     the CPU (token cosine > 0.99);
 14. the text-visual step of phase 6 with the ViT on "flash" at B = 64:
     2 warm-up and 3 timed steps, the flash forward and backward launched
     12 times each per step (counts zeroed just before the steps) and the
     training attention not at all, a profiler split in
     tv_flash_profile.txt; then its B = 4 step against fp32 on the CPU, as
     phase 7;
 15. 20 s clips (HuBERT at N = 999, past the eval kernel's old 512-key
     cap): a ServingModel of perf_eval_model_config() embeds 8 clips with
     HuBERT on its serving impl, on "packed_pair" and on "flash" (same
     weights, counts zeroed before each, the impl's kernel launched once
     per layer), the first two held against flash (token cosine > 0.999);
 16. the joint step of phase 8 fed from files on disk: two TriadPack
     shards of 96 clips (224^2, 10 s int16 audio) packed by the port from
     its seeded synthetic dataset and a folder of 192 JPEG captions, all
     written into a temporary directory and removed after; AVLoader and
     TVLoader (DataConfig's 4 thread workers, raw uint8 batches), cycling,
     two pinned-memory Prefetchers running device_ingest_av / _tv on a
     side stream: the native data library loaded (and a resample checked),
     each loader's host ms per batch (raw and host-augmented forms), the
     host-to-device ms of a batch from pinned and pageable memory, the
     device augmentation against the host path (apply_av_batch /
     apply_tv_image, same draws) within 1e-4 abs and its ms; 6 fed steps
     across the 3-batch epoch (every joint kernel launched, counts zeroed
     before them; every HuBERT parameter moved; the median fed step beside
     phase 8's; ms blocked in next()); the state copied after step 3 and
     continued by a second pair of loaders from cycling(1, 1): the next 2
     steps' losses and every parameter bit-equal to the uninterrupted
     run's; a profiler split of one more fed step (fed_profile.txt);
 17. the Trainer through its commands (triad_tpu_torch.cli.train and
     cli.eval): TriadPack shards and JPEG captions written from seeds (2
     x 96 clips and 192 captions to train on, 64 of each to validate on)
     and a JSON config (perf_train_model_config + perf_train_loss_config,
     B = 64, 10 s clips, 32 tokens, device augmentation, one epoch each of
     av_focus, tv_warmup, weighted_joint and full_joint at 3 steps,
     accumulation 3, async saves every 7 steps and at each epoch end, viz
     every 5). Run A, cli.train.main in this process (counts zeroed
     before it): every joint kernel launched, every logged loss finite,
     each epoch's phase and weights, every HuBERT parameter took a
     gradient and every DistilBERT one moved, the ViT base bit-unchanged,
     the viz PNGs (and the attention video's writer), checkpoints at 3,
     6, 8, 9 and 12 with best/; ms per step by phase (CUDA events), the
     hooks' seconds, the async saves' blocking and write seconds, a
     synchronous save, a restore, the peak memory. Run B, the same command
     in a subprocess, SIGKILLed once its mid-epoch, mid-accumulation
     step-8 checkpoint has committed; run C, the command again, resumes
     and ends with every tensor of its step-12 checkpoint, the progress
     and the losses after the resume bit-equal to run A's. cli.eval of run
     A (latest, and --best; beside runs B and C) prints run A's last
     retrieval metrics exactly;
     then the eval legs (validation, retrieval, viz) with counts zeroed:
     the forward kernels only. Run logs in chiprun_out/trainer_run_*.txt.
 18. pretrained weights (models/hf_import.py, reference_import.py), the
     infer and viz commands and the int8 serving mode, at full width, on
     phase 17's files on disk: tools/hf_layout.py writes HuBERT-base as a
     2-shard safetensors snapshot with weight_g / weight_v, DistilBERT as
     a DistilBertForMaskedLM pytorch_model.bin, DINOv2 ViT-B/14-reg as a
     torch.hub .pth under teacher / backbone. (257 positions) and a
     reference .pt; each is imported (bytes, host seconds), and imported
     tensors are held to recomputes from their seeds (a fused qkv, a conv
     kernel, the positional conv against float64 g v / |v|, the fresh LoRA
     factors against numpy's draws). cli.train from the three files (B =
     64, av_focus then full_joint, 2 steps each): the model before its
     first update bit-equal to the importer's state_dict, finite losses,
     every trainable group moved, the ViT base not; cli.train from the
     reference checkpoint (1 step): its start bit-equal to the importer's,
     its heads, temperature and LoRA factors the file's. cli.infer on the
     first run's directory (a JPEG, an mp4 written by cv2 and muxed with
     'sowt' PCM by data/mp4.py, a caption): every pairwise sim matrix,
     token cosine > 0.99 against the fp32 CPU forward of the same weights;
     cli.infer --random-init on perf_eval_model_config(), bf16 and --int8:
     one int8 product for each Dense / LoRALinear forward under --int8 and
     none in bf16, the int8 embeddings at cosine in (0.995, 1 - 1e-6) to
     the bf16 ones; _int_mm's
     int32 sums equal the plain product's (ragged rows), its time against
     the bf16 product; cli.viz --run-dir with --image / --text and
     --video: both PNGs, cv2 reads the attention mp4. Launch counts of
     each path (pretrained_trainer, reference_trainer, infer,
     infer_random, infer_int8, viz), each zeroed just before its run.
 19. the serving export (serve/export.py on torch.export) at full width,
     configs/default.yaml's model (ModelConfig(), random weights from seed
     0): cli.export --random-init for cpu and cuda (seconds by platform,
     the bundle's bytes); cli.serve --bundle in a new process whose import
     system refuses the port's models/ and kernels, ready seconds, /healthz,
     embed audio (10 s), image (224^2) and text (128 token ids) at B = 1, 3
     and 8 and /v1/score av and tv, held against the bundle's CPU programs
     (B = 1; fp32, least token cosine 0.999) and the live ServingModel of
     the same weights (every B; least token cosine 0.9995 audio, 0.99999
     visual and text; its fused MLP forward launched 12 times an
     encode_audio, nothing else), the scores against the live pair_scores;
     each cuda program's calls all aten operators (or the batch's size
     arithmetic) and the bundle's calls launching no kernel; ms per embed
     call at B = 8, bundle against live (CUDA events, device time, the
     profiler's kernel sum in chiprun_out/export_profile.txt); a 2-step
     cli.train run of configs/default.yaml (full_joint, B = 22) on phase 17's
     files exported with --run-dir, held to its restored model; cli.export
     --run-dir of phase 17's run (explicit kernel knobs) exits non-zero with
     resolve_xla_impls's message; cli.export --int8 --platforms cuda: one
     aten._int_mm per Dense / LoRALinear forward in each program, the
     embeddings at cosine in (0.995, 1 - 1e-6) to the bf16 bundle's. The
     int8 and refused exports and the server run in processes of their own
     beside the trained run's leg; the timings at B = 8 run alone.
 20. data parallelism (triad_tpu_torch/parallel/): 20d the three dropout
     kernels for the rows b0 = 32 .. 39 of a global batch, against their
     twins at b0 (2 bf16 ulps), the keep masks bit for bit, and the cost
     of a plain draw keyed on global rows; 20a initialize_from_env with
     NCCL at world size 1 in this process, phase 8's joint step through
     StepFactory(mesh=...) held to the one-process step (losses 1e-5
     relative, update cosine 0.9999, no parameter further than one Adam
     step of 2 lr + 1e-6), every joint kernel launched (counts zeroed
     before it);
     20b cli.train as two gloo ranks on the card (torchrun --standalone,
     TRIAD_DIST_BACKEND=gloo: NCCL refuses two ranks on one device),
     mesh.num_devices=2 with ZeRO-1, phase 17's files, full_joint, B = 64
     (32 a rank), accumulation 2, 2 epochs of 2 steps, against the same
     config in one process: per-step losses within 5e-3 relative and the
     final parameters' updates at cosine 0.99 (cuBLAS picks its algorithm
     by M: bf16 products of 32 and 64 rows round apart), each rank's AdamW
     moment bytes against the one process's (at most 0.6); the world-2
     step-2 checkpoint resumed in one process for steps 3-4, held to the
     world-2 run; 20c phase 8's joint step at B = 32 and world 2 (two gloo
     ranks of this script, --dp-ring-rank, under torchrun) from one start
     with the
     ring negatives and with the gathered ones (the losses equal within
     1e-6, the update at cosine 0.99: each ring step's bf16 feature
     cotangents are summed in bf16). The phase's seconds are printed.
 21. tensor parallelism and FSDP (parallel/tp.py, parallel/fsdp.py):
     phase 20's Trainer config at global B = 8 with every impl knob on
     the plain route, in one process, and again with its split layers
     rounding as tp = 2's shards do (_TpRounding); 21a mesh.tp = 2 and 21b
     mesh.fsdp as two gloo ranks each, 21c mesh.tp = 2 x num_slices 2 as
     four, all three side by side (ranks of this script, --train-rank,
     under torchrun), each held to the plain run per step (5e-3 relative) and
     in its final parameters (2 Adam steps of 2 lr), and in its final update
     (cosine 0.99): 21b to the plain run; 21a and 21c to the run at their
     rounding (on torch.mm alone), their cosine against the plain run
     printed (in bf16 the row sums' other rounding flips Adam's early
     sign-like steps: cosine 0.9668); each rank's parameter and moment
     bytes and peak; 21c's step-4 checkpoint holds whole tensors under
     one-process names and shapes, and its step-2 save resumes in one
     process (held to both one-process runs); 21d mesh.tp = 2 with an
     explicit kernel knob exits non-zero with resolve_xla_impls's message
     and writes no run directory; no kernel launches in any of it.
 22. HuBERT's remat policies and bf16 Adam moments: 22a phase 10's 6
     micro steps from the same start at remat "none" (the whole frontend):
     both medians and peaks, the losses on the start's weights within
     2e-3, the first update within one Adam step of 2 lr; 22b a B = 4
     joint step at full width on the chunked "conv_act" frontend against
     the chunked "conv" one (rates 0): frontend_activation launched once a
     pass a block, forward and recompute; the features and the loss within
     4 bf16 ulps, every group's and frontend tensor's gradient at cosine
     0.998; 22c a B = 4 joint step with every dropout live at remat
     "full" against "none": every gradient bit-equal, the HuBERT forward
     kernels launched again in the recompute; 22d phase 8's joint step at
     B = 16, 2 updates, with fp32 and with bf16 Adam moments: bytes (0.500),
     the update cosine by group, the largest parameter difference, and a
     CheckpointManager round trip keeping the bf16 moments bit-equal; 22e
     cli.train at full width on the reference's mp4 segment folders (cv2
     mp4v video muxed with 16 kHz 'sowt' PCM), B = 4, 3 steps: finite
     losses, every HuBERT tensor moved, the frames and tracks each decoder
     produced.
The port's kernels add in a fixed order (no atomics), so phase 8 trains
the same weights every run (PERF.md) and phase 9 reads the same each run.
Phase 3 also holds posconv dW at B = 96 and the activation at 768
channels, (2, 1000, 768).
Phase 3 also holds the strided (B, 12, N, 64) and merged (B, N, 2304)
training attention and the max-mean forward, dQ and dK kernels at the
shapes of phases 10 and 11 (on grid features with separated maxima, and at
the AV shape on real L2-normalised features), checks that the strided,
packed and merged kernels agree on the same inputs and seed, and holds the
head-pair eval attention, the fused frontend conv and the frontend
activation at the shapes of phase 12, the flash forward and backward at
the shapes of phases 13-14, at N = 1000 and on the strided views of a
fused (64, 261, 3, 12, 64) qkv tensor, the training attention at
(8, 1000, 768) with dropout live, the eval attention in its four modes at
(8, 999) and (8, 1000) (no kernel has a key cap), and the stride-2 conv
at conv_1's (64, 31999, 512), the train steps' batch.
The line before the last is one JSON object with one entry per kernel
(and the step times, phase 16's numbers under "data" and phase 17's under
"trainer", phase 18's under "pretrained", phase 19's under "export", phase
20's under "dp", phase 21's under "tp", phase 22's under "remat"): its
launches in the paths that run it (phases 4, 6, 8, 10, 11, 12, 13, 14, 15,
16, 17, 18, 19, 20, 21 and 22, each counted from zero), and its error, times and bound
at its main case of
phase 3 (the shape the train steps give it, else the first); every shape
of phase 3 goes to chiprun_out/kernel_cases.json. The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 8  # batch of the kernel comparisons
TXT = 24  # text tokens in the served request
TRAIN_B, TRAIN_TXT, REF_B = 64, 32, 4  # train batch, its text tokens, reference batch
DEFAULT_B = 22  # configs/default.yaml's batch_size_av and batch_size_tv
# The retrieval eval's subset: TrainConfig.retrieval_subset_size is 1000;
# cut to 400 for the script's time (PERF.md), which cuts the embedding
# 2.5x and the scoring 6x.
RETRIEVAL_N = 400
AUDIO = 160_000  # 10 s of 16 kHz audio
P_DROP = 0.1  # HuBERT's attention, activation and hidden dropout
BF16_ULP = 2.0 ** -7
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32
# outside them, HBM bandwidth; fp64 on the tensor cores (twice the fp64
# rate outside them).
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
PEAK_FP64 = 67e12


T0 = time.perf_counter()  # the script's start: each phase line gives its offset


def phase(msg):
    print(f"== {msg} [{time.perf_counter() - T0:.1f} s]", flush=True)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def randn(shape, seed, scale=1.0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


def time_fns(fns, reps=20, warmup=3, budget_ms=None):
    """Median ms of each function, timed in turns with CUDA events.
    ``budget_ms``: a function whose last warm-up call took longer than
    budget_ms / reps is timed in only the first max(5, budget_ms / its ms)
    turns (the plain twins and library calls of 50 ms and more)."""
    counts = [reps] * len(fns)
    for i in range(warmup):
        for j, fn in enumerate(fns):
            if budget_ms is None or i < warmup - 1:
                fn()
                continue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            counts[j] = max(5, min(reps, int(budget_ms / max(start.elapsed_time(end), 1e-3))))
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for i in range(reps):
        for t, fn, n in zip(times, fns, counts):
            if i >= n:
                continue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            t.append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def host_time(fn, reps=10):
    """Median host ms of one call from an idle card to its return: the
    wrapper's work up to the enqueued launch (the card runs on after)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(fn, sync_ms=None, host_ms=None):
    """Device ms per call: the card held by a sleep kernel while the host
    enqueues the calls (up to 20, about 100 ms of work), so they run back
    to back; CUDA events around them. Everything fn launches counts (its
    PyTorch ops too), its host work does not: the sleep lasts three times
    the host's enqueueing (host_ms per call, from host_time) and 1 ms
    more. sync_ms: one call from an idle card (time_fns)."""
    sync_ms = time_fns([fn], reps=3, warmup=1)[0] if sync_ms is None else sync_ms
    host_ms = host_time(fn, reps=3) if host_ms is None else host_ms
    reps = max(3, min(20, int(100 / max(sync_ms, 1e-3))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int((3 * reps * host_ms + 1) * 2e6))  # cycles at up to 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
            main=False, composition_fn=None):
    """Kernel vs plain twin: error against tol_rel of the largest output,
    times of kernel, twin and library call, and the bound (from cost).
    composition_fn, where no one call computes the function: a chain of
    library calls timed beside it as a yardstick, printed and kept apart
    from the library call."""
    got = kernel_fn()
    torch.cuda.synchronize()
    ref = plain_fn()
    err, mx = max_err(got, ref)
    tol = tol_rel * mx
    extra = [fn for fn in (library_fn, composition_fn) if fn is not None]
    ms, plain_ms, *others = time_fns([kernel_fn, plain_fn] + extra, budget_ms=1000.0)
    library_ms = others.pop(0) if library_fn is not None else None
    comp_ms = others.pop(0) if composition_fn is not None else None
    host_ms = host_time(kernel_fn)
    dev_ms = device_ms(kernel_fn, ms, host_ms)
    lib_dev_ms = None if library_fn is None else device_ms(library_fn, library_ms)
    comp_dev_ms = None if composition_fn is None else device_ms(composition_fn, comp_ms)
    bound_ms, bound_by = bound
    ok = err <= tol
    lib_txt = "-" if library_ms is None else f"{library_ms:.4f} (device {lib_dev_ms:.4f})"
    comp_txt = "" if comp_ms is None else f"composition {comp_ms:.4f} (device {comp_dev_ms:.4f}) "
    print(f"  {name:20s} {str(shape):32s} err {err:.4g} (tol {tol:.4g}) kernel {ms:.4f} "
          f"(device {dev_ms:.4f}, host {host_ms:.4f}) plain {plain_ms:.4f} library {lib_txt} "
          f"{comp_txt}bound {bound_ms:.4f} ({bound_by}) ms  {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} at {shape} disagrees with its plain version")
    results.append({"name": name, "shape": list(shape), "max_abs_err": err, "tol": tol,
                    "ms": ms, "device_ms": dev_ms, "host_ms": host_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "library_device_ms": lib_dev_ms,
                    "composition_ms": comp_ms, "composition_device_ms": comp_dev_ms,
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
    "attention_train_strided": ("triad_tpu_torch/csrc/attention_train.cu",
                                "triad_tpu/ops/pallas_attention.py:277"),
    "attention_train_strided_bwd": ("triad_tpu_torch/csrc/attention_train.cu",
                                    "triad_tpu/ops/pallas_attention.py:301"),
    "attention_train_merged": ("triad_tpu_torch/csrc/attention_train.cu",
                               "triad_tpu/ops/pallas_attention.py:774"),
    "attention_train_merged_bwd": ("triad_tpu_torch/csrc/attention_train.cu",
                                   "triad_tpu/ops/pallas_attention.py:784"),
    "maxmean": ("triad_tpu_torch/csrc/maxmean.cu", "triad_tpu/ops/pallas_maxmean.py:158"),
    "maxmean_dq": ("triad_tpu_torch/csrc/maxmean.cu", "triad_tpu/ops/pallas_maxmean.py:337"),
    "maxmean_dk": ("triad_tpu_torch/csrc/maxmean.cu", "triad_tpu/ops/pallas_maxmean.py:369"),
    "attention_eval_pair": ("triad_tpu_torch/csrc/attention_eval.cu",
                            "triad_tpu/ops/pallas_attention.py:428"),
    "attention_eval_merged_pair": ("triad_tpu_torch/csrc/attention_eval.cu",
                                   "triad_tpu/ops/pallas_attention.py:490"),
    "fused_frontend_conv": ("triad_tpu_torch/csrc/frontend_conv.cu",
                            "triad_tpu/ops/pallas_conv.py:177"),
    "frontend_activation": ("triad_tpu_torch/csrc/frontend_conv.cu",
                            "triad_tpu/ops/pallas_conv.py:228"),
    "flash_attention": ("triad_tpu_torch/csrc/attention_flash.cu",
                        "triad_tpu/models/layers.py:36"),
    "flash_attention_bwd": ("triad_tpu_torch/csrc/attention_flash.cu",
                            "triad_tpu/models/layers.py:36"),
}
SERVE_KERNELS = ("attention_eval", "attention_eval_merged", "fused_mlp", "frontend_stats",
                 "frontend_conv0", "frontend_conv")
TV_KERNELS = ("attention_train", "attention_train_bwd", "fused_mlp", "fused_mlp_bwd")
JOINT_KERNELS = TV_KERNELS + ("layernorm", "layernorm_bwd", "posconv", "posconv_dx",
                              "posconv_dw", "frontend_stats", "frontend_conv0", "frontend_conv")
# Path A, configs/default.yaml: HuBERT's strided attention, its erf fused
# MLP and the fused LayerNorm (the ViT and DistilBERT run plain ops).
DEFAULT_KERNELS = ("attention_train_strided", "attention_train_strided_bwd", "fused_mlp",
                   "fused_mlp_bwd", "layernorm", "layernorm_bwd")
# Path B, mqkv + vitmq + loss=pallas: merged attention in HuBERT and the
# ViT, the max-mean kernels in both losses, and perf_train's other kernels.
KNOBS_KERNELS = ("attention_train_merged", "attention_train_merged_bwd", "maxmean",
                 "maxmean_dq", "maxmean_dk") + JOINT_KERNELS[2:]
# The retrieval eval (phase 12): head-pair attention in all three encoders,
# HuBERT's "pallas" frontend, and its "conv_act" variant's activation pass.
RETRIEVAL_KERNELS = ("attention_eval_pair", "attention_eval_merged_pair", "fused_frontend_conv",
                     "fused_mlp")
CONV_ACT_KERNELS = ("frontend_activation", "attention_eval_pair")
# The flash route: its forward at eval (phase 13), forward and backward in
# the ViT of the text-visual step (phase 14).
EVAL_ATTENTION = ("attention_eval", "attention_eval_merged", "attention_eval_pair",
                  "attention_eval_merged_pair")
FLASH_TV_KERNELS = ("flash_attention", "flash_attention_bwd", "fused_mlp", "fused_mlp_bwd")


def _sdpa(q, k, v, mask=None):
    """F.scaled_dot_product_attention at p = 0 on the (B, H, N, 64) views
    of packed (B, N, H*64) tensors, with a (B, N) key mask if given: the
    library call beside attention."""
    import torch.nn.functional as F

    def heads(x):
        b, n, hd = x.shape
        return x.view(b, n, hd // 64, 64).transpose(1, 2)

    attn_mask = None if mask is None else mask.bool()[:, None, None, :]
    return F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=attn_mask)


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


def attention_costs(b, n, h=12):
    """(forward, backward) bounds of the training attention at (b, h, n,
    64): 2 and 5 products of N x N x 64 per head; bytes: q, k, v and the
    key mask in, out out forward; q, k, v, dout and the mask in, dq, dk,
    dv out backward. What the kernels save between the two (the row
    stats) is their design's traffic, not the function's, and stays out."""
    act = b * n * h * 64 * 2
    return (cost(4 * b * h * n * n * 64, 4 * act + b * n * 4),
            cost(10 * b * h * n * n * 64, 7 * act + b * n * 4))


def attention_cases(res, A, b, n, seed0, p, main=False):
    """Training attention forward and backward at (b, n, 768), dropout p;
    the backward from what the forward kernel saved."""
    q, k, v, do = (randn((b, n, 768), s) for s in range(seed0, seed0 + 4))
    keys = torch.ones((b, n), device="cuda")
    fwd, bwd = attention_costs(b, n)
    compare(res, "attention_train", (b, n, 768, f"p={p}"),
            lambda: A.attention_train_fwd(q, k, v, keys, 0.125, 1234, p)[0],
            lambda: A.attention_train_plain(q, k, v, keys, 0.125, 1234, p), 2 * BF16_ULP,
            fwd, lambda: _sdpa(q, k, v), main)
    _, st = A.attention_train_fwd(q, k, v, keys, 0.125, 1234, p)
    compare(res, "attention_train_bwd", (b, n, 768, f"p={p}"),
            lambda: A.attention_train_bwd(q, k, v, keys, do, 0.125, 1234, p, st),
            lambda: A.attention_train_bwd_plain(q, k, v, keys, do, 0.125, 1234, p),
            2 * BF16_ULP, bwd, _sdpa_bwd(q, k, v, do), main)


def attention_layout_cases(res, A, b, n, p, seed0, strided_main=False, merged_main=False):
    """The strided (B, H, N, 64) and merged (B, N, 3 * 768) layouts at
    (b, n), dropout p: forward and backward against their twins (2 bf16
    ulps), SDPA and its backward beside them. The strided operands are the
    permuted views of (B, N, 12, 64) projections that HuBERT passes."""
    qkv, do = randn((b, n, 2304), seed0), randn((b, n, 768), seed0 + 1)
    keys = torch.ones((b, n), device="cuda")
    h = 12
    fwd, bwd = attention_costs(b, n)
    _, st = A.attention_train_merged_fwd(qkv, keys, 0.125, 1234, p)
    if strided_main is not None:
        q, k, v = (t.contiguous().view(b, n, h, 64).transpose(1, 2) for t in qkv.chunk(3, -1))
        dos = do.view(b, n, h, 64).transpose(1, 2)
        compare(res, "attention_train_strided", (b, h, n, 64, f"p={p}"),
                lambda: A.attention_train_strided_fwd(q, k, v, keys, 0.125, 1234, p)[0],
                lambda: A.heads_train_plain(q, k, v, keys, 0.125, 1234, p).to(q.dtype),
                2 * BF16_ULP, fwd, lambda: _sdpa(*qkv.chunk(3, -1)), strided_main)
        compare(res, "attention_train_strided_bwd", (b, h, n, 64, f"p={p}"),
                lambda: A.attention_train_strided_bwd(q, k, v, keys, dos, 0.125, 1234, p,
                                                      saved=st),
                lambda: [g.to(q.dtype) for g in A.heads_train_bwd_plain(q, k, v, keys, dos, 0.125,
                                                                       1234, p)],
                2 * BF16_ULP, bwd, _sdpa_bwd(*qkv.chunk(3, -1), do), strided_main)
    if merged_main is not None:
        compare(res, "attention_train_merged", (b, n, 2304, f"p={p}"),
                lambda: A.attention_train_merged_fwd(qkv, keys, 0.125, 1234, p)[0],
                lambda: A.attention_train_merged_plain(qkv, keys, 0.125, 1234, p), 2 * BF16_ULP,
                fwd, lambda: _sdpa(*qkv.chunk(3, -1)), merged_main)
        compare(res, "attention_train_merged_bwd", (b, n, 2304, f"p={p}"),
                lambda: A.attention_train_merged_bwd(qkv, keys, do, 0.125, 1234, p, st),
                lambda: A.attention_train_merged_bwd_plain(qkv, keys, do, 0.125, 1234, p),
                2 * BF16_ULP, bwd, _sdpa_bwd(*qkv.chunk(3, -1), do), merged_main)


def layouts_agree(A, b, n, p):
    """Strided, packed and merged kernels on the same values and seed,
    forward and backward: the largest difference and whether every output
    is bit-equal (one math, one keep mask, three sets of strides)."""
    qkv, do = randn((b, n, 2304), 81), randn((b, n, 768), 82)
    q, k, v = (t.contiguous() for t in qkv.chunk(3, -1))
    keys = torch.ones((b, n), device="cuda")
    heads = lambda t: t.view(b, n, 12, 64).transpose(1, 2)  # noqa: E731
    packed = lambda t: t.transpose(1, 2).reshape(b, n, 768)  # noqa: E731
    outs, st = A.attention_train_fwd(q, k, v, keys, 0.125, 99, p)
    outs = [outs,
            packed(A.attention_train_strided_fwd(heads(q), heads(k), heads(v), keys, 0.125, 99,
                                                 p)[0]),
            A.attention_train_merged_fwd(qkv, keys, 0.125, 99, p)[0]]
    grads = [torch.cat(A.attention_train_bwd(q, k, v, keys, do, 0.125, 99, p, st), -1),
             torch.cat([packed(g) for g in A.attention_train_strided_bwd(
                 heads(q), heads(k), heads(v), keys, heads(do), 0.125, 99, p, saved=st)], -1),
             A.attention_train_merged_bwd(qkv, keys, do, 0.125, 99, p, st)]
    torch.cuda.synchronize()
    diff = max(float((x.float() - xs[0].float()).abs().max()) for xs in (outs, grads)
               for x in xs[1:])
    equal = all(torch.equal(x, xs[0]) for xs in (outs, grads) for x in xs[1:])
    mx = max(float(x.float().abs().max()) for x in (outs[0], grads[0]))
    print(f"  strided / packed / merged at {(b, n, 768, f'p={p}')}: forward and backward largest "
          f"difference {diff:.4g} (bit-equal: {equal})", flush=True)
    if not diff <= 2 * BF16_ULP * mx:
        fail("the strided, packed and merged training attention disagree")
    return {"shape": [b, n, 768], "p": p, "max_abs_diff": diff, "bit_equal": equal}


def grid(shape, seed, tie_break):
    """bf16 values k / 4, k an integer in [-4, 4], so every sum of 512
    products of two of them is exact in fp32 in any order: the max-mean
    kernels and their twin see the same sims to the bit. The last feature
    separates the keys: queries carry 1/16 there and key v of a clip
    carries v/512 (``tie_break``), which adds v/8192 to every sim, less
    than the 1/16 step of the rest, so the keys of a row never tie and each
    row's max exceeds its runner-up by at least 2^-13 (times T)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-4, 5, size=shape).astype(np.float32) / 4
    a[..., -1] = np.arange(shape[1]) / 512 if tie_break else 1 / 16
    return torch.from_numpy(a).to("cuda", torch.bfloat16)


def min_gap(q, k, temp):
    """The smallest distance between a row's max sim and its runner-up."""
    gaps = []
    for j in range(0, k.shape[0], 8):
        ts = torch.einsum("iqd,jkd->ijqk", q.float(), k[j:j + 8].float()) * temp
        top = ts.topk(2, dim=3).values
        gaps.append(float((top[..., 0] - top[..., 1]).min()))
    return min(gaps)


def maxmean_cases(res, MM, bq, bk, nq, nk, d, masked, clamp_min, main=False):
    """The max-mean forward, dQ and dK at (bq, nq) x (bk, nk), D = d, bf16
    features as the loss receives them, on grid() inputs (exact sims, every
    row's max separated from its runner-up): the first argmax of every row
    equal to the twin's, the outputs within 1e-4 of the largest (fp32 sums
    in another order; dts as bf16 hi + lo halves in the backward). No one
    library call computes the function. Bounds at the bf16 tensor-core
    peak, the peak of the products the kernels run: 2 Bq Bk Nq Nk D
    operations forward, twice that per backward pass (recompute the sims,
    then dts K or dts^T Q). At the main shape the backward's composition
    (maxmean_bwd_composition) is timed beside each backward kernel."""
    q, k = grid((bq, nq, d), 91, False), grid((bk, nk, d), 92, True)
    mask = None
    if masked:
        mask = torch.ones((bq, nq), device="cuda")
        mask[1::2, nq * 3 // 4:] = 0.0
    coeff = MM.coefficients(bq, nq, mask, "cuda")
    temp = torch.tensor(1.5, device="cuda")
    ops = 2 * bq * bk * nq * nk * d
    qb, kb, nb = bq * nq * d * 2, bk * nk * d * 2, bq * nq * 4
    got, ref = MM.maxmean_fwd(q, k, temp, coeff, clamp_min), MM.maxmean_plain(
        q, k, temp, coeff, clamp_min)
    torch.cuda.synchronize()
    if not torch.equal(got[3], ref[3]):
        fail(f"maxmean at {(bq, nq, nk, d)}: a first argmax differs from the twin's")
    gap = min_gap(q, k, temp)
    print(f"  maxmean inputs: every row's max exceeds its runner-up by >= {gap:.4g} (2^-13 T = "
          f"{1.5 / 8192:.4g}); the first argmax of every row equals the twin's", flush=True)
    if not gap >= 1.5 / 8192:
        fail("the max-mean inputs have a row whose maximum is not separated")
    shape = (bq, nq, bk, nk, d) + (("masked",) if masked else ())
    compare(res, "maxmean", shape, lambda: MM.maxmean_fwd(q, k, temp, coeff, clamp_min)[:3],
            lambda: MM.maxmean_plain(q, k, temp, coeff, clamp_min)[:3], 1e-4,
            cost(ops, qb + kb + nb + bq * bk * 4 + bq * bk * nq * 4), None, main)
    g_clip = randn((bq, bk), 93, 1.0 / bq, torch.float32)
    args = (q, k, temp, coeff, clamp_min, ref[3], g_clip, torch.tensor(0.01, device="cuda"))
    bwd_in = qb + kb + nb + bq * bk * nq * 4 + bq * bk * 4
    compare(res, "maxmean_dq", shape, lambda: MM.maxmean_dq(*args),
            lambda: MM.maxmean_dq_plain(*args), 1e-4, cost(2 * ops, bwd_in + bq * nq * d * 4),
            None, main, maxmean_bwd_composition(args) if main else None)
    compare(res, "maxmean_dk", shape, lambda: MM.maxmean_dk(*args),
            lambda: MM.maxmean_dk_plain(*args), 1e-4, cost(2 * ops, bwd_in + bk * nk * d * 4),
            None, main, maxmean_bwd_composition(args, dk=True) if main else None)


def maxmean_bwd_composition(args, dk=False):
    """dQ (or, with dk, dK) of the max-mean backward as PyTorch composes
    it: the sims of every pair in one bf16 product with fp32 output
    (torch.mm, out_dtype), the dts arithmetic on that (Bq Nq, Bk Nk) volume
    (the window term, g_clip coeff scattered to each row's first argmax,
    times T), dts as bf16 hi + lo, and two products with K (or Q) with
    fp32 output. A yardstick, not one library call; the port never calls
    it (2.1 GB of fp32 volume at the AV shape)."""
    q, k, temp, coeff, clamp_min, amax, g_clip, g_nn = args
    f32, bf16 = torch.float32, torch.bfloat16
    bq, nq, d = q.shape
    bk, nk, _ = k.shape
    q2, k2 = q.reshape(-1, d), k.reshape(-1, d)
    cols = (torch.arange(bk, device=q.device)[None, :, None] * nk + amax.long()).transpose(1, 2)
    cols = cols.reshape(bq * nq, bk)
    g_max = (g_clip[:, :, None] * coeff[:, None, :]).transpose(1, 2).reshape(bq * nq, bk)

    def run():
        ts = torch.mm(q2, k2.t(), out_dtype=f32).mul_(temp)
        dts = torch.where((ts > clamp_min) & (ts < 0.0), ts * (2.0 * g_nn), 0.0)
        del ts
        dts.scatter_add_(1, cols, g_max).mul_(temp)
        hi = dts.to(bf16)
        lo = dts.sub_(hi.to(f32)).to(bf16)
        del dts
        if dk:
            return torch.mm(hi.t(), q2, out_dtype=f32).add_(torch.mm(lo.t(), q2, out_dtype=f32))
        return torch.mm(hi, k2, out_dtype=f32).add_(torch.mm(lo, k2, out_dtype=f32))
    return run


def real_features(bq, bk, nq, nk, d, dtype):
    """q (bq, nq, d) and k (bk, nk, d): L2-normalised Gaussians (seed 94)
    on the card in dtype."""
    rng = np.random.default_rng(94)
    return (torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)), dim=-1).to("cuda", dtype)
        for shape in ((bq, nq, d), (bk, nk, d)))


def maxmean_split_case(res, MM, bq, bk, nq, nk, d, clamp_min):
    """The max-mean forward on real fp32 features, which the loss receives
    from a model with compute_dtype float32: the kernel splits them into
    bf16 hi + lo and sums hh + lh + hl. clip, nonneg and tsq within 1e-4 of
    the twin's largest; the share of rows whose first argmax agrees
    printed. The bound counts the kernel's three bf16 products."""
    q, k = real_features(bq, bk, nq, nk, d, torch.float32)
    coeff = MM.coefficients(bq, nq, None, "cuda")
    temp = torch.tensor(10.0, device="cuda")
    amax = MM.maxmean_fwd(q, k, temp, coeff, clamp_min)[3]
    agree = float((amax == MM.maxmean_plain(q, k, temp, coeff, clamp_min)[3]).float().mean())
    print(f"  maxmean on real fp32 features: the first argmax of {100 * agree:.4f}% of "
          f"{amax.numel()} rows equals the twin's", flush=True)
    ops = 2 * bq * bk * nq * nk * d
    nbytes = bq * nq * d * 4 + bk * nk * d * 4 + bq * nq * 4 + bq * bk * 4 + bq * bk * nq * 4
    compare(res, "maxmean", (bq, nq, bk, nk, d, "real", "fp32"),
            lambda: MM.maxmean_fwd(q, k, temp, coeff, clamp_min)[:3],
            lambda: MM.maxmean_plain(q, k, temp, coeff, clamp_min)[:3], 1e-4,
            cost(3 * ops, nbytes))


def maxmean_real_case(res, MM, bq, bk, nq, nk, d, clamp_min):
    """The max-mean kernels on real features: L2-normalised bf16 Gaussians,
    whose sims sum in another order in kernel and twin and whose rows may
    nearly tie. The forward's clip, nonneg and tsq within 1e-4 of the
    largest (a max is continuous even where its argmax flips), the share of
    rows whose first argmax agrees printed; dQ and dK with kernel and twin
    fed the kernel's own argmax, so a near tie can neither hide nor fake a
    routing error. T = 10 puts most sims in the clamp window."""
    q, k = real_features(bq, bk, nq, nk, d, torch.bfloat16)
    coeff = MM.coefficients(bq, nq, None, "cuda")
    temp = torch.tensor(10.0, device="cuda")
    amax = MM.maxmean_fwd(q, k, temp, coeff, clamp_min)[3]
    agree = float((amax == MM.maxmean_plain(q, k, temp, coeff, clamp_min)[3]).float().mean())
    print(f"  maxmean on real features: the first argmax of {100 * agree:.4f}% of "
          f"{amax.numel()} rows equals the twin's", flush=True)
    ops = 2 * bq * bk * nq * nk * d
    qb, kb, nb = bq * nq * d * 2, bk * nk * d * 2, bq * nq * 4
    shape = (bq, nq, bk, nk, d, "real")
    compare(res, "maxmean", shape, lambda: MM.maxmean_fwd(q, k, temp, coeff, clamp_min)[:3],
            lambda: MM.maxmean_plain(q, k, temp, coeff, clamp_min)[:3], 1e-4,
            cost(ops, qb + kb + nb + bq * bk * 4 + bq * bk * nq * 4))
    args = (q, k, temp, coeff, clamp_min, amax, randn((bq, bk), 95, 1.0 / bq, torch.float32),
            torch.tensor(0.01, device="cuda"))
    bwd_in = qb + kb + nb + bq * bk * nq * 4 + bq * bk * 4
    compare(res, "maxmean_dq", shape, lambda: MM.maxmean_dq(*args),
            lambda: MM.maxmean_dq_plain(*args), 1e-4, cost(2 * ops, bwd_in + bq * nq * d * 4))
    compare(res, "maxmean_dk", shape, lambda: MM.maxmean_dk(*args),
            lambda: MM.maxmean_dk_plain(*args), 1e-4, cost(2 * ops, bwd_in + bk * nk * d * 4))


def mlp_fwd_composition(x, w1, b1, w2, b2, form):
    """The forward as cuBLAS and PyTorch compose it at p = 0, bf16
    throughout: addmm, F.gelu, addmm (three calls, h and g through device
    memory in bf16). A yardstick, not one library call."""
    import torch.nn.functional as F

    x2, approx = x.reshape(-1, x.shape[-1]), "tanh" if form == "tanh" else "none"
    return lambda: torch.addmm(b2, F.gelu(torch.addmm(b1, x2, w1.t()), approximate=approx),
                               w2.t())


def mlp_bwd_composition(x, w1, b1, w2, dy, form):
    """The backward (dx, dh, g) as a composition at p = 0, bf16
    throughout: h = addmm, g = F.gelu(h), dg = dy W2, dh = gelu_backward(dg,
    h), dx = dh W1: the three products and GELU' of the fused kernels."""
    import torch.nn.functional as F

    x2, dy2 = x.reshape(-1, x.shape[-1]), dy.reshape(-1, dy.shape[-1])
    approx = "tanh" if form == "tanh" else "none"

    def run():
        h = torch.addmm(b1, x2, w1.t())
        dh = torch.ops.aten.gelu_backward(dy2 @ w2, h, approximate=approx)
        return dh @ w1, dh, F.gelu(h, approximate=approx)
    return run


def mlp_bwd_case(res, M, w, b, n, seed, form, p, main=False):
    w1, b1, w2, _ = w
    x, dy = randn((b, n, 768), seed), randn((b, n, 768), seed + 1)
    m = b * n
    compare(res, "fused_mlp_bwd", (b, n, 768, form, f"p={p}"),
            lambda: M.fused_mlp_bwd(x, w1, b1, w2, dy, form, 77, p),
            lambda: M.fused_mlp_bwd_plain(x, w1, b1, w2, dy, form, 77, p), 2 * BF16_ULP,
            cost(6 * m * 768 * 3072, (3 * m * 768 + 2 * m * 3072 + 2 * 768 * 3072) * 2),
            None, main, mlp_bwd_composition(x, w1, b1, w2, dy, form))


def mlp_fwd_cost(m):
    return cost(4 * m * 768 * 3072, (2 * m * 768 + 2 * 768 * 3072 + 3072 + 768) * 2)


def stats_cost(b, t):
    """The GroupNorm stats' bound: the waveform and w0 read once, (mean,
    var) written, and the Gram pass's work, 65 fp64 multiply-adds a conv_0
    step (the tap Gram's 55 products, the 10 tap sums)."""
    m0 = (t - 10) // 5 + 1
    return cost(2 * 65 * b * m0, b * t * 4 + 512 * 10 * 4 + 2 * b * 512 * 4, PEAK_FP64)


def stats_composition(wave, w0):
    """The stats by library calls: the fp32 conv_0 (cuDNN, TF32 off) and
    the means of y and y^2. A yardstick, not one library call."""
    import torch.nn.functional as F

    def run():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y = F.conv1d(wave[:, None, :], w0, stride=5)
        return y.mean(dim=-1), (y * y).mean(dim=-1)
    return run


def conv0_composition(wave, w0, scale, bias, form):
    """conv_0 by library calls: F.conv1d on bf16 operands, the affine in
    fp32, bf16, F.gelu and the transpose to (B, m0, 512)."""
    import torch.nn.functional as F

    w0b, approx = w0.to(torch.bfloat16), "tanh" if form == "tanh" else "none"

    def run():
        y = F.conv1d(wave.to(torch.bfloat16)[:, None, :], w0b, stride=5)
        z = torch.addcmul(bias[:, :, None], y, scale[:, :, None]).to(torch.bfloat16)
        return F.gelu(z, approximate=approx).transpose(1, 2).contiguous()
    return run


def frontend_cases(res, FE, wave, w0, gs, gb):
    """The stats and conv_0 at wave's (B, T) beside their twins and
    compositions; returns conv_0's folded affine (scale, bias). B = 64,
    the train steps' shape, is the kernels' main case. The stats
    are fp64 Gram sums against the fp32 recompute (1e-4 of the largest
    variance), and within an fp32 ulp (1e-6) of the Gram twin, which takes
    the same exact products in another order; conv_0 2 bf16 ulps."""
    b, t = wave.shape
    m0 = (t - 10) // 5 + 1
    compare(res, "frontend_stats", (b, t), lambda: FE.conv0_stats(wave, w0),
            lambda: FE.conv0_stats_plain(wave, w0), 1e-4, stats_cost(b, t),
            main=b == TRAIN_B, composition_fn=stats_composition(wave, w0))
    if hasattr(FE, "conv0_stats_gram_plain"):  # an older checkout's kernels lack it
        mean, var = FE.conv0_stats(wave, w0)
        rm, rv = FE.conv0_stats_gram_plain(wave, w0)
        gap = max(float((mean - rm).abs().max()) / float(rv.sqrt().max()),
                  float((var - rv).abs().max()) / float(rv.max()))
        print(f"  frontend_stats vs the Gram twin {(b, t)}: {gap:.3g} of the largest "
              f"variance (tol 1e-6)", flush=True)
        if not gap <= 1e-6:
            fail(f"frontend_stats at {(b, t)} disagrees with its Gram twin")
    mean, var = FE.conv0_stats_plain(wave, w0)
    scale = torch.rsqrt(var + FE.GN_EPS) * gs
    bias = gb - mean * scale
    compare(res, "frontend_conv0", (b, t),
            lambda: FE.conv0_norm_gelu(wave, w0, scale, bias, "tanh"),
            lambda: FE.conv0_norm_gelu_plain(wave, w0, scale, bias, "tanh"), 2 * BF16_ULP,
            cost(2 * b * m0 * 512 * 10, b * t * 4 + 512 * 10 * 4 + b * m0 * 512 * 2),
            main=b == TRAIN_B, composition_fn=conv0_composition(wave, w0, scale, bias, "tanh"))
    got = FE.conv0_norm_gelu(wave, w0, scale, bias, "tanh")
    ref = FE.conv0_norm_gelu_plain(wave, w0, scale, bias, "tanh")
    print(f"  frontend_conv0 {(b, t)}: {100 * float((got != ref).float().mean()):.4f}% of the "
          f"outputs differ from the twin's bits", flush=True)
    del got, ref
    return scale, bias


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
    # library call computes fc1 + GELU + fc2: the composition addmm +
    # F.gelu + addmm is timed beside it (at p = 0 also beside the p = 0.1
    # cases, which it does not compute: their mask is left out).
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
                    mlp_fwd_cost(B * n),
                    composition_fn=mlp_fwd_composition(x, w1, b1, w2, b2, form))
    # frontend at (B, 160000) and at the train steps' (64, 160000): the
    # stats and conv_0 (frontend_cases), the stride-2 conv (2 ulps).
    rng = np.random.default_rng(11)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to("cuda")
    w0 = f(rng.standard_normal((512, 1, 10)) * (2 / 10) ** 0.5)
    gs = f(rng.standard_normal(512) * 0.2 + 1.0)
    gb = f(rng.standard_normal(512) * 0.1)
    ws = [f(rng.standard_normal((512, 512, kk)) * (2 / (kk * 512)) ** 0.5)
          for kk in FE.KERNELS[1:]]
    frontend_cases(res, FE, randn((TRAIN_B, AUDIO), 15, dtype=torch.float32), w0, gs, gb)
    wave = randn((B, AUDIO), 12, dtype=torch.float32)
    m0 = (AUDIO - 10) // 5 + 1
    scale, bias = frontend_cases(res, FE, wave, w0, gs, gb)
    # conv_1's input as the stack hands it over: (B, T, 512) contiguous
    # (the plain conv_0 returns a transposed view, which the wrapper would
    # copy)
    x1 = FE.conv0_norm_gelu_plain(wave, w0, scale, bias, "tanh").contiguous()
    t1 = (x1.shape[1] - 3) // 2 + 1
    x1t, w1b = x1.transpose(1, 2).contiguous(), ws[0].to(torch.bfloat16)
    compare(res, "frontend_conv", (B, x1.shape[1], 512, "k3"),
            lambda: FE.conv_s2_gelu(x1, ws[0], "tanh"),
            lambda: FE.conv_s2_gelu_plain(x1, ws[0], "tanh"), 2 * BF16_ULP,
            cost(2 * B * t1 * 512 * 512 * 3, (B * (x1.shape[1] + t1) * 512 + 3 * 512 ** 2) * 2),
            lambda: F.conv1d(x1t, w1b, stride=2))
    del x1t
    # conv_1 at the train steps' B = 64 (the joint and AV steps' frontend)
    x64 = torch.randn((TRAIN_B, x1.shape[1], 512), device="cuda", dtype=torch.bfloat16,
                      generator=torch.Generator(device="cuda").manual_seed(14))  # 1e9 draws
    x64t = x64.transpose(1, 2).contiguous()
    compare(res, "frontend_conv", (TRAIN_B, x1.shape[1], 512, "k3"),
            lambda: FE.conv_s2_gelu(x64, ws[0], "tanh"),
            lambda: FE.conv_s2_gelu_plain(x64, ws[0], "tanh"), 2 * BF16_ULP,
            cost(2 * TRAIN_B * t1 * 512 * 512 * 3,
                 (TRAIN_B * (x1.shape[1] + t1) * 512 + 3 * 512 ** 2) * 2),
            lambda: F.conv1d(x64t, w1b, stride=2))
    del x64, x64t
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
                2 * BF16_ULP, mlp_fwd_cost(b * 499), None, main,
                mlp_fwd_composition(x, w1, b1, w2, b2, "tanh"))
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
    # dW at B = 96, past the train steps' batch (its blocks reduce every row)
    b = 96
    x, dz = randn((b, 499, 768), 45), randn((b, 499, 768), 46)
    xt, gout = x.transpose(1, 2).contiguous(), F.pad(dz.transpose(1, 2), (0, 1)).contiguous()
    compare(res, "posconv_dw", (b, 499, 768),
            lambda: P.pos_conv_dw(x, dz, 16, 128), lambda: P.pos_conv_dw_plain(x, dz, 16, 128),
            1e-4, cost(2 * b * 499 * 768 * 128 * 48, 4 * b * 499 * 768 + 768 * 48 * 128 * 4),
            lambda: torch.nn.grad.conv1d_weight(xt, wpc.shape, gout, padding=64, groups=16))
    del x, dz, xt, gout
    # The strided layout at Path A's (22, 499) and the train steps' B = 64,
    # HuBERT's p = 0.1; the merged layout at Path B's HuBERT (64, 499) p =
    # 0.1 and ViT (64, 261) p = 0. 2 bf16 ulps, as the packed kernels.
    attention_layout_cases(res, A, DEFAULT_B, 499, P_DROP, 101, strided_main=True,
                           merged_main=None)
    attention_layout_cases(res, A, TRAIN_B, 499, P_DROP, 103, merged_main=True)
    attention_layout_cases(res, A, TRAIN_B, 261, 0.0, 105, strided_main=None)
    agree = layouts_agree(A, TRAIN_B, 499, P_DROP)
    # The training attention past 512 keys (no key cap): HuBERT on 20 s
    # clips, N = 999 -> 1000, dropout live. Same bounds.
    attention_cases(res, A, B, 1000, 27, P_DROP)
    # max-mean at the AV loss's (64 x 499) x (64 x 256) and the TV loss's
    # masked (64 x 32) x (64 x 256), D = 512, the reference's clamps
    from triad_tpu_torch.ops import maxmean as MM

    maxmean_cases(res, MM, TRAIN_B, TRAIN_B, 499, 256, 512, False, -60.0, main=True)
    maxmean_cases(res, MM, TRAIN_B, TRAIN_B, TRAIN_TXT, 256, 512, True, -20.0)
    maxmean_real_case(res, MM, TRAIN_B, TRAIN_B, 499, 256, 512, -60.0)
    maxmean_split_case(res, MM, TRAIN_B, TRAIN_B, 499, 256, 512, -60.0)
    eval_slice_cases(res, A)
    # The eval attention in its four modes past the old 512-key cap:
    # HuBERT on 20 s clips, N = 999, and N = 1000.
    for n in (999, 1000):
        eval_attention_cases(res, A, n)
    flash_cases(res)
    return res, agree


def eval_attention_cases(res, A, n):
    """The eval attention kernel's four modes at (B, n) with 12 heads:
    packed and head-pair packed with a key mask (ones), merged and
    head-pair merged on one qkv tensor without one; 2 bf16 ulps, as at
    the serving shapes. Library: SDPA."""
    qkv = randn((B, n, 2304), 200 + n)
    q, k, v = (t.contiguous() for t in qkv.split(768, dim=-1))
    ones = torch.ones((B, n), device="cuda")
    packed = cost(4 * B * 12 * n ** 2 * 64, 4 * B * n * 768 * 2 + B * n * 4)
    merged = cost(4 * B * 12 * n ** 2 * 64, B * n * (2304 + 768) * 2)
    compare(res, "attention_eval", (B, n, 768), lambda: A.attention_eval(q, k, v, ones),
            lambda: A.attention_eval_plain(q, k, v, ones, 0.125, -(-n // 128) * 128),
            2 * BF16_ULP, packed, lambda: _sdpa(q, k, v))
    compare(res, "attention_eval_pair", (B, n, 768), lambda: A.attention_eval_pair(q, k, v, ones),
            lambda: A.attention_eval_pair_plain(q, k, v, ones, 0.125), 2 * BF16_ULP, packed,
            lambda: _sdpa(q, k, v))
    compare(res, "attention_eval_merged", (B, n, 2304), lambda: A.attention_eval_merged(qkv),
            lambda: A.attention_eval_plain(q, k, v, ones, 0.125), 2 * BF16_ULP, merged,
            lambda: _sdpa(q, k, v))
    compare(res, "attention_eval_merged_pair", (B, n, 2304),
            lambda: A.attention_eval_merged_pair(qkv),
            lambda: A.attention_eval_pair_plain(q, k, v, ones, 0.125), 2 * BF16_ULP, merged,
            lambda: _sdpa(q, k, v))


def flash_cases(res):
    """The flash kernels at the shapes of their paths, on the (B, H, N, 64)
    views of (B, N, H, 64) projections, as the encoders pass them: the
    ViT's training shape (64, 261), HuBERT's eval (8, 499), DistilBERT's
    (8, 128) with ragged keys and one row whose keys are all masked, and
    (8, 1000), past the eval kernels' old 512-key cap; then (64, 261) on q,
    k, v sliced out of one fused (64, 261, 3, 12, 64) qkv tensor (row
    stride 2304), which the kernels load through their strides. The kernel
    walks 64-key tiles with an online softmax, the twin the library's
    512-key blocks, so their bf16 roundings of P (and so of O, dS and the
    gradients) differ here and there: 2 bf16 ulps of each output's largest
    magnitude. Both backward sides take the twin's O, l and m. Library:
    SDPA with the key mask, and its autograd backward. Bound: products over
    the keys this data needs (a masked key adds nothing unless its whole
    row is masked): 2 of N x keys x 64 per head forward, 5 backward (S
    again, dP, dV, dK, dQ)."""
    import torch.nn.functional as F

    from triad_tpu_torch.ops import flash_attention as FA

    for b, n, masked, fused, main in ((TRAIN_B, 261, False, False, True),
                                      (B, 499, False, False, False),
                                      (B, 128, True, False, False),
                                      (B, 1000, False, False, False),
                                      (TRAIN_B, 261, False, True, False)):
        if fused:
            qkv = randn((b, n, 3, 12, 64), 111)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            do = randn((b, n, 12, 64), 114).transpose(1, 2)
        else:
            q, k, v, do = (randn((b, n, 12, 64), 111 + i).transpose(1, 2) for i in range(4))
        mask = attn_mask = None
        keys = b * n
        if masked:
            mask = torch.ones((b, n), device="cuda")
            mask[1::2, n * 3 // 4:] = 0.0
            mask[-1] = 0.0
            attn_mask = mask.bool()[:, None, None, :]
            per_row = mask.sum(dim=-1)
            keys = int(torch.where(per_row > 0, per_row, float(n)).sum())
        flops = 4 * 12 * n * keys * 64
        act, stats = b * n * 768 * 2, 2 * b * 12 * n * 4 + (b * n * 4 if masked else 0)
        shape = ((b, 12, n, 64) + (("masked",) if masked else ())
                 + (("fused qkv",) if fused else ()))
        compare(res, "flash_attention", shape,
                lambda: FA.flash_attention_fwd(q, k, v, mask, 0.125)[0],
                lambda: FA.flash_fwd_plain(q, k, v, mask, 0.125)[0], 2 * BF16_ULP,
                cost(flops, 4 * act + stats),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask), main)
        o, l, m = FA.flash_fwd_plain(q, k, v, mask, 0.125)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask)
        compare(res, "flash_attention_bwd", shape,
                lambda: FA.flash_attention_bwd(q, k, v, mask, o, l, m, do, 0.125),
                lambda: FA.flash_bwd_plain(q, k, v, mask, o, l, m, do, 0.125), 2 * BF16_ULP,
                cost(flops * 5 // 2, 8 * act + stats),
                lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), main)


def eval_slice_cases(res, A):
    """The kernels of the retrieval eval (phase 12) at its shapes, B = 8:
    the head-pair attention at HuBERT's (8, 499) (keys 499 -> 512 in the
    softmax), DistilBERT's (8, 128) with its key mask and the ViT's merged
    (8, 261) (-> 384); the fused frontend conv at conv_1's (k 3,
    "norm_gelu"), conv_2's (k 3, "gelu") and conv_5's (k 2, "gelu")
    inputs; the frontend activation at (8, 31999, 512). 2 bf16 ulps of the
    largest output (both round the same fp32 values; sums in another
    order). Library: SDPA (with the key mask), F.gelu for the "gelu"
    activation; no one call applies a conv's input prologue or the
    GroupNorm affine + GELU."""
    import torch.nn.functional as F

    from triad_tpu_torch.ops import frontend_conv as FC

    for n, masked in ((499, False), (128, True)):
        q, k, v = (randn((B, n, 768), s) for s in (51, 52, 53))
        mask = torch.ones((B, n), device="cuda")
        if masked:
            mask[1::2, n * 3 // 4:] = 0.0  # every other caption padded
        compare(res, "attention_eval_pair", (B, n, 768) + (("masked",) if masked else ()),
                lambda: A.attention_eval_pair(q, k, v, mask),
                lambda: A.attention_eval_pair_plain(q, k, v, mask, 0.125), 2 * BF16_ULP,
                cost(4 * B * 12 * n ** 2 * 64, 4 * B * n * 768 * 2 + B * n * 4),
                lambda: _sdpa(q, k, v, mask if masked else None), main=not masked)
    qkv = randn((B, 261, 2304), 54)
    ones = torch.ones((B, 261), device="cuda")
    compare(res, "attention_eval_merged_pair", (B, 261, 2304),
            lambda: A.attention_eval_merged_pair(qkv),
            lambda: A.attention_eval_pair_plain(*qkv.split(768, dim=-1), ones, 0.125),
            2 * BF16_ULP, cost(4 * B * 12 * 261 ** 2 * 64, B * 261 * (2304 + 768) * 2),
            lambda: _sdpa(*qkv.split(768, dim=-1)), main=True)
    stats = (randn((B, 1, 512), 55, 0.3, torch.float32),
             randn((B, 1, 512), 56, 0.2, torch.float32).abs() + 0.5,
             randn((512,), 57, 0.3, torch.float32) + 1.0, randn((512,), 58, 0.1, torch.float32))
    for t, k, prologue in ((31999, 3, "norm_gelu"), (15999, 3, "gelu"), (1999, 2, "gelu")):
        x = randn((B, t, 512), 59)
        w = randn((512, 512, k), 60, (2 / (k * 512)) ** 0.5, torch.float32)
        tout = FC.out_rows(t, k)
        compare(res, "fused_frontend_conv", (B, t, 512, f"k{k}", prologue),
                lambda: FC.fused_frontend_conv_fwd(x, w, *stats, t, prologue),
                lambda: FC.fused_frontend_conv_plain(x, w, *stats, t, prologue), 2 * BF16_ULP,
                cost(2 * B * tout * 512 * 512 * k,
                     (B * (t + tout) * 512 + k * 512 * 512) * 2 + 2 * B * 512 * 4),
                None, main=prologue == "norm_gelu")
    # the activation at conv_1's input (31999 rows, not a multiple of a
    # block's 16), and at (2, 1000, 768): 96 16-byte slots a row
    for b, t, c in ((B, 31999, 512), (2, 1000, 768)):
        x = randn((b, t, c), 61)
        st = stats if c == 512 else (
            randn((b, 1, c), 62, 0.3, torch.float32),
            randn((b, 1, c), 63, 0.2, torch.float32).abs() + 0.5,
            randn((c,), 64, 0.3, torch.float32) + 1.0, randn((c,), 65, 0.1, torch.float32))
        for act in ("norm_gelu", "gelu"):
            compare(res, "frontend_activation", (b, t, c, act),
                    lambda: FC.frontend_activation_fwd(x, *st, act),
                    lambda: FC.frontend_activation_plain(x, *st, act), 2 * BF16_ULP,
                    cost(b * t * c * (8 if act == "norm_gelu" else 4),
                         2 * b * t * c * 2 + (2 * b + 2) * c * 4 * (act == "norm_gelu"),
                         PEAK_FP32),
                    (lambda: F.gelu(x)) if act == "gelu" else None,
                    main=act == "norm_gelu" and c == 512)


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


def _train_batch(b, seed, tokens=TRAIN_TXT):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, tokens), np.float32)
    mask[1::2, tokens * 3 // 4:] = 0.0  # every other caption padded
    return {
        "images": torch.from_numpy(rng.standard_normal((b, 224, 224, 3), dtype=np.float32)),
        "token_ids": torch.from_numpy(rng.integers(1, 30_000, size=(b, tokens))),
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


def _new_state(ocfg, seed, model_cfg=None):
    from triad_tpu_torch.config import perf_train_model_config
    from triad_tpu_torch.models.convert import init_triad_model
    from triad_tpu_torch.train.optim import OptimizerBank
    from triad_tpu_torch.train.step import TrainState

    model = init_triad_model(model_cfg or perf_train_model_config(),
                             torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    return TrainState(model, OptimizerBank(ocfg, model, total_updates=1000), 0, 1)


def _run_steps(step, state, batches, loss_keys, n, warmup, record=None):
    """n steps; returns the median ms of the steps after ``warmup``. Each
    step's losses are appended to ``record`` where given."""
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
        if record is not None:
            record.append(losses)
        if i >= warmup:
            times.append(ms)
    return statistics.median(times) if times else None


def _check_launches(launches, names, path):
    print(f"  launches during the steps: {launches}", flush=True)
    for name in names:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the {path} steps")


def train_phase(model_cfg=None, kernel_names=TV_KERNELS, profile="train_profile.txt"):
    """The full-width text-visual step of ``model_cfg`` (default
    perf_train_model_config()); returns the model, the launch counts of
    the steps and the median ms of the timed steps."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.config import OptimConfig, perf_train_loss_config
    from triad_tpu_torch.train.step import StepFactory

    ocfg = OptimConfig(gradient_accumulation_steps=1)
    state = _new_state(ocfg, 0, model_cfg)
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
    _check_launches(launches, kernel_names, "text-visual")
    profile_step(lambda: step(state, None, batch), profile)
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


def _unfrozen(ocfg):
    """Every group unfrozen from step 0: the bank gates by requires_grad,
    so a gated group would launch no backward kernel."""
    return dataclasses.replace(ocfg, unfreeze_audio_step=0, unfreeze_text_step=0,
                               unfreeze_vit_step=0)


def _check_audio_moved(model, before, path):
    moved = 0
    for name, p in model.named_parameters():
        changed = not torch.equal(p, before[name])
        if name.startswith("audio_backbone") and not changed:
            fail(f"{name} did not move in the {path} steps")
        if name.startswith("visual_backbone") and "lora_" not in name and changed:
            fail(f"{name} (the frozen ViT base) changed in the {path} steps")
        moved += changed
    print(f"  {moved} parameter tensors moved, every HuBERT one among them; ViT base "
          "bit-unchanged", flush=True)


def _default_steps(remat=None):
    """configs/default.yaml's 6 joint micro steps (2 warm-up, 4 timed; one
    accumulation boundary) from its seeded start (seed 2) on the batches of
    seeds 9 and 10, every group unfrozen; ``remat`` replaces HuBERT's
    policy. Returns (model, loss config, launch counts, median ms, (peak
    bytes, bytes allocated before the steps), per-step losses, the
    parameters before the steps, (step, state, batches))."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.config import default_train_config
    from triad_tpu_torch.train.step import StepFactory

    cfg = default_train_config()
    model_cfg = cfg.model if remat is None else dataclasses.replace(
        cfg.model, hubert=dataclasses.replace(cfg.model.hubert, remat=remat))
    ocfg = _unfrozen(cfg.train.optim)
    state = _new_state(ocfg, 2, model_cfg)
    model = state.model
    h = model.cfg.hubert
    print(f"  HuBERT attention_impl {h.attention_impl!r}, mlp_impl {h.mlp_impl!r} ({h.mlp_gelu} "
          f"GELU), ln_impl {h.ln_impl!r}, frontend {h.frontend_impl!r}, remat {h.remat!r} "
          f"(chunked frontend: {model.audio_backbone.feature_extractor.chunked()}, "
          f"{h.frontend_chunk_tokens} tokens a block); loss {cfg.loss.implementation!r} at "
          f"{cfg.loss.matmul_precision!r}; accumulation {ocfg.gradient_accumulation_steps}",
          flush=True)
    step = StepFactory(cfg.loss, ocfg).make_step("joint")
    d = cfg.data
    av = {k: v.cuda() for k, v in _av_batch(d.batch_size_av, 9).items()}
    tv = {k: v.cuda() for k, v in _train_batch(d.batch_size_tv, 10, d.max_text_tokens).items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses = []
    step_ms = _run_steps(step, state, (av, tv, 0.5, 0.5), ("loss_av", "loss_tv"), 6, 2, losses)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"  median of 4 timed micro steps: {step_ms:.3f} ms; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB (max_memory_allocated), {(peak - base) / 2 ** 30:.3f} GiB "
          f"above the {base / 2 ** 30:.3f} GiB allocated before the steps", flush=True)
    return model, cfg.loss, launches, step_ms, (peak, base), losses, before, (step, state, av, tv)


def default_phase():
    """Path A: configs/default.yaml's model (ModelConfig(), HuBERT's chunked
    frontend), loss (chunked, highest) and optimizer (lr 1e-4,
    accumulation 4), every group unfrozen, B = 22 AV clips of 10 s and 22
    TV pairs of 128 tokens: 2 warm-up and 4 timed joint micro steps (one
    accumulation boundary). HuBERT's "auto" attention takes the strided
    kernel (live attention dropout on the card) and its "auto" MLP the
    fused kernel with erf GELU; the packed training attention must stay
    unlaunched. Returns the model, the loss config, the launch counts, the
    median ms, the peak memory, the per-step losses and the parameters
    after the steps (on the host)."""
    model, loss_cfg, launches, step_ms, peak, losses, before, run = _default_steps()
    if not model.audio_backbone.feature_extractor.chunked():
        fail("configs/default.yaml's HuBERT frontend is not the chunked one")
    _check_audio_moved(model, before, "default-config")
    _check_launches(launches, DEFAULT_KERNELS, "default-config")
    if model.cfg.hubert.mlp_gelu != "erf":
        fail("the default config's HuBERT MLP is not the erf form")
    for name in ("attention_train", "attention_train_bwd"):
        if launches[name]:
            fail(f"{name} (the packed layout) ran under the default config")
    step, state, av, tv = run
    after = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    profile_step(lambda: step(state, av, tv, 0.5, 0.5), "default_profile.txt")
    return model, loss_cfg, launches, step_ms, peak, losses, after


def knobs_phase():
    """Path B: apply_train_knobs(perf_train_model_config(), "mqkv,vitmq")
    (merged-qkv training attention in HuBERT and the ViT) with
    LossConfig(implementation="pallas", chunk_size=32, matmul_precision=
    "default") (the max-mean kernels), every group unfrozen, B = 64, no
    accumulation: 2 warm-up and 3 timed joint steps. Each step's AV and TV
    losses launch the max-mean kernels once each. Returns as default_phase."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.config import LossConfig, OptimConfig
    from triad_tpu_torch.train.step import StepFactory

    loss_cfg = LossConfig(implementation="pallas", chunk_size=32, matmul_precision="default")
    ocfg = _unfrozen(OptimConfig(gradient_accumulation_steps=1))
    state = _new_state(ocfg, 1, model_cfg_knobs())
    model = state.model
    step = StepFactory(loss_cfg, ocfg).make_step("joint")
    av = {k: v.cuda() for k, v in _av_batch(TRAIN_B, 11).items()}
    tv = {k: v.cuda() for k, v in _train_batch(TRAIN_B, 12).items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    n_steps = 5
    step_ms = _run_steps(step, state, (av, tv, 0.5, 0.5), ("loss_av", "loss_tv"), n_steps, 2)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"  median of 3 timed joint steps: {step_ms:.3f} ms; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB (max_memory_allocated)", flush=True)
    _check_audio_moved(model, before, "mqkv + vitmq + loss=pallas")
    _check_launches(launches, KNOBS_KERNELS, "mqkv + vitmq + loss=pallas")
    for name in ("maxmean", "maxmean_dq", "maxmean_dk"):
        if launches[name] != 2 * n_steps:
            fail(f"{name}: {launches[name]} launches in {n_steps} steps, not one per AV and per "
                 "TV loss")
    profile_step(lambda: step(state, av, tv, 0.5, 0.5), "knobs_profile.txt")
    return model, loss_cfg, launches, step_ms, peak


def profile_step(fn, filename):
    """torch.profiler over one step: kernel self device time by name.
    Returns the step's ms (CUDA events) and its kernels' device ms."""
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
    row = lambda e: f"{e.self_device_time_total / 1e3:10.4f} ms {e.count:6d}x  {e.key[:110]}"
    lines += [row(e) for e in rows[:80]]
    # and the frontend's kernels wherever they rank (their rows in PERF.md)
    lines += ["frontend kernels:"] + [row(e) for e in rows if "frontend_" in e.key]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", filename), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join("  " + line for line in lines[:25]), flush=True)
    return ms, total


def model_cfg_knobs():
    """Path B's model: perf_train_model_config() with the mqkv and vitmq
    knobs (merged-qkv training attention in HuBERT and the ViT)."""
    from triad_tpu_torch.config import apply_train_knobs, perf_train_model_config

    return apply_train_knobs(perf_train_model_config(), "mqkv,vitmq")


def _initial_model(model_cfg, seed):
    """The weights a path's steps start from: its seeded init."""
    from triad_tpu_torch.models.convert import init_triad_model

    return init_triad_model(model_cfg, torch.Generator(device="cuda").manual_seed(seed),
                            device="cuda")


def _rates_off(cfg, **hubert):
    """cfg with every dropout, SpecAugment and layerdrop off (and the given
    HuBERT fields), so a step in training mode draws nothing."""
    return dataclasses.replace(
        cfg, visual_dropout_prob=0.0,
        hubert=dataclasses.replace(cfg.hubert, hidden_dropout=0.0, activation_dropout=0.0,
                                   attention_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
                                   apply_spec_augment=False, **hubert),
        text=dataclasses.replace(cfg.text, dropout=0.0, attention_dropout=0.0))


def train_reference_phase(model, groups, av_batch, tv_batch, loss_cfg=None, rates_off=None,
                          hold_groups=True):
    """One step's loss and per-group gradients at B = REF_B with every
    dropout off and the given groups trainable: the card in bf16 against
    the same weights in float32 on the CPU (plain versions there). By
    default the step runs in eval mode (train=False); with ``rates_off``
    (a dict of HuBERT fields, possibly empty) it runs in training mode on
    a copy of the model whose every rate is 0, so the training kernels
    (merged attention, forced impls) take part. The loss must agree to
    5e-2 relative (a bf16 pass through 12 + 6 layers, HuBERT's bf16
    frontend, and the squared-sim regularisers) and each group's gradient
    at cosine > 0.99 (printed only, with ``hold_groups`` False). A
    loss=pallas step also runs maxmean_witness."""
    from triad_tpu_torch.config import OptimConfig, perf_train_loss_config
    from triad_tpu_torch.models.multimodal import TriadModel
    from triad_tpu_torch.ops.dropout import HostSeeds
    from triad_tpu_torch.train.optim import label_for_path
    from triad_tpu_torch.train.step import StepFactory

    train = rates_off is not None
    if train:
        card = TriadModel(_rates_off(model.cfg, **rates_off), device="cuda")
        card.load_state_dict(model.state_dict())
    else:
        card = model
    # HuBERT's mlp_impl "auto" takes the fused MLP on the card and the
    # plain erf-GELU MLP on the CPU: the reference takes the fused MLP's
    # fp32 twin, so both sides compute the same function.
    cfg = dataclasses.replace(card.cfg, compute_dtype="float32", hubert=dataclasses.replace(
        card.cfg.hubert, mlp_impl="fused"))
    ref = TriadModel(cfg, device="cpu")
    ref.load_state_dict({k: p.detach().cpu() for k, p in model.state_dict().items()})
    factory = StepFactory(loss_cfg or perf_train_loss_config(), OptimConfig())

    def loss_and_grads(m, device):
        for name, p in m.named_parameters():
            p.requires_grad_(label_for_path(name) in groups)
            p.grad = None
        on = [None if b is None else {k: v.to(device) for k, v in b.items()}
              for b in (av_batch, tv_batch)]
        gen = torch.Generator(device=device).manual_seed(0) if train else None
        total, _ = factory.compute_losses(m, *on, gen, train=train,
                                          seeds=HostSeeds(0, 0) if train else None)
        total.backward()
        grads = {g: {} for g in groups}
        for name, p in m.named_parameters():
            if p.grad is not None:
                grads[label_for_path(name)][name] = p.grad.detach().double().cpu().ravel()
        return float(total.detach()), grads

    def cosine(a, b):
        return float(a @ b / (a.norm() * b.norm()))

    loss, by_name = loss_and_grads(card, "cuda")
    ref_loss, ref_by_name = loss_and_grads(ref, "cpu")
    rel = abs(loss - ref_loss) / abs(ref_loss)
    print(f"  loss bf16 card {loss:.6f} vs fp32 CPU {ref_loss:.6f} (rel {rel:.3g}, bound 5e-2)",
          flush=True)
    if factory.loss_cfg.implementation == "pallas":
        maxmean_witness(card, ref, av_batch, tv_batch, factory.loss_cfg, train)
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
        if hold_groups and not cos > 0.99:
            fail(f"{g} gradients disagree with the fp32 CPU reference")


def maxmean_witness(card, ref, av_batch, tv_batch, loss_cfg, train):
    """Tells the max-mean kernels' share of a card-vs-CPU gap from the
    features' precision. The AV and TV losses' gradients w.r.t. their
    input features and T, at the features this reference step feeds them:
    (1) on the card through the kernels against the twins on the CPU fed
    the same bf16 features: they must agree (cosine > 0.9999; a kernel
    that routed to another key than the first argmax would miss); (2) the
    twins on the card's bf16 features against the twins on the CPU's fp32
    features: the routes that precision alone moves (share of rows whose
    first argmax differs), which no kernel causes."""
    from triad_tpu_torch.ops import maxmean as MM
    from triad_tpu_torch.ops.dropout import HostSeeds
    from triad_tpu_torch.ops.losses import av_loss, tv_loss

    def features(m, device):
        av, tv = ({k: v.to(device) for k, v in b.items()} for b in (av_batch, tv_batch))
        gen = torch.Generator(device=device).manual_seed(0) if train else None
        seeds = HostSeeds(0, 0) if train else None
        with torch.no_grad():  # the order of compute_losses' draws
            visual_av = m.encode_visual(av["images"], train, gen)
            audio = m.encode_audio(av["audio"], train, gen, seeds)
            visual_tv = m.encode_visual(tv["images"], train, gen)
            text = m.encode_text(tv["token_ids"], tv["text_mask"], train, gen, seeds)
        temp = m.temperature.detach()
        return {"AV": (audio, visual_av, temp, None), "TV": (text, visual_tv, temp,
                                                              tv["text_mask"])}

    def grads(q, k, temp, mask):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, temp)]
        out = av_loss(*xs, loss_cfg) if mask is None else tv_loss(xs[0], xs[1], mask, xs[2],
                                                                   loss_cfg)
        out.total.backward()
        return [x.grad.double().cpu().ravel() for x in xs]

    def routes(q, k, temp, mask, clamp_min):
        coeff = MM.coefficients(q.shape[0], q.shape[1], mask, q.device)
        return MM.maxmean_fwd(q, k.to(q.dtype), temp, coeff, clamp_min)[3].cpu()

    def cosine(a, b):
        return float(a @ b / (a.norm() * b.norm()))

    on_card, on_cpu = features(card, card.temperature.device), features(ref, "cpu")
    for name, clamp_min in (("AV", loss_cfg.av_nonneg_clamp_min),
                            ("TV", loss_cfg.tv_nonneg_clamp_min)):
        card_in = on_card[name]
        same_in = tuple(None if x is None else x.cpu() for x in card_in)
        kernel, twin, fp32 = grads(*card_in), grads(*same_in), grads(*on_cpu[name])
        r_kernel, r_twin, r_fp32 = (routes(*x, clamp_min) for x in (card_in, same_in,
                                                                    on_cpu[name]))
        same = [cosine(a, b) for a, b in zip(kernel[:2], twin[:2])]
        prec = [cosine(a, b) for a, b in zip(twin[:2], fp32[:2])]
        dt = [abs(float(a[0] - b[0])) / max(abs(float(b[0])), 1e-30)
              for a, b in ((kernel[2], twin[2]), (twin[2], fp32[2]))]
        print(f"  max-mean witness {name}: kernels vs twins on the card's bf16 features: first "
              f"argmax equal in {100 * float((r_kernel == r_twin).float().mean()):.4f}% of "
              f"{r_kernel.numel()} rows, feature-gradient cosines q {same[0]:.7f} k "
              f"{same[1]:.7f}, dT rel {dt[0]:.3g}; twins on bf16 (card) vs fp32 (CPU) features: "
              f"first argmax equal in {100 * float((r_twin == r_fp32).float().mean()):.4f}%, "
              f"cosines q {prec[0]:.6f} k {prec[1]:.6f}, dT rel {dt[1]:.3g}", flush=True)
        if not min(same) > 0.9999:
            fail(f"the max-mean kernels' {name} gradients miss the twins' on the same features")


class SyntheticAV:
    """A duck-typed AV dataset for embed_av_subset (as
    scripts/tpu_retrieval_time.py's): random 224^2 pixels and waveforms of
    4-10 s at 16 kHz, so the audio masks of the 10 s batches cut."""

    def __init__(self, n, seed=0):
        self.n, self.seed = n, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i, apply_augmentation=True):
        rng = np.random.default_rng(self.seed + i)
        t = int(rng.integers(4 * 16000, 10 * 16000))
        return {"video_frames": rng.standard_normal((224, 224, 3), dtype=np.float32),
                "audio": rng.standard_normal(t, dtype=np.float32) * 0.1}


class SyntheticTV:
    """Random 224^2 pixels and captions of 3 to 127 words of 64 (up to the
    128 text tokens of the eval)."""

    WORDS = [f"word{k}" for k in range(64)]

    def __init__(self, n, seed=1):
        self.n, self.seed = n, seed

    def __len__(self):
        return self.n

    def caption(self, i):
        rng = np.random.default_rng(self.seed * 7919 + i)
        return " ".join(self.WORDS[j] for j in rng.integers(0, 64, size=int(rng.integers(3, 128))))

    def __getitem__(self, i, apply_augmentation=True):
        rng = np.random.default_rng(self.seed + i)
        return rng.standard_normal((224, 224, 3), dtype=np.float32), self.caption(i)


def retrieval_model_config(frontend_impl="pallas"):
    """perf_eval_model_config() with the head-pair attention in all three
    encoders and HuBERT's frontend on ``frontend_impl``."""
    from triad_tpu_torch.config import perf_eval_model_config

    cfg = perf_eval_model_config()
    return dataclasses.replace(
        cfg,
        hubert=dataclasses.replace(cfg.hubert, attention_impl="packed_pair",
                                   frontend_impl=frontend_impl),
        vit=dataclasses.replace(cfg.vit, attention_impl="packed_merged_pair"),
        text=dataclasses.replace(cfg.text, attention_impl="packed_pair"))


def _token_cosines(got, want):
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    return float(cos.min())


def retrieval_phase(n):
    """The 1000-way retrieval eval on the card: the entry point
    eval_1000_way_retrieval with the launch counts zeroed just before it,
    then the same eval leg by leg on its persisted subsets, timed on the
    host clock (every item embedded at batch 8, its data made on the host
    included; every direction scored), whose recalls must equal the entry
    point's. Then the "conv_act" frontend on the same weights (its AV leg
    through the entry point, counted), the two frontends against each
    other, 8 items against fp32 on the CPU, and score_matrix against the
    CPU's."""
    import random
    import tempfile

    from triad_tpu_torch import kernels
    from triad_tpu_torch.config import Config
    from triad_tpu_torch.data.audio import pad_or_trim
    from triad_tpu_torch.data.tokenizer import WordPieceTokenizer
    from triad_tpu_torch.eval import retrieval as R
    from triad_tpu_torch.models.hubert import normalize_waveform
    from triad_tpu_torch.models.multimodal import TriadModel

    model_cfg = retrieval_model_config()
    model = _initial_model(model_cfg, 5)
    cfg = Config(model=model_cfg)
    av, tv = SyntheticAV(n), SyntheticTV(n)
    tok = WordPieceTokenizer.build_from_corpus(tv.caption(i) for i in range(256))
    samples, text_len = cfg.data.audio_num_samples, cfg.data.max_text_tokens
    temp = float(model.temperature.detach())

    def encoders(m, device):
        @torch.inference_mode()
        def enc_av(images, audio):
            return m.encode_audio(audio.to(device)), m.encode_visual(images.to(device))

        @torch.inference_mode()
        def enc_tv(images, ids, mask):
            return m.encode_text(ids.to(device), mask.to(device)), m.encode_visual(
                images.to(device))
        return enc_av, enc_tv

    enc_av, enc_tv = encoders(model, "cuda")
    timings = {}
    random.seed(0)  # the persisted subset's shuffle
    with tempfile.TemporaryDirectory() as out_dir:
        kernels.reset_launches()
        t0 = time.perf_counter()
        metrics = R.eval_1000_way_retrieval(model, av, tv, tok, cfg, out_dir)
        torch.cuda.synchronize()
        timings["eval_1000_way_retrieval_s"] = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        with open(os.path.join(out_dir, "retrieval_subset_av.json")) as f:
            idx_av = json.load(f)
        with open(os.path.join(out_dir, "retrieval_subset_tv.json")) as f:
            idx_tv = json.load(f)
    print(f"  eval_1000_way_retrieval: {json.dumps(metrics)} in "
          f"{timings['eval_1000_way_retrieval_s']:.3f} s", flush=True)
    print(f"  launches during it: {launches}", flush=True)
    _check_launches(launches, RETRIEVAL_KERNELS, "retrieval")
    for name in ("attention_eval", "attention_eval_merged", "frontend_stats", "frontend_conv0",
                 "frontend_conv", "frontend_activation"):
        if launches[name]:
            fail(f"the retrieval path launched {name}, which its configuration does not run")
    if not (len(metrics) == 16 and all(0.0 <= x <= 1.0 for x in metrics.values())):
        fail(f"retrieval metrics {metrics}: not R@1/5/10/20 of four directions in [0, 1]")

    # The same eval leg by leg on the persisted subsets, timed: every item
    # embedded at batch 8, every direction scored; the recalls must equal
    # the entry point's (the kernels add in a fixed order).
    t0 = time.perf_counter()
    a, am, v = R.embed_av_subset(enc_av, av, idx_av, samples,
                                 num_tokens_fn=model_cfg.hubert.num_audio_tokens)
    timings["embed_av_ms_per_batch"] = (time.perf_counter() - t0) * 1e3 / -(-n // 8)
    t0 = time.perf_counter()
    t, tm, vt = R.embed_tv_subset(enc_tv, tv, idx_tv, tok, text_len)
    timings["embed_tv_ms_per_batch"] = (time.perf_counter() - t0) * 1e3 / -(-n // 8)
    print(f"  embedded {n} AV items: audio {a.shape}, {int(am.sum())} of {am.size} frames real; "
          f"{n} TV items: text {t.shape}, {int(tm.sum())} of {tm.size} tokens real", flush=True)
    legs = {}
    v_mask, vt_mask = np.ones(v.shape[:2], np.float32), np.ones(vt.shape[:2], np.float32)
    directions = (("A->V", (a, am, v, v_mask)), ("V->A", (v, v_mask, a, am)),
                  ("T->V", (t, tm, vt, vt_mask)), ("V->T", (vt, vt_mask, t, tm)))
    for name, (q, qm, k, km) in directions:
        t0 = time.perf_counter()
        sims = R.score_matrix(q, qm, k, km, temp)
        timings[f"score_{name}_ms"] = (time.perf_counter() - t0) * 1e3
        if not (sims.shape == (n, n) and np.isfinite(sims).all()):
            fail(f"retrieval {name}: scores of shape {sims.shape}, not all finite")
        legs.update({f"{name}_r{k[1:]}": x for k, x in R.compute_recall_at_k(sims).items()})
    print(f"  legs: {json.dumps(timings)}", flush=True)
    if metrics != legs:
        fail(f"eval_1000_way_retrieval's metrics {metrics} differ from its legs' {legs}")

    # The "conv_act" frontend on the same weights: its AV leg through the
    # entry point, counted; the two frontends' features on one batch.
    act_model = TriadModel(retrieval_model_config("conv_act"), device="cuda")
    act_model.load_state_dict(model.state_dict())
    act_model.eval()
    with tempfile.TemporaryDirectory() as out_dir:
        kernels.reset_launches()
        act_metrics = R.eval_1000_way_retrieval(act_model, av, None, tok, cfg, out_dir)
        torch.cuda.synchronize()
        act_launches = dict(kernels.LAUNCHES)
    print(f"  conv_act frontend, AV leg: {json.dumps(act_metrics)}", flush=True)
    print(f"  launches during it: {act_launches}", flush=True)
    _check_launches(act_launches, CONV_ACT_KERNELS, "conv_act retrieval")
    if act_launches["fused_frontend_conv"]:
        fail("the conv_act frontend launched the fused frontend conv")
    audio = torch.from_numpy(np.stack([pad_or_trim(av[i]["audio"], samples)
                                       for i in idx_av[:8]])).cuda()
    with torch.inference_mode():
        wave = normalize_waveform(audio)
        f_pallas = model.audio_backbone.feature_extractor(wave)
        f_act = act_model.audio_backbone.feature_extractor(wave)
    err, mx = max_err(f_pallas, f_act)
    print(f"  frontends pallas vs conv_act at {tuple(f_pallas.shape)}: max abs difference "
          f"{err:.4g} (bound 4 bf16 ulps of {mx:.4g}: six bf16 conv layers, sums in another "
          f"order)", flush=True)
    if not err <= 4 * BF16_ULP * mx:
        fail("the pallas and conv_act frontends disagree")
    del act_model

    # 8 items in fp32 on the CPU (plain twins there) against the card.
    ref = TriadModel(dataclasses.replace(model_cfg, compute_dtype="float32"), device="cpu")
    ref.load_state_dict({k: p.cpu() for k, p in model.state_dict().items()})
    ref.eval()
    ref_av, ref_tv = encoders(ref, "cpu")
    ra, _, rv = R.embed_av_subset(ref_av, av, idx_av[:8], samples,
                                  num_tokens_fn=model_cfg.hubert.num_audio_tokens)
    rt, _, rvt = R.embed_tv_subset(ref_tv, tv, idx_tv[:8], tok, text_len)
    for name, got, want in (("audio", a[:8], ra), ("visual (AV)", v[:8], rv),
                            ("text", t[:8], rt), ("visual (TV)", vt[:8], rvt)):
        cos = _token_cosines(got, want)
        print(f"  {name:11s} vs fp32 CPU: min token cosine {cos:.5f}", flush=True)
        if not cos > 0.99:
            fail(f"retrieval {name} embeddings disagree with the fp32 CPU reference")
    del ref

    # score_matrix on the card's own embeddings against the CPU's: 40 items
    # (padded to 48 by the 8 x 16 blocks), both sides' masks.
    m = 40
    for name, (q, qm, k, km) in directions:
        args = (q[:m], qm[:m], k[:m], km[:m], temp)
        got, want = R.score_matrix(*args), R.score_matrix(*args, device="cpu")
        diff, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        print(f"  score_matrix {name} card vs CPU ({m} items): max abs difference {diff:.4g} "
              f"(bound 1e-4 of {scale:.4g})", flush=True)
        if not diff <= 1e-4 * scale:
            fail(f"score_matrix {name} on the card disagrees with the CPU's")
    timings["frontends_max_abs_diff"] = err
    return {"metrics": metrics, "conv_act_metrics": act_metrics, **timings}, launches, \
        act_launches


def flash_eval_phase():
    """perf_eval_model_config() with "flash" in all three encoders, served
    over HTTP at B = 8: 10 s clips, 224^2 images and 128-token captions
    (every other one padded to 96). Each request is counted from zero:
    flash_attention must launch once per layer of its encoder (HuBERT and
    the ViT 12, DistilBERT 6) and no eval attention kernel at all. Then
    each encode call is timed on the card (CUDA events, median of 3 after
    one warm-up), in turns with the same weights on perf_eval_model_config()'s
    own impls, and one clip, one image and the 8 captions are held against
    fp32 on the CPU (reference_phase). Returns the timings and the launch
    counts of the three requests together."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.cli.serve import load_config
    from triad_tpu_torch.serve.model import ServingModel
    from triad_tpu_torch.serve.server import make_server

    base = load_config("perf_eval")
    cfg = dataclasses.replace(base, **{
        sec: dataclasses.replace(getattr(base, sec), attention_impl="flash")
        for sec in ("vit", "hubert", "text")})
    serving = ServingModel(cfg, None, "cuda", AUDIO, 128)
    rng = np.random.default_rng(21)
    audio = (rng.standard_normal((B, AUDIO)) * 0.1).astype(np.float32)
    images = rng.standard_normal((B, 224, 224, 3)).astype(np.float32)
    ids = rng.integers(1, 30_000, size=(B, 128)).astype(np.int32)
    mask = np.ones((B, 128), np.float32)
    mask[1::2, 96:] = 0.0
    srv = make_server(serving, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    total = {name: 0 for name in kernels.LAUNCHES}
    out = {}
    try:
        for name, route, body, ctype, shape, layers in (
                ("audio", "/v1/embed/audio", _npy(audio), "application/x-npy", (B, 499, 512),
                 cfg.hubert.num_layers),
                ("image", "/v1/embed/image", _npy(images), "application/x-npy", (B, 256, 512),
                 cfg.vit.num_layers),
                ("text", "/v1/embed/text", json.dumps({"ids": ids.tolist(),
                                                       "mask": mask.tolist()}).encode(),
                 "application/json", (B, 128, 512), cfg.text.num_layers)):
            kernels.reset_launches()
            got = _post(url + route, body, ctype)
            launches = dict(kernels.LAUNCHES)
            out[name] = check(f"flash embed/{name}", got["tokens"] if name == "text" else got,
                              shape)
            used = {k: n for k, n in launches.items() if n}
            print(f"  launches during the {name} request: {used}", flush=True)
            if launches["flash_attention"] != layers:
                fail(f"{name}: flash_attention launched {launches['flash_attention']} times, "
                     f"not once per layer ({layers})")
            if any(launches[k] for k in EVAL_ATTENTION):
                fail(f"{name}: an eval attention kernel ran on the flash path")
            total = {k: total[k] + launches[k] for k in total}
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    # The same weights on perf_eval_model_config()'s own impls (the eval
    # attention kernels in HuBERT and the ViT, the plain attention in
    # DistilBERT), timed in turns with the flash model.
    from triad_tpu_torch.models.multimodal import TriadModel

    packed = TriadModel(base, device="cuda")
    packed.load_state_dict(serving.model.state_dict())
    packed.eval()
    inputs = {"audio": (torch.from_numpy(audio).cuda(),),
              "visual": (torch.from_numpy(images).cuda(),),
              "text": (torch.from_numpy(ids).long().cuda(), torch.from_numpy(mask).cuda())}
    timings = {}
    with torch.inference_mode():
        for name, args in inputs.items():
            fns = [getattr(m, f"encode_{name}") for m in (serving.model, packed)]
            ms = {0: [], 1: []}
            for i in range(4):
                for j, fn in enumerate(fns):
                    t = _step_ms(lambda: fn(*args))[1]
                    if i:
                        ms[j].append(t)
            timings[f"encode_{name}_ms"] = statistics.median(ms[0])
            timings[f"encode_{name}_ms_perf_eval_impls"] = statistics.median(ms[1])
    del packed
    print("  encode ms at B = 8 (median of 3 after one warm-up, flash and perf_eval's "
          "impls in turns): " + "  ".join(f"{k} {v:.4f}" for k, v in timings.items()),
          flush=True)
    reference_phase(serving, audio, images, ids, mask, out["audio"], out["image"], out["text"])
    return timings, total


def long_clip_phase():
    """HuBERT past the old 512-key cap: a ServingModel of
    perf_eval_model_config() with 20 s clips (N = 999 tokens) embeds the
    same 8 clips three times, with HuBERT's attention on its serving impl
    ("packed": the eval attention kernel), on "packed_pair" (its head-pair
    mode) and on "flash", the same weights each time, counts zeroed before
    each; each of the first two is held against flash at a minimum token
    cosine above 0.999 (two bf16 attention kernels with other roundings
    of the probabilities under the same bf16 model). Returns the launch
    counts of the three runs together."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.cli.serve import load_config
    from triad_tpu_torch.serve.model import ServingModel

    clip = 2 * AUDIO
    base = load_config("perf_eval")
    rng = np.random.default_rng(31)
    audio = (rng.standard_normal((B, clip)) * 0.1).astype(np.float32)
    weights, tokens = None, {}
    total = {name: 0 for name in kernels.LAUNCHES}
    impls = (base.hubert.attention_impl, "packed_pair", "flash")
    for impl in impls:
        cfg = dataclasses.replace(base, hubert=dataclasses.replace(base.hubert,
                                                                   attention_impl=impl))
        serving = ServingModel(cfg, weights, "cuda", clip, 128)
        if weights is None:
            weights = serving.model.state_dict()
        kernels.reset_launches()
        got = serving.embed_audio(audio)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        tokens[impl] = check(f"embed/audio 20 s on {impl}", got, (B, 999, 512))
        print(f"  {impl}: launches {({k: n for k, n in launches.items() if n})}", flush=True)
        total = {k: total[k] + launches[k] for k in total}
        want = "flash_attention" if impl == "flash" else (
            "attention_eval_pair" if impl == "packed_pair" else "attention_eval")
        if launches[want] != cfg.hubert.num_layers:
            fail(f"HuBERT on {impl}: {want} launched {launches[want]} times, not once per "
                 f"layer ({cfg.hubert.num_layers})")
        del serving
    for impl in impls[:2]:
        cos = _token_cosines(tokens[impl], tokens["flash"])
        print(f"  {impl} vs flash at (8, 999, 512): min token cosine {cos:.6f}", flush=True)
        if not cos > 0.999:
            fail(f"HuBERT on {impl} disagrees with flash on 20 s clips")
    return total


DATA_CLIPS = 96  # clips per TriadPack shard: two shards, three B = 64 batches an epoch
DATA_SEED = 21  # the loaders' seed: every draw keyed on (seed, epoch, batch, idx)
RESUME_AFTER = 4  # fed steps before the copy: the copy resumes at epoch 1, batch 1
AUG_TOL = 1e-4  # device vs host augmentation, abs (normalized pixels lie within about 2.7)


def _write_data(root, shards=2, clips=DATA_CLIPS, seed=3):
    """Everything phase 16 reads, written from seeds under ``root``:
    ``shards`` TriadPack shards of ``clips`` clips each (224^2 frames,
    AUDIO int16 samples) packed by the port from its SyntheticAVDataset
    (seed ``seed``), and a caption folder (two subfolders) of shards *
    clips JPEGs with their captions (seeds ``seed`` + 1 and + 2). The
    card has PIL, so the TV source is JPEGs."""
    from PIL import Image

    from triad_tpu_torch.data.datasets import SyntheticAVDataset, SyntheticTVDataset
    from triad_tpu_torch.data.packed import pack_dataset

    av_dir, tv_dir = os.path.join(root, "av"), os.path.join(root, "tv")
    os.makedirs(av_dir)
    src = SyntheticAVDataset(size=shards * clips, image_size=224, audio_seconds=AUDIO / 16_000,
                             seed=seed)
    for s in range(shards):
        pack_dataset(src, os.path.join(av_dir, f"shard{s}.tpack"), 224, AUDIO,
                     range(s * clips, (s + 1) * clips))
    captions = SyntheticTVDataset(shards * clips, 224, seed=seed + 1).captions()
    rng = np.random.default_rng(seed + 2)
    for i, caption in enumerate(captions):
        part = os.path.join(tv_dir, f"part{i % 2}")
        os.makedirs(part, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (224, 224, 3), np.uint8)).save(
            os.path.join(part, f"{i:04d}.jpg"), quality=90)
        with open(os.path.join(part, f"{i:04d}.txt"), "w") as f:
            f.write(caption + "\n")
    return av_dir, tv_dir, captions


def _data_loaders(av_dir, tv_dir, tokenizer, device_augment=True):
    """AVLoader over the shards and TVLoader over the caption folder, with
    DataConfig's workers (4, thread mode), B = TRAIN_B and TRAIN_TXT
    tokens (phase 8's text length)."""
    from triad_tpu_torch.config import DataConfig
    from triad_tpu_torch.data.datasets import LocalCaptionDataset
    from triad_tpu_torch.data.packed import PackedAVDataset
    from triad_tpu_torch.data.pipeline import AVLoader, TVLoader

    dc = DataConfig()
    av = AVLoader(PackedAVDataset(av_dir), TRAIN_B, AUDIO, seed=DATA_SEED,
                  num_workers=dc.num_workers, worker_mode=dc.worker_mode,
                  device_augment=device_augment)
    tv = TVLoader(LocalCaptionDataset(tv_dir, 224), tokenizer, TRAIN_B,
                  max_text_tokens=TRAIN_TXT, seed=DATA_SEED, num_workers=dc.num_workers,
                  worker_mode=dc.worker_mode, device_augment=device_augment)
    if av.device_augment != device_augment or tv.device_augment != device_augment:
        fail("a loader did not take the device augmentation it was asked for")
    if len(av) != 2 * DATA_CLIPS // TRAIN_B or len(tv) != len(av):
        fail(f"loaders of {len(av)} and {len(tv)} batches an epoch")
    return av, tv


def _prefetchers(av, tv, start_epoch=0, start_batch=0):
    """The two pinned-memory prefetchers on the card, each running its
    device ingest (augmentation) on its side stream."""
    from triad_tpu_torch.config import DataConfig
    from triad_tpu_torch.data.device_aug import device_ingest_av, device_ingest_tv
    from triad_tpu_torch.data.pipeline import Prefetcher, cycling

    prefetch = DataConfig().prefetch
    return (Prefetcher(cycling(av.epoch, start_epoch, start_batch), prefetch, device_ingest_av),
            Prefetcher(cycling(tv.epoch, start_epoch, start_batch), prefetch, device_ingest_tv))


def _loader_ms(loader):
    """Host ms per batch of a loader alone (the median over one epoch)
    and the batches."""
    times, batches = [], []
    it = loader.epoch(0)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        times.append((time.perf_counter() - t0) * 1e3)
        batches.append(batch)
    loader.pool.close()
    return statistics.median(times), batches


def _h2d_ms(batch):
    """Host-to-device ms of a batch's arrays (median of 20, CUDA events):
    from pinned memory (non-blocking) and from pageable memory; and its
    bytes."""
    host = [torch.from_numpy(v) for v in batch.values() if isinstance(v, np.ndarray)]
    pinned = [t.pin_memory() for t in host]
    ms = time_fns([lambda: [t.to("cuda", non_blocking=True) for t in pinned],
                   lambda: [t.to("cuda") for t in host]])
    return ms[0], ms[1], sum(t.numel() * t.element_size() for t in host)


def _fed_steps(step, state, av_pf, tv_pf, n, first, warmup=0):
    """n joint steps, each fed by one batch of each prefetcher; returns
    each step's losses, its ms (CUDA events, the next() calls included)
    and the host ms it spent blocked in next()."""
    losses, step_ms, blocked = [], [], []
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        av, tv = next(av_pf), next(tv_pf)
        blocked.append((time.perf_counter() - t0) * 1e3)
        state, m = step(state, av, tv, 0.5, 0.5)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append((float(m["loss_av"]), float(m["loss_tv"])))
        print(f"  fed step {first + i} ({'warm-up' if i < warmup else 'timed'}): loss_av "
              f"{losses[-1][0]:.6f}  loss_tv {losses[-1][1]:.6f}  {step_ms[-1]:.3f} ms, "
              f"{blocked[-1]:.3f} ms blocked in next()", flush=True)
        if not all(np.isfinite(losses[-1])):
            fail(f"fed step {first + i}: losses {losses[-1]}")
    return losses, step_ms, blocked


def data_phase(resident_ms):
    """Phase 16: the full-width joint step (phase 8's: perf_train_model_config,
    every group unfrozen, B = TRAIN_B) fed from files on disk through the
    port's loaders, two pinned-memory Prefetchers and the device
    augmentation; the loaders, copies and augmentation timed on their own;
    the device augmentation held to the host path on the same draws; and
    an exact mid-epoch resume. Returns the phase's summary and the launch
    counts of the fed steps."""
    import shutil
    import tempfile

    from triad_tpu_torch import kernels
    from triad_tpu_torch.config import OptimConfig, perf_train_loss_config
    from triad_tpu_torch.data import native
    from triad_tpu_torch.data.device_aug import (device_augment_av, device_augment_tv,
                                                 device_ingest_av, device_ingest_tv)
    from triad_tpu_torch.data.images import apply_av_batch, draw_av_params
    from triad_tpu_torch.data.tokenizer import WordPieceTokenizer
    from triad_tpu_torch.train.checkpoint import load_payload, state_payload
    from triad_tpu_torch.train.step import StepFactory

    out = {"tv_source": "jpeg captions (LocalCaptionDataset.raw_item)"}
    print(f"  TV source: {out['tv_source']}", flush=True)
    if not native.available():
        fail(f"the native data library did not load: {native.load_error}")
    out["native"] = {"loaded": True, "avcodec": native.avdec_supported()}
    print(f"  native library {os.path.relpath(native.library_path(), ROOT)} loaded "
          f"(libavcodec {'linked' if out['native']['avcodec'] else 'absent'})", flush=True)
    tone = np.sin(np.arange(48_000, dtype=np.float32) * (2 * np.pi * 440 / 48_000))
    fed = native.resample(tone, 48_000, 16_000)
    if fed.shape != (16_000,) or abs(float(np.abs(fed[100:-100]).max()) - 1) > 0.05:
        fail(f"native resample of a 440 Hz tone: {fed.shape}, peak {np.abs(fed).max()}")

    root = tempfile.mkdtemp(prefix="triad_data_")
    try:
        t0 = time.perf_counter()
        av_dir, tv_dir, captions = _write_data(root)
        sizes = {d: sum(os.path.getsize(os.path.join(p, f)) for p, _, fs in os.walk(d)
                        for f in fs) for d in (av_dir, tv_dir)}
        print(f"  wrote 2 TriadPack shards ({sizes[av_dir]} bytes) and "
              f"{len(captions)} JPEG captions ({sizes[tv_dir]} bytes) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        tokenizer = WordPieceTokenizer.build_from_corpus(captions)

        # The loaders alone, host clock: the raw (device-augment) form and
        # the host-augmented one, one epoch each.
        loader_ms, raw, host = {}, {}, {}
        for augment_on_device in (True, False):
            av, tv = _data_loaders(av_dir, tv_dir, tokenizer, augment_on_device)
            form = "raw" if augment_on_device else "host_aug"
            loader_ms[f"av_{form}"], batches = _loader_ms(av)
            (raw if augment_on_device else host)["av"] = batches[0]
            loader_ms[f"tv_{form}"], batches = _loader_ms(tv)
            (raw if augment_on_device else host)["tv"] = batches[0]
        t0 = time.perf_counter()
        apply_av_batch(raw["av"]["frames_u8"].astype(np.float32) / 255.0,
                       [draw_av_params(np.random.default_rng(i)) for i in range(TRAIN_B)])
        loader_ms["apply_av_batch"] = (time.perf_counter() - t0) * 1e3
        out["loader_host_ms"] = loader_ms
        print("  host ms per B = 64 batch, loaders alone: " + ", ".join(
            f"{k} {v:.1f}" for k, v in loader_ms.items()), flush=True)

        # Host-to-device copies of one batch each, pinned against pageable.
        h2d = {}
        for kind in ("av", "tv"):
            h2d[f"{kind}_pinned"], h2d[f"{kind}_pageable"], h2d[f"{kind}_bytes"] = _h2d_ms(
                raw[kind])
        out["h2d_ms"] = h2d
        print("  host-to-device ms per batch: " + ", ".join(
            f"{k} {v:.4f}" if "bytes" not in k else f"{k} {v}" for k, v in h2d.items()),
            flush=True)

        # The device augmentation against the host path on the same draws.
        errs, aug_ms = {}, {}
        for kind, ingest, augment in (("av", device_ingest_av, device_augment_av),
                                      ("tv", device_ingest_tv, device_augment_tv)):
            got = ingest({k: v for k, v in raw[kind].items()}, device="cuda")
            errs[kind] = float(np.abs(got["images"].cpu().numpy() - host[kind]["images"]).max())
            if errs[kind] > AUG_TOL:
                fail(f"device {kind} augmentation differs from the host path by {errs[kind]}")
            if kind == "av":
                if not np.array_equal(got["audio"].cpu().numpy(), host["av"]["audio"]):
                    fail("the device's audio conversion differs from the host path")
                args = [raw["av"][k] for k in ("frames_u8", "aug_flip", "aug_brightness",
                                               "aug_contrast", "aug_saturation")]
            else:
                if not np.array_equal(got["token_ids"].cpu().numpy(), host["tv"]["token_ids"]):
                    fail("the TV batches' token ids differ between the two forms")
                args = [raw["tv"][k] for k in ("frames_u8", "aug_flip", "aug_dx", "aug_dy",
                                               "aug_perm", "aug_factors")]
            args = [torch.from_numpy(a).cuda() for a in args]
            fn = lambda: augment(*args)  # noqa: E731
            sync = time_fns([fn])[0]
            aug_ms[kind] = {"ms": sync, "device_ms": device_ms(fn, sync)}
        out["aug_max_abs_err"], out["device_aug_ms"] = errs, aug_ms
        print(f"  device augmentation vs the host path (apply_av_batch / apply_tv_image, same "
              f"draws): max abs err av {errs['av']:.3g}, tv {errs['tv']:.3g} (tol {AUG_TOL}); "
              f"audio bit-equal; ms (sync / device) av {aug_ms['av']['ms']:.4f} / "
              f"{aug_ms['av']['device_ms']:.4f}, tv {aug_ms['tv']['ms']:.4f} / "
              f"{aug_ms['tv']['device_ms']:.4f}", flush=True)
        del raw, host

        # The fed joint steps: every group unfrozen, as phase 8.
        ocfg = _unfrozen(OptimConfig(gradient_accumulation_steps=1))
        step = StepFactory(perf_train_loss_config(), ocfg).make_step("joint")
        state = _new_state(ocfg, 1)
        before = {n: p.detach().clone() for n, p in state.model.named_parameters()
                  if n.startswith("audio_backbone")}
        av, tv = _data_loaders(av_dir, tv_dir, tokenizer)
        av_pf, tv_pf = _prefetchers(av, tv)
        kernels.reset_launches()
        _, ms1, blocked1 = _fed_steps(step, state, av_pf, tv_pf, RESUME_AFTER, 0, 2)
        saved = state_payload(state)  # what a checkpoint holds, on the host
        rest, ms2, blocked2 = _fed_steps(step, state, av_pf, tv_pf, 2, RESUME_AFTER)
        launches = dict(kernels.LAUNCHES)
        av_pf.close()
        tv_pf.close()
        av.pool.close()
        tv.pool.close()
        _check_launches(launches, JOINT_KERNELS, "fed joint")
        for name, p in state.model.named_parameters():
            if name in before and torch.equal(p, before[name]):
                fail(f"{name} did not move in the fed steps")
        print("  every HuBERT parameter moved", flush=True)
        timed_ms = (ms1 + ms2)[2:]
        out["fed_step_ms"] = statistics.median(timed_ms)
        out["fed_steps_ms"] = ms1 + ms2
        out["resident_step_ms"] = resident_ms
        out["blocked_ms_per_step"] = statistics.median((blocked1 + blocked2)[2:])
        out["blocked_ms_all"] = blocked1 + blocked2
        print(f"  median of {len(timed_ms)} timed fed steps {out['fed_step_ms']:.3f} ms "
              f"(phase 8's resident batches: {resident_ms}); blocked in next() "
              f"{out['blocked_ms_per_step']:.3f} ms a timed step (median)", flush=True)

        # Exact mid-epoch resume: the copy after RESUME_AFTER steps, fed by
        # a second pair of loaders from cycling(1, 1).
        final = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        del state, before
        torch.cuda.empty_cache()
        epoch, batch = divmod(RESUME_AFTER, len(av))
        resumed = load_payload(_new_state(ocfg, 99), saved)  # another init, then loaded
        av, tv = _data_loaders(av_dir, tv_dir, tokenizer)
        av_pf, tv_pf = _prefetchers(av, tv, epoch, batch)
        again, _, _ = _fed_steps(step, resumed, av_pf, tv_pf, 2, RESUME_AFTER)
        if again != rest:
            fail(f"resumed losses {again} differ from the uninterrupted run's {rest}")
        differ = [n for n, p in resumed.model.named_parameters() if not torch.equal(p, final[n])]
        if differ:
            fail(f"{len(differ)} parameter tensors differ after the resume, e.g. {differ[:3]}")
        out["resume"] = {"after_steps": RESUME_AFTER, "cursor": [epoch, batch],
                         "bit_equal": True}
        print(f"  resumed after step {RESUME_AFTER - 1} at cycling({epoch}, {batch}): the next 2 "
              "steps' losses and every parameter bit-equal to the uninterrupted run", flush=True)
        del final
        busy = profile_step(lambda: step(resumed, next(av_pf), next(tv_pf), 0.5, 0.5),
                            "fed_profile.txt")
        out["fed_profile"] = {"step_ms": busy[0], "kernel_ms": busy[1],
                              "busy_share": busy[1] / busy[0]}
        av_pf.close()
        tv_pf.close()
        av.pool.close()
        tv.pool.close()
        del resumed
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out, launches


TRAINER_VAL_CLIPS = 64  # clips of the validation AV root, images of its caption folder
TRAINER_STEPS = 3  # steps an epoch (--steps)
TRAINER_SAVES = [3, 6, 8, 9, 12]  # the epoch ends and save_every_steps 7's mid-epoch "step 8"
TRAINER_KILL = "Saved checkpoint at step 8"
TRAINER_PHASES = {0: ("av_focus", 1.0, 0.0), 1: ("tv_warmup", 0.0, 1.0),
                  2: ("weighted_joint", 0.8, 1.0 - 0.8), 3: ("full_joint", 1.0, 1.0)}


def _trainer_config(av_dir, tv_dir, val_av_dir, val_tv_dir):
    """Phase 17's config: perf_train_model_config() and
    perf_train_loss_config(), B = 64 for AV and TV, 10 s of audio, 32 text
    tokens, 4 thread workers, device augmentation; one epoch each of
    av_focus, tv_warmup, weighted_joint and full_joint; accumulation 3;
    audio unfrozen at micro step 2, text at 4, the ViT's LoRA at 0; a
    save every 7 steps (one inside an epoch and an accumulation window:
    "step 8", cursor (2, 2)) and at each epoch end (3, 6, 9, 12); viz
    every 5 steps, 2 samples of each kind; retrieval over 64 items;
    asynchronous saves."""
    from triad_tpu_torch.config import perf_train_loss_config, perf_train_model_config

    return {
        "model": dataclasses.asdict(perf_train_model_config()),
        "loss": dataclasses.asdict(perf_train_loss_config()),
        "data": {"audio_num_samples": AUDIO, "max_text_tokens": TRAIN_TXT,
                 "batch_size_av": TRAIN_B, "batch_size_tv": TRAIN_B, "num_workers": 4,
                 "worker_mode": "thread", "device_augment": True,
                 "audio_visual_data_root": av_dir, "text_dataset_path": tv_dir,
                 "audio_visual_val_data_root": val_av_dir, "text_dataset_val_path": val_tv_dir},
        "train": {"num_epochs": 4, "av_focus_epochs": 1, "tv_warmup_epochs": 1,
                  "weighted_joint_epochs": 1, "av_weight_start": 0.8, "av_weight_end": 0.5,
                  "vis_every": 5, "save_every_steps": 7, "validation_frequency": 10 ** 9,
                  "retrieval_subset_size": TRAINER_VAL_CLIPS, "num_vis_samples_av": 2,
                  "num_vis_samples_tv": 2, "async_checkpointing": True, "seed": 0,
                  "optim": {"gradient_accumulation_steps": 3, "unfreeze_audio_step": 2,
                            "unfreeze_text_step": 4, "unfreeze_vit_step": 0}},
    }


def _cli(module, *args):
    return [sys.executable, "-m", f"triad_tpu_torch.cli.{module}", *args]


def _run_metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _losses_by_step(lines):
    """The last logged train_loss of each global step."""
    return {int(m["global_step"]): m["train_loss"] for m in lines if "train_loss" in m}


def _last_retrieval(lines):
    last = [m for m in lines if any(k.startswith("retrieval_") for k in m)][-1]
    return {k[len("retrieval_"):]: v for k, v in last.items() if k.startswith("retrieval_")}


def _checkpoint(run_dir, step):
    d = os.path.join(run_dir, "checkpoints", "ckpts", str(step))
    with open(os.path.join(d, "meta.json")) as f:
        progress = json.load(f)["progress"]
    return torch.load(os.path.join(d, "state.pt"), map_location="cpu", weights_only=True), progress


def _tree_differences(a, b, path=""):
    """Paths where two checkpoint payloads differ in any bit."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return [] if a.dtype == b.dtype and torch.equal(a, b) else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return [f"{path} (keys)"]
        return [d for k in a for d in _tree_differences(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} (length)"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in
                _tree_differences(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


def _kill_after_commit(proc, run_dir, out_path):
    """Read run B's output until it says TRAINER_KILL, wait until that
    step's checkpoint is committed (its directory renamed into place),
    then SIGKILL the process. Returns the output and the committed steps
    at the kill."""
    import signal

    watchdog = threading.Timer(600, proc.kill)
    watchdog.start()
    lines, seen = [], False
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith(TRAINER_KILL):
                seen = True
                break
        committed = os.path.join(run_dir, "checkpoints", "ckpts", "8")
        deadline = time.monotonic() + 120
        while seen and not os.path.isdir(committed) and time.monotonic() < deadline:
            time.sleep(0.05)
        entries = sorted(os.listdir(os.path.dirname(committed))) if seen else []
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write("".join(lines))
    if not seen:
        fail(f"run B ended (rc {proc.returncode}) without '{TRAINER_KILL}': "
             f"{''.join(lines[-20:])}")
    return lines, entries


class _StartState:
    """While active, Trainer.train first keeps a CPU copy of the model's
    state (``state``) and the seconds since the context opened
    (``startup_s``): what a ``cli.train.main`` call built before its first
    step, and how long that took."""

    def __enter__(self):
        from triad_tpu_torch.train.trainer import Trainer

        self.orig, self.t0, self.state, self.startup_s = Trainer.train, time.perf_counter(), None, None
        box = self

        def train(trainer):
            box.startup_s = time.perf_counter() - box.t0
            box.state = {k: v.detach().to("cpu", copy=True)
                         for k, v in trainer.model.state_dict().items()}
            return box.orig(trainer)

        Trainer.train = train
        return self

    def __exit__(self, *exc):
        from triad_tpu_torch.train.trainer import Trainer

        Trainer.train = self.orig


def trainer_phase(root):
    """Phase 17: the port's Trainer on the card through its commands.
    Run A, ``cli.train.main`` in this process (launch counts zeroed just
    before): the full-width four-phase curriculum from TriadPack shards and
    a JPEG caption folder written from seeds under ``root`` (left there,
    with the config ``root``/trainer.json, for phase 18), validation,
    retrieval, viz and async checkpoints; run B, the same command in a
    subprocess with a fresh directory, SIGKILLed once its step-8 save has
    committed; run C, the same command again, resuming; C's final
    checkpoint held to A's bit for bit; ``cli.eval`` of A (the latest and
    --best), started beside runs B and C; then the eval legs' launch counts. Returns the summary and
    the launch counts of run A and of the eval legs."""
    import shutil

    from triad_tpu_torch import kernels
    from triad_tpu_torch.cli import train as train_cli
    from triad_tpu_torch.config import perf_train_model_config
    from triad_tpu_torch.train.checkpoint import CheckpointManager

    proc = None
    out = {}
    try:
        t0 = time.perf_counter()
        av_dir, tv_dir, _ = _write_data(os.path.join(root, "train"))
        val_av, val_tv, _ = _write_data(os.path.join(root, "val"), 1, TRAINER_VAL_CLIPS, 13)
        cfg_path = os.path.join(root, "trainer.json")
        with open(cfg_path, "w") as f:
            json.dump(_trainer_config(av_dir, tv_dir, val_av, val_tv), f)
        print(f"  wrote the training data (2 shards of {DATA_CLIPS} clips, "
              f"{2 * DATA_CLIPS} captions) and the validation data ({TRAINER_VAL_CLIPS} clips, "
              f"{TRAINER_VAL_CLIPS} captions) in {time.perf_counter() - t0:.1f} s", flush=True)
        args = ["--config", cfg_path, "--steps", str(TRAINER_STEPS)]
        run_a, run_b = os.path.join(root, "run_a"), os.path.join(root, "run_b")

        # -- run A ---------------------------------------------------------
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with _StartState() as start:
            trainer = train_cli.main(args + ["--output-dir", run_a, "--force-new"])
        out["run_a_s"] = time.perf_counter() - t0
        out["startup_s"] = start.startup_s
        del start
        launches = dict(kernels.LAUNCHES)
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        _check_launches(launches, JOINT_KERNELS, "trainer")
        lines_a = _run_metrics(run_a)
        train_lines = [m for m in lines_a if "train_loss" in m]
        for m in train_lines:
            if not np.isfinite(m["train_loss"]):
                fail(f"run A logged a non-finite train_loss: {m}")
            want = TRAINER_PHASES[m["epoch"]]
            if (m["training_phase"], m["av_weight"], m["tv_weight"]) != want:
                fail(f"epoch {m['epoch']} logged {m['training_phase']} {m['av_weight']} "
                     f"{m['tv_weight']}, not {want}")
        if sorted({m["epoch"] for m in train_lines}) != [0, 1, 2, 3]:
            fail(f"run A logged the epochs {sorted({m['epoch'] for m in train_lines})}")
        # The audio group's OneCycle spans total_updates - unfreeze_audio_step
        # = 2 updates (the reference counts the unfreeze step in micro
        # steps), so its lr falls from 2.5e-6 at its first update (micro
        # step 2) to 2.5e-10: a weight of 1.0 in a layer that LayerDrop
        # skipped at micro step 2 cannot move in fp32. So every HuBERT
        # parameter is held to a nonzero AdamW second moment (it took a
        # nonzero gradient), and the tensors that moved are counted.
        start = _initial_model(perf_train_model_config(), 0)
        audio_state = trainer.bank.opts["audio"].state
        moved = {"audio": 0, "text": 0}
        n_audio = 0
        for (name, p), (_, q) in zip(trainer.model.named_parameters(),
                                     start.named_parameters()):
            same = torch.equal(p, q)
            if name.startswith("audio_backbone"):
                n_audio += 1
                moved["audio"] += not same
                if p not in audio_state or not bool(audio_state[p]["exp_avg_sq"].any()):
                    fail(f"{name} took no gradient in run A")
            if name.startswith("text_backbone"):
                moved["text"] += not same
                if same:
                    fail(f"{name} did not move in run A")
            if name.startswith("visual_backbone") and "lora_" not in name and not same:
                fail(f"{name} (the frozen ViT base) changed in run A")
        del start
        out["moved"] = {"hubert": moved["audio"], "hubert_tensors": n_audio,
                        "distilbert": moved["text"]}
        print(f"  every HuBERT parameter tensor took a gradient ({moved['audio']} of {n_audio} "
              f"moved), every DistilBERT one ({moved['text']}) moved; the ViT base "
              "bit-unchanged", flush=True)
        for rel in ("metrics.jsonl", "viz/epoch_1/tv_0.png", "viz/epoch_3/av_0.png",
                    "viz/epoch_3/tv_0.png"):
            if not os.path.getsize(os.path.join(run_a, rel)):
                fail(f"run A did not write {rel}")
        video = os.path.join(run_a, "viz", "epoch_3", "av_0_attention.mp4")
        out["video"] = {"written": os.path.exists(video) and os.path.getsize(video) > 0,
                        "bytes": os.path.getsize(video) if os.path.exists(video) else 0,
                        "writer": trainer.video_writer}
        print(f"  viz PNGs written; av_0_attention.mp4 written: {out['video']['written']} "
              f"({out['video']['bytes']} bytes) by '{trainer.video_writer}'", flush=True)
        saves = [t["step"] for t in trainer.ckpt.timings]
        if saves != TRAINER_SAVES or trainer.ckpt.latest_step() != 12:
            fail(f"run A saved the steps {saves}, latest {trainer.ckpt.latest_step()}")
        if not os.path.exists(os.path.join(run_a, "checkpoints", "best", "state.pt")):
            fail("run A kept no best/ checkpoint")

        step_ms = {}
        for label, seconds in trainer.timer.history:
            step_ms.setdefault(label, []).append(seconds * 1e3)
        out["step_ms_by_phase"] = {k: statistics.median(v) for k, v in step_ms.items()}
        out["steps_timed_by_phase"] = {k: len(v) for k, v in step_ms.items()}
        out["step_time_ms_logged"] = {m["training_phase"]: m["step_time_ms"]
                                      for m in train_lines if "step_time_ms" in m}
        out["hooks_s"] = {k: v for k, v in trainer.timings.items() if v}
        out["async_saves_s"] = trainer.ckpt.timings
        print("  ms per step (CUDA events, median) by phase: " + ", ".join(
            f"{k} {v:.3f} ({out['steps_timed_by_phase'][k]} steps; logged step_time_ms "
            f"{out['step_time_ms_logged'].get(k, float('nan')):.3f})"
            for k, v in out["step_ms_by_phase"].items()), flush=True)
        print("  seconds: " + "; ".join(
            f"{k} " + ", ".join(f"{x:.3f}" for x in v) for k, v in out["hooks_s"].items()),
            flush=True)
        print("  async saves (s, blocking / write): " + ", ".join(
            f"step {t['step']} {t['block_s']:.3f} / {t['write_s']:.3f}"
            for t in trainer.ckpt.timings), flush=True)
        payload_bytes = os.path.getsize(os.path.join(run_a, "checkpoints", "ckpts", "12",
                                                     "state.pt"))
        sync = CheckpointManager(os.path.join(root, "sync_ckpt"))
        t0 = time.perf_counter()
        sync.save(12, trainer.state, trainer.progress, trainer.config.to_dict())
        out["sync_save_s"] = time.perf_counter() - t0
        shutil.rmtree(os.path.join(root, "sync_ckpt"))
        t0 = time.perf_counter()
        CheckpointManager(os.path.join(run_a, "checkpoints")).restore(trainer.state)
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"] = payload_bytes
        print(f"  checkpoint of step 12: {payload_bytes} bytes; a synchronous save "
              f"{out['sync_save_s']:.3f} s, a restore {out['restore_s']:.3f} s; peak device "
              f"memory {out['peak_bytes'] / 2 ** 30:.3f} GiB (max_memory_allocated); run A "
              f"{out['run_a_s']:.1f} s, {out['startup_s']:.2f} s of it to its first step (the "
              f"Trainer's start from a random init)", flush=True)
        torch.cuda.empty_cache()

        # -- cli.eval of run A: the latest checkpoint and --best, side by side,
        # and beside runs B and C (run A's files are final) ------------------
        evals, procs = {}, {}
        t_eval = time.perf_counter()
        for name, extra in (("latest", ()), ("best", ("--best",))):
            path = os.path.join(root, f"eval_{name}.json")
            log = open(os.path.join(root, f"eval_{name}.log"), "w+")  # read after run C
            procs[name] = (path, log, subprocess.Popen(
                _cli("eval", "--run-dir", run_a, "--out", path, *extra), cwd=ROOT,
                stdout=log, stderr=subprocess.STDOUT, text=True))
        try:
            # -- run B, killed; run C, resumed ------------------------------------
            env = dict(os.environ, PYTHONUNBUFFERED="1")
            t0 = time.perf_counter()
            proc = subprocess.Popen(_cli("train", *args, "--output-dir", run_b, "--force-new"),
                                    cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, env=env)
            _, entries = _kill_after_commit(proc, run_b, os.path.join(
                ROOT, "chiprun_out", "trainer_run_b.txt"))
            proc = None
            out["run_b_s"] = time.perf_counter() - t0
            print(f"  run B killed (SIGKILL) after '{TRAINER_KILL}' in {out['run_b_s']:.1f} s; "
                  f"checkpoint entries at the kill: {entries}", flush=True)
            t0 = time.perf_counter()
            c = subprocess.run(_cli("train", *args, "--output-dir", run_b), cwd=ROOT,
                               capture_output=True, text=True, env=env, timeout=600)
            out["run_c_s"] = time.perf_counter() - t0
            with open(os.path.join(ROOT, "chiprun_out", "trainer_run_c.txt"), "w") as f:
                f.write(c.stdout + c.stderr)
            if c.returncode != 0:
                fail(f"run C exited {c.returncode}: {c.stderr[-2000:]}")
            resumed = re.search(
                r"Resumed from step (\d+) \(epoch (\d+), batch (\d+)\) in ([\d.]+) s", c.stdout)
            if not resumed:
                fail("run C did not resume from a checkpoint")
            out["resumed"] = {"step": int(resumed.group(1)), "epoch": int(resumed.group(2)),
                              "batch": int(resumed.group(3)), "restore_s": float(resumed.group(4))}
            (pa, prog_a), (pc, prog_c) = _checkpoint(run_a, 12), _checkpoint(run_b, 12)
            differ = _tree_differences(pa, pc)
            if differ or prog_a != prog_c:
                fail(f"run C's final checkpoint differs from run A's: {differ[:5]} {prog_a} "
                     f"{prog_c}")
            got, want = _losses_by_step(_run_metrics(run_b)), _losses_by_step(lines_a)
            after = {s: v for s, v in got.items() if s >= out["resumed"]["step"]}
            if not after or any(want.get(s) != v for s, v in after.items()):
                fail(f"run C's train_loss after the resume {after} differs from run A's {want}")
            n_tensors = sum(1 for _ in _tensors(pa))
            out["resume_bit_equal"] = {"tensors": n_tensors, "losses_after_resume": after}
            print(f"  run C resumed from step {out['resumed']['step']} (epoch "
                  f"{out['resumed']['epoch']}, batch {out['resumed']['batch']}; restore "
                  f"{out['resumed']['restore_s']:.3f} s) and ended in {out['run_c_s']:.1f} s with "
                  f"all {n_tensors} tensors of its step-12 checkpoint (model, AdamW, .grads), the "
                  f"progress and the train_loss of steps {sorted(after)} bit-equal to run A's",
                  flush=True)

            for name, (path, log, p) in procs.items():
                p.wait(timeout=600)
                if p.returncode != 0:
                    log.seek(0)
                    fail(f"cli.eval ({name}) exited {p.returncode}: {log.read()[-2000:]}")
                with open(path) as f:
                    evals[name] = {"metrics": json.load(f), "s": time.perf_counter() - t_eval}
        finally:
            for _, log, p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        if evals["latest"]["metrics"] != _last_retrieval(lines_a):
            fail(f"cli.eval's metrics {evals['latest']['metrics']} differ from run A's last "
                 f"retrieval {_last_retrieval(lines_a)}")
        out["eval"] = evals
        print(f"  cli.eval of run A (the two commands side by side, beside runs B and C, "
              f"{max(e['s'] for e in evals.values()):.1f} s) equals run A's last retrieval "
              f"exactly: {evals['latest']['metrics']}; --best: {evals['best']['metrics']}",
              flush=True)

        # -- the eval legs alone: validation, retrieval, viz ----------------
        kernels.reset_launches()
        trainer.validate("full_joint")
        trainer.eval_1000_way_retrieval()
        trainer.visualize_samples(3)
        eval_launches = dict(kernels.LAUNCHES)
        for name in ("attention_train", "fused_mlp", "frontend_stats", "frontend_conv0",
                     "frontend_conv"):
            if eval_launches[name] <= 0:
                fail(f"kernel {name} was not launched by the trainer's eval legs")
        if any(eval_launches[n] for n in ("attention_train_bwd", "fused_mlp_bwd",
                                          "layernorm_bwd", "posconv_dx", "posconv_dw")):
            fail(f"a backward kernel ran in the eval legs: {eval_launches}")
        print(f"  the eval legs' launches (validation, retrieval, viz, counts zeroed): "
              f"{ {k: v for k, v in eval_launches.items() if v} }", flush=True)
        trainer.ckpt.close()
        del trainer
        torch.cuda.empty_cache()
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
    return out, launches, eval_launches


PRETRAINED_SEEDS = {"hubert": 31, "text": 32, "vit": 33, "reference": 34}
PRETRAINED_STEPS = 2  # steps an epoch of the run from the per-backbone files
PRETRAINED_SET = [  # over phase 17's config: av_focus, then full_joint; no viz
    "train.num_epochs=2", "train.av_focus_epochs=1", "train.tv_warmup_epochs=0",
    "train.weighted_joint_epochs=0", f"train.vis_every={10 ** 9}",
    f"train.save_every_steps={10 ** 9}", "train.optim.gradient_accumulation_steps=1",
    "train.optim.unfreeze_audio_step=0", "train.optim.unfreeze_text_step=0",
    "train.optim.unfreeze_vit_step=0"]
# Kernels the run directory's model (perf_train_model_config: the training
# attention's forward, posconv) launches in infer and viz, and those
# perf_eval_model_config's random init (the eval attention) launches in
# infer, bf16 and int8 alike
RUN_DIR_KERNELS = ("attention_train", "fused_mlp", "frontend_stats", "frontend_conv0",
                   "frontend_conv", "posconv")
RANDOM_INIT_KERNELS = ("attention_eval", "attention_eval_merged", "fused_mlp", "frontend_stats",
                       "frontend_conv0", "frontend_conv")
INT8_SHAPE = (8 * 499, 768, 3072)  # HuBERT's FFN-in product at B = 8, 10 s clips


def _cos_rows(a, b):
    a = np.asarray(a, np.float64).reshape(-1, a.shape[-1])
    b = np.asarray(b, np.float64).reshape(-1, b.shape[-1])
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _media(root):
    """A JPEG (256^2), an mp4 of ten 256^2 frames written by
    cv2.VideoWriter (mp4v) and muxed by data/mp4.py:mux_mp4 with 10 s of
    'sowt' PCM audio (a 440 Hz tone and noise), and a caption. The audio
    is read back through data/audio.py:extract_audio (which returns
    silence on any failure) and held to what was muxed."""
    import cv2
    from PIL import Image

    from triad_tpu_torch.data.audio import extract_audio
    from triad_tpu_torch.data.mp4 import mux_mp4

    rng = np.random.default_rng(41)
    jpg = os.path.join(root, "frame.jpg")
    Image.fromarray(rng.integers(0, 256, (256, 256, 3), np.uint8)).save(jpg, quality=90)
    silent, mp4 = os.path.join(root, "video_only.mp4"), os.path.join(root, "clip.mp4")
    writer = cv2.VideoWriter(silent, cv2.VideoWriter_fourcc(*"mp4v"), 1, (256, 256))
    for _ in range(10):
        writer.write(rng.integers(0, 256, (256, 256, 3), np.uint8))
    writer.release()
    t = np.arange(AUDIO) / 16_000
    audio = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(AUDIO)).astype(
        np.float32)
    mux_mp4(mp4, silent, audio, 16_000, audio_codec="sowt")
    back = extract_audio(mp4)
    if back.shape[0] < AUDIO or not np.allclose(back[:AUDIO], np.round(audio * 32767) / 32768,
                                                atol=2 / 32768):
        fail(f"the mp4's 'sowt' track did not read back ({back.shape[0]} samples)")
    return jpg, mp4, "a dog barking in a park"


def _weight_checks(cfg, trees):
    """Imported tensors against recomputes from the seeds: the ViT's fused
    qkv of block 5 and HuBERT's conv_3 kernel (transposes of the draws),
    the positional conv's weight against g v / |v| in float64 (relative
    1e-6), and the fresh LoRA factors against numpy default_rng draws
    (seed 0 for qkv, 1000 + i for proj; bit-equal)."""
    from triad_tpu_torch.tools.hf_layout import draw

    h, v = cfg.hubert, cfg.vit
    sh, sv = PRETRAINED_SEEDS["hubert"], PRETRAINED_SEEDS["vit"]
    a = "encoder.layer.5.attention.attention."
    want = np.concatenate([draw(sv, f"{a}{n}.weight", (v.hidden_size, v.hidden_size)).numpy().T
                           for n in ("query", "key", "value")], axis=1)
    if not np.array_equal(trees["vit"]["block_5"]["attn"]["qkv"]["kernel"], want):
        fail("the imported fused qkv of ViT block 5 differs from its draws")
    want = draw(sh, "feature_extractor.conv_layers.3.conv.weight",
                (h.conv_dim[3], h.conv_dim[2], h.conv_kernel[3])).numpy().transpose(2, 1, 0)
    if not np.array_equal(trees["hubert"]["feature_extractor"]["conv_3"]["kernel"], want):
        fail("the imported HuBERT conv_3 kernel differs from its draw")
    pc, k = "encoder.pos_conv_embed.conv.parametrizations.weight.", h.num_conv_pos_embeddings
    g = draw(sh, pc + "original0", (1, 1, k), offset=1.0).double()
    vv = draw(sh, pc + "original1",
              (h.hidden_size, h.hidden_size // h.num_conv_pos_embedding_groups, k)).double()
    w64 = (g * vv / vv.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()).numpy().transpose(2, 1, 0)
    got = trees["hubert"]["pos_conv_embed"]["conv"]["kernel"]
    rel = float(np.abs(got - w64).max() / np.abs(w64).max())
    if not rel < 1e-6:
        fail(f"the positional conv's weight is {rel:.3g} off g v / |v| in float64")
    for i in range(v.num_layers):
        for name, seed in (("qkv", 0), ("proj", 1000 + i)):
            dense = trees["vit"][f"block_{i}"]["attn"][name]
            lim = np.sqrt(6.0 / v.hidden_size)
            a_want = np.random.default_rng(seed).uniform(-lim, lim, (v.hidden_size, v.lora_rank))
            if not (np.array_equal(dense["lora_a"], a_want.astype(np.float32))
                    and not dense["lora_b"].any()):
                fail(f"block {i} {name}: the fresh LoRA factors differ from default_rng({seed})")
    print(f"  imported tensors held to their seeds: ViT block 5's fused qkv and HuBERT's conv_3 "
          f"bit-equal to the transposed draws; the positional conv's weight {rel:.3g} (relative) "
          f"from g v / |v| in float64; the {2 * v.num_layers} fresh LoRA A factors bit-equal to "
          f"numpy default_rng draws, every B zero", flush=True)


def _held(start, want, what):
    if start.keys() != want.keys():
        fail(f"{what}: the trainer's parameters are not the importer's: "
             f"{sorted(start.keys() ^ want.keys())[:5]}")
    differ = [k for k in want if not torch.equal(start[k], want[k].cpu())]
    if differ:
        fail(f"{what}: the model before its first update differs from the importer's "
             f"state_dict at {differ[:5]}")


def pretrained_phase(root):
    """Phase 18: the Trainer started from pretrained files, the infer and
    viz commands, and the int8 serving mode, at full width
    (perf_train_model_config(); perf_eval_model_config() for the
    random-init infer), on phase 17's files on disk under ``root``.
    Returns the summary and the launch counts of its six paths."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.cli import infer as infer_cli
    from triad_tpu_torch.cli import train as train_cli
    from triad_tpu_torch.cli import viz as viz_cli
    from triad_tpu_torch.config import perf_eval_model_config, perf_train_model_config
    from triad_tpu_torch.models import hf_import
    from triad_tpu_torch.models.convert import flax_to_torch
    from triad_tpu_torch.models.multimodal import TriadModel
    from triad_tpu_torch.models.reference_import import load_reference_checkpoint
    from triad_tpu_torch.ops import quant
    from triad_tpu_torch.tools import hf_layout

    cfg = perf_train_model_config()
    out, launches = {"files": {}}, {}
    wdir = os.path.join(root, "weights")
    os.makedirs(wdir)
    paths = {"hubert": os.path.join(wdir, "hubert-base-ls960"),
             "text": os.path.join(wdir, "distilbert-base-uncased"),
             "vit": os.path.join(wdir, "dinov2_vitb14_reg4_pretrain.pth"),
             "reference": os.path.join(wdir, "checkpoint_epoch3_step1200.pt")}
    writers = {
        "hubert": lambda p: hf_layout.write_snapshot(p, "hubert", cfg.hubert,
                                                     PRETRAINED_SEEDS["hubert"], fmt="sharded",
                                                     legacy_weight_norm=True),
        "text": lambda p: hf_layout.write_snapshot(p, "distilbert", cfg.text,
                                                   PRETRAINED_SEEDS["text"], fmt="bin", task=True),
        "vit": lambda p: hf_layout.write_hub_dinov2(p, cfg.vit, PRETRAINED_SEEDS["vit"],
                                                    wrap="teacher"),
        "reference": lambda p: hf_layout.write_reference_checkpoint(p, cfg,
                                                                    PRETRAINED_SEEDS["reference"]),
    }
    importers = {"hubert": hf_import.load_hubert_snapshot,
                 "text": hf_import.load_distilbert_snapshot,
                 "vit": hf_import.load_dinov2_snapshot, "reference": load_reference_checkpoint}
    kinds = {"hubert": "HF snapshot, 2 safetensors shards, weight_g / weight_v",
             "text": "HF snapshot, pytorch_model.bin of DistilBertForMaskedLM",
             "vit": "torch.hub .pth under teacher / backbone.",
             "reference": "reference .pt, _orig_mod., peft DINOv2 with LoRA"}
    trees = {}
    for name, path in paths.items():
        t0 = time.perf_counter()
        nbytes = writers[name](path)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        trees[name] = importers[name](path, cfg)
        import_s = time.perf_counter() - t0
        out["files"][name] = {"kind": kinds[name], "bytes": nbytes, "write_s": write_s,
                              "import_s": import_s}
        print(f"  {name}: {kinds[name]}: {nbytes} bytes written in {write_s:.3f} s, imported "
              f"in {import_s:.3f} s (host)", flush=True)
    _weight_checks(cfg, trees)
    del trees
    jpg, mp4, caption = _media(root)

    cfg_path = os.path.join(root, "trainer.json")
    run_p, run_r = os.path.join(root, "run_pretrained"), os.path.join(root, "run_reference")

    # -- the Trainer from the per-backbone files --------------------------
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with _StartState() as start:
        trainer = train_cli.main(
            ["--config", cfg_path, "--steps", str(PRETRAINED_STEPS), "--output-dir", run_p,
             "--force-new", "--set", *PRETRAINED_SET, f"pretrained.hubert={paths['hubert']}",
             f"pretrained.text={paths['text']}", f"pretrained.vit={paths['vit']}"])
    out["pretrained_run_s"] = time.perf_counter() - t0
    out["pretrained_startup_s"] = start.startup_s
    launches["pretrained_trainer"] = dict(kernels.LAUNCHES)
    trainer.ckpt.close()
    _check_launches(launches["pretrained_trainer"], JOINT_KERNELS, "pretrained trainer")
    want = hf_import.init_params_from_pretrained(
        trainer.config.model, torch.Generator(device="cuda").manual_seed(trainer.config.train.seed),
        hubert_path=paths["hubert"], text_path=paths["text"], vit_path=paths["vit"])
    _held(start.state, want, "the run from the per-backbone files")
    del want
    lines = _run_metrics(run_p)
    losses = [m for m in lines if "train_loss" in m]
    phases = sorted({m["training_phase"] for m in losses})
    if phases != ["av_focus", "full_joint"] or not all(np.isfinite(m["train_loss"])
                                                       for m in losses):
        fail(f"the pretrained run logged {[(m['training_phase'], m['train_loss']) for m in losses]}")
    moved = {}
    for name, p in trainer.model.named_parameters():
        group = name.split(".")[0]
        if group == "visual_backbone":
            group += "_lora" if "lora_" in name else "_base"
        elif group not in ("audio_backbone", "text_backbone"):
            group = "heads_temperature"
        moved.setdefault(group, [0, 0])
        moved[group][0] += not torch.equal(p.detach().cpu(), start.state[name])
        moved[group][1] += 1
    if moved["visual_backbone_base"][0] or not all(
            m[0] for g, m in moved.items() if g != "visual_backbone_base"):
        fail(f"moved tensors by group after the pretrained run: {moved}")
    out["pretrained_moved"] = moved
    final = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    tokenizer, model_cfg, data_cfg = trainer.tokenizer, trainer.config.model, trainer.config.data
    del trainer, start
    torch.cuda.empty_cache()
    print(f"  cli.train from the three files ({out['pretrained_run_s']:.1f} s, "
          f"{out['pretrained_startup_s']:.2f} s to its first step): the model before the first "
          f"update bit-equal to init_params_from_pretrained's state_dict; {len(losses)} finite "
          f"losses over {phases}; tensors moved by group: "
          f"{ {g: f'{m[0]} of {m[1]}' for g, m in moved.items()} }", flush=True)

    # -- the Trainer from the reference checkpoint ----------------------------
    kernels.reset_launches()
    t0 = time.perf_counter()
    with _StartState() as start:
        trainer = train_cli.main(
            ["--config", cfg_path, "--steps", "1", "--output-dir", run_r, "--force-new", "--set",
             *PRETRAINED_SET, "train.num_epochs=1", "train.av_focus_epochs=0",
             f"pretrained.reference_checkpoint={paths['reference']}"])
    out["reference_run_s"] = time.perf_counter() - t0
    out["reference_startup_s"] = start.startup_s
    launches["reference_trainer"] = dict(kernels.LAUNCHES)
    trainer.ckpt.close()
    _check_launches(launches["reference_trainer"], JOINT_KERNELS, "reference trainer")
    _held(start.state, flax_to_torch(load_reference_checkpoint(paths["reference"], cfg), cfg),
          "the run from the reference checkpoint")
    file = {k[len("_orig_mod."):]: v for k, v in torch.load(
        paths["reference"], map_location="cpu", weights_only=False)["model_state_dict"].items()}
    pairs = [("temperature", "temperature")]
    for m in ("audio", "text", "visual"):
        for leaf in ("projection1.weight", "projection1.bias", "layer_norm.weight",
                     "layer_norm.bias", "projection2.weight", "projection2.bias"):
            pairs.append((f"{m}_projection.{leaf}", f"{m}_embedder.{leaf}"))
    for i in range(cfg.vit.num_layers):
        for layer in ("qkv", "proj"):
            for ours, theirs in (("lora_a", "lora_A"), ("lora_b", "lora_B")):
                pairs.append((f"visual_backbone.blocks.{i}.attn.{layer}.{ours}",
                              f"visual_embedder.model.base_model.model.blocks.{i}.attn.{layer}."
                              f"{theirs}.default.weight"))
    differ = [o for o, t in pairs if not torch.equal(start.state[o], file[t])]
    if differ:
        fail(f"the reference run's start differs from the file's tensors at {differ[:5]}")
    losses_r = [m["train_loss"] for m in _run_metrics(run_r) if "train_loss" in m]
    if not losses_r or not all(np.isfinite(losses_r)):
        fail(f"the reference run logged {losses_r}")
    del trainer, start, file
    torch.cuda.empty_cache()
    print(f"  cli.train from the reference checkpoint ({out['reference_run_s']:.1f} s, "
          f"{out['reference_startup_s']:.2f} s to its first step): its start bit-equal to "
          f"load_reference_checkpoint's, its {len(pairs)} head, temperature and LoRA tensors "
          f"equal to the file's; loss {losses_r}", flush=True)

    # -- cli.infer on the run directory, then the random init ---------------
    kernels.reset_launches()
    npz_run = os.path.join(root, "infer_run.npz")
    t0 = time.perf_counter()
    summary = infer_cli.main(["--run-dir", run_p, "--image", jpg, "--media", mp4, "--text",
                              caption, "--out", os.path.join(root, "infer_run.json"),
                              "--features-npz", npz_run])
    out["infer_run_dir_s"] = time.perf_counter() - t0
    launches["infer"] = dict(kernels.LAUNCHES)
    _check_launches(launches["infer"], RUN_DIR_KERNELS, "infer --run-dir")
    sims = {"vis_text_sim_matrix", "vis_audio_sim_matrix", "text_audio_sim_matrix"}
    if not sims <= set(summary):
        fail(f"cli.infer's summary lacks {sims - set(summary)}")
    got = dict(np.load(npz_run))
    from triad_tpu_torch.data.audio import extract_audio, pad_or_trim
    from triad_tpu_torch.data.images import clean_image, load_image

    ref = TriadModel(dataclasses.replace(model_cfg, compute_dtype="float32"), device="cpu")
    ref.load_state_dict(final)
    ref.eval()
    ids, mask = tokenizer.encode_batch([caption], max_length=data_cfg.max_text_tokens,
                                       pad_to=data_cfg.max_text_tokens)
    with torch.inference_mode():
        want = ref.inference_forward(
            torch.from_numpy(clean_image(load_image(jpg, data_cfg.image_size))[None]),
            torch.from_numpy(pad_or_trim(extract_audio(mp4), data_cfg.audio_num_samples)[None]),
            torch.from_numpy(ids).long(), torch.from_numpy(mask.astype(np.float32)))
    del ref, final
    cos_run = {}
    for key in ("visual_feats", "audio_feats", "text_feats"):
        c = _cos_rows(got[key], want[key].numpy())
        cos_run[key] = float(c.min())
        if not c.min() > 0.99:
            fail(f"cli.infer's {key} disagree with the fp32 CPU forward: min cosine {c.min()}")
    out["infer_run_dir_min_cosine"] = cos_run
    print(f"  cli.infer --run-dir ({out['infer_run_dir_s']:.1f} s): "
          f"{ {k: v['shape'] for k, v in summary.items()} }; min token cosine against the fp32 "
          f"CPU forward of the run's weights {cos_run}", flush=True)

    eval_cfg = os.path.join(root, "perf_eval.json")
    with open(eval_cfg, "w") as f:
        json.dump({"model": dataclasses.asdict(perf_eval_model_config()),
                   "data": {"audio_num_samples": AUDIO, "max_text_tokens": TRAIN_TXT}}, f)
    # Every Dense / LoRALinear forward is one product; under --int8 each
    # must be one int8_matmul, and the bf16 run must make none.
    from triad_tpu_torch.models.layers import Dense, LoRALinear

    products = {}

    def count_dense(module, args, output):
        if isinstance(module, (Dense, LoRALinear)):
            products["dense"] += 1

    def count_int8(*args):
        products["int8"] += 1
        return int8_matmul(*args)

    int8_matmul = quant.int8_matmul
    hook = torch.nn.modules.module.register_module_forward_hook(count_dense)
    quant.int8_matmul = count_int8
    feats, out["infer_random_init_s"], out["int8_products"] = {}, {}, {}
    try:
        for mode, path in (("bf16", "infer_random"), ("int8", "infer_int8")):
            products.update(dense=0, int8=0)
            npz = os.path.join(root, f"infer_{mode}.npz")
            kernels.reset_launches()
            t0 = time.perf_counter()
            infer_cli.main(["--random-init", "--config", eval_cfg, "--image", jpg, "--media", mp4,
                            "--text", caption, "--features-npz", npz]
                           + (["--int8"] if mode == "int8" else []))
            out["infer_random_init_s"][mode] = time.perf_counter() - t0
            launches[path] = dict(kernels.LAUNCHES)
            _check_launches(launches[path], RANDOM_INIT_KERNELS, f"infer --random-init ({mode})")
            out["int8_products"][mode] = dict(products)
            feats[mode] = dict(np.load(npz))
    finally:
        quant.int8_matmul = int8_matmul
        hook.remove()
    dense_bf16, dense_q = out["int8_products"]["bf16"], out["int8_products"]["int8"]
    if (dense_bf16["int8"] or not dense_q["dense"] or dense_q["int8"] != dense_q["dense"]
            or dense_q["dense"] != dense_bf16["dense"]):
        fail(f"int8 products against Dense / LoRALinear forwards: {out['int8_products']}")
    cos_q = {}
    for key in ("visual_feats", "audio_feats", "text_feats"):
        a, b = feats["bf16"][key].astype(np.float64).ravel(), feats["int8"][key].astype(
            np.float64).ravel()
        cos_q[key] = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        if not 0.995 < cos_q[key] < 1 - 1e-6:
            fail(f"the int8 {key} are at cosine {cos_q[key]} to the bf16 ones")
    out["int8_cosine"] = cos_q
    print(f"  cli.infer --random-init on perf_eval_model_config(), bf16 and --int8 "
          f"({out['infer_random_init_s']['bf16']:.1f} s, {out['infer_random_init_s']['int8']:.1f}"
          f" s): {dense_q['int8']} int8 products under --int8, one for each of its "
          f"{dense_q['dense']} Dense / LoRALinear forwards, none in the bf16 run; the int8 "
          f"embeddings' cosine to the bf16 ones {cos_q}", flush=True)

    # -- the int8 product: _int_mm against its plain version, and its time ---
    g = torch.Generator().manual_seed(43)
    for m, k, n in ((261, 768, 2304), (17, 512, 768), INT8_SHAPE):
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
        if not torch.equal(quant.int8_matmul(a.cuda(), b.cuda()).cpu(),
                           quant.int8_matmul_plain(a, b)):
            fail(f"_int_mm's int32 sums differ from the plain product at ({m}, {k}, {n})")
    m, k, n = INT8_SHAPE
    a8, b8 = a.cuda(), b.cuda()
    x16 = randn((m, k), 44)
    w16 = randn((n, k), 45, 0.02)
    xf, wf = x16.float(), w16.float()
    fns = [lambda: quant.int8_matmul(a8, b8), lambda: torch.mm(x16, w16.t()),
           lambda: quant.int8_dense(x16, wf), lambda: torch.nn.functional.linear(x16, w16),
           lambda: quant.quantize_weight(wf), lambda: quant.quantize_rows(xf)]
    sync = time_fns(fns)
    dev = [device_ms(fn, s_ms) for fn, s_ms in zip(fns, sync)]
    ops = 2 * m * k * n
    bound8 = cost(ops, m * k + n * k + 4 * m * n, peak=1979e12)
    bound16 = cost(ops, 2 * (m * k + n * k + m * n))
    out["int8_gemm"] = {"shape": [m, k, n], "int_mm_ms": sync[0], "int_mm_device_ms": dev[0],
                        "bf16_mm_ms": sync[1], "bf16_mm_device_ms": dev[1],
                        "int8_dense_ms": sync[2], "int8_dense_device_ms": dev[2],
                        "bf16_linear_ms": sync[3], "bf16_linear_device_ms": dev[3],
                        "quantize_weight_device_ms": dev[4], "quantize_rows_device_ms": dev[5],
                        "int_mm_bound_ms": bound8[0], "int_mm_bound_by": bound8[1],
                        "bf16_bound_ms": bound16[0], "bf16_bound_by": bound16[1]}
    del a8, b8, x16, w16, xf, wf
    print(f"  _int_mm equals the plain int32 product at (261, 768, 2304), (17, 512, 768) and "
          f"{INT8_SHAPE}; at {INT8_SHAPE} (sync / device ms): _int_mm {sync[0]:.4f} / "
          f"{dev[0]:.4f} (bound {bound8[0]:.4f}, {bound8[1]}, int8 peak) against the bf16 "
          f"product {sync[1]:.4f} / {dev[1]:.4f} (bound {bound16[0]:.4f}); the whole int8_dense "
          f"(quantize x and W, _int_mm, scale) {sync[2]:.4f} / {dev[2]:.4f} against bf16 "
          f"F.linear {sync[3]:.4f} / {dev[3]:.4f}; of it, device ms: quantize_weight (fp32 W) "
          f"{dev[4]:.4f}, quantize_rows (fp32 x) {dev[5]:.4f}", flush=True)

    # -- cli.viz on the run directory ----------------------------------------
    import cv2

    kernels.reset_launches()
    vdir = os.path.join(root, "viz")
    t0 = time.perf_counter()
    viz_cli.main(["--run-dir", run_p, "--image", jpg, "--text", caption, "--video", mp4,
                  "--out-dir", vdir])
    out["viz_s"] = time.perf_counter() - t0
    launches["viz"] = dict(kernels.LAUNCHES)
    _check_launches(launches["viz"], RUN_DIR_KERNELS, "viz")
    for name in ("audio_attention.png", "text_attention.png"):
        if not os.path.getsize(os.path.join(vdir, name)):
            fail(f"cli.viz wrote an empty {name}")
    cap = cv2.VideoCapture(os.path.join(vdir, "audio_attention.mp4"))
    frames = 0
    while frames < 1000 and cap.read()[0]:
        frames += 1
    cap.release()
    if not frames:
        fail("cv2 reads no frame of cli.viz's audio_attention.mp4")
    out["viz_video_frames"] = frames
    print(f"  cli.viz --run-dir with --image / --text and --video ({out['viz_s']:.1f} s): both "
          f"PNGs written, cv2 reads {frames} frames of audio_attention.mp4", flush=True)
    return out, launches


EXPORT_B = (1, 3, 8)  # request batches served from the bundle
EXPORT_TXT = 128  # configs/default.yaml's max_text_tokens: the bundle's text length
EXPORT_STEPS = 2  # steps of the default-yaml run that leg 3 exports (its depth cut)
# Least token cosine of the bundle's answers, by modality. To the live
# model or a run's restored model on the card (the same bf16 weights: the
# visual and text programs run the live model's ops, the audio one the
# plain MLP where the live model runs the fused MLP kernel; on an H100
# 80GB HBM3 1.0, 1.0 and 0.99994):
EXPORT_SAME_PRECISION = {"audio": 0.9995, "visual": 0.99999, "text": 0.99999}
# To the bundle's fp32 CPU programs (bf16 against fp32; 0.99993 to 0.99995
# there):
EXPORT_CPU_FP32 = {"audio": 0.999, "visual": 0.999, "text": 0.999}
EXPORT_SET = [  # over configs/default.yaml: one full_joint epoch, every group unfrozen
    "train.num_epochs=1", "train.av_focus_epochs=0", "train.tv_warmup_epochs=0",
    "train.weighted_joint_epochs=0", f"train.vis_every={10 ** 9}",
    f"train.save_every_steps={10 ** 9}", f"train.validation_frequency={10 ** 9}",
    f"train.retrieval_subset_size={TRAINER_VAL_CLIPS}", "train.optim.gradient_accumulation_steps=1",
    "train.optim.unfreeze_audio_step=0", "train.optim.unfreeze_text_step=0",
    "train.optim.unfreeze_vit_step=0", "data.num_workers=4", 'data.worker_mode="thread"',
    "data.device_augment=true"]
# The server's process: its import system refuses the port's model code and
# kernels (what it serves comes from the bundle's programs alone); SIGTERM
# prints the port's modules it holds and ends it.
SERVE_BUNDLE = """
import signal, sys
BLOCKED = ('triad_tpu_torch.models', 'triad_tpu_torch.kernels')
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.startswith(BLOCKED):
            raise ImportError('refused: ' + name)
sys.meta_path.insert(0, Refuse())
def stop(*_):
    print('MODULES', sorted(m for m in sys.modules if m.startswith('triad_tpu_torch')), flush=True)
    sys.exit(0)
signal.signal(signal.SIGTERM, stop)
from triad_tpu_torch.cli.serve import main
main(['--bundle', sys.argv[1], '--port', '0'])
"""


def _export_cli(*args):
    """cli.export in this process: (bundle path, seconds, seconds per
    platform as export_bundle prints them)."""
    import contextlib

    from triad_tpu_torch.cli import export as export_cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        path = export_cli.main(list(args))
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    per_platform = {m.group(1): float(m.group(2)) for m in
                    re.finditer(r"exported the (\w+) programs \([^)]*\) in ([\d.]+) s", text)}
    return str(path), seconds, per_platform


def _bundle_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _export_requests(seed):
    """Requests at each of EXPORT_B: 10 s clips, 224^2 images and
    EXPORT_TXT token ids with a mask (the first caption padded after 40)."""
    rng = np.random.default_rng(seed)
    out = {}
    for b in EXPORT_B:
        mask = np.ones((b, EXPORT_TXT), np.float32)
        mask[0, 40:] = 0.0
        out[b] = ((rng.standard_normal((b, AUDIO)) * 0.1).astype(np.float32),
                  rng.standard_normal((b, 224, 224, 3)).astype(np.float32),
                  rng.integers(1, 30_000, size=(b, EXPORT_TXT)).astype(np.int32), mask)
    return out


def _embeds(serving, audio, images, ids, mask):
    return {"audio": serving.embed_audio(audio), "visual": serving.embed_visual(images),
            "text": serving.embed_text_ids(ids, mask)}


def _min_cosines(got, want, what, bounds):
    """Least token cosines of two dicts of embeddings, each held to its
    modality's bound in ``bounds``."""
    out = {}
    for key in got:
        c = float(_cos_rows(got[key], want[key]).min())
        out[key] = c
        if not c >= bounds[key]:
            fail(f"{what}: {key} tokens at min cosine {c}, under {bounds[key]}")
    return out


def _graph_ops(graph):
    """Every call of an exported program's graph, by target: aten
    operators by name, the symbolic batch's size arithmetic (Python's
    operator functions on sizes) as 'size: ...', anything else (a call
    into other Python code) as 'other: ...'."""
    import operator
    from collections import Counter

    ops = Counter()
    for node in graph.nodes:
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        t = node.target
        if isinstance(t, torch._ops.OpOverload) and t.namespace == "aten":
            ops[str(t)] += 1
        elif getattr(t, "__module__", None) == "_operator":
            ops[f"size: {t.__name__}"] += 1
        else:
            ops[f"other: {t}"] += 1
    return ops


class _BundleServer:
    """cli.serve --bundle in a new process (SERVE_BUNDLE) on an ephemeral
    port, started at construction; a thread notes when its first line
    ("serving on ...") comes. Its stderr goes to
    chiprun_out/serve_bundle_stderr.txt."""

    def __init__(self, path):
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        self._err = open(os.path.join(ROOT, "chiprun_out", "serve_bundle_stderr.txt"), "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-c", SERVE_BUNDLE, path], cwd=ROOT,
                                     stdout=subprocess.PIPE, stderr=self._err, text=True)
        self.line, self.ready_s, self.modules, self._stopped = "", None, None, False
        self._reader = threading.Thread(target=self._first_line, daemon=True)
        self._reader.start()

    def _first_line(self):
        self.line = self.proc.stdout.readline()
        self.ready_s = time.perf_counter() - self.t0

    def answers(self, requests):
        """/healthz, the embed routes at each batch of ``requests``, and
        /v1/score av and tv at the largest; then the server is stopped.
        Returns (answers, seconds to its first line, its port modules)."""
        self._reader.join(timeout=600)
        port = re.search(r"serving on 127\.0\.0\.1:(\d+) \(cuda\)", self.line)
        if not port:
            self.stop()
            fail(f"cli.serve --bundle did not start: {self.line!r} (stderr in "
                 f"chiprun_out/serve_bundle_stderr.txt)")
        base = f"http://127.0.0.1:{port.group(1)}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health.get("status") != "ok" or health.get("format") != "triad_tpu_torch.serve/1":
            fail(f"/healthz of the bundle: {health}")
        answers = {}
        for b, (audio, images, ids, mask) in requests.items():
            answers[b] = {
                "audio": check(f"bundle B={b} audio", _post(
                    base + "/v1/embed/audio", _npy(audio), "application/x-npy"), (b, 499, 512)),
                "visual": check(f"bundle B={b} image", _post(
                    base + "/v1/embed/image", _npy(images), "application/x-npy"), (b, 256, 512)),
                "text": check(f"bundle B={b} text (ids)", _post(
                    base + "/v1/embed/text", json.dumps({"ids": ids.tolist(),
                                                         "mask": mask.tolist()}).encode(),
                    "application/json")["tokens"], (b, EXPORT_TXT, 512)),
            }
        b = max(requests)
        got = answers[b]
        for direction, (qt, qm) in (("av", (got["audio"], np.ones((b, 499), np.float32))),
                                    ("tv", (got["text"], requests[b][3]))):
            body = {"query": {"tokens": qt.tolist(), "mask": qm.tolist()},
                    "key": {"tokens": got["visual"].tolist(), "mask": np.ones((b, 256)).tolist()},
                    "direction": direction}
            answers[f"score_{direction}"] = check(f"bundle score ({direction})", _post(
                base + "/v1/score", json.dumps(body).encode(), "application/json")["scores"],
                (b, b))
        modules = self.stop()
        if modules is None:
            fail(f"the bundle's server did not report its modules (rc {self.proc.returncode})")
        if any(m.startswith(("triad_tpu_torch.models", "triad_tpu_torch.kernels"))
               for m in modules):
            fail(f"the bundle's server imported model code or kernels: {modules}")
        return answers, self.ready_s, modules

    def stop(self):
        """SIGTERM: the process prints the port's modules it holds and
        ends (killed if it has not within 120 s). Returns them."""
        if self._stopped:
            return self.modules
        self._stopped = True
        self._reader.join(timeout=600)
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            rest, _ = self.proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rest, _ = self.proc.communicate()
        self._err.close()
        found = re.search(r"MODULES (\[.*\])", rest or "")
        self.modules = json.loads(found.group(1).replace("'", '"')) if found else None
        return self.modules


def export_phase(root):
    """Phase 19: the serving export at full width (configs/default.yaml's
    model, ModelConfig()). Leg 1, cli.export --random-init for cpu and
    cuda, alone (its seconds by platform). Then, while three commands run
    beside it in processes of their own (cli.serve --bundle of leg 1's
    bundle, leg 5's cli.export --int8 --platforms cuda, and leg 4's
    cli.export --run-dir of phase 17's run, which must be refused), this
    process runs leg 3 (a 2-step cli.train of the default yaml on phase
    17's files, exported with --run-dir --platforms cuda, held to its
    restored model) and loads the bundle and the live ServingModel of the
    same weights. Leg 2 then posts B = 1, 3, 8 and /v1/score both ways to
    the server, holds the answers to the bundle's CPU programs and to the
    live model (whose fused MLP launches are counted; the bundle's calls
    launch none), and, with nothing else running, times each embed call
    at B = 8, bundle against live. Returns the summary and the launch
    counts of the live comparison and of the bundle's calls."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.cli import train as train_cli
    from triad_tpu_torch.config import ModelConfig
    from triad_tpu_torch.models.layers import Dense, LoRALinear
    from triad_tpu_torch.models.multimodal import TriadModel
    from triad_tpu_torch.serve.export import ENDPOINTS, ServingBundle
    from triad_tpu_torch.serve.model import ServingModel

    out, launches = {}, {}
    yaml_cfg = os.path.join(ROOT, "configs", "default.yaml")
    requests = _export_requests(51)
    bundle_dir, int8_dir = os.path.join(root, "bundle"), os.path.join(root, "bundle_int8")
    run, run_bundle = os.path.join(root, "run_export"), os.path.join(root, "bundle_run")

    # -- leg 1: export from random weights, cpu and cuda, alone -------------
    _, out["export_s"], out["export_s_by_platform"] = _export_cli(
        "--random-init", "--config", yaml_cfg, "--platforms", "cpu,cuda", "--out", bundle_dir)
    out["bundle_bytes"] = _bundle_bytes(bundle_dir)
    print(f"  cli.export --random-init --config configs/default.yaml --platforms cpu,cuda: "
          f"{out['export_s']:.1f} s ({out['export_s_by_platform']} by platform), "
          f"{out['bundle_bytes']} bytes", flush=True)

    # -- the three commands beside this process ------------------------------
    server, procs = None, {}
    try:
        server = _BundleServer(bundle_dir)
        procs["int8"] = subprocess.Popen(
            _cli("export", "--random-init", "--config", yaml_cfg, "--int8", "--platforms",
                 "cuda", "--out", int8_dir), cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs["refused"] = subprocess.Popen(
            _cli("export", "--run-dir", os.path.join(root, "run_a"), "--out",
                 os.path.join(root, "refused")), cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

        # -- leg 3: a trained run of configs/default.yaml, exported ---------
        with open(os.path.join(root, "trainer.json")) as f:
            data = json.load(f)["data"]
        paths = [f"data.{k}={json.dumps(data[k])}" for k in (
            "audio_visual_data_root", "text_dataset_path", "audio_visual_val_data_root",
            "text_dataset_val_path")]
        t1 = time.perf_counter()
        trainer = train_cli.main(["--config", yaml_cfg, "--steps", str(EXPORT_STEPS),
                                  "--output-dir", run, "--force-new", "--set", *EXPORT_SET,
                                  *paths])
        out["train_s"] = time.perf_counter() - t1
        step = trainer.ckpt.latest_step()
        trainer.ckpt.close()
        del trainer
        torch.cuda.empty_cache()
        _, out["run_export_s"], _ = _export_cli("--run-dir", run, "--platforms", "cuda",
                                                "--out", run_bundle)
        state, _ = _checkpoint(run, step)
        restored = ServingModel(ModelConfig(), state["model"], "cuda", AUDIO, EXPORT_TXT)
        del state
        got = _embeds(ServingBundle(run_bundle, "cuda"), *requests[3])
        out["run_vs_restored_min_cosine"] = _min_cosines(
            got, _embeds(restored, *requests[3]), "the run's bundle vs its restored model",
            EXPORT_SAME_PRECISION)
        del restored
        torch.cuda.empty_cache()
        print(f"  cli.train of configs/default.yaml ({EXPORT_STEPS} steps of full_joint at B = "
              f"{DEFAULT_B}, {out['train_s']:.1f} s) then cli.export --run-dir --platforms cuda "
              f"({out['run_export_s']:.1f} s, step {step}): at B = 3 min token cosine "
              f"{out['run_vs_restored_min_cosine']} to the restored model", flush=True)

        # -- the bundle in this process, its CPU programs, the live model ----
        t1 = time.perf_counter()
        card = ServingBundle(bundle_dir, "cuda")
        out["load_cuda_s"] = time.perf_counter() - t1
        ops = {name: _graph_ops(card._fns[name].graph) for name in ENDPOINTS}
        if any(k.startswith(("other", "aten._int_mm")) for c in ops.values() for k in c):
            fail(f"the bundle's cuda programs call outside aten, or int8: {ops}")
        t1 = time.perf_counter()
        cpu = ServingBundle(bundle_dir, "cpu")
        out["load_cpu_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        on_cpu = _embeds(cpu, *requests[1])
        out["cpu_program_b1_s"] = time.perf_counter() - t1
        del cpu
        live = ServingModel(ModelConfig(), None, "cuda", AUDIO, EXPORT_TXT)
        kernels.reset_launches()
        want = {b: _embeds(live, *r) for b, r in requests.items()}
        launches["export_live"] = dict(kernels.LAUNCHES)
        print(f"  this process loaded the bundle's cuda programs in {out['load_cuda_s']:.1f} s "
              f"({sum(sum(c.values()) for c in ops.values())} calls, every one an aten "
              f"operator or the batch's size arithmetic) and its cpu programs in "
              f"{out['load_cpu_s']:.1f} s, both while the commands beside it ran", flush=True)

        # -- leg 2: the served answers ----------------------------------------
        answers, out["serve_ready_s"], modules = server.answers(requests)
        print(f"  cli.serve --bundle was ready {out['serve_ready_s']:.1f} s after its start (a "
              f"new process: python, torch, the card, the programs; beside leg 3); it held "
              f"{len(modules)} modules of the port, none of models/ or kernels", flush=True)

        # -- leg 4 and leg 5: the commands' results ----------------------------
        done = {name: proc.communicate(timeout=600) for name, proc in procs.items()}
        rc = {name: proc.returncode for name, proc in procs.items()}
        msg = ("mesh.tp > 1 requires XLA impls; vit.attention_impl='fused_packed' is a pallas "
               "path (allowed: ['xla'] or 'auto')")
        if rc["refused"] == 0 or f"ValueError: {msg}" not in done["refused"][1]:
            fail(f"cli.export of phase 17's run: rc {rc['refused']}, {done['refused'][1][-1500:]}")
        if os.path.exists(os.path.join(root, "refused")):
            fail("the refused export wrote a bundle")
        out["refused"] = msg
        print(f"  cli.export --run-dir of phase 17's run (perf_train_model_config) exited "
              f"{rc['refused']}: {msg}", flush=True)
        if rc["int8"] != 0:
            fail(f"cli.export --int8 exited {rc['int8']}: {done['int8'][1][-2000:]}")
        found = re.search(r"exported the cuda programs \([^)]*\) in ([\d.]+) s", done["int8"][0])
        out["int8_export_s_beside"] = float(found.group(1)) if found else None
    finally:
        if server is not None:
            server.stop()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    # -- the answers against the CPU programs and the live model -------------
    out["vs_cpu_program_min_cosine"] = _min_cosines(answers[1], on_cpu,
                                                    "bundle vs its CPU programs", EXPORT_CPU_FP32)
    n_layers = live.cfg.hubert.num_layers
    others = {k: v for k, v in launches["export_live"].items() if v and k != "fused_mlp"}
    if launches["export_live"]["fused_mlp"] != n_layers * len(requests) or others:
        fail(f"the live ServingModel's launches: {launches['export_live']}, not "
             f"{n_layers} fused_mlp a clip batch")
    out["vs_live_min_cosine"] = {b: _min_cosines(answers[b], want[b], f"bundle vs live at B={b}",
                                                 EXPORT_SAME_PRECISION) for b in requests}
    b = max(requests)
    for direction, (qt, qm) in (("av", (answers[b]["audio"], np.ones((b, 499), np.float32))),
                                ("tv", (answers[b]["text"], requests[b][3]))):
        kt = answers[b]["visual"]
        if direction == "av":
            qt, kt = (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
                      for x in (qt, kt))
        ref = live.pair_scores(qt, qm, kt, np.ones((b, 256), np.float32))
        err = float(np.abs(answers[f"score_{direction}"] - ref).max())
        if not err <= 1e-5 * max(float(np.abs(ref).max()), 1.0):
            fail(f"/v1/score ({direction}) of the bundle is {err} off the live pair_scores")
    print(f"  answers vs the bundle's CPU programs at B = 1 ({out['cpu_program_b1_s']:.1f} s on "
          f"the host): min token cosine {out['vs_cpu_program_min_cosine']}; vs the live "
          f"ServingModel of the same weights on the card: {out['vs_live_min_cosine']}; the live "
          f"model launched fused_mlp {launches['export_live']['fused_mlp']} times "
          f"({n_layers} an encode_audio), nothing else; /v1/score av and tv equal the live "
          f"pair_scores on the served tokens", flush=True)

    # -- leg 5: the int8 bundle ----------------------------------------------
    meta = TriadModel(ModelConfig(), device="meta")

    def n_dense(*mods):
        return sum(isinstance(m, (Dense, LoRALinear)) for mod in mods for m in mod.modules())

    want_mm = {"embed_audio": n_dense(meta.audio_backbone, meta.audio_projection),
               "embed_visual": n_dense(meta.visual_backbone, meta.visual_projection),
               "embed_text": n_dense(meta.text_backbone, meta.text_projection), "pair_scores": 0}
    del meta
    q8_bundle = ServingBundle(int8_dir, "cuda")
    ops8 = {name: _graph_ops(q8_bundle._fns[name].graph) for name in ENDPOINTS}
    if any(k.startswith("other") for c in ops8.values() for k in c):
        fail(f"the int8 programs call outside aten: {ops8}")
    got_mm = {name: c.get("aten._int_mm.default", 0) for name, c in ops8.items()}
    if got_mm != want_mm:
        fail(f"aten._int_mm calls by program {got_mm}, Dense / LoRALinear forwards {want_mm}")
    q8 = _embeds(q8_bundle, *requests[b])
    del q8_bundle
    out["int8_cosine"] = {}
    for key in q8:
        u, v = answers[b][key].astype(np.float64).ravel(), q8[key].astype(np.float64).ravel()
        out["int8_cosine"][key] = c = float(u @ v / (np.linalg.norm(u) * np.linalg.norm(v)))
        if not 0.995 < c < 1 - 1e-6:
            fail(f"the int8 bundle's {key} are at cosine {c} to the bf16 bundle's")
    out["int8_mm_by_program"] = got_mm
    print(f"  cli.export --int8 --platforms cuda (its cuda programs in "
          f"{out['int8_export_s_beside']} s, beside leg 3): aten._int_mm {got_mm}, one for each "
          f"Dense / LoRALinear forward; embeddings at B = {b} at cosine {out['int8_cosine']} to "
          f"the bf16 bundle's", flush=True)

    # -- each embed call at B = 8, the bundle's program vs the live model -----
    x = {k: torch.from_numpy(v).to("cuda") for k, v in zip(("audio", "images", "ids", "mask"),
                                                           requests[b])}
    calls = {"embed_audio": ((lambda: card._fns["embed_audio"](x["audio"])),
                             (lambda: live.model.encode_audio(x["audio"]))),
             "embed_visual": ((lambda: card._fns["embed_visual"](x["images"])),
                              (lambda: live.model.encode_visual(x["images"]))),
             "embed_text": ((lambda: card._fns["embed_text"](x["ids"], x["mask"])),
                            (lambda: live.model.encode_text(x["ids"].long(), x["mask"])))}
    out["ms_b8"] = _bundle_vs_live_ms(calls, b)
    kernels.reset_launches()
    _embeds(card, *requests[b])
    launches["bundle"] = dict(kernels.LAUNCHES)
    if any(launches["bundle"].values()):
        fail(f"the bundle launched kernels: {launches['bundle']}")
    print(f"  ms per call at B = {b}, bundle / live (CUDA events from an idle card; device time "
          f"with the card held; the profiler's kernel sum, in chiprun_out/export_profile.txt): "
          + "; ".join(f"{k} {v['bundle_sync']:.3f} / {v['live_sync']:.3f}, device "
                      f"{v['bundle']:.3f} / {v['live']:.3f}, kernels {v['bundle_kernel_ms']:.3f} "
                      f"/ {v['live_kernel_ms']:.3f} ({v['bundle_launches']} / "
                      f"{v['live_launches']} launches)" for k, v in out["ms_b8"].items())
          + "; the bundle's calls launched no kernel of the port", flush=True)
    del x, calls, card, live
    torch.cuda.empty_cache()
    return out, launches


def _bundle_vs_live_ms(calls, b):
    """Per call at batch ``b``: CUDA events from an idle card (in turns,
    bundle, live, live, bundle), device time with the card held
    (device_ms), and one call under torch.profiler: the kernels' device
    time and launches (chiprun_out/export_profile.txt)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out, lines = {}, []
    with torch.inference_mode():
        for name, (bundle_fn, live_fn) in calls.items():
            sync = time_fns([bundle_fn, live_fn, live_fn, bundle_fn], reps=5, warmup=1)
            v = out[name] = {"bundle_sync": (sync[0] + sync[3]) / 2,
                             "live_sync": (sync[1] + sync[2]) / 2}
            v["bundle"] = device_ms(bundle_fn, v["bundle_sync"])
            v["live"] = device_ms(live_fn, v["live_sync"])
            for label, fn in (("bundle", bundle_fn), ("live", live_fn)):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                rows = sorted((e for e in prof.key_averages()
                               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                              key=lambda e: -e.self_device_time_total)
                v[f"{label}_kernel_ms"] = sum(e.self_device_time_total for e in rows) / 1e3
                v[f"{label}_launches"] = sum(e.count for e in rows)
                lines.append(f"{name} at B = {b}, {label}: {v[f'{label}_kernel_ms']:.3f} ms of "
                             f"kernels in {v[f'{label}_launches']} launches")
                lines += [f"{e.self_device_time_total / 1e3:10.4f} ms {e.count:6d}x  {e.key[:110]}"
                          for e in rows[:20]]
    with open(os.path.join(ROOT, "chiprun_out", "export_profile.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return out


# ---------------------------------------------------------------------------
# Phase 20: data-parallel training
# ---------------------------------------------------------------------------

DP_STEPS, DP_EPOCHS = 2, 2  # steps an epoch and epochs: every step logged, saves at 2 and 4
DP_B0 = 32  # 20d: the kernels for the rows of rank 1 of a world-2 batch of 64
# Per-step losses (relative) and the cosine of the parameters' updates.
# World 1 against one process: the same products, the distributed
# logsumexp's order. World 2 against one process: bf16 products of 32 and
# 64 rows (cuBLAS picks its algorithm by M) round apart. Ring against
# gather from one start: the same loss values (held at 1e-6); the update
# differs at bf16 rounding, as each ring step's feature cotangents come
# back in bf16 and are summed in bf16 (the gather's chunks sum in fp32 and
# round once).
DP_LOSS_REL = {"nccl_world1": 1e-5, "world2": 5e-3, "ring": 1e-6}
DP_UPDATE_COS = {"nccl_world1": 0.9999, "world2": 0.99, "ring": 0.99}


def _dp_config(root):
    """Phase 20's config: phase 17's (perf_train_model_config(), B = 64 from
    the same TriadPack shards and caption folder) in full_joint for 2
    epochs of 2 steps, accumulation 2 (an update at steps 2 and 4, saved
    at each epoch end), every group unfrozen, no validation set, no viz."""
    with open(os.path.join(root, "trainer.json")) as f:
        cfg = json.load(f)
    cfg["data"].update(audio_visual_val_data_root=None, text_dataset_val_path=None)
    cfg["train"].update(num_epochs=DP_EPOCHS, av_focus_epochs=0, tv_warmup_epochs=0,
                        weighted_joint_epochs=0, vis_every=10 ** 9, save_every_steps=10 ** 9)
    cfg["train"]["optim"].update(gradient_accumulation_steps=2, unfreeze_audio_step=0,
                                 unfreeze_text_step=0, unfreeze_vit_step=0)
    path = os.path.join(root, "dp.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _world2(cfg_path, run_dir, *extra):
    """cli.train as two processes on the one card (torchrun, gloo): returns
    each rank's AdamW moment bytes. Any rank that fails fails the phase."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("TRIAD_")}
    env["TRIAD_DIST_BACKEND"] = "gloo"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "triad_tpu_torch.cli.train", "--config", cfg_path, "--steps",
           str(DP_STEPS), "--output-dir", run_dir, "--force-new", "--set",
           "mesh.num_devices=2", *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    log = os.path.join(ROOT, "chiprun_out", f"dp_{os.path.basename(run_dir)}.txt")
    with open(log, "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        fail(f"the world-2 run {run_dir} exited {proc.returncode}: "
             f"{(proc.stdout + proc.stderr)[-3000:]}")
    moments = {int(m.group(1)): int(m.group(2)) for m in
               re.finditer(r"rank (\d+): AdamW moments (\d+) bytes", proc.stdout)}
    if sorted(moments) != [0, 1]:
        fail(f"the world-2 run {run_dir} did not report both ranks' moments")
    print(f"  world-2 run {os.path.basename(run_dir)} {' '.join(extra)}: "
          f"{time.perf_counter() - t0:.1f} s, log {os.path.relpath(log, ROOT)}", flush=True)
    return moments


HOLD_ALL = ("losses", "cosine", "parameters")


def _dp_hold(what, key, got_losses, want_losses, got, want, init, lr_max, updates,
             held=HOLD_ALL):
    """Per-step losses within DP_LOSS_REL[key] relative ("losses"); the
    parameters after the run: their updates (from ``init``) at cosine >=
    DP_UPDATE_COS[key] ("cosine"), and no element further apart than
    ``updates`` Adam steps of 2 lr_max (an Adam step moves an element by at
    most lr; two runs may step a gradient that is 0 up to rounding either
    way) plus 1e-6 (fp32 rounding of the parameters) ("parameters").
    ``held`` names the checks that fail the phase; the others are printed
    only."""
    if sorted(got_losses) != sorted(want_losses) or not want_losses:
        fail(f"{what}: logged steps {sorted(got_losses)} vs {sorted(want_losses)}")
    worst = max(abs(got_losses[s] - want_losses[s]) / abs(want_losses[s]) for s in want_losses)
    dot = n1 = n2 = 0.0
    far = 0.0
    for name in init:
        a, b = got[name].double(), want[name].double()
        u1, u2 = a - init[name].double(), b - init[name].double()
        dot += float((u1 * u2).sum())
        n1 += float((u1 * u1).sum())
        n2 += float((u2 * u2).sum())
        far = max(far, float((a - b).abs().max()))
    cos = dot / max((n1 * n2) ** 0.5, 1e-300)
    bound = updates * 2 * lr_max + 1e-6
    ok = {"losses": worst <= DP_LOSS_REL[key], "cosine": cos >= DP_UPDATE_COS[key],
          "parameters": far <= bound}
    print(f"  {what}: losses " + ", ".join(f"{got_losses[s]:.6f}/{want_losses[s]:.6f}"
                                           for s in sorted(want_losses))
          + f" (worst {worst:.3g} relative, tol {DP_LOSS_REL[key]:g}); update cosine "
          f"{cos:.6f} (tol {DP_UPDATE_COS[key]}), |update| {n1 ** 0.5:.6g} vs {n2 ** 0.5:.6g}, "
          f"largest parameter difference {far:.3g} (bound {bound:.3g})"
          + ("" if tuple(held) == HOLD_ALL else f" (held: {', '.join(held) or 'none'})"),
          flush=True)
    bad = [k for k in held if not ok[k]]
    if bad:
        fail(f"{what} disagrees: {', '.join(bad)}")
    return {"worst_loss_rel": worst, "update_cos": cos, "max_param_diff": far}


def _lr_max(lines):
    return max(v for m in lines for k, v in m.items() if k.startswith("lr_"))


def _logged_step_ms(lines):
    """The Trainer's step_time_ms as logged (CUDA events between steps'
    ends; the first step of an epoch is not timed)."""
    return [round(m["step_time_ms"], 3) for m in lines if "step_time_ms" in m]


class _NoSaves:
    """While active, Trainer.save_checkpoint writes nothing (it records the
    step in ``steps``): phase 20's in-process runs are compared in memory,
    so their checkpoints would only add disk writes (PERF.md section 7)."""

    def __enter__(self):
        from triad_tpu_torch.train.trainer import Trainer

        self.orig, self.steps = Trainer.save_checkpoint, []
        box = self

        def save(trainer, is_best=False):
            box.steps.append(trainer.progress.global_step)

        Trainer.save_checkpoint = save
        return self

    def __exit__(self, *exc):
        from triad_tpu_torch.train.trainer import Trainer

        Trainer.save_checkpoint = self.orig


def _params(trainer):
    return {n: p.detach().to("cpu", copy=True) for n, p in trainer.model.named_parameters()}


def dropout_offset_cases():
    """20d: the three dropout kernels at their phase 3 shapes (8, 499, 768),
    p = 0.1, for the global rows b0 = 32 .. 39: outputs against the twins
    at b0 (2 bf16 ulps), the keep masks bit for bit (the attention's read
    off q = k = 0 and V = I at N = 64, where the output is the dropped
    P), and other masks than at b0 = 0."""
    from triad_tpu_torch.ops import attention as A
    from triad_tpu_torch.ops import layernorm as L
    from triad_tpu_torch.ops import mlp as M

    b, n, p, tol = B, 499, P_DROP, 2 * BF16_ULP

    def held(name, got, ref):
        err, mx = max_err(got, ref)
        print(f"  {name} at b0 = {DP_B0}: err {err:.4g} (tol {tol * mx:.4g})", flush=True)
        if err > tol * mx:
            fail(f"{name} at b0 = {DP_B0} disagrees with its twin")

    def masks(name, kept, keep, keep0):
        same, other = torch.equal(kept, keep), not torch.equal(keep, keep0)
        print(f"  {name} keep mask at b0 = {DP_B0}: bit-equal {same}, differs from b0 = 0 "
              f"{other}", flush=True)
        if not (same and other):
            fail(f"{name}: the keep mask at b0 = {DP_B0} is not the twin's")

    q, k, v, do = (randn((b, n, 768), s) for s in (81, 82, 83, 84))
    keys = torch.ones((b, n), device="cuda")
    out, saved = A.attention_train_fwd(q, k, v, keys, 0.125, 1234, p, DP_B0)
    held("attention_train", out, A.attention_train_plain(q, k, v, keys, 0.125, 1234, p, DP_B0))
    held("attention_train_bwd", A.attention_train_bwd(q, k, v, keys, do, 0.125, 1234, p, saved,
                                                      DP_B0),
         A.attention_train_bwd_plain(q, k, v, keys, do, 0.125, 1234, p, DP_B0))
    zeros = torch.zeros((b, 64, 768), device="cuda", dtype=torch.bfloat16)
    eye = torch.eye(64, device="cuda", dtype=torch.bfloat16).repeat(b, 1, 12)
    d, _ = A.attention_train_fwd(zeros, zeros, eye, torch.ones((b, 64), device="cuda"), 0.125,
                                 1234, p, DP_B0)
    masks("attention_train", d.reshape(b, 64, 12, 64).permute(0, 2, 1, 3) != 0,
          A.attention_keep(b, 12, 64, 64, 1234, p, "cuda", DP_B0),
          A.attention_keep(b, 12, 64, 64, 1234, p, "cuda"))

    w1, b1 = randn((3072, 768), 87, 768 ** -0.5), randn((3072,), 88, 0.1)
    w2, b2 = randn((768, 3072), 89, 3072 ** -0.5), randn((768,), 90, 0.1)
    x, dy = randn((b, n, 768), 85), randn((b, n, 768), 86)
    held("fused_mlp", M.fused_mlp(x, w1, b1, w2, b2, "tanh", 77, p, DP_B0),
         M.fused_mlp_plain(x, w1, b1, w2, b2, "tanh", 77, p, DP_B0))
    got = M.fused_mlp_bwd(x, w1, b1, w2, dy, "tanh", 77, p, DP_B0)
    ref = M.fused_mlp_bwd_plain(x, w1, b1, w2, dy, "tanh", 77, p, DP_B0)
    held("fused_mlp_bwd", got, ref)
    masks("fused_mlp (the dropped GELU's zeros)", got[2] != 0, ref[2] != 0,
          M.fused_mlp_bwd_plain(x, w1, b1, w2, dy, "tanh", 77, p)[2] != 0)

    gamma = randn((768,), 31, 0.2, torch.float32) + 1.0
    beta = randn((768,), 32, 0.1, torch.float32)
    x, hh, dy = (randn((b, n, 768), s) for s in (33, 34, 35))
    held("layernorm", L.dropout_add_ln(x, hh, gamma, beta, 1e-5, 99, p, DP_B0),
         L.dropout_add_ln_plain(x, hh, gamma, beta, 1e-5, 99, p, DP_B0))
    got = L.dropout_add_ln_bwd(x, hh, gamma, dy, 1e-5, 99, p, DP_B0)
    ref = L.dropout_add_ln_bwd_plain(x, hh, gamma, dy, 1e-5, 99, p, DP_B0)
    held("layernorm_bwd", got[:2], ref[:2])
    masks("layernorm (dh's zeros)", got[1] != 0, ref[1] != 0,
          L.dropout_add_ln_bwd_plain(x, hh, gamma, dy, 1e-5, 99, p)[1] != 0)

    # The plain draws' cost at world 2: a rank draws the global batch's
    # (64, 499, 768) uniforms where one process's rank-sized share would be
    # (32, 499, 768) (HuBERT's feature-projection and hidden dropouts).
    from triad_tpu_torch.ops.dropout import ShardGenerator, global_rand

    gen = ShardGenerator("cuda", (1, 2)).manual_seed(0)
    plain = torch.Generator(device="cuda").manual_seed(0)
    shape = (TRAIN_B // 2, 499, 768)
    ms_global, ms_local = time_fns([lambda: global_rand(shape, gen, "cuda"),
                                    lambda: torch.rand(shape, generator=plain, device="cuda")])
    print(f"  a rank's plain dropout draw at (32, 499, 768), keyed on global rows: "
          f"{ms_global:.4f} ms against {ms_local:.4f} ms for its own rows alone", flush=True)
    return {"global_draw_ms": ms_global, "local_draw_ms": ms_local}


RING_B = 32  # 20c's global batch (cut from phase 8's 64 for the script's time)


def _joint_once(mesh, negatives="all_gather", b=TRAIN_B):
    """Phase 8's joint step once (its seeded start, batches and seeds at
    global batch ``b``, every group unfrozen, accumulation 1), through
    StepFactory(mesh=mesh) (this rank's rows of the batch): (metrics,
    parameters after the update on the host, parameters before it)."""
    from triad_tpu_torch.config import OptimConfig, perf_train_loss_config
    from triad_tpu_torch.train.step import StepFactory

    ocfg = OptimConfig(gradient_accumulation_steps=1, unfreeze_audio_step=0,
                       unfreeze_text_step=0, unfreeze_vit_step=0)
    state = _new_state(ocfg, 1)
    rows = slice(None)
    if mesh is not None:
        from triad_tpu_torch.train.optim import OptimizerBank

        state.bank = OptimizerBank(ocfg, state.model, total_updates=1000, mesh=mesh, zero1=True)
        per = b // mesh.size
        rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    loss_cfg = dataclasses.replace(perf_train_loss_config(), negatives=negatives)
    step = StepFactory(loss_cfg, ocfg, mesh=mesh).make_step("joint")
    av = {k: v[rows].cuda() for k, v in _av_batch(b, 5).items()}
    tv = {k: v[rows].cuda() for k, v in _train_batch(b, 6).items()}
    init = {n: p.detach().to("cpu", copy=True) for n, p in state.model.named_parameters()}
    _, m = step(state, av, tv, 0.5, 0.5)
    params = {n: p.detach().to("cpu", copy=True) for n, p in state.model.named_parameters()}
    metrics = {k: float(v) for k, v in m.items()}
    del state, step
    torch.cuda.empty_cache()
    return metrics, params, init


def dp_ring_rank():
    """20c's ranks (``chip_smoke.py --dp-ring-rank`` under torchrun, gloo):
    phase 8's joint step on this rank's rows from its seeded start, once
    with the gathered negatives and once with the ring; rank 0 holds the
    two (_dp_hold "ring") and prints the result as a line "DP_RING {...}"."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.parallel.distributed import initialize_from_env
    from triad_tpu_torch.parallel.dp import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_from_env("cuda")
    kernels.library()
    mesh = make_mesh()
    gather_m, gather_p, init = _joint_once(mesh, b=RING_B)
    ring_m, ring_p, _ = _joint_once(mesh, "ring", RING_B)
    if mesh.rank == 0:
        keys = ("loss_av", "loss_tv", "train_loss")
        lr_max = max(v for k, v in gather_m.items() if k.startswith("lr_"))
        held = _dp_hold("ring vs all_gather at world 2, one step", "ring",
                        {k: ring_m[k] for k in keys}, {k: gather_m[k] for k in keys}, ring_p,
                        gather_p, init, lr_max, 1)
        print("DP_RING " + json.dumps(held), flush=True)
    torch.distributed.destroy_process_group()


def dp_phase(root):
    """Phase 20: data parallelism. 20d the dropout kernels at b0 > 0; 20a
    NCCL at world size 1 in this process (phase 8's joint step through
    StepFactory(mesh=...), held to the one-process step, every joint
    kernel launched); 20b cli.train as two gloo processes on the card
    (torchrun, mesh.num_devices=2, ZeRO-1) on phase 17's files, held per
    step and in its final parameters to the same config in one process;
    the world-2 step-2 checkpoint resumed in one process for steps 3-4;
    each rank's moment bytes; 20c the ring negatives at world 2 against
    the gathered ones (two ranks started beside 20b). Returns the summary
    and 20a's launch counts."""
    import shutil

    from triad_tpu_torch import kernels
    from triad_tpu_torch.cli import train as train_cli
    from triad_tpu_torch.parallel.distributed import initialize_from_env
    from triad_tpu_torch.parallel.dp import make_mesh

    t_phase = time.perf_counter()
    out = {}
    phase("20d. the dropout kernels for the rows of rank 1 (b0 = 32)")
    out["draws"] = dropout_offset_cases()

    phase("20a. NCCL at world size 1: phase 8's joint step through StepFactory(mesh=...)")
    want_m, want_p, init = _joint_once(None)
    saved_env = {k: os.environ.get(k) for k in ("TRIAD_COORDINATOR", "TRIAD_NUM_PROCESSES",
                                                "TRIAD_PROCESS_ID", "TRIAD_DIST_BACKEND")}
    os.environ.update(TRIAD_COORDINATOR=f"127.0.0.1:{_free_port()}", TRIAD_NUM_PROCESSES="1",
                      TRIAD_PROCESS_ID="0", TRIAD_DIST_BACKEND="nccl")
    try:
        rank, world = initialize_from_env("cuda")
        backend = torch.distributed.get_backend()
        print(f"  initialize_from_env: rank {rank} of {world}, backend {backend}", flush=True)
        if (rank, world, backend) != (0, 1, "nccl"):
            fail("initialize_from_env did not bring up NCCL at world size 1")
        kernels.reset_launches()
        got_m, got_p, _ = _joint_once(make_mesh(1))
        launches = dict(kernels.LAUNCHES)
        torch.distributed.destroy_process_group()
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _check_launches(launches, JOINT_KERNELS, "world-1 NCCL joint")
    loss_keys = ("loss_av", "loss_tv", "train_loss")
    lr_max = max(v for k, v in want_m.items() if k.startswith("lr_"))
    out["nccl_world1"] = _dp_hold(
        "world 1 (NCCL) vs one process", "nccl_world1",
        {k: got_m[k] for k in loss_keys}, {k: want_m[k] for k in loss_keys}, got_p, want_p,
        init, lr_max, 1)
    del got_p, want_p, init
    torch.cuda.empty_cache()

    phase(f"20b. cli.train as two gloo ranks on the card (torchrun, mesh.num_devices=2, ZeRO-1) "
          f"against one process: B = {TRAIN_B} ({TRAIN_B // 2} a rank), accumulation 2, "
          f"{DP_EPOCHS * DP_STEPS} steps, saves at 2 and 4; the step-2 save resumed in one "
          "process")
    cfg_path = _dp_config(root)
    run2, run1, run_r = (os.path.join(root, n) for n in ("dp_world2", "dp_one", "dp_resumed"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("TRIAD_")}
    env["TRIAD_DIST_BACKEND"] = "gloo"
    t_ring = time.perf_counter()
    ring_log = os.path.join(ROOT, "chiprun_out", "dp_ring.txt")
    with open(ring_log, "w") as log:  # 20c, beside 20b
        ring = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc_per_node", "2", os.path.join(ROOT, "chip_smoke.py"),
                                 "--dp-ring-rank"], cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT, text=True)
    moments = _world2(cfg_path, run2)
    args = ["--config", cfg_path, "--steps", str(DP_STEPS)]
    t0 = time.perf_counter()
    with _StartState() as start, _NoSaves():
        one = train_cli.main(args + ["--output-dir", run1, "--force-new"])
    out["one_process_s"] = time.perf_counter() - t0
    final1 = _params(one)
    init = {k: v for k, v in start.state.items() if k in final1}
    one_bytes = one.bank.moment_bytes()
    del one, start
    torch.cuda.empty_cache()
    lines2, lines1 = _run_metrics(run2), _run_metrics(run1)
    lr_max = _lr_max(lines1)
    final2 = _checkpoint(run2, 2 * DP_STEPS)[0]["model"]
    out["world2"] = _dp_hold("world 2 (gloo) vs one process", "world2", _losses_by_step(lines2),
                             _losses_by_step(lines1), final2, final1, init, lr_max, 2)
    print(f"  AdamW moments: rank 0 {moments[0]} bytes, rank 1 {moments[1]} bytes, one process "
          f"{one_bytes} bytes ({moments[0] / one_bytes:.3f}, {moments[1] / one_bytes:.3f} of "
          "it)", flush=True)
    if max(moments.values()) > 0.6 * one_bytes:
        fail("ZeRO-1: a rank holds more than 0.6 of the one-process moments")
    out["moment_bytes"] = {"rank0": moments[0], "rank1": moments[1], "one_process": one_bytes}
    out["step_ms"] = {"world2_rank0": _logged_step_ms(lines2), "one_process": _logged_step_ms(lines1)}
    print(f"  ms per step (the Trainer's, logged): world 2 rank 0 {out['step_ms']['world2_rank0']}, "
          f"one process {out['step_ms']['one_process']}", flush=True)

    # the world-2 run's directory up to its step-2 save, by hard links
    shutil.copytree(run2, run_r, copy_function=os.link)
    shutil.rmtree(os.path.join(run_r, "checkpoints", "ckpts", str(2 * DP_STEPS)))
    os.remove(os.path.join(run_r, "metrics.jsonl"))  # appended to: a copy of its own
    shutil.copy(os.path.join(run2, "metrics.jsonl"), run_r)
    t0 = time.perf_counter()
    with _NoSaves():
        resumed = train_cli.main(args + ["--output-dir", run_r])
    out["resume_s"] = time.perf_counter() - t0
    if resumed.timings["restore"] == []:
        fail("the one-process run did not resume the world-2 checkpoint")
    final_r = _params(resumed)
    del resumed
    torch.cuda.empty_cache()
    lines_r = _run_metrics(run_r)
    after = {s: v for s, v in _losses_by_step(lines_r).items() if s >= DP_STEPS}
    out["resumed"] = _dp_hold(
        "the world-2 step-2 checkpoint resumed in one process, steps 3-4, vs world 2", "world2",
        after, {s: v for s, v in _losses_by_step(lines2).items() if s >= DP_STEPS},
        final_r, final2, init, lr_max, 1)

    phase("20c. the ring negatives at world 2 against the all-gathered ones: phase 8's joint "
          f"step, B = {RING_B} ({RING_B // 2} a rank), from one start (two ranks started "
          "beside 20b)")
    ring.wait(timeout=600)
    with open(ring_log) as f:
        text = f.read()
    print("\n".join(line for line in text.splitlines() if line.startswith("  ring")),
          flush=True)
    held = [line for line in text.splitlines() if line.startswith("DP_RING ")]
    if ring.returncode != 0 or not held:
        fail(f"the ring ranks exited {ring.returncode}: {text[-3000:]}")
    out["ring"] = json.loads(held[0][len("DP_RING "):])
    out["ring_s"] = time.perf_counter() - t_ring
    print(f"  the ring's two ranks: {out['ring_s']:.1f} s from their start beside 20b",
          flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 20: {out['phase_s']:.1f} s", flush=True)
    return out, {"dp_nccl_world1": launches}


# ---------------------------------------------------------------------------
# Phase 21: tensor parallelism and FSDP
# ---------------------------------------------------------------------------

TP_B = 8  # global batch (16 until the script's time asked for a cut: PERF.md)
# Each knob at the value resolve_xla_impls gives "auto": no hand-written
# kernel takes a shard (JAX: a pallas_call is opaque to GSPMD).
TP_PLAIN_KNOBS = {"attention_impl": "xla", "mlp_impl": "xla", "ln_impl": "xla",
                  "frontend_impl": "conv", "posconv_impl": "conv"}
TP_LEGS = {  # leg: (ranks, mesh overrides)
    "21a": (2, ["mesh.tp=2"]),
    "21b": (2, ["mesh.fsdp=true"]),
    "21c": (4, ["mesh.tp=2", "mesh.num_slices=2"]),
}


def _tp_config(root):
    """Phase 21's config: phase 20's (dp.json: full_joint, 2 epochs of 2
    steps, accumulation 2, ZeRO-1, no validation set) at global B = TP_B,
    every impl knob on the plain route."""
    with open(_dp_config(root)) as f:
        cfg = json.load(f)
    cfg["data"].update(batch_size_av=TP_B, batch_size_tv=TP_B)
    for enc in ("vit", "hubert", "text"):
        sub = cfg["model"][enc]
        sub.update({k: v for k, v in TP_PLAIN_KNOBS.items() if k in sub})
    path = os.path.join(root, "tp.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


# The layers tensor parallelism splits (parallel/tp.py), by module name.
TP_ROW_LAYERS = ("out_proj", "out_lin", "output_dense", "fc2")
TP_COLUMN_LAYERS = ("q_proj", "k_proj", "v_proj", "q_lin", "k_lin", "v_lin", "intermediate_dense",
                    "fc1")


def _mm32(a, b):
    """a @ b of two bf16 matrices as one GEMM with an fp32 output."""
    return torch.mm(a, b, out_dtype=torch.float32)


class _SplitColumnGrad(torch.autograd.Function):
    """x W^T + b whose input gradient sums ``parts`` slices of the output
    dim, each accumulated in fp32, in fp32, and rounds once (a column shard
    pair's backward)."""

    @staticmethod
    def forward(ctx, x, w, b, parts):
        ctx.save_for_backward(x, w)
        ctx.parts = parts
        return torch.nn.functional.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        g2 = g.reshape(-1, g.shape[-1])
        n = w.shape[0] // ctx.parts
        dx = dw = db = None
        if need_x:
            dx = sum(_mm32(g2[:, i * n:(i + 1) * n], w[i * n:(i + 1) * n])
                     for i in range(ctx.parts)).to(x.dtype).reshape(x.shape)
        if need_w:
            dw = g2.t() @ x.reshape(-1, x.shape[-1])
        if need_b:
            db = g2.sum(0)
        return dx, dw, db, None


class _SplitRow(torch.autograd.Function):
    """x W^T as the sum, in fp32, of ``parts`` slices of the input dim,
    each one GEMM with an fp32 output (a row shard set's product); the
    backward runs each slice's products in the input dtype."""

    @staticmethod
    def forward(ctx, x, w, parts):
        ctx.save_for_backward(x, w)
        ctx.parts = parts
        x2, k = x.reshape(-1, x.shape[-1]), w.shape[1] // parts
        y = sum(_mm32(x2[:, i * k:(i + 1) * k], w[:, i * k:(i + 1) * k].t())
                for i in range(parts))
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        k = w.shape[1] // ctx.parts
        g2, x2 = g.to(x.dtype).reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1])
        cols = [slice(i * k, (i + 1) * k) for i in range(ctx.parts)]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.cat([g2 @ w[:, c] for c in cols], 1).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = torch.cat([g2.t() @ x2[:, c] for c in cols], 1)
        return dx, dw, None


class _TpRounding:
    """While active, one process's encoders round as ``parts`` tensor-parallel
    shards do, every product otherwise the plain one: a row layer sums its
    products over ``parts`` slices of its input in fp32 and casts once, a
    column layer sums its input gradient over ``parts`` slices of its
    output so. Built on torch.mm alone (_SplitRow, _SplitColumnGrad), not
    on the port's tensor-parallel layers. Phase 21's reference of the same
    arithmetic for 21a / 21c's update cosine: the Trainers made while it is
    active mark their layers."""

    def __init__(self, parts):
        self.parts = parts

    def __enter__(self):
        from triad_tpu_torch.models.layers import Dense
        from triad_tpu_torch.train.trainer import Trainer

        self.forward, self.init = Dense.forward, Trainer.__init__
        parts, plain, init = self.parts, self.forward, self.init

        def forward(layer, x):
            kind, d = getattr(layer, "tp_rounding", None), layer.compute_dtype
            if kind is None or d == torch.float32:
                return plain(layer, x)
            x, w = x.to(d), layer.weight.to(d)
            if kind == "column":
                return _SplitColumnGrad.apply(x, w, layer.bias.to(d), parts)
            return (_SplitRow.apply(x, w, parts) + layer.bias.to(torch.float32)).to(d)

        def mark(trainer, *args, **kwargs):
            init(trainer, *args, **kwargs)
            for name, m in trainer.model.named_modules():
                leaf = name.rsplit(".", 1)[-1]
                if isinstance(m, Dense) and leaf in TP_ROW_LAYERS + TP_COLUMN_LAYERS:
                    m.tp_rounding = "row" if leaf in TP_ROW_LAYERS else "column"

        Dense.forward, Trainer.__init__ = forward, mark
        return self

    def __exit__(self, *exc):
        from triad_tpu_torch.models.layers import Dense
        from triad_tpu_torch.train.trainer import Trainer

        Dense.forward, Trainer.__init__ = self.forward, self.init


def train_rank(final, args):
    """A rank of phase 21 (``chip_smoke.py --train-rank FINAL ARGS`` under
    torchrun, gloo): cli.train with ARGS and TF32 off; FINAL ("-": none)
    receives rank 0's whole parameters after the run (a gather over the
    ranks), and then the run writes no checkpoint (_NoSaves: only 21c's
    are read). Writes the run directory's
    train_rank<R>.json: {rank, launches, seconds, memory}: the kernel
    launches of the run; the seconds to the first step, of the training
    and of the gather and save; the rank's bytes of parameters and AdamW
    moments and its peak."""
    import contextlib

    from triad_tpu_torch import kernels
    from triad_tpu_torch.cli import train as train_cli

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.reset_launches()
    with _StartState() as start, (_NoSaves() if final != "-" else contextlib.nullcontext()):
        trainer = train_cli.main(args)
    t1 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    if final != "-":
        whole = trainer.bank.model_state_dict()
        if trainer.primary:
            torch.save({k: v.to("cpu") for k, v in whole.items()}, final)
    seconds = {"to_first_step": start.startup_s, "train": t1 - t0 - start.startup_s,
               "gather_save": time.perf_counter() - t1}
    rank = torch.distributed.get_rank()
    params = trainer.model.parameters()
    memory = {"parameters": sum(p.numel() * p.element_size() for p in params),
              "AdamW moments": trainer.bank.moment_bytes(),
              "peak memory": torch.cuda.max_memory_allocated()}
    with open(os.path.join(trainer.output_dir, f"train_rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "launches": launches, "seconds": seconds, "memory": memory}, f)
    torch.distributed.destroy_process_group()


def _tp_start(leg, cfg_path, run_dir, final):
    """TP_LEGS[leg] as gloo ranks of ``train_rank`` on the one card
    (torchrun), started: (process, start time)."""
    ranks, sets = TP_LEGS[leg]
    env = {k: v for k, v in os.environ.items() if not k.startswith("TRIAD_")}
    env["TRIAD_DIST_BACKEND"] = "gloo"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(ranks), os.path.join(ROOT, "chip_smoke.py"), "--train-rank", final, "--config",
           cfg_path, "--steps", str(DP_STEPS), "--output-dir", run_dir, "--force-new", "--set",
           f"mesh.num_devices={ranks}", *sets]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), time.perf_counter()


def _tp_finish(leg, proc, t0, run_dir):
    """Wait for a leg's ranks: (their reports, summed launches, seconds).
    A rank that fails fails the phase."""
    stdout, stderr = proc.communicate(timeout=900)
    seconds = time.perf_counter() - t0
    text = stdout + "\n--- stderr ---\n" + stderr
    with open(os.path.join(ROOT, "chiprun_out", f"tp_{leg}.txt"), "w") as f:
        f.write(text)
    ranks, sets = TP_LEGS[leg]
    paths = [os.path.join(run_dir, f"train_rank{r}.json") for r in range(ranks)]
    if proc.returncode != 0 or not all(os.path.exists(p) for p in paths):
        fail(f"{leg}: the {ranks} ranks exited {proc.returncode}: {text[-3000:]}")
    reports = []
    for path in paths:
        with open(path) as f:
            reports.append(json.load(f))
    launches = {}
    for r in reports:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    split = reports[0]["seconds"]
    print(f"  {leg} ({ranks} ranks, {' '.join(sets)}): {seconds:.1f} s (rank 0: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in split.items())
          + f"), log chiprun_out/tp_{leg}.txt", flush=True)
    return reports, launches, seconds


def _leg_memory(reports, one):
    """Each rank's bytes at rest (parameters, AdamW moments) and peak,
    printed beside one process's."""
    got = {what: {r["rank"]: r["memory"][what] for r in reports} for what in one}
    for what, by_rank in got.items():
        print(f"    {what}: " + ", ".join(f"rank {r} {b} ({b / one[what]:.3f})"
                                          for r, b in sorted(by_rank.items()))
              + f"; one process {one[what]}", flush=True)
    return got


def tp_phase(root):
    """Phase 21: tensor parallelism and FSDP on phase 20's Trainer config
    (B = TP_B, the plain impls): one process in this process, and again with
    its split layers rounding as tp = 2's shards do (_TpRounding); 21a
    mesh.tp = 2 as two gloo ranks, 21b mesh.fsdp as two, 21c tp = 2 x 2
    slices as four (all three side by side, beside the one-process runs),
    each held per step and in its final
    parameters (phase 20's world-2 bounds) to the plain one process, and
    in its update cosine: 21b to the plain run, 21a and 21c to the run at
    their rounding (their cosine against the plain run printed); each
    rank's bytes and peak; 21c's checkpoint holds whole tensors under
    one-process names and shapes, and its step-2 save resumes in one
    process; 21d an explicit kernel knob at tp = 2
    exits non-zero with JAX's resolve_xla_impls text. No kernel launches in
    any of it. Returns the summary and the launch counts."""
    import shutil

    from triad_tpu_torch import kernels
    from triad_tpu_torch.cli import train as train_cli

    t_phase = time.perf_counter()
    out = {}
    cfg_path = _tp_config(root)
    refused_dir = os.path.join(root, "tp_refused")
    refusal = subprocess.Popen(  # 21d, beside the one-process run
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "triad_tpu_torch.cli.train", "--config", cfg_path, "--output-dir", refused_dir,
         "--force-new", "--set", "mesh.num_devices=2", "mesh.tp=2", "model.hubert.mlp_impl=fused"],
        cwd=ROOT, env={**{k: v for k, v in os.environ.items() if not k.startswith("TRIAD_")},
                       "TRIAD_DIST_BACKEND": "gloo"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    # 21a, 21b and 21c (eight ranks) start first and run beside the
    # one-process runs, their references
    legs = ("21a", "21b", "21c")
    started = {}
    for leg in legs:
        final = os.path.join(root, f"tp_{leg}_final.pt") if leg != "21c" else "-"
        started[leg] = (_tp_start(leg, cfg_path, os.path.join(root, f"tp_{leg}"), final), final)

    phase(f"21. one process: phase 20's Trainer config at B = {TP_B}, the plain impls, "
          f"{DP_EPOCHS * DP_STEPS} steps, accumulation 2 (beside 21a-c's ranks)")
    args = ["--config", cfg_path, "--steps", str(DP_STEPS)]
    run1 = os.path.join(root, "tp_one")
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _StartState() as start, _NoSaves():
        one = train_cli.main(args + ["--output-dir", run1, "--force-new"])
    out["one_process_s"] = time.perf_counter() - t0
    launches = {"one_process": dict(kernels.LAUNCHES)}
    final1 = _params(one)
    init = {k: v for k, v in start.state.items() if k in final1}
    shapes1 = {k: tuple(v.shape) for k, v in one.model.state_dict().items()}
    one_mem = {"parameters": sum(p.numel() * p.element_size() for p in one.model.parameters()),
               "AdamW moments": one.bank.moment_bytes(),
               "peak memory": torch.cuda.max_memory_allocated()}
    del one, start
    torch.cuda.empty_cache()
    lines1 = _run_metrics(run1)
    want_losses = _losses_by_step(lines1)
    lr_max = _lr_max(lines1)
    out["one_process_step_ms"] = _logged_step_ms(lines1)
    print(f"  one process: {out['one_process_s']:.1f} s, update steps (ms, logged) "
          f"{out['one_process_step_ms']}, {one_mem}", flush=True)
    # The reference of tp = 2's arithmetic for the update cosine: the same
    # run with each split layer rounding as a shard pair does (_TpRounding,
    # on torch.mm alone). Against the plain run tp = 2's update cosine is
    # 0.9668 (PERF.md §6): the row sums' other rounding flips Adam's
    # sign-like early steps on near-zero gradients. The plain run still
    # holds 21a and 21c's losses and parameters.
    run_s = os.path.join(root, "tp_one_split")
    t0 = time.perf_counter()
    kernels.reset_launches()
    with _TpRounding(2), _NoSaves():
        split = train_cli.main(args + ["--output-dir", run_s, "--force-new"])
    launches["one_process_split"] = dict(kernels.LAUNCHES)
    final_s = _params(split)
    del split
    torch.cuda.empty_cache()
    losses_s = _losses_by_step(_run_metrics(run_s))
    out["split_rounding_s"] = time.perf_counter() - t0
    out["split_vs_plain"] = _dp_hold("one process at tp = 2's rounding vs plain", "world2",
                                     losses_s, want_losses, final_s, final1, init, lr_max, 2,
                                     ("losses", "parameters"))
    plain = ("one process", want_losses, final1, HOLD_ALL)
    refs = {"21a": [plain[:3] + (("losses", "parameters"),),
                    ("one process at tp = 2's rounding", losses_s, final_s, HOLD_ALL)],
            "21b": [plain]}
    refs["21c"] = refs["21a"]

    phase(", ".join(legs) + ". " + "; ".join(
        f"{leg}: {' '.join(TP_LEGS[leg][1])} as {TP_LEGS[leg][0]} gloo ranks" for leg in legs)
        + " (side by side), against one process")
    for leg in legs:
        (proc, t0), final = started[leg]
        reports, launches[leg], seconds = _tp_finish(leg, proc, t0,
                                                     os.path.join(root, f"tp_{leg}"))
        out[leg] = _tp_leg(leg, root, reports, final, refs[leg], init, lr_max, shapes1, one_mem)
        out[leg]["seconds"] = seconds

    phase("21c'. 21c's step-2 checkpoint resumed in one process (at tp = 2's rounding) for steps "
          "3-4")
    run_c, run_r = os.path.join(root, "tp_21c"), os.path.join(root, "tp_resumed")
    shutil.copytree(run_c, run_r, copy_function=os.link)
    shutil.rmtree(os.path.join(run_r, "checkpoints", "ckpts", str(2 * DP_STEPS)))
    os.remove(os.path.join(run_r, "metrics.jsonl"))
    shutil.copy(os.path.join(run_c, "metrics.jsonl"), run_r)
    kernels.reset_launches()
    with _TpRounding(2), _NoSaves():
        resumed = train_cli.main(args + ["--output-dir", run_r])
    launches["resumed"] = dict(kernels.LAUNCHES)
    if resumed.timings["restore"] == []:
        fail("the one-process run did not resume 21c's checkpoint")
    final_r = _params(resumed)
    del resumed
    torch.cuda.empty_cache()
    after = {s: v for s, v in _losses_by_step(_run_metrics(run_r)).items() if s >= DP_STEPS}
    out["resumed_vs_plain"] = _dp_hold(
        "21c's step-2 save resumed in one process, steps 3-4, vs the uninterrupted plain one "
        "process", "world2", after, {s: v for s, v in want_losses.items() if s >= DP_STEPS},
        final_r, final1, init, lr_max, 2, ("losses", "parameters"))
    out["resumed"] = _dp_hold("21c's step-2 save resumed in one process at tp = 2's rounding, "
                              "steps 3-4, vs the uninterrupted one process at that rounding",
                              "world2", after,
                              {s: v for s, v in losses_s.items() if s >= DP_STEPS},
                              final_r, final_s, init, lr_max, 2)
    shutil.rmtree(run_r)
    shutil.rmtree(run_c)

    phase("21d. mesh.tp = 2 with model.hubert.mlp_impl = 'fused': refused")
    text = refusal.communicate(timeout=600)[0]
    with open(os.path.join(ROOT, "chiprun_out", "tp_21d.txt"), "w") as f:
        f.write(text)
    want = ("mesh.tp > 1 requires XLA impls; hubert.mlp_impl='fused' is a pallas path "
            "(allowed: ['xla'] or 'auto')")
    print(f"  exit {refusal.returncode}; JAX's text in its output {want in text}; run "
          f"directory written {os.path.exists(refused_dir)}", flush=True)
    if refusal.returncode == 0 or want not in text or os.path.exists(refused_dir):
        fail(f"21d: the kernel knob was not refused: {text[-2000:]}")
    out["refused"] = {"returncode": refusal.returncode}

    total = {}
    for counts in launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    print(f"  kernel launches in phase 21: {sum(total.values())} ({total})", flush=True)
    if any(total.values()):
        fail("a hand-written kernel launched on the tensor-parallel / FSDP path")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 21: {out['phase_s']:.1f} s", flush=True)
    return out, {"tp_fsdp_legs": {k: total.get(k, 0) for k in kernels.LAUNCHES}}


def _tp_leg(leg, root, reports, final, refs, init, lr_max, shapes1, one_mem):
    """One leg against its one-process references ``refs`` [(what, losses,
    parameters, held checks)]: per-step losses and the final update
    (phase 20's world-2 bounds); 21c's step-4 checkpoint holds whole tensors under
    one-process names and shapes; each rank's bytes and peak; rank 0's
    logged update steps."""
    import shutil

    run_dir = os.path.join(root, f"tp_{leg}")
    lines = _run_metrics(run_dir)
    if final == "-":
        payload, _ = _checkpoint(run_dir, 2 * DP_STEPS)
        got = payload["model"]
        shapes = {k: tuple(v.shape) for k, v in got.items()}
        moments = [(_group_names(g, shapes1)[int(i)], tuple(st["exp_avg"].shape))
                   for g, sd in payload["opts"].items() for i, st in sd["state"].items()]
        bad = [n for n, sh in moments if sh != shapes1[n]]
        print(f"  {leg}'s step-4 checkpoint: {len(shapes)} tensors, one-process names and shapes "
              f"{shapes == shapes1}; {len(moments)} moments whole {not bad}", flush=True)
        if shapes != shapes1 or bad or not moments:
            fail(f"{leg}'s checkpoint is not a one-process file: {bad[:5]}")
    else:
        got = torch.load(final, map_location="cpu", weights_only=True)
        os.remove(final)
        shutil.rmtree(run_dir)
    out = {}
    for what, want_losses, want, held in refs:
        out[what] = _dp_hold(f"{leg} vs {what}", "world2", _losses_by_step(lines), want_losses,
                             got, want, init, lr_max, 2, held)
    out.update(step_ms=_logged_step_ms(lines), memory=_leg_memory(reports, one_mem))
    print(f"    update steps (ms, logged, rank 0): {out['step_ms']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 22: HuBERT's remat policies, bf16 Adam moments, the Trainer from
# an MP4 folder
# ---------------------------------------------------------------------------

REMAT_LOSS_REL = 2e-3  # 22a: chunked against whole frontend, per-step losses
LOWP_B = 16  # 22d: phase 8's joint step at this batch, 2 updates
# 22e: the reference's segment folders of cv2-written, PCM-muxed mp4s
MP4_SEGMENTS, MP4_CLIPS, MP4_FRAMES, MP4_B, MP4_STEPS = 2, 8, 10, 4, 3
# tensors whose gradient is 0 up to rounding (the softmax ignores a key bias)
KEY_BIASES = ("k_proj.bias", "k_lin.bias")


def remat_whole_leg(chunked):
    """22a: Path A's 6 micro steps from the same start at remat "none" (the
    whole frontend, every activation kept for the backward) against phase
    10's chunked run ``chunked`` = (median ms, (peak, base), losses,
    parameters after the steps): both medians and peaks; the per-step
    losses on the start's weights (the first accumulation window) within
    REMAT_LOSS_REL (only the statistics' summation order differs); the
    first update's parameters within one Adam step (2 lr + 1e-6) of each
    other, their update cosine printed, and the losses after it printed
    (Adam's first, sign-like step turns gradients that are 0 up to
    rounding into steps of lr either way, which moves the later losses by
    some 1e-3)."""
    from triad_tpu_torch.config import default_train_config

    model, _, launches, ms, (peak, base), losses, init, run = _default_steps("none")
    if model.audio_backbone.feature_extractor.chunked():
        fail("remat 'none' ran the chunked frontend")
    bank = run[1].bank
    lr_max = max(bank.schedules[g](0) for g in bank.schedules)
    init = {n: p.cpu() for n, p in init.items()}
    whole = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    del model, run, bank
    torch.cuda.empty_cache()
    c_ms, (c_peak, c_base), c_losses, c_after = chunked
    rel = [max(abs(a[k] - b[k]) / abs(b[k]) for k in b) for a, b in zip(c_losses, losses)]
    accum = default_train_config().train.optim.gradient_accumulation_steps
    dot = n1 = n2 = far = 0.0
    for n, p0 in init.items():
        u1, u2 = (c_after[n] - p0).double(), (whole[n] - p0).double()
        dot, n1, n2 = dot + float((u1 * u2).sum()), n1 + float((u1 * u1).sum()), n2 + float(
            (u2 * u2).sum())
        far = max(far, float((c_after[n] - whole[n]).abs().max()))
    cos = dot / max((n1 * n2) ** 0.5, 1e-300)
    bound = 2 * lr_max + 1e-6
    print(f"  chunked (phase 10) / whole: median micro step {c_ms:.3f} / {ms:.3f} ms; peak "
          f"{c_peak / 2 ** 30:.3f} / {peak / 2 ** 30:.3f} GiB, above the start "
          f"{(c_peak - c_base) / 2 ** 30:.3f} / {(peak - base) / 2 ** 30:.3f} GiB (drop "
          f"{((peak - base) - (c_peak - c_base)) / 2 ** 30:.3f} GiB); per-step losses, "
          f"relative: {', '.join(f'{r:.3g}' for r in rel)}: worst {max(rel[:accum]):.3g} on the "
          f"start's weights (bound {REMAT_LOSS_REL}); the first update: cosine {cos:.6f}, "
          f"largest parameter difference {far:.3g} (bound {bound:.3g})", flush=True)
    if not (max(rel[:accum]) <= REMAT_LOSS_REL and far <= bound):
        fail("the chunked and the whole frontend's steps disagree")
    return {"chunked_ms": c_ms, "whole_ms": ms, "chunked_peak_bytes": c_peak,
            "whole_peak_bytes": peak, "chunked_above_start_bytes": c_peak - c_base,
            "whole_above_start_bytes": peak - base, "loss_rel": rel, "update_cos": cos,
            "max_param_diff": far}, launches


def _joint_grads(model_cfg, seed=1):
    """One B = REF_B joint step's total loss and every parameter's gradient
    (all groups trainable), training mode from the seeded init ``seed``
    with step_generator(0, 0) and HostSeeds(0, 0); the launch counts
    during its forward and backward; the model."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.config import OptimConfig, perf_train_loss_config
    from triad_tpu_torch.ops.dropout import HostSeeds
    from triad_tpu_torch.train.step import StepFactory, step_generator

    model = _initial_model(model_cfg, seed)
    model.requires_grad_(True)
    av = {k: v.cuda() for k, v in _av_batch(REF_B, 23).items()}
    tv = {k: v.cuda() for k, v in _train_batch(REF_B, 24).items()}
    factory = StepFactory(perf_train_loss_config(), OptimConfig())
    kernels.reset_launches()
    total, _ = factory.compute_losses(model, av, tv, step_generator(0, 0, "cuda"), train=True,
                                      seeds=HostSeeds(0, 0))
    total.backward()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return float(total.detach()), grads, launches, model


def _group_cosines(got, want, overall=False):
    """The cosine of ``got`` to ``want`` ({name: tensor}) over each
    optimizer group's tensors (over all of them as "all" with
    ``overall``)."""
    from triad_tpu_torch.train.optim import label_for_path

    dots = {}
    for n, w in want.items():
        a, b = got[n].double().ravel(), w.double().ravel()
        d = dots.setdefault("all" if overall else label_for_path(n), [0.0, 0.0, 0.0])
        d[0] += float(a @ b)
        d[1] += float(a @ a)
        d[2] += float(b @ b)
    return {g: d[0] / max((d[1] * d[2]) ** 0.5, 1e-300) for g, d in dots.items()}


def conv_act_remat_leg():
    """22b: the B = REF_B joint step at full width with HuBERT's "conv_act"
    frontend under the default remat (chunked: one "norm_gelu" and six
    "gelu" activation launches a pass-B block, again in the block's
    recompute) against the same step on "conv" (the chunked plain-conv
    route of the same function), rates 0. Held within phase 12's bound
    between two frontends (4 bf16 ulps of the largest magnitude): the two
    frontends' features on the batch, and the loss. Gradients: every
    group's and every frontend tensor's at cosine 0.998 (conv_0's weight
    gradient is a sum that cancels, the GroupNorm being blind to each
    channel's scale, so bf16 rounding moves it by some percent of its
    norm: 4.4% in a CPU rehearsal at narrow width); each frontend tensor's
    largest difference printed."""
    from triad_tpu_torch.config import perf_train_model_config
    from triad_tpu_torch.models.hubert import normalize_waveform

    def cfg(impl):
        return _rates_off(perf_train_model_config(), frontend_impl=impl)

    wave = normalize_waveform(_av_batch(REF_B, 23)["audio"].cuda())
    act_loss, act, launches, model = _joint_grads(cfg("conv_act"))
    with torch.no_grad():
        f_act = model.audio_backbone.feature_extractor(wave)
    del model
    h = cfg("conv_act").hubert
    blocks = -(-h.num_audio_tokens(AUDIO) // h.frontend_chunk_tokens)
    want = 2 * blocks * len(h.conv_dim)
    conv_loss, conv, conv_launches, model = _joint_grads(cfg("conv"))
    with torch.no_grad():
        f_conv = model.audio_backbone.feature_extractor(wave)
    del model
    print(f"  conv_act: frontend_activation launched {launches['frontend_activation']} times "
          f"(predicted {want}: {blocks} blocks x {len(h.conv_dim)} passes, forward and "
          f"recompute); conv: {conv_launches['frontend_activation']}", flush=True)
    if launches["frontend_activation"] != want or conv_launches["frontend_activation"]:
        fail("the chunked conv_act frontend's activation launches")
    err, mx = max_err(f_act, f_conv)
    rel = abs(act_loss - conv_loss) / abs(conv_loss)
    front = {n: (float((act[n] - w).abs().max() / w.abs().max()),
                 _group_cosines({"x": act[n]}, {"x": w}, True)["all"])
             for n, w in conv.items() if ".feature_extractor." in n}
    cos = _group_cosines(act, conv)
    print(f"  features conv_act vs conv {tuple(f_act.shape)}: max abs difference {err:.4g} "
          f"(bound 4 bf16 ulps of {mx:.4g}); loss {act_loss:.6f} vs {conv_loss:.6f} (rel "
          f"{rel:.3g}, bound {4 * BF16_ULP:.4g}); group gradient cosines "
          f"{json.dumps({g: round(c, 6) for g, c in cos.items()})}; frontend gradients "
          "(largest difference over largest magnitude, cosine): "
          + ", ".join(f"{n.split('feature_extractor.')[1]} {r:.3g} {c:.6f}"
                      for n, (r, c) in front.items()), flush=True)
    if not (err <= 4 * BF16_ULP * mx and rel <= 4 * BF16_ULP
            and min(cos.values()) >= 0.998 and min(c for _, c in front.values()) >= 0.998):
        fail("the chunked conv_act step disagrees with the chunked conv step")
    del act, conv, f_act, f_conv
    torch.cuda.empty_cache()
    return {"launches_activation": launches["frontend_activation"], "predicted": want,
            "features_err": err, "loss_rel": rel, "group_cos": cos, "frontend_grads": front}, \
        launches


def full_remat_leg():
    """22c: the B = REF_B joint step at full width with every dropout live
    at remat "full" (the whole frontend and each HuBERT layer checkpointed,
    each layer's draws replayed in its recompute) against remat "none",
    same seeds and generator: every gradient bit-equal; the HuBERT-only
    forward kernels (layernorm, the frontend's) launched twice as often,
    the attention and MLP forwards once more per HuBERT layer run, the
    backward kernels as often."""
    from triad_tpu_torch.config import perf_train_model_config

    def cfg(remat):
        c = perf_train_model_config()
        return dataclasses.replace(c, hubert=dataclasses.replace(c.hubert, remat=remat))

    full_loss, full, launches, _ = _joint_grads(cfg("full"))
    none_loss, none, none_launches, _ = _joint_grads(cfg("none"))
    differ = [n for n in none if not torch.equal(full[n], none[n])]
    layers = none_launches["layernorm"] // 2  # two a HuBERT layer that ran
    twice = ("layernorm", "frontend_conv0", "frontend_stats", "frontend_conv")
    once_more = ("attention_train", "fused_mlp")
    same = ("attention_train_bwd", "fused_mlp_bwd", "layernorm_bwd", "posconv", "posconv_dx",
            "posconv_dw")
    bad = [k for k in twice if launches[k] != 2 * none_launches[k] or not none_launches[k]]
    bad += [k for k in once_more if launches[k] != none_launches[k] + layers]
    bad += [k for k in same if k in launches and launches[k] != none_launches[k]]
    print(f"  loss full {full_loss:.6f} / none {none_loss:.6f}; {len(none)} gradients, "
          f"{len(none) - len(differ)} bit-equal; launches full / none: "
          + ", ".join(f"{k} {launches[k]} / {none_launches[k]}" for k in twice + once_more + same
                      if k in launches) + f" ({layers} HuBERT layers ran)", flush=True)
    if differ:
        worst = {n: float((full[n] - none[n]).abs().max() / none[n].abs().max().clamp_min(1e-30))
                 for n in differ[:10]}
        fail(f"remat 'full' changed {len(differ)} gradients: {worst}")
    if full_loss != none_loss or bad:
        fail(f"remat 'full': loss {full_loss} vs {none_loss}, launches off for {bad}")
    n_grads = len(none)
    del full, none
    torch.cuda.empty_cache()
    return {"gradients_bit_equal": n_grads, "hubert_layers_run": layers}, launches


def lowp_moments_leg(root):
    """22d: phase 8's joint step config at B = LOWP_B, one process, every
    group unfrozen, 2 updates, with fp32 and with bf16 Adam moments from the
    same start: the moments' bytes (bf16 0.500 of fp32), the update cosine
    per group and overall against the fp32 run, the largest parameter
    difference; the bf16 run saved through CheckpointManager and restored
    into a new OptimizerBank: its moments bf16 and bit-equal."""
    import shutil

    from triad_tpu_torch import kernels
    from triad_tpu_torch.config import OptimConfig, perf_train_loss_config
    from triad_tpu_torch.train.checkpoint import CheckpointManager, HostProgress
    from triad_tpu_torch.train.optim import OptimizerBank, label_for_path
    from triad_tpu_torch.train.step import StepFactory, TrainState

    av = {k: v.cuda() for k, v in _av_batch(LOWP_B, 5).items()}
    tv = {k: v.cuda() for k, v in _train_batch(LOWP_B, 6).items()}
    runs, init = {}, None
    kernels.reset_launches()
    for dtype in ("float32", "bfloat16"):
        ocfg = _unfrozen(OptimConfig(gradient_accumulation_steps=1, mu_dtype=dtype,
                                     nu_dtype=dtype))
        state = _new_state(ocfg, 1)
        if init is None:
            init = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        step = StepFactory(perf_train_loss_config(), ocfg).make_step("joint")
        print(f"  {dtype} moments:", flush=True)
        _run_steps(step, state, (av, tv, 0.5, 0.5), ("loss_av", "loss_tv"), 2, 2)
        runs[dtype] = state, ocfg
    launches = dict(kernels.LAUNCHES)
    (s32, _), (s16, ocfg16) = runs["float32"], runs["bfloat16"]
    b32, b16 = s32.bank.moment_bytes(), s16.bank.moment_bytes()
    dtypes = {str(st[k].dtype) for opt in s16.bank.opts.values() for st in opt.state.values()
              for k in ("exp_avg", "exp_avg_sq")}
    p32 = {n: p.detach() for n, p in s32.model.named_parameters()}
    p16 = {n: p.detach() for n, p in s16.model.named_parameters()}
    upd32 = {n: p32[n] - init[n] for n in init}
    upd16 = {n: p16[n] - init[n] for n in init}
    moved = {n for n in init if bool(upd32[n].any())}
    cos = _group_cosines({n: upd16[n] for n in moved}, {n: upd32[n] for n in moved})
    overall = _group_cosines({n: upd16[n] for n in moved}, {n: upd32[n] for n in moved},
                             True)["all"]
    far = max(float((p16[n] - p32[n]).abs().max()) for n in init)
    lr_max = max(s32.bank.schedules[g](c) for g, c in s32.bank.counts.items())
    print(f"  moment bytes bf16 / fp32: {b16} / {b32} = {b16 / b32:.3f} (dtypes {sorted(dtypes)}); "
          f"update cosine to the fp32 run by group {json.dumps({g: round(c, 6) for g, c in cos.items()})}, "
          f"overall {overall:.6f}; largest parameter difference {far:.3g}", flush=True)
    if b16 * 2 != b32 or dtypes != {"torch.bfloat16"} or not overall >= 0.99:
        fail("bf16 moments: bytes, dtypes or the update's direction")
    del s32, runs, p32, upd32, upd16
    torch.cuda.empty_cache()

    ckpt = os.path.join(root, "lowp_ckpt")
    mgr = CheckpointManager(ckpt)
    t0 = time.perf_counter()
    mgr.save(2, s16, HostProgress(global_step=2), {})
    save_s = time.perf_counter() - t0
    model = _initial_model(s16.model.cfg, 1)
    fresh = TrainState(model, OptimizerBank(ocfg16, model, total_updates=1000), 0, 0)
    t0 = time.perf_counter()
    mgr.restore(fresh)
    restore_s = time.perf_counter() - t0
    checked = 0
    for g, opt in s16.bank.opts.items():
        for name, p, q in zip(s16.bank.names[g], s16.bank.groups[g], fresh.bank.groups[g]):
            if p not in opt.state:
                continue
            for k in ("exp_avg", "exp_avg_sq"):
                a, b = opt.state[p][k], fresh.bank.opts[g].state[q][k]
                if b.dtype != torch.bfloat16 or not torch.equal(a, b):
                    fail(f"restored {name} {k}: {b.dtype}, bit-equal {torch.equal(a, b.to(a.dtype))}")
                checked += 1
    shutil.rmtree(ckpt, ignore_errors=True)
    print(f"  saved in {save_s:.2f} s, restored into a new OptimizerBank in {restore_s:.2f} s: "
          f"{checked} moments bf16 and bit-equal", flush=True)
    del s16, fresh, model
    torch.cuda.empty_cache()
    return {"moment_bytes": {"float32": b32, "bfloat16": b16}, "ratio": b16 / b32,
            "update_cos": cos, "update_cos_overall": overall, "max_param_diff": far,
            "lr_max": lr_max, "restored_moments": checked}, launches


class _DecodeCounts:
    """While active, counts what the data layer's decoders produce: frames
    decoded by cv2 and by the native libavcodec path (data/video.py), audio
    tracks and samples demuxed natively (data/mp4.py), and failures."""

    def __enter__(self):
        from triad_tpu_torch.data import mp4, video

        self.n = {"cv2_frames": 0, "native_frames": 0, "native_audio_tracks": 0,
                  "native_audio_samples": 0, "failures": 0}
        lock = threading.Lock()
        self._orig = [(video, "_decode_random_frame_cv2"),
                      (video, "_decode_random_frame_native"), (mp4, "extract_audio_track")]
        self._orig = [(mod, name, getattr(mod, name)) for mod, name in self._orig]

        def counted(fn, key):
            def call(*args, **kw):
                try:
                    out = fn(*args, **kw)
                except Exception:
                    with lock:
                        self.n["failures"] += 1
                    raise
                with lock:
                    self.n[key] += 1
                    if key == "native_audio_tracks":
                        self.n["native_audio_samples"] += len(out[0])
                return out
            return call

        for (mod, name, fn), key in zip(self._orig, ("cv2_frames", "native_frames",
                                                     "native_audio_tracks")):
            setattr(mod, name, counted(fn, key))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)


def _mp4_folders(root):
    """The reference's segment layout, root/mp4/segment_N/clip_i.mp4: each
    clip MP4_FRAMES frames of 256^2 noise written by cv2.VideoWriter (mp4v)
    and muxed by data/mp4.py:mux_mp4 with 10 s of 16 kHz 'sowt' PCM (a
    tone of its own and noise)."""
    import cv2

    from triad_tpu_torch.data.mp4 import mux_mp4

    rng = np.random.default_rng(61)
    silent = os.path.join(root, "mp4_video_only.mp4")
    t = np.arange(AUDIO) / 16_000
    for seg in range(MP4_SEGMENTS):
        d = os.path.join(root, "mp4", f"segment_{seg}")
        os.makedirs(d)
        for i in range(MP4_CLIPS):
            writer = cv2.VideoWriter(silent, cv2.VideoWriter_fourcc(*"mp4v"), 1, (256, 256))
            for _ in range(MP4_FRAMES):
                writer.write(rng.integers(0, 256, (256, 256, 3), np.uint8))
            writer.release()
            tone = 200 + 40 * (seg * MP4_CLIPS + i)
            audio = (0.3 * np.sin(2 * np.pi * tone * t)
                     + 0.05 * rng.standard_normal(AUDIO)).astype(np.float32)
            mux_mp4(os.path.join(d, f"clip_{i}.mp4"), silent, audio, 16_000, audio_codec="sowt")
    os.remove(silent)
    return os.path.join(root, "mp4")


def mp4_trainer_leg(root):
    """22e: cli.train at full width (perf_train_model_config()) on an
    AudioVisualDataset of the reference's mp4 segment folders (video
    through the cv2 fallback, audio through the native PCM demux) and
    phase 17's caption folder: full_joint, B = MP4_B, MP4_STEPS steps,
    every group unfrozen, no saves. Every loss finite, every HuBERT tensor
    moved, each decoder's frames printed, no decode failure; the launch
    counts of the run."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.cli import train as train_cli
    from triad_tpu_torch.data import native

    t0 = time.perf_counter()
    mp4_root = _mp4_folders(root)
    write_s = time.perf_counter() - t0
    with open(os.path.join(root, "trainer.json")) as f:
        cfg = json.load(f)
    cfg["data"].update(audio_visual_data_root=mp4_root, audio_visual_val_data_root=None,
                       text_dataset_val_path=None, batch_size_av=MP4_B, batch_size_tv=MP4_B)
    cfg["train"].update(num_epochs=1, av_focus_epochs=0, tv_warmup_epochs=0,
                        weighted_joint_epochs=0, vis_every=10 ** 9, save_every_steps=10 ** 9)
    cfg["train"]["optim"].update(gradient_accumulation_steps=1, unfreeze_audio_step=0,
                                 unfreeze_text_step=0, unfreeze_vit_step=0)
    path, run = os.path.join(root, "mp4.json"), os.path.join(root, "run_mp4")
    with open(path, "w") as f:
        json.dump(cfg, f)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with _DecodeCounts() as counts, _StartState() as start, _NoSaves():
        trainer = train_cli.main(["--config", path, "--steps", str(MP4_STEPS), "--output-dir",
                                  run, "--force-new"])
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    losses = _losses_by_step(_run_metrics(run))
    moved = 0
    for name, p in trainer.model.named_parameters():
        if name.startswith("audio_backbone"):
            same = torch.equal(p.detach().cpu(), start.state[name])
            moved += not same
    n_audio = sum(1 for n, _ in trainer.model.named_parameters() if n.startswith("audio_backbone"))
    n = counts.n
    print(f"  {MP4_SEGMENTS} segment folders of {MP4_CLIPS} mp4s written in {write_s:.1f} s; "
          f"cli.train, {MP4_STEPS} steps of B = {MP4_B}: {run_s:.1f} s, losses "
          f"{json.dumps(losses)}; {moved} of {n_audio} HuBERT tensors moved; decoded: "
          f"{n['cv2_frames']} frames by cv2, {n['native_frames']} by the native libavcodec path "
          f"(avdec_supported {native.avdec_supported()}), {n['native_audio_tracks']} 'sowt' tracks "
          f"({n['native_audio_samples']} samples) by the native demux, {n['failures']} failures",
          flush=True)
    want = MP4_STEPS * MP4_B
    if not losses or not all(np.isfinite(v) for v in losses.values()):
        fail(f"the mp4 run's logged losses {losses}")
    if moved != n_audio:
        fail(f"{n_audio - moved} HuBERT tensors did not move in the mp4 run")
    if (n["failures"] or n["cv2_frames"] + n["native_frames"] < want
            or n["native_audio_tracks"] < want
            or n["native_audio_samples"] != AUDIO * n["native_audio_tracks"]):
        fail(f"the mp4 run's decoders: {n}")
    _check_launches(launches, JOINT_KERNELS, "mp4 trainer")
    del trainer, start
    torch.cuda.empty_cache()
    return {"write_s": write_s, "run_s": run_s, "losses": losses, "decoded": n}, launches


def remat_phase(root, chunked):
    """Phase 22: 22a-22e (above); returns the summary and the launch counts
    of each leg."""
    t_phase = time.perf_counter()
    out, launches = {}, {}
    phase(f"22a. Path A whole: configs/default.yaml's 6 micro steps at remat 'none', B = "
          f"{DEFAULT_B}, against phase 10's chunked frontend")
    out["path_a"], launches["default_noremat"] = remat_whole_leg(chunked)
    phase(f"22b. the chunked 'conv_act' frontend in training: a B = {REF_B} joint step at full "
          "width against the chunked 'conv' one")
    out["conv_act"], launches["remat_conv_act"] = conv_act_remat_leg()
    phase(f"22c. remat 'full' with every dropout live: a B = {REF_B} joint step at full width "
          "against remat 'none'")
    out["full"], launches["remat_full"] = full_remat_leg()
    phase(f"22d. bf16 Adam moments: phase 8's joint step at B = {LOWP_B}, 2 updates, against "
          "fp32 moments; a checkpoint round trip")
    out["lowp"], launches["lowp_moments"] = lowp_moments_leg(root)
    phase(f"22e. the Trainer from an MP4 folder: cli.train at full width on mp4 segment "
          f"folders, B = {MP4_B}")
    out["mp4"], launches["trainer_mp4"] = mp4_trainer_leg(root)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 22: {out['phase_s']:.1f} s", flush=True)
    return out, launches


def _group_names(group, shapes):
    """The parameter names of an optimizer group, in the bank's order."""
    from triad_tpu_torch.train.optim import label_for_path

    return [n for n in shapes if label_for_path(n) == group]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _kernel_entry(name, results, launches_by_path):
    src, replaces = KERNELS[name]
    cases = [r for r in results if r["name"] == name]
    head = next((r for r in cases if r["main"]), cases[0])
    keys = ("shape", "max_abs_err", "tol", "ms", "device_ms", "host_ms", "plain_ms", "library_ms",
            "library_device_ms", "composition_ms", "composition_device_ms", "bound_ms",
            "bound_by")
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": sum(counts[name] for counts in launches_by_path.values()),
        "launches_by_path": {path: counts[name] for path, counts in launches_by_path.items()
                             if counts[name]},
        **{k: head[k] for k in keys},
    }


# The kernels whose machine code must hold warpgroup products (HGMMA, from
# wgmma.mma_async) on tiles brought in by TMA (UTMALDG, from
# cp.async.bulk.tensor), and how many instantiations each has at least.
SASS_KERNELS = {"gemm_kernel": 2, "mlp_gemm_kernel": 7, "flash_fwd_kernel": 1,
                "flash_dkv_kernel": 1, "flash_dq_kernel": 1, "maxmean_dq_kernel": 6,
                "maxmean_dk_kernel": 6, "maxmean_fwd_kernel": 6, "posconv_kernel": 1}


def sass_check(path):
    """The Hopper kernels' machine code: every instantiation of
    conv_s2.cuh's gemm_kernel, of fused_mlp.cu's mlp_gemm_kernel, the
    flash forward, dK/dV and dQ kernels, maxmean.cu's forward, dQ and dK
    kernels (bf16 and split features, 3 widths each) and posconv.cu's
    forward must hold HGMMA and UTMALDG instructions. Counts them per kernel in
    cuobjdump's disassembly of the built library, beside the highest
    register the kernel's code names (past ptxas's launch count where a
    warpgroup raises its own with setmaxnreg)."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass: {sass.stderr.strip()[:500]}")
    counts, name = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if any(k in name for k in SASS_KERNELS):
                counts[name] = [0, 0, 0]
            else:
                name = None
        elif name is not None:
            counts[name][0] += "HGMMA" in line
            counts[name][1] += "UTMALDG" in line
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
            counts[name][2] = max([counts[name][2], *regs])
    for fn, (hgmma, tma, reg) in counts.items():
        print(f"  SASS {_kernel_name(fn)} {fn[-60:]}: {hgmma} HGMMA, {tma} UTMALDG, "
              f"highest register R{reg}", flush=True)
    for kernel, least in SASS_KERNELS.items():
        found = [c[:2] for fn, c in counts.items() if kernel in fn]
        if len(found) < least or not all(h and t for h, t in found):
            fail(f"{kernel}'s SASS lacks wgmma or TMA instructions: {found}")


def _kernel_name(mangled):
    """The name of the kernel a mangled symbol of ptxas's report holds:
    its length-prefixed identifier that ends in "kernel", the rightmost
    (an anonymous namespace's hash may hold digits that frame a false
    one before it)."""
    for i in reversed(range(len(mangled))):
        digits = re.match(r"\d+", mangled[i:])
        if digits:
            start = i + digits.end()
            name = mangled[start:start + int(digits.group())]
            if name.endswith("kernel") and name[:1].isalpha():
                return name
    return mangled[:60]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    if sys.argv[1:] == ["--dp-ring-rank"]:  # a rank of phase 20c, started by the script
        sys.path.insert(0, ROOT)
        dp_ring_rank()
        return
    if sys.argv[1:2] == ["--train-rank"]:  # a rank of phase 21, started by the script
        sys.path.insert(0, ROOT)
        train_rank(sys.argv[2], sys.argv[3:])
        return
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
    kernel = ""
    for line in kernels.build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = _kernel_name(line.split("'")[1])
        elif "Performance Loss" in line:  # a note that names its kernel
            named = re.search(r"function '([^']+)'", line)
            print(f"  {_kernel_name(named.group(1)) if named else kernel}: {line.strip()}",
                  flush=True)
        elif "registers" in line or "spill" in line:
            print(f"  {kernel}: {line.strip()}", flush=True)
    print(f"  built {os.path.relpath(path, ROOT)}", flush=True)
    sass_check(path)

    phase("3. kernels vs plain (bf16, CUDA events, median of 20; of 5-19 for a call of "
          "50 ms or more)")
    results, agree = kernel_phase()

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

    # The B = 4 step, bf16 card vs fp32 CPU. 9: on the weights phase 8
    # trained, the loss is held and the group cosines printed: there they
    # depend on the roundings that trained the weights (any kernel that
    # sums in another order trains others), and have failed at some init
    # seeds (PERF.md). 9b holds every group, the audio group's dW kernel
    # included, on the weights phase 8 started from, as 11c does.
    groups = ("others", "audio", "text", "vit_lora")
    av_ref, tv_ref = _av_batch(REF_B, 7), _train_batch(REF_B, 8)
    phase(f"9. joint train step at B = {REF_B}, rates 0, on the trained weights: bf16 card vs "
          "fp32 CPU")
    train_reference_phase(model, groups, av_ref, tv_ref, hold_groups=False)
    del model
    torch.cuda.empty_cache()
    phase("9b. the same step on the weights phase 8 started from (seed 1)")
    from triad_tpu_torch.config import perf_train_model_config

    train_reference_phase(_initial_model(perf_train_model_config(), 1), groups, av_ref, tv_ref)
    torch.cuda.empty_cache()

    phase(f"10. configs/default.yaml's joint step at full width, B = {DEFAULT_B}, accumulation "
          "4, dropouts live")
    model, loss_cfg, default_launches, default_ms, default_peak, default_losses, default_after = \
        default_phase()
    torch.cuda.empty_cache()
    phase(f"10b. its B = {REF_B} step, rates 0, HuBERT attention_impl 'fused': bf16 card vs "
          "fp32 CPU")
    train_reference_phase(model, groups, _av_batch(REF_B, 13), _train_batch(REF_B, 14, 128),
                          loss_cfg, {"attention_impl": "fused"})
    del model
    torch.cuda.empty_cache()

    phase(f"11. mqkv + vitmq + loss=pallas joint step at full width, B = {TRAIN_B}, dropouts live")
    model, loss_cfg, knobs_launches, knobs_ms, knobs_peak = knobs_phase()
    torch.cuda.empty_cache()
    # Path B's B = 4 step, training mode at rates 0, bf16 card vs fp32 CPU
    # (twins there). 11b: on the weights phase 11 trained, the loss and the
    # max-mean witness are held; the group cosines are printed, not held:
    # there the card's bf16 features move 6.4% of the TV loss's first
    # argmaxes away from the fp32 features' (the twins on either set of
    # features, PERF.md), and the text group's cosine with them (0.9857),
    # while the kernels match the twins on the card's own features
    # exactly. 11c holds every group on the weights phase 11 started from.
    av_ref, tv_ref = _av_batch(REF_B, 15), _train_batch(REF_B, 16)
    phase(f"11b. its B = {REF_B} step at rates 0 on the trained weights: bf16 card vs fp32 CPU, "
          "kernels vs twins on the card's features")
    train_reference_phase(model, groups, av_ref, tv_ref, loss_cfg, {}, hold_groups=False)
    del model
    torch.cuda.empty_cache()
    phase("11c. the same step on the weights phase 11 started from (seed 1)")
    train_reference_phase(_initial_model(model_cfg_knobs(), 1), groups, av_ref, tv_ref, loss_cfg,
                          {})
    torch.cuda.empty_cache()

    phase(f"12. 1000-way retrieval eval, head-pair attention and the pallas frontend, "
          f"perf_eval_model_config() at full width, N = {RETRIEVAL_N}")
    retrieval, retrieval_launches, conv_act_launches = retrieval_phase(RETRIEVAL_N)
    torch.cuda.empty_cache()

    phase(f"13. flash eval: perf_eval_model_config() with attention_impl 'flash' in all three "
          f"encoders, served at B = {B}")
    flash_eval, flash_eval_launches = flash_eval_phase()
    torch.cuda.empty_cache()

    phase(f"14. text-visual train step with the ViT on 'flash', full width, B = {TRAIN_B}")
    cfg = perf_train_model_config()
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, attention_impl="flash"))
    model, tv_flash_launches, tv_flash_ms = train_phase(cfg, FLASH_TV_KERNELS,
                                                        "tv_flash_profile.txt")
    print(f"  median of 3 timed steps: {tv_flash_ms:.3f} ms", flush=True)
    want = cfg.vit.num_layers * 5  # once per ViT layer in each of the 5 steps
    for name in ("flash_attention", "flash_attention_bwd"):
        if tv_flash_launches[name] != want:
            fail(f"{name}: {tv_flash_launches[name]} launches in 5 steps, not {want}")
    if tv_flash_launches["attention_train"] or tv_flash_launches["attention_train_bwd"]:
        fail("the training attention ran on the ViT-flash path")
    phase(f"14b. its B = {REF_B} step: bf16 card vs fp32 CPU")
    train_reference_phase(model, ("others", "text", "vit_lora"), None, _train_batch(REF_B, 4))
    del model
    torch.cuda.empty_cache()

    phase(f"15. 20 s clips past the old key cap: HuBERT at N = 999 on the eval attention, its "
          f"head-pair mode and flash, B = {B}")
    long_clip_launches = long_clip_phase()
    torch.cuda.empty_cache()

    phase(f"16. the joint step of phase 8 fed from files on disk (TriadPack shards, JPEG "
          f"captions) through the port's loaders, pinned-memory prefetchers and the device "
          f"augmentation, B = {TRAIN_B}, with a mid-epoch resume")
    data, fed_launches = data_phase(joint_ms)
    torch.cuda.empty_cache()

    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="triad_trainer_")
    try:
        phase(f"17. the Trainer through cli.train: the four-phase curriculum at full width from "
              f"files on disk, B = {TRAIN_B}, killed mid-epoch and resumed bit for bit; cli.eval")
        trainer, trainer_launches, trainer_eval_launches = trainer_phase(root)
        torch.cuda.empty_cache()

        phase(f"18. the Trainer from pretrained files (HF snapshots, a torch.hub DINOv2 file, a "
              f"reference checkpoint) at full width, B = {TRAIN_B}; cli.infer (bf16 and --int8) "
              f"and cli.viz")
        pretrained, pretrained_launches = pretrained_phase(root)
        torch.cuda.empty_cache()

        phase("19. the serving export at full width (configs/default.yaml's model): cli.export "
              "--random-init for cpu and cuda; cli.serve --bundle at B = 1, 3, 8 against the "
              "bundle's CPU programs and the live model; --run-dir of a 2-step default-yaml run; "
              "phase 17's run refused; --int8")
        export, export_launches = export_phase(root)
        torch.cuda.empty_cache()

        phase("20. data-parallel training: NCCL at world size 1, two gloo ranks of cli.train on "
              "the card against one process, a world-size-crossing resume, the ring, the "
              "dropout kernels at b0 > 0")
        dp, dp_launches = dp_phase(root)
        torch.cuda.empty_cache()

        phase(f"21. tensor parallelism and FSDP: phase 20's Trainer config at B = {TP_B} as "
              "tp = 2, FSDP and tp = 2 x 2 slices (gloo ranks on the card) against one process; "
              "a resume across layouts; a kernel knob refused")
        tp, tp_launches = tp_phase(root)
        torch.cuda.empty_cache()

        phase("22. HuBERT's remat policies and bf16 Adam moments: Path A chunked against whole, "
              "the chunked 'conv_act' frontend in training, remat 'full' with live dropout, bf16 "
              "moments and their checkpoint; the Trainer from an MP4 folder")
        remat, remat_launches = remat_phase(root, (default_ms, default_peak, default_losses,
                                                   default_after))
        del default_after
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    by_path = {"serve": serve_launches, "train_tv": tv_launches, "train_joint": joint_launches,
               "train_default": default_launches, "train_knobs": knobs_launches,
               "retrieval": retrieval_launches, "retrieval_conv_act": conv_act_launches,
               "flash_eval": flash_eval_launches, "train_tv_flash": tv_flash_launches,
               "long_clips": long_clip_launches, "train_joint_fed": fed_launches,
               "trainer": trainer_launches, "trainer_eval_legs": trainer_eval_launches,
               **pretrained_launches, **export_launches, **dp_launches, **tp_launches,
               **remat_launches}
    kernels_json = [_kernel_entry(name, results, by_path) for name in KERNELS]
    phase("done")
    # every shape of phase 3, too long for the line the kernels entries take
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_cases.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"kernels": kernels_json, "train_step_ms": tv_ms, "joint_step_ms": joint_ms,
                      "joint_peak_bytes": peak, "default_micro_step_ms": default_ms,
                      "default_peak_bytes": default_peak[0], "knobs_step_ms": knobs_ms,
                      "knobs_peak_bytes": knobs_peak, "layouts_agree": agree,
                      "retrieval": retrieval, "flash_eval": flash_eval,
                      "tv_flash_step_ms": tv_flash_ms, "data": data, "trainer": trainer,
                      "pretrained": pretrained, "export": export, "dp": dp, "tp": tp,
                      "remat": remat}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
