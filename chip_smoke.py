"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA
kernels from triad_tpu_torch/csrc, checks each against its plain PyTorch
twin at the shapes of the serving and training paths, serves the
full-width perf_eval_model_config() TriadModel (random weights from a
seed) over HTTP and checks the answers, then trains the full-width
text-visual step of perf_train_model_config() for a few steps.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the last line):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. nvcc build of the kernels (one nvcc per source, in parallel);
  3. each kernel vs its plain twin on the card in bf16: max abs error
     against a stated bound, median time of both (CUDA events); the
     training kernels at B = 8 and at the train step's B = 64;
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
     in float32 on the CPU.
The line before the last is one JSON object with one entry per kernel:
its launches in the path that runs it (phase 4 or 6), and its error and
times at the first shape of phase 3, with every shape of phase 3 under
"cases". The last line is {"ok": true, "device": {...}}.
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
BF16_ULP = 2.0 ** -7


def phase(msg):
    print(f"== {msg}", flush=True)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def randn(shape, seed, scale=1.0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


def time_pair(kernel_fn, plain_fn, reps=20, warmup=3):
    """Median ms of each, timed alternately with CUDA events."""
    for _ in range(warmup):
        kernel_fn()
        plain_fn()
    torch.cuda.synchronize()
    times = {"k": [], "p": []}
    for _ in range(reps):
        for key, fn in (("k", kernel_fn), ("p", plain_fn)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[key].append(start.elapsed_time(end))
    return statistics.median(times["k"]), statistics.median(times["p"])


def max_err(got, ref):
    """(max abs error, its bound's base): over several outputs, the one
    whose error is largest against its own largest magnitude."""
    g = [got] if isinstance(got, torch.Tensor) else list(got)
    r = [ref] if isinstance(ref, torch.Tensor) else list(ref)
    pairs = [(float((a.float() - b.float()).abs().max()), float(b.float().abs().max()))
             for a, b in zip(g, r)]
    return max(pairs, key=lambda p: p[0] / max(p[1], 1e-30))


def compare(results, name, shape, kernel_fn, plain_fn, tol_rel):
    got = kernel_fn()
    torch.cuda.synchronize()
    ref = plain_fn()
    err, mx = max_err(got, ref)
    tol = tol_rel * mx
    ms, plain_ms = time_pair(kernel_fn, plain_fn)
    ok = err <= tol
    print(f"  {name:24s} {str(shape):28s} max_abs_err {err:.4g} (bound {tol:.4g}) "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} at {shape} disagrees with its plain version")
    results.append({"name": name, "shape": list(shape), "max_abs_err": err,
                    "bound": tol, "ms": ms, "plain_ms": plain_ms})


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
}
TRAIN_ONLY_KERNELS = ("attention_train", "attention_train_bwd", "fused_mlp_bwd")
TRAIN_KERNELS = TRAIN_ONLY_KERNELS + ("fused_mlp",)


def kernel_phase():
    from triad_tpu_torch.ops import attention as A
    from triad_tpu_torch.ops import frontend as FE
    from triad_tpu_torch.ops import mlp as M

    res = []
    # attention: HuBERT packed (B, 499, 768), ViT merged (B, 261, 2304);
    # 2 bf16 ulps of the largest output.
    q, k, v = (randn((B, 499, 768), s) for s in (1, 2, 3))
    mask = torch.ones((B, 499), device="cuda")
    compare(res, "attention_eval", (B, 499, 768),
            lambda: A.attention_eval(q, k, v, mask),
            lambda: A.attention_eval_plain(q, k, v, mask, 0.125), 2 * BF16_ULP)
    qkv = randn((B, 261, 2304), 4)
    ones = torch.ones((B, 261), device="cuda")
    compare(res, "attention_eval_merged", (B, 261, 2304),
            lambda: A.attention_eval_merged(qkv),
            lambda: A.attention_eval_plain(*qkv.split(768, dim=-1), ones, 0.125),
            2 * BF16_ULP)
    # fused MLP at both token counts and both GELU forms; 2 ulps.
    w1 = randn((3072, 768), 6, 768 ** -0.5)
    b1 = randn((3072,), 7, 0.1)
    w2 = randn((768, 3072), 8, 3072 ** -0.5)
    b2 = randn((768,), 9, 0.1)
    for n in (499, 261):
        x = randn((B, n, 768), 5)
        for form in ("tanh", "erf"):
            compare(res, "fused_mlp", (B, n, 768, form),
                    lambda: M.fused_mlp(x, w1, b1, w2, b2, form),
                    lambda: M.fused_mlp_plain(x, w1, b1, w2, b2, form), 2 * BF16_ULP)
    # frontend at (B, 160000): stats (fp32 sums in another order, 1e-4
    # of the largest variance), conv_0 and the stride-2 conv (2 ulps).
    rng = np.random.default_rng(11)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to("cuda")
    w0 = f(rng.standard_normal((512, 1, 10)) * (2 / 10) ** 0.5)
    gs = f(rng.standard_normal(512) * 0.2 + 1.0)
    gb = f(rng.standard_normal(512) * 0.1)
    ws = [f(rng.standard_normal((512, 512, kk)) * (2 / (kk * 512)) ** 0.5)
          for kk in FE.KERNELS[1:]]
    wave = randn((B, 160000), 12, dtype=torch.float32)
    compare(res, "frontend_stats", (B, 160000), lambda: FE.conv0_stats(wave, w0),
            lambda: FE.conv0_stats_plain(wave, w0), 1e-4)
    mean, var = FE.conv0_stats_plain(wave, w0)
    scale = torch.rsqrt(var + FE.GN_EPS) * gs
    bias = gb - mean * scale
    compare(res, "frontend_conv0", (B, 160000),
            lambda: FE.conv0_norm_gelu(wave, w0, scale, bias, "tanh"),
            lambda: FE.conv0_norm_gelu_plain(wave, w0, scale, bias, "tanh"), 2 * BF16_ULP)
    x1 = FE.conv0_norm_gelu_plain(wave, w0, scale, bias, "tanh")
    compare(res, "frontend_conv", (B, x1.shape[1], 512, "k3"),
            lambda: FE.conv_s2_gelu(x1, ws[0], "tanh"),
            lambda: FE.conv_s2_gelu_plain(x1, ws[0], "tanh"), 2 * BF16_ULP)
    # the whole stack, 7 bf16 layers: 4 ulps
    compare(res, "frontend (stack)", (B, 160000),
            lambda: FE.frontend(wave, w0, gs, gb, ws, "tanh"),
            lambda: FE.reference_frontend(wave, w0, gs, gb, ws, "tanh"), 4 * BF16_ULP)
    # training kernels at the ViT's shapes, at B and at the train step's
    # batch. Attention forward: both round the same fp32 P to bf16;
    # backward: the kernels carry fp32 P and dS as bf16 hi + lo halves; MLP
    # backward: dh rounds to bf16 from an fp32 dg summed in another order.
    # 2 bf16 ulps of each output's largest magnitude.
    for b in (B, TRAIN_B):
        q, k, v, do = (randn((b, 261, 768), s) for s in (13, 14, 15, 16))
        keys = torch.ones((b, 261), device="cuda")
        compare(res, "attention_train", (b, 261, 768),
                lambda: A.attention_train_fwd(q, k, v, keys, 0.125),
                lambda: A.attention_train_plain(q, k, v, keys, 0.125), 2 * BF16_ULP)
        compare(res, "attention_train_bwd", (b, 261, 768),
                lambda: A.attention_train_bwd(q, k, v, keys, do, 0.125),
                lambda: A.attention_train_bwd_plain(q, k, v, keys, do, 0.125), 2 * BF16_ULP)
        x, dy = randn((b, 261, 768), 17), randn((b, 261, 768), 18)
        for form in ("tanh", "erf"):
            compare(res, "fused_mlp_bwd", (b, 261, 768, form),
                    lambda: M.fused_mlp_bwd(x, w1, b1, w2, dy, form),
                    lambda: M.fused_mlp_bwd_plain(x, w1, b1, w2, dy, form), 2 * BF16_ULP)
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


def _step_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def train_phase():
    """The full-width text-visual step; returns the model, the launch
    counts of the steps and the median ms of the timed steps."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.config import OptimConfig, perf_train_loss_config, perf_train_model_config
    from triad_tpu_torch.models.convert import init_triad_model
    from triad_tpu_torch.train.optim import OptimizerBank
    from triad_tpu_torch.train.step import StepFactory, TrainState

    cfg, ocfg = perf_train_model_config(), OptimConfig(gradient_accumulation_steps=1)
    model = init_triad_model(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    state = TrainState(model, OptimizerBank(ocfg, model, total_updates=1000), 0, 1)
    step = StepFactory(perf_train_loss_config(), ocfg).make_step("tv")
    batch = {k: v.cuda() for k, v in _train_batch(TRAIN_B, 3).items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    times = []
    kernels.reset_launches()
    for i in range(5):
        (state, m), ms = _step_ms(lambda: step(state, None, batch))
        loss = float(m["loss_tv"])
        print(f"  step {i} ({'warm-up' if i < 2 else 'timed'}): loss_tv {loss:.6f}  "
              f"{ms:.3f} ms", flush=True)
        if not np.isfinite(loss):
            fail(f"train step {i}: loss {loss}")
        if i >= 2:
            times.append(ms)
    launches = dict(kernels.LAUNCHES)
    print(f"  launches during the steps: {launches}", flush=True)
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
    for name in TRAIN_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the training steps")
    profile_step(lambda: step(state, None, batch))
    return model, launches, statistics.median(times)


def profile_step(fn):
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
              for e in rows[:60]]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "train_profile.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join("  " + line for line in lines[:25]), flush=True)


def train_reference_phase(model):
    """One TV step's loss and per-group gradients at B = REF_B with every
    dropout off and DistilBERT unfrozen: the card in bf16 against the same
    weights in float32 on the CPU (plain versions there). The loss must
    agree to 5e-2 relative (a bf16 pass through 12 + 6 layers and the
    squared-sim regulariser) and each group's gradient at cosine > 0.99."""
    import dataclasses

    from triad_tpu_torch.config import OptimConfig, perf_train_loss_config
    from triad_tpu_torch.models.multimodal import TriadModel
    from triad_tpu_torch.train.optim import label_for_path
    from triad_tpu_torch.train.step import StepFactory

    cfg = dataclasses.replace(model.cfg, compute_dtype="float32")
    ref = TriadModel(cfg, device="cpu")
    ref.load_state_dict({k: p.detach().cpu() for k, p in model.state_dict().items()})
    batch = _train_batch(REF_B, 4)
    factory = StepFactory(perf_train_loss_config(), OptimConfig())

    def loss_and_grads(m, device):
        groups = ("others", "text", "vit_lora")
        for name, p in m.named_parameters():
            p.requires_grad_(label_for_path(name) in groups)
            p.grad = None
        total, _ = factory.compute_losses(m, None, {k: v.to(device) for k, v in batch.items()},
                                          None, train=False)
        total.backward()
        grads = {g: [] for g in groups}
        for name, p in m.named_parameters():
            if p.grad is not None:
                grads[label_for_path(name)].append(p.grad.detach().double().cpu().ravel())
        return float(total.detach()), {g: torch.cat(v) for g, v in grads.items()}

    loss, grads = loss_and_grads(model, "cuda")
    ref_loss, ref_grads = loss_and_grads(ref, "cpu")
    rel = abs(loss - ref_loss) / abs(ref_loss)
    print(f"  loss bf16 card {loss:.6f} vs fp32 CPU {ref_loss:.6f} (rel {rel:.3g}, bound 5e-2)",
          flush=True)
    if not rel < 5e-2:
        fail("training loss disagrees with the fp32 CPU reference")
    for g, want in ref_grads.items():
        got = grads[g]
        cos = float(got @ want / (got.norm() * want.norm()))
        print(f"  grad {g:8s} cosine {cos:.6f} over {want.numel()} values", flush=True)
        if not cos > 0.99:
            fail(f"{g} gradients disagree with the fp32 CPU reference")


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
    serving = ServingModel(load_config("perf_eval"), None, "cuda", 160_000, 128)
    n_params = sum(p.numel() for p in serving.model.parameters())
    print(f"  {n_params} parameters, random init from seed 0", flush=True)
    kernels.reset_launches()
    served = serve_phase(serving)
    serve_launches = dict(kernels.LAUNCHES)
    print(f"  launches during the requests: {serve_launches}", flush=True)
    reference_phase(serving, *served)

    phase("5. launch counts")
    for name in KERNELS:
        if name not in TRAIN_ONLY_KERNELS and serve_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the serving path")
    del serving
    torch.cuda.empty_cache()

    phase(f"6. text-visual train step, perf_train_model_config() at full width, B = {TRAIN_B}")
    model, train_launches, step_ms = train_phase()
    print(f"  median of 3 timed steps: {step_ms:.3f} ms", flush=True)

    phase(f"7. train step at B = {REF_B}: bf16 card vs fp32 CPU")
    train_reference_phase(model)

    kernels_json = []
    for name, (src, replaces) in KERNELS.items():
        cases = [r for r in results if r["name"] == name]
        kernels_json.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": serve_launches[name] + train_launches[name],
            "launches_by_path": {"serve": serve_launches[name], "train": train_launches[name]},
            "max_abs_err": cases[0]["max_abs_err"],
            "ms": cases[0]["ms"], "plain_ms": cases[0]["plain_ms"],
            "cases": [{k: r[k] for k in ("shape", "max_abs_err", "bound", "ms", "plain_ms")}
                      for r in cases],
        })
    print(json.dumps({"kernels": kernels_json, "train_step_ms": step_ms}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
