"""The benchmark of the port's training step: one cell, one run.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<config>.json``: the model, loss and optimizer
sections as they are run) and a traffic mix (``traffic/<traffic>.json``,
read by ``traffic.py``); its correctness limits are in
``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``. Nothing of a cell, a mix or a metric lives in
this file.

Set-up: the weights and a ring of batch pairs are made on the card from
the seed; the program's model, optimizer bank (every gated group past its
unfreeze step, its schedules at the traffic's step) and joint step are
built; the first micro steps, which the correctness check follows, run
through that step on the ring's first pairs, then the warm-up steps. The
window: a closed loop of the same step from a synchronise, one CUDA event
after each step, until the first step past ``--seconds`` that ends an
accumulation cycle, then a synchronise. A traced run (``--trace 1``) runs that window untraced
(the step's MFU is its rate), then a second one as long traced with the
card's activity alone (idle share, launches, copies, rooflines), then
two accumulation cycles traced with the host's ops too (the idle gaps'
labels). After them the program's state is freed and the plain
reference follows the checked micro steps from the same seed.
"""

from __future__ import annotations

import gc
import contextlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import check  # noqa: E402
import devtrace as TR  # noqa: E402
import traffic as T  # noqa: E402
from reference import draws as D  # noqa: E402
from reference import layout as LAYOUT  # noqa: E402
from reference import model as RM  # noqa: E402
from reference import train as RT  # noqa: E402

GROUPS = ("others", "audio", "text", "vit_lora")
# the seed of the window's dropout, SpecAugment and layerdrop draws
WINDOW_DROPOUT_SEED = 0
FORBIDDEN = ("jax", "jaxlib", "flax", "triad_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ------------------------------------------------------------------ spec


def load_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return SimpleNamespace(
        name=name, chips=w["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=T.load(w["traffic"]),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text())["limits"],
        per_layer=spec["per_layer"], end_to_end=spec["end_to_end"])


def counts_at(optim: dict, step: int) -> Dict[str, int]:
    """The bank's applied updates per group at micro step ``step`` of a run
    whose gated groups unfroze at their unfreeze steps."""
    acc = optim["gradient_accumulation_steps"]
    return {"others": step // acc, "vit_lora": step // acc,
            "audio": max(0, step - optim["unfreeze_audio_step"]) // acc,
            "text": max(0, step - optim["unfreeze_text_step"]) // acc}


def seeds_per_layer(cfg: dict) -> int:
    """Kernel seeds a kept HuBERT layer draws on the card."""
    h = cfg["hubert"]
    return (int(h["attention_dropout"] > 0) + 2 * int(h["hidden_dropout"] > 0)
            + int(h["activation_dropout"] > 0))


def kept_layers(cell, seed: int, step: int) -> List[int]:
    h = cell.config["model"]["hubert"]
    return D.kept_layers(seed, step, h["num_layers"], h["layerdrop"],
                         seeds_per_layer(cell.config["model"]))


# --------------------------------------------------------------- program


def program_configs(cell):
    from triad_tpu_torch.config import Config

    c = Config.from_dict({"model": cell.config["model"], "loss": cell.config["loss"],
                          "train": {"optim": cell.config["optim"]}})
    return c.model, c.loss, c.train.optim


def build_program(cell, seed: int, device):
    """The program's TrainState (model loaded with the seed's weights,
    optimizer bank at the traffic's step) and its joint step."""
    from triad_tpu_torch.models.multimodal import TriadModel
    from triad_tpu_torch.train.optim import OptimizerBank
    from triad_tpu_torch.train.step import StepFactory, TrainState

    model_cfg, loss_cfg, optim_cfg = program_configs(cell)
    tr = cell.traffic
    weights = LAYOUT.make_weights(cell.config["model"], seed, device)
    model = TriadModel(model_cfg, device=device)
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {n: tuple(w.shape) for n, w in weights.items()}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:6]
        raise RuntimeError(f"the program's parameters differ from the layout: {diff}")
    model.load_state_dict(weights, strict=True)
    del weights
    bank = OptimizerBank(optim_cfg, model, total_updates=tr["total_updates"])
    bank.counts = counts_at(cell.config["optim"], tr["start_step"])
    state = TrainState(model, bank, global_step=tr["start_step"], seed=seed)
    step = StepFactory(loss_cfg, optim_cfg).make_step(tr["mode"])
    return state, step


def trainable_names(state) -> List[str]:
    return [n for g in GROUPS for n in state.bank.names[g]]


@torch.no_grad()
def _first_grad(state) -> Dict[str, torch.Tensor]:
    """Each leaf's gradient as Adam got it at its first update, on the host:
    the first moment over (1 - beta1) (zero where the group took no
    step)."""
    out = {}
    for g, opt in state.bank.opts.items():
        b1 = opt.param_groups[0]["betas"][0]
        for name, p in zip(state.bank.names[g], state.bank.groups[g]):
            st = opt.state.get(p)
            grad = st["exp_avg"].float() / (1.0 - b1) if st else torch.zeros_like(p).float()
            out[name] = grad.cpu()
    return out


@torch.no_grad()
def _changes(cell, state, seed, device) -> Dict[str, float]:
    start = LAYOUT.make_weights(cell.config["model"], seed, device)
    params = dict(state.model.named_parameters())
    names = trainable_names(state)
    vals = torch.stack([(params[n] - start[n]).float().norm() for n in names]).tolist()
    del start
    return dict(zip(names, vals))


def checked_steps(cell, state, step, ring, seed: int) -> dict:
    """The micro steps the correctness check follows, through the window's
    own call on the ring's first pairs: the program's readings."""
    tr = cell.traffic
    acc = cell.config["optim"]["gradient_accumulation_steps"]
    losses, first = [], None
    for i in range(tr["check_micro_steps"]):
        gs = state.global_step
        av, tv = ring[i]
        state, m = step(state, av, tv, tr["w_av"], tr["w_tv"])
        losses.append((float(m["loss_av"]), float(m["loss_tv"])))
        if first is None and (gs + 1) % acc == 0:
            first = _first_grad(state)
    first = first or {}
    return {"losses": losses, "first_grads": first,
            "first_grad": {n: float(g.norm()) for n, g in first.items()},
            "change": _changes(cell, state, seed, ring[0][0]["audio"].device)}


def window(cell, state, step, ring, first: int, seconds: float, max_steps: int = 0,
           mark: bool = False) -> SimpleNamespace:
    """A closed-loop window of the step on the card from ring pair ``first``
    on, until the first step past ``seconds`` that ends an accumulation
    cycle (or the ``max_steps``-th), so that every window holds whole
    cycles. ``mark`` brackets it with marker kernels at each end and a
    host-side span, which the profiler's digest reads as its bounds."""
    tr = cell.traffic
    acc = cell.config["optim"]["gradient_accumulation_steps"]
    if state.global_step % acc:
        raise RuntimeError(f"the window starts inside an accumulation cycle: micro step "
                           f"{state.global_step}")
    n = len(ring)
    ctx = (torch.profiler.record_function(TR.WINDOW) if mark else contextlib.nullcontext())
    torch.cuda.synchronize()
    ctx.__enter__()
    if mark:
        TR.mark()
    t0 = time.perf_counter()
    events, losses, steps = [torch.cuda.Event(enable_timing=True)], [], []
    events[0].record()
    i = first
    while True:
        av, tv = ring[i % n]
        i += 1
        steps.append(state.global_step)
        state, m = step(state, av, tv, tr["w_av"], tr["w_tv"])
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        losses.append(m["train_loss"])
        if (time.perf_counter() - t0 >= seconds and len(steps) % acc == 0
                or len(steps) == max_steps):
            break
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if mark:
        TR.mark()
        torch.cuda.synchronize()
    ctx.__exit__(None, None, None)
    return SimpleNamespace(
        state=state, next=i, steps=len(steps), seconds=t1 - t0, step_ids=steps,
        intervals=[a.elapsed_time(b) for a, b in zip(events, events[1:])],
        bad=int((~torch.isfinite(torch.stack(losses))).sum()))


def percentile(values, q: float) -> float:
    """Linear interpolation between order statistics (numpy's default)."""
    v = sorted(values)
    k = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


# ------------------------------------------------------------- reference


def reference_readings(cell, seed: int, device, precision: str = "fp32") -> dict:
    """The plain reference over the checked micro steps, from the seed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = cell.traffic
    if tr["mode"] != "joint":
        raise NotImplementedError("the reference follows the joint step")
    cfg = cell.config["model"]
    weights = LAYOUT.make_weights(cfg, seed, device)
    ring = T.make_ring(tr, cfg["text"]["vocab_size"], seed, device)[:tr["check_micro_steps"]]
    return RT.run(RM.Precision(precision), weights, cfg, cell.config["loss"],
                  cell.config["optim"], ring, tr["w_av"], tr["w_tv"], seed, tr["start_step"],
                  counts_at(cell.config["optim"], tr["start_step"]), tr["total_updates"],
                  tr["check_micro_steps"], tr["reference_block"])


# --------------------------------------------------------------- metrics


def load_metric(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer_metrics(cell, ctx) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        value = load_metric(m["name"]).read(ctx)
        if value is None:
            log(f"metric {m['name']}: nothing to read")
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# ------------------------------------------------------------------ run


def prepare(cell, seed: int, device, breaker=None):
    """Set-up of a run: the ring, the program's state and step, and the
    checked micro steps through that step (the program's readings).
    ``breaker`` (tests and ``calibrate.py``) wraps the built step: the
    timed path with a fault planted underneath."""
    ring = T.make_ring(cell.traffic, cell.config["model"]["text"]["vocab_size"], seed, device)
    state, step = build_program(cell, seed, device)
    if breaker is not None:
        step = breaker(step)
    prog = checked_steps(cell, state, step, ring, seed)
    return state, step, ring, prog


def verdict(cell, seed: int, prog: dict, device, bad: int = 0):
    """(correct, {number: value and limit}, lines): the plain reference over
    the checked micro steps against the program's readings."""
    ref = reference_readings(cell, seed, device)
    nums = check.numbers(prog, ref)
    correct, lines = check.judge(nums, cell.limits)
    log("not compared: " + ", ".join(f"{k} {v:.6g} ({where})" for k, (v, where) in nums.items()
                                     if k not in cell.limits))
    lines.append(f"nonfinite_losses {bad} limit 0")
    shown = {k: {"value": v, "limit": cell.limits[k]} for k, (v, _) in nums.items()
             if k in cell.limits}
    shown["nonfinite_losses"] = {"value": bad, "limit": 0}
    return bool(correct and bad == 0), shown, lines


def _traced(cell, state, step, ring, first: int, seconds: float):
    """The per-layer readings: a window of ``seconds`` traced with the card's
    activity alone (the host's ops are not recorded, so the host runs as
    untraced), then one of two accumulation cycles traced with the host's
    ops too, whose idle gaps are labelled by what the host ran."""
    from torch.profiler import ProfilerActivity, profile
    from triad_tpu_torch import kernels

    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w = window(cell, state, step, ring, first, seconds, mark=True)
    launches = dict(kernels.LAUNCHES)
    dg = TR.digest(prof, w.seconds)
    del prof
    acc = cell.config["optim"]["gradient_accumulation_steps"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window(cell, w.state, step, ring, w.next, float("inf"), max_steps=2 * acc, mark=True)
    gaps = TR.digest(prof, 0.0).gaps
    del prof
    log(f"trace: {w.steps} steps in {w.seconds:.3f} s, {dg.kernels} kernels, busy "
        f"{dg.busy_s:.4f} of {dg.window_s:.4f} s")
    return w, dg, launches, gaps


def run_cell(cell, seed: int, seconds: float, trace: bool, t_start: float) -> dict:
    """Set-up, window, reference and comparison of one run on the card; the
    result line's object."""
    device = torch.device("cuda", 0)
    tr = cell.traffic
    state, step, ring, prog = prepare(cell, seed, device)
    # The window's random draws (dropout masks, SpecAugment, layerdrop) come
    # from one fixed seed, so that every run does the same work: layerdrop
    # sets how many HuBERT layers a step runs. The checked micro steps above
    # drew from the run's seed.
    state.seed = WINDOW_DROPOUT_SEED
    first = tr["check_micro_steps"]
    for i in range(tr["warmup_steps"]):
        state, _ = step(state, *ring[(first + i) % len(ring)], tr["w_av"], tr["w_tv"])
    first += tr["warmup_steps"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start
    w = window(cell, state, step, ring, first, seconds)
    peak = torch.cuda.max_memory_allocated()
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips, "memory_peak_bytes": peak}
    log(f"{cell.name} seed {seed}: {w.steps} steps in {w.seconds:.3f} s, median interval "
        f"{statistics.median(w.intervals):.3f} ms, set-up {setup_s:.3f} s, peak {peak} B")
    out: Dict[str, object] = {"correct": False, "attempted": w.steps, "failed": w.bad}
    if trace:
        tw, dg, launches, gaps = _traced(cell, w.state, step, ring, w.next, seconds)
        kept = [kept_layers(cell, WINDOW_DROPOUT_SEED, s) for s in tw.step_ids]
        ctx = SimpleNamespace(
            cell=cell, config=cell.config["model"], traffic=tr, log=log, steps=tw.steps,
            digest=dg, launches=launches, kept=kept,
            untraced=SimpleNamespace(steps=w.steps, seconds=w.seconds, kept=[
                kept_layers(cell, WINDOW_DROPOUT_SEED, s) for s in w.step_ids]))
        out["metrics"] = per_layer_metrics(cell, ctx)
        device_info.update(busy_s=dg.busy_s, window_s=dg.window_s)
        out["breakdown"] = {"device_ops": TR.top_ops(dg), "idle_gaps": gaps}
        out["failed"] = w.bad + tw.bad
    else:
        values = {"samples_per_s": w.steps * (tr["batch_av"] + tr["batch_tv"]) / w.seconds,
                  "step_ms_p95": percentile(w.intervals, 95.0),
                  "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                          for m in cell.end_to_end}
    out["device"] = device_info
    bad = out["failed"]
    del state, step, ring, w
    gc.collect()
    torch.cuda.empty_cache()
    out["correct"], out["check"], out["lines"] = verdict(cell, seed, prog, device, bad)
    return out


def run(name: str, seed: int, seconds: float, trace: bool, t_start: float) -> int:
    cell = load_cell(name)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        log(f"{name} needs {cell.chips} CUDA device(s); found {found}")
        return 2
    from triad_tpu_torch import kernels

    kernels.library()  # the nvcc build on a checkout's first run
    out = run_cell(cell, seed, seconds, trace, t_start)
    lines = out.pop("lines")
    loaded = forbidden_modules()
    if loaded:
        log(f"modules of JAX or the JAX package are loaded: {loaded}")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(out), flush=True)
    return 0
