"""The port's Trainer data-parallel on the CPU: ``cli.train`` as two gloo
processes (launched with the ``TRIAD_*`` variables, the coordinator on a
port the OS picked) against one process, at tests/test_trainer.py's tiny
size with global batches of 4 (2 rows a rank) and every dropout live.

(f) After one epoch of 3 steps the world-2 checkpoint holds the tensor
    names and shapes of the one-process one (whole AdamW moments though
    the run kept ZeRO-1 slices) and agrees with it within 1e-5 relative
    (the key biases, whose gradient is 0 up to rounding, within two Adam
    steps: tests/test_torch_zero1.py says why); resumed in one process
    for a second epoch, the world-2 checkpoint trains to the parameters
    of the one-process checkpoint resumed the same way, at the same
    tolerance.
(g) The epoch's validation and 1000-way retrieval metrics equal the
    one-process ones (atol 1e-6, as tests/test_trainer_dp.py), both runs
    scoring one subset.
(h) The JAX Trainer's mesh ValueErrors, with torch's world size, those
    of tensor parallelism and FSDP included.
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_trainer import port_config
from tests.test_trainer import tiny_config
from tests.torch_dp_worker import ROOT, computed_once

LR_MAX = 1e-4  # OptimConfig.learning_rate: every group's peak lr is at most this
SUBSET = {"retrieval_subset_av.json": [5, 0, 3, 6], "retrieval_subset_tv.json": [2, 7, 1, 4]}


def _config(run_dir, epochs):
    cfg = tiny_config(Path(run_dir).parent)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size_av=4,
                                                            batch_size_tv=4))
    return port_config(cfg, output_dir=str(run_dir), num_epochs=epochs)


def _prepare(run_dir):
    run_dir.mkdir(parents=True)
    for name, idx in SUBSET.items():
        (run_dir / name).write_text(json.dumps(idx))


def _train_world2(run_dir):
    """cli.train as two processes (TRIAD_* variables, gloo on the CPU)."""
    _prepare(run_dir)
    cfg_file = run_dir.parent / "world2.json"
    cfg_file.write_text(json.dumps(_config(run_dir, 1).to_dict()))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, TRIAD_COORDINATOR=f"127.0.0.1:{port}", TRIAD_NUM_PROCESSES="2",
                   TRIAD_PROCESS_ID=str(rank), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        env.pop("TRIAD_DIST_BACKEND", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "triad_tpu_torch.cli.train", "--config", str(cfg_file),
             "--device", "cpu", "--force-new", "--set", "mesh.num_devices=2"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out[-4000:]}"
    return outs


def _checkpoint(run_dir, step):
    d = Path(run_dir) / "checkpoints" / "ckpts" / str(step)
    return torch.load(d / "state.pt", weights_only=True)


def _metrics(run_dir):
    return [json.loads(line) for line in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]


def _runs(workdir):
    """Epoch 0 in one process (A) and in two (B); epoch 1 of each resumed in
    one process (A2, C). The resumed runs' schedules span both epochs."""
    from triad_tpu_torch.train.trainer import Trainer

    _prepare(workdir / "a")
    Trainer(_config(workdir / "a", 1), force_new_training=True, device="cpu").train()
    outs = _train_world2(workdir / "b")
    starts = []
    for src, dst in (("a", "a2"), ("b", "c")):
        shutil.copytree(workdir / src, workdir / dst)
        resumed = Trainer(_config(workdir / dst, 2), device="cpu")
        starts.append(resumed.progress.global_step)
        resumed.train()
    return {
        "a3": _checkpoint(workdir / "a", 3), "a6": _checkpoint(workdir / "a2", 6),
        "b3": _checkpoint(workdir / "b", 3), "c6": _checkpoint(workdir / "c", 6),
        "metrics_a": _metrics(workdir / "a"), "metrics_b": _metrics(workdir / "b"),
        "starts": starts, "logs_b": outs,
        "b_files": sorted(str(p.relative_to(workdir / "b"))
                          for p in (workdir / "b").rglob("*") if p.is_file()),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return computed_once(tmp_path_factory, "torch_trainer_dp", _runs)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _key_bias_entries():
    """The payload entries of the attention key biases (parameters,
    gradients, AdamW states): their gradient is 0 up to rounding (the
    softmax ignores them), so their moments are rounding noise and Adam
    moves them by about lr at its sign."""
    from triad_tpu_torch.models.convert import init_triad_model
    from triad_tpu_torch.train.optim import GROUPS, label_for_path

    cfg = _config(Path("unused") / "run", 1)
    names = [n for n, _ in init_triad_model(cfg.model, torch.Generator().manual_seed(0),
                                            device="meta").named_parameters()]
    biases = [n for n in names if n.endswith(("k_proj.bias", "k_lin.bias"))]
    out = {f"{part}/{n}" for n in biases for part in ("model", "grads")}
    for g in GROUPS:
        group = [n for n in names if label_for_path(n) == g]
        out |= {f"opts/{g}/state/{i}/" for i, n in enumerate(group) if n in biases}
    return out


def _assert_close(got, want, what):
    """Two checkpoint payloads: the same entries and shapes; parameters and
    gradients within 1e-5 relative (key biases within two Adam steps),
    AdamW moments within 1e-4 relative (a square doubles the error), the
    counts and steps equal."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    biases = _key_bias_entries()
    for key, ref in want.items():
        mine = got[key]
        if not isinstance(ref, torch.Tensor):
            assert mine == ref, (what, key)
            continue
        if key.endswith("/step"):
            assert torch.equal(mine, ref), (what, key)
            continue
        assert mine.shape == ref.shape, (what, key)
        if key in biases or key.rsplit("/", 1)[0] + "/" in biases:
            if key.startswith("model/"):
                torch.testing.assert_close(mine, ref, rtol=0, atol=2 * LR_MAX,
                                           msg=f"{what} {key}")
        elif key.startswith("opts/"):
            torch.testing.assert_close(mine, ref, rtol=1e-4,
                                       atol=1e-6 * float(ref.abs().max()) + 1e-20,
                                       msg=f"{what} {key}")
        else:
            torch.testing.assert_close(mine, ref, rtol=1e-5, atol=1e-7, msg=f"{what} {key}")


def test_world2_checkpoint_is_the_one_process_one(runs):
    """Whole moments in the world-2 file (the run kept ZeRO-1 slices),
    agreeing with the one-process file."""
    b3, a3 = runs["b3"], runs["a3"]
    moments = [k for k in _flat(a3["opts"]) if k.endswith(("exp_avg", "exp_avg_sq"))]
    assert len(moments) > 20
    _assert_close(b3, a3, "step 3")


def test_resume_world2_in_one_process(runs):
    assert runs["starts"] == [3, 3]
    _assert_close(runs["c6"], runs["a6"], "step 6 (resumed from the world-2 step 3)")


def test_rank0_writes_one_run_directory(runs):
    files = runs["b_files"]
    assert "metrics.jsonl" in files
    assert "checkpoints/ckpts/3/state.pt" in files
    assert not any(".tmp" in f for f in files)
    assert any("Data-parallel over 2 replicas" in log for log in runs["logs_b"])


@pytest.mark.parametrize("prefix", ["val_", "retrieval_"])
def test_world2_eval_metrics_match(runs, prefix):
    """The end of epoch 0 (step 3): validation through the distributed eval
    loss, retrieval on each rank's share of every batch."""
    def at_step_3(lines):
        return {k: v for m in lines if m.get("global_step") == 3
                for k, v in m.items() if k.startswith(prefix)}

    a, b = at_step_3(runs["metrics_a"]), at_step_3(runs["metrics_b"])
    assert len(b) >= 4 and sorted(a) == sorted(b)
    for k in b:
        tol = 1e-6 if prefix == "retrieval_" else 1e-5 * abs(a[k]) + 1e-6
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=tol, err_msg=k)


# ---------------------------------------------------------------------------
# (h) the mesh section's refusals
# ---------------------------------------------------------------------------


def _mesh_config(tmp_path, **mesh):
    cfg = _config(tmp_path / "run", 1)
    return dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, **mesh))


_REFUSALS = ["batch", "no_mesh", "slices", "world", "tp", "fsdp", "tp_slices", "tp_batch",
             "ring_slices"]


@pytest.mark.parametrize("case", _REFUSALS)
def test_mesh_refusals(tmp_path, monkeypatch, case):
    """The JAX Trainer's mesh ValueErrors with torch's world size: "tp" and
    "fsdp" an explicit kernel knob (JAX's resolve_xla_impls text),
    "tp_slices" num_devices % (num_slices x tp), "tp_batch" a batch the
    data-parallel size (num_devices / tp) does not divide, "ring_slices"
    the ring negatives on a tuple axis (dp.py's error, raised here before
    anything is written)."""
    from triad_tpu_torch.parallel import collectives as C
    from triad_tpu_torch.train.trainer import Trainer

    world = {"batch": 2, "no_mesh": 2, "slices": 1, "world": 1, "tp": 2, "fsdp": 2,
             "tp_slices": 2, "tp_batch": 4, "ring_slices": 2}[case]
    monkeypatch.setattr(C, "world", lambda group=None: world)
    err = ValueError
    if case == "batch":
        cfg = _mesh_config(tmp_path, num_devices=2)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size_tv=3))
        text = "batch_size_tv=3 not divisible by the data-parallel size 2"
    elif case == "no_mesh":
        cfg = _mesh_config(tmp_path)
        text = ("multi-process run (torch.distributed world size 2 > 1) needs a device mesh: "
                "set mesh.num_devices to the GLOBAL chip count")
    elif case == "slices":
        cfg = _mesh_config(tmp_path, num_devices=3, num_slices=2)
        text = "mesh.num_devices=3 not divisible by num_slices(2) x tp(1)"
    elif case == "world":
        cfg = _mesh_config(tmp_path, num_devices=2)
        text = "mesh.num_devices=2 but torch.distributed runs 1 process"
    elif case in ("tp", "fsdp"):
        cfg = _mesh_config(tmp_path, num_devices=2, **({"tp": 2} if case == "tp"
                                                         else {"fsdp": True}))
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, vit=dataclasses.replace(cfg.model.vit, attention_impl="flash")))
        text = ("mesh.tp > 1 requires XLA impls; vit.attention_impl='flash' is a pallas path "
                "(allowed: ['xla'] or 'auto')")
    elif case == "tp_slices":
        cfg = _mesh_config(tmp_path, num_devices=2, num_slices=2, tp=2)
        text = "mesh.num_devices=2 not divisible by num_slices(2) x tp(2)"
    elif case == "tp_batch":
        cfg = _mesh_config(tmp_path, num_devices=4, tp=2)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size_av=3))
        text = "batch_size_av=3 not divisible by the data-parallel size 2"
    else:
        cfg = _mesh_config(tmp_path, num_devices=2, num_slices=2)
        cfg = dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss, negatives="ring"))
        text = "negatives='ring' supports a single mesh axis"
    with pytest.raises(err) as info:
        Trainer(cfg, force_new_training=True, device="cpu")
    assert text in str(info.value)
    assert not Path(cfg.train.output_dir).exists()  # raised before writing
