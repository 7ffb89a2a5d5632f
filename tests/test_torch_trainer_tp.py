"""The port's Trainer under tensor parallelism and FSDP on the CPU:
``cli.train`` as gloo processes (the ``TRIAD_*`` variables, the
coordinator on a port the OS picked) at tests/test_torch_trainer_dp.py's
size (tests/test_trainer.py's tiny model, global batches of 4, one epoch
of 3 steps, every dropout live), against that file's one-process run:

  * ``MeshConfig(num_devices=2, tp=2)``: one data index, two model ranks;
  * ``MeshConfig(num_devices=2, fsdp=True)``: two data ranks, ZeRO-1 on top;
  * ``MeshConfig(num_devices=4, tp=2, num_slices=2)``: (replica 2, data 1,
    model 2).

Each run's checkpoint holds the one-process run's tensor names and shapes
(whole tensors, though every rank kept slices) and agrees with it within
tests/test_torch_trainer_dp.py's bounds; resumed in one process for a
second epoch, it trains to the parameters of the one-process checkpoint
resumed the same way. The three worlds run side by side, once a session.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading

import pytest

from tests.test_torch_trainer_dp import _assert_close, _checkpoint, _config, _prepare, _runs
from tests.torch_dp_worker import ROOT, computed_once

MESHES = {"tp2": (2, ["mesh.tp=2"]), "fsdp": (2, ["mesh.fsdp=true"]),
          "tp2_slices": (4, ["mesh.tp=2", "mesh.num_slices=2"])}


def _train_world(run_dir, world, sets):
    """cli.train as ``world`` processes (TRIAD_* variables, gloo on the CPU)."""
    _prepare(run_dir)
    cfg_file = run_dir.parent / f"{run_dir.name}.json"
    cfg_file.write_text(json.dumps(_config(run_dir, 1).to_dict()))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, TRIAD_COORDINATOR=f"127.0.0.1:{port}",
                   TRIAD_NUM_PROCESSES=str(world), TRIAD_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        env.pop("TRIAD_DIST_BACKEND", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "triad_tpu_torch.cli.train", "--config", str(cfg_file),
             "--device", "cpu", "--force-new", "--set", f"mesh.num_devices={world}", *sets],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out[-4000:]}"
    return outs


def _layouts(workdir):
    from triad_tpu_torch.train.trainer import Trainer

    logs, errors = {}, []

    def run(name):
        try:
            logs[name] = _train_world(workdir / name, *MESHES[name])
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(name,)) for name in MESHES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    out = {"logs": logs}
    for name in MESHES:
        shutil.copytree(workdir / name, workdir / f"{name}_resumed")
        resumed = Trainer(_config(workdir / f"{name}_resumed", 2), device="cpu")
        out[f"{name}/start"] = resumed.progress.global_step
        resumed.train()
        out[f"{name}/3"] = _checkpoint(workdir / name, 3)
        out[f"{name}/6"] = _checkpoint(workdir / f"{name}_resumed", 6)
    return out


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """tests/test_torch_trainer_dp.py's runs (the same computation, once)."""
    return computed_once(tmp_path_factory, "torch_trainer_dp", _runs)


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    return computed_once(tmp_path_factory, "torch_trainer_tp", _layouts)


@pytest.mark.parametrize("name", list(MESHES))
def test_checkpoint_is_the_one_process_one(one_process, layouts, name):
    _assert_close(layouts[f"{name}/3"], one_process["a3"], f"{name} step 3")


@pytest.mark.parametrize("name", list(MESHES))
def test_resume_in_one_process(one_process, layouts, name):
    assert layouts[f"{name}/start"] == 3
    _assert_close(layouts[f"{name}/6"], one_process["a6"], f"{name} step 6 (resumed)")


def test_logged_layouts(layouts):
    want = {"tp2": "Data-parallel over 1 replicas (all-gathered negatives, tensor-parallel x2, "
                   "ZeRO-1 moments)",
            "fsdp": "Data-parallel over 2 replicas (all-gathered negatives, FSDP params, "
                    "ZeRO-1 moments)",
            "tp2_slices": "Data-parallel over 2 replicas (all-gathered negatives, "
                          "tensor-parallel x2, 2 slices, ZeRO-1 moments)"}
    for name, line in want.items():
        assert any(line in log for log in layouts["logs"][name]), name
