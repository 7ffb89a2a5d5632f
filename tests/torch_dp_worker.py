"""The ranks of the data-parallel CPU tests' gloo worlds (imports no JAX).

    python -m tests.torch_dp_worker CASE RANK WORLD DIR

Every rank joins a gloo world through a FileStore under DIR, runs CASE on
the inputs the test wrote to DIR (inputs.npz, or a .pt per step), and
rank 0 writes what the test compares to DIR/CASE-WORLD.npz.
``spawn_world`` starts the ranks and fails with their output if any rank
fails; ``computed_once`` runs a test module's worlds once a session.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]


def spawn_world(case: str, world: int, workdir, timeout: float = 300.0):
    """Run CASE as ``world`` ranks; returns once every rank exited 0."""
    workdir = Path(workdir)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dp_worker", case, str(r), str(world), str(workdir)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    bad = [(r, p.returncode, o) for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        raise AssertionError("\n".join(f"rank {r} exited {rc}:\n{o[-4000:]}" for r, rc, o in bad))
    return outs


def computed_once(tmp_path_factory, name: str, compute):
    """compute(workdir) once for the whole test session, even when xdist
    spreads a module's tests over several workers: the first worker to
    take the lock computes and saves the result beside the workers' temp
    roots, the others load it."""
    import fcntl

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    done = root / f"{name}.pt"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            workdir = root / f"{name}-work"
            workdir.mkdir(exist_ok=True)
            torch.save(compute(workdir), done)
    return torch.load(done, weights_only=False)


def _join(rank: int, world: int, workdir: Path):
    store = workdir / f"store-{world}"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)


# ---------------------------------------------------------------------------
# losses: distributed_av_loss / distributed_tv_loss, values and gradients
# ---------------------------------------------------------------------------


def _loss_cases(world):
    """(name, implementation, mesh kind, negatives) of a world."""
    cases = []
    for impl in ("chunked", "chunked_vjp"):
        cases.append((f"{impl}/flat/all_gather", impl, "flat", "all_gather"))
        if world == 4:
            cases.append((f"{impl}/slices/all_gather", impl, "slices", "all_gather"))
            cases.append((f"{impl}/flat/ring", impl, "flat", "ring"))
    return cases


def losses(rank, world, workdir):
    from triad_tpu_torch.config import LossConfig
    from triad_tpu_torch.parallel import collectives as C
    from triad_tpu_torch.parallel.dp import (
        _ring_aggregate,
        distributed_av_loss,
        distributed_tv_loss,
        make_mesh,
        make_multislice_mesh,
    )

    inp = np.load(workdir / "inputs.npz")
    b = inp["audio"].shape[0]
    rows = slice(rank * b // world, (rank + 1) * b // world)
    out = {}
    for name, impl, kind, negatives in _loss_cases(world):
        cfg = LossConfig(implementation=impl, chunk_size=2, negatives=negatives)
        if kind == "flat":
            mesh, axis = make_mesh(world), "data"
        else:
            mesh, axis = make_multislice_mesh(2, 2), ("replica", "data")
        for leg in ("av", "tv"):
            q = torch.tensor(inp["audio" if leg == "av" else "text"][rows], requires_grad=True)
            v = torch.tensor(inp["visual"][rows], requires_grad=True)
            t = torch.tensor(inp["temperature"], requires_grad=True)
            if leg == "av":
                res = distributed_av_loss(q, v, t, cfg, mesh, axis)
            else:
                res = distributed_tv_loss(q, v, torch.tensor(inp["mask"][rows]), t, cfg, mesh,
                                          axis)
            (res.total / world).backward()
            vals = {"total": res.total, "contrastive": res.contrastive, "reg": res.reg,
                    **res.stats}
            if leg == "av":
                vals["smooth"] = res.smooth
            for k, x in vals.items():
                out[f"{name}/{leg}/{k}"] = x.detach().numpy()
            out[f"{name}/{leg}/dq"] = C.gather_rows(q.grad).numpy()
            out[f"{name}/{leg}/dv"] = C.gather_rows(v.grad).numpy()
            out[f"{name}/{leg}/dt"] = C.all_reduce_(t.grad.clone()).numpy()
    if world == 4:
        q = torch.tensor(inp["audio"][rows])
        try:
            _ring_aggregate(q, q, torch.tensor(1.0), LossConfig(negatives="ring"), -1.0, None,
                            make_multislice_mesh(2, 2), ("replica", "data"))
            out["ring_tuple_error"] = np.array("")
        except ValueError as e:
            out["ring_tuple_error"] = np.array(str(e))
    return out


# ---------------------------------------------------------------------------
# steps: the world-2 joint step (dry-run config vs JAX; ZeRO-1 vs replicated)
# ---------------------------------------------------------------------------


def _step_run(workdir, rank, world, key, zero1, mesh_on=True):
    """One joint step of DIR/KEY.pt's model (its config, state, seed and
    batches) on this rank's rows of the batch; returns (metrics, updated
    parameters, bank)."""
    from triad_tpu_torch.config import Config
    from triad_tpu_torch.models.convert import init_triad_model
    from triad_tpu_torch.parallel.dp import make_mesh
    from triad_tpu_torch.train.optim import OptimizerBank
    from triad_tpu_torch.train.step import StepFactory, TrainState

    spec = torch.load(workdir / f"{key}.pt", weights_only=False)
    cfg = Config.from_dict(spec["config"])
    model = init_triad_model(cfg.model, torch.Generator().manual_seed(0))
    model.load_state_dict(spec["state"])
    mesh = make_mesh(world) if mesh_on else None
    ocfg = cfg.train.optim
    bank = OptimizerBank(ocfg, model, total_updates=100, mesh=mesh, zero1=zero1)
    state = TrainState(model, bank, 0, spec["seed"])
    step = StepFactory(cfg.loss, ocfg, mesh=mesh).make_step("joint")
    per = spec["av"]["audio"].shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    av = {k: v[rows] for k, v in spec["av"].items()}
    tv = {k: v[rows] for k, v in spec["tv"].items()}
    _, m = step(state, av, tv, spec["w_av"], spec["w_tv"])
    return m, {n: p.detach().clone() for n, p in model.named_parameters()}, bank


def steps(rank, world, workdir):
    from triad_tpu_torch.parallel.dp import make_mesh
    from triad_tpu_torch.parallel.zero import shard_largest_dim

    out = {}
    for key, legs in (("dryrun", (("zero1", True),)),
                      ("live", (("zero1", True), ("replicated", False)))):
        if not (workdir / f"{key}.pt").exists():
            continue
        for leg, zero1 in legs:
            m, params, bank = _step_run(workdir, rank, world, key, zero1)
            for k, v in m.items():
                out[f"{key}/{leg}/metric/{k}"] = np.asarray(float(v))
            for n, p in params.items():
                out[f"{key}/{leg}/param/{n}"] = p.numpy()
            out[f"{key}/{leg}/moment_bytes"] = np.asarray(bank.moment_bytes())
            if zero1:
                mesh = make_mesh(world)
                checked = 0
                for g, opt in bank.opts.items():
                    for name, p, st in zip(bank.names[g], bank.groups[g], bank.storage[g]):
                        dim = shard_largest_dim(p, mesh)
                        want = list(p.shape)
                        if dim is not None:
                            want[dim] //= world
                        for k in ("exp_avg", "exp_avg_sq"):
                            if p in opt.state or st in opt.state:
                                got = list(opt.state[st][k].shape)
                                assert got == want, (name, k, got, want)
                                checked += 1
                out[f"{key}/{leg}/moments_checked"] = np.asarray(checked)
    return out


CASES = {"losses": losses, "steps": steps}


def main():
    case, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(
        sys.argv[4])
    torch.set_num_threads(1)
    _join(rank, world, workdir)
    try:
        out = CASES[case](rank, world, workdir)
        if rank == 0:
            np.savez(workdir / f"{case}-{world}.npz", **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
