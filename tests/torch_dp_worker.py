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
                      ("live", (("zero1", True), ("replicated", False))),
                      ("lowp", (("zero1", True),))):
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
            if key == "lowp":  # bf16 moments: this rank's slices, and the gathered whole ones
                mine = {}
                for g, opt in bank.opts.items():
                    for name, st in zip(bank.names[g], bank.storage[g]):
                        for k in ("exp_avg", "exp_avg_sq"):
                            mine[f"{name}/{k}"] = opt.state[st][k].clone()
                torch.save(mine, workdir / f"lowp-slices-{rank}.pt")
                for g, sd in bank.full_state_dicts().items():
                    for i, st in sd["state"].items():
                        for k in ("exp_avg", "exp_avg_sq"):
                            t = st[k]
                            out[f"lowp/whole/{bank.names[g][int(i)]}/{k}"] = \
                                t.view(torch.int16).numpy()
                            out[f"lowp/whole_dtype/{bank.names[g][int(i)]}/{k}"] = \
                                np.asarray(str(t.dtype))
    return out


# ---------------------------------------------------------------------------
# layouts: tensor parallelism, FSDP, ZeRO-1 and slices (tests/test_torch_tp.py)
# ---------------------------------------------------------------------------

# name: (world, mesh kind, tp, fsdp, zero1); mesh kinds: "flat" (data),
# "tp" (data, model), "slices" (replica, data), "slices_tp" (replica, data,
# model, one data index a slice)
LAYOUTS = {
    "tp2": (2, "tp", 2, False, True),
    "fsdp": (2, "flat", 1, True, True),
    "dp2tp2": (4, "tp", 2, False, False),
    "dp2tp2_zero1": (4, "tp", 2, False, True),
    "tp2_slices": (4, "slices_tp", 2, False, True),
    "fsdp_tp2": (4, "tp", 2, True, True),
    "fsdp_slices": (4, "slices", 1, True, True),
}


def layout_mesh(kind: str, world: int, tp: int):
    """(mesh, data axis) of a layout's mesh kind over the world."""
    from triad_tpu_torch.parallel.dp import make_mesh, make_multislice_mesh
    from triad_tpu_torch.parallel.tp import make_dp_tp_mesh, make_multislice_tp_mesh

    if kind == "flat":
        return make_mesh(world), "data"
    if kind == "tp":
        return make_dp_tp_mesh(world, tp), "data"
    if kind == "slices":
        return make_multislice_mesh(2, world // 2), ("replica", "data")
    return make_multislice_tp_mesh(2, world // 2 // tp, tp), ("replica", "data")


def layout_run(workdir, key, layout, world=1):
    """DIR/KEY.pt's micro steps (its config, state, seed and batches; an
    update per accumulation window) under ``layout`` (None: one process),
    on this rank's rows; returns (metrics of the last step, whole
    parameters, bytes of this rank's parameters, of its moments)."""
    from triad_tpu_torch.config import Config
    from triad_tpu_torch.models.convert import init_triad_model
    from triad_tpu_torch.parallel.fsdp import fsdp_param_specs
    from triad_tpu_torch.parallel.tp import shard_model, tp_param_specs
    from triad_tpu_torch.train.optim import OptimizerBank
    from triad_tpu_torch.train.step import StepFactory, TrainState

    spec = torch.load(workdir / f"{key}.pt", weights_only=False)
    cfg = Config.from_dict(spec["config"])
    model = init_triad_model(cfg.model, torch.Generator().manual_seed(0))
    model.load_state_dict(spec["state"])
    mesh, axis, specs, zero1 = None, "data", None, False
    if layout is not None:
        _, kind, tp, fsdp, zero1 = LAYOUTS[layout]
        mesh, axis = layout_mesh(kind, world, tp)
        specs = tp_param_specs(model, tp) if tp > 1 else {}
        if fsdp:
            specs = fsdp_param_specs(model, mesh, base_specs=specs)
        shard_model(model, mesh, specs)
    ocfg = cfg.train.optim
    bank = OptimizerBank(ocfg, model, total_updates=100, mesh=mesh, mesh_axis=axis, zero1=zero1,
                         param_specs=specs)
    state = TrainState(model, bank, 0, spec["seed"])
    step = StepFactory(cfg.loss, ocfg, mesh=mesh, mesh_axis=axis).make_step("joint")
    index, size = (mesh.index(axis), mesh.axis_size(axis)) if mesh is not None else (0, 1)
    with _BlockCount() as blocks:
        for av, tv in spec["batches"]:
            per = av["audio"].shape[0] // size
            rows = slice(index * per, (index + 1) * per)
            _, m = step(state, {k: v[rows] for k, v in av.items()},
                        {k: v[rows] for k, v in tv.items()}, spec["w_av"], spec["w_tv"])
    params = {n: p.detach().clone() for n, p in bank.model_state_dict().items()}
    m = {k: float(v) for k, v in m.items()}
    m["frontend_blocks"] = float(blocks.n)
    return (m, params, sum(p.numel() * p.element_size() for p in model.parameters()),
            bank.moment_bytes())


class _BlockCount:
    """While active, counts the pass-B blocks HuBERT's chunked frontend runs
    (in the forward and in the backward's recompute)."""

    def __enter__(self):
        from triad_tpu_torch.models.hubert import ConvFeatureEncoder

        self.n, block = 0, ConvFeatureEncoder._block

        def counted(mod, *args):
            self.n += 1
            return block(mod, *args)

        self._undo = lambda: setattr(ConvFeatureEncoder, "_block", block)
        ConvFeatureEncoder._block = counted
        return self

    def __exit__(self, *exc):
        self._undo()


def bf16_pair(x, w1, b1, w2, b2, rank=0, parts=1):
    """A bf16 column-parallel Dense, GELU, a row-parallel Dense (rank's
    shards of the given fp32 weights; parts 1: the plain layers), and
    d(sum y^2)/dx: (y, dx) in fp32."""
    from triad_tpu_torch.models.layers import Dense

    fc1 = Dense(w1.shape[1], w1.shape[0] // parts, dtype=torch.bfloat16)
    fc2 = Dense(w2.shape[1] // parts, w2.shape[0], dtype=torch.bfloat16)
    n = w1.shape[0] // parts
    with torch.no_grad():
        fc1.weight.copy_(w1[rank * n:(rank + 1) * n])
        fc1.bias.copy_(b1[rank * n:(rank + 1) * n])
        fc2.weight.copy_(w2[:, rank * n:(rank + 1) * n])
        fc2.bias.copy_(b2)
    if parts > 1:
        fc1.set_tensor_parallel("column", rank, parts, None)
        fc2.set_tensor_parallel("row", rank, parts, None)
    x = x.clone().requires_grad_()
    y = fc2(torch.nn.functional.gelu(fc1(x)))
    (y.float() ** 2).sum().backward()
    return y.detach().float(), x.grad


def layouts(rank, world, workdir):
    out = {}
    if world == 2 and (workdir / "bf16_pair.pt").exists():
        y, dx = bf16_pair(*torch.load(workdir / "bf16_pair.pt"), rank=rank, parts=2)
        out["bf16_pair/y"], out["bf16_pair/dx"] = y.numpy(), dx.numpy()
    for key in ("exact", "accum2", "live"):
        if not (workdir / f"{key}.pt").exists():
            continue
        names = torch.load(workdir / f"{key}.pt", weights_only=False)["layouts"]
        for layout in names:
            if LAYOUTS[layout][0] != world:
                continue
            m, params, pbytes, mbytes = layout_run(workdir, key, layout, world)
            for k, v in m.items():
                out[f"{key}/{layout}/metric/{k}"] = np.asarray(v)
            for n, p in params.items():
                out[f"{key}/{layout}/param/{n}"] = p.numpy()
            out[f"{key}/{layout}/param_bytes"] = np.asarray(
                _gather_ints(pbytes))
            out[f"{key}/{layout}/moment_bytes"] = np.asarray(_gather_ints(mbytes))
    return out


def _gather_ints(x: int):
    """Every rank's integer, in rank order."""
    from triad_tpu_torch.parallel import collectives as C

    return C.gather_rows(torch.tensor([x], dtype=torch.int64)).tolist()


CASES = {"losses": losses, "steps": steps, "layouts": layouts}


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
