"""Which gloo collectives take CUDA tensors on this machine: each op runs
in a fresh world of two processes on the card (a failure can take the
connection down, so one world an op), on a CUDA tensor handed to gloo
as it is, and its result is checked.

    python3 triad_tpu_torch/tools/gloo_probe.py

Prints one line an op ("ok" or the error) and a JSON summary last.
``parallel/collectives.py:GLOO_CUDA_OPS`` names the ops the port hands
gloo CUDA tensors in; the others go through pinned host copies.
"""

import json
import subprocess
import sys
import tempfile

OPS = ("all_reduce", "all_reduce_max", "broadcast", "all_gather", "reduce_scatter", "send_recv",
       "barrier")

RANK = r'''
import sys, torch, torch.distributed as dist
op, rank, store = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=2)
torch.cuda.set_device(0)
x = torch.full((1000,), float(rank + 1), device="cuda")
if op == "all_reduce":
    dist.all_reduce(x); ok = float(x.min()) == float(x.max()) == 3.0
elif op == "all_reduce_max":
    dist.all_reduce(x, op=dist.ReduceOp.MAX); ok = float(x.min()) == 2.0
elif op == "broadcast":
    dist.broadcast(x, 0); ok = float(x.max()) == 1.0
elif op == "all_gather":
    parts = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(parts, x); ok = float(parts[0][0]) == 1.0 and float(parts[1][0]) == 2.0
elif op == "reduce_scatter":
    out = torch.empty(500, device="cuda")
    dist.reduce_scatter_tensor(out, x); ok = float(out.min()) == float(out.max()) == 3.0
elif op == "send_recv":
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                       dist.P2POp(dist.irecv, out, 1 - rank)]):
        req.wait()
    ok = float(out[0]) == 2.0 - rank
else:
    dist.barrier(); ok = True
torch.cuda.synchronize()
print("RESULT", "ok" if ok else "wrong values", flush=True)
dist.destroy_process_group()
'''


def probe(op: str) -> str:
    with tempfile.TemporaryDirectory() as d:
        script = f"{d}/rank.py"
        with open(script, "w") as f:
            f.write(RANK)
        procs = [subprocess.Popen([sys.executable, script, op, str(r), f"{d}/store"],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=120)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                return "hung (killed after 120 s)"
    if all(p.returncode == 0 and "RESULT ok" in o for p, o in zip(procs, outs)):
        return "ok"
    errors = [line for o in outs for line in o.splitlines()
              if "Error" in line or line.startswith("RESULT")]
    return (errors[-1] if errors else f"exit codes {[p.returncode for p in procs]}")[:200]


def main():
    results = {}
    for op in OPS:
        results[op] = probe(op)
        print(f"{op}: {results[op]}", flush=True)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
