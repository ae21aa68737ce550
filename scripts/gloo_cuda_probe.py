"""Which torch.distributed collectives the gloo backend runs on CUDA
tensors, at two ranks that share one card.

NCCL refuses two ranks on one card, so the port's multi-rank runs on a
one-card machine go over gloo (``runners/jax_runner.py``
``initialize_distributed``). gloo runs some collectives on CUDA tensors
and refuses others; ``parallel/comm.py`` stages the refused ones through
host memory. This script records which is which on the installed torch:

    python scripts/gloo_cuda_probe.py            # needs one CUDA card

For each collective the port uses it starts a pair of ranks of itself
(``--rank``; all pairs side by side, each on its own port), which run that
one op on a CUDA tensor and check the result: an op gloo cannot run on
device memory may abort the process (gloo's transport writes from the
device pointer), so no pair runs two ops. The parent prints
``{"gloo_cuda": {op: "ok" | "error: ..."}, "torch": ...}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

OPS = ("all_reduce", "broadcast", "all_gather_into_tensor", "all_gather",
       "reduce_scatter_tensor", "reduce_scatter", "all_to_all_single",
       "send_recv", "batch_isend_irecv", "device_mesh")


def _probe(op: str, rank: int, world: int, port: int) -> dict:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    out = {"torch": torch.__version__, "cuda": torch.version.cuda}

    def run(name, fn):
        try:
            ok = fn()
            torch.cuda.synchronize()
            out[name] = "ok" if ok else "error: wrong result"
        except Exception as e:  # recorded, not raised: this is the probe
            out[name] = f"error: {type(e).__name__}: {str(e)[:160]}"
        dist.barrier()

    def all_reduce():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return bool((t == sum(range(1, world + 1))).all())

    def broadcast():
        t = torch.full((4,), float(rank), device=dev)
        dist.broadcast(t, src=1)
        return bool((t == 1).all())

    def all_gather_into_tensor():
        t = torch.full((2,), float(rank), device=dev)
        o = torch.empty(2 * world, device=dev)
        dist.all_gather_into_tensor(o, t)
        return o.tolist() == [float(r) for r in range(world) for _ in "ab"]

    def all_gather():
        t = torch.full((2,), float(rank), device=dev)
        o = [torch.empty(2, device=dev) for _ in range(world)]
        dist.all_gather(o, t)
        return [x[0].item() for x in o] == list(map(float, range(world)))

    def reduce_scatter_tensor():
        t = torch.arange(2 * world, dtype=torch.float32, device=dev)
        o = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(o, t)
        return o.tolist() == [float(world * (2 * rank + i)) for i in (0, 1)]

    def reduce_scatter():
        t = torch.arange(2 * world, dtype=torch.float32, device=dev)
        o = torch.empty(2, device=dev)
        dist.reduce_scatter(o, list(t.chunk(world)))
        return o.tolist() == [float(world * (2 * rank + i)) for i in (0, 1)]

    def all_to_all_single():
        t = torch.full((world,), float(rank), device=dev)
        o = torch.empty(world, device=dev)
        dist.all_to_all_single(o, t)
        return o.tolist() == list(map(float, range(world)))

    def send_recv():
        t = torch.full((3,), 7.0, device=dev)
        if rank == 0:
            dist.send(t, 1)
            return True
        o = torch.empty(3, device=dev)
        dist.recv(o, 0)
        return bool((o == 7).all())

    def batch_isend_irecv():
        peer = 1 - rank
        t = torch.full((3,), float(rank), device=dev)
        o = torch.empty(3, device=dev)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, peer),
                                       dist.P2POp(dist.irecv, o, peer)])
        for r in reqs:
            r.wait()
        return bool((o == peer).all())

    def device_mesh():
        from torch.distributed.device_mesh import init_device_mesh

        m = init_device_mesh("cuda", (1, 1, 1, world),
                             mesh_dim_names=("stage", "data", "ctx", "model"))
        t = torch.ones(1, device=dev)
        dist.all_reduce(t, group=m.get_group("model"))
        return t.item() == world

    run(op, locals()[op])
    dist.destroy_process_group()
    return out


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        op, rank, port = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
        print(json.dumps(_probe(op, rank, 2, port)), flush=True)
        return 0
    import socket

    procs = {}
    for op in OPS:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs[op] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", op, str(r),
             str(port)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(2)]
    res, meta = {}, {}
    for op, pair in procs.items():
        outs = []
        for p in pair:
            try:
                out, err = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err = "timeout " + err
            outs.append((p.returncode, out, err))
        rc, out, err = outs[1]
        lines = out.strip().splitlines()
        if rc == 0 and lines:
            got = json.loads(lines[-1])
            res[op] = got[op]
            meta = {k: got[k] for k in ("torch", "cuda")}
        else:
            tail = (outs[0][2] + err).strip().splitlines()[-2:]
            res[op] = f"error: rank exit {outs[0][0]}/{rc}: {' | '.join(tail)[:200]}"
    print(json.dumps({"gloo_cuda": res, **meta}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
