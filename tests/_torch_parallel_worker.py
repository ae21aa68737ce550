"""One rank of tests/test_torch_parallel.py's gloo groups (CPU).

Started by ``kubeflow_tpu_torch.parallel.spmd_check.run_ranks`` with the
rendezvous env; reads the task list (JSON) the test wrote, runs every
task in order on every rank (each is a collective), and rank 0 writes
each task's result with ``torch.save`` into the output directory. Imports
no JAX: the test process holds the JAX references.

    python tests/_torch_parallel_worker.py TASKS.json OUT_DIR
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from kubeflow_tpu_torch.data.lm import LMDataset  # noqa: E402
from kubeflow_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig)
from kubeflow_tpu_torch.parallel.lm_train import (  # noqa: E402
    LMHyperParams, LMTrainLoop)
from kubeflow_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from kubeflow_tpu_torch.parallel.pipeline import (  # noqa: E402
    PipelinedLMTrainLoop)
from kubeflow_tpu_torch.parallel.ring_attention import (  # noqa: E402
    make_ring_attention)
from kubeflow_tpu_torch.parallel.spmd_check import (  # noqa: E402
    check_attention_sharding)
from kubeflow_tpu_torch.runners.jax_runner import (  # noqa: E402
    initialize_distributed)
from kubeflow_tpu_torch.runtime.rendezvous import rank_world  # noqa: E402


def train(task, world):
    mesh, plan = make_mesh(world, device_type="cpu", **task["mesh"])
    cfg = TransformerConfig(**task["cfg"])
    hp = LMHyperParams(**task["hp"])
    if plan.pp > 1:
        loop = PipelinedLMTrainLoop(cfg, hp, "cpu", mesh, plan,
                                    n_microbatches=task.get("micro"))
    else:
        loop = LMTrainLoop(cfg, hp, "cpu", mesh, plan)
    init = torch.load(task["init"]) if task.get("init") else None
    loop.init_state(init)
    out = {"plan": [plan.pp, plan.dp, plan.cp, plan.tp]}
    if task.get("init_only"):
        out["params"] = loop.full_params()
        return out
    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=cfg.max_seq_len)
    losses, accs = [], []
    for step, batch in enumerate(ds.batches(task["batch"],
                                            steps=task["steps"])):
        if step == task.get("save_at"):
            out["tree"] = loop.state_tree()
        loss, acc = loop.train_step(loop.local_rows(batch))
        losses.append(loss)
        accs.append(acc)
    out.update(losses=losses, accs=accs, params=loop.full_params())
    return out


def ring(task, world):
    mesh, _ = make_mesh(world, device_type="cpu", cp=world)
    q, k, v = (torch.from_numpy(np.load(task["inputs"])[n]).requires_grad_()
               for n in ("q", "k", "v"))
    out = make_ring_attention(mesh, "ctx")(q, k, v)
    (out ** 2).sum().backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def sharding(task, world):
    mesh, plan = make_mesh(world, device_type="cpu", **task["mesh"])
    return check_attention_sharding(mesh, plan, torch.device("cpu"),
                                    sp=task.get("sp", False))


def main() -> int:
    tasks_path, out_dir = sys.argv[1], sys.argv[2]
    initialize_distributed(torch.device("cpu"))
    rank, world = rank_world()
    with open(tasks_path) as f:
        tasks = json.load(f)
    for task in tasks:
        res = {"train": train, "ring": ring, "sharding": sharding}[
            task["kind"]](task, world)
        if rank == 0:
            torch.save(res, os.path.join(out_dir, task["name"] + ".pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
