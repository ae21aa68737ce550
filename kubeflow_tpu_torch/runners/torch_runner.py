"""PyTorchJob worker — port of ``kubeflow_tpu/runners/torch_runner.py``:
torch DDP driven by the env the PyTorchJob operator injects
(MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK), acceptance config #2 of
BASELINE.md (2-worker distributed MNIST, NCCL backend).

Same flags and stdout contract (``runner_start framework=torch ... rank=
world= backend=``, ``step=``, ``train_done``, ``loss=``, ``accuracy=``),
plus ``--device {cuda,cpu}`` (default cuda; rank r trains on
``cuda:{r % device_count}``). ``--backend`` wins when given; without it
the backend is ``nccl`` on cuda and ``gloo`` on the CPU (the reference
defaulted to gloo because it ran on the CPU). NCCL refuses two ranks on
one card: two ranks on one GPU take ``--backend=gloo``, whose all-reduce
takes CUDA tensors. The process group starts when WORLD_SIZE > 1 or
MASTER_ADDR is set (a one-replica PyTorchJob still rendezvouses, so its
backend is exercised):

    MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 WORLD_SIZE=2 RANK=0 \\
        python -m kubeflow_tpu_torch.runners.torch_runner --dataset=mnist \\
        --steps=300 --batch-size=128
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="kfx torch training runner")
    p.add_argument("--dataset", default="mnist")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--backend", default=None,
                   help="torch.distributed backend (default: nccl on cuda, "
                        "gloo on the CPU)")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--eval-samples", type=int, default=2048)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..runtime.lifetime import install_parent_watch

    install_parent_watch()
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn as nn

    from ..data import get_dataset
    from ..device import resolve_device

    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = args.backend or ("nccl" if dev.type == "cuda" else "gloo")
    distributed = world > 1 or "MASTER_ADDR" in os.environ
    if distributed:
        dist.init_process_group(backend=backend, rank=rank,
                                world_size=world)

    print(f"runner_start framework=torch dataset={args.dataset} "
          f"rank={rank} world={world} backend={backend}", flush=True)

    ds = get_dataset(args.dataset)
    in_dim = int(np.prod(ds.shape))
    model = nn.Sequential(
        nn.Flatten(), nn.Linear(in_dim, 256), nn.ReLU(),
        nn.Linear(256, 128), nn.ReLU(), nn.Linear(128, ds.num_classes)
    ).to(dev)
    if distributed:   # broadcasts rank 0's initial weights
        model = nn.parallel.DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None)
    opt = torch.optim.Adam(model.parameters(), lr=args.learning_rate)
    loss_fn = nn.CrossEntropyLoss()

    t0 = time.time()
    t_last = t0
    it = ds.batches(args.batch_size, shard_index=rank, num_shards=world)
    for step in range(args.steps):
        images, labels = next(it)
        x = torch.from_numpy(images).to(dev)
        y = torch.from_numpy(labels).to(dev, torch.long)
        opt.zero_grad()
        logits = model(x)
        loss = loss_fn(logits, y)
        loss.backward()  # DDP all-reduces grads here (the NCCL ring's job)
        opt.step()
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            loss_v = float(loss.detach())
            acc_v = float((logits.argmax(-1) == y).float().mean())
            now = time.time()
            dt = (now - t_last) / args.log_every
            print(f"step={step + 1} loss={loss_v:.6f} accuracy={acc_v:.6f} "
                  f"step_time={dt:.4f}", flush=True)
            t_last = now

    eval_ds = get_dataset(args.dataset, split="eval")
    images, labels = eval_ds.eval_arrays(args.eval_samples)
    with torch.no_grad():
        logits = model(torch.from_numpy(images).to(dev))
        y = torch.from_numpy(labels).to(dev, torch.long)
        eval_loss = float(loss_fn(logits, y))
        eval_acc = float((logits.argmax(-1) == y).float().mean())
    wall = time.time() - t0
    print(f"train_done steps={args.steps} wall_seconds={wall:.2f}", flush=True)
    print(f"loss={eval_loss:.6f}", flush=True)
    print(f"accuracy={eval_acc:.6f}", flush=True)
    if distributed:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
