"""JAXJob worker on one GPU — port of ``kubeflow_tpu/runners/jax_runner.py``.

The module keeps the reference's name so a manifest's ``-m
kubeflow_tpu.runners.jax_runner`` maps to ``-m
kubeflow_tpu_torch.runners.jax_runner`` one to one. Same flags and the
same stdout contract: ``runner_start …``, ``step=N loss= accuracy=
step_time= examples_per_sec=``, ``train_done …``, ``loss=``,
``accuracy=``, ``resumed_from_checkpoint step=K`` (checkpoints under
``KFX_CHECKPOINT_DIR``), ``fault_injection_crash step=`` with exit 17,
``chaos_crash step=`` with exit 137 (the ``runner.crash`` chaos point,
drawn after each checkpoint save), ``exported_model dir=``; plus
``--device {cuda,cpu}`` (default ``KFX_DEVICE``, which the JAXJob and
MPIJob operators pin into every worker, else cuda):

    python -m kubeflow_tpu_torch.runners.jax_runner --model=resnet50 \\
        --dataset=cifar10 --steps=100 --batch-size=256

``--data-pipeline auto`` draws synthetic batches on the device on cuda
and feeds host batches (prefetched on a thread) on the CPU, the
reference's rule. Steps run in chunks of ``--scan-steps`` with one sync a
chunk, cut at log, checkpoint and fault boundaries. ``KFX_CHAOS`` reaches
the startup ``rendezvous.delay`` point, ``runner.crash`` and the
checkpointer's points. With ``KFX_WORKDIR`` set (the gang sets it) the
reference's spans go to its spans file (``obs/trace.py``):
``runner.init`` (interpreter start to the first step, with
``rendezvous.wait`` inside it), ``xla.compile`` (the first chunk, which
pays the warm-up; the name is the reference's, so one waterfall reads
both), a ``train.window`` a log interval, ``checkpoint.save`` and
``checkpoint.restore`` (``training/checkpoint.py``), ``runner.eval`` and
``runner.export``. After distributed init it starts the worker's trace
server (``profiling.maybe_start_profiler_server``; ``KFX_PROFILE=0`` opts
out), which `kfx profile` reads.

Several processes (``KFX_NUM_PROCESSES``, ``KFX_PROCESS_ID``,
``KFX_COORDINATOR_ADDRESS``, as the JAXJob operator and the mpirun shim
set them) train data-parallel over ``torch.distributed``
(``initialize_distributed``): one device a process, ``cuda:{rank %
device_count}`` on cuda, the global ``--batch-size`` split evenly, every
rank printing the same ``step=`` lines; the eval set is sharded
``images[rank::world]`` and only the chief exports.
"""

from __future__ import annotations

import argparse
import os
import queue as _queue
import sys
import threading
import time

# Wall-clock anchor for the runner.init span: captured at module import
# (before torch is imported in main), so the span covers interpreter and
# backend startup the spawn span's end otherwise leaves unaccounted.
_PROC_START = time.time()


def parse_args(argv=None):
    from ..device import DEVICES, default_device

    p = argparse.ArgumentParser(description="kfx JAXJob training runner (GPU)")
    p.add_argument("--model", default="mlp")
    p.add_argument("--dataset", default="mnist")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adam")
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--checkpoint-every", type=int, default=200)
    p.add_argument("--keep-checkpoints", type=int, default=2)
    p.add_argument("--eval-samples", type=int, default=2048)
    p.add_argument("--no-checkpoint", action="store_true")
    p.add_argument("--data-pipeline", default="auto",
                   choices=["auto", "device", "host"],
                   help="auto: device batches on cuda, host batches (with "
                        "prefetch) on the CPU")
    p.add_argument("--scan-steps", type=int, default=1,
                   help="steps run back to back with one host sync")
    p.add_argument("--export-dir", default="",
                   help="After training, export params for serving here")
    p.add_argument("--fail-at-step", type=int, default=-1,
                   help="Fault injection: crash at this step (tests only)")
    p.add_argument("--device", default=default_device(), choices=DEVICES,
                   help="default: KFX_DEVICE (set by the training "
                        "operators), else cuda")
    return p.parse_args(argv)


def plan_chunks(start: int, steps: int, k_target: int, log_every: int,
                ckpt_every: int, fail_at_step: int):
    """(first step, length) of each chunk: at most ``k_target`` steps,
    never crossing a log, checkpoint or fault boundary."""
    def to_boundary(step: int, every: int) -> int:
        return every - step % every if every > 0 else k_target

    s = start
    while s < steps:
        k = min(k_target, steps - s, to_boundary(s, log_every),
                to_boundary(s, ckpt_every))
        if fail_at_step > s:
            k = min(k, fail_at_step - s)
        yield s, k
        s += k


def log(msg: str) -> None:
    """Print one stdout line in one write: ranks that share a pipe (the
    mpirun shim's) then interleave whole lines only."""
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


def initialize_distributed(device):
    """Rendezvous via env; returns this process's device. Calls the
    startup chaos hook first. For ``KFX_NUM_PROCESSES`` > 1 it starts the
    torch.distributed group at ``tcp://KFX_COORDINATOR_ADDRESS``: ``nccl``
    on cuda when the host shows at least as many cards as ranks, else
    ``gloo`` (on the CPU, and over the card's tensors when ranks share a
    card, which NCCL refuses). Prints the backend on a line of its own,
    with the transport of its collectives (``parallel/comm.py``: gloo
    stages the ops it cannot run on CUDA tensors through host memory)."""
    import torch
    import torch.distributed as dist

    from ..runtime.rendezvous import (ENV_COORDINATOR, ENV_NUM_PROCESSES,
                                      ENV_PROCESS_ID, apply_startup_chaos)

    apply_startup_chaos()
    num = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    if num <= 1:
        return device
    coord = os.environ[ENV_COORDINATOR]
    pid = int(os.environ[ENV_PROCESS_ID])
    backend = "gloo"
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        device = torch.device("cuda", pid % n_cards)
        torch.cuda.set_device(device)
        if n_cards >= num:
            backend = "nccl"
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            rank=pid, world_size=num)
    from ..parallel.comm import transport_line

    log(f"process_group backend={backend} rank={pid} world={num} "
        f"coordinator={coord} device={device} "
        f"{transport_line(backend, device.type)}")
    return device


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..obs import trace as obs_trace

    # runner.init: interpreter start -> ready to train (rendezvous, the
    # torch import, model and state init, checkpoint restore), backdated
    # to _PROC_START. The context manager records it status=error when a
    # startup failure unwinds, so a failed attempt's trace still shows
    # where its init died.
    with obs_trace.span("runner.init", ts=_PROC_START) as init_sp:
        from ..device import resolve_device
        from ..runtime.rendezvous import rank_world

        with obs_trace.span("rendezvous.wait") as rdv_sp:
            rdv_sp.attrs["processes"] = os.environ.get(
                "KFX_NUM_PROCESSES", "1")
            device = initialize_distributed(resolve_device(args.device))

        from ..profiling import maybe_start_profiler_server

        maybe_start_profiler_server()
        rank, world = rank_world()

        import numpy as np

        from ..data import get_dataset
        from ..models import get_model
        from ..training import Checkpointer, TrainLoop

        trace_id = os.environ.get("KFX_TRACE_ID", "")
        log(f"runner_start model={args.model} dataset={args.dataset} "
            f"rank={rank} world={world} devices={world} "
            f"platform={device.type}"
            + (f" trace={trace_id}" if trace_id else ""))

        dataset = get_dataset(args.dataset, split="train", seed=args.seed)
        model = get_model(args.model, num_classes=dataset.num_classes,
                          input_shape=dataset.shape)
        loop = TrainLoop(model, learning_rate=args.learning_rate,
                         optimizer=args.optimizer,
                         weight_decay=args.weight_decay, seed=args.seed,
                         device=device)
        state = loop.init_state(dataset.shape)
        init_sp.attrs.update(model=args.model, rank=str(rank),
                             world=str(world), platform=device.type)

        ckpt = None
        start_step = 0
        ckpt_dir = os.environ.get("KFX_CHECKPOINT_DIR", "")
        if ckpt_dir and not args.no_checkpoint:
            ckpt = Checkpointer(ckpt_dir, save_every=args.checkpoint_every,
                                keep=args.keep_checkpoints)
            restored = ckpt.restore_latest(state)
            if restored is not None:
                # CLI hyperparams override the checkpointed ones.
                state = loop.reapply_hyperparams(restored)
                start_step = state.step
                log(f"resumed_from_checkpoint step={start_step}")
    from .. import chaos

    device_pipeline = (args.data_pipeline == "device"
                       or (args.data_pipeline == "auto"
                           and device.type == "cuda"))

    def chunk_plan():
        return plan_chunks(start_step, args.steps, max(1, args.scan_steps),
                           args.log_every,
                           args.checkpoint_every if ckpt is not None else 0,
                           args.fail_at_step)

    prefetch_q: "_queue.Queue" = _queue.Queue(maxsize=2)
    if device_pipeline:
        log("data_pipeline=device (batches generated on device; zero "
            "input transfer per step)")
        batch_fn = dataset.device_batch_fn()
        chunks = chunk_plan()
    else:
        it = dataset.batches(args.batch_size, shard_index=rank,
                             num_shards=world, steps=None, epoch_seed=0)
        # Skip the batches consumed before a restart so the stream
        # continues where the checkpoint left off (device batches need no
        # skip: their generator is seeded by the absolute step).
        for _ in range(start_step):
            next(it)

        def _prefetch():
            # A failure goes through the queue and is re-raised by the
            # consumer: a dead thread must never leave it blocked.
            try:
                for s, k in chunk_plan():
                    batches = [next(it) for _ in range(k)]
                    prefetch_q.put((s, k, (
                        np.stack([b[0] for b in batches]),
                        np.stack([b[1] for b in batches]))))
            except BaseException as e:
                prefetch_q.put(e)

        threading.Thread(target=_prefetch, daemon=True,
                         name="kfx-prefetch").start()

    t_start = time.time()
    t_last = t_start
    last_log_step = start_step
    loss = acc = 0.0
    step = start_step
    # The first chunk (the warm-up) becomes an `xla.compile` span; each
    # log window after it a `train.window` span.
    compile_recorded = False
    win_start, win_step0 = t_start, start_step
    while step < args.steps:
        if step == args.fail_at_step:
            if ckpt is not None:
                # The injected crash comes after the last scheduled save
                # became durable, or a resume would lose it at random.
                ckpt.wait()
            log(f"fault_injection_crash step={step}")
            sys.stdout.flush()
            os._exit(17)
        if device_pipeline:
            s, k = next(chunks)
            t_dispatch = time.time()
            state, loss, acc = loop.train_steps_device(
                state, batch_fn, args.batch_size, s, k)
        else:
            got = prefetch_q.get()
            if isinstance(got, BaseException):
                raise RuntimeError("input prefetch thread failed") from got
            s, k, (images, labels) = got
            # Timed after the queue get: the first chunk's prefetch wait
            # is input latency, not warm-up.
            t_dispatch = time.time()
            state, loss, acc = loop.train_steps(state, images, labels)
        if s != step:
            raise RuntimeError(f"chunk desync: {s} != {step}")
        step += k
        now = time.time()
        if not compile_recorded:
            obs_trace.record_span("xla.compile", t_dispatch,
                                  now - t_dispatch, start_step=str(s),
                                  steps=str(k), model=args.model)
            compile_recorded = True
            win_start, win_step0 = now, step
        if step % args.log_every == 0 or step == args.steps:
            dt = (now - t_last) / max(step - last_log_step, 1)
            eps = args.batch_size / dt if dt > 0 else 0.0
            log(f"step={step} loss={loss:.6f} accuracy={acc:.6f} "
                f"step_time={dt:.4f} examples_per_sec={eps:.1f}")
            t_last = now
            last_log_step = step
            if step > win_step0:
                obs_trace.record_span(
                    "train.window", win_start, now - win_start,
                    start_step=str(win_step0), end_step=str(step),
                    examples_per_sec=f"{eps:.1f}")
            win_start, win_step0 = now, step
        if ckpt is not None and ckpt.maybe_save(step, state):
            # Fault point: a worker crash at a checkpoint boundary, after
            # the save became durable (the --fail-at-step contract), so a
            # restart-resume sequence replays exactly.
            if chaos.draw("runner.crash", target=f"step-{step}") is not None:
                ckpt.wait()
                log(f"chaos_crash step={step}")
                sys.stdout.flush()
                os._exit(137)

    # The final eval on a fixed set, sharded across processes.
    with obs_trace.span("runner.eval", samples=str(args.eval_samples)):
        eval_ds = get_dataset(args.dataset, split="eval", seed=args.seed)
        images, labels = eval_ds.eval_arrays(args.eval_samples)
        metrics = loop.evaluate(state, images[rank::world],
                                labels[rank::world])
    wall = time.time() - t_start
    log(f"train_done steps={args.steps} wall_seconds={wall:.2f}")
    log(f"loss={metrics['loss']:.6f}")
    log(f"accuracy={metrics['accuracy']:.6f}")

    if ckpt is not None:
        ckpt.maybe_save(args.steps, state, force=True)
        ckpt.close()

    if args.export_dir and rank == 0:
        from ..serving.export import export_params

        with obs_trace.span("runner.export", dir=args.export_dir):
            export_params(args.export_dir, args.model, dataset.shape,
                          dataset.num_classes, state)
        log(f"exported_model dir={args.export_dir}")
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    # Armed here, not in main: a caller that runs main in its own process
    # keeps its threads and its process group.
    from ..runtime.lifetime import install_parent_watch

    install_parent_watch()   # die with the gang supervisor
    sys.exit(main())
