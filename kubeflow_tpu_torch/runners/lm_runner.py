"""Flagship LM training worker — port of
``kubeflow_tpu/runners/lm_runner.py``: the transformer over the full
parallelism stack (dp/fsdp/tp/sp/ep/cp/pp) on a mesh of ranks, one
process a device.

Same flags and the same stdout contract (``runner_start … plan=…``,
``model_params=…``, ``collective_allreduce …`` when dp > 1, ``step=…
loss=… accuracy=… step_time=… tokens_per_s=…``, ``train_done …``,
``loss=``, ``accuracy=``, ``entropy_floor=``, and ``exported_lm dir=…``
after ``--export-dir``), plus ``--device {cuda,cpu}``:

    python -m kubeflow_tpu_torch.runners.lm_runner --preset=base \\
        --dataset=lm-small --steps=100 --batch-size=4

Several processes (``KFX_NUM_PROCESSES``, ``KFX_PROCESS_ID``,
``KFX_COORDINATOR_ADDRESS``, as the JAXJob operator sets them) rendezvous
through ``jax_runner.initialize_distributed`` and factor into the
reference's mesh (``--tp/--pp/--cp/--fsdp/--sp``, or the operator's
``KFX_PARALLELISM`` keys, the CLI winning). Every rank of one data
coordinate feeds the same rows (``--batch-size`` is the global batch);
only rank 0 exports. ``KFX_CHECKPOINT_DIR`` (and no ``--no-checkpoint``)
saves the full state every ``--checkpoint-every`` steps from rank 0 and
resumes from the newest on restart, printing ``resumed_from_checkpoint
step=K``; the checkpoint holds the world-1 tree, so any plan resumes it.
``--collective-overlap`` reduces the data-parallel grads in buckets
started during the backward (``parallel/overlap.py``; auto: on over
nccl). With ``KFX_WORKDIR`` set, the ``xla.compile`` (the first step),
``train.window`` and ``train.collective`` spans go to its spans file
(``obs/trace.py``); the reference's runner.init and rendezvous spans are
not ported (ROADMAP.md Queue A 8).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="kfx LM training runner (GPU)")
    p.add_argument("--preset", default="tiny",
                   help="transformer size preset (tiny|small|base|large)")
    p.add_argument("--dataset", default="lm-tiny")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seq-len", type=int, default=0,
                   help="override dataset/preset sequence length")
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=int, default=50)
    p.add_argument("--tp", type=int, default=0, help="tensor parallel ways")
    p.add_argument("--pp", type=int, default=1, help="pipeline stages")
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--sp", action="store_true", help="sequence parallelism")
    p.add_argument("--cp", type=int, default=1,
                   help="context parallel ways (ring attention over 'ctx')")
    p.add_argument("--experts", type=int, default=0, help="MoE experts (ep)")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat-policy", default="nothing",
                   help="what remat may keep (needs --remat)")
    p.add_argument("--attn-impl", default="auto",
                   choices=["auto", "flash", "naive", "xla", "ring"],
                   help="attention path; 'auto' picks the CUDA flash "
                        "kernels inside --flash-window on a CUDA device; "
                        "'naive' (alias 'xla') forces the dense oracle; "
                        "'ring' asserts the sequence axis is sharded "
                        "(--cp>1)")

    def flash_window(value: str):
        lo, _, hi = value.partition(":")
        try:
            return (int(lo), int(hi) if hi else None)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"expected MIN[:MAX] integers, got {value!r}") from None

    p.add_argument("--flash-window", default=None, type=flash_window,
                   help="MIN[:MAX] seq-len window where 'auto' uses flash "
                        "(default: the reference's 1024:4096, measured on a "
                        "TPU v5e; MAX 0 = unbounded)")
    p.add_argument("--microbatches", type=int, default=0)
    p.add_argument("--collective-overlap", default="auto",
                   choices=["auto", "on", "off"],
                   help="reduce the data-parallel grads in buckets started "
                        "during the backward (parallel/overlap.py); auto: "
                        "on over nccl")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint-every", type=int, default=200)
    p.add_argument("--keep-checkpoints", type=int, default=2)
    p.add_argument("--no-checkpoint", action="store_true")
    p.add_argument("--fail-at-step", type=int, default=-1)
    p.add_argument("--export-dir", default="",
                   help="after training, write a servable LM export here")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def parallelism_from_env() -> dict:
    """The operator-injected ``KFX_PARALLELISM`` JSON (flag defaults;
    explicit CLI flags win). {} when absent or malformed."""
    raw = os.environ.get("KFX_PARALLELISM", "")
    if not raw:
        return {}
    try:
        d = json.loads(raw)
    except ValueError:
        return {}
    return d if isinstance(d, dict) else {}


def _plan_line(plan, cfg) -> str:
    return (f"plan=pp{plan.pp}/dp{plan.dp}/tp{plan.tp}"
            f"{'/fsdp' if plan.fsdp else ''}"
            f"{'/sp' if cfg.sp else ''}"
            f"{f'/cp{plan.cp}' if plan.cp > 1 else ''}"
            f"{f'/ep{cfg.n_experts}' if cfg.n_experts else ''}")


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..obs import trace as obs_trace

    par = parallelism_from_env()

    def par_int(key, default):
        try:
            return int(par.get(key, default) or default)
        except (TypeError, ValueError):
            print(f"warning: ignoring non-integer KFX_PARALLELISM "
                  f"{key}={par.get(key)!r}", file=sys.stderr)
            return default

    if par:
        if not args.tp:
            args.tp = par_int("tensor", 0)
        if args.pp <= 1:
            args.pp = par_int("pipeline", 1)
        if args.cp <= 1:
            args.cp = par_int("context", 1)
        if not args.fsdp:
            args.fsdp = bool(par.get("fsdp", False))
        if not args.sp:
            args.sp = bool(par.get("sp", False))
        if not args.microbatches:
            args.microbatches = par_int("microbatches", 0)

    from ..device import resolve_device
    from .jax_runner import initialize_distributed

    from ..data.lm import get_lm_dataset
    from ..models.transformer import preset_config
    from ..parallel.lm_train import LMHyperParams, LMTrainLoop
    from ..parallel.mesh import make_mesh
    from ..parallel.overlap import overlap_enabled
    from ..runtime.rendezvous import rank_world

    device = initialize_distributed(resolve_device(args.device))
    rank, world = rank_world()

    if args.sp and args.pp > 1:
        print("error: --sp with --pp>1 is not supported "
              "(sequence parallelism composes with tp in the non-pipelined "
              "loop only)", file=sys.stderr)
        return 2
    if args.cp > 1 and (args.pp > 1 or args.sp):
        print("error: --cp composes with dp/tp/fsdp/ep only (sp shards the "
              "same seq dim; pp runs the pipelined loop)", file=sys.stderr)
        return 2
    ds = get_lm_dataset(args.dataset, seed=args.seed,
                        seq_len=args.seq_len or None)
    flash_overrides = {}
    if args.flash_window is not None:
        lo, hi = args.flash_window
        flash_overrides["flash_min_seq"] = lo
        if hi is not None:
            flash_overrides["flash_max_seq"] = hi
    cfg = preset_config(args.preset, vocab_size=ds.vocab_size,
                        max_seq_len=ds.seq_len, n_experts=args.experts,
                        sp=args.sp, cp=args.cp, remat=args.remat,
                        remat_policy=args.remat_policy,
                        attn_impl=args.attn_impl, **flash_overrides)
    mesh, plan = make_mesh(tp=args.tp or None, pp=args.pp, cp=args.cp,
                           fsdp=args.fsdp, device_type=device.type)
    if par_int("data", 0) and plan.dp != par_int("data", 0):
        # The declarative spec promised a data-parallel width the ranks
        # cannot deliver: fail rather than train another batch layout.
        print(f"error: parallelism.data={par['data']} but the mesh "
              f"factorised dp={plan.dp} over {world} device(s) "
              f"(tp={plan.tp}, pp={plan.pp}, cp={plan.cp})",
              file=sys.stderr)
        return 2
    hp = LMHyperParams(learning_rate=args.learning_rate,
                       warmup_steps=args.warmup_steps,
                       total_steps=args.steps, seed=args.seed)
    backend = "none"
    if world > 1:
        import torch.distributed as dist

        backend = dist.get_backend()
    overlap = overlap_enabled(args.collective_overlap, backend)
    if plan.pp > 1:
        from ..parallel.pipeline import PipelinedLMTrainLoop

        loop = PipelinedLMTrainLoop(cfg, hp, device, mesh, plan,
                                    n_microbatches=args.microbatches or None)
    else:
        loop = LMTrainLoop(cfg, hp, device, mesh, plan, overlap=overlap)

    print(f"runner_start model=transformer-{args.preset} "
          f"dataset={args.dataset} rank={rank} world={world} "
          f"devices={world} {_plan_line(plan, cfg)} "
          f"seq_len={ds.seq_len} device={device.type}", flush=True)

    loop.init_state()
    n_params = loop.n_params()
    print(f"model_params={n_params}", flush=True)

    ckpt = None
    start_step = 0
    ckpt_dir = os.environ.get("KFX_CHECKPOINT_DIR", "")
    if ckpt_dir and not args.no_checkpoint:
        from ..training.checkpoint import Checkpointer

        ckpt = Checkpointer(ckpt_dir, save_every=args.checkpoint_every,
                            keep=args.keep_checkpoints)
        if ckpt.restore_latest(loop) is not None:
            start_step = loop.step
            print(f"resumed_from_checkpoint step={start_step}", flush=True)

    # Rows by data coordinate: tp, cp and pp peers feed the same rows.
    it = ds.batches(args.batch_size, shard_index=mesh.index("data"),
                    num_shards=plan.dp)
    for _ in range(start_step):
        next(it)
    t_start = time.time()
    t_last = t_start
    tokens_per_step = args.batch_size * ds.seq_len
    loss = acc = 0.0
    warmed = False
    win_start, win_step0 = t_start, start_step
    last_log_step = start_step
    for step in range(start_step, args.steps):
        if step == args.fail_at_step:
            if ckpt is not None:
                ckpt.wait()   # the last scheduled save is durable first
            print(f"fault_injection_crash step={step}", flush=True)
            os._exit(17)
        t_dispatch = time.time()
        loss, acc = loop.train_step(next(it))
        if not warmed:
            # The first step pays the kernel build and warm-up; the
            # logged step times measure steady state from here on.
            warmed = True
            now = time.time()
            obs_trace.record_span("xla.compile", t_dispatch,
                                  now - t_dispatch, start_step=str(step),
                                  model=f"transformer-{args.preset}")
            t_last = win_start = now
            win_step0 = last_log_step = step + 1
            if plan.dp > 1:
                _collective_probe(loop, mesh, plan, n_params, obs_trace)
                t_last = win_start = time.time()
        if ((step + 1) % args.log_every == 0 or step + 1 == args.steps) \
                and step + 1 > last_log_step:
            now = time.time()
            dt = (now - t_last) / (step + 1 - last_log_step)
            tps = tokens_per_step / dt if dt > 0 else 0.0
            print(f"step={step + 1} loss={loss:.6f} accuracy={acc:.6f} "
                  f"step_time={dt:.4f} tokens_per_s={tps:.0f}", flush=True)
            t_last = now
            last_log_step = step + 1
            if step + 1 > win_step0:
                obs_trace.record_span(
                    "train.window", win_start, now - win_start,
                    start_step=str(win_step0), end_step=str(step + 1),
                    tokens_per_s=f"{tps:.0f}")
            win_start, win_step0 = now, step + 1
        if ckpt is not None:
            ckpt.maybe_save(step + 1, loop)

    metrics = loop.evaluate(loop.local_rows(ds.eval_batch(args.batch_size)))
    wall = time.time() - t_start
    print(f"train_done steps={args.steps} wall_seconds={wall:.2f}",
          flush=True)
    print(f"loss={metrics['loss']:.6f}", flush=True)
    print(f"accuracy={metrics['accuracy']:.6f}", flush=True)
    print(f"entropy_floor={ds.entropy_floor():.6f}", flush=True)
    if ckpt is not None:
        ckpt.maybe_save(args.steps, loop, force=True)
        ckpt.close()
    if args.export_dir:
        params = loop.full_params()   # a collective on a mesh
        if rank == 0:
            from ..models.convert import params_to_jax
            from ..serving.lm_server import export_lm

            export_lm(args.export_dir, cfg, params_to_jax(params))
            print(f"exported_lm dir={args.export_dir}", flush=True)
    if world > 1:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    return 0


def _collective_probe(loop, mesh, plan, n_params, obs_trace) -> None:
    """train.collective: the measured cost of one gradient all-reduce
    over "data", the bound collective overlap hides; on the trace,
    compare (this x steps) against train.window. Measured on a capped
    buffer and scaled linearly."""
    from ..parallel.overlap import grad_allreduce_bytes, measure_collective

    full = grad_allreduce_bytes(n_params, plan)
    probe = min(full, 64 * 1024 * 1024)
    t_coll = time.time()
    measured = measure_collective(mesh, probe)
    est = measured * (full / probe) if probe else 0.0
    obs_trace.record_span(
        "train.collective", t_coll, measured, axis="data",
        ways=str(plan.dp), grad_bytes=str(full), probe_bytes=str(probe),
        est_step_seconds=f"{est:.6f}")
    print(f"collective_allreduce axis=data ways={plan.dp} "
          f"grad_bytes={full} est_seconds_per_step={est:.6f}", flush=True)


if __name__ == "__main__":
    # Armed here, not in main: a caller that runs main in its own process
    # keeps its threads and its process group.
    from ..runtime.lifetime import install_parent_watch

    install_parent_watch()   # die with the gang supervisor
    sys.exit(main())
