"""Flagship LM training worker on one GPU — port of
``kubeflow_tpu/runners/lm_runner.py``.

Same flags and the same stdout contract (``runner_start …``,
``model_params=…``, ``step=… loss=… accuracy=… step_time=…
tokens_per_s=…``, ``train_done …``, ``loss=``, ``accuracy=``,
``entropy_floor=``, and ``exported_lm dir=…`` after ``--export-dir``), plus
``--device {cuda,cpu}``:

    python -m kubeflow_tpu_torch.runners.lm_runner --preset=base \
        --dataset=lm-small --steps=100 --batch-size=4

``--export-dir`` writes the reference's LM export format
(``serving/lm_server.py``), which both packages serve. With
``KFX_CHECKPOINT_DIR`` set (and no ``--no-checkpoint``) it saves the
params, AdamW's moments and count every ``--checkpoint-every`` steps
(``training/checkpoint.py``) and resumes from the newest on restart,
printing ``resumed_from_checkpoint step=K``. ``--remat``
(with ``--remat-policy``, the reference's policies) and ``--experts E``
(MoE, top-2; the plan gains ``/ep{E}``) train as in the reference.
Flags that need parts of the reference not ported yet (meshes) exit 2
naming the ROADMAP item that brings them. ``--collective-overlap`` has no counterpart on one GPU: ``auto`` and
``off`` are accepted as no-ops, ``on`` exits 2.
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
                   help="context parallel ways (ring attention)")
    p.add_argument("--experts", type=int, default=0, help="MoE experts (ep)")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat-policy", default="nothing",
                   help="what remat may keep (needs --remat)")
    p.add_argument("--attn-impl", default="auto",
                   choices=["auto", "flash", "naive", "xla", "ring"],
                   help="attention path; 'auto' picks the CUDA flash "
                        "kernels inside --flash-window on a CUDA device; "
                        "'naive' (alias 'xla') forces the dense oracle")

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
                   help="no counterpart on one GPU: auto/off are no-ops")
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


def _parallelism_from_env() -> dict:
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


def _unported(args) -> str:
    """The first requested feature this slice does not have, as an error
    message naming the ROADMAP item that brings it; "" if none."""
    mesh = "ROADMAP.md Queue A 6, multi-GPU"
    checks = (
        (args.tp > 1, f"--tp>1 needs {mesh}"),
        (args.pp > 1, f"--pp>1 needs {mesh}"),
        (args.cp > 1, f"--cp>1 needs {mesh}"),
        (args.sp, f"--sp needs {mesh}"),
        (args.fsdp, f"--fsdp needs {mesh}"),
        (args.collective_overlap == "on", "--collective-overlap=on has no "
                                          "counterpart on one GPU"),
    )
    for bad, msg in checks:
        if bad:
            return msg
    return ""


def main(argv=None) -> int:
    args = parse_args(argv)
    par = _parallelism_from_env()

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
    msg = _unported(args)
    if msg:
        print(f"error: {msg}", file=sys.stderr)
        return 2

    from ..data.lm import get_lm_dataset
    from ..device import resolve_device
    from ..models.transformer import n_params, preset_config
    from ..parallel.lm_train import LMHyperParams, LMTrainLoop

    device = resolve_device(args.device)
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
                        remat=args.remat, remat_policy=args.remat_policy,
                        attn_impl=args.attn_impl, **flash_overrides)
    hp = LMHyperParams(learning_rate=args.learning_rate,
                       warmup_steps=args.warmup_steps,
                       total_steps=args.steps, seed=args.seed)
    loop = LMTrainLoop(cfg, hp, device=device)
    rank, world = 0, 1
    print(f"runner_start model=transformer-{args.preset} "
          f"dataset={args.dataset} rank={rank} world={world} "
          f"devices=1 plan=pp1/dp1/tp1"
          f"{f'/ep{cfg.n_experts}' if cfg.n_experts else ''} "
          f"seq_len={ds.seq_len} "
          f"device={device.type}", flush=True)

    model = loop.init_state()
    print(f"model_params={n_params(model)}", flush=True)

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

    it = ds.batches(args.batch_size, shard_index=rank, num_shards=world)
    for _ in range(start_step):
        next(it)
    t_start = time.time()
    t_last = t_start
    tokens_per_step = args.batch_size * ds.seq_len
    loss = acc = 0.0
    warmed = False
    last_log_step = start_step
    for step in range(start_step, args.steps):
        if step == args.fail_at_step:
            if ckpt is not None:
                ckpt.wait()   # the last scheduled save is durable first
            print(f"fault_injection_crash step={step}", flush=True)
            os._exit(17)
        loss, acc = loop.train_step(next(it))
        if not warmed:
            # The first step pays the kernel build and warm-up; the
            # logged step times measure steady state from here on.
            warmed = True
            t_last = time.time()
            last_log_step = step + 1
        if ((step + 1) % args.log_every == 0 or step + 1 == args.steps) \
                and step + 1 > last_log_step:
            now = time.time()
            dt = (now - t_last) / (step + 1 - last_log_step)
            tps = tokens_per_step / dt if dt > 0 else 0.0
            print(f"step={step + 1} loss={loss:.6f} accuracy={acc:.6f} "
                  f"step_time={dt:.4f} tokens_per_s={tps:.0f}", flush=True)
            t_last = now
            last_log_step = step + 1
        if ckpt is not None:
            ckpt.maybe_save(step + 1, loop)

    metrics = loop.evaluate(ds.eval_batch(args.batch_size))
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
        from ..models.convert import params_to_jax
        from ..serving.lm_server import export_lm

        export_lm(args.export_dir, cfg, params_to_jax(model.state_dict()))
        print(f"exported_lm dir={args.export_dir}", flush=True)
    return 0


if __name__ == "__main__":
    # Armed here, not in main: a caller that runs main in its own process
    # keeps its threads and its process group.
    from ..runtime.lifetime import install_parent_watch

    install_parent_watch()   # die with the gang supervisor
    sys.exit(main())
