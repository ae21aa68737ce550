#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubeflow_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build the flash-attention kernels from ops/csrc (nvcc, sm_90a);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shape [4, 2048, 16, 64] bf16 and the large preset's
   head dim [2, 2048, 16, 128], with times (CUDA events), the plain
   version's time, the one-call PyTorch yardstick (PyTorch's fused causal
   attention and its backward, timed here and used nowhere in the port) and
   the bound;
   plus short correctness checks of every (dtype, head dim) instantiation;
4. model: TransformerLM at the base preset's full width and depth, flash vs
   naive attention on the same weights (held in f32; bf16 printed);
5. main path: the LM runner (base preset, lm-small, 4 steps, batch 4,
   S = 2048, attn_impl auto) with the launch counters set to 0 just
   before and read just after;
6. one JSON line per kernel set, the card's name and power limit, and the
   last line {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device, or without the port's package beside it, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time

# Tolerances (kernel vs its plain version on the same inputs).
TOL_O = 2e-2        # forward o, max-abs (the reference's own test bound)
TOL_LSE = 1e-3      # forward lse, max-abs
TOL_GRAD = 2e-2     # dq/dk/dv, max-abs relative to the max of the plain one
TOL_F32 = 1e-4      # f32 instantiations, max-abs relative to the max
TOL_LOGITS = 5e-2   # model logits flash vs naive, max-abs (tests/test_ops.py)

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (data sheet)
HBM_BYTES_S = 3.35e12

MAIN_ARGV = ["--preset", "base", "--dataset", "lm-small", "--steps", "4",
             "--batch-size", "4", "--warmup-steps", "1", "--log-every", "1"]
MAIN_STEPS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median over ``reps`` CUDA-event-timed calls of ``fn``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bounds(B, S, H, D, elem):
    """Least time (ms) for each kernel's work: max(FLOPs / bf16 peak,
    bytes / HBM rate), counting each input read once and each output
    written once, over the causal half (the tiles the inputs need)."""
    pairs = B * H * S * (S + 1) / 2
    t = B * S * H * D * elem          # one [B, S, H, D] tensor
    vec = B * S * H * 4               # one f32 [B, S, H, 1] vector
    work = {
        # name: (flops, bytes)
        "flash_fwd": (4 * D * pairs, 3 * t + t + vec),
        "flash_dq": (6 * D * pairs, 4 * t + 2 * vec + t),
        "flash_dkv": (8 * D * pairs, 4 * t + 2 * vec + 2 * t),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_S * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def max_rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-12))


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def kernel_phase(torch, fa, shape, dtype, seed, timed=True):
    """Kernel vs plain version at ``shape`` ([B, S, H, D]); returns one
    record per kernel."""
    import torch.nn.functional as F

    B, S, H, D = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda scale: (torch.randn(shape, generator=g, device=dev)
                        * scale).to(dtype)
    q, k, v, do = mk(1 / math.sqrt(D)), mk(1.0), mk(1.0), mk(1.0)

    o, lse = fa._fwd(q, k, v)
    o_r, lse_r = fa._fwd_reference(q, k, v)
    delta = torch.sum(do.float() * o_r.float(), -1, keepdim=True)
    dq = fa._dq(q, k, v, do, lse_r, delta)
    dq_r = fa._dq_reference(q, k, v, do, lse_r, delta)
    dk, dv = fa._dkv(q, k, v, do, lse_r, delta)
    dk_r, dv_r = fa._dkv_reference(q, k, v, do, lse_r, delta)
    torch.cuda.synchronize()

    f32 = dtype == torch.float32
    errs = {
        "flash_fwd": (max(max_abs(o, o_r), max_abs(lse, lse_r)),
                      max(max_rel(o, o_r), max_abs(lse, lse_r)) if f32
                      else max_abs(o, o_r)),
        "flash_dq": (max_abs(dq, dq_r), max_rel(dq, dq_r)),
        "flash_dkv": (max(max_abs(dk, dk_r), max_abs(dv, dv_r)),
                      max(max_rel(dk, dk_r), max_rel(dv, dv_r))),
    }
    tag = f"{list(shape)} {str(dtype).replace('torch.', '')}"
    for name, (_, err) in errs.items():
        tol = TOL_F32 if f32 else (TOL_O if name == "flash_fwd" else TOL_GRAD)
        check(err <= tol, f"{name} at {tag}: error {err:.3g} > {tol}")
    if not f32:
        e_lse = max_abs(lse, lse_r)
        check(e_lse <= TOL_LSE, f"flash_fwd lse at {tag}: {e_lse:.3g}")
    if not timed:
        log(f"kernel_check {tag} " + " ".join(
            f"{n}={e[1]:.3g}" for n, e in errs.items()))
        return []

    ms = {
        "flash_fwd": time_ms(torch, lambda: fa._fwd(q, k, v), 10),
        "flash_dq": time_ms(torch, lambda: fa._dq(
            q, k, v, do, lse_r, delta), 10),
        "flash_dkv": time_ms(torch, lambda: fa._dkv(
            q, k, v, do, lse_r, delta), 10),
    }
    plain_ms = {
        "flash_fwd": time_ms(torch, lambda: fa._fwd_reference(q, k, v), 3, 1),
        "flash_dq": time_ms(torch, lambda: fa._dq_reference(
            q, k, v, do, lse_r, delta), 3, 1),
        "flash_dkv": time_ms(torch, lambda: fa._dkv_reference(
            q, k, v, do, lse_r, delta), 3, 1),
    }
    # Yardstick: one PyTorch call for the same function ([B, H, S, D]).
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, is_causal=True, scale=1.0)
    lib_fwd = time_ms(torch, lambda: sdpa(qt, kt, vt), 10)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    out = sdpa(qg, kg, vg)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), dot, retain_graph=True), 10)
    library_ms = {"flash_fwd": lib_fwd, "flash_dq": lib_bwd,
                  "flash_dkv": lib_bwd}
    bnd = bounds(B, S, H, D, q.element_size())
    recs = []
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        recs.append({
            "name": name, "shape": list(shape),
            "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": errs[name][0], "max_err": errs[name][1],
            "ms": ms[name], "plain_ms": plain_ms[name],
            "library_ms": library_ms[name],
            "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
        })
        log(f"kernel {name} {tag} max_abs_err={errs[name][0]:.3g} "
            f"max_err={errs[name][1]:.3g} ms={ms[name]:.4f} "
            f"plain_ms={plain_ms[name]:.4f} "
            f"library_ms={library_ms[name]:.4f} "
            f"bound_ms={bnd[name][0]:.4f} ({bnd[name][1]})")
    return recs


def model_phase(torch, dev):
    """TransformerLM at the base preset's full width and depth, flash vs
    naive attention on the same weights. The bound (5e-2, the reference's
    tests/test_ops.py) is held in f32, the setting it comes from. In bf16
    the naive path rounds the scores to bf16 before the softmax, so both
    bf16 paths are printed against the f32 naive logits instead."""
    from kubeflow_tpu_torch.models.transformer import (
        TransformerLM, preset_config)

    gen = torch.Generator(device=dev).manual_seed(0)
    logits = {}
    weights = None
    tokens = None
    for dtype in ("float32", "bfloat16"):
        for impl in ("naive", "flash"):
            cfg = preset_config("base", max_seq_len=2048, attn_impl=impl,
                                dtype=dtype)
            model = TransformerLM(cfg, device=dev, generator=gen)
            if weights is None:
                weights = model.state_dict()
                tokens = torch.randint(0, cfg.vocab_size, (1, 2048),
                                       device=dev, generator=gen)
            else:
                model.load_state_dict(weights)
            with torch.no_grad():
                out = model(tokens)
            check(tuple(out.shape) == (1, 2048, cfg.vocab_size),
                  f"logits shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()),
                  f"{impl} {dtype} logits not finite")
            logits[impl, dtype] = out
            del model
    err = max_abs(logits["flash", "float32"], logits["naive", "float32"])
    exact = logits["naive", "float32"]
    e_fb = max_abs(logits["flash", "bfloat16"], exact)
    e_nb = max_abs(logits["naive", "bfloat16"], exact)
    log(f"model base d=1024 L=24 S=2048 f32 "
        f"flash_vs_naive_logits_max_abs={err:.4g} (tol {TOL_LOGITS}); "
        f"bf16 vs f32-naive max_abs: flash={e_fb:.4g} naive={e_nb:.4g}")
    check(err <= TOL_LOGITS, f"flash vs naive logits {err:.4g}")
    del logits, weights, exact
    torch.cuda.empty_cache()


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def main_path_phase(torch, fa):
    from kubeflow_tpu_torch.models.transformer import preset_config
    from kubeflow_tpu_torch.runners import lm_runner
    from kubeflow_tpu_torch.utils.flops import (
        peak_flops_per_card, transformer_train_flops_per_token)

    buf = io.StringIO()
    fa.reset_launches()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = lm_runner.main(MAIN_ARGV)
    launches = dict(fa.LAUNCHES)
    torch.cuda.synchronize()
    out = buf.getvalue()
    check(rc == 0, f"lm_runner returned {rc}")
    losses = [float(x) for x in re.findall(r"^step=\d+ loss=(\S+)", out, re.M)]
    final = re.search(r"^loss=(\S+)$", out, re.M)
    check(final is not None and len(losses) == MAIN_STEPS - 1,
          f"runner output lacks the step/loss lines:\n{out}")
    check(all(math.isfinite(x) for x in losses + [float(final.group(1))]),
          f"non-finite loss: {losses} {final.group(1)}")
    m = re.search(r"model_params=(\d+)", out)
    check("seq_len=2048" in out and m is not None, "runner_start/params")
    cfg = preset_config("base", vocab_size=32_000, max_seq_len=2048)
    n_layers = cfg.n_layers
    want = {"flash_fwd": n_layers * MAIN_STEPS + n_layers,
            "flash_dq": n_layers * MAIN_STEPS,
            "flash_dkv": n_layers * MAIN_STEPS}
    check(launches == want, f"launches {launches} != {want}")
    steps = re.findall(r"step_time=(\S+) tokens_per_s=(\S+)", out)
    step_time = sorted(float(s) for s, _ in steps)[len(steps) // 2]
    tps = sorted(float(t) for _, t in steps)[len(steps) // 2]
    mfu = tps * transformer_train_flops_per_token(cfg, 2048) / \
        peak_flops_per_card()
    log(f"main_path preset=base d={cfg.d_model} L={n_layers} S=2048 b=4 "
        f"steps={MAIN_STEPS} median_step_time={step_time} "
        f"tokens_per_s={tps:.0f} mfu={mfu:.4f} "
        f"peak_memory_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"launches={json.dumps(launches)}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false; chip_smoke.py "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "kubeflow_tpu_torch")):
        print(f"error: no kubeflow_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    card = card_line()
    log(f"card: {card}")

    # 2. build
    from kubeflow_tpu_torch.ops import build
    from kubeflow_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    build.load_library()
    log(f"build_seconds={time.perf_counter() - t0:.1f} "
        f"lib={build.BUILD_DIR / build.LIB_NAME} "
        f"(nvcc and ptxas report: {build.BUILD_DIR / 'build.log'})")

    # 3. kernels
    for D in (64, 128, 192, 256):
        for dtype in (torch.float32, torch.bfloat16):
            kernel_phase(torch, fa, (1, 512, 2, D), dtype, seed=D,
                         timed=False)
    main_recs = kernel_phase(torch, fa, (4, 2048, 16, 64), torch.bfloat16,
                             seed=1)
    large_recs = kernel_phase(torch, fa, (2, 2048, 16, 128), torch.bfloat16,
                              seed=2)
    torch.cuda.empty_cache()

    # 4. model
    model_phase(torch, dev)

    # 5. main path
    launches = main_path_phase(torch, fa)

    # 6. report
    meta = {
        "flash_fwd": ("kubeflow_tpu_torch/ops/csrc/flash_fwd.cu",
                      "kubeflow_tpu/ops/flash_attention.py:64"),
        "flash_dq": ("kubeflow_tpu_torch/ops/csrc/flash_bwd.cu",
                     "kubeflow_tpu/ops/flash_attention.py:127"),
        "flash_dkv": ("kubeflow_tpu_torch/ops/csrc/flash_bwd.cu",
                      "kubeflow_tpu/ops/flash_attention.py:158"),
    }

    def entries(recs, with_launches):
        out = []
        for r in recs:
            src, rep = meta[r["name"]]
            e = {"name": r["name"], "route": "cuda", "source": src,
                 "replaces": rep,
                 "launches": launches[r["name"]] if with_launches else None}
            e.update({k: v for k, v in r.items() if k != "name"})
            out.append(e)
        return out

    log(json.dumps({"kernels_large_head_dim": entries(large_recs, False)}))
    log(json.dumps({"kernels": entries(main_recs, True)}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
