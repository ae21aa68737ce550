"""What tests/test_torch_parallel.py and test_torch_parallel4.py share:
the port's LM training across ranks (kubeflow_tpu_torch/parallel/:
mesh, comm, ring_attention, pipeline, lm_train on a mesh) against the
JAX package's mesh runs and against the port's own world 1.

gloo groups on the CPU (2 or 4 ranks, tests/_torch_parallel_worker.py,
started once a test module) run every plan from the JAX package's init,
carried across with params_from_jax, on the same LMDataset global
batches; meanwhile this process runs the JAX LMTrainLoop /
PipelinedLMTrainLoop on the reference's virtual CPU mesh with the same
plan, and the port's world-1 loop. Bars, all in f32: per-step losses
within the reference's cross-process RTOL (2e-3) for 4 steps; the
gathered params after the steps within 1e-4 of each tensor's largest
|value| + 1e-7; ring attention's output and grads within 1e-5 of the
reference's make_ring_attention (grads relative to their largest
|value|)."""

import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kubeflow_tpu.data.lm import LMDataset
from kubeflow_tpu.models.transformer import TransformerConfig as RefCfg
from kubeflow_tpu.parallel.lm_train import (
    LMHyperParams as RefHP, LMTrainLoop as RefLoop)
from kubeflow_tpu.parallel.mesh import make_mesh as ref_mesh
from kubeflow_tpu.parallel.pipeline import PipelinedLMTrainLoop as RefPipe
from kubeflow_tpu.parallel.ring_attention import (
    make_ring_attention as ref_ring)
from kubeflow_tpu_torch.models.convert import params_from_jax, params_to_jax
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.parallel import spmd_check
from kubeflow_tpu_torch.parallel.lm_train import LMHyperParams, LMTrainLoop

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = dict(vocab_size=128, d_model=32, n_heads=2, head_dim=16, n_layers=4,
            d_ff=64, max_seq_len=32)
HP = dict(total_steps=10, warmup_steps=2, seed=0)
STEPS, BATCH = 4, 16
RTOL = 2e-3

# name: (ranks, make_mesh keywords, config overrides, microbatches)
PLANS = {
    "dp2": (2, {}, {}, None),
    "tp2": (2, {"tp": 2}, {}, None),
    "tp2_sp": (2, {"tp": 2}, {"sp": True}, None),
    "cp2": (2, {"cp": 2}, {"cp": 2}, None),
    "pp2": (2, {"pp": 2}, {}, 4),
    "ep": (2, {}, {"n_experts": 4}, None),
    "fsdp_tp2": (4, {"tp": 2, "fsdp": True}, {}, None),
    "tp2_cp2": (4, {"tp": 2, "cp": 2}, {"cp": 2}, None),
}
RING = {2: (2, 64, 4, 16), 4: (2, 64, 4, 16)}


def _batches():
    ds = LMDataset(vocab_size=TINY["vocab_size"], seq_len=TINY["max_seq_len"])
    return list(ds.batches(BATCH, steps=STEPS))


def _jax_init(experts):
    mesh, plan = ref_mesh(1)
    cfg = RefCfg(**TINY, n_experts=experts, dtype=jnp.float32)
    state = RefLoop(cfg, mesh, plan, RefHP(**HP)).init_state()
    return jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))


def _jax_run(name):
    n, mkw, ckw, micro = PLANS[name]
    mesh, plan = ref_mesh(n, **mkw)
    cfg = RefCfg(**TINY, **ckw, dtype=jnp.float32)
    if plan.pp > 1:
        loop = RefPipe(cfg, mesh, plan, RefHP(**HP), n_microbatches=micro)
    else:
        loop = RefLoop(cfg, mesh, plan, RefHP(**HP))
    state = loop.init_state()
    losses = []
    for b in _batches():
        state, loss, _ = loop.train_step(state, b)
        losses.append(loss)
    return losses, params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.device_get(state.params)))


def _port_world1(init, experts, steps=STEPS, start=None):
    cfg = TransformerConfig(**TINY, n_experts=experts, dtype="float32")
    loop = LMTrainLoop(cfg, LMHyperParams(**HP), device="cpu")
    loop.init_state(init)
    if start is not None:
        loop.load_state_tree(start)
    losses = [loop.train_step(b)[0]
              for b in _batches()[STEPS - steps:]]
    return losses, loop.model.state_dict(), loop


def _tasks(world, tmp, names):
    """The training tasks of the plans ``names`` that run on ``world``
    ranks, then the ring attention on that many."""
    tasks = []
    for name in names:
        n, mkw, ckw, micro = PLANS[name]
        if n != world:
            continue
        tasks.append({"kind": "train", "name": name, "mesh": mkw,
                      "cfg": {**TINY, **ckw, "dtype": "float32"},
                      "hp": HP, "micro": micro, "batch": BATCH,
                      "steps": STEPS, "save_at": 2,
                      "init": str(tmp / f"init{ckw.get('n_experts', 0)}.pt")})
    tasks.append({"kind": "ring", "name": f"ring{world}",
                  "inputs": str(tmp / f"ring{world}.npz")})
    return tasks


def _ring_inputs(world, seed):
    B, S, H, D = RING[world]
    rng = np.random.default_rng(seed)
    return {"q": (rng.normal(size=(B, S, H, D)) / 3.0).astype(np.float32),
            "k": rng.normal(size=(B, S, H, D)).astype(np.float32),
            "v": rng.normal(size=(B, S, H, D)).astype(np.float32)}


def make_runs(tmp, names, worlds, extra):
    """Start a gloo group of each size in ``worlds`` on the plans
    ``names`` (and ``extra``: {world: [task]}) in threads, run their JAX
    references and the port's world-1 runs here meanwhile, and return
    every result."""
    experts = sorted({PLANS[n][2].get("n_experts", 0) for n in names} | {0})
    inits = {e: _jax_init(e) for e in experts}
    for e, tree in inits.items():
        torch.save(params_from_jax(tree), tmp / f"init{e}.pt")
    for world in worlds:
        np.savez(tmp / f"ring{world}.npz", **_ring_inputs(world, world))
    errors = []

    def pool(world):
        out = tmp / f"out{world}"
        out.mkdir()
        path = tmp / f"tasks{world}.json"
        path.write_text(json.dumps(_tasks(world, tmp, names)
                                   + extra.get(world, [])))
        try:
            spmd_check.run_ranks(
                [sys.executable, os.path.join(HERE, "_torch_parallel_worker.py"),
                 str(path), str(out)], world, timeout=300,
                env={"OMP_NUM_THREADS": "1"})
        except Exception as e:  # re-raised in the test thread below
            errors.append(e)

    threads = [threading.Thread(target=pool, args=(w,)) for w in worlds]
    for t in threads:
        t.start()
    jax_runs = {name: _jax_run(name) for name in names}
    world1 = {e: _port_world1(params_from_jax(inits[e]), e)
              for e in experts}
    for t in threads:
        t.join(timeout=400)
    assert not any(t.is_alive() for t in threads), "a gloo group hung"
    if errors:
        raise errors[0]
    port = {}
    for world in worlds:
        for f in os.listdir(tmp / f"out{world}"):
            port[f[:-3]] = torch.load(tmp / f"out{world}" / f,
                                      weights_only=False)
    return {"jax": jax_runs, "world1": world1, "port": port, "tmp": tmp,
            "inits": inits}


def _params_close(got, want):
    assert set(got) == set(want)
    for k in want:
        a, b = got[k].detach().numpy(), want[k].detach().numpy()
        tol = 1e-4 * float(np.max(np.abs(b))) + 1e-7
        err = float(np.max(np.abs(a - b)))
        assert err <= tol, (k, err, tol)


def _losses_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def check_plan_vs_jax(runs, name):
    got = runs["port"][name]
    assert np.prod(got["plan"]) == PLANS[name][0]
    want_losses, want_params = runs["jax"][name]
    _losses_close(got["losses"], want_losses)
    _params_close(got["params"], want_params)


def check_plan_vs_world1(runs, name):
    got = runs["port"][name]
    losses, params, _ = runs["world1"][PLANS[name][2].get("n_experts", 0)]
    _losses_close(got["losses"], losses)
    _params_close(got["params"], params)


def check_ring(runs, world):
    from jax.sharding import Mesh

    x = _ring_inputs(world, world)
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(world), ("cp",))
    ring = ref_ring(mesh, "cp")
    q, k, v = (jnp.asarray(x[n]) for n in ("q", "k", "v"))
    out = jax.jit(ring)(q, k, v)
    grads = jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v) ** 2),
                     argnums=(0, 1, 2))(q, k, v)
    got = runs["port"][f"ring{world}"]
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(out),
                               atol=1e-5, rtol=0)
    for name, g in zip(("dq", "dk", "dv"), grads):
        g = np.asarray(g)
        err = float(np.max(np.abs(got[name].numpy() - g)))
        assert err <= 1e-5 * max(1.0, float(np.max(np.abs(g)))), (name, err)
    # The first query chunk sees no key of the later chunks: those blocks
    # are fully masked, and the first row attends to itself alone.
    np.testing.assert_allclose(got["out"].numpy()[:, 0], x["v"][:, 0],
                               atol=1e-6, rtol=0)


def check_checkpoint(runs, name):
    """The tree the plan's state_tree gave after 2 steps loads into the
    world-1 pp1 loop, which then trains steps 3-4 as the plan did; its
    params convert to the JAX package's tree."""
    got = runs["port"][name]
    tree = got["tree"]
    assert tree["step"] == 2 and tree["opt_state"]["count"] == 2
    init = params_from_jax(runs["inits"][0])
    losses, params, loop = _port_world1(init, 0, steps=2, start=tree)
    assert loop.step == 4
    _losses_close(losses, got["losses"][2:])
    _params_close(got["params"], params)
    jax_tree = params_to_jax(tree["params"])
    assert jax.tree_util.tree_structure(jax_tree) == \
        jax.tree_util.tree_structure(runs["inits"][0])
