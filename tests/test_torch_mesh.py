"""The port's mesh and sharding rules (kubeflow_tpu_torch/parallel/mesh.py,
models/transformer.py param_logical_axes) against the reference's
(kubeflow_tpu/parallel/mesh.py), with no processes: the factorisation and
its error texts, the rules table, and for every param of the tiny and
the MoE configs the dimension each mesh axis cuts under the same plans
(tp, fsdp, ep, the collision and divisibility rules)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models import transformer as ref_tf  # noqa: E402
from kubeflow_tpu.parallel import mesh as ref  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port_tf  # noqa: E402
from kubeflow_tpu_torch.parallel import mesh as port  # noqa: E402

FACTOR_CASES = [
    (8, 2, 2, None), (8, 2, None, 2), (8, None, None, None), (8, 4, 2, None),
    (4, 2, None, 2), (2, None, 2, None), (8, 3, None, None),
    (8, None, 3, None), (8, None, None, 3), (6, 4, None, None),
    (8, 2, 2, 4), (1, 2, None, None), (1, None, 2, None), (1, None, None, 2),
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("n,tp,pp,cp", FACTOR_CASES)
def test_factor_matches_reference(n, tp, pp, cp):
    assert _outcome(port._factor, n, tp, pp, cp) == \
        _outcome(ref._factor, n, tp, pp, cp)


def test_make_mesh_at_world1_matches_reference():
    mesh, plan = port.make_mesh()
    assert (plan.pp, plan.dp, plan.cp, plan.tp) == (1, 1, 1, 1)
    assert mesh.shape == {"stage": 1, "data": 1, "ctx": 1, "model": 1}
    assert mesh.coords == {a: 0 for a in port.AXES}
    assert port.AXES == ("stage", "data", "ctx", "model")
    devs = jax.devices()[:1]
    for kw in (dict(tp=2), dict(pp=2), dict(cp=2)):
        with pytest.raises(ValueError) as want:
            ref.make_mesh(devices=devs, **kw)
        with pytest.raises(ValueError) as got:
            port.make_mesh(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="requested a 2-device mesh"):
        port.make_mesh(2)


@pytest.mark.parametrize("kw", [dict(), dict(pp=2, dp=2, tp=2),
                                dict(dp=4, cp=2, fsdp=True)])
def test_plan_matches_reference(kw):
    a, b = port.MeshPlan(**kw), ref.MeshPlan(**kw)
    assert a.n_devices == b.n_devices
    assert a.axis_sizes() == b.axis_sizes()
    assert port.param_sharding_rules(a) == ref.param_sharding_rules(b)


def test_duplicate_axis_resolution():
    """MoE expert weights under fsdp: 'expert' and fsdp'd 'embed' both
    map to "data"; the first dim wins, the second is replicated."""
    rules = port.param_sharding_rules(port.MeshPlan(dp=4, tp=2, fsdp=True))
    sizes = port.MeshPlan(dp=4, tp=2).axis_sizes()
    assert port.logical_sharding(sizes, ("expert", "embed", "expert_mlp"),
                                 rules) == ("data", None, "model")


SMALL = dict(vocab_size=128, d_model=32, n_heads=2, head_dim=16,
             n_layers=2, d_ff=64, max_seq_len=32)
# (config overrides, mesh keywords over the 8 virtual devices): tp2,
# fsdp over 8, fsdp+tp2 (the expert/embed collision), ep over 4 and
# over 8 (4 experts on 8 data ranks: replicated, embed then takes
# "data"), tp4 (2 heads: dropped), cp.
SPEC_CASES = [
    ({}, dict(tp=2)), ({}, dict(fsdp=True)), ({}, dict(tp=2, fsdp=True)),
    ({"n_experts": 4}, dict(tp=2, fsdp=True)),
    ({"n_experts": 4}, dict(fsdp=True)), ({"n_experts": 8}, dict()),
    ({}, dict(tp=4)), ({}, dict(tp=2, cp=2, fsdp=True)),
]


def _ref_specs(cfg_kw, mesh_kw):
    mesh, plan = ref.make_mesh(8, **mesh_kw)
    cfg = ref_tf.TransformerConfig(**SMALL, **cfg_kw, dtype=jnp.float32)
    abstract = jax.eval_shape(lambda: ref_tf.TransformerLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    sh = ref.tree_shardings(mesh, ref_tf.param_logical_axes(abstract),
                            ref.param_sharding_rules(plan), abstract)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(sh)[0]:
        out[tuple(p.key for p in path)] = tuple(s.spec)
    return out, abstract, plan


@pytest.mark.parametrize("cfg_kw,mesh_kw", SPEC_CASES,
                         ids=lambda x: ",".join(f"{k}{v}" for k, v in
                                                x.items()) or "plain")
def test_every_param_cut_as_the_reference(cfg_kw, mesh_kw):
    want, abstract, plan = _ref_specs(cfg_kw, mesh_kw)
    shapes_ref = {tuple(p.key for p in path): leaf.shape for path, leaf in
                  jax.tree_util.tree_flatten_with_path(abstract)[0]}
    cfg = port_tf.TransformerConfig(**SMALL, **cfg_kw, dtype="float32")
    model = port_tf.TransformerLM(cfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    axes = port_tf.param_logical_axes(shapes)
    pplan = port.MeshPlan(pp=plan.pp, dp=plan.dp, cp=plan.cp, tp=plan.tp,
                          fsdp=plan.fsdp)
    got = port.tree_shardings(pplan.axis_sizes(), axes,
                              port.param_sharding_rules(pplan), shapes)
    assert set(got) == set(shapes)
    for name, spec in got.items():
        parts = name.split(".")
        stacked = parts[0] == "layers"
        path = ("layers",) + tuple(parts[2:]) if stacked else tuple(parts)
        ndim = len(shapes_ref[path])
        ref_spec = want[path] + (None,) * (ndim - len(want[path]))
        if stacked:
            ref_spec = ref_spec[1:]   # the reference's "layers" axis
        assert spec == ref_spec, (name, spec, ref_spec)
    # Spot checks the reference's tests make.
    if cfg_kw.get("n_experts") and cfg_kw["n_experts"] % plan.dp == 0:
        assert got["layers.0.moe.wi"][0] == "data"
    if mesh_kw.get("tp") == 2:
        assert got["layers.0.attn.query.kernel"][1] == "model"


def test_param_logical_axes_cover_the_tree():
    cfg = port_tf.TransformerConfig(**SMALL, n_experts=4, dtype="float32")
    shapes = {n: tuple(p.shape) for n, p in
              port_tf.TransformerLM(cfg).named_parameters()}
    axes = port_tf.param_logical_axes(shapes)
    assert axes["embed.embedding"] == ("vocab", "embed")
    assert axes["layers.1.moe.wi"] == ("expert", "embed", "expert_mlp")
    assert axes["layers.0.ln1.scale"] == (None,)
    assert all(len(axes[n]) == len(s) for n, s in shapes.items())
    with pytest.raises(ValueError, match="axes"):
        port_tf.param_logical_axes({"lm_head.kernel": (4,)})


def test_local_shard_keeps_swiglu_halves_paired():
    """A rank's slice of mlp.wi holds the matching columns of the gate
    and the up half (the hidden dim is gate || up), so its SwiGLU is
    local."""
    class Mesh:
        shape = {"stage": 1, "data": 1, "ctx": 1, "model": 2}

        def __init__(self, i):
            self.coords = {"stage": 0, "data": 0, "ctx": 0, "model": i}

        def index(self, axis):
            return self.coords[axis]

    import torch

    d, F = 4, 6
    wi = torch.arange(d * 2 * F, dtype=torch.float32).reshape(d, 2 * F)
    spec = (None, "model")
    parts = [port_tf.local_shard("layers.0.mlp.wi.kernel", wi, spec, Mesh(i))
             for i in (0, 1)]
    for i, part in enumerate(parts):
        gate, up = part.chunk(2, -1)
        np.testing.assert_array_equal(gate, wi[:, i * 3:(i + 1) * 3])
        np.testing.assert_array_equal(up, wi[:, F + i * 3:F + (i + 1) * 3])
