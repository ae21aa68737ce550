"""The port's LM training across ranks, the plans that need 4 ranks
(fsdp+tp2 as dp2 x tp2, tp2+cp2) and ep (4 experts over dp 2), from the
JAX package's init, on the same global batches, against the JAX
package's mesh run of the same plan and against the port's world 1;
ring attention on a cp 4 mesh; the init at 4 ranks byte-equal to world
1's; a tp2+fsdp checkpoint resumed at world 1; the per-rank shapes of
the attention activations and the residual stream. The machinery and
the bars are in tests/_torch_parallel_common.py."""

import pytest

pytest.importorskip("jax")

import _torch_parallel_common as C  # noqa: E402
import torch  # noqa: E402

NAMES = ("fsdp_tp2", "tp2_cp2", "ep")
EXTRA = {4: [
    {"kind": "train", "name": "init4", "mesh": {"tp": 2, "fsdp": True},
     "cfg": {**C.TINY, "dtype": "float32"}, "hp": C.HP, "init_only": True},
    {"kind": "sharding", "name": "shard_tp", "mesh": {"tp": 2, "fsdp": True}},
    {"kind": "sharding", "name": "shard_sp", "mesh": {"tp": 2}, "sp": True},
    {"kind": "sharding", "name": "shard_cp", "mesh": {"tp": 2, "cp": 2}},
]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return C.make_runs(tmp_path_factory.mktemp("parallel4"), NAMES, (2, 4),
                       EXTRA)


@pytest.mark.parametrize("name", NAMES)
def test_plan_matches_jax_mesh(runs, name):
    C.check_plan_vs_jax(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_plan_matches_port_world1(runs, name):
    C.check_plan_vs_world1(runs, name)


def test_ring_attention_matches_reference(runs):
    C.check_ring(runs, 4)


def test_init_is_plan_invariant(runs):
    """World 4 (dp2 x tp2, fsdp) draws the full params as world 1 does
    and keeps its shard: the gathered init is byte-equal."""
    got = runs["port"]["init4"]["params"]
    loop = C.LMTrainLoop(C.TransformerConfig(**C.TINY, dtype="float32"),
                         C.LMHyperParams(**C.HP), device="cpu")
    want = loop.init_state().state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_tp2_fsdp_checkpoint_resumes_at_world1(runs):
    C.check_checkpoint(runs, "fsdp_tp2")


@pytest.mark.parametrize("name,ways,residual", [
    ("shard_tp", 4, 2), ("shard_sp", 4, 4), ("shard_cp", 4, 2)])
def test_attention_activations_not_replicated(runs, name, ways, residual):
    """At 4 ranks, q/k/v and the attention mix hold 1/(dp*tp*cp) of their
    global size on each rank; the residual stream is cut over data and
    ctx, and over model under sp (dp2 x tp2; dp2 x tp2 with sp; tp2 x
    cp2)."""
    report = runs["port"][name]
    assert set(report) == {"attn_q", "attn_k", "attn_v", "attn_mix",
                           "residual"}
    for key in ("attn_q", "attn_k", "attn_v", "attn_mix"):
        assert report[key]["shard_fraction"] == pytest.approx(1 / ways)
    assert report["residual"]["shard_fraction"] == pytest.approx(
        1 / residual)
