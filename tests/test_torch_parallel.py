"""The port's LM training across ranks at 2 ranks: dp2, tp2, tp2+sp, cp2
and the pp2 pipeline at 4 microbatches, from the JAX package's init, on
the same global batches, against the JAX package's mesh run of the same
plan and against the port's world 1; ring attention on a cp 2 mesh
against the reference's make_ring_attention; a pp2 checkpoint loaded
into the pp1 loop. The machinery and the bars are in
tests/_torch_parallel_common.py (losses within RTOL 2e-3 for 4 steps,
gathered params within 1e-4 of each tensor's max + 1e-7, f32)."""

import pytest

pytest.importorskip("jax")

import _torch_parallel_common as C  # noqa: E402

NAMES = ("dp2", "tp2", "tp2_sp", "cp2", "pp2")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return C.make_runs(tmp_path_factory.mktemp("parallel2"), NAMES, (2,), {})


@pytest.mark.parametrize("name", NAMES)
def test_plan_matches_jax_mesh(runs, name):
    C.check_plan_vs_jax(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_plan_matches_port_world1(runs, name):
    C.check_plan_vs_world1(runs, name)


def test_world1_matches_jax(runs):
    """The world-1 baseline itself tracks the JAX package (dp2's JAX run
    is numerically the one-device run)."""
    C._losses_close(runs["world1"][0][0], runs["jax"]["dp2"][0])


def test_ring_attention_matches_reference(runs):
    C.check_ring(runs, 2)


def test_pp2_checkpoint_loads_into_pp1_loop(runs):
    C.check_checkpoint(runs, "pp2")
