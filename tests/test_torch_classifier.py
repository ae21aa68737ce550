"""The port's classifier zoo and synthetic image data against the JAX
package: the same seeded inputs and the same weights (converted from the
flax tree) through the reference's flax module and the port's nn.Module.

Tolerances: logits max-abs relative to their max, 1e-4 in f32 and 3e-2
in bf16 (bf16 rounds at every layer, in different places in XLA and
PyTorch); BatchNorm running stats after a train-mode forward, max-abs
1e-5 in f32 and 2e-3 in bf16; conversion round trips exact; host
batches byte-equal."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu.data import get_dataset as ref_get_dataset  # noqa: E402
from kubeflow_tpu.models import cnn as rcnn  # noqa: E402
from kubeflow_tpu.models import mlp as rmlp  # noqa: E402
from kubeflow_tpu.models import resnet as rres  # noqa: E402
from kubeflow_tpu.models import vit as rvit  # noqa: E402
from kubeflow_tpu_torch.data import get_dataset  # noqa: E402
from kubeflow_tpu_torch.models import (  # noqa: E402
    CNN, MLP, ResNet, ViT, get_model, model_names)
from kubeflow_tpu_torch.models import resnet as pres  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    classifier_params_from_jax, classifier_params_to_jax)
from kubeflow_tpu_torch.models.layers import same_pads  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
TOL_STATS = {"float32": 1e-5, "bfloat16": 2e-3}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# -- data -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mnist", "cifar10", "imagenet-tiny"])
def test_host_batches_byte_equal(name):
    for kw in ({}, {"shard_index": 1, "num_shards": 4, "epoch_seed": 3}):
        ref = ref_get_dataset(name, seed=5).batches(16, steps=2, **kw)
        got = get_dataset(name, seed=5).batches(16, steps=2, **kw)
        for (ri, rl), (pi, pl) in zip(ref, got):
            assert ri.dtype == pi.dtype and rl.dtype == pl.dtype
            assert ri.tobytes() == pi.tobytes()
            assert rl.tobytes() == pl.tobytes()
    ri, rl = ref_get_dataset(name, "eval").eval_arrays(40)
    pi, pl = get_dataset(name, "eval").eval_arrays(40)
    assert ri.tobytes() == pi.tobytes() and rl.tobytes() == pl.tobytes()
    with pytest.raises(KeyError, match="unknown dataset"):
        get_dataset(name + "-real")


def test_device_batch_fn_distribution():
    """Same distribution as the host stream: label frequencies, the flip
    rate (label_noise x (1 - 1/C)), values clipped to [0, 1] at the host
    stream's rates; seeded per step, so equal seeds give equal batches."""
    ds = get_dataset("cifar10")
    fn = ds.device_batch_fn()
    protos = torch.from_numpy(fn.consts)
    n = 4096
    gen = torch.Generator().manual_seed(7)
    images, labels = fn(protos, gen, n)
    gen.manual_seed(7)
    drawn = torch.randint(0, ds.num_classes, (n,), generator=gen)
    assert images.shape == (n,) + ds.shape and images.dtype == torch.float32
    assert float(images.min()) >= 0.0 and float(images.max()) <= 1.0
    # Binomial bounds at ~5 sigma.
    freq = torch.bincount(labels, minlength=ds.num_classes).float() / n
    assert float((freq - 0.1).abs().max()) < 5 * (0.1 * 0.9 / n) ** 0.5
    p_flip = ds.label_noise * (1 - 1 / ds.num_classes)
    flips = float((labels != drawn).float().mean())
    assert abs(flips - p_flip) < 5 * (p_flip * (1 - p_flip) / n) ** 0.5
    host, _ = next(ds.batches(256))
    for edge in (0.0, 1.0):
        want = float((host == edge).mean())
        got = float((images[:256] == edge).float().mean())
        assert abs(got - want) < 0.01, (edge, got, want)
    again = fn(protos, torch.Generator().manual_seed(7), n)
    assert torch.equal(again[0], images) and torch.equal(again[1], labels)
    other = fn(protos, torch.Generator().manual_seed(8), n)
    assert not torch.equal(other[0], images)


# -- models -----------------------------------------------------------------

def _zoo(dt):
    """name -> (reference module, port module, input shape) at test
    widths; a Bottleneck ResNet with each stem (``resnet18`` covers the
    basic block at its full width below)."""
    j, t = JDT[dt], TDT[dt]
    out = {
        "mlp": (rmlp.MLP(features=(32, 16), dtype=j),
                MLP((8, 8, 1), features=(32, 16), dtype=t), (8, 8, 1)),
        "cnn": (rcnn.CNN(features=(8, 16), dense=32, dtype=j),
                CNN((12, 12, 1), features=(8, 16), dense=32, dtype=t),
                (12, 12, 1)),
        "vit": (rvit.ViT(d_model=16, n_heads=2, d_ff=32, n_layers=2,
                         dtype=j),
                ViT((8, 8, 3), d_model=16, n_heads=2, d_ff=32, n_layers=2,
                    dtype=t), (8, 8, 3)),
    }
    for side in (32, 72):   # CIFAR stem; ImageNet stem with uneven pads
        out[f"resnet-{side}"] = (
            rres.ResNet(stage_sizes=[1, 1], block_cls=rres.BottleneckBlock,
                        num_filters=8, dtype=j),
            ResNet((side, side, 3), [1, 1], pres.BottleneckBlock,
                   num_filters=8, dtype=t), (side, side, 3))
    return out


def _weights(ref, shape, seed=1):
    """Reference variables of ``ref``'s tree (its shapes from
    ``jax.eval_shape``; a compiled init costs seconds a model on the CPU)
    with seeded values: kernels ~N(0, 1/fan_in), norm scales 1 + N(0,
    0.1) and biases N(0, 0.1) (the last norm of a block starts at 0 in
    flax), running mean N(0, 0.1) and var in [0.5, 1.5]."""
    abstract = jax.eval_shape(
        lambda: ref.init(jax.random.PRNGKey(seed), jnp.zeros((1,) + shape),
                         train=False))
    rng = np.random.default_rng(seed)

    def fill(path, a):
        names = [p.key for p in path]
        leaf = names[-1]
        if leaf == "var":
            v = rng.uniform(0.5, 1.5, a.shape)
        elif leaf in ("bias", "mean"):
            v = 0.1 * rng.normal(size=a.shape)
        elif leaf == "scale":
            v = 1 + 0.1 * rng.normal(size=a.shape)
        else:
            fan_in = a.shape[0] if names[-2] in ("query", "key", "value") \
                else int(np.prod(a.shape[:-1])) or 1
            v = rng.normal(size=a.shape) / np.sqrt(fan_in)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, abstract)


def _apply(ref):
    return jax.jit(ref.apply, static_argnames=("train", "mutable"))


def _stats_err(new_ref, port, name):
    _, stats = classifier_params_to_jax(name, port.state_dict())
    return max(float(np.abs(np.asarray(a) - b).max()) for a, b in zip(
        jax.tree.leaves(new_ref), jax.tree.leaves(stats)))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_forward_matches_flax(dt):
    rng = np.random.default_rng(0)
    for key, (ref, port, shape) in _zoo(dt).items():
        v = _weights(ref, shape)
        port.load_state_dict(classifier_params_from_jax(
            "resnet50" if key.startswith("resnet") else key, v["params"],
            v.get("batch_stats")))
        x = rng.uniform(0, 1, (8,) + shape).astype(np.float32)
        for train in (False, True):
            if train and "batch_stats" in v:
                want, new = _apply(ref)(v, x, train=True,
                                        mutable=("batch_stats",))
            else:
                want, new = _apply(ref)(v, x, train=train), None
            got = port(torch.from_numpy(x), train=train)
            want = np.asarray(want)
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert float(np.std(want, axis=0).max()) > 0  # not degenerate
            err = float(np.abs(got.detach().numpy() - want).max()
                        / np.abs(want).max())
            assert err <= TOL[dt], (key, train, err)
            if new is not None:
                # The biased-variance running update, momentum 0.9.
                err = _stats_err(new["batch_stats"], port, "resnet50")
                assert err <= TOL_STATS[dt], (key, err)


@pytest.mark.parametrize("name", sorted(
    {"mlp", "cnn", "resnet18", "resnet50", "vit", "vit-s"}))
def test_registered_models_match_flax(name):
    """Each registered name at its full width and default dtype (bf16
    compute) on its dataset's input shape, in eval mode, batch 2."""
    from kubeflow_tpu.models import get_model as ref_get_model

    shape = {"mlp": (28, 28, 1), "cnn": (28, 28, 1)}.get(name, (32, 32, 3))
    assert name in model_names()
    ref = ref_get_model(name, num_classes=10)
    port = get_model(name, num_classes=10, input_shape=shape)
    v = _weights(ref, shape)
    port.load_state_dict(classifier_params_from_jax(
        name, v["params"], v.get("batch_stats")))
    x = np.random.default_rng(3).uniform(0, 1, (2,) + shape).astype(
        np.float32)
    want = np.asarray(_apply(ref)(v, x, train=False))
    got = port(torch.from_numpy(x)).detach().numpy()
    assert float(np.abs(got - want).max() / np.abs(want).max()) \
        <= TOL["bfloat16"]


def test_same_padding_is_flax_rule():
    # The traps named in the port's docstring: stride-2 convs on even
    # inputs pad more at the end.
    assert same_pads(32, 3, 2) == (0, 1)
    assert same_pads(224, 7, 2) == (2, 3)
    assert same_pads(112, 3, 2) == (0, 1)
    assert same_pads(9, 3, 2) == (1, 1)
    assert same_pads(18, 1, 2) == (0, 0)
    assert same_pads(8, 3, 1) == (1, 1)


@pytest.mark.parametrize("name", ["mlp", "cnn", "resnet18", "vit"])
def test_convert_round_trip_is_exact(name):
    from kubeflow_tpu.models import get_model as ref_get_model

    shape = {"mlp": (28, 28, 1), "cnn": (28, 28, 1)}.get(name, (32, 32, 3))
    v = _weights(ref_get_model(name), shape)
    sd = classifier_params_from_jax(name, v["params"], v.get("batch_stats"))
    port = get_model(name, input_shape=shape)
    port.load_state_dict(sd)        # strict: every key and shape
    params, stats = classifier_params_to_jax(name, port.state_dict())
    want = jax.tree_util.tree_structure(
        {"params": v["params"], "batch_stats": v.get("batch_stats", {})})
    got = {"params": params, "batch_stats": stats}
    assert jax.tree_util.tree_structure(got) == want
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(
            {"params": v["params"], "batch_stats": v.get("batch_stats",
                                                          {})})):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))
    with pytest.raises(KeyError, match="unknown model"):
        classifier_params_from_jax("resnet51", v["params"])
