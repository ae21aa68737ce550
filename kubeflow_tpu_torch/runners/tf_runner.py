"""TFJob-compatible worker: TensorFlow training driven by ``TF_CONFIG``.

Acceptance config #1 (BASELINE.md): the tf-operator mnist example shape.
The operator injects TF_CONFIG (cluster spec + task); this runner gives it
to ``tf.distribute`` exactly as the reference example scripts do —
single-worker runs use the default strategy, multi-worker runs use
MultiWorkerMirroredStrategy over the TF gRPC cluster, and a cluster with
``ps`` entries runs the reference's original flagship mode, live
parameter-server training (SURVEY.md §2.1 tf-operator row, §2.3 row 1):
ps/worker tasks host ``tf.distribute.Server`` processes that never exit
(the operator's chief-success + cleanPodPolicy teardown reaps them), the
chief drives ``tf.distribute.ParameterServerStrategy`` through a
``ClusterCoordinator``, and every model variable lives on the PS servers.

Prints the same stdout metric contract as the JAX runner so the metrics
collector and HPO objective parsing are framework-agnostic.

The port's copy of ``kubeflow_tpu/runners/tf_runner.py``: the data come
from ``kubeflow_tpu_torch.data`` (byte-equal host batches) and the parent
watch from ``kubeflow_tpu_torch.runtime.lifetime``. TensorFlow runs on
the host, as in the reference, and is imported inside ``main``:

    TF_CONFIG='{"cluster": {"worker": ["127.0.0.1:2222"]}, "task":
    {"type": "worker", "index": 0}}' \
        python -m kubeflow_tpu_torch.runners.tf_runner --dataset=mnist
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="kfx TF training runner")
    p.add_argument("--dataset", default="mnist")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--eval-samples", type=int, default=2048)
    return p.parse_args(argv)


def _build_model(tf, ds):
    return tf.keras.Sequential([
        tf.keras.layers.Input(shape=ds.shape),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(256, activation="relu"),
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dense(ds.num_classes),
    ])


def _eval_and_report(tf, args, model, t0):
    """Final-eval + stdout metric contract shared by every tf mode (the
    collector and HPO objective parsing read these exact lines)."""
    from ..data import get_dataset

    eval_ds = get_dataset(args.dataset, split="eval")
    images, labels = eval_ds.eval_arrays(args.eval_samples)
    logits = model(tf.constant(images), training=False)
    eval_loss = float(tf.reduce_mean(
        tf.nn.sparse_softmax_cross_entropy_with_logits(
            labels=tf.constant(labels), logits=logits)))
    eval_acc = float(tf.reduce_mean(tf.cast(tf.equal(
        tf.argmax(logits, -1, output_type=tf.int32), tf.constant(labels)),
        tf.float32)))
    wall = time.time() - t0
    print(f"train_done steps={args.steps} wall_seconds={wall:.2f}",
          flush=True)
    print(f"loss={eval_loss:.6f}", flush=True)
    print(f"accuracy={eval_acc:.6f}", flush=True)


def _run_ps_mode(args, tf) -> int:
    """Live ParameterServerStrategy training (TF2 coordinator pattern).

    ps and worker tasks host long-running ``tf.distribute.Server``s; the
    chief owns the training loop and schedules per-step functions onto
    workers through a ClusterCoordinator. Variables (model + Adam slots)
    are placed on the ps job by the strategy — the chief prints where its
    variables live so tests can assert the PS genuinely serves them.

    Gradient application is CHIEF-MEDIATED: workers compute forward/
    backward (pulling weights from ps), return gradients to the chief,
    and the chief writes the Adam update into the ps-hosted variables.
    The textbook variant (workers apply gradients in the scheduled
    closure) deadlocks in this TensorFlow build: any multi-device
    function needing a worker->ps tensor SEND hangs forever, while
    ps->worker reads and chief->anywhere RPCs work — minimal repro and
    the full bisection in docs/ps-strategy.md. The architecture the
    reference cares about is preserved: every variable lives on and is
    served by the parameter server across process boundaries, and each
    step fans compute out to every worker.
    """
    resolver = tf.distribute.cluster_resolver.TFConfigClusterResolver()
    ttype, tindex = resolver.task_type, resolver.task_id
    if ttype in ("worker", "ps"):
        server = tf.distribute.Server(
            resolver.cluster_spec(), job_name=ttype, task_index=tindex,
            protocol=resolver.rpc_layer or "grpc", start=True)
        print(f"runner_start framework=tf mode=ps role={ttype}:{tindex} "
              f"server=started", flush=True)
        server.join()  # never returns; the gang reaps on chief success
        return 0
    if ttype != "chief":
        # ParameterServerStrategy only defines chief/worker/ps roles
        # (its _verify_args_and_config rejects anything else); a Master or
        # Evaluator replica in a ps-mode TFJob would otherwise fall into
        # the coordinator branch and fight the real chief over the
        # ps-hosted variables. Fail fast with a clear message instead.
        print(f"error: replica type {ttype!r} is not supported in "
              f"parameter-server mode (cluster has 'ps' entries); use "
              f"Chief + Worker + PS replicas", file=sys.stderr)
        return 2

    print(f"runner_start framework=tf mode=ps role={ttype}:{tindex} "
          f"dataset={args.dataset}", flush=True)
    import numpy as np

    from ..data import get_dataset

    n_workers = len(resolver.cluster_spec().as_dict().get("worker", ()))
    if n_workers < 1:
        # The coordinator executes closures ONLY on workers; with none,
        # the first join() would block forever.
        print("error: parameter-server mode needs at least one Worker "
              "replica to execute training closures", file=sys.stderr)
        return 2
    strategy = tf.distribute.ParameterServerStrategy(resolver)
    coordinator = (
        tf.distribute.experimental.coordinator.ClusterCoordinator(strategy))

    ds = get_dataset(args.dataset)
    # Fixed in-memory corpus: create_per_worker_dataset re-traces the
    # dataset fn on each worker, so the data must be expressible as graph
    # ops — constants from the same deterministic stream every runner uses.
    it = ds.batches(args.batch_size)
    xs, ys, n = [], [], 0
    while n < min(args.steps * args.batch_size, 8192):
        x, y = next(it)
        xs.append(x)
        ys.append(y)
        n += len(x)
    corpus_x = np.concatenate(xs).astype(np.float32)
    corpus_y = np.concatenate(ys).astype(np.int32)

    with strategy.scope():
        model = _build_model(tf, ds)
        params = model.trainable_variables
        # Manual Adam state, also ps-hosted (the strategy places scope
        # variables on the ps job round-robin).
        mus = [tf.Variable(tf.zeros_like(v)) for v in params]
        nus = [tf.Variable(tf.zeros_like(v)) for v in params]

    def var_device(v):
        # keras-3 Variable wraps the strategy's tf variable in .value;
        # tf.Variable exposes .device directly.
        for obj in (v, getattr(v, "value", None)):
            d = getattr(obj, "device", None)
            if d:
                return d
        return ""

    ps_vars = sum("/job:ps" in var_device(v)
                  for v in list(params) + mus + nus)
    print(f"variables_total={len(params) + len(mus) + len(nus)} "
          f"variables_on_ps={ps_vars} "
          f"var0_device={var_device(params[0])}", flush=True)

    # A global step = one micro-batch per worker, averaged on the chief
    # (sync PS training). Each worker's dataset replica shuffles with its
    # own nondeterministic seed, so workers draw independent streams.
    per = max(args.batch_size // max(n_workers, 1), 1)

    def dataset_fn(_ctx=None):
        d = tf.data.Dataset.from_tensor_slices((corpus_x, corpus_y))
        return d.shuffle(len(corpus_x)).repeat().batch(
            per, drop_remainder=True)

    @tf.function
    def grad_step(iterator):
        def step_fn(inputs):
            images, labels = inputs
            with tf.GradientTape() as tape:
                logits = model(images, training=True)
                loss = tf.reduce_mean(
                    tf.nn.sparse_softmax_cross_entropy_with_logits(
                        labels=labels, logits=logits))
            grads = tape.gradient(loss, model.trainable_variables)
            acc = tf.reduce_mean(tf.cast(tf.equal(
                tf.argmax(logits, -1, output_type=tf.int32), labels),
                tf.float32))
            return grads, loss, acc
        return strategy.run(step_fn, args=(next(iterator),))

    b1, b2, eps, lr = 0.9, 0.999, 1e-7, args.learning_rate

    # One traced call per step (chief->ps function inputs are on the
    # working RPC path — measured in docs/ps-strategy.md); ``t`` rides in
    # as a tensor so changing step numbers don't retrace.
    @tf.function
    def apply_grads(t, grads):
        c1 = 1.0 - tf.pow(b1, t)
        c2 = 1.0 - tf.pow(b2, t)
        for v, g, m, nn in zip(params, grads, mus, nus):
            m.assign(b1 * m + (1.0 - b1) * g)
            nn.assign(b2 * nn + (1.0 - b2) * tf.square(g))
            v.assign_sub(lr * (m / c1) / (tf.sqrt(nn / c2) + eps))

    per_worker_it = iter(coordinator.create_per_worker_dataset(dataset_fn))
    t0 = time.time()
    t_last = t0
    step_last = 0
    loss = acc = 0.0
    for step in range(args.steps):
        rvs = [coordinator.schedule(grad_step, args=(per_worker_it,))
               for _ in range(n_workers)]
        coordinator.join()
        fetched = [rv.fetch() for rv in rvs]
        grads = [np.mean([f[0][i] for f in fetched], axis=0)
                 for i in range(len(params))]
        loss = float(np.mean([f[1] for f in fetched]))
        acc = float(np.mean([f[2] for f in fetched]))
        apply_grads(tf.constant(float(step + 1)),
                    [tf.convert_to_tensor(g) for g in grads])
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            now = time.time()
            dt = (now - t_last) / (step + 1 - step_last)
            print(f"step={step + 1} loss={loss:.6f} "
                  f"accuracy={acc:.6f} step_time={dt:.4f}", flush=True)
            t_last, step_last = now, step + 1

    _eval_and_report(tf, args, model, t0)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..runtime.lifetime import install_parent_watch

    install_parent_watch()
    # Keep TF off any accelerator plugin; this compat path is CPU-only
    # (reference config #1 is explicitly CPU).
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")
    import tensorflow as tf

    from ..data import get_dataset

    tf_config = json.loads(os.environ.get("TF_CONFIG", "{}"))
    cluster = tf_config.get("cluster", {})
    task = tf_config.get("task", {"type": "worker", "index": 0})
    if cluster.get("ps"):
        return _run_ps_mode(args, tf)
    n_workers = sum(len(v) for k, v in cluster.items()
                    if k in ("worker", "chief", "master"))
    if n_workers > 1:
        strategy = tf.distribute.MultiWorkerMirroredStrategy()
    else:
        strategy = tf.distribute.get_strategy()  # no-op strategy

    print(f"runner_start framework=tf dataset={args.dataset} "
          f"task={task.get('type')}:{task.get('index')} "
          f"n_workers={max(n_workers, 1)}", flush=True)

    ds = get_dataset(args.dataset)
    with strategy.scope():
        model = _build_model(tf, ds)
        opt = tf.keras.optimizers.Adam(args.learning_rate)
        loss_fn = tf.keras.losses.SparseCategoricalCrossentropy(
            from_logits=True)

    def step_fn(images, labels):
        with tf.GradientTape() as tape:
            logits = model(images, training=True)
            loss = loss_fn(labels, logits)
        grads = tape.gradient(loss, model.trainable_variables)
        # In replica context apply_gradients all-reduces across workers
        # (the NCCL ring's job in the reference's GPU pods).
        opt.apply_gradients(zip(grads, model.trainable_variables))
        acc = tf.reduce_mean(tf.cast(
            tf.equal(tf.argmax(logits, -1, output_type=tf.int32), labels),
            tf.float32))
        return loss, acc

    @tf.function
    def train_step(images, labels):
        loss, acc = strategy.run(step_fn, args=(images, labels))
        return (strategy.reduce(tf.distribute.ReduceOp.MEAN, loss, axis=None),
                strategy.reduce(tf.distribute.ReduceOp.MEAN, acc, axis=None))

    # Each worker consumes its disjoint shard of the global batch (same
    # contract as the JAX runner's data-parallel input pipeline). Chief
    # (if any) takes shard 0, workers follow.
    n_chief = len(cluster.get("chief", [])) + len(cluster.get("master", []))
    if n_workers > 1 and task.get("type") in ("worker",):
        task_index = n_chief + int(task.get("index", 0))
    else:
        task_index = int(task.get("index", 0)) if n_workers > 1 else 0
    shards = max(n_workers, 1)
    t0 = time.time()
    t_last = t0
    step_last = 0
    it = ds.batches(args.batch_size, shard_index=task_index,
                    num_shards=shards)
    loss = acc = 0.0
    for step in range(args.steps):
        images, labels = next(it)
        loss, acc = train_step(tf.constant(images), tf.constant(labels))
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            now = time.time()
            dt = (now - t_last) / (step + 1 - step_last)
            print(f"step={step + 1} loss={float(loss):.6f} "
                  f"accuracy={float(acc):.6f} step_time={dt:.4f}", flush=True)
            t_last, step_last = now, step + 1

    _eval_and_report(tf, args, model, t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
