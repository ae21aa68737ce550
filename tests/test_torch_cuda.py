"""Card tests of the port's CUDA kernels (kubeflow_tpu_torch/ops/csrc) and
of the paths that launch them. JAX-free, so they run on a machine with a GPU
and no JAX:

    python -m pytest tests/test_torch_cuda.py -q

Each test skips where torch.cuda.is_available() is false, naming the
kernels it needs."""

import math

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("flash_fwd/flash_dq/flash_dkv CUDA kernels "
                    "(ops/csrc/flash_fwd.cu, flash_bwd.cu, "
                    "flash_fwd_wgmma.cu, flash_dq_wgmma.cu, "
                    "flash_dkv_wgmma.cu) need an NVIDIA GPU; "
                    "torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, seed, device, dtype):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    xs = [rng.normal(size=shape) / math.sqrt(D)] + [
        rng.normal(size=shape) for _ in range(3)]
    return [torch.from_numpy(x.astype(np.float32)).to(device, dtype)
            for x in xs]


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [64, 128, 192, 256])
def test_kernels_match_plain_version(cuda, dtype, D):
    """Each kernel against its plain version on the same inputs. bf16:
    outputs round once to bf16 (and, in the wgmma design at D 64/128, P
    and dS before their second products), so 2e-2 (the reference's
    bound); f32 (the FMA design): only summation order differs, 1e-4."""
    dt = getattr(torch, dtype)
    q, k, v, do = _inputs((2, 256, 2, D), D, cuda, dt)
    before = dict(fa.LAUNCHES)
    o, lse = fa._fwd(q, k, v)
    o_r, lse_r = fa._fwd_reference(q, k, v)
    delta = torch.sum(do.float() * o_r.float(), -1, keepdim=True)
    dq = fa._dq(q, k, v, do, lse_r, delta)
    dk, dv = fa._dkv(q, k, v, do, lse_r, delta)
    dq_r = fa._dq_reference(q, k, v, do, lse_r, delta)
    dk_r, dv_r = fa._dkv_reference(q, k, v, do, lse_r, delta)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    assert o.dtype == dt and lse.dtype == torch.float32
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    assert float((o.float() - o_r.float()).abs().max()) <= tol
    assert float((lse - lse_r).abs().max()) <= 1e-3
    for a, b in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        assert _rel(a, b) <= tol


def _wgmma_run(q, k, v, do):
    """The three kernels on bf16 inputs (the wgmma design), the dQ and
    dK/dV kernels fed the plain forward's lse and delta."""
    o, lse = fa._fwd(q, k, v)
    o_r, lse_r = fa._fwd_reference(q, k, v)
    delta = torch.sum(do.float() * o_r.float(), -1, keepdim=True)
    dq = fa._dq(q, k, v, do, lse_r, delta)
    dk, dv = fa._dkv(q, k, v, do, lse_r, delta)
    return (o, lse, dq, dk, dv), (o_r, lse_r, delta)


@pytest.mark.parametrize("shape", [(2, 2048, 4, 64), (1, 2048, 4, 128),
                                   (1, 320, 2, 64), (1, 320, 2, 128),
                                   (1, 64, 2, 64), (3, 192, 3, 128)])
def test_wgmma_kernels_match_plain_version(cuda, shape):
    """flash_fwd, flash_dq and flash_dkv in their wgmma design (bf16, D
    64/128; S = 320 and 192 leave a ragged half tile, S % 128 == 64, and
    S = 64 is less than one tile) against the plain versions: o 2e-2 abs,
    lse 1e-3 abs, dq/dk/dv 2e-2 relative to the max, chip_smoke.py's
    bounds. The new rounding is P and dS to bf16 before their second
    products (tests/test_torch_flash.py bounds it on the CPU)."""
    for name in fa.LAUNCHES:
        assert fa.design(torch.bfloat16, shape[-1], name) == "wgmma"
    q, k, v, do = _inputs(shape, 11, cuda, torch.bfloat16)
    before = dict(fa.LAUNCHES)
    (o, lse, dq, dk, dv), (o_r, lse_r, delta) = _wgmma_run(q, k, v, do)
    dq_r = fa._dq_reference(q, k, v, do, lse_r, delta)
    dk_r, dv_r = fa._dkv_reference(q, k, v, do, lse_r, delta)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    assert bool(torch.isfinite(o.float()).all())
    assert bool(torch.isfinite(dq.float()).all())
    assert float((o.float() - o_r.float()).abs().max()) <= 2e-2
    assert float((lse - lse_r).abs().max()) <= 1e-3
    assert _rel(dq, dq_r) <= 2e-2
    assert _rel(dk, dk_r) <= 2e-2
    assert _rel(dv, dv_r) <= 2e-2


@pytest.mark.parametrize("D", [64, 128])
def test_wgmma_kernels_are_deterministic(cuda, D):
    """Two runs of each wgmma kernel on the same inputs are bit-identical
    (no atomics; every output element is written once)."""
    q, k, v, do = _inputs((2, 1024, 4, D), 5, cuda, torch.bfloat16)
    first, _ = _wgmma_run(q, k, v, do)
    second, _ = _wgmma_run(q, k, v, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_wgmma_inputs_at_odd_offsets(cuda):
    """A bf16 view that starts 2 bytes into its allocation is copied to an
    aligned tensor before a TMA-fed kernel sees it (forward and dQ);
    _launch itself refuses it."""
    q, k, v, do = _inputs((1, 256, 2, 64), 3, cuda, torch.bfloat16)
    buf = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    q_odd = buf[1:].view(q.shape)
    q_odd.copy_(q)
    assert q_odd.data_ptr() % 16
    o, _ = fa._fwd(q_odd, k, v)
    o_r, lse_r = fa._fwd_reference(q, k, v)
    assert float((o.float() - o_r.float()).abs().max()) <= 2e-2
    delta = torch.sum(do.float() * o_r.float(), -1, keepdim=True)
    dq = fa._dq(q_odd, k, v, do, lse_r, delta)
    assert _rel(dq, fa._dq_reference(q, k, v, do, lse_r, delta)) <= 2e-2
    lse = torch.empty(1, 256, 2, 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        fa._launch("flash_fwd", q_odd, k, v, torch.empty_like(q), lse)
    with pytest.raises(ValueError, match="aligned"):
        fa._launch("flash_dq", q_odd, k, v, do, lse_r, delta,
                   torch.empty_like(q))


def test_base_preset_launches_through_wgmma(cuda, capsys):
    """The main path's configuration (base preset, bf16, D = 64) takes the
    wgmma design, and the runner's launch counts are what they were: per
    train step one forward, one dQ and one dK/dV launch a layer, plus one
    forward a layer for the eval batch."""
    from kubeflow_tpu_torch.models.transformer import preset_config
    from kubeflow_tpu_torch.runners import lm_runner

    cfg = preset_config("base")
    assert cfg.dtype == torch.bfloat16 and cfg.head_dim == 64
    assert fa.design(torch.bfloat16, 64) == "wgmma"
    assert fa.design(torch.bfloat16, 64, "flash_dkv") == "wgmma"
    assert fa.design(torch.bfloat16, 64, "flash_dq") == "wgmma"
    fa.reset_launches()
    rc = lm_runner.main(["--preset", "base", "--dataset", "lm-small",
                         "--steps", "2", "--batch-size", "1",
                         "--warmup-steps", "1", "--log-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "seq_len=2048" in out
    L = cfg.n_layers
    assert fa.LAUNCHES == {"flash_fwd": L * 2 + L, "flash_dq": L * 2,
                           "flash_dkv": L * 2}


def test_autograd_on_cuda_matches_cpu(cuda):
    """The autograd Function on CUDA tensors (the kernels) against the
    same Function on CPU tensors (the plain versions), f32 (the FMA
    design alone)."""
    q, k, v, do = _inputs((1, 384, 2, 64), 7, "cpu", torch.float32)
    outs = {}
    for dev in ("cpu", cuda):
        xs = [x.to(dev).requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention(*xs)
        grads = torch.autograd.grad(out, xs, do.to(dev))
        outs[str(dev)] = [t.detach().cpu() for t in (out, *grads)]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert _rel(a, b) <= 1e-4


def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 128, 1, 320, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa._fwd(x, x, x)
    y = torch.zeros(1, 128, 1, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa._fwd(y, y, y)


def test_model_auto_launches_kernels(cuda):
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)

    cfg = TransformerConfig(vocab_size=512, d_model=128, n_heads=2,
                            head_dim=64, n_layers=2, d_ff=256,
                            max_seq_len=1024)
    model = TransformerLM(cfg, device=cuda,
                          generator=torch.Generator(cuda).manual_seed(0))
    tokens = torch.randint(0, 512, (1, 1024), device=cuda)
    fa.reset_launches()
    loss = model(tokens).logsumexp(-1).mean()
    loss.backward()
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2}
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_flash_fwd_op_launches_the_kernel(cuda):
    """flash_attention_fwd is the kfx::flash_fwd op: on CUDA tensors it
    launches the forward kernel once and returns what _fwd returns."""
    q, k, v, _ = _inputs((1, 256, 2, 64), 3, cuda, torch.bfloat16)
    fa.reset_launches()
    o, lse = fa.flash_attention_fwd(q, k, v)
    assert fa.LAUNCHES["flash_fwd"] == 1
    o2, lse2 = fa._fwd(q, k, v)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("policy", ["nothing", "save_flash_full"])
def test_remat_policies_launch_counts_on_cuda(cuda, policy):
    """Under a policy that keeps (o, lse) the backward launches no flash
    forward (L a step); full remat re-runs it (2L); grads equal the
    no-remat grads in f32."""
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)

    kw = dict(vocab_size=512, d_model=128, n_heads=2, head_dim=64,
              n_layers=2, d_ff=256, max_seq_len=256, attn_impl="flash",
              dtype="float32")
    tokens = torch.randint(0, 512, (2, 256), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    grads = {}
    for remat in (False, True):
        model = TransformerLM(
            TransformerConfig(**kw, remat=remat, remat_policy=policy),
            device=cuda, generator=torch.Generator(cuda).manual_seed(0))
        fa.reset_launches()
        model(tokens).logsumexp(-1).mean().backward()
        torch.cuda.synchronize()
        fwd = 2 * 2 if remat and policy == "nothing" else 2
        assert fa.LAUNCHES == {"flash_fwd": fwd, "flash_dq": 2,
                               "flash_dkv": 2}
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    for n, g in grads[False].items():
        assert _rel(grads[True][n], g) <= 1e-5, n


def test_runner_on_cuda_goes_through_kernels(cuda, capsys):
    from kubeflow_tpu_torch.runners import lm_runner

    fa.reset_launches()
    rc = lm_runner.main(["--preset", "small", "--dataset", "lm-small",
                         "--seq-len", "1024", "--steps", "2",
                         "--batch-size", "1", "--log-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "device=cuda" in out and "train_done" in out
    assert fa.LAUNCHES == {"flash_fwd": 8 * 3, "flash_dq": 8 * 2,
                           "flash_dkv": 8 * 2}


@pytest.fixture
def cuda_serving():
    if not torch.cuda.is_available():
        pytest.skip("the LM serving path on the card (KV-cache decode, "
                    "LMGenerator, ModelServer :generate) needs an NVIDIA "
                    "GPU; torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tiny_gapped_lm(device, seed=0):
    """A tiny f32 LM on ``device`` with wide argmax gaps (lm_head tied to
    the embedding, attn.out and mlp.wo scaled by 0.35), drawn from
    ``seed``."""
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                            head_dim=16, n_layers=2, d_ff=64, max_seq_len=64,
                            dtype="float32", attn_impl="naive")
    model = TransformerLM(cfg, device=device,
                          generator=torch.Generator(device).manual_seed(seed))
    with torch.no_grad():
        model.lm_head.kernel.copy_(model.embed.embedding.T)
        for layer in model.layers:
            layer.attn.out.kernel.mul_(0.35)
            layer.mlp.wo.kernel.mul_(0.35)
    return cfg, model


def test_generator_greedy_equals_recompute_on_cuda(cuda_serving):
    """Cache decode on the card equals the argmax of a full no-cache
    forward over the growing sequence (gap asserted first), and touches
    no flash kernel."""
    from kubeflow_tpu_torch.models.generate import LMGenerator

    cfg, model = _tiny_gapped_lm(cuda_serving)
    prompts = [[5, 9, 11, 3, 7], [2], [40, 41, 42, 43, 44, 45, 46]]
    fa.reset_launches()
    gen = LMGenerator(cfg, model.state_dict(), device=cuda_serving)
    got = gen.generate(prompts, max_new_tokens=8)
    for p, row in zip(prompts, got):
        toks, gap = list(p), float("inf")
        with torch.no_grad():
            for _ in range(8):
                last = model(torch.tensor([toks], device=cuda_serving))[0, -1]
                top2 = torch.topk(last, 2).values
                gap = min(gap, float(top2[0] - top2[1]))
                toks.append(int(torch.argmax(last)))
        assert gap > 1e-3
        assert row == toks[len(p):]
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def test_model_server_generates_on_cuda(cuda_serving, tmp_path):
    import json
    import urllib.request

    from kubeflow_tpu_torch.models.convert import params_to_jax
    from kubeflow_tpu_torch.models.generate import LMGenerator
    from kubeflow_tpu_torch.serving.lm_server import LMPredictor, export_lm
    from kubeflow_tpu_torch.serving.server import ModelServer

    cfg, model = _tiny_gapped_lm(cuda_serving)
    export_lm(str(tmp_path), cfg, params_to_jax(model.state_dict()))
    p = LMPredictor(str(tmp_path), name="lm")
    p.load()
    assert p.device == "cuda" and p.ready
    srv = ModelServer(port=0)
    srv.register(p)
    srv.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/models/lm:generate",
            data=json.dumps({"prompt_tokens": [[5, 9, 11], [7]],
                             "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.load(r)
    finally:
        srv.stop()
    want = LMGenerator(cfg, model.state_dict(), device=cuda_serving).generate(
        [[5, 9, 11], [7]], max_new_tokens=6)
    assert body["generated_tokens"] == want


def _engine_on_card(cfg, model, device, **kw):
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    return DecodeEngine(cfg, model.state_dict(), device=device,
                        n_slots=4, chunk_tokens=4, kv_page_size=16, **kw)


def test_engine_greedy_equals_generator_on_cuda(cuda_serving):
    """The decode engine on the card (paged pool, chunked prefill at one
    page) gives the one-shot LMGenerator's greedy tokens on wide-gap
    weights, with concurrent requests and a prefix hit, and launches no
    flash kernel."""
    from kubeflow_tpu_torch.models.generate import LMGenerator

    cfg, model = _tiny_gapped_lm(cuda_serving)
    gen = LMGenerator(cfg, model.state_dict(), device=cuda_serving)
    system = [(7 * i + 3) % 60 for i in range(36)]
    prompts = [[5, 9, 11, 3, 7], [2], system + [60], system + [61],
               [(3 * i + 1) % 60 for i in range(33)]]
    fa.reset_launches()
    eng = _engine_on_card(cfg, model, cuda_serving, prefill_chunk_tokens=16)
    try:
        got = eng.generate(prompts, max_new_tokens=12)
        assert eng.prefix_stats()["hits"] >= 1
    finally:
        eng.close()
    assert got == [gen.generate([p], max_new_tokens=12)[0] for p in prompts]
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def test_engine_pages_come_back_after_preemption_on_cuda(cuda_serving):
    """A pool too small for the wave preempts (recompute) on the card;
    the tokens stay the oracle's and every page returns: free pages plus
    the prefix cache's equal the pool."""
    from kubeflow_tpu_torch.models.generate import LMGenerator

    cfg, model = _tiny_gapped_lm(cuda_serving)
    gen = LMGenerator(cfg, model.state_dict(), device=cuda_serving)
    prompts = [[i + 1, i + 2, i + 3] for i in range(4)]
    eng = _engine_on_card(cfg, model, cuda_serving, kv_pages=6)
    try:
        got = eng.generate(prompts, max_new_tokens=40)
        st = eng.page_stats()
    finally:
        eng.close()
    assert got == [gen.generate([p], max_new_tokens=40)[0] for p in prompts]
    assert st["preemptions"] >= 1
    assert st["free"] + st["cached"] == st["pages"]


def test_spec_engine_greedy_equals_generator_on_cuda(cuda_serving):
    """The speculating engine on the card (a 1-layer draft, 4 proposals,
    chunked prefill at one page, a prefix hit) gives the one-shot
    LMGenerator's greedy tokens, accepts some proposals, leaks no page of
    either pool, and launches no flash kernel."""
    from kubeflow_tpu_torch.models.generate import LMGenerator

    cfg, model = _tiny_gapped_lm(cuda_serving)
    gen = LMGenerator(cfg, model.state_dict(), device=cuda_serving)
    system = [(7 * i + 3) % 60 for i in range(36)]
    prompts = [[5, 9, 11, 3, 7], [2], system + [60], system + [61],
               [(3 * i + 1) % 60 for i in range(33)]]
    fa.reset_launches()
    eng = _engine_on_card(cfg, model, cuda_serving, prefill_chunk_tokens=16,
                          draft_layers=1, propose_tokens=4)
    try:
        got = eng.generate(prompts, max_new_tokens=12)
        st, pages = eng.spec_stats(), eng.page_stats()
        draft_free = eng._draft_mgr.n_free
    finally:
        eng.close()
    assert got == [gen.generate([p], max_new_tokens=12)[0] for p in prompts]
    assert 0 < st["accepted"] <= st["proposed"]
    assert pages["free"] + pages["cached"] == pages["pages"]
    assert draft_free == eng.draft_n_pages
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def test_spec_engine_preempts_degrades_and_samples_on_cuda(cuda_serving):
    """On the card: a target pool too small for the wave preempts, a
    one-page draft pool degrades the long prompt, tokens stay the
    oracle's, both pools come back whole, and a sampled request is the
    same beside batch mates as alone."""
    from kubeflow_tpu_torch.models.generate import LMGenerator

    cfg, model = _tiny_gapped_lm(cuda_serving)
    gen = LMGenerator(cfg, model.state_dict(), device=cuda_serving)
    prompts = [[i + 1, i + 2, i + 3] for i in range(3)] + [
        [(3 * i + 1) % 60 for i in range(20)]]
    eng = _engine_on_card(cfg, model, cuda_serving, kv_pages=6,
                          draft_layers=1, propose_tokens=4, draft_kv_pages=5)
    try:
        got = eng.generate(prompts, max_new_tokens=40)
        st, pages = eng.spec_stats(), eng.page_stats()
        draft_free = eng._draft_mgr.n_free
        kw = dict(max_new_tokens=12, temperature=1.0, seed=3)
        alone = eng.generate([[1, 2, 3]], **kw)[0]
        mate = eng.submit([9, 8], max_new_tokens=20, temperature=0.7,
                          top_k=5, seed=7)
        assert eng.generate([[1, 2, 3]], **kw)[0] == alone
        mate.result(120)
    finally:
        eng.close()
    assert got == [gen.generate([p], max_new_tokens=40)[0] for p in prompts]
    assert pages["preemptions"] >= 1 and st["degraded"] >= 1
    assert pages["free"] + pages["cached"] == pages["pages"]
    assert draft_free == eng.draft_n_pages


@pytest.fixture
def cuda_classifier():
    if not torch.cuda.is_available():
        pytest.skip("the classifier path on the card (a ResNet-50 "
                    "TrainLoop step, JaxPredictor on cuda) needs an NVIDIA "
                    "GPU; torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_resnet50_train_step_on_cuda_matches_cpu(cuda_classifier):
    """One f32 ResNet-50 step (SGD, so a param moves by lr x its grad) on
    the card against the CPU from the same seeded init and batch: loss
    1e-4 relative, param changes 1e-3 of the largest, running stats 1e-5;
    then the default bf16 model steps with a finite loss."""
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.training import TrainLoop

    shape = (32, 32, 3)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (8,) + shape).astype(np.float32)
    y = rng.integers(0, 10, 8)
    out = {}
    for dev in ("cpu", "cuda"):
        loop = TrainLoop(get_model("resnet50", input_shape=shape,
                                   dtype=torch.float32),
                         optimizer="sgd", learning_rate=0.1, device=dev)
        state = loop.init_state(shape)
        p0 = {k: v.detach().cpu().clone() for k, v in state.params.items()}
        state, loss, _ = loop.train_step(state, x, y)
        out[dev] = (loss, {k: v.detach().cpu() - p0[k]
                           for k, v in state.params.items()},
                    {k: v.cpu() for k, v in state.batch_stats.items()})
    (l_cpu, d_cpu, s_cpu), (l_gpu, d_gpu, s_gpu) = out["cpu"], out["cuda"]
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    scale = max(float(d.abs().max()) for d in d_cpu.values())
    for k in d_cpu:
        assert float((d_gpu[k] - d_cpu[k]).abs().max()) <= 1e-3 * scale, k
    for k in s_cpu:
        assert _rel(s_gpu[k], s_cpu[k]) <= 1e-5, k
    loop = TrainLoop(get_model("resnet50", input_shape=shape),
                     device=cuda_classifier)
    state = loop.init_state(shape)
    from kubeflow_tpu_torch.data import get_dataset

    fn = get_dataset("cifar10").device_batch_fn()
    state, loss, _ = loop.train_steps_device(state, fn, 32, 0, 2)
    assert math.isfinite(loss) and state.step == 2


def test_jax_predictor_on_cuda(cuda_classifier, tmp_path):
    """The classifier export served on the card by default (auto means
    cuda) answers as the CPU predictor does: probabilities within 3e-2
    (bf16), predictions on at least 95% of the images."""
    from kubeflow_tpu_torch.data import get_dataset
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.serving.export import export_params
    from kubeflow_tpu_torch.serving.server import JaxPredictor
    from kubeflow_tpu_torch.training import TrainLoop

    ds = get_dataset("mnist")
    loop = TrainLoop(get_model("cnn", input_shape=ds.shape), device="cpu")
    state = loop.init_state(ds.shape)
    for images, labels in ds.batches(64, steps=5):
        state, *_ = loop.train_step(state, images, labels)
    export_params(str(tmp_path), "cnn", ds.shape, ds.num_classes, state)
    images, _ = get_dataset("mnist", "eval").eval_arrays(40)
    got = {}
    for device in ("auto", "cpu"):
        p = JaxPredictor(str(tmp_path), max_batch_size=16, device=device)
        p.load()
        got[device] = p.predict(images, probabilities=True)
        if device == "auto":
            assert p.device == "cuda"
            assert set(p.placement.values()) == {"accelerator"}
    assert np.abs(np.asarray(got["auto"]["probabilities"])
                  - np.asarray(got["cpu"]["probabilities"])).max() <= 3e-2
    agree = np.mean(np.asarray(got["auto"]["predictions"])
                    == np.asarray(got["cpu"]["predictions"]))
    assert agree >= 0.95


@pytest.fixture
def cuda_quant():
    if not torch.cuda.is_available():
        pytest.skip("int8 serving on the card (QuantDense, the int8 paged "
                    "pool's quantize-on-write) needs an NVIDIA GPU; "
                    "torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_quant_dense_on_cuda_matches_cpu(cuda_quant):
    """QuantDense (int8 kernel, f32 scale on the product) at the base
    preset's mlp.wi shape for 8 tokens, f32, TF32 off: the card's output
    within 1e-5 of the CPU's, relative to its max."""
    from kubeflow_tpu_torch.models import transformer as T

    cfg = T.preset_config("base", dtype="float32", quant="int8")
    w = np.random.default_rng(0).normal(size=(1024, 8192)).astype(
        np.float32) * 0.02
    q, scale = T.quantize_leaf_int8(w, 1)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 1, 1024)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda_quant):
        layer = T.QuantDense((1024,), (8192,), cfg).to(dev)
        layer.kernel.data = torch.from_numpy(q).to(dev)
        layer.scale.data = torch.from_numpy(scale).to(dev)
        with torch.no_grad():
            out[str(dev)] = layer(x.to(dev)).cpu()
    assert _rel(out["cuda"], out["cpu"]) < 1e-5


def _int8_write(device, seed):
    """One int8 paged write through ``_paged_attend`` on ``device``: 3 rows
    of 24 tokens into 16-token pages, row 1's second block unallocated and
    row 2 right-padded, so writes drop to the sink. Returns the cache."""
    from kubeflow_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                              head_dim=16, n_layers=1, d_ff=64,
                              max_seq_len=64, dtype="float32", decode=True,
                              kv_page_size=16, kv_pages=6, kv_quant="int8")
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.normal(size=(3, 24, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(3, 24, 2, 16)).astype(np.float32))
    pos = np.tile(np.arange(24, dtype=np.int32), (3, 1))
    pos[2, 20:] = -1
    tables = np.array([[0, 1, -1, -1], [2, -1, -1, -1], [3, 4, -1, -1]],
                      np.int32)
    cache = T.PagedKVCache.allocate(cfg, device)
    with torch.no_grad():
        T.Attention(cfg)._paged_attend(
            torch.zeros_like(k).to(device), k.to(device), v.to(device),
            torch.from_numpy(pos).to(device), cache.layers[0],
            torch.from_numpy(tables).to(device), None)
    return cache


def test_int8_paged_write_on_cuda_equals_cpu(cuda_quant):
    """The int8 quantize-on-write on the card: the same codes and scales
    as on the CPU, byte for byte, on every real page."""
    got, want = _int8_write(cuda_quant, 0), _int8_write("cpu", 0)
    for name in ("key", "value", "key_scale", "value_scale", "pos"):
        a = getattr(got, name)[:, :6].cpu().numpy()
        b = getattr(want, name)[:, :6].numpy()
        assert a.tobytes() == b.tobytes(), name


def test_int8_sink_page_absorbs_dropped_writes_on_cuda(cuda_quant):
    """Every dropped write (row 1's unallocated block, row 2's pads) lands
    on the sink page (page 6), scales included; the free page 5 stays
    untouched."""
    cache = _int8_write(cuda_quant, 1)
    torch.cuda.synchronize()
    assert int((cache.key_scale[0, 6] > 0).sum()) > 0
    assert int((cache.value_scale[0, 6] > 0).sum()) > 0
    assert int(cache.key_scale[0, 5].abs().sum()) == 0
    assert int(cache.key[0, 5].abs().sum()) == 0
    assert bool((cache.pos[0, 5] == -1).all())
    # Real pages: row 0 fills pages 0 and 1 (24 tokens), row 1 page 2.
    assert int((cache.pos[0, 2] >= 0).sum()) == 16
    assert int((cache.pos[0, 1] >= 0).sum()) == 8


# -- multi-tenant LoRA on the card -------------------------------------------

@pytest.fixture
def cuda_lora():
    if not torch.cuda.is_available():
        pytest.skip("the LoRA fine-tune launches the flash_fwd/flash_dq/"
                    "flash_dkv CUDA kernels and the adapter pool lives in "
                    "device memory; torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_lora_gather_delta_on_cuda_matches_cpu(cuda_lora):
    """The batched gather on the card against its CPU result (f32, TF32
    off): each row its own slot, -1 rows exactly zero."""
    from kubeflow_tpu_torch.models.transformer import lora_gather_delta

    g = torch.Generator().manual_seed(0)
    entry = {"a": torch.randn(4, 1024, 8, generator=g) * 0.02,
             "b": torch.randn(4, 8, 4096, generator=g) * 0.02}
    x = torch.randn(8, 5, 1024, generator=g)
    ids = torch.tensor([3, -1, 0, 1, 2, -1, 3, 0])
    want = lora_gather_delta(x, entry, ids, torch.float32)
    got = lora_gather_delta(x.to(cuda_lora),
                            {k: v.to(cuda_lora) for k, v in entry.items()},
                            ids.to(cuda_lora), torch.float32).cpu()
    assert _rel(got, want) <= 1e-5
    assert not got[ids < 0].any()


def test_lora_finetune_step_launches_flash_on_cuda(cuda_lora):
    """A fine-tune step at S 2048 on a 2-layer base: the forward, dQ and
    dK/dV kernels launch once a layer (the factors on q/k/v need dQ and
    dK/dV), the loss at step 0 is the base model's, and the base tensors
    are bit-unchanged after the steps."""
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from kubeflow_tpu_torch.training.lora import LoRAFineTuner

    cfg = TransformerConfig(vocab_size=512, d_model=128, n_heads=2,
                            head_dim=64, n_layers=2, d_ff=256,
                            max_seq_len=2048)
    base = TransformerLM(cfg, device=cuda_lora,
                         generator=torch.Generator(cuda_lora).manual_seed(0))
    sd = {k: v.detach().clone() for k, v in base.state_dict().items()}
    tuner = LoRAFineTuner(cfg, sd, rank=8, alpha=16.0, device=cuda_lora)
    tokens = torch.randint(0, 512, (1, 2049), device=cuda_lora,
                           generator=torch.Generator(cuda_lora).manual_seed(1))
    with torch.no_grad():
        logits = base(tokens[:, :-1])
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, 512), tokens[:, 1:].reshape(-1))
    fa.reset_launches()
    losses = [tuner.train_step(tokens) for _ in range(2)]
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 4, "flash_dq": 4, "flash_dkv": 4}
    assert losses[0] == float(want)
    assert all(torch.equal(tuner.base[k], v) for k, v in sd.items())
    assert any(float(p.detach().abs().max()) > 0
               for n, p in tuner.lora.items()
               if n.endswith("_lora_b"))


def test_adapter_pool_writes_slots_in_place_on_cuda(cuda_lora, tmp_path):
    """Paging an adapter into a slot writes the device stacks in place:
    every stack keeps its data_ptr (the launches' per-layer views stay
    valid) and the slot holds alpha/rank * B."""
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.serving.adapters import (
        AdapterPool, random_lora_flat)
    from kubeflow_tpu_torch.serving.export import export_adapter

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                            head_dim=16, n_layers=2, d_ff=64, max_seq_len=64)
    flat = random_lora_flat(cfg, 4, seed=3)
    src = {f"t{i}": export_adapter(str(tmp_path / f"t{i}"), f"t{i}", cfg,
                                   flat, 4, 8.0) for i in range(3)}
    pool = AdapterPool(cfg, 2, src, draft_layers=1, device=cuda_lora)
    ptrs = {(m, n, k): t.data_ptr() for tree in (pool.tree, pool.draft_tree)
            for m, node in tree.items() for n, pair in node.items()
            for k, t in pair.items()}
    for name in ("t0", "t1", "t0", "t2"):
        pool.release(pool.acquire(name))
    assert pool.evictions == 1 and pool.loads == 3
    after = {(m, n, k): t.data_ptr() for tree in (pool.tree, pool.draft_tree)
             for m, node in tree.items() for n, pair in node.items()
             for k, t in pair.items()}
    assert after == ptrs
    slot = pool._by_name["t2"]
    b = pool.tree["mlp"]["wi"]["b"][:, slot].cpu().numpy()
    np.testing.assert_allclose(b, flat["mlp.wi"]["b"] * 2.0, rtol=1e-6)


@pytest.fixture
def cuda_kv():
    if not torch.cuda.is_available():
        pytest.skip("the KV transfer plane's page gather and scatter on the "
                    "card (DecodeEngine export/import, the host offload "
                    "tier) need an NVIDIA GPU; torch.cuda.is_available() "
                    "is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _throttled(eng, prompt, n=24):
    import time

    req = eng.submit(prompt, max_new_tokens=n,
                     on_token=lambda t: time.sleep(0.02))
    while len(req.tokens) < 2:
        time.sleep(0.002)
    return req


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_kv_import_writes_the_pool_in_place_on_cuda(cuda_kv, kv_quant):
    """An import scatters into the receiver's pool in place (every pool
    tensor keeps its data_ptr, so the decode launches' views stay valid),
    the imported prompt page's bytes on the card equal the exported frame,
    and the adopted request continues to the donor's greedy tokens."""
    import time

    from kubeflow_tpu_torch.serving import kvtransfer

    cfg, model = _tiny_gapped_lm(cuda_kv)
    kw = dict(kv_quant=kv_quant) if kv_quant else {}
    donor = _engine_on_card(cfg, model, cuda_kv, **kw)
    recv = _engine_on_card(cfg, model, cuda_kv, **kw)
    try:
        prompt = [(7 * i + 3) % 60 for i in range(20)]
        want = donor.generate([prompt], max_new_tokens=24)[0]
        ptrs = [t.data_ptr() for _, t in recv._cache_leaves()]
        grabbed = []

        def capture(payload):
            grabbed.append(payload)
            raise kvtransfer.TransferError("captured")

        req = _throttled(donor, prompt)
        assert donor.migrate_out(send=capture)["failed"] == 1
        assert req.result(60) == want   # the donor kept its copy
        hdr, frames = kvtransfer.decode(grabbed[0])
        adopted = recv.kv_import(grabbed[0],
                                 on_token=lambda t: time.sleep(0.05))
        slot = next(s for s, r in enumerate(recv._slots) if r is adopted)
        page = int(recv._tables[slot, hdr["blocks"][0]])
        row = recv._run_on_loop(lambda: recv._gather_pages([page]))
        assert row[0].tobytes() == frames[0]   # block 0: prompt only
        assert [t.data_ptr() for _, t in recv._cache_leaves()] == ptrs
        assert adopted.result(60) == want
    finally:
        donor.close()
        recv.close()


def test_offload_tier_round_trip_on_cuda(cuda_kv):
    """A prefix page demoted to the host tier at eviction promotes back on
    the card byte for byte, and the repeated prompt's tokens are
    unchanged."""
    from kubeflow_tpu_torch.serving.prefix import chain_hash

    cfg, model = _tiny_gapped_lm(cuda_kv)
    eng = _engine_on_card(cfg, model, cuda_kv, kv_pages=4,
                          kv_offload_pages=16)
    try:
        prompts = [[(7 * i + j + 2) % 60 for j in range(32)]
                   for i in range(4)]
        firsts = [eng.generate([p], max_new_tokens=8)[0] for p in prompts]
        key = chain_hash(b"", prompts[0][:16])
        demoted = eng._offload.get(key)
        assert demoted is not None
        assert eng.generate([prompts[0]], max_new_tokens=8)[0] == firsts[0]
        page = eng._prefix.full[key].page
        assert eng._run_on_loop(lambda: eng._page_payload(page)) == demoted
    finally:
        eng.close()


@pytest.fixture
def cuda_pool():
    if not torch.cuda.is_available():
        pytest.skip("the weight pool's swaps to the card (WeightPool, the "
                    "DecodeEngine's grouped dispatch) need an NVIDIA GPU; "
                    "torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pool_exports(device, root, n=3):
    """``n`` tiny wide-gap LMs (seeds 0..n-1) exported by the port's
    export_lm: (cfg, {name: dir}, {name: reference tree})."""
    from kubeflow_tpu_torch.models.convert import params_to_jax
    from kubeflow_tpu_torch.serving.lm_server import export_lm

    sources, trees = {}, {}
    for i in range(n):
        cfg, model = _tiny_gapped_lm(device, seed=i)
        trees[f"m{i}"] = params_to_jax(model.state_dict())
        sources[f"m{i}"] = export_lm(str(root / f"m{i}"), cfg,
                                     trees[f"m{i}"])
    return cfg, sources, trees


def test_weight_swap_lands_on_cuda_byte_equal_to_export(cuda_pool,
                                                        tmp_path):
    """A swap puts every tensor of the slot's module on the card, byte
    equal to the export, and records its split."""
    from kubeflow_tpu_torch.models.convert import params_to_jax
    from kubeflow_tpu_torch.models.generate import decode_config
    from kubeflow_tpu_torch.serving.lm_server import load_lm
    from kubeflow_tpu_torch.serving.weights import WeightPool

    cfg, sources, trees = _pool_exports(cuda_pool, tmp_path, 2)
    pool = WeightPool(decode_config(cfg), trees["m0"], 2, sources,
                      device=cuda_pool)
    slot = pool.acquire("m1")
    sd = pool.module(slot).state_dict()
    assert all(t.device.type == "cuda" for t in sd.values())
    got, want = params_to_jax(sd), load_lm(sources["m1"])[1]
    for a, b in zip(_flat(got), _flat(want)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert a[1].tobytes() == b[1].tobytes(), a[0]
    swap = pool.last_swap
    assert swap["model"] == "m1" and swap["bytes"] == pool.nbytes()
    assert swap["seconds"] >= swap["device_s"] > 0


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       f"{prefix}/{k}")]
    return [(prefix, np.asarray(tree))]


def test_grouped_greedy_equals_dedicated_engines_on_cuda(cuda_pool,
                                                         tmp_path):
    """Three pooled models over two weight slots on the card, one
    concurrent batch (grouped dispatch, slot pressure): every completion
    equals a dedicated engine's on that model's weights, and no flash
    kernel launches."""
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    cfg, sources, trees = _pool_exports(cuda_pool, tmp_path)
    prompts = [[5, 9, 11, 3, 7], [2, 30], [40, 41, 42, 43], [7] * 20,
               [(3 * i + 1) % 60 for i in range(33)], [1, 2, 3]]
    plan = [f"m{i % 3}" for i in range(len(prompts))]
    want = {}
    for name in sorted(sources):
        ded = DecodeEngine(cfg, trees[name], device=cuda_pool, n_slots=4,
                           chunk_tokens=4, kv_page_size=16)
        try:
            for i, m in enumerate(plan):
                if m == name:
                    want[i] = ded.generate([prompts[i]], max_new_tokens=10)[0]
        finally:
            ded.close()
    fa.reset_launches()
    eng = DecodeEngine(cfg, trees["m0"], device=cuda_pool, n_slots=4,
                       chunk_tokens=4, kv_page_size=16, models=sources,
                       model_default="m0", weight_slots=2)
    try:
        reqs = [eng.submit(p, max_new_tokens=10, model=m)
                for p, m in zip(prompts, plan)]
        got = [r.result(120) for r in reqs]
        st = eng.weight_stats()
    finally:
        eng.close()
    assert got == [want[i] for i in range(len(prompts))]
    assert st["loads"] >= 2 and st["evictions"] >= 1
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def test_eviction_returns_the_slot_bytes_on_cuda(cuda_pool, tmp_path):
    """Evicting a resident model gives its module's bytes back to the
    allocator, and hbm_bytes()["weights"] falls by the same bytes."""
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    cfg, sources, trees = _pool_exports(cuda_pool, tmp_path, 2)
    eng = DecodeEngine(cfg, trees["m0"], device=cuda_pool, n_slots=2,
                       chunk_tokens=4, kv_page_size=16, models=sources,
                       model_default="m0", weight_slots=2)
    try:
        eng.generate([[5, 9, 11]], max_new_tokens=2, model="m1")
        wp = eng._wpool
        nbytes = sum(t.numel() * t.element_size() for t in wp.module(
            wp._by_name["m1"]).state_dict().values())
        torch.cuda.synchronize()
        hbm0, alloc0 = eng.hbm_bytes()["weights"], \
            torch.cuda.memory_allocated()
        assert hbm0 == nbytes
        assert eng.evict_model("m1") is True
        torch.cuda.synchronize()
        assert eng.hbm_bytes()["weights"] == 0
        assert alloc0 - torch.cuda.memory_allocated() >= nbytes
    finally:
        eng.close()


@pytest.fixture
def cuda_compat():
    if not torch.cuda.is_available():
        pytest.skip("the Kubeflow compat surface on the card (TorchPredictor "
                    "on cuda, the PyTorchJob worker on NCCL, the MPIJob "
                    "ranks on one card) needs an NVIDIA GPU; "
                    "torch.cuda.is_available() is false")
    return torch.device("cuda")


def _compat_env(**extra):
    import os

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("KFX_", "OMPI_", "MASTER_"))
           and k not in ("RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    env.update(extra)
    return env


def test_torch_predictor_on_cuda_matches_cpu(cuda_compat, tmp_path):
    """A TorchScript export served on the card by default answers as on
    the CPU: predictions equal, probabilities within 1e-4 (TF32 off)."""
    from kubeflow_tpu_torch.serving.torch_server import (
        TorchPredictor, export_torchscript)

    torch.backends.cuda.matmul.allow_tf32 = False
    module = torch.nn.Sequential(
        torch.nn.Flatten(), torch.nn.Linear(16, 8), torch.nn.ReLU(),
        torch.nn.Linear(8, 3))
    export_torchscript(str(tmp_path), module, input_shape=(4, 4),
                       num_classes=3)
    x = np.random.default_rng(0).normal(size=(70, 4, 4)).astype(np.float32)
    got = {}
    for device in ("auto", "cpu"):
        p = TorchPredictor(str(tmp_path), device=device)
        p.load()
        assert p.device == ("cuda" if device == "auto" else "cpu")
        got[device] = p.predict(x, probabilities=True)
    assert got["auto"]["predictions"] == got["cpu"]["predictions"]
    assert np.abs(np.asarray(got["auto"]["probabilities"])
                  - np.asarray(got["cpu"]["probabilities"])).max() <= 1e-4


def test_torch_runner_world1_on_nccl(cuda_compat):
    """A one-replica PyTorchJob on the card rendezvouses over NCCL, the
    default backend on cuda."""
    import subprocess
    import sys

    from kubeflow_tpu_torch.utils.net import free_port

    out = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.runners.torch_runner",
         "--dataset=mnist", "--steps=20", "--batch-size=128",
         "--log-every=10", "--eval-samples=512"],
        env=_compat_env(MASTER_ADDR="127.0.0.1",
                        MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                        RANK="0"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "rank=0 world=1 backend=nccl" in out.stdout
    assert "train_done steps=20" in out.stdout


def test_shim_two_ranks_on_one_card(cuda_compat):
    """The MPIJob pair at -np 2 on one card: gloo over the card's tensors
    (NCCL refuses two ranks on one card), the same step= lines on both
    ranks."""
    import re
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.runners.mpi_launcher",
         "-np", "2", sys.executable, "-m",
         "kubeflow_tpu_torch.runners.mpi_jax_runner", "--model=mlp",
         "--dataset=mnist", "--steps=6", "--batch-size=64", "--log-every=3",
         "--no-checkpoint"],
        env=_compat_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("backend=gloo") == 2
    assert out.stdout.count("platform=cuda") == 2
    steps = sorted(re.sub(r" (step_time|examples_per_sec)=\S+", "", ln)
                   for ln in out.stdout.splitlines()
                   if ln.startswith("step="))
    assert len(steps) == 4 and steps[0::2] == steps[1::2], steps


@pytest.fixture
def cuda_ranks():
    if not torch.cuda.is_available():
        pytest.skip("the LM trainer across ranks on the card (tp2 over two "
                    "ranks that share it on gloo, ring attention on CUDA "
                    "tensors) needs an NVIDIA GPU; "
                    "torch.cuda.is_available() is false")
    from kubeflow_tpu_torch.ops import build

    build.load_library()   # built once, before the ranks start
    return torch.device("cuda")


def test_tp2_two_ranks_on_one_card_match_world1(cuda_ranks, tmp_path):
    """spmd_check's tp_fsdp variant (tp2) at two ranks sharing the card
    over gloo, against world 1 on the card: losses within RTOL 2e-3."""
    from kubeflow_tpu_torch.parallel import spmd_check

    got = spmd_check.check("tp_fsdp", str(tmp_path), n_processes=2,
                           device="cuda")
    assert len(got["multi"]) == spmd_check.CHECK_STEPS


_RING_RANK = '''
import sys
import numpy as np
import torch
from kubeflow_tpu_torch.parallel.mesh import make_mesh
from kubeflow_tpu_torch.parallel.ring_attention import make_ring_attention
from kubeflow_tpu_torch.runners.jax_runner import initialize_distributed

dev = initialize_distributed(torch.device("cuda"))
mesh, _ = make_mesh(cp=torch.distributed.get_world_size(),
                    device_type="cuda")
x = np.load(sys.argv[1])
q, k, v = (torch.from_numpy(x[n]).to(dev).requires_grad_()
           for n in ("q", "k", "v"))
out = make_ring_attention(mesh, "ctx")(q, k, v)
(out ** 2).sum().backward()
if torch.distributed.get_rank() == 0:
    np.savez(sys.argv[2], out=out.detach().cpu().numpy(),
             dq=q.grad.cpu().numpy(), dk=k.grad.cpu().numpy(),
             dv=v.grad.cpu().numpy())
torch.distributed.barrier()
torch.distributed.destroy_process_group()
'''


def test_ring_attention_on_cuda_tensors(cuda_ranks, tmp_path):
    """Ring attention with CUDA tensors over two ranks on the card (the
    K/V shifts go through the host-staged transport on gloo): output and
    grads within 1e-5 of dense causal attention (f32, TF32 off)."""
    import sys

    from kubeflow_tpu_torch.parallel.spmd_check import run_ranks

    B, S, H, D = 2, 256, 4, 64
    rng = np.random.default_rng(0)
    x = {"q": (rng.normal(size=(B, S, H, D)) / 8.0).astype(np.float32),
         "k": rng.normal(size=(B, S, H, D)).astype(np.float32),
         "v": rng.normal(size=(B, S, H, D)).astype(np.float32)}
    np.savez(tmp_path / "in.npz", **x)
    script = tmp_path / "ring_rank.py"
    script.write_text(_RING_RANK)
    outs = run_ranks([sys.executable, str(script), str(tmp_path / "in.npz"),
                      str(tmp_path / "out.npz")], 2, timeout=300)
    assert all("transport=host_staged(" in o for _, o, _ in outs)
    got = np.load(tmp_path / "out.npz")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.from_numpy(x[n]).to(cuda_ranks).requires_grad_()
               for n in ("q", "k", "v"))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    mask = torch.ones(S, S, dtype=torch.bool, device=cuda_ranks).tril()
    p = torch.softmax(s.masked_fill(~mask, -1e30), -1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    (out ** 2).sum().backward()
    for name, want in (("out", out), ("dq", q.grad), ("dk", k.grad),
                       ("dv", v.grad)):
        want = want.detach().cpu().numpy()
        err = float(np.abs(got[name] - want).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), (name, err)


@pytest.fixture
def cuda_plane(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("the training control plane's default device (a JAXJob "
                    "whose worker trains on cuda with KFX_WORKER_PLATFORM "
                    "unset) needs an NVIDIA GPU; torch.cuda.is_available() "
                    "is false")
    for k in ("KFX_WORKER_PLATFORM", "KFX_DEVICE", "KFX_CHAOS"):
        monkeypatch.delenv(k, raising=False)
    return torch.device("cuda")


def test_plane_runs_a_jaxjob_on_cuda_by_default(cuda_plane, tmp_path):
    """A plane in this process, the device env unset: a one-replica
    JAXJob of a few steps reaches Succeeded and its worker says cuda."""
    import sys

    from kubeflow_tpu_torch.api.base import from_manifest
    from kubeflow_tpu_torch.controlplane import ControlPlane

    job = from_manifest({
        "apiVersion": "kubeflow.org/v1", "kind": "JAXJob",
        "metadata": {"name": "on-card", "namespace": "default"},
        "spec": {"jaxReplicaSpecs": {"Worker": {
            "replicas": 1, "restartPolicy": "Never",
            "template": {"spec": {"containers": [{
                "name": "w", "command": [
                    sys.executable, "-m",
                    "kubeflow_tpu_torch.runners.jax_runner", "--model=mlp",
                    "--dataset=mnist", "--steps=8", "--batch-size=64",
                    "--log-every=4", "--eval-samples=256",
                    "--no-checkpoint"]}]}}}}}})
    with ControlPlane(home=str(tmp_path / "kfx")) as cp:
        cp.apply([job])
        final = cp.wait_for_job("JAXJob", "on-card", timeout=300)
        log = cp.job_logs("JAXJob", "on-card")
    assert final.has_condition("Succeeded"), log
    assert "platform=cuda" in log and "train_done steps=8" in log


def test_pipeline_template_step_on_cuda_by_default(cuda_plane, tmp_path):
    """A plane with no KFX_ env: a Pipeline's template step renders to a
    JAXJob whose worker gets KFX_DEVICE=cuda and trains on the card; the
    same step with the card hidden from its worker (CUDA_VISIBLE_DEVICES
    empty, a machine without a GPU as the worker sees it) fails with the
    runner's device error, and the Pipeline with it, never training on
    the CPU."""
    import os
    import sys

    from kubeflow_tpu_torch.api.base import from_manifest
    from kubeflow_tpu_torch.controlplane import ControlPlane

    cmd = [sys.executable, "-m", "kubeflow_tpu_torch.runners.jax_runner",
           "--model=mlp", "--dataset=mnist", "--steps=4", "--batch-size=64",
           "--log-every=2", "--eval-samples=256", "--no-checkpoint",
           "--export-dir=${params.workspace}/mlp"]

    def pipeline(name, env=None):
        container = {"name": "main", "command": cmd}
        if env:
            container["env"] = [{"name": k, "value": v}
                                for k, v in env.items()]
        return from_manifest({
            "apiVersion": "kubeflow.org/v1", "kind": "Pipeline",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"steps": [{"name": "train", "template": {
                "spec": {"containers": [container]}}}]}})

    with ControlPlane(home=str(tmp_path / "kfx")) as cp:
        cp.apply([pipeline("on-card"),
                  pipeline("no-card", {"CUDA_VISIBLE_DEVICES": ""})])
        ok = cp.wait_for_condition("Pipeline", "on-card", "Succeeded",
                                   timeout=300)
        bad = cp.wait_for_condition("Pipeline", "no-card", "Failed",
                                    timeout=300)
        logs = {n: cp.job_logs("JAXJob", f"{n}-train")
                for n in ("on-card", "no-card")}
    assert ok.status["steps"] == {"train": "Succeeded"}, logs["on-card"]
    assert "platform=cuda" in logs["on-card"]
    assert "train_done steps=4" in logs["on-card"]
    assert os.path.isdir(str(tmp_path / "kfx" / "pipeline-workspaces" /
                             "default_on-card" / "mlp"))
    assert bad.status["steps"] == {"train": "Failed"}
    assert "torch.cuda.is_available() is false" in logs["no-card"]
    assert "runner_start" not in logs["no-card"]
    assert "train_done" not in logs["no-card"]


def test_inferenceservice_replica_on_cuda_by_default(cuda_plane, tmp_path):
    """A plane with no pin: an InferenceService over a small mlp export
    reaches Ready, its replica says device=cuda, and :predict answers as
    the in-process JaxPredictor on the card does."""
    import glob
    import json
    import time
    import urllib.request

    from kubeflow_tpu_torch.api.manifest import load_manifests
    from kubeflow_tpu_torch.controlplane import ControlPlane
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.serving.export import export_params
    from kubeflow_tpu_torch.serving.server import JaxPredictor

    model = get_model("mlp", num_classes=10, input_shape=(28, 28, 1))

    class State:
        params = dict(model.named_parameters())
        batch_stats = dict(model.named_buffers())

    export = str(tmp_path / "export")
    export_params(export, "mlp", (28, 28, 1), 10, State())
    x = np.random.default_rng(0).random((4, 28, 28, 1)).astype(np.float32)
    want = JaxPredictor(export)
    want.load()
    home = tmp_path / "kfx"
    with ControlPlane(home=str(home)) as cp:
        cp.apply(load_manifests(f"""
apiVersion: serving.kubeflow.org/v1beta1
kind: InferenceService
metadata:
  name: on-card
spec:
  predictor:
    jax:
      storageUri: file://{export}
"""))
        deadline = time.monotonic() + 180
        while True:
            isvc = cp.store.get("InferenceService", "on-card")
            if isvc.has_condition("Ready", "True"):
                break
            assert time.monotonic() < deadline, isvc.status
            time.sleep(0.2)
        req = urllib.request.Request(
            f"{isvc.status['url']}/v1/models/on-card:predict",
            data=json.dumps({"instances": x.tolist()}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.load(resp)
    assert body["predictions"] == want.predict(x)["predictions"]
    log = "".join(open(p).read() for p in glob.glob(
        str(home / "serving" / "*" / "default-*.log")))
    assert "server_ready" in log and "device=cuda" in log


@pytest.fixture
def cuda_nas():
    if not torch.cuda.is_available():
        pytest.skip("the DARTS / ENAS supernets on the card "
                    "(kubeflow_tpu_torch/hpo/darts.py, enas.py; cuDNN "
                    "convolutions, no kernel of the port's) need an NVIDIA "
                    "GPU; torch.cuda.is_available() is false")
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32)
    # What the NAS runners set; TF32 off so that f32 is f32 on the card.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cudnn.allow_tf32) = saved


_NAS_KW = dict(edges=3, features=8, search_steps=6, eval_steps=4,
               batch_size=32, seed=3)


def test_darts_search_on_cuda_matches_cpu(cuda_nas):
    """A few DARTS steps in f32 on the card and on the CPU from the same
    weights (the SuperNet draws them from a CPU generator): the alphas
    within 1e-3 and every step's losses within 1e-3 relative (summation
    order only, amplified by Adam's normalised steps); the retrained
    genotype's accuracy within 4 of the 2048 scored images."""
    from kubeflow_tpu_torch.hpo import darts

    got = darts.search(**_NAS_KW, device="cuda", dtype=torch.float32)
    want = darts.search(**_NAS_KW, device="cpu", dtype=torch.float32)
    np.testing.assert_allclose(got.alphas, want.alphas, rtol=0, atol=1e-3)
    for g, w in zip(got.history, want.history):
        for k in ("train_loss", "val_loss"):
            assert abs(g[k] - w[k]) <= 1e-3 * abs(w[k]), (k, g, w)
    assert abs(got.val_accuracy - want.val_accuracy) <= 4 / 2048


def test_nas_search_on_cuda_is_deterministic(cuda_nas):
    """The reference promises search() is a function of its arguments:
    two bf16 runs on the card give the same genotype, alphas (or
    controller logits) and accuracy, bit for bit."""
    from kubeflow_tpu_torch.hpo import darts, enas

    a, b = (darts.search(**_NAS_KW, device="cuda") for _ in range(2))
    assert a.genotype == b.genotype and a.val_accuracy == b.val_accuracy
    np.testing.assert_array_equal(a.alphas, b.alphas)
    kw = dict(_NAS_KW, warmup_steps=8)
    c, d = (enas.search(**kw, device="cuda") for _ in range(2))
    assert c.genotype == d.genotype and c.val_accuracy == d.val_accuracy
    np.testing.assert_array_equal(c.logits, d.logits)
    assert [h["reward_mean"] for h in c.history] == \
        [h["reward_mean"] for h in d.history]


def _lm_job(name, steps):
    """A one-Worker JAXJob of the LM runner at the small preset, S 1024,
    b2: head dim 64 in bf16, inside the flash window, so its attention
    runs the three wgmma kernels (the tiny preset's head dim 32 is outside
    the kernels' shapes)."""
    import sys

    from kubeflow_tpu_torch.api.base import from_manifest

    return from_manifest({
        "apiVersion": "kubeflow.org/v1", "kind": "JAXJob",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"jaxReplicaSpecs": {"Worker": {
            "replicas": 1, "restartPolicy": "Never",
            "template": {"spec": {"containers": [{
                "name": "lm", "command": [
                    sys.executable, "-m",
                    "kubeflow_tpu_torch.runners.lm_runner",
                    "--preset=small", "--dataset=lm-small",
                    "--seq-len=1024", "--batch-size=2",
                    f"--steps={steps}", "--warmup-steps=1",
                    "--log-every=1", "--no-checkpoint"]}]}}}}}})


def _wait_log(cp, name, text, timeout=300):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if text in cp.job_logs("JAXJob", name):
                return True
        except (FileNotFoundError, KeyError):
            pass
        time.sleep(0.2)
    return False


def test_kfx_profile_of_a_cuda_lm_job_names_the_flash_kernels(cuda_plane,
                                                               tmp_path,
                                                               capsys):
    """`kfx profile` of an LM job training on the card (the plane's
    default device): the trace names flash_fwd_wgmma_kernel,
    flash_dq_wgmma_kernel and flash_dkv_wgmma_kernel, launched through
    ctypes from the port's library, and holds aten:: ops of the worker's
    main thread."""
    from kubeflow_tpu_torch import profiling
    from kubeflow_tpu_torch.cli import KfxCLI
    from kubeflow_tpu_torch.controlplane import ControlPlane

    with ControlPlane(home=str(tmp_path / "kfx")) as cp:
        cp.apply([_lm_job("prof-lm", 2000)])
        try:
            assert _wait_log(cp, "prof-lm", "step=2 "), \
                cp.job_logs("JAXJob", "prof-lm")
            rc = KfxCLI(cp).profile("JAXJob", "prof-lm", "default", "",
                                    duration_ms=1000,
                                    logdir=str(tmp_path / "trace"))
            out = capsys.readouterr().out
            assert rc == 0, out
        finally:
            cp.store.delete("JAXJob", "prof-lm")
    [path] = [ln for ln in out.splitlines()
              if ln.endswith(profiling.TRACE_SUFFIX)]
    trace = profiling.load_trace(path)
    head = trace["kfxCapture"]
    kernels = {e["name"] for e in trace["traceEvents"]
               if e.get("cat") == "kernel"}
    for sym in ("flash_fwd_wgmma_kernel", "flash_dq_wgmma_kernel",
                "flash_dkv_wgmma_kernel"):
        assert any(sym in k for k in kernels), (sym, sorted(kernels)[:20])
    assert any(e.get("cat") == "cpu_op" and e["name"].startswith("aten::")
               and e.get("tid") == head["main_tid"]
               for e in trace["traceEvents"])
    assert "CUDA" in head["activities"]


def test_kfx_server_maps_no_libcuda_while_its_job_trains(cuda_plane,
                                                         tmp_path):
    """`kfx server` is a torch-free process: while a job it owns trains on
    the card, its address space maps no libcuda (and no torch); SIGTERM
    stops it with rc 0 and removes its marker."""
    import os
    import signal
    import subprocess
    import sys
    import time

    import yaml

    from kubeflow_tpu_torch.apiserver import Client, live_server_url

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    home = str(tmp_path / "home")
    env = {k: v for k, v in os.environ.items() if not k.startswith("KFX_")}
    env["PYTHONPATH"] = repo
    server = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.cli", "--home", home,
         "server", "--port", "0"], cwd=repo, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        url = None
        while url is None and time.monotonic() < deadline:
            url = live_server_url(home) if os.path.isdir(home) else None
            time.sleep(0.1)
        assert url, "kfx server never answered /healthz"
        client = Client(url)
        client.apply_text(yaml.safe_dump(_lm_job("owned-lm", 400).to_dict()))
        deadline = time.monotonic() + 300
        log = ""
        while "step=2 " not in log and time.monotonic() < deadline:
            log = client.logs("jaxjob", "default", "owned-lm")
            time.sleep(0.2)
        assert "step=2 " in log and "device=cuda" in log, log
        with open(f"/proc/{server.pid}/maps") as f:
            maps = f.read()
        assert "libcuda" not in maps and "libtorch" not in maps
        client.delete("jaxjob", "default", "owned-lm")
        server.send_signal(signal.SIGTERM)
        out, _ = server.communicate(timeout=60)
        assert server.returncode == 0, out
        assert not os.path.exists(os.path.join(home, "server.json"))
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
