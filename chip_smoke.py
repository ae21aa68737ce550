#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubeflow_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --n3-alone   # only (n3), in a fresh process

(``--lm-worker`` and ``--beside`` are the script's own child processes.)

Phases, in order; any failure raises and the process exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build the flash-attention kernels from ops/csrc (nvcc, sm_90a); the
   six wgmma kernels (forward, dQ and dK/dV at D 64 and 128) must show no
   spill stores in ptxas's report;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shape [4, 2048, 16, 64] bf16 and the large preset's
   head dim [2, 2048, 16, 128], with times (CUDA events around back-to-back
   calls), the plain version's time, the one-call PyTorch yardstick
   (PyTorch's fused causal attention and its backward, timed here and used
   nowhere in the port), the bound and the achieved TFLOP/s; each record
   names its design (design() in ops/flash_attention.py: "wgmma" for all
   three kernels in bf16 at D 64/128, flash_fwd_wgmma.cu,
   flash_dq_wgmma.cu and flash_dkv_wgmma.cu; "fma" for f32 at every D and
   bf16 at D 192/256, flash_fwd.cu and flash_bwd.cu);
   plus short correctness checks of every (dtype, head dim) instantiation;
4. model: TransformerLM at the base preset's full width and depth, flash vs
   naive attention on the same weights (held in f32; bf16 printed);
5. main path: the LM runner (base preset, lm-small, 4 steps, batch 4,
   S = 2048, attn_impl auto, --export-dir build/serve_export) with the
   launch counters set to 0 just before and read just after;
5b. training options, base preset at full width, S = 2048, each rung with
   the launch counters set to 0 just before and read just after, with
   step time, tokens/s, MFU (model FLOPs, recompute not credited) and
   peak memory: (h0) at 4 layers, batch 2, attn flash, one backward under
   each of nothing, save_flash, save_flash_min, save_flash_full and
   save_dense against the no-remat grads of the same weights (f32 held
   within 1e-5 relative to each tensor's max, bf16 printed; flash_fwd
   launches L under save_flash*, 2L otherwise), and loss_chunk=256 against
   whole logits (f32 loss and lm_head grad within 1e-5); (h1) the runner
   with --remat --remat-policy nothing, b8, 3 steps: flash_fwd exactly 2L
   a step plus L for the eval batch, flash_dq and flash_dkv L a step;
   (h2) --remat-policy save_flash_full, b8: flash_fwd exactly L a step
   (the reference's first long-context rung); (h2b) a b8 step without
   remat, under full remat, under full remat through the selective
   dispatch mode (empty save set) and under save_flash_full, in turns in
   one process, with kernel time and busy share; (h3) LMTrainLoop with
   save_flash_min and loss_chunk=256 at b16 (the second rung), and one
   step's peak memory with and without loss_chunk on the same batch;
   (h4) the runner with --experts 8 (top-2, capacity 1.25) and
   save_flash_full, b4: finite losses, and the aux term printed;
5c. (p) the LM trainer across ranks, right after the main path, two
   ranks sharing the card over gloo (NCCL refuses that; each rank's
   process_group line must name the host-staged transport); (p1), the
   main path's runner command at tensor 2, runs through the control plane
   as (q6); (p2)
   parallel/spmd_check.py's tp_fsdp, cp, ep and pp variants at the base
   width cut to 4 layers, S 2048, f32 (flash on FMA), batch 4, two ranks
   each (the four side by side), against the same loops at world 1
   in this process (RTOL 2e-3), then the main path's runner command at
   two ranks (dp2) with --collective-overlap on against LMTrainLoop at
   world 1 on the same global batch (2e-3), its collective_allreduce
   line and its train.collective span;
6. serving, with the launch counters set to 0 just before and read just
   after (the decode path reaches no flash kernel, as in the reference):
   (a) that export loaded by LMPredictor on the card behind an in-process
   ModelServer on the one-shot path (KFX_LM_ENGINE=0, set explicitly: the
   engine is the default): one HTTP :generate of 8 prompts (64-512
   tokens, greedy, 64 new) equal to a direct LMGenerator call, an SSE
   stream equal to the buffered answer, /metrics; (b) cache decode against
   full recompute on the base preset in f32 with wide-gap weights; (c)
   seeded sampling determinism and top_k=1 == greedy; (e) load seconds,
   prefill and decode-step times against the decode step's bound, decode
   tokens/s, the device's busy share in a decode step, peak memory;
   (f) the continuous-batching DecodeEngine without a draft
   (KFX_LM_SPEC=0 pinned, so its numbers stay comparable across PRs),
   counters set to 0 just before and read just after: on (b)'s wide-gap
   f32 base weights the engine's greedy tokens for (a)'s 8 prompts x 64
   equal LMGenerator's (smallest top-1/top-2 gap asserted first), the
   512-token prompt repeated hits the prefix cache with unchanged tokens,
   a pool of one max-length request's pages preempts with unchanged
   tokens, and no page leaks; on the base export behind an engine-backed
   ModelServer, 8 concurrent single-prompt HTTP :generate requests (one
   per thread, streamed) all answer, and in a second and third wave
   (prompts cached) the SSE streams equal the buffered answers; the
   first wave's aggregate tokens/s against the same 8 served one after
   another by the one-shot path, time to first token, and the decode
   chunk at 8 active slots against its bound, with its host enqueue
   time, kernels and busy share;
   (g) speculative decoding, the reference's default (a draft of
   n_layers // 4 = 6 layers, 4 proposals a verify window), counters set
   to 0 just before and read just after: (g1) on (b)'s wide-gap f32 base
   weights, the speculating engine's greedy tokens for (a)'s 8 prompts x
   64 equal LMGenerator's (the smallest gap held to 10x the measured
   disagreement of the verify window's logits), with the accept rate; a
   draft pool of 8 pages degrades slots, fails none, and neither pool
   leaks; (g2) the bf16 export behind an engine-backed ModelServer with
   the default environment (speculation on): 8 concurrent SSE requests,
   aggregate tokens/s, TTFT, the accept rate from /metrics?format=json,
   and the kfx_tenant_* totals equal to the tokens served; agreement with
   (f2)'s tokens counted, not held (bf16); a probe of bf16 rounding with
   and without the prefix cache (ROADMAP Queue C 1); (g3) one speculative
   iteration at 8 active slots by hand: ms, host enqueue, kernels, busy
   share, tokens an iteration and the iteration's bound;
   (h5) the flight recorder (on by default), on (f2)'s server after its
   waves: /debug/flight holds records, /debug/requests the waves'
   requests with admit ... first_token ... retire trails, a :generate
   answer carries the timing block and the X-Kfx-Timing header; in (f3),
   the iteration at 8 slots with the recorder off and on, in turns, and
   the record run under CUDA's sync-debug mode "error" (it must not
   synchronise);
   (j) int8 serving at the base preset's full width, counters set to 0
   just before and read just after (0/0/0: no kernel on this path, as in
   the reference): (j0) on (b)'s wide-gap f32 weights, TF32 off, the w8
   model's logits against the f32 model's (within 5% of the largest
   |logit|, NLL within 2%) and the dequantized tree through the
   full-precision path against the w8 path (1e-4); (j1) the int8-KV and
   w8+kv8 engines' greedy drift from LMGenerator (mean agreement >= 0.5;
   the first token equal wherever the f32 top-1/top-2 gap exceeds twice
   the int8 path's largest logit change at that decision, the rows under
   it counted), then the bf16 export behind ModelServer with
   KFX_LM_QUANT=int8 and KFX_LM_KV_QUANT=int8 set as a user sets them:
   one :generate of (a)'s 8 prompts at full length (JK_NEW
   tokens), two repeats of 16 tokens identical,
   quant "w8+kv8" and the int8 kv_bytes_per_token in the JSON engine
   block; (j2) an int8-KV engine in f32 with a small pool and the prefix
   cache (a prefix hit, preemption) gives (j1)'s int8-KV tokens (a pool
   that holds every request, no hit) byte for byte; (j3) a bf16 and an
   int8 pool of the same bytes, 16 requests of 256 + 16 tokens: the int8
   pool's peak concurrent admissions >= 1.8x the bf16 pool's; (j4) an
   int8 draft (6 layers) on the f32 target, greedy equal to the first
   JK_NEW of (f1)'s tokens, the accept rate, and
   KFX_LM_QUANT_DRAFT=int8 on the bf16 export (mode "d8", one request of
   16 tokens); (j5), in (m)/(n)'s child after (n), the
   decode chunk at 8 slots under bf16 compute with f32 weights, w8, kv8
   and w8+kv8 (not profiled), with pool bytes, weight bytes, peak
   memory and load seconds, and one QuantDense call against the Dense
   call and a bf16 matmul at the mlp.wi shape for 8 tokens. No gain is
   claimed;
   (k) the chaos points, through KFX_CHAOS where a user sets it: (k1)
   engine.admit:count=1 answers 500 "chaos[engine.admit]: lm", the next
   request serves, /metrics counts 1; (k2) engine.kv_alloc:count=1
   answers 503 with Retry-After, then serves; (k3)
   engine.wedge:count=1,delay=1.5: the heartbeat and /healthz show the
   stall, the flight ring's last record is the stalled iteration, the
   drain completes and the request finishes; (k4) engine.spec_verify on
   every iteration of a request of JK_NEW tokens (f32 target, int8
   draft): tokens equal, accepted frozen, no page leak, speculation
   resumes; (k5) engine.kv_quant:count=2 on a w8+kv8 engine ((j5)'s
   quantized export): full-length answers (JK_NEW tokens) that differ
   from the clean run, an empty prefix cache, every page free after a
   drain; (k6, in phase (i)) serving.predict:count=1 on
   :predict: one 500, then served; (k7) rides phase (q), as (q3);
   (l) multi-tenant LoRA at the base preset's full width: (l0)
   LoRAFineTuner (rank 8, alpha 16) on the main path's trained weights,
   b4, S = 2048, 4 steps, counters set to 0 just before and read just
   after: flash launches exactly L a step for each kernel, the step-0
   loss equal to the base model's, the base tensors bit-unchanged; step
   time, tokens/s, peak memory and busy share against the main path's
   base step; the adapter exported; then 8 more adapters as bench.py
   makes them (random_lora_flat, seeds 101-108); (l1) on (b)'s wide-gap
   f32 weights, 8 adapters over 8 slots in one batch (every slot its own
   adapter, (a)'s prompts, 16 greedy tokens): each row equal to its
   adapter's merged-weights LMGenerator (the smallest gap held against
   the measured logit disagreement of the gather and merged paths, as in
   (f1)), and base-only rows equal to (f1)'s adapterless tokens; (l2) 8
   adapters over 4 slots: tokens unchanged, loads and evictions in LRU
   order, no pinned slot left; (l3) the 6-layer draft wearing the
   adapters: greedy unchanged; (l5) engine.adapter_load:count=1 with
   fallback "base" serves the base's tokens, counts one fallback, then
   heals; (l4) the bf16 export behind ModelServer with KFX_LM_ADAPTERS
   (9 artifacts over 8 slots, KFX_LM_SPEC=0): 8 concurrent :generate
   requests each with its own adapter (aggregate tokens/s, against (f2)'s
   base-only wave on the same export), hbm_bytes() and its ratio to the
   total without the adapter stacks, the kfx_lm_adapter_* families on
   /metrics, the chunk at 8 slots with adapters (ms, kernels, host
   enqueue, busy share; against (f3)'s base-only chunk), and with
   fallback "error" the ninth adapter's failed load answers 503 with
   Retry-After, then serves; flash launches 0/0/0 in (l1)-(l5);
   (m), (n) and (j5) run one after the other in a child process (this
   script with --beside) that starts before (j) and shares the card with
   (j), (k) and (l), which run here meanwhile; the child prints its log
   after (l) and every time of (j)-(n) is taken beside the other
   process;
   (m) the request plane and the KV transfer plane: (m0) one-slot engines
   on the bf16 export's weights at max_seq_len 512: a deadline that
   expires in the queue sheds before prefill, an infeasible deadline
   sheds at submit under a warm queue-wait estimate, an interactive
   arrival sheds the newest queued batch request, and with four slots
   over a 16-page pool the batch slots are the preemption victims
   (kfx_lm_deadline_shed_total read back); a tenant over its
   KFX_LM_RATE_LIMITS budget answered 503 with Retry-After over HTTP
   (kfx_lm_rate_limited_total on /metrics); (m1) two engines on (b)'s
   wide-gap f32 weights: (a)'s 8 prompts migrated after 16 tokens, their
   greedy tokens equal to the unmigrated run and the first 64 to (f1)'s
   LMGenerator, one seeded sampled stream equal to its unmigrated one,
   and one request of 960 + 64 tokens on the bf16 export (its pages of
   98400 bytes a token) equal to its unmigrated run; each leg's export and
   import ms, bytes, pages and GB/s printed, free pages balanced on both
   engines; (m3) kv.transfer:count=1 loses nothing and a corrupt frame is
   refused with no page leaked; (m2) a KFX_LM_ROLE=prefill server with
   KFX_LM_KV_PEERS at a decode server over loopback HTTP: 503 +
   X-Kfx-Migrated, the re-dispatched body claims the adopted generation,
   tokens (buffered and streamed) equal the decode server's own, TTFT of
   both paths; (m4) the host tier on the wide-gap f32 weights: a page
   demoted at eviction promotes back byte for byte, tokens unchanged, the
   prefix hit counted; flash launches 0/0/0;
   (n) the multi-model weight pool at the base preset's full width: three
   checkpoints over two weight slots (m0 (f1)'s wide-gap f32 weights and
   m1 another seed's as v1 f32 exports, m2 a third seed's as a v2 int8
   export normalized into the f32 pool), each export written once; (n1)
   an engine (8 slots, 8-step chunks, 32-token pages, weight_slots 2,
   model_default m0) takes (a)'s 8 prompts at once, prompt i for model
   m{i % 3}, 16 greedy tokens each: every completion equal to LMGenerator
   on its model's weights (gaps held as in (f1)), loads >= 3, evictions
   >= 1, every page and weight slot free after; each swap's split
   printed; (n2) m1 evicted (hbm_bytes()["weights"] and
   torch.cuda.memory_allocated() fall by its bytes), then a 1-token
   request cold against the same warm, the swap split into
   storage.initialize + load_lm, normalize and the copy to the card
   (GB/s); (n3) the chunk at 8 active slots by hand (not profiled, 3
   reps): one weight group against two groups of 4, with the process's
   live threads (--n3-alone runs only this part, after the exports and
   the engine it needs, in a fresh process); (n5) the pool's
   hbm_bytes()["total"] (2 models resident) over a dedicated engine's;
   (n4) LMPredictor with KFX_LM_MODELS, KFX_LM_MODEL_DEFAULT and
   KFX_LM_WEIGHT_SLOTS=2 behind ModelServer: a model "m1" :generate equal
   to (n1)'s tokens, "nope" a 400, GET /v1/models/m2 pooled, :evict of m1
   {"model": "m1", "evicted": true}, KFX_CHAOS="weights.load:count=1" a
   503 with Retry-After then a 200, /metrics with the kfx_lm_weight_*
   families and kfx_autoscaler_cold_start_seconds{mode="swap"}; flash
   launches 0/0/0;
   (r) the serving tier, after phase (i), with no KFX_ variable in the
   env (replicas default to cuda), this process's counters set to 0 just
   before and read just after (0/0/0): (r1) a ControlPlane in this
   process applies examples/torch/inferenceservice-resnet.yaml with its
   storageUri pointed at (i)'s 224^2 ResNet-50 export (jax:, maxReplicas
   2, targetConcurrency 1): Ready, its replica's server_ready line says
   framework=jax device=cuda, 16 seeded images through status.url answer
   JaxPredictor's predictions, then R_SEQ batch-1 requests through
   status.url and R_SEQ straight to the replica's port (from its
   server_ready line), in turns: p50/p99 of each, their p50 difference
   the router hop, printed beside (i)'s p50 (whose ModelServer runs in
   this process); (r2) (o1),
   KFServing's pytorch: predictor: (i)'s export in the port's classifier,
   traced with torch.jit.trace (the ResNet's getattr block lookup does not
   script) and written as model.pt + config.json, re-applied as the
   service's canary at canaryTrafficPercent 50: both revisions Ready (the
   canary's line framework=pytorch device=cuda), R_CANARY_REQUESTS
   requests of the 16 images each pass compat_parity against (i)'s
   JaxPredictor and the router's per-revision counters show both
   answering, then R_SEQ batch-1 requests straight to the canary's
   replica (the pytorch: predictor's p50/p99, (o1)'s latency); (r3) without the canary, R_CLIENTS concurrent batch-1
   clients scale the default revision from 1 to 2 (status.autoscaling,
   the scheduler's serving grant and two endpoints), then a
   replica.kill:count=1 chaos plan in this process kills one replica
   mid-burst: no client request fails, the revision's restarts and
   kfx_replica_restarts_total{reason="crashed"} read 1; it prints the
   apply-to-Ready seconds, the scale-up replica's spawn-to-ready seconds
   and the requests by revision on an {"isvc": ...} line;
   (o) the Kubeflow compat surface: (o1) is (r2); (o2) the PyTorchJob
   worker with examples/pytorchjob-mnist.yaml's arguments (mnist, 300
   steps, b128): two ranks on the one card with --backend=gloo (rank 0
   prints rank=0 world=2, both ranks' final loss= and accuracy= equal),
   then one rank with the default backend (backend=nccl), each run's
   wall-clock, its processes started beside phase (q)'s jobs (each is
   mostly start-up); (o3) rides phase (q), as (q5). TensorFlow and
   scikit-learn are not on the card's machine (their predictors and the
   TFJob worker run on the host, in the reference too), so (o) drives
   none of them;
   (q) the training control plane, after (r), with no KFX_ variable in
   the env (the workers' device defaults to cuda), this process's
   counters set to 0 just before and read just after (0/0/0), every job
   side by side (each is mostly start-up; every step time in (q) is taken
   under that contention): (t) the apiserver, kfctl and the profiler, on a
   thread that starts only processes: (t1) `python -m
   kubeflow_tpu_torch.cli --home build/t server --port <free>` in its own
   process with no KFX_ variable in its env, ready when its marker's URL
   answers /healthz, holding no CUDA context (nvidia-smi lists no compute
   app of its pid and its address space maps no libcuda, read while its
   job trains); (t2) in build/t, `kfx init` scaffolds a KfDef whose one
   application is the main path's runner command (this script with
   --lm-worker, as (s1)'s train step) as a JAXJob with --steps
   ${param.steps} = T_STEPS, `kfx generate` renders the Profile then the
   JAXJob, and once (s1)'s train step has ended its training (its
   train_done line: with both base-preset LM jobs at once the card's
   memory in use reached 80.8 of 85.0 GB) `KFX_SERVER=<url> kfx run -f
   kfdef.yaml` applies it through the remote client (the admin token
   rides: the URL is the marker's): the Profile and the JAXJob created in the KfDef's namespace
   with its labels, the job Succeeded with runner_start device=cuda,
   finite losses and flash launches of L x T_STEPS + L / L x T_STEPS /
   L x T_STEPS in its worker, the seconds from apply to Succeeded beside
   the runner's own; while it trains, GET / and the job's dashboard page
   200 with its state, /metrics a valid exposition, `KFX_SERVER=<url> kfx
   get` and `kfx logs` answer; (t3) once the worker's log shows its first step=
   line, `kfx --home build/t profile jaxjob` with no KFX_SERVER (a passive
   plane on the server's home) captures T_PROFILE_MS: one
   .pt.trace.json.gz under <logdir>/plugins/profile/<run>/ that parses,
   whose kernel events name flash_fwd_wgmma_kernel, flash_dq_wgmma_kernel
   and flash_dkv_wgmma_kernel and which holds aten:: ops of the worker's
   main thread; a {"profile": ...} line gives each flash kernel's
   launches in the window and mean device us beside the kernel table's
   CUDA-event ms, the window's five kernels by device time, its busy
   share and the runner's step times inside and outside the window; (t4)
   `KFX_SERVER=<url> kfx delete -f kfdef.yaml` removes the job then the
   Profile, and SIGTERM stops the server with rc 0, its marker gone. In
   a journaled ControlPlane in this process: (s1) the train-then-serve Pipeline of
   examples/torch/lm-train-serve-pipeline.yaml, its train step (q2)'s job:
   the main path's runner command (--no-checkpoint, as the main path
   writes none) plus the example's --export-dir into the pipeline's
   workspace, as a one-Worker JAXJob whose worker is this script with
   --lm-worker (the runner in that process, then its flash launches):
   Succeeded, device=cuda, finite step and loss lines, launches equal to
   the main path's (120/96/96), its step time beside the main path's; its
   serve step the example's InferenceService on that export: status.steps
   {train, serve} Succeeded, the replica's server_ready line device=cuda,
   :generate of S1_NEW tokens on the service's URL twice, the same
   tokens, and the seconds from apply to each step's end; (s2) an SLO on
   that service: after those requests the plane's scraper has evaluated
   it, Ready, finite budget and burn rows, both generated burn rules in
   the rule engine's states; (s3), host only: a Profile capping its
   namespace at count/jobs 1 (the second of two sleep jobs Queued with
   the scheduler's QuotaExceeded reason until the first ends, then run),
   a PodDefault whose env shows in the matching job's log and not in the
   other's, and examples/torch/notebook.yaml Ready with a status.url
   and /api/kernels that answer, culled after S3_IDLE_S idle seconds;
   (q3)
   tests/test_chaos.py's crash story as its TestChaosSmoke runs it ((k7)):
   a JAXJob (restartPolicy OnFailure, backoffLimit 2) whose runner, under
   KFX_CHAOS with a state file, corrupts its step-20 save and crashes
   there (exit 137, read in the gang's on_change before the restart), and
   whose restart quarantines 20, resumes from 10 and finishes (exit 0,
   restartCount 1); (q4) examples/torch/pytorchjob-mnist.yaml: two ranks
   on the card over gloo, the master's exit 0, both final lines equal;
   (q5) examples/torch/mpijob-resnet-cifar10.yaml, the launcher's mpirun
   through the shim at -np 2 on the card ((o3)'s checks on the launcher's
   log and exit code); (q6) (p1): the same command as (s1)'s train step
   in a JAXJob of one Worker whose spec.parallelism is {tensor: 2}, which
   the plane runs
   as two ranks of one replica (worker-0 and worker-0.1, KFX_NUM_PROCESSES
   2): on each rank the plan pp1/dp1/tp2, flash 120/96/96, q holding 8 of
   the 16 heads, the step-2 loss within 2e-3 of the main path's (the
   first update has learning rate 0) and steps 3-4 and the eval loss
   within 1e-2, its step time, peak memory and the time of one tp
   all-reduce of [4, 2048, 1024] bf16 (times the 4L + 2 a step); the job
   one succeeded Worker replica. Then, for every job, the spans the plane
   wrote (<home>/spans/plane-<pid>.jsonl): admission, reconciles,
   sched.admit and each gang.spawn, and the seconds from gang.spawn to the
   runner's first line (read off the member logs every 20 ms); Katib:
   (q7) BASELINE.json #4, `python -m kubeflow_tpu_torch.cli --home
   build/q7 run -f examples/torch/experiment-random-mnist.yaml` in its own
   process, started before (j) and running beside (j)-(l) and
   (m)/(n)'s child (its trials are mostly start-up, and those phases are
   host-bound), checked after (l): the Experiment Succeeded with 6 of 6
   trials succeeded and a `best trial:` line, every trial's runner_start
   line platform=cuda, currentOptimalTrial's accuracy the largest of the
   trials' final accuracy= lines, the Suggestion's requests 6, the seconds
   from apply to Succeeded; (q8) in (q)'s plane,
   examples/torch/darts-nas-experiment.yaml and enas-nas-experiment.yaml
   at their own sizes, one trial each: Succeeded, runner_start
   platform=cuda, arch_source=search with a genotype of `edges` names from
   OPS, the trial's val_acc finite and the Experiment's objective, ENAS's
   reward_mean= lines; beside each, a JAXJob of the same runner at the
   same budget with --arch=random --seed=1 (the reference test's random
   arm, random_genotype(.., seed=1)); the reference test's bars: searched
   val_acc > 0.8 and > the random arm's + 0.1. It prints an {"hpo": ...}
   line with each experiment's seconds and values. Once the plane has
   stopped, (s4) `python -m kubeflow_tpu_torch.cli --home <plane> trace
   jaxjob` of (s1)'s train step, as Chrome JSON and as the waterfall: the
   chain runner.init -> gang.spawn -> reconcile (the JAXJob's) ->
   reconcile (the Pipeline's) -> admission, and the runner's xla.compile
   and train.window spans under the same gang.spawn; it prints a
   {"pipelines": ...} line. The script's process runs no torch work
   during (q);
7. one JSON line per kernel set, the serving line, the engine line, the
   spec line, the training line, the classifier line, the int8 line, the
   chaos line, the lora line, the kv line, the weights line, the compat
   line, the ranks line, the plane line, the pipelines line, the hpo
   line, the profile line, the serving-tier line, each
   phase's seconds (m_beside, n_beside, j5_beside and beside_wall the child's,
   m_n_wait the wait for it after (l), q7_wait the wait for (q7) after
   that), the script's seconds, the card's
   name and power
   limit, and the
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
import urllib.error
import urllib.request

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

# Serving phase: the :generate request (8 prompts whose lengths are drawn
# from a seed in [64, 512], the longest 512, greedy, 64 new tokens: at 32
# the 8 no longer outgrow (f)'s small pool, which must preempt), the
# cache-vs-recompute check (prompts of 17, 64 and 100 tokens, 16 new) and
# its wide-gap weights (bench.py's _spec_benchable_params: lm_head tied to
# the embedding, attn.out and mlp.wo scaled by 0.35).
SERVE_BATCH = 8
SERVE_PROMPT = (64, 512)
SERVE_NEW = 64
GAP_PROMPTS = (17, 64, 100)
GAP_NEW = 16
GAP_ALPHA = 0.35
MIN_GAP = 1e-3      # top-1/top-2 logit gap required before comparing argmax

# Engine phase (f): the reference's engine defaults (8 slots, 8-step decode
# chunks, 32-token pages, prefix cache on, 256-token prefill chunks), and
# a small pool of one max-length request's pages (2048 / 32) that the 8
# prompts outgrow, so the engine must preempt.
ENGINE_SLOTS = 8
ENGINE_CHUNK = 8
ENGINE_PAGE = 32
ENGINE_PREFILL_CHUNK = 256
ENGINE_SMALL_POOL = 64
ENGINE_PROBE_STEP = 2   # the token whose logits the two paths compare
GAP_MARGIN = 10         # smallest argmax gap / measured logit disagreement

# Speculative phase (g): the reference's defaults (a draft of n_layers // 4
# layers, 4 proposals a window), and a draft pool too small for the
# prompts (8 pages of 32 tokens), so slots must degrade.
SPEC_TOKENS = 4
SPEC_SMALL_DRAFT_POOL = 8

# Training options (h): the base preset at full width, lm-small (S 2048).
# (h0) grads under each policy against no remat at 4 layers, batch 2;
# (h1)-(h4) the reference's long-context rungs (bench.py lm_long) through
# the runner and LMTrainLoop, 3 steps each.
TRAIN_STEPS = 3
TRAIN_ARGV = ["--preset", "base", "--dataset", "lm-small", "--steps",
              str(TRAIN_STEPS), "--warmup-steps", "1", "--log-every", "1"]
GRAD_LAYERS = 4
GRAD_BATCH = 2
GRAD_POLICIES = ("nothing", "save_flash", "save_flash_min",
                 "save_flash_full", "save_dense")
KEEPS_FLASH = ("save_flash", "save_flash_min", "save_flash_full")
TOL_REMAT_F32 = 1e-5   # remat vs no remat grads, f32, rel. to each max
LOSS_CHUNK = 256
MOE_EXPERTS = 8

# Two ranks share the one card over gloo (NCCL refuses two ranks on one
# card). (q6) the main path's runner command as a JAXJob whose
# spec.parallelism is {tensor: 2}. Its step-2 loss comes after the first
# update, whose learning rate is 0 (warmup 1), so only the order of the
# reductions differs from the main path's: held to 2e-3 relative. Steps
# 3-4 and the eval loss follow updates from grads whose bf16 partial sums
# were all-reduced in bf16: held to 1e-2 (the bar set before the first
# run; PERF.md has the measured values). (p2) spmd_check's variants at
# the base width, 4 layers, S 2048, f32 (flash on FMA), the four variants
# side by side (eight ranks, ~6 GB each), and dp2 with
# --collective-overlap on.
Q6_FIRST_RTOL = 2e-3
Q6_LATER_RTOL = 1e-2
P_TP_ELEMS = 4 * 2048 * 1024     # one tp all-reduce: [b, S, d]
P_TP_REPS = 10
P2_CONFIG = "base-l4"
P2_SIDE_BY_SIDE = 4

# Classifier phase (i): ResNet-50 through the JAXJob runner at the
# reference's own points (bench.py _bench_resnet50: the MPIJob config,
# cifar10 b256, and imagenet-sim 224^2 b64), then that 224^2 export behind
# the V1 server with JaxPredictor(max_batch_size=64): batch-1 :predict
# latency (BASELINE's "KFServing p50 latency") and a wave of 64 concurrent
# single-image requests with the micro-batcher (maxLatencyMs 5) and without.
CLS_POINTS = (("cifar10", 256), ("imagenet-sim", 64))
CLS_STEPS = 8
CLS_EVAL = 512
CLS_TOL_F32 = 1e-4     # forward on cuda vs CPU, f32, TF32 off, rel. to max
CLS_TOL_STATS = 1e-5   # BN running stats vs an explicit biased update, rel.
CLS_SEQ = 50
CLS_WAVE = 64
CLS_BATCHER_MS = 5.0

# int8 phase (j): the reference's bars (tests/test_generate.py
# TestQuantization, tests/test_engine.py TestInt8KV). (j0) w8 logits within
# 5% of the largest f32 |logit| and NLL within 2% over 2 x 512 tokens; the
# dequantized tree through the full-precision path within 1e-4 of the w8
# path (relative to the largest |logit|: full width in f32); (j1) greedy
# drift: first token equal, mean agreement >= 0.5; (j3) admission at the
# same pool bytes: 16 slots, 16 requests of 256 + 16 tokens, so the pool,
# not the slots, gates it; int8 >= 1.8x bf16.
INT8_SEQ = 512
INT8_TOL_LOGITS = 0.05
INT8_TOL_NLL = 0.02
INT8_TOL_DEQUANT = 1e-4
INT8_AGREE = 0.5
ADMIT_SLOTS = 16
ADMIT_PROMPT = 256
ADMIT_NEW = 16
INT8_ADMIT_RATIO = 1.8
# Depth cut to keep the script inside its time (PR 10): (j1)'s two warm
# repeats generate 16 tokens (the cold wave keeps 64), and (j5) times
# each mode's chunk without profiling it (PR 9's profiles stand in
# PERF.md).
INT8_WARM_NEW = 16
# Depth cuts that paid for phase (r): (m2)'s four generations take
# CUT_NEW greedy tokens a row, the (j4) served request and the (l5b)
# heal request INT8_WARM_NEW. And for (s1)'s serve step: (j1)'s
# cold :generate, (j4)'s int8-draft run, (k4)'s two requests and (k5)'s
# two runs take JK_NEW (each compared with the first JK_NEW of (f1)'s
# tokens, or at full length), and (l1)-(l3) LORA_NEW.
CUT_NEW = 32
JK_NEW = 16

# LoRA phase (l): the reference's multi-tenant leg (bench.py
# _bench_lm_adapters: 8 adapters in one engine, rank 8, random_lora_flat
# seeds 100 + i) at the base preset's full width; (l0) the fine-tuner at
# rank 8, alpha 16, batch 4, S 2048 on the main path's trained weights.
LORA_RANK = 8
LORA_ALPHA = 16.0
LORA_STEPS = 4
LORA_BATCH = 4
LORA_ADAPTERS = 8
LORA_NEW = 16          # greedy tokens a row in (l1)-(l3)
LORA_PAGED_SLOTS = 4   # (l2): 8 adapters over 4 slots
LORA_PAGED_NEW = 8

# KV transfer and request plane phase (m). (m0) engines run the bf16
# export's weights at max_seq_len RP_SEQ (16 pages of 32 tokens), so four
# requests of RP_NEW new tokens outgrow one engine's pool; (m1) migrates the
# 8 prompts of (a) after KV_MIGRATE_AFTER tokens with KV_MIGRATE_NEW new
# tokens each (the donor detaches one request an iteration boundary, so a
# longer run keeps all 8 decoding until their acknowledgements; the first
# SERVE_NEW are (f1)'s LMGenerator tokens), and one request of
# KV_LONG_PROMPT + SERVE_NEW tokens on the bf16 export; (m3)'s requests
# generate CHAOS_NEW tokens; (m2) hands HANDOFF_ROWS prompts from a prefill
# server to a decode server; (m4) pushes one prompt of OFFLOAD_PROMPT tokens
# to the host tier and back. Cut to hold the phase in 150 s: (m2) one
# prompt, (m3) 32 tokens; and, to hold the script under its limit once
# phase (o) came, the long request to 1024 tokens (was 2048). The migrated runs keep 192
# tokens: at 128 one of the 8 requests finished before its transfer.
RP_SEQ = 512
RP_NEW = 150
KV_MIGRATE_AFTER = 16
KV_MIGRATE_NEW = 192
KV_LONG_PROMPT = 960
HANDOFF_ROWS = 1
CHAOS_NEW = 32
OFFLOAD_PROMPT = 1024
OFFLOAD_NEW = 16

# Weight pool phase (n): three base-preset checkpoints over two weight
# slots (the pinned default and one swappable). m0 is (f1)'s wide-gap f32
# weights (seed 0) and m1 another seed's, both written as v1 f32 exports;
# m2 a third seed's, written as a v2 int8 export and normalized into the
# f32 pool at load. (n1) sends prompt i of (a) to m{i % 3}, POOL_NEW greedy
# tokens each, all at once.
POOL_SEEDS = (0, 1, 2)
POOL_SLOTS = 2
POOL_NEW = 16   # cut from 32 to hold the script under its limit

# Compat phase (o), the Kubeflow compat surface at the reference's own
# configs. (o1) BASELINE.json #5's KFServing predictor: phase (i)'s 224^2
# ResNet-50 export traced to TorchScript behind pytorch:, the canary of
# phase (r)'s InferenceService ((r2)); COMPAT_PARITY seeded images in a
# request against (i)'s JaxPredictor. The parity check
# (compat_parity) is sized to what it compares: the export is barely
# trained, so every probability is near 1/1000 and an absolute tolerance
# would pass zeros. Each row's probabilities agree within COMPAT_REL of
# the row's largest (the same bf16 convs, but cuDNN may pick another
# algorithm), each prediction is its own row's argmax, and the
# predictions are equal wherever the top-two gap exceeds twice the row's
# error (where the error cannot flip them).
# (o2) examples/pytorchjob-mnist.yaml's arguments, its workers started
# beside (q)'s jobs; (o3) examples/mpijob-resnet-cifar10.yaml's launcher
# command, through the plane as (q5) (each is mostly start-up; this holds
# the script under its limit).
# TensorFlow and scikit-learn are not on the card's machine, and their
# predictors and the TFJob worker run on the host in the reference too,
# so this phase drives none of them (the CPU tests do).
COMPAT_PARITY = 16
COMPAT_REL = 1e-2

# Serving-tier phase (r): BASELINE.json #5 as an InferenceService. (r1)
# sends R_SEQ batch-1 requests through status.url and R_SEQ straight to
# the replica's own port, in turns; (r2) sends R_CANARY_REQUESTS parity
# requests at canaryTrafficPercent 50, then R_SEQ batch-1 requests
# straight to the canary's replica; (r3) R_CLIENTS concurrent batch-1
# clients (targetConcurrency 1) until the killed replica is back, then
# R_AFTER_S more. R_SEQ is half of (i)'s CLS_SEQ, to hold the script
# inside its time budget (ROADMAP.md).
R_SEQ = 25
R_CANARY_REQUESTS = 6
R_CLIENTS = 8
R_AFTER_S = 1.0
PTJOB_ARGV = ["--dataset=mnist", "--steps=300", "--batch-size=128"]

# Control-plane phase (q): (q3) tests/test_chaos.py's crash story through
# the plane, as the reference's TestChaosSmoke runs it (the runner
# corrupts its second save, at step 20, and crashes there; the state file
# keeps the counts across the gang restart, so the rerun quarantines 20
# and resumes from 10).
Q3_ARGV = ["--model=mlp", "--dataset=mnist", "--steps=40", "--batch-size=64",
           "--log-every=10", "--checkpoint-every=10", "--keep-checkpoints=2",
           "--eval-samples=512"]
Q3_CHAOS = ("seed=7;state={state};runner.crash:after=1,count=1;"
            "checkpoint.save:mode=corrupt,after=1,count=1")
MPIJOB_ARGV = ["--model=resnet18", "--dataset=cifar10", "--steps=20",
               "--batch-size=64", "--log-every=10"]
# Katib: (q7) BASELINE.json #4, beside (j)-(l); (q8), in phase (q), the
# NAS examples, each beside a random arm of the same runner and budget
# (the reference test's random_genotype(.., seed=1)), held to the
# reference test's bars.
Q7_EXAMPLE = "experiment-random-mnist.yaml"
Q8_EXAMPLES = ("darts-nas-experiment.yaml", "enas-nas-experiment.yaml")
Q8_RANDOM_ARGV = ["--arch=random", "--seed=1"]
Q8_MIN_ACC = 0.8
Q8_MARGIN = 0.1
# Pipelines, platform and SLOs, in phase (q)'s plane: (s1) the
# train-then-serve example with (q2)'s train command, S1_NEW greedy tokens
# asked of its service twice; (s2) an SLO on that service; (s3) a Profile
# capping its namespace at one job, a PodDefault matching one of its two
# sleep jobs, the notebook example culled after S3_IDLE_S idle seconds.
S1_EXAMPLE = "lm-train-serve-pipeline.yaml"
S1_PROMPT = [[5, 9, 11, 3]]
S1_NEW = 16
S2_SLO = {"apiVersion": "obs.kubeflow.org/v1alpha1", "kind": "SLO",
          "metadata": {"name": "s2-lm-errors", "namespace": "default"},
          "spec": {"objective": "error-rate", "target": 0.99,
                   "windowSeconds": 60,
                   "selector": {"isvc": "lm-train-serve-serve"}}}
S3_NS = "s3-team"
S3_ENV = "KFX_S3_INJECTED"
S3_IDLE_S = 6
# The apiserver, kfctl and the profiler, in (q)'s wave: (t) a KfDef whose
# one application is the main path's LM as a JAXJob of T_STEPS steps
# (long enough to profile beside (q)'s jobs: ~0.25 s a step there),
# applied through `kfx server`; a T_PROFILE_MS trace of its worker.
T_PLATFORM = "t-platform"
T_NS = "t-team"
T_JOB = "t-lm"
T_LABELS = {"team": "t"}
T_STEPS = 40
T_PROFILE_MS = 2000
FLASH_SYMBOLS = {"flash_fwd": "flash_fwd_wgmma_kernel",
                 "flash_dq": "flash_dq_wgmma_kernel",
                 "flash_dkv": "flash_dkv_wgmma_kernel"}


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


def time_ms(torch, fn, reps: int, warmup: int = 2,
            span_ms: float = 2.0) -> float:
    """Per-call time of ``fn``: the median over ``reps`` CUDA-event pairs,
    each pair around N back-to-back calls (N doubled until a pair spans at
    least ``span_ms``), divided by N. One pair per call would count the
    wrapper's checks, allocation and ctypes launch into a ~0.1 ms
    kernel."""
    for _ in range(warmup):
        fn()

    def run(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    n = 1
    while run(n) < span_ms and n < 4096:
        n *= 2
    times = sorted(run(n) / n for _ in range(reps))
    return times[len(times) // 2]


def wgmma_ptxas_report(log_text: str) -> dict:
    """{"flash_fwd_wgmma_kernel<64>": (registers, spill store bytes), ...}
    from the build log's ptxas report of each wgmma kernel."""
    out = {}
    lines = log_text.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for \S*"
                      r"(flash_(?:fwd|dq|dkv)_wgmma_kernel)ILi(\d+)E", line)
        if m is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores", lines[i + 1])
        regs = re.search(r"Used (\d+) registers", lines[i + 2])
        out[f"{m.group(1)}<{m.group(2)}>"] = (
            int(regs.group(1)) if regs else None, int(spill.group(1)))
    return out


def bounds(B, S, H, D, elem):
    """Least time (ms) for each kernel's work: max(FLOPs / bf16 peak,
    bytes / HBM rate), counting each input read once and each output
    written once, over the causal half (the tiles the inputs need); with
    what bounds it and the FLOP count."""
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
                     "operations" if t_ops >= t_bytes else "bytes", flops)
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
        "flash_fwd": time_ms(torch, lambda: fa._fwd(q, k, v), 7),
        "flash_dq": time_ms(torch, lambda: fa._dq(
            q, k, v, do, lse_r, delta), 7),
        "flash_dkv": time_ms(torch, lambda: fa._dkv(
            q, k, v, do, lse_r, delta), 7),
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
    lib_fwd = time_ms(torch, lambda: sdpa(qt, kt, vt), 7)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    out = sdpa(qg, kg, vg)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), dot, retain_graph=True), 7)
    library_ms = {"flash_fwd": lib_fwd, "flash_dq": lib_bwd,
                  "flash_dkv": lib_bwd}
    bnd = bounds(B, S, H, D, q.element_size())
    recs = []
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        design = fa.design(dtype, D, name)
        tflops = bnd[name][2] / (ms[name] * 1e-3) / 1e12
        recs.append({
            "name": name, "design": design, "shape": list(shape),
            "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": errs[name][0], "max_err": errs[name][1],
            "ms": ms[name], "plain_ms": plain_ms[name],
            "library_ms": library_ms[name],
            "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
            "tflops": tflops,
        })
        log(f"kernel {name} ({design}) {tag} "
            f"max_abs_err={errs[name][0]:.3g} "
            f"max_err={errs[name][1]:.3g} ms={ms[name]:.4f} "
            f"plain_ms={plain_ms[name]:.4f} "
            f"library_ms={library_ms[name]:.4f} "
            f"bound_ms={bnd[name][0]:.4f} ({bnd[name][1]}) "
            f"tflops={tflops:.1f} "
            f"share_of_bound={bnd[name][0] / ms[name]:.3f}")
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


def main_path_phase(torch, fa, export_dir):
    from kubeflow_tpu_torch.models.transformer import preset_config
    from kubeflow_tpu_torch.runners import lm_runner
    from kubeflow_tpu_torch.utils.flops import (
        peak_flops_per_card, transformer_train_flops_per_token)

    buf = io.StringIO()
    fa.reset_launches()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = lm_runner.main(MAIN_ARGV + ["--export-dir", export_dir])
    launches = dict(fa.LAUNCHES)
    torch.cuda.synchronize()
    out = buf.getvalue()
    check(rc == 0, f"lm_runner returned {rc}")
    check(f"exported_lm dir={export_dir}" in out, "runner export line")
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
    return launches, step_time, {"losses": losses,
                                 "final": float(final.group(1)),
                                 "step_time": step_time}


def _grads(torch, model, tokens):
    """One CE forward and backward on ``tokens`` [B, S+1]: (loss, {name:
    grad}, seconds (synchronised), peak bytes allocated during it)."""
    import torch.nn.functional as F

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = model(tokens[:, :-1])
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))
    loss.backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, seconds, peak


def remat_grads_phase(torch, fa, dev):
    """(h0): at the base width, 4 layers, S 2048, attn flash, one backward
    under each remat policy against the no-remat grads of the same
    weights (held in f32, printed in bf16), with the flash launches, the
    time (one synchronised forward and backward, no optimizer step),
    tokens/s, MFU and peak memory of each; then loss_chunk against whole
    logits (f32: the loss and the lm_head grad held)."""
    from kubeflow_tpu_torch.models.transformer import (
        TransformerLM, preset_config)
    from kubeflow_tpu_torch.parallel.lm_train import (
        LMHyperParams, LMTrainLoop)
    from kubeflow_tpu_torch.utils.flops import (
        peak_flops_per_card, transformer_train_flops_per_token)

    L = GRAD_LAYERS
    g = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, 32_000, (GRAD_BATCH, 2049), device=dev,
                           generator=g)
    rec = {"layers": L, "batch": GRAD_BATCH, "seq_len": 2048}
    for dtype in ("float32", "bfloat16"):
        kw = dict(n_layers=L, max_seq_len=2048, vocab_size=32_000,
                  attn_impl="flash", dtype=dtype)
        cfg = preset_config("base", **kw)
        flops = transformer_train_flops_per_token(cfg, 2048) \
            * GRAD_BATCH * 2048
        model = TransformerLM(cfg, device=dev, generator=g)
        sd = model.state_dict()
        _grads(torch, model, tokens)   # warm
        fa.reset_launches()
        loss0, want, sec, peak = _grads(torch, model, tokens)
        del model
        errs = {}
        steps = {"none": {"ms": sec * 1e3, "peak_gb": peak / 1e9,
                          "launches": dict(fa.LAUNCHES)}}
        for policy in GRAD_POLICIES:
            model = TransformerLM(preset_config(
                "base", remat=True, remat_policy=policy, **kw), device=dev)
            model.load_state_dict(sd)
            fa.reset_launches()
            loss, got, sec, peak = _grads(torch, model, tokens)
            launches = dict(fa.LAUNCHES)
            fwd = L if policy in KEEPS_FLASH else 2 * L
            check(launches == {"flash_fwd": fwd, "flash_dq": L,
                               "flash_dkv": L},
                  f"(h0) {policy} {dtype} launches {launches}")
            errs[policy] = max(max_rel(got[n], want[n]) for n in want)
            if dtype == "float32":
                check(errs[policy] <= TOL_REMAT_F32,
                      f"(h0) {policy} f32 grads differ from no remat by "
                      f"{errs[policy]:.3g} > {TOL_REMAT_F32}")
            steps[policy] = {"ms": sec * 1e3, "peak_gb": peak / 1e9,
                             "launches": launches}
            del model, got
        for st in steps.values():
            st["tokens_per_s"] = GRAD_BATCH * 2048 / (st["ms"] / 1e3)
            st["mfu"] = flops / (st["ms"] / 1e3) / peak_flops_per_card()
        rec[dtype] = {"loss": loss0, "grad_max_rel_vs_no_remat": errs,
                      "fwd_bwd": steps}
        log(f"train (h0) base d=1024 L={L} S=2048 b={GRAD_BATCH} {dtype}: "
            f"grads under remat vs none, max rel "
            + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
            + f" (f32 tol {TOL_REMAT_F32}; bf16 reported); one forward "
            "and backward: " + "; ".join(
                f"{k} {v['ms']:.1f} ms, {v['tokens_per_s']:.0f} tokens/s, "
                f"MFU {v['mfu']:.4f}, peak {v['peak_gb']:.2f} GB, "
                f"launches {v['launches']['flash_fwd']}/"
                f"{v['launches']['flash_dq']}/{v['launches']['flash_dkv']}"
                for k, v in steps.items()))
        del want
        torch.cuda.empty_cache()
    # loss_chunk against whole logits, f32, on the same weights.
    out = {}
    sd = None
    for chunk in (0, LOSS_CHUNK):
        cfg = preset_config("base", n_layers=L, max_seq_len=2048,
                            vocab_size=32_000, attn_impl="flash",
                            dtype="float32", loss_chunk=chunk)
        loop = LMTrainLoop(cfg, LMHyperParams(seed=7), device=dev)
        loop.init_state(sd)
        sd = sd or loop.model.state_dict()
        loss, acc = loop._loss_fn(tokens)
        loss.backward()
        out[chunk] = (float(loss.detach()), float(acc),
                      loop.model.lm_head.kernel.grad.detach().clone())
        del loop
    (l0, a0, g0), (l1, a1, g1) = out[0], out[LOSS_CHUNK]
    e_loss, e_grad = abs(l1 - l0) / abs(l0), max_rel(g1, g0)
    check(e_loss <= TOL_REMAT_F32 and e_grad <= TOL_REMAT_F32,
          f"(h0) loss_chunk={LOSS_CHUNK} vs whole logits: loss rel "
          f"{e_loss:.3g}, lm_head grad rel {e_grad:.3g}")
    rec["loss_chunk"] = {"chunk": LOSS_CHUNK, "loss": l1, "loss_whole": l0,
                         "loss_rel": e_loss, "accuracy": a1,
                         "accuracy_whole": a0, "lm_head_grad_rel": e_grad}
    log(f"train (h0) f32 loss_chunk={LOSS_CHUNK} vs whole logits: loss "
        f"{l1:.6f} vs {l0:.6f} (rel {e_loss:.3g}), accuracy {a1} vs {a0}, "
        f"lm_head grad rel {e_grad:.3g} (tol {TOL_REMAT_F32})")
    del out, sd
    torch.cuda.empty_cache()
    return rec


def _train_record(torch, cfg, batch, step_times, launches, peak):
    """Step time (median of the timed steps), tokens/s, MFU (model FLOPs,
    recompute not credited) and peak memory of one training rung."""
    from kubeflow_tpu_torch.utils.flops import (
        peak_flops_per_card, transformer_train_flops_per_token)

    step = sorted(step_times)[len(step_times) // 2]
    tps = batch * 2048 / step
    return {"batch": batch, "step_s": step, "step_times": step_times,
            "tokens_per_s": tps,
            "mfu": tps * transformer_train_flops_per_token(cfg, 2048)
            / peak_flops_per_card(),
            "peak_memory_gb": peak / 1e9, "launches": launches}


def runner_rung(torch, fa, tag, argv, batch, fwd_per_layer):
    """Drive lm_runner with ``argv`` (3 steps and the eval batch), launch
    counters set to 0 just before and read just after; check the flash
    launches (``fwd_per_layer`` forwards a layer a step, one a layer for
    the eval, L dQ and dK/dV a step) and the losses."""
    from kubeflow_tpu_torch.models.transformer import preset_config
    from kubeflow_tpu_torch.runners import lm_runner

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    fa.reset_launches()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = lm_runner.main(TRAIN_ARGV + ["--batch-size", str(batch)]
                            + argv)
    launches = dict(fa.LAUNCHES)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = buf.getvalue()
    check(rc == 0, f"{tag}: lm_runner returned {rc}")
    losses = [float(x) for x in re.findall(r"^step=\d+ loss=(\S+)", out,
                                           re.M)]
    final = re.search(r"^loss=(\S+)$", out, re.M)
    check(final is not None and len(losses) == TRAIN_STEPS - 1,
          f"{tag}: runner output lacks the step/loss lines:\n{out}")
    check(all(math.isfinite(x) for x in losses + [float(final.group(1))]),
          f"{tag}: non-finite loss: {losses} {final.group(1)}")
    E = int(argv[argv.index("--experts") + 1]) if "--experts" in argv else 0
    check((f"/ep{E} " in out) == bool(E), f"{tag}: runner_start plan")
    cfg = preset_config("base", vocab_size=32_000, max_seq_len=2048,
                        n_experts=E)
    L = cfg.n_layers
    want = {"flash_fwd": fwd_per_layer * L * TRAIN_STEPS + L,
            "flash_dq": L * TRAIN_STEPS, "flash_dkv": L * TRAIN_STEPS}
    check(launches == want, f"{tag}: launches {launches} != {want}")
    times = [float(t) for t in re.findall(r"step_time=(\S+)", out)]
    rec = _train_record(torch, cfg, batch, times, launches, peak)
    rec["losses"] = losses
    rec["argv"] = argv
    rec["model_params"] = int(re.search(r"model_params=(\d+)", out)
                              .group(1))
    log(f"train {tag} base b={batch} {' '.join(argv)} "
        f"params={rec['model_params']}: step "
        f"{rec['step_s']:.4f} s, {rec['tokens_per_s']:.0f} tokens/s, MFU "
        f"{rec['mfu']:.4f}, peak {rec['peak_memory_gb']:.2f} GB, launches "
        f"{json.dumps(launches)}")
    return rec


def loss_chunk_rung(torch, fa, dev):
    """(h3): save_flash_min with loss_chunk=256 at b16 through
    LMTrainLoop, 3 steps; then the peak memory of one step with and
    without loss_chunk on the same batch."""
    from kubeflow_tpu_torch.data.lm import get_lm_dataset
    from kubeflow_tpu_torch.models.transformer import preset_config
    from kubeflow_tpu_torch.parallel.lm_train import (
        LMHyperParams, LMTrainLoop)

    B = 16
    ds = get_lm_dataset("lm-small", seed=0)
    batches = list(ds.batches(B, steps=TRAIN_STEPS))
    peaks = {}
    rec = None
    for chunk in (LOSS_CHUNK, 0):
        cfg = preset_config("base", vocab_size=ds.vocab_size,
                            max_seq_len=ds.seq_len, remat=True,
                            remat_policy="save_flash_min", loss_chunk=chunk)
        torch.cuda.empty_cache()
        loop = LMTrainLoop(cfg, LMHyperParams(warmup_steps=1,
                                              total_steps=TRAIN_STEPS),
                           device=dev)
        loop.init_state()
        L = cfg.n_layers
        if chunk:
            fa.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            first = loop.train_step(batches[0])
            times, losses = [], [first[0]]
            for b in batches[1:]:
                t0 = time.perf_counter()
                losses.append(loop.train_step(b)[0])
                times.append(time.perf_counter() - t0)
            launches = dict(fa.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            want = {"flash_fwd": L * TRAIN_STEPS,
                    "flash_dq": L * TRAIN_STEPS,
                    "flash_dkv": L * TRAIN_STEPS}
            check(launches == want, f"(h3) launches {launches} != {want}")
            check(all(math.isfinite(x) for x in losses),
                  f"(h3) non-finite loss {losses}")
            rec = _train_record(torch, cfg, B, times, launches, peak)
            rec["losses"] = losses
        # One step on the same batch, from a fresh peak.
        loop.train_step(batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loop.train_step(batches[0])
        torch.cuda.synchronize()
        peaks[chunk] = torch.cuda.max_memory_allocated() / 1e9
        del loop
    logits_gb = B * 2048 * 32_000 * 4 / 1e9
    rec["peak_gb_step"] = {"loss_chunk": peaks[LOSS_CHUNK],
                           "whole_logits": peaks[0]}
    rec["f32_logits_gb"] = logits_gb
    log(f"train (h3) base b={B} save_flash_min loss_chunk={LOSS_CHUNK}: "
        f"step {rec['step_s']:.4f} s, {rec['tokens_per_s']:.0f} tokens/s, "
        f"MFU {rec['mfu']:.4f}, peak {rec['peak_memory_gb']:.2f} GB, "
        f"launches {json.dumps(rec['launches'])}; one step's peak "
        f"{peaks[LOSS_CHUNK]:.2f} GB with loss_chunk, {peaks[0]:.2f} GB "
        f"with whole logits (f32 logits alone {logits_gb:.2f} GB)")
    return rec


def remat_cost_probe(torch, dev):
    """(h2b) what a remat policy costs a b8 step through LMTrainLoop, in
    one process on the same batches: no remat, full remat ("nothing", no
    dispatch mode), full remat through the selective-checkpoint dispatch
    mode with an empty save set ("save_names:", the same recompute plus
    a Python policy call per op) and save_flash_full. The four loops are
    built and warmed first, then stepped in turns, forward then reverse
    order, twice (the host drifts: turns keep a drift from reading as a
    policy's cost); each policy's median of its 4 steps, and one step
    each under torch.profiler (kernel time, kernels, busy share)."""
    from kubeflow_tpu_torch.data.lm import get_lm_dataset
    from kubeflow_tpu_torch.models.transformer import preset_config
    from kubeflow_tpu_torch.parallel.lm_train import (
        LMHyperParams, LMTrainLoop)

    ds = get_lm_dataset("lm-small", seed=0)
    batch = next(ds.batches(8))
    policies = (None, "nothing", "save_names:", "save_flash_full")
    loops = {}
    for policy in policies:
        kw = {} if policy is None else dict(remat=True, remat_policy=policy)
        cfg = preset_config("base", vocab_size=ds.vocab_size,
                            max_seq_len=ds.seq_len, **kw)
        loops[policy] = LMTrainLoop(cfg, LMHyperParams(warmup_steps=1),
                                    device=dev)
        loops[policy].init_state()
        loops[policy].train_step(batch)
    times = {p: [] for p in policies}
    for order in (policies, policies[::-1]) * 2:
        for policy in order:
            t0 = time.perf_counter()
            loops[policy].train_step(batch)
            times[policy].append(time.perf_counter() - t0)
    out = {}
    for policy in policies:
        step = sorted(times[policy])[len(times[policy]) // 2]
        prof = step_profile(torch, lambda: loops[policy].train_step(batch),
                            1)
        busy = prof.get("kernel_ms")
        out[str(policy)] = {"step_s": step, "step_times": times[policy],
                            "busy_share": busy / (step * 1e3) if busy
                            else None, **prof}
    del loops
    torch.cuda.empty_cache()
    log("train (h2b) b8 step by remat policy, in turns in one process: "
        + "; ".join(f"{k} {v['step_s']:.4f} s (of "
                    f"{[round(t, 4) for t in v['step_times']]}; kernels "
                    f"{v.get('kernel_ms', 0):.1f} ms, busy "
                    f"{v['busy_share'] or 0:.2f})" for k, v in out.items()))
    return out


def moe_aux_probe(torch, dev):
    """(h4)'s aux term: the runner's initial weights (same preset, seed
    and batch), one forward: CE, the layers' mean aux loss and the
    weighted term the loss adds."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.data.lm import get_lm_dataset
    from kubeflow_tpu_torch.models.transformer import (
        TransformerLM, preset_config)
    from kubeflow_tpu_torch.parallel.lm_train import LMHyperParams

    ds = get_lm_dataset("lm-small", seed=0)
    cfg = preset_config("base", vocab_size=ds.vocab_size,
                        max_seq_len=ds.seq_len, n_experts=MOE_EXPERTS)
    hp = LMHyperParams()
    model = TransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(hp.seed))
    tokens = torch.from_numpy(next(ds.batches(2))).to(dev, torch.long)
    aux = []
    with torch.no_grad():
        logits = model(tokens[:, :-1], aux_out=aux)
        ce = float(F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   tokens[:, 1:].reshape(-1)))
    mean_aux = float(torch.stack(aux).mean())
    check(len(aux) == cfg.n_layers and math.isfinite(mean_aux),
          f"(h4) aux {aux}")
    del model, logits
    torch.cuda.empty_cache()
    return {"ce": ce, "aux_mean": mean_aux,
            "aux_term": hp.moe_aux_weight * mean_aux}


def training_phase(torch, fa, dev):
    """(h0)-(h4): see the module docstring (5b)."""
    rec = {"grads": remat_grads_phase(torch, fa, dev)}
    rec["h1_full_remat"] = runner_rung(
        torch, fa, "(h1)", ["--remat", "--remat-policy", "nothing"], 8, 2)
    rec["h2_save_flash_full"] = runner_rung(
        torch, fa, "(h2)", ["--remat", "--remat-policy", "save_flash_full"],
        8, 1)
    rec["h2b_remat_cost"] = remat_cost_probe(torch, dev)
    rec["h3_save_flash_min_chunked"] = loss_chunk_rung(torch, fa, dev)
    rec["h4_moe"] = runner_rung(
        torch, fa, "(h4)", ["--experts", str(MOE_EXPERTS), "--remat",
                            "--remat-policy", "save_flash_full"], 4, 1)
    rec["h4_moe"]["aux"] = moe_aux_probe(torch, dev)
    log(f"train (h4) aux: CE {rec['h4_moe']['aux']['ce']:.6f}, mean aux "
        f"{rec['h4_moe']['aux']['aux_mean']:.6f}, term "
        f"{rec['h4_moe']['aux']['aux_term']:.6f}")
    return rec


def http_json(url, payload=None, timeout=600, with_headers=False):
    """GET (or POST ``payload``) and decode a JSON answer; text otherwise
    (with the response headers too when ``with_headers``)."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
        headers = r.headers
        ctype = headers.get("Content-Type", "")
    out = json.loads(body) if ctype == "application/json" else body.decode()
    return (out, headers) if with_headers else out


def sse_tokens(url, payload, timeout=600):
    """The tokens of one ``"stream": true`` :generate, in event order."""
    req = urllib.request.Request(url, data=json.dumps(
        dict(payload, stream=True)).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        ctype = r.headers.get("Content-Type")
        raw = r.read().decode()
    check(ctype == "text/event-stream", f"SSE content type {ctype}")
    events = [json.loads(line[len("data: "):]) for line in raw.splitlines()
              if line.startswith("data: ")]
    check(bool(events) and events[-1].get("done") is True,
          f"SSE stream did not finish: {events[-1:]}")
    return [e["token"] for e in events[:-1]]


def wide_gap_(torch, model, alpha=GAP_ALPHA):
    """bench.py's _spec_benchable_params on a port model, in place: the
    lm_head tied to the embedding, the residual projections scaled."""
    with torch.no_grad():
        model.lm_head.kernel.copy_(model.embed.embedding.T)
        for layer in model.layers:
            layer.attn.out.kernel.mul_(alpha)
            layer.mlp.wo.kernel.mul_(alpha)


def recompute_greedy(torch, model, prompt, n):
    """Greedy tokens by a full no-cache forward over the growing sequence,
    and the smallest top-1/top-2 logit gap on the path."""
    toks = torch.tensor([prompt], device=model.embed.embedding.device)
    out, gap = [], math.inf
    with torch.inference_mode():
        for _ in range(n):
            last = model(toks)[0, -1]
            top2 = torch.topk(last, 2).values
            gap = min(gap, float(top2[0] - top2[1]))
            nxt = torch.argmax(last)
            out.append(int(nxt))
            toks = torch.cat([toks, nxt.view(1, 1)], 1)
    return out, gap


def decode_bound(cfg, n_weights, B):
    """Least time (ms) of one decode step at batch B: the weights in bf16
    (every param but the embedding table, of which a step reads B rows)
    read once plus the dense K/V cache (max_seq_len slots a row, bf16)
    read once, over the HBM rate; or the step's operations over the bf16
    peak if that is longer. With what bounds it and the bytes."""
    L, H, D = cfg.max_seq_len, cfg.n_heads, cfg.head_dim
    cache = B * L * H * D * 2 * 2 * cfg.n_layers
    nbytes = 2 * n_weights + cache
    flops = 2 * n_weights * B + 4 * B * H * D * L * cfg.n_layers
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / PEAK_BF16 * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def event_ms(torch, fn, reps):
    """Median over ``reps`` CUDA-event pairs, one pair around each call."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def step_profile(torch, fn, n):
    """torch.profiler over ``n`` calls of ``fn``, per call: the kernel time
    (ms) and the number of kernels, the five kernels with the most device
    time and the five ops with the most host (self CPU) time; {"note":
    reason} where it records no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:  # the profiler is untried on that machine
        return {"note": f"profiler failed: {e}"}
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    kern = [e for e in events if getattr(e, "device_type", None) == cuda]
    us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in kern)
    if us <= 0:
        return {"note": "profiler recorded no device time"}
    host = sorted((e for e in events
                   if getattr(e, "device_type", None) != cuda),
                  key=lambda e: -e.self_cpu_time_total)[:5]
    top = sorted(kern, key=lambda e: -(getattr(
        e, "self_device_time_total", 0) or 0))[:5]
    return {"kernel_ms": us / 1e3 / n,
            "kernels": sum(e.count for e in kern) / n,
            "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3
                                / n, e.count / n] for e in top],
            "top_host_ops_ms": [[e.key, e.self_cpu_time_total / 1e3 / n]
                                for e in host]}


def decode_timings(torch, gen, B, pad, steps, seed):
    """On ``gen``'s model: the prefill of a B x pad bucket (ms, median of
    3), then one-token decode steps at batch B (ms, median over ``steps``
    after 4 warm ones), the host's enqueue time of a step, and a profile
    of 8 steps (step_profile)."""
    from kubeflow_tpu_torch.models.transformer import KVCache

    cfg, dev = gen.cfg, gen.device
    g = torch.Generator(device=dev).manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (B, pad), device=dev, generator=g)
    pos = torch.arange(pad, device=dev, dtype=torch.int32).expand(B, pad)
    with torch.inference_mode():
        caches = iter([KVCache.allocate(cfg, B, dev) for _ in range(4)])
        gen.model(tok, pos, next(caches))
        prefill = event_ms(torch, lambda: gen.model(tok, pos, next(caches)),
                           3)
        cache = KVCache.allocate(cfg, B, dev)
        gen.model(tok, pos, cache)
        t = tok[:, :1]
        cur = torch.full((B, 1), pad, device=dev, dtype=torch.int32)

        def step():
            gen.model(t, cur, cache)
            cur.add_(1)

        for _ in range(4):
            step()
        step_ms = event_ms(torch, step, steps)
        # Host time to enqueue a step (no synchronize inside): near the
        # step time, the loop is bound by the host, not the card.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(8):
            step()
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / 8
        torch.cuda.synchronize()
        prof = step_profile(torch, step, 8)
    return prefill, step_ms, enqueue_ms, prof


def serve_prompts(vocab_size):
    """Phase (a)'s 8 seeded prompts, 64-512 tokens (the longest 512)."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_BATCH)
    lens[int(np.argmax(lens))] = SERVE_PROMPT[1]
    return [rng.integers(0, vocab_size, int(n)).tolist() for n in lens]


def serving_phase(torch, fa, export_dir, gap_cfg, dev):
    """Serve the main path's export on ``dev`` (the card); see the module
    docstring (6). ``gap_cfg`` is the configuration of the
    cache-vs-recompute check. Returns the {"serving": ...} record."""
    import numpy as np

    from kubeflow_tpu_torch.models.generate import LMGenerator
    from kubeflow_tpu_torch.models.transformer import TransformerLM
    from kubeflow_tpu_torch.serving.lm_server import LMPredictor, load_lm
    from kubeflow_tpu_torch.serving.server import ModelServer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    rec = {}

    # (a) train -> export -> serve
    t0 = time.perf_counter()
    cfg, params = load_lm(export_dir)
    direct = LMGenerator(cfg, params, device=dev)
    torch.cuda.synchronize()
    rec["load_seconds"] = time.perf_counter() - t0
    del params
    rec["export"] = {k: getattr(cfg, k) for k in (
        "d_model", "n_heads", "head_dim", "n_layers", "d_ff", "vocab_size",
        "max_seq_len")}
    rec["export"]["dtype"] = str(cfg.dtype).replace("torch.", "")
    rec["export"]["param_dtype"] = str(cfg.param_dtype).replace("torch.", "")
    # The one-shot path, pinned: the engine is the default.
    os.environ["KFX_LM_ENGINE"] = "0"
    try:
        pred = LMPredictor(export_dir, name="lm", device=dev.type)
    finally:
        del os.environ["KFX_LM_ENGINE"]
    check(pred.engine is None, "phase (a) is not on the one-shot path")
    t0 = time.perf_counter()
    pred.load()
    rec["predictor_load_seconds"] = time.perf_counter() - t0
    server = ModelServer(port=0)
    server.register(pred)
    server.start()
    prompts = serve_prompts(cfg.vocab_size)
    try:
        url = f"http://127.0.0.1:{server.port}"
        gen_url = f"{url}/v1/models/lm:generate"
        check(http_json(f"{url}/v1/models/lm") == {"name": "lm",
                                                   "ready": True},
              "model not ready")
        t0 = time.perf_counter()
        body = http_json(gen_url, {"prompt_tokens": prompts,
                                   "max_new_tokens": SERVE_NEW})
        rec["http_seconds"] = time.perf_counter() - t0
        toks = body["generated_tokens"]
        check(len(toks) == SERVE_BATCH
              and all(len(row) == SERVE_NEW for row in toks)
              and all(0 <= x < cfg.vocab_size for row in toks for x in row),
              f"generated_tokens shape/range: {[len(r) for r in toks]}")
        want = direct.generate(prompts, SERVE_NEW)
        bad = [i for i, (a, b) in enumerate(zip(toks, want)) if a != b]
        check(not bad, f"HTTP tokens differ from LMGenerator in rows {bad}")
        one = {"prompt_tokens": [prompts[0]], "max_new_tokens": SERVE_NEW}
        buffered = http_json(gen_url, one)["generated_tokens"][0]
        check(sse_tokens(gen_url, one) == buffered,
              "SSE stream differs from the buffered answer")
        metrics = http_json(f"{url}/metrics")
        for fam in ("kfx_lm_generated_tokens_total",
                    "kfx_serving_requests_total"):
            check(fam in metrics, f"/metrics lacks {fam}")
    finally:
        server.stop()
    rec["http_tokens_per_second"] = body["tokens_per_second"]
    rec["prompt_lengths"] = [len(p) for p in prompts]
    log(f"serving (a) export {rec['export']} loaded in "
        f"{rec['load_seconds']:.2f} s; HTTP :generate {SERVE_BATCH}x"
        f"{SERVE_NEW} greedy in {rec['http_seconds']:.3f} s "
        f"({rec['http_tokens_per_second']} tokens/s) == LMGenerator; SSE "
        f"== buffered; /metrics ok")
    del pred, server

    # (b) cache decode against full recompute, wide-gap weights, f32
    g = torch.Generator(device=dev).manual_seed(0)
    model = TransformerLM(gap_cfg, device=dev, generator=g)
    wide_gap_(torch, model)
    model.eval()
    gen32 = LMGenerator(gap_cfg, model.state_dict(), device=dev)
    gp = [torch.randint(0, gap_cfg.vocab_size, (n,), device=dev,
                        generator=g).tolist() for n in GAP_PROMPTS]
    got = gen32.generate(gp, GAP_NEW)
    min_gap = math.inf
    for p, row in zip(gp, got):
        want, gap = recompute_greedy(torch, model, p, GAP_NEW)
        min_gap = min(min_gap, gap)
        check(gap > MIN_GAP, f"argmax gap {gap:.3g} too small to compare")
        check(row == want, f"cache decode {row} != recompute {want}")
    rec["cache_vs_recompute_min_gap"] = min_gap
    log(f"serving (b) {gap_cfg.dtype} d={gap_cfg.d_model} "
        f"L={gap_cfg.n_layers} cache decode == full recompute for prompts "
        f"{list(GAP_PROMPTS)} x {GAP_NEW} new; smallest top-1/top-2 gap "
        f"{min_gap:.4g}")

    # (c) sampling
    kw = dict(max_new_tokens=GAP_NEW, temperature=1.0)
    a = gen32.generate(gp[:1], seed=7, **kw)
    check(a == gen32.generate(gp[:1], seed=7, **kw), "seeded sampling")
    check(gen32.generate(gp[:1], top_k=1, seed=8, **kw)
          == gen32.generate(gp[:1], GAP_NEW), "top_k=1 != greedy")
    log("serving (c) same seed twice identical; top_k=1 == greedy")
    del model, gen32

    # (e) times
    n_weights = sum(p.numel() for n, p in direct.model.named_parameters()
                    if n != "embed.embedding")
    decode = {}
    for B in (1, SERVE_BATCH):
        prefill, step_ms, enqueue_ms, prof = decode_timings(
            torch, direct, B, SERVE_PROMPT[1], 32, seed=B)
        bound, by, nbytes = decode_bound(cfg, n_weights, B)
        busy = prof.get("kernel_ms")
        decode[str(B)] = {
            "prefill_ms": prefill, "step_ms": step_ms, "bound_ms": bound,
            "bound_by": by, "bound_bytes": nbytes,
            "share_of_bound": bound / step_ms,
            "tokens_per_s": B * 1e3 / step_ms,
            "host_enqueue_ms": enqueue_ms,
            "busy_share": busy / step_ms if busy else None, **prof}
        log(f"serving (e) batch {B}: prefill {B}x{SERVE_PROMPT[1]} "
            f"{prefill:.3f} ms; decode step {step_ms:.3f} ms (host enqueue "
            f"{enqueue_ms:.3f} ms), bound {bound:.3f} ms ({by}), share "
            f"{bound / step_ms:.4f}, {B * 1e3 / step_ms:.1f} tokens/s; "
            f"profile {json.dumps(prof)}")
    rec["decode"] = decode
    rec["prefill_ms_b8_s512"] = decode[str(SERVE_BATCH)]["prefill_ms"]
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    launches_all = dict(fa.LAUNCHES)
    check(all(v == 0 for v in launches_all.values()),
          f"flash kernels launched while serving: {launches_all}")
    rec["flash_launches"] = launches_all
    log(f"serving (d) flash launches {launches_all}; peak memory "
        f"{rec['peak_memory_gb']:.2f} GB")
    return rec, prompts


def run_threads(fn, items, timeout=600):
    """``fn(item)`` for every item, one thread each, started together;
    the results in item order. Any thread's exception fails the call."""
    import threading

    out, errs = [None] * len(items), []

    def run(i):
        try:
            out[i] = fn(items[i])
        except BaseException as e:  # re-raised on the calling thread
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    check(not any(t.is_alive() for t in threads), "a request thread hung")
    if errs:
        raise errs[0]
    return out


def sse_first(url, payload, t_start, timeout=600):
    """One ``"stream": true`` :generate read event by event: (tokens,
    seconds from ``t_start`` to the first token event)."""
    req = urllib.request.Request(url, data=json.dumps(
        dict(payload, stream=True)).encode())
    toks, first, done = [], None, False
    with urllib.request.urlopen(req, timeout=timeout) as r:
        check(r.headers.get("Content-Type") == "text/event-stream",
              "SSE content type")
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            ev = json.loads(line[len("data: "):])
            if ev.get("done"):
                done = True
                break
            check("token" in ev, f"SSE error event {ev}")
            if first is None:
                first = time.perf_counter() - t_start
            toks.append(ev["token"])
    check(done, "SSE stream did not finish")
    return toks, first


def greedy_with_gap(gen, prompts, n, probe_step):
    """``gen.generate(prompts, n)`` greedy; the smallest top-1/top-2 logit
    gap over every row of every step it sampled from; and the [B, V]
    logits it sampled token ``probe_step`` from."""
    from kubeflow_tpu_torch.models import generate as gen_mod

    gaps, seen, real = [], [], gen_mod._sample

    def spy(logits, *a):
        top2 = logits.topk(2, dim=-1).values
        gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
        if len(seen) == probe_step:
            seen.append(logits.clone())
        elif len(seen) < probe_step:
            seen.append(None)
        return real(logits, *a)

    gen_mod._sample = spy
    try:
        toks = gen.generate(prompts, n)
    finally:
        gen_mod._sample = real
    return toks, min(gaps[:n]), seen[probe_step]


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


def engine_phase(torch, fa, export_dir, gap_cfg, prompts, dev):
    """The DecodeEngine, the default serving path; see the module
    docstring (6f). Returns the {"engine": ...} record."""
    from kubeflow_tpu_torch.models.generate import LMGenerator
    from kubeflow_tpu_torch.models.transformer import TransformerLM
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.lm_server import LMPredictor
    from kubeflow_tpu_torch.serving.server import ModelServer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    rec = {"slots": ENGINE_SLOTS, "chunk_tokens": ENGINE_CHUNK,
           "page": ENGINE_PAGE, "prefill_chunk": ENGINE_PREFILL_CHUNK,
           "new_tokens": SERVE_NEW}
    kw = dict(n_slots=ENGINE_SLOTS, chunk_tokens=ENGINE_CHUNK,
              kv_page_size=ENGINE_PAGE,
              prefill_chunk_tokens=ENGINE_PREFILL_CHUNK, device=dev)

    # (f1) greedy equality, prefix cache, preemption: wide-gap f32 weights.
    # 512 greedy decisions at full width reach closer ties than (b)'s 48,
    # so the gap is held against the two paths' measured disagreement:
    # the logits each samples token ENGINE_PROBE_STEP from (the engine's
    # are its logits buffer after a request of that many tokens: a paged
    # prefill and decode steps through the block tables at 8 slots).
    g = torch.Generator(device=dev).manual_seed(0)
    model = TransformerLM(gap_cfg, device=dev, generator=g)
    wide_gap_(torch, model)
    sd = model.state_dict()
    gen32 = LMGenerator(gap_cfg, sd, device=dev)
    want, gap, ref_logits = greedy_with_gap(gen32, prompts, SERVE_NEW,
                                            ENGINE_PROBE_STEP)
    probe = DecodeEngine(gap_cfg, sd, name="f32-probe", prefix_cache=False,
                         **kw)
    try:
        probe.generate(prompts, ENGINE_PROBE_STEP)
        diff = max_abs(probe._logbuf[:len(prompts)], ref_logits)
    finally:
        probe.close()
    rec["min_gap"], rec["logits_max_abs_diff"] = gap, diff
    check(gap > GAP_MARGIN * diff,
          f"argmax gap {gap:.3g} too small against the paths' logit "
          f"disagreement {diff:.3g}")
    eng = DecodeEngine(gap_cfg, sd, name="f32", **kw)
    try:
        got = eng.generate(prompts, SERVE_NEW)
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        check(not bad, f"engine greedy tokens differ from LMGenerator in "
                       f"rows {bad}")
        i512 = max(range(len(prompts)), key=lambda i: len(prompts[i]))
        hits0 = eng.prefix_stats()["hits"]
        again = eng.generate([prompts[i512]], SERVE_NEW)[0]
        st = eng.prefix_stats()
        check(st["hits"] > hits0, f"no prefix-cache hit: {st}")
        check(again == want[i512], "prefix-hit tokens changed")
        pages = eng.page_stats()
        check(pages["free"] + pages["cached"] == pages["pages"],
              f"page leak: {pages}")
        rec["prefix"] = dict(st, repeat_prompt=len(prompts[i512]))
    finally:
        eng.close()
    small = DecodeEngine(gap_cfg, sd, name="f32-small",
                         kv_pages=ENGINE_SMALL_POOL, **kw)
    try:
        got = small.generate(prompts, SERVE_NEW)
        pages = small.page_stats()
        check(got == want, "tokens changed under preemption")
        check(pages["preemptions"] >= 1, f"no preemption: {pages}")
        check(pages["free"] + pages["cached"] == pages["pages"],
              f"page leak after preemption: {pages}")
        rec["preemption"] = pages
    finally:
        small.close()
    log(f"engine (f1) f32 d={gap_cfg.d_model} L={gap_cfg.n_layers} greedy "
        f"== LMGenerator for {len(prompts)} x {SERVE_NEW} (smallest "
        f"top-1/top-2 gap {gap:.4g}, logits of the two paths within "
        f"{diff:.3g}); prefix {rec['prefix']}; pool of "
        f"{ENGINE_SMALL_POOL} pages: {pages}, tokens unchanged")
    del model, sd, gen32
    torch.cuda.empty_cache()

    # (f2) the base export behind an engine-backed server, 8 concurrent
    # single-prompt requests; then the one-shot path one after another.
    n_tok = len(prompts) * SERVE_NEW
    os.environ["KFX_LM_SPEC"] = "0"   # this phase's engine has no draft
    try:
        pred = LMPredictor(export_dir, name="lm", device=dev.type)
    finally:
        del os.environ["KFX_LM_SPEC"]
    check(pred.engine is None and pred.use_engine, "engine not the default")
    pred.load()
    check(not pred.engine.spec, "phase (f) engine speculates")
    pred._warm_thread.join(600)
    server = ModelServer(port=0)
    server.register(pred)
    server.start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        gen_url = f"{url}/v1/models/lm:generate"
        one = lambda p: {"prompt_tokens": [p], "max_new_tokens": SERVE_NEW}

        def sse_wave():
            t0 = time.perf_counter()
            out = run_threads(lambda p: sse_first(gen_url, one(p), t0),
                              prompts)
            return out, time.perf_counter() - t0

        # The timed wave: cold (no prompt cached yet), streamed, so each
        # request's first token event gives its TTFT.
        chunks = pred.metrics.counter("kfx_lm_engine_chunks_total")
        n0 = sum(v for _, v in chunks.samples())
        streams, wall = sse_wave()
        rec["wave_chunks"] = sum(v for _, v in chunks.samples()) - n0
        first = [s[0] for s in streams]
        ttft = [s[1] for s in streams]
        check(all(len(t) == SERVE_NEW for t in first),
              f"engine answers {[len(t) for t in first]}")
        # SSE against buffered in one cache state: after the first wave
        # every prompt hits the prefix cache, and in bf16 a prefill of the
        # uncached tail alone rounds differently from the whole prompt's.
        bodies = run_threads(lambda p: http_json(gen_url, one(p)), prompts)
        buffered = [b["generated_tokens"][0] for b in bodies]
        again, sse_wall = sse_wave()
        check([s[0] for s in again] == buffered,
              "SSE streams differ from the buffered answers")
        blk = http_json(f"{url}/metrics?format=json")["engine"]["lm"]
        check(blk["slots"] == ENGINE_SLOTS, f"engine block {blk}")
        check(http_json(f"{url}/healthz") == {"status": "alive"},
              "healthz")
        rec["flight"] = flight_http_checks(url, gen_url, one(prompts[0]),
                                           len(prompts))
    finally:
        server.stop()
    eng = pred.engine
    eng.close()
    rec["engine_tokens_per_second"] = n_tok / wall
    rec["engine_seconds"] = wall
    rec["sse_seconds"] = sse_wall
    rec["ttft_s"] = {"p50": percentile(ttft, 0.5),
                     "p99": percentile(ttft, 0.99), "all": ttft}
    os.environ["KFX_LM_ENGINE"] = "0"
    try:
        oneshot = LMPredictor(export_dir, name="lm", device=dev.type)
    finally:
        del os.environ["KFX_LM_ENGINE"]
    oneshot.load()
    server = ModelServer(port=0)
    server.register(oneshot)
    server.start()
    try:
        gen_url = f"http://127.0.0.1:{server.port}/v1/models/lm:generate"
        serial, each = [], []
        for p in prompts:
            t0 = time.perf_counter()
            serial.append(http_json(gen_url, one(p))["generated_tokens"][0])
            each.append(time.perf_counter() - t0)
        serial_wall = sum(each)
    finally:
        server.stop()
    del oneshot
    rec["oneshot_tokens_per_second"] = n_tok / serial_wall
    rec["oneshot_seconds"] = serial_wall
    rec["oneshot_request_seconds"] = each
    rec["ratio"] = rec["engine_tokens_per_second"] / \
        rec["oneshot_tokens_per_second"]
    # bf16 on trained random weights: equality is informative only (the
    # f32 wide-gap check above is the held one).
    rec["rows_equal_oneshot_bf16"] = sum(
        a == b for a, b in zip(first, serial))
    rec["rows_equal_cold_warm_bf16"] = sum(
        a == b for a, b in zip(first, buffered))
    log(f"engine (f2) {len(prompts)} concurrent HTTP x {SERVE_NEW}: "
        f"{wall:.3f} s, {rec['engine_tokens_per_second']:.1f} tokens/s; "
        f"SSE == buffered (warm cache, {sse_wall:.3f} s); one-shot one "
        f"after another {serial_wall:.3f} s, "
        f"{rec['oneshot_tokens_per_second']:.1f} tokens/s; ratio "
        f"{rec['ratio']:.2f}; TTFT p50 {rec['ttft_s']['p50']:.3f} s p99 "
        f"{rec['ttft_s']['p99']:.3f} s")

    # (f3) the decode chunk at 8 active slots, driven by hand on the
    # stopped engine: 8 of the prompts admitted whole, each with a budget
    # of a quarter of the cache (512 tokens) so no slot retires.
    with torch.inference_mode():
        eng._cache.pos.fill_(-1)
        eng.prefill_chunk_tokens = 0
        budget = eng.cfg.max_seq_len // 4
        for slot, p in enumerate(prompts[:ENGINE_SLOTS]):
            eng._admit(eng._make_request(p, budget, 0.0, 0, 0, None), slot)

        def chunk():
            eng._ensure_chunk_pages()
            eng._decode_chunk()

        chunk()
        chunk()
        check(int(eng._active.sum()) == ENGINE_SLOTS, "slots not active")
        rec["flight"].update(flight_cost(torch, eng))
        chunk_ms = event_ms(torch, chunk, 5)
        enq = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            packed = eng._chunk_launch()
            enq.append((time.perf_counter() - t0) * 1e3)
            eng._chunk_collect(packed)
        prof = step_profile(torch, chunk, 1)
    cfg = eng.cfg
    n_weights = sum(p.numel() for n, p in eng.model.named_parameters()
                    if n != "embed.embedding")
    bound, by, nbytes = decode_bound(cfg, n_weights, ENGINE_SLOTS)
    # The plain paged attention materialises each row's gathered [L] K/V
    # view (written, then read by the products) in every layer.
    gathered = (2 * ENGINE_SLOTS * cfg.max_seq_len * cfg.n_heads
                * cfg.head_dim * 2 * cfg.n_layers)
    step_ms = chunk_ms / ENGINE_CHUNK
    busy = prof.get("kernel_ms")
    rec["chunk"] = {
        "chunk_ms": chunk_ms, "step_ms": step_ms,
        "ms_per_token": step_ms / ENGINE_SLOTS,
        "tokens_per_s": ENGINE_SLOTS * 1e3 / step_ms,
        "step_bound_ms": bound, "step_bound_by": by,
        "step_bound_bytes": nbytes,
        "gathered_bytes": 2 * gathered,
        "step_bound_with_gather_ms":
            (nbytes + 2 * gathered) / HBM_BYTES_S * 1e3,
        "share_of_bound": bound / step_ms,
        "host_enqueue_ms": sorted(enq)[1],
        "busy_share": busy / chunk_ms if busy else None, **prof}
    rec["pool_bytes"] = eng.pool_bytes
    rec["kv_bytes_per_token"] = eng.kv_bytes_per_token
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(fa.LAUNCHES)
    check(all(v == 0 for v in launches.values()),
          f"flash kernels launched by the engine: {launches}")
    rec["flash_launches"] = launches
    rec["_f1"] = {"want": want, "gap": gap, "diff": diff,
                  "ref_logits": ref_logits}
    rec["_f2_tokens"] = first
    log(f"engine (f3) decode chunk at {ENGINE_SLOTS} slots: {chunk_ms:.2f} "
        f"ms for {ENGINE_CHUNK} steps ({step_ms:.3f} ms a step, bound "
        f"{bound:.3f} ms ({by}), "
        f"{rec['chunk']['step_bound_with_gather_ms']:.3f} ms with the "
        f"gathered views); host enqueue "
        f"{rec['chunk']['host_enqueue_ms']:.2f} ms; profile "
        f"{json.dumps(prof)}; pool {eng.pool_bytes / 1e9:.3f} GB; peak "
        f"{rec['peak_memory_gb']:.2f} GB; flash launches {launches}")
    return rec

def flight_http_checks(url, gen_url, body, wave):
    """(h5) on the engine phase's server after its waves: /debug/flight
    holds iteration records, /debug/requests the waves' requests with
    admit ... first_token ... retire trails, and a :generate answer
    carries the timing block and the X-Kfx-Timing header."""
    flight = http_json(f"{url}/debug/flight")["models"]["lm"]
    reqs = http_json(f"{url}/debug/requests")["models"]["lm"]["requests"]
    check(len(flight["records"]) > 0, "(h5) no flight records")
    check(len(reqs) >= wave, f"(h5) {len(reqs)} retired requests")
    for r in reqs[-wave:]:
        names = [e["ev"] for e in r["events"]]
        check(names[0] == "admit" and names[-1] == "retire"
              and "first_token" in names and r["error"] is None,
              f"(h5) request trail {names}")
    out, headers = http_json(gen_url, body, with_headers=True)
    timing = out.get("timing") or [{}]
    hdr = headers.get("X-Kfx-Timing") or ""
    check(set(timing[0]) == {"queue_wait_s", "prefill_s", "decode_s",
                             "stalled_s", "spec_accept"},
          f"(h5) timing block {out.get('timing')}")
    check("decode_s=" in hdr, f"(h5) X-Kfx-Timing {hdr!r}")
    rec = {"records": len(flight["records"]),
           "ring_size": flight["ring_size"], "requests": len(reqs),
           "timing": timing[0], "header": hdr}
    log(f"flight (h5) /debug/flight {rec['records']} records, "
        f"/debug/requests {rec['requests']} requests (trails admit .. "
        f"first_token .. retire), X-Kfx-Timing: {hdr}")
    return rec


def flight_cost(torch, eng):
    """(h5) on the stopped engine with 8 active slots: the iteration (a
    decode chunk through _decode_once, which reads its result back) with
    the recorder off (``flight`` None, what KFX_FLIGHT=0 builds) and on
    (its hooks plus _record_flight), in turns off, on, on, off; the
    record alone; and the record run under CUDA's sync-debug mode set to
    "error", which raises if it synchronises the device."""
    recorder = eng.flight
    check(recorder is not None, "(h5) the engine has no flight recorder")

    def iteration(on):
        eng.flight = recorder if on else None
        try:
            eng._decode_once()
            if on:
                eng._record_flight()
        finally:
            eng.flight = recorder

    iteration(True)   # warm
    times = {False: [], True: []}
    for on in (False, True, True, False):
        times[on].append(event_ms(torch, lambda: iteration(on), 3))
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._record_flight()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rec_us = []
    for _ in range(50):
        t0 = time.perf_counter()
        eng._record_flight()
        rec_us.append((time.perf_counter() - t0) * 1e6)
    check(int(eng._active.sum()) == ENGINE_SLOTS, "(h5) slots retired")
    off, on = (sum(times[k]) / 2 for k in (False, True))
    out = {"chunk_ms_flight_off": times[False], "chunk_ms_flight_on":
           times[True], "record_us": sorted(rec_us)[25],
           "record_syncs": 0}
    log(f"flight (h5) iteration at {ENGINE_SLOTS} slots: recorder off "
        f"{times[False]} ms, on {times[True]} ms (means {off:.2f} vs "
        f"{on:.2f}); _record_flight {out['record_us']:.1f} us, no device "
        f"sync (sync-debug mode 'error')")
    return out


def window_logits(torch, eng, prompts, toks, index):
    """On the stopped engine ``eng``: each prompt prefilled through pages
    of its own, then ONE verify window per row, ``toks[i][:k+1]`` at the
    dense-equivalent locations, through the target; the logits at window
    ``index`` ([B, V]), i.e. those that decide token ``index + 1``."""
    import numpy as np

    from kubeflow_tpu_torch.models.generate import pow2_bucket

    k, ps, L = eng.propose_tokens, eng.page_size, eng.cfg.max_seq_len
    tables = np.full((len(prompts), eng.n_blocks), -1, np.int32)
    buckets, page = [], 0
    eng._cache.pos.fill_(-1)
    for i, p in enumerate(prompts):
        bucket = pow2_bucket(len(p), L - SERVE_NEW)
        blocks = set(range((len(p) - 1) // ps + 1)) | set(
            range(bucket // ps, (bucket + k) // ps + 1))
        for b in sorted(blocks):
            tables[i, b], page = page, page + 1
        eng._prefill(p, 0, tables[i])
        buckets.append(bucket)
    dev = eng.device
    steps = torch.arange(k + 1, device=dev)
    pos = torch.tensor([len(p) for p in prompts], device=dev)[:, None]
    loc = torch.tensor(buckets, device=dev)[:, None]
    out = eng.model(torch.tensor([t[:k + 1] for t in toks], device=dev),
                    (pos + steps).int(), eng._cache,
                    torch.from_numpy(tables).to(dev), (loc + steps).int())
    return out[:, index]


def bf16_prefix_probe(torch, eng, prompt):
    """Queue C 1 on the card, on the stopped bf16 engine ``eng``: the
    last-token logits of ``prompt`` prefilled whole (a cold cache) against
    a prefill of its tail over the whole prompt's first full pages (what a
    prefix-cache hit runs), the top-1/top-2 gap there, and, for each
    product of a layer (the projections, the two attention products over
    the 2048-slot view) and the head, the tail's rows computed among the
    whole prompt's rows against computed alone, on random bf16 inputs."""
    import numpy as np

    ps, n = eng.page_size, len(prompt)
    own = (n - 1) // ps + 1
    cold_t = np.full((eng.n_blocks,), -1, np.int32)
    cold_t[:own] = np.arange(own)
    eng._cache.pos.fill_(-1)
    cold = eng._prefill(prompt, 0, cold_t)
    j = (n - 1) // ps                      # full pages a hit reuses
    warm_t = cold_t.copy()
    warm_t[j:own] = np.arange(own, own + own - j)
    warm = eng._prefill(prompt[j * ps:], j * ps, warm_t)
    top2 = cold.topk(2).values
    cfg, dev, bf = eng.cfg, eng.device, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(3)
    t = n - j * ps

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g, dtype=bf)

    rows = {}
    layer = eng.model.layers[0]
    for name, dense in (("query", layer.attn.query),
                        ("out", layer.attn.out), ("wi", layer.mlp.wi),
                        ("wo", layer.mlp.wo),
                        ("lm_head", eng.model.lm_head)):
        x = rnd(1, n, *dense.in_shape)
        rows[name] = max_abs(dense(x)[:, -t:], dense(x[:, -t:]))
    L, H, D = cfg.max_seq_len, cfg.n_heads, cfg.head_dim
    q, kv = rnd(1, n, H, D), rnd(1, L, H, D)
    rows["scores"] = max_abs(
        torch.einsum("bqhd,bkhd->bhqk", q, kv)[:, :, -t:],
        torch.einsum("bqhd,bkhd->bhqk", q[:, -t:], kv))
    p = torch.softmax(rnd(1, H, n, L).float(), -1).to(bf)
    rows["pv"] = max_abs(torch.einsum("bhqk,bkhd->bqhd", p, kv)[:, -t:],
                         torch.einsum("bhqk,bkhd->bqhd", p[:, :, -t:], kv))
    return {"prompt": n, "reused_tokens": j * ps,
            "logits_max_abs_diff": max_abs(cold, warm),
            "argmax_equal": int(cold.argmax()) == int(warm.argmax()),
            "top2_gap": float(top2[0] - top2[1]),
            "tail_rows_max_abs_diff": rows}


def spec_bound(eng, B):
    """Least time (ms) of one speculative iteration at B active slots: the
    verify reads the target's bf16 weights (all but the embedding table)
    and its dense K/V (max_seq_len slots a row) once; each of the k+1
    draft steps (k proposals, the catch-up) reads the draft's weights and
    K/V once; or the operations (k+1 tokens a row through each) over the
    bf16 peak if that is longer. With what bounds it and the bytes."""
    cfg, k = eng.cfg, eng.propose_tokens
    L, H, D = cfg.max_seq_len, cfg.n_heads, cfg.head_dim

    def weights(model):
        return sum(p.numel() for n, p in model.named_parameters()
                   if n != "embed.embedding")

    kv = B * L * H * D * 2 * 2                  # K and V a layer, bf16
    nt, nd = weights(eng.model), weights(eng.draft_model)
    nbytes = (2 * nt + kv * cfg.n_layers
              + (k + 1) * (2 * nd + kv * eng.draft_layers))
    attn = 4 * B * H * D * L
    flops = (2 * nt * B + attn * cfg.n_layers) * (k + 1) \
        + (2 * nd * B + attn * eng.draft_layers) * (k + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / PEAK_BF16 * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def tenant_totals(text):
    """{(kind or "requests"): total} over the kfx_tenant_* samples of a
    /metrics text."""
    out = {}
    for line in text.splitlines():
        m = re.match(r'(kfx_tenant_(?:tokens|requests)_total)\{([^}]*)\} '
                     r'(\S+)$', line)
        if m:
            kind = re.search(r'kind="(\w+)"', m.group(2))
            key = kind.group(1) if kind else "requests"
            out[key] = out.get(key, 0) + float(m.group(3))
    return out


def spec_phase(torch, fa, export_dir, gap_cfg, prompts, f1, f2_tokens, dev):
    """Speculative decoding, the reference's default; see the module
    docstring (6g). ``f1`` holds phase (f1)'s LMGenerator tokens, smallest
    gap and logits; ``f2_tokens`` (f2)'s first-wave tokens. Returns the
    {"spec": ...} record."""
    import numpy as np

    from kubeflow_tpu_torch.models.transformer import (
        TransformerLM, truncate_layers)
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.lm_server import LMPredictor
    from kubeflow_tpu_torch.serving.server import ModelServer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    draft = max(1, gap_cfg.n_layers // 4)
    rec = {"draft_layers": draft, "propose_tokens": SPEC_TOKENS,
           "slots": ENGINE_SLOTS}
    kw = dict(n_slots=ENGINE_SLOTS, chunk_tokens=ENGINE_CHUNK,
              kv_page_size=ENGINE_PAGE,
              prefill_chunk_tokens=ENGINE_PREFILL_CHUNK, draft_layers=draft,
              propose_tokens=SPEC_TOKENS, device=dev)

    # (g1) greedy equality and the accept rate on wide-gap f32 weights
    g = torch.Generator(device=dev).manual_seed(0)
    model = TransformerLM(gap_cfg, device=dev, generator=g)
    wide_gap_(torch, model)
    sd = model.state_dict()
    # What bounds the accept rate: how often the draft's argmax is the
    # target's along the greedy chains (full no-cache forwards).
    agree = total = 0
    with torch.inference_mode():
        head = truncate_layers(model, draft)
        for p, w in zip(prompts, f1["want"]):
            seq = torch.tensor([p + w[:-1]], device=dev)
            want_t = model(seq)[0, len(p) - 1:].argmax(-1)
            agree += int((head(seq)[0, len(p) - 1:].argmax(-1)
                          == want_t).sum())
            total += want_t.numel()
    rec["f32_draft_top1_agreement"] = agree / total
    eng = DecodeEngine(gap_cfg, sd, name="f32-spec", **kw)
    try:
        t0 = time.perf_counter()
        got = eng.generate(prompts, SERVE_NEW)
        rec["f32_wave_seconds"] = time.perf_counter() - t0
        st = eng.spec_stats()
        pages = eng.page_stats()
        check(pages["free"] + pages["cached"] == pages["pages"]
              and eng._draft_mgr.n_free == eng.draft_n_pages,
              f"page leak: {pages}, draft free {eng._draft_mgr.n_free}")
    finally:
        eng.close()
    with torch.inference_mode():
        wl = window_logits(torch, eng, prompts, f1["want"],
                           ENGINE_PROBE_STEP - 1)
    diff = max_abs(wl, f1["ref_logits"])
    del eng, wl
    rec["f32_min_gap"], rec["f32_window_logits_max_abs_diff"] = \
        f1["gap"], diff
    check(f1["gap"] > GAP_MARGIN * diff,
          f"argmax gap {f1['gap']:.3g} too small against the verify "
          f"window's logit disagreement {diff:.3g}")
    bad = [i for i, (a, b) in enumerate(zip(got, f1["want"])) if a != b]
    check(not bad, f"speculating engine's greedy tokens differ from "
                   f"LMGenerator in rows {bad}")
    check(st["proposed"] > 0 and st["degraded"] == 0, f"spec stats {st}")
    rec["f32_spec_stats"] = st
    rec["f32_accept_rate"] = st["accepted"] / st["proposed"]
    small = DecodeEngine(gap_cfg, sd, name="f32-spec-small",
                         draft_kv_pages=SPEC_SMALL_DRAFT_POOL, **kw)
    try:
        got = small.generate(prompts, SERVE_NEW)   # raises on a failure
        st_small = small.spec_stats()
        pages = small.page_stats()
        check(got == f1["want"], "tokens changed with a small draft pool")
        check(st_small["degraded"] >= 1, f"no slot degraded: {st_small}")
        check(pages["free"] + pages["cached"] == pages["pages"]
              and small._draft_mgr.n_free == small.draft_n_pages,
              f"page leak with a small draft pool: {pages}")
        rec["f32_small_draft_pool"] = dict(st_small,
                                           pages=SPEC_SMALL_DRAFT_POOL)
    finally:
        small.close()
    log(f"spec (g1) f32 d={gap_cfg.d_model} L={gap_cfg.n_layers} draft "
        f"{draft} layers, k={SPEC_TOKENS}: greedy == LMGenerator for "
        f"{len(prompts)} x {SERVE_NEW} in {rec['f32_wave_seconds']:.3f} s "
        f"(gap {f1['gap']:.4g}, verify-window logits within {diff:.3g}); "
        f"accept rate {rec['f32_accept_rate']:.4f} {st} (draft top-1 "
        f"agreement {rec['f32_draft_top1_agreement']:.4f}); draft pool of "
        f"{SPEC_SMALL_DRAFT_POOL} pages: {st_small}, tokens unchanged, no "
        f"leak")
    del model, sd, small, head
    torch.cuda.empty_cache()

    # (g2) the bf16 export behind an engine-backed server, default env
    check(not any(k.startswith("KFX_LM_SPEC") for k in os.environ),
          "KFX_LM_SPEC* set in the environment")
    pred = LMPredictor(export_dir, name="lm", device=dev.type)
    pred.load()
    eng = pred.engine
    check(eng is not None and eng.spec and eng.draft_layers == draft,
          "speculation is not the served default")
    pred._warm_thread.join(600)
    server = ModelServer(port=0)
    server.register(pred)
    server.start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        gen_url = f"{url}/v1/models/lm:generate"
        pre = tenant_totals(urllib.request.urlopen(
            f"{url}/metrics", timeout=60).read().decode())
        check(pre == {"requests": 0, "prompt": 0, "generated": 0},
              f"tenant families before traffic: {pre}")
        one = lambda p: {"prompt_tokens": [p], "max_new_tokens": SERVE_NEW}
        t0 = time.perf_counter()
        streams = run_threads(lambda p: sse_first(gen_url, one(p), t0),
                              prompts)
        wall = time.perf_counter() - t0
        toks = [s[0] for s in streams]
        ttft = [s[1] for s in streams]
        check(all(len(t) == SERVE_NEW for t in toks),
              f"answers {[len(t) for t in toks]}")
        blk = http_json(f"{url}/metrics?format=json")["engine"]["lm"]
        ledger = tenant_totals(urllib.request.urlopen(
            f"{url}/metrics", timeout=60).read().decode())
    finally:
        server.stop()
    served = {"requests": len(prompts),
              "prompt": sum(len(p) for p in prompts),
              "generated": sum(len(t) for t in toks)}
    check(ledger == served, f"tenant ledger {ledger} != served {served}")
    check(0.0 < blk.get("spec_accept_rate", 0.0) <= 1.0,
          f"engine block {blk}")
    st = eng.spec_stats()
    eng.close()
    rec["bf16_wave_seconds"] = wall
    rec["bf16_tokens_per_second"] = served["generated"] / wall
    rec["bf16_ttft_s"] = {"p50": percentile(ttft, 0.5),
                          "p99": percentile(ttft, 0.99), "all": ttft}
    rec["bf16_spec_accept_rate_gauge"] = blk["spec_accept_rate"]
    rec["bf16_spec_stats"] = st
    rec["bf16_accept_rate"] = st["accepted"] / max(1, st["proposed"])
    rec["tenant_ledger"] = ledger
    rec["rows_equal_f2_bf16"] = sum(a == b for a, b in zip(toks, f2_tokens))
    with torch.inference_mode():
        rec["bf16_prefix_probe"] = bf16_prefix_probe(
            torch, eng, max(prompts, key=len))
    log(f"spec (g2) bf16 export, {len(prompts)} concurrent SSE x "
        f"{SERVE_NEW}: {wall:.3f} s, {rec['bf16_tokens_per_second']:.1f} "
        f"tokens/s; TTFT p50 {rec['bf16_ttft_s']['p50']:.3f} s p99 "
        f"{rec['bf16_ttft_s']['p99']:.3f} s; accept rate "
        f"{rec['bf16_accept_rate']:.4f} (gauge {blk['spec_accept_rate']}); "
        f"ledger {ledger} == served; rows equal to (f2) "
        f"{rec['rows_equal_f2_bf16']}/{len(prompts)}; prefix probe "
        f"{json.dumps(rec['bf16_prefix_probe'])}")

    # (g3) one speculative iteration at 8 active slots, by hand on the
    # stopped engine: each of 8 prompts admitted whole with a budget of a
    # quarter of the cache (512 tokens) so no slot retires.
    with torch.inference_mode():
        eng._cache.pos.fill_(-1)
        eng._draft_cache.pos.fill_(-1)
        eng.prefill_chunk_tokens = 0
        budget = eng.cfg.max_seq_len // 4
        for slot, p in enumerate(prompts[:ENGINE_SLOTS]):
            eng._admit(eng._make_request(p, budget, 0.0, 0, 0, None), slot)
        eng._spec_once()
        eng._spec_once()
        check(int((eng._active & eng._spec_ok).sum()) == ENGINE_SLOTS,
              "slots not speculating")
        acc0, n_it = eng.spec_stats()["accepted"], 5
        iter_ms = event_ms(torch, eng._spec_once, n_it)
        per_it = ENGINE_SLOTS + (eng.spec_stats()["accepted"] - acc0) / n_it
        enq = []
        for _ in range(3):
            on = eng._active.copy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            packed = eng._spec_launch(np.zeros_like(on), on)
            enq.append((time.perf_counter() - t0) * 1e3)
            packed.cpu()
        prof = step_profile(torch, eng._spec_once, 3)
    bound, by, nbytes = spec_bound(eng, ENGINE_SLOTS)
    busy = prof.get("kernel_ms")
    rec["iteration"] = {
        "iteration_ms": iter_ms, "tokens_per_iteration": per_it,
        "ms_per_token": iter_ms / per_it,
        "tokens_per_s": per_it * 1e3 / iter_ms,
        "bound_ms": bound, "bound_by": by, "bound_bytes": nbytes,
        "share_of_bound": bound / iter_ms,
        "host_enqueue_ms": sorted(enq)[1],
        "busy_share": busy / iter_ms if busy else None, **prof}
    rec["draft_pool_bytes"] = eng.draft_pool_bytes
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(fa.LAUNCHES)
    check(all(v == 0 for v in launches.values()),
          f"flash kernels launched by the speculating engine: {launches}")
    rec["flash_launches"] = launches
    log(f"spec (g3) one iteration at {ENGINE_SLOTS} slots: {iter_ms:.2f} ms "
        f"for {per_it:.2f} tokens ({iter_ms / per_it:.3f} ms a token); bound "
        f"{bound:.3f} ms ({by}); host enqueue "
        f"{rec['iteration']['host_enqueue_ms']:.2f} ms; profile "
        f"{json.dumps(prof)}; draft pool {eng.draft_pool_bytes / 1e9:.3f} "
        f"GB; peak {rec['peak_memory_gb']:.2f} GB; flash launches "
        f"{launches}")
    return rec


# -- (j) int8 serving at full width -----------------------------------------

def _agreement(got, want):
    """(first tokens all equal, mean per-row share of equal positions)."""
    first = all(g[0] == w[0] for g, w in zip(got, want))
    rows = [sum(a == b for a, b in zip(g, w)) / len(w)
            for g, w in zip(got, want)]
    return first, sum(rows) / len(rows)


def chunk_by_hand(torch, eng, prompts, adapters=None, profile=True,
                  models=None):
    """The decode chunk at 8 active slots on a stopped engine (as (f3)):
    the prompts admitted whole with a budget of a quarter of the cache
    (slot i wearing ``adapters[i]``, or pooled model ``models[i]``, when
    given), then the chunk's CUDA-event time (median of 3), its host
    enqueue (median of 3) and, with ``profile``, a profile of one chunk
    (step_profile; else {})."""
    with torch.inference_mode():
        eng._cache.pos.fill_(-1)
        eng.prefill_chunk_tokens = 0
        budget = eng.cfg.max_seq_len // 4
        for slot, p in enumerate(prompts[:ENGINE_SLOTS]):
            eng._admit(eng._make_request(
                p, budget, 0.0, 0, 0, None,
                adapter=adapters[slot] if adapters else None,
                model=models[slot] if models else None), slot)

        def chunk():
            eng._ensure_chunk_pages()
            eng._decode_chunk()

        chunk()
        chunk()
        check(int(eng._active.sum()) == ENGINE_SLOTS, "slots not active")
        chunk_ms = event_ms(torch, chunk, 3)
        enq = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            packed = eng._chunk_launch()
            enq.append((time.perf_counter() - t0) * 1e3)
            eng._chunk_collect(packed)
        prof = step_profile(torch, chunk, 1) if profile else {}
    return chunk_ms, sorted(enq)[1], prof


def first_logits(torch, eng, prompt):
    """The logits a stopped engine's paged prefill gives the first new
    token of ``prompt`` (the engine's own ``_prefill`` into fresh pages,
    freed after)."""
    import numpy as np

    n = -(-len(prompt) // eng.page_size)
    pages = eng._alloc_pages(n)
    row = np.full((eng.n_blocks,), -1, np.int32)
    row[:n] = pages
    try:
        with torch.inference_mode():
            return eng._prefill(prompt, 0, row).clone()
    finally:
        eng._mgr.decref(pages)


def peak_admission(eng, prompts, new):
    """Submit every prompt at once and poll the engine's active slots
    until all finish: (peak concurrent admissions, answers)."""
    reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    peak, deadline = 0, time.monotonic() + 600
    while not all(r.done() for r in reqs) and time.monotonic() < deadline:
        peak = max(peak, eng._active_count())
        time.sleep(0.002)
    return peak, [r.result(60) for r in reqs]


def int8_phase(torch, fa, export_dir, gap_cfg, prompts, f1, dev):
    """(j) int8 weights, int8 paged KV and the int8 draft at the base
    preset's full width; see the module docstring. ``f1`` holds phase
    (f1)'s LMGenerator tokens on the wide-gap f32 weights. Returns the
    {"int8": ...} record."""
    import dataclasses

    import numpy as np

    from kubeflow_tpu_torch.models.convert import params_to_jax
    from kubeflow_tpu_torch.models.generate import load_decode_model
    from kubeflow_tpu_torch.models.transformer import (
        TransformerLM, dequantize_params_int8, quantize_params_int8)
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.lm_server import LMPredictor, load_lm
    from kubeflow_tpu_torch.serving.server import ModelServer

    torch.cuda.empty_cache()
    fa.reset_launches()
    rec = {"seconds": {}}
    kw = dict(n_slots=ENGINE_SLOTS, chunk_tokens=ENGINE_CHUNK,
              kv_page_size=ENGINE_PAGE, device=dev)
    t_sub = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        rec["seconds"][name] = now - t_sub[0]
        t_sub[0] = now

    # (j0) int8 weights against full precision: wide-gap f32 weights.
    g = torch.Generator(device=dev).manual_seed(0)
    model = TransformerLM(gap_cfg, device=dev, generator=g)
    wide_gap_(torch, model)
    model.eval().requires_grad_(False)
    tree = params_to_jax(model.state_dict())
    t0 = time.perf_counter()
    qtree = quantize_params_int8(tree)
    rec["quantize_seconds"] = time.perf_counter() - t0
    cfg8 = dataclasses.replace(gap_cfg, quant="int8")
    w8 = load_decode_model(cfg8, qtree, dev)
    deq = load_decode_model(gap_cfg, dequantize_params_int8(qtree), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, gap_cfg.vocab_size, (2, INT8_SEQ), device=dev,
                         generator=gen)
    with torch.inference_mode():
        lf, lq, ld = model(toks), w8(toks), deq(toks)

        def nll(logits):
            lp = torch.log_softmax(logits[:, :-1], -1)
            return -float(lp.gather(-1, toks[:, 1:, None]).mean())

        nf, nq = nll(lf), nll(lq)
    big = float(lf.abs().max())
    rec["w8_logits_rel_err"] = max_abs(lq, lf) / big
    rec["w8_nll"], rec["f32_nll"] = nq, nf
    rec["w8_nll_rel_change"] = abs(nq - nf) / nf
    rec["dequant_vs_w8_abs"] = max_abs(ld, lq)
    rec["dequant_vs_w8_rel"] = rec["dequant_vs_w8_abs"] / big
    check(rec["w8_logits_rel_err"] < INT8_TOL_LOGITS,
          f"(j0) w8 logits off by {rec['w8_logits_rel_err']:.4f} of range")
    check(rec["w8_nll_rel_change"] < INT8_TOL_NLL,
          f"(j0) w8 NLL {nq:.5f} vs f32 {nf:.5f}")
    check(rec["dequant_vs_w8_rel"] < INT8_TOL_DEQUANT,
          f"(j0) dequantized path vs w8 {rec['dequant_vs_w8_rel']:.3g}")
    log(f"int8 (j0) base f32 wide-gap, {toks.shape[0]}x{INT8_SEQ} tokens: "
        f"w8 logits within {rec['w8_logits_rel_err']:.5f} of max |logit| "
        f"{big:.3f} (bar {INT8_TOL_LOGITS}); NLL {nq:.5f} vs {nf:.5f} "
        f"(change {rec['w8_nll_rel_change']:.5f}, bar {INT8_TOL_NLL}); "
        f"dequantized tree through the f32 path vs w8 "
        f"{rec['dequant_vs_w8_abs']:.3g} abs ({rec['dequant_vs_w8_rel']:.3g}"
        f" rel); quantize {rec['quantize_seconds']:.2f} s on the host")
    del w8, deq, lf, lq, ld
    torch.cuda.empty_cache()
    lap("j0")

    # (j1) drift of the int8 engines from LMGenerator on those weights:
    # the reference's contract, for int8 KV alone and for int8 weights and
    # KV (the user's path below). Mean agreement >= 0.5 is held as it is;
    # the first token is held equal wherever the f32 top-1/top-2 gap of
    # the first decision exceeds twice the int8 path's largest logit
    # change there (then no argmax can move); rows under that are counted.
    with torch.inference_mode():
        f32_first = [model(torch.tensor([p], device=dev))[0, -1]
                     for p in prompts]
    gaps = [float(t.topk(2).values[0] - t.topk(2).values[1])
            for t in f32_first]
    drift, drift_out = {}, {}
    for mode, (cfg_m, tree_m) in (("kv8", (gap_cfg, tree)),
                                  ("w8+kv8", (cfg8, qtree))):
        eng = DecodeEngine(cfg_m, tree_m, name=f"drift-{mode}",
                           kv_quant="int8", **kw)
        try:
            check(eng.quant_mode == mode, f"(j1) mode {eng.quant_mode}")
            got = eng.generate(prompts, SERVE_NEW)
        finally:
            eng.close()
        diffs = [max_abs(first_logits(torch, eng, p), t)
                 for p, t in zip(prompts, f32_first)]
        equal = [g[0] == w[0] for g, w in zip(got, f1["want"])]
        held = [i for i in range(len(prompts)) if gaps[i] > 2 * diffs[i]]
        drift_out[mode] = got
        first, agree = _agreement(got, f1["want"])
        drift[mode] = {"agreement": agree, "first_token_equal": equal,
                       "first_gap": gaps, "first_logit_change": diffs,
                       "rows_held": held}
        check(all(len(r) == SERVE_NEW for r in got)
              and all(equal[i] for i in held) and agree >= INT8_AGREE,
              f"(j1) {mode} drift: {json.dumps(drift[mode])}")
    rec["drift"] = drift
    del model
    torch.cuda.empty_cache()
    log(f"int8 (j1) drift from LMGenerator on the f32 wide-gap weights, "
        f"{len(prompts)} x {SERVE_NEW} greedy: {json.dumps(drift)}")
    lap("j1_drift")

    # (j1) the user's path: the bf16 export behind ModelServer with
    # KFX_LM_QUANT=int8 and KFX_LM_KV_QUANT=int8 (speculation on, the
    # default), one :generate of (a)'s 8 prompts, then twice more warm
    # (INT8_WARM_NEW tokens each).
    env = {"KFX_LM_QUANT": "int8", "KFX_LM_KV_QUANT": "int8"}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        pred = LMPredictor(export_dir, name="lm", device=dev.type)
        pred.load()
        rec["w8kv8_predictor_load_seconds"] = time.perf_counter() - t0
    finally:
        for k in env:
            del os.environ[k]
    eng = pred.engine
    check(eng.quant_mode == "w8+kv8" and eng.spec,
          f"(j1) served mode {eng.quant_mode}, spec {eng.spec}")
    server = ModelServer(port=0)
    server.register(pred)
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    gen_url = f"{url}/v1/models/lm:generate"
    body = {"prompt_tokens": prompts, "max_new_tokens": JK_NEW}
    t0 = time.perf_counter()
    cold = http_json(gen_url, body)["generated_tokens"]
    rec["w8kv8_http_seconds"] = time.perf_counter() - t0
    warm_body = dict(body, max_new_tokens=INT8_WARM_NEW)
    warm = [http_json(gen_url, warm_body)["generated_tokens"]
            for _ in range(2)]
    blk = http_json(f"{url}/metrics?format=json")["engine"]["lm"]
    check(all(len(r) == JK_NEW for r in cold),
          f"(j1) answers {[len(r) for r in cold]}")
    check(warm[0] == warm[1], "(j1) the repeated :generate answered "
                              "differently")
    check(blk["quant"] == "w8+kv8"
          and blk["kv_bytes_per_token"] == eng.kv_bytes_per_token,
          f"(j1) engine block {blk}")
    rec["served"] = {"quant": blk["quant"],
                     "kv_bytes_per_token": blk["kv_bytes_per_token"],
                     "rows_equal_cold_warm": sum(
                         a[:INT8_WARM_NEW] == b
                         for a, b in zip(cold, warm[0])),
                     "pool_bytes": eng.pool_bytes,
                     "spec_accept_rate": blk.get("spec_accept_rate")}
    log(f"int8 (j1) bf16 export served w8+kv8 (KFX_LM_QUANT=int8 "
        f"KFX_LM_KV_QUANT=int8, speculation on): {len(prompts)} x "
        f"{JK_NEW} in {rec['w8kv8_http_seconds']:.3f} s, full length; "
        f"warm repeats identical; engine block {json.dumps(blk)}")

    # (k1)-(k3) on that server (the wedge drains it, so it comes last).
    lap("j1_served")
    rec["_chaos"] = chaos_server_checks(server, pred, prompts)
    server.stop()
    pred._warm_thread.join(600)
    eng.close()
    del pred, eng, server
    torch.cuda.empty_cache()
    lap("k1_k3")

    # (j2) the page machinery is invisible under int8 KV, f32 weights: a
    # small pool with the prefix cache (the longest prompt twice, the
    # second a prefix hit; then the 8 prompts, which preempt) against the
    # (j1) int8-KV engine, whose pool holds every request whole and whose
    # one wave of distinct prompts hits no cached page.
    i512 = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    eng = DecodeEngine(gap_cfg, tree, name="kv8-small", kv_quant="int8",
                       kv_pages=ENGINE_SMALL_POOL, **kw)
    try:
        got_s = [eng.generate([prompts[i512]], SERVE_NEW)[0]
                 for _ in range(2)] + eng.generate(prompts, SERVE_NEW)
        pages_s, pre_s = eng.page_stats(), eng.prefix_stats()
    finally:
        eng.close()
    plain = drift_out["kv8"]
    got_p = [plain[i512], plain[i512]] + plain
    check(pages_s["preemptions"] >= 1 and pre_s["hits"] >= 1,
          f"(j2) small pool {pages_s} {pre_s}")
    check(pages_s["free"] + pages_s["cached"] == pages_s["pages"],
          f"(j2) page leak {pages_s}")
    bad = [(i, next(j for j, (a, b) in enumerate(zip(x, y)) if a != b))
           for i, (x, y) in enumerate(zip(got_s, got_p)) if x != y]
    check(not bad, f"(j2) int8 tokens changed with preemption / prefix "
                   f"hits: (row, first differing index) {bad}")
    lap("j2")
    rec["page_machinery"] = {"small_pool": pages_s, "prefix": pre_s}
    log(f"int8 (j2) f32 weights, int8 KV: pool of {ENGINE_SMALL_POOL} "
        f"pages {pages_s}, prefix {pre_s}: tokens byte-identical to (j1)'s "
        f"large pool")

    # (j3) admission at the same pool bytes (bf16 export): pages gate it.
    cfg_b, tree_b = load_lm(export_dir)
    rng = np.random.default_rng(3)
    adm_prompts = [rng.integers(0, cfg_b.vocab_size, ADMIT_PROMPT).tolist()
                   for _ in range(ADMIT_SLOTS)]
    akw = dict(n_slots=ADMIT_SLOTS, chunk_tokens=ENGINE_CHUNK,
               kv_page_size=ENGINE_PAGE, prefix_cache=False, device=dev)
    # The bf16 pool is the least an engine takes (one max-length request);
    # the int8 pool gets as many pages as the same bytes buy, at the int8
    # bytes a token of (j1)'s served engine (same geometry).
    bf16_pages = cfg_b.max_seq_len // ENGINE_PAGE
    adm = {}
    for mode in ("", "int8"):
        n_pages = bf16_pages if not mode else (
            bf16_pages * adm["bf16"]["kv_bytes_per_token"]
            // rec["served"]["kv_bytes_per_token"])
        eng = DecodeEngine(cfg_b, tree_b, name=f"admit-{mode or 'bf16'}",
                           kv_pages=n_pages, kv_quant=mode, **akw)
        try:
            peak, outs_a = peak_admission(eng, adm_prompts, ADMIT_NEW)
            adm[mode or "bf16"] = {
                "pages": n_pages, "peak_admitted": peak,
                "kv_bytes_per_token": eng.kv_bytes_per_token,
                "pool_bytes": eng.pool_bytes}
        finally:
            eng.close()
        check(all(len(o) == ADMIT_NEW for o in outs_a),
              "(j3) an admission test request came back short")
    ratio = adm["int8"]["peak_admitted"] / adm["bf16"]["peak_admitted"]
    adm["ratio"] = ratio
    rec["admission"] = adm
    check(ratio >= INT8_ADMIT_RATIO,
          f"(j3) int8 admitted {ratio:.2f}x the bf16 pool's: {adm}")
    log(f"int8 (j3) same pool bytes, {ADMIT_SLOTS} slots, {ADMIT_SLOTS} "
        f"requests of {ADMIT_PROMPT}+{ADMIT_NEW} tokens: {json.dumps(adm)}")
    torch.cuda.empty_cache()
    lap("j3")

    # (j4) the int8 draft: the speculating engine on the f32 target with
    # an int8 draft; greedy equal to (f1)'s non-speculative tokens.
    draft = max(1, gap_cfg.n_layers // 4)
    eng = DecodeEngine(gap_cfg, tree, name="d8", draft_layers=draft,
                       propose_tokens=SPEC_TOKENS, draft_quant="int8", **kw)
    try:
        check(eng.quant_mode == "d8", f"(j4) mode {eng.quant_mode}")
        got = eng.generate(prompts, JK_NEW)
        st = eng.spec_stats()
        check(got == [w[:JK_NEW] for w in f1["want"]],
              "(j4) int8-draft greedy tokens differ from the "
              "non-speculative engine's")
        check(eng._draft_mgr.n_free == eng.draft_n_pages,
              "(j4) draft page leak")
        rec["draft"] = dict(st, accept_rate=st["accepted"] / max(
            1, st["proposed"]), draft_layers=draft)
        # (k4) on the same engine: full-rejection waves across a request.
        rec["_chaos"]["k4"] = chaos_spec_verify(eng, prompts[0], f1)
    finally:
        eng.close()
    del eng
    # The knob as a user sets it, on the bf16 export: one request.
    os.environ["KFX_LM_QUANT_DRAFT"] = "int8"
    try:
        pred = LMPredictor(export_dir, name="lm", device=dev.type,
                           warm_buckets=[8])
        pred.load()
    finally:
        del os.environ["KFX_LM_QUANT_DRAFT"]
    try:
        check(pred.engine.quant_mode == "d8",
              f"(j4) served mode {pred.engine.quant_mode}")
        out = pred.generate({"prompt_tokens": prompts[:1],
                             "max_new_tokens": INT8_WARM_NEW})
        check(len(out["generated_tokens"][0]) == INT8_WARM_NEW,
              "(j4) KFX_LM_QUANT_DRAFT=int8 answers short")
        st = pred.engine.spec_stats()
        rec["draft"]["served_bf16_accept_rate"] = st["accepted"] / max(
            1, st["proposed"])
    finally:
        pred.close()
    log(f"int8 (j4) int8 draft ({draft} layers) on the f32 target: greedy "
        f"== (f1) for {len(prompts)} x {JK_NEW}, "
        f"{json.dumps(rec['draft'])}")
    del pred
    torch.cuda.empty_cache()
    lap("j4_k4")

    # (j5) runs in the beside child (j5_costs); (k5) takes the bf16
    # export's int8 tree.
    rec["_w8"] = (dataclasses.replace(cfg_b, quant="int8"),
                  quantize_params_int8(tree_b))
    rec["flash_launches"] = dict(fa.LAUNCHES)
    check(all(v == 0 for v in rec["flash_launches"].values()),
          f"(j) flash launches {rec['flash_launches']}")
    lap("w8_tree")
    return rec


def j5_costs(torch, fa, export_dir, prompts, dev):
    """(j5) costs, bf16 export, in the beside child after (n): the decode
    chunk at 8 slots per mode (bf16, w8, kv8, w8+kv8; not profiled), pool
    bytes, weight bytes, peak memory and load seconds; one QuantDense
    call against the Dense call and a bf16 matmul at the mlp.wi shape for
    8 tokens. Flash launches 0/0/0. Returns {"costs", "quant_dense",
    "flash_launches"}."""
    import dataclasses

    import numpy as np

    from kubeflow_tpu_torch.models.transformer import (
        Dense, QuantDense, quantize_leaf_int8, quantize_params_int8)
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.lm_server import load_lm

    fa.reset_launches()
    kw = dict(n_slots=ENGINE_SLOTS, chunk_tokens=ENGINE_CHUNK,
              kv_page_size=ENGINE_PAGE, device=dev)
    cfg_b, tree_b = load_lm(export_dir)
    qtree_b = quantize_params_int8(tree_b)
    cfg8_b = dataclasses.replace(cfg_b, quant="int8")
    costs = {}
    for mode, cfg_m, tree_m, kvq in (
            ("bf16", cfg_b, tree_b, ""), ("w8", cfg8_b, qtree_b, ""),
            ("kv8", cfg_b, tree_b, "int8"),
            ("w8+kv8", cfg8_b, qtree_b, "int8")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = DecodeEngine(cfg_m, tree_m, name=f"cost-{mode}", kv_quant=kvq,
                           **kw)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        eng.close()
        chunk_ms, enq, prof = chunk_by_hand(torch, eng, prompts,
                                            profile=False)
        busy = prof.get("kernel_ms")
        costs[mode] = {
            "chunk_ms": chunk_ms, "step_ms": chunk_ms / ENGINE_CHUNK,
            "host_enqueue_ms": enq, "kernel_ms": busy,
            "kernels": prof.get("kernels"),
            "busy_share": busy / chunk_ms if busy else None,
            "top_kernels_ms": prof.get("top_kernels_ms"),
            "load_seconds": load_s,
            "pool_bytes": eng.pool_bytes,
            "kv_bytes_per_token": eng.kv_bytes_per_token,
            "weight_bytes": sum(t.numel() * t.element_size() for t in
                                eng.model.state_dict().values()),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del eng
    d, f = cfg_b.d_model, 2 * cfg_b.d_ff
    w = np.random.default_rng(4).normal(size=(d, f)).astype(np.float32)
    q, scale = quantize_leaf_int8(w * 0.02, 1)
    qd = QuantDense((d,), (f,), cfg_b).to(dev)
    qd.kernel.data = torch.from_numpy(q).to(dev)
    qd.scale.data = torch.from_numpy(scale).to(dev)
    dense = Dense((d,), (f,), cfg_b).to(dev)
    with torch.no_grad():
        dense.kernel.copy_(torch.from_numpy(w * 0.02))
    x = torch.randn(ENGINE_SLOTS, 1, d, device=dev, dtype=cfg_b.dtype)
    wb = dense.kernel.to(cfg_b.dtype)
    with torch.inference_mode():
        ms = {"quant_dense": time_ms(torch, lambda: qd(x), 20),
              "dense": time_ms(torch, lambda: dense(x), 20),
              "bf16_matmul": time_ms(torch, lambda: x @ wb, 20)}
    nbytes = d * f + 2 * ENGINE_SLOTS * (d + f) + 4 * f
    ms["int8_bound_ms"] = nbytes / HBM_BYTES_S * 1e3
    ms["shape"] = [ENGINE_SLOTS, d, f]
    launches = dict(fa.LAUNCHES)
    check(all(v == 0 for v in launches.values()),
          f"(j5) flash launches {launches}")
    log(f"int8 (j5) decode chunk at {ENGINE_SLOTS} slots by mode: "
        f"{json.dumps(costs)}; mlp.wi [{ENGINE_SLOTS}x{d}]x[{d}x{f}]: "
        f"{json.dumps(ms)}; flash launches {launches}")
    return {"costs": costs, "quant_dense": ms, "flash_launches": launches}


# -- (k) the chaos points on the card -----------------------------------------

def chaos_metric(url, point):
    """kfx_chaos_injected_total{point} from the server's /metrics."""
    text = urllib.request.urlopen(f"{url}/metrics", timeout=60).read().decode()
    m = re.search(r'^kfx_chaos_injected_total\{point="%s"\} (\S+)$'
                  % re.escape(point), text, re.M)
    return float(m.group(1)) if m else None


def post_status(url, payload):
    """POST JSON: (status, decoded answer, headers), errors included."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


@contextlib.contextmanager
def chaos_env(spec):
    """KFX_CHAOS=spec for the block, with fresh process-local counts."""
    from kubeflow_tpu_torch import chaos

    chaos.reset()
    os.environ["KFX_CHAOS"] = spec
    try:
        yield chaos
    finally:
        del os.environ["KFX_CHAOS"]
        chaos.reset()


def chaos_server_checks(server, pred, prompts):
    """(k1) engine.admit, (k2) engine.kv_alloc, (k5) engine.kv_quant and
    (k3) engine.wedge on the w8+kv8 server of (j1), through KFX_CHAOS as a
    user sets it."""
    url = f"http://127.0.0.1:{server.port}"
    gen_url = f"{url}/v1/models/lm:generate"
    one = {"prompt_tokens": [prompts[0][:64]], "max_new_tokens": 16}
    out = {}
    with chaos_env("engine.admit:count=1"):
        code, body, _ = post_status(gen_url, one)
        check(code == 500 and body["error"] == "chaos[engine.admit]: lm",
              f"(k1) {code} {body}")
        code2, body2, _ = post_status(gen_url, one)
        check(code2 == 200 and len(body2["generated_tokens"][0]) == 16,
              f"(k1) next request {code2} {body2}")
        n = chaos_metric(url, "engine.admit")
        check(n == 1, f"(k1) kfx_chaos_injected_total engine.admit {n}")
    out["k1"] = {"status": code, "error": body["error"], "next": code2,
                 "metric": n}
    with chaos_env("engine.kv_alloc:count=1"):
        code, body, headers = post_status(gen_url, one)
        check(code == 503 and headers.get("Retry-After") == "1"
              and "chaos[engine.kv_alloc]" in body["error"],
              f"(k2) {code} {body} {dict(headers)}")
        code2, body2, _ = post_status(gen_url, one)
        check(code2 == 200 and len(body2["generated_tokens"][0]) == 16,
              f"(k2) next request {code2} {body2}")
    out["k2"] = {"status": code, "retry_after": headers.get("Retry-After"),
                 "next": code2}
    log(f"chaos (k1) engine.admit:count=1 -> {out['k1']}; (k2) "
        f"engine.kv_alloc:count=1 -> {out['k2']}")
    # (k3) the wedge: the heartbeat shows the stall, the ring's last
    # record is the stalled iteration, drain completes, the request ends.
    eng = pred.engine
    eng.stall_threshold_s = 0.5
    with chaos_env("engine.wedge:count=1,delay=1.5") as chaos:
        req = eng.submit(prompts[0][:64], max_new_tokens=16)
        seen, deadline = None, time.monotonic() + 60
        while time.monotonic() < deadline and not req.done():
            hb = eng.heartbeat()
            if hb["busy"] and hb["stalled_s"] > 0.8:
                seen = hb
                break
            time.sleep(0.02)
        check(seen is not None, "(k3) no stall seen on the heartbeat")
        try:
            urllib.request.urlopen(f"{url}/healthz", timeout=60)
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        check(code == 503, f"(k3) /healthz answered {code} mid-stall")
        last = eng.flight.snapshot()["records"][-1]
        frozen = eng.heartbeat()["iterations"]
        check(last["it"] == frozen and (last["active"] or
                                        last["prefilling"]),
              f"(k3) last record {last} vs iterations {frozen}")
        drained = server.drain(wait_s=60)
        toks = req.result(60)
        check(drained["drained"] is True and len(toks) == 16,
              f"(k3) drain {drained}, {len(toks)} tokens")
        check(chaos.injected_counts().get("engine.wedge") == 1,
              "(k3) wedge count")
    out["k3"] = {"stalled_s": seen["stalled_s"], "wedged": seen["wedged"],
                 "healthz": code, "last_record_it": last["it"],
                 "iterations": frozen, "drained": drained["drained"]}
    log(f"chaos (k3) engine.wedge:count=1,delay=1.5 -> {out['k3']}")
    return out


def chaos_spec_verify(eng, prompt, f1):
    """(k4) engine.spec_verify across a whole request on the f32 target:
    output equal to the uninjected run's, accepted frozen, no page leak
    from either pool, and the engine speculates again after."""
    from kubeflow_tpu_torch import chaos

    want = f1["want"][0][:JK_NEW]
    acc0 = eng.spec_stats()["accepted"]
    chaos.install(chaos.parse_spec("engine.spec_verify:count=100000"))
    try:
        got = eng.generate([prompt], JK_NEW)[0]
        n = chaos.injected_counts().get("engine.spec_verify", 0)
    finally:
        chaos.reset()
    acc1 = eng.spec_stats()["accepted"]
    pages = eng.page_stats()
    check(got == want and n >= 1 and acc1 == acc0,
          f"(k4) tokens equal {got == want}, injections {n}, accepted "
          f"{acc0} -> {acc1}")
    check(pages["free"] + pages["cached"] == pages["pages"]
          and eng._draft_mgr.n_free == eng.draft_n_pages,
          f"(k4) page leak {pages}")
    prop = eng.spec_stats()["proposed"]
    check(eng.generate([prompt], JK_NEW)[0] == want
          and eng.spec_stats()["proposed"] > prop,
          "(k4) the engine does not speculate again")
    out = {"injections": n, "accepted_frozen": acc1 == acc0,
           "pages": pages}
    log(f"chaos (k4) engine.spec_verify on every iteration of a "
        f"{JK_NEW}-token request: {out}; tokens unchanged, speculates "
        f"again after")
    return out


def chaos_kv_quant(w8, prompts, dev):
    """(k5) engine.kv_quant:count=2 on the w8+kv8 engine at full width
    (all prompts admitted before the first decode chunk): every request
    completes at full length, the output differs from the clean run, the
    prefix cache is empty after, and every page is free after a drain.
    ``w8`` is (j5)'s int8 (config, tree) of the bf16 export; JK_NEW
    tokens a row."""
    from kubeflow_tpu_torch import chaos
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    cfg8, qtree = w8
    eng = DecodeEngine(cfg8, qtree, n_slots=ENGINE_SLOTS,
                       chunk_tokens=ENGINE_CHUNK, kv_page_size=ENGINE_PAGE,
                       kv_quant="int8", name="k5", device=dev)
    try:
        clean = eng.generate(prompts, JK_NEW)
        check(len(eng._prefix) > 0, "(k5) nothing cached")
        chaos.install(chaos.parse_spec("engine.kv_quant:count=2"))
        try:
            hit = eng.generate(prompts, JK_NEW)
            n = chaos.injected_counts().get("engine.kv_quant")
        finally:
            chaos.reset()
        cached = len(eng._prefix)
        drained = eng.drain(60)
        pages = eng.page_stats()
    finally:
        eng.close()
    check(n == 2 and all(len(r) == JK_NEW for r in hit),
          f"(k5) injections {n}, lengths {[len(r) for r in hit]}")
    check(hit != clean, "(k5) crushing the scales changed no output")
    check(cached == 0 and drained and pages["free"] == pages["pages"],
          f"(k5) cache {cached}, drained {drained}, pages {pages}")
    out = {"injections": n, "rows_changed": sum(
        a != b for a, b in zip(hit, clean)), "prefix_entries_after": cached,
        "pages": pages}
    log(f"chaos (k5) engine.kv_quant:count=2 on w8+kv8: {out}")
    return out


def chaos_predict_check(export_dir):
    """(k6) serving.predict:count=1 on the classifier export of (i): one
    500 with the reference's message, then served."""
    from kubeflow_tpu_torch.data import get_dataset
    from kubeflow_tpu_torch.serving.server import JaxPredictor, ModelServer

    pred = JaxPredictor(export_dir, name="resnet50", max_batch_size=64)
    pred.load()
    images, _ = get_dataset("imagenet-sim", "eval").eval_arrays(1)
    srv = ModelServer(port=0)
    srv.register(pred)
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}/v1/models/resnet50:predict"
        body = {"instances": images[:1].tolist()}
        with chaos_env("serving.predict:count=1"):
            code, out, _ = post_status(url, body)
            code2, out2, _ = post_status(url, body)
            n = chaos_metric(f"http://127.0.0.1:{srv.port}",
                             "serving.predict")
    finally:
        srv.stop()
    check(code == 500 and out == {"error": "chaos[serving.predict]: "
                                           "resnet50"}, f"(k6) {code} {out}")
    check(code2 == 200 and len(out2["predictions"]) == 1 and n == 1,
          f"(k6) next {code2}, metric {n}")
    rec = {"status": code, "next": code2, "metric": n}
    log(f"chaos (k6) serving.predict:count=1 on :predict -> {rec}")
    return rec


# -- (l) multi-tenant LoRA at full width -------------------------------------

def stacked_tree(torch, sd):
    """A port state_dict as the reference's layout, on its device: the
    layer leaves stacked (``merge_lora_params`` merges device kernels on
    the device)."""
    L = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("layers."))
    tree = {}
    for key, t in sd.items():
        if key.startswith("layers."):
            if not key.startswith("layers.0."):
                continue
            path = ["layers"] + key.split(".")[2:]
            t = torch.stack([sd[f"layers.{i}." + ".".join(path[1:])]
                             for i in range(L)])
        else:
            path = key.split(".")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t
    return tree


def lru_replay(ops, n_slots):
    """A plain LRU model of the adapter pool: replay ("pin" | "unpin",
    name) events over ``n_slots`` slots, evicting the least recently
    pinned adapter no request wears when a new one needs a slot. Returns
    (loads, evictions, sorted resident names)."""
    from collections import OrderedDict

    lru, ref, loads, evictions = OrderedDict(), {}, 0, 0
    for op, name in ops:
        if op == "unpin":
            ref[name] -= 1
            continue
        if name in lru:
            lru.move_to_end(name)
        else:
            if len(lru) == n_slots:
                del lru[next(n for n in lru if ref[n] == 0)]
                evictions += 1
            lru[name] = True
            loads += 1
        ref[name] = ref.get(name, 0) + 1
    return loads, evictions, sorted(lru)


def lora_finetune(torch, fa, export_dir, out_dir, dev, base_step):
    """(l0): the fine-tuner on the main path's trained weights; see the
    module docstring. Returns (record, the tuned adapter's flat tree)."""
    from kubeflow_tpu_torch.models.transformer import TransformerLM
    from kubeflow_tpu_torch.serving.lm_server import load_lm
    from kubeflow_tpu_torch.training.lora import LoRAFineTuner

    cfg, params = load_lm(export_dir)
    torch.cuda.empty_cache()
    tuner = LoRAFineTuner(cfg, params, rank=LORA_RANK, alpha=LORA_ALPHA,
                          device=dev)
    del params
    g = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (LORA_BATCH, 2049),
                           device=dev, generator=g)
    # The base model's loss on the same batch: a model without factors on
    # the tuner's own base tensors.
    plain = TransformerLM(cfg, device="meta")
    plain.load_state_dict(dict(tuner.base), assign=True)
    with torch.no_grad():
        logits = plain(tokens[:, :-1])
        base_loss = float(torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg.vocab_size), tokens[:, 1:].reshape(-1)))
    del plain, logits
    before = {k: v.clone() for k, v in tuner.base.items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # What the process already holds (earlier phases' tensors, the base
    # and its copy): the steps' own peak is counted above it.
    held = torch.cuda.memory_allocated()
    fa.reset_launches()
    losses, times = [], []
    for _ in range(LORA_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tuner.train_step(tokens))   # syncs (float(loss))
        times.append(time.perf_counter() - t0)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    want = {k: L * LORA_STEPS for k in ("flash_fwd", "flash_dq",
                                        "flash_dkv")}
    check(launches == want, f"(l0) launches {launches} != {want}")
    check(losses[0] == base_loss,
          f"(l0) step-0 loss {losses[0]!r} != the base's {base_loss!r}")
    check(all(math.isfinite(x) for x in losses), f"(l0) losses {losses}")
    unchanged = all(torch.equal(before[k], v) for k, v in tuner.base.items())
    check(unchanged, "(l0) the base moved")
    del before
    prof = step_profile(torch, lambda: tuner.train_step(tokens), 1)
    step = sorted(times[1:])[len(times[1:]) // 2]
    busy = prof.get("kernel_ms")
    n_lora = sum(p.numel() for p in tuner.lora.values())
    rec = {"rank": LORA_RANK, "alpha": LORA_ALPHA, "batch": LORA_BATCH,
           "seq": 2048, "losses": losses, "base_loss": base_loss,
           "step_s": step, "step_times": times,
           "tokens_per_s": LORA_BATCH * 2048 / step,
           "base_step_s": base_step,
           "ratio_to_base_step": step / base_step if base_step else None,
           "peak_memory_gb": peak / 1e9,
           "peak_over_held_gb": (peak - held) / 1e9, "launches": launches,
           "busy_share": busy / (step * 1e3) if busy else None,
           "lora_params": n_lora, "base_bit_unchanged": unchanged,
           "profile": prof}
    flat = tuner.lora_flat()
    tuner.export(os.path.join(out_dir, "tuned"), "tuned")
    log(f"lora (l0) base d={cfg.d_model} L={L} rank {LORA_RANK} b="
        f"{LORA_BATCH} S=2048: step {step:.4f} s ({rec['tokens_per_s']:.0f}"
        f" tokens/s; the main path's base step {base_step}), step-0 loss "
        f"{losses[0]:.6f} == base {base_loss:.6f}, losses {losses}, base "
        f"bit-unchanged, peak {rec['peak_memory_gb']:.2f} GB "
        f"({rec['peak_over_held_gb']:.2f} GB over what was held), busy "
        f"{rec['busy_share']}, launches {launches}, {n_lora} factor params")
    del tuner
    torch.cuda.empty_cache()
    return rec, flat


def lora_phase(torch, fa, export_dir, gap_cfg, prompts, f1, dev, base_step,
               base_served):
    """(l) multi-tenant LoRA at the base preset's full width; see the
    module docstring. ``f1`` holds phase (f1)'s LMGenerator tokens on the
    wide-gap f32 base weights. Returns the {"lora": ...} record."""
    from kubeflow_tpu_torch import chaos
    from kubeflow_tpu_torch.models.generate import LMGenerator
    from kubeflow_tpu_torch.models.transformer import TransformerLM
    from kubeflow_tpu_torch.serving.adapters import (
        merge_lora_params, random_lora_flat)
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.export import export_adapter
    from kubeflow_tpu_torch.serving.lm_server import LMPredictor
    from kubeflow_tpu_torch.serving.server import ModelServer

    out_dir = os.path.join(os.path.dirname(export_dir), "lora")
    rec = {"seconds": {}}
    t_sub = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        rec["seconds"][name] = now - t_sub[0]
        t_sub[0] = now

    # (l0) the fine-tune, then 7 more adapters as bench.py makes them
    rec["finetune"], tuned = lora_finetune(torch, fa, export_dir, out_dir,
                                           dev, base_step)
    lap("l0")
    flats = {"tuned": tuned}
    for i in range(1, LORA_ADAPTERS + 1):   # the last one serves (l5)
        flats[f"r{100 + i}"] = random_lora_flat(gap_cfg, LORA_RANK,
                                                seed=100 + i)
    sources = {n: export_adapter(os.path.join(out_dir, n), n, gap_cfg, fl,
                                 LORA_RANK, LORA_ALPHA)
               for n, fl in flats.items()}
    names = list(sources)[:LORA_ADAPTERS]
    spare = list(sources)[LORA_ADAPTERS]
    eight = {n: sources[n] for n in names}
    fa.reset_launches()

    # (l1) greedy parity on the wide-gap f32 weights: each adapter's
    # merged-weights LMGenerator on its own prompt, the smallest gap held
    # against the two paths' measured logit disagreement.
    g = torch.Generator(device=dev).manual_seed(0)
    model = TransformerLM(gap_cfg, device=dev, generator=g)
    wide_gap_(torch, model)
    sd = model.state_dict()
    tree = stacked_tree(torch, sd)
    want, gaps, ref_logits = [], [], []
    for i, n in enumerate(names):
        gen = LMGenerator(gap_cfg, merge_lora_params(
            tree, flats[n], LORA_RANK, LORA_ALPHA), device=dev)
        w, gap, lg = greedy_with_gap(gen, [prompts[i]], LORA_NEW,
                                     ENGINE_PROBE_STEP)
        want.append(w[0])
        gaps.append(gap)
        ref_logits.append(lg)
        del gen
    del tree
    torch.cuda.empty_cache()
    kw = dict(n_slots=ENGINE_SLOTS, chunk_tokens=ENGINE_CHUNK,
              kv_page_size=ENGINE_PAGE,
              prefill_chunk_tokens=ENGINE_PREFILL_CHUNK, device=dev,
              adapters=eight, adapter_rank=LORA_RANK)
    probe = DecodeEngine(gap_cfg, sd, name="lora-probe", prefix_cache=False,
                         adapter_slots=LORA_ADAPTERS, **kw)
    try:
        reqs = [probe.submit(p, ENGINE_PROBE_STEP, adapter=n)
                for p, n in zip(prompts, names)]
        for r in reqs:
            r.result(600)
        diff = max(max_abs(probe._logbuf[i:i + 1], ref_logits[i])
                   for i in range(LORA_ADAPTERS))
    finally:
        probe.close()
    gap = min(gaps)
    rec["min_gap"], rec["logits_max_abs_diff"] = gap, diff
    check(gap > GAP_MARGIN * diff,
          f"(l1) argmax gap {gap:.3g} too small against the gather and "
          f"merged paths' logit disagreement {diff:.3g}")
    eng = DecodeEngine(gap_cfg, sd, name="lora",
                       adapter_slots=LORA_ADAPTERS, **kw)
    try:
        t0 = time.perf_counter()
        reqs = [eng.submit(p, LORA_NEW, adapter=n)
                for p, n in zip(prompts, names)]
        got = [r.result(600) for r in reqs]
        rec["mixed_wave_seconds"] = time.perf_counter() - t0
        bad = [n for n, a, b in zip(names, got, want) if a != b]
        check(not bad, f"(l1) adapters {bad}: greedy tokens differ from "
                       "their merged-weights LMGenerator")
        base = eng.generate(prompts, LORA_NEW, adapter="")
        check(base == [w[:LORA_NEW] for w in f1["want"]],
              "(l1) base-only rows differ from the adapterless engine")
        st = eng.adapter_stats()
        pages = eng.page_stats()
        check(st["loads"] == LORA_ADAPTERS and st["free"] == st["slots"],
              f"(l1) adapter stats {st}")
        check(pages["free"] + pages["cached"] == pages["pages"],
              f"(l1) page leak: {pages}")
        rec["adapter_bytes"] = eng._apool.nbytes()
    finally:
        eng.close()
    lap("l1")
    log(f"lora (l1) f32 d={gap_cfg.d_model} L={gap_cfg.n_layers}: "
        f"{LORA_ADAPTERS} adapters over {LORA_ADAPTERS} slots, one batch "
        f"(every slot its own adapter) x {LORA_NEW}: greedy == each "
        f"adapter's merged LMGenerator (smallest gap {gap:.4g}, logits "
        f"within {diff:.3g}); base-only rows == (f1); stacks "
        f"{rec['adapter_bytes'] / 1e6:.2f} MB")

    # (l2) paging: 8 adapters over 4 slots. The pool's pins and unpins
    # are logged and replayed through a plain LRU model, which must give
    # the pool's loads, evictions and resident set.
    eng = DecodeEngine(gap_cfg, sd, name="lora-paged",
                       adapter_slots=LORA_PAGED_SLOTS, **kw)
    pool, ops = eng._apool, []
    real_acquire, real_release = pool.acquire, pool.release

    def acquire(name):
        slot = real_acquire(name)
        ops.append(("pin", name))
        return slot

    def release(slot):
        ops.append(("unpin", pool._names[slot]))
        real_release(slot)

    pool.acquire, pool.release = acquire, release
    try:
        reqs = [eng.submit(p, LORA_PAGED_NEW, adapter=n)
                for p, n in zip(prompts, names)]
        got = [r.result(600) for r in reqs]
        check(got == [w[:LORA_PAGED_NEW] for w in want],
              "(l2) tokens changed under adapter paging")
        st = eng.adapter_stats()
        model_lru = lru_replay(ops, LORA_PAGED_SLOTS)
        check(st["loads"] == LORA_ADAPTERS
              and st["evictions"] == LORA_ADAPTERS - LORA_PAGED_SLOTS
              and model_lru == (st["loads"], st["evictions"],
                                pool.loaded()),
              f"(l2) {st}, resident {pool.loaded()}, LRU model "
              f"{model_lru}")
        again = eng.generate([prompts[0]], LORA_PAGED_NEW, adapter=names[0])
        st2 = eng.adapter_stats()
        model_lru = lru_replay(ops, LORA_PAGED_SLOTS)
        check(again[0] == want[0][:LORA_PAGED_NEW]
              and model_lru == (st2["loads"], st2["evictions"],
                                pool.loaded()),
              f"(l2) reload {st2}, resident {pool.loaded()}, LRU model "
              f"{model_lru}")
        check(not pool.ref.any() and st2["free"] == LORA_PAGED_SLOTS,
              f"(l2) pinned slots left: {pool.ref}")
        rec["paging"] = {"slots": LORA_PAGED_SLOTS, "after_wave": st,
                         "after_reload": st2, "pins": len(ops) // 2}
    finally:
        eng.close()
    lap("l2")
    log(f"lora (l2) {LORA_ADAPTERS} adapters over {LORA_PAGED_SLOTS} "
        f"slots: tokens unchanged, {rec['paging']}")

    # (l3) speculation: the 6-layer draft wears the adapters
    draft = max(1, gap_cfg.n_layers // 4)
    eng = DecodeEngine(gap_cfg, sd, name="lora-spec",
                       adapter_slots=LORA_ADAPTERS, draft_layers=draft,
                       propose_tokens=SPEC_TOKENS, **kw)
    try:
        reqs = [eng.submit(p, LORA_NEW, adapter=n)
                for p, n in zip(prompts, names)]
        got = [r.result(600) for r in reqs]
        sst = eng.spec_stats()
        check(got == want, "(l3) speculating adapter engine's greedy "
                           "tokens differ")
        check(sst["proposed"] > 0, f"(l3) spec stats {sst}")
        rec["spec"] = dict(sst, accept_rate=sst["accepted"] / sst["proposed"],
                           draft_layers=draft,
                           adapter_bytes=eng._apool.nbytes())
    finally:
        eng.close()
    lap("l3")
    log(f"lora (l3) draft {draft} layers wearing the adapters: greedy "
        f"unchanged, {rec['spec']}")

    # (l5a) engine.adapter_load with fallback "base": the base's tokens,
    # one fallback counted, then the adapter heals.
    chaos.install(chaos.ChaosPlan(
        [chaos.Rule("engine.adapter_load", p=1.0, count=1)], seed=1))
    eng = DecodeEngine(gap_cfg, sd, name="lora-fb", adapter_slots=1,
                       adapter_fallback="base", **kw)
    try:
        out = eng.generate([prompts[0]], LORA_PAGED_NEW, adapter=names[0])
        fb = eng._reg().counter("kfx_lm_adapter_fallbacks_total")
        n_fb = sum(v for lb, v in fb.samples() if lb["model"] == "lora-fb")
        check(out[0] == f1["want"][0][:LORA_PAGED_NEW] and n_fb == 1,
              f"(l5) fallback base: {n_fb} fallbacks")
        out = eng.generate([prompts[0]], LORA_PAGED_NEW, adapter=names[0])
        check(out[0] == want[0][:LORA_PAGED_NEW],
              "(l5) the adapter did not heal")
    finally:
        eng.close()
        chaos.install(None)
    del model, sd
    torch.cuda.empty_cache()
    launches = dict(fa.LAUNCHES)
    check(all(v == 0 for v in launches.values()),
          f"(l1)-(l3) flash launches {launches}")
    lap("l5a")

    # (l4) the bf16 export behind the server with KFX_LM_ADAPTERS (the
    # eight, plus a ninth over 8 slots for (l5b)). The base-only side of
    # its comparisons is (f2)'s wave and (f3)'s chunk on the same export
    # (``base_served``), and the base engine's HBM its own total less the
    # adapter stacks (the base-only server this phase ran before was cut
    # to make room for phase (p)).
    fa.reset_launches()
    one = lambda p, n: {"prompt_tokens": [p], "max_new_tokens": SERVE_NEW,
                        "adapter": n}
    env = {"KFX_LM_ADAPTERS": json.dumps(
               {n: "file://" + d for n, d in sources.items()}),
           "KFX_LM_ADAPTER_SLOTS": str(LORA_ADAPTERS),
           "KFX_LM_ADAPTER_FALLBACK": "error", "KFX_LM_SPEC": "0"}
    os.environ.update(env)
    try:
        pred = LMPredictor(export_dir, name="lm", device=dev.type)
        pred.load()
    finally:
        for k in env:
            del os.environ[k]
    pred._warm_thread.join(600)
    server = ModelServer(port=0)
    server.register(pred)
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    gen_url = f"{url}/v1/models/lm:generate"
    try:
        # Page every adapter in (a one-token prompt, no prefix shared
        # with the wave) so the timed wave is decode, as on the base.
        run_threads(lambda n: http_json(gen_url, {
            "prompt_tokens": [[1]], "max_new_tokens": 1, "adapter": n}),
            names)
        t0 = time.perf_counter()
        bodies = run_threads(lambda a: http_json(gen_url, one(*a)),
                             list(zip(prompts, names)))
        wall = time.perf_counter() - t0
        toks = [b["generated_tokens"][0] for b in bodies]
        check(all(len(t) == SERVE_NEW for t in toks),
              f"(l4) answers {[len(t) for t in toks]}")
        blk = http_json(f"{url}/metrics?format=json")["engine"]["lm"]
        text = http_json(f"{url}/metrics")
        missing = [f for f in (
            "kfx_lm_adapter_slots", "kfx_lm_adapter_slots_free",
            "kfx_lm_adapter_loads_total", "kfx_lm_adapter_evictions_total",
            "kfx_lm_adapter_fallbacks_total",
            "kfx_lm_adapter_requests_total") if f not in text]
        check(not missing, f"(l4) adapter families missing: {missing}")
        check(blk.get("adapter_slots") == LORA_ADAPTERS,
              f"(l4) engine block {blk}")
        # (l5b) fallback "error": the ninth adapter's load fails once ->
        # 503 + Retry-After, then it serves.
        chaos.install(chaos.ChaosPlan(
            [chaos.Rule("engine.adapter_load", p=1.0, count=1)], seed=1))
        try:
            code, _, hdr = post_status(gen_url, one(prompts[0], spare))
        finally:
            chaos.install(None)
        check(code == 503 and hdr.get("Retry-After") is not None,
              f"(l5) fallback error answered {code} {dict(hdr)}")
        ok = http_json(gen_url, dict(one(prompts[0], spare),
                                     max_new_tokens=INT8_WARM_NEW))
        check(len(ok["generated_tokens"][0]) == INT8_WARM_NEW,
              "(l5) the ninth adapter did not heal")
        rec["chaos"] = {"fallback_base": "base tokens, 1 counted, healed",
                        "fallback_error": code}
    finally:
        server.stop()
    eng = pred.engine
    eng.close()
    chunk_ms, enq, prof = chunk_by_hand(torch, eng, prompts, names)
    busy = prof.get("kernel_ms")
    a = {"tokens_per_s": len(prompts) * SERVE_NEW / wall,
         "wave_seconds": wall, "hbm_bytes": eng.hbm_bytes(),
         "chunk_ms": chunk_ms, "host_enqueue_ms": enq,
         "kernels": prof.get("kernels"), "kernel_ms": busy,
         "busy_share": busy / chunk_ms if busy else None,
         "top_kernels_ms": prof.get("top_kernels_ms")}
    del pred, eng, server
    torch.cuda.empty_cache()
    b = base_served
    base_hbm = a["hbm_bytes"]["total"] - a["hbm_bytes"]["adapters"]
    rec["served"] = {"adapters": a, "base_f2_f3": b}
    rec["hbm_ratio"] = a["hbm_bytes"]["total"] / base_hbm
    rec["chunk_ratio"] = a["chunk_ms"] / b["chunk_ms"]
    rec["tokens_per_s_ratio"] = a["tokens_per_s"] / b["tokens_per_s"]
    rec["flash_launches"] = dict(fa.LAUNCHES)
    check(all(v == 0 for v in rec["flash_launches"].values()),
          f"(l4)/(l5) flash launches {rec['flash_launches']}")
    lap("l4_l5b")
    log(f"lora (l4) bf16 export, {LORA_ADAPTERS} concurrent :generate x "
        f"{SERVE_NEW}, each its own adapter: {a['tokens_per_s']:.1f} "
        f"tokens/s against (f2)'s base-only {b['tokens_per_s']:.1f}; HBM "
        f"{a['hbm_bytes']['total'] / 1e9:.3f} GB vs "
        f"{base_hbm / 1e9:.3f} GB without the stacks (ratio "
        f"{rec['hbm_ratio']:.4f}); chunk at {ENGINE_SLOTS} slots "
        f"{a['chunk_ms']:.2f} ms ({a['kernels']} kernels, enqueue "
        f"{a['host_enqueue_ms']:.2f} ms, busy {a['busy_share']}) vs (f3)'s "
        f"{b['chunk_ms']:.2f} ms; (l5) "
        f"{rec['chaos']}; flash launches {rec['flash_launches']}; "
        f"seconds {json.dumps(rec['seconds'])}")
    return rec


# -- (m) the request plane and the KV transfer plane ---------------------------

def counter_value(eng, family, **labels):
    """The engine's sample of ``family`` with its model label and
    ``labels`` (0 when absent)."""
    want = dict(model=eng.name, **labels)
    return sum(v for lab, v in eng._reg().counter(family).samples()
               if lab == want)


def expect_raise(exc_type, fn, what):
    """Call ``fn``; fail unless it raises ``exc_type``. Returns the
    exception."""
    try:
        fn()
    except exc_type as e:
        return e
    raise AssertionError(f"{what}: no {exc_type.__name__}")


def request_plane_checks(torch, cfg, params, dev):
    """(m0) on the bf16 export's weights at max_seq_len RP_SEQ: the
    expired-deadline and infeasible-deadline sheds, batch shedding for an
    interactive arrival and the batch victim first under pool pressure."""
    import dataclasses

    from kubeflow_tpu_torch import chaos
    from kubeflow_tpu_torch.serving.engine import (
        DeadlineInfeasible, DecodeEngine, EngineOverloaded)

    rp_cfg = dataclasses.replace(cfg, max_seq_len=RP_SEQ)
    kw = dict(chunk_tokens=ENGINE_CHUNK, kv_page_size=ENGINE_PAGE,
              device=dev)
    out = {}
    eng = DecodeEngine(rp_cfg, params, n_slots=1, name="rp", **kw)

    def stall(delay):
        chaos.install(chaos.parse_spec(
            f"engine.admit:mode=delay,delay={delay},count=1"))

    try:
        eng.warm([8])
        # A request whose deadline lapses in the queue sheds before its
        # prefill: no token, no admission stamp, the stream's sentinel.
        stall(0.4)
        holder = eng.submit([1, 2, 3], max_new_tokens=8)
        sink = []
        doomed = eng.submit([4, 5], max_new_tokens=4, deadline_s=0.05,
                            on_token=sink.append)
        expect_raise(DeadlineInfeasible, lambda: doomed.result(60),
                     "expired deadline")
        chaos.install(None)
        holder.result(120)
        check(doomed.tokens == [] and doomed.t_admitted == 0.0
              and sink == [None], "the expired request was prefilled")
        # A warm queue-wait estimate refuses an infeasible deadline at
        # submit.
        stall(0.25)
        a = eng.submit([1, 2], max_new_tokens=2)
        b = eng.submit([3, 4], max_new_tokens=2)
        b.result(120)
        a.result(120)
        ewma = eng._qwait_ewma
        check(ewma > 0.01, f"queue-wait estimate {ewma}")
        stall(0.5)
        c = eng.submit([1, 2], max_new_tokens=32)
        d = eng.submit([3, 4], max_new_tokens=2)
        e = expect_raise(DeadlineInfeasible, lambda: eng.submit(
            [5, 6], max_new_tokens=2, deadline_s=0.001), "infeasible")
        check(e.retry_after_s == 1.0, f"Retry-After {e.retry_after_s}")
        d.result(120)
        c.result(120)
        chaos.install(None)
        # Queue pressure: an interactive arrival sheds the newest queued
        # batch request; a batch arrival is refused.
        eng.max_queue = 2
        stall(1.0)
        busy = eng.submit([1, 2, 3], max_new_tokens=8)
        t_end = time.monotonic() + 30
        while eng.queue_depth and time.monotonic() < t_end:
            time.sleep(0.001)
        b1 = eng.submit([4, 5], max_new_tokens=2, qos="batch")
        b2 = eng.submit([6, 7], max_new_tokens=2, qos="batch")
        expect_raise(EngineOverloaded, lambda: eng.submit(
            [10, 11], max_new_tokens=2, qos="batch"), "batch overflow")
        keep = eng.submit([8, 9], max_new_tokens=2)
        e = expect_raise(EngineOverloaded, lambda: b2.result(60),
                         "batch shed")
        check("shed for interactive" in str(e), str(e))
        check(len(keep.result(120)) == 2 and len(b1.result(120)) == 2
              and len(busy.result(120)) == 8, "queue-pressure requests")
        chaos.install(None)
        out["deadline_shed"] = counter_value(
            eng, "kfx_lm_deadline_shed_total")
        check(out["deadline_shed"] == 2,
              f"kfx_lm_deadline_shed_total {out['deadline_shed']}")
        out["qwait_ewma_s"] = ewma
    finally:
        chaos.install(None)
        eng.close()
    # Pool pressure with both classes in flight: the batch slots are the
    # victims (batch submitted first, so the class outranks age).
    eng = DecodeEngine(rp_cfg, params, n_slots=4, name="rp-qos",
                       kv_pages=RP_SEQ // ENGINE_PAGE, prefix_cache=False,
                       **kw)
    try:
        batch = [eng.submit([i + 1, i + 2, i + 3], max_new_tokens=RP_NEW,
                            qos="batch") for i in range(2)]
        inter = [eng.submit([i + 11, i + 12, i + 13],
                            max_new_tokens=RP_NEW) for i in range(2)]
        check(all(len(r.result(300)) == RP_NEW for r in batch + inter),
              "pool-pressure requests did not finish")
        pages = eng.page_stats()
        out["preempted"] = {"batch": [r.preempts for r in batch],
                            "interactive": [r.preempts for r in inter]}
        check(sum(out["preempted"]["batch"]) >= 1
              and out["preempted"]["interactive"] == [0, 0],
              f"preemption victims {out['preempted']}")
        check(pages["free"] == pages["pages"], f"page leak {pages}")
    finally:
        eng.close()
    return out


def rate_limit_check(export_dir, dev):
    """(m0) over HTTP: a tenant over its token budget is answered 503 with
    the deficit's Retry-After, on the bf16 export behind ModelServer."""
    from kubeflow_tpu_torch.serving.lm_server import LMPredictor
    from kubeflow_tpu_torch.serving.server import ModelServer

    env = {"KFX_LM_SPEC": "0", "KFX_LM_RATE_LIMITS": json.dumps({"": 4}),
           "KFX_LM_RATE_BURST_S": "10"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        pred = LMPredictor(export_dir, name="lm", device=dev.type,
                           warm_buckets=[8])
        pred.load()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    server = ModelServer(port=0)
    server.register(pred)
    server.start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        gen = f"{url}/v1/models/lm:generate"
        # 8 + 64 = 72 tokens against a 40-token budget: admitted (the
        # budget was positive), overdrawn by 32 at 4 tokens/s, which the
        # first request's own decode time cannot refill.
        body = {"prompt_tokens": [list(range(1, 9))], "max_new_tokens": 64}
        check(len(http_json(gen, body)["generated_tokens"][0]) == 64,
              "rate-limited tenant's first request")
        code, ans, headers = post_status(gen, body)
        retry = float(headers.get("Retry-After", "0"))
        check(code == 503 and "budget" in ans.get("error", "")
              and retry >= 1.0,
              f"over-budget request answered {code} {ans} Retry-After "
              f"{retry}")
        metrics = http_json(f"{url}/metrics")
        m = re.search(r'kfx_lm_rate_limited_total\{model="lm"\} (\S+)',
                      metrics)
        check(m is not None and float(m.group(1)) == 1,
              "kfx_lm_rate_limited_total")
        return {"code": code, "retry_after": retry,
                "rate_limited": float(m.group(1))}
    finally:
        server.stop()
        pred.close()


def pace(seconds):
    """An on_token sink that holds the loop ``seconds`` a token: a single
    request keeps decoding on the donor until its migration's
    acknowledgement, so the transfer is timed against a live request."""
    return lambda tok: time.sleep(seconds) if tok is not None else None


def migrate_timed(donor, recv, reqs, n_after):
    """Wait until every request in ``reqs`` holds ``n_after`` tokens, then
    migrate them all ``donor`` -> ``recv``, timing each leg: the export
    (page gather, host copy and encode on the donor's loop) and the import
    (chain verify, page scatter and install). Returns (stats, legs,
    adopted requests in ``reqs`` order)."""
    t_end = time.monotonic() + 300
    while min(len(r.tokens) for r in reqs) < n_after:
        check(time.monotonic() < t_end, "requests never reached the "
                                        "migration point")
        time.sleep(0.001)
    legs, by_rid = [], {}
    export = donor._export_slot

    def timed_export(slot):
        t0 = time.perf_counter()
        req, payload, npages = export(slot)
        legs.append({"rid": req.rid, "pages": npages,
                     "bytes": len(payload),
                     "export_ms": (time.perf_counter() - t0) * 1e3})
        return req, payload, npages

    def send(payload):
        t0 = time.perf_counter()
        adopted = recv.kv_import(payload)
        leg = next(g for g in legs if "import_ms" not in g)
        leg["import_ms"] = (time.perf_counter() - t0) * 1e3
        by_rid[leg["rid"]] = adopted
        return recv.name

    donor._export_slot = timed_export
    try:
        stats = donor.migrate_out(reason="rebalance", send=send)
    finally:
        del donor._export_slot
    for g in legs:
        g["export_gb_s"] = g["bytes"] / g["export_ms"] / 1e6
        g["import_gb_s"] = g["bytes"] / g["import_ms"] / 1e6
    return stats, legs, [by_rid.get(r.rid) for r in reqs]


def balanced(eng):
    st = eng.page_stats()
    return st["free"] + st["cached"] == st["pages"], st


def kv_phase(torch, fa, export_dir, gap_cfg, prompts, f1, dev):
    """(m) the request plane and the KV transfer plane on the card; see
    the module docstring. ``f1["want"]`` holds phase (f1)'s LMGenerator
    tokens of ``prompts`` on the wide-gap f32 weights. Returns the
    {"kv": ...} record."""
    import numpy as np

    from kubeflow_tpu_torch import chaos
    from kubeflow_tpu_torch.models.transformer import TransformerLM
    from kubeflow_tpu_torch.serving import kvtransfer
    from kubeflow_tpu_torch.serving.engine import (DecodeEngine,
                                                   RequestMigrated)
    from kubeflow_tpu_torch.serving.lm_server import load_lm

    rec = {"seconds": {}}
    t_sub = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        rec["seconds"][name] = now - t_sub[0]
        t_sub[0] = now

    fa.reset_launches()
    cfg, params = load_lm(export_dir)
    kw = dict(n_slots=ENGINE_SLOTS, chunk_tokens=ENGINE_CHUNK,
              kv_page_size=ENGINE_PAGE,
              prefill_chunk_tokens=ENGINE_PREFILL_CHUNK, device=dev)

    # (m0) the request plane
    rec["m0"] = request_plane_checks(torch, cfg, params, dev)
    rec["m0"]["rate_limit"] = rate_limit_check(export_dir, dev)
    log(f"kv (m0) request plane: deadline sheds "
        f"{rec['m0']['deadline_shed']} (queue-wait EWMA "
        f"{rec['m0']['qwait_ewma_s']:.3f} s), batch shed for an "
        f"interactive arrival, over-budget tenant "
        f"{rec['m0']['rate_limit']}, victims under pool pressure "
        f"{rec['m0']['preempted']}")
    lap("m0")

    # (m1) live migration of the 8 prompts, greedy, on the wide-gap f32
    # weights: the adopted tokens equal (f1)'s LMGenerator and the
    # unmigrated run; then one seeded sampled stream.
    g = torch.Generator(device=dev).manual_seed(0)
    model = TransformerLM(gap_cfg, device=dev, generator=g)
    wide_gap_(torch, model)
    sd = model.state_dict()
    # The donors run without a prefix cache: a repeated prompt then takes
    # the same prefill as its unmigrated run, so tokens compare exactly.
    donor = DecodeEngine(gap_cfg, sd, name="kv-donor", prefix_cache=False,
                         **kw)
    recv = DecodeEngine(gap_cfg, sd, name="kv-recv", **kw)
    del model
    try:
        before = {"donor": donor.page_stats(), "recv": recv.page_stats()}
        # KV_MIGRATE_NEW tokens, so that every request is still decoding
        # on the donor when its acknowledgement comes: the donor detaches
        # one request per iteration boundary.
        longer = donor.generate(prompts, KV_MIGRATE_NEW)
        check([t[:SERVE_NEW] for t in longer] == f1["want"],
              "the unmigrated run's first tokens differ from (f1)")
        reqs = donor.submit_batch(prompts, KV_MIGRATE_NEW)
        stats, legs, adopted = migrate_timed(donor, recv, reqs,
                                             KV_MIGRATE_AFTER)
        check(stats["moved"] == len(prompts), f"migration stats {stats}")
        for r in reqs:
            expect_raise(RequestMigrated, lambda: r.result(60),
                         "migrated request")
        got = [a.result(300) for a in adopted]
        bad = [i for i, (x, y) in enumerate(zip(got, longer)) if x != y]
        check(not bad, f"migrated greedy tokens differ in rows {bad}")
        kwargs = dict(temperature=0.8, top_k=40, seed=7)
        want_s = donor.generate([prompts[0]], SERVE_NEW, **kwargs)[0]
        sreq = donor.submit(prompts[0], SERVE_NEW, on_token=pace(0.03),
                            **kwargs)
        s_stats, _, s_adopted = migrate_timed(donor, recv, [sreq],
                                              KV_MIGRATE_AFTER)
        check(s_stats["moved"] == 1, f"seeded migration {s_stats}")
        check(s_adopted[0].result(300) == want_s,
              "migrated seeded stream differs from the unmigrated one")
        after = {"donor": donor.page_stats(), "recv": recv.page_stats()}
        for e in (donor, recv):
            ok, st = balanced(e)
            check(ok, f"{e.name} pages do not balance: {st}")
    finally:
        donor.close()
        recv.close()
    del sd
    torch.cuda.empty_cache()
    rec["m1"] = {"moved": stats["moved"], "pages": stats["pages"],
                 "legs": legs, "pages_before": before,
                 "pages_after": after, "tokens_at_export": [
                     a.meter_skip for a in adopted]}
    log(f"kv (m1) f32 wide-gap: {stats['moved']} requests migrated after "
        f">= {KV_MIGRATE_AFTER} tokens ({stats['pages']} pages), greedy "
        f"== unmigrated ({KV_MIGRATE_NEW} tokens; the first {SERVE_NEW} "
        f"== LMGenerator); seeded stream == unmigrated; "
        f"free pages before {before}, after {after}")
    for g_ in legs:
        log(f"kv (m1) leg rid={g_['rid']} pages={g_['pages']} "
            f"bytes={g_['bytes']} export {g_['export_ms']:.2f} ms "
            f"({g_['export_gb_s']:.3f} GB/s) import {g_['import_ms']:.2f} "
            f"ms ({g_['import_gb_s']:.3f} GB/s)")
    lap("m1_f32")

    # (m1) the long request and (m3) chaos, on the bf16 export
    rng = np.random.default_rng(11)
    long_prompt = rng.integers(0, cfg.vocab_size, KV_LONG_PROMPT).tolist()
    donor = DecodeEngine(cfg, params, name="kv-bf16-donor",
                         prefix_cache=False, **kw)
    recv = DecodeEngine(cfg, params, name="kv-bf16-recv", **kw)
    try:
        want = donor.generate([long_prompt], SERVE_NEW)[0]
        req = donor.submit(long_prompt, SERVE_NEW, on_token=pace(0.03))
        stats, legs, adopted = migrate_timed(donor, recv, [req],
                                             KV_MIGRATE_AFTER)
        check(stats["moved"] == 1, f"long migration {stats}")
        check(adopted[0].result(300) == want,
              "the long request's migrated tokens differ from its "
              "unmigrated run")
        rec["m1"]["long"] = dict(legs[0], prompt=KV_LONG_PROMPT,
                                 new=SERVE_NEW,
                                 kv_bytes_per_token=donor.kv_bytes_per_token,
                                 page_bytes=donor.page_bytes)
        log(f"kv (m1) bf16 {KV_LONG_PROMPT}+{SERVE_NEW} tokens: "
            f"{legs[0]['pages']} pages, {legs[0]['bytes']} bytes, export "
            f"{legs[0]['export_ms']:.2f} ms ({legs[0]['export_gb_s']:.3f} "
            f"GB/s), import {legs[0]['import_ms']:.2f} ms "
            f"({legs[0]['import_gb_s']:.3f} GB/s); tokens == unmigrated")
        lap("m1_long")
        # (m3) a severed transfer loses nothing
        short = prompts[0]
        want = donor.generate([short], CHAOS_NEW)[0]
        req = donor.submit(short, CHAOS_NEW)
        t_end = time.monotonic() + 120
        while len(req.tokens) < KV_MIGRATE_AFTER:
            check(time.monotonic() < t_end, "no tokens")
            time.sleep(0.001)
        def unreachable(payload):
            raise AssertionError("chaos must sever before the send")

        chaos.install(chaos.parse_spec("kv.transfer:count=1"))
        try:
            severed = donor.migrate_out(send=unreachable)
        finally:
            chaos.install(None)
        check(severed == {"moved": 0, "failed": 1, "pages": 0},
              f"severed transfer {severed}")
        check(req.result(300) == want, "the severed request lost tokens")
        # (m3) a corrupt frame is discarded whole, no page leaked
        grabbed = []

        def capture(payload):
            grabbed.append(payload)
            raise kvtransfer.TransferError("captured")

        req = donor.submit(short, CHAOS_NEW)
        while len(req.tokens) < KV_MIGRATE_AFTER:
            time.sleep(0.001)
        donor.migrate_out(send=capture)
        check(req.result(300) == want, "the donor lost its copy")
        free = recv.page_stats()["free"]
        bad = bytearray(grabbed[0])
        bad[-40] ^= 1
        expect_raise(kvtransfer.TransferCorrupt,
                     lambda: recv.kv_import(bytes(bad)), "corrupt frame")
        check(recv.page_stats()["free"] == free, "corrupt import leaked")
        check(recv.kv_import(grabbed[0]).result(300) == want,
              "the pristine payload did not resume")
        for e in (donor, recv):
            ok, st = balanced(e)
            check(ok, f"{e.name} pages do not balance: {st}")
        rec["m3"] = {"severed": severed, "corrupt_refused": True,
                     "recv_free_pages": free}
        log(f"kv (m3) kv.transfer:count=1 -> {severed}, tokens intact; "
            f"corrupt frame refused, receiver free pages {free} "
            f"unchanged; pristine payload resumed")
    finally:
        donor.close()
        recv.close()
    torch.cuda.empty_cache()
    lap("m3")

    # (m2) prefill/decode hand-off over loopback HTTP
    rec["m2"] = handoff_check(export_dir, prompts, dev)
    lap("m2")

    # (m4) the host offload tier on the wide-gap f32 weights
    rec["m4"] = offload_check(torch, gap_cfg, dev)
    lap("m4")
    rec["flash_launches"] = dict(fa.LAUNCHES)
    check(all(v == 0 for v in rec["flash_launches"].values()),
          f"(m) flash launches {rec['flash_launches']}")
    rec["phase_seconds"] = sum(rec["seconds"].values())
    log(f"kv (m) seconds {json.dumps(rec['seconds'])}; flash launches "
        f"{rec['flash_launches']}")
    return rec


def sse_events(url, payload, t_start, timeout=600):
    """One ``"stream": true`` :generate read event by event until the end
    or a cut: (token events, seconds from ``t_start`` to the first, done
    event or None)."""
    import http.client

    req = urllib.request.Request(url, data=json.dumps(
        dict(payload, stream=True)).encode())
    toks, first, done = [], None, None
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                ev = json.loads(line[len("data: "):])
                if ev.get("done"):
                    done = ev
                    break
                check("token" in ev, f"SSE error event {ev}")
                if first is None:
                    first = time.perf_counter() - t_start
                toks.append(ev)
    except (http.client.IncompleteRead, ConnectionError, OSError):
        pass  # the migrated stream's cut
    return toks, first, done


def handoff_check(export_dir, prompts, dev):
    """(m2): a KFX_LM_ROLE=prefill server with KFX_LM_KV_PEERS at a
    decode server, both on the bf16 export in this process. Buffered: the
    prefill server answers 503 + X-Kfx-Migrated, and the same body at that
    peer claims the adopted generation; tokens equal the decode server's
    own (mixed) answer. Streamed: the prefill server's stream is cut at
    the hand-off and the peer resumes it with stream_skip; TTFT of both
    paths."""
    from kubeflow_tpu_torch.serving.lm_server import LMPredictor
    from kubeflow_tpu_torch.serving.server import ModelServer

    def serve(env):
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            pred = LMPredictor(export_dir, name="lm", device=dev.type,
                               warm_buckets=[8])
            pred.load()
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        srv = ModelServer(port=0)
        srv.register(pred)
        srv.start()
        return srv, pred

    # No prefix cache: a repeated body then takes the same prefill, so
    # the buffered, streamed and handed-off tokens compare exactly in bf16.
    plain = {"KFX_LM_SPEC": "0", "KFX_LM_PREFIX_CACHE": "0"}
    dec_srv, dec = serve(plain)
    dec_url = f"http://127.0.0.1:{dec_srv.port}"
    pf_srv, pf = serve(dict(plain, KFX_LM_ROLE="prefill",
                            KFX_LM_KV_PEERS=json.dumps([dec_url])))
    out = {"rows": []}
    try:
        check(pf.engine.role == "prefill", "prefill role not set")
        dec_gen = f"{dec_url}/v1/models/lm:generate"
        pf_gen = f"http://127.0.0.1:{pf_srv.port}/v1/models/lm:generate"
        for p in prompts[:HANDOFF_ROWS]:
            body = {"prompt_tokens": [p], "max_new_tokens": CUT_NEW}
            want = http_json(dec_gen, body)["generated_tokens"][0]
            t0 = time.perf_counter()
            mixed, ttft_mixed, _ = sse_events(dec_gen, body, t0)
            check([e["token"] for e in mixed] == want,
                  "mixed stream differs from its buffered answer")
            code, ans, headers = post_status(pf_gen, body)
            hint = headers.get("X-Kfx-Migrated")
            check(code == 503 and hint == f"127.0.0.1:{dec_srv.port}",
                  f"prefill server answered {code} {ans} hint={hint!r}")
            got = http_json(f"http://{hint}/v1/models/lm:generate",
                            body)["generated_tokens"][0]
            check(got == want, "hand-off tokens differ from the mixed "
                               "server's")
            t0 = time.perf_counter()
            head, ttft_pf, done = sse_events(pf_gen, body, t0)
            check(done is None, "the prefill server finished the stream")
            rest, ttft_dec, done = sse_events(
                dec_gen, dict(body, stream_skip=len(head)), t0)
            check(done is not None, "the resumed stream did not finish")
            toks = [e["token"] for e in head + rest]
            check(toks == want and [e["index"] for e in head + rest]
                  == list(range(CUT_NEW)),
                  "the handed-off stream differs from the mixed one")
            out["rows"].append({
                "prompt": len(p), "ttft_mixed_s": ttft_mixed,
                "ttft_handoff_s": ttft_pf if head else ttft_dec,
                "tokens_before_cut": len(head)})
        out["migrations"] = counter_value(
            pf.engine, "kfx_lm_kv_migrations_total", reason="disagg")
        check(out["migrations"] == 2 * HANDOFF_ROWS,
              f"disagg migrations {out['migrations']}")
    finally:
        pf_srv.stop()
        dec_srv.stop()
        pf.close()
        dec.close()
    log(f"kv (m2) prefill -> decode over loopback HTTP, {HANDOFF_ROWS} "
        f"prompts x {CUT_NEW}: tokens == the mixed server's (buffered "
        f"and streamed); rows {out['rows']}")
    return out


def offload_check(torch, gap_cfg, dev):
    """(m4): one slot over a pool of one max-length request (64 pages);
    three prompts of OFFLOAD_PROMPT tokens push the first one's pages out
    to the host tier, and the first prompt again promotes them: the
    promoted bytes equal the demoted ones, the tokens are unchanged, and
    the prefix hits count it."""
    import numpy as np

    from kubeflow_tpu_torch.models.transformer import TransformerLM
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.prefix import chain_hash

    g = torch.Generator(device=dev).manual_seed(0)
    model = TransformerLM(gap_cfg, device=dev, generator=g)
    wide_gap_(torch, model)
    sd = model.state_dict()
    del model
    n_blocks = gap_cfg.max_seq_len // ENGINE_PAGE
    eng = DecodeEngine(gap_cfg, sd, n_slots=1, chunk_tokens=ENGINE_CHUNK,
                       kv_page_size=ENGINE_PAGE, kv_pages=n_blocks,
                       kv_offload_pages=2 * n_blocks, name="kv-offload",
                       device=dev)
    try:
        rng = np.random.default_rng(12)
        ps = [rng.integers(0, gap_cfg.vocab_size, OFFLOAD_PROMPT).tolist()
              for _ in range(3)]
        firsts = [eng.generate([p], OFFLOAD_NEW)[0] for p in ps]
        tier = eng._offload
        key = chain_hash(b"", ps[0][:ENGINE_PAGE])
        demoted = tier.get(key)
        check(demoted is not None and len(demoted) == eng.page_bytes,
              f"first page not demoted ({tier.demoted} demotions)")
        hits = eng.prefix_stats()["hits"]
        promoted0 = tier.promoted
        t0 = time.perf_counter()
        again = eng.generate([ps[0]], OFFLOAD_NEW)[0]
        wall = time.perf_counter() - t0
        check(again == firsts[0], "tokens changed after promotion")
        page = eng._prefix.full[key].page
        check(eng._run_on_loop(lambda: eng._page_payload(page)) == demoted,
              "promoted page bytes differ from the demoted ones")
        st = eng.prefix_stats()
        check(st["hits"] == hits + 1, f"prefix hits {st}")
        ok, pages = balanced(eng)
        check(ok, f"offload engine pages {pages}")
        out = {"demoted": tier.demoted, "promoted": tier.promoted
               - promoted0, "page_bytes": eng.page_bytes,
               "tokens_reused": st["tokens_reused"],
               "repeat_seconds": wall, "pages": pages}
    finally:
        eng.close()
    log(f"kv (m4) host tier: {out['demoted']} pages demoted, "
        f"{out['promoted']} promoted on the repeat ({out['page_bytes']} "
        f"bytes a page, bytes equal), tokens unchanged, prefix hit "
        f"counted; repeat in {wall:.3f} s")
    return out


# -- (i) the classifier / JAXJob path ---------------------------------------

def classifier_models_check(torch, dev):
    """(i0) every registered classifier (and ResNet-50 on the ImageNet
    stem) in f32 with TF32 off: the same weights (converted to the flax
    tree and back) and inputs on the card and on the CPU, eval and train
    mode; then one ResNet-50 train step on
    the card (bf16, the default) with each BatchNorm's running stats held
    to an explicit biased-variance update of its captured input."""
    from kubeflow_tpu_torch.models import get_model, model_names
    from kubeflow_tpu_torch.models.convert import (
        classifier_params_from_jax, classifier_params_to_jax)
    from kubeflow_tpu_torch.training import TrainLoop

    shapes = [(n, (28, 28, 1) if n in ("mlp", "cnn") else (32, 32, 3))
              for n in model_names()] + [("resnet50", (224, 224, 3))]
    errs = {}
    for name, shape in shapes:
        cpu = get_model(name, input_shape=shape, dtype=torch.float32, seed=1)
        # The card's copy takes the CPU model's weights through the flax
        # tree and back (the converter both directions of an export use).
        card = get_model(name, input_shape=shape, dtype=torch.float32,
                         seed=2)
        card.load_state_dict(classifier_params_from_jax(
            name, *classifier_params_to_jax(name, cpu.state_dict())))
        card.to(dev, memory_format=torch.channels_last)
        x = torch.rand((4,) + shape, generator=torch.Generator().manual_seed(2))
        err = 0.0
        for train in (False, True):
            with torch.no_grad():
                err = max(err, max_rel(card(x.to(dev), train=train).cpu(),
                                       cpu(x, train=train)))
        key = f"{name}@{shape[0]}"
        errs[key] = err
        check(err <= CLS_TOL_F32, f"(i0) {key} cuda vs cpu {err:.3g}")
        del cpu, card
    log("classifier (i0) f32 forward cuda vs cpu, max-abs rel: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tol {CLS_TOL_F32})")

    shape = (32, 32, 3)
    loop = TrainLoop(get_model("resnet50", input_shape=shape), device=dev)
    state = loop.init_state(shape)
    seen = []

    def capture(mod, args):
        seen.append((mod, args[0].detach().float(), mod.mean.clone(),
                     mod.var.clone()))

    from kubeflow_tpu_torch.models.layers import BatchNorm

    hooks = [m.register_forward_pre_hook(capture)
             for m in state.model.modules() if isinstance(m, BatchNorm)]
    g = torch.Generator().manual_seed(3)
    x = torch.rand((32,) + shape, generator=g).numpy()
    y = torch.randint(0, 10, (32,), generator=g).numpy()
    state, loss, _ = loop.train_step(state, x, y)
    for h in hooks:
        h.remove()
    check(math.isfinite(loss), f"(i0) ResNet-50 step loss {loss}")
    err, gap = 0.0, 0.0
    for mod, inp, mean0, var0 in seen:
        mean = inp.mean((0, 2, 3))
        var = ((inp - mean[:, None, None]) ** 2).mean((0, 2, 3))   # biased
        n = inp.numel() // inp.shape[1]
        want_var = 0.9 * var0 + 0.1 * var
        err = max(err, max_rel(mod.mean, 0.9 * mean0 + 0.1 * mean),
                  max_rel(mod.var, want_var))
        unbiased = 0.9 * var0 + 0.1 * var * n / (n - 1)
        gap = max(gap, max_rel(unbiased, want_var))
    log(f"classifier (i0) ResNet-50 train step b32: loss {loss:.4f}; "
        f"{len(seen)} BatchNorms, running stats vs the biased update max "
        f"rel {err:.3g} (tol {CLS_TOL_STATS}); the unbiased update would "
        f"differ by up to {gap:.3g}")
    check(len(seen) == 53, f"(i0) {len(seen)} BatchNorms ran, want 53")
    check(err <= CLS_TOL_STATS and err * 10 < gap,
          f"(i0) BN running stats {err:.3g} (unbiased gap {gap:.3g})")
    del loop, state, seen
    torch.cuda.empty_cache()
    return {"forward_max_rel_err": errs, "bn_stats_max_rel_err": err,
            "bn_unbiased_gap": gap}


def classifier_rung(torch, dev, dataset, batch, export_dir=""):
    """(i1) the runner trains ResNet-50 on ``dataset`` at ``batch`` with
    device batches (--data-pipeline auto), CLS_STEPS steps in chunks of 2;
    step ms (median of the chunks after the first), images/s, GFLOP an
    image (FlopCounterMode over one step), MFU, peak memory and the busy
    share of a profiled step."""
    from torch.utils.flop_counter import FlopCounterMode

    from kubeflow_tpu_torch.data import get_dataset
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.runners import jax_runner
    from kubeflow_tpu_torch.training import TrainLoop
    from kubeflow_tpu_torch.utils.flops import peak_flops_per_card

    argv = ["--model", "resnet50", "--dataset", dataset, "--batch-size",
            str(batch), "--steps", str(CLS_STEPS), "--log-every", "2",
            "--scan-steps", "2", "--eval-samples", str(CLS_EVAL),
            "--data-pipeline", "auto"]
    if export_dir:
        argv += ["--export-dir", export_dir]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = jax_runner.main(argv)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = buf.getvalue()
    tag = f"(i1) resnet50 {dataset} b{batch}"
    check(rc == 0, f"{tag}: runner returned {rc}")
    check("data_pipeline=device" in out and f"platform={dev.type}" in out,
          f"{tag}: not on device batches on {dev}:\n{out}")
    losses = [float(v) for v in re.findall(r"^step=\d+ loss=(\S+)", out,
                                           re.M)]
    final = [float(v) for v in re.findall(r"^(?:loss|accuracy)=(\S+)$",
                                          out, re.M)]
    check(len(losses) == CLS_STEPS // 2 and len(final) == 2
          and all(math.isfinite(v) for v in losses + final),
          f"{tag}: losses {losses}, final {final}")
    times = [float(t) for t in re.findall(r"step_time=(\S+)", out)][1:]
    step = sorted(times)[len(times) // 2]

    ds = get_dataset(dataset)
    loop = TrainLoop(get_model("resnet50", num_classes=ds.num_classes,
                               input_shape=ds.shape), device=dev)
    state = loop.init_state(ds.shape)
    fn = ds.device_batch_fn()
    loop.train_steps_device(state, fn, batch, 0, 1)
    consts = torch.from_numpy(fn.consts).to(dev)
    x, y = fn(consts, torch.Generator(device=dev).manual_seed(0), batch)
    with FlopCounterMode(display=False) as fc:
        loop._step(state, x, y)
    gflop = fc.get_total_flops() / batch / 1e9
    prof = step_profile(
        torch, lambda: loop.train_steps_device(state, fn, batch, 2, 1), 1)
    busy = prof.get("kernel_ms")
    ips = batch / step
    rec = {"dataset": dataset, "batch": batch, "step_ms": step * 1e3,
           "step_times_s": times, "images_per_s": ips,
           "gflop_per_image": gflop,
           "mfu": ips * gflop * 1e9 / peak_flops_per_card(),
           "peak_memory_gb": peak / 1e9, "losses": losses,
           "eval_loss": final[0], "eval_accuracy": final[1],
           "busy_share": busy / (step * 1e3) if busy else None, **prof}
    log(f"classifier {tag}: step {rec['step_ms']:.2f} ms (of "
        f"{[round(t * 1e3, 2) for t in times]}), {ips:.1f} images/s, "
        f"{gflop:.3f} GFLOP/image, MFU {rec['mfu']:.4f}, peak "
        f"{rec['peak_memory_gb']:.2f} GB, kernels "
        f"{prof.get('kernel_ms', 0):.1f} ms a step, busy "
        f"{rec['busy_share'] or 0:.2f}")
    del loop, state, consts, x, y
    torch.cuda.empty_cache()
    return rec


def classifier_resume_check(repo):
    """(i2) on the card, in fresh processes: with KFX_CHECKPOINT_DIR, the
    JAXJob runner (mlp, mnist) and the LM runner (tiny) exit 17 at
    --fail-at-step, and the rerun resumes from the checkpoint and reaches
    train_done. The two chains run side by side."""
    import shutil

    chains = {
        "jax_runner": ["--model", "mlp", "--dataset", "mnist", "--steps",
                       "6", "--batch-size", "64", "--log-every", "2",
                       "--checkpoint-every", "2", "--eval-samples", "512"],
        "lm_runner": ["--preset", "tiny", "--steps", "4", "--batch-size",
                      "2", "--log-every", "1", "--checkpoint-every", "2"],
    }

    def chain(name):
        ck = os.path.join(repo, "build", f"ckpt_{name}")
        shutil.rmtree(ck, ignore_errors=True)
        env = dict(os.environ, PYTHONPATH=repo, KFX_CHECKPOINT_DIR=ck)
        cmd = [sys.executable, "-m", f"kubeflow_tpu_torch.runners.{name}"]
        t0 = time.perf_counter()
        crash = subprocess.run(cmd + chains[name] + ["--fail-at-step", "3"],
                               env=env, capture_output=True, text=True,
                               timeout=300, cwd=repo)
        again = subprocess.run(cmd + chains[name], env=env,
                               capture_output=True, text=True, timeout=300,
                               cwd=repo)
        resumed = re.search(r"resumed_from_checkpoint step=(\d+)",
                            again.stdout)
        check(crash.returncode == 17
              and "fault_injection_crash step=3" in crash.stdout,
              f"(i2) {name} crash: rc {crash.returncode}\n{crash.stdout}"
              f"\n{crash.stderr[-2000:]}")
        check(again.returncode == 0 and resumed is not None
              and "train_done" in again.stdout,
              f"(i2) {name} resume: rc {again.returncode}\n{again.stdout}"
              f"\n{again.stderr[-2000:]}")
        return {"resumed_step": int(resumed.group(1)),
                "seconds": time.perf_counter() - t0}

    names = sorted(chains)
    out = dict(zip(names, run_threads(chain, names, timeout=600)))
    log("classifier (i2) crash at step 3 and resume on cuda: " + ", ".join(
        f"{k} resumed at step {v['resumed_step']} ({v['seconds']:.1f} s)"
        for k, v in out.items()))
    return out


def post_raw(url, body, timeout=600):
    """POST pre-encoded JSON bytes; (decoded answer, client ms)."""
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        out = json.loads(r.read())
    return out, (time.perf_counter() - t0) * 1e3


def classifier_serving(torch, export_dir):
    """(i3) the 224^2 ResNet-50 export (1000 classes) behind ModelServer
    with JaxPredictor(max_batch_size=64) on the card: batch-1 :predict
    latency over CLS_SEQ sequential requests, then a wave of CLS_WAVE
    concurrent single-image requests without the micro-batcher and with
    it (maxLatencyMs CLS_BATCHER_MS). Every flush the batcher makes is
    recorded; each request's answer must be its slice of that flush, and
    JaxPredictor.predict on the same stacked batch must answer the same."""
    from kubeflow_tpu_torch.data import get_dataset
    from kubeflow_tpu_torch.serving.server import JaxPredictor, ModelServer

    t0 = time.perf_counter()
    pred = JaxPredictor(export_dir, name="resnet50", max_batch_size=64)
    pred.load()
    load_s = time.perf_counter() - t0
    check(pred.device == "cuda" and set(pred.placement.values())
          == {"accelerator"} and pred._buckets == [1, 2, 4, 8, 16, 32, 64],
          f"(i3) placement {pred.placement}")
    images, _ = get_dataset("imagenet-sim", "eval").eval_arrays(CLS_WAVE)
    bodies = [json.dumps({"instances": images[i:i + 1].tolist()}).encode()
              for i in range(CLS_WAVE)]
    rec = {"load_s": load_s, "probe_ms": pred.probe_ms,
           "request_bytes": len(bodies[0])}

    def serve(batcher):
        srv = ModelServer(port=0)
        srv.register(pred, batcher)
        srv.start()
        return srv, f"http://127.0.0.1:{srv.port}/v1/models/resnet50:predict"

    srv, url = serve(None)
    try:
        for i in range(3):
            post_raw(url, bodies[i])   # warm the handler path
        seq, seq_preds = [], []
        for i in range(CLS_SEQ):
            out, ms = post_raw(url, bodies[i % CLS_WAVE])
            seq.append(ms)
            seq_preds.append(out["predictions"][0])
        server_side = http_json(url.split("/v1/")[0]
                                + "/metrics?format=json")["latency_ms"]
        t0 = time.perf_counter()
        plain = run_threads(lambda i: post_raw(url, bodies[i]),
                            list(range(CLS_WAVE)))
        plain_s = time.perf_counter() - t0
    finally:
        srv.stop()
    flushes = []
    orig = pred.predict

    def spy(instances, probabilities=False):
        out = orig(instances, probabilities=probabilities)
        flushes.append((instances.copy(), out["predictions"]))
        return out

    pred.predict = spy
    srv, url = serve({"maxBatchSize": 64, "maxLatencyMs": CLS_BATCHER_MS})
    try:
        post_raw(url, bodies[0])
        flushes.clear()
        t0 = time.perf_counter()
        batched = run_threads(lambda i: post_raw(url, bodies[i]),
                              list(range(CLS_WAVE)))
        batched_s = time.perf_counter() - t0
    finally:
        srv.stop()
        pred.predict = orig
    by_image = {}
    for stacked, preds in flushes:
        check(orig(stacked)["predictions"] == preds,
              "(i3) JaxPredictor.predict on a flushed batch answers "
              "differently")
        for row, p in zip(stacked, preds):
            by_image[row.tobytes()] = p
    for i, (out, _) in enumerate(batched):
        check(out["predictions"] == [by_image[images[i].tobytes()]],
              f"(i3) request {i}: batcher answered {out['predictions']}")
    check(sum(len(p) for _, p in flushes) == CLS_WAVE,
          f"(i3) flushes {[len(p) for _, p in flushes]}")
    stack = orig(images)["predictions"]
    agree_seq = sum(p == stack[i % CLS_WAVE]
                    for i, p in enumerate(seq_preds)) / len(seq_preds)

    def lat(xs):
        return {"p50_ms": percentile(xs, 0.5), "p99_ms": percentile(xs, 0.99)}

    rec.update({
        "batch1": {**lat(seq), "n": len(seq), "server_ms": server_side},
        "wave_plain": {**lat([ms for _, ms in plain]),
                       "images_per_s": CLS_WAVE / plain_s,
                       "wall_s": plain_s},
        "wave_batched": {**lat([ms for _, ms in batched]),
                         "images_per_s": CLS_WAVE / batched_s,
                         "wall_s": batched_s,
                         "flush_sizes": [len(p) for _, p in flushes]},
        "batch1_vs_stacked_agreement": float(agree_seq),
        "_pred": pred})
    log(f"classifier (i3) resnet50 224^2 export: load {load_s:.1f} s, "
        f"request {len(bodies[0]) / 1e6:.2f} MB of JSON; batch-1 p50 "
        f"{rec['batch1']['p50_ms']:.1f} ms, p99 "
        f"{rec['batch1']['p99_ms']:.1f} ms (server-side {server_side}); "
        f"{CLS_WAVE} concurrent: plain {rec['wave_plain']['images_per_s']:.1f}"
        f" images/s (p50 {rec['wave_plain']['p50_ms']:.0f} ms, p99 "
        f"{rec['wave_plain']['p99_ms']:.0f}), batcher "
        f"{rec['wave_batched']['images_per_s']:.1f} images/s (p50 "
        f"{rec['wave_batched']['p50_ms']:.0f} ms, p99 "
        f"{rec['wave_batched']['p99_ms']:.0f}; flushes "
        f"{rec['wave_batched']['flush_sizes']}); batch-1 answers equal the "
        f"stacked batch's on {agree_seq:.3f}")
    return rec


def classifier_phase(torch, fa, dev, repo):
    """(i): (i0), (i1) and (i3), flash launch counters set to 0 just before
    and read just after (no classifier reaches a flash kernel, as none
    reaches a Pallas kernel in the reference). (i2), the runners'
    crash-and-resume chains, runs side by side with (q)'s jobs."""
    fa.reset_launches()
    rec = {"models": classifier_models_check(torch, dev)}
    export_dir = os.path.join(repo, "build", "cls_export")
    rec["train"] = [classifier_rung(torch, dev, ds, b,
                                    export_dir if ds == "imagenet-sim"
                                    else "")
                    for ds, b in CLS_POINTS]
    rec["serving"] = classifier_serving(torch, export_dir)
    rec["chaos_predict"] = chaos_predict_check(export_dir)
    rec["launches"] = dict(fa.LAUNCHES)
    check(rec["launches"] == {"flash_fwd": 0, "flash_dq": 0,
                              "flash_dkv": 0},
          f"(i) flash launches {rec['launches']}")
    return rec


# -- (o) the Kubeflow compat surface ------------------------------------------

def compat_env(repo, **extra):
    """The environment of a compat worker: no rendezvous, checkpoint or
    chaos variable of this process, the repo on the path."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("KFX_", "OMPI_", "MASTER_"))
           and k not in ("RANK", "WORLD_SIZE")}
    return dict(env, PYTHONPATH=repo, **extra)


def rank_lines(out, prefixes):
    """The lines starting with ``prefixes``, sorted, each without the
    fields that may differ between ranks (its timing)."""
    return sorted(re.sub(r" (step_time|examples_per_sec|wall_seconds)=\S+",
                         "", ln) for ln in out.splitlines()
                  if ln.startswith(prefixes))


def compat_export(torch, dev, repo):
    """(o1)'s export: (i)'s 224^2 ResNet-50 export in the port's
    classifier, traced (its getattr block lookup won't script) and written
    as model.pt + config.json. Returns (directory, seconds)."""
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.models.convert import classifier_params_from_jax
    from kubeflow_tpu_torch.serving.export import load_exported
    from kubeflow_tpu_torch.serving.torch_server import export_torchscript

    t0 = time.perf_counter()
    config, payload = load_exported(os.path.join(repo, "build",
                                                 "cls_export"))
    shape = tuple(config["input_shape"])
    model = get_model(config["model"], num_classes=config["num_classes"],
                      input_shape=shape)
    model.load_state_dict(classifier_params_from_jax(
        config["model"], payload["params"], payload.get("batch_stats")))
    model.to(dev, memory_format=torch.channels_last).eval()
    out_dir = os.path.join(repo, "build", "torch_export")
    with torch.no_grad():
        export_torchscript(out_dir, model, input_shape=shape,
                           num_classes=config["num_classes"],
                           example_inputs=torch.zeros((1,) + shape,
                                                      device=dev))
    del model
    torch.cuda.empty_cache()
    return out_dir, time.perf_counter() - t0


def start_procs(repo, jobs):
    """Start every (argv, env) of ``jobs`` side by side, stdout and stderr
    to files (so no pipe fills); (processes, log files, start time)."""
    logs = os.path.join(repo, "build", "compat_logs")
    os.makedirs(logs, exist_ok=True)
    files, procs = [], []
    t0 = time.perf_counter()
    for i, (argv, env) in enumerate(jobs):
        f = open(os.path.join(logs, f"worker{i}.log"), "w+")
        files.append(f)
        procs.append(subprocess.Popen(argv, stdout=f,
                                      stderr=subprocess.STDOUT, text=True,
                                      env=env, cwd=repo))
    return procs, files, t0


def wait_procs(procs, files, t0, timeout=600):
    """(return codes, outputs, seconds from the start to each one's exit)
    of start_procs' processes; kills what outlives ``timeout``."""
    walls = [None] * len(procs)
    try:
        while None in walls:
            check(time.perf_counter() - t0 < timeout,
                  f"(o) workers still running after {timeout} s")
            for i, p in enumerate(procs):
                if walls[i] is None and p.poll() is not None:
                    walls[i] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in files:
        f.seek(0)
        outs.append(f.read())
        f.close()
    return [p.returncode for p in procs], outs, walls


def compat_jobs(repo):
    """(o2)'s processes: the PyTorchJob worker with
    examples/pytorchjob-mnist.yaml's arguments at two ranks over gloo and
    one rank with the default backend (nccl), each on the one card.
    (o3), the MPIJob, runs through the control plane in (q5)."""
    from kubeflow_tpu_torch.utils.net import free_port

    pt = [sys.executable, "-m", "kubeflow_tpu_torch.runners.torch_runner"]
    port, port1 = str(free_port()), str(free_port())
    jobs = [(pt + PTJOB_ARGV + ["--backend=gloo"],
             compat_env(repo, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                        WORLD_SIZE="2", RANK=str(r))) for r in range(2)]
    return jobs + [(pt + PTJOB_ARGV,
                    compat_env(repo, MASTER_ADDR="127.0.0.1",
                               MASTER_PORT=port1, WORLD_SIZE="1",
                               RANK="0"))]


def compat_job_checks(rcs, outs, walls):
    """(o2)'s contracts on compat_jobs' results; its record."""
    def train_walls(*texts):
        return [float(v) for o in texts
                for v in re.findall(r"wall_seconds=(\S+)", o)]

    check(rcs[:2] == [0, 0] and "rank=0 world=2 backend=gloo" in outs[0],
          f"(o2) two ranks: rc {rcs[:2]}\n{outs[0][-3000:]}\n"
          f"{outs[1][-3000:]}")
    finals = [rank_lines(o, ("loss=", "accuracy=")) for o in outs[:2]]
    check(finals[0] == finals[1] and len(finals[0]) == 2
          and all(math.isfinite(float(ln.split("=")[1]))
                  for ln in finals[0]),
          f"(o2) final lines differ across ranks: {finals}")
    check(rcs[2] == 0 and "rank=0 world=1 backend=nccl" in outs[2],
          f"(o2) one rank: rc {rcs[2]}\n{outs[2][-3000:]}")
    pytorchjob = {
        "argv": PTJOB_ARGV,
        "two_ranks_gloo": {"wall_s": max(walls[:2]), "final": finals[0],
                           "train_wall_s": train_walls(*outs[:2])},
        "one_rank_nccl": {"wall_s": walls[2],
                          "final": rank_lines(outs[2],
                                              ("loss=", "accuracy=")),
                          "train_wall_s": train_walls(outs[2])}}
    log(f"compat (o2) PyTorchJob mnist 300 steps b128: two ranks on one "
        f"card over gloo {max(walls[:2]):.1f} s (training "
        f"{pytorchjob['two_ranks_gloo']['train_wall_s']} s), final lines "
        f"equal {finals[0]}; one rank over nccl {walls[2]:.1f} s (training "
        f"{pytorchjob['one_rank_nccl']['train_wall_s']} s)")
    return {"pytorchjob": pytorchjob}


def mpijob_checks(rc, out, wall):
    """(o3)'s contract on the MPIJob launcher's output (the shim's two
    ranks of mpi_jax_runner on the card); its record."""
    check(rc == 0 and out.count("world=2") == 4
          and out.count("process_group backend=gloo") == 2
          and out.count("platform=cuda") == 2,
          f"(o3) rc {rc}\n{out[-4000:]}")
    steps = rank_lines(out, "step=")
    finals = rank_lines(out, ("loss=", "accuracy="))
    check(len(steps) == 4 and steps[0::2] == steps[1::2]
          and len(finals) == 4 and finals[0::2] == finals[1::2]
          and all(math.isfinite(float(ln.split("=")[1]))
                  for ln in finals),
          f"(o3) rank lines differ: {steps} {finals}")
    mpijob = {"argv": MPIJOB_ARGV, "wall_s": wall, "steps": steps[0::2],
              "final": finals[0::2],
              "step_time_s": [float(v) for v in re.findall(
                  r"step_time=(\S+)", out)],
              "train_wall_s": [float(v) for v in re.findall(
                  r"wall_seconds=(\S+)", out)]}
    log(f"compat (o3) MPIJob resnet18 cifar10 20 steps b64, -np 2 on one "
        f"card over gloo, through the plane in (q5): {wall:.1f} s "
        f"(training {mpijob['train_wall_s']} s); step lines equal on both "
        f"ranks {mpijob['steps']}, final {mpijob['final']}")
    return mpijob



def compat_parity(p_got, pred_got, p_want, pred_want) -> dict:
    """(o1)'s parity of the served predictor (``p_got``, ``pred_got``)
    against the reference's (``p_want``, ``pred_want``) on the same
    images; fails unless the probabilities are finite rows of the same
    shape that sum to 1, agree within COMPAT_REL of each row's largest,
    each prediction is its row's argmax, and the predictions are equal
    wherever the reference's top-two gap exceeds twice the row's error."""
    import numpy as np

    check(p_got.shape == p_want.shape == (len(pred_want), p_want.shape[1])
          and pred_got.shape == pred_want.shape
          and bool(np.isfinite(p_got).all())
          and bool((np.abs(p_got.sum(-1) - 1) <= 1e-3).all()),
          f"(o1) probabilities {p_got.shape} (want {p_want.shape}), "
          f"row sums {p_got.sum(-1) if p_got.ndim == 2 else '-'}")
    row_err = np.abs(p_got - p_want).max(-1)
    rel = float((row_err / p_want.max(-1)).max())
    top2 = np.sort(p_want, -1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * row_err
    same = pred_got == pred_want
    own = bool((pred_got == p_got.argmax(-1)).all())
    check(rel <= COMPAT_REL and own and bool(same[decided].all()),
          f"(o1) probabilities {rel:.3g} of the row's largest (tol "
          f"{COMPAT_REL}); predictions their rows' argmax: {own}; equal "
          f"on {int(same[decided].sum())}/{int(decided.sum())} rows whose "
          f"top-two gap exceeds twice the row's error")
    return {"parity_n": len(same), "parity_equal": int(same.sum()),
            "parity_decided": int(decided.sum()),
            "max_abs_prob_err": float(row_err.max()),
            "max_prob_err_over_row_max": rel,
            "top1_prob_max": float(p_want.max())}


# -- (r) the serving tier ----------------------------------------------------

def r_status(cp, name):
    return cp.store.get("InferenceService", name)


def r_wait(cp, name, pred, what, timeout=240):
    deadline = time.monotonic() + timeout
    while True:
        obj = r_status(cp, name)
        if pred(obj):
            return obj
        check(time.monotonic() < deadline,
              f"(r) {what} after {timeout} s: {json.dumps(obj.status)}")
        time.sleep(0.05)


def r_ready_lines(home, name):
    """{replica log name: its server_ready line} under the service's
    workdir."""
    import glob

    out = {}
    for path in sorted(glob.glob(os.path.join(
            home, "serving", f"default_{name}", "*.log"))):
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith("server_ready")]
        if lines:
            out[os.path.basename(path)] = lines[-1]
    return out


def r_revision_counts(cp, name):
    """Answered requests by revision (the router's per-revision counter in
    the plane's registry)."""
    out = {}
    for lab, v in cp.metrics.counter("kfx_router_requests_total").samples():
        if lab.get("isvc") == name and lab.get("code") == "2xx":
            out[lab["revision"]] = out.get(lab["revision"], 0) + int(v)
    return out


def r_replica_url(ready_line, name):
    """The :predict URL of a replica's own port, read off its
    server_ready line."""
    m = re.search(r" port=(\d+) ", ready_line)
    check(m is not None, f"(r) no port in {ready_line!r}")
    return f"http://127.0.0.1:{m.group(1)}/v1/models/{name}:predict"


def r_hop(url, direct, bodies):
    """R_SEQ batch-1 requests to ``direct`` (a replica's own port) and,
    unless ``url`` is None, R_SEQ to ``url`` (through the router), in
    turns (the first of each pair alternates), after 3 warm requests to
    each: {"direct": {p50_ms, p99_ms, n}, "router": ..., "hop_p50_ms":
    router p50 less direct p50}."""
    urls = {"direct": direct} if url is None else {"router": url,
                                                    "direct": direct}
    for b in bodies[:3]:   # warm the router and handler paths
        for u in urls.values():
            post_raw(u, b)
    ms = {k: [] for k in urls}
    order = list(urls)
    for i in range(R_SEQ):
        for k in (order if i % 2 == 0 else order[::-1]):
            ms[k].append(post_raw(urls[k], bodies[i % len(bodies)])[1])
    out = {k: {"p50_ms": percentile(v, 0.5), "p99_ms": percentile(v, 0.99),
               "n": len(v)} for k, v in ms.items()}
    if url is not None:
        out["hop_p50_ms"] = out["router"]["p50_ms"] - out["direct"]["p50_ms"]
    return out


def r_burst(url, bodies, stop, clients=R_CLIENTS):
    """``clients`` threads each POSTing batch-1 bodies to ``url`` until
    ``stop`` is set; returns (threads, answered list, failures list)."""
    import threading

    answered, failures = [], []

    def client(k):
        i = k
        while not stop.is_set():
            try:
                out, ms = post_raw(url, bodies[i % len(bodies)],
                                   timeout=120)
                answered.append(ms)
            except Exception as e:   # every failure is a finding
                failures.append(repr(e))
            i += clients

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    for t in threads:
        t.start()
    return threads, answered, failures


def r_phase(torch, fa, dev, repo, cls_pred, cls_p50):
    """(r) BASELINE.json #5 through the serving tier: a ControlPlane in
    this process with no KFX_ variable in its env applies
    examples/torch/inferenceservice-resnet.yaml over (i)'s 224^2 ResNet-50
    export, then a canary, a burst, a scale-up and a killed replica.
    Flash launch counters of this process set to 0 just before and read
    just after (0/0/0: the replicas are classifiers)."""
    import shutil
    import threading

    import numpy as np

    from kubeflow_tpu_torch import chaos
    from kubeflow_tpu_torch.api.manifest import load_manifest_file
    from kubeflow_tpu_torch.controlplane import ControlPlane
    from kubeflow_tpu_torch.data import get_dataset

    t0 = time.perf_counter()
    fa.reset_launches()
    saved = q_env_clean()
    home = os.path.join(repo, "build", "r_home")
    shutil.rmtree(home, ignore_errors=True)
    out_dir, export_s = compat_export(torch, dev, repo)
    [isvc] = load_manifest_file(os.path.join(
        repo, "examples", "torch", "inferenceservice-resnet.yaml"))
    name = isvc.name
    pred_spec = isvc.spec["predictor"]
    check(pred_spec["maxReplicas"] == 2 and pred_spec["minReplicas"] == 1,
          f"(r) the example's replicas {pred_spec}")
    pred_spec["jax"]["storageUri"] = "file://" + os.path.join(
        repo, "build", "cls_export")
    pred_spec["targetConcurrency"] = 1
    images, _ = get_dataset("imagenet-sim", "eval").eval_arrays(
        COMPAT_PARITY)
    parity_body = json.dumps({"instances": images.tolist(),
                              "probabilities": True}).encode()
    want = cls_pred.predict(images, probabilities=True)
    p_want = np.asarray(want["probabilities"])
    bodies = [json.dumps({"instances": images[i:i + 1].tolist()}).encode()
              for i in range(COMPAT_PARITY)]
    rec = {"export_s": export_s}
    stop = threading.Event()
    threads = []
    try:
        with ControlPlane(home=home) as cp:
            ctrl = cp.manager.controllers["InferenceService"]
            check(ctrl.device_for(pred_spec) == "cuda",
                  "(r) the plane's default replica device")
            # (r1) apply to Ready, the replica on cuda, :predict through
            # status.url against (i)'s JaxPredictor.
            t_apply = time.perf_counter()
            cp.apply([isvc])
            obj = r_wait(cp, name, lambda o: o.has_condition("Ready", "True"),
                         "(r1) not Ready")
            rec["apply_to_ready_s"] = time.perf_counter() - t_apply
            ready = r_ready_lines(home, name)
            check(list(ready) == ["default-0.log"]
                  and "framework=jax" in ready["default-0.log"]
                  and " device=cuda" in ready["default-0.log"],
                  f"(r1) replica lines {ready}")
            url = f"{obj.status['url']}/v1/models/{name}:predict"
            got, _ = post_raw(url, parity_body)
            check(got["predictions"] == want["predictions"],
                  f"(r1) predictions {got['predictions']} against "
                  f"JaxPredictor's {want['predictions']}")
            r1_err = float(np.abs(np.asarray(got["probabilities"])
                                  - p_want).max())
            direct = r_replica_url(ready["default-0.log"], name)
            batch1 = r_hop(url, direct, bodies)
            rec["r1"] = {"server_ready": ready["default-0.log"],
                         "predictions_equal": True,
                         "max_abs_prob_err": r1_err,
                         "batch1": batch1,
                         "jax_predictor_batch1_p50_ms": cls_p50}

            # (r2) the canary is (o1): (i)'s export traced to TorchScript
            # behind pytorch:, at canaryTrafficPercent 50.
            isvc.spec["canary"] = {"minReplicas": 1, "pytorch": {
                "storageUri": "file://" + out_dir}}
            isvc.spec["canaryTrafficPercent"] = 50
            t_canary = time.perf_counter()
            cp.apply([isvc])
            obj = r_wait(cp, name, lambda o: (o.status.get("readyReplicas")
                                              or {}).get("canary") == 1
                         and o.has_condition("Ready", "True"),
                         "(r2) the canary not ready")
            canary_ready_s = time.perf_counter() - t_canary
            ready = r_ready_lines(home, name)
            check("canary-0.log" in ready
                  and "framework=pytorch" in ready["canary-0.log"]
                  and " device=cuda" in ready["canary-0.log"],
                  f"(r2) replica lines {ready}")
            before = r_revision_counts(cp, name)
            parities = []
            for _ in range(R_CANARY_REQUESTS):
                got, _ = post_raw(url, parity_body)
                parities.append(compat_parity(
                    np.asarray(got["probabilities"]),
                    np.asarray(got["predictions"]), p_want,
                    np.asarray(want["predictions"])))
            after = r_revision_counts(cp, name)
            by_rev = {r: after.get(r, 0) - before.get(r, 0)
                      for r in ("default", "canary")}
            check(by_rev["default"] > 0 and by_rev["canary"] > 0
                  and sum(by_rev.values()) == R_CANARY_REQUESTS,
                  f"(r2) requests by revision {by_rev}")
            canary_batch1 = r_hop(None, r_replica_url(
                ready["canary-0.log"], name), bodies)["direct"]
            rec["r2"] = {"server_ready": ready["canary-0.log"],
                         "canary_ready_s": canary_ready_s,
                         "requests_by_revision": by_rev,
                         "max_prob_err_over_row_max": max(
                             p["max_prob_err_over_row_max"]
                             for p in parities),
                         "max_abs_prob_err": max(p["max_abs_prob_err"]
                                                 for p in parities),
                         "parity_equal_min": min(p["parity_equal"]
                                                 for p in parities),
                         "parity_decided_min": min(p["parity_decided"]
                                                   for p in parities),
                         "top1_prob_max": parities[0]["top1_prob_max"],
                         "batch1_direct": canary_batch1}

            # (r3) drop the canary, then a burst of R_CLIENTS clients
            # scales the default revision from 1 to 2; a replica.kill in
            # this process mid-burst; no client request may fail.
            del isvc.spec["canary"]
            del isvc.spec["canaryTrafficPercent"]
            cp.apply([isvc])
            r_wait(cp, name, lambda o: "canary" not in (
                o.status.get("replicas") or {}), "(r3) the canary stays")
            t_burst = time.perf_counter()
            threads, answered, failures = r_burst(url, bodies, stop)
            obj = r_wait(cp, name, lambda o: (o.status.get("replicas")
                                              or {}).get("default") == 2,
                         "(r3) no scale-up")
            t_spawn = time.perf_counter()
            obj = r_wait(cp, name, lambda o: (o.status.get(
                "readyReplicas") or {}).get("default") == 2,
                "(r3) the second replica not ready")
            t_scaled = time.perf_counter()
            auto = dict(obj.status["autoscaling"]["default"])
            granted = cp.sched.serving_granted(name, "default")
            endpoints = len(ctrl._runtimes[f"default/{name}"]
                            .router.default)
            check(auto["desired"] == 2 and granted == 2 and endpoints == 2,
                  f"(r3) scale-up: autoscaling {auto}, granted {granted}, "
                  f"endpoints {endpoints}")
            n_before_kill = len(answered)
            chaos.install(chaos.parse_spec("replica.kill:count=1"))
            try:
                obj = r_wait(cp, name, lambda o: o.status.get(
                    "autoscaling", {}).get("default", {}).get(
                        "restarts") == 1, "(r3) no replica restart")
                t_killed = time.perf_counter()
                obj = r_wait(cp, name, lambda o: (o.status.get(
                    "readyReplicas") or {}).get("default") == 2,
                    "(r3) the killed replica not back")
                t_back = time.perf_counter()
            finally:
                chaos.reset()
            time.sleep(R_AFTER_S)
            stop.set()
            for t in threads:
                t.join(timeout=180)
            restarts = cp.metrics.counter(
                "kfx_replica_restarts_total").value(
                    namespace="default", isvc=name, revision="default",
                    reason="crashed")
            check(not failures and restarts == 1
                  and obj.status["autoscaling"]["default"]["restarts"] == 1,
                  f"(r3) {len(failures)} failed of "
                  f"{len(answered) + len(failures)} ({failures[:3]}), "
                  f"restarts {restarts}")
            events = [e.reason for e in cp.store.events_for(
                "InferenceService", f"default/{name}")]
            rec["r3"] = {
                "clients": R_CLIENTS, "answered": len(answered),
                "failed": len(failures),
                "answered_after_kill": len(answered) - n_before_kill,
                "burst_to_spawn_s": t_spawn - t_burst,
                "scale_up_spawn_to_ready_s": t_scaled - t_spawn,
                "kill_to_restart_seen_s": t_killed - t_scaled,
                "restart_to_ready_s": t_back - t_killed,
                "autoscaling": auto, "granted": granted,
                "restarts_total_crashed": restarts,
                "burst_p50_ms": percentile(answered, 0.5),
                "burst_p99_ms": percentile(answered, 0.99),
                "events": sorted(set(events)),
                "requests_by_revision": r_revision_counts(cp, name)}
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=180)
        os.environ.update(saved)
    rec["launches"] = dict(fa.LAUNCHES)
    check(rec["launches"] == {"flash_fwd": 0, "flash_dq": 0,
                              "flash_dkv": 0},
          f"(r) flash launches in this process {rec['launches']}")
    rec["seconds"] = time.perf_counter() - t0
    r1, r2, r3 = rec["r1"], rec["r2"], rec["r3"]
    b1 = r1["batch1"]
    log(f"serving tier (r1) examples/torch/inferenceservice-resnet.yaml over "
        f"(i)'s ResNet-50 224^2: apply to Ready {rec['apply_to_ready_s']:.1f}"
        f" s, replica device=cuda, predictions equal JaxPredictor's "
        f"(probabilities max err {r1['max_abs_prob_err']:.3g}); batch-1 "
        f"over {R_SEQ} requests each, in turns: through status.url p50 "
        f"{b1['router']['p50_ms']:.1f} ms p99 {b1['router']['p99_ms']:.1f} "
        f"ms, straight to the replica p50 {b1['direct']['p50_ms']:.1f} ms "
        f"p99 {b1['direct']['p99_ms']:.1f} ms, the router hop "
        f"{b1['hop_p50_ms']:.1f} ms at p50 ((i)'s ModelServer in this "
        f"process: p50 {cls_p50:.1f} ms); (r2) canary "
        f"pytorch: at 50% ready in {r2['canary_ready_s']:.1f} s, requests "
        f"by revision {r2['requests_by_revision']}, probabilities "
        f"{r2['max_prob_err_over_row_max']:.3g} of the row's largest (tol "
        f"{COMPAT_REL}), batch-1 straight to its replica p50 "
        f"{r2['batch1_direct']['p50_ms']:.1f} ms p99 "
        f"{r2['batch1_direct']['p99_ms']:.1f} ms; (r3) {R_CLIENTS} clients: scale-up spawned after "
        f"{r3['burst_to_spawn_s']:.1f} s, ready "
        f"{r3['scale_up_spawn_to_ready_s']:.1f} s later, a killed replica "
        f"back in {r3['restart_to_ready_s']:.1f} s, {r3['answered']} "
        f"answered, {r3['failed']} failed; (r) {rec['seconds']:.1f} s")
    log(json.dumps({"isvc": {
        "apply_to_ready_s": rec["apply_to_ready_s"],
        "scale_up_spawn_to_ready_s": r3["scale_up_spawn_to_ready_s"],
        "restart_to_ready_s": r3["restart_to_ready_s"],
        "requests_by_revision": r3["requests_by_revision"],
        "canary_requests_by_revision": r2["requests_by_revision"]}}))
    return rec


# -- (q) the training control plane -------------------------------------------

class RunnerStarts:
    """When each worker's runner printed its first line. A thread reads
    every member log under ``roots`` (a plane's ``gangs/<gang>/logs/
    <member>.log``) every 20 ms and stamps, with ``time.time()``, the first
    ``runner_start`` line of each attempt (the gang heads each attempt's
    output with ``==== attempt N``). The gap from an attempt's gang.spawn
    span to that stamp is the worker's start-up (the interpreter, torch,
    the card's context), read to the poll's 20 ms. It also stamps every
    ``step=`` line, in ``steps[(gang, member)]`` as (stamp, line): (t)
    waits on the first and places each step inside or outside a profile's
    window; and each member's ``train_done`` line, in ``done``, on which
    (t)'s job waits."""

    POLL_S = 0.02

    def __init__(self, roots):
        import threading

        self.roots, self.stamps, self.steps, self.done = roots, {}, {}, {}
        self._files = {}   # path: [offset, unfinished line, attempt]
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()

    def _scan(self):
        import glob

        now = time.time()
        for root in self.roots:
            for path in glob.glob(os.path.join(root, "*", "logs", "*.log")):
                st = self._files.setdefault(path, [0, b"", 0])
                try:
                    with open(path, "rb") as f:
                        f.seek(st[0])
                        data = f.read()
                except OSError:
                    continue
                st[0] += len(data)
                *lines, st[1] = (st[1] + data).split(b"\n")
                gang = os.path.basename(os.path.dirname(os.path.dirname(
                    path)))
                for ln in lines:
                    m = re.match(rb"==== attempt (\d+) ", ln)
                    if m:
                        st[2] = int(m.group(1))
                    elif ln.startswith(b"runner_start"):
                        member = os.path.basename(path)[:-len(".log")]
                        self.stamps.setdefault((gang, member, st[2]), now)
                    elif ln.startswith(b"step="):
                        member = os.path.basename(path)[:-len(".log")]
                        self.steps.setdefault((gang, member), []).append(
                            (now, ln.decode()))
                    elif ln.startswith(b"train_done"):
                        member = os.path.basename(path)[:-len(".log")]
                        self.done.setdefault((gang, member), now)

    def _run(self):
        while not self._stop.wait(self.POLL_S):
            self._scan()

    def stop(self):
        self._stop.set()
        self._th.join(timeout=5)


def plane_spans(home, jobs, starts, ns="default"):
    """For each ``(kind, name)`` of ``jobs`` (namespace ``ns``), the
    spans the plane wrote to ``<home>/spans/plane-*.jsonl``: the admission
    span of the apply that created the job, its reconciles (how many, their
    total and the longest), its sched.admit spans and each attempt's
    gang.spawn span, in milliseconds, and the seconds from each gang.spawn
    span's end to the runner_start line of that attempt's last member to
    start (``starts``, a RunnerStarts)."""
    import glob

    recs = []
    for path in glob.glob(os.path.join(home, "spans", "plane-*.jsonl")):
        with open(path) as f:
            recs += [json.loads(ln) for ln in f if ln.strip()]

    def named(span, attr, value):
        return sorted((r for r in recs if r["name"] == span
                       and r.get("attrs", {}).get(attr) == value),
                      key=lambda r: r["ts"])

    def ms(rs):
        return [round(r["dur"] * 1e3, 3) for r in rs]

    out = {}
    for kind, name in jobs:
        key = f"{ns}/{name}"
        rec = [r for r in named("reconcile", "key", key)
               if r["attrs"].get("kind") == kind]
        traces = {r["trace"] for r in rec}
        spawns = named("gang.spawn", "gang", name)
        gang = f"{kind.lower()}_{ns}_{name}"
        gaps = []
        for sp in spawns:
            seen = [t for (g, _, a), t in starts.stamps.items()
                    if g == gang and a == int(sp["attrs"]["attempt"])]
            gaps.append(round(max(seen) - sp["ts"] - sp["dur"], 3)
                        if seen else None)
        out[name] = {
            "admission_ms": ms(r for r in recs if r["name"] == "admission"
                               and r["trace"] in traces),
            "reconciles": len(rec),
            "reconcile_ms_total": round(sum(r["dur"] for r in rec) * 1e3, 3),
            "reconcile_ms_max": max(ms(rec), default=None),
            "sched_admit_ms": ms(named("sched.admit", "job", key)),
            "gang_spawn_ms": ms(spawns),
            "spawn_to_runner_start_s": gaps}
    return out


def q_env_clean():
    """Take every KFX_ variable out of this process's env (the plane's
    gangs inherit it); returns them for q_phase to put back."""
    return {k: os.environ.pop(k) for k in list(os.environ)
            if k.startswith("KFX_")}


def q_jaxjob(name, command, env=None, backoff=3, parallelism=None):
    """A one-Worker JAXJob in the form of examples/torch/lm-jaxjob.yaml
    (runPolicy.backoffLimit, restartPolicy OnFailure, the first
    container's command, ``spec.parallelism`` where given: without it the
    Worker is one rank)."""
    container = {"name": "jax", "image": "kfx/jax:latest",
                 "command": command}
    if env:
        container["env"] = [{"name": k, "value": v} for k, v in env.items()]
    spec = {"runPolicy": {"backoffLimit": backoff},
            "jaxReplicaSpecs": {"Worker": {
                "replicas": 1, "restartPolicy": "OnFailure",
                "template": {"spec": {"containers": [container]}}}}}
    if parallelism:
        spec["parallelism"] = parallelism
    return {"apiVersion": "kubeflow.org/v1", "kind": "JAXJob",
            "metadata": {"name": name, "namespace": "default"},
            "spec": spec}


def cli_start(repo, home, argv, **env):
    """`python -m kubeflow_tpu_torch.cli --home HOME ARGV` in a process of
    its own (compat_env plus ``env``: no KFX_ variable of this process),
    its output read on a thread that stamps each line."""
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.cli", "--home", home]
        + argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=compat_env(repo, **env), cwd=repo)
    lines = []

    def read():
        for ln in proc.stdout:
            lines.append((time.perf_counter(), ln.rstrip("\n")))

    th = threading.Thread(target=read, daemon=True)
    th.start()
    return proc, th, lines


def q_proc_lines(proc, th, lines, timeout):
    """Wait for a cli_start process (killed after ``timeout`` s); its output
    and each line's stamp."""
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    th.join(timeout=30)
    return "\n".join(ln for _, ln in lines), {ln: t for t, ln in lines}


def chief_exit_0(job):
    """Whether ``job`` succeeded because its chief replica exited 0 (the
    gang's reason for Succeeded; the plane forgets a finished gang, so its
    last exit codes are read off the condition)."""
    return any(c.type == "Succeeded" and c.status == "True"
               and c.message == "chief exited 0" for c in job.conditions)


def q_wait(cp, kind, name, timeout=300):
    final = cp.wait_for_job(kind, name, timeout=timeout)
    return final, cp.job_logs(kind, name)


def q_job_seconds(job):
    """Seconds from the job's creation to its completionTime."""
    from kubeflow_tpu_torch.api.base import parse_utc

    return (parse_utc(job.status["completionTime"])
            - parse_utc(job.metadata.creation_timestamp)).total_seconds()


def record_exits(cp):
    """Every member exit of every gang ``cp`` starts from now on:
    ``{gang name: {(member id, attempt start): exit code}}``. Each gang's
    on_change is wrapped as it is made; the supervisor calls on_change
    after it records an exit and before it tears the attempt down or
    restarts it, so no exit is missed, whatever the restart backoff."""
    exits = {}
    ensure = cp.gangs.ensure

    def ensure_recording(key, factory):
        def make(workdir):
            gang = factory(workdir)
            notify = gang.on_change

            def on_change(g):
                seen = exits.setdefault(g.name, {})
                for rid, r in g.status().replicas.items():
                    if r.exit_code is not None:
                        seen[(rid, r.started_at or 0.0)] = r.exit_code
                if notify is not None:
                    notify(g)

            gang.on_change = on_change
            return gang

        return ensure(key, make)

    cp.gangs.ensure = ensure_recording
    return exits


def exit_codes(exits, gang, rid):
    """The member's exit codes, one an attempt, in launch order."""
    return [c for (r, _), c in sorted(exits.get(gang, {}).items(),
                                      key=lambda kv: kv[0][1]) if r == rid]


def q6_checks(cp, final, main):
    """(q6)'s checks, (p1)'s: the JAXJob of one Worker with spec.parallelism
    {tensor: 2} runs as two ranks of one gang (worker-0, worker-0.1), each
    this script with --lm-worker and the main path's runner command with no
    --tp. On each rank: the plan pp1/dp1/tp2 from KFX_PARALLELISM, its
    process_group line (gloo, world 2, the host-staged transport: NCCL
    refuses two ranks on one card), flash 120/96/96, q holding half the
    heads, the step-2 loss within 2e-3 of the main path's (the first update
    has learning rate 0) and steps 3-4 and the eval loss within 1e-2. The
    job reads one succeeded Worker replica, no restart."""
    from kubeflow_tpu_torch.models.transformer import preset_config

    base = preset_config("base")
    L, H = base.n_layers, base.n_heads
    want = {"flash_fwd": L * MAIN_STEPS + L, "flash_dq": L * MAIN_STEPS,
            "flash_dkv": L * MAIN_STEPS}
    outs = [cp.job_logs("JAXJob", "q6-tp2", replica=rid)
            for rid in ("worker-0", "worker-0.1")]
    check(final.has_condition("Succeeded")
          and final.status.get("restartCount", 0) == 0
          and final.status["replicaStatuses"] == {
              "worker": {"active": 0, "succeeded": 1, "failed": 0}},
          f"(q6) {final.status}\n{outs[0][-3000:]}\n{outs[1][-3000:]}")
    ranks = []
    for r, out in enumerate(outs):
        got = _rank_lines(out, "lm_worker ")
        check(len(got) == 1 and got[0]["rank"] == r,
              f"(q6) rank {r} lm_worker line:\n{out[-3000:]}")
        rec = got[0]
        check(" plan=pp1/dp1/tp2 " in out and " device=cuda" in out,
              f"(q6) rank {r} plan:\n{out[-3000:]}")
        m = re.search(r"^process_group backend=(\S+) rank=(\d) world=2 .* "
                      r"(transport=\S+)$", out, re.M)
        check(m is not None and m.group(1) == "gloo"
              and int(m.group(2)) == r
              and m.group(3).startswith("transport=host_staged("),
              f"(q6) rank {r} process group line:\n{out[-3000:]}")
        check(rec["launches"] == want,
              f"(q6) rank {r} launches {rec['launches']} != {want}")
        check(rec["q_shape"][2] == H // 2,
              f"(q6) rank {r} q shape {rec['q_shape']}: not {H // 2} of "
              f"{H} heads")
        steps, final_loss = _losses(out)
        check(len(steps) == MAIN_STEPS - 1 and final_loss is not None,
              f"(q6) rank {r} lacks the step/loss lines:\n{out[-3000:]}")
        rel = [abs(a - b) / abs(b) for a, b in
               zip(steps + [final_loss], main["losses"] + [main["final"]])]
        check(rel[0] <= Q6_FIRST_RTOL,
              f"(q6) rank {r} step-2 loss {steps[0]} vs the main path's "
              f"{main['losses'][0]}: rel {rel[0]:.2e} > {Q6_FIRST_RTOL}")
        check(max(rel[1:]) <= Q6_LATER_RTOL,
              f"(q6) rank {r} losses {steps} + {final_loss} vs {main}: rel "
              f"{rel} > {Q6_LATER_RTOL}")
        times = sorted(float(t) for t in re.findall(r"step_time=(\S+)",
                                                    out))
        rec.update(losses=steps, final=final_loss, rel=rel,
                   step_time=times[len(times) // 2],
                   tp_allreduces_a_step=4 * L + 2)
        rec["tp_collective_ms_a_step_est"] = \
            rec["tp_allreduce_ms"] * rec["tp_allreduces_a_step"]
        ranks.append(rec)
    return {"ranks": ranks, "created_to_completed_s": q_job_seconds(final),
            "replicaStatuses": final.status["replicaStatuses"],
            "members": ["worker-0", "worker-0.1"],
            "main_path_step_time": main["step_time"]}


def q7_start(repo):
    """(q7): `kfx run` of BASELINE.json #4 in a process of its own (no
    KFX_ variable in its env, so its trials run on cuda), with a fresh
    home under build/q7; its handle for q7_finish."""
    import shutil

    home = os.path.join(repo, "build", "q7")
    shutil.rmtree(home, ignore_errors=True)
    return cli_start(repo, home, ["run", "-f", os.path.join(
        repo, "examples", "torch", Q7_EXAMPLE)]) + (home,)


def q7_finish(proc, th, lines, home, timeout=600):
    """(q7)'s checks on BASELINE.json #4 through `kfx run`: the Experiment
    Succeeded with 6 of 6 trials and a `best trial:` line, every trial's
    runner on cuda, currentOptimalTrial's accuracy the largest final
    accuracy= of the trials, the Suggestion's requests 6."""
    from kubeflow_tpu_torch.core.store import ResourceStore

    out, stamp = q_proc_lines(proc, th, lines, timeout)
    name = "mnist-random"
    best_line = [ln for ln in stamp if ln.startswith("best trial: ")]
    check(proc.returncode == 0 and f"experiment/{name} created" in stamp
          and f"experiment/{name} succeeded" in stamp and best_line,
          f"(q7) kfx run rc {proc.returncode}:\n{out[-4000:]}")
    store = ResourceStore(os.path.join(home, "state.db"))
    try:
        exp = store.get("Experiment", name)
        requests = store.get("Suggestion", name).spec["requests"]
        trials = sorted(t.name for t in store.list("Trial"))
    finally:
        store.close()
    s = exp.status
    check(s["trials"] == 6 and s["trialsSucceeded"] == 6
          and len(trials) == 6 and requests == 6,
          f"(q7) {s}, trials {trials}, requests {requests}")
    accs, starts = {}, {}
    for t in trials:
        with open(os.path.join(home, "gangs", f"jaxjob_default_{t}", "logs",
                               "worker-0.log")) as f:
            tlog = f.read()
        start = re.findall(r"^runner_start .*$", tlog, re.M)
        final = re.findall(r"^accuracy=(\S+)$", tlog, re.M)
        check(start and all(" platform=cuda " in ln + " " for ln in start)
              and final, f"(q7) trial {t}'s log:\n{tlog[-3000:]}")
        starts[t], accs[t] = start[-1], float(final[-1])
    best = s["currentOptimalTrial"]
    top = max(accs.values())
    check(float(best["observation"]["metrics"][0]["latest"]) == top
          and accs[best["bestTrialName"]] == top
          and best["bestTrialName"] in best_line[0],
          f"(q7) best {best} vs the trials' accuracies {accs}")
    return {"apply_to_succeeded_s": stamp[f"experiment/{name} succeeded"]
            - stamp[f"experiment/{name} created"],
            "trials_succeeded": s["trialsSucceeded"], "requests": requests,
            "accuracy": accs, "best": best["bestTrialName"],
            "best_assignments": best["parameterAssignments"],
            "best_trial_line": best_line[0],
            "runner_start": starts[best["bestTrialName"]]}


def q8_random_arm(exp):
    """The random arm of a NAS example: a JAXJob running the example's
    trial command, its parameters at their one value, plus
    Q8_RANDOM_ARGV — the same runner at the same budget."""
    from kubeflow_tpu_torch.operators.hpo import render_trial_spec

    values = {p["name"]: p["feasibleSpace"]["list"][0]
              for p in exp.parameters()}
    spec = render_trial_spec(exp.trial_template()["trialSpec"],
                             exp.trial_parameters(), values)
    (c,) = spec["spec"]["jaxReplicaSpecs"]["Worker"]["template"]["spec"][
        "containers"]
    return q_jaxjob(f"{exp.name}-random",
                    c["command"] + c.get("args", []) + Q8_RANDOM_ARGV,
                    backoff=0)


def q8_val_acc(out, source, edges, what):
    """(runner_start line, genotype, val_acc) of a NAS runner's log, checked:
    on cuda, ``arch_source=<source>``, ``edges`` names from OPS, one
    finite val_acc."""
    from kubeflow_tpu_torch.hpo.darts import OPS

    start = re.findall(r"^runner_start .*$", out, re.M)
    geno = re.findall(rf"^genotype=(\S+) arch_source={source}$", out, re.M)
    acc = re.findall(r"^step=\d+ val_acc=(\S+)$", out, re.M)
    genotype = geno[0].split("|") if len(geno) == 1 else []
    check(len(start) == 1 and " platform=cuda" in start[0]
          and len(genotype) == edges and set(genotype) <= set(OPS)
          and len(acc) == 1 and math.isfinite(float(acc[0])),
          f"{what} log:\n{out[-3000:]}")
    return start[0], genotype, float(acc[0])


def q8_checks(cp, exp, timeout=600):
    """(q8)'s checks on one NAS example and its random arm."""
    from kubeflow_tpu_torch.api.base import parse_utc

    name = exp.name
    deadline = time.monotonic() + timeout
    while True:
        final = cp.store.get("Experiment", name)
        if final.has_condition("Succeeded") or final.has_condition("Failed") \
                or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    s = final.status
    best = s.get("currentOptimalTrial") or {}
    check(final.has_condition("Succeeded") and s.get("trials") == 1
          and s.get("trialsSucceeded") == 1 and best,
          f"(q8) {name}: {[c.to_dict() for c in final.conditions]} {s}")
    edges = int(next(p["feasibleSpace"]["list"][0]
                     for p in exp.parameters() if p["name"] == "edges"))
    out = cp.job_logs("JAXJob", best["bestTrialName"])
    start, genotype, acc = q8_val_acc(out, "search", edges, f"(q8) {name}")
    objective = float(best["observation"]["metrics"][0]["latest"])
    check(objective == acc, f"(q8) {name}: objective {objective} is not "
          f"the trial's val_acc {acc}")
    rewards = [float(x) for x in re.findall(r" reward_mean=(\S+)", out)]
    check(name != "enas-nas" or rewards, f"(q8) {name}: no reward_mean=")
    arm, rlog = q_wait(cp, "JAXJob", f"{name}-random")
    check(arm.has_condition("Succeeded"), f"(q8) {name}-random {arm.status}"
          f"\n{rlog[-3000:]}")
    _, rgeno, racc = q8_val_acc(rlog, "random", edges, f"(q8) {name}-random")
    log(f"hpo (q8) {name}: searched {'|'.join(genotype)} val_acc {acc}, "
        f"random arm {'|'.join(rgeno)} val_acc {racc}")
    check(acc > Q8_MIN_ACC and acc > racc + Q8_MARGIN,
          f"(q8) {name}: searched val_acc {acc} vs random {racc}: the bars "
          f"are > {Q8_MIN_ACC} and > random + {Q8_MARGIN}")
    return {"seconds": (parse_utc(final.status["completionTime"])
                        - parse_utc(final.metadata.creation_timestamp)
                        ).total_seconds(),
            "genotype": genotype, "val_acc": acc, "objective": objective,
            "runner_start": start, "reward_mean": rewards,
            "random": {"genotype": rgeno, "val_acc": racc,
                       "created_to_completed_s": q_job_seconds(arm)}}


# -- (s) pipelines, platform and SLOs in (q)'s plane --------------------------

S1_PIPELINE = "lm-train-serve"
S1_TRAIN = f"{S1_PIPELINE}-train"
S1_SERVE = f"{S1_PIPELINE}-serve"


def s1_pipeline(examples, lm_worker_cmd):
    """(s1): examples/torch/lm-train-serve-pipeline.yaml as a manifest, its
    train step's command (q2)'s (this script with --lm-worker, the main
    path's runner argv, --no-checkpoint) plus the example's --export-dir
    into the pipeline's workspace; its serve step the example's."""
    import yaml

    with open(os.path.join(examples, S1_EXAMPLE)) as f:
        doc = yaml.safe_load(f)
    train, serve = doc["spec"]["steps"]
    (c,) = train["template"]["spec"]["containers"]
    export = [a for a in c["command"] if a.startswith("--export-dir=")]
    check(doc["metadata"]["name"] == S1_PIPELINE and train["name"] == "train"
          and serve["name"] == "serve" and len(export) == 1,
          f"(s1) the example's steps: {doc['spec']['steps']}")
    c["command"] = lm_worker_cmd + export
    return doc


def s1_checks(cp, timeout=900):
    """(s1)'s checks past the train step's: the Pipeline Succeeded with
    status.steps {train, serve} both Succeeded, its replica's server_ready
    line on cuda, and S1_NEW greedy tokens from :generate on the service's
    URL, the same tokens twice; the seconds from the Pipeline's creation to
    the train step's end, to the service's Ready and to the Pipeline's
    Succeeded."""
    from kubeflow_tpu_torch.api.base import get_condition, parse_utc

    deadline = time.monotonic() + timeout
    while True:
        pipe = cp.store.get("Pipeline", S1_PIPELINE)
        if pipe.has_condition("Succeeded") or pipe.has_condition("Failed") \
                or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    isvc = cp.store.try_get("InferenceService", S1_SERVE)
    check(pipe.has_condition("Succeeded") and pipe.status["steps"] == {
        "train": "Succeeded", "serve": "Succeeded"} and isvc is not None,
        f"(s1) {json.dumps(pipe.status)}")
    ready = r_ready_lines(cp.home, S1_SERVE)
    check(len(ready) == 1 and all(" device=cuda" in ln
                                  for ln in ready.values()),
          f"(s1) the serve step's replicas: {ready}")
    gen = f"{isvc.status['url']}/v1/models/{S1_SERVE}:generate"
    body = json.dumps({"prompt_tokens": S1_PROMPT,
                       "max_new_tokens": S1_NEW}).encode()
    outs, ms = [], []
    for _ in range(2):
        t = time.perf_counter()
        req = urllib.request.Request(
            gen, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            outs.append(json.load(r)["generated_tokens"][0])
        ms.append((time.perf_counter() - t) * 1e3)
    check(all(len(o) == S1_NEW for o in outs) and outs[0] == outs[1],
          f"(s1) :generate of {S1_NEW} tokens twice: {outs}")
    created = parse_utc(pipe.metadata.creation_timestamp)

    def since(ts):
        return (parse_utc(ts) - created).total_seconds()

    train = cp.store.get("JAXJob", S1_TRAIN)
    return {"steps": pipe.status["steps"], "tokens": outs[0],
            "generate_ms": ms, "server_ready": list(ready.values())[0],
            "apply_to_train_end_s": since(train.status["completionTime"]),
            "apply_to_serve_ready_s": since(get_condition(
                isvc.conditions, "Ready").last_transition_time),
            "apply_to_succeeded_s": since(get_condition(
                pipe.conditions, "Succeeded").last_transition_time)}


def s2_checks(cp, timeout=60):
    """(s2): the SLO on (s1)'s service, read from the plane's objects once
    its scraper holds (s1)'s two requests and the SLO engine has evaluated
    after that: Ready with its two generated burn rules, its budget and
    burn rows finite, BudgetHealthy, and both rules in the rule engine's
    states."""
    name = S2_SLO["metadata"]["name"]
    isvc = S2_SLO["spec"]["selector"]["isvc"]
    deadline = time.monotonic() + timeout

    def scraped():
        return sum(v for lab, v in cp.telemetry.latest_samples(
            "kfx_router_requests_total", {"isvc": isvc})
            if lab.get("code") == "2xx")

    while scraped() < 2 and time.monotonic() < deadline:
        time.sleep(0.1)
    seen = scraped()
    t = time.time()
    while cp.slos.last_eval <= t and time.monotonic() < deadline:
        time.sleep(0.1)
    slo = cp.store.get("SLO", name)
    st = slo.status
    rules = [f"slo-{name}-fast-burn", f"slo-{name}-slow-burn"]
    states = {r["name"]: r for r in cp.alerts.states()}
    rows = [st.get(k) for k in ("budgetRemaining", "burnRateFast",
                                "burnRateSlow")]
    check(seen >= 2 and cp.slos.last_eval > t
          and slo.has_condition("Ready") and st.get("rules") == rules
          and all(isinstance(v, (int, float)) and math.isfinite(v)
                  for v in rows)
          and slo.has_condition("BudgetHealthy")
          and all(r in states for r in rules),
          f"(s2) scraped {seen} requests; {json.dumps(st)}; rule states "
          f"{sorted(states)}")
    return {"requests_scraped": seen, "budgetRemaining": rows[0],
            "burnRateFast": rows[1], "burnRateSlow": rows[2],
            "rules": {r: states[r]["state"] for r in rules}}


def s3_sleep_job(name, seconds, labels=None):
    """A one-Worker JAXJob in S3_NS printing whether S3_ENV reached it,
    then sleeping ``seconds`` (host only)."""
    doc = q_jaxjob(name, [sys.executable, "-c", (
        f"import os, time; print('{S3_ENV}=' + "
        f"str(os.environ.get('{S3_ENV}')), flush=True); "
        f"time.sleep({seconds})")], backoff=0)
    doc["metadata"]["namespace"] = S3_NS
    if labels:
        doc["metadata"]["labels"] = labels
    return doc


def s3_start(cp, examples, timeout=60):
    """(s3), host only, beside (q)'s jobs: a Profile capping S3_NS at one
    job, a PodDefault there injecting S3_ENV into jobs labelled team: s3,
    the notebook example with S3_IDLE_S idle seconds; then s3-first
    (labelled) and, once it runs, s3-second. The notebook's status.url and
    /api/kernels are read as soon as it is Ready (it is culled soon
    after); returns what s3_finish checks."""
    from kubeflow_tpu_torch.api.base import from_manifest
    from kubeflow_tpu_torch.api.manifest import load_manifest_file

    profile = {"apiVersion": "kubeflow.org/v1", "kind": "Profile",
               "metadata": {"name": S3_NS},
               "spec": {"owner": {"kind": "User", "name": "s3@example.com"},
                        "resourceQuotaSpec": {"hard": {"count/jobs": 1}}}}
    poddefault = {"apiVersion": "kubeflow.org/v1", "kind": "PodDefault",
                  "metadata": {"name": "s3-env", "namespace": S3_NS},
                  "spec": {"selector": {"matchLabels": {"team": "s3"}},
                           "env": [{"name": S3_ENV, "value": "yes"}]}}
    [nb] = load_manifest_file(os.path.join(examples, "notebook.yaml"))
    nb.metadata.annotations["notebooks.kubeflow.org/idle-seconds"] = \
        str(S3_IDLE_S)
    cp.apply([from_manifest(profile), from_manifest(poddefault), nb])
    cp.apply([from_manifest(s3_sleep_job("s3-first", 3.0,
                                         {"team": "s3"}))])
    deadline = time.monotonic() + timeout
    while not cp.store.get("JAXJob", "s3-first", S3_NS).has_condition(
            "Running"):
        check(time.monotonic() < deadline, "(s3) s3-first never ran")
        time.sleep(0.05)
    cp.apply([from_manifest(s3_sleep_job("s3-second", 0.0))])
    got = cp.wait_for_condition("Notebook", nb.name, "Ready",
                                timeout=timeout)
    url = got.status["url"]
    with urllib.request.urlopen(url, timeout=10) as r:
        code = r.status
    with urllib.request.urlopen(url + "/api/kernels", timeout=10) as r:
        kernels = json.load(r)
    check(code == 200 and kernels[0]["execution_state"] == "idle",
          f"(s3) notebook at {url}: {code} {kernels}")
    return {"notebook": nb.name, "url": url, "kernels": kernels}


def s3_finish(cp, started, timeout=120):
    """(s3)'s checks: the Profile Ready; s3-second Queued with the
    scheduler's quota reason (count/jobs=1) while s3-first held the
    namespace, then admitted and run after s3-first's end; the PodDefault's
    env in s3-first's log and not in s3-second's; the notebook culled
    after its idle window, its gang gone."""
    from kubeflow_tpu_torch.api.base import get_condition, parse_utc

    first = cp.wait_for_job("JAXJob", "s3-first", S3_NS, timeout=timeout)
    second = cp.wait_for_job("JAXJob", "s3-second", S3_NS, timeout=timeout)
    logs = [cp.job_logs("JAXJob", n, S3_NS)
            for n in ("s3-first", "s3-second")]
    quota = [e.message for e in cp.store.events_for(
        "JAXJob", f"{S3_NS}/s3-second") if e.reason == "QuotaExceeded"]
    applied = [e.message for e in cp.store.events_for(
        "JAXJob", f"{S3_NS}/s3-first") if e.reason == "PodDefaultsApplied"]
    queued = get_condition(second.conditions, "Queued")
    waited = (parse_utc(second.status["startTime"])
              - parse_utc(first.status["completionTime"])).total_seconds()
    check(cp.store.get("Profile", S3_NS).has_condition("Ready")
          and first.has_condition("Succeeded")
          and second.has_condition("Succeeded")
          and quota and "count/jobs=1" in quota[0]
          and queued is not None and queued.status == "False"
          and waited >= 0 and applied == ["s3-env"]
          and f"{S3_ENV}=yes" in logs[0] and f"{S3_ENV}=None" in logs[1],
          f"(s3) quota events {quota}, queued {queued}, second started "
          f"{waited} s after first ended, poddefaults {applied}\n"
          f"{logs[0][-1500:]}\n{logs[1][-1500:]}")
    deadline = time.monotonic() + timeout
    while True:
        nb = cp.store.get("Notebook", started["notebook"])
        if nb.has_condition("Culled") or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    culled = get_condition(nb.conditions, "Culled")
    check(nb.has_condition("Culled") and not nb.has_condition("Ready")
          and cp.gangs.get(f"notebook/{nb.key}") is None,
          f"(s3) notebook {[c.to_dict() for c in nb.conditions]}")
    return {"quota_reason": quota[0], "second_start_after_first_end_s":
            waited, "poddefaults": applied,
            "notebook_url": started["url"],
            "notebook_culled_after_s": (
                parse_utc(culled.last_transition_time)
                - parse_utc(nb.metadata.creation_timestamp)).total_seconds(),
            "idle_seconds": S3_IDLE_S}


def s4_trace(repo, home):
    """(s4): `python -m kubeflow_tpu_torch.cli --home <plane> trace` of
    (s1)'s train step once the plane has stopped, as a Chrome trace and as
    the waterfall. The tree must hold admission -> the Pipeline's
    reconcile -> the step's reconcile -> gang.spawn -> runner.init, and the
    runner's xla.compile and train.window spans under the same gang.spawn."""
    out = os.path.join(home, "s4_trace.json")
    argv = [sys.executable, "-m", "kubeflow_tpu_torch.cli", "--home", home,
            "trace", "jaxjob", S1_TRAIN]
    runs = [subprocess.run(argv + extra, capture_output=True, text=True,
                           env=compat_env(repo), cwd=repo, timeout=120)
            for extra in (["--format", "chrome", "--output", out],
                          ["--min-ms", "100"])]
    check(all(r.returncode == 0 for r in runs),
          f"(s4) kfx trace: {[(r.returncode, r.stderr[-2000:]) for r in runs]}")
    with open(out) as f:
        events = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    by_span = {e["args"]["span"]: e for e in events}

    def chain(e):
        names = []
        while e is not None:
            names.append((e["name"], e["args"].get("kind", "")))
            e = by_span.get(e["args"]["parent"])
        return names

    want = [("runner.init", ""), ("gang.spawn", ""),
            ("reconcile", "JAXJob"), ("reconcile", "Pipeline"),
            ("admission", "")]
    inits = [chain(e) for e in events if e["name"] == "runner.init"]
    train = [chain(e) for e in events
             if e["name"] in ("xla.compile", "train.window")]
    check(len(inits) == 1 and inits[0] == want and train
          and all(c[1:] == want[1:] for c in train),
          f"(s4) runner.init {inits}, train spans {train[:3]}")
    return {"spans": len(events), "runner_init_chain": [n for n, _ in want],
            "train_spans": len(train),
            "waterfall_head": runs[1].stdout.splitlines()[:24]}

# -- (t) the apiserver, kfctl and the profiler --------------------------------

def t_kfx(repo, home, argv, cwd=None, timeout=300, **env):
    """One `kfx --home HOME ARGV` to its end, with compat_env plus ``env``:
    (return code, stdout and stderr)."""
    r = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.cli", "--home", home]
        + argv, capture_output=True, text=True, env=compat_env(repo, **env),
        cwd=cwd or repo, timeout=timeout)
    return r.returncode, r.stdout + r.stderr


def t_server_start(repo, home):
    """(t1): `kfx server` on a free port in its own process, with no KFX_
    variable in its env; waits for its marker and /healthz (the home's
    live_server_url). (process, url, seconds to ready)."""
    from kubeflow_tpu_torch.apiserver import live_server_url
    from kubeflow_tpu_torch.utils.net import free_port

    port = free_port()
    t0 = time.perf_counter()
    with open(os.path.join(home, "server.log"), "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.cli", "--home", home,
             "server", "--port", str(port)], stdout=f,
            stderr=subprocess.STDOUT, text=True, env=compat_env(repo),
            cwd=repo)
    url = None
    while url is None and proc.poll() is None \
            and time.perf_counter() - t0 < 60:
        url = live_server_url(home)
        time.sleep(0.05)
    check(url == f"http://127.0.0.1:{port}",
          f"(t1) kfx server rc {proc.poll()} url {url}:\n"
          f"{open(os.path.join(home, 'server.log')).read()[-3000:]}")
    return proc, url, time.perf_counter() - t0


def t_no_cuda(pid):
    """(t1): the server process holds no CUDA context while its job
    trains: nvidia-smi lists no compute app of its pid, and its address
    space maps no libcuda."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    pids = [int(x) for x in smi.split() if x.strip().isdigit()]
    with open(f"/proc/{pid}/maps") as f:
        maps = f.read()
    check(pid not in pids and "libcuda" not in maps,
          f"(t1) the server (pid {pid}) on the card: compute apps {pids}, "
          f"libcuda mapped {'libcuda' in maps}")
    return {"compute_app_pids": pids, "server_pid": pid,
            "server_maps_libcuda": False}


def t_kfdef(repo, root, home, lm_worker_cmd):
    """(t2): `kfx init` scaffolds kfdef.yaml; its one application is the
    main path's LM command as a JAXJob with ``--steps ${param.steps}``;
    `kfx generate` renders it in apply order, the Profile first."""
    import yaml

    rc, out = t_kfx(repo, home, ["init", T_PLATFORM, "--platform-namespace",
                                 T_NS], cwd=root)
    path = os.path.join(root, "kfdef.yaml")
    check(rc == 0 and "wrote kfdef.yaml" in out, f"(t2) kfx init: {out}")
    with open(path) as f:
        doc = yaml.safe_load(f)
    check(doc["kind"] == "KfDef" and doc["spec"]["namespace"] == T_NS
          and doc["spec"]["applications"] == [], f"(t2) scaffold {doc}")
    cmd = list(lm_worker_cmd)
    cmd[cmd.index("--steps") + 1] = "${param.steps}"
    job = q_jaxjob(T_JOB, cmd, backoff=0)
    del job["metadata"]["namespace"]   # the KfDef stamps its own
    doc["spec"]["commonLabels"].update(T_LABELS)
    doc["spec"]["applications"] = [{"name": "lm", "resource": job,
                                    "parameters": {"steps": T_STEPS}}]
    with open(path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)
    rc, out = t_kfx(repo, home, ["generate", "-f", path, "-o",
                                 os.path.join(root, "manifests")], cwd=root)
    files = [os.path.basename(ln) for ln in out.split()]
    check(rc == 0 and files == [f"00-profile-{T_NS}.yaml",
                                f"01-jaxjob-{T_JOB}.yaml"],
          f"(t2) kfx generate rc {rc}: {out}")
    return path, files


def t_first_step(starts, timeout=300):
    """Wait for the first step= line of (t)'s worker; the seconds waited."""
    member = (f"jaxjob_{T_NS}_{T_JOB}", "worker-0")
    t0 = time.perf_counter()
    while not starts.steps.get(member):
        check(time.perf_counter() - t0 < timeout,
              f"(t3) no step= line from {member} in {timeout} s")
        time.sleep(0.05)
    return time.perf_counter() - t0


def t_profile(repo, root, home):
    """(t3): `kfx profile` of the running job with no KFX_SERVER (a passive
    plane on the server's home, as the reference routes it): rc 0 and one
    trace path under <logdir>/plugins/profile/<run>/. (path, seconds of
    the verb)."""
    from kubeflow_tpu_torch.profiling import TRACE_SUFFIX

    logdir = os.path.join(root, "profile")
    t0 = time.perf_counter()
    rc, out = t_kfx(repo, home, ["-n", T_NS, "profile", "jaxjob", T_JOB,
                                 "--duration-ms", str(T_PROFILE_MS),
                                 "--logdir", logdir])
    paths = [ln for ln in out.splitlines() if ln.endswith(TRACE_SUFFIX)]
    check(rc == 0 and len(paths) == 1 and os.path.dirname(os.path.dirname(
        paths[0])) == os.path.join(logdir, "plugins", "profile"),
        f"(t3) kfx profile rc {rc}:\n{out[-3000:]}")
    return paths[0], time.perf_counter() - t0


def _busy_us(events):
    """Microseconds of the union of the events' [ts, ts + dur)."""
    total, end = 0.0, None
    for e in sorted(events, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def t_trace_kernels(path, kernel_ms):
    """(t3)'s checks on the trace: it parses; its kernel events name the
    three flash kernels, each at least once; it holds aten:: ops of the
    worker's main thread (where the runner trains; the capture ran on
    another). Per flash kernel its launches in the window and mean device
    us, beside the kernel table's CUDA-event ms; the window's five kernels
    with the most device time; the device's busy share in the window."""
    from kubeflow_tpu_torch.profiling import load_trace

    trace = load_trace(path)
    head, ev = trace["kfxCapture"], trace["traceEvents"]
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    flash = {}
    for name, sym in FLASH_SYMBOLS.items():
        durs = [e["dur"] for e in kernels if sym in e["name"]]
        flash[name] = {"symbol": sym, "launches": len(durs),
                       "mean_us": sum(durs) / len(durs) if durs else None,
                       "table_ms": kernel_ms[name]}
    aten = [e for e in ev if e.get("cat") == "cpu_op"
            and e.get("name", "").startswith("aten::")]
    main = [e for e in aten if e.get("tid") == head["main_tid"]]
    check(all(r["launches"] for r in flash.values()) and main
          and "CUDA" in head["activities"],
          f"(t3) trace {path}: flash {flash}, aten:: ops {len(aten)} "
          f"({len(main)} on the main thread), {head}")
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    window_s = head["end"] - head["start"]
    return {"trace": path, "window_s": window_s, "events": len(ev),
            "flash": flash,
            "top5": [{"kernel": n[:160], "us": round(us, 1),
                      "launches": sum(1 for e in kernels if e["name"] == n)}
                     for n, us in top],
            "busy_share": _busy_us(kernels) / (window_s * 1e6),
            "aten_ops": {"main_thread": len(main),
                         "other_threads": len(aten) - len(main)},
            "_head": head}


def t_trace_steps(rec, steps):
    """The runner's step times inside the window, after it while the
    profiler stops and exports (kfxCapture's stop_s + export_s), and
    outside both (the profiler's overhead), a step placed by its
    midpoint; ``rec`` is t_trace_kernels' record."""
    import statistics

    head = rec.pop("_head")
    ready = head["end"] + head["stop_s"] + head["export_s"]
    inside, export, outside = [], [], []
    for stamp, line in steps[1:]:   # the first step pays the warm-up
        st = float(re.search(r"step_time=(\S+)", line).group(1))
        mid = stamp - st / 2
        (inside if head["start"] <= mid <= head["end"] else export
         if head["end"] < mid <= ready else outside).append(st)
    check(inside and outside, f"(t3) steps inside {inside}, outside "
          f"{outside} the window {head['start']}..{head['end']}")
    return dict(rec, stop_s=head["stop_s"], export_s=head["export_s"],

                step_time_in_window=inside, step_time_during_export=export,
                step_time_outside=outside,
                median_in=statistics.median(inside),
                median_out=statistics.median(outside))


def t_http(repo, home, url):
    """(t2)'s dashboard, metrics and remote-CLI checks, made while the job
    trains: GET / and the job's page 200 with the job's state, /metrics a
    valid exposition, `KFX_SERVER=<url> kfx get jaxjobs` and `kfx logs`
    answer with the job and its step= lines."""
    from kubeflow_tpu_torch.api.base import display_state
    from kubeflow_tpu_torch.apiserver import Client
    from kubeflow_tpu_torch.utils.prom import validate_exposition

    job = Client(url).get("jaxjob", T_NS, T_JOB)
    state = display_state(job.get("status", {}).get("conditions", []))
    out = {}
    for path in ("/", f"/ui/jaxjob/{T_NS}/{T_JOB}", "/metrics"):
        with urllib.request.urlopen(url + path, timeout=60) as r:
            out[path] = (r.status, r.read().decode())
    root, page, metrics = (out[p] for p in out)
    errors = validate_exposition(metrics[1])
    check(root[0] == page[0] == metrics[0] == 200 and T_JOB in root[1]
          and state in ("Running", "Succeeded") and state in root[1]
          and state in page[1] and not errors
          and "kfx_reconcile_duration_seconds" in metrics[1],
          f"(t2) dashboard and /metrics ({state}): "
          f"{[(p, c) for p, (c, _) in out.items()]} exposition errors "
          f"{errors[:5]}")
    for argv, want_text in ((["-n", T_NS, "get", "jaxjobs"], T_JOB),
                            (["-n", T_NS, "logs", "jaxjob", T_JOB],
                             "step=")):
        rc, text = t_kfx(repo, home, argv, KFX_SERVER=url)
        check(rc == 0 and want_text in text,
              f"(t2) KFX_SERVER kfx {' '.join(argv)} rc {rc}:\n{text}")
    return {"state": state, "dashboard": 200, "job_page": 200,
            "metrics_lines": metrics[1].count("\n")}


def t_open_gate(starts, gang, gate, timeout=600):
    """Set ``gate`` once ``gang``'s worker-0 has printed train_done (a
    RunnerStarts ``starts`` reads it); left unset after ``timeout``."""
    t0 = time.perf_counter()
    while (gang, "worker-0") not in starts.done:
        if time.perf_counter() - t0 > timeout:
            return
        time.sleep(0.05)
    gate.set()


def t_phase(repo, lm_worker_cmd, starts, kernel_ms, layers, gate):
    """(t): `kfx server`, a KfDef through the remote CLI, and `kfx profile`
    of its LM job (see the module docstring); runs on a thread of (q) and
    starts only processes, which it stops. Its home, build/t, must not
    exist: ``starts`` would read an earlier run's logs there. The KfDef is
    applied once ``gate`` is set, when (s1)'s train step has ended its
    training (its train_done line; its eval batch and export follow, and
    this job's first step comes 20 s or more after its apply): with both
    base-preset LM jobs, (q6)'s two ranks and the rest of (q) on the card
    at once, the card's memory in use reached 80.8 of 85.0 GB."""
    import signal
    import statistics

    from kubeflow_tpu_torch.apiserver import SERVER_MARKER, Client

    t0 = time.perf_counter()
    root = home = os.path.join(repo, "build", "t")   # emptied by q_phase
    os.makedirs(root)
    rec = {}
    server, url, rec["server_ready_s"] = t_server_start(repo, home)
    run = None
    try:
        path, rec["generated"] = t_kfdef(repo, root, home, lm_worker_cmd)
        t1 = time.perf_counter()
        check(gate.wait(timeout=600), "(t2) (s1)'s train step never ended")
        rec["gate_wait_s"] = time.perf_counter() - t1
        run = cli_start(repo, home, ["run", "-f", path, "--timeout", "600"],
                        KFX_SERVER=url)
        rec["apply_to_first_step_s"] = t_first_step(starts)
        rec["no_cuda"] = t_no_cuda(server.pid)
        trace, verb_s = t_profile(repo, root, home)
        traced = t_trace_kernels(trace, kernel_ms)   # while the job trains
        rec["http"] = t_http(repo, home, url)
        out, stamp = q_proc_lines(*run, timeout=600)
        check(run[0].returncode == 0
              and all(ln in stamp for ln in (
                  f"profile/{T_NS} created", f"jaxjob/{T_JOB} created",
                  f"jaxjob/{T_JOB} succeeded"))
              and "note: admin token withheld" not in out,
              f"(t2) KFX_SERVER kfx run rc {run[0].returncode}:\n"
              f"{out[-4000:]}")
        start = re.search(r"^runner_start .*$", out, re.M)
        got = _rank_lines(out, "lm_worker ")
        steps, final = _losses(out)
        L = layers
        want = {"flash_fwd": L * T_STEPS + L, "flash_dq": L * T_STEPS,
                "flash_dkv": L * T_STEPS}
        check(start is not None and " device=cuda" in start.group(0)
              and got and got[-1]["launches"] == want
              and len(steps) == T_STEPS - 1 and final is not None
              and all(math.isfinite(x) for x in steps + [final]),
              f"(t2) the job's log (launches want {want}):\n{out[-4000:]}")
        client = Client(url)
        job = client.get("jaxjob", T_NS, T_JOB)
        prof = client.get("profile", "default", T_NS)
        labels = job["metadata"].get("labels", {})
        check(job["metadata"]["namespace"] == T_NS
              and labels.get("team") == "t"
              and labels.get("app.kubernetes.io/part-of") == T_PLATFORM
              and prof["spec"]["owner"]["name"] == f"{T_PLATFORM}@kfdef",
              f"(t2) stored: {job['metadata']} {prof}")
        rec["profile"] = t_trace_steps(
            traced, starts.steps[(f"jaxjob_{T_NS}_{T_JOB}", "worker-0")])
        rec["profile"]["verb_seconds"] = verb_s
        rc, text = t_kfx(repo, home, ["delete", "-f", path], KFX_SERVER=url)
        check(rc == 0 and text.find(f"jaxjob/{T_JOB} deleted")
              < text.find(f"profile/{T_NS} deleted")
              and f"jaxjob/{T_JOB} deleted" in text
              and not client.list("jaxjob", T_NS),
              f"(t4) KFX_SERVER kfx delete -f rc {rc}:\n{text}")
        server.send_signal(signal.SIGTERM)
        rc = server.wait(timeout=60)
        check(rc == 0 and not os.path.exists(os.path.join(
            home, SERVER_MARKER)), f"(t4) kfx server after SIGTERM: rc {rc}")
        rec.update(
            launches=got[-1]["launches"], losses=steps, final=final,
            runner_start=start.group(0),
            card_used_gb_max=got[-1].get("card_used_gb_max"),
            apply_to_succeeded_s=stamp[f"jaxjob/{T_JOB} succeeded"]
            - stamp[f"jaxjob/{T_JOB} created"],
            runner_train_s=float(re.search(
                r"train_done steps=\d+ wall_seconds=(\S+)", out).group(1)),
            step_time=statistics.median(float(x) for x in re.findall(
                r"step_time=(\S+)", out)),
            seconds=time.perf_counter() - t0)
    finally:
        for p in (server, run[0] if run else None):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    return rec


def q_phase(torch, fa, repo, main_launches, main, kernel_ms):
    """(q): the training control plane on the card, its workers on cuda
    with no device env set, every job side by side (each is mostly
    start-up, and every step time here is taken under that contention):
    (t) on a thread (t_phase: `kfx server` in its own process, a KfDef of
    the main path's LM through the remote CLI, `kfx profile` of its
    worker; kernel_ms, the kernel table's ms, sits beside the in-job
    times), and in a journaled plane in this process (s1) the train-then-serve Pipeline,
    whose train step is (q2)'s job: the main path's LM command as a
    one-Worker JAXJob, and whose serve step serves its export on the card
    ((s2) an SLO on that service; s1_checks, s2_checks), (q3) tests/test_chaos.py's crash story as a JAXJob (the runner corrupts
    its step-20 save and crashes there, exit 137; the restart quarantines
    20 and resumes from 10: (k7)'s checks), (q4)
    examples/torch/pytorchjob-mnist.yaml at two ranks, (q5)
    examples/torch/mpijob-resnet-cifar10.yaml through the mpirun shim
    ((o3)'s checks) and (q6) the main path's LM command as a JAXJob of one
    Worker whose spec.parallelism is {tensor: 2}, two ranks of one replica
    ((p1)'s checks). Beside them run, as plain processes, (o2)'s
    PyTorchJob workers and (i2)'s crash-and-resume chains, each with its
    own checks. Katib beside them: (q8) in the plane the DARTS and ENAS
    examples with a random arm each (q8_checks; (q7) runs beside (j)-(l)).
    Host only beside them, (s3): a Profile's quota, a PodDefault and the
    notebook example (s3_start, s3_finish). Then each job's plane spans
    (plane_spans) and, once the plane has stopped, (s4) `kfx trace` of
    (s1)'s train step.
    Flash launch counters of this process set to 0 just before and read
    just after (0/0/0: the kernels run in the workers of (s1)'s train step,
    (q6) and (t), which report their own)."""
    import shutil
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from kubeflow_tpu_torch.api.base import from_manifest
    from kubeflow_tpu_torch.api.manifest import load_manifest_file
    from kubeflow_tpu_torch.controlplane import ControlPlane
    from kubeflow_tpu_torch.models.transformer import preset_config

    t0 = time.perf_counter()
    fa.reset_launches()
    saved = q_env_clean()
    root = os.path.join(repo, "build", "q")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    homes = {"plane": os.path.join(root, "plane"),
             "t": os.path.join(repo, "build", "t")}
    shutil.rmtree(homes["t"], ignore_errors=True)
    starts = RunnerStarts([os.path.join(h, "gangs") for h in homes.values()])
    examples = os.path.join(repo, "examples", "torch")
    lm_worker_cmd = [sys.executable, os.path.join(repo, "chip_smoke.py"),
                     "--lm-worker"] + MAIN_ARGV + ["--no-checkpoint"]
    rec = {}
    s1 = s1_pipeline(examples, lm_worker_cmd)
    pool = ThreadPoolExecutor(2)
    t_gate = threading.Event()
    t = pool.submit(t_phase, repo, lm_worker_cmd, starts, kernel_ms,
                    main_launches["flash_dq"] // MAIN_STEPS, t_gate)
    o2 = start_procs(repo, compat_jobs(repo))
    i2 = pool.submit(classifier_resume_check, repo)
    try:
        with ControlPlane(home=homes["plane"], journal=True) as cp:
            check(cp.manager.controllers["JAXJob"].platform_for(None)
                  == "cuda", "(q) the plane's default device")
            exits = record_exits(cp)
            q3 = q_jaxjob("q3-resume", [
                sys.executable, "-m", "kubeflow_tpu_torch.runners.jax_runner"]
                + Q3_ARGV, env={"KFX_CHAOS": Q3_CHAOS.format(
                    state=os.path.join(root, "q3_chaos.json"))}, backoff=2)
            q6 = q_jaxjob("q6-tp2", lm_worker_cmd, backoff=0,
                          parallelism={"tensor": 2})
            [pt] = load_manifest_file(os.path.join(
                examples, "pytorchjob-mnist.yaml"))
            [mpi] = load_manifest_file(os.path.join(
                examples, "mpijob-resnet-cifar10.yaml"))
            nas = [load_manifest_file(os.path.join(examples, f))[0]
                   for f in Q8_EXAMPLES]
            jobs = [("JAXJob", "q3-resume"), ("PyTorchJob", pt.name),
                    ("MPIJob", mpi.name), ("JAXJob", "q6-tp2"),
                    ("JAXJob", S1_TRAIN)]
            cp.apply([from_manifest(s1), from_manifest(S2_SLO),
                      from_manifest(q3), pt, mpi, from_manifest(q6)] + nas
                     + [from_manifest(q8_random_arm(e)) for e in nas])
            threading.Thread(target=t_open_gate, args=(
                starts, f"jaxjob_default_{S1_TRAIN}", t_gate),
                daemon=True).start()
            s3 = s3_start(cp, examples)
            done = {n: q_wait(cp, k, n) for k, n in jobs}
            rec["q8"] = {e.name: q8_checks(cp, e) for e in nas}
            rec["wave_s"] = time.perf_counter() - t0

            f3, log3 = done["q3-resume"]
            rc3 = exit_codes(exits, "q3-resume", "worker-0")
            check(f3.has_condition("Succeeded")
                  and f3.status["restartCount"] == 1 and rc3 == [137, 0]
                  and log3.count("platform=cuda") == 2
                  and all(ln in log3 for ln in (
                      "chaos_corrupt_checkpoint step=20",
                      "chaos_crash step=20", "checkpoint_quarantined step=20",
                      "resumed_from_checkpoint step=10",
                      "train_done steps=40")),
                  f"(q3) {f3.status} exit codes {rc3}\n{log3[-4000:]}")
            rec["q3"] = {"created_to_completed_s": q_job_seconds(f3),
                         "restartCount": f3.status["restartCount"],
                         "exit_codes": rc3, "resumed_step": 10,
                         "conditions": [[c.type, c.status, c.reason]
                                        for c in f3.conditions],
                         "replicaStatuses": f3.status["replicaStatuses"]}

            f4, log4 = done[pt.name]
            worker = cp.job_logs("PyTorchJob", pt.name, replica="worker-0")
            finals = [rank_lines(o, ("loss=", "accuracy="))
                      for o in (log4, worker)]
            check(chief_exit_0(f4)
                  and "rank=0 world=2 backend=gloo" in log4
                  and "rank=1 world=2 backend=gloo" in worker
                  and finals[0] == finals[1] and len(finals[0]) == 2
                  and all(math.isfinite(float(ln.split("=")[1]))
                          for ln in finals[0]),
                  f"(q4) {f4.status}\n{log4[-3000:]}\n{worker[-3000:]}")
            rec["q4"] = {"created_to_completed_s": q_job_seconds(f4),
                         "final": finals[0],
                         "replicaStatuses": f4.status["replicaStatuses"],
                         "train_wall_s": [float(v) for o in (log4, worker)
                                          for v in re.findall(
                                              r"wall_seconds=(\S+)", o)]}

            f5, log5 = done[mpi.name]
            rec["q5"] = mpijob_checks(0 if chief_exit_0(f5) else None, log5,
                                      q_job_seconds(f5))
            rec["q5"]["replicaStatuses"] = f5.status["replicaStatuses"]
            rec["q6"] = q6_checks(cp, done["q6-tp2"][0], main)

            f2, log2 = done[S1_TRAIN]
            rec["q2_s"] = q_job_seconds(f2)
            rec["s1"] = s1_checks(cp)
            rec["s2"] = s2_checks(cp)
            rec["s3"] = s3_finish(cp, s3)
        rec["s4"] = s4_trace(repo, homes["plane"])
        L = preset_config("base").n_layers
        got = _rank_lines(log2, "lm_worker ")
        losses = [float(x) for x in re.findall(r"^step=\d+ loss=(\S+)",
                                               log2, re.M)]
        final = re.search(r"^loss=(\S+)$", log2, re.M)
        times = sorted(float(t) for t in re.findall(r"step_time=(\S+)",
                                                    log2))
        check(f2.has_condition("Succeeded") and got
              and got[-1]["launches"] == main_launches
              and " device=cuda" in log2 and "seq_len=2048" in log2
              and len(losses) == MAIN_STEPS - 1 and final is not None
              and all(math.isfinite(x) for x in
                      losses + [float(final.group(1))]),
              f"(s1) train step {f2.status}\n{log2[-4000:]}")
        rec["s1"]["train"] = {"launches": got[-1]["launches"], "layers": L,
                     "losses": losses, "final": float(final.group(1)),
                     "step_time": times[len(times) // 2],
                     "main_path_step_time": main["step_time"],
                     "created_to_completed_s": rec.pop("q2_s")}
        rec["o2"] = compat_job_checks(*wait_procs(*o2))["pytorchjob"]
        rec["i2"] = i2.result()
        rec["t"] = t.result()   # (t)'s tail overlaps the plane's
    finally:
        starts.stop()
        pool.shutdown(wait=True)
        for p in o2[0]:
            if p.poll() is None:
                p.kill()
                p.wait()
        os.environ.update(saved)
    rec["spans"] = dict(plane_spans(homes["plane"], jobs, starts),
                        **plane_spans(homes["t"], [("JAXJob", T_JOB)],
                                      starts, ns=T_NS))
    check(all(s["gang_spawn_ms"] and s["reconciles"] and s["admission_ms"]
              for s in rec["spans"].values()),
          f"(q) a job without its plane spans: {rec['spans']}")
    rec["launches"] = dict(fa.LAUNCHES)
    check(rec["launches"] == {"flash_fwd": 0, "flash_dq": 0,
                              "flash_dkv": 0},
          f"(q) flash launches in this process {rec['launches']}")
    rec["seconds"] = time.perf_counter() - t0
    tr, q2r, q6r = rec["t"], rec["s1"]["train"], rec["q6"]["ranks"][0]
    log(f"plane (t) the KfDef's LM job through kfx server (Ready "
        f"{tr['server_ready_s']:.1f} s, no CUDA context) on cuda: apply to "
        f"Succeeded {tr['apply_to_succeeded_s']:.1f} s, the runner's "
        f"training {tr['runner_train_s']} s (step {tr['step_time']} s), "
        f"launches {json.dumps(tr['launches'])}; (s1) LM "
        f"base b4 4 steps as the Pipeline's train step: step "
        f"{q2r['step_time']} s (main "
        f"path {q2r['main_path_step_time']} s, alone), launches "
        f"{json.dumps(q2r['launches'])}, "
        f"{q2r['created_to_completed_s']:.1f} s; (q3) exit 137 at the "
        f"corrupted step-20 save, restartCount 1, quarantined 20, resumed "
        f"from 10, {rec['q3']['created_to_completed_s']:.1f} s; (q4) "
        f"PyTorchJob two ranks on the card over gloo, final lines equal "
        f"{rec['q4']['final']}, {rec['q4']['created_to_completed_s']:.1f} "
        f"s; (q5) MPIJob {rec['q5']['wall_s']:.1f} s; (q6) tensor: 2 as "
        f"worker-0 and worker-0.1, one replica succeeded, step "
        f"{q6r['step_time']} s, losses {q6r['losses']} + {q6r['final']} "
        f"rel {[f'{x:.2e}' for x in q6r['rel']]}, launches "
        f"{json.dumps(q6r['launches'])} on each rank, "
        f"{rec['q6']['created_to_completed_s']:.1f} s; all side by side "
        f"{rec['wave_s']:.1f} s; (q) {rec['seconds']:.1f} s")
    for name, s in rec["spans"].items():
        log(f"plane spans {name}: {json.dumps(s)}")
    log("hpo (q8) " + "; ".join(
        f"{n} {r['seconds']:.1f} s val_acc {r['val_acc']} (random arm "
        f"{r['random']['val_acc']})" for n, r in rec["q8"].items()))
    s1, s2, s3, s4 = (rec[k] for k in ("s1", "s2", "s3", "s4"))
    log(f"pipelines (s1) {S1_PIPELINE}: steps {s1['steps']}, from apply "
        f"the train step ended at {s1['apply_to_train_end_s']:.1f} s, the "
        f"service Ready at {s1['apply_to_serve_ready_s']:.1f} s, the "
        f"Pipeline Succeeded at {s1['apply_to_succeeded_s']:.1f} s; "
        f":generate of {S1_NEW} tokens twice, equal, "
        f"{[round(x, 1) for x in s1['generate_ms']]} ms; (s2) SLO budget "
        f"{s2['budgetRemaining']} burn {s2['burnRateFast']}/"
        f"{s2['burnRateSlow']} over {s2['requests_scraped']} scraped "
        f"requests, rules {s2['rules']}; (s3) {s3['quota_reason']}, "
        f"s3-second started {s3['second_start_after_first_end_s']:.2f} s "
        f"after s3-first ended, PodDefaults {s3['poddefaults']}, notebook "
        f"culled {s3['notebook_culled_after_s']:.1f} s after creation "
        f"(idle {S3_IDLE_S} s); (s4) kfx trace: {s4['spans']} spans, "
        f"{' -> '.join(reversed(s4['runner_init_chain']))}, "
        f"{s4['train_spans']} train spans")
    for ln in s4["waterfall_head"]:
        log(f"  (s4) {ln}")
    pr = tr["profile"]
    log(f"profile (t3) kfx profile of {T_JOB} ({T_PROFILE_MS} ms, the verb "
        f"{pr['verb_seconds']:.1f} s): " + "; ".join(
            f"{n} {r['launches']} launches, {r['mean_us']:.1f} us each "
            f"(table {r['table_ms'] * 1e3:.1f} us alone)"
            for n, r in pr["flash"].items())
        + f"; busy share {pr['busy_share']:.3f}; step {pr['median_in']} s "
        f"in the window, {pr['step_time_during_export']} s while the "
        f"profiler stopped ({pr['stop_s']:.1f} s) and exported "
        f"({pr['export_s']:.1f} s), {pr['median_out']} s outside; card in "
        f"use at most {tr['card_used_gb_max']:.1f} GB")
    return rec


# -- (p) the LM trainer across ranks ------------------------------------------

def _rank_lines(out, prefix):
    return [json.loads(ln[ln.index("{"):]) for ln in out.splitlines()
            if ln.startswith(prefix)]


def lm_worker(argv) -> int:
    """The worker of (s1)'s train step and (q6) (``--lm-worker ARGV``,
    their JAXJobs' command): the LM runner with ARGV in this process, its flash launch
    counters set to 0 just before and read just after, then one
    ``lm_worker {...}`` line: its rank, its launches, the shapes of its
    first q and residual, its peak memory, the most memory in use on the
    whole card while it ran (``torch.cuda.mem_get_info`` every 0.25 s once
    the runner has a CUDA context: what every process beside it holds
    too), and where the runner made a process group, the time of one tp
    all-reduce of [b, S, d] bf16 over that group."""
    import threading

    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import transformer as TR
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.runners import lm_runner
    from kubeflow_tpu_torch.runtime.lifetime import install_parent_watch

    install_parent_watch()
    seen = {}
    cuda = lm_runner.parse_args(argv).device == "cuda"
    used, stop = [0.0], threading.Event()

    def sample():
        while not stop.wait(0.25):
            if torch.cuda.is_initialized():
                free, total = torch.cuda.mem_get_info()
                used[0] = max(used[0], (total - free) / 1e9)

    sampler = threading.Thread(target=sample, daemon=True)
    if cuda:
        sampler.start()
    destroy = dist.destroy_process_group
    dist.destroy_process_group = lambda *a, **k: None   # for the probe
    fa.reset_launches()
    try:
        with TR.activation_probe(
                lambda name, x: seen.setdefault(name, list(x.shape))):
            rc = lm_runner.main(argv)
    finally:
        dist.destroy_process_group = destroy
        stop.set()
    rec = {"rank": 0, "launches": dict(fa.LAUNCHES),
           "q_shape": seen.get("attn_q"),
           "residual_shape": seen.get("residual"),
           "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                              if cuda else 0.0),
           "card_used_gb_max": used[0]}
    if dist.is_initialized():
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        x = torch.ones(P_TP_ELEMS, dtype=torch.bfloat16,
                       device="cuda" if cuda else "cpu")
        dist.all_reduce(x)
        sync()
        t0 = time.perf_counter()
        for _ in range(P_TP_REPS):
            dist.all_reduce(x)
        sync()
        rec.update(rank=dist.get_rank(), tp_allreduce_ms=(
            time.perf_counter() - t0) / P_TP_REPS * 1e3)
    print("lm_worker " + json.dumps(rec), flush=True)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return rc


def _losses(out):
    steps = [float(x) for x in re.findall(r"^step=\d+ loss=(\S+)", out,
                                          re.M)]
    final = re.search(r"^loss=(\S+)$", out, re.M)
    return steps, (float(final.group(1)) if final else None)


def p2_phase(torch, repo, dev):
    """(p2): the spmd_check variants at base width, 4 layers, S 2048, f32,
    two ranks each on the one card (``P2_SIDE_BY_SIDE`` variants at once),
    against world 1 in this process; then dp2 with --collective-overlap on
    through the runner against world 1 on the same global batch."""
    import threading

    import numpy as np

    from kubeflow_tpu_torch.data.lm import get_lm_dataset
    from kubeflow_tpu_torch.models.transformer import preset_config
    from kubeflow_tpu_torch.parallel import spmd_check as sc
    from kubeflow_tpu_torch.parallel.lm_train import (LMHyperParams,
                                                      LMTrainLoop)

    work = os.path.join(repo, "build", "p2")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    multi, errors, seconds = {}, [], {}
    slots = threading.Semaphore(P2_SIDE_BY_SIDE)

    def run(v):
        with slots:
            t = time.perf_counter()
            try:
                multi[v] = sc.cross_process_losses(
                    v, work, n_processes=2, device=dev.type,
                    config=P2_CONFIG, timeout=900)
            except Exception as e:  # reported below, fails the phase
                errors.append(f"{v}: {e}")
            seconds[v] = time.perf_counter() - t

    threads = [threading.Thread(target=run, args=(v,)) for v in sc.VARIANTS]
    for t in threads:
        t.start()
    single = {}
    for v in sc.VARIANTS:
        single[v] = sc.run_losses(v, 1, dev, P2_CONFIG, like=2)
        torch.cuda.empty_cache()
    for t in threads:
        t.join(1200)
    check(not any(t.is_alive() for t in threads) and not errors,
          f"(p2) spmd_check ranks failed: {errors}")
    rec = {"variants": {}}
    for v in sc.VARIANTS:
        sc.assert_close(single[v], multi[v])
        rec["variants"][v] = {
            "world1": single[v], "multi": multi[v], "seconds": seconds[v],
            "max_rel": max(abs(a - b) / abs(a)
                           for a, b in zip(single[v], multi[v]))}
    # dp2 with --collective-overlap on: the runner at 2 ranks; world 1 on
    # the same global batch (shard 0 || shard 1 of each step) meanwhile.
    spans = os.path.join(work, "spans-dp2")
    got = {}

    def dp2():
        try:
            got["outs"] = sc.run_ranks(
                [sys.executable, "-m", "kubeflow_tpu_torch.runners.lm_runner",
                 *MAIN_ARGV, "--collective-overlap", "on", "--device",
                 dev.type], 2,
                env={"KFX_WORKDIR": spans}, timeout=900, cwd=repo)
        except Exception as e:  # reported below, fails the phase
            got["error"] = str(e)

    t1 = time.perf_counter()
    th = threading.Thread(target=dp2)
    th.start()
    ds = get_lm_dataset("lm-small", seed=0)
    its = [ds.batches(4, shard_index=d, num_shards=2) for d in (0, 1)]
    loop = LMTrainLoop(preset_config("base", vocab_size=ds.vocab_size,
                                     max_seq_len=ds.seq_len),
                       LMHyperParams(warmup_steps=1, total_steps=MAIN_STEPS),
                       dev)
    loop.init_state()
    want = []
    for _ in range(MAIN_STEPS):
        want.append(loop.train_step(np.concatenate(
            [next(it) for it in its]))[0])
    del loop
    torch.cuda.empty_cache()
    th.join(1200)
    check("outs" in got, f"(p2) dp2 runner ranks failed: {got.get('error')}")
    out = got["outs"][0][1]
    check(" plan=pp1/dp2/tp1 " in out, f"(p2) dp2 plan:\n{out}")
    m = re.search(r"^collective_allreduce axis=data ways=2 grad_bytes=(\d+) "
                  r"est_seconds_per_step=(\S+)$", out, re.M)
    check(m is not None, f"(p2) no collective_allreduce line:\n{out}")
    steps, _ = _losses(out)
    rel = [abs(a - b) / abs(b) for a, b in zip(steps, want[1:])]
    check(len(steps) == MAIN_STEPS - 1 and max(rel) <= sc.RTOL,
          f"(p2) dp2 losses {steps} vs world 1 {want[1:]}: rel {rel}")
    names = set()
    for f in os.listdir(os.path.join(spans, "spans")):
        with open(os.path.join(spans, "spans", f)) as fh:
            names |= {json.loads(ln)["name"] for ln in fh}
    check("train.collective" in names, f"(p2) spans recorded: {names}")
    times = sorted(float(t) for t in re.findall(r"step_time=(\S+)", out))
    rec["dp2_overlap"] = {
        "losses": steps, "world1": want[1:], "rel": rel,
        "grad_bytes": int(m.group(1)),
        "collective_est_seconds_a_step": float(m.group(2)),
        "step_time": times[len(times) // 2], "spans": sorted(names),
        "seconds": time.perf_counter() - t1}
    rec["seconds"] = time.perf_counter() - t0
    log(f"ranks (p2) spmd_check {P2_CONFIG} at 2 ranks vs world 1: " +
        ", ".join(f"{v} max rel {r['max_rel']:.2e} ({r['seconds']:.1f} s)"
                  for v, r in rec["variants"].items()) +
        f"; dp2 --collective-overlap on: losses rel "
        f"{[f'{x:.2e}' for x in rel]}, collective est "
        f"{float(m.group(2)):.4f} s a step for {m.group(1)} bytes, step "
        f"{rec['dp2_overlap']['step_time']} s; {rec['seconds']:.1f} s")
    return rec


def ranks_phase(torch, repo, dev, main):
    """(p): see the module docstring (5c)."""
    t0 = time.perf_counter()
    rec = {"p2": p2_phase(torch, repo, dev)}
    rec["seconds"] = time.perf_counter() - t0
    return rec


# -- (n) the multi-model weight pool ------------------------------------------

def pool_exports(torch, gap_cfg, dev, root):
    """The pool's three exports, written once for (n1)-(n5): m0 and m1 as
    v1 f32 exports (no format_version, no quant block), m2 as a v2 int8
    export (export_lm's quantize="int8"). Returns ({name: dir}, {name:
    host tree of the weights}, seconds)."""
    from kubeflow_tpu_torch.models.convert import params_to_jax
    from kubeflow_tpu_torch.models.transformer import TransformerLM
    from kubeflow_tpu_torch.serving.lm_server import CONFIG_FILE, export_lm

    t0 = time.perf_counter()
    sources, trees = {}, {}
    for i, seed in enumerate(POOL_SEEDS):
        name = f"m{i}"
        g = torch.Generator(device=dev).manual_seed(seed)
        model = TransformerLM(gap_cfg, device=dev, generator=g)
        wide_gap_(torch, model)
        trees[name] = params_to_jax(model.state_dict())
        del model
        d = os.path.join(root, name)
        export_lm(d, gap_cfg, trees[name],
                  quantize="int8" if name == "m2" else "")
        if name != "m2":
            path = os.path.join(d, CONFIG_FILE)
            with open(path) as f:
                meta = json.load(f)
            meta.pop("format_version", None)
            meta.pop("quant", None)
            meta["config"].pop("quant", None)
            with open(path, "w") as f:
                json.dump(meta, f)
        sources[name] = d
    torch.cuda.empty_cache()
    return sources, trees, time.perf_counter() - t0


def pool_oracles(torch, gap_cfg, sources, trees, prompts, plan, f1, dev):
    """Each prompt's greedy tokens on its model's weights: (f1)'s
    LMGenerator tokens for m0, LMGenerator on m1's weights and on m2's
    int8 export dequantized (what the f32 pool serves), each model's
    smallest top-1/top-2 gap held against (f1)'s measured disagreement of
    the engine's and LMGenerator's logits."""
    from kubeflow_tpu_torch.models.generate import LMGenerator
    from kubeflow_tpu_torch.models.transformer import dequantize_params_int8
    from kubeflow_tpu_torch.serving.lm_server import load_lm

    want, gaps = {}, {}
    for name in sorted(set(plan)):
        rows = [i for i, m in enumerate(plan) if m == name]
        if name == "m0":
            for i in rows:
                want[i] = f1["want"][i][:POOL_NEW]
            gaps[name] = f1["gap"]
            continue
        tree = trees[name] if name != "m2" else dequantize_params_int8(
            load_lm(sources[name])[1])
        gen = LMGenerator(gap_cfg, tree, device=dev)
        toks, gaps[name], _ = greedy_with_gap(
            gen, [prompts[i] for i in rows], POOL_NEW, 0)
        del gen, tree
        for i, t in zip(rows, toks):
            want[i] = t
        check(gaps[name] > GAP_MARGIN * f1["diff"],
              f"(n) {name}: argmax gap {gaps[name]:.3g} too small against "
              f"the paths' logit disagreement {f1['diff']:.3g}")
    torch.cuda.empty_cache()
    return [want[i] for i in range(len(plan))], gaps


def pool_server_check(sources, prompts, n1_tokens, dev):
    """(n4) LMPredictor with KFX_LM_MODELS naming the three exports and
    KFX_LM_WEIGHT_SLOTS=2 behind an in-process ModelServer, as a user
    sets them: a model "m1" :generate equal to (n1)'s tokens, "nope" a
    400, GET /v1/models/m2 pooled, :evict of m1, a weights.load fault a
    503 with Retry-After then a 200, and the weight families and the swap
    cold-start series on /metrics."""
    from kubeflow_tpu_torch.serving.lm_server import LMPredictor
    from kubeflow_tpu_torch.serving.server import ModelServer

    env = {"KFX_LM_MODELS": json.dumps(sources),
           "KFX_LM_MODEL_DEFAULT": "m0", "KFX_LM_WEIGHT_SLOTS": "2"}
    os.environ.update(env)
    try:
        pred = LMPredictor(sources["m0"], name="lm", device=str(dev),
                           warm_buckets=[8])
        pred.load()
    finally:
        for k in env:
            del os.environ[k]
    check(pred.engine is not None and not pred.engine.spec
          and pred.pooled_models() == {"m0": True, "m1": False,
                                       "m2": False},
          f"(n4) pooled models {pred.pooled_models()}")
    server = ModelServer(port=0)
    server.register(pred)
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    gen_url = f"{url}/v1/models/lm:generate"
    body = {"prompt_tokens": [prompts[1]], "max_new_tokens": POOL_NEW,
            "model": "m1"}
    rec = {}
    try:
        t0 = time.perf_counter()
        out = http_json(gen_url, body)
        rec["m1_request_s"] = time.perf_counter() - t0
        check(out["generated_tokens"][0] == n1_tokens[1],
              "(n4) model m1 over HTTP differs from (n1)")
        code, err, _ = post_status(gen_url, dict(body, model="nope"))
        check(code == 400 and "unknown model" in err["error"],
              f"(n4) unknown model answered {code} {err}")
        m2 = http_json(f"{url}/v1/models/m2")
        check(m2 == {"name": "m2", "ready": True, "pooled": True,
                     "loaded": False, "host": "lm"},
              f"(n4) GET /v1/models/m2 {m2}")
        host = http_json(f"{url}/v1/models/lm")
        check(host.get("pooledModels") == {"m0": True, "m1": True,
                                           "m2": False},
              f"(n4) host status {host}")
        ev = http_json(f"{url}/v1/models/lm:evict", {"model": "m1"})
        check(ev == {"model": "m1", "evicted": True}, f"(n4) :evict {ev}")
        with chaos_env("weights.load:count=1"):
            code, err, hdr = post_status(gen_url, body)
        check(code == 503 and hdr.get("Retry-After") is not None
              and "chaos[weights.load]" in err.get("error", ""),
              f"(n4) weights.load fault answered {code} {err}")
        out = http_json(gen_url, body)
        check(out["generated_tokens"][0] == n1_tokens[1],
              "(n4) the request after the fault differs from (n1)")
        text = http_json(f"{url}/metrics")
        fams = ("kfx_lm_weight_slots", "kfx_lm_weight_slots_free",
                "kfx_lm_weight_models_loaded", "kfx_lm_weight_loads_total",
                "kfx_lm_weight_swap_seconds",
                "kfx_lm_weight_evictions_total",
                "kfx_lm_weight_model_loaded")
        missing = [f for f in fams if f not in text]
        swap = re.search(r'^kfx_autoscaler_cold_start_seconds_count\{'
                         r'[^}]*mode="swap"[^}]*\} (\S+)$', text, re.M)
        check(not missing and swap is not None and float(swap.group(1)) >= 2,
              f"(n4) /metrics lacks {missing} or the swap cold starts")
        engine = http_json(f"{url}/metrics?format=json")["engine"]["lm"]
        rec.update({"swap_cold_starts": float(swap.group(1)),
                    "engine_block": {k: engine.get(k) for k in (
                        "weight_slots", "weight_slots_free",
                        "weight_models_loaded", "pooled")},
                    "weight_stats": pred.weight_stats()})
    finally:
        server.stop()
        if pred._warm_thread is not None:
            pred._warm_thread.join(timeout=300)
        pred.close()
    return rec


def pool_chunk_groups(torch, eng, prompts):
    """(n3) the chunk at 8 active slots by hand on the stopped pooled
    engine ``eng`` (models m0 and m1 resident or loadable): one weight
    group, then two groups of 4 (unprofiled, 3 reps each). Records the
    process's live threads beside the times: the chunk is host-bound, so
    a thread left by an earlier phase competes with it for the
    interpreter."""
    import threading

    one_ms, one_enq, _ = chunk_by_hand(torch, eng, prompts, profile=False,
                                       models=["m0"] * ENGINE_SLOTS)
    eng._fail_inflight(RuntimeError("(n3) next configuration"))
    half = ENGINE_SLOTS // 2
    two_ms, two_enq, _ = chunk_by_hand(
        torch, eng, prompts, profile=False,
        models=["m0"] * half + ["m1"] * (ENGINE_SLOTS - half))
    threads = sorted(t.name for t in threading.enumerate())
    rec = {"one_group_chunk_ms": one_ms, "one_group_enqueue_ms": one_enq,
           "two_group_chunk_ms": two_ms, "two_group_enqueue_ms": two_enq,
           "ratio": two_ms / one_ms, "threads": len(threads),
           "thread_names": threads}
    log(f"weights (n3) chunk at {ENGINE_SLOTS} slots ({ENGINE_CHUNK} steps, "
        f"f32): one weight group {one_ms:.2f} ms (enqueue {one_enq:.2f} "
        f"ms), two groups of {half} {two_ms:.2f} ms (enqueue "
        f"{two_enq:.2f} ms), ratio {two_ms / one_ms:.3f}; "
        f"{len(threads)} threads live")
    return rec


def pool_chunk_alone(torch, dev, repo):
    """``--n3-alone``: (n3) in a fresh process, with no phase before it:
    the three exports and a pooled engine as phase (n) builds them, then
    pool_chunk_groups on (a)'s prompts."""
    from kubeflow_tpu_torch.models.transformer import preset_config
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    gap_cfg = preset_config("base", max_seq_len=2048, dtype="float32",
                            attn_impl="naive")
    sources, trees, _ = pool_exports(torch, gap_cfg, dev,
                                     os.path.join(repo, "build", "pool"))
    eng = DecodeEngine(gap_cfg, trees["m0"], name="pool", models=sources,
                       model_default="m0", weight_slots=POOL_SLOTS,
                       n_slots=ENGINE_SLOTS, chunk_tokens=ENGINE_CHUNK,
                       kv_page_size=ENGINE_PAGE,
                       prefill_chunk_tokens=ENGINE_PREFILL_CHUNK, device=dev)
    del trees
    eng.close()
    rec = pool_chunk_groups(torch, eng, serve_prompts(gap_cfg.vocab_size))
    eng._fail_inflight(RuntimeError("(n3) done"))
    return rec


def pool_phase(torch, fa, gap_cfg, prompts, f1, dev, repo):
    """(n) the multi-model weight pool at the base preset's full width;
    see the module docstring. ``f1`` holds phase (f1)'s LMGenerator tokens
    and gaps on the m0 weights. Returns the {"weights": ...} record."""
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    t_phase = time.perf_counter()
    rec = {"seconds": {}, "slots": POOL_SLOTS, "new_tokens": POOL_NEW}
    t_sub = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        rec["seconds"][name] = now - t_sub[0]
        t_sub[0] = now

    fa.reset_launches()
    sources, trees, rec["export_s"] = pool_exports(
        torch, gap_cfg, dev, os.path.join(repo, "build", "pool"))
    plan = [f"m{i % len(POOL_SEEDS)}" for i in range(len(prompts))]
    want, rec["gaps"] = pool_oracles(torch, gap_cfg, sources, trees,
                                     prompts, plan, f1, dev)
    lap("exports_and_oracles")

    # (n1) 8 prompts over 3 models and 2 slots, all submitted at once
    kw = dict(n_slots=ENGINE_SLOTS, chunk_tokens=ENGINE_CHUNK,
              kv_page_size=ENGINE_PAGE,
              prefill_chunk_tokens=ENGINE_PREFILL_CHUNK, device=dev)
    eng = DecodeEngine(gap_cfg, trees["m0"], name="pool", models=sources,
                       model_default="m0", weight_slots=POOL_SLOTS,
                       request_timeout_s=600.0, **kw)
    wp = eng._wpool
    swaps, real_load = [], wp._load_into

    def load_into(name, slot):
        real_load(name, slot)
        swaps.append(dict(wp.last_swap))

    wp._load_into = load_into
    t0 = time.perf_counter()
    reqs = [eng.submit(p, POOL_NEW, model=m) for p, m in zip(prompts, plan)]
    got = [r.result(600) for r in reqs]
    n1_s = time.perf_counter() - t0
    del wp._load_into   # the pool's own method again (no cycle to keep)
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    check(not bad, f"(n1) pooled greedy tokens differ from LMGenerator in "
                   f"rows {bad} (models {[plan[i] for i in bad]})")
    st = eng.weight_stats()
    check(st["loads"] >= 3 and st["evictions"] >= 1,
          f"(n1) weight stats {st}")
    pages = eng.page_stats()
    check(pages["free"] + pages["cached"] == pages["pages"],
          f"(n1) page leak {pages}")
    check(int(wp.ref.sum()) == 0 and st["free"] == POOL_SLOTS - 1,
          f"(n1) weight slots still pinned: ref {wp.ref.tolist()}, {st}")
    rec["n1"] = {"seconds": n1_s, "tokens": len(prompts) * POOL_NEW,
                 "tokens_per_s": len(prompts) * POOL_NEW / n1_s,
                 "weight_stats": st, "pages": pages, "swaps": swaps}
    log(f"weights (n1) {len(prompts)} prompts over {len(POOL_SEEDS)} models "
        f"and {POOL_SLOTS} slots, {POOL_NEW} greedy tokens each == "
        f"LMGenerator (gaps {rec['gaps']}): {n1_s:.2f} s, loads "
        f"{st['loads']}, evictions {st['evictions']}, swaps "
        f"{[(w['model'], round(w['seconds'], 3)) for w in swaps]}")
    lap("n1")

    # (n2) the swap: evict m1, then a 1-token request cold against warm
    if "m1" not in wp.loaded():
        eng.generate([prompts[1]], 1, model="m1")
    slot_bytes = sum(t.numel() * t.element_size() for t in wp.module(
        wp._by_name["m1"]).state_dict().values())
    torch.cuda.synchronize()
    hbm0, alloc0 = eng.hbm_bytes()["weights"], torch.cuda.memory_allocated()
    check(eng.evict_model("m1"), "(n2) m1 was not evicted")
    torch.cuda.synchronize()
    hbm1, alloc1 = eng.hbm_bytes()["weights"], torch.cuda.memory_allocated()
    check(hbm0 - hbm1 == slot_bytes,
          f"(n2) hbm weights fell {hbm0 - hbm1} for a {slot_bytes}-byte slot")
    check(alloc0 - alloc1 >= 0.99 * slot_bytes,
          f"(n2) allocated fell {alloc0 - alloc1} for a {slot_bytes}-byte "
          "slot")
    t0 = time.perf_counter()
    cold = eng.generate([prompts[1]], 1, model="m1")[0]
    cold_s = time.perf_counter() - t0
    swap = dict(wp.last_swap)
    t0 = time.perf_counter()
    warm = eng.generate([prompts[1]], 1, model="m1")[0]
    warm_s = time.perf_counter() - t0
    check(cold == warm == want[1][:1], f"(n2) cold {cold} warm {warm}")
    check(torch.cuda.memory_allocated() - alloc1 >= 0.99 * slot_bytes,
          "(n2) the reload did not take the slot's bytes back")
    rec["n2"] = {"cold_1tok_s": cold_s, "warm_1tok_s": warm_s,
                 "swap_s": max(cold_s - warm_s, 0.0), "split": swap,
                 "device_gb_per_s": swap["bytes"] / swap["device_s"] / 1e9,
                 "slot_bytes": slot_bytes,
                 "hbm_weights_drop": hbm0 - hbm1,
                 "allocated_drop": alloc0 - alloc1}
    log(f"weights (n2) swap of m1 ({slot_bytes / 1e9:.3f} GB): 1-token "
        f"request cold {cold_s:.3f} s, warm {warm_s:.3f} s; swap "
        f"{swap['seconds']:.3f} s = initialize + load_lm "
        f"{swap['load_s']:.3f} s + normalize {swap['normalize_s']:.3f} s + "
        f"to the card {swap['device_s']:.3f} s "
        f"({rec['n2']['device_gb_per_s']:.2f} GB/s); hbm weights fell "
        f"{hbm0 - hbm1} B, allocated fell {alloc0 - alloc1} B")
    lap("n2")

    # (n3) the chunk at 8 active slots by hand: one weight group, then two
    # groups of 4 (the loop stopped; the pool keeps its models)
    eng.close()
    rec["n3"] = pool_chunk_groups(torch, eng, prompts)
    lap("n3")

    # (n5) HBM: the pool (2 models resident) against one dedicated engine
    # with the same KV geometry
    pooled = eng.hbm_bytes()
    eng._fail_inflight(RuntimeError("(n5) done"))
    del eng, wp
    torch.cuda.empty_cache()
    ded = DecodeEngine(gap_cfg, trees["m0"], name="pool-ded", **kw)
    ded.close()
    dedicated = ded.hbm_bytes()
    del ded
    torch.cuda.empty_cache()
    rec["n5"] = {"pooled": pooled, "dedicated": dedicated,
                 "hbm_ratio": pooled["total"] / dedicated["total"]}
    log(f"weights (n5) HBM: pool of 2 resident models "
        f"{pooled['total'] / 1e9:.3f} GB (weights beyond the default "
        f"{pooled['weights'] / 1e9:.3f} GB) against a dedicated engine "
        f"{dedicated['total'] / 1e9:.3f} GB: ratio "
        f"{rec['n5']['hbm_ratio']:.4f}")
    lap("n5")
    del trees

    # (n4) the server
    rec["n4"] = pool_server_check(sources, prompts, got, dev)
    log(f"weights (n4) server: m1 over HTTP == (n1), unknown model 400, "
        f"pooled readiness, :evict, weights.load 503 + Retry-After then "
        f"200; {json.dumps(rec['n4'])}")
    lap("n4")
    torch.cuda.empty_cache()
    rec["flash_launches"] = dict(fa.LAUNCHES)
    check(all(v == 0 for v in rec["flash_launches"].values()),
          f"(n) flash launches {rec['flash_launches']}")
    rec["phase_seconds"] = time.perf_counter() - t_phase
    log(f"weights (n) seconds {json.dumps(rec['seconds'])}, phase "
        f"{rec['phase_seconds']:.1f} s; flash launches "
        f"{rec['flash_launches']}")
    return rec


def gap_config():
    """The base preset at full width in f32 with naive attention: the
    wide-gap weights' config of (b) and every phase after it."""
    from kubeflow_tpu_torch.models.transformer import preset_config

    return preset_config("base", max_seq_len=2048, dtype="float32",
                         attn_impl="naive")


# -- (m) and (n) in a child process beside (j)-(l) -----------------------------
#
# Phases (m) and (n) need only the main path's export, (a)'s prompts and
# (f1)'s tokens and gaps, and (j)-(n) are host-bound (16-19% device busy
# share in (f3)), so (m) then (n) run in a second process on the card while
# (j), (k) and (l) run in this one: each phase keeps every check, and every
# time these five phases print is taken beside the other process.

def beside_start(repo, export_dir, prompts, f1):
    """Start ``chip_smoke.py --beside STATE OUT`` (a plain fork and exec,
    no preexec_fn), its output to build/beside/beside.log. Returns its
    handle for beside_join and beside_stop."""
    work = os.path.join(repo, "build", "beside")
    os.makedirs(work, exist_ok=True)
    state, out = (os.path.join(work, n) for n in ("state.json",
                                                   "records.json"))
    with open(state, "w") as f:
        json.dump({"export_dir": export_dir, "prompts": prompts,
                   "f1": {"want": [[int(t) for t in w] for w in f1["want"]],
                          "gap": float(f1["gap"]),
                          "diff": float(f1["diff"])}}, f)
    if os.path.exists(out):
        os.remove(out)
    path = os.path.join(work, "beside.log")
    with open(path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--beside", state,
             out], stdout=logf, stderr=subprocess.STDOUT, cwd=repo)
    return {"proc": proc, "out": out, "log": path}


def beside_join(beside, timeout=900):
    """Wait for the child, print its log here, fail unless it exited 0;
    its {"kv": ..., "weights": ..., "j5": ..., "seconds": ...} record."""
    proc = beside["proc"]
    try:
        rc = proc.wait(timeout)
    except subprocess.TimeoutExpired:
        rc = f"still running after {timeout} s"
    with open(beside["log"]) as f:
        text = f.read()
    for line in text.splitlines():
        log(line)
    check(rc == 0, f"(m)/(n)/(j5) beside (j)-(l): exit {rc}:\n"
                   f"{text[-4000:]}")
    with open(beside["out"]) as f:
        return json.load(f)


def beside_stop(beside):
    """Kill the child if it still runs (this process failed first)."""
    proc = beside["proc"]
    if proc.poll() is None:
        proc.kill()
        proc.wait(30)


def beside_child(torch, dev, repo, state_path, out_path) -> int:
    """``--beside STATE OUT``: phases (m), (n) and (j5) in this process
    with the state beside_start wrote, then their records and seconds to
    OUT. It kills itself if its parent dies."""
    from kubeflow_tpu_torch.ops import build
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.runtime.lifetime import install_parent_watch

    install_parent_watch()
    t0 = time.perf_counter()
    with open(state_path) as f:
        st = json.load(f)
    build.load_library()
    gap_cfg = gap_config()
    kv = kv_phase(torch, fa, st["export_dir"], gap_cfg, st["prompts"],
                  st["f1"], dev)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    weights = pool_phase(torch, fa, gap_cfg, st["prompts"], st["f1"], dev,
                         repo)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    j5 = j5_costs(torch, fa, st["export_dir"], st["prompts"], dev)
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    rec = {"kv": kv, "weights": weights, "j5": j5, "seconds": {
        "m_beside": t1 - t0, "n_beside": t2 - t1, "j5_beside": t3 - t2,
        "beside_wall": t3 - t0}}
    with open(out_path + ".tmp", "w") as f:
        json.dump(rec, f)
    os.replace(out_path + ".tmp", out_path)
    return 0


def main() -> int:
    import torch

    worker_argv = sys.argv[2:] if sys.argv[1:2] == ["--lm-worker"] \
        else None
    beside_argv = sys.argv[2:] if sys.argv[1:2] == ["--beside"] else None
    if beside_argv is not None and len(beside_argv) != 2:
        beside_argv = None
    if (sys.argv[1:] not in ([], ["--n3-alone"]) and worker_argv is None
            and beside_argv is None):
        print("usage: python3 chip_smoke.py [--n3-alone]", file=sys.stderr)
        return 2
    alone = sys.argv[1:] == ["--n3-alone"]
    t_script = time.perf_counter()
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
    if worker_argv is not None:
        return lm_worker(worker_argv)
    if beside_argv is not None:
        return beside_child(torch, dev, repo, *beside_argv)

    if alone:
        card = card_line()
        log(f"card: {card}")
        log(json.dumps({"n3_alone": pool_chunk_alone(torch, dev, repo)}))
        log(card)
        return 0

    # 1. the card
    card = card_line()
    log(f"card: {card}")
    phase_seconds = {}
    t_lap = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_seconds[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    # 2. build
    from kubeflow_tpu_torch.ops import build
    from kubeflow_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    build.load_library()
    log(f"build_seconds={time.perf_counter() - t0:.1f} "
        f"lib={build.BUILD_DIR / build.LIB_NAME} "
        f"(nvcc and ptxas report: {build.BUILD_DIR / 'build.log'})")
    ptxas = wgmma_ptxas_report((build.BUILD_DIR / "build.log").read_text())
    check(len(ptxas) == 6, f"ptxas report of the wgmma kernels: {ptxas}")
    for kern, (regs, spill) in sorted(ptxas.items()):
        log(f"ptxas {kern}: {regs} registers, {spill} bytes spill stores")
        check(spill == 0, f"{kern} spills {spill} bytes")

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
    lap("build_kernels")

    # 4. model
    model_phase(torch, dev)
    lap("model")

    # 5. main path
    export_dir = os.path.join(repo, "build", "serve_export")
    launches, base_step, main = main_path_phase(torch, fa, export_dir)
    torch.cuda.empty_cache()
    lap("main_path")

    # 5c. the LM trainer across ranks
    ranks = ranks_phase(torch, repo, dev, main)
    torch.cuda.empty_cache()
    lap("p")

    # 5b. training options: remat policies, chunked CE, MoE
    training = training_phase(torch, fa, dev)
    torch.cuda.empty_cache()
    lap("h")

    # 6. serving
    gap_cfg = gap_config()
    serving, prompts = serving_phase(torch, fa, export_dir, gap_cfg, dev)
    torch.cuda.empty_cache()
    lap("a_serving")
    engine = engine_phase(torch, fa, export_dir, gap_cfg, prompts, dev)
    f1, f2_tokens = engine.pop("_f1"), engine.pop("_f2_tokens")
    torch.cuda.empty_cache()
    lap("f_engine")
    spec = spec_phase(torch, fa, export_dir, gap_cfg, prompts, f1, f2_tokens,
                      dev)
    torch.cuda.empty_cache()
    lap("g_spec")

    # 6m, 6n. the request and KV transfer planes, then the weight pool,
    # in a child process beside (j)-(l)
    beside = beside_start(repo, export_dir, prompts, f1)
    # (q7) BASELINE.json #4 through `kfx run`, beside (j)-(l) as well
    q7 = q7_start(repo)
    try:
        # 6j. int8 serving; 6k. the chaos points (k6 rides phase (i))
        int8 = int8_phase(torch, fa, export_dir, gap_cfg, prompts, f1, dev)
        chaos_rec = int8.pop("_chaos")
        torch.cuda.empty_cache()
        fa.reset_launches()
        chaos_rec["k5"] = chaos_kv_quant(int8.pop("_w8"), prompts, dev)
        chaos_rec["flash_launches"] = dict(fa.LAUNCHES)
        check(all(v == 0 for v in chaos_rec["flash_launches"].values()),
              f"(k) flash launches {chaos_rec['flash_launches']}")
        torch.cuda.empty_cache()
        lap("j_k")

        # 6l. multi-tenant LoRA: the fine-tune through the flash kernels,
        # then the adapter pool in the engine and the server
        lora = lora_phase(torch, fa, export_dir, gap_cfg, prompts, f1, dev,
                          base_step, {
                              "tokens_per_s":
                                  engine["engine_tokens_per_second"],
                              "chunk_ms": engine["chunk"]["chunk_ms"]})
        torch.cuda.empty_cache()
        lap("l")
        beside_rec = beside_join(beside)
        kv, weights = beside_rec["kv"], beside_rec["weights"]
        int8.update(beside_rec["j5"], beside="(m)/(n)'s child")
        for k, v in beside_rec["seconds"].items():
            phase_seconds[k] = round(v, 1)
        lap("m_n_wait")
        hpo = {"q7": q7_finish(*q7)}
        lap("q7_wait")
    finally:
        beside_stop(beside)
        if q7[0].poll() is None:
            q7[0].kill()
            q7[0].wait()
    q7r = hpo["q7"]
    log(f"hpo (q7) BASELINE.json #4 through kfx run on cuda beside (j)-(l): "
        f"6 of 6 trials succeeded, apply to Succeeded "
        f"{q7r['apply_to_succeeded_s']:.1f} s, best {q7r['best']} accuracy "
        f"{q7r['accuracy'][q7r['best']]}")

    # 6i. the classifier / JAXJob path
    classifier = classifier_phase(torch, fa, dev, repo)
    chaos_rec["k6"] = classifier.pop("chaos_predict")
    cls_pred = classifier["serving"].pop("_pred")
    lap("i")

    # 6r. the serving tier: BASELINE.json #5 as an InferenceService, the
    # pytorch: canary ((o1)), a scale-up and a killed replica
    serving_tier = r_phase(torch, fa, dev, repo, cls_pred,
                           classifier["serving"]["batch1"]["p50_ms"])
    del cls_pred
    torch.cuda.empty_cache()
    lap("r")

    # 6q. the training control plane: kfx run, the gang runtime and the
    # four training operators launching the port's runners on the card
    plane = q_phase(torch, fa, repo, launches, main,
                    {r["name"]: r["ms"] for r in main_recs})
    chaos_rec["k7"] = dict(plane["q3"], through="the control plane, (q3)")
    compat = {"predictor": dict(serving_tier["r2"],
                                through="the serving tier's canary, (r2)"),
              "mpijob": dict(plane["q5"], through="the control plane, (q5)"),
              "pytorchjob": dict(plane.pop("o2"), beside="(q)")}
    classifier["resume"] = dict(plane.pop("i2"), beside="(q)")
    ranks["p1"] = dict(plane["q6"], through="the control plane, (q6)")
    import grpc

    hpo.update(q8=plane.pop("q8"), grpc=grpc.__version__)
    pipelines = {k: plane.pop(k) for k in ("s1", "s2", "s3", "s4")}
    profile = plane["t"].pop("profile")
    lap("q")

    # 7. report
    csrc = "kubeflow_tpu_torch/ops/csrc/"
    meta = {  # name: ({design: source}, the TPU kernel it replaces)
        "flash_fwd": ({"fma": csrc + "flash_fwd.cu",
                       "wgmma": csrc + "flash_fwd_wgmma.cu"},
                      "kubeflow_tpu/ops/flash_attention.py:64"),
        "flash_dq": ({"fma": csrc + "flash_bwd.cu",
                      "wgmma": csrc + "flash_dq_wgmma.cu"},
                     "kubeflow_tpu/ops/flash_attention.py:127"),
        "flash_dkv": ({"fma": csrc + "flash_bwd.cu",
                       "wgmma": csrc + "flash_dkv_wgmma.cu"},
                      "kubeflow_tpu/ops/flash_attention.py:158"),
    }

    def entries(recs, with_launches):
        out = []
        for r in recs:
            srcs, rep = meta[r["name"]]
            src = srcs[r["design"]]
            e = {"name": r["name"], "route": "cuda", "source": src,
                 "replaces": rep,
                 "launches": launches[r["name"]] if with_launches else None}
            e.update({k: v for k, v in r.items() if k != "name"})
            out.append(e)
        return out

    log(json.dumps({"kernels_large_head_dim": entries(large_recs, False)}))
    log(json.dumps({"kernels": entries(main_recs, True)}))
    log(json.dumps({"serving": serving}))
    log(json.dumps({"engine": engine}))
    log(json.dumps({"spec": spec}))
    log(json.dumps({"training": training}))
    log(json.dumps({"classifier": classifier}))
    log(json.dumps({"int8": int8}))
    log(json.dumps({"chaos": chaos_rec}))
    log(json.dumps({"lora": lora}))
    log(json.dumps({"kv": kv}))
    log(json.dumps({"weights": weights}))
    log(json.dumps({"compat": compat}))
    log(json.dumps({"ranks": ranks}))
    log(json.dumps({"plane": plane}))
    log(json.dumps({"pipelines": pipelines}))
    log(json.dumps({"profile": profile}))
    log(json.dumps({"hpo": hpo}))
    log(json.dumps({"serving_tier": serving_tier}))
    log(json.dumps({"phase_seconds": phase_seconds}))
    log(f"script_seconds={time.perf_counter() - t_script:.1f}")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
