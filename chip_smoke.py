#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out PATH]
    python3 chip_smoke.py --kernel NAME [--kernel NAME ...]
    python3 chip_smoke.py --split18-seed S [--split18-seed S ...]

Phases, each fatal on failure:
  1. report the card (name and power limit from nvidia-smi);
  2. build every CUDA kernel of the serving path from the sources in this
     checkout (nvcc, sm_90a; one nvcc per source, all started together) and
     report the build time and ptxas' register and spill lines and
     warnings (each warp-specialised flash instantiation must launch with
     WS_LAUNCH_REGS registers a thread, and no float32 flash
     instantiation, flash_tf32_kernel, may spill);
  3. hold each kernel against its plain PyTorch version on the card, at
     the serving path's own shapes (once more with lengths spread from 1
     to W across rows) and at a small fp32 shape, and time the
     kernel, the plain version and one PyTorch library call for the same
     function (CUDA graphs of many launches, timed with CUDA events);
     then hold the attention the encoders and the plain paths take
     (``attention.sdpa_f32``: bf16 operands multiplied on the tensor cores
     with a float32 result) against its float32 upcast at SAM's, CLIP's
     and the LLM prefill's shapes, and time both. Each bottleneck case
     draws from a generator of its own, seeded from its name
     (``case_rng``); each float32-x encode case runs over BN_DRAWS draws,
     the kernel's scales within SCALES_TOL of the plain version's and both
     within SCALES_TOL of a float64 product's (``encode_draws``);
  4. check the serving path on a small input: LISA-mini in fp32, the
     scheduler's tokens with the kernel equal those of the plain path, and
     once more with ``llm.use_flash=True`` (the float32 flash kernel in
     every LLM prefill layer, exactly one launch a layer and microbatch),
     its tokens equal those of the run without it;
  5. serve six mixed Context/Insight requests over two bottleneck tiers at
     the full width of LISA-7B (random bf16 weights from ``--seed``)
     through ``MicrobatchScheduler(generate=True)``, with every kernel
     launch counter set to 0 just before and read just after;
  6. serve the same requests again with every kernel launch held against
     the plain version on that launch's own inputs, once with the plain
     version in the kernel's place (every decode layer also computed with
     the kernel on the same input and held to LAYER_RTOL, ``layer_check``)
     and once through the plain attention path (``flash_decode=False``):
     tokens equal, logits and masks within stated bf16 limits;
  7. replay one Context and one Insight microbatch warm, time each, and
     trace one more run of each with ``torch.profiler``: device time by
     kernel and the device's idle share;
  8. (inflight) serve eight requests from two operators (six Context, two
     Insight over two tiers) through ``InflightDecoder(slots=4)`` over a
     paged, shared-prefix ``PagePool`` at the full width of LISA-7B, in
     waves between ``pump`` calls, with the launch counters set to 0 just
     before and read just after: the paged kernel must launch exactly
     once per layer and decode step. Then replay the schedule with every
     paged launch held against its plain version on that launch's own
     inputs, and with the plain version in the kernel's place (every
     paged decode layer also computed with the kernel on the same input
     and held to LAYER_RTOL, ``layer_check``), and hold
     each request against the one-shot ``cloud_generate_batch``; time one
     decode step, a prefix miss and a prefix hit, and trace one step.
  9. (spec) serve six requests from two operators through
     ``InflightDecoder(slots=4, spec=...)`` at the full width of LISA-7B, on
     an executor of 6 new tokens over pages of 4 slots that shares the
     serving weights: run A drafts with the serving weights (3 drafts, one
     request kept plain), run B with a divergent random draft (4 drafts;
     rejections and page rollback). Each run's launch counters start at 0:
     verify launches must be verify steps x layers, paged decode launches
     plain steps x layers, contiguous launches draft steps x layers. Both
     runs give the tokens of a spec=None decoder (answer logits bit-equal)
     and of the one-shot ``cloud_generate_batch``; a replay holds every
     verify launch against its plain version on its own inputs, another
     puts the plain version in the kernel's place (every verify layer also
     computed with the kernel on the same input and held to LAYER_RTOL,
     ``layer_check``); one speculative step is timed and one traced.
 10. (split) on an executor with ``llm.use_flash=True`` that shares the
     serving weights, each run's launch counters set to 0 just before it:
     (a) phase 5's requests through the microbatch scheduler: one flash
     launch per layer and microbatch, tokens equal to phase 5's, logits
     and masks within SDPA_PATH_RTOL of it; a replay with the flash
     kernel's plain version in its place, in which every prefill layer is
     also computed with the kernel on the same input and held to
     LAYER_RTOL (``layer_check``), and whose tokens, logits and
     masks are held to SDPA_PATH_RTOL; (b) phase
     8's schedule through ``InflightDecoder(slots=4)``: one flash launch
     per layer and prefix miss, phase 8's paged launches and tokens;
     (c) one Insight frame per tier through the split point with both
     switches on (SAM head, ``bn.encode(use_kernel=True)``, the packet,
     ``bn.decode(use_kernel=True)``, SAM tail, ``llm_generate``, mask):
     one encode and one decode launch per frame, every launch held
     against its plain version on its own inputs, and the mask logits
     against a replay with each kernel kind's plain version in its place,
     one kind at a time: flash (with the per-layer check of (a);
     SDPA_PATH_RTOL), then the bottleneck pair (PATH_RTOL; every frame's
     boundary activation from the kernels and the first SAM-tail block on
     it also held against the plain pair's on the same SAM-head output,
     LAYER_RTOL, ``layer_check`` kind "split"), each reading on its own
     line beside its limit; one frame's encode and decode timed.
 11. (zoo) LISA-7B freed, then the zoo's Mamba path at full width with
     random bf16 weights from ``--seed``, one config after the other:
     falcon-mamba-7b (64 Mamba-1 layers) and zamba2-7b (81 Mamba-2 layers
     in 9 hybrid groups behind one shared attention block), each with
     ``use_ssm_kernel=True``: (a) ``prefill_step`` on B = 2 prompts of
     1,024 tokens, counters from 0: one scan launch per Mamba layer and no
     other kernel, finite last logits; every launch held against
     ``scan_ref`` on its own inputs, the logits against a replay with
     ``scan_ref`` in the kernel's place (PATH_RTOL) and against
     ``use_ssm_kernel=False`` (SDPA_PATH_RTOL); (b) a 64-token prompt
     through ``decode_step`` from ``init_cache`` and 4 greedy tokens: no
     kernel launch, the logits at the prompt's last position against
     ``prefill_step``'s; (c, falcon-mamba-7b) ``SplitPlan(cfg, 32)``:
     32 + 32 launches, the hidden state equal to ``forward``'s; (e) a
     warm prefill and a decode step timed, one falcon-mamba-7b prefill
     traced.
 12. (engine, run before 11 frees LISA-7B) the ``AveryEngine`` front door
     on the serving weights, each run's launch counters set to 0 just
     before it: (a) ``batching="generate"``, AdaptivePolicy over a
     ``ChannelTransport`` on ``paper_trace(seed)``, two operators' sessions
     of different mission goals, six frames through ``session.submit``
     (prompts that classify as Context and as Insight, so both edge stages
     run on the card): contiguous decode launches equal to decode steps x
     layers and no other kernel; each request's intent, tier and transmit
     record printed; tokens equal to the one-shot ``cloud_generate_batch``
     on the packet its transport carried; (b) ``batching="inflight"``
     through a ``QoSScheduler``, the same frames and one more after a
     ``pump`` that joins the running batch: paged launches equal to decode
     steps x layers, tokens equal to the one-shot path's, a late join and
     a prefix hit; the reference's canonical in-flight scenario gives the
     ``stats()`` keys of ``tests/fixtures/engine_stats_keys.json``; (c)
     ``speculative=3`` on phase 9's executor: verify, paged and contiguous
     launches equal to verify, plain and draft steps x layers, tokens
     equal to ``speculative=None``'s but for at most MAX_TIES near ties
     (where a request's tokens first differ, each run's token leads its
     own logits for it on the same prefix, the two tokens' logits within
     TIE_ULPS bf16 steps between the runs and all of them within
     PATH_RTOL, the margin printed), ``SpecStats`` printed;
     (d) a
     ``FaultInjector`` blackout over one send and a ``FaultyExecutor``
     decode fault, each with a ``RetryPolicy``: the blacked-out request
     retried, downshifted and served, the fault's victims equal to their
     fault-free run, and the counters equal to ``FAULT_COUNTERS`` (what the
     reference's engine gives on the same schedules, tests/
     test_torch_engine.py); then the TTFT, transmit and decode-step
     medians of (b)'s ``stats()`` and warm ``engine.pump()`` calls on four
     live rows, each timed whole and around the bare
     ``InflightDecoder.step`` it makes, each beside the card's name and
     power limit.
 13. (profile, after 12 and before 11 frees LISA-7B) the stage profiler,
     cost ledger and runtime sanitizers on phase 12's executor and frames,
     each run's launch counters set to 0 just before it: (a) 12b's engine
     and schedule with ``profile=`` (a ``StageProfiler`` on the H100's
     constants at this card's power limit) and tracing: paged launches
     steps x layers, tokens equal 12b's, ``cloud_decode_rows`` profiled
     once a step, the profiled calls equal the device track's (pid 3)
     spans of ``dump_trace``, every response's ledger equal to the
     analytic cost of ``network/energy.py``, ``decode_roofline_frac`` in
     (0, 1], each stage's calls and p50; (b) 12c's ``speculative=3``
     engine, profiled: verify, paged and contiguous launches verify,
     plain and draft steps x layers, the profiled ``draft``,
     ``cloud_verify_rows`` and ``cloud_decode_rows`` calls equal the
     decoder's own, tokens equal 12c's; (c) ``debug_recompiles=True,
     debug_transfers=True``: warm-up, ``arm_sanitizers()``, two waves of
     guarded pumps with a zero budget on every pump and drain (the census:
     kernel libraries loaded and the allocator's device allocations) and
     no sync outside the explicit window, a deliberate ``.item()`` inside
     the guard raising, the guard over ``speculative=3`` (queued rows
     admitted and verified inside guarded pumps), a census of every host
     sync on the guarded path with the window off (each site must be a
     boundary copy or wait the window admits, WINDOW_SITES), and a
     profiled engine with ``kv_pages=2`` whose pool grows, each growth
     read at the pool's own write (its bytes handed out by the allocator
     there; the flight recorder keeps the compile events the census saw);
     the profiler's cost a decode step (a profiled and a bare
     engine's warm pumps in turns, each turn's relative difference: median
     and quartiles beside the reference's 5 % budget; fails when the lower
     quartile exceeds it); (d) on a lisa-mini executor: ``run_mission`` in
     executor mode (AVERY against static High Accuracy over
     ``paper_trace(seed)``, 20 minutes), ``run_fleet`` with 4 UAVs (no
     kernel launch: the fidelity oracle's ``llm_reason`` is a prefill),
     and ``python -m repro_torch.launch.serve --smoke --batching inflight``
     and ``python -m repro_torch.analysis.sanitizers --smoke`` as
     subprocesses, each exiting 0 with its launches printed (the
     launcher's paged launches its steps x layers).
 14. (zoo14, after 11) the attention and MoE zoo at full width with random
     bf16 weights from ``--seed``, one config after the other, each freed
     before the next: granite-moe-3b-a800m (32 MoE layers, 40 experts
     top-8, GQA G = 3, hd 64), qwen2-vl-2b (28 layers, GQA G = 6, hd 128,
     M-RoPE, 256 vision embeddings), minicpm3-4b (62 MLA layers),
     hubert-xlarge (48 non-causal encoder layers, audio frames) and
     deepseek-v3-671b cut to 2 layers (one dense MLA layer, one MoE layer
     of 256 experts and a shared one), each with ``use_flash`` and
     ``use_flash_decode``: (a) the parameter counts, total and active,
     equal to the reference's ``count_params``; (b) ``prefill_step`` on
     B = 2 inputs of 1,024 positions, counters from 0: one flash launch a
     layer on the GQA models and none on the others, finite logits of the
     expected shape (every position for the encoder), peak memory; (c) on
     the GQA models every prefill layer of a replay with the flash
     kernel's plain version held to LAYER_RTOL (``layer_check``, moe
     layers on the tokens whose top-k set agrees, each routing flip's
     router logits within ROUTE_TIE_LOGITS), the last logits against that
     replay and against ``use_flash=False`` (SDPA_PATH_RTOL), and for
     granite each token's first routing flip between those two runs a
     near tie (ROUTE_TIE_RUN); (d) a 64-token prompt through
     ``decode_step`` and 8 greedy tokens: decode launches steps x layers
     on the GQA models and none on MLA, their tokens against
     ``use_flash_decode=False`` (near ties under 12c's rule), every decode
     layer of the plain-kernel replay held to LAYER_RTOL, the decode
     logits at the prompt's last position against one prefill of the same
     tokens (DECODE_PREFILL_RTOL; MoE with a capacity that drops nothing,
     as decode at T = B); hubert-xlarge refuses decode; (e) granite's
     dispatch modes on each moe layer's input: routing identical, scatter
     within LAYER_RTOL of einsum, and grouped (capacity per row) too on the
     tokens whose kept slots agree with einsum's; ``attn_chunk=256``
     against unchunked attention on each layer's input (granite,
     minicpm3-4b); (f) a warm prefill and decode step timed beside the
     card line, one granite prefill and decode step traced (the device
     time by class, with the MoE dispatch's sorts, scans, index and
     gather kernels as their own class, and the idle share).
 15. (train15, after 14) the generic training path (``make_train_step``,
     ``optim.adamw`` with ``cosine_with_warmup``, ``data/lm.py``'s
     batches), no kernel on it (the wrappers refuse under grad): (a) each
     of the ten reduced configs in float32, one step on the card and on
     the CPU from the same weights and batch: metrics within TRAIN15_RTOL,
     each gradient leaf and each leaf's update within TRAIN15_NORM; (b)
     qwen2-vl-2b whole at full width in random bf16 from ``--seed``, B = 2
     x S = 1,024 (256 vision embeddings): (i) one step, its metrics and
     gradients finite, every parameter with a gradient changed, the step
     1, the peak memory beside a reckoning; (ii) its loss and gradients
     against the same step replayed in float32 (TRAIN15_F32_RTOL, each
     stacked leaf a layer at a time), which a step with one layer's
     attention probabilities detached must fail; (iii) ``sdpa_f32``'s
     tensor-core route under autograd against the float32 upcast at
     qwen2-vl-2b's layer and SAM's shape (each product, then dq, dk, dv,
     with a control); (iv) four steps on one batch, the loss falling; (v)
     one step under ``transfer_guard_ctx`` (no host sync); (vi) a warm
     step's wall and one traced step; (c) granite-moe-3b-a800m at full
     width cut to 8 layers: (i) as (b), the aux loss positive, the router's
     gradient nonzero in every layer and an expert's nonzero exactly where
     it kept a token, a warm step's wall and peak memory; (d)
     ``python -m repro_torch.launch.train --arch phi4-mini-3.8b --reduced
     --steps 4`` as a subprocess, its checkpoint read back with
     ``init_params``' leaves, shapes, dtypes and structure.
 16. (lisa16, after 15) the LISA system's offline phase on lisa-mini
     (float32), no kernel on its training path: (a) three steps each of
     ``train_lisa``, ``finetune_lisa`` and ``train_bottleneck`` (r = 0.25)
     at B = 16 on the card and on the CPU from the same port-drawn
     weights: losses within TRAIN15_RTOL, parameters within TRAIN15_NORM
     (AdamW's eps TRAIN15_EPS), one step of each under
     ``transfer_guard_ctx``; (b) ``python -m repro_torch.launch.train
     --lisa`` as a subprocess into a temporary directory, its LUT held to
     the reference tests' thresholds (LISA16_ACC, LISA16_PAYLOAD_MB,
     LISA16_CONTEXT_MB) and the trained Average IoU above the untrained
     one by LISA16_IOU_GAIN; each stage's wall, one traced ``lisa_step``;
     (c) ``python -m repro_torch.launch.serve --batching inflight`` (the
     offline phase on its small budget, then serving) as a subprocess,
     paged launches its decode steps x layers and no other kernel; the
     trained system of (b) served in flight in process with the paged
     kernel on and off: tokens equal, logits and masks within LISA16_TOL;
     (d) ``run_mission`` on the trained LUT and executor, AVERY against
     static High Accuracy; (e) ``roundtrip_st`` and ``recon_loss`` at
     LISA-7B's split point (one frame's ``sam_head`` output, 4096 x 1280
     bf16, the three tiers' ranks): the forward's codes against
     ``encode(use_kernel=True)``, the gradients to ``enc`` and ``dec``
     against a float64 CPU replay (LISA16_ST_GRAD_RTOL), which a replay
     with the encoder product in bf16 must fail.
 17. (shard17, after 16) tensor-parallel paged serving: two rank
     processes on cuda:0 over gloo (``launch.mesh.spawn_ranks``; NCCL will
     not put two ranks of one communicator on one card), each building
     LISA-7B at full width and depth from ``--seed`` (a float64 sum of
     every leaf equal on both ranks) and wrapping it in a
     ``ShardedServingContext`` over ``make_local_mesh(model=2)``: Insight
     at two tiers and Context through ``AveryEngine(mesh=, batching=
     "inflight")``, plain and with ``speculative=3`` (12c's draft), launch
     counters from 0: paged = decode steps x 32, verify = verify steps x
     32, contiguous = draft steps x 32, every launch on 16 kv heads;
     ``stats()`` with ``mesh_devices`` 2, ``model_shards`` 2 and the
     per-shard pool half the logical one; one decode and one verify step
     of each rank through ``layer_check``; each layer of one sharded
     prefill against the whole layer on its input (LAYER_RTOL); rank 0
     against the unsharded engine on the same card and weights (tokens up
     to 12c's checked near ties, logits and masks within PATH_RTOL); both
     ranks' served arrays bit-equal. Per rank: peak memory, decode and verify step walls, the
     all-reduces a step and their time (gloo staged through the host on
     one card: nothing of NCCL over NVLink).
 18. (split18, after 17) the dry-run and the pod-disaggregated split
     step: (a) ``python -m repro_torch.launch.dryrun --arch A --mesh both``
     for every architecture and ``python -m repro_torch.launch.serve
     --dryrun``, child processes all started together under
     DRYRUN18_TIMEOUT_S, one line a combo: no record with an error, the
     skipped combos exactly DRYRUN18_SKIPPED (``adapt_config`` returning
     None, as the reference's); while they run, (c) the encode and decode
     kernels at the split step's shape (bf16 x, T = 8,192, d = 1,280,
     r = 638) against their plain versions, timed beside their bound and
     the 10-call / 4-call library chains, and (b) two rank processes on
     cuda:0 over gloo (``{"pod": 2}``), each building LISA-7B at full width
     from ``--seed`` and the split bottleneck, holding one device's 2
     images at 1,024 px and queries of 8: the held argument bytes equal to
     ``split_reckoning``'s per device, ``split_serve`` plain (no kernel
     launch) and with ``use_kernel=True`` (one encode and one decode
     launch a rank, each held against its plain version on its own
     inputs, answers equal to the plain step's), the bytes that crossed
     the pod link equal to the reckoned collective-permute bytes, pod 1's
     masks and both pods' answers bit-equal to rank 0 composing the stage
     functions in one process, pod 0's masks to that composition on zero
     codes, each rank's step wall, and the kernel run's oracle, which
     holds on any seed: the encode kernel's codes at most
     SPLIT18_CODES_OFF of entries off a float64 encode's
     (``encode_f64``), and pod 1's kernel masks off the plain step's
     within SPLIT18_MASK_RATIO times the distance of the plain step
     re-summed in another order (``decode_resummed``, the control),
     beside how far pod 1's plain and kernel masks each sit from the
     float64 codes' masks (``--split18-seed S`` runs 18b alone for each
     seed given); (d) the reckoning of LISA-7B's decode step on a (1, 2)
     mesh (``dryrun.reckon_lisa_decode``) equal to phase 17's
     all-reduces, count and bytes, at each step's rows.
 19. (train19, after 18) the sharded train step: qwen2-vl-2b at full
     width (d = 1,536, 12 / 2 heads, d_ff 8,960, vocab 151,936) cut to
     TRAIN19_LAYERS = 4 layers, float32 with TF32 off, random weights
     from ``--seed``, phase 15's global batch (B = 2 x 1,024), AdamW at
     eps 1e-4, two steps: (a) the unsharded ``make_train_step`` in this
     process, no kernel launched (the wrappers raise under grad); then
     ``python -m repro_torch.sharding.training`` over two gloo rank
     processes on cuda:0, (b) at (data 2, model 1) with FSDP and (c) at
     (data 1, model 2): the metrics within TRAIN19_METRIC_RTOL of (a) and
     equal on both ranks, the reassembled parameters and both moments
     leaf by leaf within TRAIN19_LEAF_TOL of each leaf's largest
     magnitude in (a), every block both ranks hold bit-equal, each rank's
     collectives by label, kind, count and bytes held to
     ``dryrun.reckon``'s charges of the same step but the named
     departures (``dryrun.held_to_reckoning``), and each rank's step
     walls, collectives' time and peak memory (gloo staged through the
     host on one card: the arithmetic, not NCCL's speed).
 20. (zoo20, after 19) the attention kernels at head sizes 112 and 192:
     zamba2-7b at full width (81 Mamba-2 layers, its shared attention
     block of 32 heads at hd 112 once in each of 9 hybrid groups) and
     nemotron-4-340b at full widths cut to 2 layers (96 / 8 heads at
     hd 192), random bf16 weights from ``--seed``, each with
     ``use_flash``, ``use_flash_decode`` and ``use_ssm_kernel``, the first
     freed before the second: (a) the parameter counts equal to the
     reference's ``count_params``; (b) ``prefill_step`` on B = 2 prompts
     of 1,024 tokens, counters from 0: one flash launch an attention
     invocation (``attention_invocations``, from the group specs) and one
     scan launch a Mamba layer, finite logits, peak memory; (c) every
     prefill layer of a replay with the flash kernel's plain version held
     to LAYER_RTOL (``layer_check``), the last logits against that replay
     within PATH_RTOL or ZOO20_CONTROL_RATIO times a control's distance
     (the replay with the kernel's function summed in float64,
     ``_flash_f64``: no kernel, other roundings; ``replay_within``) and
     against ``use_flash=False`` (SDPA_PATH_RTOL); (d) a 64-token prompt
     through ``decode_step`` and 8 greedy tokens: decode launches steps x
     attention invocations and no other kernel, the logits against a
     replay with the decode kernel's plain version (teacher-forced; the
     same limit beside the float64 control ``_decode_f64``), the tokens
     against ``use_flash_decode=False`` (12c's near-tie rule, its scales
     widened to ZOO20_CONTROL_RATIO times the largest moves of the two
     tokens' logits and margin between the runs with no kernel: the
     control, the replay and that run),
     every decode layer held to LAYER_RTOL, the logits at the prompt's
     last position against one prefill (DECODE_PREFILL_RTOL); (e) a warm
     prefill and decode step timed beside the card line.

Phase 3 holds the contiguous decode kernel at the serving path's shapes
(B = 1 and 4, lengths spread) and at the edges of its bf16 split-K design
(W = 1, 33 and 2,048; G = 4 and 12), and the paged kernels too: the
decode kernel at the three shapes of the reference's kernel test, at the
in-flight path's shape (B = 4 and one row of it), at one page a row and at
128 pages with three rows sharing 100, at G = 4, and at the trained
lisa-mini's served step (float32, B = 8, H = K = 4, hd = 32, pages of 16,
W = 48; timed); every case of the two
decode kernels launched twice and bit-equal (deterministic). The
verify kernel at the three shapes of its reference test, one with more
than 8 queries per kv head, in bf16 with more than 8 and at hd = 64 and
32, and the speculative path's shapes (C = 4 and 5, pages of 4 and 16,
and C = 1 in bf16 and fp32 against the paged decode kernel); with rows
sharing prefix pages, ragged lengths, a plain row's pad queries, an idle
row parked on the trash page, and every page no table names filled with
NaN; every case launched twice and bit-equal. It holds the flash kernel
at the five shapes of the reference's test (causal and not, fp32 and
bf16), at the LLM prefill's (B = 1 and 4,
S = 204, bf16), once more with q, k and v as views of buffers whose
rows past S are NaN, and at long sequences: bf16 causal at 1,500 and
4,096 (SAM's token grid, LLaMA-7B's heads), bf16 at 1,000 (not causal,
NaN past S) and 777 (hd = 32), float32 at 3,000 (with NaN past S); the
bottleneck encode and decode kernels at the
reference test's shapes, at ranks wider than a cluster of column tiles,
at odd widths and ragged tiles, and at the split point's (one frame of
4096 tokens x 1280, the three tiers' ranks); and the scan kernel at the
reference test's four shapes, its 512-step long-decay case, a bf16 case
and the two zoo prefills' shapes, counting the elements that are not
bit-equal to ``scan_ref``'s. Phase 14's GQA shapes are timed there too:
the flash kernel at granite-moe-3b-a800m's and qwen2-vl-2b's prefill (B = 2,
S = 1,024; G = 3, hd 64 and G = 6, hd 128) and the decode kernel at their
last decode step's (B = 2, W = 72), each beside SDPA with ``enable_gqa``.
The head sizes that no LISA path takes (80, 112, 192) have cases of their
own (``head_dim_cases``, each drawing from ``case_rng``): the flash kernel
at zamba2-7b's and nemotron-4-340b's prefill (B = 2, S = 1,024, causal) and
SAM's tail (B = 1, S = 4,096, not causal), timed beside SDPA; at each size
bf16 causal at an odd S with NaN past S and float32 causal and not; the
decode kernel at each size's heads at phase 20's last decode step (timed),
with lengths spread over 4 rows, and in float32 with an idle row; the
paged decode (pages of 16) and verify (C = 4, pages of 4) kernels at each
size's heads over random tables, bf16 (timed) and float32.

The flash kernel runs each bf16 launch on the plan ``ops.flash_plan``
picks: the one-warpgroup kernel (WGMMA) or the warp-specialised one on two
halves of a head (WS_HALVES) or, where G is even, on two heads (WS_PAIRS).
Every flash case is launched twice and bit-equal. Its edge cases
(``flash_edge_cases``: bf16 at S = 1, 65 and 129, hd 128 and 192, causal
and not, G = 1 and 12, rows past S NaN) run under every bf16 plan. Each
timed bf16 flash case prints beside the function bound the product bound
(the products the plan's kernel issues, p_hi and p_lo and whole diagonal
tiles, at the bf16 peak), and an A/B line (``[kernel] flash A/B``): every
bf16 plan on the same inputs, in turn and then in reverse. Four more timed
cases (``flash_rule_cases``) sit on either side of the launcher's S and
grid thresholds, to read its rule there.

float32 launches take the split-TF32 kernel (plan TF32). Its edge cases
(``flash_f32_edge_cases``: S = 1, 65 and 129 at every head size, causal and
not, G = 1 and 12, rows past S NaN) run under every float32 plan, and three
float32 cases are timed with their A/B lines (``flash_f32_timed_cases``
and FLASH_F32_TIMED), each beside the split products' bound (six products
a tile issued, at the TF32 peak), the function bound (``bound_ms``: three
TF32 products a float32 product, at that peak) and the same function's
bound on the CUDA cores (``cuda_core_bound_ms``), and beside the plain
version with one TF32 product each (``tf32_control``), which must
miss TOL or read TF32_CONTROL_RATIO times the kernel's error. Every
comparison against a plain version asserts that ``allow_tf32`` is off.

The last lines are the card line, a ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``. Exits non-zero, before printing any
result, when no CUDA device is available or the port is not beside this
script.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
import types
import zlib
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,      # dense tensor-core peak
              torch.float32: 67e12}        # float32 outside tensor cores
PEAK_TF32 = 495e12                         # dense TF32 tensor-core peak
L2_BYTES = 50 * 2 ** 20
QUERY_LEN = 8
MAX_NEW_TOKENS = 4
# (rtol, atol) of a kernel against its plain version on the same inputs.
# Both compute in float32 and round the output once to q's dtype, so in
# bf16 they may differ by one rounding of the output: 2**-7 relative
# (rtol 8e-3), plus atol for float32 summation order near zero.
TOL = {torch.bfloat16: (8e-3, 1e-3),
       # the reference test's: summation order, and in the flash kernel the
       # split TF32 products' dropped lo.lo and rounded low parts (each
       # below 2**-21 of its product)
       torch.float32: (1e-4, 2e-5)}
# The LISA-7B outputs of the kernel path against the same path with the
# kernel's plain version in its place, as a norm-wise relative error
# ||a - b|| / ||b||. Each launch differs by at most one bf16 rounding of
# its output (2**-8); eight such roundings are allowed: 2**-5. It holds
# the decode, paged, verify, bottleneck and scan replays. Not the flash
# replays: random-weight layers grew a correct flash kernel's one
# rounding to 0.0384 there (PERF.md §6), so each prefill layer is
# held to LAYER_RTOL on its own input, and the replay's outputs to
# SDPA_PATH_RTOL.
PATH_RTOL = 2.0 ** -5
# The same against the flash_decode=False path, whose attention rounds the
# probabilities to bf16 before P.V (as the reference's does) where the
# kernel keeps them in float32: a bf16 rounding of every output element
# in every layer and step. Its measured spread on LISA-7B (PERF.md) set
# this limit, which guards against gross faults, not rounding; it also
# holds the plain-flash replays, which differ from the kernel path only
# in rounding.
SDPA_PATH_RTOL = 2.0 ** -3
# A prefill or decode layer with a kernel against the same layer with the
# kernel's plain version, on the same input (layer_check: the flash,
# contiguous and paged decode kernels): the attention block's output and
# the layer's output, each as a norm-wise relative error. Both compute in
# float32 and round the attention output once to bf16, so they may differ
# by one bf16 rounding: 2**-8. A wrong mask, scale or head mapping is O(1).
LAYER_RTOL = 2.0 ** -8
# A moe layer's two runs in layer_check (or two dispatch modes on one input)
# route the same tokens on router inputs that differ by the attention's
# rounding: a token whose top-k set differs between them (a routing flip)
# must have router logits that agree within this bound (absolute, in
# logits; the random routers' logits are about N(0, 1)). One bf16 rounding
# of the attention output moves a logit by ~2**-9 of |h| / |x|; a wrong
# router or a wrong layer moves it by O(1).
ROUTE_TIE_LOGITS = 2.0 ** -5
# attention.sdpa_f32 with bf16 operands on the tensor cores against the
# float32 upcast it replaced, norm-wise, on the same inputs (check_sdpa).
# Both products are exact, only their order of sums differs, but where the
# two routes' scores differ in the last float32 bit a bf16 rounding of P
# can flip: the outputs read 2.7e-05 to 3.3e-05 at SAM's shape on an H100.
# A route that rounds its P.V result to bf16 reads some 1e-3; check_sdpa
# requires that control to fail this limit.
SDPA_RTOL = 1e-4
# The bf16 flash kernel keeps the probabilities near float32 through P.V
# (p_hi + p_lo, two bf16 MMAs). On every bf16 case of phase 3 (where one
# bf16 P is not exact) its norm-wise error against attention_ref must be
# under this share of the error of attention_ref with P rounded once to
# bf16 (FlashAttention's P). A kernel
# that rounds P once reads about 0.8 of it (normalised by the float32 sum),
# one that keeps P in float32 about 0.01 (tests/test_torch_flash_layers.py).
P_SPLIT_RATIO = 0.25
# The float32 flash kernel keeps float32's precision through split TF32
# products (x = hi + lo, three products each). Its control, the plain
# version with one TF32 product each (allow_tf32), must miss TOL or read at
# least this many times the kernel's norm-wise error (``tf32_control``).
TF32_CONTROL_RATIO = 10.0
REPLACES = {  # the TPU kernel each CUDA kernel replaces
    "decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:246",
    "paged_decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:66",
    "paged_verify_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:158",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:71",
    "bottleneck_encode": "src/repro/kernels/bottleneck/bottleneck.py:32",
    "bottleneck_decode": "src/repro/kernels/bottleneck/bottleneck.py:63",
    "ssm_scan": "src/repro/kernels/ssm_scan/ssm_scan.py:41",
}
# the in-flight phase: slots of the decoder, and eight requests from two
# operators in three waves: (operator, kind, frame). A frame number names
# one edge-encoded packet and query; uav-A sends frame 0 twice (a prefix
# hit). Between waves the decoder takes PUMPS[w] steps, then drains.
INFLIGHT_SLOTS = 4
INFLIGHT_WAVES = (
    (("uav-A", "context", 0), ("uav-B", "insight", 1),
     ("uav-A", "context", 2)),
    (("uav-A", "context", 0), ("uav-B", "context", 3),
     ("uav-A", "insight", 4)),
    (("uav-B", "context", 5), ("uav-A", "context", 6)),
)
PUMPS = (1, 2, 0)
# the spec phase: an executor of 6 new tokens over pages of 4 slots (draft
# overhangs cross pages, so rollback fires), and six requests from two
# operators over phase 8's frames in two waves: (operator, frame, drafts).
# uav-A sends frame 0 twice (a prefix hit, and a reuse of the draft's
# prefix row); uav-B's frame 3 rides the verify batches without drafting.
# One step between the waves, then drain.
SPEC_PAGE = 4
SPEC_MAX_NEW_TOKENS = 6
SPEC_WAVES = (
    (("uav-A", 0, True), ("uav-B", 1, True), ("uav-A", 0, True),
     ("uav-B", 3, False)),
    (("uav-A", 4, True), ("uav-B", 5, True)),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def device_ms(fn, arg_sets, reps: int = 10) -> float:
    """Device time of one call: a CUDA graph of one call per argument set
    (the sets rotate through more than the L2 cache, so each call finds its
    inputs cold, as the serving loop does), replayed ``reps`` times between
    two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in arg_sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a in arg_sets:
            fn(*a)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(arg_sets))


def l2_cold_copies(args, nbytes):
    """``args`` and enough copies of it on the device that rotating
    through them moves twice the L2 cache's bytes, so that each timed call
    finds its inputs cold."""
    copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
    return [args] + [tuple(t.clone() for t in args)
                     for _ in range(copies - 1)]


def _sync_s() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


# ---------------------------------------------------------------------------
# phase 3: decode_attention against its plain version
# ---------------------------------------------------------------------------


def decode_inputs(rng, B, H, K, hd, W, dtype, lens, dev):
    q = torch.from_numpy(rng.randn(B, H, hd).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, W, K, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, W, K, hd).astype(np.float32))
    bias = np.zeros((B, W), np.float32)
    for i, n in enumerate(lens):
        bias[i, n:] = -1e30
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.from_numpy(bias).to(dev))


def held_against(name, out, want, tol=None):
    """Max abs error of a kernel's output against its plain version's;
    raises if it is not finite or beyond ``tol`` (default TOL for its
    dtype)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"{name}: the plain version is the oracle, but "
                             f"its float32 products run in TF32")
    rtol, atol = tol or TOL[want.dtype]
    err = (out.float() - want.float()).abs()
    max_err = float(err.max())
    excess = float((err - rtol * want.float().abs()).max())
    if not (torch.isfinite(out).all() and excess <= atol):
        raise AssertionError(f"{name}: max abs err {max_err:.3g} beyond "
                             f"rtol {rtol} atol {atol}")
    return max_err


def deterministic(name, launch, args, out):
    """One more launch on the same inputs must give the same bits."""
    again = launch(*args)
    torch.cuda.synchronize()
    if not torch.equal(again, out):
        raise AssertionError(f"{name}: two launches on the same inputs "
                             f"differ in {int((again != out).sum())} "
                             f"elements")
    return True


def check_decode_attention(rng, case, dev, timed):
    """The kernel (under ``case["plan"]`` where given, else the launcher's
    own plan) against ``decode_attention_ref`` within TOL, launched twice
    and bit-equal, and in bf16 its P-split reading under P_SPLIT_RATIO.
    Timed: its time beside the plain version's, SDPA's and the byte bound,
    and at G > 1 in bf16 the A/B line of every bf16 kernel
    (``decode_ab``)."""
    from repro_torch.kernels.decode_attention import ops, ref
    B, H, K, hd, W, dtype, lens = (case[k] for k in
                                   ("B", "H", "K", "hd", "W", "dtype",
                                    "lens"))
    args = decode_inputs(rng, B, H, K, hd, W, dtype, lens, dev)
    plan = case.get("plan") or ops.decode_plan(B, H, K, hd, W, dtype)
    launch = functools.partial(ops.decode_attention, plan=plan)
    out = launch(*args)
    torch.cuda.synchronize()
    name = f"decode_attention {case['name']}"
    want = ref.decode_attention_ref(*args)
    max_err = held_against(name, out, want)
    rtol, atol = TOL[dtype]
    res = {
        "case": case["name"], "B": B, "H": H, "K": K, "hd": hd, "W": W,
        "dtype": str(dtype).replace("torch.", ""), "plan": plan.name,
        "max_abs_err": max_err, "rtol": rtol, "atol": atol,
        "deterministic": deterministic(name, launch, args, out)}
    msg = (f"[kernel] decode_attention {case['name']}: B={B} H={H} K={K} "
           f"hd={hd} W={W} {res['dtype']} plan {plan.name} max_abs_err="
           f"{max_err:.3g} (rtol {rtol}, atol {atol}); a second launch "
           f"bit-equal")
    if timed:
        es = torch.finfo(dtype).bits // 8
        nbytes = (2 * B * H * hd + 2 * B * W * K * hd) * es + B * W * 4
        flops = 4 * B * H * W * hd
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        sets = l2_cold_copies(args, nbytes)
        lib_sets = [(a.view(B, H, 1, hd), b.permute(0, 2, 1, 3),
                     c.permute(0, 2, 1, 3), m[:, None, None, :].to(dtype))
                    for a, b, c, m in sets]
        gqa = {"enable_gqa": True} if K != H else {}

        def library(qq, kk, vv, mm):
            return torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mm, **gqa)

        res.update({
            "ms": device_ms(launch, sets),
            "plain_ms": device_ms(ref.decode_attention_ref, sets),
            "library_ms": device_ms(library, lib_sets),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops})
        msg += (f" kernel_ms={res['ms']:.5f} plain_ms={res['plain_ms']:.4f}"
                f" library_ms={res['library_ms']:.5f} bound_ms="
                f"{res['bound_ms']:.5f} ({res['bound_by']})")
        if dtype == torch.bfloat16 and H // K > 1:
            res["ab_ms"], res["ab_split"] = decode_ab(
                ops.decode_attention, sets,
                lambda split: ops.set_split(B, H, K, hd, W, split))
    if dtype == torch.bfloat16:
        res["p_split"] = p_split_of(
            out, want, decode_p_bf16(*args))
        msg += p_split_msg(res["p_split"])
    log(msg)
    log_decode_ab("decode", case["name"], res)
    p_split_check(name, res.get("p_split"))
    return res


def decode_ab(launch, sets, split_of):
    """Device times of every bf16 decode kernel on the same inputs, each
    in turn and then in reverse (ms lists by label): SPLIT; SETS at the
    rule's split (``ops.sets_split``), at a split of 1 (one CTA a set, no
    cluster, no merge) and at MAX_SPLIT (as many CTAs as the card holds at
    once). Also each SETS label's split as the launcher takes it
    (``split_of(cap)``, ``ops.set_split``)."""
    from repro_torch.kernels.decode_attention import ops
    sets_plan = ops.DecodePlan.SETS
    variants = [("SPLIT", {"plan": ops.DecodePlan.SPLIT}),
                ("SETS", {"plan": sets_plan}),
                ("SETS_split1", {"plan": sets_plan, "split": 1}),
                (f"SETS_split{ops.MAX_SPLIT}",
                 {"plan": sets_plan, "split": ops.MAX_SPLIT})]
    ab = {}
    for label, kw in variants + variants[::-1]:
        ab.setdefault(label, []).append(
            device_ms(functools.partial(launch, **kw), sets))
    splits = {label: split_of(kw.get("split"))
              for label, kw in variants if kw["plan"] == sets_plan}
    return ab, splits


def log_decode_ab(kind, case, res):
    """The ``[kernel] decode A/B`` line of a timed case with an A/B."""
    if "ab_ms" not in res:
        return
    mean = {k: sum(v) / len(v) for k, v in res["ab_ms"].items()}
    other = min(mean[k] for k in ("SPLIT", "SETS") if k != res["plan"])
    log(f"[kernel] {kind} A/B {case}: " + ", ".join(
        f"{k} " + " / ".join(f"{t:.5f}" for t in v) + " ms"
        + (f" (split {res['ab_split'][k]})" if k in res["ab_split"] else "")
        for k, v in res["ab_ms"].items())
        + f"; launcher's plan {res['plan']}, "
        f"{mean[res['plan']] / other:.3f} x the other plan")


DECODE_TIMED = ("main_B1", "main_B4")

# grouped-query decode at the SETS kernel's set edges: G query heads a kv
# head (one set of 16 rows up to G = 16; two sets at 24), each under every
# bf16 plan
DECODE_SET_G = (2, 3, 6, 12, 16, 24)
DECODE_SET_HD = (64, 128, 192)
DECODE_SET_W = (1, 17, 72, 300)
# the other head sizes of HEAD_DIMS at two (G, W) each: one set over a
# cluster split with lengths spread, and two sets at W = 1 with a fully
# masked row
DECODE_SET_HD_EDGE = (32, 80, 112)
DECODE_SET_GW_EDGE = ((12, 300), (24, 1))
# the long windows off the launch floor, where one read a kv head shows:
# (name, H, K, hd) at B = 8, W = 4,096, every slot filled
DECODE_LONG = (("granite", 24, 8, 64), ("nemotron", 96, 8, 192))
DECODE_LONG_B, DECODE_LONG_W = 8, 4096


def decode_set_shapes():
    """The (G, hd, W) of the grouped-query cases: every G of DECODE_SET_G,
    hd of DECODE_SET_HD and W of DECODE_SET_W, then each hd of
    DECODE_SET_HD_EDGE at each (G, W) of DECODE_SET_GW_EDGE."""
    return (list(itertools.product(DECODE_SET_G, DECODE_SET_HD,
                                   DECODE_SET_W))
            + [(G, hd, W) for hd in DECODE_SET_HD_EDGE
               for G, W in DECODE_SET_GW_EDGE])


def decode_set_cases():
    """bf16 decode at every (G, hd, W) of ``decode_set_shapes`` over K = 2
    kv heads, each under every bf16 plan (``ops.plans``): {kernel: cases}. Contiguous: W = 1 with a fully
    masked row beside a live one (B = 2), else B = 3 with lengths spread
    from 1 to W. Paged (pages of 16, n = ceil(W / 16), each row its own
    pages in a shuffled order): the same lengths over n x 16 slots. Each
    case draws from a generator of its own (``case_rng``)."""
    from repro_torch.kernels.decode_attention import ops
    bf16 = torch.bfloat16
    dec, paged = [], []
    for G, hd, W in decode_set_shapes():
        lens = [0, 1] if W == 1 else \
            np.linspace(1, W, 3).astype(int).tolist()
        B, page = len(lens), 16
        n = -(-W // page)
        table = 1 + np.random.RandomState(G * 10000 + hd * 10 + W) \
            .permutation(B * n).reshape(B, n)
        valid = np.arange(n * page)[None] < np.array(lens)[:, None]
        base = dict(B=B, H=2 * G, K=2, hd=hd, dtype=bf16)
        for plan in ops.plans(bf16, G):
            tag = f"G{G}_hd{hd}_W{W}_{plan.name}"
            dec.append(dict(base, name=f"set_{tag}", W=W, lens=lens,
                            plan=plan))
            paged.append(dict(base, name=f"set_{tag}_page{page}",
                              P=B * n + 1, page=page, table=table,
                              valid=valid, plan=plan))
    return {"decode_attention": dec, "paged_decode_attention": paged}


# the zoo's grouped-query decode steps (phases 14 and 20: B = 2, W = 72,
# all filled), paged over pages of 8: (name, H, K, hd)
DECODE_ZOO = (("granite", 24, 8, 64), ("qwen2", 12, 2, 128),
              ("nemotron", 96, 8, 192))


def decode_timed_cases():
    """The timed grouped-query cases that phase 3 has no other case for:
    the long windows, contiguous and paged (pages of 16, each row its own
    256 pages), and the zoo's decode steps paged (each row its own 9 pages
    of 8; the contiguous ones are ``zoo14_kernel_cases`` and
    ``head_dim_cases``' hd192_B2_W72): {kernel: cases}."""
    B, W, page = DECODE_LONG_B, DECODE_LONG_W, 16
    n = W // page
    dec, paged = [], []
    for name, H, K, hd in DECODE_LONG:
        base = dict(B=B, H=H, K=K, hd=hd, dtype=torch.bfloat16, timed=True)
        dec.append(dict(base, name=f"long_{name}_B{B}_W{W}", W=W,
                        lens=[W] * B))
        paged.append(dict(base, name=f"long_{name}_B{B}_n{n}_page{page}",
                          P=B * n + 1, page=page,
                          table=1 + np.arange(B * n).reshape(B, n),
                          valid=np.ones((B, n * page), bool)))
    W = ZOO_DECODE_PROMPT + ZOO14_NEW_TOKENS
    B, page = ZOO_BATCH, 8
    n = W // page
    for name, H, K, hd in DECODE_ZOO:
        paged.append(dict(name=f"zoo_{name}_B{B}_n{n}_page{page}", B=B, H=H,
                          K=K, hd=hd, dtype=torch.bfloat16, timed=True,
                          P=B * n + 1, page=page,
                          table=1 + np.arange(B * n).reshape(B, n),
                          valid=np.ones((B, n * page), bool)))
    return {"decode_attention": dec, "paged_decode_attention": paged}


# the SETS split's threshold (ops.SETS_MIN_SLOTS) read on both sides:
# nemotron's and granite's heads at B = 2 over these windows, all filled
DECODE_RULE_W = (128, 256, 512, 1024)


def decode_rule_cases():
    """Timed bf16 decode cases beside ``ops.sets_split``'s threshold, each
    with its A/B line: nemotron's heads (H 96, K 8, hd 192) and granite's
    (H 24, K 8, hd 64) at B = 2 and each W of DECODE_RULE_W."""
    return [dict(name=f"rule_{name}_B2_W{W}", B=2, H=H, K=K, hd=hd, W=W,
                 dtype=torch.bfloat16, lens=[W, W], timed=True)
            for name, H, K, hd in DECODE_LONG for W in DECODE_RULE_W]


def kernel_cases(pcfg, batches):
    """The serving path's decode shapes (every cloud_*_gen call decodes
    at W = clip_tokens + query_len + max_new_tokens), the largest of them
    once more with lengths spread from 1 to W across rows (so that a
    wrong mask shows at full width), and the fp32 shape of the CPU tests
    with a fully masked idle row beside a live row. Then the edges of the
    bf16 split-K kernel: W = 1 (one slot, a fully masked row beside live
    ones), W = 33 (a split that takes fewer slots than the others; G = 4,
    hd = 64), W = 2,048 with lengths spread from 1 to W, and G = 12 query
    heads a kv head (two head chunks; hd = 32)."""
    llm = pcfg.llm
    S = pcfg.clip_tokens + QUERY_LEN
    W = S + MAX_NEW_TOKENS
    cases = [dict(name=f"main_B{B}", B=B, H=llm.num_heads,
                  K=llm.num_kv_heads, hd=llm.resolved_head_dim, W=W,
                  dtype=llm.adtype,
                  lens=np.linspace(S + 1, W, B).astype(int).tolist())
             for B in batches]
    B = max(batches)
    main = cases[-1]
    cases.append(dict(main, name=f"main_B{B}_ragged",
                      lens=np.linspace(1, W, B).astype(int).tolist()))
    cases.append(dict(name="fp32_idle_row", B=2, H=4, K=2, hd=64, W=128,
                      dtype=torch.float32, lens=[0, 128]))
    cases.append(dict(main, name=f"W1_B{B}_idle_row", W=1,
                      lens=[0] + [1] * (B - 1)))
    cases.append(dict(name="W33_G4_hd64", B=3, H=16, K=4, hd=64, W=33,
                      dtype=llm.adtype, lens=[1, 17, 33]))
    cases.append(dict(main, name=f"W2048_B{B}_ragged", W=2048,
                      lens=np.linspace(1, 2048, B).astype(int).tolist()))
    cases.append(dict(name="W300_G12_hd32", B=2, H=24, K=2, hd=32, W=300,
                      dtype=llm.adtype, lens=[300, 150]))
    return cases


# ---------------------------------------------------------------------------
# phase 3: paged_decode_attention against its plain version
# ---------------------------------------------------------------------------


def paged_inputs(rng, case, dev):
    """q, k/v pools, page table and bias of one paged case. ``valid``
    (B, n*page) marks each row's attended slots; every pool page that no
    table names is NaN, so a kernel reading outside its table fails."""
    B, H, K, hd, P, page = (case[k] for k in ("B", "H", "K", "hd", "P",
                                              "page"))
    table, valid = case["table"], case["valid"]
    q = rng.randn(B, H, hd).astype(np.float32)
    kp = rng.randn(P, page, K, hd).astype(np.float32)
    vp = rng.randn(P, page, K, hd).astype(np.float32)
    unnamed = np.setdiff1d(np.arange(P), table)
    kp[unnamed] = np.nan
    vp[unnamed] = np.nan
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    dtype = case["dtype"]
    return (torch.from_numpy(q).to(dev, dtype),
            torch.from_numpy(kp).to(dev, dtype),
            torch.from_numpy(vp).to(dev, dtype),
            torch.from_numpy(table.astype(np.int32)).to(dev),
            torch.from_numpy(bias).to(dev))


def paged_bytes_flops(case, es):
    """What the kernel must move and compute on these inputs: q, each
    distinct page a table names (k and v, read once however many rows
    share it), the tables, the bias and the output; 4 flops per
    (query head, slot, head-dim element)."""
    B, H, K, hd, page = (case[k] for k in ("B", "H", "K", "hd", "page"))
    table = case["table"]
    n = table.shape[1]
    pages = len(np.unique(table))
    nbytes = (2 * B * H * hd + 2 * pages * page * K * hd) * es \
        + B * n * page * 4 + B * n * 4
    return nbytes, 4 * B * H * n * page * hd


def check_paged_decode_attention(rng, case, dev, timed):
    """As ``check_decode_attention``, over the case's page table; the
    yardstick is the page gather then SDPA (two calls)."""
    from repro_torch.kernels.decode_attention import ops, ref
    args = paged_inputs(rng, case, dev)
    dtype = case["dtype"]
    B, H, K, hd, page = (case[k] for k in ("B", "H", "K", "hd", "page"))
    n = case["table"].shape[1]
    plan = case.get("plan") or ops.decode_plan(B, H, K, hd, n * page,
                                               dtype)
    launch = functools.partial(ops.paged_decode_attention, plan=plan)
    out = launch(*args)
    torch.cuda.synchronize()
    want = ref.paged_decode_attention_ref(*args)
    name = f"paged_decode_attention {case['name']}"
    max_err = held_against(name, out, want)
    rtol, atol = TOL[dtype]
    res = {"case": case["name"], "B": B, "H": H, "K": K, "hd": hd,
           "P": case["P"], "page": page, "n": n,
           "dtype": str(dtype).replace("torch.", ""), "plan": plan.name,
           "max_abs_err": max_err, "rtol": rtol, "atol": atol,
           "deterministic": deterministic(name, launch, args, out)}
    msg = (f"[kernel] paged_decode_attention {case['name']}: B={B} H={H} "
           f"K={K} hd={hd} P={case['P']} page={page} n={n} {res['dtype']} "
           f"plan {plan.name} max_abs_err={max_err:.3g} (rtol {rtol}, atol "
           f"{atol}); a second launch bit-equal")
    if timed:
        nbytes, flops = paged_bytes_flops(case, torch.finfo(dtype).bits // 8)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[dtype]
        sets = l2_cold_copies(args, nbytes)
        gqa = {"enable_gqa": True} if K != H else {}

        def gather_sdpa(q, kp, vp, table, bias):
            # two library calls: the page gather, then SDPA
            idx = table.long()
            kg = kp[idx].reshape(B, n * page, K, hd).transpose(1, 2)
            vg = vp[idx].reshape(B, n * page, K, hd).transpose(1, 2)
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kg, vg,
                attn_mask=bias[:, None, None, :].to(q.dtype), **gqa)

        res.update({
            "ms": device_ms(launch, sets),
            "plain_ms": device_ms(ref.paged_decode_attention_ref, sets),
            "gather_sdpa_ms": device_ms(gather_sdpa, sets),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "distinct_pages": int(len(np.unique(case["table"])))})
        msg += (f" kernel_ms={res['ms']:.5f} plain_ms={res['plain_ms']:.4f}"
                f" gather_sdpa_ms={res['gather_sdpa_ms']:.5f} bound_ms="
                f"{res['bound_ms']:.5f} ({res['bound_by']}, "
                f"{res['distinct_pages']} distinct pages)")
        if dtype == torch.bfloat16 and H // K > 1:
            res["ab_ms"], res["ab_split"] = decode_ab(
                ops.paged_decode_attention, sets,
                lambda split: ops.set_split(B, H, K, hd, n * page, split,
                                            n_pages=n))
    if dtype == torch.bfloat16:
        q, kp, vp, table, bias = args
        idx = table.long()
        res["p_split"] = p_split_of(out, want, decode_p_bf16(
            q, kp[idx].reshape(B, n * page, K, hd),
            vp[idx].reshape(B, n * page, K, hd), bias))
        msg += p_split_msg(res["p_split"])
    log(msg)
    log_decode_ab("paged decode", case["name"], res)
    p_split_check(name, res.get("p_split"))
    return res


def paged_cases(pcfg):
    """The three shapes of the reference's paged kernel test (fp32, random
    tables, ragged lengths), and the in-flight path's shape: B = slots,
    the LLM's heads, n = 13 prefix pages (clip tokens + query) + 1 private
    page. ``main``: the tables of a decode step, rows 0 and 1 sharing
    their prefix pages (one operator's repeated frame), each row at its
    own step, and its row 0 alone (``main_B1``); ``main_ragged_idle``:
    row 0 idle (every entry on the trash page 0, every slot masked), the
    others with lengths spread to n*page, rows 1 and 2 sharing pages; once
    in bf16, once in fp32. Then the edges of the bf16 split-K kernel: one
    page a row (n = 1), n = 128 pages with rows 0 to 2 sharing their first
    100 pages, and G = 4 at hd = 64 over pages of 8."""
    rng = np.random.RandomState(1)
    cases = []
    for B, H, K, hd, P, page, n in ((2, 4, 2, 64, 9, 16, 3),
                                    (1, 8, 8, 32, 5, 8, 4),
                                    (3, 4, 1, 128, 12, 32, 2)):
        table = rng.randint(0, P, (B, n))
        lens = np.linspace(page, n * page, B).astype(int)
        valid = np.arange(n * page)[None] < lens[:, None]
        cases.append(dict(name=f"fp32_B{B}_P{P}_page{page}", B=B, H=H, K=K,
                          hd=hd, P=P, page=page, table=table, valid=valid,
                          dtype=torch.float32))
    llm, page = pcfg.llm, 16
    prefix = pcfg.clip_tokens + QUERY_LEN
    n_pre = -(-prefix // page)
    n = n_pre + -(-MAX_NEW_TOKENS // page)
    B = INFLIGHT_SLOTS
    base = dict(B=B, H=llm.num_heads, K=llm.num_kv_heads,
                hd=llm.resolved_head_dim, page=page)
    # main: row r owns prefix pages (rows 0 and 1 share) + 1 private page
    pre = [list(range(1 + i * n_pre, 1 + (i + 1) * n_pre))
           for i in (0, 0, 1, 2)]
    private = 1 + 3 * n_pre + np.arange(B)
    table = np.array([p + [int(private[r])] for r, p in enumerate(pre)])
    valid = np.zeros((B, n * page), bool)
    valid[:, :prefix] = True
    for r in range(B):
        valid[r, n_pre * page:n_pre * page + r + 1] = True
    cases.append(dict(base, name=f"main_B{B}", P=int(table.max()) + 2,
                      table=table, valid=valid, dtype=llm.adtype))
    cases.append(dict(cases[-1], name="main_B1", B=1, table=table[:1],
                      valid=valid[:1]))
    # ragged + idle: lengths 1 .. n*page on rows 1..B-1
    table = np.zeros((B, n), int)
    table[1] = np.arange(1, n + 1)
    table[2] = np.concatenate([np.arange(1, n_pre + 1),
                               [n + 1]])        # shares row 1's prefix
    table[3] = np.arange(n + 2, 2 * n + 2)
    lens = np.linspace(1, n * page, B - 1).astype(int)
    valid = np.zeros((B, n * page), bool)
    valid[1:] = np.arange(n * page)[None] < lens[:, None]
    for dtype in (llm.adtype, torch.float32):
        cases.append(dict(base, name=f"main_B{B}_ragged_idle_"
                          f"{str(dtype).replace('torch.', '')}",
                          P=2 * n + 3, table=table, valid=valid,
                          dtype=dtype))
    # one page a row, lengths 1 .. page
    lens = np.linspace(1, page, B).astype(int)
    cases.append(dict(base, name=f"n1_B{B}", P=B + 2,
                      table=np.arange(1, B + 1)[:, None],
                      valid=np.arange(page)[None] < lens[:, None],
                      dtype=llm.adtype))
    # 128 pages: rows 0..2 share their first 100 pages
    n, shared = 128, 100
    own = n - shared
    table = np.zeros((B, n), int)
    for r in range(3):
        table[r, :shared] = np.arange(1, shared + 1)
        table[r, shared:] = 1 + shared + r * own + np.arange(own)
    table[3] = 1 + shared + 3 * own + np.arange(n)
    lens = np.array([n * page, 1700, shared * page + 1, 1000])
    cases.append(dict(base, name=f"n128_B{B}_shared100",
                      P=int(table.max()) + 2, table=table,
                      valid=np.arange(n * page)[None] < lens[:, None],
                      dtype=llm.adtype))
    # GQA: G = 4, hd = 64, pages of 8
    table = rng.randint(0, 12, (3, 5))
    lens = np.linspace(1, 40, 3).astype(int)
    cases.append(dict(name="G4_hd64_page8", B=3, H=16, K=4, hd=64, P=12,
                      page=8, table=table,
                      valid=np.arange(40)[None] < lens[:, None],
                      dtype=llm.adtype))
    return cases


# the launcher's in-flight slots (``launch/serve.py --max-batch``'s default)
LISA16_SLOTS = 8


def lisa_mini_paged_case(mini):
    """The trained lisa-mini's served decode step (phase 16c): float32,
    LISA16_SLOTS rows, each a prefix of clip tokens + query over whole
    pages (rows in pairs sharing theirs) and one private page, row r at
    its step r % MAX_NEW_TOKENS."""
    llm, page, B = mini.llm, 16, LISA16_SLOTS
    prefix = mini.clip_tokens + QUERY_LEN
    n_pre = -(-prefix // page)
    n = n_pre + -(-MAX_NEW_TOKENS // page)
    table = np.array([list(range(1 + (r // 2) * n_pre,
                                 1 + (r // 2 + 1) * n_pre))
                      + [1 + (B // 2) * n_pre + r] for r in range(B)])
    valid = np.zeros((B, n * page), bool)
    valid[:, :prefix] = True
    for r in range(B):
        valid[r, n_pre * page:n_pre * page + r % MAX_NEW_TOKENS + 1] = True
    return dict(name=f"lisa_mini_B{B}", B=B, H=llm.num_heads,
                K=llm.num_kv_heads, hd=llm.resolved_head_dim, page=page,
                P=int(table.max()) + 2, table=table, valid=valid,
                dtype=torch.float32)


# ---------------------------------------------------------------------------
# phase 3: paged_verify_attention against its plain version
# ---------------------------------------------------------------------------


def verify_inputs(rng, case, dev):
    """q (B,C,H,hd), k/v pools, page table and per-query bias of one verify
    case. ``valid`` (B, C, n*page) marks each query's attended slots; every
    pool page that no table names is NaN."""
    B, C, H, K, hd, P, page = (case[k] for k in ("B", "C", "H", "K", "hd",
                                                 "P", "page"))
    table, valid = case["table"], case["valid"]
    q = rng.randn(B, C, H, hd).astype(np.float32)
    kp = rng.randn(P, page, K, hd).astype(np.float32)
    vp = rng.randn(P, page, K, hd).astype(np.float32)
    unnamed = np.setdiff1d(np.arange(P), table)
    kp[unnamed] = np.nan
    vp[unnamed] = np.nan
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    dtype = case["dtype"]
    return (torch.from_numpy(q).to(dev, dtype),
            torch.from_numpy(kp).to(dev, dtype),
            torch.from_numpy(vp).to(dev, dtype),
            torch.from_numpy(table.astype(np.int32)).to(dev),
            torch.from_numpy(bias).to(dev))


def verify_bytes_flops(case, es):
    """What the kernel must move and compute on these inputs: q and the
    output, each distinct page a table names (k and v, read once however
    many rows share it), the tables and the per-query bias; 4 flops per
    (query, head, slot, head-dim element)."""
    B, C, H, K, hd, page = (case[k] for k in ("B", "C", "H", "K", "hd",
                                              "page"))
    table = case["table"]
    n = table.shape[1]
    pages = len(np.unique(table))
    nbytes = (2 * B * C * H * hd + 2 * pages * page * K * hd) * es \
        + B * C * n * page * 4 + B * n * 4
    return nbytes, 4 * B * C * H * n * page * hd


def check_paged_verify_attention(rng, case, dev, timed):
    from repro_torch.kernels.decode_attention import ops, ref
    args = verify_inputs(rng, case, dev)
    out = ops.paged_verify_attention(*args)
    torch.cuda.synchronize()
    want = ref.paged_verify_attention_ref(*args)
    max_err = held_against(f"paged_verify_attention {case['name']}", out,
                           want)
    dtype = case["dtype"]
    rtol, atol = TOL[dtype]
    B, C, H, K, hd, page = (case[k] for k in ("B", "C", "H", "K", "hd",
                                              "page"))
    n = case["table"].shape[1]
    name = f"paged_verify_attention {case['name']}"
    res = {"case": case["name"], "B": B, "C": C, "H": H, "K": K, "hd": hd,
           "P": case["P"], "page": page, "n": n,
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": max_err, "rtol": rtol, "atol": atol,
           "deterministic": deterministic(name, ops.paged_verify_attention,
                                          args, out)}
    msg = (f"[kernel] paged_verify_attention {case['name']}: B={B} C={C} "
           f"H={H} K={K} hd={hd} P={case['P']} page={page} n={n} "
           f"{res['dtype']} max_abs_err={max_err:.3g} (rtol {rtol}, atol "
           f"{atol}); a second launch bit-equal")
    if C == 1:
        # column 0 of a C=1 call is the paged decode kernel's answer: in
        # float32 both kernels run flash_decode.cuh (to 1e-6), in bf16 both
        # run split_decode.cuh at other set sizes (within TOL)
        q, kp, vp, table, bias = args
        dec = ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, table,
                                         bias[:, 0].contiguous())
        torch.cuda.synchronize()
        diff = float((out[:, 0].float() - dec.float()).abs().max())
        if dtype == torch.float32 and not diff <= 1e-6:
            raise AssertionError(f"{name}: C=1 off the paged decode kernel "
                                 f"by {diff:.3g}, limit 1e-6")
        if dtype != torch.float32:
            held_against(f"{name} column 0 against the paged decode kernel",
                         out[:, 0], dec)
        res["max_abs_diff_paged_decode"] = diff
        msg += f"; column 0 vs the paged decode kernel {diff:.3g}"
    if timed:
        nbytes, flops = verify_bytes_flops(case, torch.finfo(dtype).bits // 8)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[dtype]
        sets = l2_cold_copies(args, nbytes)
        G = H // K

        def gather_sdpa(q, kp, vp, table, bias):
            # two library calls: the page gather, then SDPA with the
            # C queries of each kv head's G heads as its query rows
            idx = table.long()
            kg = kp[idx].reshape(B, n * page, K, hd).transpose(1, 2)
            vg = vp[idx].reshape(B, n * page, K, hd).transpose(1, 2)
            qg = q.reshape(B, C, K, G, hd).permute(0, 2, 3, 1, 4) \
                .reshape(B, K, G * C, hd)
            mask = bias[:, None, None].expand(B, 1, G, C, n * page) \
                .reshape(B, 1, G * C, n * page).to(q.dtype)
            return torch.nn.functional.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask)

        res.update({
            "ms": device_ms(ops.paged_verify_attention, sets),
            "plain_ms": device_ms(ref.paged_verify_attention_ref, sets),
            "gather_sdpa_ms": device_ms(gather_sdpa, sets),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "distinct_pages": int(len(np.unique(case["table"])))})
        msg += (f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f}"
                f" gather_sdpa_ms={res['gather_sdpa_ms']:.4f} bound_ms="
                f"{res['bound_ms']:.5f} ({res['bound_by']}, "
                f"{res['distinct_pages']} distinct pages)")
    log(msg)
    return res


def verify_cases(pcfg):
    """The three shapes of the reference's verify kernel test (fp32, random
    tables, per-query ragged lengths), one with G*C > 8 queries per kv
    head (split over CTAs), and the speculative path's shapes: B = slots,
    the LLM's heads, C = 4 and 5 (3 and 4 drafts), the 204-token prefix in
    51 pages of 4 slots + 2 private pages (phase 9's pages) or 13 pages of
    16 + 1. Rows 0 and 1 share their prefix pages and draft (each at its
    own step, causal within the chunk); row 2 is a plain row riding the
    batch, its chunk one real entry and pad queries; row 3 is idle (every
    entry on the trash page 0, every slot masked). Then C=1 in bf16 and
    fp32, each held also against the paged decode kernel. In bf16, the
    edges of the split-K body's query sets: G*C = 10 > 8 at hd = 128 (a
    kv head's queries over two clusters, sets of 8 and 2), C = 4 at
    hd = 64 and C = 5 at hd = 32 (more queries than lanes a row)."""
    rng = np.random.RandomState(2)
    cases = []
    for B, C, H, K, hd, P, page, n, dtype in (
            (2, 4, 4, 2, 64, 9, 16, 3, torch.float32),
            (1, 3, 8, 8, 32, 5, 8, 4, torch.float32),
            (3, 2, 4, 1, 128, 12, 32, 2, torch.float32),
            (2, 5, 8, 2, 64, 9, 16, 3, torch.float32),
            (3, 5, 8, 4, 128, 12, 16, 4, torch.bfloat16),
            (2, 4, 8, 8, 64, 9, 8, 6, torch.bfloat16),
            (3, 5, 8, 8, 32, 10, 8, 5, torch.bfloat16)):
        table = rng.randint(0, P, (B, n))
        lens = rng.randint(1, n * page + 1, (B, C))
        valid = np.arange(n * page)[None, None] < lens[..., None]
        dt = "fp32" if dtype == torch.float32 else "bf16"
        cases.append(dict(name=f"{dt}_B{B}_C{C}_G{H // K}_hd{hd}_page{page}",
                          B=B, C=C, H=H, K=K, hd=hd, P=P, page=page,
                          table=table, valid=valid, dtype=dtype))
    llm = pcfg.llm
    prefix = pcfg.clip_tokens + QUERY_LEN
    B = INFLIGHT_SLOTS
    for page, C, dtype in ((SPEC_PAGE, 4, llm.adtype),
                           (SPEC_PAGE, 5, llm.adtype),
                           (16, 4, llm.adtype), (SPEC_PAGE, 1, llm.adtype),
                           (16, 1, torch.float32)):
        n_pre = -(-prefix // page)
        n_priv = -(-SPEC_MAX_NEW_TOKENS // page)
        n = n_pre + n_priv
        base = n_pre * page
        pre = [list(range(1 + i * n_pre, 1 + (i + 1) * n_pre))
               for i in (0, 0, 1)]
        priv = 1 + 2 * n_pre + np.arange(3 * n_priv).reshape(3, n_priv)
        table = np.zeros((B, n), int)
        valid = np.zeros((B, C, n * page), bool)
        for r, done in enumerate((1, 2, 3)):     # tokens emitted so far
            table[r] = pre[r] + priv[r].tolist()
            valid[r, :, :prefix] = True
            for c in range(C):
                # chunk token c sits at slot base + done - 1 + c; row 2's
                # pad queries (c >= 1) see what its real entry sees
                last = base + done - 1 + (c if r < 2 else 0)
                valid[r, c, base:last + 1] = True
        name = (f"main_B{B}_C{C}_page{page}"
                + ("" if dtype == llm.adtype else "_fp32"))
        cases.append(dict(name=name, B=B, C=C, H=llm.num_heads,
                          K=llm.num_kv_heads, hd=llm.resolved_head_dim,
                          P=int(table.max()) + 3, page=page, table=table,
                          valid=valid, dtype=dtype))
    return cases


# ---------------------------------------------------------------------------
# phase 3: flash_attention against its plain version
# ---------------------------------------------------------------------------


def flash_inputs(rng, case, dev):
    """q (B,S,H,hd), k/v (B,S,K,hd). With ``pad`` each is a view of a
    (B, S + pad, heads, hd) buffer whose rows past S are NaN: a kernel that
    reads a key or query past S fails."""
    B, S, H, K, hd, pad, dtype = (case[k] for k in ("B", "S", "H", "K", "hd",
                                                    "pad", "dtype"))

    def buf(heads):
        a = rng.randn(B, S + pad, heads, hd).astype(np.float32)
        a[:, S:] = np.nan
        return torch.from_numpy(a).to(dev, dtype)[:, :S]

    return buf(H), buf(K), buf(K)


def flash_bytes_flops(case, es):
    """q, k, v read once and the output written once; 4 flops per (query
    head, attended key, head-dim element), the causal triangle only when
    causal."""
    B, S, H, K, hd = (case[k] for k in ("B", "S", "H", "K", "hd"))
    pairs = S * (S + 1) // 2 if case["causal"] else S * S
    return (2 * B * S * H * hd + 2 * B * S * K * hd) * es, \
        4 * B * H * hd * pairs


def attention_p_bf16(q, k, v, causal=True):
    """``attention_ref`` with the probabilities rounded to bf16 before P.V,
    as one bf16 P in the P.V MMA would have them."""
    from repro_torch.kernels.flash_attention.ref import NEG_INF
    B, S, H, hd = q.shape
    K = k.shape[2]
    scores = torch.einsum("bskgh,btkh->bkgst",
                          q.reshape(B, S, K, H // K, hd).float(),
                          k.float()) / math.sqrt(hd)
    if causal:
        above = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(above, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16).float()
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def decode_p_bf16(q, k, v, bias):
    """``decode_attention_ref`` with the probabilities rounded to bf16
    before P.V, as one bf16 P in the P.V MMA would have them."""
    B, H, hd = q.shape
    K = k.shape[2]
    scores = torch.einsum("bkgh,bwkh->bkgw",
                          q.reshape(B, K, H // K, hd).float(),
                          k.float()) / math.sqrt(hd)
    scores = scores + bias[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16).float()
    out = torch.einsum("bkgw,bwkh->bkgh", probs, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def p_split_of(out, want, want_p):
    """How near ``out`` keeps P to float32: its norm-wise error against
    ``want`` (the plain version), the error of ``want_p`` (the plain
    version with P rounded once to bf16) against the same, and their
    ratio, which must be under P_SPLIT_RATIO. The ratio is None where one
    bf16 P is exact (one key a row, as at S = 1), so that there is no
    rounding of P to compare with."""
    err, err_p = _rel(out, want), _rel(want_p, want)
    return {"rel_err": err, "rel_err_p_bf16": err_p,
            "ratio": err / err_p if err_p > 0 else None,
            "limit": P_SPLIT_RATIO}


def p_split_reading(out, want, q, k, v, causal):
    """``p_split_of`` a flash output against ``attention_ref``."""
    return p_split_of(out, want, attention_p_bf16(q, k, v, causal))


def p_split_msg(p):
    return (f"; P near float32: norm-wise err {p['rel_err']:.3g}, with "
            f"P rounded to bf16 {p['rel_err_p_bf16']:.3g}, ratio "
            + ("none (one bf16 P is exact)" if p["ratio"] is None
               else f"{p['ratio']:.3g}") + f" (limit {P_SPLIT_RATIO})")


def p_split_check(name, p):
    """Raises where a P-split reading is at or over P_SPLIT_RATIO."""
    if p is not None and p["ratio"] is not None \
            and not p["ratio"] < P_SPLIT_RATIO:
        raise AssertionError(f"{name}: the kernel keeps P no nearer "
                             f"float32 than P_SPLIT_RATIO of one bf16 P's "
                             f"error: {p}")


def flash_product_flops(case, rows, keys, products=3):
    """The products a kernel issues whose CTAs hold ``rows`` query rows of
    each head and walk kv tiles of ``keys`` keys (``ops.plan_tile``): for
    each such tile, ``products`` products of 2 * rows * keys * hd flops
    (bf16: q.k and P.V twice, p_hi and p_lo; ``plan_products``), whole
    tiles on the diagonal and at S."""
    B, S, H, hd = (case[k] for k in ("B", "S", "H", "hd"))
    tiles = sum(-(-(min(q0 + rows, S) if case["causal"] else S) // keys)
                for q0 in range(0, S, rows))
    return products * 2 * rows * keys * hd * tiles * B * H


def flash_ops_per_flop(dtype):
    """Seconds a flop of the attention function takes at the least on the
    card in ``dtype``: bf16 at the bf16 tensor-core peak; float32 as three
    TF32 products (hi.hi, hi.lo, lo.hi: the split that holds float32's
    tolerance on the tensor cores) at the TF32 peak."""
    if dtype == torch.float32:
        return 3 / PEAK_TF32
    return 1 / PEAK_FLOPS[dtype]


def plan_products(plan):
    """(products a tile, the rate they run at) of ``plan``'s kernel: bf16
    q.k once and P.V twice on the bf16 tensor cores; TF32 q.k and P.V three
    times each (hi.hi, hi.lo, lo.hi) on the TF32 tensor cores."""
    if plan.name == "TF32":
        return 6, PEAK_TF32
    return 3, PEAK_FLOPS[torch.bfloat16]


def plan_product_bound(case, plan):
    """``plan``'s product bound at ``case``: the flops its kernel issues
    (``flash_product_flops`` at its tile) and their ms at their rate."""
    from repro_torch.kernels.flash_attention import ops
    products, rate = plan_products(plan)
    flops = flash_product_flops(case, *ops.plan_tile(plan, case["hd"]),
                                products)
    return flops, 1e3 * flops / rate


def tf32_control(args, want, out, causal):
    """The plain version with each product one TF32 product
    (``allow_tf32``) against the plain version, beside the kernel's
    norm-wise error: it must miss TOL, or read at least TF32_CONTROL_RATIO
    times the kernel's error, or the split's low parts are not what keeps
    the kernel within TOL."""
    from repro_torch.kernels.flash_attention import ref
    matmul = torch.backends.cuda.matmul
    if matmul.allow_tf32:
        raise AssertionError("allow_tf32 was on before the TF32 control")
    matmul.allow_tf32 = True
    try:
        one = ref.attention_ref(*args, causal=causal)
    finally:
        matmul.allow_tf32 = False
    rtol, atol = TOL[torch.float32]
    excess = float(((one - want).abs() - rtol * want.abs()).max())
    res = {"rel_err_one_tf32": _rel(one, want), "rel_err_kernel":
           _rel(out, want), "misses_tol": excess > atol,
           "max_abs_err_one_tf32": float((one - want).abs().max()),
           "ratio_limit": TF32_CONTROL_RATIO}
    res["ratio"] = (res["rel_err_one_tf32"] / res["rel_err_kernel"]
                    if res["rel_err_kernel"] > 0 else math.inf)
    res["ok"] = res["misses_tol"] or res["ratio"] >= TF32_CONTROL_RATIO
    return res


def check_flash_attention(rng, case, dev, timed):
    """The kernel (under ``case["plan"]`` where given, else the launcher's
    own plan) against ``attention_ref`` within TOL, launched twice and
    bit-equal, and in bf16 its P-split reading under P_SPLIT_RATIO. Timed:
    its time beside the plain version's, SDPA's, the function bound and the
    product bound, and for bf16 an A/B of every bf16 plan on the same
    inputs (plans in turn, then in reverse)."""
    from repro_torch.kernels.flash_attention import ops, ref
    causal = case["causal"]
    args = flash_inputs(rng, case, dev)
    launch = functools.partial(ops.flash_attention, causal=causal,
                               plan=case.get("plan"))
    out = launch(*args)
    torch.cuda.synchronize()
    want = ref.attention_ref(*args, causal=causal)
    name = f"flash_attention {case['name']}"
    max_err = held_against(name, out, want)
    dtype = case["dtype"]
    rtol, atol = TOL[dtype]
    B, S, H, K, hd = (case[k] for k in ("B", "S", "H", "K", "hd"))
    plan = case.get("plan")
    if plan is None:
        plan = ops.flash_plan(B, S, H, K, hd, dtype)
    res = {"case": case["name"], "B": B, "S": S, "H": H, "K": K, "hd": hd,
           "causal": causal, "nan_past_S": case["pad"] > 0,
           "dtype": str(dtype).replace("torch.", ""),
           "plan": plan.name, "max_abs_err": max_err, "rtol": rtol,
           "atol": atol,
           "deterministic": deterministic(name, launch, args, out)}
    msg = (f"[kernel] flash_attention {case['name']}: B={B} S={S} H={H} "
           f"K={K} hd={hd} causal={causal} {res['dtype']} plan "
           f"{plan.name} max_abs_err={max_err:.3g} (rtol "
           f"{rtol}, atol {atol}), bit-equal twice")
    if timed:
        nbytes, flops = flash_bytes_flops(case, torch.finfo(dtype).bits // 8)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops * flash_ops_per_flop(dtype)
        copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
        sets = [args] + [flash_inputs(rng, case, dev)
                         for _ in range(copies - 1)]
        gqa = {"enable_gqa": True} if K != H else {}

        def library(q, k, v):
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, **gqa)

        res.update({
            "ms": device_ms(lambda q, k, v: launch(q, k, v), sets),
            "plain_ms": device_ms(lambda q, k, v: ref.attention_ref(
                q, k, v, causal=causal), sets),
            "library_ms": device_ms(library, sets),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops})
        msg += (f" kernel_ms={res['ms']:.5f} plain_ms={res['plain_ms']:.4f}"
                f" library_ms={res['library_ms']:.5f} bound_ms="
                f"{res['bound_ms']:.5f} ({res['bound_by']})")
        if dtype == torch.float32:
            res["cuda_core_bound_ms"] = 1e3 * max(
                t_bytes, flops / PEAK_FLOPS[torch.float32])
            msg += f" cuda_core_bound_ms={res['cuda_core_bound_ms']:.5f}"
        pf, res["product_bound_ms"] = plan_product_bound(case, plan)
        res["product_flops"] = pf
        msg += (f" product_bound_ms={res['product_bound_ms']:.5f} "
                f"({pf / 1e9:.2f} GFLOP issued)")
        plans = ops.plans(dtype, H // K)
        ab = {}
        for pl in plans + plans[::-1]:
            ab.setdefault(pl.name, []).append(
                device_ms(lambda q, k, v: ops.flash_attention(
                    q, k, v, causal=causal, plan=pl), sets))
        res["ab_ms"] = ab
        res["ab_product_bound_ms"] = {
            pl.name: plan_product_bound(case, pl)[1] for pl in plans}
        if dtype == torch.float32:
            res["tf32_control"] = tf32_control(args, want, out, causal)
            t = res["tf32_control"]
            msg += (f"; one TF32 product (allow_tf32): norm-wise err "
                    f"{t['rel_err_one_tf32']:.3g} against the kernel's "
                    f"{t['rel_err_kernel']:.3g} (ratio {t['ratio']:.3g}, "
                    f"limit {TF32_CONTROL_RATIO}), max abs err "
                    f"{t['max_abs_err_one_tf32']:.3g}, "
                    + ("misses" if t["misses_tol"] else "within") + " TOL")
    if dtype == torch.bfloat16:
        res["p_split"] = p_split_reading(out, want, *args, causal)
        msg += p_split_msg(res["p_split"])
    log(msg)
    if "ab_ms" in res:
        log(f"[kernel] flash A/B {case['name']}: " + ", ".join(
            f"plan {k} " + " / ".join(f"{t:.5f}" for t in v)
            + f" ms (product bound {res['ab_product_bound_ms'][k]:.5f})"
            for k, v in res["ab_ms"].items())
            + f"; function bound {res['bound_ms']:.5f} ({res['bound_by']}, "
            + (f"3 TF32 products at {PEAK_TF32 / 1e12:.0f} TFLOP/s; on the "
               f"CUDA cores at {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s "
               f"{res['cuda_core_bound_ms']:.5f}"
               if dtype == torch.float32 else
               f"at {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s")
            + f"); launcher's plan {plan.name}")
    p_split_check(name, res.get("p_split"))
    if "tf32_control" in res and not res["tf32_control"]["ok"]:
        raise AssertionError(f"{name}: one TF32 product a product reads "
                             f"within TOL and under TF32_CONTROL_RATIO of "
                             f"the kernel's error: {res['tf32_control']}")
    return res


def flash_edge_cases():
    """bf16 at the edges of both bf16 kernels' tiles: S = 1 (one key; a
    128-row tile's second consumer wholly past S), 65 and 129 (one row
    into the next 64- or 128-row tile), at hd 128 and 192, causal and not,
    G = 1 (H = K = 2) and G = 12 (H = 12, K = 1); B = 2, each operand a
    view of a buffer whose rows past S are NaN. Each runs under every bf16
    plan (``check_flash_attention`` with ``plan``)."""
    cases = []
    for hd in (128, 192):
        for S in (1, 65, 129):
            for G, H, K in ((1, 2, 2), (12, 12, 1)):
                for causal in (True, False):
                    cases.append(dict(
                        name=f"edge_hd{hd}_S{S}_G{G}_"
                             f"{'causal' if causal else 'full'}",
                        B=2, S=S, H=H, K=K, hd=hd, causal=causal,
                        dtype=torch.bfloat16, pad=7))
    return cases


def flash_f32_edge_cases():
    """float32 at the edges of flash_tf32_kernel's tiles (64 or 128 query
    rows, kv tiles of 32 or 64 keys) at every head size of ``HEAD_DIMS``:
    S = 1, 65 and 129, G = 1 (H = K = 2) and G = 12 (H = 12, K = 1), causal
    and not; B = 2, each operand a view of a buffer whose rows past S are
    NaN. Each runs under every float32 plan (``flash_edge_checks``)."""
    from repro_torch.kernels.flash_attention import ops
    return [dict(name=f"f32_edge_hd{hd}_S{S}_G{G}_"
                      f"{'causal' if causal else 'full'}",
                 B=2, S=S, H=H, K=K, hd=hd, causal=causal,
                 dtype=torch.float32, pad=7)
            for hd in ops.HEAD_DIMS for S in (1, 65, 129)
            for G, H, K in ((1, 2, 2), (12, 12, 1))
            for causal in (True, False)]


def flash_edge_checks(seed, dev, cases=None):
    """Every edge case (default ``flash_edge_cases``) under every plan of
    its dtype and G, each plan on the case's own inputs (``case_rng``)."""
    from repro_torch.kernels.flash_attention import ops
    return [check_flash_attention(
                case_rng(seed, c["name"]),
                dict(c, name=f"{c['name']}_{p.name}", plan=p), dev,
                timed=False)
            for c in (flash_edge_cases() if cases is None else cases)
            for p in ops.plans(c["dtype"], c["H"] // c["K"])]


def flash_rule_cases():
    """bf16 causal cases on either side of ``ops.flash_plan``'s thresholds,
    each timed with its A/B line: S 512 and 1,024 at LISA-7B's heads (B = 2,
    H = K = 32, hd 128; ops.WS_MIN_S), and grids of 96 and 128 CTAs of 128
    rows at S 1,024 (B = 1, H = K = 12 and 16, hd 128; ops.WS_MIN_CTAS).
    Each draws from a generator of its own (``case_rng``)."""
    return [dict(name=f"rule_B{B}_S{S}_H{H}_hd128", B=B, S=S, H=H, K=H,
                 hd=128, causal=True, dtype=torch.bfloat16, pad=0)
            for B, S, H in ((2, 512, 32), (2, 1024, 32), (1, 1024, 12),
                            (1, 1024, 16))]


# the flash cases that are timed: the prefill's two shapes and the long
# sequences
FLASH_TIMED = ("main_B1", "main_B4", "bf16_B1_S1500_G2_hd128_causal",
               "bf16_B1_S4096_G1_hd128_causal")
# the float32 kernel's timed case, timed once more after the others on
# inputs of its own (``case_rng``), so that the cases that draw from the
# shared generator after it keep their inputs (its name keeps the plan it
# was first timed on, ONLINE)
FLASH_F32_TIMED = "float32_B2_S3000_G4_hd64_full_online"


def flash_f32_timed_cases():
    """The float32 cases timed beside FLASH_F32_TIMED, each with the A/B
    line of every float32 plan: causal at hd 128 (B 1, S 2,048, H = K = 32,
    LLaMA-7B's heads), and lisa-mini's prefill (B 4, S = clip tokens +
    query, its LLM's heads; the float32 shape of ``small_input_check``'s
    use_flash run). Each draws from a generator of its own
    (``case_rng``)."""
    from repro_torch.configs import get_lisa_config
    mini = get_lisa_config("lisa-mini")
    llm = mini.llm
    return [dict(name="float32_B1_S2048_G1_hd128_causal", B=1, S=2048, H=32,
                 K=32, hd=128, causal=True, dtype=torch.float32, pad=0),
            dict(name="float32_lisa_mini_prefill_B4", B=4,
                 S=mini.clip_tokens + QUERY_LEN, H=llm.num_heads,
                 K=llm.num_kv_heads, hd=llm.resolved_head_dim, causal=True,
                 dtype=torch.float32, pad=0)]


def flash_cases(pcfg):
    """The five shapes of the reference's flash test, causal and not, in
    fp32 and bf16; the LLM prefill's shapes (B = 1 and 4, S = clip tokens
    + query, bf16, causal); the B = 4 prefill once more with q, k and v as
    views of buffers whose rows past S are NaN; and long sequences: bf16
    causal at S = 1,500 and 4,096, bf16 not causal at 1,000 (with NaN past
    S) and causal at 777 (hd = 32), float32 at 3,000 with NaN past S."""
    cases = []
    for B, S, H, K, hd in ((2, 128, 4, 2, 64), (1, 200, 4, 4, 32),
                           (2, 64, 8, 2, 64), (1, 256, 4, 1, 128),
                           (1, 96, 6, 3, 32)):
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                cases.append(dict(
                    name=f"{str(dtype).replace('torch.', '')}_B{B}_S{S}_G"
                         f"{H // K}_hd{hd}_{'causal' if causal else 'full'}",
                    B=B, S=S, H=H, K=K, hd=hd, causal=causal, dtype=dtype,
                    pad=0))
    llm = pcfg.llm
    for B in (1, 4):
        cases.append(dict(name=f"main_B{B}", B=B,
                          S=pcfg.clip_tokens + QUERY_LEN, H=llm.num_heads,
                          K=llm.num_kv_heads, hd=llm.resolved_head_dim,
                          causal=True, dtype=llm.adtype, pad=0))
    cases.append(dict(cases[-1], name="main_B4_nan_past_S", pad=52))
    # long sequences: bf16 causal at S = 1,500 and at SAM's token grid
    # (4,096, LLaMA-7B's heads), float32 not causal with NaN past S
    cases.append(dict(name="bf16_B1_S1500_G2_hd128_causal", B=1, S=1500,
                      H=4, K=2, hd=128, causal=True, dtype=torch.bfloat16,
                      pad=0))
    cases.append(dict(name="bf16_B1_S4096_G1_hd128_causal", B=1, S=4096,
                      H=llm.num_heads, K=llm.num_kv_heads,
                      hd=llm.resolved_head_dim, causal=True,
                      dtype=torch.bfloat16, pad=0))
    # bf16 not causal with NaN past S at hd = 64, and causal at hd = 32
    # with an odd S
    cases.append(dict(name="bf16_B2_S1000_G2_hd64_full", B=2, S=1000, H=8,
                      K=4, hd=64, causal=False, dtype=torch.bfloat16,
                      pad=24))
    cases.append(dict(name="bf16_B1_S777_G4_hd32_causal", B=1, S=777, H=4,
                      K=1, hd=32, causal=True, dtype=torch.bfloat16, pad=0))
    cases.append(dict(name=FLASH_F32_TIMED, B=2, S=3000, H=8, K=2, hd=64,
                      causal=False, dtype=torch.float32, pad=40))
    return cases


# ---------------------------------------------------------------------------
# phase 3: bottleneck_encode / bottleneck_decode against their plain versions
# ---------------------------------------------------------------------------

# encode: scales in float32 to summation order (the reference's test);
# codes within 1 where a sum order moves z / s across a .5 tie, on fewer
# than CODES_OFF_FRAC of entries
SCALES_TOL = (1e-5, 1e-7)
CODES_OFF_FRAC = 1e-3
# decode: the output rounded once to bf16, or float32 summation order over
# the rank (the reference's own test)
DECODE_TOL = {torch.bfloat16: (8e-3, 1e-3), torch.float32: (1e-5, 1e-4)}


# each bottleneck case draws from a generator of its own, seeded from the
# case's name (and the draw), so a new case never moves another's inputs
def case_rng(seed, name, draw=0):
    return np.random.RandomState(zlib.crc32(f"{seed}:{name}:{draw}".encode()))


# draws of each float32-x encode case, each held three ways: the kernel's
# scales against the plain version's, and both against a float64 product
BN_DRAWS = 8


def scales_f64(x, w):
    """The encode's scales from a float64 product of the same inputs."""
    z = x.reshape(-1, x.shape[-1]).double() @ w.double()
    return z.abs().amax(-1, keepdim=True) / 127.0 + 1e-8


def _scales_excess(got, want):
    """Max abs difference of two scale columns, and how far it lies
    beyond SCALES_TOL (> 0: outside)."""
    rtol, atol = SCALES_TOL
    err = (got.double() - want.double()).abs()
    return float(err.max()), float((err - rtol * want.double().abs()).max()
                                   - atol)


def encode_draws(seed, cases, dev):
    """Every float32-x encode case over BN_DRAWS draws: the kernel's codes
    and scales against the plain version's (``codes_held_against``), and
    the kernel's and the plain version's scales each within SCALES_TOL of
    the float64 product's. Each case's line gives the worst of each
    reading over its draws, and the mean sign of (kernel - float64) of a
    token's max |z| (-1: every token's max read short)."""
    from repro_torch.kernels.bottleneck import ops, ref
    out = []
    for case in cases:
        name, d, r = case["name"], case["d"], case["r"]
        worst = {"kernel_vs_plain": 0.0, "kernel_vs_f64": 0.0,
                 "plain_vs_f64": 0.0, "codes_off_frac": 0.0,
                 "max_abs_err": 0}
        signs = []
        for draw in range(BN_DRAWS):
            x, w = encode_inputs(case_rng(seed, name, draw), case, dev)
            codes, scales = ops.bottleneck_encode(x, w)
            torch.cuda.synchronize()
            want_c, want_s = ref.encode_ref(x.reshape(-1, d), w)
            s64 = scales_f64(x, w)
            label = f"bottleneck_encode {name} draw {draw}"
            max_diff, off, s_err = codes_held_against(
                label, codes.reshape(-1, r), scales.reshape(-1, 1), want_c,
                want_s)
            for key, got in (("kernel_vs_f64", scales.reshape(-1, 1)),
                             ("plain_vs_f64", want_s)):
                err, excess = _scales_excess(got, s64)
                if excess > 0:
                    raise AssertionError(
                        f"{label}: {key.split('_')[0]} scales {err:.3g} off "
                        f"the float64 product's (rtol {SCALES_TOL[0]}, atol "
                        f"{SCALES_TOL[1]})")
                worst[key] = max(worst[key], err)
            worst["kernel_vs_plain"] = max(worst["kernel_vs_plain"], s_err)
            worst["codes_off_frac"] = max(worst["codes_off_frac"], off)
            worst["max_abs_err"] = max(worst["max_abs_err"], max_diff)
            signs.append(float(torch.sign(
                scales.reshape(-1, 1).double() - s64).mean()))
        res = {"case": f"{name}_draws", "draws": BN_DRAWS, **worst,
               "mean_sign": signs}
        log(f"[kernel] bottleneck_encode {name}: {BN_DRAWS} draws, scales "
            f"max abs err kernel-plain {worst['kernel_vs_plain']:.3g}, "
            f"kernel-float64 {worst['kernel_vs_f64']:.3g}, plain-float64 "
            f"{worst['plain_vs_f64']:.3g} (each rtol {SCALES_TOL[0]}, atol "
            f"{SCALES_TOL[1]}); codes off <= {worst['max_abs_err']} on <= "
            f"{worst['codes_off_frac']:.3g}; mean sign(kernel - float64) a "
            f"draw {[round(v, 2) for v in signs]}")
        out.append(res)
    return out


def codes_held_against(name, codes, scales, want_codes, want_scales):
    """Encode output against the plain version's: scales within
    SCALES_TOL, codes within 1 on fewer than CODES_OFF_FRAC of entries.
    Returns (max code difference, fraction of codes off, max scale
    error)."""
    s_err = held_against(f"{name} scales", scales, want_scales, SCALES_TOL)
    diff = (codes.int() - want_codes.int()).abs()
    max_diff = int(diff.max())
    off = float((diff > 0).float().mean())
    if codes.dtype != torch.int8 or max_diff > 1 or off >= CODES_OFF_FRAC:
        raise AssertionError(f"{name}: codes {codes.dtype} off the plain "
                             f"version by up to {max_diff} on {off:.3g} of "
                             f"entries (limit 1 on < {CODES_OFF_FRAC})")
    return max_diff, off, s_err


def encode_inputs(rng, case, dev):
    x = rng.randn(*case["lead"], case["d"]).astype(np.float32)
    w = (rng.randn(case["d"], case["r"]) * case["w_scale"]).astype(np.float32)
    return (torch.from_numpy(x).to(dev, case["x_dtype"]),
            torch.from_numpy(w).to(dev, case["w_dtype"]))


def decode_inputs_bn(rng, case, dev):
    codes = rng.randint(-127, 128, (*case["lead"], case["r"])).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, (*case["lead"], 1)).astype(np.float32)
    w = (rng.randn(case["r"], case["d"]) * case["w_scale"]).astype(np.float32)
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(scales).to(dev),
            torch.from_numpy(w).to(dev, case["w_dtype"]))


def bottleneck_cases(pcfg, ranks):
    """Encode: the four shapes of the reference's test in fp32 and bf16
    (x and w of one dtype), its batched (2, 37, 64) -> 16, two ranks wider
    than a cluster of column tiles, odd widths, and the split
    point's shapes: one frame's SAM boundary (1, 4096, 1280) in bf16 with
    the float32 weight of each tier's rank. Decode: the reference's two
    shapes with fp32 and bf16 weights into fp32, its batched shape, ragged
    tiles, an odd rank, and the split point's (codes of each rank back to
    1280, bf16 out)."""
    enc, dec = [], []
    for T, d, r in ((128, 128, 32), (64, 256, 100), (100, 64, 16),
                    (256, 1280, 638)):
        for dt in (torch.float32, torch.bfloat16):
            enc.append(dict(name=f"{str(dt).replace('torch.', '')}_T{T}_d{d}"
                                 f"_r{r}", lead=(T,), d=d, r=r, x_dtype=dt,
                            w_dtype=dt, w_scale=0.05))
    enc.append(dict(name="batched_2x37_d64_r16", lead=(2, 37), d=64, r=16,
                    x_dtype=torch.float32, w_dtype=torch.float32,
                    w_scale=0.1))
    # ranks wider than a cluster of 8 column tiles: every CTA walks two
    # (14 tiles), or all but the last (9 tiles); a ragged token tile
    enc.append(dict(name="float32_T40_d64_r3500_walk", lead=(40,), d=64,
                    r=3500, x_dtype=torch.float32, w_dtype=torch.float32,
                    w_scale=0.1))
    enc.append(dict(name="bfloat16_T300_d256_r2100_walk", lead=(300,),
                    d=256, r=2100, x_dtype=torch.bfloat16,
                    w_dtype=torch.float32, w_scale=0.0625))
    # odd widths: x's rows and the codes' rows not in pairs
    for wdt in (torch.float32, torch.bfloat16):
        enc.append(dict(name=f"bfloat16_T33_d63_r37_w{str(wdt)[6:]}",
                        lead=(33,), d=63, r=37, x_dtype=torch.bfloat16,
                        w_dtype=wdt, w_scale=0.125))
    for T, d, r in ((128, 128, 32), (64, 256, 100)):
        for dt in (torch.float32, torch.bfloat16):
            dec.append(dict(name=f"w{str(dt).replace('torch.', '')}_T{T}_r{r}"
                                 f"_d{d}", lead=(T,), d=d, r=r, w_dtype=dt,
                            out_dtype=torch.float32, w_scale=0.05))
    dec.append(dict(name="batched_2x37_r16_d64", lead=(2, 37), d=64, r=16,
                    w_dtype=torch.float32, out_dtype=torch.float32,
                    w_scale=0.1))
    # a ragged column tile and token tile; odd rank (codes not in pairs)
    dec.append(dict(name="wfloat32_T300_r1278_d1000", lead=(300,), d=1000,
                    r=1278, w_dtype=torch.float32,
                    out_dtype=torch.bfloat16, w_scale=1278 ** -0.5))
    dec.append(dict(name="wbfloat16_T50_r37_d96", lead=(50,), d=96, r=37,
                    w_dtype=torch.bfloat16, out_dtype=torch.float32,
                    w_scale=0.125))
    d, T = pcfg.sam.d_model, pcfg.sam_tokens
    for r in ranks:
        enc.append(dict(name=f"main_r{r}", lead=(1, T), d=d, r=r,
                        x_dtype=pcfg.sam.adtype, w_dtype=torch.float32,
                        w_scale=d ** -0.5))
        dec.append(dict(name=f"main_r{r}", lead=(1, T), d=d, r=r,
                        w_dtype=torch.float32, out_dtype=pcfg.sam.adtype,
                        w_scale=r ** -0.5))
    return enc, dec


def _bn_bound(nbytes, flops, products):
    """Least time for these bytes and the products the kernel takes on the
    tensor cores: ``products`` bf16 products of ``flops`` operations each
    (ops.tensor_core_products), at the peak of ops.PRODUCT_DTYPE. Beside it
    the float32 bound of the same function on the CUDA cores (the first
    design's), as a yardstick."""
    from repro_torch.kernels.bottleneck import ops
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = products * flops / PEAK_FLOPS[ops.PRODUCT_DTYPE]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": products * flops,
            "products": products,
            "f32_bound_ms": 1e3 * max(t_bytes,
                                      flops / PEAK_FLOPS[torch.float32])}


def check_bottleneck_encode(rng, case, dev, timed):
    from repro_torch.kernels.bottleneck import ops, ref
    x, w = encode_inputs(rng, case, dev)
    codes, scales = ops.bottleneck_encode(x, w)
    torch.cuda.synchronize()
    d, r = case["d"], case["r"]
    want_c, want_s = ref.encode_ref(x.reshape(-1, d), w)
    if tuple(codes.shape) != (*case["lead"], r) or \
            tuple(scales.shape) != (*case["lead"], 1):
        raise AssertionError(f"bottleneck_encode {case['name']}: shapes "
                             f"{tuple(codes.shape)}, {tuple(scales.shape)}")
    max_diff, off, s_err = codes_held_against(
        f"bottleneck_encode {case['name']}", codes.reshape(-1, r),
        scales.reshape(-1, 1), want_c, want_s)
    T = int(np.prod(case["lead"]))
    res = {"case": case["name"], "T": T, "d": d, "r": r,
           "x_dtype": str(case["x_dtype"]).replace("torch.", ""),
           "w_dtype": str(case["w_dtype"]).replace("torch.", ""),
           "max_abs_err": max_diff, "codes_off_frac": off,
           "scales_max_abs_err": s_err}
    msg = (f"[kernel] bottleneck_encode {case['name']}: T={T} d={d} r={r} "
           f"x {res['x_dtype']} w {res['w_dtype']}: codes off by <= "
           f"{max_diff} on {off:.3g} of entries (limit 1 on < "
           f"{CODES_OFF_FRAC}); scales max abs err {s_err:.3g} (rtol "
           f"{SCALES_TOL[0]}, atol {SCALES_TOL[1]})")
    if timed:
        nbytes = x.numel() * x.element_size() + w.numel() * w.element_size() \
            + T * r + T * 4
        res.update(_bn_bound(nbytes, 2 * T * d * r, ops.tensor_core_products(
            x.dtype, w.dtype)))
        copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
        sets = [(x, w)] + [encode_inputs(rng, case, dev)
                           for _ in range(copies - 1)]

        def matmul_quant(xx, ww):
            # ten library calls: cast, matmul, abs, amax, div, add, div,
            # round, clamp, cast
            z = torch.matmul(xx.float(), ww)
            s = torch.amax(torch.abs(z), dim=-1, keepdim=True) / 127.0 + 1e-8
            return torch.clamp(torch.round(z / s), -127, 127).to(torch.int8), s

        res.update({
            "ms": device_ms(ops.bottleneck_encode, sets),
            "plain_ms": device_ms(
                lambda xx, ww: ref.encode_ref(xx.reshape(-1, d), ww), sets),
            "matmul_quant_ms": device_ms(matmul_quant, sets),
            "matmul_quant_calls": 10})
        msg += (f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f}"
                f" matmul_quant_ms={res['matmul_quant_ms']:.4f} (10 calls)"
                f" bound_ms={res['bound_ms']:.4f} ({res['bound_by']}, "
                f"{res['products']} bf16 products; float32 "
                f"{res['f32_bound_ms']:.4f})")
    log(msg)
    return res


def check_bottleneck_decode(rng, case, dev, timed):
    from repro_torch.kernels.bottleneck import ops, ref
    codes, scales, w = decode_inputs_bn(rng, case, dev)
    out_dtype = case["out_dtype"]
    out = ops.bottleneck_decode(codes, scales, w, out_dtype)
    torch.cuda.synchronize()
    d, r = case["d"], case["r"]
    want = ref.decode_ref(codes.reshape(-1, r), scales.reshape(-1, 1), w,
                          out_dtype)
    if tuple(out.shape) != (*case["lead"], d) or out.dtype != out_dtype:
        raise AssertionError(f"bottleneck_decode {case['name']}: "
                             f"{out.dtype} {tuple(out.shape)}")
    tol = DECODE_TOL[out_dtype]
    max_err = held_against(f"bottleneck_decode {case['name']}",
                           out.reshape(-1, d), want, tol)
    T = int(np.prod(case["lead"]))
    res = {"case": case["name"], "T": T, "r": r, "d": d,
           "w_dtype": str(case["w_dtype"]).replace("torch.", ""),
           "out_dtype": str(out_dtype).replace("torch.", ""),
           "max_abs_err": max_err, "rtol": tol[0], "atol": tol[1]}
    msg = (f"[kernel] bottleneck_decode {case['name']}: T={T} r={r} d={d} "
           f"w {res['w_dtype']} -> {res['out_dtype']} max_abs_err="
           f"{max_err:.3g} (rtol {tol[0]}, atol {tol[1]})")
    if timed:
        nbytes = T * r + T * 4 + w.numel() * w.element_size() \
            + T * d * out.element_size()
        res.update(_bn_bound(nbytes, 2 * T * r * d, ops.tensor_core_products(
            codes.dtype, w.dtype)))
        copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
        sets = [(codes, scales, w)] + [decode_inputs_bn(rng, case, dev)
                                       for _ in range(copies - 1)]

        def dequant_matmul(c, s, ww):
            # four library calls: cast, mul, matmul, cast
            return torch.matmul(c.float() * s, ww).to(out_dtype)

        res.update({
            "ms": device_ms(lambda c, s, ww: ops.bottleneck_decode(
                c, s, ww, out_dtype), sets),
            "plain_ms": device_ms(lambda c, s, ww: ref.decode_ref(
                c.reshape(-1, r), s.reshape(-1, 1), ww, out_dtype), sets),
            "dequant_matmul_ms": device_ms(dequant_matmul, sets),
            "dequant_matmul_calls": 4})
        msg += (f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f}"
                f" dequant_matmul_ms={res['dequant_matmul_ms']:.4f} (4 calls)"
                f" bound_ms={res['bound_ms']:.4f} ({res['bound_by']}, "
                f"{res['products']} bf16 products; float32 "
                f"{res['f32_bound_ms']:.4f})")
    log(msg)
    return res


# ---------------------------------------------------------------------------
# the encoders' and plain paths' attention (models/attention.py:sdpa_f32)
# ---------------------------------------------------------------------------


def sdpa_upcast_f32(q, k, v, mask, scale):
    """``attention.sdpa_f32`` as it was before it multiplied bf16 operands
    on the tensor cores: float32 copies of q, k, v and the bf16
    probabilities, multiplied in float32 (TF32 off). The yardstick of
    ``check_sdpa``."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    scores = scores + mask.reshape(mask.shape[0], 1, 1, *mask.shape[1:])
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, S, H, hd)


def sdpa_cases(pcfg):
    """The three shapes that reach ``_sdpa`` on the served paths: SAM's
    global attention over one frame's token grid, CLIP's over a Context
    microbatch of 4, and the LLM prefill of the plain path
    (``use_flash=False``) at B = 4, causal."""
    sam, clip, llm = pcfg.sam, pcfg.clip, pcfg.llm
    return [
        dict(name="sam_B1", B=1, S=pcfg.sam_tokens, H=sam.num_heads,
             K=sam.num_kv_heads, hd=sam.resolved_head_dim, causal=False),
        dict(name="clip_B4", B=4, S=pcfg.clip_tokens, H=clip.num_heads,
             K=clip.num_kv_heads, hd=clip.resolved_head_dim, causal=False),
        dict(name="llm_prefill_B4", B=4, S=pcfg.clip_tokens + QUERY_LEN,
             H=llm.num_heads, K=llm.num_kv_heads, hd=llm.resolved_head_dim,
             causal=True)]


def check_sdpa(rng, case, dev, dtype=torch.bfloat16):
    """``attention.sdpa_f32`` on the card against the float32 upcast
    (``sdpa_upcast_f32``) on the same bf16 inputs. Each of its two products
    (``attention.scores_f32`` and ``attention.pv_f32``: ``torch.bmm`` of
    the native operands with a float32 result) against the same product of
    the upcast operands, q.k and then P.V on one bf16 P, within
    TOL[float32]: the products are exact in both, only the summation order
    differs. The outputs within SDPA_RTOL (norm-wise), which the same
    output rounded to bf16 (a route with a bf16 P.V result) must fail.
    Both routes timed."""
    from repro_torch.models import attention
    B, S, H, K, hd = (case[n] for n in ("B", "S", "H", "K", "hd"))
    q, k, v = (torch.from_numpy(rng.randn(B, S, n, hd).astype(np.float32)
                                ).to(dev, dtype) for n in (H, K, K))
    mask = torch.zeros((1, S, S), dtype=torch.float32, device=dev)
    if case["causal"]:
        mask = torch.triu(torch.full((1, S, S), -1e30, device=dev), 1)
    scale = 1.0 / math.sqrt(hd)
    name = f"sdpa {case['name']}"
    qg = q.reshape(B, S, K, H // K, hd).permute(0, 2, 3, 1, 4).reshape(
        B * K, -1, hd)
    kt = k.permute(0, 2, 3, 1).reshape(B * K, hd, S)
    scores = torch.bmm(qg.float(), kt.float())
    qk_err = held_against(f"{name} q.k", attention.scores_f32(q, k), scores,
                          TOL[torch.float32])
    probs = torch.softmax(scores * scale, dim=-1).to(dtype)
    vg = v.permute(0, 2, 1, 3).reshape(B * K, S, hd)
    pv_err = held_against(f"{name} p.v", attention.pv_f32(probs, v),
                          torch.bmm(probs.float(), vg.float()),
                          TOL[torch.float32])
    del scores, probs
    got = attention.sdpa_f32(q, k, v, mask, scale)
    want = sdpa_upcast_f32(q, k, v, mask, scale)
    rel = _rel(got, want)
    control = _rel(got.to(dtype).float(), want)
    if not (torch.isfinite(got).all() and rel <= SDPA_RTOL):
        raise AssertionError(f"{name}: output off the float32 upcast by "
                             f"{rel:.3g} (norm-wise), limit {SDPA_RTOL}")
    if not control > SDPA_RTOL:
        raise AssertionError(f"{name}: the output rounded to bf16 reads "
                             f"{control:.3g}, within the limit {SDPA_RTOL}: "
                             f"the check cannot tell a bf16 P.V result")
    off = int((got.to(dtype) != want.to(dtype)).sum())
    res = {"case": case["name"], "qk_max_abs_err": qk_err,
           "pv_max_abs_err": pv_err, "rel_err": rel,
           "bf16_pv_rel_err": control, "limit": SDPA_RTOL,
           "max_abs_err": float((got - want).abs().max()),
           "bf16_not_bit_equal": off, "elements": got.numel()}
    del got, want
    args = [(q, k, v, mask)]
    res["ms"] = device_ms(lambda *a: attention._sdpa(*a, scale), args)
    res["upcast_ms"] = device_ms(
        lambda *a: sdpa_upcast_f32(*a, scale).to(dtype), args)
    log(f"[sdpa] {case['name']}: B={B} S={S} H={H} K={K} hd={hd}: bf16 "
        f"operands on the tensor cores against the float32 upcast: q.k max "
        f"abs err {qk_err:.3g}, p.v {pv_err:.3g} (rtol "
        f"{TOL[torch.float32][0]}, atol {TOL[torch.float32][1]}); output "
        f"{rel:.3g} norm-wise (limit {SDPA_RTOL}; rounded to bf16 "
        f"{control:.3g}), max abs "
        f"{res['max_abs_err']:.3g}, {off} of {res['elements']} bf16 outputs "
        f"not bit-equal; ms {res['ms']:.4f}, upcast ms "
        f"{res['upcast_ms']:.4f}")
    return res


# ---------------------------------------------------------------------------
# phase 3: ssm_scan against its plain version
# ---------------------------------------------------------------------------

# the scan kernel against scan_ref on the same inputs: both round a
# multiply and an add per step in float32, so they agree bit for bit;
# the limits are the reference's own kernel test's
# (tests/test_kernels.py), 2e-4 for its long-decay case
SCAN_TOL = (1e-5, 1e-6)
SCAN_LONG_TOL = (2e-4, 2e-4)


def scan_cases(zoo_cfgs):
    """The four shapes of the reference's scan test and its 512-step
    long-decay case (float32), a bf16-input case, and the two prefill
    path shapes at B = 2, S = 1024: falcon-mamba-7b (C = d_inner, N) and
    zamba2-7b (C = d_inner, the heads' P x N flattened as the path
    flattens them, N)."""
    cases = [dict(name=f"float32_B{B}_S{S}_C{C}_N{N}", shape=(B, S, C, N),
                  dtype=torch.float32, lo=0.5, hi=1.0, drive=0.1,
                  tol=SCAN_TOL)
             for B, S, C, N in ((2, 64, 128, 16), (1, 100, 60, 8),
                                (2, 128, 256, 4), (1, 33, 16, 16))]
    cases.append(dict(name="float32_long_decay_B1_S512_C32_N8",
                      shape=(1, 512, 32, 8), dtype=torch.float32, lo=0.9,
                      hi=0.999, drive=1.0, tol=SCAN_LONG_TOL))
    cases.append(dict(name="bf16_B2_S256_C512_N16", shape=(2, 256, 512, 16),
                      dtype=torch.bfloat16, lo=0.5, hi=1.0, drive=0.1,
                      tol=SCAN_TOL))
    for name, cfg in zoo_cfgs.items():
        # mamba1's (B, S, d_inner, N); mamba2's (B, S, heads, P, N) as
        # (B, S, heads * P = d_inner, N)
        shape = (ZOO_BATCH, ZOO_PROMPT, cfg.ssm.expand * cfg.d_model,
                 cfg.ssm.state_size)
        cases.append(dict(name=f"main_{name}", shape=shape,
                          dtype=torch.float32, lo=0.5, hi=1.0, drive=0.1,
                          tol=SCAN_TOL))
    return cases


def scan_inputs(gen, case, dev):
    """decay uniform in [lo, hi), drive normal times ``drive``, made on
    the card (the path shapes are 1-4 GB a tensor)."""
    shape, dtype = case["shape"], case["dtype"]
    decay = torch.rand(shape, generator=gen, device=dev)
    decay = decay.mul_(case["hi"] - case["lo"]).add_(case["lo"])
    drive = torch.randn(shape, generator=gen, device=dev).mul_(case["drive"])
    return decay.to(dtype), drive.to(dtype)


def scan_held_against(name, h, want, tol):
    """A scan output against scan_ref's: within ``tol``; returns (max abs
    error, elements not bit-equal)."""
    err = held_against(name, h, want, tol)
    return err, int((h != want).sum())


def check_ssm_scan(gen, case, dev, timed):
    from repro_torch.kernels.ssm_scan import ops, ref
    decay, drive = scan_inputs(gen, case, dev)
    h = ops.chunked_scan(decay, drive)
    torch.cuda.synchronize()
    want = ref.scan_ref(decay, drive)
    if h.dtype != torch.float32 or h.shape != decay.shape:
        raise AssertionError(f"ssm_scan {case['name']}: {h.dtype} "
                             f"{tuple(h.shape)}")
    rtol, atol = case["tol"]
    max_err, off = scan_held_against(f"ssm_scan {case['name']}", h, want,
                                     case["tol"])
    B, S, C, N = case["shape"]
    res = {"case": case["name"], "B": B, "S": S, "C": C, "N": N,
           "dtype": str(case["dtype"]).replace("torch.", ""),
           "max_abs_err": max_err, "not_bit_equal": off,
           "elements": h.numel(), "rtol": rtol, "atol": atol}
    msg = (f"[kernel] ssm_scan {case['name']}: B={B} S={S} C={C} N={N} "
           f"{res['dtype']} max_abs_err={max_err:.3g} (rtol {rtol}, atol "
           f"{atol}), {off} of {h.numel()} elements not bit-equal")
    del want
    if timed:
        # decay and drive read once, h written once; one multiply and one
        # add an element (float32, outside the tensor cores)
        nbytes = h.numel() * (2 * decay.element_size() + 4)
        flops = 2 * h.numel()
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[
            torch.float32]
        copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
        sets = [(decay, drive)] + [scan_inputs(gen, case, dev)
                                   for _ in range(copies - 1)]
        res.update({
            "ms": device_ms(ops.chunked_scan, sets),
            "plain_ms": device_ms(ref.scan_ref, sets, reps=3),
            "same_bytes_ms": device_ms(
                lambda d, x: torch.add(d, x, out=h), sets),
            "library_ms": None,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops})
        msg += (f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f}"
                f" same_bytes_ms={res['same_bytes_ms']:.4f} (torch.add, "
                f"same bytes) bound_ms={res['bound_ms']:.4f} "
                f"({res['bound_by']})")
    log(msg)
    return res


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------

KINDS = ("context", "context", "insight", "context", "insight", "context")


def make_system(pcfg, seed, dev):
    from repro_torch.core import bottleneck as bn
    from repro_torch.core import vlm
    from repro_torch.core.lut import paper_lut
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = vlm.init_lisa(pcfg, gen, dev)
    lut = paper_lut()
    d = pcfg.sam.d_model
    bns = {t.name: bn.init_bottleneck(
        gen, bn.BottleneckSpec(d, bn.rank_for_ratio(d, t.ratio, 4), 4),
        device=dev) for t in lut.tiers}
    return params, bns, lut


def serve(executor, pcfg, seed, timings=None):
    """Edge-encode six requests, then serve them through the scheduler.
    Returns (requests, results aligned with them, the scheduler)."""
    reqs = edge_encode(executor, pcfg, seed, timings)
    return (reqs,) + serve_requests(executor, reqs, timings)


def edge_encode(executor, pcfg, seed, timings=None):
    """Six requests (KINDS) from seeded images and queries, their packets
    made by the executor's edge stages."""
    from repro_torch.core.intent import Intent
    from repro_torch.runtime.scheduler import ServeRequest
    rng = np.random.RandomState(seed)
    lut, n_ins, reqs = executor.lut, 0, []
    for i, kind in enumerate(KINDS):
        img = rng.rand(1, pcfg.image_size, pcfg.image_size,
                       3).astype(np.float32)
        query = rng.randint(0, pcfg.llm.vocab_size,
                            (1, QUERY_LEN)).astype(np.int32)
        t0 = _sync_s()
        if kind == "context":
            pkt, _ = executor.edge_context(img, i, 0.0)
            intent = Intent.CONTEXT
        else:
            pkt = executor.edge_insight(img, lut.tiers[n_ins % 2], i, 0.0)
            intent, n_ins = Intent.INSIGHT, n_ins + 1
        if timings is not None:
            timings.append({"stage": f"edge_{kind}", "seq_id": i,
                            "s": _sync_s() - t0})
        reqs.append(ServeRequest(seq_id=i, intent=intent, packet=pkt,
                                 query=query))
    return reqs


def serve_requests(executor, reqs, timings=None):
    """Serve the requests through MicrobatchScheduler(generate=True).
    Returns (results aligned with them, the scheduler)."""
    from repro_torch.runtime.scheduler import MicrobatchScheduler
    sched = MicrobatchScheduler(executor=executor, max_batch=4,
                                generate=True)
    for r in reqs:
        sched.submit(r)
    by_id = {}
    while sched.pending:
        t0 = _sync_s()
        out = sched.step()
        if timings is not None:
            timings.append({"stage": f"cloud_generate_batch[{out[0].intent.value}"
                                     f",{out[0].tier_name}]",
                            "batch": len(out), "s": _sync_s() - t0})
        by_id.update({res.seq_id: res for res in out})
    return [by_id[r.seq_id] for r in reqs], sched


def _small_against(label, results, other):
    """Tokens equal, answer logits and masks within 1e-4 (rtol and atol):
    the largest absolute difference."""
    worst = 0.0
    for a, b in zip(results, other):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"seq {a.seq_id}: {label}: tokens "
                                 f"{a.tokens} != {b.tokens}")
        pairs = [(a.answer_logits, b.answer_logits)]
        if a.mask_logits is not None:
            pairs.append((a.mask_logits, b.mask_logits))
        for x, y in pairs:
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4,
                                       err_msg=label)
            worst = max(worst, float(np.abs(x - y).max()))
    return worst


def small_input_check(seed, dev):
    """LISA-mini, fp32, on the card: the serving path with the decode
    kernel gives the same greedy tokens as the plain path, and logits and
    masks within fp32 summation-order tolerance. Then the same requests
    with ``llm.use_flash=True`` (the float32 flash kernel in every LLM
    prefill layer), counters from 0: exactly one flash launch a layer and
    microbatch, tokens equal to the ``use_flash=False`` kernel run's, logits
    and masks within the same tolerance."""
    from repro_torch.configs import get_lisa_config
    from repro_torch.core.streams import DualStreamExecutor
    pcfg = get_lisa_config("lisa-mini")
    params, bns, lut = make_system(pcfg, seed, dev)
    outs = {}
    for flash in (True, False):
        ex = DualStreamExecutor(pcfg=pcfg, params=params, bottlenecks=bns,
                                lut=lut, max_new_tokens=MAX_NEW_TOKENS,
                                flash_decode=flash, device=dev)
        outs[flash] = serve(ex, pcfg, seed)[1]
    worst = _small_against("decode kernel vs plain path", outs[True],
                           outs[False])
    log(f"[small] lisa-mini fp32: tokens equal with and without the kernel "
        f"on {len(outs[True])} requests; max |logit/mask diff| {worst:.3g}")
    fcfg = dataclasses.replace(pcfg, llm=pcfg.llm.replace(use_flash=True))
    ex = DualStreamExecutor(pcfg=fcfg, params=params, bottlenecks=bns,
                            lut=lut, max_new_tokens=MAX_NEW_TOKENS,
                            flash_decode=True, device=dev)
    _reset_launch_counts()
    _, results, sched = serve(ex, fcfg, seed)
    counts = _launch_counts()
    n, L = sched.n_microbatches, fcfg.llm.num_layers
    expect = _only(flash_attention=n * L,
                   decode_attention=n * MAX_NEW_TOKENS * L)
    if counts != expect:
        raise AssertionError(f"lisa-mini use_flash launches {counts}, "
                             f"expected {expect}")
    worst_flash = _small_against("use_flash=True vs use_flash=False",
                                 results, outs[True])
    log(f"[small] lisa-mini fp32, use_flash=True: {n} microbatches x {L} "
        f"layers = {counts['flash_attention']} flash launches, decode "
        f"{counts['decode_attention']}; "
        f"tokens equal use_flash=False's on {len(results)} requests; max "
        f"|logit/mask diff| {worst_flash:.3g}")
    return {"requests": len(outs[True]), "max_abs_diff": worst,
            "use_flash": {"launches": counts, "expected": expect,
                          "max_abs_diff": worst_flash}}


def _rel(a, b):
    """Norm-wise relative error of ``a`` against ``b``: arrays, or tensors
    (two tensors on their own device)."""
    if torch.is_tensor(a) and torch.is_tensor(b):
        a, b = a.double(), b.double()
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))
    a, b = (x.double().cpu().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def compare_paths(results, other, limit, label):
    """Hold the main path's results against another path's on the same
    requests: greedy tokens equal, answer and mask logits within ``limit``
    as a norm-wise relative error. Returns the worst error of each."""
    worst = {"answer_logits": 0.0, "mask_logits": 0.0}
    for a, b in zip(results, other):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"seq {a.seq_id}: kernel-path tokens "
                                 f"{a.tokens} != {label} {b.tokens}")
        for key in worst:
            x, y = getattr(a, key), getattr(b, key)
            if x is None:
                continue
            rel = _rel(x, y)
            worst[key] = max(worst[key], rel)
            if not rel <= limit:
                raise AssertionError(f"seq {a.seq_id}: {key} of the kernel "
                                     f"path off the {label} by {rel:.3g} "
                                     f"(norm-wise), limit {limit}")
    log(f"[parity] lisa-7b: kernel path vs {label} on {len(other)} "
        f"requests: tokens equal; norm-wise relative error answer_logits "
        f"{worst['answer_logits']:.3g}, mask_logits "
        f"{worst['mask_logits']:.3g} (limit {limit})")
    return worst


def full_width_parity(executor, reqs, results, expect):
    """LISA-7B at full width, after the main path's counted run.

    (a) Serve the same requests again with every kernel launch held
    against the plain version on the launch's own inputs: the real
    caches (in-place views with their strides), masks and queries of all
    layers and decode steps. (b) Serve them with the kernel's plain
    version in its place, every decode layer also computed with the
    kernel on the same input and held to LAYER_RTOL (``layer_check``), and
    (c) through the plain attention path (``flash_decode=False``), on the
    same weights, and hold the main path's outputs against each: greedy
    tokens equal, logits and masks within PATH_RTOL and
    SDPA_PATH_RTOL."""
    from repro_torch.kernels.decode_attention import ops, ref
    launch, errs, n_diff, n_out = ops.decode_attention, [], 0, 0

    def checked(q, k, v, bias):
        nonlocal n_diff, n_out
        out = launch(q, k, v, bias)
        want = ref.decode_attention_ref(q, k, v, bias)
        errs.append(held_against("decode_attention on the main path's "
                                 "inputs", out, want))
        n_diff += int((out != want).sum())
        n_out += out.numel()
        return out

    ops.decode_attention = checked
    try:
        serve_requests(executor, reqs)
    finally:
        ops.decode_attention = launch
    if len(errs) != expect:
        raise AssertionError(f"held {len(errs)} kernel launches against "
                             f"the plain version, expected {expect}")
    log(f"[parity] lisa-7b: {len(errs)} kernel launches on the main path's "
        f"own inputs agree with the plain version; max abs err "
        f"{max(errs):.3g} (rtol {TOL[torch.bfloat16][0]}, atol "
        f"{TOL[torch.bfloat16][1]}); {n_diff} of {n_out} output elements "
        f"not bit-equal")

    (plain_kernel, _), layers = layer_check(
        "decode", "6 microbatch", lambda: serve_requests(executor, reqs))
    if layers["layers"] != expect:
        raise AssertionError(f"checked {layers['layers']} decode layers, "
                             f"expected {expect}")
    rel = compare_paths(results, plain_kernel, PATH_RTOL,
                        "path with the kernel's plain version")
    sdpa, _ = serve_requests(dataclasses.replace(executor,
                                                 flash_decode=False), reqs)
    rel_sdpa = compare_paths(results, sdpa, SDPA_PATH_RTOL,
                             "flash_decode=False path")
    logits = np.concatenate([r.answer_logits for r in results])
    unit = logits / np.linalg.norm(logits, axis=1, keepdims=True)
    min_cos = float((unit @ unit.T)[np.triu_indices(len(results), 1)].min())
    log(f"[parity] lisa-7b: least cosine between two requests' "
        f"answer_logits {min_cos:.6f}")
    return {"launches_checked": len(errs), "max_abs_err": max(errs),
            "elements_not_bit_equal": n_diff, "elements": n_out,
            "layers": layers,
            "rel_err_plain_kernel": rel, "rel_limit_plain_kernel": PATH_RTOL,
            "rel_err_sdpa": rel_sdpa, "rel_limit_sdpa": SDPA_PATH_RTOL,
            "min_cosine_answer_logits": min_cos}


# ---------------------------------------------------------------------------
# phase 8 (inflight): InflightDecoder over a paged, shared-prefix pool
# ---------------------------------------------------------------------------


def inflight_requests(executor, pcfg, seed, timings=None):
    """Edge-encode the frames INFLIGHT_WAVES names (seeded images and
    queries; Insight frames alternate over two tiers). Returns
    {frame: (kind, packet, query)}."""
    rng = np.random.RandomState(seed + 1)
    frames, n_ins = {}, 0
    for wave in INFLIGHT_WAVES:
        for _, kind, f in wave:
            if f in frames:
                continue
            img = rng.rand(1, pcfg.image_size, pcfg.image_size,
                           3).astype(np.float32)
            query = rng.randint(0, pcfg.llm.vocab_size,
                                (1, QUERY_LEN)).astype(np.int32)
            t0 = _sync_s()
            if kind == "context":
                pkt, _ = executor.edge_context(img, f, 0.0)
            else:
                pkt = executor.edge_insight(img, executor.lut.tiers[n_ins % 2],
                                            f, 0.0)
                n_ins += 1
            if timings is not None:
                timings.append({"stage": f"edge_{kind}", "frame": f,
                                "s": _sync_s() - t0})
            frames[f] = (kind, pkt, query)
    return frames


def serve_inflight(executor, frames, step_times=None):
    """Submit INFLIGHT_WAVES to a fresh InflightDecoder(slots=4), taking
    PUMPS[w] decode steps after wave w, then drain. Returns (results in
    submission order, the decoder). With ``step_times`` each decode step's
    host wall time (ending in the device-to-host copy of its logits) is
    appended, with its live rows."""
    from repro_torch.core.intent import Intent
    from repro_torch.engine import InflightDecoder
    dec = InflightDecoder(executor, slots=INFLIGHT_SLOTS)
    if step_times is not None:
        stage = executor.cloud_decode_rows

        def timed(*args):
            t0 = _sync_s()
            out = stage(*args)
            step_times.append({"live": len(dec.active),
                               "wall_ms": (_sync_s() - t0) * 1e3})
            return out

        executor.cloud_decode_rows = timed
    done = {}
    seq = 0
    try:
        for wave, pumps in zip(INFLIGHT_WAVES, PUMPS):
            for operator, kind, f in wave:
                _, pkt, query = frames[f]
                dec.submit(seq, Intent(kind), pkt, query,
                           lambda r: done.__setitem__(r["seq_id"], r),
                           operator_id=operator)
                seq += 1
            dec.pump(pumps)
        dec.drain()
    finally:
        if step_times is not None:
            del executor.cloud_decode_rows
    failed = [r for r in done.values() if "failure" in r]
    if len(done) != seq or failed:
        raise AssertionError(f"in-flight run served {len(done)} of {seq} "
                             f"requests; failures {failed}")
    return [done[i] for i in range(seq)], dec


def _submissions():
    return [(operator, kind, f) for wave in INFLIGHT_WAVES
            for operator, kind, f in wave]


def check_inflight_outputs(pcfg, results, dec, kinds=None,
                           new_tokens=MAX_NEW_TOKENS):
    """Every output finite with the expected shape; a prefix hit, a join
    after step 0 and slot reuse happened; the pool's invariants hold and
    only the stored prefixes' pages stay in use. ``kinds``: each result's
    request kind (default: phase 8's submissions)."""
    g = pcfg.image_size // pcfg.patch_size \
        * int(round(max(1, pcfg.mask_pixels_per_patch) ** 0.5))
    if kinds is None:
        kinds = [kind for _, kind, _ in _submissions()]
    for kind, r in zip(kinds, results):
        arrs = [r["answer_logits"], r["tokens"]]
        if r["tokens"].shape != (1, new_tokens) or \
                r["answer_logits"].shape != (1, pcfg.llm.vocab_size):
            raise AssertionError(f"seq {r['seq_id']}: bad output shapes")
        if kind == "insight":
            if r["mask_logits"] is None or r["mask_logits"].shape != (1, g,
                                                                      g):
                raise AssertionError(f"seq {r['seq_id']}: bad mask")
            arrs.append(r["mask_logits"])
        elif r["mask_logits"] is not None:
            raise AssertionError(f"seq {r['seq_id']}: Context with a mask")
        if not all(np.isfinite(a).all() for a in arrs):
            raise AssertionError(f"seq {r['seq_id']}: non-finite output")
    hits = sum(r["prefix_hit"] for r in results)
    late = max(r["joined_step"] for r in results)
    if hits < 1 or late < 1 or len(results) <= INFLIGHT_SLOTS:
        raise AssertionError(f"schedule did not exercise the decoder: "
                             f"{hits} prefix hits, latest join at step "
                             f"{late}")
    acct = dec.pool.check_invariants()
    stats = dec.pool.stats()
    if stats["kv_pages_in_use"] != stats["prefix_entries"] * \
            dec.n_prefix_pages:
        raise AssertionError(f"pages in use {stats['kv_pages_in_use']} != "
                             f"{stats['prefix_entries']} prefixes x "
                             f"{dec.n_prefix_pages} pages")
    return {"prefix_hits": hits, "latest_join_step": late,
            "joined_steps": [r["joined_step"] for r in results],
            "pool": acct, "pool_stats": stats}


def compare_inflight(results, other, limits, label, tag="inflight"):
    """Hold the in-flight results against another run's on the same
    requests: tokens equal, answer and mask logits within ``limits``
    (key -> norm-wise relative error; 0 means bit-equal)."""
    worst = {k: 0.0 for k in limits}
    for a, b in zip(results, other):
        if not np.array_equal(a["tokens"], b["tokens"]):
            raise AssertionError(f"seq {a['seq_id']}: tokens {a['tokens']} "
                                 f"!= {label} {b['tokens']}")
        for key, limit in limits.items():
            x, y = a[key], b[key]
            if x is None:
                continue
            rel = _rel(x, y)
            worst[key] = max(worst[key], rel)
            if not rel <= limit:
                raise AssertionError(f"seq {a['seq_id']}: {key} off the "
                                     f"{label} by {rel:.3g} (norm-wise), "
                                     f"limit {limit}")
    log(f"[{tag}] lisa-7b: vs {label} on {len(other)} requests: tokens "
        f"equal; norm-wise relative error "
        + ", ".join(f"{k} {v:.3g} (limit {limits[k]})"
                    for k, v in worst.items()))
    return worst


def inflight_parity(executor, frames, results, expect):
    """(a) Replay the schedule with every paged launch held against the
    plain version on that launch's own inputs (the real pool views, page
    tables and masks of every layer and step); (b) replay it with the
    plain version in the kernel's place, every paged decode layer also
    computed with the kernel on the same input and held to LAYER_RTOL
    (``layer_check``): tokens and answer logits equal, mask logits within
    PATH_RTOL; (c) hold each request against the
    one-shot ``cloud_generate_batch([packet], [query])``, the in-flight
    path's oracle: tokens equal, logits and masks within SDPA_PATH_RTOL
    (the batch sizes of the GEMMs differ, so their bf16 sums do)."""
    from repro_torch.kernels.decode_attention import ops, ref
    launch, errs, n_diff, n_out = ops.paged_decode_attention, [], 0, 0

    def checked(*args):
        nonlocal n_diff, n_out
        out = launch(*args)
        want = ref.paged_decode_attention_ref(*args)
        errs.append(held_against("paged_decode_attention on the in-flight "
                                 "path's inputs", out, want))
        n_diff += int((out != want).sum())
        n_out += out.numel()
        return out

    ops.paged_decode_attention = checked
    try:
        serve_inflight(executor, frames)
    finally:
        ops.paged_decode_attention = launch
    if len(errs) != expect:
        raise AssertionError(f"held {len(errs)} paged launches against the "
                             f"plain version, expected {expect}")
    log(f"[inflight] lisa-7b: {len(errs)} paged kernel launches on the "
        f"in-flight path's own inputs agree with the plain version; max abs "
        f"err {max(errs):.3g} (rtol {TOL[torch.bfloat16][0]}, atol "
        f"{TOL[torch.bfloat16][1]}); {n_diff} of {n_out} output elements "
        f"not bit-equal")
    (plain, _), layers = layer_check(
        "paged", "8 in-flight", lambda: serve_inflight(executor, frames))
    if layers["layers"] != expect:
        raise AssertionError(f"checked {layers['layers']} paged decode "
                             f"layers, expected {expect}")
    rel_plain = compare_inflight(
        results, plain, {"answer_logits": 0.0, "mask_logits": PATH_RTOL},
        "path with the paged kernel's plain version")
    oracle = []
    for (_, kind, f), r in zip(_submissions(), results):
        _, pkt, query = frames[f]
        out = executor.cloud_generate_batch([pkt], [query])[0]
        oracle.append({"seq_id": r["seq_id"], "tokens": out[-1],
                       "answer_logits": out[-2],
                       "mask_logits": out[0] if kind == "insight" else None})
    rel_oracle = compare_inflight(
        results, oracle, {"answer_logits": SDPA_PATH_RTOL,
                          "mask_logits": SDPA_PATH_RTOL},
        "one-shot cloud_generate_batch")
    return {"launches_checked": len(errs), "max_abs_err": max(errs),
            "elements_not_bit_equal": n_diff, "elements": n_out,
            "layers": layers, "rel_err_plain_kernel": rel_plain,
            "rel_err_generate_batch": rel_oracle}


def inflight_timings(executor, frames):
    """Admission wall time (host clock, ending in a synchronise) of a
    prefix miss (the first one on a fresh pool also creates the pool) and
    of a hit, on an idle decoder; then one decode step with every slot
    live, traced: its device time and the device's idle share."""
    from repro_torch.core.intent import Intent
    from repro_torch.engine import InflightDecoder
    dec = InflightDecoder(executor, slots=INFLIGHT_SLOTS)
    contexts = [f for f, (kind, _, _) in sorted(frames.items())
                if kind == "context"]
    out = {}
    seq = 0

    def admit(label, f, operator):
        nonlocal seq
        _, pkt, query = frames[f]
        t0 = _sync_s()
        dec.submit(seq, Intent.CONTEXT, pkt, query, lambda r: None,
                   operator_id=operator)
        out[label] = (_sync_s() - t0) * 1e3
        seq += 1

    for label, f in (("miss_first_ms", contexts[0]),
                     ("miss_ms", contexts[1]), ("hit_ms", contexts[1])):
        admit(label, f, "uav-C")
        dec.drain()
    if dec.active:
        raise AssertionError("decoder not idle after drain")
    for i, f in enumerate(contexts[:INFLIGHT_SLOTS]):
        admit(f"fill_{i}", f, "uav-D")
    if len(dec.active) != INFLIGHT_SLOTS:
        raise AssertionError("timing decoder has idle slots")
    # the trace's warm-up runs the first step with every slot live
    with captured(executor, "cloud_decode_rows") as calls:
        out["step_traced"] = trace("cloud_decode_rows (4 live rows)",
                                   dec.step)
    out["pool_write"] = pool_write_cost(executor, "cloud_decode_rows",
                                        calls[-1], "inflight")
    dec.drain()
    log(f"[inflight] admission wall: prefix miss {out['miss_ms']:.1f} ms "
        f"(first, creating the pool: {out['miss_first_ms']:.1f} ms), prefix "
        f"hit {out['hit_ms']:.2f} ms")
    return {k: v for k, v in out.items() if not k.startswith("fill_")}


@contextlib.contextmanager
def captured(executor, stage):
    """Within the block, the arguments of every call of the executor's
    ``stage`` method, in order, its numpy arrays copied (the decoder
    updates its tables in place after the call)."""
    real, calls = getattr(executor, stage), []

    def record(*args):
        calls.append(tuple(a.copy() if isinstance(a, np.ndarray) else a
                           for a in args))
        return real(*args)

    setattr(executor, stage, record)
    try:
        yield calls
    finally:        # as serve_spec, which may run inside, restores it
        vars(executor).pop(stage, None)


POOL_WRITE_TURNS = 40


def pool_write_cost(executor, stage, args, tag):
    """What fixing the winner of each pool slot costs a paged step: the
    executor's ``stage`` call on ``args`` (one captured step) replayed in
    POOL_WRITE_TURNS turns (A B, B A, ...) with the shipped write
    (``stack._write_src`` once a step, ``attention.write_pool`` a layer)
    and with a direct write of each entry's own row (the write before the
    winners were fixed: duplicate slots keep no fixed winner). A replay
    writes the same rows into the same slots. Host wall of each call,
    ending in a synchronise: medians and quartiles in ms, and of each
    turn's difference (shipped minus direct), which host drift between
    turns does not move."""
    from repro_torch.models import attention, stack
    stage_fn = getattr(executor, stage)

    def direct(pool, write_page, write_off, k, v, src):
        page, off = write_page.reshape(-1), write_off.reshape(-1)
        for name, x in (("k", k), ("v", v)):
            pool[name][page, off] = x.reshape(-1, *x.shape[-2:])

    walls = {"fixed": [], "direct": []}
    for turn in range(POOL_WRITE_TURNS):
        for label in (("fixed", "direct") if turn % 2 == 0
                      else ("direct", "fixed")):
            with contextlib.ExitStack() as patches:
                if label == "direct":
                    patches.enter_context(mock.patch.object(
                        stack, "_write_src", lambda *a: None))
                    patches.enter_context(mock.patch.object(
                        attention, "write_pool", direct))
                t0 = _sync_s()
                stage_fn(*args)
                walls[label].append((_sync_s() - t0) * 1e3)
    walls["diff"] = list(np.subtract(walls["fixed"], walls["direct"]))
    out = {}
    for k, w in walls.items():
        out[f"{k}_ms"] = float(np.median(w))
        out[f"{k}_quartiles_ms"] = [float(np.percentile(w, q))
                                    for q in (25, 75)]
    q = {k: "-".join(f"{x:.2f}" for x in out[f"{k}_quartiles_ms"])
         for k in walls}
    log(f"[{tag}] pool write A/B, {stage} with {INFLIGHT_SLOTS} live rows, "
        f"{POOL_WRITE_TURNS} turns: fixed winners median "
        f"{out['fixed_ms']:.2f} ms (quartiles {q['fixed']}), direct write "
        f"{out['direct_ms']:.2f} ({q['direct']}); a turn's difference "
        f"median {out['diff_ms']:+.2f} ms ({q['diff']})")
    return out


KERNELS = ("paged_verify_attention", "paged_decode_attention",
           "decode_attention", "flash_attention", "bottleneck_encode",
           "bottleneck_decode", "ssm_scan")


def _launch_counts():
    """Each kernel wrapper's launch counter."""
    from repro_torch.kernels.bottleneck import ops as bops
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssm_scan import ops as sops
    return {"decode_attention": ops.launches,
            "paged_decode_attention": ops.paged_launches,
            "paged_verify_attention": ops.verify_launches,
            "flash_attention": fops.flash_launches,
            "bottleneck_encode": bops.encode_launches,
            "bottleneck_decode": bops.bottleneck_decode_launches,
            "ssm_scan": sops.scan_launches}


def _reset_launch_counts():
    from repro_torch.kernels.bottleneck import ops as bops
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssm_scan import ops as sops
    ops.launches = ops.paged_launches = ops.verify_launches = 0
    fops.flash_launches = 0
    bops.encode_launches = bops.bottleneck_decode_launches = 0
    sops.scan_launches = 0


def _only(**want):
    """The launch counts of a run that launches the kernels named (with
    these counts) and no other."""
    return {k: want.get(k, 0) for k in KERNELS}


# the device functions of a kernel whose names are not "<kernel>_kernel"
KERNEL_FUNCTIONS = {"flash_attention": ("flash_wgmma_kernel",
                                        "flash_ws_kernel",
                                        "flash_tf32_kernel")}


def _kernel_class(name: str, classes=None) -> str:
    """The port kernel a traced kernel name belongs to (checked longest
    name first: one is a suffix of another), else a class of ``classes``
    (class -> substrings of the lower-case name), else a library class."""
    for k in KERNELS:
        if any(f in name for f in KERNEL_FUNCTIONS.get(k, (f"{k}_kernel",))):
            return k
    low = name.lower()
    for cls, words in (classes or {}).items():
        if any(w in low for w in words):
            return cls
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul"
    if "softmax" in low:
        return "softmax"
    return "other"


TRACE_SETTLE_S = 0.2
# a trace that lost kernel events is taken again, up to this many times in
# all, where the traced function can run again (``trace(attempts=)``): the
# profiler dropped the first 18 of an Insight microbatch's 128 decode
# launches once in some forty full runs on an H100 (PERF.md §7); each drop
# is logged
TRACE_ATTEMPTS = 3


def _profiled(fn, classes):
    """One profiled warm-up and recorded run of ``fn`` (see ``trace``):
    (device ms by class, the top kernels, the port kernels in the trace,
    the launches the wrappers counted, the traced wall in seconds)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        # the device may still run the warm-up's kernels: let it finish,
        # or they land in the recorded window
        torch.cuda.synchronize()
        prof.step()
        # let the switch from warm-up to recording settle before the first
        # recorded launch: without this pause a speculative step's first
        # draft kernels were missing from the trace (93 and 95 of its 96
        # decode launches found, all 32 verify launches, which come last)
        time.sleep(TRACE_SETTLE_S)
        before = _launch_counts()
        t0 = _sync_s()
        fn()
        traced = _sync_s() - t0
        made = {k: v - before[k] for k, v in _launch_counts().items()}
        prof.step()
    by_class, top = {}, []
    seen = {k: 0 for k in KERNELS}
    for e in prof.key_averages():
        dev_us = e.self_device_time_total
        if (dev_us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith("ProfilerStep")):
            continue          # the schedule's step span is no kernel
        cls = _kernel_class(e.key, classes)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
        top.append((dev_us / 1e3, e.count, e.key[:90]))
        if cls in seen:
            seen[cls] += e.count
    return by_class, top, seen, made, traced


def trace(label, fn, classes=None, attempts=1):
    """Run ``fn`` twice under ``torch.profiler``: once as the profiler's
    warm-up, whose events are discarded (the first traced kernels can be
    lost while the tracer starts), then once recorded. Reports the recorded
    run's traced wall time, device time by kernel class (``classes``:
    extra classes, ``_kernel_class``), the top kernels, and the device's
    idle share (1 - kernel time / traced wall). Fails if the trace holds
    another count of any port kernel than its wrapper launched in the
    recorded run (the profiler dropped events) in each of ``attempts``
    tries (each a warm-up and a recorded run; for an ``fn`` that can run
    again), or more kernel time than the traced wall (it counted a span as
    a kernel)."""
    for attempt in range(1, attempts + 1):
        by_class, top, seen, made, traced = _profiled(fn, classes)
        if seen == made:
            break
        msg = (f"{label}: the trace holds port kernels {seen} but {made} "
               f"were launched; the profiler dropped events")
        if attempt == attempts:
            raise AssertionError(msg)
        log(f"[profile] {msg} (attempt {attempt} of {attempts})")
    busy = sum(by_class.values())
    if not 0 < busy <= traced * 1e3:
        raise AssertionError(f"{label}: the profiler recorded {busy:.2f} ms "
                             f"of device time in {traced * 1e3:.2f} ms")
    top.sort(reverse=True)
    log(f"[profile] {label}: traced wall {traced * 1e3:.2f} ms, device "
        f"{busy:.2f} ms (idle share {1.0 - busy / (traced * 1e3):.3f}); by "
        "class " + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])))
    for t, c, n in top[:6]:
        log(f"[profile]   {t:8.3f} ms  x{c:<5d} {n}")
    return {"traced_wall_ms": traced * 1e3, "device_ms": busy,
            "idle_share": 1.0 - busy / (traced * 1e3),
            "port_kernels_traced": seen, "attempts": attempt,
            "device_ms_by_class": by_class,
            "top_kernels": [{"ms": t, "count": c, "name": n}
                            for t, c, n in top[:10]]}


def profile_microbatches(executor, reqs):
    """Warm replays of one Context and one Insight microbatch: the
    untraced wall time, then a traced run's device time by kernel class
    and the device's idle share."""
    batches = {
        "context": [r for r in reqs if r.packet.kind == "context"],
        "insight": [r for r in reqs if r.packet.kind == "insight"][:1]}
    report = {}
    for label, batch in batches.items():
        args = ([r.packet for r in batch], [r.query for r in batch])
        executor.cloud_generate_batch(*args)
        t0 = _sync_s()
        executor.cloud_generate_batch(*args)
        warm = _sync_s() - t0
        log(f"[profile] {label} B={len(batch)}: warm wall "
            f"{warm * 1e3:.1f} ms")
        report[f"{label}_B{len(batch)}"] = dict(
            warm_wall_ms=warm * 1e3,
            **trace(f"{label} B={len(batch)}",
                    lambda: executor.cloud_generate_batch(*args),
                    attempts=TRACE_ATTEMPTS))
    return report


def inflight_phase(executor, pcfg, seed):
    """Phase 8: the paged in-flight path at LISA-7B's full width, with the
    launch counters set to 0 just before its counted run and read just
    after, then its parity checks and timings. Returns (report, the
    edge-encoded frames)."""
    timings, steps = [], []
    frames = inflight_requests(executor, pcfg, seed, timings)
    _reset_launch_counts()
    t0 = _sync_s()
    results, dec = serve_inflight(executor, frames, steps)
    wall = _sync_s() - t0
    launches = _launch_counts()
    expect = dec.n_steps * pcfg.llm.num_layers
    log(f"[inflight] {len(results)} requests on {INFLIGHT_SLOTS} slots in "
        f"{dec.n_steps} decode steps (mean live slots "
        f"{dec.mean_live_slots:.2f}), wall {wall:.2f} s; joined at steps "
        f"{[r['joined_step'] for r in results]}, prefix hits "
        f"{[int(r['prefix_hit']) for r in results]}; launches {launches} "
        f"(paged expected {expect})")
    if launches != _only(paged_decode_attention=expect) or expect == 0:
        raise AssertionError(f"in-flight path launches {launches}, expected "
                             f"{expect} paged and no others")
    shape = check_inflight_outputs(pcfg, results, dec)
    log(f"[inflight] outputs finite with expected shapes; pool "
        f"{shape['pool']}, {shape['pool_stats']['prefix_entries']} prefixes "
        f"x {dec.n_prefix_pages} pages in use; tokens "
        f"{[r['tokens'].tolist()[0] for r in results]}")
    full = [t["wall_ms"] for t in steps if t["live"] == INFLIGHT_SLOTS]
    step_ms = float(np.median(full)) if full else None
    log(f"[inflight] cloud_decode_rows wall with {INFLIGHT_SLOTS} live rows: "
        f"median {step_ms} ms over {len(full)} steps; all steps "
        f"{[round(t['wall_ms'], 1) for t in steps]}")
    out = {"wall_s": wall, "n_steps": dec.n_steps,
           "mean_live_slots": dec.mean_live_slots, "launches": launches,
           "expected_paged_launches": expect, "edge": timings,
           "steps": steps, "step_wall_ms_full": step_ms, **shape}
    out["parity"] = inflight_parity(executor, frames, results, expect)
    out["timings"] = inflight_timings(executor, frames)
    return out, frames, results


# ---------------------------------------------------------------------------
# phase 9 (spec): speculative decoding in the in-flight decoder
# ---------------------------------------------------------------------------


def spec_executor(executor):
    """An executor of SPEC_MAX_NEW_TOKENS new tokens over pages of
    SPEC_PAGE slots that shares ``executor``'s weights (phases 9, 12c,
    13b, 13c)."""
    from repro_torch.core.streams import DualStreamExecutor
    return DualStreamExecutor(pcfg=executor.pcfg, params=executor.params,
                              bottlenecks=executor.bottlenecks,
                              lut=executor.lut,
                              max_new_tokens=SPEC_MAX_NEW_TOKENS,
                              flash_decode=True, page_size=SPEC_PAGE,
                              device=executor.device)


def _spec_submissions(frames):
    """(operator, kind, frame, drafts) of every SPEC_WAVES request."""
    return [(op, frames[f][0], f, drafts) for wave in SPEC_WAVES
            for op, f, drafts in wave]


def serve_spec(executor, frames, spec, step_times=None):
    """Submit SPEC_WAVES to a fresh InflightDecoder(slots=4, spec=spec),
    one step after the first wave, then drain. Returns (results in
    submission order, the decoder, the number of verify and of plain
    decode steps). With ``step_times`` each step's host wall time (ending
    in the device-to-host copy of its logits) is appended, with its stage
    and live rows."""
    from repro_torch.core.intent import Intent
    from repro_torch.engine import InflightDecoder
    dec = InflightDecoder(executor, slots=INFLIGHT_SLOTS, spec=spec)
    calls = {"cloud_verify_rows": 0, "cloud_decode_rows": 0}

    def counted(name):
        stage = getattr(executor, name)

        def run(*args):
            calls[name] += 1
            t0 = _sync_s() if step_times is not None else 0.0
            out = stage(*args)
            if step_times is not None:
                step_times.append({"stage": name, "live": len(dec.active),
                                   "wall_ms": (_sync_s() - t0) * 1e3})
            return out
        return run

    for name in calls:
        setattr(executor, name, counted(name))
    done = {}
    seq = 0
    try:
        for w, wave in enumerate(SPEC_WAVES):
            for operator, f, drafts in wave:
                kind, pkt, query = frames[f]
                dec.submit(seq, Intent(kind), pkt, query,
                           lambda r: done.__setitem__(r["seq_id"], r),
                           operator_id=operator,
                           speculative=None if drafts else False)
                seq += 1
            if w == 0:
                dec.pump(1)
        dec.drain()
    finally:
        for name in calls:
            delattr(executor, name)
    failed = [r for r in done.values() if "failure" in r]
    if len(done) != seq or failed:
        raise AssertionError(f"spec run served {len(done)} of {seq} "
                             f"requests; failures {failed}")
    return [done[i] for i in range(seq)], dec, calls


def spec_run(executor, pcfg, frames, spec, label, step_times=None):
    """One counted run: launch counters set to 0 just before, read just
    after; verify launches must be verify steps x layers, paged decode
    launches plain steps x layers, contiguous launches the draft model's
    decode steps x layers."""
    _reset_launch_counts()
    t0 = _sync_s()
    results, dec, calls = serve_spec(executor, frames, spec, step_times)
    wall = _sync_s() - t0
    launches = _launch_counts()
    L = pcfg.llm.num_layers
    draft_steps = dec.draft.n_steps if dec.draft is not None else 0
    expect = _only(paged_verify_attention=calls["cloud_verify_rows"] * L,
                   paged_decode_attention=calls["cloud_decode_rows"] * L,
                   decode_attention=draft_steps * L)
    stats = dec.spec_stats.as_dict()
    log(f"[spec] {label}: {len(results)} requests on {INFLIGHT_SLOTS} slots "
        f"in {calls['cloud_verify_rows']} verify and "
        f"{calls['cloud_decode_rows']} plain steps, {draft_steps} draft "
        f"steps, {dec.draft.n_prefills if dec.draft else 0} draft prefills,"
        f" wall {wall:.2f} s; launches {launches} (expected {expect}); "
        f"joined at steps {[r['joined_step'] for r in results]}, prefix "
        f"hits {[int(r['prefix_hit']) for r in results]}")
    log(f"[spec] {label}: SpecStats {json.dumps(stats)}")
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expect}")
    kinds = [kind for _, kind, _, _ in _spec_submissions(frames)]
    shape = check_inflight_outputs(pcfg, results, dec, kinds,
                                   SPEC_MAX_NEW_TOKENS)
    log(f"[spec] {label}: outputs finite with expected shapes; pool "
        f"{shape['pool']}; tokens {[r['tokens'].tolist()[0] for r in results]}")
    return results, dec, {"wall_s": wall, "launches": launches,
                          "expected_launches": expect, "steps": calls,
                          "draft_steps": draft_steps,
                          "draft_prefills": dec.draft.n_prefills
                          if dec.draft else 0,
                          "spec_stats": stats, **shape}


def spec_parity(executor, frames, spec, results, expect):
    """(a) Replay run A with every verify launch held against the plain
    version on that launch's own inputs (the real pool views, page tables
    and per-query masks of every layer and step); (b) replay it with the
    plain version in the kernel's place: tokens and answer logits equal,
    mask logits within PATH_RTOL; (c) in that replay, every verify layer
    also computed with the kernel on the same input and held to
    LAYER_RTOL (``layer_check``), ``expect`` layers in all."""
    from repro_torch.kernels.decode_attention import ops, ref
    launch, errs, n_diff, n_out = ops.paged_verify_attention, [], 0, 0

    def checked(*args):
        nonlocal n_diff, n_out
        out = launch(*args)
        want = ref.paged_verify_attention_ref(*args)
        errs.append(held_against("paged_verify_attention on the spec "
                                 "path's inputs", out, want))
        n_diff += int((out != want).sum())
        n_out += out.numel()
        return out

    ops.paged_verify_attention = checked
    try:
        serve_spec(executor, frames, spec)
    finally:
        ops.paged_verify_attention = launch
    if len(errs) != expect:
        raise AssertionError(f"held {len(errs)} verify launches against the "
                             f"plain version, expected {expect}")
    log(f"[spec] lisa-7b: {len(errs)} verify kernel launches on the spec "
        f"path's own inputs agree with the plain version; max abs err "
        f"{max(errs):.3g} (rtol {TOL[torch.bfloat16][0]}, atol "
        f"{TOL[torch.bfloat16][1]}); {n_diff} of {n_out} output elements "
        f"not bit-equal")
    (plain, _, _), layers = layer_check(
        "verify", "9 spec run A", lambda: serve_spec(executor, frames, spec))
    if layers["layers"] != expect:
        raise AssertionError(f"checked {layers['layers']} verify layers, "
                             f"expected {expect}")
    rel = compare_inflight(results, plain,
                           {"answer_logits": 0.0, "mask_logits": PATH_RTOL},
                           "spec path with the verify kernel's plain version",
                           tag="spec")
    return {"launches_checked": len(errs), "max_abs_err": max(errs),
            "elements_not_bit_equal": n_diff, "elements": n_out,
            "layers": layers, "rel_err_plain_kernel": rel}


def spec_timings(executor, frames, spec):
    """Three decoders with every slot live and speculating (Context frames
    of uav-C, their draft prefix rows shared): the wall time of one step
    (draft rounds + verify, ending in a synchronise) on the first, then
    one traced step on the third, the second's step being the trace's
    warm-up. Each is its decoder's first step: full chunks of k+1."""
    from repro_torch.core.intent import Intent
    from repro_torch.core.paging import PagePool
    from repro_torch.engine import InflightDecoder
    contexts = [f for f, (kind, _, _) in sorted(frames.items())
                if kind == "context"][:INFLIGHT_SLOTS]
    pool, rows, decs = PagePool(page_size=SPEC_PAGE), {}, []
    for _ in range(3):
        dec = InflightDecoder(executor, slots=INFLIGHT_SLOTS, pool=pool,
                              spec=spec, spec_prefix_rows=rows)
        for i, f in enumerate(contexts):
            _, pkt, query = frames[f]
            dec.submit(i, Intent.CONTEXT, pkt, query, lambda r: None,
                       operator_id="uav-C")
        if len(dec.active) != INFLIGHT_SLOTS:
            raise AssertionError("timing decoder has idle slots")
        decs.append(dec)
    with captured(executor, "cloud_verify_rows") as calls:
        t0 = _sync_s()
        decs[0].step()
        step_ms = (_sync_s() - t0) * 1e3
    # before the other decoders take pages that this step's rollback freed
    write = pool_write_cost(executor, "cloud_verify_rows", calls[-1],
                            "spec")
    log(f"[spec] one speculative step (draft + verify) with "
        f"{INFLIGHT_SLOTS} live rows: wall {step_ms:.1f} ms")
    queue = decs[1:]
    traced = trace(f"speculative step ({INFLIGHT_SLOTS} live rows)",
                   lambda: queue.pop(0).step())
    want = executor.pcfg.llm.num_layers
    if traced["port_kernels_traced"]["paged_verify_attention"] != want:
        raise AssertionError(f"the traced step holds "
                             f"{traced['port_kernels_traced']} port kernels;"
                             f" expected {want} verify kernels")
    for dec in decs:
        dec.drain()
    return {"step_wall_ms": step_ms, "step_traced": traced,
            "pool_write": write}


def spec_phase(executor, pcfg, seed, frames):
    """Phase 9: speculative decoding at LISA-7B's full width on an executor
    of 6 new tokens over pages of 4 that shares the serving executor's
    weight tensors. Run A drafts with the serving weights (3 drafts), run
    B with a divergent draft (4 drafts; the LLM and seg_proj of a second
    random LISA-7B from ``seed``+1). Each counts its launches from 0; both
    must give the tokens of a spec=None decoder (answer logits bit-equal)
    and of the one-shot cloud_generate_batch."""
    from repro_torch.core import vlm
    from repro_torch.engine.speculative import SpeculativeConfig
    dev = executor.device
    sx = spec_executor(executor)
    if sx.params["llm"]["embed"] is not executor.params["llm"]["embed"]:
        raise AssertionError("the spec executor copied the weights")
    out = {}
    step_times = []
    spec_a = SpeculativeConfig(draft_tokens=3)
    res_a, dec_a, out["run_a"] = spec_run(sx, pcfg, frames, spec_a,
                                          "run A (shared draft, k=3)",
                                          step_times)
    if not (out["run_a"]["steps"]["cloud_verify_rows"]
            and out["run_a"]["steps"]["cloud_decode_rows"]
            and out["run_a"]["draft_prefills"] < sum(
                d for *_, d in _spec_submissions(frames))):
        raise AssertionError("run A did not exercise verify steps, plain "
                             "steps and the draft's prefix-row reuse")
    full = [t["wall_ms"] for t in step_times
            if t["stage"] == "cloud_verify_rows"
            and t["live"] == INFLIGHT_SLOTS]
    out["run_a"]["stage_walls"] = step_times
    out["run_a"]["verify_wall_ms_full"] = float(np.median(full)) \
        if full else None
    log(f"[spec] cloud_verify_rows wall with {INFLIGHT_SLOTS} live rows: "
        f"median {out['run_a']['verify_wall_ms_full']} ms over {len(full)} "
        f"steps; all stage calls "
        f"{[(t['stage'][6:12], t['live'], round(t['wall_ms'], 1)) for t in step_times]}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    other = vlm.init_lisa(pcfg, gen, dev)
    draft = {"llm": other["llm"], "seg_proj": other["seg_proj"]}
    del other
    spec_b = SpeculativeConfig(draft_tokens=4, draft_params=draft)
    res_b, dec_b, out["run_b"] = spec_run(sx, pcfg, frames, spec_b,
                                          "run B (divergent draft, k=4)")
    st = dec_b.spec_stats
    if not (st.acceptance_rate < 1.0 and st.pages_rolled_back > 0):
        raise AssertionError(f"run B shows no rejection and rollback: "
                             f"{st.as_dict()}")
    del dec_b, spec_b, draft
    torch.cuda.empty_cache()

    plain, _, _ = serve_spec(sx, frames, None)
    oracle = []
    for (_, kind, f, _), r in zip(_spec_submissions(frames), res_a):
        _, pkt, query = frames[f]
        o = sx.cloud_generate_batch([pkt], [query])[0]
        oracle.append({"seq_id": r["seq_id"], "tokens": o[-1],
                       "answer_logits": o[-2],
                       "mask_logits": o[0] if kind == "insight" else None})
    for label, res in (("run A", res_a), ("run B", res_b)):
        out[label.replace(" ", "_").lower()]["rel_err_spec_none"] = \
            compare_inflight(res, plain, {"answer_logits": 0.0,
                                          "mask_logits": SDPA_PATH_RTOL},
                             f"spec=None decoder ({label})", tag="spec")
        out[label.replace(" ", "_").lower()]["rel_err_generate_batch"] = \
            compare_inflight(res, oracle,
                             {"answer_logits": SDPA_PATH_RTOL,
                              "mask_logits": SDPA_PATH_RTOL},
                             f"one-shot cloud_generate_batch ({label})",
                             tag="spec")
    out["parity"] = spec_parity(
        sx, frames, spec_a, res_a,
        out["run_a"]["launches"]["paged_verify_attention"])
    out["timings"] = spec_timings(sx, frames, spec_a)
    return out


# ---------------------------------------------------------------------------
# phase 10 (split): the LLM prefill through flash_attention (llm.use_flash)
# and the Insight split point through the bottleneck kernels (use_kernel)
# ---------------------------------------------------------------------------


def _flash_plain(q, k, v, causal=True, block_q=128, block_k=128):
    from repro_torch.kernels.flash_attention import ref
    return ref.attention_ref(q, k, v, causal=causal)


def _layer_kind(kind):
    """What ``layer_check`` wraps for one kind of layer: the stack's block
    bodies (dense and moe), the attention function whose output is h, the
    group pass that starts a new prefill or step, the kernel wrapper's
    module and name, its plain version, and the word for one group
    pass."""
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.kernels.flash_attention import ops as fops
    return {
        "flash": (("_dense_block_full", "_moe_block_full"), "attn_full",
                  "group_forward", fops, "flash_attention", _flash_plain,
                  "prefill"),
        "decode": (("_dense_block_decode", "_moe_block_decode"),
                   "attn_decode", "group_decode", ops, "decode_attention",
                   ref.decode_attention_ref, "step"),
        "paged": (("_dense_block_decode_paged", "_moe_block_decode_paged"),
                  "attn_decode_paged", "group_decode_paged", ops,
                  "paged_decode_attention", ref.paged_decode_attention_ref,
                  "step"),
        "verify": (("_dense_block_decode_paged", "_moe_block_decode_paged"),
                   "attn_verify_paged", "group_verify_paged", ops,
                   "paged_verify_attention", ref.paged_verify_attention_ref,
                   "step"),
    }[kind]


def _route_sets(gate_idx):
    """Each token's top-k set, as its sorted expert indices (T, k)."""
    return gate_idx.sort(dim=-1).values


def route_flips(a, b):
    """Two runs' routing of the same tokens, each (gate_idx (T, k), router
    logits (T, E) in float32): the tokens whose top-k sets agree, and the
    routing flips, the tokens whose top-k set differs, each with the
    largest difference of its router logits between the runs (what moved
    it across its k-th / (k+1)-th boundary) and its boundary gaps (k-th
    minus (k+1)-th logit) in each run."""
    (ia, la), (ib, lb) = a[:2], b[:2]
    agree = (_route_sets(ia) == _route_sets(ib)).all(dim=-1)
    flips = (~agree).nonzero().flatten()
    k = ia.shape[-1]
    out = []
    for t in flips.tolist():
        gaps = [float(l[t].topk(k + 1).values[k - 1]
                      - l[t].topk(k + 1).values[k]) for l in (la, lb)]
        out.append({"token": t,
                    "logit_diff": float((la[t] - lb[t]).abs().max()),
                    "gaps": gaps})
    return agree, out


def _recording_router(record):
    """A stand-in for ``moe._router`` that appends (gate_idx, router logits
    as a full float32 product) of each call to ``record``."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.common import full_fp32
    router = moe_lib._router

    def routed(p, cfg, xt):
        out = router(p, cfg, xt)
        with full_fp32(xt):
            logits = xt.float() @ p["router"].float()
        record.append((out[1], logits))
        return out
    return routed


def _pinned_router(routes, record):
    """A stand-in for ``moe._router`` whose i-th call routes as the i-th
    entry of ``routes`` (gate_idx, router logits, ...) did: those top-k
    experts with those gate values (from the recorded logits, normalised
    as the router does). Each call appends this run's own choice (as
    ``_recording_router`` records it) to ``record``."""
    router, it = _recording_router(record), iter(routes)

    def pinned(p, cfg, xt):
        _, _, _, aux = router(p, cfg, xt)
        gate_idx, logits = next(it)[:2]
        gate = torch.softmax(logits, dim=-1).gather(1, gate_idx)
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
        return gate, gate_idx, torch.nn.functional.one_hot(
            gate_idx, cfg.moe.num_experts).float(), aux
    return pinned


def layer_check(kind, label, run, kernel=None):
    """Run ``run()`` with a kernel's plain version in the kernel's place,
    so that it follows the plain trajectory, and hold every layer of
    ``kind`` that reaches the kernel: on the layer's input as the plain run
    has it, the layer computed with ``kernel`` (default: the kernel's
    wrapper) against the layer computed with the plain version, in the
    same weights and dtype. Kinds: "flash" (prefill layers,
    ``_dense_block_full`` / ``_moe_block_full`` through ``attn_full``,
    each ``group_forward`` pass a prefill), "decode"
    (``_dense_block_decode`` / ``_moe_block_decode`` through
    ``attn_decode`` with ``decode_attention``, each ``group_decode`` pass a
    step), "paged" (``_dense_block_decode_paged`` /
    ``_moe_block_decode_paged`` through ``attn_decode_paged`` with
    ``paged_decode_attention``, each ``group_decode_paged`` pass a step;
    the same blocks' verify layers, whose ``attn_fn`` is
    ``attn_verify_paged``, pass through unchecked) and "verify" (the same
    blocks' verify layers, exactly those called with ``attn_fn=
    attn_verify_paged``, with ``paged_verify_attention``, each
    ``group_verify_paged`` pass a step; the plain paged decode layers,
    which pass no ``attn_fn``, pass through unchecked).

    Two norm-wise relative errors a layer, each within LAYER_RTOL: the
    attention block's output h (before the residual add, so a small
    attention term cannot hide behind a large residual) and the layer's
    output. In a moe layer the two runs' router inputs differ by the
    attention's rounding, so a token near a tie of its k-th and (k+1)-th
    expert may choose another top-k set (a routing flip, which would also
    move other tokens across an expert's capacity), and every gate moves
    with its logits, which the random experts' large outputs carry into
    the layer output: the kernel's run of a moe layer therefore routes as
    the plain run did (its experts and gates, ``_pinned_router``), and the
    routing is held apart: each token whose own top-k set would differ
    (``route_flips``) must have router logits within ROUTE_TIE_LOGITS of
    the plain run's. The plain output
    goes on, so no error carries from one layer to the next. The decode
    kinds write the new token's k/v into the cache or pool in place before
    attending; the second run of a layer computes the same k/v from the
    same input and writes the same values to the same slots. That holds
    for the paged kinds too, whose pad and idle entries all target the
    shared trash page, several to one slot, which an idle row attends: the
    pool write gives every entry of a slot the row of the last entry for it
    (``attention.write_pool``), so however the card orders the duplicates,
    both runs leave the same values there. Raises naming the first
    (prefill or step, layer) past a limit. Returns (what ``run`` returns,
    which is the plain replay's result, and a summary). Kind "split" is
    the split point's check (``split_layer_check``; ``kernel`` an (encode,
    decode) pair)."""
    if kind == "split":
        return split_layer_check(label, run, kernel)
    from repro_torch.models import attention, stack
    from repro_torch.models import moe as moe_lib
    block_names, attn_name, group_name, mod, name, plain_fn, unit = \
        _layer_kind(kind)
    kernel = getattr(mod, name) if kernel is None else kernel
    attn_fn = getattr(attention, attn_name)
    group = getattr(stack, group_name)
    # the paged block's attn_fn: the "paged" kind checks the calls that
    # pass none (its default), the "verify" kind those that pass attn_fn
    unset = None if kind == "verify" else attn_fn
    passes = []                 # one list of layer readings a group pass

    def grouped(*a, **kw):
        passes.append([])
        return group(*a, **kw)

    def layer(block, fn, pin, *a, **kw):
        seen = {"kernel": 0, "route": []}

        def counted(*x, **y):
            seen["kernel"] += 1
            return fn(*x, **y)

        def attn(*x, **y):
            seen["h"], rest = attn_fn(*x, **y)
            return seen["h"], rest

        if kind in ("paged", "verify"):   # the block and the group pass
            kw = dict(kw, attn_fn=attn)     # bind attn_fn before this call
        with mock.patch.object(mod, name, counted), \
                mock.patch.object(attention, attn_name, attn), \
                mock.patch.object(moe_lib, "_router",
                                  _recording_router(seen["route"])
                                  if pin is None else
                                  _pinned_router(pin, seen["route"])):
            y, *rest = block(*a, **kw)
        return seen, y, rest

    def checker(block):
        def checked(*a, **kw):
            if kw.get("attn_fn", unset) is not attn_fn:
                return block(*a, **kw)  # a layer of the other paged kind
            plain, y, rest = layer(block, plain_fn, None, *a, **kw)
            if plain["kernel"]:
                # a moe layer's kernel run routes as the plain run did
                got, y_k, _ = layer(block, kernel, plain["route"], *a, **kw)
                r = {"h": _rel(got["h"], plain["h"]), "out": _rel(y_k, y),
                     "bit_equal": bool(torch.equal(y_k, y)), "flips": []}
                if plain["route"]:
                    _, r["flips"] = route_flips(plain["route"][0],
                                                got["route"][0])
                passes[-1].append(r)
            return (y, *rest)
        return checked

    with contextlib.ExitStack() as patches:
        for bn in block_names:
            patches.enter_context(mock.patch.object(
                stack, bn, checker(getattr(stack, bn))))
        patches.enter_context(mock.patch.object(stack, group_name, grouped))
        result = run()
    passes = [p for p in passes if p]   # e.g. the encoders take no flash
    layers = [(i, j, r) for i, p in enumerate(passes)
              for j, r in enumerate(p)]
    if not layers:
        raise AssertionError(f"{label}: no layer reached {name}")
    i, j, r = max(layers, key=lambda t: max(t[2]["h"], t[2]["out"]))
    per_pass = [max(max(r["h"], r["out"]) for r in p) for p in passes]
    off = sum(not r["bit_equal"] for _, _, r in layers)
    flips = [(i, j, f) for i, j, r in layers for f in r["flips"]]
    summary = {"layers": len(layers), f"{unit}s": len(passes),
               "worst": {unit: i, "layer": j, "h": r["h"], "out": r["out"]},
               f"per_{unit}_max": per_pass,
               "outputs_not_bit_equal": off, "limit": LAYER_RTOL,
               "route_flips": [{unit: i, "layer": j, **f}
                               for i, j, f in flips],
               "route_tie_limit": ROUTE_TIE_LOGITS}
    log(f"[layers] {label}: {len(layers)} layers in {len(passes)} {unit}s, "
        f"each against the plain version on its own input; worst {unit} "
        f"{i} layer {j}: attention h {r['h']:.3g}, layer output "
        f"{r['out']:.3g} (limit {LAYER_RTOL}); per-{unit} max "
        + ", ".join(f"{m:.3g}" for m in per_pass)
        + f"; {off} of {len(layers)} layer outputs not bit-equal")
    if flips:
        worst_flip = max(f["logit_diff"] for _, _, f in flips)
        log(f"[layers] {label}: {len(flips)} routing flips (a token's own "
            f"top-k set in the kernel's layer differs from the plain "
            f"version's, whose routing that layer takes); largest "
            f"router-logit difference of a flipped token {worst_flip:.3g} "
            f"(limit {ROUTE_TIE_LOGITS}); boundary gaps "
            + ", ".join(f"{min(f['gaps']):.3g}" for _, _, f in flips[:8]))
    bad = [(i, j, r) for i, j, r in layers
           if not max(r["h"], r["out"]) <= LAYER_RTOL
           or any(not f["logit_diff"] <= ROUTE_TIE_LOGITS
                  for f in r["flips"])]
    if bad:
        i, j, r = bad[0]
        raise AssertionError(
            f"{label}: {unit} {i} layer {j} with the {name} kernel is off "
            f"the plain version's on the same input: attention h by "
            f"{r['h']:.3g}, layer output by {r['out']:.3g} (norm-wise), "
            f"limit {LAYER_RTOL}; routing flips {r['flips'][:4]} (router "
            f"logits limit {ROUTE_TIE_LOGITS}); {len(bad)} layers past it")
    return result, summary


def flash_layer_check(label, run, kernel=None):
    """``layer_check`` of the dense prefill layers with the flash kernel."""
    return layer_check("flash", label, run, kernel)


def _plain_encode(x, w):
    """The bottleneck encode kernel's plain version, in the wrapper's
    shapes."""
    from repro_torch.kernels.bottleneck import ref
    r = w.shape[1]
    c, sc = ref.encode_ref(x.reshape(-1, x.shape[-1]), w)
    return c.reshape(*x.shape[:-1], r), sc.reshape(*x.shape[:-1], 1)


def _plain_decode(codes, scales, w, out_dtype=torch.float32):
    """The bottleneck decode kernel's plain version, in the wrapper's
    shapes."""
    from repro_torch.kernels.bottleneck import ref
    r, d = w.shape
    return ref.decode_ref(codes.reshape(-1, r), scales.reshape(-1, 1), w,
                          out_dtype).reshape(*codes.shape[:-1], d)


def split_layer_check(label, run, kernels=None):
    """``layer_check`` of the split point (kind "split"): run ``run()`` with
    the bottleneck pair's plain versions in the kernels' place, and at
    every frame, on the SAM-head output as the plain run has it, hold the
    boundary activation the kernels reconstruct (``kernels``, an (encode,
    decode) pair, default the two wrappers: decode of encode's codes and
    scales) against the plain pair's, and the first SAM-tail block on
    each, each as a norm-wise relative error within LAYER_RTOL. Counts the
    codes that are off the plain version's and by how much. The plain
    activation goes on. Raises naming the first frame past the limit.
    Returns (what ``run`` returns, a summary)."""
    from repro_torch.core import vlm
    from repro_torch.kernels.bottleneck import ops as bops
    enc_k, dec_k = kernels or (bops.bottleneck_encode,
                               bops.bottleneck_decode)
    frames = []
    tail = vlm.sam_tail

    def encode(x, w):
        codes, scales = _plain_encode(x, w)
        k_codes, k_scales = enc_k(x, w)
        diff = (k_codes.int() - codes.int()).abs()
        frames.append({"rank": int(w.shape[1]), "codes": codes.numel(),
                       "codes_off": int((diff > 0).sum()),
                       "codes_max_diff": int(diff.max()),
                       "scales": _rel(k_scales, scales),
                       "pair": (k_codes, k_scales)})
        return codes, scales

    def decode(codes, scales, w, out_dtype=torch.float32):
        a = _plain_decode(codes, scales, w, out_dtype)
        f = frames[-1]
        f["a"] = dec_k(*f.pop("pair"), w, out_dtype)
        f["boundary"] = _rel(f["a"], a)
        return a

    def sam_tail(params, pcfg, x, split_k=None):
        k = pcfg.split_layer if split_k is None else split_k
        f, groups = frames[-1], params["sam"]["groups"]
        f["block"] = _rel(
            vlm._encoder_blocks(groups, pcfg.sam, f.pop("a"), k, k + 1),
            vlm._encoder_blocks(groups, pcfg.sam, x, k, k + 1))
        return tail(params, pcfg, x, split_k)

    with mock.patch.object(bops, "bottleneck_encode", encode), \
            mock.patch.object(bops, "bottleneck_decode", decode), \
            mock.patch.object(vlm, "sam_tail", sam_tail):
        result = run()
    if not frames or any("block" not in f for f in frames):
        raise AssertionError(f"{label}: {len(frames)} frames reached the "
                             f"split point, or a frame skipped its tail")
    i, worst = max(enumerate(frames),
                   key=lambda t: max(t[1]["boundary"], t[1]["block"]))
    summary = {"frames": [{k: f[k] for k in ("rank", "boundary", "block",
                                             "codes", "codes_off",
                                             "codes_max_diff", "scales")}
                          for f in frames],
               "worst": {"frame": i, "boundary": worst["boundary"],
                         "block": worst["block"]},
               "limit": LAYER_RTOL}
    log(f"[layers] {label}: {len(frames)} frames, the bottleneck pair "
        f"against its plain version on each frame's SAM-head output; worst "
        f"frame {i} (rank {worst['rank']}): boundary activation "
        f"{worst['boundary']:.3g}, first SAM-tail block "
        f"{worst['block']:.3g} (limit {LAYER_RTOL}); per frame (rank: "
        f"boundary, block, codes off / codes, max off, scales) "
        + "; ".join(f"{f['rank']}: {f['boundary']:.3g}, {f['block']:.3g}, "
                    f"{f['codes_off']} / {f['codes']}, "
                    f"{f['codes_max_diff']}, {f['scales']:.3g}"
                    for f in frames))
    bad = [(j, f) for j, f in enumerate(frames)
           if not max(f["boundary"], f["block"]) <= LAYER_RTOL]
    if bad:
        j, f = bad[0]
        raise AssertionError(
            f"{label}: frame {j} (rank {f['rank']}) with the bottleneck "
            f"kernels is off the plain pair's on the same input: boundary "
            f"activation by {f['boundary']:.3g}, first SAM-tail block by "
            f"{f['block']:.3g} (norm-wise), limit {LAYER_RTOL}; {len(bad)} "
            f"frames past it")
    return result, summary


def split_microbatch(fx, reqs, base_results):
    """10a: phase 5's requests through MicrobatchScheduler(generate=True)
    on the use_flash executor, counters from 0: one flash launch per layer
    and microbatch (the prefill of each cloud_*_gen call), the decode
    steps' launches as in phase 5. Tokens equal to phase 5's, logits and
    masks within SDPA_PATH_RTOL of it (its _sdpa rounds P to bf16, the
    kernel does not); a replay with the flash kernel's plain version in
    its place, every prefill layer held against the kernel on its own
    input (flash_layer_check, LAYER_RTOL), the outputs within
    SDPA_PATH_RTOL."""
    L = fx.pcfg.llm.num_layers
    _reset_launch_counts()
    t0 = _sync_s()
    results, sched = serve_requests(fx, reqs)
    wall = _sync_s() - t0
    launches = _launch_counts()
    n = sched.n_microbatches
    expect = _only(flash_attention=n * L,
                   decode_attention=n * MAX_NEW_TOKENS * L)
    log(f"[split] microbatch: {len(results)} requests in {n} microbatches, "
        f"wall {wall:.2f} s; launches {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"use_flash microbatch launches {launches}, "
                             f"expected {expect}")
    out = {"wall_s": wall, "microbatches": n, "launches": launches,
           "expected_launches": expect}
    out["rel_err_use_flash_false"] = compare_paths(
        results, base_results, SDPA_PATH_RTOL,
        "use_flash=False path (phase 5)")
    (plain, _), out["layers"] = flash_layer_check(
        "10a microbatch", lambda: serve_requests(fx, reqs))
    if out["layers"]["layers"] != n * L:
        raise AssertionError(f"checked {out['layers']['layers']} prefill "
                             f"layers, expected {n * L}")
    out["rel_err_plain_kernel"] = compare_paths(
        results, plain, SDPA_PATH_RTOL, "path with the flash kernel's plain "
        "version")
    return out


def split_inflight(fx, frames, base_results, base_paged):
    """10b: phase 8's schedule through InflightDecoder(slots=4) on the
    use_flash executor, counters from 0: one flash launch per layer and
    prefix miss (cloud_prefix), the paged launches of phase 8. Tokens
    equal to phase 8's, logits and masks within SDPA_PATH_RTOL."""
    L = fx.pcfg.llm.num_layers
    _reset_launch_counts()
    t0 = _sync_s()
    results, dec = serve_inflight(fx, frames)
    wall = _sync_s() - t0
    launches = _launch_counts()
    misses = sum(not r["prefix_hit"] for r in results)
    expect = _only(flash_attention=misses * L,
                   paged_decode_attention=dec.n_steps * L)
    log(f"[split] in-flight: {len(results)} requests, {misses} prefix "
        f"misses, {dec.n_steps} decode steps, wall {wall:.2f} s; launches "
        f"{launches} (expected {expect}; phase 8 paged {base_paged})")
    if launches != expect or dec.n_steps * L != base_paged:
        raise AssertionError(f"use_flash in-flight launches {launches}, "
                             f"expected {expect} with {base_paged} paged")
    rel = compare_inflight(results, base_results,
                           {"answer_logits": SDPA_PATH_RTOL,
                            "mask_logits": SDPA_PATH_RTOL},
                           "use_flash=False in-flight run (phase 8)",
                           tag="split")
    return {"wall_s": wall, "prefix_misses": misses, "n_steps": dec.n_steps,
            "launches": launches, "expected_launches": expect,
            "rel_err_use_flash_false": rel}


def split_frames(fx, pcfg, seed):
    """One Insight frame per tier: a seeded image and query, and its CLIP
    features (the edge's Context pass, which the packet carries)."""
    from repro_torch.core import vlm
    rng = np.random.RandomState(seed + 2)
    frames = []
    for tier in fx.lut.tiers:
        img = torch.from_numpy(rng.rand(1, pcfg.image_size, pcfg.image_size,
                                        3).astype(np.float32)).to(fx.device)
        query = torch.from_numpy(rng.randint(
            0, pcfg.llm.vocab_size, (1, QUERY_LEN)).astype(np.int32)
        ).to(fx.device)
        with torch.inference_mode():
            ctx = vlm.clip_encode(fx.params, pcfg, img)
        frames.append((tier, img, query, ctx))
    return frames


@torch.inference_mode()
def split_point(fx, frame, i):
    """One Insight frame through the reference's edge_insight and
    cloud_insight_gen stage bodies with both switches on: SAM head,
    bn.encode(use_kernel=True), the packet, bn.decode(use_kernel=True),
    SAM tail, llm_generate on the use_flash config, mask decode. Returns
    (mask_logits, answer_logits, tokens) as numpy, and the packet."""
    from repro_torch.core import bottleneck as bn
    from repro_torch.core import packets as pk
    from repro_torch.core import vlm
    from repro_torch.core.streams import host
    tier, img, query, ctx = frame
    pcfg, p, bp = fx.pcfg, fx.params, fx.bottlenecks[tier.name]
    a = vlm.sam_head(p, pcfg, img)
    codes, scales = bn.encode(bp, a, use_kernel=True)
    pkt = pk.make_insight_packet(i, 0.0, tier.name, host(codes),
                                 host(scales), clip_feats=host(ctx))
    a = bn.decode(bp, fx._dev(pkt.content["codes"]),
                  fx._dev(pkt.content["scales"]), out_dtype=pcfg.sam.adtype,
                  use_kernel=True)
    feats = vlm.sam_tail(p, pcfg, a)
    tokens, logits0, seg = vlm.llm_generate(p, fx._gen_pcfg, ctx, query,
                                            MAX_NEW_TOKENS)
    mask = vlm.mask_decode(p, pcfg, feats, seg)
    return (host(mask), host(logits0), host(tokens)), pkt


def _split_run(fx, frames):
    return [split_point(fx, f, i)[0] for i, f in enumerate(frames)]


def split_point_phase(fx, pcfg, seed):
    """10c: one frame per tier through the split point with both switches
    on, counters from 0: exactly one encode and one decode launch per
    frame, one flash launch per layer and frame. Then (a) a replay with
    every launch of the three kernels held against its plain version on
    that launch's own inputs (outputs bit-equal to the counted run's);
    (b) a replay with flash's plain version in its place, every prefill
    layer also computed with the kernel on the same input and held to
    LAYER_RTOL (flash_layer_check), its tokens equal and mask logits within
    SDPA_PATH_RTOL of the counted run's, and (c) one with the bottleneck
    pair's plain versions in theirs, every frame's split point also
    computed with the kernels on the same input and held to LAYER_RTOL
    (``layer_check`` kind "split"): tokens equal, mask logits within
    PATH_RTOL, each reading on its own. Times one frame's edge encode and
    cloud decode."""
    from repro_torch.core import bottleneck as bn
    from repro_torch.core import vlm
    from repro_torch.kernels.bottleneck import ops as bops
    from repro_torch.kernels.bottleneck import ref as bref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    L = pcfg.llm.num_layers
    frames = split_frames(fx, pcfg, seed)
    n = len(frames)
    _reset_launch_counts()
    t0 = _sync_s()
    outs = _split_run(fx, frames)
    wall = _sync_s() - t0
    launches = _launch_counts()
    expect = _only(bottleneck_encode=n, bottleneck_decode=n,
                   flash_attention=n * L,
                   decode_attention=n * MAX_NEW_TOKENS * L)
    log(f"[split] split point: {n} Insight frames (ranks "
        f"{[fx.bottlenecks[f[0].name]['enc'].shape[1] for f in frames]}), "
        f"wall {wall:.2f} s; launches {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"split-point launches {launches}, expected "
                             f"{expect}")
    g = pcfg.image_size // pcfg.patch_size \
        * int(round(max(1, pcfg.mask_pixels_per_patch) ** 0.5))
    for i, (mask, logits, tokens) in enumerate(outs):
        if (mask.shape != (1, g, g)
                or logits.shape != (1, pcfg.llm.vocab_size)
                or tokens.shape != (1, MAX_NEW_TOKENS)):
            raise AssertionError(f"split frame {i}: bad output shapes")
        if not all(np.isfinite(a).all() for a in (mask, logits)):
            raise AssertionError(f"split frame {i}: non-finite output")
    out = {"wall_s": wall, "launches": launches, "expected_launches": expect,
           "tokens": [o[2].tolist()[0] for o in outs]}

    # (a) every launch against its plain version on its own inputs
    errs = {"flash_attention": [], "bottleneck_encode": [],
            "bottleneck_decode": []}
    # output elements not bit-equal to the plain version's, and elements
    not_equal = {k: [0, 0] for k in errs}
    enc, dec, fl = (bops.bottleneck_encode, bops.bottleneck_decode,
                    fops.flash_attention)

    def count(name, out, want):
        not_equal[name][0] += int((out != want).sum())
        not_equal[name][1] += out.numel()

    def enc_checked(x, w):
        codes, scales = enc(x, w)
        r = w.shape[1]
        want_c, want_s = bref.encode_ref(x.reshape(-1, x.shape[-1]), w)
        errs["bottleneck_encode"].append(codes_held_against(
            "bottleneck_encode on the split point's inputs",
            codes.reshape(-1, r), scales.reshape(-1, 1), want_c, want_s))
        count("bottleneck_encode", codes.reshape(-1, r), want_c)
        return codes, scales

    def dec_checked(codes, scales, w, out_dtype=torch.float32):
        y = dec(codes, scales, w, out_dtype)
        d, r = w.shape[1], w.shape[0]
        want = bref.decode_ref(codes.reshape(-1, r), scales.reshape(-1, 1),
                               w, out_dtype)
        errs["bottleneck_decode"].append(held_against(
            "bottleneck_decode on the split point's inputs",
            y.reshape(-1, d), want, DECODE_TOL[out_dtype]))
        count("bottleneck_decode", y.reshape(-1, d), want)
        return y

    def flash_checked(q, k, v, causal=True, block_q=128, block_k=128):
        o = fl(q, k, v, causal=causal)
        want = fref.attention_ref(q, k, v, causal=causal)
        errs["flash_attention"].append(held_against(
            "flash_attention on the split point's inputs", o, want))
        count("flash_attention", o, want)
        return o

    with mock.patch.object(bops, "bottleneck_encode", enc_checked), \
            mock.patch.object(bops, "bottleneck_decode", dec_checked), \
            mock.patch.object(fops, "flash_attention", flash_checked):
        checked = _split_run(fx, frames)
    if [len(v) for v in errs.values()] != [n * L, n, n]:
        raise AssertionError(f"held {[len(v) for v in errs.values()]} "
                             f"launches against their plain versions, "
                             f"expected {[n * L, n, n]}")
    for a, b in zip(outs, checked):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError("the checked replay's outputs differ from "
                                 "the counted run's")
    enc_worst = max(e[1] for e in errs["bottleneck_encode"])
    log(f"[split] every launch on its own inputs agrees with its plain "
        f"version: flash {len(errs['flash_attention'])} launches, max abs "
        f"err {max(errs['flash_attention']):.3g}; encode {n}: codes off by "
        f"<= {max(e[0] for e in errs['bottleneck_encode'])} on <= "
        f"{enc_worst:.3g} of entries, scales max abs err "
        f"{max(e[2] for e in errs['bottleneck_encode']):.3g}; decode {n}: "
        f"max abs err {max(errs['bottleneck_decode']):.3g}; output elements "
        f"not bit-equal: " + ", ".join(f"{k} {a} of {b}" for k, (a, b) in
                                       not_equal.items()))
    out["launches_checked"] = {k: len(v) for k, v in errs.items()}
    out["elements_not_bit_equal"] = not_equal
    out["max_abs_err"] = {
        "flash_attention": max(errs["flash_attention"]),
        "bottleneck_encode": max(e[0] for e in errs["bottleneck_encode"]),
        "bottleneck_decode": max(errs["bottleneck_decode"])}
    out["encode_codes_off_frac"] = enc_worst
    out["encode_scales_max_abs_err"] = max(
        e[2] for e in errs["bottleneck_encode"])

    # (b), (c): each kernel kind's plain version in its place, on its own,
    # each with its per-layer check
    flash_plain, out["layers"] = flash_layer_check(
        "10c split point", lambda: _split_run(fx, frames))
    if out["layers"]["layers"] != n * L:
        raise AssertionError(f"checked {out['layers']['layers']} prefill "
                             f"layers, expected {n * L}")
    bn_plain, out["split_layers"] = layer_check(
        "split", "10c split point", lambda: _split_run(fx, frames))
    if len(out["split_layers"]["frames"]) != n:
        raise AssertionError(f"checked {len(out['split_layers']['frames'])}"
                             f" frames at the split point, expected {n}")
    failed = []
    for label, other, limit in (
            ("flash_attention", flash_plain, SDPA_PATH_RTOL),
            ("bottleneck pair", bn_plain, PATH_RTOL)):
        per_frame = [{"mask_logits": _rel(a[0], b[0]),
                      "answer_logits": _rel(a[1], b[1]),
                      "tokens_equal": bool(np.array_equal(a[2], b[2]))}
                     for a, b in zip(outs, other)]
        worst = max(f["mask_logits"] for f in per_frame)
        out[f"rel_err_plain_{label.replace(' ', '_')}"] = per_frame
        log(f"[split] plain {label} in its place: mask_logits norm-wise "
            f"relative error {worst:.3g} (limit {limit}); per frame "
            + ", ".join(f"{f['mask_logits']:.3g}" for f in per_frame)
            + "; answer_logits per frame "
            + ", ".join(f"{f['answer_logits']:.3g}" for f in per_frame)
            + f"; tokens equal {[f['tokens_equal'] for f in per_frame]}")
        if not (worst <= limit and all(f["tokens_equal"]
                                           for f in per_frame)):
            failed.append(f"{label}: mask_logits off by {worst:.3g} (limit "
                          f"{limit}) or tokens differ")
    if failed:
        raise AssertionError(f"split point against each kernel kind's plain "
                             f"version: {failed}")

    # one frame's edge encode and cloud decode, warm, host wall to a sync
    tier, img, _, _ = frames[0]
    bp = fx.bottlenecks[tier.name]
    with torch.inference_mode():
        a = vlm.sam_head(fx.params, pcfg, img)
        times = {}
        for _ in range(2):
            t0 = _sync_s()
            codes, scales = bn.encode(bp, a, use_kernel=True)
            times["encode_ms"] = (_sync_s() - t0) * 1e3
            t0 = _sync_s()
            bn.decode(bp, codes, scales, out_dtype=pcfg.sam.adtype,
                      use_kernel=True)
            times["decode_ms"] = (_sync_s() - t0) * 1e3
    out["frame_wall_ms"] = dict(times, rank=int(bp["enc"].shape[1]))
    log(f"[split] one frame at rank {bp['enc'].shape[1]}, warm: edge encode "
        f"{times['encode_ms']:.3f} ms, cloud decode {times['decode_ms']:.3f} "
        f"ms (host wall to a synchronise)")
    return out


def split_phase(executor, pcfg, seed, reqs, results, frames,
                inflight_results, inflight_paged):
    """Phase 10: LISA-7B at full width on an executor with
    ``llm.use_flash=True`` that shares the serving executor's weight
    tensors: 10a microbatch, 10b in-flight, 10c split point."""
    from repro_torch.core.streams import DualStreamExecutor
    fcfg = dataclasses.replace(pcfg, llm=pcfg.llm.replace(use_flash=True))
    fx = DualStreamExecutor(pcfg=fcfg, params=executor.params,
                            bottlenecks=executor.bottlenecks,
                            lut=executor.lut, max_new_tokens=MAX_NEW_TOKENS,
                            flash_decode=True, device=executor.device)
    if fx.params["llm"]["embed"] is not executor.params["llm"]["embed"]:
        raise AssertionError("the use_flash executor copied the weights")
    return {"microbatch": split_microbatch(fx, reqs, results),
            "inflight": split_inflight(fx, frames, inflight_results,
                                       inflight_paged),
            "split_point": split_point_phase(fx, fcfg, seed)}


# ---------------------------------------------------------------------------
# phase 12 (engine): the AveryEngine front door
# ---------------------------------------------------------------------------

# six frames from two operators through OperatorSession.submit: (operator,
# prompt, mission time). Each prompt classifies as Context or Insight
# (core/intent.py), so both edge stages run on the card.
ENGINE_FRAMES = (
    ("uav-A", "segment the stranded person on the roof", 0.0),
    ("uav-B", "how many boats are there", 0.4),
    ("uav-A", "describe the flooded area", 0.8),
    ("uav-B", "outline the collapsed bridge", 1.2),
    ("uav-A", "is there anyone on the road", 1.6),
    ("uav-B", "highlight the rescue boat", 2.0),
)
# 12b: after one pump, uav-A sends frame 0 again (it joins the running
# batch and hits the prefix store)
ENGINE_REPEAT_T = 2.4
# 12d: a blackout window over frame 0's send, and a decode fault on the
# second cloud_decode_rows call, when both of two rows are live
FAULT_BLACKOUT = ((0.0, 0.3),)
FAULT_DECODE_CALL = 1
# the counters the two fault runs must end with. They are structural: the
# blackout catches only sends that start in its window, and only frame 0
# is sent there (the others start at 0.4 s or later, the retry after a
# 0.5 s backoff); the stage fault is at a decode call's index. Neither
# depends on a packet's size or the trace's rates, so they hold for
# LISA-7B's packets on any paper_trace seed. The CPU tests get the same
# from the reference's engine on lisa_mini (tests/test_torch_engine.py)
FAULT_COUNTERS = {
    "blackout": {"retries": 1, "downshifts": 1, "blackouts": 0,
                 "cloud_errors": 0, "stage_faults": 0},
    "stage": {"retries": 2, "downshifts": 0, "blackouts": 0,
              "cloud_errors": 0, "stage_faults": 1},
}
# timing: engine pumps on four live rows, each timed whole and around the
# bare decoder step it makes, on an executor with enough new tokens to
# keep the rows live through every turn
TIMING_TURNS = 24
TIMING_TOKENS = TIMING_TURNS + 2 * INFLIGHT_SLOTS
# the host cost a step counts as resolved when its quartiles lie within
# this many ms of its median
TIMING_RESOLVE_MS = 0.5
# 12c: a near tie may move a request's tokens off speculative=None's only
# where the two tokens' logits move by at most TIE_ULPS bf16 steps at
# their magnitude between the runs, and at most MAX_TIES requests may
# (2 of 7 measured on the H100: 0 to 2 bf16 steps at the two tokens)
TIE_ULPS = 4
MAX_TIES = 2


def engine_frames(pcfg, seed):
    """Seeded images and queries for ENGINE_FRAMES: [(images, query)]."""
    rng = np.random.RandomState(seed + 12)
    return [(rng.rand(1, pcfg.image_size, pcfg.image_size,
                      3).astype(np.float32),
             rng.randint(0, pcfg.llm.vocab_size,
                         (1, QUERY_LEN)).astype(np.int32))
            for _ in ENGINE_FRAMES]


def submit_frames(engine, frames, which, sessions=None):
    """Submit ENGINE_FRAMES[i] for i in ``which`` through each operator's
    session (made on first use). Returns (futures, sessions)."""
    sessions = {} if sessions is None else sessions
    futs = []
    for i in which:
        op, prompt, t = ENGINE_FRAMES[i]
        sess = sessions.get(op) or sessions.setdefault(op,
                                                       engine.session(op))
        images, query = frames[i]
        futs.append(sess.submit(prompt=prompt, images=images, query=query,
                                time_s=t))
    return futs, sessions


def delivered_packets(transport):
    """{request id: the packet of its last delivered TransmitRecord}."""
    return {r.packet.seq_id: r.packet for r in transport.records
            if r.delivered}


def _engine_sessions(engine):
    """uav-A with the default goal (accuracy), uav-B prioritising
    throughput: the two select different Insight tiers."""
    from repro_torch.core.controller import MissionGoal
    return {"uav-A": engine.session("uav-A"),
            "uav-B": engine.session(
                "uav-B", goal=MissionGoal.PRIORITIZE_THROUGHPUT)}


def fault_counters(stats):
    return {k: stats[k] for k in FAULT_COUNTERS["stage"]}


def fault_blackout_run(eng, executor, frames, trace):
    """12d, blackout: four frames through a FaultInjector over a
    ChannelTransport on ``trace`` whose blackout window covers frame 0's
    send, with a RetryPolicy, in flight on 4 slots. ``eng`` is the engine
    package (the port's here; the CPU tests also pass the reference's).
    Returns (engine, responses)."""
    engine = eng.AveryEngine(
        lut=executor.lut, executor=executor, batching="inflight",
        max_batch=4, transport=eng.FaultInjector(
            eng.ChannelTransport.from_trace(trace),
            blackouts=FAULT_BLACKOUT),
        retry=eng.RetryPolicy(max_attempts=3, backoff_base_s=0.5),
        debug_invariants=True)
    futs, _ = submit_frames(engine, frames, range(4))
    engine.drain()
    return engine, [f.result() for f in futs]


def fault_stage_run(eng, executor, packets, faulty=True):
    """12d, stage fault: two packets through ``submit_packet`` on 4 slots,
    the executor wrapped in a FaultyExecutor that raises CloudStageError
    on decode call FAULT_DECODE_CALL (both rows live), with a RetryPolicy
    (``faulty=False``: the same schedule fault-free). ``packets``:
    [(packet, query, Intent)]. Returns (engine, responses)."""
    if faulty:
        executor = eng.FaultyExecutor(
            executor, fail_at={"cloud_decode_rows": [FAULT_DECODE_CALL]})
    engine = eng.AveryEngine(
        lut=executor.lut, executor=executor, batching="inflight",
        max_batch=4, retry=eng.RetryPolicy(max_attempts=3,
                                           backoff_base_s=0.1),
        debug_invariants=True)
    futs = [engine.submit_packet(p, q, it, time_s=0.5 * i)
            for i, (p, q, it) in enumerate(packets)]
    engine.drain()
    return engine, [f.result() for f in futs]


def _engine_outputs(pcfg, responses, new_tokens=MAX_NEW_TOKENS):
    """Every response served, finite, with the expected shapes."""
    g = pcfg.image_size // pcfg.patch_size \
        * int(round(max(1, pcfg.mask_pixels_per_patch) ** 0.5))
    for r in responses:
        if r.failure is not None or r.tokens is None:
            raise AssertionError(f"request {r.request_id} not served: "
                                 f"{r.failure}")
        arrs = [r.answer_logits, r.tokens]
        if r.tokens.shape != (1, new_tokens) or \
                r.answer_logits.shape != (1, pcfg.llm.vocab_size):
            raise AssertionError(f"request {r.request_id}: bad shapes")
        if r.intent.value == "insight":
            if r.mask_logits is None or r.mask_logits.shape != (1, g, g):
                raise AssertionError(f"request {r.request_id}: bad mask")
            arrs.append(r.mask_logits)
        if not all(np.isfinite(a).all() for a in arrs):
            raise AssertionError(f"request {r.request_id}: non-finite")


def _one_shot(executor, responses, packets, queries, label):
    """Each response's tokens equal those of its own packet through the
    one-shot ``cloud_generate_batch``."""
    for r in responses:
        want = executor.cloud_generate_batch([packets[r.request_id]],
                                             [queries[r.request_id]])[0]
        if not np.array_equal(r.tokens, want[-1]):
            raise AssertionError(f"{label}: request {r.request_id} tokens "
                                 f"{r.tokens} != one-shot {want[-1]}")
    log(f"[engine] {label}: {len(responses)} requests' tokens equal the "
        f"one-shot cloud_generate_batch on the packets their transport "
        f"carried")


def _log_requests(label, responses, transport):
    recs = {}
    for rec in transport.records:
        recs.setdefault(rec.packet.seq_id, []).append(rec)
    for r in responses:
        sends = ", ".join(
            f"[{x.start_s:.3f}, {x.end_s:.3f}] s {x.packet.payload_bytes} B"
            f"{'' if x.delivered else ' lost'}"
            for x in recs.get(r.request_id, []))
        log(f"[engine] {label}: request {r.request_id} ({r.operator_id}) "
            f"{r.intent.value}, tier {r.tier_name}, attempts {r.attempts}, "
            f"sent {sends}; tokens {r.tokens.tolist()[0]}")


def engine_generate(executor, pcfg, frames, trace):
    """12a: ``batching="generate"``, AdaptivePolicy over a ChannelTransport
    on ``trace``, two sessions of different mission goals, six frames
    through ``session.submit``. Counters from 0 just before: contiguous
    decode launches must be steps x layers and no other kernel."""
    from repro_torch import engine as eng
    engine = eng.AveryEngine(
        lut=executor.lut, executor=executor, batching="generate",
        max_batch=4, transport=eng.ChannelTransport.from_trace(trace),
        policy=eng.AdaptivePolicy())
    sessions = _engine_sessions(engine)
    _reset_launch_counts()
    t0 = _sync_s()
    futs, _ = submit_frames(engine, frames, range(len(ENGINE_FRAMES)),
                            sessions)
    engine.drain()
    wall = _sync_s() - t0
    launches = _launch_counts()
    responses = [f.result() for f in futs]
    stats = engine.stats
    steps = stats["n_microbatches"] * MAX_NEW_TOKENS
    expect = _only(decode_attention=steps * pcfg.llm.num_layers)
    log(f"[engine] 12a generate: {len(responses)} requests in "
        f"{stats['n_microbatches']} microbatches ({steps} decode steps), "
        f"wall {wall:.2f} s; launches {launches} (expected {expect})")
    if launches != expect or steps == 0:
        raise AssertionError(f"12a: launches {launches}, expected {expect}")
    kinds = {r.intent.value for r in responses}
    if kinds != {"context", "insight"}:
        raise AssertionError(f"12a: intents {kinds}")
    _engine_outputs(pcfg, responses)
    _log_requests("12a", responses, engine.transport)
    packets = delivered_packets(engine.transport)
    _one_shot(executor, responses, packets,
              [q for _, q in frames], "12a")
    return {"wall_s": wall, "launches": launches, "expected": expect,
            "microbatches": stats["n_microbatches"],
            "intents": [r.intent.value for r in responses],
            "tiers": [r.tier_name for r in responses]}


def engine_inflight(executor, pcfg, frames, trace):
    """12b: ``batching="inflight"`` through a QoSScheduler, the sessions
    and frames of 12a, then uav-A's frame 0 again after a pump. Paged
    launches must be decode steps x layers and no other kernel; tokens
    equal the one-shot path's; a late join and a prefix hit. Then the
    reference's canonical in-flight scenario (three packets through
    ``submit_packet``, two slots) for the ``stats()`` key set. Returns
    (report, the engine, [(packet, query, Intent)] in request order)."""
    from repro_torch import engine as eng
    from repro_torch.core.intent import Intent
    engine = eng.AveryEngine(
        lut=executor.lut, executor=executor, batching="inflight",
        max_batch=INFLIGHT_SLOTS, transport=eng.ChannelTransport.from_trace(
            trace), policy=eng.AdaptivePolicy(),
        scheduler=eng.QoSScheduler(), wallclock=time.perf_counter)
    _reset_launch_counts()
    t0 = _sync_s()
    futs = _inflight_schedule(engine, frames)
    wall = _sync_s() - t0
    launches = _launch_counts()
    responses = [f.result() for f in futs]
    stats = engine.stats
    expect = _only(paged_decode_attention=stats["inflight_steps"]
                   * pcfg.llm.num_layers)
    log(f"[engine] 12b inflight: {len(responses)} requests on "
        f"{INFLIGHT_SLOTS} slots in {stats['inflight_steps']} decode steps "
        f"(mean live slots {stats['mean_live_slots']:.2f}), wall "
        f"{wall:.2f} s; joined at steps "
        f"{[r.joined_step for r in responses]}, prefix hits "
        f"{[int(r.prefix_hit) for r in responses]}, preemptions "
        f"{[r.preemptions for r in responses]}; launches {launches} "
        f"(expected {expect})")
    if launches != expect or stats["inflight_steps"] == 0:
        raise AssertionError(f"12b: launches {launches}, expected {expect}")
    if max(r.joined_step for r in responses) < 1 or \
            not any(r.prefix_hit for r in responses):
        raise AssertionError("12b: no late join or no prefix hit")
    _engine_outputs(pcfg, responses)
    _log_requests("12b", responses, engine.transport)
    packets = delivered_packets(engine.transport)
    queries = [q for _, q in frames] + [frames[0][1]]
    _one_shot(executor, responses, packets, queries, "12b")
    engine.kv_pool.check_invariants()
    # the reference's canonical in-flight scenario, for the key set
    canon = eng.AveryEngine(lut=executor.lut, executor=executor,
                            batching="inflight", max_batch=2)
    order = [(packets[r.request_id], queries[r.request_id],
              Intent(packets[r.request_id].kind)) for r in responses]
    for i, (p, q, it) in enumerate(order[:3]):
        canon.submit_packet(p, q, it, time_s=float(i))
    canon.drain()
    with open(os.path.join(REPO, "tests", "fixtures",
                           "engine_stats_keys.json")) as f:
        want_keys = json.load(f)
    if sorted(canon.stats) != want_keys:
        raise AssertionError(
            f"12b: stats() keys differ from the fixture: "
            f"{sorted(set(canon.stats) ^ set(want_keys))}")
    log(f"[engine] 12b: stats() keys of the canonical in-flight scenario "
        f"equal tests/fixtures/engine_stats_keys.json ({len(want_keys)} "
        f"keys); compiled_stages {canon.stats['compiled_stages']}")
    return ({"wall_s": wall, "launches": launches, "expected": expect,
             "steps": stats["inflight_steps"],
             "joined_steps": [r.joined_step for r in responses],
             "prefix_hits": [bool(r.prefix_hit) for r in responses],
             "preemptions": [r.preemptions for r in responses],
             "stats_keys": len(want_keys),
             "tokens": [r.tokens.tolist() for r in responses]}, engine, order)


def _inflight_schedule(engine, frames):
    """12b's schedule (and 13a's): the six frames through the two
    sessions, a pump, uav-A's frame 0 again (a late join and a prefix
    hit), then a drain. Returns the futures in submission order."""
    sessions = _engine_sessions(engine)
    futs, _ = submit_frames(engine, frames, range(len(ENGINE_FRAMES)),
                            sessions)
    engine.pump()
    images, query = frames[0]
    futs.append(sessions["uav-A"].submit(
        prompt=ENGINE_FRAMES[0][1], images=images, query=query,
        time_s=ENGINE_REPEAT_T))
    engine.drain()
    return futs


def _serve_packets(engine, order):
    futs = [engine.submit_packet(p, q, it, time_s=0.4 * i)
            for i, (p, q, it) in enumerate(order)]
    engine.pump()
    return futs


def _recording(executor, engine, name, calls, logits):
    """Wrap the executor's stage ``name`` (``cloud_decode_rows`` or
    ``cloud_verify_rows``) of ``engine``'s decoder: count its calls and
    record, for every live row, the logits that predict each of the row's
    next tokens, ``logits[(request id, token index)]`` (a verify chunk's
    query i predicts token n + i of a row with n tokens)."""
    stage = getattr(executor, name)

    def run(*args):
        calls[name] += 1
        dec, = engine._inflight.values()
        rows = {s: (st.req.seq_id, len(st.tokens))
                for s, st in dec.active.items()}
        out = stage(*args)
        for s, (rid, n) in rows.items():
            if name == "cloud_decode_rows":
                logits[(rid, n)] = out[0][s]
            else:
                for i in range(int(args[6][s])):
                    logits[(rid, n + i)] = out[0][s, i]
        return out
    return run


def _bf16_step(v):
    """The bf16 step at |v|: 2^(e - 7) for |v| in [2^e, 2^(e + 1))."""
    return 2.0 ** (math.floor(math.log2(abs(float(v)))) - 7) if v else 0.0


def _bf16_steps(x, y):
    """|x - y| in bf16 steps at the larger magnitude."""
    step = _bf16_step(max(abs(float(x)), abs(float(y))))
    return abs(float(x) - float(y)) / step if step else 0.0


def engine_spec(executor, pcfg, order):
    """12c: ``speculative=3`` on phase 9's executor (6 new tokens over
    pages of 4, the serving weights), 12b's packets through
    ``submit_packet``. Verify, paged and contiguous launches must be
    verify steps, plain steps and draft steps, each x layers. Tokens equal
    the same engine's with ``speculative=None``, but for at most MAX_TIES
    near ties of the two leading logits. Where a request's tokens first
    differ, take the logits both runs computed for that token on the same
    prefix (S through the verify kernel, P through the paged decode
    kernel), the speculative token a and the plain one b: a must lead S
    and b lead P (so a kept draft is the verify logits' pick), S[a] and
    P[a], and S[b] and P[b], must differ by at most TIE_ULPS bf16 steps,
    and S and P must agree within PATH_RTOL norm-wise, as a kernel's path
    and its plain version's do. The ``speculative=None`` run's margin
    P[b] - P[a] is printed beside the two differences."""
    from repro_torch import engine as eng
    sx = spec_executor(executor)
    runs = []
    for speculative in (3, None):
        engine = eng.AveryEngine(lut=sx.lut, executor=sx,
                                 batching="inflight",
                                 max_batch=INFLIGHT_SLOTS,
                                 speculative=speculative)
        calls = {"cloud_verify_rows": 0, "cloud_decode_rows": 0}
        logits = {}
        for name in calls:
            setattr(sx, name, _recording(sx, engine, name, calls, logits))
        try:
            _reset_launch_counts()
            t0 = _sync_s()
            futs = _serve_packets(engine, order)
            decoders = list(engine._inflight.values())
            engine.drain()
            wall = _sync_s() - t0
            launches = _launch_counts()
        finally:
            for name in calls:
                delattr(sx, name)
        runs.append((engine, [f.result() for f in futs], calls, logits,
                     decoders, wall, launches))
    engine, responses, calls, spec_logits, decoders, wall, launches = runs[0]
    L = pcfg.llm.num_layers
    draft_steps = sum(d.draft.n_steps for d in decoders
                      if d.draft is not None)
    expect = _only(paged_verify_attention=calls["cloud_verify_rows"] * L,
                   paged_decode_attention=calls["cloud_decode_rows"] * L,
                   decode_attention=draft_steps * L)
    spec = {k: v for k, v in engine.stats.items() if k.startswith("spec_")}
    log(f"[engine] 12c speculative=3: {len(responses)} requests in "
        f"{calls['cloud_verify_rows']} verify and "
        f"{calls['cloud_decode_rows']} plain steps, {draft_steps} draft "
        f"steps, wall {wall:.2f} s; launches {launches} (expected "
        f"{expect})")
    log(f"[engine] 12c SpecStats {json.dumps(spec)}")
    if launches != expect or not calls["cloud_verify_rows"] or \
            not spec["spec_drafted"]:
        raise AssertionError(f"12c: launches {launches}, expected {expect}")
    _engine_outputs(pcfg, responses, SPEC_MAX_NEW_TOKENS)
    _, base, _, plain_logits, _, _, _ = runs[1]
    ties = []
    for r, b in zip(responses, base):
        x, y = r.tokens[0], b.tokens[0]
        if np.array_equal(x, y):
            continue
        d = int(np.argmax(x != y))
        key = (r.request_id, d)
        if key not in spec_logits or key not in plain_logits:
            raise AssertionError(f"12c: request {r.request_id} tokens {x} "
                                 f"!= speculative=None {y} at token {d}, "
                                 f"with no logits recorded for it")
        S, P = (np.asarray(v, np.float64) for v in (spec_logits[key],
                                                    plain_logits[key]))
        a, b = int(x[d]), int(y[d])
        tie = {"request": r.request_id, "token": d, "spec": a, "plain": b,
               "margin": float(P[b] - P[a]),
               "diff_spec_token": float(S[a] - P[a]),
               "diff_plain_token": float(S[b] - P[b]),
               "ulps_spec_token": _bf16_steps(S[a], P[a]),
               "ulps_plain_token": _bf16_steps(S[b], P[b]),
               "spec_leads": bool(S[a] >= S.max()),
               "plain_leads": bool(P[b] >= P.max()),
               "max_diff": float(np.abs(S - P).max()), "rel": _rel(S, P)}
        ties.append(tie)
        log(f"[engine] 12c: request {r.request_id} tokens {x.tolist()} vs "
            f"speculative=None {y.tolist()}, first differing at token {d}: "
            f"speculative=None margin {tie['margin']:.4g} of {b} over {a}; "
            f"the verify path's logits there differ by "
            f"{tie['diff_spec_token']:+.4g} at {a} and "
            f"{tie['diff_plain_token']:+.4g} at {b} "
            f"({tie['ulps_spec_token']:.3g} and {tie['ulps_plain_token']:.3g}"
            f" bf16 steps, limit {TIE_ULPS}); {a} leads the verify logits: "
            f"{tie['spec_leads']}, {b} the decode logits: "
            f"{tie['plain_leads']}; max abs {tie['max_diff']:.4g}, "
            f"norm-wise {tie['rel']:.3g} (limit {PATH_RTOL})")
        if not (tie["spec_leads"] and tie["plain_leads"]
                and tie["ulps_spec_token"] <= TIE_ULPS
                and tie["ulps_plain_token"] <= TIE_ULPS
                and tie["rel"] <= PATH_RTOL):
            raise AssertionError(f"12c: request {r.request_id} differs from "
                                 f"speculative=None beyond a near tie: "
                                 f"{tie}")
    log(f"[engine] 12c: {len(responses) - len(ties)} of {len(responses)} "
        f"requests' tokens equal the speculative=None engine's; "
        f"{len(ties)} differ from a near tie on (at most {MAX_TIES})")
    if len(ties) > MAX_TIES:
        raise AssertionError(f"12c: {len(ties)} requests differ from "
                             f"speculative=None, more than {MAX_TIES}")
    return {"wall_s": wall, "launches": launches, "expected": expect,
            "steps": calls, "draft_steps": draft_steps, "spec_stats": spec,
            "ties": ties, "tokens": [r.tokens.tolist() for r in responses]}


def engine_faults(executor, pcfg, frames, order, trace):
    """12d: the blackout run and the stage-fault run, each held to
    FAULT_COUNTERS; the blacked-out request retried, downshifted and
    served; the stage fault's victims equal to their fault-free run."""
    from repro_torch import engine as eng
    out = {}
    engine, responses = fault_blackout_run(eng, executor, frames, trace)
    got = fault_counters(engine.stats)
    _engine_outputs(pcfg, responses)
    hit = responses[0]
    kinds = [e.kind for e in hit.events]
    tiers = [e.data.get("tier") for e in hit.events
             if e.kind == "tier_selected"]
    log(f"[engine] 12d blackout: request 0 events {kinds}, tiers {tiers}, "
        f"attempts {hit.attempts}; counters {got}")
    if got != FAULT_COUNTERS["blackout"] or hit.attempts != 2 or \
            "blackout" not in kinds or len(set(tiers)) != 2:
        raise AssertionError(f"12d blackout: counters {got}, expected "
                             f"{FAULT_COUNTERS['blackout']}")
    out["blackout"] = {"counters": got, "tiers": tiers,
                       "attempts": hit.attempts}
    engine, responses = fault_stage_run(eng, executor, order[:2])
    got = fault_counters(engine.stats)
    _, clean = fault_stage_run(eng, executor, order[:2], faulty=False)
    for r, c in zip(responses, clean):
        if r.attempts != 2 or not np.array_equal(r.tokens, c.tokens):
            raise AssertionError(f"12d stage fault: request {r.request_id}"
                                 f" attempts {r.attempts}, tokens "
                                 f"{r.tokens} vs fault-free {c.tokens}")
    log(f"[engine] 12d stage fault: both rows failed at decode call "
        f"{FAULT_DECODE_CALL}, retried and equal their fault-free run's "
        f"tokens; counters {got}")
    if got != FAULT_COUNTERS["stage"]:
        raise AssertionError(f"12d stage fault: counters {got}, expected "
                             f"{FAULT_COUNTERS['stage']}")
    out["stage"] = {"counters": got}
    return out


def engine_timings(executor, order, card):
    """TIMING_TURNS warm engine pumps on four live rows (an executor of
    TIMING_TOKENS new tokens that shares the serving weights), each timed
    whole and around the bare ``InflightDecoder.step`` it makes, both on
    the host clock after a synchronise (a step ends in a copy of its
    logits to the host). The front door's host cost a step is the median
    of the pumps' own differences, pump minus its step: one call holds
    both, so the host's drift between calls cancels. It is printed as
    resolved when its quartiles lie within TIMING_RESOLVE_MS of it."""
    from repro_torch import engine as eng
    from repro_torch.core.streams import DualStreamExecutor
    tx = DualStreamExecutor(pcfg=executor.pcfg, params=executor.params,
                            bottlenecks=executor.bottlenecks,
                            lut=executor.lut, max_new_tokens=TIMING_TOKENS,
                            flash_decode=True, device=executor.device)
    engine = eng.AveryEngine(lut=tx.lut, executor=tx, batching="inflight",
                             max_batch=INFLIGHT_SLOTS)
    rows = [o for o in order if o[0].kind == "context"][:INFLIGHT_SLOTS]
    rows += order[:INFLIGHT_SLOTS - len(rows)]
    for p, q, it in rows:
        engine.submit_packet(p, q, it, time_s=0.0)
    dec, = engine._inflight.values()
    if len(dec.active) != INFLIGHT_SLOTS:
        raise AssertionError("timing decoder has idle slots")
    turns = []
    step = dec.step

    def timed_step():
        t0 = _sync_s()
        out = step()
        turns[-1]["step"] = (_sync_s() - t0) * 1e3
        return out
    dec.step = timed_step
    try:
        for _ in range(TIMING_TURNS):
            turns.append({})
            t0 = _sync_s()
            engine.pump()
            turns[-1]["pump"] = (_sync_s() - t0) * 1e3
    finally:
        del dec.step
    if len(dec.active) != INFLIGHT_SLOTS or \
            any("step" not in t for t in turns):
        raise AssertionError("a timing pump made no step on every row")
    engine.drain()
    diff = [t["pump"] - t["step"] for t in turns]
    pump, step_ms = (float(np.median([t[k] for t in turns]))
                     for k in ("pump", "step"))
    q1, med, q3 = (float(np.percentile(diff, q)) for q in (25, 50, 75))
    resolved = max(med - q1, q3 - med) <= TIMING_RESOLVE_MS
    log(f"[engine] {TIMING_TURNS} warm engine.pump() calls on "
        f"{INFLIGHT_SLOTS} live rows, each timed whole and around its bare "
        f"InflightDecoder.step: pump median {pump:.3f} ms, step "
        f"{step_ms:.3f} ms; front-door host cost a step (pump minus its "
        f"step) median {med:.4f} ms, quartiles {q1:.4f} to {q3:.4f}, "
        f"{'resolved' if resolved else 'unresolved'} (limit "
        f"±{TIMING_RESOLVE_MS} ms) ({card})")
    return {"pump_ms": pump, "step_ms": step_ms, "host_cost_ms": med,
            "host_cost_quartiles_ms": [q1, q3], "resolved": resolved,
            "turns": turns}


def engine_phase(executor, pcfg, seed):
    """Phase 12: the AveryEngine front door at LISA-7B's full width on the
    serving weights: 12a generate, 12b in flight, 12c speculative, 12d
    faults, then timings. Returns (report, 12b's [(packet, query,
    Intent)] in request order)."""
    from repro_torch.network import paper_trace
    frames = engine_frames(pcfg, seed)
    out = {"generate": engine_generate(executor, pcfg, frames,
                                       paper_trace(seed))}
    out["inflight"], engine, order = engine_inflight(
        executor, pcfg, frames, paper_trace(seed))
    stats = engine.stats
    keys = ("ttft_latency_p50_s", "ttft_throughput_p50_s",
            "transmit_p50_s", "decode_step_p50_s")
    out["stats"] = {k: stats[k] for k in keys}
    card = card_line()
    log(f"[engine] 12b stats(): TTFT p50 latency class "
        f"{stats['ttft_latency_p50_s']:.4f} s, throughput class "
        f"{stats['ttft_throughput_p50_s']:.4f} s, transmit p50 "
        f"{stats['transmit_p50_s']:.4f} s (mission clock: the simulated "
        f"uplink); decode step p50 {stats['decode_step_p50_s'] * 1e3:.2f} "
        f"ms over {stats['inflight_steps']} steps (wall, ending in the copy "
        f"of the step's logits to the host; {card})")
    out["spec"] = engine_spec(executor, pcfg, order)
    out["faults"] = engine_faults(executor, pcfg, frames, order,
                                  paper_trace(seed))
    out["timings"] = engine_timings(executor, order, card)
    return out, order


# ---------------------------------------------------------------------------
# phase 13 (profile): the stage profiler, cost ledger and sanitizers
# ---------------------------------------------------------------------------

# the reference's budget for the profiler's cost a serve (tests/
# test_profiler.py): the run fails when the lower quartile of the per-turn
# relative cost a decode step exceeds it
PROFILE_OVERHEAD_BUDGET = 0.05
# the overhead's turns (96: a turn's difference spreads by about +-12 % of
# a step on the host; 24 turns left the median within +-3 %) and the new
# tokens that keep four rows live through them
PROFILE_TURNS = 96
PROFILE_TOKENS = PROFILE_TURNS + 2 * INFLIGHT_SLOTS
# 13c: pumps after each steady-state wave, as the sanitizers' smoke pumps
SANITIZER_PUMPS = 16
# 13c: the pool pre-sized for the steady waves (a pool that grows allocates
# anew, which the census counts where the cache lacks the room): at most 8
# stored prefixes and 4 live ones of ceil(204 / 16) = 13 pages each, and a
# private page a slot
SANITIZER_PAGES = 192
# 13c: distinct prefixes fed to a pool of kv_pages=2
POOL_GROWTH_REQUESTS = 8
# 13d: the lisa-mini runs on the card: the paper's 20-minute mission
# (MissionSpec's default duration), a fleet of 4 UAVs, and the two
# launchers, each run as ``python -m`` runs a module, its kernel launch
# counters printed after it (RUN_MODULE)
FLEET_UAVS = 4
SERVE_ARGS = ("--smoke", "--batching", "inflight", "--duration", "20",
              "--seed", "1")
SUBPROCESS_TIMEOUT_S = 300
RUN_MODULE = """
import importlib, json, os, runpy, sys, time
import torch
from repro_torch.kernels.decode_attention import ops
module, sys.argv = sys.argv[1], sys.argv[1:]
walls = []


def timed(mod, name):
    fn = getattr(mod, name)

    def run(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        walls.append([name, time.perf_counter() - t0])
        return out
    setattr(mod, name, run)


for spec in filter(None, os.environ.get("CHIP_SMOKE_TIMED", "").split(",")):
    mod, name = spec.split(":")
    timed(importlib.import_module(mod), name)
code = 0
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code or 0
if walls:
    print("[walls] " + json.dumps(walls))
print(json.dumps({"decode_attention": ops.launches,
                  "paged_decode_attention": ops.paged_launches,
                  "paged_verify_attention": ops.verify_launches}))
sys.exit(code)
"""


def card_device(card):
    """The H100's constants (``network/energy.py:H100_SXM``) at this card's
    power limit, from the card line ``name, <limit> W``."""
    from repro_torch.network.energy import H100_SXM
    watts = float(card.rsplit(",", 1)[1].split()[0])
    return dataclasses.replace(H100_SXM, power_watts=watts)


def _stage_lines(tag, stats, card):
    """Each profiled stage's calls and p50 wall (ms; the histograms' 8
    buckets a decade make each p50 a bucket edge)."""
    from repro_torch.engine.profiler import PROFILED_STAGES
    ran = [s for s in PROFILED_STAGES if stats[f"stage_{s}_calls"]]
    log(f"[profile] {tag} stages (calls, p50 ms): " + ", ".join(
        f"{s} {stats[f'stage_{s}_calls']} x "
        f"{stats[f'stage_{s}_p50_s'] * 1e3:.3f}" for s in ran)
        + f" ({card})")
    return {s: {"calls": stats[f"stage_{s}_calls"],
                "p50_s": stats[f"stage_{s}_p50_s"]} for s in ran}


def _device_track(engine):
    """The pid-3 spans of the engine's ``dump_trace`` document."""
    import tempfile
    from repro_torch.engine.observability import DEVICE_TRACK_PID
    with tempfile.TemporaryDirectory() as d:
        with open(engine.dump_trace(os.path.join(d, "trace.json"))) as f:
            doc = json.load(f)
    return [e for e in doc["traceEvents"]
            if e.get("pid") == DEVICE_TRACK_PID and e.get("ph") == "X"]


def _ledger_check(tag, pcfg, responses, stats, steps):
    """Each response's ledger against the analytic cost recomputed from
    ``network/energy.py``: the prefill of a prefix miss, then one token a
    decode step at its attended context; the engine's totals against the
    responses' sums. Rows that were preempted (and replayed) are left out
    of the per-response check and counted."""
    from repro_torch.network import energy
    prefix = pcfg.clip_tokens + QUERY_LEN
    checked = 0
    for r in responses:
        if r.preemptions:
            continue
        flops = 0.0 if r.prefix_hit else energy.encoder_flops(pcfg.llm,
                                                              prefix)
        hbm = 0.0
        for i in range(1, steps + 1):
            flops += energy.decode_token_flops(pcfg.llm, prefix + i)
            hbm += energy.decode_token_hbm_bytes(pcfg.llm, prefix + i)
        if (r.cloud_flops, r.cloud_hbm_bytes) != (flops, hbm):
            raise AssertionError(
                f"{tag}: request {r.request_id} ledger "
                f"{(r.cloud_flops, r.cloud_hbm_bytes)} != analytic "
                f"{(flops, hbm)}")
        checked += 1
    for key, field in (("ledger_flops_total", "cloud_flops"),
                       ("ledger_hbm_bytes_total", "cloud_hbm_bytes"),
                       ("ledger_energy_j_total", "cloud_energy_j")):
        want = sum(getattr(r, field) for r in responses)
        if not math.isclose(stats[key], want, rel_tol=1e-12):
            raise AssertionError(f"{tag}: {key} {stats[key]} != the "
                                 f"responses' sum {want}")
    frac = stats["decode_roofline_frac"]
    log(f"[profile] {tag} ledger: {checked} of {len(responses)} requests "
        f"equal the analytic cost; totals {stats['ledger_flops_total']:.6g}"
        f" FLOPs, {stats['ledger_hbm_bytes_total']:.6g} HBM bytes, "
        f"{stats['ledger_energy_j_total']:.6g} J; decode_roofline_frac "
        f"{frac:.6f} (limit (0, 1])")
    if not 0.0 < frac <= 1.0:
        raise AssertionError(f"{tag}: decode_roofline_frac {frac} outside "
                             f"(0, 1]: a wrong count")
    return checked


def profile_inflight(executor, pcfg, frames, trace, base, device, card):
    """13a: 12b's engine and schedule with ``profile=`` (a StageProfiler on
    this card's constants) and tracing on. Counters from 0 just before:
    paged launches steps x layers and no other kernel; tokens equal 12b's;
    ``cloud_decode_rows`` profiled once a step; the profiled calls equal
    the device track's spans; the ledger against the analytic cost;
    ``decode_roofline_frac`` in (0, 1]."""
    from repro_torch import engine as eng
    engine = eng.AveryEngine(
        lut=executor.lut, executor=executor, batching="inflight",
        max_batch=INFLIGHT_SLOTS, transport=eng.ChannelTransport.from_trace(
            trace), policy=eng.AdaptivePolicy(),
        scheduler=eng.QoSScheduler(), wallclock=time.perf_counter,
        trace=True, profile=eng.StageProfiler(time.perf_counter,
                                              device=device))
    _reset_launch_counts()
    t0 = _sync_s()
    futs = _inflight_schedule(engine, frames)
    wall = _sync_s() - t0
    launches = _launch_counts()
    responses = [f.result() for f in futs]
    stats = engine.stats
    steps = stats["inflight_steps"]
    expect = _only(paged_decode_attention=steps * pcfg.llm.num_layers)
    tokens = [r.tokens.tolist() for r in responses]
    spans = _device_track(engine)
    log(f"[profile] 13a profiled inflight: {len(responses)} requests in "
        f"{steps} decode steps, wall {wall:.2f} s; launches {launches} "
        f"(expected {expect}); cloud_decode_rows profiled "
        f"{stats['stage_cloud_decode_rows_calls']} times (steps {steps}); "
        f"{stats['profiled_stage_calls']} profiled calls, {len(spans)} "
        f"device-track spans; compile events {stats['compile_events']} "
        f"({card})")
    if launches != expect or steps == 0:
        raise AssertionError(f"13a: launches {launches}, expected {expect}")
    if tokens != base["tokens"]:
        raise AssertionError(f"13a: tokens {tokens} != 12b's "
                             f"{base['tokens']}")
    if stats["stage_cloud_decode_rows_calls"] != steps:
        raise AssertionError("13a: cloud_decode_rows calls != steps")
    if len(spans) != stats["profiled_stage_calls"]:
        raise AssertionError(f"13a: {len(spans)} device spans, "
                             f"{stats['profiled_stage_calls']} calls")
    _engine_outputs(pcfg, responses)
    checked = _ledger_check("13a", pcfg, responses, stats, MAX_NEW_TOKENS)
    log("[profile] 13a: tokens equal 12b's")
    engine.kv_pool.check_invariants()
    return {"wall_s": wall, "launches": launches, "expected": expect,
            "steps": steps, "stages": _stage_lines("13a", stats, card),
            "profiled_calls": stats["profiled_stage_calls"],
            "device_spans": len(spans), "ledger_checked": checked,
            **{k: stats[k] for k in (
                "compile_events", "compile_wall_s", "compiled_roots",
                "ledger_flops_total", "ledger_hbm_bytes_total",
                "ledger_energy_j_total", "decode_roofline_frac",
                "profiled_wall_s")}}


def profile_spec(executor, pcfg, order, base, device, card):
    """13b: 12c's ``speculative=3`` engine on phase 9's executor, profiled.
    Counters from 0 just before: verify, paged and contiguous launches
    verify, plain and draft steps x layers; ``draft`` profiled once a
    drafting round and ``cloud_verify_rows`` once a verify step, each
    counted at the decoder's own calls; tokens equal 12c's."""
    from repro_torch import engine as eng
    from repro_torch.engine.speculative import DraftModel
    sx = spec_executor(executor)
    engine = eng.AveryEngine(
        lut=sx.lut, executor=sx, batching="inflight",
        max_batch=INFLIGHT_SLOTS, speculative=3, wallclock=time.perf_counter,
        profile=eng.StageProfiler(time.perf_counter, device=device))
    calls = {"cloud_verify_rows": 0, "cloud_decode_rows": 0, "draft": 0}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    real_draft = DraftModel.draft
    for name in ("cloud_verify_rows", "cloud_decode_rows"):
        setattr(sx, name, counted(name, getattr(sx, name)))
    try:
        with mock.patch.object(DraftModel, "draft",
                               counted("draft", real_draft)):
            _reset_launch_counts()
            t0 = _sync_s()
            futs = _serve_packets(engine, order)
            decoders = list(engine._inflight.values())
            engine.drain()
            wall = _sync_s() - t0
            launches = _launch_counts()
    finally:
        for name in ("cloud_verify_rows", "cloud_decode_rows"):
            delattr(sx, name)
    responses = [f.result() for f in futs]
    stats = engine.stats
    L = pcfg.llm.num_layers
    draft_steps = sum(d.draft.n_steps for d in decoders
                      if d.draft is not None)
    expect = _only(paged_verify_attention=calls["cloud_verify_rows"] * L,
                   paged_decode_attention=calls["cloud_decode_rows"] * L,
                   decode_attention=draft_steps * L)
    tokens = [r.tokens.tolist() for r in responses]
    log(f"[profile] 13b profiled speculative=3: {len(responses)} requests "
        f"in {calls['cloud_verify_rows']} verify and "
        f"{calls['cloud_decode_rows']} plain steps, {calls['draft']} "
        f"drafting rounds of {draft_steps} draft steps, wall {wall:.2f} s; "
        f"launches {launches} (expected {expect}); profiled draft "
        f"{stats['stage_draft_calls']}, draft_admit "
        f"{stats['stage_draft_admit_calls']}, cloud_verify_rows "
        f"{stats['stage_cloud_verify_rows_calls']}, cloud_decode_rows "
        f"{stats['stage_cloud_decode_rows_calls']} ({card})")
    if launches != expect or not calls["cloud_verify_rows"]:
        raise AssertionError(f"13b: launches {launches}, expected {expect}")
    if (stats["stage_draft_calls"], stats["stage_cloud_verify_rows_calls"],
            stats["stage_cloud_decode_rows_calls"]) != (
            calls["draft"], calls["cloud_verify_rows"],
            calls["cloud_decode_rows"]) or not calls["draft"]:
        raise AssertionError(f"13b: profiled stage calls differ from the "
                             f"decoder's {calls}")
    if tokens != base["tokens"]:
        raise AssertionError(f"13b: tokens {tokens} != 12c's "
                             f"{base['tokens']}")
    _engine_outputs(pcfg, responses, SPEC_MAX_NEW_TOKENS)
    frac = stats["decode_roofline_frac"]
    if not 0.0 < frac <= 1.0:
        raise AssertionError(f"13b: decode_roofline_frac {frac} outside "
                             f"(0, 1]")
    log(f"[profile] 13b: tokens equal 12c's; decode_roofline_frac "
        f"{frac:.6f} (limit (0, 1])")
    return {"wall_s": wall, "launches": launches, "expected": expect,
            "calls": calls, "draft_steps": draft_steps,
            "stages": _stage_lines("13b", stats, card),
            "decode_roofline_frac": frac}


def sanitize_phase(executor, pcfg, order, device, card):
    """13c: ``debug_recompiles=True, debug_transfers=True`` in flight on
    the serving weights. Warm up on 12b's packets, ``arm_sanitizers()``,
    then two steady waves of the same packets under new queries (new
    prefixes, the same shapes), SANITIZER_PUMPS guarded pumps after each:
    every pump and drain checks the zero budget and raises on any sync
    outside the explicit window. Then a deliberate ``.item()`` inside the
    guard must raise; and a profiled engine with ``kv_pages=2`` fed
    distinct prefixes must grow its pool, each growth read at the pool's
    own write (``pool_growths``), and serve on; the flight recorder keeps
    the compile events (the allocator's) that the census saw."""
    from repro_torch import engine as eng
    from repro_torch.analysis import sanitizers
    L, V = pcfg.llm.num_layers, pcfg.llm.vocab_size
    engine = eng.AveryEngine(
        lut=executor.lut, executor=executor, batching="inflight",
        max_batch=INFLIGHT_SLOTS, kv_pages=SANITIZER_PAGES,
        max_prefixes=8, debug_recompiles=True, debug_transfers=True)

    def wave(shift, t0):
        return [engine.submit_packet(p, (q + shift) % V, it,
                                     time_s=t0 + 0.4 * i)
                for i, (p, q, it) in enumerate(order[:6])]

    futs = wave(0, 0.0)
    engine.drain()
    armed = engine.arm_sanitizers()
    warm_steps = engine.stats["inflight_steps"]
    _reset_launch_counts()
    t0 = _sync_s()
    for k in (1, 2):
        futs += wave(k, 100.0 * k)
        for _ in range(SANITIZER_PUMPS):
            engine.pump()
    engine.drain()
    wall = _sync_s() - t0
    launches = _launch_counts()
    engine.check_sanitizers(budget=0)
    stats = engine.stats
    steps = stats["inflight_steps"] - warm_steps
    expect = _only(paged_decode_attention=steps * L)
    failed = [f.result().failure for f in futs if f.result().failure]
    log(f"[profile] 13c sanitizers: census {armed} at arm ("
        f"{sorted(sanitizers.named_jit_roots(engine))}), "
        f"{stats['new_compiles_since_arm']} new after two waves of "
        f"{SANITIZER_PUMPS} guarded pumps ({steps} steps, wall {wall:.2f} "
        f"s; limit 0); no sync outside the explicit window; launches "
        f"{launches} (expected {expect}) ({card})")
    if failed or stats["new_compiles_since_arm"] != 0 or \
            launches != expect:
        raise AssertionError(f"13c: failures {failed}, new "
                             f"{stats['new_compiles_since_arm']}, launches "
                             f"{launches}")
    x = torch.ones(4, device=executor.device)
    try:
        with sanitizers.transfer_guard_ctx(True, executor.device):
            x.sum().item()
    except RuntimeError as e:
        bite = str(e).splitlines()[0]
    else:
        raise AssertionError("13c: .item() inside the guard did not raise")
    if torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("13c: the guard left the sync debug mode set")
    log(f"[profile] 13c: a deliberate .item() inside the guard raised "
        f"({bite!r}); the mode restored")
    out = {"armed": armed, "steps": steps, "wall_s": wall,
           "launches": launches, "roots": sorted(
               sanitizers.named_jit_roots(engine)), "bite": bite}
    del engine
    out["sync_census"] = sync_census(executor, pcfg, order, card)
    gc.collect()
    torch.cuda.empty_cache()      # or the caching allocator hides growth
    engine = eng.AveryEngine(
        lut=executor.lut, executor=executor, batching="inflight",
        max_batch=INFLIGHT_SLOTS, kv_pages=2, wallclock=time.perf_counter,
        profile=eng.StageProfiler(time.perf_counter, device=device))

    def submit(i):
        p, q, it = order[i % len(order)]
        return engine.submit_packet(p, (q + 10 + i) % V, it,
                                    time_s=float(i),
                                    session=engine.session(f"uav-{i}"))

    futs = [submit(0)]
    engine.drain()
    warm, pages0 = (engine.stats[k] for k in ("compile_events",
                                              "kv_pages_total"))
    with pool_growths(engine.kv_pool, device) as growths:
        futs += [submit(i) for i in range(1, POOL_GROWTH_REQUESTS)]
        engine.drain()
    stats = engine.stats
    compiles = [e["data"] for e in engine.flight.snapshot()
                if e["kind"] == "compile"]
    log(f"[profile] 13c pool growth (kv_pages=2, {POOL_GROWTH_REQUESTS} "
        f"distinct prefixes): pages {pages0} -> {stats['kv_pages_total']}; "
        f"at each growth of the pool (pages, pool bytes, bytes the "
        f"allocator handed out in it, new device allocations, reserved "
        f"bytes added): {growths}; compile events {warm} -> "
        f"{stats['compile_events']} "
        f"({stats['compile_wall_s'] * 1e3:.2f} ms of calls), flight "
        f"recorder's compile entries "
        f"{[(c['stage'], c['root'], c['delta']) for c in compiles]} "
        f"({card})")
    if not (growths and stats["kv_pages_total"] > pages0
            and all(g["allocated_bytes"] >= g["pool_bytes"][1]
                    and g["pool_bytes"][1] > g["pool_bytes"][0]
                    for g in growths)
            and all(c["delta"] >= 1 and c["root"] for c in compiles)
            and all(f.result().failure is None for f in futs)):
        raise AssertionError(f"13c: pool growth not seen at the pool: "
                             f"{growths}")
    out["pool_growth"] = {"pages": [pages0, stats["kv_pages_total"]],
                          "growths": growths,
                          "compile_events": [warm, stats["compile_events"]],
                          "flight_compiles": compiles}
    return out


@contextlib.contextmanager
def pool_growths(pool, device):
    """Reads the allocator around each call of ``pool.ensure`` that grows
    the pool: its pages and bytes before and after, the bytes the caching
    allocator handed out inside the call (at least the grown pool's, a
    fresh tensor a leaf), and the new device allocations and reserved
    bytes it took (none when the cache already held the room). Yields the
    list it fills."""
    growths, ensure = [], pool.ensure

    def stat(key):
        return int(torch.cuda.memory_stats(device).get(key, 0))

    def read():
        return (pool.num_pages if pool.kv is not None else 0,
                pool.pool_bytes, stat("allocated_bytes.all.allocated"),
                stat("num_device_alloc"), stat("reserved_bytes.all.current"))

    def watched(*args, **kwargs):
        before = read()
        ensure(*args, **kwargs)
        after = read()
        if before[0] and after[0] > before[0]:
            growths.append({"pages": [before[0], after[0]],
                            "pool_bytes": [before[1], after[1]],
                            "allocated_bytes": after[2] - before[2],
                            "device_allocs": after[3] - before[3],
                            "reserved_bytes": after[4] - before[4]})

    pool.ensure = watched
    try:
        yield growths
    finally:
        del pool.ensure


# the sites whose host syncs the explicit window admits: the executor's
# (and the draft model's) boundary copies and the profiler's wait, as
# (file under src/repro_torch, function)
WINDOW_SITES = {("core/streams.py", "host"),
                ("core/streams.py", "to_device"),
                ("engine/profiler.py", "_block")}


def sync_census(executor, pcfg, order, card):
    """13c, every host sync on the guarded pump path: 12b's packets through
    a profiled engine, and twice (the second time under new queries, so
    prefix misses) through 12c's ``speculative=3`` engine, one slot each:
    the rows queued behind it are admitted (prefill and draft prefill) and
    decoded (verify steps, drafting rounds) inside guarded pumps. The guard
    is in "warn" mode and the explicit window switched off; each warning is
    attributed to the innermost frame under ``src/repro_torch``. Every site
    must be one the window admits (WINDOW_SITES), which shows that the
    guard's "error" mode would raise on none of them. In the speculative
    run, counters from 0 after the submissions (each of which makes one
    unguarded step): verify plus paged launches must be the guarded steps
    x layers, contiguous launches the draft steps x layers. (The recompile
    budget is not armed here: the draft prefix rows are not pre-sized as
    the page pool is.)"""
    import traceback
    import warnings
    from repro_torch import engine as eng
    from repro_torch.core import streams
    from repro_torch.engine import engine as engmod
    from repro_torch.engine import profiler as profmod
    root = os.path.join(REPO, "src", "repro_torch") + os.sep
    L, V = pcfg.llm.num_layers, pcfg.llm.vocab_size
    sites = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        mine = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(root)]
        f = mine[-1]
        caller = mine[-2].name if len(mine) > 1 else "?"
        key = (os.path.relpath(f.filename, root).replace(os.sep, "/"),
               f.name, caller)
        sites[key] = sites.get(key, 0) + 1

    def warn_guard(enabled=True, device="cuda"):
        if not enabled or not streams.on_card(device):
            return streams.NULL_CTX
        return streams.SyncDebugMode("warn")

    def no_window(device):
        return streams.NULL_CTX

    runs = {"profiled": (dict(executor=executor, profile=True,
                              wallclock=time.perf_counter), (0,)),
            "speculative=3": (dict(executor=spec_executor(executor),
                                   speculative=3), (0, 1))}
    steps, spec = {}, {}
    with contextlib.ExitStack() as patches, warnings.catch_warnings():
        for mod, name, fn in ((engmod, "transfer_guard_ctx", warn_guard),
                              (streams, "sync_window", no_window),
                              (profmod, "sync_window", no_window)):
            patches.enter_context(mock.patch.object(mod, name, fn))
        warnings.simplefilter("always")
        warnings.showwarning = record
        for label, (kw, shifts) in runs.items():
            engine = eng.AveryEngine(lut=executor.lut, batching="inflight",
                                     max_batch=1, debug_transfers=True,
                                     **kw)
            futs = [engine.submit_packet(p, (q + k) % V, it,
                                         time_s=0.4 * i)
                    for k in shifts for i, (p, q, it) in enumerate(order)]
            dec, = engine._inflight.values()
            steps0 = engine.stats["inflight_steps"]
            drafted0 = dec.draft.n_steps if dec.draft is not None else 0
            _reset_launch_counts()
            for _ in range(SANITIZER_PUMPS):
                engine.pump()
            engine.drain()
            launches = _launch_counts()
            steps[label] = engine.stats["inflight_steps"] - steps0
            if dec.has_work or any(f.result().failure for f in futs):
                raise AssertionError(f"13c sync census: {label} failed or "
                                     "left rows after the drain")
            if "speculative" not in kw:
                continue
            if dec.draft is None:
                raise AssertionError("13c speculative: no draft was built")
            draft_steps = dec.draft.n_steps - drafted0
            spec = {"requests": len(futs), "steps": steps[label],
                    "draft_steps": draft_steps, "launches": launches}
            if launches != _only(
                    paged_verify_attention=launches["paged_verify_attention"],
                    paged_decode_attention=launches["paged_decode_attention"],
                    decode_attention=draft_steps * L) or \
                    launches["paged_verify_attention"] \
                    + launches["paged_decode_attention"] \
                    != steps[label] * L or \
                    not launches["paged_verify_attention"]:
                raise AssertionError(f"13c speculative: {spec}")
    log(f"[profile] 13c sync census, the window off, {steps} guarded "
        f"steps on one slot: " + "; ".join(
            f"{n} x {path}:{fn} (from {caller})"
            for (path, fn, caller), n in sorted(sites.items()))
        + f" ({card})")
    log(f"[profile] 13c speculative=3 in the census: {spec['requests']} "
        f"requests, {spec['steps']} steps and {spec['draft_steps']} draft "
        f"steps in guarded pumps; launches {spec['launches']} (verify + "
        f"paged = steps x {L}, contiguous = draft steps x {L}) ({card})")
    stray = sorted(k for k in sites if k[:2] not in WINDOW_SITES)
    if stray or not sites:
        raise AssertionError(f"13c: host syncs outside the window's sites: "
                             f"{stray}")
    return {"steps": steps, "spec": spec, "sites": [
        {"file": k[0], "function": k[1], "caller": k[2], "count": n}
        for k, n in sorted(sites.items())]}


def _run_module(module, args, tag="profile", phase="13d", timed=()):
    """``python -m module args`` (through RUN_MODULE, which prints the
    kernel launch counters after it), its output logged under ``tag``:
    (wall seconds, output lines, launches). Each ``"module:function"`` of
    ``timed`` is wrapped in the subprocess to time its calls (to a
    synchronise), printed as a ``[walls]`` line of [name, seconds]."""
    env = dict(os.environ)
    env["CHIP_SMOKE_TIMED"] = ",".join(timed)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")] + ([env["PYTHONPATH"]]
                                       if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", RUN_MODULE, module, *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=SUBPROCESS_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for ln in lines[:-1]:
        log(f"[{tag}]   {ln}")
    if proc.returncode != 0:
        raise AssertionError(f"{phase}: python -m {module} {' '.join(args)} "
                             f"exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    return wall, lines[:-1], json.loads(lines[-1])


def lisa_mini_phase(seed, dev, card):
    """13d: on a lisa-mini executor on the card (floodseg scenes are
    32 px, as the reference defines these paths): ``run_mission`` in
    executor mode (the fidelity oracle through ``cloud_insight``), AVERY
    against static High Accuracy over ``paper_trace(seed)`` for the paper's
    20 minutes; ``run_fleet`` with FLEET_UAVS UAVs; then the serving
    launcher in flight and the sanitizers' smoke, each as ``python -m``
    runs it. Each prints its kernel launches: the missions and the fleet
    launch none (the oracle's ``llm_reason`` is a prefill, with flash off),
    the launcher's paged launches are its decode steps x layers."""
    from repro_torch import engine as eng
    from repro_torch.configs.lisa_mini import CONFIG as mini
    from repro_torch.core import profile as prof
    from repro_torch.core.streams import DualStreamExecutor
    from repro_torch.network import paper_trace
    from repro_torch.runtime.fleet import run_fleet
    from repro_torch.runtime.mission import MissionSpec, run_mission
    params, bns, lut = prof.random_init_system(mini, seed=seed, device=dev)
    ex = DualStreamExecutor(pcfg=mini, params=params, bottlenecks=bns,
                            lut=lut, max_new_tokens=3, device=dev)
    out = {}
    _reset_launch_counts()
    for name, policy in (("avery", eng.AdaptivePolicy()),
                         ("static High Accuracy",
                          eng.StaticTierPolicy("High Accuracy"))):
        t0 = time.perf_counter()
        m = run_mission(lut, paper_trace(seed),
                        MissionSpec(policy=policy, seed=seed), executor=ex)
        wall = time.perf_counter() - t0
        ious = [f.iou for f in m.frames]
        log(f"[profile] 13d mission {name}: {len(m.frames)} frames over "
            f"{m.spec.duration_s:.0f} s, {m.mean_pps:.4f} pps, mean IoU "
            f"{m.mean_iou:.4f}, infeasible {m.infeasible_s:.0f} s, tiers "
            f"{sorted(set(f.tier for f in m.frames))}; host wall "
            f"{wall:.2f} s ({card})")
        if not m.frames or not all(0.0 <= x <= 1.0 for x in ious):
            raise AssertionError(f"13d: mission {name} served no frame or "
                                 f"an IoU outside [0, 1]")
        out[name] = {"frames": len(m.frames), "pps": m.mean_pps,
                     "iou": m.mean_iou, "infeasible_s": m.infeasible_s,
                     "wall_s": wall}
    log(f"[profile] 13d: AVERY {out['avery']['pps']:.4f} pps against "
        f"static High Accuracy {out['static High Accuracy']['pps']:.4f} "
        f"(the paper's claim: higher)")
    if not out["avery"]["pps"] > out["static High Accuracy"]["pps"]:
        raise AssertionError("13d: AVERY does not out-deliver static High "
                             "Accuracy")
    t0 = time.perf_counter()
    fleet = run_fleet(lut, paper_trace(seed), FLEET_UAVS,
                      MissionSpec(seed=seed), executor=ex)
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    log(f"[profile] 13d fleet of {FLEET_UAVS}: {fleet.aggregate_pps:.4f} "
        f"pps in all, mean IoU {fleet.mean_iou:.4f}, infeasible share "
        f"{fleet.infeasible_frac:.4f}, {fleet.stats['submitted']} frames "
        f"submitted; host wall {wall:.2f} s ({card}); the missions' and "
        f"fleet's launches {launches} (expected none)")
    if not all(l.frames for l in fleet.logs) or launches != _only():
        raise AssertionError(f"13d: fleet logs or launches {launches}")
    out["fleet"] = {"aggregate_pps": fleet.aggregate_pps,
                    "mean_iou": fleet.mean_iou,
                    "infeasible_frac": fleet.infeasible_frac,
                    "wall_s": wall, "launches": launches}
    wall, lines, launched = _run_module("repro_torch.launch.serve",
                                        SERVE_ARGS)
    served = [ln for ln in lines if " in-flight decode steps" in ln]
    steps = int(served[0].split(" in-flight decode steps")[0]
                .rsplit(" ", 1)[1]) if served else 0
    expect = {"decode_attention": 0,
              "paged_decode_attention": steps * mini.llm.num_layers,
              "paged_verify_attention": 0}
    log(f"[profile] 13d python -m repro_torch.launch.serve "
        f"{' '.join(SERVE_ARGS)}: exit 0 in {wall:.1f} s ({card}), "
        f"launches {launched} (expected {expect})")
    if not steps or launched != expect:
        raise AssertionError(f"13d: serve launches {launched}, expected "
                             f"{expect}")
    out["serve"] = {"wall_s": wall, "steps": steps, "launches": launched}
    wall, lines, launched = _run_module("repro_torch.analysis.sanitizers",
                                        ("--smoke",))
    log(f"[profile] 13d python -m repro_torch.analysis.sanitizers --smoke: "
        f"exit 0 in {wall:.1f} s ({card}), launches {launched}")
    if not any("smoke ok on cuda" in ln for ln in lines) or \
            not launched["paged_decode_attention"] or \
            launched["decode_attention"] or \
            launched["paged_verify_attention"]:
        raise AssertionError(f"13d: sanitizer smoke {lines}, {launched}")
    out["sanitizers_smoke"] = {"wall_s": wall, "launches": launched}
    return out


def profile_overhead(executor, order, device, card):
    """The profiler's cost a decode step: a profiled and a bare engine on
    one executor (PROFILE_TOKENS new tokens, the serving weights), four
    live rows each, PROFILE_TURNS turns in which each makes one warm
    ``engine.pump()`` (in turns A B, B A), each timed on the host clock
    after a synchronise. The cost is each turn's relative difference,
    (profiled - bare) / bare: its median and quartiles, beside the
    reference's 5 % budget. Fails only when the lower quartile exceeds
    it. Beside it, the profiler's own host time in the profiled pumps: each
    profiled call's wall minus the wall of the stage it wraps (the in-call
    difference, which host drift between calls does not move), summed a
    pump."""
    from repro_torch import engine as eng
    from repro_torch.core.streams import DualStreamExecutor
    tx = DualStreamExecutor(pcfg=executor.pcfg, params=executor.params,
                            bottlenecks=executor.bottlenecks,
                            lut=executor.lut, max_new_tokens=PROFILE_TOKENS,
                            flash_decode=True, device=executor.device)
    rows = [o for o in order if o[0].kind == "context"][:INFLIGHT_SLOTS]
    rows += order[:INFLIGHT_SLOTS - len(rows)]
    engines = {}
    for label in ("profiled", "bare"):
        kw = ({"profile": eng.StageProfiler(time.perf_counter,
                                            device=device),
               "wallclock": time.perf_counter}
              if label == "profiled" else {})
        e = eng.AveryEngine(lut=tx.lut, executor=tx, batching="inflight",
                            max_batch=INFLIGHT_SLOTS, **kw)
        for p, q, it in rows:
            e.submit_packet(p, q, it, time_s=0.0)
        e.pump()
        engines[label] = e
    profiler = engines["profiled"].profiler
    real_call, in_call = profiler._call, []

    def timed_call(stage, fn, *rest, **kw):
        inner = []

        def stage_fn(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            inner.append(time.perf_counter() - t0)
            return out
        t0 = time.perf_counter()
        out = real_call(stage, stage_fn, *rest, **kw)
        in_call[-1] += (time.perf_counter() - t0 - inner[0]) * 1e3
        return out

    profiler._call = timed_call
    walls = {"profiled": [], "bare": []}
    try:
        for turn in range(PROFILE_TURNS):
            for label in (("profiled", "bare") if turn % 2 == 0
                          else ("bare", "profiled")):
                if label == "profiled":
                    in_call.append(0.0)
                t0 = _sync_s()
                engines[label].pump()
                walls[label].append((_sync_s() - t0) * 1e3)
    finally:
        del profiler._call
    for label, e in engines.items():
        dec, = e._inflight.values()
        if len(dec.active) != INFLIGHT_SLOTS:
            raise AssertionError(f"overhead: the {label} engine's rows "
                                 f"finished before the last turn")
        e.drain()
    rel = [(p - b) / b for p, b in zip(walls["profiled"], walls["bare"])]
    q1, med, q3 = (float(np.percentile(rel, q)) for q in (25, 50, 75))
    prof_ms, bare_ms = (float(np.median(walls[k]))
                        for k in ("profiled", "bare"))
    c1, cmed, c3 = (float(np.percentile(in_call, q)) for q in (25, 50, 75))
    log(f"[profile] overhead: {PROFILE_TURNS} turns of one profiled and "
        f"one bare engine.pump() on {INFLIGHT_SLOTS} live rows: profiled "
        f"median {prof_ms:.3f} ms, bare {bare_ms:.3f} ms; the profiler's "
        f"cost a step (a turn's (profiled - bare) / bare) median "
        f"{med * 100:+.2f} %, quartiles {q1 * 100:+.2f} to {q3 * 100:+.2f} "
        f"% (budget {PROFILE_OVERHEAD_BUDGET * 100:.0f} %, the reference's;"
        f" fails when the lower quartile exceeds it); the profiler's own "
        f"host time a profiled pump (in-call) median {cmed:.4f} ms, "
        f"quartiles {c1:.4f} to {c3:.4f} ms, {cmed / bare_ms * 100:.3f} % "
        f"of the bare step ({card})")
    if q1 > PROFILE_OVERHEAD_BUDGET:
        raise AssertionError(f"the profiler costs {q1 * 100:.2f} % a step "
                             f"at its lower quartile, over the budget")
    return {"profiled_ms": prof_ms, "bare_ms": bare_ms, "rel_median": med,
            "rel_quartiles": [q1, q3], "in_call_ms": cmed,
            "in_call_quartiles_ms": [c1, c3], "walls": walls,
            "in_call": in_call}


def profile_phase(executor, pcfg, seed, engine_report, order):
    """Phase 13: the stage profiler, cost ledger and sanitizers on phase
    12's executor and frames (13a in flight, 13b speculative, 13c the
    sanitizers and pool growth), the profiler's overhead a step, then 13d
    on a lisa-mini executor."""
    from repro_torch.network import paper_trace
    card = card_line()
    device = card_device(card)
    log(f"[profile] cloud device: {device} ({card})")
    frames = engine_frames(pcfg, seed)
    out = {"device": dataclasses.asdict(device)}
    out["inflight"] = profile_inflight(executor, pcfg, frames,
                                       paper_trace(seed),
                                       engine_report["inflight"], device,
                                       card)
    out["spec"] = profile_spec(executor, pcfg, order,
                               engine_report["spec"], device, card)
    out["sanitizers"] = sanitize_phase(executor, pcfg, order, device, card)
    out["overhead"] = profile_overhead(executor, order, device, card)
    out["lisa_mini"] = lisa_mini_phase(seed, executor.device, card)
    return out


# ---------------------------------------------------------------------------
# phase 11: the zoo's Mamba path (falcon-mamba-7b, zamba2-7b)
# ---------------------------------------------------------------------------

# the two zoo configs of the path, each with its count of parameters (the
# reference's count_params) and its split point
ZOO = {"falcon-mamba-7b": 7_272_665_088, "zamba2-7b": 6_751_130_832}
ZOO_SPLIT = {"falcon-mamba-7b": 32}
ZOO_BATCH = 2
ZOO_PROMPT = 1024
ZOO_DECODE_PROMPT = 64
ZOO_NEW_TOKENS = 4
# decode against prefill on the same prompt: the decode step runs the
# causal conv as one contraction and the recurrence one token at a time,
# where the prefill sums tap by tap and scans; bf16 roundings of the
# layers' outputs differ, as between the LISA paths of SDPA_PATH_RTOL
DECODE_PREFILL_RTOL = 2.0 ** -3


def _within(label, value, limit, tag="zoo"):
    log(f"[{tag}] {label}: {value:.3g} (limit {limit:.3g})")
    if not value <= limit:
        raise AssertionError(f"{label}: {value:.3g} beyond {limit:.3g}")
    return value


def _median_wall_ms(fn, n=3):
    walls = []
    for _ in range(n):
        t0 = _sync_s()
        fn()
        walls.append((_sync_s() - t0) * 1e3)
    return float(np.median(walls)), walls


def zoo_prefill_checks(params, cfg, batch, logits):
    """(a) after the counted prefill: a replay with every scan launch held
    against scan_ref on that launch's own inputs (its outputs are the
    kernel's, so the replay is the counted run again); a replay with
    scan_ref in the kernel's place (logits within PATH_RTOL); the plain
    path, ``use_ssm_kernel=False`` (the doubling scan; logits within
    SDPA_PATH_RTOL)."""
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    from repro_torch.models import prefill_step
    kernel = sops.chunked_scan
    seen = {"launches": 0, "max_abs_err": 0.0, "not_bit_equal": 0,
            "elements": 0}

    def held(decay, drive, **kw):
        h = kernel(decay, drive, **kw)
        torch.cuda.synchronize()
        err, off = scan_held_against(f"{cfg.name} scan launch "
                                     f"{seen['launches']}", h,
                                     sref.scan_ref(decay, drive), SCAN_TOL)
        seen["launches"] += 1
        seen["max_abs_err"] = max(seen["max_abs_err"], err)
        seen["not_bit_equal"] += off
        seen["elements"] += h.numel()
        return h

    with mock.patch.object(sops, "chunked_scan", held):
        again, _ = prefill_step(params, cfg, batch)
    if not torch.equal(again, logits):
        raise AssertionError(f"{cfg.name}: the checked replay's logits "
                             f"differ from the counted run's")
    log(f"[zoo] {cfg.name}: {seen['launches']} scan launches held against "
        f"scan_ref on their own inputs: max_abs_err "
        f"{seen['max_abs_err']:.3g} (rtol {SCAN_TOL[0]}, atol "
        f"{SCAN_TOL[1]}), {seen['not_bit_equal']} of {seen['elements']} "
        f"elements not bit-equal")
    with mock.patch.object(sops, "chunked_scan",
                           lambda d, x, **kw: sref.scan_ref(d, x)):
        plain, _ = prefill_step(params, cfg, batch)
    before = sops.scan_launches
    sdpa, _ = prefill_step(params, cfg.replace(use_ssm_kernel=False), batch)
    if sops.scan_launches != before:
        raise AssertionError(f"{cfg.name}: use_ssm_kernel=False launched "
                             f"the scan kernel")
    return {"per_launch": seen,
            "plain_replay_rel": _within(
                f"{cfg.name} last logits vs scan_ref replay (norm-wise)",
                _rel(logits, plain), PATH_RTOL),
            "plain_path_rel": _within(
                f"{cfg.name} last logits vs use_ssm_kernel=False "
                f"(norm-wise)", _rel(logits, sdpa), SDPA_PATH_RTOL)}


def zoo_decode(params, cfg, prompt, dev):
    """(b) the prompt through ``decode_step`` from ``init_cache`` (the
    reference's prefill hands SSM state to nothing), then
    ZOO_NEW_TOKENS greedy tokens fed back; counters from 0. The logits at
    the prompt's last position against ``prefill_step``'s."""
    from repro_torch.models import decode_step, init_cache, prefill_step
    S = prompt.shape[1]
    cache = init_cache(cfg, ZOO_BATCH, S + ZOO_NEW_TOKENS, dev)
    _reset_launch_counts()
    t0 = _sync_s()
    new, last = [], None
    for t in range(S + ZOO_NEW_TOKENS):
        tok = prompt[:, t:t + 1] if t < S else new[t - S]
        lg, cache = decode_step(params, cfg, cache, tok, t)
        if t == S - 1:
            last = lg
        if t >= S - 1 and len(new) < ZOO_NEW_TOKENS:
            new.append(torch.argmax(lg[:, -1], dim=-1)[:, None].int())
    wall = _sync_s() - t0
    counts = _launch_counts()
    if counts != _only():
        raise AssertionError(f"{cfg.name} decode launched port kernels: "
                             f"{counts}")
    tokens = torch.cat(new, dim=1)
    if not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name}: decoded token out of range")
    if not bool(torch.isfinite(last).all()):
        raise AssertionError(f"{cfg.name}: non-finite decode logits")
    want, _ = prefill_step(params, cfg, {"tokens": prompt})
    log(f"[zoo] {cfg.name} decode: prompt {S} + {ZOO_NEW_TOKENS} greedy "
        f"tokens in {wall:.2f} s, no kernel launches, tokens "
        f"{tokens.tolist()}")
    return {"steps": S + ZOO_NEW_TOKENS, "wall_s": wall,
            "tokens": tokens.tolist(),
            "vs_prefill_rel": _within(
                f"{cfg.name} decode logits at position {S - 1} vs "
                f"prefill_step (norm-wise)", _rel(last, want),
                DECODE_PREFILL_RTOL)}


def zoo_split(params, cfg, batch, k):
    """(c) ``SplitPlan(cfg, k)``: head_apply then tail_apply over the
    embedded prompt, counters from 0: k + (L - k) scan launches, the
    hidden state equal to ``forward``'s, the weights shared."""
    from repro_torch.core import SplitPlan
    from repro_torch.models import forward
    from repro_torch.models.common import causal_mask
    from repro_torch.models.model import _embed_inputs
    plan = SplitPlan(cfg, k)
    edge, cloud = plan.split_params(params)
    w = params["groups"][0]["mixer"]["in_proj"]
    if edge["groups"][0]["mixer"]["in_proj"].data_ptr() != w.data_ptr() \
            or cloud["groups"][0]["mixer"]["in_proj"].data_ptr() \
            != w[k].data_ptr():
        raise AssertionError("SplitPlan copied the weights")
    _, _, _, hidden = forward(params, cfg, batch)
    x, positions = _embed_inputs(params, cfg, batch)
    mask = causal_mask(x.shape[1], device=x.device)[None]
    _reset_launch_counts()
    mid = plan.head_apply(edge, x, positions, mask)
    torch.cuda.synchronize()
    head = _launch_counts()["ssm_scan"]
    out = plan.tail_apply(cloud, mid, positions, mask)
    torch.cuda.synchronize()
    counts = _launch_counts()
    want = _only(ssm_scan=cfg.num_layers)
    if head != k or counts != want:
        raise AssertionError(f"{cfg.name} split@{k}: {head} head launches "
                             f"(expected {k}), counts {counts}")
    log(f"[zoo] {cfg.name} split@{k}: {head} + {counts['ssm_scan'] - head} "
        f"scan launches, weights shared")
    return {"split_layer": k, "launches": {"head": head,
                                           "tail": counts["ssm_scan"] - head},
            "hidden_rel": _within(f"{cfg.name} split@{k} hidden vs "
                                  f"forward (norm-wise)",
                                  _rel(out, hidden), PATH_RTOL)}


def zoo_run(name, seed, dev):
    """Phase 11 for one zoo config: init at full width, the counted
    prefill (a) and its checks, decode (b), split (c) where the config
    has a split point, and timings (e). Frees nothing itself: the
    caller drops its references."""
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill_step, stack)
    cfg = get_config(name).replace(use_ssm_kernel=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = _sync_s()
    params = init_params(cfg, gen, dev)
    init_s = _sync_s() - t0
    n_params = sum(t.numel() for t in stack.leaves(params))
    if n_params != ZOO[name]:
        raise AssertionError(f"{name}: {n_params} parameters, expected "
                             f"{ZOO[name]}")
    nbytes = sum(t.numel() * t.element_size() for t in stack.leaves(params))
    log(f"[zoo] {name}: {n_params:,} parameters ({nbytes / 1e9:.2f} GB "
        f"bf16) initialised in {init_s:.1f} s")
    tokens = torch.randint(0, cfg.vocab_size, (ZOO_BATCH, ZOO_PROMPT),
                           generator=gen, device=dev)
    batch = {"tokens": tokens}
    layers = cfg.num_layers

    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = _sync_s()
    logits, cache = prefill_step(params, cfg, batch)
    wall = _sync_s() - t0
    counts = _launch_counts()
    if counts != _only(ssm_scan=layers):
        raise AssertionError(f"{name} prefill: launches {counts}, expected "
                             f"{layers} ssm_scan and no other")
    if tuple(logits.shape) != (ZOO_BATCH, 1, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: last logits {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    log(f"[zoo] {name} prefill B={ZOO_BATCH} S={ZOO_PROMPT}: {layers} "
        f"ssm_scan launches (expected {layers}), other kernels 0; last "
        f"logits {tuple(logits.shape)} finite; wall {wall:.2f} s (first "
        f"call), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    out = {"params": n_params, "init_s": init_s, "first_prefill_s": wall,
           "launches": counts, "logits_shape": list(logits.shape),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del cache
    out["prefill"] = zoo_prefill_checks(params, cfg, batch, logits)
    out["decode"] = zoo_decode(params, cfg, tokens[:, :ZOO_DECODE_PROMPT],
                               dev)
    if name in ZOO_SPLIT:
        out["split"] = zoo_split(params, cfg, batch, ZOO_SPLIT[name])

    # (e) timings: a warm prefill and one decode step, wall to a
    # synchronise, median of 3; one traced prefill (falcon-mamba-7b)
    out["prefill_wall_ms"], walls = _median_wall_ms(
        lambda: prefill_step(params, cfg, batch))
    cache = init_cache(cfg, ZOO_BATCH, ZOO_DECODE_PROMPT, dev)
    tok = tokens[:, :1]
    decode_step(params, cfg, cache, tok, 0)
    pos = itertools.count(1)
    out["decode_step_wall_ms"], dwalls = _median_wall_ms(
        lambda: decode_step(params, cfg, cache, tok, next(pos)))
    log(f"[zoo] {name}: warm prefill wall {out['prefill_wall_ms']:.1f} ms "
        f"(median of {[round(w, 1) for w in walls]}), decode step wall "
        f"{out['decode_step_wall_ms']:.2f} ms (median of "
        f"{[round(w, 2) for w in dwalls]})")
    if name == "falcon-mamba-7b":
        out["profile"] = trace(f"{name} prefill B={ZOO_BATCH} "
                               f"S={ZOO_PROMPT}",
                               lambda: prefill_step(params, cfg, batch),
                               attempts=TRACE_ATTEMPTS)
        out["decode_profile"] = trace(
            f"{name} decode step B={ZOO_BATCH}",
            lambda: decode_step(params, cfg, cache, tok, next(pos)),
            attempts=TRACE_ATTEMPTS)
    return out


def zoo_phase(seed, dev):
    """Phase 11: each zoo config in turn, freed before the next."""
    report = {}
    for name in ZOO:
        report[name] = zoo_run(name, seed, dev)
        gc.collect()
        torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 14: the attention and MoE zoo (granite-moe-3b-a800m, qwen2-vl-2b,
# minicpm3-4b, hubert-xlarge, the deepseek-v3-671b cut)
# ---------------------------------------------------------------------------

# each config of the phase with its count of parameters and of active
# parameters (the reference's count_params, total and active_only)
ZOO14 = {
    "granite-moe-3b-a800m": (3_374_295_552, 958_376_448),
    "qwen2-vl-2b": (1_779_054_080, 1_779_054_080),
    "minicpm3-4b": (4_261_902_848, 4_261_902_848),
    "hubert-xlarge": (945_912_320, 945_912_320),
    "deepseek-v3-671b": (14_278_064_128, 3_356_096_512),
}
# deepseek-v3-671b at full widths, its depth cut to 2 layers: one dense MLA
# layer and one MoE layer (256 routed experts, top-8, and the shared
# expert), with its MTP block's parameters
ZOO14_CUT = {"deepseek-v3-671b": {"num_layers": 2, "first_k_dense": 1}}
# the two GQA models, served through the flash and decode kernels (G = 3
# and 6); the others take neither (MLA, a non-causal encoder)
ZOO14_GQA = ("granite-moe-3b-a800m", "qwen2-vl-2b")
ZOO14_NEW_TOKENS = 8
ZOO14_CHUNK = 256
ZOO14_CHUNKED = ("granite-moe-3b-a800m", "minicpm3-4b")
# A MoE model's outputs follow its routing: a token that takes another
# expert (a routing flip at a near tie) changes by that expert's share, and
# the change spreads, so two runs that differ in rounding soon differ in
# routing (a random granite at 4 layers on the CPU: 481 of 2048 tokens);
# with the experts pinned but each run's own gate values, the random
# granite's large expert outputs still carry the gates' rounding into a
# router drift of 0.112 by layer 32 on an H100 (PERF.md §6). The path
# comparisons of phase 14 therefore pin the other run's routing to the
# kernel run's (``_pinned_router``: each moe layer takes the kernel run's
# top-k experts and gate values) and hold the routing apart: at each moe
# layer of the pinned run, a token whose own top-k set would differ from the
# kernel run's (a flip) must sit at a near tie in both runs' router logits,
# its k-th and (k+1)-th within ROUTE_TIE_RUN (absolute; the random routers'
# logits are about N(0, 1), whose spacing at the 8th of 40 is about 0.09),
# and the layer's router logits must agree with the kernel run's within
# SDPA_PATH_RTOL (norm-wise), the drift of the stream they are computed on.
ROUTE_TIE_RUN = 2.0 ** -2
# the traced prefill's extra class: sorts, scans, index, gather and
# scatter kernels (the MoE dispatch's ranks and one-hots, the scatter and
# the gather of expert outputs; also the embedding lookup)
DISPATCH_CLASS = {"dispatch_gather": ("sort", "scan", "index", "gather",
                                      "scatter", "one_hot", "cumsum")}


def zoo14_kernel_cases():
    """The flash kernel at phase 14's prefill shapes (B = 2, S = 1,024,
    causal, bf16) and the decode kernel at its last decode step's (B = 2,
    W = 64 + 8 slots, all filled) for the two GQA models: (flash cases,
    decode cases)."""
    from repro_torch.configs import get_config
    W = ZOO_DECODE_PROMPT + ZOO14_NEW_TOKENS
    flash, decode = [], []
    for name in ZOO14_GQA:
        c = get_config(name)
        short = name.split("-")[0]
        H, K, hd = c.num_heads, c.num_kv_heads, c.resolved_head_dim
        flash.append(dict(name=f"zoo_{short}_B{ZOO_BATCH}_S{ZOO_PROMPT}",
                          B=ZOO_BATCH, S=ZOO_PROMPT, H=H, K=K, hd=hd,
                          causal=True, dtype=c.adtype, pad=0))
        decode.append(dict(name=f"zoo_{short}_B{ZOO_BATCH}_W{W}",
                           B=ZOO_BATCH, H=H, K=K, hd=hd, W=W,
                           dtype=c.adtype, lens=[W] * ZOO_BATCH))
    return flash, decode


# phase 3 at the head sizes that no LISA path takes: each (H, K) a config
# of the repo gives with it (SAM ViT-H and hubert-xlarge at 80, zamba2-7b
# at 112, nemotron-4-340b at 192)
HD_HEADS = {80: (16, 16), 112: (32, 32), 192: (96, 8)}


def head_dim_cases():
    """The four attention kernels at hd 80, 112 and 192: {kernel: cases},
    each case with ``timed`` and drawing from a generator of its own
    (``case_rng``), so the cases before them keep their inputs. Flash:
    zamba2-7b's and nemotron-4-340b's prefill (B = 2, S = 1,024, causal)
    and SAM's tail (B = 1, S = 4,096, not causal), timed; at each new size
    bf16 causal at an odd S with NaN past S (G = 4), and float32 at a small
    shape, causal and not. Decode: each size's heads at phase 20's last
    decode step (B = 2, W = 72; timed), once with lengths spread from 1 to
    W over 4 rows, and float32 with an idle row. Paged decode (pages of
    16) and verify (C = 4, pages of 4): each size's heads over a random
    table, lengths spread, in bf16 (timed) and float32."""
    bf16, f32 = torch.bfloat16, torch.float32
    W = ZOO_DECODE_PROMPT + ZOO14_NEW_TOKENS
    flash = [dict(name="hd112_zamba2_B2_S1024", B=2, S=1024, H=32, K=32,
                  hd=112, causal=True, dtype=bf16, pad=0, timed=True),
             dict(name="hd192_nemotron_B2_S1024", B=2, S=1024, H=96, K=8,
                  hd=192, causal=True, dtype=bf16, pad=0, timed=True),
             dict(name="hd80_sam_B1_S4096_full", B=1, S=4096, H=16, K=16,
                  hd=80, causal=False, dtype=bf16, pad=0, timed=True)]
    decode, paged, verify = [], [], []
    for hd, (H, K) in HD_HEADS.items():
        flash.append(dict(name=f"hd{hd}_bf16_B2_S777_G4_causal_nan_past_S",
                          B=2, S=777, H=8, K=2, hd=hd, causal=True,
                          dtype=bf16, pad=40))
        for causal in (True, False):
            flash.append(dict(
                name=f"hd{hd}_float32_B2_S200_G2_"
                     f"{'causal' if causal else 'full'}",
                B=2, S=200, H=4, K=2, hd=hd, causal=causal, dtype=f32,
                pad=0))
        base = dict(H=H, K=K, hd=hd)
        decode += [
            dict(base, name=f"hd{hd}_B2_W{W}", B=2, W=W, dtype=bf16,
                 lens=[W, W], timed=True),
            dict(base, name=f"hd{hd}_B4_W{W}_ragged", B=4, W=W, dtype=bf16,
                 lens=np.linspace(1, W, 4).astype(int).tolist()),
            dict(base, name=f"hd{hd}_fp32_B3_W100_idle_row", B=3, W=100,
                 dtype=f32, lens=[0, 37, 100])]
        rng = np.random.RandomState(hd)
        for dtype in (bf16, f32):
            dt = "bf16" if dtype == bf16 else "fp32"
            P, page, n = 12, 16, 5
            lens = np.linspace(1, n * page, 3).astype(int)
            paged.append(dict(
                base, name=f"hd{hd}_{dt}_B3_page{page}", B=3, P=P,
                page=page, table=rng.randint(0, P, (3, n)),
                valid=np.arange(n * page)[None] < lens[:, None],
                dtype=dtype, timed=dtype == bf16))
            P, page, n, C = 40, 4, 20, 4
            lens = rng.randint(1, n * page + 1, (3, C))
            verify.append(dict(
                base, name=f"hd{hd}_{dt}_B3_C{C}_page{page}", B=3, C=C, P=P,
                page=page, table=rng.randint(0, P, (3, n)),
                valid=np.arange(n * page)[None, None] < lens[..., None],
                dtype=dtype, timed=dtype == bf16))
    return {"flash_attention": flash, "decode_attention": decode,
            "paged_decode_attention": paged,
            "paged_verify_attention": verify}


def zoo14_config(name):
    """The phase's config: full widths, ``use_flash`` and
    ``use_flash_decode`` on, and the cut of ZOO14_CUT."""
    from repro_torch.configs import get_config
    cfg = get_config(name).replace(use_flash=True, use_flash_decode=True)
    cut = ZOO14_CUT.get(name)
    if cut:
        cfg = cfg.replace(num_layers=cut["num_layers"],
                          moe=dataclasses.replace(
                              cfg.moe, first_k_dense=cut["first_k_dense"]))
    return cfg


def _moe(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


def zoo14_batch(cfg, gen, dev):
    """ZOO_BATCH inputs of ZOO_PROMPT positions in the model's batch format
    (tests/helpers.py:make_batch's keys and shapes), from the seed: text
    tokens; audio frames (B, S, 512); the VLM's tokens, 256 vision
    embeddings (B, 256, 1280) and M-RoPE positions (3, B, S), the vision
    tokens on a (t = 0, h, w) 16 x 16 grid and the text after it, one
    position for all three streams."""
    B, seq = ZOO_BATCH, ZOO_PROMPT
    if cfg.modality == "audio":
        return {"frames": torch.randn(B, seq, cfg.frontend_dim,
                                      generator=gen, device=dev)}
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, seq),
                                     generator=gen, device=dev)}
    if cfg.modality == "vlm":
        nv = cfg.num_vision_tokens
        side = int(round(nv ** 0.5))
        batch["vision_embeds"] = torch.randn(B, nv, cfg.frontend_dim,
                                             generator=gen, device=dev)
        i = torch.arange(nv, device=dev)
        pos = torch.zeros((3, B, seq), dtype=torch.int32, device=dev)
        pos[1, :, :nv], pos[2, :, :nv] = i // side, i % side
        pos[:, :, nv:] = side + torch.arange(seq - nv, device=dev)
        batch["positions"] = pos
    return batch


def _text_prefill_batch(cfg, prompt):
    """What ``decode_step`` computes over ``prompt`` as one prefill: the
    tokens alone, and for the VLM no vision tokens and M-RoPE's three
    streams at one position each (as decode broadcasts it). Returns
    (cfg, batch)."""
    if cfg.modality != "vlm":
        return cfg, {"tokens": prompt}
    B, S = prompt.shape
    pos = torch.arange(S, dtype=torch.int32, device=prompt.device)
    return cfg.replace(num_vision_tokens=0), {
        "tokens": prompt, "positions": pos.expand(3, B, S).contiguous(),
        "vision_embeds": torch.zeros((B, 0, cfg.frontend_dim),
                                     device=prompt.device)}


def _routes(run):
    """``run()`` with every router call recorded: (its result, a list of
    (gate_idx, router logits) a moe layer)."""
    from repro_torch.models import moe as moe_lib
    record = []
    with mock.patch.object(moe_lib, "_router", _recording_router(record)):
        out = run()
    return out, record


def pinned_run(routes, run):
    """``run()`` with its routing pinned to ``routes`` (``_pinned_router``):
    (its result, its own routing choices). Every recorded route must be
    taken, and no more."""
    from repro_torch.models import moe as moe_lib
    own = []
    with mock.patch.object(moe_lib, "_router", _pinned_router(routes, own)):
        out = run()
    if len(own) != len(routes):
        raise AssertionError(f"the pinned run routed {len(own)} times, the "
                             f"recorded one {len(routes)}")
    return out, own


def zoo14_route_flips(label, kernel_routes, own_routes):
    """The routing of a run pinned to the kernel run's, held apart: at each
    moe layer (or step and layer) the tokens whose own top-k set would
    differ from the kernel run's, each at a near tie in both runs' router
    logits (ROUTE_TIE_RUN), and the router logits within SDPA_PATH_RTOL of
    the kernel run's (ROUTE_TIE_RUN's comment)."""
    per_layer, flips, drift = [], [], []
    for j, (a, b) in enumerate(zip(kernel_routes, own_routes)):
        _, fl = route_flips(a, b)
        per_layer.append(len(fl))
        flips += [dict(f, layer=j) for f in fl]
        drift.append(_rel(b[1], a[1]))
    T = kernel_routes[0][0].shape[0]
    bad = [f for f in flips if not max(f["gaps"]) <= ROUTE_TIE_RUN]
    gaps = sorted(max(f["gaps"]) for f in flips)
    log(f"[zoo14] {label}: routing flips (a token's own top-k set against "
        f"the kernel run's, routing pinned) {len(flips)} of "
        f"{T * len(per_layer)} token-layers ("
        + (f"per layer {per_layer}" if len(per_layer) <= 64 else
           f"{sum(n > 0 for n in per_layer)} of {len(per_layer)} layer "
           f"calls with any")
        + "); each "
        f"flip's larger boundary gap of the two runs: median "
        f"{np.median(gaps) if gaps else 0:.3g}, max "
        f"{gaps[-1] if gaps else 0:.3g} (limit {ROUTE_TIE_RUN}); router "
        f"logits against the kernel run's, worst layer {max(drift):.3g} "
        f"(limit {SDPA_PATH_RTOL})")
    if bad:
        raise AssertionError(f"{label}: {len(bad)} routing flips are no "
                             f"near tie: {bad[:4]}")
    _within(f"{label} router logits vs the kernel run's, worst layer",
            max(drift), SDPA_PATH_RTOL)
    return {"flips": len(flips), "token_layers": T * len(per_layer),
            "per_layer": per_layer, "max_gap": gaps[-1] if gaps else 0.0,
            "gap_limit": ROUTE_TIE_RUN, "router_drift": max(drift)}


def zoo14_dispatch(params, cfg, batch):
    """(e) granite's prefill (einsum dispatch), and at each moe layer, on
    that layer's input, ``moe_mlp`` once more under "scatter" and
    "grouped": the routing equal to einsum's and the output within
    LAYER_RTOL of einsum's; grouped keeps per row (capacity
    ``capacity(cfg, S)``), so it is held on the tokens whose kept slots
    agree with einsum's."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import prefill_step
    mlp, readings = moe_lib.moe_mlp, []

    def kept(gate_idx, groups, C):
        return moe_lib._scatter_plan(gate_idx.reshape(groups, -1),
                                     cfg.moe.num_experts, C)[1]

    def checked(p, c, x):
        (out, aux), rec = _routes(lambda: mlp(p, c, x))
        B, S, d = x.shape
        gate = rec[0][0]
        # the tokens whose kept slots agree under the two capacities
        same = (kept(gate, 1, moe_lib.capacity(c, B * S)).reshape(B * S, -1)
                == kept(gate, B, moe_lib.capacity(c, S)).reshape(B * S, -1)
                ).all(dim=-1)
        r = {}
        for mode, tokens in (("scatter", slice(None)), ("grouped", same)):
            c2 = _moe(c, dispatch=mode)
            (y, _), rec2 = _routes(lambda: mlp(p, c2, x))
            if not torch.equal(rec2[0][0], gate):
                raise AssertionError(f"{c.name}: {mode} dispatch routed "
                                     f"otherwise than einsum")
            r[mode] = {"rel": _rel(y.reshape(-1, d)[tokens],
                                   out.reshape(-1, d)[tokens]),
                       "bit_equal": bool(torch.equal(y, out))}
        r["grouped"]["kept_differs"] = int((~same).sum())
        readings.append(r)
        return out, aux

    with mock.patch.object(moe_lib, "moe_mlp", checked):
        prefill_step(params, cfg, batch)
    worst = {m: max(r[m]["rel"] for r in readings)
             for m in ("scatter", "grouped")}
    equal = {m: sum(r[m]["bit_equal"] for r in readings)
             for m in ("scatter", "grouped")}
    differs = sum(r["grouped"]["kept_differs"] for r in readings)
    log(f"[zoo14] {cfg.name} dispatch on each of {len(readings)} moe "
        f"layers' inputs: routing identical in all three modes; against "
        f"einsum, scatter {worst['scatter']:.3g} ({equal['scatter']} layers "
        f"bit-equal), grouped {worst['grouped']:.3g} (per-row capacity: "
        f"kept slots differ on {differs} token-layers, held on the rest; "
        f"{equal['grouped']} bit-equal) (limit {LAYER_RTOL})")
    for m in worst:
        _within(f"{cfg.name} {m} vs einsum, worst moe layer (norm-wise)",
                worst[m], LAYER_RTOL)
    return {"layers": len(readings), "worst": worst,
            "grouped_kept_differs": differs, "bit_equal_layers": equal,
            "limit": LAYER_RTOL}


def zoo14_chunk(params, cfg, batch):
    """(e) ``attn_chunk=ZOO14_CHUNK`` against unchunked attention: on each
    attention layer's input of an unchunked plain prefill (use_flash off,
    so the chunked branch is reached), the chunked attention's output
    within LAYER_RTOL of the unchunked one's."""
    from repro_torch.models import attention, prefill_step
    full, readings = attention.attn_full, []
    plain = cfg.replace(use_flash=False)
    chunked = plain.replace(attn_chunk=ZOO14_CHUNK)

    def checked(p, c, x, positions, mask):
        out, kv = full(p, c, x, positions, mask)
        out_c, _ = full(p, chunked, x, positions, mask)
        readings.append((_rel(out_c, out), bool(torch.equal(out_c, out))))
        return out, kv

    with mock.patch.object(attention, "attn_full", checked):
        prefill_step(params, plain, batch)
    worst = max(r for r, _ in readings)
    log(f"[zoo14] {cfg.name} attn_chunk={ZOO14_CHUNK} vs unchunked on each "
        f"of {len(readings)} attention layers' inputs: worst {worst:.3g}, "
        f"{sum(e for _, e in readings)} bit-equal (limit {LAYER_RTOL})")
    _within(f"{cfg.name} attn_chunk={ZOO14_CHUNK} worst layer", worst,
            LAYER_RTOL)
    return {"layers": len(readings), "worst": worst,
            "bit_equal": sum(e for _, e in readings)}


def zoo14_decode(params, cfg, prompt, dev, forced=None):
    """The prompt through ``decode_step`` from ``init_cache``, then
    ZOO14_NEW_TOKENS greedy tokens fed back (or, teacher-forced, the
    tokens ``forced`` (B, new)): (the greedy tokens (B, new), the last
    logits of each step from the prompt's last on, as float32)."""
    from repro_torch.models import decode_step, init_cache
    S = prompt.shape[1]
    cache = init_cache(cfg, ZOO_BATCH, S + ZOO14_NEW_TOKENS, dev)
    new, logits = [], []
    fed = new if forced is None else list(forced.split(1, dim=1))
    for t in range(S + ZOO14_NEW_TOKENS):
        tok = prompt[:, t:t + 1] if t < S else fed[t - S]
        lg, cache = decode_step(params, cfg, cache, tok, t)
        if t >= S - 1:
            logits.append(lg[:, -1].float())
            if len(new) < ZOO14_NEW_TOKENS:
                new.append(torch.argmax(lg[:, -1], dim=-1)[:, None].int())
    return torch.cat(new, dim=1), logits


def decode_ties(label, tokens, logits, other_tokens, other_logits, limit,
                tag="zoo14", control=None):
    """Each row's greedy tokens against another path's: equal, or first
    differing at a near tie (12c's rule): at that token the two runs'
    logits (on the same prefix) must each lead with its own token, each of
    the two tokens' logits must move between the runs by at most its
    scale, and their margin by at most its own, the rows within ``limit``
    norm-wise; at most MAX_TIES rows. ``logits[d][b]``: row b's logits
    that predict its token d. A logit's scale is TIE_ULPS bf16 steps at
    its magnitude, the margin's twice that at the larger (which the leads
    and the two logits' scales already imply). With ``control`` (runs with
    no kernel, teacher-forced on the same tokens and indexed as
    ``logits``), the other run, which has no kernel either, joins them, and
    each scale is the larger of that and ZOO20_CONTROL_RATIO times the
    largest move of the same logit or margin between two of these runs at
    that step and row: how far a change of rounding with no kernel moves
    it."""
    ties = []
    for b in range(tokens.shape[0]):
        x, y = tokens[b].tolist(), other_tokens[b].tolist()
        if x == y:
            continue
        d = next(i for i, (u, v) in enumerate(zip(x, y)) if u != v)
        A = logits[d][b].double().cpu().numpy()
        P = other_logits[d][b].double().cpu().numpy()
        a, o = x[d], y[d]
        step = {t: _bf16_step(max(abs(A[t]), abs(P[t]))) for t in (a, o)}
        top = max(step.values())
        tie = {"row": b, "token": d, "kernel": a, "other": o,
               "margin": float(P[o] - P[a]),
               "kernel_margin": float(A[a] - A[o]),
               "ulps_kernel_token": _bf16_steps(A[a], P[a]),
               "ulps_other_token": _bf16_steps(A[o], P[o]),
               "ulps_margin": float((A[a] - A[o]) - (P[a] - P[o])) / top,
               "kernel_leads": bool(A[a] >= A.max()),
               "other_leads": bool(P[o] >= P.max()), "rel": _rel(A, P)}
        scale = {"kernel_token": TIE_ULPS, "other_token": TIE_ULPS,
                 "margin": 2 * TIE_ULPS}
        if control is not None:
            runs = [P] + [c[d][b].double().cpu().numpy() for c in control]
            tie["no_kernel_margins"] = [float(r[a] - r[o]) for r in runs]
            moves = {k: max(abs(f(r) - f(q)) for r in runs for q in runs)
                     for k, f in (("kernel_token", lambda r: r[a]),
                                  ("other_token", lambda r: r[o]),
                                  ("margin", lambda r: r[a] - r[o]))}
            tie["control_moves"] = {k: float(v) for k, v in moves.items()}
            per = {"kernel_token": step[a], "other_token": step[o],
                   "margin": top}
            scale = {k: max(v, float(ZOO20_CONTROL_RATIO * moves[k] / per[k]))
                     for k, v in scale.items()}
        tie["scale_ulps"] = scale
        near = all(tie[f"ulps_{k}"] <= v for k, v in scale.items())
        ties.append(tie)
        log(f"[{tag}] {label}: row {b} tokens {x} vs {y}, first differing "
            f"at token {d}: margin {tie['margin']:.4g} of {o} over {a}, the "
            f"kernel run's {tie['kernel_margin']:.4g}; the runs apart by "
            f"{tie['ulps_kernel_token']:.3g} and "
            f"{tie['ulps_other_token']:.3g} bf16 steps at the two tokens "
            f"and {tie['ulps_margin']:.3g} at the margin (scales "
            f"{scale['kernel_token']:.3g}, {scale['other_token']:.3g}, "
            f"{scale['margin']:.3g}"
            + ("" if control is None else
               f"; the runs with no kernel move them up to "
               f"{tie['control_moves']['kernel_token']:.4g}, "
               f"{tie['control_moves']['other_token']:.4g}, "
               f"{tie['control_moves']['margin']:.4g}, their margins of {a} "
               f"over {o} "
               + ", ".join(f"{m:.4g}" for m in tie["no_kernel_margins"]))
            + f"), each leads its own logits: {tie['kernel_leads']}, "
            f"{tie['other_leads']}; norm-wise {tie['rel']:.3g} (limit "
            f"{limit})")
        if not (tie["kernel_leads"] and tie["other_leads"] and near
                and tie["rel"] <= limit):
            raise AssertionError(f"{label}: row {b} differs beyond a near "
                                 f"tie: {tie}")
    if len(ties) > MAX_TIES:
        raise AssertionError(f"{label}: {len(ties)} rows differ, more than "
                             f"{MAX_TIES}")
    return ties


def zoo14_decode_checks(params, cfg, prompt, dev, gqa):
    """(d) greedy decode with use_flash_decode, counters from 0: decode
    launches steps x layers on the GQA models, none on the others; on the
    GQA models the tokens against use_flash_decode=False, teacher-forced on
    the kernel run's tokens, with its routing (experts and gates; near ties
    under 12c's rule, routing flips held to ROUTE_TIE_RUN), and every
    decode layer of a replay with the kernel's plain version held to
    LAYER_RTOL (``layer_check`` "decode"); the logits at the prompt's last
    position against one prefill of the same tokens with the decode run's
    routing (DECODE_PREFILL_RTOL; MLA's absorbed decode against its full
    form; an MoE config with a capacity that drops nothing, as decode at
    T = B never drops)."""
    from repro_torch.models import prefill_step, stack
    S = prompt.shape[1]
    steps = S + ZOO14_NEW_TOKENS
    _reset_launch_counts()
    t0 = _sync_s()
    (tokens, logits), routes = _routes(lambda: zoo14_decode(params, cfg,
                                                            prompt, dev))
    wall = _sync_s() - t0
    counts = _launch_counts()
    want = _only(decode_attention=steps * cfg.num_layers if gqa else 0)
    log(f"[zoo14] {cfg.name} decode: prompt {S} + {ZOO14_NEW_TOKENS} greedy "
        f"tokens, {steps} steps in {wall:.2f} s; launches {counts} "
        f"(expected {want}); tokens {tokens.tolist()}")
    if counts != want:
        raise AssertionError(f"{cfg.name} decode: launches {counts}, "
                             f"expected {want}")
    if not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()) \
            or not all(bool(torch.isfinite(lg).all()) for lg in logits):
        raise AssertionError(f"{cfg.name}: bad decode tokens or logits")
    out = {"steps": steps, "wall_s": wall, "launches": counts,
           "tokens": tokens.tolist()}
    if gqa:     # MLA decode takes no kernel: use_flash_decode changes nothing
        (plain_tokens, plain_logits), own = pinned_run(routes, lambda: (
            zoo14_decode(params, cfg.replace(use_flash_decode=False),
                         prompt, dev, forced=tokens)))
        out["ties"] = decode_ties(
            f"{cfg.name} decode vs use_flash_decode=False", tokens, logits,
            plain_tokens, plain_logits, SDPA_PATH_RTOL)
        log(f"[zoo14] {cfg.name}: {ZOO_BATCH - len(out['ties'])} of "
            f"{ZOO_BATCH} rows' tokens equal use_flash_decode=False's")
        if routes:
            out["route_flips"] = zoo14_route_flips(
                f"{cfg.name} decode, use_flash_decode=False", routes, own)
        _, out["layers"] = layer_check(
            "decode", f"{cfg.name} decode", lambda: zoo14_decode(
                params, cfg, prompt, dev))
    pcfg, pbatch = _text_prefill_batch(cfg, prompt)
    n_moe = sum(g.count for g in stack.layer_groups(cfg) if g.kind == "moe")
    pre = [tuple(torch.stack([routes[t * n_moe + j][i] for t in range(S)],
                             dim=1).reshape(ZOO_BATCH * S, -1)
                 for i in (0, 1)) for j in range(n_moe)]
    if cfg.moe is not None:
        pcfg = _moe(pcfg, capacity_factor=cfg.moe.num_experts
                    / cfg.moe.top_k)
    (want_logits, _), _ = pinned_run(pre, lambda: prefill_step(
        params, pcfg, pbatch))
    out["vs_prefill_rel"] = _within(
        f"{cfg.name} decode logits at position {S - 1} vs one prefill "
        f"(norm-wise)", _rel(logits[0], want_logits[:, -1].float()),
        DECODE_PREFILL_RTOL)
    return out


def zoo14_run(name, seed, dev):
    """Phase 14 for one config: init at full width (a), the counted
    prefill (b), the kernel checks against the plain path (c), decode (d),
    the same function two ways (e) and timings (f). Frees nothing itself:
    the caller drops its references."""
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill_step, stack)
    cfg = zoo14_config(name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = _sync_s()
    params = init_params(cfg, gen, dev)
    init_s = _sync_s() - t0
    n_params = sum(t.numel() for t in stack.leaves(params))
    active = stack.count_params(cfg, active_only=True)
    if (n_params, active) != ZOO14[name] \
            or stack.count_params(cfg) != n_params:
        raise AssertionError(f"{name}: {n_params} parameters, {active} "
                             f"active, expected {ZOO14[name]}")
    nbytes = sum(t.numel() * t.element_size() for t in stack.leaves(params))
    cut = ZOO14_CUT.get(name)
    log(f"[zoo14] {name}: {n_params:,} parameters ({active:,} active; "
        f"{nbytes / 1e9:.2f} GB) initialised in {init_s:.1f} s"
        + (f"; depth cut: {cut}" if cut else ""))
    batch = zoo14_batch(cfg, gen, dev)
    layers = cfg.num_layers
    gqa = name in ZOO14_GQA

    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = _sync_s()
    (logits, cache), routes = _routes(lambda: prefill_step(params, cfg,
                                                           batch))
    wall = _sync_s() - t0
    counts = _launch_counts()
    want = _only(flash_attention=layers if gqa else 0)
    S = ZOO_PROMPT
    shape = (ZOO_BATCH, S if cfg.modality == "audio" else 1, cfg.vocab_size)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[zoo14] {name} prefill B={ZOO_BATCH} S={S}: launches {counts} "
        f"(expected {want}); logits {tuple(logits.shape)} finite "
        f"{bool(torch.isfinite(logits).all())}; wall {wall:.2f} s (first "
        f"call), peak memory {peak:.1f} GiB")
    if counts != want:
        raise AssertionError(f"{name} prefill: launches {counts}, expected "
                             f"{want}")
    if tuple(logits.shape) != shape or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: logits {tuple(logits.shape)} "
                             f"(expected {shape}) or not finite")
    if (cache is None) != (cfg.modality == "audio"):
        raise AssertionError(f"{name}: prefill cache {type(cache)}")
    out = {"params": n_params, "active_params": active, "init_s": init_s,
           "cut": cut, "first_prefill_s": wall, "launches": counts,
           "logits_shape": list(logits.shape), "peak_gib": peak}
    del cache

    if gqa:     # (c) the flash kernel against the plain path
        from repro_torch.kernels.flash_attention import ops as fops
        _, out["layers"] = layer_check(
            "flash", f"{name} prefill", lambda: prefill_step(params, cfg,
                                                             batch))
        # the last logits against the plain-kernel replay and the plain
        # path, each run with the counted run's routing (ROUTE_TIE_RUN)
        with mock.patch.object(fops, "flash_attention", _flash_plain):
            (replay, _), _ = pinned_run(routes, lambda: prefill_step(
                params, cfg, batch))
        out["plain_replay_rel"] = _within(
            f"{name} last logits vs the plain-kernel replay (norm-wise)",
            _rel(logits, replay), SDPA_PATH_RTOL)
        (plain, _), own = pinned_run(routes, lambda: prefill_step(
            params, cfg.replace(use_flash=False), batch))
        out["plain_path_rel"] = _within(
            f"{name} last logits vs use_flash=False (norm-wise)",
            _rel(logits, plain), SDPA_PATH_RTOL)
        if routes:
            out["route_flips"] = zoo14_route_flips(
                f"{name} prefill, use_flash=False", routes, own)
        del replay, plain, own
    del routes
    if cfg.supports_decode:
        out["decode"] = zoo14_decode_checks(
            params, cfg, batch["tokens"][:, :ZOO_DECODE_PROMPT], dev, gqa)
    else:
        try:
            decode_step(params, cfg, None, None, 0)
        except ValueError as e:
            log(f"[zoo14] {name}: no decode step (ValueError: {e})")
        else:
            raise AssertionError(f"{name}: decode_step did not refuse")
    if name == ZOO14_GQA[0]:
        out["dispatch"] = zoo14_dispatch(params, cfg, batch)
    if name in ZOO14_CHUNKED:
        out["attn_chunk"] = zoo14_chunk(params, cfg, batch)

    # (f) timings: a warm prefill and one decode step, wall to a
    # synchronise, median of 3; one traced granite prefill and decode step
    out["prefill_wall_ms"], walls = _median_wall_ms(
        lambda: prefill_step(params, cfg, batch))
    msg = (f"[zoo14] {name}: warm prefill wall {out['prefill_wall_ms']:.1f}"
           f" ms (median of {[round(w, 1) for w in walls]})")
    if cfg.supports_decode:
        cache = init_cache(cfg, ZOO_BATCH, ZOO_DECODE_PROMPT, dev)
        tok = batch["tokens"][:, :1]
        decode_step(params, cfg, cache, tok, 0)
        pos = itertools.count(1)
        out["decode_step_wall_ms"], dwalls = _median_wall_ms(
            lambda: decode_step(params, cfg, cache, tok, next(pos)))
        msg += (f", decode step wall {out['decode_step_wall_ms']:.2f} ms "
                f"(median of {[round(w, 2) for w in dwalls]})")
    log(msg + f"; {card_line()}")
    if name == ZOO14_GQA[0]:
        out["profile"] = trace(f"{name} prefill B={ZOO_BATCH} S={S}",
                               lambda: prefill_step(params, cfg, batch),
                               DISPATCH_CLASS, TRACE_ATTEMPTS)
        out["decode_profile"] = trace(
            f"{name} decode step B={ZOO_BATCH}",
            lambda: decode_step(params, cfg, cache, tok, next(pos)),
            DISPATCH_CLASS, TRACE_ATTEMPTS)
    return out


def zoo14_phase(seed, dev):
    """Phase 14: each config in turn, freed before the next."""
    report = {}
    for name in ZOO14:
        t0 = time.perf_counter()
        report[name] = zoo14_run(name, seed, dev)
        report[name]["phase_s"] = time.perf_counter() - t0
        log(f"[zoo14] {name} in {report[name]['phase_s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 15: generic training (models/model.py:make_train_step, optim/)
# ---------------------------------------------------------------------------


# (a) one step of every reduced config on the card against the same step
# on the CPU (float32, TF32 off): the loss and each metric within
# TRAIN15_RTOL, each gradient leaf and each leaf's update p' - p norm-wise
# within TRAIN15_NORM, as the CPU tests hold the port against the
# reference. TRAIN15_EPS is AdamW's eps there (tests/test_torch_train_zoo
# .py: EPS): at the default 1e-8 an element whose gradient cancels to near
# eps turns the float32 rounding of its gradient into its whole update, and
# the reference disagrees with itself there by 2e-3 to 4e-3.
TRAIN15_RTOL = 1e-5
TRAIN15_NORM = 1e-4
TRAIN15_EPS = 1e-4
TRAIN15_LR = 3e-4
# the rate of the checked first step of (b) and (c): every parameter with a
# nonzero gradient must change, and bf16 parameters near 1 (the norms'
# weights) move only when lr * |update| passes half a bf16 step below 1,
# 2**-9; AdamW's first update is about 1 a parameter
TRAIN15_CHECK_LR = 1e-2
# (b) qwen2-vl-2b whole at full width, (c) granite-moe-3b-a800m at full
# width cut in depth (all 32 layers need about 54 GB of parameters and
# optimizer state alone), both at B = 2 x S = 1,024
TRAIN15_BATCH, TRAIN15_SEQ = 2, 1024
TRAIN15_QWEN = "qwen2-vl-2b"
TRAIN15_GRANITE = "granite-moe-3b-a800m"
TRAIN15_GRANITE_LAYERS = 8
# (b ii) the bf16 step's loss and gradients against the same step replayed
# in float32 from the same weights, norm-wise per leaf, each stacked layer
# leaf a layer at a time (a stack of 28 layers hides one wrong layer: the
# control read 0.080 on the whole `bk` stack, 1.0 on its layer). bf16
# activations and gradient signals, each rounded to 2**-9, through 28
# layers: the worst layer read 0.0372 (`bk`, layer 0), the median 0.0156
# of 340 leaves, the loss 1.22e-4 (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).
# The limit keeps a factor of 3 over the worst and 8 under the control.
TRAIN15_F32_RTOL = 2.0 ** -3
# (b ii) the control: the same bf16 step with this layer's attention
# probabilities detached must fail TRAIN15_F32_RTOL
TRAIN15_CONTROL_LAYER = 13
TRAIN15_LAUNCHER = ("--arch", "phi4-mini-3.8b", "--reduced", "--steps", "4")
# (b iii) each of the route's two products under autograd against the
# float32 upcast product's autograd on the same operands and cotangent,
# norm-wise: both multiply the same float32 values (TF32 off)
TRAIN15_PRODUCT_RTOL = 1e-6
# (b iii) dq, dk, dv of the route against the upcast route's, norm-wise.
# Not SDPA_RTOL: where the two routes' scores differ in the last float32
# bit, the bf16 rounding of P flips (SDPA_RTOL's forward reads 2.1e-5 to
# 3.3e-5), and dv sums those P over queries: dv read 1.19e-4 at qwen2-vl's
# layer (dq 2.63e-5, dk 2.21e-5) while each product's own gradients are
# held to TRAIN15_PRODUCT_RTOL. A backward that rounds its cotangent to
# bf16 reads 2.6e-3 to 3.8e-3 and must fail this limit.
TRAIN15_SDPA_GRAD_RTOL = 5e-4
# (b iii) (name, B, S, H, K, hd, causal)
TRAIN15_SDPA_CASES = (("qwen2-vl-2b_layer", 2, 1024, 12, 2, 128, True),
                      ("sam", 1, 4096, 16, 16, 80, False))
TRAIN_CLASSES = {"elementwise": ("elementwise",),
                 "reduce": ("reduce",),
                 "index_gather": ("index", "gather", "scatter")}


def _paths(tree, pre=""):
    """(path, leaf) of a dict / list / tuple tree, depth first."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{pre}/{i}")
    else:
        yield pre, tree


def _norm_rel(a, b):
    """||a - b|| / ||b|| of two leaves, in float64 on ``b``'s device
    (``None`` is zeros); 0 when both are zero."""
    if a is None and b is None:
        return 0.0
    ref = b if b is not None else a
    a = torch.zeros_like(ref) if a is None else a
    b = torch.zeros_like(ref) if b is None else b
    a, b = a.detach().to(b.device).double(), b.detach().double()
    n = float(torch.linalg.vector_norm(b))
    d = float(torch.linalg.vector_norm(a - b))
    return d / n if n > 0 else d


def _layer_paths(tree):
    """``_paths`` with each stacked layer leaf (under ``groups``) split
    into its layers: "/groups/0/attn/wq[13]"."""
    for path, leaf in _paths(tree):
        if path.startswith("/groups/") and leaf is not None:
            for i, t in enumerate(leaf.unbind(0)):
                yield f"{path}[{i}]", t
        else:
            yield path, leaf


def _worst(a_tree, b_tree):
    """(the largest ``_norm_rel`` over the leaves, its path)."""
    return max(((_norm_rel(a, b), p) for (p, a), (_, b) in
                zip(_paths(a_tree), _paths(b_tree))), default=(0.0, ""))


def _recording_opt(opt):
    """``opt`` whose ``apply`` also keeps the gradients it was given."""
    from repro_torch.optim import Optimizer
    seen = []

    def apply(p, s, g):
        seen.append(g)
        return opt.apply(p, s, g)
    return Optimizer(init=opt.init, apply=apply), seen


def _to(tree, dev):
    from repro_torch.models.stack import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def train15_cpu_parity(seed, dev):
    """(a) each reduced config: one step on the card and on the CPU from
    the same weights (made on the CPU, then copied) and batch."""
    from repro_torch.configs import ARCH_IDS, get_reduced
    from repro_torch.data import lm
    from repro_torch.models import init_params, make_train_step
    from repro_torch.optim import adamw, cosine_with_warmup
    out = {}
    for name in ARCH_IDS:
        cfg = get_reduced(name)
        params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
        nb = lm.lm_batch(np.random.RandomState(seed), cfg, 2, 16)
        runs = {}
        for where in ("cpu", dev):
            opt, seen = _recording_opt(adamw(cosine_with_warmup(
                1e-3, 1, 4), eps=TRAIN15_EPS))
            p = _to(params, where)
            new, state, metrics = make_train_step(cfg, opt)(
                p, opt.init(p), {k: torch.from_numpy(v).to(where)
                                 for k, v in nb.items()})
            upd = [None if a is None else a.float() - b.float() for a, b in
                   ((n, o) for (_, n), (_, o) in zip(_paths(new),
                                                     _paths(p)))]
            runs[str(where)] = (metrics, seen[0], upd)
        (mc, gc_, uc), (md, gd, ud) = runs["cpu"], runs[str(dev)]
        rel = {k: abs(float(md[k]) - float(mc[k]))
               / max(abs(float(mc[k])), 1e-30) if float(mc[k]) else
               abs(float(md[k])) for k in mc}
        g_err, g_path = _worst(gd, gc_)
        u_err, u_path = max((_norm_rel(a, b), p) for (p, _), a, b in
                            zip(_paths(params), ud, uc))
        log(f"[train15] (a) {name}: metrics rel "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
            + f" (limit {TRAIN15_RTOL:g}); worst gradient leaf {g_path} "
            f"{g_err:.2e}, worst update leaf {u_path} {u_err:.2e} (limit "
            f"{TRAIN15_NORM:g}, norm-wise)")
        if sorted(md) != sorted(mc) or max(rel.values()) > TRAIN15_RTOL \
                or g_err > TRAIN15_NORM or u_err > TRAIN15_NORM:
            raise AssertionError(f"15a {name}: the card's step is off the "
                                 f"CPU's")
        out[name] = {"metrics_rel": rel, "grad_worst": [g_err, g_path],
                     "update_worst": [u_err, u_path],
                     "loss": float(md["loss"])}
    return out


def _mem_gb(params):
    """(parameters, their gradients, the float32 moments, the float32
    clipped gradients) in GB."""
    from repro_torch.models.stack import leaves
    n = sum(t.numel() for t in leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    return nbytes / 1e9, nbytes / 1e9, 8 * n / 1e9, 4 * n / 1e9


def _step_checks(label, params, new, state, metrics, grads, moe=False):
    """(i): the loss, aux_loss and grad_norm finite (aux_loss positive on
    an MoE model), every gradient finite, every parameter with a nonzero
    gradient changed, the state's step 1."""
    for k in ("loss", "aux_loss", "grad_norm", "total_loss"):
        if not bool(torch.isfinite(metrics[k])):
            raise AssertionError(f"{label}: {k} {float(metrics[k])}")
    if moe and not float(metrics["aux_loss"]) > 0:
        raise AssertionError(f"{label}: aux_loss {float(metrics['aux_loss'])}")
    n_grad = n_changed = n_none = 0
    for (path, g), (_, a), (_, b) in zip(_paths(grads), _paths(new),
                                         _paths(params)):
        if g is None:
            n_none += 1
            continue
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: gradient {path} not finite")
        if bool(g.any()):
            n_grad += 1
            if torch.equal(a, b):
                raise AssertionError(f"{label}: {path} has a gradient but "
                                     f"did not change")
            n_changed += 1
    if int(state["step"]) != 1 or state["step"].dtype != torch.int32:
        raise AssertionError(f"{label}: state step {state['step']}")
    log(f"[train15] {label}: loss {float(metrics['loss']):.4f}, aux_loss "
        f"{float(metrics['aux_loss']):.4g}, grad_norm "
        f"{float(metrics['grad_norm']):.4f}; {n_grad} leaves with a "
        f"nonzero gradient, all finite, all {n_changed} changed; "
        f"{n_none} without a gradient; state step 1")
    return n_grad


def _sdpa_probs_detached(q, k, v, mask, scale):
    """``attention.sdpa_tc`` with its probabilities detached: no gradient
    reaches q and k through this attention (the control of 15b ii)."""
    from repro_torch.models import attention
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    mask = mask.reshape(mask.shape[0], 1, 1, *mask.shape[1:])
    scores = attention.scores_f32(q, k).reshape(B, K, G, S, T) * scale \
        + mask
    probs = torch.softmax(scores, dim=-1).detach().to(v.dtype)
    out = attention.pv_f32(probs.reshape(B * K, G * S, T), v)
    return out.reshape(B, K, G, S, hd).permute(0, 3, 1, 2, 4).reshape(
        B, S, H, hd)


def _control_grads(params, cfg, batch, layer):
    """``loss_and_grads`` with layer ``layer``'s attention probabilities
    detached."""
    from repro_torch.models import attention, loss_and_grads
    calls = itertools.count()
    tc = attention.sdpa_tc

    def sdpa(*args):
        return (_sdpa_probs_detached if next(calls) == layer else tc)(*args)
    with mock.patch.object(attention, "sdpa_tc", sdpa):
        out = loss_and_grads(params, cfg, batch)
    if next(calls) != cfg.num_layers:
        raise AssertionError("15b control: not one attention a layer")
    return out


def _count_nodes(fn, name):
    """Autograd nodes named ``name`` in the graph behind ``fn``."""
    seen, todo, n = set(), [fn], 0
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        n += type(f).__name__ == name
        todo.extend(g for g, _ in f.next_functions)
    return n


class _MatmulF32Bf16Cotangent(torch.autograd.Function):
    """The control of 15b iii: ``_MatmulF32`` with a backward that rounds
    the float32 cotangent to the operands' dtype first (what autograd of a
    bf16 product computes)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype).float()
        return (torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype),
                torch.bmm(a.float().transpose(1, 2), g).to(b.dtype))


def _product_grads(a, b, cot, fn):
    leaves = [a.clone().requires_grad_(), b.clone().requires_grad_()]
    out = fn(*leaves)
    return (out.detach(), *torch.autograd.grad((out * cot).sum(), leaves))


def train15_sdpa_backward(gen, dev):
    """(b iii) ``sdpa_f32``'s tensor-core route under autograd (two
    ``_MatmulF32`` products) against autograd of the float32 upcast on the
    same bf16 inputs, at qwen2-vl-2b's layer (B = 2, S = 1,024, H 12 / K 2,
    hd 128, causal) and SAM's (4,096 tokens, 16 heads, hd 80): each
    product's gradients against the upcast product's on the same operands
    and cotangent (TRAIN15_PRODUCT_RTOL; the forwards differ in their
    order of sums, ``check_sdpa``), and dq, dk, dv of the whole
    attention (TRAIN15_SDPA_GRAD_RTOL), which a route with a bf16
    cotangent must fail."""
    from repro_torch.models import attention
    from repro_torch.models.common import causal_mask

    def upcast(a, b):
        return torch.bmm(a.float(), b.float())
    out = {}
    for name, B, S, H, K, hd, causal in TRAIN15_SDPA_CASES:
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=dev
                               ).to(torch.bfloat16) for n in (H, K, K))
        cot = torch.randn(B, S, H, hd, generator=gen, device=dev)
        mask = causal_mask(S, device=dev)[None] if causal else \
            torch.zeros((1, S, S), device=dev)
        # each product on its own operands: the route's shapes
        G = H // K
        qg = q.reshape(B, S, K, G, hd).permute(0, 2, 3, 1, 4).reshape(
            B * K, G * S, hd)
        kt = k.permute(0, 2, 3, 1).reshape(B * K, hd, S)
        vg = v.permute(0, 2, 1, 3).reshape(B * K, S, hd)
        probs = torch.softmax(torch.randn(B * K, G * S, S, generator=gen,
                                          device=dev), -1).to(v.dtype)
        prod = {}
        for pname, a, b in (("q.k", qg, kt), ("p.v", probs, vg)):
            c = torch.randn(a.shape[0], a.shape[1], b.shape[2],
                            generator=gen, device=dev)
            got = _product_grads(a, b, c, attention._MatmulF32.apply)
            want = _product_grads(a, b, c, upcast)
            prod[pname] = max(_rel(x, y) for x, y in zip(got[1:], want[1:]))
        del qg, kt, vg, probs
        res = {}
        for route, fn in (("tc", attention.sdpa_f32),
                          ("upcast", sdpa_upcast_f32),
                          ("control", attention.sdpa_f32)):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            with (mock.patch.object(attention._MatmulF32, "apply",
                                    _MatmulF32Bf16Cotangent.apply)
                  if route == "control" else contextlib.nullcontext()):
                o = fn(*leaves, mask, hd ** -0.5)
                if route == "tc" and _count_nodes(
                        o.grad_fn, "_MatmulF32Backward") != 2:
                    raise AssertionError(f"15b iii {name}: the route has "
                                         f"no two _MatmulF32 products")
                res[route] = (o.detach(), *torch.autograd.grad(
                    (o * cot).sum(), leaves))
            del o, leaves
        errs = {n: _rel(a, b) for n, a, b in zip(
            ("out", "dq", "dk", "dv"), res["tc"], res["upcast"])}
        ctl = {n: _rel(a, b) for n, a, b in zip(
            ("dq", "dk", "dv"), res["control"][1:], res["upcast"][1:])}
        log(f"[train15] (b iii) sdpa backward {name}: each product's "
            f"gradients against the upcast product's "
            + ", ".join(f"{n} {e:.2e}" for n, e in prod.items())
            + f" (limit {TRAIN15_PRODUCT_RTOL:g}); the attention against "
            f"the upcast route "
            + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + f" (limit {TRAIN15_SDPA_GRAD_RTOL}, norm-wise); control (a "
            f"bf16 cotangent) "
            + ", ".join(f"{n} {e:.2e}" for n, e in ctl.items()))
        if max(prod.values()) > TRAIN15_PRODUCT_RTOL:
            raise AssertionError(f"15b iii {name}: products {prod}")
        if max(errs[n] for n in ("dq", "dk", "dv")) > TRAIN15_SDPA_GRAD_RTOL:
            raise AssertionError(f"15b iii {name}: {errs}")
        if not min(ctl.values()) > TRAIN15_SDPA_GRAD_RTOL:
            raise AssertionError(f"15b iii {name}: the control {ctl} passes")
        out[name] = {"products": prod, "route": errs, "control": ctl}
        del res
        torch.cuda.empty_cache()
    return out


def _lm_batch(cfg, seed, dev):
    from repro_torch.data import lm
    nb = lm.lm_batch(np.random.RandomState(seed), cfg, TRAIN15_BATCH,
                     TRAIN15_SEQ)
    return {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}


def train15_qwen(seed, dev, card):
    """(b) qwen2-vl-2b whole at full width."""
    from repro_torch.analysis.sanitizers import transfer_guard_ctx
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, loss_and_grads, \
        make_train_step, stack
    from repro_torch.optim import adamw, cosine_with_warmup
    from repro_torch.models.stack import tree_map
    cfg = get_config(TRAIN15_QWEN)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, dev)
    n_params = sum(t.numel() for t in stack.leaves(params))
    if n_params != ZOO14[TRAIN15_QWEN][0]:
        raise AssertionError(f"15b: {n_params} parameters")
    batch = _lm_batch(cfg, seed, dev)
    gb = _mem_gb(params)
    out = {"params": n_params, "reckoning_gb": {
        "params": gb[0], "grads": gb[1], "moments": gb[2],
        "clipped_f32_grads": gb[3]}}

    def opt_(lr=TRAIN15_LR):
        return adamw(cosine_with_warmup(lr, 1, 8))
    opt, seen = _recording_opt(opt_(TRAIN15_CHECK_LR))
    step = make_train_step(cfg, opt)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    t0 = _sync_s()
    new, state, metrics = step(params, opt.init(params), batch)
    out["first_step_s"] = _sync_s() - t0
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    grads = seen.pop()
    log(f"[train15] (b) {TRAIN15_QWEN}: {n_params:,} parameters, B="
        f"{TRAIN15_BATCH} x S={TRAIN15_SEQ} ({cfg.num_vision_tokens} vision "
        f"embeddings); first step {out['first_step_s']:.2f} s; peak memory "
        f"{out['peak_gib']:.2f} GiB (parameters and batch "
        f"{base:.2f} GiB before it; reckoning: parameters {gb[0]:.2f} GB, "
        f"gradients {gb[1]:.2f}, moments {gb[2]:.2f}, float32 clipped "
        f"gradients {gb[3]:.2f}, plus activations)")
    out["n_grad_leaves"] = _step_checks(f"(b i) {TRAIN15_QWEN} step", params,
                                        new, state, metrics, grads)
    loss16 = metrics["total_loss"]
    del new, state
    out["grad_none"] = [p for p, g in _paths(grads) if g is None]

    # (ii) the same step's loss and gradients replayed in float32
    cfg32 = cfg.replace(param_dtype="float32", act_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    total32, _, g32 = loss_and_grads(p32, cfg32, batch)
    del p32
    errs = sorted(((_norm_rel(a, b), p) for (p, a), (_, b) in
                   zip(_layer_paths(grads), _layer_paths(g32))),
                  reverse=True)
    loss_rel = _rel(loss16, total32)
    _, _, gctl = _control_grads(params, cfg, batch, TRAIN15_CONTROL_LAYER)
    ctl = max((_norm_rel(a, b), p) for (p, a), (_, b) in
              zip(_layer_paths(gctl), _layer_paths(g32)))
    del gctl, g32
    out["f32_replay"] = {"loss_rel": loss_rel, "worst": errs[:5],
                         "median": float(np.median([e for e, _ in errs])),
                         "control_worst": list(ctl)}
    log(f"[train15] (b ii) bf16 step against its float32 replay: loss rel "
        f"{loss_rel:.2e}; gradient leaves norm-wise: worst "
        + ", ".join(f"{p} {e:.3e}" for e, p in errs[:5])
        + f"; median {out['f32_replay']['median']:.3e} over "
        f"{len(errs)} leaves, each stacked leaf a layer at a time (limit "
        f"{TRAIN15_F32_RTOL}); control (layer {TRAIN15_CONTROL_LAYER}'s "
        f"attention probabilities detached): worst {ctl[1]} {ctl[0]:.3e}")
    if errs[0][0] > TRAIN15_F32_RTOL or loss_rel > TRAIN15_F32_RTOL:
        raise AssertionError(f"15b ii: {errs[0]} beyond {TRAIN15_F32_RTOL}")
    if not ctl[0] > TRAIN15_F32_RTOL:
        raise AssertionError(f"15b ii: the control {ctl} passes "
                             f"{TRAIN15_F32_RTOL}")
    del grads
    gc.collect()
    torch.cuda.empty_cache()

    out["sdpa_backward"] = train15_sdpa_backward(gen, dev)

    # (iv) four AdamW steps on one fixed batch: the loss falls
    step = make_train_step(cfg, opt_())
    p, s = params, opt_().init(params)
    losses = []
    for _ in range(4):
        p, s, m = step(p, s, batch)
        losses.append(float(m["loss"]))
    out["losses"] = losses
    log(f"[train15] (b iv) four steps on one batch: losses "
        f"{[round(x, 4) for x in losses]}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"15b iv: the loss did not fall: {losses}")

    # (v) one step under the transfer guard, the batch on the card before
    with transfer_guard_ctx(True, dev):
        p, s, m = step(p, s, batch)
    torch.cuda.synchronize()
    log("[train15] (b v) one step under the transfer guard: no host sync")

    # (vi) a warm step's wall (median of 3), one step traced, peak memory
    hold = {"p": p, "s": s}
    del p, s

    def one():
        hold["p"], hold["s"], _ = step(hold["p"], hold["s"], batch)
    out["step_wall_ms"], walls = _median_wall_ms(one)
    out["profile"] = trace(f"{TRAIN15_QWEN} train step B={TRAIN15_BATCH} "
                           f"S={TRAIN15_SEQ}", one, TRAIN_CLASSES)
    out["peak_gib_end"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] {TRAIN15_QWEN} (whole, {cfg.num_layers} layers, "
        f"{n_params / 1e9:.3f} B parameters, bf16) B={TRAIN15_BATCH} x "
        f"S={TRAIN15_SEQ}: warm step wall {out['step_wall_ms']:.1f} ms "
        f"(median of {[round(w, 1) for w in walls]}), device "
        f"{out['profile']['device_ms']:.1f} ms (idle share "
        f"{out['profile']['idle_share']:.3f}), peak memory "
        f"{out['peak_gib']:.2f} GiB; {card}")
    return out


def train15_granite(seed, dev, card):
    """(c) granite-moe-3b-a800m at full width, cut to
    TRAIN15_GRANITE_LAYERS layers."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_train_step, moe, stack
    from repro_torch.optim import adamw, cosine_with_warmup
    cfg = get_config(TRAIN15_GRANITE)
    full_layers = cfg.num_layers
    cfg = cfg.replace(num_layers=TRAIN15_GRANITE_LAYERS)
    m = cfg.moe
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, dev)
    n_params = sum(t.numel() for t in stack.leaves(params))
    batch = _lm_batch(cfg, seed, dev)
    opt, seen = _recording_opt(adamw(cosine_with_warmup(TRAIN15_CHECK_LR,
                                                        1, 8)))
    step = make_train_step(cfg, opt)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    routes, router = [], moe._router

    def recording(*args):
        out = router(*args)
        routes.append(out[1])
        return out
    t0 = _sync_s()
    with mock.patch.object(moe, "_router", recording):
        new, state, metrics = step(params, opt.init(params), batch)
    first = _sync_s() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    grads = seen.pop()
    label = f"(c i) {TRAIN15_GRANITE} ({TRAIN15_GRANITE_LAYERS} of " \
            f"{full_layers} layers) step"
    n_grad = _step_checks(label, params, new, state, metrics, grads,
                          moe=True)
    del new, state
    # the router's gradient nonzero in every layer; an expert's gradients
    # nonzero exactly where the expert kept a token (an expert chosen at
    # all keeps its first (token, slot) pair), zero elsewhere
    g = grads["groups"][0]["moe"]
    if len(routes) != TRAIN15_GRANITE_LAYERS:
        raise AssertionError(f"15c: {len(routes)} router calls")
    kept = []
    for layer, gate_idx in enumerate(routes):
        if not bool(g["router"][layer].any()):
            raise AssertionError(f"15c: layer {layer}'s router has no "
                                 f"gradient")
        chosen = torch.bincount(gate_idx.reshape(-1),
                                minlength=m.num_experts) > 0
        for w in ("w_gate", "w_up", "w_down"):
            has = g[w][layer].flatten(1).any(dim=1)
            if not torch.equal(has, chosen):
                raise AssertionError(f"15c: layer {layer} {w}: gradient "
                                     f"experts {has.tolist()}, experts "
                                     f"that kept a token {chosen.tolist()}")
        kept.append(int(chosen.sum()))
    log(f"[train15] (c) experts that kept a token, a layer: {kept} of "
        f"{m.num_experts}; each has a nonzero gradient, the others none; "
        f"every layer's router has a gradient")
    del grads, routes
    hold = {"p": params, "s": opt.init(params)}
    del params
    step = make_train_step(cfg, adamw(cosine_with_warmup(TRAIN15_LR, 1, 8)))

    def one():
        hold["p"], hold["s"], _ = step(hold["p"], hold["s"], batch)
    one()
    wall, walls = _median_wall_ms(one)
    cut = f"depth cut {full_layers} -> {TRAIN15_GRANITE_LAYERS} layers"
    log(f"[train] {TRAIN15_GRANITE} (full width, {cut}; {n_params / 1e9:.3f}"
        f" B parameters, {m.num_experts} experts top-{m.top_k}, "
        f"{m.dispatch} dispatch, bf16) B={TRAIN15_BATCH} x S={TRAIN15_SEQ}:"
        f" first step {first:.2f} s, warm step wall {wall:.1f} ms (median "
        f"of {[round(w, 1) for w in walls]}), peak memory {peak:.2f} GiB; "
        f"{card}")
    return {"params": n_params, "cut": cut, "first_step_s": first,
            "step_wall_ms": wall, "peak_gib": peak, "kept": kept,
            "aux_loss": float(metrics["aux_loss"]),
            "loss": float(metrics["loss"]), "n_grad_leaves": n_grad}


def train15_launcher():
    """(d) ``python -m repro_torch.launch.train`` as a subprocess on the
    card: exit 0, its ``[train]`` lines, and a checkpoint that
    ``bridge.load_checkpoint`` reads with ``init_params``' leaves, shapes,
    dtypes and structure."""
    import tempfile

    from repro_torch.bridge import load_checkpoint
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_params
    arch = TRAIN15_LAUNCHER[1]
    cfg = get_reduced(arch)
    with tempfile.TemporaryDirectory() as tmp:
        wall, lines, _ = _run_module("repro_torch.launch.train",
                                     [*TRAIN15_LAUNCHER, "--out", tmp],
                                     tag="train15", phase="15d")
        back = load_checkpoint(os.path.join(tmp, cfg.name), "cpu")
    if not any(ln.startswith(f"[train] {cfg.name}") for ln in lines) or \
            sum("loss=" in ln for ln in lines) != 4:
        raise AssertionError(f"15d: the launcher printed {lines}")

    def flat(tree):
        return {p: (tuple(t.shape), t.dtype) for p, t in _paths(tree)}
    want = init_params(cfg, torch.Generator(), "meta")
    if flat(back) != flat(want) or len(flat(back)) != len(flat(want)):
        raise AssertionError("15d: the checkpoint's structure, shapes or "
                             "dtypes differ from init_params'")
    log(f"[train15] (d) python -m repro_torch.launch.train "
        f"{' '.join(TRAIN15_LAUNCHER)} in {wall:.1f} s: exit 0; the "
        f"checkpoint reads back with init_params' {len(flat(want))} leaves,"
        f" shapes, dtypes and structure")
    return {"wall_s": wall, "lines": lines, "leaves": len(flat(want))}


def train15_phase(seed, dev):
    """Phase 15: (a), then each full-width model freed before the next,
    then the launcher."""
    card = card_line()
    report = {}
    for part, fn in (("cpu_parity", lambda: train15_cpu_parity(seed, dev)),
                     ("qwen", lambda: train15_qwen(seed, dev, card)),
                     ("granite", lambda: train15_granite(seed, dev, card)),
                     ("launcher", train15_launcher)):
        t0 = time.perf_counter()
        report[part] = fn()
        report[part + "_s"] = time.perf_counter() - t0
        log(f"[train15] {part} in {report[part + '_s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 16 (lisa16): the LISA system's offline phase and the trained system
# ---------------------------------------------------------------------------

# (a) three steps of each trainer on the card and on the CPU, B = 16,
# against TRAIN15_RTOL (losses) and TRAIN15_NORM (parameters, norm-wise) at
# AdamW's eps TRAIN15_EPS (1e-4, as phase 15a: at the default 1e-8 an
# element whose gradient cancels to near eps turns float32 rounding into
# its whole update)
LISA16_BATCH = 16
LISA16_STEPS = 3
LISA16_RATIO = 0.25
# (b) the offline phase through its launcher, at the reference test's
# budget of steps (tests/test_system.py trains 300 and 80 steps); the LUT
# held to the reference tests' thresholds: High Accuracy's acc_base in
# (0.15, 1.0], its payload in (2.0, 4.0) MB, the context payload under
# 3.0 MB (tests/test_system.py:31-40), and the trained Average IoU above
# the untrained one by more than 0.05 and above 0.15
# (tests/test_vlm_pipeline.py:64-75; 2 batches of 16, no pair). The
# launcher trains from seed 0.
LISA16_LAUNCHER = ("--lisa", "--steps", "300", "--ft-steps", "60",
                   "--bn-steps", "80")
LISA16_TIMED = ("repro_torch.core.training:train_lisa",
                "repro_torch.core.training:finetune_lisa",
                "repro_torch.core.training:train_bottleneck",
                "repro_torch.core.profile:build_lut")
LISA16_ACC = (0.15, 1.0)
LISA16_PAYLOAD_MB = (2.0, 4.0)
LISA16_CONTEXT_MB = 3.0
LISA16_IOU_GAIN = 0.05
# (c) the serving launcher without --smoke; the in-process runs' logits and
# masks with the paged kernel on against off: the float32 attention
# tolerance (the kernel sums in another order than the plain version)
LISA16_SERVE = ("--batching", "inflight", "--duration", "20")
LISA16_TOL = {"rtol": 1e-4, "atol": 2e-5}
# (e) the straight-through pair's gradients to enc and dec at LISA-7B's
# split point on the card (float32 products, TF32 off) against a float64
# replay on the CPU, norm-wise. The gradient to enc under a cotangent,
# x^T (g dec^T), depends on no rounding and read 4.4e-7 at r = 1278; the
# others go through the forward's codes and its bf16 output, whose
# roundings flip at ties between float32 and float64: dec 6.4e-5, the
# reconstruction loss's 1.1e-4 and 1.2e-4. The encoder product in bf16
# (the control) read 2.1e-3 to 4.4e-3 (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md §6, the offline phase's probe run 1).
LISA16_ST_GRAD_RTOL = 5e-4


def _eps_optim():
    """``repro_torch.optim`` for ``core/training.py``, its AdamW at eps
    TRAIN15_EPS."""
    from repro_torch import optim
    return types.SimpleNamespace(
        adamw=functools.partial(optim.adamw, eps=TRAIN15_EPS),
        cosine_with_warmup=optim.cosine_with_warmup)


def lisa16_trainers(where, params, pair, seed):
    """Three steps each of ``train_lisa``, ``finetune_lisa`` (from the
    first's result) and ``train_bottleneck`` on ``where``, from ``params``
    and with ``pair`` in place of the trainer's own draw, at AdamW's eps
    TRAIN15_EPS: (each step's loss, (trained, fine-tuned, pair))."""
    from repro_torch.configs.lisa_mini import CONFIG as mini
    from repro_torch.core import bottleneck as bn
    from repro_torch.core import training
    losses = []

    def recording(step):
        def run(*args):
            out = step(*args)
            losses.append(out[2])
            return out
        return run
    with mock.patch.object(training, "optim", _eps_optim()), \
            mock.patch.object(training, "lisa_step",
                              recording(training.lisa_step)), \
            mock.patch.object(training, "bottleneck_step",
                              recording(training.bottleneck_step)), \
            mock.patch.object(bn, "init_bottleneck",
                              lambda gen, spec, dtype=None, device=None:
                              _to(pair, device)):
        p = training.train_lisa(mini, steps=LISA16_STEPS,
                                batch_size=LISA16_BATCH, seed=seed,
                                params=_to(params, where), log_every=0,
                                device=where)
        ft = training.finetune_lisa(mini, p, steps=LISA16_STEPS,
                                    batch_size=LISA16_BATCH, seed=seed + 1,
                                    log=lambda s: None, device=where)
        bp = training.train_bottleneck(mini, p, LISA16_RATIO,
                                       steps=LISA16_STEPS,
                                       batch_size=LISA16_BATCH, seed=seed,
                                       log_every=0, device=where)
    return [float(x) for x in losses], (p, ft, bp)


def lisa16_cpu_parity(seed, dev):
    """(a) the three trainers on the card against the CPU from the same
    weights (drawn on the CPU, then copied), then one ``lisa_step`` and one
    ``bottleneck_step`` under the transfer guard."""
    from repro_torch import optim
    from repro_torch.analysis.sanitizers import transfer_guard_ctx
    from repro_torch.configs.lisa_mini import CONFIG as mini
    from repro_torch.core import bottleneck as bn
    from repro_torch.core import training, vlm
    from repro_torch.data import floodseg
    params = vlm.init_lisa(mini, torch.Generator().manual_seed(seed), "cpu")
    d = mini.sam.d_model
    spec = bn.BottleneckSpec(d, bn.rank_for_ratio(d, LISA16_RATIO, 4), 4)
    pair = bn.init_bottleneck(torch.Generator().manual_seed(
        seed + int(LISA16_RATIO * 1000)), spec)
    lc, trees_c = lisa16_trainers("cpu", params, pair, seed)
    ld, trees_d = lisa16_trainers(dev, params, pair, seed)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(ld, lc))
    worst = {name: _worst(a, b) for name, a, b in
             zip(("train_lisa", "finetune_lisa", "train_bottleneck"),
                 trees_d, trees_c)}
    log(f"[lisa16] (a) three steps each of train_lisa, finetune_lisa and "
        f"train_bottleneck (r={LISA16_RATIO}) at B={LISA16_BATCH}, card "
        f"against CPU: losses {[round(x, 5) for x in ld]}, worst rel "
        f"{loss_rel:.2e} (limit {TRAIN15_RTOL:g}); worst parameter leaf "
        + ", ".join(f"{k} {p} {e:.2e}" for k, (e, p) in worst.items())
        + f" (limit {TRAIN15_NORM:g}, norm-wise; AdamW eps {TRAIN15_EPS:g})")
    if len(ld) != 3 * LISA16_STEPS or loss_rel > TRAIN15_RTOL or \
            max(e for e, _ in worst.values()) > TRAIN15_NORM:
        raise AssertionError("16a: the card's steps are off the CPU's")
    rng = np.random.RandomState(seed)
    ins = training._to_device(floodseg.make_batch(
        rng, LISA16_BATCH, "segment"), dev)
    ctx = training._to_device(floodseg.make_batch(
        rng, LISA16_BATCH, "count"), dev)
    p, bp = trees_d[0], trees_d[2]
    opt, bopt = optim.adamw(optim.cosine_with_warmup(3e-4, 1, 8)), \
        optim.adamw(1e-3)
    state, bstate = opt.init(p), bopt.init(bp)
    training.lisa_step(opt, mini, p, state, ins, ctx)
    torch.cuda.synchronize()
    with transfer_guard_ctx(True, dev):
        training.lisa_step(opt, mini, p, state, ins, ctx)
        training.bottleneck_step(bopt, mini, p, bp, bstate, ins, 0.1)
    torch.cuda.synchronize()
    log("[lisa16] (a) one lisa_step and one bottleneck_step under the "
        "transfer guard: no host sync")
    return {"losses": ld, "loss_rel": loss_rel,
            "worst": {k: list(v) for k, v in worst.items()}}


def _walls(lines):
    """The ``[walls]`` line RUN_MODULE prints: [[function, seconds], ...]."""
    found = [ln for ln in lines if ln.startswith("[walls] ")]
    return json.loads(found[-1][len("[walls] "):]) if found else []


def lisa16_offline(dev, card):
    """(b) the offline phase as ``python -m repro_torch.launch.train
    --lisa`` into a temporary directory, the LUT against the reference
    tests' thresholds, the trained against the untrained Average IoU, one
    ``lisa_step`` traced. Returns (report, (params, params_ft, pairs by
    ratio, lut)) read back from the launcher's files."""
    import tempfile

    from repro_torch import optim
    from repro_torch.bridge import load_checkpoint
    from repro_torch.configs.lisa_mini import CONFIG as mini
    from repro_torch.core import training, vlm
    from repro_torch.core.lut import SystemLUT
    from repro_torch.data import floodseg
    with tempfile.TemporaryDirectory(prefix="lisa16_") as tmp:
        wall, lines, launched = _run_module(
            "repro_torch.launch.train", [*LISA16_LAUNCHER, "--out", tmp],
            tag="lisa16", phase="16b", timed=LISA16_TIMED)
        lut = SystemLUT.load(os.path.join(tmp, "lut.json"))
        params = load_checkpoint(os.path.join(tmp, "lisa_mini_original"),
                                 dev)
        params_ft = load_checkpoint(os.path.join(tmp,
                                                 "lisa_mini_finetuned"), dev)
        bns = {t.ratio: load_checkpoint(os.path.join(
            tmp, f"bottleneck_r{t.ratio}"), dev) for t in lut.tiers}
    walls = _walls(lines)
    rows = [{"name": t.name, "ratio": t.ratio, "acc_base": t.acc_base,
             "acc_finetuned": t.acc_finetuned, "payload_mb": t.payload_mb}
            for t in lut.tiers]
    log(f"[lisa16] (b) python -m repro_torch.launch.train "
        f"{' '.join(LISA16_LAUNCHER)}: exit 0 in {wall:.1f} s ({card}); "
        f"stage walls " + ", ".join(f"{n} {w:.2f} s" for n, w in walls)
        + f"; launches {launched} (expected none); LUT "
        + "; ".join(f"{r['name']} r={r['ratio']} base {r['acc_base']:.4f} "
                    f"ft {r['acc_finetuned']:.4f} payload "
                    f"{r['payload_mb']:.4f} MB" for r in rows)
        + f"; context {lut.context.payload_mb:.4f} MB")
    ha = lut.tiers[0]
    if any(launched.values()) or [t.ratio for t in lut.tiers] != \
            [0.25, 0.1, 0.05] or ha.name != "High Accuracy":
        raise AssertionError(f"16b: launches {launched} or tiers {rows}")
    if not (LISA16_ACC[0] < ha.acc_base <= LISA16_ACC[1]
            and LISA16_PAYLOAD_MB[0] < ha.payload_mb < LISA16_PAYLOAD_MB[1]
            and lut.context.payload_mb < LISA16_CONTEXT_MB):
        raise AssertionError(f"16b: the LUT misses the reference tests' "
                             f"thresholds: {rows}, context "
                             f"{lut.context.payload_mb}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    before = training.evaluate_insight(mini, vlm.init_lisa(mini, gen, dev),
                                       batches=2, batch_size=16, device=dev)
    after = training.evaluate_insight(mini, params, batches=2,
                                      batch_size=16, device=dev)
    gain = after["avg_iou"] - before["avg_iou"]
    log(f"[lisa16] (b) Average IoU untrained {before['avg_iou']:.4f}, "
        f"trained {after['avg_iou']:.4f} (gain {gain:.4f}, limit > "
        f"{LISA16_IOU_GAIN}; trained > {LISA16_ACC[0]})")
    if not (gain > LISA16_IOU_GAIN and after["avg_iou"] > LISA16_ACC[0]):
        raise AssertionError("16b: training did not lift Average IoU")
    rng = np.random.RandomState(0)
    ins = training._to_device(floodseg.make_batch(
        rng, LISA16_BATCH, "segment"), dev)
    ctx = training._to_device(floodseg.make_batch(
        rng, LISA16_BATCH, "any"), dev)
    opt = optim.adamw(optim.cosine_with_warmup(3e-4, 30, 300))
    hold = {"p": params, "s": opt.init(params)}

    def one():
        hold["p"], hold["s"], _, _ = training.lisa_step(
            opt, mini, hold["p"], hold["s"], ins, ctx)
    step_ms, step_walls = _median_wall_ms(one)
    prof = trace(f"lisa-mini train_lisa step B={LISA16_BATCH}", one,
                 TRAIN_CLASSES)
    log(f"[train] lisa-mini (float32) lisa_step B={LISA16_BATCH}: warm "
        f"wall {step_ms:.2f} ms (median of "
        f"{[round(w, 2) for w in step_walls]}), device "
        f"{prof['device_ms']:.2f} ms (idle share {prof['idle_share']:.3f});"
        f" {card}")
    report = {"wall_s": wall, "stage_walls": walls, "lut": rows,
              "context_mb": lut.context.payload_mb, "launches": launched,
              "iou_untrained": before, "iou_trained": after,
              "step_wall_ms": step_ms, "profile": prof}
    return report, (params, params_ft, bns, lut)


def lisa16_frames(executor, mini, seed):
    """INFLIGHT_WAVES' frames as floodseg scenes (Insight: a segment query
    of the scene's class; Context: an "any" query), edge-encoded by the
    executor, Insight frames alternating over two tiers."""
    from repro_torch.data import floodseg
    rng = np.random.RandomState(seed + 1)
    frames, n_ins = {}, 0
    for wave in INFLIGHT_WAVES:
        for _, kind, f in wave:
            if f in frames:
                continue
            b = floodseg.make_batch(rng, 1, "segment" if kind == "insight"
                                    else "any", augment=False)
            if kind == "context":
                pkt, _ = executor.edge_context(b["images"], f, 0.0)
            else:
                pkt = executor.edge_insight(
                    b["images"], executor.lut.tiers[n_ins % 2], f, 0.0)
                n_ins += 1
            frames[f] = (kind, pkt, b["query"])
    return frames


def lisa16_serve(system, seed, dev, card):
    """(c) the serving launcher without ``--smoke`` as a subprocess; then
    the trained system of (b) served in flight in process, the paged
    kernel on (counted) and off; (d) missions on its LUT and executor."""
    from repro_torch import engine as eng
    from repro_torch.configs.lisa_mini import CONFIG as mini
    from repro_torch.core.streams import DualStreamExecutor
    from repro_torch.network import paper_trace
    from repro_torch.runtime.mission import MissionSpec, run_mission
    wall, lines, launched = _run_module("repro_torch.launch.serve",
                                        LISA16_SERVE, tag="lisa16",
                                        phase="16c")
    served = [ln for ln in lines if " in-flight decode steps" in ln]
    steps = int(served[0].split(" in-flight decode steps")[0]
                .rsplit(" ", 1)[1]) if served else 0
    expect = {"decode_attention": 0,
              "paged_decode_attention": steps * mini.llm.num_layers,
              "paged_verify_attention": 0}
    log(f"[lisa16] (c) python -m repro_torch.launch.serve "
        f"{' '.join(LISA16_SERVE)}: exit 0 in {wall:.1f} s ({card}), "
        f"launches {launched} (expected {expect})")
    if not steps or launched != expect:
        raise AssertionError(f"16c: serve launches {launched}, expected "
                             f"{expect}")
    out = {"launcher": {"wall_s": wall, "steps": steps,
                        "launches": launched}}

    params, _, bns, lut = system
    by_name = {lut.tiers[i].name: bns[r]
               for i, r in enumerate(sorted(bns, reverse=True))}
    ex = DualStreamExecutor(pcfg=mini, params=params, bottlenecks=by_name,
                            lut=lut, device=dev)
    frames = lisa16_frames(ex, mini, seed)
    _reset_launch_counts()
    on, dec = serve_inflight(ex, frames)
    launches = _launch_counts()
    expect = _only(paged_decode_attention=dec.n_steps * mini.llm.num_layers)
    check_inflight_outputs(mini, on, dec)
    ex.flash_decode = False
    try:
        off, _ = serve_inflight(ex, frames)
    finally:
        ex.flash_decode = True
    plain = {k: v - launches[k] for k, v in _launch_counts().items()}
    worst, margins = {"answer_logits": 0.0, "mask_logits": 0.0}, []
    for a, b in zip(on, off):
        if not np.array_equal(a["tokens"], b["tokens"]):
            raise AssertionError(f"16c seq {a['seq_id']}: tokens "
                                 f"{a['tokens']} with the kernel, "
                                 f"{b['tokens']} without")
        for k in worst:
            if a[k] is None:
                continue
            np.testing.assert_allclose(a[k], b[k], **LISA16_TOL,
                                       err_msg=f"16c seq {a['seq_id']} {k}")
            worst[k] = max(worst[k], float(np.abs(a[k] - b[k]).max()))
        top2 = np.sort(a["answer_logits"][0])[-2:]
        margins.append(float(top2[1] - top2[0]))
    log(f"[lisa16] (c) the trained system in flight: {len(on)} requests in "
        f"{dec.n_steps} decode steps, launches {launches} (expected "
        f"{expect}), kernel off {plain} (expected none); tokens equal, max "
        f"abs difference " + ", ".join(f"{k} {v:.3g}" for k, v in
                                       worst.items())
        + f" (rtol {LISA16_TOL['rtol']}, atol {LISA16_TOL['atol']}); the "
        f"first answer's two leading logits {min(margins):.4f} apart at the "
        f"least (median {np.median(margins):.4f})")
    if launches != expect or plain != _only():
        raise AssertionError(f"16c: launches {launches} / {plain}")
    out["inflight"] = {"steps": dec.n_steps, "launches": launches,
                       "max_abs": worst, "tokens": [r["tokens"].tolist()[0]
                                                    for r in on],
                       "answer_margins": margins}

    missions = {}
    for name, policy in (("avery", eng.AdaptivePolicy()),
                         ("static High Accuracy",
                          eng.StaticTierPolicy("High Accuracy"))):
        t0 = time.perf_counter()
        m = run_mission(lut, paper_trace(seed),
                        MissionSpec(policy=policy, seed=seed), executor=ex)
        ious = [f.iou for f in m.frames]
        if not m.frames or not all(0.0 <= x <= 1.0 for x in ious):
            raise AssertionError(f"16d: mission {name} served no frame or "
                                 f"an IoU outside [0, 1]")
        missions[name] = {"frames": len(m.frames), "pps": m.mean_pps,
                          "iou": m.mean_iou, "infeasible_s": m.infeasible_s,
                          "tiers": sorted(set(f.tier for f in m.frames)),
                          "wall_s": time.perf_counter() - t0}
    a, h = missions["avery"], missions["static High Accuracy"]
    gap = 100.0 * (h["iou"] - a["iou"]) / h["iou"] if h["iou"] else math.nan
    log(f"[lisa16] (d) missions on the trained LUT ({card}): AVERY "
        f"{a['frames']} frames, {a['pps']:.4f} pps, mean IoU {a['iou']:.4f}, "
        f"tiers {a['tiers']}; static High Accuracy {h['frames']} frames, "
        f"{h['pps']:.4f} pps, mean IoU {h['iou']:.4f}; AVERY's IoU "
        f"{gap:.3f} % under static High Accuracy's (the paper's claim: "
        f"within 0.75 %; reported, not held)")
    out["missions"] = missions
    out["iou_gap_pct"] = gap
    return out


def _st_grads(pair, x, cot, dtype, product_dtype=None):
    """Gradients to ``enc`` and ``dec`` of the straight-through round trip
    (under the cotangent ``cot``) and of the reconstruction loss, written
    out in ``dtype`` on x's device, the encoder product in
    ``product_dtype`` (default ``dtype``): ``roundtrip_st`` and
    ``recon_loss``'s formulas, the output cast to x's dtype as theirs."""
    enc = pair["enc"].detach().to(dtype).requires_grad_()
    dec = pair["dec"].detach().to(dtype).requires_grad_()
    pd = product_dtype or dtype
    xd = x.to(dtype)
    z = (x.to(pd) @ enc.to(pd)).to(dtype)
    s = z.detach().abs().amax(-1, keepdim=True) / 127.0 + 1e-8
    zq = z / s
    zq = zq + (torch.clamp(torch.round(zq), -127, 127) - zq).detach()
    out = ((zq * s) @ dec).to(x.dtype)
    g_rt = torch.autograd.grad(out, [enc, dec], cot, retain_graph=True)
    xh = out.to(dtype)
    loss = torch.mean(torch.square(xh - xd)) / (torch.mean(torch.square(xd))
                                                + 1e-8)
    return list(g_rt) + list(torch.autograd.grad(loss, [enc, dec]))


def lisa16_full_width(x, ranks, seed, dev, card):
    """(e) ``roundtrip_st`` and ``recon_loss`` at LISA-7B's split point:
    ``x`` one frame's boundary activation (1, 4096, 1280) bf16, a pair of
    each tier's rank drawn from ``seed``."""
    from repro_torch.core import bottleneck as bn
    d = x.shape[-1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cot = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
    out = {}
    for rank in ranks:
        pair = bn.init_bottleneck(gen, bn.BottleneckSpec(d, rank, 4),
                                  device=dev)
        with torch.no_grad():
            z = x.float() @ pair["enc"]
            s = bn._absmax_scale(z)
            codes = torch.clamp(torch.round(z / s), -127, 127).to(torch.int8)
            kc, ks = bn.encode(pair, x, use_kernel=True)
            torch.cuda.synchronize()
        diff, off, s_err = codes_held_against(
            f"16e r{rank}: encode kernel against roundtrip_st's codes", kc,
            ks, codes, s)
        live = {k: v.detach().clone().requires_grad_()
                for k, v in pair.items()}
        t0 = _sync_s()
        y = bn.roundtrip_st(live, x)
        g = list(torch.autograd.grad(y, [live["enc"], live["dec"]], cot))
        g += list(torch.autograd.grad(bn.recon_loss(live, x),
                                      [live["enc"], live["dec"]]))
        card_s = _sync_s() - t0
        fwd = _rel(y.detach(), bn.decode(pair, codes, s, out_dtype=x.dtype))
        cpu = {k: v.cpu() for k, v in pair.items()}
        t0 = time.perf_counter()
        ref = _st_grads(cpu, x.cpu(), cot.cpu(), torch.float64)
        replay_s = time.perf_counter() - t0
        ctl = _st_grads(pair, x, cot, torch.float32, product_dtype=x.dtype)
        names = ("roundtrip enc", "roundtrip dec", "recon enc", "recon dec")
        errs = {n: _norm_rel(a, b) for n, a, b in zip(names, g, ref)}
        ctl_errs = {n: _norm_rel(a, b) for n, a, b in zip(names, ctl, ref)}
        log(f"[lisa16] (e) r{rank} at {x.shape[1]} x {d} {x.dtype}: codes "
            f"against the encode kernel off by {diff} on {off:.3g} of entries, scales "
            f"{s_err:.3g}; forward against decode of its codes {fwd:.3g}; "
            f"gradients against the float64 CPU replay "
            + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
            + f" (limit {LISA16_ST_GRAD_RTOL:g}, norm-wise); control (bf16 "
            f"encoder product) "
            + ", ".join(f"{n} {e:.3g}" for n, e in ctl_errs.items())
            + f"; card {card_s * 1e3:.1f} ms, replay {replay_s:.1f} s; "
            f"{card}")
        if fwd > 2.0 ** -8 or max(errs.values()) > LISA16_ST_GRAD_RTOL:
            raise AssertionError(f"16e r{rank}: forward {fwd} or gradients "
                                 f"{errs} beyond the limits")
        if not max(ctl_errs.values()) > LISA16_ST_GRAD_RTOL:
            raise AssertionError(f"16e r{rank}: the control {ctl_errs} "
                                 f"passes {LISA16_ST_GRAD_RTOL}")
        out[f"r{rank}"] = {"codes_off": off, "codes_max_diff": diff,
                           "scales_err": s_err, "forward_rel": fwd,
                           "grad_rel": errs, "control_rel": ctl_errs,
                           "card_ms": card_s * 1e3, "replay_s": replay_s}
    return out


def lisa16_boundary(executor, pcfg, seed):
    """One frame's ``sam_head`` output of the LISA-7B executor (the split
    point's boundary activation), kept for (e) after LISA-7B is freed."""
    from repro_torch.core import vlm
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(rng.rand(1, pcfg.image_size, pcfg.image_size,
                                    3).astype(np.float32)).to(
        executor.device)
    with torch.inference_mode():
        x = vlm.sam_head(executor.params, pcfg, img)
    return x.clone()


def lisa16_phase(seed, dev, x, ranks):
    """Phase 16: (a) the trainers on the card against the CPU, (b) the
    offline phase's launcher, (c) the serving launcher and the trained
    system in flight, (d) its missions, (e) the pair at full width."""
    card = card_line()
    report = {}
    t0 = time.perf_counter()
    report["cpu_parity"] = lisa16_cpu_parity(seed, dev)
    report["cpu_parity_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["offline"], system = lisa16_offline(dev, card)
    report["offline_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["serve"] = lisa16_serve(system, seed, dev, card)
    report["serve_s"] = time.perf_counter() - t0
    del system
    t0 = time.perf_counter()
    report["full_width"] = lisa16_full_width(x, ranks, seed, dev, card)
    report["full_width_s"] = time.perf_counter() - t0
    for part in ("cpu_parity", "offline", "serve", "full_width"):
        log(f"[lisa16] {part} in {report[part + '_s']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# phase 17: tensor-parallel paged serving, two ranks of LISA-7B on one card
# ---------------------------------------------------------------------------

SHARD17_RANKS = 2
# the whole phase, and one collective (rendezvous included: a rank's
# LISA-7B takes tens of seconds to build before its first one)
SHARD17_TIMEOUT_S = 480
SHARD17_COLLECTIVE_S = 300
# Insight at the first two tiers, then Context
SHARD17_KINDS = ("insight", "insight", "context")
SHARD17_SPECULATIVE = 3          # 12c's draft: the serving weights, k = 3


def shard17_requests(executor, pcfg, seed):
    """SHARD17_KINDS from 12b's seeded frames, their packets made by the
    executor's edge stages: [(packet, query, intent)]."""
    from repro_torch.core.intent import Intent
    out = []
    for i, ((images, query), kind) in enumerate(
            zip(engine_frames(pcfg, seed), SHARD17_KINDS)):
        if kind == "context":
            pkt, _ = executor.edge_context(images, i, 0.0)
            out.append((pkt, query, Intent.CONTEXT))
        else:
            pkt = executor.edge_insight(images, executor.lut.tiers[i], i,
                                        0.0)
            out.append((pkt, query, Intent.INSIGHT))
    return out


def _kv_heads_seen(seen):
    """Stand-ins for the three decode-attention wrappers that record the
    kv heads of each call (k's third axis: (P, page, K, hd) or (B, W, K,
    hd)) before calling through."""
    from repro_torch.kernels.decode_attention import ops
    patches = []
    for name in ("decode_attention", "paged_decode_attention",
                 "paged_verify_attention"):
        def wrap(fn, name=name):
            def run(q, k, *a, **kw):
                seen.setdefault(name, set()).add(int(k.shape[2]))
                return fn(q, k, *a, **kw)
            return run
        patches.append(mock.patch.object(ops, name, wrap(getattr(ops,
                                                                 name))))
    return patches


def shard17_run(executor, pcfg, order, mesh, speculative):
    """One engine run of ``order`` through ``submit_packet`` on
    ``executor`` (a ``ShardedServingContext`` with ``mesh``, or the plain
    executor), launch counters from 0 just before and read just after.
    Each decode and verify step is timed to the end of its device work,
    with the all-reduces it joined and their time (each timed alone
    between two synchronisations). Returns (responses, report, the logits
    that predicted each (request, token))."""
    from repro_torch.engine.engine import AveryEngine
    engine = AveryEngine(lut=executor.lut, executor=executor, mesh=mesh,
                         batching="inflight", max_batch=INFLIGHT_SLOTS,
                         speculative=speculative)
    calls = {"cloud_verify_rows": 0, "cloud_decode_rows": 0}
    steps = {name: [] for name in calls}
    logits, reduce, heads = {}, {"n": 0, "s": 0.0, "b": 0}, {}
    sharded = mesh is not None

    def timed(name, stage):
        def run(*args):
            n0, s0, b0 = reduce["n"], reduce["s"], reduce["b"]
            t0 = _sync_s()
            out = stage(*args)
            steps[name].append({"wall_s": _sync_s() - t0,
                                "all_reduces": reduce["n"] - n0,
                                "all_reduce_s": reduce["s"] - s0,
                                "all_reduce_bytes": reduce["b"] - b0,
                                "rows": len(args[3])})
            return out
        return run

    if sharded:
        real_reduce = executor.all_reduce

        def timed_reduce(t):
            t0 = _sync_s()
            out = real_reduce(t)
            reduce["s"] += _sync_s() - t0
            reduce["n"] += 1
            reduce["b"] += t.nbytes
            return out
        executor.all_reduce = timed_reduce
    for name in calls:
        setattr(executor, name, timed(name, _recording(
            executor, engine, name, calls, logits)))
    try:
        with contextlib.ExitStack() as stack:
            for p in _kv_heads_seen(heads):
                stack.enter_context(p)
            _reset_launch_counts()
            t0 = _sync_s()
            futs = [engine.submit_packet(p, q, it, time_s=0.4 * i)
                    for i, (p, q, it) in enumerate(order)]
            decoders = list(engine._inflight.values())
            engine.drain()
            wall = _sync_s() - t0
            launches = _launch_counts()
    finally:
        for name in calls:
            vars(executor).pop(name, None)
        vars(executor).pop("all_reduce", None)
    responses = [f.result() for f in futs]
    _engine_outputs(pcfg, responses, SPEC_MAX_NEW_TOKENS)
    L = pcfg.llm.num_layers
    draft_steps = sum(d.draft.n_steps for d in decoders
                      if d.draft is not None)
    expect = _only(paged_verify_attention=calls["cloud_verify_rows"] * L,
                   paged_decode_attention=calls["cloud_decode_rows"] * L,
                   decode_attention=draft_steps * L)
    ran = calls["cloud_verify_rows" if speculative else "cloud_decode_rows"]
    if launches != expect or not ran:
        raise AssertionError(f"17: launches {launches}, expected {expect} "
                             f"({calls}, {draft_steps} draft steps)")
    stats = engine.stats
    report = {"wall_s": wall, "steps": calls, "draft_steps": draft_steps,
              "launches": launches, "kv_heads": {k: sorted(v)
                                                 for k, v in heads.items()},
              "step_times": steps,
              "pool": {k: stats[k] for k in ("kv_pool_bytes",
                                             "kv_pool_bytes_per_shard",
                                             "kv_shards")}}
    if sharded:
        report.update(mesh_devices=stats["mesh_devices"],
                      model_shards=stats["model_shards"])
    return responses, report, logits


def _shard17_arrays(responses):
    """Each response's tokens, answer logits and (Insight) mask logits."""
    out = {}
    for r in responses:
        out[f"tokens_{r.request_id}"] = np.asarray(r.tokens)
        out[f"answer_{r.request_id}"] = np.asarray(r.answer_logits)
        if r.mask_logits is not None:
            out[f"mask_{r.request_id}"] = np.asarray(r.mask_logits)
    return out


def shard17_against_unsharded(label, responses, logits, base, base_logits):
    """Rank 0's tokens against the unsharded engine's, up to 12c's checked
    near ties (``decode_ties``: TIE_ULPS, MAX_TIES, each path's logits
    within PATH_RTOL where a token first differs), and its answer and mask
    logits within PATH_RTOL norm-wise. Returns the ties and the worst
    norm-wise difference."""
    tokens = np.concatenate([r.tokens for r in responses])
    other = np.concatenate([r.tokens for r in base])
    rows = {r.request_id: b for b, r in enumerate(responses)}

    def by_token(rec):
        out = {}
        for (rid, d), v in rec.items():
            out.setdefault(d, {})[rows[rid]] = torch.as_tensor(v)
        return out
    try:
        ties = decode_ties(label, tokens, by_token(logits), other,
                           by_token(base_logits), PATH_RTOL, tag="shard17")
    except KeyError as e:
        raise AssertionError(f"{label}: tokens {tokens.tolist()} != "
                             f"{other.tolist()} with no logits recorded for "
                             f"the first differing one ({e})") from None
    worst = 0.0
    for r, b in zip(responses, base):
        worst = max(worst, _rel(r.answer_logits, b.answer_logits))
        if b.mask_logits is not None:
            worst = max(worst, _rel(r.mask_logits, b.mask_logits))
    if not worst <= PATH_RTOL:
        raise AssertionError(f"{label}: logits or masks {worst:.3g} off the "
                             f"unsharded engine's (limit {PATH_RTOL})")
    return ties, worst


def shard17_layers(ctx, order, kind, rank):
    """``layer_check`` of one step of ``kind`` on this rank's slice: a
    fresh decoder on the sharded context admits ``order`` and takes one
    step ("paged": plain decode; "verify": speculative, whose first step
    verifies)."""
    from repro_torch.core.paging import PagePool
    from repro_torch.engine.inflight import InflightDecoder
    from repro_torch.engine.speculative import SpeculativeConfig

    def run():
        spec = (SpeculativeConfig(draft_tokens=SHARD17_SPECULATIVE)
                if kind == "verify" else None)
        pool = PagePool(page_size=ctx.page_size, placement=ctx.place_pool,
                        shards=ctx.model_shards)
        dec = InflightDecoder(ctx, slots=INFLIGHT_SLOTS, pool=pool,
                              spec=spec)
        for i, (p, q, it) in enumerate(order):
            dec.submit(i, it, p, q, lambda o: None)
        dec.pump(1)
    _, summary = layer_check(kind, f"17 rank {rank} one {kind} step", run)
    if summary["steps"] != 1:
        raise AssertionError(f"17: {summary['steps']} {kind} steps checked, "
                             f"expected 1")
    return summary


def shard17_prefill_layers(ctx, executor, order, rank):
    """Each prefill layer of the Context request's ``cloud_prefix`` on
    this rank's slice (row-parallel sums over the ranks) against, on rank
    0, the whole layer on the same input (the unsharded weights, no
    collective): attention block and layer output norm-wise within
    LAYER_RTOL, as ``layer_check`` holds a kernel. Returns the readings
    (rank 0) or None."""
    from repro_torch.models import stack
    pkt, query, _ = order[SHARD17_KINDS.index("context")]
    block, seen = stack._dense_block_full, []

    def recorded(p, cfg, x, positions, mask):
        y, kv = block(p, cfg, x, positions, mask)
        seen.append((x, positions, mask, y))
        return y, kv
    with mock.patch.object(stack, "_dense_block_full", recorded):
        ctx.cloud_prefix(pkt.content["ctx"], query)
    if rank != 0:
        return None
    llm = executor.pcfg.llm
    whole = stack.layer_views(executor.params["llm"]["groups"][0],
                              llm.num_layers)
    rel = [_rel(y, block(whole[i], llm, x, positions, mask)[0])
           for i, (x, positions, mask, y) in enumerate(seen)]
    worst = int(np.argmax(rel))
    log(f"[shard17] rank 0: {len(rel)} prefill layers of rank 0's slice "
        f"against the whole layer on the same input: worst layer {worst} "
        f"{rel[worst]:.3g} norm-wise (limit {LAYER_RTOL}); per layer "
        + ", ".join(f"{r:.2g}" for r in rel))
    if len(rel) != llm.num_layers or not max(rel) <= LAYER_RTOL:
        raise AssertionError(f"17: sharded prefill layers {rel} against the "
                             f"whole layers (limit {LAYER_RTOL})")
    return {"layers": len(rel), "worst_layer": worst, "per_layer": rel,
            "limit": LAYER_RTOL}


def shard17_serve(rank, seed, dev):
    """One rank of phase 17: LISA-7B at full width from ``seed`` (the
    weights checked leaf by leaf against rank 0's), wrapped in a
    ``ShardedServingContext`` over ``make_local_mesh(model=2)``, serves
    SHARD17_KINDS plain and with ``speculative=3``; one step of each kind
    through ``layer_check``; one prefill's layers against the whole
    layers (``shard17_prefill_layers``); on rank 0 the same runs
    unsharded. Returns (report, the served arrays)."""
    from repro_torch.configs import get_lisa_config
    from repro_torch.core.streams import DualStreamExecutor
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.stack import leaves
    from repro_torch.sharding.serving import (ShardedServingContext,
                                              same_on_all_ranks)
    pcfg = get_lisa_config("lisa-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = _sync_s()
    params, bns, lut = make_system(pcfg, seed, dev)
    executor = spec_executor(DualStreamExecutor(
        pcfg=pcfg, params=params, bottlenecks=bns, lut=lut,
        max_new_tokens=MAX_NEW_TOKENS, flash_decode=True, device=dev))
    sums = np.array([float(t.sum(dtype=torch.float64))
                     for tree in (params, bns) for t in leaves(tree)])
    if not same_on_all_ranks([sums], dev):
        raise AssertionError("17: the ranks built different weights")
    mesh = make_local_mesh(model=SHARD17_RANKS)
    ctx = ShardedServingContext(executor, mesh)
    init_s = _sync_s() - t0
    order = shard17_requests(executor, pcfg, seed)
    contents = [np.asarray(v) for p, q, _ in order
                for v in list(p.content.values()) + [q]]
    if not same_on_all_ranks(contents, dev):
        raise AssertionError("17: the ranks' edge stages made different "
                             "packets")
    log(f"[shard17] rank {rank}: LISA-7B ({sums.size} leaves, equal on "
        f"every rank) and its slice ({sorted(ctx.tp.kinds)} cut over "
        f"{ctx.model_shards}) in {init_s:.1f} s; "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB peak")
    report = {"rank": rank, "init_s": init_s, "kinds": sorted(ctx.tp.kinds),
              "weight_leaves": int(sums.size)}
    arrays, runs = {}, {}
    for name, spec in (("plain", None), ("spec", SHARD17_SPECULATIVE)):
        responses, rep, logits = shard17_run(ctx, pcfg, order, mesh, spec)
        runs[name] = (responses, logits)
        arrays.update({f"{name}_{k}": v for k, v in
                       _shard17_arrays(responses).items()})
        L = pcfg.llm.num_layers
        heads = pcfg.llm.num_kv_heads // SHARD17_RANKS
        if any(v != [heads] for v in rep["kv_heads"].values()):
            raise AssertionError(f"17 {name}: kernels launched on kv heads "
                                 f"{rep['kv_heads']}, not {heads}")
        pool = rep["pool"]
        if (rep["mesh_devices"], rep["model_shards"]) != (2, 2) or \
                pool["kv_pool_bytes_per_shard"] * 2 != pool["kv_pool_bytes"]:
            raise AssertionError(f"17 {name}: stats {rep}")
        st = rep["step_times"]
        for stage, tag in (("cloud_decode_rows", "decode"),
                           ("cloud_verify_rows", "verify")):
            if st[stage]:
                walls = [x["wall_s"] * 1e3 for x in st[stage]]
                red = [x["all_reduces"] for x in st[stage]]
                red_ms = [x["all_reduce_s"] * 1e3 for x in st[stage]]
                rep[f"{tag}_step_ms_median"] = float(np.median(walls))
                rep[f"{tag}_all_reduces_a_step"] = red
                rep[f"{tag}_all_reduce_ms_median"] = float(np.median(red_ms))
                log(f"[shard17] rank {rank} {name}: {len(walls)} {tag} "
                    f"steps, wall median {np.median(walls):.2f} ms (min "
                    f"{min(walls):.2f}, max {max(walls):.2f}), all-reduces "
                    f"a step {sorted(set(red))}, their time a step median "
                    f"{np.median(red_ms):.2f} ms (gloo staged through the "
                    f"host on one card; says nothing of NCCL over NVLink)")
        log(f"[shard17] rank {rank} {name}: {len(responses)} requests, "
            f"{rep['steps']['cloud_decode_rows']} decode and "
            f"{rep['steps']['cloud_verify_rows']} verify steps, "
            f"{rep['draft_steps']} draft steps; launches {rep['launches']} "
            f"(paged = decode steps x {L}, verify = verify steps x {L}, "
            f"contiguous = draft steps x {L}), each on {heads} kv heads; "
            f"pool {pool}; wall {rep['wall_s']:.2f} s")
        report[name] = rep
    for kind in ("paged", "verify"):
        report[f"layers_{kind}"] = shard17_layers(ctx, order, kind, rank)
    report["prefill_layers"] = shard17_prefill_layers(ctx, executor, order,
                                                      rank)
    if not same_on_all_ranks(list(arrays.values()), dev):
        raise AssertionError("17: the ranks served different bits")
    if rank == 0:
        for name, spec in (("plain", None), ("spec", SHARD17_SPECULATIVE)):
            base, _, base_logits = shard17_run(executor, pcfg, order, None,
                                               spec)
            responses, logits = runs[name]
            ties, worst = shard17_against_unsharded(
                f"17 {name}", responses, logits, base, base_logits)
            report[f"{name}_against_unsharded"] = {
                "ties": ties, "worst_rel": worst,
                "tokens": [r.tokens.tolist() for r in responses],
                "unsharded_tokens": [r.tokens.tolist() for r in base]}
            log(f"[shard17] rank 0 {name}: tokens "
                f"{[r.tokens.tolist()[0] for r in responses]} against the "
                f"unsharded engine's "
                f"{[r.tokens.tolist()[0] for r in base]}: {len(ties)} near "
                f"ties (at most {MAX_TIES}); answer and mask logits "
                f"{worst:.3g} norm-wise (limit {PATH_RTOL})")
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[shard17] rank {rank}: peak memory {report['peak_gib']:.2f} GiB "
        f"(this process)")
    return report, arrays


def shard17_rank(args):
    """A rank process of phase 17 (``--rank``, from ``shard17_phase``):
    joins the gloo group on cuda:0, serves, writes its report and arrays
    into ``--shard17-out``."""
    from repro_torch.launch import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh_lib.init_rank(args.rank, args.world, args.init, "cuda",
                             timeout_s=SHARD17_COLLECTIVE_S)
    import torch.distributed as dist
    try:
        with torch.inference_mode():
            report, arrays = shard17_serve(args.rank, args.seed, dev)
        with open(os.path.join(args.shard17_out,
                               f"rank{args.rank}.json"), "w") as f:
            json.dump(report, f, default=str)
        np.savez(os.path.join(args.shard17_out, f"rank{args.rank}.npz"),
                 **arrays)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def shard17_phase(seed):
    """Phase 17: two rank processes on cuda:0 over gloo
    (``launch.mesh.spawn_ranks``), each as ``shard17_serve``; the ranks'
    served arrays must be bit-equal. Returns both reports."""
    from repro_torch.launch import mesh as mesh_lib
    import tempfile
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = mesh_lib.spawn_ranks(
            [os.path.abspath(__file__), "--seed", str(seed),
             "--shard17-out", tmp], SHARD17_RANKS, SHARD17_TIMEOUT_S)
        wall = time.perf_counter() - t0
        for r, out in enumerate(outs):
            for line in out.splitlines():
                log(f"[rank {r}] {line}")
        reports, arrays = [], []
        for r in range(SHARD17_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
                arrays.append({k: z[k] for k in z.files})
    if set(arrays[0]) != set(arrays[1]) or not all(
            np.array_equal(arrays[0][k], arrays[1][k]) for k in arrays[0]):
        raise AssertionError("17: the ranks' served arrays differ")
    for rep in reports:
        log(f"[shard17] rank {rep['rank']}: peak {rep['peak_gib']:.2f} GiB; "
            f"decode step {rep['plain']['decode_step_ms_median']:.2f} ms "
            f"with {rep['plain']['decode_all_reduces_a_step'][0]} "
            f"all-reduces in {rep['plain']['decode_all_reduce_ms_median']:.2f}"
            f" ms; verify step {rep['spec']['verify_step_ms_median']:.2f} ms "
            f"with {rep['spec']['verify_all_reduces_a_step'][0]} all-reduces "
            f"in {rep['spec']['verify_all_reduce_ms_median']:.2f} ms (gloo "
            f"staged through the host on one card: says nothing of NCCL "
            f"over NVLink); {card}")
    log(f"[shard17] {len(arrays[0])} served arrays bit-equal on both ranks; "
        f"phase wall {wall:.1f} s")
    return {"ranks": reports, "wall_s": wall, "card": card}


# ---------------------------------------------------------------------------
# phase 18: the dry-run, and the pod-disaggregated split step over two ranks
# ---------------------------------------------------------------------------

SPLIT18_RANKS = 2
# the rank processes (a rank's LISA-7B takes tens of seconds to build) and
# one collective; the dry-run's children, all started together
SPLIT18_TIMEOUT_S = 420
SPLIT18_COLLECTIVE_S = 300
DRYRUN18_TIMEOUT_S = 300
# one device's share of the 2x16x16 mesh's 32 images (split_reckoning)
SPLIT18_BATCH = 2
SPLIT18_RATIO = 0.25
# 18b's oracle of the kernel run, which holds on any seed: the encode
# kernel's codes against a float64 encode's (at most this share of entries
# off; seeds 0-3 read 5.4e-5 to 6.5e-5), and its masks off the plain
# step's within this many times the distance of the plain step re-summed
# in another order, a control with no kernel (seeds 0-3 read ratios 0.94
# to 1.09). A fixed limit measured the random SAM tail's conditioning:
# the control alone read 0.0281 to 0.105 over those seeds.
SPLIT18_CODES_OFF = 1e-4
SPLIT18_MASK_RATIO = 1.5
# the combos adapt_config skips (the reference's; tests/test_torch_dryrun.py)
DRYRUN18_SKIPPED = {("hubert-xlarge", "decode_32k"),
                    ("hubert-xlarge", "long_500k")}


def _port_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")] + [p for p in env.get(
            "PYTHONPATH", "").split(os.pathsep) if p])
    return env


def dryrun18_start(out_dir):
    """18a: ``python -m repro_torch.launch.dryrun --arch A --mesh both``
    for every architecture and ``python -m repro_torch.launch.serve
    --dryrun``, one child process each, all started together. Returns
    {name: process}."""
    from repro_torch.configs import ARCH_IDS
    procs = {}
    for arch in ARCH_IDS:
        procs[arch] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--mesh", "both", "--out", out_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_port_env(), cwd=REPO)
    procs["serve"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--dryrun"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_port_env(), cwd=REPO)
    return procs


def dryrun18_finish(procs, out_dir, t0):
    """Wait for 18a's children (DRYRUN18_TIMEOUT_S from ``t0``, then every
    child still running is killed and the phase fails): each exits 0,
    logs one line a combo, and writes one record a combo, none with an
    error; the skipped combos are exactly DRYRUN18_SKIPPED, which is
    where ``adapt_config`` returns None."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import dryrun
    outs, failed = {}, []
    try:
        for name, p in procs.items():
            left = max(1.0, DRYRUN18_TIMEOUT_S - (time.perf_counter() - t0))
            try:
                outs[name] = p.communicate(timeout=left)[0]
            except subprocess.TimeoutExpired:
                failed.append(f"{name}: still running after "
                              f"{DRYRUN18_TIMEOUT_S} s")
                break
            if p.returncode != 0:
                failed.append(f"{name}: exit {p.returncode}\n"
                              f"{outs[name][-2000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed:
        raise AssertionError("18a: " + "; ".join(failed))
    wall = time.perf_counter() - t0
    lines = [ln for name in ARCH_IDS for ln in outs[name].splitlines()
             if ln.startswith("[dryrun]")]
    for ln in lines:
        log(f"[split18] {ln}")
    want = {(a, s): dryrun.adapt_config(get_config(a), dryrun.SHAPES[s])
            is None for a in ARCH_IDS for s in dryrun.SHAPES}
    if {k for k, v in want.items() if v} != DRYRUN18_SKIPPED:
        raise AssertionError(f"18a: adapt_config skips "
                             f"{sorted(k for k, v in want.items() if v)}")
    recs = []
    for (arch, shape) in want:
        for mesh in ("16x16", "2x16x16"):
            with open(os.path.join(out_dir, f"{arch}__{shape}__{mesh}"
                                   ".json")) as f:
                recs.append(json.load(f))
    errors = [r for r in recs if r.get("error")]
    skipped = {(r["arch"], r["shape"]) for r in recs if r.get("skipped")}
    if errors or skipped != DRYRUN18_SKIPPED or len(lines) != len(recs):
        first = [(r["arch"], r["shape"], r["error"]) for r in errors[:3]]
        raise AssertionError(f"18a: {len(errors)} errors {first}, skipped "
                             f"{sorted(skipped)}, {len(lines)} lines for "
                             f"{len(recs)} records")
    serve = [ln for ln in outs["serve"].splitlines()
             if ln.startswith("[serve-dryrun]")]
    for ln in serve:
        log(f"[split18] {ln}")
    costed = [r for r in recs if "flops" in r]
    log(f"[split18] 18a: {len(recs)} dry-run records ({len(costed)} with "
        f"costs, {2 * len(DRYRUN18_SKIPPED)} skipped, no error) in "
        f"{wall:.1f} s wall, {len(procs)} child processes")
    return {"records": len(recs), "costed": len(costed),
            "skipped": sorted(skipped), "wall_s": wall,
            "serve_dryrun": serve,
            "bottlenecks": {f"{r['arch']}__{r['shape']}": r["bottleneck"]
                            for r in costed}}


def split18_kernel_cases(pcfg):
    """18c: the split step's encode and decode at their shape there: one
    device's 2 images (T = 8,192) at d = 1,280 and the rank of
    SPLIT18_RATIO, bf16 x and the float32 bottleneck weights."""
    from repro_torch.core.bottleneck import rank_for_ratio
    d, T = pcfg.sam.d_model, pcfg.sam_tokens
    r = rank_for_ratio(d, SPLIT18_RATIO, 2)
    name = f"split_T{SPLIT18_BATCH * T}_r{r}"
    enc = dict(name=name, lead=(SPLIT18_BATCH, T), d=d, r=r,
               x_dtype=pcfg.sam.adtype, w_dtype=torch.float32,
               w_scale=d ** -0.5)
    dec = dict(name=name, lead=(SPLIT18_BATCH, T), d=d, r=r,
               w_dtype=torch.float32, out_dtype=pcfg.sam.adtype,
               w_scale=r ** -0.5)
    return enc, dec


def _captured(module, name, seen):
    """A stand-in for a kernel wrapper that records each call's inputs
    and output before returning it."""
    real = getattr(module, name)

    def run(*args):
        out = real(*args)
        seen.append((args, out))
        return out
    return mock.patch.object(module, name, run)


def encode_f64(params, x):
    """The plain encode's function with nothing rounded before the codes:
    x @ W_enc in float64, the absmax scale, codes int8 and scales float32
    (18b's witness of which encode sits nearer the true codes)."""
    z = x.double() @ params["enc"].double()
    s = torch.amax(torch.abs(z), dim=-1, keepdim=True) / 127.0 + 1e-8
    codes = torch.clamp(torch.round(z / s), -127, 127).to(torch.int8)
    return codes, s.float()


def decode_resummed(params, codes, scales, out_dtype):
    """The plain decode with its float32 sum over the rank taken in two
    halves: as exact as the plain one, in another order (18b's control of
    how far the path moves for no loss of precision)."""
    z = codes.float() * scales
    w = params["dec"].float()
    h = z.shape[-1] // 2
    return (z[..., :h] @ w[:h] + z[..., h:] @ w[h:]).to(out_dtype)


def split18_serve(rank, seed, dev):
    """One rank of 18b: LISA-7B at full width from ``seed`` and the split
    bottleneck (r of SPLIT18_RATIO, float32), one device's 2 images at
    1,024 px and queries of 8 (``serve.split_inputs``), over
    ``make_named_mesh({"pod": 2})``. Its held argument bytes must equal
    ``split_reckoning``'s per device; ``split_serve`` runs plain (twice:
    cold, then warm and timed) and with ``use_kernel=True``, counters from
    0: the plain runs launch nothing, the kernel run one encode and one
    decode, each held against its plain version on its own inputs; the
    bytes that crossed equal the reckoned collective-permute bytes. Rank 0
    also composes the stage functions in one process, on its codes, on
    zero codes, on a float64 encode's codes (``encode_f64``, the witness),
    on the kernel's codes through the plain decode, and on its codes
    through ``decode_resummed`` (the control), and reads how many of the
    plain and the kernel codes differ from the witness's (the oracle of
    the kernel run, held in ``split18_ranks``). Returns (report,
    arrays)."""
    from repro_torch.configs import get_lisa_config
    from repro_torch.core import bottleneck as bn
    from repro_torch.core import vlm
    from repro_torch.kernels.bottleneck import ops as bops
    from repro_torch.kernels.bottleneck import ref as bref
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_named_mesh
    from repro_torch.models.stack import leaves
    pcfg = get_lisa_config("lisa-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = _sync_s()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = vlm.init_lisa(pcfg, gen, dev)
    d = pcfg.sam.d_model
    r = bn.rank_for_ratio(d, SPLIT18_RATIO, 2)
    bnp = bn.init_bottleneck(gen, bn.BottleneckSpec(d, r, 2), device=dev)
    images, query = serve.split_inputs(pcfg, SPLIT18_BATCH, seed, dev)
    mesh = make_named_mesh({"pod": SPLIT18_RANKS})
    init_s = _sync_s() - t0
    reck = serve.split_reckoning(pcfg)
    held = {"params": sum(t.nbytes for t in leaves(params)),
            "bottleneck": sum(t.nbytes for t in leaves(bnp)),
            "images": images.nbytes, "query": query.nbytes}
    held["total"] = sum(held.values())
    if held != reck["device_bytes"]:
        raise AssertionError(f"18b rank {rank}: holds {held}, the "
                             f"reckoning {reck['device_bytes']}")
    cp = reck["collectives"]["collective-permute"]
    pod = mesh.coords["pod"]
    report = {"rank": rank, "pod": pod, "init_s": init_s, "held": held,
              "reckoned_permute_bytes": cp}

    def run(use_kernel):
        mesh.sent_bytes = mesh.received_bytes = 0
        _reset_launch_counts()
        t1 = _sync_s()
        masks, ans = serve.split_serve(params, bnp, pcfg, images, query,
                                       mesh, use_kernel=use_kernel)
        wall = _sync_s() - t1
        crossed = mesh.sent_bytes if pod == 0 else mesh.received_bytes
        other = mesh.received_bytes if pod == 0 else mesh.sent_bytes
        if (crossed, other) != (cp, 0):
            raise AssertionError(f"18b rank {rank}: {crossed} bytes crossed "
                                 f"(and {other} back), reckoned {cp}")
        return masks, ans, wall, _launch_counts()

    walls = []
    for _ in range(2):
        masks, ans, wall, counts = run(False)
        walls.append(wall)
        if counts != _only():
            raise AssertionError(f"18b rank {rank}: the plain step launched "
                                 f"{counts}")
    enc_seen, dec_seen = [], []
    with _captured(bops, "bottleneck_encode", enc_seen), \
            _captured(bops, "bottleneck_decode", dec_seen):
        masks_k, ans_k, wall_k, counts = run(True)
    want = _only(bottleneck_encode=1, bottleneck_decode=1)
    if counts != want or len(enc_seen) != 1 or len(dec_seen) != 1:
        raise AssertionError(f"18b rank {rank}: the kernel step launched "
                             f"{counts}, expected {want}")
    (x, w), (codes, scales) = enc_seen[0]
    want_c, want_s = bref.encode_ref(x.reshape(-1, d), w)
    max_diff, off, s_err = codes_held_against(
        f"18b rank {rank} encode", codes.reshape(-1, r),
        scales.reshape(-1, 1), want_c, want_s)
    (c_in, s_in, w_dec, out_dtype), out = dec_seen[0]
    want_out = bref.decode_ref(c_in.reshape(-1, r), s_in.reshape(-1, 1),
                               w_dec, out_dtype)
    dec_err = held_against(f"18b rank {rank} decode", out.reshape(-1, d),
                           want_out, DECODE_TOL[out_dtype])
    # pod 0 decodes the zeros it received: equal bits, a zero norm
    mask_rel = 0.0 if torch.equal(masks_k, masks) else _rel(masks_k, masks)
    if not torch.equal(ans_k, ans):
        raise AssertionError(f"18b rank {rank}: the kernel step's answers "
                             f"differ from the plain step's")
    report.update(
        wall_cold_s=walls[0], wall_s=walls[1], wall_kernel_s=wall_k,
        launches=counts, encode={"codes_max_diff": max_diff,
                                 "codes_off_frac": off,
                                 "scales_max_abs_err": s_err},
        decode_max_abs_err=dec_err, mask_rel_kernel=mask_rel,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    arrays = {"masks": masks.float().cpu().numpy(),
              "masks_kernel": masks_k.float().cpu().numpy(),
              "answers": ans.float().cpu().numpy()}
    if rank == 0:
        a = vlm.sam_head(params, pcfg, images)
        codes, scales = bn.encode(bnp, a)
        codes64, scales64 = encode_f64(bnp, a)
        # the kernel run's codes are pod 0's, the ones that crossed
        codes_k = enc_seen[0][1][0].reshape(codes.shape)
        report["codes_off_f64"] = {
            "plain": float((codes != codes64).double().mean()),
            "kernel": float((codes_k != codes64).double().mean())}
        ctx = vlm.clip_encode(params, pcfg, images)
        comp_ans, seg = vlm.llm_reason(params, pcfg, ctx, query)
        arrays["comp_answers"] = comp_ans.float().cpu().numpy()
        scales_k = enc_seen[0][1][1].reshape(scales.shape)
        for tag, (c, sc) in (("pod1", (codes, scales)),
                             ("pod0", (torch.zeros_like(codes),
                                       torch.zeros_like(scales))),
                             ("f64", (codes64, scales64)),
                             ("kcodes", (codes_k, scales_k)),
                             ("ctrl", (codes, scales))):
            if tag == "ctrl":
                a_hat = decode_resummed(bnp, c, sc, pcfg.sam.adtype)
            else:
                a_hat = bn.decode(bnp, c, sc, out_dtype=pcfg.sam.adtype)
            feats = vlm.sam_tail(params, pcfg, a_hat)
            arrays[f"comp_masks_{tag}"] = vlm.mask_decode(
                params, pcfg, feats, seg).float().cpu().numpy()
    log(f"[split18] rank {rank} (pod {pod}): LISA-7B and the r = {r} "
        f"bottleneck in {init_s:.1f} s, held {held['total']} B = the "
        f"reckoning; split step wall {walls[1] * 1e3:.1f} ms warm "
        f"({walls[0] * 1e3:.1f} cold), {wall_k * 1e3:.1f} ms with the "
        f"kernels; {cp} B crossed the pod link (the reckoning's); kernel "
        f"launches {counts}: codes off <= {max_diff} on {off:.3g}, scales "
        f"{s_err:.3g}, decode {dec_err:.3g}, masks {mask_rel:.3g} off the "
        f"plain step's; peak "
        f"{report['peak_gib']:.2f} GiB (gloo staged through the host)")
    return report, arrays


def split18_rank(args):
    """A rank process of 18b (``--rank`` with ``--split18-out``): joins
    the gloo group on cuda:0, runs ``split18_serve``, writes its report
    and arrays into ``--split18-out``."""
    from repro_torch.launch import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh_lib.init_rank(args.rank, args.world, args.init, "cuda",
                             timeout_s=SPLIT18_COLLECTIVE_S)
    import torch.distributed as dist
    try:
        with torch.inference_mode():
            report, arrays = split18_serve(args.rank, args.seed, dev)
        with open(os.path.join(args.split18_out,
                               f"rank{args.rank}.json"), "w") as f:
            json.dump(report, f, default=str)
        np.savez(os.path.join(args.split18_out, f"rank{args.rank}.npz"),
                 **arrays)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def split18_ranks(seed):
    """18b: two rank processes of ``split18_serve`` on cuda:0 over gloo;
    pod 1's masks and both pods' answers bit-equal to rank 0's one-process
    composition, pod 0's masks bit-equal to that composition on zero
    codes."""
    from repro_torch.launch import mesh as mesh_lib
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = mesh_lib.spawn_ranks(
            [os.path.abspath(__file__), "--seed", str(seed),
             "--split18-out", tmp],
            SPLIT18_RANKS, SPLIT18_TIMEOUT_S)
        wall = time.perf_counter() - t0
        for r, out in enumerate(outs):
            for line in out.splitlines():
                log(f"[rank {r}] {line}")
        reports, arrays = [], []
        for r in range(SPLIT18_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
                arrays.append({k: z[k] for k in z.files})
    comp = arrays[0]
    checks = {"pod 1 masks": (arrays[1]["masks"], comp["comp_masks_pod1"]),
              "pod 0 masks": (arrays[0]["masks"], comp["comp_masks_pod0"]),
              "pod 1 answers": (arrays[1]["answers"], comp["comp_answers"]),
              "pod 0 answers": (arrays[0]["answers"], comp["comp_answers"])}
    for label, (got, want) in checks.items():
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"18b: {label} differ from the one-process "
                                 f"composition (max "
                                 f"{np.abs(got - want).max():.3g})")
    if np.array_equal(arrays[0]["masks"], arrays[1]["masks"]):
        raise AssertionError("18b: both pods' masks equal; the codes did "
                             "not cross")
    # the witness: how far pod 1's plain and kernel masks each sit from
    # the masks of a float64 encode's codes
    witness = {"seed": seed,
               "mask_rel_kernel_plain": reports[1]["mask_rel_kernel"],
               "mask_rel_plain_f64": _rel(arrays[1]["masks"],
                                          comp["comp_masks_f64"]),
               "mask_rel_kernel_f64": _rel(arrays[1]["masks_kernel"],
                                           comp["comp_masks_f64"]),
               # the kernel run split at its two kernels: its codes (plain
               # decode) against the witness's, then its decode
               "mask_rel_kcodes_f64": _rel(comp["comp_masks_kcodes"],
                                           comp["comp_masks_f64"]),
               "mask_rel_kernel_kcodes": _rel(arrays[1]["masks_kernel"],
                                              comp["comp_masks_kcodes"]),
               "mask_rel_control_plain": _rel(comp["comp_masks_ctrl"],
                                              comp["comp_masks_pod1"]),
               "codes_off_f64": reports[0]["codes_off_f64"]}
    log(f"[split18] 18b: pod 1's masks and both pods' answers bit-equal to "
        f"one process composing the stages, pod 0's masks to it on zero "
        f"codes; ranks' wall {wall:.1f} s")
    # the oracle of the kernel run: its codes against the float64
    # encode's, and its masks off the plain step's against the control's
    codes_off = witness["codes_off_f64"]["kernel"]
    mask_limit = SPLIT18_MASK_RATIO * witness["mask_rel_control_plain"]
    log(f"[split18] 18b witness, seed {seed}: pod 1's kernel masks "
        f"{witness['mask_rel_kernel_plain']:.4g} off the plain step's "
        f"(limit {mask_limit:.4g}: {SPLIT18_MASK_RATIO} x the control); "
        f"the kernel's codes off the float64 codes {codes_off:.4g} (limit "
        f"{SPLIT18_CODES_OFF}); against a float64 encode's masks: plain "
        f"{witness['mask_rel_plain_f64']:.4g}, kernel "
        f"{witness['mask_rel_kernel_f64']:.4g} (its codes through the "
        f"plain decode {witness['mask_rel_kcodes_f64']:.4g}, its decode "
        f"after them {witness['mask_rel_kernel_kcodes']:.4g}); the plain "
        f"step re-summed in another order (control) "
        f"{witness['mask_rel_control_plain']:.4g} off it; codes off the "
        f"float64 codes: plain {witness['codes_off_f64']['plain']:.4g}, "
        f"kernel {witness['codes_off_f64']['kernel']:.4g}")
    if not codes_off <= SPLIT18_CODES_OFF:
        raise AssertionError(f"18b: the kernel's codes {codes_off:.4g} off "
                             f"the float64 encode's (limit "
                             f"{SPLIT18_CODES_OFF})")
    if not witness["mask_rel_kernel_plain"] <= mask_limit:
        raise AssertionError(f"18b: the kernel step's masks "
                             f"{witness['mask_rel_kernel_plain']:.4g} off "
                             f"the plain step's, past {SPLIT18_MASK_RATIO} x "
                             f"the re-summed control's "
                             f"{witness['mask_rel_control_plain']:.4g}")
    return {"ranks": reports, "wall_s": wall, "witness": witness}


def split18_phase(seed, dev, shard17):
    """Phase 18: (a) the dry-run CLI over every arch x shape on both
    meshes, and ``serve --dryrun``, in child processes on the host's
    cores; while they run, (c) the encode and decode kernels timed at the
    split step's shape and (b) the split step over two ranks; then (d)
    the reckoning of LISA-7B's LLM decode step on a (1, 2) mesh against
    phase 17's counted all-reduces. Returns the report."""
    import tempfile
    from repro_torch.configs import get_lisa_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    pcfg = get_lisa_config("lisa-7b")
    card = card_line()
    report = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = dryrun18_start(tmp)
        try:
            enc, dec = split18_kernel_cases(pcfg)
            report["encode"] = check_bottleneck_encode(
                case_rng(seed, enc["name"]), enc, dev, timed=True)
            report["decode"] = check_bottleneck_decode(
                case_rng(seed, dec["name"]), dec, dev, timed=True)
            gc.collect()
            torch.cuda.empty_cache()
            log(f"[split18] 18c: encode {report['encode']['ms']:.4f} ms, "
                f"decode {report['decode']['ms']:.4f} ms at T = "
                f"{report['encode']['T']}, r = {report['encode']['r']}; "
                f"{card}")
            report["split"] = split18_ranks(seed)
        except BaseException:
            for p in procs.values():
                p.kill()
                p.wait()
            raise
        report["dryrun"] = dryrun18_finish(procs, tmp, t0)
    # 18d: phase 17's decode steps against the reckoning
    mesh = Mesh({"data": 1, "model": SHARD17_RANKS})
    seen = {}
    for rep in shard17["ranks"]:
        for step in rep["plain"]["step_times"]["cloud_decode_rows"]:
            key = (step["rows"], step["all_reduces"],
                   step["all_reduce_bytes"])
            seen[key] = seen.get(key, 0) + 1
    if not seen:
        raise AssertionError("18d: phase 17 recorded no decode step")
    matched = []
    for rows, n, nbytes in seen:
        want = dryrun.reckon_lisa_decode(pcfg, mesh, rows, 64)
        coll = want["collectives"]
        if (coll["count"], coll["all-reduce"], coll["total"]) != \
                (n, nbytes, nbytes):
            raise AssertionError(f"18d: phase 17 counted {n} all-reduces of "
                                 f"{nbytes} B a step of {rows} rows; the "
                                 f"reckoning {coll}")
        matched.append({"rows": rows, "all_reduces": n, "bytes": nbytes,
                        "steps": seen[(rows, n, nbytes)],
                        "kinds": want["kinds"]})
    log(f"[split18] 18d: the reckoning of LISA-7B's decode step on (1, 2) "
        f"({matched[0]['kinds']} cut) equals phase 17's counted "
        f"all-reduces: {matched}")
    report["reckoned_decode"] = matched
    report["launches"] = {
        k: sum(r["launches"][k] for r in report["split"]["ranks"])
        for k in ("bottleneck_encode", "bottleneck_decode")}
    return report


# ---------------------------------------------------------------------------
# phase 19: the sharded train step over two ranks
# ---------------------------------------------------------------------------

TRAIN19_ARCH = "qwen2-vl-2b"
# full width, cut to 4 of its 28 layers so that whole trees are compared;
# float32 (TF32 off), phase 15's global batch, two AdamW steps at eps 1e-4
TRAIN19_LAYERS = 4
TRAIN19_BATCH, TRAIN19_SEQ = TRAIN15_BATCH, TRAIN15_SEQ
TRAIN19_STEPS = 2
TRAIN19_LR, TRAIN19_EPS = TRAIN15_LR, TRAIN15_EPS
# (b) FSDP over data ranks, (c) tensor parallel over model ranks:
# (label, data, model, fsdp)
TRAIN19_MESHES = (("b", 2, 1, True), ("c", 1, 2, False))
# the metrics against (a); each leaf of the parameters and moments within
# TRAIN19_LEAF_TOL of its largest magnitude in (a)
TRAIN19_METRIC_RTOL = 1e-5
TRAIN19_LEAF_TOL = 1e-4
TRAIN19_TIMEOUT_S = 420


def train19_config():
    from repro_torch.configs import get_config
    return get_config(TRAIN19_ARCH).replace(
        num_layers=TRAIN19_LAYERS, param_dtype="float32",
        act_dtype="float32")


def train19_batch(cfg, seed, dev):
    from repro_torch.data import lm
    nb = lm.lm_batch(np.random.RandomState(seed), cfg, TRAIN19_BATCH,
                     TRAIN19_SEQ)
    return {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}


def train19_unsharded(cfg, params, batch):
    """(a) The unsharded port step, TRAIN19_STEPS times: (params, state,
    metrics a step, step walls)."""
    from repro_torch import optim
    from repro_torch.models import make_train_step
    opt = optim.adamw(TRAIN19_LR, eps=TRAIN19_EPS)
    step = make_train_step(cfg, opt)
    p, s = params, opt.init(params)
    metrics, walls = [], []
    for _ in range(TRAIN19_STEPS):
        t0 = _sync_s()
        p, s, m = step(p, s, batch)
        walls.append(_sync_s() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return p, s, metrics, walls


def train19_spawn(label, data, model, fsdp, case, tmp):
    """One spawn of ``python -m repro_torch.sharding.training`` over
    data x model gloo ranks on cuda:0, its outputs into ``tmp/label``.
    Returns (the ranks' outputs, the spawn's wall)."""
    from repro_torch.launch import mesh as mesh_lib
    out_dir = os.path.join(tmp, label)
    os.makedirs(out_dir)
    argv = ["-m", "repro_torch.sharding.training", "--case", case,
            "--data", str(data), "--model", str(model), "--out", out_dir,
            "--timeout", str(TRAIN19_TIMEOUT_S)] + (
                ["--fsdp"] if fsdp else [])
    t0 = time.perf_counter()
    outs = mesh_lib.spawn_ranks(argv, data * model, TRAIN19_TIMEOUT_S)
    return outs, time.perf_counter() - t0


def train19_mesh(label, data, model, fsdp, case, cfg, want, want_metrics,
                 reckoned, spawned, card, dev):
    """One spawn's ranks (``train19_spawn``): metrics against (a), the
    reassembled parameters and moments against (a) leaf by leaf, blocks
    two ranks hold bit-equal (``training.assemble``), each rank's
    collectives held to the reckoning, and each rank's walls and peak
    memory."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import dryrun
    from repro_torch.sharding import specs as sh
    from repro_torch.sharding import training
    world = data * model
    outs, spawn_s = spawned
    out_dir = os.path.join(os.path.dirname(case), label)
    for r, out in enumerate(outs):
        for line in out.splitlines():
            log(f"[rank {r}] {line}")
    ranks = training.load_outputs(out_dir, case, world)
    shape = {"data": data, "model": model}
    for r, o in enumerate(ranks):
        if o["metrics"] != ranks[0]["metrics"]:
            raise AssertionError(f"19{label}: rank {r}'s metrics differ")
        if o["step"] != TRAIN19_STEPS:
            raise AssertionError(f"19{label}: rank {r} at step {o['step']}")
    metric_rel = 0.0
    for mine, ref in zip(ranks[0]["metrics"], want_metrics):
        for k in ref:
            rel = abs(mine[k] - ref[k]) / max(abs(ref[k]), 1e-30)
            metric_rel = max(metric_rel, rel)
            if rel > TRAIN19_METRIC_RTOL:
                raise AssertionError(f"19{label}: {k} {mine[k]!r} against "
                                     f"(a)'s {ref[k]!r} (rel {rel:.3g})")
    specs = sh.param_specs(cfg, want["params"], mesh_lib.Mesh(shape),
                           fsdp=fsdp)
    worst = (0.0, "")
    for tree in ("params", "m", "v"):
        whole = training.assemble([o[tree] for o in ranks], specs, shape)
        for (path, a), (_, b) in zip(sh.leaves_with_paths(want[tree]),
                                     sh.leaves_with_paths(whole)):
            b = b.to(dev)
            err = float((b - a).abs().max() / a.abs().max().clamp_min(
                1e-30))
            worst = max(worst, (err, f"{tree}/{'/'.join(path)}"))
        del whole
    if not worst[0] <= TRAIN19_LEAF_TOL:
        raise AssertionError(f"19{label}: {worst[1]} {worst[0]:.3g} of its "
                             f"largest magnitude off (a) (limit "
                             f"{TRAIN19_LEAF_TOL})")
    held = None
    for o in ranks:
        for seen in o["collectives"]:
            held = dryrun.held_to_reckoning(reckoned, seen)
    per_rank = [{"wall_ms": [w * 1e3 for w in o["wall_s"]],
                 "collective_ms": [c * 1e3 for c in o["collective_s"]],
                 "peak_gib": (o["peak_bytes"] or 0) / 2 ** 30,
                 "collectives": o["collectives"][-1]} for o in ranks]
    log(f"[train19] ({label}) {data} data x {model} model ranks"
        f"{' with FSDP' if fsdp else ''}: metrics {metric_rel:.3g} off (a) "
        f"(limit {TRAIN19_METRIC_RTOL}); worst leaf {worst[1]} "
        f"{worst[0]:.3g} of its largest magnitude (limit "
        f"{TRAIN19_LEAF_TOL}); every block two ranks hold bit-equal; "
        f"collectives held to the reckoning, departures "
        f"{json.dumps(held['departures'])}; spawn {spawn_s:.1f} s")
    for r, rep in enumerate(per_rank):
        log(f"[train19] ({label}) rank {r}: step walls "
            f"{[round(w, 1) for w in rep['wall_ms']]} ms, of which "
            f"collectives {[round(c, 1) for c in rep['collective_ms']]} ms "
            f"(gloo staged through the host on one card, beside the other "
            f"mesh's ranks: says nothing of NCCL over NVLink); peak "
            f"{rep['peak_gib']:.2f} GiB; {card}")
    return {"data": data, "model": model, "fsdp": fsdp,
            "metric_rel": metric_rel, "worst_leaf": list(worst),
            "held": held, "ranks": per_rank, "spawn_s": spawn_s}


def train19_phase(seed, dev):
    """Phase 19: qwen2-vl-2b at full width, 4 layers, float32 with TF32
    off: (a) the unsharded port step in this process, then (b) two gloo
    ranks on cuda:0 at (data 2, model 1) with FSDP and (c) at (1, 2),
    each held to (a) and to the reckoning (``train19_mesh``)."""
    import tempfile
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import init_params
    from repro_torch.sharding import training
    card = card_line()
    cfg = train19_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, dev)
    batch = train19_batch(cfg, seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    p, s, metrics, walls = train19_unsharded(cfg, params, batch)
    if _launch_counts() != _only():
        raise AssertionError(f"19a launched {_launch_counts()}")
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"19a: metrics {metrics}")
    report = {"card": card, "unsharded": {
        "metrics": metrics, "wall_ms": [w * 1e3 for w in walls],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}}
    log(f"[train19] (a) {TRAIN19_ARCH} at full width, {cfg.num_layers} "
        f"layers, float32: {sum(t.numel() for t in _leaves(params)):,} "
        f"parameters, B = {TRAIN19_BATCH} x S = {TRAIN19_SEQ}; losses "
        f"{[m['loss'] for m in metrics]}, grad_norm "
        f"{[m['grad_norm'] for m in metrics]}; step walls "
        f"{[round(w * 1e3, 1) for w in walls]} ms; peak "
        f"{report['unsharded']['peak_gib']:.2f} GiB; {card}")
    want = {"params": p, "m": s["m"], "v": s["v"]}
    shape19 = dryrun.ShapeSpec("train19", TRAIN19_SEQ, TRAIN19_BATCH,
                               "train")
    with tempfile.TemporaryDirectory() as tmp:
        case = os.path.join(tmp, "train19.pt")
        training.save_case(case, cfg, params, batch, TRAIN19_LR,
                           TRAIN19_EPS, TRAIN19_STEPS, tf32=False)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        # both meshes' ranks at once, on the one card; the reckonings
        # meanwhile, here
        env = {"PYTHONPATH": _port_env()["PYTHONPATH"]}
        with mock.patch.dict(os.environ, env), \
                concurrent.futures.ThreadPoolExecutor(
                    len(TRAIN19_MESHES)) as pool:
            spawns = {label: pool.submit(train19_spawn, label, data, model,
                                         fsdp, case, tmp)
                      for label, data, model, fsdp in TRAIN19_MESHES}
            reckoned = {label: dryrun.reckon(
                cfg, shape19, Mesh({"data": data, "model": model}),
                fsdp=fsdp)["by_label"]
                for label, data, model, fsdp in TRAIN19_MESHES}
            spawned = {label: f.result() for label, f in spawns.items()}
        for label, data, model, fsdp in TRAIN19_MESHES:
            report[label] = train19_mesh(
                label, data, model, fsdp, case, cfg, want, metrics,
                reckoned[label], spawned[label], card, dev)
    return report


# ---------------------------------------------------------------------------
# phase 20: zamba2-7b and nemotron-4-340b through the flash and decode
# kernels, at head sizes 112 and 192
# ---------------------------------------------------------------------------

# each config of the phase with its count of parameters (the reference's
# count_params) and its depth cut: zamba2-7b whole (81 Mamba-2 layers and a
# shared attention block of 32 heads at hd 112), nemotron-4-340b at full
# widths cut to 2 of its 96 layers (96 query and 8 kv heads at hd 192)
ZOO20 = {"zamba2-7b": 6_751_130_832, "nemotron-4-340b": 16_345_387_008}
ZOO20_CUT = {"nemotron-4-340b": 2}
# A replay's distance is held to PATH_RTOL, or, where the path's own
# conditioning puts that out of reach, to this multiple of its control's:
# the same path with the kernel's function summed in float64 (no kernel,
# other roundings; ``_flash_f64``, ``_decode_f64``). Random zamba2-7b at
# full depth grows any rounding of its 9 attention outputs: its float64
# control reads 0.076 at the prefill's last logits and 0.0653 over the
# decode steps, the kernels 0.0829 and 0.0698 on an H100 (PERF.md §6),
# while every layer holds LAYER_RTOL on its own input. The ratio is
# SPLIT18_MASK_RATIO's. Tokens against use_flash_decode=False take the
# same ratio of the largest moves of the two tokens' logits and margin
# between the runs with no kernel (the control, the replay and
# use_flash_decode=False) as their near-tie scales where those pass
# TIE_ULPS (``decode_ties``).
ZOO20_CONTROL_RATIO = 1.5


def zoo20_config(name):
    """The phase's config: full widths, the three kernel switches on, and
    the cut of ZOO20_CUT."""
    from repro_torch.configs import get_config
    cfg = get_config(name).replace(use_flash=True, use_flash_decode=True,
                                   use_ssm_kernel=True)
    if name in ZOO20_CUT:
        cfg = cfg.replace(num_layers=ZOO20_CUT[name])
    return cfg


def attention_invocations(cfg):
    """Attention blocks one pass runs, from the group specs: a dense or
    moe group's layers, and a hybrid group's shared block once a group."""
    from repro_torch.models import stack
    return sum(g.count for g in stack.layer_groups(cfg)
               if g.kind in ("dense", "moe", "hybrid"))


def mamba_layers(cfg):
    """Mamba layers one pass runs, from the group specs."""
    from repro_torch.models import stack
    return sum(g.count * (cfg.hybrid.attn_every if g.kind == "hybrid" else 1)
               for g in stack.layer_groups(cfg)
               if g.kind in ("hybrid", "mamba1", "mamba2"))


def _flash_f64(q, k, v, causal=True, block_q=128, block_k=128):
    """The flash kernel's function summed in float64 and rounded once to
    q's dtype: the plain version with other roundings and no kernel, the
    control of phase 20's replays."""
    from repro_torch.kernels.flash_attention.ref import NEG_INF
    B, S, H, hd = q.shape
    K = k.shape[2]
    scores = torch.einsum("bskgh,btkh->bkgst",
                          q.reshape(B, S, K, H // K, hd).double(),
                          k.double()) / math.sqrt(hd)
    if causal:
        above = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(above, NEG_INF)
    out = torch.einsum("bkgst,btkh->bskgh", torch.softmax(scores, dim=-1),
                       v.double())
    return out.reshape(B, S, H, hd).to(q.dtype)


def _decode_f64(q, k, v, bias):
    """The decode kernel's function in float64, rounded once to q's dtype
    (the control of phase 20's decode replay)."""
    B, H, hd = q.shape
    K = k.shape[2]
    scores = torch.einsum("bkgh,bwkh->bkgw",
                          q.reshape(B, K, H // K, hd).double(),
                          k.double()) / math.sqrt(hd) \
        + bias.double()[:, None, None, :]
    out = torch.einsum("bkgw,bwkh->bkgh", torch.softmax(scores, dim=-1),
                       v.double())
    return out.reshape(B, H, hd).to(q.dtype)


def replay_within(label, control, kernel):
    """A kernel run's distance from its plain-kernel replay, ``kernel``,
    held to PATH_RTOL or ZOO20_CONTROL_RATIO times the float64 control's
    distance from the same replay, ``control``, whichever is larger.
    Returns (control, kernel)."""
    limit = max(PATH_RTOL, ZOO20_CONTROL_RATIO * control)
    log(f"[zoo20] {label}: the float64 control vs the plain-kernel replay "
        f"{control:.3g}; the kernel run {kernel:.3g} (limit {limit:.3g}: "
        f"PATH_RTOL {PATH_RTOL:.3g} or {ZOO20_CONTROL_RATIO} x the "
        f"control's)")
    if not kernel <= limit:
        raise AssertionError(f"{label}: the kernel run {kernel:.3g} off "
                             f"the plain-kernel replay, beyond {limit:.3g}")
    return control, kernel


def zoo20_decode_checks(params, cfg, prompt, dev, n_attn):
    """(d) the prompt through ``decode_step`` and ZOO14_NEW_TOKENS greedy
    tokens, counters from 0: decode launches steps x attention
    invocations and no other kernel; the logits of every step against a
    replay with the decode kernel's plain version in its place,
    teacher-forced on the same tokens, the worst step beside the float64
    control's (``replay_within``); the tokens against
    ``use_flash_decode=False`` (12c's near-tie rule, ``decode_ties``, its
    scales widened to the moves of the two tokens' logits and margin
    between the control, the replay and that run); every decode layer of the plain-kernel replay held
    to LAYER_RTOL (``layer_check``); the logits at the prompt's last
    position against one prefill of the prompt (DECODE_PREFILL_RTOL)."""
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.models import prefill_step
    S = prompt.shape[1]
    steps = S + ZOO14_NEW_TOKENS
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = _sync_s()
    tokens, logits = zoo14_decode(params, cfg, prompt, dev)
    wall = _sync_s() - t0
    counts = _launch_counts()
    want = _only(decode_attention=steps * n_attn)
    log(f"[zoo20] {cfg.name} decode: prompt {S} + {ZOO14_NEW_TOKENS} greedy "
        f"tokens, {steps} steps in {wall:.2f} s; launches {counts} "
        f"(expected {want}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; tokens "
        f"{tokens.tolist()}")
    if counts != want:
        raise AssertionError(f"{cfg.name} decode: launches {counts}, "
                             f"expected {want}")
    if not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()) \
            or not all(bool(torch.isfinite(lg).all()) for lg in logits):
        raise AssertionError(f"{cfg.name}: bad decode tokens or logits")
    out = {"steps": steps, "wall_s": wall, "launches": counts,
           "tokens": tokens.tolist(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    with mock.patch.object(ops, "decode_attention",
                           ref.decode_attention_ref):
        _, replay = zoo14_decode(params, cfg, prompt, dev, forced=tokens)
    with mock.patch.object(ops, "decode_attention", _decode_f64):
        _, control = zoo14_decode(params, cfg, prompt, dev, forced=tokens)
    out["control_rel"], out["plain_replay_rel"] = replay_within(
        f"{cfg.name} decode logits (norm-wise, worst of {len(logits)} "
        f"steps)", max(_rel(a, b) for a, b in zip(control, replay)),
        max(_rel(a, b) for a, b in zip(logits, replay)))
    plain_tokens, plain_logits = zoo14_decode(
        params, cfg.replace(use_flash_decode=False), prompt, dev,
        forced=tokens)
    out["ties"] = decode_ties(
        f"{cfg.name} decode vs use_flash_decode=False", tokens, logits,
        plain_tokens, plain_logits, SDPA_PATH_RTOL, tag="zoo20",
        control=(control, replay))
    log(f"[zoo20] {cfg.name}: {ZOO_BATCH - len(out['ties'])} of {ZOO_BATCH} "
        f"rows' tokens equal use_flash_decode=False's")
    _, out["layers"] = layer_check("decode", f"{cfg.name} decode",
                                   lambda: zoo14_decode(params, cfg, prompt,
                                                        dev))
    want_logits, _ = prefill_step(params, cfg, {"tokens": prompt})
    out["vs_prefill_rel"] = _within(
        f"{cfg.name} decode logits at position {S - 1} vs one prefill "
        f"(norm-wise)", _rel(logits[0], want_logits[:, -1].float()),
        DECODE_PREFILL_RTOL, "zoo20")
    return out


def zoo20_run(name, seed, dev):
    """Phase 20 for one config: init at full width (a), the counted
    prefill (b), the flash kernel against its plain version layer by layer
    and in a replay (c), decode (d) and timings (e). Frees nothing itself:
    the caller drops its references."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill_step, stack)
    cfg = zoo20_config(name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = _sync_s()
    params = init_params(cfg, gen, dev)
    init_s = _sync_s() - t0
    n_params = sum(t.numel() for t in stack.leaves(params))
    if n_params != ZOO20[name] or stack.count_params(cfg) != n_params:
        raise AssertionError(f"{name}: {n_params} parameters, expected "
                             f"{ZOO20[name]}")
    nbytes = sum(t.numel() * t.element_size() for t in stack.leaves(params))
    n_attn, n_mamba = attention_invocations(cfg), mamba_layers(cfg)
    log(f"[zoo20] {name}: {n_params:,} parameters ({nbytes / 1e9:.2f} GB) "
        f"initialised in {init_s:.1f} s; {cfg.num_layers} layers"
        + (f" (cut from {get_config(name).num_layers})"
           if name in ZOO20_CUT else "")
        + f", {n_attn} attention invocations a pass (H {cfg.num_heads}, "
        f"K {cfg.num_kv_heads}, hd {cfg.resolved_head_dim}), {n_mamba} "
        f"Mamba layers")
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (ZOO_BATCH, ZOO_PROMPT), generator=gen,
                                     device=dev)}

    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = _sync_s()
    logits, cache = prefill_step(params, cfg, batch)
    wall = _sync_s() - t0
    counts = _launch_counts()
    want = _only(flash_attention=n_attn, ssm_scan=n_mamba)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[zoo20] {name} prefill B={ZOO_BATCH} S={ZOO_PROMPT}: launches "
        f"{counts} (expected {want}); logits {tuple(logits.shape)} finite "
        f"{bool(torch.isfinite(logits).all())}; wall {wall:.2f} s (first "
        f"call), peak memory {peak:.1f} GiB")
    if counts != want:
        raise AssertionError(f"{name} prefill: launches {counts}, expected "
                             f"{want}")
    if tuple(logits.shape) != (ZOO_BATCH, 1, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: logits {tuple(logits.shape)} or not "
                             f"finite")
    del cache
    out = {"params": n_params, "init_s": init_s, "layers_run": cfg.num_layers,
           "attention_invocations": n_attn, "mamba_layers": n_mamba,
           "head_dim": cfg.resolved_head_dim, "first_prefill_s": wall,
           "launches": counts, "peak_gib": peak}
    _, out["layers"] = layer_check("flash", f"{name} prefill",
                                   lambda: prefill_step(params, cfg, batch))
    with mock.patch.object(fops, "flash_attention", _flash_plain):
        replay, _ = prefill_step(params, cfg, batch)
    with mock.patch.object(fops, "flash_attention", _flash_f64):
        control, _ = prefill_step(params, cfg, batch)
    out["control_rel"], out["plain_replay_rel"] = replay_within(
        f"{name} last logits (norm-wise)", _rel(control, replay),
        _rel(logits, replay))
    plain, _ = prefill_step(params, cfg.replace(use_flash=False), batch)
    out["plain_path_rel"] = _within(
        f"{name} last logits vs use_flash=False (norm-wise)",
        _rel(logits, plain), SDPA_PATH_RTOL, "zoo20")
    del replay, control, plain
    out["decode"] = zoo20_decode_checks(
        params, cfg, batch["tokens"][:, :ZOO_DECODE_PROMPT], dev, n_attn)

    # (e) a warm prefill and one decode step, wall to a synchronise,
    # median of 3, beside the card line
    out["prefill_wall_ms"], walls = _median_wall_ms(
        lambda: prefill_step(params, cfg, batch))
    cache = init_cache(cfg, ZOO_BATCH, ZOO_DECODE_PROMPT, dev)
    tok = batch["tokens"][:, :1]
    decode_step(params, cfg, cache, tok, 0)
    pos = itertools.count(1)
    out["decode_step_wall_ms"], dwalls = _median_wall_ms(
        lambda: decode_step(params, cfg, cache, tok, next(pos)))
    log(f"[zoo20] {name}: warm prefill wall {out['prefill_wall_ms']:.1f} ms "
        f"(median of {[round(w, 1) for w in walls]}), decode step wall "
        f"{out['decode_step_wall_ms']:.2f} ms (median of "
        f"{[round(w, 2) for w in dwalls]}), peak memory {peak:.1f} GiB "
        f"(prefill), {out['decode']['peak_gib']:.1f} GiB (decode); "
        f"{card_line()}")
    return out


def zoo20_phase(seed, dev):
    """Phase 20: each config in turn, freed before the next."""
    report = {}
    for name in ZOO20:
        t0 = time.perf_counter()
        report[name] = zoo20_run(name, seed, dev)
        report[name]["phase_s"] = time.perf_counter() - t0
        log(f"[zoo20] {name} in {report[name]['phase_s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return report


def _leaves(tree):
    from repro_torch.models.stack import leaves
    return leaves(tree)


def _mangled_base(head):
    """The identifier that ends ``head`` in a mangled name, before its
    ``_kernel``: the shortest tail ``x`` that starts with a letter and
    follows its own length with ``_kernel`` added (``17flash_tf32`` for
    ``flash_tf32_kernel``), so digits inside the name are kept."""
    for n in range(1, len(head) + 1):
        base = head[len(head) - n:]
        if base[0].isalpha() and head[:len(head) - n].endswith(
                str(n + len("_kernel"))):
            return base
    return ""


def ptxas_lines(log_path):
    """ptxas' report per kernel instantiation, one line each: the kernel's
    name and the template arguments of its (mangled) entry name, its
    stack, spills and registers; and every warning line of the log."""
    out, fn, spill = [], "?", ""
    for ln in log_path.read_text().splitlines():
        if "warning" in ln:
            out.append(ln.strip())
        elif "Function properties for" in ln:
            name = ln.split("Function properties for", 1)[1].strip()
            head, _, tail = name.partition("_kernel")
            fn = _mangled_base(head) + "_kernel" + tail[:36]
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            out.append(f"{fn}: {ln.split(':', 1)[-1].strip()}; {spill}")
    return out


# the registers a thread of flash_ws_kernel must launch with: its consumers'
# setmaxnreg.inc draws on the pool the launch allocates (384 x 168), and a
# pool any smaller would leave the increase waiting
WS_LAUNCH_REGS = 168


def ws_launch_regs(lines):
    """The launch registers of every flash_ws_kernel instantiation in
    ``ptxas_lines``; raises unless each is WS_LAUNCH_REGS."""
    regs = [int(re.search(r"Used (\d+) registers", ln).group(1))
            for ln in lines if ln.startswith("flash_ws_kernel")
            and "Used" in ln]
    if not regs or any(r != WS_LAUNCH_REGS for r in regs):
        raise AssertionError(f"flash_ws_kernel launches with {regs} "
                             f"registers a thread, not {WS_LAUNCH_REGS}")
    return regs


def kernels_spill_free(lines, prefix):
    """Raises unless ``ptxas_lines`` holds an instantiation of a kernel
    whose name starts with ``prefix`` and every one of them reports no
    spill."""
    rows = [ln for ln in lines if ln.startswith(prefix) and "Used" in ln]
    bad = [ln for ln in rows if re.search(r"\b[1-9]\d* bytes spill", ln)]
    if not rows or bad:
        raise AssertionError(f"{prefix}* kernels spill (or none was built): "
                             f"{bad or lines}")
    return rows


def _write_report(path, report):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1, default=str)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--kernel", action="append", default=None,
                    choices=KERNELS, metavar="NAME",
                    help="build and check only this kernel (phases 1-3; "
                    "repeatable), then stop without a result line")
    ap.add_argument("--split18-seed", type=int, action="append",
                    default=None, metavar="SEED",
                    help="build the bottleneck pair and run only phase "
                    "18b's split step with this seed (repeatable; its "
                    "float64 witness read for each), then stop without a "
                    "result line")
    # a rank process of phase 17 or 18 (launch.mesh.spawn_ranks adds the
    # last three)
    ap.add_argument("--shard17-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--split18-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    if args.rank is not None:
        if args.split18_out:
            return split18_rank(args)
        return shard17_rank(args)
    from repro_torch.configs import get_config, get_lisa_config
    from repro_torch.core.bottleneck import rank_for_ratio
    from repro_torch.core.lut import paper_lut
    from repro_torch.core.streams import DualStreamExecutor
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "card": card_line(), "device": torch.cuda.get_device_name(0)}
    log(f"[card] {report['card']} (torch {report['torch']}, "
        f"cuda {report['cuda']})")

    t0 = time.perf_counter()
    names = args.kernel or list(_build.SOURCES)
    if args.split18_seed:
        names = ["bottleneck_encode", "bottleneck_decode"]
    _build.build(names)     # one nvcc per source, all started together
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {sorted(names)} in {report['build_s']:.1f} s")
    report["ptxas"] = {}
    for name in names:
        lines = ptxas_lines(_build.library_path(name).with_suffix(".log"))
        report["ptxas"][name] = lines
        for ln in lines:
            log(f"[build] {name}: {ln}")
    if "flash_attention" in names:
        ws_launch_regs(report["ptxas"]["flash_attention"])
        kernels_spill_free(report["ptxas"]["flash_attention"], "flash_tf32_")
    for name in ("decode_attention", "paged_decode_attention"):
        if name in names:
            kernels_spill_free(report["ptxas"][name], "set_")
    if args.split18_seed:
        report["split18_seeds"], failed = [], []
        for s in args.split18_seed:
            try:
                report["split18_seeds"].append(
                    split18_ranks(s)["witness"])
            except Exception as e:                          # noqa: BLE001
                failed.append(s)
                log(f"[split18] seed {s} failed: {type(e).__name__}: "
                    f"{str(e)[-2000:]}")
        report["total_s"] = time.perf_counter() - t_start
        if args.out:
            _write_report(args.out, report)
        log(f"[done] {report['total_s']:.1f} s, phase 18b for seeds "
            f"{args.split18_seed} only; failed {failed}")
        return 1 if failed else 0

    pcfg = get_lisa_config("lisa-7b")
    mini_paged = lisa_mini_paged_case(get_lisa_config("lisa-mini"))
    rng = np.random.RandomState(args.seed)
    # the main path decodes a Context microbatch of 4 and one Insight
    # request per tier (KINDS, max_batch=4)
    paged_main = f"main_B{INFLIGHT_SLOTS}"     # the in-flight step's shape
    d_sam = pcfg.sam.d_model
    ranks = [rank_for_ratio(d_sam, t.ratio, 4) for t in paper_lut().tiers]
    enc_cases, dec_cases = bottleneck_cases(pcfg, ranks)
    scan_gen = torch.Generator(device=dev)
    scan_gen.manual_seed(args.seed)
    hd_cases = head_dim_cases()

    def head_dim_checks(check, name):
        return [check(case_rng(args.seed, c["name"]), c, dev,
                      timed=c.get("timed", False)) for c in hd_cases[name]]

    set_cases, timed_cases = decode_set_cases(), decode_timed_cases()

    def own_rng_checks(check, cases):
        return [check(case_rng(args.seed, c["name"]), c, dev,
                      timed=c.get("timed", False)) for c in cases]

    phase3 = {
        "decode_attention": lambda: [
            check_decode_attention(rng, c, dev,
                                   timed=c["name"] in DECODE_TIMED
                                   or c["name"].startswith("zoo_"))
            for c in kernel_cases(pcfg, (1, 4)) + zoo14_kernel_cases()[1]]
        + head_dim_checks(check_decode_attention, "decode_attention")
        + own_rng_checks(check_decode_attention,
                         set_cases["decode_attention"]
                         + timed_cases["decode_attention"]
                         + decode_rule_cases()),
        # lisa-mini's served shape draws from its own RandomState: the
        # cases after it keep the inputs they have always had
        "paged_decode_attention": lambda: [
            check_paged_decode_attention(
                rng, c, dev, timed=c["name"] in (paged_main, "main_B1"))
            for c in paged_cases(pcfg)] + [check_paged_decode_attention(
                np.random.RandomState(args.seed), mini_paged, dev,
                timed=True)]
        + head_dim_checks(check_paged_decode_attention,
                          "paged_decode_attention")
        + own_rng_checks(check_paged_decode_attention,
                         set_cases["paged_decode_attention"]
                         + timed_cases["paged_decode_attention"]),
        "paged_verify_attention": lambda: [
            check_paged_verify_attention(
                rng, c, dev, timed=c["name"].startswith("main")
                and c["dtype"] == pcfg.llm.adtype)
            for c in verify_cases(pcfg)]
        + head_dim_checks(check_paged_verify_attention,
                          "paged_verify_attention"),
        "flash_attention": lambda: [
            check_flash_attention(rng, c, dev,
                                  timed=c["name"] in FLASH_TIMED
                                  or c["name"].startswith("zoo_"))
            for c in flash_cases(pcfg) + zoo14_kernel_cases()[0]]
        + head_dim_checks(check_flash_attention, "flash_attention")
        + [check_flash_attention(case_rng(args.seed, c["name"]), c, dev,
                                 timed=True) for c in flash_rule_cases()]
        + flash_edge_checks(args.seed, dev)
        + flash_edge_checks(args.seed, dev, flash_f32_edge_cases())
        + [check_flash_attention(case_rng(args.seed, c["name"]),
                                 dict(c, name=f"{c['name']}_timed"), dev,
                                 timed=True)
           for c in flash_cases(pcfg) if c["name"] == FLASH_F32_TIMED]
        + [check_flash_attention(case_rng(args.seed, c["name"]), c, dev,
                                 timed=True)
           for c in flash_f32_timed_cases()],
        "bottleneck_encode": lambda: [
            check_bottleneck_encode(case_rng(args.seed, c["name"]), c, dev,
                                    timed=c["name"].startswith("main"))
            for c in enc_cases] + encode_draws(
                args.seed, [c for c in enc_cases
                            if c["x_dtype"] == torch.float32], dev),
        "bottleneck_decode": lambda: [
            check_bottleneck_decode(case_rng(args.seed, c["name"]), c, dev,
                                    timed=c["name"].startswith("main"))
            for c in dec_cases],
        "ssm_scan": lambda: [
            check_ssm_scan(scan_gen, c, dev,
                           timed=c["name"].startswith("main"))
            for c in scan_cases({n: get_config(n) for n in ZOO})]}
    checks, report["check_s"] = {}, {}
    for name in names:
        t0 = time.perf_counter()
        checks[name] = phase3[name]()
        report["check_s"][name] = time.perf_counter() - t0
    log("[kernel] phase 3 seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in report["check_s"].items()))
    gc.collect()
    torch.cuda.empty_cache()
    report.update(checks)
    if not args.kernel:
        report["sdpa"] = [check_sdpa(rng, c, dev) for c in sdpa_cases(pcfg)]
        gc.collect()
        torch.cuda.empty_cache()
    if args.kernel:
        report["total_s"] = time.perf_counter() - t_start
        if args.out:
            _write_report(args.out, report)
        log(f"[done] {report['total_s']:.1f} s, phases 1-3 for {names} "
            f"only")
        return 0
    report["small_input"] = small_input_check(args.seed, dev)

    t0 = time.perf_counter()
    params, bns, lut = make_system(pcfg, args.seed, dev)
    executor = DualStreamExecutor(pcfg=pcfg, params=params, bottlenecks=bns,
                                  lut=lut, max_new_tokens=MAX_NEW_TOKENS,
                                  flash_decode=True, device=dev)
    from repro_torch.models.stack import leaves
    n_params = sum(t.numel() for t in leaves(executor.params))
    report["init_s"] = _sync_s() - t0
    log(f"[serve] lisa-7b: {n_params / 1e9:.3f} B parameters "
        f"({sum(t.numel() * t.element_size() for t in leaves(executor.params)) / 1e9:.2f} GB) "
        f"initialised in {report['init_s']:.1f} s")

    timings = []
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = _sync_s()
    reqs, results, sched = serve(executor, pcfg, args.seed, timings)
    wall = _sync_s() - t0
    counts = _launch_counts()
    launches = counts["decode_attention"]
    if counts != _only(decode_attention=launches):
        raise AssertionError(f"the microbatch path launched another kernel "
                             f"than decode_attention: {counts}")
    n_gen = sched.n_microbatches
    expect = n_gen * MAX_NEW_TOKENS * pcfg.llm.num_layers
    for t in timings:
        log(f"[serve] {t['stage']}: {t['s'] * 1e3:.1f} ms")
    log(f"[serve] {len(results)} requests in {n_gen} microbatches "
        f"(batch sizes {[r.batch_size for r in results]}), wall "
        f"{wall:.2f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB, "
        f"decode_attention launches {launches} (expected {expect})")
    if launches != expect or launches == 0:
        raise AssertionError(f"decode_attention launched {launches} times "
                             f"on the main path, expected {expect}")
    g = pcfg.image_size // pcfg.patch_size
    for req, res in zip(reqs, results):
        arrs = [res.answer_logits, res.tokens]
        if res.tokens.shape != (1, MAX_NEW_TOKENS) or \
                res.answer_logits.shape != (1, pcfg.llm.vocab_size):
            raise AssertionError(f"seq {res.seq_id}: bad output shapes")
        if req.packet.kind == "insight":
            if res.mask_logits is None or res.mask_logits.shape != (1, g, g):
                raise AssertionError(f"seq {res.seq_id}: bad mask")
            arrs.append(res.mask_logits)
        if not all(np.isfinite(a).all() for a in arrs):
            raise AssertionError(f"seq {res.seq_id}: non-finite output")
        if not ((res.tokens >= 0) & (res.tokens < pcfg.llm.vocab_size)).all():
            raise AssertionError(f"seq {res.seq_id}: token out of range")
    log(f"[serve] outputs finite with expected shapes; tokens "
        f"{[r.tokens.tolist()[0] for r in results]}")
    report["serve"] = {"wall_s": wall, "microbatches": n_gen,
                       "batch_sizes": [r.batch_size for r in results],
                       "launches": {"decode_attention": launches},
                       "stages": timings,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "params": n_params}

    report["parity"] = full_width_parity(executor, reqs, results, expect)
    report["profile"] = profile_microbatches(executor, reqs)
    report["inflight"], frames, inflight_results = inflight_phase(
        executor, pcfg, args.seed)
    report["spec"] = spec_phase(executor, pcfg, args.seed, frames)
    report["split"] = split_phase(
        executor, pcfg, args.seed, reqs, results, frames, inflight_results,
        report["inflight"]["launches"]["paged_decode_attention"])

    t0 = time.perf_counter()
    report["engine"], order = engine_phase(executor, pcfg, args.seed)
    report["engine_s"] = time.perf_counter() - t0
    log(f"[engine] phase 12 in {report['engine_s']:.1f} s")

    t0 = time.perf_counter()
    report["profiler"] = profile_phase(executor, pcfg, args.seed,
                                       report["engine"], order)
    report["profiler_s"] = time.perf_counter() - t0
    log(f"[profile] phase 13 in {report['profiler_s']:.1f} s")
    del order

    boundary = lisa16_boundary(executor, pcfg, args.seed)
    # phase 11: free LISA-7B, then the zoo's Mamba path
    del executor, params, bns, reqs, results, sched, frames, inflight_results
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[zoo] LISA-7B freed: {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
        f" GiB still allocated")
    t0 = time.perf_counter()
    report["zoo"] = zoo_phase(args.seed, dev)
    report["zoo_s"] = time.perf_counter() - t0
    log(f"[zoo] phase 11 in {report['zoo_s']:.1f} s")
    t0 = time.perf_counter()
    report["zoo14"] = zoo14_phase(args.seed, dev)
    report["zoo14_s"] = time.perf_counter() - t0
    log(f"[zoo14] phase 14 in {report['zoo14_s']:.1f} s")
    t0 = time.perf_counter()
    report["train15"] = train15_phase(args.seed, dev)
    report["train15_s"] = time.perf_counter() - t0
    log(f"[train15] phase 15 in {report['train15_s']:.1f} s")
    t0 = time.perf_counter()
    report["lisa16"] = lisa16_phase(args.seed, dev, boundary, ranks)
    report["lisa16_s"] = time.perf_counter() - t0
    log(f"[lisa16] phase 16 in {report['lisa16_s']:.1f} s")
    t0 = time.perf_counter()
    report["shard17"] = shard17_phase(args.seed)
    report["shard17_s"] = time.perf_counter() - t0
    log(f"[shard17] phase 17 in {report['shard17_s']:.1f} s")
    t0 = time.perf_counter()
    report["split18"] = split18_phase(args.seed, dev, report["shard17"])
    report["split18_s"] = time.perf_counter() - t0
    log(f"[split18] phase 18 in {report['split18_s']:.1f} s")
    t0 = time.perf_counter()
    report["train19"] = train19_phase(args.seed, dev)
    report["train19_s"] = time.perf_counter() - t0
    log(f"[train19] phase 19 in {report['train19_s']:.1f} s")
    t0 = time.perf_counter()
    report["zoo20"] = zoo20_phase(args.seed, dev)
    report["zoo20_s"] = time.perf_counter() - t0
    log(f"[zoo20] phase 20 in {report['zoo20_s']:.1f} s")

    # each kernel's line: its own checks, its own path's launches, and its
    # times at its path's main shape
    main_case = {"decode_attention": "main_B4",
                 "paged_decode_attention": paged_main,
                 "paged_verify_attention": f"main_B{INFLIGHT_SLOTS}_C4_page"
                                           f"{SPEC_PAGE}",
                 "flash_attention": "main_B4",
                 "bottleneck_encode": f"main_r{max(ranks)}",
                 "bottleneck_decode": f"main_r{max(ranks)}",
                 "ssm_scan": "main_falcon-mamba-7b"}
    split = report["split"]
    # the bottleneck pair's launches: phase 10c's and phase 18b's ranks'
    pair = {k: split["split_point"]["launches"][k]
            + report["split18"]["launches"][k]
            for k in ("bottleneck_encode", "bottleneck_decode")}
    launched = {"decode_attention": report["serve"]["launches"],
                "paged_decode_attention": report["inflight"]["launches"],
                "paged_verify_attention": report["spec"]["run_a"]["launches"],
                "flash_attention": split["microbatch"]["launches"],
                "bottleneck_encode": pair, "bottleneck_decode": pair,
                "ssm_scan": report["zoo"]["falcon-mamba-7b"]["launches"]}
    path_err = {"decode_attention": report["parity"]["max_abs_err"],
                "paged_decode_attention":
                    report["inflight"]["parity"]["max_abs_err"],
                "paged_verify_attention":
                    report["spec"]["parity"]["max_abs_err"],
                **split["split_point"]["max_abs_err"],
                "ssm_scan": max(z["prefill"]["per_launch"]["max_abs_err"]
                                for z in report["zoo"].values())}
    # yardsticks beside library_ms where no one PyTorch call computes the
    # function: page gather + SDPA (two calls) for the paged kernels, the
    # matmul + quantisation chain (ten calls) for encode, the
    # dequantisation + matmul chain (four calls) for decode, one
    # torch.add over the same bytes for the scan
    extra = ("gather_sdpa_ms", "matmul_quant_ms", "dequant_matmul_ms",
             "same_bytes_ms")
    kernels = []
    for name, src in _build.SOURCES.items():
        main_check = next(c for c in checks[name]
                          if c["case"] == main_case[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(src, REPO),
            "replaces": REPLACES[name],
            "launches": launched[name][name],
            "max_abs_err": max([c["max_abs_err"] for c in checks[name]]
                               + [path_err[name]]),
            "ms": main_check["ms"], "plain_ms": main_check["plain_ms"],
            "bound_ms": main_check["bound_ms"],
            "bound_by": main_check["bound_by"],
            "library_ms": main_check.get("library_ms"),
            **{k: main_check[k] for k in extra if k in main_check}})
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    if args.out:
        _write_report(args.out, report)
    log(f"[done] {report['total_s']:.1f} s")
    print(report["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
