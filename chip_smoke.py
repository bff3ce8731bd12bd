#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path (``distributed_llm_training_benchmark_framework_tpu_torch``)
and fails, printing no result, if any phase fails:

0. prints the card's name and power limit (nvidia-smi), turns TF32 off,
   builds the CUDA kernels from ``csrc/`` with nvcc and prints the build time
   and ptxas's register / spill report, per template instance of every
   kernel (the wgmma kernels K1, K4 and K5-K9 on
   ``csrc/flash_fwd_sm90.cuh``'s mainloop and ``csrc/flash_bwd.cu``'s pair),
   with any ptxas line about wgmma;
1. holds each kernel (flash forward K1, backward dq K2, backward dk/dv K3)
   against its plain PyTorch version on the card at the main path's shapes:
   (a) BH 16, S 2048, Dh 64, non-causal, dropout 0.1 (the parity row),
   (b) BH 16, S 2048, Dh 128, causal, no dropout (the flagship row),
   (c) BH 4, S 256, Dh 64, causal with dropout, (h) (a) with batch
   offset 3, as a data-parallel rank holds its rows: the mask keyed by
   global batch*head ids 48-63 (K1 through its offset seed, K2 and K3
   through their id vector), which must change the output, and the
   Ulysses rows' one head group per launch at S 8192: (u) BH 4 (B 1 x
   16/4 heads), Dh 64, non-causal, rate 0.1, and (v) BH 2 (B 1 x 8/4
   heads), Dh 128, causal, rate 0;
2. times each kernel, its plain version and, as a yardstick the port never
   calls, torch's scaled_dot_product_attention (rate 0: it cannot draw the
   coordinate-hash mask) with CUDA events, median of 25 launches after 5
   warmup launches, at shapes (a) and (b). ``ms`` starts the clock on an
   idle card, so it holds the wrapper's host time up to the launch as well
   as the kernel (the clock of every ``ms`` in PERF.md); ``device_ms``
   (and ``library_device_ms`` for SDPA) queues each timed launch behind a
   ~1 ms device sleep, so it is the card's own time, and ``ms -
   device_ms`` is about the host's share. The backward pair's yardstick
   is torch's flash-attention backward (``aten.
   _scaled_dot_product_flash_attention_backward``, rate 0, dq, dk and dv
   in one call, delta computed inside; its out and logsumexp from the
   matching forward op), set beside the pair's own dq + dk/dv +
   ``attention_delta`` on both clocks. At (a), whose row drops, K1 and
   the pair are timed again at rate 0, as the library runs, for a like-for-
   like factor (``rate0_*``). (u) and (v) are timed the same way;
3. trains both bench rows at full tier-A width through
   ``train.loop.run_benchmark`` (parity: TinyGPT b1 x accum 4, dropout 0.1;
   flagship: Llama b2 x accum 2), 3 warmup + 6 timed steps each, and checks
   the losses fall and each kernel's launch count equals layers x
   micro-batches x steps;
4. checks that the first-step tier-A loss (dropout 0) through the kernels
   matches the loss through the plain attention within 1e-2, for both
   families.

The sequence-parallel path (ring attention over 4 sequence shards, all held
on the one card) at S 8192, full tier-A width, in two ring rows:
(d) parity ring: TinyGPT, BH 16, shards of 2048, Dh 64, non-causal, rate
0.1, contiguous; (e) flagship ring: Llama, BH 8 (b1 x 8 heads, the batch
the flagship ring row trains at), shards of 2048 as zigzag half-chunks of
1024, Dh 128, causal, rate 0.

5. holds the ring kernels (ring block forward K4, fp32-output backward dq
   K2′ and dk/dv K3′) against their plain versions at every hop of shards 0
   and 3 of 4, at (d) and (e): rel-Frobenius <= 2e-2 on o, dq, dk, dv, max
   abs <= 1e-3 on m and l;
6. times them at one hop (shard 1, hop 1) of (d) and (e) as in phase 2, the
   bound from the live score elements of that hop, and, as yardsticks at
   rate 0, SDPA's forward on the same block (with the block's causal mask;
   SDPA returns a normalized output) and, for the backward pair, at (d)
   torch's flash-attention backward as in phase 2 and at (e), whose
   zigzag mask that op cannot take, SDPA's masked forward + backward
   (``torch.autograd.grad``) less its forward; at (d) K4 and the pair
   again at rate 0, as in phase 2;
7. holds ``ring_attention`` over 4 shards against ``flash_attention`` over
   the whole S 8192 on the card: out, dq, dk, dv within rel-Frobenius 2e-2,
   both layouts, rate 0 and 0.1, same seed;
8. trains both ring rows through ``run_benchmark`` with
   ``sequence_parallel=4, attention_impl="ring"`` (parity ring: TinyGPT b1 x
   accum 1, dropout 0.1; flagship ring: Llama b1 x accum 2, causal, zigzag
   auto), 3 warmup + 6 timed steps, and checks the losses fall, K4, K2′ and
   K3′ each launched layers x micro-batches x steps x 16 times and K1-K3 not
   at all;
9. checks the first-step tier-A loss at S 8192 (dropout 0) through the ring
   against flash within 1e-2, for both families.

The head-dim-64 forward microbench (``microbench/flash_fwd.py``, the port of
``scripts/microbench_flash_fwd.py``) and its five kernels K5-K9
(``ops/fwd_variants.py``): non-causal, no dropout, at (f) BH 16, S 2048,
Dh 64 (the microbench's default, the parity row's attention block at rate
0) and (g) BH 4, S 256, Dh 128.

10. holds K5-K9 against their plain versions at (f) and (g) (rel-Frobenius
    <= 2e-2; K8, which has no softmax and so no online-rescale gap, also
    <= 2e-3), K5, K6 and K7 against K1 at rate 0 bit for bit (the four run
    the wgmma mainloop of ``csrc/flash_fwd_sm90.cuh`` with one arithmetic),
    K9 against K5 bit for bit at Dh 64 (K9 scales q in bf16 by 2^-3 there,
    which commutes with every rounding of that loop), and K8 against its
    plain version bit for bit on integer inputs in {-2, ..., 2} at (f)
    (every score, every bf16(score * 2^-3) and every fp32 sum of P.V is
    exact there, so any difference is a fault of the kernel); prints max
    |Δ| between the kernels, and times each at (f) as in phase 2, beside
    SDPA on the same block (for K8, which no one call computes, the two
    calls baddbmm and bmm, on both clocks), K5, K6, K7 and K9 also against
    K1 and K8 against K5 on the device clock (the microbench's split of one
    forward into its products and its softmax);
11. runs the microbench once through its module at (f), printing its table,
    and checks every kernel's launch count equals the launches it made.

The strategy arms (``parallel/strategies.py``) on the parity row:

12. runs one tier-A micro-batch at dropout 0.1 under remat none, dots and
    full with the same seeds (gradients within 1e-5
    relative, K1 launched twice per layer under remat), then trains the
    parity row 3 warmup + 6 timed steps under each arm (ddp, fsdp, zero2,
    zero3) without a process group, and again inside a single-rank NCCL
    group made by ``runtime.setup_distributed``, where each arm lays the
    model out (DDP, FSDP2's DTensors, zero2's flat buffers; checked), and
    checks the losses fall, each step's loss under the group within 1e-3
    relative of the no-group run, and K1-K3's launch counts equal layers x
    micro-batches x steps (K1 twice that under remat); prints each arm's
    resolved remat, tokens/s, peak memory and ``world_size``. At world 1
    these measure each wrapper's cost on one card, not scaling. The group
    is torn down at the end.

Ulysses attention (``ops/ulysses_attention.py``: an all-to-all around
K1-K3, no kernel of its own), at full tier-A width and S 8192 over 4
sequence shards, (u) and (v) above:

13. holds ``ulysses_attention(seq_shards=4)``, forward and backward on the
    kernels, against the same function over ``flash_attention_plain``: out,
    dq, dk, dv within phase 1's rel-Frobenius 2e-2; at rate 0 (v) its
    output and gradients equal ``flash_attention``'s bit for bit (each
    head's tiles are flash's); at rate 0.1 (u) the kept share of the masks
    its folded seeds draw (the coordinate hash, which phase 1 holds the
    kernels to) lies within 6 binomial sigmas of the hash's keep
    probability, and the mask and output differ from flash's;
14. trains the two Ulysses rows through ``run_benchmark`` with
    ``sequence_parallel=4, attention_impl="ulysses"``, all shards on the one
    card (parity Ulysses: TinyGPT b1 x accum 1, dropout 0.1; flagship
    Ulysses: Llama b1 x accum 2, causal), 3 warmup + 6 timed steps, and
    checks the losses fall, K1-K3 each launched layers x micro-batches x
    steps x 4 times (64 / 128 per step) and the ring kernels not at all;
15. inside phase 12's single-rank NCCL group, runs the group forms once,
    forward and backward: ``ring_attention_sharded`` and
    ``ulysses_attention_sharded`` on the group at (a) and (b), against
    ``flash_attention_plain`` (a one-shard ring is attention over the whole
    sequence; the sharded Ulysses folds its seed even at one shard, as JAX
    does, so its plain version draws with the folded seed) within phase 1's
    limits, and the sharded Ulysses equal to ``flash_attention`` bit for bit
    at (b), rate 0; then ``run_benchmark(attention_impl="ulysses")`` on the
    parity row (zero2, ``seq`` width 1, where Ulysses is flash), whose
    per-step losses must equal phase 12's no-group zero2 run's within
    1e-3. At world 1 this launches NCCL's ``all_to_all_single`` on the
    card; the one-shard ring sends nothing and no ``seq`` reduction runs,
    and nothing here says anything about scaling.

Tensor parallelism (``parallel/tensor.py``, the ``model`` axis over the
group): each ``model`` rank runs K1-K3 on its H/tp heads, keyed by global
batch*head ids (K1's ``bhv`` instance, ``flash_fwd_bhv``).

16. (a) one process: at (t) = the parity row's attention at B 2 x 16
    heads of 64 (S 2048, non-causal, rate 0.1) over tp 2 and 4, and the
    flagship's, B 2 x 8 query heads of 128 (4 kv heads repeated), causal,
    over tp 2 (the kv heads split) and 8 (they do not), every shard's K1
    (``bhv`` instance), K2 and K3 launches equal the matching rows of the
    one whole-layer launch bit for bit (out, lse, dq, dk, dv) and their
    plain versions within phase 1's limits; the ring at (d)'s geometry (S
    8192 over 4 shards, Dh 64, rate 0.1) at B 2 over tp 2, each head shard
    with its head offset, equals the whole ring's rows bit for bit (out,
    dq, dk, dv); K1's ``bhv`` instance is timed at (t) as in phase 2,
    beside K1's offset instance on the same inputs (device clock), and at
    the flagship's shard (BH 8, Dh 128, causal); (b) two processes on the
    one card, joined over gloo (NCCL takes one rank per device; gloo
    carries the collectives of CUDA tensors through the host), train both
    rows at full tier-A width, S 2048, at ``tensor_parallel=2`` ((data 1,
    model 2)), under ddp and zero2, ``TP_STEPS`` steps: per-step losses
    within ``TP_LOSS_RTOL`` of the no-group run on one card (phases 3 and
    12 and a no-group ddp flagship run), both ranks equal, K1's ``bhv``
    instance, K2 and K3 each launched layers x micro-batches x steps times
    per rank and K1's offset instance not at all, and each rank's peak
    memory beside ``estimate_hbm``'s figure for it. The collective matmul
    needs point-to-point sends, which one card cannot carry over NCCL: it
    runs on the CPU only (its tests).

17. the host-offload arm and bf16 parameters (``parallel/offload.py``):
    (a) the parity row (zero2, 3 warmup + 6 timed steps through
    ``run_benchmark``) at ``param_dtype`` bf16, under the serial offload
    arm and under the delayed one, each beside phase 3's fp32 row: tokens/s,
    step ms, peak device memory against ``estimate_hbm``, K1-K3 launches,
    falling losses, and for the offload runs the host update's ms, the
    device-to-host and host-to-device copies' ms and GB/s per step (CUDA
    events on the copy stream), the time the step waited for the delayed
    worker, the pinned host bytes, the host's cores, intra-op threads and
    ``MemAvailable``; host AdamW over tier A's masters, fused and foreach;
    (b) tier B (1.68B, S 1024, zero3) at f32, bf16, offload serial (b1 x
    accum 4) and offload delayed (accum 16), 2 warmup + 4 timed steps, the
    same prints, after checking that the host holds tier B's pinned state;
    (c) the serial arm's update held against its plain version with masters
    and moments on the card (``DeviceMasters``, test code here): in step
    with it on the same gradients and scale for 5 steps (tier A, dropout
    0), the masters within ``MASTER_RTOL`` relative plus ``MASTER_ATOL``
    after every step, and a run of the plain version's own, whose per-step
    losses must be within ``OFFLOAD_LOSS_RTOL`` of the host arm's; (d) the
    same for the delayed arm over 4 steps against the plain version with a
    one-step lag (update t takes step t-1's gradients and scale, update 0
    zeros).

Mixture-of-Experts (``models/moe.py``; no kernel of its own: the expert FFN
is batched ``torch.bmm``, the attention K1-K3):

18. (a) the 1.18B MoE row on one card, no group: TinyGPT tier A with 8
    experts, top-2, capacity factor 1.25 (1,176,635,392 parameters), S
    2048, b1 x accum 4, zero2, dropout 0.1, through ``run_benchmark(
    n_experts=8)``, 3 warmup + 6 timed steps, at fp32 and at bf16
    parameters: tokens/s, step ms, MFU (active experts' FLOPs), peak memory
    against ``estimate_hbm``, ``expert_overflow_pct``; the loss falls, K1-K3
    launch 64 times each per step (K1 16 more: the overflow diagnostic's
    forward after the timed steps), the overflow lies within JAX's [0, 60];
    (b) the layer at the row's shape (N 2048, E 8, C 640, D 1024, F 4096,
    bf16): the index dispatch (the main path) against the one-hot plain
    version: the experts each token reaches equal, the output bit for bit,
    the gradients within 2e-2 of their largest magnitude; forward and
    forward + backward of both, and the route / dispatch / expert FFN /
    combine of the index form, on the device clock; (c) expert_parallel 2
    as two processes on the one card over gloo (``chip_smoke.py
    --moe-worker RANK PORT DIR``), after checking that gloo carries
    ``all_to_all_single`` on CUDA tensors: the row's width at 4 layers,
    dropout 0, zero2, 3 steps, per-step losses within ``MOE_EP_RTOL`` (JAX's
    ep-against-one-device 5e-3: capacity is provisioned per member) of
    one process's run of the same global batch, and the all-to-all's time
    over gloo (through the host; not NCCL); (d) is phase 12: its zero2
    group run reduce-scatters per block (the bucket count is printed).

Pipeline parallelism (``parallel/pipeline.py``, ``parallel/interleaved.py``;
no kernel of its own: each stage runs K1-K3 on whole layers):

19. two processes on the one card joined over gloo (``chip_smoke.py
    --pipe-worker RANK PORT DIR``), one stage each: first two processes
    that try gloo's ``send`` on a CUDA tensor (``--pipe-probe``), which
    gloo's TCP transport refuses, so the transport stages its messages
    through pinned host memory under gloo (printed); (a) the parity row at
    ``pipeline_parallel`` 2 (TinyGPT tier A, 8 layers per stage, S 2048, b1
    x accum 4 = M 4 microbatches, zero2, dropout 0.1) through
    ``run_benchmark`` under gpipe, 1f1b and interleaved (V 2, 4 layers per
    chunk), 2 warmup + 4 timed steps each: per schedule and stage the
    tokens/s and step ms (two stages time-sliced on one card: not a
    scaling number), peak memory against ``estimate_hbm``, messages sent
    per step against the law (M(P-1) per direction, M(PV-1) interleaved),
    the ms per step spent waiting in receives and the schedule's bubble
    bound; the three schedules' per-step losses within ``PIPE_LOSS_RTOL``
    (they draw the same masks), and K1-K3 launches per stage per step equal
    to the schedule's count (``PIPE_LAUNCHES``: K1 once per layer and
    microbatch, again in the 1f1b / interleaved recompute, none for the
    head chunk's F unit); (b) gpipe at dropout 0, 3 steps, against the
    one-process parity row from the same seed, per-step losses within
    ``PIPE_VS_ONE_RTOL``; (c) where a gpipe step of (a) goes on each
    stage: the schedule, the arm's reduction with the sum of the
    replicated leaves over ``pipe``, the optimizer step (host clock, the
    card synchronized around each), and that sum alone over gloo.

The run-time layer (``train/harness.py``, ``runtime/checkpoint.py``,
``telemetry/``, ``faults/``; no kernel of its own):

20. the harness CLI as a subprocess on the card (its default device): (a)
    the parity row (tier A, zero2, S 2048, b1 x accum 4, dropout 0.1,
    flash) for 8 steps, warmup 2, ``--checkpoint-every 4``,
    ``--inject-fault sigterm@6``: exit 75, an emergency checkpoint and a
    final heartbeat carrying ``emergency_checkpoint_step``; then
    ``--resume``: exit 0, ``resumed`` true, ``n_restarts`` 1; (b) the same
    8 steps straight through: the per-step losses of (a), before and after
    the resume, within ``RT_LOSS_RTOL`` of (b)'s (the telemetry's step
    windows, 6 decimals; printed whether equal); (c) the costs, beside the
    card's name and power limit: each save's gather / write / digest ms and
    bytes (step 4's save asynchronous, committed by the SIGTERM's flush;
    the resume's final save of step 7 synchronous), the restore's validate
    / load / apply ms, ms from the SIGTERM to the process's exit,
    ``time_in_compile_sec``, and the step ms before the first save, under
    the async write (steps 5-6) and resumed (steps 5-7); (d) drills at tier S (plain attention: its 32-wide heads
    are not the kernels'), the three chains at once: ``sigkill@5`` then ``--resume``
    (resumed from step 4, ``n_restarts`` 1), a resume past the end (77),
    ``torn-checkpoint`` (step 4 quarantined, the resume falls back to 2),
    ``hang@3:30`` with ``--hang-timeout-sec 5`` (76 and a ``hang_dump``
    event).
21. the second half of the run-time layer (``faults/sentinel.py``,
    ``data/stream.py``, ``data/prefetch.py``), the parity row at full width:
    (a) three harness subprocesses at once on the card: the row with
    ``--sentinel on --sentinel-checksum-every 4 --checkpoint-every 4
    --inject-fault bitflip@7`` (exit 0, ``n_rollbacks`` 1, every replayed
    loss finite, the restore's wall); ``opt-moments@5`` with the sentinel
    and no checkpoint (healed from the host snapshot: the same assertions,
    the trip on step 6, the first after the corruption); and, on shards written by the
    port's writer (S 2048, vocab 32000, twice the records any run reads),
    ``data-stall@4:120`` with ``--data-stall-timeout-sec 3`` (exit 78, an
    emergency checkpoint of step 3 with its stream sidecar) and its
    ``--resume`` (exit 0, the cursor continuing at record 16: steps 4-7 read
    exactly records 16-31); (b) alone on the card, through
    ``run_benchmark`` with K1-K3's launches counted: the row on the
    synthetic table without and with the sentinel and on the stream, in
    turns (off, on, stream), their step ms (the
    sentinel's per-step cost and the stream's against the table), the stream's
    ``data_stall_frac`` and mean prefetch wait; ``data-corrupt-record@5``
    on the stream (``records_skipped`` 1, finite losses); the parameter
    checksum's ``device_ms`` against its bound (0.94 GB of fp32 read once).

The supervisor and the run registry (``runtime/supervisor.py``,
``runtime/launch.py``, ``regress/``, ``analysis/``; no kernel of its own):

22. (a) ``python -m ...runtime.supervisor`` over ``runtime.launch --nproc
    1`` over the harness on the card: the parity row (tier A, zero2, S
    2048, b1 x accum 4, dropout 0.1, flash: K1-K3 in the child), 8 steps,
    ``--checkpoint-every 4``, ``--inject-fault sigterm@6``, a policy with
    ``preempted -> resume``: the ledger ``[preempted/resume, ok]``, the
    fault dropped from attempt 2, whose telemetry and heartbeats carry
    ``supervised_attempt: 2``, the final row stamped (``supervision``
    ``n_attempts`` 2, ``resumed`` true) and passed by the port's
    validator; (b) the supervisor's device probe (a torch import in a
    subprocess) returns the card count, 1, while the same command with
    ``--resume`` past the end exits 77 and the supervisor gives up with
    that code after one attempt; (c) the port's ``regress`` ingests (a)'s
    results into a temporary registry, keeps the resumed row out of the
    baseline and ``gate`` skips it (exit 0); ``parse_metrics`` writes
    metrics.csv (``supervised_attempts`` 2), ``telemetry_report`` and
    ``make_report`` run over the same directory. Printed beside the card's
    name and power limit: each attempt's wall, the supervisor's own time
    between attempts (its wall less the children's, backoff 0), the
    probe's wall and the ingest / gate / csv / telemetry-report / report
    walls. The phase runs beside phase 20 (b) and (d), so these walls are
    taken with those processes on the same host and card.

The trace and memory anatomy (``analysis/{profile_summary,step_anatomy,
memory_anatomy}.py``; no kernel of its own):

23. trains the parity and flagship rows of phase 3 again, 3 + 6 steps,
    through ``run_benchmark(profile_dir=...)`` (one timed window), and
    checks on each: the trace and ``cost_analysis.json`` exist; the step
    anatomy has 6 steps, clipped to the telemetry's timed phase with no
    lane falling back; compute + exposed + idle = 1 within 1e-6 and no
    exposed collective (world 1 runs no NCCL kernel:
    ``comms_exposed_frac`` 0.0, ``comms_overlap_frac`` null); the trace
    holds K1-K3 64 / 64 / 64 (parity) and 32 / 32 / 32 (flagship) times
    per traced step; the memory anatomy's source is the allocator and the
    port's validator accepts the row. It prints the kineto categories,
    where the step markers fall, each op's device start less its host
    launch (the two clocks' agreement), the trace's bytes and its stop /
    export / load / analysis seconds, the anatomy's idle beside 1 - busy /
    phase 3's unprofiled wall, tokens/s profiled / phase 3's, the device ms
    per step by class, the bytes earlier phases still hold and
    ``hbm_model_drift_frac``, and writes the whole as
    ``build/phase23_profile.json``.

The static audit (``analysis/static``: graftcheck; no kernel of its own):

24. runs the graftcheck CLI in child processes on the card's host, as the
    port's bench runs its preflight: (a) ``bench.PREFLIGHT_ARGS`` (the lint
    and the collective audit of ``llama-tp2-gqa``), which must exit 0; (b)
    the collective audit of the whole roster against the budgets, which
    were frozen under another torch version: exit 0 says this torch's fake
    process group and dispatch mode see the same ``c10d`` ops, bytes and
    group sizes; (c) ``--inject bad-cmm-ring --arms llama-tp2-gqa-cmm``,
    which must exit 1 naming the arm. Each
    child must print ``torch.cuda.is_initialized() = False``. Printed
    beside the card's name and power limit: each run's wall. This script
    calls the bench CLI nowhere (it trains through ``run_benchmark``), so
    no call of it needs ``--skip-preflight``.

The suite layer (``scripts/torch_chaos_suite.sh``,
``scripts/torch_with_retries.sh``, ``scripts/torch_run_all_benchmarks.sh``,
the bench's ``--remat-sweep``; no kernel of its own):

25. (a) ``scripts/torch_chaos_suite.sh --smoke --jobs 4`` with
    ``CHAOS_ON_DEVICE=1``: sigkill, torn-checkpoint, bitflip and
    data-corrupt-record, each through the harness on the card at tier S,
    must each print ``CHAOS OK`` and the suite exit 0, with every row's
    ``backend`` cuda; (b) ``scripts/torch_run_all_benchmarks.sh`` at its
    default full width (tier A, S 2048, b1 x accum 4) with ``STRATEGIES="ddp
    fsdp zero2 zero3" WORLD_SIZES=1 ATTENTION=flash STEPS=12
    WARMUP_STEPS=3 REMAT_SWEEP=1 SKIP_CHAOS=1 SKIP_PREFLIGHT=1
    ARM_CHECKPOINT_EVERY=0`` ((a) ran the chaos smoke and phase 24
    graftcheck): "Suite complete: 4 passed, 0 failed", ``VALIDATE PASS``,
    the gate's 0 regressions, one metrics.csv row per arm on cuda, the
    report's Key findings and remat frontier, the four policies' rows. The
    suite's processes write their kernel launches at exit
    (``KERNEL_LAUNCHES_DIR``): each arm's K1-K3 16 x 4 x 12 times; the
    sweep's process (its top row, the parity row, then the flagship once
    per policy) K2-K3 16 x 4 x 12 + 16 x 2 x 12 x 4 times and K1 once more
    per layer under a recomputing policy. Printed beside the card's name and power limit:
    the walls of (a), of each stage of (b), the arms' tokens/s and peak
    memory, the frontier (tokens/s, peak, headroom per policy). (a) runs
    beside phase 24, which needs only the host: phase 24's walls are
    taken with it running.

Ends with a line ``{"kernels": [...]}`` (per kernel and row: launches on the
main path, error against the plain version, times, the least time the card
could take and what bounds it; the parity row's K1-K3 also carry phase
19's launches per stage and step and phase 25's in the suite's arms, the
flagship row's phase 25's in the remat sweep), the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``. Exits nonzero without those lines when
no CUDA device is available.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# INT32 lanes: 64 per SM (Hopper architecture white paper) x 132 SMs x the
# 1.98 GHz maximum SM clock of the H100 SXM; the dropout hash runs on these.
# The bf16 and HBM peaks come from the package's tables (utils/flops.py,
# utils/platform.py), matched on the card's name.
H100_INT32_OPS = 64 * 132 * 1.98e9
HASH_OPS_PER_ELEMENT = 10  # mix32 (2 mul, 3 shift, 3 xor) + add + compare
# Exponentials: 16 per SM per clock (the special-function units), same SMs
# and clock. Written beside the softmax variants' bound, not part of it.
H100_EXP_OPS = 16 * 132 * 1.98e9

WARMUP_STEPS, TIMED_STEPS = 3, 6


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


# About 1 ms of device sleep (torch.cuda._sleep counts SM clock cycles).
SLEEP_CYCLES = 2_000_000


def median_ms(fn, warmup: int = 5, reps: int = 25, device_clock: bool = False) -> float:
    """Median over ``reps`` calls of the time between two CUDA events around
    one call of ``fn``. The clock starts on an idle card, so the reading
    holds the host's time from the first event to the launch as well as the
    kernel. ``device_clock=True`` enqueues each call behind a ~1 ms device
    sleep instead: the host's time is then off the clock and the reading is
    the card's own time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if device_clock:
            torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


SHAPES = {
    "a": dict(BH=16, S=2048, D=64, causal=False, rate=0.1, row="parity"),
    "b": dict(BH=16, S=2048, D=128, causal=True, rate=0.0, row="flagship"),
    "c": dict(BH=4, S=256, D=64, causal=True, rate=0.1, row=None),
    # (a) as rank 1 of a data-parallel pair holding 3 rows of batch each:
    # the mask keyed by global batch*head ids 48..63.
    "h": dict(BH=16, S=2048, D=64, causal=False, rate=0.1, row=None, batch_offset=3),
}
ULYSSES_ROWS = {
    "parity ulysses": dict(model_family="tinygpt", per_device_batch=1, grad_accum=1, layers=16),
    "flagship ulysses": dict(model_family="llama", per_device_batch=1, grad_accum=2, layers=16),
}
# The Ulysses rows' attention at full width, S 8192 over 4 shards (the ring
# rows' geometry): each head group of H/4 heads is one K1-K3 launch over the
# whole sequence. Llama's k/v are repeated to its 8 query heads before.
ULYSSES_SHAPES = {
    "u": dict(B=1, H=16, S=8192, n=4, D=64, causal=False, rate=0.1, row="parity ulysses"),
    "v": dict(B=1, H=8, S=8192, n=4, D=128, causal=True, rate=0.0, row="flagship ulysses"),
}
for _key, _sh in ULYSSES_SHAPES.items():
    SHAPES[_key] = dict(BH=_sh["B"] * _sh["H"] // _sh["n"], S=_sh["S"], D=_sh["D"],
                        causal=_sh["causal"], rate=_sh["rate"], row=_sh["row"])


def make_inputs(shape, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    BH, S, D = shape["BH"], shape["S"], shape["D"]
    return [torch.randn(BH, S, D, device="cuda", generator=g).to(torch.bfloat16)
            for _ in range(4)]


FLOPS_PER_LIVE_ELEMENT = {"fwd": 4, "dq": 6, "dkv": 8}  # times Dh: the tile products


def bound_ms(kind: str, D: int, live: int, nbytes: int, rate: float,
             peaks) -> tuple[float, str]:
    """Least time (ms) the card could take for the work and what bounds it:
    ``nbytes`` (each input read once, each output written once) at the HBM
    rate, the live score elements' tensor FLOPs at the bf16 peak and, with
    dropout, their hash integer work at the INT32 rate."""
    t_bytes = nbytes / peaks["bytes"]
    t_ops = FLOPS_PER_LIVE_ELEMENT[kind] * D * live / peaks["flops"]
    if rate > 0:
        t_ops = max(t_ops, HASH_OPS_PER_ELEMENT * live / H100_INT32_OPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def library_flash_bwd(q, k, v, do, causal: bool):
    """The backward pair's yardstick: a thunk of one call of torch's
    flash-attention backward (``aten._scaled_dot_product_flash_attention_backward``,
    rate 0: it cannot draw the coordinate-hash mask) on the (1, BH, S, Dh)
    layout, with its out and logsumexp from the matching forward op on the
    same inputs. It returns (dq, dk, dv) and computes delta inside."""
    aten = torch.ops.aten
    q4, k4, v4, do4 = (t.unsqueeze(0) for t in (q, k, v, do))
    out, lse, cum_q, cum_k, max_q, max_k, philox_seed, philox_offset = (
        aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, causal)[:8])
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        do4, q4, k4, v4, out, lse, cum_q, cum_k, max_q, max_k, 0.0, causal, philox_seed,
        philox_offset)


def time_pair(res, fa, out, do, library) -> None:
    """Put the backward pair's yardstick on ``res``: the library call's time on
    both clocks on the dk/dv entry, beside the pair's own dq + dk/dv +
    attention_delta (the library computes delta inside); a note on dq."""
    delta_ms = median_ms(lambda: fa.attention_delta(out, do))
    delta_device_ms = median_ms(lambda: fa.attention_delta(out, do), device_clock=True)
    lib_ms, lib_device_ms, note = library
    res["dkv"].update(
        library_ms=lib_ms, library_device_ms=lib_device_ms, attention_delta_ms=delta_ms,
        attention_delta_device_ms=delta_device_ms,
        pair_ms=res["dq"]["ms"] + res["dkv"]["ms"] + delta_ms,
        pair_device_ms=res["dq"]["device_ms"] + res["dkv"]["device_ms"] + delta_device_ms,
        library_note=note)
    res["dq"]["library_note"] = ("one library call computes dq, dk and dv together: its time "
                                 "is on this row's flash_bwd_dkv entry beside the pair's")


def time_rate0(res, fwd, dq, dkv) -> None:
    """Where a row drops (rate 0.1), time its forward and backward pair again
    at rate 0 on both clocks, so that the factor against the library (which
    runs at rate 0: it cannot draw the hash) is like for like: the forward's
    on the fwd entry, the pair's (dq + dk/dv + attention_delta) on the dk/dv
    entry."""
    for kind, fn in (("fwd", fwd), ("dq", dq), ("dkv", dkv)):
        res[kind]["rate0_ms"] = median_ms(fn)
        res[kind]["rate0_device_ms"] = median_ms(fn, device_clock=True)
    res["fwd"]["rate0_library_factor"] = (res["fwd"]["rate0_device_ms"]
                                          / res["fwd"]["library_device_ms"])
    pair = (res["dq"]["rate0_device_ms"] + res["dkv"]["rate0_device_ms"]
            + res["dkv"]["attention_delta_device_ms"])
    res["dkv"]["rate0_pair_device_ms"] = pair
    res["dkv"]["rate0_pair_library_factor"] = pair / res["dkv"]["library_device_ms"]


def bound(kind: str, shape, peaks) -> tuple[float, str]:
    """``bound_ms`` of a flash kernel (K1-K3, bf16 outputs) at a shape."""
    BH, S, D = shape["BH"], shape["S"], shape["D"]
    live = BH * (S * (S + 1) // 2 if shape["causal"] else S * S)
    mat = BH * S * D * 2
    row = BH * S * 4
    nbytes = {"fwd": 4 * mat + row, "dq": 5 * mat + 2 * row, "dkv": 6 * mat + 2 * row}[kind]
    return bound_ms(kind, D, live, nbytes, shape["rate"], peaks)


# The template parameters of every kernel template in csrc/, by name: phase 0
# prints each instance's registers and spills under them. K1 / K4, K5 / K6 /
# K7 (fwd_layout_kernel), K8 (fwd_matmul_kernel) and K9 (fwd_qscaled_kernel)
# run csrc/flash_fwd_sm90.cuh's mainloop; K2 / K3 are the backward pair in
# csrc/flash_bwd.cu (None: the output type).
KERNEL_PARAMS = {
    "flash_fwd_kernel": ("Dh", "causal", "dropout"),
    "flash_fwd_bhv_kernel": ("Dh", "causal", "dropout"),
    "ring_fwd_block_kernel": ("Dh", "causal", "dropout"),
    "flash_bwd_dq_kernel": ("Dh", "causal", "dropout", None),
    "flash_bwd_dkv_kernel": ("Dh", "causal", "dropout", None),
    "fwd_layout_kernel": ("Dh", "k transposed", "warpgroups"),
    "fwd_qscaled_kernel": ("Dh",),
    "fwd_matmul_kernel": ("Dh",),
}
# One Itanium-mangled template argument: an int or bool literal, or a type.
TEMPLATE_ARG = re.compile(r"L[ib](\d+)E|(f)|(13__nv_bfloat16)")


def instance_name(mangled: str) -> str:
    """``kernel<Dh 64, causal 0, ...>`` for an instance of a KERNEL_PARAMS
    template; any other entry keeps its mangled name."""
    kernel = next((k for k in KERNEL_PARAMS if f"{len(k)}{k}I" in mangled), None)
    if kernel is None:
        return mangled
    head = f"{len(kernel)}{kernel}I"
    pos, args = mangled.index(head) + len(head), []
    for label in KERNEL_PARAMS[kernel]:
        m = TEMPLATE_ARG.match(mangled, pos)
        if m is None:
            return mangled
        pos = m.end()
        args.append(f"{label} {m[1]}" if m[1] is not None
                    else "fp32 out" if m[2] else "bf16 out")
    return f"{kernel}<{', '.join(args)}>"


def ptxas_instances(report: list[str]) -> dict:
    """{instance name (``instance_name``): (registers, spill line)} from ptxas -v."""
    out, name, spill = {}, None, ""
    for ln in report:
        if "Compiling entry function" in ln:
            name = instance_name(ln.split("'")[1])
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and name is not None:
            out[name] = (int(re.search(r"Used (\d+) registers", ln)[1]), spill)
            name = None
    return out


def phase_kernels(fa, peaks):
    """Phases 1 and 2: kernel vs plain at shapes a, b, c; times at a and b."""
    results, outs = {}, {}
    for key, sh in SHAPES.items():
        q, k, v, do = make_inputs(sh)
        c, r, seed = sh["causal"], sh["rate"], 0x2545F491
        # One batch of BH heads: batch offset b keys the rows as ids b*BH + i.
        b_off = sh.get("batch_offset", 0)
        bhv = fa._global_bh_vec(1, sh["BH"], b_off, 0, sh["BH"], "cuda") if b_off else None
        out, lse = fa.flash_fwd(q, k, v, c, r, seed, b_off * sh["BH"])
        p_out, p_lse = fa.flash_forward_plain(q, k, v, c, r, seed, b_off * sh["BH"])
        outs[key] = out
        delta = fa.attention_delta(p_out, do)
        bwd = (q, k, v, do, p_lse, delta, c, r, seed)
        dq = fa.flash_bwd_dq(*bwd, bhv=bhv)
        dk, dv = fa.flash_bwd_dkv(*bwd, bhv=bhv)
        torch.cuda.synchronize()
        p_dq = fa.flash_bwd_dq_plain(*bwd, bhv=bhv)
        p_dk, p_dv = fa.flash_bwd_dkv_plain(*bwd, bhv=bhv)
        errs = {
            "out": rel_err(out, p_out), "dq": rel_err(dq, p_dq),
            "dk": rel_err(dk, p_dk), "dv": rel_err(dv, p_dv),
        }
        lse_err = max_abs(lse, p_lse)
        log(f"[1] shape ({key}) BH={sh['BH']} S={sh['S']} Dh={sh['D']} causal={c} "
            f"rate={r}{f' batch offset {b_off}' if b_off else ''}: rel-Frobenius "
            f"{json.dumps({n: f'{e:.2e}' for n, e in errs.items()})}"
            f", lse max abs {lse_err:.2e}, out max abs {max_abs(out, p_out):.2e}")
        for name, e in errs.items():
            assert e <= 2e-2, f"shape ({key}): {name} rel error {e} > 2e-2"
        assert lse_err <= 1e-3, f"shape ({key}): lse max abs error {lse_err} > 1e-3"
        if b_off:
            # Same inputs as (a): another mask must give another output.
            assert not torch.equal(out, outs["a"]), f"shape ({key}): the offset changed nothing"
        res = {
            "fwd": dict(max_abs_err=max(max_abs(out, p_out), lse_err)),
            "dq": dict(max_abs_err=max_abs(dq, p_dq)),
            "dkv": dict(max_abs_err=max(max_abs(dk, p_dk), max_abs(dv, p_dv))),
        }
        if sh["row"] is not None:
            timings = {
                "fwd": (lambda: fa.flash_fwd(q, k, v, c, r, seed),
                        lambda: fa.flash_forward_plain(q, k, v, c, r, seed)),
                "dq": (lambda: fa.flash_bwd_dq(*bwd), lambda: fa.flash_bwd_dq_plain(*bwd)),
                "dkv": (lambda: fa.flash_bwd_dkv(*bwd), lambda: fa.flash_bwd_dkv_plain(*bwd)),
            }
            for kind, (kern, plain) in timings.items():
                res[kind]["ms"] = median_ms(kern)
                res[kind]["device_ms"] = median_ms(kern, device_clock=True)
                res[kind]["plain_ms"] = median_ms(plain, warmup=2, reps=20)
                res[kind]["bound_ms"], res[kind]["bound_by"] = bound(kind, sh, peaks)
                res[kind]["library_ms"] = None
            # Yardstick: SDPA on the same (B=1, H=BH, S, Dh) layout, rate 0.
            qs, ks, vs = (t.unsqueeze(0).detach().requires_grad_(True) for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            res["fwd"]["library_ms"] = median_ms(lambda: sdpa(qs, ks, vs, is_causal=c))
            res["fwd"]["library_device_ms"] = median_ms(lambda: sdpa(qs, ks, vs, is_causal=c),
                                                        device_clock=True)
            do4 = do.unsqueeze(0)
            res["fwd"]["library_fwd_bwd_ms"] = median_ms(
                lambda: torch.autograd.grad(sdpa(qs, ks, vs, is_causal=c), (qs, ks, vs), do4))
            lib = library_flash_bwd(q, k, v, do, c)
            if r == 0.0:
                lib_dq, lib_dk, lib_dv = (t[0] for t in lib())
                log(f"[2] shape ({key}) library backward vs the kernels, rel-Frobenius: dq "
                    f"{rel_err(lib_dq, dq):.2e}, dk {rel_err(lib_dk, dk):.2e}, dv "
                    f"{rel_err(lib_dv, dv):.2e}")
            time_pair(res, fa, p_out, do, (
                median_ms(lib), median_ms(lib, device_clock=True),
                "torch's flash-attention backward (aten._scaled_dot_product_flash_attention_"
                "backward), rate 0, one call for dq, dk and dv; pair_ms is dq + dk/dv + "
                "attention_delta"))
            if r > 0:
                out0, lse0 = fa.flash_fwd(q, k, v, c, 0.0, seed)
                bwd0 = (q, k, v, do, lse0, fa.attention_delta(out0, do), c, 0.0, seed)
                time_rate0(res, lambda: fa.flash_fwd(q, k, v, c, 0.0, seed),
                           lambda: fa.flash_bwd_dq(*bwd0), lambda: fa.flash_bwd_dkv(*bwd0))
            log(f"[2] shape ({key}) times (ms, median of 25): " + json.dumps(
                {kind: {n: (round(x, 5) if isinstance(x, float) else x) for n, x in d.items()
                        if n != "library_note"} for kind, d in res.items()}))
            results[key] = res
        del q, k, v, do
        torch.cuda.empty_cache()
    return results


def phase_train(fa, ra, run_benchmark):
    """Phase 3: both rows at full tier-A width through run_benchmark."""
    rows = {
        "parity": dict(model_family="tinygpt", per_device_batch=1, grad_accum=4, layers=16),
        "flagship": dict(model_family="llama", per_device_batch=2, grad_accum=2, layers=16),
    }
    out, losses, results = {}, {}, {}
    for name, row in rows.items():
        steps = WARMUP_STEPS + TIMED_STEPS
        fa.reset_launch_counts()
        losses[name] = []
        res = run_benchmark(
            strategy="zero2", tier="A", seq_len=2048, model_family=row["model_family"],
            steps=steps, warmup_steps=WARMUP_STEPS, per_device_batch=row["per_device_batch"],
            grad_accum=row["grad_accum"], attention_impl="flash", sync_every=5, device="cuda",
            loss_log=losses[name],
        )
        counts = fa.launch_counts()
        want = row["layers"] * row["grad_accum"] * steps
        log(f"[3] {name}: {res.model_family} tier A b{res.per_device_batch}x{res.grad_accum} "
            f"dropout {res.dropout}: {res.tokens_per_sec:.1f} tok/s, step "
            f"{1e3 * res.mean_step_time_sec:.2f} ms, MFU {res.mfu_pct:.2f}% "
            f"({res.device_kind}), peak {res.peak_hbm_gb:.2f} GB ({res.peak_hbm_method}), "
            f"loss first {res.loss_first_window:.4f} last {res.loss_last_window:.4f}, "
            f"launches {counts} (want {want} each)")
        assert math.isfinite(res.loss_first_window) and math.isfinite(res.loss_last_window)
        assert res.loss_last_window < res.loss_first_window, f"{name}: loss did not fall"
        for kernel, n in counts.items():
            assert n == want, f"{name}: {kernel} launched {n} times, want {want}"
        assert set(ra.launch_counts().values()) == {0}, f"{name}: ring kernels ran"
        out[name] = counts
        results[name] = res
        torch.cuda.empty_cache()
    return out, losses, results


def phase_whole_model(fa, models, SyntheticDataset):
    """Phase 4: first-step tier-A loss, kernels vs the plain attention."""
    for family in models.MODEL_FAMILIES:
        cfg = models.get_config(family, "A", 2048, dropout=0.0, attention_impl="flash")
        with torch.device("cuda"):
            model = models.TinyGPT(cfg)
        model.init_weights(torch.Generator(device="cuda").manual_seed(0))
        batch = SyntheticDataset(cfg.vocab_size, 2048, 4, seed=42).to_device("cuda")[:1]
        with torch.no_grad():
            _, loss_kernels = model(batch, batch)
            model.attention = fa.flash_attention_plain
            _, loss_plain = model(batch, batch)
        diff = abs(loss_kernels.item() - loss_plain.item())
        log(f"[4] {family} tier A first-step loss: kernels {loss_kernels.item():.6f}, "
            f"plain {loss_plain.item():.6f}, |diff| {diff:.2e}")
        assert math.isfinite(loss_kernels.item()) and diff <= 1e-2, f"{family}: |diff| {diff}"
        del model
        torch.cuda.empty_cache()


RING_ROWS = {
    "parity ring": dict(model_family="tinygpt", per_device_batch=1, grad_accum=1, layers=16),
    "flagship ring": dict(model_family="llama", per_device_batch=1, grad_accum=2, layers=16),
}
# The ring kernels are checked and timed at the blocks the ring rows launch:
# B is the batch the row trains at.
RING_SHAPES = {
    "d": dict(B=RING_ROWS["parity ring"]["per_device_batch"], H=16, S=8192, n=4, D=64,
              causal=False, rate=0.1, zigzag=False, row="parity ring"),
    "e": dict(B=RING_ROWS["flagship ring"]["per_device_batch"], H=8, S=8192, n=4, D=128,
              causal=True, rate=0.0, zigzag=True, row="flagship ring"),
}
RING_CHECKED_SHARDS = (0, 3)
RING_TIMED = (1, 1)  # (shard, hop) of the timed block


def ring_block_inputs(fa, ra, sh, my: int, t: int):
    """Tile bases, per-row global positions and live score elements of the
    block that shard ``my`` holds at hop ``t``."""
    n, Sl = sh["n"], sh["S"] // sh["n"]
    tiles = ra._shard_tiles(n, Sl, sh["zigzag"], "cuda")
    src = (my - t) % n
    qo, ko = tiles[my], tiles[src]
    rows = fa._tile_coords(qo, Sl, "cuda")
    cols = fa._tile_coords(ko, Sl, "cuda")
    BH = sh["B"] * sh["H"]
    live = BH * (int((rows[:, None] >= cols[None, :]).sum()) if sh["causal"] else Sl * Sl)
    return qo, ko, rows, cols, live


def phase_ring_kernels(fa, ra, peaks):
    """Phases 5 and 6: K4, K2′, K3′ vs plain at every hop of two shards, and
    their times at one hop, at ring shapes (d) and (e)."""
    results = {}
    for key, sh in RING_SHAPES.items():
        B, H, n, D = sh["B"], sh["H"], sh["n"], sh["D"]
        BH, Sl = B * H, sh["S"] // n
        q, k, v, do = make_inputs(dict(BH=BH, S=Sl, D=D), seed=1)
        c, r, seed = sh["causal"], sh["rate"], 0x2545F491
        bhv = ra._global_bh_vec(B, H, 0, 0, H, "cuda")
        errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
        worst = {"o": 0.0, "m": 0.0, "l": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
        for my in RING_CHECKED_SHARDS:
            for t in range(n):
                qo, ko, rows, cols, live = ring_block_inputs(fa, ra, sh, my, t)
                m, l, o = ra.ring_fwd_block(q, k, v, c, r, seed, qo, ko, bhv)
                pm, pl, po = ra._block_stats_plain(q, k, v, seed, rows, cols, bhv, c, r)
                l_safe = torch.where(pl == 0, 1.0, pl)
                lse = pm + torch.log(l_safe)
                delta = fa.attention_delta((po / l_safe[..., None]).to(q.dtype), do)
                bwd = (q, k, v, do, lse, delta, c, r, seed, qo, ko, bhv)
                dq = fa.flash_bwd_dq(*bwd, out_dtype=torch.float32)
                dk, dv = fa.flash_bwd_dkv(*bwd, out_dtype=torch.float32)
                torch.cuda.synchronize()
                p_dq = fa.flash_bwd_dq_plain(*bwd, out_dtype=torch.float32)
                p_dk, p_dv = fa.flash_bwd_dkv_plain(*bwd, out_dtype=torch.float32)
                hop = {"o": rel_err(o, po), "m": max_abs(m, pm), "l": max_abs(l, pl),
                       "dq": rel_err(dq, p_dq), "dk": rel_err(dk, p_dk), "dv": rel_err(dv, p_dv)}
                log(f"[5] ({key}) shard {my} hop {t} (block from shard {(my - t) % n}, "
                    f"{live / (BH * Sl * Sl):.3f} live): rel-Frobenius o/dq/dk/dv "
                    f"{hop['o']:.2e}/{hop['dq']:.2e}/{hop['dk']:.2e}/{hop['dv']:.2e}, "
                    f"max abs m {hop['m']:.2e} l {hop['l']:.2e}")
                for name in ("o", "dq", "dk", "dv"):
                    assert hop[name] <= 2e-2, f"({key}) {my}/{t}: {name} rel {hop[name]} > 2e-2"
                for name in ("m", "l"):
                    assert hop[name] <= 1e-3, f"({key}) {my}/{t}: {name} max abs {hop[name]} > 1e-3"
                worst = {name: max(worst[name], e) for name, e in hop.items()}
                errs["fwd"] = max(errs["fwd"], max_abs(o, po), hop["m"], hop["l"])
                errs["dq"] = max(errs["dq"], max_abs(dq, p_dq))
                errs["dkv"] = max(errs["dkv"], max_abs(dk, p_dk), max_abs(dv, p_dv))
        log(f"[5] ({key}) worst over shards {RING_CHECKED_SHARDS}, every hop: "
            + json.dumps({name: f"{e:.2e}" for name, e in worst.items()}))

        my, t = RING_TIMED
        qo, ko, rows, cols, live = ring_block_inputs(fa, ra, sh, my, t)
        m, l, o = ra.ring_fwd_block(q, k, v, c, r, seed, qo, ko, bhv)
        l_safe = torch.where(l == 0, 1.0, l)
        lse = m + torch.log(l_safe)
        delta = fa.attention_delta((o / l_safe[..., None]).to(q.dtype), do)
        bwd = (q, k, v, do, lse, delta, c, r, seed, qo, ko, bhv)
        f32 = torch.float32
        mat, mat32, row = BH * Sl * D * 2, BH * Sl * D * 4, BH * Sl * 4
        nbytes = {"fwd": 3 * mat + mat32 + 2 * row, "dq": 4 * mat + 2 * row + mat32,
                  "dkv": 4 * mat + 2 * row + 2 * mat32}
        timings = {
            "fwd": (lambda: ra.ring_fwd_block(q, k, v, c, r, seed, qo, ko, bhv),
                    lambda: ra._block_stats_plain(q, k, v, seed, rows, cols, bhv, c, r)),
            "dq": (lambda: fa.flash_bwd_dq(*bwd, out_dtype=f32),
                   lambda: fa.flash_bwd_dq_plain(*bwd, out_dtype=f32)),
            "dkv": (lambda: fa.flash_bwd_dkv(*bwd, out_dtype=f32),
                    lambda: fa.flash_bwd_dkv_plain(*bwd, out_dtype=f32)),
        }
        res = {}
        for kind, (kern, plain) in timings.items():
            res[kind] = dict(max_abs_err=errs[kind], ms=median_ms(kern),
                             device_ms=median_ms(kern, device_clock=True),
                             plain_ms=median_ms(plain, warmup=2, reps=20), library_ms=None)
            res[kind]["bound_ms"], res[kind]["bound_by"] = bound_ms(
                kind, D, live, nbytes[kind], r, peaks)
        # Yardstick: SDPA forward on the same block at rate 0, with the
        # block's causal mask (every row of the timed block has a live key).
        qs, ks, vs = (t_.unsqueeze(0) for t_ in (q, k, v))
        mask = (rows[:, None] >= cols[None, :]) if c else None
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["fwd"]["library_ms"] = median_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask))
        res["fwd"]["library_device_ms"] = median_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask),
                                                    device_clock=True)
        res["fwd"]["library_note"] = ("SDPA forward, rate 0, on the same block; it returns "
                                      "a normalized output, K4 an unnormalized one")
        # The backward pair's yardstick at rate 0: torch's flash-attention
        # backward where the block's mask is none (d); the flash op cannot
        # take the zigzag block's half-live mask (e), so there SDPA's masked
        # forward + backward less its forward.
        out = (o / l_safe[..., None]).to(q.dtype)
        if mask is None:
            lib = library_flash_bwd(q, k, v, do, False)
            library = (median_ms(lib), median_ms(lib, device_clock=True),
                       "torch's flash-attention backward (aten._scaled_dot_product_flash_"
                       "attention_backward), rate 0, one call for dq, dk and dv; pair_ms is "
                       "dq + dk/dv + attention_delta")
        else:
            qg, kg, vg = (t_.detach().requires_grad_(True) for t_ in (qs, ks, vs))
            do4 = do.unsqueeze(0)
            fwd = lambda: sdpa(qg, kg, vg, attn_mask=mask)  # noqa: E731
            fwd_bwd = lambda: torch.autograd.grad(sdpa(qg, kg, vg, attn_mask=mask),  # noqa: E731
                                                  (qg, kg, vg), do4)
            library = (median_ms(fwd_bwd) - median_ms(fwd),
                       median_ms(fwd_bwd, device_clock=True) - median_ms(fwd, device_clock=True),
                       "SDPA with the block's causal mask, rate 0: torch.autograd.grad of "
                       "scaled_dot_product_attention(attn_mask=mask) less that call's forward "
                       "(the flash backward op takes no mask); pair_ms is dq + dk/dv + "
                       "attention_delta")
        time_pair(res, fa, out, do, library)
        if r > 0:
            m0, l0, o0 = ra.ring_fwd_block(q, k, v, c, 0.0, seed, qo, ko, bhv)
            l0 = torch.where(l0 == 0, 1.0, l0)
            delta0 = fa.attention_delta((o0 / l0[..., None]).to(q.dtype), do)
            bwd0 = (q, k, v, do, m0 + torch.log(l0), delta0, c, 0.0, seed, qo, ko, bhv)
            time_rate0(res, lambda: ra.ring_fwd_block(q, k, v, c, 0.0, seed, qo, ko, bhv),
                       lambda: fa.flash_bwd_dq(*bwd0, out_dtype=f32),
                       lambda: fa.flash_bwd_dkv(*bwd0, out_dtype=f32))
        log(f"[6] ({key}) shard {my} hop {t}, {live / (BH * Sl * Sl):.3f} live, times (ms, "
            "median of 25): " + json.dumps(
                {kind: {nm: (round(x, 5) if isinstance(x, float) else x) for nm, x in d.items()
                        if nm != "library_note"} for kind, d in res.items()}))
        results[key] = res
        del q, k, v, do
        torch.cuda.empty_cache()
    return results


def phase_ring_vs_flash(fa, ra):
    """Phase 7: ring_attention over 4 shards against flash_attention over the
    whole sequence, forward and backward, both layouts, rate 0 and 0.1."""
    for key, sh in RING_SHAPES.items():
        B, H, S, D, c = sh["B"], sh["H"], sh["S"], sh["D"], sh["causal"]
        g = torch.Generator(device="cuda").manual_seed(2)
        q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g).to(torch.bfloat16)
                       for _ in range(4))
        for zigzag in (False, True):
            for rate in (0.0, 0.1):
                outs = []
                for fn in (lambda a, b, d: ra.ring_attention(
                               a, b, d, causal=c, dropout_rate=rate, dropout_seed=7,
                               seq_shards=sh["n"], zigzag=zigzag),
                           lambda a, b, d: fa.flash_attention(
                               a, b, d, causal=c, dropout_rate=rate, dropout_seed=7)):
                    qq, kk, vv = (t_.detach().requires_grad_(True) for t_ in (q, k, v))
                    out = fn(qq, kk, vv)
                    outs.append((out, *torch.autograd.grad(out, (qq, kk, vv), do)))
                errs = {nm: rel_err(a, b) for nm, a, b in zip(("out", "dq", "dk", "dv"), *outs)}
                log(f"[7] ({key}) B {B} S {S} H {H} Dh {D} causal {c} "
                    f"{'zigzag' if zigzag else 'contiguous'} rate {rate}: ring vs flash "
                    "rel-Frobenius " + json.dumps({nm: f"{e:.2e}" for nm, e in errs.items()}))
                for nm, e in errs.items():
                    assert e <= 2e-2, f"({key}) zigzag={zigzag} rate={rate}: {nm} rel {e} > 2e-2"
                del outs
        del q, k, v, do
        torch.cuda.empty_cache()


def phase_ring_train(fa, ra, run_benchmark):
    """Phase 8: both ring rows through run_benchmark on the one card."""
    out = {}
    for name, row in RING_ROWS.items():
        steps = WARMUP_STEPS + TIMED_STEPS
        fa.reset_launch_counts()
        res = run_benchmark(
            strategy="zero2", tier="A", seq_len=8192, model_family=row["model_family"],
            steps=steps, warmup_steps=WARMUP_STEPS, per_device_batch=row["per_device_batch"],
            grad_accum=row["grad_accum"], attention_impl="ring", sequence_parallel=4,
            sync_every=5, device="cuda",
        )
        counts, flash_counts = ra.launch_counts(), fa.launch_counts()
        want = row["layers"] * row["grad_accum"] * steps * 16
        log(f"[8] {name}: {res.model_family} tier A S 8192 sp {res.sequence_parallel} "
            f"zigzag {res.ring_zigzag} causal {res.causal} b{res.per_device_batch}x"
            f"{res.grad_accum} dropout {res.dropout}: {res.tokens_per_sec:.1f} tok/s, step "
            f"{1e3 * res.mean_step_time_sec:.2f} ms, MFU {res.mfu_pct:.2f}% "
            f"({res.device_kind}), peak {res.peak_hbm_gb:.2f} GB ({res.peak_hbm_method}), "
            f"loss first {res.loss_first_window:.4f} last {res.loss_last_window:.4f}, "
            f"ring launches {counts} (want {want} each), flash launches {flash_counts}")
        assert math.isfinite(res.loss_first_window) and math.isfinite(res.loss_last_window)
        assert res.loss_last_window < res.loss_first_window, f"{name}: loss did not fall"
        for kernel, n in counts.items():
            assert n == want, f"{name}: {kernel} launched {n} times, want {want}"
        assert set(flash_counts.values()) == {0}, f"{name}: flash kernels ran: {flash_counts}"
        out[name] = counts
        torch.cuda.empty_cache()
    return out


def phase_ring_whole_model(fa, models, SyntheticDataset, make_mesh):
    """Phase 9: first-step tier-A loss at S 8192, ring (4 shards) vs flash."""
    for family in models.MODEL_FAMILIES:
        cfg = models.get_config(family, "A", 8192, dropout=0.0, attention_impl="ring")
        with torch.device("cuda"):
            model = models.TinyGPT(cfg, mesh=make_mesh((4,), ("seq",)))
        model.init_weights(torch.Generator(device="cuda").manual_seed(0))
        batch = SyntheticDataset(cfg.vocab_size, 8192, 4, seed=42).to_device("cuda")[:1]
        with torch.no_grad():
            _, loss_ring = model(batch, batch)
            model.attention = fa.flash_attention
            _, loss_flash = model(batch, batch)
        diff = abs(loss_ring.item() - loss_flash.item())
        log(f"[9] {family} tier A S 8192 first-step loss: ring {loss_ring.item():.6f}, "
            f"flash {loss_flash.item():.6f}, |diff| {diff:.2e}")
        assert math.isfinite(loss_ring.item()) and diff <= 1e-2, f"{family}: |diff| {diff}"
        del model
        torch.cuda.empty_cache()


FWD_SHAPES = {
    "f": dict(BH=16, S=2048, D=64),
    "g": dict(BH=4, S=256, D=128),
}
FWD_SOURCE = "distributed_llm_training_benchmark_framework_tpu_torch/csrc/fwd_variants.cu"
# Line of each Pallas kernel in scripts/microbench_flash_fwd.py.
FWD_REPLACES = {"fwd_current": 83, "fwd_headpair": 140, "fwd_kt": 199,
                "fwd_matmul_only": 258, "fwd_qscaled": 303}


def phase_fwd_variants(fa, fv, peaks):
    """Phase 10: K5-K9 against their plain versions at (f) and (g), K5, K6
    and K7 == K1 bitwise, K9 == K5 bitwise at Dh 64, K8 == its plain version
    bitwise on integer inputs, cross-variant differences, times at (f)."""
    results = {n: {"max_abs_err": 0.0} for n in fv.VARIANTS}
    for key, sh in FWD_SHAPES.items():
        BH, S, D = sh["BH"], sh["S"], sh["D"]
        q, k, v, _ = make_inputs(sh, seed=3)
        kt = k.transpose(1, 2).contiguous()
        args = {n: (q, kt, v) if n == "fwd_kt" else (q, k, v) for n in fv.VARIANTS}
        outs = {n: fv.WRAPPERS[n](*a) for n, a in args.items()}
        k1, _ = fa.flash_fwd(q, k, v, False, 0.0, 0)
        torch.cuda.synchronize()
        plains = {n: fv.PLAIN[n](*a) for n, a in args.items()}
        errs = {n: rel_err(outs[n], plains[n]) for n in fv.VARIANTS}
        cur = outs["fwd_current"]
        # K1 and K5-K9 run one wgmma mainloop (csrc/flash_fwd_sm90.cuh); K8
        # is its matmul-only instance and computes another function.
        cross = {"K5-K6": max_abs(cur, outs["fwd_headpair"]), "K5-K7": max_abs(cur, outs["fwd_kt"]),
                 "K6-K7": max_abs(outs["fwd_headpair"], outs["fwd_kt"]),
                 "K5-K9": max_abs(cur, outs["fwd_qscaled"]), "K5-K1": max_abs(cur, k1),
                 "K1-K6": max_abs(k1, outs["fwd_headpair"]), "K1-K7": max_abs(k1, outs["fwd_kt"])}
        log(f"[10] ({key}) BH={BH} S={S} Dh={D}: rel-Frobenius vs plain "
            + json.dumps({n: f"{e:.2e}" for n, e in errs.items()})
            + "; max abs between kernels " + json.dumps({n: f"{e:.2e}" for n, e in cross.items()}))
        for n, e in errs.items():
            assert e <= 2e-2, f"({key}) {n}: rel error {e} > 2e-2"
            results[n]["max_abs_err"] = max(results[n]["max_abs_err"], max_abs(outs[n], plains[n]))
        # No softmax, so no online-rescale gap: only the sums' order differs.
        assert errs["fwd_matmul_only"] <= 2e-3, \
            f"({key}) fwd_matmul_only: rel error {errs['fwd_matmul_only']} > 2e-3"
        if D == 64:
            assert torch.equal(outs["fwd_qscaled"], cur), f"({key}) K9 differs from K5 at Dh 64"
            # Integers in {-2, ..., 2}: |s| <= 256 fits bf16's 8 bits, s * 2^-3
            # is exact, and every fp32 sum of P.V (multiples of 2^-3 below
            # 2^17) is exact in any order, so the kernel must equal its plain
            # version bit for bit.
            g = torch.Generator(device="cuda").manual_seed(11)
            qi, ki, vi = (torch.randint(-2, 3, (BH, S, D), device="cuda", generator=g)
                          .to(torch.bfloat16) for _ in range(3))
            got, want = fv.fwd_matmul_only(qi, ki, vi), fv.fwd_matmul_only_plain(qi, ki, vi)
            log(f"[10] ({key}) K8 on integer inputs: max abs vs plain {max_abs(got, want):.2e}")
            assert torch.equal(got, want), f"({key}) K8 differs from its plain version on integers"
            del qi, ki, vi, got, want
        # K5, K6 and K7 are K1's loop with K1's arithmetic (K7 only reads k
        # through a transposed descriptor): K1's output bit for bit.
        for nm in ("fwd_current", "fwd_headpair", "fwd_kt"):
            assert torch.equal(outs[nm], k1), \
                f"({key}) {nm} differs from K1: max abs {max_abs(outs[nm], k1)}"
        if key == "f":
            live = BH * S * S
            bound = bound_ms("fwd", D, live, 4 * BH * S * D * 2, 0.0, peaks)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            sdpa_ms = median_ms(lambda: sdpa(q[None], k[None], v[None]))
            sdpa_device_ms = median_ms(lambda: sdpa(q[None], k[None], v[None]), device_clock=True)
            # K8 in two calls: bf16(scale * q.k^T), then its product with v.
            buf = torch.empty(BH, S, S, dtype=q.dtype, device=q.device)
            two_calls = lambda: torch.bmm(  # noqa: E731
                torch.baddbmm(buf, q, k.transpose(1, 2), beta=0.0, alpha=D ** -0.5), v)
            two_calls_ms = median_ms(two_calls)
            two_calls_device_ms = median_ms(two_calls, device_clock=True)
            for n, a in args.items():
                r = results[n]
                r["ms"] = median_ms(lambda: fv.WRAPPERS[n](*a))
                r["device_ms"] = median_ms(lambda: fv.WRAPPERS[n](*a), device_clock=True)
                r["plain_ms"] = median_ms(lambda: fv.PLAIN[n](*a), warmup=2, reps=20)
                r["bound_ms"], r["bound_by"] = bound
                if n == "fwd_matmul_only":
                    r["library_ms"] = None
                    r["library_two_calls_ms"] = two_calls_ms
                    r["library_device_ms"] = two_calls_device_ms
                    r["library_note"] = ("no one call computes K8: torch.baddbmm(beta=0, "
                                         "alpha=scale) then torch.bmm, two calls, on both "
                                         "clocks (library_two_calls_ms, library_device_ms)")
                else:
                    r["library_ms"] = sdpa_ms
                    r["library_device_ms"] = sdpa_device_ms
                    r["exp_bound_ms"] = 1e3 * live / H100_EXP_OPS
            k1_ms = median_ms(lambda: fa.flash_fwd(q, k, v, False, 0.0, 0))
            k1_device_ms = median_ms(lambda: fa.flash_fwd(q, k, v, False, 0.0, 0),
                                     device_clock=True)
            on_k1 = {"K5": "fwd_current", "K6": "fwd_headpair", "K7": "fwd_kt",
                     "K9": "fwd_qscaled"}
            for n in on_k1.values():
                results[n]["flash_fwd_device_ms"] = k1_device_ms
                results[n]["vs_flash_fwd_device"] = results[n]["device_ms"] / k1_device_ms
            # The microbench's split of one forward: its products (K8)
            # against products and softmax (K5), one design.
            k8 = results["fwd_matmul_only"]
            k8["vs_fwd_current_device"] = k8["device_ms"] / results["fwd_current"]["device_ms"]
            vs_k1 = ", ".join(f"{kn} / K1 {results[n]['vs_flash_fwd_device']:.3f}"
                              for kn, n in on_k1.items())
            log(f"[10] ({key}) K1 (flash_fwd, rate 0, non-causal, lse written; the wgmma "
                f"mainloop K5-K9 share) {k1_ms:.5f} ms (device {k1_device_ms:.5f}); "
                f"{vs_k1} on the device clock; K9 / K5 "
                f"{results['fwd_qscaled']['device_ms'] / results['fwd_current']['device_ms']:.3f}; "
                f"K8 / K5 {k8['vs_fwd_current_device']:.3f}; "
                f"SDPA {sdpa_ms:.5f} ms (device {sdpa_device_ms:.5f}); K8 as baddbmm + bmm "
                f"{two_calls_ms:.5f} ms (device {two_calls_device_ms:.5f})")
            log(f"[10] ({key}) times (ms, median of 25): " + json.dumps(
                {n: {nm: (round(x, 5) if isinstance(x, float) else x) for nm, x in r.items()
                     if nm != "library_note"} for n, r in results.items()}))
        del q, k, v, kt, outs, plains
        torch.cuda.empty_cache()
    return results


def phase_microbench(build, mb):
    """Phase 11: the microbench through its module at (f); every kernel's
    launch count equals the launches its row made."""
    sh = FWD_SHAPES["f"]
    build.reset_launch_counts()
    rows = mb.main(["--bh", str(sh["BH"]), "--seq", str(sh["S"]), "--dim", str(sh["D"]),
                    "--reps", "25", "--device", "cuda"])
    counts = dict(build.LAUNCHES)
    want = {r["kernel"]: r["launches"] for r in rows if r["kernel"]}
    log(f"[11] launches {counts} (want {want})")
    assert counts == want, f"microbench launches {counts}, want {want}"
    for r in rows:
        assert r["ms"] > 0 and math.isfinite(r["max_abs"]), r
        if r["ref"] == "sdpa_materialized":
            assert r["max_abs"] <= 2e-2, f"{r['name']}: max abs {r['max_abs']} vs sdpa_materialized"
    torch.cuda.empty_cache()
    return counts


def fwd_bwd(attn, q, k, v, do):
    """(out, dq, dk, dv) of ``attn`` on fresh leaves of q, k, v, with do as
    the output's cotangent."""
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = attn(qq, kk, vv)
    return (out.detach(), *torch.autograd.grad(out, (qq, kk, vv), do))


def ulysses_mask_stats(fa, ua, sh, seed: int) -> tuple[float, float, float]:
    """(kept share, keep probability, share of elements whose keep differs
    from flash's) of the masks Ulysses' folded seeds draw at a non-causal
    shape, by the coordinate hash: head group g keys local batch*head ids
    from 0 under seed _shard_seed(seed, g), flash global ids under seed."""
    B, H, S, n = sh["B"], sh["H"], sh["S"], sh["n"]
    thr = fa.dropout_threshold(sh["rate"])
    idx = torch.arange(S, device="cuda", dtype=torch.int64)
    kept = differ = 0
    Hg = H // n
    for g in range(n):
        seed_g = ua._shard_seed(seed, ua._global_shard_index(g, n))
        for b in range(B):
            for h in range(Hg):
                keep = fa.dropout_keep(seed_g, b * Hg + h, idx[:, None], idx[None, :], thr)
                flash = fa.dropout_keep(seed, b * H + g * Hg + h, idx[:, None], idx[None, :], thr)
                kept += int(keep.sum())
                differ += int((keep != flash).sum())
                del keep, flash
    total = B * H * S * S
    return kept / total, thr / 2**32, differ / total


def phase_ulysses(fa, ua):
    """Phase 13: ulysses_attention over 4 head groups at (u) and (v) on the
    kernels against the same function over flash_attention_plain; bit
    equality with flash at rate 0; the kept share at rate 0.1."""
    import unittest.mock

    for key, sh in ULYSSES_SHAPES.items():
        B, H, S, D, n, c, r = (sh[x] for x in ("B", "H", "S", "D", "n", "causal", "rate"))
        g = torch.Generator(device="cuda").manual_seed(4)
        q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g).to(torch.bfloat16)
                       for _ in range(4))
        seed = 7

        def ulysses(a, b, d):
            return ua.ulysses_attention(a, b, d, causal=c, dropout_rate=r, dropout_seed=seed,
                                        seq_shards=n)

        kern = fwd_bwd(ulysses, q, k, v, do)
        with unittest.mock.patch.object(ua, "flash_attention", fa.flash_attention_plain):
            plain = fwd_bwd(ulysses, q, k, v, do)
        errs = {nm: rel_err(a, b) for nm, a, b in zip(("out", "dq", "dk", "dv"), kern, plain)}
        flash = fwd_bwd(lambda a, b, d: fa.flash_attention(a, b, d, causal=c, dropout_rate=r,
                                                           dropout_seed=seed), q, k, v, do)
        vs_flash = {nm: max_abs(a, b) for nm, a, b in zip(("out", "dq", "dk", "dv"), kern, flash)}
        log(f"[13] ({key}) ulysses_attention B {B} S {S} H {H} Dh {D} causal {c} rate {r} "
            f"over {n} head groups: kernels vs plain rel-Frobenius "
            + json.dumps({nm: f"{e:.2e}" for nm, e in errs.items()})
            + "; max abs vs flash_attention " + json.dumps({nm: f"{e:.2e}"
                                                             for nm, e in vs_flash.items()}))
        for nm, e in errs.items():
            assert e <= 2e-2, f"({key}) ulysses {nm}: rel error {e} > 2e-2"
        if r == 0.0:
            for nm, e in vs_flash.items():
                assert e == 0.0, f"({key}) ulysses {nm} differs from flash's at rate 0 by {e}"
        else:
            share, p_keep, differ = ulysses_mask_stats(fa, ua, sh, seed)
            bound = 6 * math.sqrt(p_keep * (1 - p_keep) / (B * H * S * S))
            log(f"[13] ({key}) kept share {share:.6f} (keep probability {p_keep:.6f}, 6 sigma "
                f"{bound:.2e}); {differ:.4f} of the elements keep otherwise than flash's mask")
            assert abs(share - p_keep) <= bound, f"({key}) kept share {share} vs {p_keep}"
            assert differ > 0.1 and vs_flash["out"] > 1e-2, f"({key}) the mask is flash's"
        del q, k, v, do, kern, plain, flash
        torch.cuda.empty_cache()


def phase_ulysses_train(fa, ra, run_benchmark):
    """Phase 14: both Ulysses rows through run_benchmark on the one card."""
    out = {}
    for name, row in ULYSSES_ROWS.items():
        steps = WARMUP_STEPS + TIMED_STEPS
        fa.reset_launch_counts()
        res = run_benchmark(
            strategy="zero2", tier="A", seq_len=8192, model_family=row["model_family"],
            steps=steps, warmup_steps=WARMUP_STEPS, per_device_batch=row["per_device_batch"],
            grad_accum=row["grad_accum"], attention_impl="ulysses", sequence_parallel=4,
            sync_every=5, device="cuda",
        )
        counts, ring_counts = fa.launch_counts(), ra.launch_counts()
        per_step = row["layers"] * row["grad_accum"] * 4
        want = per_step * steps
        log(f"[14] {name}: {res.model_family} tier A S 8192 sp {res.sequence_parallel} causal "
            f"{res.causal} b{res.per_device_batch}x{res.grad_accum} dropout {res.dropout}: "
            f"{res.tokens_per_sec:.1f} tok/s, step {1e3 * res.mean_step_time_sec:.2f} ms, MFU "
            f"{res.mfu_pct:.2f}% ({res.device_kind}), world_size {res.world_size}, peak "
            f"{res.peak_hbm_gb:.2f} GB ({res.peak_hbm_method}), loss first "
            f"{res.loss_first_window:.4f} last {res.loss_last_window:.4f}, launches {counts} "
            f"(want {want} each, {per_step} per step), ring launches {ring_counts}")
        assert math.isfinite(res.loss_first_window) and math.isfinite(res.loss_last_window)
        assert res.loss_last_window < res.loss_first_window, f"{name}: loss did not fall"
        for kernel, n in counts.items():
            assert n == want, f"{name}: {kernel} launched {n} times, want {want}"
        assert set(ring_counts.values()) == {0}, f"{name}: ring kernels ran: {ring_counts}"
        out[name] = counts
        torch.cuda.empty_cache()
    return out


def phase_group_forms(fa, ra, ua, run_benchmark, no_group_losses):
    """Phase 15, inside the single-rank NCCL group: the sharded ring and
    Ulysses at (a) and (b) against their plain versions, and the bench's
    Ulysses (seq width 1) on the parity row against the no-group run."""
    import torch.distributed as dist

    group = dist.group.WORLD
    for key in ("a", "b"):
        sh = SHAPES[key]
        H, S, D, c, r, seed = sh["BH"], sh["S"], sh["D"], sh["causal"], sh["rate"], 0x2545F491
        g = torch.Generator(device="cuda").manual_seed(5)
        q, k, v, do = (torch.randn(1, S, H, D, device="cuda", generator=g).to(torch.bfloat16)
                       for _ in range(4))
        folded = ua._shard_seed(seed, ua._global_shard_index(0, 1))
        forms = {
            "ring_attention_sharded": (
                lambda a, b, d: ra.ring_attention_sharded(a, b, d, group=group, causal=c,
                                                          dropout_rate=r, dropout_seed=seed),
                lambda a, b, d: fa.flash_attention_plain(a, b, d, causal=c, dropout_rate=r,
                                                         dropout_seed=seed)),
            "ulysses_attention_sharded": (
                lambda a, b, d: ua.ulysses_attention_sharded(a, b, d, group=group, causal=c,
                                                             dropout_rate=r, dropout_seed=seed),
                lambda a, b, d: fa.flash_attention_plain(a, b, d, causal=c, dropout_rate=r,
                                                         dropout_seed=folded)),
        }
        fa.reset_launch_counts()
        outs = {}
        for name, (form, plain) in forms.items():
            got, want = fwd_bwd(form, q, k, v, do), fwd_bwd(plain, q, k, v, do)
            errs = {nm: rel_err(a, b) for nm, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
            log(f"[15] ({key}) {name} over the single-rank NCCL group, causal {c} rate {r}: "
                "vs plain rel-Frobenius " + json.dumps({nm: f"{e:.2e}" for nm, e in errs.items()}))
            for nm, e in errs.items():
                assert e <= 2e-2, f"({key}) {name} {nm}: rel error {e} > 2e-2"
            outs[name] = got
        counts = {**fa.launch_counts(), **ra.launch_counts()}
        log(f"[15] ({key}) launches: {counts}")
        assert set(counts.values()) == {1}, f"({key}) launches {counts}"
        if r == 0.0:
            flash = fwd_bwd(lambda a, b, d: fa.flash_attention(a, b, d, causal=c), q, k, v, do)
            for nm, a, b in zip(("out", "dq", "dk", "dv"), outs["ulysses_attention_sharded"],
                                flash):
                assert torch.equal(a, b), f"({key}) sharded ulysses {nm} is not flash's"
        del q, k, v, do, outs
        torch.cuda.empty_cache()
    steps = WARMUP_STEPS + TIMED_STEPS
    fa.reset_launch_counts()
    losses = []
    res = run_benchmark(
        strategy="zero2", tier="A", seq_len=2048, model_family=ARM_ROW["model_family"],
        steps=steps, warmup_steps=WARMUP_STEPS, per_device_batch=ARM_ROW["per_device_batch"],
        grad_accum=ARM_ROW["grad_accum"], attention_impl="ulysses", sync_every=5,
        device="cuda", loss_log=losses)
    counts = fa.launch_counts()
    want = ARM_ROW["layers"] * ARM_ROW["grad_accum"] * steps
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, no_group_losses))
    log(f"[15] run_benchmark(attention_impl='ulysses') parity row, zero2, single-rank NCCL "
        f"group, world_size {res.world_size}, sequence_parallel {res.sequence_parallel}: "
        f"{res.tokens_per_sec:.1f} tok/s, per-step loss vs the no-group flash run max relative "
        f"difference {rel:.2e} (limit {ARM_LOSS_RTOL}), launches {counts}")
    assert res.attention_impl == "ulysses" and len(losses) == steps
    assert rel <= ARM_LOSS_RTOL, f"ulysses under the group vs no group: {rel}"
    assert set(counts.values()) == {want}, f"launches {counts}, want {want} each"


ARMS = ("ddp", "fsdp", "zero2", "zero3")
# The parity row, trained under each arm.
ARM_ROW = dict(model_family="tinygpt", per_device_batch=1, grad_accum=4, layers=16)
# Largest relative difference allowed between a step's loss under the
# single-rank group and without a group (same seeds, same kernels).
ARM_LOSS_RTOL = 1e-3
# Remat recomputes with the same kernels on the same inputs; a recompute
# that drew another dropout mask would differ by O(1).
REMAT_GRAD_RTOL = 1e-5


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_remat(fa, models):
    """Phase 12, first part: one tier-A micro-batch of the parity model at
    dropout 0.1 under remat none, dots and full, same seeds:
    equal gradients, and K1 launched once more per layer under remat."""
    cfg = models.get_config("tinygpt", "A", 2048, dropout=0.1, attention_impl="flash")
    batch = torch.randint(0, cfg.vocab_size, (1, 2048), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(5))
    mask_seeds = models.draw_mask_seeds(torch.Generator().manual_seed(3), cfg.n_layer)
    grads = {}
    for remat in ("none", "dots", "full"):
        with torch.device("cuda"):
            model = models.TinyGPT(dataclasses.replace(cfg, remat=remat))
        model.init_weights(torch.Generator(device="cuda").manual_seed(0))
        fa.reset_launch_counts()
        _, loss = model(batch, batch, attn_seeds=list(range(1, 17)), mask_seeds=mask_seeds)
        loss.backward()
        counts = fa.launch_counts()
        want = {"flash_fwd": 16 * (1 if remat == "none" else 2), "flash_bwd_dq": 16,
                "flash_bwd_dkv": 16}
        assert counts == want, f"remat {remat}: launches {counts}, want {want}"
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
        del model
    for remat in ("dots", "full"):
        worst = max(max_abs(grads[remat][n], g) for n, g in grads["none"].items())
        rel = max(rel_err(grads[remat][n], g) for n, g in grads["none"].items())
        log(f"[12] remat {remat} vs none, tier A micro-batch at dropout 0.1: gradients max abs "
            f"{worst:.2e}, worst rel-Frobenius {rel:.2e} (limit {REMAT_GRAD_RTOL}); K1 twice "
            "per layer")
        assert rel <= REMAT_GRAD_RTOL, f"remat {remat}: gradients differ from none by {rel}"
    del grads
    torch.cuda.empty_cache()


def phase_arms(fa, ra, ua, models, make_mesh, get_strategy, rt, memory, loop):
    """Phase 12: the four arms on the parity row, first without a process
    group, then under a single-rank NCCL group, where each arm wraps the
    model; per-step losses agree, K1-K3 launch what the arm issues. Phase
    15 runs inside the group."""
    import torch.distributed as dist

    run_benchmark, build_run, DATASET_SIZE = loop.run_benchmark, loop.build_run, loop.DATASET_SIZE
    phase_remat(fa, models)
    steps = WARMUP_STEPS + TIMED_STEPS
    runs = {}
    for grouped in (False, True):
        if grouped:
            assert rt.setup_distributed(num_processes=1, process_id=0, master_port=free_port())
            assert dist.is_initialized() and dist.get_backend() == "nccl"
            assert dist.get_world_size() == 1
        for arm in ARMS:
            mesh = make_mesh()
            assert (mesh.device_mesh is not None) == grouped
            cfg = models.get_config("tinygpt", "A", 2048, attention_impl="flash")
            remat = memory.resolve_auto_remat(
                cfg, get_strategy(arm), mesh, ARM_ROW["per_device_batch"], 2048,
                DATASET_SIZE, torch.cuda.get_device_name(0)).remat
            fa.reset_launch_counts()
            losses = []
            res = run_benchmark(
                strategy=arm, tier="A", seq_len=2048, model_family=ARM_ROW["model_family"],
                steps=steps, warmup_steps=WARMUP_STEPS,
                per_device_batch=ARM_ROW["per_device_batch"],
                grad_accum=ARM_ROW["grad_accum"], attention_impl="flash", sync_every=5,
                device="cuda", loss_log=losses)
            counts = fa.launch_counts()
            micro = ARM_ROW["layers"] * ARM_ROW["grad_accum"] * steps
            want = {"flash_fwd": micro * (1 if remat == "none" else 2),
                    "flash_bwd_dq": micro, "flash_bwd_dkv": micro}
            log(f"[12] {arm} {'single-rank NCCL group' if grouped else 'no group'}: remat "
                f"{remat}, world_size {res.world_size}, {res.tokens_per_sec:.1f} tok/s, step "
                f"{1e3 * res.mean_step_time_sec:.2f} ms, MFU {res.mfu_pct:.2f}%, peak "
                f"{res.peak_hbm_gb:.2f} GB ({res.peak_hbm_method}), loss first "
                f"{res.loss_first_window:.4f} last {res.loss_last_window:.4f}, launches {counts}")
            assert res.world_size == 1 and len(losses) == steps
            assert all(math.isfinite(x) for x in losses)
            assert res.loss_last_window < res.loss_first_window, f"{arm}: loss did not fall"
            assert counts == want, f"{arm}: launches {counts}, want {want}"
            runs[arm, grouped] = dict(res=res, losses=losses, remat=remat, launches=counts)
            gc.collect()
            torch.cuda.empty_cache()
        if grouped:
            # What each arm laid out under the group (no fallback to the plain model).
            for arm in ARMS:
                run = build_run(strategy=arm, tier="S", seq_len=256, device="cuda")
                inner = getattr(run.model, "module", run.model)
                kinds = {type(p).__name__ for p in inner.parameters()}
                opt = type(run.step_fn.optimizer).__name__
                buckets = getattr(run.step_fn.optimizer, "buckets", [])
                log(f"[12] {arm} under the group: model {type(run.model).__name__}, params "
                    f"{sorted(kinds)}, optimizer {opt}"
                    + (f", {len(buckets)} reduce-scatter buckets (one per block and one for "
                       "the leaves outside them)" if buckets else ""))
                assert {"ddp": isinstance(run.model, torch.nn.parallel.DistributedDataParallel),
                        "fsdp": kinds == {"DTensor"}, "zero3": kinds == {"DTensor"},
                        "zero2": opt == "_Zero2Optimizer"}[arm], f"{arm}: not laid out"
                del run
                gc.collect()
            phase_group_forms(fa, ra, ua, run_benchmark, runs["zero2", False]["losses"])
            gc.collect()
            torch.cuda.empty_cache()
            rt.cleanup_distributed()
            assert not dist.is_initialized()
    out = {}
    for arm in ARMS:
        plain, group = runs[arm, False], runs[arm, True]
        rel = max(abs(a - b) / abs(b) for a, b in zip(group["losses"], plain["losses"]))
        log(f"[12] {arm}: per-step loss, group vs no group, max relative difference "
            f"{rel:.2e} (limit {ARM_LOSS_RTOL}); tok/s {plain['res'].tokens_per_sec:.1f} -> "
            f"{group['res'].tokens_per_sec:.1f}, peak {plain['res'].peak_hbm_gb:.2f} -> "
            f"{group['res'].peak_hbm_gb:.2f} GB")
        assert rel <= ARM_LOSS_RTOL, f"{arm}: group vs no-group loss differs by {rel}"
        out[arm] = dict(plain=plain, group=group, loss_rel=rel)
    return out


# Phase 16 (a): whole layers at B 2 cut into head shards. "parity" at tp 2
# is (t), one rank's attention in the tp-2 parity row.
TP_SHAPES = {
    "parity": dict(B=2, H=16, Hkv=16, S=2048, D=64, causal=False, rate=0.1, tps=(2, 4)),
    "flagship": dict(B=2, H=8, Hkv=4, S=2048, D=128, causal=True, rate=0.0, tps=(2, 8)),
}
# The ring at (d)'s geometry, B 2, over tp 2.
TP_RING = dict(B=2, H=16, S=8192, n=4, D=64, rate=0.1, tp=2)
# Phase 16 (b): the bench rows at tensor_parallel 2 in two processes.
TP_ROWS = {
    "parity": dict(model_family="tinygpt", per_device_batch=1, grad_accum=4, layers=16),
    "flagship": dict(model_family="llama", per_device_batch=2, grad_accum=2, layers=16),
}
TP_ARMS = ("ddp", "zero2")
TP_STEPS, TP_WARMUP, TP_WIDTH = 3, 1, 2
# Largest relative difference allowed between a step's loss at tp 2 and on
# one card without a group (same seeds and masks; bf16, where the tp path
# sums each row-parallel product's fp32 halves over the group before
# rounding, and the loss is the vocab-parallel one).
TP_LOSS_RTOL = 5e-3


def head_rows(B: int, H: int, m: int, Hl: int) -> torch.Tensor:
    """Rows of a (B*H, S, Dh) layer that ``model`` rank m holds at H/Hl ranks."""
    return torch.cat([torch.arange(b * H + m * Hl, b * H + (m + 1) * Hl)
                      for b in range(B)]).cuda()


def tp_layer_inputs(sh, seed: int = 16):
    """q, do (B*H, S, Dh) and k, v from Hkv heads repeated to the H query
    heads (the model's consecutive-block repeat), bf16 on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, Hkv, S, D = sh["B"], sh["H"], sh["Hkv"], sh["S"], sh["D"]

    def randn(heads):
        return torch.randn(B * heads, S, D, device="cuda", generator=g).to(torch.bfloat16)

    q, do = randn(H), randn(H)
    k, v = (randn(Hkv).view(B, Hkv, S, D).repeat_interleave(H // Hkv, dim=1)
            .reshape(B * H, S, D).contiguous() for _ in range(2))
    return q, k, v, do


def phase_tp_kernels(fa, ra, peaks):
    """Phase 16 (a): head shards of K1-K3 and of the ring against the whole
    layer's rows, and K1's bhv instance timed."""
    seed = 0x2545F491
    timing = {}
    for key, sh in TP_SHAPES.items():
        B, H, c, r = sh["B"], sh["H"], sh["causal"], sh["rate"]
        q, k, v, do = tp_layer_inputs(sh)
        out, lse = fa.flash_fwd(q, k, v, c, r, seed)
        delta = fa.attention_delta(out, do)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, c, r, seed)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, c, r, seed)
        for tp in sh["tps"]:
            Hl, worst = H // tp, {}
            for m in range(tp):
                rows = head_rows(B, H, m, Hl)
                bhv = fa._global_bh_vec(B, Hl, 0, m * Hl, H, "cuda")
                qs, ks, vs, dos = (t[rows].contiguous() for t in (q, k, v, do))
                fa.reset_launch_counts()
                o, l = fa.flash_fwd(qs, ks, vs, c, r, seed, bhv=bhv)
                args = (qs, ks, vs, dos, l, delta[rows].contiguous(), c, r, seed)
                sdq = fa.flash_bwd_dq(*args, bhv=bhv)
                sdk, sdv = fa.flash_bwd_dkv(*args, bhv=bhv)
                counts = fa.head_shard_launch_counts()
                assert counts == {"flash_fwd_bhv": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}, \
                    f"({key}) tp {tp}: launches {counts}"
                for nm, a, b in (("out", o, out), ("lse", l, lse), ("dq", sdq, dq),
                                 ("dk", sdk, dk), ("dv", sdv, dv)):
                    assert torch.equal(a, b[rows]), f"({key}) tp {tp} rank {m}: {nm} is not " \
                                                    "the whole layer's rows"
                po, pl = fa.flash_forward_plain(qs, ks, vs, c, r, seed, bhv=bhv)
                pargs = (qs, ks, vs, dos, pl, fa.attention_delta(po, dos), c, r, seed)
                pdq = fa.flash_bwd_dq_plain(*pargs, bhv=bhv)
                pdk, pdv = fa.flash_bwd_dkv_plain(*pargs, bhv=bhv)
                errs = {"out": rel_err(o, po), "dq": rel_err(sdq, pdq), "dk": rel_err(sdk, pdk),
                        "dv": rel_err(sdv, pdv)}
                for nm, e in errs.items():
                    assert e <= 2e-2, f"({key}) tp {tp} rank {m}: {nm} rel error {e} > 2e-2"
                    worst[nm] = max(worst.get(nm, 0.0), e)
                lse_err = max_abs(l, pl)
                assert lse_err <= 1e-3, f"({key}) tp {tp} rank {m}: lse error {lse_err}"
                worst["lse max abs"] = max(worst.get("lse max abs", 0.0), lse_err)
                if key == "parity" and tp == TP_WIDTH and m == 1:
                    timing["parity"] = dict(inputs=(qs, ks, vs, bhv), max_abs_err=max(
                        max_abs(o, po), lse_err))
                if key == "flagship" and tp == TP_WIDTH and m == 1:
                    timing["flagship"] = dict(inputs=(qs, ks, vs, bhv), max_abs_err=max(
                        max_abs(o, po), lse_err))
            log(f"[16] ({key}) B {B} x {H} heads (kv {sh['Hkv']}) Dh {sh['D']} causal {c} rate "
                f"{r} over tp {tp}: every shard's K1 (bhv) / K2 / K3 == the whole layer's rows "
                f"bit for bit (out, lse, dq, dk, dv); vs plain, worst " + json.dumps(
                    {nm: f"{e:.2e}" for nm, e in worst.items()}))
        del q, k, v, do, out, lse, dq, dk, dv
        torch.cuda.empty_cache()
    # The ring at (d)'s geometry, B 2: each head shard with its offset.
    sh = TP_RING
    g = torch.Generator(device="cuda").manual_seed(17)
    B, H, S, D = sh["B"], sh["H"], sh["S"], sh["D"]
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    kw = dict(dropout_rate=sh["rate"], dropout_seed=seed, seq_shards=sh["n"])
    whole = fwd_bwd(lambda a, b, d: ra.ring_attention(a, b, d, **kw), q, k, v, do)
    Hl = H // sh["tp"]
    for m in range(sh["tp"]):
        heads = slice(m * Hl, (m + 1) * Hl)
        part = fwd_bwd(lambda a, b, d: ra.ring_attention(a, b, d, head_offset=m * Hl,
                                                         n_heads=H, **kw),
                       *(t[:, :, heads].contiguous() for t in (q, k, v, do)))
        for nm, a, b in zip(("out", "dq", "dk", "dv"), part, whole):
            assert torch.equal(a, b[:, :, heads]), f"ring tp rank {m}: {nm} differs"
    log(f"[16] ring B {B} x {H} heads S {S} over {sh['n']} shards Dh {D} rate {sh['rate']} "
        f"over tp {sh['tp']}: each head shard (head offset, global ids) == the whole ring's "
        "rows bit for bit (out, dq, dk, dv)")
    del q, k, v, do, whole, part
    torch.cuda.empty_cache()
    # K1's bhv instance at (t) and at the flagship's shard, as in phase 2.
    out = {}
    for key, t in timing.items():
        sh = TP_SHAPES[key]
        qs, ks, vs, bhv = t["inputs"]
        c, r = sh["causal"], sh["rate"]
        shape = dict(BH=qs.shape[0], S=sh["S"], D=sh["D"], causal=c, rate=r)
        kern = lambda: fa.flash_fwd(qs, ks, vs, c, r, seed, bhv=bhv)  # noqa: E731
        res = dict(max_abs_err=t["max_abs_err"], ms=median_ms(kern),
                   device_ms=median_ms(kern, device_clock=True),
                   offset_instance_device_ms=median_ms(
                       lambda: fa.flash_fwd(qs, ks, vs, c, r, seed, 8), device_clock=True),
                   plain_ms=median_ms(lambda: fa.flash_forward_plain(qs, ks, vs, c, r, seed,
                                                                     bhv=bhv),
                                      warmup=2, reps=20))
        res["bound_ms"], res["bound_by"] = bound("fwd", shape, peaks)
        q4, k4, v4 = (x.unsqueeze(0) for x in (qs, ks, vs))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["library_ms"] = median_ms(lambda: sdpa(q4, k4, v4, is_causal=c))
        res["library_device_ms"] = median_ms(lambda: sdpa(q4, k4, v4, is_causal=c),
                                             device_clock=True)
        res["shape"] = shape
        log(f"[16] ({key}) K1 bhv instance BH {shape['BH']} S {shape['S']} Dh {shape['D']} "
            f"causal {c} rate {r} (ms, median of 25): " + json.dumps(
                {n: (round(x, 5) if isinstance(x, float) else x) for n, x in res.items()
                 if n != "shape"}))
        out[key] = res
    del timing
    torch.cuda.empty_cache()
    return out


def tp_worker(rank: int, port: int, outdir: str) -> int:
    """Phase 16 (b), one rank: ``chip_smoke.py --tp-worker RANK PORT DIR``."""
    from distributed_llm_training_benchmark_framework_tpu_torch import models
    from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as fa
    from distributed_llm_training_benchmark_framework_tpu_torch.parallel import get_strategy
    from distributed_llm_training_benchmark_framework_tpu_torch.parallel.mesh import Mesh
    from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt
    from distributed_llm_training_benchmark_framework_tpu_torch.train import loop
    from distributed_llm_training_benchmark_framework_tpu_torch.utils import memory

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert rt.setup_distributed(num_processes=TP_WIDTH, process_id=rank, master_port=port,
                                device="cuda", backend="gloo")
    out = {}
    try:
        for row, spec in TP_ROWS.items():
            for arm in TP_ARMS:
                fa.reset_launch_counts()
                losses = []
                res = loop.run_benchmark(
                    strategy=arm, tier="A", seq_len=2048, model_family=spec["model_family"],
                    steps=TP_STEPS, warmup_steps=TP_WARMUP,
                    per_device_batch=spec["per_device_batch"], grad_accum=spec["grad_accum"],
                    attention_impl="flash", sync_every=5, device="cuda", loss_log=losses,
                    tensor_parallel=TP_WIDTH)
                counts = {**fa.head_shard_launch_counts(),
                          "flash_fwd": fa.launch_counts()["flash_fwd"]}
                peak = torch.cuda.max_memory_allocated() / 1e9
                cfg = models.get_config(spec["model_family"], "A", 2048, attention_impl="flash")
                est = memory.estimate_hbm(cfg, get_strategy(arm), Mesh({"data": 1,
                                                                        "model": TP_WIDTH}),
                                          spec["per_device_batch"], 2048, loop.DATASET_SIZE)
                out[f"{row}.{arm}"] = dict(
                    losses=losses, launches=counts, peak_gb=peak, estimate_gb=est.total / 1e9,
                    tokens_per_sec=res.tokens_per_sec, world_size=res.world_size,
                    tensor_parallel=res.tensor_parallel, n_params=res.n_params)
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        rt.cleanup_distributed()
    with open(os.path.join(outdir, f"tp.rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def phase_tp_train(no_group_losses: dict) -> dict:
    """Phase 16 (b): two ranks of tensor_parallel 2 on the one card over
    gloo, both rows, ddp and zero2, against the no-group run's losses."""
    outdir = tempfile.mkdtemp(prefix="tp_smoke_")
    env = dict(os.environ, LOCAL_RANK="0",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-worker",
                               str(r), str(port), outdir], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(TP_WIDTH)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"tp rank {r} exited {p.returncode}:\n{text[-4000:]}"
    ranks = [json.load(open(os.path.join(outdir, f"tp.rank{r}.json")))
             for r in range(TP_WIDTH)]
    launches = {}
    for label, run in ranks[0].items():
        row, arm = label.split(".")
        spec = TP_ROWS[row]
        want = spec["layers"] * spec["grad_accum"] * TP_STEPS
        base = no_group_losses[row, arm][:TP_STEPS]
        rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], base))
        peaks = [f"{rk[label]['peak_gb']:.2f}" for rk in ranks]
        log(f"[16] {row} {arm} at tensor_parallel {TP_WIDTH} (two ranks on one card over "
            f"gloo): world_size {run['world_size']}, {run['tokens_per_sec']:.1f} tok/s, "
            f"losses {[round(x, 5) for x in run['losses']]}, max relative difference to the "
            f"no-group run {rel:.2e} (limit {TP_LOSS_RTOL}), peak per rank {peaks} GB, "
            f"estimate_hbm per rank {run['estimate_gb']:.2f} GB, launches per rank "
            f"{run['launches']} (want {want} each, flash_fwd 0)")
        assert all(math.isfinite(x) for x in run["losses"]) and len(run["losses"]) == TP_STEPS
        assert all(rk[label]["losses"] == run["losses"] for rk in ranks), f"{label}: ranks differ"
        assert rel <= TP_LOSS_RTOL, f"{label}: tp-2 loss differs from one card's by {rel}"
        assert run["launches"] == {"flash_fwd_bhv": want, "flash_bwd_dq": want,
                                   "flash_bwd_dkv": want, "flash_fwd": 0}, \
            f"{label}: launches {run['launches']}"
        assert (run["world_size"], run["tensor_parallel"]) == (TP_WIDTH, TP_WIDTH)
        launches[label] = run["launches"]["flash_fwd_bhv"]
    return launches


def no_group_ddp_flagship(run_benchmark) -> list:
    """The flagship row without a group under ddp (bare AdamW), TP_STEPS
    steps: phase 16 (b)'s baseline for its ddp flagship run."""
    losses = []
    spec = TP_ROWS["flagship"]
    run_benchmark(strategy="ddp", tier="A", seq_len=2048, model_family=spec["model_family"],
                  steps=TP_STEPS, warmup_steps=TP_WARMUP,
                  per_device_batch=spec["per_device_batch"], grad_accum=spec["grad_accum"],
                  attention_impl="flash", sync_every=5, device="cuda", loss_log=losses)
    torch.cuda.empty_cache()
    return losses


# Phase 17: the host-offload arm. Masters of the host update against its
# plain version on the card: the same inputs through fused CPU AdamW and
# CUDA AdamW differ by a few fp32 roundings of the master (2^-21: four
# ulps) and of the update (2^-20 of lr 1e-4).
MASTER_RTOL, MASTER_ATOL = 2 ** -21, 2 ** -20 * 1e-4
# Per-step losses of two runs whose masters differ by that much: their bf16
# compute copies differ where a master sits on a rounding boundary.
OFFLOAD_LOSS_RTOL = 1e-4
OFFLOAD_WAYS = {
    "bf16": dict(param_dtype="bf16"),
    "offload serial": dict(offload_opt_state=True),
    "offload delayed": dict(offload_opt_state=True, offload_delayed_update=True),
}
TIER_B = dict(tier="B", seq_len=1024, layers=32, warmup=2, timed=4)
TIER_B_WAYS = {  # way: (strategy change, grad accum)
    "f32": ({}, 4), "bf16": (dict(param_dtype="bf16"), 4),
    "offload serial": (dict(offload_opt_state=True), 4),
    "offload delayed": (dict(offload_opt_state=True, offload_delayed_update=True), 16),
}
# Host bytes per parameter of the offload state (parallel/offload.py): fp32
# masters, gradient upcast and two moments, bf16 slot and upload buffer.
HOST_BYTES_PER_PARAM = 4 * 4 + 2 * 2


def mem_available_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def pinned_need_gb(n: int) -> float:
    """Host bytes of the offload state of n parameters once pinned: the
    pinned allocator rounds each flat buffer up to a power of two."""
    pow2 = lambda b: 1 << (b - 1).bit_length()
    return (4 * pow2(4 * n) + 2 * pow2(2 * n)) / 1e9


class DeviceMasters:
    """The host update's plain version, run by this script only: fp32
    masters and ``torch.optim.AdamW`` on the card, JAX's ``host_math`` on
    the same gradients and scale (``HostOffload``'s interface: ``begin_step``,
    ``step``). ``delayed``: update t takes step t-1's gradients and scale,
    update 0 zeros. ``write``: copy bf16(masters) into the parameters (the
    arm's own run); off, it only follows the host arm (lockstep)."""

    def __init__(self, host, strategy, delayed: bool, write: bool):
        self.tensors, self.schedule, self.clip = host.tensors, host.schedule, host.clip
        self.sizes = [t.numel() for t in host.tensors]
        self.master = host.master.to("cuda", copy=True)
        self.master.grad = torch.zeros_like(self.master)
        self.adamw = torch.optim.AdamW([self.master], lr=strategy.learning_rate,
                                       betas=strategy.betas, eps=strategy.eps,
                                       weight_decay=strategy.weight_decay)
        self.count, self.delayed, self.write = 0, delayed, write
        self.pending = torch.zeros(self.master.numel(), dtype=torch.bfloat16, device="cuda")
        self.pending_scale = torch.zeros((), device="cuda")

    def begin_step(self) -> None:
        pass

    @torch.no_grad()
    def step(self, grads, scale) -> None:
        g = torch.cat([x.reshape(-1) for x in grads])
        if self.delayed:
            (g, self.pending), (scale, self.pending_scale) = (
                (self.pending, g), (self.pending_scale, scale))
        self.master.grad.copy_(g)
        if self.clip:
            self.master.grad.mul_(scale)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        if self.write:
            for t, v in zip(self.tensors, torch.split(self.master, self.sizes)):
                t.view(-1).copy_(v)


def _timed(values, n):
    return statistics.median(values[-n:]) if values else float("nan")


def offload_line(stats: dict, timed: int) -> tuple[str, dict]:
    """The host arm's per-step numbers (medians over the timed steps)."""
    d2h, h2d = _timed(stats["d2h_ms"], timed), _timed(stats["h2d_ms"], timed)
    out = {
        "host_update_ms": _timed(stats["host_update_ms"], timed),
        "wait_ms": _timed(stats["wait_ms"], timed) if stats["wait_ms"] else None,
        "d2h_ms": d2h, "d2h_gbps": stats["d2h_bytes"] / d2h / 1e6,
        "h2d_ms": h2d, "h2d_gbps": stats["h2d_bytes"] / h2d / 1e6,
        "d2h_gb": stats["d2h_bytes"] / 1e9, "pinned_gb": stats["host_bytes"] / 1e9,
        "pinned": stats["pinned"], "cpu_count": stats["cpu_count"],
        "threads": stats["threads"], "mem_available_gb": mem_available_gb(),
    }
    assert stats["pinned"], "host offload state not pinned"
    wait = f", step waited {out['wait_ms']:.2f} ms for the worker" if out["wait_ms"] else ""
    return (f"host update {out['host_update_ms']:.2f} ms{wait}; D2H {d2h:.2f} ms "
            f"({out['d2h_gbps']:.2f} GB/s over {out['d2h_gb']:.3f} GB), H2D {h2d:.2f} ms "
            f"({out['h2d_gbps']:.2f} GB/s); pinned host {out['pinned_gb']:.2f} GB; "
            f"{out['cpu_count']} cores, {out['threads']} intra-op threads, MemAvailable "
            f"{out['mem_available_gb']:.1f} GB"), out


def offload_run(fa, loop, memory, models, get_strategy, param_torch_dtype, label, *, change,
                tier, seq_len, arm, accum, layers, warmup, timed, base=None):
    """One row of phase 17 (a) / (b) through run_benchmark."""
    strategy = dataclasses.replace(get_strategy(arm), **change)
    steps = warmup + timed
    cfg = models.get_config("tinygpt", tier, seq_len, attention_impl="flash",
                            param_dtype=param_torch_dtype(strategy))
    resolved = memory.resolve_auto_remat(cfg, strategy, None, 1, seq_len, loop.DATASET_SIZE,
                                         torch.cuda.get_device_name(0))
    est = memory.estimate_hbm(dataclasses.replace(cfg, remat=resolved.remat), resolved, None,
                              1, seq_len, loop.DATASET_SIZE)
    fa.reset_launch_counts()
    losses, stats = [], {}
    t0 = time.perf_counter()
    res = loop.run_benchmark(strategy=strategy, tier=tier, seq_len=seq_len, steps=steps,
                             warmup_steps=warmup, per_device_batch=1, grad_accum=accum,
                             attention_impl="flash", sync_every=5, device="cuda",
                             loss_log=losses, offload_log=stats)
    wall = time.perf_counter() - t0
    counts = fa.launch_counts()
    micro = layers * accum * steps
    want = {"flash_fwd": micro * (1 if resolved.remat == "none" else 2),
            "flash_bwd_dq": micro, "flash_bwd_dkv": micro}
    line = (f"[17] {label}: {res.tokens_per_sec:.1f} tok/s, step "
            f"{1e3 * res.mean_step_time_sec:.2f} ms (cv {res.step_time_cv_pct:.1f}%), MFU "
            f"{res.mfu_pct:.2f}%, peak {res.peak_hbm_gb:.2f} GB, estimate_hbm "
            f"{est.total / 1e9:.2f} GB (opt state {est.opt_state / 1e9:.2f} GB), remat "
            f"{resolved.remat}, loss first {res.loss_first_window:.4f} last "
            f"{res.loss_last_window:.4f}, launches {counts}, run {wall:.1f} s")
    if base is not None:
        line += (f"; fp32 row: {base.tokens_per_sec:.1f} tok/s, step "
                 f"{1e3 * base.mean_step_time_sec:.2f} ms, peak {base.peak_hbm_gb:.2f} GB")
    out = dict(tokens_per_sec=res.tokens_per_sec, step_ms=1e3 * res.mean_step_time_sec,
               peak_gb=res.peak_hbm_gb, estimate_gb=est.total / 1e9, remat=resolved.remat,
               losses=losses, n_params=res.n_params)
    if stats:
        text, numbers = offload_line(stats, timed)
        line += "; " + text
        out.update(numbers)
    log(line)
    assert all(math.isfinite(x) for x in losses) and len(losses) == steps
    assert res.loss_last_window < res.loss_first_window, f"{label}: loss did not fall"
    assert counts == want, f"{label}: launches {counts}, want {want}"
    assert (res.param_dtype, res.offload_opt_state, res.offload_delayed_update) == (
        strategy.param_dtype, strategy.offload_opt_state, strategy.offload_delayed_update)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def host_adamw_ms(n: int) -> dict:
    """Host AdamW over n fp32 elements, fused and foreach: median ms of 3
    steps after one."""
    out = {}
    for kind in ("fused", "foreach"):
        p = torch.zeros(n)
        p.grad = torch.full((n,), 1e-3)
        opt = torch.optim.AdamW([p], lr=1e-4, weight_decay=0.01, **{kind: True})
        opt.step()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            opt.step()
            times.append(1e3 * (time.perf_counter() - t0))
        out[kind] = statistics.median(times)
        del p, opt
    return out


def lockstep(loop, strategy, steps: int, delayed: bool):
    """Phase 17 (c) / (d): the arm at tier A (dropout 0) with its host
    update followed by ``DeviceMasters`` on the same inputs; then a run of
    ``DeviceMasters`` alone. Returns (worst master rel, worst abs, the host
    run's losses, the plain run's)."""
    kw = dict(strategy=strategy, tier="A", seq_len=2048, per_device_batch=1, grad_accum=4,
              dropout=0.0, attention_impl="flash", device="cuda")
    run = loop.build_run(**kw)
    opt = run.step_fn.optimizer
    plain = DeviceMasters(opt.host, strategy, delayed, write=False)
    host_step = opt.host.step

    def both(grads, scale):
        plain.step(grads, scale)
        host_step(grads, scale)

    opt.host.step = both
    losses, worst_rel, worst_abs = [], 0.0, 0.0
    for step in range(steps):
        losses.append(run.step_fn(run.table, step).item())
        host = opt.host.master.to("cuda")
        diff = (plain.master - host).abs()
        worst_abs = max(worst_abs, diff.max().item())
        worst_rel = max(worst_rel, (diff / host.abs().clamp_min(1e-30)).max().item())
        bad = (diff > MASTER_RTOL * host.abs() + MASTER_ATOL).sum().item()
        assert bad == 0, f"step {step}: {bad} masters beyond the limit"
    del run, opt, plain, host
    gc.collect()
    run = loop.build_run(**kw)
    opt = run.step_fn.optimizer
    opt.host = DeviceMasters(opt.host, strategy, delayed, write=True)
    plain_losses = [run.step_fn(run.table, step).item() for step in range(steps)]
    del run, opt
    gc.collect()
    torch.cuda.empty_cache()
    return worst_rel, worst_abs, losses, plain_losses


def phase_offload(fa, loop, memory, models, get_strategy, param_torch_dtype, smi,
                  fp32_parity) -> dict:
    """Phase 17: the host-offload arm and bf16 parameters on the card."""
    log(f"[17] host: {os.cpu_count()} cores, {torch.get_num_threads()} intra-op threads, "
        f"MemAvailable {mem_available_gb():.1f} GB; {smi}")
    out = {"parity": {}, "tier_b": {}}
    row = dict(tier="A", seq_len=2048, arm="zero2", accum=4, layers=16, warmup=WARMUP_STEPS,
               timed=TIMED_STEPS)
    for way, change in OFFLOAD_WAYS.items():
        out["parity"][way] = offload_run(fa, loop, memory, models, get_strategy,
                                         param_torch_dtype, f"(a) parity {way}", change=change,
                                         base=fp32_parity, **row)
    n_a = out["parity"]["offload serial"]["n_params"]
    adamw = host_adamw_ms(n_a)
    log(f"[17] (a) host AdamW over tier A's {n_a} masters: fused {adamw['fused']:.1f} ms, "
        f"foreach {adamw['foreach']:.1f} ms ({torch.get_num_threads()} threads, "
        f"{os.cpu_count()} cores; the arm runs fused); {smi}")
    out["host_adamw_ms"] = adamw
    with torch.device("meta"):
        n_b = models.count_params(models.TinyGPT(models.get_config("tinygpt", "B", 1024)))
    need, avail = pinned_need_gb(n_b), mem_available_gb()
    log(f"[17] (b) tier B: {n_b} parameters; its pinned offload state {need:.1f} GB "
        f"({HOST_BYTES_PER_PARAM} B per parameter, buffers rounded to powers of two) of "
        f"MemAvailable {avail:.1f} GB")
    assert need < 0.9 * avail, f"the host cannot hold tier B's offload state: {need} of {avail}"
    for way, (change, accum) in TIER_B_WAYS.items():
        out["tier_b"][way] = offload_run(
            fa, loop, memory, models, get_strategy, param_torch_dtype,
            f"(b) tier B zero3 S 1024 b1 x {accum} {way}", change=change, tier=TIER_B["tier"],
            seq_len=TIER_B["seq_len"], arm="zero3", accum=accum, layers=TIER_B["layers"],
            warmup=TIER_B["warmup"], timed=TIER_B["timed"])
    for key, way, steps, delayed in (("c", "offload serial", 5, False),
                                     ("d", "offload delayed", 4, True)):
        strategy = dataclasses.replace(get_strategy("zero2"), **OFFLOAD_WAYS[way])
        rel, worst, host_losses, plain_losses = lockstep(loop, strategy, steps, delayed)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(host_losses, plain_losses))
        log(f"[17] ({key}) {way} vs its plain version on the card (masters and AdamW in device "
            f"memory{', one-step lag' if delayed else ''}), tier A, dropout 0, {steps} steps: "
            f"masters in step, worst relative {rel:.2e}, worst abs {worst:.2e} (limit "
            f"{MASTER_RTOL:.2e} x |m| + {MASTER_ATOL:.2e}); losses host "
            f"{[round(x, 5) for x in host_losses]}, plain {[round(x, 5) for x in plain_losses]}, "
            f"max relative difference {loss_rel:.2e} (limit {OFFLOAD_LOSS_RTOL})")
        assert loss_rel <= OFFLOAD_LOSS_RTOL, f"({key}): losses differ by {loss_rel}"
        out[key] = dict(master_rel=rel, master_abs=worst, loss_rel=loss_rel)
    log("[17] summary: " + json.dumps(
        {k: ({w: {n: v for n, v in r.items() if n != "losses"} for w, r in v.items()}
             if k in ("parity", "tier_b") else v) for k, v in out.items()}) + f" on {smi}")
    return out


# Keys a kernel's entry in the kernels line carries where its phase measured them.
OPTIONAL_KEYS = ("library_device_ms", "library_fwd_bwd_ms", "library_note", "attention_delta_ms",
                 "attention_delta_device_ms", "pair_ms", "pair_device_ms", "rate0_ms",
                 "rate0_device_ms", "rate0_library_factor", "rate0_pair_device_ms",
                 "rate0_pair_library_factor")


# Phase 18: the MoE row, its layer, and expert parallelism over gloo.
MOE_ROW = dict(tier="A", seq_len=2048, per_device_batch=1, grad_accum=4, n_experts=8,
               layers=16, params=1_176_635_392)
MOE_LAYER = dict(N=2048, E=8, D=1024, F=4096)  # capacity(2048, 8, 2, 1.25) = 640
MOE_GRAD_TOL = 2e-2  # bf16 gradients, index vs plain (tests/test_torch_moe.py)
MOE_EP = dict(width=2, layers=4, steps=3, accum=4)
MOE_EP_RTOL = 5e-3  # JAX tests/test_moe.py: ep against one device
MOE_OVERFLOW_MAX_PCT = 60.0  # analysis/validate_results.py EXPERT_OVERFLOW_MAX_PCT


def moe_ep_config(models):
    return models.get_config("tinygpt", "A", 2048, n_experts=MOE_ROW["n_experts"],
                             n_layer=MOE_EP["layers"], dropout=0.0)


def moe_ep_losses(models, strategies, mesh, micro: int, step_mod, table) -> list:
    """zero2 on the 4-layer MoE model at the row's width, seed 0."""
    dev = torch.device("cuda")
    with dev:
        model = models.TinyGPT(moe_ep_config(models), mesh=mesh)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    model, opt = strategies.apply_strategy(model, strategies.get_strategy("zero2"), mesh)
    step_fn = step_mod.TrainStep(model, opt, grad_accum=MOE_EP["accum"], micro_batch=micro,
                                 seed=0, device=dev, mesh=mesh)
    return [step_fn(table, step).item() for step in range(MOE_EP["steps"])]


def moe_worker(rank: int, port: int, outdir: str) -> int:
    """Phase 18 (c), one rank: ``chip_smoke.py --moe-worker RANK PORT DIR``."""
    import torch.distributed as dist

    from distributed_llm_training_benchmark_framework_tpu_torch import models
    from distributed_llm_training_benchmark_framework_tpu_torch.data import SyntheticDataset
    from distributed_llm_training_benchmark_framework_tpu_torch.models import moe
    from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
    from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies
    from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt
    from distributed_llm_training_benchmark_framework_tpu_torch.train import step as step_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ep = MOE_EP["width"]
    assert rt.setup_distributed(num_processes=ep, process_id=rank, master_port=port,
                                device="cuda", backend="gloo")
    out = {}
    try:
        # Does gloo take all_to_all_single on CUDA tensors? Each rank sends
        # block j to rank j; rank r must receive j's block r.
        x = torch.arange(ep * 4, device="cuda", dtype=torch.float32) + 100 * rank
        y = torch.empty_like(x)
        try:
            dist.all_to_all_single(y, x)
            torch.cuda.synchronize()
        except RuntimeError as e:
            out["a2a_error"] = str(e).splitlines()[0]
        else:
            want = torch.cat([torch.arange(rank * 4, rank * 4 + 4, device="cuda",
                                           dtype=torch.float32) + 100 * j for j in range(ep)])
            out["a2a_ok"] = bool(torch.equal(y, want))
        if out.get("a2a_ok"):
            mesh = make_mesh((ep,), ("expert",))
            cfg = moe_ep_config(models)
            table = SyntheticDataset(cfg.vocab_size, 2048, 1000, 42).to_device("cuda")
            out["losses"] = moe_ep_losses(models, strategies, mesh, 1, step_mod, table)
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            cap = moe.capacity(2048, MOE_LAYER["E"], 2, cfg.capacity_factor)
            buf = torch.zeros(MOE_LAYER["E"] * cap * MOE_LAYER["D"], device="cuda",
                              dtype=torch.bfloat16)
            group = mesh.expert_group

            def hop():
                moe._AllToAll.apply(buf, group)

            out["a2a_gloo_ms"] = median_ms(hop, warmup=2, reps=5)
            out["a2a_bytes"] = buf.numel() * buf.element_size()
    finally:
        rt.cleanup_distributed()
    with open(os.path.join(outdir, f"moe.rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def moe_layer_inputs(seed: int = 18):
    """The row's layer (B 1, S 2048, bf16 stream) with the JAX init's
    scales: router and expert weights normal(0, 0.02), biases 0.02 too (so
    that they are exercised)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    N, E, D, F = (MOE_LAYER[k] for k in ("N", "E", "D", "F"))

    def rnd(*shape, scale=0.02):
        return (scale * torch.randn(*shape, device="cuda", generator=g)).requires_grad_()

    x = torch.randn(1, N, D, device="cuda", generator=g).to(torch.bfloat16).requires_grad_()
    leaves = dict(router=rnd(D, E), moe_w1=rnd(E, D, F), moe_b1=rnd(E, F), moe_w2=rnd(E, F, D),
                  moe_b2=rnd(E, D))
    dy = torch.randn(1, N, D, device="cuda", generator=g)
    return x, leaves, dy


def phase_moe_layer(models, moe) -> dict:
    """Phase 18 (b): the index form against the plain one-hot form at the
    row's layer shape, and their times on the device clock."""
    cfg = models.get_config("tinygpt", "A", 2048, n_experts=MOE_LAYER["E"])
    cd = cfg.compute_dtype
    x, lv, dy = moe_layer_inputs()
    names = ("moe_w1", "moe_b1", "moe_w2", "moe_b2")

    def ffn(xin):
        return moe.expert_ffn(xin, *(lv[k] for k in names), cd)

    def index():
        return moe.moe_mlp(cfg, x, lv["router"], ffn)

    def plain():
        return moe.moe_mlp_plain(cfg, x, lv["router"], *(lv[k] for k in names))

    grads = {}
    outs = {}
    for label, fn in (("index", index), ("plain", plain)):
        y, aux = fn()
        (torch.sum(y.float() * dy) + aux).backward()
        outs[label] = (y.detach(), aux.detach())
        grads[label] = {k: t.grad.clone() for k, t in (("x", x), *lv.items())}
        for t in (x, *lv.values()):
            t.grad = None
    N, E = MOE_LAYER["N"], MOE_LAYER["E"]
    cap = moe.capacity(N, E, cfg.expert_top_k, cfg.capacity_factor)
    with torch.no_grad():
        r = moe.route(x.reshape(N, -1), lv["router"], cfg.expert_top_k, cap)
        dispatch, _ = moe.plain_dispatch(r, E, cap, cd)
        reached = (torch.nn.functional.one_hot(r.expert_idx, E) * r.keep[..., None]).sum(1) > 0
        same_experts = bool(torch.equal(dispatch.sum(-1) > 0, reached))
    y_equal = bool(torch.equal(outs["index"][0], outs["plain"][0]))
    grad_err = {k: max_abs(grads["index"][k], grads["plain"][k])
                / grads["plain"][k].abs().max().item() for k in grads["plain"]}
    log(f"[18] (b) index vs plain dispatch at N {N} E {E} C {cap} D {MOE_LAYER['D']} F "
        f"{MOE_LAYER['F']} bf16: experts reached equal {same_experts}, kept "
        f"{int(r.keep.sum())} of {N * cfg.expert_top_k} assignments (drop "
        f"{r.drop_frac.item():.4f}), output bit for bit {y_equal}, aux "
        f"{outs['index'][1].item():.6f} vs {outs['plain'][1].item():.6f}, gradients' max |diff| "
        f"/ max |plain| {json.dumps({k: float(f'{v:.3e}') for k, v in grad_err.items()})} "
        f"(limit {MOE_GRAD_TOL})")
    assert same_experts, "the index form reaches other experts than the one-hot dispatch"
    assert y_equal, "index dispatch output differs from the plain one-hot version"
    assert torch.equal(outs["index"][1], outs["plain"][1])
    assert all(v <= MOE_GRAD_TOL for v in grad_err.values()), grad_err

    def fwd_bwd(fn):
        def run():
            y, aux = fn()
            (torch.sum(y.float() * dy) + aux).backward()
        return run

    xt = x.detach().reshape(N, -1)
    router = lv["router"].detach()
    w = [lv[k].detach() for k in names]
    with torch.no_grad():
        r = moe.route(xt, router, cfg.expert_top_k, cap)
        xin = moe._dispatch(xt, r, E, cap)
        out_e = moe.expert_ffn(xin, *w, cd)
        parts = {
            "route_ms": median_ms(lambda: moe.route(xt, router, cfg.expert_top_k, cap),
                                  device_clock=True),
            "dispatch_ms": median_ms(lambda: moe._dispatch(xt, r, E, cap), device_clock=True),
            "expert_ffn_ms": median_ms(lambda: moe.expert_ffn(xin, *w, cd), device_clock=True),
            "combine_ms": median_ms(lambda: moe._combine(out_e, r, cap, cd), device_clock=True),
            "index_fwd_ms": median_ms(index, device_clock=True),
            "plain_fwd_ms": median_ms(plain, device_clock=True),
        }
    parts["index_fwd_bwd_ms"] = median_ms(fwd_bwd(index), device_clock=True)
    parts["plain_fwd_bwd_ms"] = median_ms(fwd_bwd(plain), device_clock=True)
    for t in (x, *lv.values()):
        t.grad = None
    log(f"[18] (b) device ms (one layer, one micro-batch): "
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + f"; plain / index forward {parts['plain_fwd_ms'] / parts['index_fwd_ms']:.2f}x, "
          f"forward + backward {parts['plain_fwd_bwd_ms'] / parts['index_fwd_bwd_ms']:.2f}x")
    return dict(parts, same_experts=same_experts, y_equal=y_equal, grad_err=grad_err,
                drop_frac=r.drop_frac.item())


def phase_moe_ep(models, strategies, step_mod, SyntheticDataset, make_mesh) -> dict:
    """Phase 18 (c): expert_parallel 2 as two gloo ranks on the one card
    against one process's run of the same global batch."""
    outdir = tempfile.mkdtemp(prefix="moe_smoke_")
    env = dict(os.environ, LOCAL_RANK="0",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    port = free_port()
    ep = MOE_EP["width"]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--moe-worker",
                               str(r), str(port), outdir], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(ep)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"moe rank {r} exited {p.returncode}:\n{text[-4000:]}"
    ranks = [json.load(open(os.path.join(outdir, f"moe.rank{r}.json"))) for r in range(ep)]
    run = ranks[0]
    if "a2a_error" in run:
        # gloo has no all_to_all for CUDA tensors here: the leg cannot run.
        # Only that refusal is accepted; anything else fails above.
        assert "alltoall" in run["a2a_error"].lower() or "all_to_all" in run[
            "a2a_error"].lower(), run["a2a_error"]
        log(f"[18] (c) NOT RUN: gloo refuses all_to_all_single on CUDA tensors: "
            f"{run['a2a_error']}")
        return {"ran": False, "error": run["a2a_error"]}
    assert all(rk["a2a_ok"] for rk in ranks), "gloo's all_to_all_single moved the wrong blocks"
    cfg = moe_ep_config(models)
    table = SyntheticDataset(cfg.vocab_size, 2048, 1000, 42).to_device("cuda")
    base = moe_ep_losses(models, strategies, make_mesh(), ep, step_mod, table)
    rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], base))
    log(f"[18] (c) expert_parallel {ep} over gloo on one card ({MOE_EP['layers']} layers at the "
        f"row's width, zero2, dropout 0): losses {[round(v, 5) for v in run['losses']]}, one "
        f"process {[round(v, 5) for v in base]}, max relative difference {rel:.2e} (limit "
        f"{MOE_EP_RTOL}); peak per rank {[round(rk['peak_gb'], 2) for rk in ranks]} GB; "
        f"all-to-all of {run['a2a_bytes'] / 1e6:.2f} MB over gloo (host-staged) "
        f"{run['a2a_gloo_ms']:.3f} ms")
    assert all(rk["losses"] == run["losses"] for rk in ranks), "ranks' losses differ"
    assert all(math.isfinite(v) for v in run["losses"])
    assert rel <= MOE_EP_RTOL, f"ep {ep} loss differs from one process's by {rel}"
    return {"ran": True, "loss_rel": rel, "a2a_gloo_ms": run["a2a_gloo_ms"]}


def phase_moe(fa, loop, memory, models, get_strategy, make_mesh, smi) -> dict:
    """Phase 18 (a)-(c)."""
    from distributed_llm_training_benchmark_framework_tpu_torch.data import SyntheticDataset
    from distributed_llm_training_benchmark_framework_tpu_torch.models import moe
    from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies
    from distributed_llm_training_benchmark_framework_tpu_torch.train import step as step_mod

    steps = WARMUP_STEPS + TIMED_STEPS
    micro = MOE_ROW["layers"] * MOE_ROW["grad_accum"] * steps
    rows = {}
    for label, change in (("f32", {}), ("bf16", {"param_dtype": "bf16"})):
        strat = dataclasses.replace(get_strategy("zero2"), **change)
        fa.reset_launch_counts()
        losses = []
        res = loop.run_benchmark(
            strategy=strat, tier=MOE_ROW["tier"], seq_len=MOE_ROW["seq_len"], steps=steps,
            warmup_steps=WARMUP_STEPS, per_device_batch=MOE_ROW["per_device_batch"],
            grad_accum=MOE_ROW["grad_accum"], attention_impl="flash", sync_every=5,
            device="cuda", loss_log=losses, n_experts=MOE_ROW["n_experts"])
        counts = fa.launch_counts()
        cfg = models.get_config("tinygpt", "A", 2048, attention_impl="flash",
                                n_experts=MOE_ROW["n_experts"],
                                param_dtype=strategies.param_torch_dtype(strat))
        est = memory.estimate_hbm(cfg, strat, make_mesh(), MOE_ROW["per_device_batch"], 2048,
                                  loop.DATASET_SIZE)
        # The overflow diagnostic's dropout-free forward after the timed
        # steps launches K1 once more per layer.
        want = {"flash_fwd": micro + MOE_ROW["layers"], "flash_bwd_dq": micro,
                "flash_bwd_dkv": micro}
        log(f"[18] (a) MoE row {label} parameters (E {MOE_ROW['n_experts']} top-2, capacity "
            f"1.25, zero2, S 2048, b1 x accum 4): {res.tokens_per_sec:.1f} tok/s, step "
            f"{1e3 * res.mean_step_time_sec:.2f} ms (p50 {1e3 * res.step_time_p50_sec:.2f}), "
            f"MFU {res.mfu_pct:.2f}% ({res.flops_per_token / 1e9:.3f} GFLOP/token), peak "
            f"{res.peak_hbm_gb:.2f} GB (estimate_hbm {est.total / 1e9:.2f} GB), n_params "
            f"{res.n_params}, expert_overflow_pct {res.expert_overflow_pct}, loss first "
            f"{res.loss_first_window:.4f} last {res.loss_last_window:.4f}, launches {counts} "
            f"on {smi}")
        assert res.n_params == MOE_ROW["params"], res.n_params
        assert all(math.isfinite(v) for v in losses) and len(losses) == steps
        assert res.loss_last_window < res.loss_first_window, f"MoE {label}: loss did not fall"
        assert counts == want, f"MoE {label}: launches {counts}, want {want}"
        assert 0.0 <= res.expert_overflow_pct <= MOE_OVERFLOW_MAX_PCT, res.expert_overflow_pct
        assert (res.n_experts, res.expert_parallel) == (MOE_ROW["n_experts"], 1)
        rows[label] = dict(tokens_per_sec=res.tokens_per_sec, step_ms=1e3 * res.mean_step_time_sec,
                           mfu_pct=res.mfu_pct, peak_gb=res.peak_hbm_gb,
                           estimate_gb=est.total / 1e9,
                           expert_overflow_pct=res.expert_overflow_pct, launches=counts)
        gc.collect()
        torch.cuda.empty_cache()
    layer = phase_moe_layer(models, moe)
    gc.collect()
    torch.cuda.empty_cache()
    ep = phase_moe_ep(models, strategies, step_mod, SyntheticDataset, make_mesh)
    summary = {"rows": rows, "layer": {k: v for k, v in layer.items() if k != "grad_err"},
               "ep": ep}
    log(f"[18] summary {json.dumps(summary)} on {smi}")
    return summary


PIPE = dict(width=2, tier="A", seq_len=2048, per_device_batch=1, grad_accum=4, layers=16,
            virtual=2, dropout=0.1)
PIPE_SCHEDULES = ("gpipe", "1f1b", "interleaved")
PIPE_WARMUP, PIPE_TIMED = 2, 4  # per schedule
PIPE_VS_ONE_STEPS = 3
# JAX's schedule-against-schedule tests hold the losses to 2e-3 (its
# tests/test_pipeline.py); the schedules here draw the same masks and differ
# only in the order their bf16 stages' fp32 gradients are summed.
PIPE_LOSS_RTOL = 2e-3
# pp 2 against one process at dropout 0: phase 12's group / no-group limit
# (JAX allows 2e-3 for pp against ddp).
PIPE_VS_ONE_RTOL = 1e-3
# K1, K2, K3 launches per step on (stage 0, stage 1) at L 16, P 2, M 4: the
# forward once per layer and microbatch (M * L / P = 32), again in the
# 1f1b recompute; interleaved stage 1 holds chunks 1 and 3 and position 3
# runs no F unit (16 + 32).
PIPE_LAUNCHES = {
    "gpipe": ((32, 32, 32), (32, 32, 32)),
    "1f1b": ((64, 32, 32), (64, 32, 32)),
    "interleaved": ((64, 32, 32), (48, 32, 32)),
}
PIPE_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def pipe_probe(rank: int, port: int, outdir: str) -> int:
    """Phase 19's probe, one rank: ``chip_smoke.py --pipe-probe RANK PORT
    DIR``: does gloo's ``send`` / ``recv`` take a CUDA tensor?"""
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    x = torch.full((1024,), float(rank + 1), device="cuda")
    out = {}
    try:
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(x, 0)
        torch.cuda.synchronize()
        out["ok"] = bool((x == 1.0).all())
    except RuntimeError as e:
        out["error"] = str(e).splitlines()[0]
    with open(os.path.join(outdir, f"probe.rank{rank}.json"), "w") as f:
        json.dump(out, f)
    os._exit(0)  # the peer may have torn the pair down; skip gloo's teardown


def pipe_worker(rank: int, port: int, outdir: str) -> int:
    """Phase 19, one stage: ``chip_smoke.py --pipe-worker RANK PORT DIR``."""
    from distributed_llm_training_benchmark_framework_tpu_torch import models
    from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as fa
    from distributed_llm_training_benchmark_framework_tpu_torch.parallel import get_strategy
    from distributed_llm_training_benchmark_framework_tpu_torch.parallel.mesh import Mesh
    from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt
    from distributed_llm_training_benchmark_framework_tpu_torch.train import loop
    from distributed_llm_training_benchmark_framework_tpu_torch.utils import memory

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert rt.setup_distributed(num_processes=PIPE["width"], process_id=rank, master_port=port,
                                device="cuda", backend="gloo")
    out = {}
    runs = [(sched, PIPE["dropout"], PIPE_WARMUP + PIPE_TIMED, PIPE_WARMUP)
            for sched in PIPE_SCHEDULES]
    runs.append(("gpipe_dropout0", 0.0, PIPE_VS_ONE_STEPS, 1))
    try:
        for label, dropout, n, warm in runs:
            schedule = label.split("_")[0]
            fa.reset_launch_counts()
            losses, plog = [], {}
            res = loop.run_benchmark(
                strategy="zero2", tier=PIPE["tier"], seq_len=PIPE["seq_len"], steps=n,
                warmup_steps=warm, per_device_batch=PIPE["per_device_batch"],
                grad_accum=PIPE["grad_accum"], attention_impl="flash", dropout=dropout,
                sync_every=5, device="cuda", loss_log=losses, pipeline_parallel=PIPE["width"],
                pipeline_schedule=schedule, virtual_stages=PIPE["virtual"], pipeline_log=plog)
            counts = fa.launch_counts()
            cfg = models.get_config("tinygpt", "A", PIPE["seq_len"], attention_impl="flash")
            est = memory.estimate_hbm(cfg, get_strategy("zero2"),
                                      Mesh({"data": 1, "pipe": PIPE["width"]}),
                                      PIPE["per_device_batch"], PIPE["seq_len"],
                                      loop.DATASET_SIZE)
            out[label] = dict(
                losses=losses, launches_per_step={k: counts[k] / n for k in PIPE_KERNELS},
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, estimate_gb=est.total / 1e9,
                tokens_per_sec=res.tokens_per_sec, step_ms=1e3 * res.mean_step_time_sec,
                row=[res.world_size, res.pipeline_parallel, res.pipeline_schedule,
                     res.virtual_stages], **plog)
            gc.collect()
            torch.cuda.empty_cache()
        out["parts"] = pipe_step_parts(loop)
    finally:
        rt.cleanup_distributed()
    with open(os.path.join(outdir, f"pipe.rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def pipe_step_parts(loop) -> dict:
    """Phase 19 (c), one stage: where a gpipe step of (a)'s row goes, on the
    host clock with the card synchronized around each part (which costs a
    little): the schedule, the arm's reduction with the sum of the
    replicated leaves over ``pipe`` (``finish_grads``), the optimizer step;
    and that sum alone, an all-reduce of the replicated leaves' gradients
    (wte, wpe, the final norm) over the gloo ``pipe`` group."""
    import torch.distributed as dist

    run = loop.build_run(strategy="zero2", tier=PIPE["tier"], seq_len=PIPE["seq_len"],
                         per_device_batch=PIPE["per_device_batch"],
                         grad_accum=PIPE["grad_accum"], attention_impl="flash",
                         dropout=PIPE["dropout"], device="cuda",
                         pipeline_parallel=PIPE["width"], pipeline_schedule="gpipe")
    opt, acc = run.step_fn.optimizer, {"reduce": 0.0, "step": 0.0}

    def timed(fn, key):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t
            return out
        return call

    opt.finish_grads, opt.step = timed(opt.finish_grads, "reduce"), timed(opt.step, "step")
    reps, total = 3, 0.0
    for step in range(2 + reps):
        if step == 2:
            acc.update(reduce=0.0, step=0.0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        float(run.step_fn(run.table, step))
        if step >= 2:
            total += time.perf_counter() - t
    inner = getattr(run.model, "module", run.model)
    shared = sum(p.numel() for name, p in inner.named_parameters() if not name.startswith("blocks"))
    buf = torch.zeros(shared, device="cuda")
    sums = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        dist.all_reduce(buf, group=run.mesh.pipe_group)
        torch.cuda.synchronize()
        sums.append(time.perf_counter() - t)
    return dict(step_ms=1e3 * total / reps, reduce_ms=1e3 * acc["reduce"] / reps,
                optimizer_ms=1e3 * acc["step"] / reps,
                schedule_ms=1e3 * (total - acc["reduce"] - acc["step"]) / reps,
                pipe_sum_ms=1e3 * statistics.median(sums), pipe_sum_mb=shared * 4 / 1e6)


def _pair(flag: str, timeout: int, check: bool = True) -> tuple:
    """Start this script twice as ``flag`` RANK PORT DIR on the one card and
    wait: (the directory, each process' output); kills both on the way out.
    ``check``: fail unless both exit 0."""
    outdir = tempfile.mkdtemp(prefix="pipe_smoke_")
    env = dict(os.environ, LOCAL_RANK="0",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, str(r),
                               str(port), outdir], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(PIPE["width"])]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 or not check, (
            f"{flag} rank {r} exited {p.returncode}:\n{text[-4000:]}")
    return outdir, logs


def phase_pipe(run_benchmark, smi) -> dict:
    """Phase 19 (a) and (b)."""
    from distributed_llm_training_benchmark_framework_tpu_torch.parallel.pipeline import (
        expected_messages,
        pipeline_bubble_bound,
    )

    # gloo reports the refusal as an exception in the sender, or aborts it
    # from its I/O thread: either way the sender's first line of it is kept.
    outdir, logs = _pair("--pipe-probe", 120, check=False)
    path = os.path.join(outdir, "probe.rank0.json")
    sent = json.load(open(path)) if os.path.exists(path) else {}
    errors = [ln for ln in logs[0].splitlines() if "gloo" in ln]
    sender = sent.get("error") or (f"delivered: {sent['ok']}" if "ok" in sent else
                                   (errors[-1].strip() if errors else logs[0][-300:]))
    log(f"[19] gloo send of a CUDA tensor: {sender}; the pipeline's transport stages its "
        "messages through pinned host memory under gloo")
    outdir, _ = _pair("--pipe-worker", 600)
    ranks = [json.load(open(os.path.join(outdir, f"pipe.rank{r}.json")))
             for r in range(PIPE["width"])]
    P, M, V = PIPE["width"], PIPE["grad_accum"], PIPE["virtual"]
    summary, launches = {}, {}
    for sched in PIPE_SCHEDULES:
        virtual = V if sched == "interleaved" else 1
        law = expected_messages(sched, P, M, virtual)
        bound = pipeline_bubble_bound(sched, P, M, virtual)
        for rk in ranks:
            run = rk[sched]
            stage = run["stage"]
            got = tuple(run["launches_per_step"][k] for k in PIPE_KERNELS)
            log(f"[19] (a) {sched} stage {stage} (two stages time-sliced on one card; not a "
                f"scaling number): {run['tokens_per_sec']:.1f} tok/s, step "
                f"{run['step_ms']:.2f} ms, peak {run['peak_gb']:.2f} GB (estimate_hbm "
                f"{run['estimate_gb']:.2f} GB), messages per step fwd/bwd "
                f"{run['sent_per_step']} (the pipeline's law {law} per direction), receive "
                f"wait {run['wait_ms_per_step']:.2f} ms/step, host-staged "
                f"{run['host_staged']}, bubble bound {bound:.4f}, K1/K2/K3 per step {got} "
                f"(want {PIPE_LAUNCHES[sched][stage]}), row {run['row']} on {smi}")
            assert got == PIPE_LAUNCHES[sched][stage], f"{sched} stage {stage}: launches {got}"
            assert run["host_staged"] and run["row"] == [P, P, sched, virtual]
            assert all(math.isfinite(x) for x in run["losses"])
            assert run["losses"] == ranks[0][sched]["losses"], f"{sched}: ranks' losses differ"
        for d in (0, 1):
            assert sum(rk[sched]["sent_per_step"][d] for rk in ranks) == law, (sched, d)
        launches[sched] = [rk[sched]["launches_per_step"] for rk in sorted(
            ranks, key=lambda rk: rk[sched]["stage"])]
        summary[sched] = dict(
            tokens_per_sec=ranks[0][sched]["tokens_per_sec"],
            step_ms=ranks[0][sched]["step_ms"], bubble_bound=bound, messages_law=law,
            stages=[{k: rk[sched][k] for k in ("stage", "peak_gb", "estimate_gb",
                                                 "sent_per_step", "wait_ms_per_step")}
                    for rk in ranks])
    base = ranks[0]["gpipe"]["losses"]
    rel = {sched: max(abs(a - b) / abs(b) for a, b in zip(ranks[0][sched]["losses"], base))
           for sched in PIPE_SCHEDULES[1:]}
    log(f"[19] (a) per-step losses: " + json.dumps({s: [round(x, 5) for x in
                                                        ranks[0][s]["losses"]]
                                                    for s in PIPE_SCHEDULES})
        + f"; max relative difference to gpipe {rel} (limit {PIPE_LOSS_RTOL})")
    assert all(v <= PIPE_LOSS_RTOL for v in rel.values()), rel
    one = []
    run_benchmark(strategy="zero2", tier=PIPE["tier"], seq_len=PIPE["seq_len"],
                  steps=PIPE_VS_ONE_STEPS, warmup_steps=1,
                  per_device_batch=PIPE["per_device_batch"], grad_accum=PIPE["grad_accum"],
                  attention_impl="flash", dropout=0.0, sync_every=5, device="cuda",
                  loss_log=one)
    piped = ranks[0]["gpipe_dropout0"]["losses"]
    rel_one = max(abs(a - b) / abs(b) for a, b in zip(piped, one))
    log(f"[19] (b) gpipe at pp {P}, dropout 0: losses {[round(x, 6) for x in piped]}, one "
        f"process {[round(x, 6) for x in one]}, max relative difference {rel_one:.2e} (limit "
        f"{PIPE_VS_ONE_RTOL})")
    assert rel_one <= PIPE_VS_ONE_RTOL, f"pp {P} differs from one process by {rel_one}"
    for rk in ranks:
        parts = rk["parts"]
        log(f"[19] (c) gpipe stage {rk['gpipe']['stage']}, a step's parts (host clock, card "
            f"synchronized around each): step {parts['step_ms']:.2f} ms = schedule "
            f"{parts['schedule_ms']:.2f} + the arm's reduction and the pipe sum "
            f"{parts['reduce_ms']:.2f} + optimizer {parts['optimizer_ms']:.2f}; the pipe sum "
            f"alone (all-reduce of {parts['pipe_sum_mb']:.1f} MB over gloo) "
            f"{parts['pipe_sum_ms']:.2f} ms")
    summary["parts"] = [rk["parts"] for rk in ranks]
    summary["vs_one_process_rel"] = rel_one
    summary["loss_rel_to_gpipe"] = rel
    log(f"[19] summary {json.dumps(summary)} on {smi}")
    return launches


# Phase 20: the run-time layer, through the harness CLI as a subprocess on
# the card. (a) to (c) run the parity row; (d) drills at tier S.
RT_ROW = ["--strategy", "zero2", "--world-size", "1", "--tier", "A", "--seq-len", "2048",
          "--per-device-batch", "1", "--grad-accum", "4", "--attention", "flash",
          "--warmup-steps", "2", "--heartbeat-sec", "0"]
RT_STEPS, RT_EVERY, RT_SIGTERM = 8, 4, 6
# Tier S's heads are 32 wide, which the kernels do not take: plain attention.
RT_DRILL = ["--strategy", "zero2", "--world-size", "1", "--tier", "S", "--seq-len", "128",
            "--per-device-batch", "1", "--grad-accum", "2", "--attention", "reference",
            "--warmup-steps", "1", "--steps", "8", "--heartbeat-sec", "0"]
RT_LOSS_RTOL = 1e-5  # resumed per-step losses against the straight run's
RT_MIN_FREE_GB = 20.0  # a tier-A checkpoint is ~2.8 GB; up to 3 kept, plus staging

# Phase 21: the numerics sentinel and the streaming input path.
RT2_BITFLIP = ["--steps", "9", "--sentinel", "on", "--sentinel-checksum-every", "4",
               "--checkpoint-every", "4", "--inject-fault", "bitflip@7"]
RT2_MOMENTS = ["--steps", "10", "--sentinel", "on", "--inject-fault", "opt-moments@5"]
RT2_STALL = ["--steps", "8", "--inject-fault", "data-stall@4:120",
             "--data-stall-timeout-sec", "3"]
RT2_SHARDS = dict(num_shards=4, records_per_shard=32)  # 128 records; a run reads <= 48
RT2_STEPS, RT2_WARMUP = 8, 2  # the in-process runs of (b)
# (b)'s runs in turns, (name, sentinel, stream): the sentinel on and the
# stream, each against the run with neither.
RT2_TURNS = (("off", False, False), ("on", True, False), ("stream", False, True))
RT2_KW = dict(strategy="zero2", tier="A", seq_len=2048, per_device_batch=1, grad_accum=4,
              attention_impl="flash", device="cuda")  # the parity row in process
RT2_LAUNCHES = 16 * 4 * RT2_STEPS  # K1-K3 each: layers x micro-batches x steps
RT2_ARM = "zero2_ws1_seq2048_tierA"
RT2_VOCAB = 32000  # tier A's


def harness(args: list, results: str, timeout: int) -> dict:
    """Run the port's harness CLI once on the card (its default device):
    exit code, stdout, the wall time and the unix time it exited; kills it
    on the way out."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    env.pop("INJECT_FAULT", None)
    cmd = [sys.executable, "-m",
           "distributed_llm_training_benchmark_framework_tpu_torch.train.harness",
           "--results-dir", results] + args
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"rc": proc.returncode, "out": out, "exited": time.time(),
            "wall_s": time.perf_counter() - t0}


def rt_events(results: str, arm: str) -> list:
    from distributed_llm_training_benchmark_framework_tpu_torch.telemetry import read_events

    return read_events(os.path.join(results, f"telemetry_{arm}.jsonl"))


def rt_losses(events: list) -> dict:
    """{step: loss} from per-step windows (the harness fences every step)."""
    return {e["step"]: e["loss"] for e in events if e["event"] == "step_window"}


def rt_step_ms(events: list) -> dict:
    """{step: ms} from per-step windows."""
    return {e["step"]: 1e3 * e["window_mean_step_time_sec"] for e in events
            if e["event"] == "step_window"}


def rt_row(results: str, arm: str) -> dict:
    return json.load(open(os.path.join(results, f"result_{arm}.json")))


def rt_expect(run: dict, rc: int, what: str) -> None:
    assert run["rc"] == rc, f"[20] {what}: exit {run['rc']}, expected {rc}:\n{run['out'][-4000:]}"


RT_S_ARM = "zero2_ws1_seq128_tierS"


def rt_drill_kill(root: str) -> dict:
    """``sigkill@5``, then ``--resume`` (from step 4, ``n_restarts`` 1)."""
    ck = ["--checkpoint-dir", os.path.join(root, "d_kill"), "--checkpoint-every", "2"]
    kill = harness(RT_DRILL + ck + ["--inject-fault", "sigkill@5"], os.path.join(root, "d1"),
                   300)
    rt_expect(kill, -9, "(d) sigkill@5")
    back = harness(RT_DRILL + ck + ["--resume"], os.path.join(root, "d2"), 300)
    rt_expect(back, 0, "(d) resume after sigkill")
    r = rt_row(os.path.join(root, "d2"), RT_S_ARM)
    assert (r["resumed"], r["n_restarts"], r["resume_step"]) == (True, 1, 4), r
    return {"sigkill@5": {"exit": kill["rc"], "resume_exit": back["rc"],
                          "resume_step": r["resume_step"], "n_restarts": r["n_restarts"]}}


def rt_drill_torn(root: str) -> dict:
    """``torn-checkpoint``: step 4 torn and the process killed; the resume
    quarantines it and falls back to step 2."""
    ck = ["--checkpoint-dir", os.path.join(root, "d_torn"), "--checkpoint-every", "2"]
    torn = harness(RT_DRILL + ck + ["--inject-fault", "torn-checkpoint"],
                   os.path.join(root, "d4"), 300)
    rt_expect(torn, -9, "(d) torn-checkpoint")
    fell = harness(RT_DRILL + ck + ["--resume"], os.path.join(root, "d5"), 300)
    rt_expect(fell, 0, "(d) resume after the torn checkpoint")
    note = os.path.join(root, "d_torn", "quarantine", "step_4", "QUARANTINE.json")
    assert os.path.exists(note), f"[20] no {note}"
    r = rt_row(os.path.join(root, "d5"), RT_S_ARM)
    assert r["resume_step"] == 2, r["resume_step"]
    return {"torn-checkpoint": {"exit": torn["rc"], "quarantined": json.load(open(note))["step"],
                                "resume_step": r["resume_step"], "resume_exit": fell["rc"]}}


def rt_drill_hang(root: str) -> dict:
    """``hang@3:30`` under a 5 s watchdog: exit 76 and a ``hang_dump``; then
    a resume of its step 2 with ``--steps 3``, past the end: 77."""
    ck = ["--checkpoint-dir", os.path.join(root, "d_hang"), "--checkpoint-every", "2"]
    hang = harness(RT_DRILL + ck + ["--inject-fault", "hang@3:30", "--hang-timeout-sec", "5"],
                   os.path.join(root, "d6"), 300)
    rt_expect(hang, 76, "(d) hang@3:30")
    dump = [e for e in rt_events(os.path.join(root, "d6"), RT_S_ARM)
            if e["event"] == "hang_dump"]
    assert dump and dump[0]["stacks"], "[20] no hang_dump event"
    past = harness(RT_DRILL + ck + ["--resume", "--steps", "3"], os.path.join(root, "d3"), 300)
    rt_expect(past, 77, "(d) resume past the end")
    assert "found checkpoint step 2" in past["out"], past["out"][-2000:]
    return {"hang@3:30": {"exit": hang["rc"], "hang_dump_threads": len(dump[0]["stacks"]),
                          "wall_s": hang["wall_s"]},
            "resume past the end": {"exit": past["rc"]}}


def phase_runtime(smi: str, beside=None) -> dict:
    """Phase 20: (a) preempt and resume at full width, (b) equal to the
    straight run, (c) the costs on the card, (d) fault drills at tier S.
    ``beside`` (a callable, or None) runs beside (b) and (d), after (a)'s
    two runs, which have the card to themselves; its result is returned
    under "beside"."""

    root = tempfile.mkdtemp(prefix="runtime_smoke_")
    free_gb = shutil.disk_usage(root).free / 1e9
    assert free_gb >= RT_MIN_FREE_GB, f"[20] {free_gb:.1f} GB free under {root}"
    log(f"[20] harness runs under {root} ({free_gb:.0f} GB free)")
    arm = "zero2_ws1_seq2048_tierA"
    row = RT_ROW + ["--steps", str(RT_STEPS)]
    ck = ["--checkpoint-dir", os.path.join(root, "ck"), "--checkpoint-every", str(RT_EVERY)]
    t0 = time.perf_counter()
    # (a) async saves: step RT_EVERY's is staged and written on a thread
    # while the next steps run; SIGTERM at the boundary of step RT_SIGTERM
    # commits it (the emergency flush), and the resume restores that
    # async-written step. The resume's only save, the final one, is sync.
    pre = harness(row + ck + ["--checkpoint-async", "--inject-fault", f"sigterm@{RT_SIGTERM}"],
                  os.path.join(root, "a1"), 600)
    rt_expect(pre, 75, "(a) sigterm")
    beats = [json.loads(ln.split(" ", 1)[1]) for ln in pre["out"].splitlines()
             if ln.startswith("BENCHMARK_HEARTBEAT ")]
    assert beats[-1].get("reason") == "preempted", beats[-1]
    assert beats[-1].get("emergency_checkpoint_step") == RT_EVERY, beats[-1]
    ev_pre = rt_events(os.path.join(root, "a1"), arm)
    fault_ts = next(e["ts"] for e in ev_pre if e["event"] == "fault_injected")
    flush = next(e for e in ev_pre if e["event"] == "emergency_flush")
    assert (flush["mode"], flush["committed_step"], flush["steps_delta"]) == (
        "async-delta", RT_EVERY, RT_SIGTERM - RT_EVERY), flush
    saves = [e for e in ev_pre if e["event"] == "checkpoint_saved"]
    assert [(e["step"], e["async"]) for e in saves] == [(RT_EVERY, True)], saves
    res = harness(RT_ROW + ["--steps", str(RT_STEPS), "--checkpoint-dir", os.path.join(root, "ck"),
                            "--resume"], os.path.join(root, "a2"), 600)
    rt_expect(res, 0, "(a) resume")
    resumed = rt_row(os.path.join(root, "a2"), arm)
    assert (resumed["resumed"], resumed["n_restarts"], resumed["resume_step"]) == (
        True, 1, RT_EVERY), {k: resumed[k] for k in ("resumed", "n_restarts", "resume_step")}
    ev_res = rt_events(os.path.join(root, "a2"), arm)
    restore = next(e for e in ev_res if e["event"] == "checkpoint_restored")
    assert restore["step"] == RT_EVERY, restore
    saves += [e for e in ev_res if e["event"] == "checkpoint_saved"]
    assert [(e["step"], e["async"]) for e in saves] == [
        (RT_EVERY, True), (RT_STEPS - 1, False)], saves
    shutil.rmtree(os.path.join(root, "ck"))
    # (b) the same steps straight through, no checkpoint, and (d) the drills
    # at tier S, the three chains at once (independent directories), all
    # started together with ``beside``: (b) is read for its losses only.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(5) as pool:
        side_job = pool.submit(beside) if beside is not None else None
        straight_job = pool.submit(harness, row, os.path.join(root, "b"), 600)
        chains = [pool.submit(fn, root) for fn in (rt_drill_kill, rt_drill_torn, rt_drill_hang)]
        straight = straight_job.result()
        drills = {k: v for c in chains for k, v in c.result().items()}
        side = side_job.result() if side_job is not None else None
    rt_expect(straight, 0, "(b) straight")
    want = rt_losses(rt_events(os.path.join(root, "b"), arm))
    lost, redone = rt_losses(ev_pre), rt_losses(ev_res)
    # Steps RT_EVERY + 1 .. RT_SIGTERM ran in both halves: each against (b).
    assert sorted({**lost, **redone}) == sorted(want) == list(range(RT_STEPS)), (
        sorted(lost), sorted(redone), sorted(want))
    pairs = [(v, want[s]) for half in (lost, redone) for s, v in half.items()]
    rel = max(abs(a - b) / abs(b) for a, b in pairs)
    assert rel <= RT_LOSS_RTOL, f"[20] (b) resumed losses {rel:.3g} rel from the straight run"
    log(f"[20] (a) --checkpoint-async, sigterm@{RT_SIGTERM}: exit 75, the in-flight async "
        f"save of step {flush['committed_step']} committed by the emergency flush "
        f"({flush['steps_delta']} steps to recompute); --resume from that step: exit 0, "
        f"resumed {resumed['resumed']}, n_restarts {resumed['n_restarts']}; (b) per-step losses "
        f"of (a), both halves, vs the straight run: max rel {rel:.3g} (limit {RT_LOSS_RTOL}), "
        f"equal at the telemetry's 6 decimals: {all(a == b for a, b in pairs)}")
    # (c) the costs, all from (a)'s two runs, which ran alone on the card.
    # Step ms from the windows: the timed steps before the first save, the
    # steps that ran while the async write was in flight, and the resumed
    # run's (its first holds the restart).
    pre_ms = rt_step_ms(ev_pre)
    aborted = next(e for e in ev_pre if e["event"] == "run_aborted")
    keep = ("step", "async", "gather_ms", "dispatch_ms", "write_ms", "write_wait_ms",
            "digest_ms", "bytes")
    costs = {
        "card": smi,
        "saves": [{k: e[k] for k in keep if k in e} for e in saves],
        "restore": restore,
        "sigterm_to_exit_ms": 1e3 * (pre["exited"] - fault_ts),
        "time_in_compile_sec": {"preempted": aborted["phase_times"]["compile"],
                                "resumed": resumed["time_in_compile_sec"]},
        "time_in_checkpoint_sec": {"resumed": resumed["time_in_checkpoint_sec"]},
        "step_ms": {
            "no checkpoint, median of timed steps 2..4": statistics.median(
                pre_ms[st] for st in range(2, RT_EVERY + 1)),
            "async write in flight, per step": {
                st: pre_ms[st] for st in range(RT_EVERY + 1, RT_SIGTERM + 1)},
            "resumed, per step": rt_step_ms(ev_res)},
        "wall_s": {"a1": pre["wall_s"], "a2": res["wall_s"], "b": straight["wall_s"]},
    }
    log(f"[20] (c) costs on {smi}: " + json.dumps(costs))
    log(f"[20] (d) drills at tier S: {json.dumps(drills)}")
    shutil.rmtree(root, ignore_errors=True)
    log(f"[20] phase wall {time.perf_counter() - t0:.1f} s"
        + (" (phase 22 beside (b) and (d))" if beside is not None else ""))
    return {"costs": costs, "drills": drills, "loss_max_rel": rel, "beside": side}


def rt2_losses_finite(results: str, arm: str) -> list:
    """The run's events, once every step's last loss (a replayed step's is
    its replay's) is finite."""
    events = rt_events(results, arm)
    losses = rt_losses(events)
    assert losses and all(v is not None and math.isfinite(v) for v in losses.values()), losses
    return events


def rt2_sentinel_run(root: str, name: str, args: list) -> dict:
    """One sentinel harness run of the parity row: exit 0, one rollback,
    finite losses (replayed ones included); its trip, rollback and restore."""
    arm = RT2_ARM
    run = harness(RT_ROW + args, os.path.join(root, name), 600)
    rt_expect(run, 0, f"(a) {name}")
    events = rt2_losses_finite(os.path.join(root, name), arm)
    row = rt_row(os.path.join(root, name), arm)
    assert row["n_rollbacks"] == 1, row["n_rollbacks"]
    trips = [(e["kind"], e["step"]) for e in events if e["event"] == "sentinel_trip"]
    restore = next(e for e in events if e["event"] == "checkpoint_restored" and e.get("rollback"))
    return {"exit": run["rc"], "n_rollbacks": row["n_rollbacks"],
            "rollback_steps_replayed": row["rollback_steps_replayed"], "trips": trips,
            "restore": restore, "wall_s": run["wall_s"],
            "step_ms_median": statistics.median(rt_step_ms(events).values())}


def rt2_stall_chain(root: str, shards: str) -> dict:
    """``data-stall@4:120`` under a 3 s timeout: exit 78 with step 3 saved;
    then the resume, whose cursor continues at the sidecar's."""
    arm = RT2_ARM
    ck = ["--data-path", shards, "--checkpoint-dir", os.path.join(root, "ck_stall")]
    stall = harness(RT_ROW + RT2_STALL + ck, os.path.join(root, "stall"), 600)
    rt_expect(stall, 78, "(a) data-stall")
    fatal = [e for e in rt_events(os.path.join(root, "stall"), arm)
             if e["event"] == "data_stall" and e["fatal"]]
    assert len(fatal) == 1 and fatal[0]["step"] == 4, fatal
    back = harness(RT_ROW + ["--steps", "8", "--resume"] + ck, os.path.join(root, "stall_back"),
                   600)
    rt_expect(back, 0, "(a) resume after the stall")
    rt2_losses_finite(os.path.join(root, "stall_back"), arm)
    row = rt_row(os.path.join(root, "stall_back"), arm)
    got = (row["resume_step"], row["stream_cursor_start"], row["stream_cursor_end"],
           row["records_consumed"])
    assert got == (3, 16, 32, 16), got
    return {"exit": stall["rc"], "stall_wait_sec": fatal[0]["wait_sec"], "resume_exit": back["rc"],
            "resume_step": row["resume_step"],
            "cursor": [row["stream_cursor_start"], row["stream_cursor_end"]],
            "wall_s": [stall["wall_s"], back["wall_s"]]}


def rt2_row(fa, run_benchmark, **kw) -> tuple:
    """The parity row in process, K1-K3 counted: (result, runtime log)."""
    log_, losses = {}, []
    fa.reset_launch_counts()
    res = run_benchmark(steps=RT2_STEPS, warmup_steps=RT2_WARMUP, telemetry=False,
                        loss_log=losses, runtime_log=log_, **RT2_KW, **kw)
    counts = fa.launch_counts()
    assert all(n == RT2_LAUNCHES for n in counts.values()), (counts, RT2_LAUNCHES)
    assert all(math.isfinite(v) for v in losses), losses
    return res, log_


def phase_runtime2(fa, run_benchmark, smi: str) -> dict:
    """Phase 21: the sentinel and the stream, (a) through the harness, (b)
    in process (see the module docstring)."""
    from concurrent.futures import ThreadPoolExecutor

    from distributed_llm_training_benchmark_framework_tpu_torch.data.make_shards import (
        make_shards,
    )

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="runtime2_smoke_")
    shards = os.path.join(root, "shards")
    make_shards(shards, seq_len=RT2_KW["seq_len"], vocab_size=RT2_VOCAB, seed=21, **RT2_SHARDS)
    log(f"[21] shards: {RT2_SHARDS} records of S {RT2_KW['seq_len']} under {shards} "
        f"({sum(os.path.getsize(os.path.join(shards, f)) for f in os.listdir(shards))} bytes)")
    with ThreadPoolExecutor(3) as pool:
        jobs = {
            "bitflip@7": pool.submit(rt2_sentinel_run, root, "bitflip", RT2_BITFLIP + [
                "--checkpoint-dir", os.path.join(root, "ck_bitflip")]),
            "opt-moments@5 (snapshot)": pool.submit(rt2_sentinel_run, root, "moments",
                                                    RT2_MOMENTS),
            "data-stall@4:120": pool.submit(rt2_stall_chain, root, shards),
        }
        drills = {name: job.result() for name, job in jobs.items()}
    # The trip lands on step 6, the step after the corruption (its first
    # symptom: the guards judge the loss first, then the grad norm).
    assert drills["opt-moments@5 (snapshot)"]["trips"][0][1] == 6, drills
    log(f"[21] (a) three harness runs at once on {smi}: {json.dumps(drills)}")
    gc.collect()
    torch.cuda.empty_cache()
    rows = {}
    for name, sentinel, stream in RT2_TURNS:
        res, log_ = rt2_row(fa, run_benchmark, sentinel=sentinel,
                            data_path=shards if stream else None)
        rows[name] = {"step_ms": 1e3 * res.mean_step_time_sec, "tokens_per_sec": res.tokens_per_sec,
                      "data_stall_frac": res.data_stall_frac,
                      "prefetch_wait_ms_mean": (statistics.mean(log_["data_wait_ms"])
                                                if "data_wait_ms" in log_ else None),
                      "records": [res.stream_cursor_start, res.stream_cursor_end]}
        torch.cuda.empty_cache()
    cost = {"sentinel_on_minus_off_ms": rows["on"]["step_ms"] - rows["off"]["step_ms"],
            "stream_minus_table_ms": rows["stream"]["step_ms"] - rows["off"]["step_ms"]}
    log(f"[21] (b) in process, K1-K3 {RT2_LAUNCHES} launches each per run, in turns on "
        f"{smi}: {json.dumps(rows)}; {json.dumps(cost)}")
    res, log_ = rt2_row(fa, run_benchmark, data_path=shards, inject_fault="data-corrupt-record@5")
    assert res.records_skipped == 1, res.records_skipped
    # The checksum alone: the fp32 global norm of the row's parameters.
    from distributed_llm_training_benchmark_framework_tpu_torch.train.loop import build_run

    run = build_run(sentinel=True, **RT2_KW)
    n_bytes = sum(p.numel() * p.element_size() for p in run.model.parameters())
    dev_ms = median_ms(run.step_fn.param_checksum, warmup=3, reps=10, device_clock=True)
    checksum = {"device_ms": dev_ms, "ms": median_ms(run.step_fn.param_checksum, 3, 10),
                "bytes": n_bytes, "bound_ms": 1e3 * n_bytes / (platform_hbm_gbps() * 1e9),
                "bound_by": "bytes"}
    log(f"[21] (b) data-corrupt-record@5 on the stream: records_skipped {res.records_skipped}, "
        f"finite losses; the parameter checksum on {smi}: {json.dumps(checksum)}")
    del run
    shutil.rmtree(root, ignore_errors=True)
    log(f"[21] phase wall {time.perf_counter() - t0:.1f} s")
    return {"drills": drills, "rows": rows, "cost": cost, "checksum": checksum}


# Phase 22: the supervisor over the harness, then the post-run path.
SV_STEPS, SV_EVERY, SV_SIGTERM = 8, 4, 6
SV_POLICY = {"schema_version": 1, "backoff_base_sec": 0.0, "backoff_max_sec": 0.0,
             "jitter_frac": 0.0,
             "classes": {"preempted": {"action": "resume", "max_attempts": 2},
                         "nothing-to-resume": {"action": "give-up", "max_attempts": 0}}}
PKG = "distributed_llm_training_benchmark_framework_tpu_torch"


def supervised(sup_args: list, child: list, results: str, timeout: int) -> dict:
    """The port's supervisor over ``child`` as a subprocess: exit code,
    output (stdout and stderr) and wall; kills it on the way out."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    for var in ("INJECT_FAULT", "SUPERVISOR_CHAOS", "RECOVERY_POLICY", "SUPERVISOR_DEVICE_COUNT",
                "BENCH_SUPERVISED_ATTEMPT"):
        env.pop(var, None)
    cmd = ([sys.executable, "-m", f"{PKG}.runtime.supervisor"] + sup_args
           + ["--results-dir", results, "--"] + child)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"rc": proc.returncode, "out": out, "wall_s": time.perf_counter() - t0}


def timed_call(fn, *args, **kw):
    """(result, stdout it printed, wall s)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = fn(*args, **kw)
    return res, buf.getvalue(), time.perf_counter() - t0


def phase_supervisor(smi: str) -> dict:
    """Phase 22: (a) the supervisor over a preempted parity row, (b) its
    probe beside a give-up, (c) ingest / gate / csv / reports on the
    results. ``main`` runs it beside phase 20 (b) and (d), so its walls
    are taken with those processes on the same host and card."""
    from concurrent.futures import ThreadPoolExecutor

    from distributed_llm_training_benchmark_framework_tpu_torch.analysis import (
        make_report,
        parse_metrics,
        telemetry_report,
        validate_results,
    )
    from distributed_llm_training_benchmark_framework_tpu_torch.regress import compare, store
    from distributed_llm_training_benchmark_framework_tpu_torch.runtime import supervisor

    root = tempfile.mkdtemp(prefix="supervisor_smoke_")
    free_gb = shutil.disk_usage(root).free / 1e9
    assert free_gb >= RT_MIN_FREE_GB, f"[22] {free_gb:.1f} GB free under {root}"
    t0 = time.perf_counter()
    results, ck = os.path.join(root, "r"), os.path.join(root, "ck")
    policy = os.path.join(root, "policy.json")
    with open(policy, "w") as f:
        json.dump(SV_POLICY, f)

    def child(out: str) -> list:
        """runtime.launch --nproc 1 over the harness, writing under ``out``."""
        return ([sys.executable, "-m", f"{PKG}.runtime.launch", "--nproc", "1", "--",
                 sys.executable, "-m", f"{PKG}.train.harness"] + RT_ROW
                + ["--steps", str(SV_STEPS), "--results-dir", out, "--checkpoint-dir", ck,
                   "--checkpoint-every", str(SV_EVERY)])

    sup = ["--policy", policy, "--resume-flag", "--resume"]
    # (a) preempted at SV_SIGTERM, resumed by the policy with the fault dropped.
    run = supervised(sup + ["--drop-on-retry", "--inject-fault"],
                     child(results) + ["--inject-fault", f"sigterm@{SV_SIGTERM}"], results, 900)
    assert run["rc"] == 0, f"[22] (a) supervisor exit {run['rc']}:\n{run['out'][-4000:]}"
    ledger = json.load(open(os.path.join(results, supervisor.LEDGER_NAME)))
    (path,) = [os.path.join(results, n) for n in os.listdir(results) if n.startswith("result_")]
    arm = os.path.basename(path)[len("result_"):-len(".json")]
    got = [(a["class"], a["action"], a["rc"]) for a in ledger["attempts"]]
    assert got == [("preempted", "resume", 75), ("ok", None, 0)], got
    assert "--inject-fault" not in ledger["attempts"][1]["cmd"], ledger["attempts"][1]["cmd"]
    assert ledger["attempts"][1]["cmd"][-1] == "--resume", ledger["attempts"][1]["cmd"]
    meta = rt_events(results, arm)[0]
    assert meta["event"] == "run_meta" and meta.get("supervised_attempt") == 2, meta
    beats = [json.loads(ln.split(" ", 1)[1]) for ln in run["out"].splitlines()
             if ln.startswith("BENCHMARK_HEARTBEAT ")]
    second = [b for b in beats if b.get("supervised_attempt") == 2]
    assert second and all(b["step"] > SV_EVERY for b in second), beats[-1]
    assert all(b["step"] <= SV_SIGTERM + 1 for b in beats if "supervised_attempt" not in b)
    row = rt_row(results, arm)
    sv = row["supervision"]
    assert (sv["n_attempts"], sv["classes"], sv["actions"], row["resumed"]) == (
        2, ["preempted", "ok"], ["resume"], True), (sv, row["resumed"])
    assert row["attention_impl"] == "flash" and row["resume_step"] >= SV_EVERY, row
    bad = (validate_results.validate_result(row, "[22]")
           + validate_results.validate_telemetry(path, row, "[22]"))
    assert bad == [], bad
    walls = [a["duration_sec"] for a in ledger["attempts"]]
    log(f"[22] (a) supervised parity row: ledger {got}, attempt walls {walls} s, supervisor "
        f"wall {run['wall_s']:.2f} s, its own time between attempts "
        f"{run['wall_s'] - sum(walls):.2f} s (backoff 0); row stamped {sv}, "
        f"resume_step {row['resume_step']}, {row['tokens_per_sec']:.0f} tok/s, "
        f"port validator: pass; on {smi}")
    # (b) the probe, beside a give-up: the checkpoint now holds the last step.
    r77 = os.path.join(root, "r77")
    with ThreadPoolExecutor(1) as pool:
        probe_t0 = time.perf_counter()
        probe_job = pool.submit(lambda: (supervisor.probe_device_count(), time.perf_counter()))
        give = supervised(sup, child(r77) + ["--resume"], r77, 600)
        n, probe_t1 = probe_job.result()
    probe_s = probe_t1 - probe_t0
    assert n == torch.cuda.device_count() == 1, n
    led77 = json.load(open(os.path.join(r77, supervisor.LEDGER_NAME)))
    assert give["rc"] == 77 and led77["gave_up"] and led77["n_attempts"] == 1, (
        give["rc"], led77, give["out"][-3000:])
    assert led77["attempts"][0]["class"] == "nothing-to-resume", led77
    log(f"[22] (b) probe: {n} device(s) in {probe_s:.2f} s (a torch import in a subprocess, "
        f"beside the give-up); "
        f"--resume past the end: exit 77, gave up after 1 attempt "
        f"({led77['attempts'][0]['give_up_reason']}), wall {give['wall_s']:.2f} s; on {smi}")
    # (c) the post-run path over (a)'s results.
    reg = os.path.join(root, "reg")
    rc_ingest, out_ingest, ingest_s = timed_call(
        compare.main, ["--registry", reg, "ingest", "--results-dir", results])
    rc_gate, out_gate, gate_s = timed_call(compare.main, ["--registry", reg, "gate", "--all"])
    assert (rc_ingest, rc_gate) == (0, 0), (out_ingest, out_gate)
    registry = store.Registry(reg)
    assert len(registry.records(arm)) == 1 and registry.baseline(arm) is None
    assert f"SKIP arm={arm}" in out_gate and "resumed (stitched)" in out_gate, out_gate
    df, _, csv_s = timed_call(
        lambda: parse_metrics.add_scaling_efficiency(parse_metrics.load_results(results)))
    parse_metrics.to_csv(df, os.path.join(root, "summary", "metrics.csv"))
    assert list(df["supervised_attempts"]) == [2] and list(df["supervised_actions"]) == [
        "resume"], df.to_dict("records")
    rc_tr, out_tr, tr_s = timed_call(telemetry_report.main, ["--results-dir", results])
    assert rc_tr == 0 and "Phase attribution" in out_tr, out_tr[-2000:]
    md, _, md_s = timed_call(make_report.build_report, df, registry_root=reg)
    assert md.startswith(make_report.TITLE) and "Supervised recoveries:** 1 arm(s)" in md, md
    with open(os.path.join(root, "summary", "BENCHMARK_REPORT.md"), "w") as f:
        f.write(md)
    costs = {"card": smi, "attempt_wall_s": walls, "supervisor_wall_s": run["wall_s"],
             "supervisor_between_attempts_s": run["wall_s"] - sum(walls),
             "probe_s": probe_s, "give_up_wall_s": give["wall_s"], "ingest_s": ingest_s,
             "gate_s": gate_s, "metrics_csv_s": csv_s, "telemetry_report_s": tr_s,
             "make_report_s": md_s}
    log(f"[22] (c) ingest {ingest_s:.3f} s, gate {gate_s:.3f} s (the resumed row kept out of "
        f"the baseline: SKIP), metrics.csv {csv_s:.3f} s, telemetry report {tr_s:.3f} s, "
        f"report {md_s:.3f} s on {smi}")
    log(f"[22] costs: {json.dumps(costs)}")
    shutil.rmtree(root, ignore_errors=True)
    log(f"[22] phase wall {time.perf_counter() - t0:.1f} s")
    return costs


PROFILE_ROWS = {
    "parity": dict(model_family="tinygpt", per_device_batch=1, grad_accum=4, layers=16),
    "flagship": dict(model_family="llama", per_device_batch=2, grad_accum=2, layers=16),
}
PROFILE_KERNELS = {"flash_fwd_kernel": "flash_fwd", "flash_bwd_dq_kernel": "flash_bwd_dq",
                   "flash_bwd_dkv_kernel": "flash_bwd_dkv"}


def launch_times(ps, events: list) -> dict:
    """{correlation: host ts} of the trace's launch calls."""
    return {e["args"]["correlation"]: e["ts"] for e in events
            if e.get("ph") == "X" and e.get("cat") in ps.LAUNCH_CATS
            and "correlation" in (e.get("args") or {})}


def launch_latency(ps, events: list) -> dict:
    """Device start less host launch time (us) of every device op joined to
    its launch by ``correlation``: the two clocks' agreement. A negative
    value is an op that started before its launch, which only a skew
    between the converted device clock and the host clock can produce."""
    launched = launch_times(ps, events)
    lat = sorted(e["ts"] - launched[c] for ops in ps.device_ops(events).values() for e in ops
                 if (c := (e.get("args") or {}).get("correlation")) in launched)
    return {"n": len(lat), "min_us": round(lat[0], 1), "median_us": round(lat[len(lat) // 2], 1),
            "max_us": round(lat[-1], 1), "n_negative": sum(x < 0 for x in lat)} if lat else {}


def marker_layout(ps, events: list, n: int = 2) -> list:
    """Where the step markers of the first ``n`` and the last traced step fall
    (us after the first host marker): the host ``ProfilerStep#N`` span, its
    ``gpu_user_annotation`` mirror on the card (None when kineto wrote none),
    the step's device window (first op to the next step's first op), and
    its first device op's start less that op's host launch time."""
    host = ps.host_steps(events)
    t_ref = host[0][1]
    gpu = {e["name"]: ps._span(e) for e in events
           if e.get("cat") == "gpu_user_annotation" and ps.STEP_MARKER_RE.match(e["name"])}
    (wins,) = ps.device_steps(events).values()
    windows = {name: (t0, t1) for name, t0, t1 in wins}
    launched = launch_times(ps, events)
    first_op = {e["ts"]: e for ops in ps.device_ops(events).values() for e in ops}
    out = []
    for step, h0, h1 in host[:n] + host[-1:]:
        g = gpu.get(f"ProfilerStep#{step}")
        w = windows.get(str(step))
        op = first_op.get(w[0]) if w is not None else None
        corr = (op.get("args") or {}).get("correlation") if op is not None else None
        out.append({"step": step, "host": [round(h0 - t_ref, 1), round(h1 - t_ref, 1)],
                    "gpu_annotation": None if g is None else [round(g[0] - t_ref, 1),
                                                              round(g[1] - t_ref, 1)],
                    "device_window": None if w is None else [round(w[0] - t_ref, 1),
                                                             round(w[1] - t_ref, 1)],
                    "first_op": None if op is None else op["name"][:60],
                    "first_op_launch_to_start_us": (round(w[0] - launched[corr], 1)
                                                    if corr in launched else None)})
    return out


def phase_profile(fa, run_benchmark, unprofiled: dict, smi: str) -> dict:
    """Phase 23: both tier-A rows profiled through run_benchmark(profile_dir=...):
    the trace, the cost JSON, the step anatomy (6 steps, clipped, fractions
    summing to 1, no exposed collective at world 1), K1-K3 launches per traced
    step in the trace, and the memory anatomy from the allocator."""

    from distributed_llm_training_benchmark_framework_tpu_torch.analysis import (
        profile_summary as ps,
        step_anatomy as sa,
        validate_results,
    )

    root = tempfile.mkdtemp(prefix="profile_smoke_")
    t_phase = time.perf_counter()
    out = {}
    for name, row in PROFILE_ROWS.items():
        prof, results = os.path.join(root, name), os.path.join(root, f"results_{name}")
        held_gib = torch.cuda.memory_allocated() / 2**30  # earlier phases' live tensors
        fa.reset_launch_counts()
        res = run_benchmark(
            strategy="zero2", tier="A", seq_len=2048, model_family=row["model_family"],
            steps=WARMUP_STEPS + TIMED_STEPS, warmup_steps=WARMUP_STEPS,
            per_device_batch=row["per_device_batch"], grad_accum=row["grad_accum"],
            attention_impl="flash", sync_every=TIMED_STEPS, device="cuda",
            results_dir=results, profile_dir=prof)
        counts = fa.launch_counts()
        per_micro = row["layers"] * row["grad_accum"]
        for kernel, n in counts.items():
            assert n == per_micro * (WARMUP_STEPS + TIMED_STEPS), (
                f"[23] {name}: {kernel} launched {n} times")
        (trace,) = ps.trace_files(prof)
        assert os.path.exists(os.path.join(prof, sa.COST_JSON_FILENAME)), f"[23] {name}: no cost"
        arm = res.result_filename()[len("result_"):-len(".json")]
        tel = os.path.join(results, f"telemetry_{arm}.jsonl")
        (exported,) = [e for e in rt_events(results, arm) if e["event"] == "profile_trace"]
        t0 = time.perf_counter()
        events = ps.load_events(trace)
        load_s = time.perf_counter() - t0
        summary = ps.summarize(events)
        summarize_s = time.perf_counter() - t0 - load_s
        layout = marker_layout(ps, events)
        latency = launch_latency(ps, events)
        busy_us = sum(summary["op_classes"].values())
        del events
        t0 = time.perf_counter()
        report = sa.analyze_profile_dir(prof, telemetry_path=tel)
        analyze_s = time.perf_counter() - t0
        agg = report["agg"]
        log(f"[23] {name}: trace {exported['bytes']} bytes, {summary['n_events']} events (stop "
            f"{exported['stop_sec']:.2f} s, export {exported['export_sec']:.2f} s, time_in_trace "
            f"{res.time_in_trace_sec:.2f} s; load {load_s:.2f} s, summary "
            f"{summarize_s:.2f} s, analysis {analyze_s:.2f} s)")
        log(f"[23] {name}: kineto categories "
            f"{json.dumps(dict(summary['categories'].most_common()))}")
        log(f"[23] {name}: step markers (us after the first host marker) "
            f"{json.dumps(layout)}")
        log(f"[23] {name}: device start less host launch over {latency.get('n')} ops (us): "
            f"{json.dumps(latency)}; traced steps {agg['n_steps']}, clipped "
            f"{agg['clipped_to_timed']}, fallback lanes {agg['clip_fallback_lanes']}")
        assert agg["n_steps"] == TIMED_STEPS, f"[23] {name}: {agg['n_steps']} traced steps"
        assert agg["clipped_to_timed"] is True and agg["clip_fallback_lanes"] == 0, agg
        total = agg["compute_frac"] + agg["comms_exposed_frac"] + agg["idle_frac"]
        assert abs(total - 1.0) <= 1e-6, f"[23] {name}: fractions sum to {total!r}"
        assert agg["comms_exposed_frac"] == 0.0 and agg["comms_overlap_frac"] is None, agg
        assert res.comms_exposed_frac == 0.0 and res.comms_overlap_frac is None, res
        assert res.anatomy_compute_frac is not None and res.anatomy_idle_frac is not None
        assert res.roofline_flops_pct_of_peak is not None, res
        per_step = {PROFILE_KERNELS[k]: summary["op_counts"][k] / agg["n_steps"]
                    for k in PROFILE_KERNELS}
        assert set(per_step.values()) == {per_micro}, f"[23] {name}: {per_step} per step"
        assert res.hbm_attribution_source == "allocator", res.hbm_attribution_source
        assert res.hbm_model_drift_frac is not None, res
        path = os.path.join(results, res.result_filename())
        row_dict = json.load(open(path))
        bad = (validate_results.validate_result(row_dict, f"[23] {name}")
               + validate_results.validate_telemetry(path, row_dict, f"[23] {name}"))
        assert bad == [], bad
        base = unprofiled[name]
        busy_ms = busy_us / 1e3 / agg["n_steps"]
        out[name] = {
            "card": smi,
            "trace_bytes": exported["bytes"], "trace_events": summary["n_events"],
            "stop_s": exported["stop_sec"], "export_s": exported["export_sec"],
            "time_in_trace_sec": res.time_in_trace_sec, "load_s": load_s,
            "summarize_s": summarize_s, "analyze_s": analyze_s,
            "categories": dict(summary["categories"].most_common()),
            "markers": layout, "launch_to_start_us": latency,
            "anatomy": {k: agg[k] for k in ("compute_frac", "comms_exposed_frac", "idle_frac",
                                            "median_step_us", "mean_step_us")},
            "roofline_flops_pct_of_peak": res.roofline_flops_pct_of_peak,
            "op_ms_per_step": {k: v / 1e3 / agg["n_steps"]
                               for k, v in summary["op_classes"].most_common()},
            "op_launches_per_step": {k: v / agg["n_steps"]
                                     for k, v in summary["op_counts"].most_common()},
            "kernel_launches_per_step": per_step,
            "busy_ms_per_step": busy_ms,
            "profiled_step_ms": 1e3 * res.mean_step_time_sec,
            "unprofiled_step_ms": 1e3 * base.mean_step_time_sec,
            "idle_unprofiled": 1.0 - busy_ms / (1e3 * base.mean_step_time_sec),
            "tokens_per_sec": res.tokens_per_sec,
            "tokens_per_sec_unprofiled": base.tokens_per_sec,
            "tokens_ratio": res.tokens_per_sec / base.tokens_per_sec,
            "held_before_gib": held_gib, "peak_hbm_gb": res.peak_hbm_gb,
            "hbm_measured_gib": res.hbm_measured, "hbm_estimate_gib":
                res.hbm_estimate["total_gib"], "hbm_attribution": res.hbm_attribution,
            "hbm_model_drift_frac": res.hbm_model_drift_frac,
        }
        o = out[name]
        log(f"[23] {name}: anatomy over {agg['n_steps']} steps (clipped, fallback 0): compute "
            f"{agg['compute_frac']!r} + exposed {agg['comms_exposed_frac']!r} + idle "
            f"{agg['idle_frac']!r} = {total!r}; median step {agg['median_step_us'] / 1e3:.3f} "
            f"ms; roofline {res.roofline_flops_pct_of_peak}% of bf16 peak (model FLOPs)")
        log(f"[23] {name}: K1-K3 per traced step {per_step}; device busy {busy_ms:.3f} ms/step; "
            f"idle: anatomy {agg['idle_frac']:.4f} (profiled), 1 - busy / unprofiled wall "
            f"{o['idle_unprofiled']:.4f} (phase 3's {o['unprofiled_step_ms']:.2f} ms); "
            f"tok/s profiled {res.tokens_per_sec:.1f} / phase 3's {base.tokens_per_sec:.1f} = "
            f"{o['tokens_ratio']:.4f}")
        log(f"[23] {name}: device ms per step by class "
            + json.dumps({k: round(v, 3) for k, v in o["op_ms_per_step"].items()}))
        log(f"[23] {name}: memory anatomy: allocator {res.hbm_measured} GiB (the process's peak "
            f"{res.peak_hbm_gb:.2f} GB less {held_gib:.4f} GiB held before the arm) vs estimate "
            f"{o['hbm_estimate_gib']:.4f} GiB, hbm_model_drift_frac {res.hbm_model_drift_frac}, "
            f"attribution {json.dumps(res.hbm_attribution)}; port validator: pass; on {smi}")
        shutil.rmtree(prof, ignore_errors=True)
        del report
        gc.collect()
        torch.cuda.empty_cache()
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "phase23_profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    shutil.rmtree(root, ignore_errors=True)
    log(f"[23] phase wall {time.perf_counter() - t_phase:.1f} s")
    return out


def platform_hbm_gbps() -> float:
    from distributed_llm_training_benchmark_framework_tpu_torch.utils import platform

    return platform.device_peak_hbm_gbps(torch.cuda.get_device_name(0))


def phase_static(smi: str) -> dict:
    """Phase 24: the graftcheck CLI as the bench's preflight runs it, the lint
    alone, the roster's collective audit and an injected seed bug, each in a
    child process that must not initialize CUDA."""
    from distributed_llm_training_benchmark_framework_tpu_torch import bench
    from distributed_llm_training_benchmark_framework_tpu_torch.analysis.static import (
        collective_audit as ca,
    )

    frozen = ca.load_budgets()["torch_version"]
    runs = {
        "preflight": (list(bench.PREFLIGHT_ARGS), 0),
        "roster": (["--audit", "--arms", ",".join(ca.ROSTER)], 0),
        "inject": (["--audit", "--inject", "bad-cmm-ring", "--arms", "llama-tp2-gqa-cmm"], 1),
    }
    t0 = time.perf_counter()
    out = {}
    for tag, (args, want) in runs.items():
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"{PKG}.analysis.static", *args],
                              capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        wall = time.perf_counter() - t1
        assert proc.returncode == want, (
            f"[24] {tag}: exit {proc.returncode}, want {want}:\n{proc.stderr[-4000:]}")
        cuda = re.findall(r"torch\.cuda\.is_initialized\(\) = (\w+)", proc.stderr)
        assert cuda == ["False"], f"[24] {tag}: the audit process initialized CUDA: {cuda}"
        if tag == "inject":
            assert "llama-tp2-gqa-cmm:" in proc.stderr, proc.stderr[-4000:]
        summary = [ln for ln in proc.stderr.splitlines()
                   if "finding(s)" in ln or "graftcheck lint:" in ln]
        out[tag] = {"rc": proc.returncode, "wall_s": round(wall, 2), "summary": summary}
        log(f"[24] ({'abc'[len(out) - 1]}) {tag}: exit {proc.returncode} in {wall:.2f} s, "
            f"torch.cuda.is_initialized() False; {' / '.join(summary)}")
    log(f"[24] budgets frozen on torch {frozen}, this torch {torch.__version__}; walls "
        + json.dumps({t: r["wall_s"] for t, r in out.items()}) + f" on {smi}")
    log(f"[24] phase wall {time.perf_counter() - t0:.1f} s")
    return out


# Phase 25: the suite layer, through the port's own scripts.
# SKIP_CHAOS: (a) ran the smoke; SKIP_PREFLIGHT: phase 24 ran graftcheck.
SUITE_ENV = {"STRATEGIES": "ddp fsdp zero2 zero3", "WORLD_SIZES": "1", "ATTENTION": "flash",
             "STEPS": "12", "WARMUP_STEPS": "3", "REMAT_SWEEP": "1", "SKIP_CHAOS": "1",
             "SKIP_PREFLIGHT": "1", "ARM_CHECKPOINT_EVERY": "0"}
SUITE_STEPS = 12  # warmup included, as run_benchmark counts them
SUITE_SMOKE = ("sigkill", "torn-checkpoint", "bitflip", "data-corrupt-record")
SUITE_FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
SUITE_ARM_LAUNCHES = 16 * 4 * SUITE_STEPS  # parity: layers x micro-batches x steps
SUITE_SWEEP_LAUNCHES = 16 * 2 * SUITE_STEPS  # flagship: layers x micro-batches x steps
# The sweep's bench process also runs its top row, the parity row, first.


def start_script(script: str, args: list, env_extra: dict) -> dict:
    """Start one of the port's suite scripts in a session of its own, its
    output (stdout and stderr) to a file; ``finish_script`` waits."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here, PYTHON_BIN=sys.executable, **env_extra)
    for var in ("INJECT_FAULT", "SUPERVISOR_CHAOS", "RECOVERY_POLICY", "SUPERVISOR_DEVICE_COUNT",
                "BENCH_SUPERVISED_ATTEMPT", "REGISTRY_DIR", "DEVICE"):
        env.pop(var, None)
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(["bash", os.path.join(here, "scripts", script), *args], cwd=here,
                            env=env, stdout=out, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    return {"proc": proc, "out": out, "t0": time.perf_counter()}


def stop_script(run: dict) -> None:
    """Kill what is left of a started script's session and reap it."""
    import signal

    try:
        os.killpg(run["proc"].pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    run["proc"].wait()


def finish_script(run: dict, timeout: int) -> dict:
    """Wait for a started script: exit code, output and wall; kills its
    whole session on the way out."""
    proc = run["proc"]
    try:
        proc.wait(timeout=max(timeout - (time.perf_counter() - run["t0"]), 1))
    finally:
        if proc.poll() is None:
            stop_script(run)
    run["out"].seek(0)
    return {"rc": proc.returncode, "out": run["out"].read(),
            "wall_s": time.perf_counter() - run["t0"]}


def suite_script(script: str, args: list, env_extra: dict, timeout: int) -> dict:
    """Run one of the port's suite scripts to its end (``start_script``,
    ``finish_script``)."""
    return finish_script(start_script(script, args, env_extra), timeout)


def start_chaos_smoke(root: str) -> dict:
    """Phase 25 (a), started: the chaos smoke with CHAOS_ON_DEVICE=1, whose
    one-rank arms pass no --device, so run on cuda. It needs the card
    lightly (tier S) and the host mostly (process starts), so ``main``
    runs it beside phase 24, which uses the host alone."""
    return start_script("torch_chaos_suite.sh",
                        ["--smoke", "--jobs", "4", "--keep", "--results-dir",
                         os.path.join(root, "chaos")], {"CHAOS_ON_DEVICE": "1"})


def phase_suite(smi: str, chaos_run: dict = None, root: str = None) -> dict:
    """Phase 25: (a) the chaos smoke's one-rank arms on the card (started
    by ``start_chaos_smoke`` under ``root``, or here), (b) the port's local
    suite at full tier-A width with the remat sweep."""
    import csv
    import glob

    if chaos_run is None:
        root = tempfile.mkdtemp(prefix="suite_smoke_")
        chaos_run = start_chaos_smoke(root)
    t0 = time.perf_counter()
    chaos = finish_script(chaos_run, 900)
    assert chaos["rc"] == 0, f"[25] (a) chaos smoke exit {chaos['rc']}:\n{chaos['out'][-6000:]}"
    oks = re.findall(r"^CHAOS OK +(\S+):", chaos["out"], re.M)
    assert sorted(oks) == sorted(SUITE_SMOKE), oks
    backends = {f: json.load(open(os.path.join(root, "chaos", f, "results",
                                               "result_ddp_ws1_seq32_tierS.json")))["backend"]
                for f in SUITE_SMOKE}
    assert set(backends.values()) == {"cuda"}, backends
    log(f"[25] (a) torch_chaos_suite.sh --smoke --jobs 4, CHAOS_ON_DEVICE=1: exit 0, CHAOS OK {oks}, "
        f"rows on {set(backends.values())}, wall {chaos['wall_s']:.1f} s (from its start) on {smi}")
    # (b) the suite; its processes write their kernel launch counts at exit.
    launches_dir = os.path.join(root, "launches")
    os.makedirs(launches_dir)
    results = os.path.join(root, "suite")
    suite = suite_script("torch_run_all_benchmarks.sh", [],
                         {**SUITE_ENV, "RESULTS_DIR": results,
                          "KERNEL_LAUNCHES_DIR": launches_dir}, 1200)
    out = suite["out"]
    stages = {m[0]: float(m[1]) for m in re.findall(r"^STAGE (\w+) wall ([\d.]+)s", out, re.M)}
    log(f"[25] (b) torch_run_all_benchmarks.sh: exit {suite['rc']}, stage walls "
        f"{json.dumps(stages)} s, suite wall {suite['wall_s']:.1f} s on {smi}")
    assert suite["rc"] == 0, f"[25] (b) suite exit {suite['rc']}:\n{out[-8000:]}"
    assert "Suite complete: 4 passed, 0 failed" in out, out[-4000:]
    assert "VALIDATE PASS" in out and "REGRESSION GATE FAILED" not in out, out[-4000:]
    gate = re.findall(r"regress gate: (\d+) arm\(s\) checked, (\d+) regression", out)
    assert gate and gate[-1][1] == "0", gate
    assert set(stages) == {"arms", "analysis", "regress", "remat_sweep"}, stages
    with open(os.path.join(results, "summary", "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    assert sorted(r["strategy"] for r in rows) == ["ddp", "fsdp", "zero2", "zero3"], rows
    assert all(r["backend"] == "cuda" and "H100" in r["device_kind"] for r in rows), rows
    report = open(os.path.join(results, "summary", "BENCHMARK_REPORT.md")).read()
    assert "## Key findings" in report and "## Remat/HBM frontier" in report, report[:2000]
    arms = {}
    for path in glob.glob(os.path.join(results, "*_results", "result_*.json")):
        r = json.load(open(path))
        assert r["attention_impl"] == "flash" and r["tier"] == "A", path
        arms[r["strategy"]] = {"tokens_per_sec": r["tokens_per_sec"],
                               "step_ms": 1e3 * r["mean_step_time_sec"],
                               "peak_hbm_gb": r["peak_hbm_gb"], "mfu_pct": r["mfu_pct"]}
    sweep = json.loads(open(os.path.join(results, "remat_sweep.json")).read().splitlines()[-1])
    frontier = {pol: {"resolved": r["remat_policy_resolved"], "tokens_per_sec": r["value"],
                      "peak_hbm_gb": r["peak_hbm_gb"], "headroom_gb": r["hbm_headroom_gb"]}
                for pol, r in sweep["remat_sweep"].items()}
    assert list(frontier) == ["none", "dots", "full", "auto"], frontier
    assert all(v["tokens_per_sec"] > 0 and v["peak_hbm_gb"] > 0 for v in frontier.values())
    # The launches: each arm process K1-K3 as layers x micro-batches x steps;
    # the sweep's process its top row (the parity row) and then the flagship
    # once per policy, K1 twice per layer under a recomputing policy.
    counts = [json.load(open(p)) for p in glob.glob(os.path.join(launches_dir, "*.json"))]
    per_arm = [c for c in counts if c.get("flash_bwd_dq") == SUITE_ARM_LAUNCHES]
    sweep_counts = [c for c in counts if c not in per_arm]
    assert len(per_arm) == 4 and all(
        [c.get(k) for k in SUITE_FLASH] == [SUITE_ARM_LAUNCHES] * 3 for c in per_arm), counts
    recompute = sum(2 if v["resolved"] != "none" else 1 for v in frontier.values())
    assert sweep_counts == [{
        "flash_fwd": SUITE_ARM_LAUNCHES + SUITE_SWEEP_LAUNCHES * recompute,
        "flash_bwd_dq": SUITE_ARM_LAUNCHES + SUITE_SWEEP_LAUNCHES * 4,
        "flash_bwd_dkv": SUITE_ARM_LAUNCHES + SUITE_SWEEP_LAUNCHES * 4}], sweep_counts
    launches = {"arms": {k: 4 * SUITE_ARM_LAUNCHES for k in SUITE_FLASH},
                "remat_sweep": sweep_counts[0]}
    log(f"[25] (b) torch_run_all_benchmarks.sh ({' '.join(f'{k}={v}' for k, v in SUITE_ENV.items())}"
        f"): exit 0, 'Suite complete: 4 passed, 0 failed', VALIDATE PASS, gate "
        f"{gate[-1][0]} arm(s) 0 regressions, metrics.csv {len(rows)} rows on cuda, the report's "
        f"Key findings and remat frontier")
    log(f"[25] (b) arms, 12 steps (3 warmup) on {smi}: {json.dumps(arms)}")
    log(f"[25] (b) remat sweep (flagship row, 12 steps) on {smi}: {json.dumps(frontier)}")
    log(f"[25] (b) K1-K3 launches in the suite's processes: {json.dumps(launches)}")
    shutil.rmtree(root, ignore_errors=True)
    log(f"[25] phase wall {time.perf_counter() - t0:.1f} s")
    return {"chaos_wall_s": chaos["wall_s"], "suite_wall_s": suite["wall_s"], "stages": stages,
            "arms": arms, "frontier": frontier, "launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--tp-worker"]:
        return tp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if sys.argv[1:2] == ["--moe-worker"]:
        return moe_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if sys.argv[1:2] == ["--pipe-worker"]:
        return pipe_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if sys.argv[1:2] == ["--pipe-probe"]:
        return pipe_probe(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    from distributed_llm_training_benchmark_framework_tpu_torch import models
    from distributed_llm_training_benchmark_framework_tpu_torch.data import SyntheticDataset
    from distributed_llm_training_benchmark_framework_tpu_torch.ops import _build
    from distributed_llm_training_benchmark_framework_tpu_torch.microbench import flash_fwd as mb
    from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as fa
    from distributed_llm_training_benchmark_framework_tpu_torch.ops import fwd_variants as fv
    from distributed_llm_training_benchmark_framework_tpu_torch.ops import ring_attention as ra
    from distributed_llm_training_benchmark_framework_tpu_torch.ops import ulysses_attention as ua
    from distributed_llm_training_benchmark_framework_tpu_torch.parallel import (
        get_strategy,
        make_mesh,
    )
    from distributed_llm_training_benchmark_framework_tpu_torch.parallel.strategies import (
        param_torch_dtype,
    )
    from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt
    from distributed_llm_training_benchmark_framework_tpu_torch.train import loop
    from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
    from distributed_llm_training_benchmark_framework_tpu_torch.utils import flops, memory, platform

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"[0] {smi}")
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    name = torch.cuda.get_device_name(0)
    tflops, gbps = flops.device_peak_tflops(name), platform.device_peak_hbm_gbps(name)
    assert tflops and gbps, f"no bf16 / HBM peak known for {name!r}"
    peaks = {"flops": tflops * 1e12, "bytes": gbps * 1e9}
    log(f"[0] peaks for the bounds: {tflops} TFLOP/s bf16 dense, {gbps} GB/s HBM, "
        f"{H100_INT32_OPS / 1e12:.2f} T int32 op/s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    log(f"[0] kernels built in {_build.build_seconds:.1f} s into {_build.build_dir()}")
    for lib in _build.SIGNATURES:
        report = (_build.build_dir() / f"{lib}.ptxas.txt").read_text().splitlines()
        regs = [ln.split(":")[-1].strip() for ln in report if "registers" in ln]
        spills = [ln.strip() for ln in report
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        log(f"[0] {lib}: {len(regs)} kernels, {sorted(set(regs))}; spills: {spills or 'none'}")
        for inst, (nregs, spill) in ptxas_instances(report).items():
            log(f"[0]   {inst}: {nregs} registers, {spill}")
        for ln in report:
            if "wgmma" in ln.lower() and "Compiling entry function" not in ln:
                log(f"[0]   ptxas: {ln.strip()}")

    def walled(phases: str, fn, *args):
        """Run ``fn`` and log its wall under its phase numbers."""
        t = time.perf_counter()
        out = fn(*args)
        log(f"[{phases}] phase wall {time.perf_counter() - t:.1f} s")
        return out

    timing = walled("1-2", phase_kernels, fa, peaks)
    launches, row_losses, row_results = walled("3", phase_train, fa, ra, run_benchmark)
    walled("4", phase_whole_model, fa, models, SyntheticDataset)
    ring_timing = walled("5-6", phase_ring_kernels, fa, ra, peaks)
    walled("7", phase_ring_vs_flash, fa, ra)
    ring_launches = walled("8", phase_ring_train, fa, ra, run_benchmark)
    walled("9", phase_ring_whole_model, fa, models, SyntheticDataset, make_mesh)
    fwd_timing = walled("10", phase_fwd_variants, fa, fv, peaks)
    mb_launches = walled("11", phase_microbench, _build, mb)
    walled("13", phase_ulysses, fa, ua)
    launches.update(walled("14", phase_ulysses_train, fa, ra, run_benchmark))
    arms = walled("12, 15", phase_arms, fa, ra, ua, models, make_mesh, get_strategy, rt, memory,
                  loop)
    tp_timing = walled("16 (a)", phase_tp_kernels, fa, ra, peaks)
    tp_launches = walled("16 (b)", phase_tp_train, {
        ("parity", "zero2"): row_losses["parity"], ("flagship", "zero2"): row_losses["flagship"],
        ("parity", "ddp"): arms["ddp"]["plain"]["losses"],
        ("flagship", "ddp"): no_group_ddp_flagship(run_benchmark)})
    walled("17", phase_offload, fa, loop, memory, models, get_strategy, param_torch_dtype, smi,
           row_results["parity"])
    walled("18", phase_moe, fa, loop, memory, models, get_strategy, make_mesh, smi)
    gc.collect()
    torch.cuda.empty_cache()
    pipe_launches = walled("19", phase_pipe, run_benchmark, smi)
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 22's chain of processes runs beside phase 20's straight run and
    # drills: each is mostly process starts and checkpoint I/O.
    phase_runtime(smi, beside=lambda: phase_supervisor(smi))
    gc.collect()
    torch.cuda.empty_cache()
    phase_runtime2(fa, run_benchmark, smi)
    gc.collect()
    torch.cuda.empty_cache()
    phase_profile(fa, run_benchmark, row_results, smi)
    suite_root = tempfile.mkdtemp(prefix="suite_smoke_")
    chaos_run = start_chaos_smoke(suite_root)
    try:
        phase_static(smi)
        gc.collect()
        torch.cuda.empty_cache()
        suite = phase_suite(smi, chaos_run, suite_root)
    finally:
        stop_script(chaos_run)
        shutil.rmtree(suite_root, ignore_errors=True)

    names = {"fwd": "flash_fwd", "dq": "flash_bwd_dq", "dkv": "flash_bwd_dkv"}
    sources = {
        "fwd": ("distributed_llm_training_benchmark_framework_tpu_torch/csrc/flash_fwd.cu",
                "distributed_llm_training_benchmark_framework_tpu/ops/flash_attention.py:127"),
        "dq": ("distributed_llm_training_benchmark_framework_tpu_torch/csrc/flash_bwd.cu",
               "distributed_llm_training_benchmark_framework_tpu/ops/flash_attention.py:328"),
        "dkv": ("distributed_llm_training_benchmark_framework_tpu_torch/csrc/flash_bwd.cu",
                "distributed_llm_training_benchmark_framework_tpu/ops/flash_attention.py:396"),
    }
    kernels = []
    for key in ("a", "b", "u", "v"):
        sh = SHAPES[key]
        for kind in ("fwd", "dq", "dkv"):
            r = timing[key][kind]
            entry = {
                "name": f"{names[kind]} [{sh['row']}: BH {sh['BH']} S {sh['S']} Dh {sh['D']}"
                        f" causal {sh['causal']} rate {sh['rate']}]",
                "route": "cuda",
                "source": sources[kind][0],
                "replaces": sources[kind][1],
                "launches": launches[sh["row"]][names[kind]],
                "launches_per_step": launches[sh["row"]][names[kind]] / (WARMUP_STEPS
                                                                         + TIMED_STEPS),
                "max_abs_err": r["max_abs_err"],
                "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "device_ms": r["device_ms"],
            }
            entry.update({nm: r[nm] for nm in OPTIONAL_KEYS if nm in r})
            if key == "a":
                entry["pipeline_launches_per_stage_per_step"] = {
                    sched: [stage[names[kind]] for stage in stages]
                    for sched, stages in pipe_launches.items()}
                entry["suite_launches"] = suite["launches"]["arms"][names[kind]]
            if key == "b":
                entry["suite_launches"] = suite["launches"]["remat_sweep"][names[kind]]
            kernels.append(entry)
    ring_kernels = {
        "fwd": ("ring_fwd_block", "ring_fwd_block",
                "distributed_llm_training_benchmark_framework_tpu_torch/csrc/ring_fwd.cu",
                "distributed_llm_training_benchmark_framework_tpu/ops/ring_attention.py:77"),
        "dq": ("flash_bwd_dq fp32 (ring)", "flash_bwd_dq_ring", sources["dq"][0],
               "distributed_llm_training_benchmark_framework_tpu/ops/ring_attention.py:231"),
        "dkv": ("flash_bwd_dkv fp32 (ring)", "flash_bwd_dkv_ring", sources["dkv"][0],
                "distributed_llm_training_benchmark_framework_tpu/ops/ring_attention.py:252"),
    }
    for key, sh in RING_SHAPES.items():
        layout = "zigzag" if sh["zigzag"] else "contiguous"
        for kind, (label, count, source, replaces) in ring_kernels.items():
            r = ring_timing[key][kind]
            entry = {
                "name": f"{label} [{sh['row']}: BH {sh['B'] * sh['H']} Sl {sh['S'] // sh['n']}"
                        f" Dh {sh['D']} causal {sh['causal']} rate {sh['rate']} {layout},"
                        f" shard {RING_TIMED[0]} hop {RING_TIMED[1]}]",
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": ring_launches[sh["row"]][count],
                **{nm: r[nm] for nm in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms")},
            }
            entry.update({nm: r[nm] for nm in OPTIONAL_KEYS if nm in r})
            kernels.append(entry)
    sh = FWD_SHAPES["f"]
    for n in fv.VARIANTS:
        r = fwd_timing[n]
        kernels.append({
            "name": f"{n} [microbench (f): BH {sh['BH']} S {sh['S']} Dh {sh['D']} non-causal"
                    " rate 0]",
            "route": "cuda",
            "source": FWD_SOURCE,
            "replaces": f"scripts/microbench_flash_fwd.py:{FWD_REPLACES[n]}",
            "launches": mb_launches[n],
            "launches_on": "the microbench path (phase 11)",
            **r,
        })
    for key, r in tp_timing.items():
        sh, spec = r["shape"], TP_ROWS[key]
        n = tp_launches[f"{key}.zero2"]
        kernels.append({
            "name": f"flash_fwd_bhv [{key} row at tensor_parallel {TP_WIDTH}, one rank: BH "
                    f"{sh['BH']} ({TP_SHAPES[key]['B']} x {TP_SHAPES[key]['H'] // TP_WIDTH} "
                    f"heads) S {sh['S']} Dh {sh['D']} causal {sh['causal']} rate {sh['rate']}]",
            "route": "cuda",
            "source": sources["fwd"][0],
            "replaces": sources["fwd"][1],
            "launches": n,
            "launches_per_step": n / TP_STEPS,
            "launches_on": "each rank of the zero2 tp-2 run (phase 16 (b))",
            **{nm: r[nm] for nm in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "device_ms", "library_device_ms",
                                    "offset_instance_device_ms")},
        })
    log("[12] the arms at world 1 (parity row; tokens/s measure each wrapper's overhead on "
        "one card, nothing about scaling): " + json.dumps({
            arm: {"remat": a["group"]["remat"], "world_size": a["group"]["res"].world_size,
                  "tokens_per_sec_no_group": a["plain"]["res"].tokens_per_sec,
                  "tokens_per_sec_group": a["group"]["res"].tokens_per_sec,
                  "peak_gb_no_group": a["plain"]["res"].peak_hbm_gb,
                  "peak_gb_group": a["group"]["res"].peak_hbm_gb,
                  "loss_max_rel_diff": a["loss_rel"], "launches_group": a["group"]["launches"]}
            for arm, a in arms.items()}) + f" on {smi}")
    log(f"[end] total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
