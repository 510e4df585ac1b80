#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each on its own lines; any failure exits nonzero:

1. device    — the card's name and power limit (``nvidia-smi``); no CUDA
               device is a failure.
2. build     — compile every hand-written kernel from ``src/`` (one
               ``nvcc`` per source, concurrently) and print the build
               seconds and the ``-Xptxas -v`` report.
2a. lint     — host only, alone: ``python -m repro_torch.analysis
               src/repro_torch chip_smoke.py --fail-on-findings`` in a
               subprocess (any finding fails; files, counts and
               suppressions printed); RPL004's static shared bytes of
               every ``__global__`` of the seven sources held against
               ptxas's ``bytes smem`` for each built entry (demangled
               with ``cu++filt``), equal once rounded up to the source's
               ``extern __shared__`` alignment (the dynamic region starts
               there), every kernel matched; RPL004's default budget
               against the card's ``cudaDevAttrMaxSharedMemoryPerBlock
               Optin`` (read with ``ctypes`` from the toolkit's CUDA
               runtime): a card reporting less fails.
3. kernels   — hold each decode kernel against its plain PyTorch version
               in bf16 at the main path's shapes and time the kernel, the
               plain version, the bound and a library yardstick: K1
               flash_decode (dense slot cache; G = 1, 5, 6 and 8, and a
               4096-row slot among short ones at G = 8; gemma3-12b's
               head_dim 256 at G = 2 on 392- and 2048-row slots;
               phi-3-vision's head_dim 96 and whisper's 64, both G = 1
               (H = Hkv = 32 and 20); each
               with the partition count it took and also timed with L2
               flushed before each call, and its ptxas registers and
               spills per instantiation, K2's too), K2 paged_flash_decode
               (block table into a page pool, with a parked slot; the
               main path, GQA, one 4096-row slot among short ones,
               gemma3's head_dim 256 through 50- and 256-block tables,
               phi-3-vision's and whisper's shapes through 50-block
               tables (whisper's row printed only: it never pages),
               each also through K1 on the same rows gathered, both
               also with L2 flushed, with each wrapper's host time a
               call).
4. retrieval — the batched retrieval path at the SQuAD scale (20,000
               synthetic paragraphs, 64 questions, k = 10):
               ``DenseIndex.topk_batch`` (K3 dense_topk) and
               ``BM25Index.scores_batch`` (K5 on the index's nonzeros,
               ``device_csr``, uploaded once and timed) once each,
               counted; each held against its plain version in float32
               and the host's numpy retrieval (ids identical but for ties
               within 1e-5), and timed; K5's whole call (its row's time)
               and its kernel alone (``kernel_ms``), also on a dense
               ``tf`` (its compaction timed with it), beside two
               yardsticks (cuBLAS ``wq @ sat.T`` and ``torch.sparse.mm``
               on a CSR of the saturated values) and three bounds (what
               the batch's terms need, every nonzero, the dense matrix);
               K3 again on 1,048,576 seeded unit rows (1 GiB).  K3's
               HGMMA (wgmma) count in its SASS first (none is a failure);
               each K3 row with its bound on the TF32 tensor cores it
               feeds beside the float32 CUDA-core basis of the kernel it
               replaced, the wrapper's time a call on the host's clock
               and the kernels one call launches (one); then K3 across
               its contract against the plain version: k = 64 (timed
               beside k = 10), Q = 5 and 200, D < 64, E = 768, and rows
               duplicated into other tiles and blocks (ids exact).
               Distributed retrieval over a serving mesh of one NCCL
               rank: ``DistributedDenseIndex`` and ``DistributedBM25``
               over the same corpus and questions, one K3 and one K5
               launch, the ids of ``topk_batch`` and of the stable top-k
               of ``scores_batch`` (but for ties within 1e-5).
4a. grouped gemm — K7 (the MoE layers' grouped product and its dX) and
               K8 (its dW), ``csrc/grouped_gemm.cu``, against their
               plain versions in bf16 and float32 at dbrx-132b's and
               deepseek-v3-671b's prefill (4 x 384 tokens) and decode (8
               slots) shapes, dbrx's training shape (4 x 1024), a split
               with empty groups, one with every row in one group and
               one whose every group holds under 64 rows: forward and,
               against autograd of the plain version, dX and dW (not in
               float32 at deepseek's prefill), K7 and K8 each repeating
               bit for bit; in bf16 each shape timed warm and flushed
               beside the plain version, its bound and
               ``torch._grouped_mm`` (the yardstick, for K8 in its 2-D
               form that splits the rows by group; the port never calls
               it), with the kernel's time as a multiple of each;
               ptxas's registers and spills (a spill fails) and the
               library's HGMMA (wgmma) and HMMA (mma.sync) counts (no
               HGMMA, or any HMMA, fails).
5. small     — the SMOKE decoder in bf16: prefill + decode on the card
               against the same weights on the host; then every weight
               NaN, 2 requests on 2 slots: the executor's isfinite test
               on the card trips both and the scheduler quarantines them;
               with ``health_checks=False`` nothing trips.
6. router    — the paper's router on the FULL testbed
               (``configs/paper_slo_router.py``: 800 / 200 questions over
               600 paragraphs, 30 epochs): ``run_experiment`` builds the
               offline log on the host (its seconds printed) and trains
               the six policies of Table 1 on the card (each training's
               wall and ms an epoch), prints the grid and checks the
               paper's failure mode (cheap Argmax-CE refuses > 0.5 with
               acc < 0.2 and a reward under best-fixed's; quality_first
               Argmax-CE within 0.1 of best-fixed, refusing < 0.8; the
               constrained objective (cap 0.45) refusing less with a
               higher acc, on the mean over the draws of seeds 0..19,
               trained in 4 spawned processes at once, each draw
               printed: at this cap one draw decides it); then
               quality_first Argmax-CE trained from one host-drawn init on
               the card and on the host (at most 2 of 200 eval actions
               may disagree; the largest parameter difference and each
               disagreeing action's top-two logit margin printed) and the
               time to route a micro-batch; one ``ConditionedPolicy`` for
               both profiles (cheap must refuse more); the quickstart's
               ``Gateway`` + ``SimulatorBackend`` under cheap, 60 requests.
7. main      — ``qwen1.5-32b`` FULL (64 layers, d_model 5120, seeded
               bf16 weights) served through ``Gateway.serve`` on the
               dense slot cache, with the bm25, dense and hybrid
               retrievers behind a shared retrieval cache: 8 requests
               under ``FixedPolicy(0)``, 8 routed by the quality_first
               router trained in phase 6 (both bm25).  Checks that K1
               was launched 64 times per decode step, that no slot was
               quarantined, that every generating request produced a
               token and that at least one of the router's 8 generated.
8. profile   — 8 more requests under ``torch.profiler``: the card's busy
               and idle share and the kernels that take its time.
9. hybrid    — the same engine under the ``hybrid9`` action space:
               ``FixedPolicy(3)`` (dense retrieval) and ``FixedPolicy(7)``
               (bm25 + dense fusion), 4 questions twice each; checks
               cache hits, no degraded lookup, K1 launches, and prints
               this phase's decode steps on their own lines.
9a. open loop — the closed loop's served rate c and request-latency
               p50 set deadline_ms = 2 x p50 rounded up to 100 ms; seeded
               Poisson traces (24 requests, quality_first, questions of
               their own) at 0.5, 0.75, 1.0 and 1.5 x c replayed in real
               time through ``AsyncGateway`` + the stream protocol on the
               same engine, served by the gateway's background thread:
               per rate the nominal, trace and submitted rates, served,
               shed, forced refusals, depth clamps, goodput, latency
               p50/p99, first-token p50, K1 launches; the highest rate
               whose goodput fraction meets the latency objective (0.90).
               Checks every request resolved, the thread on cuda:0's
               default stream and stopped, K1 64 times a decode step.
9b. chaos    — the dense engine freed; ``benchmarks/chaos_bench.py``'s
               four plans (no faults, retriever brownout, executor fault
               burst, NaN storm) in virtual time, 16 requests each on a
               fresh engine of the main path's shape: counters printed;
               every request resolves, no_faults counts nothing and its
               tokens equal a features-off run's, the brownout degrades
               and fails none, the burst's transient completions are
               retried or counted faulted, the storm quarantines its
               plan's slots; K1 64 times a decode step.
9c. padded   — ``Engine.generate`` (per-call cache, K1) against
               ``ContinuousEngine.generate_many`` on 8 prompts of 384
               tokens: tokens identical, walls and decode steps; then a
               batch of 8 through ``Gateway.serve`` over ``EngineBackend``.
10. paged    — the dense engine's buffers freed, the same 16 requests
               on the paged engine (page size 8, 400 pages, prefix
               sharing): K2 launched 64 times per decode step, K1 only
               64 times for each admission group whose suffix is one
               token (every page of its prompts but the last token a
               prefix hit: that prefill's single query takes the decode
               branch over the dense scratch), every request served,
               prompt tokens served from shared pages, no deferral;
               prints the prefix-hit rate, forks, peak pages, ms per
               decode step and the greedy tokens that agree with the
               dense phase's; then the 1.0 x c trace of 9a on the paged
               engine (the same launch accounting), with its prefix-hit
               rate.
11. int8     — the paged engine with the int8 KV cache, 8 requests under
               ``FixedPolicy(0)``: K2 launches, no quarantine, tokens.
11a. sharded — ``make_serving_mesh("dp=1")`` over an NCCL process group
               of one rank (its version printed): the first 8 requests
               of phase 7 through ``ShardedExecutor`` on the dense slot
               cache, then the paged pool, on phase 7's weights (views,
               no second draw), each in turns with the single-device
               executor (single, sharded, sharded, single): tokens
               identical to phase 7's, K1 / K2 64 times a decode step,
               the decode steps of the turns, the collectives of a decode
               step counted, a decode chunk under
               ``set_sync_debug_mode("error")``; in each dense turn one
               admission group (prefill + commit) of 4 seeded
               384-token prompts timed with CUDA events, the sharded
               executor prefilling all 4 rows (one batch shard: no row
               split) and its admission issuing no collective of its own
               (only the apply's over ``model``; no all-to-all), the
               first tokens of every turn equal; then ``--mesh dp=1`` on
               the serve CLI (``--variant smoke``) printing the lines of
               the run without it.  One more decode step of the 8
               slots over 392-row caches through the tensor-parallel
               apply: its collectives, K1 launches, peak memory and its
               rise, and ms, for phase 16a2.  The process group is
               destroyed at the end.
12. train    — the serving weights freed, ``make_train_step`` (fused
               loss, plain attention, AdamW) for 8 steps on
               ``qwen1.5-32b`` at full width with its depth cut 64 -> 4
               (seeded bf16 weights, ``remat="full"``), over the port's
               ``LMDataset`` at batch 4 x seq 1024: finite loss and
               gradient norm, step 0's loss equal to
               ``forward_train_loss`` under ``no_grad``, params moved,
               the loss falling, no K4 launch; ms per step, tokens/s,
               model FLOPs/s, peak memory, the AdamW update and the
               forward timed alone, the device time of one step by
               kernel, and one loss and gradient under each of remat
               none / full / dots (the same numbers, each mode's peak
               memory).
13. eval     — on the trained params, a held batch through
               ``make_eval_step`` with K4 and with the plain attention:
               K4 launched 4 times (once a layer), the losses agreeing;
               ``forward_train_loss`` under ``no_grad`` with K4; a train
               step through K4 raising the gradient guard.
14. mamba serve — ``mamba2-130m`` FULL (24 layers, d_model 768, seeded
               bf16 weights, not cut) through ``Gateway.serve`` on the
               dense slot engine, 8 + 8 requests as in phase 7 (the
               trained router routes the second 8): no kernel launched
               (the cached prefill and the O(1) decode step never take
               K6), every request served, each engine token the greedy
               choice of a per-request prefill/decode loop on the card;
               decode step and prefill ms, peak memory.
15. mamba eval — a held batch of 4 x 2048 through ``make_eval_step``
               with K6 (24 launches a call) and with the plain scan: the
               losses agreeing; both timed.
16. mamba train — ``make_train_step`` for 8 steps at 4 x 2048 with the
               chunk cut 256 -> 64: finite, falling losses, no K6
               launch; ms per step, tokens/s, peak memory; the gradient
               norm at chunk 256 (NaN, as the reference's); a train step
               through K6 raising the gradient guard.
16t. mamba tp — Mamba2 under tensor parallelism on phases 14-15's
               ``mamba2-130m`` FULL weights: K6 on each of the 16
               ranks' sub-heads at mp = 16 (layer 0's scan inputs on
               phase 15's held batch, each rank's (4, 2048, 3, 32)),
               each against its plain version and all 16 reassembled
               against the whole call, one jamba rank's (16 heads of
               64, N 16) too; rank 0's launch timed beside its bound
               (its row in the kernels line); then a one-rank NCCL
               serving mesh: ``ShardedExecutor`` serving phase 14's
               first 8 requests with phase 14's tokens,
               ``make_sharded_eval_step`` with K6 (24 launches) giving
               phase 15's loss, the collectives of a decode step and an
               eval call by kind and their ms beside the single-device
               ones.
16a0. train families — phase 12's checks and phase 13's eval for every
               other family, each after the previous model is freed
               (``TRAIN_FAMILIES``, lr 1e-4, 8 steps): ``dbrx-132b`` cut
               to 1 of 40 layers (one MoE layer, 16 experts top-4) at 4
               x 1024, ``minicpm3-4b`` FULL (MLA) at 4 x 1024,
               ``deepseek-v3-671b`` cut to its 3 dense layers plus the
               MTP layer (autograd through MLA and MTP) at 4 x 1024,
               ``gemma3-12b`` cut to 12 of 48 layers (2 global) at 2 x
               2048 (the window of 1024 masks), ``phi-3-vision-4.2b``
               FULL at 4 x (576 image patches + 448 tokens) and
               ``whisper-large-v3`` FULL at 4 x 384 tokens with 4 x
               1500 frames; model FLOPs/s over the active parameters;
               each eval launching K4 once for each layer the
               reference's gate lets through (1, 0, 0, 2, 32, 32);
               dbrx's train steps through the grouped GEMM, K7 3 x 3
               times a step (forward, rematerialized forward, dX) and K8
               3 times (dW).  Then qwen at 4 layers, one step at microbatches 1, 2 and 4 from
               the same seeded init: loss, gradient norm and the updated
               leaves agreeing, the activations beside the float32
               accumulators falling.
16a1. sharded train — multi-GPU training on one card: a dp = 1 mesh
               over an NCCL group of one rank, each layer's weights
               gathered (a copy) inside its rematerialized body.
               ``make_sharded_train_step`` for 8 steps on phase 12's
               qwen1.5-32b (4 layers, 4 x 1024, the same seeded weights
               and batches): losses and gradient norms within 1e-3 of
               phase 12's single-device run (the largest gap printed),
               the collectives a step by kind, ms a step beside phase
               12's and their ratio, peak memory and the peak of live
               gathered weights; ``make_sharded_eval_step`` with K4 on
               the trained shards (K4 4 times) beside ``make_eval_step``
               with K4 and without.  Then 16a0's dbrx-132b (1 layer)
               through ``make_ep_moe_fn`` at capacity 4.0 = E / k: no
               routed row dropped, each step's loss and gradient norm
               within 1e-3 of the routed form's (K7 / K8) at the same params
               (the whole run within 5e-2 of 16a0's: bf16 sums in
               another row order drift apart), 6 ``all_to_all`` a step;
               and 3 steps at capacity 1.25 from the same init, the
               share of routed rows dropped printed.
16a2. dry run — ``repro_torch.launch.dryrun`` in subprocesses started
               before phase 16a0, so that their tracing (host cores
               only) runs beside 16a0 and 16a1 (the seconds won back
               printed), as rank 0
               of a one-rank fake world on fake CUDA tensors (nothing
               allocated on the card): 16a1's qwen train step (4 layers,
               4 x 1024, dp = 1) and 11a's decode step (qwen FULL, 8
               slots, 392-row caches).  Its collective census and K1's
               would-be launches (the census's count of K1's fake-rule
               op; no kernel launches in a trace) equal to the real
               steps' collectives and launches, its predicted peak and
               temp bytes within 10 % (or 256 MiB) of
               ``max_memory_allocated`` and its rise above the resident
               bytes; the roofline's three terms and MODEL_FLOPS (as a
               share of 989 TFLOP/s) beside each step's measured ms.
               Then the head_dim route (kv heads, or heads too, that the
               production mesh's mp = 16 does not divide) and the MLA
               route, and the Mamba2 route: qwen FULL's decode_32k and
               train_4k, and command-r FULL's, minicpm3-4b FULL's,
               deepseek-v3-671b FULL's, mamba2-130m FULL's,
               jamba-1.5-large-398b FULL's and whisper-large-v3 FULL's
               (its cross layers on head_dim) decode_32k, unpadded, traced
               as rank 0 of the fake 16 x 16 world on fake CUDA tensors
               and, concurrently, on fake CPU tensors (two more
               subprocesses; a fourth traces 16c's one-rank
               MLA decode steps for their census): census, collective bytes,
               per-rank peak and temp, FLOPs and K1's would-be launches
               printed, the census and bytes equal on both and K1 0 on
               both (the split layers take the plain route on either);
               and the route's split-score decode attention at qwen
               FULL's decode shape (B = 8, L = 392 ragged, H = 40, D =
               128, bf16), its float32 partial scores all-reduced over a
               one-rank NCCL group: equal to the plain attention, within
               the kernel tolerance of K1, each timed.
16a. moe/gqa serve — the mixture-of-experts and GQA families at their
               published widths through ``Gateway.serve``, one after the
               other, each after the previous model is freed:
               ``dbrx-132b`` (16 experts top-4 through the grouped GEMM,
               48 heads over 8 kv heads: G = 6) cut to 10 of its 40
               layers, and ``command-r-35b`` FULL (64 over 8: G = 8), on
               the dense engine (K1) and the paged engine (page 8, 400
               pages; K2), 8 + 8 requests as in phase 7: K1 / K2 exactly
               layers x decode steps, K7 exactly 3 x MoE layers x
               (prefills + decode steps), every request served, the dense
               engine's greedy tokens repeating bit for bit when its
               first batch is served again, a decode chunk under
               ``torch.cuda.set_sync_debug_mode("error")``; the decode
               step (median, CUDA events) beside its weight-read bound
               (an MoE layer's experts as many as a step's rows reach),
               each admission group's prefill beside its routed-operation
               bound, peak memory.  Phase 3 holds K1 and K2 at both
               models' shapes (H 48 and 64 over 8 kv heads).
16b. gemma3 serve — ``gemma3-12b`` FULL (48 layers, 5 local with a
               sliding window of 1024 to 1 global, head_dim 256, G = 2;
               seeded bf16, not cut) through ``Gateway.serve`` as in
               16a on the dense engine (K1), the dense engine with the
               ring cache (``window_ring_cache``) and the paged engine
               (K2): K1 / K2 exactly 8 global layers x decode steps (the
               local layers decode through the plain windowed attention,
               as the reference's gate sends them), every request
               served, the dense tokens repeating bit for bit, dense and
               ring decode chunks under ``set_sync_debug_mode("error")``;
               decode step, prefill and peak memory beside their bounds.
               Then the long case, where the window binds: 8 seeded
               prompts of 1280-1536 tokens, max_len 2048, 8 greedy steps
               with the full-length cache and with the ring (1024 rows a
               local layer): each step's max |logit gap| and agreeing
               tokens, both caches' GiB; bf16 prefill logits within
               2e-2 of max |logit|, and a float32 witness (the weights
               converted, K1 swapped for its plain version) within 1e-4
               at every step.
16c. mla serve — multi-head latent attention, which reaches no kernel
               (the reference's MLA has no kernel branch and does not
               page): ``deepseek-v3-671b`` SMOKE in float32 on the card
               against the host (naive and absorbed decode, training
               and MTP logits, 1e-4 of max |logit|); then
               ``minicpm3-4b`` FULL (62 layers, seeded bf16, not cut)
               with the naive and the absorbed decode, and
               ``deepseek-v3-671b`` at full width cut to its first 5 of
               61 layers (3 dense, 2 MoE of 256 experts top-8 with a
               shared one) with the naive decode, each through
               ``Gateway.serve`` on the dense engine as in 16a: K1, K2
               and K4 launched exactly 0 times, K7 3 times in each of
               deepseek's 2 MoE layers a forward, every request served,
               the tokens repeating bit for bit, a decode chunk under
               ``set_sync_debug_mode("error")``; decode step, prefill
               and peak memory beside their bounds.  minicpm3's naive
               and absorbed runs driven through prefill / decode: their
               gaps in bf16, and in float32 within 2e-3 at every step.
               deepseek's ``forward_train_loss`` on 2 x 512 tokens with
               and without MTP: both finite, different.  For each model,
               naive and absorbed, one decode step of 8 slots over
               392-row caches (a prefill of seeded prompts) through the
               tensor-parallel apply on a one-rank NCCL group and on one
               device: the next tokens equal, the collectives equal to
               16a2's one-rank census of the step, deepseek's K7
               launches equal, both steps' ms printed.
16d. vision / audio serve — phi-3-vision and whisper SMOKE in float32 on
               the card against the host (with the image or the frames;
               phi-3 also at head_dim 96); then ``phi-3-vision-4.2b``
               FULL (32 layers, head_dim 96, seeded bf16, not cut)
               through ``Gateway.serve`` as in 16a on the dense (K1),
               paged (K2) and paged int8 (K2) engines, K1 / K2 exactly 32
               x decode steps, and an image prefill (4 x 576 patches +
               384 tokens) beside its operations bound, then 8 greedy
               steps through K1 at D = 96 beside a run with K1 swapped
               for its plain version; ``whisper-large-v3`` FULL (32
               encoder + 32 decoder layers, not cut) on the dense engine
               only (K1 exactly 32 x steps, K2 never; the paged pool's
               refusal shown), its decode step beside the decoder's
               weights plus the cross cache, then an audio prefill (4 x
               1500 frames + 384 tokens) beside the encoder's operations
               bound and 8 steps that read the cross cache.
16w. whisper tp — Whisper under tensor parallelism, in two parts where
               the weights already live.  In 16a0's whisper entry, on its
               trained weights and held batch: K4 on each of the 16
               ranks' blocks of heads at mp = 16 (layer 0's q, k and v
               as ``_gqa_head_dim`` holds them after its gather: 2 heads
               on ranks 0-3, 1 on ranks 4-15, each a view), each against
               its plain version and all 16 reassembled against K4's
               whole (4, 384, 20, 64) call, rank 0's and rank 4's
               launches timed beside their bounds and SDPA (their rows
               in the kernels line); then ``make_sharded_eval_step``
               with K4 on a one-rank NCCL mesh: 32 launches, 16a0's
               loss, its collectives and ms in turns with
               ``make_eval_step``.  In 16d's whisper block:
               ``ShardedExecutor`` on the one-rank mesh serves 16d's
               first 8 requests with 16d's tokens (K1 32 x steps), and
               a decode step's collectives and ms in turns with the
               single-device step.  Its seconds by part are printed.
17. serve cli — ``repro_torch.launch.serve.main`` in this process,
               ``--backend continuous --variant full`` (qwen1.5-32b
               FULL, seeded bf16 weights, 8 slots, prompts of 192, 8 new
               tokens), each run building the FULL testbed, its router
               and its engine as the CLI does: the closed loop (16
               requests, paper5, quality_first, trace and metrics files)
               and the open loop (24 seeded Poisson arrivals at 40/s,
               deadline 250 ms, virtual time). Checks: every request
               served or resolved, the reward finite, prefills and decode
               chunks, K1 64 times a decode step, the telemetry files
               non-empty; prints each run's wall, testbed build, router
               training and decode step (CUDA events).
18. cli      — ``python -m repro_torch.launch.train`` twice at once, in
               subprocesses on the card: qwen SMOKE and the defaults
               (mamba2-130m SMOKE), 20 steps each: each loss falls, and
               each npz checkpoint loads back equal through
               ``load_checkpoint``.  Beside them, from before phase 17's
               open loop (virtual time) starts to after they end (after
               every timed row above):
19. paper benches — ``python -m repro_torch.benchmarks.run`` with the
               paper's ten benches (Table 1, Figures 1-3, mitigation,
               the objective ablation over paper5 and hybrid9, OPE, the
               conditioned policy, the Pareto sweep, 5 seeds) ``--device
               cuda`` in a subprocess: exit 0, ten CSV rows, every
               artifact written by this run, every number finite; prints
               Table 1, Figure 1's two shares, the mitigation, both
               objective grids and the seeds' means +- std.

The kernel checks (phase 3) include K4 flash_attention: first the count
of HGMMA (wgmma) instructions in its SASS (``cuobjdump -sass``; none is a
failure) and its ``-Xptxas -v`` lines (registers and spills per head
dim); then the training shape (B=4, S=1024, H=Hkv=40, D=128, causal),
phi-3-vision-4.2b's eval shape (B=4, S=1024, H=Hkv=32, D=96) and
gemma3-12b's (B=2, S=2048, H=16, Hkv=8, D=256), GQA G=2, a non-causal
ragged case, D=64, a causal Sq != Skv case and D=96 / 256 ragged and
causal, each against its plain version; the first three are timed warm
and with L2 flushed beside their bounds and SDPA.  Kernel times are
CUDA-event means of back-to-back calls after the card has been given a
head start (a spin longer than the host's enqueueing), so that they time
the card and not the host's launch rate.  And K6
ssd_chunk_scan: mamba2-130m's evaluation shape (B=4, S=2048, H=24,
hd=64, N=128, chunk 256, bf16, A_log = 0), G=2 H=8, chunks 64 and 128,
S < chunk, the reference test's shape and rows off 16-byte boundaries
(strided x, B, C; N=18), each against its plain
version in float32 within 5e-5 of max |y|; first the count of HMMA
(mma.sync) instructions in its SASS (none is a failure); the evaluation
shape is timed beside its bound -- bytes, or its operations on the bf16
tensor cores it feeds, with the float32 CUDA-core basis printed beside
-- and the device time of each of its three launches (no PyTorch call
computes the scan: no library time).

The last three lines are the JSON kernel table, the card's name and
power limit (``nvidia-smi``), and the ``{"ok": true, ...}`` device
record.  Imports nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import multiprocessing
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM dense TF32 tensor cores
FP32_OPS_PER_S = 67e12         # H100 SXM float32 on CUDA cores
NUM_SLOTS, PREFILL_BATCH = 8, 4
MAX_PROMPT_LEN, MAX_NEW_TOKENS = 384, 8
PAGE_SIZE, NUM_PAGES = 8, 400  # max_len 392 = 49 pages; tables of 50
KERNEL_TOL = 2e-2  # bf16 output: |out| <~ 3 rounds at 2^-8 relative, plus
#                    the kernel's fp32 sums in another order
RETRIEVAL_TOL = 1e-5  # float32 scores: the same sums in another order
SQUAD_PARAGRAPHS, SQUAD_QUESTIONS, TOP_K = 20000, 64, 10
BIG_DOCS = 1 << 20    # 1 GiB of float32 rows at E = 256
BM25_HOST_QUESTIONS = 8  # BM25Index.topk saturates all of tf per question
# training: full width, depth cut so params, gradients and AdamW moments
# (12 B a param) fit one 80 GB card beside the activations
QWEN = "qwen1.5-32b"
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4, 1024, 4, 8
# bf16 weights of ~0.02 move by more than half a rounding step; the
# norms' ones would not (3e-4 against 2^-8)
QWEN_WATCHED = ("blocks/p0/mlp/w_down/0", "blocks/p0/attn/bq",
                "embed/:4096")
MICROBATCHES = (1, 2, 4)
# the families' learning rate (qwen's phase keeps 3e-4): at 3e-4 after a
# warmup of 2 steps deepseek-v3-671b's 7168-wide seeded stack overshoots
# (loss 17.0 -> 33.0 at step 2, 21.0 at step 8 on an H100); the
# reference's own schedule warms up over 100 steps
FAMILY_LR = 1e-4
# every served family trained on the card: (arch, layers kept (None:
# FULL, not cut), batch, seq, watched leaves).  Each train state is 12 B
# a param: dbrx-132b's one MoE layer of 16 experts (3.88 B params, 46.5
# GB), minicpm3-4b FULL (4.07 B, 48.9 GB), deepseek-v3-671b's 3 dense
# layers and its MTP layer (4.29 B, 51.5 GB: one of its MoE layers is
# 11.5 B, 138 GB), gemma3-12b's first 12 layers (two global; 3.70 B,
# 44.4 GB) at 2 x 2048 so that the local layers' window of 1024 masks,
# phi-3-vision-4.2b FULL (3.74 B, 44.8 GB; 576 image patches + 448
# tokens a row) and whisper-large-v3 FULL (1.96 B, 23.5 GB; 384 tokens
# and 1500 frames a row, its encoder not rematerialized, as the
# reference's)
TRAIN_FAMILIES = (
    ("dbrx-132b", 1, 4, 1024, ("blocks/p0/moe/w_down/0/0",
                               "blocks/p0/moe/router/0",
                               "blocks/p0/attn/wq/0")),
    ("minicpm3-4b", None, 4, 1024, ("blocks/p0/attn/wkv_a/0",
                                    "blocks/p0/attn/wq_a/0",
                                    "blocks/p0/mlp/w_down/0")),
    ("deepseek-v3-671b", 3, 4, 1024, ("prefix/0/attn/wkv_a", "mtp/w_comb",
                                      "mtp/layer/attn/wkv_a")),
    ("gemma3-12b", 12, 2, 2048, ("blocks/p0/attn/wq/0",
                                 "blocks/p5/attn/wq/0",
                                 "blocks/p5/mlp/w_down/0")),
    ("phi-3-vision-4.2b", None, 4, 1024, ("projector/w1", "projector/w2",
                                          "blocks/p0/attn/wq/0")),
    ("whisper-large-v3", None, 4, 384, ("encoder/attn/wq/0", "enc_pos",
                                        "blocks/p0/cross/wq/0")),
)
# the sharded step against the single-device one at dp = 1: the same bf16
# arithmetic (a gather or reduce-scatter of one rank copies), but for
# bf16 gradients summed by atomics in an order that may change from run
# to run (REMAT_RTOL's reason)
SHARDED_RTOL = 1e-3
DBRX = "dbrx-132b"
# the EP moe_fn's capacity factors on the card: E / k = 16 / 4 (no drop),
# and the reference's default, 3 steps from the same init
EP_CAPACITY, EP_DROP_CAPACITY, EP_DROP_STEPS = 4.0, 1.25, 3
# the EP run against the routed form's whole run (16a0's: K7 / K8): step 0
# agrees
# (2.3e-5 of its gradient norm), then the expert products' bf16 sums in
# another row order, carried by 8 Adam steps at lr 1e-4, drift the
# trajectories apart (4.5e-3 of the loss, 1.2e-2 of the gradient norm
# by step 8 on an H100); each step is held at SHARDED_RTOL against the
# routed form at the same params instead
EP_DRIFT_RTOL = 5e-2
EVAL_RTOL = 5e-3  # bf16 activations: K4 rounds P to bf16 and sums in
#                   another order than the plain float32 attention
REMAT_RTOL = 1e-3  # the same forward; bf16 gradients summed by atomics in
#                    an order that may change from run to run
SSD_RTOL = 5e-5   # of max |y|, float32 before the final rounding: the same
#                   sums in another order (the reference's kernel test's)
MAMBA = "mamba2-130m"
MAMBA_EVAL_SEQ, MAMBA_BATCH = 2048, 4
MAMBA_TRAIN_CHUNK, MAMBA_TRAIN_STEPS = 64, 8
MAMBA_TP_MP = 16        # the production mesh's model axis (phase 16t)
MAMBA_TP_LOSS_RTOL = 1e-5  # one rank: the same logits, the loss's sums
#                            taken over the batch group
MAMBA_EVAL_RTOL = 1e-3  # bf16 activations; both scans sum in float32
WHISPER_TP_MP = 16        # the production mesh's model axis (phase 16w)
WHISPER_TP_LOSS_RTOL = 1e-5  # one rank: the same logits, the loss's sums
#                              taken over the batch group
# phase 16w's results, for the kernel table: K4's rows at the rank
# blocks and the launches of the 16 ranks' route, the one-rank sharded
# eval's K4 launches, its seconds by part
WHISPER_TP: dict = {"rows": [], "block_launches": {}, "launches": {},
                    "seconds": {}}
TOKEN_GAP_RTOL = 2e-2   # of max |logit|: bf16 rounding of a batch of 8
#                         against a batch of 1
ROUTER_CAP = 0.45        # the constrained objective's refusal cap
ROUTER_SEEDS = 20        # draws the constrained objective is held over
ROUTER_WORKERS = 4       # processes the draws train in, a card context each
ROUTER_MAX_DISAGREE = 2  # of 200 eval actions, card vs host training: the
#                          same float32 steps, sums in another order
# the open loop: Poisson traces at these multiples of the closed loop's
# served rate, replayed in real time through AsyncGateway's thread
OPEN_LOOP_RATES, OPEN_LOOP_REQUESTS = (0.5, 0.75, 1.0, 1.5), 24
# chaos: benchmarks/chaos_bench.py's rate, deadline and pump quantum (all
# virtual time), retry policy and breaker settings; 16 requests a
# scenario, the CPU twins' size (tests/test_torch_faults.py), where the
# bench's quick run takes 24: each plan's window still falls inside the
# run, and the phase takes two thirds of the time
CHAOS_REQUESTS, CHAOS_RATE = 16, 120.0
CHAOS_DEADLINE_MS, CHAOS_QUANTUM_S = 800.0, 0.01
CHAOS_BREAKER = dict(window=8, min_calls=4, failure_threshold=0.5,
                     cooldown=4)
# the MoE / GQA phase: each config at its published widths, with the
# depth it keeps (dbrx-132b's 40 layers are 131 B params, 244 GiB in
# bf16; 10 of them and the tied embedding are 33.2 B, 61.9 GiB);
# command-r-35b FULL (30.3 B, 56.4 GiB) is not cut
MOE_GQA_MODELS = (("dbrx-132b", 10), ("command-r-35b", None))
# gemma3-12b FULL (11.77 B params, 21.91 GiB in bf16) is not cut; its
# long case: prompts past the local layers' window of 1024, decoded with
# the full-length cache and with the ring cache
GEMMA = "gemma3-12b"
LONG_MIN, LONG_MAX, LONG_MAX_LEN, LONG_STEPS = 1280, 1536, 2048, 8
GEMMA_K1 = "gemma3-12b, D=256, G=2"
GEMMA_K1_LONG = "gemma3-12b 2048-row slot, D=256, G=2"
# the vision and audio families, FULL and not cut: phi-3-vision-4.2b (3.74
# B params, 7.47 GB in bf16; 32 layers of 32 heads = kv heads at head_dim
# 96) and whisper-large-v3 (1.96 B; 32 encoder and 32 decoder layers of
# 20 heads at head_dim 64); their stub frontends' embeddings are seeded
PHI3, WHISPER = "phi-3-vision-4.2b", "whisper-large-v3"
PHI3_K1 = "phi-3-vision-4.2b, D=96, G=1"
WHISPER_K1 = "whisper-large-v3, D=64, G=1"
# K4 at the eval shapes of the two families past D = 64 / 128
PHI3_K4 = "phi-3-vision-4.2b eval, D=96, G=1"
GEMMA_K4 = "gemma3-12b eval, D=256, G=2"
MODALITY_BATCH, IMAGE_TEXT_TOKENS, MODALITY_STEPS = 4, 384, 8
MODALITY_F32_RTOL = 1e-4  # of max |logit|: SMOKE float32 on the card and
#                           on the host, the same sums in another order
RING_LOGIT_RTOL = 2e-2  # of max |logit|: the same function, its float32
#                         sums over 1024 ring rows or 2048 cache rows (S
#                         fresh rows or 2048 at prefill) in other orders,
#                         rounded to bf16 at every layer
RING_F32_RTOL = 1e-4    # of max |logit|: the float32 witness, the same
#                         sums in other orders, no bf16 rounding
# the MLA phase: minicpm3-4b FULL (62 layers, 4.07 B params, 7.59 GiB in
# bf16) is not cut and is served with the naive and the absorbed decode;
# deepseek-v3-671b (61 layers, 671.7 B params, 1251 GiB) keeps its first
# 5 layers, the 3 dense ones and 2 MoE layers of 256 experts (27.30 B,
# 50.86 GiB), and is served with the naive decode, the reference's
# default; then its training loss with and without MTP
MLA_MODELS = (("minicpm3-4b", None, (False, True)),
              ("deepseek-v3-671b", 5, (False,)))
MTP_BATCH, MTP_SEQ = 2, 512
MLA_F32_RTOL = 1e-4     # of max |logit|: float32 on the card and on the
#                         host, the same sums in another order
MLA_ABSORB_RTOL = 2e-3  # of max |logit|: absorbed vs naive in float32,
#                         the reference's own tolerance for the pair
#                         (tests/test_transformer.py)
# the MoE layers' grouped GEMM (K7 forward and dX, K8 dW): one product
# (the gate's, d x f; dX and dW of it) at the main path's shapes: T
# tokens, top-k of E experts, M = T k routed rows; each token's k
# experts drawn from seeded scores (distinct, about uniform)
GG_SHAPES = (("dbrx-132b prefill", 4 * 384, 4, 16, 6144, 10752),
             ("dbrx-132b decode", NUM_SLOTS, 4, 16, 6144, 10752),
             ("deepseek-v3-671b prefill", 4 * 384, 8, 256, 7168, 2048),
             ("deepseek-v3-671b decode", NUM_SLOTS, 8, 256, 7168, 2048))
# K8's main path: dbrx-132b's training step (TRAIN_FAMILIES: 4 x 1024)
GG_TRAIN_SHAPE = ("dbrx-132b train", 4 * 1024, 4, 16, 6144, 10752)
GG_TOL = 1e-2      # of max |y|, bf16 outputs: both versions sum in
#                    float32 and round once (2^-8 of |y| <= max |y|), the
#                    plain one in cuBLAS's order
GG_F32_TOL = 1e-5  # of max |y|, float32 (no TF32): the same products
#                    summed in another order


def say(*a) -> None:
    print(*a, flush=True)


def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    say(f"== device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    say(f"   nvidia-smi: {card}")
    # float32 comparisons run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def ptxas_lines(compiler_output: str) -> list:
    """The ``-Xptxas -v`` lines of one source's build (registers, shared
    memory, spills) and its warnings."""
    return [line.strip() for line in compiler_output.splitlines()
            if any(w in line for w in ("register", "smem", "spill",
                                       "arning", "Performance"))]


def build_phase() -> dict:
    """Builds every kernel source; returns ``build.build_all``'s report,
    ``{source: {"seconds", "compiler_output"}}``."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build_all()
    say(f"== build: {len(report)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, r in report.items():
        say(f"   {name}: nvcc {r['seconds']:.2f} s")
        for line in ptxas_lines(r["compiler_output"]):
            say(f"     {line}")
    return report


CUDA_DEV_ATTR_SMEM_OPTIN = 97  # cudaDevAttrMaxSharedMemoryPerBlockOptin


def smem_optin() -> int:
    """The card's opt-in maximum of shared memory a block, read through
    ``cudaDeviceGetAttribute`` of the toolkit's CUDA runtime (the
    library beside ``nvcc``)."""
    import torch
    from repro_torch.kernels import build
    lib64 = Path(build.nvcc_path()).resolve().parent.parent / "lib64"
    cudart = ctypes.CDLL(str(sorted(lib64.glob("libcudart.so*"))[0]))
    get = cudart.cudaDeviceGetAttribute
    get.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                    ctypes.c_int]
    get.restype = ctypes.c_int
    value = ctypes.c_int(0)
    rc = get(ctypes.byref(value), CUDA_DEV_ATTR_SMEM_OPTIN,
             torch.cuda.current_device())
    if rc != 0:
        raise SystemExit(f"chip_smoke: cudaDeviceGetAttribute returned {rc}")
    return value.value


def ptxas_smem(compiler_output: str) -> list:
    """``[(mangled entry, static shared bytes)]`` of one source's
    ``-Xptxas -v`` report (no ``bytes smem`` on its line: 0)."""
    out, entry = [], None
    for line in compiler_output.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry and re.search(r"Used \d+ registers", line):
            m = re.search(r"(\d+) bytes smem", line)
            out.append((entry, int(m.group(1)) if m else 0))
            entry = None
    return out


def lint_phase(card: str, build_report: dict) -> None:
    """Phase 2a: the port's linter on the card's Python, and RPL004's
    static shared bytes and budget held against ptxas and the card."""
    from repro_torch.analysis.lintconfig import DEFAULT_CONFIG
    from repro_torch.analysis.rules.cuda_smem import (CudaUnit,
                                                      estimate_static_smem)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONDONTWRITEBYTECODE="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch",
         "chip_smoke.py", "--fail-on-findings", "--format", "json"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise SystemExit(f"chip_smoke: the lint gate exited "
                         f"{proc.returncode}:\n{proc.stdout[-4000:]}"
                         f"{proc.stderr[-4000:]}")
    data = json.loads(proc.stdout)
    cuda = sum(f["path"].endswith((".cu", ".cuh"))
               for f in data["suppressed"])
    say(f"== lint: python -m repro_torch.analysis src/repro_torch "
        f"chip_smoke.py: {data['n_files']} files, "
        f"{len(data['findings'])} findings {data['counts']}, "
        f"{len(data['suppressed'])} suppressed ({cuda} in CUDA sources), "
        f"Python {sys.version.split()[0]}")
    missing = [s for s in build.SOURCES if s not in build_report]
    if missing:
        raise SystemExit(f"chip_smoke: {missing} not built in this run: "
                         f"no ptxas report to hold RPL004 against (remove "
                         f"{build.BUILD_DIR})")
    entries = [(src, mangled, smem) for src in build.SOURCES
               for mangled, smem in ptxas_smem(
                   build_report[src]["compiler_output"])]
    filt = Path(build.nvcc_path()).with_name("cu++filt")
    names = subprocess.run([str(filt)], input="\n".join(
        e[1] for e in entries), capture_output=True, text=True,
        check=True).stdout.splitlines()
    units = {src: CudaUnit((build.CSRC / f"{src}.cu").read_text(),
                           str(build.CSRC / f"{src}.cu"))
             for src in build.SOURCES}
    matched, bad, rows = set(), [], {}
    for (src, _, smem), name in zip(entries, names):
        plain = name.replace("<unnamed>::", "").replace(
            "(anonymous namespace)::", "")
        m = re.match(r"(?:void )?(\w+)(?:<([^<>]*)>)?\(", plain)
        if m is None:
            raise SystemExit(f"chip_smoke: cannot read the entry {name!r}")
        kernel = next((k for k in units[src].kernels
                       if k.name == m.group(1)), None)
        if kernel is None:
            raise SystemExit(f"chip_smoke: ptxas entry {name!r} is no "
                             f"__global__ RPL004 found in {src}.cu")
        env = {}
        args = [re.sub(r"^\(\w+(?: \w+)?\)", "", a)
                for a in (m.group(2) or "").split(", ")]
        for param, arg in zip(kernel.template_params, args):
            if arg.isdigit():
                env[param] = int(arg)
            elif arg in ("true", "false"):
                env[param] = int(arg == "true")
        est = estimate_static_smem(build.CSRC / f"{src}.cu",
                                   env)[kernel.name]
        align = max(1, units[src].extern_align)
        padded = -(-est // align) * align
        matched.add((src, kernel.name))
        rows.setdefault((src, kernel.name, est, padded, align, smem),
                        []).append("<" + ", ".join(args) + ">"
                                   if m.group(2) else "")
        if padded != smem:
            bad.append(f"{name}: RPL004 {est} B ({padded} aligned), "
                       f"ptxas {smem} B")
    for (src, kernel, est, padded, align, smem), insts in rows.items():
        say(f"   RPL004 {src}.cu {kernel}: {est} B static, {padded} B at "
            f"the extern alignment {align}; ptxas {smem} B "
            f"({len(insts)} {'entry' if len(insts) == 1 else 'entries'}"
            f"{': ' if insts[0] else ''}{' '.join(insts)}) [{card}]")
    unmatched = {(src, k.name) for src, u in units.items()
                 for k in u.kernels} - matched
    if bad or unmatched:
        raise SystemExit(f"chip_smoke: RPL004's static shared bytes "
                         f"disagree with ptxas: {bad}; kernels with no "
                         f"ptxas entry: {sorted(unmatched)}")
    optin = smem_optin()
    budget = DEFAULT_CONFIG.rule("RPL004").options["budget_bytes"]
    say(f"== lint: {len(entries)} ptxas entries of {len(matched)} "
        f"kernels in {len(units)} sources equal RPL004's static bytes; "
        f"the card's opt-in maximum {optin} B a block "
        f"(cudaDevAttrMaxSharedMemoryPerBlockOptin), RPL004's budget "
        f"{budget} B; {time.perf_counter() - t0:.2f} s [{card}]")
    if optin < budget:
        raise SystemExit(f"chip_smoke: the card's opt-in maximum {optin} B "
                         f"is under RPL004's budget {budget} B")


def sass_count(name: str, opcode: str) -> int:
    """How many instructions of the built ``csrc/<name>.cu`` library's
    SASS (``cuobjdump -sass``) carry ``opcode``."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return sum(opcode in line for line in sass.splitlines())


def cuda_ms(fn, iters: int = 100) -> float:
    """Mean device time of one ``fn()`` call, by CUDA events around
    ``iters`` back-to-back calls after a warm-up.  The card first spins
    for longer than the host takes to enqueue the calls, so the events
    time the calls back to back on the card and not the host's launch
    rate."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) * iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 2e9 cycles a second bounds the SM clock from above; at most 2 s
    torch.cuda._sleep(int(min(2.0, 1.5 * host_s + 1e-3) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def k1_ptxas(build_report: dict, name: str = "flash_decode",
             second: str = "warps") -> list:
    """K1's registers and spills per instantiation (its head dim and
    warps a block), from the ``-Xptxas -v`` lines of the build in
    ``build_report``; empty when this run did not build it.  With
    ``name="paged_flash_decode", second="MAXG"`` the same for K2 (its
    head dim and group bucket); with ``name="flash_attention"`` for K4
    (its head dim only: ``second`` is not read)."""
    out = (build_report or {}).get(name, {}).get("compiler_output", "")
    rows, dim = [], None
    for line in out.splitlines():
        m = re.search(rf"Compiling entry function '.*[^_]{name}_kernel"
                      r"ILi(\d+)E(?:Li(\d+)E)?", line)
        if m:
            dim = m.group(1)
            rows.append([f"D={dim}" + (f", {second} {m.group(2)}"
                                       if m.group(2) else "")])
        elif dim is not None and ("spill" in line or "registers" in line):
            rows[-1].append(line.split(":", 1)[-1].strip())
    return [", ".join(r) for r in rows]


def kernel_phase(build_report: dict = None) -> list:
    """K1 flash_decode against its plain version at the main path's
    shape, a GQA shape, the shapes of the MoE / GQA phase's two models
    (dbrx-132b G = 6, command-r-35b G = 8) and a long slot at
    command-r-35b's G = 8 (L = 4096: one slot of 4096 rows, one of 1,
    the rest short), each beside SDPA, its bound and the partition count
    the wrapper chose; gemma3-12b's head_dim 256 at G = 2 on its 392-row
    slots and on 2048-row ones (4 runs); with ``build_phase``'s report,
    K1's and K2's registers and spills per instantiation.  Returns the
    table's rows: the main path's, then the two head-dim-256 rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_torch,
                                                  partitions, wide_blocks)
    tol = KERNEL_TOL
    g = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for line in k1_ptxas(build_report) or ["not built in this run"]:
        say(f"== K1 ptxas: {line}")
    for line in k1_ptxas(build_report, "paged_flash_decode", "MAXG"):
        say(f"== K2 ptxas: {line}")
    # the script's first timed row: a second of bf16 products first, so
    # that it does not time the card's clocks ramping up (a fresh H100
    # 80GB HBM3 at 700 W once read 31.80 µs warm against 19.37 flushed
    # on the main path)
    warm = torch.ones(4096, 4096, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        for _ in range(50):
            warm @ warm
        torch.cuda.synchronize()
    del warm
    rows = []
    for label, B, L, H, Hkv, D in (
            ("main path", 8, 392, 40, 40, 128),
            ("GQA", 8, 392, 40, 8, 128),
            ("dbrx-132b, G=6", 8, 392, 48, 8, 128),
            ("command-r-35b, G=8", 8, 392, 64, 8, 128),
            ("long slot, command-r-35b G=8", 8, 4096, 64, 8, 128),
            (GEMMA_K1, 8, 392, 16, 8, 256),
            (GEMMA_K1_LONG, 8, 2048, 16, 8, 256),
            (PHI3_K1, 8, 392, 32, 32, 96),
            (WHISPER_K1, 8, 392, 20, 20, 64)):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.bfloat16)
        q, k, v = rnd(B, H, D), rnd(B, L, Hkv, D), rnd(B, L, Hkv, D)
        if label.startswith("long slot"):
            lens = torch.randint(1, 300, (B,), generator=g, device="cuda",
                                 dtype=torch.int32)
            lens[0], lens[1] = L, 1      # one long slot among short ones
        else:
            lens = torch.randint(1, L + 1, (B,), generator=g, device="cuda",
                                 dtype=torch.int32)
            lens[0], lens[1] = 1, L      # ragged, with both extremes
        out = flash_decode(q, k, v, lens)
        want = flash_decode_torch(q, k, v, lens)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        # the yardstick: one library call computing the same function
        mask = (torch.arange(L, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        kt, vt, q4 = k.transpose(1, 2), v.transpose(1, 2), q[:, :, None]

        def library():
            return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = (library()[:, :, 0].float() - want.float()).abs().max()
        ms = cuda_ms(lambda: flash_decode(q, k, v, lens))
        plain_ms = cuda_ms(lambda: flash_decode_torch(q, k, v, lens))
        library_ms = cuda_ms(library)
        # a served step finds each layer's K/V cold in L2
        cold = [cuda_ms_cold(f) for f in (
            lambda: flash_decode(q, k, v, lens),
            lambda: flash_decode_torch(q, k, v, lens), library)]
        n = lens.clamp(1, L).long()
        nbytes = (q.numel() * 2 + int(n.sum()) * Hkv * D * 2 * 2
                  + B * 4 + B * H * D * 2)
        nops = int(n.sum()) * H * D * 4
        bound_ms = max(nbytes / HBM_BYTES_PER_S,
                       nops / BF16_OPS_PER_S) * 1e3
        parts, part_rows = partitions(L)
        warps = 8 if wide_blocks(B, Hkv, parts, sms, D) else 4
        say(f"== kernel flash_decode [{label}: B={B} L={L} H={H} "
            f"Hkv={Hkv} D={D}, lengths {lens.tolist()}; {parts} "
            f"partition(s) of {part_rows} rows, blocks of {warps} warps, "
            f"on {sms} SMs]")
        say(f"   max_abs_err {err:.3e} (tol {tol:.0e}); library "
            f"max_abs_err {float(lib_err):.3e}")
        say(f"   kernel {ms * 1e3:.2f} us | plain {plain_ms * 1e3:.2f} us | "
            f"library {library_ms * 1e3:.2f} us | bound "
            f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB)")
        say(f"   L2 flushed before each call: kernel {cold[0] * 1e3:.2f} us "
            f"| plain {cold[1] * 1e3:.2f} us | library {cold[2] * 1e3:.2f} "
            f"us")
        if not err <= tol:
            raise AssertionError(f"flash_decode [{label}] disagrees with "
                                 f"its plain version: {err} > {tol}")
        rows.append(dict(name="flash_decode", route="cuda",
                         source="src/repro_torch/kernels/csrc/flash_decode.cu",
                         replaces="src/repro/kernels/flash_decode.py:138",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by="bytes",
                         library_ms=library_ms, shape=label,
                         ms_cold=cold[0]))
        del q, k, v, out, want
    torch.cuda.empty_cache()
    return [rows[0]] + [r for r in rows if r["shape"].startswith(
        ("gemma3", "phi-3", "whisper"))]


def host_us(fn, calls: int = 200) -> float:
    """The host's time to issue one ``fn()`` call (wrapper, checks and
    launch), by the host clock around ``calls`` back-to-back calls that
    the card does not hold up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def paged_kernel_phase() -> list:
    """K2 paged_flash_decode against its plain version at the paged main
    path's shape (page size 8, 50-block tables into 400 pages), a GQA
    shape, the MoE / GQA phase's two models' shapes (dbrx-132b H=48,
    command-r-35b H=64, both Hkv=8), and a long slot (page size 16,
    256-block tables, one slot of 4096 rows among short ones), through a shuffled table whose entries
    past each slot's length are stale out-of-range ids, with a slot
    parked at max_blocks * page_size + 1 as an idle slot is.  Each case
    is also timed through K1 on the same rows gathered into a dense cache,
    and the wrappers' host time a call is printed.  gemma3-12b's head_dim
    256 (H=16, Hkv=8) goes through 50- and 256-block tables of page 8.
    Returns the table's rows: the main path's, then the two
    head-dim-256 rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode import partitions as k1_partitions
    from repro_torch.kernels.paged_flash_decode import (
        paged_flash_decode, paged_flash_decode_torch, partitions)
    g = torch.Generator(device="cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B = 8
    rows = []
    for label, H, Hkv, ps, MB, NP, D in (
            ("main path", 40, 40, PAGE_SIZE, 50, NUM_PAGES, 128),
            ("GQA", 40, 8, PAGE_SIZE, 50, NUM_PAGES, 128),
            ("dbrx-132b, G=6", 48, 8, PAGE_SIZE, 50, NUM_PAGES, 128),
            ("command-r-35b, G=8", 64, 8, PAGE_SIZE, 50, NUM_PAGES, 128),
            ("long slot", 40, 8, 16, 256, 2048, 128),
            (GEMMA_K1, 16, 8, PAGE_SIZE, 50, NUM_PAGES, 256),
            (GEMMA_K1_LONG, 16, 8, PAGE_SIZE, 256, 2048, 256),
            (PHI3_K1, 32, 32, PAGE_SIZE, 50, NUM_PAGES, 96),
            (WHISPER_K1, 20, 20, PAGE_SIZE, 50, NUM_PAGES, 64)):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.bfloat16)
        q, kp, vp = rnd(B, H, D), rnd(NP, ps, Hkv, D), rnd(NP, ps, Hkv, D)
        table = torch.randperm(NP, generator=g, device="cuda")[:B * MB]
        table = table.reshape(B, MB).to(torch.int32)
        if label == "long slot":
            lens = torch.randint(1, 300, (B,), generator=g, device="cuda",
                                 dtype=torch.int32)
            lens[0], lens[1], lens[2] = MB * ps, 1, MB * ps + 1
        else:
            lens = torch.randint(1, MB * ps - ps + 1, (B,), generator=g,
                                 device="cuda", dtype=torch.int32)
            lens[0], lens[1], lens[2] = 1, MB * ps + 1, MB * ps - ps
        n = lens.clamp(1, MB * ps)
        # stale ids past each slot's allocation: clamped, never read
        past = (torch.arange(MB, device="cuda")[None, :] * ps
                >= n[:, None])
        table[past] = NP + 7
        out = paged_flash_decode(q, kp, vp, table, lens)
        want = paged_flash_decode_torch(q, kp, vp, table, lens)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        # the yardstick: SDPA over the rows already gathered (the
        # gather is excluded: no single PyTorch call reads a table); K1
        # over the same gathered rows
        tab = table.long().clamp(0, NP - 1)
        kd = kp[tab].reshape(B, MB * ps, Hkv, D)
        vd = vp[tab].reshape(B, MB * ps, Hkv, D)
        kt, vt = kd.transpose(1, 2), vd.transpose(1, 2)
        mask = (torch.arange(MB * ps, device="cuda")[None, :]
                < n[:, None])[:, None, None, :]
        q4 = q[:, :, None]

        def library():
            return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = (library()[:, :, 0].float() - want.float()).abs().max()
        k1_err = (flash_decode(q, kd, vd, n).float()
                  - want.float()).abs().max().item()
        ms = cuda_ms(lambda: paged_flash_decode(q, kp, vp, table, lens))
        plain_ms = cuda_ms(
            lambda: paged_flash_decode_torch(q, kp, vp, table, lens))
        library_ms = cuda_ms(library)
        k1_ms = cuda_ms(lambda: flash_decode(q, kd, vd, n))
        k2_cold = cuda_ms_cold(
            lambda: paged_flash_decode(q, kp, vp, table, lens))
        k1_cold = cuda_ms_cold(lambda: flash_decode(q, kd, vd, n))
        k2_host = host_us(lambda: paged_flash_decode(q, kp, vp, table, lens))
        k1_host = host_us(lambda: flash_decode(q, kd, vd, n))
        parts, part_pages = partitions(MB, ps, B, Hkv, sms)
        k1_parts = k1_partitions(MB * ps)[0]
        nbytes = (q.numel() * 2 + int(n.long().sum()) * Hkv * D * 2 * 2
                  + table.numel() * 4 + B * 4 + B * H * D * 2)
        nops = int(n.long().sum()) * H * D * 4
        bound_ms = max(nbytes / HBM_BYTES_PER_S,
                       nops / BF16_OPS_PER_S) * 1e3
        say(f"== kernel paged_flash_decode [{label}: B={B} H={H} Hkv={Hkv} "
            f"D={D} page_size={ps} max_blocks={MB} num_pages={NP}, lengths "
            f"{lens.tolist()}; {parts} partition(s) of {part_pages} pages "
            f"on {sms} SMs]")
        say(f"   max_abs_err {err:.3e} (tol {KERNEL_TOL:.0e}); library "
            f"max_abs_err {float(lib_err):.3e}; K1 on the gathered rows "
            f"max_abs_err {k1_err:.3e}")
        say(f"   kernel {ms * 1e3:.2f} us | plain {plain_ms * 1e3:.2f} us | "
            f"library (SDPA on pre-gathered rows) {library_ms * 1e3:.2f} us "
            f"| bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB) | K1 "
            f"on the same rows, gathered {k1_ms * 1e3:.2f} us ({k1_parts} "
            f"partition(s))")
        say(f"   L2 flushed before each call: kernel {k2_cold * 1e3:.2f} us "
            f"| K1 on the same rows {k1_cold * 1e3:.2f} us")
        say(f"   host time a call: paged_flash_decode {k2_host:.2f} us, "
            f"flash_decode {k1_host:.2f} us")
        if not (err <= KERNEL_TOL and k1_err <= KERNEL_TOL):
            raise AssertionError(f"paged_flash_decode [{label}] disagrees "
                                 f"with its plain version: {err}")
        rows.append(dict(
            name="paged_flash_decode", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_flash_decode.cu",
            replaces="src/repro/kernels/flash_decode.py:84",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes", library_ms=library_ms, host_us=k2_host,
            shape=label, ms_cold=k2_cold))
        del q, kp, vp, out, want, kd, vd, kt, vt
    torch.cuda.empty_cache()
    # whisper's row is measured and printed, not returned: whisper's
    # cross-attention layers never page, so K2 is not on its path
    return [rows[0]] + [r for r in rows if r["shape"].startswith(
        ("gemma3", "phi-3"))]


def attention_kernel_phase(build_report: dict) -> list:
    """K4 flash_attention against its plain version in bf16: the training
    shape (B=4, S=1024, H=Hkv=40, D=128, causal), phi-3-vision-4.2b's
    eval shape (B=4, S=1024, H=Hkv=32, D=96) and gemma3-12b's global
    layers' (B=2, S=2048, H=16, Hkv=8, D=256), then GQA G=2, a non-causal
    case with Sq != Skv and ragged tiles, D=64 (SMOKE), a causal Sq !=
    Skv case, and D=96 / 256 on ragged tiles.  The first three are timed
    warm and with L2 flushed, beside their bound, the plain version and
    SDPA; K4's HGMMA count and its ptxas lines (from ``build_report``,
    ``build_phase``'s) are printed first, with its registers and spills
    per head dim.  Returns the three timed rows of the table."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    hgmma = sass_count("flash_attention", "HGMMA")
    ptxas = ptxas_lines(build_report["flash_attention"]["compiler_output"])
    say(f"== kernel flash_attention: {hgmma} HGMMA instruction(s) in its "
        f"SASS; ptxas: {' | '.join(ptxas)}")
    for line in k1_ptxas(build_report, "flash_attention"):
        say(f"== K4 ptxas: {line}")
    if not hgmma:
        raise AssertionError("flash_attention's SASS has no HGMMA: the "
                             "products do not run on wgmma")
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for label, B, Sq, Skv, H, Hkv, D, causal in (
            ("training shape", 4, 1024, 1024, 40, 40, 128, True),
            (PHI3_K4, 4, 1024, 1024, 32, 32, 96, True),
            (GEMMA_K4, 2, 2048, 2048, 16, 8, 256, True),
            ("GQA G=2", 2, 512, 512, 16, 8, 128, True),
            ("non-causal, G=4, ragged", 2, 320, 448, 8, 2, 128, False),
            ("SMOKE D=64", 2, 256, 256, 4, 4, 64, True),
            ("causal Sq != Skv", 1, 200, 136, 4, 4, 64, True),
            ("D=96 non-causal, G=2, ragged", 2, 200, 328, 8, 4, 96, False),
            ("D=256 non-causal, G=2, ragged", 2, 200, 328, 8, 4, 256, False),
            ("D=256 causal Sq != Skv", 1, 300, 136, 4, 4, 256, True)):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.bfloat16)
        q, k, v = rnd(B, Sq, H, D), rnd(B, Skv, Hkv, D), rnd(B, Skv, Hkv, D)
        with torch.no_grad():
            out = flash_attention(q, k, v, causal=causal)
            want = flash_attention_torch(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        say(f"== kernel flash_attention [{label}: B={B} Sq={Sq} Skv={Skv} "
            f"H={H} Hkv={Hkv} D={D} causal={causal}]: max_abs_err "
            f"{err:.3e} (tol {KERNEL_TOL:.0e})")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"flash_attention [{label}] disagrees with "
                                 f"its plain version: {err}")
        if len(rows) < 3:
            # the yardstick: SDPA on (B, H, S, D) views of the same tensors
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

            def kernel():
                return flash_attention(q, k, v)

            def plain():
                return flash_attention_torch(q, k, v)
            lib_err = (library().transpose(1, 2).float()
                       - want.float()).abs().max().item()
            with torch.no_grad():
                ms = cuda_ms(kernel)
                plain_ms = cuda_ms(plain, 10)
                library_ms = cuda_ms(library)
                cold = [cuda_ms_cold(f) for f in (kernel, plain, library)]
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
            pairs = Sq * (Sq + 1) // 2          # (q, kv) pairs attended
            nops = 4 * B * H * D * pairs
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            say(f"   kernel {ms * 1e3:.2f} us | plain {plain_ms * 1e3:.2f} us"
                f" | library (SDPA, is_causal) {library_ms * 1e3:.2f} us, "
                f"max_abs_err {lib_err:.3e} | bound {bound_ms * 1e3:.2f} us "
                f"({nbytes / 1e6:.2f} MB: {t_bytes * 1e6:.2f} us; "
                f"{nops / 1e9:.2f} GFLOP: {t_ops * 1e6:.2f} us; {bound_by}); "
                f"kernel at {nops / ms / 1e9:.1f} TFLOP/s")
            say(f"   L2 flushed before each call: kernel {cold[0] * 1e3:.2f} "
                f"us | plain {cold[1] * 1e3:.2f} us | library "
                f"{cold[2] * 1e3:.2f} us")
            rows.append(dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:63",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, shape=label,
                ms_cold=cold[0]))
        del q, k, v, out, want
    torch.cuda.empty_cache()
    return rows


def ssd_ops(B, S, H, hd, N, c) -> int:
    """The float32 operations an SSD scan needs: the causal half of the
    two intra-chunk products in every chunk, and the inter-chunk term
    and the state update in every chunk with a state before or after it
    (the first chunk's state is zero, the last one's is not returned)."""
    nc = S // c
    pairs = c * (c + 1) // 2
    return B * H * (nc * pairs * 2 * (N + hd) + (nc - 1) * 2 * 2 * c * hd * N)


def ssd_kernel_phase() -> dict:
    """K6 ssd_chunk_scan against its plain version: the evaluation shape
    of mamba2-130m FULL (B=4, S=2048, H=24, hd=64, G=1, N=128, chunk 256,
    bf16 inputs, A_log = 0 so that exp(cum_t - cum_s) overflows above the
    diagonal), G=2 H=8, chunks 64 and 128, S < chunk, the reference
    test's shape, and x, B and C read through strides that split their
    rows off 16-byte boundaries.  Compared in float32 before the final rounding, within
    SSD_RTOL of max |y|; the bf16 output must be the float32 one rounded.
    The evaluation shape is timed beside its bound: the larger of its
    bytes and its operations on the bf16 tensor cores that the kernel
    feeds, with the float32 CUDA-core basis of the kernel it replaced
    printed beside it, and the device time of each of its three
    launches.  The count of tensor-core (HMMA) instructions in its SASS
    is printed first; none is a failure.  Returns its row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import (ssd_chunk_scan,
                                              ssd_chunk_scan_torch)
    hmma = sass_count("ssd_scan", "HMMA")
    say(f"== kernel ssd_chunk_scan: {hmma} HMMA (mma.sync) instruction(s) "
        f"in its SASS")
    if not hmma:
        raise AssertionError("ssd_scan's SASS has no HMMA: the products do "
                             "not run on the tensor cores")
    g = torch.Generator(device="cuda").manual_seed(3)
    row = None
    for label, B, S, H, hd, G, N, chunk, dtype in (
            ("eval shape", 4, 2048, 24, 64, 1, 128, 256, torch.bfloat16),
            ("G=2 H=8", 2, 1024, 8, 64, 2, 64, 256, torch.float32),
            ("chunk 64", 2, 1024, 24, 64, 1, 128, 64, torch.bfloat16),
            ("chunk 128", 2, 1024, 24, 64, 1, 128, 128, torch.bfloat16),
            ("S < chunk", 2, 200, 8, 64, 1, 128, 256, torch.float32),
            ("reference test shape", 2, 256, 4, 32, 2, 16, 32,
             torch.float32),
            # rows that are not whole 16-byte pieces: the staging's
            # element-by-element path
            ("strided rows", 2, 256, 4, 40, 1, 18, 64, torch.bfloat16)):
        pad = 3 if label == "strided rows" else 0

        def rnd(*shape, scale=1.0):
            wide = (*shape[:-1], shape[-1] + pad)
            return (torch.randn(wide, generator=g, device="cuda")
                    * scale).to(dtype)[..., :shape[-1]]
        x = rnd(B, S, H, hd)
        Bm, Cm = rnd(B, S, G, N, scale=0.5), rnd(B, S, G, N, scale=0.5)
        dt = F.softplus(torch.randn((B, S, H), generator=g,
                                    device="cuda")).to(dtype)
        A_log = (torch.zeros(H, device="cuda") if G == 1 else
                 torch.randn(H, generator=g, device="cuda") * 0.3).to(dtype)
        args = (x, Bm, Cm, dt, A_log)
        with torch.no_grad():
            y32 = ssd_chunk_scan(*args, chunk=chunk, out_dtype=torch.float32)
            y = ssd_chunk_scan(*args, chunk=chunk)
            want = ssd_chunk_scan_torch(*args, chunk=chunk,
                                        out_dtype=torch.float32)
        torch.cuda.synchronize()
        c = min(chunk, S)
        err = (y32 - want).abs().max().item()
        rel = err / want.abs().max().item()
        fall = float((dt.float() * -torch.exp(A_log.float())).reshape(
            B, S // c, c, H).sum(2).min())
        rounded = torch.equal(y, y32.to(dtype))
        say(f"== kernel ssd_chunk_scan [{label}: B={B} S={S} H={H} hd={hd} "
            f"G={G} N={N} chunk {c}, {str(dtype)[6:]}]: max_abs_err "
            f"{err:.3e}, relative to max |y| {rel:.3e} (tol "
            f"{SSD_RTOL:.0e}); cum falls to {fall:.1f} within a chunk; "
            f"finite {bool(torch.isfinite(y32).all())}; {str(dtype)[6:]} "
            f"output = float32 output rounded: {rounded}")
        if not (rel <= SSD_RTOL and torch.isfinite(y32).all() and rounded
                and y.dtype == dtype):
            raise AssertionError(f"ssd_chunk_scan [{label}] disagrees with "
                                 f"its plain version: {rel}")
        if row is None:
            with torch.no_grad():
                ms = cuda_ms(lambda: ssd_chunk_scan(*args, chunk=chunk), 20)
                plain_ms = cuda_ms(
                    lambda: ssd_chunk_scan_torch(*args, chunk=chunk), 5)
            nbytes = sum(t.numel() * t.element_size()
                         for t in (*args, y))
            nops = ssd_ops(B, S, H, hd, N, c)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S
            fp32_bound_ms = nops / FP32_OPS_PER_S * 1e3
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            say(f"   kernel {ms * 1e3:.2f} us | plain {plain_ms * 1e3:.2f} us"
                f" | library: none (no single PyTorch call computes the SSD "
                f"scan) | bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.1f} "
                f"MB: {t_bytes * 1e6:.2f} us; {nops / 1e9:.2f} GFLOP on the "
                f"bf16 tensor cores: {t_ops * 1e6:.2f} us; {bound_by}; the "
                f"float32 CUDA-core basis: {fp32_bound_ms * 1e3:.2f} us); "
                f"kernel at {nops / ms / 1e9:.2f} TFLOP/s")
            say(f"   device time by kernel, one call: "
                f"{device_split(lambda: ssd_chunk_scan(*args, chunk=chunk))}")
            row = dict(name="ssd_chunk_scan", route="cuda",
                       source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                       replaces="src/repro/kernels/ssd_scan.py:60",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                       fp32_bound_ms=fp32_bound_ms, hmma=hmma)
        del x, Bm, Cm, dt, args, y, y32, want
    torch.cuda.empty_cache()
    return row


def _gg_routing(T: int, k: int, E: int, g) -> tuple:
    """Offsets of T tokens' top-k of E experts, drawn from seeded scores:
    ``(offsets (E + 1,) int32 on the card, group sizes)``."""
    import torch
    top = torch.randn(T, E, generator=g, device="cuda").topk(k).indices
    ids = top.reshape(-1).sort(stable=True).values
    offsets = torch.searchsorted(ids, torch.arange(E + 1,
                                                   device="cuda")).int()
    return offsets, offsets.diff().tolist()


def _gg_library(grouped, capacity, want) -> tuple:
    """The yardstick: ``grouped()`` (a ``torch._grouped_mm`` call) where
    the card's torch has it for these operands, else the capacity form's
    product (``capacity()`` makes its zero buffers and gives the
    ``torch.bmm`` call); neither is the port's.  Returns its name, the
    call and, for ``torch._grouped_mm``, its max |difference| from
    ``want`` (the kernel's output) relative to max |want|."""
    import torch
    try:
        got = grouped()
    except (AttributeError, RuntimeError, TypeError) as err:
        reason = str(err).splitlines()[0][:80]
        return (f"the capacity form's torch.bmm (_grouped_mm: {reason})",
                capacity(), None)
    diff = ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()
    return "torch._grouped_mm", grouped, diff


def _gg_rel_err(a, b) -> float:
    """max |a - b| / max |b|, for a dW one expert's matrix at a time: a
    float32 copy of a whole dW takes 15 GB at deepseek-v3-671b's widths,
    and three of them do not fit beside the weight and both dW."""
    err = scale = 0.0
    for p, q in (zip(a, b) if a.dim() == 3 else ((a, b),)):
        err = max(err, (p.float() - q.float()).abs().max().item())
        scale = max(scale, q.float().abs().max().item())
    return err / scale


def _gg_case(label, x, w, offsets, max_group, dtype, tol, grads=True
             ) -> dict:
    """K7 (through the wrapper and ``GroupedGemm``'s backward: K7 for dX,
    K8 for dW) against the plain version and its autograd on the same
    inputs; K7 called twice must agree bit for bit, and so must K8.
    Returns the relative errors."""
    import torch
    from repro_torch.kernels.grouped_gemm import (GroupedGemm, grouped_gemm,
                                                  grouped_gemm_torch)
    y = grouped_gemm(x, w, offsets, max_group)
    again = grouped_gemm(x, w, offsets, max_group)
    want = grouped_gemm_torch(x, w, offsets, max_group)
    torch.cuda.synchronize()
    errs = {"y": _gg_rel_err(y, want)}
    repeat = torch.equal(y, again)
    del y, again, want
    if grads:
        dy = torch.randn(x.shape[0], w.shape[2], device="cuda",
                         dtype=dtype)
        xk, wk = (t.detach().requires_grad_(True) for t in (x, w))
        got = torch.autograd.grad(GroupedGemm.apply(xk, wk, offsets),
                                  (xk, wk), dy)
        xp, wp = (t.detach().requires_grad_(True) for t in (x, w))
        ref = torch.autograd.grad(grouped_gemm_torch(xp, wp, offsets,
                                                     max_group), (xp, wp), dy)
        for name, a, b in zip(("dx", "dw"), got, ref):
            errs[name] = _gg_rel_err(a, b)
        dw_again = torch.ops.repro_torch.grouped_gemm_dw(x, dy, offsets)
        torch.cuda.synchronize()
        repeat = repeat and torch.equal(got[1], dw_again)
        del dy, xk, wk, got, xp, wp, ref, dw_again
    say(f"   {label} [{str(dtype).split('.')[-1]}]: max |err| / max |want| "
        f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tol "
        f"{tol:.0e}); K7{' and K8' * grads} repeat bit for bit: {repeat}")
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad or not repeat:
        raise AssertionError(f"grouped_gemm [{label}, {dtype}] disagrees "
                             f"with its plain version: {bad}; repeat "
                             f"{repeat}")
    return errs


def grouped_gemm_phase(build_report: dict = None) -> list:
    """K7 and K8 (the MoE layers' grouped GEMM) against their plain
    versions on the card, in bf16 and float32, at GG_SHAPES (dbrx-132b's
    and deepseek-v3-671b's prefill and decode), K8's training shape, a
    split with empty groups (first, middle, last), one with every row
    in one group and one whose every group holds under 64 rows (each K8
    reduction a single, partly zeroed stage; K7's second consumer idle):
    forward, and dX and dW against autograd of the plain version (in
    float32 not at deepseek's prefill, whose plain autograd does not fit
    beside the 15 GB weight and two 15 GB dW); then, in bf16, each
    shape's K7 (K8 at the training shape) timed warm and with L2 flushed
    beside the plain version as the main path calls it (max_group = T),
    its bound (operations at 989 TFLOP/s or the bytes of its rows and of
    the experts they reach at 3.35 TB/s, the larger) and the library
    yardstick, and the kernel's warm time as a multiple of each.
    ptxas's registers and spills first (a spill fails), then the
    library's HGMMA and HMMA counts (wgmma must be there, mma.sync must
    not).  Returns the rows of the kernel table."""
    import torch
    from repro_torch.kernels.grouped_gemm import (grouped_gemm,
                                                  grouped_gemm_dw_torch,
                                                  grouped_gemm_torch)
    k8 = torch.ops.repro_torch.grouped_gemm_dw
    t0 = time.perf_counter()
    out = (build_report or {}).get("grouped_gemm", {}).get(
        "compiler_output", "")
    for line in ptxas_lines(out) or ["not built in this run"]:
        say(f"== K7/K8 ptxas: {line}")
    spills = [line for line in ptxas_lines(out) if re.search(
        r"[1-9]\d* bytes spill (stores|loads)", line)]
    if spills:
        raise AssertionError(f"grouped_gemm spills: {spills}")
    hgmma = sass_count("grouped_gemm", "HGMMA")
    hmma = sass_count("grouped_gemm", "HMMA")
    say(f"== K7/K8 SASS: {hgmma} HGMMA (wgmma), {hmma} HMMA (mma.sync)")
    if hgmma == 0 or hmma:
        raise AssertionError("grouped_gemm's bf16 products must run on "
                             "wgmma alone")
    g = torch.Generator(device="cuda").manual_seed(7)

    def rnd(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    # the ragged edges: empty groups first, in the middle and last; every
    # row in one group; every group under 64 rows, with K and N not
    # multiples of the 128 x 256 tile (small shapes: the contract, not
    # the speed)
    for label, sizes, K, N in (
            ("empty groups", [0, 37, 0, 0, 129, 200, 1, 0], 256, 384),
            ("one group", [0, 0, 0, 500, 0, 0, 0, 0], 256, 384),
            ("groups under 64 rows", [5, 63, 1, 0, 17, 40, 2, 33], 320,
             264)):
        offsets = torch.tensor([0] + sizes, device="cuda").cumsum(0).int()
        for dtype, tol in ((torch.bfloat16, GG_TOL),
                           (torch.float32, GG_F32_TOL)):
            x = rnd(sum(sizes), K, dtype=dtype)
            w = rnd(len(sizes), K, N, dtype=dtype, scale=K ** -0.5)
            _gg_case(f"{label} {sizes}, K={K} N={N}", x, w, offsets,
                     max(sizes), dtype, tol)
            dw = k8(x, rnd(sum(sizes), N, dtype=dtype), offsets)
            empty = [i for i, n in enumerate(sizes) if n == 0]
            if dw[empty].any():
                raise AssertionError(f"grouped_gemm_dw [{label}] wrote "
                                     f"nonzero dW for an empty group")

    rows = []
    for label, T, k, E, d, f in GG_SHAPES + (GG_TRAIN_SHAPE,):
        offsets, sizes = _gg_routing(T, k, E, g)
        M, hit = T * k, sum(n > 0 for n in sizes)
        say(f"== kernel grouped_gemm [{label}: T={T} tokens top-{k} of "
            f"E={E}, M={M} rows, K={d} N={f}; {hit} experts reached, "
            f"groups {min(sizes)}..{max(sizes)} rows]")
        train = label == GG_TRAIN_SHAPE[0]
        for dtype, tol in ((torch.bfloat16, GG_TOL),
                           (torch.float32, GG_F32_TOL)):
            x = rnd(M, d, dtype=dtype)
            w = rnd(E, d, f, dtype=dtype, scale=d ** -0.5)
            # float32 gradients at deepseek's prefill: the plain version's
            # autograd holds its (256, 1536, 7168) buffer and that
            # buffer's gradient, 11.3 GB each, beside the 15 GB weight and
            # both 15 GB dW, over 70 of the card's 80 GB
            errs = _gg_case(label, x, w, offsets, T, dtype, tol, grads=not (
                dtype == torch.float32
                and label == "deepseek-v3-671b prefill"))
            if dtype == torch.float32:
                del x, w
                torch.cuda.empty_cache()
                continue
            nops = 2 * M * d * f
            if train:
                dy = rnd(M, f, dtype=dtype)
                err = errs["dw"]
                name, source = "grouped_gemm_dw", "K8"

                def kernel():
                    return k8(x, dy, offsets)

                def plain():
                    return grouped_gemm_dw_torch(x, dy, offsets, T)

                def capacity():
                    xb = x.new_zeros((E, T, d))
                    db = dy.new_zeros((E, T, f))
                    return lambda: torch.bmm(xb.transpose(1, 2), db)
                # x and dy read once, dW written once, every expert's
                nbytes = (M * d + M * f + E * d * f) * 2
                # the 2-D x 2-D form splits the contraction (rows) by offs
                lib_name, library, lib_diff = _gg_library(
                    lambda: torch._grouped_mm(x.t(), dy, offs=offsets[1:]),
                    capacity, kernel())
            else:
                err = errs["y"]
                name, source = "grouped_gemm", "K7"

                def kernel():
                    return grouped_gemm(x, w, offsets, T)

                def plain():
                    return grouped_gemm_torch(x, w, offsets, T)
                def capacity():
                    buf = x.new_zeros((E, T, d))
                    return lambda: torch.bmm(buf, w)
                # x read once, y written once, and the weights of each
                # expert a row reaches
                nbytes = (M * d + M * f + hit * d * f) * 2
                lib_name, library, lib_diff = _gg_library(
                    lambda: torch._grouped_mm(x, w, offs=offsets[1:]),
                    capacity, kernel())
            ms = cuda_ms(kernel, 20)
            cold = cuda_ms_cold(kernel, 10)
            plain_ms = cuda_ms(plain, 5)
            library_ms = cuda_ms(library, 20)
            lib_cold = cuda_ms_cold(library, 10)
            t_ops, t_bytes = nops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
            bound_ms = max(t_ops, t_bytes) * 1e3
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            say(f"   {source} {name} bf16: x library {ms / library_ms:.2f}"
                f", x bound {ms / bound_ms:.2f} (warm)")
            say(f"   {source} {name} bf16: kernel {ms * 1e3:.2f} us warm, "
                f"{cold * 1e3:.2f} us flushed ({nops / ms / 1e9:.1f} "
                f"TFLOP/s) | plain {plain_ms * 1e3:.2f} us | library "
                f"{library_ms * 1e3:.2f} us warm, {lib_cold * 1e3:.2f} us "
                f"flushed ({lib_name}"
                + ("" if lib_diff is None else
                   f"; max |difference| from the kernel / max |kernel| "
                   f"{lib_diff:.3e}")
                + f") | bound {bound_ms * 1e3:.2f} us ({nops / 1e9:.1f} GFLOP"
                f" / 989 TFLOP/s = {t_ops * 1e6:.2f} us; {nbytes / 1e9:.3f} "
                f"GB / 3.35 TB/s = {t_bytes * 1e6:.2f} us; {bound_by})")
            rows.append(dict(name=name, route="cuda",
                             source="src/repro_torch/kernels/csrc/"
                                    "grouped_gemm.cu",
                             replaces="src/repro/models/moe.py:91",
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms, shape=label,
                             ms_cold=cold, library=lib_name,
                             library_ms_cold=lib_cold))
            del x, w
            torch.cuda.empty_cache()
    say(f"== grouped gemm: {time.perf_counter() - t0:.1f} s")
    return rows


def cuda_ms_cold(fn, iters: int = 20) -> float:
    """Mean device time of one ``fn()`` call with the 50 MB L2 cache
    flushed before each: a 128 MiB read between the timed launches
    leaves the cache holding other, clean lines, as a served step's
    weights leave it for the next layer's attention.  The card first
    spins for longer than the host takes to issue the flush and the
    call, so the events time the call on the card and not the host; two
    untimed rounds first, so that no lazy load of the flush's kernel
    lands in a timed one."""
    import torch
    flush = torch.zeros(32 << 20, dtype=torch.float32, device="cuda")
    sink = torch.empty((), dtype=torch.float32, device="cuda")
    torch.sum(flush, dim=0, out=sink)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin = int(min(0.1, 2 * (time.perf_counter() - t0) + 1e-4) * 2e9)
    total = 0.0
    for i in range(iters + 2):
        torch.cuda._sleep(spin)
        torch.sum(flush, dim=0, out=sink)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end) if i >= 2 else 0.0
    return total / iters


def device_split(fn, top: int = 0) -> str:
    """The device time of each kernel of one ``fn()`` call (the ``top``
    largest when ``top`` > 0), by ``torch.profiler`` (self device time,
    us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    items = sorted(((e.self_device_time_total, e.key)
                    for e in prof.key_averages()
                    if e.self_device_time_total > 0), reverse=True)
    if not items:
        return "not measured (the profiler saw no device activity)"
    total = sum(us for us, _ in items)
    items = items[:top] if top else items
    return f"{total:.2f} us in all: " + ", ".join(
        f"{key[:48]} {us:.2f} us" for us, key in items)


def _tie_swaps(ids, want_ids, rows, tol: float, label: str) -> int:
    """Hold a top-k against a reference top-k of the same queries: the
    ids are the same at every position except where the reference's
    own scores (``rows``, (Q, D)) of the two ids tie within ``tol``,
    and no id repeats in a row.  Returns the number of such swaps."""
    import numpy as np
    ids, want_ids = np.asarray(ids), np.asarray(want_ids)
    if ids.shape != want_ids.shape:
        raise AssertionError(f"[{label}] ids {ids.shape} vs reference "
                             f"{want_ids.shape}")
    swaps = 0
    for qi in range(ids.shape[0]):
        if len(set(ids[qi].tolist())) != ids.shape[1]:
            raise AssertionError(f"[{label}] query {qi}: repeated ids "
                                 f"{ids[qi].tolist()}")
        for j in np.flatnonzero(ids[qi] != want_ids[qi]):
            a, b = rows[qi][ids[qi, j]], rows[qi][want_ids[qi, j]]
            if not abs(float(a) - float(b)) <= tol:
                raise AssertionError(
                    f"[{label}] query {qi} position {j}: id {ids[qi, j]} "
                    f"(score {a}) where the reference has id "
                    f"{want_ids[qi, j]} (score {b})")
            swaps += 1
    return swaps


def kernel_launches(fn, calls: int = 5) -> dict:
    """``{kernel name: launches a call}`` of ``fn()`` by ``torch.profiler``
    over ``calls`` calls; empty when the profiler saw no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count / calls for e in prof.key_averages()
            if e.self_device_time_total > 0}


def _k3_row(label, q, docs, counted, reference=None) -> dict:
    """Hold the K3 result ``counted`` (the main path's launch) against
    the plain version on the same inputs and time kernel, plain version
    and library yardstick; the bound on the TF32 tensor cores the kernel
    feeds (three products per float32 product) beside the float32
    CUDA-core basis of the kernel it replaced; the wrapper's time a call
    on the host's clock and the kernels one call launches.
    ``reference``: (ids, (Q, D) scores) of a host-side reference to hold
    the ids against as well."""
    import torch
    from repro_torch.kernels.dense_topk import dense_topk, dense_topk_torch
    Q, E = q.shape
    D, k = docs.shape[0], TOP_K
    got_s, got_i = counted
    want_s, want_i = dense_topk_torch(q, docs, k=k)
    rows = (q @ docs.T).cpu().numpy()   # the plain version's scores
    torch.cuda.synchronize()
    err = (got_s - want_s).abs().max().item()
    swaps = _tie_swaps(got_i.cpu().numpy(), want_i.cpu().numpy(), rows,
                       RETRIEVAL_TOL, f"dense_topk {label}")
    host = ""
    if reference is not None:
        host_swaps = _tie_swaps(got_i.cpu().numpy(), reference[0],
                                reference[1], RETRIEVAL_TOL,
                                f"dense_topk {label} vs DenseIndex.topk")
        host = (f"; ids vs DenseIndex.topk (numpy) for all {Q} questions: "
                f"{host_swaps} tie swap(s)")
    del rows

    def library():
        return torch.topk(q @ docs.T, k, dim=1)
    iters = 100 if D < BIG_DOCS else 10
    ms = cuda_ms(lambda: dense_topk(q, docs, k=k), iters)
    plain_ms = cuda_ms(lambda: dense_topk_torch(q, docs, k=k), iters)
    library_ms = cuda_ms(library, iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        dense_topk(q, docs, k=k)
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    cold = ""
    if D * E * 4 < 50e6:
        cold = (f" | kernel, L2 flushed before each launch "
                f"{cuda_ms_cold(lambda: dense_topk(q, docs, k=k)) * 1e3:.2f}"
                f" us")
    nbytes = (Q * E + D * E) * 4 + Q * k * 8
    nops = 2 * Q * D * E
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_tc = 3 * nops / TF32_OPS_PER_S
    bound_ms = max(t_bytes, t_tc) * 1e3
    bound_by = "bytes" if t_bytes >= t_tc else "operations"
    fp32_bound_ms = max(t_bytes, nops / FP32_OPS_PER_S) * 1e3
    launched = kernel_launches(lambda: dense_topk(q, docs, k=k))
    say(f"== kernel dense_topk [{label}: Q={Q} D={D} E={E} k={k}, float32]")
    say(f"   max_abs_err {err:.3e} (tol {RETRIEVAL_TOL:.0e}); ids vs the "
        f"plain version: {swaps} tie swap(s){host}")
    say(f"   kernel {ms * 1e3:.2f} us | plain {plain_ms * 1e3:.2f} us | "
        f"library yardstick torch.topk(q @ docs.T) {library_ms * 1e3:.2f} us "
        f"| wrapper {host_us:.2f} us a call on the host's clock{cold}")
    say(f"   bound {bound_ms * 1e3:.2f} us, {bound_by} ({nbytes / 1e6:.2f} "
        f"MB: {t_bytes * 1e6:.2f} us; 3 x {nops / 1e9:.2f} GFLOP on the TF32 "
        f"tensor cores: {t_tc * 1e6:.2f} us) | the float32 CUDA-core basis "
        f"of the kernel it replaced: {fp32_bound_ms * 1e3:.2f} us | kernel "
        f"at {bound_ms / ms:.1%} of the bound")
    say(f"   kernels a call (torch.profiler, 5 calls): "
        f"{launched or 'not measured (the profiler saw no device activity)'}")
    say(f"   device time by kernel, one call: "
        f"{device_split(lambda: dense_topk(q, docs, k=k))}")
    if not err <= RETRIEVAL_TOL:
        raise AssertionError(f"dense_topk [{label}] scores disagree with "
                             f"its plain version: {err}")
    # the profiler may drop a call's events on this machine, never add one
    if launched and (len(launched) != 1 or max(launched.values()) > 1.0):
        raise AssertionError(f"dense_topk [{label}]: one call launched "
                             f"{launched}, want one kernel")
    return dict(name="dense_topk", route="cuda",
                source="src/repro_torch/kernels/csrc/dense_topk.cu",
                replaces="src/repro/kernels/dense_topk.py:100",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, fp32_bound_ms=fp32_bound_ms,
                host_us=host_us)


def k3_contract_phase(hgmma: int) -> None:
    """K3 across its contract, each against its plain version on seeded
    unit rows (scores within RETRIEVAL_TOL, ids equal but for tie swaps
    within it): k = 64 at the main-path shape (timed beside k = 10),
    ragged Q (5 and 200), D < 64, E = 768, and a corpus of 4,000 rows
    each placed five times at random positions (other tiles, other
    blocks), whose ids must equal the plain version's exactly (equal rows
    score bitwise-equal, exact ties to the lower id)."""
    import torch
    from repro_torch.kernels.dense_topk import dense_topk, dense_topk_torch
    g = torch.Generator(device="cuda").manual_seed(5)

    def unit(n, e):
        x = torch.randn((n, e), generator=g, device="cuda")
        return x / x.norm(dim=1, keepdim=True)
    say(f"== kernel dense_topk across its contract ({hgmma} HGMMA (wgmma) "
        f"instruction(s) in its SASS)")
    times = {}
    for label, Q, D, E, k in (("k = 64", 64, SQUAD_PARAGRAPHS, 256, 64),
                              ("k = 10", 64, SQUAD_PARAGRAPHS, 256, 10),
                              ("Q = 5", 5, SQUAD_PARAGRAPHS, 256, TOP_K),
                              ("Q = 200", 200, SQUAD_PARAGRAPHS, 256, TOP_K),
                              ("D < 64", 64, 37, 256, TOP_K),
                              ("E = 768", 64, SQUAD_PARAGRAPHS, 768, TOP_K),
                              ("duplicated rows", 64, SQUAD_PARAGRAPHS, 256,
                               TOP_K)):
        q = unit(Q, E)
        if label == "duplicated rows":
            base = unit(D // 5, E)
            perm = torch.randperm(D, generator=g, device="cuda")
            docs = base.repeat(5, 1)[perm]
        else:
            docs = unit(D, E)
        got_s, got_i = dense_topk(q, docs, k=k)
        want_s, want_i = dense_topk_torch(q, docs, k=k)
        torch.cuda.synchronize()
        err = (got_s - want_s).abs().max().item()
        if label == "duplicated rows":
            exact = torch.equal(got_i, want_i)
            note = f"ids equal to the plain version's: {exact}"
            if not exact:
                raise AssertionError(f"dense_topk [{label}]: ids differ from "
                                     f"the plain version's")
        else:
            swaps = _tie_swaps(got_i.cpu().numpy(), want_i.cpu().numpy(),
                               (q @ docs.T).cpu().numpy(), RETRIEVAL_TOL,
                               f"dense_topk {label}")
            note = f"{swaps} tie swap(s)"
        if label.startswith("k = "):
            times[label] = cuda_ms(lambda: dense_topk(q, docs, k=k))
            note += f"; kernel {times[label] * 1e3:.2f} us"
        say(f"   [{label}: Q={Q} D={D} E={E} k={min(k, D)}] max_abs_err "
            f"{err:.3e}; {note}")
        if not (err <= RETRIEVAL_TOL and got_s.shape == (Q, min(k, D))):
            raise AssertionError(f"dense_topk [{label}] disagrees with its "
                                 f"plain version: {err}")
        del q, docs
    say(f"   k = 64 takes {times['k = 64'] / times['k = 10']:.2f} x the time "
        f"of k = 10")
    torch.cuda.empty_cache()


def _k5_row(bm25, questions, qtf, csr, doc_len, idf, bm, bm_i,
            csr_s: float) -> dict:
    """Hold K5's result ``bm`` (the main path's launch, through
    ``BM25Index.scores_batch`` on the index's ``BM25Csr``) against the
    plain version on the same inputs and its top-k ``bm_i`` against the
    host's ``BM25Index.topk``; time the call (the row's ``ms``), the
    kernel alone (``kernel_ms``), the plain version, the call on a dense
    ``tf`` (compaction included) and two library yardsticks; compute the
    bound of what this run's data needs, beside the bounds of every
    nonzero and of the dense input."""
    import numpy as np
    import torch
    from repro_torch.kernels import bm25 as k5
    from repro_torch.kernels.bm25 import bm25_scores, bm25_scores_torch
    tf = torch.from_numpy(bm25.tf).cuda()
    want = bm25_scores_torch(qtf, csr, doc_len, idf)
    dense_want = bm25_scores_torch(qtf, tf, doc_len, idf)
    scale = want.abs().max()
    rel = ((bm - want).abs().max() / scale).item()
    dense_in = bm25_scores(qtf, tf, doc_len, idf)
    dense_rel = ((dense_in - want).abs().max() / scale).item()
    plain_rel = ((dense_want - want).abs().max() / scale).item()
    n_host = BM25_HOST_QUESTIONS
    t0 = time.perf_counter()
    host_ids = np.stack([bm25.topk(t, TOP_K)[0]
                         for t in questions[:n_host]])
    host_s = (time.perf_counter() - t0) / n_host
    host_rows = np.stack([bm25.scores_np(bm25.query_vector(t))
                          for t in questions[:n_host]])
    bm25_swaps = _tie_swaps(bm_i[:n_host].cpu().numpy(), host_ids,
                            host_rows,
                            RETRIEVAL_TOL * float(np.abs(host_rows).max()),
                            "bm25_scores top-k vs BM25Index.topk")
    # the yardsticks' inputs, prep untimed: the saturated matrix, dense
    # and as a CSR tensor of the same nonzeros
    k1, b = bm25.cfg.k1, bm25.cfg.b
    norm = k1 * (1 - b + b * doc_len / (doc_len.mean() + 1e-6))
    wq = qtf * idf[None, :]
    sat = tf * (k1 + 1.0) / (tf + norm[:, None])
    sat_csr = torch.sparse_csr_tensor(
        csr.row_ptr.long(), csr.cols.long(),
        csr.vals * (k1 + 1.0) / (csr.vals + norm[k5._csr_rows(csr)]),
        csr.shape)
    wqT = wq.T.contiguous()

    def cublas():
        return wq @ sat.T

    def sparse():
        return torch.sparse.mm(sat_csr, wqT)
    cublas_rel = ((cublas() - want).abs().max() / scale).item()
    sparse_rel = ((sparse().T - want).abs().max() / scale).item()
    # the whole call (the row's time, as every row's), its time on the
    # host's clock back to back, and the kernel alone on the wrapper's
    # prep (untimed, as the yardsticks' prep is)
    ms = cuda_ms(lambda: bm25_scores(qtf, csr, doc_len, idf))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        bm25_scores(qtf, csr, doc_len, idf)
    torch.cuda.synchronize()
    call_wall_ms = (time.perf_counter() - t0) * 10
    kernel = k5._kernel()
    prep = k5._kernel_prep(qtf, doc_len, idf, k1, b)
    kernel_ms = cuda_ms(
        lambda: k5._launch(kernel, *prep[:2], csr, prep[2], k1))
    plain_ms = cuda_ms(lambda: bm25_scores_torch(qtf, csr, doc_len, idf),
                       20)
    dense_ms = cuda_ms(lambda: bm25_scores(qtf, tf, doc_len, idf), 20)
    cublas_ms = cuda_ms(cublas, 20)
    library_ms = cuda_ms(sparse, 20)
    Q, V = qtf.shape
    D, nnz = csr.shape[0], csr.vals.numel()
    used = prep[1]
    n_terms = int(used.sum().item())
    n_used = int(used[csr.cols.long()].sum().item())
    # what this run's data needs: row_ptr, every col (to find the used
    # ones), norm, the used flags and the output; vals and the weights
    # only of the used terms; the saturation (3) and the Q products (2 Q)
    # of each used nonzero.  Beside it the same count over every nonzero
    # and all of wq.
    fixed = (D + 1) * 4 + nnz * 4 + D * 4 + V + Q * D * 4
    nbytes = fixed + n_used * 4 + n_terms * Q * 4
    nops = (2 * Q + 3) * n_used
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    all_bytes = fixed + nnz * 4 + Q * V * 4
    all_ms = max(all_bytes / HBM_BYTES_PER_S,
                 (2 * Q + 3) * nnz / FP32_OPS_PER_S) * 1e3
    dense_bytes = (Q * V + D * V + D + V + Q * D) * 4
    say(f"== kernel bm25 [SQuAD scale: Q={Q} D={D} V={V}, float32, "
        f"{nnz} nonzero tf ({nnz / D:.1f} a document), {n_used} of them "
        f"in the {n_terms} terms of the batch]")
    say(f"   BM25Index.device_csr: compacted on the host and copied with "
        f"doc_len and idf ({(D + 1) * 4 + nnz * 8 + D * 4 + V * 4} bytes) "
        f"in {csr_s * 1e3:.2f} ms, once")
    say(f"   max relative err {rel:.3e} (tol {RETRIEVAL_TOL:.0e}); dense-"
        f"input call {dense_rel:.3e}; plain dense version {plain_rel:.3e}; "
        f"cuBLAS {cublas_rel:.3e}; torch.sparse.mm {sparse_rel:.3e}; "
        f"top-{TOP_K} vs BM25Index.topk (numpy, {host_s:.2f} s a question "
        f"on the host) for the first {n_host} questions: {bm25_swaps} tie "
        f"swap(s)")
    say(f"   call {ms * 1e3:.2f} us on the card (torch prep + kernel; "
        f"{call_wall_ms * 1e3:.2f} us a call on the host's clock) | kernel "
        f"alone {kernel_ms * 1e3:.2f} us | plain (CSR) "
        f"{plain_ms * 1e3:.2f} us | dense-input call, compaction included "
        f"{dense_ms * 1e3:.2f} us | library torch.sparse.mm (CSR of the "
        f"saturated values, prep untimed) {library_ms * 1e3:.2f} us | "
        f"cuBLAS wq @ sat.T (prep untimed) {cublas_ms * 1e3:.2f} us")
    say(f"   bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB: "
        f"{t_bytes * 1e6:.2f} us; {nops / 1e6:.1f} MFLOP: "
        f"{t_ops * 1e6:.2f} us; {bound_by}): call "
        f"{ms / bound_ms:.1f} x, kernel {kernel_ms / bound_ms:.1f} x | "
        f"counting every nonzero and all of wq {all_ms * 1e3:.2f} us "
        f"({all_bytes / 1e6:.2f} MB) | dense-input bound "
        f"{dense_bytes / HBM_BYTES_PER_S * 1e6:.2f} us "
        f"({dense_bytes / 1e6:.2f} MB)")
    say(f"   device time by kernel, one call: "
        f"{device_split(lambda: bm25_scores(qtf, csr, doc_len, idf))}")
    if not (rel <= RETRIEVAL_TOL and dense_rel <= RETRIEVAL_TOL):
        raise AssertionError(f"bm25 disagrees with its plain version: "
                             f"{rel}, dense input {dense_rel}")
    return dict(name="bm25_scores", route="cuda",
                source="src/repro_torch/kernels/csrc/bm25.cu",
                replaces="src/repro/kernels/bm25.py:40",
                max_abs_err=(bm - want).abs().max().item(), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, kernel_ms=kernel_ms)


def retrieval_kernel_phase() -> tuple:
    """K3 and K5 on the batched retrieval path at the SQuAD scale (a
    synthetic corpus of 20,000 paragraphs, 64 questions, k = 10): the
    path's entry points (``DenseIndex.topk_batch``,
    ``BM25Index.scores_batch``) run once with the launch counts set to 0
    just before and read just after; then each kernel is held against its plain version and the
    host's numpy retrieval, and timed.  K3 is held and timed again on
    1,048,576 seeded random unit rows (1 GiB).  Between the two, the
    distributed retrieval over a serving mesh of one NCCL rank
    (``distributed_retrieval_phase``).  Returns the table's main-path
    rows, the path's launch counts and the distributed retrieval's."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticSquad
    from repro_torch.kernels.bm25 import bm25_scores
    from repro_torch.kernels.dense_topk import dense_topk
    from repro_torch.retrieval import BM25Index, DenseIndex
    hgmma = sass_count("dense_topk", "HGMMA")
    say(f"== kernel dense_topk: {hgmma} HGMMA (wgmma) instruction(s) in its "
        f"SASS")
    if not hgmma:
        raise AssertionError("dense_topk's SASS has no HGMMA: the products "
                             "do not run on the tensor cores")
    t0 = time.perf_counter()
    data = SyntheticSquad(n_paragraphs=SQUAD_PARAGRAPHS,
                          n_questions=SQUAD_QUESTIONS, seed=0)
    texts = [p.text for p in data.paragraphs]
    questions = [q.text for q in data.questions]
    t1 = time.perf_counter()
    bm25 = BM25Index.build(texts)
    t2 = time.perf_counter()
    dense = DenseIndex.build(texts)
    t3 = time.perf_counter()
    say(f"== retrieval kernels: SyntheticSquad {len(texts)} paragraphs, "
        f"{len(questions)} questions ({t1 - t0:.1f} s); BM25Index "
        f"{bm25.tf.shape} ({t2 - t1:.1f} s, {(bm25.tf > 0).mean():.4f} "
        f"nonzero); DenseIndex {dense.emb.shape} ({t3 - t2:.1f} s) "
        f"on the host")
    qtf = torch.from_numpy(np.stack([bm25.query_vector(t)
                                     for t in questions])).cuda()
    emb = dense.device_emb("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    csr = bm25.device_csr("cuda")     # compacted on the host, copied once
    torch.cuda.synchronize()
    csr_s = time.perf_counter() - t0
    doc_len, idf = (torch.from_numpy(a).cuda()
                    for a in (bm25.doc_len, bm25.idf))
    if bm25.device_csr("cuda") is not csr:
        raise AssertionError("[retrieval] device_csr was built twice")

    # -- the batched retrieval path, counted -----------------------------
    counters = (dense_topk, bm25_scores)
    for fn in counters:
        fn.launches = 0
    ids, scores = dense.topk_batch(questions, TOP_K)
    bm = bm25.scores_batch(qtf)
    bm_i = torch.topk(bm, TOP_K, dim=1).indices
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    if bm25.device_csr(qtf.device) is not csr:
        raise AssertionError(f"[retrieval] scores_batch on {qtf.device} "
                             f"uploaded the index again")
    say(f"   path: DenseIndex.topk_batch + BM25Index.scores_batch -> "
        f"top-{TOP_K}: launches {launches}")
    if launches != {"dense_topk": 1, "bm25_scores": 1}:
        raise AssertionError(f"[retrieval] launches {launches}: want one "
                             f"of each kernel")
    dist_launches = distributed_retrieval_phase(dense, bm25, questions, qtf,
                                                ids, bm)

    # -- K3: against the plain version and DenseIndex.topk ---------------
    qe = torch.from_numpy(np.stack([dense.encode(t) for t in questions]))
    host_ids = np.stack([dense.topk(t, TOP_K)[0] for t in questions])
    host_rows = np.stack([dense.scores_np(e) for e in qe.numpy()])
    host_err = max(float(np.abs(scores[i] - host_rows[i][host_ids[i]]).max())
                   for i in range(len(questions)))
    if not host_err <= RETRIEVAL_TOL:
        raise AssertionError(f"topk_batch scores vs DenseIndex.topk: "
                             f"{host_err}")
    qe = qe.cuda()
    counted = (torch.from_numpy(scores).cuda(),
               torch.from_numpy(ids).cuda())
    k3 = _k3_row(f"SQuAD scale, topk_batch; scores vs DenseIndex.topk "
                 f"{host_err:.2e}", qe, emb, counted, (host_ids, host_rows))

    # -- K5: against the plain version and BM25Index.topk ----------------
    k5 = _k5_row(bm25, questions, qtf, csr, doc_len, idf, bm, bm_i, csr_s)
    del csr, bm, emb, dense, bm25
    gc.collect()
    torch.cuda.empty_cache()

    # -- K3 at 1,048,576 docs ----------------------------------------------
    g = torch.Generator(device="cuda").manual_seed(2)
    docs = torch.randn((BIG_DOCS, 256), generator=g, device="cuda")
    docs.div_(docs.norm(dim=1, keepdim=True))
    qb = torch.randn((SQUAD_QUESTIONS, 256), generator=g, device="cuda")
    qb.div_(qb.norm(dim=1, keepdim=True))
    k3_1m = _k3_row("1M seeded unit rows", qb, docs,
                    dense_topk(qb, docs, k=TOP_K))
    k3.update(ms_1m=k3_1m["ms"], bound_ms_1m=k3_1m["bound_ms"],
              plain_ms_1m=k3_1m["plain_ms"],
              library_ms_1m=k3_1m["library_ms"], hgmma=hgmma)
    del docs, qb
    torch.cuda.empty_cache()
    k3_contract_phase(hgmma)
    return [k3, k5], launches, dist_launches


@contextlib.contextmanager
def _serving_mesh(cfg=None):
    """``make_serving_mesh("dp=1")`` on the card: with no process group
    it makes an NCCL world of one rank; the group is destroyed on the
    way out, pass or fail, so no later phase inherits it."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serving_mesh
    if dist.is_initialized():
        raise AssertionError("a process group is already initialized")
    try:
        mesh = make_serving_mesh("dp=1", cfg, device="cuda")
        want = "nccl" if mesh.device.type == "cuda" else "gloo"
        if dist.get_backend() != want:
            raise AssertionError(f"process group backend "
                                 f"{dist.get_backend()}, want {want}")
        say(f"   serving mesh dp=1 over NCCL "
            f"{'.'.join(map(str, torch.cuda.nccl.version()))}, world size "
            f"{dist.get_world_size()}, rank device {mesh.device}")
        yield mesh
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def distributed_retrieval_phase(dense, bm25, questions, qtf, ids,
                                bm) -> dict:
    """``DistributedDenseIndex`` and ``DistributedBM25`` over a serving
    mesh of one NCCL rank (dp = 1), on the retrieval phase's corpus and
    questions: one K3 and one K5 launch, counted from 0; the ids of
    ``topk_batch`` (``ids``) and of the stable top-k of
    ``scores_batch``'s scores (``bm``), but for swaps of ids whose scores
    tie within ``RETRIEVAL_TOL``.  Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.kernels.bm25 import bm25_scores
    from repro_torch.kernels.dense_topk import dense_topk
    from repro_torch.retrieval import DistributedBM25, DistributedDenseIndex
    qe = np.stack([dense.encode(t) for t in questions])
    qtf = qtf.cpu().numpy()
    say(f"== distributed retrieval: {len(dense.texts)} paragraphs, "
        f"{len(questions)} questions, k = {TOP_K}")
    with _serving_mesh() as mesh:
        dist_dense = DistributedDenseIndex(mesh, dense.emb)
        dist_bm25 = DistributedBM25(mesh, bm25.tf, bm25.doc_len, bm25.idf)
        torch.cuda.synchronize()
        counters = (dense_topk, bm25_scores)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        d_ids, d_s = dist_dense.topk(qe, TOP_K)
        t1 = time.perf_counter()
        b_ids, b_s = dist_bm25.topk(qtf, TOP_K)
        t2 = time.perf_counter()
        launches = {fn.__name__: fn.launches for fn in counters}
    say(f"   DistributedDenseIndex.topk {1e3 * (t1 - t0):.3f} ms, "
        f"DistributedBM25.topk {1e3 * (t2 - t1):.3f} ms (host clock, the "
        f"first call each, ids back on the host): launches {launches}")
    if launches != {"dense_topk": 1, "bm25_scores": 1}:
        raise AssertionError(f"[distributed retrieval] launches {launches}: "
                             f"want one of each kernel")
    rows = qe @ dense.emb.T
    d_swaps = _tie_swaps(d_ids, ids, rows, RETRIEVAL_TOL,
                         "distributed dense")
    bm = bm.cpu().numpy()
    want = np.argsort(-bm, axis=1, kind="stable")[:, :TOP_K]
    b_swaps = _tie_swaps(b_ids, want, bm, RETRIEVAL_TOL, "distributed bm25")
    d_err = float(np.abs(d_s - np.take_along_axis(rows, d_ids, 1)).max())
    b_err = float(np.abs(b_s - np.take_along_axis(bm, b_ids, 1)).max()
                  / np.abs(bm).max())
    say(f"   ids as topk_batch's ({d_swaps} swap(s) of tied scores) and "
        f"scores_batch's stable top-k ({b_swaps}); scores within "
        f"{d_err:.2e} (dense, absolute) and {b_err:.2e} (bm25, of max)")
    if not (d_err <= RETRIEVAL_TOL and b_err <= RETRIEVAL_TOL):
        raise AssertionError(f"[distributed retrieval] scores {d_err}, "
                             f"{b_err}")
    return launches


def _card_vs_host(model, host, card, **forward_kw) -> float:
    """Prefill of 3 x 12 seeded tokens + 4 greedy decode steps of
    ``model`` on the host (``host`` params) and on the card (``card``
    params, the same values); the card replays the host's tokens so both
    decode the same sequence.  Returns the largest max |dlogit| / max
    |logit| over the steps."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(4, model.cfg.vocab_size,
                                         size=(3, 12)))

    def run(dev, params, feed=None):
        cache = model.init_cache(3, 20, device=dev)
        lg, _ = model.prefill(params, {"tokens": toks.to(dev)}, cache,
                              **forward_kw)
        out, fed = [lg.cpu()], []
        for i in range(4):
            nxt = (feed[i] if feed is not None
                   else lg[:, -1].argmax(-1).to(torch.int32).cpu())
            fed.append(nxt)
            lg, _ = model.decode(params, {"tokens": nxt[:, None].to(dev)},
                                 cache, **forward_kw)
            out.append(lg.cpu())
        return out, fed

    host_logits, fed = run("cpu", host)
    card_logits, _ = run("cuda", card, fed)
    return max(((a - b).abs().max() / a.abs().max()).item()
               for a, b in zip(host_logits, card_logits))


def small_model_phase() -> None:
    """The SMOKE decoder in bf16, prefill + 4 decode steps, card (kernel)
    against host (plain attention) on the same weights and tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.schema import tree_map
    cfg = get_config("qwen1.5-32b", "smoke")
    model = build_model(cfg)
    host = model.init(seed=0, device="cpu")
    card = tree_map(lambda t: t.cuda(), host)
    worst = _card_vs_host(model, host, card)
    say(f"== small: SMOKE bf16 prefill + 4 decode steps, card vs host: "
        f"max |dlogit| / max |logit| = {worst:.3e} (tol 5e-2)")
    if not worst <= 5e-2:
        raise AssertionError(f"SMOKE decoder on the card disagrees with the "
                             f"host: {worst}")
    nan_phase(model, tree_map(lambda t: t * float("nan"), card))


def nan_phase(model, bad) -> None:
    """A real on-device NaN: with every weight NaN, 2 requests on 2
    slots; the executor's isfinite test on the card must trip both slots
    and the scheduler quarantine them (each request failing transiently,
    nothing hanging); with ``health_checks=False`` nothing trips."""
    import torch
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.executor import SingleDeviceExecutor
    for checks in (True, False):
        ex = SingleDeviceExecutor(model, bad, num_slots=2, max_len=32,
                                  max_new_cap=8, sync_every=2,
                                  health_checks=checks)
        eng = ContinuousEngine(executor=ex)
        t0 = time.perf_counter()
        outs = eng.generate_many([[5, 6, 7], [9, 4, 11, 2]],
                                 max_new_tokens=8)
        torch.cuda.synchronize()
        failed = [bool(o.failed and o.transient) for o in outs]
        say(f"== nan: SMOKE with NaN weights on the card, health checks "
            f"{'on' if checks else 'off'}: nan trips "
            f"{eng.stats.n_nan_trips}, quarantined "
            f"{sorted(eng.quarantined_slots)}, failed transiently "
            f"{failed}, {time.perf_counter() - t0:.2f} s")
        want = (2, {0, 1}, [True, True]) if checks else (0, set(),
                                                         [False, False])
        if (eng.stats.n_nan_trips, eng.quarantined_slots, failed) != want:
            raise AssertionError(f"[nan] health checks {checks}: "
                                 f"{eng.stats}, {eng.quarantined_slots}")


def _cheap_draws(train_log, eval_log, rc, jobs, device: str) -> list:
    """``train_policy`` under ``cheap`` for each ``(seed, objective)`` of
    ``jobs`` on ``device``: (refuse share, acc) of each on the eval log.
    :func:`router_phase` runs it in spawned worker processes, each on
    its share of the host's cores."""
    import torch
    from repro_torch.core.actions import REFUSE_ACTION, SLO_PROFILES
    from repro_torch.core.metrics import evaluate_actions
    from repro_torch.core.policy import policy_actions, train_policy
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // ROUTER_WORKERS))
    cheap = SLO_PROFILES["cheap"]
    cheap_rewards = train_log.rewards(cheap)
    out = []
    for seed, obj in jobs:
        tr = train_policy(train_log, cheap_rewards, rc, objective=obj,
                          refusal_cap=ROUTER_CAP, seed=seed, device=device)
        rep = evaluate_actions(
            eval_log, policy_actions(tr.params, eval_log.states, rc),
            cheap, obj)
        out.append((float(rep.action_dist[REFUSE_ACTION]), rep.acc))
    return out


def router_phase(card: str):
    """The paper's router, trained on the card at the FULL testbed
    (``configs/paper_slo_router.py``: 800 train / 200 eval questions
    over 600 paragraphs, the 5-action paper space, 30 epochs): the
    Table 1 grid through ``run_experiment``, the refusal collapse under
    ``cheap``, the card's training against the host's from one initial
    draw, one SLO-conditioned policy routing both profiles, and the
    quickstart's Gateway over the simulator backend.  Returns the
    quality_first Argmax-CE policy trained on the card, which routes the
    serving phases."""
    import numpy as np
    import torch
    from repro_torch.configs import paper_slo_router
    from repro_torch.core.actions import REFUSE_ACTION, SLO_PROFILES
    from repro_torch.core.experiment import run_experiment
    from repro_torch.core.metrics import evaluate_actions
    from repro_torch.core.policy import init_policy, resolve_device
    from repro_torch.routing import (ConditionedPolicy, Gateway, MLPPolicy,
                                     Request, SimulatorBackend)
    cfg = paper_slo_router.FULL
    rc = cfg.router
    steps = -(-cfg.n_train // rc.batch_size)
    say(f"== router: paper_slo_router.FULL, {cfg.n_train} train / "
        f"{cfg.n_eval} eval questions over {cfg.n_paragraphs} paragraphs, "
        f"MLP {rc.state_dim} -> {rc.hidden_dims} -> {rc.n_actions}, "
        f"{rc.n_epochs} epochs of {steps} steps (batch {rc.batch_size}), "
        f"float32")
    res, extras, (train_log, eval_log) = run_experiment(
        cfg, include_mitigation=True, refusal_cap=ROUTER_CAP, verbose=False,
        device="cuda")
    secs = extras["seconds"]
    say(f"   offline log (host, one question at a time): "
        f"{secs['build_testbed']:.2f} s for {train_log.n + eval_log.n} "
        f"questions x {train_log.n_actions} actions")
    for key, hist in extras["train_hist"].items():
        say(f"   train {key:28s} {secs[key]:.3f} s wall, "
            f"{secs[key] / rc.n_epochs * 1e3:.2f} ms an epoch; last epoch "
            f"loss {hist['loss']:.4f}, p_refuse {hist['p_refuse']:.3f}, "
            f"lambda {hist['lambda']:.3f} [{card}]")
    for line in res.table().splitlines():
        say("   " + line)
    say(f"   action distributions: {extras['action_dists']}")
    rows = {(r["slo"], r["method"]): r for r in res.rows}
    best = {r["slo"]: r for r in res.rows
            if r["method"].startswith("best-fixed")}
    ce, con = rows[("cheap", "argmax_ce")], rows[("cheap", "constrained")]
    qf = rows[("quality_first", "argmax_ce")]
    say(f"   Table 1's draw (seed {rc.seed}): cheap constrained refuse "
        f"share {con['action_dist'][REFUSE_ACTION]} and acc {con['acc']} "
        f"against argmax_ce's {ce['action_dist'][REFUSE_ACTION]} and "
        f"{ce['acc']}")
    # At this cap the constraint on the mean refusal probability barely
    # binds (Argmax-CE's own is about 0.5 in training), so one draw
    # decides whether the eval refusals fall; the objective's effect is
    # held on the mean over the draws of seeds 0 .. ROUTER_SEEDS - 1.
    # The 2 x ROUTER_SEEDS trainings are host-bound (a few ms of Python a
    # step of a small MLP), so they train in ROUTER_WORKERS spawned
    # processes at once, nothing else running beside them
    draws = {"argmax_ce": [], "constrained": []}
    jobs = [(seed, obj) for seed in range(ROUTER_SEEDS) for obj in draws]
    device = resolve_device("cuda").type
    t0 = time.perf_counter()
    with ProcessPoolExecutor(ROUTER_WORKERS, mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        parts = pool.map(_cheap_draws, *zip(*[
            (train_log, eval_log, rc, jobs[w::ROUTER_WORKERS], device)
            for w in range(ROUTER_WORKERS)]))
        for w, part in enumerate(parts):
            for (seed, obj), draw in zip(jobs[w::ROUTER_WORKERS], part):
                draws[obj].append((seed, draw))
    draws = {o: [d for _, d in sorted(v)] for o, v in draws.items()}
    ref_share = {o: float(np.mean([d[0] for d in v]))
                 for o, v in draws.items()}
    acc = {o: float(np.mean([d[1] for d in v])) for o, v in draws.items()}
    held = sum(c[0] < a[0] and c[1] > a[1] for a, c in
               zip(draws["argmax_ce"], draws["constrained"]))
    say(f"   cheap over seeds 0..{ROUTER_SEEDS - 1} "
        f"({2 * ROUTER_SEEDS} trainings, {time.perf_counter() - t0:.1f} s): "
        f"mean refuse share {ref_share}, mean acc {acc}; constrained "
        f"refuses less with a higher acc in {held} of {ROUTER_SEEDS} "
        f"draws; argmax_ce refuse share > 0.5 in "
        f"{sum(d[0] > 0.5 for d in draws['argmax_ce'])} of them")
    say(f"     (refuse share, acc) by seed: {draws}")
    checks = {
        "cheap argmax_ce refuses > 0.5": ce["refuse"] > 0.5,
        "cheap argmax_ce acc < 0.2": ce["acc"] < 0.2,
        "cheap argmax_ce reward < best-fixed's":
            ce["reward"] < best["cheap"]["reward"],
        "cheap constrained mean refuse share < argmax_ce's":
            ref_share["constrained"] < ref_share["argmax_ce"],
        "cheap constrained mean acc > argmax_ce's":
            acc["constrained"] > acc["argmax_ce"],
        "quality_first argmax_ce reward > best-fixed's - 0.1":
            qf["reward"] > best["quality_first"]["reward"] - 0.1,
        "quality_first argmax_ce refuses < 0.8": qf["refuse"] < 0.8,
    }
    say(f"   failure mode: {checks}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"[router] the paper's failure mode does not "
                             f"show at FULL size: {failed}")

    # the card's training against the host's, from one host-drawn init
    profile = SLO_PROFILES["quality_first"]
    rewards = train_log.rewards(profile)
    init = init_policy(rc.seed, rc, device="cpu")
    trained = {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trained[dev] = MLPPolicy.train(
            train_log, rewards, rc, init_params=init, device=dev,
            name="MLPPolicy(trained, quality_first argmax_ce)")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        say(f"   quality_first argmax_ce on {dev}, one host-drawn init: "
            f"{wall:.3f} s wall, {wall / rc.n_epochs * 1e3:.2f} ms an epoch")
    card_pol, host_pol = trained["cuda"], trained["cpu"]
    diff = max((card_pol.params[k].cpu() - host_pol.params[k]).abs().max()
               .item() for k in init)
    card_logits = card_pol.logits(eval_log.states)
    host_logits = host_pol.logits(eval_log.states)
    card_acts = card_logits.argmax(-1)
    host_acts = host_logits.argmax(-1)
    off = np.nonzero(card_acts != host_acts)[0]
    top2 = np.sort(host_logits, axis=-1)[:, -2:]
    margins = {int(i): float(top2[i, 1] - top2[i, 0]) for i in off}
    rep = evaluate_actions(eval_log, card_acts, profile, "card")
    say(f"   card vs host: largest param difference {diff:.3e}; "
        f"{len(off)} of {eval_log.n} eval actions disagree (tol "
        f"{ROUTER_MAX_DISAGREE}), host top-two logit margins there "
        f"{margins}; the card's policy: {rep.row()}")
    if len(off) > ROUTER_MAX_DISAGREE:
        raise AssertionError(f"[router] the card's training disagrees with "
                             f"the host's on {len(off)} eval actions")
    us = {n: host_us(lambda n=n: card_pol.route(eval_log.states[:n]),
                     calls=100) for n in (8, 20)}
    say(f"   route a micro-batch on the card (host clock, logits back to "
        f"the host): {us[8]:.1f} us for 8 requests, {us[20]:.1f} us for "
        f"20 [{card}]")

    # one SLO-conditioned policy for both profiles
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cond = ConditionedPolicy.train(
        train_log, [SLO_PROFILES["quality_first"], SLO_PROFILES["cheap"]],
        rc, device="cuda")
    wall = time.perf_counter() - t0
    shares = {slo: float(np.mean(cond.route(eval_log.states, slo).actions
                                 == REFUSE_ACTION))
              for slo in ("quality_first", "cheap")}
    say(f"   conditioned policy (state_dim {cond.cfg.state_dim}, "
        f"{len(cond.train_result.history)} epochs over 5 profiles x "
        f"{train_log.n}): {wall:.3f} s wall; refuse share {shares}")
    if not shares["cheap"] > shares["quality_first"]:
        raise AssertionError(f"[router] the conditioned policy does not "
                             f"refuse more under cheap: {shares}")

    # the quickstart's serving step
    data, index, pipe = extras["testbed"]
    cheap = MLPPolicy.train(train_log,
                            train_log.rewards(SLO_PROFILES["cheap"]), rc,
                            objective="argmax_ce", device="cuda")
    gw = Gateway(cheap, SimulatorBackend(pipe), router_cfg=rc, index=index,
                 max_batch=20, adaptive_refusal=True, base_refusal_share=0.5)
    t0 = time.perf_counter()
    st = gw.serve([Request(qid=q.qid, question=q, slo="cheap")
                   for q in data.questions[-60:]])
    say(f"   Gateway + SimulatorBackend under cheap: served {st.served}, "
        f"avg reward {st.avg_reward:+.4f}, refusal share "
        f"{gw.refusal_share:.2f} (cap history {st.refusal_cap_history}), "
        f"{time.perf_counter() - t0:.2f} s host wall")
    if st.served != 60 or not np.isfinite(st.avg_reward):
        raise AssertionError(f"[router] the simulator Gateway served "
                             f"{st.served} of 60: {st}")
    return card_pol


def profile_phase(gw, reqs, plain_wall_s: float) -> None:
    """One more micro-batch, after the counted main path, under the
    profiler (device activity only): device busy time (the kernels' self
    device time) against the device window between two CUDA events, and
    the kernels that take most of it.  The profiler slows the host's
    launches, so the idle share it shows is an upper bound; the host
    wall beside the unprofiled micro-batch's shows by how much."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        gw.serve(reqs)
        end.record()
        end.synchronize()
        wall_s = time.perf_counter() - t0
    window_ms = start.elapsed_time(end)
    avgs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in avgs) / 1e3
    say(f"== profile: one more micro-batch of the trained router, "
        f"{len(reqs)} requests "
        f"(host wall {wall_s:.2f} s profiled vs {plain_wall_s:.2f} s "
        f"unprofiled)")
    if busy_ms <= 0:
        say(f"   device time not measured (the profiler saw no device "
            f"activity in the {window_ms:.1f} ms window)")
        return
    say(f"   device busy {busy_ms:.1f} ms of a {window_ms:.1f} ms device "
        f"window, idle share {1 - busy_ms / window_ms:.3f}")
    for e in sorted(avgs, key=lambda e: -e.self_device_time_total)[:10]:
        say(f"     {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")


def _instrument(engine) -> dict:
    """Record, for one engine: CUDA events around each decode chunk and
    each admission (prefill + commit) of the dense executor with its
    token rows' shape, the greedy tokens of every finished request keyed
    by its prompt, and (on a paged engine) the peak pages in use after
    each admission round and the admission groups whose suffix is one
    token."""
    import torch
    rec = {"chunks": [], "admits": [], "admit_shapes": [], "tokens": {},
           "peak_pages": 0, "short_prefills": 0}
    prompts = {}
    ex = engine.executor
    run_chunk, admit_group, submit, run = (ex.decode_chunk, ex.admit,
                                           engine.submit, engine.run)

    def timed(fn, key):
        def call(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            rec[key].append((s, e))
            return out
        return call

    def recording_submit(rid, prompt, *a, **kw):
        prompts[rid] = tuple(prompt)
        return submit(rid, prompt, *a, **kw)

    def recording_run():
        done = run()
        for rid, gen in done.items():
            if not gen.failed:
                rec["tokens"][prompts[rid]] = [int(t) for t in gen.tokens]
        return done
    def shaped_admit(tokens, *a):
        rec["admit_shapes"].append(tuple(tokens.shape))
        return admit_group(tokens, *a)
    ex.decode_chunk = timed(run_chunk, "chunks")
    ex.admit = timed(shaped_admit, "admits")
    engine.submit, engine.run = recording_submit, recording_run
    if engine._pages is not None:
        admit = engine._start_admissions
        admit_paged = ex.admit_paged

        def counting_admit_paged(tokens, *a):
            rec["short_prefills"] += tokens.shape[1] == 1
            return admit_paged(tokens, *a)
        ex.admit_paged = counting_admit_paged

        def counting_admit():
            admit()
            rec["peak_pages"] = max(rec["peak_pages"],
                                    engine._pages.pages_in_use)
        engine._start_admissions = counting_admit
    return rec


def _gateways(backend, index, served, n: int, policy):
    """The first ``n`` of: a FixedPolicy(0) gateway, a gateway routing
    with ``policy`` (the router trained in the router phase), both over
    ``backend``."""
    from repro_torch.core.config import RouterConfig
    from repro_torch.routing import FixedPolicy, Gateway
    router = RouterConfig()
    gws = [("FixedPolicy(0)", lambda: Gateway(
                FixedPolicy(0), backend, router_cfg=router, index=index,
                max_batch=8, adaptive_refusal=False,
                on_outcome=lambda *a: served.append(a))),
           (policy.name, lambda: Gateway(
               policy, backend, router_cfg=router, index=index, max_batch=8,
               on_outcome=lambda *a: served.append(a)))]
    return [(name, make()) for name, make in gws[:n]]


def _requests(qs, i):
    from repro_torch.routing import Request
    return [Request(qid=q.qid, question=q, slo="quality_first")
            for q in qs[8 * i: 8 * i + 8]]


def _step_ms(chunks, steps: int) -> float:
    """Device time per decode step over CUDA-event pairs around chunks."""
    return sum(s.elapsed_time(e) for s, e in chunks) / max(steps, 1)


def _check_served(label, served, n_req: int, engine) -> None:
    """Every request served, every generating request produced its
    tokens, no slot quarantined."""
    if len(served) != n_req:
        raise AssertionError(f"[{label}] {len(served)} of {n_req} requests "
                             f"served")
    for req, action, out, _ in served:
        if out.rejected or (not out.refused
                            and out.cost_tokens < MAX_PROMPT_LEN + 1):
            raise AssertionError(f"[{label}] request {req.qid} "
                                 f"(a{action.idx}) did not generate: {out}")
    if engine.stats.n_quarantined or engine.quarantined_slots:
        raise AssertionError(f"[{label}] {engine.stats.n_quarantined} "
                             f"slot(s) quarantined (NaN/inf logits or no "
                             f"progress)")


def _zero(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def _drive(label, backend, index, qs, n_batches, card, n_layers,
           counters, policy) -> dict:
    """Serve ``n_batches`` micro-batches of 8 through ``Gateway.serve``
    with every kernel launch count set to 0 just before and read just
    after, then check: every request served, every generating request
    produced its tokens, at least one request of the trained router's
    batch generated, no slot quarantined.  Returns the launch counts, the
    decode steps, the engine record and the gateways."""
    import torch
    engine = backend.engine
    rec = _instrument(engine)
    served = []
    gateways = _gateways(backend, index, served, n_batches, policy)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _zero(counters)
    t0 = time.perf_counter()
    for i, (name, gw) in enumerate(gateways):
        t_batch = time.perf_counter()
        st = gw.serve(_requests(qs, i))
        torch.cuda.synchronize()
        rec["batch_wall"] = time.perf_counter() - t_batch
        say(f"   {name}: served {st.served}, actions "
            f"{dict(sorted(st.action_counts.items()))}, avg_reward "
            f"{st.avg_reward:+.4f}, rejected {st.rejected}, refusal cap "
            f"history {st.refusal_cap_history}, host wall "
            f"{rec['batch_wall']:.2f} s, latency {st.latency_percentiles()}")
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    es = engine.stats
    steps = es.n_decode_steps
    step_ms = _step_ms(rec["chunks"], steps)
    weight_bytes = _served_weight_bytes(engine.params)
    # an MoE step reads only the experts its rows reach: its bound is
    # printed with the decode step (_say_step_and_prefill), not here
    bound = ("" if engine.model.cfg.moe else
             f" beside the weight-read bound "
             f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms "
             f"({weight_bytes / 1e9:.1f} GB / 3.35 TB/s)")
    rec["step_ms"] = step_ms
    say(f"   engine: admitted {es.n_admitted}, completed {es.n_completed}, "
        f"prefills {es.n_prefills}, decode chunks {es.n_decode_chunks} "
        f"({steps} steps), max concurrent {es.max_concurrent}, "
        f"quarantined {es.n_quarantined}")
    say(f"   decode [{label}]: {step_ms:.2f} ms per step (device time of the "
        f"chunks){bound}; serve wall {wall:.2f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    say(f"   launches {launches} for {n_layers} layers x {steps} decode "
        f"steps")

    _check_served(label, served, 8 * n_batches, engine)
    if n_batches > 1 and all(out.refused for _, _, out, _ in served[8:16]):
        raise AssertionError(f"[{label}] no request of the trained "
                             f"router's batch generated")
    return {"launches": launches, "steps": steps, "rec": rec,
            "gateways": gateways, "wall": wall}


def _check_launches(label, launches, kernel, steps, n_layers,
                    absent=()) -> None:
    if steps == 0 or launches[kernel] != n_layers * steps:
        raise AssertionError(f"[{label}] {kernel} launched "
                             f"{launches[kernel]} times for {steps} decode "
                             f"steps of {n_layers} layers")
    for other in absent:
        if launches[other]:
            raise AssertionError(f"[{label}] {other} launched "
                                 f"{launches[other]} times on this path")


def _check_paged_launches(label, launches, steps, n_layers,
                          short: int) -> None:
    """The paged engine: K2 once a layer per decode step; K1 only for
    admission groups whose suffix is one token (a prompt whose pages but
    its last token were all prefix hits: that token's prefill has a
    single query and takes the decode branch over the dense prefill
    scratch), once a layer each."""
    _check_launches(label, launches, "paged_flash_decode", steps, n_layers)
    if launches["flash_decode"] != n_layers * short:
        raise AssertionError(f"[{label}] flash_decode launched "
                             f"{launches['flash_decode']} times for {short} "
                             f"one-token prefills of {n_layers} layers")


def _free_gpu_memory(label: str) -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    say(f"== {label}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated after freeing the previous engine")


def hybrid_phase(backend, index, data, rec, n_layers, counters) -> None:
    """The retriever-choice action space ``hybrid9`` on the dense
    engine's backend: ``FixedPolicy(3)`` (dense, k=5, guarded), then
    ``FixedPolicy(7)`` (hybrid, k=5, auto), each over 4 questions twice
    (repeats hit the shared retrieval cache).  Checks: every request
    served on its action, cache hits, nothing degraded, no slot
    quarantined, K1 launched 64 times per decode step of this phase."""
    import torch
    from repro_torch.core.config import RouterConfig
    from repro_torch.routing import (FixedPolicy, Gateway, Request,
                                     get_action_space)
    engine, cache = backend.engine, backend.retrieval_cache
    space = get_action_space("hybrid9")
    steps0, chunks0 = engine.stats.n_decode_steps, len(rec["chunks"])
    hits0, lookups0 = cache.hits, cache.lookups
    qs = data.questions[:4] * 2
    served = []
    say(f"== hybrid: hybrid9 space on the dense engine, retrievers "
        f"{sorted(backend.retrievers)}, shared retrieval cache of "
        f"{cache.maxsize}")
    _zero(counters)
    t0 = time.perf_counter()
    for idx in (3, 7):
        a = space[idx]
        gw = Gateway(FixedPolicy(idx), backend, router_cfg=RouterConfig(),
                     index=index, max_batch=8, adaptive_refusal=False,
                     action_space=space,
                     on_outcome=lambda *o: served.append(o))
        st = gw.serve([Request(qid=q.qid, question=q, slo="quality_first")
                       for q in qs])
        torch.cuda.synchronize()
        say(f"   FixedPolicy({idx}) [{a.retriever}, k={a.k}, {a.mode}]: "
            f"served {st.served}, actions "
            f"{dict(sorted(st.action_counts.items()))}, degraded "
            f"{st.degraded}, retrieval cache hits / lookups "
            f"{st.retrieval_cache_hits} / {st.retrieval_cache_lookups}, "
            f"latency {st.latency_percentiles()}")
        if st.served != len(qs) or dict(st.action_counts) != {idx: len(qs)}:
            raise AssertionError(f"[hybrid] FixedPolicy({idx}): served "
                                 f"{st.served}, actions {st.action_counts}")
        if st.degraded:
            raise AssertionError(f"[hybrid] {st.degraded} degraded "
                                 f"lookups")
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    steps = engine.stats.n_decode_steps - steps0
    chunks = rec["chunks"][chunks0:]
    step_ms = _step_ms(chunks, steps)
    hits, lookups = cache.hits - hits0, cache.lookups - lookups0
    say(f"   hybrid: {steps} decode steps in {len(chunks)} chunks, "
        f"{step_ms:.2f} ms per step (device time of the chunks); serve "
        f"wall {wall:.2f} s; cache hits {hits} of {lookups} lookups in "
        f"this phase; launches {launches}")
    _check_served("hybrid", served, 2 * len(qs), engine)
    if hits <= 0:
        raise AssertionError("[hybrid] no retrieval cache hit")
    _check_launches("hybrid", launches, "flash_decode", steps, n_layers,
                    absent=("paged_flash_decode",))


def _closed_loop_rate(dense: dict) -> tuple:
    """The closed-loop dense run's served requests per second and its
    request-latency p50 (ms), over both of its gateways."""
    import numpy as np
    lat = [v for _, gw in dense["gateways"]
           for v in gw.stats.latency._samples]
    return len(lat) / dense["wall"], float(np.percentile(lat, 50))


def _open_loop(label, backend, index, qs, policy, rate, deadline_ms,
               counters) -> dict:
    """One seeded Poisson trace (seed 0, OPEN_LOOP_REQUESTS requests,
    quality_first) replayed in real time through ``AsyncGateway`` over
    ``backend``'s stream protocol, served by the gateway's background
    thread on the engine's perf_counter clock, every launch count 0 just
    before and read just after.  Checks: every offered request resolved;
    the serving thread ran on cuda:0's default stream and was stopped
    before the engine is freed.  The row carries the run's launches and
    decode steps for the caller to check."""
    import threading
    import torch
    from repro_torch.core.config import RouterConfig
    from repro_torch.serving.streaming import AsyncGateway
    from repro_torch.serving.traffic import (LoadGenerator, PoissonProcess,
                                             build_trace)
    engine = backend.engine
    es = engine.stats
    gw = AsyncGateway(policy, backend, router_cfg=RouterConfig(),
                      index=index, deadline_ms=deadline_ms)
    trace = build_trace(qs, PoissonProcess(rate, seed=0),
                        OPEN_LOOP_REQUESTS, slo="quality_first",
                        deadline_ms=deadline_ms)
    seen, threads = {}, []
    poll, start = backend.stream_poll, gw.start

    def probing_poll():
        if not seen:
            seen.update(thread=threading.current_thread().name,
                        device=torch.cuda.current_device(),
                        default=torch.cuda.current_stream()
                        == torch.cuda.default_stream(0))
        return poll()

    def recording_start(**kw):
        out = start(**kw)
        threads.append(gw._thread)
        return out
    backend.stream_poll, gw.start = probing_poll, recording_start
    steps0, hit0, tok0 = (es.n_decode_steps, es.prefill_tokens_avoided,
                          es.prompt_tokens_total)
    torch.cuda.synchronize()
    _zero(counters)
    t0 = time.perf_counter()
    gen = LoadGenerator(gw, trace)
    try:
        rep = gen.run_realtime(timeout_s=180.0)
    finally:
        del backend.stream_poll
    # stop(drain=False) has joined the thread; nothing of it may still be
    # enqueueing when the caller frees the engine
    if any(t is not None and t.is_alive() for t in threads):
        raise AssertionError(f"[{label}] the serving thread outlived stop()")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    steps = es.n_decode_steps - steps0
    handles = gen.last_handles
    # arrivals are stamped on the gateway's perf_counter clock: each
    # one's lag behind its trace time, from the replay's start
    lags = [h.arrival_t - (t0 + a.t) for h, a in zip(handles, trace)]
    row = {"rate": rate, "trace_rate": rep.offered_rate,
           "submitted_rate": len(handles) / (handles[-1].arrival_t - t0),
           "max_lag_ms":
           max(lags) * 1e3, "rep": rep, "served": gw.stats.served,
           "steps": steps, "launches": launches, "wall": wall,
           "prefix_hits": es.prefill_tokens_avoided - hit0,
           "prompt_tokens": es.prompt_tokens_total - tok0}
    if rep.completed != rep.offered:
        raise AssertionError(f"[{label}] {rep.completed} of {rep.offered} "
                             f"offered requests resolved")
    if (seen.get("device") != 0 or not seen.get("default")
            or seen.get("thread") == threading.main_thread().name):
        raise AssertionError(f"[{label}] serving thread {seen}: not on "
                             f"cuda:0's default stream off the main thread")
    return row


def _say_open_loop(label, row, deadline_ms, extra="") -> None:
    rep = row["rep"]
    lat, ft = rep.latency, rep.first_token
    say(f"   {label} {row['rate']:6.3f}/s nominal, {row['trace_rate']:6.3f} "
        f"trace, {row['submitted_rate']:6.3f} submitted (largest arrival "
        f"lag {row['max_lag_ms']:.1f} ms): served {row['served']}, shed "
        f"{rep.shed}, forced refusals {rep.forced_refusals}, depth clamps "
        f"{rep.depth_clamped}, timed out {rep.timed_out}; goodput "
        f"{rep.goodput:.3f}/s ({rep.goodput_fraction:.4f} within "
        f"{deadline_ms:.0f} ms); latency p50 {lat.percentile(50):.1f} p99 "
        f"{lat.percentile(99):.1f} ms, first token p50 "
        f"{ft.percentile(50):.1f} ms; {row['steps']} decode steps, "
        f"launches {row['launches']}; wall {row['wall']:.2f} s{extra}")


def open_loop_phase(backend, index, qs_per_rate, policy, c, deadline_ms,
                    card, n_layers, counters) -> list:
    """The dense engine (K1) under open-loop Poisson traffic at
    OPEN_LOOP_RATES x ``c`` (each rate over questions of its own, so no
    rate finds another's lookups in the retrieval cache): one row per
    rate, then the highest offered rate whose goodput fraction meets the
    latency target's objective."""
    from repro_torch.serving.slo_budget import latency_target
    t0 = time.perf_counter()
    target = latency_target(deadline_ms).objective
    say(f"== open loop, dense (K1): {OPEN_LOOP_REQUESTS} requests a rate, "
        f"Poisson seed 0, deadline {deadline_ms:.0f} ms, goodput target "
        f"{target:.2f} [{card}]")
    rows = []
    for mult, qs in zip(OPEN_LOOP_RATES, qs_per_rate):
        row = _open_loop("open loop dense", backend, index, qs, policy,
                         mult * c, deadline_ms, counters)
        _say_open_loop(f"{mult:4.2f} x c =", row, deadline_ms)
        _check_launches("open loop dense", row["launches"], "flash_decode",
                        row["steps"], n_layers,
                        absent=("paged_flash_decode",))
        rows.append(row)
    ok = [r for r in rows if r["rep"].goodput_fraction >= target]
    best = max(ok, key=lambda r: r["rate"]) if ok else None
    say(f"   highest offered rate meeting the SLO (goodput fraction >= "
        f"{target:.2f}): " + (
            f"{best['rate']:.3f}/s nominal, {best['submitted_rate']:.3f}/s "
            f"submitted" if best else "none of the rates")
        + f"; open loop {time.perf_counter() - t0:.1f} s")
    return rows


def chaos_plans(n_requests: int) -> dict:
    """``benchmarks/chaos_bench.py``'s four seeded plans (name ->
    FaultPlan); windows in site-invocation counts."""
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    brown = max(4, n_requests // 6)
    return {
        "no_faults": FaultPlan(),
        "retriever_brownout": FaultPlan(specs=(
            FaultSpec(site="retriever.dense", kind="raise", start=4,
                      count=brown),), seed=0),
        "executor_fault_burst": FaultPlan(specs=(
            FaultSpec(site="executor.decode", kind="raise", start=6,
                      count=3),), seed=0),
        "nan_storm": FaultPlan(specs=(
            FaultSpec(site="executor.decode", kind="nan", start=5, count=2,
                      slots=(0, 1)),), seed=0),
    }


def _chaos_run(model, params, tok, index, qs, plan, n_layers, counters, *,
               hardened: bool = True) -> dict:
    """One seeded Poisson trace through AsyncGateway over a fresh dense
    engine with ``plan`` armed, entirely in virtual time
    (``benchmarks/chaos_bench.py::run_scenario`` at the main path's
    engine shape).  ``hardened=False`` is the features-off twin: an
    executor without health checks, no breakers, no retries."""
    import numpy as np
    import torch
    from repro_torch.retrieval.hybrid import (IndexRetriever,
                                              collect_breakers,
                                              resolve_retrievers)
    from repro_torch.routing import ContinuousEngineBackend, FixedPolicy
    from repro_torch.routing.registry import Action, ActionSpace
    from repro_torch.serving.executor import SingleDeviceExecutor
    from repro_torch.serving.faults import ChaosInjector, RetryPolicy
    from repro_torch.serving.streaming import AdmissionConfig, AsyncGateway
    from repro_torch.serving.traffic import (LoadGenerator, PoissonProcess,
                                             VirtualClock, build_trace)
    space = ActionSpace("chaos4", (
        Action(0, 0, "refuse"), Action(1, 1, "guarded", "dense"),
        Action(2, 3, "guarded", "dense"), Action(3, 5, "auto", "dense")))
    clock = VirtualClock()
    injector = ChaosInjector(plan, clock=clock.now, sleep=clock.advance)
    retrievers = {"bm25": IndexRetriever("bm25", index),
                  "dense": IndexRetriever("dense", index)}
    max_len = MAX_PROMPT_LEN + MAX_NEW_TOKENS
    executor = None if hardened else SingleDeviceExecutor(
        model, params, num_slots=NUM_SLOTS, max_len=max_len,
        max_new_cap=MAX_NEW_TOKENS, sync_every=4,
        prefill_batch=PREFILL_BATCH, health_checks=False)
    backend = ContinuousEngineBackend.create(
        model, params, tok, index, num_slots=NUM_SLOTS,
        prefill_batch=PREFILL_BATCH, max_prompt_len=MAX_PROMPT_LEN,
        max_new_tokens=MAX_NEW_TOKENS, sync_every=4, clock=clock.now,
        retrievers=retrievers, chaos=injector, breaker_kw=CHAOS_BREAKER,
        executor=executor)
    if not hardened:
        backend.retrievers, backend.retrieval_cache = resolve_retrievers(
            retrievers, index, breakers=False)
        backend.breakers = collect_breakers(backend.retrievers)
    engine = backend.engine
    tokens, prompts, transient = {}, {}, [0]
    submit, poll, stream_poll = (engine.submit, engine.poll,
                                 backend.stream_poll)

    def recording_submit(rid, prompt, *a, **kw):
        prompts[rid] = tuple(prompt)
        return submit(rid, prompt, *a, **kw)

    def recording_poll():
        done = poll()
        for rid, g in done.items():
            if not g.failed:
                tokens[prompts[rid]] = [int(t) for t in g.tokens]
        return done

    def counting_stream_poll():
        done = stream_poll()
        transient[0] += sum(c.outcome.transient and not c.outcome.timed_out
                            for c in done)
        return done
    engine.submit, engine.poll = recording_submit, recording_poll
    backend.stream_poll = counting_stream_poll
    gw = AsyncGateway(
        FixedPolicy(2), backend, action_space=space,
        state_fn=lambda q: np.zeros((len(q), 1)), clock=clock.now,
        deadline_ms=CHAOS_DEADLINE_MS,
        admission=AdmissionConfig(max_backlog=4 * NUM_SLOTS),
        retry=(RetryPolicy(max_retries=2, backoff_s=0.02) if hardened
               else None))
    trace = build_trace(qs, PoissonProcess(CHAOS_RATE, seed=0),
                        CHAOS_REQUESTS, deadline_ms=CHAOS_DEADLINE_MS)
    gen = LoadGenerator(gw, trace)
    torch.cuda.synchronize()
    _zero(counters)
    t0 = time.perf_counter()
    rep = gen.run_virtual(clock, service_quantum_s=CHAOS_QUANTUM_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    recovery = None
    last = injector.last_fire_t()
    if last is not None:
        after = [h.completed_t for h in gen.last_handles
                 if h.outcome is not None and not h.outcome.refused
                 and not getattr(h.outcome, "degraded", False)
                 and h.completed_t is not None and h.completed_t >= last]
        recovery = round(min(after) - last, 4) if after else None
    es = engine.stats
    row = {"rep": rep, "fired": len(injector.fire_log),
           "retries": gw.stats.retries, "faulted": gw.stats.faulted,
           "degraded": gw.stats.degraded, "timed_out": gw.stats.timed_out,
           "shed": gw.stats.shed, "quarantined": es.n_quarantined,
           "nan_trips": es.n_nan_trips, "exec_faults": es.n_exec_faults,
           "watchdog": es.n_watchdog_trips,
           "breaker_trips": sum(b.n_trips for b in backend.breakers.values()),
           "recovery_s": recovery, "tokens": tokens,
           "transient": transient[0], "steps": es.n_decode_steps,
           "launches": launches, "wall": wall,
           "handles": gen.last_handles}
    _check_launches("chaos", launches, "flash_decode", row["steps"],
                    n_layers, absent=("paged_flash_decode",))
    del backend, engine, gw, gen
    return row


def chaos_phase(model, params, tok, index, qs, card, n_layers,
                counters) -> None:
    """The chaos bench's four scenarios on the dense engine (K1) in
    virtual time, each on a fresh engine freed after it, plus the
    features-off twin of ``no_faults``; prints each scenario's counters
    and holds the invariants."""
    t0 = time.perf_counter()
    say(f"== chaos (K1): {CHAOS_REQUESTS} requests a scenario, Poisson "
        f"{CHAOS_RATE:.0f}/s, deadline {CHAOS_DEADLINE_MS:.0f} ms, pump "
        f"quantum {CHAOS_QUANTUM_S * 1e3:.0f} ms (virtual time), chaos4 "
        f"space, FixedPolicy(2), retries 2 x 20 ms, backlog "
        f"{4 * NUM_SLOTS} [{card}]")
    rows = {}
    for name, plan in chaos_plans(CHAOS_REQUESTS).items():
        r = rows[name] = _chaos_run(model, params, tok, index, qs, plan,
                                    n_layers, counters)
        _free_gpu_memory(f"chaos {name}")
        rep = r["rep"]
        say(f"   {name:22s} fired {r['fired']}, retries {r['retries']}, "
            f"faulted {r['faulted']}, degraded {r['degraded']}, quarantined "
            f"{r['quarantined']}, nan trips {r['nan_trips']}, exec faults "
            f"{r['exec_faults']}, timed out {r['timed_out']}, breaker trips "
            f"{r['breaker_trips']}, shed {r['shed']}, recovery "
            f"{r['recovery_s']} s; goodput {rep.goodput:.2f}/s (virtual), "
            f"completed {rep.completed}/{rep.offered}; {r['steps']} decode "
            f"steps, {r['launches']['flash_decode']} K1 launches, wall "
            f"{r['wall']:.2f} s")
        if rep.completed != rep.offered:
            raise AssertionError(f"[chaos {name}] {rep.completed} of "
                                 f"{rep.offered} requests resolved")
    base = rows["no_faults"]
    counts = ("fired", "retries", "faulted", "degraded", "quarantined",
              "nan_trips", "exec_faults", "timed_out", "breaker_trips",
              "watchdog")
    if any(base[k] for k in counts):
        raise AssertionError(f"[chaos no_faults] counters "
                             f"{ {k: base[k] for k in counts} }")
    off = _chaos_run(model, params, tok, index, qs,
                     chaos_plans(CHAOS_REQUESTS)["no_faults"], n_layers,
                     counters, hardened=False)
    _free_gpu_memory("chaos features-off")
    same = off["tokens"] == base["tokens"] and len(base["tokens"]) > 0
    say(f"   no_faults vs features off (no health checks, no breakers, no "
        f"retries): {len(base['tokens'])} requests, greedy tokens "
        f"{'identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("[chaos no_faults] tokens differ from the "
                             "features-off run")
    brown = rows["retriever_brownout"]
    if brown["degraded"] < 1 or brown["faulted"]:
        raise AssertionError(f"[chaos brownout] degraded "
                             f"{brown['degraded']}, faulted "
                             f"{brown['faulted']}")
    burst = rows["executor_fault_burst"]
    if burst["exec_faults"] != 3 or burst["fired"] != 3 or \
            burst["transient"] != burst["retries"] + burst["faulted"] or \
            not burst["transient"]:
        raise AssertionError(
            f"[chaos burst] exec faults {burst['exec_faults']}, fired "
            f"{burst['fired']}, transient completions {burst['transient']} "
            f"!= retries {burst['retries']} + faulted {burst['faulted']}")
    storm = rows["nan_storm"]
    slots = chaos_plans(CHAOS_REQUESTS)["nan_storm"].specs[0].slots
    if not storm["quarantined"] == storm["nan_trips"] == len(slots):
        raise AssertionError(f"[chaos nan storm] quarantined "
                             f"{storm['quarantined']}, nan trips "
                             f"{storm['nan_trips']}, plan slots {slots}")
    say(f"   burst: {burst['transient']} transient completions = "
        f"{burst['retries']} retried inside the deadline + "
        f"{burst['faulted']} faulted; chaos {time.perf_counter() - t0:.1f} "
        f"s")


class _TimedDecode:
    """A model whose ``decode`` calls are bracketed by CUDA events."""

    def __init__(self, model):
        self.model = model
        self.events = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode(self, *a, **kw):
        import torch
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = self.model.decode(*a, **kw)
        e.record()
        self.events.append((s, e))
        return out


def padded_phase(model, params, tok, index, qs, card, n_layers,
                 counters) -> None:
    """The padded-bucket ``Engine`` (K1) on the served params: 8 seeded
    prompts of MAX_PROMPT_LEN tokens, MAX_NEW_TOKENS new, through
    ``Engine.generate`` and ``ContinuousEngine.generate_many`` (8 slots,
    prefill batch 8: the same shapes), greedy tokens identical per
    request trimmed at EOS; then one closed-loop batch of 8 through
    ``Gateway.serve`` over ``EngineBackend`` (one bucket, one
    ``generate`` call).  Each run's wall, decode step (device time of the
    decode calls) and K1 launches."""
    import numpy as np
    import torch
    from repro_torch.core.config import RouterConfig
    from repro_torch.data.tokenizer import trim_at_eos
    from repro_torch.routing import EngineBackend, FixedPolicy, Gateway
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Engine
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(4, model.cfg.vocab_size,
                                 size=MAX_PROMPT_LEN)) for _ in range(8)]
    max_len = MAX_PROMPT_LEN + MAX_NEW_TOKENS
    say(f"== padded (K1): Engine vs ContinuousEngine, 8 prompts of "
        f"{MAX_PROMPT_LEN} tokens, {MAX_NEW_TOKENS} new [{card}]")

    ce = ContinuousEngine(model, params, num_slots=8, max_len=max_len,
                          max_new_cap=MAX_NEW_TOKENS, sync_every=4,
                          prefill_batch=8)
    rec = _instrument(ce)
    torch.cuda.synchronize()
    _zero(counters)
    t1 = time.perf_counter()
    outs = ce.generate_many(prompts, max_new_tokens=MAX_NEW_TOKENS)
    torch.cuda.synchronize()
    ce_wall = time.perf_counter() - t1
    ce_k1 = counters["flash_decode"].launches
    ce_steps = ce.stats.n_decode_steps
    ce_step_ms = _step_ms(rec["chunks"], ce_steps)
    del ce, rec
    _free_gpu_memory("padded")

    timed = _TimedDecode(model)
    eng = Engine(timed, params, max_len=max_len)
    _zero(counters)
    t1 = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=MAX_NEW_TOKENS)
    torch.cuda.synchronize()
    pad_wall, pad_k1 = time.perf_counter() - t1, \
        counters["flash_decode"].launches
    pad_step_ms = _step_ms(timed.events, len(timed.events))
    agree = sum(trim_at_eos(res.tokens[i]) == trim_at_eos(outs[i].tokens)
                for i in range(8))
    say(f"   Engine.generate: {res.n_steps} steps, wall {pad_wall:.2f} s, "
        f"decode step {pad_step_ms:.2f} ms, {pad_k1} K1 launches; "
        f"ContinuousEngine.generate_many: {ce_steps} decode steps, wall "
        f"{ce_wall:.2f} s, decode step {ce_step_ms:.2f} ms, {ce_k1} K1 "
        f"launches; {agree} of 8 requests' greedy tokens identical")
    if agree != 8:
        raise AssertionError(f"[padded] {8 - agree} requests' greedy tokens "
                             f"differ from the continuous engine's")
    _check_launches("padded", {"flash_decode": pad_k1}, "flash_decode",
                    len(timed.events), n_layers)

    timed.events = []
    served = []
    gw = Gateway(FixedPolicy(0), EngineBackend(
        Engine(timed, params, max_len=max_len), tok, index,
        max_prompt_len=MAX_PROMPT_LEN, max_new_tokens=MAX_NEW_TOKENS),
        router_cfg=RouterConfig(), index=index, max_batch=8,
        adaptive_refusal=False, on_outcome=lambda *a: served.append(a))
    torch.cuda.synchronize()
    _zero(counters)
    t1 = time.perf_counter()
    st = gw.serve(_requests(qs, 0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {name: fn.launches for name, fn in counters.items()}
    steps = len(timed.events)
    say(f"   Gateway.serve over EngineBackend: served {st.served}, actions "
        f"{dict(sorted(st.action_counts.items()))}, wall {wall:.2f} s, "
        f"{steps} decode steps at {_step_ms(timed.events, steps):.2f} ms, "
        f"launches {launches}; latency {st.latency_percentiles()}; padded "
        f"{time.perf_counter() - t0:.1f} s")
    if st.served != 8 or any(out.refused for _, _, out, _ in served):
        raise AssertionError(f"[padded] served {st.served}: {served}")
    _check_launches("padded gateway", launches, "flash_decode", steps,
                    n_layers, absent=("paged_flash_decode",))
    del gw, eng, timed


def main_path_phases(card: str, policy, dist_launches: dict) -> dict:
    """qwen1.5-32b FULL behind Gateway.serve, on the dense slot cache
    (then the same engine under open-loop traffic), the chaos scenarios
    and the padded engine on engines of their own, then the paged pool
    (closed and open loop), then the paged int8 pool, then both again
    through ``ShardedExecutor`` (``sharded_serve_phase``, which also
    reports ``dist_launches``, the distributed retrieval's); ``policy``
    (the trained router) routes the second batch of each closed loop and
    the open loops.  Returns each kernel's launches on its own
    closed-loop path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import HashTokenizer, SyntheticSquad
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.models import build_model
    from repro_torch.retrieval import (BM25Index, DenseIndex,
                                       build_retriever_suite)
    from repro_torch.routing import ContinuousEngineBackend

    cfg = get_config("qwen1.5-32b", "full")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    say(f"== main: {cfg.name} FULL, {cfg.n_layers} layers x d_model "
        f"{cfg.d_model}, {model.n_params() / 1e9:.2f} B params bf16, "
        f"seeded init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    data = SyntheticSquad(n_paragraphs=600, n_questions=1000, seed=0)
    texts = [p.text for p in data.paragraphs]
    index = BM25Index.build(texts)
    counters = {"flash_decode": flash_decode,
                "paged_flash_decode": paged_flash_decode}
    # 8 + 8 counted requests, then 8 for the profiled micro-batch
    qs = data.questions[-16:] + data.questions[-24:-16]
    L = cfg.n_layers

    def backend_for(m, retrieval=None, **engine_kw):
        b = ContinuousEngineBackend.create(
            m, params, HashTokenizer(cfg.vocab_size), index,
            num_slots=NUM_SLOTS, prefill_batch=PREFILL_BATCH,
            max_prompt_len=MAX_PROMPT_LEN, max_new_tokens=MAX_NEW_TOKENS,
            **(retrieval or {}), **engine_kw)
        e = b.engine
        say(f"   engine: num_slots {NUM_SLOTS}, prefill_batch "
            f"{PREFILL_BATCH}, max_len {e.max_len}, {engine_kw or 'dense'}, "
            f"cache allocations {e.stats.cache_allocations}, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        return b

    # -- dense slot cache: K1; bm25, dense and hybrid retrievers --------
    backend = backend_for(model, retrieval=dict(
        retrievers=build_retriever_suite(index, DenseIndex.build(texts)),
        retrieval_cache_size=64))
    dense = _drive("dense", backend, index, qs, 2, card, L, counters,
                   policy)
    _check_launches("dense", dense["launches"], "flash_decode",
                    dense["steps"], L, absent=("paged_flash_decode",))
    # read before the profiled batch adds to the gateways' latencies
    c, p50 = _closed_loop_rate(dense)
    profile_phase(dense["gateways"][1][1], _requests(qs, 2),
                  dense["rec"]["batch_wall"])
    hybrid_phase(backend, index, data, dense["rec"], L, counters)
    dense_tokens, dense_step_ms = dense["rec"]["tokens"], \
        dense["rec"]["step_ms"]
    launches = {"flash_decode": dense["launches"]["flash_decode"]}

    # -- open loop on the dense engine: K1 ------------------------------
    deadline_ms = math.ceil(2 * p50 / 100.0) * 100.0
    say(f"== open loop: the closed loop above served c = {c:.3f} "
        f"requests/s, request latency p50 {p50:.1f} ms -> deadline_ms = "
        f"{deadline_ms:.0f} (2 x p50, rounded up to 100 ms)")
    open_qs = [data.questions[100 + 24 * i: 124 + 24 * i]
               for i in range(len(OPEN_LOOP_RATES) + 1)]
    open_loop_phase(backend, index, open_qs[:-1], policy, c, deadline_ms,
                    card, L, counters)
    del dense, backend
    _free_gpu_memory("chaos")

    # -- chaos and the padded engine, each on engines of their own: K1 --
    tok = HashTokenizer(cfg.vocab_size)
    chaos_phase(model, params, tok, index,
                data.questions[300:300 + CHAOS_REQUESTS], card, L, counters)
    padded_phase(model, params, tok, index, data.questions[400:408], card,
                 L, counters)
    _free_gpu_memory("paged")

    # -- paged pool with prefix sharing: K2 -----------------------------
    paged_kw = dict(paged=True, page_size=PAGE_SIZE, num_pages=NUM_PAGES)
    backend = backend_for(model, **paged_kw)
    paged = _drive("paged", backend, index, qs, 2, card, L, counters,
                   policy)
    _check_paged_launches("paged", paged["launches"], paged["steps"], L,
                          paged["rec"]["short_prefills"])
    es = backend.engine.stats
    tokens = paged["rec"]["tokens"]
    common = [k for k in tokens if k in dense_tokens]
    agree = sum(a == b for k in common
                for a, b in zip(tokens[k], dense_tokens[k]))
    total = sum(min(len(tokens[k]), len(dense_tokens[k])) for k in common)
    say(f"   paged: prefix-hit rate {es.prefill_tokens_avoided} / "
        f"{es.prompt_tokens_total} prompt tokens = "
        f"{es.prefill_tokens_avoided / max(es.prompt_tokens_total, 1):.4f}, "
        f"copy-on-write forks {es.n_cow_forks}, evictions "
        f"{es.n_pages_evicted}, deferred admissions "
        f"{es.n_deferred_admissions}, peak pages in use "
        f"{paged['rec']['peak_pages']} of {NUM_PAGES}")
    say(f"   paged: {agree} of {total} greedy tokens agree with the dense "
        f"phase's, over {len(common)} common prompts; decode step "
        f"{paged['rec']['step_ms']:.2f} ms = "
        f"{paged['rec']['step_ms'] / dense_step_ms:.3f} x the dense step's")
    if es.n_deferred_admissions:
        raise AssertionError(f"[paged] {es.n_deferred_admissions} deferred "
                             f"admissions")
    if es.prefill_tokens_avoided <= 0:
        raise AssertionError("[paged] no prompt token was served from a "
                             "shared page")
    launches["paged_flash_decode"] = paged["launches"]["paged_flash_decode"]
    single = {"dense": (dense_tokens, dense_step_ms),
              "paged": (tokens, paged["rec"]["step_ms"])}

    # -- open loop on the paged engine: K2 ------------------------------
    t0 = time.perf_counter()
    say(f"== open loop, paged (K2): 1.00 x c, {OPEN_LOOP_REQUESTS} requests, "
        f"deadline {deadline_ms:.0f} ms [{card}]")
    short0 = paged["rec"]["short_prefills"]
    row = _open_loop("open loop paged", backend, index, open_qs[-1], policy,
                     c, deadline_ms, counters)
    _say_open_loop("1.00 x c =", row, deadline_ms, extra=(
        f"; prefix-hit rate {row['prefix_hits']} / {row['prompt_tokens']} = "
        f"{row['prefix_hits'] / max(row['prompt_tokens'], 1):.4f}; "
        f"{time.perf_counter() - t0:.1f} s"))
    short = paged["rec"]["short_prefills"] - short0
    say(f"   paged open loop: {short} admission group(s) with a one-token "
        f"suffix (K1 on the prefill scratch)")
    _check_paged_launches("open loop paged", row["launches"], row["steps"],
                          L, short)
    del paged, backend
    _free_gpu_memory("int8")

    # -- paged int8 pool: K2 over the dequantized pool ------------------
    model8 = build_model(dataclasses.replace(cfg, kv_quant_int8=True))
    int8 = _drive("paged int8", backend_for(model8, **paged_kw), index, qs,
                  1, card, L, counters, policy)
    _check_paged_launches("paged int8", int8["launches"], int8["steps"], L,
                          int8["rec"]["short_prefills"])
    del int8
    _free_gpu_memory("sharded")
    sharded_serve_phase(card, model, params, index, qs, policy, single,
                        paged_kw, dist_launches)
    return launches


def _count_collectives(fn) -> dict:
    """The ``torch.distributed`` collectives ``fn()`` issues, by name."""
    import torch.distributed as dist
    counts = {"all_reduce": 0, "all_gather": 0, "all_to_all_single": 0}
    real = {name: getattr(dist, name) for name in counts}

    def counting(name):
        def call(*a, **kw):
            counts[name] += 1
            return real[name](*a, **kw)
        return call
    with mock.patch.multiple(dist, **{n: counting(n) for n in counts}):
        fn()
    return counts


ADMIT_REPS = 3


def _time_admission(label: str, ex, collectives: dict) -> dict:
    """One admission group of ``PREFILL_BATCH`` seeded prompts of
    ``MAX_PROMPT_LEN`` tokens (prefill + commit) through ``ex.admit``
    into slots ``0 .. PB - 1`` of an idle engine: a warm call, then the
    median of ``ADMIT_REPS`` calls, each timed with CUDA events from an
    idle stream (the host's enqueueing and the card's work together).
    Checks: every prefill ran on all ``PB`` rows (a wrapper of
    ``model.prefill`` counts them), and one admission issued the
    ``collectives`` given, by name.  Returns the time, the calls' ms and
    the first tokens committed."""
    import numpy as np
    import torch
    pb = ex.prefill_batch
    toks = np.random.default_rng(0).integers(
        4, ex.model.cfg.vocab_size, (pb, MAX_PROMPT_LEN)).astype(np.int32)
    args = (toks, np.arange(pb, dtype=np.int32),
            np.full(pb, MAX_NEW_TOKENS, np.int32))
    rows, real = [], ex.model.prefill

    def admit(*a):
        # the class's admit, not the engine instrumentation's wrapper
        return type(ex).admit(ex, *a)

    def prefill(params, inputs, cache, **kw):
        rows.append(int(inputs["tokens"].shape[0]))
        return real(params, inputs, cache, **kw)
    with mock.patch.object(ex.model, "prefill", prefill):
        admit(*args)
        torch.cuda.synchronize()
        ms = []
        for _ in range(ADMIT_REPS):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            admit(*args)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        counts = _count_collectives(lambda: admit(*args))
        torch.cuda.synchronize()
    if set(rows) != {pb} or len(rows) != ADMIT_REPS + 2:
        raise AssertionError(f"[{label}] prefills of {rows} rows, want "
                             f"{ADMIT_REPS + 2} of {pb}")
    if counts != collectives:
        raise AssertionError(f"[{label}] an admission issued {counts}, "
                             f"want {collectives}")
    return {"ms": float(np.median(ms)), "calls": ms,
            "firsts": ex._host(ex._dtok)[:pb].tolist()}


def sharded_serve_phase(card: str, model, params, index, qs, policy,
                        single: dict, paged_kw: dict,
                        dist_launches: dict) -> None:
    """qwen1.5-32b FULL through ``ShardedExecutor`` over a serving mesh
    of one NCCL rank (dp = 1): the main path's first 8 requests
    (``FixedPolicy(0)``) on the dense slot cache, then on the paged pool,
    each engine on ``params`` as they are (views: no second init) and
    freed before the next.  The decode step is a host-bound time that
    drifts over a run, so each pool serves in turns, single-device,
    sharded, sharded, single-device, and the two are compared over the
    turns.  Checks: every run's tokens identical to the main path's
    single-device runs' (``single[kind] = (tokens by prompt, decode
    step)``), K1 / K2 64 times a decode step, the collectives of one
    decode step (an all-reduce for the embedding and two a layer, one
    all-gather of the logits), no host sync in a sharded decode chunk.
    Each dense turn also times one admission group through its
    executor (``_time_admission``): the sharded one prefills all PB rows
    and adds no collective, every turn commits the same first tokens.
    Then ``--mesh dp=1`` on the serve CLI (SMOKE: the engines above are
    FULL) prints the lines of the run without it.  The process group is
    destroyed at the end."""
    import io
    import torch
    from repro_torch.data import HashTokenizer
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.launch import serve
    from repro_torch.models.schema import tree_leaves
    from repro_torch.routing import ContinuousEngineBackend
    cfg = model.cfg
    L = cfg.n_layers
    counters = {"flash_decode": flash_decode,
                "paged_flash_decode": paged_flash_decode}
    say(f"== sharded: {cfg.name} FULL through ShardedExecutor, "
        f"{NUM_SLOTS} slots, in turns with the single-device executor "
        f"[{card}]")
    sharded = {}
    with _serving_mesh(cfg) as mesh:
        for kind, engine_kw in (("dense", {}), ("paged", paged_kw)):
            want, main_ms = single[kind]
            steps_ms, admits = [], []
            for turn in (None, mesh, mesh, None):
                label = f"{'sharded' if turn else 'single'} {kind}"
                backend = ContinuousEngineBackend.create(
                    model, params, HashTokenizer(cfg.vocab_size), index,
                    num_slots=NUM_SLOTS, prefill_batch=PREFILL_BATCH,
                    max_prompt_len=MAX_PROMPT_LEN,
                    max_new_tokens=MAX_NEW_TOKENS, mesh=turn, **engine_kw)
                ex = backend.engine.executor
                if turn is not None:
                    if any(a is not b for a, b in zip(
                            tree_leaves(ex.params), tree_leaves(params))):
                        raise AssertionError(f"[{label}] the executor "
                                             f"copied a weight at mp = 1")
                    say(f"   {label}: {type(ex).__name__} on {ex.device}, "
                        f"slots [{ex.slot_base}, "
                        f"{ex.slot_base + ex._dactive.shape[0]}), the "
                        f"weights' own tensors, "
                        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                        f"allocated")
                run = _drive(label, backend, index, qs, 1, card, L,
                             counters, policy)
                rec, steps = run["rec"], run["steps"]
                if kind == "dense":
                    _check_launches(label, run["launches"], "flash_decode",
                                    steps, L, absent=("paged_flash_decode",))
                else:
                    _check_paged_launches(label, run["launches"], steps, L,
                                          rec["short_prefills"])
                differ = [p for p in rec["tokens"]
                          if rec["tokens"][p] != want.get(p)]
                if differ or not rec["tokens"]:
                    raise AssertionError(f"[{label}] {len(differ)} of "
                                         f"{len(rec['tokens'])} requests' "
                                         f"tokens differ from the main "
                                         f"path's")
                steps_ms.append(rec["step_ms"])
                served = len(rec["tokens"])
                if kind == "dense":
                    # sharded: only the apply's collectives over model (an
                    # all-reduce for the embedding and two a layer, one
                    # all-gather of the logits), no all-to-all
                    admits.append(_time_admission(label, ex, {
                        "all_reduce": (2 * L + 1) * bool(turn),
                        "all_gather": int(bool(turn)),
                        "all_to_all_single": 0}))
                    say(f"   {label}: one admission group of "
                        f"{PREFILL_BATCH} x {MAX_PROMPT_LEN} tokens "
                        f"(prefill + commit), median of {ADMIT_REPS}: "
                        f"{admits[-1]['ms']:.2f} ms (calls "
                        f"{' / '.join(f'{t:.2f}' for t in admits[-1]['calls'])}"
                        f" ms) [{card}]")
                if turn is not None:
                    sharded[kind] = run["launches"]
                    torch.cuda.synchronize()
                    counts = _count_collectives(ex.decode_chunk)
                    torch.cuda.synchronize()
                    k = ex.sync_every
                    if counts != {"all_reduce": (2 * L + 1) * k,
                                  "all_gather": k, "all_to_all_single": 0}:
                        raise AssertionError(f"[{label}] collectives "
                                             f"{counts}")
                    _check_no_sync(ex, f"{label} decode chunk")
                del backend, ex, run, rec
                _free_gpu_memory(f"{label} done")
            ratio = (steps_ms[1] + steps_ms[2]) / (steps_ms[0] + steps_ms[3])
            say(f"   {kind}: {served} requests' tokens identical to the "
                f"main path's in every turn; decode step in turns single / "
                f"sharded / sharded / single "
                f"{' / '.join(f'{t:.2f}' for t in steps_ms)} ms (the main "
                f"path's {main_ms:.2f}): sharded = {ratio:.3f} x single; "
                f"{counts['all_reduce'] // k} all-reduces and "
                f"{counts['all_gather'] // k} all-gather a step [{card}]")
            if admits:
                if any(a["firsts"] != admits[0]["firsts"] for a in admits):
                    raise AssertionError(f"[sharded admission] first tokens "
                                         f"differ over the turns: "
                                         f"{[a['firsts'] for a in admits]}")
                t = [a["ms"] for a in admits]
                say(f"   dense admission group in turns single / sharded / "
                    f"sharded / single {' / '.join(f'{x:.2f}' for x in t)} "
                    f"ms: sharded = {(t[1] + t[2]) / (t[0] + t[3]):.3f} x "
                    f"single; the sharded executor prefilled all "
                    f"{PREFILL_BATCH} rows and added no collective; first "
                    f"tokens {admits[0]['firsts']} in every turn [{card}]")
        REAL_STEPS["decode"] = _tp_decode_step(model, params, mesh, card)
        say(f"   sharded path launches: K1 {sharded['dense']['flash_decode']}"
            f" (dense), K2 {sharded['paged']['paged_flash_decode']} (paged), "
            f"{L} layers x decode steps, each turn; K3 "
            f"{dist_launches['dense_topk']}, K5 "
            f"{dist_launches['bm25_scores']} (distributed retrieval)")

        base = ["--backend", "continuous", "--variant", "smoke", "-n", "8",
                "--device", "cuda"]
        outs = []
        for argv in (base, base + ["--mesh", "dp=1"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                serve.main(argv)
            outs.append(buf.getvalue().splitlines())
        differ = [(a, b) for a, b in zip(*outs) if a != b]
        say(f"   serve cli --variant smoke -n 8 --mesh dp=1: "
            f"{len(outs[1])} lines, {len(differ)} differ from the run "
            f"without --mesh")
        for line in outs[1][:12]:
            say(f"   | {line}")
        if differ or len(outs[0]) != len(outs[1]):
            raise AssertionError(f"[sharded cli] lines differ: {differ[:4]}")


# the real steps the dry-run phase (16a2) is held against
REAL_STEPS: dict = {}


def _tp_decode_step(model, params, mesh, card: str) -> dict:
    """One decode step of ``NUM_SLOTS`` slots over ``MAX_PROMPT_LEN +
    MAX_NEW_TOKENS``-row caches through the tensor-parallel apply (``tp``
    the mesh's model group, as ``ShardedExecutor`` runs it) and the next
    token's argmax: its collectives (as ``_count_collectives`` counts
    them), K1 launches, the resident bytes before it and the peak during
    it, and its ms (CUDA events, warm)."""
    import torch
    from repro_torch.kernels.flash_decode import flash_decode
    tp = mesh.group("model")
    cache = model.init_cache(NUM_SLOTS, MAX_PROMPT_LEN + MAX_NEW_TOKENS,
                             device=mesh.device)
    tokens = torch.zeros(NUM_SLOTS, 1, dtype=torch.int32, device=mesh.device)

    def step():
        logits, _ = model.decode(params, {"tokens": tokens}, cache, tp=tp)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    step()
    cache["pos"].zero_()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    flash_decode.launches = 0
    counts = _count_collectives(step)
    torch.cuda.synchronize()
    out = {"collectives": counts, "launches": flash_decode.launches,
           "resident": resident, "peak": torch.cuda.max_memory_allocated(),
           "ms": cuda_ms(step, 20)}
    say(f"   one TP decode step ({NUM_SLOTS} slots, "
        f"{MAX_PROMPT_LEN + MAX_NEW_TOKENS}-row caches): {counts}, K1 "
        f"{out['launches']}, resident {resident} B, peak {out['peak']} B, "
        f"{out['ms']:.3f} ms [{card}]")
    del cache
    return out


def _leaf(params, path: str):
    """The tensor at ``path`` in a params tree: "/"-separated keys, a
    number indexes a list or a stacked leaf, ":n" takes its first n
    rows."""
    t = params
    for part in path.split("/"):
        if part.startswith(":"):
            t = t[:int(part[1:])]
        elif part.isdigit():
            t = t[int(part)]
        else:
            t = t[part]
    return t


def _model_flops(model, positions: int, text: int) -> tuple:
    """(FLOPs of one train step by 6 N tokens, a note of the N used).  N
    counts the active parameters: an MoE layer's router and shared
    experts and k / E of its routed experts.  An encoder-decoder's
    encoder parameters run over its frames (``positions`` - ``text``
    of them), the rest over the ``text`` tokens."""
    from repro_torch.models.schema import n_params
    cfg = model.cfg
    n = model.n_params()
    note = "N = every parameter"
    n_moe = (sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
             if cfg.moe else 0)
    if n_moe:
        e = cfg.moe
        routed = n_moe * 3 * cfg.d_model * e.d_ff_expert * e.n_experts
        n = n - routed + routed * e.top_k // e.n_experts
        note = (f"N = {n / 1e9:.3f} B active (router, shared experts and "
                f"{e.top_k} / {e.n_experts} of the routed experts of "
                f"{n_moe} MoE layer(s); {model.n_params() / 1e9:.3f} B in "
                f"all)")
    if cfg.is_encoder_decoder:
        n_enc = sum(n_params(model.schema[k])
                    for k in ("encoder", "enc_pos", "enc_final_norm"))
        note = (f"N = {n_enc / 1e9:.3f} B encoder over {positions - text} "
                f"frames + {(n - n_enc) / 1e9:.3f} B decoder over {text} "
                f"tokens")
        return 6 * (n_enc * (positions - text) + (n - n_enc) * text), note
    return 6 * n * positions, note


def _train_family(arch: str, layers, batch: int, seq: int, card: str,
                  watched, *, label: str = None,
                  lr: float = FAMILY_LR) -> dict:
    """``make_train_step`` (fused loss, the plain attention: the
    reference's only trainable setting; AdamW at ``lr``, warmup 2) for
    TRAIN_STEPS steps on ``arch`` at full width with its depth cut to
    ``layers`` (None: FULL, not cut), seeded weights, over the port's
    ``LMDataset`` at ``batch`` x ``seq`` (a vision config's image patches
    and an audio config's frames drawn by it too).  Checks every loss
    and gradient norm finite, the step-0 loss equal to
    ``forward_train_loss`` under ``no_grad`` on the same params and
    batch, the loss falling, the ``watched`` leaves ("/"-paths, see
    :func:`_leaf`) moving, no K4 launch, an MoE layer's K7 and K8
    launches (three products a layer: K7 forward, rematerialized and dX,
    K8 dW) and no param left requiring grad; prints ms per step (CUDA
    events), positions / s, model FLOPs / s, peak memory and the device
    time of one more step by kernel.  Returns the trained params, the
    model, the optimizer state, the last batch, the steady step's ms and
    the K7 / K8 launches."""
    import torch
    from repro_torch.data.lm_dataset import LMDataset
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    from repro_torch.models.schema import tree_leaves, zeros_from_schema
    from repro_torch.models.transformer import forward_train_loss
    from repro_torch.training import (OptConfig, adamw_init_schema,
                                      make_train_step)
    label = label or f"train {arch}"
    _free_gpu_memory(label)
    cfg, model, params = _build_family(arch, layers, card, label)
    n = model.n_params()
    opt_state = zeros_from_schema(adamw_init_schema(model.schema),
                                  device="cuda")
    ds = LMDataset(cfg, seq)
    batches = ds.batches(batch)
    text = seq - (cfg.n_modality_tokens if cfg.modality == "vision" else 0)
    positions = batch * seq + (batch * cfg.encoder_seq_len
                               if cfg.is_encoder_decoder else 0)
    flops, n_note = _model_flops(model, positions, batch * text)
    extra = {"vision": f" ({cfg.n_modality_tokens} image patches + {text} "
                       f"text tokens a row)",
             "audio": f" text tokens, + {cfg.encoder_seq_len} frames a row "
                      f"through the encoder"}.get(cfg.modality, " tokens")
    say(f"   train state: {n / 1e9:.3f} B params x 12 B (params, "
        f"gradients, float32 AdamW moments) = {n * 12 / 1e9:.1f} GB; data: "
        f"LMDataset, batch {batch} x seq {seq}{extra}; {TRAIN_STEPS} steps, "
        f"lr {lr:g}, warmup 2, remat {cfg.remat!r}")
    step_fn = make_train_step(model, OptConfig(lr=lr, warmup_steps=2,
                                               total_steps=TRAIN_STEPS))

    def leaves():
        return [_leaf(params, w) for w in watched]
    before = [t.float().clone() for t in leaves()]
    first = {k: torch.from_numpy(v).cuda() for k, v in next(batches).items()}
    with torch.no_grad():
        loss0 = float(forward_train_loss(params, cfg, first))
    events, metrics = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    grouped_gemm.launches = grouped_gemm.dw_launches = 0
    for i in range(TRAIN_STEPS):
        b = first if i == 0 else {k: torch.from_numpy(v).cuda() for k, v in
                                  next(batches).items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, m = step_fn(params, opt_state, b)
        end.record()
        events.append((start, end))
        metrics.append(m)
    torch.cuda.synchronize()
    k4_launches = flash_attention.launches
    moe = {"grouped_gemm": grouped_gemm.launches,
           "grouped_gemm_dw": grouped_gemm.dw_launches}
    peak = torch.cuda.max_memory_allocated()
    ms = [s_.elapsed_time(e) for s_, e in events]
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    say(f"   losses {[round(x, 4) for x in losses]}; step 0 under no_grad "
        f"{loss0:.6f} (relative gap {abs(losses[0] - loss0) / abs(loss0):.2e}"
        f", tol {REMAT_RTOL:.0e})")
    say(f"   grad_norm {[round(x, 4) for x in gnorms]}")
    say(f"   lr {[float(m['lr']) for m in metrics]}")
    steady = ms[1:]
    step_ms = sum(steady) / len(steady)
    mfu = flops / (step_ms / 1e3)
    say(f"   ms per step {[round(x, 2) for x in ms]} (CUDA events); steady "
        f"(steps 2..{TRAIN_STEPS}) {step_ms:.2f} ms = "
        f"{positions / step_ms * 1e3:.0f} positions/s; model FLOPs/s "
        f"(6 N positions / step; {n_note}) {mfu / 1e12:.1f} T = "
        f"{mfu / BF16_OPS_PER_S:.3f} of 989 TFLOP/s; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    moved = [(t.float() - b_).abs().max().item()
             for t, b_ in zip(leaves(), before)]
    say(f"   params moved (max |delta| of {', '.join(watched)}): {moved}; "
        f"K4 launches during the train steps: {k4_launches}")
    if not all(math.isfinite(x) for x in losses + gnorms + [loss0]):
        raise AssertionError(f"[{label}] non-finite loss or grad_norm: "
                             f"{losses}, {gnorms}, step 0 {loss0}")
    if abs(losses[0] - loss0) > REMAT_RTOL * abs(loss0):
        raise AssertionError(f"[{label}] step 0's loss {losses[0]} is not "
                             f"forward_train_loss's {loss0}")
    if not all(x > 0 for x in moved):
        raise AssertionError(f"[{label}] params did not move: {moved}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[{label}] the loss did not fall: {losses}")
    if k4_launches:
        raise AssertionError(f"[{label}] K4 launched {k4_launches} times in "
                             f"train steps")
    # an MoE layer's three products: K7 in the forward, again in the
    # rematerialized forward, and for dX; K8 for dW
    n_moe = _moe_layers(cfg)
    forwards = 1 if cfg.remat == "none" else 2
    want = {"grouped_gemm": 3 * n_moe * (forwards + 1) * TRAIN_STEPS,
            "grouped_gemm_dw": 3 * n_moe * TRAIN_STEPS}
    if n_moe:
        say(f"   grouped GEMM launches in the train steps: K7 "
            f"{moe['grouped_gemm']}, K8 {moe['grouped_gemm_dw']} (3 "
            f"products x {n_moe} MoE layer(s) x {TRAIN_STEPS} steps, K7 "
            f"{forwards + 1} times: forward{', remat' * (forwards - 1)} "
            f"and dX; K8 once: dW)")
    if moe != want:
        raise AssertionError(f"[{label}] grouped GEMM launches {moe}, want "
                             f"{want}")
    if any(t.requires_grad for t in tree_leaves(params)):
        raise AssertionError(f"[{label}] params left requiring grad")
    del before, metrics
    say(f"   device time by kernel, one more step (top 10): "
        f"{device_split(lambda: step_fn(params, opt_state, b), 10)}")
    return {"params": params, "model": model, "opt_state": opt_state,
            "batch": b, "step_ms": step_ms, "seq": seq, "rows": batch,
            "launches": moe,
            "record": {"losses": losses, "gnorms": gnorms, "ms": ms,
                       "step_ms": step_ms, "peak": peak, "lr": lr}}


def _eval_family(trained: dict, card: str, label: str) -> tuple:
    """On the trained params, one held batch (``LMDataset`` seed 1, the
    training shape): ``make_eval_step`` with K4
    (``use_pallas_attention=True``) and with the plain attention, by
    CUDA events.  K4 must launch once for each layer the
    reference's gate lets through (GQA, causal, no window, S % 128 ==
    0: :func:`_kernel_layers`) and the two losses agree within
    EVAL_RTOL; each eval is timed on a second call.  Returns (K4's
    launches, the held batch, the K4 model)."""
    import torch
    from repro_torch.data.lm_dataset import LMDataset
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    from repro_torch.training import make_eval_step
    params, model = trained["params"], trained["model"]
    cfg = model.cfg
    k4_model = build_model(dataclasses.replace(cfg,
                                               use_pallas_attention=True))
    want = _kernel_layers(cfg)
    held = {k: torch.from_numpy(v).cuda() for k, v in next(
        LMDataset(cfg, trained["seq"], seed=1).batches(
            trained["rows"])).items()}
    out = {}
    for name, m in (("K4", k4_model), ("plain", model)):
        step = make_eval_step(m)
        torch.cuda.synchronize()
        flash_attention.launches = 0
        loss = float(step(params, held))
        launches = flash_attention.launches
        # timed on a second call: the first pays for the shapes' first
        # library calls
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(params, held)
        end.record()
        torch.cuda.synchronize()
        out[name] = (loss, start.elapsed_time(end), launches)
    (a, k4_ms, launches), (b, plain_ms, plain_launches) = (out["K4"],
                                                           out["plain"])
    rel = abs(a - b) / abs(b)
    say(f"== eval [{label}]: held batch {trained['rows']} x "
        f"{trained['seq']} (LMDataset seed 1): loss with K4 {a:.6f}, plain "
        f"attention {b:.6f}, relative difference {rel:.2e} (tol "
        f"{EVAL_RTOL:.0e}); K4 launches {launches} for the {want} layer(s) "
        f"the gate lets through; eval step {k4_ms:.2f} ms with K4, "
        f"{plain_ms:.2f} ms plain (one warm call each) [{card}]")
    if launches != want or plain_launches:
        raise AssertionError(f"[eval {label}] K4 launched {launches} times "
                             f"(plain: {plain_launches}) for {want} layers")
    if not (math.isfinite(a) and rel <= EVAL_RTOL):
        raise AssertionError(f"[eval {label}] losses disagree: K4 {a}, "
                             f"plain {b}")
    return launches, held, k4_model


def train_phase(card: str) -> dict:
    """:func:`_train_family` on qwen1.5-32b at full width, its depth cut
    64 -> 4, bf16, ``remat="full"``, batch 4 x seq 1024; then, on the
    trained params, the AdamW update and the forward timed alone, and
    :func:`remat_check`.  Returns the trained params and the model."""
    from repro_torch.models.schema import tree_leaves
    from repro_torch.models.transformer import forward_train_loss
    from repro_torch.training import OptConfig, adamw_update
    import torch
    trained = _train_family(QWEN, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, card,
                            QWEN_WATCHED, label="train", lr=3e-4)
    params, opt_state, batch = (trained["params"], trained["opt_state"],
                                trained["batch"])
    cfg, step_ms = trained["model"].cfg, trained["step_ms"]
    # where a step's time goes: the optimizer alone (on zero gradients:
    # the same arithmetic) and the forward alone, against the whole step
    zero = [torch.zeros_like(p) for p in tree_leaves(params)]
    opt_ms = cuda_ms(lambda: adamw_update(zero, opt_state, params,
                                          OptConfig()), 3)
    del zero
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: forward_train_loss(params, cfg, batch), 3)
    say(f"   split: AdamW update {opt_ms:.2f} ms, forward_train_loss "
        f"without autograd {fwd_ms:.2f} ms, so forward + backward with the "
        f"recompute about {step_ms - opt_ms:.2f} ms of the {step_ms:.2f} ms "
        f"step")
    del trained["opt_state"], opt_state
    remat_check(params, cfg, batch)
    return trained


def remat_check(params, cfg, batch) -> None:
    """The three remat modes on the card, one loss and gradient each on
    the same params and batch: the same loss, gradient norms within
    REMAT_RTOL, and the peak memory of each."""
    import torch
    from repro_torch.models.schema import tree_leaves
    from repro_torch.models.transformer import forward_train_loss
    from repro_torch.training.optimizer import global_norm
    leaves = tree_leaves(params)
    out = {}
    for remat in ("full", "dots", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = forward_train_loss(params, c, batch)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        out[remat] = (float(loss.detach()), float(global_norm(grads)),
                      torch.cuda.max_memory_allocated() / 2**30)
        del loss, grads
    say("   remat modes, one loss + gradient each on the same batch: "
        + "; ".join(f"{k}: loss {v[0]:.6f}, grad_norm {v[1]:.6f}, peak "
                    f"{v[2]:.2f} GiB" for k, v in out.items()))
    ref_loss, ref_norm, _ = out["full"]
    for k, (loss, norm, _) in out.items():
        if (abs(loss - ref_loss) > REMAT_RTOL * abs(ref_loss)
                or abs(norm - ref_norm) > REMAT_RTOL * ref_norm):
            raise AssertionError(f"[train] remat {k} disagrees with full: "
                                 f"{out}")


def eval_phase(trained: dict, card: str) -> dict:
    """On the trained params: :func:`_eval_family` (K4 once a layer, the
    losses agreeing), ``forward_train_loss`` under ``torch.no_grad()``
    with K4 (K4 once a layer, the same loss), both eval steps timed; a
    train step with K4 raises the gradient guard.  Returns K4's
    launches on this path."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.schema import zeros_from_schema
    from repro_torch.models.transformer import forward_train_loss
    from repro_torch.training import (OptConfig, adamw_init_schema,
                                      make_eval_step, make_train_step)
    params, model = trained["params"], trained["model"]
    L = model.cfg.n_layers
    launches, held, k4_model = _eval_family(trained, card, model.cfg.name)
    plain_eval, k4_eval = make_eval_step(model), make_eval_step(k4_model)
    plain_loss = float(plain_eval(params, held))
    flash_attention.launches = 0
    with torch.no_grad():
        fused = float(forward_train_loss(params, k4_model.cfg, held))
    torch.cuda.synchronize()
    fused_launches = flash_attention.launches
    k4_ms = cuda_ms(lambda: k4_eval(params, held), 5)
    plain_ms = cuda_ms(lambda: plain_eval(params, held), 5)
    say(f"   forward_train_loss under no_grad with K4 {fused:.6f} "
        f"({fused_launches} K4 launches for {L} layers); eval step "
        f"{k4_ms:.2f} ms with K4, {plain_ms:.2f} ms plain (warm) [{card}]")
    if fused_launches != L:
        raise AssertionError(f"[eval] K4 launched {fused_launches} times in "
                             f"forward_train_loss for {L} layers")
    if not (math.isfinite(fused)
            and abs(fused - plain_loss) / abs(plain_loss) <= EVAL_RTOL):
        raise AssertionError(f"[eval] losses disagree: plain {plain_loss}, "
                             f"fused {fused}")
    opt_state = zeros_from_schema(adamw_init_schema(model.schema),
                                  device="cuda")
    flash_attention.launches = 0
    try:
        make_train_step(k4_model, OptConfig())(params, opt_state, held)
    except RuntimeError as e:
        if "no gradient" not in str(e):
            raise
        say(f"   train step with K4 raises: {e}")
    else:
        raise AssertionError("[eval] a train step through K4 did not raise")
    if int(opt_state["step"]) != 0 or flash_attention.launches:
        raise AssertionError("[eval] the refused train step changed state")
    return {"flash_attention": launches}


def train_families_phase(card: str, records: dict = None) -> dict:
    """Every served family trained and evaluated on the card, each after
    the previous model is freed (TRAIN_FAMILIES: dbrx-132b's MoE,
    minicpm3-4b's MLA, deepseek-v3-671b's MLA + MTP, gemma3-12b's sliding
    window, phi-3-vision-4.2b's image projector, whisper-large-v3's
    encoder): :func:`_train_family`, then :func:`_eval_family`; then
    :func:`microbatch_phase`.  Returns K4's launches in each family's
    eval and K8's in its train steps, keyed by arch, for the kernel
    table's rows at their shapes;
    each run's losses, gradient norms and times go into ``records``
    (by arch), for :func:`sharded_train_phase`."""
    t0 = time.perf_counter()
    out = {}
    for arch, layers, batch, seq, watched in TRAIN_FAMILIES:
        trained = _train_family(arch, layers, batch, seq, card, watched)
        if records is not None:
            records[arch] = trained["record"]
        del trained["opt_state"], trained["batch"]
        k4, held, k4_model = _eval_family(trained, card, arch)
        out[arch] = {"flash_attention": k4,
                     "grouped_gemm_dw":
                         trained["launches"]["grouped_gemm_dw"]}
        if arch == WHISPER:
            # phase 16w's K4 and eval parts, where the weights live
            whisper_tp_eval(card, trained, held, k4_model)
        del trained, held, k4_model
    microbatch_phase(card)
    say(f"== train families: {time.perf_counter() - t0:.1f} s")
    return out


def microbatch_phase(card: str) -> None:
    """One train step of qwen1.5-32b cut to TRAIN_LAYERS at batch
    TRAIN_BATCH x TRAIN_SEQ with ``microbatches`` 1, 2 and 4, each from
    its own ``model.init(seed=0)`` and on the same batch: the loss and the
    gradient norm within REMAT_RTOL of the single batch's, the watched
    leaves after the update within one AdamW sign flip (2 lr: a first
    step moves each element by lr x g / (|g| + eps)) plus one bf16 step
    at the leaf's largest entry; the share of elements that differ is
    printed.
    Microbatching bounds the saved activations to one microbatch's and
    adds float32 accumulators (4 B a param): the peak of the gradient
    computation (read just before the update) less the memory the step
    starts with and less the accumulators must fall as microbatches
    grow.  Prints each run's step ms, whole-step peak and that split."""
    import torch
    from repro_torch.data.lm_dataset import LMDataset
    from repro_torch.models import build_model
    from repro_torch.models.schema import tree_leaves, zeros_from_schema
    from repro_torch.training import (OptConfig, adamw_init_schema,
                                      make_train_step)
    from repro_torch.training import steps as train_steps
    _free_gpu_memory("train microbatched")
    from repro_torch.configs import get_config
    model = build_model(dataclasses.replace(get_config(QWEN, "full"),
                                            n_layers=TRAIN_LAYERS))
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(
        LMDataset(model.cfg, TRAIN_SEQ).batches(TRAIN_BATCH)).items()}
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    real_update = train_steps.adamw_update
    runs = {}
    for mb in MICROBATCHES:
        params = model.init(seed=0, device="cuda")
        opt_state = zeros_from_schema(adamw_init_schema(model.schema),
                                      device="cuda")
        accum = (sum(p.numel() for p in tree_leaves(params)) * 4
                 if mb > 1 else 0)
        step_fn = make_train_step(model, opt_cfg, microbatches=mb)
        grad_peak = []

        def update(*a, **kw):
            grad_peak.append(torch.cuda.max_memory_allocated())
            return real_update(*a, **kw)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with mock.patch.object(train_steps, "adamw_update", update):
            start.record()
            params, opt_state, m = step_fn(params, opt_state, batch)
            end.record()
        torch.cuda.synchronize()
        acts = grad_peak[0] - base - accum
        runs[mb] = dict(
            loss=float(m["loss"]), gnorm=float(m["grad_norm"]),
            lr=float(m["lr"]), ms=start.elapsed_time(end),
            peak=torch.cuda.max_memory_allocated() / 2**30,
            grad_peak=(grad_peak[0] - base) / 2**30, accum=accum / 2**30,
            acts=acts / 2**30,
            leaves=[_leaf(params, w).float().clone() for w in QWEN_WATCHED])
        say(f"== train microbatched [{QWEN}, {TRAIN_LAYERS} layers, "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}, microbatches {mb}]: loss "
            f"{runs[mb]['loss']:.6f}, grad_norm {runs[mb]['gnorm']:.6f}, "
            f"step {runs[mb]['ms']:.2f} ms (CUDA events, the first step); "
            f"peak {runs[mb]['peak']:.2f} GiB; gradient computation "
            f"{runs[mb]['grad_peak']:.2f} GiB above the "
            f"{base / 2**30:.2f} GiB of params, moments and batch, of which "
            f"{runs[mb]['accum']:.2f} GiB float32 accumulators and "
            f"{runs[mb]['acts']:.2f} GiB activations and gradients [{card}]")
        del params, opt_state, m, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    one = runs[MICROBATCHES[0]]
    bound = 2 * one["lr"]
    for mb, r in runs.items():
        gaps, share = [], []
        for a, b in zip(r["leaves"], one["leaves"]):
            ulp = 2.0 ** (math.floor(math.log2(b.abs().max().item())) - 7)
            gap = (a - b).abs()
            gaps.append(gap.max().item())
            share.append((gap > 0).float().mean().item())
            if gap.max().item() > bound + ulp:
                raise AssertionError(f"[microbatched {mb}] a leaf moved "
                                     f"{gap.max().item()} from the single "
                                     f"batch's: over {bound + ulp}")
        say(f"   microbatches {mb} against 1: loss gap "
            f"{abs(r['loss'] - one['loss']) / abs(one['loss']):.2e}, "
            f"grad_norm gap {abs(r['gnorm'] - one['gnorm']) / one['gnorm']:.2e}"
            f" (tol {REMAT_RTOL:.0e}); leaves' max gaps {gaps} (bound 2 lr "
            f"= {bound:.1e} + one bf16 step), share of elements that differ "
            f"{share}")
        if (abs(r["loss"] - one["loss"]) > REMAT_RTOL * abs(one["loss"])
                or abs(r["gnorm"] - one["gnorm"]) > REMAT_RTOL * one["gnorm"]):
            raise AssertionError(f"[microbatched {mb}] loss / grad_norm "
                                 f"{r['loss']}, {r['gnorm']} against "
                                 f"{one['loss']}, {one['gnorm']}")
    acts = [runs[mb]["acts"] for mb in MICROBATCHES]
    if not all(x > y for x, y in zip(acts, acts[1:])):
        raise AssertionError(f"[microbatched] the gradient computation's "
                             f"memory beside the accumulators did not fall: "
                             f"{acts} GiB for microbatches {MICROBATCHES}")


def _sharded_run(label: str, arch: str, layers, batch: int, seq: int,
                 card: str, lr: float, steps: int, *, capacity=None,
                 evaluate: bool = False, twin: bool = False) -> dict:
    """``make_sharded_train_step`` for ``steps`` steps on ``arch`` at full
    width cut to ``layers``, from :func:`_train_family`'s seeded weights
    and ``LMDataset`` batches (the same draws, so its single-device run
    is the twin), on a dp = 1 mesh over an NCCL group of one rank: the
    params and AdamW moments as the rank's shards (at dp = 1 the leaves
    themselves), each layer's weights gathered (a copy) inside its
    rematerialized body.  With ``capacity`` the MoE layers take
    ``make_ep_moe_fn`` at that capacity factor.  Records each step's
    metrics, ms (CUDA events), collectives by kind and routed / kept
    rows, the peak memory and the peak of live gathered bytes; with
    ``twin``, before each step, the single-device loss and gradient norm
    (``forward_train_loss``, the routed form) at the same params and
    batch; with ``evaluate`` also the sharded eval step with K4 beside
    ``make_eval_step`` with K4 and without on the trained shards."""
    import torch
    from repro_torch.data.lm_dataset import LMDataset
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.moe_parallel import make_ep_moe_fn
    from repro_torch.models import build_model
    from repro_torch.models import collectives as C
    from repro_torch.models.schema import tree_leaves
    from repro_torch.models.transformer import forward_train_loss
    from repro_torch.training import OptConfig, make_eval_step
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.steps import value_and_grads
    from repro_torch.training.sharded import (init_opt_state,
                                              make_sharded_eval_step,
                                              make_sharded_train_step,
                                              shard_params)
    _free_gpu_memory(label)
    cfg, model, params = _build_family(arch, layers, card, label)
    out = {"cfg": cfg}
    with _serving_mesh(cfg) as mesh:
        local = shard_params(model, mesh, params)
        views = all(a is b for a, b in zip(tree_leaves(local),
                                           tree_leaves(params)))
        del params
        opt = init_opt_state(model, mesh)
        routed = []
        moe_fn = None
        if capacity is not None:
            ep = make_ep_moe_fn(mesh, capacity_factor=capacity)

            def moe_fn(p, x, c):
                st = {}
                y, aux = ep(p, x, c, stats=st)
                routed.append(st)
                return y, aux
        step = make_sharded_train_step(
            model, OptConfig(lr=lr, warmup_steps=2, total_steps=TRAIN_STEPS),
            mesh, moe_fn=moe_fn)
        batches = LMDataset(cfg, seq).batches(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        flash_attention.launches = 0
        C.reset_counts()
        events, metrics, issued, kept, twins = [], [], [], [], []
        for _ in range(steps):
            b = {k: torch.from_numpy(v).cuda()
                 for k, v in next(batches).items()}
            if twin:
                loss, grads = value_and_grads(
                    lambda p, mb: forward_train_loss(p, cfg, mb), local, [b])
                twins.append((float(loss), float(global_norm(grads))))
                del grads
            routed.clear()
            C.ISSUED.clear()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            local, opt, m = step(local, opt, b)
            end.record()
            events.append((start, end))
            metrics.append(m)
            issued.append(dict(C.ISSUED))
            # the forward's calls (the rematerialized forward repeats them)
            n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
            kept.append([(st["routed"], st["kept"]) for st in routed[:n_moe]])
        torch.cuda.synchronize()
        out.update(
            views=views, issued=issued,
            losses=[float(m["loss"]) for m in metrics],
            gnorms=[float(m["grad_norm"]) for m in metrics],
            ms=[a.elapsed_time(e) for a, e in events],
            peak=torch.cuda.max_memory_allocated(), resident=resident,
            gathered_peak=C.GATHERED["peak"],
            train_k4=flash_attention.launches,
            kept=[[(r, int(k)) for r, k in step_] for step_ in kept],
            twins=twins,
            nccl=".".join(map(str, torch.cuda.nccl.version())))
        out["step_ms"] = sum(out["ms"][1:]) / max(1, len(out["ms"]) - 1)
        if evaluate:
            held = {k: torch.from_numpy(v).cuda() for k, v in next(
                LMDataset(cfg, seq, seed=1).batches(batch)).items()}
            k4_model = build_model(dataclasses.replace(
                cfg, use_pallas_attention=True))
            sharded_eval = make_sharded_eval_step(k4_model, mesh)
            torch.cuda.synchronize()
            flash_attention.launches = 0
            C.ISSUED.clear()
            out["eval"] = float(sharded_eval(local, held))
            torch.cuda.synchronize()
            out["eval_k4"] = flash_attention.launches
            out["eval_issued"] = dict(C.ISSUED)
            out["eval_single_k4"] = float(make_eval_step(k4_model)(local,
                                                                   held))
            out["eval_plain"] = float(make_eval_step(model)(local, held))
            out["eval_ms"] = cuda_ms(lambda: sharded_eval(local, held), 3)
            out["eval_single_ms"] = cuda_ms(
                lambda: make_eval_step(k4_model)(local, held), 3)
        del local, opt
    return out


def single_device_records(card: str) -> dict:
    """The two single-device runs :func:`sharded_train_phase` is held
    against, run alone: phase 12's qwen training and 16a0's dbrx one
    (the whole script takes them from those phases)."""
    records = {}
    for arch, layers, batch, seq, watched in TRAIN_FAMILIES[:1]:
        records[arch] = _train_family(arch, layers, batch, seq, card,
                                      watched)["record"]
    records[QWEN] = _train_family(QWEN, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ,
                                  card, QWEN_WATCHED, label="train",
                                  lr=3e-4)["record"]
    return records


def _gap(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def sharded_train_phase(card: str, records: dict) -> dict:
    """Multi-GPU training on one card: ``make_sharded_train_step`` over
    a dp = 1 mesh (an NCCL group of one rank), held against the
    single-device runs of phases 12 and 16a0 (``records``: their losses,
    gradient norms, ms and peaks, on the same seeded weights and
    batches; one card cannot hold two train states of these models, so
    the turns are whole runs, single first, in this call).

    qwen1.5-32b at full width cut to 4 layers, 4 x 1024, lr 3e-4, 8
    steps without ``moe_fn``: every loss and gradient norm within
    SHARDED_RTOL of the single-device step's, the largest gap printed;
    the collectives a step by kind; ms a step and the ratio; peak
    memory and the peak of live gathered bytes; then the sharded eval
    step with K4 on the trained shards (K4 once a layer: 4) against
    ``make_eval_step`` with K4 (SHARDED_RTOL) and without (EVAL_RTOL).
    dbrx-132b at full width cut to 1 layer, 4 x 1024, lr 1e-4, through
    ``make_ep_moe_fn`` (E = 16, E_loc = 16 at dp = 1): at capacity 4.0 =
    E / k no routed row drops, each step's loss and gradient norm are
    the routed form's at the same params and batch within
    SHARDED_RTOL, and the whole run stays within EP_DRIFT_RTOL of
    16a0's (its step 0 within SHARDED_RTOL); 6 ``all_to_all`` a step (2
    a MoE layer forward, 2 for its rematerialized forward, 2 backward);
    then, from the same seeded init, 3 steps at capacity 1.25 with the
    share of routed rows dropped.  Returns K4's launches in the sharded
    eval."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    for key, arch, layers, lr, capacity, evaluate in (
            ("qwen", QWEN, TRAIN_LAYERS, 3e-4, None, True),
            ("dbrx", DBRX, 1, FAMILY_LR, EP_CAPACITY, False)):
        single = records[arch]
        label = f"sharded train {arch}" + (
            f" (EP at capacity {capacity})" if capacity else "")
        run = _sharded_run(label, arch, layers, TRAIN_BATCH, TRAIN_SEQ, card,
                           lr, TRAIN_STEPS, capacity=capacity,
                           evaluate=evaluate, twin=capacity is not None)
        if run["twins"]:
            # the routed form at the same params each step: the EP
            # block's products sum over rows in another order, and eight
            # bf16 Adam steps carry that apart (the whole run's gap is
            # printed against EP_DRIFT_RTOL)
            twin_l = _gap(run["losses"], [t[0] for t in run["twins"]])
            twin_g = _gap(run["gnorms"], [t[1] for t in run["twins"]])
            say(f"   the routed form (K7 / K8) at the same params and batch, "
                f"each "
                f"step: losses {[round(t[0], 6) for t in run['twins']]}, "
                f"grad_norm {[round(t[1], 6) for t in run['twins']]}; "
                f"largest relative gap {twin_l:.3e} / {twin_g:.3e} (tol "
                f"{SHARDED_RTOL:.0e}) [{card}]")
            if not (twin_l <= SHARDED_RTOL and twin_g <= SHARDED_RTOL):
                raise AssertionError(f"[{label}] EP is not the routed form at "
                                     f"the same params: {twin_l}, "
                                     f"{twin_g}")
        run_tol = EP_DRIFT_RTOL if run["twins"] else SHARDED_RTOL
        gap_l = _gap(run["losses"], single["losses"])
        gap_g = _gap(run["gnorms"], single["gnorms"])
        kinds = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all")
        per_step = [tuple(i.get(k, 0) for k in kinds) for i in run["issued"]]
        say(f"   dp = 1 mesh over NCCL {run['nccl']}; the shards are the "
            f"leaves themselves: {run['views']}")
        say(f"   losses sharded {[round(x, 6) for x in run['losses']]}, "
            f"single-device {[round(x, 6) for x in single['losses']]}; "
            f"largest relative gap {gap_l:.3e} (tol {run_tol:.0e}) "
            f"[{card}]")
        say(f"   grad_norm sharded {[round(x, 6) for x in run['gnorms']]}, "
            f"single {[round(x, 6) for x in single['gnorms']]}; largest "
            f"relative gap {gap_g:.3e}")
        say(f"   collectives a step ({', '.join(kinds)}): {per_step[0]}"
            f"{'' if len(set(per_step)) == 1 else f' (varying: {per_step})'}")
        ratio = run["step_ms"] / single["step_ms"]
        say(f"   ms a step (CUDA events) sharded "
            f"{[round(x, 2) for x in run['ms']]}, steady {run['step_ms']:.2f}; "
            f"single-device steady {single['step_ms']:.2f}; ratio "
            f"{ratio:.3f}; peak memory {run['peak'] / 2**30:.2f} GiB "
            f"(single {single['peak'] / 2**30:.2f}); live gathered weights "
            f"at most {run['gathered_peak'] / 2**30:.3f} GiB [{card}]")
        if run["train_k4"]:
            raise AssertionError(f"[{label}] K4 launched {run['train_k4']} "
                                 f"times in train steps")
        first = abs(run["losses"][0] - single["losses"][0]) / abs(
            single["losses"][0])
        if not (gap_l <= run_tol and gap_g <= run_tol
                and first <= SHARDED_RTOL):
            raise AssertionError(f"[{label}] the sharded step is not the "
                                 f"single-device step: {gap_l}, {gap_g}")
        if run["peak"] >= 80e9:
            raise AssertionError(f"[{label}] peak {run['peak']} B")
        if key == "qwen":
            REAL_STEPS["train"] = {
                "collectives": run["issued"][0], "launches": run["train_k4"],
                "resident": run["resident"], "peak": run["peak"],
                "ms": run["step_ms"]}
        out[key] = {"gap_loss": gap_l, "gap_gnorm": gap_g,
                    "collectives": dict(zip(kinds, per_step[0])),
                    "step_ms": run["step_ms"], "ratio": ratio,
                    "peak_gib": run["peak"] / 2**30}
        if capacity is not None:
            n_moe = sum(run["cfg"].is_moe_layer(i)
                        for i in range(run["cfg"].n_layers))
            want = 6 * n_moe
            drops = [sum(r - k for r, k in st) for st in run["kept"]]
            say(f"   all_to_all a step: {per_step[0][3]} (expected {want}: "
                f"2 a MoE layer forward, 2 for its rematerialized forward, "
                f"2 backward); routed rows dropped a step at capacity "
                f"{capacity}: {drops} of {run['kept'][0][0][0]}")
            if per_step[0][3] != want or any(drops):
                raise AssertionError(f"[{label}] all_to_all {per_step[0][3]}"
                                     f", drops {drops}")
            drop = _sharded_run(f"sharded train {arch} (EP at capacity "
                                f"{EP_DROP_CAPACITY})", arch, layers,
                                TRAIN_BATCH, TRAIN_SEQ, card, lr,
                                EP_DROP_STEPS, capacity=EP_DROP_CAPACITY)
            shares = [sum(r - k for r, k in st) / sum(r for r, _ in st)
                      for st in drop["kept"]]
            say(f"   capacity {EP_DROP_CAPACITY}: share of routed rows "
                f"dropped a step {[round(x, 4) for x in shares]}; losses "
                f"{[round(x, 6) for x in drop['losses']]} (capacity "
                f"{capacity}: {[round(x, 6) for x in run['losses'][:3]]}); "
                f"grad_norm {[round(x, 6) for x in drop['gnorms']]}; ms a "
                f"step {[round(x, 2) for x in drop['ms']]}; peak "
                f"{drop['peak'] / 2**30:.2f} GiB [{card}]")
            if not all(math.isfinite(x) for x in drop["losses"]
                       + drop["gnorms"]):
                raise AssertionError(f"[{label}] capacity "
                                     f"{EP_DROP_CAPACITY}: {drop}")
            out[key]["drop_shares"] = shares
        if evaluate:
            want = _kernel_layers(run["cfg"])
            gap = abs(run["eval"] - run["eval_single_k4"]) / abs(
                run["eval_single_k4"])
            gap_plain = abs(run["eval"] - run["eval_plain"]) / abs(
                run["eval_plain"])
            say(f"== sharded eval [{arch}]: loss {run['eval']:.6f} with K4 "
                f"({run['eval_k4']} launches for the {want} layers the "
                f"gate lets through), make_eval_step with K4 "
                f"{run['eval_single_k4']:.6f} (gap {gap:.2e}, tol "
                f"{SHARDED_RTOL:.0e}), plain {run['eval_plain']:.6f} (gap "
                f"{gap_plain:.2e}, tol {EVAL_RTOL:.0e}); collectives "
                f"{run['eval_issued']}; {run['eval_ms']:.2f} ms sharded, "
                f"{run['eval_single_ms']:.2f} ms single (warm) [{card}]")
            if run["eval_k4"] != want or gap > SHARDED_RTOL \
                    or gap_plain > EVAL_RTOL:
                raise AssertionError(f"[sharded eval] K4 {run['eval_k4']}, "
                                     f"gaps {gap}, {gap_plain}")
            out["flash_attention"] = run["eval_k4"]
    say(f"   sharded train counts: {json.dumps(out)}")
    say(f"== sharded train: {time.perf_counter() - t0:.1f} s [{card}]")
    return out


DRYRUN_TOL, DRYRUN_SLACK = 0.10, 256 << 20  # the larger of 10 % and 256 MiB
# every dry-run subprocess prints one JSON line whose "wall_s" is its
# own seconds from its start
_DRYRUN_CODE = r"""
import time; t0 = time.perf_counter()
import dataclasses, json, numpy as np
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import LayoutMesh
cases = json.loads(%r)
lay = LayoutMesh(("data", "model"), np.arange(1).reshape(1, 1))
full = get_config("qwen1.5-32b", "full")
out = {}
for key, layers, shape, kw in cases:
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    out[key] = D.trace_case(cfg, shape, lay, device="cuda", **kw)
out["wall_s"] = time.perf_counter() - t0
print(json.dumps(out))
"""


# the head_dim route's and the MLA route's production-mesh traces (phase
# 16a2): unpadded on the 16 x 16 layout; train_4k at one microbatch (the
# CLI picks 16: the same ops 16 times over, minutes of tracing)
DRYRUN_MESH_CASES = (("qwen1.5-32b", "decode_32k", None),
                     ("command-r-35b", "decode_32k", None),
                     ("qwen1.5-32b", "train_4k", 1),
                     ("minicpm3-4b", "decode_32k", None),
                     ("deepseek-v3-671b", "decode_32k", None),
                     ("mamba2-130m", "decode_32k", None),
                     ("jamba-1.5-large-398b", "decode_32k", None),
                     ("whisper-large-v3", "decode_32k", None))
_DRYRUN_MESH_CODE = r"""
import time; t0 = time.perf_counter()
import json, sys
from repro_torch.launch import dryrun as D
out = {}
for arch, shape, mb in json.loads(sys.argv[2]):
    out[f"{arch} {shape}"] = D.run_one(arch, shape, "single",
                                       device=sys.argv[1], microbatches=mb)
out["wall_s"] = time.perf_counter() - t0
print(json.dumps(out))
"""
# phase 16c's tensor-parallel decode steps, traced as rank 0 of a
# one-rank fake world on fake CUDA tensors: the MLA models as phase 16c
# serves them (minicpm3-4b FULL, deepseek-v3-671b cut to 5 layers), one
# decode step of NUM_SLOTS slots over 392-row caches, naive and
# absorbed, the MoE layers through moe_apply_ragged as ShardedExecutor
# serves them (no EP)
_DRYRUN_MLA_CODE = r"""
import time; t0 = time.perf_counter()
import dataclasses, json, sys, numpy as np
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import LayoutMesh
lay = LayoutMesh(("data", "model"), np.arange(1).reshape(1, 1))
shape = json.loads(sys.argv[2])
out = {}
for arch, layers in json.loads(sys.argv[1]):
    cfg = get_config(arch, "full")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    for absorb in (False, True):
        rec = D.trace_case(cfg, shape, lay, device=sys.argv[3], ep=False,
                           mla_absorb=absorb)
        out[f"{arch} {absorb}"] = rec["collective_counts"]
out["wall_s"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def _subprocess(code: str, *args) -> subprocess.Popen:
    """``python -c code args`` from the repo root with ``src`` on the
    path, its output piped."""
    return subprocess.Popen(
        [sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(ROOT / "src")] + [p for p in [os.environ.get(
                "PYTHONPATH")] if p])})


def _finish(proc: subprocess.Popen, label: str, timeout: float) -> dict:
    """The JSON of the last line ``proc`` printed (killed past
    ``timeout``)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"[{label}] still running after {timeout} s")
    if proc.returncode != 0:
        raise AssertionError(f"[{label}] exit {proc.returncode}: "
                             f"{err[-3000:]}")
    return json.loads(out.splitlines()[-1])


def _dryrun_cases() -> list:
    """Phase 16a2's one-rank cases: (key, layers, shape, kw)."""
    shapes = {"train": dict(kind="train", global_batch=TRAIN_BATCH,
                            seq_len=TRAIN_SEQ),
              "decode": _decode_shape()}
    return [("train", TRAIN_LAYERS, shapes["train"], {"microbatches": 1}),
            ("decode", None, shapes["decode"], {})]


def _decode_shape() -> dict:
    """The main path's decode step as a dry-run shape: NUM_SLOTS slots
    over MAX_PROMPT_LEN + MAX_NEW_TOKENS-row caches."""
    return dict(kind="decode", global_batch=NUM_SLOTS,
                seq_len=MAX_PROMPT_LEN + MAX_NEW_TOKENS)


def start_dryrun() -> dict:
    """Start phase 16a2's traces and phase 16c's census, each in a
    subprocess on the host's cores (fake tensors: nothing is allocated
    on the card), so that they run beside the phases in between;
    :func:`dryrun_phase` collects them (:func:`stop_dryrun` kills any
    left).  Returns the processes by name and their start time."""
    census = [(arch, layers) for arch, layers, _ in MLA_MODELS]
    procs = {"one-rank": _subprocess(_DRYRUN_CODE
                                     % json.dumps(_dryrun_cases())),
             "mla census": _subprocess(_DRYRUN_MLA_CODE, json.dumps(census),
                                       json.dumps(_decode_shape()), "cuda")}
    for dev in ("cuda", "cpu"):
        procs[f"16 x 16 {dev}"] = _subprocess(
            _DRYRUN_MESH_CODE, dev, json.dumps(DRYRUN_MESH_CASES))
    return {"procs": procs, "t0": time.perf_counter()}


def stop_dryrun(started: dict) -> None:
    for proc in started["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# phase 16c's census of its tensor-parallel decode steps, from the
# one-rank dry run (``"<arch> <absorb>"`` -> collective counts by kind)
MLA_CENSUS: dict = {}
# seconds of work that ran beside other phases instead of after them,
# by what ran beside (printed before the total)
WON_BACK: dict = {}


def dryrun_phase(card: str, started: dict = None) -> dict:
    """The dry run (``repro_torch.launch.dryrun``) of two steps this
    script also runs for real, traced in a subprocess (a process makes
    one world) as rank 0 of a one-rank fake world on fake CUDA tensors:
    phase 16a1's qwen train step (4 layers, 4 x 1024, dp = 1, through
    ``make_sharded_train_step``) and phase 11a's decode step (qwen FULL,
    ``NUM_SLOTS`` slots over 392-row caches, through the tensor-parallel
    apply; ``REAL_STEPS``).  Each census equal to the real step's
    collectives, K1's would-be launches (the census's dispatches of its
    fake-rule op) equal to the real step's launches, the predicted peak and temp bytes
    within ``DRYRUN_TOL`` (or ``DRYRUN_SLACK``, the larger) of
    ``max_memory_allocated`` and of its rise above the resident bytes;
    the roofline's three terms and MODEL_FLOPS (its share of 989 TFLOP/s)
    printed beside each step's measured ms.  Beside that subprocess two
    more trace ``DRYRUN_MESH_CASES`` unpadded as rank 0 of the fake 16 x
    16 world, on fake CUDA and on fake CPU tensors: the census and
    collective bytes equal, K1 0 on both (the head_dim route's layers
    decode on the plain route, MLA takes no kernel), and a fourth the
    one-rank census of phase 16c's MLA decode steps (``MLA_CENSUS``);
    then :func:`split_score_check`.  ``started``: the subprocesses
    :func:`start_dryrun` started earlier (None: started here); the
    seconds this phase waited for them are printed beside their own."""
    from repro_torch.analysis import roofline as R
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    started = started or start_dryrun()
    t0 = time.perf_counter()
    try:
        runs = {name: _finish(proc, f"dry run {name}", 600)
                for name, proc in started["procs"].items()}
    finally:
        stop_dryrun(started)
    waited = time.perf_counter() - t0
    longest = max(r.pop("wall_s") for r in runs.values())
    traced = runs["one-rank"]
    mesh = {dev: runs[f"16 x 16 {dev}"] for dev in ("cuda", "cpu")}
    MLA_CENSUS.update(runs["mla census"])
    cases = _dryrun_cases()
    WON_BACK["the dry run's traces"] = longest - waited
    say(f"== dry run: {len(runs)} subprocesses of traces on fake tensors, "
        f"the longest {longest:.1f} s, started "
        f"{t0 - started['t0']:.1f} s before this phase; it waited "
        f"{waited:.1f} s for them: {longest - waited:.1f} s won back by "
        f"tracing beside the phases before [{card}]")
    say(f"== dry run: qwen1.5-32b train (4 layers, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}) and FULL decode ({NUM_SLOTS} slots x "
        f"{MAX_PROMPT_LEN + MAX_NEW_TOKENS} rows) traced on a one-rank "
        f"fake world (trace "
        f"{traced['train']['trace_s']} / {traced['decode']['trace_s']} s) "
        f"[{card}]")
    full = get_config(QWEN, "full")
    out = {}
    for key, layers, shape, _ in cases:
        dry, real = traced[key], REAL_STEPS[key]
        kinds = {k.replace("-", "_"): n
                 for k, n in dry["collective_counts"].items()}
        want = {k: real["collectives"].get(k, 0) for k in kinds}
        k1 = dry["launches"]["flash_decode"]
        others = {n: c for n, c in dry["launches"].items()
                  if n != "flash_decode" and c}
        rise = real["peak"] - real["resident"]
        gaps = {}
        for name, pred, meas in (("peak", dry["peak_bytes"], real["peak"]),
                                 ("temp", dry["temp_size_in_bytes"], rise)):
            gaps[name] = (pred - meas, max(DRYRUN_TOL * meas, DRYRUN_SLACK))
        cfg = full if layers is None else dataclasses.replace(
            full, n_layers=layers)
        row = R.analyse(QWEN, shape, record={**dry, "n_devices": 1},
                        cfg=cfg, mesh={"data": 1, "model": 1})
        share = row.model_flops / (real["ms"] / 1e3 * PEAK_FLOPS_BF16)
        say(f"   {key}: census {kinds} (the real step: "
            f"{real['collectives']}); K1 {k1} would-be launches (real "
            f"step launched {real['launches'] if key == 'decode' else 0}); "
            f"predicted "
            f"peak {dry['peak_bytes']} B = arguments "
            f"{dry['argument_size_in_bytes']} + temp "
            f"{dry['temp_size_in_bytes']}, measured peak {real['peak']} B "
            f"(resident {real['resident']}, rise {rise}): gaps "
            f"{gaps['peak'][0]} / {gaps['temp'][0]} B (bars "
            f"{gaps['peak'][1]:.0f} / {gaps['temp'][1]:.0f}) [{card}]")
        say(f"   {key}: roofline compute {row.compute_s * 1e3:.4f} ms, "
            f"memory {row.memory_s * 1e3:.4f} ms, collective "
            f"{row.collective_s * 1e3:.4f} ms ({row.dominant}); counted "
            f"{dry['flops']:.4g} FLOP, MODEL_FLOPS {row.model_flops:.4g} "
            f"= {share:.4f} of 989 TFLOP/s at the measured "
            f"{real['ms']:.3f} ms a step [{card}]")
        real_k1 = real["launches"] if key == "decode" else 0
        if kinds != want or k1 != real_k1 or others:
            raise AssertionError(f"[dry run {key}] census {kinds} vs "
                                 f"{want}, K1 {k1} vs {real_k1}, {others}")
        for name, (gap, bar) in gaps.items():
            if abs(gap) > bar:
                raise AssertionError(f"[dry run {key}] {name} off by {gap} "
                                     f"B (bar {bar:.0f})")
        out[key] = {"census": kinds, "k1": k1, "gaps": gaps,
                    "share": share, "dominant": row.dominant}
    for arch, shape, mb in DRYRUN_MESH_CASES:
        key = f"{arch} {shape}"
        card_rec, cpu_rec = mesh["cuda"][key], mesh["cpu"][key]
        k1 = {d: r["launches"]["flash_decode"] for d, r in mesh.items()
              for r in [r[key]]}
        say(f"   16 x 16, {key} unpadded (rank 0 of 256, fake tensors; "
            f"{'microbatches ' + str(mb) if mb else 'one step'}): census "
            f"{card_rec['collective_counts']}, collective bytes "
            f"{card_rec['collective_bytes']}; peak "
            f"{card_rec['peak_bytes']} B, temp "
            f"{card_rec['temp_size_in_bytes']} B (on cpu tensors "
            f"{cpu_rec['peak_bytes']} / {cpu_rec['temp_size_in_bytes']}); "
            f"{card_rec['flops']:.4g} FLOP; K1 would-be launches {k1}; "
            f"traced in {card_rec['trace_s']} / {cpu_rec['trace_s']} s "
            f"[{card}]")
        if (card_rec["collective_counts"] != cpu_rec["collective_counts"]
                or card_rec["collective_bytes"]
                != cpu_rec["collective_bytes"] or any(k1.values())):
            raise AssertionError(f"[dry run 16 x 16 {key}] card "
                                 f"{card_rec['collective_counts']} vs cpu "
                                 f"{cpu_rec['collective_counts']}, K1 {k1}")
        out[key] = {"census": card_rec["collective_counts"],
                    "peak": card_rec["peak_bytes"]}
    out["split_scores"] = split_score_check(card)
    say(f"== dry run: {time.perf_counter() - t0:.1f} s [{card}]")
    return out


def split_score_check(card: str) -> dict:
    """The head_dim route's decode attention (``models/layers.py::
    attention`` with ``reduce``: float32 partial scores summed over the
    model group before the scale, the masks and the softmax) at qwen
    FULL's decode shape, through a one-rank NCCL group: equal to the
    plain attention (a one-rank all-reduce leaves the scores as they
    are) and within ``KERNEL_TOL`` of K1 on the same rows; each timed
    warm by CUDA events."""
    import torch
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import layers as L
    B, Lk, H, D = NUM_SLOTS, MAX_PROMPT_LEN + MAX_NEW_TOKENS, 40, 128
    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)
    q, k, v = rnd(B, 1, H, D), rnd(B, Lk, H, D), rnd(B, Lk, H, D)
    lens = torch.randint(1, Lk + 1, (B,), generator=g, device="cuda",
                         dtype=torch.int32)
    lens[0], lens[1] = 1, Lk
    pos = (lens - 1)[:, None]
    with _serving_mesh() as mesh:
        group = mesh.group("model")

        def split():
            return L.attention(q, k, v, q_pos=pos, kv_len=lens,
                               head_dim=D,
                               reduce=lambda s: L.all_reduce(s, group))

        def plain():
            return L.attention(q, k, v, q_pos=pos, kv_len=lens)

        def k1():
            return flash_decode(q[:, 0], k, v, lens)
        got, want, kern = split(), plain(), k1()
        torch.cuda.synchronize()
        err_plain = (got.float() - want.float()).abs().max().item()
        err_k1 = (got[:, 0].float() - kern.float()).abs().max().item()
        ms = {name: cuda_ms(fn, 50) for name, fn in
              (("split", split), ("plain", plain), ("k1", k1))}
    say(f"   head_dim route's split-score decode attention (B={B}, L={Lk} "
        f"ragged, H={H}, D={D}, bf16; scores all-reduced over a one-rank "
        f"NCCL group): max_abs_err {err_plain:.3e} vs the plain attention, "
        f"{err_k1:.3e} vs K1 (tol {KERNEL_TOL:.0e}); "
        f"{ms['split'] * 1e3:.2f} us, plain {ms['plain'] * 1e3:.2f} us, "
        f"K1 {ms['k1'] * 1e3:.2f} us [{card}]")
    if err_plain != 0.0 or not err_k1 <= KERNEL_TOL:
        raise AssertionError(f"[split scores] {err_plain} vs plain, "
                             f"{err_k1} vs K1")
    return {"err_k1": err_k1, **ms}


def _greedy_gaps(model, params, rec) -> tuple:
    """Each served prompt again, alone, through ``prefill`` and
    ``decode`` on a batch-1 cache, fed the engine's tokens: how many of
    the engine's greedy tokens are the loop's argmax too, and the largest
    gap (max logit - the engine token's logit) over max |logit|."""
    import torch
    agree = total = 0
    worst = 0.0
    with torch.no_grad():
        for prompt, toks in rec["tokens"].items():
            cache = model.init_cache(1, len(prompt) + len(toks), device="cuda")
            lg, _ = model.prefill(params, {"tokens": torch.tensor(
                [prompt], dtype=torch.int64, device="cuda")}, cache)
            for i, t in enumerate(toks):
                row = lg[0, -1]
                gap = (row.max() - row[t]) / row.abs().max()
                agree += int(row.argmax()) == t
                worst = max(worst, float(gap))
                total += 1
                if i + 1 < len(toks):
                    lg, _ = model.decode(params, {"tokens": torch.tensor(
                        [[t]], dtype=torch.int32, device="cuda")}, cache)
    return agree, total, worst


def mamba_serve_phase(card: str, policy) -> dict:
    """``mamba2-130m`` FULL (24 layers, d_model 768, seeded bf16 weights,
    not cut) through ``Gateway.serve`` on the dense slot engine: 8 slots,
    prefill batch 4, prompts of 384 tokens, 8 new tokens; 8 requests
    under ``FixedPolicy(0)``, 8 routed by ``policy`` (the trained
    router), every
    launch count 0 just before and read just after.  Checks every request
    served with its tokens, no quarantine, no kernel launched (the cached
    prefill and the O(1) decode step never take K6, as in the
    reference), and each engine token is the greedy choice of the same
    model run per request within TOKEN_GAP_RTOL."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import HashTokenizer, SyntheticSquad
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan
    from repro_torch.models import build_model
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.retrieval import BM25Index
    from repro_torch.routing import ContinuousEngineBackend
    cfg = get_config(MAMBA, "full")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    say(f"== mamba serve: {cfg.name} FULL, {cfg.n_layers} layers x d_model "
        f"{cfg.d_model} (d_state {cfg.ssm.d_state}, head_dim "
        f"{cfg.ssm.head_dim}, {ssm_dims(cfg)[1]} heads, chunk "
        f"{cfg.ssm.chunk_size}), {model.n_params() / 1e6:.1f} M params "
        f"{cfg.dtype}, seeded")
    data = SyntheticSquad(n_paragraphs=600, n_questions=1000, seed=0)
    index = BM25Index.build([p.text for p in data.paragraphs])
    backend = ContinuousEngineBackend.create(
        model, params, HashTokenizer(cfg.vocab_size), index,
        num_slots=NUM_SLOTS, prefill_batch=PREFILL_BATCH,
        max_prompt_len=MAX_PROMPT_LEN, max_new_tokens=MAX_NEW_TOKENS)
    counters = {"flash_decode": flash_decode,
                "paged_flash_decode": paged_flash_decode,
                "flash_attention": flash_attention,
                "ssd_chunk_scan": ssd_chunk_scan}
    run = _drive("mamba dense", backend, index, data.questions[-16:], 2,
                 card, cfg.n_layers, counters, policy)
    rec = run["rec"]
    admits = [s_.elapsed_time(e) for s_, e in rec["admits"]]
    say(f"   prefill: {len(admits)} admission groups (prefill batch "
        f"{PREFILL_BATCH}, {sum(map(len, rec['tokens']))} prompt tokens), "
        f"{sum(admits) / max(len(admits), 1):.2f} ms each (device time of "
        f"prefill + commit), {[round(a, 2) for a in admits]}")
    if any(run["launches"].values()):
        raise AssertionError(f"[mamba serve] kernels launched on the "
                             f"serving path: {run['launches']}")
    agree, total, worst = _greedy_gaps(model, params, rec)
    say(f"   {agree} of {total} greedy tokens of {len(rec['tokens'])} "
        f"requests agree with a per-request prefill/decode loop on the "
        f"card; largest gap to that loop's top logit {worst:.2e} of max "
        f"|logit| (tol {TOKEN_GAP_RTOL:.0e}) [{card}]")
    if not total or worst > TOKEN_GAP_RTOL:
        raise AssertionError(f"[mamba serve] engine tokens are not the "
                             f"per-request greedy choice: {worst}")
    return {"tokens": rec["tokens"], "index": index,
            "questions": data.questions[-16:]}


def mamba_eval_phase(card: str) -> tuple:
    """``mamba2-130m`` FULL (seeded bf16 weights) on a held batch of 4 x
    2048 tokens through ``make_eval_step`` with K6 (``use_pallas_ssd``:
    every layer's scan, 24 launches a call) and with the plain chunked
    scan; the losses within MAMBA_EVAL_RTOL.  Returns K6's launches on
    this path and the loss with K6."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.lm_dataset import LMDataset
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan
    from repro_torch.models import build_model
    from repro_torch.training import make_eval_step
    cfg = get_config(MAMBA, "full")
    model = build_model(cfg)
    k6_model = build_model(dataclasses.replace(cfg, use_pallas_ssd=True))
    params = model.init(seed=0, device="cuda")
    held = {k: torch.from_numpy(v).cuda() for k, v in next(
        LMDataset(cfg, MAMBA_EVAL_SEQ, seed=1).batches(MAMBA_BATCH)).items()}
    plain_eval, k6_eval = make_eval_step(model), make_eval_step(k6_model)
    say(f"== mamba eval: {cfg.name} FULL, held batch {MAMBA_BATCH} x "
        f"{MAMBA_EVAL_SEQ} (LMDataset seed 1), chunk {cfg.ssm.chunk_size}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd_chunk_scan.launches = 0
    k6_loss = k6_eval(params, held)
    torch.cuda.synchronize()
    launches = ssd_chunk_scan.launches
    plain_loss = plain_eval(params, held)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    k6_ms = cuda_ms(lambda: k6_eval(params, held), 3)
    plain_ms = cuda_ms(lambda: plain_eval(params, held), 3)
    a, b = float(k6_loss), float(plain_loss)
    rel = abs(a - b) / abs(b)
    say(f"   eval loss with K6 {a:.6f}, plain scan {b:.6f}: relative "
        f"difference {rel:.2e} (tol {MAMBA_EVAL_RTOL:.0e}); K6 launches "
        f"{launches} per eval call for {cfg.n_layers} layers")
    say(f"   eval step {k6_ms:.2f} ms with K6, {plain_ms:.2f} ms plain; "
        f"peak memory {peak:.2f} GiB [{card}]")
    say(f"   device time by kernel, one eval call with K6 (top 8): "
        f"{device_split(lambda: k6_eval(params, held), 8)}")
    if launches != cfg.n_layers:
        raise AssertionError(f"[mamba eval] K6 launched {launches} times for "
                             f"{cfg.n_layers} layers")
    if not (math.isfinite(a) and rel <= MAMBA_EVAL_RTOL):
        raise AssertionError(f"[mamba eval] losses disagree: K6 {a}, plain "
                             f"{b}")
    return {"ssd_chunk_scan": launches}, a


def mamba_train_phase(card: str) -> None:
    """``make_train_step`` (fused loss, the plain chunked scan, AdamW) for
    8 steps on ``mamba2-130m`` FULL with ``ssm.chunk_size = 64`` (the
    chunk at which the reference's FULL gradient is finite), seeded bf16
    weights, ``remat="full"``, over ``LMDataset`` at batch 4 x seq 2048.
    Checks finite losses and gradient norms, the last loss below the
    first, no K6 launch, and a train step with ``use_pallas_ssd`` raising
    the gradient guard; prints ms per step, tokens/s, peak memory, and
    the gradient norm at FULL's chunk of 256 (NaN in the reference)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.lm_dataset import LMDataset
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan
    from repro_torch.models import build_model
    from repro_torch.models.schema import tree_leaves, zeros_from_schema
    from repro_torch.models.transformer import forward_train_loss
    from repro_torch.training import (OptConfig, adamw_init_schema,
                                      make_train_step)
    from repro_torch.training.optimizer import global_norm
    full = get_config(MAMBA, "full")
    cfg = dataclasses.replace(full, ssm=dataclasses.replace(
        full.ssm, chunk_size=MAMBA_TRAIN_CHUNK))
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    opt_state = zeros_from_schema(adamw_init_schema(model.schema),
                                  device="cuda")
    batches = LMDataset(cfg, MAMBA_EVAL_SEQ).batches(MAMBA_BATCH)
    tokens = MAMBA_BATCH * MAMBA_EVAL_SEQ
    # the qwen train phase's schedule; at lr 1e-3 dt grows until cum
    # falls by more than 88 within 64 rows, and the gradient turns NaN
    # as at chunk 256 (PERF.md, the Mamba2 findings)
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=2,
                        total_steps=MAMBA_TRAIN_STEPS)
    step_fn = make_train_step(model, opt_cfg)
    say(f"== mamba train: {cfg.name} FULL with chunk_size "
        f"{full.ssm.chunk_size} -> {MAMBA_TRAIN_CHUNK}, remat "
        f"{cfg.remat!r}, batch {MAMBA_BATCH} x seq {MAMBA_EVAL_SEQ} = "
        f"{tokens} tokens a step, {MAMBA_TRAIN_STEPS} steps, lr "
        f"{opt_cfg.lr}, warmup {opt_cfg.warmup_steps}")
    events, metrics = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd_chunk_scan.launches = 0
    for _ in range(MAMBA_TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).cuda() for k, v in
                 next(batches).items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, m = step_fn(params, opt_state, batch)
        end.record()
        events.append((start, end))
        metrics.append(m)
    torch.cuda.synchronize()
    launches = ssd_chunk_scan.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = [s_.elapsed_time(e) for s_, e in events]
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    step_ms = sum(ms[1:]) / len(ms[1:])
    say(f"   losses {[round(x, 4) for x in losses]}")
    say(f"   grad_norm {[round(x, 4) for x in gnorms]}")
    say(f"   ms per step {[round(x, 2) for x in ms]} (CUDA events); steady "
        f"{step_ms:.2f} ms = {tokens / step_ms * 1e3:.0f} tokens/s; peak "
        f"memory {peak:.2f} GiB; K6 launches in the train steps {launches} "
        f"[{card}]")
    say(f"   device time by kernel, one more step (top 8): "
        f"{device_split(lambda: step_fn(params, opt_state, batch), 8)}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"[mamba train] non-finite loss or grad_norm: "
                             f"{losses}, {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[mamba train] the loss did not fall: {losses}")
    if launches:
        raise AssertionError(f"[mamba train] K6 launched {launches} times in "
                             f"train steps")
    # FULL's own chunk of 256: exp(cum_t - cum_s) is inf above the
    # diagonal, and its gradient through the mask is NaN (the reference's
    # too); shown, not trained
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = forward_train_loss(params, full, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        gn = float(global_norm([g for g in grads if g is not None]))
    finally:
        for p in leaves:
            p.requires_grad_(False)
    say(f"   at chunk {full.ssm.chunk_size}: loss {float(loss.detach()):.6f}, "
        f"gradient norm {gn} (NaN in the reference as well)")
    del loss, grads
    k6_step = make_train_step(build_model(dataclasses.replace(
        cfg, use_pallas_ssd=True)), opt_cfg)
    step0 = int(opt_state["step"])
    try:
        k6_step(params, opt_state, batch)
    except RuntimeError as e:
        if "no gradient" not in str(e):
            raise
        say(f"   train step with K6 raises: {e}")
    else:
        raise AssertionError("[mamba train] a train step through K6 did not "
                             "raise")
    if int(opt_state["step"]) != step0 or ssd_chunk_scan.launches != launches:
        raise AssertionError("[mamba train] the refused step changed state")


def _k6_shard_row(label, args, chunk: int, y) -> dict:
    """K6 at one rank's sub-heads: warm and flushed ms, the plain
    version's, the bound over the call's bytes and operations; the
    ``ssd_chunk_scan`` row."""
    import torch
    from repro_torch.kernels.ssd_scan import (ssd_chunk_scan,
                                              ssd_chunk_scan_torch)
    B, S, H, hd = args[0].shape
    N = args[1].shape[-1]
    with torch.no_grad():
        ms = cuda_ms(lambda: ssd_chunk_scan(*args, chunk=chunk), 20)
        cold = cuda_ms_cold(lambda: ssd_chunk_scan(*args, chunk=chunk))
        plain_ms = cuda_ms(lambda: ssd_chunk_scan_torch(*args, chunk=chunk),
                           5)
    nbytes = sum(t.numel() * t.element_size() for t in (*args, y))
    nops = ssd_ops(B, S, H, hd, N, min(chunk, S))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    say(f"   K6 [{label}]: {ms * 1e3:.2f} us warm, {cold * 1e3:.2f} us "
        f"flushed | plain {plain_ms * 1e3:.2f} us | library: none | bound "
        f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB: "
        f"{t_bytes * 1e6:.2f} us; {nops / 1e9:.3f} GFLOP on the bf16 tensor "
        f"cores: {t_ops * 1e6:.2f} us; {bound_by})")
    return dict(name="ssd_chunk_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:60", ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, shape=label, ms_cold=cold)


def _in_turns(fns: dict, iters: int) -> dict:
    """``cuda_ms`` of ``fns["single"]`` and ``fns["tp"]`` in turns
    (single, tp, tp, single): each one's two readings, rounded to µs."""
    out = {"single": [], "tp": []}
    for name in ("single", "tp", "tp", "single"):
        out[name].append(round(cuda_ms(fns[name], iters), 3))
    return out


def mamba_tp_phase(card: str, single: dict, policy) -> tuple:
    """Mamba2 under tensor parallelism (``models/ssm.py::ssm_apply`` with
    ``tp``), on phases 14-15's ``mamba2-130m`` FULL weights (seed 0):

    * K6 on the rank shards: layer 0's scan inputs on phase 15's held
      batch (4 x 2048, N 128, chunk 256, captured from an eval forward
      with K6), cut for each of the 16 ranks at mp = 16 into its three
      sub-heads of 32 (``sub_heads``): K6 on each rank's (4, 2048, 3, 32)
      against ``ssd_chunk_scan_torch`` on the same inputs, and the 16
      outputs reassembled against K6's whole (4, 2048, 24, 64) call, each
      within SSD_RTOL of max |y| in float32; then one jamba rank (16
      heads of 64, N 16, G 1, seeded inputs) against its plain version.
      Rank 0's mamba2 launch timed warm and flushed beside its bound:
      the ``ssd_chunk_scan`` row at the rank shard.
    * The one-rank tensor-parallel path, on an NCCL serving mesh of one
      rank: ``ShardedExecutor`` serves phase 14's first 8 requests
      through ``Gateway.serve`` (FixedPolicy(0)), every launch count 0
      just before and read just after, its tokens equal to phase 14's;
      ``make_sharded_eval_step`` with K6 on phase 15's held batch, K6's
      count 0 just before and 24 just after, the loss within
      MAMBA_TP_LOSS_RTOL of phase 15's.  The collectives of a decode step
      and of an eval call by kind (the dry run's ``Census``), and their
      ms beside the single-device ones.
    Returns the row and K6's launches on this phase's eval."""
    import torch
    import repro_torch.models.ssm as ssm_mod
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data import HashTokenizer
    from repro_torch.data.lm_dataset import LMDataset
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.kernels.ssd_scan import (ssd_chunk_scan,
                                              ssd_chunk_scan_torch)
    from repro_torch.launch.dryrun import Census
    from repro_torch.models import build_model
    from repro_torch.routing import ContinuousEngineBackend
    from repro_torch.training import make_eval_step
    from repro_torch.training.sharded import (make_sharded_eval_step,
                                              shard_params)
    t0 = time.perf_counter()
    cfg = get_config(MAMBA, "full")
    model = build_model(cfg)
    k6_model = build_model(dataclasses.replace(cfg, use_pallas_ssd=True))
    params = model.init(seed=0, device="cuda")
    dev = params["embed"].device
    held = {k: torch.from_numpy(v).to(dev) for k, v in next(
        LMDataset(cfg, MAMBA_EVAL_SEQ, seed=1).batches(MAMBA_BATCH)).items()}
    d_inner, H = ssm_mod.ssm_dims(cfg)
    say(f"== mamba tp: {cfg.name} FULL (seed 0) at mp = {MAMBA_TP_MP}: "
        f"d_inner {d_inner} = {H} heads of {cfg.ssm.head_dim}, "
        f"{d_inner // MAMBA_TP_MP} columns a rank")

    # layer 0's scan inputs on the eval path
    seen, scan = [], ssm_mod.ssd_chunk_scan

    def capture(*a, **kw):
        if not seen:
            seen.append((a, kw["chunk"]))
        return scan(*a, **kw)
    ssm_mod.ssd_chunk_scan = capture
    try:
        with torch.no_grad():
            k6_model.train_logits(params, {"tokens": held["tokens"]})
    finally:
        ssm_mod.ssd_chunk_scan = scan
    (x, Bm, Cm, dt, A_log), chunk = seen[0]
    B, S = x.shape[:2]
    f32 = torch.float32
    with torch.no_grad():
        whole = ssd_chunk_scan(x, Bm, Cm, dt, A_log, chunk=chunk,
                               out_dtype=f32)
        parts, worst, row = [], 0.0, None
        for r in range(MAMBA_TP_MP):
            lo, c, g, heads = ssm_mod.sub_heads(cfg, MAMBA_TP_MP, r)
            idx = torch.tensor(heads, device=dev)
            args = (x.reshape(B, S, d_inner)[..., lo:lo + c].reshape(
                        B, S, c // g, g).contiguous(), Bm, Cm,
                    dt[..., idx].contiguous(), A_log[idx])
            y = ssd_chunk_scan(*args, chunk=chunk, out_dtype=f32)
            want = ssd_chunk_scan_torch(*args, chunk=chunk, out_dtype=f32)
            torch.cuda.synchronize()
            rel = ((y - want).abs().max() / want.abs().max()).item()
            worst = max(worst, rel)
            if not (torch.isfinite(y).all() and rel <= SSD_RTOL):
                raise AssertionError(f"[mamba tp] K6 on rank {r}'s sub-heads "
                                     f"{tuple(args[0].shape)} disagrees "
                                     f"with its plain version: {rel}")
            parts.append(y.reshape(B, S, c))
            shard = tuple(args[0].shape)
            if r == 0:
                label = (f"{MAMBA} tp rank shard: mp = {MAMBA_TP_MP}, rank "
                         f"0's sub-heads B={B} S={S} H={c // g} hd={g} G=1 "
                         f"N={Bm.shape[-1]} chunk {chunk}, bf16")
                y16 = ssd_chunk_scan(*args, chunk=chunk)
                row = _k6_shard_row(label, args, chunk, y16)
                row["max_abs_err"] = (y - want).abs().max().item()
                say(f"   K6 rank 0 heads {heads}, float32 out against the "
                    f"plain version: max_abs_err {row['max_abs_err']:.3e} "
                    f"[{card}]")
        got = torch.cat(parts, -1)
        ref = whole.reshape(B, S, d_inner)
        join = ((got - ref).abs().max() / ref.abs().max()).item()
        same = torch.equal(got, ref)
    say(f"   K6 on all {MAMBA_TP_MP} ranks' {shard} sub-heads: worst "
        f"relative error to the plain version {worst:.3e}; reassembled "
        f"against K6's whole {tuple(x.shape)} call {join:.3e} (bit for bit: "
        f"{same}; tol {SSD_RTOL:.0e}) [{card}]")
    if join > SSD_RTOL:
        raise AssertionError(f"[mamba tp] the ranks' K6 outputs do not "
                             f"reassemble the whole call: {join}")
    del x, Bm, Cm, dt, whole, parts, got, ref, seen

    # one jamba rank: 16 whole heads of 64, N 16, G 1 (seeded inputs)
    jcfg = get_config("jamba-1.5-large-398b", "full")
    jd, jH = ssm_mod.ssm_dims(jcfg)
    _, jc, jg, jheads = ssm_mod.sub_heads(jcfg, MAMBA_TP_MP, 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(bf)
    jN, jchunk = jcfg.ssm.d_state, jcfg.ssm.chunk_size
    jargs = (rnd(B, S, jc // jg, jg), rnd(B, S, 1, jN, scale=0.5),
             rnd(B, S, 1, jN, scale=0.5),
             F.softplus(torch.randn((B, S, jc // jg), generator=gen,
                                    device=dev)).to(bf),
             (torch.randn(jc // jg, generator=gen, device=dev)
              * 0.3).to(bf))
    with torch.no_grad():
        y = ssd_chunk_scan(*jargs, chunk=jchunk, out_dtype=f32)
        want = ssd_chunk_scan_torch(*jargs, chunk=jchunk, out_dtype=f32)
        jrel = ((y - want).abs().max() / want.abs().max()).item()
        jms = cuda_ms(lambda: ssd_chunk_scan(*jargs, chunk=jchunk), 20)
    say(f"   K6 on a jamba rank's sub-heads {tuple(jargs[0].shape)} (heads "
        f"{jheads[0]}..{jheads[-1]} of {jH}, N {jN}, chunk {jchunk}): "
        f"relative error to the plain version {jrel:.3e} (tol "
        f"{SSD_RTOL:.0e}); {jms * 1e3:.2f} us warm [{card}]")
    if not (torch.isfinite(y).all() and jrel <= SSD_RTOL):
        raise AssertionError(f"[mamba tp] K6 on a jamba rank disagrees with "
                             f"its plain version: {jrel}")
    del jargs, y, want

    counters = {"flash_decode": flash_decode,
                "paged_flash_decode": paged_flash_decode,
                "flash_attention": flash_attention,
                "ssd_chunk_scan": ssd_chunk_scan}
    with _serving_mesh(cfg) as mesh:
        tp = mesh.group("model")
        backend = ContinuousEngineBackend.create(
            model, params, HashTokenizer(cfg.vocab_size), single["index"],
            num_slots=NUM_SLOTS, prefill_batch=PREFILL_BATCH,
            max_prompt_len=MAX_PROMPT_LEN, max_new_tokens=MAX_NEW_TOKENS,
            mesh=mesh)
        ex = backend.engine.executor
        if type(ex).__name__ != "ShardedExecutor":
            raise AssertionError(f"[mamba tp] executor {type(ex).__name__}")
        run = _drive("mamba tp dense", backend, single["index"],
                     single["questions"], 1, card, cfg.n_layers, counters,
                     policy)
        toks = run["rec"]["tokens"]
        equal = sum(single["tokens"].get(p) == t for p, t in toks.items())
        say(f"   ShardedExecutor (dp = 1 over NCCL): {equal} of {len(toks)} "
            f"requests' tokens equal to phase 14's; launches "
            f"{run['launches']} [{card}]")
        if len(toks) != 8 or equal != len(toks) or any(
                run["launches"].values()):
            raise AssertionError(f"[mamba tp] {equal} of {len(toks)} token "
                                 f"lists equal phase 14's; launches "
                                 f"{run['launches']}")
        del backend, run

        cache = model.init_cache(NUM_SLOTS, MAX_PROMPT_LEN + MAX_NEW_TOKENS,
                                 device=dev)
        step_tokens = torch.zeros(NUM_SLOTS, 1, dtype=torch.int32,
                                  device=dev)
        steps, colls = {}, {}
        for name, group in (("single", None), ("tp", tp)):
            @torch.no_grad()
            def step(group=group):
                lg, _ = model.decode(params, {"tokens": step_tokens}, cache,
                                     tp=group)
                return lg[:, -1].argmax(-1)
            counted = Census()
            with counted:
                step()
            torch.cuda.synchronize()
            steps[name] = step
            colls[name] = {k: n for k, n in counted.coll_counts.items() if n}
        ms = _in_turns(steps, 10)
        del cache
        say(f"   decode step ({NUM_SLOTS} slots), in turns single, tp, tp, "
            f"single: tensor-parallel {ms['tp']} ms, collectives "
            f"{colls['tp']}; single-device {ms['single']} ms, collectives "
            f"{colls['single']} [{card}]")

        sparams = shard_params(k6_model, mesh, params)
        sh_eval, k6_eval = (make_sharded_eval_step(k6_model, mesh),
                            make_eval_step(k6_model))
        torch.cuda.synchronize()
        ssd_chunk_scan.launches = 0
        counted = Census()
        with counted:
            loss = float(sh_eval(sparams, held))
        torch.cuda.synchronize()
        k6 = ssd_chunk_scan.launches
        coll = {k: n for k, n in counted.coll_counts.items() if n}
        ms = _in_turns({"single": lambda: k6_eval(params, held),
                        "tp": lambda: sh_eval(sparams, held)}, 3)
        rel = abs(loss - single["eval_loss"]) / abs(single["eval_loss"])
        say(f"   make_sharded_eval_step with K6: loss {loss:.6f} (phase 15: "
            f"{single['eval_loss']:.6f}, relative {rel:.2e}, tol "
            f"{MAMBA_TP_LOSS_RTOL:.0e}); K6 launches {k6}; collectives "
            f"{coll}; in turns {ms['tp']} ms beside make_eval_step's "
            f"{ms['single']} ms [{card}]")
        if k6 != cfg.n_layers or not rel <= MAMBA_TP_LOSS_RTOL:
            raise AssertionError(f"[mamba tp] sharded eval: K6 {k6} for "
                                 f"{cfg.n_layers} layers, loss {loss} vs "
                                 f"{single['eval_loss']}")
        del sparams
    del params
    _free_gpu_memory("mamba tp")
    say(f"== mamba tp: {time.perf_counter() - t0:.1f} s [{card}]")
    return row, {"ssd_chunk_scan": k6}


def _k4_block_row(label, q, k, v, out, err) -> dict:
    """K4 at one rank's block of heads (views): warm and flushed ms, the
    plain version's, SDPA's on the same views, the bound over the
    block's bytes (q, k, v read, out written) and its causal operations;
    the ``flash_attention`` row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    B, S, H, D = q.shape
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with torch.no_grad():
        ms = cuda_ms(lambda: flash_attention(q, k, v), 50)
        cold = cuda_ms_cold(lambda: flash_attention(q, k, v))
        plain_ms = cuda_ms(lambda: flash_attention_torch(q, k, v), 10)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 50)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    nops = 4 * B * H * D * (S * (S + 1) // 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    say(f"   K4 [{label}]: {ms * 1e3:.2f} us warm, {cold * 1e3:.2f} us "
        f"flushed | plain {plain_ms * 1e3:.2f} us | library (SDPA, "
        f"is_causal, the same views) {library_ms * 1e3:.2f} us | bound "
        f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB: "
        f"{t_bytes * 1e6:.2f} us; {nops / 1e9:.3f} GFLOP: "
        f"{t_ops * 1e6:.2f} us; {bound_by})")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:63",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, shape=label,
                ms_cold=cold)


class _HandGroup:
    """Rank ``r`` of ``n`` ranks run as threads of this process: a
    tensor handed in by every rank, every rank's back in rank order."""

    def __init__(self, hub: dict, r: int):
        self.hub, self.r, self.n = hub, r, len(hub["parts"])

    def exchange(self, x):
        hub = self.hub
        hub["parts"][self.r] = x
        hub["barrier"].wait()
        got = list(hub["parts"])
        hub["barrier"].wait()
        return got


def _rank_threads(n: int, cfg, q, k, v, pos):
    """``models/layers.py::_gqa_head_dim`` on each of ``n`` ranks' head_dim
    columns of the whole (B, S, H, D) ``q``, ``k``, ``v`` (no cache,
    causal), the ranks in threads and the route's two collectives at
    S > 1 done by hand over a :class:`_HandGroup` (the gather
    concatenated and the all-to-all's blocks handed on in rank order;
    any other collective on the group raises; a failed rank breaks
    the barrier, so no rank waits for ever).  K4's count is 0 just
    before the threads start and is read just after they end, into
    ``WHISPER_TP["block_launches"]``; each launch is made under a lock,
    so the count is exact.  Returns every rank's output columns and
    its K4 launch: (q, k, v, out) as the route handed them to K4."""
    import threading
    import torch.distributed as dist
    import repro_torch.models.layers as layers_mod
    from repro_torch.kernels.flash_attention import flash_attention
    hub = {"parts": [None] * n, "barrier": threading.Barrier(n, timeout=120)}
    mine = threading.local()
    lock = threading.Lock()
    blocks = [None] * n
    real = {name: getattr(layers_mod, name) for name in
            ("gather_split", "all_to_all", "flash_attention")}
    real_size, real_rank = dist.get_world_size, dist.get_rank

    def gather_split(x, g, dim):
        if not isinstance(g, _HandGroup):
            return real["gather_split"](x, g, dim)
        return torch.cat(g.exchange(x), dim)

    def all_to_all(x, g, sizes=None, out_sizes=None):
        if not isinstance(g, _HandGroup):
            return real["all_to_all"](x, g, sizes, out_sizes)
        return torch.cat([p.split(ps)[g.r] for p, ps in g.exchange((x,
                                                                     sizes))])

    def k4(qb, kb, vb, **kw):
        with lock:
            out = real["flash_attention"](qb, kb, vb, **kw)
        blocks[mine.r] = (qb, kb, vb, out)
        return out

    def body(r):
        mine.r = r
        g = _HandGroup(hub, r)
        dims = slice(r * (q.shape[-1] // n), (r + 1) * (q.shape[-1] // n))
        try:
            return layers_mod._gqa_head_dim(
                q[..., dims], k[..., dims], v[..., dims], cfg, positions=pos,
                cache=None, window=0, causal=True, ring=False,
                page_table=None, tp=g)
        except BaseException:
            hub["barrier"].abort()
            raise

    import torch
    from concurrent.futures import ThreadPoolExecutor
    patched = dict(gather_split=gather_split, all_to_all=all_to_all,
                   flash_attention=k4)
    for name, fn in patched.items():
        setattr(layers_mod, name, fn)
    dist.get_world_size = lambda g=None: (g.n if isinstance(g, _HandGroup)
                                          else real_size(g))
    dist.get_rank = lambda g=None: (g.r if isinstance(g, _HandGroup)
                                    else real_rank(g))
    try:
        flash_attention.launches = 0
        with ThreadPoolExecutor(n) as pool:
            outs = list(pool.map(body, range(n)))
        torch.cuda.synchronize()
        WHISPER_TP["block_launches"] = {
            "flash_attention": flash_attention.launches}
    finally:
        for name, fn in real.items():
            setattr(layers_mod, name, fn)
        dist.get_world_size, dist.get_rank = real_size, real_rank
    return outs, blocks


def whisper_tp_eval(card: str, trained: dict, held: dict, k4_model) -> None:
    """Phase 16w, its first part, on 16a0's trained ``whisper-large-v3``
    FULL weights and held eval batch (4 x 384 tokens, 4 x 1500 frames):

    * K4 on the rank blocks of mp = 16: decoder layer 0's q, k and v
      projected from its input (captured from an eval forward), and
      ``models/layers.py::_gqa_head_dim`` itself on each of the 16
      ranks' ``head_dim`` columns, the ranks in threads with the
      collectives done by hand (:func:`_rank_threads`): K4's count 0
      just before and 16 just after, each launch on the route's own
      views of the rank's block of heads (``_heads_of``: 2 heads on
      ranks 0-3, 1 on ranks 4-15) against ``flash_attention_torch`` on
      the same views within KERNEL_TOL, and the ranks' columns after the
      route's all-to-all against K4's whole (4, 384, 20, 64) call.  Rank
      0's (H = 2) and rank 4's (H = 1) launches timed warm and flushed
      beside their bounds and SDPA: their rows in the kernels line, with
      the launches of this run.
    * The one-rank tensor-parallel eval, on an NCCL serving mesh of one
      rank: ``make_sharded_eval_step`` with K4 on the held batch, K4's
      count 0 just before and 32 (one a causal decoder layer) just
      after, the loss within WHISPER_TP_LOSS_RTOL of ``make_eval_step``'s
      with K4 (16a0's); its collectives by kind (the dry run's
      ``Census``) and its ms in turns with the single-device eval's.
    Results go into ``WHISPER_TP``."""
    import torch
    import repro_torch.models.layers as layers_mod
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    from repro_torch.launch.dryrun import Census
    from repro_torch.training import make_eval_step
    from repro_torch.training.sharded import (make_sharded_eval_step,
                                              shard_params)
    t0 = time.perf_counter()
    params, cfg = trained["params"], k4_model.cfg
    H, n = cfg.n_heads, WHISPER_TP_MP
    say(f"== whisper tp (16w): {cfg.name} FULL (16a0's trained weights) at "
        f"mp = {n}: {H} heads and kv heads of {cfg.head_dim}, on head_dim "
        f"(20 % 16 != 0); at S > 1 each rank attends a block of whole "
        f"heads [{card}]")
    seen, real = [], layers_mod.gqa_apply

    def capture(p, x, cfg_, **kw):
        # decoder layer 0's self-attention: the first causal call (the
        # encoder's layers come first and are not causal)
        if not seen and kw.get("causal", True) and kw.get("cross_kv") is None:
            seen.append((p, x, kw["positions"]))
        return real(p, x, cfg_, **kw)
    layers_mod.gqa_apply = capture
    try:
        with torch.no_grad():
            k4_model.train_logits(params, {k: t for k, t in held.items()
                                           if k != "labels"})
    finally:
        layers_mod.gqa_apply = real
    p0, x0, pos = seen[0]
    del seen
    with torch.no_grad():
        q, k, v = (layers_mod.proj_heads(x0, p0[w])
                   for w in ("wq", "wk", "wv"))
        if "bq" in p0:
            q = q + p0["bq"]
        if "bk" in p0:
            k, v = k + p0["bk"], v + p0["bv"]
        whole = flash_attention(layers_mod.apply_rope(q, pos, cfg.rope_theta),
                                layers_mod.apply_rope(k, pos, cfg.rope_theta),
                                v, causal=True)
        outs, blocks = _rank_threads(n, cfg, q, k, v, pos)
    k4 = WHISPER_TP["block_launches"]["flash_attention"]
    if k4 != n:
        raise AssertionError(f"[whisper tp] _gqa_head_dim over {n} ranks "
                             f"launched K4 {k4} times, want {n}")
    Dl, worst, join = cfg.head_dim // n, 0.0, 0.0
    with torch.no_grad():
        for r in range(n):
            qb, kb, vb, out = blocks[r]
            c = layers_mod._heads_of(H, n, r)[1][r]
            want = flash_attention_torch(qb, kb, vb, causal=True)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            if (qb.shape[2] != c or qb.is_contiguous() or vb.is_contiguous()
                    or not (torch.isfinite(out).all() and err <= KERNEL_TOL)):
                raise AssertionError(f"[whisper tp] K4 on rank {r}'s heads "
                                     f"{tuple(qb.shape)} (strides "
                                     f"{qb.stride()}, {vb.stride()}; want "
                                     f"{c} heads, views) against its plain "
                                     f"version: {err}")
            cols = whole[..., r * Dl:(r + 1) * Dl]
            join = max(join, (outs[r].float() - cols.float()).abs().max()
                       .item())
            if r in (0, 4):
                label = (f"{WHISPER} tp rank block: mp = {n}, rank {r}'s "
                         f"B={qb.shape[0]} S={qb.shape[1]} H={c} D="
                         f"{qb.shape[3]} causal, _gqa_head_dim's views (q "
                         f"strides {tuple(qb.stride())}, v "
                         f"{tuple(vb.stride())})")
                WHISPER_TP["rows"].append(_k4_block_row(label, qb, kb, vb,
                                                        out, err))
        same = torch.equal(torch.cat(outs, 3), whole)
    say(f"   _gqa_head_dim on all {n} ranks (threads, collectives by hand): "
        f"K4 launched {k4} times, on views of 2 heads (ranks 0-3) and 1 "
        f"(4-15); worst max_abs_err to the plain version {worst:.3e} (tol "
        f"{KERNEL_TOL:.0e}); the ranks' columns after the all-to-all "
        f"against K4's whole {tuple(whole.shape)} call: max_abs_err "
        f"{join:.3e}, bit for bit {same} [{card}]")
    if not join <= KERNEL_TOL:
        raise AssertionError(f"[whisper tp] the ranks' columns do not "
                             f"reassemble K4's whole call: {join}")
    del q, k, v, whole, outs, blocks, p0, x0
    WHISPER_TP["seconds"]["K4 blocks"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    with _serving_mesh(cfg) as mesh:
        sparams = shard_params(k4_model, mesh, params)
        sh_eval, k4_eval = (make_sharded_eval_step(k4_model, mesh),
                            make_eval_step(k4_model))
        single = float(k4_eval(params, held))
        torch.cuda.synchronize()
        flash_attention.launches = 0
        counted = Census()
        with counted:
            loss = float(sh_eval(sparams, held))
        torch.cuda.synchronize()
        k4 = flash_attention.launches
        coll = {kind: c for kind, c in counted.coll_counts.items() if c}
        ms = _in_turns({"single": lambda: k4_eval(params, held),
                        "tp": lambda: sh_eval(sparams, held)}, 2)
        rel = abs(loss - single) / abs(single)
        want = _kernel_layers(cfg)
        say(f"   make_sharded_eval_step with K4: loss {loss:.6f} "
            f"(make_eval_step with K4, 16a0's: {single:.6f}, relative "
            f"{rel:.2e}, tol {WHISPER_TP_LOSS_RTOL:.0e}); K4 launches {k4} "
            f"for {want} causal decoder layers; collectives {coll}; in "
            f"turns {ms['tp']} ms beside make_eval_step's {ms['single']} "
            f"ms [{card}]")
        if k4 != want or not rel <= WHISPER_TP_LOSS_RTOL:
            raise AssertionError(f"[whisper tp] sharded eval: K4 {k4} for "
                                 f"{want} layers, loss {loss} vs {single}")
        del sparams
    WHISPER_TP["launches"] = {"flash_attention": k4}
    WHISPER_TP["seconds"]["sharded eval"] = time.perf_counter() - t1
    say(f"== whisper tp, eval part: {time.perf_counter() - t0:.1f} s "
        f"[{card}]")


def whisper_tp_serve(card: str, model, params, index, qs, tokens: dict,
                     counters: dict, policy) -> None:
    """Phase 16w, its serving part, on 16d's ``whisper-large-v3`` FULL
    weights: on an NCCL serving mesh of one rank, ``ShardedExecutor``
    serves 16d's first 8 requests through ``Gateway.serve``, every
    launch count 0 just before and read just after: K1 exactly 32
    decoder layers x decode steps, K2 never, the tokens equal to 16d's
    (``tokens``, by prompt); then one decode step of NUM_SLOTS slots
    through the tensor-parallel apply and on one device: its
    collectives by kind (the dry run's ``Census``) and its ms in turns
    (single, tp, tp, single)."""
    import torch
    from repro_torch.data import HashTokenizer
    from repro_torch.launch.dryrun import Census
    from repro_torch.routing import ContinuousEngineBackend
    t0 = time.perf_counter()
    cfg = model.cfg
    L = _kernel_layers(cfg)
    with _serving_mesh(cfg) as mesh:
        tp = mesh.group("model")
        backend = ContinuousEngineBackend.create(
            model, params, HashTokenizer(cfg.vocab_size), index,
            num_slots=NUM_SLOTS, prefill_batch=PREFILL_BATCH,
            max_prompt_len=MAX_PROMPT_LEN, max_new_tokens=MAX_NEW_TOKENS,
            mesh=mesh)
        ex = backend.engine.executor
        if type(ex).__name__ != "ShardedExecutor":
            raise AssertionError(f"[whisper tp] executor "
                                 f"{type(ex).__name__}")
        label = f"{WHISPER} tp dense"
        run = _drive(label, backend, index, qs, 1, card, L, counters, policy)
        _check_launches(label, run["launches"], "flash_decode",
                        run["steps"], L, absent=("paged_flash_decode",))
        got = run["rec"]["tokens"]
        equal = sum(tokens.get(p) == t for p, t in got.items())
        say(f"   ShardedExecutor (dp = 1 over NCCL): {equal} of {len(got)} "
            f"requests' tokens equal to 16d's; launches {run['launches']} "
            f"[{card}]")
        if len(got) != 8 or equal != len(got):
            raise AssertionError(f"[whisper tp] {equal} of {len(got)} token "
                                 f"lists equal 16d's")
        del backend, run, ex
        dev = params["embed"].device
        cache = model.init_cache(NUM_SLOTS, MAX_PROMPT_LEN + MAX_NEW_TOKENS,
                                 device=dev)
        step_tokens = torch.zeros(NUM_SLOTS, 1, dtype=torch.int32,
                                  device=dev)
        steps, colls = {}, {}
        for name, group in (("single", None), ("tp", tp)):
            @torch.no_grad()
            def step(group=group):
                lg, _ = model.decode(params, {"tokens": step_tokens}, cache,
                                     tp=group)
                return lg[:, -1].argmax(-1)
            counted = Census()
            with counted:
                step()
            torch.cuda.synchronize()
            steps[name] = step
            colls[name] = {k: c for k, c in counted.coll_counts.items() if c}
        ms = _in_turns(steps, 2)
        del cache
    say(f"   decode step ({NUM_SLOTS} slots), in turns single, tp, tp, "
        f"single: tensor-parallel {ms['tp']} ms, collectives "
        f"{colls['tp']}; single-device {ms['single']} ms, collectives "
        f"{colls['single']} [{card}]")
    WHISPER_TP["seconds"]["serve"] = time.perf_counter() - t0
    say(f"== whisper tp (16w): {sum(WHISPER_TP['seconds'].values()):.1f} s "
        f"in all ({', '.join(f'{k} {v:.1f} s' for k, v in WHISPER_TP['seconds'].items())}) [{card}]")


def _prefill_flops(cfg, B: int, S: int) -> int:
    """The operations one prefill of B prompts of S tokens needs on an
    attention stack: the weight products of every token (an MoE layer's
    router, its shared experts' and its top-k experts' products, the
    routed rows the grouped GEMM computes), the causal attention scores
    and values, and the unembedding of the last position.  An MLA
    layer's products are its query (through the q-LoRA), latent, key /
    value expansion and output projections; its scores span the nope and
    rope dims, its values v_head_dim.  A decoder layer of an
    encoder-decoder adds its cross sublayer, as a served prefill runs it
    (no encoder: keys and values from the cache)."""
    T = B * S
    d, H, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    causal = S * (S + 1) // 2
    if cfg.attn_type == "mla":
        m = cfg.mla
        qd, r, rq = (m.qk_nope_head_dim + m.qk_rope_head_dim,
                     m.kv_lora_rank, m.q_lora_rank)
        proj = ((d * rq + rq * H * qd) if rq else d * H * qd) \
            + d * (r + m.qk_rope_head_dim) \
            + r * H * (m.qk_nope_head_dim + m.v_head_dim) \
            + H * m.v_head_dim * d
        attn = 2 * T * proj + 2 * B * H * (qd + m.v_head_dim) * causal
    else:
        attn = 2 * T * d * D * (2 * H + 2 * Hkv) + 4 * B * H * D * causal
    if cfg.is_encoder_decoder:
        # the cross sublayer: its query and output products, scores and
        # values over every encoder row (keys and values from the cache)
        attn += 2 * T * d * D * 2 * H + 4 * B * H * D * S * cfg.encoder_seq_len
    ops = 2 * B * d * cfg.padded_vocab
    for i in range(cfg.n_layers):
        ops += attn
        if cfg.is_moe_layer(i):
            e = cfg.moe
            ops += (2 * T * d * e.n_experts
                    + 2 * T * (e.top_k + e.n_shared_experts) * 3 * d
                    * e.d_ff_expert)
        else:
            ops += 2 * T * 3 * d * cfg.d_ff
    return ops


def _kernel_layers(cfg) -> int:
    """The layers whose decode takes K1 / K2: GQA attention layers with
    no window (the reference's gate; no served config sets a softcap).
    An MLA stack has none: the reference's MLA has no kernel branch."""
    from repro_torch.models.transformer import layer_structure
    if cfg.attn_type == "mla":
        return 0
    prefix, block, n_blocks = layer_structure(cfg)
    def count(sigs):
        return sum(s.kind == "A" and not s.window for s in sigs)
    return count(prefix) + n_blocks * count(block)


# parameter subtrees a served decode step never reads: the
# multi-token-prediction head (training only), the image projector and
# the encoder (prefill only)
NOT_DECODED = ("mtp", "projector", "encoder", "enc_pos", "enc_final_norm")


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _served_weight_bytes(params, expert_share: float = 1.0) -> float:
    """The bytes a decode step reads once at least: every weight but
    those of ``NOT_DECODED``, an MoE layer's routed experts (its
    ``EXPERT_LEAVES``) times ``expert_share``, the share of its experts a
    step's rows reach: the grouped GEMM reads only those."""
    def walk(tree, path=()):
        if isinstance(tree, dict):
            return sum(walk(v, path + (k,)) for k, v in tree.items())
        if isinstance(tree, (list, tuple)):
            return sum(walk(v, path) for v in tree)
        share = (expert_share if path[-2:-1] == ("moe",)
                 and path[-1] in EXPERT_LEAVES else 1.0)
        return tree.numel() * tree.element_size() * share
    return walk({k: v for k, v in params.items() if k not in NOT_DECODED})


def _moe_layers(cfg) -> int:
    return sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))


@contextlib.contextmanager
def _routed_groups(calls: list):
    """Record ``(rows, offsets)`` of every forward grouped product (the
    op ``repro_torch::grouped_gemm`` on untransposed weights) dispatched
    while open, by a dispatch mode: nothing is patched, and the offsets
    stay on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._schema.name == "repro_torch::grouped_gemm" and not (
                    args[3]):
                calls.append((args[0].shape[0], args[2]))
            return func(*args, **(kwargs or {}))
    with Recorder():
        yield


def _decode_expert_share(cfg, calls, slots: int) -> float:
    """The mean share of an MoE layer's experts that a decode step's rows
    (``slots`` x top-k) reach, over the recorded products; 1.0 without
    MoE."""
    import torch
    if not cfg.moe:
        return 1.0
    dec = [o for m, o in calls if m == slots * cfg.moe.top_k]
    if not dec:
        raise AssertionError(f"no decode step's grouped product was "
                             f"recorded ({len(calls)} products)")
    hits = torch.stack([(o[1:] > o[:-1]).sum() for o in dec])
    return hits.float().mean().item() / cfg.moe.n_experts


def _check_moe_launches(label, launches, stats, cfg) -> int:
    """K7 three times (gate, up, down) in each MoE layer of every
    forward, each admission group's prefill and each decode step.
    Returns the count."""
    want = 3 * _moe_layers(cfg) * (stats.n_prefills + stats.n_decode_steps)
    got = launches["grouped_gemm"]
    if not cfg.moe:
        if got:
            raise AssertionError(f"[{label}] grouped_gemm launched {got} "
                                 f"times without MoE layers")
        return 0
    say(f"   grouped_gemm (K7) launches {got} = 3 x {_moe_layers(cfg)} MoE "
        f"layers x ({stats.n_prefills} prefills + {stats.n_decode_steps} "
        f"decode steps)")
    if got != want or not got:
        raise AssertionError(f"[{label}] grouped_gemm launched {got} times, "
                             f"want {want}")
    return got


def _cross_cache_bytes(cfg, slots: int) -> int:
    """The encoder keys and values a decode step of ``slots`` slots reads
    in every decoder layer (0 without cross-attention)."""
    if not cfg.is_encoder_decoder:
        return 0
    return (slots * cfg.n_layers * cfg.encoder_seq_len * cfg.n_kv_heads
            * cfg.head_dim * 2 * 2)


def _say_step_and_prefill(label, rec, ex, cfg, params, card,
                          groups=()) -> float:
    """Print the dense engine's decode step (median of the chunks'
    per-step device time) beside its bound, the weights read once (an
    MoE layer's experts as many as the step's rows reach, by the routed
    ``groups`` that :func:`_check_repeat` recorded; and, for an
    encoder-decoder, every slot's cross cache), and each admission
    group's prefill (device time of prefill + commit) beside its bound
    over the routed operations or every weight read once.  Returns the
    decode bound in ms."""
    import statistics
    share = _decode_expert_share(cfg, groups, ex.num_slots)
    weight_bytes = _served_weight_bytes(params, share)
    cross = _cross_cache_bytes(cfg, ex.num_slots)
    per_step = [s_.elapsed_time(e) / ex.sync_every for s_, e in rec["chunks"]]
    step_ms = statistics.median(per_step)
    bound_ms = (weight_bytes + cross) / HBM_BYTES_PER_S * 1e3
    what = (f"weight-read bound {bound_ms:.2f} ms ({weight_bytes / 1e9:.1f}"
            f" GB" + (f" + {cross / 1e9:.2f} GB of cross cache" if cross
                      else "") + " / 3.35 TB/s" + (
                f"; an MoE layer's step reaches {share * cfg.moe.n_experts:.1f}"
                f" of its {cfg.moe.n_experts} experts" if cfg.moe else "")
            + ")")
    say(f"   decode step [{label}]: median {step_ms:.2f} ms over "
        f"{len(per_step)} chunks of {ex.sync_every} steps (CUDA events; "
        f"{[round(x, 2) for x in per_step]}) beside its {what} = "
        f"{step_ms / bound_ms:.2f} x [{card}]")
    admits = {}
    for shape, (s_, e) in zip(rec["admit_shapes"], rec["admits"]):
        admits.setdefault(shape, []).append(s_.elapsed_time(e))
    every_weight = _served_weight_bytes(params)
    for (B, S), ms in admits.items():
        need = _prefill_flops(cfg, B, S)
        pre_bound = max(every_weight / HBM_BYTES_PER_S,
                        need / BF16_OPS_PER_S) * 1e3
        say(f"   prefill [{label}]: {len(ms)} admission groups of {B} x {S} "
            f"tokens, {statistics.median(ms):.2f} ms each (median device "
            f"time of prefill + commit; {[round(x, 2) for x in ms]}) beside "
            f"its bound {pre_bound:.2f} ms ({need / 1e12:.2f} TFLOP routed / "
            f"989 TFLOP/s, or every weight read once) [{card}]")
    return bound_ms


def _check_repeat(label, dense, qs, groups=None) -> dict:
    """Serve the FixedPolicy(0) batch of a :func:`_drive` run again,
    untimed: its greedy tokens must repeat bit for bit.  Given a list
    ``groups``, the repeat records its grouped products there
    (:func:`_routed_groups`): the same tokens route alike, so a decode
    step reaches the experts it reached in the timed run.  Returns the
    first run's tokens by prompt (the record then holds the repeat's
    tokens and, still, only the timed run's events)."""
    import torch
    rec = dense["rec"]
    first = dict(rec["tokens"])
    rec["tokens"].clear()
    timed = {k: len(rec[k]) for k in ("chunks", "admits", "admit_shapes")}
    with (contextlib.nullcontext() if groups is None
          else _routed_groups(groups)):
        dense["gateways"][0][1].serve(_requests(qs, 0))
    torch.cuda.synchronize()
    for k, n in timed.items():
        del rec[k][n:]
    again = rec["tokens"]
    same = sum(first.get(k) == v for k, v in again.items())
    say(f"   repeat [{label}]: the FixedPolicy(0) batch served again, "
        f"{same} of {len(again)} requests' greedy tokens identical to the "
        f"first run's")
    if len(again) != 8 or same != len(again):
        raise AssertionError(f"[{label}] the greedy tokens of a repeated "
                             f"batch differ: {same} of {len(again)} equal")
    return first


def _check_no_sync(ex, what: str) -> None:
    """One more decode chunk of executor ``ex`` under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync raises."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ex.decode_chunk()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say(f"   {what} under torch.cuda.set_sync_debug_mode('error'): no host "
        f"sync")


def _build_family(arch: str, layers, card: str, phase: str) -> tuple:
    """``arch``'s FULL config, its depth cut to ``layers`` (None: not
    cut), built with seeded weights on the card; prints its widths and
    its cut (for a ``phase`` that trains, against the 12 B a param of a
    train state).  Returns (cfg, model, params)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    full = get_config(arch, "full")
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    moe = (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff "
           f"{cfg.moe.d_ff_expert} ({cfg.moe.n_shared_experts} shared, the "
           f"first {cfg.moe.first_k_dense} layers dense of d_ff {cfg.d_ff})"
           if cfg.moe else f", d_ff {cfg.d_ff}")
    L = _kernel_layers(cfg)
    window = (f", sliding window {cfg.sliding_window} on "
              f"{cfg.n_layers - L} local layers ({''.join(cfg.attn_pattern)}"
              f" repeated), {L} global" if cfg.sliding_window else "")
    m = cfg.mla
    mla = (f", MLA (kv_lora_rank {m.kv_lora_rank}, q_lora_rank "
           f"{m.q_lora_rank}, qk_nope {m.qk_nope_head_dim} + qk_rope "
           f"{m.qk_rope_head_dim}, v {m.v_head_dim})" if m else "")
    mtp = f", MTP depth {cfg.mtp_depth}" if cfg.mtp_depth else ""
    say(f"== {phase}: {cfg.name} ({cfg.source}), {cfg.n_layers} "
        f"layers x d_model {cfg.d_model}, {cfg.n_heads} heads over "
        f"{cfg.n_kv_heads} kv heads (G = {cfg.n_heads // cfg.n_kv_heads}), "
        f"head_dim {cfg.head_dim}{mla}{moe}{mtp}, vocab {cfg.vocab_size}, "
        f"rope theta {cfg.rope_theta:g}{window}; "
        f"{model.n_params() / 1e9:.2f} B params {cfg.dtype}, seeded init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB [{card}]")
    if layers is not None:
        n_full = build_model(full).n_params()
        held = (f"{n_full * 12 / 1e9:.0f} GB of params, gradients and "
                f"AdamW moments at 12 B a param" if "train" in phase else
                f"{n_full * 2 / 2**30:.0f} GiB in bf16")
        say(f"   reduced: n_layers {full.n_layers} -> {layers} (FULL is "
            f"{n_full / 1e9:.1f} B params, {held}, beyond one 80 GB "
            f"card); every width as published")
    else:
        say("   reduced: nothing (FULL's own depth)")
    return cfg, model, params


def _serve_family(arch: str, layers, card: str, policy, data, index,
                  phase: str = "moe/gqa serve") -> tuple:
    """One model through ``Gateway.serve``: the dense engine (K1), for a
    model with sliding-window layers also the dense engine with the ring
    cache (``window_ring_cache=True``), then the paged engine (K2); see
    :func:`moe_gqa_serve_phase`.  K1 / K2 launch once a decode step in
    each layer the reference's gate lets through (no window).  Returns
    the model, its params and the launches of K1 on the dense engine and
    of K2 on the paged one."""
    import statistics

    import torch
    from repro_torch.data import HashTokenizer
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_torch)
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.models import build_model
    from repro_torch.models import layers as model_layers
    from repro_torch.models.schema import tree_leaves
    from repro_torch.routing import ContinuousEngineBackend
    cfg, model, params = _build_family(arch, layers, card, phase)
    L = _kernel_layers(cfg)
    counters = {"flash_decode": flash_decode,
                "paged_flash_decode": paged_flash_decode,
                "grouped_gemm": grouped_gemm}
    qs = data.questions[-16:]

    def backend_for(served_model=model, **engine_kw):
        return ContinuousEngineBackend.create(
            served_model, params, HashTokenizer(cfg.vocab_size), index,
            num_slots=NUM_SLOTS, prefill_batch=PREFILL_BATCH,
            max_prompt_len=MAX_PROMPT_LEN, max_new_tokens=MAX_NEW_TOKENS,
            **engine_kw)

    # -- dense slot cache: K1 -------------------------------------------
    backend = backend_for()
    label = f"{arch} dense"
    dense = _drive(label, backend, index, qs, 2, card, L, counters, policy)
    _check_launches(label, dense["launches"], "flash_decode",
                    dense["steps"], L, absent=("paged_flash_decode",))
    k7 = _check_moe_launches(label, dense["launches"], backend.engine.stats,
                             cfg)
    rec, ex = dense["rec"], backend.engine.executor
    groups = []
    first = _check_repeat(label, dense, qs, groups)
    bound_ms = _say_step_and_prefill(label, rec, ex, cfg, params, card,
                                     groups)
    del groups
    # a decode chunk on the card synchronises with the host nowhere (the
    # MoE group offsets stay on the device)
    _check_no_sync(ex, "decode chunk")
    # a witness for the dense-vs-paged agreement below: the same batch
    # with K1 swapped for its plain version (float32 throughout)
    rec["tokens"].clear()
    with mock.patch.object(model_layers, "flash_decode", flash_decode_torch):
        dense["gateways"][0][1].serve(_requests(qs, 0))
    torch.cuda.synchronize()
    plain = dict(rec["tokens"])
    agree = sum(a == b for k in plain for a, b in zip(plain[k], first[k]))
    total = sum(min(len(plain[k]), len(first[k])) for k in plain)
    say(f"   witness [{label}]: the FixedPolicy(0) batch served again with "
        f"K1 swapped for flash_decode_torch: {agree} of {total} greedy "
        f"tokens agree with K1's")
    dense_tokens, dense_launches = first, dense["launches"]
    del dense, backend, rec, ex

    # -- the ring cache of the windowed layers: K1 on the global ones ----
    if cfg.sliding_window:
        _free_gpu_memory(f"{arch} dense ring")
        ring_model = build_model(dataclasses.replace(
            cfg, window_ring_cache=True))
        backend = backend_for(ring_model)
        label = f"{arch} dense ring"
        ring = _drive(label, backend, index, qs, 2, card, L, counters,
                      policy)
        _check_launches(label, ring["launches"], "flash_decode",
                        ring["steps"], L, absent=("paged_flash_decode",))
        ex = backend.engine.executor
        per_step = [s_.elapsed_time(e) / ex.sync_every
                    for s_, e in ring["rec"]["chunks"]]
        tokens = ring["rec"]["tokens"]
        common = [k for k in tokens if k in dense_tokens]
        agree = sum(a == b for k in common
                    for a, b in zip(tokens[k], dense_tokens[k]))
        total = sum(min(len(tokens[k]), len(dense_tokens[k]))
                    for k in common)
        spans = sorted({tuple(c.shape)[2] for c in tree_leaves(
            ex._cache["blocks"]) if c.dim() == 5})
        say(f"   decode step [{label}]: median "
            f"{statistics.median(per_step):.2f} ms (bound {bound_ms:.2f} "
            f"ms); cache rows a layer {spans} (ring = min(max_len, "
            f"window)); {agree} of {total} greedy tokens agree with the "
            f"full cache's over {len(common)} common prompts [{card}]")
        _check_no_sync(ex, "ring decode chunk")
        del ring, backend, ex, ring_model
    _free_gpu_memory(f"{arch} paged")

    # -- paged pool with prefix sharing: K2 -----------------------------
    backend = backend_for(paged=True, page_size=PAGE_SIZE,
                          num_pages=NUM_PAGES)
    label = f"{arch} paged"
    paged = _drive(label, backend, index, qs, 2, card, L, counters, policy)
    _check_paged_launches(label, paged["launches"], paged["steps"], L,
                          paged["rec"]["short_prefills"])
    k7 += _check_moe_launches(label, paged["launches"], backend.engine.stats,
                              cfg)
    tokens = paged["rec"]["tokens"]
    common = [k for k in tokens if k in dense_tokens]
    agree = sum(a == b for k in common
                for a, b in zip(tokens[k], dense_tokens[k]))
    total = sum(min(len(tokens[k]), len(dense_tokens[k])) for k in common)
    firsts = sum(tokens[k][:1] == dense_tokens[k][:1] for k in common)
    per_step = [s_.elapsed_time(e) / backend.engine.executor.sync_every
                for s_, e in paged["rec"]["chunks"]]
    say(f"   decode step [{label}]: median {statistics.median(per_step):.2f} "
        f"ms (bound {bound_ms:.2f} ms); {agree} of {total} greedy tokens "
        f"agree with the dense engine's over {len(common)} common prompts, "
        f"the first (prefill's) token of {firsts}: bf16 sums in K2's order "
        f"and K1's part the two runs [{card}]")
    launches = {"flash_decode": dense_launches["flash_decode"],
                "paged_flash_decode": paged["launches"]["paged_flash_decode"],
                "grouped_gemm": k7}
    del paged, backend
    return model, params, launches


def moe_gqa_serve_phase(card: str, policy) -> dict:
    """The mixture-of-experts and GQA families at their published widths
    through ``Gateway.serve``: ``dbrx-132b`` (16 experts top-4, G = 6)
    cut to 10 of its 40 layers and ``command-r-35b`` FULL (G = 8), seeded
    bf16 weights, one after the other, each after the previous model's
    memory is freed.  Each on the dense engine (K1) and the paged engine
    (page 8, 400 pages; K2) at the main path's settings (8 slots,
    prefill batch 4, prompts of 384, 8 new tokens): 8 requests under
    ``FixedPolicy(0)``, 8 routed by ``policy`` (the trained router),
    every launch count 0 just before and read just after.  Checks every
    request served, K1 (dense) and K2 (paged) launched exactly layers x
    decode steps, dbrx's MoE layers launching K7 (the grouped GEMM)
    three times in each forward (:func:`_check_moe_launches`), the dense
    engine's greedy tokens repeating bit for bit when its first batch
    is served again, and a dense decode chunk running with no host
    sync; prints the decode step (median of the chunks' per-step device
    time) beside its weight-read bound (an MoE layer's experts as many
    as the step's rows reach), each admission group's prefill beside
    its bound over the routed operations, peak memory, and how many
    greedy tokens of the first batch agree when it is served again with
    K1 swapped for its plain version (a witness for the dense-vs-paged
    agreement).  Returns each model's launches (K1 dense, K2 paged, K7
    on both)."""
    from repro_torch.data import SyntheticSquad
    from repro_torch.retrieval import BM25Index
    t0 = time.perf_counter()
    data = SyntheticSquad(n_paragraphs=600, n_questions=1000, seed=0)
    index = BM25Index.build([p.text for p in data.paragraphs])
    launches = {}
    for arch, layers in MOE_GQA_MODELS:
        _free_gpu_memory(f"{arch} dense")
        launches[arch] = _serve_family(arch, layers, card, policy, data,
                                       index)[2]
    say(f"== moe/gqa serve: both models served, {time.perf_counter() - t0:.1f}"
        f" s")
    return launches


def gemma3_serve_phase(card: str, policy) -> dict:
    """``gemma3-12b`` FULL (48 layers, 5 local with a window of 1024 to 1
    global, head_dim 256; seeded bf16, not cut) through ``Gateway.serve``
    as the MoE / GQA phase serves its models (:func:`_serve_family`): on
    the dense engine (K1), the dense engine with the ring cache and the
    paged engine (page 8, 400 pages; K2), 8 + 8 requests each.  K1 / K2
    launch exactly 8 global layers x decode steps: the local layers take
    the plain attention, as the reference's gate sends them.  Then
    :func:`gemma3_long_case` on the same weights.  Returns the launches
    of K1 (dense engine) and K2 (paged engine), the head-dim-256 rows'
    counts in the kernel table."""
    from repro_torch.data import SyntheticSquad
    from repro_torch.retrieval import BM25Index
    t0 = time.perf_counter()
    data = SyntheticSquad(n_paragraphs=600, n_questions=1000, seed=0)
    index = BM25Index.build([p.text for p in data.paragraphs])
    _free_gpu_memory(f"{GEMMA} dense")
    model, params, launches = _serve_family(GEMMA, None, card, policy, data,
                                            index, phase="gemma3 serve")
    _free_gpu_memory(f"{GEMMA} long case")
    gemma3_long_case(card, model, params)
    del model, params
    say(f"== gemma3 serve: {time.perf_counter() - t0:.1f} s")
    return launches


def mla_smoke_check(card: str) -> None:
    """``deepseek-v3-671b`` SMOKE (MLA with the q-LoRA, a dense first
    layer, MoE with a shared expert, MTP) in float32 on the card against
    the host, on the same weights and tokens: prefill + 4 greedy decode
    steps with the naive and the absorbed decode, and the training
    forward's logits and MTP logits, each within MLA_F32_RTOL of max
    |logit|."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.schema import tree_map
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", "smoke"),
                              dtype="float32")
    model = build_model(cfg)
    host = model.init(seed=0, device="cpu")
    on_card = tree_map(lambda t: t.cuda(), host)
    worst = {f"decode {'absorbed' if a else 'naive'}": _card_vs_host(
        model, host, on_card, mla_absorb=a) for a in (False, True)}
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        4, cfg.vocab_size, size=(2, 16)))
    want = model.train_logits(host, {"tokens": toks})
    got = model.train_logits(on_card, {"tokens": toks.cuda()})
    for name, w, g in (("train logits", want[0], got[0]),
                       ("MTP logits", want[1]["mtp_logits"],
                        got[1]["mtp_logits"])):
        worst[name] = ((w - g.cpu()).abs().max() / w.abs().max()).item()
    say(f"== mla smoke: {cfg.name} float32, card vs host, max |dlogit| / "
        f"max |logit|: {', '.join(f'{k} {v:.3e}' for k, v in worst.items())}"
        f" (tol {MLA_F32_RTOL:g}) [{card}]")
    bad = {k: v for k, v in worst.items() if not v <= MLA_F32_RTOL}
    if bad:
        raise AssertionError(f"[mla smoke] the card disagrees with the "
                             f"host: {bad}")


def _greedy_steps(model, params, logits, cache, n: int, feed,
                  **forward_kw) -> tuple:
    """``n`` decode steps after a prefill whose last logits (float32
    (B, V)) and cache are given, fed ``feed`` (or, when None, this run's
    greedy tokens).  Returns (the logits of every step, the prefill's
    first, float32 (B, V) each, the tokens fed, the cache)."""
    import torch
    steps, tokens = [logits], ([] if feed is None else feed)
    for t in range(n):
        if feed is None:
            tokens.append(steps[-1].argmax(-1).to(torch.int32))
        logits, cache = model.decode(params, {"tokens": tokens[t][:, None]},
                                     cache, **forward_kw)
        steps.append(logits[:, -1].float())
    return steps, tokens, cache


def _mla_run(model, params, prompts, feed, absorb: bool) -> tuple:
    """``prompts`` (NUM_SLOTS of MAX_PROMPT_LEN tokens) prefilled
    together, then MAX_NEW_TOKENS ``_greedy_steps`` with the naive or the
    absorbed MLA.  Returns (the logits of every step, the tokens fed)."""
    import numpy as np
    import torch
    with torch.no_grad():
        cache = model.init_cache(len(prompts), MAX_PROMPT_LEN
                                 + MAX_NEW_TOKENS, device="cuda")
        toks = torch.as_tensor(np.stack(prompts), device=cache["pos"].device)
        logits, cache = model.prefill(params, {"tokens": toks}, cache,
                                      mla_absorb=absorb)
        steps, tokens, _ = _greedy_steps(model, params,
                                         logits[:, -1].float(), cache,
                                         MAX_NEW_TOKENS, feed,
                                         mla_absorb=absorb)
    torch.cuda.synchronize()
    return steps, tokens


def mla_absorb_witness(card: str, cfg, params) -> None:
    """The naive and the absorbed MLA on the served model's weights,
    driven through ``prefill`` / ``decode``: NUM_SLOTS seeded prompts of
    MAX_PROMPT_LEN, MAX_NEW_TOKENS greedy steps, both fed the naive
    run's tokens.  In bf16 each step's max |logit difference| and the
    greedy tokens the two share are printed; then the witness, the same
    weights in float32 (the bf16 params converted in place): every step
    within ``MLA_ABSORB_RTOL`` of max |logit|, so what the bf16 runs
    show is rounding and not two functions."""
    import numpy as np
    from repro_torch.models import build_model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(4, cfg.vocab_size, size=MAX_PROMPT_LEN)
               for _ in range(NUM_SLOTS)]
    for dtype, held in (("bfloat16", 0), ("float32", MAX_NEW_TOKENS + 1)):
        if dtype == "float32":
            _to_float32(params)
        model = build_model(dataclasses.replace(cfg, dtype=dtype))
        t0 = time.perf_counter()
        naive, feed = _mla_run(model, params, prompts, None, False)
        absorbed, _ = _mla_run(model, params, prompts, feed, True)
        say(f"   absorb witness [{cfg.name}, {dtype}]: {NUM_SLOTS} prompts "
            f"of {MAX_PROMPT_LEN}, {MAX_NEW_TOKENS} steps each way, "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
        _long_gaps(dtype, naive, absorbed, held, MLA_ABSORB_RTOL,
                   case="absorb witness", names=("naive", "absorbed"))


def _mtp_loss_check(cfg, params, card: str, counters) -> None:
    """``forward_train_loss`` without autograd on MTP_BATCH x MTP_SEQ
    seeded tokens (labels the next token), with the config's MTP head and
    with ``mtp_depth=0``: both losses finite, and different; no kernel
    launched (the MLA layers take none)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        4, cfg.vocab_size, size=(MTP_BATCH, MTP_SEQ))).cuda()
    labels = torch.full_like(toks, -1)
    labels[:, :-1] = toks[:, 1:]
    batch = {"tokens": toks, "labels": labels}
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    losses = {}
    with torch.no_grad():
        for depth in (cfg.mtp_depth, 0):
            s_ = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s_.record()
            loss = T.forward_train_loss(
                params, dataclasses.replace(cfg, mtp_depth=depth), batch)
            e.record()
            torch.cuda.synchronize()
            losses[depth] = (float(loss), s_.elapsed_time(e))
    launches = {name: fn.launches for name, fn in counters.items()}
    (l_mtp, ms_mtp), (l_no, ms_no) = losses[cfg.mtp_depth], losses[0]
    say(f"   mtp loss [{cfg.name}]: forward_train_loss on {MTP_BATCH} x "
        f"{MTP_SEQ} tokens, no autograd: {l_mtp:.6f} with MTP depth "
        f"{cfg.mtp_depth} ({ms_mtp:.2f} ms), {l_no:.6f} without "
        f"({ms_no:.2f} ms); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches} [{card}]")
    if not (np.isfinite(l_mtp) and np.isfinite(l_no)) or l_mtp == l_no:
        raise AssertionError(f"[mtp loss] losses {l_mtp} (MTP) and {l_no} "
                             f"(none) must be finite and differ")
    if any(launches.values()):
        raise AssertionError(f"[mtp loss] kernels launched: {launches}")


def _mla_census(device: str = "cuda") -> dict:
    """``MLA_CENSUS``; traced here (on fake ``device`` tensors) when
    phase 16a2 has not run."""
    if not MLA_CENSUS:
        census = [(arch, layers) for arch, layers, _ in MLA_MODELS]
        out = _finish(_subprocess(_DRYRUN_MLA_CODE, json.dumps(census),
                                  json.dumps(_decode_shape()), device),
                      "mla census", 600)
        out.pop("wall_s")
        MLA_CENSUS.update(out)
    return MLA_CENSUS


def mla_tp_decode(cfg, model, params, card: str) -> dict:
    """One decode step of ``NUM_SLOTS`` slots over ``MAX_PROMPT_LEN +
    MAX_NEW_TOKENS``-row caches holding a prefill of seeded prompts,
    naive and absorbed, through the tensor-parallel apply (``tp`` the
    model group of a one-rank NCCL serving mesh, as ``ShardedExecutor``
    runs it: ``models/layers.py::_mla_split`` on unsplit leaves) and on
    one device, each on its own copy of the prefilled cache.  Checks:
    the next tokens equal; the tensor-parallel step's collectives
    (counted by the dry run's ``Census`` on the real step) equal to the
    one-rank dry run's census of the same step (``MLA_CENSUS``); K7's
    launches equal.  Prints both steps' ms (CUDA events, warm).  Returns
    the ms by route."""
    import numpy as np
    import torch
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    from repro_torch.launch.dryrun import Census
    from repro_torch.models.schema import tree_map
    census = _mla_census()
    t0 = time.perf_counter()
    dev = params["embed"].device
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        4, cfg.vocab_size, size=(NUM_SLOTS, MAX_PROMPT_LEN)), device=dev)
    out = {}
    with _serving_mesh(cfg) as mesh:
        tp = mesh.group("model")
        for absorb in (False, True):
            with torch.no_grad():
                cache = model.init_cache(NUM_SLOTS, MAX_PROMPT_LEN
                                         + MAX_NEW_TOKENS, device=dev)
                logits, cache = model.prefill(params, {"tokens": toks}, cache,
                                              mla_absorb=absorb)
                nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            runs = {}
            for name, group in (("single", None), ("tp", tp)):
                mine = tree_map(torch.clone, cache)
                pos = mine["pos"]

                @torch.no_grad()
                def step(mine=mine, group=group):
                    # every call decodes the same step: the cache's row
                    # at pos is written again
                    mine["pos"] = pos
                    lg, _ = model.decode(params, {"tokens": nxt}, mine,
                                         tp=group, mla_absorb=absorb)
                    return lg[:, -1].argmax(-1)
                grouped_gemm.launches = 0
                counted = Census()
                with counted:
                    got = step()
                torch.cuda.synchronize()
                runs[name] = {"tokens": got.tolist(),
                              "k7": grouped_gemm.launches,
                              "counts": {k: n for k, n in
                                         counted.coll_counts.items() if n},
                              "ms": cuda_ms(step, 5)}
                del mine
            del cache
            route = "absorbed" if absorb else "naive"
            want = {k: n for k, n in
                    census[f"{cfg.name} {absorb}"].items() if n}
            single, split = runs["single"], runs["tp"]
            say(f"   tensor-parallel decode step [{cfg.name}, {route}] on a "
                f"one-rank NCCL group, {NUM_SLOTS} slots x "
                f"{MAX_PROMPT_LEN + MAX_NEW_TOKENS} rows: {split['ms']:.3f} "
                f"ms beside the single-device step's {single['ms']:.3f} ms; "
                f"collectives {split['counts']} (the one-rank dry run's "
                f"census {want}); K7 {split['k7']} (single-device "
                f"{single['k7']}); next tokens equal: "
                f"{split['tokens'] == single['tokens']} [{card}]")
            if (split["tokens"] != single["tokens"]
                    or split["counts"] != want or single["counts"]
                    or split["k7"] != single["k7"]):
                raise AssertionError(
                    f"[mla tp decode {cfg.name} {route}] tokens "
                    f"{split['tokens']} vs {single['tokens']}, collectives "
                    f"{split['counts']} vs the census {want} (single-device "
                    f"{single['counts']}), K7 {split['k7']} vs "
                    f"{single['k7']}")
            out[route] = {"ms": split["ms"], "single_ms": single["ms"]}
    say(f"   tensor-parallel decode steps [{cfg.name}]: "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def mla_serve_phase(card: str, policy) -> dict:
    """Multi-head latent attention at its published widths through
    ``Gateway.serve`` on the dense slot engine (the paged pool refuses
    MLA, as the reference's does): ``minicpm3-4b`` FULL (not cut) with
    the naive decode (``mla_absorb=False``, the reference's default) and
    the absorbed one, then ``deepseek-v3-671b`` cut to its first 5
    layers (3 dense, 2 MoE of 256 experts) with the naive decode and its
    training loss with and without MTP; seeded bf16 weights, each model
    after the previous one's memory is freed.  First
    :func:`mla_smoke_check`.  Each engine at the main path's settings (8
    slots, prefill batch 4, prompts of 384, 8 new tokens): 8 requests
    under ``FixedPolicy(0)``, 8 routed by ``policy``, every launch count
    0 just before and read just after.  Checks every request served, K1,
    K2 and K4 launched exactly 0 times (the reference's MLA has no
    kernel branch), deepseek's two MoE layers launching K7 three times in
    each forward, the greedy tokens repeating bit for bit when the first
    batch is served again, and a decode chunk running with no host sync;
    prints the decode step beside its weight-read bound, each admission
    group's prefill beside its bound, peak memory, and how many greedy
    tokens the naive and absorbed runs share.  Returns each model's K7
    launches."""
    import torch
    from repro_torch.data import HashTokenizer, SyntheticSquad
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.retrieval import BM25Index
    from repro_torch.routing import ContinuousEngineBackend
    t0 = time.perf_counter()
    mla_smoke_check(card)
    data = SyntheticSquad(n_paragraphs=600, n_questions=1000, seed=0)
    index = BM25Index.build([p.text for p in data.paragraphs])
    qs = data.questions[-16:]
    attention = {"flash_decode": flash_decode,
                 "paged_flash_decode": paged_flash_decode,
                 "flash_attention": flash_attention}
    counters = {**attention, "grouped_gemm": grouped_gemm}
    launches = {}
    for arch, layers, modes in MLA_MODELS:
        _free_gpu_memory(f"{arch} dense")
        cfg, model, params = _build_family(arch, layers, card, "mla serve")
        tokens = {}
        for absorb in modes:
            label = f"{arch} dense {'absorbed' if absorb else 'naive'}"
            backend = ContinuousEngineBackend.create(
                model, params, HashTokenizer(cfg.vocab_size), index,
                num_slots=NUM_SLOTS, prefill_batch=PREFILL_BATCH,
                max_prompt_len=MAX_PROMPT_LEN, max_new_tokens=MAX_NEW_TOKENS,
                mla_absorb=absorb)
            dense = _drive(label, backend, index, qs, 2, card, 0,
                           counters, policy)
            if dense["steps"] == 0 or any(dense["launches"][k]
                                          for k in attention):
                raise AssertionError(f"[{label}] kernels launched "
                                     f"{dense['launches']} over "
                                     f"{dense['steps']} decode steps: MLA "
                                     f"takes none")
            launches[arch] = {"grouped_gemm": _check_moe_launches(
                label, dense["launches"], backend.engine.stats, cfg)}
            ex = backend.engine.executor
            groups = []
            tokens[absorb] = _check_repeat(label, dense, qs, groups)
            _say_step_and_prefill(label, dense["rec"], ex, cfg, params, card,
                                  groups)
            del groups
            _check_no_sync(ex, "decode chunk")
            del dense, backend, ex
            gc.collect()
        # before the witness converts the weights to float32
        mla_tp_decode(cfg, model, params, card)
        if len(tokens) == 2:
            naive, absorbed = tokens[False], tokens[True]
            common = [k for k in naive if k in absorbed]
            agree = sum(a == b for k in common
                        for a, b in zip(naive[k], absorbed[k]))
            total = sum(min(len(naive[k]), len(absorbed[k]))
                        for k in common)
            say(f"   naive vs absorbed [{arch}]: {agree} of {total} greedy "
                f"tokens agree over {len(common)} common prompts (bf16 "
                f"weights; the absorbed attention runs in float32)")
            mla_absorb_witness(card, cfg, params)
        if cfg.mtp_depth:
            _mtp_loss_check(cfg, params, card, attention)
        del model, params
    say(f"== mla serve: {time.perf_counter() - t0:.1f} s")
    return launches


def _modality_inputs(cfg, B: int, S_txt: int, dev, dtype=None) -> dict:
    """Seeded prefill inputs of a vision or audio config: ``B`` x
    ``S_txt`` text tokens and the stub frontend's embeddings (numpy's
    generator, so the host and the card get the same values), image
    (B, n_modality_tokens, modality_embed_dim) or frames (B,
    encoder_seq_len, d_model) at 0.02, in ``dtype`` (float32 when
    None)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    inputs = {"tokens": torch.from_numpy(rng.integers(
        4, cfg.vocab_size, size=(B, S_txt)).astype(np.int32))}
    if cfg.modality == "vision":
        shape = (B, cfg.n_modality_tokens, cfg.modality_embed_dim)
        name = "image_emb"
    else:
        shape = (B, cfg.encoder_seq_len, cfg.d_model)
        name = "audio_emb"
    inputs[name] = torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * 0.02)
    out = {k: v.to(dev) for k, v in inputs.items()}
    if dtype is not None:
        out[name] = out[name].to(dtype)
    return out


def modality_smoke_check(card: str) -> None:
    """phi-3-vision and whisper SMOKE in float32 on the card against the
    host, on the same weights and inputs: ``forward_train`` logits with
    the image / frames, then a prefill with them and 4 greedy decode
    steps (the card fed the host's tokens), each within
    MODALITY_F32_RTOL of max |logit|.  K1 takes bf16 only, so both sides
    decode through its plain version here; the served phases hold K1
    itself."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import flash_decode_torch
    from repro_torch.models import build_model
    from repro_torch.models import layers as model_layers
    from repro_torch.models.schema import tree_map
    worst = {}
    for arch, kw in ((PHI3, {}), (PHI3, {"head_dim": 96}), (WHISPER, {})):
        cfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32",
                                  **kw)
        model = build_model(cfg)
        host = model.init(seed=0, device="cpu")
        on_card = tree_map(lambda t: t.cuda(), host)
        hi, ci = (_modality_inputs(cfg, 3, 12, d) for d in ("cpu", "cuda"))
        extra = cfg.n_modality_tokens if cfg.modality == "vision" else 0
        with mock.patch.object(model_layers, "flash_decode",
                               flash_decode_torch):
            want = model.train_logits(host, hi)[0]
            got = model.train_logits(on_card, ci)[0].cpu()
            name = f"{cfg.name} D={cfg.head_dim}"
            worst[f"{name} train"] = ((want - got).abs().max()
                                      / want.abs().max()).item()
            runs = {}
            for dev, params, inputs in (("cpu", host, hi),
                                        ("cuda", on_card, ci)):
                cache = model.init_cache(3, 12 + extra + 4, device=dev)
                lg, cache = model.prefill(params, inputs, cache)
                # the card is fed the host's greedy tokens
                feed = (None if dev == "cpu"
                        else [t.cuda() for t in runs["cpu"][1]])
                runs[dev] = _greedy_steps(model, params, lg[:, -1].float(),
                                          cache, 4, feed)
            worst[f"{name} prefill + decode"] = max(
                ((a - b.cpu()).abs().max() / a.abs().max()).item()
                for a, b in zip(runs["cpu"][0], runs["cuda"][0]))
    say(f"== modality smoke: float32, card vs host, max |dlogit| / max "
        f"|logit|: {', '.join(f'{k} {v:.3e}' for k, v in worst.items())} "
        f"(tol {MODALITY_F32_RTOL:g}) [{card}]")
    bad = {k: v for k, v in worst.items() if not v <= MODALITY_F32_RTOL}
    if bad:
        raise AssertionError(f"[modality smoke] the card disagrees with the "
                             f"host: {bad}")


def _modality_prefill_case(card: str, cfg, model, params, counters) -> None:
    """One prefill of MODALITY_BATCH rows of IMAGE_TEXT_TOKENS text tokens
    with the stub frontend's seeded embeddings (phi-3: the image's 576
    positions before the text; whisper: 1500 frames through the encoder,
    whose keys and values fill every decoder layer's cross cache), then
    MODALITY_STEPS greedy decode steps from that cache (whisper's read
    the cross cache, with no frames), each launch count 0 just before.
    Checks K1 launched layers x steps and K2 never, the cache's
    positions, every logit finite, whisper's cross cache written; prints
    the prefill beside its operations bound, the decode step, peak
    memory, and each step's gap to the same run with K1 swapped for its
    plain version, fed the same tokens (the prefill's within
    TOKEN_GAP_RTOL)."""
    import torch
    from repro_torch.kernels.flash_decode import flash_decode_torch
    from repro_torch.models import layers as model_layers
    from repro_torch.models.schema import tree_leaves
    B, S_txt, n = MODALITY_BATCH, IMAGE_TEXT_TOKENS, MODALITY_STEPS
    inputs = _modality_inputs(cfg, B, S_txt, "cuda", torch.bfloat16)
    vision = cfg.modality == "vision"
    S = S_txt + (cfg.n_modality_tokens if vision else 0)
    L = _kernel_layers(cfg)
    d = cfg.d_model

    def run(feed):
        cache = model.init_cache(B, S + n, device="cuda")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with torch.no_grad():
            ev[0].record()
            logits, cache = model.prefill(params, inputs, cache)
            ev[1].record()
            steps, tokens, cache = _greedy_steps(
                model, params, logits[:, -1].float(), cache, n, feed)
            ev[2].record()
        torch.cuda.synchronize()
        return steps, tokens, cache, ev

    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    steps, tokens, cache, ev = run(None)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    with mock.patch.object(model_layers, "flash_decode", flash_decode_torch):
        plain, _, _, _ = run(tokens)
    prefill_ms, step_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(
        ev[2]) / n
    ops = _prefill_flops(cfg, B, S)
    if vision:
        what = (f"{B} x ({cfg.n_modality_tokens} image + {S_txt} text) = "
                f"{B} x {S} positions")
        ops += 2 * B * cfg.n_modality_tokens * (cfg.modality_embed_dim * d
                                                + d * d)
    else:
        T = cfg.encoder_seq_len
        enc_layer = (2 * d * cfg.head_dim * (2 * cfg.n_heads
                                             + 2 * cfg.n_kv_heads)
                     + 2 * 3 * d * cfg.d_ff)
        ops += (cfg.n_encoder_layers * (B * T * enc_layer
                                        + 4 * B * cfg.n_heads
                                        * cfg.head_dim * T * T)
                + cfg.n_layers * 2 * B * T * d * cfg.head_dim * 2
                * cfg.n_kv_heads)
        what = f"{B} x {T} frames through the encoder, {B} x {S} text tokens"
    bound_ms = ops / BF16_OPS_PER_S * 1e3
    step_bound = (_served_weight_bytes(params) + _cross_cache_bytes(cfg, B)
                  ) / HBM_BYTES_PER_S * 1e3
    finite = all(bool(torch.isfinite(x).all()) for x in steps)
    pos = cache["pos"].tolist()
    say(f"   {cfg.modality} prefill [{cfg.name}]: {what}, "
        f"{prefill_ms:.2f} ms (CUDA events) beside its bound "
        f"{bound_ms:.2f} ms ({ops / 1e12:.2f} TFLOP / 989 TFLOP/s) = "
        f"{prefill_ms / bound_ms:.2f} x; then {n} greedy steps at "
        f"{step_ms:.2f} ms a step beside {step_bound:.2f} ms; positions "
        f"{pos}; peak memory {peak:.2f} GiB; launches {launches} [{card}]")
    # the same run with K1 swapped for its plain version, fed the same
    # tokens: the prefill (no K1) must agree; each decode step's gap is
    # K1's bf16 rounding against the plain version's, carried through
    # every layer of random weights, printed and not held
    _long_gaps(f"{cfg.name} {cfg.modality} prefill", steps, plain, 1,
               TOKEN_GAP_RTOL, case="K1 witness", names=("K1", "plain"))
    if pos != [S + n] * B or not finite:
        raise AssertionError(f"[{cfg.name} {cfg.modality} prefill] "
                             f"positions {pos}, finite {finite}")
    if (launches["flash_decode"] != L * n
            or launches["paged_flash_decode"]):
        raise AssertionError(f"[{cfg.name} {cfg.modality} prefill] "
                             f"launches {launches} for {n} steps of {L} "
                             f"layers")
    if not vision:
        cross = [t for t in tree_leaves(cache["blocks"]) if t.dim() == 5
                 and t.shape[2] == cfg.encoder_seq_len]
        if len(cross) != 2 or not all(bool(c.abs().sum() > 0)
                                      for c in cross):
            raise AssertionError(f"[{cfg.name} audio prefill] the cross "
                                 f"cache was not written")
    del cache, steps, plain


def modality_serve_phase(card: str, policy) -> dict:
    """The vision and audio families at their published widths, not cut,
    seeded bf16 weights, each after the previous model is freed; first
    :func:`modality_smoke_check`.  ``phi-3-vision-4.2b`` FULL (head_dim
    96) through ``Gateway.serve`` as the MoE / GQA phase serves its
    models (:func:`_serve_family`: the dense engine, K1, and the paged
    one, K2, 8 + 8 requests) and on the paged int8 engine (8 requests);
    prompts are text only, as a served request is.  Then its image
    prefill and decode (:func:`_modality_prefill_case`).
    ``whisper-large-v3`` FULL on the dense engine only (8 + 8 requests;
    the reference's executor passes no frames, so a served request
    attends over the zero cross cache, as there): K1 exactly 32 decoder
    layers x decode steps, K2 never; the paged pool's refusal shown; the
    tokens repeating bit for bit, a decode chunk with no host sync; then
    its audio prefill and decode.  Returns the launches of K1 and K2 by
    model, for the kernel table's phi-3 and whisper rows."""
    import torch
    from repro_torch.data import HashTokenizer, SyntheticSquad
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.models import build_model
    from repro_torch.retrieval import BM25Index
    from repro_torch.routing import ContinuousEngineBackend
    t0 = time.perf_counter()
    modality_smoke_check(card)
    data = SyntheticSquad(n_paragraphs=600, n_questions=1000, seed=0)
    index = BM25Index.build([p.text for p in data.paragraphs])
    qs = data.questions[-16:]
    counters = {"flash_decode": flash_decode,
                "paged_flash_decode": paged_flash_decode}
    out = {}

    # -- phi-3-vision: dense (K1), paged (K2), paged int8 (K2) -----------
    _free_gpu_memory(f"{PHI3} dense")
    model, params, out[PHI3] = _serve_family(PHI3, None, card, policy, data,
                                             index, phase="vision serve")
    cfg = model.cfg
    L = _kernel_layers(cfg)
    _free_gpu_memory(f"{PHI3} paged int8")
    label = f"{PHI3} paged int8"
    backend = ContinuousEngineBackend.create(
        build_model(dataclasses.replace(cfg, kv_quant_int8=True)), params,
        HashTokenizer(cfg.vocab_size), index, num_slots=NUM_SLOTS,
        prefill_batch=PREFILL_BATCH, max_prompt_len=MAX_PROMPT_LEN,
        max_new_tokens=MAX_NEW_TOKENS, paged=True, page_size=PAGE_SIZE,
        num_pages=NUM_PAGES)
    int8 = _drive(label, backend, index, qs, 1, card, L, counters, policy)
    _check_paged_launches(label, int8["launches"], int8["steps"], L,
                          int8["rec"]["short_prefills"])
    del int8, backend
    _free_gpu_memory(f"{PHI3} image prefill")
    _modality_prefill_case(card, cfg, model, params, counters)
    del model, params

    # -- whisper: the dense engine (K1); the paged pool refuses ----------
    _free_gpu_memory(f"{WHISPER} dense")
    cfg, model, params = _build_family(WHISPER, None, card, "audio serve")
    say(f"   encoder: {cfg.n_encoder_layers} layers over "
        f"{cfg.encoder_seq_len} frames (non-causal, the plain attention as "
        f"the reference routes it); decoder: {cfg.n_layers} layers with "
        f"cross-attention")
    L = _kernel_layers(cfg)

    def backend_for(**kw):
        return ContinuousEngineBackend.create(
            model, params, HashTokenizer(cfg.vocab_size), index,
            num_slots=NUM_SLOTS, prefill_batch=PREFILL_BATCH,
            max_prompt_len=MAX_PROMPT_LEN, max_new_tokens=MAX_NEW_TOKENS,
            **kw)
    label = f"{WHISPER} dense"
    backend = backend_for()
    dense = _drive(label, backend, index, qs, 2, card, L, counters, policy)
    _check_launches(label, dense["launches"], "flash_decode",
                    dense["steps"], L, absent=("paged_flash_decode",))
    ex = backend.engine.executor
    _say_step_and_prefill(label, dense["rec"], ex, cfg, params, card)
    _check_repeat(label, dense, qs)
    _check_no_sync(ex, "decode chunk")
    out[WHISPER] = dense["launches"]
    tokens = dense["rec"]["tokens"]
    del dense, backend, ex
    # phase 16w's serving part, where the weights live
    _free_gpu_memory(f"{WHISPER} tp")
    whisper_tp_serve(card, model, params, index, qs, tokens, counters, policy)
    _free_gpu_memory(f"{WHISPER} paged")
    try:
        backend_for(paged=True, page_size=PAGE_SIZE, num_pages=NUM_PAGES)
    except ValueError as e:
        say(f"   paged [{WHISPER}]: refused, as in the reference: {e}")
    else:
        raise AssertionError(f"[{WHISPER} paged] the paged pool took "
                             f"cross-attention layers")
    _free_gpu_memory(f"{WHISPER} audio prefill")
    _modality_prefill_case(card, cfg, model, params, counters)
    del model, params
    say(f"== modality serve: {time.perf_counter() - t0:.1f} s")
    return out


def _prefill_rows(model, params, prompts, max_len: int) -> tuple:
    """Each prompt prefilled alone into a one-row cache and its rows
    copied into slot i of a cache of len(prompts) slots, as the
    executor commits an admission.  Returns (the prefill logits (B, V)
    float32, the cache)."""
    import torch
    from repro_torch.models.schema import tree_leaves
    cache = model.init_cache(len(prompts), max_len, device="cuda")
    firsts = []
    for i, p in enumerate(prompts):
        one = model.init_cache(1, max_len, device="cuda")
        toks = torch.as_tensor(p, dtype=torch.int64,
                               device=cache["pos"].device)[None]
        logits, one = model.prefill(params, {"tokens": toks}, one)
        firsts.append(logits[:, -1].float())
        cache["pos"][i] = one["pos"][0]
        for key, lead in (("prefix", 0), ("blocks", 1)):
            for big, small in zip(tree_leaves(cache[key]),
                                  tree_leaves(one[key])):
                big.select(lead, i).copy_(small.select(lead, 0))
        del one
    return torch.cat(firsts), cache


def _long_run(card, label, model, params, prompts, feed) -> tuple:
    """One cache of the long case: prefill ``prompts`` into their slots,
    then ``LONG_STEPS`` ``_greedy_steps``.  Returns (the logits of every
    step, float32 (B, V) each, the tokens fed, K1's launches)."""
    import torch
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models.schema import tree_leaves
    cfg = model.cfg
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = _prefill_rows(model, params, prompts, LONG_MAX_LEN)
        flash_decode.launches = 0
        steps, tokens, cache = _greedy_steps(model, params, logits, cache,
                                             LONG_STEPS, feed)
    torch.cuda.synchronize()
    launches = flash_decode.launches
    gib = sum(t.numel() * t.element_size()
              for t in tree_leaves(cache)) / 2**30
    local = (min(LONG_MAX_LEN, cfg.sliding_window) if cfg.window_ring_cache
             else LONG_MAX_LEN)
    say(f"   long case [{label}]: cache {gib:.3f} GiB ({LONG_MAX_LEN} rows "
        f"a global layer, {local} a local one), K1 launched {launches} "
        f"times for {LONG_STEPS} steps, positions to "
        f"{int(cache['pos'].max())}, {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    del cache
    torch.cuda.empty_cache()
    return steps, tokens, launches


def _long_gaps(label, full, ring, held: int, rtol: float,
               case: str = "long case", names=("full", "ring")) -> None:
    """Prints each step's max |logit a - b| (``names``: the two runs)
    and the greedy tokens the two agree on; the first ``held`` steps
    must agree within ``rtol`` of max |logit|."""
    a, b = names
    for i, (f, r) in enumerate(zip(full, ring)):
        gap = (f - r).abs().max().item()
        scale = f.abs().max().item()
        agree = int((f.argmax(-1) == r.argmax(-1)).sum())
        say(f"   {case} [{label}] step {i} "
            f"({'prefill' if i == 0 else 'decode'}): max |logit {a} - "
            f"{b}| {gap:.4e} of max |logit| {scale:.4e} ({gap / scale:.2e})"
            f"; greedy tokens agree in {agree} of {f.shape[0]}")
        if i < held and not gap <= rtol * scale:
            raise AssertionError(f"[{case} {label}] step {i}: {a} and {b} "
                                 f"logits differ by {gap} > {rtol} x "
                                 f"{scale}")


def _to_float32(tree) -> None:
    """Every tensor of a nested dict / list to float32, in place, one
    leaf at a time (the bf16 leaf is freed as its copy is made)."""
    import torch
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if isinstance(v, torch.Tensor):
            tree[k] = v.float()
        else:
            _to_float32(v)


def gemma3_long_case(card: str, model, params) -> None:
    """Where the window binds: 8 seeded prompts of 1280-1536 tokens,
    max_len 2048, 8 greedy decode steps, driven through the model's
    ``prefill`` / ``decode`` with the full-length cache and with the
    ring cache (W = 1024), both fed the full cache's greedy tokens.
    Prints, for each step, max |logit difference| and the greedy tokens
    the two agree on, and both caches' GiB; K1 runs the 8 global layers
    over 2048-row slots (4 runs of 512 rows, merged in the launch).  In
    bf16 the prefill's logits must agree within ``RING_LOGIT_RTOL`` of
    max |logit|; the decode steps' are printed.  Then the witness: the
    same weights in float32 (the bf16 params converted in place), K1
    swapped for its plain version (the kernel takes bf16), every step
    within ``RING_F32_RTOL``."""
    import numpy as np
    from repro_torch.models import build_model
    from repro_torch.models import layers as model_layers
    from repro_torch.kernels.flash_decode import flash_decode_torch
    cfg = model.cfg
    rng = np.random.default_rng(0)
    lens = rng.integers(LONG_MIN, LONG_MAX + 1, size=NUM_SLOTS)
    lens[0], lens[1] = LONG_MIN, LONG_MAX
    prompts = [rng.integers(4, cfg.vocab_size, size=int(n)) for n in lens]
    k_layers = _kernel_layers(cfg)
    say(f"   long case: prompts {sorted(int(n) for n in lens)} past the "
        f"window {cfg.sliding_window}; the ring holds "
        f"{min(LONG_MAX_LEN, cfg.sliding_window)} rows in each of the "
        f"{cfg.n_layers - k_layers} local layers against {LONG_MAX_LEN}")
    runs, feed = {}, None
    for name, ring in (("full", False), ("ring", True)):
        m = build_model(dataclasses.replace(cfg, window_ring_cache=ring))
        runs[name], feed, launches = _long_run(card, f"bf16, {name} cache",
                                               m, params, prompts, feed)
        _check_launches(f"long case, {name} cache",
                        {"flash_decode": launches}, "flash_decode",
                        LONG_STEPS, k_layers)
    _long_gaps("bf16", runs["full"], runs["ring"], 1, RING_LOGIT_RTOL)
    _to_float32(params)
    f32 = {}
    with mock.patch.object(model_layers, "flash_decode", flash_decode_torch):
        for name, ring in (("full", False), ("ring", True)):
            m = build_model(dataclasses.replace(
                cfg, dtype="float32", window_ring_cache=ring))
            f32[name], _, _ = _long_run(card, f"float32 witness, {name} "
                                        f"cache, plain K1", m, params,
                                        prompts, feed)
    _long_gaps("float32", f32["full"], f32["ring"], LONG_STEPS + 1,
               RING_F32_RTOL)


def cli_phase(card: str) -> None:
    """``python -m repro_torch.launch.train`` on the card, twice at once
    in two subprocesses: qwen SMOKE (``--arch qwen1.5-32b``) and the
    defaults (``mamba2-130m`` SMOKE), 20 steps each.  Each final loss must
    be finite and below its first, and each checkpoint must load back
    through ``load_checkpoint`` with every leaf equal to the saved
    arrays."""
    import os
    import re
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.schema import zeros_from_schema
    from repro_torch.training import adamw_init_schema
    from repro_torch.training.checkpoint import _paths, load_checkpoint
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for arch, flags in (("qwen1.5-32b", ["--arch", "qwen1.5-32b",
                                             "--variant", "smoke"]),
                            (MAMBA, [])):
            ckpt = str(Path(tmp) / arch)
            cmd = [sys.executable, "-m", "repro_torch.launch.train", *flags,
                   "--steps", "20", "--ckpt", ckpt]
            runs.append((arch, ckpt, cmd, time.perf_counter(),
                         subprocess.Popen(cmd, cwd=ROOT, env=env,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True)))
        for arch, ckpt, cmd, t0, proc in runs:
            out, err = proc.communicate(timeout=600)
            say(f"== cli: {' '.join(cmd[1:-1])} <tmpdir>: exit "
                f"{proc.returncode} in {time.perf_counter() - t0:.1f} s "
                f"(both runs at once)")
            for line in out.splitlines():
                say(f"   | {line}")
            if proc.returncode != 0:
                raise AssertionError(f"[cli {arch}] exit {proc.returncode}: "
                                     f"{err}")
            got = re.search(r"final loss (\S+) \(start (\S+)\)", out)
            final, start = float(got.group(1)), float(got.group(2))
            if not (math.isfinite(final) and final < start):
                raise AssertionError(f"[cli {arch}] final loss {final}, "
                                     f"start {start}")
            model = build_model(get_config(arch, "smoke"))
            step, params, opt = load_checkpoint(
                ckpt, model.init(seed=1, device="cuda"),
                zeros_from_schema(adamw_init_schema(model.schema),
                                  device="cuda"))
            n = 0
            for name, tree in (("params", params), ("opt", opt)):
                with np.load(Path(ckpt) / f"{name}_{step}.npz") as z:
                    for key, leaf in _paths(tree):
                        if not np.array_equal(leaf.float().cpu().numpy(),
                                              z[key].astype(np.float32)):
                            raise AssertionError(
                                f"[cli {arch}] {name} leaf {key} differs "
                                f"from the checkpoint")
                        n += 1
            fresh = model.init(seed=0, device="cuda")
            if step != 20 or int(opt["step"]) != 20 or torch.equal(
                    params["embed"], fresh["embed"]):
                raise AssertionError(f"[cli {arch}] checkpoint step {step}, "
                                     f"opt step {int(opt['step'])}, or "
                                     f"untrained params")
            say(f"   {arch} checkpoint step {step}: {n} leaves loaded back "
                f"equal to the saved arrays [{card}]")


# the serving CLI at qwen1.5-32b FULL: closed loop, then open loop in
# virtual time (40 requests a virtual second, the CLI's default deadline)
SERVE_CLI_REQUESTS, SERVE_CLI_OPEN_REQUESTS = 16, 24
SERVE_CLI_RATE, SERVE_CLI_DEADLINE_MS = 40.0, 250.0
# the paper's ten benches: run.py's names and each one's artifact
PAPER_BENCHES = {"table1": "table1_slo_grid", "fig1": "fig1_action_dist",
                 "fig2": "fig2_cost_quality", "fig3": "fig3_reward",
                 "mitigation": "mitigation",
                 "objectives": "objectives_ablation", "ope": "ope",
                 "conditioned": "conditioned_policy",
                 "pareto": "pareto_sweep", "seeds": "seeds_ablation"}


def _serve_cli(label, argv, card, n_layers, counters) -> dict:
    """``repro_torch.launch.serve.main(argv)`` in this process, its
    engine instrumented as the CLI builds it (CUDA events around each
    decode chunk), every launch count 0 just before and read just after,
    the CLI's own lines printed behind ``|``.  Checks the engine
    prefilled and decoded and K1 ran once a layer per decode step."""
    import contextlib
    import io
    import torch
    from repro_torch.launch import serve
    rec = {}
    build = serve._continuous_backend

    def instrumented(*a, **kw):
        backend = build(*a, **kw)
        rec.update(_instrument(backend.engine))
        return backend
    out = io.StringIO()
    serve._continuous_backend = instrumented
    torch.cuda.synchronize()
    _zero(counters)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            run = serve.main(argv)
        torch.cuda.synchronize()
    finally:
        serve._continuous_backend = build
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    lines = out.getvalue().splitlines()
    if len(lines) > 40:
        lines = lines[:20] + [f"... ({len(lines) - 40} lines)"] + lines[-20:]
    for line in lines:
        say(f"   | {line}")
    es = run["gateway"].engine_stats
    steps, secs = es.n_decode_steps, run["seconds"]
    step_ms = _step_ms(rec["chunks"], steps)
    say(f"   [{label}] wall {wall:.1f} s: FULL testbed build "
        f"{secs['build_testbed']:.2f} s (host), router training "
        f"{secs['train_router']:.3f} s, engine with seeded FULL weights "
        f"{secs['build_backend']:.2f} s, serve {secs['serve']:.2f} s")
    say(f"   [{label}] prefills {es.n_prefills}, decode chunks "
        f"{es.n_decode_chunks} ({steps} steps), max concurrent "
        f"{es.max_concurrent}, decode step {step_ms:.2f} ms (device time of "
        f"the chunks), launches {launches} for {n_layers} layers [{card}]")
    if not (es.n_prefills and es.n_decode_chunks):
        raise AssertionError(f"[{label}] {es.n_prefills} prefills, "
                             f"{es.n_decode_chunks} decode chunks")
    _check_launches(label, launches, "flash_decode", steps, n_layers,
                    absent=("paged_flash_decode",))
    return {"run": run, "launches": launches}


def serve_cli_phase(card: str, before_open=None) -> int:
    """``python -m repro_torch.launch.serve --backend continuous --variant
    full`` in this process, twice, each building the FULL testbed, its
    router and its own qwen1.5-32b FULL engine as the CLI does: the
    closed loop (paper5, quality_first, with the trace and metrics files)
    and the open loop on the virtual clock.  Checks: every request served
    (closed) or resolved (open), the reward finite, prefills and decode
    chunks, K1 64 times a decode step, the telemetry files non-empty.
    ``before_open()``, where given, runs between the two (``main`` starts
    the paper benches there: the open loop's results are on the virtual
    clock, so they do not depend on what shares the host and the card).
    Returns the closed loop's K1 launches."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    counters = {"flash_decode": flash_decode,
                "paged_flash_decode": paged_flash_decode}
    L = get_config("qwen1.5-32b", "full").n_layers
    base = ["--backend", "continuous", "--variant", "full",
            "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        trace, prom = Path(tmp) / "trace.json", Path(tmp) / "metrics.prom"
        n = SERVE_CLI_REQUESTS
        say(f"== serve cli: repro_torch.launch.serve {' '.join(base)} -n {n} "
            f"--trace-out <tmp> --metrics-out <tmp> (closed loop, paper5, "
            f"quality_first) [{card}]")
        closed = _serve_cli("serve cli closed", base + [
            "-n", str(n), "--trace-out", str(trace),
            "--metrics-out", str(prom)], card, L, counters)
        stats = closed["run"]["stats"]
        sizes = {p.name: p.stat().st_size if p.exists() else 0
                 for p in (trace, prom)}
        say(f"   closed loop: served {stats.served}, avg_reward "
            f"{stats.avg_reward:+.4f}, actions "
            f"{dict(sorted(stats.action_counts.items()))}, telemetry bytes "
            f"{sizes}")
        if stats.served != n or not math.isfinite(stats.avg_reward):
            raise AssertionError(f"[serve cli closed] served {stats.served} "
                                 f"of {n}, avg_reward {stats.avg_reward}")
        if not all(sizes.values()):
            raise AssertionError(f"[serve cli closed] telemetry files "
                                 f"{sizes}")
    k1 = closed["launches"]["flash_decode"]
    del closed, stats
    _free_gpu_memory("serve cli, open loop")
    if before_open is not None:
        before_open()
    n = SERVE_CLI_OPEN_REQUESTS
    flags = ["-n", str(n), "--open-loop", str(SERVE_CLI_RATE),
             "--deadline-ms", str(SERVE_CLI_DEADLINE_MS)]
    say(f"== serve cli: repro_torch.launch.serve {' '.join(base + flags)} "
        f"(virtual time) [{card}]")
    opened = _serve_cli("serve cli open", base + flags, card, L, counters)
    rep, st = opened["run"]["report"], opened["run"]["gateway"].stats
    say(f"   open loop: offered {rep.offered}, resolved {rep.completed}, "
        f"answered {rep.answered}, refused {rep.refused}, shed {rep.shed}, "
        f"goodput fraction {rep.goodput_fraction:.4f}, avg_reward "
        f"{st.avg_reward:+.4f} (virtual clock)")
    if rep.offered != n or rep.completed != n \
            or not math.isfinite(st.avg_reward):
        raise AssertionError(f"[serve cli open] {rep.completed} of "
                             f"{rep.offered} resolved, avg_reward "
                             f"{st.avg_reward}")
    del opened, rep, st
    _free_gpu_memory("serve cli done")
    return k1


def _finite_numbers(obj, where: str) -> int:
    """The count of numbers in a JSON value; raises on one not finite."""
    if obj is None or isinstance(obj, (bool, str)):
        return 0
    if isinstance(obj, (int, float)):
        if not math.isfinite(obj):
            raise AssertionError(f"[paper benches] {where} = {obj}")
        return 1
    items = obj.items() if isinstance(obj, dict) else enumerate(obj)
    return sum(_finite_numbers(v, f"{where}/{k}") for k, v in items)


def _say_paper_headlines(art: dict, derived: dict) -> None:
    for r in art["table1"]:
        say(f"   table1 {r['slo']:>13s} {r['method']:>16s} acc "
            f"{r['acc']:.3f} cost {r['cost']:7.1f} reward {r['reward']:+.4f} "
            f"refuse {r['refuse']:.3f}")
    say(f"   fig1: cheap/argmax_ce refuse share "
        f"{derived['fig1']['cheap_ce_refuse_share']:.3f}, "
        f"quality_first/argmax_ce a0 share "
        f"{derived['fig1']['quality_ce_a0_share']:.3f}")
    m = art["mitigation"]
    for key in ("cheap_argmax_ce", "cheap_constrained"):
        say(f"   mitigation {key:16s} " + ", ".join(
            f"{k} {v:+.4f}" for k, v in m[key].items()))
    say(f"   mitigation: final lambda {m['lagrange_final']}, "
        f"{derived['mitigation']}")
    for r in art["objectives"]:
        say(f"   objectives {r['space']:>7s} {r['slo']:>13s} "
            f"{r['method']:>16s} acc {r['acc']:.3f} cost {r['cost']:7.1f} "
            f"reward {r['reward']:+.4f} refuse {r['refuse']:.3f}")
    for k, v in art["seeds"].items():
        say(f"   seeds {k:18s} {v['mean']:+.4f} +- {v['std']:.4f} "
            f"{v['values']}")


def start_paper_benches() -> dict:
    """``python -m repro_torch.benchmarks.run`` with the paper's ten
    benches on the card, started in a subprocess (its output to
    temporary files); :func:`paper_bench_phase` waits for it."""
    import os
    import tempfile
    cmd = [sys.executable, "-m", "repro_torch.benchmarks.run",
           *PAPER_BENCHES, "--device", "cuda"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    # repro: allow[RPL001] compared with the artifacts' file times (each artifact written by this run), which are wall time
    return {"cmd": cmd, "out": out, "err": err, "started": time.time(),
            "t0": time.perf_counter(),
            "proc": subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                     stderr=err, text=True)}


def stop_paper_benches(run: dict) -> None:
    if run and run["proc"].poll() is None:
        run["proc"].kill()
        run["proc"].wait()


def paper_bench_phase(card: str, beside, run: dict = None) -> None:
    """The paper's ten benches (:func:`start_paper_benches`, started
    here unless ``run`` was started earlier) waited for after
    ``beside()`` runs.  Checks: exit 0, the ten CSV rows, each artifact
    written by this run, every number in the artifacts and the derived
    values finite; prints the paper's headline numbers and how long the
    phase waited for the benches beyond ``beside()``."""
    art_dir = ROOT / "src" / "repro_torch" / "benchmarks" / "artifacts"
    run = run or start_paper_benches()
    proc, cmd, started = run["proc"], run["cmd"], run["started"]
    early = time.perf_counter() - run["t0"]
    try:
        beside()
        t1 = time.perf_counter()
        rc = proc.wait(timeout=900)
    finally:
        stop_paper_benches(run)
    waited = time.perf_counter() - t1
    wall = time.perf_counter() - run["t0"]
    WON_BACK["the paper benches"] = early
    with run["out"] as out, run["err"] as err:
        out.seek(0)
        err.seek(0)
        text, errors = out.read(), err.read()
    say(f"== paper benches: {' '.join(cmd[1:])}: exit {rc} in {wall:.1f} s, "
        f"started {early:.1f} s before the cli phase (beside the serve "
        f"cli's open loop), waited for {waited:.1f} s after it [{card}]")
    if rc != 0:
        raise AssertionError(f"[paper benches] exit {rc}: {errors[-4000:]}")
    lines = text.splitlines()
    csv = lines[lines.index("name,us_per_call,derived") + 1:]
    derived, secs = {}, {}
    for line in csv:
        name, us, rest = line.split(",", 2)
        derived[name], secs[name] = json.loads(rest), int(us) / 1e6
    if list(derived) != list(PAPER_BENCHES):
        raise AssertionError(f"[paper benches] CSV rows {list(derived)}")
    art, n = {}, _finite_numbers(derived, "derived")
    for name, stem in PAPER_BENCHES.items():
        p = art_dir / f"{stem}.json"
        if not p.exists() or p.stat().st_mtime < started:
            raise AssertionError(f"[paper benches] {p} not written by "
                                 f"this run")
        art[name] = json.loads(p.read_text())
        n += _finite_numbers(art[name], stem)
    say(f"   seconds per bench (the first pays the canonical testbed, "
        f"objectives the hybrid9 testbed): "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    say(f"   {n} numbers in the artifacts and derived values, all finite")
    _say_paper_headlines(art, derived)


K3_PROFILE_SHAPES = (("main path", SQUAD_PARAGRAPHS, TOP_K),
                     ("main path, k = 64", SQUAD_PARAGRAPHS, 64),
                     ("1M docs", BIG_DOCS, TOP_K))
K3_PROFILE_PHASES = ("products start", "copy issue", "copy wait", "barrier",
                     "split", "products wait", "accumulate", "selection",
                     "query fragments", "proxy fence", "barrier")
K3_PROFILE_STAMPS = ("start", "first stage", "stream end", "grid barrier",
                     "merged")


def _k3_sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"dense_topk_profile: the source no longer has "
                         f"one {old[:60]!r}; update _k3_probes/_k3_variants")
    return text.replace(old, new)


def _k3_probes(src: str) -> str:
    """The source with per-phase cycle counters and per-block stamps,
    written to two device arrays read back by ``read_probes``."""
    src = _k3_sub(src, "namespace {\n\nconstexpr int kWG", """\
__device__ long long g_cyc[8192][12];
__device__ unsigned long long g_ns[8192][5];
extern "C" int read_k3_probes(void* cyc, void* ns, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(cyc, g_cyc, (size_t)n * 96);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ns, g_ns, (size_t)n * 40);
  return (int)e;
}
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
namespace {

constexpr int kWG""")
    blk = "blockIdx.y * gridDim.x + blockIdx.x"
    src = _k3_sub(src, "  const auto doc0 = ", f"""\
  unsigned long long* const NS = g_ns[{blk}];
  if (tid == 0) {{ NS[0] = now_ns(); NS[1] = NS[2] = NS[3] = NS[4] = 0; }}
  long long P[11] = {{0}}, c0 = 0, c1 = 0;
#define TICK(i) do {{ c1 = clock64(); P[i] += c1 - c0; c0 = c1; }} while (0)
  const auto doc0 = """)
    src = _k3_sub(src, "  if (steps > 0) {\n    split_stage(0);",
                  "  if (tid == 0) NS[1] = now_ns();\n"
                  "  if (steps > 0) {\n    split_stage(0);")
    src = _k3_sub(src, "    start_products(it);\n",
                  "    c0 = clock64();\n    start_products(it);\n"
                  "    TICK(0);\n")
    src = _k3_sub(src, "    const bool more = it + 1 < steps;\n",
                  "    TICK(1);\n    const bool more = it + 1 < steps;\n")
    src = _k3_sub(src, "      cp_async_wait_dyn(p.stages - 2);\n"
                  "      wg_sync(wg);  // stage it + 1 landed, every thread's"
                  " copies\n"
                  "      split_stage(it + 1);\n",
                  "      cp_async_wait_dyn(p.stages - 2);\n      TICK(2);\n"
                  "      wg_sync(wg);\n      TICK(3);\n"
                  "      split_stage(it + 1);\n      TICK(4);\n")
    src = _k3_sub(src, "    fence_regs(alo);\n    const int chunk",
                  "    fence_regs(alo);\n    TICK(5);\n    const int chunk")
    src = _k3_sub(src, "    if (chunk == n_ec - 1) {\n",
                  "    TICK(6);\n    if (chunk == n_ec - 1) {\n")
    src = _k3_sub(src, "    if (more) {\n      load_a(it + 1);\n"
                  "      asm volatile(\"fence.proxy.async.shared::cta;"
                  "\\n\" ::: \"memory\");\n      wg_sync(wg);\n    }\n  }\n",
                  "    TICK(7);\n    if (more) {\n      load_a(it + 1);\n"
                  "      TICK(8);\n"
                  "      asm volatile(\"fence.proxy.async.shared::cta;"
                  "\\n\" ::: \"memory\");\n      TICK(9);\n"
                  "      wg_sync(wg);\n"
                  "      TICK(10);\n    }\n  }\n"
                  f"  if (tid == 0) {{\n    for (int z = 0; z < 11; ++z) "
                  f"g_cyc[{blk}][z] = P[z];\n"
                  f"    g_cyc[{blk}][11] = steps;\n  }}\n")
    src = _k3_sub(src,
                  "  cp_async_wait<0>();\n  __syncthreads();  // the rings",
                  "  cp_async_wait<0>();\n  if (tid == 0) NS[2] = now_ns();\n"
                  "  __syncthreads();  // the rings")
    src = _k3_sub(src, "  grid_barrier(p.bar, p.S * gridDim.y);\n",
                  "  grid_barrier(p.bar, p.S * gridDim.y);\n"
                  "  if (tid == 0) NS[3] = now_ns();\n")
    src = _k3_sub(src,
                  "          p.out_i[(int64_t)(q0 + j) * p.k + pos] = mi[r];"
                  "\n        }\n      }\n  }\n}",
                  "          p.out_i[(int64_t)(q0 + j) * p.k + pos] = mi[r];"
                  "\n        }\n      }\n    if (tid == 0) NS[4] = now_ns();"
                  "\n  }\n}")
    return src


def _k3_variants(src: str) -> dict:
    wg = "      wgmma_tf32(acc, "
    return {
        "no selection": _k3_sub(src, "    if (chunk == n_ec - 1) {\n",
                                "    if (chunk == n_ec - 1 && p.k < 0) {\n"),
        "no products": src.replace(wg, "      if (p.k < 0) wgmma_tf32(acc, "),
        "32-column stages": _k3_sub(src, "int cc = 64, n_wg = 2",
                                    "int cc = 32, n_wg = 2"),
        "one warpgroup, 32-column stages": _k3_sub(
            src, "    if (stages >= 3 && (cc == 32 || slots == 16)) break;",
            "    if (false) break;"),
        "probes": _k3_probes(src),
    }


def _k3_build_variants(variants: dict) -> dict:
    """One ``nvcc`` per variant, all started together, into ``_build``."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        stem = "".join(ch if ch.isalnum() else "_" for ch in name)
        cu, so = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I",
             str(build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"dense_topk_profile: {name} failed to build:"
                             f"\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        lib.dense_topk_f32.argtypes = ([ctypes.c_void_p] * 7
                                       + [ctypes.c_int] * 5
                                       + [ctypes.c_void_p])
        lib.dense_topk_f32.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _k3_call(lib, q, docs, k):
    """The wrapper's launch, through another build of the kernel."""
    import torch
    from repro_torch.kernels import dense_topk as dt
    Q, E = q.shape
    D = docs.shape[0]
    p = dt.plan(D, Q, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    out_s, out_i = dt._empty(q, k)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bar, ls, li = dt._scratch(q.device, stream, dt.scratch_sizes(p, k))
    rc = lib.dense_topk_f32(q.data_ptr(), docs.data_ptr(), ls.data_ptr(),
                            li.data_ptr(), bar.data_ptr(), out_s.data_ptr(),
                            out_i.data_ptr(), Q, D, E, k, p.slices, stream)
    if rc:
        raise RuntimeError(f"dense_topk_profile: launch failed: {rc}")
    return out_s, out_i, p


def dense_topk_profile() -> None:
    """Where K3 spends its time (not part of ``main``; run it with
    ``python3 -c "import chip_smoke as c; c.device_phase();
    c.dense_topk_profile()"``).  At the batched retrieval path's shape
    (Q=64 seeded unit queries against D=20,000 unit rows, E=256, k=10),
    the same at k=64, and at D=1,048,576 it times the kernel as built and
    variants of its source built beside it, each with one part taken out
    or changed: ``no selection`` (the tiles' scores never offered),
    ``no products`` (the wgmma products skipped, the lists fed whatever
    the accumulators hold), ``32-column stages`` (the stage width of
    k > 16 for every k), ``one warpgroup, 32-column stages`` (one
    consumer warpgroup a block; 64-column stages need two).  Then, on
    the kernel built with two probes: the cycles a stage of warpgroup 0
    spends in each phase of its loop (``clock64``, the median over
    blocks) and each block's start, first stage, end of its stream, grid
    barrier and merge (``%globaltimer``, us after the first block
    starts).  The variants that compute the same function (the last
    two) are held against the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.dense_topk import dense_topk, dense_topk_torch
    build.build_all(["dense_topk"])
    libs = _k3_build_variants(
        _k3_variants((build.CSRC / "dense_topk.cu").read_text()))
    g = torch.Generator(device="cuda").manual_seed(7)

    def unit(n):
        x = torch.randn((n, 256), generator=g, device="cuda")
        return x / x.norm(dim=1, keepdim=True)
    for label, D, k in K3_PROFILE_SHAPES:
        q, docs = unit(64), unit(D)
        iters = 100 if D < BIG_DOCS else 10
        want_s, want_i = dense_topk_torch(q, docs, k=k)
        ms = cuda_ms(lambda: dense_topk(q, docs, k=k), iters)
        line = [f"kernel {ms * 1e3:.2f}"]
        for name in ("no selection", "no products", "32-column stages",
                     "one warpgroup, 32-column stages"):
            lib = libs[name]
            if "stages" in name:
                s, i, _ = _k3_call(lib, q, docs, k)
                err = (s - want_s).abs().max().item()
                if not err <= RETRIEVAL_TOL:
                    raise AssertionError(f"[{label}] {name}: {err}")
            ms = cuda_ms(lambda: _k3_call(lib, q, docs, k), iters)
            line.append(f"{name} {ms * 1e3:.2f}")
        say(f"== dense_topk [{label}: Q=64 D={D} E=256 k={k}] us: "
            + " | ".join(line))
        _, _, p = _k3_call(libs["probes"], q, docs, k)
        torch.cuda.synchronize()
        n = p.slices * p.q_tiles
        cyc = (ctypes.c_longlong * (n * 12))()
        ns = (ctypes.c_ulonglong * (n * 5))()
        if libs["probes"].read_k3_probes(cyc, ns, n):
            raise RuntimeError("dense_topk_profile: probes not read")
        c = np.array(cyc, dtype=np.float64).reshape(n, 12)
        per = np.median(c[:, :11] / np.maximum(c[:, 11:], 1), axis=0)
        say("   cycles a stage, warpgroup 0 (median over blocks): "
            + ", ".join(f"{a} {v:.0f}"
                        for a, v in zip(K3_PROFILE_PHASES, per)))
        t = np.array(ns, dtype=np.float64).reshape(n, 5)
        t0 = t[:, 0].min()
        parts = []
        for col, name in enumerate(K3_PROFILE_STAMPS):
            v = (t[:, col][t[:, col] > 0] - t0) / 1e3
            if len(v):
                parts.append(f"{name} {np.median(v):.2f} (max {v.max():.2f},"
                             f" {len(v)} blocks)")
        say("   us after the first block starts, median: "
            + "; ".join(parts))
        del q, docs
        torch.cuda.empty_cache()


def main() -> None:
    t0 = time.perf_counter()
    card = device_phase()
    report = build_phase()
    lint_phase(card, report)
    rows = (kernel_phase(report) + paged_kernel_phase()
            + attention_kernel_phase(report))
    k6 = ssd_kernel_phase()
    retrieval_rows, launches, dist_launches = retrieval_kernel_phase()
    moe_rows = grouped_gemm_phase(report)
    rows += retrieval_rows + [k6] + moe_rows
    small_model_phase()
    router = router_phase(card)
    launches.update(main_path_phases(card, router, dist_launches))
    trained = train_phase(card)
    launches.update(eval_phase(trained, card))
    # the single-device runs the sharded phase is held against
    records = {QWEN: trained["record"]}
    del trained
    _free_gpu_memory("mamba")
    mamba = mamba_serve_phase(card, router)
    k6_launches, mamba["eval_loss"] = mamba_eval_phase(card)
    launches.update(k6_launches)
    mamba_train_phase(card)
    tp_row, tp_launches = mamba_tp_phase(card, mamba, router)
    rows.append(tp_row)
    del mamba
    # the dry run's traces (host cores only) run beside the training
    # phases on the card, and are collected in phase 16a2
    traces = start_dryrun()
    try:
        train_launches = train_families_phase(card, records)
        sharded_train_phase(card, records)
        dryrun_phase(card, traces)
    finally:
        stop_dryrun(traces)
    moe_launches = moe_gqa_serve_phase(card, router)
    gemma_launches = gemma3_serve_phase(card, router)
    moe_launches.update(mla_serve_phase(card, router))
    family_launches = modality_serve_phase(card, router)
    family_launches[GEMMA] = gemma_launches
    # K6's row at mamba2-130m's rank shard counts phase 16t's eval, K4's
    # at whisper's rank blocks phase 16w's run of the 16 ranks' route
    family_launches[MAMBA + " tp"] = tp_launches
    family_launches[WHISPER + " tp"] = WHISPER_TP["launches"]
    family_launches[WHISPER + " tp rank block"] = \
        WHISPER_TP["block_launches"]
    rows += WHISPER_TP["rows"]
    # K4's rows at a family's eval shape count that family's eval, K8's
    # its train steps
    for arch, counts in train_launches.items():
        family_launches.setdefault(arch, {}).update(counts)
    # K7's rows at an MoE family's shapes count its serve phase's
    for arch in (DBRX, "deepseek-v3-671b"):
        family_launches.setdefault(arch, {})["grouped_gemm"] = \
            moe_launches[arch]["grouped_gemm"]
    _free_gpu_memory("serve cli")
    # the paper's benches run beside the serve CLI's open loop (virtual
    # time) and the training CLI, after every timed row of the phases
    # above
    benches = {}
    try:
        serve_cli_phase(card, before_open=lambda: benches.update(
            start_paper_benches()))
        paper_bench_phase(card, beside=lambda: cli_phase(card),
                          run=benches or None)
    finally:
        stop_paper_benches(benches)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for row in rows:
        # the rows at a family's shape count that family's phase's
        # launches (gemma3: head_dim 256; phi-3: 96; whisper: 64, G = 1;
        # K4's at phi-3's and gemma3's eval shapes, their evals'; K7's at
        # dbrx's and deepseek's, their serve phases'; K8's, dbrx's train
        # steps)
        fam = max((f for f in family_launches
                   if row.get("shape", "").startswith(f)), key=len,
                  default=None)
        row["launches"] = (family_launches[fam] if fam
                           else launches)[row["name"]]
    say(f"== won back by running beside other phases: "
        f"{', '.join(f'{k} {v:.1f} s' for k, v in WON_BACK.items())}; "
        f"{sum(WON_BACK.values()):.1f} s in all [{card}]")
    say(f"== total: {time.perf_counter() - t0:.1f} s, every phase passed "
        f"[{card}]")
    # every row has the keys above, in that order; K5's adds kernel_ms
    print(json.dumps({"kernels": [{**{k: row[k] for k in keys}, **row}
                                  for row in rows]}))
    print(card)
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
