#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``byteps_tpu_torch``) on one card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --ring     # the ring phases (10-11) alone
    python3 chip_smoke.py --dcn      # train_dcn (12) alone
    python3 chip_smoke.py --hybrid   # train_hybrid (13) alone
    python3 chip_smoke.py --chaos    # train_chaos (14) alone
    python3 chip_smoke.py --zero     # the training options (8b, 9, 11,
                                     # 15) alone
    python3 chip_smoke.py --parallel # the flash kernels at train_parallel's
                                     # calls and train_parallel (16) alone
    python3 chip_smoke.py --pipeline # the flash kernels and onebit at
                                     # their calls, train_pipeline and
                                     # train_moe (17) alone
    python3 chip_smoke.py --multislice  # the flash kernels and onebit at
                                     # train_multislice's calls and
                                     # train_multislice (18) alone
    python3 chip_smoke.py --sharded_decode  # the segmented LoRA kernel's
                                     # halves and sharded_decode (19)
                                     # alone
    python3 chip_smoke.py --serve_router  # the verify chunk's flash cases,
                                     # speculative and serve_router (6b)
                                     # alone
    python3 chip_smoke.py --families  # the flash kernels at the families'
                                     # calls, families and families_tiny
                                     # (20) alone
    python3 chip_smoke.py --process_tier  # process_tier (21) and
                                     # examples (15, with launch_global)
                                     # alone

Phases, each printing one JSON line:

1. card — name and power limit (``nvidia-smi``), then the kernel build
   (one ``nvcc`` per source, all started together) and its time, the
   ptxas register and spill report, and each kernel's SASS counts
   (attention: HGMMA, HMMA, UTMALDG, LDGSTS, SYNCS; the FMA kernels:
   tensor-core, atomic, cp.async, shuffle, cluster-barrier, FFMA and
   FADD instructions); the bf16 split-path forward must show
   tensor-core instructions (HGMMA or HMMA);
2. flash_fwd — the forward kernel against its plain PyTorch version at
   the slice's prefill shapes, bf16 and f32, the training shape, head
   dim 128 (B=4, S=1024, 8 heads) and a non-causal ragged S=1000, and
   on its split path (the serving chunks: one launch, key splits merged
   in a thread-block cluster) serve's 32-row chunk at 256 and a ragged
   37 rows at 475 (bf16, f32), multitenant's 64-row chunk at 640 against
   1024 keys (bf16, f32), GQA 16/4, head dim 128, 37 rows at 4000
   against 4096 keys (32 splits, more than a cluster's 8 blocks) and 32
   rows at 5984 at head dim 128 (47 splits, a cluster of 16): error
   against a stated tolerance, the route (split or wgmma), and kernel /
   plain / ``scaled_dot_product_attention`` times from CUDA events with
   the L2 cache flushed before each launch; the split path's invariance
   (bf16 and f32 at head dim 64, bf16 GQA at 128): a 32-row chunk's o
   and lse bit-equal to the same rows inside a 64-row chunk, against 300
   keys more, as batch entry 0 of B = 4 (f32: B = 9, whose tiles fill
   the card, so one block takes each), and on a second launch; and,
   with the backward, every distinct call train_parallel's paths make
   (each path's local batch, heads and length, each ring step's offsets,
   live and dead blocks, the zigzag half-pairs masked and unmasked, the
   backward with the merge's lse cotangent), each with its route;
3. flash_decode — the decode kernel the same way, dense and int8 caches:
   generate's step (B=4, pos 160), B=8 at pos 0, 100, 700 and 1023 (the
   long case), f32, GQA 16/4, B=1 at pos 1023 (the most splits), the
   tile edges pos 31 and 32, the long case's bytes with one kv head
   (B=128: each sequence's cache rows side by side), and head dims 128
   (GQA, int8), 256 (f32, 16 query heads a kv head) and 36;
   flash_bwd — the dq and dk/dv kernels against ``flash_bwd_torch`` at
   the training shape (B=8, S=1024, 16 heads of 64, causal) in bf16 and
   f32, GQA 16/4, a ragged S=1000, an offset chunk with dead rows and
   a nonzero lse cotangent, one partial tile (B=1, S=17), head dim 128,
   head dim 128 with GQA 8/2, offsets, dead rows and an lse cotangent,
   and a non-causal ragged S=1000: each element against a tolerance of
   its own size plus a floor of a thousandth of max |grad|, the relative
   L2 error, and kernel / plain / SDPA-backward times; flash_determinism
   — two launches of the bf16 forward, dq and dk/dv on the same inputs
   bit-equal, at the training shape and head dim 128, and of decode at
   B=8, pos 1023, dense and int8; onebit — pack words bit-equal to
   the plain version at the 1,024,000-element chunk, a ragged length,
   an input seeded with -0.0, 0 and NaN, and inputs that start 4 bytes
   past an aligned address (the chunk, n = 4097 and 33), unpack-sum
   equal by bit pattern at K=1, 2, 8 and 32 and, in the grid order the
   reference takes above 32 payloads, at K=33, 40, 41, 129 and 256, at
   n = 1, 31 and 4097 and an odd word count with a zero scale (K = 1 to
   256: 33, 40, 41, 64, 72, 129, 256 in the grid order), and with NaN
   and inf scales (non-finite elements by position, finite ones
   bit-equal); topk — select, reconstruct-sum and
   the fused round trip bit-equal to their plain versions at the
   training step's shapes (the (80, 100) round trip of a full chunk
   with and without the EF residual, select and reconstruct at
   (100, 10240) and the ragged tail's
   (101, 5617) with n = 567,296, reconstruct at K = 8, both from a
   4-byte offset, and at K = 1, 2, 3 and 8 on no-winner and out-of-range
   locals, one slot hit by two and three payloads, -0.0 values, and one
   column of 600,000 rows), the round trip
   of a chunk at (8, 1000) and (1, 8000) (k = 0.001 and 128), on ties,
   zeros and NaN, on ``split_ties`` (equal maxima 16, 32 and the launch
   plan's thread stride apart and across its block boundary, ±inf
   after a finite max, a lone -0.0) at (80, 100), (8, 1000), (1, 8000),
   (3, 257), (1, 600), (2, 1) and (1, 8193) (rows past a cluster's
   registers, read twice) and select at the tail and at (1000, 1024) (a
   cluster of 8), and from a 4-byte offset (the round trip's 4-byte
   variant, select and reconstruct); select, reconstruct and the round
   trip also give ``warm_ms``: 200 calls back to back, L2 not flushed;
   segmented_lora — the per-row LoRA delta against its
   plain version on a layer's strided slice of pool-shaped slabs: the
   packed decode shape (R=16, S=1, 1024 -> 8 -> 1024, 33 slots, mixed
   slots with 0 and repeats) in bf16 and f32, a 64-row prefill chunk,
   w2's 4096 -> 8 -> 1024, rank 64, d_in 1000 and 36, ranks 1, 3 and
   33, S=17, d_out 1001 and 4096, a B=4 T=128 prefill on one adapter,
   slot-0 rows exactly 0, two launches
   bit-equal, and a row alone, in R=16 and on a one-slot view bit-equal
   at the decode, w2 and rank-64 shapes (batch invariance); library
   yardstick: index_select + two bmm; segmented_lora_halves — the
   row-parallel arm's down and up launches against ``down_torch`` and
   ``up_torch`` at generate's grafted wo and w2 under tp2 (512 and 2,048
   local input rows, rank 8, decode and prefill, bf16 and f32), timed,
   bounded, beside one index_select and one bmm each; and at one rank
   down + up bit-equal to the fused launch (the whole wo and w2, f32 and
   bf16);
4. generate — ``make_generate_fn`` at the full width of GPT-2 medium in
   bf16 (random weights from a seed): B=4, T0=128, 64 new tokens;
5. serve — ``Scheduler.serve`` at the same width, bf16: 8 requests with
   prompts of 40..700 tokens, 32 new tokens each, default block size,
   chunk and batch; every request finishes and no KV block leaks;
6. exact — in f32 at full width, three requests through
   ``Scheduler.serve`` emit exactly the tokens of solo
   ``make_generate_fn`` runs;
   multitenant — the reference bench's LoRA race at GPT-2 medium width
   in bf16: 32 adapters (wq/wv, ranks 2/4/8, rank bucket 8, b =
   0.02·N(0,1)) in a 33-slot ``AdapterPool``, one tenant each, 32
   requests (prompts 16/64/128, 16 new tokens), max_batch 16, prefill
   chunk 64; the multiplexed pass (one Scheduler) and the dedicated pass
   (one Scheduler per tenant on its grafted tree), walls, tokens/s,
   and how many tenants' tokens agree; no KV block or slot leaks;
   multitenant_exact — f32 at full width, 4 adapter tenants (one scaled
   1.5) and a base tenant pooled: each equals its solo grafted run;
6b. speculative — the speculative samplers at GPT-2 medium width with a
   4-layer draft of its width (its own seed), K = 4 (bench.py's
   spec_len): bf16, B=4, T0=128, 64 new tokens through prompt lookup,
   the draft and the self-draft probe (after a pass of each at 5 new
   tokens) and through plain greedy: new tokens/s on the same call, verify rounds, committed tokens a round, and each row's
   first position off plain greedy's tokens (reported, no limit); a
   Scheduler serving 8 requests of 32 new tokens (4 lookup on a random
   16-token base tiled to 128, 4 draft on random 128-token prompts):
   tokens/s, the lane's counters, ``serve.decode_tokens`` 0; f32 at
   B=4, 32 new: both samplers and the self-draft equal plain greedy, the
   self-draft within ceil(31 / 4) + 1 rounds; a lookup, a draft and a
   plain request through one Scheduler equal solo runs. Each leg's flash
   launches are held exactly to the prediction from its rounds, chunks
   and draft steps: a (B, T > 1) forward launches the forward kernel once
   a layer (its route held as a known constant: wgmma for the B=4 bf16
   prefills of 128 tokens, split for the rest), a (B, 1) step the decode
   kernel; the plain and solo runs each path is compared with run after
   its launch counts are read, so they stay out of them; the verify chunk's own shapes (4 rows at pos0 128 and 160 in
   a dense B=4 cache of 1,024 positions, a paged request's 4 rows at 160
   against 256 keys; bf16, f32) are kernel cases of phase 2;
   serve_router — failover (f32): two replicas (explicit pools),
   ``worker:kill@op=4`` on replica 1, 6 requests of 32..128 prompt tokens
   and 16 new: tokens equal solo runs, epoch 1, one eviction, requeued
   >= 1, no leaked block, the lease 3 × the slowest step of a warm
   replica (at least 200 ms), the ms from the kill to the eviction; the
   disaggregated race (bf16, bench.py's: 3 prompts of 224 tokens, 12 of
   16, 8 new, max_batch 16, chunk 64) through 1 prefill + 1 decode
   replica (prompt threshold 120) and through 2 colocated replicas after
   a warm pass: TTFT p50/p99 by class, makespan, migrated requests,
   blocks and bytes, streams equal between the layouts (reported); its
   f32 cut (1 long, 4 short) equal to colocated and solo;
   migrate-don't-evict (f32, bench.py's: block 16, replica A's pool 1 + 9,
   4 prompts of 48, 32 new, max_batch 2): recompute > 0 with migration
   off, fewer with it on, migrated > 0, streams equal; kv_socket: the f32
   cut's disaggregated run again with every KV block crossing a real TCP
   socket (``Router(kv_target_wrap=...)``: ``SocketKVTarget`` →
   ``KVSocketEndpoint`` in front of the decode replica) under a
   ``push:corrupt@op=1`` rule on the socket client: every stream
   bit-equal to the in-process wire's, the corruption rejected by the
   listener's CRC and healed by the KVPUSH stage retry, every migrated
   block ingested once, ms a block over the socket beside the in-process
   delivery's; every leg's flash
   launches held to the prediction from its prefill chunks, the solo
   runs' after the path's counts are read;
7. tiny — a tiny model run on the CPU (plain versions) and on the card
   (kernels) emits the same tokens;
   train_bf16 — one bf16 training step of a small model at head dim 64,
   on the CPU (plain versions) and on the card (the tensor-core forward
   and backward kernels): losses and each leaf's gradient agree;
8. train — ``make_gpt_train_step`` at the full width and depth of GPT-2
   medium, bf16 over f32 master weights, AdamW(1e-3), one seeded batch of
   B=8 × S=1024: a raw leg, a onebit + error-feedback leg and a top-k
   block + error-feedback leg (k = 0.01, the reference's ``topk-block``
   configuration), each one warm-up and 5 timed steps; the loss stays
   finite and falls; step ms, tokens/s and peak memory;
   aggregate_onebit — the aggregation tier's onebit decompress-sum at
   pod scale: 40, then 256 workers' gradients of one default partition
   (1,024,000 f32) through ``OnebitCompressor.compress``, stacked and
   summed by ``decompress_sum``: one grid unpack-sum launch a sum, equal
   to the plain version bit for bit;
   zero_codecs — the onebit and top-k kernels at ZeRO-1's shapes, where
   the whole flat gradient is one chunk: GPT-2 medium's 354,871,296 f32
   (n = 1) and a 177,435,648 segment (n = 2); pack bit-equal, unpack-sum
   at K = 1 and 2 by bit pattern, top-k select (the strided (101,
   3,513,578) and (101, 1,756,789)) and reconstruct-sum at K = 1 and 2
   bit-equal to their plain versions; kernel, plain and bound ms at the
   whole vector;
8b. train_zero — ZeRO-1 (``zero_1=True``) on the card, the train legs'
   model, batch and seeds, one warm-up and 2 timed steps a leg:
   replicated_raw, zero_raw (losses and parameter digest bit-equal to
   replicated_raw's), zero_onebit_ef (one onebit round trip of the
   whole vector a step), zero_topk_block_ef (k = 0.01 of the whole
   vector: the strided layout); moments exactly 2·ceil(L/n)·4 B; step
   ms, peak memory;
   train_accum — ``accum_steps`` = 2 and 4 at B=8 × S=1024 (raw, one
   warm-up and 2 timed steps): losses finite and falling, peak memory
   below the raw leg's (accum_steps = 1);
   eval — ``evaluate_perplexity`` of ``make_eval_step`` on two B=8 ×
   S=1024 batches before and after three raw steps on them from the
   train legs' weights: finite, falling, the first below 2 × vocab;
9. train_tiny — a tiny f32 model trains 3 raw steps on the CPU (plain
   versions) and on the card (kernels) to losses within 1e-4; on the
   card ``accum_steps=2`` equals the full-batch step to 1e-5;
10. ring — the ring kernels with 2, 3 and 4 rank processes (``spawn``;
    ring, train_ring and the mesh phases run on four kept processes,
    ``RankPool``, each body in a new group; the DCN phases on fresh ones)
    on the card, in one gloo group over a ``FileStore``, mapping each
    other's workspaces through CUDA IPC; the card's compute mode. At the
    training step's payload rows (onebit words of a full 1,024,000 and
    of the 567,296 tail chunk's segment, the f32 scale, randomk's
    k = 0.01 values), an odd 1,003-byte uint8 row, a 300,001-byte row
    that makes the ranks grow their workspaces, an int32 row, and two
    payloads in one tree call (onebit's signs and scale, the main path's
    call; the tail's signs, the scale and an odd uint8 leaf), the rotate
    call (collect and gather: a push kernel, the stream's waits on the
    rank's own flags, a land kernel) and presum (n kernels, n - 1 stream
    waits) are bit-equal to their plain versions over gloo on CPU
    copies; 2,000 back-to-back calls cycling the three over changing
    contents come out right; at chunk level ``compressed_allreduce_local``
    on the ring equals the staged tier bit for bit for onebit + EF and
    top-k block + EF, and randomk keeps the same support, values within
    1e-5; the last rank holds back a call and every other rank's
    workspace check raises, naming the epoch and the late rank's flag,
    within its bound (2 s here), before the late call releases them.
    Each case also runs with n in-process peers (one workspace and stream
    a rank in this process, all n at once), bit-equal to what the ranks
    sent, under both protocols (the stream's waits, which the ranks on
    one card take, and the spinning kernel, which peers that run at once
    take). Per call: ms, CUDA events around a call of the n in-process
    peers in the stream protocol, its launches and waits issued while a
    sleep kernel holds the card (the kernels' own time), ms_spin the same
    in the spinning protocol; ms_time_sliced, around one rank
    process's bare call after the ranks meet on the host, the slowest
    rank's median (the protocol's cost with the ranks time-slicing the
    card); library_ms, gloo's ``all_to_all_single``, ``all_gather`` or
    ``reduce_scatter`` on the same CUDA rows, timed as ms_time_sliced
    (null for a payload of several leaves: no one call moves it); the
    byte bound. At n = 2, ring_switch: an empty push bounced between the
    two processes 200 times, half a round being the card's cost of one
    switch between their contexts;
11. train_ring — two rank processes on the card run
    ``make_gpt_train_step`` at GPT-2 medium's full width and 8 of its 24
    layers (``RANK_PHASE_LAYERS``), B=4 × S=1024 each (the single-card
    legs' global batch), one warm-up
    and 2 steps a leg: staged onebit + EF, ``BYTEPS_ICI_TIER=ring``
    onebit + EF, ring randomk (k = 0.01) + EF, then ZeRO-1: staged raw,
    staged onebit + EF, ring onebit + EF. Each ring onebit leg's
    losses and each rank's parameter digest equal its staged leg's;
    every leg ends with the ranks' parameters equal and finite losses;
    each rank's moments 2·ceil(L/2)·4 B under ZeRO-1, 2·L·4 replicated
    (L = 153,331,712 parameters at 8 layers); step ms, tokens/s
    (time-sliced) and each rank's peak memory;
12. train_dcn — the DCN parameter-server tier: one server process of the
    port (``python -m byteps_tpu_torch.server``, two workers, a free
    port; built with g++ first) and two rank processes on the card, each
    training GPT-2 medium at full width and the depth of
    ``RANK_PHASE_LAYERS`` (4 layers, as in phases 13 and 14: the cuts
    keep the whole smoke inside its limit), B=4 × S=1024, one
    warm-up and
    one timed step a leg: staged_raw (``make_gpt_train_step`` at n = 2, the
    yardstick), dcn_raw and dcn_fp16 (``byteps_tpu_torch.torch``'s
    ``DistributedOptimizer`` over the server, ``Compression.fp16`` on the
    second, after ``broadcast_parameters`` from rank 0), then dcn_ipc_raw
    (the raw leg over a server rank 0 starts in its own process, reached
    there through the in-process path, ``BYTEPS_ENABLE_IPC=1``; rank 1
    over TCP). Both ranks'
    parameters are equal after every step of every leg, dcn_raw's and
    dcn_ipc_raw's equal staged_raw's bit for bit (rank 0's data plane
    opening no TCP connection, its server stopped by the two goodbyes),
    dcn_fp16's losses lie within 1e-2 of
    dcn_raw's, the bytes pushed and pulled per step are the partitions'
    codec bytes (raw 411,787,264 each way at 4 layers), the bytes copied
    D2H and H2D per step 411,787,264 each, and the flash kernels launch once
    per layer and step on every leg; the server exits 0 after both
    ranks' goodbyes and is killed on any other way out. Step ms (the
    slower rank), tokens/s, wire and copy bytes, the scheduler's stage
    run and dwell sums per step, peak memory;
13. train_hybrid — the eager surface (``byteps_tpu_torch.eager``) over
    one pod of two rank processes on the card, with one port server
    process (``DMLC_NUM_WORKER=1``) for each hybrid leg, the ranks under
    ``BYTEPS_FORCE_DISTRIBUTED=1``: GPT-2 medium at full width and 4
    layers (``RANK_PHASE_LAYERS``), B=4 × S=1024 a rank, one warm-up and
    one timed step a leg,
    ``push_pull_tree`` of
    the gradients (``flat_leaves`` order, averaged) between backward and
    AdamW: staged_raw (``make_gpt_train_step``, the yardstick), eager_raw
    (not distributed: the eager ICI pipeline), hybrid_raw (sharded, the
    staged tier, the raw wire) and hybrid_ring_onebit
    (``BYTEPS_ICI_TIER=ring``: the ring's compressed reduce-scatter, the
    onebit wire with the controller's host EF) and hybrid_ctl3_raw
    (``BYTEPS_POD_CONTROLLERS=3``: each partition on its owner's NIC).
    Both ranks' parameters
    equal after every step of every leg, eager_raw's, hybrid_raw's and
    hybrid_ctl3_raw's equal staged_raw's bit for bit (every NIC of the
    three moving bytes, their sum hybrid_raw's each way),
    hybrid_ring_onebit's averaged
    gradients of block 0 after every step held against the same
    pipeline's on the CPU (the plain versions of the kernels, the same
    host codec and EF) from the same raw gradients: every sign equal,
    every value within 1e-5 of its leaf's largest magnitude, the
    controller's bytes pushed and
    pulled per step the plans' (raw 411,787,264 each way at 4 layers), D2H
    and H2D 411,787,264, the other rank's none; step ms (the slower rank),
    tokens/s, bytes and ``ici.wire_bytes`` per step, the stage run and
    dwell sums (REDUCE's, run in the caller's thread, too) and the tail
    thread's sum (``eager.tail_us``) per step, peak memory;
14. train_chaos — the DCN tier's robustness, the same two ranks and
    model at 2 layers, two port server processes a leg (``DMLC_NUM_SERVER=2``), one
    warm-up and 2 steps a leg: staged_raw (the yardstick); dcn_chaos
    (``DistributedOptimizer`` under ``BYTEPS_FAULT_SPEC=
    push:timeout@p=0.02;pull:corrupt@p=0.02``, a fixed seed: retries,
    injected ack losses and corruptions and CRC errors on each rank, no
    give-up, every credit back); dcn_failover (the health monitor at 50
    ms, 3 misses; after the first timed step the parent SIGKILLs server
    1 and the next step runs through the failure: one failover a rank,
    its keys re-inited on server 0, which exits 0 after both goodbyes;
    then each rank fails server 0 over too, and a 3,000,000-float
    ``push_pull`` average on the card degrades to the rank's own value,
    undivided by ``size()`` 2);
    hybrid_degraded (the pod of train_hybrid's hybrid_raw with the
    monitor on; after the first timed step the parent SIGKILLs both
    servers and the next step degrades to the pod's sum over the pod:
    degraded fallbacks on the controller, no wire byte);
    hybrid_owner_failover (that pod over three controller NICs, two wire
    retries; after the first timed step a fault plan on owner 1's NIC
    kills every push through it, and the next step runs through the
    owner failover: one failover, the NIC retired, owners 0 and 2 left,
    every credit pool full, the servers exiting 0; the time from the
    first kill to the remap). Every leg's
    parameters equal staged_raw's bit for bit after every step (two
    ranks: a + b exact in either order, /2 exact; one pod is the whole
    job); bytes pushed, pulled, D2H and H2D per step exact; step ms (the
    slower rank), the counters, and the time from each kill to each
    rank's failover. Then elastic membership and bounded staleness, each
    leg's server pair started once both ranks are about to connect (a
    lease runs from the server's start): dcn_lease_evict
    (``BYTEPS_WORKER_LEASE_MS=800``, heartbeats every 100 ms; rank 1
    arms a ``worker:kill`` plan after the first timed step and its
    second step fails on the kill; step 1 equal to staged_raw's on both
    ranks, rank 0's second step equal to a one-worker replay of it from
    rank 0's state after step 1, with no wire; one membership event or
    more and live size 1 on rank 0; the time from the kill to rank 0's
    adoption of the eviction); dcn_join (the job starts with
    ``DMLC_NUM_WORKER=1``; rank 1, worker id 1, enters through
    ``DcnCore.join()`` before the warm-up: every step equal to
    staged_raw's, so the divisor is the live count 2; one join on rank
    1, a membership event on rank 0); dcn_straggler_k0 (rank 1 pays
    ``STRAGGLER_MS`` a wire attempt, ``worker1:slow``: equal to
    staged_raw's); dcn_straggler_k1 (the same straggler under
    ``BYTEPS_STALENESS=1``: the warm-up equal to staged_raw's, every
    pull at most one round stale; stale and served-ahead pulls, and
    both ranks' ms a step against dcn_straggler_k0's).
15. examples — the port's ``examples/torch_port/`` as their docstrings
    run them, each job's server and workers started through the
    launcher's roles (``python -m byteps_tpu_torch.launcher``:
    ``DMLC_ROLE=server``, and ``DMLC_ROLE=worker`` spawning both workers
    on the card): the MNIST example's loss falls from epoch to epoch and
    both workers end with equal parameters; the benchmark example prints
    its GB/s, beside the card's name and power limit; and, at once,
    launch_global: ``BYTEPS_JAX_DISTRIBUTED=1`` through the launcher's
    worker role spawns two copies of ``checkpoint_resume.py`` (GPT-2
    medium at full width and ``LAUNCH_GLOBAL_LAYERS`` layers, B=4 ×
    S=512 a rank) whose bootstrap forms a gloo world of 2 before the
    script runs: both report the restored checkpoint matching their
    live parameters and equal digests, and each rank's flash launches
    (reported by the rank) are the forward (wgmma), dq and dk/dv once a
    layer and step.
16. train_parallel — tensor and sequence parallelism: GPT-2 medium at
    full width and 12 of its 24 layers (``RANK_PHASE_LAYERS``: the cut
    keeps the whole smoke inside its limit with train_multislice), bf16
    over f32 master weights,
    AdamW(1e-3), the global batch B=4 × S=1024, on meshes of rank
    processes that time-slice the card (gloo), one warm-up and one timed
    step a leg: one_rank (this process, the yardstick, and a roundoff
    control: tp = 2's row-parallel arithmetic on one rank), tp2_raw, sp2_raw (the contiguous ring),
    sp2_zigzag, tp2_sp2_vocab (the readout's vocab split over tp),
    dp2_tp2_onebit_ef (onebit + EF over the dp axis),
    dp2_tp2_onebit_ring (the same on the ring tier over each dp line,
    two rings at once: losses and each rank's parameter digest bit-equal
    to dp2_tp2_onebit_ef's, two rotate calls a chunk), and a planted
    fault (sp2 with the sp sum of wte and wpe dropped). Each leg's losses
    fall and lie within 1e-2 of one_rank's (the onebit leg: its warm-up;
    then within 0.1), each gathered leaf further than 2·lr from
    one_rank's in under ``PARALLEL_OFF_SHARE`` of its elements (onebit:
    the whole under 0.3; the planted fault must fail it), its
    tp-replicated leaves bit-identical on every rank, its launch counts
    exact, the split-path forwards those the route of its calls gives;
    ms a step, peak memory a rank, collectives per step by kind. Then a
    small f32 model's tp2×sp2 and dp2×sp2 zigzag steps, on the CPU
    (plain versions) and on the card (kernels), the losses within 1e-4
    of one rank's and each leaf under the same per-leaf limit.
17. train_pipeline and train_moe — pipeline and expert parallelism on
    rank processes that time-slice the card (gloo), one warm-up and one
    timed step a leg, after the flash kernels at every distinct call the
    legs make and onebit at the dp2_pp2 stage's tail chunk
    (``pipeline_kernel_cases``). train_pipeline: GPT-2 medium at full
    width and depth, B=4 × S=1024, GPipe stages of 12 layers:
    one_rank (the yardstick), pp2_raw (4 microbatches of one row) and
    dp2_pp2_onebit_ef (2 of one row); train_moe: the repo's Switch-MoE
    configuration (vocab 32768, d 512, 8 heads, 8 layers, d_ff 2048, 8
    experts, capacity factor 1.25, top-1, bf16) at B=8 × S=512:
    moe_one_rank, moe_dp2 (the control), moe_ep2 (held to it) and
    moe_pp2_ep2 (2 microbatches; held to moe_ep2). Each leg's losses
    fall, its limits hold (see ``phase_train_pipeline`` and
    ``phase_train_moe``), the leaves no pp or ep axis splits are the same
    on every rank, the launch and collective counts exact; ms a step,
    peak memory a rank, the aux loss, collectives a step by kind. Then
    small f32 models' pp2, ep2 and pp2×ep2 steps on the card (capacity
    not binding, no aux term) within 1e-4 of one rank's.
18. train_multislice — the multi-slice tier (the ``slice_`` axis as a
    hierarchical DCN tier), ZeRO-3 and ZeRO-1 over a dp subgroup: GPT-2
    medium at full width and 12 of its 24 layers (``RANK_PHASE_LAYERS``)
    on four rank processes time-slicing the card, B=8 × S=1024 (2 rows a
    data worker), one warm-up and one timed step a leg, after the flash
    kernels at a data worker's and a dp2×tp2 rank's calls and onebit at
    the hierarchical exchange's segments (``multislice_kernel_cases``):
    dp4_raw, slice2_dp2_raw (bit-equal to it), slice2_dp2_onebit_ef (EF
    exactly ceil(P / 2) f32 a rank), slice2_dp2_onebit_ef_ring (its
    exchange over the slice_ line on the ring tier, bit-equal to it),
    slice2_dp2_zero3 (ZeRO-3 over slice_ with remat: exact persistent
    bytes a rank, peak below slice2_dp2_raw's, exact gathers and
    reduce-scatters), dp2_tp2_raw and dp2_tp2_zero1 (bit-equal to it);
    the limits at ``MULTISLICE_LEGS``, exact launches; ms a step, peak
    memory a rank, collectives a step.
19. sharded_decode — tp and ep in generate and serve, on four rank
    processes time-slicing the card (one spawn, gloo), after the rotate
    and presum kernels over each dp line of the job (two rings at once)
    bit-equal to the plain hops over the same group: generate over tp2
    (GPT-2 medium at full width and depth, bf16, B=4, T0=128, 32 new
    tokens), over ep2 and ep2×tp2 (bench.py's "moe" model, uncut), the
    tiny f32 configs over tp2 (dense, an int8 cache, a grafted rank-8
    LoRA on wq, wv, wo and w2) and ep2×tp2 (the tiny MoE), and the
    Scheduler over tp2 (GPT-2 medium bf16, 8 requests; the tiny f32
    model on a pool that preempts). One rank's run of each model (this
    process) is the yardstick, and the MoE model's one-rank run a leg of
    its own (moe_one_rank): bf16 first-step logits within TOL of it,
    every rank of a tp line the same tokens, f32 tokens equal to it
    exactly, the LoRA leg's fused launches and each half's exactly
    2 × layers × forward calls; tokens/s, TTFT, peak memory a rank.

20. families — the model families at full width and depth (bench.py's
    shapes), bf16 over f32 master weights, AdamW(1e-3), one warm-up and
    2 timed steps a leg on a repeated seeded batch, after the forward,
    dq and dk/dv kernels at their non-causal calls (BERT-base B=8 × 512
    and ViT-B/16 B=32 × 196, 12 heads of 64; T5's cross-attention at
    512/512 and 128 rows over 512 keys; a ring block of BERT over sp2 at
    keys 256 with an lse cotangent), generate's non-causal encoder prefill
    (B=4 × 128), its one-row cross-attention over those 128 keys and its
    decode step (``family_kernel_cases``):
    bert_onebit_ef (BERT-base, B=8 × S=512, mask rate 0.15, onebit + EF),
    vit_b16 (B=32 at 224²), t5_base (12 + 12 layers, B=8, 512 + 512
    tokens), t5_generate (B=4, 128 source tokens, 32 new, greedy, from
    t5_base's weights) and resnet50 (B=32 at 224²): losses fall, ResNet's
    running statistics move; step ms, items/s, peak memory, new tokens/s;
    families_tiny — each family's tiny f32 step on the CPU and on the
    card from the same weights within 1e-4 (loss and every leaf; ResNet
    with TF32 off), BERT's ``accum_steps=2`` on microbatches of unequal mask counts
    against its full-batch step, and T5's cached greedy generation on
    weights scaled by 20: the card's tokens equal the CPU's, not
    constant, each cached step's logits within 1e-4 of teacher-forced
    ``t5_decode``.
21. process_tier — resume_exact: GPT-2 medium at full width and
    ``PROCESS_TIER_LAYERS`` layers, B=8 × S=1024, the onebit + EF leg
    fed through ``data.PrefetchLoader`` in ``data.ElasticShardMap``
    order: 2 steps, an asynchronous ``Checkpointer.save`` of
    ``checkpoint.train_state`` (parameters, AdamW moments and step
    count, EF residual, codec seed and count, the shard map's cursor),
    2 more steps; a freshly built step restored from it trains the same
    2 steps: losses, parameters, moments and EF bit-equal to the
    continuation; the checkpoint's bytes, the save's device-to-host ms
    and writer ms, the restore ms; the flight recorder's step ring
    advanced once a step. supervised_resume: a port server in this
    process and the launcher's ``Supervisor`` running ``--child-worker``
    children (``BYTEPS_CHILD_PIN=1``, a checkpoint directory, no card):
    one clean run, one whose child is SIGKILLed after its round-2
    progress line, respawned, restored and rejoined: ``state_crc`` and
    ``state_sum`` equal, exit reasons ``signal:SIGKILL`` … ``clean``,
    restarts and ``resumed_from`` at least 1; the ms from the kill to the
    respawned child's first round.

Each of phases 4-6, each train leg and aggregate_onebit runs with the
launch counters set to 0 just before it and read just after: serve,
exact and the
multitenant paths must launch the forward on its split path
(``flash_fwd_split``), the multitenant paths the segmented LoRA kernel,
the race exactly 2 x 24
times for each packed decode step and each prefill chunk of an
adapter-tagged request (counted by wrapping the schedulers' callables);
generate must launch the
forward and decode kernels, serve the forward kernel (its decode is the
packed plain step; it reaches the decode kernel only through a one-token
prefill chunk), exact both; train_bf16 and the train legs the forward
and both backward kernels once per layer and step, the onebit leg the
pack and unpack-sum kernels once per gradient chunk and step, and the
top-k leg the round trip once per full chunk and step (346) and select
and reconstruct-sum once per step (the ragged tail chunk),
aggregate_onebit the pack once a worker (296) and the grid unpack-sum
once a sum (2); process_tier the forward (wgmma), dq and dk/dv once a
layer and step and onebit pack and unpack-sum once a gradient chunk
and step over its 6 steps. families (each leg counted from 0) the flash kernels
12 a step for BERT and ViT and 36 for T5, onebit pack and unpack-sum
once a gradient chunk a step for BERT, t5_generate's forward 12 + 12·N
and decode 12·N a call of N new tokens, and nothing for ResNet-50.
train_zero (its ZeRO legs, each counted from 0) the
flash kernels once per layer and step, onebit pack and unpack-sum once
a step, top-k select and reconstruct-sum once a step and the round trip
never; train_accum the flash kernels accum × 24 a step; eval (each of
its two evaluations counted from 0) the forward 24 times a batch and
neither backward kernel.
train_hybrid's and train_chaos's ranks report theirs, exact on both
ranks per leg: the flash kernels once per layer and step; in hybrid_ring_onebit, per
compressed partition (at least ``BYTEPS_MIN_COMPRESS_BYTES``) and step,
onebit pack twice, unpack-sum once and the rotate call once (the ring's
reduce-scatter at n = 2). train_ring's ranks report their counts, equal
on both ranks and exact per leg: the flash kernels once per layer and step; onebit pack n + 1 and
unpack-sum 1 + 2n times per chunk and step at n = 2 ranks (n segments
packed and the owner's sum repacked; the owner's K = n unpack-sum, then
n gathered and n own rows decoded); the ring onebit leg the rotate
call twice per chunk and step (one collect and one gather, each moving
the signs and the scale), the randomk leg presum once and rotate once
(the gather) and no collect; under ZeRO-1 (one reduce-scatter of the
whole vector a step, the stepped segments all-gathered raw) onebit pack
n and unpack-sum 1 + n times a step, the ring leg the rotate call once
(the collect).
A ``launches`` line gives the counts per path, then a
``{"kernels": [...]}`` line whose ``launches`` sums the main paths
(generate, serve, multitenant, speculative, serve_router, the three
train legs, train_zero's
three ZeRO legs, train_accum, eval, train_ring's six legs on one rank,
train_dcn's four legs on one rank, train_hybrid's five legs on one
rank, train_chaos's nine legs on one rank, aggregate_onebit,
train_parallel's one_rank and one rank of each leg, train_pipeline's
one_rank and one rank of each leg, train_moe's moe_one_rank and one
rank of each leg, train_multislice's one rank of each leg,
sharded_decode's moe_one_rank and rank 0 of each leg, families' legs,
process_tier's resume_exact;
the segmented
LoRA row's launches count its fused launches and both halves (apart as
``fused_launches``, ``down_launches`` and ``up_launches``, and the
halves by path), and it gives the halves' times, bounds and library
times at the wo decode case as ``down_*`` and ``up_*``, every half case
as ``halves`` and the one-rank split's as ``split_tp1_bit_equal``; the
ring rows add sharded_decode's cases over a dp line as
``dp_line_cases``; the ring
rows' times are the
ring phase's
n = 2 cases, rotate's the onebit payload's tree collect with the signs
leaf alone as ``signs_*``; the flash_fwd row, timed at serve's chunk,
also gives the training shape's ms, bound and SDPA ms as ``train_*``,
the split path's at serve's chunk as ``split_*`` and its launches, in
all and by path, as ``split_launches`` and ``split_launches_by_path``,
the flash_decode
row, timed at generate's step, the long case's as ``long_*``; the
flash_fwd row the verify chunk's cases as ``verify_cases``; the
flash_fwd, flash_bwd_dq and flash_bwd_dkv rows also give each
train_parallel call's times, bound and error (and the forward's route
and the paths making the call) as ``ring_cases``, each train_pipeline
and train_moe call's as ``pipeline_cases``, each train_multislice
call's as ``multislice_cases``, each families call's as
``family_cases`` (the decode row: t5_generate's step); the onebit rows the dp2_pp2 tail
chunk's ms as ``pp_tail_ms`` and the hierarchical exchange's segments'
as ``hier_chunk_half_*`` and ``hier_tail_half_*``; the
topk rows add ``warm_ms`` and the 4-byte offset's ``offset_ms``, the
round trip ``tall``: (8, 1000) and (1, 8000), reconstruct the chunk's
and K = 8's ms as ``chunk_ms`` and ``k8_ms``; the grid unpack-sum row,
timed at K = 40, K = 256's ms and bound as ``k256_*`` and the ragged
1,000,003's ms as ``ragged_ms``),
and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, so the script exits non-zero and prints no
result; so it does without a CUDA card or without the package beside it.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): memory and per-type compute
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain: bf16 outputs round to 2^-8 relative and the two sum in
# different orders; f32 differs by the roundoff of <= 1024-term sums
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# backward, on top of TOL per element: an absolute floor of a thousandth
# of the largest |grad| (causal dq/dk/dv peak at the first rows and keys,
# 25-55x their rms at the training shape), and the relative L2 error of
# the whole output; bf16 differs where p or ds round the other way
# (NVIDIA H100: <= 2e-4), f32 is bit-equal
BWD_ATOL = 1e-3
BWD_REL_L2 = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
# one bf16 step, CPU against card: the GEMMs round to bf16 in different
# orders on the two devices (NVIDIA H100: losses 3e-5 apart, gradients
# <= 1e-2 in relative L2)
TRAIN_BF16_LOSS_TOL = 1e-3
TRAIN_BF16_REL_L2 = 5e-2
# segmented LoRA, f32 kernel vs plain: the same f32 products summed in
# other orders, relative to max |plain|; bf16 is held to one bf16 ulp
LORA_F32_TOL = 1e-5


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since start."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean device time of ``fn`` over ``iters`` launches, each timed by
    its own CUDA events after the L2 cache was overwritten (a 256 MB
    buffer, five times the 50 MB L2), so every launch starts cold as
    the main path's do. A spin kernel (``torch.cuda._sleep``, about a
    millisecond) runs ahead of each timed region, so the host enqueues
    ``fn``'s launches while the card is busy and the events see device
    time, not the host's launch overhead."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for a, b in ev:
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in ev) / iters


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple:
    """(max |got - want|, whether |got - want| <= tol + tol * |want|)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return float(d.max()), bool((d <= tol + tol * w.abs()).all())


# --------------------------------------------------------------------------
# phases 2-3: each kernel against its plain version
# --------------------------------------------------------------------------
def fwd_case(timer, name, B, Sq, Sk, H, Hkv, D, q_off, dtype, seed,
             causal=True, k_off=0):
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from byteps_tpu_torch.ops.flash_attention import (
        attention_lse_torch, flash_attention_lse)

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
    o, lse = flash_attention_lse(q, k, v, q_off, k_off, causal=causal)
    o_ref, lse_ref = attention_lse_torch(q, k, v, q_off, k_off,
                                         causal=causal)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    err_o, ok_o = max_err(o, o_ref, tol)
    err_l, ok_l = max_err(lse, lse_ref, tol)
    if not (ok_o and ok_l):
        raise AssertionError(f"flash_fwd {name}: o err {err_o}, lse err "
                             f"{err_l} beyond tolerance {tol}")
    ms = timer(lambda: flash_attention_lse(q, k, v, q_off, k_off,
                                           causal=causal))
    plain_ms = timer(lambda: attention_lse_torch(q, k, v, q_off, k_off,
                                                 causal=causal))
    # the library yardstick: same function (o only) from (B, H, S, D)
    # copies made outside the timing, k/v widened to H heads for GQA
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    if not causal:
        lib_ms = timer(lambda: sdpa(qt, kt, vt))
    elif q_off == k_off and Sq == Sk:   # plain causal: SDPA's flash
        lib_ms = timer(lambda: sdpa(qt, kt, vt, is_causal=True))
    else:
        mask = (q_off + torch.arange(Sq, device="cuda")[:, None]
                >= k_off + torch.arange(Sk, device="cuda")[None, :])
        lib_ms = timer(lambda: sdpa(qt, kt, vt, attn_mask=mask))
    # the work this run's data needs: live (row, key) pairs, live keys
    pairs = (Sq * Sk if not causal else
             sum(min(Sk, max(0, q_off + i - k_off + 1)) for i in range(Sq)))
    kend = Sk if not causal else min(Sk, max(0, q_off + Sq - k_off))
    isz = q.element_size()
    n_bytes = (2 * B * Sq * H * D * isz + 2 * B * kend * Hkv * D * isz
               + B * Sq * H * 4)
    n_ops = 4 * D * pairs * B * H
    bms, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"case": name, "dtype": str(dtype).split(".")[-1],
           "shape": [B, Sq, Sk, H, Hkv, D], "q_off": q_off,
           "k_off": k_off, "causal": causal,
           "route": fwd_route_of(q, k, v),
           "max_abs_err": max(err_o, err_l),
           "tolerance": tol,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bms, "bound_by": by}
    emit({"phase": "flash_fwd", **res})
    return res


def parallel_layer_calls(cfg, B, S, axes, layout) -> list:
    """The flash calls one layer of a train_parallel step makes, for each
    sp index of the mesh ``axes`` (the schedules of
    ``parallel/ring_attention.py``; the dp and tp ranks at one sp index
    make the same calls): per sp index a list of (B, Sq, Sk, H, Hkv, D,
    q_off, k_off, causal, dlse), B and the heads this rank's share.
    Without sp the plain causal call, no lse cotangent; the contiguous
    ring every block at its owner's offset, dead blocks included; the
    zigzag ring its half-pairs (the diagonal masked, the others
    unmasked); on a ring the merge gives the backward an lse cotangent."""
    dp, tp, sp = (axes.get(a, 1) for a in ("dp", "tp", "sp"))
    Bl, H, Hkv, D = (B // dp, cfg.n_heads // tp, cfg.kv_heads // tp,
                     cfg.head_dim)
    if sp == 1:
        return [[(Bl, S, S, H, Hkv, D, 0, 0, True, False)]]
    S_loc = S // sp
    out = []
    for idx in range(sp):
        mine = []
        for step in range(sp):
            src = (idx - step) % sp
            if layout == "contiguous":
                mine.append((Bl, S_loc, S_loc, H, Hkv, D, idx * S_loc,
                             src * S_loc, True, True))
                continue
            c = S_loc // 2
            q_offs = (idx * c, (2 * sp - 1 - idx) * c)
            k_offs = (src * c, (2 * sp - 1 - src) * c)
            pairs = (((0, 0, True), (1, 0, False), (1, 1, True)) if step == 0
                     else ((1, 0, False), (0, 0, False)) if idx > src
                     else ((1, 0, False), (1, 1, False)))
            mine += [(Bl, c, c, H, Hkv, D, q_offs[qi], k_offs[ki], masked,
                      True) for qi, ki, masked in pairs]
        out.append(mine)
    return out


def parallel_paths() -> list:
    """(path, dtype, cfg, B, S, mesh axes, seq_layout) of every step
    train_parallel drives: one_rank and the legs in bf16, then the f32
    parity case's one-rank step and legs."""
    from byteps_tpu_torch.models import GPTConfig

    g, f = GPTConfig.gpt2_medium(), parallel_f32_cfg()
    bf, f32 = torch.bfloat16, torch.float32
    return ([("one_rank", bf, g, *PARALLEL_BATCH, {}, "contiguous")]
            + [(leg, bf, g, *PARALLEL_BATCH, axes, layout)
               for leg, _, axes, layout, _, _ in PARALLEL_LEGS]
            + [("f32_one_rank", f32, f, *PARALLEL_F32_BATCH, {},
                "contiguous")]
            + [(leg, f32, f, *PARALLEL_F32_BATCH, axes, layout)
               for leg, axes, layout in PARALLEL_F32_LEGS])


def parallel_kernel_cases(timer) -> dict:
    """The forward, dq and dk/dv kernels at every distinct call the
    train_parallel paths make (:func:`parallel_layer_calls`: each path's
    local batch, heads and length, each offset pair, live and dead, the
    backward with the lse cotangent where the path has one), each against
    its plain version under the cases' tolerances, timed and bounded:
    {case: {"paths": [...], "fwd": ..., "bwd": ...}}, the forward's
    ``route`` among its fields."""
    calls = {}
    for path, dt, cfg, B, S, axes, layout in parallel_paths():
        for mine in parallel_layer_calls(cfg, B, S, axes, layout):
            for call in mine:
                paths = calls.setdefault((dt,) + call, [])
                if path not in paths:
                    paths.append(path)
    out = {}
    for i, (key, paths) in enumerate(calls.items()):
        dt, B, Sq, Sk, H, Hkv, D, q_off, k_off, causal, dlse = key
        name = (f"{paths[0]}:{B}x{Sq}x{H}@{q_off}/{k_off}"
                + ("" if causal else ":unmasked"))
        out[name] = {
            "paths": paths,
            "fwd": fwd_case(timer, name, B, Sq, Sk, H, Hkv, D, q_off, dt,
                            200 + i, causal=causal, k_off=k_off),
            "bwd": bwd_case(timer, name, B, Sq, Sk, H, Hkv, D, q_off, k_off,
                            dt, 400 + i, dlse, causal)}
    return out


def leg_routes(path) -> dict:
    """The forward's route at each distinct call of ``path``'s layer (as
    the library decides it for such tensors) and the split-path launches
    one rank of it makes a layer: {"routes": {call: route}, "split_per_layer":
    n}."""
    from byteps_tpu_torch.ops.flash_attention import fwd_route

    _, dt, cfg, B, S, axes, layout = next(p for p in parallel_paths()
                                          if p[0] == path)
    routes, split = {}, []
    for mine in parallel_layer_calls(cfg, B, S, axes, layout):
        n = 0
        for B_, Sq, Sk, H, Hkv, D, q_off, k_off, causal, _ in mine:
            q = torch.empty(B_, Sq, H, D, dtype=dt, device="cuda")
            k = torch.empty(B_, Sk, Hkv, D, dtype=dt, device="cuda")
            r = fwd_route(q, k, k)
            routes[f"{B_}x{Sq}x{H}@{q_off}/{k_off}"
                   + ("" if causal else ":unmasked")] = r
            n += r == "split"
        split.append(n)
    if len(set(split)) != 1:
        raise AssertionError(f"{path}: sp ranks take the split path a "
                             f"different number of times a layer: {split}")
    return {"routes": routes, "split_per_layer": split[0]}


def fwd_route_of(q, k, v):
    """The forward's route for these inputs ("split" or "wgmma"), or None
    from a checkout whose library does not say."""
    from byteps_tpu_torch.ops import flash_attention as tfa

    route = getattr(tfa, "fwd_route", None)
    return route(q, k, v) if route is not None else None


# (name, B, Sq, Sk, H, Hkv, D, q_off, dtypes, seed): the split path at the
# serving chunks' geometry beyond serve's own chunk: multitenant's 64-row
# chunk at a long prefix, GQA, head dim 128, more splits than one cluster
# holds (32 splits of 128 keys on clusters of 8), and 47 splits at head
# dim 128, whose merge slots take a cluster of 16
SPLIT_CASES = (
    ("chunk64", 1, 64, 1024, 16, 16, 64, 640, ("bf16", "f32"), 18),
    ("chunk_gqa", 1, 32, 512, 16, 4, 64, 256, ("bf16",), 19),
    ("chunk_d128", 1, 32, 512, 8, 8, 128, 256, ("bf16",), 20),
    ("many_splits", 1, 37, 4096, 4, 4, 64, 4000, ("bf16",), 21),
    ("wide_cluster", 1, 32, 6016, 8, 8, 128, 5984, ("bf16",), 22),
)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def split_cases(timer) -> list:
    return [fwd_case(timer, name, B, Sq, Sk, H, Hkv, D, q_off, DTYPES[dt],
                     seed)
            for name, B, Sq, Sk, H, Hkv, D, q_off, dts, seed in SPLIT_CASES
            for dt in dts]


# (dtype, H, Hkv, D, position of the chunk, batch, seed): in f32 the
# batch of 9 makes the tiles fill the card (one block a tile) and the
# 64-row chunk takes 32-row tiles, so the plan differs on each side
INVARIANCE = (("bf16", 16, 16, 64, 475, 4, 51),
              ("f32", 16, 16, 64, 475, 9, 52),
              ("bf16", 16, 4, 128, 200, 4, 53))


def fwd_invariance(dtype, H, Hkv, D, pos, batch, seed):
    """The split path's contract: a row's o and lse depend only on its q
    row and its live keys. The 32 rows of a chunk at ``pos`` against
    their live keys, bit for bit the same (o and lse) as: the same rows
    inside a 64-row chunk; against 300 keys more past the live ones; as
    batch entry 0 of ``batch``; and a second launch."""
    from byteps_tpu_torch.ops.flash_attention import flash_attention_lse

    dt = DTYPES[dtype]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(batch, 64, H, D, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(batch, pos + 364, Hkv, D, generator=g,
                        device="cuda").to(dt) for _ in range(2))
    live = pos + 32

    def rows32(qq, kk, vv):
        o, lse = flash_attention_lse(qq.contiguous(), kk.contiguous(),
                                     vv.contiguous(), pos, 0)
        return o[:1, :32], lse[:1, :32], fwd_route_of(qq, kk, vv)

    base = rows32(q[:1, :32], k[:1, :live], v[:1, :live])
    variants = {
        "in_64_row_chunk": rows32(q[:1], k[:1, :pos + 64], v[:1, :pos + 64]),
        "sk_live_plus_300": rows32(q[:1, :32], k[:1, :live + 300],
                                   v[:1, :live + 300]),
        f"batch_{batch}": rows32(q[:, :32], k[:, :live], v[:, :live]),
        "second_launch": rows32(q[:1, :32], k[:1, :live], v[:1, :live]),
    }
    torch.cuda.synchronize()
    same = {nm: bits_equal(o, base[0]) and bits_equal(lse, base[1])
            for nm, (o, lse, _) in variants.items()}
    res = {"case": "fwd_invariance", "dtype": dtype, "H": H, "Hkv": Hkv,
           "D": D, "pos": pos, "batch": batch, "route": base[2],
           "routes": {nm: r for nm, (_, _, r) in variants.items()},
           "bit_equal": same}
    emit({"phase": "flash_fwd", **res})
    if not all(same.values()):
        raise AssertionError(f"flash_fwd invariance {dtype} H{H}/{Hkv} D{D}: "
                             f"{same}")
    return res


def decode_case(timer, name, B, S, H, Hkv, D, pos, dtype, quant, seed):
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from byteps_tpu_torch.models.generate import _quantize_block
    from byteps_tpu_torch.ops.flash_decode import decode_torch, flash_decode

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, 1, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
    ks = vs = None
    if quant:
        k, ks = _quantize_block(k)
        v, vs = _quantize_block(v)
    o = flash_decode(q, k, v, pos, ks, vs)
    o_ref = decode_torch(q, k, v, pos, ks, vs)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    err, ok = max_err(o, o_ref, tol)
    if not ok:
        raise AssertionError(f"flash_decode {name}: err {err} beyond "
                             f"tolerance {tol}")
    ms = timer(lambda: flash_decode(q, k, v, pos, ks, vs))
    plain_ms = timer(lambda: decode_torch(q, k, v, pos, ks, vs))
    lib_ms = None
    if not quant:       # no one library call dequantizes int8 and attends
        live = pos + 1
        qt = q.transpose(1, 2).contiguous()
        kt = k[:, :live].repeat_interleave(H // Hkv, 2).transpose(1, 2) \
            .contiguous()
        vt = v[:, :live].repeat_interleave(H // Hkv, 2).transpose(1, 2) \
            .contiguous()
        lib_ms = timer(lambda: sdpa(qt, kt, vt))
    live = pos + 1
    isz = q.element_size()
    n_bytes = (2 * B * H * D * isz + 2 * B * live * Hkv * D * k.element_size()
               + (2 * B * live * Hkv * 4 if quant else 0))
    n_ops = 4 * D * live * B * H
    bms, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"case": name, "dtype": str(dtype).split(".")[-1],
           "cache": "int8" if quant else "dense",
           "shape": [B, S, H, Hkv, D], "pos": pos, "max_abs_err": err,
           "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bms, "bound_by": by}
    emit({"phase": "flash_decode", **res})
    return res


def decode_twice_case(name, B, S, H, Hkv, D, pos, quant, seed):
    """Two launches of the decode kernel on the same bf16 inputs give the
    same bits: the split plan depends only on the shapes, the splits
    merge in a fixed order and each output element has one writer."""
    from byteps_tpu_torch.models.generate import _quantize_block
    from byteps_tpu_torch.ops.flash_decode import flash_decode

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, 1, H, D, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    ks = vs = None
    if quant:
        k, ks = _quantize_block(k)
        v, vs = _quantize_block(v)
    a, b = (flash_decode(q, k, v, pos, ks, vs) for _ in range(2))
    torch.cuda.synchronize()
    same = torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    res = {"case": name, "shape": [B, S, H, Hkv, D], "pos": pos,
           "cache": "int8" if quant else "dense", "bit_equal": same}
    emit({"phase": "flash_determinism", **res})
    if not same:
        raise AssertionError(f"flash_decode {name}: two launches differ")
    return res


# (name, B, S, H, Hkv, D, pos, dtype, quant, seed): the main path's
# generate step first, the long case (B=8, pos 1023, dense bf16) second
DECODE_CASES = (
    [("main_path", 4, 1024, 16, 16, 64, 160, torch.bfloat16, False, 20),
     ("b8", 8, 1024, 16, 16, 64, 1023, torch.bfloat16, False, 21)]
    + [("b8", 8, 1024, 16, 16, 64, pos, torch.bfloat16, quant, 21)
       for pos in (0, 100, 700, 1023) for quant in (False, True)
       if (pos, quant) != (1023, False)]
    + [(nm, 8, 1024, 16, Hkv, 64, 700, dt, quant, seed)
       for quant in (False, True)
       for nm, Hkv, dt, seed in (("b8", 16, torch.float32, 22),
                                 ("gqa", 4, torch.bfloat16, 23))]
    # the most splits (B=1), the tile edges, and the long case's bytes
    # and grid with one kv head, whose cache rows lie side by side
    + [("b1", 1, 1024, 16, 16, 64, 1023, torch.bfloat16, False, 24),
       ("tile_edge", 4, 1024, 16, 16, 64, 31, torch.bfloat16, False, 25),
       ("tile_edge", 4, 1024, 16, 16, 64, 32, torch.bfloat16, False, 25),
       ("one_head", 128, 1024, 1, 1, 64, 1023, torch.bfloat16, False, 28)]
    # other head dims: 128 with GQA over int8; 256 in f32 beside 16 query
    # heads a kv head (one staged tile a warp fits); 36, whose rows are
    # no whole number of 16-byte vectors
    + [("d128_gqa", 4, 1024, 16, 4, 128, 700, torch.bfloat16, True, 29),
       ("d256_gqa16", 2, 600, 16, 1, 256, 599, torch.float32, False, 30),
       ("d36", 3, 333, 6, 3, 36, 332, torch.bfloat16, False, 31)])
DECODE_TWICE = (("b8", 8, 1024, 16, 16, 64, 1023, False, 26),
                ("b8", 8, 1024, 16, 16, 64, 1023, True, 27))


def grad_err(got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    """How far a kernel's gradient lies from its plain version, held two
    ways: each element to |got - want| <= BWD_ATOL * max|want| + tol *
    |want| (the floor is a thousandth of the largest entry, far below the
    typical one, so a kernel wrong on a share of rows or keys fails), and
    the whole to ||got - want|| / ||want|| <= BWD_REL_L2."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    top = float(w.abs().max())
    floor = BWD_ATOL * top
    # the worst element's use of its allowance (<= 1 passes)
    worst = float((d / (floor + tol * w.abs())).max()) if top else 0.0
    rel_l2 = float(d.norm() / w.norm()) if top else float(d.norm())
    return {"max_abs_err": float(d.max()), "max_abs": top,
            "rms": float(w.pow(2).mean().sqrt()), "rel_l2": rel_l2,
            "worst_share": worst,
            "ok": worst <= 1.0 and rel_l2 <= BWD_REL_L2[want.dtype]}


def bwd_case(timer, name, B, Sq, Sk, H, Hkv, D, q_off, k_off, dtype, seed,
             with_dlse=False, causal=True):
    """dq and dk/dv from the kernels against ``flash_bwd_torch``, each
    held by :func:`grad_err`; rows with no live key must get dq = 0
    exactly."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from byteps_tpu_torch.ops.flash_attention import (
        _dkv_cuda, _dq_cuda, attention_lse_torch, flash_bwd_torch)

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
    do = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
    dlse = (torch.randn(B, Sq, H, generator=g, device="cuda")
            if with_dlse else None)
    o, lse = attention_lse_torch(q, k, v, q_off, k_off, causal=causal)
    lse = lse.contiguous()
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, dlse, q_off, k_off, causal)
    dq = _dq_cuda(*args)
    dk, dv = _dkv_cuda(*args)
    want = flash_bwd_torch(q, k, v, o, lse, do, dlse, q_off, k_off, causal)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    stats = {nm: grad_err(got, ref, tol)
             for nm, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    if not all(s["ok"] for s in stats.values()):
        raise AssertionError(f"flash_bwd {name} {dtype}: beyond tolerance "
                             f"(rtol {tol}, floor {BWD_ATOL} x max, rel L2 "
                             f"{BWD_REL_L2[dtype]}): {stats}")
    errs = {nm: s["max_abs_err"] for nm, s in stats.items()}
    n_dead = min(Sq, max(0, k_off - q_off)) if causal else 0
    if n_dead and not bool((dq[:, :n_dead] == 0).all()):
        raise AssertionError(f"flash_bwd {name}: a row with no live key got "
                             "a nonzero dq")
    ms_dq = timer(lambda: _dq_cuda(*args))
    ms_dkv = timer(lambda: _dkv_cuda(*args))
    plain_ms = timer(lambda: flash_bwd_torch(q, k, v, o, lse, do, dlse,
                                             q_off, k_off, causal), iters=5)
    # the library yardstick: SDPA's backward for (dq, dk, dv) together,
    # from (B, H, S, D) leaves made outside the timing (k/v widened for
    # GQA), no lse cotangent
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt = k.repeat_interleave(H // Hkv, 2).transpose(1, 2).contiguous() \
        .requires_grad_()
    vt = v.repeat_interleave(H // Hkv, 2).transpose(1, 2).contiguous() \
        .requires_grad_()
    if not causal:
        ot = sdpa(qt, kt, vt)
    elif q_off == k_off and Sq == Sk:
        ot = sdpa(qt, kt, vt, is_causal=True)
    else:
        mask = (q_off + torch.arange(Sq, device="cuda")[:, None]
                >= k_off + torch.arange(Sk, device="cuda")[None, :])
        ot = sdpa(qt, kt, vt, attn_mask=mask)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = timer(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                               retain_graph=True))
    # the work this run's data needs: live (row, key) pairs, live keys
    pairs = (Sq * Sk if not causal else
             sum(min(Sk, max(0, q_off + i - k_off + 1)) for i in range(Sq)))
    kend = Sk if not causal else min(Sk, max(0, q_off + Sq - k_off))
    isz = q.element_size()
    row_f32 = B * Sq * H * 4 * (3 if with_dlse else 2)   # lse, Δ, dlse
    qo_bytes = B * Sq * H * D * isz
    kv_bytes = B * kend * Hkv * D * isz
    b_dq, by_dq = bound_ms(3 * qo_bytes + 2 * kv_bytes + row_f32,
                           6 * D * pairs * B * H, dtype)
    b_dkv, by_dkv = bound_ms(2 * qo_bytes + 4 * kv_bytes + row_f32,
                             8 * D * pairs * B * H, dtype)
    res = {"case": name, "dtype": str(dtype).split(".")[-1],
           "shape": [B, Sq, Sk, H, Hkv, D], "q_off": q_off, "k_off": k_off,
           "causal": causal, "dlse": with_dlse, "dead_rows": n_dead,
           "err": {nm: {k: v for k, v in s.items() if k != "ok"}
                   for nm, s in stats.items()},
           "tolerance": {"rtol": tol, "floor_of_max": BWD_ATOL,
                         "rel_l2": BWD_REL_L2[dtype]},
           "dq": {"ms": ms_dq, "bound_ms": b_dq, "bound_by": by_dq,
                  "max_abs_err": errs["dq"]},
           "dkv": {"ms": ms_dkv, "bound_ms": b_dkv, "bound_by": by_dkv,
                   "max_abs_err": max(errs["dk"], errs["dv"])},
           "plain_ms": plain_ms, "library_ms": lib_ms}
    emit({"phase": "flash_bwd", **res})
    return res


def twice_case(name, B, S, H, Hkv, D, seed, causal=True):
    """Two launches of the tensor-core forward and of the dq and dk/dv
    kernels on the same bf16 inputs give the same bits: every sum runs in
    a fixed order and each output element has one writer."""
    from byteps_tpu_torch.ops.flash_attention import (_dkv_cuda, _dq_cuda,
                                                      _fwd_cuda)

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(B, S, H, D, generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    runs = []
    for _ in range(2):
        o, lse = _fwd_cuda(q, k, v, 0, 0, causal)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta, None, 0, 0, causal)
        runs.append((o, lse, _dq_cuda(*args), *_dkv_cuda(*args)))
    torch.cuda.synchronize()
    same = {nm: torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            for nm, a, b in zip(("o", "lse", "dq", "dk", "dv"), *runs)}
    res = {"case": name, "shape": [B, S, S, H, Hkv, D], "causal": causal,
           "bit_equal": same}
    emit({"phase": "flash_determinism", **res})
    if not all(same.values()):
        raise AssertionError(f"flash {name}: two launches differ: {same}")
    return res


ATTN_SASS = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS", "SYNCS")
# the FMA kernels: no tensor cores and no atomics (ATOM, ATOMS, RED);
# cp.async (LDGSTS), shuffles, cluster barriers, FMAs and adds
FMA_SASS = ("HGMMA", "HMMA", "ATOM", "ATOMS", "RED", "LDGSTS", "SHFL",
            "UCGABAR_ARV", "UCGABAR_WAIT", "FFMA", "FADD")
# the codec kernels' arithmetic and memory instructions, and "ALL": every
# instruction (a line of cuobjdump's listing)
CODEC_SASS = ("FADD", "FSEL", "SEL", "LOP3", "SHF", "IMAD", "ISETP", "LDG",
              "LDS", "STG", "ALL")
SASS_ALL = r"/\*[0-9a-f]{4,}\*/\s+\S"


def sass_counts(lib, ops=ATTN_SASS) -> dict:
    """``{kernel: {op: count}}``: how many instructions of each kind in
    ``ops`` each kernel of a built library holds (``cuobjdump -sass``
    beside nvcc; kernels named as ``cu++filt`` demangles them, without
    their parameters). By default the kinds of the attention kernels:
    HGMMA (wgmma), HMMA (mma.sync), UTMALDG (TMA loads), LDGSTS
    (cp.async), SYNCS (mbarrier operations)."""
    from pathlib import Path

    from byteps_tpu_torch.ops import _build

    bin_dir = Path(_build.find_nvcc()).parent
    text = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    chunks = re.split(r"\n\s*Function : ", text)[1:]
    names = [c.split("\n", 1)[0].strip() for c in chunks]
    if (bin_dir / "cu++filt").is_file():
        names = subprocess.run([str(bin_dir / "cu++filt")], input="\n".join(
            names), capture_output=True, text=True, check=True,
            timeout=60).stdout.splitlines()
    out = {}
    for name, chunk in zip(names, chunks):
        name = re.sub(r"^(void )?(\(anonymous namespace\)::|<unnamed>::)?",
                      "", name)
        if "<" in name:   # up to the template's closing ">"
            depth, i = 0, name.index("<")
            for i in range(i, len(name)):
                depth += {"<": 1, ">": -1}.get(name[i], 0)
                if depth == 0:
                    break
            name = name[:i + 1]
        else:
            name = name.split("(", 1)[0]
        body = chunk.split("\n", 1)[1] if "\n" in chunk else ""
        out[name] = {op: len(re.findall(SASS_ALL if op == "ALL"
                                        else rf"\b{op}\b", body))
                     for op in ops}
    return out


# unpack-sum payload counts: timed, and checked only (the grid order's
# 8-row blocks cut at 33, 41 and 129 rows)
UNPACK_TIMED = (1, 2, 8, 32, 40, 256)
UNPACK_GRID_KS = (33, 40, 41, 64, 72, 129, 256)


def onebit_case(timer, name, n, seed, special=False):
    """Pack words bit-equal to the plain version; unpack-sum bit-equal
    (by bit pattern: -0.0 is not 0.0) at K = 1 (one card), 2 (train_ring's
    owner), 8 and 32 (the most the unrolled order takes), and at K = 33,
    40, 41, 129 and 256 in the grid order (timed at 40 and 256); the fold
    order is fixed, so equality is exact."""
    from byteps_tpu_torch.ops.onebit_kernels import (
        _pack_torch, _unpack_sum_torch, onebit_pack, onebit_unpack_sum,
        packed_words)

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=g, device="cuda")
    if special:
        x[0::7] = -0.0
        x[1::7] = 0.0
        x[2::7] = float("nan")
    words = onebit_pack(x)
    plain = _pack_torch(x)
    one = torch.ones(1, device="cuda")
    # the words' error in value space: +-1 per element as each decodes
    pack_err = float((_unpack_sum_torch(words[None], one, n)
                      - _unpack_sum_torch(plain[None], one, n)).abs().max())
    if not torch.equal(words, plain):
        raise AssertionError(f"onebit pack {name}: words differ from the "
                             f"plain version (max decoded err {pack_err})")
    L = packed_words(n)
    res = {"case": name, "n": n, "words": L, "special": special,
           "pack_bit_equal": True, "pack_max_abs_err": pack_err}
    if special:
        emit({"phase": "onebit", **res})
        return res
    res["pack_ms"] = timer(lambda: onebit_pack(x))
    res["pack_plain_ms"] = timer(lambda: _pack_torch(x))
    res["pack_bound_ms"], res["pack_bound_by"] = bound_ms(
        4 * n + 4 * L, 32 * L, torch.float32)
    for K in sorted(UNPACK_TIMED + (33, 41, 129)):
        if K <= 8:
            ws = torch.stack([onebit_pack(torch.randn(n, generator=g,
                                                      device="cuda"))
                              for _ in range(K)])
        else:
            ws = torch.randint(-2 ** 31, 2 ** 31 - 1, (K, L), generator=g,
                               device="cuda", dtype=torch.int32)
        sc = torch.rand(K, generator=g, device="cuda")
        out = onebit_unpack_sum(ws, sc, n)
        ref = _unpack_sum_torch(ws, sc, n)
        err = float((out - ref).abs().max())
        if not bits_equal(out, ref):
            raise AssertionError(f"onebit unpack_sum {name} K={K}: differs "
                                 f"from the plain version (max err {err})")
        res[f"unpack_k{K}_equal"] = True
        res[f"unpack_k{K}_max_abs_err"] = err
        if K not in UNPACK_TIMED:
            continue
        res[f"unpack_k{K}_ms"] = timer(lambda: onebit_unpack_sum(ws, sc, n))
        res[f"unpack_k{K}_plain_ms"] = timer(
            lambda: _unpack_sum_torch(ws, sc, n), iters=20 if K <= 8 else 5)
        res[f"unpack_k{K}_bound_ms"], res[f"unpack_k{K}_bound_by"] = \
            bound_ms(4 * K * L + 4 * K + 4 * n, 2 * K * n, torch.float32)
    emit({"phase": "onebit", **res})
    return res


def pack_unaligned_cases(timer) -> list:
    """The chunk (timed), n = 4097 and n = 33, each from a 4-byte offset."""
    return [pack_unaligned_case(timer, "chunk_unaligned", 4096000 // 4, 44,
                                timed=True),
            pack_unaligned_case(timer, "n4097_unaligned", 4097, 45),
            pack_unaligned_case(timer, "n33_unaligned", 33, 46)]


def pack_unaligned_case(timer, name, n, seed, timed=False):
    """Pack of an input that starts 4 bytes past an aligned address
    (``buf[1:n+1]``, so no 16-byte vector of it is aligned): words
    bit-equal to the plain version's; timed at the chunk."""
    from byteps_tpu_torch.ops.onebit_kernels import _pack_torch, onebit_pack

    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn(n + 1, generator=g, device="cuda")
    buf[1::11] = -0.0
    x = buf[1:n + 1]
    words = onebit_pack(x)
    if not torch.equal(words, _pack_torch(x)):
        raise AssertionError(f"onebit pack {name} (4-byte offset): words "
                             "differ from the plain version")
    res = {"case": name, "n": n, "offset_bytes": x.data_ptr() % 16,
           "pack_bit_equal": True}
    if timed:
        res["pack_ms"] = timer(lambda: onebit_pack(x))
    emit({"phase": "onebit", **res})
    return res


def unpack_edge_cases(seed=43):
    """Unpack-sum at the lengths that cut a row of words short (n = 1,
    31, 4097) and at an odd word count (L = 33, whose last column has no
    pair, n = 1055) for K = 1, 2, 8 and 32 and the grid order's K = 33,
    40, 41, 64, 72, 129 and 256, one payload's scale 0 (its terms add
    +-0.0): bit-equal to the plain version by bit pattern."""
    from byteps_tpu_torch.ops.onebit_kernels import (
        _unpack_sum_torch, onebit_unpack_sum, packed_words)

    g = torch.Generator(device="cuda").manual_seed(seed)
    checked = []
    for n, L in [(n, packed_words(n)) for n in (1, 31, 4097)] + [(1055, 33)]:
        for K in (1, 2, 8, 32) + UNPACK_GRID_KS:
            ws = torch.randint(-2 ** 31, 2 ** 31 - 1, (K, L), generator=g,
                               device="cuda", dtype=torch.int32)
            sc = torch.rand(K, generator=g, device="cuda")
            sc[K // 2] = 0.0
            out = onebit_unpack_sum(ws, sc, n)
            if not bits_equal(out, _unpack_sum_torch(ws, sc, n)):
                raise AssertionError(f"onebit unpack_sum n={n} L={L} K={K} "
                                     "(one zero scale): differs from the "
                                     "plain version")
            checked.append([n, L, K])
    emit({"phase": "onebit", "case": "unpack_edges", "checked": checked,
          "bit_equal": True})


def unpack_nonfinite_cases(seed=47):
    """Unpack-sum with one payload's scale NaN, or two payloads' scales
    inf (NaN where their bits differ, an inf of either sign where they
    agree), at the ragged 1,000,003 and K = 8, 40 and 256: the
    non-finite elements where the plain version has them (NaN and each
    sign of inf by position), every finite element bit-equal (every
    element takes each payload's term, so here none is finite). Whether
    the NaNs' bits agree too is reported (``all_bits_equal``), not
    required: ``bit ? s : -s`` and ``(2 bit - 1) * s`` may give NaNs of
    other signs."""
    from byteps_tpu_torch.ops.onebit_kernels import (
        _unpack_sum_torch, onebit_unpack_sum, packed_words)

    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 1_000_003
    L = packed_words(n)
    checked = []
    for K in (8, 40, 256):
        ws = torch.randint(-2 ** 31, 2 ** 31 - 1, (K, L), generator=g,
                           device="cuda", dtype=torch.int32)
        for bad in (float("nan"), float("inf")):
            sc = torch.rand(K, generator=g, device="cuda")
            sc[K // 3] = bad
            if bad == float("inf"):
                sc[2 * K // 3] = bad
            out = onebit_unpack_sum(ws, sc, n)
            ref = _unpack_sum_torch(ws, sc, n)
            fin = torch.isfinite(ref)
            same = (torch.equal(out.isnan(), ref.isnan())
                    and torch.equal(out == float("inf"), ref == float("inf"))
                    and torch.equal(out == -float("inf"),
                                    ref == -float("inf"))
                    and bits_equal(out[fin], ref[fin]))
            if not same:
                raise AssertionError(f"onebit unpack_sum K={K} with a "
                                     f"{bad} scale: differs from the plain "
                                     "version")
            checked.append({"K": K, "scale": str(bad),
                            "nan": int(ref.isnan().sum()),
                            "non_finite": int((~fin).sum()),
                            "all_bits_equal": bits_equal(out, ref)})
    emit({"phase": "onebit", "case": "unpack_nonfinite", "n": n,
          "checked": checked, "finite_bit_equal": True})


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit: -0.0 against 0.0 and NaN against NaN count."""
    as_int = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(as_int), b.contiguous().view(as_int))


def warm_ms(fn, calls: int = 200) -> dict:
    """Device ms a call of ``calls`` calls of ``fn`` issued back to back
    and one synchronize, the L2 cache not flushed (warm, as the main path
    meets these kernels). A sleep kernel holds the card while the host
    enqueues the calls, so the events see the kernels and the gaps between
    them; ``warm_host_ms`` (the enqueue, host clock) must stay below
    ``warm_sleep_ms`` (the sleep, device clock) for that to hold."""
    fn()
    e0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    e0.record()
    torch.cuda._sleep(50_000_000)          # cycles
    a.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) * 1e3
    b.record()
    torch.cuda.synchronize()
    return {"warm_ms": a.elapsed_time(b) / calls, "warm_host_ms": host,
            "warm_sleep_ms": e0.elapsed_time(a)}


def offset_view(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` that starts 4 bytes past an aligned address (no
    16-byte vector of it is aligned), same shape."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    return v


def topk_plan(tk, name: str, *shape) -> dict:
    """``tk.<name>(*shape)`` as a dict; on a tree before launch plans (a
    parent timed with ``scripts/torch_topk_tc.py --repo``), a stand-in
    that puts split_ties' block and thread strides 16 rows apart."""
    fn = getattr(tk, name, None)
    if fn is None:
        return {"width": 32, "cluster": 1, "rows": 16, "threads": 512,
                "blocks": None}
    return fn(*shape)._asdict()


def split_ties(x: torch.Tensor, L: int, S: int) -> None:
    """On the group-row axis (-2) of a (..., G, W) view whose groups a
    launch plan splits into blocks of L rows and threads S rows apart:
    equal maxima (+50 first, -50 second) 16, 32 and S rows apart, on both
    sides of a block boundary (rows L - 1 and L) and at the first and last
    row; +inf and -inf after a finite max (the first inf wins, its
    residual NaN); a column whose only non-zero is -0.0; an all-zero column
    led by -0.0 (index 0); a NaN column. Columns 0-9, where G allows."""
    G = x.shape[-2]
    pairs = [(1, 17), (3, 35), (5, 5 + S), (L - 1, L), (0, G - 1)]
    for c, (a, b) in enumerate(pairs):
        if 0 <= a < b < G:
            x[..., a, c] = 50.0
            x[..., b, c] = -50.0
    if G >= 5:
        x[..., 0, 5] = 50.0
        x[..., 2, 5] = float("inf")
        x[..., 4, 5] = float("-inf")
    x[..., :, 6] = 0.0
    x[..., G // 2, 6] = -0.0
    x[..., :, 7] = 0.0
    x[..., 0, 7] = -0.0
    x[..., G - 1, 8] = float("nan")
    x[..., 0, 9] = float("-inf")


def topk_select_case(timer, name, block, rows, n, seed, ties=False,
                     splits=False, offset=False, timed=True):
    """block_select against its plain version, bit for bit; returns the
    winners too. ``ties``: :func:`tie_rows`; ``splits``:
    :func:`split_ties` at the launch plan's block and thread strides;
    ``offset``: x starts 4 bytes past an aligned address."""
    from byteps_tpu_torch.ops import topk_kernels as tk

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(block, rows, generator=g, device="cuda")
    plan = topk_plan(tk, "select_plan", block, rows)
    if ties:
        tie_rows(x)
    if splits:
        split_ties(x, plan["rows"], plan["threads"] // 32)
    if offset:
        x = offset_view(x)
    block_select, _select_torch = tk.block_select, tk._select_torch
    lo, va = block_select(x, n)
    plo, pva = _select_torch(x, n)
    torch.cuda.synchronize()
    if not (torch.equal(lo, plo) and bits_equal(va, pva)):
        raise AssertionError(f"topk select {name}: differs from the plain "
                             "version")
    res = {"case": name, "shape": [block, rows], "n": n, "ties": ties,
           "splits": splits, "offset_bytes": x.data_ptr() % 16,
           "plan": plan, "bit_equal": True,
           "max_abs_err": float((va - pva).abs().max())}
    if timed:
        res["ms"] = timer(lambda: block_select(x, n))
        res.update(warm_ms(lambda: block_select(x, n)))
        res["plain_ms"] = timer(lambda: _select_torch(x, n))
        # two calls: abs, then max over the rows
        res["library_ms"] = timer(lambda: torch.max(x.abs(), 0))
        res["bound_ms"], res["bound_by"] = bound_ms(4 * n + 8 * rows, 2 * n,
                                                    torch.float32)
    emit({"phase": "topk_select", **res})
    return res, lo, va


def tie_rows(x: torch.Tensor) -> None:
    """Ties, zeros and NaN on the leading axis of (groups, g, 128) or
    (block, rows) views: rows 2 and 5 tie at |3| (2 must win), some
    columns all zero (index 0 wins), one holds a NaN (no winner), -0.0
    beside 0.0."""
    x[..., 2, :] = -3.0
    x[..., 5, :] = 3.0
    x[..., 0:64] = 0.0
    x[..., 3, 10] = -0.0
    x[..., 7, 70] = float("nan")


def topk_reconstruct_case(timer, name, lo, va, block, offset=False,
                          timed=True):
    """block_reconstruct_sum against its plain version, bit for bit;
    ``offset``: locals and values start 4 bytes past an aligned address
    (the kernel's 4-byte variant)."""
    from byteps_tpu_torch.ops import topk_kernels as tk

    block_reconstruct_sum = tk.block_reconstruct_sum
    _reconstruct_sum_torch = tk._reconstruct_sum_torch
    K, rows = lo.shape
    if offset:
        lo, va = offset_view(lo), offset_view(va)
    out = block_reconstruct_sum(lo, va, block)
    ref = _reconstruct_sum_torch(lo, va, block)
    torch.cuda.synchronize()
    if not bits_equal(out, ref):
        raise AssertionError(f"topk reconstruct {name} K={K}: differs from "
                             "the plain version")
    res = {"case": name, "K": K, "shape": [block, rows],
           "offset_bytes": lo.data_ptr() % 16,
           "plan": topk_plan(tk, "reconstruct_plan", K, block, rows),
           "bit_equal": True, "max_abs_err": float((out - ref).abs().max())}
    if timed:
        idx = lo.long().clamp(0, block - 1)  # no-winner lanes: in range
        res["ms"] = timer(lambda: block_reconstruct_sum(lo, va, block))
        res.update(warm_ms(lambda: block_reconstruct_sum(lo, va, block)))
        res["plain_ms"] = timer(
            lambda: _reconstruct_sum_torch(lo, va, block))
        # two calls: zeros, then scatter_add_
        res["library_ms"] = timer(
            lambda: torch.zeros(block, rows, device="cuda").scatter_add_(
                0, idx, va))
        res["bound_ms"], res["bound_by"] = bound_ms(
            8 * K * rows + 4 * block * rows, 2 * K * block * rows,
            torch.float32)
    emit({"phase": "topk_reconstruct", **res})
    return res


def recon_payloads(K, block, rows, seed):
    """K payloads' (locals, values) for (block, rows) as aggregation
    meets them: locals in [-1, block] (block: select's "no winner"; -1
    out of range), a third of the lanes with no winner, payload 1 hitting
    payload 0's slot on every other lane (and payload 2 on every fifth:
    three hits), -0.0 among the values."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lo = torch.randint(-1, block + 1, (K, rows), generator=g, device="cuda",
                       dtype=torch.int32)
    va = torch.randn(K, rows, generator=g, device="cuda")
    lo[:, 1::3] = block
    if K > 1:
        lo[1, ::2] = lo[0, ::2]
    if K > 2:
        lo[2, ::5] = lo[0, ::5]
    va[:, ::7] = -0.0
    return lo, va


def topk_roundtrip_case(timer, name, J, g_, with_e, seed, ties=False,
                        splits=False, offset=False, timed=True):
    """block_roundtrip against its plain version, dense and residual bit
    for bit. ``ties``: :func:`tie_rows`; ``splits``: :func:`split_ties`
    at the launch plan's block and thread strides; ``offset``: x and e
    start 4 bytes past an aligned address (the 4-byte-load variant)."""
    from byteps_tpu_torch.ops import topk_kernels as tk

    block_roundtrip, _roundtrip_torch = tk.block_roundtrip, tk._roundtrip_torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    N = J * g_ * 128
    x = torch.randn(N, generator=g, device="cuda")
    e = 0.1 * torch.randn(N, generator=g, device="cuda") if with_e else None
    plan = topk_plan(tk, "roundtrip_plan", J, g_)
    if ties:
        tie_rows(x.view(J, g_, 128))
    if splits:
        split_ties(x.view(J, g_, 128), plan["rows"],
                   plan["threads"] // plan["width"])
        if e is not None:     # the planted values (-0.0 too) survive the add
            e.view(J, g_, 128)[..., :10] = -0.0
    if offset:
        x = offset_view(x)
        e = None if e is None else offset_view(e)
    d, r = block_roundtrip(x, J, g_, e)
    pd, pr = _roundtrip_torch(x, J, g_, e)
    torch.cuda.synchronize()
    if not (bits_equal(d, pd) and bits_equal(r, pr)):
        raise AssertionError(f"topk roundtrip {name}: differs from the "
                             "plain version")
    res = {"case": name, "J": J, "g": g_, "with_e": with_e, "ties": ties,
           "splits": splits, "offset_bytes": x.data_ptr() % 16,
           "plan": plan, "bit_equal": True,
           "max_abs_err": float(max((d - pd).nan_to_num().abs().max(),
                                    (r - pr).nan_to_num().abs().max()))}
    if timed:
        res["ms"] = timer(lambda: block_roundtrip(x, J, g_, e))
        res.update(warm_ms(lambda: block_roundtrip(x, J, g_, e)))
        res["plain_ms"] = timer(lambda: _roundtrip_torch(x, J, g_, e))
        res["library_ms"] = None      # no one library call does this
        res["bound_ms"], res["bound_by"] = bound_ms(
            4 * N * (2 if with_e else 1) + 8 * N, N * (3 if with_e else 2),
            torch.float32)
    emit({"phase": "topk_roundtrip", **res})
    return res


# round trips of one 1,024,000-element chunk at other group heights
# (TopkCompressor k = 0.001 and k = 128), with e: timed
TOPK_TALL = [(8, 1000), (1, 8000)]
# (J, g) cases with split_ties, with e: odd and tall groups, one group row
# (2, 1), and (1, 8193), whose rows outgrow a cluster's registers (read
# twice)
TOPK_SPLITS = [(80, 100), (8, 1000), (1, 8000), (3, 257), (1, 600), (2, 1),
               (1, 8193)]


def topk_cases(timer) -> dict:
    """Each top-k kernel against its plain version at the training step's
    shapes and on the cases above; the main-path cases by kernel name."""
    chunk, tail = 1_024_000, 354_871_296 % 1_024_000      # GPT-2 medium
    _, lo, va = topk_select_case(timer, "chunk", 100, 10240, chunk, 50)
    tsel, tlo, tva = topk_select_case(timer, "tail", 101, 5617, tail, 51)
    topk_select_case(timer, "ties", 100, 10240, chunk, 52, ties=True,
                     timed=False)
    topk_select_case(timer, "tail_splits", 101, 5617, tail, 59, splits=True,
                     timed=False)
    topk_select_case(timer, "tall_splits", 1000, 1024, chunk, 60,
                     splits=True, timed=False)
    tsel["offset_ms"] = topk_select_case(timer, "tail_offset", 101, 5617,
                                         tail, 61, offset=True)[0]["ms"]
    rchunk = topk_reconstruct_case(timer, "chunk", lo[None], va[None], 100)
    trec = topk_reconstruct_case(timer, "tail", tlo[None], tva[None], 101)
    trec["offset_ms"] = topk_reconstruct_case(
        timer, "tail_offset", tlo[None], tva[None], 101, offset=True)["ms"]
    rchunk["offset_ms"] = topk_reconstruct_case(
        timer, "chunk_offset", lo[None], va[None], 100, offset=True)["ms"]
    g = torch.Generator(device="cuda").manual_seed(55)
    lo8 = torch.randint(0, 101, (8, 10240), generator=g, device="cuda",
                        dtype=torch.int32)
    va8 = torch.randn(8, 10240, generator=g, device="cuda")
    trec["k8_ms"] = topk_reconstruct_case(timer, "K8", lo8, va8, 100)["ms"]
    trec["chunk_ms"] = rchunk["ms"]
    # and one column of 600,000 rows (k = 1): more stripes than the grid
    for K, block, rows, seed in ((3, 101, 5617, 74), (8, 100, 10240, 75),
                                 (3, 100, 10240, 76), (1, 101, 5617, 77),
                                 (2, 600_000, 1, 79)):
        topk_reconstruct_case(timer, f"hits_K{K}_{block}x{rows}",
                              *recon_payloads(K, block, rows, seed), block,
                              timed=False)
    topk_reconstruct_case(timer, "hits_K3_tail_offset",
                          *recon_payloads(3, 101, 5617, 78), 101,
                          offset=True, timed=False)
    rt = topk_roundtrip_case(timer, "chunk_ef", 80, 100, True, 56)
    topk_roundtrip_case(timer, "chunk", 80, 100, False, 57)
    topk_roundtrip_case(timer, "ties", 80, 100, True, 58, ties=True,
                        timed=False)
    rt["tall"] = {}
    for i, (J, g_) in enumerate(TOPK_TALL):
        t = topk_roundtrip_case(timer, f"tall_{J}x{g_}", J, g_, True, 62 + i)
        rt["tall"][f"{J}x{g_}"] = {k: t[k] for k in ("ms", "warm_ms",
                                                     "bound_ms", "plan")}
    for i, (J, g_) in enumerate(TOPK_SPLITS):
        topk_roundtrip_case(timer, f"splits_{J}x{g_}", J, g_, True, 64 + i,
                            splits=True, timed=False)
    topk_roundtrip_case(timer, "splits_no_e", 3, 257, False, 71, splits=True,
                        timed=False)
    rt["offset_ms"] = topk_roundtrip_case(timer, "chunk_ef_offset", 80, 100,
                                          True, 72, offset=True)["ms"]
    topk_roundtrip_case(timer, "splits_offset", 1, 600, False, 73,
                        splits=True, offset=True, timed=False)
    return {"topk_select": tsel, "topk_reconstruct_sum": trec,
            "topk_roundtrip": rt}


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |v| (2^(e - 8) for |v| in [2^(e-1), 2^e))."""
    _, e = torch.frexp(v.float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def lora_case(timer, name, R, S, d_in, rb, d_out, dtype, seed, slots=None,
              n_slots=33):
    """The segmented LoRA kernel against its plain version on a layer's
    slice of pool-shaped slabs ((n_slots, 24, d_in, rb), strided, as the
    packed decode step hands them over), slot 0 all zero. f32: within
    LORA_F32_TOL of max |plain|; bf16: within one bf16 ulp of the plain
    version's f32 result, plus that f32 allowance (where the rank terms
    cancel to near 0, the two f32 sums differ by more than the result's
    own bf16 ulp). Rows on slot 0 must be exactly 0, and a second launch
    on the same inputs must give the same bits."""
    from byteps_tpu_torch.ops.segmented_lora import (delta_torch,
                                                     segmented_lora_delta)

    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(n_slots, 24, d_in, rb, generator=g, device="cuda")
    B = 0.02 * torch.randn(n_slots, 24, rb, d_out, generator=g,
                           device="cuda")
    A[0] = 0.0
    B[0] = 0.0
    a, b = A[:, 7], B[:, 7]
    if slots is None:           # mixed: slot 0, repeats, spread over the pool
        slots = torch.randint(0, n_slots, (R,), generator=g, device="cuda")
        slots[0] = 0
        slots[R // 2:] = slots[:R - R // 2].flip(0)
    slots = torch.as_tensor(slots).to(device="cuda", dtype=torch.int32)
    x = torch.randn(R, S, d_in, generator=g, device="cuda").to(dtype)
    out = segmented_lora_delta(x, a, b, slots)
    again = segmented_lora_delta(x, a, b, slots)
    plain = delta_torch(x, a, b, slots)
    plain32 = delta_torch(x.float(), a, b, slots)
    torch.cuda.synchronize()
    err = float((out.float() - plain.float()).abs().max())
    f32_tol = LORA_F32_TOL * float(plain32.abs().max())
    if dtype == torch.float32:
        tol = f32_tol
        ok = err <= tol
    else:
        ok = bool(((out.float() - plain32).abs()
                   <= bf16_ulp(plain32) + f32_tol).all())
        tol = f"1 bf16 ulp of the plain f32 result + {f32_tol:.3g}"
    zero = slots == 0
    twice = torch.equal(out.view(torch.uint8), again.view(torch.uint8))
    if not ok or not bool((out[zero] == 0).all()) or not twice:
        raise AssertionError(f"segmented_lora {name} {dtype}: err {err} "
                             f"(tolerance {tol}), slot-0 rows exactly 0: "
                             f"{bool((out[zero] == 0).all())}, two launches "
                             f"bit-equal: {twice}")
    ms = timer(lambda: segmented_lora_delta(x, a, b, slots))
    plain_ms = timer(lambda: delta_torch(x, a, b, slots))
    # the library yardstick: gather the rows' slabs, two bmm (f32), cast
    idx = slots.long()
    lib_ms = timer(lambda: torch.bmm(
        torch.bmm(x.float(), a.index_select(0, idx)),
        b.index_select(0, idx)).to(dtype))
    live = int(torch.unique(slots[~zero]).numel())
    n_bytes = (x.numel() * x.element_size() + 4 * R
               + live * 4 * (d_in * rb + rb * d_out)
               + R * S * d_out * x.element_size())
    # f32 FMAs of the rows off slot 0 (slot 0 needs none)
    n_ops = 2 * int((~zero).sum()) * S * (d_in * rb + rb * d_out)
    bms, by = bound_ms(n_bytes, n_ops, torch.float32)
    res = {"case": name, "dtype": str(dtype).split(".")[-1],
           "shape": [R, S, d_in, rb, d_out], "n_slots": n_slots,
           "live_slots": live, "slot0_rows": int(zero.sum()),
           "max_abs_err": err, "max_abs": float(plain32.abs().max()),
           "tolerance": tol, "slot0_exact": True,
           "two_launches_bit_equal": True, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
           "bound_by": by}
    emit({"phase": "segmented_lora", **res})
    return res


def lora_invariance_case(d_in, rb, d_out, seed):
    """A row computed alone (R = 1), inside R = 16 and on a one-slot view
    (as ``lora_delta`` calls the kernel) is bit for bit the same, for a
    decode row and a 64-row prefill chunk and its 1- and 7-row parts."""
    from byteps_tpu_torch.ops.segmented_lora import segmented_lora_delta

    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(33, 24, d_in, rb, generator=g, device="cuda")
    B = 0.02 * torch.randn(33, 24, rb, d_out, generator=g, device="cuda")
    a, b = A[:, 3], B[:, 3]
    slots = torch.randint(1, 33, (16,), generator=g, device="cuda",
                          dtype=torch.int32)
    zero1 = torch.zeros(1, dtype=torch.int32, device="cuda")
    checked = 0
    for dtype in (torch.bfloat16, torch.float32):
        for S in (1, 64):
            x = torch.randn(16, S, d_in, generator=g, device="cuda").to(dtype)
            full = segmented_lora_delta(x, a, b, slots)
            for r in (0, 9, 15):
                s = int(slots[r])
                alone = segmented_lora_delta(x[r:r + 1], a, b, slots[r:r + 1])
                one = segmented_lora_delta(x[r:r + 1], a[s][None].contiguous(),
                                           b[s][None].contiguous(), zero1)
                parts = [(0, S)] if S == 1 else [(0, 1), (5, 12), (57, 64)]
                for lo, hi in parts:
                    part = segmented_lora_delta(x[r:r + 1, lo:hi], a, b,
                                                slots[r:r + 1])
                    if not torch.equal(part[0], full[r, lo:hi]):
                        raise AssertionError(
                            f"segmented_lora {d_in}->{rb}->{d_out}: rows "
                            f"{lo}:{hi} differ from the full chunk")
                if not (torch.equal(alone, full[r:r + 1])
                        and torch.equal(one, full[r:r + 1])):
                    raise AssertionError(
                        f"segmented_lora {d_in}->{rb}->{d_out}: a row alone "
                        "or on a one-slot view differs from R=16")
                checked += 1
    emit({"phase": "segmented_lora", "case": "batch_invariance",
          "shape": [d_in, rb, d_out], "rows_checked": checked,
          "bit_equal": True})


# (name, R, S, d_in, rank bucket, d_out, dtype, seed[, slots]): the packed
# decode shape first (the kernels line's), a 64-row prefill chunk, w2's
# 4096 -> 8 -> 1024, rank 64, mostly slot 0, then the edges: a d_in that
# the cluster's warps do not split evenly (1000, 36), ranks below and
# above a bucket (1, 3, 33), 17 positions a row, a d_out that is not a
# multiple of 4 (no vector access lines up), a block's columns past what
# it stages in shared memory (rank 64, d_out 4096), and generate's prefill
# through ``lora_delta`` (B=4, T=128 on one adapter: 512 blocks)
LORA_CASES = (
    ("decode", 16, 1, 1024, 8, 1024, torch.bfloat16, 60),
    ("decode", 16, 1, 1024, 8, 1024, torch.float32, 61),
    ("prefill_chunk", 1, 64, 1024, 8, 1024, torch.bfloat16, 62, [5]),
    ("w2", 16, 1, 4096, 8, 1024, torch.bfloat16, 63),
    ("rank64", 16, 1, 1024, 64, 1024, torch.bfloat16, 64),
    ("rank64", 16, 1, 1024, 64, 1024, torch.float32, 65),
    ("slot0", 16, 1, 1024, 8, 1024, torch.bfloat16, 66,
     [0] * 12 + [3, 0, 7, 0]),
    ("d_in1000", 16, 1, 1000, 8, 1024, torch.bfloat16, 68),
    ("d_in36", 16, 1, 36, 8, 1024, torch.bfloat16, 69),
    ("rank1", 16, 1, 1024, 1, 1024, torch.bfloat16, 70),
    ("rank3", 16, 1, 1024, 3, 1024, torch.bfloat16, 71),
    ("rank33", 16, 1, 1024, 33, 1024, torch.bfloat16, 72),
    ("rank33", 16, 1, 1024, 33, 1024, torch.float32, 73),
    ("S17", 4, 17, 1024, 8, 1024, torch.bfloat16, 74),
    ("ragged_all", 4, 17, 1000, 3, 1001, torch.float32, 75),
    ("rank64_d4096", 4, 1, 1024, 64, 4096, torch.float32, 78),
    ("solo_prefill", 4, 128, 1024, 8, 1024, torch.bfloat16, 79, [5] * 4),
)
# (d_in, rank bucket, d_out, seed): packed decode, w2, rank 64
LORA_INVARIANCE = ((1024, 8, 1024, 67), (4096, 8, 1024, 76),
                   (1024, 64, 1024, 77))


def lora_cases(timer) -> dict:
    """Every case of the segmented LoRA kernel; the decode case (the
    packed decode step's shape) for the kernels line."""
    res = [lora_case(timer, *case) for case in LORA_CASES]
    for case in LORA_INVARIANCE:
        lora_invariance_case(*case)
    return res[0]


# The row-parallel arm's halves (``lora_down``, ``lora_up``) at generate's
# calls of a grafted wo and w2 under tp2 on GPT-2 medium, rank 8, one slot
# (as ``lora_delta`` calls them): wo's 512 local input rows, w2's 2,048, a
# decode step (R = B = 4, S = 1) and the prefill (S = 128).
# (name, R, S, d_in, d_out, dtype, seed)
LORA_HALF_CASES = (
    ("wo_decode", 4, 1, 512, 1024, torch.bfloat16, 80),
    ("wo_decode", 4, 1, 512, 1024, torch.float32, 81),
    ("w2_decode", 4, 1, 2048, 1024, torch.bfloat16, 82),
    ("w2_decode", 4, 1, 2048, 1024, torch.float32, 83),
    ("wo_prefill", 4, 128, 512, 1024, torch.bfloat16, 84),
    ("w2_prefill", 4, 128, 2048, 1024, torch.float32, 85))
# down + up at one rank against the fused launch, the whole wo and w2:
# (name, R, S, d_in, d_out, seed)
LORA_SPLIT_TP1 = (("wo_decode", 4, 1, 1024, 1024, 86),
                  ("w2_decode", 4, 1, 4096, 1024, 87),
                  ("wo_prefill", 4, 128, 1024, 1024, 88),
                  ("w2_prefill", 4, 128, 4096, 1024, 89))
LORA_TP_RANK = 8


def lora_half_case(timer, name, R, S, d_in, d_out, dtype, seed,
                   rb=LORA_TP_RANK) -> dict:
    """The down and the up launch against ``down_torch`` and ``up_torch``
    on the same inputs (the up half from the kernel's own ``u``), under
    the segmented kernel's tolerances (f32 LORA_F32_TOL of max; bf16 one
    ulp of the plain f32 result plus that), timed, bounded, and beside
    one ``index_select`` and one ``bmm`` (f32) each: the library's
    gather-and-multiply of the same half."""
    from byteps_tpu_torch.ops.segmented_lora import (down_torch, lora_down,
                                                     lora_up, up_torch)

    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(1, d_in, rb, generator=g, device="cuda")
    b = 0.02 * torch.randn(1, rb, d_out, generator=g, device="cuda")
    slots = torch.zeros(R, dtype=torch.int32, device="cuda")
    x = torch.randn(R, S, d_in, generator=g, device="cuda").to(dtype)
    u = lora_down(x, a, b, slots)
    u_plain = down_torch(x, a, slots)
    out = lora_up(u, a, b, slots, dtype)
    plain32 = up_torch(u, b, slots, torch.float32)
    torch.cuda.synchronize()
    down_err = float((u - u_plain).abs().max())
    down_tol = LORA_F32_TOL * float(u_plain.abs().max())
    up_err = float((out.float() - plain32).abs().max())
    f32_tol = LORA_F32_TOL * float(plain32.abs().max())
    if dtype == torch.float32:
        up_ok, up_tol = up_err <= f32_tol, f32_tol
    else:
        up_ok = bool(((out.float() - plain32).abs()
                      <= bf16_ulp(plain32) + f32_tol).all())
        up_tol = f"1 bf16 ulp of the plain f32 result + {f32_tol:.3g}"
    if down_err > down_tol or not up_ok:
        raise AssertionError(f"segmented_lora halves {name} {dtype}: down "
                             f"err {down_err} (tolerance {down_tol}), up err "
                             f"{up_err} (tolerance {up_tol})")
    idx = slots.long()
    es = x.element_size()
    res = {"case": name, "dtype": str(dtype).split(".")[-1],
           "shape": [R, S, d_in, rb, d_out], "down_max_abs_err": down_err,
           "down_tolerance": down_tol, "up_max_abs_err": up_err,
           "up_tolerance": up_tol,
           "down_ms": timer(lambda: lora_down(x, a, b, slots)),
           "down_plain_ms": timer(lambda: down_torch(x, a, slots)),
           "down_library_ms": timer(lambda: torch.bmm(
               x.float(), a.index_select(0, idx))),
           "up_ms": timer(lambda: lora_up(u, a, b, slots, dtype)),
           "up_plain_ms": timer(lambda: up_torch(u, b, slots, dtype)),
           "up_library_ms": timer(lambda: torch.bmm(
               u, b.index_select(0, idx)).to(dtype))}
    res["down_bound_ms"], res["down_bound_by"] = bound_ms(
        R * S * d_in * es + 4 * R + 4 * d_in * rb + 4 * R * S * rb,
        2 * R * S * d_in * rb, torch.float32)
    res["up_bound_ms"], res["up_bound_by"] = bound_ms(
        4 * R * S * rb + 4 * R + 4 * rb * d_out + R * S * d_out * es,
        2 * R * S * rb * d_out, torch.float32)
    emit({"phase": "segmented_lora_halves", **res})
    return res


def lora_split_tp1_case(name, R, S, d_in, d_out, seed,
                        rb=LORA_TP_RANK) -> dict:
    """At one rank the down launch, then the up launch on its ``u``, give
    the fused launch's bits (f32 and bf16): the same products summed in
    the same order."""
    from byteps_tpu_torch.ops.segmented_lora import (lora_down, lora_up,
                                                     segmented_lora_delta)

    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(1, d_in, rb, generator=g, device="cuda")
    b = 0.02 * torch.randn(1, rb, d_out, generator=g, device="cuda")
    slots = torch.zeros(R, dtype=torch.int32, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(R, S, d_in, generator=g, device="cuda").to(dtype)
        fused = segmented_lora_delta(x, a, b, slots)
        split = lora_up(lora_down(x, a, b, slots), a, b, slots, dtype)
        if not torch.equal(fused.view(torch.uint8), split.view(torch.uint8)):
            raise AssertionError(
                f"segmented_lora {name} {dtype}: down + up at one rank "
                "differs from the fused launch")
    res = {"case": name, "shape": [R, S, d_in, rb, d_out],
           "dtypes": ["bfloat16", "float32"], "bit_equal_to_fused": True}
    emit({"phase": "segmented_lora_split_tp1", **res})
    return res


def lora_half_cases(timer) -> dict:
    """The halves' cases and the one-rank split's: {"halves": [...],
    "split_tp1": [...]}; the first half case is the kernels line's."""
    return {"halves": [lora_half_case(timer, *c) for c in LORA_HALF_CASES],
            "split_tp1": [lora_split_tp1_case(*c) for c in LORA_SPLIT_TP1]}


# --------------------------------------------------------------------------
# phases 4-9: the main path
# --------------------------------------------------------------------------
def phase_generate(params, cfg, B=4, T0=128, max_new=64):
    from byteps_tpu_torch.models import make_generate_fn

    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (B, T0)).astype(np.int32)
    gen = make_generate_fn(cfg, max_new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = gen(params, prompt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = out.cpu().numpy()
    if out.shape != (B, T0 + max_new):
        raise AssertionError(f"generate returned {out.shape}")
    if not (out[:, :T0] == prompt).all():
        raise AssertionError("generate changed the prompt")
    if out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError("generated token outside the vocabulary")
    emit({"phase": "generate", "batch": B, "prompt": T0,
          "max_new": max_new, "wall_s": wall,
          "new_tokens_per_s": B * max_new / wall})


def phase_serve(params, cfg, max_new=32):
    from byteps_tpu_torch.common.metrics import get_registry, reset_registry
    from byteps_tpu_torch.serve import Request, Scheduler

    reset_registry()
    rng = np.random.default_rng(1)
    lens = np.linspace(40, 700, 8).astype(int)
    reqs = [Request(rid=f"r{i}", prompt=rng.integers(
                0, cfg.vocab_size, n).astype(np.int32), max_new=max_new)
            for i, n in enumerate(lens)]
    sched = Scheduler(params, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sched.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        got = res[r.rid]["tokens"]
        if len(got) != len(r.prompt) + max_new or not (
                got[:len(r.prompt)] == r.prompt).all():
            raise AssertionError(f"request {r.rid} returned {len(got)} "
                                 "tokens or changed its prompt")
    leaked = sched.cache.leaked_blocks()
    if leaked:
        raise AssertionError(f"{leaked} KV blocks leaked")
    snap = get_registry().snapshot("serve.")
    emit({"phase": "serve", "requests": len(reqs),
          "prompt_lens": lens.tolist(), "max_new": max_new,
          "block_size": sched.cache.block_size,
          "prefill_chunk": sched.prefill_chunk,
          "max_batch": sched.max_batch,
          "pool_blocks": sched.cache.pool_blocks, "wall_s": wall,
          "new_tokens_per_s": len(reqs) * max_new / wall,
          "prompt_tokens_per_s": int(lens.sum()) / wall,
          "ttft_ms": snap["histograms"]["serve.ttft_ms"],
          "token_ms": snap["histograms"]["serve.token_ms"],
          "iterations": snap["counters"]["serve.iterations"],
          "leaked_blocks": leaked})
    del sched


def phase_exact(params, cfg32):
    from byteps_tpu_torch.models import make_generate_fn
    from byteps_tpu_torch.serve import Request, Scheduler

    rng = np.random.default_rng(2)
    reqs = [Request(rid=f"x{i}", prompt=rng.integers(
                0, cfg32.vocab_size, n).astype(np.int32), max_new=16)
            for i, n in enumerate((50, 200, 333))]
    sched = Scheduler(params, cfg32)
    res = sched.serve(reqs)
    gen = make_generate_fn(cfg32, 16)
    for r in reqs:
        solo = gen(params, r.prompt[None]).cpu().numpy()[0]
        if not np.array_equal(res[r.rid]["tokens"], solo):
            raise AssertionError(
                f"f32 serve tokens of {r.rid} differ from solo generate:\n"
                f"{res[r.rid]['tokens'][-16:]}\n{solo[-16:]}")
    del sched
    emit({"phase": "exact", "f32_serve_equals_solo": True,
          "requests": [len(r.prompt) for r in reqs]})


# filled by phase_multitenant: the forward calls (packed decode steps and
# prefill chunks of adapter-tagged requests) whose every layer must launch
# the segmented LoRA kernel once per pooled target
MT_CALLS = {}
MT_TARGETS = ("wq", "wv")


def mt_adapters(cfg, n, ranks, seed, b_std=0.02):
    """n adapters as in the reference bench's race (``bench.py:1326-1376``):
    targets wq/wv, a ~ N(0, 1/rank), b = b_std·N(0, 1) (0.02 there) so
    every adapter changes the outputs, from seeded card generators."""
    from byteps_tpu_torch.models.lora import lora_init

    out = []
    for j in range(n):
        g = torch.Generator(device="cuda").manual_seed(seed + j)
        ad = lora_init(cfg, ranks[j % len(ranks)], MT_TARGETS, generator=g)
        for blk in ad["blocks"]:
            for ab in blk.values():
                ab["b"] = b_std * torch.randn(ab["b"].shape, generator=g,
                                              device="cuda")
        out.append(ad)
    return out


def counting(calls: list, fn, only_grafted: bool):
    """Wrap a scheduler's decode or prefill callable to count its calls
    (``only_grafted``: only those on a grafted tree)."""
    def wrapped(params, *args, **kw):
        if not only_grafted or "lora" in params["blocks"][0]:
            calls.append(1)
        return fn(params, *args, **kw)
    return wrapped


def phase_multitenant(params, cfg, n=32, max_new=16):
    """The reference bench's multi-tenant race at GPT-2 medium width,
    bf16: 32 adapters (ranks 2/4/8, one tenant each) in a 33-slot pool
    (rank bucket 8), 32 requests with prompts of 16/64/128 tokens and
    ``max_new`` new tokens each, max_batch 16, prefill chunk 64. The
    multiplexed pass serves them all from one Scheduler; the dedicated
    pass runs one Scheduler per tenant on its grafted tree. Hard limits:
    no leaked KV block or adapter slot, refcounts clean. Tokens of the
    two passes are compared and reported, not required equal (bf16)."""
    from byteps_tpu_torch.common.metrics import get_registry, reset_registry
    from byteps_tpu_torch.serve import AdapterPool, Request, Scheduler

    reset_registry()
    pool = AdapterPool(cfg, n_slots=n + 1, rank_bucket=8,
                       targets=MT_TARGETS)
    for j, ad in enumerate(mt_adapters(cfg, n, (2, 4, 8), 1000)):
        pool.register(f"a{j}", ad)
    rng = np.random.default_rng(5)
    lens = [(16, 64, 128)[j % 3] for j in range(n)]
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in lens]
    kw = dict(max_batch=16, prefill_chunk=64)
    calls = []

    def instrument(sched):
        # a pooled decode step adds the deltas whatever its rows; a
        # prefill chunk only on an adapter's grafted tree
        sched._decode = counting(calls, sched._decode,
                                 sched.adapter_pool is None)
        sched._prefill = counting(calls, sched._prefill, True)
        return sched

    sched = instrument(Scheduler(params, cfg, adapter_pool=pool, **kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mux = sched.serve([Request(rid=j, prompt=p, max_new=max_new,
                               tenant=f"t{j}", adapter=f"a{j}")
                       for j, p in enumerate(prompts)])
    torch.cuda.synchronize()
    mux_s = time.perf_counter() - t0
    if sched.cache.leaked_blocks() or pool.leaked_slots():
        raise AssertionError(f"multiplexed pass leaked "
                             f"{sched.cache.leaked_blocks()} KV blocks, "
                             f"{pool.leaked_slots()} adapter slots")
    pool.check_refcounts()
    snap = get_registry().snapshot("serve.")
    mux_steps = len(calls)
    del sched
    t0 = time.perf_counter()
    ded = {}
    for j, p in enumerate(prompts):
        one = instrument(Scheduler(pool.graft(params, f"a{j}"), cfg, **kw))
        ded.update(one.serve([Request(rid=j, prompt=p, max_new=max_new)]))
        if one.cache.leaked_blocks():
            raise AssertionError(f"dedicated pass {j} leaked KV blocks")
        del one
    torch.cuda.synchronize()
    ded_s = time.perf_counter() - t0
    equal, first_diff = 0, None
    for j, p in enumerate(prompts):
        a, b = mux[j]["tokens"], ded[j]["tokens"]
        if len(a) != len(p) + max_new or not (a[:len(p)] == p).all():
            raise AssertionError(f"tenant {j}: bad multiplexed output")
        if np.array_equal(a, b):
            equal += 1
        else:
            pos = int(np.flatnonzero(a != b)[0]) - len(p)
            first_diff = pos if first_diff is None else min(first_diff, pos)
    MT_CALLS["multitenant"] = len(calls)
    new = n * max_new
    emit({"phase": "multitenant", "adapters": n, "n_slots": n + 1,
          "rank_bucket": 8, "ranks": [2, 4, 8], "targets": list(MT_TARGETS),
          "prompt_lens": sorted(set(lens)), "max_new": max_new, **kw,
          "multiplexed_s": mux_s, "multiplexed_new_tokens_per_s": new / mux_s,
          "dedicated_s": ded_s, "dedicated_new_tokens_per_s": new / ded_s,
          "speedup": ded_s / mux_s,
          "multiplexed_forward_calls": mux_steps,
          "dedicated_forward_calls": len(calls) - mux_steps,
          "tenants_equal": equal, "first_diff_position": first_diff,
          "adapter_loads": snap["counters"].get("serve.adapter_loads", 0),
          "ttft_ms": snap["histograms"]["serve.ttft_ms"],
          "leaked_blocks": 0, "leaked_slots": 0})


def phase_multitenant_exact(params, cfg32):
    """f32 at GPT-2 medium width: 4 tenants (ranks 2/4/8, one with scale
    1.5, b = 0.1·N(0, 1)) and a base-model tenant through one pooled
    Scheduler; each
    tenant's tokens must equal a solo ``make_generate_fn`` run on its
    grafted tree (the base tenant's on the base)."""
    from byteps_tpu_torch.models import make_generate_fn
    from byteps_tpu_torch.serve import AdapterPool, Request, Scheduler

    pool = AdapterPool(cfg32, n_slots=5, rank_bucket=8, targets=MT_TARGETS)
    for j, (ad, scale) in enumerate(zip(
            mt_adapters(cfg32, 4, (2, 4, 8, 8), 2000, b_std=0.1),
            (1.0, 1.0, 1.0, 1.5))):
        pool.register(f"a{j}", ad, scale=scale)
    rng = np.random.default_rng(6)
    aids = ["a0", "a1", "a2", "a3", None]
    reqs = [Request(rid=f"m{j}", prompt=rng.integers(
                0, cfg32.vocab_size, n).astype(np.int32), max_new=16,
                tenant=f"t{j}", adapter=aid)
            for j, (aid, n) in enumerate(zip(aids, (50, 200, 333, 97, 120)))]
    sched = Scheduler(params, cfg32, adapter_pool=pool, max_batch=4,
                      prefill_chunk=64)
    res = sched.serve(reqs)
    gen = make_generate_fn(cfg32, 16)
    changed = 0
    for r in reqs:
        tree = params if r.adapter is None else pool.graft(params, r.adapter)
        solo = gen(tree, r.prompt[None]).cpu().numpy()[0]
        if not np.array_equal(res[r.rid]["tokens"], solo):
            raise AssertionError(
                f"f32 pooled tokens of {r.rid} (adapter {r.adapter}) differ "
                f"from its solo run:\n{res[r.rid]['tokens'][-16:]}\n"
                f"{solo[-16:]}")
        if r.adapter is not None:
            base = gen(params, r.prompt[None]).cpu().numpy()[0]
            changed += not np.array_equal(solo, base)
    if sched.cache.leaked_blocks() or pool.leaked_slots():
        raise AssertionError("multitenant_exact leaked blocks or slots")
    pool.check_refcounts()
    del sched
    emit({"phase": "multitenant_exact", "f32_pooled_equals_solo": True,
          "tenants": len(reqs), "adapters_changing_tokens": changed,
          "prompt_lens": [len(r.prompt) for r in reqs]})


# --------------------------------------------------------------------------
# speculative decoding and the rest of serving
# --------------------------------------------------------------------------
SPEC_K = 4                 # bench.py:894's spec_len
SPEC_DRAFT_LAYERS = 4
# the verify chunk's shapes: K rows at pos0 in a dense B=4 cache of 1,024
# positions (the samplers), and a paged request's K rows at pos0 160
# against its table's 16 blocks of 16 keys (the scheduler's lane)
VERIFY_CASES = (("verify_dense_128", 4, SPEC_K, 1024, 128, 60),
                ("verify_dense_160", 4, SPEC_K, 1024, 160, 61),
                ("verify_paged_160", 1, SPEC_K, 256, 160, 62))
FLASH_KEYS = ("flash_fwd", "flash_fwd_split", "flash_decode")


def verify_cases(timer) -> list:
    return [fwd_case(timer, name, B, Sq, Sk, 16, 16, 64, pos0, dt, seed)
            for name, B, Sq, Sk, pos0, seed in VERIFY_CASES
            for dt in (torch.bfloat16, torch.float32)]


def fwd_is_split(B, Sq, cfg) -> bool:
    """The route a (B, Sq) forward of these serving paths is known to
    take at GPT-2 medium width, held as constants rather than asked of
    the library: the B=4 bf16 prefills of 128 tokens fill the card and
    take wgmma; a verify round (B=4, ``SPEC_K`` rows), a one-request
    paged chunk or draft prefill of up to 128 rows, and every f32
    forward take the split path. Any other shape fails."""
    if cfg.dtype == torch.float32:
        return True
    if (B, Sq) == (4, 128):
        return False
    if (B, Sq) == (4, SPEC_K) or (B == 1 and Sq <= 128):
        return True
    raise AssertionError(f"no known forward route for ({B}, {Sq}) in "
                         f"{cfg.dtype}")


def forwards(cfg, layers, calls) -> dict:
    """The flash launches of ``calls`` cached forwards ``(B, T)`` of a
    ``layers``-deep model: a T > 1 forward launches the forward kernel
    once a layer (split-path or not by its route), a T = 1 step the decode
    kernel."""
    want = dict.fromkeys(FLASH_KEYS, 0)
    for B, T in calls:
        if T == 1:
            want["flash_decode"] += layers
        else:
            want["flash_fwd"] += layers
            want["flash_fwd_split"] += layers * fwd_is_split(B, T, cfg)
    return want


def add_counts(*dicts) -> dict:
    return {k: sum(d.get(k, 0) for d in dicts) for k in FLASH_KEYS}


class LaunchLeg:
    """The flash launches between construction and :meth:`held`, which
    fails unless they are the prediction."""

    def __init__(self, name: str):
        from byteps_tpu_torch.ops import launches

        self.name, self.launches = name, launches
        self.t0 = {k: launches[k] for k in FLASH_KEYS}

    def held(self, want: dict) -> dict:
        got = {k: self.launches[k] - self.t0[k] for k in FLASH_KEYS}
        if got != want:
            raise AssertionError(f"{self.name} launched {got}, predicted "
                                 f"{want}")
        return got


def chunk_log(sched, log: list):
    """Record the rows of every paged prefill chunk (and verify round) a
    scheduler runs: ``log`` gets one ``(1, C)`` a call."""
    fn = sched._prefill

    def wrapped(params, pool, tokens, *args, **kw):
        log.append((1, int(tokens.shape[1])))
        return fn(params, pool, tokens, *args, **kw)
    sched._prefill = wrapped
    return sched


def first_diff(a: np.ndarray, b: np.ndarray, T0: int) -> list:
    """Per row, the first new-token position where ``a`` and ``b`` differ
    (None where equal)."""
    return [None if np.array_equal(x, y) else
            int(np.flatnonzero(x != y)[0]) - T0 for x, y in zip(a, b)]


def solo_check(name, params, res, reqs, c) -> list:
    """Each request's tokens in ``res`` must equal a solo
    ``make_generate_fn`` run of ``c``; returns the solo runs' forward
    calls for their launch prediction."""
    from byteps_tpu_torch.models import make_generate_fn

    calls = []
    for r in reqs:
        solo = make_generate_fn(c, r.max_new)(
            params, r.prompt[None]).cpu().numpy()[0]
        if not np.array_equal(res[r.rid]["tokens"], solo):
            raise AssertionError(f"{name}: tokens of {r.rid} differ from "
                                 f"its solo run")
        calls += [(1, len(r.prompt))] + [(1, 1)] * (r.max_new - 1)
    return calls


def timed(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def spec_prompt(cfg, B, T0, seed) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T0)).astype(np.int32)


def plain_leg(params, cfg, B, T0, max_new, seed) -> dict:
    """Plain greedy on :func:`sampler_legs`' prompts, the samplers'
    yardstick: tokens, wall and its flash launches held to the
    prediction."""
    from byteps_tpu_torch.models import make_generate_fn

    leg = LaunchLeg(f"plain_{cfg.dtype}")
    toks, wall = timed(make_generate_fn(cfg, max_new), params,
                       spec_prompt(cfg, B, T0, seed))
    return {"tokens": toks.cpu().numpy(), "wall_s": wall,
            "launches": leg.held(forwards(
                cfg, cfg.n_layers, [(B, T0)] + [(B, 1)] * (max_new - 1)))}


def sampler_legs(params, draft, cfg, dcfg, B, T0, max_new, seed) -> dict:
    """Prompt lookup, the draft model and the self-draft probe on one
    prompt batch: tokens, rounds, wall, and each leg's flash launches held
    to the prediction from its rounds."""
    from byteps_tpu_torch.models import (make_lookup_generate_fn,
                                         make_speculative_generate_fn)

    K, L = SPEC_K, cfg.n_layers
    prompt = spec_prompt(cfg, B, T0, seed)
    legs = {}
    runs = (("lookup", None, None),
            ("draft", draft, dcfg),
            ("self_draft", params, cfg))
    for name, dp, dc in runs:
        leg = LaunchLeg(f"{name}_{cfg.dtype}")
        if dp is None:
            gen = make_lookup_generate_fn(cfg, max_new, spec_len=K)
            (toks, rounds), wall = timed(gen, params, prompt)
            want = forwards(cfg, L, [(B, T0)] + [(B, K)] * rounds)
        else:
            gen = make_speculative_generate_fn(cfg, dc, max_new, spec_len=K)
            (toks, rounds), wall = timed(gen, params, dp, prompt)
            want = add_counts(
                forwards(cfg, L, [(B, T0)] + [(B, K)] * rounds),
                forwards(dc, dc.n_layers, [(B, T0)] + [(B, 1)] * K * rounds))
        legs[name] = {"tokens": toks.cpu().numpy(), "rounds": rounds,
                      "wall_s": wall, "launches": leg.held(want)}
    for name, r in legs.items():
        if r["tokens"].shape != (B, T0 + max_new) or not (
                r["tokens"][:, :T0] == prompt).all():
            raise AssertionError(f"{name} returned {r['tokens'].shape} or "
                                 "changed the prompt")
    return legs


def spec_sched_leg(params, cfg, draft, dcfg, seed, n_each, plain, max_new,
                   T0=128):
    """One Scheduler serving ``n_each`` lookup requests (a random 16-token
    base tiled to ``T0``), ``n_each`` draft requests (random prompts) and
    ``plain`` plain ones: results, wall, counters, and the flash launches
    held to the prediction from its chunks, rounds and draft steps."""
    from byteps_tpu_torch.common.metrics import get_registry
    from byteps_tpu_torch.serve import Request, Scheduler, SpecPolicy

    rng = np.random.default_rng(seed)
    lookup = SpecPolicy("lookup", SPEC_K)
    draftp = SpecPolicy("draft", SPEC_K, draft_params=draft, draft_cfg=dcfg)
    reqs = []
    for i in range(n_each):
        base = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
        reqs.append(Request(rid=f"lookup{i}", prompt=np.tile(base, T0 // 16),
                            max_new=max_new, spec=lookup))
    for kind, pol, n in (("draft", draftp, n_each), ("plain", None, plain)):
        reqs += [Request(rid=f"{kind}{i}", prompt=rng.integers(
                     0, cfg.vocab_size, T0).astype(np.int32),
                     max_new=max_new, spec=pol) for i in range(n)]
    c0 = dict(get_registry().snapshot()["counters"])
    chunks = []
    sched = chunk_log(Scheduler(params, cfg, pool_blocks=1 + 12 * len(reqs)),
                      chunks)
    leg = LaunchLeg(f"spec_sched_{cfg.dtype}")
    res, wall = timed(sched.serve, reqs)
    c1 = get_registry().snapshot()["counters"]
    c = {k: c1.get(k, 0) - c0.get(k, 0) for k in (
        "serve.spec_rounds", "serve.spec_tokens", "serve.decode_tokens",
        "serve.iterations", "serve.prefill_tokens",
        "serve.prefix_saved_tokens")}
    draft_rounds = sum(res[r.rid]["spec_rounds"] for r in reqs
                       if r.rid.startswith("draft"))
    launches = leg.held(add_counts(
        forwards(cfg, cfg.n_layers, chunks),
        forwards(dcfg, dcfg.n_layers,
                 [(1, T0)] * n_each + [(1, 1)] * SPEC_K * draft_rounds)))
    if sched.cache.leaked_blocks():
        raise AssertionError(f"spec scheduler leaked "
                             f"{sched.cache.leaked_blocks()} KV blocks")
    return reqs, res, wall, c, launches, chunks


def phase_speculative(params, cfg):
    """The speculative samplers and the scheduler's speculative lane at
    GPT-2 medium width (``SPEC_K`` = 4, a ``SPEC_DRAFT_LAYERS``-layer
    draft of the same width and its own seed). bf16: B=4, T0=128, 64 new
    through prompt lookup, the draft and the self-draft probe, after a
    pass of each at ``SPEC_K`` + 1 new tokens; then 8
    requests of 32 new through one Scheduler, 4 lookup on tiled prompts
    and 4 draft, with ``serve.decode_tokens`` 0. f32: both samplers and
    the self-draft at 32 new, the self-draft within ceil(31 / 4) + 1
    rounds; a lookup, a draft and a plain request through one Scheduler.
    Every leg's flash launches held to the prediction.

    Returns the phase's record and its comparison, run after the path's
    launches are read: plain greedy on the same prompts (new tokens/s
    against plain, committed tokens a round, the first position each
    bf16 row leaves plain greedy's tokens, no limit; f32 tokens equal)
    and solo runs of the f32 scheduler's requests."""
    from byteps_tpu_torch.models import gpt_init

    dcfg = dataclasses.replace(cfg, n_layers=SPEC_DRAFT_LAYERS)
    draft = gpt_init(dcfg, torch.Generator(device="cuda").manual_seed(1))
    B, T0 = 4, 128
    # a short pass first, so no timed leg pays the first calls' costs
    warm = sampler_legs(params, draft, cfg, dcfg, B, T0, SPEC_K + 1, 40)
    bf = sampler_legs(params, draft, cfg, dcfg, B, T0, 64, 40)
    # the scheduler's lane, bf16: no request takes a packed decode step
    reqs, res, wall, counters, launches, chunks = spec_sched_leg(
        params, cfg, draft, dcfg, 41, 4, 0, 32)
    if counters["serve.decode_tokens"] != 0:
        raise AssertionError(f"spec requests took packed decode steps: "
                             f"{counters}")
    lane = {"requests": len(reqs), "max_new": 32, "wall_s": wall,
            "new_tokens_per_s": len(reqs) * 32 / wall,
            "spec_rounds_by_request": {r.rid: res[r.rid]["spec_rounds"]
                                       for r in reqs},
            "counters": counters, "prefill_chunks": len(chunks),
            "launches": launches}
    # f32: the round ceiling here, token equality in the comparison
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    dcfg32 = dataclasses.replace(dcfg, dtype=torch.float32)
    f32 = sampler_legs(params, draft, cfg32, dcfg32, B, T0, 32, 42)
    ceiling = -(-(32 - 1) // SPEC_K) + 1
    if f32["self_draft"]["rounds"] > ceiling:
        raise AssertionError(f"f32 self-draft took "
                             f"{f32['self_draft']['rounds']} rounds, over "
                             f"the ceiling {ceiling}")
    reqs32, res32, _, c32, launches32, _ = spec_sched_leg(
        params, cfg32, draft, dcfg32, 43, 1, 1, 16)
    if c32["serve.decode_tokens"] != 15:
        raise AssertionError(f"f32 lane: the plain request alone decodes "
                             f"packed, {c32}")
    record = {"phase": "speculative", "card": card_name_and_limit(),
              "spec_len": SPEC_K, "draft_layers": SPEC_DRAFT_LAYERS,
              "batch": B, "prompt": T0, "max_new": 64,
              "warm_pass": {name: {"max_new": SPEC_K + 1,
                                   "rounds": r["rounds"],
                                   "launches": r["launches"]}
                            for name, r in warm.items()},
              "scheduler_lane_bf16": lane,
              "f32": {name: {"rounds": r["rounds"], "wall_s": r["wall_s"],
                             "launches": r["launches"]}
                      for name, r in f32.items()},
              "f32_self_draft_ceiling": ceiling,
              "f32_scheduler_rounds": {r.rid: res32[r.rid]["spec_rounds"]
                                       for r in reqs32},
              "f32_scheduler_launches": launches32}

    def compare() -> dict:
        plain = plain_leg(params, cfg, B, T0, 64, 40)
        samplers = {
            name: {"rounds": r["rounds"], "wall_s": r["wall_s"],
                   "new_tokens_per_s": B * 64 / r["wall_s"],
                   "speedup_vs_plain": plain["wall_s"] / r["wall_s"],
                   "committed_per_round": (64 - 1) / r["rounds"],
                   "first_diff_vs_plain": first_diff(
                       r["tokens"], plain["tokens"], T0),
                   "launches": r["launches"]}
            for name, r in bf.items()}
        plain32 = plain_leg(params, cfg32, B, T0, 32, 42)
        for name, r in f32.items():
            if not np.array_equal(r["tokens"], plain32["tokens"]):
                raise AssertionError(
                    f"f32 {name} tokens differ from plain greedy at "
                    f"{first_diff(r['tokens'], plain32['tokens'], T0)}")
        leg = LaunchLeg("spec_solo_f32")
        leg.held(forwards(cfg32, cfg.n_layers, solo_check(
            "f32 scheduler", params, res32, reqs32, cfg32)))
        return {"plain_new_tokens_per_s": B * 64 / plain["wall_s"],
                "plain_launches": plain["launches"],
                "plain_f32_launches": plain32["launches"],
                "bf16": samplers, "f32_equal_plain": True,
                "f32_scheduler_equals_solo": True}

    return record, [compare]


def percentiles(xs) -> dict:
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))}


def phase_serve_router(params, cfg):
    """Failover, the disaggregated race and migrate-don't-evict at GPT-2
    medium width, every replica's pool sized explicitly.

    failover (f32): two replicas, ``worker:kill@op=4`` on replica 1, 6
    requests of 32..128 prompt tokens and 16 new: tokens equal to solo
    runs, epoch 1, one eviction, requeued >= 1, no leaked block; the lease
    above the slowest step of a warm replica; the ms from the kill to the
    eviction. race (bf16, bench.py's serve race): 3 prompts of 224 tokens
    and 12 of 16, 8 new, max_batch 16, chunk 64, through 1 prefill + 1
    decode replica (prompt threshold 120) and through 2 colocated
    replicas, after a warm pass: TTFT p50/p99 of each class, makespan,
    the migrated requests, blocks and bytes, and how many streams the
    two layouts share; then an f32 cut (1 long, 4 short) whose streams
    equal colocated and solo. migrate (f32, bench.py's migrate race):
    block 16, replica A's pool 1 + 9, 4 prompts of 48, 32 new,
    max_batch 2: recompute > 0 with migration off, fewer with it on,
    migrated > 0, the streams equal. Every leg's flash launches are
    held to the prediction from its prefill chunks.

    Returns the phase's record and its comparison, run after the path's
    launches are read: the failover's and the f32 race's streams equal
    solo runs."""
    from byteps_tpu_torch.common.faults import (FaultPlan, WorkerKilledError,
                                                parse_fault_spec)
    from byteps_tpu_torch.common.metrics import get_registry
    from byteps_tpu_torch.serve import Request, Router, Scheduler

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    L = cfg.n_layers

    def counters():
        return dict(get_registry().snapshot()["counters"])

    def delta(c0, c1, *keys):
        return {k: c1.get(k, 0) - c0.get(k, 0) for k in keys}

    def leak_free(name, scheds):
        leaked = [s.cache.leaked_blocks() for s in scheds]
        if any(leaked):
            raise AssertionError(f"{name} leaked KV blocks {leaked}")

    out = {"phase": "serve_router", "card": card_name_and_limit()}
    solo = []                     # (name, results, requests) to hold
    # -- failover, f32 ----------------------------------------------------
    pool = 1 + 64
    kw = dict(max_batch=3, pool_blocks=pool)
    chunks = []
    warm = chunk_log(Scheduler(params, cfg32, replica_id=9, **kw), chunks)
    leg = LaunchLeg("failover_warm")
    rng = np.random.default_rng(50)
    warm_reqs = [Request(rid=f"w{i}", prompt=rng.integers(
        0, cfg.vocab_size, n).astype(np.int32), max_new=4)
        for i, n in enumerate((64, 128))]
    for r in warm_reqs:
        warm.submit(r)
    steps = []
    while not warm.finished:
        _, s = timed(warm.step)
        steps.append(s)
    leg.held(forwards(cfg32, L, chunks))
    slowest_ms = max(steps) * 1e3
    lease_ms = max(200, int(3 * slowest_ms))
    del warm
    chunks = []
    r0 = chunk_log(Scheduler(params, cfg32, replica_id=0, **kw), chunks)
    r1 = chunk_log(Scheduler(
        params, cfg32, replica_id=1,
        fault_plan=FaultPlan(parse_fault_spec("worker:kill@op=4"), seed=0,
                             worker_id=1), **kw), chunks)
    router = Router([r0, r1], lease_ms=lease_ms)
    stamp = {}
    step1, sweep = r1.step, router.sweep

    def r1_step():
        try:
            return step1()
        except WorkerKilledError:
            stamp.setdefault("kill", time.perf_counter())
            raise

    def timed_sweep():
        sweep()
        if 1 not in router.live_replicas():
            stamp.setdefault("evict", time.perf_counter())
    r1.step, router.sweep = r1_step, timed_sweep
    reqs = [Request(rid=f"f{i}", prompt=rng.integers(
        0, cfg.vocab_size, n).astype(np.int32), max_new=16)
        for i, n in enumerate(np.linspace(32, 128, 6).astype(int))]
    c0 = counters()
    leg = LaunchLeg("failover")
    res, wall = timed(router.run, reqs)
    leg.held(forwards(cfg32, L, chunks))
    c = delta(c0, counters(), "serve.router.evictions",
              "serve.router.requeued", "serve.resumed")
    solo.append(("failover", res, reqs))
    leak_free("failover", (r0, r1))
    if not (router.epoch == 1 and c["serve.router.evictions"] == 1
            and c["serve.router.requeued"] >= 1 and r1.dead):
        raise AssertionError(f"failover: epoch {router.epoch}, {c}")
    out["failover_f32"] = {
        "requests": len(reqs), "prompt_lens": [len(r.prompt) for r in reqs],
        "max_new": 16, "slowest_warm_step_ms": slowest_ms,
        "lease_ms": lease_ms, "wall_s": wall, "epoch": router.epoch,
        "kill_to_evict_ms": (stamp["evict"] - stamp["kill"]) * 1e3,
        "moved_to_survivor": sum(res[r.rid]["epoch"] == 1 for r in reqs),
        **c}
    router.close()
    del router, r0, r1
    gc.collect()

    # -- the disaggregated race, bf16 ---------------------------------------
    def race(c, n_long, n_short, seed, disagg, max_new=8, wrap=None,
             tag="", rid=int):
        rng = np.random.default_rng(seed)
        trace = []
        for _ in range(n_long):
            trace.append(rng.integers(0, c.vocab_size, 224).astype(np.int32))
            trace += [rng.integers(0, c.vocab_size, 16).astype(np.int32)
                      for _ in range(n_short // n_long)]
        kw = dict(max_batch=16, prefill_chunk=64, pool_blocks=1 + 96)
        chunks = []
        if disagg:
            reps = [chunk_log(Scheduler(params, c, role="decode",
                                        replica_id=0, **kw), chunks),
                    chunk_log(Scheduler(params, c, role="prefill",
                                        replica_id=1, **kw), chunks)]
            router = Router(reps[:1], prefill_replicas=reps[1:],
                            lease_ms=600000, prompt_threshold=120,
                            migrate_preempt=False, kv_target_wrap=wrap)
        else:
            reps = [chunk_log(Scheduler(params, c, replica_id=i, **kw),
                              chunks) for i in range(2)]
            router = Router(reps, lease_ms=600000, migrate_preempt=False)
        reqs = [Request(rid=rid(i), prompt=p, max_new=max_new)
                for i, p in enumerate(trace)]
        c0 = counters()
        leg = LaunchLeg(f"race_{'disagg' if disagg else 'colocated'}{tag}")
        res, wall = timed(router.run, reqs)
        router.close()
        launches = leg.held(forwards(c, L, chunks))
        leak_free("race", reps)
        mig = delta(c0, counters(), "serve.migration.adopted",
                    "serve.migration.blocks", "serve.migration.bytes",
                    "serve.migration.recompute_tokens")
        stats = {"makespan_s": wall, "launches": launches, **mig}
        for cls, n in (("short", 16), ("long", 224)):
            stats[f"ttft_ms_{cls}"] = percentiles(
                [res[r.rid]["ttft_s"] * 1e3 for r in reqs
                 if len(r.prompt) == n])
        if disagg and mig["serve.migration.adopted"] != n_long:
            raise AssertionError(f"race: {mig} with {n_long} long prompts")
        return reqs, res, stats

    race(cfg, 3, 12, 51, True)                    # warm both roles
    reqs, dis_res, dis = race(cfg, 3, 12, 51, True)
    _, col_res, col = race(cfg, 3, 12, 51, False)
    same = sum(np.array_equal(dis_res[r.rid]["tokens"],
                              col_res[r.rid]["tokens"]) for r in reqs)
    out["race_bf16"] = {
        "n_long": 3, "long_tokens": 224, "n_short": 12, "short_tokens": 16,
        "max_new": 8, "prompt_threshold": 120, "max_batch": 16,
        "prefill_chunk": 64, "disagg": dis, "colocated": col,
        "streams_equal": same, "streams": len(reqs),
        "short_ttft_p99_colocated_over_disagg":
            col["ttft_ms_short"]["p99"] / dis["ttft_ms_short"]["p99"]}
    inproc_ms = []
    reqs, dis_res, _ = race(cfg32, 1, 4, 52, True,
                            wrap=lambda t: TimedTarget(t, inproc_ms))
    _, col_res, _ = race(cfg32, 1, 4, 52, False)
    solo.append(("race_f32", dis_res, reqs))
    for r in reqs:
        if not np.array_equal(col_res[r.rid]["tokens"],
                              dis_res[r.rid]["tokens"]):
            raise AssertionError(f"f32 race: colocated {r.rid} differs")
    out["race_f32_equal"] = True
    out["kv_socket_f32"] = kv_socket_leg(race, cfg32, dis_res, inproc_ms,
                                         counters, delta)

    # -- migrate-don't-evict, f32 ------------------------------------------
    rng = np.random.default_rng(53)
    trace = [rng.integers(0, cfg.vocab_size, 48).astype(np.int32)
             for _ in range(4)]

    def migrate(on):
        kw = dict(max_batch=2, block_size=16, prefill_chunk=64)
        chunks = []
        a = chunk_log(Scheduler(params, cfg32, pool_blocks=1 + 9,
                                replica_id=0, **kw), chunks)
        b = chunk_log(Scheduler(params, cfg32, pool_blocks=1 + 32,
                                replica_id=1, **kw), chunks)
        router = Router([a, b], lease_ms=600000, migrate_preempt=on)
        reqs = [Request(rid=i, prompt=p, max_new=32)
                for i, p in enumerate(trace)]
        c0 = counters()
        leg = LaunchLeg(f"migrate_{'on' if on else 'off'}")
        res, wall = timed(router.run, reqs)
        router.close()
        launches = leg.held(forwards(cfg32, L, chunks))
        leak_free("migrate", (a, b))
        return reqs, res, {"wall_s": wall, "launches": launches, **delta(
            c0, counters(), "serve.migration.recompute_tokens",
            "serve.migration.out_requests", "serve.migration.adopted",
            "serve.migration.blocks", "serve.preempted")}

    reqs, off_res, off = migrate(False)
    _, on_res, on = migrate(True)
    rec = "serve.migration.recompute_tokens"
    if off[rec] <= 0:
        raise AssertionError(f"migrate: no recompute with migration off, "
                             f"{off}")
    if not (on[rec] < off[rec] and on["serve.migration.out_requests"] > 0):
        raise AssertionError(f"migrate: on {on}, off {off}")
    for r in reqs:
        if not np.array_equal(on_res[r.rid]["tokens"],
                              off_res[r.rid]["tokens"]):
            raise AssertionError(f"migrate: request {r.rid} differs on/off")
    out["migrate_f32"] = {"block_size": 16, "pool_a": 1 + 9,
                          "pool_b": 1 + 32, "prompt": 48, "max_new": 32,
                          "requests": 4, "max_batch": 2, "on": on,
                          "off": off, "streams_equal": True}

    def compare() -> dict:
        for name, res, reqs in solo:
            leg = LaunchLeg(f"{name}_solo")
            leg.held(forwards(cfg32, L, solo_check(name, params, res, reqs,
                                                   cfg32)))
        return {"failover_f32_equals_solo": True,
                "race_f32_equals_solo": True}

    return out, [compare]


class TimedTarget:
    """A KV wire target that times each ``ingest_block`` into ``log``
    (ms) and forwards it, liveness included, to ``target``."""

    def __init__(self, target, log: list):
        self._t, self._log = target, log

    @property
    def dead(self):
        return getattr(self._t, "dead", False)

    def ingest_block(self, rid, block_idx, frame):
        t0 = time.perf_counter()
        self._t.ingest_block(rid, block_idx, frame)
        self._log.append((time.perf_counter() - t0) * 1e3)


def kv_socket_leg(race, cfg32, inproc_res, inproc_ms, counters, delta):
    """serve_router's f32 race cut again with every migrated KV block
    crossing a real TCP socket: the Router's ``kv_target_wrap`` maps the
    decode replica to a ``SocketKVTarget`` whose client carries a
    ``push:corrupt@op=1`` rule, in front of a ``KVSocketEndpoint`` on
    that replica. Every stream bit-equal to the in-process wire's run
    (``inproc_res``); the corrupted frame rejected by the listener's CRC
    and healed by the KVPUSH stage retry; every migrated block ingested
    over the socket once; ms a delivered block (the request and its
    reply, the far end's decode and staging included; the rejected one
    not counted) beside the in-process delivery's."""
    from byteps_tpu_torch.common.faults import FaultPlan, parse_fault_spec
    from byteps_tpu_torch.serve.kv_socket import (KVSocketEndpoint,
                                                  SocketKVTarget)

    import threading

    plan = FaultPlan(parse_fault_spec("push:corrupt@op=1"), seed=0)
    ends, socket_ms, lock = {}, [], threading.Lock()

    def wrap(sched):
        with lock:                 # the wire's push threads resolve at once
            if id(sched) not in ends:
                ep = KVSocketEndpoint(sched, port=free_port_pair())
                ends[id(sched)] = (ep, SocketKVTarget(
                    ep.host, ep.port, timeout_ms=10000, fault_plan=plan))
            return TimedTarget(ends[id(sched)][1], socket_ms)

    c0 = counters()
    try:
        # request ids cross the socket as strings (kv_socket's frame)
        reqs, res, stats = race(cfg32, 1, 4, 52, True, wrap=wrap,
                                tag="_socket", rid=str)
    finally:
        for ep, proxy in ends.values():
            proxy.close()
            ep.close()
    c = counters()
    d = delta(c0, c, "serve.kv_socket.blocks_ingested",
              "serve.migration.blocks", "scheduler.stage_retries")
    crc = sum(c.get(k, 0) - c0.get(k, 0) for k in c
              if k.startswith("socknic.l") and k.endswith(".crc_rejects"))
    for r in reqs:
        if not np.array_equal(res[r.rid]["tokens"],
                              inproc_res[int(r.rid)]["tokens"]):
            raise AssertionError(f"kv_socket: stream {r.rid} differs from "
                                 "the in-process wire's")
    if len(ends) != 1:
        raise AssertionError(f"kv_socket: {len(ends)} decode endpoints")
    blocks = d["serve.migration.blocks"]
    if not (blocks > 0 and d["serve.kv_socket.blocks_ingested"] == blocks
            and plan.counters().get("corrupt") == 1 and crc == 1
            and d["scheduler.stage_retries"] >= 1
            and len(socket_ms) == blocks):
        raise AssertionError(f"kv_socket: {d}, CRC rejects {crc}, plan "
                             f"{plan.counters()}, {len(socket_ms)} "
                             "deliveries")
    return {"requests": len(reqs), "blocks": blocks,
            "block_bytes": stats["serve.migration.bytes"] // blocks,
            "corrupt_injected": 1,
            "crc_rejects": crc,
            "stage_retries": d["scheduler.stage_retries"],
            "socket_ms_per_block": percentiles(socket_ms),
            "inproc_ms_per_block": percentiles(inproc_ms),
            "launches": stats["launches"], "streams_equal": True}


def phase_tiny():
    """A tiny model: plain versions on the CPU and kernels on the card
    emit the same greedy tokens."""
    from byteps_tpu_torch.models import GPTConfig, gpt_init, make_generate_fn

    tiny = dataclasses.replace(GPTConfig.tiny(), max_seq=128)
    tp_cpu = gpt_init(tiny, torch.Generator().manual_seed(3), device="cpu")
    tp_gpu = copy.deepcopy(tp_cpu).to("cuda")
    prompt = np.random.default_rng(3).integers(
        0, tiny.vocab_size, (2, 37)).astype(np.int32)
    cpu = make_generate_fn(tiny, 24, device="cpu")(tp_cpu, prompt).numpy()
    gpu = make_generate_fn(tiny, 24)(tp_gpu, prompt).cpu().numpy()
    if not np.array_equal(cpu, gpu):
        raise AssertionError("tiny model: CPU and card tokens differ")
    emit({"phase": "tiny", "cpu_equals_card": True})


# filled by phase_train: the gradient chunks and elements of one step,
# and the peak memory of the leg
TRAIN_CHUNKS = {}
TRAIN_PARAMS = {}
TRAIN_PEAK = {}


def phase_train(leg, compression_params, B=8, S=1024, steps=5):
    """One leg of the training step at GPT-2 medium width: one warm-up
    step, then ``steps`` timed ones on a fixed seeded batch."""
    from byteps_tpu_torch.models import (GPTConfig, make_gpt_train_step,
                                         synthetic_batch)

    cfg = GPTConfig.gpt2_medium()
    step, params, opt = make_gpt_train_step(
        cfg, compression_params=compression_params,
        generator=torch.Generator(device="cuda").manual_seed(0))
    tok, tgt = synthetic_batch(torch.Generator(device="cuda").manual_seed(1),
                               cfg, B, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(steps + 1):
        t0 = time.perf_counter()
        loss = float(step(tok, tgt))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train {leg}: losses {losses} not finite or "
                             "not falling")
    step_s = sum(times[1:]) / steps
    from byteps_tpu_torch.common.config import get_config

    n_params = sum(p.numel() for p in opt.params)
    per = get_config().partition_bytes // 4
    chunks = TRAIN_CHUNKS[leg] = -(-n_params // per)
    TRAIN_PARAMS[leg] = n_params
    TRAIN_PEAK[leg] = torch.cuda.max_memory_allocated()
    emit({"phase": "train", "leg": leg, "batch": B, "seq": S,
          "params": n_params, "chunks_per_step": chunks,
          "compression": compression_params, "losses": losses,
          "warmup_s": times[0], "step_ms": step_s * 1e3,
          "step_ms_each": [t * 1e3 for t in times[1:]],
          "tokens_per_s": B * S / step_s,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    del step, params, opt


# accum_steps=2 against the full-batch step (f32): the microbatch means
# add in another order than the batch's mean
ACCUM_TINY_TOL = 1e-5


def phase_train_tiny(steps=3):
    """A tiny f32 model trains on the CPU (plain versions) and on the card
    (kernels) from the same weights and batch to the same losses; on the
    card, ``accum_steps=2`` from the same weights gives the full-batch
    step's losses and parameters to ``ACCUM_TINY_TOL``."""
    from byteps_tpu_torch.models import (GPTConfig, gpt_init,
                                         make_gpt_train_step)

    tiny = GPTConfig.tiny()
    p_cpu = gpt_init(tiny, torch.Generator().manual_seed(3), device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tiny.vocab_size, (4, 33))
    tok, tgt = toks[:, :-1], toks[:, 1:]
    cpu = make_gpt_train_step(tiny, init_params=p_cpu, device="cpu")[0]
    gpu = make_gpt_train_step(tiny, init_params=p_gpu)[0]
    p_acc = copy.deepcopy(p_gpu)
    acc = make_gpt_train_step(tiny, init_params=p_acc, accum_steps=2)[0]
    lc = [float(cpu(tok, tgt)) for _ in range(steps)]
    lg = [float(gpu(tok, tgt)) for _ in range(steps)]
    la = [float(acc(tok, tgt)) for _ in range(steps)]
    diff = max(abs(a - b) for a, b in zip(lc, lg))
    if not diff <= 1e-4:
        raise AssertionError(f"tiny train: CPU losses {lc} vs card {lg}")
    # two microbatches of 2 rows against the full batch of 4, on the card
    acc_diff = max(abs(a - b) for a, b in zip(la, lg))
    acc_pdiff = max(float((a - b).detach().abs().max()) for a, b in
                    zip(p_acc.parameters(), p_gpu.parameters()))
    if not (acc_diff <= ACCUM_TINY_TOL and acc_pdiff <= ACCUM_TINY_TOL):
        raise AssertionError(f"tiny train: accum_steps=2 losses {la} vs the "
                             f"full batch's {lg} (params {acc_pdiff} apart)")
    emit({"phase": "train_tiny", "cpu_losses": lc, "card_losses": lg,
          "max_diff": diff, "tolerance": 1e-4, "accum2_losses": la,
          "accum2_max_diff": acc_diff, "accum2_params_max_diff": acc_pdiff,
          "accum2_tolerance": ACCUM_TINY_TOL})


def named_grads(params) -> dict:
    """Each leaf's gradient under its path in the reference's tree."""
    out = {k: p.grad for k, p in params._parameters.items()}
    for i, b in enumerate(params.blocks):
        out.update({f"blocks.{i}.{k}": p.grad
                    for k, p in b._parameters.items()})
    return out


def phase_train_bf16():
    """One bf16 step at head dim 64 on the CPU (plain versions) and on
    the card, from the same weights and batch. B=8, S=256 and 4 heads
    give 128 query tiles, so the card runs the tensor-core forward and
    both tensor-core backward kernels, as the training step at full width
    does. The losses agree to TRAIN_BF16_LOSS_TOL; each leaf's gradient
    to TRAIN_BF16_REL_L2 in relative L2, but for ``bk``, whose exact
    gradient is 0 (softmax ignores a per-row shift), so its value is
    roundoff."""
    from byteps_tpu_torch.models import (GPTConfig, gpt_init,
                                         make_gpt_train_step)

    cfg = GPTConfig(vocab_size=2048, max_seq=256, d_model=256, n_heads=4,
                    n_layers=2, d_ff=1024, dtype=torch.bfloat16)
    p_cpu = gpt_init(cfg, torch.Generator().manual_seed(4), device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (8, 257))
    tok, tgt = toks[:, :-1], toks[:, 1:]
    lc = float(make_gpt_train_step(cfg, init_params=p_cpu,
                                   device="cpu")[0](tok, tgt))
    lg = float(make_gpt_train_step(cfg, init_params=p_gpu)[0](tok, tgt))
    gc_, gg = named_grads(p_cpu), named_grads(p_gpu)
    rel = {k: float((gg[k].cpu().float() - g.float()).norm()
                    / g.float().norm())
           for k, g in gc_.items() if not k.endswith(".bk")}
    norms = {k: [float(g.float().norm()), float(gg[k].float().norm())]
             for k, g in gc_.items()}
    worst = max(rel, key=rel.get)
    res = {"phase": "train_bf16", "cpu_loss": lc, "card_loss": lg,
           "loss_diff": abs(lc - lg), "loss_tol": TRAIN_BF16_LOSS_TOL,
           "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_leaf": worst,
           "grad_rel_l2_tol": TRAIN_BF16_REL_L2, "grad_rel_l2": rel,
           "grad_norms_cpu_card": norms}
    emit(res)
    if not (abs(lc - lg) <= TRAIN_BF16_LOSS_TOL
            and rel[worst] <= TRAIN_BF16_REL_L2):
        raise AssertionError(f"bf16 step: CPU loss {lc} vs card {lg}, "
                             f"gradient of {worst} {rel[worst]} apart")


# the aggregation tier's worker counts for one chunk's decompress-sum:
# above 32, the grid order
AGGREGATE_KS = (40, 256)


def phase_aggregate_onebit(n=4096000 // 4):
    """The aggregation tier's onebit decompress-sum at pod scale (K
    workers, one default 4,096,000-byte partition each): K seeded
    gradients go through ``OnebitCompressor.compress`` (scaled), the
    payloads are stacked as the tier receives them and summed by
    ``decompress_sum``, at K = 40 and 256. Each sum must launch the grid
    unpack-sum exactly once and equal the plain version bit for bit,
    finite, of n elements."""
    from byteps_tpu_torch.compression import OnebitCompressor
    from byteps_tpu_torch.ops import launches
    from byteps_tpu_torch.ops.onebit_kernels import _unpack_sum_torch

    comp = OnebitCompressor(scaling=True)
    g = torch.Generator(device="cuda").manual_seed(48)
    res = {}
    for K in AGGREGATE_KS:
        grads = torch.randn(K, n, generator=g, device="cuda")
        pays = [comp.compress(grads[k]) for k in range(K)]
        del grads
        stacked = {key: torch.stack([p[key] for p in pays])
                   for key in pays[0]}
        before = launches["onebit_unpack_sum_grid"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = comp.decompress_sum(stacked, n)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        calls = launches["onebit_unpack_sum_grid"] - before
        ref = _unpack_sum_torch(stacked["signs"], stacked["scale"][:, 0], n)
        if calls != 1:
            raise AssertionError(f"aggregate_onebit K={K}: decompress_sum "
                                 f"launched the grid unpack-sum {calls} "
                                 "times, not once")
        if not (out.shape == (n,) and bool(out.isfinite().all())
                and bits_equal(out, ref)):
            raise AssertionError(f"aggregate_onebit K={K}: decompress_sum "
                                 "differs from the plain version")
        res[K] = {"grid_launches": calls, "bit_equal": True,
                  "wall_ms": wall}
    emit({"phase": "aggregate_onebit", "n": n, **{f"K{K}": r
                                                  for K, r in res.items()}})
    return res


# --------------------------------------------------------------------------
# ZeRO-1, gradient accumulation, the eval step and the examples
# --------------------------------------------------------------------------
ZERO_N = 354_871_296             # GPT-2 medium's parameters: one ZeRO chunk
ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}


def zero_codec_cases(timer) -> dict:
    """The codec kernels at ZeRO-1's shapes, where the whole flat gradient
    is one chunk: GPT-2 medium's 354,871,296 f32 (n = 1) and a segment of
    177,435,648 (n = 2). Onebit pack bit-equal to the plain version at
    both; unpack-sum by bit pattern at K = 1 on the whole vector and K = 2
    on the segment (the owner's sum); top-k block select (k = 0.01: the
    strided layout, (101, 3,513,578) and (101, 1,756,789)) and
    reconstruct-sum bit for bit, K = 1 whole, K = 2 on two segments.
    Kernel, plain and bound ms at the whole vector."""
    from byteps_tpu_torch.compression.topk import block_shape, tiled_shape
    from byteps_tpu_torch.ops.onebit_kernels import (
        _pack_torch, _unpack_sum_torch, onebit_pack, onebit_unpack_sum,
        packed_words)

    g = torch.Generator(device="cuda").manual_seed(60)
    out = {}
    for name, n, K in (("whole", ZERO_N, 1), ("segment", -(-ZERO_N // 2), 2)):
        timed = name == "whole"
        xs = [torch.randn(n, generator=g, device="cuda") for _ in range(K)]
        words = [onebit_pack(x) for x in xs]
        for x, w in zip(xs, words):
            if not torch.equal(w, _pack_torch(x)):
                raise AssertionError(f"onebit pack at ZeRO's {name} shape "
                                     f"(n = {n}): differs from the plain "
                                     "version")
        ws = torch.stack(words)
        sc = torch.stack([x.abs().mean() for x in xs])
        del words
        got = onebit_unpack_sum(ws, sc, n)
        ref = _unpack_sum_torch(ws, sc, n)
        if not bits_equal(got, ref):
            raise AssertionError(f"onebit unpack_sum at ZeRO's {name} shape "
                                 f"(n = {n}, K = {K}): differs from the "
                                 "plain version")
        L = packed_words(n)
        res = {"n": n, "K": K, "words": L, "pack_bit_equal": True,
               "unpack_sum_bit_equal": True,
               "unpack_max_abs_err": float((got - ref).abs().max())}
        del got, ref
        if timed:
            x = xs[0]
            res["pack_ms"] = timer(lambda: onebit_pack(x), iters=5)
            res["pack_plain_ms"] = timer(lambda: _pack_torch(x), iters=3)
            res["pack_bound_ms"], res["pack_bound_by"] = bound_ms(
                4 * n + 4 * L, 32 * L, torch.float32)
            res["unpack_ms"] = timer(lambda: onebit_unpack_sum(ws, sc, n),
                                     iters=5)
            res["unpack_plain_ms"] = timer(
                lambda: _unpack_sum_torch(ws, sc, n), iters=3)
            res["unpack_bound_ms"], res["unpack_bound_by"] = bound_ms(
                4 * K * L + 4 * K + 4 * n, 2 * K * n, torch.float32)
        del xs, ws, sc
        if tiled_shape(0.01, n) is not None:
            raise AssertionError(f"top-k k = 0.01 tiles at n = {n}: the "
                                 "ZeRO legs' launch counts assume strided")
        rows, block = block_shape(0.01, n)
        los, vas = [], []
        for k in range(K):
            r, lo, va = topk_select_case(timer if timed else None,
                                         f"zero_{name}", block, rows, n,
                                         61 + k, timed=timed)
            los.append(lo)
            vas.append(va)
            if timed:
                res.update({f"select_{f}": r[f] for f in (
                    "ms", "warm_ms", "plain_ms", "library_ms", "bound_ms")})
        r = topk_reconstruct_case(timer if timed else None, f"zero_{name}",
                                  torch.stack(los), torch.stack(vas), block,
                                  timed=timed)
        if timed:
            res.update({f"reconstruct_{f}": r[f] for f in (
                "ms", "warm_ms", "plain_ms", "library_ms", "bound_ms")})
        res.update({"topk_shape": [block, rows], "topk_bit_equal": True})
        out[name] = res
        del los, vas
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "zero_codecs", **out})
    return out


def falls(losses) -> bool:
    """Every loss finite, and one after the first below it. (AdamW at
    1e-3 from GPT-2 medium's random init goes 11.03, 10.81, 12.99, 9.74
    on the train legs' batch, on an NVIDIA H100 80GB HBM3 at 700 W: the
    third step overshoots.)"""
    return bool(np.isfinite(losses).all()) and min(losses[1:]) < losses[0]


def timed_train(step, opt, tok, tgt, steps) -> dict:
    """One warm-up and ``steps`` timed calls of ``step`` on one batch:
    losses, step ms, the parameters' digest, the moments' bytes and peak
    memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(steps + 1):
        t0 = time.perf_counter()
        losses.append(float(step(tok, tgt)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"losses": losses, "warmup_s": times[0],
            "step_ms": sum(times[1:]) / steps * 1e3,
            "step_ms_each": [t * 1e3 for t in times[1:]],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "moment_bytes": opt.moment_bytes(),
            "params_sha1": params_digest(opt.params)}


def phase_train_zero(B=8, S=1024, steps=2) -> dict:
    """ZeRO-1 on one card, GPT-2 medium uncut, B=8 × S=1024, bf16 over f32
    master, AdamW(1e-3), one warm-up and ``steps`` timed steps a leg from
    the train legs' seeds: replicated_raw (the yardstick), zero_raw,
    zero_onebit_ef (the whole vector one onebit chunk), zero_topk_block_ef
    (k = 0.01 of the whole vector: the strided layout). zero_raw's losses
    and parameter digest equal replicated_raw's bit for bit (n = 1
    aggregates nothing and AdamW is elementwise); every leg's losses
    :func:`falls`; each ZeRO leg's moments are exactly 2·ceil(L/n)·4 B
    (n = 1: the replicated leg's); per step the flash kernels launch once
    a layer, onebit pack and unpack-sum once each (one round trip of the
    whole vector), top-k select and reconstruct-sum once each and the
    tiled round trip never. Returns the ZeRO legs' launch counts, each
    leg counted from 0."""
    from byteps_tpu_torch.models import (GPTConfig, make_gpt_train_step,
                                         synthetic_batch)
    from byteps_tpu_torch.ops import launches, reset_launches

    cfg = GPTConfig.gpt2_medium()
    calls = steps + 1
    legs, total = {}, {}
    # (leg, compression, zero_1); replicated_raw is the yardstick
    for leg, comp, zero in (("replicated_raw", None, False),
                            ("zero_raw", None, True),
                            ("zero_onebit_ef", ONEBIT_EF, True),
                            ("zero_topk_block_ef", TOPK_BLOCK_EF, True)):
        reset_launches()
        step, params, opt = make_gpt_train_step(
            cfg, compression_params=comp, zero_1=zero,
            generator=torch.Generator(device="cuda").manual_seed(0))
        tok, tgt = synthetic_batch(
            torch.Generator(device="cuda").manual_seed(1), cfg, B, S)
        r = timed_train(step, opt, tok, tgt, steps)
        r["launches"] = dict(launches)
        L = sum(p.numel() for p in opt.params)
        if not falls(r["losses"]):
            raise AssertionError(f"train_zero {leg}: losses {r['losses']}")
        if r["moment_bytes"] != 2 * L * 4:
            raise AssertionError(f"train_zero {leg}: moments "
                                 f"{r['moment_bytes']} B, not 2 x {L} x 4")
        legs[leg] = {"compression": comp, "zero_1": zero, **r}
        del step, params, opt
        gc.collect()
        torch.cuda.empty_cache()
        if zero:
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
    if L != ZERO_N:
        raise AssertionError(f"GPT-2 medium has {L} parameters, not {ZERO_N}")
    base, z = legs["replicated_raw"], legs["zero_raw"]
    if (z["losses"] != base["losses"]
            or z["params_sha1"] != base["params_sha1"]):
        raise AssertionError(f"train_zero: zero_raw {z['losses']} differs "
                             f"from replicated_raw {base['losses']}")
    per_layer = {k: calls * cfg.n_layers for k in TRAIN}
    want = {"zero_raw": {**per_layer, "onebit_pack": 0,
                         "onebit_unpack_sum": 0, "topk_select": 0,
                         "topk_reconstruct_sum": 0, "topk_roundtrip": 0},
            "zero_onebit_ef": {**per_layer, "onebit_pack": calls,
                               "onebit_unpack_sum": calls,
                               "topk_select": 0, "topk_reconstruct_sum": 0,
                               "topk_roundtrip": 0},
            "zero_topk_block_ef": {**per_layer, "onebit_pack": 0,
                                   "onebit_unpack_sum": 0,
                                   "topk_select": calls,
                                   "topk_reconstruct_sum": calls,
                                   "topk_roundtrip": 0}}
    for leg, w in want.items():
        got = legs[leg]["launches"]
        bad = {k: (got[k], v) for k, v in w.items() if got[k] != v}
        if bad:
            raise AssertionError(f"train_zero {leg}: launches (got, want) "
                                 f"{bad}")
    emit({"phase": "train_zero", "batch": B, "seq": S, "steps": steps,
          "params": L, "zero_raw_equals_replicated": True, "legs": legs})
    return total


ACCUM_LEGS = (2, 4)


def phase_train_accum(B=8, S=1024, steps=2) -> dict:
    """Gradient accumulation at GPT-2 medium's full width: B=8 × S=1024 a
    step as ``accum_steps`` = 2 and 4 microbatches (4 and 2 rows), raw,
    from the train legs' seeds, one warm-up and ``steps`` timed steps a
    leg. Losses :func:`falls`; peak memory below the train_raw leg's
    (accum_steps = 1, the same batch); the flash kernels exactly accum x
    24 a step each. Returns the legs' launch counts, each leg counted
    from 0."""
    from byteps_tpu_torch.models import (GPTConfig, make_gpt_train_step,
                                         synthetic_batch)
    from byteps_tpu_torch.ops import launches, reset_launches

    cfg = GPTConfig.gpt2_medium()
    legs, total = {}, {}
    for accum in ACCUM_LEGS:
        reset_launches()
        step, params, opt = make_gpt_train_step(
            cfg, accum_steps=accum,
            generator=torch.Generator(device="cuda").manual_seed(0))
        tok, tgt = synthetic_batch(
            torch.Generator(device="cuda").manual_seed(1), cfg, B, S)
        r = timed_train(step, opt, tok, tgt, steps)
        r["launches"] = dict(launches)
        del step, params, opt
        gc.collect()
        torch.cuda.empty_cache()
        leg = f"accum{accum}"
        if not falls(r["losses"]):
            raise AssertionError(f"train_accum {leg}: losses {r['losses']}")
        if not r["max_memory_allocated"] < TRAIN_PEAK["raw"]:
            raise AssertionError(
                f"train_accum {leg}: peak {r['max_memory_allocated']} B not "
                f"below accum_steps=1's {TRAIN_PEAK['raw']}")
        want = (steps + 1) * accum * cfg.n_layers
        bad = {k: r["launches"][k] for k in TRAIN if r["launches"][k] != want}
        if bad:
            raise AssertionError(f"train_accum {leg}: launches {bad}, not "
                                 f"{want} each")
        legs[leg] = r
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    emit({"phase": "train_accum", "batch": B, "seq": S, "steps": steps,
          "accum1_max_memory_allocated": TRAIN_PEAK["raw"], "legs": legs})
    return total


def phase_eval(B=8, S=1024, steps=2) -> dict:
    """``evaluate_perplexity`` of ``make_eval_step`` at GPT-2 medium's
    full width on two B=8 × S=1024 batches, before and after the raw
    training step's warm-up and ``steps`` steps (taken on the two batches
    in turn) from the train legs' seeded weights: both finite, the second
    lower, the first below 2 x vocab. Each evaluation runs with the launch
    counts at 0 and must launch the forward 24 times a batch and the
    backward kernels never. Returns the two evaluations' counts, summed."""
    from byteps_tpu_torch.models import (GPTConfig, evaluate_perplexity,
                                         make_eval_step, make_gpt_train_step,
                                         synthetic_batch)
    from byteps_tpu_torch.ops import launches, reset_launches

    cfg = GPTConfig.gpt2_medium()
    step, params, _ = make_gpt_train_step(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    batches = [synthetic_batch(torch.Generator(device="cuda").manual_seed(s),
                               cfg, B, S) for s in (1, 2)]
    ev = make_eval_step(cfg)
    ppl, counts, total, ms = [], [], {}, []
    for phase in ("before", "after"):
        if phase == "after":
            for i in range(steps + 1):
                step(*batches[i % 2])
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        ppl.append(evaluate_perplexity(ev, params, batches))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        c = dict(launches)
        want = {"flash_fwd": len(batches) * cfg.n_layers,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        bad = {k: (c[k], v) for k, v in want.items() if c[k] != v}
        if bad:
            raise AssertionError(f"eval {phase}: launches (got, want) {bad}")
        counts.append(c)
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    del step, params
    if not (np.isfinite(ppl).all() and ppl[1] < ppl[0] < 2 * cfg.vocab_size):
        raise AssertionError(f"eval: perplexity {ppl[0]} -> {ppl[1]}")
    emit({"phase": "eval", "batches": len(batches), "batch": B, "seq": S,
          "train_steps": steps + 1, "perplexity_before": ppl[0],
          "perplexity_after": ppl[1], "vocab": cfg.vocab_size,
          "eval_ms": ms, "launches": counts})
    return total


EXAMPLES = "examples/torch_port"
# launch_global's depth (GPT-2 medium at full width): two processes on
# the card, each saving its parameters every step
LAUNCH_GLOBAL_LAYERS = 2
LAUNCH_GLOBAL_STEPS = 2
LAUNCH_GLOBAL_BATCH = (4, 512)


def launcher_env(root, **kv) -> dict:
    """This environment without a job's DMLC_* and launcher knobs, plus
    ``kv``."""
    import os

    env = dict(os.environ, PYTHONPATH=str(root))
    for k in ("DMLC_ROLE", "DMLC_WORKER_ID", "DMLC_NUM_WORKER",
              "BYTEPS_LOCAL_SIZE", "BYTEPS_JAX_DISTRIBUTED"):
        env.pop(k, None)
    env.update({k: str(v) for k, v in kv.items()})
    return env


def by_worker(pattern: str, out: str, n: int = 2) -> list:
    """Each worker's matches of ``pattern`` (after its ``[worker i]``
    tag) in the launcher's merged output: the children share one pipe,
    and ``print`` writes a line and its newline apart, so two workers'
    lines may run together."""
    found = [[] for _ in range(n)]
    for w, m in re.findall(r"\[worker (\d+)\] " + pattern, out):
        found[int(w)].append(m)
    return found


def phase_examples(card: str) -> dict:
    """The port's examples as their docstrings run them, started through
    the launcher's roles (``python -m byteps_tpu_torch.launcher``), three
    jobs at once. MNIST and the benchmark: each one server
    (``DMLC_ROLE=server``) and one worker launcher (``DMLC_ROLE=worker``,
    ``BYTEPS_LOCAL_SIZE=2``: two workers on the card, the single-host
    simulation's ``DMLC_WORKER_ID`` a child). The MNIST example (2 epochs
    of 2,048 samples, ``--print-digest``): every worker's loss falls from
    epoch to epoch and both end with the same parameters. The benchmark
    example (25 MB in 8 tensors, 5 iterations): its GB/s line, beside the
    card's name and power limit. Each server exits 0 after the workers'
    goodbyes, and every process is killed on any other way out.
    launch_global: ``BYTEPS_JAX_DISTRIBUTED=1`` through the worker role,
    whose bootstrap forms a gloo world of 2 before
    ``checkpoint_resume.py`` runs (GPT-2 medium, ``LAUNCH_GLOBAL_*``):
    both ranks report the restored checkpoint matching and equal
    digests, and their flash launches are the forward (wgmma), dq and
    dk/dv once a layer and step."""
    import shutil
    import tempfile
    from pathlib import Path

    from byteps_tpu_torch.server import native

    root = Path(__file__).resolve().parent
    native.build()
    launcher = [sys.executable, "-m", "byteps_tpu_torch.launcher"]

    def run(env, cmd):
        """The worker launcher's merged output and wall seconds."""
        t0 = time.perf_counter()
        p = subprocess.Popen(launcher + cmd, env=env, cwd=root,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
        try:
            out, err = p.communicate(timeout=300)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        if p.returncode != 0:
            raise AssertionError(f"examples {cmd[-1]}: the worker launcher "
                                 f"exited {p.returncode}: {err[-2000:]}")
        return out, time.perf_counter() - t0

    def job(script, args, port, n=2):
        env = launcher_env(root, DMLC_NUM_WORKER=n, DMLC_NUM_SERVER=1,
                           DMLC_PS_ROOT_URI="127.0.0.1",
                           DMLC_PS_ROOT_PORT=port - 1)
        server = subprocess.Popen(
            launcher, env={**env, "DMLC_ROLE": "server",
                           "DMLC_SERVER_ID": "0"},
            cwd=root, stdout=sys.stderr)
        try:
            out, wall = run({**env, "DMLC_ROLE": "worker",
                             "DMLC_WORKER_ID": "0",
                             "BYTEPS_LOCAL_SIZE": str(n)},
                            [sys.executable, str(root / EXAMPLES / script),
                             *args])
            if server.wait(timeout=60) != 0:
                raise AssertionError(f"examples {script}: the server exited "
                                     f"{server.returncode}")
            return out, wall
        finally:
            if server.poll() is None:
                server.kill()
                server.wait()

    def launch_global(port):
        ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        B, S = LAUNCH_GLOBAL_BATCH
        env = launcher_env(root, DMLC_ROLE="worker", DMLC_NUM_WORKER=2,
                           DMLC_WORKER_ID=0, BYTEPS_LOCAL_SIZE=2,
                           BYTEPS_JAX_DISTRIBUTED=1,
                           DMLC_PS_ROOT_URI="127.0.0.1",
                           DMLC_PS_ROOT_PORT=port)
        try:
            return run(env, [
                sys.executable, str(root / EXAMPLES / "checkpoint_resume.py"),
                "--config", "gpt2_medium",
                "--layers", str(LAUNCH_GLOBAL_LAYERS),
                "--batch", str(B), "--seq", str(S),
                "--steps", str(LAUNCH_GLOBAL_STEPS), "--ckpt-dir", ckpt,
                "--print-digest", "--print-launches"])
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)

    from concurrent.futures import ThreadPoolExecutor

    ports = []                   # three jobs, each its own port pair
    while len(ports) < 3:
        p = free_port_pair()
        if all(abs(p - q) > 1 for q in ports):
            ports.append(p)
    with ThreadPoolExecutor(3) as ex:
        mnist = ex.submit(job, "train_mnist_byteps.py",
                          ["--samples", "2048", "--print-digest"], ports[0])
        bench = ex.submit(job, "benchmark_byteps.py", ["--num-iters", "5"],
                          ports[1])
        glob = ex.submit(launch_global, ports[2])
        (mnist_out, mnist_s), (bench_out, bench_s), (g_out, g_s) = (
            mnist.result(), bench.result(), glob.result())
    losses = [[float(v) for v in ls] for ls in by_worker(
        r"epoch \d+: loss=(\d+\.\d{4})", mnist_out)]
    if not all(len(ls) == 2 and ls[1] < ls[0] for ls in losses):
        raise AssertionError(f"examples mnist: losses {losses} not falling")
    sha1 = r"params sha1=([0-9a-f]{40})"
    digests = by_worker(sha1, mnist_out)
    if len(digests[0]) != 1 or digests[0] != digests[1]:
        raise AssertionError(f"examples mnist: the workers' parameters "
                             f"differ: {digests}")
    line = re.findall(r"push_pull: [^\n\[]*workers\)", bench_out)
    if len(line) != 1:
        raise AssertionError(f"examples benchmark: no rate line: "
                             f"{bench_out}")
    g_digests, g_launches = by_worker(sha1, g_out), []
    want = {k: LAUNCH_GLOBAL_STEPS * LAUNCH_GLOBAL_LAYERS for k in TRAIN}
    matches = by_worker(r"restored checkpoint matches live params: (\w+)",
                        g_out)
    launch_lines = by_worker(r"launches (\{[^}]*\})", g_out)
    for rank in range(2):
        if matches[rank] != ["True"] or len(launch_lines[rank]) != 1:
            raise AssertionError(f"launch_global: rank {rank}: {g_out}")
        counts = json.loads(launch_lines[rank][0])
        got = {k: counts.get(k, 0) for k in TRAIN + ("flash_fwd_split",)}
        if got != {**want, "flash_fwd_split": 0}:
            raise AssertionError(f"launch_global: rank {rank} launched "
                                 f"{got}, predicted {want} (wgmma)")
        g_launches.append(got)
    if len(g_digests[0]) != 1 or g_digests[0] != g_digests[1]:
        raise AssertionError(f"launch_global: the ranks' parameters "
                             f"differ: {g_digests}")
    res = {"phase": "examples", "mnist_losses": losses,
           "mnist_params_sha1": digests[0][0], "mnist_wall_s": mnist_s,
           "benchmark": line[0],
           "benchmark_wall_s": bench_s,
           "launch_global": {
               "layers": LAUNCH_GLOBAL_LAYERS, "steps": LAUNCH_GLOBAL_STEPS,
               "batch_per_rank": list(LAUNCH_GLOBAL_BATCH), "world": 2,
               "matches": [True, True], "params_sha1": g_digests[0][0],
               "launches_by_rank": g_launches, "wall_s": g_s},
           "card": card}
    emit(res)
    return res


# --------------------------------------------------------------------------
# phases 10-11: the ring tier, ranks as processes that share the card
# --------------------------------------------------------------------------
# GPT-2 medium's gradient in default partitions: 346 full chunks of
# 1,024,000 f32 and a tail of 567,296; randomk keeps k = 0.01 of a segment
GPT2M_PARAMS = 354_871_296
# The depth of the rank phases that share the card and move whole
# gradients through servers or over meshes (GPT-2 medium at full width,
# its 24 layers cut so the whole smoke stays inside its limit with
# train_pipeline and train_moe added, train_parallel's with
# train_multislice, train_multislice's, train_dcn's and train_chaos's
# with sharded_decode, and train_ring's and train_hybrid's to keep it
# inside on slower hosts: every check of those two is a bit-equality,
# which holds at any depth; each phase names its depth in its output line.
# train_parallel's limits hold at 12 layers, and its onebit leg's loss
# gap does not at 8: 0.115 against 0.1, NVIDIA H100 80GB HBM3, 700 W;
# train_chaos, the longest rank phase, at 2 since process_tier came in:
# its checks are bit-equalities and exact counts, which hold at any depth)
RANK_PHASE_LAYERS = {"train_ring": 8, "train_dcn": 4, "train_hybrid": 4,
                     "train_chaos": 2, "train_parallel": 12,
                     "train_multislice": 12}
# the legs that run the ring tier over a mesh subgroup (a dp line, the
# slice_ line), each held bit-equal to its staged twin
RING_TIER_TWIN = {"dp2_tp2_onebit_ring": "dp2_tp2_onebit_ef",
                  "slice2_dp2_onebit_ef_ring": "slice2_dp2_onebit_ef"}


@contextlib.contextmanager
def ici_tier(tier):
    """``BYTEPS_ICI_TIER`` set to ``tier`` (None: left as it is) while the
    block runs; the port's config re-read on the way in and out."""
    import os

    from byteps_tpu_torch.common.config import reset_config

    old = os.environ.get("BYTEPS_ICI_TIER")
    if tier is not None:
        os.environ["BYTEPS_ICI_TIER"] = tier
    reset_config()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("BYTEPS_ICI_TIER", None)
        else:
            os.environ["BYTEPS_ICI_TIER"] = old
        reset_config()


def close_rings(mesh, axes=("dp", "slice_")) -> None:
    """Free the ring workspaces of this rank's lines of ``axes`` on
    ``mesh`` (collective over each line), before its groups go."""
    from byteps_tpu_torch.ops import ring_collective_kernels as rk

    for name in axes:
        if name in mesh.axis_names and mesh.axis_size(name) > 1:
            rk.close_workspaces(mesh.group(name))


def rank_phase_cfg(phase: str):
    """GPT-2 medium at ``phase``'s depth (:data:`RANK_PHASE_LAYERS`)."""
    from byteps_tpu_torch.models import GPTConfig

    cfg = GPTConfig.gpt2_medium()
    return dataclasses.replace(
        cfg, n_layers=RANK_PHASE_LAYERS.get(phase, cfg.n_layers))


def gpt_param_count(cfg) -> int:
    """The parameters of a GPT-2-style ``cfg`` (learned positions,
    layernorm, biases, the gelu MLP, tied readout): 354,871,296 for
    GPT-2 medium."""
    d, ff = cfg.d_model, cfg.d_ff
    block = 4 * d * d + 2 * d * ff + 9 * d + ff
    return cfg.vocab_size * d + cfg.max_seq * d + 2 * d + cfg.n_layers * block
CHUNK = 4096000 // 4
TAIL = GPT2M_PARAMS % CHUNK
RANDOMK_K = 0.01
RING_NS = (2, 3, 4)
RING_CALLS = 2000            # back-to-back calls of the race check
# randomk, ring against staged: the chain and the worker-order fold add
# the same n terms in other orders. Values are scaled by seg/k (about
# 100), so a sum that nearly cancels keeps its terms' absolute roundoff:
# held to 1e-5 of the chunk's largest value
RING_TOL = 1e-5


# the rank bodies that run on the kept rank processes (:class:`RankPool`);
# the DCN phases' bodies (their servers, the torch adapter's worker state,
# their DMLC_* settings) keep fresh processes
POOLED_BODIES = ("ring_rank", "train_ring_rank", "train_parallel_rank",
                 "train_pipeline_rank", "train_moe_rank",
                 "train_multislice_rank", "sharded_decode_rank")
POOL_RANKS = 4
_POOL: list = []             # the live RankPool, if any


def spawn_ranks(body, n, *args, timeout=900):
    """Run ``body(rank, n, *args)`` on ``n`` rank processes that share a
    gloo group over a FileStore on card 0; return each rank's result,
    raising if any rank failed. A body of POOLED_BODIES runs on ranks 0 to
    n - 1 of the kept :class:`RankPool` (started at its first use), any
    other on ``n`` fresh processes (``spawn``: the parent already holds a
    CUDA context), all gone on return."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ring_")
    try:
        if body.__name__ in POOLED_BODIES:
            return rank_pool().run(body.__name__, n, f"{tmp}/store", args,
                                   timeout)
        return fresh_ranks(body.__name__, n, f"{tmp}/store", args, timeout)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def collect_results(name, q, procs, n, timeout) -> list:
    """Each of ranks 0 to n - 1's result from ``q``, in rank order;
    raise if a rank reported a failure, died (``procs``: its process)
    or gave nothing in ``timeout`` seconds."""
    res = {}
    deadline = time.monotonic() + timeout
    while len(res) < n:
        left = deadline - time.monotonic()
        if left <= 0:
            raise AssertionError(f"{name}: ranks "
                                 f"{sorted(set(range(n)) - set(res))} "
                                 f"gave no result in {timeout} s")
        try:
            r = q.get(timeout=min(left, 5.0))
        except Exception:          # queue.Empty: is every rank alive?
            dead = [i for i, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and i not in res]
            if dead:
                raise AssertionError(
                    f"{name}: rank(s) {dead} died "
                    f"(exit {[procs[i].exitcode for i in dead]})")
            continue
        res[r["rank"]] = r
    failed = {k: v["failed"] for k, v in res.items() if "failed" in v}
    if failed:
        raise AssertionError(f"{name} failed:\n"
                             + "\n".join(f"rank {k}: {v}"
                                         for k, v in failed.items()))
    return [res[r] for r in range(n)]


def fresh_ranks(name, n, store, args, timeout) -> list:
    """The body named ``name`` on ``n`` new processes, joined (or killed)
    before this returns."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=rank_entry, args=(name, r, n, store, q)
                         + tuple(args)) for r in range(n)]
    done = False
    try:
        for p in procs:
            p.start()
        out = collect_results(name, q, procs, n, timeout)
        done = True
        return out
    finally:
        for p in procs:
            if p.pid is None:              # never started
                continue
            p.join(timeout=60 if done else 0)
            if p.is_alive():
                p.kill()
                p.join()


class RankPool:
    """POOL_RANKS rank processes (``spawn``) kept from one rank phase to
    the next. A fresh process takes ~8-10 s to reach the card (its
    imports and CUDA context), which every spawn of a phase paid; a kept
    one runs each body handed to it as a rank of a new gloo group
    (:func:`pool_entry`). A failed or late body closes the pool, and the
    next use starts another."""

    def __init__(self, size=POOL_RANKS):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(size)]
        self.procs = [ctx.Process(target=pool_entry,
                                  args=(r, self.tasks[r], self.results),
                                  daemon=True) for r in range(size)]
        for p in self.procs:
            p.start()

    def run(self, name, n, store, args, timeout) -> list:
        if n > len(self.procs):
            raise ValueError(f"{name}: {n} ranks, the pool has "
                             f"{len(self.procs)}")
        for r in range(n):
            self.tasks[r].put((name, n, store, tuple(args)))
        done = False
        try:
            out = collect_results(name, self.results, self.procs[:n], n,
                                  timeout)
            done = True
            return out
        finally:
            if not done:
                close_pool(kill=True)

    def close(self, kill=False) -> None:
        """Stop every process: told to (their bodies done), or killed."""
        if not kill:
            for q, p in zip(self.tasks, self.procs):
                if p.is_alive():
                    q.put(None)
        for p in self.procs:
            p.join(timeout=0 if kill else 60)
            if p.is_alive():
                p.kill()
                p.join()


def rank_pool() -> RankPool:
    if not _POOL:
        _POOL.append(RankPool())
    return _POOL[0]


def close_pool(kill=False) -> None:
    """Stop the kept rank processes, if any."""
    if _POOL:
        _POOL.pop().close(kill)


def pool_entry(rank, tasks, q):
    """A kept rank process: run each body handed to it as ``rank``
    (:func:`run_rank_body`) until it is handed None, each from a fresh
    process's state: the launch, collective and metric counts at 0, torch's
    default generators at their first seed; and after each restore its
    environment (bodies set BYTEPS_* settings), the port's config, torch's
    thread count and the card memory it cached; stop after a failed
    body."""
    import os

    from byteps_tpu_torch.common.config import reset_config
    from byteps_tpu_torch.common.metrics import reset_registry
    from byteps_tpu_torch.ops import reset_launches
    from byteps_tpu_torch.parallel.mesh import reset_collectives

    seed = torch.initial_seed()
    while (task := tasks.get()) is not None:
        name, n, store, args = task
        env, threads = dict(os.environ), torch.get_num_threads()
        reset_launches()
        reset_collectives()
        reset_registry()
        torch.manual_seed(seed)
        ok = run_rank_body(name, rank, n, store, q, args)
        os.environ.clear()
        os.environ.update(env)
        reset_config()
        torch.set_num_threads(threads)
        gc.collect()
        torch.cuda.empty_cache()
        if not ok:
            return


def rank_entry(body_name, rank, n, store, q, *args):
    """A fresh rank process: one body (:func:`run_rank_body`)."""
    run_rank_body(body_name, rank, n, store, q, args)


def run_rank_body(body_name, rank, n, store, q, args) -> bool:
    """Join the gloo group on card 0 as ``rank`` of ``n``, run the body
    named ``body_name``, leave the group, and report its result or its
    failure (with any ring wait that ran past its bound) on the queue;
    True if the body succeeded."""
    import datetime
    import traceback

    import torch.distributed as dist

    from byteps_tpu_torch.ops import ring_collective_kernels as rk
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", store=dist.FileStore(store, n),
                                rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=300))
        res = globals()[body_name](rank, n, *args)
        rk.close_workspaces()
        dist.destroy_process_group()
        q.put({"rank": rank, **res})
        return True
    except Exception:               # reported to the parent, which fails
        q.put({"rank": rank, "failed": traceback.format_exc()
               + "".join(f"\n{e}" for e in rk.ring_errors())})
        return False


def ring_cases(n: int) -> list:
    """(name, op, leaves) of the ring phase at n ranks, leaves a tuple of
    (key, dtype, row shape): the training step's payload rows (onebit
    words of a full and of the tail chunk's segment, the f32 scale,
    randomk's values), an odd uint8 row, a row past the workspace's first
    64 KB slots (the ranks grow it together; every later call runs on the
    grown one), an int32 row, and two payloads of several leaves in one
    tree call: onebit's signs and scale (the main path's call), and the
    tail's signs, the scale and an odd uint8 leaf (a leaf of 1,003 bytes
    ahead of the others in the slot)."""
    from byteps_tpu_torch.compression.topk import resolve_k
    from byteps_tpu_torch.ops.onebit_kernels import packed_words

    seg, tseg = -(-CHUNK // n), -(-TAIL // n)
    k = resolve_k(RANDOMK_K, seg)
    signs = ("signs", torch.int32, (packed_words(seg),))
    scale = ("scale", torch.float32, (1,))
    cases = []
    for name, leaves in (
            ("signs_full", (("x",) + signs[1:],)),
            ("signs_tail", (("x", torch.int32, (packed_words(tseg),)),)),
            ("scale", (("x",) + scale[1:],)),
            ("randomk_values", (("x", torch.float32, (k,)),)),
            ("odd_uint8", (("x", torch.uint8, (1003,)),)),
            ("grow_uint8", (("x", torch.uint8, (300_001,)),)),
            ("int32", (("x", torch.int32, (4, 250)),)),
            ("onebit_tree", (signs, scale)),
            ("odd_tree", (("signs", torch.int32, (packed_words(tseg),)),
                          scale, ("odd", torch.uint8, (1003,))))):
        for op in ("collect", "gather"):
            cases.append((name, op, leaves))
    cases.append(("randomk_values", "presum",
                  (("x", torch.float32, (k,)),)))
    return cases


def ring_input(i, op, leaves, n, rank) -> dict:
    """Case ``i``'s payload on ``rank``, from a seed of its own."""
    g = torch.Generator(device="cuda").manual_seed(1000 * rank + i)
    out = {}
    for key, dt, row in leaves:
        shape = row if op == "gather" else (n,) + row
        if dt == torch.float32:
            out[key] = torch.randn(shape, generator=g, device="cuda")
            continue
        hi = 256 if dt == torch.uint8 else 2 ** 31 - 1
        out[key] = torch.randint(0 if dt == torch.uint8 else -hi, hi, shape,
                                 generator=g, device="cuda", dtype=dt)
    return out


def ring_call(rk, op, payload, group=None) -> dict:
    """The public call of ``op`` on ``payload`` over ``group`` (the
    default group when None): a leaf alone through
    ``ring_collect``/``ring_allgather``/``ring_presum``, several through
    the tree calls."""
    if op == "presum":
        return {"x": rk.ring_presum(payload["x"], group=group)}
    if len(payload) == 1:
        fn = rk.ring_collect if op == "collect" else rk.ring_allgather
        return {"x": fn(payload["x"], group=group)}
    fn = rk.ring_collect_tree if op == "collect" else rk.ring_allgather_tree
    return fn(payload, group=group)


def ring_outputs(rk, op, payload, n):
    """(empty outputs, the rotate's (src, out, slot offset) leaves or None,
    the slot span) of a bare call."""
    if op == "presum":
        x = payload["x"]
        out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
        return {"x": out}, None, out.numel() * 4
    gather = op == "gather"
    outs = {k: torch.empty((n,) + tuple(x.shape[0 if gather else 1:]),
                           dtype=x.dtype, device=x.device)
            for k, x in payload.items()}
    layout, span = rk.slot_layout({k: (o.shape[1:], o.dtype)
                                   for k, o in outs.items()})
    return outs, [(payload[k], o, layout[k][0]) for k, o in outs.items()], \
        span


def ring_bytes(op, n, row_bytes):
    """(bytes read, bytes written) of one call: each input once, each
    output once."""
    return {"collect": (n * row_bytes, n * row_bytes),
            "gather": (row_bytes, n * row_bytes),
            "presum": (n * row_bytes, row_bytes)}[op]


def ring_kernel_ms(payload, op, n, rank, iters=20):
    """The median of CUDA events around the bare call (push, the stream's
    waits, land; presum's n kernels and n-1 waits), after the ranks drain
    their streams and meet on the host (the ranks time-slice the card)."""
    import statistics

    import torch.distributed as dist

    from byteps_tpu_torch.ops import ring_collective_kernels as rk

    x = next(iter(payload.values()))
    ws = rk.workspace(x.device)
    outs, leaves, span = ring_outputs(rk, op, payload, n)
    evs = []
    for _ in range(iters):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        epoch = ws.prepare(span)
        torch.cuda.current_stream().synchronize()
        dist.barrier()
        ev[0].record()
        if op == "presum":
            rk.launch_presum(ws, x, outs["x"], n, rank, epoch)
        else:
            rk.launch_rotate(ws, leaves, n, rank, op == "gather", epoch)
        ev[1].record()
        evs.append(ev)
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def ring_library_ms(payload, op, n, iters=20):
    """{"library_ms": the median of CUDA events around the one PyTorch call
    of the same function on the same CUDA rows, gloo's
    ``all_to_all_single`` (collect), ``all_gather`` (gather) or
    ``reduce_scatter`` (presum), after the ranks meet on the host as for
    the kernel's time}; null and the reason where gloo refuses the
    tensors, or where no one call moves a payload of several leaves."""
    import statistics

    import torch.distributed as dist

    if len(payload) > 1:
        return {"library_ms": None,
                "library_refused": "no one PyTorch call moves a payload's "
                                   "leaves"}
    x = payload["x"]
    if op == "collect":
        out = torch.empty_like(x)
        call = lambda: dist.all_to_all_single(out, x)           # noqa: E731
    elif op == "gather":
        outs = [torch.empty_like(x) for _ in range(n)]
        call = lambda: dist.all_gather(outs, x)                 # noqa: E731
    else:
        out, ins = torch.empty_like(x[0]), list(x.unbind(0))
        call = lambda: dist.reduce_scatter(out, ins)            # noqa: E731
    evs = []
    try:
        for _ in range(iters):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            torch.cuda.current_stream().synchronize()
            dist.barrier()
            ev[0].record()
            call()
            ev[1].record()
            evs.append(ev)
    except RuntimeError as e:        # gloo's refusal, the same on each rank
        return {"library_ms": None, "library_refused": str(e)[:200]}
    torch.cuda.synchronize()
    return {"library_ms": statistics.median(a.elapsed_time(b)
                                            for a, b in evs)}


def ring_switch_ms(rank, rounds=200):
    """Ranks 0 and 1 bounce an empty push ``rounds`` times, back to back
    (rank 0 signals then its stream waits, rank 1 waits then signals):
    host clock over the rounds, per round. A round is two switches of a
    time-sliced card between the ranks' contexts."""
    import torch.distributed as dist

    from byteps_tpu_torch.ops import ring_collective_kernels as rk

    ws = rk.workspace(torch.device("cuda", 0))
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(rounds):
        epoch = ws.prepare(0)
        p = (epoch & 1) * 2
        if rank == 0:
            rk.launch_push(ws, [], 2, 0, False, epoch)
            rk.wait_flag(ws, p + 1, epoch)
        else:
            rk.wait_flag(ws, p, epoch)
            rk.launch_push(ws, [], 2, 1, False, epoch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / rounds


def ring_dead_peer(rank, n):
    """The last rank holds back its call: every other rank's check must
    raise within the workspace's bound (set to 2 s here), naming the
    epoch and the late rank's flag, instead of hanging; then the late
    call releases their streams."""
    import torch.distributed as dist

    from byteps_tpu_torch.ops import ring_collective_kernels as rk

    ws = rk.workspace(torch.device("cuda", 0))
    ws.wait_bound_s = 2.0
    late, res = n - 1, {}
    x = torch.full((n, 16), rank, dtype=torch.int32, device="cuda")
    if rank != late:
        rk.ring_collect(x)
        epoch, t0, err = ws.epoch, time.monotonic(), None
        while err is None and time.monotonic() - t0 < 60:
            time.sleep(0.2)
            try:
                ws.check()
            except RuntimeError as e:
                err = str(e)
        want = (f"epoch {epoch}", f"source {late})")
        if err is None or not all(w in err for w in want):
            raise AssertionError(f"dead peer at n={n}: rank {rank}'s check "
                                 f"gave {err!r}, not an error naming {want}")
        res = {"dead_peer_error": err, "dead_peer_raised_s":
               time.monotonic() - t0}
    dist.barrier()
    if rank == late:
        rk.ring_collect(x)
    torch.cuda.synchronize()
    return res


def ring_rank(rank, n):
    """One rank of the ring phase: every case's kernel output against
    the plain version over gloo on CPU copies, timed; the race check;
    the chunk-level tiers on the card; at n = 2 the switch; last, a rank
    that holds back its call."""
    import statistics

    from byteps_tpu_torch.comm.ici import compressed_allreduce_local
    from byteps_tpu_torch.compression import (OnebitCompressor,
                                              RandomkCompressor,
                                              TopkCompressor)
    from byteps_tpu_torch.ops import launches
    from byteps_tpu_torch.ops import ring_collective_kernels as rk

    res = {"cases": []}
    for i, (name, op, leaves) in enumerate(ring_cases(n)):
        x = ring_input(i, op, leaves, n, rank)
        kernel = "ring_presum" if op == "presum" else "ring_rotate"
        before = launches[kernel]
        got = ring_call(rk, op, x)
        torch.cuda.synchronize()
        if launches[kernel] != before + 1:
            raise AssertionError(f"ring {op} {name} did not launch once")
        xc = {k: v.cpu() for k, v in x.items()}
        plain = ring_call(rk, op, xc)
        equal = got.keys() == plain.keys() and all(
            got[k].dtype == plain[k].dtype and torch.equal(
                got[k].cpu().view(torch.uint8), plain[k].view(torch.uint8))
            for k in got)
        if not equal:
            raise AssertionError(f"ring {op} {name} at n={n}: the kernel "
                                 "differs from the plain version")
        ms, lib_ms = ring_kernel_ms(x, op, n, rank), ring_library_ms(x, op, n)
        torch.cuda.synchronize()
        plain_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            ring_call(rk, op, xc)
            plain_ms.append((time.perf_counter() - t0) * 1e3)
        row_bytes = sum(int(np.prod(row)) * dt.itemsize
                        for _, dt, row in leaves)
        res["cases"].append({
            "case": name, "op": op,
            "leaves": [[k, str(dt).split(".")[1], list(row)]
                       for k, dt, row in leaves],
            "row_bytes": row_bytes, "bit_equal": True, "ms": ms,
            "plain_ms": statistics.median(plain_ms), **lib_ms})
    # the race check: back-to-back calls cycling collect, gather and
    # presum over changing contents, against what each rank knows the
    # others sent (rank w's row i is base + 7 i + 1000 w)
    base = torch.arange(n * 64, device="cuda", dtype=torch.int32).reshape(
        n, 64)
    wrong = torch.zeros((), dtype=torch.int64, device="cuda")
    ranks = torch.arange(n, device="cuda", dtype=torch.int32)[:, None]
    for i in range(RING_CALLS):
        mine = base + 7 * i + 1000 * rank
        every = base[rank] + 7 * i + 1000 * ranks        # (n, 64)
        op = ("collect", "gather", "presum")[i % 3]
        if op == "collect":
            wrong += (rk.ring_collect(mine) != every).sum()
        elif op == "gather":
            got = rk.ring_allgather(mine[0])
            wrong += (got != base[0] + 7 * i + 1000 * ranks).sum()
        else:                          # integer f32 sums are exact
            got = rk.ring_presum(mine.float())
            wrong += (got != every.float().sum(0)).sum()
    if int(wrong):
        raise AssertionError(f"ring race check at n={n}: {int(wrong)} "
                             f"elements wrong over {RING_CALLS} calls")
    res["race_calls"], res["race_wrong"] = RING_CALLS, 0
    ws = rk.workspace(base.device)
    if (ws.layout, ws.protocol) != ("same_card", "stream"):
        raise AssertionError(f"ranks on one card took {ws.protocol} "
                             f"({ws.layout}), not the stream protocol")
    res.update(slot_bytes=ws.cap, layout=ws.layout, protocol=ws.protocol)
    # chunk level on the card: ring == staged bit for bit (deterministic
    # codecs, with error feedback); randomk the same support, values at
    # summation-order roundoff
    g = torch.Generator(device="cuda").manual_seed(50 + rank)
    x = torch.randn(CHUNK, generator=g, device="cuda")
    e = 0.1 * torch.randn(CHUNK, generator=g, device="cuda")
    for name, codec in (("onebit_ef", OnebitCompressor(scaling=True)),
                        ("topk_block_ef",
                         TopkCompressor(k=0.01, selection="block"))):
        a, ae = compressed_allreduce_local(x, codec, n, ef_residual=e,
                                           rng=7, tier="staged")
        b, be = compressed_allreduce_local(x, codec, n, ef_residual=e,
                                           rng=7, tier="ring")
        if not (torch.equal(a, b) and torch.equal(ae, be)):
            raise AssertionError(f"chunk {name} at n={n}: ring differs "
                                 "from staged")
        res[f"chunk_{name}_ring_equals_staged"] = True
    codec = RandomkCompressor(k=RANDOMK_K)
    a = compressed_allreduce_local(x, codec, n, rng=7, tier="staged")
    b = compressed_allreduce_local(x, codec, n, rng=7, tier="ring")
    if not torch.equal(a != 0, b != 0):
        raise AssertionError(f"chunk randomk at n={n}: ring and staged "
                             "keep different supports")
    diff, top = float((a - b).abs().max()), float(a.abs().max())
    if not diff <= RING_TOL * top:
        raise AssertionError(f"chunk randomk at n={n}: ring and staged "
                             f"values {diff} apart (largest {top})")
    res["chunk_randomk_same_support"] = True
    res["chunk_randomk_max_abs_diff"] = diff
    res["chunk_randomk_max_abs"] = top
    if n == 2:
        res["switch_round_trip_ms"] = ring_switch_ms(rank)
    res.update(ring_dead_peer(rank, n))
    return res


def ring_local_case(i, op, leaves, n, protocol, iters=50):
    """Case ``i`` at ``n`` in-process peers (``LocalPeers``: one workspace
    and stream a rank in this process, all n running at once, no
    time-slicing) under ``protocol`` on every rank's input of the ring
    phase: every rank's output bit-equal to what the ranks sent (presum:
    the chain's adds in its order), and the median of CUDA events around
    a call of all n. A ~1 ms sleep kernel ahead of the start event holds
    the card while the host issues the n calls, so the events see the
    kernels and the stream waits, not the host."""
    import statistics

    from byteps_tpu_torch.ops import ring_collective_kernels as rk

    xs = [ring_input(i, op, leaves, n, r) for r in range(n)]
    if op == "presum":
        want = []
        for d in range(n):
            acc = xs[(d + 1) % n]["x"][d].clone()
            for t in range(2, n + 1):
                acc = acc + xs[(d + t) % n]["x"][d]
            want.append({"x": acc})
    elif op == "gather":
        want = [{k: torch.stack([x[k] for x in xs]) for k in xs[0]}] * n
    else:
        want = [{k: torch.stack([x[k][r] for x in xs]) for k in xs[0]}
                for r in range(n)]
    outs = [{k: torch.empty_like(w) for k, w in wr.items()} for wr in want]
    peers = rk.LocalPeers(n, ring_outputs(rk, op, xs[0], n)[2],
                          torch.device("cuda", 0), protocol)
    if op == "presum":
        call = lambda: peers.presum([x["x"] for x in xs],      # noqa: E731
                                    [o["x"] for o in outs])
    else:
        leaves = []
        for x, out in zip(xs, outs):
            _, lv, _ = ring_outputs(rk, op, x, n)
            leaves.append([(src, out[k], off)
                           for (src, _, off), k in zip(lv, x)])
        call = lambda: peers.rotate(leaves, op == "gather")    # noqa: E731
    evs = []
    for it in range(iters + 1):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        torch.cuda._sleep(2_000_000)          # cycles
        ev[0].record()
        call()
        ev[1].record()
        if it == 0:                 # check the first call and the last
            check = [{k: o.clone() for k, o in out.items()} for out in outs]
        else:
            evs.append(ev)
    torch.cuda.synchronize()
    for got in (check, outs):
        if not all(torch.equal(g[k].reshape(-1).view(torch.uint8),
                               w[k].reshape(-1).view(torch.uint8))
                   for g, w in zip(got, want) for k in w):
            raise AssertionError(f"ring {op} case {i} at {n} in-process "
                                 "peers: wrong output")
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def phase_ring() -> dict:
    """The ring kernels at 2, 3 and 4 ranks on the card. Returns the n = 2
    rows of the kernel table."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    main = {}
    for n in RING_NS:
        t0 = time.perf_counter()
        per_rank = spawn_ranks(ring_rank, n)
        cases = []
        for i, (c, spec) in enumerate(zip(per_rank[0]["cases"],
                                          ring_cases(n))):
            rd, wr = ring_bytes(c["op"], n, c["row_bytes"])
            lib = [r["cases"][i]["library_ms"] for r in per_rank]
            bound, by = bound_ms(rd + wr, 0, torch.float32)
            cases.append({
                **c, "ms": ring_local_case(i, *spec[1:], n, "stream"),
                "ms_spin": ring_local_case(i, *spec[1:], n, "spin"),
                # the slowest rank's median
                "ms_time_sliced": max(r["cases"][i]["ms"] for r in per_rank),
                "plain_ms": max(r["cases"][i]["plain_ms"] for r in per_rank),
                "library_ms": None if None in lib else max(lib),
                "bound_ms": bound, "bound_by": by, "max_abs_err": 0.0})
        r0 = {k: v for k, v in per_rank[0].items()
              if k not in ("cases", "rank", "switch_round_trip_ms")}
        emit({"phase": "ring", "ranks": n, "compute_mode": mode,
              "timing": "ms: CUDA events around a call of n in-process "
                        "peers running at once (the stream protocol, the "
                        "main path's; ms_spin: the spinning one, the "
                        "protocol of peers that run at once); "
                        "ms_time_sliced and "
                        "library_ms (gloo on the same CUDA rows): around "
                        "one rank process's call after the ranks meet, "
                        "median per rank, the slowest rank, the ranks "
                        "time-slicing the card",
              "wall_s": time.perf_counter() - t0, "cases": cases, **r0})
        if n == 2:
            trip = max(r["switch_round_trip_ms"] for r in per_rank)
            emit({"phase": "ring_switch", "ranks": 2,
                  "switch_ms": trip / 2, "round_trip_ms": trip,
                  "timing": "an empty push bounced between two rank "
                            "processes time-slicing the card, 200 rounds "
                            "back to back, host clock; the slower rank; a "
                            "switch is half a round"})
            for kernel, case, op in (("ring_rotate", "onebit_tree",
                                      "collect"),
                                     ("ring_presum", "randomk_values",
                                      "presum")):
                c = next(c for c in cases
                         if c["case"] == case and c["op"] == op)
                main[kernel] = {**c, "case": f"{case} {op}, 2 ranks: ms "
                                             "in-process peers, "
                                             "ms_time_sliced two processes "
                                             "on one card"}
            # the signs leaf alone, beside gloo's one call on it
            c = next(c for c in cases
                     if c["case"] == "signs_full" and c["op"] == "collect")
            main["ring_rotate"].update({f"signs_{k}": c[k] for k in (
                "ms", "ms_time_sliced", "library_ms", "bound_ms")})
    return main


# (leg, tier, compression, zero_1)
TRAIN_RING_LEGS = (("staged_onebit_ef", "staged", ONEBIT_EF, False),
                   ("ring_onebit_ef", "ring", ONEBIT_EF, False),
                   ("ring_randomk_ef", "ring",
                    {"compressor": "randomk", "k": RANDOMK_K,
                     "ef": "vanilla"}, False),
                   ("zero_staged_raw", "staged", None, True),
                   ("zero_staged_onebit_ef", "staged", ONEBIT_EF, True),
                   ("zero_ring_onebit_ef", "ring", ONEBIT_EF, True))


def train_ring_rank(rank, n, B, S, steps):
    """One rank of train_ring: each leg builds the training step from the
    same seeded weights, trains on this rank's seeded batch, and reports
    losses, step times, a digest of its parameters, peak memory and the
    launch counts."""
    import os

    from byteps_tpu_torch.common.config import reset_config
    from byteps_tpu_torch.models import make_gpt_train_step, synthetic_batch
    from byteps_tpu_torch.ops import launches, reset_launches

    cfg = rank_phase_cfg("train_ring")
    res = {}
    for leg, tier, comp, zero in TRAIN_RING_LEGS:
        os.environ["BYTEPS_ICI_TIER"] = tier
        reset_config()
        reset_launches()
        step, params, opt = make_gpt_train_step(
            cfg, compression_params=comp, zero_1=zero,
            generator=torch.Generator(device="cuda").manual_seed(0))
        tok, tgt = synthetic_batch(
            torch.Generator(device="cuda").manual_seed(1 + rank), cfg, B, S)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(steps + 1):
            t0 = time.perf_counter()
            losses.append(float(step(tok, tgt)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res[leg] = {
            "losses": losses, "step_ms_each": [t * 1e3 for t in times[1:]],
            "warmup_s": times[0],
            "params_sha1": params_digest(opt.params),
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
            / 1e9,
            "moment_bytes": opt.moment_bytes(),
            "launches": dict(launches)}
        del step, params, opt
        gc.collect()
        torch.cuda.empty_cache()
    return res


def phase_train_ring(B=4, S=1024, steps=2) -> dict:
    """Two ranks on the card train GPT-2 medium at full width and 8 of its
    24 layers (``RANK_PHASE_LAYERS``), B=4 × S=1024
    each (the single-card legs' global batch of 8), bf16 over f32 master
    weights, AdamW(1e-3), one warm-up and ``steps`` timed steps a leg:
    staged onebit + EF, ring onebit + EF and ring randomk + EF, then
    ZeRO-1 (``zero_1=True``): staged raw, staged onebit + EF and ring
    onebit + EF. Each ring onebit leg equals its staged one bit for bit
    (losses and each rank's parameter digest); every leg ends with both
    ranks' parameters equal and every loss finite; each rank's moments
    are 2·ceil(L/2)·4 B under ZeRO-1, half the replicated legs' 2·L·4;
    the launch counts are exact. Returns rank 0's counts summed over the
    legs (both ranks' are checked equal)."""
    n = 2
    t0 = time.perf_counter()
    per_rank = spawn_ranks(train_ring_rank, n, B, S, steps)
    wall = time.perf_counter() - t0
    cfg = rank_phase_cfg("train_ring")
    L = gpt_param_count(cfg)
    calls = steps + 1
    chunks = -(-L // CHUNK)
    seg = -(-L // n)
    for leg, _, _, zero in TRAIN_RING_LEGS:
        legs = [r[leg] for r in per_rank]
        moments = 2 * (seg if zero else L) * 4
        if any(lg["moment_bytes"] != moments for lg in legs):
            raise AssertionError(f"train_ring {leg}: moments "
                                 f"{[lg['moment_bytes'] for lg in legs]} B,"
                                 f" not {moments}")
        if len({lg["params_sha1"] for lg in legs}) != 1:
            raise AssertionError(f"train_ring {leg}: the ranks' parameters "
                                 "differ")
        if not all(np.isfinite(lg["losses"]).all() for lg in legs):
            raise AssertionError(f"train_ring {leg}: a loss is not finite")
        if legs[0]["launches"] != legs[1]["launches"]:
            raise AssertionError(f"train_ring {leg}: the ranks launched "
                                 "different counts")
    for r in per_rank:
        for ring, staged in (("ring_onebit_ef", "staged_onebit_ef"),
                             ("zero_ring_onebit_ef",
                              "zero_staged_onebit_ef")):
            if (r[ring]["losses"] != r[staged]["losses"]
                    or r[ring]["params_sha1"] != r[staged]["params_sha1"]):
                raise AssertionError(
                    f"train_ring: rank {r['rank']}'s {ring} leg differs "
                    f"from {staged}: losses {r[ring]['losses']} vs "
                    f"{r[staged]['losses']}")
    # exact counts, per rank. The onebit general body at n ranks, per
    # chunk: pack n segments, recompress the owner's sum (n + 1 packs);
    # unpack-sum the owner's n received segments once, decompress the n
    # gathered rows and, for the EF residual, the n own rows (1 + 2n
    # unpack-sum launches, K = n and K = 1)
    per_layer = calls * cfg.n_layers
    onebit = {"onebit_pack": calls * chunks * (n + 1),
              "onebit_unpack_sum": calls * chunks * (1 + 2 * n)}
    want = {
        "staged_onebit_ef": {**onebit, "ring_rotate": 0, "ring_presum": 0},
        # one collect and one gather call, each for both leaves (signs,
        # scale)
        "ring_onebit_ef": {**onebit, "ring_rotate": calls * chunks * 2,
                           "ring_presum": 0},
        # presum on the values, gather of the summed values; no collect
        "ring_randomk_ef": {"onebit_pack": 0, "onebit_unpack_sum": 0,
                            "ring_rotate": calls * chunks,
                            "ring_presum": calls * chunks},
        # ZeRO-1: one reduce-scatter of the whole vector a step (no pull:
        # the stepped segments are all-gathered raw, over gloo); onebit
        # packs the n segments, unpack-sums the owner's K = n received
        # ones once and, for the EF residual, the n own rows
        "zero_staged_raw": {"onebit_pack": 0, "onebit_unpack_sum": 0,
                            "ring_rotate": 0, "ring_presum": 0},
        "zero_staged_onebit_ef": {"onebit_pack": calls * n,
                                  "onebit_unpack_sum": calls * (1 + n),
                                  "ring_rotate": 0, "ring_presum": 0},
        # the collect call alone, both leaves at once
        "zero_ring_onebit_ef": {"onebit_pack": calls * n,
                                "onebit_unpack_sum": calls * (1 + n),
                                "ring_rotate": calls, "ring_presum": 0}}
    for leg, w in want.items():
        got = per_rank[0][leg]["launches"]
        w = {**w, **{k: per_layer for k in TRAIN}}
        bad = {k: (got[k], v) for k, v in w.items() if got[k] != v}
        if bad:
            raise AssertionError(f"train_ring {leg}: launches (got, want) "
                                 f"{bad}")
    tokens = n * B * S
    legs_out = {}
    for leg, tier, comp, zero in TRAIN_RING_LEGS:
        step_ms = max(sum(r[leg]["step_ms_each"]) / steps for r in per_rank)
        legs_out[leg] = {
            "tier": tier, "compression": comp, "zero_1": zero,
            "moment_bytes": per_rank[0][leg]["moment_bytes"],
            "losses": per_rank[0][leg]["losses"],
            "params_sha1": [r[leg]["params_sha1"] for r in per_rank],
            "step_ms": step_ms,
            "step_ms_each": [r[leg]["step_ms_each"] for r in per_rank],
            "tokens_per_s": tokens / step_ms * 1e3,
            "warmup_s": max(r[leg]["warmup_s"] for r in per_rank),
            "max_memory_allocated_gb": [r[leg]["max_memory_allocated_gb"]
                                        for r in per_rank],
            "launches": per_rank[0][leg]["launches"]}
    emit({"phase": "train_ring", "ranks": n, "layers": cfg.n_layers,
          "depth_cut": "24 layers cut to keep the smoke in its limit",
          "timing": "two ranks time-slice one card", "batch_per_rank": B,
          "seq": S, "steps": steps, "chunks_per_step": chunks,
          "ring_equals_staged": True, "wall_s": wall, "legs": legs_out})
    total = {}
    for leg, *_ in TRAIN_RING_LEGS:
        for k, v in per_rank[0][leg]["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


# the DCN legs of train_dcn: the torch adapter's DistributedOptimizer with
# the raw f32 wire, then with the fp16 wire (Compression.fp16)
DCN_LEGS = (("dcn_raw", "none"), ("dcn_fp16", "fp16"))
# fp16 wire against raw, each rank's loss at each step (absolute)
DCN_FP16_LOSS_TOL = 1e-2


def params_digest(leaves) -> str:
    """SHA-1 of the SHA-1s of the flat parameters' bytes in 64 MiB pieces,
    in order. The pieces hash on threads (hashlib lets go of the GIL), so
    GPT-2 medium's 1.42 GB costs a fraction of one thread's pass."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    flat = torch.cat([p.detach().reshape(-1) for p in leaves]).cpu()
    buf = flat.numpy().view(np.uint8)
    piece = 64 << 20
    with ThreadPoolExecutor(8) as ex:
        parts = list(ex.map(lambda i: hashlib.sha1(buf[i:i + piece])
                            .digest(), range(0, buf.size, piece)))
    return hashlib.sha1(b"".join(parts)).hexdigest()


def dcn_timed_steps(step_fn, leaves, steps, probe=None,
                    between=None) -> dict:
    """One warm-up and ``steps`` timed calls of ``step_fn``: losses, step
    times, the parameters' digest after every step, peak memory, and the
    change of ``probe()`` (a tuple of counts) over each step.
    ``between(i)`` runs after step i (0: the warm-up), untimed."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "times": [], "digests": [], "deltas": []}
    for _ in range(steps + 1):
        before = probe() if probe else ()
        t0 = time.perf_counter()
        loss = step_fn()
        torch.cuda.synchronize()
        out["times"].append(time.perf_counter() - t0)
        out["losses"].append(float(loss))
        after = probe() if probe else ()
        out["deltas"].append([a - b for a, b in zip(after, before)])
        out["digests"].append(params_digest(leaves))
        if between is not None:
            between(len(out["digests"]) - 1)
    if probe is None:
        del out["deltas"]
    out["step_ms_each"] = [t * 1e3 for t in out.pop("times")[1:]]
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def hist_sums(reg, prefix="scheduler.stage.") -> dict:
    """``{histogram: sum}`` of the registry's histograms under ``prefix``
    (by default the scheduler's stage run and dwell times)."""
    snap = reg.snapshot(prefix)["histograms"]
    return {k: v.get("sum", 0.0) for k, v in snap.items()}


def train_dcn_rank(rank, n, B, S, steps, port, ipc_port):
    """One rank of train_dcn. The yardstick first: ``make_gpt_train_step``
    over the gloo group (staged all-reduce, raw). Then each DCN leg: the
    same seeded weights and batch, the same ``gpt_loss`` and ``adamw``,
    through ``byteps_tpu_torch.torch.DistributedOptimizer`` over the
    summation server on ``port`` after ``broadcast_parameters`` from rank
    0; then dcn_ipc_raw, the raw leg over a server that rank 0 starts in
    its own process on ``ipc_port`` and reaches through the in-process
    path (``BYTEPS_ENABLE_IPC=1``), rank 1 over TCP. Reports each leg's
    losses, step times, parameter digests, peak memory and launch counts,
    and each DCN leg's wire, copy and stage numbers per step, checking
    the byte counts itself; dcn_ipc_raw also whether the worker takes the
    IPC path, the TCP connections its data plane opened over the leg and
    whether the workers' goodbyes stopped rank 0's server."""
    import os

    import byteps_tpu_torch.torch as bps
    from byteps_tpu_torch.common.config import get_config, reset_config
    from byteps_tpu_torch.common.metrics import get_registry
    from byteps_tpu_torch.compression.wire import Fp16Wire
    from byteps_tpu_torch.models import (GPTConfig, gpt_init,
                                         make_gpt_train_step,
                                         synthetic_batch)
    from byteps_tpu_torch.models.convert import flat_leaves
    from byteps_tpu_torch.models.gpt import gpt_loss
    from byteps_tpu_torch.models.train import adamw
    from byteps_tpu_torch.ops import launches, reset_launches

    os.environ.update(DMLC_NUM_WORKER=str(n), DMLC_NUM_SERVER="1",
                      DMLC_PS_ROOT_URI="127.0.0.1",
                      DMLC_PS_ROOT_PORT=str(port - 1),
                      DMLC_WORKER_ID=str(rank))
    reset_config()
    cfg = rank_phase_cfg("train_dcn")
    tok, tgt = synthetic_batch(
        torch.Generator(device="cuda").manual_seed(1 + rank), cfg, B, S)
    res = {}
    reset_launches()
    step, params, opt = make_gpt_train_step(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    res["staged_raw"] = dcn_timed_steps(lambda: step(tok, tgt), opt.params,
                                        steps)
    res["staged_raw"]["launches"] = dict(launches)
    del step, params, opt
    gc.collect()
    torch.cuda.empty_cache()

    bps.init()
    reg = get_registry()
    min_bytes = get_config().min_compress_bytes

    def run_leg(leg, comp):
        core = bps._state.core
        reset_launches()
        params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0))
        params.requires_grad_(True)
        leaves = flat_leaves(params)
        opt = bps.DistributedOptimizer(adamw(leaves),
                                       params.named_parameters(),
                                       compression=comp)
        bps.broadcast_parameters(dict(params.named_parameters()),
                                 root_rank=0)
        # the wire bytes of one step: each partition's codec bytes, raw
        # f32 below min_compress_bytes
        codec = Fp16Wire() if comp == "fp16" else None
        wire = 0
        for name, _ in params.named_parameters():
            for p in core.registry.get(f"byteps_push_pull.{name}").partitions:
                wire += (codec.wire_bytes(p.length)
                         if codec and p.length * 4 >= min_bytes
                         else p.length * 4)

        def one_step():
            opt.zero_grad()
            loss = gpt_loss(params, tok, tgt, cfg, chunked_ce=True)
            loss.backward()
            opt.step()
            return loss.detach()

        # bytes pushed, pulled, copied D2H and H2D, then each stage
        # histogram's sum, read around every step
        keys = sorted(hist_sums(reg))
        out = dcn_timed_steps(
            one_step, leaves, steps,
            lambda: (core.bytes_moved() + core.bytes_copied()
                     + tuple(hist_sums(reg)[k] for k in keys)))
        timed = out["deltas"][1:]         # step 0 is the warm-up
        out["stage_us_per_step"] = {
            k: sum(d[4 + i] for d in timed) / steps
            for i, k in enumerate(keys)}
        n_bytes = gpt_param_count(cfg) * 4
        want = [wire, wire, n_bytes, n_bytes]
        bad = [d[:4] for d in out["deltas"] if d[:4] != want]
        if bad:
            raise AssertionError(
                f"train_dcn {leg}: bytes (pushed, pulled, D2H, H2D) per step "
                f"{bad}, want {want}")
        del out["deltas"]
        out["wire_bytes_per_step"] = wire
        out["copy_bytes_per_step"] = n_bytes
        out["launches"] = dict(launches)
        del opt, params, leaves
        gc.collect()
        torch.cuda.empty_cache()
        return out

    for leg, comp in DCN_LEGS:
        res[leg] = run_leg(leg, comp)
    bps.shutdown()

    from byteps_tpu_torch.server import start_server, stop_server
    from byteps_tpu_torch.server.native import LOCAL_NO_SERVER, load_lib

    os.environ["DMLC_PS_ROOT_PORT"] = str(ipc_port - 1)
    if rank == 0:
        os.environ["BYTEPS_ENABLE_IPC"] = "1"
    reset_config()
    if rank == 0:
        start_server(num_workers=n)
    bps.init()
    worker = bps._state.core.worker
    conns = len(worker._all_conns)        # the init barrier's
    out = run_leg("dcn_ipc_raw", "none")
    out["ipc"] = worker._ipc
    out["tcp_conns_opened"] = len(worker._all_conns) - conns
    bps.shutdown()
    os.environ.pop("BYTEPS_ENABLE_IPC", None)
    if rank == 0:
        # both workers' goodbyes stop the server; a key no partition has
        # probes it
        end = time.monotonic() + 60
        while (load_lib().bps_local_init(1 << 62, 4) != LOCAL_NO_SERVER
               and time.monotonic() < end):
            time.sleep(0.05)
        out["server_stopped_by_goodbyes"] = (
            load_lib().bps_local_init(1 << 62, 4) == LOCAL_NO_SERVER)
        stop_server()
    res["dcn_ipc_raw"] = out
    return res


def phase_train_dcn(B=4, S=1024, steps=1) -> dict:
    """The DCN parameter-server tier on the card: one server process of the
    port (``python -m byteps_tpu_torch.server``, two workers) and two rank
    processes that time-slice the card, each training GPT-2 medium at full
    width and 4 layers (``RANK_PHASE_LAYERS``), B=4 × S=1024, bf16 over
    f32 master weights, one warm-up and
    ``steps`` timed steps a leg: staged_raw (the all-reduce step, the
    yardstick), dcn_raw and dcn_fp16 (``DistributedOptimizer`` over the
    server), dcn_ipc_raw (over a server in rank 0's process, which rank 0
    reaches through the in-process path). Every leg ends each step with
    both ranks' parameters equal; dcn_raw's and dcn_ipc_raw's equal
    staged_raw's after every step, bit for bit (two workers: a + b is
    exact in either order and /2 is exact); in dcn_ipc_raw rank 0's data
    plane opens no TCP connection and the goodbyes stop its server;
    dcn_fp16's
    losses lie within 1e-2 of dcn_raw's; bytes pushed, pulled and copied
    each way per step are exact; the flash kernels launch once per layer
    and step. The server must exit 0 once both ranks said goodbye, and is
    killed on any other way out. Returns rank 0's launch counts summed
    over the legs."""
    import os
    import socket
    from pathlib import Path

    from byteps_tpu_torch.models import GPTConfig
    from byteps_tpu_torch.server import native

    n = 2
    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    port, ipc_port = free_port_pair(), free_port_pair()
    env = dict(os.environ, DMLC_ROLE="server", DMLC_NUM_WORKER=str(n),
               DMLC_NUM_SERVER="1", DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_PS_ROOT_PORT=str(port - 1), DMLC_SERVER_ID="0")
    server = subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.server"], env=env,
        cwd=Path(__file__).resolve().parent, stdout=sys.stderr)
    try:
        t0 = time.perf_counter()
        per_rank = spawn_ranks(train_dcn_rank, n, B, S, steps, port,
                               ipc_port)
        wall = time.perf_counter() - t0
        try:
            rc = server.wait(timeout=60)
        except subprocess.TimeoutExpired:
            raise AssertionError("train_dcn: the server outlived its "
                                 "workers") from None
        if rc != 0:
            raise AssertionError(f"train_dcn: the server exited {rc}")
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    cfg = rank_phase_cfg("train_dcn")
    calls = steps + 1
    legs = (("staged_raw",) + tuple(leg for leg, _ in DCN_LEGS)
            + ("dcn_ipc_raw",))
    for leg in legs:
        a, b = (r[leg] for r in per_rank)
        if a["digests"] != b["digests"]:
            raise AssertionError(f"train_dcn {leg}: the ranks' parameters "
                                 "differ")
        for r in per_rank:
            if not np.isfinite(r[leg]["losses"]).all():
                raise AssertionError(f"train_dcn {leg}: a loss is not "
                                     f"finite: {r[leg]['losses']}")
            got = {k: r[leg]["launches"][k] for k in TRAIN}
            if got != {k: calls * cfg.n_layers for k in TRAIN}:
                raise AssertionError(f"train_dcn {leg}: rank {r['rank']} "
                                     f"launched {got}, not "
                                     f"{calls * cfg.n_layers} each")
    for r in per_rank:
        for leg in ("dcn_raw", "dcn_ipc_raw"):
            differ = [i for i, (x, y) in enumerate(zip(
                r[leg]["digests"], r["staged_raw"]["digests"])) if x != y]
            if differ:
                raise AssertionError(
                    f"train_dcn: rank {r['rank']}'s {leg} parameters differ "
                    f"from staged_raw's after step(s) {differ} (0: warm-up)")
        ipc = r["dcn_ipc_raw"]
        want = ((True, 0, True) if r["rank"] == 0 else (False,))
        got = ((ipc["ipc"], ipc["tcp_conns_opened"],
                ipc["server_stopped_by_goodbyes"]) if r["rank"] == 0
               else (ipc["ipc"],))
        if got != want:
            raise AssertionError(
                f"train_dcn dcn_ipc_raw: rank {r['rank']}'s (IPC path, TCP "
                f"connections its data plane opened, server stopped by the "
                f"goodbyes) {got}, want {want}")
        gap = max(abs(x - y) for x, y in zip(r["dcn_fp16"]["losses"],
                                             r["dcn_raw"]["losses"]))
        if not gap <= DCN_FP16_LOSS_TOL:
            raise AssertionError(f"train_dcn: rank {r['rank']}'s fp16 losses "
                                 f"lie {gap} from raw's")
    tokens = n * B * S
    legs_out = {}
    for leg in legs:
        step_ms = max(sum(r[leg]["step_ms_each"]) / steps for r in per_rank)
        legs_out[leg] = {
            "losses": [r[leg]["losses"] for r in per_rank],
            "step_ms": step_ms,
            "step_ms_each": [r[leg]["step_ms_each"] for r in per_rank],
            "tokens_per_s": tokens / step_ms * 1e3,
            "max_memory_allocated_gb": [r[leg]["max_memory_allocated_gb"]
                                        for r in per_rank],
            **{k: [r[leg][k] for r in per_rank]
               for k in ("wire_bytes_per_step", "copy_bytes_per_step",
                         "stage_us_per_step", "ipc", "tcp_conns_opened")
               if k in r[leg]}}
    emit({"phase": "train_dcn", "ranks": n, "layers": cfg.n_layers,
          "depth_cut": "24 layers cut to keep the smoke in its limit",
          "server": "one process; dcn_ipc_raw's in rank 0's process",
          "timing": "two ranks time-slice one card", "batch_per_rank": B,
          "seq": S, "steps": steps, "server_build_s": build_s,
          "numpy": np.__version__, "host_cpus": os.cpu_count(),
          "dcn_raw_equals_staged_raw": True, "wall_s": wall,
          "legs": legs_out})
    total = {}
    for leg in legs:
        for k, v in per_rank[0][leg]["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


# the legs of train_hybrid after staged_raw: (name, environment, the
# default compression of eager.init, which server of the phase's)
# hybrid_ring_onebit against its CPU replay: every sign equal, and each
# value within this share of its leaf's largest magnitude (the f32 means
# of the onebit scales sum in another order on the CPU, and EF carries
# the difference into the next step)
HYBRID_HOLD_TOL = 1e-5
HYBRID_LEGS = (
    ("eager_raw", {}, None, None),
    ("hybrid_raw", {"BYTEPS_FORCE_DISTRIBUTED": "1"}, None, 0),
    ("hybrid_ring_onebit", {"BYTEPS_FORCE_DISTRIBUTED": "1",
                            "BYTEPS_ICI_TIER": "ring"},
     {"compressor": "onebit", "ef": "vanilla"}, 1),
    # the sharded pod wire over three controller NICs (owner-routed)
    ("hybrid_ctl3_raw", {"BYTEPS_FORCE_DISTRIBUTED": "1",
                         "BYTEPS_POD_CONTROLLERS": "3"}, None, 2))
HYBRID_KNOBS = ("BYTEPS_FORCE_DISTRIBUTED", "BYTEPS_ICI_TIER",
                "BYTEPS_POD_CONTROLLERS", "DMLC_PS_ROOT_PORT")
# the raw legs of train_hybrid, each bit-equal to staged_raw
HYBRID_RAW = ("eager_raw", "hybrid_raw", "hybrid_ctl3_raw")


def hybrid_plan(bps, n_leaves, params) -> dict:
    """One step's wire bytes (each partition's codec bytes, raw f32 below
    ``BYTEPS_MIN_COMPRESS_BYTES``) and the partitions the ring compresses
    at REDUCE, from the registry of ``eager``."""
    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.compression import from_params
    from byteps_tpu_torch.compression.wire import make_wire_codec

    codec = make_wire_codec(from_params(params))
    min_bytes = get_config().min_compress_bytes
    wire = compressed = 0
    for i in range(n_leaves):
        for p in bps._state.registry.get(f"grad.{i}").partitions:
            big = codec is not None and p.length * 4 >= min_bytes
            wire += codec.wire_bytes(p.length) if big else p.length * 4
            compressed += big
    return {"wire": wire, "compressed": compressed}


def train_hybrid_rank(rank, n, B, S, steps, ports):
    """One rank of train_hybrid's pod. The yardstick first:
    ``make_gpt_train_step`` over the gloo group (staged all-reduce, raw).
    Then each leg of ``HYBRID_LEGS``: the same seeded weights and batch,
    ``gpt_loss`` and ``adamw``, with ``eager.push_pull_tree`` of the
    gradients (declared in ``flat_leaves`` order, averaged) between
    ``backward`` and the optimizer step. Reports each leg's losses, step
    times, parameter digests, peak memory and launch counts, and for each
    eager leg its bytes per step (DCN pushed and pulled, D2H, H2D,
    ``ici.wire_bytes``), stage and tail sums per step and plan. A leg
    with compression also keeps block 0's raw and averaged gradients of
    every step and, after its timed steps, replays their aggregation on
    the CPU under other names (the same pipeline with the kernels' plain
    versions, the same host codec and EF, step by step), reporting per
    step the elements whose sign differs and the largest error relative
    to its leaf's largest magnitude in the replay."""
    import os

    from byteps_tpu_torch import eager as bps
    from byteps_tpu_torch.common.config import reset_config
    from byteps_tpu_torch.common.metrics import get_registry
    from byteps_tpu_torch.models import (GPTConfig, gpt_init,
                                         make_gpt_train_step,
                                         synthetic_batch)
    from byteps_tpu_torch.models.convert import flat_leaves
    from byteps_tpu_torch.models.gpt import gpt_loss
    from byteps_tpu_torch.models.train import adamw
    from byteps_tpu_torch.ops import launches, reset_launches

    os.environ.update(DMLC_NUM_WORKER="1", DMLC_NUM_SERVER="1",
                      DMLC_PS_ROOT_URI="127.0.0.1", DMLC_WORKER_ID="0")
    reset_config()
    cfg = rank_phase_cfg("train_hybrid")
    tok, tgt = synthetic_batch(
        torch.Generator(device="cuda").manual_seed(1 + rank), cfg, B, S)
    res = {}
    reset_launches()
    step, params, opt = make_gpt_train_step(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    res["staged_raw"] = dcn_timed_steps(lambda: step(tok, tgt), opt.params,
                                        steps)
    res["staged_raw"]["launches"] = dict(launches)
    del step, params, opt
    gc.collect()
    torch.cuda.empty_cache()

    reg = get_registry()
    for leg, env, comp, server in HYBRID_LEGS:
        for k in HYBRID_KNOBS:
            os.environ.pop(k, None)
        os.environ.update(env)
        if server is not None:
            os.environ["DMLC_PS_ROOT_PORT"] = str(ports[server] - 1)
        reset_config()
        reset_launches()
        bps.init(compression_params=comp)
        params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0))
        params.requires_grad_(True)
        leaves = flat_leaves(params)
        opt = adamw(leaves)
        # block 0's leaves (flat_leaves puts the blocks first): raw and
        # averaged gradients of every step, kept on the card
        n_hold = len(leaves) // cfg.n_layers if comp is not None else 0
        held = []

        def one_step():
            for p in leaves:
                p.grad = None
            loss = gpt_loss(params, tok, tgt, cfg, chunked_ce=True)
            loss.backward()
            raw = [p.grad.clone() for p in leaves[:n_hold]]
            avg = bps.push_pull_tree([p.grad for p in leaves], average=True)
            for p, g in zip(leaves, avg):
                p.grad = g
            opt.step()
            if n_hold:
                held.append((raw, [g.clone() for g in avg[:n_hold]]))
            return loss.detach()

        reg.histogram("eager.tail_us")      # listed from the first step on
        keys = sorted({**hist_sums(reg), **hist_sums(reg, "eager.")})

        def probe():
            sums = {**hist_sums(reg), **hist_sums(reg, "eager.")}
            wire = reg.snapshot("ici.")["counters"].get("ici.wire_bytes", 0)
            return (bps.bytes_moved() + bps.bytes_copied() + (wire,)
                    + tuple(sums.get(k, 0.0) for k in keys))

        out = dcn_timed_steps(one_step, leaves, steps, probe)
        timed = out["deltas"][1:]         # step 0 is the warm-up
        out["bytes_per_step"] = [d[:5] for d in out.pop("deltas")]
        out["stage_us_per_step"] = {
            k: sum(d[5 + i] for d in timed) / steps
            for i, k in enumerate(keys)}
        out["plan"] = hybrid_plan(bps, len(leaves), comp)
        out["stages"] = list(bps._state.stages)
        out["launches"] = dict(launches)
        # each controller NIC's (pushed, pulled) over the leg's calls
        out["nic_bytes"] = [[w.bytes_pushed, w.bytes_pulled]
                            for w in bps._state.psworkers]
        if n_hold:
            errs, flips = [], []
            for raw, avg in held:
                want = bps.push_pull_tree([g.cpu() for g in raw],
                                          average=True, name_prefix="hold")
                err = flip = 0
                for g, w in zip(avg, want):
                    g = g.cpu()
                    scale = max(float(w.abs().max()), 1e-30)
                    err = max(err, float((g - w).abs().max()) / scale)
                    flip += int((torch.sign(g) != torch.sign(w)).sum())
                errs.append(err)
                flips.append(flip)
            out["hold"] = {"leaves": n_hold,
                           "numel": sum(g.numel() for g in held[0][0]),
                           "max_rel_err": errs, "sign_flips": flips}
            del held
        res[leg] = out
        bps.shutdown()
        del opt, params, leaves
        gc.collect()
        torch.cuda.empty_cache()
    return res


def phase_train_hybrid(B=4, S=1024, steps=1) -> dict:
    """The eager surface and the hybrid two-tier pipeline on the card: one
    pod of two rank processes time-slicing the card over gloo, and one
    port server process a hybrid leg (``DMLC_NUM_WORKER=1``, the ranks
    with ``BYTEPS_FORCE_DISTRIBUTED=1``: every hybrid stage runs and the
    pod's sums cross the server). Each rank trains GPT-2 medium at full
    width and 4 layers (``RANK_PHASE_LAYERS``), B=4 × S=1024, bf16 over
    f32 master weights, one warm-up and
    ``steps`` timed steps a leg: staged_raw (``make_gpt_train_step``, the
    yardstick), eager_raw (the eager ICI pipeline), hybrid_raw (sharded,
    staged tier, raw wire), hybrid_ring_onebit (the ring's compressed
    reduce-scatter, the onebit wire with the controller's host EF) and
    hybrid_ctl3_raw (three controller NICs). Checks: both ranks'
    parameters equal after every step of every leg and every loss finite;
    eager_raw, hybrid_raw and hybrid_ctl3_raw equal staged_raw bit for
    bit after every step (one pod of two: a + b is exact in either order,
    /2 exact); in hybrid_ctl3_raw every NIC moves bytes and their sums
    are hybrid_raw's; on the controller the bytes pushed and pulled a step equal
    the plans' wire bytes and D2H and H2D the gradient's f32 bytes, the
    other rank moving none; the flash kernels once per layer and step,
    and in hybrid_ring_onebit, per compressed partition and step, two
    onebit packs, one unpack-sum and one ring rotate. Every server exits 0
    after its pod's goodbye and is killed on any other way out. Returns
    rank 0's launch counts summed over the legs."""
    import os
    import socket
    from pathlib import Path

    from byteps_tpu_torch.models import GPTConfig
    from byteps_tpu_torch.server import native

    n = 2
    native.build()
    servers, ports = [], []
    try:
        for _ in range(1 + max(i for *_, i in HYBRID_LEGS
                               if i is not None)):
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            env = dict(os.environ, DMLC_ROLE="server", DMLC_NUM_WORKER="1",
                       DMLC_NUM_SERVER="1", DMLC_PS_ROOT_URI="127.0.0.1",
                       DMLC_PS_ROOT_PORT=str(port - 1), DMLC_SERVER_ID="0")
            servers.append(subprocess.Popen(
                [sys.executable, "-m", "byteps_tpu_torch.server"], env=env,
                cwd=Path(__file__).resolve().parent, stdout=sys.stderr))
            ports.append(port)
        t0 = time.perf_counter()
        per_rank = spawn_ranks(train_hybrid_rank, n, B, S, steps, ports)
        wall = time.perf_counter() - t0
        for i, server in enumerate(servers):
            try:
                rc = server.wait(timeout=60)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"train_hybrid: server {i} outlived "
                                     "its pod") from None
            if rc != 0:
                raise AssertionError(f"train_hybrid: server {i} exited {rc}")
    finally:
        for server in servers:
            if server.poll() is None:
                server.kill()
                server.wait()
    cfg = rank_phase_cfg("train_hybrid")
    calls = steps + 1
    legs = ("staged_raw",) + tuple(leg for leg, _, _, _ in HYBRID_LEGS)
    for leg in legs:
        a, b = (r[leg] for r in per_rank)
        if a["digests"] != b["digests"]:
            raise AssertionError(f"train_hybrid {leg}: the ranks' parameters "
                                 "differ")
        for r in per_rank:
            if not np.isfinite(r[leg]["losses"]).all():
                raise AssertionError(f"train_hybrid {leg}: a loss is not "
                                     f"finite: {r[leg]['losses']}")
            got = {k: r[leg]["launches"][k] for k in TRAIN}
            if got != {k: calls * cfg.n_layers for k in TRAIN}:
                raise AssertionError(f"train_hybrid {leg}: rank {r['rank']} "
                                     f"launched {got}, not "
                                     f"{calls * cfg.n_layers} each")
    for r in per_rank:
        for leg in HYBRID_RAW:
            differ = [i for i, (x, y) in enumerate(zip(
                r[leg]["digests"], r["staged_raw"]["digests"])) if x != y]
            if differ:
                raise AssertionError(
                    f"train_hybrid: rank {r['rank']}'s {leg} parameters "
                    f"differ from staged_raw's after step(s) {differ} (0: "
                    "warm-up)")
    n_bytes = gpt_param_count(cfg) * 4
    for leg, _, _, server in HYBRID_LEGS:
        for r in per_rank:
            wire = r[leg]["plan"]["wire"]
            want = ([wire, wire, n_bytes, n_bytes]
                    if server is not None and r["rank"] == 0 else [0, 0, 0, 0])
            bad = [d[:4] for d in r[leg]["bytes_per_step"] if d[:4] != want]
            if bad:
                raise AssertionError(
                    f"train_hybrid {leg}: rank {r['rank']}'s bytes (pushed, "
                    f"pulled, D2H, H2D) per step {bad}, want {want}")
    # three controller NICs: each carries some of the partitions, and
    # their bytes add up to hybrid_raw's one NIC's, each way
    nics = per_rank[0]["hybrid_ctl3_raw"]["nic_bytes"]
    one = per_rank[0]["hybrid_raw"]["nic_bytes"]
    if (len(nics) != 3 or not all(p > 0 and q > 0 for p, q in nics)
            or [sum(c) for c in zip(*nics)] != one[0]
            or one[0] != [calls * per_rank[0]["hybrid_raw"]["plan"]["wire"]]
            * 2):
        raise AssertionError(f"train_hybrid hybrid_ctl3_raw: the NICs' "
                             f"(pushed, pulled) {nics}, hybrid_raw's {one}")
    # the ring's compressed reduce-scatter at n = 2, per compressed
    # partition: pack the two segments, unpack-sum the owner's two, one
    # rotate call (the collect); the wire codec is the host's
    comp = per_rank[0]["hybrid_ring_onebit"]["plan"]["compressed"]
    want = {"onebit_pack": calls * comp * n,
            "onebit_unpack_sum": calls * comp, "ring_rotate": calls * comp,
            "ring_presum": 0, "onebit_unpack_sum_grid": 0}
    for r in per_rank:
        got = r["hybrid_ring_onebit"]["launches"]
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if bad:
            raise AssertionError(f"train_hybrid hybrid_ring_onebit: rank "
                                 f"{r['rank']} launches (got, want) {bad}")
        hold = r["hybrid_ring_onebit"]["hold"]
        if (hold["sign_flips"] != [0] * calls
                or not max(hold["max_rel_err"]) <= HYBRID_HOLD_TOL):
            raise AssertionError(
                f"train_hybrid hybrid_ring_onebit: rank {r['rank']}'s "
                f"averaged gradients against the CPU replay {hold}, want "
                f"{calls} steps, no sign flip, within {HYBRID_HOLD_TOL}")
    tokens = n * B * S
    legs_out = {}
    for leg in legs:
        step_ms = max(sum(r[leg]["step_ms_each"]) / steps for r in per_rank)
        legs_out[leg] = {
            "losses": [r[leg]["losses"] for r in per_rank],
            "step_ms": step_ms,
            "step_ms_each": [r[leg]["step_ms_each"] for r in per_rank],
            "tokens_per_s": tokens / step_ms * 1e3,
            "max_memory_allocated_gb": [r[leg]["max_memory_allocated_gb"]
                                        for r in per_rank],
            **{k: [r[leg][k] for r in per_rank]
               for k in ("bytes_per_step", "stage_us_per_step", "hold")
               if k in r[leg]},
            **{k: per_rank[0][leg][k] for k in ("plan", "stages",
                                                "nic_bytes")
               if k in per_rank[0][leg]}}
    emit({"phase": "train_hybrid", "ranks": n, "layers": cfg.n_layers,
          "depth_cut": "24 layers cut to keep the smoke in its limit",
          "pods": 1,
          "servers": "one process a hybrid leg",
          "timing": "two ranks time-slice one card", "batch_per_rank": B,
          "seq": S, "steps": steps, "host_cpus": os.cpu_count(),
          "bytes_per_step_fields": ["pushed", "pulled", "d2h", "h2d",
                                    "ici.wire_bytes"],
          "raw_legs_equal_staged_raw": True, "wall_s": wall,
          "legs": legs_out})
    total = {}
    for leg in legs:
        for k, v in per_rank[0][leg]["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


# train_chaos: (leg, environment); the dcn legs run on two workers, the
# hybrid leg on one pod. dcn_chaos's faults: 2% of push attempts lose
# their ack (the push was applied), 2% of pull responses arrive with a
# byte flipped (the CRC, forced on, catches it)
CHAOS_SPEC = "push:timeout@p=0.02;pull:corrupt@p=0.02"
CHAOS_HEALTH = {"BYTEPS_HEALTH_INTERVAL_MS": "50",
                "BYTEPS_HEALTH_MISS_LIMIT": "3"}
CHAOS_LEGS = (
    ("dcn_chaos", {"BYTEPS_FAULT_SPEC": CHAOS_SPEC,
                   "BYTEPS_FAULT_SEED": "15", "BYTEPS_RETRY_LIMIT": "10",
                   "BYTEPS_RETRY_BACKOFF_MS": "10"}),
    ("dcn_failover", CHAOS_HEALTH),
    ("hybrid_degraded", {**CHAOS_HEALTH, "BYTEPS_FORCE_DISTRIBUTED": "1",
                         "BYTEPS_DEGRADED_OK": "1"}),
    # three controller NICs; a NIC gives up after 2 wire retries
    ("hybrid_owner_failover", {"BYTEPS_FORCE_DISTRIBUTED": "1",
                               "BYTEPS_POD_CONTROLLERS": "3",
                               "BYTEPS_RETRY_LIMIT": "2",
                               "BYTEPS_RETRY_BACKOFF_MS": "10"}))
# elastic membership and bounded staleness, after the chaos legs, on the
# same yardstick: two workers a leg, leases of 800 ms heartbeated every
# 100 ms; the straggler is worker 1, every wire attempt STRAGGLER_MS late
STRAGGLER_MS = 20
ELASTIC_LEASE = {"BYTEPS_WORKER_LEASE_MS": "800",
                 "BYTEPS_HEALTH_INTERVAL_MS": "100"}
STRAGGLER = {"BYTEPS_FAULT_SPEC": f"worker1:slow@ms={STRAGGLER_MS}"}
ELASTIC_LEGS = (
    # rank 1 dies by a worker:kill plan armed after the first timed step
    ("dcn_lease_evict", ELASTIC_LEASE),
    # the job starts with one worker; rank 1 joins before the warm-up
    ("dcn_join", ELASTIC_LEASE),
    ("dcn_straggler_k0", STRAGGLER),
    ("dcn_straggler_k1", {**STRAGGLER, "BYTEPS_STALENESS": "1"}))
# what the leg's server processes take of its environment
SERVER_KNOBS = ("BYTEPS_WORKER_LEASE_MS", "BYTEPS_STALENESS")
CHAOS_KNOBS = sorted({k for _, env in CHAOS_LEGS + ELASTIC_LEGS for k in env}
                     | {"DMLC_PS_ROOT_PORT"})
# the servers of a leg's pair the parent kills once both ranks ended
# the first timed step (step 1)
CHAOS_KILL = {"dcn_failover": (1,), "hybrid_degraded": (0, 1)}
CHAOS_KILL_STEP = 1
# the controller NIC a leg's per-owner plan kills, armed after the first
# timed step: every push through it from the second step's first on
OWNER_KILL = {"hybrid_owner_failover": (1, "push:kill@op=1..")}


def wait_file(path: str, bound: float = 120.0) -> str:
    import os

    end = time.monotonic() + bound
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"{path} did not appear in {bound} s")
        time.sleep(0.005)
    with open(path) as f:
        return f.read()


def train_chaos_rank(rank, n, B, S, steps, bases, sigdir):
    """One rank of train_chaos. The yardstick first, as in train_dcn. Then
    each leg of ``CHAOS_LEGS`` on its own pair of servers (``bases``: the
    first server's port): the dcn legs through
    ``byteps_tpu_torch.torch.DistributedOptimizer`` after
    ``broadcast_parameters``, the hybrid leg through
    ``eager.push_pull_tree`` of the gradients, with the seeded weights,
    batch, ``gpt_loss`` and ``adamw`` of train_dcn. A leg the parent
    kills servers in touches ``<leg>.done<rank>`` in ``sigdir`` after the
    first timed step and steps on once ``<leg>.killed`` holds the kill's
    time. Reports each leg's losses, step times, digests, launches, bytes
    per step (pushed, pulled, D2H, H2D) and stage sums per step (thread
    ms, each stage's run and dwell, the tail's), the wire counters, live
    servers and the wall time of each failover, and the dcn legs' credit
    pools and the keys homed on server 1.

    Then the legs of ``ELASTIC_LEGS``, as the dcn legs: dcn_lease_evict
    (rank 1 arms a ``worker:kill`` plan after the first timed step and
    its second step fails on it; rank 0 snapshots its parameters and
    AdamW state there, and after its second step replays that step on
    one worker, without the wire); dcn_join (``DMLC_NUM_WORKER=1``: rank
    0 builds its core and touches ``<leg>.inited``; then rank 1 builds
    its own, enters through ``DcnCore.join()`` and touches
    ``<leg>.joined``, which rank 0 waits for before
    ``broadcast_parameters``); the
    straggler legs (each pull's requested and served round). Reports the
    membership counters, the kill and the adoption times, the replay's
    digest and the served rounds."""
    import os
    from pathlib import Path

    import byteps_tpu_torch.torch as tbps
    from byteps_tpu_torch import eager
    from byteps_tpu_torch.common.config import reset_config
    from byteps_tpu_torch.common.faults import FaultPlan, parse_fault_spec
    from byteps_tpu_torch.common.metrics import get_registry
    from byteps_tpu_torch.models import (GPTConfig, gpt_init,
                                         make_gpt_train_step,
                                         synthetic_batch)
    from byteps_tpu_torch.models.convert import flat_leaves
    from byteps_tpu_torch.models.gpt import gpt_loss
    from byteps_tpu_torch.models.train import adamw
    from byteps_tpu_torch.ops import launches, reset_launches

    cfg = rank_phase_cfg("train_chaos")
    tok, tgt = synthetic_batch(
        torch.Generator(device="cuda").manual_seed(1 + rank), cfg, B, S)
    res = {}
    reset_launches()
    step, params, opt = make_gpt_train_step(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    res["staged_raw"] = dcn_timed_steps(lambda: step(tok, tgt), opt.params,
                                        steps)
    res["staged_raw"]["launches"] = dict(launches)
    del step, params, opt
    gc.collect()
    torch.cuda.empty_cache()

    reg = get_registry()
    for leg, env in CHAOS_LEGS + ELASTIC_LEGS:
        hybrid = leg.startswith("hybrid")
        for k in CHAOS_KNOBS:
            os.environ.pop(k, None)
        os.environ.update(env, DMLC_NUM_WORKER="1" if hybrid
                          or leg == "dcn_join" else str(n),
                          DMLC_NUM_SERVER="2", DMLC_PS_ROOT_URI="127.0.0.1",
                          DMLC_PS_ROOT_PORT=str(bases[leg] - 1),
                          DMLC_WORKER_ID="0" if hybrid else str(rank))
        reset_config()
        reset_launches()
        params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0))
        params.requires_grad_(True)
        leaves = flat_leaves(params)
        out = {}
        if hybrid:
            eager.init()
            worker = eager._state.psworker       # the controller's only
            opt = adamw(leaves)

            def one_step():
                for p in leaves:
                    p.grad = None
                loss = gpt_loss(params, tok, tgt, cfg, chunked_ce=True)
                loss.backward()
                avg = eager.push_pull_tree([p.grad for p in leaves],
                                           average=True)
                for p, g in zip(leaves, avg):
                    p.grad = g
                opt.step()
                return loss.detach()

            def copies():
                return eager.bytes_moved() + eager.bytes_copied()
        else:
            if leg in dict(ELASTIC_LEGS):
                Path(f"{sigdir}/{leg}.want{rank}").touch()
                wait_file(f"{sigdir}/{leg}.up")
            if leg == "dcn_join" and rank == 1:
                # the job runs: rank 0 took the start barrier alone
                wait_file(f"{sigdir}/{leg}.inited")
            tbps.init()
            core = tbps._state.core
            worker = core.worker
            if leg == "dcn_join":
                # rank 1's id is past DMLC_NUM_WORKER: its core took no
                # start barrier, and it enters the running job here
                if rank == 1:
                    out["joined_live"] = core.join()
                    Path(f"{sigdir}/{leg}.joined").touch()
                else:
                    Path(f"{sigdir}/{leg}.inited").touch()
                    wait_file(f"{sigdir}/{leg}.joined")
            opt = tbps.DistributedOptimizer(adamw(leaves),
                                            params.named_parameters())
            tbps.broadcast_parameters(dict(params.named_parameters()),
                                      root_rank=0)

            def one_step():
                opt.zero_grad()
                loss = gpt_loss(params, tok, tgt, cfg, chunked_ce=True)
                loss.backward()
                try:
                    opt.step()
                except Exception as e:
                    # the evicted rank's expected end: its plan killed it
                    if not (leg == "dcn_lease_evict" and killed_by_plan(e)):
                        raise
                    out["died"] = f"{type(e).__name__}: {e}"[:300]
                return loss.detach()

            def copies():
                return core.bytes_moved() + core.bytes_copied()
            keys = [p.key for name, _ in params.named_parameters()
                    for p in core.registry.get(
                        f"byteps_push_pull.{name}").partitions]
            out["keys_on_server1"] = sum(k % 2 == 1 for k in keys)
        failed_over = []
        if worker is not None:
            fail_over = worker.fail_over

            def timed_fail_over(sidx, barrier=True):
                ok = fail_over(sidx, barrier)
                if ok:
                    failed_over.append(time.time())
                return ok
            worker.fail_over = timed_fail_over
        # the owner leg on the controller: the times of the first injected
        # kill and of each owner failover
        owner_kill = OWNER_KILL.get(leg) if worker is not None else None
        kills, remaps = [], []
        fail_owner = eager._fail_owner
        if owner_kill is not None:
            retired0 = reg.counter("nic.retired").value()

            def timed_fail_owner(o, cause=None):
                ok = fail_owner(o, cause)
                if ok:
                    remaps.append(time.time())
                return ok
            eager._fail_owner = timed_fail_owner

        def timed_plan(rule, wid):
            """A fault plan that stamps its first hit's time into kills."""
            plan = FaultPlan(parse_fault_spec(rule), worker_id=wid)
            intercept = plan.intercept

            def timed_intercept(op, sidx, tenant=None):
                hit = intercept(op, sidx, tenant)
                if hit is not None and not kills:
                    kills.append(time.time())
                return hit
            plan.intercept = timed_intercept
            return plan

        def arm_owner_kill():
            o, rule = owner_kill
            eager._state.psworkers[o]._plan = timed_plan(rule, o)

        # the elastic legs: rank 1's kill plan, rank 0's snapshot for the
        # one-worker replay, each membership adoption's time, and each
        # pull's requested and served round and whether that round closed
        # over this rank alone: its sum then is twice this rank's push
        # (scaled by live/contributors = 2, exact), judged on the first 16
        # floats of the raw wire (None where they are all zero)
        saved, adopted, served_log, heads = {}, [], [], {}
        if leg in dict(ELASTIC_LEGS):
            adopt = worker._adopt_membership

            def timed_adopt(sidx):
                before = worker.counters["membership_events"]
                adopt(sidx)
                if worker.counters["membership_events"] > before:
                    adopted.append(time.time())
            worker._adopt_membership = timed_adopt
            push, pull = worker.push_bytes, worker.pull_bytes

            def logged_push(key, buf, *a, **k):
                v = push(key, buf, *a, **k)
                heads[(key, v)] = np.frombuffer(buf[:64].tobytes(),
                                                np.float32)
                return v

            def logged_pull(key, capacity, version, *a, **k):
                got = pull(key, capacity, version, *a, **k)
                served = worker.last_pull_round()
                mine = heads.get((key, served))
                alone = (None if mine is None or not mine.any() else
                         np.array_equal(np.frombuffer(got[:64].tobytes(),
                                                      np.float32),
                                        mine * np.float32(2)))
                served_log.append((version, served, alone))
                return got
            worker.push_bytes, worker.pull_bytes = logged_push, logged_pull

        def between(i):
            if leg in CHAOS_KILL and i == CHAOS_KILL_STEP:
                Path(f"{sigdir}/{leg}.done{rank}").touch()
                out["killed_at"] = float(wait_file(f"{sigdir}/{leg}.killed"))
            if owner_kill is not None and i == CHAOS_KILL_STEP:
                arm_owner_kill()
            if leg == "dcn_lease_evict" and i == CHAOS_KILL_STEP:
                if rank == 1:
                    worker._plan = timed_plan("worker:kill", rank)
                else:
                    saved["params"] = [p.detach().clone() for p in leaves]
                    saved["opt"] = copy.deepcopy(opt.state_dict())

        # bytes pushed, pulled, copied D2H and H2D, then each stage's (and
        # the tail's) run and dwell sums, read around every step
        reg.histogram("eager.tail_us")
        stages = sorted({**hist_sums(reg), **hist_sums(reg, "eager.")})

        def probe():
            sums = {**hist_sums(reg), **hist_sums(reg, "eager.")}
            return copies() + tuple(sums.get(k, 0.0) for k in stages)

        out.update(dcn_timed_steps(one_step, leaves, steps, probe, between))
        deltas = out.pop("deltas")
        out["bytes_per_step"] = [d[:4] for d in deltas]
        out["stage_ms_per_step"] = {
            k: [d[4 + i] / 1e3 for d in deltas]
            for i, k in enumerate(stages) if any(d[4 + i] for d in deltas)}
        out["launches"] = dict(launches)
        if worker is not None:
            out["counters"] = worker.get_counters()
            out["live_servers"] = sorted(worker.live_servers())
            out["failover_at"] = failed_over
        if leg in dict(ELASTIC_LEGS):
            out["live_size"] = core.live_size()
            out["adopted_at"] = adopted
            out["served"] = served_log
            out["killed_at"] = kills[0] if kills else None
        if saved:
            # the second timed step replayed on one worker from rank 0's
            # state after the first: same parameters, AdamW moments and
            # batch, the gradient undivided, no wire
            for h in opt._hooks:
                h.remove()
            solo = adamw(leaves)
            solo.load_state_dict(saved.pop("opt"))
            with torch.no_grad():
                for p, v in zip(leaves, saved.pop("params")):
                    p.copy_(v)
            solo.zero_grad()
            gpt_loss(params, tok, tgt, cfg, chunked_ce=True).backward()
            solo.step()
            out["replay_digest"] = params_digest(leaves)
            del solo
        if owner_kill is not None:
            eager._fail_owner = fail_owner
            pools = eager._state.scheduler.credit_pools()
            out["owner"] = {
                "owner_failovers": eager._state.owner_failovers,
                "live_owners": sorted(eager._state.owners.live()),
                "nic_retired": reg.counter("nic.retired").value() - retired0,
                "credit_pools": {str(k): v for k, v in pools.items()},
                "credits_full": all(v == eager._state.cfg.scheduling_credit
                                    for v in pools.values()),
                "nic_counters": [w.get_counters()
                                 for w in eager._state.psworkers],
                "nic_bytes": [[w.bytes_pushed, w.bytes_pulled]
                              for w in eager._state.psworkers],
                "kill_to_remap_ms": [(t - kills[0]) * 1e3 for t in remaps]
                if kills else None}
        if leg == "dcn_failover":
            # DcnCore's degraded path on the card at size() 2: once no
            # server lives, a tensor's average is its own value, undivided
            fail_over(0, barrier=False)
            gen = torch.Generator(device="cuda").manual_seed(7 + rank)
            x = torch.randn(3_000_000, device="cuda", generator=gen)
            y = tbps.push_pull(x.clone(), average=True, name="degraded_probe")
            out["degraded_probe"] = {
                "equal_local": bool(torch.equal(y, x)),
                "ici_fallbacks": worker.get_counters()["ici_fallbacks"]}
        if hybrid:
            eager.shutdown()
        elif "died" in out:
            # a dead process says no goodbye: its lease expired, and the
            # server counts it out
            for sched in (core.scheduler, core._cuda_scheduler):
                if sched is not None:
                    sched.shutdown()
            for w in core.workers:
                w.close()
            tbps._state.initialized = False
        else:
            out["credits"] = [(s._credits, s._credit_total) for s in
                              (core.scheduler, core._cuda_scheduler) if s]
            tbps.shutdown()
        res[leg] = out
        del opt, params, leaves
        gc.collect()
        torch.cuda.empty_cache()
    return res


def killed_by_plan(e: BaseException) -> bool:
    """Whether ``e`` (or the error it wraps) is an injected worker death."""
    from byteps_tpu_torch.common.faults import WorkerKilledError

    seen = set()
    while e is not None and id(e) not in seen:
        if isinstance(e, WorkerKilledError):
            return True
        seen.add(id(e))
        e = getattr(e, "cause", None) or e.__cause__
    return False


def check_elastic_legs(per_rank, steps) -> dict:
    """The checks of train_chaos's ``ELASTIC_LEGS`` beyond those every dcn
    leg takes (dcn_join and dcn_straggler_k0 take those too): raises on a
    miss, returns what each leg adds to its line."""
    from byteps_tpu_torch.models import GPTConfig

    cfg = rank_phase_cfg("train_chaos")
    calls = steps + 1
    full = [gpt_param_count(cfg) * 4] * 4
    staged = [r["staged_raw"]["digests"] for r in per_rank]
    out = {}
    for r in per_rank:
        for leg, _ in ELASTIC_LEGS:
            got = {k: r[leg]["launches"][k] for k in TRAIN}
            if got != {k: calls * cfg.n_layers for k in TRAIN}:
                raise AssertionError(f"train_chaos {leg}: rank {r['rank']} "
                                     f"launched {got}")
            if not np.isfinite(r[leg]["losses"]).all():
                raise AssertionError(f"train_chaos {leg}: a loss is not "
                                     f"finite: {r[leg]['losses']}")
    # dcn_lease_evict: step 1 as staged_raw's on both ranks, rank 1 dead
    # of its plan in step 2, rank 0's step 2 the one-worker replay's
    e0, e1 = (r["dcn_lease_evict"] for r in per_rank)
    for r, e in zip(per_rank, (e0, e1)):
        if e["digests"][:2] != staged[r["rank"]][:2]:
            raise AssertionError(f"train_chaos dcn_lease_evict: rank "
                                 f"{r['rank']}'s first steps differ from "
                                 "staged_raw's")
    if "died" in e0 or "died" not in e1 or e1["killed_at"] is None:
        raise AssertionError("train_chaos dcn_lease_evict: rank 1 must die "
                             f"of its plan and rank 0 live: {e1.get('died')}")
    if e0["digests"][2] != e0["replay_digest"]:
        raise AssertionError("train_chaos dcn_lease_evict: rank 0's second "
                             "step differs from the one-worker replay")
    c = e0["counters"]
    if (c["membership_events"] < 1 or e0["live_size"] != 1
            or not e0["adopted_at"]
            or e0["bytes_per_step"] != [full] * calls):
        raise AssertionError(f"train_chaos dcn_lease_evict: rank 0 counters "
                             f"{c}, live {e0['live_size']}, bytes "
                             f"{e0['bytes_per_step']}")
    out["dcn_lease_evict"] = {
        "kill_to_eviction_ms": (e0["adopted_at"][0] - e1["killed_at"]) * 1e3,
        "replay_bit_equal": True, "died": e1["died"],
        "membership_events": c["membership_events"],
        "live_size": e0["live_size"]}
    # dcn_join: the divisor is the live count 2, so every step is
    # staged_raw's (checked with the other dcn legs)
    j0, j1 = (r["dcn_join"] for r in per_rank)
    if (j1["counters"]["joins"] != 1 or j1.get("joined_live") != 2
            or j0["counters"]["membership_events"] < 1
            or j0["live_size"] != 2 or j1["live_size"] != 2):
        raise AssertionError(f"train_chaos dcn_join: joins "
                             f"{j1['counters']['joins']}, live "
                             f"{j1.get('joined_live')}, rank 0 "
                             f"{j0['counters']}")
    out["dcn_join"] = {"joins": j1["counters"]["joins"],
                       "membership_events_rank0":
                       j0["counters"]["membership_events"],
                       "live_size": [j0["live_size"], j1["live_size"]]}
    # dcn_straggler_k1: the warm-up (round 1, a full quorum sum) as
    # staged_raw's; every pull at most one round stale; rounds served
    # ahead to the straggler were closed past it (force-closed, at least)
    k1 = [r["dcn_straggler_k1"] for r in per_rank]
    for r, k in zip(per_rank, k1):
        if k["digests"][0] != staged[r["rank"]][0]:
            raise AssertionError(f"train_chaos dcn_straggler_k1: rank "
                                 f"{r['rank']}'s warm-up differs from "
                                 "staged_raw's")
        if k["bytes_per_step"] != [full] * calls:
            raise AssertionError(f"train_chaos dcn_straggler_k1: rank "
                                 f"{r['rank']}'s bytes "
                                 f"{k['bytes_per_step']}")
    lags = [[v - s for v, s, _ in k["served"]] for k in k1]
    if any(d > 1 for lag in lags for d in lag):
        raise AssertionError("train_chaos dcn_straggler_k1: a pull served "
                             "more than one round stale: "
                             f"{max(map(max, lags))}")
    k0 = [r["dcn_straggler_k0"] for r in per_rank]
    if any(a for k in k0 for _, _, a in k["served"]):
        raise AssertionError("train_chaos dcn_straggler_k0: a round closed "
                             "over one rank alone under K = 0")
    out["dcn_straggler_k1"] = {
        "pulls": [len(lag) for lag in lags],
        "stale_by_one": [sum(d == 1 for d in lag) for lag in lags],
        "served_ahead": [sum(d < 0 for d in lag) for lag in lags],
        # rounds the fast rank force-closed over itself past the straggler
        "closed_over_self_alone": [sum(a is True for _, _, a in k["served"])
                                   for k in k1],
        "zero_heads": [sum(a is None for _, _, a in k["served"])
                       for k in k1],
        "max_staleness": max(max(lag) for lag in lags),
        "step_ms_k1": [sum(k["step_ms_each"]) / steps for k in k1],
        "step_ms_k0": [sum(k["step_ms_each"]) / steps for k in k0],
        "straggle_ms_a_wire_attempt": STRAGGLER_MS}
    return out


def wait_listening(port: int, bound: float = 60.0) -> None:
    """Return once something accepts on the loopback ``port``."""
    import socket

    end = time.monotonic() + bound
    while True:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            if time.monotonic() > end:
                raise TimeoutError(f"nothing listens on :{port} after "
                                   f"{bound} s") from None
            time.sleep(0.01)


def free_port_pair() -> int:
    """A port p with p and p + 1 both free on the loopback."""
    import socket

    while True:
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            p = a.getsockname()[1]
            try:
                with socket.socket() as b:
                    b.bind(("127.0.0.1", p + 1))
            except OSError:
                continue
            return p


def phase_train_chaos(B=4, S=1024, steps=2) -> dict:
    """The DCN tier's robustness on the card: the two rank processes of
    train_dcn, a pair of port server processes a leg, and the legs of
    ``CHAOS_LEGS`` and ``ELASTIC_LEGS`` after staged_raw (see phase 14
    in the module's docstring). A watcher thread kills a leg's servers
    (``CHAOS_KILL``) once both ranks ended its first timed step and tells
    them the kill's time, and starts an elastic leg's servers once both
    ranks asked for them (``<leg>.want<rank>``), telling them once both
    listen (``<leg>.up``); the elastic legs' own checks are
    :func:`check_elastic_legs`'s. Checks: every chaos leg's (and
    dcn_join's and dcn_straggler_k0's) parameters equal on both ranks and
    equal to staged_raw's after every step, bit for bit; every loss
    finite; the
    flash kernels once per layer and step; bytes pushed, pulled, D2H and
    H2D per step exact (none on the wire in hybrid_degraded's step after
    the kill, none at all on the pod's other rank); dcn_chaos: retries,
    injected timeouts and corruptions and CRC errors on each rank, no
    give-up; dcn_failover: one failover a rank to ``{0}``, and re-inits
    that cover every key homed on server 1; hybrid_degraded: both servers
    failed over on the controller and a degraded fallback a partition of
    the step after the kill; hybrid_owner_failover: one owner failover,
    its NIC retired, owners 0 and 2 left, no server failed over, every
    credit pool full; every credit of the dcn legs back; the servers not
    killed exit 0 after the ranks' goodbyes. Returns rank 0's launch
    counts summed over the legs."""
    import os
    import shutil
    import tempfile
    import threading
    from pathlib import Path

    from byteps_tpu_torch.models import GPTConfig
    from byteps_tpu_torch.server import native

    n = 2
    native.build()
    bases = {leg: free_port_pair() for leg, _ in CHAOS_LEGS + ELASTIC_LEGS}
    servers = {}
    sigdir = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    stop = threading.Event()
    watch_errors = []

    def start_servers(leg, env):
        workers = ("1" if leg.startswith("hybrid") or leg == "dcn_join"
                   else str(n))
        servers[leg] = [subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.server"],
            env=dict(os.environ, DMLC_ROLE="server",
                     DMLC_NUM_WORKER=workers, DMLC_NUM_SERVER="2",
                     DMLC_PS_ROOT_URI="127.0.0.1",
                     DMLC_PS_ROOT_PORT=str(bases[leg] - 1),
                     DMLC_SERVER_ID=str(i),
                     **{k: env[k] for k in SERVER_KNOBS if k in env}),
            cwd=Path(__file__).resolve().parent, stdout=sys.stderr)
            for i in range(2)]

    def watch():
        pending = dict(CHAOS_KILL)
        # a lease runs from the server's start: an elastic leg's servers
        # start once both ranks are about to connect, and the ranks go on
        # once both listen
        to_start = dict(ELASTIC_LEGS)
        try:
            while (pending or to_start) and not stop.is_set():
                for leg, env in list(to_start.items()):
                    if all(os.path.exists(f"{sigdir}/{leg}.want{r}")
                           for r in range(n)):
                        start_servers(leg, env)
                        for i in range(2):
                            wait_listening(bases[leg] + i)
                        open(f"{sigdir}/{leg}.up", "w").close()
                        del to_start[leg]
                for leg, idx in list(pending.items()):
                    if all(os.path.exists(f"{sigdir}/{leg}.done{r}")
                           for r in range(n)):
                        t = time.time()
                        for i in idx:
                            servers[leg][i].kill()
                        for i in idx:
                            servers[leg][i].wait()
                        with open(f"{sigdir}/{leg}.tmp", "w") as f:
                            f.write(repr(t))
                        os.replace(f"{sigdir}/{leg}.tmp",
                                   f"{sigdir}/{leg}.killed")
                        del pending[leg]
                stop.wait(0.005)
        except Exception as e:       # the ranks then time out waiting
            watch_errors.append(e)

    watcher = threading.Thread(target=watch, daemon=True)
    try:
        for leg, env in CHAOS_LEGS:
            start_servers(leg, env)
        watcher.start()
        t0 = time.perf_counter()
        per_rank = spawn_ranks(train_chaos_rank, n, B, S, steps, bases,
                               sigdir)
        wall = time.perf_counter() - t0
        if watch_errors:
            raise AssertionError(f"train_chaos: the watcher failed: "
                                 f"{watch_errors}")
        for leg, pair in servers.items():
            for i, server in enumerate(pair):
                try:
                    rc = server.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    raise AssertionError(f"train_chaos {leg}: server {i} "
                                         "outlived its workers") from None
                want = -9 if i in CHAOS_KILL.get(leg, ()) else 0
                if rc != want:
                    raise AssertionError(f"train_chaos {leg}: server {i} "
                                         f"exited {rc}, not {want}")
    finally:
        stop.set()
        if watcher.is_alive():
            watcher.join(5)
        for pair in servers.values():
            for server in pair:
                if server.poll() is None:
                    server.kill()
                    server.wait()
        shutil.rmtree(sigdir, ignore_errors=True)
    cfg = rank_phase_cfg("train_chaos")
    calls = steps + 1
    n_bytes = gpt_param_count(cfg) * 4
    legs = ("staged_raw",) + tuple(leg for leg, _ in CHAOS_LEGS)
    elastic = check_elastic_legs(per_rank, steps)
    for leg in legs + ("dcn_join", "dcn_straggler_k0"):
        a, b = (r[leg] for r in per_rank)
        if a["digests"] != b["digests"]:
            raise AssertionError(f"train_chaos {leg}: the ranks' parameters "
                                 "differ")
        for r in per_rank:
            if not np.isfinite(r[leg]["losses"]).all():
                raise AssertionError(f"train_chaos {leg}: a loss is not "
                                     f"finite: {r[leg]['losses']}")
            got = {k: r[leg]["launches"][k] for k in TRAIN}
            if got != {k: calls * cfg.n_layers for k in TRAIN}:
                raise AssertionError(f"train_chaos {leg}: rank {r['rank']} "
                                     f"launched {got}, not "
                                     f"{calls * cfg.n_layers} each")
            if leg == "staged_raw":
                continue
            differ = [i for i, (x, y) in enumerate(zip(
                r[leg]["digests"], r["staged_raw"]["digests"])) if x != y]
            if differ:
                raise AssertionError(
                    f"train_chaos: rank {r['rank']}'s {leg} parameters "
                    f"differ from staged_raw's after step(s) {differ} (0: "
                    "warm-up)")
            # every leg's wire is raw f32: the gradient's bytes each way
            wire = n_bytes
            want = [[wire, wire, n_bytes, n_bytes]] * calls
            if leg == "hybrid_degraded":
                want = ([[wire, wire, n_bytes, n_bytes]] * (CHAOS_KILL_STEP + 1)
                        + [[0, 0, n_bytes, n_bytes]]
                        * (calls - CHAOS_KILL_STEP - 1))
            if leg.startswith("hybrid") and r["rank"] != 0:
                want = [[0, 0, 0, 0]] * calls
            if r[leg]["bytes_per_step"] != want:
                raise AssertionError(
                    f"train_chaos {leg}: rank {r['rank']}'s bytes (pushed, "
                    f"pulled, D2H, H2D) per step {r[leg]['bytes_per_step']},"
                    f" want {want}")
            if "credits" in r[leg] and any(
                    a != b for a, b in r[leg]["credits"]):
                raise AssertionError(f"train_chaos {leg}: rank {r['rank']} "
                                     f"leaked credits: {r[leg]['credits']}")
    for r in per_rank:
        c = r["dcn_chaos"]["counters"]
        if not (c["retries"] > 0 and c["injected_timeout"] > 0
                and c["injected_corrupt"] > 0 and c["crc_errors"] > 0
                and c["give_ups"] == 0):
            raise AssertionError(f"train_chaos dcn_chaos: rank {r['rank']}'s "
                                 f"counters {c}")
        f = r["dcn_failover"]
        if (f["counters"]["failovers"] != 1 or f["live_servers"] != [0]
                or f["counters"]["give_ups"] != 0):
            raise AssertionError(f"train_chaos dcn_failover: rank "
                                 f"{r['rank']}: live {f['live_servers']}, "
                                 f"counters {f['counters']}")
        if not (f["degraded_probe"]["equal_local"]
                and f["degraded_probe"]["ici_fallbacks"] > 0):
            raise AssertionError(f"train_chaos dcn_failover: rank "
                                 f"{r['rank']}'s degraded push_pull: "
                                 f"{f['degraded_probe']}")
    # each key homed on server 1 is re-inited on server 0 by whichever
    # rank pushes it there first
    reinits = sum(r["dcn_failover"]["counters"]["reinits"] for r in per_rank)
    moved = per_rank[0]["dcn_failover"]["keys_on_server1"]
    if not 0 < moved <= reinits:
        raise AssertionError(f"train_chaos dcn_failover: {reinits} re-inits "
                             f"for {moved} keys moved to server 0")
    h = per_rank[0]["hybrid_degraded"]
    if (h["counters"]["ici_fallbacks"] < 1 or h["live_servers"] != []
            or h["counters"]["failovers"] != 2):
        raise AssertionError(f"train_chaos hybrid_degraded: live "
                             f"{h['live_servers']}, counters {h['counters']}")
    # owner 1's NIC gave up inside the second timed step: one owner
    # failover, its NIC retired, owners 0 and 2 carry the rest, every
    # credit pool full, no server failed over
    o = per_rank[0]["hybrid_owner_failover"]["owner"]
    c = o["nic_counters"]
    if (o["owner_failovers"] != 1 or o["nic_retired"] != 1
            or o["live_owners"] != [0, 2] or not o["credits_full"]
            or c[1].get("injected_kill", 0) < 1
            or any(x["failovers"] for x in c)
            or not o["kill_to_remap_ms"]
            or not all(p > 0 for p, _ in o["nic_bytes"])):
        raise AssertionError(f"train_chaos hybrid_owner_failover: {o}")
    tokens = n * B * S
    legs_out = {}
    legs += tuple(leg for leg, _ in ELASTIC_LEGS)
    for leg in legs:
        step_ms = max(sum(r[leg]["step_ms_each"]) / steps for r in per_rank)
        legs_out[leg] = {
            "losses": [r[leg]["losses"] for r in per_rank],
            "step_ms": step_ms,
            "step_ms_each": [r[leg]["step_ms_each"] for r in per_rank],
            "tokens_per_s": tokens / step_ms * 1e3,
            "max_memory_allocated_gb": [r[leg]["max_memory_allocated_gb"]
                                        for r in per_rank],
            **{k: [r[leg].get(k) for r in per_rank]
               for k in ("counters", "live_servers", "bytes_per_step",
                         "stage_ms_per_step", "degraded_probe")
               if k in per_rank[0][leg]}}
        if "owner" in per_rank[0][leg]:
            legs_out[leg]["owner"] = per_rank[0][leg]["owner"]
        if leg in CHAOS_KILL:
            legs_out[leg]["kill_to_failover_ms"] = [
                [(t - r[leg]["killed_at"]) * 1e3 for t in r[leg]["failover_at"]]
                if "failover_at" in r[leg] else None for r in per_rank]
    legs_out["dcn_failover"]["reinits_for_keys_on_server1"] = [reinits,
                                                               moved]
    for leg, extra in elastic.items():
        legs_out[leg].update(extra)
    emit({"phase": "train_chaos", "ranks": n, "layers": cfg.n_layers,
          "depth_cut": "24 layers cut to keep the smoke in its limit",
          "servers": "two processes a leg",
          "timing": "two ranks time-slice one card", "batch_per_rank": B,
          "seq": S, "steps": steps, "kill_after_step": CHAOS_KILL_STEP,
          "fault_spec": CHAOS_SPEC, "health": CHAOS_HEALTH,
          "elastic_lease": ELASTIC_LEASE, "straggler": STRAGGLER,
          "host_cpus": os.cpu_count(), "legs_equal_staged_raw": True,
          "bytes_per_step_fields": ["pushed", "pulled", "d2h", "h2d"],
          "wall_s": wall, "legs": legs_out})
    total = {}
    for leg in legs:
        for k, v in per_rank[0][leg]["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


# --------------------------------------------------------------------------
# phase 16: tensor and sequence parallelism, ranks that share the card
# --------------------------------------------------------------------------
# (name, ranks, mesh axes, seq_layout, chunked_ce, compression): GPT-2
# medium on a mesh of rank processes time-slicing the card, each held to
# one_rank, the same global batch and seeded weights on one rank
PARALLEL_LEGS = (
    ("tp2_raw", 2, {"tp": 2}, "contiguous", True, None),
    ("sp2_raw", 2, {"sp": 2}, "contiguous", True, None),
    ("sp2_zigzag", 2, {"sp": 2}, "zigzag", True, None),
    ("tp2_sp2_vocab", 4, {"tp": 2, "sp": 2}, "contiguous", "vocab_parallel",
     None),
    ("dp2_tp2_onebit_ef", 4, {"dp": 2, "tp": 2}, "contiguous", True,
     ONEBIT_EF),
    # the same leg on the ring tier over each dp line (two rings at once)
    ("dp2_tp2_onebit_ring", 4, {"dp": 2, "tp": 2}, "contiguous", True,
     ONEBIT_EF))
# the global batch (B, S) of every leg and of one_rank
PARALLEL_BATCH = (4, 1024)
PARALLEL_LR = 1e-3
# a leg against one_rank: the loss at each step, and for each leaf the
# share of its gathered elements further than 2·lr from one_rank's
# (AdamW moves an element by about lr a step, along its gradient's sign:
# one that lands further than 2·lr away went the other way on both steps)
PARALLEL_LOSS_TOL = 1e-2
# The per-leaf limit. Roundoff alone: a bf16 gradient near zero takes
# the other sign when the forward rounds differently (tp sums two bf16
# partial products, the ring merges two partial attentions), and AdamW
# then moves it 2·lr the other way a step. The split_matmul control
# (one rank whose row-parallel products are two bf16 partials summed in
# f32, as tp = 2 computes them) reads that share on one rank; the planted
# fault (sp2_fault: the sp sum of wte's and wpe's gradients dropped)
# reads what a missing sum does. The limit is the geometric mean of the
# two (NVIDIA H100 80GB HBM3, 700 W, GPT-2 medium, 2 steps): the control's
# worst leaf 1.17e-2 (a 1,024-element bias; the raw legs' 6.8e-3 to
# 1.07e-2, every leaf of the f32 legs 0) and the fault's wte 3.39e-2. wpe's
# dropped sum stays under it (a rank's gradient of wpe is zero outside
# its own positions, so those rows move by the decay alone, under 2·lr
# from one_rank's); the replicas' digest catches that.
PARALLEL_OFF_SHARE = 2e-2
# leaves the per-leaf limit does not hold: the key bias's exact gradient
# is zero (it shifts every score of a query by the same amount, which the
# softmax cancels), so its sign is roundoff's and AdamW moves each
# element lr one way or the other in any layout; its share is reported
PARALLEL_NOISE_LEAVES = ("bk",)
# the planted fault: sp2_raw with the sp sum dropped on these leaves (each
# sp rank steps them with its own tokens' gradient), run to show that the
# per-leaf check sees it; its leaves' readings are the upper ones
PARALLEL_FAULT = ("sp2_fault", 2, {"sp": 2}, "contiguous", True, None)
PARALLEL_FAULT_LEAVES = ("wte", "wpe")
# the onebit leg against one_rank's raw step: one_rank sums the exact
# gradients, the leg the dp ranks' signs times their chunk scales, so
# after the warm-up's update the two are different trainings. The
# warm-up's loss (same weights, no update yet) is held to
# PARALLEL_LOSS_TOL; after it the loss to this gap, and the share of
# parameters further than 2·lr to ONEBIT_OFF_BOUND (the reference's
# own onebit + EF against its raw step, dp2 on the CPU, tiny model, 2
# steps: loss 0.05 apart, 21.7% of the parameters further than 2·lr)
PARALLEL_ONEBIT_LOSS_GAP = 0.1
PARALLEL_ONEBIT_OFF_SHARE = 0.3
# the f32 parity case: a small model, plain versions (CPU tensors) and
# kernels (the card) through the same mesh step, against one rank's step:
# the losses within this, the parameters held per leaf as the bf16 legs
PARALLEL_F32_TOL = 1e-4
PARALLEL_F32_BATCH = (4, 256)
PARALLEL_F32_LEGS = (("f32_tp2_sp2", {"tp": 2, "sp": 2}, "contiguous"),
                     ("f32_dp2_sp2_zigzag", {"dp": 2, "sp": 2}, "zigzag"))


def parallel_f32_cfg():
    from byteps_tpu_torch.models import GPTConfig

    return GPTConfig(vocab_size=512, max_seq=256, d_model=256, n_heads=4,
                     n_layers=2, d_ff=1024, dtype=torch.float32)


def parallel_batch(cfg, B, S, device):
    from byteps_tpu_torch.models import synthetic_batch

    return synthetic_batch(torch.Generator(device=device).manual_seed(1),
                           cfg, B, S)


def zigzag_batch(tok, tgt, n):
    from byteps_tpu_torch.parallel.ring_attention import zigzag_permutation

    perm = zigzag_permutation(tok.shape[1], n).to(tok.device)
    return tok[:, perm], tgt[:, perm]


def named_leaves(tree, prefix: str = "") -> list:
    """(name, array) of a nested parameter tree in ``flat_leaves``'
    order: keys sorted at every level, blocks as ``blocks.<i>.<key>``
    (an MoE block's experts ``blocks.<i>.moe.<key>``)."""
    if isinstance(tree, dict):
        return [nl for k in sorted(tree)
                for nl in named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [nl for i, b in enumerate(tree)
                for nl in named_leaves(b, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def off_2lr_by_leaf(tree, ref) -> dict:
    """{leaf: [elements further than 2·lr from ``ref``, elements, largest
    distance]}: ``ref`` the flat parameters in ``flat_leaves`` order."""
    out, off = {}, 0
    for name, a in named_leaves(tree):
        d = np.abs(a.ravel() - np.asarray(ref[off:off + a.size]))
        off += a.size
        out[name] = [int((d > 2 * PARALLEL_LR).sum()), int(a.size),
                     float(d.max())]
    if off != ref.size:
        raise AssertionError(f"{off} parameters against {ref.size}")
    return out


def off_summary(per_leaf) -> dict:
    """A per-leaf reading: the whole share, the largest distance, the
    worst leaf the limit holds (not of PARALLEL_NOISE_LEAVES' kinds) and
    its share, and the share of each kind of leaf (``wq``, ``ln1_g``, …)
    over the blocks."""
    kinds = {}
    for name, (o, n, _) in per_leaf.items():
        k = kinds.setdefault(name.split(".")[-1], [0, 0])
        k[0] += o
        k[1] += n
    held = [k for k in per_leaf
            if k.split(".")[-1] not in PARALLEL_NOISE_LEAVES]
    worst = max(held, key=lambda k: per_leaf[k][0] / per_leaf[k][1])
    return {"share": (sum(v[0] for v in per_leaf.values())
                      / sum(v[1] for v in per_leaf.values())),
            "max_abs_diff": max(v[2] for v in per_leaf.values()),
            "worst_leaf": worst,
            "worst_share": per_leaf[worst][0] / per_leaf[worst][1],
            "by_kind": {k: o / n for k, (o, n) in sorted(kinds.items())}}


def flat_params(opt) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1).float()
                      for p in opt.params]).cpu().numpy()


@contextlib.contextmanager
def split_row_parallel():
    """A context in which a one-rank step computes each row-parallel
    product (attention's output projection, the MLP's down projection) as
    tp = 2 does: two bf16 partial products over the halves of the
    contraction, summed in f32 and rounded, the bias after the sum."""
    from byteps_tpu_torch.models import gpt

    inner = gpt.row_parallel_matmul

    def split(x, w, axis, b=None):
        h = w.shape[0] // 2
        y = ((x[..., :h] @ w[:h]).float()
             + (x[..., h:] @ w[h:]).float()).to(x.dtype)
        return y if b is None else y + b

    gpt.row_parallel_matmul = split
    try:
        yield
    finally:
        gpt.row_parallel_matmul = inner


def drop_sp_sum(params, opt, names) -> None:
    """The planted fault: the leaves ``names`` stepped with this rank's
    own gradient, as a step that left out their sum over sp would (each
    leaf's gradient is kept when its backward ends, and put back in
    place of the summed one before the optimizer steps)."""
    held = {}
    for nm in names:
        params[nm].register_post_accumulate_grad_hook(
            lambda t, nm=nm: held.__setitem__(nm, t.grad.clone()))
    inner = opt.step

    def step(*a, **kw):
        for nm in names:
            params[nm].grad = held[nm]
        return inner(*a, **kw)

    opt.step = step


def parallel_f32_one(device, steps=3) -> tuple:
    """The f32 case's one-rank losses and flat parameters on
    ``device``."""
    from byteps_tpu_torch.models import gpt_init, make_gpt_train_step

    cfg = parallel_f32_cfg()
    init = gpt_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    step, _, opt = make_gpt_train_step(cfg, init_params=init.to(device),
                                       device=device)
    tok, tgt = parallel_batch(cfg, *PARALLEL_F32_BATCH, "cpu")
    losses = [float(step(tok.to(device), tgt.to(device)))
              for _ in range(steps)]
    return losses, flat_params(opt)


def train_parallel_rank(rank, n, B, S, steps, ref_path, f32_refs):
    """One rank of train_parallel: each leg of ``n`` ranks (and, at 2, the
    planted fault) builds its mesh and the training step from the seeded
    weights, trains on the global batch (its block), and reports losses,
    step times, peak memory, the launch and collective counts, a digest
    of its tp-replicated leaves and (rank 0) each gathered leaf's count
    of elements further than 2·lr from one_rank's; then the f32 parity
    legs on the CPU and on the card."""
    from byteps_tpu_torch.models import make_gpt_train_step, params_to_numpy
    from byteps_tpu_torch.models.convert import flat_specs, param_specs
    from byteps_tpu_torch.ops import launches, reset_launches
    from byteps_tpu_torch.parallel.mesh import (MeshAxes, collectives,
                                                make_mesh,
                                                reset_collectives)
    from byteps_tpu_torch.parallel.partitioner import spec_axes

    cfg = rank_phase_cfg("train_parallel")
    ref = np.load(ref_path, mmap_mode="r")
    res = {}
    for leg, ranks, axes, layout, ce, comp in PARALLEL_LEGS + (
            PARALLEL_FAULT,):
        if ranks != n:
            continue
        mesh = make_mesh(MeshAxes(**axes))
        step, params, opt = make_gpt_train_step(
            cfg, compression_params=comp, chunked_ce=ce, seq_layout=layout,
            generator=torch.Generator(device="cuda").manual_seed(0),
            mesh=mesh)
        if leg == PARALLEL_FAULT[0]:
            drop_sp_sum(params, opt, PARALLEL_FAULT_LEAVES)
        tok, tgt = parallel_batch(cfg, B, S, "cuda")
        if layout == "zigzag":
            tok, tgt = zigzag_batch(tok, tgt, axes["sp"])
        gc.collect()
        torch.cuda.empty_cache()
        reset_launches()
        reset_collectives()
        with ici_tier("ring" if leg in RING_TIER_TWIN else None):
            out = timed_train(step, opt, tok, tgt, steps)
        close_rings(mesh)
        out["launches"] = dict(launches)
        out["collectives"] = dict(collectives)
        specs = flat_specs(param_specs(cfg, mesh))
        rep = [p for p, s in zip(opt.params, specs)
               if "tp" not in spec_axes(s)]
        out["rep_sha1"] = params_digest(rep)
        out["params_sha1"] = params_digest(opt.params)
        out["coords"] = {a: mesh.axis_index(a) for a in mesh.axis_names}
        out["local_params"] = sum(p.numel() for p in opt.params)
        tree = params_to_numpy(params, mesh=mesh)
        if rank == 0:
            out["off_2lr"] = off_2lr_by_leaf(tree, ref)
        res[leg] = out
        del step, params, opt, tree
        gc.collect()
        torch.cuda.empty_cache()
    if n == 4:
        res["f32"] = parallel_f32_rank(rank, f32_refs)
    return res


def parallel_f32_rank(rank, refs, steps=3) -> dict:
    """The f32 parity legs on this rank: the same mesh step on CPU
    tensors (the plain versions) and on the card (the kernels), the
    losses and (rank 0) each leaf's count of elements further than 2·lr
    from the one-rank step's on that device (``refs``)."""
    from byteps_tpu_torch.models import (gpt_init, make_gpt_train_step,
                                         params_to_numpy)
    from byteps_tpu_torch.ops import launches, reset_launches
    from byteps_tpu_torch.parallel.mesh import MeshAxes, make_mesh

    torch.set_num_threads(2)
    cfg = parallel_f32_cfg()
    out = {}
    for leg, axes, layout in PARALLEL_F32_LEGS:
        mesh = make_mesh(MeshAxes(**axes))
        for dev in ("cpu", "cuda"):
            init = gpt_init(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
            step, params, _ = make_gpt_train_step(
                cfg, init_params=init.to(dev), device=dev, mesh=mesh,
                seq_layout=layout)
            tok, tgt = parallel_batch(cfg, *PARALLEL_F32_BATCH, "cpu")
            if layout == "zigzag":
                tok, tgt = zigzag_batch(tok, tgt, axes["sp"])
            reset_launches()
            out[f"{leg}_{dev}"] = [float(step(tok.to(dev), tgt.to(dev)))
                                   for _ in range(steps)]
            out[f"{leg}_{dev}_launches"] = dict(launches)
            tree = params_to_numpy(params, mesh=mesh)
            if rank == 0:
                out[f"{leg}_{dev}_off_2lr"] = off_2lr_by_leaf(tree,
                                                              refs[dev])
    return out


def phase_train_parallel(B=PARALLEL_BATCH[0], S=PARALLEL_BATCH[1],
                         steps=1) -> dict:
    """GPT-2 medium at full width and 12 of its 24 layers
    (:data:`RANK_PHASE_LAYERS`) on meshes of rank processes (``spawn``,
    one gloo group over a FileStore) that time-slice the card,
    bf16 over f32 master weights, AdamW(1e-3), the global batch B=4 ×
    S=1024 and the seeded weights of one_rank (the same step on one rank,
    in this process, the yardstick), one warm-up and ``steps`` timed steps
    a leg: tp2_raw, sp2_raw (the contiguous ring), sp2_zigzag, tp2_sp2_vocab
    (``chunked_ce="vocab_parallel"``), dp2_tp2_onebit_ef (onebit + EF over
    the dp axis). Each leg: losses finite and falling; each step's loss
    within PARALLEL_LOSS_TOL of one_rank's (the onebit leg: its warm-up,
    then within PARALLEL_ONEBIT_LOSS_GAP); every gathered leaf further
    than 2·lr from one_rank's in under PARALLEL_OFF_SHARE of its elements
    (the onebit leg: the whole under PARALLEL_ONEBIT_OFF_SHARE); the
    tp-replicated leaves bit-identical on every rank; the launch counts
    exact (the flash kernels once per layer, ring step and step, five
    half-pair calls a layer in the zigzag ring at sp = 2; onebit pack 3
    and unpack-sum 5 times per chunk and step over the dp axis of 2), the
    split-path forwards among them those the library's route gives the
    leg's calls (:func:`leg_routes`); ms a step, peak memory and
    collectives per step by kind. Beside them the roundoff control (one
    rank with tp = 2's row-parallel arithmetic, :func:`split_row_parallel`),
    which must pass the per-leaf check, and the planted fault
    (PARALLEL_FAULT), which must fail it. Then the f32 parity case: a small model's tp2×sp2
    (contiguous) and dp2×sp2 (zigzag) steps on the CPU (plain versions)
    and on the card (kernels), three steps each, the losses within
    PARALLEL_F32_TOL of one rank's on the same device and every leaf
    within the per-leaf limit. Returns the counts of one rank per leg and
    one_rank's, summed."""
    import os
    import shutil
    import tempfile

    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.models import make_gpt_train_step, params_to_numpy
    from byteps_tpu_torch.ops import launches, reset_launches

    cfg = rank_phase_cfg("train_parallel")
    t0 = time.perf_counter()
    reset_launches()
    step, params, opt = make_gpt_train_step(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    tok, tgt = parallel_batch(cfg, B, S, "cuda")
    one = timed_train(step, opt, tok, tgt, steps)
    one["launches"] = dict(launches)
    calls = steps + 1
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    ref_path = os.path.join(tmp, "one_rank.npy")
    np.save(ref_path, flat_params(opt))
    del step, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    # the roundoff control: one rank with tp = 2's row-parallel arithmetic
    step, params, _ = make_gpt_train_step(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    with split_row_parallel():
        losses = [float(step(tok, tgt)) for _ in range(calls)]
    control = {"losses": losses,
               "loss_gap": [abs(a - b) for a, b in zip(losses,
                                                       one["losses"])],
               "off_2lr": off_summary(off_2lr_by_leaf(
                   params_to_numpy(params),
                   np.load(ref_path, mmap_mode="r")))}
    del step, params
    gc.collect()
    torch.cuda.empty_cache()
    f32_one = {dev: parallel_f32_one(dev) for dev in ("cuda", "cpu")}
    try:
        per_n = {n: spawn_ranks(train_parallel_rank, n, B, S, steps,
                                ref_path,
                                {d: f32_one[d][1] for d in f32_one})
                 for n in (2, 4)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    per = get_config().partition_bytes // 4
    legs_out, failed = {}, []
    total = dict(one["launches"])
    if control["off_2lr"]["worst_share"] >= PARALLEL_OFF_SHARE:
        failed.append(("the roundoff control", control["off_2lr"]))
    for leg, n, axes, layout, ce, comp in PARALLEL_LEGS:
        rs = [r[leg] for r in per_n[n]]
        r0 = rs[0]
        losses = r0["losses"]
        gap = [abs(a - b) for a, b in zip(losses, one["losses"])]
        onebit = comp is not None
        tol = [PARALLEL_LOSS_TOL] + [PARALLEL_ONEBIT_LOSS_GAP if onebit
                                     else PARALLEL_LOSS_TOL] * steps
        off = off_summary(r0["off_2lr"])
        off_ok = (off["share"] < PARALLEL_ONEBIT_OFF_SHARE if onebit
                  else off["worst_share"] < PARALLEL_OFF_SHARE)
        sp = axes.get("sp", 1)
        per_layer = (1 if sp == 1 else 5 if layout == "zigzag" else sp)
        want = {k: calls * cfg.n_layers * per_layer for k in TRAIN}
        route = leg_routes(leg)
        want["flash_fwd_split"] = (calls * cfg.n_layers
                                   * route["split_per_layer"])
        if onebit:
            chunks = -(-r0["local_params"] // per)
            want.update(onebit_pack=calls * chunks * 3,
                        onebit_unpack_sum=calls * chunks * 5)
        if leg in RING_TIER_TWIN:
            # a collect and an all-gather a chunk over the dp line
            want["ring_rotate"] = calls * chunks * 2
        bad_launch = {k: (r0["launches"][k], v) for k, v in want.items()
                      if r0["launches"][k] != v}
        checks = {
            "falls": all(falls(r["losses"]) for r in rs),
            "loss_gap": all(g <= t for g, t in zip(gap, tol)),
            "off_2lr": off_ok,
            "rep_identical": len({r["rep_sha1"] for r in rs}) == 1,
            "same_losses": all(r["losses"] == losses for r in rs),
            "launches": not bad_launch,
            "ranks_launch_alike": all(r["launches"] == r0["launches"]
                                      for r in rs)}
        if leg in RING_TIER_TWIN:
            # losses and each rank's parameter digest: the ring moves the
            # staged tier's bits
            twin = [r[RING_TIER_TWIN[leg]] for r in per_n[n]]
            checks["bit_equal_to_staged"] = all(
                r["losses"] == t["losses"]
                and r["params_sha1"] == t["params_sha1"]
                for r, t in zip(rs, twin))
        if not all(checks.values()):
            failed.append((leg, checks, bad_launch))
        legs_out[leg] = {
            "ranks": n, "mesh": axes, "seq_layout": layout,
            "chunked_ce": ce, "compression": comp, "losses": losses,
            "one_rank_losses": one["losses"], "loss_gap": gap,
            "loss_tol": tol, "off_2lr": off,
            "off_2lr_bound": (PARALLEL_ONEBIT_OFF_SHARE, "whole")
            if onebit else (PARALLEL_OFF_SHARE, "each leaf"),
            "routes": route["routes"],
            "split_launches": r0["launches"]["flash_fwd_split"],
            "step_ms": max(r["step_ms"] for r in rs),
            "step_ms_each": [r["step_ms_each"] for r in rs],
            "vs_one_rank": max(r["step_ms"] for r in rs) / one["step_ms"],
            "warmup_s": max(r["warmup_s"] for r in rs),
            "max_memory_allocated_gb": [r["max_memory_allocated"] / 1e9
                                        for r in rs],
            "local_params": [r["local_params"] for r in rs],
            "collectives_per_step": {k: v / calls for k, v in
                                     r0["collectives"].items() if v},
            "launches": r0["launches"], "checks": checks}
        for k, v in r0["launches"].items():
            total[k] = total.get(k, 0) + v
    fault_leaf = per_n[2][0][PARALLEL_FAULT[0]]["off_2lr"]
    fault = {"leaves": {nm: fault_leaf[nm][0] / fault_leaf[nm][1]
                        for nm in PARALLEL_FAULT_LEAVES},
             **off_summary(fault_leaf)}
    fault["caught"] = fault["worst_share"] >= PARALLEL_OFF_SHARE
    fault["rep_identical"] = len({r[PARALLEL_FAULT[0]]["rep_sha1"]
                                  for r in per_n[2]}) == 1
    if not fault["caught"]:
        failed.append(("the planted fault passed the per-leaf check",
                       fault))
    f32 = {}
    for leg, axes, layout in PARALLEL_F32_LEGS:
        for dev in ("cpu", "cuda"):
            got = [r["f32"][f"{leg}_{dev}"] for r in per_n[4]]
            gap = max(abs(a - b) for g in got
                      for a, b in zip(g, f32_one[dev][0]))
            off = off_summary(per_n[4][0]["f32"][f"{leg}_{dev}_off_2lr"])
            f32[f"{leg}_{dev}"] = {"losses": got[0], "one_rank":
                                   f32_one[dev][0], "max_gap": gap,
                                   "off_2lr": off}
            if gap > PARALLEL_F32_TOL or off["worst_share"] >= \
                    PARALLEL_OFF_SHARE:
                failed.append((f"{leg}_{dev}", gap, off))
        kern = per_n[4][0]["f32"][f"{leg}_cuda_launches"]
        route = leg_routes(leg)
        want = {k: 3 * (parallel_f32_cfg().n_layers
                        * len(parallel_layer_calls(
                            parallel_f32_cfg(), *PARALLEL_F32_BATCH, axes,
                            layout)[0])) for k in TRAIN}
        want["flash_fwd_split"] = (3 * parallel_f32_cfg().n_layers
                                   * route["split_per_layer"])
        f32[f"{leg}_cuda"]["routes"] = route["routes"]
        if any(kern[k] != v for k, v in want.items()):
            failed.append((f"{leg}_cuda launches", kern, want))
    emit({"phase": "train_parallel", "card": card_name_and_limit(),
          "layers": cfg.n_layers,
          "depth_cut": "24 layers cut to keep the smoke in its limit",
          "timing": "the ranks time-slice one card", "batch": B, "seq": S,
          "steps": steps, "one_rank": {
              k: one[k] for k in ("losses", "step_ms", "warmup_s",
                                  "max_memory_allocated")},
          "off_2lr_limit_each_leaf": PARALLEL_OFF_SHARE,
          "split_matmul_control": control, "fault": fault,
          "wall_s": wall, "legs": legs_out, "f32": f32,
          "f32_tol": PARALLEL_F32_TOL, "failed": failed})
    if failed:
        raise AssertionError(f"train_parallel failed: {failed}")
    return total


# --------------------------------------------------------------------------
# phase 17: pipeline and expert parallelism, ranks that share the card
# --------------------------------------------------------------------------
# (name, ranks, mesh axes, microbatches, compression): GPT-2 medium at
# full width and depth through GPipe stages, each leg held to one_rank
# (the same global batch and seeded weights on one rank). dp2_pp2's rank
# holds 2 rows of the batch of 4, so it takes 2 microbatches of one row,
# the microbatch pp2_raw's 4 take.
PIPELINE_LEGS = (("pp2_raw", 2, {"pp": 2}, 4, None),
                 ("dp2_pp2_onebit_ef", 4, {"pp": 2, "dp": 2}, 2, ONEBIT_EF))
# the f32 parity case: the small dense model of train_parallel's f32
# case on pp2, 2 microbatches, against one rank's step on the card
PIPELINE_F32_LEGS = (("f32_pp2", 2, {"pp": 2}, 2),)
# The Switch-MoE configuration the repo benchmarks (bench.py's "moe"
# model: Switch-MoE E8 d512/L8, top-1, capacity factor 1.25, aux 0.01,
# bf16) at its batch B=8 × S=512. (name, ranks, mesh axes, microbatches):
# moe_dp2 every rank all 8 experts (the control), moe_ep2 4 experts a
# rank, moe_pp2_ep2 4 ranks, 4 layers a stage.
MOE_BATCH = (8, 512)
MOE_LEGS = (("moe_dp2", 2, {"dp": 2}, None),
            ("moe_ep2", 2, {"ep": 2}, None),
            ("moe_pp2_ep2", 4, {"pp": 2, "ep": 2}, 2))
# moe_ep2 against moe_dp2: each rank routes the same rows at the same
# capacity in both, so they differ only in where the expert products and
# their gradients are summed (over both ranks' slots in one bf16 product
# against two f32-summed per-rank products): bf16 roundoff, held as PR
# 19's layouts are (the loss each step, each leaf's share past 2·lr, the
# key bias exempt).
MOE_EP_LOSS_TOL = PARALLEL_LOSS_TOL
MOE_EP_OFF_SHARE = PARALLEL_OFF_SHARE
# moe_pp2_ep2 against moe_ep2: routing per microbatch of 2 rows (the
# capacity from 1,024 tokens) drops other tokens than routing the rank's
# 4 rows at once where capacity 1.25 binds, so after the warm-up's
# update they are different trainings, held as PR 19's onebit leg is:
# the warm-up's loss (same weights, only the drops differ) within
# MOE_PP_WARMUP_TOL, later losses within MOE_PP_LOSS_GAP, the whole
# share past 2·lr under MOE_PP_OFF_SHARE.
MOE_PP_WARMUP_TOL = 2e-2
MOE_PP_LOSS_GAP = PARALLEL_ONEBIT_LOSS_GAP
MOE_PP_OFF_SHARE = PARALLEL_ONEBIT_OFF_SHARE
# the f32 MoE parity case: a small model at a capacity that does not bind
# and no aux term (the Switch aux is a product of per-rank means, so its
# value depends on how tokens split; the nll does not), on ep2 and
# pp2×ep2, each within PARALLEL_F32_TOL of one rank's step on the card
MOE_F32_LEGS = (("f32_ep2", 2, {"ep": 2}, None),
                ("f32_pp2_ep2", 4, {"pp": 2, "ep": 2}, 2))


def moe_switch_cfg():
    from byteps_tpu_torch.models import MoEGPTConfig

    return MoEGPTConfig(vocab_size=32768, max_seq=512, d_model=512,
                        n_heads=8, n_layers=8, d_ff=2048, n_experts=8,
                        dtype=torch.bfloat16)


def moe_f32_cfg():
    from byteps_tpu_torch.models import MoEGPTConfig

    return MoEGPTConfig(vocab_size=512, max_seq=256, d_model=256,
                        n_heads=4, n_layers=2, d_ff=512, n_experts=4,
                        capacity_factor=4.0, aux_coef=0.0,
                        dtype=torch.float32)


def pipeline_paths() -> list:
    """(path, dtype, B, S, heads, head dim) of the attention calls each
    step of train_pipeline and train_moe makes (every call the whole
    causal sequence of one microbatch, no lse cotangent): one rank's, and
    each leg's microbatch."""
    from byteps_tpu_torch.models import GPTConfig

    g, f = GPTConfig.gpt2_medium(), parallel_f32_cfg()
    m, mf = moe_switch_cfg(), moe_f32_cfg()
    bf, f32 = torch.bfloat16, torch.float32
    B, S = PARALLEL_BATCH
    Bf, Sf = PARALLEL_F32_BATCH
    Bm, Sm = MOE_BATCH

    def rows(B, axes, micro, batch_axes):
        for a in batch_axes:
            B //= axes.get(a, 1)
        return B // (micro or 1)

    out = [("pipe_one_rank", bf, B, S, g.n_heads, g.head_dim)]
    out += [(leg, bf, rows(B, axes, M, ("dp",)), S, g.n_heads, g.head_dim)
            for leg, _, axes, M, _ in PIPELINE_LEGS]
    out += [(leg, f32, rows(Bf, axes, M, ("dp",)), Sf, f.n_heads,
             f.head_dim) for leg, _, axes, M in PIPELINE_F32_LEGS]
    out += [("moe_one_rank", bf, Bm, Sm, m.n_heads, m.head_dim)]
    out += [(leg, bf, rows(Bm, axes, M, ("dp", "ep")), Sm, m.n_heads,
             m.head_dim) for leg, _, axes, M in MOE_LEGS]
    out += [("f32_moe_one_rank", f32, Bf, Sf, mf.n_heads, mf.head_dim)]
    out += [(leg, f32, rows(Bf, axes, M, ("dp", "ep")), Sf, mf.n_heads,
             mf.head_dim) for leg, _, axes, M in MOE_F32_LEGS]
    return out


def pipeline_onebit_tail() -> int:
    """The tail chunk of a dp2_pp2 stage's flat gradient (its 12 layers
    and the leaves every stage holds)."""
    from byteps_tpu_torch.models import GPTConfig

    cfg = GPTConfig.gpt2_medium()
    whole = gpt_param_count(cfg)
    top = gpt_param_count(dataclasses.replace(cfg, n_layers=0))
    stage = top + (whole - top) // 2
    return stage % CHUNK


def pipeline_kernel_cases(timer) -> dict:
    """The forward, dq and dk/dv kernels at every distinct call of
    :func:`pipeline_paths`, each against its plain version under the
    cases' tolerances, timed and bounded, and onebit pack and unpack-sum
    at the dp2_pp2 leg's tail chunk (its full chunks are the "chunk"
    case's): {case: {"paths", "fwd", "bwd"}}."""
    calls = {}
    for path, dt, B, S, H, D in pipeline_paths():
        calls.setdefault((dt, B, S, H, D), []).append(path)
    out = {}
    for i, ((dt, B, S, H, D), paths) in enumerate(calls.items()):
        name = f"{paths[0]}:{B}x{S}x{H}"
        out[name] = {
            "paths": paths,
            "fwd": fwd_case(timer, name, B, S, S, H, H, D, 0, dt, 600 + i),
            "bwd": bwd_case(timer, name, B, S, S, H, H, D, 0, 0, dt,
                            700 + i)}
    out["onebit_tail"] = onebit_case(timer, "dp2_pp2_tail",
                                     pipeline_onebit_tail(), 48)
    return out


@contextlib.contextmanager
def recording_aux(store: list):
    """A context in which every MoE FFN's aux loss (this rank's, detached)
    is appended to ``store`` as it is computed."""
    from byteps_tpu_torch.models import moe_gpt

    inner = moe_gpt.moe_ffn

    def rec(*a, **kw):
        y, aux = inner(*a, **kw)
        store.append(aux.detach())
        return y, aux

    moe_gpt.moe_ffn = rec
    try:
        yield
    finally:
        moe_gpt.moe_ffn = inner


def timed_legs_step(step, opt, tok, tgt, steps, aux=None) -> dict:
    """:func:`timed_train`, and with ``aux`` (a :func:`recording_aux`
    store) the mean aux of the last step's MoE layers."""
    if aux is None:
        return timed_train(step, opt, tok, tgt, steps)
    with recording_aux(aux):
        out = timed_train(step, opt, tok, tgt, steps)
    per_step = len(aux) // (steps + 1)
    out["aux"] = float(torch.stack(aux[-per_step:]).mean())
    return out


def mesh_leg(rank, factory, cfg, axes, tok, tgt, steps, ref_path=None,
             save_path=None, aux=False, **kw) -> dict:
    """One bf16 leg on this rank: the mesh, ``factory``'s step from the
    seeded weights, one warm-up and ``steps`` timed steps; losses, times,
    peak memory, launches and collectives, the digest of the leaves
    every pp stage and ep rank holds, and on rank 0 each gathered leaf's
    distance past 2·lr from the flat parameters at ``ref_path``; rank 0
    saves its gathered parameters to ``save_path``, the next leg's
    yardstick."""
    from byteps_tpu_torch.models import params_to_numpy
    from byteps_tpu_torch.models.convert import flat_specs, param_specs
    from byteps_tpu_torch.ops import launches, reset_launches
    from byteps_tpu_torch.parallel.mesh import (MeshAxes, collectives,
                                                make_mesh,
                                                reset_collectives)
    from byteps_tpu_torch.parallel.partitioner import spec_axes

    mesh = make_mesh(MeshAxes(**axes))
    step, params, opt = factory(
        cfg, mesh, generator=torch.Generator(device="cuda").manual_seed(0),
        **kw)
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    reset_collectives()
    out = timed_legs_step(step, opt, tok, tgt, steps, [] if aux else None)
    out["launches"] = dict(launches)
    out["collectives"] = dict(collectives)
    specs = flat_specs(param_specs(cfg, mesh, params.stacked))
    rep = [p for p, s in zip(opt.params, specs)
           if not {"pp", "ep"} & set(spec_axes(s))]
    out["rep_sha1"] = params_digest(rep)
    out["coords"] = {a: mesh.axis_index(a) for a in mesh.axis_names}
    out["local_params"] = sum(p.numel() for p in opt.params)
    tree = params_to_numpy(params, mesh=mesh)
    if rank == 0 and ref_path is not None:
        out["off_2lr"] = off_2lr_by_leaf(tree, np.load(ref_path,
                                                       mmap_mode="r"))
    if rank == 0 and save_path is not None:
        np.save(save_path, np.concatenate(
            [a.ravel() for _, a in named_leaves(tree)]))
    del step, params, opt, tree
    gc.collect()
    torch.cuda.empty_cache()
    return out


def f32_leg(rank, factory, cfg, axes, init, batch, ref, steps=3,
            **kw) -> dict:
    """One f32 parity leg on the card: losses, launches, (rank 0) each
    leaf's distance past 2·lr from ``ref``."""
    from byteps_tpu_torch.models import params_to_numpy
    from byteps_tpu_torch.ops import launches, reset_launches
    from byteps_tpu_torch.parallel.mesh import MeshAxes, make_mesh

    mesh = make_mesh(MeshAxes(**axes))
    step, params, _ = factory(cfg, mesh, init_params=init().to("cuda"),
                              device="cuda", **kw)
    tok, tgt = batch
    reset_launches()
    out = {"losses": [float(step(tok.cuda(), tgt.cuda()))
                      for _ in range(steps)],
           "launches": dict(launches)}
    tree = params_to_numpy(params, mesh=mesh)
    if rank == 0:
        out["off_2lr"] = off_2lr_by_leaf(tree, ref)
    return out


def f32_init(cfg):
    """The f32 cases' seeded weights (on the CPU, then moved)."""
    from byteps_tpu_torch.models import gpt_init, moe_gpt_init

    init = moe_gpt_init if hasattr(cfg, "n_experts") else gpt_init
    return lambda: init(cfg, torch.Generator().manual_seed(0), device="cpu")


def f32_one_rank(factory, cfg, steps=3) -> tuple:
    """The f32 case's one-rank losses and flat parameters on the card."""
    step, _, opt = factory(cfg, init_params=f32_init(cfg)().to("cuda"),
                           device="cuda")
    tok, tgt = parallel_batch(cfg, *PARALLEL_F32_BATCH, "cpu")
    losses = [float(step(tok.cuda(), tgt.cuda())) for _ in range(steps)]
    return losses, flat_params(opt)


def train_pipeline_rank(rank, n, B, S, steps, ref_path, f32_ref):
    """One rank of train_pipeline: each bf16 leg of ``n`` ranks
    (:func:`mesh_leg`, held to one_rank's parameters at ``ref_path``),
    then the f32 parity leg at 2."""
    from byteps_tpu_torch.models import (GPTConfig, make_gpt_pp_train_step,
                                         synthetic_batch)

    cfg = GPTConfig.gpt2_medium()
    tok, tgt = parallel_batch(cfg, B, S, "cuda")
    res = {}
    for leg, ranks, axes, M, comp in PIPELINE_LEGS:
        if ranks == n:
            res[leg] = mesh_leg(rank, make_gpt_pp_train_step, cfg, axes,
                                tok, tgt, steps, ref_path, n_micro=M,
                                compression_params=comp)
    fc = parallel_f32_cfg()
    for leg, ranks, axes, M in PIPELINE_F32_LEGS:
        if ranks == n:
            res[leg] = f32_leg(rank, make_gpt_pp_train_step, fc, axes,
                               f32_init(fc), parallel_batch(
                                   fc, *PARALLEL_F32_BATCH, "cpu"),
                               f32_ref, n_micro=M)
    return res


def train_moe_rank(rank, n, B, S, steps, tmp, f32_ref):
    """One rank of train_moe: each bf16 leg of ``n`` ranks, held to the
    leg before it (moe_ep2 to moe_dp2, moe_pp2_ep2 to moe_ep2: rank 0
    keeps each leg's gathered parameters in ``tmp``), then the f32
    parity legs, held to one rank's (``f32_ref``)."""
    import os

    from byteps_tpu_torch.models import (make_gpt_moe_pp_train_step,
                                         make_gpt_moe_train_step)

    cfg = moe_switch_cfg()
    tok, tgt = parallel_batch(cfg, B, S, "cuda")
    res = {}
    names = [g[0] for g in MOE_LEGS]
    for i, (leg, ranks, axes, M) in enumerate(MOE_LEGS):
        if ranks == n:
            factory, kw = ((make_gpt_moe_pp_train_step, {"n_micro": M})
                           if M else (make_gpt_moe_train_step, {}))
            res[leg] = mesh_leg(
                rank, factory, cfg, axes, tok, tgt, steps,
                ref_path=(os.path.join(tmp, f"{names[i - 1]}.npy")
                          if i else None),
                save_path=(os.path.join(tmp, f"{leg}.npy")
                           if i + 1 < len(names) else None),
                aux=True, **kw)
    mc = moe_f32_cfg()
    for leg, ranks, axes, M in MOE_F32_LEGS:
        if ranks == n:
            factory, kw = ((make_gpt_moe_pp_train_step, {"n_micro": M})
                           if M else (make_gpt_moe_train_step, {}))
            res[leg] = f32_leg(rank, factory, mc, axes, f32_init(mc),
                               parallel_batch(mc, *PARALLEL_F32_BATCH,
                                              "cpu"), f32_ref, **kw)
    return res


def want_launches(calls, micro, layers, route_call) -> dict:
    """A rank's flash launches: one a layer and microbatch each way, the
    forward's split path as the library routes ``route_call``'s
    (B, S, H, D, dtype)."""
    from byteps_tpu_torch.ops.flash_attention import fwd_route

    B, S, H, D, dt = route_call
    q = torch.empty(B, S, H, D, dtype=dt, device="cuda")
    n = calls * micro * layers
    want = {k: n for k in TRAIN}
    want["flash_fwd_split"] = n if fwd_route(q, q, q) == "split" else 0
    return want


def want_collectives(calls, **per_step) -> dict:
    """Every kind of ``collectives`` at 0 but ``per_step``'s, times
    ``calls``."""
    from byteps_tpu_torch.parallel.mesh import collectives

    return {k: calls * per_step.get(k, 0) for k in collectives}


def leg_summary(rs, yard_losses, tol, off_limit, whole) -> tuple:
    """The checks every bf16 leg takes against its yardstick's losses
    (``tol`` None: the gaps reported, not held) and parameters (rank 0's
    ``off_2lr``; ``off_limit`` None: none): (summary, checks)."""
    r0 = rs[0]
    losses = r0["losses"]
    gap = [abs(a - b) for a, b in zip(losses, yard_losses)]
    checks = {
        "falls": all(falls(r["losses"]) for r in rs),
        "same_losses": all(r["losses"] == losses for r in rs),
        "ranks_launch_alike": all(r["launches"] == r0["launches"]
                                  for r in rs)}
    if tol is not None:
        checks["loss_gap"] = all(g <= t for g, t in zip(gap, tol))
    off = None
    if off_limit is not None:
        off = off_summary(r0["off_2lr"])
        checks["off_2lr"] = ((off["share"] if whole
                              else off["worst_share"]) < off_limit)
    return {"losses": losses, "yardstick_losses": yard_losses,
            "loss_gap": gap, "loss_tol": tol, "off_2lr": off,
            "off_2lr_bound": (off_limit, "whole" if whole else "each leaf"),
            "step_ms": max(r["step_ms"] for r in rs),
            "step_ms_each": [r["step_ms_each"] for r in rs],
            "warmup_s": max(r["warmup_s"] for r in rs),
            "max_memory_allocated_gb": [r["max_memory_allocated"] / 1e9
                                        for r in rs],
            "local_params": [r["local_params"] for r in rs],
            "launches": r0["launches"]}, checks


def exact(got, want) -> dict:
    """{kind: (got, want)} where they differ."""
    return {k: (got.get(k, 0), v) for k, v in want.items()
            if got.get(k, 0) != v}


def phase_train_pipeline(B=PARALLEL_BATCH[0], S=PARALLEL_BATCH[1],
                         steps=1) -> dict:
    """GPT-2 medium at full width and depth through GPipe stages on meshes
    of rank processes that time-slice the card (``spawn``, gloo), bf16
    over f32 master weights, AdamW(1e-3), the global batch B=4 × S=1024
    and one_rank's seeded weights (one_rank: the same step on one rank,
    in this process, the yardstick), one warm-up and ``steps`` timed
    steps a leg: pp2_raw (12 layers a stage, 4 microbatches of one row)
    and dp2_pp2_onebit_ef (onebit + EF over dp, 2 microbatches of one
    row). pp2_raw: each step's loss within PARALLEL_LOSS_TOL of
    one_rank's, each gathered leaf's share past 2·lr under
    PARALLEL_OFF_SHARE (the key bias exempt), the leaves both stages
    hold bit-identical on every rank. dp2_pp2_onebit_ef: PR 19's onebit
    limits (the warm-up's loss within PARALLEL_LOSS_TOL, then
    PARALLEL_ONEBIT_LOSS_GAP; the whole share past 2·lr under
    PARALLEL_ONEBIT_OFF_SHARE), those leaves identical within each
    stage. Exact launches (the flash kernels once a layer and
    microbatch each way on a stage's 12 layers; onebit pack 3 and
    unpack-sum 5 times a chunk and step) and collectives (M + S − 2
    shifts each way and one pp gradient sum a step). Then the f32 parity
    case: train_parallel's small model on pp2 (2 microbatches), three
    steps on the card, within PARALLEL_F32_TOL of one rank's. Returns
    one rank's launch counts a leg and one_rank's, summed."""
    import os
    import shutil
    import tempfile

    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.models import GPTConfig, make_gpt_train_step
    from byteps_tpu_torch.ops import launches, reset_launches

    cfg = GPTConfig.gpt2_medium()
    t0 = time.perf_counter()
    reset_launches()
    step, params, opt = make_gpt_train_step(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    tok, tgt = parallel_batch(cfg, B, S, "cuda")
    one = timed_train(step, opt, tok, tgt, steps)
    one["launches"] = dict(launches)
    calls = steps + 1
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    ref_path = os.path.join(tmp, "one_rank.npy")
    np.save(ref_path, flat_params(opt))
    del step, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    f32_one = f32_one_rank(make_gpt_train_step, parallel_f32_cfg())
    try:
        per_n = {n: spawn_ranks(train_pipeline_rank, n, B, S, steps,
                                ref_path, f32_one[1]) for n in (2, 4)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    per = get_config().partition_bytes // 4
    legs_out, failed = {}, []
    total = dict(one["launches"])
    for leg, n, axes, M, comp in PIPELINE_LEGS:
        rs = [r[leg] for r in per_n[n]]
        onebit = comp is not None
        tol = [PARALLEL_LOSS_TOL] + [PARALLEL_ONEBIT_LOSS_GAP if onebit
                                     else PARALLEL_LOSS_TOL] * steps
        out, checks = leg_summary(
            rs, one["losses"], tol, PARALLEL_ONEBIT_OFF_SHARE if onebit
            else PARALLEL_OFF_SHARE, onebit)
        pp = axes["pp"]
        want = want_launches(calls, M, cfg.n_layers // pp,
                             (B // axes.get("dp", 1) // M, S, cfg.n_heads,
                              cfg.head_dim, torch.bfloat16))
        if onebit:
            chunks = -(-rs[0]["local_params"] // per)
            want.update(onebit_pack=calls * chunks * 3,
                        onebit_unpack_sum=calls * chunks * 5)
        wcoll = want_collectives(calls, pp_shift_fwd=M + pp - 2,
                                 pp_shift_bwd=M + pp - 2, pp_grad_sum=1)
        checks["launches"] = not exact(rs[0]["launches"], want)
        checks["collectives"] = not exact(rs[0]["collectives"], wcoll)
        # the leaves every stage holds: the same bits on every rank, or
        # under onebit within each stage (each stage's chunk scales are
        # its own)
        groups = ([list(range(n))] if not onebit else
                  [[i for i, r in enumerate(rs) if r["coords"]["pp"] == s]
                   for s in range(pp)])
        checks["rep_identical"] = all(
            len({rs[i]["rep_sha1"] for i in g}) == 1 for g in groups)
        if not all(checks.values()):
            failed.append((leg, checks, exact(rs[0]["launches"], want),
                           exact(rs[0]["collectives"], wcoll)))
        legs_out[leg] = {
            "ranks": n, "mesh": axes, "n_micro": M, "compression": comp,
            **out, "vs_one_rank": out["step_ms"] / one["step_ms"],
            "collectives_per_step": {k: v / calls for k, v in
                                     rs[0]["collectives"].items() if v},
            "checks": checks}
        for k, v in rs[0]["launches"].items():
            total[k] = total.get(k, 0) + v
    f32 = {}
    fc = parallel_f32_cfg()
    for leg, n, axes, M in PIPELINE_F32_LEGS:
        got = [r[leg]["losses"] for r in per_n[n]]
        gap = max(abs(a - b) for g in got for a, b in zip(g, f32_one[0]))
        off = off_summary(per_n[n][0][leg]["off_2lr"])
        want = want_launches(3, M, fc.n_layers // axes["pp"],
                             (PARALLEL_F32_BATCH[0] // M,
                              PARALLEL_F32_BATCH[1], fc.n_heads,
                              fc.head_dim, torch.float32))
        bad = exact(per_n[n][0][leg]["launches"], want)
        f32[leg] = {"losses": got[0], "one_rank": f32_one[0],
                    "max_gap": gap, "off_2lr": off, "launches_off": bad}
        if (gap > PARALLEL_F32_TOL or bad
                or off["worst_share"] >= PARALLEL_OFF_SHARE):
            failed.append((leg, gap, off, bad))
    emit({"phase": "train_pipeline", "card": card_name_and_limit(),
          "timing": "the ranks time-slice one card", "batch": B, "seq": S,
          "layers": cfg.n_layers, "steps": steps, "one_rank": {
              k: one[k] for k in ("losses", "step_ms", "warmup_s",
                                  "max_memory_allocated")},
          "wall_s": wall, "legs": legs_out, "f32": f32,
          "f32_tol": PARALLEL_F32_TOL, "failed": failed})
    if failed:
        raise AssertionError(f"train_pipeline failed: {failed}")
    return total


def phase_train_moe(B=MOE_BATCH[0], S=MOE_BATCH[1], steps=1) -> dict:
    """The repo's Switch-MoE configuration (:func:`moe_switch_cfg`) at
    B=8 × S=512, bf16 over f32 master weights, AdamW(1e-3), seeded
    weights, one warm-up and ``steps`` timed steps a leg: moe_one_rank
    (no mesh, in this process), then on rank processes that time-slice
    the card moe_dp2 (every rank all 8 experts: the control), moe_ep2
    (4 experts a rank; held to moe_dp2 within MOE_EP_LOSS_TOL each step
    and MOE_EP_OFF_SHARE a leaf past 2·lr, the key bias exempt) and
    moe_pp2_ep2 (4 ranks, 2 microbatches; held to moe_ep2: the warm-up
    within MOE_PP_WARMUP_TOL, then MOE_PP_LOSS_GAP, the whole share past
    2·lr under MOE_PP_OFF_SHARE). Every leg: losses finite and falling,
    the leaves no pp or ep axis splits bit-identical on every rank,
    exact launches (the flash kernels once a layer and microbatch each
    way) and collectives (two exchanges over ep a layer and microbatch
    each way, one ep gradient sum a step; pp: M + S − 2 shifts each way
    and one pp gradient sum). Each leg reports ms a step (the slower
    rank), peak memory a rank and the mean aux loss of its last step's
    MoE layers. Then the f32 parity case (:func:`moe_f32_cfg`: capacity
    not binding, no aux) on ep2 and pp2×ep2 within PARALLEL_F32_TOL of
    one rank's step on the card. Returns one rank's launch counts a leg
    and moe_one_rank's, summed."""
    import shutil
    import tempfile

    from byteps_tpu_torch.models import make_gpt_moe_train_step
    from byteps_tpu_torch.ops import launches, reset_launches

    cfg = moe_switch_cfg()
    t0 = time.perf_counter()
    reset_launches()
    step, params, opt = make_gpt_moe_train_step(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    tok, tgt = parallel_batch(cfg, B, S, "cuda")
    one = timed_legs_step(step, opt, tok, tgt, steps, [])
    one["launches"] = dict(launches)
    calls = steps + 1
    del step, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    f32_one = f32_one_rank(make_gpt_moe_train_step, moe_f32_cfg())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    try:
        per_n = {n: spawn_ranks(train_moe_rank, n, B, S, steps, tmp,
                                f32_one[1]) for n in (2, 4)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    legs_out, failed = {}, []
    total = dict(one["launches"])
    want_one = want_launches(calls, 1, cfg.n_layers,
                             (B, S, cfg.n_heads, cfg.head_dim,
                              torch.bfloat16))
    if exact(one["launches"], want_one) or not falls(one["losses"]):
        failed.append(("moe_one_rank", one["losses"],
                       exact(one["launches"], want_one)))
    prev = None
    for leg, n, axes, M in MOE_LEGS:
        rs = [r[leg] for r in per_n[n]]
        ep, pp, micro = axes.get("ep", 1), axes.get("pp", 1), M or 1
        if prev is None:
            # the control: its rows route at another capacity than
            # moe_one_rank's, so its gaps to it are reported, not held
            yard, tol, limit, whole = one["losses"], None, None, False
        elif pp == 1:
            yard = legs_out[prev]["losses"]
            tol, limit, whole = ([MOE_EP_LOSS_TOL] * calls,
                                 MOE_EP_OFF_SHARE, False)
        else:
            yard = legs_out[prev]["losses"]
            tol, limit, whole = ([MOE_PP_WARMUP_TOL]
                                 + [MOE_PP_LOSS_GAP] * steps,
                                 MOE_PP_OFF_SHARE, True)
        out, checks = leg_summary(rs, yard, tol, limit, whole)
        rows = B // axes.get("dp", 1) // ep // micro
        want = want_launches(calls, micro, cfg.n_layers // pp,
                             (rows, S, cfg.n_heads, cfg.head_dim,
                              torch.bfloat16))
        per_step = {}
        if ep > 1:
            a2a = 2 * micro * cfg.n_layers // pp
            per_step.update(ep_all_to_all_fwd=a2a, ep_all_to_all_bwd=a2a,
                            ep_grad_sum=1)
        if pp > 1:
            per_step.update(pp_shift_fwd=micro + pp - 2,
                            pp_shift_bwd=micro + pp - 2, pp_grad_sum=1)
        wcoll = want_collectives(calls, **per_step)
        checks["launches"] = not exact(rs[0]["launches"], want)
        checks["collectives"] = not exact(rs[0]["collectives"], wcoll)
        checks["rep_identical"] = len({r["rep_sha1"] for r in rs}) == 1
        if not all(checks.values()):
            failed.append((leg, checks, exact(rs[0]["launches"], want),
                           exact(rs[0]["collectives"], wcoll)))
        legs_out[leg] = {
            "ranks": n, "mesh": axes, "n_micro": M, "held_to": prev,
            **out, "aux": [r["aux"] for r in rs],
            "vs_one_rank": out["step_ms"] / one["step_ms"],
            "collectives_per_step": {k: v / calls for k, v in
                                     rs[0]["collectives"].items() if v},
            "checks": checks}
        for k, v in rs[0]["launches"].items():
            total[k] = total.get(k, 0) + v
        prev = leg
    f32 = {}
    mc = moe_f32_cfg()
    for leg, n, axes, M in MOE_F32_LEGS:
        micro, pp = M or 1, axes.get("pp", 1)
        got = [r[leg]["losses"] for r in per_n[n]]
        gap = max(abs(a - b) for g in got for a, b in zip(g, f32_one[0]))
        off = off_summary(per_n[n][0][leg]["off_2lr"])
        rows = PARALLEL_F32_BATCH[0] // axes.get("ep", 1) // micro
        want = want_launches(3, micro, mc.n_layers // pp,
                             (rows, PARALLEL_F32_BATCH[1], mc.n_heads,
                              mc.head_dim, torch.float32))
        bad = exact(per_n[n][0][leg]["launches"], want)
        f32[leg] = {"losses": got[0], "one_rank": f32_one[0],
                    "max_gap": gap, "off_2lr": off, "launches_off": bad}
        if (gap > PARALLEL_F32_TOL or bad
                or off["worst_share"] >= PARALLEL_OFF_SHARE):
            failed.append((leg, gap, off, bad))
    emit({"phase": "train_moe", "card": card_name_and_limit(),
          "timing": "the ranks time-slice one card", "batch": B, "seq": S,
          "config": {k: getattr(cfg, k) for k in (
              "vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
              "n_experts", "capacity_factor", "aux_coef", "router_topk")},
          "steps": steps, "moe_one_rank": {
              k: one[k] for k in ("losses", "step_ms", "warmup_s",
                                  "max_memory_allocated", "aux")},
          "limits": {"ep_loss": MOE_EP_LOSS_TOL,
                     "ep_off_2lr_each_leaf": MOE_EP_OFF_SHARE,
                     "pp_warmup": MOE_PP_WARMUP_TOL,
                     "pp_loss": MOE_PP_LOSS_GAP,
                     "pp_off_2lr_whole": MOE_PP_OFF_SHARE},
          "wall_s": wall, "legs": legs_out, "f32": f32,
          "f32_tol": PARALLEL_F32_TOL, "failed": failed})
    if failed:
        raise AssertionError(f"train_moe failed: {failed}")
    return total


# --------------------------------------------------------------------------
# phase 18: the multi-slice tier, ZeRO-3 and ZeRO-1 over a dp subgroup
# --------------------------------------------------------------------------
# GPT-2 medium at full width and 12 layers, four rank processes
# time-slicing the card over gloo, bf16 over f32 master weights, AdamW(1e-3), the
# seeded weights, one global batch of B=8 × S=1024 for every leg (2 rows
# a worker on the data legs), one warm-up and one timed step a leg.
# (name, mesh axes, make_gpt_train_step keywords)
MULTISLICE_BATCH = (8, 1024)
MULTISLICE_LEGS = (
    ("dp4_raw", {"dp": 4}, {}),
    ("slice2_dp2_raw", {"slice_": 2, "dp": 2}, {}),
    ("slice2_dp2_onebit_ef", {"slice_": 2, "dp": 2},
     {"compression_params": ONEBIT_EF}),
    # the hierarchical leg's onebit exchange on the ring tier over slice_
    ("slice2_dp2_onebit_ef_ring", {"slice_": 2, "dp": 2},
     {"compression_params": ONEBIT_EF}),
    ("slice2_dp2_zero3", {"slice_": 2, "dp": 2},
     {"zero_3": True, "remat": True}),
    ("dp2_tp2_raw", {"dp": 2, "tp": 2}, {}),
    ("dp2_tp2_zero1", {"dp": 2, "tp": 2}, {"zero_1": True}))
# The limits, stated before the first run. slice2_dp2_raw against dp4_raw
# and dp2_tp2_zero1 against dp2_tp2_raw: bit-equal (losses and each
# rank's parameter digest: the joined (slice_, dp) group sums the same
# four gradients in one all-reduce over the whole job; ZeRO-1's
# scatter adds the same two dp terms as the all-reduce and AdamW is
# elementwise). slice2_dp2_onebit_ef against dp4_raw: the warm-up's
# loss bit-equal (the same weights, nothing aggregated yet), the timed
# step's within PARALLEL_ONEBIT_LOSS_GAP (train_pipeline's onebit
# limit). The ZeRO-3 leg against slice2_dp2_raw: the warm-up's loss
# bit-equal (the same forward on gathered copies of the same f32
# weights), the timed
# step's within MULTISLICE_ZERO3_LOSS_TOL: its gradient is the same sum
# of the same four per-worker gradients in another order (a scatter over
# slice_, then a sum over dp), f32 roundoff that AdamW's first step
# turns into a sign flip only where a gradient is near zero.
MULTISLICE_ZERO3_LOSS_TOL = 1e-3
# slice2_dp2_onebit_ef_ring against slice2_dp2_onebit_ef: bit-equal (losses
# and each rank's parameter digest): the ring moves the staged tier's
# payload bits over the slice_ line, and onebit's owner sum decodes them
# in the same order.


def multislice_zero3_bytes(cfg) -> int:
    """ZeRO-3's persistent bytes a rank at n_shard = 2: the segments and
    AdamW's two moments, 3 · 4 · (ceil(rest / 2) + L · ceil(block / 2));
    2,129,227,776 at GPT-2 medium's 24 layers."""
    d, ff = cfg.d_model, cfg.d_ff
    rest = cfg.vocab_size * d + cfg.max_seq * d + 2 * d
    block = 4 * d * d + 2 * d * ff + 9 * d + ff
    return 3 * 4 * (-(-rest // 2) + cfg.n_layers * -(-block // 2))


def multislice_ef(cfg) -> int:
    """The hierarchical leg's EF residual a rank, f32: ceil(P / 2) of the
    model's P parameters (177,435,648 at 24 layers)."""
    return -(-gpt_param_count(cfg) // 2)


def multislice_onebit_case(timer, name, n, seed) -> dict:
    """Onebit pack and unpack-sum at K = 1 and 2 (the hierarchical path's
    exchange over two slices: the owner's sum of two payloads, and each
    row decoded) at one segment length, bit-equal to the plain versions,
    timed and bounded."""
    from byteps_tpu_torch.ops.onebit_kernels import (
        _pack_torch, _unpack_sum_torch, onebit_pack, onebit_unpack_sum,
        packed_words)

    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = [torch.randn(n, generator=g, device="cuda") for _ in range(2)]
    L = packed_words(n)
    words = torch.stack([onebit_pack(x) for x in xs])
    if not torch.equal(words, torch.stack([_pack_torch(x) for x in xs])):
        raise AssertionError(f"onebit pack {name}: words differ from the "
                             "plain version")
    res = {"case": name, "n": n, "words": L, "pack_max_abs_err": 0.0,
           "pack_ms": timer(lambda: onebit_pack(xs[0])),
           "pack_plain_ms": timer(lambda: _pack_torch(xs[0]))}
    res["pack_bound_ms"], res["pack_bound_by"] = bound_ms(
        4 * n + 4 * L, 32 * L, torch.float32)
    sc = torch.rand(2, generator=g, device="cuda")
    for K in (1, 2):
        out = onebit_unpack_sum(words[:K], sc[:K], n)
        ref = _unpack_sum_torch(words[:K], sc[:K], n)
        if not bits_equal(out, ref):
            raise AssertionError(f"onebit unpack_sum {name} K={K}: differs "
                                 "from the plain version")
        res[f"unpack_k{K}_max_abs_err"] = float((out - ref).abs().max())
        res[f"unpack_k{K}_ms"] = timer(
            lambda: onebit_unpack_sum(words[:K], sc[:K], n))
        res[f"unpack_k{K}_plain_ms"] = timer(
            lambda: _unpack_sum_torch(words[:K], sc[:K], n))
        res[f"unpack_k{K}_bound_ms"], res[f"unpack_k{K}_bound_by"] = \
            bound_ms(4 * K * L + 4 * K + 4 * n, 2 * K * n, torch.float32)
    emit({"phase": "onebit", **res})
    return res


def multislice_kernel_cases(timer) -> dict:
    """The kernels at train_multislice's calls, each against its plain
    version, timed and bounded: the flash forward, dq and dk/dv at a data
    worker's 2 rows (16 heads) and at a dp2×tp2 rank's 4 rows (8 heads),
    and onebit at the hierarchical leg's exchange, per chunk of its dp
    segment over two slices: the full chunk's half (512,000) and the tail
    chunk's (141,824)."""
    from byteps_tpu_torch.common.config import get_config

    cfg = rank_phase_cfg("train_multislice")
    B, S = MULTISLICE_BATCH
    out = {}
    for i, (name, rows, heads) in enumerate((
            ("worker", B // 4, cfg.n_heads),
            ("dp2_tp2", B // 2, cfg.n_heads // 2))):
        nm = f"multislice_{name}:{rows}x{S}x{heads}"
        out[nm] = {
            "paths": ["train_multislice"],
            "fwd": fwd_case(timer, nm, rows, S, S, heads, heads,
                            cfg.head_dim, 0, torch.bfloat16, 900 + i),
            "bwd": bwd_case(timer, nm, rows, S, S, heads, heads,
                            cfg.head_dim, 0, 0, torch.bfloat16, 910 + i)}
    per = get_config().partition_bytes // 4
    tail = multislice_ef(cfg) % per
    out["onebit_chunk"] = multislice_onebit_case(
        timer, "hier_chunk_half", -(-per // 2), 920)
    out["onebit_tail"] = multislice_onebit_case(
        timer, "hier_tail_half", -(-tail // 2), 921)
    return out


def train_multislice_rank(rank, n, B, S, steps):
    """One rank of train_multislice: each leg's mesh and step from the
    seeded weights, one warm-up and ``steps`` timed steps on the global
    batch; losses, step times, peak memory, launch and collective
    counts, a digest of this rank's parameters (its segments under
    ZeRO-3), its persistent state's bytes and its EF length."""
    from byteps_tpu_torch.models import make_gpt_train_step
    from byteps_tpu_torch.ops import launches, reset_launches
    from byteps_tpu_torch.parallel.mesh import (MeshAxes, collectives,
                                                make_mesh,
                                                reset_collectives)
    from byteps_tpu_torch.parallel.zero3 import state_bytes

    cfg = rank_phase_cfg("train_multislice")
    tok, tgt = parallel_batch(cfg, B, S, "cuda")
    res = {}
    for leg, axes, kw in MULTISLICE_LEGS:
        mesh = make_mesh(MeshAxes(**axes))
        step, params, opt = make_gpt_train_step(
            cfg, generator=torch.Generator(device="cuda").manual_seed(0),
            mesh=mesh, **kw)
        zero3 = kw.get("zero_3", False)
        leaves = [params["rest"], *params["blocks"]] if zero3 else opt.params
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        reset_collectives()
        losses, times = [], []
        with ici_tier("ring" if leg in RING_TIER_TWIN else None):
            for _ in range(steps + 1):
                t0 = time.perf_counter()
                losses.append(float(step(tok, tgt)))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        close_rings(mesh)
        out = {"losses": losses, "warmup_s": times[0],
               "step_ms": sum(times[1:]) / steps * 1e3,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches": dict(launches), "collectives": dict(collectives),
               "params_sha1": params_digest(leaves),
               "coords": {a: mesh.axis_index(a) for a in mesh.axis_names}}
        if zero3:
            out["state_bytes"] = state_bytes(params, opt)
        else:
            out["state_bytes"] = opt.moment_bytes() + sum(
                p.numel() * p.element_size() for p in opt.params)
            out["ef_numel"] = 0 if opt.ef is None else opt.ef.numel()
        res[leg] = out
        del step, params, opt, leaves
        gc.collect()
        torch.cuda.empty_cache()
    return res


def phase_train_multislice(B=MULTISLICE_BATCH[0], S=MULTISLICE_BATCH[1],
                           steps=1) -> dict:
    """The multi-slice tier, ZeRO-3 and ZeRO-1 over a dp subgroup on four
    rank processes that time-slice the card (:data:`MULTISLICE_LEGS`),
    GPT-2 medium at full width and 12 of its 24 layers
    (:data:`RANK_PHASE_LAYERS`): dp4_raw; slice2_dp2_raw (the joined
    (slice_, dp) group, bit-equal to dp4_raw); slice2_dp2_onebit_ef (the
    hierarchical path: raw reduce-scatter over dp, onebit + EF over
    slice_ per chunk of the dp segment, all-gather over dp; EF exactly
    :func:`multislice_ef` f32 a rank); slice2_dp2_onebit_ef_ring (the same
    on the ring tier over the slice_ line: two rotate calls a chunk,
    bit-equal to it); slice2_dp2_zero3 (ZeRO-3 over slice_ with remat:
    persistent state exactly :func:`multislice_zero3_bytes` a rank, peak
    memory below slice2_dp2_raw's); dp2_tp2_raw and dp2_tp2_zero1 (ZeRO-1
    over the dp line, bit-equal to it). Every leg: losses finite and falling, the
    same on every rank, the limits stated at MULTISLICE_LEGS, exact
    launches (the flash kernels once a layer and step, the forward twice
    under ZeRO-3's remat; onebit pack 3 and unpack-sum 5 times a chunk of
    the dp segment and step) and collectives (the hierarchical leg one dp
    reduce-scatter and one dp all-gather a step; ZeRO-3 25 forward
    gathers, 24 backward gathers, 25 reduce-scatters over slice_ and one
    sum over dp a step; the tp legs the same tp sums); ms a step (the
    slower rank), peak memory a rank. Returns rank 0's launch counts,
    summed over the legs."""
    from byteps_tpu_torch.common.config import get_config

    cfg = rank_phase_cfg("train_multislice")
    L = cfg.n_layers
    ms_ef, ms_z3 = multislice_ef(cfg), multislice_zero3_bytes(cfg)
    t0 = time.perf_counter()
    ranks = spawn_ranks(train_multislice_rank, 4, B, S, steps)
    wall = time.perf_counter() - t0
    calls = steps + 1
    per = get_config().partition_bytes // 4
    legs = {leg: [r[leg] for r in ranks] for leg, _, _ in MULTISLICE_LEGS}
    out, failed, total = {}, [], {}
    for leg, axes, kw in MULTISLICE_LEGS:
        rs = legs[leg]
        r0 = rs[0]
        rows = B // (axes.get("slice_", 1) * axes.get("dp", 1))
        heads = cfg.n_heads // axes.get("tp", 1)
        want = want_launches(calls, 1, L, (rows, S, heads, cfg.head_dim,
                                           torch.bfloat16))
        per_step = {}
        if kw.get("zero_3"):
            want["flash_fwd"] *= 2
            want["flash_fwd_split"] *= 2
            per_step = {"zero3_gather_fwd": L + 1, "zero3_gather_bwd": L,
                        "zero3_reduce_scatter": L + 1, "zero3_grad_sum": 1}
        if "compression_params" in kw:
            chunks = -(-r0["ef_numel"] // per)
            want.update(onebit_pack=calls * chunks * 3,
                        onebit_unpack_sum=calls * chunks * 5)
            if leg in RING_TIER_TWIN:
                # a collect and an all-gather a chunk over slice_
                want["ring_rotate"] = calls * chunks * 2
            per_step = {"hier_dp_reduce_scatter": 1, "hier_dp_all_gather": 1}
        checks = {
            "falls": all(falls(r["losses"]) for r in rs),
            "same_losses": all(r["losses"] == r0["losses"] for r in rs),
            "ranks_launch_alike": all(r["launches"] == r0["launches"]
                                      for r in rs),
            "launches": not exact(r0["launches"], want)}
        if "tp" not in axes:
            checks["collectives"] = not exact(
                r0["collectives"], want_collectives(calls, **per_step))
        out[leg] = {
            "mesh": axes, "options": {k: v for k, v in kw.items()
                                      if k != "compression_params"},
            "compression": kw.get("compression_params"),
            "losses": r0["losses"],
            "step_ms": max(r["step_ms"] for r in rs),
            "step_ms_each": [r["step_ms"] for r in rs],
            "warmup_s": max(r["warmup_s"] for r in rs),
            "max_memory_allocated_gb": [r["max_memory_allocated"] / 1e9
                                        for r in rs],
            "state_bytes": [r["state_bytes"] for r in rs],
            "ef_numel": r0.get("ef_numel"),
            "collectives_per_step": {k: v / calls for k, v in
                                     r0["collectives"].items() if v},
            "launches": r0["launches"], "checks": checks}
        for k, v in r0["launches"].items():
            total[k] = total.get(k, 0) + v

    def same(a, b, key):
        return all(x[key] == y[key] for x, y in zip(legs[a], legs[b]))

    dp4, s2, ob, z3 = (legs["dp4_raw"][0], legs["slice2_dp2_raw"][0],
                       legs["slice2_dp2_onebit_ef"][0],
                       legs["slice2_dp2_zero3"][0])
    ob_gap = [abs(a - b) for a, b in zip(ob["losses"], dp4["losses"])]
    z3_gap = [abs(a - b) for a, b in zip(z3["losses"], s2["losses"])]
    pairs = {
        "slice2_dp2_raw": {
            "bit_equal_to_dp4_raw": (same("slice2_dp2_raw", "dp4_raw",
                                          "losses")
                                     and same("slice2_dp2_raw", "dp4_raw",
                                              "params_sha1"))},
        "dp2_tp2_zero1": {
            "bit_equal_to_dp2_tp2_raw": (
                same("dp2_tp2_zero1", "dp2_tp2_raw", "losses")
                and same("dp2_tp2_zero1", "dp2_tp2_raw", "params_sha1")),
            "collectives_of_dp2_tp2_raw": same("dp2_tp2_zero1",
                                               "dp2_tp2_raw",
                                               "collectives")},
        "slice2_dp2_onebit_ef_ring": {
            "bit_equal_to_slice2_dp2_onebit_ef": (
                same("slice2_dp2_onebit_ef_ring", "slice2_dp2_onebit_ef",
                     "losses")
                and same("slice2_dp2_onebit_ef_ring", "slice2_dp2_onebit_ef",
                         "params_sha1"))},
        "slice2_dp2_onebit_ef": {
            "ef_numel": all(r["ef_numel"] == ms_ef
                            for r in legs["slice2_dp2_onebit_ef"]),
            "warmup_bit_equal_to_dp4_raw": (ob["losses"][0]
                                            == dp4["losses"][0]),
            "loss_gap": all(g <= PARALLEL_ONEBIT_LOSS_GAP
                            for g in ob_gap[1:])},
        "slice2_dp2_zero3": {
            "state_bytes": all(r["state_bytes"] == ms_z3
                               for r in legs["slice2_dp2_zero3"]),
            "peak_below_slice2_dp2_raw": (
                max(r["max_memory_allocated"]
                    for r in legs["slice2_dp2_zero3"])
                < min(r["max_memory_allocated"]
                      for r in legs["slice2_dp2_raw"])),
            "warmup_bit_equal_to_slice2_dp2_raw": (z3["losses"][0]
                                                   == s2["losses"][0]),
            "loss_gap": all(g <= MULTISLICE_ZERO3_LOSS_TOL
                            for g in z3_gap[1:])}}
    out["slice2_dp2_onebit_ef"]["loss_gap_to_dp4_raw"] = ob_gap
    out["slice2_dp2_zero3"]["loss_gap_to_slice2_dp2_raw"] = z3_gap
    for leg, checks in pairs.items():
        out[leg]["checks"].update(checks)
    for leg, o in out.items():
        if not all(o["checks"].values()):
            failed.append((leg, o["checks"]))
    emit({"phase": "train_multislice", "card": card_name_and_limit(),
          "timing": "four ranks time-slice one card", "batch": B, "seq": S,
          "layers": L, "depth_cut": "24 layers cut to 12 to keep the smoke "
                                    "in its limit",
          "steps": steps,
          "limits": {"onebit_loss_gap": PARALLEL_ONEBIT_LOSS_GAP,
                     "zero3_loss_gap": MULTISLICE_ZERO3_LOSS_TOL,
                     "zero3_state_bytes": ms_z3,
                     "hier_ef_numel": ms_ef},
          "wall_s": wall, "legs": out, "failed": failed})
    if failed:
        raise AssertionError(f"train_multislice failed: {failed}")
    return total


# --------------------------------------------------------------------------
# phase 19: sharded decode (tp and ep in generate and serve), ranks that
# share the card
# --------------------------------------------------------------------------
# the bf16 generate legs' (B, T0, max_new): GPT-2 medium at full width and
# all 24 layers, and the MoE model of bench.py's "moe" (uncut)
SHARDED_GEN = (4, 128, 32)
# the f32 legs' on the repo's tiny configs (64 positions)
SHARDED_TINY = (4, 24, 24)
# (leg, mesh, model, options), every leg on the one 4-rank job: beside a
# tp2 or an ep2 axis the mesh has a dp axis, whose two lines each run the
# leg ("one_line": GPT-2 medium's, only the first line runs it, the other
# waits, so the pair has the card to itself). bf16 legs: the first step's logits within TOL of one rank's (this
# process, the same seeded weights), and the ranks of a tp line emit the
# same tokens; f32 legs (the tiny configs): every rank's greedy tokens
# equal one rank's exactly; serve legs: the Scheduler over tp, every
# request's tokens the same on the ranks of a tp line (bf16) or equal to
# one rank's Scheduler (f32), no block leaked.
SHARDED_LEGS = (
    ("gpt2m_tp2", {"dp": 2, "tp": 2}, "gpt2m", {"one_line": True}),
    ("moe_ep2", {"dp": 2, "ep": 2}, "moe", {}),
    ("moe_ep2_tp2", {"ep": 2, "tp": 2}, "moe", {}),
    ("tiny_tp2", {"dp": 2, "tp": 2}, "tiny", {}),
    ("tiny_tp2_quant", {"dp": 2, "tp": 2}, "tiny", {"quant_cache": True}),
    ("tiny_tp2_lora", {"dp": 2, "tp": 2}, "tiny", {"lora": True}),
    ("moe_tiny_ep2_tp2", {"ep": 2, "tp": 2}, "moe_tiny", {}),
    ("gpt2m_serve_tp2", {"dp": 2, "tp": 2}, "gpt2m",
     {"serve": True, "one_line": True}),
    ("tiny_serve_tp2", {"dp": 2, "tp": 2}, "tiny", {"serve": True}))
# the grafted adapter of the LoRA leg (rank LORA_TP_RANK, b nonzero)
SHARDED_LORA_TARGETS = ("wq", "wv", "wo", "w2")
# the tiny serve leg's pool: 3 rows, blocks of 8, 8 usable blocks, chunks
# of 8, so chunked prefill and preemption both happen
SHARDED_TINY_SCHED = {"max_batch": 3, "block_size": 8, "pool_blocks": 9,
                      "prefill_chunk": 8}
SHARDED_SERVE_NEW = 8
# filled by phase_sharded_decode: rank 0's rotate and presum cases over
# its dp line, for the kernels line
SHARDED_RING = {}


def sharded_model(kind):
    """(cfg, whole seeded parameters on the card) of a sharded_decode
    model: the same weights in every process."""
    from byteps_tpu_torch.models import (GPTConfig, MoEGPTConfig, gpt_init,
                                         moe_gpt_init)

    cfg = {"gpt2m": GPTConfig.gpt2_medium, "moe": moe_switch_cfg,
           "tiny": GPTConfig.tiny, "moe_tiny": MoEGPTConfig.tiny}[kind]()
    init = moe_gpt_init if kind.startswith("moe") else gpt_init
    return cfg, init(cfg, torch.Generator(device="cuda").manual_seed(0))


def sharded_adapters(cfg) -> dict:
    """The LoRA leg's adapter tree (numpy, whole): ``lora_init``'s a and
    a nonzero b, from a seeded generator on the card."""
    from byteps_tpu_torch.models.convert import adapters_to_numpy
    from byteps_tpu_torch.models.lora import lora_init

    g = torch.Generator(device="cuda").manual_seed(7)
    ad = lora_init(cfg, LORA_TP_RANK, SHARDED_LORA_TARGETS, generator=g)
    for blk in ad["blocks"]:
        for ab in blk.values():
            ab["b"] = 0.1 * torch.randn(ab["b"].shape, generator=g,
                                        device="cuda")
    return adapters_to_numpy(ad)


def sharded_params(kind, opts, mesh=None):
    """(cfg, this rank's parameters): the whole seeded model cut to its
    shards on ``mesh`` (None: whole), the LoRA leg's adapter grafted
    (its shards cut by ``lora_param_specs``)."""
    from byteps_tpu_torch.models.convert import (adapters_from_numpy,
                                                 shard_params)
    from byteps_tpu_torch.models.lora import graft_lora

    cfg, params = sharded_model(kind)
    if mesh is not None:
        params = shard_params(params, mesh)
    if opts.get("lora"):
        params = graft_lora(params, adapters_from_numpy(
            sharded_adapters(cfg), mesh=mesh), 1.0)
    return cfg, params


def sharded_prompt(cfg) -> np.ndarray:
    """The generate legs' prompt: (B, T0) of SHARDED_TINY (f32) or
    SHARDED_GEN (bf16), seeded."""
    B, T0, _ = SHARDED_TINY if cfg.dtype == torch.float32 else SHARDED_GEN
    return np.random.default_rng(T0).integers(
        0, cfg.vocab_size, (B, T0)).astype(np.int32)


def first_logits(cfg, params, tp=None, ep=None) -> np.ndarray:
    """The first step's logits (the prefill's last position) of
    :func:`sharded_prompt`, f32 (B, vocab)."""
    from byteps_tpu_torch.models.generate import gpt_apply_cached, init_cache

    prompt = torch.as_tensor(sharded_prompt(cfg), device="cuda")
    kv = params["blocks"][0]["wk"].shape[-1] // cfg.head_dim
    logits, _ = gpt_apply_cached(params, prompt,
                                 init_cache(cfg, prompt.shape[0], h_loc=kv),
                                 cfg, tp, ep)
    return logits[:, -1].cpu().numpy()


@contextlib.contextmanager
def tp2_arithmetic():
    """A context in which one rank's cached forward computes as each rank
    of tp = 2 does, on contiguous halves: the column-parallel products
    (q, k, v, the MLP's up projection) as two products of half the
    output columns, attention over each half of the heads, and every
    row-parallel product as two bf16 partial products over the halves of
    the contraction, summed in f32 and rounded, the bias after the sum:
    attention's output projection and the dense MLP's down projection
    (``row_parallel_matmul``) and each expert's down projection (the
    MoE's ``ecf,efd->ecd`` product, whose ff dim tp splits)."""
    from byteps_tpu_torch.models import generate, gpt

    saved = (gpt.col_parallel_matmul, gpt.row_parallel_matmul,
             generate._cached_attention, torch.einsum)
    einsum = torch.einsum

    def halves(t, dim):
        h = t.shape[dim] // 2
        return (t.narrow(dim, 0, h).contiguous(),
                t.narrow(dim, h, t.shape[dim] - h).contiguous())

    def col(x, w, b=None):
        y = torch.cat([x @ wh for wh in halves(w, 1)], -1)
        return y if b is None else y + b

    def row(x, w, axis, b=None):
        (x0, x1), (w0, w1) = halves(x, -1), halves(w, 0)
        y = ((x0 @ w0).float() + (x1 @ w1).float()).to(x.dtype)
        return y if b is None else y + b

    def attention(q, k, v, q_pos0):
        return torch.cat([saved[2](qh, kh, vh, q_pos0) for qh, kh, vh in
                          zip(halves(q, 2), halves(k, 2), halves(v, 2))], 2)

    def split_einsum(eq, *ops):
        if eq != "ecf,efd->ecd":
            return einsum(eq, *ops)
        (h0, h1), (w0, w1) = halves(ops[0], 2), halves(ops[1], 1)
        return (einsum(eq, h0, w0).float()
                + einsum(eq, h1, w1).float()).to(h0.dtype)

    gpt.col_parallel_matmul = generate.col_parallel_matmul = col
    gpt.row_parallel_matmul = generate.row_parallel_matmul = row
    generate._cached_attention = attention
    torch.einsum = split_einsum
    try:
        yield
    finally:
        gpt.col_parallel_matmul = generate.col_parallel_matmul = saved[0]
        gpt.row_parallel_matmul = generate.row_parallel_matmul = saved[1]
        generate._cached_attention = saved[2]
        torch.einsum = saved[3]


def sharded_requests(cfg) -> list:
    """The serve legs' 8 greedy requests: tiny's prompt lengths of the
    tier's parity tests, GPT-2 medium's 32 to 128 tokens."""
    from byteps_tpu_torch.serve import Request

    rng = np.random.default_rng(5)
    if cfg.dtype == torch.float32:
        lens, new = [4, 13, 9, 21, 6, 17, 11, 5], 8
    else:
        lens = np.linspace(32, 128, 8).astype(int).tolist()
        new = SHARDED_SERVE_NEW
    return [Request(rid=f"r{i}", prompt=rng.integers(
        0, cfg.vocab_size, n).astype(np.int32), max_new=new)
        for i, n in enumerate(lens)]


def sharded_serve(cfg, params, tp) -> dict:
    """The Scheduler over ``tp`` serving :func:`sharded_requests`: every
    request's tokens (concatenated), wall, tokens/s, TTFT, preemptions,
    leaked blocks."""
    from byteps_tpu_torch.common.metrics import get_registry, reset_registry
    from byteps_tpu_torch.serve import Scheduler

    reset_registry()
    reqs = sharded_requests(cfg)
    kw = SHARDED_TINY_SCHED if cfg.dtype == torch.float32 else {}
    sched = Scheduler(params, cfg, tp_axis=tp, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sched.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = get_registry().snapshot("serve.")
    out = {"tokens": np.concatenate([res[r.rid]["tokens"] for r in reqs]),
           "requests": len(reqs), "wall_s": wall,
           "new_tokens_per_s": sum(r.max_new for r in reqs) / wall,
           "ttft_ms": snap["histograms"]["serve.ttft_ms"],
           "preempted": snap["counters"].get("serve.preempted", 0),
           "leaked_blocks": sched.cache.leaked_blocks()}
    del sched
    return out


def sharded_leg(leg, mesh, kind, opts) -> dict:
    """One sharded_decode leg on this rank over ``mesh``'s tp and ep axes
    (``mesh`` None: one rank, whole weights): generate's tokens, wall and
    tokens/s (bf16: also the first step's logits, the prefill's last
    position), or the serve leg's; launches, peak memory, coordinates."""
    from byteps_tpu_torch.models import make_generate_fn
    from byteps_tpu_torch.ops import launches, reset_launches

    names = () if mesh is None else mesh.axis_names
    if opts.get("one_line") and "dp" in names and mesh.axis_index("dp"):
        return {"coords": {a: mesh.axis_index(a) for a in names},
                "idle": True}
    tp = mesh.axis("tp") if "tp" in names else None
    ep = mesh.axis("ep") if "ep" in names else None
    cfg, params = sharded_params(kind, opts, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = {"coords": {a: mesh.axis_index(a) for a in names}}
    if opts.get("serve"):
        out.update(sharded_serve(cfg, params, tp))
    else:
        B, T0, new = (SHARDED_TINY if cfg.dtype == torch.float32
                      else SHARDED_GEN)
        prompt = sharded_prompt(cfg)
        if cfg.dtype == torch.bfloat16:
            out["first_logits"] = first_logits(cfg, params, tp, ep)
        gen = make_generate_fn(cfg, new, tp_axis=tp, ep_axis=ep,
                               quant_cache=opts.get("quant_cache", False))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = gen(params, prompt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out.update(tokens=toks.cpu().numpy(), wall_s=wall, batch=B,
                   prompt=T0, max_new=new, new_tokens_per_s=B * new / wall)
    out["launches"] = dict(launches)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["layers"] = cfg.n_layers
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_line_ring_cases(rank, mesh) -> dict:
    """The rotate and presum kernels over this rank's dp line of the
    4-rank job (both lines' rings run at once on the card), each public
    call on the card against the same call's plain hops over the same
    group on CPU tensors, bit for bit: onebit's tree payload (the signs
    of a full chunk's segment and the scale) collected and gathered,
    randomk's values presummed. Medians of CUDA events around 10 calls
    (the line's ranks meet before each), of the plain hops' host time
    over 5, and (rotate) of gloo's own all-to-all or all-gather of the
    same bytes over the same group; the bound of the call's bytes."""
    import statistics

    import torch.distributed as dist

    from byteps_tpu_torch.compression.topk import resolve_k
    from byteps_tpu_torch.ops import ring_collective_kernels as rk
    from byteps_tpu_torch.ops.onebit_kernels import packed_words

    dp = mesh.axis("dp")
    n, group = dp.size, dp.group
    seg = -(-CHUNK // n)
    tree = (("signs", torch.int32, (packed_words(seg),)),
            ("scale", torch.float32, (1,)))
    values = (("x", torch.float32, (resolve_k(RANDOMK_K, seg),)),)
    out = {}
    for i, (name, op, leaves) in enumerate((
            ("onebit_tree", "collect", tree), ("onebit_tree", "gather", tree),
            ("randomk_values", "presum", values))):
        payload = ring_input(700 + i, op, leaves, n, rank)
        got = ring_call(rk, op, payload, group)
        want = ring_call(rk, op, {k: v.cpu() for k, v in payload.items()},
                         group)
        if not all(bits_equal(got[k].cpu(), want[k]) for k in got):
            raise AssertionError(f"ring {op} of {name} over the dp line "
                                 f"{dp.ranks}: the kernel's bits differ "
                                 "from the plain hops'")

        def events(fn, iters=10):
            evs = []
            for _ in range(iters):
                torch.cuda.current_stream().synchronize()
                dist.barrier(group=group)
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                fn()
                ev[1].record()
                evs.append(ev)
            torch.cuda.synchronize()
            return statistics.median(a.elapsed_time(b) for a, b in evs)

        cpu = {k: v.cpu() for k, v in payload.items()}
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            ring_call(rk, op, cpu, group)
            host.append((time.perf_counter() - t0) * 1e3)
        row = sum(int(np.prod(r)) * dt.itemsize for _, dt, r in leaves)
        rd, wr = ring_bytes(op, n, row)
        bms, by = bound_ms(rd + wr, 0, torch.float32)
        lib = None
        if op != "presum":
            flat = torch.cat([v.reshape(v.shape[0] if op == "collect"
                                        else 1, -1).view(torch.uint8)
                              for v in payload.values()], 1).reshape(-1)
            if op == "collect":
                dst = torch.empty_like(flat)
                lib = events(lambda: dist.all_to_all_single(
                    dst, flat, group=group))
            else:
                dst = flat.new_empty(n * flat.numel())
                lib = events(lambda: dist.all_gather_into_tensor(
                    dst, flat, group=group))
        out[f"{name}_{op}"] = {
            "dp_line": list(dp.ranks), "row_bytes": row, "bit_equal": True,
            "ms": events(lambda: ring_call(rk, op, payload, group)),
            "plain_ms": statistics.median(host), "bound_ms": bms,
            "bound_by": by, "library_ms": lib}
    return out


def sharded_decode_rank(rank, n):
    """One rank of sharded_decode: the ring cases over its dp line, then
    every leg of :data:`SHARDED_LEGS` on a mesh of its own."""
    from byteps_tpu_torch.parallel.mesh import MeshAxes, make_mesh

    mesh = make_mesh(MeshAxes(dp=2, tp=2))
    res = {"ring": dp_line_ring_cases(rank, mesh)}
    close_rings(mesh)
    for leg, axes, kind, opts in SHARDED_LEGS:
        res[leg] = sharded_leg(leg, make_mesh(MeshAxes(**axes)), kind, opts)
    return res


def lines_of(rs, axis) -> list:
    """The ranks' results grouped by their line of ``axis`` (every other
    coordinate equal)."""
    lines = {}
    for r in rs:
        key = tuple(sorted((a, i) for a, i in r["coords"].items()
                           if a != axis))
        lines.setdefault(key, []).append(r)
    return list(lines.values())


def phase_sharded_decode() -> dict:
    """Sharded decode on four rank processes that time-slice the card
    (one spawn, gloo, :data:`SHARDED_LEGS`): generate over tp2 (GPT-2
    medium, full width and depth, bf16, B4 T0 128 and 32 new tokens), over
    ep2 and ep2×tp2 (bench.py's "moe" model, uncut), the f32 tiny configs
    over tp2 (dense, an int8 cache, a grafted rank-8 LoRA on wq, wv, wo
    and w2: the fused kernel for the column targets, the down and up
    halves around the tp sum for the row ones) and ep2×tp2 (the tiny
    MoE), and the Scheduler over tp2 (GPT-2 medium bf16, 8 requests; the
    tiny f32 model on a pool that preempts). Before them, on each dp line
    of the job (two rings at once), the rotate and presum kernels against
    the plain hops over the same group. One rank's runs of each model in
    this process are the yardstick; the MoE model's is also a leg of its
    own, moe_one_rank. Checks: bf16 first-step logits within
    TOL of one rank's (a tp leg's within TOL of one rank computing as tp
    = 2 does, :func:`tp2_arithmetic`: tp's own rounding of two partial
    sums moves a 24-layer bf16 model's logits by more than TOL, and flips
    MoE routes; the distance to the plain one rank is reported beside
    it); a tp line's ranks emit identical tokens; f32
    tokens equal one rank's; the LoRA leg launches the fused kernel and
    each half exactly 2 × layers × calls times; no block leaked; the ring
    cases bit-equal. Returns the path's launch counts: moe_one_rank's
    and rank 0's of each leg, summed (the other one-rank runs, the
    roundoff control and the ring cases count with no path)."""
    t0 = time.perf_counter()
    one = {}
    for leg, axes, kind, opts in SHARDED_LEGS:
        key = (kind, tuple(sorted(opts)))
        if key not in one:
            one[key] = sharded_leg(leg, None, kind, opts)
    moe_one = one[("moe", ())]
    total = dict(moe_one["launches"])
    # the roundoff control of the bf16 tp legs: one rank summing every
    # row-parallel product as tp = 2 does
    control = {}
    with tp2_arithmetic():
        for kind in ("gpt2m", "moe"):
            cfg, params = sharded_params(kind, {})
            control[kind] = first_logits(cfg, params)
            del params
    one_s = time.perf_counter() - t0
    ranks = spawn_ranks(sharded_decode_rank, 4)
    wall = time.perf_counter() - t0
    SHARDED_RING.update(ranks[0]["ring"])
    failed = []
    legs = {"moe_one_rank": {
        "mesh": {}, "model": "moe", "options": {},
        "layers": moe_one["layers"],
        "new_tokens_per_s": moe_one["new_tokens_per_s"],
        "wall_s": moe_one["wall_s"],
        "max_memory_allocated_gb": [moe_one["max_memory_allocated"] / 1e9],
        "launches": moe_one["launches"]}}
    bf = torch.bfloat16
    for leg, axes, kind, opts in SHARDED_LEGS:
        rs = [r[leg] for r in ranks if not r[leg].get("idle")]
        ref = one[(kind, tuple(sorted(opts)))]
        checks = {}
        if "tp" in axes:
            checks["tp_ranks_identical"] = all(
                all(np.array_equal(r["tokens"], ln[0]["tokens"])
                    for r in ln) for ln in lines_of(rs, "tp"))
        errs = plain_errs = None
        if "first_logits" in ref:
            # a tp leg against one rank with tp's partial sums, any other
            # against one rank; the distance to the plain one rank beside
            want = torch.from_numpy(control[kind] if "tp" in axes
                                    else ref["first_logits"])
            errs = [max_err(torch.from_numpy(r["first_logits"]), want,
                            TOL[bf]) for r in rs]
            plain_errs = [max_err(torch.from_numpy(r["first_logits"]),
                                  torch.from_numpy(ref["first_logits"]),
                                  TOL[bf])[0] for r in rs]
            checks["first_logits"] = all(ok for _, ok in errs)
        elif kind not in ("gpt2m", "moe"):       # the f32 legs
            checks["tokens_equal_one_rank"] = all(
                np.array_equal(r["tokens"], ref["tokens"]) for r in rs)
        if opts.get("serve"):
            checks["no_leak"] = all(r["leaked_blocks"] == 0 for r in rs)
        else:
            B, T0 = rs[0]["batch"], rs[0]["prompt"]
            checks["tokens"] = all(
                r["tokens"].shape == (B, T0 + r["max_new"])
                and r["tokens"].min() >= 0 for r in rs)
        want = {}
        if opts.get("lora"):
            # each forward call (the prefill and max_new - 1 decode steps)
            # a layer: wq and wv fused, wo and w2 down and up
            calls = rs[0]["max_new"]
            per = len(SHARDED_LORA_TARGETS) // 2 * rs[0]["layers"] * calls
            want = {"segmented_lora": per, "segmented_lora_down": per,
                    "segmented_lora_up": per}
            checks["lora_launches"] = all(
                r["launches"][k] == v for r in rs for k, v in want.items())
        if not all(checks.values()):
            failed.append((leg, checks))
        legs[leg] = {
            "mesh": axes, "model": kind, "options": opts,
            "layers": rs[0]["layers"], "checks": checks,
            "first_logits_held_to": None if errs is None
            else "tp2_arithmetic" if "tp" in axes else "one_rank",
            "first_logits_max_err": None if errs is None
            else max(e for e, _ in errs),
            "first_logits_max_err_to_one_rank": None if plain_errs is None
            else max(plain_errs),
            "control_max_err_to_one_rank": max_err(
                torch.from_numpy(control[kind]),
                torch.from_numpy(ref["first_logits"]), TOL[bf])[0]
            if errs is not None and "tp" in axes else None,
            "new_tokens_per_s": min(r["new_tokens_per_s"] for r in rs),
            "wall_s": max(r["wall_s"] for r in rs),
            "one_rank_new_tokens_per_s": ref["new_tokens_per_s"],
            "max_memory_allocated_gb": [r["max_memory_allocated"] / 1e9
                                        for r in rs],
            "one_rank_max_memory_allocated_gb":
                ref["max_memory_allocated"] / 1e9,
            "launches": rs[0]["launches"], "want_launches": want,
            **({"ttft_ms": [r["ttft_ms"] for r in rs],
                "preempted": [r["preempted"] for r in rs],
                "one_rank_ttft_ms": ref["ttft_ms"]}
               if opts.get("serve") else {})}
        for k, v in ranks[0][leg]["launches"].items():
            total[k] = total.get(k, 0) + v
    ring = {}
    for case in ranks[0]["ring"]:
        ring[case] = {**ranks[0]["ring"][case],
                      "ms_each_rank": [r["ring"][case]["ms"] for r in ranks]}
    emit({"phase": "sharded_decode", "card": card_name_and_limit(),
          "timing": "four ranks time-slice one card", "one_rank_s": one_s,
          "wall_s": wall, "legs": legs, "ring_over_dp_lines": ring,
          "failed": failed})
    if failed:
        raise AssertionError(f"sharded_decode failed: {failed}")
    return total


# --------------------------------------------------------------------------
# phase 20: families — BERT, ViT, T5 (training and cached generation) and
# ResNet-50 at full width and depth, and their tiny f32 legs
# --------------------------------------------------------------------------
FAMILY_STEPS = 2             # timed steps a leg, after one warm-up
# (B, source length, new tokens) of t5_generate: bench.py's T5-base
T5_GEN = (4, 128, 32)
# the tiny f32 legs, card against CPU from the same weights and batch:
# losses and leaves after one step, and the cached decoder's logits
FAMILY_TINY_TOL = 1e-4
# at PRNG-scale weights T5's tied readout returns its input, so greedy
# decoding emits BOS forever; the tiny generation leg scales every matrix
# of its weights by this, where the stream varies
T5_TINY_GEN_SCALE = 20.0
# (case, B, Sq, Sk, heads, q_off, k_off, lse cotangent, seed): the
# non-causal calls of the families' training steps (BERT-base and
# ViT-B/16 self-attention, T5's cross-attention square and, as a
# generation prefix's length gives it, rectangular) and one non-causal
# ring block of BERT over sp2 at the second block's keys
FAMILY_CASES = (("bert_base", 8, 512, 512, 12, 0, 0, False, 310),
                ("vit_b16", 32, 196, 196, 12, 0, 0, False, 311),
                ("t5_cross_512", 8, 512, 512, 12, 0, 0, False, 312),
                ("t5_cross_128x512", 8, 128, 512, 12, 0, 0, False, 313),
                ("bert_sp2_ring_block", 8, 256, 256, 12, 0, 256, True, 314))


def family_kernel_cases(timer) -> dict:
    """The forward, dq and dk/dv kernels at :data:`FAMILY_CASES` (bf16,
    head dim 64, no mask), t5_generate's non-causal encoder prefill (B=4
    × 128 tokens: several 64-row query tiles) and its one-row
    cross-attention against those 128 keys (forward only: generation has
    no backward), and
    its self-attention decode step (B=4, a 512-position cache at position
    31), each against its plain version under the cases' tolerances, timed
    and bounded; each forward's route among its fields."""
    bf = torch.bfloat16
    out = {}
    for name, B, Sq, Sk, H, q_off, k_off, dlse, seed in FAMILY_CASES:
        out[name] = {
            "fwd": fwd_case(timer, name, B, Sq, Sk, H, H, 64, q_off, bf,
                            seed, causal=False, k_off=k_off),
            "bwd": bwd_case(timer, name, B, Sq, Sk, H, H, 64, q_off, k_off,
                            bf, seed + 100, dlse, False)}
    B, S_src, _ = T5_GEN
    out["t5_gen_encoder"] = {"fwd": fwd_case(
        timer, "t5_gen_encoder", B, S_src, S_src, 12, 12, 64, 0, bf, 317,
        causal=False)}
    out["t5_gen_cross_row"] = {"fwd": fwd_case(
        timer, "t5_gen_cross_row", B, 1, S_src, 12, 12, 64, 0, bf, 315,
        causal=False)}
    out["t5_gen_self_decode"] = {"dec": decode_case(
        timer, "t5_gen_self_decode", B, 512, 12, 12, 64, 31, bf, False,
        316)}
    return out


def hold_launches(leg, got, want) -> None:
    """Raise unless every kernel of ``want`` launched exactly its count
    in ``got``."""
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise AssertionError(f"families {leg}: launches (got, want) {bad}")


def family_bf16_leg(name, factory, cfg, batch, want_of, per_item, **kw):
    """One full-width leg: ``factory(cfg, generator=seed 0, **kw)``, one
    warm-up and FAMILY_STEPS timed steps on the seeded ``batch``, its
    launches counted from 0 and held to ``want_of(params)`` (kernel:
    count, predicted from the model before it trains), its losses to
    :func:`falls`. Returns (record, the factory's outputs)."""
    from byteps_tpu_torch.ops import launches, reset_launches

    reset_launches()
    out = factory(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                  **kw)
    step = out[0]
    want = want_of(out[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(FAMILY_STEPS + 1):
        t0 = time.perf_counter()
        losses.append(float(step(*batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    got = dict(launches)
    hold_launches(name, got, want)
    if not falls(losses):
        raise AssertionError(f"families {name}: losses {losses}")
    step_s = sum(times[1:]) / FAMILY_STEPS
    n_params = sum(p.numel() for p in out[1].parameters())
    rec = {"leg": name, "params": n_params, "losses": losses,
           "warmup_s": times[0], "step_ms": step_s * 1e3,
           "step_ms_each": [t * 1e3 for t in times[1:]],
           "items_per_s": per_item / step_s,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": got}
    return rec, out


def phase_families() -> dict:
    """The families at full width and depth on the card, bf16 over f32
    master weights, AdamW(1e-3), one warm-up and FAMILY_STEPS timed steps
    a leg on a repeated seeded batch (bench.py's shapes):
    bert_onebit_ef (BERT-base, B=8 × S=512, mask rate 0.15, onebit + EF:
    BASELINE config 3), vit_b16 (B=32 at 224²), t5_base (12 + 12 layers,
    B=8, 512 source and 512 target tokens), t5_generate (T5-base from
    t5_base's trained weights, B=4, 128 source tokens, 32 new, greedy,
    after a pass at 2 new) and resnet50 (B=32 at 224², BASELINE config
    2). Each leg's losses fall, ResNet's running statistics move, and
    each leg's launches are held exactly to the prediction from its layer
    and chunk counts: the forward, dq and dk/dv kernels 12 a step for
    BERT and ViT and 36 for T5 (12 encoder, 12 decoder and 12 cross
    attentions), onebit pack and unpack-sum once a gradient chunk a step
    for BERT (ceil(P / 1,024,000) chunks, counted from the model before
    it trains), t5_generate's forward 12 + 12·N and decode 12·N for N new
    tokens (the BOS step included), no kernel of the port for ResNet
    (its convolutions are cuDNN's, as the reference's are XLA's). Returns
    the summed launch counts."""
    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.models import (BertConfig, ResNetConfig, T5Config,
                                         ViTConfig, make_bert_train_step,
                                         make_resnet_train_step,
                                         make_t5_generate_fn,
                                         make_t5_train_step,
                                         make_vit_train_step,
                                         synthetic_mlm_batch,
                                         synthetic_seq2seq_batch,
                                         synthetic_vit_batch)
    from byteps_tpu_torch.ops import launches, reset_launches

    calls = FAMILY_STEPS + 1
    per = get_config().partition_bytes // 4
    zero = {k: 0 for k in ("flash_decode", "onebit_pack",
                           "onebit_unpack_sum", "onebit_unpack_sum_grid",
                           "topk_select", "topk_reconstruct_sum",
                           "topk_roundtrip", "segmented_lora",
                           "ring_rotate", "ring_presum")}

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    legs, total = {}, {}

    def add(rec):
        legs[rec["leg"]] = rec
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v

    def attn(n):
        # every training forward takes the wgmma path (bf16, B·H·ceil(Sq /
        # 64) >= 128 tiles)
        return {**{k: n * calls for k in TRAIN}, "flash_fwd_split": 0}

    def chunks(params):
        return -(-sum(p.numel() for p in params.parameters()) // per)

    # BERT-base, onebit + EF: a pack and an unpack-sum a gradient chunk
    bert = BertConfig.base()
    rec, out = family_bf16_leg(
        "bert_onebit_ef", make_bert_train_step, bert,
        synthetic_mlm_batch(gen(1), bert, 8, 512),
        lambda p: {**attn(bert.n_layers), **zero,
                   "onebit_pack": chunks(p) * calls,
                   "onebit_unpack_sum": chunks(p) * calls}, 8 * 512,
        compression_params=ONEBIT_EF)
    add({**rec, "batch": [8, 512], "mask_rate": 0.15,
         "chunks_per_step": chunks(out[1]), "items": "tokens"})
    del out
    gc.collect()
    torch.cuda.empty_cache()

    vit = ViTConfig.base()
    rec, out = family_bf16_leg(
        "vit_b16", make_vit_train_step, vit,
        synthetic_vit_batch(gen(1), vit, 32),
        lambda p: {**attn(vit.n_layers), **zero}, 32)
    add({**rec, "batch": [32, 224, 224, 3], "items": "images"})
    del out
    gc.collect()
    torch.cuda.empty_cache()

    t5 = T5Config.base()
    rec, out = family_bf16_leg(
        "t5_base", make_t5_train_step, t5,
        synthetic_seq2seq_batch(gen(1), t5, 8, 512, 512),
        lambda p: {**attn(t5.n_enc_layers + 2 * t5.n_dec_layers), **zero},
        8 * 512)
    add({**rec, "batch": [8, 512, 512], "items": "target tokens"})
    params = out[1]
    del out
    B, S_src, N = T5_GEN
    src = torch.randint(0, t5.vocab_size, (B, S_src), generator=gen(2),
                        device="cuda")
    reset_launches()
    make_t5_generate_fn(t5, 2)(params, src)            # the warm pass
    g = make_t5_generate_fn(t5, N)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = g(params, src)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(launches)
    L = t5.n_dec_layers
    fwd = (t5.n_enc_layers + L * 2) + (t5.n_enc_layers + L * N)
    # every forward of generation takes the split path: the B=4 × 128
    # encoder is 96 tiles of 64 rows, the one-row cross-attention 48
    want = {"flash_fwd": fwd, "flash_fwd_split": fwd,
            "flash_decode": L * 2 + L * N, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    hold_launches("t5_generate", got, want)
    if toks.shape != (B, N) or not bool(((toks >= 0)
                                         & (toks < t5.vocab_size)).all()):
        raise AssertionError(f"families t5_generate: tokens {toks.shape}")
    add({"leg": "t5_generate", "batch": B, "source": S_src, "new": N,
         "wall_s": wall, "new_tokens_per_s": B * N / wall,
         "distinct_tokens": int(torch.unique(toks).numel()),
         "launches": got})
    del params
    gc.collect()
    torch.cuda.empty_cache()

    rn = ResNetConfig(dtype=torch.bfloat16)
    images = torch.randn((32, 224, 224, 3), generator=gen(1), device="cuda")
    labels = torch.randint(0, rn.num_classes, (32,), generator=gen(1),
                           device="cuda")
    rec, out = family_bf16_leg(
        "resnet50", make_resnet_train_step, rn, (images, labels),
        lambda p: {**attn(0), **zero}, 32)
    bn = out[3]
    # from running means 0 and variances 1
    moved = max(float((t - float(name.endswith("var"))).abs().max())
                for name, t in bn.named_parameters())
    if not moved > 0:
        raise AssertionError("families resnet50: bn_state never moved")
    add({**rec, "batch": [32, 224, 224, 3], "items": "images",
         "bn_state_max_move": moved})
    del out, bn
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "families", "steps": FAMILY_STEPS, "legs": legs})
    return total


def tiny_family(fam, seed):
    """(config, factory, CPU weights (and ResNet's statistics), batch as
    numpy) of a family's tiny f32 leg."""
    from byteps_tpu_torch.models import (BertConfig, ResNetConfig, T5Config,
                                         ViTConfig, bert_init,
                                         make_bert_train_step,
                                         make_resnet_train_step,
                                         make_t5_train_step,
                                         make_vit_train_step, resnet_init,
                                         t5_init, vit_init)

    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    if fam == "bert":
        cfg = BertConfig.tiny()
        tgt = rng.integers(0, cfg.vocab_size, (4, 32))
        mask = np.zeros((4, 32), np.int64)
        # microbatches of two rows with 10 and 7 masked positions
        for r, n in enumerate((2, 8, 4, 3)):
            mask[r, rng.choice(32, n, replace=False)] = 1
        batch = (np.where(mask == 1, cfg.vocab_size - 1, tgt), tgt, mask)
        return cfg, make_bert_train_step, (bert_init(cfg, g, "cpu"),), batch
    if fam == "vit":
        cfg = ViTConfig.tiny()
        batch = (rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                 rng.integers(0, cfg.n_classes, (4,)))
        return cfg, make_vit_train_step, (vit_init(cfg, g, "cpu"),), batch
    if fam == "t5":
        cfg = T5Config.tiny()
        tg = rng.integers(0, cfg.vocab_size, (4, 17))
        tg[:, 0] = 0
        batch = (rng.integers(0, cfg.vocab_size, (4, 24)), tg[:, :-1],
                 tg[:, 1:])
        return cfg, make_t5_train_step, (t5_init(cfg, g, "cpu"),), batch
    cfg = ResNetConfig.tiny()
    batch = (rng.standard_normal((4, 33, 33, 3)).astype(np.float32),
             rng.integers(0, cfg.num_classes, (4,)))
    return cfg, make_resnet_train_step, resnet_init(cfg, g, "cpu"), batch


def leaf_diffs(a, b) -> dict:
    """Each leaf's max |a - b| by its path, ``b`` on the card."""
    return {n: float((x.detach().cpu() - y.detach().cpu()).abs().max())
            for (n, x), (_, y) in zip(a.named_parameters(),
                                      b.named_parameters())}


def phase_families_tiny() -> dict:
    """Each family's tiny f32 config on the CPU (plain versions) and on
    the card (kernels) from the same weights and batch: the loss and every
    leaf after one step within FAMILY_TINY_TOL. ResNet runs
    with cuDNN's TF32 off (``main`` turns it off for the whole smoke, and
    this leg asserts it). BERT also runs ``accum_steps=2`` on the card on
    microbatches of 10 and 7 masked positions, held to the full batch's
    step within the same tolerance. Then T5's cached generation: a tiny
    f32 model with every matrix scaled by T5_TINY_GEN_SCALE (greedy
    emits BOS forever at PRNG scale) decodes 12 tokens greedily on both
    devices: the tokens equal, the stream not constant, and the card's
    logits at each cached step equal to teacher-forced ``t5_decode``
    over the same tokens within FAMILY_TINY_TOL."""
    from byteps_tpu_torch.models import (make_t5_generate_fn, t5_decode,
                                         t5_decode_cached, t5_encode,
                                         t5_init)
    from byteps_tpu_torch.models.t5 import t5_cross_kv, t5_init_cache

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("families_tiny runs with TF32 off")
    tol = FAMILY_TINY_TOL
    res = {}
    for i, fam in enumerate(("bert", "vit", "t5", "resnet")):
        cfg, factory, init, batch = tiny_family(fam, 50 + i)
        pristine = copy.deepcopy(init)

        def on_card():
            w = copy.deepcopy(pristine)
            return ({"init_params": w[0].to("cuda")}
                    | ({"init_state": w[1].to("cuda")} if fam == "resnet"
                       else {}))

        kw = ({"init_state": init[1]} if fam == "resnet" else {})
        cpu = factory(cfg, init_params=init[0], device="cpu", **kw)
        card = factory(cfg, **on_card())
        lc, lg = float(cpu[0](*batch)), float(card[0](*batch))
        diffs = leaf_diffs(cpu[1], card[1])
        worst = max(diffs, key=diffs.get)
        r = {"cpu_loss": lc, "card_loss": lg, "loss_diff": abs(lc - lg),
             "worst_leaf": worst, "worst_leaf_diff": diffs[worst]}
        ok = abs(lc - lg) <= tol and diffs[worst] <= tol
        if fam == "resnet":
            r["bn_state_max_diff"] = max(leaf_diffs(cpu[3], card[3])
                                         .values())
            r["tf32"] = False
            ok = ok and r["bn_state_max_diff"] <= tol
        if fam == "bert":
            acc = factory(cfg, accum_steps=2, **on_card())
            la = float(acc[0](*batch))
            ad = leaf_diffs(card[1], acc[1])
            r.update(accum2_loss=la, accum2_loss_diff=abs(la - lg),
                     accum2_params_max_diff=max(ad.values()),
                     mask_counts=batch[2].sum(1).tolist())
            ok = ok and abs(la - lg) <= tol and max(ad.values()) <= tol
        res[fam] = r
        if not ok:
            raise AssertionError(f"families_tiny {fam}: {r} beyond {tol}")
    # cached generation, T5 tiny at scaled weights
    cfg = tiny_family("t5", 52)[0]
    p_cpu = t5_init(cfg, torch.Generator().manual_seed(7), device="cpu")
    with torch.no_grad():
        for t in p_cpu.parameters():
            if t.ndim == 2:
                t.mul_(T5_TINY_GEN_SCALE)
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    src = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 16))
    n = 12
    t_cpu = make_t5_generate_fn(cfg, n, device="cpu")(p_cpu, src)
    t_gpu = make_t5_generate_fn(cfg, n)(p_gpu, src)
    src_t = torch.as_tensor(src, device="cuda")
    with torch.no_grad():
        mem = t5_encode(p_gpu, src_t, cfg)
        ck, cv = t5_cross_kv(p_gpu, mem, cfg)
        cache = t5_init_cache(cfg, 2)
        fed = torch.cat([torch.zeros((2, 1), dtype=torch.long,
                                     device="cuda"), t_gpu[:, :-1].long()], 1)
        steps = []
        for j in range(n):
            lg_, cache = t5_decode_cached(p_gpu, fed[:, j:j + 1], cache, ck,
                                          cv, cfg)
            steps.append(lg_)
        teacher = t5_decode(p_gpu, mem, fed, cfg)
    step_diff = float((torch.cat(steps, 1) - teacher).abs().max())
    distinct = int(torch.unique(t_gpu).numel())
    gen = {"tokens_equal": bool(torch.equal(t_cpu, t_gpu.cpu())),
           "distinct_tokens": distinct, "step_logits_max_diff": step_diff,
           "weight_scale": T5_TINY_GEN_SCALE, "new": n}
    res["t5_generate"] = gen
    if not (gen["tokens_equal"] and distinct > 2 and step_diff <= tol):
        raise AssertionError(f"families_tiny t5_generate: {gen}")
    emit({"phase": "families_tiny", "tolerance": tol, **res})
    return res


# the kernels each run of the main path must launch
# --------------------------------------------------------------------------
# phase 21: the process tier
# --------------------------------------------------------------------------
# resume_exact's depth (GPT-2 medium at full width): its checkpoint holds
# the parameters, two AdamW moments and the EF residual, 16 bytes a
# parameter, most of them the embedding's
PROCESS_TIER_LAYERS = 2
PROCESS_TIER_BATCH = (8, 1024)
# the supervised children: rounds, floats a round, the pause a round, and
# the server's lease (a checkpointing child's interpreter and torch
# import take seconds before its first round)
CHILD_ROUNDS = 6
CHILD_ELEMS = 1 << 16
CHILD_DELAY_MS = 150
CHILD_LEASE_MS = 10000


def resume_exact(B, S) -> dict:
    """The onebit + EF leg of GPT-2 medium at ``PROCESS_TIER_LAYERS``
    layers, its batches read in ``ElasticShardMap`` order through
    ``PrefetchLoader``: 2 steps, an asynchronous save of the whole train
    state (the shard map's cursor with it), 2 more steps; a freshly
    built step, restored, trains the same 2 steps. Losses, parameters,
    AdamW moments and step count, EF residual and the codec's count
    must be bit-equal to the continuation."""
    import shutil
    import tempfile

    from byteps_tpu_torch.checkpoint import (Checkpointer, load_train_state,
                                             train_state)
    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.common.flight_recorder import get_flight_recorder
    from byteps_tpu_torch.common.metrics import get_registry
    from byteps_tpu_torch.data import ElasticShardMap, PrefetchLoader
    from byteps_tpu_torch.models import GPTConfig, make_gpt_train_step
    from byteps_tpu_torch.models.convert import flat_leaves

    cfg = dataclasses.replace(GPTConfig.gpt2_medium(),
                              n_layers=PROCESS_TIER_LAYERS)
    steps = (2, 2, 2)              # before the save, after it, resumed
    rows = np.random.default_rng(60).integers(
        0, cfg.vocab_size, (B * sum(steps), S + 1))

    def batches(smap, n):
        """``n`` batches of the epoch's order from the map's cursor."""
        order = smap.shard_for(0, [0])
        for i in range(n):
            r = rows[order[i * B:(i + 1) * B]]
            yield torch.from_numpy(r[:, :-1]), torch.from_numpy(r[:, 1:])

    def run(step, smap, n):
        losses = []
        with PrefetchLoader(batches(smap, n), depth=2) as loader:
            for tok, tgt in loader:
                losses.append(float(step(tok, tgt)))
        smap.advance(n * B)
        return losses

    def factory(seed):
        return make_gpt_train_step(
            cfg, compression_params=ONEBIT_EF,
            generator=torch.Generator(device="cuda").manual_seed(seed))

    fr = get_flight_recorder()
    hist = get_registry().histogram("train.step_ms")
    fr0, h0, warm = fr.summary()["step"], hist.count(), fr.summary()["step"] > 0
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        step, params, opt = factory(0)
        smap = ElasticShardMap(len(rows), seed=61)
        first = run(step, smap, steps[0])
        ck = Checkpointer(ckdir, max_to_keep=2, async_save=True)
        state, specs = train_state(steps[0], params, opt)
        state["data"] = {"epoch": smap.epoch, "cursor": smap.n_examples
                         - smap.remaining}
        torch.cuda.synchronize()
        ck.save(steps[0], state, specs=specs)
        del state
        cont = run(step, smap, steps[1])
        ck.wait()
        saved = dict(ck.last_save)
        step2, params2, opt2 = factory(1)          # other weights
        like, specs2 = train_state(0, params2, opt2)
        like["data"] = {"epoch": 0, "cursor": 0}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = ck.restore(like, specs=specs2)
        got_step = load_train_state(params2, opt2, restored)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        smap2 = ElasticShardMap(len(rows), seed=61)
        smap2.advance(restored["data"]["cursor"])
        del restored, like
        resumed = run(step2, smap2, steps[2])
        same = {
            "loss": cont == resumed,
            "params": all(torch.equal(a, b) for a, b in zip(
                flat_leaves(params), flat_leaves(params2))),
            "moments": all(
                set(opt.optimizer.state[a]) == set(opt2.optimizer.state[b])
                and all(torch.equal(opt.optimizer.state[a][k],
                                    opt2.optimizer.state[b][k])
                        for k in opt.optimizer.state[a])
                for a, b in zip(opt.params, opt2.params)),
            "ef": torch.equal(opt.ef, opt2.ef),
            "count": opt.count == opt2.count == sum(steps[:2])}
        if got_step != steps[0] or not all(same.values()):
            raise AssertionError(f"resume_exact: restored step {got_step}, "
                                 f"bit-equal {same}; continuation {cont}, "
                                 f"resumed {resumed}")
        n_params = sum(p.numel() for p in opt.params)
        chunks = -(-n_params // (get_config().partition_bytes // 4))
        taken = sum(steps)
        ring = fr.summary()
        timed_steps = hist.count() - h0
        if ring["step"] - fr0 != taken or timed_steps != taken - (not warm):
            raise AssertionError(f"resume_exact: the flight recorder moved "
                                 f"{ring['step'] - fr0} steps and timed "
                                 f"{timed_steps} for {taken} steps taken")
        del step, params, opt, step2, params2, opt2
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return {"layers": cfg.n_layers, "batch": B, "seq": S,
            "params": n_params, "chunks_per_step": chunks,
            "steps": list(steps), "losses": first + cont,
            "resumed_losses": resumed, "bit_equal": same,
            "checkpoint_bytes": saved["bytes"],
            "save_d2h_ms": saved["d2h_ms"],
            "save_write_ms": saved["write_ms"], "restore_ms": restore_ms,
            "flight_recorder": {"ring_steps": ring["ring_steps"],
                                "steps_advanced": ring["step"] - fr0,
                                "train_step_ms_count": timed_steps}}


def supervised_resume() -> dict:
    """The launcher's ``Supervisor`` running ``--child-worker`` children
    against a port server in this process: one clean run, one whose
    child is SIGKILLed after its round-2 progress line, respawned,
    restored from its checkpoint and rejoined. The children are host
    processes that never touch the card."""
    import json as js
    import os
    import shutil
    import signal
    import tempfile
    from pathlib import Path

    from byteps_tpu_torch.launcher import Supervisor
    from byteps_tpu_torch.server import (native, start_server_any_port,
                                         stop_server)

    root = Path(__file__).resolve().parent
    native.build()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_supervised_"))

    def one(name, kill_after=None):
        port = start_server_any_port(free_port_pair(), num_workers=1,
                                     engine_threads=2, async_mode=False,
                                     lease_ms=CHILD_LEASE_MS)
        out = tmp / f"{name}.json"
        sup = Supervisor(backoff_ms=50, base_env={
            "PYTHONPATH": str(root), "CUDA_VISIBLE_DEVICES": "",
            "BYTEPS_CHILD_SERVERS": f"127.0.0.1:{port}",
            "BYTEPS_CHILD_ROUNDS": str(CHILD_ROUNDS),
            "BYTEPS_CHILD_ELEMS": str(CHILD_ELEMS),
            "BYTEPS_CHILD_PIN": "1", "BYTEPS_CHILD_CKPT": str(tmp / name),
            "BYTEPS_CHILD_OUT": str(out),
            "BYTEPS_CHILD_ROUND_DELAY_MS": str(CHILD_DELAY_MS)})
        progress = Path(str(out) + ".progress")

        def lines():
            return (progress.read_text().splitlines()
                    if progress.exists() else [])

        t_start = time.perf_counter()
        sup.spawn(auto_restart=True)
        kill_ms = None
        try:
            if kill_after is not None:
                deadline = time.monotonic() + 120
                while len(lines()) <= kill_after:
                    if time.monotonic() > deadline or not sup.live():
                        raise AssertionError(f"supervised_resume: the child "
                                             f"never passed round "
                                             f"{kill_after}")
                    sup.poll()
                    time.sleep(0.01)
                t_kill = time.perf_counter()
                victim = sup.child(0)
                sup.kill(0, signal.SIGKILL)
                victim.wait(timeout=30)
                n_dead = len(lines())
                deadline = time.monotonic() + 120
                while len(lines()) <= n_dead:
                    if time.monotonic() > deadline:
                        raise AssertionError("supervised_resume: the "
                                             "respawned child never "
                                             "finished a round")
                    sup.poll()
                    time.sleep(0.01)
                kill_ms = (time.perf_counter() - t_kill) * 1e3
            if not sup.wait_all(timeout_s=120, poll_ms=20):
                raise AssertionError("supervised_resume: children still "
                                     f"running: {sup.live()}")
        finally:
            sup.shutdown()
            stop_server()
        return (js.loads(out.read_text()), sup.exit_reasons.get(0, []),
                kill_ms, time.perf_counter() - t_start)

    try:
        clean, clean_reasons, _, clean_s = one("clean")
        crashed, reasons, kill_ms, crash_s = one("crash", kill_after=2)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok = (clean_reasons == ["clean"] and len(reasons) >= 2
          and reasons[0] == "signal:SIGKILL" and reasons[-1] == "clean"
          and crashed["restarts"] >= 1 and crashed["resumed_from"] >= 1
          and len(clean["rounds"]) == CHILD_ROUNDS
          and crashed["state_crc"] == clean["state_crc"]
          and crashed["state_sum"] == clean["state_sum"])
    if not ok:
        raise AssertionError(f"supervised_resume: clean {clean_reasons} "
                             f"{clean}, crashed {reasons} {crashed}")
    return {"rounds": CHILD_ROUNDS, "elems": CHILD_ELEMS,
            "round_delay_ms": CHILD_DELAY_MS, "lease_ms": CHILD_LEASE_MS,
            "exit_reasons": reasons, "restarts": crashed["restarts"],
            "resumed_from": crashed["resumed_from"],
            "state_crc": crashed["state_crc"],
            "state_crc_equal": True, "state_sum": crashed["state_sum"],
            "kill_to_first_respawned_round_ms": kill_ms,
            "clean_wall_s": clean_s, "crash_wall_s": crash_s}


PROCESS_TIER = {}


def phase_process_tier() -> dict:
    """Phase 21 (the module docstring): resume_exact, then
    supervised_resume; one line naming the depth."""
    t0 = time.perf_counter()
    B, S = PROCESS_TIER_BATCH
    rec = {"phase": "process_tier", "card": card_name_and_limit(),
           "layers": PROCESS_TIER_LAYERS,
           "resume_exact": resume_exact(B, S)}
    rec["supervised_resume"] = supervised_resume()
    rec["elapsed_s"] = time.perf_counter() - t0
    emit(rec)
    PROCESS_TIER.update(rec)
    return rec


def process_tier_path() -> dict:
    """process_tier counted, its launches held: resume_exact's steps
    launch the forward (wgmma, never the split path), dq and dk/dv once
    a layer and step, onebit pack and unpack-sum once a chunk and step;
    the supervised children launch nothing here."""
    counts = counted("process_tier", phase_process_tier)
    rx = PROCESS_TIER["resume_exact"]
    steps = sum(rx["steps"])
    want = {**{k: steps * rx["layers"] for k in TRAIN},
            "flash_fwd_split": 0, "flash_decode": 0,
            "onebit_pack": steps * rx["chunks_per_step"],
            "onebit_unpack_sum": steps * rx["chunks_per_step"]}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"process_tier launched {got}, predicted "
                             f"{want}")
    return counts


TRAIN = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
TOPK = ("topk_select", "topk_reconstruct_sum", "topk_roundtrip")
# (serving chunks take the forward's split path: flash_fwd_split)
SPLIT = ("flash_fwd", "flash_fwd_split")
PATHS = {"generate": ("flash_fwd", "flash_decode"), "serve": SPLIT,
         "exact": SPLIT + ("flash_decode",),
         "multitenant": SPLIT + ("segmented_lora",),
         "multitenant_exact": SPLIT + ("segmented_lora",),
         "speculative": SPLIT + ("flash_decode",),
         "serve_router": SPLIT,
         "train_bf16": TRAIN,
         "train_raw": TRAIN,
         "train_onebit": TRAIN + ("onebit_pack", "onebit_unpack_sum"),
         "train_topk": TRAIN + TOPK,
         "train_ring": TRAIN + ("onebit_pack", "onebit_unpack_sum",
                                "ring_rotate", "ring_presum"),
         "train_dcn": TRAIN,
         "train_hybrid": TRAIN + ("onebit_pack", "onebit_unpack_sum",
                                  "ring_rotate"),
         "train_chaos": TRAIN,
         "aggregate_onebit": ("onebit_pack", "onebit_unpack_sum_grid"),
         "train_zero": TRAIN + ("onebit_pack", "onebit_unpack_sum",
                                "topk_select", "topk_reconstruct_sum"),
         "train_accum": TRAIN,
         "eval": ("flash_fwd",),
         "train_parallel": TRAIN + ("onebit_pack", "onebit_unpack_sum",
                                    "ring_rotate"),
         "train_pipeline": TRAIN + ("onebit_pack", "onebit_unpack_sum"),
         "train_moe": TRAIN,
         "train_multislice": TRAIN + ("onebit_pack", "onebit_unpack_sum",
                                      "ring_rotate"),
         "sharded_decode": SPLIT + ("flash_decode", "segmented_lora",
                                    "segmented_lora_down",
                                    "segmented_lora_up"),
         "families": TRAIN + ("onebit_pack", "onebit_unpack_sum",
                              "flash_decode"),
         "process_tier": TRAIN + ("onebit_pack", "onebit_unpack_sum")}
MAIN_PATHS = ("generate", "serve", "multitenant", "speculative",
              "serve_router", "train_raw",
              "train_onebit", "train_topk", "train_ring", "train_dcn",
              "train_hybrid", "train_chaos", "aggregate_onebit",
              "train_zero", "train_accum", "eval", "train_parallel",
              "train_pipeline", "train_moe", "train_multislice",
              "sharded_decode", "families", "process_tier")
# the launch counters of a kernels-line row: the segmented LoRA kernel's
# fused launches and its two halves'
ROW_COUNTS = {"segmented_lora": ("segmented_lora", "segmented_lora_down",
                                 "segmented_lora_up")}
TOPK_BLOCK_EF = {"compressor": "topk", "k": 0.01, "ef": "vanilla",
                 "selection": "block"}


def check_path(name, counts) -> dict:
    """Fail if a kernel the path must launch never ran; free its memory."""
    missing = [k for k in PATHS[name] if counts[k] <= 0]
    gc.collect()
    torch.cuda.empty_cache()
    if missing:
        raise AssertionError(f"{name} never launched {missing}: {counts}")
    return counts


def counted(name, fn, *args) -> dict:
    """Run one path of the main path with every launch count at 0 just
    before it; return the counts read just after."""
    from byteps_tpu_torch.ops import launches, reset_launches

    reset_launches()
    fn(*args)
    return check_path(name, dict(launches))


def counted_compared(name, fn, *args) -> dict:
    """Run one path of the main path counted as :func:`counted` does,
    where ``fn`` returns its record and its comparisons (plain or solo
    runs the path is held against): they run after the counts are read,
    so their launches stay out of the path's, and each adds its entries
    to the record, which is then printed."""
    from byteps_tpu_torch.ops import launches, reset_launches

    reset_launches()
    record, comparisons = fn(*args)
    counts = check_path(name, dict(launches))
    for compare in comparisons:
        record.update(compare())
    emit(record)
    return counts


def counted_ranks(name, fn, *args) -> dict:
    """Run one path of the main path that runs in rank processes: each
    starts with every count at 0, and ``fn`` returns the counts they
    report."""
    return check_path(name, fn(*args))


def serving_rest(params, cfg) -> dict:
    """speculative and serve_router, each counted without its
    comparison runs: their launch counts by path (each leg's held exactly
    inside)."""
    return {"speculative": counted_compared("speculative",
                                            phase_speculative, params, cfg),
            "serve_router": counted_compared("serve_router",
                                             phase_serve_router, params,
                                             cfg)}


def training_options() -> dict:
    """The raw train leg (the yardstick of accumulation's peak memory),
    then train_zero, train_accum and eval, each counted: their launch
    counts by path."""
    return {"train_raw": counted("train_raw", phase_train, "raw", None),
            "train_zero": check_path("train_zero", phase_train_zero()),
            "train_accum": check_path("train_accum", phase_train_accum()),
            "eval": check_path("eval", phase_eval())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ring", action="store_true",
                    help="run only the ring phases (ring, train_ring), for "
                         "work on the ring kernels; no kernels line, no "
                         "result line")
    ap.add_argument("--dcn", action="store_true",
                    help="run only train_dcn, for work on the DCN tier; no "
                         "kernels line, no result line")
    ap.add_argument("--hybrid", action="store_true",
                    help="run only train_hybrid, for work on the eager "
                         "surface; no kernels line, no result line")
    ap.add_argument("--chaos", action="store_true",
                    help="run only train_chaos, for work on the DCN tier's "
                         "robustness; no kernels line, no result line")
    ap.add_argument("--parallel", action="store_true",
                    help="run only the flash kernels at train_parallel's "
                         "calls "
                         "and train_parallel (tensor and sequence "
                         "parallelism); no kernels line, no result line")
    ap.add_argument("--pipeline", action="store_true",
                    help="run only the flash kernels and onebit at "
                         "train_pipeline's and train_moe's calls, and "
                         "train_pipeline and train_moe (pipeline and "
                         "expert parallelism); no kernels line, no result "
                         "line")
    ap.add_argument("--multislice", action="store_true",
                    help="run only the kernels at train_multislice's calls "
                         "and train_multislice (the multi-slice tier, "
                         "ZeRO-3 and ZeRO-1 over a dp subgroup); no kernels "
                         "line, no result line")
    ap.add_argument("--sharded_decode", action="store_true",
                    help="run only the segmented LoRA kernel's halves and "
                         "sharded_decode (tp and ep in generate and serve, "
                         "the ring kernels over each dp line); no kernels "
                         "line, no result line")
    ap.add_argument("--zero", action="store_true",
                    help="run only the training options' phases (the codec "
                         "kernels at ZeRO's shapes, train_raw, train_zero, "
                         "train_accum, eval, train_tiny, train_ring with "
                         "its ZeRO legs) and examples; no kernels line, no "
                         "result line")
    ap.add_argument("--families", action="store_true",
                    help="run only the flash kernels at the families' calls, "
                         "families (BERT-base onebit + EF, ViT-B/16, "
                         "T5-base training and generation, ResNet-50) and "
                         "their tiny f32 legs; no kernels line, no result "
                         "line")
    ap.add_argument("--process_tier", action="store_true",
                    help="run only process_tier (resume_exact, "
                         "supervised_resume) and examples (with "
                         "launch_global); no kernels line, no result line")
    ap.add_argument("--serve_router", action="store_true",
                    help="run only the verify chunk's flash cases, "
                         "speculative and serve_router (speculative "
                         "decoding, failover, disaggregation and "
                         "migration); no kernels line, no result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from byteps_tpu_torch.models import GPTConfig, gpt_init
    from byteps_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_and_limit()
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in p.with_suffix(".log").read_text()
                 .splitlines() if "registers" in ln or "spill" in ln]
             for n, p in libs.items()}
    # one cuobjdump a library, all at once
    with concurrent.futures.ThreadPoolExecutor(5) as ex:
        sass = {n: ex.submit(sass_counts, libs[n], *ops) for n, ops in (
            ("flash_fwd", ()), ("flash_bwd", ()), ("flash_decode", ()),
            ("segmented_lora", (FMA_SASS,)), ("onebit", (FMA_SASS,)))}
        sass = {n: f.result() for n, f in sass.items()}
    emit({"phase": "card", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas,
          "sass": sass})
    # the bf16 split kernel's tensor-core instantiations (MMA = true)
    tc_split = re.compile(
        r"fwd_split_kernel<__nv_bfloat16, [^,]+, (\(bool\)1|true)[,>]"
        r"|fwd_split_kernelI13__nv_bfloat16Li\d+ELb1E")
    split_sass = {k: c for k, c in sass["flash_fwd"].items()
                  if tc_split.search(k)}
    if not split_sass or not all(c["HGMMA"] + c["HMMA"] > 0
                                 for c in split_sass.values()):
        raise AssertionError("the bf16 split kernel shows no tensor-core "
                             f"instruction: {split_sass}")

    if args.ring:
        phase_ring()
        emit({"phase": "launches", "train_ring": counted_ranks(
            "train_ring", phase_train_ring)})
        return 0
    if args.dcn:
        emit({"phase": "launches", "train_dcn": counted_ranks(
            "train_dcn", phase_train_dcn)})
        return 0
    if args.hybrid:
        emit({"phase": "launches", "train_hybrid": counted_ranks(
            "train_hybrid", phase_train_hybrid)})
        return 0
    if args.chaos:
        emit({"phase": "launches", "train_chaos": counted_ranks(
            "train_chaos", phase_train_chaos)})
        return 0
    if args.parallel:
        parallel_kernel_cases(Timer())
        emit({"phase": "launches", "train_parallel": counted_ranks(
            "train_parallel", phase_train_parallel)})
        return 0
    if args.pipeline:
        pipeline_kernel_cases(Timer())
        emit({"phase": "launches", "train_pipeline": counted_ranks(
            "train_pipeline", phase_train_pipeline), "train_moe":
            counted_ranks("train_moe", phase_train_moe)})
        return 0
    if args.multislice:
        multislice_kernel_cases(Timer())
        emit({"phase": "launches", "train_multislice": counted_ranks(
            "train_multislice", phase_train_multislice)})
        return 0
    if args.sharded_decode:
        lora_half_cases(Timer())
        emit({"phase": "launches", "sharded_decode": counted_ranks(
            "sharded_decode", phase_sharded_decode)})
        return 0
    if args.families:
        family_kernel_cases(Timer())
        emit({"phase": "launches", "families": check_path(
            "families", phase_families())})
        phase_families_tiny()
        return 0
    if args.serve_router:
        verify_cases(Timer())
        cfg = GPTConfig.gpt2_medium()
        params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0))
        emit({"phase": "launches", **serving_rest(params, cfg)})
        return 0
    if args.process_tier:
        emit({"phase": "launches", "process_tier": process_tier_path()})
        phase_examples(card)
        return 0
    if args.zero:
        zero_codec_cases(Timer())
        emit({"phase": "launches", **training_options(),
              "train_ring": counted_ranks("train_ring", phase_train_ring)})
        phase_train_tiny()
        phase_examples(card)
        return 0
    timer = Timer()
    bf, f32 = torch.bfloat16, torch.float32
    fwd = []
    for dt in (bf, f32):
        fwd.append(fwd_case(timer, "prefill", 4, 128, 1024, 16, 16, 64, 0,
                            dt, 10))
        fwd.append(fwd_case(timer, "chunk", 1, 32, 512, 16, 16, 64, 256,
                            dt, 11))
        fwd.append(fwd_case(timer, "ragged_chunk", 1, 37, 512, 16, 16, 64,
                            475, dt, 12))
        fwd.append(fwd_case(timer, "gqa", 4, 128, 1024, 16, 4, 64, 0, dt,
                            13))
        fwd.append(fwd_case(timer, "long_prefill", 1, 700, 1024, 16, 16, 64,
                            0, dt, 14))
    fwd += split_cases(timer)
    verify = verify_cases(timer)
    for case in INVARIANCE:
        fwd_invariance(*case)
    dec = [decode_case(timer, *case) for case in DECODE_CASES]
    for case in DECODE_TWICE:
        decode_twice_case(*case)
    # the training shape: B=8, S=1024, 16 heads of 64
    fwd.append(fwd_case(timer, "train", 8, 1024, 1024, 16, 16, 64, 0, bf,
                        15))
    # the tensor-core path at head dim 128, and without the causal mask on
    # a ragged length
    fwd.append(fwd_case(timer, "d128", 4, 1024, 1024, 8, 8, 128, 0, bf, 16))
    fwd.append(fwd_case(timer, "noncausal_ragged", 2, 1000, 1000, 16, 16,
                        64, 0, bf, 17, causal=False))
    bwd, failed = [], []
    for case in (("train", 8, 1024, 1024, 16, 16, 64, 0, 0, bf, 30),
                 ("train", 8, 1024, 1024, 16, 16, 64, 0, 0, f32, 31),
                 ("gqa", 8, 1024, 1024, 16, 4, 64, 0, 0, bf, 32),
                 ("ragged", 8, 1000, 1000, 16, 16, 64, 0, 0, bf, 33),
                 ("offset_dead_rows", 2, 256, 512, 16, 16, 64, 128, 256, bf,
                  34, True),
                 ("offset_dead_rows", 2, 256, 512, 16, 16, 64, 128, 256, f32,
                  35, True),
                 ("tiny_partial", 1, 17, 17, 2, 2, 64, 0, 0, bf, 28),
                 ("d128", 4, 1024, 1024, 8, 8, 128, 0, 0, bf, 36),
                 ("d128_gqa_offset", 2, 256, 512, 8, 2, 128, 128, 256, bf, 29,
                  True),
                 ("noncausal_ragged", 2, 1000, 1000, 16, 16, 64, 0, 0, bf, 37,
                  False, False)):
        try:                       # run every case, then fail on any
            bwd.append(bwd_case(timer, *case))
        except AssertionError as e:
            print(e, file=sys.stderr, flush=True)
            failed.append(case[0])
    if failed:
        raise AssertionError(f"flash_bwd cases {failed} failed")
    ring_kc = parallel_kernel_cases(timer)
    pipe_kc = pipeline_kernel_cases(timer)
    ms_kc = multislice_kernel_cases(timer)
    fam_kc = family_kernel_cases(timer)
    twice_case("train", 8, 1024, 16, 16, 64, 38)
    twice_case("d128", 4, 1024, 8, 8, 128, 39)
    chunk = 4096000 // 4           # one default partition of f32
    bits = [onebit_case(timer, "chunk", chunk, 40),
            onebit_case(timer, "ragged", 1_000_003, 41),
            onebit_case(timer, "signed_zero_nan", 1_000_003, 42,
                        special=True)]
    pack_unaligned_cases(timer)
    unpack_edge_cases()
    unpack_nonfinite_cases()
    topk = topk_cases(timer)
    lora = lora_cases(timer)
    halves = lora_half_cases(timer)
    zero_codec_cases(timer)
    del timer

    cfg = GPTConfig.gpt2_medium()
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    by_path = {
        "generate": counted("generate", phase_generate, params, cfg),
        "serve": counted("serve", phase_serve, params, cfg),
        "exact": counted("exact", phase_exact, params,
                         dataclasses.replace(cfg, dtype=torch.float32)),
        "multitenant": counted("multitenant", phase_multitenant, params, cfg),
        "multitenant_exact": counted(
            "multitenant_exact", phase_multitenant_exact, params,
            dataclasses.replace(cfg, dtype=torch.float32)),
        **serving_rest(params, cfg),
    }
    del params
    # 2 pooled targets x 24 layers, once for each packed decode step and
    # each prefill chunk of an adapter-tagged request, both passes
    want = len(MT_TARGETS) * cfg.n_layers * MT_CALLS["multitenant"]
    if by_path["multitenant"]["segmented_lora"] != want:
        raise AssertionError(
            f"multitenant launched segmented_lora "
            f"{by_path['multitenant']['segmented_lora']} times, not {want} "
            f"({len(MT_TARGETS)} targets x {cfg.n_layers} layers x "
            f"{MT_CALLS['multitenant']} forward calls)")
    by_path["train_bf16"] = counted("train_bf16", phase_train_bf16)
    by_path.update(training_options())
    by_path["train_onebit"] = counted(
        "train_onebit", phase_train, "onebit_ef",
        {"compressor": "onebit", "ef": "vanilla"})
    by_path["train_topk"] = counted("train_topk", phase_train,
                                    "topk_block_ef", TOPK_BLOCK_EF)
    by_path["aggregate_onebit"] = counted("aggregate_onebit",
                                          phase_aggregate_onebit)
    want = {"onebit_pack": sum(AGGREGATE_KS),
            "onebit_unpack_sum_grid": len(AGGREGATE_KS)}
    for name, n in want.items():
        if by_path["aggregate_onebit"][name] != n:
            raise AssertionError(f"aggregate_onebit launched {name} "
                                 f"{by_path['aggregate_onebit'][name]} "
                                 f"times, not {n}")
    steps = 6                      # one warm-up and five timed
    chunks = TRAIN_CHUNKS["onebit_ef"]
    for name in ("onebit_pack", "onebit_unpack_sum"):
        if by_path["train_onebit"][name] != steps * chunks:
            raise AssertionError(
                f"train_onebit launched {name} "
                f"{by_path['train_onebit'][name]} times, not one per chunk "
                f"and step ({steps} x {chunks})")
    # top-k: the fused round trip on each full chunk (tiled layout), select
    # and reconstruct-sum on the ragged tail (strided layout)
    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.compression.topk import tiled_shape

    per = get_config().partition_bytes // 4
    full, tail = divmod(TRAIN_PARAMS["topk_block_ef"], per)
    k = TOPK_BLOCK_EF["k"]
    if tiled_shape(k, per) is None or (tail and tiled_shape(k, tail)):
        raise AssertionError("top-k chunks no longer take the expected "
                             "layouts")
    want = {"topk_roundtrip": steps * full,
            "topk_select": steps * (tail > 0),
            "topk_reconstruct_sum": steps * (tail > 0)}
    for name, n in want.items():
        if by_path["train_topk"][name] != n:
            raise AssertionError(f"train_topk launched {name} "
                                 f"{by_path['train_topk'][name]} times, not "
                                 f"{n} ({steps} steps, {full} full chunks)")
    for leg in ("train_raw", "train_onebit", "train_topk"):
        for name in TRAIN:
            if by_path[leg][name] != steps * cfg.n_layers:
                raise AssertionError(f"{leg} launched {name} "
                                     f"{by_path[leg][name]} times, not one "
                                     f"per layer and step")
    if TRAIN_PARAMS["onebit_ef"] != GPT2M_PARAMS:
        raise AssertionError(f"GPT-2 medium has {TRAIN_PARAMS['onebit_ef']} "
                             f"parameters, the ring phases assume "
                             f"{GPT2M_PARAMS}")
    ring = phase_ring()
    # its exact counts are checked leg by leg inside
    by_path["train_ring"] = counted_ranks("train_ring", phase_train_ring)
    by_path["train_dcn"] = counted_ranks("train_dcn", phase_train_dcn)
    by_path["train_hybrid"] = counted_ranks("train_hybrid",
                                            phase_train_hybrid)
    by_path["train_chaos"] = counted_ranks("train_chaos", phase_train_chaos)
    by_path["train_parallel"] = counted_ranks("train_parallel",
                                              phase_train_parallel)
    by_path["train_pipeline"] = counted_ranks("train_pipeline",
                                              phase_train_pipeline)
    by_path["train_moe"] = counted_ranks("train_moe", phase_train_moe)
    by_path["train_multislice"] = counted_ranks("train_multislice",
                                                phase_train_multislice)
    by_path["sharded_decode"] = counted_ranks("sharded_decode",
                                              phase_sharded_decode)
    by_path["families"] = check_path("families", phase_families())
    by_path["process_tier"] = process_tier_path()
    emit({"phase": "launches", **by_path})
    phase_tiny()
    phase_train_tiny()
    phase_families_tiny()
    phase_examples(card)

    # the shapes the main path launches most: serve's prefill chunks,
    # generate's decode steps, the training step's attention backward and
    # the gradient chunks
    main_fwd = next(r for r in fwd if r["case"] == "chunk")
    train_fwd = next(r for r in fwd if r["case"] == "train")
    main_dec = {**dec[0], **{f"long_{k}": dec[1][k]
                             for k in ("ms", "bound_ms", "library_ms")}}
    main_bwd = bwd[0]
    main_bits = bits[0]
    common = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")
    rows = [("flash_fwd", "flash_fwd", "byteps_tpu/ops/flash_attention.py:207",
             {**main_fwd, **{f"train_{k}": train_fwd[k]
                             for k in ("ms", "bound_ms", "library_ms")},
              **{f"split_{k}": main_fwd[k]
                 for k in ("ms", "bound_ms", "library_ms")},
              "verify_cases": {
                  f"{c['case']}_{c['dtype']}": {
                      k: c[k] for k in ("shape", "q_off", "route", "ms",
                                        "plain_ms", "library_ms",
                                        "bound_ms", "bound_by",
                                        "max_abs_err")}
                  for c in verify},
              "split_launches": sum(by_path[p]["flash_fwd_split"]
                                    for p in MAIN_PATHS),
              "split_launches_by_path": {
                  p: c["flash_fwd_split"] for p, c in by_path.items()},
              "ring_cases": {
                  nm: {"paths": c["paths"],
                       **{k: c["fwd"][k] for k in ("ms", "plain_ms",
                                                   "library_ms", "bound_ms",
                                                   "bound_by", "max_abs_err",
                                                   "route")}}
                  for nm, c in ring_kc.items()},
              "pipeline_cases": {
                  nm: {"paths": c["paths"],
                       **{k: c["fwd"][k] for k in ("ms", "plain_ms",
                                                   "library_ms", "bound_ms",
                                                   "bound_by", "max_abs_err",
                                                   "route")}}
                  for nm, c in pipe_kc.items() if nm != "onebit_tail"},
              "multislice_cases": {
                  nm: {"paths": c["paths"],
                       **{k: c["fwd"][k] for k in ("ms", "plain_ms",
                                                   "library_ms", "bound_ms",
                                                   "bound_by", "max_abs_err",
                                                   "route")}}
                  for nm, c in ms_kc.items() if "fwd" in c},
              "family_cases": {
                  nm: {k: c["fwd"][k] for k in ("shape", "q_off", "k_off",
                                                "ms", "plain_ms",
                                                "library_ms", "bound_ms",
                                                "bound_by", "max_abs_err",
                                                "route")}
                  for nm, c in fam_kc.items() if "fwd" in c}}),
            ("flash_decode", "flash_decode",
             "byteps_tpu/ops/flash_decode.py:77",
             {**main_dec, "family_cases": {
                 nm: {k: c["dec"][k] for k in common}
                 for nm, c in fam_kc.items() if "dec" in c}}),
            ("flash_bwd_dq", "flash_bwd",
             "byteps_tpu/ops/flash_attention.py:340",
             {**main_bwd, **main_bwd["dq"],
              "ring_cases": {nm: {**c["bwd"]["dq"],
                                  "plain_ms": c["bwd"]["plain_ms"],
                                  "library_ms": c["bwd"]["library_ms"]}
                             for nm, c in ring_kc.items()},
              "pipeline_cases": {
                  nm: {**c["bwd"]["dq"], "plain_ms": c["bwd"]["plain_ms"],
                       "library_ms": c["bwd"]["library_ms"]}
                  for nm, c in pipe_kc.items() if nm != "onebit_tail"},
              "multislice_cases": {
                  nm: {**c["bwd"]["dq"], "plain_ms": c["bwd"]["plain_ms"],
                       "library_ms": c["bwd"]["library_ms"]}
                  for nm, c in ms_kc.items() if "bwd" in c},
              "family_cases": {
                  nm: {**c["bwd"]["dq"], "plain_ms": c["bwd"]["plain_ms"],
                       "library_ms": c["bwd"]["library_ms"]}
                  for nm, c in fam_kc.items() if "bwd" in c}}),
            ("flash_bwd_dkv", "flash_bwd",
             "byteps_tpu/ops/flash_attention.py:399",
             {**main_bwd, **main_bwd["dkv"],
              "ring_cases": {nm: {**c["bwd"]["dkv"],
                                  "plain_ms": c["bwd"]["plain_ms"],
                                  "library_ms": c["bwd"]["library_ms"]}
                             for nm, c in ring_kc.items()},
              "pipeline_cases": {
                  nm: {**c["bwd"]["dkv"], "plain_ms": c["bwd"]["plain_ms"],
                       "library_ms": c["bwd"]["library_ms"]}
                  for nm, c in pipe_kc.items() if nm != "onebit_tail"},
              "multislice_cases": {
                  nm: {**c["bwd"]["dkv"], "plain_ms": c["bwd"]["plain_ms"],
                       "library_ms": c["bwd"]["library_ms"]}
                  for nm, c in ms_kc.items() if "bwd" in c},
              "family_cases": {
                  nm: {**c["bwd"]["dkv"], "plain_ms": c["bwd"]["plain_ms"],
                       "library_ms": c["bwd"]["library_ms"]}
                  for nm, c in fam_kc.items() if "bwd" in c}}),
            ("onebit_pack", "onebit", "byteps_tpu/ops/onebit_kernels.py:81",
             {"case": "chunk", "max_abs_err": main_bits["pack_max_abs_err"],
              "pp_tail_ms": pipe_kc["onebit_tail"]["pack_ms"],
              "hier_chunk_half_ms": ms_kc["onebit_chunk"]["pack_ms"],
              "hier_tail_half_ms": ms_kc["onebit_tail"]["pack_ms"],
              "ms": main_bits["pack_ms"],
              "plain_ms": main_bits["pack_plain_ms"],
              "bound_ms": main_bits["pack_bound_ms"],
              "bound_by": main_bits["pack_bound_by"], "library_ms": None}),
            ("onebit_unpack_sum", "onebit",
             "byteps_tpu/ops/onebit_kernels.py:124",
             {"case": "chunk K=1",
              "max_abs_err": main_bits["unpack_k1_max_abs_err"],
              "pp_tail_ms": pipe_kc["onebit_tail"]["unpack_k1_ms"],
              "hier_chunk_half_k2_ms": ms_kc["onebit_chunk"]["unpack_k2_ms"],
              "hier_tail_half_k2_ms": ms_kc["onebit_tail"]["unpack_k2_ms"],
              "ms": main_bits["unpack_k1_ms"],
              "plain_ms": main_bits["unpack_k1_plain_ms"],
              "bound_ms": main_bits["unpack_k1_bound_ms"],
              "bound_by": main_bits["unpack_k1_bound_by"],
              "library_ms": None}),
            ("onebit_unpack_sum_grid", "onebit",
             "byteps_tpu/ops/onebit_kernels.py:134",
             {"case": "chunk K=40 (aggregate_onebit: K = 40 and 256)",
              "max_abs_err": main_bits["unpack_k40_max_abs_err"],
              "ms": main_bits["unpack_k40_ms"],
              "plain_ms": main_bits["unpack_k40_plain_ms"],
              "bound_ms": main_bits["unpack_k40_bound_ms"],
              "bound_by": main_bits["unpack_k40_bound_by"],
              "library_ms": None,
              "k256_ms": main_bits["unpack_k256_ms"],
              "k256_bound_ms": main_bits["unpack_k256_bound_ms"],
              "ragged_ms": bits[1]["unpack_k40_ms"]}),
            ("topk_select", "topk", "byteps_tpu/ops/topk_kernels.py:76",
             topk["topk_select"]),
            ("topk_reconstruct_sum", "topk",
             "byteps_tpu/ops/topk_kernels.py:110",
             topk["topk_reconstruct_sum"]),
            ("topk_roundtrip", "topk", "byteps_tpu/ops/topk_kernels.py:139",
             topk["topk_roundtrip"]),
            ("segmented_lora", "segmented_lora",
             "byteps_tpu/ops/segmented_lora.py:87",
             {**lora, **{k: halves["halves"][0][k] for k in (
                 "down_ms", "down_bound_ms", "down_library_ms", "up_ms",
                 "up_bound_ms", "up_library_ms")},
              "halves": halves["halves"],
              "split_tp1_bit_equal": halves["split_tp1"],
              **{f"{h}_launches": sum(by_path[p][f"segmented_lora_{h}"]
                                      for p in MAIN_PATHS)
                 for h in ("down", "up")},
              "fused_launches": sum(by_path[p]["segmented_lora"]
                                    for p in MAIN_PATHS),
              **{f"{h}_launches_by_path": {
                  p: c[f"segmented_lora_{h}"] for p, c in by_path.items()}
                 for h in ("down", "up")}}),
            ("ring_rotate", "ring",
             "byteps_tpu/ops/ring_collective_kernels.py:138",
             {**ring["ring_rotate"], "dp_line_cases": {
                 k: v for k, v in SHARDED_RING.items() if "presum" not in k}}),
            ("ring_presum", "ring",
             "byteps_tpu/ops/ring_collective_kernels.py:189",
             {**ring["ring_presum"], "dp_line_cases": {
                 k: v for k, v in SHARDED_RING.items() if "presum" in k}})]
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"byteps_tpu_torch/ops/csrc/{src}.cu", "replaces": rep,
         "launches": sum(by_path[p][k] for p in MAIN_PATHS
                         for k in ROW_COUNTS.get(name, (name,))),
         "launches_by_path": {p: sum(c[k] for k in ROW_COUNTS.get(
             name, (name,))) for p, c in by_path.items()},
         "case": main["case"], **{k: main[k] for k in common},
         **{k: main[k] for k in ("warm_ms", "offset_ms", "tall",
                                 "chunk_ms", "k8_ms", "k256_ms",
                                 "k256_bound_ms", "ragged_ms",
                                 "ms_time_sliced", "train_ms",
                                 "train_bound_ms", "train_library_ms",
                                 "split_ms", "split_bound_ms",
                                 "split_library_ms", "split_launches",
                                 "split_launches_by_path", "long_ms",
                                 "long_bound_ms", "long_library_ms",
                                 "ms_spin", "signs_ms",
                                 "signs_ms_time_sliced",
                                 "signs_library_ms", "signs_bound_ms",
                                 "verify_cases", "ring_cases",
                                 "pipeline_cases",
                                 "multislice_cases", "family_cases",
                                 "pp_tail_ms",
                                 "hier_chunk_half_ms", "hier_tail_half_ms",
                                 "hier_chunk_half_k2_ms",
                                 "hier_tail_half_k2_ms", "down_ms",
                                 "down_bound_ms", "down_library_ms",
                                 "up_ms", "up_bound_ms", "up_library_ms",
                                 "halves", "split_tp1_bit_equal",
                                 "fused_launches", "down_launches",
                                 "up_launches", "down_launches_by_path",
                                 "up_launches_by_path", "dp_line_cases")
            if k in main}}
        for name, src, rep, main in rows]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        close_pool()
    sys.exit(rc)
