#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``byteps_tpu_torch``) on one card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --ring     # the ring phases (10-11) alone
    python3 chip_smoke.py --dcn      # train_dcn (12) alone
    python3 chip_smoke.py --hybrid   # train_hybrid (13) alone
    python3 chip_smoke.py --chaos    # train_chaos (14) alone

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
   the card, so one block takes each), and on a second launch;
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
   yardstick: index_select + two bmm;
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
9. train_tiny — a tiny f32 model trains 3 raw steps on the CPU (plain
   versions) and on the card (kernels) to losses within 1e-4;
10. ring — the ring kernels with 2, 3 and 4 rank processes (``spawn``)
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
    ``make_gpt_train_step`` at GPT-2 medium's full width and depth,
    B=4 × S=1024 each (the single-card legs' global batch), one warm-up
    and 2 steps a leg: staged onebit + EF, ``BYTEPS_ICI_TIER=ring``
    onebit + EF, ring randomk (k = 0.01) + EF. The ring onebit leg's
    losses and each rank's parameter digest equal the staged leg's;
    every leg ends with the ranks' parameters equal and finite losses;
    step ms, tokens/s (time-sliced) and each rank's peak memory;
12. train_dcn — the DCN parameter-server tier: one server process of the
    port (``python -m byteps_tpu_torch.server``, two workers, a free
    port; built with g++ first) and two rank processes on the card, each
    training GPT-2 medium at full width, B=4 × S=1024, one warm-up and 2
    steps a leg: staged_raw (``make_gpt_train_step`` at n = 2, the
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
    codec bytes (raw 1,419,485,184 each way), the bytes copied D2H and
    H2D per step 1,419,485,184 each, and the flash kernels launch once
    per layer and step on every leg; the server exits 0 after both
    ranks' goodbyes and is killed on any other way out. Step ms (the
    slower rank), tokens/s, wire and copy bytes, the scheduler's stage
    run and dwell sums per step, peak memory;
13. train_hybrid — the eager surface (``byteps_tpu_torch.eager``) over
    one pod of two rank processes on the card, with one port server
    process (``DMLC_NUM_WORKER=1``) for each hybrid leg, the ranks under
    ``BYTEPS_FORCE_DISTRIBUTED=1``: GPT-2 medium at full width, B=4 ×
    S=1024 a rank, one warm-up and 2 steps a leg, ``push_pull_tree`` of
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
    pulled per step the plans' (raw 1,419,485,184 each way), D2H and H2D
    1,419,485,184, the other rank's none; step ms (the slower rank),
    tokens/s, bytes and ``ici.wire_bytes`` per step, the stage run and
    dwell sums (REDUCE's, run in the caller's thread, too) and the tail
    thread's sum (``eager.tail_us``) per step, peak memory;
14. train_chaos — the DCN tier's robustness, the same two ranks and
    model, two port server processes a leg (``DMLC_NUM_SERVER=2``), one
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
    rank's failover.

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
once a sum (2).
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
(the gather) and no collect.
A ``launches`` line gives the counts per path, then a
``{"kernels": [...]}`` line whose ``launches`` sums the main paths
(generate, serve, multitenant, the three train legs, train_ring's
three legs on one rank, train_dcn's four legs on one rank,
train_hybrid's five legs on one rank, train_chaos's five legs on one
rank, aggregate_onebit; the ring rows' times are the
ring phase's
n = 2 cases, rotate's the onebit payload's tree collect with the signs
leaf alone as ``signs_*``; the flash_fwd row, timed at serve's chunk,
also gives the training shape's ms, bound and SDPA ms as ``train_*``,
the split path's at serve's chunk as ``split_*`` and its launches, in
all and by path, as ``split_launches`` and ``split_launches_by_path``,
the flash_decode
row, timed at generate's step, the long case's as ``long_*``; the
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


def emit(obj) -> None:
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
             causal=True):
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from byteps_tpu_torch.ops.flash_attention import (
        attention_lse_torch, flash_attention_lse)

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
    o, lse = flash_attention_lse(q, k, v, q_off, 0, causal=causal)
    o_ref, lse_ref = attention_lse_torch(q, k, v, q_off, 0, causal=causal)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    err_o, ok_o = max_err(o, o_ref, tol)
    err_l, ok_l = max_err(lse, lse_ref, tol)
    if not (ok_o and ok_l):
        raise AssertionError(f"flash_fwd {name}: o err {err_o}, lse err "
                             f"{err_l} beyond tolerance {tol}")
    ms = timer(lambda: flash_attention_lse(q, k, v, q_off, 0, causal=causal))
    plain_ms = timer(lambda: attention_lse_torch(q, k, v, q_off, 0,
                                                 causal=causal))
    # the library yardstick: same function (o only) from (B, H, S, D)
    # copies made outside the timing, k/v widened to H heads for GQA
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    if not causal:
        lib_ms = timer(lambda: sdpa(qt, kt, vt))
    elif q_off == 0 and Sq == Sk:   # plain causal: SDPA's flash backend
        lib_ms = timer(lambda: sdpa(qt, kt, vt, is_causal=True))
    else:
        mask = (q_off + torch.arange(Sq, device="cuda")[:, None]
                >= torch.arange(Sk, device="cuda")[None, :])
        lib_ms = timer(lambda: sdpa(qt, kt, vt, attn_mask=mask))
    # the work this run's data needs: live (row, key) pairs, live keys
    pairs = (Sq * Sk if not causal else
             sum(min(Sk, max(0, q_off + i + 1)) for i in range(Sq)))
    kend = Sk if not causal else min(Sk, q_off + Sq)
    isz = q.element_size()
    n_bytes = (2 * B * Sq * H * D * isz + 2 * B * kend * Hkv * D * isz
               + B * Sq * H * 4)
    n_ops = 4 * D * pairs * B * H
    bms, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"case": name, "dtype": str(dtype).split(".")[-1],
           "shape": [B, Sq, Sk, H, Hkv, D], "q_off": q_off,
           "causal": causal, "route": fwd_route_of(q, k, v),
           "max_abs_err": max(err_o, err_l),
           "tolerance": tol,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bms, "bound_by": by}
    emit({"phase": "flash_fwd", **res})
    return res


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


# filled by phase_train: the gradient chunks and elements of one step
TRAIN_CHUNKS = {}
TRAIN_PARAMS = {}


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
    emit({"phase": "train", "leg": leg, "batch": B, "seq": S,
          "params": n_params, "chunks_per_step": chunks,
          "compression": compression_params, "losses": losses,
          "warmup_s": times[0], "step_ms": step_s * 1e3,
          "step_ms_each": [t * 1e3 for t in times[1:]],
          "tokens_per_s": B * S / step_s,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    del step, params, opt


def phase_train_tiny(steps=3):
    """A tiny f32 model trains on the CPU (plain versions) and on the card
    (kernels) from the same weights and batch to the same losses."""
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
    lc = [float(cpu(tok, tgt)) for _ in range(steps)]
    lg = [float(gpu(tok, tgt)) for _ in range(steps)]
    diff = max(abs(a - b) for a, b in zip(lc, lg))
    if not diff <= 1e-4:
        raise AssertionError(f"tiny train: CPU losses {lc} vs card {lg}")
    emit({"phase": "train_tiny", "cpu_losses": lc, "card_losses": lg,
          "max_diff": diff, "tolerance": 1e-4})


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
# phases 10-11: the ring tier, ranks as processes that share the card
# --------------------------------------------------------------------------
# GPT-2 medium's gradient in default partitions: 346 full chunks of
# 1,024,000 f32 and a tail of 567,296; randomk keeps k = 0.01 of a segment
GPT2M_PARAMS = 354_871_296
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


def spawn_ranks(body, n, *args, timeout=900):
    """Run ``body(rank, n, *args)`` in ``n`` fresh processes (``spawn``:
    the parent already holds a CUDA context) that share a gloo group over
    a FileStore on card 0; return each rank's result, raising if any rank
    failed. Every process is gone on return."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ring_")
    procs = [ctx.Process(target=rank_entry,
                         args=(body.__name__, r, n, f"{tmp}/store", q)
                         + args)
             for r in range(n)]
    done = False
    try:
        for p in procs:
            p.start()
        res = {}
        deadline = time.monotonic() + timeout
        while len(res) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise AssertionError(f"{body.__name__}: ranks "
                                     f"{sorted(set(range(n)) - set(res))} "
                                     f"gave no result in {timeout} s")
            try:
                r = q.get(timeout=min(left, 5.0))
            except Exception:          # queue.Empty: is every rank alive?
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in res]
                if dead:
                    raise AssertionError(
                        f"{body.__name__}: rank(s) {dead} died "
                        f"(exit {[procs[i].exitcode for i in dead]})")
                continue
            res[r["rank"]] = r
        failed = {k: v["failed"] for k, v in res.items() if "failed" in v}
        if failed:
            raise AssertionError(f"{body.__name__} failed:\n"
                                 + "\n".join(f"rank {k}: {v}"
                                             for k, v in failed.items()))
        done = True
        return [res[r] for r in range(n)]
    finally:
        for p in procs:
            if p.pid is None:              # never started
                continue
            p.join(timeout=60 if done else 0)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def rank_entry(body_name, rank, n, store, q, *args):
    """A rank process: join the gloo group on card 0, run the body named
    ``body_name``, and report its result or its failure (with any ring
    wait that ran past its bound) on the queue."""
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
    except Exception:               # reported to the parent, which fails
        q.put({"rank": rank, "failed": traceback.format_exc()
               + "".join(f"\n{e}" for e in rk.ring_errors())})


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


def ring_call(rk, op, payload) -> dict:
    """The public call of ``op`` on ``payload``: a leaf alone through
    ``ring_collect``/``ring_allgather``/``ring_presum``, several through
    the tree calls."""
    if op == "presum":
        return {"x": rk.ring_presum(payload["x"])}
    if len(payload) == 1:
        fn = rk.ring_collect if op == "collect" else rk.ring_allgather
        return {"x": fn(payload["x"])}
    fn = rk.ring_collect_tree if op == "collect" else rk.ring_allgather_tree
    return fn(payload)


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


TRAIN_RING_LEGS = (("staged_onebit_ef", "staged",
                    {"compressor": "onebit", "ef": "vanilla"}),
                   ("ring_onebit_ef", "ring",
                    {"compressor": "onebit", "ef": "vanilla"}),
                   ("ring_randomk_ef", "ring",
                    {"compressor": "randomk", "k": RANDOMK_K,
                     "ef": "vanilla"}))


def train_ring_rank(rank, n, B, S, steps):
    """One rank of train_ring: each leg builds the training step from the
    same seeded weights, trains on this rank's seeded batch, and reports
    losses, step times, a digest of its parameters, peak memory and the
    launch counts."""
    import hashlib
    import os

    from byteps_tpu_torch.common.config import reset_config
    from byteps_tpu_torch.models import (GPTConfig, make_gpt_train_step,
                                         synthetic_batch)
    from byteps_tpu_torch.ops import launches, reset_launches

    cfg = GPTConfig.gpt2_medium()
    res = {}
    for leg, tier, comp in TRAIN_RING_LEGS:
        os.environ["BYTEPS_ICI_TIER"] = tier
        reset_config()
        reset_launches()
        step, params, opt = make_gpt_train_step(
            cfg, compression_params=comp,
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
        flat = torch.cat([p.detach().reshape(-1) for p in opt.params])
        res[leg] = {
            "losses": losses, "step_ms_each": [t * 1e3 for t in times[1:]],
            "warmup_s": times[0],
            "params_sha1": hashlib.sha1(flat.cpu().numpy().data).hexdigest(),
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
            / 1e9,
            "launches": dict(launches)}
        del step, params, opt, flat
        gc.collect()
        torch.cuda.empty_cache()
    return res


def phase_train_ring(B=4, S=1024, steps=2) -> dict:
    """Two ranks on the card train GPT-2 medium at full width, B=4 × S=1024
    each (the single-card legs' global batch of 8), bf16 over f32 master
    weights, AdamW(1e-3), one warm-up and ``steps`` timed steps a leg:
    staged onebit + EF, ring onebit + EF and ring randomk + EF. The ring
    onebit leg equals the staged one bit for bit (losses and each rank's
    parameter digest); every leg ends with both ranks' parameters equal
    and every loss finite; the launch counts are exact. Returns rank 0's
    counts summed over the legs (both ranks' are checked equal)."""
    from byteps_tpu_torch.models import GPTConfig

    n = 2
    t0 = time.perf_counter()
    per_rank = spawn_ranks(train_ring_rank, n, B, S, steps)
    wall = time.perf_counter() - t0
    cfg = GPTConfig.gpt2_medium()
    calls = steps + 1
    chunks = -(-GPT2M_PARAMS // CHUNK)
    for leg, _, _ in TRAIN_RING_LEGS:
        legs = [r[leg] for r in per_rank]
        if len({lg["params_sha1"] for lg in legs}) != 1:
            raise AssertionError(f"train_ring {leg}: the ranks' parameters "
                                 "differ")
        if not all(np.isfinite(lg["losses"]).all() for lg in legs):
            raise AssertionError(f"train_ring {leg}: a loss is not finite")
        if legs[0]["launches"] != legs[1]["launches"]:
            raise AssertionError(f"train_ring {leg}: the ranks launched "
                                 "different counts")
    for r in per_rank:
        if (r["ring_onebit_ef"]["losses"] != r["staged_onebit_ef"]["losses"]
                or r["ring_onebit_ef"]["params_sha1"]
                != r["staged_onebit_ef"]["params_sha1"]):
            raise AssertionError(
                f"train_ring: rank {r['rank']}'s ring onebit + EF leg "
                f"differs from staged: losses {r['ring_onebit_ef']['losses']}"
                f" vs {r['staged_onebit_ef']['losses']}")
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
                            "ring_presum": calls * chunks}}
    for leg, w in want.items():
        got = per_rank[0][leg]["launches"]
        w = {**w, **{k: per_layer for k in TRAIN}}
        bad = {k: (got[k], v) for k, v in w.items() if got[k] != v}
        if bad:
            raise AssertionError(f"train_ring {leg}: launches (got, want) "
                                 f"{bad}")
    tokens = n * B * S
    legs_out = {}
    for leg, tier, comp in TRAIN_RING_LEGS:
        step_ms = max(sum(r[leg]["step_ms_each"]) / steps for r in per_rank)
        legs_out[leg] = {
            "tier": tier, "compression": comp,
            "losses": per_rank[0][leg]["losses"],
            "params_sha1": [r[leg]["params_sha1"] for r in per_rank],
            "step_ms": step_ms,
            "step_ms_each": [r[leg]["step_ms_each"] for r in per_rank],
            "tokens_per_s": tokens / step_ms * 1e3,
            "warmup_s": max(r[leg]["warmup_s"] for r in per_rank),
            "max_memory_allocated_gb": [r[leg]["max_memory_allocated_gb"]
                                        for r in per_rank],
            "launches": per_rank[0][leg]["launches"]}
    emit({"phase": "train_ring", "ranks": n,
          "timing": "two ranks time-slice one card", "batch_per_rank": B,
          "seq": S, "steps": steps, "chunks_per_step": chunks,
          "ring_equals_staged": True, "wall_s": wall, "legs": legs_out})
    total = {}
    for leg, _, _ in TRAIN_RING_LEGS:
        for k, v in per_rank[0][leg]["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


# the DCN legs of train_dcn: the torch adapter's DistributedOptimizer with
# the raw f32 wire, then with the fp16 wire (Compression.fp16)
DCN_LEGS = (("dcn_raw", "none"), ("dcn_fp16", "fp16"))
# fp16 wire against raw, each rank's loss at each step (absolute)
DCN_FP16_LOSS_TOL = 1e-2


def params_digest(leaves) -> str:
    import hashlib

    flat = torch.cat([p.detach().reshape(-1) for p in leaves])
    return hashlib.sha1(flat.cpu().numpy().data).hexdigest()


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
    cfg = GPTConfig.gpt2_medium()
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
        n_bytes = GPT2M_PARAMS * 4
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


def phase_train_dcn(B=4, S=1024, steps=2) -> dict:
    """The DCN parameter-server tier on the card: one server process of the
    port (``python -m byteps_tpu_torch.server``, two workers) and two rank
    processes that time-slice the card, each training GPT-2 medium at full
    width, B=4 × S=1024, bf16 over f32 master weights, one warm-up and
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
    cfg = GPTConfig.gpt2_medium()
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
    emit({"phase": "train_dcn", "ranks": n,
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
    cfg = GPTConfig.gpt2_medium()
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


def phase_train_hybrid(B=4, S=1024, steps=2) -> dict:
    """The eager surface and the hybrid two-tier pipeline on the card: one
    pod of two rank processes time-slicing the card over gloo, and one
    port server process a hybrid leg (``DMLC_NUM_WORKER=1``, the ranks
    with ``BYTEPS_FORCE_DISTRIBUTED=1``: every hybrid stage runs and the
    pod's sums cross the server). Each rank trains GPT-2 medium at full
    width, B=4 × S=1024, bf16 over f32 master weights, one warm-up and
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
    cfg = GPTConfig.gpt2_medium()
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
    n_bytes = GPT2M_PARAMS * 4
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
    emit({"phase": "train_hybrid", "ranks": n, "pods": 1,
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
CHAOS_KNOBS = sorted({k for _, env in CHAOS_LEGS for k in env}
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
    pools and the keys homed on server 1."""
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

    cfg = GPTConfig.gpt2_medium()
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
    for leg, env in CHAOS_LEGS:
        hybrid = leg.startswith("hybrid")
        for k in CHAOS_KNOBS:
            os.environ.pop(k, None)
        os.environ.update(env, DMLC_NUM_WORKER="1" if hybrid else str(n),
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
            tbps.init()
            core = tbps._state.core
            worker = core.worker
            opt = tbps.DistributedOptimizer(adamw(leaves),
                                            params.named_parameters())
            tbps.broadcast_parameters(dict(params.named_parameters()),
                                      root_rank=0)

            def one_step():
                opt.zero_grad()
                loss = gpt_loss(params, tok, tgt, cfg, chunked_ce=True)
                loss.backward()
                opt.step()
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

        def arm_owner_kill():
            o, rule = owner_kill
            plan = FaultPlan(parse_fault_spec(rule), worker_id=o)
            intercept = plan.intercept

            def timed_intercept(op, sidx, tenant=None):
                hit = intercept(op, sidx, tenant)
                if hit is not None and not kills:
                    kills.append(time.time())
                return hit
            plan.intercept = timed_intercept
            eager._state.psworkers[o]._plan = plan

        def between(i):
            if leg in CHAOS_KILL and i == CHAOS_KILL_STEP:
                Path(f"{sigdir}/{leg}.done{rank}").touch()
                out["killed_at"] = float(wait_file(f"{sigdir}/{leg}.killed"))
            if owner_kill is not None and i == CHAOS_KILL_STEP:
                arm_owner_kill()

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
        else:
            out["credits"] = [(s._credits, s._credit_total) for s in
                              (core.scheduler, core._cuda_scheduler) if s]
            tbps.shutdown()
        res[leg] = out
        del opt, params, leaves
        gc.collect()
        torch.cuda.empty_cache()
    return res


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
    ``CHAOS_LEGS`` after staged_raw (see phase 14 in the module's
    docstring). A watcher thread kills a leg's servers (``CHAOS_KILL``)
    once both ranks ended its first timed step and tells them the kill's
    time. Checks: every leg's parameters equal on both ranks and equal to
    staged_raw's after every step, bit for bit; every loss finite; the
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
    bases = {leg: free_port_pair() for leg, _ in CHAOS_LEGS}
    servers = {}
    sigdir = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    stop = threading.Event()
    watch_errors = []

    def watch():
        pending = dict(CHAOS_KILL)
        try:
            while pending and not stop.is_set():
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
        for leg, _ in CHAOS_LEGS:
            workers = "1" if leg.startswith("hybrid") else str(n)
            servers[leg] = [subprocess.Popen(
                [sys.executable, "-m", "byteps_tpu_torch.server"],
                env=dict(os.environ, DMLC_ROLE="server",
                         DMLC_NUM_WORKER=workers, DMLC_NUM_SERVER="2",
                         DMLC_PS_ROOT_URI="127.0.0.1",
                         DMLC_PS_ROOT_PORT=str(bases[leg] - 1),
                         DMLC_SERVER_ID=str(i)),
                cwd=Path(__file__).resolve().parent, stdout=sys.stderr)
                for i in range(2)]
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
    cfg = GPTConfig.gpt2_medium()
    calls = steps + 1
    n_bytes = GPT2M_PARAMS * 4
    legs = ("staged_raw",) + tuple(leg for leg, _ in CHAOS_LEGS)
    for leg in legs:
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
    emit({"phase": "train_chaos", "ranks": n, "servers": "two processes a leg",
          "timing": "two ranks time-slice one card", "batch_per_rank": B,
          "seq": S, "steps": steps, "kill_after_step": CHAOS_KILL_STEP,
          "fault_spec": CHAOS_SPEC, "health": CHAOS_HEALTH,
          "host_cpus": os.cpu_count(), "legs_equal_staged_raw": True,
          "bytes_per_step_fields": ["pushed", "pulled", "d2h", "h2d"],
          "wall_s": wall, "legs": legs_out})
    total = {}
    for leg in legs:
        for k, v in per_rank[0][leg]["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


# the kernels each run of the main path must launch
TRAIN = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
TOPK = ("topk_select", "topk_reconstruct_sum", "topk_roundtrip")
# (serving chunks take the forward's split path: flash_fwd_split)
SPLIT = ("flash_fwd", "flash_fwd_split")
PATHS = {"generate": ("flash_fwd", "flash_decode"), "serve": SPLIT,
         "exact": SPLIT + ("flash_decode",),
         "multitenant": SPLIT + ("segmented_lora",),
         "multitenant_exact": SPLIT + ("segmented_lora",),
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
         "aggregate_onebit": ("onebit_pack", "onebit_unpack_sum_grid")}
MAIN_PATHS = ("generate", "serve", "multitenant", "train_raw",
              "train_onebit", "train_topk", "train_ring", "train_dcn",
              "train_hybrid", "train_chaos", "aggregate_onebit")
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


def counted_ranks(name, fn, *args) -> dict:
    """Run one path of the main path that runs in rank processes: each
    starts with every count at 0, and ``fn`` returns the counts they
    report."""
    return check_path(name, fn(*args))


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
    emit({"phase": "card", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas,
          "sass": {**{n: sass_counts(libs[n]) for n in ("flash_fwd",
                                                        "flash_bwd",
                                                        "flash_decode")},
                   **{n: sass_counts(libs[n], FMA_SASS)
                      for n in ("segmented_lora", "onebit")}}})
    # the bf16 split kernel's tensor-core instantiations (MMA = true)
    tc_split = re.compile(
        r"fwd_split_kernel<__nv_bfloat16, [^,]+, (\(bool\)1|true)[,>]"
        r"|fwd_split_kernelI13__nv_bfloat16Li\d+ELb1E")
    split_sass = {k: c for k, c in sass_counts(libs["flash_fwd"]).items()
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
    by_path["train_raw"] = counted("train_raw", phase_train, "raw", None)
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
    emit({"phase": "launches", **by_path})
    phase_tiny()
    phase_train_tiny()

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
              "split_launches": sum(by_path[p]["flash_fwd_split"]
                                    for p in MAIN_PATHS),
              "split_launches_by_path": {
                  p: c["flash_fwd_split"] for p, c in by_path.items()}}),
            ("flash_decode", "flash_decode",
             "byteps_tpu/ops/flash_decode.py:77", main_dec),
            ("flash_bwd_dq", "flash_bwd",
             "byteps_tpu/ops/flash_attention.py:340",
             {**main_bwd, **main_bwd["dq"]}),
            ("flash_bwd_dkv", "flash_bwd",
             "byteps_tpu/ops/flash_attention.py:399",
             {**main_bwd, **main_bwd["dkv"]}),
            ("onebit_pack", "onebit", "byteps_tpu/ops/onebit_kernels.py:81",
             {"case": "chunk", "max_abs_err": main_bits["pack_max_abs_err"],
              "ms": main_bits["pack_ms"],
              "plain_ms": main_bits["pack_plain_ms"],
              "bound_ms": main_bits["pack_bound_ms"],
              "bound_by": main_bits["pack_bound_by"], "library_ms": None}),
            ("onebit_unpack_sum", "onebit",
             "byteps_tpu/ops/onebit_kernels.py:124",
             {"case": "chunk K=1",
              "max_abs_err": main_bits["unpack_k1_max_abs_err"],
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
             "byteps_tpu/ops/segmented_lora.py:87", lora),
            ("ring_rotate", "ring",
             "byteps_tpu/ops/ring_collective_kernels.py:138",
             ring["ring_rotate"]),
            ("ring_presum", "ring",
             "byteps_tpu/ops/ring_collective_kernels.py:189",
             ring["ring_presum"])]
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"byteps_tpu_torch/ops/csrc/{src}.cu", "replaces": rep,
         "launches": sum(by_path[p][name] for p in MAIN_PATHS),
         "launches_by_path": {p: c[name] for p, c in by_path.items()},
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
                                 "signs_library_ms", "signs_bound_ms")
            if k in main}}
        for name, src, rep, main in rows]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
