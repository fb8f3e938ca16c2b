#!/usr/bin/env python3
"""Where the time goes in the port's training step, on one CUDA card.

    python3 scripts/torch_profile_train.py [--steps 3] [--legs raw,onebit_ef,topk_block_ef] [--repo DIR] [--out bench_results/torch_profile_train.json]

Builds ``make_gpt_train_step`` at the full width and depth of GPT-2
medium (bf16 activations over f32 master weights, AdamW(1e-3), random
weights from a seed) on one seeded batch of B=8 x S=1024, for three
legs: raw aggregation, onebit with error feedback, and top-k (block,
k = 0.01) with error feedback. Each leg runs one
warm-up step, ``--steps`` timed steps without the profiler, then
``--steps`` steps under ``torch.profiler``. For each leg it reports the
wall time per step without and with the profiler (whose host-side
tracing slows the host, not the kernels), the summed device time of
every kernel per step, the device's busy share (that device time over
the unprofiled wall time), the kernel launches per step, the device
time per step by group (the port's hand-written kernels one by one,
GEMMs, everything else), the launches per step by group and the kernels
that took the most device time. ``--legs`` picks legs by name; ``--repo``
profiles another checkout's ``byteps_tpu_torch`` (a parent commit
unpacked with ``git archive``), so two trees are compared in one call.
Needs a CUDA card; prints one JSON line per leg.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo

# the port's hand-written kernels by their CUDA names (every path: the
# forward's fwd_split and fwd_wgmma, dq_wgmma, dkv_wgmma; fwd and merge,
# the forward's two-launch split path of earlier trees, so that a profile
# of such a tree with --repo counts it too), in the launch counters' names
OWN = {"flash_fwd": r"\b(fwd|fwd_split|fwd_wgmma|merge)_kernel\b",
       "flash_decode": r"\bdecode_kernel\b",
       "segmented_lora": r"\bsegmented_lora_kernel\b",
       "flash_bwd_dq": r"\bdq(_wgmma)?_kernel\b",
       "flash_bwd_dkv": r"\bdkv(_wgmma)?_kernel\b",
       "onebit_pack": r"\bpack_kernel\b",
       "onebit_unpack_sum": r"\bunpack_sum_kernel\b",
       "onebit_unpack_sum_grid": r"\bunpack_sum_grid_kernel\b",
       "topk_select": r"\bselect_kernel\b",
       "topk_reconstruct_sum": r"\breconstruct_sum_kernel\b",
       "topk_roundtrip": r"\broundtrip_kernel\b"}
GEMM = ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "sm80_")


def _group(name: str) -> str:
    for k, pat in OWN.items():
        if re.search(pat, name):
            return k
    if any(f in name.lower() for f in GEMM):
        return "gemm"
    return "other"


def _profiled_leg(compression, steps: int, B: int, S: int) -> dict:
    from byteps_tpu_torch.models import (GPTConfig, make_gpt_train_step,
                                         synthetic_batch)

    cfg = GPTConfig.gpt2_medium()
    step, params, opt = make_gpt_train_step(
        cfg, compression_params=compression,
        generator=torch.Generator(device="cuda").manual_seed(0))
    tok, tgt = synthetic_batch(torch.Generator(device="cuda").manual_seed(1),
                               cfg, B, S)
    step(tok, tgt)                       # warm-up: builds, allocator

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step(tok, tgt)
        torch.cuda.synchronize()
        return loss, (time.perf_counter() - t0) / steps

    _, wall_s = timed()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss, prof_wall_s = timed()
    # device work only: a user annotation (the optimizer's
    # ``Optimizer.step#AdamW.step`` range) spans kernels counted already
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    total_us = sum(e.self_device_time_total for e in rows) / steps
    groups: dict = {}
    counts: dict = {}
    for e in rows:
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / steps
        counts[g] = counts.get(g, 0) + e.count / steps
    rows.sort(key=lambda e: -e.self_device_time_total)
    del step, params, opt
    torch.cuda.empty_cache()
    return {"compression": compression, "batch": B, "seq": S,
            "loss": float(loss), "wall_ms_per_step": wall_s * 1e3,
            "profiled_wall_ms_per_step": prof_wall_s * 1e3,
            "device_ms_per_step": total_us * 1e-3,
            "device_busy_share": total_us * 1e-6 / wall_s,
            "launches_per_step": sum(e.count for e in rows) / steps,
            "device_ms_by_group": {k: v * 1e-3 for k, v in
                                   sorted(groups.items(),
                                          key=lambda kv: -kv[1])},
            "launches_per_step_by_group": counts,
            "top": [{"kernel": e.key[:90], "count": e.count // steps,
                     "device_ms": e.self_device_time_total * 1e-3 / steps}
                    for e in rows[:15]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--legs", default="raw,onebit_ef,topk_block_ef",
                    help="comma-separated legs to profile")
    ap.add_argument("--repo", default=str(Path(__file__).resolve()
                                          .parents[1]),
                    help="checkout whose byteps_tpu_torch is profiled")
    ap.add_argument("--out", default="bench_results/torch_profile_train.json")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_train: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": card, "repo": str(Path(args.repo).resolve())}
    legs = {"raw": None,
            "onebit_ef": {"compressor": "onebit", "ef": "vanilla"},
            "topk_block_ef": {"compressor": "topk", "k": 0.01,
                              "ef": "vanilla", "selection": "block"}}
    for leg in args.legs.split(","):
        out[leg] = _profiled_leg(legs[leg], args.steps, 8, 1024)
        print(json.dumps({"leg": leg, "card": card, **out[leg]}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
