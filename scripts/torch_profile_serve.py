#!/usr/bin/env python3
"""Where the time goes on the port's serving path, on one CUDA card.

    python3 scripts/torch_profile_serve.py [--multitenant] [--repo DIR] [--out bench_results/torch_profile_serve.json]

Runs GPT-2 medium (bf16, random weights from a seed) through
``make_generate_fn`` (B=4, T0=128, 16 new tokens) and ``Scheduler.serve``
(8 requests of 40..700 prompt tokens, 16 new tokens each) under
``torch.profiler``, after one unprofiled warm-up run of each. For each
it reports the host wall time, the summed device time of every kernel,
their ratio (the device's busy share; the rest is the card waiting on
the host), the number of kernel launches, and the kernels that took the
most device time. ``--multitenant`` profiles instead one multiplexed
pass of ``chip_smoke.py``'s LoRA race (32 adapters on wq/wv, ranks
2/4/8 in a 33-slot pool, 32 tenants' requests of 16/64/128 prompt
tokens and 16 new tokens, max_batch 16, prefill chunk 64) and adds the
device time by group (the port's kernels by name, GEMMs, the rest) and
the number of packed decode steps and prefill chunks. Every run also
reports the kernel launches by group and the port's launch counters
over the profiled pass (``calls``: ``flash_fwd``, and ``flash_fwd_split``
where the tree counts its split path), so the forward's device ms and
launches a pass read off one line. ``--repo`` profiles another
checkout's ``byteps_tpu_torch`` (a parent commit unpacked with ``git
archive``), so two trees are compared in one call. Needs a CUDA card;
prints one JSON line per run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo

from torch_profile_train import _group  # noqa: E402  (this script's dir)


def _kernel_stats(prof, top: int = 12) -> dict:
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    total_us = sum(e.self_device_time_total for e in rows)
    groups: dict = {}
    counts: dict = {}
    for e in rows:
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total * 1e-3
        counts[g] = counts.get(g, 0) + e.count
    rows.sort(key=lambda e: -e.self_device_time_total)
    return {"device_us": total_us,
            "launches": sum(e.count for e in rows),
            "device_ms_by_group": dict(sorted(groups.items(),
                                              key=lambda kv: -kv[1])),
            "launches_by_group": counts,
            "top": [{"kernel": e.key[:90], "count": e.count,
                     "device_us": e.self_device_time_total}
                    for e in rows[:top]]}


def _profiled(fn) -> dict:
    from byteps_tpu_torch.ops import launches, reset_launches

    fn()                                   # warm-up: builds, allocator
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    calls = {k: v for k, v in launches.items() if v}
    stats = _kernel_stats(prof)
    stats["calls"] = calls
    stats["wall_s"] = wall_s
    stats["device_busy_share"] = stats["device_us"] * 1e-6 / wall_s
    return stats


def _multitenant(params, cfg) -> dict:
    """One multiplexed pass of the smoke's LoRA race, profiled."""
    from byteps_tpu_torch.models.lora import lora_init
    from byteps_tpu_torch.serve import AdapterPool, Request, Scheduler

    n, targets = 32, ("wq", "wv")
    pool = AdapterPool(cfg, n_slots=n + 1, rank_bucket=8, targets=targets)
    for j in range(n):
        g = torch.Generator(device="cuda").manual_seed(1000 + j)
        ad = lora_init(cfg, (2, 4, 8)[j % 3], targets, generator=g)
        for blk in ad["blocks"]:
            for ab in blk.values():
                ab["b"] = 0.02 * torch.randn(ab["b"].shape, generator=g,
                                             device="cuda")
        pool.register(f"a{j}", ad)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (16, 64, 128)[j % 3])
               .astype(np.int32) for j in range(n)]
    calls = {"decode_steps": 0, "prefill_chunks": 0}

    def serve():
        sched = Scheduler(params, cfg, adapter_pool=pool, max_batch=16,
                          prefill_chunk=64)
        for attr, key in (("_decode", "decode_steps"),
                          ("_prefill", "prefill_chunks")):
            def counted(*a, _fn=getattr(sched, attr), _key=key, **kw):
                calls[_key] += 1
                return _fn(*a, **kw)
            setattr(sched, attr, counted)
        sched.serve([Request(rid=j, prompt=p, max_new=16, tenant=f"t{j}",
                             adapter=f"a{j}") for j, p in enumerate(prompts)])

    stats = _profiled(serve)
    # the warm-up and the profiled pass counted alike
    stats.update({k: v // 2 for k, v in calls.items()})
    return stats


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multitenant", action="store_true",
                    help="profile one multiplexed pass of the LoRA race "
                    "instead of generate and serve")
    ap.add_argument("--repo", default=str(Path(__file__).resolve()
                                          .parents[1]),
                    help="checkout whose byteps_tpu_torch is profiled")
    ap.add_argument("--out", default="bench_results/torch_profile_serve.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_serve: no CUDA device")
    sys.path.insert(0, str(Path(args.repo).resolve()))
    from byteps_tpu_torch.models import GPTConfig, gpt_init, make_generate_fn
    from byteps_tpu_torch.serve import Request, Scheduler

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = GPTConfig.gpt2_medium()
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    if args.multitenant:
        out = {"card": card, "repo": str(Path(args.repo).resolve()),
               "multitenant": _multitenant(params, cfg)}
        print(json.dumps({"run": "multitenant", **out["multitenant"],
                          "card": card}), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        return 0
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    gen = make_generate_fn(cfg, 16)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in np.linspace(40, 700, 8).astype(int)]

    def serve():
        Scheduler(params, cfg).serve(
            [Request(rid=i, prompt=p, max_new=16)
             for i, p in enumerate(prompts)])

    out = {"card": card, "repo": str(Path(args.repo).resolve()),
           "generate": _profiled(lambda: gen(params, prompt)),
           "serve": _profiled(serve)}
    for name in ("generate", "serve"):
        print(json.dumps({"run": name, "card": card, **out[name]}),
              flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
