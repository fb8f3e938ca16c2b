#!/usr/bin/env python3
"""Two ranks on one CUDA card: what the ring kernels meet there.

    python3 scripts/torch_ring_probe.py [--calls 200]
    python3 scripts/torch_ring_probe.py --train 2

Starts two rank processes (``spawn``) on card 0 that share a ``gloo``
group over a ``FileStore``, and reports, one JSON line each:

* the card's compute mode, and that each rank opened the other's
  workspace through CUDA IPC (``RingWorkspace``);
* the ring kernels (``ring_collect``, ``ring_allgather``, ``ring_presum``)
  at a onebit chunk's rows (16,000 words), against the rows each rank
  knows the other sent;
* the median time per call, host clock around call and synchronize,
  with the ranks meeting on the host before each launch
  (``RingWorkspace.rendezvous``) and without (the default: each kernel
  may spin while the other rank's context still has work queued);
* what a spinning kernel costs the other context: the median time of a
  small kernel plus synchronize on rank 1, alone and while rank 0's
  kernel waits for rank 1's flags;
* whether gloo takes CUDA tensors for ``all_to_all_single``,
  ``all_gather`` and ``all_reduce`` (the staged tier's collectives).

With ``--train STEPS`` it runs instead the ring onebit + EF training leg
of ``chip_smoke.py``'s train_ring (GPT-2 medium, two ranks on the card)
with the ring workspace's host rendezvous on, off, off and on, and
reports each leg's step times; the legs' losses and parameters must
agree.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo


def _timed(fn, calls):
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _rank(rank: int, store: str, calls: int, q) -> None:
    try:
        from byteps_tpu_torch.ops import ring_collective_kernels as rk

        dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                                rank=rank, world_size=2)
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        res = {"rank": rank}
        ws = rk.workspace(dev)
        words = 16000
        x = (torch.arange(2 * words, device=dev, dtype=torch.int32)
             .reshape(2, words) + 100000 * rank)
        other = (torch.arange(2 * words, device=dev, dtype=torch.int32)
                 .reshape(2, words) + 100000 * (1 - rank))
        got = rk.ring_collect(x)
        res["collect_ok"] = bool(torch.equal(got[rank], x[rank])
                                 and torch.equal(got[1 - rank], other[rank]))
        got = rk.ring_allgather(x[0])
        res["gather_ok"] = bool(torch.equal(got[rank], x[0])
                                and torch.equal(got[1 - rank], other[0]))
        xf = x.float()
        got = rk.ring_presum(xf)
        res["presum_ok"] = bool(torch.equal(got, other.float()[rank]
                                            + xf[rank]))
        for co in (True, False):
            ws.rendezvous = co
            dist.barrier()
            res[f"collect_ms_rendezvous_{co}"] = _timed(
                lambda: rk.ring_collect(x), calls)
            dist.barrier()
            res[f"presum_ms_rendezvous_{co}"] = _timed(
                lambda: rk.ring_presum(xf), calls)
        small = torch.zeros(1024, device=dev)
        dist.barrier()
        if rank == 1:
            res["small_kernel_ms_alone"] = _timed(lambda: small.add_(1),
                                                  calls)
        dist.barrier()
        # rank 0's kernel waits for rank 1's flags while rank 1 runs
        # small kernels, then launches its own
        dist.barrier()
        if rank == 0:
            rk.ring_collect(x)
            torch.cuda.synchronize()
        else:
            time.sleep(0.05)
            res["small_kernel_ms_beside_spinner"] = _timed(
                lambda: small.add_(1), min(calls, 50))
            rk.ring_collect(x)
            torch.cuda.synchronize()
        # gloo with CUDA tensors
        for name, fn in (
                ("all_to_all_single", lambda: dist.all_to_all_single(
                    torch.empty_like(x), x)),
                ("all_gather", lambda: dist.all_gather(
                    [torch.empty_like(x[0]) for _ in range(2)], x[0])),
                ("all_reduce", lambda: dist.all_reduce(xf.clone()))):
            try:
                res[f"gloo_cuda_{name}_ms"] = _timed(fn, 20)
            except Exception as e:           # reported, not hidden
                res[f"gloo_cuda_{name}"] = f"refused: {e}"
        res["errors"] = rk.ring_errors()
        rk.close_workspaces()
        dist.destroy_process_group()
        q.put(res)
    except Exception:
        q.put({"rank": rank, "failed": traceback.format_exc()})


def _train_rank(rank: int, store: str, steps: int, q) -> None:
    """The ring onebit + EF leg of chip_smoke.py's train_ring (GPT-2
    medium, B=4 × S=1024 a rank, bf16 over f32 master weights, AdamW),
    with the workspace's host rendezvous on, off, off and on: one warm-up
    and ``steps`` timed steps a leg, host clock around step and
    synchronize; every leg's losses and parameters must agree."""
    try:
        import hashlib

        from byteps_tpu_torch.common.config import reset_config
        from byteps_tpu_torch.models import (GPTConfig, make_gpt_train_step,
                                             synthetic_batch)
        from byteps_tpu_torch.ops import ring_collective_kernels as rk

        os.environ["BYTEPS_ICI_TIER"] = "ring"
        reset_config()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                                rank=rank, world_size=2)
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        cfg = GPTConfig.gpt2_medium()
        res = {"rank": rank, "legs": []}
        for on in (True, False, False, True):
            rk.workspace(dev).rendezvous = on
            step, params, opt = make_gpt_train_step(
                cfg, compression_params={"compressor": "onebit",
                                         "ef": "vanilla"},
                generator=torch.Generator(device="cuda").manual_seed(0))
            tok, tgt = synthetic_batch(
                torch.Generator(device="cuda").manual_seed(1 + rank), cfg,
                4, 1024)
            losses, ms = [], []
            for _ in range(steps + 1):
                t0 = time.perf_counter()
                losses.append(float(step(tok, tgt)))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            flat = torch.cat([p.detach().reshape(-1) for p in opt.params])
            res["legs"].append({
                "rendezvous": on, "losses": losses, "warmup_ms": ms[0],
                "step_ms_each": ms[1:],
                "params_sha1": hashlib.sha1(
                    flat.cpu().numpy().data).hexdigest()})
            del step, params, opt, flat
            torch.cuda.empty_cache()
        res["errors"] = rk.ring_errors()
        rk.close_workspaces()
        dist.destroy_process_group()
        q.put(res)
    except Exception:
        q.put({"rank": rank, "failed": traceback.format_exc()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--train", type=int, default=0, metavar="STEPS",
                    help="instead: the ring onebit + EF training leg with "
                         "the host rendezvous on and off, STEPS timed "
                         "steps a leg")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ring_probe: no CUDA device", file=sys.stderr)
        return 1
    from byteps_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build(("ring",))["ring"]
    print(json.dumps({
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "build_s": time.perf_counter() - t0,
        "ptxas": [ln.strip() for ln in lib.with_suffix(".log").read_text()
                  .splitlines() if "registers" in ln or "spill" in ln]}),
        flush=True)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(), "store")
    body, arg = (_train_rank, args.train) if args.train else (_rank,
                                                               args.calls)
    procs = [ctx.Process(target=body, args=(r, store, arg, q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        res = [q.get(timeout=1200) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    ok = True
    for r in sorted(res, key=lambda r: r["rank"]):
        print(json.dumps(r), flush=True)
        if args.train:
            ok &= "failed" not in r and len(
                {(str(lg["losses"]), lg["params_sha1"])
                 for lg in r["legs"]}) == 1
        else:
            ok &= "failed" not in r and all(r.get(k) for k in (
                "collect_ok", "gather_ok", "presum_ok"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
