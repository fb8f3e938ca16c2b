#!/usr/bin/env python3
"""Whether NCCL takes two ranks on one CUDA card.

    python3 scripts/torch_nccl_one_card.py [--bound 120]

Two rank processes (``spawn``), each on card 0, join one ``nccl`` group
over a ``FileStore`` and all-reduce a tensor of four floats. Prints the
card's name and power limit, then one JSON line: for each rank whether
the collective succeeded and, if not, the first line of its error (NCCL
names a second rank on a device it already serves "Duplicate GPU
detected"). A rank that neither finishes nor fails within ``--bound``
seconds is reported as hung and killed. This is why the hybrid pipeline
of ``byteps_tpu_torch.eager`` keeps a pod of several ranks on one card on
gloo: an NCCL pod needs a card a rank.
"""

from __future__ import annotations

import argparse
import datetime
import json
import shutil
import subprocess
import sys
import tempfile
import time


def rank_main(rank: int, store: str, q) -> None:
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(store, 2),
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=60))
        t = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        q.put({"rank": rank, "ok": True, "sum": t.tolist()})
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 - reported to the parent
        msg = str(e).strip().splitlines()
        q.put({"rank": rank, "ok": False, "error": type(e).__name__,
               "message": next((ln for ln in msg if "Duplicate" in ln),
                               msg[0] if msg else "")})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bound", type=float, default=120.0)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("torch_nccl_one_card: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="nccl_one_card_")
    procs = [ctx.Process(target=rank_main, args=(r, f"{tmp}/store", q))
             for r in range(2)]
    res = {}
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + args.bound
        while len(res) < 2 and time.monotonic() < end:
            try:
                r = q.get(timeout=1.0)
            except Exception:  # noqa: BLE001 - queue.Empty: keep waiting
                continue
            res[r["rank"]] = r
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    ranks = [res.get(r, {"rank": r, "ok": False, "error": "hung",
                         "message": f"no result in {args.bound} s"})
             for r in range(2)]
    print(json.dumps({"nccl": torch.cuda.nccl.version(),
                      "torch": torch.__version__,
                      "two_ranks_one_card_refused":
                          not all(r["ok"] for r in ranks),
                      "ranks": ranks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
