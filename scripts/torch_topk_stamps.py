#!/usr/bin/env python3
"""Where a top-k kernel's time goes, from clock stamps, on one CUDA card.

    python3 scripts/torch_topk_stamps.py [--repo DIR]

Builds DIR's ``ops/csrc/topk.cu`` (default: this checkout) with
``-DBPS_TOPK_STAMPS`` into a library of its own beside the kernels'
build: thread 0 of each block writes ``%globaltimer`` at entry, after
its scan (its loads arrived), after the fold across the block and its
cluster, and after its last store is issued. The port's own wrappers
then run on it: the round trip of one 1,024,000-element chunk at (80,
100), (8, 1000) and (1, 8000) with e, and select at the training tail
(101, 5617) and at (100, 10240), each cold (L2 flushed, the launch
queued behind a sleep kernel) and warm (the last of 20 calls issued back
to back). For each it prints the call's ms from CUDA events and, over
the blocks, the min / median / max of each stamp in µs after the first
block's entry: when blocks start, when their data is in, when the fold
ends, when their stores are issued (the rest of ``ms`` is the launch
and the stores draining). One JSON line per case; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

STAGES = ("entry", "scanned", "folded", "stored")


def stamped_lib(_build):
    """topk.cu built with the stamps, named by the sources' digest."""
    out = _build.library_path("topk")
    out = out.with_name(out.name.replace("libtopk-", "libtopk_stamps-"))
    if not out.exists():
        _build.BUILD_DIR.mkdir(exist_ok=True)
        subprocess.run(_build.nvcc_command("topk", out)
                       + ["-DBPS_TOPK_STAMPS"], check=True,
                       capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.bps_topk_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bps_topk_read_stamps.restype = ctypes.c_int
    return lib


def summary(lib, blocks: int) -> dict:
    raw = np.zeros((blocks, 4), np.uint64)
    rc = lib.bps_topk_read_stamps(raw.ctypes.data, blocks)
    if rc != 0:
        raise RuntimeError(f"reading the stamps failed: {rc}")
    rel = (raw.astype(np.int64) - int(raw[:, 0].min())) / 1e3     # µs
    return {st: [float(rel[:, k].min()), float(np.median(rel[:, k])),
                 float(rel[:, k].max())] for k, st in enumerate(STAGES)}


def measure(lib, name, fn, blocks, flush) -> None:
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    fn()
    flush.zero_()
    torch.cuda._sleep(2_000_000)
    ev[0].record()
    fn()
    ev[1].record()
    torch.cuda.synchronize()
    cold = {"ms": ev[0].elapsed_time(ev[1]), **summary(lib, blocks)}
    torch.cuda._sleep(20_000_000)
    for _ in range(19):
        fn()
    ev[0].record()
    fn()
    ev[1].record()
    torch.cuda.synchronize()
    warm = {"ms": ev[0].elapsed_time(ev[1]), **summary(lib, blocks)}
    print(json.dumps({"case": name, "blocks": blocks, "cold": cold,
                      "warm": warm}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve()
                                          .parents[1]),
                    help="checkout whose topk.cu is stamped")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_topk_stamps: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.repo).resolve()))
    from byteps_tpu_torch.ops import _build
    from byteps_tpu_torch.ops import topk_kernels as tk

    lib = stamped_lib(_build)
    _build.load = lambda name: lib       # the wrappers launch the stamped
    tk._lib.cache_clear()                # build from here on
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "repo": str(Path(args.repo).resolve())}),
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    n = 1_024_000
    x = torch.randn(n, generator=g, device="cuda")
    e = 0.1 * torch.randn(n, generator=g, device="cuda")
    for J, G in ((80, 100), (8, 1000), (1, 8000)):
        measure(lib, f"roundtrip {J}x{G} e", lambda: tk.block_roundtrip(
            x, J, G, e), tk.roundtrip_plan(J, G).blocks, flush)
    for block, rows, m in ((101, 5617, 567_296), (100, 10240, n)):
        xs = x[:block * rows].view(block, rows)
        measure(lib, f"select {block}x{rows}",
                lambda: tk.block_select(xs, m),
                tk.select_plan(block, rows).blocks, flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
