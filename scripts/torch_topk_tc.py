#!/usr/bin/env python3
"""The top-k kernels (select, reconstruct-sum, the round trip) on one CUDA card.

    python3 scripts/torch_topk_tc.py [--repo DIR] [--plans]

Builds topk from DIR's sources (default: this checkout) and prints its
ptxas report (registers, shared memory, spills) and each kernel's SASS
counts. Then it runs ``chip_smoke.py``'s top-k cases (``topk_cases``):
select at (100, 10240) and the ragged tail (101, 5617), reconstruct-sum
at both (also from a 4-byte offset) and at K = 8, and at K = 1, 2, 3
and 8 on no-winner and out-of-range locals, hits of one slot by two and
three payloads and one column of 600,000 rows, the round trip of a
1,024,000-element chunk at (80, 100) with and
without e and at (8, 1000) and (1, 8000) with e, ties, zeros, -0.0, NaN
and inf at the launch plan's thread and block strides, odd and tall
groups, and inputs that start 4 bytes past an aligned address, every
case bit-equal to the plain version; kernel / plain / library times from
CUDA events with the L2 cache flushed before each launch (``ms``), and
200 calls back to back with L2 warm (``warm_ms``), beside what the same
timer reads for zeroing one float and 4 MB and for copying 4 MB.
``--repo`` points at another checkout (a parent commit unpacked with
``git archive``) so that two versions are compared on one card in one
call: run parent, change, change, parent. ``--plans`` runs instead a
sweep of reconstruct-sum's launch plans (stripe heights 1-8, 1-8 warps a
block) at the tail and a chunk, K = 1 and 8. One JSON line per case;
exits non-zero if a case fails or there is no CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    """This checkout's ``chip_smoke.py`` as a module (its cases)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(ROOT),
                    help="checkout whose byteps_tpu_torch is measured")
    ap.add_argument("--plans", action="store_true",
                    help="instead of the cases, time reconstruct-sum on "
                         "every stripe height and block size")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_topk_tc: no CUDA device", file=sys.stderr)
        return 1
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    cs = _smoke()
    from byteps_tpu_torch.ops import _build

    lib = _build.build(("topk",))["topk"]
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln
             or "Compiling" in ln or "warning" in ln]
    cs.emit({"phase": "build", "repo": str(repo),
             "card": cs.card_name_and_limit(), "ptxas": ptxas,
             "sass": cs.sass_counts(lib, cs.CODEC_SASS)})
    timer = cs.Timer()
    one, chunk_f32, dst = (torch.zeros(n, device="cuda")
                           for n in (1, 1024000, 1024000))
    cs.emit({"phase": "timer_floor", "zero_1_ms": timer(one.zero_),
             "zero_4MB_ms": timer(chunk_f32.zero_),
             "copy_4MB_ms": timer(lambda: dst.copy_(chunk_f32)),
             **{f"zero_1_{k}": v for k, v in cs.warm_ms(one.zero_).items()}})
    try:
        if args.plans:
            recon_plans(cs, timer)
        else:
            cs.topk_cases(timer)
    except AssertionError as e:
        print(f"torch_topk_tc: {e}", file=sys.stderr)
        return 1
    return 0


# (K, block, rows) of the sweep: the training tail, a chunk, a chunk at K = 8
PLAN_SHAPES = ((1, 101, 5617), (1, 100, 10240), (8, 100, 10240))


def recon_plans(cs, timer) -> None:
    """Reconstruct-sum at PLAN_SHAPES on other plans than
    ``reconstruct_plan``'s: every stripe height and 1, 2, 4 or 8 warps a
    block, each bit-equal to the plain version, cold ``ms`` and
    ``warm_ms`` (the kernel's C entry called directly)."""
    from byteps_tpu_torch.ops import topk_kernels as tk

    lib = tk._lib()
    stream = torch.cuda.current_stream().cuda_stream
    for K, block, rows in PLAN_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(block + K)
        lo = torch.randint(0, block + 1, (K, rows), generator=g,
                           device="cuda", dtype=torch.int32)
        va = torch.randn(K, rows, generator=g, device="cuda")
        ref = tk._reconstruct_sum_torch(lo, va, block)
        vec = int(rows % 4 == 0)
        for R in range(1, tk._RECON_ROWS + 1):
            for w in (1, 2, 4, 8):
                out = torch.empty(block, rows, device="cuda")

                def call():
                    rc = lib.bps_topk_reconstruct_sum(
                        lo.data_ptr(), va.data_ptr(), out.data_ptr(), K,
                        block, rows, R, 32 * w, vec, stream)
                    if rc != 0:
                        raise AssertionError(f"reconstruct plan R={R} "
                                             f"w={w}: launch error {rc}")
                call()
                torch.cuda.synchronize()
                if not cs.bits_equal(out, ref):
                    raise AssertionError(f"reconstruct plan R={R} w={w} at "
                                         f"{(K, block, rows)}: differs")
                cs.emit({"phase": "recon_plan", "K": K,
                         "shape": [block, rows], "stripe": R, "warps": w,
                         "plan": tk.reconstruct_plan(K, block, rows)
                         ._asdict(), "ms": timer(call),
                         **cs.warm_ms(call)})


if __name__ == "__main__":
    sys.exit(main())
