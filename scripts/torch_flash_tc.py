#!/usr/bin/env python3
"""The attention kernels on one CUDA card: the bf16 tensor-core forward,
dq and dk/dv, (with ``--decode``) flash decode, and (with ``--split``)
the forward's split path.

    python3 scripts/torch_flash_tc.py [--repo DIR] [--train-only] [--decode]
    python3 scripts/torch_flash_tc.py --split [--repo DIR]

Builds flash_fwd and flash_bwd (and flash_decode) from DIR's sources
(default: this checkout) and prints each library's ptxas report and SASS
counts. Then it runs ``chip_smoke.py``'s forward and backward cases on
the tensor-core paths: each kernel against its plain version at the
smoke's tolerances, kernel / plain / SDPA times from CUDA events with
the L2 cache flushed before each launch, and the two-launch
bit-equality checks. ``--train-only`` keeps the training shape's two
cases (B=8, S=1024, 16 heads of 64, causal: the forward, then dq and
dk/dv). ``--decode`` adds every decode case of the smoke (generate's
step B=4 pos 160, B=8 up to pos 1023 dense and int8, f32, GQA, B=1 pos
1023, the tile edges) and its two-launch check. ``--split`` runs instead
the forward's split-path cases of the smoke (serve's 32-row chunk, the
ragged 37-row chunk, multitenant's 64-row chunk, GQA, head dim 128,
more splits than a cluster holds; bf16 and f32; and the f32 prefills,
which always take it) and its invariance
checks (a chunk's rows bit for bit the same inside a larger chunk,
against more keys, in a batch, launched twice), beside what the timer
reads for zeroing one float. ``--repo`` points at
another checkout (a parent commit unpacked with ``git archive``) so
that two versions are compared on one card in one call: run parent,
change, change, parent. One JSON line per case; exits non-zero if a
case fails or there is no CUDA card.
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
    ap.add_argument("--train-only", action="store_true",
                    help="only the training shape's forward and backward")
    ap.add_argument("--decode", action="store_true",
                    help="also the flash-decode cases")
    ap.add_argument("--split", action="store_true",
                    help="only the forward's split-path cases and its "
                    "invariance checks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_tc: no CUDA device", file=sys.stderr)
        return 1
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    cs = _smoke()
    from byteps_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = _build.build(("flash_fwd",) if args.split else
                        ("flash_fwd", "flash_bwd")
                        + (("flash_decode",) if args.decode else ()))
    ptxas = {n: [ln.strip() for ln in p.with_suffix(".log").read_text()
                 .splitlines() if "registers" in ln or "spill" in ln
                 or "Compiling" in ln or "warning" in ln]
             for n, p in libs.items()}
    cs.emit({"phase": "build", "repo": str(repo),
             "card": cs.card_name_and_limit(), "ptxas": ptxas,
             "sass": {n: cs.sass_counts(p) for n, p in libs.items()}})

    if args.split:
        return split_only(cs)
    bf = torch.bfloat16
    fwd = [(("train", 8, 1024, 1024, 16, 16, 64, 0, bf, 15), {})]
    bwd = [(("train", 8, 1024, 1024, 16, 16, 64, 0, 0, bf, 30), {})]
    twice = []
    if not args.train_only:
        fwd += [(("prefill", 4, 128, 1024, 16, 16, 64, 0, bf, 10), {}),
                (("gqa", 4, 128, 1024, 16, 4, 64, 0, bf, 13), {}),
                (("long_prefill", 1, 700, 1024, 16, 16, 64, 0, bf, 14), {}),
                (("d128", 4, 1024, 1024, 8, 8, 128, 0, bf, 16), {}),
                (("noncausal_ragged", 2, 1000, 1000, 16, 16, 64, 0, bf, 17),
                 {"causal": False})]
        bwd += [(("gqa", 8, 1024, 1024, 16, 4, 64, 0, 0, bf, 32), {}),
                (("ragged", 8, 1000, 1000, 16, 16, 64, 0, 0, bf, 33), {}),
                (("offset_dead_rows", 2, 256, 512, 16, 16, 64, 128, 256, bf,
                  34, True), {}),
                (("tiny_partial", 1, 17, 17, 2, 2, 64, 0, 0, bf, 28), {}),
                (("d128", 4, 1024, 1024, 8, 8, 128, 0, 0, bf, 36), {}),
                (("d128_gqa_offset", 2, 256, 512, 8, 2, 128, 128, 256, bf, 29,
                  True), {}),
                (("noncausal_ragged", 2, 1000, 1000, 16, 16, 64, 0, 0, bf,
                  37), {"causal": False})]
        twice = [("train", 8, 1024, 16, 16, 64, 38),
                 ("d128", 4, 1024, 8, 8, 128, 39)]
    dec = [(case, {}) for case in cs.DECODE_CASES] if args.decode else []
    twice = [(cs.twice_case, case) for case in twice]
    if args.decode:
        twice += [(cs.decode_twice_case, case) for case in cs.DECODE_TWICE]
    timer = cs.Timer()
    failed = []
    for fn, cases in ((cs.fwd_case, fwd), (cs.bwd_case, bwd),
                      (cs.decode_case, dec)):
        for case, kw in cases:
            try:
                fn(timer, *case, **kw)
            except AssertionError as e:      # run every case, then fail
                print(e, file=sys.stderr, flush=True)
                failed.append(f"{fn.__name__} {case[0]}")
    for fn, case in twice:
        try:
            fn(*case)
        except AssertionError as e:
            print(e, file=sys.stderr, flush=True)
            failed.append(f"{fn.__name__} {case[0]}")
    if failed:
        print(f"torch_flash_tc: failed {failed}", file=sys.stderr)
        return 1
    return 0


def split_only(cs) -> int:
    """The split-path cases and the invariance checks; 1 if any failed."""
    timer = cs.Timer()
    one = torch.zeros(1, device="cuda")
    cs.emit({"phase": "timer_floor", "zero_1_ms": timer(one.zero_)})
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(cs.fwd_case, (timer, name, B, Sq, Sk, H, Hkv, 64, q_off, dt,
                            seed))
             for name, B, Sq, Sk, H, Hkv, q_off, dts, seed in (
                 ("chunk", 1, 32, 512, 16, 16, 256, (bf, f32), 11),
                 ("ragged_chunk", 1, 37, 512, 16, 16, 475, (bf, f32), 12),
                 ("prefill", 4, 128, 1024, 16, 16, 0, (f32,), 10),
                 ("gqa", 4, 128, 1024, 16, 4, 0, (f32,), 13),
                 ("long_prefill", 1, 700, 1024, 16, 16, 0, (f32,), 14))
             for dt in dts]
    cases += [(cs.fwd_case, (timer, name, B, Sq, Sk, H, Hkv, D, q_off,
                             cs.DTYPES[dt], seed))
              for name, B, Sq, Sk, H, Hkv, D, q_off, dts, seed
              in cs.SPLIT_CASES for dt in dts]
    cases += [(cs.fwd_invariance, case) for case in cs.INVARIANCE]
    failed = []
    for fn, case in cases:
        try:
            fn(*case)
        except AssertionError as e:      # run every case, then fail
            print(e, file=sys.stderr, flush=True)
            failed.append(f"{fn.__name__} {case[:2]}")
    if failed:
        print(f"torch_flash_tc: failed {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
