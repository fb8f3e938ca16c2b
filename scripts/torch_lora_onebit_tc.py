#!/usr/bin/env python3
"""The segmented-LoRA and onebit kernels on one CUDA card.

    python3 scripts/torch_lora_onebit_tc.py [--repo DIR] [--onebit]

Builds segmented_lora and onebit from DIR's sources (default: this
checkout) and prints each library's ptxas report and, per kernel, its
SASS counts (tensor-core and atomic instructions, cp.async, shuffles,
cluster barriers, FMAs and adds). Then it runs ``chip_smoke.py``'s LoRA
cases (every shape of ``LORA_CASES`` against the plain version at the
smoke's tolerances, slot-0 rows exactly 0, two launches bit-equal, and
the batch-invariance checks of ``LORA_INVARIANCE``) and its onebit cases
(pack and unpack-sum at the 1,024,000-element chunk and a ragged
1,000,003 at K = 1, 2, 8, 32 and, in the grid order, 33, 40, 41, 129 and
256, bit for bit; pack on -0.0, 0 and NaN and from a 4-byte offset at
the chunk, n = 4097 and n = 33; the short lengths and an odd word count
with a zero scale at K = 1 to 256; NaN and inf scales, non-finite
elements by position; the aggregation tier's decompress-sum of 40 and
256 workers' compressed chunks, one grid launch each): kernel / plain /
library times from CUDA events with the L2 cache flushed before each
launch, beside what the same timer reads for zeroing one float and 4 MB
and for copying 4 MB. The onebit SASS counts give every instruction of
each kernel ("ALL") beside its adds, and from them the grid
unpack-sum's issue time at K = 40 and 256.
``--repo`` points at another checkout (a parent commit unpacked with
``git archive``) so that two versions are compared on one card in one
call: run parent, change, change, parent. ``--onebit`` runs only the
onebit cases. One JSON line per case; exits non-zero if a case fails or
there is no CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
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


def issue_estimate(sass: dict, n: int = 4096000 // 4) -> dict:
    """The grid unpack-sum's issue time at K = 40 and 256 on a chunk, as
    its SASS gives it: every add (K terms and ceil(K / 8) partials an
    element) costs the kernel's instructions over its adds (loop set-up
    and stores included, so a little high), issued at 128 lanes a clock
    on each SM at the card's top SM clock (``nvidia-smi``)."""
    grid = next((c for k, c in sass.items()
                 if k.startswith("unpack_sum_grid_kernel")), None)
    if not grid or not grid["FADD"]:
        return {}
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_add = grid["ALL"] / grid["FADD"]
    out = {"instructions_per_add": per_add, "sm_mhz": mhz, "sms": sms}
    for K in (40, 256):
        adds = n * (K + -(-K // 8))
        out[f"k{K}_issue_us"] = adds * per_add / (128 * sms * mhz)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(ROOT),
                    help="checkout whose byteps_tpu_torch is measured")
    ap.add_argument("--onebit", action="store_true",
                    help="run only the onebit cases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_lora_onebit_tc: no CUDA device", file=sys.stderr)
        return 1
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    cs = _smoke()
    from byteps_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = _build.build(("segmented_lora", "onebit"))
    ptxas = {n: [ln.strip() for ln in p.with_suffix(".log").read_text()
                 .splitlines() if "registers" in ln or "spill" in ln
                 or "Compiling" in ln or "warning" in ln]
             for n, p in libs.items()}
    sass = {"segmented_lora": cs.sass_counts(libs["segmented_lora"],
                                             cs.FMA_SASS),
            "onebit": cs.sass_counts(libs["onebit"], cs.CODEC_SASS)}
    cs.emit({"phase": "build", "repo": str(repo),
             "card": cs.card_name_and_limit(), "ptxas": ptxas,
             "sass": sass, "issue": issue_estimate(sass["onebit"])})

    timer = cs.Timer()
    # what the timer reads for any launch: one float zeroed, a chunk's 4
    # MB of output written, and a chunk's 4 MB read and written (copy_)
    one, chunk_f32, dst = (torch.zeros(n, device="cuda")
                           for n in (1, 1024000, 1024000))
    cs.emit({"phase": "timer_floor", "zero_1_ms": timer(one.zero_),
             "zero_4MB_ms": timer(chunk_f32.zero_),
             "copy_4MB_ms": timer(lambda: dst.copy_(chunk_f32))})
    chunk = 4096000 // 4           # one default partition of f32
    lora = ([] if args.onebit else
            [(cs.lora_case, (timer, *c)) for c in cs.LORA_CASES]
            + [(cs.lora_invariance_case, c) for c in cs.LORA_INVARIANCE])
    cases = (lora
             + [(cs.onebit_case, (timer, "chunk", chunk, 40)),
                (cs.onebit_case, (timer, "ragged", 1_000_003, 41)),
                (cs.onebit_case, (timer, "signed_zero_nan", 1_000_003, 42,
                                  True)),
                (cs.pack_unaligned_cases, (timer,)),
                (cs.unpack_edge_cases, ()),
                (cs.unpack_nonfinite_cases, ()),
                (cs.phase_aggregate_onebit, ())])
    failed = []
    for fn, case in cases:
        try:
            fn(*case)
        except AssertionError as e:      # run every case, then fail
            print(e, file=sys.stderr, flush=True)
            failed.append(f"{fn.__name__} {case[1:3]}")
    if failed:
        print(f"torch_lora_onebit_tc: failed {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
