#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``byteps_tpu_torch``) on one card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printing one JSON line:

1. card — name and power limit (``nvidia-smi``), then the kernel build
   (one ``nvcc`` per source, all started together) and its time;
2. flash_fwd — the forward kernel against its plain PyTorch version at
   the slice's prefill shapes, bf16 and f32: error against a stated
   tolerance, and kernel / plain / ``scaled_dot_product_attention``
   times from CUDA events with the L2 cache flushed before each launch;
3. flash_decode — the decode kernel the same way, dense and int8 caches;
4. generate — ``make_generate_fn`` at the full width of GPT-2 medium in
   bf16 (random weights from a seed): B=4, T0=128, 64 new tokens;
5. serve — ``Scheduler.serve`` at the same width, bf16: 8 requests with
   prompts of 40..700 tokens, 32 new tokens each, default block size,
   chunk and batch; every request finishes and no KV block leaks;
6. exact — in f32 at full width, three requests through
   ``Scheduler.serve`` emit exactly the tokens of solo
   ``make_generate_fn`` runs;
7. tiny — a tiny model run on the CPU (plain versions) and on the card
   (kernels) emits the same tokens.

Each of phases 4-6 runs with the launch counters set to 0 just before it
and read just after: generate must launch both kernels, serve the
forward kernel (its decode is the packed plain step; it reaches the
decode kernel only through a one-token prefill chunk), exact both. A
``launches`` line gives the counts per path, then a ``{"kernels": [...]}``
line whose ``launches`` sums generate and serve, and, last,
``{"ok": true, "device": ...}``.
Any failed check raises, so the script exits non-zero and prints no
result; so it does without a CUDA card or without the package beside it.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
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
def fwd_case(timer, name, B, Sq, Sk, H, Hkv, D, q_off, dtype, seed):
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from byteps_tpu_torch.ops.flash_attention import (
        attention_lse_torch, flash_attention_lse)

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
    o, lse = flash_attention_lse(q, k, v, q_off, 0)
    o_ref, lse_ref = attention_lse_torch(q, k, v, q_off, 0)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    err_o, ok_o = max_err(o, o_ref, tol)
    err_l, ok_l = max_err(lse, lse_ref, tol)
    if not (ok_o and ok_l):
        raise AssertionError(f"flash_fwd {name}: o err {err_o}, lse err "
                             f"{err_l} beyond tolerance {tol}")
    ms = timer(lambda: flash_attention_lse(q, k, v, q_off, 0))
    plain_ms = timer(lambda: attention_lse_torch(q, k, v, q_off, 0))
    # the library yardstick: same function (o only) from (B, H, S, D)
    # copies made outside the timing, k/v widened to H heads for GQA
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    mask = (q_off + torch.arange(Sq, device="cuda")[:, None]
            >= torch.arange(Sk, device="cuda")[None, :])
    lib_ms = timer(lambda: sdpa(qt, kt, vt, attn_mask=mask))
    # the work this run's data needs: live (row, key) pairs, live keys
    pairs = sum(min(Sk, max(0, q_off + i + 1)) for i in range(Sq))
    kend = min(Sk, q_off + Sq)
    isz = q.element_size()
    n_bytes = (2 * B * Sq * H * D * isz + 2 * B * kend * Hkv * D * isz
               + B * Sq * H * 4)
    n_ops = 4 * D * pairs * B * H
    bms, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"case": name, "dtype": str(dtype).split(".")[-1],
           "shape": [B, Sq, Sk, H, Hkv, D], "q_off": q_off,
           "max_abs_err": max(err_o, err_l), "tolerance": tol,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bms, "bound_by": by}
    emit({"phase": "flash_fwd", **res})
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


# --------------------------------------------------------------------------
# phases 4-6: the main path
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


# the kernels each run of the main path must launch
PATHS = {"generate": ("flash_fwd", "flash_decode"), "serve": ("flash_fwd",),
         "exact": ("flash_fwd", "flash_decode")}


def counted(name, fn, *args) -> dict:
    """Run one path of the main path with every launch count at 0 just
    before it; return the counts read just after, failing if a kernel
    the path must launch never ran."""
    from byteps_tpu_torch.ops import launches, reset_launches

    reset_launches()
    fn(*args)
    counts = dict(launches)
    missing = [k for k in PATHS[name] if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{name} never launched {missing}: {counts}")
    return counts


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
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
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas})

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
    dec = [decode_case(timer, "main_path", 4, 1024, 16, 16, 64, 160, bf,
                       False, 20)]
    for pos in (0, 100, 700, 1023):
        for quant in (False, True):
            dec.append(decode_case(timer, "b8", 8, 1024, 16, 16, 64, pos, bf,
                                   quant, 21))
    for quant in (False, True):
        dec.append(decode_case(timer, "b8", 8, 1024, 16, 16, 64, 700, f32,
                               quant, 22))
        dec.append(decode_case(timer, "gqa", 8, 1024, 16, 4, 64, 700, bf,
                               quant, 23))
    del timer

    cfg = GPTConfig.gpt2_medium()
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    by_path = {
        "generate": counted("generate", phase_generate, params, cfg),
        "serve": counted("serve", phase_serve, params, cfg),
        "exact": counted("exact", phase_exact, params,
                         dataclasses.replace(cfg, dtype=torch.float32)),
    }
    emit({"phase": "launches", **by_path})
    phase_tiny()

    # the shapes the main path launches most: serve's prefill chunks, and
    # generate's decode steps
    main_fwd = next(r for r in fwd if r["case"] == "chunk")
    main_dec = dec[0]
    common = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"byteps_tpu_torch/ops/csrc/{name}.cu", "replaces": rep,
         "launches": by_path["generate"][name] + by_path["serve"][name],
         "launches_by_path": {p: c[name] for p, c in by_path.items()},
         "case": main["case"], **{k: main[k] for k in common}}
        for name, rep, main in (
            ("flash_fwd", "byteps_tpu/ops/flash_attention.py:207", main_fwd),
            ("flash_decode", "byteps_tpu/ops/flash_decode.py:77", main_dec))]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
