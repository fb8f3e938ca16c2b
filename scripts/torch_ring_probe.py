#!/usr/bin/env python3
"""What a ring call costs when two ranks share one CUDA card, by form.

    python3 scripts/torch_ring_probe.py [--repo DIR] [--calls 200]
    python3 scripts/torch_ring_probe.py --cards [--calls 200]

For this checkout, and for the checkout at ``--repo`` (e.g. the parent
commit unpacked, timed in the same call), two layouts of two ranks on
card 0:

* processes: two rank processes (``spawn``) in one ``gloo`` group over a
  ``FileStore``, mapping each other's ``RingWorkspace`` through CUDA IPC,
  as ``chip_smoke.py``'s train_ring runs them: the card time-slices the
  two contexts;
* in-process: one process holding both ranks' workspaces, each rank on a
  stream of its own (``LocalPeers``), so both run at once.

Forms, each at a onebit row of 64,000 bytes (16,000 words: a 1,024,000
chunk's segment at n = 2) for collect and gather, and randomk's 5,120 f32
values for presum:

1. ``spin``: the checkout at ``--repo`` when it has no tree calls (the
   earlier kernels: a flag a block, a trap after 30 s);
2. ``stream``: a push kernel, ``cuStreamWaitValue32`` (EQ, the epoch) on
   the rank's own flags, a land kernel, also the onebit payload's two
   leaves (signs and scale) in one ``ring_collect_tree`` call;
3. ``stream_flush``: form 2 with ``CU_STREAM_WAIT_VALUE_FLUSH``, where
   the device supports it;
4. ``switch``: an empty push bounced between the ranks (rank 0 signals
   then its stream waits, rank 1 waits then signals): half a round trip
   is the card's cost of one switch between the contexts;

and, in-process, this checkout's one-flag spinning kernel
(``spin_one_flag``: the protocol ``plan`` gives peers whose contexts run
at once).

With ``--cards``: one rank process a card on every card of the machine
(peers over NVLink, the ``other_cards`` layout), this checkout only: the
calls checked against what the other ranks sent, timed under the plan's
protocol (``spin``) and under ``stream``.

Per form: ``*_ms``, host clock around ``calls`` calls issued back to back
and a synchronize, per call (the regime of a training step);
``*_ms_event``, the median of CUDA events around one bare call after the
ranks drain their streams and meet at a ``dist.barrier`` (the smoke's
``ms_time_sliced``); in-process, the median of CUDA events around a call
of both ranks, issued while a sleep kernel holds the card (the smoke's
``ms``). Every output is checked against what the other ranks sent.
One JSON line for the card, then one a checkout, layout and rank.

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
import types
from pathlib import Path

import torch
import torch.multiprocessing as mp

REPO = Path(__file__).resolve().parents[1]
WORDS = 16000                # a onebit row at n = 2, 64,000 bytes
VALUES = 5120                # randomk's k = 0.01 of a 512,000 segment


def _import(repo: str):
    """The ring module of the checkout at ``repo`` (a fresh process)."""
    sys.path.insert(0, repo)
    from byteps_tpu_torch.ops import ring_collective_kernels as rk
    return rk


def _rows(rank: int, n: int, dev) -> torch.Tensor:
    """Rank ``rank``'s (n, WORDS) int32 rows: every value below 2^24, so
    f32 sums of them are exact."""
    return (torch.arange(n * WORDS, device=dev, dtype=torch.int32)
            .reshape(n, WORDS) + 100000 * rank)


def _progress(res: dict) -> None:
    """A rank's results so far, on stderr (what is left if a call hangs)."""
    print(json.dumps({"progress": res}), file=sys.stderr, flush=True)


def _back_to_back(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


# --------------------------------------------------------------------------
# rank processes
# --------------------------------------------------------------------------
def _rank(rank: int, n: int, repo: str, store: str, calls: int,
          cards: bool, q) -> None:
    try:
        import datetime

        import torch.distributed as dist

        rk = _import(repo)
        dist.init_process_group("gloo", store=dist.FileStore(store, n),
                                rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=120))
        dev = torch.device("cuda", rank if cards else 0)
        torch.cuda.set_device(dev)
        new = hasattr(rk, "ring_collect_tree")
        ws = rk.workspace(dev)
        x = _rows(rank, n, dev)
        every = [_rows(s, n, dev) for s in range(n)]
        xf = x[:, :VALUES].float()
        res = {"rank": rank, "ranks": n, "card": str(dev)}
        got = rk.ring_collect(x)
        res["collect_ok"] = all(torch.equal(got[s], every[s][rank])
                                for s in range(n))
        got = rk.ring_allgather(x[0])
        res["gather_ok"] = all(torch.equal(got[s], every[s][0])
                               for s in range(n))
        got = rk.ring_presum(xf)
        res["presum_ok"] = bool(torch.equal(got, sum(
            e[rank, :VALUES].float() for e in every)))
        out = torch.empty_like(x)
        outg = torch.empty_like(x)
        outf = torch.empty_like(xf[0])

        def bare(op, flush=False):
            def call(epoch):
                if flush:            # the stream form, its waits flushing
                    if op == "presum":
                        for t in range(n):
                            if t:
                                rk.wait_flag(ws, (epoch & 1) * n + t, epoch,
                                             True)
                            rk.launch_presum_hop(ws, xf, outf, n, rank, t,
                                                 epoch)
                        return
                    lv = [(x, out, 0)]
                    rk.launch_push(ws, lv, n, rank, False, epoch)
                    for f in rk.rotate_flags(n, rank, epoch):
                        rk.wait_flag(ws, f, epoch, True)
                    rk.launch_land(ws, lv, n, rank, epoch)
                elif op == "presum":
                    rk.launch_presum(ws, xf, outf, n, rank, epoch)
                elif new:
                    rk.launch_rotate(ws, [(x if op == "collect" else x[0],
                                           out if op == "collect" else outg,
                                           0)], n, rank, op == "gather",
                                     epoch)
                else:
                    rk.launch_rotate(ws, x if op == "collect" else x[0],
                                     out if op == "collect" else outg, n,
                                     rank, op == "gather", epoch)
            return call

        def event_ms(call, nbytes):
            evs = []
            for _ in range(min(calls, 50)):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                epoch = ws.prepare(nbytes)
                torch.cuda.current_stream().synchronize()
                dist.barrier()
                ev[0].record()
                call(epoch)
                ev[1].record()
                evs.append(ev)
            torch.cuda.synchronize()
            return statistics.median(a.elapsed_time(b) for a, b in evs)

        def timed(flush=False):
            form = {}
            for op, nbytes, fn in (
                    ("collect", 4 * WORDS, lambda: rk.ring_collect(x)),
                    ("gather", 4 * WORDS, lambda: rk.ring_allgather(x[0])),
                    ("presum", 4 * VALUES, lambda: rk.ring_presum(xf))):
                if flush and op == "gather":
                    continue
                call = bare(op, flush)
                dist.barrier()
                form[f"{op}_ms"] = _back_to_back(
                    (lambda: call(ws.prepare(nbytes))) if flush else fn,
                    calls)
                dist.barrier()
                form[f"{op}_ms_event"] = event_ms(call, nbytes)
            return form

        if not new:
            res["spin"] = timed()
        else:
            res["layout"], res["plan"] = ws.layout, ws.protocol
            tree = {"signs": x, "scale": xf[:, :1].contiguous()}
            got = rk.ring_collect_tree(tree)
            res["tree_ok"] = all(
                torch.equal(got["signs"][s], every[s][rank])
                and torch.equal(got["scale"][s], every[s][rank, :1].float())
                for s in range(n))
            _progress(res)
            for protocol in dict.fromkeys((ws.protocol, "stream")):
                ws.protocol = protocol
                res[protocol] = timed()
                _progress(res)
                dist.barrier()
                res[protocol]["collect_tree_ms"] = _back_to_back(
                    lambda: rk.ring_collect_tree(tree), calls)
            if not ws.can_flush:
                res["stream_flush"] = (
                    "unsupported: CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES"
                    " is 0")
            elif not cards:
                res["stream_flush"] = timed(flush=True)
            if n == 2 and not cards:
                dist.barrier()

                def bounce():
                    epoch = ws.prepare(0)
                    p = (epoch & 1) * 2
                    if rank == 0:
                        rk.launch_push(ws, [], 2, 0, False, epoch)
                        rk.wait_flag(ws, p + 1, epoch)
                    else:
                        rk.wait_flag(ws, p, epoch)
                        rk.launch_push(ws, [], 2, 1, False, epoch)
                trip = _back_to_back(bounce, calls)
                res["switch"] = {"round_trip_ms": trip, "switch_ms": trip / 2}
        res["errors"] = rk.ring_errors()
        rk.close_workspaces()
        dist.destroy_process_group()
        q.put(res)
    except Exception:
        q.put({"rank": rank, "failed": traceback.format_exc()})


# --------------------------------------------------------------------------
# both ranks in one process
# --------------------------------------------------------------------------
def _local(repo: str, calls: int, q) -> None:
    try:
        rk = _import(repo)
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        n = 2
        xs = [_rows(r, n, dev) for r in range(n)]
        xfs = [x[:, :VALUES].float() for x in xs]
        outs = [torch.empty_like(x) for x in xs]
        outfs = [torch.empty_like(xf[0]) for xf in xfs]

        def event_ms(calls_by_op, op):
            evs = []
            for _ in range(calls):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                torch.cuda._sleep(2_000_000)
                ev[0].record()
                calls_by_op[op]()
                ev[1].record()
                evs.append(ev)
            torch.cuda.synchronize()
            if op == "collect":
                ok = all(torch.equal(outs[r][s], xs[s][r])
                         for r in range(n) for s in range(n))
            elif op == "presum":
                ok = all(torch.equal(outfs[r], xfs[(r + 1) % n][r]
                                     + xfs[r][r]) for r in range(n))
            else:
                ok = True
            if not ok:
                raise AssertionError(f"in-process {op}: wrong output")
            return statistics.median(a.elapsed_time(b) for a, b in evs)

        res = {}
        if not hasattr(rk, "LocalPeers"):      # the earlier kernels' checkout
            ops = _spin_local(rk, n, dev, xs, outs, xfs, outfs)
            res["spin"] = {f"{op}_ms": event_ms(ops, op) for op in ops}
        else:
            for name, protocol in (("stream", "stream"),
                                   ("spin_one_flag", "spin")):
                peers = rk.LocalPeers(n, 4 * WORDS, dev, protocol)
                ops = {"collect": lambda: peers.rotate(
                           [[(xs[r], outs[r], 0)] for r in range(n)], False),
                       "presum": lambda: peers.presum(xfs, outfs)}
                res[name] = {f"{op}_ms": event_ms(ops, op) for op in ops}
                if protocol == "stream":
                    res["switch"] = {"round_trip_ms": event_ms(
                        {"switch": peers.bounce}, "switch")}
        q.put(res)
    except Exception:
        q.put({"failed": traceback.format_exc()})


def _spin_local(rk, n, dev, xs, outs, xfs, outfs) -> dict:
    """Both ranks' calls of the earlier spinning kernels (that checkout's
    API), each rank on its own stream."""
    import ctypes

    lib = rk._lib()
    slots_off = rk._round_up(2 * n * lib.bps_ring_max_blocks() * 4, 256)
    cap = rk._round_up(4 * WORDS, 256)
    host, err = ctypes.c_void_p(), ctypes.c_void_p()
    rk._check(lib.bps_ring_host_alloc(40, ctypes.byref(host),
                                      ctypes.byref(err)), "error words")
    bufs = [torch.zeros(slots_off + 2 * n * cap, dtype=torch.uint8,
                        device=dev) for _ in range(n)]
    ws = types.SimpleNamespace(
        peers=torch.tensor([b.data_ptr() for b in bufs], dtype=torch.int64,
                           device=dev),
        slots_off=slots_off, cap=cap, err_dev=err.value, bufs=bufs)
    streams = [torch.cuda.Stream() for _ in range(n)]
    epoch = [0]

    def call(presum):
        epoch[0] += 1
        cur = torch.cuda.current_stream()
        for r, st in enumerate(streams):
            st.wait_stream(cur)
            with torch.cuda.stream(st):
                if presum:
                    rk.launch_presum(ws, xfs[r], outfs[r], n, r, epoch[0])
                else:
                    rk.launch_rotate(ws, xs[r], outs[r], n, r, False,
                                     epoch[0])
        for st in streams:
            cur.wait_stream(st)

    return {"collect": lambda: call(False), "presum": lambda: call(True)}


def _run(ctx, target, args, count) -> list:
    """``target(rank, count, *args, q)`` in ``count`` processes, or
    ``target(*args, q)`` in one when count is 0; their results."""
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=((r, count) if count else ())
                         + args + (q,)) for r in range(max(count, 1))]
    for p in procs:
        p.start()
    try:
        res = []
        while len(res) < len(procs):    # a rank that failed ends the wait
            res.append(q.get(timeout=600))
            if "failed" in res[-1]:
                break
        return res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--repo", default=None,
                    help="another checkout to time in the same call (its "
                         "ring module and kernels), e.g. the parent commit")
    ap.add_argument("--cards", action="store_true",
                    help="instead: one rank a card on every card")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ring_probe: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()}), flush=True)
    ctx = mp.get_context("spawn")
    repos = [str(REPO)]
    if args.repo and not args.cards:
        repos.append(str(Path(args.repo).resolve()))
    ok = True
    for repo in repos:
        sys.path.insert(0, repo)
        from byteps_tpu_torch.ops import _build
        t0 = time.perf_counter()
        lib = _build.build(("ring",))["ring"]
        print(json.dumps({
            "repo": repo, "build_s": time.perf_counter() - t0,
            "ptxas": [ln.strip() for ln in lib.with_suffix(".log")
                      .read_text().splitlines()
                      if "registers" in ln or "spill" in ln]}), flush=True)
        for m in [m for m in sys.modules if m.startswith("byteps_tpu_torch")]:
            del sys.modules[m]
        sys.path.remove(repo)
        n = torch.cuda.device_count() if args.cards else 2
        store = os.path.join(tempfile.mkdtemp(), "store")
        ranks = _run(ctx, _rank, (repo, store, args.calls, args.cards), n)
        for r in sorted(ranks, key=lambda r: r.get("rank", -1)):
            print(json.dumps({"repo": repo, "layout_run": "cards" if
                              args.cards else "processes", **r}), flush=True)
            ok &= "failed" not in r and all(
                r.get(k, True) for k in ("collect_ok", "gather_ok",
                                         "presum_ok", "tree_ok"))
        if args.cards:
            continue
        local = _run(ctx, _local, (repo, args.calls), 0)[0]
        print(json.dumps({"repo": repo, "layout_run": "in-process", **local}),
              flush=True)
        ok &= "failed" not in local
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
