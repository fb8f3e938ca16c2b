"""The ICI collective tier over ``torch.distributed`` (counterpart of
``byteps_tpu/comm/ici.py``, staged tier).

The reference runs SPMD inside ``shard_map``: each function sees one
device's block and names a mesh axis. Here each rank is one process,
each function takes this rank's flat tensor, and the collectives run
over the default process group. Without an initialized process group
the world is one rank and no collective runs.

The compressed all-reduce keeps the reference's hybrid-PS dataflow:
each rank compresses one segment per owner, the segments are exchanged
(``all_to_all_single``: owner j receives every rank's segment j, stacked
in worker order), the owner decompresses and sums them in f32 (the
codec's fused ``decompress_sum``), recompresses the sum when
``two_way``, and every owner's result is gathered (``all_gather``) and
decompressed. Presummable codecs (identity) sum their payloads
positionally in an explicit worker-order left fold instead. With one
rank and a deterministic codec the whole body is one codec round trip,
error feedback included (``Compressor.roundtrip``), exactly as the
reference's n == 1 fast path.

The ring tier (``BYTEPS_ICI_TIER=ring``) waits for the ring collective
kernels. Stochastic codecs are not ported yet.

``ici.<kind>_dispatch``, ``ici.wire_bytes`` and ``ici.logical_bytes``
count the host-dispatched wrappers (``allreduce_flat``,
``compressed_allreduce_flat``), under the reference's names; the bodies
the optimizer calls chunk by chunk are not counted, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.compression.base import Compressor, Payload


def world() -> Tuple[int, int]:
    """(size, rank) of the default process group; (1, 0) when none is
    initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _count_dispatch(kind: str) -> None:
    get_registry().counter(f"ici.{kind}_dispatch").inc()


def _account_wire(wire_bytes: int, logical_bytes: int) -> None:
    """Per-dispatch wire bytes of this rank (compressed payload bytes)
    and the uncompressed f32 bytes the same collective would move."""
    if wire_bytes:
        get_registry().counter("ici.wire_bytes").inc(int(wire_bytes))
    if logical_bytes:
        get_registry().counter("ici.logical_bytes").inc(int(logical_bytes))


def allreduce_flat(x: torch.Tensor, average: bool = True) -> torch.Tensor:
    """Uncompressed all-reduce of this rank's flat (L,) tensor."""
    n, _ = world()
    _count_dispatch("allreduce")
    raw = 2 * (n - 1) * (-(-x.shape[0] // n)) * x.element_size()
    _account_wire(raw, raw)
    out = x.clone()
    if n > 1:
        dist.all_reduce(out)
    return out / n if average else out


def _segment(g: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    """Pad a flat (L,) vector and view as (n, seg) owner-major segments."""
    L = g.shape[0]
    seg = -(-L // n)
    if seg * n != L:
        g = torch.cat([g, g.new_zeros(seg * n - L)])
    return g.reshape(n, seg), seg


def _stack(payloads) -> Payload:
    return {k: torch.stack([p[k] for p in payloads]) for k in payloads[0]}


def _row(payload: Payload, j: int) -> Payload:
    return {k: v[j] for k, v in payload.items()}


def _exchange(payload: Payload) -> Payload:
    """Deliver row j of every rank's stacked payload to owner j, stacked
    in worker order (``all_to_all`` semantics)."""
    out = {}
    for k, a in payload.items():
        a = a.contiguous()
        recv = torch.empty_like(a)
        dist.all_to_all_single(recv, a)
        out[k] = recv
    return out


def _gather(out_payload: Payload, n: int) -> Payload:
    """Owner-ordered stack of every owner's result payload (the "pull")."""
    out = {}
    for k, a in out_payload.items():
        a = a.contiguous()
        parts = [torch.empty_like(a) for _ in range(n)]
        dist.all_gather(parts, a)
        out[k] = torch.stack(parts)
    return out


def _payload_sum(recv: Payload, n: int) -> Payload:
    """Positional payload sum over the worker-ordered stack as a left
    fold in worker order (w = 0, 1, …, n−1), the reference's pinned
    association."""
    def fold(a):
        acc = a[0]
        for w in range(1, n):
            acc = acc + a[w]
        return acc

    return {k: fold(a) for k, a in recv.items()}


def _compress_push(g: torch.Tensor, compressor: Compressor, n: int):
    """COMPRESS → "PUSH": segment, compress each owner's segment, and
    exchange so owner j receives every rank's segment j. Returns
    ``(payload, recv, seg)``."""
    segs, seg = _segment(g, n)
    payload = _stack([compressor.compress(segs[j]) for j in range(n)])
    return payload, _exchange(payload), seg


def _decompress_rows(compressor: Compressor, stacked: Payload, n: int,
                     seg: int) -> torch.Tensor:
    return torch.cat([compressor.decompress(_row(stacked, j), seg,
                                            torch.float32)
                      for j in range(n)])


def compressed_allreduce_local(
    g: torch.Tensor,
    compressor: Compressor,
    n: Optional[int] = None,
    average: bool = True,
    two_way: bool = True,
    ef_residual: Optional[torch.Tensor] = None,
):
    """This rank's body of the compressed all-reduce of a flat (L,) chunk.

    With ``ef_residual`` the compressed input is ``g + ef_residual`` and
    the result is ``(out, new_residual)``, ``new_residual = input −
    D(C(input))`` from the own payload."""
    if compressor.stochastic:
        raise NotImplementedError(
            f"{compressor.name}: stochastic codecs are not ported yet")
    if n is None:
        n = world()[0]
    L = g.shape[0]
    g = g.float()
    if n == 1:
        # single-worker fast path: no exchange exists, so the whole body
        # is one codec round trip, error feedback included; exact for
        # deterministic codecs, whose D∘C is idempotent
        dense, resid = compressor.roundtrip(g, e=ef_residual)
        return dense if ef_residual is None else (dense, resid)
    if ef_residual is not None:
        g = g + ef_residual
    payload, recv, seg = _compress_push(g, compressor, n)
    if compressor.presummable:
        out_payload = _payload_sum(recv, n)
    else:
        # owner: decompress each rank's segment and sum in f32 (the
        # codec's fused decompress_sum), then recompress for the pull
        s = compressor.decompress_sum(recv, seg, torch.float32)
        out_payload = compressor.compress(s) if two_way else {"dense": s}
    gathered = _gather(out_payload, n)
    if compressor.presummable or two_way:
        out = _decompress_rows(compressor, gathered, n, seg)
    else:
        out = gathered["dense"].reshape(-1)
    out = out[:L]
    out = out / n if average else out
    if ef_residual is None:
        return out
    return out, g - _decompress_rows(compressor, payload, n, seg)[:L]


def compressed_allreduce_flat(
    x: torch.Tensor,
    compressor: Compressor,
    average: bool = True,
    two_way: bool = True,
    ef_residual: Optional[torch.Tensor] = None,
):
    """Host-dispatched compressed all-reduce of this rank's flat (L,)
    tensor: :func:`compressed_allreduce_local` plus the dispatch and
    wire-byte counters. Returns ``out``, or ``(out, new_residual)`` with
    ``ef_residual``."""
    n, _ = world()
    _count_dispatch("compressed_allreduce")
    if n > 1:
        seg = -(-x.shape[0] // n)
        pb = compressor.compressed_bytes(seg)
        wire = (n - 1) * pb + (n - 1) * (
            pb if (compressor.presummable or two_way) else seg * 4)
        _account_wire(wire, 2 * (n - 1) * seg * 4)
    return compressed_allreduce_local(x, compressor, n, average=average,
                                      two_way=two_way,
                                      ef_residual=ef_residual)

