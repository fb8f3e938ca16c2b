"""The ICI collective tier over ``torch.distributed`` (counterpart of
``byteps_tpu/comm/ici.py``, staged and ring tiers).

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
decompressed. Presummable codecs (identity, fp16, randomk) sum their
payloads positionally in an explicit worker-order left fold instead.
With one rank and a deterministic codec the whole body is one codec
round trip, error feedback included (``Compressor.roundtrip``), exactly
as the reference's n == 1 fast path. Stochastic codecs run the general
body at one rank too, as the reference's do; there the exchange and the
gather are identities and need no process group.

The bodies the optimizer calls take a ``group``: the process group of a
mesh's dp axis, so that on a dp×tp×sp mesh each (tp, sp) rank aggregates
its own leaves over dp alone, or of its ``slice_`` axis or the two joined
(``None``: the default group). Both wire tiers run over that group: the
ring's transport keeps one workspace a group, so the two dp lines of a
dp×tp job ring at once, each over its own members.

Keys (``compression.base.fold_in``): the caller's ``rng`` (a chunk's
key) gives segment j the key ``fold_in(rng, j)``, the same on every
rank, and the owner rank r recompresses with ``fold_in(rng, r)``.

Wire tiers (``BYTEPS_ICI_TIER``, per-call ``tier=``; ``None`` reads the
config): ``staged`` moves each payload leaf with one ``all_to_all_single``
("push") and one ``all_gather`` ("pull"); ``ring`` moves the same leaves
through ``n−1`` ring hops (``ops/ring_collective_kernels.py``: the
hand-written peer-copy kernels on the card, every leaf of a payload in
one call a direction, point-to-point rounds on the CPU). Both move bits only, and the aggregation arithmetic (the codec's
``decompress_sum``, the worker-order fold, the ``two_way`` recompression)
is shared, so deterministic codecs give the same bits under both tiers.
Stochastic presummable codecs (randomk) instead take ``ring_presum``
under the ring, the serial reduce-scatter chain in payload space, and
skip the push exchange (the reference's XLA drops it as dead code): the
same support, values at summation-order roundoff. At n == 1 the tiers
are one code path and no ring kernel launches.

``ici.<kind>_dispatch``, ``ici.wire_bytes`` and ``ici.logical_bytes``
count the host-dispatched wrappers (``allreduce_flat``,
``reduce_scatter_flat``, ``all_gather_flat``, ``broadcast_flat``,
``compressed_allreduce_flat``, ``compressed_reduce_scatter_flat``),
under the reference's names; the bodies the optimizer calls (chunk by
chunk, or ZeRO-1's one scatter and gather a step) are not counted, as in
the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from byteps_tpu_torch.common.config import ICI_TIERS, get_config
from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.compression.base import Compressor, Payload, fold_in
from byteps_tpu_torch.ops.ring_collective_kernels import (
    ring_allgather_tree,
    ring_collect_tree,
    ring_presum,
)


def world(group=None) -> Tuple[int, int]:
    """(size, rank) of ``group`` (the default process group when None);
    (1, 0) when none is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group), dist.get_rank(group)
    return 1, 0


def _resolve_tier(tier: Optional[str]) -> str:
    t = tier or get_config().ici_tier
    if t not in ICI_TIERS:
        raise ValueError(f"unknown ICI tier {t!r} (BYTEPS_ICI_TIER / tier=): "
                         f"expected one of {ICI_TIERS}")
    return t


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


def reduce_scatter_flat(x: torch.Tensor) -> torch.Tensor:
    """Sum-reduce this rank's flat (L,) tensor over the ranks and keep
    owner segment ``rank``: the ``(ceil(L/n),)`` slice of the (zero-
    padded) sum. Each link carries (n−1)/n · L elements, half of an
    all-reduce."""
    n, _ = world()
    _count_dispatch("reduce_scatter")
    raw = (n - 1) * (-(-x.shape[0] // n)) * x.element_size()
    _account_wire(raw, raw)
    return reduce_scatter_body(x, n)


def reduce_scatter_body(x: torch.Tensor, n: int,
                        group=None) -> torch.Tensor:
    """:func:`reduce_scatter_flat` without the counters, over ``group``
    (the default process group when None): the body ZeRO-1 and the
    hierarchical multi-slice path call, as the reference's optimizer
    calls ``psum_scatter``."""
    segs, seg = _segment(x, n)
    if n == 1:
        return segs[0].clone()
    out = x.new_empty(seg)
    dist.reduce_scatter_tensor(out, segs.reshape(-1), group=group)
    return out


def all_gather_flat(seg: torch.Tensor, length: Optional[int] = None,
                    group=None) -> torch.Tensor:
    """Every rank's (seg,) owner segment, concatenated in rank order and
    cut to ``length``: the tail half of :func:`reduce_scatter_flat`, over
    ``group`` (the default process group when None). Exact: gathering
    moves bits."""
    n, _ = world(group)
    _count_dispatch("all_gather")
    raw = (n - 1) * seg.shape[0] * seg.element_size()
    _account_wire(raw, raw)
    return all_gather_body(seg, n, length, group)


def all_gather_body(seg: torch.Tensor, n: int, length: Optional[int] = None,
                    group=None) -> torch.Tensor:
    """:func:`all_gather_flat` without the counters (ZeRO-1's gather of
    the stepped segments)."""
    if n == 1:
        out = seg.clone()
    else:
        out = seg.new_empty(n * seg.shape[0])
        dist.all_gather_into_tensor(out, seg.contiguous(), group=group)
    return out if length is None else out[:length]


def broadcast_flat(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Rank ``root``'s flat tensor on every rank, as the reference (and
    BytePS's ``broadcast_parameters``) computes it: zeros on the other
    ranks, then a sum."""
    n, rank = world()
    _count_dispatch("broadcast")
    # accounted as the sum it is computed with
    raw = 2 * (n - 1) * (-(-x.shape[0] // n)) * x.element_size()
    _account_wire(raw, raw)
    out = x.clone() if rank == root else torch.zeros_like(x)
    if n > 1:
        dist.all_reduce(out)
    return out


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


def _as_wire(a: torch.Tensor) -> torch.Tensor:
    """A payload leaf as the collectives carry it: fp8 bytes as uint8
    (gloo has no fp8 type; the bits move unchanged)."""
    a = a.contiguous()
    if a.is_floating_point() and a.element_size() == 1:
        return a.view(torch.uint8)
    return a


def _exchange(payload: Payload, n: int, tier: str, group=None) -> Payload:
    """Deliver row j of every rank's stacked payload to owner j, stacked
    in worker order (``all_to_all`` semantics); the identity at n == 1."""
    if n == 1:
        return payload
    if tier == "ring":
        return ring_collect_tree(payload, n, group)
    out = {}
    for k, a in payload.items():
        a = _as_wire(a)
        recv = torch.empty_like(a)
        dist.all_to_all_single(recv, a, group=group)
        out[k] = recv.view(payload[k].dtype)
    return out


def _gather(out_payload: Payload, n: int, tier: str, group=None) -> Payload:
    """Owner-ordered stack of every owner's result payload (the "pull")."""
    if n == 1:
        return {k: a[None] for k, a in out_payload.items()}
    if tier == "ring":
        return ring_allgather_tree(out_payload, n, group)
    out = {}
    for k, a in out_payload.items():
        w = _as_wire(a)
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=group)
        out[k] = torch.stack(parts).view(a.dtype)
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


def _presum_route(compressor: Compressor, n: int, tier: str) -> bool:
    """Whether the owner's sum takes the ring's fused presum chain (a
    stochastic presummable codec on the ring, over more than one rank)."""
    return (tier == "ring" and n > 1 and compressor.presummable
            and compressor.stochastic)


def _compress_push(g: torch.Tensor, rng: int, compressor: Compressor,
                   n: int, tier: str, group=None):
    """COMPRESS → "PUSH": segment, compress segment j with key
    ``fold_in(rng, j)``, and exchange so owner j receives every rank's
    segment j. Returns ``(payload, seg_keys, recv, seg)``; ``recv`` is
    None on the presum route, which needs no exchange."""
    segs, seg = _segment(g, n)
    seg_keys = [fold_in(rng, j) for j in range(n)]
    payload = _stack([compressor.compress(segs[j], seg_keys[j])
                      for j in range(n)])
    recv = (None if _presum_route(compressor, n, tier)
            else _exchange(payload, n, tier, group))
    return payload, seg_keys, recv, seg


def _decompress_rows(compressor: Compressor, stacked: Payload,
                     keys, seg: int) -> torch.Tensor:
    return torch.cat([compressor.decompress(_row(stacked, j), seg,
                                            torch.float32, key)
                      for j, key in enumerate(keys)])


def _size_rank(n: Optional[int], group=None) -> Tuple[int, int]:
    """(n, this rank's index among them): ``group``'s (the default
    group's by default)."""
    size, rank = world(group)
    if n is None:
        n = size
    return n, (rank if n > 1 else 0)


def _require_rng(compressor: Compressor, rng: Optional[int]) -> int:
    if rng is None:
        if compressor.stochastic:
            raise ValueError(
                f"{compressor.name} requires an rng key advancing every step")
        rng = 0
    return rng


def _owner_sum(payload: Payload, recv: Optional[Payload],
               compressor: Compressor, n: int, seg: int,
               tier: str, group=None) -> Payload:
    """The owner's aggregate of the received segments: the positional
    payload sum of a presummable codec (still compressed; on the presum
    route the ring chain over this rank's own ``payload``), else the f32
    sum of the decompressed segments as ``{"dense": ...}``."""
    if _presum_route(compressor, n, tier):
        return {k: ring_presum(a, n, group) for k, a in payload.items()}
    if compressor.presummable:
        return _payload_sum(recv, n)
    return {"dense": compressor.decompress_sum(recv, seg, torch.float32)}


def compressed_allreduce_local(
    g: torch.Tensor,
    compressor: Compressor,
    n: Optional[int] = None,
    average: bool = True,
    two_way: bool = True,
    ef_residual: Optional[torch.Tensor] = None,
    rng: Optional[int] = None,
    tier: Optional[str] = None,
    group=None,
):
    """This rank's body of the compressed all-reduce of a flat (L,) chunk
    over ``group`` (the default group when None).

    ``rng`` is the chunk's key, the same on every rank; stochastic codecs
    require it. With ``ef_residual`` the compressed input is ``g +
    ef_residual`` and the result is ``(out, new_residual)``,
    ``new_residual = input − D(C(input))`` from the own payload. ``tier``
    picks the wire transport (None reads ``BYTEPS_ICI_TIER``)."""
    tier = _resolve_tier(tier)
    rng = _require_rng(compressor, rng)
    n, rank = _size_rank(n, group)
    L = g.shape[0]
    g = g.float()
    if n == 1 and not compressor.stochastic:
        # single-worker fast path: no exchange exists, so the whole body
        # is one codec round trip, error feedback included; exact for
        # deterministic codecs, whose D∘C is idempotent
        dense, resid = compressor.roundtrip(g, fold_in(rng, 0),
                                            e=ef_residual)
        return dense if ef_residual is None else (dense, resid)
    if ef_residual is not None:
        g = g + ef_residual
    payload, seg_keys, recv, seg = _compress_push(g, rng, compressor, n,
                                                  tier, group)
    out_payload = _owner_sum(payload, recv, compressor, n, seg, tier, group)
    if two_way and not compressor.presummable:
        # recompress the owner's sum for the pull, with the owner's key
        out_payload = compressor.compress(out_payload["dense"],
                                          fold_in(rng, rank))
    gathered = _gather(out_payload, n, tier, group)
    if compressor.presummable or two_way:
        out = _decompress_rows(compressor, gathered, seg_keys, seg)
    else:
        out = gathered["dense"].reshape(-1)
    out = out[:L]
    out = out / n if average else out
    if ef_residual is None:
        return out
    return out, g - _decompress_rows(compressor, payload, seg_keys, seg)[:L]


def compressed_reduce_scatter_local(
    g: torch.Tensor,
    compressor: Compressor,
    n: Optional[int] = None,
    average: bool = True,
    ef_residual: Optional[torch.Tensor] = None,
    rng: Optional[int] = None,
    tier: Optional[str] = None,
    group=None,
):
    """The first half of the compressed all-reduce over ``group`` (the
    default group when None): COMPRESS → "PUSH" → the owner's f32 sum,
    without the pull. Returns this rank's owned ``(ceil(L/n),)`` segment
    of the aggregate, or ``(segment, new_residual)`` with
    ``ef_residual`` (error feedback and ``tier`` as in
    :func:`compressed_allreduce_local`)."""
    tier = _resolve_tier(tier)
    rng = _require_rng(compressor, rng)
    n, rank = _size_rank(n, group)
    L = g.shape[0]
    g = g.float()
    if n == 1 and not compressor.stochastic:
        # the owner "sum" over one worker is D(C(g[+e])), one round trip;
        # the segment is the whole vector and nothing is recompressed
        dense, resid = compressor.roundtrip(g, fold_in(rng, 0),
                                            e=ef_residual)
        return dense if ef_residual is None else (dense, resid)
    if ef_residual is not None:
        g = g + ef_residual
    payload, seg_keys, recv, seg = _compress_push(g, rng, compressor, n,
                                                  tier, group)
    agg = _owner_sum(payload, recv, compressor, n, seg, tier, group)
    # a presummable sum is still a payload, of this owner's segment key
    s = (compressor.decompress(agg, seg, torch.float32, fold_in(rng, rank))
         if compressor.presummable else agg["dense"])
    s = s / n if average else s
    if ef_residual is None:
        return s
    return s, g - _decompress_rows(compressor, payload, seg_keys, seg)[:L]


def _account_compressed(compressor: Compressor, L: int, n: int,
                        two_way: bool, pull: bool) -> None:
    """Wire bytes of one compressed dispatch on this rank: (n−1) segment
    payloads pushed, and for an all-reduce (n−1) pulled, compressed when
    ``two_way`` or presummable, raw f32 otherwise."""
    if n <= 1:
        return
    seg = -(-L // n)
    pb = compressor.compressed_bytes(seg)
    wire, logical = (n - 1) * pb, (n - 1) * seg * 4
    if pull:
        wire += (n - 1) * (
            pb if (compressor.presummable or two_way) else seg * 4)
        logical *= 2
    _account_wire(wire, logical)


def compressed_allreduce_flat(
    x: torch.Tensor,
    compressor: Compressor,
    average: bool = True,
    two_way: bool = True,
    ef_residual: Optional[torch.Tensor] = None,
    rng: Optional[int] = None,
    tier: Optional[str] = None,
):
    """Host-dispatched compressed all-reduce of this rank's flat (L,)
    tensor: :func:`compressed_allreduce_local` plus the dispatch and
    wire-byte counters (the same under both tiers). Returns ``out``, or
    ``(out, new_residual)`` with ``ef_residual``."""
    tier = _resolve_tier(tier)
    n, _ = world()
    _count_dispatch("compressed_allreduce")
    _account_compressed(compressor, x.shape[0], n, two_way, pull=True)
    return compressed_allreduce_local(x, compressor, n, average=average,
                                      two_way=two_way,
                                      ef_residual=ef_residual, rng=rng,
                                      tier=tier)


def compressed_reduce_scatter_flat(
    x: torch.Tensor,
    compressor: Compressor,
    average: bool = False,
    rng: Optional[int] = None,
    tier: Optional[str] = None,
) -> torch.Tensor:
    """Host-dispatched compressed reduce-scatter: this rank's owned
    ``(ceil(L/n),)`` segment of Σ_w D(C(x_w)) (a sum by default, as a
    reduce is), with the dispatch and wire-byte counters."""
    tier = _resolve_tier(tier)
    n, _ = world()
    _count_dispatch("compressed_reduce_scatter")
    _account_compressed(compressor, x.shape[0], n, False, pull=False)
    return compressed_reduce_scatter_local(x, compressor, n, average=average,
                                           rng=rng, tier=tier)
