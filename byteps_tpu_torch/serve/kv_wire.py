"""KV-block wire codec and migration transport for disaggregated
serving — the port's ``byteps_tpu/serve/kv_wire.py``.

Prefill and decode stop sharing a replica: the KV blocks a prefill
replica commits stream to their decode target over the gradient tier's
wire machinery.

* **Codec** — :class:`KVBlockCodec` turns one physical KV block (every
  layer's k/v rows, and the int8 pool's scales) into self-describing
  wire bytes and back, byte for byte. The frame is the reference's: a
  ``[magic, flags, body_len, crc32]`` u32 header, then k ‖ v (‖ k_scale ‖
  v_scale), the raw bytes in the pool's own dtype — a bf16 pool's as its
  16-bit words (numpy has no bfloat16; :class:`BlockPayload` carries
  them as ``uint16``). Nothing is re-encoded, so migration cannot move a
  request's numerics, and each package decodes the other's frames.
* **Transport** — :class:`KVWire` is one source replica's outbound NIC:
  a two-stage :class:`~byteps_tpu_torch.common.scheduler.PipelineScheduler`
  (KVCOMPRESS → KVPUSH) with wire-scoped PUSH credits, so one block's
  bytes ride the wire while the next encodes, and both overlap the
  source replica's next prefill chunk on its own thread. The stage
  threads touch host bytes only: the device gather and scatter
  (``PagedKVCache.snapshot_blocks`` / ``write_payloads``) run on the
  replicas' calling threads. Payload bytes pass a
  :class:`~byteps_tpu_torch.server.pacer.DcnPacer` token bucket
  (``BYTEPS_SERVE_DISAGG_MBPS``).
* **Self-healing** — the frame's CRC32 is checked at decode (corruption
  is detected, never adopted), KVPUSH is ``Stage.retryable``, and the
  push resolves its target on every attempt through a router callback,
  so a dead decode target is a remap (the router points the request at a
  live sibling), not a loss.

The same transport serves migrate-don't-evict preemption: a pressured
victim's committed blocks move to a sibling replica instead of being
freed and recomputed (``Scheduler.extract_for_migration`` → the router's
``_migrate_out`` → the sibling's ``submit_migrated``).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import zlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from byteps_tpu_torch.common.faults import (
    FaultPlan,
    InjectedConnectionError,
    InjectedTimeout,
)
from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.common.partition import Partition
from byteps_tpu_torch.common.scheduler import (
    Handle,
    PartitionTask,
    PipelineScheduler,
    Stage,
)
from byteps_tpu_torch.server.pacer import DcnPacer

_MAGIC = 0x4B564231  # "KVB1"
_FLAG_QUANT = 0x1

# NIC sequence: one KVWire per source replica, each with its own
# in-flight gauge series
_WIRE_SEQ = itertools.count()


class KVWireError(RuntimeError):
    """Malformed or incompatible KV frame — not retryable (re-sending the
    same bytes cannot fix a layout mismatch)."""

    retryable = False


class KVWireCorruption(RuntimeError):
    """CRC mismatch on a received KV block. Retryable: the source
    re-sends its pristine payload."""

    retryable = True


class DeadTargetError(ConnectionError):
    """The resolved decode target is dead or evicted. Retryable: the
    retry re-resolves the target, which the router has remapped."""

    retryable = True


class BlockPayload(NamedTuple):
    """One physical KV block's host copy, every layer at once.

    k/v: ``(n_layers, block_size, h_kv, head_dim)`` in the pool's dtype
    (int8 in quant mode; a bf16 pool's raw words as ``uint16``);
    k_scale/v_scale: ``(n_layers, block_size, h_kv)`` f32 in quant mode,
    else None. Exactly the pool slices ``state.k[:, b]`` and so on."""

    k: np.ndarray
    v: np.ndarray
    k_scale: Optional[np.ndarray] = None
    v_scale: Optional[np.ndarray] = None


@dataclasses.dataclass
class MigrationTicket:
    """What a decode replica needs to continue a request whose KV lives
    in (or is arriving at) its pool: the request, its committed tokens,
    the decode cursor and the latency stamps. Block contents travel
    apart over the :class:`KVWire`; ``payloads`` carries only the blocks
    not streamed when the ticket was cut (the partial tail at a prefill
    handoff; all of them for a migrate-don't-evict extraction).
    ``full_input`` is the token context behind cache rows ``[0,
    cache_len)``, what the receiving pool's radix index matches and
    commits, so prefix sharing survives migration."""

    req: Any                       # serve.scheduler.Request
    emitted: List[int]
    pending: Optional[int]
    cache_len: int
    full_input: np.ndarray
    n_blocks: int
    payloads: Dict[int, BlockPayload]
    t_origin: float = 0.0
    t_submit: float = 0.0
    t_first: Optional[float] = None
    tok_s: List[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    spec_rounds: int = 0


def _np_dtype(dtype) -> np.dtype:
    """The numpy dtype of a pool's bytes: a torch bf16 pool travels as
    ``uint16`` words."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return np.dtype(np.uint16)
        return np.dtype(torch.empty(0, dtype=dtype).numpy().dtype)
    return np.dtype(dtype)


class KVBlockCodec:
    """Encode and decode one KV block for the migration wire.

    Frame: ``[u32 magic][u32 flags][u32 body_len][u32 crc32]`` + body,
    body = k ‖ v (‖ k_scale ‖ v_scale in quant mode), raw bytes in the
    pool's dtype. Shapes and dtype are bound at construction (both ends
    must agree; decode checks), so no shape travels with a block. The
    round trip is byte-identical: the body is a view, never a cast."""

    def __init__(self, n_layers: int, block_size: int, h_kv: int,
                 head_dim: int, dtype, quant: bool):
        self.n_layers = int(n_layers)
        self.block_size = int(block_size)
        self.h_kv = int(h_kv)
        self.head_dim = int(head_dim)
        self.dtype = _np_dtype(dtype)
        self.quant = bool(quant)
        self._kv_shape = (self.n_layers, self.block_size, self.h_kv,
                          self.head_dim)
        self._sc_shape = self._kv_shape[:-1]
        self._kv_bytes = int(np.prod(self._kv_shape)) * self.dtype.itemsize
        self._sc_bytes = (int(np.prod(self._sc_shape)) * 4 if self.quant
                          else 0)
        self.body_bytes = 2 * self._kv_bytes + 2 * self._sc_bytes

    @classmethod
    def from_pool(cls, cache) -> "KVBlockCodec":
        """The codec of a :class:`~byteps_tpu_torch.serve.paged_cache.
        PagedKVCache`'s pool layout (its ``PoolState``)."""
        L, _, bs, h, D = cache.state.k.shape
        return cls(L, bs, h, D, cache.state.k.dtype, cache.quant)

    @property
    def frame_bytes(self) -> int:
        return 16 + self.body_bytes

    def encode(self, p: BlockPayload) -> np.ndarray:
        """BlockPayload → uint8 wire frame, CRC32-stamped."""
        parts = [np.ascontiguousarray(p.k).view(np.uint8).ravel(),
                 np.ascontiguousarray(p.v).view(np.uint8).ravel()]
        if self.quant:
            if p.k_scale is None or p.v_scale is None:
                raise KVWireError("quant codec needs k_scale/v_scale")
            parts.append(np.ascontiguousarray(
                p.k_scale, np.float32).view(np.uint8).ravel())
            parts.append(np.ascontiguousarray(
                p.v_scale, np.float32).view(np.uint8).ravel())
        body = np.concatenate(parts)
        if body.nbytes != self.body_bytes:
            raise KVWireError(
                f"payload is {body.nbytes} B, codec expects "
                f"{self.body_bytes} B — pool layout mismatch")
        out = np.empty(16 + body.nbytes, np.uint8)
        hdr = np.asarray(
            [_MAGIC, _FLAG_QUANT if self.quant else 0, body.nbytes,
             zlib.crc32(body.tobytes()) & 0xFFFFFFFF], np.uint32)
        out[:16] = hdr.view(np.uint8)
        out[16:] = body
        return out

    def decode(self, buf: np.ndarray) -> BlockPayload:
        """uint8 wire frame → BlockPayload, CRC-verified."""
        buf = np.ascontiguousarray(buf, np.uint8)
        if buf.nbytes < 16:
            raise KVWireError(f"short KV frame ({buf.nbytes} B)")
        magic, flags, body_len, crc = (int(x) for x in
                                       buf[:16].view(np.uint32))
        if magic != _MAGIC:
            raise KVWireError(f"bad KV frame magic {magic:#x}")
        want_flags = _FLAG_QUANT if self.quant else 0
        if flags != want_flags or body_len != self.body_bytes:
            raise KVWireError(
                f"KV frame flags/len ({flags:#x}, {body_len}) do not "
                f"match this codec ({want_flags:#x}, {self.body_bytes}) "
                "— source and target pool layouts differ")
        body = buf[16:16 + body_len]
        if body.nbytes != body_len:
            raise KVWireError(
                f"truncated KV frame: {body.nbytes}/{body_len} body B")
        if (zlib.crc32(body.tobytes()) & 0xFFFFFFFF) != crc:
            raise KVWireCorruption(
                "KV block CRC mismatch — frame damaged in flight")
        kb, sb = self._kv_bytes, self._sc_bytes
        k = body[:kb].view(self.dtype).reshape(self._kv_shape).copy()
        v = body[kb:2 * kb].view(self.dtype).reshape(self._kv_shape).copy()
        if not self.quant:
            return BlockPayload(k, v)
        ks = body[2 * kb:2 * kb + sb].view(np.float32) \
            .reshape(self._sc_shape).copy()
        vs = body[2 * kb + sb:].view(np.float32) \
            .reshape(self._sc_shape).copy()
        return BlockPayload(k, v, ks, vs)


class KVWire:
    """One source replica's outbound migration NIC.

    ``send_block`` enqueues one block: KVCOMPRESS encodes it on a pool
    thread; KVPUSH (credited, wire-scoped release, retryable) pays the
    token bucket's wire time and delivers into the current target's
    staging through ``Scheduler.ingest_block``, the target re-resolved
    through ``resolve(rid)`` on every attempt, so a retry after
    :class:`DeadTargetError` lands on the sibling the router remapped the
    request to. Credits bound the encoded frames in flight.

    An optional :class:`~byteps_tpu_torch.common.faults.FaultPlan`
    intercepts each push attempt (op ``"push"``): ``corrupt`` flips a
    byte of a copy of the frame (the CRC catches it, the retry re-sends
    the pristine bytes), ``timeout`` delivers and then loses the ack (the
    re-delivery is idempotent: staging is keyed by (rid, block)),
    ``kill``/``down`` fail the attempt."""

    def __init__(self, codec: KVBlockCodec,
                 resolve: Callable[[Any], Any], *,
                 mbps: float = 0.0, credit: int = 4,
                 fault_plan: Optional[FaultPlan] = None,
                 max_attempts: int = 10):
        self.codec = codec
        self._resolve = resolve
        self._plan = fault_plan
        self._pacer = DcnPacer(mbps) if mbps and mbps > 0 else None
        self._key_seq = itertools.count()
        _reg = get_registry()
        self._m_blocks = _reg.counter("serve.migration.blocks")
        self._m_bytes = _reg.counter("serve.migration.bytes")
        self._g_inflight = _reg.gauge(
            f"serve.kvwire{next(_WIRE_SEQ)}.inflight_blocks")
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._sched = PipelineScheduler(
            stages=[
                Stage(name="KVCOMPRESS", fn=self._compress, pool_size=2),
                Stage(name="KVPUSH", fn=self._push, credited=True,
                      releases_credit=True, retryable=True,
                      pool_size=2, max_attempts=max_attempts,
                      retry_backoff_s=0.02),
            ],
            credit=max(1, credit),
        )

    # -- stage bodies (pool threads) ----------------------------------------
    def _compress(self, task: PartitionTask) -> np.ndarray:
        return self.codec.encode(task.payload)

    def _push(self, task: PartitionTask) -> int:
        buf = task.payload
        rid = task.context["rid"]
        bi = task.context["block"]
        deliver = buf
        inj = self._plan.intercept("push", -1) if self._plan else None
        if inj is not None:
            if inj.kind in ("kill", "down"):
                raise InjectedConnectionError(
                    f"injected {inj.kind} on KV push {rid!r}.{bi}")
            if inj.kind == "corrupt":
                deliver = buf.copy()
                FaultPlan.corrupt(deliver, inj.corrupt_at)
        if self._pacer is not None:
            self._pacer.throttle_send(int(buf.nbytes))
        target = self._resolve(rid)
        if target is None or getattr(target, "dead", False):
            raise DeadTargetError(
                f"decode target for {rid!r} is dead/unassigned")
        # the target decodes inside this push (CRC checked before
        # anything is staged); a corruption is retryable and the retry
        # re-sends the pristine frame
        target.ingest_block(rid, bi, deliver)
        if inj is not None and inj.kind == "timeout":
            # delivered, ack lost: the retry's re-delivery overwrites the
            # identical staged payload
            raise InjectedTimeout(
                f"injected timeout on KV push {rid!r}.{bi}")
        self._m_blocks.inc()
        self._m_bytes.inc(int(buf.nbytes))
        self._note_inflight(-1)
        return int(buf.nbytes)

    def _note_inflight(self, d: int) -> None:
        with self._inflight_lock:
            self._inflight += d
            self._g_inflight.set(self._inflight)

    # -- client surface ------------------------------------------------------
    def send_block(self, rid, block_idx: int,
                   payload: BlockPayload) -> Handle:
        """Enqueue one block; the handle completes when the target staged
        it (or fails once the retries are spent)."""
        key = next(self._key_seq)
        part = Partition(key=key, tensor_id=key, part_idx=int(block_idx),
                         offset=0, length=self.codec.body_bytes // 4,
                         priority=0)
        handle = Handle(f"kv.{rid}.{block_idx}", 1)
        task = PartitionTask(partition=part, name=f"kv.{rid}",
                             handle=handle, payload=payload,
                             context={"rid": rid, "block": int(block_idx)})
        self._note_inflight(1)
        self._sched.enqueue([task])
        return handle

    def abandon(self, n: int = 1) -> None:
        """Router bookkeeping: ``n`` sends failed for good (their blocks
        are re-sent as fresh tasks)."""
        self._note_inflight(-n)

    def shutdown(self) -> None:
        self._sched.shutdown()
