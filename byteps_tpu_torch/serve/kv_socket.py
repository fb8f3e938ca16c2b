"""KV-block migration over a REAL socket: the kv_wire seam, cross-process
(the port's copy of ``byteps_tpu/serve/kv_socket.py``).

:class:`~byteps_tpu_torch.serve.kv_wire.KVWire` delivers each block by calling
``target.ingest_block(rid, bi, frame)`` on whatever ``resolve(rid)``
returns — in a colocated router that is the decode
:class:`~byteps_tpu_torch.serve.scheduler.Scheduler` itself. This module puts
a real TCP link inside that seam without KVWire noticing:

* :class:`KVSocketEndpoint` — the DECODE side. Owns a
  :class:`~byteps_tpu_torch.common.socknic.SocketNicListener`, unpacks each
  ``CH_KV_BLOCK`` frame and feeds the local scheduler's
  ``ingest_block`` (which decodes through the KV codec — CRC verified
  — and stages idempotently by ``(rid, block)``, so a retry's
  re-delivery is harmless). A codec/CRC failure raises out of the
  handler and crosses BACK over the wire as a typed error reply.
* :class:`SocketKVTarget` — the SOURCE side's proxy for that endpoint:
  the same ``ingest_block``/``dead`` duck type the in-process target
  has, delivery by framed request over a
  :class:`~byteps_tpu_torch.common.socknic.SocketNicClient`. Failures keep
  the existing retryable/wire-death taxonomy KVWire's retryable KVPUSH
  stage already classifies: a reset/refused link raises
  ``ConnectionError``, a recv deadline ``TimeoutError``, on-wire
  damage :class:`~byteps_tpu_torch.common.socknic.SockWireCorruption`, and a
  remote codec rejection is re-raised as the ORIGINAL
  ``KVWireCorruption``/``KVWireError`` type — so what is retryable
  in-process is retryable cross-process, for real reasons.

Routers opt in per-target via ``Router(kv_target_wrap=...)``: the wrap
is applied to the resolve callback handed to KVWire only, so the
router's own migration bookkeeping (``staged_blocks``/``pop_staged``/
``submit_migrated``) keeps talking to the local scheduler object while
the BYTES cross the kernel's TCP stack. Request ids must be strings on
this path (they are serialized into the frame).
"""

from __future__ import annotations

import struct
from typing import Any, Optional

import numpy as np

from byteps_tpu_torch.common.logging import get_logger
from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.common.socknic import (
    CH_KV_BLOCK,
    SocketNicClient,
    SocketNicListener,
)
from byteps_tpu_torch.serve.kv_wire import (
    DeadTargetError,
    KVWireCorruption,
    KVWireError,
)

log = get_logger("serve.kv_socket")

__all__ = ["KVSocketEndpoint", "SocketKVTarget"]

_BODY_HDR = struct.Struct("<II")  # rid_len, block_idx


def _pack(rid: str, block_idx: int, frame: np.ndarray) -> bytes:
    rb = rid.encode("utf-8")
    return (_BODY_HDR.pack(len(rb), int(block_idx)) + rb
            + np.ascontiguousarray(frame, np.uint8).tobytes())


def _unpack(body: bytes):
    rid_len, block_idx = _BODY_HDR.unpack_from(body)
    off = _BODY_HDR.size
    rid = body[off:off + rid_len].decode("utf-8")
    frame = np.frombuffer(body, np.uint8, offset=off + rid_len)
    return rid, block_idx, frame


class KVSocketEndpoint:
    """Decode-side ingest listener in front of a local scheduler."""

    def __init__(self, target, port: int = 16200, attempts: int = 16,
                 stride: int = 1):
        self._target = target
        self._listener = SocketNicListener(port, attempts=attempts,
                                           stride=stride)
        self._listener.register(CH_KV_BLOCK, self._on_block)
        self._m_ingested = get_registry().counter(
            "serve.kv_socket.blocks_ingested")
        log.info("KV socket endpoint listening on :%d", self.port)

    @property
    def port(self) -> int:
        return self._listener.port

    @property
    def host(self) -> str:
        return self._listener.host

    def _on_block(self, body: bytes) -> bytes:
        if getattr(self._target, "dead", False):
            # same refusal the in-process path makes BEFORE delivery;
            # crossing back as DeadTargetError keeps it retryable (the
            # source's next attempt re-resolves)
            raise DeadTargetError("decode target behind this endpoint "
                                  "is dead")
        rid, bi, frame = _unpack(body)
        # ingest_block decodes (CRC verified) + stages idempotently;
        # KVWireCorruption/KVWireError raise back across the wire typed
        self._target.ingest_block(rid, bi, frame)
        self._m_ingested.inc()
        return b""

    def close(self) -> None:
        self._listener.close()


class SocketKVTarget:
    """Source-side proxy: KVWire's target duck type over a real link."""

    # the wire surfaces its own liveness (ConnectionError per attempt,
    # re-resolved by the retry) — a proxy has no local lease to check
    dead = False

    def __init__(self, host: str, port: int,
                 timeout_ms: Optional[int] = None, pacer=None,
                 fault_plan=None):
        self._client = SocketNicClient(
            host, port, timeout_ms=timeout_ms, pacer=pacer,
            fault_plan=fault_plan,
            error_types={
                "KVWireCorruption": KVWireCorruption,
                "KVWireError": KVWireError,
                "DeadTargetError": DeadTargetError,
            })

    def ingest_block(self, rid: Any, block_idx: int,
                     frame: np.ndarray) -> None:
        self._client.request(CH_KV_BLOCK, _pack(str(rid), block_idx,
                                                frame))

    def close(self) -> None:
        self._client.close()
