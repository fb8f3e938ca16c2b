"""Tensor declaration, key assignment, and partitioning (the port's copy
of ``byteps_tpu/common/partition.py``; keys and priorities must equal the
reference's for the same declarations).

Equivalent of the reference's tensor-declaration and partitioning logic
(``byteps/common/global.cc`` ``DeclareTensor`` and
``byteps/common/operations.cc`` ``InitTensor`` / key-list construction):

* Each named tensor is **declared** once; declaration order assigns a
  monotonically increasing tensor id, and **priority = -declaration order**
  — in backward passes, the last layers' gradients are declared first and so
  get the highest priority; they're produced first and consumed last, which
  is exactly what overlap wants.
* Each tensor is **partitioned** into chunks of at most
  ``BYTEPS_PARTITION_BYTES`` (default 4096000) so large tensors pipeline
  through the stages and interleave with smaller ones.
* Each partition gets a globally unique **key**; on the DCN tier, key → server
  assignment is ``key % num_server`` (the reference hashes partition keys to
  spread load across servers).

Partitioning is in **elements** (derived from dtype itemsize): the
pipeline slices flat arrays rather than raw byte buffers.
"""

from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.common.logging import bps_check, get_logger

log = get_logger("partition")

# Max partitions per declared tensor; keys are tensor_id * MAX_PARTS + i.
# 2**16 partitions * 4MB ≈ 256 GB per tensor — comfortably above any real
# tensor, and keeps keys stable as partition size is tuned downward.
MAX_PARTS_PER_TENSOR = 1 << 16


@dataclasses.dataclass(frozen=True)
class Partition:
    """One ~partition_bytes chunk of a declared tensor.

    Reference analog: one ``TensorTableEntry`` (byteps/common/common.h) —
    minus the runtime fields (buffers, callback), which live in the
    scheduler's task object here.
    """

    key: int           # globally unique partition key
    tensor_id: int
    part_idx: int      # index of this partition within its tensor
    offset: int        # element offset into the flattened tensor
    length: int        # element count
    priority: int      # = -tensor_id (higher = schedule earlier)
    # Sharded-wire hierarchical mode: the pod controller that carries this
    # partition over the DCN (rendezvous hash over the pod's live
    # controllers, see OwnerTable), set when DcnCore or eager's hybrid
    # pipeline enqueues it; 0, the only controller, with one. A LABEL
    # (the credit pool it draws from): the stages re-resolve the owner
    # through the OwnerTable, so an owner failover moves the wire without
    # rewriting tasks.
    owner: int = 0


@dataclasses.dataclass
class TensorContext:
    """Per-declared-tensor state (reference analog: ``BPSContext``)."""

    name: str
    tensor_id: int
    shape: Tuple[int, ...]
    dtype: np.dtype
    partitions: List[Partition]

    @property
    def priority(self) -> int:
        return -self.tensor_id

    @property
    def num_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def partition_length(itemsize: int, partition_bytes: int) -> int:
    """Elements per partition for a given byte budget (≥1)."""
    return max(1, partition_bytes // max(1, itemsize))


def make_partitions(
    tensor_id: int,
    num_elements: int,
    itemsize: int,
    partition_bytes: Optional[int] = None,
) -> List[Partition]:
    if partition_bytes is None:
        partition_bytes = get_config().partition_bytes
    plen = partition_length(itemsize, partition_bytes)
    n_parts = max(1, -(-num_elements // plen))
    bps_check(
        n_parts <= MAX_PARTS_PER_TENSOR,
        f"tensor {tensor_id} needs {n_parts} partitions > {MAX_PARTS_PER_TENSOR}",
    )
    parts = []
    for i in range(n_parts):
        off = i * plen
        parts.append(
            Partition(
                key=tensor_id * MAX_PARTS_PER_TENSOR + i,
                tensor_id=tensor_id,
                part_idx=i,
                offset=off,
                length=min(plen, num_elements - off),
                priority=-tensor_id,
            )
        )
    return parts


class TensorRegistry:
    """Declaration table: name → TensorContext. Thread-safe.

    Reference analog: ``BytePSGlobal``'s declared-tensor table
    (``byteps/common/global.cc``).
    """

    def __init__(self, partition_bytes: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._by_name: Dict[str, TensorContext] = {}
        self._next_id = 0
        self._partition_bytes = partition_bytes

    @property
    def partition_bytes(self) -> int:
        if self._partition_bytes is not None:
            return self._partition_bytes
        return get_config().partition_bytes

    def declare(
        self,
        name: str,
        shape: Sequence[int],
        dtype,
    ) -> TensorContext:
        """Idempotent per name; first call fixes id/priority/partitioning."""
        dtype = np.dtype(dtype)
        with self._lock:
            ctx = self._by_name.get(name)
            if ctx is not None:
                bps_check(
                    tuple(shape) == ctx.shape and dtype == ctx.dtype,
                    f"tensor '{name}' re-declared with different shape/dtype "
                    f"({tuple(shape)}/{dtype} vs {ctx.shape}/{ctx.dtype})",
                )
                return ctx
            tid = self._next_id
            self._next_id += 1
            nelem = int(np.prod(shape)) if len(shape) else 1
            ctx = TensorContext(
                name=name,
                tensor_id=tid,
                shape=tuple(shape),
                dtype=dtype,
                partitions=make_partitions(
                    tid, nelem, dtype.itemsize, self.partition_bytes
                ),
            )
            self._by_name[name] = ctx
            log.debug(
                "declared tensor '%s' id=%d parts=%d priority=%d",
                name, tid, len(ctx.partitions), ctx.priority,
            )
            return ctx

    def get(self, name: str) -> Optional[TensorContext]:
        with self._lock:
            return self._by_name.get(name)

    def snapshot(self) -> List[Tuple[str, TensorContext]]:
        """Locked point-in-time view of every declared tensor — for
        cross-tensor walks (owner failover's moved-partition diff) that
        must not race declare()/repartition()."""
        with self._lock:
            return list(self._by_name.items())

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_name)

    def repartition(self, partition_bytes: int) -> None:
        """Re-chunk all declared tensors (used by the auto-tuner)."""
        with self._lock:
            self._partition_bytes = partition_bytes
            for ctx in self._by_name.values():
                nelem = ctx.num_elements
                ctx.partitions = make_partitions(
                    ctx.tensor_id, nelem, ctx.dtype.itemsize, partition_bytes
                )


def owner_for_key(key: int, controllers, salt: int = 0) -> int:
    """Deterministic partition→controller placement: rendezvous hash over
    the given controller ranks (mirrors PSWorker._server_for_live's
    key→server hash, so owner remap composes with server failover — both
    layers move only the dead member's keys). zlib.crc32 is stable across
    processes/runs, unlike salted hash(); ``salt`` (BYTEPS_OWNER_SALT)
    lets a deployment reshuffle placement without renaming tensors."""
    ranks = list(controllers)
    bps_check(len(ranks) > 0, "owner_for_key: no live controllers")
    if len(ranks) == 1:
        return ranks[0]
    return max(ranks,
               key=lambda c: zlib.crc32(f"{key}:{c}:{salt}".encode()))


class OwnerTable:
    """Live-controller view for the sharded-wire hierarchical DCN tier.

    One per pod-controller process. Each partition key is owned by exactly
    one of the pod's ``n_controllers`` (rendezvous hash over the LIVE
    set): the owner alone COMPRESSes, PUSHes and PULLs that partition
    through its own NIC, dividing per-NIC DCN bytes by the live-controller
    count. ``fail(rank)`` shrinks the live set — only the dead
    controller's keys move (rendezvous property), exactly like the
    server-side key remap. Thread-safe; ``owner()`` is resolved at stage
    execution time so a stage retry after a failover lands on the
    survivor.
    """

    def __init__(self, n_controllers: int, salt: int = 0) -> None:
        bps_check(n_controllers >= 1, "OwnerTable needs >= 1 controller")
        self._lock = threading.Lock()
        self._live = set(range(n_controllers))
        self.n_controllers = n_controllers
        self.salt = salt

    def live(self):
        with self._lock:
            return set(self._live)

    def owner(self, key: int) -> int:
        with self._lock:
            live = set(self._live)
        return owner_for_key(key, live, self.salt)

    def owner_in(self, key: int, live) -> int:
        """Placement under an explicit live set (failover diffing)."""
        return owner_for_key(key, live, self.salt)

    def fail(self, rank: int) -> bool:
        """Mark a controller dead; False if already dead. Refuses to kill
        the last controller (the pod would have no wire at all — that is
        the total-DCN-outage degraded path's job, not ours)."""
        with self._lock:
            if rank not in self._live or len(self._live) == 1:
                return False
            self._live.discard(rank)
            return True
