"""Elastic data sharding: the shard map recomputed from the live bitmap
(the port's copy of ``byteps_tpu/data/elastic.py``, numpy only).

Mid-stream worker churn (eviction, ``kJoin`` admission) changes WHO
consumes the input stream, but the epoch's data contract must not
change: within an epoch window no example may be dropped and none
visited twice. :class:`ElasticShardMap` is the deterministic shard
authority every worker holds a replica of — same ``(seed, epoch)`` ⇒
same global visit order on every host, so recomputing the assignment
from the adopted live set needs no coordination beyond the membership
epoch itself (exactly like the rendezvous-hashed key→server placement:
agreement through shared determinism, not messages).

Usage at an epoch adoption (an ``eager.on_membership_change`` hook, or
the host adapters' own membership callbacks)::

    smap = ElasticShardMap(n_examples, seed=epoch_seed)
    shard = smap.shard_for(my_id, live_ids)      # consume in order...
    smap.advance(consumed)                       # ...at round boundaries
    # membership changed (join/evict): the UNVISITED remainder re-splits
    shard = smap.shard_for(my_id, new_live_ids)

Pinned invariants (tests/test_torch_data.py):

* the union of all live workers' shards is EXACTLY the unvisited
  remainder of the epoch's global order — nothing dropped;
* shards are pairwise disjoint — nothing double-visited;
* the assignment is a pure function of ``(seed, epoch, cursor,
  live_ids)`` — every worker computes the same map independently.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np

__all__ = ["ElasticShardMap", "live_ids_from_bitmap"]


def live_ids_from_bitmap(bitmap: Sequence[int]) -> List[int]:
    """Worker ids marked live in a ``kMembers`` bitmap (the server's
    per-worker live array) — the bridge from the membership layer's view
    to the shard map's ``live_ids`` argument."""
    return [i for i, b in enumerate(bitmap) if b]


class ElasticShardMap:
    """Deterministic elastic shard assignment over one epoch window."""

    def __init__(self, n_examples: int, seed: int = 0):
        if n_examples <= 0:
            raise ValueError(f"n_examples must be > 0, got {n_examples}")
        self.n_examples = int(n_examples)
        self.seed = int(seed)
        self.epoch = 0
        self._order = self._perm()
        self._cursor = 0

    def _perm(self) -> np.ndarray:
        # seeded by (seed, epoch): a fresh shuffle per epoch, identical
        # on every worker without coordination
        return np.random.default_rng(
            (self.seed, self.epoch)).permutation(self.n_examples)

    # -- epoch window cursor -------------------------------------------------
    @property
    def remaining(self) -> int:
        """Unvisited examples left in this epoch window."""
        return self.n_examples - self._cursor

    def advance(self, n: int) -> None:
        """Mark the next ``n`` examples of the GLOBAL order visited (call
        at round boundaries with the globally-consumed count — every
        worker advances identically, keeping the maps in agreement)."""
        if n < 0:
            raise ValueError(f"cannot advance by {n}")
        self._cursor = min(self.n_examples, self._cursor + int(n))

    def next_epoch(self) -> None:
        """Open the next epoch window: fresh deterministic shuffle, the
        cursor rewinds, and every example is visitable again."""
        self.epoch += 1
        self._order = self._perm()
        self._cursor = 0

    # -- assignment ----------------------------------------------------------
    def assign(self, live_ids: Iterable[int]) -> Dict[int, np.ndarray]:
        """Split the UNVISITED remainder of the epoch's global order over
        the live workers (contiguous near-equal chunks in ascending
        worker-id order). Recomputing after a membership change
        reassigns only what nobody has consumed yet — the visited prefix
        is never handed out again, so no example is dropped or
        double-visited within the epoch window."""
        ids = sorted({int(w) for w in live_ids})
        if not ids:
            raise ValueError("no live workers to shard the epoch over")
        chunks = np.array_split(self._order[self._cursor:], len(ids))
        return {w: chunks[i] for i, w in enumerate(ids)}

    def shard_for(self, worker_id: int,
                  live_ids: Iterable[int]) -> np.ndarray:
        """This worker's slice of :meth:`assign` (raises if it is not in
        the live set — an evicted worker holds no shard)."""
        shards = self.assign(live_ids)
        if int(worker_id) not in shards:
            raise ValueError(
                f"worker {worker_id} is not in the live set "
                f"{sorted(shards)} — evicted workers hold no shard")
        return shards[int(worker_id)]
