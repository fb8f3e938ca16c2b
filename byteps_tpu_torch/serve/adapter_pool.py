"""Paged LoRA adapter pool: the KV pool's memory model applied to
adapter parameters (S-LoRA's weight paging).

Counterpart of ``byteps_tpu/serve/adapter_pool.py``. One base model,
many tenants: each tenant's LoRA A/B weights live in a fixed slot pool
on the device (``{target: {"a": (n_slots, L, d_in, rank_bucket), "b":
(n_slots, L, rank_bucket, d_out)}}`` float32), and the packed decode
step gathers each row's slabs by its slot index
(``ops/segmented_lora.py``).

* **Slot 0 is reserved** and all-zero forever: base-model and padded
  rows gather it and add exactly 0.0.
* **Refcounted residency**: ``acquire`` pins an adapter for one holder
  (a request id); an adapter with live holders is never evicted.
  ``release`` at refcount 0 keeps it resident (cached-idle).
* **All-or-nothing**: a failed ``acquire`` changes nothing; with every
  slot pinned it raises :class:`~byteps_tpu_torch.serve.paged_cache.
  PoolExhausted` with the occupancy breakdown.
* **LRU eviction of idle adapters** under slot pressure; the host
  registry (the padded, scale-folded slabs ``register`` keeps on the
  CPU) is the reload source.
* **Leak accounting**: ``leaked_slots()`` from the residency map itself,
  ``check_refcounts()`` against the holder sets.

Where the reference rebinds a new slab array on each load, ``_load``
writes the slot's rows in place.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Set

import torch

from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.models.gpt import GPTConfig
from byteps_tpu_torch.models.lora import (
    _check_targets,
    _target_dims,
    graft_blocks,
    lora_pool_slabs,
    lora_rank,
)
from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.serve.paged_cache import PoolExhausted

__all__ = ["AdapterPool"]

# pool instance sequence for per-pool gauge series
_APOOL_SEQ = itertools.count()


class AdapterPool:
    """Device-resident LoRA slot pool + host-side adapter registry.

    ``n_slots`` counts the reserved zero slot 0; ``rank_bucket`` is the
    pool-wide padded rank; ``targets`` the target set every registered
    adapter must cover. Omitted sizing falls back to
    ``BYTEPS_SERVE_ADAPTER_SLOTS`` / ``BYTEPS_SERVE_ADAPTER_RANK_BUCKET``
    (the former defaults to 0, so an env-sized pool must be enabled).
    The slabs live on ``device``, the card unless told otherwise.
    """

    def __init__(self, cfg: GPTConfig, *, n_slots: Optional[int] = None,
                 rank_bucket: Optional[int] = None,
                 targets: Sequence[str] = ("wq", "wv"), device=None):
        c = get_config()
        if n_slots is None:
            n_slots = c.serve_adapter_slots
        if rank_bucket is None:
            rank_bucket = c.serve_adapter_rank_bucket
        if n_slots < 2:
            raise ValueError(
                f"n_slots ({n_slots}) must hold the reserved zero slot "
                "plus at least one loadable slot")
        if rank_bucket < 1:
            raise ValueError(f"rank_bucket must be >= 1; got {rank_bucket}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.rank_bucket = rank_bucket
        self.targets = _check_targets(cfg, targets)
        L = cfg.n_layers
        self.slabs: Dict[str, Dict[str, torch.Tensor]] = {}
        for t in self.targets:
            d_in, d_out = _target_dims(cfg, t)
            self.slabs[t] = {
                "a": torch.zeros((n_slots, L, d_in, rank_bucket),
                                 device=self.device),
                "b": torch.zeros((n_slots, L, rank_bucket, d_out),
                                 device=self.device),
            }
        # host registry: the reload source (CPU slabs) + the rank
        self._registry: Dict[Any, Dict[str, Any]] = {}
        self._graft_cache: Dict[Any, Any] = {}
        # LIFO free list over slots 1..n_slots-1 (0 = zero, reserved)
        self._free: List[int] = list(range(n_slots - 1, 0, -1))
        self._slot: Dict[Any, int] = {}      # resident adapter -> slot
        self._ref: Dict[Any, int] = {}       # resident adapter -> pins
        self._holders: Dict[Any, Set[Any]] = {}   # ground truth for _ref
        self._lru_tick = 0
        self._last_used: Dict[Any, int] = {}
        _reg = get_registry()
        seq = next(_APOOL_SEQ)
        self._g_live = _reg.gauge(f"serve.apool{seq}.live_adapters")
        self._g_cached = _reg.gauge(f"serve.apool{seq}.cached_adapters")
        self._c_loads = _reg.counter("serve.adapter_loads")
        self._c_evict = _reg.counter("serve.adapter_evictions")
        self._c_fail = _reg.counter("serve.adapter_alloc_failures")

    # -- registry ------------------------------------------------------------
    def register(self, adapter_id, adapters: Dict[str, Any],
                 scale: float = 1.0) -> None:
        """Admit an adapter tree (tensors on any device) to the host
        registry, not the device pool: residency is paged in by
        :meth:`acquire`/:meth:`prefetch`. Rank and target coverage are
        checked here, so a bad adapter fails now, not at first use."""
        if adapter_id in self._registry:
            raise ValueError(f"adapter {adapter_id!r} already registered")
        slabs = lora_pool_slabs(adapters, self.cfg, self.rank_bucket,
                                scale, self.targets)
        self._registry[adapter_id] = {
            "slabs": {t: {k: v.cpu() for k, v in ts.items()}
                      for t, ts in slabs.items()},
            "rank": lora_rank(adapters),
        }

    def unregister(self, adapter_id) -> None:
        """Drop an adapter from the registry (and its slot, when
        cached-idle). Refuses while the adapter has live holders."""
        if self._ref.get(adapter_id, 0) > 0:
            raise ValueError(
                f"adapter {adapter_id!r} has {self._ref[adapter_id]} live "
                "holder(s) — release them before unregistering")
        if adapter_id in self._slot:
            self._evict(adapter_id)
        del self._registry[adapter_id]
        self._graft_cache.pop(adapter_id, None)

    def registered(self, adapter_id) -> bool:
        return adapter_id in self._registry

    def rank_of(self, adapter_id) -> int:
        return self._registry[adapter_id]["rank"]

    def graft(self, base_params, adapter_id):
        """The adapter's solo grafted tree, built from the pool's own
        padded, scale-folded slabs (scale 1 at graft), so prefill chunks
        (this tree), the packed decode (the device slabs) and a solo
        ``make_generate_fn`` run all compute the same delta. Cached per
        adapter; every base leaf is shared by reference."""
        p = self._graft_cache.get(adapter_id)
        if p is None:
            host = self._registry[adapter_id]["slabs"]
            dev = base_params["wte"].device
            p = graft_blocks(base_params, [
                {t: {k: host[t][k][li].to(dev) for k in ("a", "b")}
                 for t in self.targets}
                for li in range(self.cfg.n_layers)])
            self._graft_cache[adapter_id] = p
        return p

    # -- accounting ----------------------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def live_adapters(self) -> int:
        return sum(1 for r in self._ref.values() if r > 0)

    @property
    def cached_adapters(self) -> int:
        return sum(1 for r in self._ref.values() if r == 0)

    def leaked_slots(self) -> int:
        """Slots neither free nor held by a resident adapter — 0 at
        drain, computed from the residency map itself."""
        return (self.n_slots - 1) - len(self._free) \
            - len(set(self._slot.values()))

    def check_refcounts(self) -> None:
        """Test invariant: refcounts equal the holder sets; the slot map
        and free list partition the allocatable slots. Raises
        AssertionError on drift."""
        for aid, r in self._ref.items():
            if r != len(self._holders.get(aid, ())) or r < 0:
                raise AssertionError(
                    f"refcount drift for adapter {aid!r}: {r} != "
                    f"{len(self._holders.get(aid, ()))}")
        if set(self._ref) != set(self._slot):
            raise AssertionError("resident map / refcount map diverged")
        slots = list(self._slot.values())
        if len(slots) != len(set(slots)):
            raise AssertionError("two adapters share a slot")
        if set(slots) & set(self._free):
            raise AssertionError("free list overlaps resident slots")
        if 0 in slots or 0 in self._free:
            raise AssertionError("reserved zero slot was allocated")
        if self.leaked_slots():
            raise AssertionError(
                f"{self.leaked_slots()} leaked adapter slot(s)")

    def _exhausted_msg(self, adapter_id) -> str:
        leaked = self.leaked_slots()
        return (f"adapter {adapter_id!r} needs a slot, pool has "
                f"{len(self._free)} free — occupancy: "
                f"{self.n_slots - 1} allocatable = "
                f"{self.live_adapters} live adapter(s) + "
                f"{self.cached_adapters} cached-idle + "
                f"{len(self._free)} free"
                + (f" + {leaked} LEAKED" if leaked else ""))

    # -- residency -----------------------------------------------------------
    def _touch(self, adapter_id) -> None:
        self._lru_tick += 1
        self._last_used[adapter_id] = self._lru_tick

    def _load(self, adapter_id, slot: int) -> None:
        host = self._registry[adapter_id]["slabs"]
        for t in self.targets:
            for k in ("a", "b"):
                self.slabs[t][k][slot] = host[t][k]
        self._c_loads.inc()

    def _evict(self, adapter_id) -> None:
        """Drop a cached-idle adapter's slot. Its device rows go stale
        rather than zeroed: no live row can gather a freed slot."""
        assert self._ref.get(adapter_id, 0) == 0
        self._free.append(self._slot.pop(adapter_id))
        del self._ref[adapter_id]
        self._holders.pop(adapter_id, None)
        self._last_used.pop(adapter_id, None)
        self._c_evict.inc()

    def _alloc_slot(self, adapter_id) -> int:
        if not self._free:
            idle = sorted((aid for aid, r in self._ref.items() if r == 0),
                          key=lambda aid: self._last_used.get(aid, 0))
            if idle:
                self._evict(idle[0])
        if not self._free:
            self._c_fail.inc()
            raise PoolExhausted(self._exhausted_msg(adapter_id))
        return self._free.pop()

    def _make_resident(self, slot: int, adapter_id) -> None:
        self._slot[adapter_id] = slot
        self._ref[adapter_id] = 0
        self._load(adapter_id, slot)

    def acquire(self, adapter_id, holder) -> int:
        """Pin ``adapter_id`` for ``holder`` (a request id), loading it
        into a slot if it is not resident. Returns the slot index.
        All-or-nothing: on :class:`PoolExhausted` nothing changed."""
        if adapter_id not in self._registry:
            raise KeyError(f"adapter {adapter_id!r} is not registered")
        holders = self._holders.setdefault(adapter_id, set())
        if holder in holders:
            raise ValueError(f"holder {holder!r} already pinned adapter "
                             f"{adapter_id!r}")
        if adapter_id not in self._slot:
            self._make_resident(self._alloc_slot(adapter_id), adapter_id)
        holders.add(holder)
        self._ref[adapter_id] += 1
        self._touch(adapter_id)
        self._update_gauges()
        return self._slot[adapter_id]

    def release(self, adapter_id, holder) -> None:
        """Unpin one holder. At refcount 0 the adapter stays resident
        (cached-idle, LRU-evictable)."""
        holders = self._holders.get(adapter_id)
        if not holders or holder not in holders:
            raise ValueError(
                f"holder {holder!r} does not pin adapter {adapter_id!r}")
        holders.remove(holder)
        self._ref[adapter_id] -= 1
        self._update_gauges()

    def prefetch(self, adapter_id) -> bool:
        """Best-effort warm-up into a FREE slot only (never evicts).
        True when the adapter is resident after the call."""
        if adapter_id not in self._registry:
            raise KeyError(f"adapter {adapter_id!r} is not registered")
        if adapter_id in self._slot:
            self._touch(adapter_id)
            return True
        if not self._free:
            return False
        self._make_resident(self._free.pop(), adapter_id)
        self._touch(adapter_id)
        self._update_gauges()
        return True

    def evict_idle(self, adapter_id) -> None:
        """Drop a cached-idle adapter's slot. Refuses for live adapters."""
        if adapter_id not in self._slot:
            raise KeyError(f"adapter {adapter_id!r} is not resident")
        if self._ref[adapter_id] > 0:
            raise ValueError(
                f"adapter {adapter_id!r} has {self._ref[adapter_id]} live "
                "holder(s) — live adapters are never evicted")
        self._evict(adapter_id)
        self._update_gauges()

    def slot_of(self, adapter_id) -> int:
        """The resident slot (KeyError when not resident)."""
        return self._slot[adapter_id]

    def resident(self, adapter_id) -> bool:
        return adapter_id in self._slot

    def _update_gauges(self) -> None:
        self._g_live.set(self.live_adapters)
        self._g_cached.set(self.cached_adapters)
