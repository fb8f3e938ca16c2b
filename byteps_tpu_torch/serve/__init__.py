"""byteps_tpu_torch.serve — the continuous-batching inference tier.

* ``paged_cache`` — a block-paged KV pool with per-request block
  tables, refcounted pages and a radix prefix index (copy-on-write at
  the divergence block, LRU eviction of idle pages).
* ``scheduler`` — iteration-level scheduling: continuous admission,
  chunked prefill, speculative decoding as a per-request policy, one
  packed decode batch, preemption with recompute-on-resume; tenants with
  KV quotas and fair queuing; fault plans; the prefill and decode roles
  of disaggregation.
* ``router`` — multi-replica routing with lease/epoch liveness: a dead
  replica's requests re-queue on the survivors; replica autoscaling;
  disaggregated prefill/decode and migrate-don't-evict.
* ``adapter_pool`` — a paged pool of LoRA adapter slots on the device,
  which the packed decode step reads by per-row slot.
* ``kv_wire`` — the KV-block codec and the KVCOMPRESS → KVPUSH migration
  wire between replicas.

Greedy outputs equal single-request ``make_generate_fn`` runs token for
token; batching, paging, speculation, failover and migration move speed,
never content.
"""

from byteps_tpu_torch.serve.adapter_pool import AdapterPool  # noqa: F401
from byteps_tpu_torch.serve.kv_wire import (  # noqa: F401
    BlockPayload,
    KVBlockCodec,
    KVWire,
    MigrationTicket,
)
from byteps_tpu_torch.serve.paged_cache import (  # noqa: F401
    PagedKVCache,
    PoolExhausted,
    PoolState,
    make_paged_decode_fn,
    make_paged_prefill_fn,
)
from byteps_tpu_torch.serve.router import (  # noqa: F401
    NoLiveReplicasError,
    Router,
)
from byteps_tpu_torch.serve.scheduler import (  # noqa: F401
    NoProgressError,
    Request,
    Scheduler,
    SpecPolicy,
)
