"""byteps_tpu_torch.serve — the continuous-batching inference tier.

* ``paged_cache`` — a block-paged KV pool with per-request block
  tables, refcounted pages and a radix prefix index (copy-on-write at
  the divergence block, LRU eviction of idle pages).
* ``scheduler`` — iteration-level scheduling: continuous admission,
  chunked prefill, one packed decode batch, preemption with
  recompute-on-resume; tenants with KV quotas and fair queuing.
* ``adapter_pool`` — a paged pool of LoRA adapter slots on the device,
  which the packed decode step reads by per-row slot.

Greedy outputs equal single-request ``make_generate_fn`` runs token for
token; batching and paging move speed, never content.
"""

from byteps_tpu_torch.serve.adapter_pool import AdapterPool  # noqa: F401
from byteps_tpu_torch.serve.paged_cache import (  # noqa: F401
    PagedKVCache,
    PoolExhausted,
    PoolState,
    make_paged_decode_fn,
    make_paged_prefill_fn,
)
from byteps_tpu_torch.serve.scheduler import (  # noqa: F401
    NoProgressError,
    Request,
    Scheduler,
)
