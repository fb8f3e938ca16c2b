"""Typed runtime configuration fed by ``BYTEPS_*`` environment variables.

A lean copy of ``byteps_tpu/common/config.py`` holding only what the
ported slices read: the log level, the metrics switch, the ``serve_*``
knobs of the continuous-batching tier (adapter pool, tenant quotas and
fair queuing included), and the gradient-aggregation
knobs of the data-parallel training step (partition size, reduce dtype,
the onebit codec's scaling default, the ICI wire tier), under the same
variable names and defaults.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

# the reference's BYTEPS_PARTITION_BYTES default (byteps/common/global.cc)
DEFAULT_PARTITION_BYTES = 4096000
REDUCE_DTYPES = ("float32", "bfloat16")
# wire tiers of the compressed collectives (comm/ici.py)
ICI_TIERS = ("staged", "ring")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return int(v)


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.strip().lower() in ("1", "true", "on", "yes", "y")


@dataclasses.dataclass
class Config:
    """Process-wide runtime configuration of the port."""

    log_level: str = "INFO"
    # BYTEPS_METRICS_ON=0 swaps every metric handle for a shared no-op
    metrics_on: bool = True

    # --- inference serving tier --------------------------------------------
    # KV block size (tokens per paged-cache block); should divide the
    # model's max_seq so the gathered views carry no zero tail.
    serve_block_size: int = 16
    # Physical KV blocks in the preallocated pool. 0 = auto: enough for
    # max_batch full-length requests plus the reserved scratch block.
    # Smaller pools oversubscribe and trigger preemption with
    # recompute-on-resume.
    serve_pool_blocks: int = 0
    # Decode-batch slots: rows of one packed decode step.
    serve_max_batch: int = 8
    # Prefill chunk length in tokens: a long prompt is fed this many
    # tokens per scheduler iteration so it cannot starve the decode lane.
    serve_prefill_chunk: int = 32
    # int8-quantized KV pool with per-(position, head) f32 scales.
    serve_quant_cache: bool = False
    # Radix prefix cache over the paged pool: requests sharing a prompt
    # prefix map the same physical pages (copy-on-write at the
    # divergence block). Outputs are identical either way; 0 turns it off.
    serve_prefix_cache: bool = True
    # Device-resident LoRA adapter-pool slots (slot 0 is the reserved
    # all-zero base-model slot, so N slots serve N-1 live adapters; idle
    # ones stay cached in place, LRU). 0 = no pool: the scheduler serves
    # the bare base model and rejects adapter-tagged requests.
    serve_adapter_slots: int = 0
    # Rank every pooled adapter is zero-padded to, so mixed-rank tenants
    # share one packed decode step; a higher rank is refused at register.
    serve_adapter_rank_bucket: int = 8
    # Per-tenant KV-pool quota in blocks (0 = off): growth past it
    # preempts the tenant's own youngest run, never a sibling's.
    serve_tenant_quota_blocks: int = 0
    # Deficit-weighted fair queuing across tenants at admission;
    # single-tenant traffic is plain FIFO either way.
    serve_fair_queue: bool = True

    # --- gradient aggregation (data-parallel training) ---------------------
    # Bytes per aggregation chunk: the flat gradient is cut into chunks of
    # this many bytes, each aggregated (and compressed) on its own.
    partition_bytes: int = DEFAULT_PARTITION_BYTES
    # dtype of uncompressed chunk sums (one of REDUCE_DTYPES); bfloat16
    # halves the bytes summed at bf16 precision. Compression always
    # aggregates f32.
    reduce_dtype: str = "float32"
    # onebit codec: scale = mean(|x|) (True) or 1 when the compressor is
    # built without an explicit ``scaling``
    compressor_onebit_scaling: bool = True
    # Wire transport of the compressed collectives (comm/ici.py): "staged"
    # = one all_to_all and one all_gather per payload leaf; "ring" = n-1
    # ring hops through the hand-written peer-copy kernels on the card
    # (ops/ring_collective_kernels.py), bit-equal to staged for
    # deterministic codecs. Checked where it is used (ici._resolve_tier).
    ici_tier: str = "staged"

    def __post_init__(self):
        if self.reduce_dtype not in REDUCE_DTYPES:
            raise ValueError(f"BYTEPS_REDUCE_DTYPE={self.reduce_dtype!r}: "
                             f"expected one of {REDUCE_DTYPES}")

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            log_level=os.environ.get("BYTEPS_LOG_LEVEL", "INFO").upper(),
            metrics_on=_env_bool("BYTEPS_METRICS_ON", True),
            serve_block_size=_env_int("BYTEPS_SERVE_BLOCK_SIZE", 16),
            serve_pool_blocks=_env_int("BYTEPS_SERVE_POOL_BLOCKS", 0),
            serve_max_batch=_env_int("BYTEPS_SERVE_MAX_BATCH", 8),
            serve_prefill_chunk=_env_int("BYTEPS_SERVE_PREFILL_CHUNK", 32),
            serve_quant_cache=_env_bool("BYTEPS_SERVE_QUANT_CACHE"),
            serve_prefix_cache=_env_bool("BYTEPS_SERVE_PREFIX_CACHE", True),
            serve_adapter_slots=_env_int("BYTEPS_SERVE_ADAPTER_SLOTS", 0),
            serve_adapter_rank_bucket=_env_int(
                "BYTEPS_SERVE_ADAPTER_RANK_BUCKET", 8),
            serve_tenant_quota_blocks=_env_int(
                "BYTEPS_SERVE_TENANT_QUOTA_BLOCKS", 0),
            serve_fair_queue=_env_bool("BYTEPS_SERVE_FAIR_QUEUE", True),
            partition_bytes=_env_int("BYTEPS_PARTITION_BYTES",
                                     DEFAULT_PARTITION_BYTES),
            reduce_dtype=os.environ.get("BYTEPS_REDUCE_DTYPE") or "float32",
            compressor_onebit_scaling=_env_bool(
                "BYTEPS_COMPRESSOR_ONEBIT_SCALING", True),
            ici_tier=os.environ.get("BYTEPS_ICI_TIER") or "staged",
        )


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config


def reset_config() -> None:
    """Drop the cached config so the next read re-parses the environment."""
    global _config
    _config = None
