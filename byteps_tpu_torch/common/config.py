"""Typed runtime configuration fed by ``BYTEPS_*`` environment variables.

A lean copy of ``byteps_tpu/common/config.py`` holding only what the
ported slices read: the log level, the metrics switch, the ``serve_*``
knobs of the continuous-batching tier (adapter pool, tenant quotas and
fair queuing included), the gradient-aggregation
knobs of the data-parallel training step (partition size, reduce dtype,
the onebit codec's scaling default, the ICI wire tier), and the
``DMLC_*`` topology and ``BYTEPS_*`` knobs of the DCN parameter-server
tier, under the same variable names and defaults.

The tier's robustness knobs (fault injection, the health monitor,
degraded fallback, the handle deadline), the sharded pod wire over
several controllers (``BYTEPS_POD_CONTROLLERS``, ``BYTEPS_OWNER_SALT``)
and the in-process IPC path (``BYTEPS_ENABLE_IPC``) are ported. Its
knobs that are not ported yet (asynchronous or stale rounds, worker
leases, the auto-tuner, a fault plan's ``join`` rule) are parsed all the
same, so that :func:`check_ported` can refuse a caller who sets one
instead of silently running the default.
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
# the reference's BYTEPS_SCHEDULING_CREDIT default (scheduled_queue.cc)
DEFAULT_SCHEDULING_CREDIT = 4
DEFAULT_SERVER_ENGINE_THREADS = 4


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


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return float(v)


@dataclasses.dataclass
class Config:
    """Process-wide runtime configuration of the port."""

    log_level: str = "INFO"
    # BYTEPS_METRICS_ON=0 swaps every metric handle for a shared no-op
    metrics_on: bool = True

    # --- DMLC_* cluster topology (DCN parameter-server tier) ---------------
    role: str = "worker"  # scheduler | server | worker | joint
    num_worker: int = 1
    num_server: int = 0
    # server i listens on ps_root_port + 1 + i at ps_root_uri
    ps_root_uri: str = "127.0.0.1"
    ps_root_port: int = 9000
    worker_id: int = 0
    local_rank: int = 0
    local_size: int = 1
    # run the hybrid (server) pipeline of ``eager`` even with one pod
    force_distributed: bool = False

    # --- DCN tier tuning ---------------------------------------------------
    # partitions in flight between COMPRESS and the end of PUSH
    scheduling_credit: int = DEFAULT_SCHEDULING_CREDIT
    server_engine_threads: int = DEFAULT_SERVER_ENGINE_THREADS
    # a contended server engine sums and answers lower keys first
    server_enable_schedule: bool = False
    # the server fails a pull that waited longer than this (0: never)
    pull_timeout_ms: int = 60000
    # partitions below this many bytes ride the raw f32 wire
    min_compress_bytes: int = 65536
    # > 0 paces each PSWorker's payload bytes at this many megabits/s
    dcn_throttle_mbps: float = 0.0
    # wire retries per op (exponential backoff from retry_backoff_ms,
    # x2 an attempt, capped at 2 s, seeded jitter); replays are deduped
    # server-side by (worker, key, round)
    retry_limit: int = 8
    retry_backoff_ms: int = 50
    # CRC32 of every push (checked before the sum) and pull response;
    # forced on while a fault plan injects corruption
    wire_crc: bool = False
    # deterministic fault injection at the PSWorker wire boundary
    # (common/faults.py grammar), seeded per worker; empty = off
    fault_spec: str = ""
    fault_seed: int = 0
    # > 0: a thread pings every live server each interval, and after
    # health_miss_limit consecutive misses fails the server over (its
    # keys move to the survivors); 0 = no monitor
    health_interval_ms: int = 0
    health_miss_limit: int = 3
    # no live server left: degrade push_pull to the local (DcnCore) or
    # pod-local (eager's hybrid) sum, warning once; False fails the handle
    degraded_ok: bool = True
    # > 0 caps every Handle.wait at this many ms with a StallError that
    # carries the pipeline's counters; 0 = the caller's timeout only
    handle_deadline_ms: int = 0

    # pushes, pulls and inits of keys homed on a summation server running
    # in this process skip TCP (server/__init__.py, PSWorker(use_ipc=))
    enable_ipc: bool = False
    # the hybrid pipeline reduce-scatters the pod and all-gathers the
    # global sums (else all-reduce and broadcast)
    hybrid_sharded: bool = True
    # controller NICs a sharded pod pushes through, each its own PSWorker
    # (connections, fault plan, health monitor); a partition's owner is
    # a rendezvous hash over the live controllers (partition.OwnerTable)
    pod_controllers: int = 1
    # salt of that hash: reshuffles placement without renaming tensors;
    # must agree across a pod's controllers
    owner_salt: int = 0

    # --- DCN tier knobs not ported yet (check_ported refuses them) ---------
    enable_async: bool = False
    staleness: int = 0
    worker_lease_ms: int = 0
    auto_tune: bool = False

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

    @property
    def is_distributed(self) -> bool:
        """The hybrid pipeline over the summation servers (several pods,
        or one pod forced onto them) rather than the pod's collectives
        alone."""
        return self.num_worker > 1 or self.force_distributed

    def __post_init__(self):
        if self.reduce_dtype not in REDUCE_DTYPES:
            raise ValueError(f"BYTEPS_REDUCE_DTYPE={self.reduce_dtype!r}: "
                             f"expected one of {REDUCE_DTYPES}")

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            log_level=os.environ.get("BYTEPS_LOG_LEVEL", "INFO").upper(),
            metrics_on=_env_bool("BYTEPS_METRICS_ON", True),
            role=os.environ.get("DMLC_ROLE", "worker"),
            num_worker=_env_int("DMLC_NUM_WORKER", 1),
            num_server=_env_int("DMLC_NUM_SERVER", 0),
            ps_root_uri=os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"),
            ps_root_port=_env_int("DMLC_PS_ROOT_PORT", 9000),
            worker_id=_env_int("DMLC_WORKER_ID", 0),
            local_rank=_env_int("BYTEPS_LOCAL_RANK", 0),
            local_size=_env_int("BYTEPS_LOCAL_SIZE", 1),
            force_distributed=_env_bool("BYTEPS_FORCE_DISTRIBUTED"),
            scheduling_credit=_env_int("BYTEPS_SCHEDULING_CREDIT",
                                       DEFAULT_SCHEDULING_CREDIT),
            server_engine_threads=_env_int("BYTEPS_SERVER_ENGINE_THREAD",
                                           DEFAULT_SERVER_ENGINE_THREADS),
            server_enable_schedule=_env_bool("BYTEPS_SERVER_ENABLE_SCHEDULE"),
            pull_timeout_ms=_env_int("BYTEPS_SERVER_PULL_TIMEOUT_MS", 60000),
            min_compress_bytes=_env_int("BYTEPS_MIN_COMPRESS_BYTES", 65536),
            dcn_throttle_mbps=_env_float("BYTEPS_DCN_THROTTLE_MBPS", 0.0),
            retry_limit=_env_int("BYTEPS_RETRY_LIMIT", 8),
            retry_backoff_ms=_env_int("BYTEPS_RETRY_BACKOFF_MS", 50),
            wire_crc=_env_bool("BYTEPS_WIRE_CRC"),
            fault_spec=os.environ.get("BYTEPS_FAULT_SPEC", ""),
            fault_seed=_env_int("BYTEPS_FAULT_SEED", 0),
            health_interval_ms=_env_int("BYTEPS_HEALTH_INTERVAL_MS", 0),
            health_miss_limit=_env_int("BYTEPS_HEALTH_MISS_LIMIT", 3),
            degraded_ok=_env_bool("BYTEPS_DEGRADED_OK", True),
            handle_deadline_ms=_env_int("BYTEPS_HANDLE_DEADLINE_MS", 0),
            enable_async=_env_bool("BYTEPS_ENABLE_ASYNC"),
            enable_ipc=_env_bool("BYTEPS_ENABLE_IPC"),
            staleness=max(0, _env_int("BYTEPS_STALENESS", 0)),
            worker_lease_ms=_env_int("BYTEPS_WORKER_LEASE_MS", 0),
            hybrid_sharded=_env_bool("BYTEPS_HYBRID_SHARDED", True),
            pod_controllers=_env_int("BYTEPS_POD_CONTROLLERS", 1),
            owner_salt=_env_int("BYTEPS_OWNER_SALT", 0),
            auto_tune=_env_bool("BYTEPS_AUTO_TUNE"),
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


def check_ported(cfg: Optional[Config] = None) -> None:
    """Refuse, naming the knob, any DCN-tier setting whose behaviour the
    port does not have yet, instead of running the synchronous default
    in its place. Called where the tier starts: ``start_server``,
    ``PSWorker``, ``DcnCore`` and ``eager.init``. A fault spec is parsed
    here, so a malformed one fails at start; its ``join`` rules (elastic
    membership) are refused."""
    from byteps_tpu_torch.common.logging import bps_check

    cfg = cfg or get_config()
    joins = []
    if cfg.fault_spec:
        from byteps_tpu_torch.common.faults import parse_fault_spec

        joins = [r.to_spec() for r in parse_fault_spec(cfg.fault_spec)
                 if r.kind == "join"]
    for knob, unported in (
            ("BYTEPS_ENABLE_ASYNC", cfg.enable_async),
            ("BYTEPS_STALENESS", cfg.staleness > 0),
            ("BYTEPS_WORKER_LEASE_MS", cfg.worker_lease_ms > 0),
            (f"BYTEPS_FAULT_SPEC join rule {joins}", bool(joins)),
            ("BYTEPS_AUTO_TUNE", cfg.auto_tune)):
        bps_check(not unported,
                  f"{knob} is set, and the port's DCN tier has not ported "
                  "it yet (not ported yet)")
