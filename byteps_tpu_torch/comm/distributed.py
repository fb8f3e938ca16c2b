"""Multi-host rendezvous: the global ``torch.distributed`` group from the
``DMLC_*`` environment (the port's counterpart of
``byteps_tpu/comm/distributed.py``, which brings up ``jax.distributed``).

Reference analog: ps-lite's scheduler rendezvous — every worker connects
to the root address, gets a rank and joins the group before training
starts. Here worker ``DMLC_WORKER_ID`` of ``DMLC_NUM_WORKER`` joins one
``torch.distributed`` group whose TCP store worker 0 hosts at
``BYTEPS_JAX_COORD_URI:BYTEPS_JAX_COORD_PORT`` (default: the DMLC root
address, where reference launch scripts already point; the summation
servers bind root port + 1 + i, so they do not clash).

Two topologies, as in the reference:

* **hybrid PS** (the default when ``DMLC_NUM_WORKER > 1``): every
  worker is its own pod, its own group (or none); pods aggregate through
  the summation servers.
* **global group** (``BYTEPS_JAX_DISTRIBUTED=1``, the reference's switch,
  kept so launch scripts carry over): the workers form ONE group, and the
  train factories, ``eager`` and ``comm.mesh.device_mesh`` span it;
  ``Config.is_distributed`` turns off, so aggregation is pure
  collectives.

The group's backend is gloo: the ranks of this tier may share one card,
and NCCL refuses two ranks on one device (``scripts/
torch_nccl_one_card.py``). The store binds through ``server.any_port``
(this image's ephemeral range starts at 16000, so a client socket can
squat a fixed port): worker 0 takes the first free port from the
coordinator port up, and the other workers find it by probing the same
ports in the same order (a squatting client socket refuses connections;
the store accepts them).
"""

from __future__ import annotations

import datetime
import errno
import socket
import threading
import time

from byteps_tpu_torch.common.config import Config, get_config
from byteps_tpu_torch.common.logging import get_logger

log = get_logger("comm.distributed")

__all__ = ["maybe_init_distributed", "is_multiprocess"]

_lock = threading.Lock()
_initialized = False
# how long a worker waits for the store and its peers
_RENDEZVOUS_S = 300
# ports probed from the coordinator port (server.any_port's default)
_PORT_ATTEMPTS = 16


def _host_store(cfg: Config, timeout: datetime.timedelta):
    """Worker 0's store, bound through ``any_port``."""
    import torch.distributed as dist

    from byteps_tpu_torch.server import any_port

    def bind(port: int):
        try:
            return dist.TCPStore(cfg.global_coord_uri, port, cfg.num_worker,
                                 is_master=True, timeout=timeout,
                                 wait_for_workers=False)
        except RuntimeError as e:
            if "EADDRINUSE" in str(e) or "address already in use" in str(e):
                raise OSError(errno.EADDRINUSE, str(e)) from e
            raise

    return any_port(bind, cfg.global_coord_port, attempts=_PORT_ATTEMPTS)


def _join_store(cfg: Config, timeout: datetime.timedelta):
    """A peer's connection to worker 0's store: the first port of the
    probe sequence that accepts a connection."""
    import torch.distributed as dist

    deadline = time.monotonic() + timeout.total_seconds()
    while True:
        for i in range(_PORT_ATTEMPTS):
            port = cfg.global_coord_port + i
            try:
                socket.create_connection((cfg.global_coord_uri, port),
                                         timeout=1.0).close()
            except OSError:
                continue
            return dist.TCPStore(cfg.global_coord_uri, port, cfg.num_worker,
                                 is_master=False, timeout=timeout)
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"no rendezvous store at {cfg.global_coord_uri}:"
                f"{cfg.global_coord_port}+ within {timeout.total_seconds()} "
                "s (is worker 0 up?)")
        time.sleep(0.1)


def maybe_init_distributed(cfg: Config | None = None) -> bool:
    """Join the global group if this job asks for one
    (``BYTEPS_JAX_DISTRIBUTED=1`` and more than one worker). The launcher
    interposes ``byteps_tpu_torch._boot`` so this runs before user code;
    a second call is a no-op. Returns True when this process is part of
    a multi-process group."""
    global _initialized
    cfg = cfg or get_config()
    if not cfg.global_group or cfg.num_worker <= 1:
        return False
    with _lock:
        if _initialized:
            return True
        import torch.distributed as dist

        if dist.is_initialized():  # the user (or a launcher) did it
            _initialized = True
            return True
        timeout = datetime.timedelta(seconds=_RENDEZVOUS_S)
        store = (_host_store(cfg, timeout) if cfg.worker_id == 0
                 else _join_store(cfg, timeout))
        log.info("torch.distributed gloo group: rank %d of %d (store "
                 "%s:%d)", cfg.worker_id, cfg.num_worker,
                 cfg.global_coord_uri, store.port)
        dist.init_process_group("gloo", store=store, rank=cfg.worker_id,
                                world_size=cfg.num_worker, timeout=timeout)
        _initialized = True
        return True


def is_multiprocess() -> bool:
    """True when this process runs inside a multi-process global group."""
    if not _initialized:
        return False
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > 1
