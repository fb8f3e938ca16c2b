"""Shared plumbing of the DCN-tier parity tests (``tests/test_torch_dcn_*``):
a port per test that no other pytest-xdist worker probes, the reference's
native library loaded once under a file lock, and the environment of a
two-worker, one-server job."""

from __future__ import annotations

import fcntl
import itertools
import os
import tempfile
from pathlib import Path

# each xdist worker gets its own 700-port window, each test 20 ports of it
# (any_port probes up to 16), between the reference tests' fixed ports
# (19500-26730) and the kernel's ephemeral range (from 32768)
_WORKER = int(os.environ.get("PYTEST_XDIST_WORKER", "gw0").lstrip("gw") or 0)
_PORTS = itertools.count(27000 + 700 * _WORKER, 20)
_REF_CSRC = (Path(__file__).resolve().parents[2] / "byteps_tpu" / "server"
             / "csrc")


def next_port() -> int:
    return next(_PORTS)


def reference_lib():
    """The reference's ``load_lib`` under a file lock: it may run ``make``
    in its own source directory on first use, and several workers may get
    there at once."""
    from byteps_tpu.server.native import load_lib

    with open(Path(tempfile.gettempdir()) / "bps_ref_server_lib.lock",
              "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return load_lib()


def port_lib():
    """The port's ``load_lib``, before any worker starts. The library is
    built at first use (``make`` under its own file lock: seconds alone,
    tens of seconds on a loaded host); built on a worker's first
    connection instead, it holds that worker back while its peer's pull
    runs into the server's pull deadline."""
    from byteps_tpu_torch.server.native import load_lib

    return load_lib()


def csrc_listing(path: Path = _REF_CSRC) -> dict:
    """{name: (size, mtime_ns)} of a source directory."""
    return {f.name: (f.stat().st_size, f.stat().st_mtime_ns)
            for f in sorted(path.iterdir())}


def job_env(monkeypatch, port: int, workers: int = 2) -> None:
    """DMLC_* of a job with ``workers`` workers and one server on ``port``
    (server 0 listens on DMLC_PS_ROOT_PORT + 1)."""
    monkeypatch.setenv("DMLC_NUM_WORKER", str(workers))
    monkeypatch.setenv("DMLC_NUM_SERVER", "1")
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(port - 1))
