"""ctypes binding for the port's native DCN summation service.

The C++ sources in ``csrc/`` are the reference's
(``byteps_tpu/server/csrc``), built with the same flags, so a sum, an
fp16 or an fp8 conversion is the same machine code in both packages.
The library is built at first use with ``make`` and ``g++`` into
``_build/`` (git-ignored), named by a digest of the sources, the
Makefile (its flags) and the host's CPU model (``-march=native`` code
must not move between hosts): under a file lock, into a private
directory, then renamed into place, so concurrent processes build it
once. A failed build or load raises; nothing falls back to another
library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from byteps_tpu_torch.common.logging import get_logger

log = get_logger("server.native")

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_lib = None
_lib_lock = threading.Lock()

# Wire codec ids — must match csrc/codec.h Codec enum.
WIRE_RAW = 0
WIRE_FP16 = 1
WIRE_ONEBIT = 2
WIRE_TOPK = 3
WIRE_DITHER = 4
WIRE_FP8 = 5


class WireCorruption(RuntimeError):
    """A CRC32-checked payload arrived corrupted (push rejected server-side
    or pull response failing the worker-side verify). Always retryable:
    the data was detected bad, never summed or consumed."""


class WorkerEvictedError(RuntimeError):
    """The server refused this worker as evicted. The port arms no worker
    leases (``BYTEPS_WORKER_LEASE_MS`` is not ported), so this is raised
    only by a server that another program started with leases."""


# the in-process path's return codes (csrc/api.cc, csrc/server.cc)
LOCAL_NO_SERVER = -10
LOCAL_EVICTED = -11


def check_local(rc: int, op: str) -> None:
    """Raise for a failed ``bps_local_*`` call (``rc`` < 0; a push or init
    also fails on any rc != 0). -10, no server running in this process
    (a worker-driven shutdown stopped it, or none was started), raises
    loudly instead of reaching a stopped server's store; -11 is the
    eviction the TCP path reports as a server-side error."""
    if rc == LOCAL_NO_SERVER:
        raise RuntimeError(
            f"local {op} failed (rc={rc}): no summation server is running "
            "in this process (stopped by the workers' shutdown, or never "
            "started); start_server reclaims the slot")
    if rc == LOCAL_EVICTED:
        raise WorkerEvictedError(f"local {op} rejected: worker evicted "
                                 "(rc=-11); rejoin required")
    raise RuntimeError(f"local {op} failed (rc={rc})")


def _cpu_model() -> str:
    """The first CPU's model name and feature flags (what ``-march=native``
    compiles for)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().split("\n\n")[0]
        return "\n".join(ln for ln in lines.splitlines()
                         if ln.startswith(("model name", "flags")))
    except OSError:
        return platform.processor() or platform.machine()


def library_path() -> Path:
    """Where the library lives, keyed by the sources, the Makefile and
    the CPU model."""
    h = hashlib.sha1(_cpu_model().encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cc", ".h") or f.name == "Makefile":
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"libbyteps_tpu_torch_server-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library unless it is present; return its path. Raises
    with the compiler's output if ``make`` fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():               # another process built it meanwhile
            return out
        tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
        try:
            log.info("building the native server library into %s", out)
            res = subprocess.run(
                ["make", "-C", str(CSRC), "-j4", f"BUILD={tmp}",
                 f"TARGET={tmp / out.name}"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if res.returncode != 0:
                raise RuntimeError("building the native server library "
                                   f"failed:\n{res.stdout}")
            os.replace(tmp / out.name, out)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    sigs = {
        "bps_server_start": ([c.c_uint16] + [c.c_int] * 8, c.c_int),
        "bps_server_wait": ([], None),
        "bps_server_stop": ([], None),
        # the server's own codec calls, which the parity tests hold
        "bps_float_to_fp8": ([c.c_float], c.c_uint8),
        "bps_codec_encode": ([c.c_uint8, c.c_void_p, c.c_int64, c.c_uint32,
                              c.c_uint64, c.c_void_p, c.c_int64], c.c_int64),
        "bps_client_connect": ([c.c_char_p, c.c_uint16, c.c_int, c.c_int],
                               c.c_void_p),
        "bps_client_init_key": ([c.c_void_p, c.c_uint64, c.c_uint64],
                                c.c_int),
        "bps_client_push2": ([c.c_void_p, c.c_uint64, c.c_void_p, c.c_uint64,
                              c.c_uint8, c.c_uint16, c.c_uint64, c.c_uint32],
                             c.c_int),
        "bps_client_pull3": ([c.c_void_p, c.c_uint64, c.c_void_p, c.c_uint64,
                              c.c_uint64, c.c_uint8, c.c_int,
                              c.POINTER(c.c_uint64), c.POINTER(c.c_uint32),
                              c.c_int, c.POINTER(c.c_uint32),
                              c.POINTER(c.c_uint64)], c.c_int),
        "bps_client_barrier": ([c.c_void_p, c.c_int], c.c_int),
        "bps_client_shutdown": ([c.c_void_p, c.c_int], c.c_int),
        "bps_client_ping": ([c.c_void_p, c.POINTER(c.c_int64),
                             c.POINTER(c.c_int64), c.c_int], c.c_int),
        "bps_client_last_error": ([c.c_void_p], c.c_char_p),
        "bps_client_is_dead": ([c.c_void_p], c.c_int),
        "bps_client_free": ([c.c_void_p], None),
        "bps_reduce_sum_f32": ([c.POINTER(c.c_float), c.POINTER(c.c_float),
                                c.c_int64], None),
        # the in-process (IPC) path: the server's store in this process
        "bps_local_init": ([c.c_uint64, c.c_uint64], c.c_int),
        "bps_local_push": ([c.c_uint16, c.c_uint64, c.c_uint8, c.c_void_p,
                            c.c_uint64], c.c_int),
        "bps_local_push2": ([c.c_uint16, c.c_uint64, c.c_uint8, c.c_uint64,
                             c.c_void_p, c.c_uint64], c.c_int),
        "bps_local_pull": ([c.c_uint64, c.c_uint8, c.c_uint64, c.c_int,
                            c.c_void_p, c.c_uint64], c.c_int64),
        "bps_local_pull2": ([c.c_uint64, c.c_uint8, c.c_uint64, c.c_int,
                             c.c_void_p, c.c_uint64, c.POINTER(c.c_uint64)],
                            c.c_int64),
        "bps_local_pull3": ([c.c_uint64, c.c_uint8, c.c_uint64, c.c_int,
                             c.c_void_p, c.c_uint64, c.POINTER(c.c_uint64),
                             c.POINTER(c.c_uint64)], c.c_int64),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res


def load_lib() -> ctypes.CDLL:
    """The port's server library, built first if missing."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


def reduce_sum_f32(dst: np.ndarray, src: np.ndarray) -> None:
    """dst += src via the native kernel (golden-testable)."""
    if not (dst.dtype == src.dtype == np.float32 and dst.size == src.size
            and dst.flags.c_contiguous and src.flags.c_contiguous):
        raise ValueError("reduce_sum_f32 takes two contiguous f32 arrays "
                         "of one size")
    lib = load_lib()
    lib.bps_reduce_sum_f32(
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dst.size,
    )


class NativeClient:
    """One serial TCP connection to one summation server.

    Reference analog: a ps-lite customer. The native side serializes per
    connection; PSWorker keeps one NativeClient per scheduler pool thread.
    """

    def __init__(self, host: str, port: int, timeout_ms: int = 30000,
                 recv_timeout_ms: int = 120000):
        self._lib = load_lib()
        # held across every native call so close() cannot free the handle
        # under an in-flight op
        self._op_lock = threading.Lock()
        self._h: Optional[int] = self._lib.bps_client_connect(
            host.encode(), port, timeout_ms, recv_timeout_ms)
        if not self._h:
            raise ConnectionError(f"cannot reach bps server {host}:{port}")

    def init_key(self, key: int, nbytes: int) -> None:
        with self._op_lock:
            self._require_open()
            self._check(self._lib.bps_client_init_key(self._h, key, nbytes),
                        "init")

    def push(self, key: int, buf: np.ndarray, codec: int = WIRE_RAW,
             worker_id: int = 0, version: int = 0, crc: int = 0) -> None:
        """Push the contiguous bytes of ``buf``. ``version`` != 0 arms the
        server's (worker, key, version) replay dedupe; ``crc`` != 0 is
        verified server-side before the payload is summed."""
        if not buf.flags.c_contiguous:
            raise ValueError("push needs a contiguous buffer")
        with self._op_lock:
            self._require_open()
            self._check(self._lib.bps_client_push2(
                self._h, key, buf.ctypes.data, buf.nbytes, codec, worker_id,
                version, crc), "push")

    def pull(self, key: int, out: np.ndarray, version: int,
             codec: int = WIRE_RAW, want_crc: bool = False,
             worker_id: int = -1):
        """Pull round ``version`` into ``out`` (a capacity buffer); returns
        ``(bytes received, the response's crc)``; the server computes the
        crc only when ``want_crc`` asks for it (0 otherwise)."""
        if not (out.dtype == np.uint8 and out.flags.c_contiguous
                and out.flags.writeable):
            raise ValueError("pull needs a writeable contiguous uint8 buffer")
        with self._op_lock:
            self._require_open()
            got = ctypes.c_uint64(0)
            crc = ctypes.c_uint32(0)
            ep = ctypes.c_uint32(0)
            served = ctypes.c_uint64(0)
            self._check(self._lib.bps_client_pull3(
                self._h, key, out.ctypes.data, out.nbytes, version, codec,
                int(want_crc),
                ctypes.byref(got), ctypes.byref(crc), worker_id,
                ctypes.byref(ep), ctypes.byref(served)), "pull")
            return int(got.value), int(crc.value)

    def barrier(self, worker_id: int = -1) -> None:
        with self._op_lock:
            self._require_open()
            self._check(self._lib.bps_client_barrier(self._h, worker_id),
                        "barrier")

    def ping(self, worker_id: int = -1) -> Tuple[int, int]:
        """(server CLOCK_REALTIME ns, round-trip ns): the health monitor's
        probe. The port arms no worker leases, so the worker id it
        carries refreshes nothing on a port server."""
        with self._op_lock:
            self._require_open()
            sns = ctypes.c_int64(0)
            rtt = ctypes.c_int64(0)
            self._check(self._lib.bps_client_ping(
                self._h, ctypes.byref(sns), ctypes.byref(rtt), worker_id),
                "ping")
            return int(sns.value), int(rtt.value)

    def is_dead(self) -> bool:
        """True once a timeout or desync closed the socket (or the client
        was closed): the owner connects a fresh one."""
        with self._op_lock:
            return not self._h or bool(self._lib.bps_client_is_dead(self._h))

    def shutdown(self, worker_id: int = -1) -> None:
        """The worker's goodbye: the server stops once every worker said
        it."""
        with self._op_lock:
            if self._h:
                self._lib.bps_client_shutdown(self._h, worker_id)

    def close(self) -> None:
        with self._op_lock:
            h, self._h = self._h, None
        if h:
            self._lib.bps_client_free(h)

    def _require_open(self) -> None:
        if not self._h:
            raise RuntimeError("NativeClient is closed")

    def _check(self, rc: int, op: str) -> None:
        if rc > 0:  # server-side kErr with a message
            msg = (self._lib.bps_client_last_error(self._h) or b"").decode()
            if "crc mismatch" in msg:
                raise WireCorruption(f"bps {op} rejected: {msg} (detected, "
                                     "not applied; retryable)")
            if "worker evicted" in msg:
                raise WorkerEvictedError(f"bps {op} rejected: {msg}")
            raise RuntimeError(f"bps {op} rejected: {msg}")
        if rc == -8:
            raise RuntimeError(f"bps {op} rejected: worker id out of range "
                               "for the wire encoding (must be within "
                               "[0, 65534])")
        if rc == -7:
            raise TimeoutError(f"bps {op} receive timeout (server dead or "
                               "stalled); connection closed")
        if rc == -6:
            raise RuntimeError(f"bps {op} response key mismatch (stale frame "
                               "on a desynchronized stream); connection "
                               "closed")
        if rc != 0:
            raise RuntimeError(f"bps {op} failed (rc={rc})")

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
