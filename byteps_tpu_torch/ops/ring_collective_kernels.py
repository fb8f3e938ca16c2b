"""Ring transport of the ``ring`` ICI tier: the plain PyTorch versions
over ``torch.distributed`` point-to-point, and the dispatchers that send
CUDA tensors to the hand-written kernels (``csrc/ring.cu``).

Counterpart of ``byteps_tpu/ops/ring_collective_kernels.py``. The
reference runs inside ``shard_map`` and names a mesh axis; here each rank
is a process of the default process group and passes its own block:

* :func:`ring_collect`: ``(n, ...)`` rows, row j bound for rank j →
  ``(n, ...)`` rows, row w rank w's row for this rank (``all_to_all``
  semantics); hop t sends row ``(my+t) mod n`` to rank ``(my+t) mod n``
  and lands the row received from ``(my−t) mod n`` at that row.
* :func:`ring_allgather`: this rank's block → the ``(n, ...)``
  rank-ordered stack (``all_gather`` semantics), by the same rotation.
* :func:`ring_presum`: ``(n, ...)`` f32 rows → this rank's summed row,
  the serial ring reduce-scatter: the chain for segment d starts at
  rank d+1 with its row d, each hop adds the next rank's row after the
  received partial (``cur = recv + own``), and rank d adds its own last.

Each hop of a plain version is one ``dist.batch_isend_irecv`` round and
moves the rows as bytes (so fp8 and any other dtype move unchanged).
With one rank every function is a passthrough (``x``, ``x[None]``,
``x[0]``) and needs no process group. The reference's lane-alignment
gate (``kernels_supported``) does not carry over: the kernels take any
byte length, so the card has no twin path.

On the card the kernels address peers through :class:`RingWorkspace`:
one ``cudaMalloc`` buffer a rank for flags and landing slots, whose IPC
handles the ranks exchange once (``dist.all_gather_object``) and open,
with the peer pointer table kept on the device. It grows, by the same
collective exchange, when a larger row arrives; every rank sees the same
sizes in the same order, so they grow together. Two ranks may share one
card (CUDA IPC within a device); then the card time-slices their
contexts, and a kernel that spins on a flag holds the card until its
slice ends. Launches still go out as they come, with no host meeting:
draining the stream and meeting the peers at a ``dist.barrier`` before
each launch (``RingWorkspace.rendezvous``) made the two-rank GPT-2
medium ring step slower on one H100 (``scripts/torch_ring_probe.py
--train``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from byteps_tpu_torch.ops import _build
from byteps_tpu_torch.ops.backend import launches

# smallest landing slot (bytes) a workspace starts with
_MIN_CAP = 1 << 16
_ALIGN = 256


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernels' golden)
# --------------------------------------------------------------------------
def _hop(send: torch.Tensor, dst: int, recv: torch.Tensor, src: int) -> None:
    """One ring hop: ``send`` to rank ``dst`` while ``recv`` fills from
    rank ``src``, as one batched point-to-point round."""
    ops = [dist.P2POp(dist.isend, send, dst),
           dist.P2POp(dist.irecv, recv, src)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()


def _bytes(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` as a (rows, bytes) uint8 view."""
    return x.contiguous().reshape(rows, -1).view(torch.uint8)


def _collect_torch(x: torch.Tensor, n: int, my: int) -> torch.Tensor:
    xb = _bytes(x, n)
    out = torch.empty_like(xb)
    out[my] = xb[my]
    for t in range(1, n):
        dest, src = (my + t) % n, (my - t) % n
        recv = torch.empty_like(xb[0])
        _hop(xb[dest], dest, recv, src)
        out[src] = recv
    return out.view(x.dtype).reshape(x.shape)


def _allgather_torch(x: torch.Tensor, n: int, my: int) -> torch.Tensor:
    xb = _bytes(x, 1)[0]
    out = xb.new_empty((n, xb.shape[0]))
    out[my] = xb
    for t in range(1, n):
        dest, src = (my + t) % n, (my - t) % n
        recv = torch.empty_like(xb)
        _hop(xb, dest, recv, src)
        out[src] = recv
    return out.view(x.dtype).reshape((n,) + tuple(x.shape))


def _presum_torch(x: torch.Tensor, n: int, my: int) -> torch.Tensor:
    cur = x[(my - 1) % n].clone()
    right, left = (my + 1) % n, (my - 1) % n
    for t in range(1, n):
        recv = torch.empty_like(cur)
        _hop(cur, right, recv, left)
        cur = recv + x[(my - 1 - t) % n]
    return cur


# --------------------------------------------------------------------------
# the CUDA kernels and their workspace
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ring")
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_uint
    pp = ctypes.POINTER(ctypes.c_void_p)
    sigs = {"bps_ring_max_blocks": [], "bps_ring_handle_size": [],
            "bps_ring_alloc": [ll, pp], "bps_ring_free": [p],
            "bps_ring_get_handle": [p, p], "bps_ring_open_handle": [p, pp],
            "bps_ring_close_handle": [p], "bps_ring_host_alloc": [ll, pp, pp],
            "bps_ring_host_free": [p],
            "bps_ring_rotate": [p, p, ll, i, i, i, u, p, ll, ll, p, p],
            "bps_ring_presum": [p, p, ll, i, i, u, p, ll, ll, p, p]}
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"ring {what} failed: "
                           f"{_build.error_string(_lib(), rc)}")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class RingWorkspace:
    """This rank's flags and landing slots, mapped into every other rank
    of the default process group, for the ring kernels on ``device``.

    Layout (``csrc/ring.cu``): uint32 flags ``[2][n][max_blocks]`` at 0,
    then ``[2][n][cap]`` landing slots at ``slots_off``. ``epoch`` counts
    the launches since the last (re)allocation, the same on every rank.
    Creating and growing it are collective."""

    # error words the kernels write before they trap (pinned host memory)
    _ERR_WORDS = 5

    def __init__(self, device: torch.device):
        lib = _lib()
        self.device = device
        self.n, self.rank = dist.get_world_size(), dist.get_rank()
        self.cap = 0
        self.epoch = 0
        self._base: Optional[int] = None
        self._opened: List[int] = []
        self.peers: Optional[torch.Tensor] = None
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(device):
            _check(lib.bps_ring_host_alloc(8 * self._ERR_WORDS,
                                           ctypes.byref(host),
                                           ctypes.byref(dev)),
                   "error-word allocation")
        self._err_host, self.err_dev = host.value, dev.value
        self.flags_bytes = _round_up(
            2 * self.n * lib.bps_ring_max_blocks() * 4, _ALIGN)
        # drain the stream and meet the other ranks on the host before
        # each launch: a policy, the same on every rank; off, as it was
        # slower even where the ranks time-slice one card
        self.rendezvous = False
        self._grow(_MIN_CAP)

    @property
    def slots_off(self) -> int:
        return self.flags_bytes

    def _grow(self, need: int) -> None:
        """Reallocate with slots of at least ``need`` bytes and exchange
        the new handles; every rank calls it at the same point."""
        lib = _lib()
        cap = _round_up(max(need, 2 * self.cap, _MIN_CAP), _ALIGN)
        with torch.cuda.device(self.device):
            if self._base is not None:
                torch.cuda.synchronize(self.device)
                dist.barrier()            # every peer's kernels are done
                self._close_peers()
                dist.barrier()            # every peer let go of our buffer
                _check(lib.bps_ring_free(self._base), "free")
                self._base = None
            ptr = ctypes.c_void_p()
            _check(lib.bps_ring_alloc(self.flags_bytes + 2 * self.n * cap,
                                      ctypes.byref(ptr)), "allocation")
            self._base = ptr.value
            handle = ctypes.create_string_buffer(lib.bps_ring_handle_size())
            _check(lib.bps_ring_get_handle(self._base, handle), "IPC handle")
            handles = [None] * self.n
            dist.all_gather_object(handles, handle.raw)
            bases = []
            for r, h in enumerate(handles):
                if r == self.rank:
                    bases.append(self._base)
                    continue
                peer = ctypes.c_void_p()
                _check(lib.bps_ring_open_handle(h, ctypes.byref(peer)),
                       f"opening rank {r}'s IPC handle")
                self._opened.append(peer.value)
                bases.append(peer.value)
        self.peers = torch.tensor([b - (1 << 64) if b >= 1 << 63 else b
                                   for b in bases], dtype=torch.int64,
                                  device=self.device)
        self.cap = cap
        self.epoch = 0

    def _close_peers(self) -> None:
        for p in self._opened:
            _check(_lib().bps_ring_close_handle(p), "closing an IPC handle")
        self._opened = []

    def prepare(self, row_bytes: int) -> int:
        """Before a launch: grow the slots to ``row_bytes`` if needed,
        meet the other ranks if ``rendezvous``, and return the launch's
        epoch."""
        self.check()
        if row_bytes > self.cap:
            self._grow(row_bytes)
        if self.rendezvous:
            torch.cuda.current_stream(self.device).synchronize()
            dist.barrier()
        self.epoch += 1
        return self.epoch

    def error(self) -> Optional[str]:
        """What a kernel waited for when its wait ran past the bound
        (before it trapped), or None."""
        words = (ctypes.c_uint64 * self._ERR_WORDS).from_address(
            self._err_host)
        kind, epoch, slot, block, seen = list(words)
        if not kind:
            return None
        what = {1: "rotate", 2: "presum"}.get(kind, str(kind))
        return (f"ring {what} on rank {self.rank} waited past its bound for "
                f"slot {slot}, block {block}, epoch {epoch} (saw {seen})")

    def check(self) -> None:
        err = self.error()
        if err:
            raise RuntimeError(err)

    def close(self) -> None:
        """Unmap the peers and free this rank's buffers (collective)."""
        lib = _lib()
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            dist.barrier()
            self._close_peers()
            dist.barrier()
            if self._base is not None:
                _check(lib.bps_ring_free(self._base), "free")
                self._base = None
            _check(lib.bps_ring_host_free(self._err_host), "free")
        self.peers = None


# one workspace per (process group, card) of this process
_workspaces: Dict[Tuple[int, int], Tuple[object, RingWorkspace]] = {}


def workspace(device: torch.device) -> RingWorkspace:
    """This process's workspace on ``device`` for the current default
    process group, made (collectively) at its first use."""
    pg = dist.group.WORLD
    key = (id(pg), device.index)
    hit = _workspaces.get(key)
    if hit is None or hit[0] is not pg:
        hit = _workspaces[key] = (pg, RingWorkspace(device))
    return hit[1]


def close_workspaces() -> None:
    """Free every workspace of the current default process group
    (collective: every rank calls it before the group goes)."""
    pg = dist.group.WORLD
    for key in [k for k, (g, _) in _workspaces.items() if g is pg]:
        _workspaces.pop(key)[1].close()


def ring_errors() -> List[str]:
    """The recorded wait failures of this process's workspaces."""
    return [e for _, ws in _workspaces.values() if (e := ws.error())]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_input(x: torch.Tensor, dtypes=None) -> None:
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor; got {x.device}")
    if dtypes is not None and x.dtype not in dtypes:
        raise TypeError(f"x must be one of {dtypes}; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def launch_rotate(ws, x: torch.Tensor, out: torch.Tensor, n: int, my: int,
                  gather: bool, epoch: int) -> None:
    """Launch the rotate kernel on ``ws``'s slots (anything with
    ``peers``, ``slots_off``, ``cap`` and ``err_dev``) at ``epoch``, on
    the current stream: no rendezvous, no launch count (callers that time
    the bare kernel take ``ws.prepare`` themselves)."""
    with torch.cuda.device(x.device):
        rc = _lib().bps_ring_rotate(
            x.data_ptr(), out.data_ptr(), out[0].numel() * x.element_size(),
            n, my, int(gather), epoch, ws.peers.data_ptr(), ws.slots_off,
            ws.cap, ws.err_dev, _stream(x))
    _check(rc, "rotate kernel launch")


def launch_presum(ws, x: torch.Tensor, out: torch.Tensor, n: int, my: int,
                  epoch: int) -> None:
    """Launch the presum kernel, as :func:`launch_rotate`."""
    with torch.cuda.device(x.device):
        rc = _lib().bps_ring_presum(
            x.data_ptr(), out.data_ptr(), out.numel(), n, my, epoch,
            ws.peers.data_ptr(), ws.slots_off, ws.cap, ws.err_dev,
            _stream(x))
    _check(rc, "presum kernel launch")


def _rotate_cuda(x: torch.Tensor, n: int, my: int,
                 gather: bool) -> torch.Tensor:
    _check_input(x)
    rows = (n,) + (tuple(x.shape) if gather else tuple(x.shape[1:]))
    out = torch.empty(rows, dtype=x.dtype, device=x.device)
    row_bytes = out[0].numel() * x.element_size()
    if row_bytes == 0:
        return out
    ws = workspace(x.device)
    launch_rotate(ws, x, out, n, my, gather, ws.prepare(row_bytes))
    launches["ring_rotate"] += 1
    return out


def _presum_cuda(x: torch.Tensor, n: int, my: int) -> torch.Tensor:
    _check_input(x, (torch.float32,))
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    ws = workspace(x.device)
    launch_presum(ws, x, out, n, my, ws.prepare(out.numel() * 4))
    launches["ring_presum"] += 1
    return out


# --------------------------------------------------------------------------
# public API (over the default process group)
# --------------------------------------------------------------------------
def _size_rank(n: Optional[int]) -> Tuple[int, int]:
    """(n, this rank): the default group's when n is None; n == 1 needs
    no group, any other n must be the group's size."""
    if n == 1:
        return 1, 0
    if not (dist.is_available() and dist.is_initialized()):
        if n is None:
            return 1, 0
        raise RuntimeError(f"a ring over {n} ranks needs an initialized "
                           "process group")
    size = dist.get_world_size()
    if n is not None and n != size:
        raise ValueError(f"ring over {n} ranks in a group of {size}")
    return size, dist.get_rank()


def _check_rows(x: torch.Tensor, n: int) -> None:
    if x.ndim == 0 or x.shape[0] != n:
        raise ValueError(f"expected ({n}, ...) rows; got {tuple(x.shape)}")


def ring_collect(x: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """(n, ...) rows, row j bound for rank j → (n, ...) rows, row w rank
    w's row for this rank (``all_to_all`` semantics): exact, moves bits
    only."""
    n, my = _size_rank(n)
    if n == 1:
        return x
    _check_rows(x, n)
    if x.is_cuda:
        return _rotate_cuda(x.contiguous(), n, my, gather=False)
    return _collect_torch(x, n, my)


def ring_allgather(x: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """This rank's block → the (n, ...) rank-ordered stack of every
    rank's block (``all_gather`` semantics): exact, moves bits only."""
    n, my = _size_rank(n)
    if n == 1:
        return x[None]
    if x.is_cuda:
        return _rotate_cuda(x.contiguous(), n, my, gather=True)
    return _allgather_torch(x, n, my)


def ring_presum(x: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """(n, ...) f32 rows → this rank's summed row, ring reduce-scatter
    order (rank d: p_{d+1} + p_{d+2} + … + p_d). Chain-ordered adds:
    exact positionally for presummable payloads, not bitwise the staged
    worker-order fold, so callers route stochastic codecs only."""
    n, my = _size_rank(n)
    if n == 1:
        return x[0]
    _check_rows(x, n)
    if x.dtype != torch.float32:
        raise TypeError(f"ring_presum adds f32 rows; got {x.dtype}")
    if x.is_cuda:
        return _presum_cuda(x.contiguous(), n, my)
    return _presum_torch(x, n, my)
