"""Ring transport of the ``ring`` ICI tier: the plain PyTorch versions
over ``torch.distributed`` point-to-point, and the dispatchers that send
CUDA tensors to the hand-written kernels (``csrc/ring.cu``).

Counterpart of ``byteps_tpu/ops/ring_collective_kernels.py``. The
reference runs inside ``shard_map`` and names a mesh axis; here each rank
is a process and passes its own block, and the ring spans a process group:
the default group, or ``group=`` (a mesh axis's line, such as one dp line
of a dp×tp job, or the ``slice_`` line of the hierarchical path), whose
members are indexed by their rank in it:

* :func:`ring_collect`: ``(n, ...)`` rows, row j bound for rank j →
  ``(n, ...)`` rows, row w rank w's row for this rank (``all_to_all``
  semantics); hop t sends row ``(my+t) mod n`` to rank ``(my+t) mod n``
  and lands the row received from ``(my−t) mod n`` at that row.
* :func:`ring_allgather`: this rank's block → the ``(n, ...)``
  rank-ordered stack (``all_gather`` semantics), by the same rotation.
* :func:`ring_collect_tree`, :func:`ring_allgather_tree`: the same for
  every leaf of a payload dict at once (one call on the card: each leaf
  at its offset in a landing slot, :func:`slot_layout`).
* :func:`ring_presum`: ``(n, ...)`` f32 rows → this rank's summed row,
  the serial ring reduce-scatter: the chain for segment d starts at
  rank d+1 with its row d, each hop adds the next rank's row after the
  received partial (``cur = recv + own``), and rank d adds its own last.

Each hop of a plain version is one ``dist.batch_isend_irecv`` round and
moves the rows as bytes (so fp8 and any other dtype move unchanged); the
tree calls' plain versions loop over the leaves. With one rank every
function is a passthrough (``x``, ``x[None]``, ``x[0]``) and needs no
process group. The reference's lane-alignment gate
(``kernels_supported``) does not carry over: the kernels take any byte
length, so the card has no twin path.

On the card the kernels address peers through :class:`RingWorkspace`:
one ``cudaMalloc`` buffer a rank for flags and landing slots, whose IPC
handles the ranks exchange once (``dist.all_gather_object``) and open,
with the peer pointer table kept on the device. It grows, by the same
collective exchange, when a larger payload arrives; every rank sees the
same sizes in the same order, so they grow together. Two ranks may share
one card (CUDA IPC within a device), which then time-slices their
contexts. There no kernel waits on a peer: a kernel pushes, the stream
waits on the rank's own flags (``cuStreamWaitValue32``), and a second
kernel lands what arrived, so a rank whose peers are behind leaves the
card to them. Where every peer's context runs at once with this one (each
rank on a card of its own; :class:`LocalPeers`), one kernel pushes, waits
and lands: :func:`plan` picks the protocol from the peers' layout. A
wait has no timeout: each call records an event, and
:meth:`RingWorkspace.check` (run before every call) raises once a call's
event is still pending :attr:`RingWorkspace.wait_bound_s` after it was
issued, naming the epoch and the flags that do not hold it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from byteps_tpu_torch.ops import _build
from byteps_tpu_torch.ops.backend import launches

# smallest landing slot (bytes) a workspace starts with
_MIN_CAP = 1 << 16
_ALIGN = 256
# a leaf's offset in a landing slot is a multiple of this (16-byte moves)
LEAF_ALIGN = 16
# leaves a tree call carries (csrc/ring.cu kMaxLeaves)
MAX_LEAVES = 8

Payload = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernels' golden)
# --------------------------------------------------------------------------
def _hop(send: torch.Tensor, dst: int, recv: torch.Tensor, src: int,
         group=None) -> None:
    """One ring hop: ``send`` to index ``dst`` of ``group`` (the default
    group when None) while ``recv`` fills from index ``src``, as one
    batched point-to-point round; a group index goes out as its global
    rank."""
    if group is not None:
        dst = dist.get_global_rank(group, dst)
        src = dist.get_global_rank(group, src)
    ops = [dist.P2POp(dist.isend, send, dst, group),
           dist.P2POp(dist.irecv, recv, src, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()


def _bytes(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` as a (rows, bytes) uint8 view."""
    return x.contiguous().reshape(rows, -1).view(torch.uint8)


def _collect_torch(x: torch.Tensor, n: int, my: int,
                   group=None) -> torch.Tensor:
    xb = _bytes(x, n)
    out = torch.empty_like(xb)
    out[my] = xb[my]
    for t in range(1, n):
        dest, src = (my + t) % n, (my - t) % n
        recv = torch.empty_like(xb[0])
        _hop(xb[dest], dest, recv, src, group)
        out[src] = recv
    return out.view(x.dtype).reshape(x.shape)


def _allgather_torch(x: torch.Tensor, n: int, my: int,
                     group=None) -> torch.Tensor:
    xb = _bytes(x, 1)[0]
    out = xb.new_empty((n, xb.shape[0]))
    out[my] = xb
    for t in range(1, n):
        dest, src = (my + t) % n, (my - t) % n
        recv = torch.empty_like(xb)
        _hop(xb, dest, recv, src, group)
        out[src] = recv
    return out.view(x.dtype).reshape((n,) + tuple(x.shape))


def _presum_torch(x: torch.Tensor, n: int, my: int,
                  group=None) -> torch.Tensor:
    cur = x[(my - 1) % n].clone()
    right, left = (my + 1) % n, (my - 1) % n
    for t in range(1, n):
        recv = torch.empty_like(cur)
        _hop(cur, right, recv, left, group)
        cur = recv + x[(my - 1 - t) % n]
    return cur


# --------------------------------------------------------------------------
# the landing slot's layout of a payload's leaves
# --------------------------------------------------------------------------
def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def slot_layout(rows: Mapping[str, Tuple[Sequence[int], torch.dtype]]
                ) -> Tuple[Dict[str, Tuple[int, int]], int]:
    """Where each leaf's row sits in a landing slot: ``rows`` maps a leaf's
    name to its row's shape and dtype; returns ``({name: (offset,
    bytes)}, span)``. Leaves follow one another in the order of their
    names (so any dict order gives the same layout, on every rank), each
    at a multiple of :data:`LEAF_ALIGN`; ``span`` is the sum of the
    aligned rows."""
    layout, off = {}, 0
    for name in sorted(rows):
        shape, dtype = rows[name]
        nbytes = dtype.itemsize
        for d in shape:
            nbytes *= int(d)
        layout[name] = (off, nbytes)
        off += _round_up(nbytes, LEAF_ALIGN)
    return layout, off


# --------------------------------------------------------------------------
# the CUDA kernels and their workspace
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ring")
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_uint
    pp = ctypes.POINTER(ctypes.c_void_p)
    pi = ctypes.POINTER(ctypes.c_int)
    sigs = {"bps_ring_max_leaves": [], "bps_ring_handle_size": [],
            "bps_ring_alloc": [ll, pp], "bps_ring_free": [p],
            "bps_ring_get_handle": [p, p], "bps_ring_open_handle": [p, pp],
            "bps_ring_close_handle": [p],
            "bps_ring_wait": [p, p, u, i], "bps_ring_init": [p, p, pi],
            "bps_ring_read": [p, p, ll],
            "bps_ring_push": [i, p, i, i, i, u, p, ll, ll, p],
            "bps_ring_land": [i, p, i, i, u, p, ll, ll, p],
            "bps_ring_rotate": [i, p, i, i, i, u, i, p, p, ll, ll, p],
            "bps_ring_presum_hop": [p, p, ll, i, i, i, u, p, ll, ll, p],
            "bps_ring_presum": [p, p, ll, i, i, u, i, p, p, ll, ll, p]}
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i
    if lib.bps_ring_max_leaves() != MAX_LEAVES:
        raise RuntimeError("csrc/ring.cu and its wrapper disagree on the "
                           "leaves a call carries")
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"ring {what} failed: "
                           f"{_build.error_string(_lib(), rc)}")


def flags_bytes(n: int) -> int:
    """Bytes ahead of the landing slots in a workspace of n ranks: the
    uint32 flags [2][n] and last-block counters [n] (``csrc/ring.cu``)."""
    return _round_up(4 * 3 * n, _ALIGN)


def plan(layout: str) -> str:
    """The protocol a peer layout takes (``csrc/ring.cu``'s header):
    ``"stream"`` (a push kernel, the stream's waits, a land kernel: no
    kernel waits on a peer) where a peer shares this card from another
    process (``"same_card"``), so the card time-slices their contexts;
    ``"spin"`` (one kernel that waits on the flags itself) where every
    peer's context runs at once with this one: peers in this process
    (``"in_process"``) or each on another card (``"other_cards"``)."""
    if layout == "same_card":
        return "stream"
    if layout in ("in_process", "other_cards"):
        return "spin"
    raise ValueError(f"unknown peer layout {layout!r}")


class RingWorkspace:
    """This rank's flags and landing slots, mapped into every other rank
    of ``group`` (the default process group when None), for the ring
    kernels on ``device``. ``n`` and ``rank`` are the group's size and
    this rank's index in it; the peer table is in group order.

    Layout (``csrc/ring.cu``): uint32 flags ``[2][n]`` and counters at 0,
    then ``[2][n][cap]`` landing slots at ``slots_off``. ``epoch`` counts
    the calls since the last (re)allocation, the same on every rank.
    ``layout`` is ``"same_card"`` when another rank's process shares this
    card, else ``"other_cards"``; ``protocol`` is :func:`plan` of it.
    Creating and growing it are collective. It refuses to start where the
    driver has no stream memory operations."""

    # seconds a call's stream waits may stay pending before check raises
    wait_bound_s = 30.0

    def __init__(self, device: torch.device, group=None):
        lib = _lib()
        self.device = device
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.cap = 0
        self.epoch = 0
        self.base: Optional[int] = None
        self._opened: List[int] = []
        self.peers: Optional[torch.Tensor] = None
        self.slots_off = flags_bytes(self.n)
        # (event after the call, epoch, op, flags the call waited on, host
        # time issued), oldest first; the first stuck call's report
        self._pending: collections.deque = collections.deque()
        self._error: Optional[str] = None
        cards = [None] * self.n
        dist.all_gather_object(
            cards, str(torch.cuda.get_device_properties(device).uuid),
            group=group)
        self.layout = ("same_card" if cards.count(cards[self.rank]) > 1
                       else "other_cards")
        self.protocol = plan(self.layout)
        self._grow(_MIN_CAP)
        can_flush = ctypes.c_int()
        with torch.cuda.device(device):
            # a wait on the counter, which holds 0 between kernels
            _check(lib.bps_ring_init(self.base + 8 * self.n,
                                     torch.cuda.current_stream(
                                         device).cuda_stream,
                                     ctypes.byref(can_flush)),
                   "stream memory operation (cuStreamWaitValue32)")
        self.can_flush = bool(can_flush.value)

    def _grow(self, need: int) -> None:
        """Reallocate with slots of at least ``need`` bytes and exchange
        the new handles; every rank calls it at the same point."""
        lib = _lib()
        cap = _round_up(max(need, 2 * self.cap, _MIN_CAP), _ALIGN)
        with torch.cuda.device(self.device):
            if self.base is not None:
                torch.cuda.synchronize(self.device)
                # every peer's kernels are done
                dist.barrier(group=self.group)
                self._close_peers()
                # every peer let go of our buffer
                dist.barrier(group=self.group)
                _check(lib.bps_ring_free(self.base), "free")
                self.base = None
            ptr = ctypes.c_void_p()
            _check(lib.bps_ring_alloc(self.slots_off + 2 * self.n * cap,
                                      ctypes.byref(ptr)), "allocation")
            self.base = ptr.value
            handle = ctypes.create_string_buffer(lib.bps_ring_handle_size())
            _check(lib.bps_ring_get_handle(self.base, handle), "IPC handle")
            handles = [None] * self.n
            dist.all_gather_object(handles, handle.raw, group=self.group)
            bases = []
            for r, h in enumerate(handles):
                if r == self.rank:
                    bases.append(self.base)
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
        self._pending.clear()

    def _close_peers(self) -> None:
        for p in self._opened:
            _check(_lib().bps_ring_close_handle(p), "closing an IPC handle")
        self._opened = []

    def prepare(self, span: int) -> int:
        """Before a call: raise if an earlier call's waits are stuck, grow
        the slots to ``span`` bytes if needed, and return the call's
        epoch."""
        self.check()
        if span > self.cap:
            self._grow(span)
        self.epoch += 1
        return self.epoch

    def watch(self, epoch: int, op: str, flags: Sequence[int]) -> None:
        """After a call on the current stream: remember its epoch and the
        flags (indices of the rank's ``[2][n]`` flags) it waits on."""
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._pending.append((ev, epoch, op, tuple(flags), time.monotonic()))

    def _describe(self, epoch: int, op: str, flags: Sequence[int]) -> str:
        words = (ctypes.c_uint32 * (2 * self.n))()
        with torch.cuda.device(self.device):
            _check(_lib().bps_ring_read(words, self.base, 8 * self.n),
                   "reading the flags")
        what = "hop" if op == "presum" else "source"
        late = [f"flag (parity {f // self.n}, {what} {f % self.n}) holds "
                f"{words[f]}" for f in flags if words[f] != epoch & 0xFFFFFFFF]
        return (f"ring {op} on rank {self.rank}: waited more than "
                f"{self.wait_bound_s:g} s for epoch {epoch}: "
                + ("; ".join(late) or "every flag holds it now"))

    def error(self) -> Optional[str]:
        """What a call waited for when its wait stayed pending past
        :attr:`wait_bound_s`, or None. Once set, it stays."""
        if self._error is None:
            q = self._pending
            while q and q[0][0].query():
                q.popleft()
            if q and time.monotonic() - q[0][4] > self.wait_bound_s:
                self._error = self._describe(*q[0][1:4])
        return self._error

    def check(self) -> None:
        err = self.error()
        if err:
            raise RuntimeError(err)

    def close(self) -> None:
        """Unmap the peers and free this rank's buffer (collective)."""
        lib = _lib()
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            dist.barrier(group=self.group)
            self._close_peers()
            dist.barrier(group=self.group)
            if self.base is not None:
                _check(lib.bps_ring_free(self.base), "free")
                self.base = None
        self.peers = None
        self._pending.clear()


# one workspace per (process group, card) of this process
_workspaces: Dict[Tuple[int, int], Tuple[object, RingWorkspace]] = {}


def workspace(device: torch.device, group=None) -> RingWorkspace:
    """This process's workspace on ``device`` for ``group`` (the current
    default process group when None), made (collectively, over the
    group) at its first use. Each group has its own: two rings of one
    job (each dp line of a dp×tp mesh) never share flags, slots or
    epochs."""
    pg = dist.group.WORLD if group is None else group
    key = (id(pg), device.index)
    hit = _workspaces.get(key)
    if hit is None or hit[0] is not pg:
        hit = _workspaces[key] = (pg, RingWorkspace(device, group))
    return hit[1]


def close_workspaces(group=None) -> None:
    """Free every workspace of ``group`` (the current default process
    group when None); collective over the group: every member calls it
    before the group goes."""
    pg = dist.group.WORLD if group is None else group
    for key in [k for k, (g, _) in _workspaces.items() if g is pg]:
        _workspaces.pop(key)[1].close()


def ring_errors() -> List[str]:
    """The recorded wait failures of this process's workspaces."""
    return [e for _, ws in _workspaces.values() if (e := ws.error())]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _desc(leaves: Sequence[Tuple[torch.Tensor, torch.Tensor, int]]):
    """(src, out, slot offset) leaves → the kernels' descriptor rows:
    (src, out, a row's bytes, offset) as a ctypes array."""
    vals = []
    for x, out, off in leaves:
        vals += [x.data_ptr(), out.data_ptr(),
                 out[0].numel() * out.element_size(), off]
    return (ctypes.c_longlong * max(len(vals), 1))(*vals)


def rotate_flags(n: int, my: int, epoch: int) -> List[int]:
    """The flags (indices into ``[2][n]``) a rotate call's stream waits
    on: (parity, source) for every other rank."""
    p = epoch & 1
    return [p * n + (my - t) % n for t in range(1, n)]


def presum_flags(n: int, epoch: int) -> List[int]:
    """The flags a presum call's stream waits on: (parity, hop t)."""
    return [(epoch & 1) * n + t for t in range(1, n)]


def launch_rotate(ws, leaves, n: int, my: int, gather: bool,
                  epoch: int) -> None:
    """A rotate call on ``ws``'s slots (anything with ``peers``, ``base``,
    ``slots_off``, ``cap`` and ``protocol``) at ``epoch``, on the current
    stream, for every ``(src, out, slot offset)`` of ``leaves``: the push
    kernel, the stream's waits, the land kernel; or the spinning kernel.
    No watch and no launch count: callers that time the bare call take
    ``ws.prepare`` themselves."""
    x = leaves[0][0]
    with torch.cuda.device(x.device):
        rc = _lib().bps_ring_rotate(
            len(leaves), _desc(leaves), n, my, int(gather), epoch,
            int(ws.protocol == "spin"), ws.peers.data_ptr(), ws.base,
            ws.slots_off, ws.cap, _stream(x))
    _check(rc, "rotate call")


def launch_presum(ws, x: torch.Tensor, out: torch.Tensor, n: int, my: int,
                  epoch: int) -> None:
    """A presum call (n kernels and n−1 stream waits, or the spinning
    kernel), as :func:`launch_rotate`."""
    with torch.cuda.device(x.device):
        rc = _lib().bps_ring_presum(
            x.data_ptr(), out.data_ptr(), out.numel(), n, my, epoch,
            int(ws.protocol == "spin"), ws.peers.data_ptr(), ws.base,
            ws.slots_off, ws.cap, _stream(x))
    _check(rc, "presum call")


def launch_push(ws, leaves, n: int, my: int, gather: bool,
                epoch: int) -> None:
    """Step 1 of a rotate call alone (the push kernel); with no leaves, an
    empty push that raises flag (parity, my) of every other rank and moves
    nothing (the kernel of a switch's measurement)."""
    with torch.cuda.device(ws.device):
        rc = _lib().bps_ring_push(
            len(leaves), _desc(leaves), n, my, int(gather), epoch,
            ws.peers.data_ptr(), ws.slots_off, ws.cap,
            torch.cuda.current_stream(ws.device).cuda_stream)
    _check(rc, "push kernel launch")


def launch_land(ws, leaves, n: int, my: int, epoch: int) -> None:
    """Step 3 of a rotate call alone (the land kernel)."""
    with torch.cuda.device(ws.device):
        rc = _lib().bps_ring_land(
            len(leaves), _desc(leaves), n, my, epoch, ws.peers.data_ptr(),
            ws.slots_off, ws.cap,
            torch.cuda.current_stream(ws.device).cuda_stream)
    _check(rc, "land kernel launch")


def launch_presum_hop(ws, x: torch.Tensor, out: torch.Tensor, n: int,
                      my: int, t: int, epoch: int) -> None:
    """Kernel t of a presum call alone."""
    with torch.cuda.device(ws.device):
        rc = _lib().bps_ring_presum_hop(
            x.data_ptr(), out.data_ptr(), out.numel(), n, my, t, epoch,
            ws.peers.data_ptr(), ws.slots_off, ws.cap,
            torch.cuda.current_stream(ws.device).cuda_stream)
    _check(rc, "presum kernel launch")


def wait_flag(ws, flag: int, epoch: int, flush: bool = False) -> None:
    """The current stream waits until this rank's flag ``flag`` (an index
    into ``[2][n]``) holds ``epoch``; ``flush`` adds
    ``CU_STREAM_WAIT_VALUE_FLUSH`` (where ``ws.can_flush``)."""
    with torch.cuda.device(ws.device):
        rc = _lib().bps_ring_wait(
            torch.cuda.current_stream(ws.device).cuda_stream,
            ws.base + 4 * flag, epoch, int(flush))
    _check(rc, "stream wait")


class LocalPeers:
    """n ranks' workspaces in this one process, each rank on a stream of
    its own, so all n run at once: for measuring a protocol's own time (no
    time-slicing); ``protocol`` defaults to :func:`plan`'s for this
    layout. The streams of one process may share a hardware queue, where
    a stream's wait holds back what follows it, so a stream-form call is
    issued step by step across the ranks: every push (or presum hop)
    ahead of the waits that need it."""

    def __init__(self, n: int, span: int, device: torch.device,
                 protocol: Optional[str] = None):
        self.n, self.epoch, self.device = n, 0, device
        self.protocol = protocol or plan("in_process")
        self.slots_off = flags_bytes(n)
        self.cap = _round_up(max(span, 1), _ALIGN)
        self.bufs = [torch.zeros(self.slots_off + 2 * n * self.cap,
                                 dtype=torch.uint8, device=device)
                     for _ in range(n)]
        self.peers = torch.tensor([b.data_ptr() for b in self.bufs],
                                  dtype=torch.int64, device=device)
        self.streams = [torch.cuda.Stream(device) for _ in range(n)]

    def rank(self, r: int):
        """Rank r's view, as the launch functions take it."""
        return _LocalRank(self, self.bufs[r].data_ptr())

    def _steps(self, steps) -> None:
        """Run ``steps`` (``(rank, fn)`` in issue order), each on its rank's
        stream, after the current stream's work; the current stream then
        waits for all."""
        cur = torch.cuda.current_stream(self.device)
        for st in self.streams:
            st.wait_stream(cur)
        for r, fn in steps:
            with torch.cuda.stream(self.streams[r]):
                fn(self.rank(r))
        for st in self.streams:
            cur.wait_stream(st)

    def rotate(self, leaves, gather: bool) -> None:
        """One rotate call of every rank; ``leaves[r]``: rank r's ``(src,
        out, slot offset)`` leaves."""
        self.epoch += 1
        e, n = self.epoch, self.n
        if self.protocol == "spin":
            self._steps([(r, lambda w, r=r: launch_rotate(
                w, leaves[r], n, r, gather, e)) for r in range(n)])
            return
        steps = [(r, lambda w, r=r: launch_push(w, leaves[r], n, r, gather,
                                                e)) for r in range(n)]
        for r in range(n):
            for f in rotate_flags(n, r, e):
                steps.append((r, lambda w, f=f: wait_flag(w, f, e)))
            steps.append((r, lambda w, r=r: launch_land(w, leaves[r], n, r,
                                                        e)))
        self._steps(steps)

    def presum(self, xs, outs) -> None:
        """One presum call of every rank: xs[r] (n, row) f32, outs[r]
        (row)."""
        self.epoch += 1
        e, n = self.epoch, self.n
        if self.protocol == "spin":
            self._steps([(r, lambda w, r=r: launch_presum(
                w, xs[r], outs[r], n, r, e)) for r in range(n)])
            return
        steps = []
        for t in range(n):
            for r in range(n):
                if t:
                    steps.append((r, lambda w, t=t: wait_flag(
                        w, (e & 1) * n + t, e)))
                steps.append((r, lambda w, r=r, t=t: launch_presum_hop(
                    w, xs[r], outs[r], n, r, t, e)))
        self._steps(steps)

    def bounce(self) -> None:
        """Ranks 0 and 1 bounce an empty push once (the stream form's
        switch): rank 0 signals, rank 1's stream waits for it and signals
        back, rank 0's stream waits."""
        self.epoch += 1
        e, p = self.epoch, (self.epoch & 1) * self.n
        self._steps([(0, lambda w: launch_push(w, [], self.n, 0, False, e)),
                     (1, lambda w: wait_flag(w, p, e)),
                     (1, lambda w: launch_push(w, [], self.n, 1, False, e)),
                     (0, lambda w: wait_flag(w, p + 1, e))])


class _LocalRank:
    """One rank of :class:`LocalPeers`: the fields the launch functions
    read."""

    def __init__(self, peers: LocalPeers, base: int):
        self.peers, self.base = peers.peers, base
        self.slots_off, self.cap = peers.slots_off, peers.cap
        self.device, self.protocol = peers.device, peers.protocol


def _check_input(x: torch.Tensor, dtypes=None) -> None:
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor; got {x.device}")
    if dtypes is not None and x.dtype not in dtypes:
        raise TypeError(f"x must be one of {dtypes}; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _rotate_cuda(payload: Payload, n: int, my: int,
                 gather: bool, group=None) -> Payload:
    """One rotate call for every leaf of ``payload`` (CUDA, contiguous,
    one card): returns the leaves' (n, ...) outputs under the same
    keys."""
    if len(payload) > MAX_LEAVES:
        raise ValueError(f"a ring call carries at most {MAX_LEAVES} leaves; "
                         f"got {len(payload)}")
    dev = None
    for x in payload.values():
        _check_input(x)
        if dev is not None and x.device != dev:
            raise ValueError(f"every leaf must be on one card; got {dev} and "
                             f"{x.device}")
        dev = x.device
    outs = {k: torch.empty((n,) + (tuple(x.shape) if gather
                                   else tuple(x.shape[1:])),
                           dtype=x.dtype, device=x.device)
            for k, x in payload.items()}
    live = {k: o for k, o in outs.items() if o.numel()}
    if not live:
        return outs
    layout, span = slot_layout({k: (o.shape[1:], o.dtype)
                                for k, o in live.items()})
    ws = workspace(dev, group)
    epoch = ws.prepare(span)
    launch_rotate(ws, [(payload[k], o, layout[k][0])
                       for k, o in live.items()], n, my, gather, epoch)
    ws.watch(epoch, "allgather" if gather else "collect",
             rotate_flags(n, my, epoch))
    launches["ring_rotate"] += 1
    return outs


def _presum_cuda(x: torch.Tensor, n: int, my: int,
                 group=None) -> torch.Tensor:
    _check_input(x, (torch.float32,))
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    ws = workspace(x.device, group)
    epoch = ws.prepare(out.numel() * 4)
    launch_presum(ws, x, out, n, my, epoch)
    ws.watch(epoch, "presum", presum_flags(n, epoch))
    launches["ring_presum"] += 1
    return out


# --------------------------------------------------------------------------
# public API (over the default process group, or ``group``)
# --------------------------------------------------------------------------
def _size_rank(n: Optional[int], group=None) -> Tuple[int, int]:
    """(n, this rank's index): ``group``'s (the default group's when
    None) when n is None; n == 1 needs no group, any other n must be the
    group's size."""
    if n == 1:
        return 1, 0
    if not (dist.is_available() and dist.is_initialized()):
        if n is None:
            return 1, 0
        raise RuntimeError(f"a ring over {n} ranks needs an initialized "
                           "process group")
    size = dist.get_world_size(group)
    if n is not None and n != size:
        raise ValueError(f"ring over {n} ranks in a group of {size}")
    return size, dist.get_rank(group)


def _check_rows(x: torch.Tensor, n: int) -> None:
    if x.ndim == 0 or x.shape[0] != n:
        raise ValueError(f"expected ({n}, ...) rows; got {tuple(x.shape)}")


def _on_card(payload: Payload) -> bool:
    """Whether the payload's leaves are CUDA tensors (all or none)."""
    cuda = {x.is_cuda for x in payload.values()}
    if len(cuda) > 1:
        raise ValueError("a payload's leaves must all be on the card or all "
                         "on the CPU")
    return cuda == {True}


def ring_collect_tree(payload: Payload, n: Optional[int] = None,
                      group=None) -> Payload:
    """:func:`ring_collect` of every leaf of ``payload`` (a dict of (n, ...)
    rows), in one call on the card: the same keys, the same bits."""
    n, my = _size_rank(n, group)
    if n == 1:
        return dict(payload)
    for x in payload.values():
        _check_rows(x, n)
    if _on_card(payload):
        return _rotate_cuda({k: x.contiguous() for k, x in payload.items()},
                            n, my, gather=False, group=group)
    return {k: _collect_torch(x, n, my, group) for k, x in payload.items()}


def ring_allgather_tree(payload: Payload, n: Optional[int] = None,
                        group=None) -> Payload:
    """:func:`ring_allgather` of every leaf of ``payload``, in one call on
    the card: the same keys, the same bits."""
    n, my = _size_rank(n, group)
    if n == 1:
        return {k: x[None] for k, x in payload.items()}
    if _on_card(payload):
        return _rotate_cuda({k: x.contiguous() for k, x in payload.items()},
                            n, my, gather=True, group=group)
    return {k: _allgather_torch(x, n, my, group) for k, x in payload.items()}


def ring_collect(x: torch.Tensor, n: Optional[int] = None,
                 group=None) -> torch.Tensor:
    """(n, ...) rows, row j bound for rank j → (n, ...) rows, row w rank
    w's row for this rank (``all_to_all`` semantics): exact, moves bits
    only."""
    return ring_collect_tree({"x": x}, n, group)["x"]


def ring_allgather(x: torch.Tensor, n: Optional[int] = None,
                   group=None) -> torch.Tensor:
    """This rank's block → the (n, ...) rank-ordered stack of every
    rank's block (``all_gather`` semantics): exact, moves bits only."""
    return ring_allgather_tree({"x": x}, n, group)["x"]


def ring_presum(x: torch.Tensor, n: Optional[int] = None,
                group=None) -> torch.Tensor:
    """(n, ...) f32 rows → this rank's summed row, ring reduce-scatter
    order (rank d: p_{d+1} + p_{d+2} + … + p_d). Chain-ordered adds:
    exact positionally for presummable payloads, not bitwise the staged
    worker-order fold, so callers route stochastic codecs only."""
    n, my = _size_rank(n, group)
    if n == 1:
        return x[0]
    _check_rows(x, n)
    if x.dtype != torch.float32:
        raise TypeError(f"ring_presum adds f32 rows; got {x.dtype}")
    if x.is_cuda:
        return _presum_cuda(x.contiguous(), n, my, group)
    return _presum_torch(x, n, my, group)
