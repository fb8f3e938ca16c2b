"""Input pipeline: host→device prefetch (the port's counterpart of
``byteps_tpu/data/loader.py``).

The reference has no data loader of its own (models and data come from
the host framework); the part a framework must own is the host→device
hop: a step that blocks on its batch's copy serializes the PCIe transfer
with the card's compute. This module covers it:

* :func:`shard_batch` — put one host batch (a tuple, list or dict of
  numpy arrays or tensors) on the card. With a ``mesh`` each leaf is cut
  to this rank's block by its spec first (``("dp",)``: this rank's rows
  of the dp axis; ``()``: the whole leaf), so only the rank's rows cross
  PCIe — the counterpart of ``make_array_from_process_local_data``,
  where each process feeds its own rows of the global batch.
* :class:`PrefetchLoader` — wraps any host-batch iterator and runs
  :func:`shard_batch` in a background thread, ``depth`` batches ahead of
  the consumer: the producer pins each leaf and copies it to the card on
  a side CUDA stream, so batch t+1's copy runs under batch t's compute.
  The consumer's stream waits on the copy's event before the batch is
  handed out, and every leaf is marked used on that stream
  (``record_stream``), so the caching allocator cannot hand its memory
  to the side stream while the step still reads it.

On the CPU (``device="cpu"``) the copies are plain and synchronous.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from byteps_tpu_torch.ops.backend import resolve_device

__all__ = ["PrefetchLoader", "shard_batch"]


def _map(fn: Callable, batch: Any, spec: Any) -> Any:
    """``fn(leaf, leaf_spec)`` over a batch tree (tuple, list, dict);
    ``spec`` one spec for every leaf, or a tree matching ``batch``."""
    if isinstance(batch, dict):
        return {k: _map(fn, v, spec[k] if isinstance(spec, dict) else spec)
                for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        per = isinstance(spec, list) or (
            isinstance(spec, tuple) and len(spec) == len(batch)
            and all(s is None or isinstance(s, tuple) for s in spec))
        out = [_map(fn, v, spec[i] if per else spec)
               for i, v in enumerate(batch)]
        return type(batch)(out) if isinstance(batch, tuple) else out
    return fn(batch, spec)


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _rank_block(x, spec: Optional[tuple], mesh):
    """This rank's block of leaf ``x`` under ``spec`` on ``mesh``."""
    if mesh is None or not spec:
        return x
    from byteps_tpu_torch.parallel.partitioner import block_of

    idx = tuple(block_of(x.shape[d], spec[d] if d < len(spec) else None,
                         mesh) for d in range(x.ndim))
    return x[idx]


def shard_batch(batch: Any, spec: Any = None, mesh=None, device=None,
                stream=None) -> Any:
    """Place a host batch on ``device`` (the card unless told
    otherwise). ``spec`` is one partition spec for every leaf or a tree
    of them matching ``batch`` (a tuple of axis names a dimension, None
    for a whole dimension); with ``mesh`` each leaf is first cut to this
    rank's block. On the card each leaf is pinned and copied
    ``non_blocking`` on ``stream`` (the caller's current stream when
    None): the caller orders its consumer after that stream."""
    dev = resolve_device(device)

    def put(x, s):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        t = _rank_block(t, s, mesh)
        if dev.type != "cuda":
            return t.to(dev, copy=True)
        t = t.contiguous()
        if not t.is_pinned():
            t = t.pin_memory()
        if stream is None:
            return t.to(dev, non_blocking=True)
        with torch.cuda.stream(stream):
            return t.to(dev, non_blocking=True)

    return _map(put, batch, spec)


class PrefetchLoader:
    """Iterate device-resident batches ``depth`` ahead of use.

    >>> with PrefetchLoader(host_batches, depth=2) as loader:
    ...     for tokens, targets in loader:
    ...         loss = step(tokens, targets)

    ``spec``/``mesh``/``device`` as :func:`shard_batch`. The background
    thread stops at source exhaustion, on :meth:`close`, or on an error
    (re-raised in the consumer). One pass per source iterator."""

    _DONE = object()

    def __init__(self, source: Iterable[Any], spec: Any = None, mesh=None,
                 depth: int = 2, device=None) -> None:
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._source = iter(source)
        self._spec = spec
        self._mesh = mesh
        self._dev = resolve_device(device)
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name="byteps-prefetch", daemon=True)
        self._thread.start()

    def _produce(self, batch: Any, stream) -> Any:
        dev = shard_batch(batch, self._spec, self._mesh, self._dev, stream)
        if stream is None:
            return dev, None
        ev = torch.cuda.Event()
        ev.record(stream)
        return dev, ev

    def _run(self) -> None:
        stream = None
        try:
            if self._dev.type == "cuda":
                torch.cuda.set_device(self._dev)
                stream = torch.cuda.Stream(device=self._dev)
            for batch in self._source:
                if self._stop.is_set():
                    return
                item = self._produce(batch, stream)
                # blocks while `depth` batches wait: residency stays at
                # depth + 1 (this one and the queue)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(self._DONE, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is not self._DONE and self._stop.is_set():
            # close() ran while this call waited: the item may be a live
            # batch that won the drained slot — end instead of
            # delivering data after close()
            raise StopIteration
        if item is self._DONE:
            # terminal: later calls keep raising. _err was set before the
            # producer's _DONE, so no join is needed to see it; the join
            # is bounded (the producer may sit in the user's source)
            self._stop.set()
            self._thread.join(timeout=1.0)
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        batch, ev = item
        if ev is not None:
            cur = torch.cuda.current_stream(self._dev)
            cur.wait_event(ev)
            for t in _leaves(batch):
                t.record_stream(cur)
        return batch

    def close(self) -> None:
        """Stop prefetching and release the thread (idempotent)."""
        self._stop.set()
        try:  # unblock a producer waiting on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # the drain may have swallowed the producer's _DONE: put one back
        # so a consumer blocked in __next__ always wakes
        try:
            self._q.put_nowait(self._DONE)
        except queue.Full:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
