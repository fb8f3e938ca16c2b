"""Gradient aggregation and ``DistributedOptimizer`` (counterpart of
``byteps_tpu/jax/optimizer.py``, data parallelism only: no ZeRO, no
hierarchical multi-slice path).

The gradients of a step are flattened in the reference's leaf order
(``models.convert.flat_leaves``), concatenated into one f32 vector,
cut into ``BYTEPS_PARTITION_BYTES`` chunks, and each chunk is
aggregated in order: an all-reduce, or the compressed all-reduce of
``comm/ici.py`` with error feedback. With one rank and no compression
the aggregation is the identity. Error-feedback and Nesterov-momentum
state are flat f32 tensors of this rank (each rank is one reference
worker), held by the optimizer wrapper around a ``torch.optim``
optimizer.

Keys for the stochastic codecs (``compression.base.fold_in``), as the
reference derives them: the step's key is ``fold_in(fold_in(seed,
spec.seed), count)``, chunk i's ``fold_in(step_key, i)``; deterministic
codecs ignore them. The reference's batched-chunk mode
(``BYTEPS_COMPRESS_BATCH_CHUNKS`` > 1) is not ported: chunks run one
after another, its default.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from byteps_tpu_torch.comm.ici import (
    _resolve_tier,
    compressed_allreduce_local,
    world,
)
from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.compression import (
    CompressionSpec,
    fold_in,
    from_params,
    momentum_step,
)

# BYTEPS_REDUCE_DTYPE's values (common/config.py checks them)
REDUCE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _flatten_concat(leaves: Sequence[torch.Tensor],
                    dtype: torch.dtype = torch.float32
                    ) -> Tuple[torch.Tensor, List[int]]:
    flats = [t.reshape(-1).to(dtype) for t in leaves]
    sizes = [f.shape[0] for f in flats]
    return (torch.cat(flats) if len(flats) > 1 else flats[0]), sizes


def _unconcat_unflatten(flat: torch.Tensor, leaves: Sequence[torch.Tensor],
                        sizes: Sequence[int]) -> List[torch.Tensor]:
    outs, off = [], 0
    for leaf, s in zip(leaves, sizes):
        outs.append(flat[off:off + s].reshape(leaf.shape).to(leaf.dtype))
        off += s
    return outs


def _chunk_bounds(total: int, chunk_elems: int) -> List[Tuple[int, int]]:
    bounds, off = [], 0
    while off < total:
        ln = min(chunk_elems, total - off)
        bounds.append((off, ln))
        off += ln
    return bounds or [(0, total)]


def _aggregate_flat(flat: torch.Tensor, n: int, average: bool,
                    spec: CompressionSpec, rng: Optional[int],
                    ef_flat: Optional[torch.Tensor], chunk_elems: int,
                    two_way: bool):
    """Chunk a flat gradient vector and aggregate each chunk over the
    ranks, in order, chunk i with the key ``fold_in(rng, i)``, on the wire
    tier of ``BYTEPS_ICI_TIER`` (read once a step). Returns
    ``(agg_flat, new_ef_flat_or_None, num_chunks)``."""
    bounds = _chunk_bounds(flat.shape[0], chunk_elems)
    tier = _resolve_tier(None)
    if spec.enabled and rng is None:
        if spec.compressor.stochastic:
            raise ValueError(
                f"{spec.compressor.name} requires an rng that advances "
                "every step; pass rng= (DistributedOptimizer does this "
                "from its step count)")
        rng = 0
    out_chunks = []
    new_e_chunks = [] if ef_flat is not None else None
    for ci, (off, ln) in enumerate(bounds):
        g = flat[off:off + ln]
        if spec.enabled:
            e = ef_flat[off:off + ln] if ef_flat is not None else None
            res = compressed_allreduce_local(
                g, spec.compressor, n, average=average, two_way=two_way,
                ef_residual=e, rng=fold_in(rng, ci), tier=tier)
            if e is not None:
                out, ne = res
                new_e_chunks.append(ne)
            else:
                out = res
        else:
            s = g.clone()
            if n > 1:
                dist.all_reduce(s)
            out = s / n if average else s
            if new_e_chunks is not None:
                # no compression happened, so no error is carried forward
                new_e_chunks.append(torch.zeros(ln, dtype=torch.float32,
                                                device=g.device))
        out_chunks.append(out)
    agg = out_chunks[0] if len(out_chunks) == 1 else torch.cat(out_chunks)
    new_e = None
    if new_e_chunks is not None:
        new_e = (new_e_chunks[0] if len(new_e_chunks) == 1
                 else torch.cat(new_e_chunks))
    return agg, new_e, len(bounds)


def push_pull_inside(grads: Sequence[torch.Tensor], n: Optional[int] = None,
                     average: bool = True,
                     spec: Optional[CompressionSpec] = None,
                     rng: Optional[int] = None,
                     ef_residual: Optional[torch.Tensor] = None,
                     partition_bytes: Optional[int] = None,
                     two_way: bool = True):
    """Aggregate this rank's gradient leaves (in the reference's leaf
    order) across the ranks, ``rng`` the step's key (stochastic codecs
    require it). Returns the aggregated leaves, or ``(leaves,
    new_ef_residual)`` when ``ef_residual`` (a flat f32 vector of the
    total element count) is given."""
    cfg = get_config()
    if n is None:
        n = world()[0]
    if spec is None:
        spec = from_params(None)
    if n == 1 and not spec.enabled:
        # single-worker fast path: aggregation is the identity; no
        # compression happened, so no error is carried forward
        grads = list(grads)
        if ef_residual is not None:
            return grads, torch.zeros_like(ef_residual)
        return grads
    # compression aggregates f32; BYTEPS_REDUCE_DTYPE sets the dtype of
    # the uncompressed sums
    acc_dtype = (torch.float32 if spec.enabled
                 else REDUCE_DTYPES[cfg.reduce_dtype])
    flat, sizes = _flatten_concat(grads, acc_dtype)
    agg, new_e = _push_pull_flat(flat, n, average, spec, rng, ef_residual,
                                 partition_bytes, two_way)
    out = _unconcat_unflatten(agg, grads, sizes)
    if ef_residual is not None:
        return out, new_e
    return out


def _push_pull_flat(flat: torch.Tensor, n: int, average: bool,
                    spec: CompressionSpec, rng: Optional[int],
                    ef_residual: Optional[torch.Tensor],
                    partition_bytes: Optional[int], two_way: bool):
    """:func:`push_pull_inside` past the flatten: aggregate one flat
    vector (of the reduce dtype) in ``partition_bytes`` chunks. Returns
    ``(agg_flat, new_ef_flat_or_None)``."""
    partition_bytes = partition_bytes or get_config().partition_bytes
    chunk_elems = max(1, partition_bytes // flat.element_size())
    agg, new_e, _ = _aggregate_flat(flat, n, average, spec, rng,
                                    ef_residual, chunk_elems, two_way)
    return agg, new_e


class DistributedOptimizer:
    """Wrap a ``torch.optim`` optimizer with BytePS gradient aggregation:
    :meth:`step` aggregates the ``.grad`` of ``params`` (compressed when
    ``compression_params`` asks for it), writes the result back into
    ``.grad``, then steps the wrapped optimizer.

    ``params`` must be listed in the reference's leaf order
    (``models.convert.flat_leaves``): chunks, and so the onebit scale of
    each, span leaf boundaries in that order. ``ef`` and ``momentum`` are
    this rank's flat f32 worker state (None when off). ``seed`` with the
    codec's ``seed`` and the step ``count`` gives the step's key.

    Reference: ``byteps_tpu.jax.DistributedOptimizer`` (non-ZeRO,
    non-hierarchical ``update_fn``), itself the functional form of
    ``byteps.torch.DistributedOptimizer``."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 params: Sequence[torch.Tensor],
                 compression_params: Optional[Dict[str, Any]] = None,
                 average: bool = True,
                 partition_bytes: Optional[int] = None,
                 seed: int = 0):
        self.optimizer = optimizer
        self.params = list(params)
        self.spec = from_params(compression_params)
        self.average = average
        self.partition_bytes = partition_bytes
        self.seed = seed
        self.count = 0
        total = sum(p.numel() for p in self.params)
        dev = self.params[0].device

        def buf(on: bool):
            return (torch.zeros(total, dtype=torch.float32, device=dev)
                    if self.spec.enabled and on else None)

        self.ef = buf(self.spec.ef)
        self.momentum = buf(self.spec.momentum)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def aggregate(self) -> None:
        """Replace each parameter's ``.grad`` with the ranks' aggregate."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        spec = self.spec
        rng = fold_in(fold_in(self.seed, spec.seed), self.count)
        if self.momentum is not None:
            # Nesterov momentum before compression, on the flat vector
            # that is then aggregated as it stands
            flat, sizes = _flatten_concat(grads)
            flat, self.momentum = momentum_step(flat, self.momentum, spec.mu)
            agg, new_e = _push_pull_flat(
                flat, world()[0], self.average, spec, rng, self.ef,
                self.partition_bytes, spec.two_way)
            if self.ef is not None:
                self.ef = new_e
            agg = _unconcat_unflatten(agg, grads, sizes)
        elif self.ef is not None:
            agg, self.ef = push_pull_inside(
                grads, None, self.average, spec, rng, ef_residual=self.ef,
                partition_bytes=self.partition_bytes,
                two_way=spec.two_way)
        else:
            agg = push_pull_inside(
                grads, None, self.average, spec, rng,
                partition_bytes=self.partition_bytes,
                two_way=spec.two_way)
        for p, g in zip(self.params, agg):
            p.grad = g

    def step(self) -> None:
        self.aggregate()
        self.optimizer.step()
        self.count += 1
