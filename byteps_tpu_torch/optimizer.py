"""Gradient aggregation and ``DistributedOptimizer`` (counterpart of
``byteps_tpu/jax/optimizer.py``: data parallelism, replicated or ZeRO-1,
flat or hierarchical over a multi-slice mesh).

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

ZeRO-1 (``zero=True``, the reference's ``_zero_update``): the inner
optimizer's state lives on this rank's ``ceil(L/n)`` segment of the flat
f32 vector (segment r = elements ``[r·seg, (r+1)·seg)`` of the
zero-padded flat). A step flattens the gradients, applies Nesterov
momentum when the codec asks for it, and aggregates the whole vector
ONCE (``partition_bytes`` does not apply): raw, padded to ``n·seg``, cast
to ``BYTEPS_REDUCE_DTYPE``, reduce-scattered and divided by n; or
compressed, through ``compressed_reduce_scatter_local`` with the EF
residual and the step's key unchanged (no chunk fold). The inner
optimizer steps the segment with the same segment of the f32 parameters;
the stepped segments are all-gathered and written into the leaves. (The
reference gathers the *updates* and adds them; gathering the stepped
values is the same for an elementwise optimizer, and keeps the leaves
bit-equal to a replicated step's.) The moments (AdamW's ``exp_avg``,
``exp_avg_sq``) are ``ceil(L/n)`` f32 each; EF and momentum stay
full-length per rank, as in the reference.

ZeRO-1 runs over the ranks of ``axis`` (a mesh's dp axis: on a tp, pp or
ep mesh each tp shard, pp stage or ep rank shards its own slab's state
over its dp line) or the default group without one.

Multi-slice (``dcn_axis=``, the reference's ``dcn_axis`` path): ``axis``
is the dp axis inside a slice, ``dcn_axis`` the ``slice_`` axis across
slices and ``joint_axis`` the two joined (``Mesh.axes``). Uncompressed,
the gradients aggregate once over the joint axis and are divided by
``n·n_dcn``, as the reference's one ``psum`` over ``(dcn_axis, axis)``.
Compressed (the reference's ``_hier_update``): the flat f32 gradient,
zero-padded to ``n·seg`` (``seg = ceil(L/n)``), is reduce-scattered raw
over dp; Nesterov momentum runs on this rank's segment; the segment is
aggregated over ``slice_`` in ``partition_bytes`` chunks with error
feedback (``_aggregate_flat``, on the wire tier of ``BYTEPS_ICI_TIER``,
the ring over the ``slice_`` line's group); the aggregated segments
are all-gathered over dp, cut to L and divided by ``n·n_dcn``. Only
segment-sized compressed payloads cross the slow tier, each once, and
the EF and momentum buffers are segment-sized (``seg`` f32 a rank).
``zero=True`` does not compose with it (ZeRO-1's segment flow owns the
reduce-scatter), as in the reference.

The segment's master copy is transient: each step copies the segment
out of the leaves (``ceil(L/n)·4`` B, beside the flat gradient's
``L·4`` and the gathered ``n·ceil(L/n)·4``, all after the backward has
freed its activations) and frees it after the write-back. Kept between
steps it would cost ``ceil(L/n)·4`` B for good (GPT-2 medium:
1,419,485,184 B at n = 1, 709,742,592 at n = 2). Making the leaves
views of one flat buffer would save even the transient copy, at the
price of re-pointing every parameter of the caller's module into that
buffer; the transient copy does not raise the step's peak, which the
backward sets.

ZeRO restriction, as the reference's: the inner optimizer must be
ELEMENTWISE in the gradient (SGD, Adam, AdamW, ...): it sees one
segment, so a cross-element rule (a global-norm clip, a factored second
moment) would compute from partial data. ``torch.optim.LBFGS`` and
``torch.optim.Adafactor`` are refused; other such optimizers are not
detected. The optimizer must hold one parameter group and no state yet:
the wrapper moves that group onto the segment.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from byteps_tpu_torch.comm.ici import (
    _resolve_tier,
    all_gather_body,
    compressed_allreduce_local,
    compressed_reduce_scatter_local,
    reduce_scatter_body,
    world,
)
from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.compression import (
    CompressionSpec,
    fold_in,
    from_params,
    momentum_step,
)
from byteps_tpu_torch.parallel.mesh import collectives

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


def _group_of(axis):
    """The process group a collective over ``axis`` runs on: None (the
    default group) without an axis, at size 1, or where the axis is the
    whole job rank for rank; else the axis's group."""
    if axis is None or axis.size == 1:
        return None
    return None if tuple(axis.ranks) == tuple(range(world()[0])) \
        else axis.group


def _aggregate_flat(flat: torch.Tensor, n: int, average: bool,
                    spec: CompressionSpec, rng: Optional[int],
                    ef_flat: Optional[torch.Tensor], chunk_elems: int,
                    two_way: bool, group=None):
    """Chunk a flat gradient vector and aggregate each chunk over the
    ranks of ``group`` (the default group when None), in order, chunk i
    with the key ``fold_in(rng, i)``, on the wire tier of
    ``BYTEPS_ICI_TIER`` (read once a step). Returns
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
                ef_residual=e, rng=fold_in(rng, ci), tier=tier, group=group)
            if e is not None:
                out, ne = res
                new_e_chunks.append(ne)
            else:
                out = res
        else:
            s = g.clone()
            if n > 1:
                dist.all_reduce(s, group=group)
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
                     two_way: bool = True, group=None):
    """Aggregate this rank's gradient leaves (in the reference's leaf
    order) across the ranks of ``group`` (the default group when None;
    ``n`` its size), ``rng`` the step's key (stochastic codecs require
    it). Returns the aggregated leaves, or ``(leaves, new_ef_residual)``
    when ``ef_residual`` (a flat f32 vector of the total element count)
    is given."""
    cfg = get_config()
    if n is None:
        n = world(group)[0]
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
                                 partition_bytes, two_way, group)
    out = _unconcat_unflatten(agg, grads, sizes)
    if ef_residual is not None:
        return out, new_e
    return out


def _push_pull_flat(flat: torch.Tensor, n: int, average: bool,
                    spec: CompressionSpec, rng: Optional[int],
                    ef_residual: Optional[torch.Tensor],
                    partition_bytes: Optional[int], two_way: bool,
                    group=None):
    """:func:`push_pull_inside` past the flatten: aggregate one flat
    vector (of the reduce dtype) in ``partition_bytes`` chunks. Returns
    ``(agg_flat, new_ef_flat_or_None)``."""
    partition_bytes = partition_bytes or get_config().partition_bytes
    chunk_elems = max(1, partition_bytes // flat.element_size())
    agg, new_e, _ = _aggregate_flat(flat, n, average, spec, rng,
                                    ef_residual, chunk_elems, two_way,
                                    group)
    return agg, new_e


# inner optimizers that are not elementwise in the gradient (ZeRO refuses)
_NOT_ELEMENTWISE = tuple(c for c in (getattr(torch.optim, "LBFGS", None),
                                     getattr(torch.optim, "Adafactor", None))
                         if c is not None)


def _first_state(optimizer: torch.optim.Optimizer,
                 p: torch.Tensor) -> Dict[str, Any]:
    """The state ``optimizer``'s first step would create for ``p``, at
    zero: a throwaway optimizer of its class and hyperparameters steps a
    one-element parameter once, which names the keys; a per-element one
    becomes zeros like ``p``, a scalar one (AdamW's ``step``) zeros like
    the probe's."""
    probe = torch.zeros(1, requires_grad=True)
    o = type(optimizer)([probe])
    o.param_groups[0].update({k: v for k, v in
                              optimizer.param_groups[0].items()
                              if k != "params"})
    probe.grad = torch.zeros(1)
    o.step()
    return {k: (torch.zeros_like(p) if torch.is_tensor(v) and v.ndim > 0
                and v.shape == probe.shape else
                torch.zeros_like(v) if torch.is_tensor(v) else v)
            for k, v in o.state[probe].items()}


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

    ``zero=True`` is ZeRO-1 (the module docstring): ``optimizer`` (built
    over ``params``, one group, not stepped yet) is moved onto this
    rank's segment of the flat parameters, sharded over the ranks of
    ``axis`` (the default group without one), their number fixed at
    construction. ``params`` must be f32.

    ``axis`` (a mesh's dp :class:`~byteps_tpu_torch.parallel.mesh.Axis`)
    aggregates over that axis's ranks instead of the default group: of
    size 1 nothing is aggregated. ``dcn_axis`` (the ``slice_`` axis) with
    ``joint_axis`` (``axis`` and ``dcn_axis`` joined) is the multi-slice
    path (the module docstring). ``resymmetrize``, when given, runs
    between the aggregation and the inner step (the mesh step makes the
    tp-replicated leaves' aggregate the same on every tp rank there);
    under ZeRO-1 it is called with this rank's aggregated segment and
    the segment's offset in the flat vector.

    Reference: ``byteps_tpu.jax.DistributedOptimizer`` (``update_fn``,
    ``_zero_update`` and ``_hier_update``), itself the functional form of
    ``byteps.torch.DistributedOptimizer``."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 params: Sequence[torch.Tensor],
                 compression_params: Optional[Dict[str, Any]] = None,
                 average: bool = True,
                 partition_bytes: Optional[int] = None,
                 seed: int = 0,
                 zero: bool = False,
                 axis=None,
                 resymmetrize=None,
                 dcn_axis=None,
                 joint_axis=None):
        if zero and dcn_axis is not None:
            raise ValueError(
                "zero=True and dcn_axis are mutually exclusive — ZeRO-1's "
                "segment flow already owns the reduce-scatter; shard over "
                "one axis or use the ZeRO-3 factory for multi-slice FSDP")
        if dcn_axis is not None and joint_axis is None:
            raise ValueError("dcn_axis needs joint_axis: the axis and the "
                             "dcn axis joined (Mesh.axes)")
        self.optimizer = optimizer
        self.params = list(params)
        self.spec = from_params(compression_params)
        self.average = average
        self.partition_bytes = partition_bytes
        self.seed = seed
        self.count = 0
        self.zero = zero
        self.axis = axis
        self.dcn_axis = dcn_axis
        # the axis the flat path aggregates over: the joint one on a
        # multi-slice mesh
        self._agg_axis = joint_axis if dcn_axis is not None else axis
        self.resymmetrize = resymmetrize
        total = sum(p.numel() for p in self.params)
        dev = self.params[0].device
        self._state_len = total
        if self._hierarchical():
            # each rank's residuals cover its own dp segment only
            self._state_len = -(-total // self._dp_size())

        def buf(on: bool):
            return (torch.zeros(self._state_len, dtype=torch.float32,
                                device=dev)
                    if self.spec.enabled and on else None)

        self.ef = buf(self.spec.ef)
        self.momentum = buf(self.spec.momentum)
        if zero:
            self._zero_setup(total, dev)

    def _hierarchical(self) -> bool:
        return self.dcn_axis is not None and self.spec.enabled

    def _dp_size(self) -> int:
        return 1 if self.axis is None else self.axis.size

    def _zero_setup(self, total: int, dev: torch.device) -> None:
        opt = self.optimizer
        if isinstance(opt, _NOT_ELEMENTWISE):
            raise ValueError(
                f"zero=True needs an elementwise inner optimizer; "
                f"{type(opt).__name__} computes across elements and would "
                "see one segment only (use zero=False)")
        if len(opt.param_groups) != 1 or opt.state:
            raise ValueError("zero=True takes an optimizer with one "
                             "parameter group and no state yet")
        bad = [p.dtype for p in self.params if p.dtype != torch.float32]
        if bad:
            raise ValueError(f"zero=True steps f32 parameters; got {bad[0]}")
        self.n, self.rank = ((self.axis.size, self.axis.index)
                             if self.axis is not None else world())
        self.total = total
        self.seg = -(-total // self.n)
        # the inner optimizer's one parameter: this rank's segment, holding
        # data only while a step runs
        self._seg = torch.empty(0, dtype=torch.float32, device=dev)
        opt.param_groups[0]["params"] = [self._seg]

    def _group(self):
        """The process group the flat aggregation runs over (None: the
        default group)."""
        return _group_of(self._agg_axis)

    def _workers(self) -> int:
        return (world()[0] if self._agg_axis is None
                else self._agg_axis.size)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def moment_bytes(self) -> int:
        """Bytes of the inner optimizer's per-element state on this rank
        (AdamW: ``exp_avg`` and ``exp_avg_sq``; scalars such as the step
        count left out)."""
        return sum(t.numel() * t.element_size()
                   for st in self.optimizer.state.values()
                   for t in st.values()
                   if torch.is_tensor(t) and t.ndim > 0)

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def _step_key(self) -> int:
        return fold_in(fold_in(self.seed, self.spec.seed), self.count)

    def _check_state(self) -> None:
        for buf, kind in ((self.ef, "EF"), (self.momentum, "momentum")):
            if buf is not None and buf.shape[0] != self._state_len:
                raise ValueError(
                    f"{kind} state has {buf.shape[0]} elements on this rank "
                    f"but this rank expects {self._state_len} (the flat "
                    "gradient's length, or its dp segment's on the "
                    "hierarchical multi-slice path)")

    def aggregate(self) -> None:
        """Replace each parameter's ``.grad`` with the ranks' aggregate."""
        if self.zero:
            raise RuntimeError("under zero=True the aggregate exists only "
                               "as this rank's segment; call step()")
        self._check_state()
        grads = self._grads()
        spec = self.spec
        rng = self._step_key()
        if self._hierarchical():
            agg = self._hier_aggregate(grads, rng)
        elif self.momentum is not None:
            # Nesterov momentum before compression, on the flat vector
            # that is then aggregated as it stands
            flat, sizes = _flatten_concat(grads)
            flat, self.momentum = momentum_step(flat, self.momentum, spec.mu)
            agg, new_e = _push_pull_flat(
                flat, self._workers(), self.average, spec, rng, self.ef,
                self.partition_bytes, spec.two_way, self._group())
            if self.ef is not None:
                self.ef = new_e
            agg = _unconcat_unflatten(agg, grads, sizes)
        elif self.ef is not None:
            agg, self.ef = push_pull_inside(
                grads, self._workers(), self.average, spec, rng,
                ef_residual=self.ef, partition_bytes=self.partition_bytes,
                two_way=spec.two_way, group=self._group())
        else:
            agg = push_pull_inside(
                grads, self._workers(), self.average, spec, rng,
                partition_bytes=self.partition_bytes,
                two_way=spec.two_way, group=self._group())
        for p, g in zip(self.params, agg):
            p.grad = g

    def _hier_aggregate(self, grads: List[torch.Tensor],
                        rng: int) -> List[torch.Tensor]:
        """The compressed multi-slice aggregation (the reference's
        ``_hier_update``, the module docstring): raw reduce-scatter over
        dp, momentum and the chunked compressed exchange with EF over
        ``slice_`` on this rank's segment, raw all-gather over dp."""
        spec = self.spec
        flat, sizes = _flatten_concat(grads)
        L = flat.shape[0]
        n, n_dcn = self._dp_size(), self.dcn_axis.size
        dp_group = _group_of(self.axis)
        if n > 1:
            seg = reduce_scatter_body(flat, n, dp_group)
            collectives["hier_dp_reduce_scatter"] += 1
        else:
            seg = flat
        if self.momentum is not None:
            seg, self.momentum = momentum_step(seg, self.momentum, spec.mu)
        pb = self.partition_bytes or get_config().partition_bytes
        agg, new_e, _ = _aggregate_flat(
            seg, n_dcn, False, spec, rng, self.ef, max(1, pb // 4),
            spec.two_way, _group_of(self.dcn_axis))
        if self.ef is not None:
            self.ef = new_e
        if n > 1:
            full = all_gather_body(agg, n, L, dp_group)
            collectives["hier_dp_all_gather"] += 1
        else:
            full = agg[:L]
        if self.average:
            full = full / (n * n_dcn)
        return _unconcat_unflatten(full, grads, sizes)

    def _zero_aggregate(self) -> torch.Tensor:
        """This rank's ``(seg,)`` segment of the aggregated flat gradient:
        one reduce-scatter of the whole vector over ``axis``, raw or
        compressed."""
        spec, n, group = self.spec, self.n, self._group()
        flat, _ = _flatten_concat(self._grads())
        if self.momentum is not None:
            flat, self.momentum = momentum_step(flat, self.momentum, spec.mu)
        if spec.enabled:
            tier = _resolve_tier(None)
            res = compressed_reduce_scatter_local(
                flat, spec.compressor, n, average=self.average,
                ef_residual=self.ef, rng=self._step_key(), tier=tier,
                group=group)
            if self.ef is None:
                return res
            seg, self.ef = res
            return seg
        # BYTEPS_REDUCE_DTYPE sets the dtype of the raw sum, as on the
        # chunked path
        flat = flat.to(REDUCE_DTYPES[get_config().reduce_dtype])
        s = (reduce_scatter_body(flat, n, group) if n > 1 else flat).float()
        return s / n if self.average and n > 1 else s

    def _param_segment(self) -> torch.Tensor:
        """A copy of this rank's segment of the flat f32 parameters, zero
        past the end."""
        start, seg = self.rank * self.seg, self.seg
        out = torch.empty(seg, dtype=torch.float32,
                          device=self.params[0].device)
        end, off = start, 0
        for p in self.params:
            lo, hi = max(off, start), min(off + p.numel(), start + seg)
            if lo < hi:
                out[lo - start:hi - start] = \
                    p.detach().reshape(-1)[lo - off:hi - off]
                end = hi
            off += p.numel()
        out[end - start:].zero_()
        return out

    @torch.no_grad()
    def _zero_step(self) -> None:
        if self._workers() != self.n:
            raise RuntimeError(f"ZeRO state was sharded over {self.n} ranks; "
                               f"the group now has {self._workers()}")
        self._check_state()
        g = self._zero_aggregate()
        if self.resymmetrize is not None:
            self.resymmetrize(g, self.rank * self.seg)
        self._seg.data = self._param_segment()
        self._seg.grad = g
        self.optimizer.step()
        full = all_gather_body(self._seg.detach(), self.n, self.total,
                               self._group())
        off = 0
        for p in self.params:
            p.copy_(full[off:off + p.numel()].view_as(p))
            off += p.numel()
        self._seg.grad = None
        self._seg.data = self._seg.new_empty(0)

    def state_tree(self) -> Dict[str, Any]:
        """This rank's whole optimizer state, what a bit-exact resume
        needs (``checkpoint.train_state``'s ``opt``): the step ``count``
        and ``seed`` (with the codec's seed they make each step's codec
        key), the EF residual and the momentum (None when off), and the
        inner optimizer's state a parameter in ``params`` order. A
        parameter the inner optimizer has not stepped yet gets the state
        its first step would create, zero, so a fresh optimizer's tree
        is a restore's ``like``. The tensors are the live ones."""
        if self.zero:
            raise NotImplementedError(
                "state_tree under zero=True (ZeRO-1's segment state) is "
                "not ported yet")
        inner = []
        for p in self.params:
            st = self.optimizer.state.get(p)
            inner.append(dict(st) if st else _first_state(self.optimizer, p))
        return {"count": self.count, "seed": self.seed, "ef": self.ef,
                "momentum": self.momentum, "inner": inner}

    @torch.no_grad()
    def load_state_tree(self, tree: Dict[str, Any]) -> None:
        """Adopt a :meth:`state_tree` (a restored one, laid out as this
        optimizer's own): the count, the EF and momentum buffers, and
        the inner optimizer's state a parameter."""
        if self.zero:
            raise NotImplementedError(
                "load_state_tree under zero=True is not ported yet")
        if int(tree["seed"]) != self.seed:
            raise ValueError(f"state of seed {tree['seed']}, this optimizer "
                             f"has seed {self.seed}")
        for name in ("ef", "momentum"):
            cur, new = getattr(self, name), tree[name]
            if (cur is None) != (new is None) or (
                    cur is not None and new.shape != cur.shape):
                raise ValueError(f"{name} state does not match this "
                                 "optimizer's (codec or layout differs)")
            if cur is not None:
                setattr(self, name, new.to(cur.device, cur.dtype).clone())
        if len(tree["inner"]) != len(self.params):
            raise ValueError(f"{len(tree['inner'])} parameter states for "
                             f"{len(self.params)} parameters")
        for p, st in zip(self.params, tree["inner"]):
            self.optimizer.state[p] = {
                k: v.clone() if torch.is_tensor(v) else v
                for k, v in st.items()}
        self.count = int(tree["count"])

    def step(self) -> None:
        if self.zero:
            self._zero_step()
        else:
            self.aggregate()
            if self.resymmetrize is not None:
                self.resymmetrize()
            self.optimizer.step()
        self.count += 1
