"""The GPT training steps and the eval step (counterparts of
``byteps_tpu/models/train.py``'s ``make_gpt_train_step``,
``make_gpt_pp_train_step``, ``make_gpt_moe_train_step``,
``make_gpt_moe_pp_train_step``, ``make_eval_step`` and
``evaluate_perplexity``: dp, tp, sp, pp, ep and the multi-slice
``slice_`` axis; ``zero_3=True`` delegates to ``parallel/zero3.py``).

One step runs, in order: the forward, the backward (attention through
the hand-written flash kernels on the card), the flattening of the
gradients in the reference's leaf order, the chunked aggregation of
``optimizer.DistributedOptimizer`` (raw, or compressed by any codec of
``compression``, with error feedback and momentum as asked),
the write-back into ``.grad``, and a ``torch.optim.AdamW`` step. Each
rank is one process. Without a mesh each rank takes its own batch and
the step aggregates over the default ``torch.distributed`` group, which
the caller initializes. ``zero_1=True`` shards AdamW's moments over the
ranks (ZeRO-1: one reduce-scatter of the flat gradient, the segment's
step, an all-gather of the stepped segments). ``accum_steps`` > 1 splits
the rank's batch into that many microbatches and runs forward and
backward one microbatch at a time (only one microbatch's activations
live), summing the unscaled gradients and losses and dividing once by
their count before the one aggregation of the step, as the reference's
``_accumulating_value_and_grad`` does (:func:`accumulate`, which also
takes its ``weight_fn``: BERT's microbatches are weighted by their mask
counts).

On a mesh (``mesh=``, ``parallel/mesh.py``) every rank takes the global
batch and keeps its block (:meth:`Partitioner.local_batch`: its dp rows,
its sp slice); its parameters are its tp shards. ``gpt_loss`` runs with
the mesh's tp and sp axes: the Megatron pair sums over tp inside the
forward and backward, so a tp-sharded leaf's gradient is whole on its
rank and a tp-replicated one's is whole and bit-identical on every tp
rank (the reference's VMA contract, ``_make_resymmetrize``); the loss is
the mean over sp, whose backward leaves each sp rank the share of its
own tokens, so every leaf's gradient is then summed over sp (the
reference's ``_manual_axis_sums`` over sp). The ``DistributedOptimizer``
aggregates over the dp axis alone; on a mesh with a ``slice_`` axis over
dp with ``slice_`` as its DCN tier (raw: one sum over the two joined;
compressed: the hierarchical path of ``optimizer.py``), or over
``slice_`` alone where the mesh has no dp axis (the reference's
``_make_tx``). A lossy codec's onebit scale (or
top-k selection) spans a chunk that mixes a rank's tp shards with the
replicated leaves, so the replicated leaves' aggregate would differ
between tp ranks: the step makes it tp index 0's on every tp rank (one
broadcast over tp between the aggregation and AdamW), where the
reference leaves its tp replicas to drift apart.

The pipeline steps (``make_gpt_pp_train_step``, and
``make_gpt_moe_pp_train_step`` with MoE blocks) hold this rank's pp
stage's layers as one stacked slab (``models.convert.shard_params(...,
stacked=True)``) and run ``gpt_pp_loss`` (``moe_gpt_pp_loss``): GPipe
microbatches through ``parallel/pipeline.py``, the loss the last stage's.
The MoE steps route each rank's tokens to the experts of its ep line
(``parallel/moe.py``). The gradient assembly after the backward, the
reference's ``_build_pp_jit`` and its MoE step: every leaf summed over
sp (as above); the leaves every stage holds (the embeddings, the final
norm) summed over pp (each stage holds its part of their gradient); the
leaves every ep rank holds (all but the experts) summed over ep, and
then every gradient divided by ep once (the loss is the mean of the ep
ranks' local means, and the experts' gradients already carry their
peers' part through the exchange's backward). Each of those sums is one
flat all-reduce over its axis. The ``DistributedOptimizer`` then
aggregates over dp as above, each stage its own slab with its own EF
state. The reported loss is summed over pp, then averaged over
``slice_`` and dp (and ep), one all-reduce over those axes joined.

ZeRO-1 (``zero_1=True``) shards the optimizer state over the dp axis on
any mesh (each tp shard, pp stage or ep rank its own slab's segment, the
reference's ``state_leading``); it needs a dp axis and refuses a
``slice_`` axis, with the reference's messages.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from byteps_tpu_torch.comm.ici import world
from byteps_tpu_torch.compression import from_params
from byteps_tpu_torch.models.bert import BertConfig, bert_init, bert_mlm_loss
from byteps_tpu_torch.models.convert import (flat_leaves, flat_specs,
                                             param_specs, shard_params,
                                             shard_tree)
from byteps_tpu_torch.models.gpt import (GPT, GPTConfig, ParamTree, gpt_init,
                                         gpt_loss, gpt_pp_loss)
from byteps_tpu_torch.models.resnet import (ResNetConfig, resnet_init,
                                            resnet_loss)
from byteps_tpu_torch.models.t5 import T5Config, t5_init, t5_loss
from byteps_tpu_torch.models.vit import ViTConfig, vit_init, vit_loss
from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.optimizer import DistributedOptimizer
from byteps_tpu_torch.parallel.mesh import Axis, collectives
from byteps_tpu_torch.parallel.partitioner import Partitioner, spec_axes
from byteps_tpu_torch.parallel.tp import maybe_psum, pmean


def adamw(leaves: Sequence[torch.Tensor], lr: float = 1e-3
          ) -> torch.optim.Optimizer:
    """``torch.optim.AdamW`` with ``optax.adamw``'s defaults (β 0.9/0.999,
    ε 1e-8 outside the square root, weight decay 1e-4 on every leaf;
    torch's own default decay is 1e-2)."""
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _check_seq_layout(seq_layout: str, sp=None) -> None:
    if seq_layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown seq_layout {seq_layout!r} — expected "
                         "'contiguous' or 'zigzag'")
    if seq_layout == "zigzag" and sp is None:
        # the zigzag contract is "feed zigzag_permutation-permuted tokens";
        # without an sp axis those would just be scrambled tokens
        raise ValueError(
            "seq_layout='zigzag' requires a mesh with an sp axis — the "
            "layout only exists to balance the causal ring over sp; on "
            "this mesh the permuted inputs would just be scrambled tokens")


class _Axes:
    """The (slice_, dp, tp, sp, pp, ep) axes of a mesh for ``cfg`` (None
    where the mesh has no such axis) and its partitioner; all None
    without a mesh."""

    def __init__(self, cfg: GPTConfig, mesh):
        self.mesh = mesh
        self.part = (Partitioner.for_config(cfg, mesh) if mesh is not None
                     else None)

        def ax(name):
            return mesh.axis(name) if name is not None else None

        p = self.part
        self.dp = ax(p.dp) if p else None
        self.tp = ax(p.tp) if p else None
        self.sp = ax(p.sp) if p else None
        self.pp = ax(p.pp) if p else None
        self.ep = ax(p.ep) if p else None
        self.slice_ = ax(p.slice_) if p else None

    def block(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.part is None else self.part.local_batch(x)

    def joint(self, names: Sequence[str]):
        """The mesh axes ``names`` joined (``Mesh.axes``, collective the
        first time); None without a mesh."""
        return self.mesh.axes(names) if self.mesh is not None else None

    def optimizer_axes(self) -> Dict[str, Any]:
        """What the ``DistributedOptimizer`` aggregates over, as its
        keywords: the default group without a mesh; the dp axis, with
        ``slice_`` as its DCN tier on a multi-slice mesh; ``slice_``
        alone where the mesh has no dp axis (it becomes the worker axis,
        the reference's ``_make_tx``); one rank where it has neither."""
        if self.mesh is None:
            return {}
        if _live(self.slice_):
            if not _live(self.dp):
                return {"axis": self.slice_}
            return {"axis": self.dp, "dcn_axis": self.slice_,
                    "joint_axis": self.joint(("slice_", "dp"))}
        if self.dp is not None:
            return {"axis": self.dp}
        return {"axis": Axis("dp", 1, 0, (self.mesh.rank,))}


def _live(axis) -> bool:
    return axis is not None and axis.size > 1


def _sum_over(leaves: Sequence[torch.Tensor], axis, kind: str) -> None:
    """Sum every leaf's ``.grad`` (zeros where a leaf has none) over
    ``axis``, in one flat all-reduce, counted as ``kind``."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in leaves]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=axis.group)
    collectives[kind] += 1
    off = 0
    for p, g in zip(leaves, grads):
        p.grad = flat[off:off + g.numel()].view_as(g).to(g.dtype)
        off += g.numel()


def _tp_resymmetrize(leaves: Sequence[torch.Tensor], specs, tp):
    """The aggregate of the tp-replicated leaves made tp index 0's on
    every tp rank: one broadcast over tp of their ``.grad``, or under
    ZeRO-1 (``resym(seg, start)``) of their elements in this rank's
    aggregated segment, which starts at ``start`` of the flat vector
    (every tp rank's flat puts those leaves at the same offsets)."""
    rep = [p for p, s in zip(leaves, specs) if "tp" not in spec_axes(s)]
    spans, off = [], 0
    for p, s in zip(leaves, specs):
        if "tp" not in spec_axes(s):
            spans.append((off, off + p.numel()))
        off += p.numel()

    def resym(seg: Optional[torch.Tensor] = None, start: int = 0) -> None:
        if seg is None:
            parts = [p.grad for p in rep]
        else:
            end = start + seg.shape[0]
            parts = [seg[max(a, start) - start:min(b, end) - start]
                     for a, b in spans if a < end and b > start]
            if not parts:
                return
        flat = torch.cat([t.reshape(-1) for t in parts])
        dist.broadcast(flat, src=tp.ranks[0], group=tp.group)
        collectives["tp_broadcast"] += 1
        off = 0
        for t in parts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()

    return resym


def make_gpt_train_step(
    cfg: GPTConfig,
    make_optimizer: Callable[[Sequence[torch.Tensor]],
                             torch.optim.Optimizer] = adamw,
    compression_params: Optional[Dict[str, Any]] = None,
    partition_bytes: Optional[int] = None,
    remat: bool = False,
    chunked_ce=True,
    zero_1: bool = False,
    zero_3: bool = False,
    accum_steps: int = 1,
    seq_layout: str = "contiguous",
    init_params: Optional[GPT] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    mesh=None,
):
    """Returns ``(step, params, opt)``.

    ``step(tokens, targets) -> loss`` takes (B, S) token ids (tensors or
    numpy) and returns the mean loss over the ranks, as a 0-d f32 tensor
    on the device, after updating ``params`` in place: this rank's batch
    without a mesh, the global batch on one (each rank keeps its block).
    ``params`` is a :class:`GPT` on ``device`` (the card unless told
    otherwise): ``init_params`` made trainable, or fresh
    :func:`gpt_init` weights from ``generator``; on a mesh, this rank's
    shards of them (``init_params`` whole). ``opt`` is the
    :class:`DistributedOptimizer` around ``make_optimizer(leaves)``
    (default :func:`adamw`), its EF/momentum buffers this rank's state.
    ``compression_params`` as the reference's, e.g. ``{"compressor":
    "onebit", "ef": "vanilla"}`` or ``{"compressor": "topk", "k": 0.01,
    "ef": "vanilla", "selection": "block"}``; ``remat`` recomputes each
    block in the backward; ``chunked_ce`` True (the fused readout + CE),
    ``"vocab_parallel"`` (its vocab split over tp) or False (the dense
    chain). ``zero_1=True`` is ZeRO-1 (``DistributedOptimizer(zero=True)``
    over the dp axis; an elementwise ``make_optimizer`` only).
    ``accum_steps`` > 1 accumulates over that many sequential
    microbatches of the rank's batch before the one aggregation and
    update. ``seq_layout="zigzag"`` runs the load-balanced causal ring
    over sp: feed tokens and targets permuted with
    ``parallel.ring_attention.zigzag_permutation``; it needs a mesh with
    an sp axis. On a mesh with a ``slice_`` axis the batch splits over
    ``slice_`` and dp, the gradients aggregate over both (the module
    docstring) and the loss is their mean.

    ``zero_3=True`` delegates to
    :func:`~byteps_tpu_torch.parallel.zero3.make_gpt_zero3_train_step`
    (ZeRO-3 FSDP; ``accum_steps`` must stay 1) and returns what it
    returns: ``(step, segs, opt)``, ``segs`` this rank's parameter
    segments in place of ``params``."""
    if zero_3:
        if zero_1:
            raise ValueError("zero_1 and zero_3 are mutually exclusive")
        if accum_steps != 1:
            raise ValueError("accum_steps does not compose with zero_3")
        from byteps_tpu_torch.parallel.zero3 import make_gpt_zero3_train_step

        return make_gpt_zero3_train_step(
            cfg, mesh, make_optimizer, compression_params=compression_params,
            partition_bytes=partition_bytes, remat=remat,
            seq_layout=seq_layout, init_params=init_params,
            generator=generator, chunked_ce=chunked_ce, device=device)
    axes = _Axes(cfg, mesh)
    _check_seq_layout(seq_layout, axes.sp)
    if accum_steps < 1:
        raise ValueError(f"accum_steps={accum_steps} must be at least 1")
    dev = resolve_device(device)
    params = _whole_params(cfg, init_params, generator, dev, gpt_init)
    if mesh is not None:
        params = shard_params(params, mesh)
    leaves, _, opt = _mesh_optimizer(cfg, params, mesh, axes,
                                     make_optimizer, compression_params,
                                     partition_bytes, zero_1)
    mean_axis = axes.joint(("slice_", "dp"))

    def step(tokens, targets) -> torch.Tensor:
        opt.zero_grad()
        tok = axes.block(_as_ids(tokens, dev))
        tgt = axes.block(_as_ids(targets, dev))
        loss = accumulate(
            lambda a, b: gpt_loss(params, a, b, cfg, tp_axis=axes.tp,
                                  sp_axis=axes.sp, remat=remat,
                                  seq_layout=seq_layout,
                                  chunked_ce=chunked_ce),
            (tok, tgt), accum_steps, leaves)
        if _live(axes.sp):
            # each sp rank holds the share of its own tokens
            _sum_over(leaves, axes.sp, "sp_grad_sum")
        opt.step()
        return _group_mean(loss, mean_axis)

    return ticking(step), params, opt


def ticking(step):
    """``step`` with one flight-recorder tick a dispatched step (the
    reference's factories do the same): a relative tick, since the
    recorder may already be ahead (DCN rounds, an earlier model)."""
    from byteps_tpu_torch.common.flight_recorder import get_flight_recorder

    def ticked(*a, **k):
        out = step(*a, **k)
        get_flight_recorder().tick()
        return out

    return ticked


def accumulate(loss_fn, batch: Sequence[torch.Tensor], accum_steps: int,
               leaves: Sequence[torch.Tensor], weight_fn=None
               ) -> torch.Tensor:
    """Forward and backward of ``loss_fn(*batch)`` into the leaves'
    ``.grad``, over ``accum_steps`` sequential microbatches of the rank's
    batch (rows ``[i·B/n, (i+1)·B/n)`` of every element of ``batch``,
    one microbatch's activations alive at a time): the reference's
    ``_accumulating_value_and_grad``. Returns the detached loss.

    Each microbatch's loss and gradients are summed with weight
    ``weight_fn(*microbatch)`` (1 without one), then divided once by the
    weights' sum (guarded: where it is not positive, by 1). Losses that
    normalize by a data-dependent count (BERT's masked mean) need the
    weights: the mean of the microbatches' means weights unequal counts
    wrongly, the count-weighted mean is the full batch's. At
    ``accum_steps`` 1 the batch runs whole and ``weight_fn`` is unused,
    as in the reference."""
    B = batch[0].shape[0]
    if B % accum_steps:
        raise ValueError(f"per-device batch {B} not divisible by "
                         f"accum_steps={accum_steps}")
    mb = B // accum_steps
    weighted = weight_fn is not None and accum_steps > 1
    loss = w_sum = None
    for i in range(accum_steps):
        part_b = tuple(b[i * mb:(i + 1) * mb] for b in batch)
        part = loss_fn(*part_b)
        if weighted:
            w = weight_fn(*part_b).float()
            part = part * w
            w_sum = w if w_sum is None else w_sum + w
        part.backward()                    # into .grad, summed
        part = part.detach()
        loss = part if loss is None else loss + part
    if accum_steps > 1:
        # the sums of the (weighted) gradients and losses, divided once
        div = (torch.where(w_sum > 0.0, w_sum, torch.ones_like(w_sum))
               if weighted else accum_steps)
        for p in leaves:
            if p.grad is not None:
                p.grad.div_(div)
        loss = loss / div
    return loss


def _mesh_optimizer(cfg, params: GPT, mesh, axes: _Axes, make_optimizer,
                    compression_params, partition_bytes, zero_1: bool,
                    stacked: bool = False):
    """``params`` (this rank's shards) made trainable, their leaves in
    the reference's order, the leaves' specs (None without a mesh), and
    the ``DistributedOptimizer`` over the data axes
    (:meth:`_Axes.optimizer_axes`) around ``make_optimizer(leaves)``
    (the tp broadcast of the replicated leaves' aggregate under a lossy
    codec, as ``make_gpt_train_step``). Raises the reference's errors
    for ZeRO-1 on a mesh without a dp axis or with a ``slice_`` axis."""
    if zero_1 and mesh is not None:
        if axes.dp is None:
            raise ValueError(
                "zero_1=True requires a dp mesh axis — ZeRO-1 shards the "
                "optimizer state over dp and there is nothing to shard over "
                "on this mesh")
        if axes.slice_ is not None:
            raise ValueError(
                "zero_1=True does not compose with a slice_ mesh axis — the "
                "ZeRO-1 segment flow owns the dp reduce-scatter; use "
                "zero_3=True for multi-slice FSDP instead")
    params.requires_grad_(True)
    leaves = flat_leaves(params)
    specs = (flat_specs(param_specs(cfg, mesh, stacked)) if mesh is not None
             else None)
    resym = None
    if _live(axes.tp) and from_params(compression_params).enabled:
        resym = _tp_resymmetrize(leaves, specs, axes.tp)
    opt = DistributedOptimizer(make_optimizer(leaves), leaves,
                               compression_params,
                               partition_bytes=partition_bytes,
                               zero=zero_1, resymmetrize=resym,
                               **axes.optimizer_axes())
    return leaves, specs, opt


def _assemble(leaves: Sequence[torch.Tensor], specs, axes: _Axes) -> None:
    """The gradient assembly of the mesh steps (the module docstring):
    the sums over sp, pp and ep, then the division by ep."""
    if _live(axes.sp):
        _sum_over(leaves, axes.sp, "sp_grad_sum")
    for name in ("pp", "ep"):
        axis = getattr(axes, name)
        if _live(axis):
            _sum_over([p for p, s in zip(leaves, specs)
                       if name not in spec_axes(s)], axis,
                      f"{name}_grad_sum")
    if _live(axes.ep):
        for p in leaves:
            if p.grad is not None:
                p.grad.div_(axes.ep.size)


def _whole_params(cfg, init_params, generator, dev, init_fn):
    params = (init_params if init_params is not None
              else init_fn(cfg, generator, device=dev))
    if params.wte.device != dev:
        raise ValueError(f"init_params live on {params.wte.device}, the "
                         f"step on {dev}")
    return params


def _pipeline_axes(cfg, mesh, seq_layout: str, factory: str) -> _Axes:
    """The axes of a pipeline factory's mesh, checked: a pp axis, the
    layers divisible by it, the sequence layout."""
    if mesh is None or Partitioner.for_config(cfg, mesh).pp is None:
        raise ValueError(f"mesh has no pp axis — use {factory}")
    axes = _Axes(cfg, mesh)
    _check_seq_layout(seq_layout, axes.sp)
    nstages = mesh.shape["pp"]
    if cfg.n_layers % nstages != 0:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pp={nstages}")
    return axes


def _check_experts(cfg, axes: _Axes) -> None:
    if axes.ep is not None and cfg.n_experts % axes.ep.size != 0:
        raise ValueError(
            f"n_experts={cfg.n_experts} not divisible by ep={axes.ep.size}")


def _mesh_step(loss_fn, params, leaves, specs, opt, axes: _Axes, dev,
               mean_over: Sequence[str]):
    """``step(tokens, targets) -> loss`` of the pp and MoE factories: this
    rank's block of the global batch, ``loss_fn(params, tok, tgt)``, its
    backward, :func:`_assemble`, the optimizer's step; the loss summed
    over pp, then averaged over the axes ``mean_over`` joined."""
    mean_axis = axes.joint(mean_over)

    def step(tokens, targets) -> torch.Tensor:
        opt.zero_grad()
        loss = loss_fn(params, axes.block(_as_ids(tokens, dev)),
                       axes.block(_as_ids(targets, dev)))
        loss.backward()
        _assemble(leaves, specs, axes)
        opt.step()
        loss = loss.detach()
        if _live(axes.pp):
            loss = loss.clone()
            dist.all_reduce(loss, group=axes.pp.group)
        return _group_mean(loss, mean_axis)

    return ticking(step)


def make_gpt_pp_train_step(
    cfg: GPTConfig,
    mesh,
    make_optimizer: Callable[[Sequence[torch.Tensor]],
                             torch.optim.Optimizer] = adamw,
    n_micro: int = 4,
    compression_params: Optional[Dict[str, Any]] = None,
    partition_bytes: Optional[int] = None,
    remat: bool = False,
    zero_1: bool = False,
    seq_layout: str = "contiguous",
    init_params: Optional[GPT] = None,
    generator: Optional[torch.Generator] = None,
    chunked_ce=True,
    device=None,
):
    """Pipeline-parallel GPT train step over a (pp, dp[, tp][, sp]) mesh.
    Returns ``(step, params, opt)`` as :func:`make_gpt_train_step`.

    ``init_params`` are whole and unstacked (a :class:`GPT` as
    ``gpt_init`` makes it), or fresh ``gpt_init`` weights from
    ``generator``; ``params`` is this rank's stage slab
    (``params.stacked``: n_layers/pp layers stacked on a leading axis,
    this rank's tp shards of them) plus the leaves every stage holds.
    ``step(tokens, targets)`` takes the global (B, S) batch and runs this
    rank's (dp, sp) block as ``n_micro`` microbatches through the GPipe
    schedule (``parallel/pipeline.py``); tp and sp compose inside the
    stages as in :func:`make_gpt_train_step`. ``compression_params``
    compresses each stage's aggregation over dp, with its own EF state.
    ``zero_1`` shards each stage's optimizer state over its dp line.
    Raises the reference's errors for a mesh without a pp axis and for
    layers that pp does not divide."""
    axes = _pipeline_axes(cfg, mesh, seq_layout, "make_gpt_train_step")
    dev = resolve_device(device)
    whole = _whole_params(cfg, init_params, generator, dev, gpt_init)
    params = shard_params(whole, mesh, stacked=True)
    leaves, specs, opt = _mesh_optimizer(
        cfg, params, mesh, axes, make_optimizer, compression_params,
        partition_bytes, zero_1, stacked=True)

    def loss_fn(p, tok, tgt):
        return gpt_pp_loss(p, tok, tgt, cfg, axes.pp, n_micro,
                           tp_axis=axes.tp, sp_axis=axes.sp, remat=remat,
                           seq_layout=seq_layout, chunked_ce=chunked_ce)

    return (_mesh_step(loss_fn, params, leaves, specs, opt, axes, dev,
                       ("slice_", "dp")), params, opt)


def make_gpt_moe_train_step(
    cfg,
    mesh=None,
    make_optimizer: Callable[[Sequence[torch.Tensor]],
                             torch.optim.Optimizer] = adamw,
    compression_params: Optional[Dict[str, Any]] = None,
    partition_bytes: Optional[int] = None,
    remat: bool = False,
    zero_1: bool = False,
    seq_layout: str = "contiguous",
    init_params: Optional[GPT] = None,
    generator: Optional[torch.Generator] = None,
    chunked_ce=True,
    device=None,
):
    """Expert-parallel MoE GPT train step (``cfg`` a ``MoEGPTConfig``)
    over a (dp, ep[, tp][, sp]) mesh, or without one the plain
    data-parallel step over the default group. Returns ``(step, params,
    opt)`` as :func:`make_gpt_train_step`.

    The batch splits over dp and ep (each rank routes its own tokens to
    all experts, ``parallel/moe.py``); the experts' stacks split over ep
    and, with a tp axis, their ff dim over tp. ``init_params`` are whole
    (a :class:`GPT` as ``moe_gpt_init`` makes it), or fresh weights from
    ``generator`` (the reference's factory seeds ``PRNGKey(0)``).
    Gradients as the module docstring assembles them; dp (and ``slice_``)
    aggregation in ``DistributedOptimizer``; the loss averaged over
    ``slice_``, dp and ep. Raises
    the reference's errors for experts that ep does not divide and for a
    mesh with a pp axis."""
    from byteps_tpu_torch.models.moe_gpt import moe_gpt_init, moe_gpt_loss

    axes = _Axes(cfg, mesh)
    if axes.part is not None and axes.part.pp is not None:
        raise ValueError(
            "mesh has a pp axis — use make_gpt_moe_pp_train_step for "
            "pipelined MoE")
    _check_seq_layout(seq_layout, axes.sp)
    _check_experts(cfg, axes)
    dev = resolve_device(device)
    params = _whole_params(cfg, init_params, generator, dev, moe_gpt_init)
    if mesh is not None:
        params = shard_params(params, mesh)
    leaves, specs, opt = _mesh_optimizer(
        cfg, params, mesh, axes, make_optimizer, compression_params,
        partition_bytes, zero_1)

    def loss_fn(p, tok, tgt):
        return moe_gpt_loss(p, tok, tgt, cfg, ep_axis=axes.ep,
                            tp_axis=axes.tp, sp_axis=axes.sp, remat=remat,
                            seq_layout=seq_layout, chunked_ce=chunked_ce)

    return (_mesh_step(loss_fn, params, leaves, specs, opt, axes, dev,
                       ("slice_", "dp", "ep")), params, opt)


def make_gpt_moe_pp_train_step(
    cfg,
    mesh,
    make_optimizer: Callable[[Sequence[torch.Tensor]],
                             torch.optim.Optimizer] = adamw,
    n_micro: int = 4,
    compression_params: Optional[Dict[str, Any]] = None,
    partition_bytes: Optional[int] = None,
    remat: bool = False,
    zero_1: bool = False,
    seq_layout: str = "contiguous",
    init_params: Optional[GPT] = None,
    generator: Optional[torch.Generator] = None,
    chunked_ce=True,
    device=None,
):
    """Pipelined MoE GPT over a (pp, dp[, ep][, tp][, sp]) mesh: GPipe
    stages (:func:`make_gpt_pp_train_step`) whose blocks are MoE blocks
    (:func:`make_gpt_moe_train_step`), routing per microbatch (the
    capacity from the microbatch's tokens). ``init_params`` whole and
    unstacked (``moe_gpt_init``'s), or fresh from ``generator``;
    ``params`` this rank's stage slab with its experts. Returns ``(step,
    params, opt)``; the loss summed over pp, averaged over ``slice_``, dp
    and ep. Raises the reference's errors."""
    from byteps_tpu_torch.models.moe_gpt import moe_gpt_init, moe_gpt_pp_loss

    axes = _pipeline_axes(cfg, mesh, seq_layout, "make_gpt_moe_train_step")
    _check_experts(cfg, axes)
    dev = resolve_device(device)
    whole = _whole_params(cfg, init_params, generator, dev, moe_gpt_init)
    params = shard_params(whole, mesh, stacked=True)
    leaves, specs, opt = _mesh_optimizer(
        cfg, params, mesh, axes, make_optimizer, compression_params,
        partition_bytes, zero_1, stacked=True)

    def loss_fn(p, tok, tgt):
        return moe_gpt_pp_loss(p, tok, tgt, cfg, axes.pp, n_micro,
                               ep_axis=axes.ep, tp_axis=axes.tp,
                               sp_axis=axes.sp, remat=remat,
                               seq_layout=seq_layout, chunked_ce=chunked_ce)

    return (_mesh_step(loss_fn, params, leaves, specs, opt, axes, dev,
                       ("slice_", "dp", "ep")), params, opt)


def _as_ids(x, dev) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(dev, torch.long)


def _as_f32(x, dev) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(dev, torch.float32)


def _group_mean(loss: torch.Tensor, axis=None) -> torch.Tensor:
    """The mean of ``loss`` over the data-parallel ranks (the reference's
    ``pmean`` over its data axes), for reporting: over ``axis`` (a mesh's
    data axes joined), or the default group without one."""
    n, group = (world()[0], None) if axis is None else (axis.size,
                                                         axis.group)
    if n == 1:
        return loss
    loss = loss.clone()
    dist.all_reduce(loss, group=group)
    return loss / n


def make_eval_step(cfg: GPTConfig, device=None, chunked_ce=True,
                   mesh=None, seq_layout: str = "contiguous"):
    """``eval_step(params, tokens, targets) -> mean nll`` (a 0-d f32
    tensor on the device) under ``torch.no_grad()``, through the training
    step's ``gpt_loss``: of this rank's (B, S) batch, with more than one
    rank the mean over the default group; on a mesh, of the global batch
    (each rank its block, ``params`` its shards), the mean over dp and
    sp, then over ``slice_``, as the reference's. ``exp`` of the running
    mean is the perplexity (:func:`evaluate_perplexity`). No optimizer,
    no gradients: safe on training parameters at any step."""
    dev = resolve_device(device)
    axes = _Axes(cfg, mesh)
    _check_seq_layout(seq_layout, axes.sp)

    @torch.no_grad()
    def eval_step(params: GPT, tokens, targets) -> torch.Tensor:
        loss = gpt_loss(params, axes.block(_as_ids(tokens, dev)),
                        axes.block(_as_ids(targets, dev)), cfg,
                        dp_axis=axes.dp, tp_axis=axes.tp, sp_axis=axes.sp,
                        seq_layout=seq_layout, chunked_ce=chunked_ce)
        if mesh is None:
            return _group_mean(loss)
        return pmean(loss, axes.slice_)

    return eval_step


def evaluate_perplexity(eval_step, params: GPT,
                        batches: Iterable[Tuple[Any, Any]]) -> float:
    """Mean perplexity over an iterable of (tokens, targets) batches:
    ``exp`` of the mean of ``eval_step``'s losses."""
    total, n = 0.0, 0
    for tokens, targets in batches:
        total += float(eval_step(params, tokens, targets))
        n += 1
    if n == 0:
        raise ValueError("evaluate_perplexity: no batches")
    return math.exp(total / n)


def synthetic_batch(generator: torch.Generator, cfg: GPTConfig, batch: int,
                    seq: int):
    """Random next-token LM batch ``(tokens, targets)``, (batch, seq)
    int64 each, drawn from ``generator`` on its device."""
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                         generator=generator, device=generator.device)
    return toks[:, :-1], toks[:, 1:]


# --------------------------------------------------------------------------
# the model families: BERT, T5, ViT, ResNet
# --------------------------------------------------------------------------
def _family_params(cfg, init_params, generator, dev, init_fn, mesh
                   ) -> ParamTree:
    """``init_params`` (whole, on ``dev``) or fresh ``init_fn`` weights
    from ``generator``; on a mesh, this rank's shards of them."""
    params = (init_params if init_params is not None
              else init_fn(cfg, generator, device=dev))
    leaf = next(iter(params.parameters()))
    if leaf.device != dev:
        raise ValueError(f"init_params live on {leaf.device}, the step on "
                         f"{dev}")
    return shard_tree(params, mesh) if mesh is not None else params


def _family_step(loss_fn, convs, params, leaves, opt, axes: _Axes, dev,
                 accum_steps: int = 1, weight_fn=None, sp_sum: bool = True):
    """``step(*batch) -> loss`` of the family factories: each element of
    the global batch (``convs``: ids or f32) cut to this rank's block,
    forward and backward of ``loss_fn(params, *block)`` over
    ``accum_steps`` microbatches (:func:`accumulate`, ``weight_fn``),
    the gradients summed over sp where the loss is the mean over sp
    (``sp_sum``), the optimizer's step; the loss averaged over
    ``slice_`` and dp."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps={accum_steps} must be at least 1")
    mean_axis = axes.joint(("slice_", "dp"))

    def step(*batch) -> torch.Tensor:
        opt.zero_grad()
        block = tuple(axes.block(c(x, dev)) for c, x in zip(convs, batch))
        loss = accumulate(lambda *mb: loss_fn(params, *mb), block,
                          accum_steps, leaves, weight_fn)
        if sp_sum and _live(axes.sp):
            _sum_over(leaves, axes.sp, "sp_grad_sum")
        opt.step()
        return _group_mean(loss, mean_axis)

    return ticking(step)


def make_bert_train_step(
    cfg: BertConfig,
    make_optimizer: Callable[[Sequence[torch.Tensor]],
                             torch.optim.Optimizer] = adamw,
    compression_params: Optional[Dict[str, Any]] = None,
    partition_bytes: Optional[int] = None,
    remat: bool = False,
    zero_1: bool = False,
    accum_steps: int = 1,
    chunked_ce=True,
    init_params: Optional[ParamTree] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    mesh=None,
):
    """MLM pretraining step (BASELINE config 3's shape). Returns ``(step,
    params, opt)`` as :func:`make_gpt_train_step`, over the same mesh
    surface (dp, tp, sp, ``slice_``) and options.

    ``step(tokens, targets, mask) -> loss``: (B, S) corrupted ids, the
    original ids and the {0, 1} mask of predicted positions (the global
    batch on a mesh). ``params`` is ``init_params`` (whole: a
    :class:`ParamTree` as ``bert_init`` or ``convert.tree_from_numpy``
    makes it) or fresh ``bert_init`` weights from ``generator``. Under
    ``accum_steps`` > 1 each microbatch is weighted by its mask count,
    summed over sp (the reference's ``weight_fn``), so the accumulated
    step equals the full batch's masked mean."""
    axes = _Axes(cfg, mesh)
    dev = resolve_device(device)
    params = _family_params(cfg, init_params, generator, dev, bert_init,
                            mesh)
    leaves, _, opt = _mesh_optimizer(cfg, params, mesh, axes,
                                     make_optimizer, compression_params,
                                     partition_bytes, zero_1)

    def loss_fn(p, tok, tgt, mask):
        return bert_mlm_loss(p, tok, tgt, mask, cfg, tp_axis=axes.tp,
                             sp_axis=axes.sp, remat=remat,
                             chunked_ce=chunked_ce)

    def mask_count(tok, tgt, mask):
        # the sp-global count: the loss divides by it after its sp sum
        return maybe_psum(mask.sum().float(), axes.sp)

    return (_family_step(loss_fn, (_as_ids, _as_ids, _as_ids), params,
                         leaves, opt, axes, dev, accum_steps,
                         weight_fn=mask_count), params, opt)


def make_t5_train_step(
    cfg: T5Config,
    make_optimizer: Callable[[Sequence[torch.Tensor]],
                             torch.optim.Optimizer] = adamw,
    compression_params: Optional[Dict[str, Any]] = None,
    partition_bytes: Optional[int] = None,
    remat: bool = False,
    zero_1: bool = False,
    accum_steps: int = 1,
    chunked_ce=True,
    init_params: Optional[ParamTree] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    mesh=None,
):
    """Encoder–decoder seq2seq step. Returns ``(step, params, opt)``;
    ``step(src, tgt_in, tgt_out) -> loss`` on (B, S_src) and (B, S_tgt)
    ids. Over an sp axis both sides shard their sequence (the
    non-causal encoder ring, the causal decoder ring, the rectangular
    cross-attention ring; each length must divide by sp); dp, tp,
    ``slice_`` and the options as :func:`make_gpt_train_step`."""
    axes = _Axes(cfg, mesh)
    dev = resolve_device(device)
    params = _family_params(cfg, init_params, generator, dev, t5_init, mesh)
    leaves, _, opt = _mesh_optimizer(cfg, params, mesh, axes,
                                     make_optimizer, compression_params,
                                     partition_bytes, zero_1)

    def loss_fn(p, src, tgt_in, tgt_out):
        return t5_loss(p, src, tgt_in, tgt_out, cfg, tp_axis=axes.tp,
                       sp_axis=axes.sp, remat=remat, chunked_ce=chunked_ce)

    return (_family_step(loss_fn, (_as_ids,) * 3, params, leaves, opt, axes,
                         dev, accum_steps), params, opt)


def make_vit_train_step(
    cfg: ViTConfig,
    make_optimizer: Callable[[Sequence[torch.Tensor]],
                             torch.optim.Optimizer] = adamw,
    compression_params: Optional[Dict[str, Any]] = None,
    partition_bytes: Optional[int] = None,
    remat: bool = False,
    zero_1: bool = False,
    accum_steps: int = 1,
    init_params: Optional[ParamTree] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    mesh=None,
):
    """ViT classification step over dp, tp and ``slice_``. Returns
    ``(step, params, opt)``; ``step(images, labels) -> loss`` on (B, H,
    W, C) f32 images and (B,) labels. As in the reference, sequence
    parallelism is not plumbed: on a mesh with an sp axis the batch is
    not split over it and every sp rank computes the same step."""
    axes = _Axes(cfg, mesh)
    dev = resolve_device(device)
    params = _family_params(cfg, init_params, generator, dev, vit_init,
                            mesh)
    leaves, _, opt = _mesh_optimizer(cfg, params, mesh, axes,
                                     make_optimizer, compression_params,
                                     partition_bytes, zero_1)

    def loss_fn(p, images, labels):
        return vit_loss(p, images, labels, cfg, tp_axis=axes.tp,
                        remat=remat)

    return (_family_step(loss_fn, (_as_f32, _as_ids), params, leaves, opt,
                         axes, dev, accum_steps, sp_sum=False), params, opt)


def make_resnet_train_step(
    cfg: ResNetConfig,
    make_optimizer: Callable[[Sequence[torch.Tensor]],
                             torch.optim.Optimizer] = adamw,
    compression_params: Optional[Dict[str, Any]] = None,
    partition_bytes: Optional[int] = None,
    zero_1: bool = False,
    init_params: Optional[ParamTree] = None,
    init_state: Optional[ParamTree] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    mesh=None,
):
    """Data-parallel ResNet step (BASELINE config 2's shape) with SyncBN.
    Returns ``(step, params, opt, bn_state)``; ``step(images, labels) ->
    loss`` on (B, H, W, 3) f32 NHWC images and (B,) labels updates
    ``params`` and the running statistics ``bn_state`` in place.

    The batch statistics synchronize over the data axes (``slice_`` and
    dp joined on a mesh; the default group without one), so
    ``bn_state`` stays the same on every rank. ``init_params`` and
    ``init_state`` are whole (``resnet_init``'s, or converted from the
    reference's), else fresh ``resnet_init`` weights from
    ``generator``. The loss is the rank's own mean, averaged over the
    data axes for reporting."""
    axes = _Axes(cfg, mesh)
    dev = resolve_device(device)
    if init_params is None:
        init_params, fresh_state = resnet_init(cfg, generator, device=dev)
        init_state = init_state if init_state is not None else fresh_state
    elif init_state is None:
        raise ValueError("init_params needs its init_state (bn_state)")
    params = _family_params(cfg, init_params, generator, dev, None, mesh)
    bn_state = init_state
    leaves, _, opt = _mesh_optimizer(cfg, params, mesh, axes,
                                     make_optimizer, compression_params,
                                     partition_bytes, zero_1)
    if mesh is not None:
        data_axis = axes.joint(("slice_", "dp"))
    else:
        n, rank = world()
        data_axis = Axis("dp", n, rank, tuple(range(n)))

    def step(images, labels) -> torch.Tensor:
        opt.zero_grad()
        loss, new = resnet_loss(params, bn_state,
                                axes.block(_as_f32(images, dev)),
                                axes.block(_as_ids(labels, dev)), cfg,
                                dp_axis=data_axis, train=True)
        loss.backward()
        opt.step()
        with torch.no_grad():
            _copy_tree(bn_state, new)
        return _group_mean(loss.detach(),
                           data_axis if mesh is not None else None)

    return ticking(step), params, opt, bn_state


def _copy_tree(dst, src) -> None:
    """Copy the nested dict of tensors ``src`` into the leaves of the
    module tree ``dst`` of the same structure, in place."""
    if isinstance(src, dict):
        for k, v in src.items():
            _copy_tree(dst[k], v)
    elif isinstance(src, list):
        for d, s in zip(dst, src):
            _copy_tree(d, s)
    else:
        dst.copy_(src)


def synthetic_mlm_batch(generator: torch.Generator, cfg: BertConfig,
                        batch: int, seq: int, mask_rate: float = 0.15):
    """``(corrupted tokens, targets, mask)`` for MLM pretraining, (batch,
    seq) each, drawn from ``generator`` on its device: random targets, a
    Bernoulli(``mask_rate``) mask, the last id standing in for [MASK]."""
    dev = generator.device
    targets = torch.randint(0, cfg.vocab_size, (batch, seq),
                            generator=generator, device=dev)
    mask = torch.rand((batch, seq), generator=generator,
                      device=dev) < mask_rate
    tokens = torch.where(mask, cfg.vocab_size - 1, targets)
    return tokens, targets, mask.to(torch.int32)
