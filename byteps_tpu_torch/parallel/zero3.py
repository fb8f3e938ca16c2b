"""ZeRO-3 FSDP for the GPT family (counterpart of
``byteps_tpu/parallel/zero3.py``): the parameters live as flat f32
segments sharded over the ``slice_`` or dp axis and are all-gathered
just in time, one group at a time.

- **Persistent state**, the master weights and the optimizer's moments,
  is one flat f32 segment a group on each rank: ``ceil(total/n)`` of the
  group's zero-padded flat vector, n the shard axis's size. The groups
  are ``rest`` (every leaf outside the blocks: the embeddings, the final
  norm, an untied head) and one a transformer block, each flattened in
  the reference's leaf order (keys sorted) and zero-padded to
  ``n·ceil(total/n)``.
- **Transient state**: a group's whole weights exist only while it
  computes. :class:`_Gather`'s forward all-gathers the segments over the
  shard axis; the block runs on views of the gathered vector. Under
  ``remat=True`` the gather sits inside the checkpointed block, so only
  one block's whole weights are alive at a time and the backward
  gathers them again.
- **Gradients arrive sharded.** :class:`_Gather`'s backward is a
  reduce-scatter (a sum) over the shard axis, the transpose of the
  reference's tiled ``all_gather``: each rank receives the summed
  gradient of its own segment. The data axis that replicates the
  segments (dp under a ``slice_`` shard) adds one explicit sum of all
  segment gradients, and every gradient is then divided by the number
  of workers (the ``slice_`` × dp ranks): the gradient of the global
  mean loss.
- **The update is elementwise on segments**: ``make_optimizer`` (AdamW
  by default) steps the segments directly; the whole parameters are
  never built for it, so it must be elementwise, as ZeRO-1's.

The shard axis is ``slice_`` when the mesh has one, else dp; without a
mesh, the default process group (each rank takes its own batch, as the
plain data-parallel step). Pure FSDP only: tp, sp, pp and ep axes are
refused, and so is ``compression_params`` (the collectives here move
parameters), with the reference's messages. Padding never reaches the
loss (the gather cuts it before the views), so its gradient is exactly
zero and AdamW leaves it at zero.

Collectives are counted in ``parallel.mesh.collectives``:
``zero3_gather_fwd`` (one a group in the forward), ``zero3_gather_bwd``
(one a block in a rematerialized backward), ``zero3_reduce_scatter``
(one a group) and ``zero3_grad_sum`` (one a step over the replicating
data axis).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from byteps_tpu_torch.comm.ici import (all_gather_body, reduce_scatter_body,
                                       world)
from byteps_tpu_torch.parallel.mesh import Axis, collectives
from byteps_tpu_torch.parallel.partitioner import Partitioner
from byteps_tpu_torch.parallel.remat import maybe_remat

#: One group's layout: (leaf names, shapes, sizes, total, padded).
Meta = Tuple[List[str], List[Tuple[int, ...]], List[int], int, int]


def _seg_of(total: int, n: int) -> int:
    return -(-total // n)


def _meta(tree: Dict[str, Any], n_shard: int) -> Meta:
    names = sorted(tree)
    shapes = [tuple(tree[k].shape) for k in names]
    sizes = [int(np.prod(s)) for s in shapes]
    total = sum(sizes)
    return names, shapes, sizes, total, n_shard * _seg_of(total, n_shard)


def _rest(params) -> Dict[str, Any]:
    return {k: params[k] for k in params.keys() if k != "blocks"}


def _block(b) -> Dict[str, Any]:
    return {k: b[k] for k in b.keys()}


def _group_meta(params, n_shard: int) -> Tuple[Meta, Meta]:
    """The layouts of the two group kinds: ``rest`` (every leaf outside
    the blocks) and one transformer block, each flattened in sorted key
    order and zero-padded to a multiple of ``n_shard``. ``params`` is a
    :class:`~byteps_tpu_torch.models.gpt.GPT` (its blocks a list) or the
    reference's tree of arrays."""
    return (_meta(_rest(params), n_shard),
            _meta(_block(params["blocks"][0]), n_shard))


def _tensor(a) -> torch.Tensor:
    """A tensor or numpy array as a tensor (numpy copied: it may be
    read-only)."""
    return a.detach() if torch.is_tensor(a) else torch.from_numpy(
        np.array(a))


def _flat_pad(tree: Dict[str, Any], meta: Meta) -> torch.Tensor:
    names, _, _, total, padded = meta
    flat = torch.cat([_tensor(tree[k]).reshape(-1).float() for k in names])
    return torch.cat([flat, flat.new_zeros(padded - total)])


def _to_segs(params, n_shard: int) -> Dict[str, Any]:
    """Whole parameters → ``{"rest": (padded,), "blocks": [(padded,),
    ...]}``: each group's flat f32 vector, zero-padded to a multiple of
    ``n_shard`` (the reference's global segment arrays)."""
    rest_m, blk_m = _group_meta(params, n_shard)
    return {"rest": _flat_pad(_rest(params), rest_m),
            "blocks": [_flat_pad(_block(b), blk_m)
                       for b in params["blocks"]]}


def _views(flat: torch.Tensor, meta: Meta) -> Dict[str, torch.Tensor]:
    names, shapes, sizes, _, _ = meta
    out, off = {}, 0
    for k, shape, s in zip(names, shapes, sizes):
        out[k] = flat[off:off + s].view(shape)
        off += s
    return out


def _shapes_gpt(cfg):
    """A :class:`GPT` of ``cfg``'s shapes on the meta device (no data)."""
    from byteps_tpu_torch.models.gpt import gpt_init

    return gpt_init(cfg, torch.Generator(), device="meta")


def zero3_gather_params(segs: Dict[str, Any], cfg, device=None):
    """The whole parameters (a :class:`~byteps_tpu_torch.models.gpt.GPT`)
    from whole segments: ``{"rest": (padded,), "blocks": [...]}`` of
    numpy arrays or tensors, each a group's gathered flat vector
    (``models.convert.zero3_segments_to_numpy`` gives them, as the
    reference's segment dict does). Host-side (checkpointing, export,
    eval on another mesh): nothing is communicated. ``device``: the
    segments' device (the CPU for numpy) unless given."""
    from byteps_tpu_torch.models.gpt import GPT

    rest = _tensor(segs["rest"])
    dev = torch.device(device) if device is not None else rest.device
    rest_m, blk_m = _group_meta(_shapes_gpt(cfg), 1)

    def whole(seg, meta):
        flat = _tensor(seg).to(dev, torch.float32)[:meta[3]]
        return {k: v.clone() for k, v in _views(flat, meta).items()}

    return GPT(cfg, whole(rest, rest_m),
               [whole(s, blk_m) for s in segs["blocks"]])


class _Gather(torch.autograd.Function):
    """This rank's segment → the group's whole flat vector, all-gathered
    over the shard axis; backward, the gradient reduce-scattered (summed)
    back to the segment."""

    @staticmethod
    def forward(ctx, seg, shard: Axis, state: Dict[str, bool]):
        ctx.shard = shard
        if shard.size > 1:
            kind = ("zero3_gather_bwd" if state["backward"]
                    else "zero3_gather_fwd")
            collectives[kind] += 1
        return all_gather_body(seg.detach(), shard.size, None, shard.group)

    @staticmethod
    def backward(ctx, g):
        shard = ctx.shard
        if shard.size > 1:
            collectives["zero3_reduce_scatter"] += 1
        return (reduce_scatter_body(g.contiguous(), shard.size, shard.group),
                None, None)


def state_bytes(segs: Dict[str, Any], opt: torch.optim.Optimizer) -> int:
    """This rank's persistent ZeRO-3 bytes: its segments and the
    optimizer's per-element state of them (AdamW: two moments)."""
    seg_list = [segs["rest"], *segs["blocks"]]
    moments = sum(t.numel() * t.element_size()
                  for st in opt.state.values() for t in st.values()
                  if torch.is_tensor(t) and t.ndim > 0)
    return sum(t.numel() * t.element_size() for t in seg_list) + moments


def shard_axis(mesh=None) -> Optional[Axis]:
    """The axis ZeRO-3 shards over: ``slice_`` when the mesh has one,
    else dp (None when it has neither); without a mesh the default
    process group's ranks (``group`` None)."""
    if mesh is None:
        n, rank = world()
        return Axis("world", n, rank, tuple(range(n)))
    for name in ("slice_", "dp"):
        if name in mesh.axis_names:
            return mesh.axis(name)
    return None


def _axes(cfg, mesh) -> Tuple[Axis, Optional[Axis], Optional[Axis], int]:
    """(shard axis, the other data axis or None, the data axes joined
    (None without a mesh: the default group), the worker count), with the
    reference's refusals."""
    shard = shard_axis(mesh)
    if mesh is None:
        return shard, None, None, shard.size
    part = Partitioner.for_config(cfg, mesh)
    banned = [a for a in (part.tp, part.sp, part.pp, part.ep)
              if a is not None]
    if banned:
        raise ValueError(
            f"zero_3 is pure FSDP — mesh axes {banned} are not supported "
            "(tp/sp/pp/ep compose on the zero_3=False paths)")
    if shard is None:
        raise ValueError("zero_3 needs a slice_ or dp mesh axis to shard "
                         "params over")
    data = tuple(a for a in (part.slice_, part.dp) if a is not None)
    other = [a for a in data if a != shard.name]
    joint = mesh.axes(data)
    return (shard, mesh.axis(other[0]) if other else None, joint,
            joint.size)


def make_gpt_zero3_train_step(
    cfg,
    mesh=None,
    make_optimizer: Optional[Callable[[Sequence[torch.Tensor]],
                                      torch.optim.Optimizer]] = None,
    compression_params: Optional[Dict[str, Any]] = None,
    partition_bytes: Optional[int] = None,
    remat: bool = False,
    seq_layout: str = "contiguous",
    init_params=None,
    generator: Optional[torch.Generator] = None,
    chunked_ce=True,
    device=None,
):
    """The ``zero_3=True`` backend of
    :func:`byteps_tpu_torch.models.train.make_gpt_train_step`. Returns
    ``(step, segs, opt)`` in place of the reference's ``(step, segs,
    opt_state, batch_sharding)``:

    - ``step(tokens, targets) -> loss`` takes the global (B, S) batch on
      a mesh (each rank keeps its block of ``slice_`` × dp rows), this
      rank's batch without one, and returns the mean loss over the data
      axes (a 0-d f32 tensor on the device) after updating ``segs`` in
      place;
    - ``segs`` is ``{"rest": seg, "blocks": [seg, ...]}``, this rank's
      f32 segment of each group (the master copy; ``models.convert
      .zero3_segments_to_numpy`` gathers them whole and
      :func:`zero3_gather_params` rebuilds the model);
    - ``opt`` is ``make_optimizer`` (default
      ``models.train.adamw``) over those segments, its state theirs.

    ``init_params`` is a whole :class:`GPT` on the step's device (the
    card unless ``device`` says otherwise), or fresh ``gpt_init`` weights
    from ``generator``. ``partition_bytes`` is accepted and unused, as in
    the reference (nothing is chunked). Raises the reference's errors
    for tp, sp, pp or ep axes, for ``compression_params``, and for a
    mesh with neither a ``slice_`` nor a dp axis."""
    from byteps_tpu_torch.models.gpt import (_embed, _positions,
                                             _readout_nll, gpt_init,
                                             resolve_norm, resolve_rope,
                                             transformer_block)
    from byteps_tpu_torch.models.train import (_as_ids, _check_seq_layout,
                                               _group_mean, _whole_params,
                                               adamw, ticking)
    from byteps_tpu_torch.ops.backend import resolve_device

    del partition_bytes
    if compression_params is not None:
        raise ValueError(
            "compression_params does not compose with zero_3 (the DCN "
            "collectives here move params, not grads) — use the hybrid "
            "compressed-gradient path (zero_3=False on a slice_ mesh)")
    shard, other, joint, n_workers = _axes(cfg, mesh)
    _check_seq_layout(seq_layout, None)
    dev = resolve_device(device)
    params = _whole_params(cfg, init_params, generator, dev, gpt_init)
    n_shard = shard.size
    rest_m, blk_m = _group_meta(params, n_shard)
    whole = _to_segs(params, n_shard)
    del params                        # the segments are the master copy

    def mine(flat: torch.Tensor) -> torch.Tensor:
        seg = flat.shape[0] // n_shard
        return (flat[shard.index * seg:(shard.index + 1) * seg].clone()
                .requires_grad_(True))

    segs = {"rest": mine(whole["rest"]),
            "blocks": [mine(b) for b in whole["blocks"]]}
    del whole
    seg_list = [segs["rest"], *segs["blocks"]]
    opt = (make_optimizer or adamw)(seg_list)
    part = Partitioner.for_config(cfg, mesh) if mesh is not None else None
    rope_base = resolve_rope(cfg)
    norm_fn, norm_eps = resolve_norm(cfg)
    state = {"backward": False}

    def gather(seg, meta):
        return _views(_Gather.apply(seg, shard, state)[:meta[3]], meta)

    def loss_from_segs(tok, tgt):
        pos = _positions(tok.shape[1], None, seq_layout, tok.device)
        rest = gather(segs["rest"], rest_m)
        x = _embed(rest, tok, cfg, pos=pos)

        def apply_block(x, seg):
            # the gather lives inside the (rematerialized) block: the
            # backward gathers again instead of keeping every block's
            # whole weights alive
            return transformer_block(x, gather(seg, blk_m), cfg.head_dim,
                                     seq_layout=seq_layout,
                                     rope_base=rope_base, norm_fn=norm_fn,
                                     norm_eps=norm_eps,
                                     use_bias=cfg.use_bias, pos=pos)

        apply_block = maybe_remat(apply_block, remat)
        for seg in segs["blocks"]:
            x = apply_block(x, seg)
        return _readout_nll(rest, x, tgt, norm_fn, norm_eps,
                            chunked=chunked_ce).mean()

    def step(tokens, targets) -> torch.Tensor:
        for t in seg_list:
            t.grad = None
        tok, tgt = _as_ids(tokens, dev), _as_ids(targets, dev)
        if part is not None:
            tok, tgt = part.local_batch(tok), part.local_batch(tgt)
        state["backward"] = False
        loss = loss_from_segs(tok, tgt)
        state["backward"] = True
        try:
            loss.backward()
        finally:
            state["backward"] = False
        with torch.no_grad():
            grads = [t.grad for t in seg_list]
            if other is not None and other.size > 1:
                flat = torch.cat(grads)
                dist.all_reduce(flat, group=other.group)
                collectives["zero3_grad_sum"] += 1
                grads = list(flat.split([g.numel() for g in grads]))
            for t, g in zip(seg_list, grads):
                t.grad = g / n_workers
        opt.step()
        return _group_mean(loss.detach(), joint)

    return ticking(step), segs, opt
