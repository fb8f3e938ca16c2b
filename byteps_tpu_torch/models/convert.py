"""Carry parameter trees between the reference and the port.

``byteps_tpu.models.gpt_init`` returns a nested dict of arrays; handed
over as numpy (``jax.tree.map(np.asarray, tree)``), it becomes the
port's :class:`~byteps_tpu_torch.models.gpt.GPT` with the same leaf
names, shapes and values, so both packages compute the same function;
:func:`params_to_numpy` goes back; :func:`adapters_from_numpy` and
:func:`adapters_to_numpy` do the same for a LoRA adapter tree
(``{"blocks": [{target: {"a", "b"}}]}``). :func:`flat_leaves` lists the leaves
in the order ``jax.tree.flatten`` gives that tree, the order gradients
are flattened and chunked in. This module takes numpy only and never
imports the reference.

On a mesh (``parallel/mesh.py``) a rank holds shards:
``params_from_numpy(tree, cfg, mesh=mesh)`` and :func:`shard_params`
cut each leaf to this rank's block by its spec
(``models.gpt.gpt_logical_specs`` or ``models.moe_gpt
.moe_gpt_logical_specs`` through the partitioner: an MoE block's
experts over ep), and ``params_to_numpy(params, mesh=mesh)`` gathers the
blocks back to whole leaves over their axes (collective: every rank of
those axes calls it). ``stacked=True`` lays the blocks out as a pipeline
stage's slab: this rank's pp stage's layers stacked on a leading axis,
one leaf a key (``parallel.pipeline.stack_blocks``), so
:func:`flat_leaves` yields the reference's stacked pytree's order;
``params_to_numpy`` unstacks the gathered slab back into layers.

ZeRO-3 (``parallel/zero3.py``) holds each rank's f32 segment of every
parameter group instead: :func:`zero3_segments_from_numpy` cuts the
reference's whole segment arrays to this rank's, and
:func:`zero3_segments_to_numpy` gathers a rank's segments back to them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from byteps_tpu_torch.models.gpt import GPT, Block, GPTConfig
from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.parallel.partitioner import Partitioner, block_of
from byteps_tpu_torch.parallel.pipeline import stack_blocks


def param_specs(cfg: GPTConfig, mesh, stacked: bool = False
                ) -> Dict[str, Any]:
    """The spec tree of ``cfg``'s parameters on ``mesh``; ``stacked``:
    with the blocks as one pipeline slab (``"blocks"`` one spec tree,
    the layer axis over pp), as :func:`shard_params` lays them out."""
    return Partitioner.for_config(cfg, mesh).param_specs(cfg, stacked)


def shard_leaf(a, spec: tuple, mesh):
    """This rank's block of a whole leaf ``a`` (numpy array or tensor)
    under ``spec``: each dimension cut to the rank's block of the mesh
    axes the spec names for it."""
    if not spec:
        return a
    idx = tuple(block_of(a.shape[d], spec[d] if d < len(spec) else None,
                         mesh) for d in range(a.ndim))
    return a[idx]


def gather_leaf(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from this rank's block ``t``: for each dimension
    the spec splits, the blocks of its axes gathered in index order
    (innermost axis first). Collective over those axes."""
    for d, target in enumerate(spec):
        if target is None:
            continue
        for name in reversed((target,) if isinstance(target, str)
                             else target):
            axis = mesh.axis(name)
            if axis.size == 1:
                continue
            parts = [torch.empty_like(t) for _ in range(axis.size)]
            dist.all_gather(parts, t.contiguous(), group=axis.group)
            t = torch.cat(parts, dim=d)
    return t


def _map_leaves(fn, tree, specs):
    """``fn(leaf, spec)`` over a (nested) dict of leaves and its specs."""
    return {k: (_map_leaves(fn, v, specs[k]) if isinstance(v, dict)
                else fn(v, specs[k])) for k, v in tree.items()}


def _shard_tree(tree: Dict[str, Any], specs: Dict[str, Any], mesh, conv,
                stacked: bool = False):
    """This rank's top-level leaves and blocks of a whole tree (blocks a
    list of per-layer trees). ``stacked``: the blocks become one slab of
    this rank's pp stage, only its layers stacked, each leaf then cut by
    the rest of its stacked spec."""
    leaves = {k: conv(shard_leaf(v, specs[k], mesh))
              for k, v in tree.items() if k != "blocks"}
    if not stacked:
        blocks = [_map_leaves(lambda v, sp: conv(shard_leaf(v, sp, mesh)),
                              b, bs)
                  for b, bs in zip(tree["blocks"], specs["blocks"])]
        return leaves, blocks
    n = len(tree["blocks"])

    def first_target(sp):
        while isinstance(sp, dict):
            sp = next(iter(sp.values()))
        return sp[0]

    rows = block_of(n, first_target(specs["blocks"]), mesh)
    slab = stack_blocks(tree["blocks"][rows])
    blocks = _map_leaves(
        lambda v, sp: conv(shard_leaf(v, (None,) + tuple(sp[1:]), mesh)),
        slab, specs["blocks"])
    return leaves, blocks


def _module_tree(module) -> Dict[str, Any]:
    """A :class:`GPT` or :class:`Block` as a nested dict of its leaves
    (``"blocks"`` a list of per-layer dicts, or the slab's dict)."""
    out = {}
    for k in module.keys():
        v = module[k]
        if isinstance(v, torch.nn.ModuleList):
            out[k] = [_module_tree(b) for b in v]
        elif isinstance(v, Block):
            out[k] = _module_tree(v)
        else:
            out[k] = v
    return out


def shard_params(params: GPT, mesh, stacked: bool = False) -> GPT:
    """This rank's shards of whole parameters ``params`` (a :class:`GPT`
    on one rank's layout) as a :class:`GPT` on the same device: each
    leaf cut to its block by its spec on ``mesh``, copied. ``stacked``:
    the blocks become this rank's pipeline slab (:func:`_shard_tree`)."""
    specs = param_specs(params.cfg, mesh, stacked)

    def conv(t: torch.Tensor) -> torch.Tensor:
        return t.detach().contiguous().clone()

    leaves, blocks = _shard_tree(_module_tree(params), specs, mesh, conv,
                                 stacked)
    return GPT(params.cfg, leaves, blocks)


def params_from_numpy(tree: Dict[str, Any], cfg: GPTConfig,
                      device=None, mesh=None, stacked: bool = False) -> GPT:
    """``{"wte": ..., "blocks": [{"wq": ...}, ...]}`` of numpy arrays (a
    block's nested dicts, an MoE block's ``"moe"``, kept nested) → a
    :class:`GPT` on ``device`` (the card unless told otherwise). Leaf
    dtypes are kept (the reference's master weights are f32). With
    ``mesh``, the leaves are whole and each is cut to this rank's shard
    (:func:`shard_leaf`); ``stacked`` makes the blocks this rank's
    pipeline slab (this stage's layers, and of its experts this rank's
    with an ep axis)."""
    dev = resolve_device(device)

    def conv(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    if len(tree["blocks"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, "
                         f"cfg.n_layers is {cfg.n_layers}")
    if tuple(np.shape(tree["wte"])) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"wte {tuple(np.shape(tree['wte']))} does not "
                         f"match cfg ({cfg.vocab_size}, {cfg.d_model})")
    if mesh is not None:
        leaves, blocks = _shard_tree(tree, param_specs(cfg, mesh, stacked),
                                     mesh, conv, stacked)
    else:
        if stacked:
            raise ValueError("stacked=True takes a mesh (the pp stage)")
        leaves = {k: conv(v) for k, v in tree.items() if k != "blocks"}
        blocks = [_map_leaves(lambda v, _: conv(v), b, _nones(b))
                  for b in tree["blocks"]]
    return GPT(cfg, leaves, blocks)


def _tree_leaves(module) -> List[torch.Tensor]:
    out = []
    if isinstance(module, torch.nn.ModuleList):
        for b in module:
            out.extend(_tree_leaves(b))
        return out
    for name in sorted(module.keys()):
        v = module[name]
        if isinstance(v, (Block, torch.nn.ModuleList)):
            out.extend(_tree_leaves(v))
        else:
            out.append(v)
    return out


def flat_leaves(params: GPT) -> List[torch.Tensor]:
    """The leaves of ``params`` in ``jax.tree.flatten`` order of the
    reference's tree: dict keys sorted at every level (nested blocks
    too, an MoE block's ``"moe"`` between ``ln2_g`` and ``wk``), so
    ``blocks`` (each block's keys sorted: ``b1, b2, bk, bo, bq, bv,
    ln1_b, …, wv``; a pipeline slab's stacked leaves in the same order)
    comes before ``lnf_b, lnf_g, wpe, wte``. Not the module's
    registration order: the onebit scale is per chunk, and chunks span
    leaf boundaries in this order."""
    return _tree_leaves(params)


def flat_specs(specs: Any) -> List[tuple]:
    """A spec tree's leaves in :func:`flat_leaves` order."""
    if isinstance(specs, list):
        return [s for b in specs for s in flat_specs(b)]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in flat_specs(specs[k])]
    return [specs]


def params_to_numpy(params: GPT, mesh=None) -> Dict[str, Any]:
    """A :class:`GPT` → the reference's nested tree of f32 numpy arrays
    (``{"wte": ..., "blocks": [{"wq": ...}, ...]}``, unstacked). With
    ``mesh``, ``params`` is this rank's shards and each leaf is gathered
    whole over the axes its spec splits it on (:func:`gather_leaf`:
    every rank of those axes calls it): a pipeline slab's over pp (and
    its experts over ep), then unstacked into layers."""
    stacked = params.stacked
    specs = (param_specs(params.cfg, mesh, stacked) if mesh is not None
             else None)

    def conv(t: torch.Tensor, spec: Optional[tuple]) -> np.ndarray:
        t = t.detach()
        if spec:
            t = gather_leaf(t, spec, mesh)
        return t.cpu().numpy().copy()

    mod = _module_tree(params)
    tree = {k: conv(v, specs and specs[k]) for k, v in mod.items()
            if k != "blocks"}
    if stacked:
        slab = _map_leaves(conv, mod["blocks"],
                           specs["blocks"] if specs else _nones(
                               mod["blocks"]))
        tree["blocks"] = [_unstack(slab, i)
                          for i in range(params.cfg.n_layers)]
    else:
        tree["blocks"] = [
            _map_leaves(conv, b, specs["blocks"][i] if specs
                        else _nones(b))
            for i, b in enumerate(mod["blocks"])]
    return tree


def _nones(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _nones(v) if isinstance(v, dict) else None
            for k, v in tree.items()}


def _unstack(slab: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: _unstack(v, i) if isinstance(v, dict) else v[i]
            for k, v in slab.items()}


def _adapter_specs(tree: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The specs of ``tree``'s targets over ``mesh``'s tp axis."""
    from byteps_tpu_torch.models.lora import adapter_specs

    return adapter_specs(tree, "tp" if "tp" in mesh.axis_names else None)


def adapters_from_numpy(tree: Dict[str, Any], device=None,
                        mesh=None) -> Dict[str, Any]:
    """The reference's adapter tree ``{"blocks": [{target: {"a": (d_in,
    r), "b": (r, d_out)}}]}`` of numpy arrays → the same tree of tensors
    on ``device`` (the card unless told otherwise), dtypes kept. With a
    ``mesh``, each leaf is cut to this rank's shard by its spec over the
    mesh's tp axis (``models.lora.lora_param_specs``'s)."""
    dev = resolve_device(device)
    specs = None if mesh is None else _adapter_specs(tree, mesh)

    def conv(v, spec):
        if mesh is not None:
            v = shard_leaf(np.asarray(v), spec, mesh)
        return torch.from_numpy(np.array(v, copy=True)).to(dev)

    return {"blocks": [
        {t: {k: conv(v, specs and specs["blocks"][i][t][k])
             for k, v in ab.items()} for t, ab in blk.items()}
        for i, blk in enumerate(tree["blocks"])]}


def adapters_to_numpy(adapters: Dict[str, Any],
                      mesh=None) -> Dict[str, Any]:
    """An adapter tree of tensors → the reference's tree of numpy arrays;
    with a ``mesh``, each shard gathered back to the whole leaf over the
    axes of its spec (as :func:`adapters_from_numpy` cut it; collective
    over them)."""
    specs = None if mesh is None else _adapter_specs(adapters, mesh)

    def conv(v, spec):
        v = v.detach()
        if mesh is not None and spec:
            v = gather_leaf(v, spec, mesh)
        return v.cpu().numpy().copy()

    return {"blocks": [
        {t: {k: conv(v, specs and specs["blocks"][i][t][k])
             for k, v in ab.items()} for t, ab in blk.items()}
        for i, blk in enumerate(adapters["blocks"])]}


def zero3_segments_from_numpy(segs: Dict[str, Any], n_shard: int,
                              index: int, device=None) -> Dict[str, Any]:
    """The reference's ZeRO-3 segments (``{"rest": (padded,), "blocks":
    [(padded,), ...]}``, each group's whole zero-padded flat vector, as
    numpy) → shard ``index`` of ``n_shard`` of each group, f32 tensors on
    ``device`` (the card unless told otherwise): a rank's ``segs``."""
    dev = resolve_device(device)

    def cut(a) -> torch.Tensor:
        a = np.asarray(a, np.float32)
        seg = -(-a.shape[0] // n_shard)
        return torch.from_numpy(a[index * seg:(index + 1) * seg].copy()
                                ).to(dev)

    return {"rest": cut(segs["rest"]),
            "blocks": [cut(b) for b in segs["blocks"]]}


def zero3_segments_to_numpy(segs: Dict[str, Any], mesh=None
                            ) -> Dict[str, Any]:
    """A rank's ZeRO-3 ``segs`` → each group's whole zero-padded flat
    vector as numpy, the reference's segment dict: all-gathered over the
    shard axis of ``mesh`` (``slice_``, else dp; without a mesh the
    default group). Collective over that axis."""
    from byteps_tpu_torch.comm.ici import all_gather_body
    from byteps_tpu_torch.parallel.zero3 import shard_axis

    shard = shard_axis(mesh)

    def whole(t: torch.Tensor) -> np.ndarray:
        t = all_gather_body(t.detach().float(), shard.size, None,
                            shard.group)
        return t.cpu().numpy().copy()

    return {"rest": whole(segs["rest"]),
            "blocks": [whole(b) for b in segs["blocks"]]}
