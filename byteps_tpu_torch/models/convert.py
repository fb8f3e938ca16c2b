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
(``models.gpt.gpt_logical_specs`` through the partitioner), and
``params_to_numpy(params, mesh=mesh)`` gathers the blocks back to whole
leaves over their axes (collective: every rank of those axes calls it).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from byteps_tpu_torch.models.gpt import GPT, GPTConfig
from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.parallel.partitioner import Partitioner, block_of


def param_specs(cfg: GPTConfig, mesh) -> Dict[str, Any]:
    """The spec tree of ``cfg``'s parameters on ``mesh``."""
    return Partitioner.for_config(cfg, mesh).param_specs(cfg)


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


def _shard_tree(tree: Dict[str, Any], specs: Dict[str, Any], mesh, conv):
    leaves = {k: conv(shard_leaf(v, specs[k], mesh))
              for k, v in tree.items() if k != "blocks"}
    blocks = [{k: conv(shard_leaf(v, bs[k], mesh)) for k, v in b.items()}
              for b, bs in zip(tree["blocks"], specs["blocks"])]
    return leaves, blocks


def shard_params(params: GPT, mesh) -> GPT:
    """This rank's shards of whole parameters ``params`` (a :class:`GPT`
    on one rank's layout) as a :class:`GPT` on the same device: each
    leaf cut to its block by its spec on ``mesh``, copied."""
    specs = param_specs(params.cfg, mesh)

    def conv(t: torch.Tensor) -> torch.Tensor:
        return t.detach().contiguous().clone()

    tree = {k: params[k] for k in _leaf_names(params)}
    tree["blocks"] = [{k: b[k] for k in _leaf_names(b)}
                      for b in params.blocks]
    leaves, blocks = _shard_tree(tree, specs, mesh, conv)
    return GPT(params.cfg, leaves, blocks)


def params_from_numpy(tree: Dict[str, Any], cfg: GPTConfig,
                      device=None, mesh=None) -> GPT:
    """``{"wte": ..., "blocks": [{"wq": ...}, ...]}`` of numpy arrays →
    a :class:`GPT` on ``device`` (the card unless told otherwise). Leaf
    dtypes are kept (the reference's master weights are f32). With
    ``mesh``, the leaves are whole and each is cut to this rank's shard
    (:func:`shard_leaf`)."""
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
        leaves, blocks = _shard_tree(tree, param_specs(cfg, mesh), mesh,
                                     conv)
    else:
        leaves = {k: conv(v) for k, v in tree.items() if k != "blocks"}
        blocks = [{k: conv(v) for k, v in b.items()} for b in tree["blocks"]]
    return GPT(cfg, leaves, blocks)


def _leaf_names(module) -> List[str]:
    return list(module._parameters)


def flat_leaves(params: GPT) -> List[torch.Tensor]:
    """The leaves of ``params`` in ``jax.tree.flatten`` order of the
    reference's tree: dict keys sorted at every level, so ``blocks``
    (each block's keys sorted: ``b1, b2, bk, bo, bq, bv, ln1_b, …,
    wv``) comes before ``lnf_b, lnf_g, wpe, wte``. Not the module's
    registration order: the onebit scale is per chunk, and chunks span
    leaf boundaries in this order."""
    out = []
    for name in sorted(_leaf_names(params) + ["blocks"]):
        if name == "blocks":
            for b in params.blocks:
                out.extend(b[k] for k in sorted(_leaf_names(b)))
        else:
            out.append(params[name])
    return out


def flat_specs(specs: Dict[str, Any]) -> List[tuple]:
    """A spec tree's leaves in :func:`flat_leaves` order."""
    out = []
    for name in sorted(specs):
        if name == "blocks":
            for b in specs["blocks"]:
                out.extend(b[k] for k in sorted(b))
        else:
            out.append(specs[name])
    return out


def params_to_numpy(params: GPT, mesh=None) -> Dict[str, Any]:
    """A :class:`GPT` → the reference's nested tree of f32 numpy arrays
    (``{"wte": ..., "blocks": [{"wq": ...}, ...]}``). With ``mesh``,
    ``params`` is this rank's shards and each leaf is gathered whole
    over the axes its spec splits it on (:func:`gather_leaf`: every rank
    of those axes calls it)."""
    if mesh is None:
        specs = None
    else:
        specs = param_specs(params.cfg, mesh)

    def conv(t: torch.Tensor, spec: Optional[tuple]) -> np.ndarray:
        t = t.detach()
        if spec:
            t = gather_leaf(t, spec, mesh)
        return t.cpu().numpy().copy()

    tree = {k: conv(params[k], specs and specs[k])
            for k in _leaf_names(params)}
    tree["blocks"] = [{k: conv(b[k], specs and specs["blocks"][i][k])
                       for k in _leaf_names(b)}
                      for i, b in enumerate(params.blocks)]
    return tree


def adapters_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The reference's adapter tree ``{"blocks": [{target: {"a": (d_in,
    r), "b": (r, d_out)}}]}`` of numpy arrays → the same tree of tensors
    on ``device`` (the card unless told otherwise), dtypes kept."""
    dev = resolve_device(device)
    return {"blocks": [
        {t: {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
             for k, v in ab.items()} for t, ab in blk.items()}
        for blk in tree["blocks"]]}


def adapters_to_numpy(adapters: Dict[str, Any]) -> Dict[str, Any]:
    """An adapter tree of tensors → the reference's tree of numpy arrays."""
    return {"blocks": [
        {t: {k: v.detach().cpu().numpy().copy() for k, v in ab.items()}
         for t, ab in blk.items()}
        for blk in adapters["blocks"]]}
