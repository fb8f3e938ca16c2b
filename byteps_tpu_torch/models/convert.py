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
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from byteps_tpu_torch.models.gpt import GPT, GPTConfig
from byteps_tpu_torch.ops.backend import resolve_device


def params_from_numpy(tree: Dict[str, Any], cfg: GPTConfig,
                      device=None) -> GPT:
    """``{"wte": ..., "blocks": [{"wq": ...}, ...]}`` of numpy arrays →
    a :class:`GPT` on ``device`` (the card unless told otherwise). Leaf
    dtypes are kept (the reference's master weights are f32)."""
    dev = resolve_device(device)

    def conv(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    leaves = {k: conv(v) for k, v in tree.items() if k != "blocks"}
    blocks = [{k: conv(v) for k, v in b.items()} for b in tree["blocks"]]
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"tree has {len(blocks)} blocks, cfg.n_layers is "
                         f"{cfg.n_layers}")
    if tuple(leaves["wte"].shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"wte {tuple(leaves['wte'].shape)} does not match "
                         f"cfg ({cfg.vocab_size}, {cfg.d_model})")
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


def params_to_numpy(params: GPT) -> Dict[str, Any]:
    """A :class:`GPT` → the reference's nested tree of f32 numpy arrays
    (``{"wte": ..., "blocks": [{"wq": ...}, ...]}``)."""
    def conv(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().copy()

    tree = {k: conv(params[k]) for k in _leaf_names(params)}
    tree["blocks"] = [{k: conv(b[k]) for k in _leaf_names(b)}
                      for b in params.blocks]
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
