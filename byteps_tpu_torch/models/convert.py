"""Carry a reference parameter tree into the port.

``byteps_tpu.models.gpt_init`` returns a nested dict of arrays; handed
over as numpy (``jax.tree.map(np.asarray, tree)``), it becomes the
port's :class:`~byteps_tpu_torch.models.gpt.GPT` with the same leaf
names, shapes and values, so both packages compute the same function.
This module takes numpy only and never imports the reference.
"""

from __future__ import annotations

from typing import Any, Dict

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
