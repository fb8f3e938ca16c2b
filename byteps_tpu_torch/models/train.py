"""The data-parallel GPT training step (counterpart of
``byteps_tpu/models/train.py:make_gpt_train_step`` with dp only: no tp,
sp, pp or ZeRO).

One step runs, in order: the forward, the backward (attention through
the hand-written flash kernels on the card), the flattening of the
gradients in the reference's leaf order, the chunked aggregation of
``optimizer.DistributedOptimizer`` (raw, or compressed by any codec of
``compression``, with error feedback and momentum as asked),
the write-back into ``.grad``, and a ``torch.optim.AdamW`` step. Each
rank is one process with its own batch; with more than one rank the step
aggregates over the default ``torch.distributed`` group, which the caller
initializes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from byteps_tpu_torch.comm.ici import world
from byteps_tpu_torch.models.convert import flat_leaves
from byteps_tpu_torch.models.gpt import GPT, GPTConfig, gpt_init, gpt_loss
from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.optimizer import DistributedOptimizer


def adamw(leaves: Sequence[torch.Tensor], lr: float = 1e-3
          ) -> torch.optim.Optimizer:
    """``torch.optim.AdamW`` with ``optax.adamw``'s defaults (β 0.9/0.999,
    ε 1e-8 outside the square root, weight decay 1e-4 on every leaf;
    torch's own default decay is 1e-2)."""
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_gpt_train_step(
    cfg: GPTConfig,
    make_optimizer: Callable[[Sequence[torch.Tensor]],
                             torch.optim.Optimizer] = adamw,
    compression_params: Optional[Dict[str, Any]] = None,
    partition_bytes: Optional[int] = None,
    remat: bool = False,
    chunked_ce: bool = True,
    init_params: Optional[GPT] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
):
    """Returns ``(step, params, opt)``.

    ``step(tokens, targets) -> loss`` takes this rank's (B, S) token ids
    (tensors or numpy) and returns the mean loss over the group, as a
    0-d f32 tensor on the device, after updating ``params`` in place.
    ``params`` is a :class:`GPT` on ``device`` (the card unless told
    otherwise): ``init_params`` made trainable, or fresh
    :func:`gpt_init` weights from ``generator``. ``opt`` is the
    :class:`DistributedOptimizer` around ``make_optimizer(leaves)``
    (default :func:`adamw`), its EF/momentum buffers this rank's state.
    ``compression_params`` as the reference's, e.g. ``{"compressor":
    "onebit", "ef": "vanilla"}`` or ``{"compressor": "topk", "k": 0.01,
    "ef": "vanilla", "selection": "block"}``; ``remat`` recomputes each block in the
    backward; ``chunked_ce=False`` takes the dense readout + CE."""
    dev = resolve_device(device)
    params = (init_params if init_params is not None
              else gpt_init(cfg, generator, device=dev))
    if params.wte.device != dev:
        raise ValueError(f"init_params live on {params.wte.device}, the "
                         f"step on {dev}")
    params.requires_grad_(True)
    leaves = flat_leaves(params)
    opt = DistributedOptimizer(make_optimizer(leaves), leaves,
                               compression_params,
                               partition_bytes=partition_bytes)

    def as_ids(x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(dev, torch.long)

    def step(tokens, targets) -> torch.Tensor:
        opt.zero_grad()
        loss = gpt_loss(params, as_ids(tokens), as_ids(targets), cfg,
                        remat=remat, chunked_ce=chunked_ce)
        loss.backward()
        opt.step()
        loss = loss.detach()
        n = world()[0]
        if n > 1:                     # the global mean loss, for reporting
            dist.all_reduce(loss)
            loss = loss / n
        return loss

    return step, params, opt


def synthetic_batch(generator: torch.Generator, cfg: GPTConfig, batch: int,
                    seq: int):
    """Random next-token LM batch ``(tokens, targets)``, (batch, seq)
    int64 each, drawn from ``generator`` on its device."""
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                         generator=generator, device=generator.device)
    return toks[:, :-1], toks[:, 1:]
