"""The data-parallel GPT training step and the eval step (counterparts
of ``byteps_tpu/models/train.py``'s ``make_gpt_train_step``,
``make_eval_step`` and ``evaluate_perplexity``, with dp only: no tp, sp,
pp or ZeRO-3).

One step runs, in order: the forward, the backward (attention through
the hand-written flash kernels on the card), the flattening of the
gradients in the reference's leaf order, the chunked aggregation of
``optimizer.DistributedOptimizer`` (raw, or compressed by any codec of
``compression``, with error feedback and momentum as asked),
the write-back into ``.grad``, and a ``torch.optim.AdamW`` step. Each
rank is one process with its own batch; with more than one rank the step
aggregates over the default ``torch.distributed`` group, which the caller
initializes. ``zero_1=True`` shards AdamW's moments over the ranks
(ZeRO-1: one reduce-scatter of the flat gradient, the segment's step,
an all-gather of the stepped segments). ``accum_steps`` > 1 splits the
rank's batch into that many microbatches and runs forward and backward
one microbatch at a time (only one microbatch's activations live),
summing the unscaled gradients and losses and dividing once by their
count before the one aggregation of the step, as the reference's
``_accumulating_value_and_grad`` does.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

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


# the training options the port leaves to ROADMAP A.6 (parallelism)
_A6 = "not ported yet (ROADMAP A.6, parallelism)"


def _check_seq_layout(seq_layout: str) -> None:
    if seq_layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown seq_layout {seq_layout!r} — expected "
                         "'contiguous' or 'zigzag'")
    if seq_layout == "zigzag":
        raise NotImplementedError(
            f"seq_layout='zigzag' (the load-balanced causal ring over sp) "
            f"is {_A6}")


def make_gpt_train_step(
    cfg: GPTConfig,
    make_optimizer: Callable[[Sequence[torch.Tensor]],
                             torch.optim.Optimizer] = adamw,
    compression_params: Optional[Dict[str, Any]] = None,
    partition_bytes: Optional[int] = None,
    remat: bool = False,
    chunked_ce: bool = True,
    zero_1: bool = False,
    zero_3: bool = False,
    accum_steps: int = 1,
    seq_layout: str = "contiguous",
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
    backward; ``chunked_ce=False`` takes the dense readout + CE.
    ``zero_1=True`` is ZeRO-1 (``DistributedOptimizer(zero=True)``; an
    elementwise ``make_optimizer`` only). ``accum_steps`` > 1
    accumulates over that many sequential microbatches of the rank's
    batch before the one aggregation and update (the torch adapter's
    ``backward_passes_per_step``, fused into the step). ``zero_3`` and
    ``seq_layout="zigzag"`` are not ported (ROADMAP A.6)."""
    if zero_3:
        if zero_1:
            raise ValueError("zero_1 and zero_3 are mutually exclusive")
        raise NotImplementedError(f"zero_3 (ZeRO-3 FSDP) is {_A6}")
    _check_seq_layout(seq_layout)
    if accum_steps < 1:
        raise ValueError(f"accum_steps={accum_steps} must be at least 1")
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
                               partition_bytes=partition_bytes,
                               zero=zero_1)

    def step(tokens, targets) -> torch.Tensor:
        opt.zero_grad()
        tok, tgt = _as_ids(tokens, dev), _as_ids(targets, dev)
        B = tok.shape[0]
        if B % accum_steps:
            raise ValueError(f"per-device batch {B} not divisible by "
                             f"accum_steps={accum_steps}")
        mb = B // accum_steps
        loss = None
        for i in range(accum_steps):
            part = gpt_loss(params, tok[i * mb:(i + 1) * mb],
                            tgt[i * mb:(i + 1) * mb], cfg, remat=remat,
                            chunked_ce=chunked_ce)
            part.backward()                # into .grad, summed
            part = part.detach()
            loss = part if loss is None else loss + part
        if accum_steps > 1:
            # the sums of the unscaled gradients and losses, divided once
            for p in leaves:
                if p.grad is not None:
                    p.grad.div_(accum_steps)
            loss = loss / accum_steps
        opt.step()
        return _group_mean(loss)

    return step, params, opt


def _as_ids(x, dev) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(dev, torch.long)


def _group_mean(loss: torch.Tensor) -> torch.Tensor:
    """The mean of ``loss`` over the default group (the reference's dp
    ``pmean``), for reporting."""
    n = world()[0]
    if n > 1:
        loss = loss.clone()
        dist.all_reduce(loss)
        loss = loss / n
    return loss


def make_eval_step(cfg: GPTConfig, device=None, chunked_ce: bool = True):
    """``eval_step(params, tokens, targets) -> mean nll`` (a 0-d f32
    tensor on the device) of this rank's (B, S) batch under
    ``torch.no_grad()``, through the training step's ``gpt_loss``; with
    more than one rank, the mean over the default group, as the
    reference's dp ``pmean``. ``exp`` of the running mean is the
    perplexity (:func:`evaluate_perplexity`). No optimizer, no gradients:
    safe on training parameters at any step."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(params: GPT, tokens, targets) -> torch.Tensor:
        loss = gpt_loss(params, _as_ids(tokens, dev), _as_ids(targets, dev),
                        cfg, chunked_ce=chunked_ce)
        return _group_mean(loss)

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
