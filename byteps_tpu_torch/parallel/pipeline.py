"""Pipeline parallelism over a pp mesh axis: GPipe microbatches.

Counterpart of ``byteps_tpu/parallel/pipeline.py``. Each pp stage owns a
contiguous slab of layers, stacked on a leading layer axis
(:func:`stack_blocks`; the slab's spec puts ``pp`` on that axis,
:func:`stacked_specs`). :func:`pipeline_apply` runs the reference's
schedule: M + S − 1 ticks, stage s applying its slab to microbatch
t − s at tick t, and between ticks every stage ships its tick's output
to the next stage (:class:`PPShift`: forward to index + 1, the gradient
back to index − 1). The reference's ``ppermute`` becomes one uneven
``all_to_all_single`` over the pp group carrying the activation as bytes
(``ring_attention.shift_flat``, the sp ring's transport: gloo's
point-to-point moves host buffers only, and its all-to-all takes no
16-bit type). Autograd derives the backward pipeline.

Design, for the deadlock-free backward and the exact launch counts:

* Every stage issues one shift a tick except after the last tick, whose
  output no later tick reads: M + S − 2 shifts forward and, through
  :class:`PPShift`'s backward, as many backward, in reverse tick order on
  every stage (each tick's backward waits for the next tick's, so the
  pp group's exchanges cannot cross).
* Stage 0 takes ``torch.where(first, inject, recv)`` as the reference
  does, so the received tensor stays in its graph with a zero gradient
  and stage 0 issues its backward shifts too.
* A dead tick (warm-up or drain: microbatch t − s outside ``[0, M)``)
  skips the slab's compute and passes its input on unchanged; its output
  reaches only other dead ticks and the masked outputs, so its value and
  gradient are the reference's masked zeros. Each stage runs its slab M
  times a step: M · L/S layer calls forward (and backward) a stage.
* The outputs of a stage that is not the last are ``torch.where(False,
  …, 0)`` of its ticks' outputs: zeros, as the reference returns there,
  which keep the whole tick chain in the graph of a loss built on them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping

import numpy as np
import torch
import torch.distributed as dist

from byteps_tpu_torch.parallel.mesh import collectives
from byteps_tpu_torch.parallel.remat import maybe_remat
from byteps_tpu_torch.parallel.ring_attention import shift_flat


def _stack(xs):
    return (torch.stack(xs) if isinstance(xs[0], torch.Tensor)
            else np.stack(xs))


def stack_blocks(blocks: List[Mapping[str, Any]]) -> Dict[str, Any]:
    """A list of identically shaped block trees (dicts, nested dicts
    allowed; tensors or numpy arrays) → one tree with a leading layer
    axis on every leaf."""
    out = {}
    for k, v in blocks[0].items():
        parts = [b[k] for b in blocks]
        out[k] = (stack_blocks(parts) if isinstance(v, Mapping)
                  else _stack(parts))
    return out


def stacked_specs(block_spec: Any, pp_axis) -> Any:
    """The spec tree of :func:`stack_blocks`' output: the leading layer
    axis over ``pp_axis``, each leaf's own dimensions as ``block_spec``
    gives them (a replicated leaf's ``()`` becomes ``(pp_axis,)``)."""
    if isinstance(block_spec, Mapping):
        return {k: stacked_specs(v, pp_axis) for k, v in block_spec.items()}
    return (pp_axis,) + tuple(block_spec)


def _live(axis) -> bool:
    return axis is not None and axis.size > 1


def is_last_stage(pp_axis) -> bool:
    return not _live(pp_axis) or pp_axis.index == pp_axis.size - 1


class PPShift(torch.autograd.Function):
    """One pipeline tick's shift over the pp axis: forward to the next
    stage, the gradient back to the previous one."""

    @staticmethod
    def forward(x, axis):
        collectives["pp_shift_fwd"] += 1
        return shift_flat(x.contiguous(), axis, +1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        collectives["pp_shift_bwd"] += 1
        return shift_flat(g.contiguous(), ctx.axis, -1), None


def pp_shift(x: torch.Tensor, axis) -> torch.Tensor:
    """The previous stage's ``x`` (:class:`PPShift`)."""
    return PPShift.apply(x, axis)


def layer_params(stacked: Mapping[str, Any]) -> List[Dict[str, Any]]:
    """The slab's per-layer parameter trees: each leaf unbound once along
    its layer axis (one backward node a leaf, which stacks the layers'
    gradients into the slab's), nested trees kept nested."""
    per = {}
    n = None
    for k in stacked.keys():
        v = stacked[k]
        if isinstance(v, torch.Tensor):
            per[k] = v.unbind(0)
        else:
            per[k] = layer_params(v)
        n = len(per[k])
    return [{k: per[k][i] for k in per} for i in range(n)]


def pipeline_apply(x_mb: torch.Tensor, stacked: Mapping[str, Any],
                   block_fn: Callable, pp_axis, remat: bool = False,
                   has_aux: bool = False):
    """Run microbatches through the pp-staged layer pipeline.

    ``x_mb`` is the stage-0 input ``(M, mb, ...)`` (the same on every
    stage; only stage 0 reads it); ``stacked`` this stage's slab (a
    mapping of ``(layers_per_stage, ...)`` leaves, nested mappings
    allowed); ``block_fn(x, layer) -> x`` one layer, shape-preserving,
    or with ``has_aux`` ``-> (x, scalar aux)``. Returns ``(M, mb, ...)``
    outputs, real on the last pp stage and zeros elsewhere, and with
    ``has_aux`` also this stage's layers' aux summed over its M real
    microbatches (f32). With no pp axis (or one of size 1) the slab is
    the whole model and every microbatch runs through it in turn.
    The schedule is the module docstring's."""
    n = pp_axis.size if _live(pp_axis) else 1
    s = pp_axis.index if _live(pp_axis) else 0
    M = x_mb.shape[0]
    layers = layer_params(stacked)
    fn = maybe_remat(block_fn, remat)
    first = torch.tensor(s == 0, device=x_mb.device)
    recv = torch.zeros_like(x_mb[0])
    aux = torch.zeros((), dtype=torch.float32, device=x_mb.device)
    ys = []
    ticks = M + n - 1
    for t in range(ticks):
        inject = x_mb[min(t, M - 1)]
        y = torch.where(first, inject, recv) if n > 1 else inject
        if 0 <= t - s < M:
            aux_t = torch.zeros((), dtype=torch.float32, device=y.device)
            for p in layers:
                out = fn(y, p)
                if has_aux:
                    y, a = out
                    aux_t = aux_t + a
                else:
                    y = out
            aux = aux + aux_t
        if t >= n - 1:
            ys.append(y)
        if n > 1 and t + 1 < ticks:
            recv = pp_shift(y, pp_axis)
    outs = torch.stack(ys)
    if not is_last_stage(pp_axis):
        outs = torch.where(torch.tensor(False, device=outs.device), outs,
                           torch.zeros((), dtype=outs.dtype,
                                       device=outs.device))
    return (outs, aux) if has_aux else outs


def last_stage_value(value: torch.Tensor, pp_axis) -> torch.Tensor:
    """A last-stage value replicated to every pp stage (the sum over pp
    of the value masked to zero off the last stage), outside autograd:
    for reporting."""
    if not _live(pp_axis):
        return value
    out = value.detach().float()
    if not is_last_stage(pp_axis):
        out = torch.zeros_like(out)
    dist.all_reduce(out, group=pp_axis.group)
    return out.to(value.dtype)
