"""Tensor-parallel building blocks (Megatron-style).

Counterpart of ``byteps_tpu/parallel/tp.py``. Weights arrive sharded:
a column-parallel weight split on its output dim, its row-parallel
partner on its input dim. Where the reference's ``psum`` transposes
itself under ``shard_map``, here two autograd Functions carry Megatron's
pair over the tp axis's process group:

* :func:`copy_to_tp` on the column-parallel input: identity forward, a
  sum over tp backward (each rank's branch holds a part of the input's
  gradient);
* :func:`maybe_psum` on the row-parallel output: a sum over tp forward,
  identity backward (the summed output is replicated, so is its
  gradient).

:func:`pmean` is the same sum divided by the axis size: the loss's mean
over dp and sp.

An axis is a :class:`~byteps_tpu_torch.parallel.mesh.Axis` (or None);
at size 1 both are the identity. Narrow floats are summed in f32 and
rounded back, so the sum is the correctly rounded one on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from byteps_tpu_torch.parallel.mesh import collectives


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.float() if x.dtype in (torch.bfloat16, torch.float16) \
        else x.clone()
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group, kind):
        collectives[kind] = collectives.get(kind, 0) + 1
        return _all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToTP(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        collectives["tp_allreduce_bwd"] += 1
        return _all_reduce(g.contiguous(), ctx.group), None


def _live(axis) -> bool:
    return axis is not None and axis.size > 1


def maybe_psum(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (identity backward), identity when
    ``axis`` is None or of size 1."""
    if not _live(axis):
        return x
    return _ReduceFromTP.apply(x, axis.group, f"{axis.name}_allreduce_fwd")


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    """The mean of ``x`` over ``axis``, each rank's gradient its own
    ``1/n`` share (the loss's mean over dp and sp: every rank then
    differentiates the same mean, and the gradient of its own term
    stays on it)."""
    if not _live(axis):
        return x
    return maybe_psum(x, axis) / axis.size


def copy_to_tp(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` as the input of column-parallel projections over ``axis``:
    unchanged forward, its gradient summed over ``axis`` backward."""
    if not _live(axis):
        return x
    return _CopyToTP.apply(x, axis.group)


def col_parallel_matmul(x: torch.Tensor, w: torch.Tensor,
                        b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y_local = x @ w_local (+ b_local): ``w`` is this rank's output
    columns, the result stays sharded. No collective."""
    y = x @ w
    if b is not None:
        y = y + b
    return y


def row_parallel_matmul(x: torch.Tensor, w: torch.Tensor, axis,
                        b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = sum over ``axis`` of x_local @ w_local, then the (replicated)
    bias, added after the sum as the reference adds it."""
    y = maybe_psum(x @ w, axis)
    if b is not None:
        y = y + b
    return y
