"""Fused readout → cross-entropy whose (N, V) f32 logits never exist
whole: the counterpart of ``byteps_tpu/ops/chunked_ce.py`` (no vocab
sub-chunking).

:func:`chunked_ce_nll` is the drop-in for the dense
``_nll(head_dot(h, head), targets)``: per-token NLL through an autograd
Function that walks the flattened ``(N, d)`` hidden states in row blocks
(``_default_row_block``: at most 64 MiB of f32 logits live at a time),
saves only the per-row logsumexp, and recomputes each block's logits in
the backward. An optional f32 ``(V,)`` logit bias (BERT's ``mlm_bias``)
adds to every row's logits in both passes; its gradient is the column
sum of the logits' gradient. It keeps the ``head_dot`` precision
contract: dot operands in the activation dtype, f32 accumulation, ``dh``
in the activation dtype, ``dhead`` in f32.

Vocab-parallel (``tp_axis``): each rank takes its ``V/ntp`` columns of
the replicated head (and of the bias); a row block's max is combined
over tp by an all-reduce MAX and its rescaled sum-exp and target logit
by one
all-reduce SUM before the log-partition; the backward sums ``dh`` over tp
once and gathers the ranks' ``dhead`` columns (with their ``dbias``
entries as one more row) once. Where V does not
divide by the tp size, every rank computes the whole vocab, as the
reference falls back. The reference computes this in XLA outside
Pallas, so the products here are library GEMMs (:func:`f32_dot`), not
kernels of the port.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def f32_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (..., k) @ b (k, n)`` with f32 accumulation and an f32 result
    from operands of one dtype. f32 operands multiply as they are;
    narrower ones on the card keep their dtype and ask the GEMM for an
    f32 output (``out_dtype``), and on the CPU widen first (the same
    products, each exact in f32)."""
    if a.dtype == torch.float32:
        return a @ b
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda:
        out = torch.mm(a2, b, out_dtype=torch.float32)
    else:
        out = a2.float() @ b.float()
    return out.reshape(*a.shape[:-1], b.shape[-1])


def _default_row_block(n_rows: int, v: int) -> int:
    """Largest power-of-two row count keeping one block's f32 logits
    ≤ 64 MiB (the whole batch when it fits); clamped to [16, n_rows]."""
    budget = (64 * 1024 * 1024) // 4
    if n_rows * max(v, 1) <= budget:
        return max(n_rows, 1)
    rb = 16
    while rb * 2 * max(v, 1) <= budget:
        rb *= 2
    return rb


def _local_head(head: torch.Tensor, bias: Optional[torch.Tensor], tp_axis):
    """This rank's columns of the (replicated) head and bias and their
    vocab offset: the whole head with no tp axis, at size 1, or where V
    does not split evenly (the replicated-vocab path); else the ``V/ntp``
    columns at the rank's tp index."""
    V = head.shape[1]
    if tp_axis is None or tp_axis.size == 1 or V % tp_axis.size:
        return head, bias, 0
    v_loc = V // tp_axis.size
    off = tp_axis.index * v_loc
    return (head[:, off:off + v_loc],
            None if bias is None else bias[off:off + v_loc], off)


def _count(kind: str, n: int = 1) -> None:
    from byteps_tpu_torch.parallel.mesh import collectives
    collectives[kind] += n


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h2, head, bias, tgt, row_block, tp_axis):
        N = h2.shape[0]
        head_loc, bias_loc, off = _local_head(head, bias, tp_axis)
        split = head_loc.shape[1] != head.shape[1]
        rb = row_block or _default_row_block(N, head_loc.shape[1])
        head_c = head_loc.to(h2.dtype)
        nll = torch.empty(N, dtype=torch.float32, device=h2.device)
        lse = torch.empty(N, dtype=torch.float32, device=h2.device)
        for r0 in range(0, N, rb):
            z = f32_dot(h2[r0:r0 + rb], head_c)
            if bias_loc is not None:
                z = z + bias_loc
            m = z.amax(dim=-1)
            s = torch.exp(z - m[:, None]).sum(dim=-1)
            if split:
                # this shard's (max, sum-exp, target logit), combined over
                # tp before the log-partition: the max by MAX, the
                # rescaled sum-exp and the target logit (0 off the shard)
                # in one SUM
                local = tgt[r0:r0 + rb].long() - off
                hit = (local >= 0) & (local < z.shape[1])
                t = z.gather(1, local.clamp(0, z.shape[1] - 1)[:, None])[:, 0]
                t = torch.where(hit, t, torch.zeros_like(t))
                m_g = m.clone()
                dist.all_reduce(m_g, op=dist.ReduceOp.MAX,
                                group=tp_axis.group)
                st = torch.stack([s * torch.exp(m - m_g), t])
                dist.all_reduce(st, group=tp_axis.group)
                _count("vocab_allreduce_fwd", 2)
                s, t, m = st[0], st[1], m_g
            else:
                t = z.gather(1, tgt[r0:r0 + rb, None].long())[:, 0]
            # -log_softmax[target], associated as the dense chain does
            nll[r0:r0 + rb] = torch.log(s) - (t - m)
            lse[r0:r0 + rb] = m + torch.log(s)
        ctx.save_for_backward(h2, head, bias, tgt, lse)
        ctx.rb = rb
        ctx.tp_axis = tp_axis
        return nll

    @staticmethod
    def backward(ctx, g):
        h2, head, bias, tgt, lse = ctx.saved_tensors
        rb, tp_axis = ctx.rb, ctx.tp_axis
        head_loc, bias_loc, off = _local_head(head, bias, tp_axis)
        split = head_loc.shape[1] != head.shape[1]
        head_c = head_loc.to(h2.dtype)
        v_loc = head_c.shape[1]
        g = g.float()
        dh = torch.empty(h2.shape, device=h2.device,
                         dtype=torch.float32 if split else h2.dtype)
        # dhead, and the bias's gradient as one more row
        dhead = torch.zeros((head_loc.shape[0] + (bias is not None),
                             v_loc), dtype=torch.float32, device=h2.device)
        d = head_loc.shape[0]
        rows = torch.arange(min(rb, h2.shape[0]), device=h2.device)
        for r0 in range(0, h2.shape[0], rb):
            h_blk = h2[r0:r0 + rb]
            n = h_blk.shape[0]
            z = f32_dot(h_blk, head_c)
            if bias_loc is not None:
                z = z + bias_loc
            p = torch.exp(z - lse[r0:r0 + rb, None])
            local = tgt[r0:r0 + rb].long() - off
            hit = (local >= 0) & (local < v_loc)
            # the target's one-hot, where it falls in this shard
            p[rows[:n], local.clamp(0, v_loc - 1)] -= hit.float()
            dz = (p * g[r0:r0 + rb, None]).to(h2.dtype)
            dh_blk = f32_dot(dz, head_c.T)
            dh[r0:r0 + rb] = dh_blk if split else dh_blk.to(h2.dtype)
            dhead[:d] += f32_dot(h_blk.T, dz)
            if bias is not None:
                dhead[d] += dz.float().sum(dim=0)
        if split:
            # each rank holds its shard's share of dh and its columns of
            # dhead: one sum over tp for dh, one gather for dhead
            dist.all_reduce(dh, group=tp_axis.group)
            n_rows = dhead.shape[0]
            parts = torch.empty((tp_axis.size * n_rows, v_loc),
                                dtype=dhead.dtype, device=dhead.device)
            dist.all_gather_into_tensor(parts, dhead.contiguous(),
                                        group=tp_axis.group)
            _count("vocab_allreduce_bwd", 2)
            dh = dh.to(h2.dtype)
            dhead = parts.view(tp_axis.size, n_rows, v_loc).permute(
                1, 0, 2).reshape(n_rows, head.shape[1])
        dbias = None if bias is None else dhead[d].to(bias.dtype)
        return (dh, dhead[:d].to(head.dtype), dbias, None, None, None)


def chunked_ce_nll(h: torch.Tensor, head: torch.Tensor,
                   targets: torch.Tensor,
                   row_block: Optional[int] = None,
                   tp_axis=None,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-token cross-entropy of the fused readout. ``h (..., d)``
    activations, ``head (d, V)`` f32 readout weight, ``targets (...)`` int
    ids, optional ``bias (V,)`` f32 logit bias (BERT's ``mlm_bias``);
    returns f32 NLL shaped like ``targets``. ``tp_axis`` (an
    :class:`~byteps_tpu_torch.parallel.mesh.Axis`) splits the vocab over
    tp: each rank computes its ``V/ntp`` logit columns and the row
    statistics are combined over tp; where V does not divide by the tp
    size every rank computes the whole vocab."""
    if h.shape[:-1] != targets.shape:
        raise ValueError(f"h leading dims {tuple(h.shape[:-1])} must match "
                         f"targets shape {tuple(targets.shape)}")
    if head.ndim != 2 or h.shape[-1] != head.shape[0]:
        raise ValueError(f"head must be (d, V) with d == h.shape[-1]; got "
                         f"{tuple(head.shape)} vs d={h.shape[-1]}")
    if bias is not None and tuple(bias.shape) != (head.shape[1],):
        raise ValueError(f"bias must be (V,) = ({head.shape[1]},); got "
                         f"{tuple(bias.shape)}")
    nll = _ChunkedCE.apply(h.reshape(-1, h.shape[-1]), head, bias,
                           targets.reshape(-1), row_block, tp_axis)
    return nll.reshape(targets.shape)
