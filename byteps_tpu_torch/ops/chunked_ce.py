"""Fused readout → cross-entropy whose (N, V) f32 logits never exist
whole: the counterpart of ``byteps_tpu/ops/chunked_ce.py`` (single
device: no vocab-parallel split, no vocab sub-chunking, no logit bias).

:func:`chunked_ce_nll` is the drop-in for the dense
``_nll(head_dot(h, head), targets)``: per-token NLL through an autograd
Function that walks the flattened ``(N, d)`` hidden states in row blocks
(``_default_row_block``: at most 64 MiB of f32 logits live at a time),
saves only the per-row logsumexp, and recomputes each block's logits in
the backward. It keeps the ``head_dot`` precision contract: dot operands
in the activation dtype, f32 accumulation, ``dh`` in the activation
dtype, ``dhead`` in f32. The reference computes this in XLA outside
Pallas, so the products here are library GEMMs (:func:`f32_dot`), not
kernels of the port.
"""

from __future__ import annotations

from typing import Optional

import torch


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


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h2, head, tgt, row_block):
        N = h2.shape[0]
        rb = row_block or _default_row_block(N, head.shape[1])
        head_c = head.to(h2.dtype)
        nll = torch.empty(N, dtype=torch.float32, device=h2.device)
        lse = torch.empty(N, dtype=torch.float32, device=h2.device)
        for r0 in range(0, N, rb):
            z = f32_dot(h2[r0:r0 + rb], head_c)
            m = z.amax(dim=-1)
            s = torch.exp(z - m[:, None]).sum(dim=-1)
            t = z.gather(1, tgt[r0:r0 + rb, None].long())[:, 0]
            # -log_softmax[target], associated as the dense chain does
            nll[r0:r0 + rb] = torch.log(s) - (t - m)
            lse[r0:r0 + rb] = m + torch.log(s)
        ctx.save_for_backward(h2, head, tgt, lse)
        ctx.rb = rb
        return nll

    @staticmethod
    def backward(ctx, g):
        h2, head, tgt, lse = ctx.saved_tensors
        rb = ctx.rb
        head_c = head.to(h2.dtype)
        g = g.float()
        dh = torch.empty_like(h2)
        dhead = torch.zeros(head.shape, dtype=torch.float32,
                            device=h2.device)
        rows = torch.arange(min(rb, h2.shape[0]), device=h2.device)
        for r0 in range(0, h2.shape[0], rb):
            h_blk = h2[r0:r0 + rb]
            n = h_blk.shape[0]
            p = torch.exp(f32_dot(h_blk, head_c) - lse[r0:r0 + rb, None])
            p[rows[:n], tgt[r0:r0 + rb].long()] -= 1.0
            dz = (p * g[r0:r0 + rb, None]).to(h2.dtype)
            dh[r0:r0 + rb] = f32_dot(dz, head_c.T).to(h2.dtype)
            dhead += f32_dot(h_blk.T, dz)
        return dh, dhead.to(head.dtype), None, None


def chunked_ce_nll(h: torch.Tensor, head: torch.Tensor,
                   targets: torch.Tensor,
                   row_block: Optional[int] = None) -> torch.Tensor:
    """Per-token cross-entropy of the fused readout. ``h (..., d)``
    activations, ``head (d, V)`` f32 readout weight, ``targets (...)`` int
    ids; returns f32 NLL shaped like ``targets``."""
    if h.shape[:-1] != targets.shape:
        raise ValueError(f"h leading dims {tuple(h.shape[:-1])} must match "
                         f"targets shape {tuple(targets.shape)}")
    if head.ndim != 2 or h.shape[-1] != head.shape[0]:
        raise ValueError(f"head must be (d, V) with d == h.shape[-1]; got "
                         f"{tuple(head.shape)} vs d={h.shape[-1]}")
    nll = _ChunkedCE.apply(h.reshape(-1, h.shape[-1]), head,
                           targets.reshape(-1), row_block)
    return nll.reshape(targets.shape)
