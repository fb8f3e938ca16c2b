"""Ring attention: sequence parallelism over an sp mesh axis.

Counterpart of ``byteps_tpu/parallel/ring_attention.py`` in its
flash-kernel form (``_ring_flash``). The sequence is split over the sp
axis; each rank holds one block of q, k and v, and the k/v blocks rotate
around the ring. At each step the rank runs the flash attention of its
queries against the block in hand at global offsets
(:func:`~byteps_tpu_torch.ops.flash_attention.flash_attention_lse`: the
forward kernel, and in the backward the dq and dk/dv kernels with the
lse cotangent of the merge, on CUDA tensors; the plain versions on CPU
tensors), and :func:`~byteps_tpu_torch.ops.flash_attention
.merge_attention` folds the step's ``(o, lse)`` partial into the running
one. A block wholly after the queries (the contiguous ring's upper
steps) comes out ``(0, −1e30)`` from the kernel and merges to nothing,
as in the reference. GQA rotates the narrow k/v.

The rotation is :class:`RingShift`: forward, each rank sends its k/v to
the next index and receives the previous index's; backward, the
gradients travel the other way, back to the ranks that own the blocks.
Its transport is one ``all_to_all_single`` over the sp group with
uneven splits (the whole k/v block to one peer, nothing to the others):
gloo takes CUDA tensors in that collective, as the staged ICI tier
already relies on, where its point-to-point ``send``/``recv`` take host
buffers only, and the port's own ring kernels (``csrc/ring.cu``) move
between processes that map each other's workspaces, which the ranks of
a mesh on several cards or hosts do not. k and v move in one call a
step.

The zigzag layout balances the causal ring: the sequence splits into
``2n`` chunks and rank d holds chunks ``(d, 2n−1−d)``. Its offsets are
Python ints (a rank's index is one), so where the reference selects the
live half-pair of an off-diagonal step branchlessly, here it is chosen
in Python: the same partials, merged in the same order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from byteps_tpu_torch.ops.flash_attention import (
    attention_lse,
    flash_attention,
    merge_attention,
)
from byteps_tpu_torch.parallel.mesh import collectives

_NEG = -1e30


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """One rank's softmax attention, (B, S, H, D): the flash kernels
    where supported."""
    return flash_attention(q, k, v, causal=causal)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A flat buffer as the collective carries it: its bytes, as uint8
    (gloo's all-to-all takes no 16-bit type; the bits move unchanged)."""
    return x.view(torch.uint8)


def shift_flat(buf: torch.Tensor, axis, direction: int) -> torch.Tensor:
    """Send the contiguous ``buf`` to index ``idx + direction`` of the
    ring of ``axis`` and return the tensor of the same shape and type
    received from ``idx − direction``: one uneven ``all_to_all_single``
    over the axis's group, the whole buffer to one peer as bytes."""
    n, idx = axis.size, axis.index
    nbytes = buf.numel() * buf.element_size()
    send = [0] * n
    recv = [0] * n
    send[(idx + direction) % n] = nbytes
    recv[(idx - direction) % n] = nbytes
    out = torch.empty_like(buf)
    dist.all_to_all_single(_wire(out.reshape(-1)), _wire(buf.reshape(-1)),
                           recv, send, group=axis.group)
    return out


def _shift(k: torch.Tensor, v: torch.Tensor, axis, direction: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send ``(k, v)`` to index ``idx + direction`` of the ring and return
    the pair received from ``idx − direction``."""
    buf = torch.cat([k.reshape(-1), v.reshape(-1)])
    out = shift_flat(buf, axis, direction)
    nk = k.numel()
    return out[:nk].view(k.shape), out[nk:].view(v.shape)


class RingShift(torch.autograd.Function):
    """One ring step of a k/v pair over the sp axis: forward to the next
    index, the gradients backward to the previous one."""

    @staticmethod
    def forward(k, v, axis):
        collectives["sp_rotate_fwd"] += 1
        return _shift(k.contiguous(), v.contiguous(), axis, +1)

    @staticmethod
    def backward(ctx, dk, dv):
        axis = ctx.axis
        shape_k, shape_v = ctx.shapes
        dk = (dk.contiguous() if dk is not None
              else torch.zeros(shape_k, dtype=ctx.dtypes[0],
                               device=ctx.device))
        dv = (dv.contiguous() if dv is not None
              else torch.zeros(shape_v, dtype=ctx.dtypes[1],
                               device=ctx.device))
        collectives["sp_rotate_bwd"] += 1
        gk, gv = _shift(dk, dv, axis, -1)
        return gk, gv, None

    @staticmethod
    def setup_context(ctx, inputs, output):
        k, v, axis = inputs
        ctx.axis = axis
        ctx.shapes = (k.shape, v.shape)
        ctx.dtypes = (k.dtype, v.dtype)
        ctx.device = k.device
        ctx.set_materialize_grads(False)


def ring_shift(k: torch.Tensor, v: torch.Tensor, axis
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(k, v)`` of the previous index of ``axis`` (:class:`RingShift`)."""
    return RingShift.apply(k, v, axis)


def _live(axis) -> bool:
    return axis is not None and axis.size > 1


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sp_axis, causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention. q/k/v: (B, S_local, H, D), this rank's
    block; the global sequence is the blocks in sp index order. With no
    sp axis (or one of size 1), :func:`plain_attention`."""
    if not _live(sp_axis):
        return plain_attention(q, k, v, causal=causal)
    n, idx = sp_axis.size, sp_axis.index
    B, S_loc, H, D = q.shape
    q_off = idx * S_loc
    o = torch.zeros((B, S_loc, H, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, S_loc, H), _NEG, dtype=torch.float32,
                     device=q.device)
    k_blk, v_blk = k, v
    for step in range(n):
        src = (idx - step) % n             # owner of the block in hand
        # offset by the k block's own length (rectangular rings)
        o_s, lse_s = attention_lse(q, k_blk, v_blk, q_off,
                                   src * k_blk.shape[1], causal=causal)
        o, lse = merge_attention(o, lse, o_s, lse_s)
        if step + 1 < n:
            k_blk, v_blk = ring_shift(k_blk, v_blk, sp_axis)
    return o.to(q.dtype)


def zigzag_permutation(S: int, n: int) -> torch.Tensor:
    """Global index map of the zigzag layout: the sequence in 2n chunks,
    rank d holding chunks ``(d, 2n−1−d)``; ``perm[i]`` is the global
    position at layout slot i (int64)."""
    if S % (2 * n) != 0:
        raise ValueError(f"zigzag needs S ({S}) divisible by 2·sp ({2 * n})")
    c = S // (2 * n)
    chunks = []
    for d in range(n):
        chunks.append(torch.arange(d * c, (d + 1) * c))
        e = 2 * n - 1 - d
        chunks.append(torch.arange(e * c, (e + 1) * c))
    return torch.cat(chunks)


def zigzag_inverse(S: int, n: int) -> torch.Tensor:
    """Inverse map: ``x_layout[zigzag_inverse(S, n)] == x_original``."""
    perm = zigzag_permutation(S, n)
    inv = torch.empty(S, dtype=torch.int64)
    inv[perm] = torch.arange(S)
    return inv


def zigzag_local_positions(S_loc: int, sp_axis,
                           device: Optional[torch.device] = None
                           ) -> torch.Tensor:
    """This rank's global positions under the zigzag layout (S_loc local
    tokens: two chunks of S_loc/2)."""
    n, idx = sp_axis.size, sp_axis.index
    c = S_loc // 2
    a = idx * c + torch.arange(c, device=device)
    b = (2 * n - 1 - idx) * c + torch.arange(c, device=device)
    return torch.cat([a, b])


def zigzag_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sp_axis, causal: bool = True) -> torch.Tensor:
    """The load-balanced causal ring, inputs and output in the zigzag
    layout (each rank's S_loc tokens its (chunk_d, chunk_{2n−1−d}) pair).
    The k/v pairs rotate as in :func:`ring_attention`; each live
    (q-half, k-half) pair runs flash attention at its own global offsets,
    merged by logsumexp. Causal: the diagonal step runs (early q, early
    k) and (late q, late k) masked and (late q, early k) unmasked; every
    other step two unmasked half-pairs, (late q, early k) and whichever
    of (early q, early k) (this rank after the block's owner) or (late
    q, late k) (before it) is live."""
    if not _live(sp_axis):
        return plain_attention(q, k, v, causal=causal)
    n, idx = sp_axis.size, sp_axis.index
    B, S_loc, H, D = q.shape
    if S_loc % 2 != 0:
        raise ValueError(f"zigzag layout needs even local length; got "
                         f"{S_loc}")
    c = S_loc // 2
    my_offs = (idx * c, (2 * n - 1 - idx) * c)
    q_halves = (q[:, :c].contiguous(), q[:, c:].contiguous())
    state = [(torch.zeros((B, c, H, D), dtype=torch.float32,
                          device=q.device),
              torch.full((B, c, H), _NEG, dtype=torch.float32,
                         device=q.device)) for _ in range(2)]

    def add(qi, kh, vh, ki, k_offs, masked):
        o_s, lse_s = attention_lse(q_halves[qi], kh[ki], vh[ki], my_offs[qi],
                                   k_offs[ki], causal=masked)
        state[qi] = merge_attention(*state[qi], o_s, lse_s)

    k_blk, v_blk = k, v
    for step in range(n):
        src = (idx - step) % n
        k_offs = (src * c, (2 * n - 1 - src) * c)
        kh = (k_blk[:, :c].contiguous(), k_blk[:, c:].contiguous())
        vh = (v_blk[:, :c].contiguous(), v_blk[:, c:].contiguous())
        if not causal:
            for ki in range(2):
                for qi in range(2):
                    add(qi, kh, vh, ki, k_offs, False)
        elif step == 0:
            for qi, ki, masked in ((0, 0, True), (1, 0, False),
                                   (1, 1, True)):
                add(qi, kh, vh, ki, k_offs, masked)
        else:
            add(1, kh, vh, 0, k_offs, False)
            if idx > src:
                add(0, kh, vh, 0, k_offs, False)
            else:
                add(1, kh, vh, 1, k_offs, False)
        if step + 1 < n:
            k_blk, v_blk = ring_shift(k_blk, v_blk, sp_axis)
    out = torch.cat([state[0][0], state[1][0]], dim=1)
    return out.to(q.dtype)
