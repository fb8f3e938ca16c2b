"""Segmented LoRA delta: the batched heterogeneous-adapter product behind
multi-tenant serving, dispatched by device to the hand-written kernel
(``csrc/segmented_lora.cu``) or to its plain PyTorch version.

Counterpart of ``byteps_tpu/ops/segmented_lora.py``. R packed rows each
carry a slot index into a pool of adapter slabs, and one call computes
every row's own low-rank delta ``(x_r @ A[slot_r]) @ B[slot_r]``. Slot 0
of a pool is its all-zero slot (base-model rows, padded rows): a finite
row there gets exactly 0.0.

The function is the reference's Pallas kernel body (``:87-93``): x upcast
to f32, the f32 slabs as they are, the thin ``u = x @ A`` kept in f32,
the output cast to x's dtype. The reference's jnp twin (``_delta_jnp``)
instead casts the slabs to x's dtype and rounds ``u`` there, which
differs in bf16; the port follows the kernel on both devices.

Both versions are batch invariant: a row's delta is summed in an order
that depends only on ``d_in``, the rank and ``d_out``, never on R, S or
the row's place in the batch. The kernel does it by construction: one
thread-block cluster a (row, position) splits ``d_in`` across its blocks
and warps and adds the partials in a fixed order, on a launch plan the
kernel's library computes from those three widths (see the kernel's
note); the plain version sums ``x * A`` over ``d_in`` with one reduction
and adds the rank terms in order with elementwise ops, where a CPU
``matmul``'s blocking changes with the number of rows. That is what lets
``models/lora.lora_delta`` (one slot, all rows on it) and the pooled
decode step compute the same bits for the same row.

The row-parallel arm (``row_parallel=True`` with a live ``tp_axis``: a
tensor-parallel ``wo`` or ``w2``, whose ``d_in`` is this rank's shard)
needs the sum over tp between the two products, as the reference's
``lora_delta(..., tp_axis)`` has it. The fused launch has no seam for
it, so the arm runs two launches of the same kernel: the *down* half
writes ``u = x @ A[slot]`` as f32 ``(R, S, rb)``, ``u`` is summed over
tp in f32 (``parallel/tp.maybe_psum``), and the *up* half computes ``u @
B[slot]`` in x's dtype. Each half sums in the fused launch's order, so at
one rank down + up is the fused launch bit for bit; the plain version is
split the same way (:func:`down_torch`, :func:`up_torch`). ``u`` stays
f32 throughout, the Pallas body's contract (the reference's jnp twin
rounds it to x's dtype; ROADMAP C).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from byteps_tpu_torch.ops import _build
from byteps_tpu_torch.ops.backend import check_kernel_input, launches

__all__ = ["segmented_lora_delta", "delta_torch", "down_torch", "up_torch",
           "lora_down", "lora_up", "MAX_RANK"]

# the kernel's largest rank bucket (its shared arrays are sized by it)
MAX_RANK = 64


def down_torch(x: torch.Tensor, a_slab: torch.Tensor,
               slots: torch.Tensor) -> torch.Tensor:
    """The plain down half: each row's ``u = Σ_k x·A[slot]`` in f32,
    ``(R, S, rb)``."""
    a = a_slab[slots.long()].float()                     # (R, d_in, rb)
    return (x.float()[..., :, None] * a[:, None]).sum(-2)


def up_torch(u: torch.Tensor, b_slab: torch.Tensor, slots: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """The plain up half: each row's ``Σ_j u_j·B[slot]_j`` added in rank
    order from f32 ``u``, cast to ``dtype``."""
    b = b_slab[slots.long()].float()                     # (R, rb, d_out)
    out = u[..., 0:1] * b[:, None, 0]
    for j in range(1, b.shape[1]):
        out = out + u[..., j:j + 1] * b[:, None, j]
    return out.to(dtype)


def delta_torch(x: torch.Tensor, a_slab: torch.Tensor, b_slab: torch.Tensor,
                slots: torch.Tensor) -> torch.Tensor:
    """The plain version: gather each row's slabs, ``u = Σ_k x·A`` in f32,
    then ``Σ_j u_j·B_j`` added in rank order, cast to x's dtype (the
    down half, then the up half)."""
    return up_torch(down_torch(x, a_slab, slots), b_slab, slots, x.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("segmented_lora")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bps_segmented_lora.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                       ll, ll, i, i, p]
    lib.bps_segmented_lora.restype = i
    return lib


def _slab_ok(t: torch.Tensor) -> bool:
    """The kernel reads a slab through its slot stride: the two inner
    dims must be contiguous; the slot stride is free."""
    return t.stride(2) == 1 and t.stride(1) == t.shape[2]


# the kernel's modes (csrc/segmented_lora.cu) and the launch count of each
_FUSED, _DOWN, _UP = 0, 1, 2
_COUNT = {_FUSED: "segmented_lora", _DOWN: "segmented_lora_down",
          _UP: "segmented_lora_up"}


def _launch(mode: int, x: torch.Tensor, u: Optional[torch.Tensor],
            a_slab: torch.Tensor, b_slab: torch.Tensor, slots: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """One launch of the kernel in ``mode`` (the fused delta, the down or
    the up half); the slabs' widths set its plan in every mode. Returns
    the fused delta or the up half in ``dtype``, or the down half's f32
    ``u``."""
    lead = x if mode != _UP else u
    check_kernel_input(lead, "x" if mode != _UP else "u",
                       (torch.float32, torch.bfloat16) if mode != _UP
                       else (torch.float32,))
    for name, t in (("a_slab", a_slab), ("b_slab", b_slab)):
        if not t.is_cuda or t.device != lead.device:
            raise ValueError(f"{name} must live on {lead.device}; got "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}")
        if not _slab_ok(t):
            raise ValueError(f"{name}'s two inner dims must be contiguous; "
                             f"strides {t.stride()}")
    check_kernel_input(slots, "slots", (torch.int32,), lead.device)
    R, S = lead.shape[:2]
    n_slots, d_in, rb = a_slab.shape
    d_out = b_slab.shape[-1]
    if rb > MAX_RANK:
        raise ValueError(f"the kernel takes ranks up to {MAX_RANK}; got {rb}")
    if mode == _DOWN:
        out = None
        u = torch.empty((R, S, rb), dtype=torch.float32, device=lead.device)
    else:
        out = torch.empty((R, S, d_out), dtype=dtype, device=lead.device)
    lib = _lib()
    with torch.cuda.device(lead.device):
        rc = lib.bps_segmented_lora(
            0 if mode == _UP else x.data_ptr(), a_slab.data_ptr(),
            b_slab.data_ptr(), slots.data_ptr(),
            0 if out is None else out.data_ptr(),
            0 if u is None else u.data_ptr(), R, S, d_in, rb, d_out,
            n_slots, a_slab.stride(0), b_slab.stride(0),
            int(dtype == torch.bfloat16), mode,
            torch.cuda.current_stream(lead.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("segmented LoRA kernel launch failed: "
                           f"{_build.error_string(lib, rc)}")
    launches[_COUNT[mode]] += 1
    return u if mode == _DOWN else out


def lora_down(x: torch.Tensor, a_slab: torch.Tensor, b_slab: torch.Tensor,
              slots: torch.Tensor) -> torch.Tensor:
    """The down half, ``u = x @ A[slot]`` as f32 ``(R, S, rb)``: the
    kernel's down launch on the card (``b_slab``'s width sets its plan,
    so ``u`` is summed as the fused launch sums it), :func:`down_torch`
    on the CPU."""
    if x.is_cuda:
        return _launch(_DOWN, x.contiguous(), None, a_slab, b_slab, slots,
                       x.dtype)
    return down_torch(x, a_slab, slots)


def lora_up(u: torch.Tensor, a_slab: torch.Tensor, b_slab: torch.Tensor,
            slots: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The up half, ``u @ B[slot]`` in ``dtype`` from f32 ``u``: the
    kernel's up launch on the card, :func:`up_torch` on the CPU."""
    if u.is_cuda:
        return _launch(_UP, None, u.contiguous(), a_slab, b_slab, slots,
                       dtype)
    return up_torch(u, b_slab, slots, dtype)


def check_slots(slots: torch.Tensor, n_slots: int) -> None:
    """Raise unless every slot lies in ``[0, n_slots)``. Reading a card
    tensor's range waits for the card, so a checked card tensor is marked
    with its version: handing the same unmodified vector to every layer
    of a step costs one wait, not one a layer."""
    tag = (slots._version, n_slots)
    if getattr(slots, "_bps_checked", None) == tag:
        return
    if slots.numel():
        lo, hi = torch.stack(torch.aminmax(slots)).tolist()
        if lo < 0 or hi >= n_slots:
            raise ValueError(f"slots must lie in [0, {n_slots}); got "
                             f"[{lo}, {hi}]")
    if slots.is_cuda:
        slots._bps_checked = tag


def segmented_lora_delta(x: torch.Tensor, a_slab: torch.Tensor,
                         b_slab: torch.Tensor, slots: torch.Tensor,
                         row_parallel: bool = False,
                         tp_axis=None) -> torch.Tensor:
    """Per-row LoRA delta of a packed batch of heterogeneous adapters.

    x: ``(R, S, d_in)`` activations (S = 1 in the packed decode step);
    a_slab/b_slab: ``(n_slots, d_in, rb)`` / ``(n_slots, rb, d_out)``
    float32 slot arrays (a strided slot dim is fine: a layer's slice of
    the pool's slabs is passed as it is); slots: ``(R,)`` int32 slot
    indices on x's device. Returns ``(R, S, d_out)`` in x's dtype. A slot
    outside ``[0, n_slots)`` raises.

    ``row_parallel`` with a live ``tp_axis`` (a mesh
    :class:`~byteps_tpu_torch.parallel.mesh.Axis`) is the reference's tp
    contract for ``wo``/``w2``: ``x`` and ``a_slab`` carry this rank's
    share of ``d_in``, and the thin f32 ``u`` is summed over tp between
    the down and the up half (the module docstring). Otherwise one fused
    launch."""
    if x.ndim != 3 or a_slab.ndim != 3 or b_slab.ndim != 3:
        raise ValueError(f"x {tuple(x.shape)}, a_slab {tuple(a_slab.shape)} "
                         f"and b_slab {tuple(b_slab.shape)} must be 3-D")
    n_slots, d_in, rb = a_slab.shape
    if (x.shape[-1] != d_in or b_slab.shape[:2] != (n_slots, rb)
            or slots.shape != (x.shape[0],)):
        raise ValueError(f"shapes do not pair up: x {tuple(x.shape)}, a_slab "
                         f"{tuple(a_slab.shape)}, b_slab "
                         f"{tuple(b_slab.shape)}, slots {tuple(slots.shape)}")
    check_slots(slots, n_slots)
    if row_parallel and tp_axis is not None and tp_axis.size > 1:
        from byteps_tpu_torch.parallel.tp import maybe_psum

        u = maybe_psum(lora_down(x, a_slab, b_slab, slots), tp_axis)
        return lora_up(u, a_slab, b_slab, slots, x.dtype)
    if x.is_cuda:
        return _launch(_FUSED, x.contiguous(), None, a_slab, b_slab, slots,
                       x.dtype)
    return delta_torch(x, a_slab, b_slab, slots)
