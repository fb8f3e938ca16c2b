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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from byteps_tpu_torch.ops import _build
from byteps_tpu_torch.ops.backend import check_kernel_input, launches

__all__ = ["segmented_lora_delta", "delta_torch", "MAX_RANK"]

# the kernel's largest rank bucket (its shared arrays are sized by it)
MAX_RANK = 64


def delta_torch(x: torch.Tensor, a_slab: torch.Tensor, b_slab: torch.Tensor,
                slots: torch.Tensor) -> torch.Tensor:
    """The plain version: gather each row's slabs, ``u = Σ_k x·A`` in f32,
    then ``Σ_j u_j·B_j`` added in rank order, cast to x's dtype."""
    idx = slots.long()
    a = a_slab[idx].float()                              # (R, d_in, rb)
    b = b_slab[idx].float()                              # (R, rb, d_out)
    u = (x.float()[..., :, None] * a[:, None]).sum(-2)   # (R, S, rb)
    out = u[..., 0:1] * b[:, None, 0]
    for j in range(1, b.shape[1]):
        out = out + u[..., j:j + 1] * b[:, None, j]
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("segmented_lora")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bps_segmented_lora.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ll,
                                       ll, i, p]
    lib.bps_segmented_lora.restype = i
    return lib


def _slab_ok(t: torch.Tensor) -> bool:
    """The kernel reads a slab through its slot stride: the two inner
    dims must be contiguous; the slot stride is free."""
    return t.stride(2) == 1 and t.stride(1) == t.shape[2]


def _delta_cuda(x: torch.Tensor, a_slab: torch.Tensor, b_slab: torch.Tensor,
                slots: torch.Tensor) -> torch.Tensor:
    check_kernel_input(x, "x")
    for name, t in (("a_slab", a_slab), ("b_slab", b_slab)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must live on {x.device}; got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}")
        if not _slab_ok(t):
            raise ValueError(f"{name}'s two inner dims must be contiguous; "
                             f"strides {t.stride()}")
    check_kernel_input(slots, "slots", (torch.int32,), x.device)
    R, S, d_in = x.shape
    n_slots, _, rb = a_slab.shape
    d_out = b_slab.shape[-1]
    if rb > MAX_RANK:
        raise ValueError(f"the kernel takes ranks up to {MAX_RANK}; got {rb}")
    out = torch.empty((R, S, d_out), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.bps_segmented_lora(
            x.data_ptr(), a_slab.data_ptr(), b_slab.data_ptr(),
            slots.data_ptr(), out.data_ptr(), R, S, d_in, rb, d_out, n_slots,
            a_slab.stride(0), b_slab.stride(0),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("segmented LoRA kernel launch failed: "
                           f"{_build.error_string(lib, rc)}")
    launches["segmented_lora"] += 1
    return out


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
                         b_slab: torch.Tensor,
                         slots: torch.Tensor) -> torch.Tensor:
    """Per-row LoRA delta of a packed batch of heterogeneous adapters.

    x: ``(R, S, d_in)`` activations (S = 1 in the packed decode step);
    a_slab/b_slab: ``(n_slots, d_in, rb)`` / ``(n_slots, rb, d_out)``
    float32 slot arrays (a strided slot dim is fine: a layer's slice of
    the pool's slabs is passed as it is); slots: ``(R,)`` int32 slot
    indices on x's device. Returns ``(R, S, d_out)`` in x's dtype. A slot
    outside ``[0, n_slots)`` raises. ``row_parallel``/``tp_axis`` wait
    for tensor parallelism."""
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
    if x.is_cuda:
        return _delta_cuda(x.contiguous(), a_slab, b_slab, slots)
    return delta_torch(x, a_slab, b_slab, slots)
