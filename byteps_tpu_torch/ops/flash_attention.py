"""Flash attention for the port: the plain PyTorch versions, the
autograd Function around them, and the dispatchers that send CUDA tensors
to the hand-written kernels (``csrc/flash_fwd.cu`` forward,
``csrc/flash_bwd.cu`` dq and dk/dv).

Counterpart of ``byteps_tpu/ops/flash_attention.py``. Layout is the
reference's ``(B, S, H, D)``; k/v may carry fewer heads (GQA, ``H`` a
multiple of ``Hkv``). Causal masking compares global positions
``q_offset + i >= k_offset + j``; a row with no live key gives ``o = 0,
lse = -1e30`` and zero gradient. Accumulation is f32 whatever the input
dtype; o comes out in the input dtype, lse in f32.

:func:`flash_attention_lse` goes through :class:`FlashCore`, the
counterpart of the reference's ``_flash_core`` custom VJP: it saves
``q, k, v, o, lse`` and differentiates through both outputs (the lse
cotangent folds into dS, as ring attention needs). Dispatch is by
device: a CUDA tensor goes to the kernels, a CPU tensor to
:func:`attention_lse_torch` and :func:`flash_bwd_torch`. A per-batch
``(B,)`` offset vector (the serve tier's packed decode) always takes the
plain version, as in the reference, whose kernel masks with scalar
offsets only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from byteps_tpu_torch.ops import _build
from byteps_tpu_torch.ops.backend import check_kernel_input, launches

_NEG = -1e30
_MAX_HEAD_DIM = 256

Offset = Union[int, torch.Tensor]


def supported(head_dim: int) -> bool:
    """Whether the kernels take this head dim. Both kernels, forward and
    decode, mask ragged q and k edges themselves, so only the head dim
    is bounded (≤ 256); the reference's 8..256 tile gate belongs to the
    TPU."""
    return 1 <= head_dim <= _MAX_HEAD_DIM


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The kernels' shape contract, checked once by each dispatcher for
    both devices: q (B, Sq, H, D); k and v alike, (B, Sk, Hkv, D), with H
    a multiple of Hkv and D within :func:`supported`."""
    B, _, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv != 0:
        raise ValueError(f"q heads ({H}) not a multiple of kv heads "
                         f"({Hkv})")
    if v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ "
                         "— GQA narrows k and v together")
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if not supported(D):
        raise ValueError(f"head_dim {D} is past the kernels' bound of "
                         f"{_MAX_HEAD_DIM}; gate on supported()")


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernel's golden)
# --------------------------------------------------------------------------
def attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Single-device softmax attention, (B, S, H, D), f32 softmax; twin
    of ``attention_jnp``."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def attention_lse_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offset: Offset, k_offset: int,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of ``attention_lse_jnp``: the (o, lse) contract of
    :func:`flash_attention_lse` at any shape, GQA through a grouped
    einsum (no repeated k/v). ``q_offset`` may be a per-batch ``(B,)``
    tensor: row ``b``'s queries then sit at ``q_offset[b] + arange(Sq)``.
    Returns ``(o (B, Sq, H, D) in q.dtype, lse (B, Sq, H) f32)``."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / (D ** 0.5)
    if Hkv != H:
        g = H // Hkv
        qg = q.reshape(B, Sq, Hkv, g, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
        s = s.reshape(B, H, Sq, Sk)
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        ar_q = torch.arange(Sq, device=q.device)
        cols = k_offset + torch.arange(Sk, device=q.device)
        if isinstance(q_offset, torch.Tensor) and q_offset.ndim == 1:
            rows = q_offset.to(q.device)[:, None, None] + ar_q[None, :, None]
            s = torch.where((rows >= cols[None, None, :])[:, None], s, _NEG)
        else:
            rows = int(q_offset) + ar_q[:, None]
            s = torch.where((rows >= cols[None, :])[None, None], s, _NEG)
    m = s.amax(dim=-1)                                    # (B, H, Sq)
    live = m > _NEG / 2
    m_safe = torch.where(live, m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    if causal:
        p = torch.where(s > _NEG / 2, p, 0.0)
    l = p.sum(dim=-1)
    l_safe = torch.where(l > 0.0, l, 1.0)
    pn = p / l_safe[..., None]
    if Hkv != H:
        pn = pn.reshape(B, Hkv, H // Hkv, Sq, Sk)
        o = torch.einsum("bhgqk,bkhd->bqhgd", pn, v.float())
        o = o.reshape(B, Sq, H, D)
    else:
        o = torch.einsum("bhqk,bkhd->bqhd", pn, v.float())
    o = torch.where(live.transpose(1, 2)[..., None], o, 0.0)
    lse = torch.where(live, m_safe + torch.log(l_safe), _NEG)
    return o.to(q.dtype), lse.transpose(1, 2)             # (B, Sq, H)


def flash_bwd_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    dlse: Optional[torch.Tensor], q_offset: int,
                    k_offset: int, causal: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward of :func:`flash_attention_lse`: the recompute
    formulas of the reference's ``_dq_kernel``/``_dkv_kernel``.

    ``p = exp(s - lse)`` on live pairs (0 elsewhere, so a row with no
    live key gives no gradient), ``dp = dO·Vᵀ``, ``Δ = rowsum(dO∘O)`` in
    f32, ``dS = p∘(dp − Δ + dlse)`` (``dlse`` None means 0). dS rounds to
    the input dtype before the dq/dk products and p to dO's dtype before
    the dv product, as the reference's kernels round them for their MXU
    dots; products accumulate in f32. GQA sums dk/dv over each kv head's
    group. Returns ``(dq, dk, dv)`` in the input dtypes."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / (D ** 0.5)

    def by_group(x: torch.Tensor) -> torch.Tensor:
        # (B, Sq, H) → (B, Hkv, G, Sq)
        return x.float().reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)

    qf = q.float().reshape(B, Sq, Hkv, G, D)
    dof = do.float().reshape(B, Sq, Hkv, G, D)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    p = torch.exp(s - by_group(lse)[..., None])
    if causal:
        rows = q_offset + torch.arange(Sq, device=q.device)[:, None]
        cols = k_offset + torch.arange(Sk, device=q.device)[None, :]
        p = torch.where(rows >= cols, p, 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    delta = by_group((do.float() * o.float()).sum(-1))
    ds = dp - delta[..., None]
    if dlse is not None:
        ds = ds + by_group(dlse)[..., None]
    ds = (p * ds).to(q.dtype).float()
    pr = p.to(do.dtype).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", pr, dof)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# --------------------------------------------------------------------------
# the CUDA kernels
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bps_flash_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                  i, i, ctypes.c_float, p]
    lib.bps_flash_fwd.restype = i
    lib.bps_flash_fwd_route.argtypes = [p, p, p, i, i, i, i, i]
    lib.bps_flash_fwd_route.restype = i
    return lib


def fwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The path the forward kernel takes for these CUDA inputs, as its
    library decides from the shapes, the dtype and the rows' alignment:
    ``"wgmma"`` (bf16 grids that fill the card) or ``"split"``."""
    B, Sq, H, D = q.shape
    tc = _lib().bps_flash_fwd_route(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    int(q.dtype == torch.bfloat16), B, Sq, H,
                                    D)
    return "wgmma" if tc else "split"


def _fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_offset: int, k_offset: int, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on shapes :func:`check_shapes` passed:
    one launch, outputs only. bf16 grids large enough to fill the card
    run on the wgmma path; the others on the split path, whose key splits
    merge inside one thread-block cluster (counted again as
    ``flash_fwd_split``)."""
    check_kernel_input(q, "q")
    for t, name in ((k, "k"), (v, "v")):
        check_kernel_input(t, name, (q.dtype,), q.device)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    lib = _lib()
    split = fwd_route(q, k, v) == "split"
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.bps_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), None, int(q.dtype == torch.bfloat16), B, Sq, Sk,
            H, Hkv, D, int(q_offset), int(k_offset), int(causal),
            1.0 / (D ** 0.5), stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed: {_build.error_string(lib, rc)}")
    launches["flash_fwd"] += 1
    if split:
        launches["flash_fwd_split"] += 1
    return o, lse


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bps_flash_bwd_dq.argtypes = [p] * 8 + [i] * 10 + [ctypes.c_float, p]
    lib.bps_flash_bwd_dq.restype = i
    lib.bps_flash_bwd_dkv.argtypes = [p] * 9 + [i] * 10 + [ctypes.c_float, p]
    lib.bps_flash_bwd_dkv.restype = i
    return lib


def _bwd_sizes(q, k, q_offset, k_offset, causal) -> tuple:
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    return (int(q.dtype == torch.bfloat16), B, Sq, Sk, H, Hkv, D,
            int(q_offset), int(k_offset), int(causal), 1.0 / (D ** 0.5))


def _bwd_inputs(q, k, v, do, lse, delta, dlse) -> tuple:
    """The checks of both backward wrappers; their input pointers."""
    check_kernel_input(q, "q")
    for t, name in ((k, "k"), (v, "v"), (do, "do")):
        check_kernel_input(t, name, (q.dtype,), q.device)
    for t, name in ((lse, "lse"), (delta, "delta"), (dlse, "dlse")):
        if t is not None:
            check_kernel_input(t, name, (torch.float32,), q.device)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if dlse is None else dlse.data_ptr())


def _dq_cuda(q, k, v, do, lse, delta, dlse, q_offset, k_offset,
             causal) -> torch.Tensor:
    """Launch the dq kernel: ``dq`` like q. ``delta`` = rowsum(dO∘O),
    (B, Sq, H) f32; ``dlse`` None means zero."""
    ins = _bwd_inputs(q, k, v, do, lse, delta, dlse)
    dq = torch.empty_like(q)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        rc = lib.bps_flash_bwd_dq(
            *ins, dq.data_ptr(), *_bwd_sizes(q, k, q_offset, k_offset, causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_bwd dq kernel launch failed: "
                           f"{_build.error_string(lib, rc)}")
    launches["flash_bwd_dq"] += 1
    return dq


def _dkv_cuda(q, k, v, do, lse, delta, dlse, q_offset, k_offset,
              causal) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel: ``(dk, dv)`` like k and v, GQA-narrow."""
    ins = _bwd_inputs(q, k, v, do, lse, delta, dlse)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        rc = lib.bps_flash_bwd_dkv(
            *ins, dk.data_ptr(), dv.data_ptr(),
            *_bwd_sizes(q, k, q_offset, k_offset, causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_bwd dkv kernel launch failed: "
                           f"{_build.error_string(lib, rc)}")
    launches["flash_bwd_dkv"] += 1
    return dk, dv


def _bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              dlse: Optional[torch.Tensor], q_offset: int, k_offset: int,
              causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on the card, on shapes :func:`check_shapes` passed:
    Δ = rowsum(dO∘O) as one f32 torch reduction outside the kernels (as
    the reference computes it in XLA outside Pallas), then the dq kernel
    and the dk/dv kernel."""
    check_kernel_input(o, "o", (q.dtype,), q.device)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, dlse, q_offset, k_offset, causal)
    dq = _dq_cuda(*args)
    return (dq, *_dkv_cuda(*args))


class FlashCore(torch.autograd.Function):
    """``(o, lse)`` of causal attention with a hand-written backward: the
    counterpart of the reference's ``_flash_core`` custom VJP. Saves
    ``q, k, v, o, lse``; CUDA tensors run the forward kernel and the two
    backward kernels, CPU tensors the plain versions. A missing lse (or
    o) cotangent counts as zero."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset: int, k_offset: int, causal: bool):
        if q.is_cuda:
            o, lse = _fwd_cuda(q, k, v, q_offset, k_offset, causal)
        else:
            o, lse = attention_lse_torch(q, k, v, q_offset, k_offset,
                                         causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.meta = (q_offset, k_offset, causal)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        q_offset, k_offset, causal = ctx.meta
        do = (torch.zeros_like(o) if do is None
              else do.to(o.dtype).contiguous())
        if dlse is not None:
            dlse = dlse.float().contiguous()
        bwd = _bwd_cuda if q.is_cuda else flash_bwd_torch
        dq, dk, dv = bwd(q, k, v, o, lse, do, dlse, q_offset, k_offset,
                         causal)
        return dq, dk, dv, None, None, None


# --------------------------------------------------------------------------
# dispatchers
# --------------------------------------------------------------------------
def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offset: Offset, k_offset: int,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention with logsumexp and scalar global offsets. q/k/v:
    (B, S, H, D) with k/v narrow under GQA. Returns ``(o (B, Sq, H, D),
    lse (B, Sq, H) f32)``, differentiable through both (:class:`FlashCore`):
    CUDA tensors run the kernels, CPU tensors the plain versions."""
    check_shapes(q, k, v)
    if isinstance(q_offset, torch.Tensor):
        if q_offset.ndim != 0:
            raise ValueError("flash_attention_lse takes a scalar q_offset; "
                             "attention_lse() routes per-row offsets")
        q_offset = int(q_offset)
    return FlashCore.apply(q, k, v, int(q_offset), int(k_offset),
                           bool(causal))


def attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: Offset, k_offset: int, causal: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) attention with global offsets. Scalar offsets take
    :func:`flash_attention_lse`; a per-batch ``(B,)`` q_offset (the serve
    tier's packed decode) takes the plain version, as in the reference."""
    per_row = isinstance(q_offset, torch.Tensor) and q_offset.ndim == 1
    if not per_row and supported(q.shape[-1]):
        return flash_attention_lse(q, k, v, q_offset, k_offset,
                                   causal=causal)
    return attention_lse_torch(q, k, v, q_offset, k_offset, causal=causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention, (B, S, H, D), offsets 0, differentiable: the
    kernels on CUDA tensors where :func:`supported`, the plain version
    otherwise."""
    if supported(q.shape[-1]):
        return flash_attention_lse(q, k, v, 0, 0, causal=causal)[0]
    if k.shape[2] != q.shape[2]:
        return attention_lse_torch(q, k, v, 0, 0, causal=causal)[0]
    return attention_torch(q, k, v, causal=causal)


def merge_attention(o_a: torch.Tensor, lse_a: torch.Tensor,
                    o_b: torch.Tensor, lse_b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine two attention partials over disjoint key sets, the
    reference's ``merge_attention``. o: (B, S, H, D) normalized outputs;
    lse: (B, S, H) f32 logsumexps (−1e30: no live key). A row with no
    live key on one side merges to exactly the other partial. Plain
    differentiable torch ops in f32: gradients reach both o and both lse
    (the flash backward folds an lse cotangent into dS). o comes back in
    ``o_a``'s dtype."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)
    wb = torch.exp(lse_b - m)
    denom = wa + wb
    safe = torch.where(denom > 0.0, denom, torch.ones_like(denom))
    o = (o_a.float() * wa[..., None]
         + o_b.float() * wb[..., None]) / safe[..., None]
    lse = torch.where(denom > 0.0, m + torch.log(safe),
                      torch.full_like(m, _NEG))
    return o.to(o_a.dtype), lse
