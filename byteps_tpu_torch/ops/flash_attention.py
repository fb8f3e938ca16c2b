"""Flash attention for the port: the plain PyTorch versions and the
dispatchers that send CUDA tensors to the hand-written forward kernel
(``csrc/flash_fwd.cu``).

Counterpart of ``byteps_tpu/ops/flash_attention.py`` (forward only: the
backward kernels come with the training slice). Layout is the
reference's ``(B, S, H, D)``; k/v may carry fewer heads (GQA, ``H`` a
multiple of ``Hkv``). Causal masking compares global positions
``q_offset + i >= k_offset + j``; a row with no live key gives ``o = 0,
lse = -1e30``. Accumulation is f32 whatever the input dtype; o comes
out in the input dtype, lse in f32.

Dispatch is by device: a CUDA tensor goes to the kernel, a CPU tensor
to :func:`attention_lse_torch`. A per-batch ``(B,)`` offset vector (the
serve tier's packed decode) always takes the plain version, as in the
reference, whose kernel masks with scalar offsets only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

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


# --------------------------------------------------------------------------
# the CUDA kernel
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bps_flash_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                  i, i, ctypes.c_float, p]
    lib.bps_flash_fwd.restype = i
    lib.bps_flash_fwd_workspace.argtypes = [i] * 8
    lib.bps_flash_fwd_workspace.restype = ctypes.c_longlong
    return lib


def _fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_offset: int, k_offset: int, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on shapes :func:`check_shapes` passed.
    Keys are cut into fixed splits across blocks; when a row's live keys
    span more than one, the kernel needs an f32 workspace for the
    partial states, allocated here."""
    check_kernel_input(q, "q")
    for t, name in ((k, "k"), (v, "v")):
        check_kernel_input(t, name, (q.dtype,), q.device)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    lib = _lib()
    sizes = (B, Sq, Sk, H, D, int(q_offset), int(k_offset), int(causal))
    ws_bytes = lib.bps_flash_fwd_workspace(*sizes)
    ws = (torch.empty(ws_bytes // 4, dtype=torch.float32, device=q.device)
          if ws_bytes else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.bps_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), None if ws is None else ws.data_ptr(),
            int(q.dtype == torch.bfloat16), B, Sq, Sk, H, Hkv, D,
            int(q_offset), int(k_offset), int(causal), 1.0 / (D ** 0.5),
            stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed: {_build.error_string(lib, rc)}")
    launches["flash_fwd"] += 1
    return o, lse


# --------------------------------------------------------------------------
# dispatchers
# --------------------------------------------------------------------------
def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offset: Offset, k_offset: int,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention with logsumexp and scalar global offsets. q/k/v:
    (B, S, H, D) with k/v narrow under GQA. Returns ``(o (B, Sq, H, D),
    lse (B, Sq, H) f32)``. CUDA tensors run the forward kernel, CPU
    tensors :func:`attention_lse_torch`."""
    check_shapes(q, k, v)
    if isinstance(q_offset, torch.Tensor):
        if q_offset.ndim != 0:
            raise ValueError("flash_attention_lse takes a scalar q_offset; "
                             "attention_lse() routes per-row offsets")
        q_offset = int(q_offset)
    if q.is_cuda:
        return _fwd_cuda(q, k, v, q_offset, k_offset, causal)
    return attention_lse_torch(q, k, v, q_offset, k_offset, causal=causal)


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
    """Softmax attention, (B, S, H, D), offsets 0: the forward kernel on
    CUDA tensors where :func:`supported`, the plain version otherwise."""
    if supported(q.shape[-1]):
        return flash_attention_lse(q, k, v, 0, 0, causal=causal)[0]
    if k.shape[2] != q.shape[2]:
        return attention_lse_torch(q, k, v, 0, 0, causal=causal)[0]
    return attention_torch(q, k, v, causal=causal)
