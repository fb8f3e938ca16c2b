"""Flash-decode for the port: single-token cached attention, dispatched
by device to the hand-written kernel (``csrc/flash_decode.cu``) or to
its plain PyTorch version.

Counterpart of ``byteps_tpu/ops/flash_decode.py``. The contract is the
reference's (its module docstring, lines 37-41): for a query at global
position ``pos`` the result equals ``attention_lse(q, K, V, pos, 0)``
restricted to the live prefix ``0..pos``, where K/V is the cache read
in the model dtype (int8 entries: ``f32(q) * scale`` rounded to the
model dtype). Accumulation is f32; the output is in q's dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from byteps_tpu_torch.ops import _build
from byteps_tpu_torch.ops.backend import check_kernel_input, launches
from byteps_tpu_torch.ops.flash_attention import (
    attention_lse_torch,
    check_shapes,
)

__all__ = ["flash_decode", "decode_torch"]


def _read(cache: torch.Tensor, scale: Optional[torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """The attention-ready view: int8 entries dequantize through their
    scales and round to ``dtype`` (``generate._cache_read``'s rule)."""
    if scale is None:
        return cache
    return (cache.float() * scale[..., None]).to(dtype)


def decode_torch(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: int,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: :func:`attention_lse_torch` over the live
    prefix ``0..pos`` of the cache, read in q's dtype."""
    live = pos + 1
    k = _read(k_cache[:, :live], None if k_scale is None
              else k_scale[:, :live], q.dtype)
    v = _read(v_cache[:, :live], None if v_scale is None
              else v_scale[:, :live], q.dtype)
    o, _ = attention_lse_torch(q, k, v, pos, 0, causal=True)
    return o


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bps_flash_decode.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                     i, ctypes.c_float, p]
    lib.bps_flash_decode.restype = i
    return lib


def _decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: int,
                 k_scale: Optional[torch.Tensor],
                 v_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the decode kernel on shapes :func:`flash_decode` passed."""
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    quant = k_scale is not None
    check_kernel_input(q, "q")
    cache_dtypes = (torch.int8,) if quant else (q.dtype,)
    check_kernel_input(k_cache, "k_cache", cache_dtypes, q.device)
    check_kernel_input(v_cache, "v_cache", cache_dtypes, q.device)
    if quant:
        check_kernel_input(k_scale, "k_scale", (torch.float32,), q.device)
        check_kernel_input(v_scale, "v_scale", (torch.float32,), q.device)
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.bps_flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, o.data_ptr(),
            int(q.dtype == torch.bfloat16), int(quant), B, S, Hkv, H // Hkv,
            D, pos, 1.0 / (D ** 0.5), stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_decode kernel launch failed: "
            f"{_build.error_string(lib, rc)}")
    launches["flash_decode"] += 1
    return o


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: int,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token cached attention: ``q (B, 1, H, D)`` against the
    stored cache ``k/v (B, S, Hkv, D)`` (int8 when ``k_scale/v_scale
    (B, S, Hkv)`` are given, else q's dtype), attending to global key
    positions ``≤ pos``. Returns ``o (B, 1, H, D)`` in q.dtype. CUDA
    tensors run the decode kernel, CPU tensors :func:`decode_torch`."""
    if q.shape[1] != 1:
        raise ValueError(f"flash_decode is the T=1 step; got T={q.shape[1]}")
    check_shapes(q, k_cache, v_cache)
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    for s, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
        if s is not None and s.shape != k_cache.shape[:3]:
            raise ValueError(f"{name} {tuple(s.shape)} does not match the "
                             f"cache {tuple(k_cache.shape)}")
    pos = int(pos)
    if not 0 <= pos < k_cache.shape[1]:
        raise ValueError(f"pos {pos} outside the cache "
                         f"(S={k_cache.shape[1]})")
    if q.is_cuda:
        return _decode_cuda(q, k_cache, v_cache, pos, k_scale, v_scale)
    return decode_torch(q, k_cache, v_cache, pos, k_scale, v_scale)
