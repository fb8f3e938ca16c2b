"""Flash-decode for the port: single-token cached attention, dispatched
by device to the hand-written kernel (``csrc/flash_decode.cu``) or to
its plain PyTorch version.

Counterpart of ``byteps_tpu/ops/flash_decode.py``. The contract is the
reference's (its module docstring, lines 37-41): for a query at global
position ``pos`` the result equals ``attention_lse(q, K, V, pos, 0)``
restricted to the live prefix ``0..pos``, where K/V is the cache read
in the model dtype (int8 entries: ``f32(q) * scale`` rounded to the
model dtype). Accumulation is f32; the output is in q's dtype.

On the card the live prefix is cut into splits of whole 32-key tiles
(:func:`decode_plan`), one block per (kv head, sequence, split); the
splits of a (sequence, kv head) pair form one thread-block cluster and
merge their partial states in split order through distributed shared
memory, in the same launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from byteps_tpu_torch.ops import _build
from byteps_tpu_torch.ops.backend import check_kernel_input, launches
from byteps_tpu_torch.ops.flash_attention import (
    attention_lse_torch,
    check_shapes,
)

__all__ = ["flash_decode", "decode_torch", "decode_plan"]

TILE_KEYS = 32   # keys of the kernel's staged tile
MAX_SPLITS = 16  # the kernel's largest cluster


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


def decode_plan(live: int, B: int, Hkv: int, sms: int,
                most: int = MAX_SPLITS) -> Tuple[int, int]:
    """How the kernel cuts a live prefix of ``live`` keys across blocks:
    ``(n_split, split_tiles)``, split s taking the 32-key tiles
    ``[s * split_tiles, (s + 1) * split_tiles)`` of the prefix (the last
    split may hold fewer, never none). The grid has ``B * Hkv * n_split``
    blocks: at least one wave of ``sms`` wherever the live tiles allow
    it in at most ``most`` splits (the kernel's cap for the shapes), with
    about as few splits as that takes, since each split costs its
    cluster a merge and on an H100 a second wave of splits was slower at
    the long prefixes. A function of its arguments only, so a decode
    step's sum order is fixed."""
    tiles = -(-live // TILE_KEYS)
    pairs = max(1, B * Hkv)
    want = min(tiles, most, -(-sms // pairs))
    split_tiles = max(tiles // want, -(-tiles // most))
    return -(-tiles // split_tiles), split_tiles


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bps_flash_decode.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                     i, i, i, ctypes.c_float, p]
    lib.bps_flash_decode.restype = i
    lib.bps_flash_decode_max_splits.argtypes = [i, i, i, i]
    lib.bps_flash_decode_max_splits.restype = i
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
    # the most splits whose partial states fit split 0's shared memory
    most = lib.bps_flash_decode_max_splits(H // Hkv, D,
                                           k_cache.element_size(),
                                           int(quant))
    n_split, split_tiles = decode_plan(pos + 1, B, Hkv,
                                       _sm_count(q.device.index), most)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.bps_flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, o.data_ptr(),
            int(q.dtype == torch.bfloat16), int(quant), B, S, Hkv, H // Hkv,
            D, pos, n_split, split_tiles, 1.0 / (D ** 0.5), stream)
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
