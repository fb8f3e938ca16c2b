"""Onebit pack and unpack-sum: the plain PyTorch versions and the
dispatchers that send CUDA tensors to the hand-written kernels
(``csrc/onebit.cu``).

Counterpart of ``byteps_tpu/ops/onebit_kernels.py``, with its wire
layout kept bit for bit: the flat input, padded with zeros to ``32·L``
(``L = packed_words(n)``, a multiple of 128), is viewed as ``(32, L)``,
and bit k of word j is ``x[k·L + j] >= 0``. Padding therefore packs as 1,
-0.0 as 1 and NaN as 0. Words are int32 tensors holding the uint32 bits
(``words.numpy().view(np.uint32)`` equals the reference's words):
``torch.uint32`` has thin op coverage.

``onebit_unpack_sum`` adds the K payloads in the reference's order, so
kernel, plain version and reference agree bit for bit. Up to 32 payloads
(``_make_unpack_sum_kernel``) it folds them in order r = 0..K-1 from
0.0, as ``_rows_unpack_acc`` does. Above 32 (``_make_unpack_sum_grid_kernel``)
it pads K to a multiple of 8 with zero-scale rows, folds each block of
8 rows from 0.0, and adds the block partials into the output in block
order; those launches count as ``onebit_unpack_sum_grid``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from byteps_tpu_torch.ops import _build
from byteps_tpu_torch.ops.backend import check_kernel_input, launches

_LANES = 128
_BITS = 32
# the reference's unrolled unpack-sum takes up to this many payloads;
# above it, its grid kernel folds them in blocks of _GRID_ROWS
_UNROLL_K_MAX = 32
_GRID_ROWS = 8


def packed_words(n: int) -> int:
    """Words on the wire for n elements: ceil(n/32), lane-padded to 128."""
    m = -(-n // _BITS)
    return -(-m // _LANES) * _LANES


def _pad_len(n: int) -> int:
    return packed_words(n) * _BITS


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernels' golden)
# --------------------------------------------------------------------------
def _pack_torch(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    L = packed_words(n)
    xp = torch.zeros(L * _BITS, dtype=torch.float32, device=x.device)
    xp[:n] = x
    bits = (xp.reshape(_BITS, L) >= 0).to(torch.int64)
    shifts = torch.arange(_BITS, device=x.device, dtype=torch.int64)[:, None]
    words = (bits << shifts).sum(dim=0)                 # < 2^32, exact
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _rows_unpack_acc(words: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """Σ_r signs(words[r])·scales[r] folded in order r = 0.. from 0.0,
    as (32, L)."""
    shifts = torch.arange(_BITS, device=words.device,
                          dtype=torch.int32)[:, None]
    acc = torch.zeros((_BITS, words.shape[1]), dtype=torch.float32,
                      device=words.device)
    for r in range(words.shape[0]):
        bits = (words[r][None, :] >> shifts) & 1           # (32, L)
        acc = acc + (bits.to(torch.float32) * 2.0 - 1.0) * scales[r]
    return acc


def _unpack_sum_torch(words: torch.Tensor, scales: torch.Tensor,
                      n: int) -> torch.Tensor:
    K = words.shape[0]
    if K <= _UNROLL_K_MAX:
        return _rows_unpack_acc(words, scales).reshape(-1)[:n]
    kp = -(-K // _GRID_ROWS) * _GRID_ROWS
    words = torch.nn.functional.pad(words, (0, 0, 0, kp - K))
    scales = torch.nn.functional.pad(scales, (0, kp - K))
    acc = None
    for b in range(0, kp, _GRID_ROWS):
        part = _rows_unpack_acc(words[b:b + _GRID_ROWS],
                                scales[b:b + _GRID_ROWS])
        acc = part if acc is None else acc + part
    return acc.reshape(-1)[:n]


# --------------------------------------------------------------------------
# the CUDA kernels
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("onebit")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bps_onebit_pack.argtypes = [p, p, ll, i, p]
    lib.bps_onebit_pack.restype = i
    for fn in (lib.bps_onebit_unpack_sum, lib.bps_onebit_unpack_sum_grid):
        fn.argtypes = [p, p, p, i, i, ll, p]
        fn.restype = i
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _pack_cuda(x: torch.Tensor) -> torch.Tensor:
    check_kernel_input(x, "x", (torch.float32,))
    n = x.shape[0]
    L = packed_words(n)
    words = torch.empty(L, dtype=torch.int32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.bps_onebit_pack(x.data_ptr(), words.data_ptr(), n, L,
                                 _stream(x))
    if rc != 0:
        raise RuntimeError("onebit pack kernel launch failed: "
                           f"{_build.error_string(lib, rc)}")
    launches["onebit_pack"] += 1
    return words


def _unpack_sum_cuda(words: torch.Tensor, scales: torch.Tensor,
                     n: int) -> torch.Tensor:
    check_kernel_input(words, "words", (torch.int32,))
    check_kernel_input(scales, "scales", (torch.float32,), words.device)
    K, L = words.shape
    out = torch.empty(n, dtype=torch.float32, device=words.device)
    lib = _lib()
    grid = K > _UNROLL_K_MAX
    fn = lib.bps_onebit_unpack_sum_grid if grid else lib.bps_onebit_unpack_sum
    with torch.cuda.device(words.device):
        rc = fn(words.data_ptr(), scales.data_ptr(), out.data_ptr(), K, L, n,
                _stream(words))
    if rc != 0:
        raise RuntimeError("onebit unpack_sum kernel launch failed: "
                           f"{_build.error_string(lib, rc)}")
    launches["onebit_unpack_sum_grid" if grid else "onebit_unpack_sum"] += 1
    return out


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------
def onebit_pack(x: torch.Tensor) -> torch.Tensor:
    """Flat f32 (n,) → (L,) int32 sign words (L = packed_words(n))."""
    if x.ndim != 1:
        raise ValueError(f"onebit_pack takes a flat vector; got {x.shape}")
    x = x.float()
    if x.is_cuda:
        return _pack_cuda(x.contiguous())
    return _pack_torch(x)


def onebit_unpack_sum(words: torch.Tensor, scales: torch.Tensor,
                      n: int) -> torch.Tensor:
    """(K, L) sign words + (K,) scales → Σ_k signs_k·scale_k as f32 (n,)."""
    if words.ndim != 2 or scales.shape != (words.shape[0],):
        raise ValueError(f"words {tuple(words.shape)} and scales "
                         f"{tuple(scales.shape)} do not pair up as (K, L), "
                         "(K,)")
    if not 0 <= n <= words.shape[1] * _BITS:
        raise ValueError(f"n={n} outside the payload's "
                         f"{words.shape[1] * _BITS} elements")
    scales = scales.float()
    if words.is_cuda:
        return _unpack_sum_cuda(words.contiguous(), scales.contiguous(), n)
    return _unpack_sum_torch(words, scales, n)


def onebit_unpack(words: torch.Tensor, scale: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Single-payload decompress: (L,) words + scalar scale → (n,) f32."""
    return onebit_unpack_sum(words[None], scale.reshape(1), n)
