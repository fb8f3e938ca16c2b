"""Top-k sparsification (counterpart of ``byteps_tpu/compression/topk.py``).

Keeps k coordinates; the wire format is (index, value) pairs. ``k`` is a
count or a ratio in (0, 1] of each chunk's length. Three selections,
one wire format:

* ``"exact"`` (default): the k largest |x|, ``torch.topk`` sorted, as
  the reference's ``lax.top_k``.
* ``"approx"``: the reference's ``lax.approx_max_k``, which off the TPU
  computes the exact top k; here it is ``"exact"`` (its ``approx`` and
  ``recall_target`` keywords have nothing to tune and are ignored).
* ``"block"``: one first-max winner per block, on the reference's
  layouts. A chunk whose k and length are multiples of 128 with
  ``(n/128) % (k/128) == 0`` is viewed as ``(J, g, 128)``
  (:func:`tiled_shape`): one winner per (j, lane) over g, and its
  single-worker round trip is one fused kernel
  (``ops.topk_kernels.block_roundtrip``). Any other chunk takes the
  strided ``(block, rows)`` layout (:func:`block_shape`), lane c's block
  being ``{c, c+rows, ...}``: selection through
  ``ops.topk_kernels.block_select`` (for a ragged chunk, with the
  chunk's length, so its padding never wins) and reconstruction through
  ``block_reconstruct_sum``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from byteps_tpu_torch.compression.base import (
    Compressor,
    Payload,
    register_compressor,
)
from byteps_tpu_torch.ops.topk_kernels import (
    block_reconstruct_sum,
    block_roundtrip,
    block_select,
    first_max,
)

_SELECTIONS = ("exact", "approx", "block")
_LANES = 128


def resolve_k(k: Union[int, float], n: int) -> int:
    if isinstance(k, float) and 0 < k <= 1:
        return max(1, int(n * k))
    return max(1, min(int(k), n))


def block_shape(k: Union[int, float], n: int) -> tuple:
    """(rows, block) with rows·block >= n covering n with about k winner
    rows: the strided layout."""
    kk = resolve_k(k, n)
    block = -(-n // kk)
    rows = -(-n // block)
    return rows, block


def tiled_shape(k: Union[int, float], n: int):
    """(J, g) of the ``(J, g, 128)`` layout, or None when (k, n) does not
    tile: then the strided layout applies."""
    kk = resolve_k(k, n)
    if kk % _LANES or n % _LANES or kk >= n:
        return None
    J, M = kk // _LANES, n // _LANES
    if M % J:
        return None
    return J, M // J


def _tiled_local(idx: torch.Tensor, J: int, g: int) -> torch.Tensor:
    """Winner group index per (j, lane) from tiled flat indices."""
    jj = torch.arange(J, dtype=idx.dtype, device=idx.device)[:, None]
    return idx.reshape(J, _LANES) // _LANES - jj * g


@register_compressor("topk")
class TopkCompressor(Compressor):
    name = "topk"
    presummable = False  # supports differ between workers: densify to sum

    def __init__(self, k: Union[int, float] = 0.01,
                 selection: str = "exact", **_ignored):
        self.k = k
        self.selection = selection
        if selection not in _SELECTIONS:
            raise ValueError(f"unknown selection {selection!r} — "
                             f"expected one of {_SELECTIONS}")

    def compress(self, x: torch.Tensor, rng=None) -> Payload:
        n = x.shape[0]
        k = resolve_k(self.k, n)
        xf = x.float()
        if self.selection == "block" and k < n:
            tiled = tiled_shape(self.k, n)
            if tiled is not None:
                J, g = tiled
                x3 = xf.reshape(J, g, _LANES)
                local = first_max(x3.abs(), 1)               # (J, 1, 128)
                ii = torch.arange(g, dtype=torch.int32,
                                  device=x.device)[None, :, None]
                vals = torch.where(ii == local, x3, 0.0).sum(dim=1)
                local = local[:, 0]
                lane = torch.arange(_LANES, dtype=torch.int32,
                                    device=x.device)[None, :]
                jj = torch.arange(J, dtype=torch.int32,
                                  device=x.device)[:, None]
                idx = (jj * g + local) * _LANES + lane
                return {"indices": idx.reshape(-1),
                        "values": vals.reshape(-1)}
            rows, block = block_shape(self.k, n)
            pad = rows * block - n
            if pad:
                xf = torch.nn.functional.pad(xf, (0, pad))
            local, vals = block_select(xf.reshape(block, rows), n)
            idx = local * rows + torch.arange(rows, dtype=torch.int32,
                                              device=x.device)
            return {"indices": idx, "values": vals}
        # exact; "approx" is exact off the TPU; k == n keeps everything
        idx = torch.topk(xf.abs(), k).indices
        return {"indices": idx.to(torch.int32), "values": xf[idx]}

    def decompress(self, payload: Payload, n: int,
                   dtype: torch.dtype = torch.float32,
                   rng=None) -> torch.Tensor:
        idx, vals = payload["indices"], payload["values"].float()
        tiled = tiled_shape(self.k, n)
        if (self.selection == "block" and tiled is not None
                and idx.shape[0] == resolve_k(self.k, n)):
            J, g = tiled
            ii = torch.arange(g, dtype=idx.dtype,
                              device=idx.device)[None, :, None]
            dense = torch.where(ii == _tiled_local(idx, J, g)[:, None, :],
                                vals.reshape(J, 1, _LANES), 0.0)
            return dense.reshape(-1).to(dtype)
        rows, block = block_shape(self.k, n)
        if self.selection == "block" and idx.shape[0] == rows and block > 1:
            lane = torch.arange(rows, dtype=idx.dtype, device=idx.device)
            dense = block_reconstruct_sum(((idx - lane) // rows)[None],
                                          vals[None], block)
            return dense.reshape(-1)[:n].to(dtype)
        dense = torch.zeros(n, dtype=torch.float32, device=vals.device)
        return dense.index_add_(0, idx.long(), vals).to(dtype)

    def roundtrip(self, x: torch.Tensor, rng=None,
                  e: Optional[torch.Tensor] = None):
        """The single-worker aggregation body: on the tiled layout one
        fused kernel pass (EF add, selection, reconstruction, residual),
        else compress then decompress. Both select the same support, so
        n == 1 and n > 1 compress alike."""
        n = x.shape[0]
        tiled = (tiled_shape(self.k, n)
                 if self.selection == "block" else None)
        if tiled is None:
            return super().roundtrip(x, rng, e)
        J, g = tiled
        return block_roundtrip(x, J, g, e=e)

    def decompress_sum(self, payloads: Payload, n: int,
                       dtype: torch.dtype = torch.float32,
                       rng_keys=None) -> torch.Tensor:
        """Σ_k decompress(payload_k) over K stacked payloads, in order
        k = 0..K-1, without K dense temporaries on the block layouts: on
        the tiled layout from zeros (as the reference's sum there), on
        the strided one through ``block_reconstruct_sum``."""
        idx = payloads["indices"]
        vals = payloads["values"].float()
        tiled = tiled_shape(self.k, n)
        if (self.selection == "block" and tiled is not None
                and idx.ndim == 2 and idx.shape[1] == resolve_k(self.k, n)):
            J, g = tiled
            ii = torch.arange(g, dtype=idx.dtype,
                              device=idx.device)[None, :, None]
            # from zeros, as the reference: a lone -0.0 comes back 0.0
            acc = torch.zeros((J, g, _LANES), dtype=torch.float32,
                              device=vals.device)
            for ki in range(idx.shape[0]):
                acc = acc + torch.where(
                    ii == _tiled_local(idx[ki], J, g)[:, None, :],
                    vals[ki].reshape(J, 1, _LANES), 0.0)
            return acc.reshape(-1).to(dtype)
        rows, block = block_shape(self.k, n)
        if (self.selection == "block" and idx.ndim == 2
                and idx.shape[1] == rows and block > 1):
            lane = torch.arange(rows, dtype=idx.dtype, device=idx.device)
            dense = block_reconstruct_sum((idx - lane[None, :]) // rows,
                                          vals, block)
            return dense.reshape(-1)[:n].to(dtype)
        return super().decompress_sum(payloads, n, dtype, rng_keys)

    def compressed_bytes(self, n: int, itemsize: int = 4) -> int:
        if self.selection == "block":
            rows, _ = block_shape(self.k, n)
            return rows * (4 + itemsize)
        return resolve_k(self.k, n) * (4 + itemsize)
