"""Random-k sparsification (counterpart of
``byteps_tpu/compression/randomk.py``).

Keeps k coordinates drawn uniformly without replacement, scaled by n/k
so the estimate is unbiased. The draw depends only on the key, so every
worker given the same key keeps the same coordinates, the payload is
values only, and payloads sum positionally (``presummable``).

The draw (:meth:`RandomkCompressor._indices`: the first k of
``torch.randperm`` from the key's generator) is apart from the
deterministic apply steps (:meth:`compress_at`, :meth:`decompress_at`),
which take the indices.
"""

from __future__ import annotations

from typing import Union

import torch

from byteps_tpu_torch.compression.base import (
    Compressor,
    Payload,
    generator,
    register_compressor,
)
from byteps_tpu_torch.compression.topk import resolve_k


def _require(key, what: str) -> int:
    if key is None:
        raise ValueError(f"randomk {what} requires an rng key (the same on "
                         "every worker)")
    return key


@register_compressor("randomk")
class RandomkCompressor(Compressor):
    name = "randomk"
    stochastic = True

    def __init__(self, k: Union[int, float] = 0.01, scale: bool = True,
                 **_ignored):
        self.k = k
        self.scale = bool(scale)

    @staticmethod
    def _indices(key: int, n: int, k: int,
                 device: torch.device) -> torch.Tensor:
        """k distinct indices of range(n), int32, determined by ``key``."""
        perm = torch.randperm(n, generator=generator(key, device),
                              device=device)
        return perm[:k].to(torch.int32)

    def compress_at(self, x: torch.Tensor, idx: torch.Tensor) -> Payload:
        vals = x.float()[idx.long()]
        if self.scale:
            vals = vals * (x.shape[0] / idx.shape[0])
        return {"values": vals}

    @staticmethod
    def decompress_at(payload: Payload, idx: torch.Tensor, n: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
        vals = payload["values"]
        dense = torch.zeros(n, dtype=torch.float32, device=vals.device)
        return dense.index_add_(0, idx.long(), vals).to(dtype)

    def compress(self, x: torch.Tensor, rng=None) -> Payload:
        key = _require(rng, "compress")
        n = x.shape[0]
        return self.compress_at(
            x, self._indices(key, n, resolve_k(self.k, n), x.device))

    def decompress(self, payload: Payload, n: int,
                   dtype: torch.dtype = torch.float32,
                   rng=None) -> torch.Tensor:
        key = _require(rng, "decompress")
        vals = payload["values"]
        return self.decompress_at(
            payload, self._indices(key, n, vals.shape[0], vals.device), n,
            dtype)

    def compressed_bytes(self, n: int, itemsize: int = 4) -> int:
        return resolve_k(self.k, n) * itemsize
