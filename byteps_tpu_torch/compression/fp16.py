"""IEEE-half compression (counterpart of ``byteps_tpu/compression/fp16.py``):
values cast to float16 and back, round to nearest even."""

from __future__ import annotations

import torch

from byteps_tpu_torch.compression.base import (
    Compressor,
    Payload,
    register_compressor,
)


@register_compressor("fp16")
class Fp16Compressor(Compressor):
    name = "fp16"
    presummable = True  # linear codec: positional sums commute with decode

    def __init__(self, **_ignored):
        pass

    def compress(self, x: torch.Tensor, rng=None) -> Payload:
        return {"values": x.to(torch.float16)}

    def decompress(self, payload: Payload, n: int,
                   dtype: torch.dtype = torch.float32,
                   rng=None) -> torch.Tensor:
        return payload["values"].to(dtype)

    def compressed_bytes(self, n: int, itemsize: int = 4) -> int:
        return n * 2
