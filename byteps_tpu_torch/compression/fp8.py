"""Scaled fp8 (e4m3) compression (counterpart of
``byteps_tpu/compression/fp8.py``): one f32 absmax scale per chunk and
one ``torch.float8_e4m3fn`` byte per element, x / scale clipped to
±448 (the largest finite e4m3fn value) and rounded to nearest even."""

from __future__ import annotations

import torch

from byteps_tpu_torch.compression.base import (
    Compressor,
    Payload,
    register_compressor,
)

FP8_MAX = 448.0


@register_compressor("fp8")
class Fp8Compressor(Compressor):
    name = "fp8"
    # per-worker scales differ: positional byte sums do not commute
    presummable = False

    def __init__(self, **_ignored):
        pass

    def compress(self, x: torch.Tensor, rng=None) -> Payload:
        xf = x.float()
        absmax = xf.abs().amax()
        scale = torch.where(absmax > 0, absmax / FP8_MAX, 1.0)
        q = (xf / scale).clamp(-FP8_MAX, FP8_MAX)
        return {"values": q.to(torch.float8_e4m3fn), "scale": scale}

    def decompress(self, payload: Payload, n: int,
                   dtype: torch.dtype = torch.float32,
                   rng=None) -> torch.Tensor:
        return (payload["values"].float() * payload["scale"]).to(dtype)

    def compressed_bytes(self, n: int, itemsize: int = 4) -> int:
        return 4 + n
