"""1-bit sign compression (counterpart of
``byteps_tpu/compression/onebit.py``).

Wire format: sign bits in the reference's ``(32, L)`` transposed layout
(bit k of word j = padded element ``k·L + j``; ``ops/onebit_kernels.py``)
plus one f32 scale. ``scaling=True`` sets scale = mean(|x|), so
decompress returns ±mean|x|; otherwise ±1. The kwarg defaults to
``BYTEPS_COMPRESSOR_ONEBIT_SCALING`` (on). Pack and the fused
unpack-sum run the hand-written kernels on CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.compression.base import (
    Compressor,
    Payload,
    register_compressor,
)
from byteps_tpu_torch.ops.onebit_kernels import (
    onebit_pack,
    onebit_unpack,
    onebit_unpack_sum,
    packed_words,
)


@register_compressor("onebit")
class OnebitCompressor(Compressor):
    name = "onebit"
    presummable = False  # signs cannot be summed; must decompress first

    def __init__(self, scaling: Optional[bool] = None, **_ignored):
        if scaling is None:
            scaling = get_config().compressor_onebit_scaling
        self.scaling = bool(scaling)

    def compress(self, x: torch.Tensor, rng=None) -> Payload:
        xf = x.float()
        words = onebit_pack(xf)
        if self.scaling:
            scale = xf.abs().mean().reshape(1)
        else:
            scale = torch.ones(1, dtype=torch.float32, device=x.device)
        return {"signs": words, "scale": scale}

    def decompress(self, payload: Payload, n: int,
                   dtype: torch.dtype = torch.float32,
                   rng=None) -> torch.Tensor:
        return onebit_unpack(payload["signs"], payload["scale"], n).to(dtype)

    def decompress_sum(self, payloads: Payload, n: int,
                       dtype: torch.dtype = torch.float32,
                       rng_keys=None) -> torch.Tensor:
        # fused kernel: one pass over the K payloads
        return onebit_unpack_sum(payloads["signs"], payloads["scale"][:, 0],
                                 n).to(dtype)

    def compressed_bytes(self, n: int, itemsize: int = 4) -> int:
        return 4 * packed_words(n) + 4
