"""Stochastic (dithered) quantization (counterpart of
``byteps_tpu/compression/dithering.py``).

Quantizes |x| / ‖x‖ onto s levels with stochastic rounding (unbiased),
keeping the sign; the wire format is int8 levels and one f32 norm.

* ``s``: levels, 1..127 (int8).
* ``partition``: ``"linear"`` (levels i/s) or ``"natural"`` (powers of
  two, 2^-j, denser near zero).
* ``normalize``: ``"l2"`` or ``"max"``.

The uniform draws (:meth:`DitheringCompressor._uniform`, from the key's
generator) are apart from the deterministic apply step
(:meth:`quantize`), which takes them. The natural partition's exponent
is ``floor(log2(p))``, taken exactly from ``torch.frexp``, and
``torch.exp2`` of an integer is exact; the reference's XLA ``exp2`` and
``log2`` are not below 2^-12 on the CPU, so there the two may round a
level differently.
"""

from __future__ import annotations

import torch

from byteps_tpu_torch.compression.base import (
    Compressor,
    Payload,
    generator,
    register_compressor,
)


@register_compressor("dithering")
class DitheringCompressor(Compressor):
    name = "dithering"
    presummable = False  # per-worker norms differ; levels are not summable
    stochastic = True

    def __init__(self, s: int = 127, partition: str = "linear",
                 normalize: str = "l2", **_ignored):
        if partition not in ("linear", "natural"):
            raise ValueError(
                f"partition must be linear|natural, got {partition}")
        if normalize not in ("l2", "max"):
            raise ValueError(f"normalize must be l2|max, got {normalize}")
        if not 1 <= int(s) <= 127:
            raise ValueError(
                f"s must be in [1, 127] (levels are stored int8), got {s}")
        self.s = int(s)
        self.partition = partition
        self.normalize = normalize

    @staticmethod
    def _uniform(key: int, shape, device: torch.device) -> torch.Tensor:
        """Uniform [0, 1) f32 draws of ``shape``, determined by ``key``."""
        return torch.rand(shape, generator=generator(key, device),
                          device=device)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.normalize == "l2":
            return (x * x).sum().sqrt()
        return x.abs().amax()

    def quantize(self, x: torch.Tensor, u: torch.Tensor) -> Payload:
        """The payload of ``x`` given the uniform draws ``u``."""
        xf = x.float()
        norm = self._norm(xf)
        safe = torch.where(norm > 0, norm, 1.0)
        p = xf.abs() / safe                                   # in [0, 1]
        if self.partition == "linear":
            y = p * self.s
            lo = y.floor()
            level = lo + (u < (y - lo)).float()
        else:
            # p = 2^e · m, m in [1, 2): round m to 1 or 2 stochastically,
            # so q is 2^e or 2^(e+1); below 2^-(s-1), q is kept at that
            # level or dropped to 0, unbiased either way
            tiny = 2.0 ** (-(self.s - 1))
            pc = p.clamp(tiny, 1.0)
            m, ex = torch.frexp(pc)          # pc = m · 2^ex, m in [0.5, 1)
            e = ex - 1                       # floor(log2(pc))
            up = u < (2.0 * m - 1.0)         # pc / 2^e − 1, exactly
            keep = (u < p / tiny) | (p >= tiny)
            # level j = log2(q) + s, 0 for a dropped element
            level = torch.where(keep, (e + up.int() + self.s).float(), 0.0)
        levels = (xf.sign() * level).to(torch.int8)
        return {"levels": levels, "norm": norm.reshape(1)}

    def compress(self, x: torch.Tensor, rng=None) -> Payload:
        if rng is None:
            raise ValueError(
                "dithering requires an rng key for stochastic rounding")
        return self.quantize(x, self._uniform(rng, x.shape, x.device))

    def decompress(self, payload: Payload, n: int,
                   dtype: torch.dtype = torch.float32,
                   rng=None) -> torch.Tensor:
        lv = payload["levels"].float()
        norm = payload["norm"][0]
        mag = lv.abs()
        if self.partition == "linear":
            p = mag / self.s
        else:
            p = torch.where(mag > 0, torch.exp2(mag - 1 - (self.s - 1)), 0.0)
        return (lv.sign() * p * norm).to(dtype)

    def compressed_bytes(self, n: int, itemsize: int = 4) -> int:
        return n + 4
