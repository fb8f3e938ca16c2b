"""Host-side (numpy) wire codecs for the DCN parameter-server tier (the
port's copy of ``byteps_tpu/compression/wire.py``: the same bytes for the
same input and seed).

Reference analog: the worker half of byteps's compression feature — the
COMPRESS/DECOMPRESS stages around PUSH/PULL in
``byteps/common/core_loops.cc``, whose byte formats the server
(``byteps/server/server.cc``) decompresses, fp32-sums, and re-compresses.
The byte layouts here must match ``server/csrc/codec.cc`` bit-exactly; the
formats are documented in ``server/csrc/codec.h``.

These are deliberately host implementations: the pipeline's COMPRESS
stage runs on scheduler pool threads, after the gradient left the card
(the hand-written kernels of ``ops/`` serve the in-group collectives
instead). Stochastic choices (randomk support, dithering rounding) derive
only from a caller-supplied integer seed so every worker agrees where it
must. The e4m3 cast of :class:`Fp8Wire` is torch's
``float8_e4m3fn`` conversion (round to nearest even), which gives the
reference's ml_dtypes bytes on the clipped range it is fed.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np
import torch

from byteps_tpu_torch.compression.error_feedback import CompressionSpec
from byteps_tpu_torch.compression.topk import (block_shape, resolve_k,
                                               tiled_shape)


def wire_seed(name: str, version: int, part_idx: int, salt: int = 0) -> int:
    """THE deterministic per-(tensor, round, partition) codec seed.

    Every party that encodes or decodes a given partition round — the
    COMPRESS/DECOMPRESS stages of every worker, and (positionally) the
    summation server — must draw stochastic codec choices (randomk
    support, dithering rounding) from the SAME seed, or payloads stop
    being summable. This is the single definition of that contract;
    ``salt`` carries a CompressionSpec's user seed where one exists.
    zlib.crc32 is stable across processes/runs, unlike salted hash().
    """
    base = zlib.crc32(name.encode()) & 0xFFFFFFFF
    return (base * 1000003 + version * 8191 + part_idx + salt) % (2 ** 63)


def pull_seed(name: str, context_version: int, part_idx: int,
              served_round=None, staleness: int = 0,
              degraded: bool = False, salt: int = 0) -> int:
    """Seed for decoding a PULLED round result — the one place that owns
    the served-round → version-counter contract under bounded staleness
    (BYTEPS_STALENESS): server round N was pushed at version counter
    N−1, so a seed-keyed pull decode (randomk's positional store) must
    use the seed of the round the served aggregate was BUILT from, not
    the round the caller asked for. K=0 leaves served == requested and
    the seed bit-identical to the sync tier; a DEGRADED payload is the
    PUSH-side encoding of the caller's own round, so it keeps the
    caller's version."""
    v = context_version
    if staleness > 0 and served_round and not degraded:
        v = served_round - 1
    return wire_seed(name, v, part_idx, salt=salt)

# Codec ids — must match server/csrc/codec.h Codec enum.
WIRE_RAW = 0
WIRE_FP16 = 1
WIRE_ONEBIT = 2
WIRE_TOPK = 3
WIRE_DITHER = 4
WIRE_FP8 = 5

_DITHER_NATURAL = 0x1
_DITHER_MAXNORM = 0x2


class WireCodec:
    """Encode/decode one partition for the DCN wire (fp32 both ends)."""

    codec_id = WIRE_RAW

    def encode(self, x: np.ndarray, seed: int = 0) -> np.ndarray:
        """fp32 vector -> uint8 wire bytes."""
        return np.ascontiguousarray(x, np.float32).view(np.uint8).ravel()

    def decode(self, buf: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
        """uint8 wire bytes -> fp32 vector of length n."""
        return np.ascontiguousarray(buf[: n * 4]).view(np.float32).copy()

    def store_elems(self, n: int) -> int:
        """Dense fp32 elements the server must allocate for this key."""
        return n

    def wire_bytes(self, n: int) -> int:
        return n * 4


class Fp16Wire(WireCodec):
    """IEEE binary16 wire — halves every push/pull byte (the reference's
    fp16 Compression shim, byteps/torch/compression.py, with real wire
    savings rather than a round-trip simulation)."""

    codec_id = WIRE_FP16

    def encode(self, x: np.ndarray, seed: int = 0) -> np.ndarray:
        return (
            np.ascontiguousarray(x, np.float32)
            .astype(np.float16)
            .view(np.uint8)
            .ravel()
        )

    def decode(self, buf: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
        return (
            np.ascontiguousarray(buf[: n * 2])
            .view(np.float16)
            .astype(np.float32)
        )

    def wire_bytes(self, n: int) -> int:
        return n * 2


class Fp8Wire(WireCodec):
    """[f32 scale][n bytes e4m3fn] — quarter of raw fp32, half of fp16.
    scale = absmax/448 (1.0 for an all-zero partition); elements are
    clipped to the finite e4m3 range before the RNE cast so the
    overflow->NaN cast semantics can never fire. Byte-exact C++
    twin in server/csrc/codec.cc."""

    codec_id = WIRE_FP8

    FP8_MAX = 448.0

    def encode(self, x: np.ndarray, seed: int = 0) -> np.ndarray:
        xf = np.ascontiguousarray(x, np.float32)
        absmax = float(np.max(np.abs(xf))) if xf.size else 0.0
        scale = np.float32(absmax / self.FP8_MAX if absmax > 0 else 1.0)
        q = np.clip(xf / scale, -self.FP8_MAX, self.FP8_MAX)
        body = (torch.from_numpy(np.ascontiguousarray(q, np.float32))
                .to(torch.float8_e4m3fn).view(torch.uint8).numpy())
        out = np.empty(4 + xf.size, np.uint8)
        out[:4] = np.frombuffer(scale.tobytes(), np.uint8)
        out[4:] = body
        return out

    def decode(self, buf: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
        buf = np.ascontiguousarray(buf)
        scale = buf[:4].view(np.float32)[0]
        vals = (torch.from_numpy(buf[4:4 + n].copy())
                .view(torch.float8_e4m3fn).float().numpy())
        return vals * scale

    def wire_bytes(self, n: int) -> int:
        return 4 + n


class OnebitWire(WireCodec):
    """[f32 scale][ceil(n/32) u32 words]; bit (i&31) of word i>>5 set means
    x[i] >= +0.0 (signbit semantics, so -0.0 encodes negative)."""

    codec_id = WIRE_ONEBIT

    def __init__(self, scaling: bool = True):
        self.scaling = bool(scaling)

    def encode(self, x: np.ndarray, seed: int = 0) -> np.ndarray:
        xf = np.ascontiguousarray(x, np.float32)
        n = xf.size
        scale = np.float32(np.mean(np.abs(xf)) if self.scaling and n else 1.0)
        bits = ~np.signbit(xf)
        nwords = (n + 31) // 32
        packed = np.packbits(bits, bitorder="little")
        words = np.zeros(nwords * 4, np.uint8)
        words[: packed.size] = packed
        out = np.empty(4 + nwords * 4, np.uint8)
        out[:4] = np.frombuffer(np.float32(scale).tobytes(), np.uint8)
        out[4:] = words
        return out

    def decode(self, buf: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
        buf = np.ascontiguousarray(buf)
        scale = buf[:4].view(np.float32)[0]
        bits = np.unpackbits(buf[4:], bitorder="little")[:n]
        return np.where(bits, scale, -scale).astype(np.float32)

    def wire_bytes(self, n: int) -> int:
        return 4 + 4 * ((n + 31) // 32)


class TopkWire(WireCodec):
    """[u32 count][count u32 indices][count f32 values]; server
    scatter-adds. The count header makes the format self-describing, so
    every selection strategy shares one decode and one server path:

    * ``selection="exact"`` (default) — argpartition, count = k pairs.
    * ``selection="block"`` — blockwise top-1 (the fused kernels'
      selection, ``topk.py``): count = rows (can be < k on ragged
      chunks), keeping wire bytes consistent with
      ``TopkCompressor.compressed_bytes``.
    * ``selection="approx"`` — the reference's TPU-only selection strategy
      (``lax.approx_max_k`` has no host analog); the wire uses exact
      selection at the identical k-pair budget, which can only improve
      recall.
    """

    codec_id = WIRE_TOPK

    def __init__(self, k=0.01, selection: str = "exact"):
        if selection not in ("exact", "block", "approx"):
            raise ValueError(f"unknown wire selection {selection!r} — "
                             "expected 'exact', 'block', or 'approx'")
        self.k = k
        # approx is TPU-only in the reference; on the host wire it aliases
        # exact (same k-pair budget, strictly better recall)
        self.selection = "exact" if selection == "approx" else selection

    def _k(self, n: int) -> int:
        return resolve_k(self.k, n)

    def _block_shape(self, n: int):
        return block_shape(self.k, n)

    def encode(self, x: np.ndarray, seed: int = 0) -> np.ndarray:
        xf = np.ascontiguousarray(x, np.float32)
        n = xf.size
        if self.selection == "block":
            # must mirror TopkCompressor's tiled selection exactly:
            # tiling-native (J, g, 128) when (k, n) qualify, else the
            # strided (block, rows) layout — see topk.py
            tiled = tiled_shape(self.k, n)
            if tiled is not None:
                J, g = tiled
                x3 = np.abs(xf).reshape(J, g, 128)
                local = np.argmax(x3, axis=1)                 # (J, 128)
                jj = np.arange(J, dtype=np.uint32)[:, None]
                lane = np.arange(128, dtype=np.uint32)[None, :]
                idx = ((jj * np.uint32(g) + local.astype(np.uint32))
                       * np.uint32(128) + lane).reshape(-1)
                k = idx.size
            else:
                rows, block = self._block_shape(n)
                pad = rows * block - n
                xa = np.abs(xf)
                if pad:
                    xa = np.concatenate(
                        [xa, np.full(pad, -1.0, np.float32)])
                local = np.argmax(xa.reshape(block, rows), axis=0)
                idx = (local.astype(np.uint32) * np.uint32(rows)
                       + np.arange(rows, dtype=np.uint32))
                k = rows
        else:
            k = self._k(n)
            idx = np.argpartition(np.abs(xf), n - k)[n - k:].astype(np.uint32)
        out = np.empty(4 + k * 8, np.uint8)
        out[:4] = np.frombuffer(np.uint32(k).tobytes(), np.uint8)
        out[4:4 + k * 4] = idx.view(np.uint8)
        out[4 + k * 4:] = xf[idx].view(np.uint8)
        return out

    def decode(self, buf: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
        buf = np.ascontiguousarray(buf)
        k = int(buf[:4].view(np.uint32)[0])
        idx = buf[4:4 + k * 4].view(np.uint32).astype(np.int64)
        val = buf[4 + k * 4:4 + k * 8].view(np.float32)
        dense = np.zeros(n, np.float32)
        np.add.at(dense, idx, val)
        return dense

    def wire_bytes(self, n: int) -> int:
        if self.selection == "block":
            return 4 + self._block_shape(n)[0] * 8
        return 4 + self._k(n) * 8


class RandomkWire(WireCodec):
    """Values-only wire for seed-synced randomk: every pod derives the same
    k indices from the shared seed, so the server positional-sums k floats
    without ever seeing indices (the reference's synced-PRNG trick); the
    store for this key is k elements, not n."""

    codec_id = WIRE_RAW  # positional fp32 sum on the server

    def __init__(self, k=0.01, scale: bool = True):
        self.k = k
        self.scale = bool(scale)

    def _k(self, n: int) -> int:
        return resolve_k(self.k, n)

    def _indices(self, n: int, seed: int) -> np.ndarray:
        rng = np.random.Generator(np.random.PCG64(seed))
        return rng.choice(n, size=self._k(n), replace=False)

    def encode(self, x: np.ndarray, seed: int = 0) -> np.ndarray:
        xf = np.ascontiguousarray(x, np.float32)
        n = xf.size
        k = self._k(n)
        vals = xf[self._indices(n, seed)]
        if self.scale:
            vals = vals * np.float32(n / k)
        return vals.astype(np.float32).view(np.uint8).ravel()

    def decode(self, buf: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
        buf = np.ascontiguousarray(buf)
        vals = buf.view(np.float32)
        dense = np.zeros(n, np.float32)
        dense[self._indices(n, seed)] = vals
        return dense

    def store_elems(self, n: int) -> int:
        return self._k(n)

    def wire_bytes(self, n: int) -> int:
        return self._k(n) * 4


class DitherWire(WireCodec):
    """[u8 flags][u8 s][u16 0][f32 norm][n i8 levels] — stochastic
    quantization; flags bit0 = natural (powers-of-two) levels, bit1 =
    max-norm. Level mapping matches DitheringCompressor and codec.cc."""

    codec_id = WIRE_DITHER

    def __init__(self, s: int = 127, partition: str = "linear",
                 normalize: str = "l2"):
        self.s = int(s)
        self.natural = partition == "natural"
        self.maxnorm = normalize == "max"

    @property
    def _flags(self) -> int:
        return (_DITHER_NATURAL if self.natural else 0) | (
            _DITHER_MAXNORM if self.maxnorm else 0
        )

    def encode(self, x: np.ndarray, seed: int = 0) -> np.ndarray:
        xf = np.ascontiguousarray(x, np.float32)
        n = xf.size
        s = self.s
        norm = np.float32(
            np.max(np.abs(xf)) if self.maxnorm
            else np.sqrt(np.sum(xf.astype(np.float64) ** 2))
        ) if n else np.float32(0)
        safe = norm if norm > 0 else np.float32(1)
        p = np.abs(xf) / safe
        u = np.random.Generator(np.random.PCG64(seed)).random(
            n, dtype=np.float32
        )
        if not self.natural:
            y = np.minimum(p, 1.0) * s
            lo = np.floor(y)
            level = lo + (u < (y - lo))
        else:
            tiny = np.float32(2.0 ** (-(s - 1)))
            pc = np.clip(p, tiny, 1.0)
            e = np.floor(np.log2(pc))
            base = np.exp2(e)
            frac = pc / base - 1.0
            q = base * np.where(u < frac, 2.0, 1.0)
            level = np.rint(np.log2(q)) + (s - 1) + 1
            level = np.minimum(level, s)
            below = p < tiny
            level = np.where(
                below, np.where(u < p / tiny, 1.0, 0.0), level
            )
        levels = (np.where(np.signbit(xf), -level, level)).astype(np.int8)
        out = np.empty(8 + n, np.uint8)
        out[0] = self._flags
        out[1] = s
        out[2:4] = 0
        out[4:8] = np.frombuffer(np.float32(norm).tobytes(), np.uint8)
        out[8:] = levels.view(np.uint8)
        return out

    def decode(self, buf: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
        buf = np.ascontiguousarray(buf)
        flags = int(buf[0])
        s = int(buf[1])
        norm = buf[4:8].view(np.float32)[0]
        lv = buf[8:8 + n].view(np.int8).astype(np.float32)
        mag = np.abs(lv)
        if flags & _DITHER_NATURAL:
            p = np.where(mag > 0, np.exp2(mag - 1 - (s - 1)), 0.0)
        else:
            p = mag / s
        return (np.sign(lv) * p * norm).astype(np.float32)

    def wire_bytes(self, n: int) -> int:
        return 8 + n


@dataclasses.dataclass
class WirePlan:
    """How one tensor travels the DCN: push codec + pull codec (two-way
    compression re-compresses the pull direction, reference server
    behavior; one-way pulls raw fp32). For store-compacted codecs
    (randomk), the "raw" pull is already the compact positional sum and is
    decoded by the codec regardless of two_way."""

    codec: WireCodec
    two_way: bool

    @property
    def compacted(self) -> bool:
        # store_elems < n ⇒ the raw store itself is the compressed form
        return type(self.codec).store_elems is not WireCodec.store_elems

    @property
    def pull_codec_id(self) -> int:
        return (
            self.codec.codec_id
            if (self.two_way and not self.compacted)
            else WIRE_RAW
        )

    def pull_capacity(self, n: int) -> int:
        store = self.codec.store_elems(n)
        return max(store * 4, self.codec.wire_bytes(n) if self.two_way else 0)

    def decode_pull(self, buf: np.ndarray, n: int, seed: int) -> np.ndarray:
        if self.compacted or self.two_way:
            return self.codec.decode(buf, n, seed)
        return np.ascontiguousarray(buf[: n * 4]).view(np.float32).copy()


def make_wire_codec(spec: CompressionSpec) -> Optional[WireCodec]:
    """Map a resolved CompressionSpec to its DCN wire codec (None = raw)."""
    c = spec.compressor
    name = c.name
    if name == "identity":
        return None
    if name == "onebit":
        return OnebitWire(scaling=getattr(c, "scaling", True))
    if name == "topk":
        return TopkWire(k=getattr(c, "k", 0.01),
                        selection=getattr(c, "selection", "exact"))
    if name == "randomk":
        return RandomkWire(
            k=getattr(c, "k", 0.01), scale=getattr(c, "scale", True)
        )
    if name == "dithering":
        return DitherWire(
            s=getattr(c, "s", 127),
            partition=getattr(c, "partition", "linear"),
            normalize=getattr(c, "normalize", "l2"),
        )
    if name == "fp16":
        return Fp16Wire()
    if name == "fp8":
        return Fp8Wire()
    raise ValueError(f"no DCN wire codec for compressor '{name}'")
