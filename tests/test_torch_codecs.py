"""The port's fp16, fp8, randomk and dithering codecs and its key
derivation against the reference.

* fp16 and fp8 are deterministic and held bit for bit: fp16 half bits on
  random and special values; fp8 all 256 e4m3fn byte values decoded,
  random grids (subnormals, the clip at ±448) encoded, and the codec's
  scale, bytes and decode.
* randomk and dithering are stochastic, and the port draws from
  ``torch.Generator`` where the reference draws from ``jax.random``. Each
  codec's apply step takes its draws, so it is held exactly given the
  reference's own draws (``jax.random.choice`` indices, ``uniform``
  numbers): randomk values and dense bit-equal; dithering levels
  bit-equal, norms and decodes within 1e-6 relative where the l2 norm is
  summed in another order (the max norm exactly). Natural dithering is
  held on inputs whose |x|/‖x‖ stays at or above 2^-12: below that the
  reference's XLA ``exp2`` / ``log2`` are not exact on the CPU (ROADMAP
  C). Then each whole codec is held on statistics with fixed seeds:
  randomk's support has k distinct indices fixed by the key, and
  E[D(C(x))] = x within 4σ over 400 keys for both.
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from byteps_tpu_torch.compression import (
    DitheringCompressor,
    Fp8Compressor,
    Fp16Compressor,
    RandomkCompressor,
    fold_in,
    from_params,
)
from byteps_tpu_torch.compression import base as tbase

rcomp = importlib.import_module("byteps_tpu.compression")

torch.set_num_threads(1)
RTOL = 1e-6


def _rand(n, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(n)).astype(
        np.float32)


def _bits(a, dtype):
    return np.ascontiguousarray(a).view(dtype)


def test_fp16_bits_match_reference():
    x = np.concatenate([_rand(4000, 1), _rand(100, 2, 1e-6),
                        _rand(100, 3, 1e5),
                        np.array([0.0, -0.0, np.inf, -np.inf, 65504.0,
                                  65520.0, 6e-8, 2.98e-8], np.float32)])
    ref, port = rcomp.Fp16Compressor(), Fp16Compressor()
    rp, tp = ref.compress(jnp.asarray(x)), port.compress(torch.as_tensor(x))
    np.testing.assert_array_equal(_bits(tp["values"].numpy(), np.uint16),
                                  _bits(np.asarray(rp["values"]), np.uint16))
    np.testing.assert_array_equal(
        port.decompress(tp, x.size).numpy(),
        np.asarray(ref.decompress(rp, x.size)))
    assert port.compressed_bytes(777) == ref.compressed_bytes(777)
    assert port.presummable and not port.stochastic


def test_fp8_all_bytes_decode_like_reference():
    raw = np.arange(256, dtype=np.uint8)
    want = raw.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    got = torch.as_tensor(raw).view(torch.float8_e4m3fn).float().numpy()
    np.testing.assert_array_equal(got, want)       # NaN bytes equal as NaN
    assert np.isnan(got).sum() == 2


def test_fp8_encode_grid_matches_reference():
    rng = np.random.default_rng(7)
    x = np.concatenate([
        rng.uniform(-448, 448, 3000), rng.uniform(-1, 1, 1000) * 2.0 ** -7,
        rng.uniform(-1, 1, 500) * 2.0 ** -10,        # subnormal e4m3
        np.array([0.0, -0.0, 448.0, -448.0, 464.0, -500.0, 1e6])
    ]).astype(np.float32)
    want = jnp.asarray(x).astype(jnp.float8_e4m3fn)
    got = torch.as_tensor(x).clamp(-448, 448).to(torch.float8_e4m3fn)
    np.testing.assert_array_equal(
        got.view(torch.uint8).numpy(),
        _bits(np.asarray(jnp.clip(jnp.asarray(x), -448, 448)
                         .astype(jnp.float8_e4m3fn)), np.uint8))
    # the plain cast below the max agrees too
    inside = np.abs(x) <= 448
    np.testing.assert_array_equal(
        torch.as_tensor(x[inside]).to(torch.float8_e4m3fn)
        .view(torch.uint8).numpy(), _bits(np.asarray(want)[inside], np.uint8))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_fp8_codec_matches_reference(scale):
    x = _rand(5000, 11, scale)
    ref, port = rcomp.Fp8Compressor(), Fp8Compressor()
    rp, tp = ref.compress(jnp.asarray(x)), port.compress(torch.as_tensor(x))
    assert tp["scale"].shape == np.asarray(rp["scale"]).shape == ()
    np.testing.assert_array_equal(tp["scale"].numpy(), np.asarray(rp["scale"]))
    np.testing.assert_array_equal(tp["values"].view(torch.uint8).numpy(),
                                  _bits(np.asarray(rp["values"]), np.uint8))
    np.testing.assert_array_equal(port.decompress(tp, x.size).numpy(),
                                  np.asarray(ref.decompress(rp, x.size)))
    assert port.compressed_bytes(5000) == ref.compressed_bytes(5000)
    assert not port.presummable


# --- randomk --------------------------------------------------------------
@pytest.mark.parametrize("k,scale", [(0.05, True), (37, False)])
def test_randomk_exact_given_reference_draws(k, scale):
    n = 3000
    x = _rand(n, 21)
    ref = rcomp.RandomkCompressor(k=k, scale=scale)
    port = RandomkCompressor(k=k, scale=scale)
    key = jax.random.PRNGKey(5)
    kk = rcomp.topk.resolve_k(k, n)
    idx = np.asarray(ref._indices(key, n, kk))
    rp = ref.compress(jnp.asarray(x), key)
    tp = port.compress_at(torch.as_tensor(x), torch.as_tensor(idx))
    np.testing.assert_array_equal(tp["values"].numpy(),
                                  np.asarray(rp["values"]))
    np.testing.assert_array_equal(
        port.decompress_at(tp, torch.as_tensor(idx), n).numpy(),
        np.asarray(ref.decompress(rp, n, rng=key)))
    assert port.compressed_bytes(n) == ref.compressed_bytes(n)


def test_randomk_support_and_unbiased():
    n, k, T = 200, 20, 400
    port = RandomkCompressor(k=k)
    x = torch.as_tensor(_rand(n, 31))
    idx = port._indices(1234, n, k, x.device)
    assert idx.dtype == torch.int32 and len(set(idx.tolist())) == k
    assert 0 <= int(idx.min()) and int(idx.max()) < n
    assert torch.equal(idx, port._indices(1234, n, k, x.device))
    assert not torch.equal(idx, port._indices(1235, n, k, x.device))
    # the codec's own draw: compress and decompress with one key agree
    p = port.compress(x, 99)
    d = port.decompress(p, n, rng=99)
    np.testing.assert_array_equal(np.flatnonzero(d.numpy()),
                                  np.sort(port._indices(99, n, k, x.device)
                                          .numpy()))
    est = torch.stack([port.roundtrip(x, fold_in(7, t))[0]
                       for t in range(T)])
    sigma = x.abs() * np.sqrt(n / k - 1) / np.sqrt(T)
    z = ((est.mean(0) - x).abs() / sigma).max()
    assert z < 4.0, float(z)
    with pytest.raises(ValueError, match="rng key"):
        port.compress(x)
    with pytest.raises(ValueError, match="rng key"):
        port.decompress(p, n)


# --- dithering ------------------------------------------------------------
def _dither_input(partition, normalize, n, seed):
    rng = np.random.default_rng(seed)
    if partition == "linear":
        return _rand(n, seed)
    # |x|/‖x‖ >= 2^-12, where the reference's exp2/log2 are exact
    lo = 8 if normalize == "l2" else 12
    mag = 2.0 ** -rng.uniform(0, lo, n)
    return (np.where(rng.random(n) < 0.5, -1, 1) * mag).astype(np.float32)


@pytest.mark.parametrize("partition", ["linear", "natural"])
@pytest.mark.parametrize("normalize", ["l2", "max"])
@pytest.mark.parametrize("s", [127, 7])
def test_dithering_exact_given_reference_draws(partition, normalize, s):
    n = 1024
    x = _dither_input(partition, normalize, n, s)
    ref = rcomp.DitheringCompressor(s=s, partition=partition,
                                    normalize=normalize)
    port = DitheringCompressor(s=s, partition=partition, normalize=normalize)
    key = jax.random.PRNGKey(s)
    u = np.asarray(jax.random.uniform(key, (n,)))
    rp = ref.compress(jnp.asarray(x), key)
    tp = port.quantize(torch.as_tensor(x), torch.as_tensor(u))
    assert tp["levels"].dtype == torch.int8 and tp["norm"].shape == (1,)
    np.testing.assert_array_equal(tp["levels"].numpy(),
                                  np.asarray(rp["levels"]))
    assert np.abs(tp["levels"].numpy()).max() <= s
    if normalize == "max":
        np.testing.assert_array_equal(tp["norm"].numpy(),
                                      np.asarray(rp["norm"]))
    np.testing.assert_allclose(tp["norm"].numpy(), np.asarray(rp["norm"]),
                               rtol=RTOL)
    np.testing.assert_allclose(port.decompress(tp, n).numpy(),
                               np.asarray(ref.decompress(rp, n)), rtol=RTOL)
    assert port.compressed_bytes(n) == ref.compressed_bytes(n)


@pytest.mark.parametrize("partition", ["linear", "natural"])
def test_dithering_unbiased(partition):
    n, T = 128, 400
    port = DitheringCompressor(s=4, partition=partition, normalize="max")
    x = torch.as_tensor(_rand(n, 41))
    est = torch.stack([port.roundtrip(x, fold_in(3, t))[0] for t in range(T)])
    # one rounding step is at most the level spacing: 1/s of the norm
    # (linear); natural, the value itself (a power-of-two bracket), or the
    # lowest level 2^-(s-1) of the norm for values below it
    norm = x.abs().max()
    step = (norm / 4 if partition == "linear"
            else torch.maximum(x.abs(), norm * 2.0 ** -3))
    sigma = step / 2 / np.sqrt(T)
    z = ((est.mean(0) - x).abs() / sigma).max()
    assert z < 4.0, float(z)
    with pytest.raises(ValueError, match="rng key"):
        port.compress(x)


def test_dithering_validation():
    for bad in ({"partition": "log"}, {"normalize": "l1"}, {"s": 128},
                {"s": 0}):
        with pytest.raises(ValueError):
            DitheringCompressor(**bad)


# --- keys and the registry --------------------------------------------------
def test_fold_in_is_a_fixed_64_bit_mix():
    keys = {fold_in(k, i) for k in range(50) for i in range(50)}
    assert len(keys) == 2500
    assert all(0 <= k < 2 ** 64 for k in keys)
    assert fold_in(0, 0) == fold_in(0, 0) != fold_in(0, 1)
    assert fold_in(2 ** 64 - 1, 3) < 2 ** 64
    g1 = tbase.generator(fold_in(9, 1), torch.device("cpu"))
    g2 = tbase.generator(fold_in(9, 1), torch.device("cpu"))
    assert torch.equal(torch.rand(8, generator=g1), torch.rand(8, generator=g2))


@pytest.mark.parametrize("name,cls,stochastic", [
    ("fp16", Fp16Compressor, False), ("fp8", Fp8Compressor, False),
    ("randomk", RandomkCompressor, True),
    ("dithering", DitheringCompressor, True)])
def test_registry(name, cls, stochastic):
    spec = from_params({"compressor": name, "k": 0.1, "s": 15,
                        "partition": "natural", "ef": "vanilla"})
    ref = rcomp.from_params({"compressor": name, "k": 0.1, "s": 15,
                             "partition": "natural", "ef": "vanilla"})
    assert isinstance(spec.compressor, cls) and spec.ef
    assert spec.compressor.stochastic is stochastic is ref.compressor.stochastic
    assert spec.compressor.presummable is ref.compressor.presummable
