"""The port's onebit codec against the reference: pack words bit for bit
(the reference's uint32 words as the port's int32 bits) under both of
the reference's backends — jnp and its Pallas kernels in interpret
mode — at ragged lengths, on -0.0 / 0 / NaN and from a view 4 bytes
into its buffer; unpack-sum equal at
K = 1, 3 and 8, and at K = 2 and 32 (the ring owner's and the most the
unrolled kernel takes) at n = 1 and 31 (both fold the K rows in order
from 0.0, so equality is exact) and at K = 33, 40, 41, 64 and 129
against the reference's grid kernel (rows in blocks of 8, block partials
added in order: bit-equal, where a fold of all K rows in one sequence is
not), also with a zero scale and with inf scales; and the compressor's
compress / decompress / decompress_sum /
roundtrip with error feedback. The scale is mean(|x|), whose reduction
order differs between the frameworks: scales and everything scaled by
them are held at 1e-6 relative.

The CUDA kernels are checked against these plain versions, bit for bit,
on the card by ``chip_smoke.py``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu_torch.compression import (
    Compressor,
    OnebitCompressor,
    ef_compress,
    from_params,
    get_compressor,
    momentum_step,
)
from byteps_tpu_torch.ops import onebit_kernels as tob

rob = importlib.import_module("byteps_tpu.ops.onebit_kernels")
rcomp = importlib.import_module("byteps_tpu.compression")

SCALE_RTOL = 1e-6


def _x(n, seed, special=False):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    if special:
        x[0::5] = -0.0
        x[1::5] = 0.0
        x[2::5] = np.nan
    return x


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("n,special", [(1, False), (31, False),
                                       (4097, False), (5003, True)])
def test_pack_words_bit_equal(backend, n, special):
    x = _x(n, seed=n, special=special)
    want = np.asarray(rob.onebit_pack(jnp.asarray(x), backend=backend))
    got = tob.onebit_pack(torch.as_tensor(x)).numpy().view(np.uint32)
    assert got.shape == (tob.packed_words(n),) == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("n", [33, 4097])
def test_pack_from_unaligned_start_bit_equal(backend, n):
    """A view that starts 4 bytes into its buffer (``buf[1:n+1]``), as the
    card's pack takes it without a vector load: the reference's words."""
    buf = _x(n + 1, seed=n + 1, special=True)
    want = np.asarray(rob.onebit_pack(jnp.asarray(buf[1:]), backend=backend))
    view = torch.as_tensor(buf)[1:n + 1]
    assert view.storage_offset() == 1
    got = tob.onebit_pack(view).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("K,n", [
    pytest.param(1, 5003, id="1"), pytest.param(3, 5003, id="3"),
    pytest.param(8, 5003, id="8"), pytest.param(2, 1, id="2-n1"),
    pytest.param(2, 31, id="2-n31"), pytest.param(32, 1, id="32-n1"),
    pytest.param(32, 31, id="32-n31")])
def test_unpack_sum_equal(backend, K, n):
    words = np.stack([np.asarray(rob.onebit_pack(jnp.asarray(_x(n, 10 + r)),
                                                 backend="jnp"))
                      for r in range(K)])
    scales = np.random.default_rng(K).random(K).astype(np.float32)
    want = np.asarray(rob.onebit_unpack_sum(jnp.asarray(words),
                                            jnp.asarray(scales), n,
                                            backend=backend))
    got = tob.onebit_unpack_sum(torch.as_tensor(words.view(np.int32)),
                                torch.as_tensor(scales), n).numpy()
    np.testing.assert_array_equal(got, want)
    one = tob.onebit_unpack(torch.as_tensor(words[0].view(np.int32)),
                            torch.as_tensor(scales[:1]), n).numpy()
    np.testing.assert_array_equal(
        one, np.asarray(rob.onebit_unpack(jnp.asarray(words[0]),
                                          jnp.asarray(scales[:1]), n,
                                          backend=backend)))


@pytest.mark.parametrize("K,zero,inf", [
    pytest.param(40, False, False, id="40"),
    pytest.param(64, False, False, id="64"),
    pytest.param(33, True, False, id="33-zero"),
    pytest.param(41, False, True, id="41-inf"),
    pytest.param(129, True, True, id="129-zero-inf")])
def test_unpack_sum_grid_order_equal(K, zero, inf):
    """At a ragged n, K cutting the last 8-row block short (33, 41, 129)
    or not; a zero scale (its terms add +-0.0) and two inf scales (inf
    where their bits agree, NaN where they differ): bit-equal by bit
    pattern, NaN included."""
    n = 5003
    rng = np.random.default_rng(K)
    words = np.stack([np.asarray(rob.onebit_pack(
        jnp.asarray(rng.standard_normal(n).astype(np.float32)),
        backend="jnp")) for _ in range(K)])
    scales = rng.random(K).astype(np.float32)
    if zero:
        scales[K // 2] = 0.0
    if inf:
        scales[[K // 3, 2 * K // 3]] = np.inf
    want = np.asarray(rob.onebit_unpack_sum(jnp.asarray(words),
                                            jnp.asarray(scales), n,
                                            backend="pallas"))
    tw, ts = torch.as_tensor(words.view(np.int32)), torch.as_tensor(scales)
    got = tob.onebit_unpack_sum(tw, ts, n).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if inf:
        assert np.isnan(want).any() and np.isinf(want).any()
        return
    # the order is the point: one fold over all K rows differs in the
    # last bit on a share of the elements
    one_fold = tob._rows_unpack_acc(tw, ts).reshape(-1)[:n].numpy()
    assert (one_fold != want).mean() > 0.1


@pytest.mark.parametrize("scaling", [True, False])
def test_compressor_matches_reference(scaling):
    n = 3001
    x = _x(n, seed=3)
    e = 0.1 * _x(n, seed=4)
    ref = rcomp.OnebitCompressor(scaling=scaling)
    port = OnebitCompressor(scaling=scaling)
    rp = ref.compress(jnp.asarray(x))
    pp = port.compress(torch.as_tensor(x))
    np.testing.assert_array_equal(pp["signs"].numpy().view(np.uint32),
                                  np.asarray(rp["signs"]))
    np.testing.assert_allclose(pp["scale"].numpy(), np.asarray(rp["scale"]),
                               rtol=SCALE_RTOL)
    np.testing.assert_allclose(port.decompress(pp, n).numpy(),
                               np.asarray(ref.decompress(rp, n)),
                               rtol=SCALE_RTOL)
    assert port.compressed_bytes(n) == ref.compressed_bytes(n)
    # decompress_sum over a stacked K = 3 payload
    xs = [_x(n, seed=20 + r) for r in range(3)]
    rps = [ref.compress(jnp.asarray(a)) for a in xs]
    pps = [port.compress(torch.as_tensor(a)) for a in xs]
    rstack = {k: jnp.stack([p[k] for p in rps]) for k in rps[0]}
    pstack = {k: torch.stack([p[k] for p in pps]) for k in pps[0]}
    np.testing.assert_allclose(port.decompress_sum(pstack, n).numpy(),
                               np.asarray(ref.decompress_sum(rstack, n)),
                               rtol=SCALE_RTOL, atol=SCALE_RTOL)
    # the n == 1 aggregation body with error feedback
    rd, rr = ref.roundtrip(jnp.asarray(x), e=jnp.asarray(e))
    pd, pr = port.roundtrip(torch.as_tensor(x), e=torch.as_tensor(e))
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=SCALE_RTOL)
    np.testing.assert_allclose(pr.numpy(), np.asarray(rr), rtol=SCALE_RTOL,
                               atol=SCALE_RTOL)
    # the error-feedback and Nesterov helpers the optimizer builds on
    rp, re_ = rcomp.ef_compress(ref, jnp.asarray(x), jnp.asarray(e))
    tp, te = ef_compress(port, torch.as_tensor(x), torch.as_tensor(e))
    np.testing.assert_array_equal(tp["signs"].numpy().view(np.uint32),
                                  np.asarray(rp["signs"]))
    np.testing.assert_allclose(te.numpy(), np.asarray(re_), rtol=SCALE_RTOL,
                               atol=SCALE_RTOL)
    rx, rm = rcomp.momentum_step(jnp.asarray(x), jnp.asarray(e), 0.9)
    tx, tm = momentum_step(torch.as_tensor(x), torch.as_tensor(e), 0.9)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(rm))


def test_scaling_env_default_and_registry(monkeypatch):
    from byteps_tpu_torch.common import config as tconfig

    monkeypatch.setenv("BYTEPS_COMPRESSOR_ONEBIT_SCALING", "0")
    tconfig.reset_config()
    try:
        assert OnebitCompressor().scaling is False
    finally:
        monkeypatch.delenv("BYTEPS_COMPRESSOR_ONEBIT_SCALING")
        tconfig.reset_config()
    assert OnebitCompressor().scaling is True
    spec = from_params({"compressor": "onebit", "ef": "vanilla"})
    assert isinstance(spec.compressor, OnebitCompressor)
    assert spec.ef and spec.enabled and spec.two_way and not spec.momentum
    assert not from_params(None).enabled
    assert type(get_compressor("identity")) is Compressor
    with pytest.raises(KeyError, match="unknown compressor"):
        get_compressor("powersgd")


def test_guards():
    with pytest.raises(ValueError, match="flat vector"):
        tob.onebit_pack(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="pair up"):
        tob.onebit_unpack_sum(torch.zeros(2, 128, dtype=torch.int32),
                              torch.zeros(3), 10)
    with pytest.raises(ValueError, match="outside the payload"):
        tob.onebit_unpack_sum(torch.zeros(1, 128, dtype=torch.int32),
                              torch.zeros(1), 128 * 32 + 1)
