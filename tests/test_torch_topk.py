"""The port's block top-k against the reference, exactly.

* The three kernels' plain versions against the reference's Pallas
  kernels in interpret mode (``backend="pallas"``, at shapes its gate
  admits): ``block_select`` winner rows and values, including the
  first-max tie-break, an all-zero lane, -0.0 and a NaN lane (no winner,
  as the Pallas arithmetic gives; the reference's jnp twin would pick the
  NaN); ``block_reconstruct_sum`` at K = 1, 3 and 8 on (100, 1280),
  (101, 1280) and (3, 128), with no-winner and out-of-range locals and
  one slot hit by two and three payloads (odd rows against the
  reference's jnp twin, without -0.0); ``block_roundtrip``
  dense and residual, with and without the error-feedback residual, at
  the default partition's (80, 100), at tall and odd groups ((1, 600),
  (3, 257), (2, 1)) and with ties and a NaN group.
* Ties where the CUDA kernels split a group: 16 and 32 rows apart, the
  launch plan's thread stride apart and on both sides of its block
  boundary, with ±inf beside a finite max and -0.0 as a group's only
  non-zero (the kernels meet the same inputs in ``chip_smoke.py``); the
  launch plans (``select_plan``, ``roundtrip_plan``,
  ``reconstruct_plan``) give every slot to exactly one thread and fill
  the card at a chunk's layouts.
* ``resolve_k`` / ``block_shape`` / ``tiled_shape`` over a grid of
  (k, n) covering the tiled, strided-aligned and ragged layouts.
* ``TopkCompressor`` compress / decompress / roundtrip / decompress_sum
  on each layout and on ``exact`` selection, against the reference's;
  the ragged strided chunk goes through ``block_select`` with its length
  here (the CUDA kernel on the card) and through the reference's jnp
  argmax branch there; the tiled ``decompress_sum`` of 1, 2 and 3
  payloads holding -0.0, bit for bit (a sum from the first payload's
  term instead of zeros keeps at K = 1 a -0.0 the reference returns as
  0.0).

Everything is exact: the winner rule is a max and a min over exact
comparisons, a winner's value is copied, and sums add the same terms in
the same order. The CUDA kernels are held to these plain versions, bit
for bit, on the card by ``chip_smoke.py``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu_torch.compression import TopkCompressor, from_params
from byteps_tpu_torch.compression import topk as ttopk
from byteps_tpu_torch.ops import topk_kernels as tk

rk = importlib.import_module("byteps_tpu.ops.topk_kernels")
rtopk = importlib.import_module("byteps_tpu.compression.topk")
# the ties, infs and signed zeros the kernels meet on the card
split_ties = importlib.import_module("chip_smoke").split_ties

torch.set_num_threads(1)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _eq(got: torch.Tensor, want) -> None:
    """Bit-equal, -0.0 and NaN included."""
    g = got.numpy()
    w = np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
    np.testing.assert_array_equal(g.view(np.uint32 if g.itemsize == 4
                                         else np.uint8),
                                  w.view(np.uint32 if w.itemsize == 4
                                         else np.uint8))


def _select_both(x):
    lo, va = rk.block_select(jnp.asarray(x), backend="pallas")
    tlo, tva = tk.block_select(torch.as_tensor(x))
    _eq(tlo, lo)
    _eq(tva, va)
    return tlo, tva


@pytest.mark.parametrize("block,rows", [(8, 256), (100, 1280), (320, 1280)])
def test_select_matches_pallas(block, rows):
    assert tk.kernels_supported(block, rows) == rk.kernels_supported(
        block, rows) is True
    x = _rand((block, rows), block + rows)
    lo, _ = _select_both(x)
    np.testing.assert_array_equal(lo.numpy(), np.abs(x).argmax(0))


def test_select_ties_zeros_and_nan_match_pallas():
    block, rows = 8, 256
    x = np.zeros((block, rows), np.float32)
    x[2, :] = -3.0                 # ties with row 5: the first wins
    x[5, :] = 3.0
    x[6, :128] = 3.0               # a three-way tie on half the lanes
    x[:, 200:] = 0.0               # all-zero lanes: row 0
    x[4, 210] = -0.0               # -0.0 ties with 0.0
    x[0, 220] = -0.0               # a -0.0 winner is reported as 0.0
    x[3, 230] = np.nan             # a NaN lane: no winner
    x[6, 231] = np.nan
    x[1, 231] = 7.0
    lo, va = _select_both(x)
    want = np.full(rows, 2)
    want[200:] = 0
    want[[230, 231]] = block
    np.testing.assert_array_equal(lo.numpy(), want)
    np.testing.assert_array_equal(va.numpy()[:200], -3.0)
    assert not np.signbit(va.numpy()[220]) and va[230] == 0 == va[231]
    # the reference's jnp twin is argmax: it names the NaN's row instead
    jlo, _ = rk.block_select(jnp.asarray(x), backend="jnp")
    assert int(jlo[230]) == 3


def test_select_valid_length():
    """Slots at flat index >= n never win, as the reference's -1 padding
    (its ragged branch, compared through the codec below)."""
    block, rows, n = 7, 50, 7 * 50 - 13
    x = _rand((block, rows), 5)
    x.reshape(-1)[n:] = 100.0      # would win every padded lane
    lo, va = tk.block_select(torch.as_tensor(x), n)
    xa = np.abs(x).reshape(-1).copy()
    xa[n:] = -1.0
    want = xa.reshape(block, rows).argmax(0)
    np.testing.assert_array_equal(lo.numpy(), want)
    np.testing.assert_array_equal(va.numpy(), x[want, np.arange(rows)])
    with pytest.raises(ValueError, match="without a slot"):
        tk.block_select(torch.as_tensor(x), rows - 1)


RECON_CASES = (
    [pytest.param(100, 1280, K, id=str(K)) for K in (1, 3, 8)]
    + [pytest.param(101, 1280, K, id=f"101x1280-{K}") for K in (1, 3, 8)]
    + [pytest.param(3, 128, K, id=f"3x128-{K}") for K in (1, 3)]
    + [pytest.param(101, 617, K, id=f"101x617-{K}") for K in (1, 3)])


@pytest.mark.parametrize("block,rows,K", RECON_CASES)
def test_reconstruct_sum_matches_pallas(block, rows, K):
    """Locals in [-1, block] (-1 out of range, block select's "no
    winner", also on every ninth lane), payloads 1 and 2 hitting payload
    0's slot on every other and every fifth lane. Odd ``rows`` take the
    reference's jnp twin, which sums from 0.0 and so returns a lone -0.0
    as 0.0 (ROADMAP C): there the values hold no -0.0."""
    rng = np.random.default_rng(K * 1000 + block + rows)
    locals_ = rng.integers(-1, block + 1, (K, rows)).astype(np.int32)
    locals_[:, ::9] = block
    if K > 1:
        locals_[1, ::2] = locals_[0, ::2]
    if K > 2:
        locals_[2, ::5] = locals_[0, ::5]
    vals = rng.standard_normal((K, rows)).astype(np.float32)
    aligned = rk.kernels_supported(block, rows)
    assert aligned == (rows % 128 == 0)
    if aligned:
        vals[0, :7] = -0.0
    want = rk.block_reconstruct_sum(jnp.asarray(locals_), jnp.asarray(vals),
                                    block, backend="pallas")
    got = tk.block_reconstruct_sum(torch.as_tensor(locals_),
                                   torch.as_tensor(vals), block)
    _eq(got, want)


@pytest.mark.parametrize("J,g,with_e", [(2, 64, False), (2, 64, True),
                                        (80, 100, True),
                                        (1, 600, False), (1, 600, True),
                                        (3, 257, False), (3, 257, True),
                                        (2, 1, False), (2, 1, True)])
def test_roundtrip_matches_pallas(J, g, with_e):
    n = J * g * 128
    x = _rand(n, J * g)
    e = 0.1 * _rand(n, J * g + 1) if with_e else None
    d, r = rk.block_roundtrip(jnp.asarray(x), J, g,
                              e=None if e is None else jnp.asarray(e),
                              backend="pallas")
    td, tr = tk.block_roundtrip(torch.as_tensor(x), J, g,
                                e=None if e is None else torch.as_tensor(e))
    _eq(td, d)
    _eq(tr, r)
    assert np.count_nonzero(td.numpy()) == J * 128


def test_roundtrip_ties_and_nan_match_pallas():
    J, g = 2, 64
    x = np.zeros(J * g * 128, np.float32)
    x3 = x.reshape(J, g, 128)
    x3[:, 5, :] = 2.0              # ties with group index 9: 5 wins
    x3[:, 9, :] = -2.0
    x3[0, :, 7] = 0.0              # an all-zero group: index 0
    x3[0, 3, 7] = -0.0
    x3[1, 11, 9] = np.nan          # a NaN group: no winner
    d, r = rk.block_roundtrip(jnp.asarray(x), J, g, backend="pallas")
    td, tr = tk.block_roundtrip(torch.as_tensor(x), J, g)
    _eq(td, d)
    _eq(tr, r)
    want = np.zeros((J, g, 128), np.float32)
    want[:, 5, :] = 2.0
    want[0, :, 7] = 0.0            # winner index 0, value 0
    want[1, :, 9] = 0.0            # no winner
    np.testing.assert_array_equal(td.numpy().reshape(J, g, 128), want)
    assert np.isnan(tr.numpy().reshape(J, g, 128)[1, 11, 9])


@pytest.mark.parametrize("J,g,with_e", [(80, 100, True), (1, 600, False),
                                        (3, 257, True), (2, 40, False)])
def test_roundtrip_split_ties_match_pallas(J, g, with_e):
    n = J * g * 128
    x = _rand(n, 7 * g)
    e = 0.1 * _rand(n, 7 * g + 1) if with_e else None
    p = tk.roundtrip_plan(J, g)
    split_ties(torch.from_numpy(x).view(J, g, 128), p.rows,
               p.threads // p.width)
    if with_e:              # the planted values (-0.0 too) survive the add
        e.reshape(J, g, 128)[:, :, :10] = -0.0
    d, r = rk.block_roundtrip(jnp.asarray(x), J, g,
                              e=None if e is None else jnp.asarray(e),
                              backend="pallas")
    td, tr = tk.block_roundtrip(torch.as_tensor(x), J, g,
                                e=None if e is None else torch.as_tensor(e))
    _eq(td, d)
    _eq(tr, r)
    got = td.numpy().reshape(J, g, 128)
    if g > 35:                      # the first of each tie won
        assert (got[:, 1, 0] == 50.0).all() and (got[:, 3, 1] == 50.0).all()
    assert np.isnan(tr.numpy().reshape(J, g, 128)[:, 2, 5]).all()
    assert (got[:, :, 8] == 0).all()              # the NaN column: no winner
    res = tr.numpy().reshape(J, g, 128)
    if g > 1:           # a lone -0.0 ties with 0.0 and loses to row 0
        assert np.signbit(res[:, g // 2, 6]).all()
    assert np.signbit(got[:, 0, 7]).all()         # a -0.0 winner stays -0.0


@pytest.mark.parametrize("block,rows", [(100, 1280), (600, 128)])
def test_select_split_ties_match_pallas(block, rows):
    x = _rand((block, rows), block)
    p = tk.select_plan(block, rows)
    split_ties(torch.from_numpy(x), p.rows, p.threads // 32)
    lo, va = _select_both(x)
    assert lo[0] == 1 and lo[1] == 3 and va[0] == 50.0
    assert lo[5] == 2 and va[5] == np.inf and lo[8] == block
    assert lo[6] == 0 and lo[7] == 0 and not np.signbit(va[7].item())


def _covered(plan, height, columns, width, ends):
    """How often each (row, column) of ``columns`` column slices of
    ``width`` the plan's threads visit (the kernels' index arithmetic);
    ``ends[col]`` is a column's row count."""
    cnt = np.zeros((height, columns * width), np.int32)
    S = plan.threads // width
    for b in range(plan.blocks):
        rank, sl = b % plan.cluster, b // plan.cluster
        lo = rank * plan.rows
        for t in range(plan.threads):
            col = sl * width + t % width
            hi = min(ends[col], lo + plan.rows)
            cnt[lo + t // width:hi:S, col] += 1
    return cnt


@pytest.mark.parametrize("J,g", [(80, 100), (8, 1000), (1, 8000), (3, 257),
                                 (2, 1), (1, 8193), (0, 5)])
def test_roundtrip_plan_covers_every_slot_once(J, g):
    p = tk.roundtrip_plan(J, g)
    assert p.threads % 32 == 0 and p.threads <= 512 and p.cluster <= 16
    cnt = _covered(p, g, J * 32 // p.width, p.width, [g] * (J * 32))
    assert (cnt == 1).all()


@pytest.mark.parametrize("block,rows,n", [(101, 5617, 567_296),
                                          (100, 10240, 1_024_000),
                                          (1000, 1024, 1_024_000),
                                          (7, 50, 337), (4, 0, 0)])
def test_select_plan_covers_every_slot_once(block, rows, n):
    p = tk.select_plan(block, rows)
    slices = -(-rows // 32)
    ends = [min(block, -(-(n - c) // rows)) if c < rows else 0
            for c in range(slices * 32)]
    cnt = _covered(p, block, slices, 32, ends)[:, :rows].reshape(-1)
    assert (cnt[:n] == 1).all() and (cnt[n:] == 0).all()


@pytest.mark.parametrize("K,block,rows", [(1, 101, 5617), (1, 100, 10240),
                                         (8, 100, 10240), (3, 3, 128),
                                         (1, 1000, 1024), (2, 2, 1),
                                         (1, 4, 0), (1, 600_000, 1)])
@pytest.mark.parametrize("vec", [True, False])
def test_reconstruct_plan_covers_every_element_once(K, block, rows, vec):
    """The kernel's index arithmetic on ``reconstruct_plan``: a grid of
    (slices / warps a block, stripes, at most 65,535), warp w of block
    (bx, by) on the 128-column slice bx·W + w and the rows [r0, r0 + R),
    r0 = (by + m·gy)·R, its lane on 4 columns (adjacent, or 32 apart).
    600,000 rows of one column (k = 1 on the strided layout) outnumber
    the grid's stripes."""
    p = tk.reconstruct_plan(K, block, rows)
    assert 1 <= p.rows <= 8 and p.threads % 32 == 0 and p.threads <= 256
    W, slices = p.threads // 32, -(-rows // 128)
    gx, gy = -(-slices // W), min(-(-block // p.rows), 65535)
    assert p.blocks == (gx * gy if rows else 0)
    cnt = np.zeros((block, slices * 128), np.int32)
    lane = np.arange(32)
    for bx in range(gx if rows else 0):
        for w in range(W):
            c0 = (bx * W + w) * 128 + (4 * lane if vec else lane)
            cols = (c0[:, None] + np.arange(4)[None, :] * (1 if vec else 32))
            cols = cols[cols < rows]
            for by in range(gy):
                for r0 in range(by * p.rows, block, gy * p.rows):
                    cnt[r0:r0 + p.rows, cols] += 1
    assert (cnt[:, :rows] == 1).all() and (cnt[:, rows:] == 0).all()


@pytest.mark.parametrize("K,block,rows", [(1, 101, 5617), (1, 100, 10240),
                                         (8, 100, 10240)])
def test_reconstruct_plan_fills_the_card(K, block, rows):
    """The training tail and a chunk: one wave of 4 to 12 warps an SM of
    the H100's 132 (12 fit at the kernel's 160 registers), a thread
    holding at most 8 rows."""
    p = tk.reconstruct_plan(K, block, rows)
    warps = -(-rows // 128) * -(-block // p.rows)
    assert 132 * 4 <= warps <= 132 * 12 and p.rows <= 8


@pytest.mark.parametrize("J,g", [(80, 100), (8, 1000), (1, 8000)])
def test_roundtrip_plan_fills_the_card_at_a_chunk(J, g):
    """One 1,024,000-element chunk at k = 0.01, 0.001 and 128: about two
    blocks an SM of the H100's 132 whatever the group height, each thread
    holding its rows (at most 4) in registers: one read."""
    p = tk.roundtrip_plan(J, g)
    assert p.blocks >= 128 and p.blocks * p.threads >= 64_000
    S = p.threads // p.width
    assert -(-p.rows // S) <= 4


def test_topk_compressor_k128_roundtrip_matches_reference(monkeypatch):
    """k = 128 on 76,800 elements tiles as (1, 600): one tall group a
    lane, through the reference's Pallas kernel (interpret mode)."""
    monkeypatch.setenv("BYTEPS_KERNEL_BACKEND", "pallas")
    n = 76_800
    assert ttopk.tiled_shape(128, n) == (1, 600)
    x = _rand(n, 11)
    e = 0.1 * _rand(n, 12)
    rd, rr = rtopk.TopkCompressor(k=128, selection="block").roundtrip(
        jnp.asarray(x), e=jnp.asarray(e))
    td, tr = TopkCompressor(k=128, selection="block").roundtrip(
        torch.as_tensor(x), e=torch.as_tensor(e))
    _eq(td, rd)
    _eq(tr, rr)
    assert np.count_nonzero(td.numpy()) == 128


# --- the codec ----------------------------------------------------------------
KN = [(0.01, 1_024_000), (0.01, 567_296), (0.01, 12_800), (0.01, 10_752),
      (256, 25_600), (256, 10_752), (100, 5000), (0.5, 1000), (3, 7),
      (1.0, 64), (128, 128), (0.25, 1024), (1000, 100)]


@pytest.mark.parametrize("k,n", KN)
def test_layout_helpers_match_reference(k, n):
    assert ttopk.resolve_k(k, n) == rtopk.resolve_k(k, n)
    assert ttopk.block_shape(k, n) == rtopk.block_shape(k, n)
    assert ttopk.tiled_shape(k, n) == rtopk.tiled_shape(k, n)


def test_layouts_of_the_training_chunks():
    # the default 4,096,000-byte partition and GPT-2 medium's tail chunk
    assert ttopk.tiled_shape(0.01, 1_024_000) == (80, 100)
    assert ttopk.tiled_shape(0.01, 567_296) is None
    assert ttopk.block_shape(0.01, 567_296) == (5617, 101)
    assert not tk.kernels_supported(101, 5617)


CODEC_CASES = [
    ("block", 0.01, 25_600),       # tiled (2, 100)
    ("block", 0.01, 10_752),       # strided, ragged (pad 55)
    ("block", 100, 5000),          # strided, aligned (50 x 100)
    ("exact", 0.01, 10_752),
    ("approx", 37, 4000),
]


@pytest.mark.parametrize("selection,k,n", CODEC_CASES)
def test_codec_matches_reference(selection, k, n):
    ref = rtopk.TopkCompressor(k=k, selection=selection)
    port = TopkCompressor(k=k, selection=selection)
    x = _rand(n, n)
    e = 0.1 * _rand(n, n + 1)
    rp, tp = ref.compress(jnp.asarray(x)), port.compress(torch.as_tensor(x))
    if selection == "approx":
        # approx_max_k off the TPU is the exact top k, as a set
        np.testing.assert_array_equal(np.sort(tp["indices"].numpy()),
                                      np.sort(np.asarray(rp["indices"])))
        return
    for key in ("indices", "values"):
        _eq(tp[key], rp[key])
    _eq(port.decompress(tp, n), ref.decompress(rp, n))
    rd, rr = ref.roundtrip(jnp.asarray(x), e=jnp.asarray(e))
    td, tr = port.roundtrip(torch.as_tensor(x), e=torch.as_tensor(e))
    _eq(td, rd)
    _eq(tr, rr)
    # decompress_sum over K = 3 workers' payloads
    xs = [_rand(n, 50 + w) for w in range(3)]
    rps = [ref.compress(jnp.asarray(a)) for a in xs]
    tps = [port.compress(torch.as_tensor(a)) for a in xs]
    rs = ref.decompress_sum({k_: jnp.stack([p[k_] for p in rps])
                             for k_ in rps[0]}, n)
    ts = port.decompress_sum({k_: torch.stack([p[k_] for p in tps])
                              for k_ in tps[0]}, n)
    if selection == "exact":       # the reference's vmap sum: roundoff
        np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=1e-6,
                                   atol=1e-7)
    else:
        _eq(ts, rs)
    assert port.compressed_bytes(n) == ref.compressed_bytes(n)


@pytest.mark.parametrize("K", [1, 2, 3])
def test_tiled_decompress_sum_signed_zero_matches_reference(K):
    """The tiled (80, 100) layout of a 1,024,000-element chunk: K stacked
    payloads, the first holding -0.0 values, sum from zeros as the
    reference's does, so a lone -0.0 comes back 0.0 at K = 1 too."""
    n = 1_024_000
    ref = rtopk.TopkCompressor(k=0.01, selection="block")
    port = TopkCompressor(k=0.01, selection="block")
    assert ttopk.tiled_shape(0.01, n) == (80, 100)
    pays = [port.compress(torch.as_tensor(_rand(n, 90 + w)))
            for w in range(K)]
    idx = torch.stack([p["indices"] for p in pays]).numpy()
    vals = torch.stack([p["values"] for p in pays]).numpy()
    vals[0, :5] = -0.0
    want = ref.decompress_sum({"indices": jnp.asarray(idx),
                               "values": jnp.asarray(vals)}, n)
    got = port.decompress_sum({"indices": torch.as_tensor(idx),
                               "values": torch.as_tensor(vals)}, n)
    _eq(got, want)
    assert not np.signbit(got.numpy()[idx[0, :5]]).any()


def test_ragged_chunk_with_ties_matches_reference():
    """The ragged tail through block_select(n): first-max on ties and on
    all-zero lanes, as the reference's argmax branch."""
    n = 10_752
    x = np.zeros(n, np.float32)
    x[::3] = 1.5
    x[1::7] = -1.5
    ref, port = (rtopk.TopkCompressor(k=0.01, selection="block"),
                 TopkCompressor(k=0.01, selection="block"))
    rp, tp = ref.compress(jnp.asarray(x)), port.compress(torch.as_tensor(x))
    for key in ("indices", "values"):
        _eq(tp[key], rp[key])


def test_spec_and_validation():
    spec = from_params({"compressor": "topk", "k": 0.01, "ef": "vanilla",
                        "selection": "block"})
    assert isinstance(spec.compressor, TopkCompressor)
    assert spec.compressor.selection == "block" and spec.ef
    assert not spec.compressor.presummable
    with pytest.raises(ValueError, match="unknown selection"):
        TopkCompressor(selection="heap")
    with pytest.raises(ValueError, match="128"):
        tk.block_roundtrip(torch.zeros(100), 1, 1)
    with pytest.raises(ValueError, match="2\\^31"):
        tk._check_size(2 ** 31, "x")
