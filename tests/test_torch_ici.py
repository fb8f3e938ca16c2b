"""The port's aggregation tier against the reference's ICI tier.

* One rank: the compressed all-reduce's n == 1 fast path (one codec
  round trip, error feedback included) against the reference's on a
  1-device mesh, for identity, onebit, top-k (block on the tiled and
  strided layouts, exact), fp16 and fp8, and the compressed
  reduce-scatter's for onebit and top-k; the general body that
  stochastic codecs take at one rank; and ``push_pull_inside`` with
  a small partition (chunks that cut through leaves, one onebit scale
  per chunk) against the reference's inside ``shard_map`` on that mesh.
* Two ranks: two processes on the ``gloo`` backend (a ``FileStore`` in
  the test's directory) that import only torch and the port, against the
  reference on a 2-device CPU mesh: the raw all-reduce; onebit with
  error feedback, the pull compressed (two-way) or not (the result on
  each rank and each rank's new residual), with the wire-byte counters;
  identity with error feedback (payloads summed positionally); top-k
  block (tiled and ragged strided) and fp8 with error feedback, with
  their wire bytes; randomk's positional sum (the same support on both
  ranks, from one key); the compressed reduce-scatter for onebit and
  top-k; the raw reduce-scatter, all-gather and broadcast; and
  ``push_pull_inside`` over chunks, raw (f32 and, under
  ``BYTEPS_REDUCE_DTYPE=bfloat16``, bf16 sums) and onebit + EF.

Tolerances: raw sums are exact (two f32 terms add the same way
everywhere). onebit results carry mean(|x|) scales, which the two
frameworks reduce in different orders: 1e-6 relative (the scales' own
agreement), the words themselves bit-equal. top-k, fp16 and fp8 select,
round and scale exactly alike; their owner sums add two terms, so they
are held to the same 1e-6."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from byteps_tpu.comm import ici as rici
from byteps_tpu.common.metrics import get_registry as r_registry
from byteps_tpu.compression import Compressor as RCompressor
from byteps_tpu.compression import Fp8Compressor as RFp8
from byteps_tpu.compression import Fp16Compressor as RFp16
from byteps_tpu.compression import OnebitCompressor as ROnebit
from byteps_tpu.compression import TopkCompressor as RTopk
from byteps_tpu.compression import from_params as r_from_params
from byteps_tpu.jax.optimizer import push_pull_inside as r_push_pull
from byteps_tpu_torch.comm import ici as tici
from byteps_tpu_torch.compression import (Compressor, DitheringCompressor,
                                          Fp8Compressor, Fp16Compressor,
                                          OnebitCompressor,
                                          RandomkCompressor, TopkCompressor,
                                          fold_in)
from byteps_tpu_torch.compression import from_params
from byteps_tpu_torch.optimizer import push_pull_inside

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-6
L = 5000
LT = 51_200                     # 25,600-element segments: tiled (2, 100)
PARTITION_BYTES = 4096          # 1024 f32 elements a chunk
SHAPES = [(37, 11), (1024,), (3, 700), (5,)]
ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}
CODECS = {"identity": (RCompressor, Compressor),
          "onebit": (lambda: ROnebit(scaling=True),
                     lambda: OnebitCompressor(scaling=True)),
          "topk-block": (lambda: RTopk(k=0.01, selection="block"),
                         lambda: TopkCompressor(k=0.01, selection="block")),
          "topk-exact": (lambda: RTopk(k=0.01), lambda: TopkCompressor(k=0.01)),
          "fp16": (RFp16, Fp16Compressor),
          "fp8": (RFp8, Fp8Compressor)}
# the n == 1 cases' lengths: L strided for top-k block; 25,600 tiled (2, 100)
N1_CASES = [(c, L) for c in sorted(CODECS)] + [("topk-block", 25_600)]


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _mesh(n):
    return jax.make_mesh((n,), ("dp",), devices=jax.devices()[:n])


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("codec,n", N1_CASES)
def test_n1_fast_path_matches_reference(codec, n):
    rmk, tmk = CODECS[codec]
    g, e = _rand(n, 1), _rand(n, 2, 0.1)
    want, want_e = rici.compressed_allreduce_flat(
        jnp.asarray(g[None]), rmk(), _mesh(1), average=True,
        rng=jax.random.PRNGKey(9), ef_residual=jnp.asarray(e[None]))
    out, new_e = tici.compressed_allreduce_flat(
        torch.as_tensor(g), tmk(), ef_residual=torch.as_tensor(e))
    _close(out.numpy(), np.asarray(want).reshape(-1))
    _close(new_e.numpy(), np.asarray(want_e).reshape(-1))
    # without EF: the round trip alone
    plain = tici.compressed_allreduce_local(torch.as_tensor(g), tmk(), 1)
    _close(plain.numpy(), np.asarray(rici.compressed_allreduce_flat(
        jnp.asarray(g[None]), rmk(), _mesh(1))).reshape(-1))


@pytest.mark.parametrize("codec", ["onebit", "topk-block"])
def test_n1_reduce_scatter_matches_reference(codec):
    rmk, tmk = CODECS[codec]
    g = _rand(L, 5)
    want = rici.compressed_reduce_scatter_flat(jnp.asarray(g[None]), rmk(),
                                               _mesh(1))
    got = tici.compressed_reduce_scatter_flat(torch.as_tensor(g), tmk())
    _close(got.numpy(), np.asarray(want))
    out, ne = tici.compressed_reduce_scatter_local(
        torch.as_tensor(g), tmk(), 1, average=True,
        ef_residual=torch.zeros(L))
    _close(out.numpy(), np.asarray(want))
    _close(ne.numpy(), g - np.asarray(want))


def test_n1_stochastic_codecs_take_the_general_body():
    """At one rank a stochastic codec runs the general body, as the
    reference's does: segment 0 with the key fold_in(rng, 0) and, for a
    codec that is not presummable, the owner's recompression of its sum
    with the same key (two rounds of dithering)."""
    g, rng = torch.as_tensor(_rand(L, 6)), 77
    rk = RandomkCompressor(k=0.02)
    key = fold_in(rng, 0)
    out, ne = tici.compressed_allreduce_local(g, rk, 1, ef_residual=0 * g,
                                              rng=rng)
    want = rk.decompress(rk.compress(g, key), L, rng=key)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    np.testing.assert_array_equal(ne.numpy(), (g - want).numpy())
    assert np.count_nonzero(out.numpy()) == 100
    dt = DitheringCompressor(s=15)
    out = tici.compressed_allreduce_local(g, dt, 1, rng=rng)
    once = dt.decompress(dt.compress(g, key), L)
    twice = dt.decompress(dt.compress(once, key), L)
    np.testing.assert_array_equal(out.numpy(), twice.numpy())
    rs = tici.compressed_reduce_scatter_local(g, dt, 1, rng=rng)
    np.testing.assert_array_equal(rs.numpy(), once.numpy())
    for codec in (rk, dt):
        with pytest.raises(ValueError, match="rng key"):
            tici.compressed_allreduce_local(g, codec, 1)


def _ref_push_pull(mesh, grads, ef, spec_params):
    """The reference's push_pull_inside on ``mesh``: per-device grad
    trees and EF rows stacked on a leading axis of size n."""
    n = mesh.shape["dp"]
    spec = r_from_params(spec_params)

    def body(gs, e):
        gs = [g[0] for g in gs]
        out, ne = r_push_pull(gs, axis="dp", n=n, spec=spec,
                              ef_residual=e[0],
                              partition_bytes=PARTITION_BYTES)
        return [o[None] for o in out], ne[None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                               out_specs=(P("dp"), P("dp")),
                               check_vma=False))
    out, ne = fn([jnp.asarray(g) for g in grads], jnp.asarray(ef))
    return [np.asarray(o) for o in out], np.asarray(ne)


def _grads(n, seed):
    """Per-rank gradient leaves, stacked (n, *shape)."""
    return [_rand((n,) + s, seed + i) for i, s in enumerate(SHAPES)]


def test_push_pull_inside_chunks_like_reference():
    grads = _grads(1, 20)
    total = sum(int(np.prod(s)) for s in SHAPES)
    ef = _rand((1, total), 30, 0.1)
    want, want_e = _ref_push_pull(_mesh(1), grads, ef, ONEBIT_EF)
    out, new_e = push_pull_inside(
        [torch.as_tensor(g[0]) for g in grads], spec=from_params(ONEBIT_EF),
        ef_residual=torch.as_tensor(ef[0]), partition_bytes=PARTITION_BYTES)
    assert len(out) == len(SHAPES)
    for o, w, s in zip(out, want, SHAPES):
        assert tuple(o.shape) == s
        _close(o.numpy(), w[0])
    _close(new_e.numpy(), want_e[0])
    # one onebit scale per 1024-element chunk: a single whole-vector
    # round trip gives a different result
    whole, _ = OnebitCompressor().roundtrip(
        torch.cat([torch.as_tensor(g[0]).reshape(-1) for g in grads]),
        e=torch.as_tensor(ef[0]))
    assert not np.allclose(whole.numpy()[:SHAPES[0][0] * SHAPES[0][1]],
                           want[0].reshape(-1))
    # raw, one rank: the identity, and no error carried forward
    raw, raw_e = push_pull_inside([torch.as_tensor(g[0]) for g in grads],
                                  ef_residual=torch.as_tensor(ef[0]))
    for o, g in zip(raw, grads):
        np.testing.assert_array_equal(o.numpy(), g[0])
    assert not raw_e.any()


_RANK = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from byteps_tpu_torch.comm import ici
from byteps_tpu_torch.common.config import reset_config
from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.compression import (
    Compressor, Fp8Compressor, OnebitCompressor, RandomkCompressor,
    TopkCompressor, from_params)
from byteps_tpu_torch.optimizer import push_pull_inside

rank, world, store_path, io = int(sys.argv[1]), int(sys.argv[2]), \
    sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)
d = np.load(io + "/in.npz")
x, e = torch.as_tensor(d["x"][rank]), torch.as_tensor(d["e"][rank])
out = {"raw": ici.allreduce_flat(x).numpy()}
before = get_registry().snapshot("ici.")["counters"]
o, ne = ici.compressed_allreduce_flat(x, OnebitCompressor(scaling=True),
                                      two_way=True, ef_residual=e)
after = get_registry().snapshot("ici.")["counters"]
out["wire"] = np.array([after[k] - before.get(k, 0) for k in
                        ("ici.wire_bytes", "ici.logical_bytes")])
out["onebit"], out["onebit_e"] = o.numpy(), ne.numpy()
o, ne = ici.compressed_allreduce_flat(x, OnebitCompressor(scaling=True),
                                      two_way=False, ef_residual=e)
out["oneway"], out["oneway_e"] = o.numpy(), ne.numpy()
o, ne = ici.compressed_allreduce_flat(x, Compressor(), ef_residual=e)
out["identity"], out["identity_e"] = o.numpy(), ne.numpy()
xt, et = torch.as_tensor(d["xt"][rank]), torch.as_tensor(d["et"][rank])
for name, codec, a, b in (
        ("topk_tiled", TopkCompressor(k=0.01, selection="block"), xt, et),
        ("topk_ragged", TopkCompressor(k=0.013, selection="block"), x, e),
        ("fp8", Fp8Compressor(), x, e)):
    before = get_registry().snapshot("ici.")["counters"]
    o, ne = ici.compressed_allreduce_flat(a, codec, ef_residual=b)
    after = get_registry().snapshot("ici.")["counters"]
    out[name], out[name + "_e"] = o.numpy(), ne.numpy()
    out[name + "_wire"] = np.array([after[k] - before.get(k, 0) for k in
                                    ("ici.wire_bytes", "ici.logical_bytes")])
out["randomk"] = ici.compressed_allreduce_flat(
    x, RandomkCompressor(k=0.02), rng=1234).numpy()
for name, codec in (("rs_onebit", OnebitCompressor(scaling=True)),
                    ("rs_topk", TopkCompressor(k=0.013, selection="block"))):
    out[name] = ici.compressed_reduce_scatter_flat(x, codec).numpy()
seg = ici.reduce_scatter_flat(x)
out["reduce_scatter"] = seg.numpy()
out["all_gather"] = ici.all_gather_flat(seg, length=x.shape[0]).numpy()
out["broadcast"] = ici.broadcast_flat(x, root=1).numpy()
grads = [torch.as_tensor(d[f"g{i}"][rank]) for i in range(int(d["ng"]))]
for i, a in enumerate(push_pull_inside(grads,
                                       partition_bytes=int(d["pb"]))):
    out[f"raw_pp{i}"] = a.numpy()
agg, ne = push_pull_inside(grads, spec=from_params(
    {"compressor": "onebit", "ef": "vanilla"}),
    ef_residual=torch.as_tensor(d["ef"][rank]),
    partition_bytes=int(d["pb"]))
for i, a in enumerate(agg):
    out[f"pp{i}"] = a.numpy()
out["pp_e"] = ne.numpy()
os.environ["BYTEPS_REDUCE_DTYPE"] = "bfloat16"
reset_config()
for i, a in enumerate(push_pull_inside(grads,
                                       partition_bytes=int(d["pb"]))):
    out[f"bf16_pp{i}"] = a.numpy()
np.savez(f"{io}/out{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
print(json.dumps({"rank": rank, "ok": True}))
"""


def _tiled_inputs():
    """The two ranks' (LT,) gradients and EF residuals for tiled top-k."""
    return {"xt": _rand((2, LT), 8), "et": _rand((2, LT), 9, 0.1)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    io = tmp_path_factory.mktemp("gloo")
    x, e = _rand((2, L), 3), _rand((2, L), 4, 0.1)
    grads = _grads(2, 40)
    total = sum(int(np.prod(s)) for s in SHAPES)
    ef = _rand((2, total), 50, 0.1)
    np.savez(io / "in.npz", x=x, e=e, ef=ef, ng=len(grads),
             **_tiled_inputs(),
             pb=PARTITION_BYTES, **{f"g{i}": g for i, g in enumerate(grads)})
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), "2", str(io / "store"),
         str(io)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        res = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, res):
        assert p.returncode == 0, se[-3000:]
        assert json.loads(so.strip().splitlines()[-1])["ok"]
    outs = [dict(np.load(io / f"out{r}.npz")) for r in range(2)]
    return x, e, grads, ef, outs


def test_two_ranks_raw_allreduce(two_ranks):
    x, _, _, _, outs = two_ranks
    want = np.asarray(rici.allreduce_flat(jnp.asarray(x), _mesh(2)))
    for o in outs:
        np.testing.assert_array_equal(o["raw"], want)


@pytest.mark.parametrize("case", ["onebit", "oneway", "identity"])
def test_two_ranks_compressed_allreduce_ef(two_ranks, case):
    x, e, _, _, outs = two_ranks
    codec = RCompressor() if case == "identity" else ROnebit(scaling=True)
    reg = r_registry()
    before = dict(reg.snapshot("ici.")["counters"])
    want, want_e = rici.compressed_allreduce_flat(
        jnp.asarray(x), codec, _mesh(2), average=True,
        rng=jax.random.PRNGKey(0), two_way=case != "oneway",
        ef_residual=jnp.asarray(e))
    after = reg.snapshot("ici.")["counters"]
    want, want_e = np.asarray(want).reshape(-1), np.asarray(want_e)
    for r, o in enumerate(outs):
        _close(o[case], want)
        _close(o[f"{case}_e"], want_e[r])
    # both ranks hold the same result
    np.testing.assert_array_equal(outs[0][case], outs[1][case])
    if case == "identity":       # exact: the payloads are the values
        np.testing.assert_allclose(outs[0][case], (x + e).mean(0),
                                   rtol=RTOL, atol=RTOL)
    else:                        # compressed: not the raw mean
        assert not np.allclose(outs[0][case], x.mean(0), atol=1e-3)
    if case == "onebit":         # wire bytes of this rank, reference's count
        np.testing.assert_array_equal(outs[0]["wire"], [
            after[k] - before.get(k, 0)
            for k in ("ici.wire_bytes", "ici.logical_bytes")])
        # 2500-element segments pad to 128 words: ~19x, not 32x
        assert outs[0]["wire"][0] < outs[0]["wire"][1] / 16


def test_two_ranks_push_pull_inside_bf16_reduce(two_ranks, monkeypatch):
    """BYTEPS_REDUCE_DTYPE=bfloat16: the raw chunks are summed in bf16
    (2048 elements a 4096-byte chunk), as the reference's psum does.
    Exact: each rank's bf16 leaf is the same, and a sum of two terms
    rounds once whichever way it is computed."""
    from byteps_tpu.common.config import reset_config as r_reset

    _, _, grads, _, outs = two_ranks
    monkeypatch.setenv("BYTEPS_REDUCE_DTYPE", "bfloat16")
    r_reset()
    total = sum(int(np.prod(s)) for s in SHAPES)
    want, _ = _ref_push_pull(_mesh(2), grads, np.zeros((2, total),
                                                       np.float32), None)
    r_reset()
    for r, o in enumerate(outs):
        for i, (w, g) in enumerate(zip(want, grads)):
            np.testing.assert_array_equal(o[f"bf16_pp{i}"], w[r])
            # bf16-rounded: near the f32 mean, but not equal to it
            np.testing.assert_allclose(o[f"bf16_pp{i}"], g.mean(0),
                                       rtol=2e-2, atol=4e-3)
    assert any(np.abs(outs[0][f"bf16_pp{i}"] - g.mean(0)).max() > 0
               for i, g in enumerate(grads))


def test_reduce_dtype_is_checked(monkeypatch):
    from byteps_tpu_torch.common.config import get_config, reset_config

    monkeypatch.setenv("BYTEPS_REDUCE_DTYPE", "float16")
    reset_config()
    try:
        with pytest.raises(ValueError, match="BYTEPS_REDUCE_DTYPE"):
            get_config()
    finally:
        monkeypatch.delenv("BYTEPS_REDUCE_DTYPE")
        reset_config()


def test_two_ranks_push_pull_inside_chunked(two_ranks):
    _, _, grads, ef, outs = two_ranks
    want, want_e = _ref_push_pull(_mesh(2), grads, ef, ONEBIT_EF)
    for r, o in enumerate(outs):
        for i, (w, g) in enumerate(zip(want, grads)):
            _close(o[f"pp{i}"], w[r])
            # raw: the mean of the two ranks' leaves
            _close(o[f"raw_pp{i}"], g.mean(0))
        _close(o["pp_e"], want_e[r])


TWO_RANK_CODECS = {
    "topk_tiled": (lambda: RTopk(k=0.01, selection="block"), "xt", "et"),
    "topk_ragged": (lambda: RTopk(k=0.013, selection="block"), "x", "e"),
    "fp8": (RFp8, "x", "e"),
}


@pytest.mark.parametrize("case", sorted(TWO_RANK_CODECS))
def test_two_ranks_topk_fp8_ef(two_ranks, case):
    x, e, _, _, outs = two_ranks
    mk, xn, en = TWO_RANK_CODECS[case]
    xs = {"x": x, "e": e, **_tiled_inputs()}
    reg = r_registry()
    before = dict(reg.snapshot("ici.")["counters"])
    want, want_e = rici.compressed_allreduce_flat(
        jnp.asarray(xs[xn]), mk(), _mesh(2), average=True,
        rng=jax.random.PRNGKey(0), ef_residual=jnp.asarray(xs[en]))
    after = reg.snapshot("ici.")["counters"]
    want, want_e = np.asarray(want).reshape(-1), np.asarray(want_e)
    for r, o in enumerate(outs):
        _close(o[case], want)
        _close(o[f"{case}_e"], want_e[r])
    np.testing.assert_array_equal(outs[0][case], outs[1][case])
    np.testing.assert_array_equal(outs[0][f"{case}_wire"], [
        after[k] - before.get(k, 0)
        for k in ("ici.wire_bytes", "ici.logical_bytes")])


def test_two_ranks_randomk_positional_sum(two_ranks):
    """Both ranks draw segment j's support from fold_in(rng, j), so the
    payloads sum positionally: the result is the mean of the two ranks'
    scaled values on that support, 0 elsewhere, on both ranks."""
    x, _, _, _, outs = two_ranks
    seg, k = L // 2, 50
    want = np.zeros(L, np.float32)
    for j in range(2):
        idx = RandomkCompressor._indices(fold_in(1234, j), seg, k,
                                         torch.device("cpu")).numpy()
        vals = [(torch.as_tensor(x[r, j * seg:(j + 1) * seg][idx])
                 * (seg / k)).numpy() for r in range(2)]
        want[j * seg + idx] = (vals[0] + vals[1]) / 2
    for o in outs:
        np.testing.assert_array_equal(o["randomk"], want)
    assert np.count_nonzero(want) == 2 * k


@pytest.mark.parametrize("codec", ["onebit", "topk"])
def test_two_ranks_compressed_reduce_scatter(two_ranks, codec):
    x, _, _, _, outs = two_ranks
    mk = (lambda: ROnebit(scaling=True)) if codec == "onebit" else (
        lambda: RTopk(k=0.013, selection="block"))
    want = np.asarray(rici.compressed_reduce_scatter_flat(
        jnp.asarray(x), mk(), _mesh(2)))
    seg = L // 2
    for r, o in enumerate(outs):
        _close(o[f"rs_{codec}"], want[r * seg:(r + 1) * seg])


def test_two_ranks_raw_collectives(two_ranks):
    x, _, _, _, outs = two_ranks
    rs = np.asarray(rici.reduce_scatter_flat(jnp.asarray(x), _mesh(2)))
    ag = np.asarray(rici.all_gather_flat(jnp.asarray(rs), _mesh(2),
                                         length=L))
    bc = np.asarray(rici.broadcast_flat(jnp.asarray(x), _mesh(2), root=1))
    seg = L // 2
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["reduce_scatter"],
                                      rs[r * seg:(r + 1) * seg])
        np.testing.assert_array_equal(o["all_gather"], ag)
        np.testing.assert_array_equal(o["broadcast"], bc)
    np.testing.assert_array_equal(outs[0]["all_gather"], x.sum(0))
    np.testing.assert_array_equal(outs[0]["broadcast"], x[1])
