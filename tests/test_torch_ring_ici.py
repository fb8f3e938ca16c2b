"""The ``ring`` wire tier of the port's compressed collectives
(``comm/ici.py``, ``BYTEPS_ICI_TIER=ring``) against its staged tier and
against the reference's ring tier, mirroring ``tests/test_ring_ici.py``.

Four ranks on the ``gloo`` backend, started once for the module, run
every case under both tiers (the ring on the CPU: the plain versions of
``ops/ring_collective_kernels.py``):

* identity, onebit, top-k (exact and block, k = 0.25) and fp16 at
  L = 1003 (padded segments), with error feedback on and off and
  ``two_way`` on and off: the all-reduce and each rank's new residual
  are bit-equal across the tiers (the tiers move bits and share the
  aggregation arithmetic) and equal the reference's
  ``compressed_allreduce_flat(..., tier="ring")`` on a 4-device mesh to
  1e-6, the tolerance of the two-rank tests (``tests/test_torch_ici.py``:
  the frameworks reduce onebit's mean(|x|) scales in different orders);
* the same for the reduce-scatter, and onebit's with error feedback;
* randomk (stochastic, presummable: the ring's presum chain, with no
  collect exchange): the same support under both tiers, values within
  1e-5 (chain order against the worker-order fold);
* dithering (stochastic, not presummable: the collect exchange): ring
  equals staged;
* ``BYTEPS_ICI_TIER`` and the per-call ``tier=`` pick the transport, an
  unknown tier raises, and ``ici.wire_bytes`` is the same under both;
  the ring moves a payload's leaves in one tree call a direction;
* at n = 2 and 3 (groups of their own), onebit + EF at chunk level, the
  pull compressed or not: ring equals staged bit for bit, through one
  ``ring_collect_tree`` and one ``ring_allgather_tree`` call a chunk.

The port's stochastic codecs draw from ``torch.Generator``s, so randomk
and dithering are held against the port's staged tier, not the
reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.comm import ici as rici
from byteps_tpu.compression import Compressor as RCompressor
from byteps_tpu.compression import Fp16Compressor as RFp16
from byteps_tpu.compression import OnebitCompressor as ROnebit
from byteps_tpu.compression import TopkCompressor as RTopk
from byteps_tpu_torch.comm import ici as tici
from byteps_tpu_torch.compression import Compressor

from test_torch_ring import run_group

N = 4
L = 1003
RTOL = 1e-6
COMBOS = [(False, True), (False, False), (True, True), (True, False)]
REF_CODECS = {"identity": RCompressor,
              "onebit": lambda: ROnebit(scaling=True),
              "topk": lambda: RTopk(k=0.25),
              "topk-block": lambda: RTopk(k=0.25, selection="block"),
              "fp16": RFp16}

_RANK = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from byteps_tpu_torch.comm import ici
from byteps_tpu_torch.common.config import reset_config
from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.compression import (
    Compressor, DitheringCompressor, Fp16Compressor, OnebitCompressor,
    RandomkCompressor, TopkCompressor)

rank, world, store_path, io = int(sys.argv[1]), int(sys.argv[2]), \
    sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)
d = {k: torch.as_tensor(v[rank]) for k, v in np.load(io + "/in.npz").items()}
CODECS = {"identity": Compressor,
          "onebit": lambda: OnebitCompressor(scaling=True),
          "topk": lambda: TopkCompressor(k=0.25),
          "topk-block": lambda: TopkCompressor(k=0.25, selection="block"),
          "fp16": Fp16Compressor}
WIRE = ("ici.wire_bytes", "ici.logical_bytes")


def wire():
    c = get_registry().snapshot("ici.")["counters"]
    return np.array([c.get(k, 0) for k in WIRE])


out = {}
for tier in ("staged", "ring"):
    for name, mk in CODECS.items():
        for ef, tw in ((False, True), (False, False), (True, True),
                       (True, False)):
            key = f"ar_{name}_{tier}_{int(ef)}{int(tw)}"
            before = wire()
            if ef:
                o, ne = ici.compressed_allreduce_flat(
                    d["g"], mk(), two_way=tw, ef_residual=d["e"], tier=tier)
                out[key + "_e"] = ne.numpy()
            else:
                o = ici.compressed_allreduce_flat(d["g"], mk(), two_way=tw,
                                                  tier=tier)
            out[key] = o.numpy()
            out[key + "_wire"] = wire() - before
        before = wire()
        out[f"rs_{name}_{tier}"] = ici.compressed_reduce_scatter_flat(
            d["gr"], mk(), tier=tier).numpy()
        out[f"rs_{name}_{tier}_wire"] = wire() - before
    s, ne = ici.compressed_reduce_scatter_local(
        d["g"], OnebitCompressor(scaling=True), average=True,
        ef_residual=d["e"], tier=tier)
    out[f"rs_ef_{tier}"], out[f"rs_ef_{tier}_e"] = s.numpy(), ne.numpy()
    out[f"randomk_{tier}"] = ici.compressed_allreduce_flat(
        d["gk"], RandomkCompressor(k=0.25), rng=5, tier=tier).numpy()
    out[f"randomk_rs_{tier}"] = ici.compressed_reduce_scatter_flat(
        d["gk"], RandomkCompressor(k=0.25), rng=5, tier=tier).numpy()
    out[f"dither_{tier}"] = ici.compressed_allreduce_flat(
        d["gd"], DitheringCompressor(s=127, partition="linear",
                                     normalize="l2"),
        rng=6, two_way=False, tier=tier).numpy()

# which transport each call takes: count the ring entry points
calls = {"collect_tree": 0, "allgather_tree": 0, "presum": 0}
for name in calls:
    real = getattr(ici, "ring_" + name)

    def counting(*a, _real=real, _name=name, **k):
        calls[_name] += 1
        return _real(*a, **k)

    setattr(ici, "ring_" + name, counting)


def run(**kw):
    for k in calls:
        calls[k] = 0
    ici.compressed_allreduce_flat(d["g"], OnebitCompressor(), **kw)
    return [calls["collect_tree"], calls["allgather_tree"]]


os.environ["BYTEPS_ICI_TIER"] = "ring"
reset_config()
dispatch = run() + run(tier="staged")
os.environ["BYTEPS_ICI_TIER"] = "staged"
reset_config()
dispatch += run() + run(tier="ring")
for k in calls:
    calls[k] = 0
ici.compressed_allreduce_flat(d["gk"], RandomkCompressor(k=0.25), rng=5,
                              tier="ring")
out["dispatch"] = np.array(dispatch + [calls["collect_tree"],
                                       calls["presum"],
                                       calls["allgather_tree"]])
os.environ["BYTEPS_ICI_TIER"] = "bogus"
reset_config()
try:
    ici.compressed_allreduce_flat(d["g"], OnebitCompressor())
    out["bogus"] = np.array("accepted")
except ValueError as e:
    out["bogus"] = np.array(str(e))
np.savez(f"{io}/out{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
print(json.dumps({"rank": rank, "ok": True}))
"""


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    io = tmp_path_factory.mktemp("ring_ici")
    d = {"g": _rand((N, L), 1), "e": _rand((N, L), 2, 0.1),
         "gr": _rand((N, L), 3), "gk": _rand((N, 4096), 7),
         "gd": _rand((N, 512), 8)}
    np.savez(io / "in.npz", **d)
    return d, run_group(io, N, _RANK)


def _mesh():
    return jax.make_mesh((N,), ("dp",), devices=jax.devices()[:N])


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("name", sorted(REF_CODECS))
@pytest.mark.parametrize("ef,two_way", COMBOS)
def test_ring_allreduce_equals_staged_and_reference(four_ranks, name, ef,
                                                    two_way):
    d, outs = four_ranks
    key = f"{int(ef)}{int(two_way)}"
    kw = dict(average=True, rng=jax.random.PRNGKey(9), two_way=two_way,
              tier="ring")
    if ef:
        want, want_e = rici.compressed_allreduce_flat(
            jnp.asarray(d["g"]), REF_CODECS[name](), _mesh(),
            ef_residual=jnp.asarray(d["e"]), **kw)
        want_e = np.asarray(want_e)
    else:
        want = rici.compressed_allreduce_flat(
            jnp.asarray(d["g"]), REF_CODECS[name](), _mesh(), **kw)
    want = np.asarray(want).reshape(-1)
    for r, o in enumerate(outs):
        ring, staged = o[f"ar_{name}_ring_{key}"], o[f"ar_{name}_staged_{key}"]
        np.testing.assert_array_equal(ring, staged)
        _close(ring, want)
        if ef:
            np.testing.assert_array_equal(o[f"ar_{name}_ring_{key}_e"],
                                          o[f"ar_{name}_staged_{key}_e"])
            _close(o[f"ar_{name}_ring_{key}_e"], want_e[r])
        # the wire counters do not depend on the transport
        np.testing.assert_array_equal(o[f"ar_{name}_ring_{key}_wire"],
                                      o[f"ar_{name}_staged_{key}_wire"])
        np.testing.assert_array_equal(ring, outs[0][f"ar_{name}_ring_{key}"])
    if name != "identity":
        assert outs[0][f"ar_{name}_ring_{key}_wire"][0] > 0


@pytest.mark.parametrize("name", sorted(REF_CODECS))
def test_ring_reduce_scatter_equals_staged_and_reference(four_ranks, name):
    d, outs = four_ranks
    want = np.asarray(rici.compressed_reduce_scatter_flat(
        jnp.asarray(d["gr"]), REF_CODECS[name](), _mesh(),
        rng=jax.random.PRNGKey(11), tier="ring"))
    seg = -(-L // N)
    assert want.shape == (N * seg,)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o[f"rs_{name}_ring"],
                                      o[f"rs_{name}_staged"])
        _close(o[f"rs_{name}_ring"], want[r * seg:(r + 1) * seg])
        np.testing.assert_array_equal(o[f"rs_{name}_ring_wire"],
                                      o[f"rs_{name}_staged_wire"])


def test_ring_reduce_scatter_ef_equals_staged(four_ranks):
    from jax.sharding import PartitionSpec as P

    d, outs = four_ranks
    rng = jax.random.PRNGKey(13)

    def inner(blk, eblk, r):
        s, ne = rici.compressed_reduce_scatter_local(
            blk[0], r, ROnebit(scaling=True), "dp", N, average=True,
            ef_residual=eblk[0], tier="ring")
        return s, ne[None]

    s, ne = jax.jit(jax.shard_map(
        inner, mesh=_mesh(), in_specs=(P("dp"), P("dp"), P()),
        out_specs=(P("dp"), P("dp")), check_vma=False))(
        jnp.asarray(d["g"]), jnp.asarray(d["e"]), rng)
    s, ne = np.asarray(s), np.asarray(ne)
    seg = -(-L // N)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["rs_ef_ring"], o["rs_ef_staged"])
        np.testing.assert_array_equal(o["rs_ef_ring_e"], o["rs_ef_staged_e"])
        _close(o["rs_ef_ring"], s[r * seg:(r + 1) * seg])
        _close(o["rs_ef_ring_e"], ne[r])
    assert np.abs(outs[0]["rs_ef_ring_e"]).max() > 0     # EF engaged


def test_ring_randomk_same_support_values_close(four_ranks):
    _, outs = four_ranks
    for o in outs:
        for kind in ("randomk", "randomk_rs"):
            a, b = o[f"{kind}_staged"], o[f"{kind}_ring"]
            np.testing.assert_array_equal(a != 0, b != 0)
            assert (a != 0).sum() > 0
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(outs[0]["randomk_ring"],
                                  outs[1]["randomk_ring"])


def test_ring_dithering_equals_staged(four_ranks):
    _, outs = four_ranks
    for o in outs:
        np.testing.assert_array_equal(o["dither_ring"], o["dither_staged"])


def test_tier_env_and_override_dispatch(four_ranks):
    """Ring calls (collect, gather) of one onebit all-reduce under env
    ring, env ring + tier="staged", env staged, env staged +
    tier="ring": one call a direction for both payload leaves (signs and
    scale) on the ring, none staged; then randomk on the ring: no
    collect exchange, one presum (one payload leaf), one gather."""
    _, outs = four_ranks
    for o in outs:
        np.testing.assert_array_equal(o["dispatch"],
                                      [1, 1, 0, 0, 0, 0, 1, 1, 0, 1, 1])
        assert "unknown ICI tier 'bogus'" in str(o["bogus"])


def test_unknown_tier_raises_at_one_rank():
    x = torch.zeros(64)
    with pytest.raises(ValueError, match="unknown ICI tier"):
        tici.compressed_allreduce_flat(x, Compressor(), tier="bogus")
    with pytest.raises(ValueError, match="unknown ICI tier"):
        tici.compressed_reduce_scatter_local(x, Compressor(), 1,
                                             tier="bogus")
    # one rank: both tiers are one code path
    for tier in ("staged", "ring"):
        np.testing.assert_array_equal(
            tici.compressed_allreduce_flat(x + 1, Compressor(),
                                           tier=tier).numpy(),
            np.ones(64, np.float32))


_CHUNK_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from byteps_tpu_torch.comm import ici
from byteps_tpu_torch.compression import OnebitCompressor

rank, world, store_path, io = int(sys.argv[1]), int(sys.argv[2]), \
    sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)
d = {k: torch.as_tensor(v[rank]) for k, v in np.load(io + "/in.npz").items()}
calls = {"collect_tree": 0, "allgather_tree": 0}
for name in calls:
    real = getattr(ici, "ring_" + name)

    def counting(*a, _real=real, _name=name, **k):
        calls[_name] += 1
        return _real(*a, **k)

    setattr(ici, "ring_" + name, counting)
out = {}
for tier in ("staged", "ring"):
    for tw in (True, False):
        o, ne = ici.compressed_allreduce_local(
            d["g"], OnebitCompressor(scaling=True), world, two_way=tw,
            ef_residual=d["e"], tier=tier)
        out[f"{tier}_{int(tw)}"], out[f"{tier}_{int(tw)}_e"] = \
            o.numpy(), ne.numpy()
out["tree_calls"] = np.array([calls["collect_tree"],
                              calls["allgather_tree"]])
np.savez(f"{io}/out{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
print(json.dumps({"rank": rank, "ok": True}))
"""


@pytest.fixture(scope="module")
def chunk_groups(tmp_path_factory):
    """{n: each rank's outputs} for n = 2 and 3: one onebit + EF chunk
    (L = 1003) under both tiers, the pull compressed and not."""
    res = {}
    for n in (2, 3):
        io = tmp_path_factory.mktemp(f"ring_chunk{n}")
        np.savez(io / "in.npz", g=_rand((n, L), 20 + n),
                 e=_rand((n, L), 30 + n, 0.1))
        res[n] = run_group(io, n, _CHUNK_RANK)
    return res


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("two_way", [True, False])
def test_ring_onebit_ef_chunk_equals_staged_with_tree_calls(chunk_groups, n,
                                                            two_way):
    """Ring == staged bit for bit at chunk level (the all-reduce and each
    rank's new residual), the ring moving both payload leaves (signs and
    scale) in one collect and one gather call a chunk."""
    for o in chunk_groups[n]:
        for suffix in ("", "_e"):
            np.testing.assert_array_equal(o[f"ring_{int(two_way)}{suffix}"],
                                          o[f"staged_{int(two_way)}"
                                            f"{suffix}"])
        np.testing.assert_array_equal(o["tree_calls"], [2, 2])
