"""The port's input pipeline (``byteps_tpu_torch/data``), twin of
``tests/test_data.py``: a host batch cut to this rank's block (the
reference's sharded ``device_put``), the prefetch loader's order, run-
ahead, error and close contracts, a train step fed through it — and the
elastic shard map, exactly the reference's for the same seed, epoch,
cursor and live ids.

The loader's producer is a thread: every wait on it here is bounded.
"""

import time

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from byteps_tpu.data import ElasticShardMap as RefShardMap
from byteps_tpu.data import live_ids_from_bitmap as ref_live_ids
from byteps_tpu.data import shard_batch as ref_shard_batch
from byteps_tpu.parallel import MeshAxes, make_mesh as ref_make_mesh
from byteps_tpu_torch.data import (ElasticShardMap, PrefetchLoader,
                                   live_ids_from_bitmap, shard_batch)
from byteps_tpu_torch.parallel.mesh import Axis, Mesh

torch.set_num_threads(1)
N_DP = 8


@pytest.fixture(scope="module")
def ref_mesh():
    return ref_make_mesh(MeshAxes(dp=N_DP))


def _dp_mesh(index: int) -> Mesh:
    """Rank ``index``'s view of a dp=8 mesh (cutting needs no group)."""
    return Mesh({"dp": Axis("dp", N_DP, index, tuple(range(N_DP)))}, index)


def _batches(n, rows=16, cols=4):
    for i in range(n):
        yield (np.full((rows, cols), i, np.float32),
               np.full((rows,), i, np.int32))


def _seeded(rows=16, cols=4):
    rng = np.random.default_rng(3)
    return (rng.standard_normal((rows, cols)).astype(np.float32),
            rng.integers(0, 100, rows).astype(np.int32))


def test_shard_batch_cuts_each_ranks_rows_as_the_reference(ref_mesh):
    """Rank i's block of a ("dp",) batch is the reference's shard on its
    device i, for every i."""
    batch = _seeded()
    ref = ref_shard_batch(batch, NamedSharding(ref_mesh, P("dp")))
    for i in range(N_DP):
        got = shard_batch(batch, ("dp",), _dp_mesh(i), device="cpu")
        for g, r in zip(got, ref):
            want = np.asarray(next(s.data for s in r.addressable_shards
                                   if s.device == ref_mesh.devices[i]))
            assert isinstance(g, torch.Tensor)
            np.testing.assert_array_equal(g.numpy(), want)


def test_shard_batch_per_leaf_specs(ref_mesh):
    batch = _seeded()
    ref = ref_shard_batch(batch, (NamedSharding(ref_mesh, P("dp")),
                                  NamedSharding(ref_mesh, P())))
    x, y = shard_batch(batch, (("dp",), ()), _dp_mesh(3), device="cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(
        ref[0].addressable_shards[3].data))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref[1]))
    assert tuple(x.shape) == (2, 4) and tuple(y.shape) == (16,)
    # without a mesh every leaf is whole, copied off the host buffer
    whole = shard_batch(batch, device="cpu")
    np.testing.assert_array_equal(whole[0].numpy(), batch[0])
    assert whole[0].data_ptr() != torch.from_numpy(batch[0]).data_ptr()


def test_loader_order_values_and_blocks():
    with PrefetchLoader(_batches(5), ("dp",), _dp_mesh(1), depth=2,
                        device="cpu") as loader:
        seen = []
        for x, y in loader:
            assert tuple(x.shape) == (2, 4)
            seen.append(int(y[0]))
    assert seen == [0, 1, 2, 3, 4]


def test_loader_runs_ahead():
    """The producer advances past the consumer by up to ``depth``."""
    pulled = []

    def source():
        for i in range(4):
            pulled.append(i)
            yield (np.zeros((8, 2), np.float32),)

    with PrefetchLoader(source(), depth=2, device="cpu") as loader:
        next(loader)
        deadline = time.monotonic() + 5.0
        while len(pulled) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(pulled) >= 3, pulled


def test_loader_propagates_source_error():
    def source():
        yield (np.zeros((8, 2), np.float32),)
        raise RuntimeError("corrupt shard")

    loader = PrefetchLoader(source(), depth=2, device="cpu")
    next(loader)
    with pytest.raises(RuntimeError, match="corrupt shard"):
        next(loader)
    loader.close()


def test_loader_keeps_raising_after_exhaustion():
    loader = PrefetchLoader(_batches(1), depth=2, device="cpu")
    assert len(list(loader)) == 1
    with pytest.raises(StopIteration):
        next(loader)
    with pytest.raises(StopIteration):
        next(loader)


def test_loader_close_unblocks_producer():
    loader = PrefetchLoader(_batches(100), depth=1, device="cpu")
    next(loader)
    loader.close()
    assert not loader._thread.is_alive()
    with pytest.raises(StopIteration):
        next(loader)


def test_loader_feeds_training():
    """Loader batches drive a ViT train step; the losses are bit for bit
    those of the same batches fed directly."""
    from byteps_tpu_torch.models import ViTConfig, make_vit_train_step

    cfg = ViTConfig.tiny()
    rng = np.random.default_rng(5)
    host = [(rng.standard_normal((4, cfg.image_size, cfg.image_size,
                                  cfg.channels)).astype(np.float32),
             rng.integers(0, cfg.n_classes, 4).astype(np.int64))
            for _ in range(3)]

    def run(batches):
        step, _, _ = make_vit_train_step(
            cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        return [float(step(x, y)) for x, y in batches]

    with PrefetchLoader(iter(host), depth=2, device="cpu") as loader:
        fed = run(loader)
    assert len(fed) == 3 and all(np.isfinite(fed))
    assert fed == run(host)


@pytest.mark.parametrize("n,seed,epochs,cursor,live", [
    (100, 0, 0, 0, [0, 1, 2]),
    (1000, 7, 1, 333, [0, 2, 5, 9]),
    (17, 3, 2, 16, [4]),
    (4096, 11, 0, 1000, [3, 1, 2, 0, 2]),
])
def test_elastic_shard_map_equals_the_reference(n, seed, epochs, cursor,
                                                live):
    maps = []
    for cls in (ElasticShardMap, RefShardMap):
        m = cls(n, seed=seed)
        for _ in range(epochs):
            m.next_epoch()
        m.advance(cursor)
        maps.append(m)
    got, ref = (m.assign(live) for m in maps)
    assert sorted(got) == sorted(ref)
    for w in ref:
        np.testing.assert_array_equal(got[w], ref[w])
        np.testing.assert_array_equal(maps[0].shard_for(w, live),
                                      maps[1].shard_for(w, live))
    assert maps[0].remaining == maps[1].remaining
    with pytest.raises(ValueError):
        maps[0].shard_for(max(live) + 1, live)


def test_live_ids_from_bitmap_equals_the_reference():
    for bits in ([1, 0, 1, 1], [0, 0], [1] * 7):
        assert live_ids_from_bitmap(bits) == ref_live_ids(bits)
