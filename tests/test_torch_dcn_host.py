"""The DCN tier's host layer, port against reference on the same seeded
numpy inputs: partitions, keys and priorities, owner placement, the six
wire codecs' bytes and decodes, the wire plans and seeds, and the
scheduler's order of stage starts under priority and credit contention.
Everything here is held bit for bit."""

import dataclasses
import threading

import numpy as np
import pytest

from byteps_tpu.common import partition as rpart
from byteps_tpu.common import scheduler as rsched
from byteps_tpu.compression import wire as rwire
from byteps_tpu_torch.common import partition as tpart
from byteps_tpu_torch.common import scheduler as tsched
from byteps_tpu_torch.compression import wire as twire

SHAPES = [(3,), (1000, 7), (), (1024, 257), (65536,), (17, 3, 5), (1,)]


def _parts(ps):
    return [(p.key, p.tensor_id, p.part_idx, p.offset, p.length, p.priority)
            for p in ps]


@pytest.mark.parametrize("partition_bytes", [4096000, 40000, 1024, 100])
def test_registry_keys_offsets_priorities_match(partition_bytes):
    ref = rpart.TensorRegistry(partition_bytes)
    port = tpart.TensorRegistry(partition_bytes)
    for i, shape in enumerate(SHAPES):
        dt = (np.float32, np.float16, np.int64)[i % 3]
        a = ref.declare(f"t{i}", shape, dt)
        b = port.declare(f"t{i}", shape, dt)
        assert (a.tensor_id, a.priority, a.num_elements) == \
            (b.tensor_id, b.priority, b.num_elements)
        assert _parts(a.partitions) == _parts(b.partitions)
    # a re-declaration is idempotent; a mismatched one refused by both
    assert port.declare("t1", SHAPES[1], np.float16).tensor_id == 1
    for reg in (ref, port):
        with pytest.raises(RuntimeError, match="re-declared"):
            reg.declare("t1", (2,), np.float32)
    ref.repartition(partition_bytes * 3)
    port.repartition(partition_bytes * 3)
    for (n, a), (m, b) in zip(ref.snapshot(), port.snapshot()):
        assert n == m and _parts(a.partitions) == _parts(b.partitions)
    # more than MAX_PARTS_PER_TENSOR partitions: both refuse
    for mod in (rpart, tpart):
        with pytest.raises(RuntimeError, match="partitions >"):
            mod.make_partitions(5, 10 ** 6, 4, 4)


@pytest.mark.parametrize("n_ctl,salt", [(1, 0), (3, 0), (4, 7)])
def test_owner_table_placement_matches(n_ctl, salt):
    ref, port = rpart.OwnerTable(n_ctl, salt), tpart.OwnerTable(n_ctl, salt)
    keys = [k * tpart.MAX_PARTS_PER_TENSOR + i for k in range(20)
            for i in range(3)]
    assert [ref.owner(k) for k in keys] == [port.owner(k) for k in keys]
    if n_ctl > 1:
        assert ref.fail(1) and port.fail(1)
        assert [ref.owner(k) for k in keys] == [port.owner(k) for k in keys]
        assert ref.live() == port.live()


def _codecs(mod):
    return [mod.WireCodec(), mod.Fp16Wire(), mod.Fp8Wire(),
            mod.OnebitWire(), mod.OnebitWire(scaling=False),
            mod.TopkWire(k=0.01), mod.TopkWire(k=7),
            mod.TopkWire(k=0.01, selection="block"),
            mod.TopkWire(k=128, selection="block"),
            mod.RandomkWire(k=0.01), mod.RandomkWire(k=5, scale=False),
            mod.DitherWire(), mod.DitherWire(s=16, partition="natural",
                                             normalize="max")]


# ragged, under and over min_compress_bytes (16384 f32 = 65536 B), and a
# tiled top-k length (16384 = 128 x 128)
LENGTHS = [1, 33, 1000, 16383, 16384, 20001]


@pytest.mark.parametrize("n", LENGTHS)
def test_codec_bytes_and_decodes_match(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * rng.uniform(0.1, 10)).astype(np.float32)
    x[::11] = 0.0
    x[1::13] = -0.0
    for ref, port in zip(_codecs(rwire), _codecs(twire)):
        for seed in (0, 3, 2 ** 40 + 5):
            a = ref.encode(x, seed=seed)
            b = port.encode(x, seed=seed)
            assert a.dtype == b.dtype == np.uint8
            assert np.array_equal(a, b), (type(ref).__name__, n, seed)
            assert port.wire_bytes(n) == ref.wire_bytes(n) == b.size
            assert port.store_elems(n) == ref.store_elems(n)
            da, db = ref.decode(a, n, seed), port.decode(b, n, seed)
            assert da.dtype == db.dtype == np.float32
            assert np.array_equal(da.view(np.uint32), db.view(np.uint32))


def test_wire_plans_and_seeds_match():
    for ref, port in zip(_codecs(rwire), _codecs(twire)):
        for two_way in (True, False):
            a, b = rwire.WirePlan(ref, two_way), twire.WirePlan(port, two_way)
            assert (a.compacted, a.pull_codec_id) == \
                (b.compacted, b.pull_codec_id)
            for n in LENGTHS:
                assert a.pull_capacity(n) == b.pull_capacity(n)
    for name in ("byteps_push_pull.fc1.weight", "w", ""):
        for v, part, salt in ((0, 0, 0), (5, 3, 0), (2 ** 20, 99, 11)):
            assert rwire.wire_seed(name, v, part, salt) == \
                twire.wire_seed(name, v, part, salt)
            assert rwire.pull_seed(name, v, part) == \
                twire.pull_seed(name, v, part)
    assert [getattr(twire, f"WIRE_{c}") for c in
            ("RAW", "FP16", "ONEBIT", "TOPK", "DITHER", "FP8")] == \
        [getattr(rwire, f"WIRE_{c}") for c in
         ("RAW", "FP16", "ONEBIT", "TOPK", "DITHER", "FP8")]


def test_make_wire_codec_maps_specs_alike():
    from byteps_tpu.compression import from_params as rfrom
    from byteps_tpu_torch.compression import from_params as tfrom

    for params in (None, {"compressor": "onebit"},
                   {"compressor": "onebit", "scaling": False},
                   {"compressor": "topk", "k": 0.02, "selection": "block"},
                   {"compressor": "randomk", "k": 0.05},
                   {"compressor": "dithering", "s": 8,
                    "partition": "natural"},
                   {"compressor": "fp16"}, {"compressor": "fp8"}):
        a = rwire.make_wire_codec(rfrom(params))
        b = twire.make_wire_codec(tfrom(params))
        if a is None:
            assert b is None
            continue
        assert type(a).__name__ == type(b).__name__
        assert {k: v for k, v in vars(a).items()} == \
            {k: v for k, v in vars(b).items()}


def _run_order(mod, pmod, stages_spec, credit, tensors, priorities=None):
    """Each stage's order of starts when every task of ``tensors``
    ([(tensor_id, n_elems)], the first enqueued alone while it holds the
    gate) contends for ``credit`` and one thread a stage."""
    gate = threading.Event()
    order = {name: [] for name, _, _ in stages_spec}

    def make_fn(name):
        def fn(task):
            if not gate.is_set():
                gate.wait(5)
            order[name].append(task.partition.key)
            return None
        return fn

    stages = [mod.Stage(name, make_fn(name), credited=cr, pool_size=1,
                        releases_credit=rel)
              for name, cr, rel in stages_spec]
    sched = mod.PipelineScheduler(stages, credit=credit)
    handles = []
    for tid, n in tensors:
        parts = pmod.make_partitions(tid, n, 4, 8)
        h = mod.Handle(str(tid), len(parts))
        handles.append(h)
        if priorities is not None:
            parts = [dataclasses.replace(p, priority=priorities[tid])
                     for p in parts]
        sched.enqueue([mod.PartitionTask(partition=p, name=str(tid),
                                         handle=h) for p in parts])
    gate.set()
    for h in handles:
        h.wait(10)
    sched.shutdown()
    return order


ORDER_CASES = {
    # after tests/test_scheduler.py's single-stage cases: one credit
    "one_stage": ([("PUSH", True, False)], 1,
                  [(9, 1), (8, 3), (7, 1), (3, 5), (1, 2), (0, 1)], None),
    # the DCN shape: a credited codec stage, then the credited wire stage
    # that frees the credit on exit, then two plain stages
    "dcn_stages": ([("COMPRESS", True, False), ("PUSH", True, True),
                    ("PULL", False, False), ("DECOMPRESS", False, False)],
                   2, [(6, 4), (2, 3), (5, 1), (0, 6), (4, 2)], None),
    # explicit priorities override declaration order
    "priority_override": ([("COMPRESS", True, False), ("PUSH", True, True)],
                          3, [(0, 2), (1, 4), (2, 2), (3, 3)],
                          {0: -5, 1: 7, 2: 7, 3: 0}),
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_scheduler_start_order_matches_reference(case):
    stages, credit, tensors, prios = ORDER_CASES[case]
    ref = _run_order(rsched, rpart, stages, credit, tensors, prios)
    port = _run_order(tsched, tpart, stages, credit, tensors, prios)
    assert ref == port
    total = sum(len(tpart.make_partitions(t, n, 4, 8)) for t, n in tensors)
    assert all(len(v) == total for v in port.values())
    # after the first (issued alone), the first stage runs in priority
    # order, ties by key
    first = port[stages[0][0]]
    key_prio = {p.key: (prios or {}).get(t, -t) for t, n in tensors
                for p in tpart.make_partitions(t, n, 4, 8)}
    rest = [(-key_prio[k], k) for k in first[1:]]
    assert rest == sorted(rest)


def test_scheduler_retry_credit_and_stats():
    """A retryable stage re-runs a failed task with its priority, the
    credit pool refills, and each stage's run and dwell times land in the
    port's metrics registry."""
    from byteps_tpu_torch.common.metrics import get_registry, reset_registry

    reset_registry()
    failed = []

    def flaky(task):
        if task.partition.part_idx == 1 and not failed:
            failed.append(task.partition.key)
            raise ConnectionError("lost")
        return task.partition.length

    sched = tsched.PipelineScheduler(
        [tsched.Stage("PUSH", flaky, credited=True, pool_size=2,
                      releases_credit=True, retryable=True,
                      retry_backoff_s=0.001),
         tsched.Stage("PULL", lambda t: t.payload * 2, pool_size=2)],
        credit=2)
    h = tsched.Handle("t", 3)
    sched.enqueue([tsched.PartitionTask(partition=p, name="t", handle=h)
                   for p in tpart.make_partitions(0, 7, 4, 12)])
    assert h.wait(5) == {0: 6, 1: 6, 2: 2}
    assert failed and sched.credit_pools() == {0: 2}
    snap = get_registry().snapshot("scheduler.")
    assert snap["counters"]["scheduler.stage_retries"] == 1
    for st in ("PUSH", "PULL"):
        assert snap["histograms"][f"scheduler.stage.{st}.run_us"]["count"] \
            >= 3
        assert f"scheduler.stage.{st}.dwell_us" in snap["histograms"]
    sched.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        sched.enqueue([])
    reset_registry()


def test_handle_stall_and_failure_errors():
    h = tsched.Handle("x", 2)
    h.diag = lambda: {"pushed": 3}
    with pytest.raises(tsched.StallError, match="0/2 partition.*pushed"):
        h.wait(0.01)
    h._partition_done(0, "a")
    h._partition_failed(ValueError("bad"), 1)
    with pytest.raises(tsched.PartitionFailure, match="partition 1") as ei:
        h.wait(1)
    assert ei.value.partial_results == {0: "a"} and h.failed()


DCN_ENV = {"DMLC_ROLE": "server", "DMLC_NUM_WORKER": "3",
           "DMLC_NUM_SERVER": "2", "DMLC_PS_ROOT_URI": "10.0.0.5",
           "DMLC_PS_ROOT_PORT": "9100", "DMLC_WORKER_ID": "2",
           "BYTEPS_LOCAL_RANK": "1", "BYTEPS_LOCAL_SIZE": "4",
           "BYTEPS_SCHEDULING_CREDIT": "7",
           "BYTEPS_SERVER_ENGINE_THREAD": "3",
           "BYTEPS_SERVER_ENABLE_SCHEDULE": "1",
           "BYTEPS_SERVER_PULL_TIMEOUT_MS": "1234",
           "BYTEPS_MIN_COMPRESS_BYTES": "1000",
           "BYTEPS_DCN_THROTTLE_MBPS": "2.5", "BYTEPS_RETRY_LIMIT": "3",
           "BYTEPS_RETRY_BACKOFF_MS": "9", "BYTEPS_WIRE_CRC": "yes",
           "BYTEPS_ENABLE_ASYNC": "on", "BYTEPS_ENABLE_IPC": "1",
           "BYTEPS_STALENESS": "-3", "BYTEPS_WORKER_LEASE_MS": "50",
           "BYTEPS_HEALTH_INTERVAL_MS": "20", "BYTEPS_HYBRID_SHARDED": "0",
           "BYTEPS_POD_CONTROLLERS": "2", "BYTEPS_OWNER_SALT": "7",
           "BYTEPS_FAULT_SPEC": "push:kill@op=1"}
DCN_FIELDS = ("role", "num_worker", "num_server", "ps_root_uri",
              "ps_root_port", "worker_id", "local_rank", "local_size",
              "scheduling_credit", "server_engine_threads",
              "server_enable_schedule", "pull_timeout_ms",
              "min_compress_bytes", "dcn_throttle_mbps", "retry_limit",
              "retry_backoff_ms", "wire_crc", "enable_async", "enable_ipc",
              "staleness", "worker_lease_ms", "health_interval_ms",
              "hybrid_sharded", "pod_controllers", "owner_salt",
              "fault_spec")


@pytest.mark.parametrize("env", [{}, DCN_ENV], ids=["defaults", "set"])
def test_dcn_config_fields_match_reference(monkeypatch, env):
    from byteps_tpu.common import config as rconfig
    from byteps_tpu_torch.common import config as tconfig

    for k in DCN_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tconfig.reset_config()
    rconfig.reset_config()
    try:
        r, t = rconfig.get_config(), tconfig.get_config()
        assert {f: getattr(t, f) for f in DCN_FIELDS} == \
            {f: getattr(r, f) for f in DCN_FIELDS}
    finally:
        tconfig.reset_config()
        rconfig.reset_config()
