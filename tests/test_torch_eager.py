"""The port's eager surface (``byteps_tpu_torch.eager``, not distributed:
the eager ICI pipeline) against the reference's ``byteps_tpu.jax``.

A port pod is two gloo rank processes (a ``FileStore`` in the test's
directory) that import only torch and the port, each passing its own
row; the reference pod is ``byteps_tpu.jax`` on a 2-device CPU mesh,
passing the stacked rows. Both take the same numpy inputs. Mirrors
``tests/test_jax_adapter.py``: topology, ``push_pull`` average and sum
over 4 partitions, four async handles, onebit + error feedback and
Nesterov momentum per partition, the small-tensor skip,
``push_pull_tree``, ``broadcast_parameters`` (f32 and int64 above 2^24),
declaration priority, anonymous names, and randomk keys per partition
and version. Then a pod of one rank in this process, with no process
group.

Tolerances: raw sums, the tree and broadcasts are exact (two f32 terms
add the same way everywhere). onebit results carry mean(|x|) scales,
which the two frameworks reduce in different orders: the signs (the
words) are equal and the values held to 1e-6 relative, as
``tests/test_torch_ici.py`` holds onebit; momentum adds two f32 products
that XLA may fuse, so it is held to the same 1e-6. randomk's draws are
the port's own (``compression/base.py``), so its supports are checked for
what the reference's test checks, not against the reference's."""

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

import byteps_tpu.jax as rbps
from byteps_tpu.common.config import reset_config as r_reset
from byteps_tpu_torch import eager
from byteps_tpu_torch.common.config import reset_config as t_reset

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
N = 2
RTOL = 1e-6
ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}
ONEBIT_EF_MOM = {"compressor": "onebit", "ef": "vanilla",
                 "momentum": "nesterov"}
BIG = 1 << 25
LONG = 1 << 15                  # 2 partitions of 65,536 bytes


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _inputs():
    return {"avg": _rand((N, 32, 4), 0), "sum4": _rand((N, 1000), 1),
            **{f"h{i}": _rand((N, 64), 10 + i) for i in range(4)},
            "efm": _rand((N, LONG), 2), "ef": _rand((N, LONG), 3),
            "small": _rand((N, 16), 4), "anon": _rand((N, LONG), 5),
            "rk": _rand((N, LONG), 6), "bw": _rand((N, 5, 5), 7),
            "tree_b": np.tile(np.arange(N, dtype=np.float32)[:, None],
                              (1, 3))}


_RANK = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, io = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from byteps_tpu_torch import eager as bps
from byteps_tpu_torch.common.config import reset_config

d = np.load(io + "/in.npz")
row = lambda k: torch.as_tensor(d[k][rank])
out = {}
bps.init()
out["topo"] = np.array([bps.pod_size(), bps.size(), bps.rank(),
                        bps.local_rank(), bps.local_size(),
                        len(bps._state.stages)])
out["avg"] = bps.push_pull(row("avg"), average=True, name="t0").numpy()
os.environ["BYTEPS_PARTITION_BYTES"] = "1024"
reset_config()
out["sum4"] = bps.push_pull(row("sum4"), average=False, name="t1").numpy()
out["sum4_parts"] = np.array(
    len(bps._state.registry.get("t1").partitions))
os.environ["BYTEPS_PARTITION_BYTES"] = "65536"
reset_config()
hs = [bps.push_pull_async(row(f"h{i}"), name=f"h{i}") for i in range(4)]
for i, h in enumerate(hs):
    out[f"h{i}"] = bps.synchronize(h).numpy()
for r in range(2):
    out[f"efm{r}"] = bps.push_pull(row("efm"), name="efm",
                                   compression_params=json.loads(sys.argv[5])
                                   ).numpy()
    out[f"ef{r}"] = bps.push_pull(row("ef"), name="ef",
                                  compression_params=json.loads(sys.argv[6])
                                  ).numpy()
for k in ("efm", "ef"):
    for p in range(2):
        out[f"{k}_e{p}"] = bps._state.ef_state[(k, p)].numpy()
    if k == "efm":
        for p in range(2):
            out[f"{k}_m{p}"] = bps._state.mom_state[(k, p)].numpy()
out["small"] = bps.push_pull(row("small"), name="small",
                             compression_params={"compressor": "onebit"}
                             ).numpy()
out["anon"] = bps.push_pull(row("anon"),
                            compression_params=json.loads(sys.argv[6])
                            ).numpy()
out["anon_state"] = np.array(len(bps._state.ef_state))
rk = {"compressor": "randomk", "k": 0.05}
out["rk0"] = bps.push_pull(row("rk"), name="rk", compression_params=rk).numpy()
out["rk1"] = bps.push_pull(row("rk"), name="rk", compression_params=rk).numpy()
tree = bps.push_pull_tree({"w": torch.ones(4, 4), "b": row("tree_b")})
out["tree_w"], out["tree_b"] = tree["w"].numpy(), tree["b"].numpy()
lst = bps.push_pull_tree([torch.ones(2) * (rank + 1), torch.ones(3)],
                         average=False, name_prefix="lst")
out["tree_list"] = torch.cat(lst).numpy()
bc = bps.broadcast_parameters(
    {"w": row("bw"), "step": torch.full((1,), (1 << 25) + 3 + rank,
                                        dtype=torch.int64)}, root_rank=1)
out["bcast_w"] = bc["w"].numpy()
out["bcast_step"] = bc["step"].numpy()
out["bcast_dtype"] = np.array(str(bc["step"].dtype))
bps.declare_tensor("a", (10,), torch.float32)
bps.declare_tensor("b", (10,), np.float32)
out["prio"] = np.array([bps._state.registry.get(k).priority
                        for k in ("a", "b")])
bps.shutdown()
np.savez(f"{io}/out{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
print(json.dumps({"rank": rank, "ok": True}))
"""


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    io = tmp_path_factory.mktemp("eager")
    x = _inputs()
    np.savez(io / "in.npz", **x)
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    for k in list(env):
        if k.startswith(("BYTEPS_", "DMLC_")):
            del env[k]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(N), str(io / "store"),
         str(io), json.dumps(ONEBIT_EF_MOM), json.dumps(ONEBIT_EF)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(N)]
    try:
        res = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, res):
        assert p.returncode == 0, se[-3000:]
        assert json.loads(so.strip().splitlines()[-1])["ok"]
    return x, [dict(np.load(io / f"out{r}.npz")) for r in range(N)]


@pytest.fixture
def ref(monkeypatch):
    """The reference adapter on a 2-device mesh, reset around the test."""
    mesh = jax.make_mesh((N,), ("dp",), devices=jax.devices()[:N])
    r_reset()
    rbps.init(mesh=mesh)
    yield rbps
    rbps.shutdown()
    rbps._state.__init__()
    r_reset()


def _both(outs, key):
    """Both ranks' results, checked equal bit for bit; rank 0's."""
    np.testing.assert_array_equal(outs[0][key], outs[1][key], err_msg=key)
    return outs[0][key]


def test_topology(pod):
    _, outs = pod
    for r, o in enumerate(outs):
        # pod_size, size, rank (the pod's id), local_rank, local_size, and
        # no scheduler stages: PUSHPULL and SYNC run in the caller's thread
        np.testing.assert_array_equal(o["topo"], [N, N, 0, r, N, 0])


def test_push_pull_average_and_sum_over_four_partitions(pod, ref,
                                                        monkeypatch):
    x, outs = pod
    want = np.asarray(ref.push_pull(jnp.asarray(x["avg"]), average=True,
                                    name="t0"))
    np.testing.assert_array_equal(_both(outs, "avg"), want)
    monkeypatch.setenv("BYTEPS_PARTITION_BYTES", "1024")
    r_reset()
    want = np.asarray(ref.push_pull(jnp.asarray(x["sum4"]), average=False,
                                    name="t1"))
    assert len(ref._state.registry.get("t1").partitions) == 4
    assert int(outs[0]["sum4_parts"]) == 4
    np.testing.assert_array_equal(_both(outs, "sum4"), want)
    np.testing.assert_array_equal(want, x["sum4"][0] + x["sum4"][1])


def test_push_pull_async_four_handles(pod, ref):
    x, outs = pod
    hs = [ref.push_pull_async(jnp.asarray(x[f"h{i}"]), name=f"h{i}")
          for i in range(4)]
    for i, h in enumerate(hs):
        np.testing.assert_array_equal(_both(outs, f"h{i}"),
                                      np.asarray(ref.synchronize(h)))


@pytest.mark.parametrize("key,params", [("efm", ONEBIT_EF_MOM),
                                        ("ef", ONEBIT_EF)])
def test_onebit_ef_and_momentum_per_partition(pod, ref, monkeypatch, key,
                                              params):
    """Two rounds over two partitions: the results' signs (onebit's words)
    equal, values, EF residuals and momentum to 1e-6 relative."""
    x, outs = pod
    monkeypatch.setenv("BYTEPS_PARTITION_BYTES", "65536")
    r_reset()
    for r in range(2):
        want = np.asarray(ref.push_pull(jnp.asarray(x[key]), name=key,
                                        compression_params=params))
        got = _both(outs, f"{key}{r}")
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
        # one scale a partition and rank segment: 2 × 2 magnitudes
        assert len(np.unique(np.abs(got))) == 4
    for p in range(2):
        want_e = np.asarray(ref._state.ef_state[(key, p)])
        for rk, o in enumerate(outs):
            np.testing.assert_allclose(o[f"{key}_e{p}"], want_e[rk],
                                       rtol=RTOL, atol=RTOL)
            if key == "efm":
                np.testing.assert_allclose(
                    o[f"{key}_m{p}"],
                    np.asarray(ref._state.mom_state[(key, p)])[rk],
                    rtol=RTOL, atol=RTOL)


def test_small_tensor_skips_compression(pod, ref):
    x, outs = pod
    want = np.asarray(ref.push_pull(jnp.asarray(x["small"]), name="small",
                                    compression_params={"compressor":
                                                        "onebit"}))
    np.testing.assert_array_equal(_both(outs, "small"), want)
    np.testing.assert_allclose(want, x["small"].mean(0), rtol=1e-6)


def test_anonymous_names_disable_error_feedback(pod, ref, monkeypatch):
    x, outs = pod
    monkeypatch.setenv("BYTEPS_PARTITION_BYTES", "65536")
    r_reset()
    want = np.asarray(ref.push_pull(jnp.asarray(x["anon"]),
                                    compression_params=ONEBIT_EF))
    assert ref._state.ef_state == {}
    got = _both(outs, "anon")
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    # only the named tensors' state: efm and ef, two partitions each
    assert int(outs[0]["anon_state"]) == 4


def test_randomk_keys_per_partition_and_version(pod):
    """The same support on both ranks (one key), another at the next
    version, and not the same in the two partitions of one call."""
    _, outs = pod
    o1, o2 = _both(outs, "rk0"), _both(outs, "rk1")
    s1, s2 = set(np.nonzero(o1)[0]), set(np.nonzero(o2)[0])
    assert 0 < len(s1) < LONG
    assert len(s1 & s2) < 0.5 * len(s1)
    half = LONG // 2
    assert {i for i in s1 if i < half} != {i - half for i in s1 if i >= half}


def test_push_pull_tree(pod, ref):
    x, outs = pod
    want = ref.push_pull_tree({"w": jnp.ones((N, 4, 4)),
                               "b": jnp.asarray(x["tree_b"])})
    np.testing.assert_array_equal(_both(outs, "tree_w"),
                                  np.asarray(want["w"]))
    np.testing.assert_array_equal(_both(outs, "tree_b"),
                                  np.asarray(want["b"]))
    np.testing.assert_array_equal(_both(outs, "tree_list"),
                                  [3, 3, 2, 2, 2])


def test_broadcast_parameters_bit_exact(pod, ref):
    x, outs = pod
    want = ref.broadcast_parameters(
        {"w": jnp.asarray(x["bw"]),
         "step": jnp.asarray(np.array([[BIG + 3], [BIG + 4]], np.int32))},
        root_rank=1)
    np.testing.assert_array_equal(_both(outs, "bcast_w"),
                                  np.asarray(want["w"]))
    np.testing.assert_array_equal(_both(outs, "bcast_w"), x["bw"][1])
    # int64 above 2^24: exact, in its own dtype
    np.testing.assert_array_equal(_both(outs, "bcast_step"), [BIG + 4])
    assert int(np.asarray(want["step"])[0]) == BIG + 4
    assert str(outs[0]["bcast_dtype"]) == "torch.int64"


def test_declare_tensor_priority(pod, ref):
    _, outs = pod
    ref.declare_tensor("a", (10,), np.float32)
    ref.declare_tensor("b", (10,), np.float32)
    want = [ref._state.registry.get(k).priority for k in ("a", "b")]
    assert want[0] > want[1]
    for o in outs:
        assert o["prio"][0] > o["prio"][1]


@pytest.fixture
def solo():
    """A pod of one rank in this process, with no process group."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    t_reset()
    eager.init()
    yield eager
    eager.shutdown()
    eager._state.__init__()
    t_reset()


def test_pod_of_one_rank_without_a_process_group(solo, monkeypatch):
    mesh = jax.make_mesh((1,), ("dp",), devices=jax.devices()[:1])
    monkeypatch.setenv("BYTEPS_PARTITION_BYTES", "65536")
    r_reset()
    t_reset()
    x = _rand((1, LONG), 8)
    assert (solo.pod_size(), solo.size(), solo.local_rank()) == (1, 1, 0)
    np.testing.assert_array_equal(
        solo.push_pull(torch.as_tensor(x[0]), name="raw").numpy(), x[0])
    rbps.init(mesh=mesh)
    try:
        for _ in range(2):
            want = np.asarray(rbps.push_pull(jnp.asarray(x), name="e",
                                             compression_params=ONEBIT_EF))
            got = solo.push_pull(torch.as_tensor(x[0]), name="e",
                                 compression_params=ONEBIT_EF).numpy()
            np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
        for p in range(2):
            np.testing.assert_allclose(
                solo._state.ef_state[("e", p)].numpy(),
                np.asarray(rbps._state.ef_state[("e", p)])[0],
                rtol=RTOL, atol=RTOL)
        bc = solo.broadcast_parameters([torch.as_tensor(x[0])])
        np.testing.assert_array_equal(bc[0].numpy(), x[0])
    finally:
        rbps.shutdown()
        rbps._state.__init__()
        r_reset()


def test_unported_knobs_raise(monkeypatch):
    for knob, value in (("BYTEPS_AUTO_TUNE", "1"),):
        monkeypatch.setenv(knob, value)
        t_reset()
        try:
            with pytest.raises(RuntimeError, match="not ported yet"):
                eager.init()
            assert not eager._state.initialized
        finally:
            monkeypatch.delenv(knob)
            eager._state.__init__()
            t_reset()
    assert eager.auto_tune_enabled() is False


def test_pod_controllers_are_accepted(monkeypatch):
    """``BYTEPS_POD_CONTROLLERS`` > 1 (sharded) is ported: a pod of one
    rank in this process holds a ``PSWorker`` a controller NIC and an
    owner table, with owner-scoped credits; its sums are exact and its
    NICs' wire bytes add up to the plans' (``BYTEPS_OWNER_SALT`` moves
    which NIC carries which partition, not the result)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
    from dcn_fixtures import job_env, next_port

    from byteps_tpu_torch.server import start_server_any_port, stop_server

    x = torch.as_tensor(np.random.RandomState(5).randn(60000)
                        .astype(np.float32))
    split = []
    for salt in ("0", "7"):
        port = start_server_any_port(next_port(), num_workers=1)
        job_env(monkeypatch, port, workers=1)
        for k, v in (("BYTEPS_FORCE_DISTRIBUTED", "1"),
                     ("BYTEPS_POD_CONTROLLERS", "3"),
                     ("BYTEPS_OWNER_SALT", salt),
                     ("BYTEPS_PARTITION_BYTES", "16384")):
            monkeypatch.setenv(k, v)
        t_reset()
        eager.init()
        try:
            assert len(eager._state.psworkers) == 3
            assert eager._state.psworker is eager._state.psworkers[0]
            assert eager._state.owners.salt == int(salt)
            assert eager._state.scheduler._credit_scope == "owner"
            out = eager.push_pull(x, average=False, name="w")
            np.testing.assert_array_equal(out.numpy(), x.numpy())
            per_nic = [w.bytes_pushed for w in eager._state.psworkers]
            assert eager.bytes_moved() == (x.numel() * 4, x.numel() * 4)
            assert sum(per_nic) == x.numel() * 4
            assert sum(b > 0 for b in per_nic) >= 2, per_nic
            pools = eager._state.scheduler.credit_pools()
            assert pools and all(v == eager._state.cfg.scheduling_credit
                                 for v in pools.values()), pools
            split.append(per_nic)
        finally:
            eager.shutdown()
            eager._state.__init__()
            t_reset()
            stop_server()
    assert split[0] != split[1]
