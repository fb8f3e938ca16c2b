"""The port's native summation server and its worker client, against the
reference's: the library builds from the port's own sources into its own
build directory; a reference PSWorker and a port PSWorker pushing seeded
partitions under every wire codec pull bit-equal buffers, on a reference
server and on a port server; the native sum and codecs agree bit for
bit; and each DCN-tier knob the port has not ported is refused."""

import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from byteps_tpu.compression import wire as rwire
from byteps_tpu_torch.common import config as tconfig
from byteps_tpu_torch.compression import wire as twire
from byteps_tpu_torch.server import native as tnative

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from dcn_fixtures import (csrc_listing, job_env, next_port,  # noqa: E402
                          port_lib, reference_lib)

ROOT = Path(__file__).resolve().parents[1]

_BUILD = r"""
import sys
from pathlib import Path
from byteps_tpu_torch.server import native
native.BUILD_DIR = Path(sys.argv[1])
print(native.build())
"""


def test_library_builds_from_its_own_sources(tmp_path):
    """Two processes build at once into an empty build directory: one
    library, named by the sources' digest, no build leftovers, and
    neither source directory touched."""
    ref_before = csrc_listing()
    port_before = csrc_listing(tnative.CSRC)
    build = tmp_path / "_build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o[0].strip().splitlines()[-1] for o in outs}
    assert len(paths) == 1
    lib = Path(paths.pop())
    assert lib.parent == build and lib.name == tnative.library_path().name
    assert sorted(f.name for f in build.iterdir()) == [".lock", lib.name]
    assert csrc_listing() == ref_before
    assert csrc_listing(tnative.CSRC) == port_before
    assert not [f for f in tnative.CSRC.iterdir()
                if f.suffix in (".o", ".so")]


@pytest.fixture
def servers():
    """Start/stop helpers for one reference and one port server."""
    from byteps_tpu import server as rserver
    from byteps_tpu_torch import server as tserver

    reference_lib()
    port_lib()
    started = []

    def start(kind):
        mod = {"ref": rserver, "port": tserver}[kind]
        port = tserver.any_port(
            lambda p: mod.start_server(port=p, num_workers=2,
                                       engine_threads=2,
                                       pull_timeout_ms=20000), next_port())
        started.append(mod)
        return [("127.0.0.1", port)]

    yield start
    for mod in started:
        mod.stop_server()


def _mixed_round(servers, n, seed, port_kw=None):
    """Worker 0 is the reference's PSWorker, worker 1 the port's (built
    with ``port_kw``, and reporting its TCP connections before the
    closing barrier under ``"conns"``); each
    pushes its own seeded vector under every codec and pulls the round raw
    and in the codec's own pull format. Returns {worker: {case: bytes}}.
    Worker 1 pushes a key only after worker 0's push of it returned: where
    the server's decode-and-add multiplies (fp8's and dithering's
    ``dst += value * scale``), ``-march=native`` may fuse the multiply
    into the add, and then the f32 sum depends on the order in which the
    pushes arrive, on either server."""
    from byteps_tpu import server as rserver
    from byteps_tpu_torch import server as tserver

    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(n).astype(np.float32) for _ in range(2)]
    xs[1][::5] = xs[0][::5]            # some exact ties and cancellations
    xs[1][1::7] = -xs[0][1::7]
    out, errors = {}, []
    pushed = [threading.Event() for _ in range(16)]

    def work(wid, mod, wire):
        try:
            w = mod.PSWorker(servers=servers, worker_id=wid,
                             recv_timeout_ms=20000,
                             **((port_kw or {}) if wid == 1 else {}))
            codecs = {"raw": wire.WireCodec(), "fp16": wire.Fp16Wire(),
                      "fp8": wire.Fp8Wire(), "onebit": wire.OnebitWire(),
                      "topk": wire.TopkWire(k=0.01),
                      "topk_block": wire.TopkWire(k=0.01, selection="block"),
                      "dither": wire.DitherWire(),
                      "dither_natural": wire.DitherWire(
                          s=8, partition="natural", normalize="max"),
                      "randomk": wire.RandomkWire(k=0.05)}
            got = {}
            for key, (case, c) in enumerate(codecs.items()):
                plan = wire.WirePlan(c, two_way=True)
                w.init_key(key, c.store_elems(n) * 4)
                if wid == 1:
                    assert pushed[key].wait(20)
                v = w.push_bytes(key, c.encode(xs[wid], seed=seed + key),
                                 c.codec_id)
                if wid == 0:
                    pushed[key].set()
                got[case + ".raw"] = w.pull_bytes(
                    key, c.store_elems(n) * 4, v).tobytes()
                got[case] = w.pull_bytes(key, plan.pull_capacity(n), v,
                                         plan.pull_codec_id).tobytes()
            if wid == 1:
                conns = len(w._all_conns)
            w.barrier()
            w.shutdown()
            out[wid] = got
            if wid == 1:
                out["conns"] = conns
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append((wid, repr(e)))

    ts = [threading.Thread(target=work, args=(0, rserver, rwire)),
          threading.Thread(target=work, args=(1, tserver, twire))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts), "a worker hung"
    assert not errors, errors
    return out


@pytest.mark.parametrize("n", [1000, 20001])
def test_mixed_workers_pull_bit_equal_on_either_server(servers, n):
    on_ref = _mixed_round(servers("ref"), n, seed=n)
    on_port = _mixed_round(servers("port"), n, seed=n)
    assert on_ref[0] == on_ref[1]
    assert on_port[0] == on_port[1]
    assert on_ref[0] == on_port[0]
    # and the raw sum is the f32 sum of the two decoded pushes
    rng = np.random.default_rng(n)
    xs = [rng.standard_normal(n).astype(np.float32) for _ in range(2)]
    xs[1][::5] = xs[0][::5]
    xs[1][1::7] = -xs[0][1::7]
    np.testing.assert_array_equal(
        np.frombuffer(on_port[0]["raw.raw"], np.float32), xs[0] + xs[1])


@pytest.mark.parametrize("n", [1000, 20001])
def test_ipc_worker_pulls_bit_equal_beside_a_tcp_worker(servers, n):
    """The port worker reaches the port's in-process server through the
    IPC path (no TCP connection until the closing barrier) beside a
    reference worker on TCP: under every codec both pull the bytes that
    two TCP workers pull from the reference's server."""
    on_ref = _mixed_round(servers("ref"), n, seed=n)
    on_ipc = _mixed_round(servers("port"), n, seed=n,
                          port_kw={"use_ipc": True})
    assert on_ipc["conns"] == 0 and on_ref["conns"] > 0
    assert on_ipc[0] == on_ipc[1]
    assert on_ipc[0] == on_ref[0]


def test_ipc_path_without_tcp_and_after_shutdown():
    """IPC on: init, push and pull of the in-process server's keys open
    no TCP connection (reference ``tests/test_dcn.py:505``); a
    worker-driven shutdown stops the server, after which the local path
    raises on -10 instead of reaching the stopped store, and a restart
    in the process reclaims it (``:464``). IPC asked for with no server
    in the process stays on TCP."""
    from byteps_tpu_torch import server as tserver

    lib = port_lib()
    port = tserver.start_server_any_port(next_port(), num_workers=1,
                                         engine_threads=1)
    addr = [("127.0.0.1", port)]
    x = np.arange(32, dtype=np.float32)
    try:
        w = tserver.PSWorker(servers=addr, use_ipc=True)
        assert w._is_local(0)
        w.init_key(4, x.nbytes)
        np.testing.assert_array_equal(w.push_pull(4, x), x)
        np.testing.assert_array_equal(w.push_pull(4, 2 * x), 2 * x)
        assert not w._all_conns and w.bytes_pushed == 2 * x.nbytes
        w.shutdown()               # the one worker's goodbye stops it
        deadline = time.monotonic() + 5
        while (lib.bps_local_init(12, 32) != tnative.LOCAL_NO_SERVER
               and time.monotonic() < deadline):
            time.sleep(0.05)
        w2 = tserver.PSWorker(servers=addr, use_ipc=True)
        with pytest.raises(RuntimeError, match="rc=-10.*no summation"):
            w2.init_key(12, 32)
        w2.close()
        port = tserver.start_server_any_port(port, num_workers=1,
                                             engine_threads=1)
        w3 = tserver.PSWorker(servers=[("127.0.0.1", port)],
                              use_ipc=True)
        w3.init_key(13, x.nbytes)
        np.testing.assert_array_equal(w3.push_pull(13, x), x)
        assert not w3._all_conns
        w3.shutdown()
    finally:
        tserver.stop_server()
    assert tserver._INPROC_SERVER_ID is None
    w4 = tserver.PSWorker(servers=addr, use_ipc=True)
    assert not w4._ipc
    w4.close()


def test_native_sum_and_codecs_match_reference():
    ref = reference_lib()
    port = tnative.load_lib()
    rng = np.random.default_rng(7)
    for n in (1, 7, 1024, 100003):
        dst = rng.standard_normal(n).astype(np.float32)
        src = rng.standard_normal(n).astype(np.float32)
        a, b = dst.copy(), dst.copy()
        from byteps_tpu.server.native import reduce_sum_f32 as rsum
        rsum(a, src)
        tnative.reduce_sum_f32(b, src)
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
        np.testing.assert_array_equal(b, dst + src)
    # the server's re-encode of a sum, codec by codec, and its fp8 casts
    x = (rng.standard_normal(5000) * 3).astype(np.float32)
    x[::9] = 0.0
    for codec in (twire.WIRE_RAW, twire.WIRE_FP16, twire.WIRE_ONEBIT,
                  twire.WIRE_TOPK, twire.WIRE_DITHER, twire.WIRE_FP8):
        outs = []
        for lib in (ref, port):
            buf = np.empty(8 + 8 * x.size, np.uint8)
            got = lib.bps_codec_encode(codec, x.ctypes.data, x.size, 50,
                                       12345, buf.ctypes.data, buf.size)
            assert got > 0
            outs.append(buf[:got].copy())
        assert np.array_equal(*outs), codec
    # deterministic codecs: the server's bytes are the host codec's
    for codec, c in ((twire.WIRE_FP16, twire.Fp16Wire()),
                     (twire.WIRE_FP8, twire.Fp8Wire()),
                     (twire.WIRE_ONEBIT, twire.OnebitWire())):
        buf = np.empty(8 + 8 * x.size, np.uint8)
        got = port.bps_codec_encode(codec, x.ctypes.data, x.size, 0, 0,
                                    buf.ctypes.data, buf.size)
        assert np.array_equal(buf[:got], c.encode(x)), codec
    grid = np.concatenate([np.linspace(-448, 448, 2001, dtype=np.float32),
                           np.array([0.0, -0.0, 2 ** -9, 2 ** -10, 1e-3],
                                    np.float32)])
    assert [port.bps_float_to_fp8(float(v)) for v in grid] == \
        [ref.bps_float_to_fp8(float(v)) for v in grid]


# a fault spec is ported but for its join rules (elastic membership);
# the IPC path and several controllers a pod are ported since, and
# accepted
UNPORTED = [("BYTEPS_ENABLE_ASYNC", "1"), ("BYTEPS_STALENESS", "2"),
            ("BYTEPS_WORKER_LEASE_MS", "500"), ("BYTEPS_ENABLE_IPC", "1"),
            ("BYTEPS_POD_CONTROLLERS", "2"),
            ("BYTEPS_FAULT_SPEC", "push:kill@op=1;worker2:join@step=3")]
PORTED = ("BYTEPS_ENABLE_IPC", "BYTEPS_POD_CONTROLLERS")


def _accepted(monkeypatch, knob):
    """A one-worker job with ``knob`` set: the server starts, a DcnCore
    built from the environment takes the knob (the IPC path to the
    in-process server; two controller NICs with owner-scoped credits),
    and a push_pull sums exactly."""
    from byteps_tpu_torch import server as tserver
    from byteps_tpu_torch.common.dcn_adapter import DcnCore

    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    tconfig.reset_config()
    tconfig.check_ported()
    port = tserver.start_server_any_port(next_port())
    core = None
    try:
        core = DcnCore(servers=[("127.0.0.1", port)])
        if knob == "BYTEPS_ENABLE_IPC":
            assert core.worker._ipc and len(core.workers) == 1
        else:
            assert len(core.workers) == 2
            assert core.scheduler._credit_scope == "owner"
        x = np.arange(50000, dtype=np.float32)
        h = core.push_pull_async(x, name="accepted")
        np.testing.assert_array_equal(DcnCore.assemble(h, 30), x)
    finally:
        if core is not None:
            core.shutdown()
        tserver.stop_server()
        tconfig.reset_config()


@pytest.mark.parametrize("knob,value", UNPORTED)
def test_unported_knobs_are_refused(monkeypatch, knob, value):
    """Each knob not ported yet is refused by every entry of the tier;
    the knobs of ``PORTED`` are accepted."""
    from byteps_tpu_torch import server as tserver
    from byteps_tpu_torch.common.dcn_adapter import DcnCore

    job_env(monkeypatch, next_port())
    monkeypatch.setenv(knob, value)
    tconfig.reset_config()
    if knob in PORTED:
        _accepted(monkeypatch, knob)
        return
    try:
        short = knob.split("_", 1)[1]
        for call in (tconfig.check_ported, tserver.start_server,
                     tserver.PSWorker, DcnCore):
            with pytest.raises(RuntimeError,
                               match=f"{short}.*not ported yet"):
                call()
    finally:
        tconfig.reset_config()
    # the same value with the knob's default elsewhere is accepted
    monkeypatch.delenv(knob)
    tconfig.reset_config()
    try:
        tconfig.check_ported()
    finally:
        tconfig.reset_config()


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_crc_and_pacer_on_one_worker(servers, monkeypatch, kind):
    """BYTEPS_WIRE_CRC checks every push and pull response; the pacer books
    every payload byte each way."""
    from byteps_tpu_torch import server as tserver

    monkeypatch.setenv("BYTEPS_WIRE_CRC", "1")
    tconfig.reset_config()
    try:
        addr = servers(kind)
        w = tserver.PSWorker(servers=addr, worker_id=0, throttle_mbps=1e4,
                             recv_timeout_ms=20000)
        assert w._crc
        rng = np.random.default_rng(3)
        x = rng.standard_normal(3000).astype(np.float32)
        y = rng.standard_normal(3000).astype(np.float32)
        w.init_key(7, x.nbytes)
        # a two-worker server: the second contribution comes from a
        # second port worker
        w2 = tserver.PSWorker(servers=addr, worker_id=1,
                              recv_timeout_ms=20000)
        w2.init_key(7, y.nbytes)
        v = w.push(7, x)
        assert w2.push(7, y) == v
        got = w.pull(7, x.size, v)
        np.testing.assert_array_equal(got, x + y)
        assert w.pacer.sent_bytes == w.bytes_pushed == x.nbytes
        assert w.pacer.recv_bytes == w.bytes_pulled == x.nbytes
        assert w.get_counters()["crc_errors"] == 0
        np.testing.assert_array_equal(w2.pull(7, y.size, v), x + y)
        assert tserver.wire_crc32(b"") == 1
        w.shutdown()
        w2.shutdown()
    finally:
        tconfig.reset_config()
