"""The port's real socket NIC (``byteps_tpu_torch/common/socknic.py``) and
KV socket seam (``serve/kv_socket.py``), twin of ``tests/test_socknic.py``:
framed CRC transport between processes behind the interfaces the
emulated transports use — plus the ``BNC1`` frame byte for byte the
reference's (a port client against a reference listener and the
reverse), and a migrated request's greedy tokens over a real socket
equal to the reference's own socket run on the same f32 weights.

Every wait on a socket or process here is bounded (client deadlines,
``_T``)."""

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from byteps_tpu.common import faults as rfaults
from byteps_tpu.common import socknic as rsock
from byteps_tpu_torch.common import config as config_mod
from byteps_tpu_torch.common import faults as tfaults
from byteps_tpu_torch.common.faults import FaultPlan, parse_fault_spec
from byteps_tpu_torch.common.metrics import get_registry, reset_registry
from byteps_tpu_torch.common.socknic import (
    CH_PING,
    SockRemoteError,
    SockWireCorruption,
    SocketNicClient,
    SocketNicListener,
)
from byteps_tpu_torch.common import socknic as tsock
from byteps_tpu_torch.server import _is_retryable_wire_error, any_port

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from dcn_fixtures import next_port, port_lib  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_T = 60


@pytest.fixture(autouse=True)
def _fresh():
    reset_registry()
    yield
    config_mod.reset_config()


def _counters():
    return get_registry().snapshot()["counters"]


def _sum_counters(suffix):
    return sum(v for k, v in _counters().items()
               if k.startswith("socknic.") and k.endswith(suffix))


# ---- framing ----------------------------------------------------------------
def test_ping_roundtrip_and_large_frame():
    lst = SocketNicListener(next_port())
    cli = SocketNicClient("127.0.0.1", lst.port, timeout_ms=5000)
    try:
        assert cli.ping(b"hello") == b"hello"
        big = os.urandom(1 << 20)
        assert cli.request(CH_PING, big) == big
        assert _sum_counters(".frames") == 2
        assert _sum_counters(".crc_rejects") == 0
    finally:
        cli.close()
        lst.close()


def test_unknown_channel_is_a_typed_remote_error():
    lst = SocketNicListener(next_port())
    cli = SocketNicClient("127.0.0.1", lst.port, timeout_ms=5000)
    try:
        with pytest.raises(SockRemoteError, match="no handler"):
            cli.request(42, b"x")
        assert cli.ping() == b"socknic"   # the link survives
    finally:
        cli.close()
        lst.close()


def test_frames_byte_identical_to_the_reference():
    for ch, seq, flags, body in ((0, 1, 0, b""), (1, 7, 1, b"kv" * 999),
                                 (42, 2**31, 3, os.urandom(513))):
        assert tsock._frame(ch, seq, flags, body) == \
            rsock._frame(ch, seq, flags, body)
    assert tsock._HDR.format == rsock._HDR.format
    assert tsock._MAGIC == rsock._MAGIC


@pytest.mark.parametrize("listener,client", [
    (rsock.SocketNicListener, SocketNicClient),
    (SocketNicListener, rsock.SocketNicClient)])
def test_port_and_reference_ends_talk_to_each_other(listener, client):
    """A port client against a reference listener and the reverse: pings,
    a 1 MiB frame, a registered handler, a relayed handler error and a
    corrupted frame rejected by the far end's CRC, then healed."""
    lst = listener(next_port())
    lst.register(9, lambda body: body[::-1])
    lst.register(11, lambda body: (_ for _ in ()).throw(
        ValueError("bad body")))
    faults = tfaults if client is SocketNicClient else rfaults
    cli = client("127.0.0.1", lst.port, timeout_ms=5000)
    bad = client("127.0.0.1", lst.port, timeout_ms=5000,
                 fault_plan=faults.FaultPlan(
                     faults.parse_fault_spec("push:corrupt@op=1"), seed=3))
    try:
        assert cli.ping(b"hello") == b"hello"
        big = os.urandom(1 << 20)
        assert cli.request(CH_PING, big) == big
        assert cli.request(9, b"abcdef") == b"fedcba"
        with pytest.raises(Exception, match="ValueError: bad body"):
            cli.request(11, b"x")
        with pytest.raises(Exception) as ei:
            bad.request(9, b"payload")
        assert type(ei.value).__name__ == "SockWireCorruption"
        assert bad.request(9, b"payload") == b"daolyap"
    finally:
        cli.close()
        bad.close()
        lst.close()


def test_listener_sidesteps_port_squatter():
    base = next_port()
    squatter = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    squatter.bind(("127.0.0.1", base))
    squatter.listen(1)
    try:
        lst = SocketNicListener(base)
        try:
            assert lst.port == base + 1  # next probe, stride 1
            cli = SocketNicClient("127.0.0.1", lst.port, timeout_ms=5000)
            assert cli.ping() == b"socknic"
            cli.close()
        finally:
            lst.close()
    finally:
        squatter.close()


def test_any_port_generic_probing_and_error_passthrough():
    calls = []

    def bind_busy_then_ok(p):
        calls.append(p)
        if len(calls) < 3:
            raise OSError(98, "Address already in use")
        return p

    assert any_port(bind_busy_then_ok, 100, attempts=4) == 102
    assert calls == [100, 101, 102]

    def bind_rc2(p):
        if p < 201:
            raise RuntimeError("bps_server_start failed (rc=-2, port=200)")
        return p

    assert any_port(bind_rc2, 200, attempts=4) == 201
    with pytest.raises(OSError, match="Permission"):
        any_port(lambda p: (_ for _ in ()).throw(
            OSError(1, "Permission denied (op not permitted)")), 300)
    with pytest.raises(RuntimeError, match="rc=-5"):
        any_port(lambda p: (_ for _ in ()).throw(
            RuntimeError("bps_server_start failed (rc=-5)")), 300)
    with pytest.raises(RuntimeError, match="no squatter-free port"):
        any_port(lambda p: (_ for _ in ()).throw(
            OSError(98, "Address already in use")), 300, attempts=3)


# ---- chaos: real corruption, real connection errors -------------------------
def test_injected_corruption_caught_by_listener_crc_and_healed():
    plan = FaultPlan(parse_fault_spec("push:corrupt@op=1"), seed=3)
    lst = SocketNicListener(next_port())
    cli = SocketNicClient("127.0.0.1", lst.port, timeout_ms=5000,
                          fault_plan=plan)
    try:
        with pytest.raises(SockWireCorruption):
            cli.request(CH_PING, b"payload")
        assert SockWireCorruption.retryable is True
        assert cli.request(CH_PING, b"payload") == b"payload"
        assert plan.counters()["corrupt"] == 1
        assert _sum_counters(".crc_rejects") == 1
        assert _sum_counters(".crc_errors") == 1
    finally:
        cli.close()
        lst.close()


def test_real_connection_errors_keep_the_wire_taxonomy():
    cli = SocketNicClient("127.0.0.1", next_port(), timeout_ms=2000)
    with pytest.raises(ConnectionError) as ei:
        cli.ping()
    assert _is_retryable_wire_error(ei.value)
    cli.close()

    lst = SocketNicListener(next_port())
    cli = SocketNicClient("127.0.0.1", lst.port, timeout_ms=2000)
    assert cli.ping() == b"socknic"
    lst.close()
    time.sleep(0.05)
    with pytest.raises((ConnectionError, TimeoutError)) as ei:
        cli.ping()
    assert _is_retryable_wire_error(ei.value)
    cli.close()

    lst = SocketNicListener(next_port())
    lst.register(7, lambda body: time.sleep(1.5) or b"late")
    cli = SocketNicClient("127.0.0.1", lst.port, timeout_ms=200)
    try:
        with pytest.raises(TimeoutError) as ei:
            cli.request(7, b"x")
        assert _is_retryable_wire_error(ei.value)
        assert _sum_counters(".timeouts") == 1
    finally:
        cli.close()
        lst.close()


def test_client_is_thread_safe_per_thread_sockets():
    lst = SocketNicListener(next_port())
    lst.register(9, lambda body: body[::-1])
    cli = SocketNicClient("127.0.0.1", lst.port, timeout_ms=5000)
    errs = []

    def hammer(i):
        try:
            for j in range(20):
                body = f"t{i}.{j}".encode()
                assert cli.request(9, body) == body[::-1]
        except Exception as e:  # noqa: BLE001 - surfaced via errs
            errs.append(e)

    try:
        ts = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not errs
        assert _sum_counters(".requests") == 80
    finally:
        cli.close()
        lst.close()


def test_socket_mbps_paces_the_client(monkeypatch):
    """``BYTEPS_SOCKET_MBPS`` arms the client's pacer: every frame's bytes
    go through its token bucket, which makes 2 Mbit over an 8 Mbit/s
    link sleep."""
    monkeypatch.setenv("BYTEPS_SOCKET_MBPS", "8")
    config_mod.reset_config()
    lst = SocketNicListener(next_port())
    cli = SocketNicClient("127.0.0.1", lst.port, timeout_ms=5000)
    try:
        assert cli._pacer is not None
        for _ in range(4):
            cli.request(CH_PING, b"x" * 62_500)
        assert cli._pacer.sent_bytes == 4 * (24 + 62_500)
        assert cli._pacer.recv_bytes == 4 * (24 + 62_500)
        assert cli._pacer.send_sleep_s > 0
    finally:
        cli.close()
        lst.close()


# ---- drop-in bit-identity: gradient push/pull over real TCP -----------------
def test_gradient_push_pull_over_tcp_bit_identical_to_ipc():
    from byteps_tpu_torch.server import PSWorker, start_server, stop_server

    port_lib()
    port = next_port()
    rounds, elems = 4, 64
    rng = np.random.default_rng(5)
    payloads = [rng.standard_normal(elems).astype(np.float32)
                for _ in range(rounds)]

    def run_rounds(servers, use_ipc):
        sums = []
        w = PSWorker(servers=servers, worker_id=0, use_ipc=use_ipc,
                     health_interval_ms=0)
        w.init_key(0, elems * 4)
        for r in range(rounds):
            v = w.push_bytes(0, payloads[r].view(np.uint8))
            sums.append(w.pull_bytes(0, elems * 4, v).tobytes())
        w.shutdown()
        return sums

    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from byteps_tpu_torch.server import start_server, load_lib\n"
         f"start_server(port={port}, num_workers=1, engine_threads=2,\n"
         "             async_mode=False)\n"
         "load_lib().bps_server_wait()\n"],
        env={**os.environ, "PYTHONPATH": REPO}, cwd=REPO)
    try:
        deadline = time.time() + _T
        while time.time() < deadline:
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=0.2).close()
                break
            except OSError:
                time.sleep(0.1)
        tcp_sums = run_rounds([("127.0.0.1", port)], use_ipc=False)
        assert proc.wait(timeout=_T) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    ipc_port = next_port()
    start_server(port=ipc_port, num_workers=1, engine_threads=2,
                 async_mode=False)
    try:
        ipc_sums = run_rounds([("127.0.0.1", ipc_port)], use_ipc=True)
    finally:
        stop_server()
    assert tcp_sums == ipc_sums


# ---- KV migration over a real socket ----------------------------------------
@pytest.fixture(scope="module")
def model():
    from byteps_tpu.models import GPTConfig as JConfig
    from byteps_tpu.models.gpt import gpt_init as j_init
    from byteps_tpu_torch.models import GPTConfig, params_from_numpy

    jp = j_init(jax.random.PRNGKey(0), JConfig.tiny())
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                 GPTConfig.tiny(), device="cpu")


def _reqs():
    rng = np.random.default_rng(7)
    vocab = 256          # GPTConfig.tiny()'s, in both packages
    return [(f"r{i}", rng.integers(0, vocab, (9, 14, 6)[i]).astype(np.int32),
             (8, 5, 10)[i]) for i in range(3)]


def _socket_router(pkg, params, reqs):
    """``pkg``'s Router over a prefill and a decode replica, every KV
    block delivered through ``pkg``'s SocketKVTarget → KVSocketEndpoint;
    returns the results and the blocks the endpoint ingested."""
    if pkg == "ref":
        from byteps_tpu.common.metrics import get_registry as reg
        from byteps_tpu.models import GPTConfig as C
        from byteps_tpu.serve import Request, Router, Scheduler
        from byteps_tpu.serve.kv_socket import (KVSocketEndpoint,
                                                SocketKVTarget)
        kw = {}
    else:
        from byteps_tpu_torch.common.metrics import get_registry as reg
        from byteps_tpu_torch.models import GPTConfig as C
        from byteps_tpu_torch.serve import Request, Router, Scheduler
        from byteps_tpu_torch.serve.kv_socket import (KVSocketEndpoint,
                                                      SocketKVTarget)
        kw = {"device": "cpu"}
    cfg = C.tiny()
    before = reg().snapshot()["counters"].get(
        "serve.kv_socket.blocks_ingested", 0)
    pre = Scheduler(params, cfg, max_batch=3, prefill_chunk=4,
                    role="prefill", replica_id=1, **kw)
    dec = Scheduler(params, cfg, max_batch=3, prefill_chunk=4,
                    role="decode", replica_id=0, **kw)
    endpoint = KVSocketEndpoint(dec, port=next_port())
    proxies, lock = {}, threading.Lock()

    def wrap(sched):
        with lock:           # the wire's push threads resolve at once
            if id(sched) not in proxies:
                proxies[id(sched)] = SocketKVTarget(
                    endpoint.host, endpoint.port, timeout_ms=10000)
            return proxies[id(sched)]

    router = Router([dec], prefill_replicas=[pre], lease_ms=5000,
                    prompt_threshold=1, kv_target_wrap=wrap)
    try:
        res = router.run([Request(rid=r, prompt=p, max_new=n)
                          for r, p, n in reqs])
    finally:
        router.close()
        for p in proxies.values():
            p.close()
        endpoint.close()
    assert pre.cache.leaked_blocks() == 0
    assert dec.cache.leaked_blocks() == 0
    after = reg().snapshot()["counters"]
    return res, after.get("serve.kv_socket.blocks_ingested", 0) - before, \
        after


def test_kv_migration_over_real_socket_equals_the_reference(model):
    """Disaggregated prefill → decode with every KV block crossing a real
    TCP socket (``Router(kv_target_wrap=...)``): the port's greedy tokens
    equal the port's solo generate and the reference's own socket run on
    the same f32 weights, with as many blocks over the socket."""
    from byteps_tpu_torch.models import GPTConfig, make_generate_fn

    jp, tp = model
    reqs = _reqs()
    res, blocks, c = _socket_router("port", tp, reqs)
    jres, jblocks, _ = _socket_router("ref", jp, reqs)
    for rid, prompt, n in reqs:
        solo = make_generate_fn(GPTConfig.tiny(), n, device="cpu")(
            tp, prompt[None])
        np.testing.assert_array_equal(res[rid]["tokens"], solo.numpy()[0])
        np.testing.assert_array_equal(res[rid]["tokens"],
                                      jres[rid]["tokens"])
    assert c["serve.migration.adopted"] == len(reqs)
    assert c["serve.migration.recompute_tokens"] == 0
    assert blocks == jblocks >= len(reqs)


def test_kv_socket_corruption_healed_by_stage_retry(model):
    """A corrupt rule on the SOCKET client damages the framed bytes on the
    real wire; the remote codec's CRC rejects, the typed KVWireCorruption
    crosses back, and KVPUSH's stage retry re-sends pristine."""
    from byteps_tpu_torch.models import GPTConfig
    from byteps_tpu_torch.serve import Scheduler
    from byteps_tpu_torch.serve.kv_socket import (KVSocketEndpoint,
                                                  SocketKVTarget)
    from byteps_tpu_torch.serve.kv_wire import KVWire

    _, tp = model
    sched = Scheduler(tp, GPTConfig.tiny(), max_batch=2, block_size=4,
                      device="cpu")
    sched.cache.register("w")
    sched.cache.ensure("w", 8)
    sched.cache.state.k.add_(1.0)
    payloads = sched.cache.snapshot_blocks("w", 0, 2)
    plan = FaultPlan(parse_fault_spec("push:corrupt@op=1"), seed=0)
    endpoint = KVSocketEndpoint(sched, port=next_port())
    target = SocketKVTarget(endpoint.host, endpoint.port,
                            timeout_ms=10000, fault_plan=plan)
    wire = KVWire(sched.kv_codec, resolve=lambda rid: target)
    try:
        handles = [wire.send_block("w", bi, p)
                   for bi, p in payloads.items()]
        for h in handles:
            h.wait(timeout=_T)
        assert sched.staged_blocks("w") == {0, 1}
        staged = sched.pop_staged("w")
        for bi, p in payloads.items():
            np.testing.assert_array_equal(staged[bi].k, p.k)
            np.testing.assert_array_equal(staged[bi].v, p.v)
        assert plan.counters()["corrupt"] == 1
        assert _counters()["scheduler.stage_retries"] >= 1
        assert _sum_counters(".crc_rejects") >= 1
    finally:
        wire.shutdown()
        target.close()
        endpoint.close()
        sched.cache.release("w")
    assert sched.cache.leaked_blocks() == 0
