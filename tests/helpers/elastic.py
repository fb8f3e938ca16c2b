"""Shared plumbing of the elastic-membership parity tests
(``tests/test_torch_membership.py``, ``tests/test_torch_staleness.py``):
the reference's and the port's server packages side by side, a bounded
poll, and threads that fail one test instead of hanging the suite."""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List

from dcn_fixtures import next_port, port_lib, reference_lib


def packages(kind: str):
    """(server package, native module, config module) of the reference
    (``"ref"``) or the port (``"port"``), each library built and loaded."""
    if kind == "ref":
        from byteps_tpu.common import config
        from byteps_tpu.server import native
        import byteps_tpu.server as server

        reference_lib()
    else:
        from byteps_tpu_torch.common import config
        from byteps_tpu_torch.server import native
        import byteps_tpu_torch.server as server

        port_lib()
    return server, native, config


def reset_configs() -> None:
    from byteps_tpu.common import config as rconfig
    from byteps_tpu_torch.common import config as tconfig

    rconfig.reset_config()
    tconfig.reset_config()


def start(kind: str, **kw) -> int:
    """A server of ``kind``'s library on a fresh port; returns the port."""
    server, _, _ = packages(kind)
    return server.start_server_any_port(next_port(), **kw)


def wait_until(pred: Callable[[], bool], bound: float = 10.0,
               what: str = "condition") -> None:
    end = time.monotonic() + bound
    while not pred():
        if time.monotonic() > end:
            raise AssertionError(f"{what} did not hold within {bound} s")
        time.sleep(0.02)


def run_threads(bodies: Dict[str, Callable[[], None]],
                bound: float = 60.0) -> Dict[str, BaseException]:
    """Run each body on its own thread, join each within ``bound`` and
    fail if one still runs; returns the exceptions they raised, by
    name."""
    errors: Dict[str, BaseException] = {}

    def wrap(name, body):
        def run():
            try:
                body()
            except BaseException as e:  # noqa: BLE001 - reported to caller
                errors[name] = e
        return run

    threads: List[threading.Thread] = [
        threading.Thread(target=wrap(n, b), daemon=True, name=n)
        for n, b in bodies.items()]
    for t in threads:
        t.start()
    end = time.monotonic() + bound
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))
    hung = [t.name for t in threads if t.is_alive()]
    assert not hung, f"thread(s) {hung} still running after {bound} s"
    return errors
