"""The flight recorder's event ring — the port's lean copy of
``byteps_tpu/common/flight_recorder.py``.

The reference keeps two bounded rings for post-mortems: per-step metric
snapshots fed by its tracer's step advance, and the most recent
FAULT-class events (retries, failovers, evictions, scale decisions).
The port keeps the second: the serve tier's replica deaths, preemptions
and KV migrations, and every autoscaler decision
(:func:`~byteps_tpu_torch.common.autoscaler.record_decision`), land here
as they do in the reference. The per-step ring, ``post_mortem`` and its
dump files wait for the port's tracer (ROADMAP A.8).

Knob: ``BYTEPS_FLIGHT_RECORDER_EVENTS`` (ring size, 0 records nothing).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from byteps_tpu_torch.common.metrics import json_safe


class FlightRecorder:
    """A bounded ring of recent FAULT-class events."""

    def __init__(self, max_events: int = 128) -> None:
        self.max_events = max(0, max_events)
        self._events: deque = deque(maxlen=max(1, self.max_events))
        self._lock = threading.Lock()
        self._t0 = time.time()

    def record_event(self, name: str,
                     args: Optional[Dict[str, Any]] = None) -> None:
        """Append one event; its args are made JSON-safe now, so a numpy
        scalar cannot poison a later dump."""
        if self.max_events <= 0:
            return
        ev = {"t_s": round(time.time() - self._t0, 6),
              "event": str(name),
              "args": json_safe(args or {})}
        with self._lock:
            self._events.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    """The process-wide recorder, sized from the config on first use."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                from byteps_tpu_torch.common.config import get_config

                _recorder = FlightRecorder(
                    max_events=get_config().flight_recorder_events)
    return _recorder


def reset_flight_recorder() -> None:
    """Drop the cached recorder (test isolation, like reset_registry)."""
    global _recorder
    with _recorder_lock:
        _recorder = None
