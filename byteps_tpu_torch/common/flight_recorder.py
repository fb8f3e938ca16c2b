"""Per-step flight recorder: the always-on post-mortem ring buffer (the
port's copy of ``byteps_tpu/common/flight_recorder.py``).

A stall report alone shows only the moment of death: ``StallError``
carries the current per-NIC counters and credit pools, but nothing about
the steps leading up to it. This module keeps a bounded ring of per-step
metric snapshots (stage dwell/run percentiles, the registry's counters
and gauges, step walltime) plus the most recent FAULT-class events, and
hands the whole thing out as a **post-mortem** that rides every
``StallError`` / ``PartitionFailure`` (attached in
``common/scheduler.py``) and is exposed as
``byteps_tpu_torch.metrics_snapshot()``.

Its producers:

* **steps** — every train-step factory (``models/train.py``,
  ``parallel/zero3.py``) ticks once for each step it dispatches
  (:meth:`FlightRecorder.tick`), and the DCN adapter's round advance
  calls :meth:`FlightRecorder.on_step` with the round number, where the
  reference advances its tracer. Each step also observes
  ``train.step_ms`` in the registry.
* **events** — retries, failovers, evictions, replica deaths, KV
  migrations, the supervisor's spawns and exits and every autoscaler
  decision call :meth:`FlightRecorder.record_event` directly (the
  reference also forwards its tracer's FAULT-track instants; the port
  has no tracer yet).

Knobs: ``BYTEPS_FLIGHT_RECORDER_STEPS`` (ring size, 0 disables the
per-step ring), ``BYTEPS_FLIGHT_RECORDER_EVENTS`` (event ring),
``BYTEPS_FLIGHT_RECORDER_DIR`` (also write post-mortems as JSON files,
one per distinct failure reason per run).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from byteps_tpu_torch.common.logging import get_logger
from byteps_tpu_torch.common.metrics import get_registry, json_safe

log = get_logger("flight_recorder")

# step times are ms-scale: train.step_ms takes the default bucket ladder
_STEP_MS_HIST = "train.step_ms"


class FlightRecorder:
    """Bounded per-step snapshot ring + recent FAULT events."""

    def __init__(self, max_steps: int = 64, max_events: int = 128,
                 dump_dir: str = "") -> None:
        self.max_steps = max(0, max_steps)
        self.max_events = max(0, max_events)
        self._steps: deque = deque(maxlen=max(1, self.max_steps))
        self._events: deque = deque(maxlen=max(1, self.max_events))
        self._dump_dir = dump_dir
        self._lock = threading.Lock()
        # serializes a whole step advance (guard, snapshot, append), so
        # two advancers append in step order with step-consistent
        # snapshots; re-entrant for tick()'s read-then-advance
        self._step_serial = threading.RLock()
        self._step = 0
        self._last_step_t: Optional[float] = None
        self._t0 = time.time()
        # one dump FILE a distinct reason a run
        self._dumped_reasons: set = set()
        # reason -> (monotonic time, post-mortem): a storm failing many
        # handles at once shares one dict
        self._pm_cache: Dict[str, Any] = {}

    # -- producers -----------------------------------------------------------
    def record_event(self, name: str,
                     args: Optional[Dict[str, Any]] = None) -> None:
        """A FAULT-class event. Its args are made JSON-safe now, so a
        numpy scalar cannot poison a later dump."""
        if self.max_events <= 0:
            return
        ev = {"t_s": round(time.time() - self._t0, 6),
              "step": self._step,
              "event": str(name),
              "args": json_safe(args or {})}
        with self._lock:
            self._events.append(ev)

    def on_step(self, step_no: int) -> None:
        """Step boundary ``step_no``: snapshots the registry's headline
        series into the ring and observes the step walltime. Idempotent
        per step number; skipped steps collapse into one entry (whose
        walltime then covers the skipped span)."""
        with self._step_serial:
            self._on_step_serialized(step_no)

    def _on_step_serialized(self, step_no: int) -> None:
        now = time.perf_counter()
        with self._lock:
            if step_no <= self._step:
                return
            self._step = step_no
            last = self._last_step_t
            self._last_step_t = now
        step_ms = None if last is None else (now - last) * 1e3
        reg = get_registry()
        if step_ms is not None:
            reg.histogram(_STEP_MS_HIST).observe(step_ms)
        if self.max_steps <= 0:
            return
        # scalars for everything, percentiles for the stage histograms
        # only: the full snapshot is the post-mortem's, once
        scalars = reg.snapshot_scalars()
        stage_hists = reg.snapshot(prefix="scheduler.stage.")
        stages: Dict[str, Any] = {}
        for k in stage_hists["histograms"]:
            if not k.endswith(".run_us"):
                continue
            st = k[len("scheduler.stage."):-len(".run_us")]
            stages[st] = {
                f"{kind}_{q}_us": _p(stage_hists,
                                     f"scheduler.stage.{st}.{kind}_us", q)
                for kind in ("dwell", "run") for q in ("p50", "p99")}
        entry = {
            "step": step_no,
            "t_s": round(time.time() - self._t0, 6),
            "step_ms": None if step_ms is None else round(step_ms, 3),
            "stages": stages,
            "counters": scalars["counters"],
            "gauges": scalars["gauges"],
        }
        with self._lock:
            self._steps.append(entry)

    def tick(self) -> None:
        """Advance ONE step past the recorder's current step — for
        producers with a private notion of "a step happened" (the train
        step factories) that cannot know the process-wide step number:
        an absolute ``on_step`` from a fresh counter would be dropped
        whenever the recorder already advanced past it."""
        with self._step_serial:
            with self._lock:
                nxt = self._step + 1
            self._on_step_serialized(nxt)

    # -- consumers -----------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def steps(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._steps)

    def post_mortem(self, reason: str = "manual",
                    extra: Optional[Dict[str, Any]] = None,
                    dump: bool = True,
                    coalesce_s: float = 0.5) -> Dict[str, Any]:
        """The full flight dump: the step ring, the event ring, the
        registry's snapshot and the resolved config. Also written to
        ``BYTEPS_FLIGHT_RECORDER_DIR`` (once a reason) when set and
        ``dump``. Calls without ``extra`` for one reason within
        ``coalesce_s`` share one dict."""
        now = time.monotonic()
        if extra is None:
            with self._lock:
                cached = self._pm_cache.get(reason)
            if cached is not None and now - cached[0] < coalesce_s:
                return cached[1]
        with self._lock:
            steps = list(self._steps)
            events = list(self._events)
            step = self._step
        pm: Dict[str, Any] = {
            "reason": reason,
            "step": step,
            "steps": steps,
            "fault_events": events,
            "metrics": get_registry().snapshot(),
            "config": _config_snapshot(),
        }
        if extra:
            pm["extra"] = json_safe(extra)
        else:
            with self._lock:
                self._pm_cache[reason] = (now, pm)
        if dump:
            self.maybe_dump(reason, pm)
        return pm

    def summary(self) -> Dict[str, Any]:
        """Light view for ``metrics_snapshot()``: counts, not payloads."""
        with self._lock:
            return {"step": self._step,
                    "ring_steps": len(self._steps),
                    "fault_events": len(self._events)}

    def maybe_dump(self, reason: str, pm: Dict[str, Any]) -> Optional[str]:
        """Write ``pm`` as JSON into ``BYTEPS_FLIGHT_RECORDER_DIR`` (no-op
        when unset; once a reason a run). Public so a caller that must
        wake waiters before touching the disk can split build and dump."""
        if not self._dump_dir:
            return None
        with self._lock:
            if reason in self._dumped_reasons:
                return None
            self._dumped_reasons.add(reason)
        try:
            os.makedirs(self._dump_dir, exist_ok=True)
            path = os.path.join(self._dump_dir,
                                f"flight_{reason}_{os.getpid()}.json")
            with open(path, "w") as f:
                json.dump(pm, f, indent=1)
            log.warning("flight-recorder post-mortem (%s) written to %s",
                        reason, path)
            return path
        except Exception as e:  # noqa: BLE001 - a post-mortem writer
            # must never add a second failure on top of the first
            log.warning("flight-recorder dump failed: %s", e)
            return None


def _config_snapshot() -> Dict[str, Any]:
    """The resolved config as a JSON-safe dict; a config problem never
    breaks a post-mortem."""
    try:
        from byteps_tpu_torch.common.config import get_config

        return get_config().snapshot()
    except Exception:  # noqa: BLE001
        return {}


def _p(snap: Dict[str, Any], name: str, stat: str) -> Optional[float]:
    h = snap["histograms"].get(name)
    if not h or not h.get("count"):
        return None
    v = h.get(stat)
    return None if v is None else round(v, 1)


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    """The process-wide recorder, sized from the config on first use."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                from byteps_tpu_torch.common.config import get_config

                cfg = get_config()
                _recorder = FlightRecorder(
                    max_steps=cfg.flight_recorder_steps,
                    max_events=cfg.flight_recorder_events,
                    dump_dir=cfg.flight_recorder_dir)
    return _recorder


def reset_flight_recorder() -> None:
    """Drop the cached recorder (test isolation, like reset_registry)."""
    global _recorder
    with _recorder_lock:
        _recorder = None
