"""Telemetry-driven autoscaling policy — the port's copy of
``byteps_tpu/common/autoscaler.py``.

:class:`ScalingPolicy` reads a domain-agnostic :class:`Sample` and emits
``admit``/``evict``/``hold`` with hysteresis, a sustain requirement and a
cooldown; the serve router (``serve/router.py``) feeds it per-replica
queue depth and TTFT-SLO pressure (:func:`serve_sample`) and spawns or
drains replicas on its decisions; :func:`train_sample` distills the
train domain's sample from ``metrics_snapshot()``, and the launcher's
``Supervisor.execute`` carries a ``domain="proc"`` decision out against
real processes. Every consequential decision — the
policy's, or the router's lease eviction — goes through
:func:`record_decision`: the ``autoscaler.decisions`` and
``autoscaler.<domain>.<action>`` counters and a flight-recorder event,
so a post-mortem shows why a replica was admitted or evicted.

Decision semantics, as the reference's:

* **admit** — ``load`` held at or above ``scale_up_load × (1 +
  hysteresis)`` for ``sustain`` consecutive samples and the unit count
  below ``max_units``;
* **evict** — a straggler (``straggler`` above ``straggler_limit`` for
  ``sustain`` samples) or ``load`` held at or below ``scale_down_load ×
  (1 − hysteresis)``, and the unit count above ``min_units``;
* **hold** — inside the band, during the post-decision cooldown, or at a
  bound.

Not ported yet (ROADMAP A.8): ``record_decision``'s chrome-trace FAULT
instant, which waits for the port's ``common/tracing.py``, as its other
FAULT instants do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.common.flight_recorder import get_flight_recorder
from byteps_tpu_torch.common.logging import get_logger
from byteps_tpu_torch.common.metrics import get_registry

log = get_logger("autoscaler")

__all__ = ["Sample", "Decision", "ScalingPolicy", "record_decision",
           "serve_sample", "train_sample"]


def record_decision(domain: str, action: str, reason: str,
                    target: Optional[int] = None,
                    live: Optional[int] = None,
                    predicted: Optional[Dict[str, Any]] = None) -> None:
    """The one event path of every scale decision: the
    ``autoscaler.decisions`` and ``autoscaler.<domain>.<action>``
    counters and an ``autoscaler.decision`` flight-recorder event
    (``predicted``: the estimator's payoff estimate, when consulted)."""
    reg = get_registry()
    reg.counter("autoscaler.decisions").inc()
    reg.counter(f"autoscaler.{domain}.{action}").inc()
    args = {"domain": domain, "action": action, "reason": reason,
            "target": target, "live": live}
    if predicted is not None:
        args["predicted"] = predicted
    get_flight_recorder().record_event("autoscaler.decision", args)
    log.info("autoscaler[%s]: %s (%s)%s", domain, action, reason,
             f" target={target}" if target is not None else "")


@dataclasses.dataclass(frozen=True)
class Sample:
    """One domain-agnostic policy observation."""

    live: int               # current live unit count (workers/replicas)
    load: float             # demand signal, HIGH = the pool earns its keep
    straggler: float = 0.0  # straggler severity


@dataclasses.dataclass(frozen=True)
class Decision:
    action: str   # 'admit' | 'evict' | 'hold'
    reason: str
    step: int     # the policy step this decision was made at
    live: int     # unit count observed when deciding
    # the estimator's payoff prediction, when one was consulted
    predicted: Optional[Dict[str, float]] = None


class ScalingPolicy:
    """Hysteresis/sustain/cooldown admit-evict-hold policy. The
    constructor's thresholds carry the domain's units; the dynamics
    default from ``BYTEPS_AUTOSCALE_*``.

    ``estimator(n_units) -> predicted aggregate goodput``, when set, makes
    an admit predict its own payoff first: the marginal unit must add at
    least ``hysteresis`` of an average live unit's contribution, else the
    decision becomes a hold that says so (recorded, and arming the
    cooldown like the admit it replaced)."""

    def __init__(self, scale_up_load: float, scale_down_load: float,
                 straggler_limit: Optional[float] = None,
                 hysteresis: Optional[float] = None,
                 cooldown: Optional[int] = None,
                 sustain: Optional[int] = None,
                 min_units: Optional[int] = None,
                 max_units: Optional[int] = None,
                 domain: str = "train",
                 estimator: Optional[Callable[[int], float]] = None):
        cfg = get_config()
        if scale_down_load >= scale_up_load:
            raise ValueError(
                f"scale_down_load ({scale_down_load}) must sit below "
                f"scale_up_load ({scale_up_load}) — an inverted band "
                "admits and evicts at once")
        self.scale_up_load = float(scale_up_load)
        self.scale_down_load = float(scale_down_load)
        self.straggler_limit = straggler_limit
        self.hysteresis = (hysteresis if hysteresis is not None
                           else cfg.autoscale_hysteresis)
        self.cooldown = (cooldown if cooldown is not None
                         else cfg.autoscale_cooldown)
        self.sustain = max(1, sustain if sustain is not None
                           else cfg.autoscale_sustain)
        self.min_units = (min_units if min_units is not None
                          else cfg.autoscale_min)
        self.max_units = (max_units if max_units is not None
                          else cfg.autoscale_max)
        self.domain = domain
        self.estimator = estimator
        self._step = 0
        self._last_change = -(10 ** 9)
        self._up_streak = 0
        self._down_streak = 0
        self._straggler_streak = 0
        # every decision, in order
        self.trace: List[Decision] = []
        self._m_hold = get_registry().counter(f"autoscaler.{domain}.hold")

    def observe(self, sample: Sample) -> Decision:
        """Feed one sample; return (and record) the decision. An admit,
        an evict or an estimator veto resets the streaks and arms the
        cooldown; the caller carries the decision out."""
        self._step += 1
        d = self._decide(sample)
        self.trace.append(d)
        if d.action == "hold" and not (d.predicted is not None
                                       and "veto" in d.reason):
            # plain holds are counted, not recorded: one event a tick
            # would drown the ring
            self._m_hold.inc()
            return d
        record_decision(self.domain, d.action, d.reason, live=sample.live,
                        predicted=d.predicted)
        self._last_change = self._step
        self._up_streak = self._down_streak = 0
        self._straggler_streak = 0
        return d

    def _decide(self, s: Sample) -> Decision:
        up_at = self.scale_up_load * (1.0 + self.hysteresis)
        down_at = self.scale_down_load * (1.0 - self.hysteresis)
        # the streaks advance during the cooldown too, so a condition that
        # persists acts the moment the cooldown ends
        if (self.straggler_limit is not None
                and s.straggler > self.straggler_limit):
            self._straggler_streak += 1
        else:
            self._straggler_streak = 0
        self._up_streak = self._up_streak + 1 if s.load >= up_at else 0
        self._down_streak = (self._down_streak + 1 if s.load <= down_at
                             else 0)
        if self._step - self._last_change <= self.cooldown:
            return Decision("hold", "cooldown", self._step, s.live)
        if self._straggler_streak >= self.sustain:
            if s.live > self.min_units:
                return Decision(
                    "evict",
                    f"straggler detected ({s.straggler:.3g} > "
                    f"{self.straggler_limit:.3g} for "
                    f"{self._straggler_streak} samples)",
                    self._step, s.live)
            return Decision("hold", "straggler but at min_units",
                            self._step, s.live)
        if self._up_streak >= self.sustain:
            if s.live < self.max_units:
                reason = (f"sustained load headroom ({s.load:.3g} >= "
                          f"{up_at:.3g} for {self._up_streak} samples)")
                pred = self._predict(s.live, s.live + 1)
                if pred is not None and not pred["pays_off"]:
                    return Decision(
                        "hold",
                        f"estimator veto: goodput({s.live + 1}) "
                        f"{pred['goodput_target']:.3g} adds under "
                        f"{self.hysteresis:.3g}x of an average "
                        f"worker's share at live {s.live} "
                        f"({pred['goodput_live']:.3g})",
                        self._step, s.live, predicted=pred)
                return Decision("admit", reason, self._step, s.live,
                                predicted=pred)
            return Decision("hold", "demand but at max_units",
                            self._step, s.live)
        if self._down_streak >= self.sustain:
            if s.live > self.min_units:
                return Decision(
                    "evict",
                    f"sustained idle ({s.load:.3g} <= {down_at:.3g} "
                    f"for {self._down_streak} samples)",
                    self._step, s.live,
                    predicted=self._predict(s.live, s.live - 1))
            return Decision("hold", "idle but at min_units",
                            self._step, s.live)
        return Decision("hold", "in-band", self._step, s.live)

    def _predict(self, live: int, target: int
                 ) -> Optional[Dict[str, float]]:
        """The estimator's view of ``live -> target`` (None without one,
        or when it fails: the policy keeps deciding without its
        advisor)."""
        if self.estimator is None:
            return None
        try:
            cur = float(self.estimator(live))
            tgt = float(self.estimator(target))
        except Exception as e:  # noqa: BLE001 — advisory, never fatal
            log.warning("autoscaler estimator failed (%s); deciding "
                        "without prediction", e)
            return None
        # the marginal unit must add `hysteresis` of an average live
        # unit's share (a per-unit margin: linear scaling always passes)
        per_unit = cur / max(1, live)
        return {"goodput_live": cur, "goodput_target": tgt,
                "target": target,
                "pays_off": ((tgt - cur) > self.hysteresis * per_unit
                             if target > live else tgt >= 0.0)}


def train_sample(snapshot: Dict[str, Any], live: int,
                 goodput_per_worker: float,
                 baseline_per_worker: float) -> Sample:
    """The TRAIN-domain :class:`Sample` from a ``metrics_snapshot()``
    dict plus the caller's goodput trend: ``load`` = per-worker goodput
    as a fraction of the clean per-worker baseline (≈1.0 means adding
    capacity still pays linearly); ``straggler`` = the spread of the
    per-NIC ``psworker.*.rounds_ahead`` gauges with the
    ``server.staleness`` p99 folded in — both zero on a healthy
    strict-sync tier."""
    m = snapshot.get("metrics", snapshot)
    gauges = m.get("gauges", {})
    ahead = [
        float(v["value"] if isinstance(v, dict) else v)
        for k, v in gauges.items()
        if k.startswith("psworker.") and k.endswith(".rounds_ahead")
    ]
    spread = (max(ahead) - min(ahead)) if len(ahead) > 1 else 0.0
    hist = m.get("histograms", {}).get("server.staleness", {})
    stale_p99 = float(hist.get("p99", 0.0) or 0.0)
    load = (goodput_per_worker / baseline_per_worker
            if baseline_per_worker > 0 else 0.0)
    return Sample(live=int(live), load=load,
                  straggler=max(spread, stale_p99))


def serve_sample(live: int, queue_depth: float,
                 ttft_p99_ms: float = 0.0,
                 ttft_slo_ms: Optional[float] = None) -> Sample:
    """The serve domain's :class:`Sample`: ``load`` is the queue depth a
    live replica, plus how far the recent TTFT overshoots the SLO when
    one is set (the router passes a windowed TTFT). ``straggler`` stays
    0: a silent replica is the lease sweep's business."""
    load = float(queue_depth) / max(1, int(live))
    if ttft_slo_ms and ttft_p99_ms:
        load += max(0.0, float(ttft_p99_ms) / float(ttft_slo_ms) - 1.0)
    return Sample(live=int(live), load=load, straggler=0.0)
