"""Elastic autoscale: the arrival forecast drives the worker count.

Port of the JAX package's ``cluster/autoscale.py``. The tuning plane's
:class:`~realtime_fraud_detection_tpu_torch.tuning.forecast.
ArrivalForecaster` already estimates the offered rate AND its trend
from admission timestamps — exactly the signal an autoscaler needs to act
*before* a diurnal peak instead of after the backlog does (arXiv:2109.09541
scales its serving fleet horizontally on the same logic: identical workers,
deterministic routing, capacity follows load). This controller closes that
loop for the process fleet (cluster/procfleet.py):

- **lead horizon**: the target is computed from the rate forecast
  ``lead_s`` seconds AHEAD (Holt level + trend extrapolation), so on a
  rising ramp the fleet grows while the backlog is still zero — worker
  spawn latency (a real OS process: interpreter + import + restore) is
  paid inside the forecast lead, not inside the latency budget;
- **asymmetric hysteresis**: scale-up applies immediately (under-capacity
  burns the latency budget now), scale-down waits ``down_patience``
  consecutive decisions below the current target (a burst trough must not
  thrash the fleet through drain/restore cycles);
- **deterministic decision ledger**: decisions are evaluated only at
  fixed ``decide_interval_s`` boundaries of the OBSERVATION clock (the
  drill's event timeline, wall time in production), so the ledger is a
  pure function of the arrival schedule — the elastic drill replays it
  bit-identically and includes it in the verdict digest while wall-clock
  execution timings stay excluded.

Movement stays cheap because placement is the consistent-hash ring
(cluster/hashring.py): a one-worker membership change moves ~K/N of K
partitions, each rebalance a bounded restore + committed-gap replay.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from realtime_fraud_detection_tpu_torch.tuning.forecast import ArrivalForecaster

__all__ = ["AutoscaleController"]


class AutoscaleController:
    """Forecast-driven target worker count with a deterministic ledger."""

    def __init__(self, per_worker_tps: float, min_workers: int = 1,
                 max_workers: int = 8, headroom: float = 1.25,
                 lead_s: float = 2.0, decide_interval_s: float = 0.5,
                 down_patience: int = 3,
                 forecaster: Optional[ArrivalForecaster] = None):
        if per_worker_tps <= 0:
            raise ValueError(
                f"per_worker_tps must be > 0, got {per_worker_tps}")
        if not 1 <= min_workers <= max_workers:
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"{min_workers}..{max_workers}")
        if headroom < 1.0 or lead_s < 0 or decide_interval_s <= 0 \
                or down_patience < 1:
            raise ValueError(
                "autoscale requires headroom >= 1, lead_s >= 0, "
                "decide_interval_s > 0, down_patience >= 1")
        self.per_worker_tps = float(per_worker_tps)
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.headroom = float(headroom)
        self.lead_s = float(lead_s)
        self.decide_interval_s = float(decide_interval_s)
        self.down_patience = int(down_patience)
        self.forecaster = forecaster or ArrivalForecaster(bucket_s=0.25)
        self.target = self.min_workers
        self.events: Dict[str, int] = {"up": 0, "down": 0}
        self.decisions: List[Dict[str, Any]] = []   # changes only
        self._next_decide: Optional[float] = None
        self._below_streak = 0
        self._last_rate = 0.0

    # -------------------------------------------------------------- forecast
    def lead_rate(self, now: float) -> float:
        """Offered-rate forecast ``lead_s`` ahead of ``now``: the Holt
        one-step rate extrapolated along its trend — the rising-ramp lead
        that lets the fleet grow before the peak arrives. Floored at the
        current rate so a noisy negative trend never under-provisions an
        already-observed load."""
        f = self.forecaster
        rate = f.rate(now)
        trend_per_s = f.trend / f.bucket_s
        return max(rate, rate + trend_per_s * self.lead_s)

    def _target_for(self, lead_rate: float) -> int:
        raw = math.ceil(lead_rate * self.headroom / self.per_worker_tps)
        return max(self.min_workers, min(self.max_workers, raw))

    # --------------------------------------------------------------- observe
    def observe(self, now: float, n: int = 1) -> Optional[Dict[str, Any]]:
        """Feed ``n`` arrivals at observation-clock ``now``; returns the
        ledger entry when a boundary decision CHANGED the target, else
        None.

        Decisions fire only at ``decide_interval_s`` boundaries, and a
        boundary ``B`` is decided BEFORE an arrival at ``t > B`` is fed —
        so as long as the caller's ``now`` values are non-decreasing
        (arrivals in schedule order, idle polls in between), the ledger
        is a pure function of the arrival schedule: independent of call
        chunking, wall pacing, and poll frequency. That is what lets the
        elastic drill put the ledger inside its replay digest.
        """
        if self._next_decide is None:
            self._next_decide = (math.floor(now / self.decide_interval_s)
                                 + 1) * self.decide_interval_s
        changed = None
        while now >= self._next_decide:
            changed = self._decide(self._next_decide) or changed
            self._next_decide += self.decide_interval_s
        if n > 0:
            self.forecaster.observe(now, n)
        return changed

    def _decide(self, t: float) -> Optional[Dict[str, Any]]:
        lead = self.lead_rate(t)
        self._last_rate = self.forecaster.rate(t)
        want = self._target_for(lead)
        if want > self.target:
            entry = {"t": round(t, 6), "rate": round(self._last_rate, 3),
                     "lead_rate": round(lead, 3), "target": want,
                     "from": self.target, "direction": "up"}
            self.target = want
            self._below_streak = 0
            self.events["up"] += 1
            self.decisions.append(entry)
            return entry
        if want < self.target:
            self._below_streak += 1
            if self._below_streak >= self.down_patience:
                entry = {"t": round(t, 6),
                         "rate": round(self._last_rate, 3),
                         "lead_rate": round(lead, 3), "target": want,
                         "from": self.target, "direction": "down"}
                self.target = want
                self._below_streak = 0
                self.events["down"] += 1
                self.decisions.append(entry)
                return entry
        else:
            self._below_streak = 0
        return None

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able state shaped for
        ``obs.metrics.MetricsCollector.sync_autoscale``."""
        return {
            "target_workers": self.target,
            "forecast_rate": round(self._last_rate, 3),
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "per_worker_tps": self.per_worker_tps,
            "events": dict(self.events),
            "decisions": list(self.decisions),
        }
