"""Gradient-free online config tuning: hill-climb the host-pipeline knobs.

Port of the JAX package's ``tuning/tuner.py``; same decisions on the same inputs.

The pipeline's latency knobs (max-wait deadline bound, bucket set,
overlap/in-flight depth) were hand-set flags frozen at deploy time; this
tuner adjusts them online, tf.data-autotune style (arXiv:2101.12127): one
knob at a time, trial an adjacent value for one epoch, keep it only when
the measured admitted p99 improves past a hysteresis margin at
equal-or-better throughput, revert otherwise. Deterministic by
construction — the dimension rotation and step directions are fixed
round-robin state, never random draws, so a virtual-clock replay makes
identical moves.

Safety rails (the acceptance contract):

- the deadline search space is CLAMPED to ``[deadline_min_ms,
  deadline_max_ms]``, and ``TuningSettings.validate`` refuses a
  deadline_max_ms past the QoS budget's assembly slice — no tuner move
  can ever hold a batch beyond the deadline the QoS plane promised;
- while the QoS degradation ladder sits above rung 0 (or the SLO burn
  gate is engaged) the tuner FREEZES: an in-flight trial reverts
  immediately and no new trial starts — the ladder is shedding work to
  recover, and a knob experiment underneath it would fight the control
  loop that owns the emergency.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from realtime_fraud_detection_tpu_torch.tuning.controller import JitBatchController

__all__ = ["ConfigTuner"]

_DIMS = ("max_wait", "bucket_set", "inflight")


class ConfigTuner:
    """One-knob-at-a-time trial/revert hill climber with hysteresis."""

    MAX_WAIT_STEP = 1.4          # multiplicative deadline step
    EPOCH_LATENCY_CAP = 8192     # per-epoch latency sample bound

    def __init__(self, settings: Any, controller: JitBatchController):
        self.settings = settings
        self.controller = controller
        s = settings
        self.bucket_sets: List[tuple] = [tuple(bs) for bs in s.bucket_sets]
        self.bucket_set_idx = 0
        self.inflight_depth = max(2, s.inflight_min)
        self._clamp_and_apply()
        # epoch accumulators: exact served count (the throughput term)
        # plus a bounded, deterministically stride-decimated latency
        # sample covering the WHOLE epoch (the p99 term) — truncating to
        # the epoch's earliest traffic would bias both sides of the
        # accept/revert comparison under a ramping load
        self._batches = 0
        self._latencies: List[float] = []
        self._lat_count = 0
        self._lat_stride = 1
        self._lat_seen = 0
        self._epoch_start: Optional[float] = None
        # worst emergency signal seen ANYWHERE in the epoch (latched per
        # batch): a mid-epoch ladder excursion must freeze the epoch even
        # if the ladder recovered by the closing batch
        self._epoch_burn = 0.0
        self._epoch_ladder = 0
        # trial state machine
        self._baseline: Optional[Dict[str, float]] = None  # p99/tput
        self._trial: Optional[Dict[str, Any]] = None       # dim + saved value
        self._dim_i = 0
        self._dir: Dict[str, int] = {d: 1 for d in _DIMS}
        self._cooldown = 0
        self.frozen = False
        self.counters: Dict[str, int] = {
            "epochs": 0, "trials": 0, "accepted": 0, "reverted": 0,
            "frozen_epochs": 0,
        }

    # ---------------------------------------------------------- knob state
    def _clamp_and_apply(self) -> None:
        s = self.settings
        c = self.controller
        c.max_wait_ms = min(max(c.max_wait_ms, s.deadline_min_ms),
                            s.deadline_max_ms)
        c.buckets = self.bucket_sets[self.bucket_set_idx]
        self.inflight_depth = min(max(self.inflight_depth, s.inflight_min),
                                  s.inflight_max)

    def _get(self, dim: str):
        if dim == "max_wait":
            return self.controller.max_wait_ms
        if dim == "bucket_set":
            return self.bucket_set_idx
        return self.inflight_depth

    def _set(self, dim: str, value) -> None:
        if dim == "max_wait":
            self.controller.max_wait_ms = float(value)
        elif dim == "bucket_set":
            self.bucket_set_idx = int(value)
        else:
            self.inflight_depth = int(value)
        self._clamp_and_apply()

    def _propose(self, dim: str):
        """The adjacent value in the current direction; None when the
        dimension is pinned at its boundary in that direction."""
        s = self.settings
        d = self._dir[dim]
        if dim == "max_wait":
            cur = self.controller.max_wait_ms
            new = cur * (self.MAX_WAIT_STEP if d > 0
                         else 1.0 / self.MAX_WAIT_STEP)
            new = min(max(new, s.deadline_min_ms), s.deadline_max_ms)
            return None if abs(new - cur) < 1e-9 else new
        if dim == "bucket_set":
            if len(self.bucket_sets) < 2:
                return None
            return (self.bucket_set_idx + d) % len(self.bucket_sets)
        new = self.inflight_depth + d
        if not s.inflight_min <= new <= s.inflight_max:
            return None
        return new

    # ------------------------------------------------------- observations
    def observe_result(self, latency_ms: float, n: int = 1) -> None:
        """Admitted-transaction completion latencies (the objective).

        Every observation counts toward throughput; the latency SAMPLE
        keeps every ``_lat_stride``-th value and, at the cap, halves
        itself and doubles the stride — a deterministic uniform-ish
        sample over the whole epoch, never just its start."""
        self._lat_count += max(1, int(n))
        self._lat_seen += 1
        if self._lat_seen % self._lat_stride:
            return
        self._latencies.append(float(latency_ms))
        if len(self._latencies) >= self.EPOCH_LATENCY_CAP:
            self._latencies = self._latencies[::2]
            self._lat_stride *= 2

    def on_batch(self, now: float, burn_rate: float = 0.0,
                 ladder_level: int = 0) -> None:
        """One completed batch; closes an epoch every
        ``tune_interval_batches`` and runs the trial state machine. The
        emergency signals are latched per batch — and an in-flight trial
        reverts IMMEDIATELY when one fires, not at epoch close: a knob
        experiment must never keep running under a degraded ladder."""
        if self._epoch_start is None:
            self._epoch_start = now
        self._epoch_burn = max(self._epoch_burn, burn_rate)
        self._epoch_ladder = max(self._epoch_ladder, int(ladder_level))
        if (ladder_level > 0 or burn_rate > 1.0) \
                and self._trial is not None:
            self._set(self._trial["dim"], self._trial["saved"])
            self.counters["reverted"] += 1
            self._trial = None
            self.frozen = True
        self._batches += 1
        if self._batches < self.settings.tune_interval_batches:
            return
        self._close_epoch(now, self._epoch_burn, self._epoch_ladder)

    # ------------------------------------------------------ epoch machine
    def _objective(self, now: float) -> Optional[Dict[str, float]]:
        if not self._latencies:
            return None
        from realtime_fraud_detection_tpu_torch.obs.profiling import (
            interpolated_percentile,
        )

        lat = sorted(self._latencies)
        dur = max(1e-9, now - (self._epoch_start or now))
        return {"p99_ms": interpolated_percentile(lat, 0.99),
                "tput": self._lat_count / dur}

    def _reset_epoch(self, now: float) -> None:
        self._batches = 0
        self._latencies = []
        self._lat_count = 0
        self._lat_stride = 1
        self._lat_seen = 0
        self._epoch_start = now
        self._epoch_burn = 0.0
        self._epoch_ladder = 0

    def _close_epoch(self, now: float, burn_rate: float,
                     ladder_level: int) -> None:
        self.counters["epochs"] += 1
        obj = self._objective(now)
        frozen = ladder_level > 0 or burn_rate > 1.0
        if frozen:
            # the QoS ladder (or SLO burn) owns the emergency: revert any
            # trial to its saved value and stand down
            self.counters["frozen_epochs"] += 1
            if self._trial is not None:
                self._set(self._trial["dim"], self._trial["saved"])
                self.counters["reverted"] += 1
                self._trial = None
            self.frozen = True
            self._baseline = None       # post-emergency load is new load
            self._reset_epoch(now)
            return
        self.frozen = False
        if obj is None:
            self._reset_epoch(now)
            return
        h = self.settings.hysteresis_frac
        if self._trial is not None:
            base = self._trial["baseline"]
            better = (obj["p99_ms"] < base["p99_ms"] * (1.0 - h)
                      and obj["tput"] >= base["tput"] * (1.0 - h))
            if better:
                self.counters["accepted"] += 1
                self._baseline = obj    # the trial config is the new base
            else:
                dim = self._trial["dim"]
                self._set(dim, self._trial["saved"])
                self._dir[dim] = -self._dir[dim]   # try the other way next
                self.counters["reverted"] += 1
                self._baseline = None   # re-measure under the restored knob
            self._trial = None
            self._cooldown = self.settings.tuner_cooldown_epochs
            self._reset_epoch(now)
            return
        if self._baseline is None:
            self._baseline = obj        # fresh baseline epoch
            self._reset_epoch(now)
            return
        # rolling baseline: the most recent non-trial epoch represents
        # current load better than a stale measurement ever could
        self._baseline = obj
        if self._cooldown > 0:
            self._cooldown -= 1
            self._reset_epoch(now)
            return
        # propose the next move, round-robin over dimensions
        for _ in range(len(_DIMS)):
            dim = _DIMS[self._dim_i]
            self._dim_i = (self._dim_i + 1) % len(_DIMS)
            new = self._propose(dim)
            if new is None:
                self._dir[dim] = -self._dir[dim]
                continue
            self._trial = {"dim": dim, "saved": self._get(dim),
                           "baseline": self._baseline}
            self._set(dim, new)
            self.counters["trials"] += 1
            break
        self._reset_epoch(now)

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, Any]:
        return {
            "max_wait_ms": round(self.controller.max_wait_ms, 4),
            "bucket_set_idx": self.bucket_set_idx,
            "bucket_set": list(self.bucket_sets[self.bucket_set_idx]),
            "inflight_depth": self.inflight_depth,
            "frozen": self.frozen,
            "in_trial": self._trial is not None,
            "trial_dim": (self._trial or {}).get("dim"),
            "counters": dict(self.counters),
        }
