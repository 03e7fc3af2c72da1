"""Frozen copy for the benchmark: ``realtime_fraud_detection_tpu_torch/sim/arrivals.py`` as of the commit that added
``perfbench/``. Later changes to the program's simulator do not move
the yardstick; change this copy only in a PR that redefines the
benchmark.

Nonstationary offered-load generator: diurnal ramp + Poisson bursts.

Port of the JAX package's ``sim/arrivals.py`` (numpy only): the same seed
gives the same timestamps, bit for bit.

The reference simulator paces a single flat TPS with ``sleep(1/tps)``
(simulator.py:437-449); real payment traffic is nothing like that — it
ramps through a diurnal cycle and spikes in bursts (flash sales, batch
retries, regional wakeups). This module generates explicit arrival
TIMESTAMPS for such a process, as a first-class simulator feature:

- the base rate follows a raised-cosine diurnal ramp between
  ``trough_tps`` and ``peak_tps`` over ``period_s`` (a drill compresses a
  day into virtual seconds by shrinking the period);
- bursts arrive on a deterministic schedule (``burst_every_s`` apart,
  starting at ``burst_offset_s``), each multiplying the instantaneous
  rate by ``burst_mult`` for ``burst_duration_s``;
- arrivals are drawn from the resulting nonhomogeneous Poisson process by
  Lewis thinning — fully seedable, so the same seed reproduces the same
  timeline bit-for-bit;
- timestamps are plain floats from ``t0`` on whatever clock base the
  caller uses (the drills' virtual clock, or wall time), so the process
  is virtual-clock compatible by construction.

Consumed by the ``autotune-drill`` command (tuning/drill.py) and by the
tuning phase of ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["DiurnalBurstProcess", "DiurnalBurstConfig"]


@dataclasses.dataclass
class DiurnalBurstConfig:
    """Shape of the offered load. Rates are instantaneous txn/s."""

    trough_tps: float = 200.0
    peak_tps: float = 2_000.0
    period_s: float = 10.0          # one full diurnal cycle
    # burst schedule: deterministic spacing so drills can pin which
    # phases contain bursts; each burst multiplies the diurnal rate
    burst_every_s: float = 2.5
    burst_offset_s: float = 1.25
    burst_duration_s: float = 0.25
    burst_mult: float = 4.0
    t0: float = 0.0

    def validate(self) -> None:
        if not (0.0 < self.trough_tps <= self.peak_tps):
            raise ValueError(
                f"arrivals require 0 < trough_tps <= peak_tps, got "
                f"trough={self.trough_tps} peak={self.peak_tps}")
        if self.period_s <= 0 or self.burst_duration_s < 0 \
                or self.burst_mult < 1.0:
            raise ValueError(
                "arrivals require period_s > 0, burst_duration_s >= 0 "
                "and burst_mult >= 1")
        if self.burst_every_s <= 0:
            raise ValueError("arrivals require burst_every_s > 0")


class DiurnalBurstProcess:
    """Seedable nonhomogeneous Poisson arrival-time generator."""

    def __init__(self, config: DiurnalBurstConfig | None = None,
                 seed: int = 7):
        self.config = config or DiurnalBurstConfig()
        self.config.validate()
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------- intensity
    def _rates(self, t: np.ndarray) -> np.ndarray:
        """Vectorized deterministic intensity at each time in ``t`` —
        independent of the rng, so tests can pin the envelope exactly."""
        c = self.config
        rel = np.asarray(t, float) - c.t0
        # raised cosine: trough at phase 0, peak at phase 0.5
        phase = np.mod(rel, c.period_s) / c.period_s
        rates = (c.trough_tps
                 + (c.peak_tps - c.trough_tps)
                 * 0.5 * (1.0 - np.cos(2.0 * math.pi * phase)))
        if c.burst_duration_s > 0:
            in_cycle = np.mod(rel - c.burst_offset_s, c.burst_every_s)
            rates = np.where((rel >= c.burst_offset_s)
                             & (in_cycle < c.burst_duration_s),
                             rates * c.burst_mult, rates)
        return np.where(rel < 0, 0.0, rates)

    def rate_at(self, t: float) -> float:
        """Scalar convenience over :meth:`_rates`."""
        return float(self._rates(np.asarray([t]))[0])

    def peak_rate(self) -> float:
        return self.config.peak_tps * max(1.0, self.config.burst_mult)

    # ------------------------------------------------------------- sampling
    def generate(self, duration_s: float) -> np.ndarray:
        """Arrival timestamps in ``[t0, t0 + duration_s)`` by Lewis
        thinning: homogeneous candidates at the peak rate, kept with
        probability rate(t)/peak. Sorted, float64, deterministic per
        seed."""
        c = self.config
        lam_max = self.peak_rate()
        n_cand = self.rng.poisson(lam_max * duration_s)
        cand = np.sort(self.rng.uniform(0.0, duration_s, n_cand)) + c.t0
        if n_cand == 0:
            return cand
        keep = self.rng.uniform(0.0, lam_max, n_cand) < self._rates(cand)
        return cand[keep]

    def paired_with(self, generator: Any,
                    duration_s: float) -> List[Tuple[float, Dict]]:
        """(arrival_ts, transaction) pairs: the offered-load timeline
        joined to a ``TransactionGenerator``'s record stream — what a
        drill's drive loop feeds the broker."""
        times = self.generate(duration_s)
        txns = generator.generate_batch(len(times))
        return list(zip(times.tolist(), txns))

    def summary(self, times: Sequence[float]) -> Dict[str, Any]:
        """Compact stats over a generated timeline (drill reporting)."""
        times = np.asarray(times, float)
        if times.size == 0:
            return {"n": 0}
        gaps = np.diff(times) if times.size > 1 else np.array([0.0])
        return {
            "n": int(times.size),
            "span_s": round(float(times[-1] - times[0]), 4),
            "mean_tps": round(
                float(times.size / max(times[-1] - times[0], 1e-9)), 1),
            "min_gap_us": round(float(gaps.min()) * 1e6, 2),
            "p99_gap_ms": round(
                float(np.percentile(gaps, 99)) * 1e3, 4),
        }
