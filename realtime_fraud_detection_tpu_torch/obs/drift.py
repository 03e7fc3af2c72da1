"""Feature-distribution drift over the (B, 64) feature stream.

Port of the JAX package's ``obs/drift.py`` (numpy only), vectorised over
whole microbatches:

- warm-up: per-feature baseline by Welford mean / variance, then fixed PSI
  bin edges at the baseline mean +- {0.5, 1, 2} sigma, the warm-up rows
  binned as the baseline mass;
- steady state: windowed per-bin counts (halved when twice the window);
  each feature's score is the Population Stability Index between the
  window's and the baseline's bin masses;
- report: per-feature PSI, the features above the threshold worst first,
  and the overall flag (PSI < 0.1 stable, > 0.25 shifted).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = ["DriftConfig", "DriftReport", "FeatureDriftMonitor"]

_EPS = 1e-6


@dataclasses.dataclass
class DriftConfig:
    num_features: int = 64
    warmup_rows: int = 2_000       # rows before the baseline freezes
    window_rows: int = 2_000       # rolling comparison window
    threshold: float = 0.25        # PSI alarm level (config.py:110-116 analog)
    min_report_rows: int = 200     # window rows required before alarming
                                   # (a near-empty window is ~one-hot per
                                   # feature and would always false-alarm)


@dataclasses.dataclass
class DriftReport:
    drifted: bool
    max_psi: float
    psi: np.ndarray                      # f32[F]
    top_features: List[int]              # worst-first indices above threshold
    rows_seen: int
    baseline_frozen: bool


class FeatureDriftMonitor:
    """Streaming PSI drift monitor; feed every scored feature batch."""

    def __init__(self, config: Optional[DriftConfig] = None):
        self.config = config or DriftConfig()
        f = self.config.num_features
        # Welford accumulators for the baseline
        self._n = 0
        self._mean = np.zeros((f,), np.float64)
        self._m2 = np.zeros((f,), np.float64)
        self._edges: Optional[np.ndarray] = None      # f64[F, 7] bin edges
        self._base_mass: Optional[np.ndarray] = None  # f64[F, 8]
        self._base_counts = np.zeros((f, 8), np.float64)
        self._warmup_buf: List[np.ndarray] = []       # rows kept to self-seed
        # ring buffer of windowed per-bin counts
        self._win_counts = np.zeros((f, 8), np.float64)
        self._win_rows = 0
        self.rows_seen = 0

    @property
    def baseline_frozen(self) -> bool:
        return self._edges is not None

    # ---------------------------------------------------------------- update
    def update(self, features: np.ndarray) -> None:
        """Ingest one (B, F) batch of extracted features."""
        x = np.asarray(features, np.float64)
        if x.ndim != 2 or x.shape[1] != self.config.num_features:
            raise ValueError(f"expected (B, {self.config.num_features}), "
                             f"got {x.shape}")
        self.rows_seen += x.shape[0]
        if not self.baseline_frozen:
            self._update_baseline(x)
            self._warmup_buf.append(x)
            if self._n >= self.config.warmup_rows:
                self._freeze()
                # the warmup sample IS the baseline distribution — binning it
                # (rather than assuming Gaussian masses) keeps near-constant
                # and skewed features from false-alarming
                self._base_counts += self._bin_counts(
                    np.concatenate(self._warmup_buf, axis=0))
                self._warmup_buf.clear()
            return
        counts = self._bin_counts(x)
        self._win_counts += counts
        self._win_rows += x.shape[0]
        # decay instead of a true ring buffer: halve when 2x over the window
        # (cheap, keeps recency without storing per-row history)
        if self._win_rows >= 2 * self.config.window_rows:
            self._win_counts *= 0.5
            self._win_rows //= 2

    def _update_baseline(self, x: np.ndarray) -> None:
        # Chan's parallel Welford merge: fold the whole batch in O(1) numpy
        # calls instead of a per-row Python loop (this runs on the scoring
        # hot path during warmup)
        m = x.shape[0]
        batch_mean = x.mean(axis=0)
        batch_m2 = ((x - batch_mean) ** 2).sum(axis=0)
        n = self._n
        delta = batch_mean - self._mean
        total = n + m
        self._mean += delta * (m / total)
        self._m2 += batch_m2 + delta ** 2 * (n * m / total)
        self._n = total

    def _freeze(self) -> None:
        std = np.sqrt(self._m2 / max(self._n - 1, 1))
        std = np.where(std < _EPS, 1.0, std)
        offsets = np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0])
        self._edges = self._mean[:, None] + std[:, None] * offsets[None, :]

    def seed_baseline_counts(self, features: np.ndarray) -> None:
        """Re-bin warmup data as the baseline mass (call after freeze, or
        let steady-state updates lazily approximate it)."""
        if not self.baseline_frozen:
            raise RuntimeError("baseline not frozen yet")
        self._base_counts += self._bin_counts(np.asarray(features, np.float64))
        self._base_mass = None

    def _bin_counts(self, x: np.ndarray) -> np.ndarray:
        assert self._edges is not None
        f = x.shape[1]
        # searchsorted per feature: bin index in [0, 7]
        idx = np.empty(x.shape, np.intp)
        for j in range(f):
            idx[:, j] = np.searchsorted(self._edges[j], x[:, j])
        counts = np.zeros((f, 8), np.float64)
        for j in range(f):
            counts[j] = np.bincount(idx[:, j], minlength=8)
        return counts

    # ---------------------------------------------------------------- report
    def report(self) -> DriftReport:
        f = self.config.num_features
        if not self.baseline_frozen or self._win_rows < max(
                self.config.min_report_rows, 1):
            return DriftReport(False, 0.0, np.zeros((f,), np.float32), [],
                               self.rows_seen, self.baseline_frozen)
        if self._base_mass is None:
            base = self._base_counts
            self._base_mass = (base + _EPS) / (base + _EPS).sum(
                axis=1, keepdims=True)
        cur = (self._win_counts + _EPS) / (self._win_counts + _EPS).sum(
            axis=1, keepdims=True)
        psi = np.sum((cur - self._base_mass)
                     * np.log(cur / self._base_mass), axis=1)
        psi32 = psi.astype(np.float32)
        above = np.where(psi > self.config.threshold)[0]
        top = sorted(above.tolist(), key=lambda j: -psi[j])
        return DriftReport(
            drifted=bool(len(top) > 0),
            max_psi=float(psi.max()),
            psi=psi32,
            top_features=top,
            rows_seen=self.rows_seen,
            baseline_frozen=True,
        )
