"""Bounded exponential backoff with deterministic jitter, behind a seam.

Port of the JAX package's ``utils/backoff.py``. ``DeterministicBackoff``
paces the broker client's reconnect loop:

- **bounded exponential**: ``base_s * mult**attempt`` capped at ``max_s``
  — a broker that stays down costs bounded per-attempt waits, never an
  unbounded doubling;
- **deterministic jitter**: the jitter fraction for attempt *k* is drawn
  from ``crc32(f"{seed}:{k}")`` — stable across processes and replays
  (``hash()`` is salted per process), so two seeded runs wait identical
  schedules while two clients with different seeds still de-synchronize
  their retry storms (the point of jitter);
- **injected sleep seam**: tests pass a recording or virtual-clock
  ``sleep`` so retry behaviour is assertable without wall time. Production
  callers default to ``time.sleep``.
"""

from __future__ import annotations

import itertools
import os
import time
import zlib
from collections import deque
from typing import Callable, Optional

__all__ = ["DeterministicBackoff", "instance_seed"]

_INSTANCE_COUNTER = itertools.count()


def instance_seed(tag: str) -> int:
    """Backoff seed for one retrying INSTANCE: mixes the caller's tag with
    the process id and a per-process construction counter. The peers that
    must de-correlate their retry storms are exactly the ones that share a
    tag (every member of one consumer group, every client of one broker
    port) — a tag-only seed would hand the whole herd one identical
    schedule. Per-instance seeds keep them apart, while a seeded drill
    still constructs its instances in a deterministic order (and nothing
    in a drill's replay digest reads wall-clock retry delays)."""
    return zlib.crc32(
        f"{tag}:{os.getpid()}:{next(_INSTANCE_COUNTER)}".encode())


class DeterministicBackoff:
    """Retry-delay policy: ``delay(k)`` is pure, ``sleep(k)`` applies it."""

    def __init__(self, base_s: float = 0.05, mult: float = 2.0,
                 max_s: float = 1.0, jitter_frac: float = 0.25,
                 seed: int = 0,
                 sleep: Optional[Callable[[float], None]] = None):
        if base_s <= 0 or mult < 1.0 or max_s < base_s:
            raise ValueError(
                f"backoff requires base_s > 0, mult >= 1 and max_s >= "
                f"base_s, got base={base_s} mult={mult} max={max_s}")
        if not 0.0 <= jitter_frac <= 1.0:
            raise ValueError(
                f"jitter_frac must be in [0, 1], got {jitter_frac}")
        self.base_s = float(base_s)
        self.mult = float(mult)
        self.max_s = float(max_s)
        self.jitter_frac = float(jitter_frac)
        self.seed = int(seed)
        self._sleep = sleep if sleep is not None else time.sleep
        # applied delays (test/chaos ledger) — bounded: the instance lives
        # inside long-lived transports, and a flapping broker must not
        # grow an unbounded list for the process lifetime
        self.slept: deque = deque(maxlen=64)

    def delay(self, attempt: int) -> float:
        """Delay for the ``attempt``-th retry (0-based). Pure function of
        (config, seed, attempt) — replays bit-identically."""
        raw = min(self.max_s, self.base_s * self.mult ** max(0, int(attempt)))
        if self.jitter_frac <= 0.0:
            return raw
        # deterministic per-(seed, attempt) fraction in [0, 1): crc32 is
        # stable across processes, unlike salted str.__hash__
        frac = (zlib.crc32(f"{self.seed}:{int(attempt)}".encode())
                % 10_000) / 10_000.0
        # jitter shrinks the delay (decorrelates retry storms without ever
        # exceeding the bounded schedule)
        return raw * (1.0 - self.jitter_frac * frac)

    def sleep(self, attempt: int) -> float:
        """Apply the delay for ``attempt`` through the injected seam.
        Returns the delay actually requested (the test/chaos ledger gets a
        copy in ``slept``)."""
        d = self.delay(attempt)
        self.slept.append(d)
        self._sleep(d)
        return d
