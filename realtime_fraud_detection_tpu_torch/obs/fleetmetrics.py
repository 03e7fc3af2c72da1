"""Fleet-level Prometheus exposition: ``FleetMetrics``.

Port of ``FleetMetrics`` from the JAX package's ``obs/fleetmetrics.py``,
behind the serving app's ``GET /metrics/fleet``. Per-worker counter totals
fold into one exposition: every series once per worker under a
``{worker=...}`` label plus an unlabeled fleet sum, exactly one ``# HELP`` /
``# TYPE`` pair per family. Two ways in share one accumulator:
``ingest_delta`` (a worker's delta event with a per-worker monotonic
``seq``; a stale or redelivered seq is dropped, so every count applies once)
and ``ingest_cumulative`` (an absolute snapshot, last one wins: the serving
process folds its own tracer counters in this way at render time). The
trace-stitching half of the JAX module (``FleetTraceStore``,
``merge_chrome_traces``) is not ported.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

__all__ = ["FleetMetrics"]


def _num(v: Any) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return 0.0


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare (honest counters)."""
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


class FleetMetrics:
    """Coordinator-side fold of per-worker counter snapshots.

    Two ingestion paths share one accumulator:

    - :meth:`ingest_delta` — the streaming path: a ``metrics`` event off
      ``cluster-events`` carrying ``{worker, seq, counters:{k: delta}}``.
      Events are deduped by per-worker ``seq`` (strictly increasing) so
      broker redelivery can never double-count.
    - :meth:`ingest_cumulative` — the snapshot path: an absolute counter
      dict (a worker's bye frame, or the serving process's own local
      counters folded in at render time). Replaces that worker's totals
      wholesale — last snapshot wins.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # worker -> {counter_key: cumulative total}
        self._workers: Dict[str, Dict[str, float]] = {}
        # worker -> last applied delta seq (streaming dedup watermark)
        self._seq: Dict[str, int] = {}
        # worker -> {label: value} identity stamps (pid, version, ...)
        self._info: Dict[str, Dict[str, str]] = {}
        self.events_applied = 0
        self.events_stale = 0

    # -------------------------------------------------------------- ingest
    def ingest_delta(self, event: Mapping[str, Any]) -> bool:
        """Apply one ``metrics`` fleet event; False = stale seq, dropped."""
        worker = str(event.get("worker", "") or "")
        if not worker:
            return False
        seq = int(event.get("seq", 0) or 0)
        counters = event.get("counters") or {}
        with self._lock:
            last = self._seq.get(worker, -1)
            if seq <= last:
                self.events_stale += 1
                return False
            self._seq[worker] = seq
            totals = self._workers.setdefault(worker, {})
            for k, v in counters.items():
                totals[str(k)] = totals.get(str(k), 0.0) + _num(v)
            self.events_applied += 1
        return True

    def ingest_cumulative(self, worker: str,
                          counters: Mapping[str, Any]) -> None:
        """Replace ``worker``'s totals with an absolute snapshot (bye
        frames; the coordinator's own in-process counters)."""
        worker = str(worker)
        with self._lock:
            self._workers[worker] = {
                str(k): _num(v) for k, v in counters.items()}

    def set_worker_info(self, worker: str, **labels: Any) -> None:
        """Identity stamps rendered on ``fleet_worker_info`` (pid,
        version, config digest, ...)."""
        with self._lock:
            row = self._info.setdefault(str(worker), {})
            for k, v in labels.items():
                row[str(k)] = str(v)

    def forget_worker(self, worker: str) -> None:
        with self._lock:
            self._workers.pop(str(worker), None)
            self._seq.pop(str(worker), None)
            self._info.pop(str(worker), None)

    # ------------------------------------------------------------- queries
    def worker_counters(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {w: dict(c) for w, c in self._workers.items()}

    def fleet_counters(self) -> Dict[str, float]:
        """Honest fleet sums: key -> sum over workers."""
        out: Dict[str, float] = {}
        with self._lock:
            for counters in self._workers.values():
                for k, v in counters.items():
                    out[k] = out.get(k, 0.0) + v
        return out

    def take_delta(self, key: str, _state: Dict[str, float] = None) -> float:
        """Fleet-sum delta for ``key`` since the previous call with the
        same ``_state`` dict (callers keep their own) — the autoscaler
        feeds these into ``observe()`` as arrivals."""
        state = _state if _state is not None else self._default_state
        total = self.fleet_counters().get(key, 0.0)
        prev = state.get(key, 0.0)
        state[key] = total
        return max(0.0, total - prev)

    @property
    def _default_state(self) -> Dict[str, float]:
        st = getattr(self, "_take_state", None)
        if st is None:
            st = self._take_state = {}
        return st

    # -------------------------------------------------------------- render
    def render(self, version: str = "", extra_info: Optional[
            Mapping[str, str]] = None) -> str:
        """One fleet Prometheus exposition. Families are rendered from a
        family-keyed dict, so exactly one ``# HELP``/``# TYPE`` pair per
        series name is structural, not incidental:

        - ``rtfd_worker_<key>{worker="w0"}`` — per-worker totals;
        - ``rtfd_fleet_<key>`` — the unlabeled fleet sum;
        - ``rtfd_build_info`` / ``fleet_worker_info`` — constant ``1``
          gauges carrying version + per-worker identity stamps.

        Counter keys that already end in ``_total`` keep the suffix once
        (never ``_total_total``); keys without it get ``_total`` appended
        so the counter naming convention holds fleet-wide.
        """
        with self._lock:
            workers = {w: dict(c) for w, c in sorted(self._workers.items())}
            info = {w: dict(r) for w, r in sorted(self._info.items())}

        def series_name(prefix: str, key: str) -> str:
            base = f"{prefix}_{key}"
            return base if key.endswith("_total") else f"{base}_total"

        # family name -> (help, type, [(labels_str, value)])
        fams: Dict[str, Tuple[str, str, List[Tuple[str, float]]]] = {}

        def add(name: str, help_text: str, mtype: str,
                labels: str, value: float) -> None:
            fam = fams.get(name)
            if fam is None:
                fam = fams[name] = (help_text, mtype, [])
            fam[2].append((labels, value))

        fleet: Dict[str, float] = {}
        for w, counters in workers.items():
            for k in sorted(counters):
                v = counters[k]
                fleet[k] = fleet.get(k, 0.0) + v
                add(series_name("rtfd_worker", k),
                    f"Per-worker cumulative {k}", "counter",
                    '{worker="%s"}' % _escape_label(w), v)
        for k in sorted(fleet):
            add(series_name("rtfd_fleet", k),
                f"Fleet-wide sum of {k} over all workers", "counter",
                "", fleet[k])

        build_labels = {"version": version or "unknown"}
        if extra_info:
            build_labels.update({str(k): str(v)
                                 for k, v in extra_info.items()})
        lbl = ",".join('%s="%s"' % (k, _escape_label(v))
                       for k, v in sorted(build_labels.items()))
        add("rtfd_build_info",
            "Build/version identity of the aggregating process", "gauge",
            "{%s}" % lbl, 1.0)
        for w, row in info.items():
            labels = {"worker": w}
            labels.update(row)
            lbl = ",".join('%s="%s"' % (k, _escape_label(v))
                           for k, v in sorted(labels.items()))
            add("fleet_worker_info",
                "Per-worker identity stamps (pid, version, config)",
                "gauge", "{%s}" % lbl, 1.0)

        lines: List[str] = []
        for name in sorted(fams):
            help_text, mtype, samples = fams[name]
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {mtype}")
            for labels, value in samples:
                lines.append(f"{name}{labels} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            workers = {w: dict(c) for w, c in self._workers.items()}
            seq = dict(self._seq)
            applied, stale = self.events_applied, self.events_stale
        fleet: Dict[str, float] = {}
        for counters in workers.values():
            for k, v in counters.items():
                fleet[k] = fleet.get(k, 0.0) + v
        return {
            "workers": workers,
            "fleet": fleet,
            "seq": seq,
            "events_applied": applied,
            "events_stale": stale,
        }
