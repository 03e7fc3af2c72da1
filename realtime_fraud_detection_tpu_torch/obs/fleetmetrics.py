"""Fleet-level Prometheus exposition: ``FleetMetrics``.

Port of ``FleetMetrics`` from the JAX package's ``obs/fleetmetrics.py``,
behind the serving app's ``GET /metrics/fleet``. Per-worker counter totals
fold into one exposition: every series once per worker under a
``{worker=...}`` label plus an unlabeled fleet sum, exactly one ``# HELP`` /
``# TYPE`` pair per family. Two ways in share one accumulator:
``ingest_delta`` (a worker's delta event with a per-worker monotonic
``seq``; a stale or redelivered seq is dropped, so every count applies once)
and ``ingest_cumulative`` (an absolute snapshot, last one wins: the serving
process folds its own tracer counters in this way at render time). 
``FleetTraceStore`` is the coordinator's flight recorder over stitched
traces: ``cluster/procfleet.py ProcessFleet`` folds each worker's ring dump
(shipped in its bye frame) into it, for the fleet critical path and one
merged Chrome trace. ``merge_chrome_traces`` (behind ``trace-export
--merge``) folds ring dumps written to disk the same way.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from realtime_fraud_detection_tpu_torch.obs.tracing import TRACE_STAGES

__all__ = ["FleetMetrics", "FleetTraceStore", "merge_chrome_traces"]


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


# ---------------------------------------------------------------------------
# cross-process trace stitching
# ---------------------------------------------------------------------------

class FleetTraceStore:
    """Coordinator-side flight recorder over STITCHED traces.

    Ingests workers' ring dumps (``CompletedTrace.to_dict`` rows, wall-
    clock ``t_start`` base) tagged with the consuming worker id. A trace
    whose ``origin`` differs from its consuming worker crossed a process
    boundary — the stitching signal the obs-drill pins.
    """

    def __init__(self, ring_size: int = 16384, slowest_n: int = 32):
        self._lock = threading.Lock()
        self._ring_size = max(16, int(ring_size))
        self._rows: List[Dict[str, Any]] = []
        self._pids: Dict[str, int] = {}
        self._slowest_n = max(1, int(slowest_n))

    # -------------------------------------------------------------- ingest
    def ingest(self, worker: str, traces: Sequence[Mapping[str, Any]],
               pid: int = 0) -> int:
        """Fold one worker's ring dump in; rows are kept verbatim plus a
        ``worker`` tag. Returns rows accepted."""
        worker = str(worker)
        rows = []
        for t in traces:
            if not isinstance(t, Mapping) or "trace_id" not in t:
                continue
            row = dict(t)
            row["worker"] = worker
            rows.append(row)
        with self._lock:
            if pid:
                self._pids[worker] = int(pid)
            self._rows.extend(rows)
            if len(self._rows) > self._ring_size:
                self._rows = self._rows[-self._ring_size:]
        return len(rows)

    def rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._rows)

    # ------------------------------------------------------------ analysis
    def stitch_stats(self) -> Dict[str, Any]:
        """How well did the carrier plane stitch: of all ingested traces,
        how many crossed a process boundary (carrier adopted from another
        origin), how many carry a remote graph-fetch child span, and the
        broker-transit distribution. ``fresh_roots`` are traces minted
        locally (no origin) — carrier loss and un-stamped producers land
        here."""
        from realtime_fraud_detection_tpu_torch.obs.profiling import (
            interpolated_percentile,
        )

        rows = self.rows()
        crossed = with_remote = fresh = 0
        transit: List[float] = []
        for r in rows:
            origin = str(r.get("origin", "") or "")
            worker = str(r.get("worker", "") or "")
            if origin and origin != worker:
                crossed += 1
            elif not origin:
                fresh += 1
            bt = _num((r.get("stages") or {}).get("broker_transit", 0.0))
            if bt > 0.0:
                transit.append(bt)
            spans = (r.get("meta") or {}).get("spans") or []
            if any(s.get("name") == "remote_fetch" for s in spans
                   if isinstance(s, Mapping)):
                with_remote += 1
        out: Dict[str, Any] = {
            "total": len(rows),
            "crossed_process": crossed,
            "with_remote_span": with_remote,
            "fresh_roots": fresh,
            "stitch_rate": round(crossed / len(rows), 4) if rows else 0.0,
        }
        if transit:
            st = sorted(transit)
            out["broker_transit_ms"] = {
                "p50": round(interpolated_percentile(st, 0.50), 4),
                "p99": round(interpolated_percentile(st, 0.99), 4),
                "max": round(st[-1], 4),
                "n": len(st),
            }
        return out

    def breakdown(self) -> Dict[str, Any]:
        """Fleet critical path: the Tracer.breakdown contract (additive
        per-stage contributions over the tail at each quantile, dominant
        stage flagged) computed over ALL workers' scored traces, plus
        per-worker dominant stages and the dominant WORKER of each tail
        (the worker contributing the most summed e2e among tail traces —
        the slow-worker attribution the obs-drill pins)."""
        from realtime_fraud_detection_tpu_torch.obs.profiling import (
            interpolated_percentile,
        )

        rows = [r for r in self.rows() if r.get("terminal") == "scored"]
        if not rows:
            return {"n": 0, "quantiles": {}, "per_worker": {},
                    "exemplars": []}
        e2e = sorted(_num(r.get("e2e_ms")) for r in rows)
        quantiles: Dict[str, Any] = {}
        for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            thresh = interpolated_percentile(e2e, q)
            tail = [r for r in rows if _num(r.get("e2e_ms")) >= thresh] \
                or rows[-1:]
            contrib: Dict[str, float] = {}
            by_worker: Dict[str, float] = {}
            for r in tail:
                for stage, ms in (r.get("stages") or {}).items():
                    contrib[stage] = contrib.get(stage, 0.0) + _num(ms)
                w = str(r.get("worker", "") or "?")
                by_worker[w] = by_worker.get(w, 0.0) + _num(r.get("e2e_ms"))
            n = len(tail)
            contrib = {s: round(v / n, 4) for s, v in contrib.items()}
            dominant = max(contrib, key=contrib.get)
            dom_worker = max(by_worker, key=by_worker.get)
            quantiles[name] = {
                "e2e_ms": round(thresh, 4),
                "tail_n": n,
                "stage_ms": contrib,
                "dominant_stage": dominant,
                "dominant_frac": round(
                    contrib[dominant] / max(sum(contrib.values()), 1e-9), 4),
                "dominant_worker": dom_worker,
                "worker_e2e_share": {
                    w: round(v / max(sum(by_worker.values()), 1e-9), 4)
                    for w, v in sorted(by_worker.items())},
            }
        per_worker: Dict[str, Any] = {}
        for w in sorted({str(r.get("worker", "") or "?") for r in rows}):
            wrows = [r for r in rows if str(r.get("worker", "") or "?") == w]
            sums: Dict[str, float] = {}
            for r in wrows:
                for stage, ms in (r.get("stages") or {}).items():
                    sums[stage] = sums.get(stage, 0.0) + _num(ms)
            dom = max(sums, key=sums.get) if sums else None
            per_worker[w] = {
                "n": len(wrows),
                "dominant_stage": dom,
                "mean_e2e_ms": round(
                    sum(_num(r.get("e2e_ms")) for r in wrows) / len(wrows),
                    4),
            }
        slowest = sorted(rows, key=lambda r: _num(r.get("e2e_ms")),
                         reverse=True)[: self._slowest_n]
        return {
            "n": len(rows),
            "quantiles": quantiles,
            "per_worker": per_worker,
            "stitch": self.stitch_stats(),
            # slowest-N exemplars verbatim — the whole row, not a summary
            "exemplars": slowest,
        }

    # -------------------------------------------------------------- export
    def export_chrome_trace(self) -> Dict[str, Any]:
        """One merged Chrome/Perfetto trace for the whole fleet: a named
        process track per worker (``worker <id> (pid N)``) plus one
        ``ingress`` track per producing origin; a stitched trace's
        ``ingest`` + ``broker_transit`` slices draw on its ORIGIN track
        and the remaining stages on the consuming worker's track, joined
        by a flow arrow (``ph:"s"``/``ph:"f"``) across the broker hop —
        the cross-process handoff is a visible edge, not an inference.
        Requires the workers' tracers to share one wall-clock base."""
        rows = sorted(self.rows(), key=lambda r: _num(r.get("t_start")))
        with self._lock:
            pids = dict(self._pids)
        # stable integer pid per track: workers first, then origins
        track_pid: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []

        def pid_for(track: str, kind: str) -> int:
            p = track_pid.get(track)
            if p is not None:
                return p
            p = len(track_pid) + 1
            track_pid[track] = p
            real = pids.get(track)
            name = f"worker {track}" + (f" (pid {real})" if real else "") \
                if kind == "worker" else f"ingress {track}"
            events.append({"name": "process_name", "ph": "M", "pid": p,
                           "args": {"name": name}})
            return p

        flow_id = 0
        for tid, r in enumerate(rows):
            worker = str(r.get("worker", "") or "?")
            origin = str(r.get("origin", "") or "")
            stages = r.get("stages") or {}
            wpid = pid_for(worker, "worker")
            opid = pid_for(origin, "origin") if origin and origin != worker \
                else wpid
            args = {"trace_id": r.get("trace_id"),
                    "txn_id": r.get("txn_id"),
                    "terminal": r.get("terminal"),
                    "worker": worker}
            t = _num(r.get("t_start"))
            crossed = opid != wpid
            for stage in TRACE_STAGES:
                ms = stages.get(stage)
                if ms is None:
                    continue
                ms = _num(ms)
                on_origin = crossed and stage in ("ingest", "broker_transit")
                pid = opid if on_origin else wpid
                ts = round(t * 1e6, 3)
                events.append({"name": stage, "ph": "X", "pid": pid,
                               "tid": tid, "ts": ts,
                               "dur": round(ms * 1e3, 3), "args": args})
                if crossed and stage == "broker_transit":
                    # flow arrow: start on the producer's transit slice,
                    # finish at the head of the consumer's first slice
                    flow_id += 1
                    events.append({"name": "broker_hop", "ph": "s",
                                   "id": flow_id, "pid": opid, "tid": tid,
                                   "ts": ts, "cat": "broker"})
                    events.append({"name": "broker_hop", "ph": "f",
                                   "bp": "e", "id": flow_id, "pid": wpid,
                                   "tid": tid,
                                   "ts": round((t + ms / 1e3) * 1e6, 3),
                                   "cat": "broker"})
                t += ms / 1e3
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {"tool": "rtfd trace-export --merge",
                         "n_traces": len(rows),
                         "tracks": {t: p for t, p in track_pid.items()}},
        }


def merge_chrome_traces(dumps: Sequence[Mapping[str, Any]],
                        ring_size: int = 65536) -> Dict[str, Any]:
    """Fold N per-worker ring dumps, ``{"worker": id, "pid": N, "traces":
    [CompletedTrace.to_dict(), ...]}`` (the shape of ``obs-drill
    --rings-out`` and of a worker's bye frame), into one fleet Chrome
    trace."""
    store = FleetTraceStore(ring_size=ring_size)
    for d in dumps:
        store.ingest(str(d.get("worker", "") or "?"),
                     d.get("traces") or [], pid=int(d.get("pid", 0) or 0))
    return store.export_chrome_trace()
