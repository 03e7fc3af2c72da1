"""Per-transaction tracing plane: flight recorder, tail attribution, SLO burn.

Port of the JAX package's ``obs/tracing.py`` (plain Python; the process
fleet's coordinator stitches its workers' rings with ``obs/fleetmetrics.py
FleetTraceStore``, and ``trace-export --merge`` merges exported rings into
one Chrome trace). Every admitted
transaction gets a trace context that rides the batch through the port's
stream job —

    ingest (broker lag) -> QoS admission -> microbatch queue wait ->
    assemble -> pack -> dispatch (pinned H2D + launches + D2H start) ->
    device_wait (until the D2H event completes) -> finalize / fan-out

— and completed traces land in a fixed-size ring buffer (the "flight
recorder") plus a slowest-N exemplar store kept verbatim. ``breakdown``
splits the p50 / p95 / p99 end-to-end latency into additive per-stage
shares; ``SloTracker`` turns completions into the burn rate the QoS plane's
SLO gate and the tuning plane read.

Cost discipline: with no tracer attached the scoring path pays one
``is None`` check per batch; stage marks are batch-granular (one clock
read per stage per microbatch); completion takes one lock per batch.

Clock discipline: stage marks, admission timestamps and SLO windows all
read the tracer's clock (``time.monotonic`` by default, a virtual clock in
the drills); the ingest lag is a wall-minus-wall delta computed upstream
and carried as a duration.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "TRACE_STAGES",
    "TRACE_STAGE_BUCKETS_MS",
    "CARRIER_KEY",
    "make_carrier",
    "parse_carrier",
    "TraceContext",
    "TraceBatch",
    "CompletedTrace",
    "SloTracker",
    "Tracer",
    "set_log_context",
    "clear_log_context",
    "current_log_context",
]

# Canonical stage order (the JAX package's): ``ingest`` is the
# ingest-to-produce lag, ``broker_transit`` the produce→consume transit
# (producer wall stamp in the carrier vs consume wall stamp),
# ``redirect_hops`` time a carrier reports spent on wrong-shard bounces,
# ``queue`` the microbatch assembly wait; the rest are the batch-granular
# pipeline stages. ``device_wait`` spans launch-queued → result-in-hand,
# so under pipelining it absorbs the in-flight dwell (that time IS the
# batch's device + queue residency from the transaction's point of view).
# ``remote_fetch`` is carved OUT of its enclosing stage by the child-span
# bookkeeping (``TraceBatch.child_span``), so the stages stay additive
# over e2e.
TRACE_STAGES = ("ingest", "broker_transit", "redirect_hops", "queue",
                "assemble", "pack", "dispatch", "device_wait",
                "remote_fetch", "finalize")

# trace_stage_ms histogram bounds (milliseconds). Shared with
# obs.metrics.MetricsCollector.sync_tracing: the tracer aggregates into
# exactly these buckets so the Prometheus mirror is a pure counter-delta.
TRACE_STAGE_BUCKETS_MS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                          20.0, 50.0, 100.0, 500.0)

# ---------------------------------------------------------------------------
# cross-process trace carrier
# ---------------------------------------------------------------------------

# Producers stamp the carrier INTO the record value (next to ``ingest_ts``),
# so it rides the broker verbatim; the stream job reads it from the RAW
# record value before sanitize strips unknown fields.
CARRIER_KEY = "trace_carrier"


def make_carrier(trace_id: str, origin: str = "",
                 produced_ts: Optional[float] = None, priority: str = "",
                 fault: str = "", parent: str = "", hops: int = 0,
                 redirect_s: float = 0.0) -> Dict[str, Any]:
    """Compact wire form of a trace context (the keys are the format):

    ``v`` version, ``tid`` trace id, ``sp`` parent span id, ``org``
    producing process, ``ts`` producer
    WALL stamp (consume-wall minus it = ``broker_transit``), ``pr`` QoS
    priority, ``flt`` producer-side fault context, ``rh``/``rs``
    421-redirect hop count and accumulated redirect seconds. Empty
    fields are omitted — the carrier stays a handful of bytes.
    """
    c: Dict[str, Any] = {"v": 1, "tid": str(trace_id)}
    if parent:
        c["sp"] = str(parent)
    if origin:
        c["org"] = str(origin)
    if produced_ts is not None:
        c["ts"] = round(float(produced_ts), 6)
    if priority:
        c["pr"] = str(priority)
    if fault:
        c["flt"] = str(fault)
    if hops:
        c["rh"] = int(hops)
    if redirect_s:
        c["rs"] = round(float(redirect_s), 6)
    return c


def parse_carrier(obj: Any) -> Optional[Dict[str, Any]]:
    """Validate a wire carrier; None = unusable (counted as carrier loss
    by ``Tracer.begin`` when one was expected — a fresh root, never a
    wedge)."""
    if not isinstance(obj, dict):
        return None
    tid = obj.get("tid")
    if not isinstance(tid, str) or not tid:
        return None
    out: Dict[str, Any] = {"tid": tid,
                           "sp": str(obj.get("sp", "") or ""),
                           "org": str(obj.get("org", "") or ""),
                           "pr": str(obj.get("pr", "") or ""),
                           "flt": str(obj.get("flt", "") or "")}
    for key, cast in (("ts", float), ("rh", int), ("rs", float)):
        try:
            out[key] = cast(obj[key])
        except (KeyError, TypeError, ValueError):
            pass
    return out


# Log/trace correlation seam: ``Tracer.batch`` publishes the active batch's
# lead trace id (+ worker origin) thread-locally, for a log formatter to
# stamp on its lines (``obs/logs.py`` reads it through
# ``current_log_context``).
_log_ctx = threading.local()


def set_log_context(trace_id: str, worker: str = "") -> None:
    _log_ctx.trace_id = str(trace_id)
    _log_ctx.worker = str(worker)


def clear_log_context() -> None:
    _log_ctx.trace_id = ""
    _log_ctx.worker = ""


def current_log_context() -> Optional[Dict[str, str]]:
    tid = getattr(_log_ctx, "trace_id", "")
    if not tid:
        return None
    return {"trace_id": tid, "worker": getattr(_log_ctx, "worker", "")}


class TraceContext:
    """Per-transaction trace state between admission and completion.
    ``priority`` is the QoS class the admission path assigned (empty when
    no QoS plane classified the transaction) — it rides to the completed
    trace so queue-wait attribution can split by class."""

    __slots__ = ("trace_id", "txn_id", "t_admit", "ingest_lag_s",
                 "priority", "broker_transit_s", "redirect_s", "hops",
                 "origin", "parent", "fault")

    def __init__(self, trace_id: str, txn_id: str, t_admit: float,
                 ingest_lag_s: float = 0.0, priority: str = "",
                 broker_transit_s: float = 0.0, redirect_s: float = 0.0,
                 hops: int = 0, origin: str = "", parent: str = "",
                 fault: str = ""):
        self.trace_id = trace_id
        self.txn_id = txn_id
        self.t_admit = t_admit
        self.ingest_lag_s = ingest_lag_s
        self.priority = priority
        # carrier-adopted cross-process segments (wall-minus-wall deltas
        # carried as durations, the ingest-lag clock discipline)
        self.broker_transit_s = broker_transit_s
        self.redirect_s = redirect_s
        self.hops = hops
        self.origin = origin            # producing process ("" = local root)
        self.parent = parent            # producer-side parent span id
        self.fault = fault              # producer-side fault context


class TraceBatch:
    """One microbatch's trace carrier: per-txn contexts + batch marks.

    ``mark`` records (stage, now) once per batch — the near-zero-overhead
    contract. The scorer marks assemble/pack/dispatch/device_wait/finalize;
    the owner (the stream job) finishes the batch after fan-out,
    which stamps the emit time and fans the shared marks out to per-txn
    completed traces.
    """

    __slots__ = ("tracer", "contexts", "marks", "meta", "spans")

    def __init__(self, tracer: "Tracer", contexts: List[TraceContext],
                 meta: Optional[Dict[str, Any]] = None):
        self.tracer = tracer
        self.contexts = contexts
        self.marks: List[Tuple[str, float]] = []
        self.meta: Dict[str, Any] = dict(meta or {})
        # child spans carved OUT of their enclosing stage at finish time:
        # (enclosing mark index, span name, duration ms, span meta)
        self.spans: List[Tuple[int, str, float, Dict[str, Any]]] = []

    def mark(self, stage: str) -> None:
        self.marks.append((stage, self.tracer._clock()))

    def child_span(self, name: str, dur_ms: float, **meta: Any) -> None:
        """Record a sub-operation (a remote graph-fetch RPC, say) inside
        the CURRENT stage. ``finish_batch`` subtracts the span from its
        enclosing stage and books it under its own name, so the stage
        table stays additive over e2e while the remote time is visible
        as a first-class stage."""
        self.spans.append((len(self.marks) - 1, str(name),
                           max(0.0, float(dur_ms)), meta))

    def annotate(self, **kv: Any) -> None:
        self.meta.update(kv)


class CompletedTrace:
    """An immutable completed trace row in the flight recorder."""

    __slots__ = ("trace_id", "txn_id", "t_start", "e2e_ms", "stages",
                 "meta", "terminal", "priority", "origin", "parent")

    def __init__(self, trace_id, txn_id, t_start, e2e_ms, stages, meta,
                 terminal, priority="", origin="", parent=""):
        self.trace_id = trace_id
        self.txn_id = txn_id
        self.t_start = t_start          # tracer-clock start (admit - queue)
        self.e2e_ms = e2e_ms
        self.stages = stages            # {stage: ms}, additive over e2e
        self.meta = meta
        self.terminal = terminal        # scored | shed | error | cached
        self.priority = priority        # QoS class ("" = unclassified)
        self.origin = origin            # carrier origin ("" = local root)
        self.parent = parent            # carrier parent span id

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "trace_id": self.trace_id,
            "txn_id": self.txn_id,
            "t_start": round(self.t_start, 6),
            "e2e_ms": round(self.e2e_ms, 4),
            "stages": {k: round(v, 4) for k, v in self.stages.items()},
            "meta": self.meta,
            "terminal": self.terminal,
            "priority": self.priority,
        }
        if self.origin:
            out["origin"] = self.origin
        if self.parent:
            out["parent"] = self.parent
        return out


class SloTracker:
    """Windowed SLO accounting: objective_frac of txns under objective_ms.

    Time-bucketed counters (one [bucket, total, violations] row per
    ``bucket_s``) bound memory to the slow window regardless of
    throughput, and make the burn rate exact on a virtual clock. Burn
    rate = violation fraction / error budget (1 - objective_frac): 1.0
    means the budget is being consumed exactly at the sustainable rate,
    2.0 means twice as fast — the standard multi-window burn alerting
    quantity.
    """

    def __init__(self, objective_ms: float = 20.0,
                 objective_frac: float = 0.99,
                 fast_window_s: float = 3600.0,
                 slow_window_s: float = 21600.0,
                 bucket_s: float = 60.0,
                 clock=time.monotonic):
        self.objective_ms = float(objective_ms)
        self.objective_frac = float(objective_frac)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.bucket_s = float(bucket_s)
        self._clock = clock
        self._lock = threading.Lock()
        maxlen = int(self.slow_window_s / self.bucket_s) + 2
        self._buckets: deque = deque(maxlen=maxlen)  # [idx, total, bad]
        self.violations_total = 0
        self.observations_total = 0

    def record(self, e2e_ms: float, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        idx = int(now // self.bucket_s)
        bad = 1 if e2e_ms > self.objective_ms else 0
        with self._lock:
            if self._buckets and self._buckets[-1][0] == idx:
                row = self._buckets[-1]
                row[1] += 1
                row[2] += bad
            else:
                self._buckets.append([idx, 1, bad])
            self.observations_total += 1
            self.violations_total += bad

    def _counts(self, window_s: float, now: float) -> Tuple[int, int]:
        lo = int((now - window_s) // self.bucket_s)
        total = bad = 0
        with self._lock:
            for idx, t, b in self._buckets:
                if idx > lo:
                    total += t
                    bad += b
        return total, bad

    def burn_rate(self, window_s: float, now: Optional[float] = None) -> float:
        now = self._clock() if now is None else now
        total, bad = self._counts(window_s, now)
        if not total:
            return 0.0
        budget = max(1e-9, 1.0 - self.objective_frac)
        return (bad / total) / budget

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``GET /slo`` payload."""
        now = self._clock() if now is None else now
        windows = {}
        for name, win in (("fast", self.fast_window_s),
                          ("slow", self.slow_window_s)):
            total, bad = self._counts(win, now)
            budget = max(1e-9, 1.0 - self.objective_frac)
            frac = bad / total if total else 0.0
            windows[name] = {
                "window_s": win,
                "observed": total,
                "violations": bad,
                "violation_frac": round(frac, 6),
                "burn_rate": round(frac / budget, 4),
                "budget_remaining_frac": round(1.0 - frac / budget, 4),
            }
        return {
            "objective": {"latency_ms": self.objective_ms,
                          "frac": self.objective_frac},
            "windows": windows,
            "observations_total": self.observations_total,
            "violations_total": self.violations_total,
        }


def _bucket_index(ms: float) -> int:
    for i, ub in enumerate(TRACE_STAGE_BUCKETS_MS):
        if ms <= ub:
            return i
    return len(TRACE_STAGE_BUCKETS_MS)        # the +Inf bucket


class _StageAgg:
    """Cumulative per-stage histogram (TRACE_STAGE_BUCKETS_MS + Inf),
    mirrored into Prometheus by counter deltas (sync_tracing)."""

    __slots__ = ("bucket_counts", "sum_ms", "count", "max_ms", "exemplar")

    def __init__(self) -> None:
        self.bucket_counts = [0] * (len(TRACE_STAGE_BUCKETS_MS) + 1)
        self.sum_ms = 0.0
        self.count = 0
        self.max_ms = 0.0
        self.exemplar: Optional[Dict[str, Any]] = None   # slowest sample

    def add(self, ms: float, trace_id: str) -> None:
        self.bucket_counts[_bucket_index(ms)] += 1
        self.sum_ms += ms
        self.count += 1
        if ms >= self.max_ms:
            self.max_ms = ms
            self.exemplar = {"trace_id": trace_id, "ms": round(ms, 4)}


class Tracer:
    """The tracing plane: begin/mark/finish + flight recorder + SLO.

    One instance per stream job. All
    completion work is batched: ``finish_batch`` takes the plane lock once
    per microbatch. ``settings`` is a ``utils.config.TracingSettings``
    (or anything with its fields); ``clock`` must match the time base of
    every ``t_admit`` handed to :meth:`begin` — the drills pass a virtual
    clock.
    """

    def __init__(self, settings: Optional[Any] = None, clock=time.monotonic,
                 origin: str = ""):
        from realtime_fraud_detection_tpu_torch.utils.config import TracingSettings

        self.settings = settings if settings is not None else TracingSettings(
            enabled=True)
        self.enabled = bool(getattr(self.settings, "enabled", True))
        self._clock = clock
        self._lock = threading.Lock()
        # process identity stamped into minted trace ids — what keeps two
        # workers' fresh roots distinct when their rings are merged (""
        # keeps the single-process id format)
        self.origin = str(origin
                          or getattr(self.settings, "origin", "") or "")
        s = self.settings
        self._ring: deque = deque(maxlen=max(16, int(s.ring_size)))
        self._slowest: List[Tuple[float, int, CompletedTrace]] = []
        self._slowest_n = max(1, int(s.slowest_n))
        self._seq = itertools.count()
        self._stage_agg: Dict[str, _StageAgg] = {}
        self.counters: Dict[str, int] = {
            "started": 0, "completed": 0, "shed": 0, "errors": 0,
            "cached": 0, "carrier_adopted": 0, "carrier_lost": 0,
        }
        # the chaos plane's fault-window attribution: while set, every trace
        # closed (scored, shed, errored, terminal) carries meta["fault"], so
        # the flight recorder separates in-fault tails from steady state
        self.fault_context: str = ""
        self.slo = SloTracker(
            objective_ms=s.slo_objective_ms,
            objective_frac=s.slo_objective_frac,
            fast_window_s=s.slo_fast_window_s,
            slow_window_s=s.slo_slow_window_s,
            bucket_s=s.slo_bucket_s,
            clock=clock,
        )

    # ------------------------------------------------------------- lifecycle
    def _next_id(self) -> str:
        n = next(self._seq)
        return f"t{self.origin}-{n:08x}" if self.origin else f"t{n:08x}"

    def begin(self, txn_id: str, ingest_lag_s: float = 0.0,
              t_admit: Optional[float] = None, priority: str = "",
              carrier: Any = None, now_wall: Optional[float] = None,
              expect_carrier: bool = False) -> Optional[TraceContext]:
        """Open a trace at admission. Returns None when disabled — every
        downstream call site guards on the context, so the disabled plane
        costs one branch. ``priority`` is the QoS class the admission path
        assigned (queue-wait attribution splits on it).

        ``carrier`` re-hydrates a producer-stamped wire carrier: the
        trace ADOPTS the producer's trace id (stitching key), priority,
        fault context and redirect ledger, and ``broker_transit`` becomes
        ``now_wall`` (consume wall stamp) minus the carrier's produce
        stamp — the ingest lag is reduced by the same amount so the
        pre-admission segments never double-count one interval. A
        missing or unparseable carrier where one was expected
        (``expect_carrier``, or a present-but-garbled frame) degrades to
        a fresh LOCAL root, counted in ``carrier_lost`` — never a gap,
        never a wedge."""
        if not self.enabled:
            return None
        self.counters["started"] += 1
        tid = ""
        parent = origin = fault = ""
        transit = redirect = 0.0
        hops = 0
        pr = str(priority)
        if carrier is not None or expect_carrier:
            c = parse_carrier(carrier)
            if c is None:
                self.counters["carrier_lost"] += 1
            else:
                self.counters["carrier_adopted"] += 1
                tid = c["tid"]
                parent, origin, fault = c["sp"], c["org"], c["flt"]
                if not pr:
                    pr = c["pr"]
                ts = c.get("ts")
                if ts is not None and now_wall is not None:
                    transit = max(0.0, float(now_wall) - ts)
                hops = int(c.get("rh", 0))
                redirect = max(0.0, float(c.get("rs", 0.0)))
        ingest = max(0.0, float(ingest_lag_s))
        if transit > 0.0:
            # ingest_ts and the carrier's produce stamp bracket the same
            # wall interval's two ends: keep ingest = submit→produce,
            # transit = produce→consume, additive by construction
            ingest = max(0.0, ingest - transit)
        return TraceContext(
            tid or self._next_id(), str(txn_id),
            self._clock() if t_admit is None else t_admit,
            ingest, pr, broker_transit_s=transit, redirect_s=redirect,
            hops=hops, origin=origin, parent=parent, fault=fault)

    def root_carrier(self, produced_ts: Optional[float] = None,
                     priority: str = "") -> Optional[Dict[str, Any]]:
        """Mint a wire carrier for a record this process produces but will
        never score (the ingress gateway -> broker): a fresh trace id plus
        the producer's wall stamp, which the consumer turns into
        ``broker_transit``. None when the tracer is disabled."""
        if not self.enabled:
            return None
        return make_carrier(self._next_id(), origin=self.origin,
                            produced_ts=produced_ts, priority=priority,
                            fault=self.fault_context)

    def batch(self, contexts: Sequence[Optional[TraceContext]],
              **meta: Any) -> Optional[TraceBatch]:
        """Bind admitted contexts into one microbatch carrier. Publishes
        the lead trace id thread-locally (``current_log_context``) so JSON
        log lines emitted while the batch is in flight carry it."""
        ctxs = [c for c in contexts if c is not None]
        if not self.enabled or not ctxs:
            return None
        set_log_context(ctxs[0].trace_id, self.origin)
        return TraceBatch(self, ctxs, meta)

    def set_fault_context(self, name: str) -> None:
        """Chaos-plane attribution: set (or clear, with "") the active
        fault-window name(s); later trace completions, terminal sheds and
        errors included, carry it as ``meta["fault"]``."""
        self.fault_context = str(name or "")

    def finish_batch(self, trace: Optional[TraceBatch],
                     terminal: str = "scored") -> None:
        """Stamp emit time, fan batch marks out to per-txn traces, record.

        Stage durations are consecutive-mark deltas, so they partition
        ``emit - admit`` exactly (additive by construction); ``queue`` is
        per-transaction (first mark - that txn's admission), ``ingest``
        the carried upstream lag.
        """
        if trace is None:
            return
        now = self._clock()
        clear_log_context()
        if self.fault_context:
            trace.meta = dict(trace.meta)
            trace.meta["fault"] = self.fault_context
        if trace.spans:
            trace.meta = dict(trace.meta)
            trace.meta["spans"] = [
                {"name": name, "ms": round(ms, 4), **smeta}
                for _, name, ms, smeta in trace.spans]
        marks = trace.marks
        completed: List[CompletedTrace] = []
        for ctx in trace.contexts:
            stages: Dict[str, float] = {}
            if ctx.ingest_lag_s > 0.0:
                stages["ingest"] = ctx.ingest_lag_s * 1e3
            if ctx.broker_transit_s > 0.0:
                stages["broker_transit"] = ctx.broker_transit_s * 1e3
            if ctx.hops or ctx.redirect_s > 0.0:
                stages["redirect_hops"] = ctx.redirect_s * 1e3
            if marks:
                stages["queue"] = max(0.0, marks[0][1] - ctx.t_admit) * 1e3
                for i, (name, t0) in enumerate(marks):
                    t1 = marks[i + 1][1] if i + 1 < len(marks) else now
                    stages[name] = max(0.0, t1 - t0) * 1e3
            else:
                stages["queue"] = max(0.0, now - ctx.t_admit) * 1e3
            for idx, name, ms, _smeta in trace.spans:
                # carve the child span out of its enclosing stage so the
                # table stays additive (a span before the first mark came
                # out of the queue wait)
                encl = marks[idx][0] if 0 <= idx < len(marks) else "queue"
                if encl in stages:
                    stages[encl] = max(0.0, stages[encl] - ms)
                stages[name] = stages.get(name, 0.0) + ms
            pre = (ctx.ingest_lag_s + ctx.broker_transit_s
                   + ctx.redirect_s)
            e2e_ms = (pre + max(0.0, now - ctx.t_admit)) * 1e3
            meta = trace.meta
            if ctx.fault and "fault" not in meta:
                meta = dict(meta)
                meta["fault"] = ctx.fault
            completed.append(CompletedTrace(
                ctx.trace_id, ctx.txn_id, ctx.t_admit - pre, e2e_ms,
                stages, meta, terminal, ctx.priority,
                origin=ctx.origin, parent=ctx.parent))
        with self._lock:
            for ct in completed:
                self._record_locked(ct, now)

    def finish_terminal(self, ctx: Optional[TraceContext], terminal: str,
                        **meta: Any) -> None:
        """Close a trace that never reached the device — shed at
        admission, served from the prediction cache, or errored before
        dispatch. The terminal stage is recorded so sheds are auditable
        in the flight recorder, never silent gaps."""
        if ctx is None:
            return
        now = self._clock()
        pre = ctx.ingest_lag_s + ctx.broker_transit_s + ctx.redirect_s
        e2e_ms = (pre + max(0.0, now - ctx.t_admit)) * 1e3
        stages = {"queue": max(0.0, now - ctx.t_admit) * 1e3}
        if ctx.ingest_lag_s > 0.0:
            stages["ingest"] = ctx.ingest_lag_s * 1e3
        if ctx.broker_transit_s > 0.0:
            stages["broker_transit"] = ctx.broker_transit_s * 1e3
        if ctx.hops or ctx.redirect_s > 0.0:
            stages["redirect_hops"] = ctx.redirect_s * 1e3
        meta = dict(meta)
        if self.fault_context:
            meta.setdefault("fault", self.fault_context)
        if ctx.fault:
            meta.setdefault("fault", ctx.fault)
        ct = CompletedTrace(ctx.trace_id, ctx.txn_id,
                            ctx.t_admit - pre, e2e_ms, stages,
                            meta, terminal, ctx.priority,
                            origin=ctx.origin, parent=ctx.parent)
        with self._lock:
            self._record_locked(ct, now)

    def _record_locked(self, ct: CompletedTrace, now: float) -> None:
        self._ring.append(ct)
        key = self.counters
        if ct.terminal == "scored":
            key["completed"] += 1
        elif ct.terminal == "shed":
            key["shed"] += 1
        elif ct.terminal == "cached":
            key["cached"] += 1
        else:
            key["errors"] += 1
        if ct.terminal == "scored":
            for stage, ms in ct.stages.items():
                agg = self._stage_agg.get(stage)
                if agg is None:
                    agg = self._stage_agg[stage] = _StageAgg()
                agg.add(ms, ct.trace_id)
            self.slo.record(ct.e2e_ms, now)
            # slowest-N exemplars kept verbatim (min-heap on e2e)
            item = (ct.e2e_ms, next(self._seq), ct)
            if len(self._slowest) < self._slowest_n:
                heapq.heappush(self._slowest, item)
            elif ct.e2e_ms > self._slowest[0][0]:
                heapq.heapreplace(self._slowest, item)

    # -------------------------------------------------------------- analysis
    def traces(self, terminal: Optional[str] = None) -> List[CompletedTrace]:
        with self._lock:
            out = list(self._ring)
        if terminal is not None:
            out = [t for t in out if t.terminal == terminal]
        return out

    def slowest(self) -> List[CompletedTrace]:
        with self._lock:
            return [ct for _, _, ct in sorted(self._slowest, reverse=True)]

    def breakdown(self) -> Dict[str, Any]:
        """Critical-path decomposition: additive per-stage contributions
        to the p50/p95/p99 end-to-end latency, with the dominant stage
        flagged per quantile (the ``GET /latency/breakdown`` payload).

        For each quantile q the contribution of stage s is the mean of s
        over the traces at-or-above the q-th e2e percentile — the stage
        means sum to the tail's mean e2e, so "where did the p99 go" has
        an additive answer.
        """
        from realtime_fraud_detection_tpu_torch.obs.profiling import (
            interpolated_percentile,
        )

        traces = self.traces(terminal="scored")
        if not traces:
            return {"enabled": self.enabled, "n": 0, "quantiles": {},
                    "exemplars": []}
        e2e = sorted(t.e2e_ms for t in traces)

        quantiles: Dict[str, Any] = {}
        for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            thresh = interpolated_percentile(e2e, q)
            tail = [t for t in traces if t.e2e_ms >= thresh] or traces[-1:]
            contrib: Dict[str, float] = {}
            queue_by_prio: Dict[str, Dict[str, float]] = {}
            for t in tail:
                for stage, ms in t.stages.items():
                    contrib[stage] = contrib.get(stage, 0.0) + ms
                    if stage == "queue":
                        # queue-wait attribution split by QoS class: each
                        # class's share of the tail's SUMMED queue time,
                        # so the per-class contributions (normalized by
                        # the same tail_n) sum exactly to the aggregate
                        # queue figure — "is high-value traffic the one
                        # waiting?" has an additive answer
                        row = queue_by_prio.setdefault(
                            t.priority or "unclassified",
                            {"ms": 0.0, "n": 0})
                        row["ms"] += ms
                        row["n"] += 1
            n = len(tail)
            contrib = {s: round(v / n, 4) for s, v in contrib.items()}
            dominant = max(contrib, key=contrib.get)
            quantiles[name] = {
                "e2e_ms": round(thresh, 4),
                "tail_n": n,
                "stage_ms": contrib,
                "dominant_stage": dominant,
                "dominant_frac": round(
                    contrib[dominant] / max(sum(contrib.values()), 1e-9), 4),
                "queue_ms_by_priority": {
                    p: {"contrib_ms": round(row["ms"] / n, 4),
                        "tail_n": row["n"],
                        "mean_ms": round(row["ms"] / max(row["n"], 1), 4)}
                    for p, row in sorted(queue_by_prio.items())
                },
            }
        return {
            "enabled": self.enabled,
            "n": len(traces),
            "quantiles": quantiles,
            "exemplars": [
                {"trace_id": t.trace_id, "txn_id": t.txn_id,
                 "e2e_ms": round(t.e2e_ms, 4),
                 "dominant_stage": max(t.stages, key=t.stages.get)
                 if t.stages else None}
                for t in self.slowest()[:8]
            ],
        }

    # --------------------------------------------------------------- export
    def export_chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace / Perfetto JSON of the captured window: one track
        per trace (the ring, slowest-N merged in), complete ("X") events
        per stage. Load in ui.perfetto.dev or chrome://tracing."""
        with self._lock:
            ring = list(self._ring)
            slowest = [ct for _, _, ct in self._slowest]
        seen = {id(t) for t in ring}
        traces = ring + [t for t in slowest if id(t) not in seen]
        traces.sort(key=lambda t: t.t_start)
        events: List[Dict[str, Any]] = []
        for tid, tr in enumerate(traces):
            t = tr.t_start
            for stage in TRACE_STAGES:
                ms = tr.stages.get(stage)
                if ms is None:
                    continue
                events.append({
                    "name": stage, "ph": "X", "pid": 1, "tid": tid,
                    "ts": round(t * 1e6, 3), "dur": round(ms * 1e3, 3),
                    "args": {"trace_id": tr.trace_id, "txn_id": tr.txn_id,
                             "terminal": tr.terminal, **tr.meta},
                })
                t += ms / 1e3
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {"tool": "realtime_fraud_detection_tpu_torch trace-export",
                         "n_traces": len(traces),
                         "slo": self.slo.snapshot()},
        }

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, Any]:
        """Cumulative plane state for the Prometheus mirror
        (obs.metrics.MetricsCollector.sync_tracing) and JSON endpoints.
        Bucket counts use TRACE_STAGE_BUCKETS_MS exactly, so the mirror
        is a pure counter-delta (honest counters, rate()/increase()
        valid)."""
        with self._lock:
            stages = {
                name: {
                    "bucket_counts": list(agg.bucket_counts),
                    "sum_ms": agg.sum_ms,
                    "count": agg.count,
                    "max_ms": agg.max_ms,
                    "exemplar": dict(agg.exemplar) if agg.exemplar else None,
                }
                for name, agg in self._stage_agg.items()
            }
            counters = dict(self.counters)
        return {
            "enabled": self.enabled,
            "buckets_ms": list(TRACE_STAGE_BUCKETS_MS),
            "stages": stages,
            "counters": counters,
            "slo": self.slo.snapshot(),
        }

    def reset(self) -> None:
        """Drop the captured window (testing/drills); cumulative counters
        and SLO history survive — only the recorder clears."""
        with self._lock:
            self._ring.clear()
            self._slowest.clear()
