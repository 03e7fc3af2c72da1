"""One run of one cell: set-up, the measured window, the check, one line.

The run is one process. It makes the cell's traffic and the weights from
``--seed``, builds the ``run-job`` path (``perfbench/system.py``), warms up
the bucket shapes the cell's traffic uses, then measures ``--seconds`` of
``StreamJob.run_for``:

- backlog cells fill the transactions topic before the window opens, so
  every batch is full; ``txn_per_s`` counts the decisions put on the
  predictions topic inside the window;
- open-loop cells put the window's transactions in the topic before it
  opens, each readable by the job's consumer from its due time on
  (``System.open_loop``); a transaction's latency runs from its due time
  to the moment its decision is on the predictions topic, and what is due
  but not decided when the window closes is scored after it, its wait
  counted.

With ``--trace 1`` the last ``profile.slice_s`` seconds of the window run
under ``torch.profiler`` and the per-layer metrics are read from the trace,
the host spans and the program's counters (``perfbench/metrics/``).

Then the program's state is freed and the plain reference
(``perfbench/reference/``) replays the run's batches and judges the
transactions drawn for the check (``perfbench/check.py``). The last line
of standard output is the run's JSON result line.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

from perfbench import spec
from perfbench.traffic import make_traffic

FORBIDDEN = {"jax", "jaxlib", "flax", "realtime_fraud_detection_tpu"}
OUT_DIR = spec.ROOT / "build" / "perfbench"
PIN_CORES = 4


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The program's own kernels build into ``build/kernels/<hash>/`` there."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        path = spec.ROOT / "build" / "cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def _pin() -> int:
    """Load from one process on a few fixed cores: the run's threads stay on
    the same ``PIN_CORES`` cores of those the process may use (the first is
    left to the machine); returns their number, which torch's CPU operators
    take as their thread count. Acts on this process alone."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > PIN_CORES:
        cores = cores[1:PIN_CORES + 1]
    os.sched_setaffinity(0, cores)
    return len(cores)


def _freeze_traffic() -> None:
    """Keep the benchmark's pre-made traffic out of the program's garbage
    collections. In a deployment the window's records arrive from the
    network as the job polls them; here they are made in set-up and sit in
    the job's process, where every full collection would walk them. Called
    once the traffic is made and before the program (or torch) is imported,
    so the permanent generation holds the harness's own objects alone: the
    program's modules, its state and the profiles it keeps (a copy made
    after this) are collected as in a deployment."""
    gc.collect()
    gc.freeze()


def _warm_sizes(cell: Dict[str, Any]) -> List[int]:
    w = cell["warmup"]
    return [int(b) for b in w["buckets"] for _ in range(int(w["batches_per_bucket"]))]


class _GcClock:
    """Pause time of the interpreter's collections (``gc.callbacks``)."""

    def __init__(self) -> None:
        self.pauses: List[tuple] = []
        self._t = 0.0

    def __call__(self, phase: str, info: Dict[str, Any]) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.append((self._t, time.perf_counter(), info.get("generation")))


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda",
        overrides: Optional[Dict[str, Any]] = None,
        fault: Optional[str] = None, control: bool = False) -> int:
    """One run; prints the result line and returns the exit code.
    ``overrides`` (the harness's own tests) replaces keys of the cell and
    the configuration, ``device="cpu"`` skips the look for a card, and
    ``fault`` plants one of ``perfbench/faults.py``'s faults; ``control``
    also reads the control's numbers (``perfbench/control.py``)."""
    bench = spec.benchmark()
    cell = spec.cell(workload, bench)
    cfg = spec.config(cell["config"])
    if overrides:
        cell.update(overrides.get("cell", {}))
        for key, val in overrides.get("config", {}).items():
            cfg[key] = {**cfg[key], **val} if isinstance(val, dict) else val
    _cache_dirs()
    sizes = _warm_sizes(cell)
    traffic = make_traffic(cell, seed, seconds, sum(sizes))
    _freeze_traffic()
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            gc.unfreeze()
            print(f"perfbench: {workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        torch.set_num_threads(_pin())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from perfbench.system import System
    from perfbench.weights import input_scales, make_weights

    scales = input_scales(traffic, cfg)
    weights = make_weights(seed, cfg, device, scales)
    system = System(cfg, cell, weights, copy.deepcopy(traffic.users),
                    copy.deepcopy(traffic.merchants), device)
    del weights
    if fault is not None:
        from perfbench.faults import plant

        plant(fault, system)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    system.warm_up(traffic.warmup, sizes)
    rec = system.rec
    k0 = rec.batches
    stride = int(cell["check"]["stride"])
    n_check = int(cell["check"]["batches"])
    phase = int(seed) % stride
    rec.keep = lambda k: (k >= k0 and (k - k0) % stride == phase
                          and (k - k0) // stride < n_check)
    n_warm_preds = len(rec.produced)
    gate = None
    if traffic.open_loop:
        gate = system.open_loop(traffic.records, traffic.due)
    else:
        system.produce(traffic.records)

    prof = None
    slice_s = float(cell["profile"]["slice_s"])
    gc_clock = _GcClock()
    state: Dict[str, Any] = {}
    if trace:
        system.trace_job_steps()
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device == "cuda" else [])
        # the profiler's first start initialises the tracer: do it in set-up
        with profile(activities=acts):
            torch.ones(1, device=device).add_(1)
        prof = profile(activities=acts)
        gc.callbacks.append(gc_clock)
    gc.collect()
    setup_s = time.perf_counter() - t_start

    # ------------------------------------------------------------ window
    t0 = time.perf_counter()
    if gate is not None:
        gate["t0"] = t0
    t_slice = t0 + seconds - slice_s
    if trace:
        def on_dispatch() -> None:
            if "slice" not in state and time.perf_counter() >= t_slice:
                state["slice"] = time.perf_counter()
                state["stages_at_slice"] = system.host_stages()
                prof.start()
        rec.on_dispatch = on_dispatch
    stages_before = system.host_stages()
    system.job.run_for(seconds)
    t_loop = time.perf_counter()
    if prof is not None and "slice" in state:
        prof.stop()
        state["slice_end"] = time.perf_counter()
    rec.on_dispatch = None
    backlog_left = system.backlog()
    if traffic.open_loop:
        # due inside the window: scored now, their wait counted
        system.job.run_until_drained()
    t_drained = time.perf_counter()
    if trace:
        gc.callbacks.remove(gc_clock)

    # ------------------------------------------------------ end to end
    decided: Dict[str, float] = {}
    results: Dict[str, Dict[str, Any]] = {}
    in_window = 0
    for t, items in rec.produced[n_warm_preds:]:
        if t0 < t <= t0 + seconds:
            in_window += len(items)
        for _, res in items:
            decided[res["transaction_id"]] = t
            results[res["transaction_id"]] = res
    errors = sum(1 for r in results.values() if r.get("risk_level") == "ERROR")
    metrics: Dict[str, Dict[str, Any]] = {}
    stats: Dict[str, Any] = {"window_s": seconds, "loop_s": t_loop - t0,
                             "drain_s": t_drained - t_loop,
                             "batches": rec.batches - k0,
                             "backlog_left": backlog_left}
    if traffic.open_loop:
        due_ids = [r["transaction_id"] for r in traffic.records]
        lat = []
        missing = 0
        for tid, d in zip(due_ids, traffic.due):
            t = decided.get(tid)
            if t is None:
                missing += 1
            else:
                lat.append(t - (t0 + d))
        attempted, failed, unanswered = len(due_ids), missing + errors, missing
        lat_ms = np.asarray(lat) * 1e3
        values = {"txn_p50_ms": float(np.percentile(lat_ms, 50)) if lat else None,
                  "txn_p99_ms": float(np.percentile(lat_ms, 99)) if lat else None}
        stats["decided_after_window"] = sum(1 for tid in due_ids
                                            if decided.get(tid, 0) > t0 + seconds)
        stats.update({k: v for k, v in values.items() if v is not None})
    else:
        if backlog_left <= 0:
            print(f"perfbench: the backlog ran dry inside the window "
                  f"({len(traffic.records)} records); raise arrivals.depth_per_s",
                  file=sys.stderr)
            return 1
        # every record the run loops batched gets a decision
        emitted = system.job.assembler.records_emitted
        unanswered = max(0, emitted - len(results))
        attempted, failed = max(emitted, len(results)), errors + unanswered
        values = {"txn_per_s": in_window / seconds}
    values["setup_s"] = setup_s
    device_info: Dict[str, Any] = {
        "platform": "gpu" if device == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
        if device == "cuda" else 0,
    }
    stats["kernels"] = system.kernel_snapshot()
    stats["cores"], stats["threads"] = sorted(os.sched_getaffinity(0)), torch.get_num_threads()

    # ------------------------------------------------------------ traced
    result_extra: Dict[str, Any] = {}
    if trace:
        from perfbench import trace as tr

        ctx = {"cfg": cfg, "cell": cell, "seconds": seconds, "t0": t0,
               "in_window": in_window, "spans": list(rec.spans),
               "slice": state.get("slice"), "slice_end": state.get("slice_end"),
               "stages_before": stages_before,
               "stages_at_slice": state.get("stages_at_slice"),
               "gc_pauses": gc_clock.pauses, "trace": None}
        if "slice" in state:
            OUT_DIR.mkdir(parents=True, exist_ok=True)
            path = OUT_DIR / f"trace-{workload}.json"
            prof.export_chrome_trace(str(path))
            ctx["trace"] = tr.read_trace(path)
            device_info["busy_s"] = ctx["trace"]["busy_s"]
            device_info["window_s"] = ctx["trace"]["window_s"]
            result_extra["breakdown"] = tr.breakdown(ctx["trace"])
            stats["trace_file"] = str(path)
        for m in spec.metrics_for(workload, bench, trace=True):
            val = spec.reader(m["name"])(ctx)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        stats["launch_counts"] = ctx.get("launch_counts")
    else:
        for m in spec.metrics_for(workload, bench, trace=False):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    # ------------------------------------------------------------- check
    kept = dict(rec.kept)
    events = list(rec.events)
    system.close()
    del system, rec
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    gc.unfreeze()
    from perfbench.check import check_run

    t_check = time.perf_counter()
    verdict = check_run(cfg, cell, seed, device, traffic, scales, events, kept,
                        results, unanswered, control=control)
    stats["check_s"] = time.perf_counter() - t_check
    stats["check_rows"] = verdict["rows"]
    stats["check_info"] = verdict["info"]
    if control:
        stats["control"] = verdict["control"]
    correct = bool(verdict["correct"]) and failed == 0
    print("perfbench stats " + json.dumps(stats, default=str), file=sys.stderr)

    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, (value, limit) in verdict["numbers"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    out = {"correct": correct, "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device_info, **result_extra,
           "checks": {k: {"value": v, "limit": lim}
                      for k, (v, lim) in verdict["numbers"].items()}}
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0
