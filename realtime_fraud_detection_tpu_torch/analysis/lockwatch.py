"""Dynamic lock-order watcher: record real acquisition graphs under drills.

The static ``lock-order`` rule (analysis/lint.py) sees the lexical
structure; this module watches what the threads actually do. While any of
the deterministic drills run (``lint --lockwatch`` drives the thirteen of
LOCKWATCH_DRILLS), every ``threading.Lock`` / ``RLock`` / ``Condition``
created from the port's code is replaced by an instrumented wrapper that
records, per thread:

- the acquisition DAG (edge A->B = "acquired B while holding A", keyed by
  lock *creation site*, so every instance of a class shares one node and
  the order analysis generalizes across objects);
- max hold time and max acquire-wait time per lock site;
- **violations**: a device wait entered while ANY watched lock is held —
  the designated wait (``core/sync.py device_wait``, called on the CPU
  too, with no event), ``torch.cuda.synchronize``, a CUDA event's or
  stream's ``synchronize``, or a blocking pull of a CUDA tensor
  (``Tensor.item`` / ``.cpu`` / ``.tolist`` on the card). The serving
  plane's contract is the opposite (the score lock covers host-state
  mutation, never the device wait), and a lock held across a multi-ms
  device block is exactly how a 20 ms p99 budget dies;
- **warnings**: a condition wait while holding a *different* watched lock
  (the classic nested-wait deadlock shape — reported for triage, not
  failed, because a timeout-guarded wait can be a legitimate design).

A cycle anywhere in the merged acquisition graph, or any violation, fails
the run. The report also counts the device waits by kind
(``device_waits``), so a caller can check that the designated wait saw
every finalized batch. The wrappers cost one dict update per acquisition
and are installed only inside :func:`watch_locks`; production code paths
never see them. The module imports torch only inside :func:`watch_locks`.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = ["LockWatcher", "WatchedLock", "WatchedCondition", "watch_locks",
           "run_drill_watched", "LOCKWATCH_DRILLS", "SEAM"]

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

# the port's package directory as a path component: the JAX package's
# directory name is a prefix of this one, so a bare name would not do
PACKAGE_MARKER = os.sep + "realtime_fraud_detection_tpu_torch" + os.sep

# the designated wait's name in the report's device_waits
SEAM = "sync.device_wait"

# the thirteen deterministic drills the watcher is validated against
LOCKWATCH_DRILLS = ("qos-drill", "trace-drill", "autotune-drill",
                    "feedback-drill", "pool-drill", "chaos-drill",
                    "shard-drill", "mesh-drill", "elastic-drill",
                    "partition-drill", "graph-drill", "kernel-drill",
                    "obs-drill")


class LockWatcher:
    """Acquisition-graph recorder shared by every instrumented lock."""

    def __init__(self) -> None:
        self._meta = _REAL_LOCK()
        self._tls = threading.local()
        self.edges: Dict[Tuple[str, str], int] = {}
        self.max_hold_ms: Dict[str, float] = {}
        self.max_wait_ms: Dict[str, float] = {}
        self.acquisitions = 0
        self.violations: List[Dict[str, Any]] = []
        self.warnings: List[Dict[str, Any]] = []
        self.device_waits: Dict[str, int] = {}
        self.armed = True

    # ------------------------------------------------------------- test API
    def lock(self, name: str) -> "WatchedLock":
        """A named instrumented lock (the corpus tests build inverted
        acquisition orders with these; package code gets wrapped
        automatically by watch_locks)."""
        return WatchedLock(self, _REAL_LOCK(), name)

    def condition(self, name: str) -> "WatchedCondition":
        return WatchedCondition(self, _REAL_CONDITION(), name)

    # ------------------------------------------------------------ recording
    def _held(self) -> List[List[Any]]:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def held_sites(self) -> List[str]:
        return [s for s, _ in self._held()]

    def _acquired(self, site: str, waited_s: float) -> None:
        held = self._held()
        with self._meta:
            self.acquisitions += 1
            w = waited_s * 1e3
            if w > self.max_wait_ms.get(site, 0.0):
                self.max_wait_ms[site] = w
            for h, _t in held:
                if h != site:
                    self.edges[(h, site)] = self.edges.get((h, site), 0) + 1
        held.append([site, time.perf_counter()])

    def _released(self, site: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == site:
                _, t0 = held.pop(i)
                ms = (time.perf_counter() - t0) * 1e3
                with self._meta:
                    if ms > self.max_hold_ms.get(site, 0.0):
                        self.max_hold_ms[site] = ms
                return

    def note_device_wait(self, what: str) -> None:
        """Called (via the patched waits) when a thread is about to block
        on a device result; holding any watched lock here is a
        violation."""
        if not self.armed:
            return
        held = self.held_sites()
        with self._meta:
            self.device_waits[what] = self.device_waits.get(what, 0) + 1
            if held:
                self.violations.append({
                    "kind": "device-wait-under-lock",
                    "blocking_on": what,
                    "held": list(held),
                    "thread": threading.current_thread().name,
                })

    def _device_wait(self, what: str, fn: Callable, *args: Any) -> Any:
        """Note a wait, then run it; a wait inside another noted wait (the
        seam's own ``Event.synchronize``) is the same wait, noted once."""
        if getattr(self._tls, "in_wait", False):
            return fn(*args)
        self.note_device_wait(what)
        self._tls.in_wait = True
        try:
            return fn(*args)
        finally:
            self._tls.in_wait = False

    def note_cond_wait(self, site: str) -> None:
        if not self.armed:
            return
        others = [s for s in self.held_sites() if s != site]
        if others:
            with self._meta:
                self.warnings.append({
                    "kind": "cond-wait-holding-other-lock",
                    "cond": site,
                    "held": others,
                    "thread": threading.current_thread().name,
                })

    # ------------------------------------------------------------- analysis
    def cycles(self, limit: int = 8) -> List[List[str]]:
        """Distinct cycles in the merged acquisition graph (site names)."""
        adj: Dict[str, List[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
        found: List[Tuple[str, ...]] = []

        def dfs(node: str, path: List[str], on_path: set) -> None:
            if len(found) >= limit:
                return
            for nxt in adj.get(node, ()):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    # canonicalize by rotating the smallest element first
                    body = cyc[:-1]
                    k = body.index(min(body))
                    canon = tuple(body[k:] + body[:k])
                    if canon not in {tuple(c[:-1]) for c in found}:
                        found.append(tuple(cyc))
                elif nxt not in visited:
                    visited.add(nxt)
                    on_path.add(nxt)
                    dfs(nxt, path + [nxt], on_path)
                    on_path.discard(nxt)

        visited: set = set()
        for start in sorted(adj):
            if start not in visited:
                visited.add(start)
                dfs(start, [start], {start})
        return [list(c) for c in found]

    def disarm(self) -> None:
        self.armed = False

    def report(self) -> Dict[str, Any]:
        cycles = self.cycles()
        with self._meta:
            return {
                "locks": sorted(set(
                    [a for a, _ in self.edges] + [b for _, b in self.edges]
                    + list(self.max_hold_ms))),
                "acquisitions": self.acquisitions,
                "edges": sorted(
                    [[a, b, n] for (a, b), n in self.edges.items()]),
                "cycles": cycles,
                "violations": list(self.violations),
                "warnings": list(self.warnings),
                "max_hold_ms": {k: round(v, 3)
                                for k, v in sorted(self.max_hold_ms.items())},
                "max_wait_ms": {k: round(v, 3)
                                for k, v in sorted(self.max_wait_ms.items())},
                "device_waits": dict(sorted(self.device_waits.items())),
                "ok": not cycles and not self.violations,
            }


class WatchedLock:
    """Drop-in ``threading.Lock``/``RLock`` wrapper feeding a watcher."""

    def __init__(self, watcher: LockWatcher, inner, site: str):
        self._watcher = watcher
        self._inner = inner
        self.site = site

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        t0 = time.perf_counter()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._watcher._acquired(self.site, time.perf_counter() - t0)
        return ok

    def release(self) -> None:
        self._watcher._released(self.site)
        self._inner.release()

    def __enter__(self) -> "WatchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()

    # RLock internals threading.Condition relies on when one is passed in
    def _is_owned(self):  # pragma: no cover - Condition(lock=...) path
        return self._inner._is_owned() if hasattr(self._inner, "_is_owned") \
            else self._inner.locked()


class WatchedCondition:
    """Drop-in ``threading.Condition`` wrapper.

    ``wait`` releases the underlying lock, so the held-stack entry is
    popped for the duration (otherwise every waiter would look like it
    holds the lock across its own sleep) and a wait entered while holding
    a DIFFERENT watched lock is recorded as a warning."""

    def __init__(self, watcher: LockWatcher, inner, site: str):
        self._watcher = watcher
        self._inner = inner
        self.site = site

    def acquire(self, *a, **k) -> bool:
        t0 = time.perf_counter()
        ok = self._inner.acquire(*a, **k)
        if ok:
            self._watcher._acquired(self.site, time.perf_counter() - t0)
        return ok

    def release(self) -> None:
        self._watcher._released(self.site)
        self._inner.release()

    def __enter__(self) -> "WatchedCondition":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def wait(self, timeout: Optional[float] = None) -> bool:
        self._watcher.note_cond_wait(self.site)
        self._watcher._released(self.site)
        try:
            return self._inner.wait(timeout)
        finally:
            self._watcher._acquired(self.site, 0.0)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        self._watcher.note_cond_wait(self.site)
        self._watcher._released(self.site)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._watcher._acquired(self.site, 0.0)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


def _creation_site(include: Sequence[str]) -> Optional[str]:
    """Site label for a lock created now, or None when the creating frame
    is outside the watched paths (stdlib, third-party, test machinery)."""
    f: Any = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if "lockwatch" not in fn and not fn.endswith("threading.py"):
            break
        f = f.f_back
    if f is None:
        return None
    fn = f.f_code.co_filename
    if not any(p in fn for p in include):
        return None
    parts = fn.replace(os.sep, "/").split("/")
    tail = "/".join(parts[-2:])
    return f"{tail}:{f.f_lineno}"


class _Patches:
    """Attribute patches undone exactly: an attribute a class only
    inherited is deleted again, not shadowed by its old value."""

    def __init__(self) -> None:
        self._undo: List[Tuple[Any, str, bool, Any]] = []

    def set(self, owner: Any, name: str, value: Any) -> None:
        own = name in getattr(owner, "__dict__", {})
        self._undo.append((owner, name, own, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self) -> None:
        for owner, name, own, old in reversed(self._undo):
            if own:
                setattr(owner, name, old)
            else:
                delattr(owner, name)
        self._undo.clear()


def _patch_device_waits(w: LockWatcher, patches: _Patches) -> None:
    """Route the port's device waits through ``w``: the designated wait
    (always), and, when torch is importable, the CUDA synchronizations
    and the blocking pulls of a tensor on the card."""
    from realtime_fraud_detection_tpu_torch.core import sync

    real_seam = sync.device_wait
    patches.set(sync, "device_wait",
                lambda event: w._device_wait(SEAM, real_seam, event))
    try:
        import torch
    except ImportError:            # the watcher's CPU-free unit use
        return

    real_sync = torch.cuda.synchronize
    patches.set(torch.cuda, "synchronize",
                lambda *a, **k: w._device_wait(
                    "torch.cuda.synchronize", lambda: real_sync(*a, **k)))
    for cls, what in ((torch.cuda.Event, "torch.cuda.Event.synchronize"),
                      (torch.cuda.Stream, "torch.cuda.Stream.synchronize")):
        real = cls.synchronize

        def _sync(self, _real=real, _what=what):
            return w._device_wait(_what, _real, self)

        patches.set(cls, "synchronize", _sync)
    for name in ("item", "cpu", "tolist"):
        real = getattr(torch.Tensor, name)

        def _pull(self, *a, _real=real, _what=f"Tensor.{name}", **k):
            if self.is_cuda:
                return w._device_wait(_what, lambda: _real(self, *a, **k))
            return _real(self, *a, **k)

        patches.set(torch.Tensor, name, _pull)


@contextmanager
def watch_locks(watcher: Optional[LockWatcher] = None,
                include: Sequence[str] = (PACKAGE_MARKER,),
                patch_device: bool = True) -> Iterator[LockWatcher]:
    """Instrument package lock creation (and the device waits) for the
    duration of the block. Locks created before the block keep their real
    identity; locks created inside it from non-watched paths do too."""
    w = watcher or LockWatcher()

    def _lock_factory():
        site = _creation_site(include)
        if site is None:
            return _REAL_LOCK()
        return WatchedLock(w, _REAL_LOCK(), site)

    def _rlock_factory():
        site = _creation_site(include)
        if site is None:
            return _REAL_RLOCK()
        return WatchedLock(w, _REAL_RLOCK(), site)

    def _cond_factory(lock=None):
        site = _creation_site(include)
        inner_lock = lock._inner if isinstance(lock, WatchedLock) else lock
        if site is None:
            return _REAL_CONDITION(inner_lock)
        return WatchedCondition(w, _REAL_CONDITION(inner_lock), site)

    threading.Lock = _lock_factory          # type: ignore[assignment]
    threading.RLock = _rlock_factory        # type: ignore[assignment]
    threading.Condition = _cond_factory     # type: ignore[assignment]
    patches = _Patches()
    try:
        if patch_device:
            _patch_device_waits(w, patches)
        yield w
    finally:
        threading.Lock = _REAL_LOCK         # type: ignore[assignment]
        threading.RLock = _REAL_RLOCK       # type: ignore[assignment]
        threading.Condition = _REAL_CONDITION  # type: ignore[assignment]
        patches.undo()
        w.disarm()


# ------------------------------------------------------------ drill harness

def run_drill_watched(drill: str, fast: bool = True, seed: int = 7,
                      device: str = "cuda") -> Dict[str, Any]:
    """Run one deterministic drill under the watcher; return
    ``{"drill", "drill_passed", "lockwatch": report}``.

    The drills that score on a device take ``device`` (the card unless
    ``"cpu"``); the host-only ones (shard, elastic, partition, obs, and
    the stand-in scorers of qos, trace and autotune) ignore it. Drills
    with a bit-identical second run do one pass: the lock and thread
    behaviour of the replay is the same, and the digest is the drill's
    own acceptance.
    """
    import contextlib
    import dataclasses
    import io

    if drill not in LOCKWATCH_DRILLS:
        raise ValueError(f"unknown drill {drill!r}; "
                         f"expected one of {LOCKWATCH_DRILLS}")
    if drill == "mesh-drill" and device != "cpu":
        # before CUDA starts in the process: the mesh's scores equal one
        # position's only with cuBLAS's split-K off
        from realtime_fraud_detection_tpu_torch.core.precision import (
            batch_invariant_blas,
        )

        batch_invariant_blas()
    sink = io.StringIO()
    with watch_locks() as w:
        with contextlib.redirect_stdout(sink):
            if drill == "qos-drill":
                from realtime_fraud_detection_tpu_torch.qos.drill import (
                    run_overload_drill,
                )

                s = run_overload_drill(seed=seed)
                passed = bool(s.get("p99_within_budget"))
            elif drill == "trace-drill":
                from realtime_fraud_detection_tpu_torch.obs.trace_drill import (
                    TraceDrillConfig,
                    run_trace_drill,
                )

                cfg = (TraceDrillConfig.fast() if fast
                       else TraceDrillConfig())
                passed = bool(run_trace_drill(cfg)["passed"])
            elif drill == "autotune-drill":
                from realtime_fraud_detection_tpu_torch.tuning.drill import (
                    AutotuneDrillConfig,
                    run_autotune_drill,
                )

                cfg = (AutotuneDrillConfig.fast() if fast
                       else AutotuneDrillConfig())
                passed = bool(run_autotune_drill(cfg)["passed"])
            elif drill == "feedback-drill":
                from realtime_fraud_detection_tpu_torch.feedback.drill import (
                    FeedbackDrillConfig,
                    run_feedback_drill,
                )

                cfg = (FeedbackDrillConfig.fast() if fast
                       else FeedbackDrillConfig())
                cfg = dataclasses.replace(cfg, device=device)
                passed = bool(run_feedback_drill(cfg)["passed"])
            elif drill == "pool-drill":
                from realtime_fraud_detection_tpu_torch.scoring.pool_drill import (
                    PoolDrillConfig,
                    run_pool_drill,
                )

                cfg = PoolDrillConfig.fast() if fast else PoolDrillConfig()
                passed = bool(run_pool_drill(cfg, device=device)["passed"])
            elif drill == "chaos-drill":
                from realtime_fraud_detection_tpu_torch.chaos.drill import (
                    ChaosDrillConfig,
                    run_chaos_drill,
                )

                cfg = dataclasses.replace(
                    ChaosDrillConfig.fast() if fast else ChaosDrillConfig(),
                    replay_check=False, device=device)
                passed = bool(run_chaos_drill(cfg)["passed"])
            elif drill == "shard-drill":
                from realtime_fraud_detection_tpu_torch.cluster.drill import (
                    ShardDrillConfig,
                    run_shard_drill,
                )

                # the oracle run inside still executes (it IS a check)
                cfg = dataclasses.replace(
                    ShardDrillConfig.fast() if fast else ShardDrillConfig(),
                    replay_check=False)
                passed = bool(run_shard_drill(cfg)["passed"])
            elif drill == "mesh-drill":
                from realtime_fraud_detection_tpu_torch.scoring.mesh_drill import (
                    MeshDrillConfig,
                    run_mesh_drill,
                )

                cfg = dataclasses.replace(
                    MeshDrillConfig.fast() if fast else MeshDrillConfig(),
                    replay_check=False, device=device)
                passed = bool(run_mesh_drill(cfg)["passed"])
            elif drill == "elastic-drill":
                from realtime_fraud_detection_tpu_torch.cluster.elastic_drill import (
                    ElasticDrillConfig,
                    run_elastic_drill,
                )

                # the watcher instruments THIS process — the coordinator,
                # broker server and handoff server threads; the worker
                # processes run their own interpreters and are covered by
                # the drill's checks
                cfg = dataclasses.replace(
                    ElasticDrillConfig.fast() if fast
                    else ElasticDrillConfig(),
                    replay_check=False)
                passed = bool(run_elastic_drill(cfg)["passed"])
            elif drill == "partition-drill":
                from realtime_fraud_detection_tpu_torch.chaos.partition_drill import (
                    PartitionDrillConfig,
                    run_partition_drill,
                )

                # the link-faulted clients live inside the worker processes
                cfg = dataclasses.replace(
                    PartitionDrillConfig.fast() if fast
                    else PartitionDrillConfig(),
                    replay_check=False)
                passed = bool(run_partition_drill(cfg)["passed"])
            elif drill == "graph-drill":
                from realtime_fraud_detection_tpu_torch.graph.drill import (
                    GraphDrillConfig,
                    run_graph_drill,
                )

                # the in-process worker fleet, the typed stores' locks and
                # the graph-fetch TCP server threads are all watched here
                cfg = dataclasses.replace(
                    GraphDrillConfig.fast() if fast
                    else GraphDrillConfig(),
                    replay_check=False, device=device)
                passed = bool(run_graph_drill(cfg)["passed"])
            elif drill == "kernel-drill":
                from realtime_fraud_detection_tpu_torch.scoring.kernel_drill import (
                    KernelDrillConfig,
                    run_kernel_drill,
                )

                cfg = dataclasses.replace(
                    KernelDrillConfig.fast() if fast
                    else KernelDrillConfig(),
                    replay=False, device=device)
                passed = bool(run_kernel_drill(cfg)["passed"])
            else:   # obs-drill
                from realtime_fraud_detection_tpu_torch.obs.obs_drill import (
                    ObsDrillConfig,
                    run_obs_drill,
                )

                # the coordinator's fleet-metrics fold and trace stitching
                # and the broker / handoff server threads are watched here;
                # the tracers live inside the worker processes. One retry
                # absorbs a wall-clock scheduling stall on a loaded host
                # (the drill's p99 attribution and overhead ratio are
                # real-time measurements over real OS processes); a retried
                # pass still proves the lock story, a double failure fails
                cfg = dataclasses.replace(
                    ObsDrillConfig.fast() if fast else ObsDrillConfig(),
                    replay_check=False)
                passed = bool(run_obs_drill(cfg)["passed"]) \
                    or bool(run_obs_drill(cfg)["passed"])
    return {"drill": drill, "drill_passed": passed, "lockwatch": w.report()}
