"""Replicated scoring pool: N replicas of the scorer's models, each with its
own CUDA stream and in-flight queue.

Port of the JAX package's ``scoring/device_pool.py``. A replica is a
``torch.device`` plus a ``torch.cuda.Stream`` of its own; ``devices=None``
means every visible card (on one H100 a pool of one; a scorer on the CPU
gets a pool of one on the CPU); a list may name one card more than once, and
then N replicas share the card, each launching on its own stream (this is
how the drill and the tests get N replicas); the CPU takes ``["cpu"] * N``.
Replicas on the same device share one set of parameter tensors: the scorer's
own on its device, one copy per other device.

- ``dispatch_packed`` picks a replica round-robin (strict rotation over the
  healthy ones, so the schedule is deterministic), copies the packed host
  blobs to its device from pinned memory, runs the scorer's fused program
  (``TorchFraudScorer.launch_packed``: the megakernel or the per-site
  chain) and starts the copy of the result back behind a CUDA event, all
  under ``torch.cuda.stream(replica.stream)``, which first waits for the
  work queued on the caller's stream (parameters copied by ``set_models``);
- at most ``inflight_depth`` batches ride each replica; a full replica
  blocks the dispatcher, and the wait is recorded as queue wait;
- completion order is the caller's: ``TorchFraudScorer.finalize`` waits on
  batches in dispatch order, so FIFO holds by construction;
- a replica whose result fetch fails is marked unhealthy and its batch is
  relaunched from the token's numpy blob copies (never from freed pinned
  buffers) on the least-loaded healthy replica, bypassing the depth bound
  (the caller may be the only thread draining the pool); counted as a
  retry;
- ``set_models`` swaps the models replica by replica; a batch in flight
  keeps the models, ensemble parameters and megakernel arguments it was
  launched with (``PoolToken.launched_with``) until its event completed,
  so no batch sees mixed parameters;
- the branch-validity mask is snapshotted per dispatch
  (``PoolToken.model_valid``): every launch passes the scorer's current
  host mask, so a QoS step fans out to every replica at once and a batch
  in flight (or its relaunch) keeps its own rung. JAX's ``_Replica.mv_dev``
  keeps a device copy; the port's kernels read the rung as host flags, so
  there is none.

A fault is injected on the host, at the result fetch (``inject_fault``): a
real CUDA fault poisons the whole context, so the rescue path cannot be
shown with one. ``inject_slow`` delays a replica's fetches; ``revive``
readmits a replica. JAX's ``donate`` (an XLA buffer-aliasing switch) has no
PyTorch counterpart and is left out, as is ``complete_no_fetch``, which
exists for the JAX benchmark's ``pool_scaling`` stage.

Bit-equality: a pooled batch runs the same launches on the same inputs, on
another stream, so scores are bit-identical to unpooled scoring on the same
device (``pool-drill`` pins it).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.core import sync

__all__ = ["DevicePool", "PoolToken"]


class PoolToken:
    """One pooled batch in flight: the host result and its event, and what
    a relaunch on another replica needs."""

    __slots__ = ("out", "event", "replica_idx", "blobs", "spec", "params",
                 "model_valid", "static", "inflight_at_dispatch",
                 "launched_with", "launches")

    def __init__(self, replica_idx, blobs, spec, params, model_valid, static,
                 inflight_at_dispatch=0):
        self.out = None
        self.event = None
        self.replica_idx = replica_idx
        self.blobs = blobs                  # host numpy copies (retry source)
        self.spec = spec
        self.params = params
        self.model_valid = model_valid      # host bool[M] snapshot
        self.static = static                # the kernel selection at dispatch
        # the replica's queue depth (this batch included) at assignment
        self.inflight_at_dispatch = inflight_at_dispatch
        # (models, ensemble params, megakernel arguments, the previous
        # launch's tuple or None) of the launch in flight, held until its
        # event has completed
        self.launched_with = None
        # hand-written kernel launches of this batch, rescues included
        self.launches = 0


class _Replica:
    """One replica: its device, its stream and its dispatch bookkeeping."""

    def __init__(self, idx: int, device: torch.device):
        self.idx = idx
        self.device = device
        # replicas sharing a card are told apart by index
        self.name = f"{device}#{idx}"
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.healthy = True
        self.inflight = 0
        self.dispatched = 0
        self.completed = 0
        self.retries = 0            # batches rescued onto this replica
        self.failures = 0           # fetch failures observed on this replica
        self.queue_wait_s = 0.0
        self.fail_next = 0          # injected faults (inject_fault)
        self.slow_next = 0          # injected delays (inject_slow)
        self.slow_s = 0.0


class _DeviceModels:
    """The models one device's replicas launch with, the ensemble
    parameters moved there, and the megakernel's parameter arguments for
    them (built at the first megakernel batch)."""

    def __init__(self, models):
        self.models = models
        self.mega_args = None
        self._params: Optional[tuple] = None     # (source, moved)

    def params_on(self, params, device: torch.device):
        cached = self._params
        if cached is None or cached[0] is not params:
            self._params = cached = (params, params.to(device))
        return cached[1]


class DevicePool:
    """Round-robin replicated dispatch over ``devices``.

    ``inflight_depth`` is per replica (2 keeps a replica's work back to back:
    one batch running while the next one's copies queue). Thread-safe:
    dispatch and completion may come from different threads.
    """

    def __init__(self, scorer, devices: Optional[Sequence] = None,
                 inflight_depth: int = 2):
        self.scorer = scorer
        if devices is None:
            if scorer.device.type == "cuda":
                devs = [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
            else:
                devs = [scorer.device]
        else:
            devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("device pool needs at least one device")
        if any(d.type == "cuda" for d in devs) and not torch.cuda.is_available():
            raise RuntimeError("device pool: no CUDA device available")
        devs = [self._resolve(d) for d in devs]
        self.inflight_depth = max(1, int(inflight_depth))
        self._cv = threading.Condition()
        self.replicas = [_Replica(i, d) for i, d in enumerate(devs)]
        self._home = self._resolve(scorer.device)
        self._models: Dict[torch.device, _DeviceModels] = {}
        self._place(scorer.models)
        self._rr = 0
        # replica assignments in dispatch order (rescues included): the
        # drill replays the real schedule on its virtual timeline
        self.assignment_log: deque = deque(maxlen=4096)
        scorer.attach_pool(self)

    @staticmethod
    def _resolve(device: torch.device) -> torch.device:
        if device.type == "cuda" and device.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return device

    def _place(self, models) -> None:
        """One model set per device: the scorer's own tensors on its device,
        a copy on every other."""
        placed = {}
        for dev in dict.fromkeys(r.device for r in self.replicas):
            placed[dev] = _DeviceModels(models if dev == self._home
                                        else models.to(dev))
        with self._cv:
            self._models = placed

    # ------------------------------------------------------------- capacity
    def __len__(self) -> int:
        return len(self.replicas)

    @property
    def healthy_count(self) -> int:
        return sum(1 for r in self.replicas if r.healthy)

    def total_slots(self) -> int:
        """Batches in flight across the healthy replicas: what the stream's
        and the service's pipeline depth rise to, so every replica gets
        work."""
        return max(1, self.healthy_count * self.inflight_depth)

    # ------------------------------------------------------------- dispatch
    def _pick_replica(self) -> tuple:
        """Round-robin over healthy replicas; blocks (queue wait) while the
        chosen one is at depth. Returns (replica, its depth with this
        batch), the depth read under the lock."""
        with self._cv:
            n = len(self.replicas)
            for off in range(n):
                rep = self.replicas[(self._rr + off) % n]
                if rep.healthy:
                    self._rr = (self._rr + off + 1) % n
                    break
            else:
                raise RuntimeError("device pool has no healthy replicas")
            # rtfd-lint: allow[wall-clock] queue-wait/dispatch diagnostics (host stats), not control flow
            t0 = time.perf_counter()
            while rep.inflight >= self.inflight_depth:
                if not self._cv.wait(timeout=120.0):
                    raise TimeoutError(
                        f"replica {rep.idx} stuck at inflight depth "
                        f"{rep.inflight} for 120s")
                if not rep.healthy:     # died while we waited: pick again
                    return self._pick_replica()
            # rtfd-lint: allow[wall-clock] queue-wait/dispatch diagnostics (host stats), not control flow
            rep.queue_wait_s += time.perf_counter() - t0
            rep.inflight += 1
            rep.dispatched += 1
            self.assignment_log.append(rep.idx)
            return rep, rep.inflight

    def _launch(self, rep: _Replica, token: PoolToken) -> None:
        """Launch ``token``'s batch on ``rep``: on its stream, after the
        work queued on the caller's stream, with the replica's models."""
        with self._cv:
            placed = self._models[rep.device]   # a hot swap never tears it
        models = placed.models
        params = (token.params if rep.device == self._home
                  else placed.params_on(token.params, rep.device))
        mega_args = None
        if token.static.get("mega_valid") is not None:
            if placed.mega_args is None:
                placed.mega_args = self.scorer.mega_param_args_for(models, rep.device)
            mega_args = placed.mega_args
        if rep.stream is not None:
            rep.stream.wait_stream(torch.cuda.current_stream(rep.device))
            ctx = torch.cuda.stream(rep.stream)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            out, event, launches = self.scorer.launch_packed(
                token.blobs, token.spec, token.model_valid, token.static, rep.device,
                models, params, mega_args)
        token.out, token.event = out, event
        # a rescue keeps the failed launch's references too (its kernels may
        # still be reading them on the other stream) until the token resolves
        token.launched_with = (models, params, mega_args, token.launched_with)
        token.launches += launches

    def dispatch_packed(self, blobs: Dict[str, np.ndarray], spec, params,
                        model_valid: np.ndarray,
                        static: Dict[str, Any]) -> PoolToken:
        """Copy and launch one packed microbatch on the next replica without
        waiting for it; blocks only while that replica is at depth."""
        rep, depth = self._pick_replica()
        host_blobs = {k: v for k, v in blobs.items() if v is not None}
        token = PoolToken(rep.idx, host_blobs, spec, params,
                          # rtfd-lint: allow[d2h] host bool[M] validity mask, never a device array
                          np.array(model_valid, bool), dict(static),
                          inflight_at_dispatch=depth)
        try:
            self._launch(rep, token)
        except Exception:
            # a launch failure is a replica failure too: free the slot and
            # mark it; the caller's dispatch raises
            self._mark_failed(rep)
            raise
        return token

    # ------------------------------------------------------------ completion
    def _mark_failed(self, rep: _Replica) -> None:
        with self._cv:
            rep.failures += 1
            rep.healthy = False
            rep.inflight = max(0, rep.inflight - 1)
            self._cv.notify_all()

    def _release(self, rep: _Replica) -> None:
        with self._cv:
            rep.inflight = max(0, rep.inflight - 1)
            rep.completed += 1
            self._cv.notify_all()

    def _fetch(self, rep: _Replica, token: PoolToken):
        """Wait for the batch's result on ``rep``; an armed fault raises
        here, at the fetch."""
        with self._cv:
            if rep.fail_next > 0:
                rep.fail_next -= 1
                raise RuntimeError(f"injected device fault on replica {rep.idx}")
        sync.device_wait(token.event)
        return token.out

    def wait(self, token: PoolToken):
        """Block on a pooled batch's host result; when its replica fails,
        relaunch the batch from its host blobs on the least-loaded healthy
        replica and wait again. Raises when no healthy replica is left."""
        for _ in range(len(self.replicas) + 1):
            rep = self.replicas[token.replica_idx]
            self._maybe_slow(rep)
            try:
                out = self._fetch(rep, token)
            except Exception:
                self._mark_failed(rep)
                # the rescue bypasses the depth bound: with every healthy
                # replica at full depth and one draining thread, waiting for
                # a slot here would deadlock. A rescue replica whose own
                # launch fails is marked too, and the next is tried.
                while True:
                    with self._cv:
                        candidates = [r for r in self.replicas if r.healthy]
                        if not candidates:
                            raise
                        retry = min(candidates, key=lambda r: r.inflight)
                        retry.inflight += 1
                        retry.dispatched += 1
                        retry.retries += 1
                        self.assignment_log.append(retry.idx)
                    try:
                        self._launch(retry, token)
                    except Exception:
                        self._mark_failed(retry)
                        continue
                    token.replica_idx = retry.idx
                    break
                continue
            token.launched_with = None
            self._release(rep)
            return out
        raise RuntimeError("device pool retry budget exhausted")

    # -------------------------------------------------------------- control
    def set_models(self, models) -> None:
        """Fan a model swap out (``models`` on the scorer's device; callers
        hold the score lock). A batch in flight keeps the models it captured
        at launch."""
        self._place(models)

    def inject_fault(self, replica_idx: int, n: int = 1) -> None:
        """Make the next ``n`` result fetches on a replica raise (the rescue
        path without a real device loss)."""
        with self._cv:
            self.replicas[replica_idx].fail_next += n

    def inject_slow(self, replica_idx: int, delay_s: float, n: int = 1) -> None:
        """Make the next ``n`` result fetches on a replica take ``delay_s``
        longer: a delayed replica, not a dead one (no retry, no health
        change; FIFO completion must hold)."""
        with self._cv:
            rep = self.replicas[replica_idx]
            rep.slow_next += max(0, int(n))
            # rtfd-lint: allow[d2h] delay_s is a host scalar argument, not a device value
            rep.slow_s = float(delay_s)

    def _maybe_slow(self, rep: _Replica) -> None:
        """An injected delay, slept outside the lock (a stalled fetch must
        not block dispatch to the other replicas)."""
        if rep.slow_next <= 0:          # unarmed: no lock on the hot path
            return
        with self._cv:
            if rep.slow_next <= 0:
                return
            rep.slow_next -= 1
            delay = rep.slow_s
        time.sleep(delay)

    def revive(self, replica_idx: int) -> None:
        """Readmit a failed replica; faults and delays still armed on it are
        cleared (a stale arm must not kill it again)."""
        with self._cv:
            rep = self.replicas[replica_idx]
            rep.healthy = True
            rep.fail_next = 0
            rep.slow_next = 0
            self._cv.notify_all()

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        """Per-replica counters (``MetricsCollector.sync_device_pool``)."""
        with self._cv:
            per_device: List[Dict[str, Any]] = [{
                "device": rep.name,
                "index": rep.idx,
                "healthy": rep.healthy,
                "dispatched": rep.dispatched,
                "completed": rep.completed,
                "inflight": rep.inflight,
                "retries": rep.retries,
                "failures": rep.failures,
                "queue_wait_ms": round(rep.queue_wait_s * 1e3, 3),
            } for rep in self.replicas]
        return {
            "devices": per_device,
            "n_devices": len(self.replicas),
            "healthy": sum(1 for d in per_device if d["healthy"]),
            "inflight_depth": self.inflight_depth,
            "dispatched": sum(d["dispatched"] for d in per_device),
            "completed": sum(d["completed"] for d in per_device),
            "retries": sum(d["retries"] for d in per_device),
        }
