"""Overlapped host assembly: two-stage software pipelining of the seam.

Port of the JAX package's ``scoring/host_pipeline.py``:

    stage 1 (the stage's thread): assemble + pad / pack + launch batch N+1
    stage 2 (the caller's thread): wait for batch N's result, write back

``AssemblerStage`` owns one daemon thread and a bounded FIFO queue.
``submit`` enqueues a record batch and returns an ``AssembledHandle`` at
once; the thread runs ``scorer.assemble`` + ``scorer.dispatch_assembled``
in submit order, so while the caller waits out batch N's device time in
``finalize``, batch N+1 is being assembled. The queue bound is the pipeline
depth: a slow card backpressures ``submit``.

Ordering and state contract:

- batches dispatch in submit order (one thread, FIFO), so scoring, fan-out
  and offset commits are never reordered;
- ``lock`` serializes the scorer's host state: the stage holds it across
  assemble + dispatch, and callers pass it to ``scorer.finalize`` so a
  write-back never interleaves with an assembly; the device wait is
  outside the lock, which is the window the overlap lives in;
- every launch of a card kernel happens on the stage thread (``finalize``
  launches nothing), so the scorer's before / after reading of the
  process-wide launch counters sees only its own batch, its kernel
  counters are written by that thread alone (the span timer takes its own
  lock), and the result's CUDA event is recorded on the stage thread's
  stream, which ran it. The thread makes the scorer's card its current
  device first: PyTorch keeps the current device per thread. ``finalize``
  reads nothing from the card but the batch's own result, so it never
  waits on a batch the stage has queued behind it;
- velocity and history staleness is the pipeline-depth tradeoff of
  ``stream/job.py``, but which write-backs land before an assembly now
  depends on timing, so the job keeps overlap opt-in
  (``JobConfig.overlap_assembly``).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, List, Mapping, Optional, Sequence

import torch

__all__ = ["AssembledHandle", "AssemblerStage"]


class AssembledHandle:
    """Future for one submitted batch: resolves to a ``PendingScore``."""

    __slots__ = ("_event", "_pending", "_exc")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._pending: Any = None
        self._exc: Optional[BaseException] = None

    def _set(self, pending: Any) -> None:
        self._pending = pending
        self._event.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until the batch is assembled and dispatched; returns the
        ``PendingScore`` or re-raises the stage's error."""
        if not self._event.wait(timeout):
            raise TimeoutError("assembled batch not ready")
        if self._exc is not None:
            raise self._exc
        return self._pending


class AssemblerStage:
    """Background assemble + dispatch stage over one ``TorchFraudScorer``.

    Pass ``lock`` to ``scorer.finalize(..., lock=stage.lock)`` so
    write-backs serialize against assemblies.
    """

    def __init__(self, scorer, depth: int = 2):
        self.scorer = scorer
        self.lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # seconds the stage spent assembling and dispatching, and batches
        self.busy_s = 0.0
        self.batches = 0
        # the card the stage thread launches on: the scorer's, else the
        # caller's current one
        device = getattr(scorer, "device", None)
        self._cuda_index: Optional[int] = None
        if isinstance(device, torch.device) and device.type == "cuda":
            self._cuda_index = (device.index if device.index is not None
                                else torch.cuda.current_device())

    # ------------------------------------------------------------ lifecycle
    def _ensure_started(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="host-assembler", daemon=True)
            self._thread.start()

    def close(self) -> None:
        """Drain and stop the stage thread (idempotent)."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=30.0)
            self._thread = None

    # --------------------------------------------------------------- submit
    def submit(self, records: Sequence[Mapping[str, Any]],
               now: Optional[float] = None,
               trace: Optional[Any] = None) -> AssembledHandle:
        """Enqueue one microbatch for background assembly and dispatch;
        blocks while ``depth`` batches are queued. The handle resolves in
        FIFO order. ``trace`` (an ``obs.tracing.TraceBatch``) rides the
        queue item, so the stage thread's marks land on the batch being
        assembled (attached by identity, not timing)."""
        if self._closed:
            raise RuntimeError("assembler stage is closed")
        self._ensure_started()
        handle = AssembledHandle()
        self._q.put((list(records), now, handle, trace))
        return handle

    def finalize(self, handle: AssembledHandle,
                 now: Optional[float] = None) -> List[dict]:
        """Resolve a handle and finalize under the stage lock."""
        pending = handle.result()
        return self.scorer.finalize(pending, now=now, lock=self.lock)

    # ----------------------------------------------------------------- run
    def _run(self) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        while True:
            item = self._q.get()
            if item is None:
                return
            records, now, handle, trace = item
            t0 = time.perf_counter()
            try:
                with self.lock:
                    # the trace kwarg only when tracing is live, as the job
                    # passes it: a scorer need not know the argument
                    kw = {"trace": trace} if trace is not None else {}
                    if trace is not None:
                        trace.mark("assemble")
                    batch = self.scorer.assemble(records, now)
                    pending = self.scorer.dispatch_assembled(batch, records, t0=t0,
                                                             **kw)
            except BaseException as e:  # noqa: BLE001 - surfaces at result()
                # count the batch before resolving its handle: a caller that
                # reads busy_s after the last result() sees every batch
                self.busy_s += time.perf_counter() - t0
                self.batches += 1
                handle._set_exception(e)
            else:
                self.busy_s += time.perf_counter() - t0
                self.batches += 1
                handle._set(pending)
