"""Ingress gateway: many producer threads -> lock-free queue -> one sender.

Port of the JAX package's ``stream/gateway.py``. The reference's ingest
edge is payment gateways POSTing into Kafka through librdkafka's background
sender thread; here application threads call ``submit(txn)`` — a lock-free
MPMC push into the C++ microbatch queue (``native/``) that never blocks on
the network — while one background sender drains deadline batches and
produces them to any broker behind the transport contract (in-memory or
``NetBrokerClient``). When the native library is unavailable (no g++, or
``RTFD_DISABLE_NATIVE=1``) the gateway degrades to a locked deque with the
same semantics; ``gateway.native`` says which queue it used.

Delivery: at-least-once from the ``submit()`` caller's side once
``flush()`` returns — the sender retries a failed ``produce_batch`` once and
counts drops otherwise (backpressure surfaces as ``submit() == False`` when
the ring is full, so callers can shed or spin). With a live ``Tracer`` each
submitted transaction carries a root trace carrier (``Tracer.root_carrier``)
minted at submit.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Callable, Mapping, Optional

__all__ = ["IngressGateway"]


class _DequeFallback:
    """Locked-deque stand-in with the native queue's push/next_batch API
    (including the max_batch bound, so batch-size tuning behaves the same
    on both backends)."""

    def __init__(self, capacity: int, max_batch: int):
        self._dq: collections.deque = collections.deque()
        self._capacity = capacity
        self._max_batch = max_batch
        self._lock = threading.Lock()

    def push(self, payload: bytes) -> bool:
        with self._lock:
            if len(self._dq) >= self._capacity:
                return False
            self._dq.append(payload)
            return True

    def next_batch(self, block_ms: int = 0) -> list:
        # rtfd-lint: allow[wall-clock] real network/backpressure pacing
        deadline = time.monotonic() + block_ms / 1000.0
        while True:
            with self._lock:
                if self._dq:
                    out = [self._dq.popleft()
                           for _ in range(min(len(self._dq),
                                              self._max_batch))]
                    return out
            # rtfd-lint: allow[wall-clock] real network/backpressure pacing
            if time.monotonic() >= deadline:
                return []
            time.sleep(0.001)

    def pending(self) -> int:
        with self._lock:
            return len(self._dq)

    def close(self) -> None:
        pass


class IngressGateway:
    """Thread-safe transaction ingress in front of a broker."""

    def __init__(self, broker: Any, topic: str,
                 key_fn: Optional[Callable[[Mapping[str, Any]], str]] = None,
                 capacity: int = 8192, max_batch: int = 512,
                 max_delay_ms: float = 5.0, stamp_ingest: bool = False,
                 tracer: Optional[Any] = None):
        self.broker = broker
        self.topic = topic
        self.key_fn = key_fn or (lambda r: str(r.get("user_id", "")))
        self.max_batch = max_batch
        self.max_delay_ms = max_delay_ms
        # tracing support: stamp each submitted txn with the wall-clock
        # instant it entered THIS process (``ingest_ts``), so the tracing
        # plane's ``ingest`` stage covers the gateway ring + sender +
        # broker hop, not just broker-to-admission. Off by default — the
        # stamp adds a field to every produced record.
        self.stamp_ingest = bool(stamp_ingest)
        # distributed tracing: with a Tracer attached (obs/tracing.py),
        # every submitted txn additionally carries a root trace carrier
        # (trace id + this process's origin + produce wall stamp) that
        # the consuming worker re-hydrates — the consume-side wall stamp
        # minus this one IS the broker_transit stage
        self.tracer = tracer if tracer is not None \
            and getattr(tracer, "enabled", False) else None
        self.sent = 0
        self.dropped = 0
        self.native = False
        try:
            from realtime_fraud_detection_tpu_torch.native import (
                NativeMicrobatchQueue,
                native_available,
            )

            if native_available():
                self._q: Any = NativeMicrobatchQueue(
                    capacity=capacity, slot_bytes=8192,
                    max_batch=max_batch, max_delay_ms=max_delay_ms)
                self.native = True
                self._slot_bytes = 8192
            else:
                self._q = _DequeFallback(capacity, max_batch)
                self._slot_bytes = None
        except Exception:  # noqa: BLE001 — build toolchain absent
            self._q = _DequeFallback(capacity, max_batch)
            self._slot_bytes = None
        self._stop = threading.Event()
        self._idle = threading.Event()
        self._thread = threading.Thread(
            target=self._sender, name="ingress-gateway", daemon=True)
        self._thread.start()

    # ---------------------------------------------------------------- submit
    def submit(self, txn: Mapping[str, Any]) -> bool:
        """Lock-free enqueue from any thread. False == ring full —
        backpressure, NOT a drop: the caller sheds or retries, and the
        ``dropped`` counter only ever counts records actually lost."""
        if self.stamp_ingest or self.tracer is not None:
            txn = dict(txn)
            # rtfd-lint: allow[wall-clock] ingest stamp is wall-clock by contract (broker-lag attribution)
            now_wall = time.time()
            if self.stamp_ingest:
                txn["ingest_ts"] = now_wall
            if self.tracer is not None:
                carrier = self.tracer.root_carrier(produced_ts=now_wall)
                if carrier is not None:
                    txn["trace_carrier"] = carrier
        payload = json.dumps(txn, separators=(",", ":")).encode()
        if self._slot_bytes is not None and len(payload) > self._slot_bytes:
            # oversized for a ring slot: drain what's queued first so this
            # thread's per-key ordering survives, then produce directly
            self.flush()
            self.broker.produce(self.topic, dict(txn), key=self.key_fn(txn))
            self.sent += 1
            return True
        ok = self._q.push(payload)
        if ok:
            self._idle.clear()
        return ok

    # ---------------------------------------------------------------- sender
    def _sender(self) -> None:
        while not self._stop.is_set():
            batch = self._q.next_batch(block_ms=int(self.max_delay_ms))
            if not batch:
                self._idle.set()
                continue
            records = [json.loads(p) for p in batch]
            try:
                self.broker.produce_batch(self.topic, records,
                                          key_fn=self.key_fn)
            except Exception:  # noqa: BLE001 — one retry, then count drops
                try:
                    time.sleep(0.05)
                    self.broker.produce_batch(self.topic, records,
                                              key_fn=self.key_fn)
                except Exception:  # noqa: BLE001
                    self.dropped += len(records)
                    continue
            self.sent += len(records)

    def flush(self, timeout_s: float = 30.0) -> bool:
        """Block until everything submitted so far has been produced."""
        # rtfd-lint: allow[wall-clock] real network/backpressure pacing
        deadline = time.monotonic() + timeout_s
        # rtfd-lint: allow[wall-clock] real network/backpressure pacing
        while time.monotonic() < deadline:
            if self._q.pending() == 0 and self._idle.is_set():
                return True
            time.sleep(0.005)
        return False

    def close(self, timeout_s: float = 30.0) -> None:
        if not self.flush(timeout_s):
            # shutdown with the broker wedged: whatever is still in the
            # ring is lost when the queue is destroyed — count it
            self.dropped += self._q.pending()
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._q.close()
