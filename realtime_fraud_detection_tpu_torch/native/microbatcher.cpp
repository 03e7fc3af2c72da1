// Native microbatcher: lock-free MPMC ring buffer + deadline batch assembler.
//
// A copy of the JAX package's native/microbatcher.cpp: the reference's
// latency-critical data plane (the Flink netty shuffle + the TF-Serving
// batching config that was never wired, reference
// k8s/manifests/ml-models-deployment.yaml:270-290). Producers are
// ingest threads (transport consumers / HTTP handlers); the single logical
// consumer is the scoring loop, which drains fixed-deadline microbatches into
// pinned host buffers for device transfer.
//
// Queue algorithm: bounded MPMC with per-slot sequence counters (Vyukov).
// Each push/pop is one CAS + one release store; no locks anywhere on the
// hot path. Batch close condition mirrors stream/microbatch.py: size reached
// OR max_delay elapsed since the oldest pending record.
//
// C ABI only (consumed via ctypes; pybind11 is not in this image).

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <thread>

namespace {

using Clock = std::chrono::steady_clock;

struct Slot {
  std::atomic<uint64_t> seq;
  uint32_t len;
  double enq_time;  // seconds since queue creation
  char *payload;
};

struct Queue {
  Slot *slots;
  size_t capacity;       // power of two
  size_t slot_bytes;     // max payload per record
  size_t max_batch;
  double max_delay_s;
  Clock::time_point t0;
  alignas(64) std::atomic<uint64_t> head;  // next push ticket
  alignas(64) std::atomic<uint64_t> tail;  // next pop ticket
  alignas(64) std::atomic<uint64_t> batches;
  std::atomic<uint64_t> records;
  std::atomic<uint64_t> dropped;

  double now() const {
    return std::chrono::duration<double>(Clock::now() - t0).count();
  }
};

size_t round_pow2(size_t v) {
  size_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

void *mb_create(size_t capacity, size_t slot_bytes, size_t max_batch,
                double max_delay_ms) {
  auto *q = new Queue();
  q->capacity = round_pow2(capacity < 2 ? 2 : capacity);
  q->slot_bytes = slot_bytes;
  q->max_batch = max_batch;
  q->max_delay_s = max_delay_ms / 1000.0;
  q->t0 = Clock::now();
  q->slots = new Slot[q->capacity];
  for (size_t i = 0; i < q->capacity; ++i) {
    q->slots[i].seq.store(i, std::memory_order_relaxed);
    q->slots[i].payload = new char[slot_bytes];
    q->slots[i].len = 0;
  }
  q->head.store(0, std::memory_order_relaxed);
  q->tail.store(0, std::memory_order_relaxed);
  q->batches.store(0, std::memory_order_relaxed);
  q->records.store(0, std::memory_order_relaxed);
  q->dropped.store(0, std::memory_order_relaxed);
  return q;
}

void mb_destroy(void *handle) {
  auto *q = static_cast<Queue *>(handle);
  for (size_t i = 0; i < q->capacity; ++i) delete[] q->slots[i].payload;
  delete[] q->slots;
  delete q;
}

// 0 = ok, -1 = queue full, -2 = payload too large.
int mb_push(void *handle, const char *data, uint32_t len) {
  auto *q = static_cast<Queue *>(handle);
  if (len > q->slot_bytes) return -2;
  uint64_t pos = q->head.load(std::memory_order_relaxed);
  for (;;) {
    Slot &s = q->slots[pos & (q->capacity - 1)];
    uint64_t seq = s.seq.load(std::memory_order_acquire);
    intptr_t dif = (intptr_t)seq - (intptr_t)pos;
    if (dif == 0) {
      if (q->head.compare_exchange_weak(pos, pos + 1,
                                        std::memory_order_relaxed)) {
        std::memcpy(s.payload, data, len);
        s.len = len;
        s.enq_time = q->now();
        s.seq.store(pos + 1, std::memory_order_release);
        return 0;
      }
    } else if (dif < 0) {
      q->dropped.fetch_add(1, std::memory_order_relaxed);
      return -1;  // full
    } else {
      pos = q->head.load(std::memory_order_relaxed);
    }
  }
}

// Pop exactly one record if available. Returns len, or -1 if empty.
static int pop_one(Queue *q, char *out, double *enq_time) {
  uint64_t pos = q->tail.load(std::memory_order_relaxed);
  for (;;) {
    Slot &s = q->slots[pos & (q->capacity - 1)];
    uint64_t seq = s.seq.load(std::memory_order_acquire);
    intptr_t dif = (intptr_t)seq - (intptr_t)(pos + 1);
    if (dif == 0) {
      if (q->tail.compare_exchange_weak(pos, pos + 1,
                                        std::memory_order_relaxed)) {
        uint32_t len = s.len;
        std::memcpy(out, s.payload, len);
        if (enq_time) *enq_time = s.enq_time;
        s.seq.store(pos + q->capacity, std::memory_order_release);
        return (int)len;
      }
    } else if (dif < 0) {
      return -1;  // empty
    } else {
      pos = q->tail.load(std::memory_order_relaxed);
    }
  }
}

size_t mb_pending(void *handle) {
  auto *q = static_cast<Queue *>(handle);
  uint64_t h = q->head.load(std::memory_order_acquire);
  uint64_t t = q->tail.load(std::memory_order_acquire);
  return h > t ? (size_t)(h - t) : 0;
}

// Peek the enqueue time of the oldest pending record. Single-consumer only.
// Returns false when the queue is empty (or the slot is mid-write).
static bool peek_oldest(Queue *q, double *enq_time) {
  uint64_t pos = q->tail.load(std::memory_order_relaxed);
  Slot &s = q->slots[pos & (q->capacity - 1)];
  if (s.seq.load(std::memory_order_acquire) != pos + 1) return false;
  *enq_time = s.enq_time;
  return true;
}

// Assemble the next microbatch into out_buf (concatenated payloads) +
// out_lens (per-record byte lengths). Returns the record count.
//
// Close conditions (same contract as stream/microbatch.py): the batch only
// opens once `max_batch` records are pending OR the oldest pending record is
// older than `max_delay`; with a block budget (block_ms > 0) an expiring
// budget flushes whatever is pending. block_ms=0 -> strict non-blocking:
// returns 0 until a close condition holds.
int mb_next_batch(void *handle, char *out_buf, size_t out_cap,
                  uint32_t *out_lens, int block_ms) {
  auto *q = static_cast<Queue *>(handle);
  double deadline_wall = q->now() + block_ms / 1000.0;
  bool flush = false;
  for (;;) {
    double oldest;
    bool have = peek_oldest(q, &oldest);
    bool size_ready = mb_pending(handle) >= q->max_batch;
    bool deadline_ready = have && (q->now() - oldest) >= q->max_delay_s;
    if (size_ready || deadline_ready || (flush && have)) break;
    if (q->now() >= deadline_wall) {
      if (block_ms <= 0 || !have) return 0;
      flush = true;  // budget exhausted: flush pending
    } else {
      std::this_thread::yield();
    }
  }
  size_t n = 0, used = 0;
  while (n < q->max_batch && used + q->slot_bytes <= out_cap) {
    double enq;
    int len = pop_one(q, out_buf + used, &enq);
    if (len < 0) break;
    out_lens[n++] = (uint32_t)len;
    used += (size_t)len;
  }
  if (n > 0) {
    q->batches.fetch_add(1, std::memory_order_relaxed);
    q->records.fetch_add(n, std::memory_order_relaxed);
  }
  return (int)n;
}

uint64_t mb_stat_batches(void *h) {
  return static_cast<Queue *>(h)->batches.load(std::memory_order_relaxed);
}
uint64_t mb_stat_records(void *h) {
  return static_cast<Queue *>(h)->records.load(std::memory_order_relaxed);
}
uint64_t mb_stat_dropped(void *h) {
  return static_cast<Queue *>(h)->dropped.load(std::memory_order_relaxed);
}

}  // extern "C"
