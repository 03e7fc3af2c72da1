"""ctypes bindings for the native (C++) microbatch queue.

Port of the microbatcher half of the JAX package's ``native/``: the C++
source (``microbatcher.cpp``, a lock-free MPMC ring with a deadline batch
close, and its ThreadSanitizer harness ``stress_main.cpp``) is a copy, and
``NativeMicrobatchQueue`` keeps the JAX class's API. The library is built
with g++ on first use into ``<repo>/build/native/<hash>/``, keyed on a hash
of the source and the flags, never next to the source; a process that finds
the library built loads it. ``RTFD_DISABLE_NATIVE=1`` turns the native
queue off (callers then use their pure-Python fallback, as
``stream/gateway.py`` does). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

__all__ = ["NativeMicrobatchQueue", "native_available", "native_build_error",
           "native_library_path"]

_SRC = Path(__file__).resolve().parent / "microbatcher.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def native_library_path() -> Path:
    """Where the library is (or will be) built for the current source."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "_microbatcher.so"


def _compile() -> tuple[Optional[ctypes.CDLL], Optional[str]]:
    """Build (unless built) and load; returns (lib, error). The object is
    written to a temporary name in the target directory and renamed into
    place, so two processes building at once never load a torn file."""
    if os.environ.get("RTFD_DISABLE_NATIVE") == "1":
        return None, "disabled via RTFD_DISABLE_NATIVE"
    lib_path = native_library_path()
    try:
        if not lib_path.exists():
            lib_path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_path.parent)
            os.close(fd)
            try:
                subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", tmp],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, lib_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return ctypes.CDLL(str(lib_path)), None
    except (OSError, subprocess.SubprocessError) as e:
        return None, str(e)


def _build() -> Optional[ctypes.CDLL]:
    global _build_error
    lib, _build_error = _compile()
    if lib is None:
        return None
    lib.mb_create.restype = ctypes.c_void_p
    lib.mb_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t,
                              ctypes.c_size_t, ctypes.c_double]
    lib.mb_destroy.argtypes = [ctypes.c_void_p]
    lib.mb_push.restype = ctypes.c_int
    lib.mb_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.mb_pending.restype = ctypes.c_size_t
    lib.mb_pending.argtypes = [ctypes.c_void_p]
    lib.mb_next_batch.restype = ctypes.c_int
    lib.mb_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
    ]
    for name in ("mb_stat_batches", "mb_stat_records", "mb_stat_dropped"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is None and _build_error is None:
            _lib = _build()
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


def native_build_error() -> Optional[str]:
    _get_lib()
    return _build_error


class NativeMicrobatchQueue:
    """Lock-free MPMC ingest queue + deadline microbatcher (C++ backed).

    The close condition of ``stream.microbatch.MicrobatchAssembler``: a
    batch closes when it reaches ``max_batch`` or when ``max_delay_ms`` has
    passed since its oldest record was enqueued.
    """

    def __init__(self, capacity: int = 4096, slot_bytes: int = 4096,
                 max_batch: int = 256, max_delay_ms: float = 5.0):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(f"native microbatcher unavailable: {_build_error}")
        self._lib = lib
        self.slot_bytes = slot_bytes
        self.max_batch = max_batch
        self._q = ctypes.c_void_p(lib.mb_create(
            capacity, slot_bytes, max_batch, max_delay_ms))
        self._out_buf = ctypes.create_string_buffer(slot_bytes * max_batch)
        self._out_lens = (ctypes.c_uint32 * max_batch)()

    def _handle(self) -> ctypes.c_void_p:
        if not self._q:
            raise ValueError("queue is closed")
        return self._q

    def push(self, payload: bytes) -> bool:
        """Enqueue one record; False when the ring is full (backpressure)."""
        rc = self._lib.mb_push(self._handle(), payload, len(payload))
        if rc == -2:
            raise ValueError(
                f"payload of {len(payload)} bytes exceeds slot size {self.slot_bytes}")
        return rc == 0

    def next_batch(self, block_ms: int = 0) -> List[bytes]:
        n = self._lib.mb_next_batch(
            self._handle(), self._out_buf, len(self._out_buf), self._out_lens,
            block_ms)
        if n <= 0:
            return []
        used = sum(self._out_lens[i] for i in range(n))
        raw = ctypes.string_at(self._out_buf, used)  # the used prefix only
        out: List[bytes] = []
        off = 0
        for i in range(n):
            ln = self._out_lens[i]
            out.append(raw[off:off + ln])
            off += ln
        return out

    def pending(self) -> int:
        return int(self._lib.mb_pending(self._handle()))

    def stats(self) -> dict:
        h = self._handle()
        return {
            "batches": int(self._lib.mb_stat_batches(h)),
            "records": int(self._lib.mb_stat_records(h)),
            "dropped": int(self._lib.mb_stat_dropped(h)),
        }

    def close(self) -> None:
        if self._q:
            self._lib.mb_destroy(self._q)
            self._q = ctypes.c_void_p(None)

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
