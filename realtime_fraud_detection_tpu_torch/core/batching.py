"""Batch bucketing: pad dynamic microbatches onto a fixed set of sizes.

Port of the JAX package's ``core/batching.py``. Rounding every microbatch up
to a bucket keeps the device program to a few shapes and carries a validity
mask for the padding rows.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np

from realtime_fraud_detection_tpu_torch.core.packing import tree_map

BATCH_BUCKETS: tuple[int, ...] = (1, 8, 32, 128, 256)


def bucket_for(n: int, buckets: tuple[int, ...] = BATCH_BUCKETS,
               multiple_of: int = 1) -> int:
    """Smallest bucket >= n; multiples of the largest bucket for huge n.
    Buckets below ``multiple_of`` are rounded up to it."""
    if n <= 0:
        raise ValueError(f"batch size must be positive, got {n}")

    def _round_up(size: int) -> int:
        if size % multiple_of:
            size = ((size + multiple_of - 1) // multiple_of) * multiple_of
        return size

    for b in buckets:
        if n <= b:
            return _round_up(b)
    top = buckets[-1]
    return _round_up(((n + top - 1) // top) * top)


def pad_to_bucket(tree: Any, n: int, buckets: tuple[int, ...] = BATCH_BUCKETS,
                  multiple_of: int = 1) -> Tuple[Any, np.ndarray, int]:
    """Pad every [n, ...] leaf to the bucket size; return (padded, mask, size).

    Padding replicates row 0 (keeps values in-distribution so padded rows
    cannot produce inf/nan in reductions); the mask is False on padded rows.
    """
    size = bucket_for(n, buckets, multiple_of)
    pad = size - n

    def _pad(x):
        arr = np.asarray(x)
        if arr.ndim == 0 or arr.shape[0] != n or pad == 0:
            return arr
        filler = np.broadcast_to(arr[:1], (pad,) + arr.shape[1:])
        return np.concatenate([arr, filler], axis=0)

    mask = np.zeros((size,), dtype=bool)
    mask[:n] = True
    return tree_map(_pad, tree), mask, size
