"""One CPU thread for torch in the port's tests, and in what they spawn.

The suite runs under ``pytest-xdist``, several workers at once on one host.
At its default, each worker's torch sizes its intra-op pool to every core,
so the workers' pools spin against each other and a case that takes seconds
alone takes minutes beside them. Every ``tests/test_torch_*.py`` imports
this module first: it sets torch's pool to one thread before any torch
work, and ``spawn_env`` gives a spawned process (a ``python -m
realtime_fraud_detection_tpu_torch`` command, a JAX-blocked script) the
same limit through ``OMP_NUM_THREADS`` and ``MKL_NUM_THREADS``.
"""

import os

import torch

THREAD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}

torch.set_num_threads(1)


def spawn_env(**extra: str) -> dict:
    """The environment for a process a port test starts: this process's,
    with torch's threads held to one, plus ``extra``."""
    return {**os.environ, **THREAD_ENV, **extra}
