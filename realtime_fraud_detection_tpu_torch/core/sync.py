"""The designated device wait: where the host blocks on a batch's result.

The port's counterpart of ``jax.block_until_ready``. A dispatched batch
records a ``torch.cuda.Event`` after its device-to-host copy; the three
completion points (``TorchFraudScorer.finalize``, ``DevicePool`` and
``MeshExecutor`` waits) block on it here and nowhere else. On the CPU there
is no event and nothing to wait for, but the call is made all the same
(with ``None``), so the lock watcher (``analysis/lockwatch.py``), which
patches :func:`device_wait`, sees every designated wait on either device.
Callers look the function up through this module (``sync.device_wait``)
so that the patch reaches them.
"""

from __future__ import annotations

from typing import Any, Optional


def device_wait(event: Optional[Any]) -> None:
    """Block until ``event`` (a recorded ``torch.cuda.Event``) completed;
    ``None`` (a batch scored on the CPU) returns at once."""
    if event is not None:
        event.synchronize()
