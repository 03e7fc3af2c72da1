"""Invariant guard plane: the port's static checks + dynamic lock watcher.

The port's correctness invariants — virtual-clock determinism, no blocking
device pull on the dispatch path, honest counter-delta Prometheus mirrors,
score-lock discipline around parameter swaps, no device wait under a held
lock — are machine-checked here. ``lint`` (analysis/lint.py) checks them
over the AST with the standard library only (``python -m
realtime_fraud_detection_tpu_torch lint`` imports no torch);
``analysis/lockwatch.py`` watches real lock acquisition order and the
device waits while the deterministic drills run, on the card or on the
CPU. Both are enforced in tier-1 (tests/test_torch_lint.py,
tests/test_torch_lockwatch*.py).
"""

from realtime_fraud_detection_tpu_torch.analysis.lint import (
    Finding,
    RULES,
    format_findings,
    lint_paths,
    lint_source,
    run_lint,
)
from realtime_fraud_detection_tpu_torch.analysis.lockwatch import (
    LockWatcher,
    watch_locks,
)

__all__ = [
    "Finding",
    "RULES",
    "format_findings",
    "lint_paths",
    "lint_source",
    "run_lint",
    "LockWatcher",
    "watch_locks",
]
