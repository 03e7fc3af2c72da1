"""The degradation ladder: trade ensemble quality for latency, reversibly.

Port of the JAX package's ``qos/ladder.py``. Under sustained backlog the
ensemble steps down one rung at a time:

    0  full_ensemble   all 5 branches
    1  no_text_graph   drop BERT + GNN (the two heavy branches)
    2  trees_iforest   XGBoost + isolation forest only
    3  rules_only      the rule ladder alone, no learned branch

and back up when the backlog drains. Each rung is a branch-validity mask
(``TorchFraudScorer.set_degradation``): the fused program renormalizes the
blend over the surviving branches, and on the megakernel path the mask is
the kernel's ``mega_valid`` (all false at ``rules_only``).

Hysteresis: a step in either direction takes ``patience`` consecutive
observations past its watermark, and the two watermarks are apart, so a
backlog oscillating around one threshold cannot flap the ensemble.
``DegradationLadder`` is pure host state driven by explicit observations:
the stream job makes one per dispatched microbatch, the drill one per
virtual-clock batch.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Optional, Sequence, Tuple

import numpy as np

__all__ = ["LadderLevel", "LADDER_LEVELS", "LadderConfig",
           "DegradationLadder"]


@dataclasses.dataclass(frozen=True)
class LadderLevel:
    name: str
    dropped_branches: FrozenSet[str]
    rules_only: bool = False


LADDER_LEVELS: Tuple[LadderLevel, ...] = (
    LadderLevel("full_ensemble", frozenset()),
    LadderLevel("no_text_graph", frozenset({"bert_text", "graph_neural"})),
    LadderLevel("trees_iforest",
                frozenset({"bert_text", "graph_neural", "lstm_sequential"})),
    LadderLevel("rules_only",
                frozenset({"xgboost_primary", "lstm_sequential", "bert_text",
                           "graph_neural", "isolation_forest"}),
                rules_only=True),
)


@dataclasses.dataclass
class LadderConfig:
    """Watermarks are in backlog records (consumer lag + in flight)."""

    high_backlog: float = 2048.0   # sustained above this -> step down
    low_backlog: float = 256.0     # sustained at or below this -> step up
    patience: int = 2              # consecutive observations to step down
    # recovery patience (None = patience): slower than degradation, since
    # stepping up hands capacity back and a symmetric ladder would flap
    # under a sustained overload
    up_patience: Optional[int] = None
    max_level: int = len(LADDER_LEVELS) - 1


class DegradationLadder:
    """Observe the backlog, return the current level."""

    def __init__(self, config: LadderConfig = None):
        self.config = config or LadderConfig()
        self.level = 0
        self.transitions_down = 0
        self.transitions_up = 0
        self._over = 0
        self._under = 0

    @property
    def current(self) -> LadderLevel:
        return LADDER_LEVELS[self.level]

    def observe(self, backlog: float) -> int:
        c = self.config
        if backlog > c.high_backlog:
            self._over += 1
            self._under = 0
            if self._over >= c.patience and self.level < c.max_level:
                self.level += 1
                self.transitions_down += 1
                self._over = 0
        elif backlog <= c.low_backlog:   # inclusive: a drained (0) backlog
            # counts as low even when low_backlog is 0
            self._under += 1
            self._over = 0
            up_patience = (c.up_patience if c.up_patience is not None
                           else c.patience)
            if self._under >= up_patience and self.level > 0:
                self.level -= 1
                self.transitions_up += 1
                self._under = 0
        else:
            # the hysteresis band: hold the level, reset both streaks
            self._over = 0
            self._under = 0
        return self.level

    def level_mask(self, model_names: Sequence[str],
                   level: Optional[int] = None) -> np.ndarray:
        """Branch-validity mask over ``model_names`` (and-ed with the
        deployment's own validity in the scorer) for the current level, or
        for ``level`` (the plane's effective rung)."""
        rung = LADDER_LEVELS[self.level if level is None else level]
        dropped = rung.dropped_branches
        return np.asarray([n not in dropped for n in model_names], bool)

    def snapshot(self) -> dict:
        return {
            "level": self.level,
            "level_name": self.current.name,
            "rules_only": self.current.rules_only,
            "transitions_down": self.transitions_down,
            "transitions_up": self.transitions_up,
            "high_backlog": self.config.high_backlog,
            "low_backlog": self.config.low_backlog,
            "patience": self.config.patience,
        }
