"""The degradation ladder's rungs: trade ensemble quality for latency.

A copy of the rung table of the JAX package's ``qos/ladder.py``
(``LadderLevel``, ``LADDER_LEVELS``):

    0  full_ensemble   all 5 branches
    1  no_text_graph   drop BERT + GNN (the two heavy branches)
    2  trees_iforest   XGBoost + isolation forest only
    3  rules_only      the rule ladder alone, no learned branch

Each rung is a branch-validity mask (``TorchFraudScorer.set_degradation``);
the fused program renormalizes the blend over the surviving branches. The
controller that steps the ladder (``DegradationLadder``) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Tuple

__all__ = ["LadderLevel", "LADDER_LEVELS"]


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
