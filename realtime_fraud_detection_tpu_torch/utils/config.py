"""Scoring configuration the port needs: the quant and kernel planes, the
ensemble defaults ``EnsembleParams.from_config`` reads, and the state
stores' TTLs and list lengths.

Values are copies of the JAX package's ``utils/config.py`` (QuantSettings,
KernelSettings, StateConfig's memory tier, the five-model registry
weights, the confidence multipliers and the decision-ladder rungs), and the
ensemble part of its environment layering (``RTFD_ENSEMBLE_STRATEGY`` or
``ENSEMBLE_STRATEGY``, ``CONFIDENCE_THRESHOLD``, ``FRAUD_THRESHOLD``). The
port keeps its own copy so it imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict

VALID_STRATEGIES = ("weighted_average", "voting", "stacking")


def _env(name: str, default: str) -> str:
    """``RTFD_<name>``, then ``name``, else ``default``."""
    for key in (f"RTFD_{name}", name):
        val = os.getenv(key)
        if val is not None:
            return val
    return default

# Decision-ladder rung defaults (ensemble_predictor.py:344-356).
DECLINE_THRESHOLD_DEFAULT = 0.95
REVIEW_THRESHOLD_DEFAULT = 0.8
MONITOR_THRESHOLD_DEFAULT = 0.6

# The five-model registry weights (reference config.py:126-199), in
# registry order.
DEFAULT_MODEL_WEIGHTS: Dict[str, float] = {
    "xgboost_primary": 0.40,
    "lstm_sequential": 0.25,
    "bert_text": 0.15,
    "graph_neural": 0.15,
    "isolation_forest": 0.05,
}

# Confidence multipliers per model (ensemble_predictor.py:331-337).
MODEL_CONFIDENCE_MULTIPLIER: Dict[str, float] = {
    "xgboost_primary": 1.0,
    "lstm_sequential": 0.8,
    "bert_text": 0.7,
    "graph_neural": 0.6,
    "isolation_forest": 0.5,
}
DEFAULT_CONFIDENCE_MULTIPLIER = 0.5


@dataclass
class EnsembleConfig:
    """Ensemble strategy + decision thresholds (config.py:21-27)."""

    strategy: str = "weighted_average"
    confidence_threshold: float = 0.7
    fraud_threshold: float = 0.5
    enable_explanation: bool = True
    decline_threshold: float = DECLINE_THRESHOLD_DEFAULT
    review_threshold: float = REVIEW_THRESHOLD_DEFAULT
    monitor_threshold: float = MONITOR_THRESHOLD_DEFAULT


VALID_BERT_WEIGHTS = ("f32", "int8")
VALID_TREE_KERNELS = ("gather", "gemm")


@dataclass
class QuantSettings:
    """Quantized scoring plane: weight-only int8 BERT and the GEMM-form
    tree traversals, selectable per branch. Off by default."""

    enabled: bool = False
    bert_weights: str = "f32"       # f32 | int8
    tree_kernel: str = "gather"     # gather | gemm
    iforest_kernel: str = "gather"  # gather | gemm

    def validate(self) -> None:
        if self.bert_weights not in VALID_BERT_WEIGHTS:
            raise ValueError(
                f"quant.bert_weights must be one of {VALID_BERT_WEIGHTS}, "
                f"got {self.bert_weights!r}")
        for name, kernel in (("tree_kernel", self.tree_kernel),
                             ("iforest_kernel", self.iforest_kernel)):
            if kernel not in VALID_TREE_KERNELS:
                raise ValueError(
                    f"quant.{name} must be one of {VALID_TREE_KERNELS}, "
                    f"got {kernel!r}")

    @classmethod
    def full(cls) -> "QuantSettings":
        """int8 BERT + GEMM-form kernels for both tree branches."""
        return cls(enabled=True, bert_weights="int8",
                   tree_kernel="gemm", iforest_kernel="gemm")

    def bert_mode(self) -> str:
        return self.bert_weights if self.enabled else "f32"

    def static(self) -> Dict[str, str]:
        """The tree-kernel selection the fused scorer takes."""
        if not self.enabled:
            return {"tree_kernel": "gather", "iforest_kernel": "gather"}
        return {"tree_kernel": self.tree_kernel,
                "iforest_kernel": self.iforest_kernel}


VALID_KERNEL_SITES = ("dequant_matmul", "epilogue", "attention",
                      "megakernel")
VALID_KERNEL_MODES = ("off", "cuda")
VALID_ATTENTION_KERNELS = ("reference", "flash")


@dataclass
class KernelSettings:
    """Hand-written kernel plane (ops/): per-site kernel selection.

    ``dequant_matmul``, ``epilogue`` and ``megakernel`` are "off" or
    "cuda"; ``attention`` is "reference" or "flash". When the megakernel
    engages it subsumes the three per-site kernels: one launch scores the
    batch, and the per-site selections only matter on shapes its plan
    declines (``ops/megakernel.py mega_plan``), which fall back to the
    per-site chain. Off by default.
    """

    enabled: bool = False
    dequant_matmul: str = "off"
    epilogue: str = "off"
    attention: str = "reference"
    megakernel: str = "off"

    def validate(self) -> None:
        for name, mode in (("dequant_matmul", self.dequant_matmul),
                           ("epilogue", self.epilogue),
                           ("megakernel", self.megakernel)):
            if mode not in VALID_KERNEL_MODES:
                raise ValueError(
                    f"kernels.{name} must be one of {VALID_KERNEL_MODES}, "
                    f"got {mode!r}")
        if self.attention not in VALID_ATTENTION_KERNELS:
            raise ValueError(
                f"kernels.attention must be one of "
                f"{VALID_ATTENTION_KERNELS}, got {self.attention!r}")

    @classmethod
    def full(cls) -> "KernelSettings":
        """Fused dequant-matmul + fused epilogue + flash attention."""
        return cls(enabled=True, dequant_matmul="cuda", epilogue="cuda",
                   attention="flash")

    @classmethod
    def mega(cls) -> "KernelSettings":
        """``full()`` plus the persistent megakernel; the per-site plane
        stays the fallback for shapes the megakernel's plan declines."""
        return cls(enabled=True, dequant_matmul="cuda", epilogue="cuda",
                   attention="flash", megakernel="cuda")

    def site_modes(self) -> Dict[str, str]:
        if not self.enabled:
            return {"dequant_matmul": "off", "epilogue": "off",
                    "attention": "reference", "megakernel": "off"}
        return {"dequant_matmul": self.dequant_matmul,
                "epilogue": self.epilogue, "attention": self.attention,
                "megakernel": self.megakernel}

    def static(self) -> Dict[str, object]:
        """The kernel selection the fused scorer takes."""
        modes = self.site_modes()
        return {"dequant_kernel": modes["dequant_matmul"],
                "epilogue_kernel": modes["epilogue"],
                "use_flash": modes["attention"] == "flash",
                "megakernel": modes["megakernel"]}


@dataclass
class StateConfig:
    """In-process state store settings (RedisService.java key TTLs). Only
    the memory tier is ported; velocity windows expire on their own
    periods, so there is no velocity TTL."""

    transaction_ttl_s: int = 24 * 3600
    features_ttl_s: int = 2 * 3600
    user_history_len: int = 100  # RedisService.java:296-306 last-100 list
    merchant_history_len: int = 500


@dataclass
class Config:
    """The slice of the JAX package's root ``Config`` that scoring reads.
    A model left out of ``model_weights`` is disabled."""

    model_weights: Dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_MODEL_WEIGHTS))
    ensemble: EnsembleConfig = field(default_factory=EnsembleConfig)
    quant: QuantSettings = field(default_factory=QuantSettings)
    kernels: KernelSettings = field(default_factory=KernelSettings)
    state: StateConfig = field(default_factory=StateConfig)

    def __post_init__(self) -> None:
        self._apply_env()
        self.validate()

    def _apply_env(self) -> None:
        """The ensemble part of the JAX ``Config._apply_env``: strategy and
        thresholds from ``RTFD_``-prefixed or plain environment variables.
        (The JAX package's serving, logging and Redis variables configure
        tiers the port does not have yet.)"""
        e = self.ensemble
        e.strategy = _env("ENSEMBLE_STRATEGY", e.strategy)
        e.confidence_threshold = float(
            _env("CONFIDENCE_THRESHOLD", str(e.confidence_threshold)))
        e.fraud_threshold = float(_env("FRAUD_THRESHOLD", str(e.fraud_threshold)))

    def normalized_weights(self) -> Dict[str, float]:
        """Blend weights over the configured (enabled) models."""
        total = sum(self.model_weights.values())
        if total <= 0:
            return {n: 0.0 for n in self.model_weights}
        return {n: w / total for n, w in self.model_weights.items()}

    def validate(self) -> None:
        if self.ensemble.strategy not in VALID_STRATEGIES:
            raise ValueError(
                f"ensemble.strategy must be one of {VALID_STRATEGIES}, got "
                f"{self.ensemble.strategy!r}")
        e = self.ensemble
        if not (0.0 <= e.monitor_threshold <= e.review_threshold
                <= e.decline_threshold <= 1.0):
            raise ValueError(
                "decision ladder must satisfy 0 <= monitor_threshold <= "
                "review_threshold <= decline_threshold <= 1")
        self.quant.validate()
        self.kernels.validate()
