"""The port's ``Config`` layers the ensemble settings from the environment
as the JAX package's ``Config`` does: ``RTFD_``-prefixed or plain
``ENSEMBLE_STRATEGY``, ``CONFIDENCE_THRESHOLD`` and ``FRAUD_THRESHOLD``,
the prefixed name first. Compared field by field with the JAX ``Config``
under the same monkeypatched environment, and through ``EnsembleParams``.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import dataclasses

import numpy as np
import pytest

from realtime_fraud_detection_tpu.ensemble.combine import (
    EnsembleParams as JaxEnsembleParams,
)
from realtime_fraud_detection_tpu.scoring.pipeline import MODEL_NAMES
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
from realtime_fraud_detection_tpu_torch.utils.config import Config

ENV_NAMES = [f"{prefix}{name}" for prefix in ("RTFD_", "")
             for name in ("ENSEMBLE_STRATEGY", "CONFIDENCE_THRESHOLD",
                          "FRAUD_THRESHOLD")]


@pytest.fixture
def env(monkeypatch):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("setting", [
    {},
    {"RTFD_ENSEMBLE_STRATEGY": "voting", "FRAUD_THRESHOLD": "0.4",
     "CONFIDENCE_THRESHOLD": "0.65"},
    {"ENSEMBLE_STRATEGY": "stacking", "RTFD_CONFIDENCE_THRESHOLD": "0.55"},
    # the prefixed name wins over the plain one
    {"RTFD_ENSEMBLE_STRATEGY": "stacking", "ENSEMBLE_STRATEGY": "voting",
     "RTFD_FRAUD_THRESHOLD": "0.3", "FRAUD_THRESHOLD": "0.9"},
], ids=["unset", "prefixed_and_plain", "plain_strategy", "prefixed_wins"])
def test_ensemble_settings_follow_the_environment_like_jax(env, setting):
    for name, value in setting.items():
        env.setenv(name, value)
    got, want = Config().ensemble, JaxConfig().ensemble
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    tp = EnsembleParams.from_config(Config(), MODEL_NAMES)
    jp = JaxEnsembleParams.from_config(JaxConfig(), MODEL_NAMES)
    assert (tp.strategy, tp.fraud_threshold, tp.confidence_threshold) == (
        int(jp.strategy), float(jp.fraud_threshold), float(jp.confidence_threshold))
    np.testing.assert_array_equal(tp.weights.numpy(), np.asarray(jp.weights))


def test_an_unknown_strategy_from_the_environment_is_refused_like_jax(env):
    env.setenv("RTFD_ENSEMBLE_STRATEGY", "majority")
    with pytest.raises(ValueError, match="strategy"):
        JaxConfig()
    with pytest.raises(ValueError, match="strategy"):
        Config()


SERVICE_ENV = [f"{prefix}{name}" for prefix in ("RTFD_", "")
               for name in ("ML_SERVICE_PORT", "ML_SERVICE_HOST", "LOG_LEVEL",
                            "LOG_FILE")]


@pytest.mark.parametrize("setting", [
    {},
    {"ML_SERVICE_PORT": "9090", "ML_SERVICE_HOST": "127.0.0.1", "LOG_LEVEL": "DEBUG",
     "LOG_FILE": "/var/log/rtfd.json"},
    # the prefixed name wins over the plain one
    {"RTFD_ML_SERVICE_PORT": "7070", "ML_SERVICE_PORT": "9090",
     "RTFD_LOG_LEVEL": "WARNING", "LOG_LEVEL": "DEBUG"},
], ids=["unset", "plain", "prefixed_wins"])
def test_serving_and_monitoring_follow_the_environment_like_jax(monkeypatch, setting):
    for name in SERVICE_ENV + ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    for name, value in setting.items():
        monkeypatch.setenv(name, value)
    got, want = Config(), JaxConfig()
    for block in ("serving", "monitoring"):
        for f in dataclasses.fields(getattr(got, block)):
            assert getattr(getattr(got, block), f.name) == \
                getattr(getattr(want, block), f.name), (block, f.name)
    for f in ("cache_ttl_seconds", "cache_max_entries"):
        assert getattr(got.ensemble, f) == getattr(want.ensemble, f)


@pytest.mark.parametrize("patch", [
    {"serving": {"port": 70000}},
    {"serving": {"max_concurrent_predictions": 0}},
    {"serving": {"prediction_timeout_seconds": 0}},
    {"monitoring": {"prometheus_port": -1}},
    {"monitoring": {"log_level": "LOUD"}},
    {"ensemble": {"cache_max_entries": 0}},
])
def test_serving_settings_are_validated(monkeypatch, patch):
    for name in SERVICE_ENV + ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError):
        Config.from_dict(patch)
    assert Config.from_dict({"serving": {"port": 0, "overlap_assembly": True}}) \
        .serving.overlap_assembly is True
