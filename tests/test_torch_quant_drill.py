"""The port's quantization drill against the JAX package's, on the CPU.

Both run ``QuantDrillConfig.fast()``; the port's scorers start from the JAX
scorer's own initial model set (``init_scoring_models(PRNGKey(11))``,
bridged), so both sides serve the same weights: the ``checks`` dicts and the
decision flips are equal, the f32 and int8 AUCs agree within
``QUANT_AUC_TOL``, the bytes ratio is equal (3.828), both divergences sit
under their own noise bounds, and two port runs give the same digest.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import dataclasses
import io
import contextlib
import json

import jax
import numpy as np
import pytest

from realtime_fraud_detection_tpu.scoring import pipeline as jpipeline
from realtime_fraud_detection_tpu.scoring import quant_drill as jqd
from realtime_fraud_detection_tpu_torch.__main__ import main as port_main
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.scoring import quant_drill as qd

# the drill's AUCs on the same weights and stream: the f32 trees and forest
# are bit-equal, BERT's bf16 rounding differs by ~1e-6 between the packages,
# which moves no pair of scores across each other on this stream
QUANT_AUC_TOL = 1e-6


@pytest.fixture(scope="module")
def runs():
    cfg = qd.QuantDrillConfig.fast()
    jm = jpipeline.init_scoring_models(jax.random.PRNGKey(cfg.seed),
                                      feature_dim=64, node_dim=16)
    models = models_from_numpy(jax.tree_util.tree_map(np.asarray, jm))
    got = qd.run_quant_drill(dataclasses.replace(cfg, device="cpu"), models=models)
    want = jqd.run_quant_drill(jqd.QuantDrillConfig.fast())
    return got, want


def test_quant_drill_config_matches_jax():
    for want, got in ((jqd.QuantDrillConfig(), qd.QuantDrillConfig()),
                      (jqd.QuantDrillConfig.fast(), qd.QuantDrillConfig.fast())):
        for f in dataclasses.fields(want):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert qd.QuantDrillConfig().device == "cuda"


def test_quant_drill_checks_equal_jax(runs):
    got, want = runs
    assert got["passed"] is True and want["passed"] is True
    assert got["checks"] == want["checks"] and all(got["checks"].values())
    assert got["divergence"]["decision_flips"] == want["divergence"]["decision_flips"] == 0
    assert got["modes"] == want["modes"]


def test_quant_drill_aucs_and_bytes_equal_jax(runs):
    got, want = runs
    for key in ("auc_f32", "auc_quant", "auc_delta"):
        assert abs(got["quality"][key] - want["quality"][key]) <= QUANT_AUC_TOL, key
    for key in ("eval_txn", "fraud_rate"):
        assert got["quality"][key] == want["quality"][key], key
    assert got["param_bytes"] == want["param_bytes"]
    assert got["param_bytes"]["ratio"] == 3.828


def test_quant_drill_divergence_under_each_bound(runs):
    got, want = runs
    for side in (got, want):
        div = side["divergence"]
        assert div["max"] <= div["noise_scale"] * div["noise_floor"]["bound"]
        assert div["n_txn"] == 512
    assert got["divergence"]["noise_floor"]["bound"] == \
        want["divergence"]["noise_floor"]["bound"]
    assert got["tree_oracle"]["leaves_equal"] and want["tree_oracle"]["leaves_equal"]


def test_quant_drill_replay_digest_is_stable(runs):
    got, _ = runs
    assert got["replay"]["bit_identical"]
    assert got["replay"]["digest"] == got["digest"]


def test_quant_drill_command_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_main(["quant-drill", "--fast", "--no-replay", "--device", "cpu"])
    lines = out.getvalue().strip().splitlines()
    compact = json.loads(lines[-1])
    assert rc == 0 and compact["passed"] is True and len(lines[-1]) < 2048
    assert compact["device"] == "cpu" and "replay_bit_identical" not in compact["checks"]
    assert json.loads(lines[-2])["digest"][:16] == compact["digest"]
