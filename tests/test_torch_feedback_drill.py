"""The port's closed-loop feedback drill against the JAX package's, on the
CPU: ``feedback-drill --fast --device cpu`` (the port's command) and the
JAX fast drill. The compact summaries' discrete fields are equal (2
triggers, the gate 1 fail / 1 pass, 1 promotion, 4,733 labels matched), the
baseline / dip / recovered AUCs agree within ``DRILL_AUC_TOL``, the join,
buffer and policy blocks are equal, and the compact last line parses and
stays under 2 KB. Also ``run-job --feedback`` on a small stream against the
JAX command (the labels matched and the buffer equal), and the refusals
without a card.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import contextlib
import io
import json

import pytest
import torch

from realtime_fraud_detection_tpu import cli as jax_cli
from realtime_fraud_detection_tpu.feedback import drill as jdrill
from realtime_fraud_detection_tpu_torch.__main__ import main as port_main

# the drill's AUCs (rounded to 4 places by the drill) on the two packages:
# the same trees, the host features within 1e-5
DRILL_AUC_TOL = 1e-4
DISCRETE = ("passed", "auc_dipped", "retrain_triggered", "trigger_reason",
            "gate_control_rejected", "blend_unchanged_on_reject", "promoted",
            "promoted_blend", "labels_matched", "labeled_total",
            "virtual_duration_s")


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    lines = [ln for ln in out.getvalue().strip().splitlines() if ln.strip()]
    return rc, lines


@pytest.fixture(scope="module")
def drills():
    rc, lines = _run(port_main, ["feedback-drill", "--fast", "--device", "cpu"])
    want = jdrill.run_feedback_drill(fast=True)
    return rc, lines, want


def test_feedback_drill_passes_like_jax(drills):
    rc, lines, want = drills
    full, compact = json.loads(lines[-2]), json.loads(lines[-1])
    assert rc == 0 and full["passed"] is True and compact["passed"] is True
    jcompact = jdrill.compact_drill_summary(want)
    for key in DISCRETE:
        assert compact[key] == jcompact[key], key
    for key in ("baseline_auc", "dip_auc", "recovered_auc"):
        assert abs(compact[key] - jcompact[key]) <= DRILL_AUC_TOL, key
    assert compact["labels_matched"] == 4733
    assert full["policy"] == want["policy"] == {
        "triggers": 2, "gate_pass": 1, "gate_fail": 1, "promotions": 1}
    for key in ("label_join", "buffer", "incumbent", "events", "drift_rate"):
        assert full[key] == want[key], key
    assert full["trigger_reason"] == "feature_drift"
    gate, jgate = full["gate"], want["gate"]
    for key in ("passed", "reason", "strategy", "holdout_n", "holdout_positives",
                "trained_on", "select_auc", "trigger_reason"):
        assert gate[key] == jgate[key], key
    for key in ("auc_as_served", "auc_candidate", "recall_as_served",
                "recall_candidate"):
        assert abs(gate[key] - jgate[key]) <= DRILL_AUC_TOL, key


def test_feedback_drill_last_line_is_compact_json(drills):
    _, lines, _ = drills
    assert len(lines[-1].encode()) < 2048
    compact = json.loads(lines[-1])
    assert compact["metric"] == "feedback_drill"
    assert compact["summary_of"] == "full result JSON on the preceding stdout line"


def test_run_job_feedback_block_matches_jax():
    """``run-job --feedback`` on a small stream: the label producer, the
    join and the buffer are host work, equal to the JAX command's."""
    argv = ["run-job", "--count", "384", "--users", "200", "--merchants", "60",
            "--batch", "128", "--feedback"]
    rc, lines = _run(port_main, argv + ["--device", "cpu"])
    jrc, jlines = _run(jax_cli.main, argv)
    assert rc == jrc == 0
    got, want = json.loads(lines[-1]), json.loads(jlines[-1])
    assert got["scored"] == want["scored"] == 384
    for key in ("labels_matched", "buffer"):
        assert got["feedback"][key] == want["feedback"][key] == 384, key
    assert sorted(got["feedback"]) == sorted(want["feedback"])
    assert sorted(got["feedback"]["policy"]) == sorted(want["feedback"]["policy"])
    assert sorted(got["feedback"]["prequential_sliding"]) == \
        sorted(want["feedback"]["prequential_sliding"])


@pytest.mark.parametrize("command", ["feedback-drill", "quant-drill"])
def test_drills_refuse_to_start_without_a_card(command, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert port_main([command, "--fast"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
