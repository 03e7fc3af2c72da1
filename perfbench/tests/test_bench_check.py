"""The check: the reference agrees with the port at toy size, the control
and every planted fault come out as not correct, and the yardstick's
counts match a hand count."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import counts, harness
from perfbench.faults import FAULTS
from perfbench.reference import models as ref
from perfbench.tests.toy import TINY_ENCODER, run_toy
from perfbench.weights import make_weights


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_makes_the_run_incorrect(fault, tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "OUT_DIR", tmp_path)
    rc, out, _ = run_toy("distilbert-ensemble.backlog", seed=1_234_567_891_011,
                         fault=fault)
    assert rc == 0
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["checks"].values()) \
        or out["failed"] > 0


def test_control_separates_from_the_program(tmp_path, monkeypatch, capsys):
    """At toy size the control (the reference one precision step down) lies
    far above the program on the numbers that separate the two at full
    size; the full-size readings and limits come from the chip
    (``python3 -m perfbench.control``, ``PERF.md``)."""
    import json

    monkeypatch.setattr(harness, "OUT_DIR", tmp_path)
    rc, out, _ = run_toy("distilbert-ensemble.backlog", control=True)
    assert rc == 0 and out["correct"] is True
    stats = next(ln for ln in capsys.readouterr().err.splitlines()
                 if ln.startswith("perfbench stats "))
    control = json.loads(stats[len("perfbench stats "):])["control"]
    program = {**{k: v["value"] for k, v in out["checks"].items()},
               **json.loads(stats[len("perfbench stats "):])["check_info"]}
    for name in ("bert_text", "lstm_sequential", "graph_neural", "fraud_score"):
        assert control[name] > 10 * program[name], name


def test_reference_encoder_agrees_with_the_port_plain_path():
    """The reference's f32 encoder with int8 weights against the port's own
    plain (kernels-off) path at f32 compute on the same quantized weights."""
    from realtime_fraud_detection_tpu_torch.models.bert import BertConfig, bert_predict
    from realtime_fraud_detection_tpu_torch.models.quant import quantize_bert_params
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import _nested_to

    cfg = {"text_encoder": TINY_ENCODER, "ensemble": {
        "feature_dim": 64, "node_dim": 16, "gbdt": {"n_trees": 4, "depth": 3},
        "isolation_forest": {"n_trees": 4, "depth": 3, "max_samples": 8},
        "lstm": {"hidden": 16, "head_hidden": 8}, "gnn": {"hidden": 8, "head_hidden": 8}}}
    w = make_weights(5, cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 30522, (8, 16), generator=g, dtype=torch.int32)
    mask = torch.arange(16)[None, :] < torch.randint(2, 17, (8, 1), generator=g)
    want = ref.encoder_prob(ref.encoder_weights(w["bert"], 8), ids, mask, TINY_ENCODER)
    got = bert_predict(_nested_to(quantize_bert_params(w["bert"]), "cpu"), ids, mask,
                       BertConfig(**TINY_ENCODER), compute_dtype=torch.float32)
    assert float((got - want).abs().max()) < 1e-5


def test_counts_match_a_hand_count_of_one_distilbert_layer():
    enc = {"hidden_size": 768, "intermediate_size": 3072, "num_heads": 12,
           "num_layers": 6, "num_labels": 2}
    m = 256 * 64
    flops = sum(counts.dequant_matmul_work(m, k, n)[1]
                for k, n in counts.dequant_matmul_sites(enc))
    # q, k, v, o: 2 x M x 768 x 768 each; ffn1 and ffn2: 2 x M x 768 x 3072
    assert flops == 4 * 2 * m * 768 * 768 + 2 * 2 * m * 768 * 3072
    nbytes = counts.dequant_matmul_work(m, 768, 3072)[0]
    assert nbytes == m * 768 * 4 + 768 * 3072 + 2 * 3072 * 4 + m * 3072 * 4
    b, f = counts.attention_work(256, 12, 64, 64)
    assert f == 2 * (2 * 256 * 12 * 64 * 64 * 64)
    assert b == 4 * 256 * 12 * 64 * 64 * 4 + 256 * 64
    t, by = counts.bound(nbytes, 2 * m * 768 * 3072, "bf16")
    assert by == "operations" and t == pytest.approx(2 * m * 768 * 3072 / 989e12 * 1e3)
    cfg = {"text_encoder": enc, "ensemble": {
        "text_len": 64, "feature_dim": 64, "seq_len": 10, "node_dim": 16, "fanout": 16,
        "lstm": {"hidden": 128, "head_hidden": 64}, "gnn": {"hidden": 64, "head_hidden": 64},
        "gbdt": {"n_trees": 100, "depth": 6},
        "isolation_forest": {"n_trees": 100, "depth": 8}}}
    per_txn = counts.model_flops_per_txn(cfg)
    assert 5.4e9 < per_txn < 5.6e9


def test_round_operand_steps_down():
    x = torch.linspace(-3.0, 3.0, 1001)
    for kind, bound in (("tf32", 2.0 ** -11), ("fp8", 2.0 ** -3)):
        y = ref.round_operand(x, kind)
        rel = ((y - x).abs() / x.abs().clamp(min=1e-3)).max()
        assert 0 < float(rel) <= bound * 1.01
    assert torch.equal(ref.round_operand(x, "f32"), x)
    # int4: scale max|w| / 7, 0.25 / (1 / 7) = 1.75 rounds to 2
    assert np.isclose(float(ref.quantize(torch.tensor([[1.0], [0.25]]), 4, 0)[1]),
                      2 / 7)


def test_reference_branches_agree_with_the_port_plain_path():
    """The reference's trees, LSTM, GNN and blend against the port's own
    plain functions at f32 on the same weights and random inputs."""
    from realtime_fraud_detection_tpu_torch.ensemble.combine import (
        EnsembleParams,
        combine_predictions,
    )
    from realtime_fraud_detection_tpu_torch.models.gnn import gnn_logits
    from realtime_fraud_detection_tpu_torch.models.lstm import lstm_logits
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES
    from realtime_fraud_detection_tpu_torch.utils.config import Config

    from perfbench import spec
    from perfbench.check import BRANCHES
    from perfbench.system import program_models

    cfg = spec.config("distilbert-ensemble")
    cfg["text_encoder"] = TINY_ENCODER
    w = make_weights(11, cfg, "cpu")
    models = program_models(w)
    g = torch.Generator().manual_seed(1)
    b = 64
    x = torch.randn((b, 64), generator=g) * 3
    from realtime_fraud_detection_tpu_torch.models.isolation_forest import iforest_predict
    from realtime_fraud_detection_tpu_torch.models.trees import tree_ensemble_predict

    for kernel in ("gather", "gemm"):
        assert float((ref.gbdt_prob(w["gbdt"], x)
                      - tree_ensemble_predict(models.trees, x, kernel)).abs().max()) < 1e-6
        assert float((ref.iforest_prob(w["iforest"], x)
                      - iforest_predict(models.iforest, x, kernel)).abs().max()) < 1e-6
    seq = torch.randn((b, 10, 64), generator=g)
    lengths = torch.randint(0, 11, (b,), generator=g, dtype=torch.int32)
    want = ref.lstm_prob(w["lstm"], seq, lengths)
    got = torch.sigmoid(lstm_logits(models.lstm, seq, lengths, torch.float32))
    assert float((want - got).abs().max()) < 1e-6
    nf = [torch.randn(s, generator=g) for s in ((b, 16), (b, 16), (b, 16, 16), (b, 16, 16))]
    masks = [torch.rand((b, 16), generator=g) < 0.6 for _ in range(2)]
    want = ref.gnn_prob(w["gnn"], x, nf[0], nf[1], nf[2], masks[0], nf[3], masks[1])
    got = torch.sigmoid(gnn_logits(models.gnn, x, nf[0], nf[1], nf[2], masks[0],
                                   nf[3], masks[1]))
    assert float((want - got).abs().max()) < 1e-6
    preds = torch.rand((b, 5), generator=g)
    mine = ref.blend(preds, cfg["ensemble"], BRANCHES)
    config = Config()
    for name, mc in config.models.items():
        mc.weight = cfg["ensemble"]["weights"][name]
    theirs = combine_predictions(preds, torch.ones(5, dtype=torch.bool),
                                 EnsembleParams.from_config(config, MODEL_NAMES))
    assert float((mine["prob"] - theirs["fraud_probability"]).abs().max()) < 1e-6
    assert torch.equal(mine["decision"], theirs["decision"].long())
    assert torch.equal(mine["risk"], theirs["risk_level"].long())
