"""The harness finds its pieces by name, and a toy-size CPU run of each
cell's path prints the result line and is judged correct."""

from __future__ import annotations

import sys
import types

import pytest

from perfbench import harness, spec
from perfbench.tests.toy import CELLS, run_toy

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def test_every_entry_resolves_by_name():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        cfg = spec.config(cell["config"])
        assert cfg["name"] == w["config"]
        assert "limits" in cell["check"]
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))


def test_metrics_follow_the_cell():
    bench = spec.benchmark()
    for cell in CELLS:
        e2e = {m["name"] for m in spec.metrics_for(cell, bench, trace=False)}
        assert e2e == {"txn_per_s", "setup_s"}
    bench["workloads"].append({"name": "x.later", "config": "distilbert-ensemble",
                               "traffic": "later", "chips": 1})
    e2e = {m["name"] for m in spec.metrics_for("x.later", bench, trace=False)}
    assert e2e == {"setup_s"}


def test_every_reader_file_loads():
    """The readers of the open-loop family's metrics (kept for its later
    cells) load as those of the listed metrics do."""
    for path in sorted((spec.HERE / "metrics").glob("[!_]*.py")):
        assert callable(spec.reader(path.stem))


@pytest.mark.parametrize("cell", CELLS)
def test_toy_run_prints_the_result_line(cell, tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "OUT_DIR", tmp_path)
    rc, out, _ = run_toy(cell)
    assert rc == 0
    assert KEYS <= set(out)
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert "setup_s" in out["metrics"]
    assert all(v["value"] <= v["limit"] for v in out["checks"].values())


def test_traced_toy_run_reports_per_layer_metrics(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "OUT_DIR", tmp_path)
    rc, out, _ = run_toy("distilbert-ensemble.backlog", trace=True, seconds=3.0)
    assert rc == 0 and out["correct"] is True
    # host metrics read on the CPU too; device metrics need the card's trace
    assert {"complete_ms.backlog", "assemble_ms.backlog", "dispatch_ms.backlog",
            "gc_ms.backlog", "model_mfu"} <= set(out["metrics"])
    assert "txn_per_s" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])


def test_open_loop_toy_run_is_correct(tmp_path, monkeypatch, capsys):
    """The open-loop path (records readable from their due times, the
    undecided scored after the close) stays correct; its latencies are on
    the stats line while no listed cell reports them."""
    import json

    monkeypatch.setattr(harness, "OUT_DIR", tmp_path)
    rc, out, _ = run_toy("distilbert-ensemble.backlog", open_loop=True)
    assert rc == 0 and out["correct"] is True and out["failed"] == 0
    stats = next(ln for ln in capsys.readouterr().err.splitlines()
                 if ln.startswith("perfbench stats "))
    stats = json.loads(stats[len("perfbench stats "):])
    assert 0 < stats["txn_p50_ms"] <= stats["txn_p99_ms"]


def test_import_check_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "realtime_fraud_detection_tpu_torch.x",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    for name in ("realtime_fraud_detection_tpu", "realtime_fraud_detection_tpu.ops",
                 "jax", "jax.numpy", "jaxlib", "flax.linen"):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, name, types.ModuleType(name))
            assert harness.forbidden_modules() == [name.split(".")[0]]


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.run("distilbert-ensemble.backlog", 1, 1.0, False, 0.0)
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("arrivals", [
    {"kind": "poisson", "rate_per_s": 500.0},
    {"kind": "diurnal", "trough_tps": 200.0, "peak_tps": 800.0, "period_s": 4.0,
     "burst_every_s": 2.0, "burst_offset_s": 1.0, "burst_duration_s": 0.25,
     "burst_mult": 4.0}])
def test_open_loop_arrivals_fix_the_work(arrivals):
    """Every seed gets the same number of arrivals, sorted inside the
    window; the seed moves only when they come."""
    from perfbench.traffic import arrival_times

    runs = [arrival_times(arrivals, 8.0, seed) for seed in (1, 2, 3_000_000_001)]
    assert len({len(r) for r in runs}) == 1 and len(runs[0]) > 1000
    for r in runs:
        assert (r[1:] >= r[:-1]).all() and r[0] >= 0.0 and r[-1] < 8.0
    assert not (runs[0] == runs[1]).all()
    assert (arrival_times(arrivals, 8.0, 1) == runs[0]).all()


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct(capsys):
    """On a card: a short run of a cell at its own sizes prints a correct
    result line (skipped without a CUDA device)."""
    import json
    import time

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc = harness.run("distilbert-ensemble.backlog", 3_000_000_777, 5.0, False,
                     time.perf_counter())
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"] is True
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
