"""The readers of the program's own stage spans and collector counter, on
synthetic run contexts, a synthetic Chrome trace and a traced toy run."""

from __future__ import annotations

import json

import pytest

from perfbench import harness, spec
from perfbench.trace import read_trace
from perfbench.tests.toy import run_toy

STAGE_READERS = {"h2d_ms.backlog": "h2d", "launch_ms.backlog": "launch",
                 "responses_ms.backlog": "responses",
                 "write_back_ms.backlog": "write_back",
                 "fan_out_ms.backlog": "fan_out"}
NEW = [*STAGE_READERS, "gc_gen2_ms.backlog", "idle_gc_pct.backlog"]


def _ctx(before, at_slice, t0=100.0, slice_=110.0, trace=None):
    return {"t0": t0, "seconds": 51.0, "slice": slice_,
            "slice_end": None if slice_ is None else slice_ + 3.0,
            "stages_before": before, "stages_at_slice": at_slice, "trace": trace,
            "spans": [], "gc_pauses": []}


@pytest.mark.parametrize("metric", sorted(STAGE_READERS))
def test_a_stage_reader_takes_the_mean_between_the_two_snapshots(metric):
    stage = STAGE_READERS[metric]
    read = spec.reader(metric)
    before = {stage: {"count": 10_000, "total_s": 40.0, "mean_ms": 4.0}}
    # past the sample ring's 10,000: the cumulative totals still difference
    after = {stage: {"count": 10_400, "total_s": 42.0, "mean_ms": 4.04}}
    assert read(_ctx(before, after)) == pytest.approx(5.0)
    # a stage the window never reached, and a program without the stage
    assert read(_ctx(before, before)) is None
    assert read(_ctx({}, {"dispatch": {"count": 3, "total_s": 0.1}})) is None
    assert read(_ctx({}, None)) is None


def test_gc_gen2_reads_pause_ms_a_second_before_the_slice():
    read = spec.reader("gc_gen2_ms.backlog")
    before = {"gc.gen0": {"count": 5, "total_s": 0.01, "mean_ms": 2.0}}
    after = {"gc.gen0": {"count": 900, "total_s": 0.2, "mean_ms": 0.2},
             "gc.gen2": {"count": 2, "total_s": 1.5, "mean_ms": 750.0}}
    # no gen-2 entry before the window: read as 0; 1.5 s over a 10 s span
    assert read(_ctx(before, after)) == pytest.approx(150.0)
    # no full collection at all: 0, not nothing
    assert read(_ctx(before, before)) == 0.0
    # a program that counts no collections, or no slice: nothing
    assert read(_ctx({}, {"dispatch": {"count": 3, "total_s": 0.1}})) is None
    assert read(_ctx(before, None, slice_=None)) is None


def _chrome(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_idle_under_a_collection_region_counts_toward_idle_gc(tmp_path):
    """Three idle gaps on the card between four kernels: one whose middle
    lies in ``rtfd.gc.gen2``, one in ``rtfd.tokens``, one in the job step
    alone. Only the first counts."""
    events = [
        _x("job.dispatch_batch", "user_annotation", 0, 10_000),
        _x("rtfd.assemble", "user_annotation", 50, 6_000),
        _x("rtfd.tokens", "user_annotation", 1_000, 2_000),
        _x("rtfd.gc.gen2", "user_annotation", 3_200, 1_600),
        _x("k0", "kernel", 0, 100),
        _x("k1", "kernel", 1_900, 100),     # gap 100..1900: mid 1000 -> tokens
        _x("k2", "kernel", 3_000, 100),     # gap 2000..3000: mid 2500 -> tokens
        _x("k3", "kernel", 4_900, 100),     # gap 3100..4900: mid 4000 -> gc.gen2
        _x("k4", "kernel", 9_000, 1_000),   # gap 5000..9000: mid 7000 -> job alone
    ]
    tr = read_trace(_chrome(tmp_path, events))
    assert tr["gaps"]["job.dispatch_batch > rtfd.gc.gen2"] == pytest.approx(1.8e-3)
    assert tr["gaps"]["job.dispatch_batch > rtfd.tokens"] == pytest.approx(2.8e-3)
    assert tr["gaps"]["job.dispatch_batch"] == pytest.approx(4.0e-3)
    read = spec.reader("idle_gc_pct.backlog")
    assert read(_ctx({}, {}, trace=tr)) == pytest.approx(100.0 * 1.8e-3 / 10e-3)


def test_idle_gc_reads_zero_without_a_collection_gap_and_none_without_a_trace(tmp_path):
    read = spec.reader("idle_gc_pct.backlog")
    events = [_x("job.dispatch_batch", "user_annotation", 0, 5_000),
              _x("rtfd.tokens", "user_annotation", 100, 4_000),
              _x("k0", "kernel", 0, 100), _x("k1", "kernel", 4_900, 100)]
    assert read(_ctx({}, {}, trace=read_trace(_chrome(tmp_path, events)))) == 0.0
    assert read(_ctx({}, {}, trace=None)) is None
    # a program that opens no region of its own: nothing to read
    bare = [_x("job.dispatch_batch", "user_annotation", 0, 5_000),
            _x("k0", "kernel", 0, 100), _x("k1", "kernel", 4_900, 100)]
    assert read(_ctx({}, {}, trace=read_trace(_chrome(tmp_path, bare)))) is None


def test_the_new_metrics_are_listed_in_both_backlog_cells():
    bench = spec.benchmark()
    listed = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]]
    for name in NEW:
        assert listed[name]["moves"] == "txn_per_s"
        assert listed[name]["workloads"] == cells


def test_a_traced_toy_run_reports_the_host_splits(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "OUT_DIR", tmp_path)
    rc, out, _ = run_toy("distilbert-ensemble.backlog", trace=True, seconds=3.0)
    assert rc == 0 and out["correct"] is True
    got = out["metrics"]
    assert {*STAGE_READERS, "gc_gen2_ms.backlog"} <= set(got)
    # the splits lie inside the stages they split
    assert got["h2d_ms.backlog"]["value"] + got["launch_ms.backlog"]["value"] \
        <= got["dispatch_ms.backlog"]["value"]
