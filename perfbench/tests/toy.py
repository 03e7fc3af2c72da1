"""Toy sizes for the harness's CPU tests: every cell's path at a size a test
run holds (a 2-layer 128-wide encoder, 300 users, 32-row batches)."""

from __future__ import annotations

import io
import json
import time
from contextlib import redirect_stdout

from perfbench import harness, spec

TINY_ENCODER = {"vocab_size": 30522, "hidden_size": 128, "num_layers": 2,
                "num_heads": 2, "intermediate_size": 256,
                "max_position_embeddings": 512, "layer_norm_eps": 1e-12,
                "num_labels": 2}
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def overrides(cell_name: str, open_loop: bool = False) -> dict:
    """The cell at toy size; ``open_loop`` swaps its mix for Poisson
    arrivals, the harness's open-loop path."""
    cell = json.loads((spec.HERE / "workloads" / f"{cell_name}.json").read_text())
    open_loop = open_loop or cell["arrivals"]["kind"] != "backlog"
    return {"config": {"text_encoder": TINY_ENCODER},
            "cell": {"population": {"users": 300, "merchants": 60},
                     "arrivals": ({"kind": "poisson", "rate_per_s": 60} if open_loop
                                  else {"kind": "backlog", "depth_per_s": 3000}),
                     "job": {**cell["job"], "max_batch": 32},
                     "warmup": {"buckets": [8, 32] if open_loop else [32],
                                "batches_per_bucket": 1},
                     "check": {**cell["check"], "stride": 3, "batches": 4},
                     "profile": {"slice_s": 0.5}}}


def run_toy(cell_name: str, seed: int = 3_000_000_019, seconds: float = 1.5,
            trace: bool = False, open_loop: bool = False, **kw):
    """(exit code, last stdout line parsed, stdout text)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = harness.run(cell_name, seed, seconds, trace, time.perf_counter(),
                         device="cpu", overrides=overrides(cell_name, open_loop), **kw)
    text = buf.getvalue()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), text
