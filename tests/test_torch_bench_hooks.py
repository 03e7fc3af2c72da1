"""The benchmark's three host hooks in the port, against the JAX package's.

- ``graph/drill.py run_graph_sampling_bench``: the graph's node counts and
  the sampler's counters equal JAX's (the timings are the host's own).
- ``cluster/drill.py run_shard_scaling`` at ``workers=(1, 2)``: a virtual
  clock, so the whole summary (makespans, txn/s, the kill run's handoff)
  equals JAX's exactly.
- ``cluster/elastic_drill.py run_elastic_scaling`` in the port alone at
  ``workers=(1, 2)``, ``n_txns=256``: real ``cluster-worker`` processes over
  the TCP broker, so only the schema, the SIGKILL's returncode and a replay
  deeper than 0 are checked. It runs on a thread started with the module,
  beside the other cases.
"""

import torch_threads  # first: torch held to one CPU thread
import threading

import pytest

from realtime_fraud_detection_tpu.cluster.drill import run_shard_scaling as jax_shard_scaling
from realtime_fraud_detection_tpu.graph.drill import (
    run_graph_sampling_bench as jax_graph_sampling_bench,
)
from realtime_fraud_detection_tpu_torch.cluster.drill import run_shard_scaling
from realtime_fraud_detection_tpu_torch.cluster.elastic_drill import run_elastic_scaling
from realtime_fraud_detection_tpu_torch.graph.drill import run_graph_sampling_bench


@pytest.fixture(scope="module", autouse=True)
def elastic():
    """``run_elastic_scaling(workers=(1, 2), n_txns=256)`` on a thread from
    the module's first case; the case that reads it waits for it."""
    out = {}

    def run():
        try:
            out["summary"] = run_elastic_scaling(workers=(1, 2), n_txns=256)
        except BaseException as e:            # reported by the reading case
            out["error"] = e

    worker = threading.Thread(target=run)
    worker.start()
    yield lambda: (worker.join(120), out)[1]
    worker.join(120)


def test_graph_sampling_counts_equal_jax():
    got, want = run_graph_sampling_bench(seed=7), jax_graph_sampling_bench(seed=7)
    assert list(got) == list(want)
    assert got["graph_nodes"] == want["graph_nodes"]
    assert got["sampler"] == want["sampler"]
    assert got["sampler"]["hits"] > 0 and got["graph_nodes"]["user"] == 4096
    for key in ("sampler_cold_us_per_txn", "sampler_cached_us_per_txn",
                "remote_per_node_us", "remote_batched_us_per_node"):
        assert got[key] > 0


def test_shard_scaling_equals_jax_on_the_virtual_clock():
    got = run_shard_scaling(seed=7, workers=(1, 2))
    assert got == jax_shard_scaling(seed=7, workers=(1, 2))
    assert set(got["workers"]) == {"1", "2"}
    assert got["scaling_vs_single"] > 1.5 and got["handoff"]["replayed"] > 0


def test_elastic_scaling_schema_kill_and_replay(elastic):
    out = elastic()
    assert "error" not in out, out.get("error")
    got = out["summary"]
    assert list(got) == ["n_txns", "n_partitions", "workers", "aggregate_txn_per_s",
                         "scaling_vs_min", "scaling_efficiency", "kill_run"]
    assert (got["n_txns"], got["n_partitions"]) == (256, 12)
    assert set(got["workers"]) == {"1", "2"}
    for run in got["workers"].values():
        assert set(run) == {"wall_s", "txn_per_s"} and run["txn_per_s"] > 0
    kill = got["kill_run"]
    assert kill["returncode"] == -9
    assert kill["replayed"] > 0
    assert kill["rebalance_pause_s"] is None or kill["rebalance_pause_s"] >= 0
