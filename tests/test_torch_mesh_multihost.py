"""The port's mesh executor in its multi-process ``mesh=`` mode
(``scoring/mesh_executor.py``, ``core/mesh.py build_multihost_mesh``), on
the CPU.

- ``run_two_process_step(2, 4, "cpu")``: two ``gloo`` processes, 4
  positions each, one global mesh of data 4 x model 2 with BERT stored split
  over ``model``. Each process returns its own 128 of 256 rows, bit for bit
  the same rows of a one-process ``score_fused_packed`` of the whole batch,
  with the kernels off and with ``full()`` (the plain versions on the CPU),
  and stores at most 0.6 of the replicated BERT bytes a position. The JAX
  counterpart is the third stage of ``__graft_entry__.py
  _dryrun_multihost_child``.
- The constructor's refusals, with the JAX package's message.
- A one-process ``mesh=`` executor against ``devices=`` on the same
  positions: the same stored blocks, the same rows bit for bit.
- Each process's share, on a mesh whose positions are owned by two ranks
  (built in this process): blocks only on its own positions, its own rows
  only, bit-equal to the whole batch's; then both processes' rows against
  the JAX package's one-process ``score_fused_packed`` on the JAX contract's
  seeds (models from ``PRNGKey(3)`` through the bridge, batch seed 13):
  decisions exact, probability and confidence within the JAX kernel drill's
  bf16 noise bound (``torch_bounds``), no row near a rung.
"""

import torch_threads  # first: torch held to one CPU thread
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu.core.packing import pack_tree as jax_pack_tree
from realtime_fraud_detection_tpu.ensemble.combine import EnsembleParams as JaxEnsembleParams
from realtime_fraud_detection_tpu.features.schema import TransactionBatch as JaxTransactionBatch
from realtime_fraud_detection_tpu.models import bert as jbert
from realtime_fraud_detection_tpu.scoring import MeshExecutor as JaxMeshExecutor
from realtime_fraud_detection_tpu.scoring import pipeline as jax_pipeline
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.core.mesh import (
    AXIS_NAMES,
    Mesh,
    MeshConfig,
    build_multihost_mesh,
    process_row_span,
)
from realtime_fraud_detection_tpu_torch.core.packing import pack_tree
from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
from realtime_fraud_detection_tpu_torch.parallel.train import run_two_process_step
from realtime_fraud_detection_tpu_torch.scoring.mesh_executor import ROW_BLOCK, MeshExecutor
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    MODEL_NAMES,
    OUT_COLUMNS,
    ScorerConfig,
    init_scoring_models,
    make_example_batch,
    score_fused_packed,
)
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from torch_bounds import near_rung, noise_bound

CPU8 = ["cpu"] * 8
SC = ScorerConfig(text_len=16)
N = 4 * ROW_BLOCK                     # a data-4 mesh's batch: 64 rows a data row
MV = np.ones(len(MODEL_NAMES), bool)
DEC, RISK = OUT_COLUMNS.index("decision"), OUT_COLUMNS.index("risk_level")


@pytest.fixture(scope="module", autouse=True)
def two_process():
    """``run_two_process_step(2, 4, "cpu")``, started on a thread before the
    module's first test: its processes run beside the in-process tests, and
    the test that reads it comes last."""
    out = {}
    worker = threading.Thread(target=lambda: out.update(
        run_two_process_step(2, 4, "cpu", env=torch_threads.spawn_env())))
    worker.start()
    yield lambda: (worker.join(300), out)[1]
    worker.join(300)


@pytest.fixture(scope="module")
def port_models():
    return init_scoring_models(3, TINY_CONFIG, feature_dim=SC.feature_dim,
                               node_dim=SC.node_dim)


def _scorer(models):
    return TorchFraudScorer(models=models, scorer_config=SC, bert_config=TINY_CONFIG,
                            device="cpu")


def _blobs(seed=13):
    return pack_tree(make_example_batch(N, SC, rng=np.random.default_rng(seed)))


def _score(ex, blobs, spec):
    return ex.wait(ex.dispatch_packed(blobs, spec, ex.scorer.ensemble_params, MV)).numpy()


def _whole(scorer, blobs, spec):
    """A one-process ``score_fused_packed`` of the whole batch."""
    dev = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in blobs.items()
           if v is not None}
    return score_fused_packed(scorer.models, dev, spec, scorer.ensemble_params,
                              torch.from_numpy(MV), bert_config=TINY_CONFIG).numpy()


def _two_rank_mesh(rank):
    """The global data 4 x model 2 mesh of two processes with 4 positions
    each (process-major along ``data``), as ``rank`` sees it."""
    devs = np.empty(8, dtype=object)
    devs[:] = [torch.device("cpu")] * 8
    ranks = np.repeat([0, 1], 4).reshape(4, 2, 1)
    return Mesh(devs.reshape(4, 2, 1), AXIS_NAMES, ranks=ranks, rank=rank)


@pytest.mark.parametrize("kwargs", [dict(devices=CPU8), dict(replicas=2)],
                         ids=["devices", "replicas"])
def test_mesh_refuses_devices_or_replicas_with_jax_message(port_models, kwargs):
    mesh = build_multihost_mesh(MeshConfig(model=2), CPU8)
    with pytest.raises(ValueError) as want:
        JaxMeshExecutor(None, mesh=object(), **kwargs)
    with pytest.raises(ValueError) as got:
        MeshExecutor(_scorer(port_models), mesh=mesh, **kwargs)
    assert str(got.value) == str(want.value)
    assert "pre-built mesh=" in str(got.value)


def test_one_process_mesh_equals_devices_bit_for_bit(port_models):
    blobs, spec = _blobs()
    by_devices = MeshExecutor(_scorer(port_models), devices=CPU8, model_axis=2,
                              inflight_depth=1, shard_branches=("bert_text",))
    mesh = build_multihost_mesh(MeshConfig(model=2), CPU8)
    by_mesh = MeshExecutor(_scorer(port_models), mesh=mesh, inflight_depth=1,
                           shard_branches=("bert_text",))
    assert not by_mesh.multihost and not by_devices.multihost
    assert (by_mesh.data_axis, by_mesh.model_axis, by_mesh.batch_multiple) == \
        (by_devices.data_axis, by_devices.model_axis, by_devices.batch_multiple) == (4, 2, N)
    assert mesh.local_data_rows() == [0, 1, 2, 3]
    assert process_row_span(mesh, N) == slice(0, N)
    a, b = by_devices.replicas[0].stored, by_mesh.replicas[0].stored
    assert a.keys() == b.keys() == set(mesh.positions())
    for pos in a:
        assert torch.equal(a[pos].bert["word_emb"], b[pos].bert["word_emb"])
    got = _score(by_mesh, blobs, spec)
    assert got.tobytes() == _score(by_devices, blobs, spec).tobytes()
    assert by_mesh.param_bytes() == by_devices.param_bytes()
    # all but the host clock's queue wait
    assert [{**r, "queue_wait_ms": 0} for r in by_mesh.stats()["replicas"]] == \
        [{**r, "queue_wait_ms": 0} for r in by_devices.stats()["replicas"]]
    assert by_mesh.mesh_snapshot().keys() == by_devices.mesh_snapshot().keys()


@pytest.fixture(scope="module")
def jax_contract():
    """The JAX contract's models (``init_scoring_models(PRNGKey(3))``, TINY,
    numpy leaves) and its one-process ``score_fused_packed`` of the whole
    256-row batch from seed 13."""
    jmodels = jax.tree_util.tree_map(np.asarray, jax_pipeline.init_scoring_models(
        jax.random.PRNGKey(3), bert_config=jbert.TINY_CONFIG,
        feature_dim=SC.feature_dim, node_dim=SC.node_dim))
    batch = make_example_batch(N, SC, rng=np.random.default_rng(13))
    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)
              if f.name != "txn"}
    jbatch = jax_pipeline.ScoreBatch(txn=JaxTransactionBatch(**vars(batch.txn)), **fields)
    blobs, spec = jax_pack_tree(jbatch)
    ens = JaxEnsembleParams.from_config(JaxConfig(), list(MODEL_NAMES))
    want = np.asarray(jax_pipeline.score_fused_packed(
        jmodels, blobs["f32"], blobs["i32"], blobs["u8"], spec=spec, params=ens,
        model_valid=MV, blob_bf16=blobs.get("bf16"), bert_config=jbert.TINY_CONFIG))
    weights = np.asarray(ens.weights)
    bound = noise_bound(jmodels.bert, [(batch.token_ids, batch.token_mask)], weights, MV)
    return jmodels, want, bound


@pytest.mark.parametrize("rank", [0, 1])
def test_each_process_share_on_a_two_rank_mesh(port_models, jax_contract, rank):
    # the port's own models: this rank's rows bit-equal to the whole batch's
    blobs, spec = _blobs()
    mesh = _two_rank_mesh(rank)
    scorer = _scorer(port_models)
    ex = MeshExecutor(scorer, mesh=mesh, inflight_depth=1, shard_branches=("bert_text",))
    assert ex.multihost and (ex.data_axis, ex.model_axis, ex.batch_multiple) == (4, 2, N)
    local = set(mesh.local_positions())
    assert set(ex.replicas[0].stored) == local and len(local) == 4
    assert mesh.local_data_rows() == [2 * rank, 2 * rank + 1]
    span = process_row_span(mesh, N)
    assert span == slice(rank * N // 2, (rank + 1) * N // 2)
    got = _score(ex, blobs, spec)
    assert got.tobytes() == _whole(scorer, blobs, spec)[span].tobytes()
    pb = ex.param_bytes()["bert_text"]
    assert pb["per_chip"] <= 0.6 * pb["replicated"]
    # a swap re-places on this rank's positions only
    scorer.set_models(init_scoring_models(5, TINY_CONFIG, feature_dim=SC.feature_dim,
                                          node_dim=SC.node_dim))
    assert set(ex.replicas[0].stored) == local
    assert ex.stats()["replicas"][0]["devices"] == 8

    # the JAX contract's models and batch: this rank's rows against JAX's
    jmodels, want, bound = jax_contract
    bridged = _scorer(models_from_numpy(jmodels))
    ex = MeshExecutor(bridged, mesh=mesh, inflight_depth=1, shard_branches=("bert_text",))
    got = _score(ex, *_blobs())
    mine = want[span]
    assert got.shape == mine.shape
    assert not (near_rung(mine[:, 0], bound) | near_rung(mine[:, 1], bound)).any()
    np.testing.assert_array_equal(got[:, [DEC, RISK]], mine[:, [DEC, RISK]])
    np.testing.assert_allclose(got[:, :2], mine[:, :2], rtol=0, atol=bound)


@pytest.mark.parametrize("mode", ["off", "full"])
def test_two_gloo_processes_return_their_own_rows_bit_equal(two_process, mode):
    out = two_process()
    assert out["passed"], out
    lines = out["processes"]
    assert [r["process"] for r in lines] == [0, 1]
    for line in lines:
        assert line["mesh_geometry"] == {"data": 4, "model": 2, "seq": 1}
        assert line["mesh_width"] == "tiny"
        run = line["mesh_runs"][mode]
        assert run["multihost"] and run["finite"]
        assert (run["rows"], run["batch"]) == (N // 2, N)
        assert run["bit_equal"] and run["max_abs"] == 0.0
        assert run["bert_per_chip"] <= 0.6 * run["bert_replicated"]
        # the plain versions on the CPU: no hand-written launch
        assert not any(run["launches"].values())
    assert all(line["mesh_bit_equal"] and line["mesh_multihost"] for line in lines)
    # both processes store the same share of the same models
    assert lines[0]["mesh_runs"][mode]["bert_per_chip"] == \
        lines[1]["mesh_runs"][mode]["bert_per_chip"]
