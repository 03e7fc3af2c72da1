"""The port's mesh executor (``scoring/mesh_executor.py``), its layouts
(``parallel/layouts.py``), ``MeshSettings``, the ``mesh_*`` families and the
mesh drill, against the JAX package's, on the CPU.

- Storage specs leaf by leaf against JAX's ``parallel/layouts.py`` (f32 and
  int8 BERT, every placement of ``branch_serving_specs``), the stored
  blocks against the specs, the bytes a position stores.
- The executor's contract, mirroring JAX ``tests/test_mesh_executor.py``:
  the batch-multiple seam, the device split, round-robin and slots, the
  QoS mask per dispatch, bit-equality with the port's single-device scorer
  (f32, int8, under a rung), the hot swap, a failed replica (no rescue).
- The port's ``MeshExecutor`` against JAX's ``MeshExecutor`` on conftest's
  virtual 8-device CPU mesh, from the same weights through the bridge, for
  every placement combo of the drill and every ladder rung: decisions
  exact, probabilities within the JAX kernel drill's bf16 noise bound
  (``torch_bounds``), no row near a rung.
- A checkpoint restored into a mesh-attached scorer; ``ServingApp``
  building the executor from ``mesh.enabled``, the ``mesh_*`` exposition
  equal to JAX's line for line; ``MeshSettings.validate`` as JAX's.
- ``mesh-drill --fast --device cpu``: every check true, the check set
  JAX's minus its two donation checks.
"""

import torch_threads  # first: torch held to one CPU thread
import asyncio
import json
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu.obs.metrics import MetricsCollector as JaxMetricsCollector
from realtime_fraud_detection_tpu.parallel import layouts as jlayouts
from realtime_fraud_detection_tpu.qos.ladder import LADDER_LEVELS as JAX_LADDER
from realtime_fraud_detection_tpu.scoring import FraudScorer
from realtime_fraud_detection_tpu.scoring import MeshExecutor as JaxMeshExecutor
from realtime_fraud_detection_tpu.scoring import ScorerConfig as JaxScorerConfig
from realtime_fraud_detection_tpu.utils import config as jconfig
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.checkpoint import CheckpointManager
from realtime_fraud_detection_tpu_torch.core.mesh import MODEL_AXIS, P, tree_leaves, tree_map
from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
from realtime_fraud_detection_tpu_torch.obs.metrics import MetricsCollector
from realtime_fraud_detection_tpu_torch.parallel.layouts import (
    SHARDABLE_BRANCHES,
    bert_serving_param_specs,
    branch_serving_specs,
    leaf_storage_spec,
)
from realtime_fraud_detection_tpu_torch.qos.ladder import LADDER_LEVELS
from realtime_fraud_detection_tpu_torch.scoring.mesh_executor import ROW_BLOCK, MeshExecutor
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    MODEL_NAMES,
    ScorerConfig,
    init_scoring_models,
)
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.utils.config import (
    MESH_SHARDABLE_BRANCHES,
    Config,
    MeshSettings,
    QuantSettings,
)
from test_torch_stream import _jax_models
from torch_bounds import near_rung, noise_bound

ROOT = Path(__file__).resolve().parents[1]
CPU8 = ["cpu"] * 8
NOW = 1000.0
# a batch whose rows fill every data shard of a data-4 mesh: 64-row shards
# against a 256-row single-device batch, the mesh's contract
WHOLE = 4 * ROW_BLOCK
ALL_NEURAL = ("bert_text", "graph_neural", "lstm_sequential")
# JAX's drill checks (scoring/mesh_drill.py) but its two donation checks
DRILL_COMBOS = ("data_only", "bert_sharded", "all_neural_sharded", "pool_x_mesh",
                "quant_bert_sharded", "quant_all_neural_sharded")
DRILL_CHECKS = ({f"bit_identical_{c}" for c in DRILL_COMBOS}
                | {f"fifo_{c}" for c in DRILL_COMBOS}
                | {f"bert_bytes_{c}" for c in DRILL_COMBOS if c != "data_only"}
                | {"all_mesh_replicas_utilized", "round_robin_assignment",
                   "bit_identical_all_ladder_rungs", "no_mixed_params_batch",
                   "swap_preserves_sharding", "replay_bit_identical"})


@pytest.fixture(scope="module", autouse=True)
def drill_command():
    """``mesh-drill --fast --device cpu``, started before the module's first
    test: it runs beside the others."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "realtime_fraud_detection_tpu_torch", "mesh-drill",
         "--fast", "--device", "cpu"], cwd=ROOT, env=torch_threads.spawn_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def make_scorer(seed=3, model_seed=0, quant=False, models=None, **kw):
    gen = TransactionGenerator(num_users=300, num_merchants=60, seed=seed)
    cfg = Config(quant=QuantSettings.full()) if quant else None
    s = TorchFraudScorer(config=cfg, models=models, seed=model_seed, device="cpu", **kw)
    s.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    return gen, s


def rows(results):
    return [(r["transaction_id"], r["fraud_probability"], r["confidence"],
             r["decision"]) for r in results]


def _norm(tree):
    """A spec tree (port or JAX) as nested dicts / lists of normalised
    tuples."""
    def one(spec):
        return tuple(P(*spec).normalized())
    if isinstance(tree, P) or type(tree).__name__ == "PartitionSpec":
        return one(tree)
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_norm(v) for v in tree]
    return {f: _norm(getattr(tree, f)) for f in ("trees", "iforest", "lstm", "gnn",
                                                 "bert", "feature", "threshold", "leaf",
                                                 "base_score", "path_length", "c_psi")
            if hasattr(tree, f)}


# ------------------------------------------------------------ storage specs
def test_shardable_branches_pinned_to_config_and_jax():
    assert sorted(MESH_SHARDABLE_BRANCHES) == sorted(SHARDABLE_BRANCHES)
    assert SHARDABLE_BRANCHES == jlayouts.SHARDABLE_BRANCHES
    assert MESH_SHARDABLE_BRANCHES == jconfig.MESH_SHARDABLE_BRANCHES


@pytest.mark.parametrize("shape,axis", [((192, 512), 2), ((512,), 2), ((7, 3), 2), ((), 2),
                                        ((512, 64), 1), ((16, 16), 4), ((30522, 128), 4)])
def test_leaf_storage_spec_rules_equal_jax(shape, axis):
    got = leaf_storage_spec(np.zeros(shape), axis)
    assert got.normalized() == P(*jlayouts.leaf_storage_spec(np.zeros(shape), axis)).normalized()


@pytest.fixture(scope="module")
def jax_models():
    return _jax_models()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("axis", [2, 4])
def test_serving_specs_equal_jax_leaf_by_leaf(jax_models, quant, axis):
    from realtime_fraud_detection_tpu.models.quant import quantize_bert_params as jquant

    jm = jax_models.replace(bert=jquant(jax_models.bert)) if quant else jax_models
    jm = jax.tree_util.tree_map(np.asarray, jm)
    pm = models_from_numpy(jm)
    assert _norm(bert_serving_param_specs(pm.bert, axis)) == \
        _norm(jlayouts.bert_serving_param_specs(jm.bert, axis))
    for placement in ((), ("bert_text",), ALL_NEURAL, ("lstm_sequential",)):
        assert _norm(branch_serving_specs(pm, axis, placement)) == \
            _norm(jlayouts.branch_serving_specs(jm, axis, placement)), placement
    layer = bert_serving_param_specs(pm.bert, 2)["layers"][0]
    wkey = "qw" if quant else "w"
    assert layer["q"][wkey] == P(None, MODEL_AXIS) and layer["o"][wkey] == P(MODEL_AXIS)
    with pytest.raises(ValueError, match="not shardable"):
        branch_serving_specs(pm, 2, ("xgboost_primary",))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_stored_blocks_honor_specs_and_bytes(quant):
    _, s = make_scorer(quant=quant)
    ex = MeshExecutor(s, devices=CPU8, model_axis=2,
                      shard_branches=("bert_text", "lstm_sequential"))
    rep = ex.replicas[0]
    specs = branch_serving_specs(s.models, 2, ("bert_text", "lstm_sequential"))
    for pos, stored in rep.stored.items():
        for field in ("bert", "lstm"):
            def check(spec, full, block):
                want = list(full.shape)
                if spec != P():
                    want[list(spec).index(MODEL_AXIS)] //= 2
                assert list(block.shape) == want
                if spec == P():
                    assert block is full          # replicated: the shared tensor
            tree_map(check, getattr(specs, field), getattr(s.models, field),
                     getattr(stored, field))
        # un-named branches are the scorer's own tensors (one device)
        for field in ("gnn", "trees"):
            assert all(a is b for a, b in zip(tree_leaves(getattr(stored, field)),
                                              tree_leaves(getattr(s.models, field))))
    pb = ex.param_bytes()
    assert pb["bert_text"]["per_chip"] <= 0.6 * pb["bert_text"]["replicated"]
    assert pb["graph_neural"]["per_chip"] == pb["graph_neural"]["replicated"]


# --------------------------------------------------------- executor basics
def test_batch_multiple_seam_and_model_info():
    gen, s = make_scorer()
    ex = MeshExecutor(s, devices=CPU8, model_axis=2, shard_branches=("bert_text",))
    assert ex.data_axis == 4 and ex.batch_multiple == 4 * ROW_BLOCK
    pending = s.dispatch(gen.generate_batch(5), now=NOW)
    assert s.finalize(pending, now=NOW) and pending.out.shape[0] == 4 * ROW_BLOCK
    # an unmeshed scorer keeps its buckets
    gen_b, plain = make_scorer()
    pending = plain.dispatch(gen_b.generate_batch(5), now=NOW)
    assert plain.finalize(pending, now=NOW) and pending.out.shape[0] == 8
    assert s.model_info()["mesh"] == {"data": 4, "model": 2, "seq": 1}


def test_device_split_validation():
    _, s = make_scorer()
    with pytest.raises(ValueError, match="equal"):
        MeshExecutor(s, devices=CPU8, replicas=3)
    with pytest.raises(ValueError, match="model_axis"):
        MeshExecutor(s, devices=CPU8, model_axis=3)
    with pytest.raises(ValueError, match="not shardable"):
        MeshExecutor(s, devices=CPU8, model_axis=2, shard_branches=("xgboost_primary",))


def test_round_robin_slots_and_failed_replica_raises():
    gen, s = make_scorer()
    ex = MeshExecutor(s, devices=CPU8, model_axis=2, replicas=2, inflight_depth=2,
                      shard_branches=())
    assert len(ex) == 2 and ex.total_slots() == 4
    pend = [s.dispatch(gen.generate_batch(4), now=NOW) for _ in range(4)]
    assert list(ex.assignment_log) == [0, 1, 0, 1]
    assert [p.pool_token.replica_idx for p in pend] == [0, 1, 0, 1]
    for p in pend:
        s.finalize(p, now=NOW)
    st = ex.stats()
    assert st["dispatched"] == 4 and st["completed"] == 4 and st["kind"] == "mesh"
    # no rescue: the failed replica is marked and the batch raises
    p = s.dispatch(gen.generate_batch(4), now=NOW)
    ex.inject_fault(p.pool_token.replica_idx)
    with pytest.raises(RuntimeError, match="injected"):
        s.finalize(p, now=NOW)
    assert ex.healthy_count == 1 and ex.stats()["replicas"][0]["failures"] == 1
    assert s.dispatch(gen.generate_batch(4), now=NOW).pool_token.replica_idx == 1


def test_degradation_masks_flow_through():
    gen, s = make_scorer()
    MeshExecutor(s, devices=CPU8, model_axis=2, shard_branches=("bert_text",))
    s.set_degradation(np.asarray([True, False, False, False, True]), level=2)
    for r in s.score_batch(gen.generate_batch(4), now=NOW):
        assert set(r["model_predictions"]) == {"xgboost_primary", "isolation_forest"}


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_mesh_equals_single_device(quant):
    gen_a, ref = make_scorer(quant=quant)
    want = [rows(ref.score_batch(gen_a.generate_batch(WHOLE), now=NOW)) for _ in range(2)]
    gen_b, meshed = make_scorer(quant=quant)
    MeshExecutor(meshed, devices=CPU8, model_axis=2, shard_branches=ALL_NEURAL)
    got = [rows(meshed.score_batch(gen_b.generate_batch(WHOLE), now=NOW)) for _ in range(2)]
    assert got == want


def test_mesh_equals_single_device_under_rung_and_hot_swap():
    gen_a, ref = make_scorer()
    gen_b, meshed = make_scorer()
    ex = MeshExecutor(meshed, devices=CPU8, model_axis=2, shard_branches=("bert_text",))
    mask = np.asarray([True, True, False, False, True])
    ref.set_degradation(mask, level=1)
    meshed.set_degradation(mask, level=1)
    assert rows(meshed.score_batch(gen_b.generate_batch(WHOLE), now=NOW)) == \
        rows(ref.score_batch(gen_a.generate_batch(WHOLE), now=NOW))
    before = rows(meshed.score_batch(gen_b.generate_batch(WHOLE), now=NOW))
    ref.score_batch(gen_a.generate_batch(WHOLE), now=NOW)
    new = init_scoring_models(42, bert_config=meshed.bert_config)
    meshed.set_models(new)
    ref.set_models(new)
    after = rows(meshed.score_batch(gen_b.generate_batch(WHOLE), now=NOW))
    assert after == rows(ref.score_batch(gen_a.generate_batch(WHOLE), now=NOW))
    assert before != after
    pb = ex.param_bytes()["bert_text"]
    assert pb["per_chip"] <= 0.6 * pb["replicated"]


def test_row_blocks_score_alike_and_trees_contract_contiguous():
    """What the mesh's bit-equality stands on, op by op on the CPU: the
    packed scorer (TINY, int8 BERT, GEMM-form trees) gives a 256-row batch's
    rows bit for bit as four 64-row shards do, and the GEMM-form trees'
    contraction is contiguous (the einsum's own layout sums over trees in an
    order that depends on the batch on the card)."""
    import dataclasses

    from realtime_fraud_detection_tpu_torch.core.packing import pack_tree
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.models.quant import quantize_bert_params
    from realtime_fraud_detection_tpu_torch.models.trees import gemm_leaf_contract
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
        make_example_batch,
        score_fused_packed,
    )

    models = init_scoring_models(0)
    models = dataclasses.replace(models, bert=quantize_bert_params(models.bert)).to("cpu")
    ens = EnsembleParams.from_config(Config(), MODEL_NAMES)
    blobs, spec = pack_tree(make_example_batch(WHOLE, rng=np.random.default_rng(0)))
    blobs = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in blobs.items()}

    def packed(a, m):
        return score_fused_packed(models, {k: v[a:a + m] for k, v in blobs.items()}, spec,
                                  ens, torch.ones(5, dtype=torch.bool),
                                  bert_config=TINY_CONFIG, tree_kernel="gemm",
                                  iforest_kernel="gemm")

    whole = packed(0, WHOLE)
    shards = torch.cat([packed(i * ROW_BLOCK, ROW_BLOCK) for i in range(4)])
    assert torch.equal(whole, shards)
    tr = models.trees
    x = torch.rand(WHOLE, 64, generator=torch.Generator().manual_seed(0))
    full = gemm_leaf_contract(tr.feature, tr.threshold, tr.leaf, x)
    assert full.is_contiguous()
    assert torch.equal(full[:ROW_BLOCK],
                       gemm_leaf_contract(tr.feature, tr.threshold, tr.leaf, x[:ROW_BLOCK]))


def test_batch_invariant_blas_sets_or_refuses(monkeypatch):
    from realtime_fraud_detection_tpu_torch.core import precision

    for key in precision.BATCH_INVARIANT_BLAS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="split-K"):
        precision.batch_invariant_blas()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    precision.batch_invariant_blas()
    for key, value in precision.BATCH_INVARIANT_BLAS.items():
        assert precision.os.environ[key] == value
    # already in force: nothing to refuse
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    precision.batch_invariant_blas()


def test_mesh_drill_refuses_a_batch_of_partial_blocks():
    from realtime_fraud_detection_tpu_torch.scoring.mesh_drill import (
        MeshDrillConfig,
        run_mesh_drill,
    )

    with pytest.raises(ValueError, match="64-row blocks"):
        run_mesh_drill(MeshDrillConfig(batch=32, device="cpu"))


# ------------------------------------------------------------ against JAX
def _jax_run(jax_models, quant, kwargs, rung_schedule, batches, profiles):
    from realtime_fraud_detection_tpu.core.mesh import build_mesh as jbuild_mesh
    from realtime_fraud_detection_tpu.utils.config import (
        Config as JaxConfig,
        QuantSettings as JaxQuant,
    )

    js = FraudScorer(config=JaxConfig(quant=JaxQuant.full()) if quant else None,
                     models=jax_models, scorer_config=JaxScorerConfig(text_len=32),
                     mesh=jbuild_mesh(devices=jax.devices()[:1]))
    tokens = []
    assemble = js.assemble

    def keep(*a, **k):
        batch = assemble(*a, **k)
        tokens.append((np.asarray(batch.token_ids), np.asarray(batch.token_mask)))
        return batch

    js.assemble = keep
    js.seed_profiles(*profiles)
    JaxMeshExecutor(js, model_axis=2, inflight_depth=2, **kwargs)
    return _stream(js, batches, rung_schedule, JAX_LADDER), tokens


def _stream(scorer, batches, rung_schedule, ladder):
    out, inflight = [], []
    for i, b in enumerate(batches):
        if i in rung_schedule:
            rung = ladder[rung_schedule[i]]
            scorer.set_degradation(
                np.asarray([n not in rung.dropped_branches for n in MODEL_NAMES]),
                rules_only=rung.rules_only, level=rung_schedule[i])
        inflight.append(scorer.dispatch(b, now=NOW))
        while len(inflight) >= 2:
            out.extend(scorer.finalize(inflight.pop(0), now=NOW))
    while inflight:
        out.extend(scorer.finalize(inflight.pop(0), now=NOW))
    return out


JAX_COMBOS = [
    ("data_only", False, dict(replicas=1, shard_branches=())),
    ("bert_sharded", False, dict(replicas=1, shard_branches=("bert_text",))),
    ("all_neural_sharded", False, dict(replicas=1, shard_branches=ALL_NEURAL)),
    ("pool_x_mesh", False, dict(replicas=2, shard_branches=("bert_text",))),
    ("quant_bert_sharded", True, dict(replicas=1, shard_branches=("bert_text",))),
    ("quant_all_neural_sharded", True, dict(replicas=1, shard_branches=ALL_NEURAL)),
    ("ladder_rungs", False, dict(replicas=1, shard_branches=ALL_NEURAL)),
]


@pytest.mark.parametrize("name,quant,kwargs", JAX_COMBOS, ids=[c[0] for c in JAX_COMBOS])
def test_mesh_executor_matches_jax(jax_models, name, quant, kwargs):
    gen = TransactionGenerator(num_users=200, num_merchants=50, seed=21)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    n_batches = 2 * len(LADDER_LEVELS) if name == "ladder_rungs" else 3
    batches = [gen.generate_batch(32) for _ in range(n_batches)]
    schedule = ({2 * i: i for i in range(len(LADDER_LEVELS))}
                if name == "ladder_rungs" else {})
    want, tokens = _jax_run(jax_models, quant, kwargs, schedule, batches, profiles)
    ps = TorchFraudScorer(config=Config(quant=QuantSettings.full()) if quant else None,
                          models=models_from_numpy(jax_models),
                          scorer_config=ScorerConfig(text_len=32), device="cpu")
    ps.seed_profiles(*profiles)
    MeshExecutor(ps, devices=CPU8, model_axis=2, inflight_depth=2, **kwargs)
    got = _stream(ps, batches, schedule, LADDER_LEVELS)
    weights = EnsembleParams.from_config(Config(), MODEL_NAMES).weights.numpy()
    bound = noise_bound(jax_models.bert, tokens, weights, np.ones(5, bool))
    assert [r["transaction_id"] for r in got] == [r["transaction_id"] for r in want]
    prob = np.array([r["fraud_probability"] for r in want])
    conf = np.array([r["confidence"] for r in want])
    assert int((near_rung(prob, bound) | near_rung(conf, bound)).sum()) == 0
    for p, q in zip(got, want):
        assert (p["decision"], p["risk_level"]) == (q["decision"], q["risk_level"])
        assert set(p["model_predictions"]) == set(q["model_predictions"])
    np.testing.assert_allclose([p["fraud_probability"] for p in got], prob,
                               rtol=0, atol=bound)


# -------------------------------------------------- checkpoint and service
def test_checkpoint_restore_into_mesh_attached_scorer(tmp_path):
    CheckpointManager(tmp_path / "ck").save(1, params=init_scoring_models(77))
    gen_a, ref = make_scorer()
    CheckpointManager(tmp_path / "ck").restore_into_scorer(ref)
    want = rows(ref.score_batch(gen_a.generate_batch(WHOLE), now=NOW))
    gen_b, meshed = make_scorer()
    ex = MeshExecutor(meshed, devices=CPU8, model_axis=2, shard_branches=("bert_text",))
    CheckpointManager(tmp_path / "ck").restore_into_scorer(meshed, lock=threading.Lock())
    assert rows(meshed.score_batch(gen_b.generate_batch(WHOLE), now=NOW)) == want
    pb = ex.param_bytes()["bert_text"]
    assert pb["per_chip"] <= 0.6 * pb["replicated"]
    # the stored blocks are the restored models', not the old ones
    assert torch.equal(ex.replicas[0].stored[(0, 0, 0)].trees.leaf, meshed.models.trees.leaf)


def test_serving_app_builds_the_executor_and_mirrors_it():
    from realtime_fraud_detection_tpu_torch.serving.app import ServingApp

    config = Config()
    config.mesh.enabled = True
    config.mesh.model = 2
    config.mesh.data = 4
    config.mesh.shard_branches = ["bert_text"]
    app = ServingApp(config, host="127.0.0.1", port=0, device="cpu")
    assert isinstance(app.pool, MeshExecutor) and app.pool.model_axis == 2
    assert app.pool.data_axis == 4 and app.pool.total_slots() == 2
    assert app.batcher.pipeline_depth == 2
    assert app.scorer.model_info()["mesh"] == {"data": 4, "model": 2, "seq": 1}
    status, text = asyncio.run(app._metrics_prometheus(None, None))
    assert status == 200
    assert "mesh_model_axis_size 2" in text
    assert 'mesh_branch_sharded{branch="bert_text"} 1' in text
    # the replicated pool's family stays untouched
    assert "device_pool_dispatched_total" in text
    assert "device_pool_dispatched_total{" not in text
    status, summary = asyncio.run(app._metrics(None, None))
    assert summary["mesh"]["kind"] == "mesh" and "device_pool" not in summary


def _snapshot():
    gen, s = make_scorer()
    ex = MeshExecutor(s, devices=CPU8, model_axis=2, replicas=2,
                      shard_branches=("bert_text",))
    for _ in range(3):
        s.score_batch(gen.generate_batch(4), now=NOW)
    return ex.mesh_snapshot()


def test_sync_mesh_equals_jax_exposition_and_deltas():
    snap = _snapshot()
    port, ref = MetricsCollector(), JaxMetricsCollector()
    for m in (port, ref):
        m.sync_mesh(snap)
        m.sync_mesh(snap)                  # a re-sync counts nothing twice
    assert sum(v for _, v in port.mesh_dispatched.by_label()) == 3.0
    assert port.mesh_branch_sharded.value(branch="xgboost_primary") == 0.0

    def mesh_lines(mc):
        return [ln for ln in mc.render_prometheus().splitlines()
                if ln.split(" ")[2 if ln.startswith("#") else 0].startswith("mesh_")]

    assert mesh_lines(port) == mesh_lines(ref) and len(mesh_lines(port)) > 20


def test_mesh_settings_validate_as_jax():
    MeshSettings().validate()
    Config().validate()
    for kwargs in (dict(replicas=0), dict(inflight_depth=0), dict(model=0), dict(seq=0),
                   dict(shard_branches=["isolation_forest"])):
        with pytest.raises(ValueError) as got:
            MeshSettings(**kwargs).validate()
        with pytest.raises(ValueError) as want:
            jconfig.MeshSettings(**kwargs).validate()
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------------- drill
def test_mesh_drill_fast_on_the_cpu(drill_command):
    out, err = drill_command.communicate(timeout=600)
    assert drill_command.returncode == 0, err[-3000:]
    lines = out.strip().splitlines()
    compact = json.loads(lines[-1])
    assert compact["passed"] is True and len(lines[-1].encode()) < 2048
    assert set(compact["checks"]) == DRILL_CHECKS and all(compact["checks"].values())
    for frac in compact["bert_per_chip_frac"].values():
        assert frac <= 0.60
    full = json.loads(lines[-2])
    assert full["placements"]["pool_x_mesh"]["per_replica_dispatched"] == [3, 3]
    assert full["hot_swap"]["batches_on_old_params"] == 4
    assert full["hot_swap"]["batches_on_new_params"] == 4
