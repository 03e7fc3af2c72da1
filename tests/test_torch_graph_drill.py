"""The port's graph drill against the JAX package's, on the same weights.

The JAX drill's ``_train_models`` trains the fast config's trees and typed
GNN once; the test bridges them into the port (``bridge.models_from_numpy``)
and runs both drills' ``run_graph_drill`` (without their replays) with
``_train_models`` replaced by that result, capturing each ``_run_fleet``
output and each fleet's workers. Held equal: the schedule, the committed
offsets, the assignment, the scored and shed counts, each partition's
typed-graph digest (only ids from the transactions enter it), the ``checks``
dict and the AUCs (rounded to 4 places by both drills). Counted, not
matched, as the JAX drill leaves them out of its digest: the remote fetches,
the nodes fetched and the degraded batches; each side is held to the
drill's own checks on them (fetches and nodes above 0, degraded batches
above 0 inside the netfault window and 0 before it). Within the end-to-end
bound of ``tests/torch_bounds.py`` (the 1e-4 floor: the BERT branch is out
of the drill's blend): every row's served, trees and GNN probability.
Decisions equal on every id farther than the bound from a rung.

The port's own command, ``graph-drill --fast --device cpu``, runs beside the
JAX drill in another process: the compact verdict is the last line and under
2 KB, the exit code agrees with ``passed``, and its checks are pinned as the
port's drill decides them from its own numpy-seeded GNN: every check passes,
``healthy_not_regressed`` included, which JAX's fails (ROADMAP C.1); the
replay is bit-identical and columnar == serial holds.
"""

import torch_threads  # first: torch held to one CPU thread
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import torch_bounds
from chip_smoke import GRAPH_CPU_CHECKS
from realtime_fraud_detection_tpu.cluster import fleet as jfleet_mod
from realtime_fraud_detection_tpu.graph import drill as jdrill
from realtime_fraud_detection_tpu.stream import topics as JT
from realtime_fraud_detection_tpu.stream import transport as jtransport
from realtime_fraud_detection_tpu_torch.__main__ import main as port_main
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.cluster import fleet as pfleet_mod
from realtime_fraud_detection_tpu_torch.graph import drill as pdrill

ROOT = Path(__file__).resolve().parent.parent

# the port's own verdict of `graph-drill --fast --device cpu`: every check
# passes (its GNN starts from numpy-seeded weights, JAX's from a PRNG key);
# chip_smoke.py's phase 23 holds the card's verdict to the same dict
PORT_CHECKS = GRAPH_CPU_CHECKS


def _capture(monkeypatch, drill, fleet_mod, models):
    """Replace ``drill._train_models`` by ``models``; record every
    ``_run_fleet`` result and every ``WorkerFleet`` it builds."""
    runs, fleets = [], []
    orig_run = drill._run_fleet

    class Recorded(fleet_mod.WorkerFleet):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            fleets.append(self)

    def run_fleet(*a, **kw):
        out = orig_run(*a, **kw)
        runs.append(out)
        return out

    monkeypatch.setattr(drill, "_train_models", lambda cfg: models)
    monkeypatch.setattr(drill, "_run_fleet", run_fleet)
    monkeypatch.setattr(fleet_mod, "WorkerFleet", Recorded)
    return runs, fleets


def _graph_digests(fleet):
    return {p: w.store.state(p).graph.digest()
            for w in fleet.workers.values() for p in w.store.owned()}


@pytest.fixture(scope="module")
def drills():
    """Both drills on the same trained weights, and the port's command."""
    command = subprocess.Popen(
        [sys.executable, "-m", "realtime_fraud_detection_tpu_torch", "graph-drill",
         "--fast", "--device", "cpu"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=torch_threads.spawn_env())
    mp = pytest.MonkeyPatch()
    try:
        jcfg = dataclasses.replace(jdrill.GraphDrillConfig.fast(), replay_check=False)
        pcfg = dataclasses.replace(pdrill.GraphDrillConfig.fast(), replay_check=False,
                                   device="cpu")
        jmodels, jbert = jdrill._train_models(jcfg)
        pmodels = models_from_numpy(jax.tree_util.tree_map(np.asarray, jmodels))
        pbert = pdrill._drill_bert_config()
        assert dataclasses.asdict(pbert) == dataclasses.asdict(jbert)

        # JAX's ledger carries no decision: read it from the broker
        brokers = []

        class Broker(jtransport.InMemoryBroker):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                brokers.append(self)

        mp.setattr(jtransport, "InMemoryBroker", Broker)
        jruns, jfleets = _capture(mp, jdrill, jfleet_mod, (jmodels, jbert))
        want = jdrill.run_graph_drill(jcfg)
        pruns, pfleets = _capture(mp, pdrill, pfleet_mod, (pmodels, pbert))
        got = pdrill.run_graph_drill(pcfg)
        jdecisions = {}
        for p in range(brokers[0].partitions(JT.PREDICTIONS)):
            for r in brokers[0].read(JT.PREDICTIONS, p, 0, 1 << 20):
                ex = r.value.get("explanation") or {}
                if not (ex.get("shed") or ex.get("replayed_from_cache") or ex.get("error")):
                    jdecisions.setdefault(r.value["transaction_id"], r.value["decision"])
        stdout, stderr = command.communicate(timeout=900)
    finally:
        mp.undo()
        command.kill()
        command.wait()
    assert len(jruns) == len(pruns) == 1 and len(jfleets) == len(pfleets) == 1
    return dict(want=want, got=got, jout=jruns[0], pout=pruns[0], jfleet=jfleets[0],
                pfleet=pfleets[0], jdecisions=jdecisions,
                command=(command.returncode, stdout, stderr))


def test_config_schedule_and_compact_equal_jax():
    fast, jfast = pdrill.GraphDrillConfig.fast(), jdrill.GraphDrillConfig.fast()
    got = dataclasses.asdict(fast)
    assert got.pop("device") == "cuda"
    assert got == dataclasses.asdict(jfast)
    assert fast.phase_edges() == jfast.phase_edges() and fast.cost_s(7) == jfast.cost_s(7)
    sched, truth, ring, profiles = pdrill._build_schedule(fast)
    jsched, jtruth, jring, jprofiles = jdrill._build_schedule(jfast)
    assert sched == jsched and truth == jtruth and ring == jring
    assert json.dumps(profiles, sort_keys=True) == json.dumps(jprofiles, sort_keys=True)
    for summary in ({"metric": "graph_drill", "passed": True,
                     "checks": dict(PORT_CHECKS), "auc": {"ring_phase_lift": 0.2,
                                                           "ring": {"graph_on": 0.7}},
                     "digest": "b" * 64, "ring_workers": ["w0", "w1"]},
                    {"passed": False,
                     "checks": {f"check_named_at_length_{i}" * 5: False for i in range(60)}}):
        compact = pdrill.compact_graph_summary(summary)
        assert compact == jdrill.compact_graph_summary(summary)
        assert len(json.dumps(compact, separators=(",", ":")).encode()) < 2048


def test_fleet_equals_jax_on_the_same_weights(drills):
    jout, pout = drills["jout"], drills["pout"]
    assert pout["committed"] == jout["committed"] == pout["tx_ends"] == jout["tx_ends"]
    assert pout["assignment"] == jout["assignment"]
    assert pout["counters"] == jout["counters"]
    assert pout["counters"]["errors"] == 0 and pout["counters"]["scored"] == 2304
    jkinds = sorted((t, k) for t, *_, k in jout["preds"])
    assert sorted((t, k) for t, *_, k in pout["preds"]) == jkinds
    graphs = _graph_digests(drills["pfleet"])
    assert graphs == _graph_digests(drills["jfleet"]) and len(graphs) == 12
    assert pout["makespan_s"] == jout["makespan_s"]


def test_fetch_and_degrade_hold_the_drill_checks_on_both_sides(drills):
    """Counted, not matched (the refusal count in the window can vary with
    batch timing in both packages): each side fetches remotely and
    degrades inside the window only."""
    for name, out in (("port", drills["pout"]), ("jax", drills["jout"])):
        fetches = sum(s["remote_fetch_total"] for s in out["fetch"].values())
        nodes = sum(s["fetched_nodes_total"] for s in out["fetch"].values())
        print(f"{name}: {fetches} remote fetches, {nodes} nodes, "
              f"{out['degraded_in_window']} degraded batches in the window, "
              f"{out['degraded_pre_window']} before it")
        assert fetches > 0 and nodes > 0
        assert out["degraded_in_window"] > 0 and out["degraded_pre_window"] == 0
        assert sum(lk["partitioned_sends_total"] for lk in out["links"].values()) > 0


def test_rows_within_the_bound_and_decisions_away_from_a_cut(drills):
    bound = torch_bounds.FLOOR
    want = {t: (s, tr, g) for t, s, tr, g, k in drills["jout"]["preds"] if k == "scored"}
    got = {t: (s, tr, g) for t, s, tr, g, k in drills["pout"]["preds"] if k == "scored"}
    assert set(got) == set(want)
    gaps = np.abs(np.asarray([got[t] for t in want]) - np.asarray([want[t] for t in want]))
    assert gaps.max() <= bound, gaps.max(axis=0)
    ids = sorted(want)
    near = torch_bounds.near_rung([want[t][0] for t in ids], bound)
    decisions, jdecisions = drills["pout"]["decisions"], drills["jdecisions"]
    assert set(decisions) == set(jdecisions) == set(ids)
    flips = [t for t, n in zip(ids, near) if not n and decisions[t] != jdecisions[t]]
    assert not flips
    assert int(near.sum()) <= 2, [(t, want[t]) for t, n in zip(ids, near) if n]


def test_analysis_equals_jax(drills):
    got, want = drills["got"], drills["want"]
    assert got["checks"] == want["checks"]
    assert got["auc"] == want["auc"]
    assert want["checks"]["healthy_not_regressed"] is False      # ROADMAP C.1
    for key in ("produced", "scored", "lost", "double_scored", "ring_workers",
                "ring_members", "n_workers", "n_partitions", "num_users",
                "columnar_serial"):
        assert got[key] == want[key], key
    assert got["columnar_serial"]["leaves_equal"] and got["replay_identical"] is None
    print(f"same weights: healthy AUC graph on {got['auc']['healthy']['graph_on']} "
          f"against trees {got['auc']['healthy']['incumbent_trees']}; ring lift "
          f"{got['auc']['ring_phase_lift']}")


def test_graph_drill_command_on_the_cpu(drills):
    rc, stdout, stderr = drills["command"]
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    assert lines, stderr[-3000:]
    compact = json.loads(lines[-1])
    assert len(lines[-1].encode()) < 2048
    full = json.loads(lines[-2])
    assert rc == (0 if full["passed"] else 1), stderr[-3000:]
    assert compact["passed"] == full["passed"] and compact["checks"] == full["checks"]
    assert full["checks"] == PORT_CHECKS
    assert full["replay_identical"] is True and full["lost"] == 0
    assert full["produced"] == full["scored"] == 2304
    # the trees are the same function of the same stream in both packages
    assert full["auc"]["healthy"]["incumbent_trees"] == \
        drills["want"]["auc"]["healthy"]["incumbent_trees"]
    print("port graph-drill --fast --device cpu: healthy AUC graph on "
          f"{full['auc']['healthy']['graph_on']} against trees "
          f"{full['auc']['healthy']['incumbent_trees']}; ring lift "
          f"{full['auc']['ring_phase_lift']}; {full['remote_fetches']} remote fetches "
          f"of {full['remote_nodes']} nodes; degraded {full['degraded_in_window']} in "
          f"the window, {full['degraded_pre_window']} before")


def test_graph_drill_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert port_main(["graph-drill", "--fast"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
