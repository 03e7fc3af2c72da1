"""The port's chaos drill and chaos plane settings against the JAX package.

- ``ChaosSettings``: its validation and its overlay onto the drill's config
  equal JAX's; a config file's ``chaos`` block loads alike.
- ``sync_chaos`` renders the JAX series.
- The drill's fast config, capacity model and whole arrival timeline
  (times, transactions, phase marks, the fraud ring's truth ledger) equal
  JAX's on the same seed.
- ``chaos-drill --fast --device cpu`` as a command: every check passes, the
  second run replays bit-identically, and its verdict equals that of the
  JAX package's ``run_chaos_drill`` on the fast config, run live in the test
  process on the virtual CPU devices (without its replay, which the port's
  run still checks). Four differences are expected and named: the digest
  hashes the scores to six decimals, where the two float paths part in the
  last places; the pool's device names and wall-clock queue waits; and one
  recorded divergence: the port's ``StreamJob`` closes a terminal trace for
  a duplicate it skips (``tests/test_torch_tracing.py``), JAX's opens none,
  so the port's flight recorder holds the duplicates the broker outage
  replays under ``broker_outage``.
- Without a card the command refuses with exit 2.
"""

import torch_threads  # first: torch held to one CPU thread
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest

from realtime_fraud_detection_tpu.chaos import drill as jdrill
from realtime_fraud_detection_tpu.chaos.faults import ChaosPlan as JaxChaosPlan
from realtime_fraud_detection_tpu.chaos.faults import FaultWindow as JaxFaultWindow
from realtime_fraud_detection_tpu.obs.metrics import MetricsCollector as JaxMetricsCollector
from realtime_fraud_detection_tpu.sim.simulator import (
    TransactionGenerator as JaxTransactionGenerator,
)
from realtime_fraud_detection_tpu.utils.config import ChaosSettings as JaxChaosSettings
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu_torch.__main__ import main as port_main
from realtime_fraud_detection_tpu_torch.chaos import drill as pdrill
from realtime_fraud_detection_tpu_torch.chaos.faults import ChaosPlan, FaultWindow
from realtime_fraud_detection_tpu_torch.obs.metrics import MetricsCollector
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.utils.config import ChaosSettings, Config

ROOT = Path(__file__).resolve().parents[1]

# ----------------------------------------------------------------- settings
@pytest.mark.parametrize("bad", [
    {"broker_outage_s": 0.0}, {"label_stall_s": -1.0}, {"flash_crowd_mult": 0.5},
    {"flash_burst_mult": 0.9}, {"ring_rate": 0.0}, {"ring_rate": 1.5},
    {"ring_devices": 0}, {"replica_faults": 0}, {"slow_device_ms": -1.0},
])
def test_chaos_settings_validate_like_jax(bad):
    with pytest.raises(ValueError) as got:
        ChaosSettings(**bad).validate()
    with pytest.raises(ValueError) as want:
        JaxChaosSettings(**bad).validate()
    assert str(got.value) == str(want.value)


def test_config_chaos_block_loads_like_jax(tmp_path, caplog):
    assert dataclasses.asdict(Config().chaos) == dataclasses.asdict(JaxConfig().chaos)
    block = {"chaos": {"seed": 99, "ring_rate": 0.2, "broker_outage_s": 2.5}}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(block))
    with caplog.at_level("WARNING"):
        got = Config.from_file(str(path)).chaos
    assert not any("chaos" in rec.getMessage() for rec in caplog.records)
    assert dataclasses.asdict(got) == dataclasses.asdict(JaxConfig.from_file(str(path)).chaos)
    assert (got.seed, got.ring_rate) == (99, 0.2)


def _no_device(cfg):
    out = dataclasses.asdict(cfg)
    out.pop("device", None)
    return out


def test_settings_overlay_and_fast_config_equal_jax():
    kw = dict(seed=99, broker_outage_s=2.5, label_stall_s=1.0, flash_crowd_mult=3.0,
              flash_burst_mult=1.2, ring_rate=0.2, ring_members=10, ring_merchants=2,
              ring_devices=3, ring_ips=5, replica_faults=2, slow_device_ms=15.0)
    for base, jbase in ((pdrill.ChaosDrillConfig.fast(), jdrill.ChaosDrillConfig.fast()),
                        (pdrill.ChaosDrillConfig(), jdrill.ChaosDrillConfig())):
        assert _no_device(base) == _no_device(jbase)
        assert base.capacity_tps() == jbase.capacity_tps()
        assert [base.cost_s(64, lv) for lv in range(5)] == \
            [jbase.cost_s(64, lv) for lv in range(5)]
        got = pdrill.apply_chaos_settings(base, ChaosSettings(**kw))
        want = jdrill.apply_chaos_settings(jbase, JaxChaosSettings(**kw))
        assert _no_device(got) == _no_device(want)
        assert got.device == "cuda" and got.n_devices == base.n_devices


def test_sync_chaos_renders_the_jax_series():
    got, want = MetricsCollector(), JaxMetricsCollector()
    plans = (ChaosPlan([FaultWindow("broker_outage", "broker", 1.0, 2.0)]),
             JaxChaosPlan([JaxFaultWindow("broker_outage", "broker", 1.0, 2.0)]))

    def lines(m):
        return [ln for ln in m.render_prometheus().splitlines() if "chaos_" in ln]

    for t, recovered in ((1.5, None), (1.5, None), (2.5, 2.75)):
        for plan, mc in zip(plans, (got, want)):
            plan.poll(t)
            if recovered is not None:
                plan.note_recovered("broker_outage", recovered)
            mc.sync_chaos(plan.snapshot(t))
        assert lines(got) == lines(want)
    assert got.chaos_fault_windows.value(fault="broker_outage") == 1.0
    assert got.chaos_fault_active.value(fault="broker_outage") == 0.0
    assert got.chaos_recovery_seconds.value(fault="broker_outage") == 0.75


def test_compact_chaos_summary_equals_jax():
    for summary in (
            {"metric": "chaos_drill", "passed": True,
             "checks": {f"check_{i}": True for i in range(20)},
             "phase_auc": {"healthy": 0.95, "recovery": 0.97}, "digest": "a" * 64},
            {"metric": "chaos_drill", "passed": False,
             "checks": {f"very_long_check_name_{i}" * 4: False for i in range(64)}}):
        got = pdrill.compact_chaos_summary(summary)
        assert got == jdrill.compact_chaos_summary(summary)
        assert len(json.dumps(got, separators=(",", ":")).encode()) < 2048


# ----------------------------------------------------------------- timeline
def test_arrival_timeline_equals_jax():
    """The whole seeded timeline: the same transactions at the same
    virtual instants, the same phase marks, the ring injected at the same
    point of the generator's sequence, the same truth ledger."""
    cfg, jcfg = pdrill.ChaosDrillConfig.fast(), jdrill.ChaosDrillConfig.fast()
    out = {}
    for name, mod, c, gen_cls in (("port", pdrill, cfg, TransactionGenerator),
                                  ("jax", jdrill, jcfg, JaxTransactionGenerator)):
        gen = gen_cls(num_users=c.num_users, num_merchants=c.num_merchants,
                      seed=c.seed, tps=c.tps)
        for start in range(0, c.n_train, c.batch):     # the incumbent's segment
            gen.generate_batch(min(c.batch, c.n_train - start))
        sched, marks, ring, truth = mod._build_schedule(c, gen, 3.5)
        out[name] = (sched, marks, ring.stats(), truth)
    assert out["port"] == out["jax"]
    sched, marks, _, truth = out["port"]
    assert len(sched) == len(truth) == 6345
    assert list(marks) == ["healthy", "flash", "outage", "pool", "ring", "recovery", "end"]


# ------------------------------------------------------------------- drill
# summary keys whose values are not the same function of the inputs in the
# two packages (see the module docstring); every other key is compared
NOT_COMPARED = {"digest", "replay_identical", "checks", "pool", "fault_window_traces"}


def test_chaos_drill_fast_on_the_cpu_equals_the_jax_verdict():
    """``chaos-drill --fast --device cpu``: every check passes, the second
    run is bit-identical, and the verdict equals a live run of JAX's drill
    on the same fast config. The port's command runs in its own process
    while the JAX drill runs in this one."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "realtime_fraud_detection_tpu_torch", "chaos-drill",
         "--fast", "--device", "cpu"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=torch_threads.spawn_env())
    try:
        want = jdrill.run_chaos_drill(
            dataclasses.replace(jdrill.ChaosDrillConfig.fast(), replay_check=False))
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, stdout[-2000:] + stderr[-2000:]
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    compact = json.loads(lines[-1])
    assert len(lines[-1].encode()) < 2048 and compact["passed"] is True
    full = json.loads(lines[-2])
    assert "ledger" not in full
    assert want["passed"] is True and want["replay_identical"] is None
    checks = dict(full["checks"])
    assert checks.pop("replay_bit_identical") is True and full["replay_identical"] is True
    assert checks == want["checks"] and all(checks.values())
    # JSON round trip: the port's verdict was printed, JAX's is in memory
    want = json.loads(json.dumps(want))
    assert set(full) - {"first_promotion_ts"} == set(want)
    assert {k: full[k] for k in want if k not in NOT_COMPARED} == \
        {k: want[k] for k in want if k not in NOT_COMPARED}

    def pool(p, drop=("device", "queue_wait_ms")):
        return {**{k: v for k, v in p.items() if k != "devices"},
                "devices": [{k: v for k, v in d.items() if k not in drop}
                            for d in p["devices"]]}

    assert pool(full["pool"]) == pool(want["pool"])
    assert full["pool"]["n_devices"] == 2 and full["pool"]["retries"] == 1
    traces = dict(full["fault_window_traces"])
    assert traces.pop("broker_outage") > 0        # the replayed duplicates
    assert "broker_outage" not in want["fault_window_traces"]
    assert traces == want["fault_window_traces"]
    assert full["scored"] > 0 and full["shed"] > 0 and full["ring_promotions"] == 1


def test_chaos_drill_refuses_without_a_card(capsys):
    assert port_main(["chaos-drill", "--fast"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
