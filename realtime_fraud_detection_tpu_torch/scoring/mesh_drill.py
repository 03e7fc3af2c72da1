"""Deterministic mesh-sharding drill: the ``mesh-drill`` acceptance gate.

Port of the JAX package's ``scoring/mesh_drill.py``. It runs the real
mesh-sharded scoring path (``TorchFraudScorer`` + ``MeshExecutor``) on
deterministic streams and holds the executor's contract in one verdict:

1. **bit-equality per placement**: every branch-placement combo (pure data
   sharding, BERT-only model sharding, all three neural branches sharded,
   pool x mesh with two mesh replicas, and the int8-quantized forms of the
   sharded combos) scores bit-identical to a fresh single-position
   reference driven with the same in-flight window, with results in submit
   order;
2. **ladder rungs**: a stream stepping down through every QoS rung
   mid-flight (rules-only included) stays bit-identical, so the
   per-dispatch mask snapshot fans out over the mesh;
3. **hot swap**: a mid-stream ``set_models`` re-places replica by replica:
   every batch matches the old-params or the new-params reference wholly,
   and the swapped params are still sharded;
4. **memory**: the BERT bytes each position stores on the 2-way model axis
   are <= ``max_bert_per_chip_frac`` (60%) of the replicated equivalent,
   read from the stored tensors, f32 and int8;
5. **replay**: a second full pass replays bit-identically (a sha256 digest
   over every scored row of every phase).

JAX's two donation checks (``donated_scores_identical``,
``donation_reaches_compiler``) have no counterpart: donation is an XLA
buffer-aliasing switch. The positions are ``n_devices`` entries over the
visible cards, cycled (``device="cuda"``; several on one card, each with
its own stream), or all on the CPU (``device="cpu"``); the JAX command
re-execs onto virtual CPU devices instead. The reference scores each batch
at its bucket and the mesh pads to whole 64-row blocks a data shard
(``scoring/mesh_executor.py ROW_BLOCK``), so bit-equality is held where
both sides score whole blocks: a batch of 256 puts 64 rows on each of the 4
data shards of 8 positions at ``model_axis=2`` against the 256-row
reference, and a batch whose bucket is not a whole number of blocks is
refused (JAX's drill runs 32 rows). ``kernels`` runs every scorer
(reference and meshed) with ``KernelSettings.full()`` or ``.mega()``; the
summary records each combo's hand-written launches a batch, meshed and
single. The full summary, then a compact (< 2 KB) verdict as the last
stdout line (``mesh-drill``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["MeshDrillConfig", "compact_mesh_summary", "run_mesh_drill"]


@dataclasses.dataclass
class MeshDrillConfig:
    n_devices: int = 8
    model_axis: int = 2
    inflight_depth: int = 2
    batch: int = 256             # a whole number of ROW_BLOCK rows a shard
    n_batches: int = 12          # per placement combo
    swap_batches: int = 12       # hot-swap phase (swap at the midpoint)
    rung_batches: int = 2        # batches scored AT each ladder rung
    seed: int = 7
    # per-position BERT bytes against the replicated equivalent at
    # model_axis=2: the dense kernels and embeddings halve, layer norms and
    # the head stay whole, hence 0.6 rather than 0.5
    max_bert_per_chip_frac: float = 0.60
    replay_check: bool = True
    device: str = "cuda"
    kernels: str = "off"         # "off", "full" or "mega"

    @classmethod
    def fast(cls) -> "MeshDrillConfig":
        """The test sizes: every phase runs, on fewer batches."""
        return cls(n_batches=6, swap_batches=8)


ALL_NEURAL = ("bert_text", "graph_neural", "lstm_sequential")


def _config(cfg: MeshDrillConfig, quant: bool):
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    kernels = {"off": KernelSettings(), "full": KernelSettings.full(),
               "mega": KernelSettings.mega()}[cfg.kernels]
    return Config(quant=QuantSettings.full() if quant else QuantSettings(),
                  kernels=kernels)


def _make_scorer(cfg: MeshDrillConfig, model_seed: int = 0, quant: bool = False):
    """A fresh generator and single-device scorer; an attached MeshExecutor
    takes over its batch seam."""
    from realtime_fraud_detection_tpu_torch.scoring.mesh_executor import mesh_positions
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import ScorerConfig
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator

    dev = mesh_positions(1, cfg.device)[0]
    gen = TransactionGenerator(num_users=500, num_merchants=100, seed=cfg.seed)
    scorer = TorchFraudScorer(config=_config(cfg, quant), scorer_config=ScorerConfig(),
                              seed=model_seed, device=dev)
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    return gen, scorer


def _run_stream(scorer, batches: List[list], window: int, now: float = 1000.0,
                swap_at: Optional[int] = None, swap_models=None,
                rung_schedule: Optional[Dict[int, int]] = None,
                ) -> Tuple[List[List[Dict[str, Any]]], Dict[str, int]]:
    """Dispatch / finalize with at most ``window`` in flight: the same
    routine drives the meshed scorer and the reference. ``rung_schedule``
    maps a batch index to the ladder level set right before its dispatch.
    Returns the results and the hand-written kernel launches by kernel."""
    from realtime_fraud_detection_tpu_torch.ops import launch_counts
    from realtime_fraud_detection_tpu_torch.qos.ladder import LADDER_LEVELS
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES

    results: List[List[Dict[str, Any]]] = []
    before = launch_counts()
    inflight: deque = deque()

    def complete():
        results.append(scorer.finalize(inflight.popleft(), now=now))

    for i, recs in enumerate(batches):
        if swap_at is not None and i == swap_at:
            # rtfd-lint: allow[lock-order] the drill IS the only dispatcher; swap purity is what it pins
            scorer.set_models(swap_models)
        if rung_schedule is not None and i in rung_schedule:
            level = rung_schedule[i]
            rung = LADDER_LEVELS[level]
            # rtfd-lint: allow[d2h] host bool list -> validity mask, never a device array
            mask = np.asarray([n not in rung.dropped_branches for n in MODEL_NAMES])
            # rtfd-lint: allow[lock-order] the drill IS the only dispatcher; rung fan-out is what it pins
            scorer.set_degradation(mask, rules_only=rung.rules_only, level=level)
        inflight.append(scorer.dispatch(recs, now=now))
        while len(inflight) >= window:
            complete()
    while inflight:
        complete()
    after = launch_counts()
    return results, {k: after[k] - before[k] for k in after}


def _rows(results: List[List[Dict[str, Any]]]) -> List[tuple]:
    return [(r["transaction_id"], r["fraud_probability"], r["confidence"],
             r["decision"]) for batch in results for r in batch]


def _bert_frac(executor) -> float:
    pb = executor.param_bytes()["bert_text"]
    return pb["per_chip"] / max(pb["replicated"], 1)


def _one_pass(cfg: MeshDrillConfig) -> Tuple[Dict[str, Any], str]:
    """One full drill pass; returns (summary, digest over every row)."""
    from realtime_fraud_detection_tpu_torch.qos.ladder import LADDER_LEVELS
    from realtime_fraud_detection_tpu_torch.scoring.mesh_executor import (
        MeshExecutor,
        mesh_positions,
    )
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import init_scoring_models

    devices = mesh_positions(cfg.n_devices, cfg.device)
    window = cfg.inflight_depth
    summary: Dict[str, Any] = {
        "drill": "mesh",
        "n_devices": cfg.n_devices,
        "model_axis": cfg.model_axis,
        "inflight_depth": cfg.inflight_depth,
        "batch": cfg.batch,
        "platform": cfg.device,
        "devices": devices,
        "kernels": cfg.kernels,
        "checks": {},
        "placements": {},
    }
    checks = summary["checks"]
    digest = hashlib.sha256()

    def fold(rows: List[tuple]) -> None:
        digest.update(json.dumps(rows, sort_keys=True).encode())

    # ------------------------------------------- phase 1: placement combos
    combos: List[Tuple[str, bool, Dict[str, Any]]] = [
        ("data_only", False, dict(replicas=1, shard_branches=())),
        ("bert_sharded", False, dict(replicas=1, shard_branches=("bert_text",))),
        ("all_neural_sharded", False, dict(replicas=1, shard_branches=ALL_NEURAL)),
        ("pool_x_mesh", False, dict(replicas=2, shard_branches=("bert_text",))),
        ("quant_bert_sharded", True, dict(replicas=1, shard_branches=("bert_text",))),
        ("quant_all_neural_sharded", True, dict(replicas=1, shard_branches=ALL_NEURAL)),
    ]
    ref_rows: Dict[bool, List[tuple]] = {}
    ref_launches: Dict[bool, Dict[str, int]] = {}
    for quant in (False, True):
        gen, ref = _make_scorer(cfg, quant=quant)
        batches = [gen.generate_batch(cfg.batch) for _ in range(cfg.n_batches)]
        res, ref_launches[quant] = _run_stream(ref, batches, window)
        ref_rows[quant] = _rows(res)
        fold(ref_rows[quant])

    for name, quant, kwargs in combos:
        gen, scorer = _make_scorer(cfg, quant=quant)
        executor = MeshExecutor(scorer, devices=devices, model_axis=cfg.model_axis,
                                inflight_depth=cfg.inflight_depth, **kwargs)
        batches = [gen.generate_batch(cfg.batch) for _ in range(cfg.n_batches)]
        res, launches = _run_stream(scorer, batches, window)
        got = _rows(res)
        fold(got)
        checks[f"bit_identical_{name}"] = got == ref_rows[quant]
        submitted = [str(r.get("transaction_id", "")) for b in batches for r in b]
        checks[f"fifo_{name}"] = [t for t, *_ in got] == submitted
        st = executor.stats()
        entry: Dict[str, Any] = {
            "quantized": quant,
            "shard_branches": list(kwargs["shard_branches"]),
            "replicas": kwargs["replicas"],
            "bert_per_chip_frac": round(_bert_frac(executor), 4),
            "launches_per_batch": {
                "mesh": {k: v / cfg.n_batches for k, v in launches.items()},
                "single": {k: v / cfg.n_batches for k, v in ref_launches[quant].items()}},
            "mega_shards": {"served": sum(r["mega_shards_served"] for r in st["replicas"]),
                            "declined": sum(r["mega_shards_declined"]
                                            for r in st["replicas"])},
        }
        if not got == ref_rows[quant]:
            diff = [(a, b) for a, b in zip(got, ref_rows[quant]) if a != b]
            entry["rows_differing"] = len(diff)
            entry["first_difference"] = [list(diff[0][0]), list(diff[0][1])] if diff else None
        if kwargs["shard_branches"]:
            checks[f"bert_bytes_{name}"] = (
                entry["bert_per_chip_frac"] <= cfg.max_bert_per_chip_frac)
        if kwargs["replicas"] > 1:
            entry["per_replica_dispatched"] = [r["dispatched"] for r in st["replicas"]]
            checks["all_mesh_replicas_utilized"] = all(
                r["dispatched"] > 0 for r in st["replicas"])
            checks["round_robin_assignment"] = (
                list(executor.assignment_log)
                == [i % kwargs["replicas"] for i in range(cfg.n_batches)])
        summary["placements"][name] = entry

    # --------------------------------------------- phase 2: ladder rungs
    n_rungs = len(LADDER_LEVELS)
    rung_schedule = {i * cfg.rung_batches: i for i in range(n_rungs)}
    n_rung_batches = n_rungs * cfg.rung_batches
    gen_r, rung_ref = _make_scorer(cfg)
    ref_r = _rows(_run_stream(
        rung_ref, [gen_r.generate_batch(cfg.batch) for _ in range(n_rung_batches)],
        window, rung_schedule=rung_schedule)[0])
    gen_m, rung_scorer = _make_scorer(cfg)
    MeshExecutor(rung_scorer, devices=devices, model_axis=cfg.model_axis,
                 inflight_depth=cfg.inflight_depth, shard_branches=ALL_NEURAL)
    got_r = _rows(_run_stream(
        rung_scorer, [gen_m.generate_batch(cfg.batch) for _ in range(n_rung_batches)],
        window, rung_schedule=rung_schedule)[0])
    fold(got_r)
    checks["bit_identical_all_ladder_rungs"] = got_r == ref_r
    summary["ladder"] = {"rungs": n_rungs, "batches_per_rung": cfg.rung_batches}

    # ------------------------------------------------ phase 3: hot swap
    new_models = init_scoring_models(
        101, bert_config=rung_scorer.bert_config,
        feature_dim=rung_scorer.sc.feature_dim, node_dim=rung_scorer.sc.node_dim)
    swap_at = cfg.swap_batches // 2
    gen_old, serial_old = _make_scorer(cfg)
    swap_old_ref = _run_stream(serial_old, [gen_old.generate_batch(cfg.batch)
                                            for _ in range(cfg.swap_batches)], window)[0]
    gen_new, serial_new = _make_scorer(cfg)
    # rtfd-lint: allow[lock-order] serial oracle scorer, single-threaded by construction
    serial_new.set_models(new_models)
    swap_new_ref = _run_stream(serial_new, [gen_new.generate_batch(cfg.batch)
                                            for _ in range(cfg.swap_batches)], window)[0]
    gen_sw, swap_scorer = _make_scorer(cfg)
    swap_exec = MeshExecutor(swap_scorer, devices=devices, model_axis=cfg.model_axis,
                             inflight_depth=cfg.inflight_depth,
                             shard_branches=("bert_text",))
    swap_got = _run_stream(swap_scorer, [gen_sw.generate_batch(cfg.batch)
                                         for _ in range(cfg.swap_batches)],
                           window, swap_at=swap_at, swap_models=new_models)[0]
    fold(_rows(swap_got))
    mixed = matches_old = matches_new = 0
    for i, batch_res in enumerate(swap_got):
        rows = _rows([batch_res])
        if rows == _rows([swap_old_ref[i]]):
            matches_old += 1
        elif rows == _rows([swap_new_ref[i]]):
            matches_new += 1
        else:
            mixed += 1
    checks["no_mixed_params_batch"] = mixed == 0 and matches_old > 0 and matches_new > 0
    checks["swap_preserves_sharding"] = _bert_frac(swap_exec) <= cfg.max_bert_per_chip_frac
    summary["hot_swap"] = {
        "swap_at_batch": swap_at,
        "batches_on_old_params": matches_old,
        "batches_on_new_params": matches_new,
        "mixed_batches": mixed,
        "post_swap_bert_per_chip_frac": round(_bert_frac(swap_exec), 4),
    }

    checks = {k: bool(v) for k, v in checks.items()}
    summary["checks"] = checks
    summary["passed"] = all(checks.values())
    return summary, digest.hexdigest()


def run_mesh_drill(cfg: Optional[MeshDrillConfig] = None) -> Dict[str, Any]:
    from realtime_fraud_detection_tpu_torch.core.batching import bucket_for
    from realtime_fraud_detection_tpu_torch.scoring.mesh_executor import ROW_BLOCK

    cfg = cfg or MeshDrillConfig()
    if bucket_for(cfg.batch) % ROW_BLOCK:
        raise ValueError(
            f"mesh drill: the single-position reference scores a batch of "
            f"{cfg.batch} as {bucket_for(cfg.batch)} rows, not a whole number of "
            f"{ROW_BLOCK}-row blocks as the mesh's shards are; use a batch over 32")
    summary, digest = _one_pass(cfg)
    summary["digest"] = digest
    if cfg.replay_check:
        # a second full pass from fresh scorers and streams must replay
        # every scored row bit-identically
        _, digest2 = _one_pass(cfg)
        summary["checks"]["replay_bit_identical"] = digest == digest2
        summary["passed"] = all(bool(v) for v in summary["checks"].values())
    return summary


def compact_mesh_summary(summary: Dict[str, Any]) -> Dict[str, Any]:
    """< 2 KB single-line verdict."""
    placements = summary.get("placements") or {}
    return {
        "drill": "mesh",
        "passed": summary.get("passed", False),
        "checks": {k: bool(v) for k, v in (summary.get("checks") or {}).items()},
        "n_devices": summary.get("n_devices"),
        "model_axis": summary.get("model_axis"),
        "bert_per_chip_frac": {
            name: p.get("bert_per_chip_frac")
            for name, p in placements.items() if p.get("shard_branches")},
        "digest": (summary.get("digest") or "")[:16],
    }
