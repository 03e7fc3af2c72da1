"""The system under test, built from a configuration, and what the harness
reads of it.

This is the one module of the benchmark that imports the program
(``realtime_fraud_detection_tpu_torch``). It builds the ``run-job`` path as
the deployment runs it: ``StreamJob`` over an ``InMemoryBroker`` with a
``TorchFraudScorer``, the job at the cell's settings and no planes, the
scorer at ``QuantSettings.full()`` and ``KernelSettings.full()`` with the
benchmark's own weights, and the blend set from the configuration file.

Instrumentation is by wrapping public methods on the instances, never by
editing the program:

- ``scorer.assemble``: numbers the batches and keeps the assembled host
  batch of the batches drawn for the check;
- ``scorer.dispatch`` / ``scorer.finalize``: the order in which batches
  were assembled and written back (``Recorder.events``), which the
  reference replays to rebuild the streaming state;
- ``broker.produce_batch_keyed`` on the predictions topic: the host time at
  which each decision was put on the topic;
- with tracing, ``job.dispatch_batch`` / ``job.complete_batch``: a
  ``record_function`` region and a host span each.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.models.bert import BertConfig
from realtime_fraud_detection_tpu_torch.models.isolation_forest import IsolationForest
from realtime_fraud_detection_tpu_torch.models.trees import TreeEnsemble
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    ScorerConfig,
    ScoringModels,
)
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
from realtime_fraud_detection_tpu_torch.utils.config import (
    Config,
    KernelSettings,
    QuantSettings,
)

TRANSACTIONS = T.TRANSACTIONS
PREDICTIONS = T.PREDICTIONS
WARMUP_TOPIC = "perfbench-warmup"


def program_config(cfg: Dict[str, Any], device: str) -> Config:
    """The port's ``Config`` with the blend, the thresholds and the planes
    taken from the configuration file (never from the environment)."""
    ens = cfg["ensemble"]
    config = Config()
    for name, mc in config.models.items():
        mc.weight = float(ens["weights"][name])
        mc.enabled = True
    e = config.ensemble
    e.strategy = ens["strategy"]
    e.confidence_threshold = float(ens["confidence_threshold"])
    e.decline_threshold = float(ens["decline_threshold"])
    e.review_threshold = float(ens["review_threshold"])
    e.monitor_threshold = float(ens["monitor_threshold"])
    config.state.backend = "memory"
    config.quant = QuantSettings.full()
    # the hand-written kernels exist only on the card; a CPU run (the
    # harness's own tests) takes the plain versions
    config.kernels = KernelSettings.full() if device == "cuda" else KernelSettings()
    return config


def program_models(w: Dict[str, Any]) -> ScoringModels:
    g, i = w["gbdt"], w["iforest"]
    return ScoringModels(
        trees=TreeEnsemble(g["feature"], g["threshold"], g["leaf"], g["base_score"]),
        iforest=IsolationForest(i["feature"], i["threshold"], i["path_length"],
                                i["c_psi"]),
        lstm=dict(w["lstm"]), gnn=dict(w["gnn"]), bert=w["bert"])


@dataclasses.dataclass
class Recorder:
    """What the wrappers saw. ``events`` is ("D", k, records) at each
    assembly and ("F", k) at each write-back, in order; ``kept`` maps a
    drawn batch number to its assembled host batch; ``produced`` holds
    (host time, predictions) per produce on the predictions topic."""

    events: List[tuple] = dataclasses.field(default_factory=list)
    kept: Dict[int, Any] = dataclasses.field(default_factory=dict)
    produced: List[tuple] = dataclasses.field(default_factory=list)
    keep: Callable[[int], bool] = lambda k: False
    batches: int = 0
    # traced runs: (name, start, end, rows) host spans of the job's steps
    spans: List[tuple] = dataclasses.field(default_factory=list)
    on_dispatch: Optional[Callable[[], None]] = None


class System:
    def __init__(self, cfg: Dict[str, Any], cell: Dict[str, Any],
                 weights: Dict[str, Any], users, merchants, device: str):
        ens, enc = cfg["ensemble"], cfg["text_encoder"]
        self.device = device
        self.bert_config = BertConfig(**enc)
        sc = ScorerConfig(seq_len=ens["seq_len"], feature_dim=ens["feature_dim"],
                          node_dim=ens["node_dim"], fanout=ens["fanout"],
                          graph_mode=ens["graph_mode"], text_len=ens["text_len"],
                          tokenizer=ens["tokenizer"])
        self.scorer = TorchFraudScorer(
            program_config(cfg, device), models=program_models(weights),
            scorer_config=sc, bert_config=self.bert_config, device=device)
        self.scorer.seed_profiles(users, merchants)
        self.broker = InMemoryBroker()
        job = cell["job"]
        self.job = StreamJob(self.broker, self.scorer, JobConfig(
            max_batch=int(job["max_batch"]), max_delay_ms=float(job["max_delay_ms"]),
            pipeline_depth=int(job["pipeline_depth"])))
        self.rec = Recorder()
        self._wrap()

    # ------------------------------------------------------------ wrappers
    def _wrap(self) -> None:
        scorer, rec = self.scorer, self.rec
        assemble, dispatch, finalize = (scorer.assemble, scorer.dispatch,
                                        scorer.finalize)

        def assemble_w(records, now=None):
            k = rec.batches
            rec.batches += 1
            batch = assemble(records, now)
            rec.events.append(("D", k, records))
            if rec.keep(k):
                rec.kept[k] = batch
            return batch

        def dispatch_w(records, now=None, **kw):
            pending = dispatch(records, now, **kw)
            pending.perfbench_k = rec.batches - 1
            return pending

        def finalize_w(pending, now=None, lock=None):
            out = finalize(pending, now=now, lock=lock)
            if pending.n:
                rec.events.append(("F", pending.perfbench_k))
            return out

        scorer.assemble, scorer.dispatch, scorer.finalize = (
            assemble_w, dispatch_w, finalize_w)
        produce = self.broker.produce_batch_keyed

        def produce_w(topic, items):
            if topic == PREDICTIONS:
                items = list(items)
                rec.produced.append((time.perf_counter(), items))
            return produce(topic, items)

        self.broker.produce_batch_keyed = produce_w

    def trace_job_steps(self) -> None:
        """Traced runs: name the job's two steps in the profiler's timeline
        and time them on the host."""
        job, rec = self.job, self.rec
        dispatch, complete = job.dispatch_batch, job.complete_batch

        def dispatch_w(records, now=None):
            if rec.on_dispatch is not None:
                rec.on_dispatch()
            t0 = time.perf_counter()
            with torch.profiler.record_function("job.dispatch_batch"):
                ctx = dispatch(records, now=now)
            rec.spans.append(("dispatch_batch", t0, time.perf_counter(),
                              len(records)))
            return ctx

        def complete_w(ctx, now=None):
            t0 = time.perf_counter()
            with torch.profiler.record_function("job.complete_batch"):
                out = complete(ctx, now=now)
            rec.spans.append(("complete_batch", t0, time.perf_counter(),
                              len(ctx.fresh)))
            return out

        job.dispatch_batch, job.complete_batch = dispatch_w, complete_w

    # ------------------------------------------------------------- driving
    def warm_up(self, records: List[Dict[str, Any]], sizes: List[int]) -> None:
        """Score ``records`` through the job's own two steps in batches of
        ``sizes``: every bucket shape the cell's traffic uses, and the
        kernels' build and first launch."""
        self.broker.produce_batch(WARMUP_TOPIC, records,
                                  key_fn=lambda r: str(r["user_id"]))
        consumer = self.broker.consumer([WARMUP_TOPIC], "perfbench-warmup")
        for n in sizes:
            batch = consumer.poll(n)
            self.job.process_batch(batch)
        if self.device == "cuda":
            torch.cuda.synchronize()

    def produce(self, records: List[Dict[str, Any]]) -> None:
        self.broker.produce_batch(TRANSACTIONS, records,
                                  key_fn=lambda r: str(r["user_id"]))

    def open_loop(self, records: List[Dict[str, Any]], due) -> Dict[str, Any]:
        """Put an open-loop window's records in the transactions topic, each
        readable from its due time on: the broker's ``read`` (what the job's
        consumer polls through) stops at the first record of a partition
        not yet due. Arrivals then reach the job on schedule, whatever the
        job is doing, with no producer thread in the job's process.
        Returns the gate's state; set ``"t0"`` when the window opens."""
        self.produce(records)
        parts: Dict[int, list] = {}
        for rec, d in zip(records, due):
            p = self.broker.select_partition(TRANSACTIONS, str(rec["user_id"]))
            parts.setdefault(p, []).append(float(d))
        arrays = {p: np.asarray(v) for p, v in parts.items()}
        state: Dict[str, Any] = {"t0": None}
        read = self.broker.read

        def gated(topic, partition, start, limit):
            recs = read(topic, partition, start, limit)
            if topic != TRANSACTIONS or not recs:
                return recs
            if state["t0"] is None:
                return []
            now = time.perf_counter() - state["t0"]
            due_now = int(np.searchsorted(arrays[partition], now, side="right"))
            return recs[:max(0, due_now - start)]

        self.broker.read = gated
        return state

    def backlog(self) -> int:
        return self.job.consumer.lag()

    def host_stages(self) -> Dict[str, Dict[str, float]]:
        return self.scorer.host_stats()["stages"]

    def kernel_snapshot(self) -> Dict[str, Any]:
        return self.scorer.kernel_snapshot()

    def close(self) -> None:
        self.job.close()
        self.scorer.close()
