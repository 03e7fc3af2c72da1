"""The streaming scorer: host assembly, the device program, write-back.

Port of the JAX package's ``scoring/scorer.py FraudScorer``:

- host half: ``assemble`` joins the profile, velocity and history state of
  a microbatch of transaction dicts and encodes one dense ``ScoreBatch``
  (columnar encode with the cross-batch entity row cache, the 64 features
  extracted on the CPU, the history ring, the graph join, the tokenizer:
  ``ScorerConfig.tokenizer`` "word" or "wordpiece", refused when its
  vocabulary is wider than the BERT config's embedding table);
  ``assemble_serial`` is its record-at-a-time oracle;
  ``finalize`` writes velocity, the transaction cache and, in typed graph
  mode, the batch's entity links back after scoring; ``host_stats``
  reports the per-stage spans (assemble, graph, pack, dispatch,
  device_wait) and the cache counters, ``graph_snapshot`` the typed
  graph's store and sampler counters;
- graph plane: ``ScorerConfig.graph_mode`` "bipartite" joins the user <->
  merchant ``EntityGraphStore``; "typed" samples the ``TypedEntityGraph``
  (user <-> device <-> merchant <-> IP) through ``NeighborSampler`` into
  one- and two-hop tensors, with edges ingested at write-back;
- device half: ``dispatch_assembled`` pads the batch to its bucket, packs
  it into the three transfer blobs (a fourth, half-width one with
  ``ScorerConfig.transfer_bf16``), copies them to the card from pinned
  host memory, launches the fused scorer and starts the copy of the result
  matrix back into pinned host memory behind a CUDA event; ``finalize``
  waits on that event and builds the response dicts. The kernel plane's
  host-side accounting (``kernel_snapshot``) records per batch which kernel
  sites the fused scorer dispatched, which fell back (the megakernel's plan
  declining a batch, or f32 BERT weights leaving the int8 site no work),
  and how many hand-written kernels the batch launched;
- QoS seam: ``set_degradation`` takes a ladder rung (``qos/plane.py
  apply_degradation``) as a branch mask anded with the deployment's
  validity (the enabled models of ``Config.models``); a megakernel batch
  passes it as ``mega_valid`` (all false at ``rules_only``);
- handoff seam: ``replay_state`` re-applies the state updates of records
  scored elsewhere, with REVIEW markers in the transaction cache;
- explanations: ``set_feature_importances`` attaches a trainer's gain
  importances as the top-10 ``top_feature_importances`` of every
  explanation; ``set_models`` clears them (they describe the old trees);
- serving seam: ``model_info`` (the branches, their blend weights, the
  strategy), ``quant_snapshot`` (the BERT weight form read from the live
  parameters, the tree kernels, the BERT parameter bytes, the divergence
  gate's verdicts) and ``refresh_blend_from_config`` (a new blend from
  ``Config`` with no new parameters). ``set_models`` may run while
  batches are queued on the card: each ``PendingScore`` holds the models,
  ensemble parameters and megakernel arguments it was launched with until
  ``finalize`` has waited for its event;
- tracing seam: ``dispatch`` and ``dispatch_assembled`` take an optional
  ``obs.tracing.TraceBatch`` and mark the JAX scorer's stages on it
  (``assemble`` before ``assemble`` runs, ``pack``, ``dispatch``,
  ``device_wait`` once the launches and the D2H copy are queued,
  ``finalize`` once the copy's event has completed), so ``device_wait``
  is the card's time as the batch sees it, not the launch's return.

- state tier: in-process single-writer stores by default; with
  ``state_client`` (a ``state.resp.RespClient``), or with
  ``Config.state.backend == "redis"`` (then the scorer connects to
  ``redis_host:redis_port`` itself, owns that client and ``close()``
  releases it), profiles, velocity and the transaction cache live on the
  shared RESP server (``state/shared.py``), so N replicas share one state
  plane; the history ring stays local, as in the JAX scorer. With
  ``stores`` (``cluster/partition.py PartitionedStore``, or any bundle with
  the same four store attributes, and ``graph`` in typed mode) the stores
  are injected: the partition-parallel fleet hands each worker a scorer
  whose state is sliced to its owned partitions. ``stores`` together with a
  state client is refused: both decide where state lives;
- device pool: ``attach_pool`` (called by ``scoring/device_pool.py
  DevicePool``) routes ``dispatch_assembled`` through the pool, which runs
  the same launches on a replica's own CUDA stream; ``finalize`` resolves
  the batch through ``DevicePool.wait`` (which relaunches it on a healthy
  replica when its fetch fails) and ``set_models`` fans the swap out to
  the replicas. A batch's hand-written launches are counted on the thread
  that launches them (``ops.thread_launches``), so ``kernel_snapshot`` stays
  exact with batches dispatched from several threads.

- graph fetch: ``attach_graph_fetch`` (typed mode only) gives the sampler a
  ``graph/fetch.py GraphFetchClient``, which resolves the remote shares of
  a batch's two-hop rings from the other partition workers, budgeted and
  deadlined, degraded to the local subgraph on any failure.

- mesh: a ``scoring/mesh_executor.py MeshExecutor`` attaches through the
  same seam as the pool. ``dispatch_assembled`` pads each batch to a
  multiple of the executor's ``batch_multiple`` (its data axis times 64
  rows), the executor scores each data row's share on its own position,
  and ``model_info`` reports the executor's ``data x model`` geometry.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.core.batching import pad_to_bucket
from realtime_fraud_detection_tpu_torch.core.packing import pack_tree
from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
from realtime_fraud_detection_tpu_torch.features.extract import (
    extract_features_host,
    top_feature_importances,
)
from realtime_fraud_detection_tpu_torch.features.rules import (
    APPROVE,
    APPROVE_WITH_MONITORING,
    DECISIONS,
    DECLINE,
    REVIEW,
    RISK_LEVEL_NAMES,
    risk_level_codes_np,
)
from realtime_fraud_detection_tpu_torch.features.schema import (
    MERCHANT_CATEGORIES,
    EntityRowCache,
    _code,
    encode_transactions,
    encode_transactions_columnar,
)
from realtime_fraud_detection_tpu_torch.graph.sampler import NeighborSampler
from realtime_fraud_detection_tpu_torch.graph.store import TypedEntityGraph
from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG, BertConfig
from realtime_fraud_detection_tpu_torch.models.quant import (
    bert_param_bytes,
    is_quantized_bert,
    quantize_bert_params,
)
from realtime_fraud_detection_tpu_torch.models.text import combined_text
from realtime_fraud_detection_tpu_torch.models.tokenizer import FraudTokenizer
from realtime_fraud_detection_tpu_torch.models.wordpiece import WordPieceTokenizer
from realtime_fraud_detection_tpu_torch.obs.profiling import SpanTimer
from realtime_fraud_detection_tpu_torch.ops import (
    mega_launch_accounting,
    mega_plan,
    thread_launches,
)
from realtime_fraud_detection_tpu_torch.ops.attention import attention_supported
from realtime_fraud_detection_tpu_torch.ops.epilogue import _host_vectors
from realtime_fraud_detection_tpu_torch.ops.dequant_matmul import (
    matmul_supported,
    rows_supported,
)
from realtime_fraud_detection_tpu_torch.ops.megakernel import MegaParamArgs
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    MODEL_NAMES,
    NUM_MODELS,
    OUT_COLUMNS,
    ScoreBatch,
    ScorerConfig,
    ScoringModels,
    init_scoring_models,
    score_fused_packed,
)
from realtime_fraud_detection_tpu_torch.state.history import (
    EntityGraphStore,
    UserHistoryStore,
)
from realtime_fraud_detection_tpu_torch.state.resp import RespClient
from realtime_fraud_detection_tpu_torch.state.shared import (
    SharedProfileStore,
    SharedTransactionCache,
    SharedVelocityStore,
)
from realtime_fraud_detection_tpu_torch.state.stores import (
    ProfileStore,
    TransactionCache,
    VelocityStore,
)
from realtime_fraud_detection_tpu_torch.utils.config import VALID_KERNEL_SITES, Config


@dataclasses.dataclass
class PendingScore:
    """A dispatched-but-not-finalized microbatch. ``out`` is the host
    result matrix, filled once ``event`` (None on the CPU) has completed;
    ``features`` is the host copy of the batch's 64-wide feature rows,
    captured at dispatch (a later dispatch overwrites ``last_features``).
    ``dispatch_ms`` is the host's assemble + dispatch time, so finalize adds
    its own device wait and never the pipeline's queue wait."""

    records: List[Mapping[str, Any]]
    n: int
    out: Optional[torch.Tensor]
    event: Optional[torch.cuda.Event]
    dispatch_ms: float
    model_valid: np.ndarray
    rules_only: bool = False
    features: Optional[np.ndarray] = None
    # the batch's obs.tracing.TraceBatch (None = tracing off): finalize
    # marks "finalize" on it once the result is on the host
    trace: Optional[Any] = None
    # what the batch's launches read (models, ensemble parameters, the
    # megakernel's parameter arguments), held until finalize has waited for
    # ``event``: a hot swap (set_models) or a new blend in between frees
    # nothing a queued kernel still reads, whichever stream a later
    # allocation runs on
    launched_with: Optional[tuple] = None
    # pooled dispatch (scoring/device_pool.py): the pool's token, resolved
    # by DevicePool.wait in finalize (which holds what a replica's launch
    # reads until its event has completed)
    pool_token: Optional[Any] = None
    # the hand-written kernel launches of this batch, a rescue relaunch
    # included
    kernel_launches: int = 0


class _EntityIndex:
    """Stable string id -> dense int index with on-the-fly node features.

    Rows live in one preallocated, doubling (capacity, node_dim) table
    written in place; ``table()`` is a zero-copy slice.
    """

    def __init__(self, node_dim: int):
        self.node_dim = node_dim
        self._idx: Dict[str, int] = {}
        self._profiled: set[str] = set()
        self._tbl = np.zeros((256, node_dim), np.float32)
        self._n = 0

    def _grow(self, need: int) -> None:
        cap = self._tbl.shape[0]
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        tbl = np.zeros((cap, self.node_dim), np.float32)
        tbl[: self._tbl.shape[0]] = self._tbl
        self._tbl = tbl

    def lookup(self, entity_id: str, profile: Optional[Mapping[str, Any]],
               is_merchant: bool) -> int:
        i = self._idx.get(entity_id)
        if i is None:
            i = self._n
            self._idx[entity_id] = i
            self._grow(i + 1)
            self._tbl[i] = self._featurize(profile, is_merchant)
            self._n += 1
        elif profile is not None and entity_id not in self._profiled:
            # a profile arrived after first sight: refresh the zero row
            self._tbl[i] = self._featurize(profile, is_merchant)
        if profile is not None:
            self._profiled.add(entity_id)
        return i

    def lookup_batch(self, entity_ids: Sequence[str],
                     profiles: Mapping[str, Mapping[str, Any]],
                     is_merchant: bool) -> np.ndarray:
        """One dense index vector for a microbatch; featurization runs only
        for ids never seen (or first seen without the profile they have
        now)."""
        out = np.empty((len(entity_ids),), np.int64)
        idx_get = self._idx.get
        prof_get = profiles.get
        profiled = self._profiled
        for k, eid in enumerate(entity_ids):
            i = idx_get(eid)
            if i is None or (eid not in profiled
                             and prof_get(eid) is not None):
                i = self.lookup(eid, prof_get(eid), is_merchant)
            out[k] = i
        return out

    def _featurize(self, p: Optional[Mapping[str, Any]], is_merchant: bool) -> np.ndarray:
        """Node features in the slots of the JAX package's
        ``models/gnn.py build_node_features``."""
        row = np.zeros((self.node_dim,), np.float32)
        if p is None:
            row[8] = 1.0 if is_merchant else 0.0
            return row
        if is_merchant:
            risk = {"low": 0, "medium": 1, "high": 2}.get(str(p.get("risk_level")), 1)
            hours = p.get("operating_hours") or {}
            row[0] = risk / 2.0
            row[1] = float(p.get("fraud_rate", 0.05))
            row[2] = np.log1p(float(p.get("avg_transaction_amount", 0.0)))
            row[3] = float(bool(p.get("is_blacklisted", False)))
            row[4] = _code(MERCHANT_CATEGORIES, p.get("category")) / 10.0
            row[5] = float(hours.get("start_hour", 0)) / 24.0
            row[6] = float(hours.get("end_hour", 24)) / 24.0
            row[8] = 1.0
        else:
            patterns = p.get("behavioral_patterns") or {}
            row[0] = float(p.get("risk_score", 0.5))
            row[1] = np.log1p(float(p.get("avg_transaction_amount", 0.0)))
            row[2] = float(p.get("transaction_frequency", 0.0))
            row[3] = float(p.get("account_age_days", 0.0)) / 365.0
            row[4] = float(str(p.get("kyc_status", "")) == "verified")
            row[5] = float(patterns.get("weekend_activity", 0.5))
            row[6] = float(patterns.get("international_transactions", 0.0) or 0.0)
            row[7] = float(patterns.get("online_preference", 0.7))
        return row

    def table(self) -> np.ndarray:
        return self._tbl[: self._n] if self._n else self._tbl[:1]

    def peek_rows(self, entity_ids: Sequence[str]) -> np.ndarray:
        """Feature rows for known ids, zero rows for unknown ones: a
        read-only probe that never creates entries (the typed sampler's
        two-hop users need not be entities this scorer scores)."""
        out = np.zeros((len(entity_ids), self.node_dim), np.float32)
        get = self._idx.get
        for k, eid in enumerate(entity_ids):
            i = get(eid)
            if i is not None:
                out[k] = self._tbl[i]
        return out


def _stage_bf16(padded: ScoreBatch) -> ScoreBatch:
    """The padded batch with its float-heavy leaves (history, node and
    neighbour features, the two-hop context) as CPU bfloat16 tensors, which
    ``pack_tree`` ships in the half-width bf16 blob (the JAX scorer's
    ``transfer_bf16`` staging, rounded to nearest even as ``ml_dtypes``
    rounds)."""
    names = ["history", "user_feat", "merchant_feat", "user_neigh_feat",
             "merch_neigh_feat"]
    if padded.user_neigh2_feat is not None:
        names += ["user_neigh2_feat", "merch_neigh2_feat"]
    return dataclasses.replace(padded, **{
        name: torch.from_numpy(np.ascontiguousarray(getattr(padded, name),
                                                    np.float32)).to(torch.bfloat16)
        for name in names})


class TorchFraudScorer:
    """Stateful streaming scorer on one device (``cuda`` by default)."""

    def __init__(self, config: Optional[Config] = None,
                 models: Optional[ScoringModels] = None,
                 scorer_config: Optional[ScorerConfig] = None,
                 bert_config: BertConfig = TINY_CONFIG, seed: int = 0,
                 device: str = "cuda",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 state_client: Any = None, stores: Any = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchFraudScorer: no CUDA device available")
        self.config = config or Config()
        self.sc = scorer_config or ScorerConfig()
        self.bert_config = bert_config
        self.compute_dtype = compute_dtype
        self.quant = self.config.quant
        self.kernels = self.config.kernels
        self.ensemble_params = EnsembleParams.from_config(
            self.config, MODEL_NAMES).to(self.device)
        enabled = self.config.get_enabled_models()
        self.model_valid = np.asarray([n in enabled for n in MODEL_NAMES], bool)
        self._qos_mask: Optional[np.ndarray] = None
        self._qos_rules_only = False
        self.qos_level = 0
        # divergence-oracle verdicts recorded against this scorer
        # (record_quant_gate; mirrored by MetricsCollector.sync_quant)
        self._quant_gate_counts: Dict[str, int] = {"pass": 0, "fail": 0}
        self._kernel_counts: Dict[str, Dict[str, int]] = {
            "dispatch": {site: 0 for site in VALID_KERNEL_SITES},
            "fallback": {site: 0 for site in VALID_KERNEL_SITES},
        }
        # the most recent batch: the JAX package's program count (1 when
        # the megakernel served it) and the port's hand-written launches
        self._last_launches_per_batch = 0
        self._last_kernel_launches = 0
        # the top-10 global feature importances attached to every
        # explanation (set_feature_importances; cleared by set_models)
        self._top_importances: Optional[Dict[str, float]] = None
        # the device pool (scoring/device_pool.py), attached by DevicePool
        self._pool = None
        self.set_models(models if models is not None else init_scoring_models(
            seed, bert_config, feature_dim=self.sc.feature_dim,
            node_dim=self.sc.node_dim))

        # streaming state (the reference's Redis plane), read at assembly and
        # written back at finalize: in-process single-writer stores, or with
        # a state client the shared RESP tier, so replicas share one plane
        st = self.config.state
        cache_kwargs = dict(
            txn_ttl_s=st.transaction_ttl_s, features_ttl_s=st.features_ttl_s,
            user_list_len=st.user_history_len,
            merchant_list_len=st.merchant_history_len)
        self._owned_state_client = None
        if state_client is None and st.backend == "redis":
            # a connection the config asked for: this scorer owns it and
            # close() releases it (a client passed in stays the caller's)
            state_client = RespClient(host=st.redis_host, port=st.redis_port)
            self._owned_state_client = state_client
        if stores is not None:
            # an injected bundle (cluster/partition.py PartitionedStore): the
            # partition-parallel fleet's worker scorer, its state sliced to
            # the owned partitions; the scorer itself is shard-oblivious
            if state_client is not None:
                raise ValueError(
                    "pass either stores= (partitioned state) or "
                    "state_client= (shared RESP tier), not both")
            self.profiles = stores.profiles
            self.velocity = stores.velocity
            self.txn_cache = stores.txn_cache
            self.history = stores.history
            hist_seq = getattr(self.history, "seq_len", self.sc.seq_len)
            hist_dim = getattr(self.history, "feature_dim", self.sc.feature_dim)
            if hist_seq != self.sc.seq_len or hist_dim != self.sc.feature_dim:
                # a mismatched table would gather wrong-shaped LSTM inputs
                raise ValueError(
                    f"injected history store is ({hist_seq}, {hist_dim}), "
                    f"scorer expects ({self.sc.seq_len}, {self.sc.feature_dim})")
        elif state_client is not None:
            self.profiles = SharedProfileStore(state_client)
            self.velocity = SharedVelocityStore(state_client)
            self.txn_cache = SharedTransactionCache(state_client, **cache_kwargs)
            self.history = UserHistoryStore(self.sc.seq_len, self.sc.feature_dim)
        else:
            self.profiles = ProfileStore()
            self.velocity = VelocityStore()
            self.txn_cache = TransactionCache(**cache_kwargs)
            self.history = UserHistoryStore(self.sc.seq_len, self.sc.feature_dim)
        self.graph = EntityGraphStore(self.sc.fanout)
        if self.sc.graph_mode not in ("bipartite", "typed"):
            raise ValueError(
                f"ScorerConfig.graph_mode must be 'bipartite' or 'typed', "
                f"got {self.sc.graph_mode!r}")
        self.typed_graph: Optional[TypedEntityGraph] = None
        self._sampler: Optional[NeighborSampler] = None
        if self.sc.graph_mode == "typed":
            # the typed graph rides an injected partition bundle (its
            # ``graph`` facade) when there is one
            tg = getattr(stores, "graph", None) if stores is not None else None
            self.typed_graph = tg if tg is not None else TypedEntityGraph(self.sc.fanout)
            self._sampler = NeighborSampler(
                self.typed_graph, self.sc.node_dim, self.sc.fanout,
                self.sc.graph_fanout2,
                user_rows=lambda ids: self._users.peek_rows(ids),
                merchant_rows=lambda ids: self._merchants.peek_rows(ids))
        if self.sc.tokenizer == "wordpiece":
            self.tokenizer = WordPieceTokenizer(
                max_length=self.sc.text_len,
                cache_entries=self.sc.token_cache_entries)
        elif self.sc.tokenizer == "word":
            self.tokenizer = FraudTokenizer(
                vocab_size=bert_config.vocab_size, max_length=self.sc.text_len,
                cache_entries=self.sc.token_cache_entries)
        else:
            # a typo'd tokenizer name must not silently feed the text model
            # ids from another vocabulary
            raise ValueError(
                f"ScorerConfig.tokenizer must be 'word' or 'wordpiece', "
                f"got {self.sc.tokenizer!r}")
        if self.tokenizer.vocab_size > bert_config.vocab_size:
            # on the card an out-of-range id would reach a hand-written
            # gather with no bounds check: refuse the pairing here
            raise ValueError(
                f"tokenizer vocab_size {self.tokenizer.vocab_size} exceeds "
                f"bert_config.vocab_size {bert_config.vocab_size}")
        self._users = _EntityIndex(self.sc.node_dim)
        self._merchants = _EntityIndex(self.sc.node_dim)
        self._join_cache = EntityRowCache()
        self.spans = SpanTimer()
        self.last_features = np.zeros((0, self.sc.feature_dim), np.float32)
        self.stats: Dict[str, float] = {"scored": 0, "batches": 0, "total_time_s": 0.0}

    # ------------------------------------------------------------ state plane
    def seed_profiles(self, users: Mapping[str, Mapping[str, Any]],
                      merchants: Mapping[str, Mapping[str, Any]]) -> None:
        self.profiles.seed(users, merchants)

    def close(self) -> None:
        """Release what this scorer owns: the state-tier connection it made
        itself for ``Config.state.backend == "redis"``."""
        if self._owned_state_client is not None:
            try:
                self._owned_state_client.close()
            finally:
                self._owned_state_client = None

    # ----------------------------------------------------------------- models
    def set_models(self, models: ScoringModels) -> None:
        """Swap the model set; with int8 BERT configured the weights are
        quantized on the host first (idempotent), then moved to the device.
        Raises when a per-site kernel the settings ask for does not take the
        configured widths (its wrapper would raise on every batch). This is
        the only way the scorer's models change: the megakernel's parameter
        arguments point into them and are rebuilt here."""
        if self.quant.bert_mode() == "int8":
            models = dataclasses.replace(
                models, bert=quantize_bert_params(models.bert))
        self._check_kernel_widths(models)
        self.models = models.to(self.device)
        self._mega_plans: Dict[tuple, Dict[str, Any]] = {}
        self._mega_args: Optional[MegaParamArgs] = None
        # the importances described the old trees; the caller re-attaches
        # them for the new set
        self._top_importances = None
        if self._pool is not None:
            # replica by replica; a batch in flight keeps what it launched
            # with
            self._pool.set_models(self.models)

    # ---------------------------------------------------------------- pooling
    def attach_pool(self, pool) -> None:
        """Adopt a ``DevicePool`` or a ``MeshExecutor``: later dispatches
        route through it. Called by their ``__init__``: build the scorer
        first, then the pool around it."""
        self._pool = pool

    @property
    def pool(self):
        return self._pool

    def set_feature_importances(self, importances) -> None:
        """Attach global gain importances (e.g. ``GBDTTrainer.
        feature_importances_``) to prediction explanations as the top-10
        name -> score mapping; None clears them."""
        self._top_importances = (None if importances is None
                                 else top_feature_importances(importances))

    def _check_kernel_widths(self, models: ScoringModels) -> None:
        modes = self.kernels.site_modes()
        h = self.bert_config.hidden_size
        ffn = self.bert_config.intermediate_size
        if (modes["dequant_matmul"] == "cuda" and is_quantized_bert(models.bert)
                and not (matmul_supported(1, h, h) and matmul_supported(1, h, ffn)
                         and matmul_supported(1, ffn, h) and rows_supported(h))):
            raise ValueError(f"the dequant_matmul kernel does not take hidden {h}"
                             f" / FFN {ffn}")
        if (modes["attention"] == "flash"
                and not attention_supported(self.sc.text_len,
                                            self.bert_config.head_dim)):
            raise ValueError(
                f"the flash attention kernel does not take text length "
                f"{self.sc.text_len} / head width {self.bert_config.head_dim}")

    def refresh_blend_from_config(self) -> None:
        """Re-read the blend (weights, strategy, thresholds) and the enabled
        branches from ``self.config``: weights and validity are run-time
        tensors of the fused scorer, so the next batch runs the new blend.
        Callers hold the serving score lock."""
        self.ensemble_params = EnsembleParams.from_config(
            self.config, MODEL_NAMES).to(self.device)
        enabled = self.config.get_enabled_models()
        self.model_valid = np.asarray([n in enabled for n in MODEL_NAMES], bool)

    def record_quant_gate(self, passed: bool) -> None:
        """Record a divergence-oracle verdict of a caller comparing the
        quantized plane with f32 (``quant_gate_verdicts_total``)."""
        self._quant_gate_counts["pass" if passed else "fail"] += 1

    def quant_snapshot(self) -> Dict[str, Any]:
        """The quantized plane as served: the BERT weight form read from the
        live parameters (the truth after an ``allow_arch_mismatch``
        restore), the tree kernels, the BERT parameter bytes and the gate's
        verdicts."""
        static = self.quant.static()
        return {
            "modes": {
                "bert_text": ("int8" if is_quantized_bert(self.models.bert)
                              else "f32"),
                "xgboost_primary": static["tree_kernel"],
                "isolation_forest": static["iforest_kernel"],
            },
            "param_bytes": {"bert_text": bert_param_bytes(self.models.bert)},
            "gate": dict(self._quant_gate_counts),
        }

    def model_info(self) -> Dict[str, Any]:
        """The branches (enabled, normalised blend weight), the strategy,
        the branch count and the device layout in the JAX scorer's mesh
        axes: an attached mesh executor's ``data x model`` geometry, else
        every axis 1."""
        norm = self.config.normalized_weights()
        return {
            "models": {
                name: {"enabled": bool(self.model_valid[j]),
                       "weight": float(norm.get(name, 0.0))}
                for j, name in enumerate(MODEL_NAMES)
            },
            "strategy": self.config.ensemble.strategy,
            "num_models": NUM_MODELS,
            "mesh": {"data": int(getattr(self._pool, "data_axis", 1)),
                     "model": int(getattr(self._pool, "model_axis", 1)), "seq": 1},
        }

    def set_degradation(self, mask: Optional[np.ndarray],
                        rules_only: bool = False, level: int = 0) -> None:
        """QoS rung (``qos/ladder.py LADDER_LEVELS[level]``): ``mask``
        narrows the enabled branches for later dispatches; ``rules_only``
        serves the rule score instead; ``level`` is the rung's index."""
        self._qos_mask = None if mask is None else np.asarray(mask, bool)
        self._qos_rules_only = bool(rules_only)
        self.qos_level = int(level)

    def effective_model_valid(self) -> np.ndarray:
        """Deployment validity AND the current QoS rung's mask."""
        if self._qos_mask is None:
            return self.model_valid.copy()
        return self.model_valid & self._qos_mask

    # ----------------------------------------------------------- kernel plane
    def kernel_static(self, size: int, model_valid=None,
                      has_two_hop: bool = False) -> Dict[str, Any]:
        """The kernel selection the fused scorer takes for a ``size``-row
        batch (with two-hop context when ``has_two_hop``). ``mega_valid``
        is the QoS rung as a tuple of branch-validity booleans
        (``model_valid`` when given, the dispatch-time snapshot; else the
        current effective mask) when the megakernel is on and its plan
        admits the batch; None otherwise, which runs the per-site chain."""
        static = dict(self.kernels.static())
        mega_valid = None
        if (static["megakernel"] == "cuda"
                and self._mega_plan(size, has_two_hop)["supported"]):
            mv = (self.effective_model_valid() if model_valid is None
                  else np.asarray(model_valid))
            mega_valid = tuple(bool(v) for v in mv)
        static["mega_valid"] = mega_valid
        return static

    def _mega_plan(self, size: int, has_two_hop: bool = False) -> Dict[str, Any]:
        """The megakernel's shape plan for a ``size``-row batch, two-hop or
        not (a typed-graph batch carries two-hop context and is declined,
        as the JAX plan declines it). Kept per (size, two-hop) until the
        models change."""
        key = (size, bool(has_two_hop))
        plan = self._mega_plans.get(key)
        if plan is None:
            plan = self._mega_plans[key] = mega_plan(
                self.models, self.bert_config, b=size,
                text_len=self.sc.text_len, seq_len=self.sc.seq_len,
                feature_dim=self.sc.feature_dim, has_two_hop=has_two_hop,
                fanout=self.sc.fanout)
        return plan

    def _mega_param_args(self) -> MegaParamArgs:
        """The megakernel's parameter arguments for the current models,
        built at the first batch the megakernel serves after ``set_models``
        and passed with every later one. A typed-mode scorer never builds
        them: its plan declines every batch it assembles."""
        if self._mega_args is None:
            self._mega_args = self.mega_param_args_for(self.models, self.device)
        return self._mega_args

    def mega_param_args_for(self, models: ScoringModels,
                            device: torch.device) -> MegaParamArgs:
        """The megakernel's parameter arguments for ``models`` on
        ``device`` at this scorer's widths and compute dtype (a device
        pool's replica on another card builds its own)."""
        widths = (self.sc.text_len, self.sc.feature_dim, self.sc.seq_len,
                  self.sc.fanout)
        return MegaParamArgs(models, self.bert_config, self.compute_dtype, widths,
                             device)

    def _record_kernel_dispatch(self, size: int, model_valid,
                                mega_served: bool) -> None:
        """Host-side account of the kernel sites one ``size``-row batch
        under the rung ``model_valid`` dispatches. A batch the megakernel
        served runs one launch and touches no per-site counter; a declined
        one counts a megakernel fallback and the per-site chain. A per-site
        site counts as dispatched when its mode asks for the kernel (the
        widths were checked by ``set_models``); the int8 site also counts
        a fallback with f32 BERT weights, where the plain matmul runs."""
        if not self.kernels.enabled:
            return
        modes = self.kernels.site_modes()
        disp = self._kernel_counts["dispatch"]
        fall = self._kernel_counts["fallback"]
        if modes["megakernel"] == "cuda":
            disp["megakernel"] += 1
            if mega_served:
                self._last_launches_per_batch = 1
                return
            fall["megakernel"] += 1
        self._last_launches_per_batch = mega_launch_accounting(
            size, NUM_MODELS, mega_valid=tuple(bool(v) for v in model_valid),
        )["launches_per_batch_chain"]
        if modes["dequant_matmul"] == "cuda":
            disp["dequant_matmul"] += 1
            if not is_quantized_bert(self.models.bert):
                fall["dequant_matmul"] += 1
        if modes["epilogue"] == "cuda":
            disp["epilogue"] += 1
        if modes["attention"] == "flash":
            disp["attention"] += 1

    def kernel_snapshot(self) -> Dict[str, Any]:
        """Effective per-site modes, cumulative dispatch / fallback counts
        per site, and two launch counts of the most recent batch:
        ``launches_per_batch`` is the JAX package's program count (1 when
        the megakernel served, else the enabled branches + 2), kept equal
        to its gauge; ``kernel_launches`` is the port's own count of
        hand-written kernel launches (0 on the CPU, where the plain
        versions run)."""
        return {
            "modes": self.kernels.site_modes(),
            "dispatch": dict(self._kernel_counts["dispatch"]),
            "fallback": dict(self._kernel_counts["fallback"]),
            "launches_per_batch": self._last_launches_per_batch,
            "kernel_launches": self._last_kernel_launches,
        }

    # --------------------------------------------------------------- assembly
    def assemble(self, records: Sequence[Mapping[str, Any]],
                 now: Optional[float] = None) -> ScoreBatch:
        """Join state + encode one dense host ``ScoreBatch``.

        Profile and velocity joins gather through the generation-stamped
        entity row cache, entity indices resolve in one batched lookup, the
        features are extracted on the CPU and appended to the history ring
        before it is gathered (each row is scored against a history that
        ends with itself), and repeated texts hit the token LRU.
        """
        t0 = time.perf_counter()
        user_ids = [str(r.get("user_id", "")) for r in records]
        merchant_ids = [str(r.get("merchant_id", "")) for r in records]
        uprofs = {u: p for u in user_ids
                  if (p := self.profiles.get_user(u)) is not None}
        mprofs = {m: p for m in merchant_ids
                  if (p := self.profiles.get_merchant(m)) is not None}
        velocities = {u: self.velocity.get_all(u, now) for u in set(user_ids)}

        self._join_cache.sync(self.profiles)
        txn = encode_transactions_columnar(records, uprofs, mprofs, velocities,
                                           cache=self._join_cache)
        feats = extract_features_host(txn)
        self.last_features = feats  # host copy for the features topic
        history, history_len = self.history.append_and_gather(user_ids, feats)

        u_idx = self._users.lookup_batch(user_ids, uprofs, False)
        m_idx = self._merchants.lookup_batch(merchant_ids, mprofs, True)
        graph_t = self._graph_join(user_ids, merchant_ids, u_idx, m_idx)

        token_ids, token_mask = self.tokenizer.encode_batch(
            self._texts_for(records, merchant_ids, mprofs))

        batch = ScoreBatch(
            txn=txn,
            features=feats,
            history=history,
            history_len=history_len,
            token_ids=token_ids.astype(np.int32),
            token_mask=token_mask.astype(bool),
            valid=np.ones((len(records),), bool),
            **graph_t,
        )
        self.spans.record("assemble", time.perf_counter() - t0)
        return batch

    def _graph_join(self, user_ids: Sequence[str], merchant_ids: Sequence[str],
                    u_idx: np.ndarray, m_idx: np.ndarray
                    ) -> Dict[str, np.ndarray]:
        """The GNN's tensors, the one seam both assemble paths call.
        Bipartite: this batch's neighbourhoods see only earlier batches'
        edges, then the batch's own edges are committed for the next batch.
        Typed: the sampler's one- and two-hop tensors; the edges are
        ingested at write-back."""
        t0 = time.perf_counter()
        utable, mtable = self._users.table(), self._merchants.table()
        out = {"user_feat": utable[u_idx], "merchant_feat": mtable[m_idx]}
        if self._sampler is not None:
            out.update(self._sampler.sample(user_ids, merchant_ids))
        else:
            un_idx, un_mask = self.graph.user_neighbors(u_idx)
            mn_idx, mn_mask = self.graph.merchant_neighbors(m_idx)
            out.update(
                user_neigh_feat=mtable[np.where(un_mask, un_idx, 0)],
                user_neigh_mask=un_mask,
                merch_neigh_feat=utable[np.where(mn_mask, mn_idx, 0)],
                merch_neigh_mask=mn_mask,
            )
            self.graph.add_edges(u_idx, m_idx)
        self.spans.record("graph", time.perf_counter() - t0)
        return out

    def assemble_serial(self, records: Sequence[Mapping[str, Any]],
                        now: Optional[float] = None) -> ScoreBatch:
        """Record-at-a-time assembly, the oracle of the columnar
        ``assemble``: each record runs the join, a 1-row encode, a 1-row
        feature extraction, a history append and a tokenize alone, and the
        rows are stacked at the end. One batch-level carve-out: the graph
        join for all records precedes this batch's edge inserts, as in
        ``assemble``."""
        n = len(records)
        user_ids = [str(r.get("user_id", "")) for r in records]
        merchant_ids = [str(r.get("merchant_id", "")) for r in records]
        txns, feat_rows, hist_rows, hist_lens, tok_rows, tok_masks = (
            [], [], [], [], [], [])
        u_idx = np.empty((n,), np.int64)
        m_idx = np.empty((n,), np.int64)
        mprofs: Dict[str, Any] = {}
        for i, (r, uid, mid) in enumerate(zip(records, user_ids, merchant_ids)):
            up = self.profiles.get_user(uid)
            mp = self.profiles.get_merchant(mid)
            if mp is not None:
                mprofs[mid] = mp
            txn = encode_transactions(
                [r], {uid: up} if up is not None else {},
                {mid: mp} if mp is not None else {},
                {uid: self.velocity.get_all(uid, now)})
            feats = extract_features_host(txn)
            hist, hlen = self.history.append_and_gather([uid], feats)
            u_idx[i] = self._users.lookup(uid, up, False)
            m_idx[i] = self._merchants.lookup(mid, mp, True)
            ids, mask = self.tokenizer.encode_batch(
                self._texts_for([r], [mid], mprofs))
            txns.append(txn)
            feat_rows.append(feats)
            hist_rows.append(hist)
            hist_lens.append(hlen)
            tok_rows.append(ids)
            tok_masks.append(mask)

        graph_t = self._graph_join(user_ids, merchant_ids, u_idx, m_idx)
        txn_all = type(txns[0])(**{
            f.name: np.concatenate([np.asarray(getattr(t, f.name)) for t in txns])
            for f in dataclasses.fields(txns[0])})
        feats = np.concatenate(feat_rows, axis=0)
        self.last_features = feats
        return ScoreBatch(
            txn=txn_all,
            features=feats,
            history=np.concatenate(hist_rows, axis=0),
            history_len=np.concatenate(hist_lens, axis=0),
            token_ids=np.concatenate(tok_rows, axis=0).astype(np.int32),
            token_mask=np.concatenate(tok_masks, axis=0).astype(bool),
            valid=np.ones((n,), bool),
            **graph_t,
        )

    def _texts_for(self, records, merchant_ids, mprofs) -> List[str]:
        """Combined text per record for the text branch (models/text.py)."""
        texts = []
        for r, m in zip(records, merchant_ids):
            mp = mprofs.get(m) or {}
            texts.append(combined_text({
                "merchant_name": mp.get("name") or str(r.get("merchant_name", "")),
                "description": str(r.get("description", "") or ""),
                "category": str(mp.get("category", "") or ""),
                "location": str(r.get("location", "") or ""),
            }))
        return texts

    def host_stats(self) -> Dict[str, Any]:
        """Per-stage span stats (assemble / graph / pack / dispatch /
        device_wait) and the entity-row and token cache counters."""
        return {"stages": self.spans.stats(),
                "caches": {"entity_rows": self._join_cache.stats(),
                           "tokens": self.tokenizer.cache_stats()}}

    def attach_graph_fetch(self, client) -> None:
        """Adopt a ``graph/fetch.py GraphFetchClient``: the typed sampler
        resolves non-owned neighbour nodes through it. Typed mode only."""
        if self._sampler is None:
            raise ValueError(
                "attach_graph_fetch needs ScorerConfig.graph_mode='typed'")
        self._sampler.attach_fetch(client)

    def graph_snapshot(self) -> Dict[str, Any]:
        """The graph mode and, in typed mode, the typed store's node and
        edge counts by type, the sampler's cache hits, misses and
        evictions, and with a fetch client attached its counters."""
        snap: Dict[str, Any] = {"mode": self.sc.graph_mode}
        if self.typed_graph is not None:
            snap["store"] = self.typed_graph.stats()
            snap["sampler"] = self._sampler.stats()
            if self._sampler.fetch is not None:
                snap["fetch"] = self._sampler.fetch.stats()
        return snap

    # ---------------------------------------------------------------- scoring
    @staticmethod
    def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
        host = torch.from_numpy(arr)
        if device.type != "cuda":
            return host.to(device)
        # a fresh pinned buffer per blob and batch: with two batches in
        # flight a reused one could be rewritten while the earlier batch's
        # non-blocking copy still reads it
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        return pinned.to(device, non_blocking=True)

    def launch_packed(self, blobs: Dict[str, np.ndarray], spec, mv: np.ndarray,
                      static: Dict[str, Any], device: torch.device,
                      models: ScoringModels, params: EnsembleParams,
                      mega_args: Optional[MegaParamArgs]) -> tuple:
        """Copy the packed host blobs to ``device`` from pinned memory, run
        the fused scorer (the kernel selection ``static``, the rung ``mv``)
        and start the copy of its result into pinned host memory behind a
        CUDA event, all on the calling thread's current stream of
        ``device``. Returns (host result, event or None on the CPU, the
        hand-written kernels launched). The device pool calls this under a
        replica's stream with the replica's models."""
        dev_blobs = {name: self._to_device(arr, device) for name, arr in blobs.items()}
        before = thread_launches()
        out = score_fused_packed(
            models, dev_blobs, spec, params, torch.from_numpy(mv),
            bert_config=self.bert_config, compute_dtype=self.compute_dtype,
            param_args=mega_args, **self.quant.static(), **static)
        launches = thread_launches() - before
        if device.type != "cuda":
            return out, None, launches
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        # on the stream that ran the batch: this thread's current one (with
        # overlapped assembly the stage thread's, in a pool the replica's)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        return host, event, launches

    def dispatch(self, records: Sequence[Mapping[str, Any]],
                 now: Optional[float] = None,
                 trace: Optional[Any] = None) -> PendingScore:
        """Assemble + launch without waiting for the device: the caller can
        assemble the next microbatch while the card runs this one;
        ``finalize`` waits, builds the responses and writes state back.
        ``trace`` (an ``obs.tracing.TraceBatch``) collects the batch's stage
        marks; None costs one branch a stage."""
        t0 = time.perf_counter()
        if not records:
            return PendingScore(records=[], n=0, out=None, event=None,
                                dispatch_ms=0.0,
                                model_valid=self.effective_model_valid(),
                                features=self.last_features[:0])
        if trace is not None:
            trace.mark("assemble")
        batch = self.assemble(records, now)
        return self.dispatch_assembled(batch, records, t0=t0, trace=trace)

    def dispatch_assembled(self, batch: ScoreBatch,
                           records: Sequence[Mapping[str, Any]],
                           t0: Optional[float] = None,
                           trace: Optional[Any] = None) -> PendingScore:
        """Pad + pack + launch an assembled host batch without waiting for
        the device."""
        t0 = time.perf_counter() if t0 is None else t0
        if trace is not None:
            trace.mark("pack")
        t_pack = time.perf_counter()
        n = len(records)
        # an attached mesh executor splits the batch over its data axis in
        # whole row blocks: pad to its multiple
        padded, mask, size = pad_to_bucket(
            batch, n, multiple_of=getattr(self._pool, "batch_multiple", 1))
        padded = dataclasses.replace(padded, valid=mask)
        if self.sc.transfer_bf16:
            padded = _stage_bf16(padded)
        blobs, spec = pack_tree(padded)
        self.spans.record("pack", time.perf_counter() - t_pack)
        if trace is not None:
            trace.mark("dispatch")
        t_disp = time.perf_counter()
        mv = self.effective_model_valid()
        static = self.kernel_static(size, mv,
                                    has_two_hop=batch.user_neigh2_feat is not None)
        self._record_kernel_dispatch(size, mv,
                                     mega_served=static["mega_valid"] is not None)
        token = event = launched_with = None
        if self._pool is not None:
            # the whole microbatch runs on one replica, picked round-robin
            # by the pool; in-flight depth and the rescue live there
            token = self._pool.dispatch_packed(blobs, spec, self.ensemble_params,
                                               mv, static)
            host, launches = None, token.launches
            if trace is not None:
                # which replica took the batch and how deep its queue was
                trace.annotate(replica=token.replica_idx,
                               inflight_depth=token.inflight_at_dispatch)
        else:
            mega_args = (self._mega_param_args() if static["mega_valid"] is not None
                         else None)
            host, event, launches = self.launch_packed(
                blobs, spec, mv, static, self.device, self.models,
                self.ensemble_params, mega_args)
            launched_with = (self.models, self.ensemble_params, mega_args)
        self._last_kernel_launches = launches
        self.spans.record("dispatch", time.perf_counter() - t_disp)
        if trace is not None:
            # the launches and the D2H copy are queued: from the batch's
            # point of view the card's time (and any pipeline dwell) starts
            trace.mark("device_wait")
        return PendingScore(
            records=list(records), n=n, out=host, event=event,
            dispatch_ms=(time.perf_counter() - t0) * 1000.0,
            model_valid=mv, rules_only=self._qos_rules_only,
            features=np.asarray(batch.features), trace=trace,
            launched_with=launched_with, pool_token=token,
            kernel_launches=launches)

    def finalize(self, pending: PendingScore, now: Optional[float] = None,
                 lock=None) -> List[Dict[str, Any]]:
        """Wait for a dispatched batch, build its responses and write state
        back. ``lock`` (optional) is held around the write-back only, not
        the device wait."""
        if pending.n == 0:
            return []
        t_fin = time.perf_counter()
        # the blend the batch was launched with reads its explanations and
        # rung ladders, even when a promotion or reload swapped it since
        if pending.pool_token is not None:
            # pooled completion: DevicePool.wait relaunches the batch on a
            # healthy replica when this one's fetch fails
            token = pending.pool_token
            pending.out = self._pool.wait(token)
            params = token.params
            if token.launches != pending.kernel_launches:
                # a rescue relaunch counts toward its batch
                pending.kernel_launches = token.launches
                self._last_kernel_launches = token.launches
        else:
            if pending.event is not None:
                pending.event.synchronize()
            params = pending.launched_with[1] if pending.launched_with else None
        pending.launched_with = None
        self.spans.record("device_wait", time.perf_counter() - t_fin)
        if pending.trace is not None:
            # read after the D2H event completed, not after the launch
            # returned: device_wait ends with the result on the host
            pending.trace.mark("finalize")
        elapsed_ms = pending.dispatch_ms + (time.perf_counter() - t_fin) * 1000.0
        results = self._build_responses(
            pending.records, pending.out.numpy(), pending.n, elapsed_ms,
            model_valid=pending.model_valid, rules_only=pending.rules_only,
            params=params)
        with (lock if lock is not None else contextlib.nullcontext()):
            self._write_back(pending.records, results, now)
            self.stats["scored"] += pending.n
            self.stats["batches"] += 1
            self.stats["total_time_s"] += elapsed_ms / 1000.0
        return results

    def score_batch(self, records: Sequence[Mapping[str, Any]],
                    now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Score transaction dicts -> prediction dicts (one batch, waited)."""
        return self.finalize(self.dispatch(records, now), now)

    def replay_state(self, records: Sequence[Mapping[str, Any]],
                     now: Optional[float] = None) -> None:
        """State-only replay (JAX ``FraudScorer.replay_state``): re-apply
        the state updates of records already scored, emitted and committed
        elsewhere, with no scoring on the card and nothing emitted.
        ``assemble`` rebuilds the history ring and the profile / velocity
        read path as the scoring pass did; the write-back caches each
        transaction with a REVIEW marker (its served score is not known
        here), so a later duplicate re-emits the marker rather than an
        invented score."""
        if not records:
            return
        self.assemble(records, now=now)
        markers = [{
            "transaction_id": str(r.get("transaction_id", "")),
            "fraud_score": 0.5,
            "decision": "REVIEW",
            "risk_level": "UNKNOWN",
            "confidence": 0.0,
            "explanation": {"replay_restored": True},
        } for r in records]
        self._write_back(records, markers, now)

    def _write_back(self, records, results, now: Optional[float]) -> None:
        """Post-scoring state updates (RedisTransactionSink.java:53-135):
        velocity, the transaction cache with enough of the result for the
        job's dedupe path to re-emit a faithful prediction, and in typed
        graph mode the batch's entity links."""
        ts = now if now is not None else time.time()
        for rec, res in zip(records, results):
            uid = str(rec.get("user_id", ""))
            self.velocity.update(uid, float(rec.get("amount", 0.0)), ts)
            merged = dict(rec)
            merged["fraud_score"] = res["fraud_score"]
            merged["decision"] = res["decision"]
            merged["risk_level"] = res["risk_level"]
            merged["confidence"] = res["confidence"]
            self.txn_cache.cache_transaction(merged, now=ts)
        if self.typed_graph is not None:
            # the typed graph's ingest: the batch's user -> device / merchant
            # / IP links, then the sampler evicts what they changed
            self.typed_graph.add_batch(
                [str(r.get("user_id", "")) for r in records],
                [str(r.get("merchant_id", "")) for r in records],
                [str(r.get("device_id") or r.get("device_fingerprint") or "")
                 for r in records],
                [str(r.get("ip_address") or "") for r in records])
            self._sampler.sync()

    def _build_responses(self, records, out, n, elapsed_ms, model_valid=None,
                         rules_only=False, params=None) -> List[Dict[str, Any]]:
        """Response dicts from the packed matrix ``out`` ([B, 8+M] or, with
        the epilogue extension, [B, 8+2M+2]); ``params`` is the batch's
        ``EnsembleParams`` (default the current ones)."""
        if model_valid is None:
            model_valid = self.model_valid
        if params is None:
            params = self.ensemble_params
        mat = np.asarray(out)[:n]
        col = {name: mat[:, j] for j, name in enumerate(OUT_COLUMNS)}
        probs = col["fraud_probability"]
        conf = col["confidence"]
        decisions = col["decision"].astype(np.int32)
        risk = col["risk_level"].astype(np.int32)
        base_w = len(OUT_COLUMNS) + NUM_MODELS
        extended = mat.shape[1] >= base_w + NUM_MODELS + 2
        preds = mat[:, len(OUT_COLUMNS):base_w]
        contrib_cols = mat[:, base_w:base_w + NUM_MODELS] if extended else None
        rule = col["rule_score"]
        if rules_only and extended:
            probs = rule
            conf = np.ones_like(probs)
            decisions = mat[:, base_w + NUM_MODELS].astype(np.int32)
            risk = mat[:, base_w + NUM_MODELS + 1].astype(np.int32)
        elif rules_only:
            p = params
            probs = rule
            conf = np.ones_like(probs)
            decisions = np.where(
                probs >= p.decline_threshold, DECLINE,
                np.where(probs >= p.review_threshold, REVIEW,
                         np.where(probs >= p.monitor_threshold,
                                  APPROVE_WITH_MONITORING,
                                  APPROVE))).astype(np.int32)
            risk = risk_level_codes_np(probs)
        high_amount = col["high_amount"] > 0.5
        unusual_hour = col["unusual_hour"] > 0.5
        high_risk_payment = col["high_risk_payment"] > 0.5
        per_txn_ms = elapsed_ms / max(n, 1)

        results = []
        with_explanation = self.config.ensemble.enable_explanation
        # the weights' host copy is cached: reading the card here would wait
        # on whatever another thread has queued on its stream
        weights = (np.asarray(_host_vectors(params)[0], np.float32)
                   if with_explanation and contrib_cols is None else None)
        for i, rec in enumerate(records):
            model_predictions = {
                name: float(preds[i, j])
                for j, name in enumerate(MODEL_NAMES) if model_valid[j]
            }
            if with_explanation:
                factors = []
                if high_amount[i]:
                    factors.append("high_transaction_amount")
                if unusual_hour[i]:
                    factors.append("unusual_transaction_hour")
                if high_risk_payment[i]:
                    factors.append("high_risk_payment_method")
                if contrib_cols is not None:
                    contributions = {
                        name: float(contrib_cols[i, j])
                        for j, name in enumerate(MODEL_NAMES) if model_valid[j]
                    }
                else:
                    contributions = {
                        name: float(weights[j] * preds[i, j])
                        for j, name in enumerate(MODEL_NAMES) if model_valid[j]
                    }
                explanation = {
                    "model_contributions": contributions,
                    "key_factors": factors,
                    "rule_score": float(rule[i]),
                }
                if rules_only:
                    explanation["degraded"] = "rules_only"
                if self._top_importances is not None:
                    # a fresh dict per response: a consumer mutating one
                    # explanation must not change its batch-mates'
                    explanation["top_feature_importances"] = dict(
                        self._top_importances)
            else:
                explanation = {}
            results.append({
                "transaction_id": str(rec.get("transaction_id", "")),
                "fraud_probability": float(probs[i]),
                "fraud_score": float(probs[i]),
                "risk_level": RISK_LEVEL_NAMES[int(risk[i])],
                "decision": DECISIONS[int(decisions[i])],
                "model_predictions": model_predictions,
                "confidence": float(conf[i]),
                "processing_time_ms": per_txn_ms,
                "explanation": explanation,
            })
        return results
