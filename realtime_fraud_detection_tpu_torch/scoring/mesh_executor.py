"""Mesh-sharded scoring: ``data x model`` sharding behind the pool seam.

Port of the JAX package's ``scoring/mesh_executor.py``. ``DevicePool``
(``scoring/device_pool.py``) replicates the full models on every replica;
this executor splits each replica into a ``data x model`` mesh
(``core/mesh.py``): the microbatch splits over ``data`` (each data row of
the mesh scores B/data rows) while the branches named in ``shard_branches``
store their parameters split over ``model`` (each position holds 1/model of
the branch), trees / iforest / rules always replicated.

Storage sharding, not compute sharding: scores must be bit-identical to one
position's, and Megatron's row-parallel partial sums reorder float
additions. So a sharded branch stores each leaf split along its storage spec
(``parallel/layouts.py branch_serving_specs``: the Megatron column / row
positions), one block a ``model`` position, and at use ``_regather_models``
rebuilds the exact bytes (``torch.cat`` of the blocks on the scoring
position's device, on its stream). Each data row of the mesh scores its rows
through ``TorchFraudScorer.launch_packed`` (the megakernel or the per-site
chain, the plan decided for the shard's size) on the stream of its position
``(d, 0)``; the outputs join in row order. Replicated branches on one device
share one set of tensors, as in the pool; ``param_bytes`` counts what each
position stores, so the 60% bound at ``model_axis=2`` is read per position.

The gather makes the PARAMETERS exact; the rows match only in whole
blocks. A shard of B/data rows is a smaller product than the
whole batch, and below ``ROW_BLOCK`` (64) rows the chain's plain products
and reductions take another algorithm on the card (another summation
order), and PyTorch's CPU loops finish a remainder with scalar code that
rounds otherwise than the vector code; cuBLAS's split-K also changes with
the row count. So ``batch_multiple`` is ``data * ROW_BLOCK``: the scorer
pads every mesh batch to it (row 0 repeated), each data shard is a whole
number of 64-row blocks, and a mesh on the card turns split-K off for its
process (``core/precision.py batch_invariant_blas``; the constructor
raises where CUDA already runs without it). Then a shard's rows equal the
same rows scored by one position in any batch of a multiple of 64 rows
(JAX pins its contract at >= 8 rows a shard). Only the mesh pays for the
padding: a one-row request on a data-4 mesh scores 256 rows.

Discipline as the pool's: ``devices`` split into ``replicas`` equal subsets,
one mesh each; strict round-robin over the healthy replicas with
``inflight_depth`` batches on each; the branch mask snapshotted per
dispatch; ``set_models`` re-places replica by replica under the caller's
score lock, and a batch in flight keeps the tensors it launched with
(``MeshToken.launched_with``: the stored blocks and the gathered
temporaries, until its events completed), so no batch sees mixed
parameters. There is no rescue: a mesh batch lives across a whole replica, so ``wait``
marks a failed replica unhealthy and raises (``inject_fault`` arms such a
failure at the fetch, on the host).

A pre-built ``mesh=`` (``core/mesh.py build_multihost_mesh``, a
process-major data axis over ``gloo`` processes) is one spanning replica,
and this executor is one process's participant in it. Every process holds
the same models and the same global packed batch (both from seeds or a
checkpoint); each stores blocks only on its own positions, launches only
its own data rows, and ``wait`` returns its own rows in row order. Every
``model`` tile lies inside one process (the mesh refuses one that would
straddle), so the gather at use stays local: no batch or parameter bytes
cross processes, and ``gloo`` carries only the mesh's exchange of device
names.

Each data row's launch goes through ``mesh_score_packed`` (the regather,
then ``TorchFraudScorer.launch_packed``); ``mesh_entry()`` returns it, as
the JAX package's returns its jitted entry. Left out, as the pool left them
out: ``donate``, ``mesh_entry(donate=True)`` and ``donation_lowering`` (an
XLA buffer-aliasing switch) and ``complete_no_fetch`` (a hook for the JAX
benchmark).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.core import sync
from realtime_fraud_detection_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshConfig,
    P,
    build_mesh,
    tree_leaves,
    tree_map,
)
from realtime_fraud_detection_tpu_torch.core.precision import batch_invariant_blas
from realtime_fraud_detection_tpu_torch.parallel.layouts import (
    SHARDABLE_BRANCHES,
    branch_serving_specs,
)
from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES

__all__ = ["MeshExecutor", "MeshToken", "ROW_BLOCK", "mesh_entry",
           "mesh_positions", "mesh_score_packed"]

# rows in a block of a data shard: a multiple of every CPU vector loop's step
# (two vectors of 32 bf16 lanes at most), and on the card the row count from
# which the chain's products and reductions keep one algorithm whatever the
# batch (with split-K off)
ROW_BLOCK = 64

_FIELDS = ("trees", "iforest", "lstm", "gnn", "bert")
_BRANCH_FIELDS = {"xgboost_primary": "trees", "lstm_sequential": "lstm",
                  "bert_text": "bert", "graph_neural": "gnn",
                  "isolation_forest": "iforest"}


def mesh_positions(n: int, device: Any = "cuda") -> List[str]:
    """``n`` mesh positions: the visible cards cycled (several positions on
    one card each get a stream of their own), or all on the CPU."""
    if torch.device(device).type == "cpu":
        return ["cpu"] * n
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("mesh: no CUDA device available")
    return [f"cuda:{i % cards}" for i in range(n)]


def _move(value: Any, device: torch.device) -> Any:
    """A model field on ``device`` (the same tensors when it is there)."""
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, value)


def _block(leaf: torch.Tensor, spec, m: int, n: int, device: torch.device) -> torch.Tensor:
    """Position ``m``'s block of ``leaf`` under a storage spec: a copy of its
    own (the full tensor is not kept alive by it), or the leaf itself when
    the spec replicates it."""
    if spec == P():
        return leaf.to(device)
    dim = list(spec).index(MODEL_AXIS)
    chunk = leaf.shape[dim] // n
    return leaf.narrow(dim, m * chunk, chunk).to(device).clone()


def _regather_models(stored: Dict[Tuple[int, ...], Any], specs: Any,
                     gather_fields: Tuple[str, ...], d: int, n_model: int,
                     device: torch.device):
    """Data row ``d``'s models with every sharded field rebuilt from the
    blocks of its ``model`` positions: ``torch.cat`` along the split dim in
    axis order, on ``device`` (the calling thread's current stream), exact
    bytes. Unnamed fields are the position's own replicated tensors."""
    base = stored[(d, 0, 0)]
    if not gather_fields:
        return base
    gathered = {}
    for f in gather_fields:
        blocks = [getattr(stored[(d, m, 0)], f) for m in range(n_model)]
        gathered[f] = tree_map(
            lambda spec, *parts: parts[0] if spec == P() else torch.cat(
                [p.to(device) for p in parts], dim=list(spec).index(MODEL_AXIS)),
            getattr(specs, f), *blocks)
    return dataclasses.replace(base, **gathered)


def mesh_score_packed(models: Dict[Tuple[int, ...], Any],
                      blobs: Dict[str, np.ndarray], spec, params,
                      model_valid: np.ndarray, *, scorer, static: Dict[str, Any],
                      device: torch.device, specs: Any = None,
                      gather_fields: Tuple[str, ...] = (), data_row: int = 0,
                      n_model: int = 1, mega_args=None) -> tuple:
    """Score data row ``data_row``'s share of a packed batch (``blobs``, its
    rows only) on ``device``, on the calling thread's current stream there:
    the fields named in ``gather_fields`` rebuilt from the ``model`` blocks
    of ``models`` (a mesh replica's stored models, position -> models, with
    their storage ``specs``), then ``scorer.launch_packed`` with the kernel
    selection ``static``. ``mega_args`` (the megakernel's parameter
    arguments) is built here from the gathered models when the plan admits
    the shard and none is given. Returns (host result, event or None,
    hand-written launches, gathered models, megakernel arguments); the
    caller keeps the last two alive until the event completed."""
    gathered = _regather_models(models, specs, gather_fields, data_row,
                                n_model, device)
    if static["mega_valid"] is not None and mega_args is None:
        mega_args = scorer.mega_param_args_for(gathered, device)
    out, event, launches = scorer.launch_packed(
        blobs, spec, model_valid, static, device, gathered, params, mega_args)
    return out, event, launches, gathered, mega_args


def mesh_entry(donate: bool = False):
    """The mesh scoring entry the executor dispatches through. Donation (an
    XLA buffer-aliasing switch) has no counterpart in the port."""
    if donate:
        raise ValueError("mesh_entry(donate=True): buffer donation is an XLA "
                         "switch with no counterpart in the PyTorch port")
    return mesh_score_packed


def _has_two_hop(spec) -> bool:
    """Whether a packed batch carries the typed graph's two-hop context."""
    return dict(spec.treedef[1]).get("user_neigh2_feat") is not None


class MeshToken:
    """One mesh batch in flight. Field names mirror ``PoolToken`` where the
    scorer reads them (``replica_idx``, ``inflight_at_dispatch``,
    ``params``, ``launches``)."""

    __slots__ = ("parts", "replica_idx", "inflight_at_dispatch", "params",
                 "model_valid", "launched_with", "launches", "mega_shards")

    def __init__(self, replica_idx, inflight_at_dispatch, params, model_valid):
        self.parts: List[tuple] = []         # (host result, event) a data row
        self.replica_idx = replica_idx
        self.inflight_at_dispatch = inflight_at_dispatch
        self.params = params
        self.model_valid = model_valid       # host bool[M] snapshot
        # (stored blocks, gathered models, params, megakernel arguments) a
        # data row, held until the token resolves
        self.launched_with = None
        self.launches = 0                    # hand-written kernel launches
        self.mega_shards = 0                 # data rows the megakernel served


class _MeshReplica:
    """One ``data x model`` mesh: what each position stores, and the
    dispatch bookkeeping."""

    def __init__(self, idx: int, mesh: Mesh):
        self.idx = idx
        self.mesh = mesh
        self.stored: Dict[Tuple[int, ...], Any] = {}
        self.specs = None
        self.mega_args: Dict[Any, Any] = {}
        self.params: Optional[tuple] = None      # (source, {device: moved})
        self.healthy = True
        self.inflight = 0
        self.dispatched = 0
        self.completed = 0
        self.failures = 0
        self.queue_wait_s = 0.0
        self.fail_next = 0
        self.mega_served = 0          # data shards the megakernel scored
        self.mega_declined = 0        # data shards its plan declined


class MeshExecutor:
    """Mesh-sharded microbatch executor behind the pool dispatch seam.

    ``devices`` (every visible card by default; the scorer's own device on
    the CPU; a list may name one card more than once, each position with a
    stream of its own) split into ``replicas`` equal subsets; each becomes a
    ``(data=per/model_axis) x model_axis`` mesh holding one copy of the
    models, placed per branch (``shard_branches`` store split over
    ``model``; the rest replicate). Or ``mesh``, built by the caller: one
    replica with the mesh's axes, of which this process owns its positions
    (``multihost`` when they span processes)."""

    def __init__(self, scorer, devices: Optional[Sequence] = None,
                 model_axis: int = 1, replicas: int = 1,
                 inflight_depth: int = 2,
                 shard_branches: Sequence[str] = ("bert_text",),
                 mesh: Optional[Mesh] = None):
        if mesh is not None:
            if replicas != 1 or devices is not None:
                raise ValueError(
                    "pass either a pre-built mesh= (one spanning replica) "
                    "or devices/replicas, not both")
            devs = [mesh.device(pos) for pos in mesh.local_positions()]
            model_axis = mesh.shape[MODEL_AXIS]
        elif devices is None:
            if scorer.device.type == "cuda":
                devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            else:
                devs = [scorer.device]
        else:
            devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("mesh executor needs at least one device")
        if any(d.type == "cuda" for d in devs):
            batch_invariant_blas()
        if mesh is None:
            replicas = max(1, int(replicas))
            if len(devs) % replicas:
                raise ValueError(f"{len(devs)} devices do not split into {replicas} "
                                 f"equal mesh replicas")
            per = len(devs) // replicas
            model_axis = max(1, int(model_axis))
            if per % model_axis:
                raise ValueError(f"model_axis={model_axis} does not divide the {per} "
                                 f"devices of each mesh replica")
            meshes = [build_mesh(MeshConfig(model=model_axis), devs[i * per:(i + 1) * per])
                      for i in range(replicas)]
        else:
            meshes = [mesh]
        bad = [b for b in shard_branches if b not in SHARDABLE_BRANCHES]
        if bad:
            raise ValueError(
                f"branch(es) {bad} not shardable; expected a subset of "
                f"{sorted(SHARDABLE_BRANCHES)} (trees/iforest/rules are "
                f"replicated by design)")
        self.scorer = scorer
        self.model_axis = model_axis
        self.data_axis = meshes[0].shape[DATA_AXIS]
        # more than one process: this one feeds, scores and returns only the
        # rows of its own data rows
        self.multihost = len({int(r) for r in meshes[0].ranks.flat}) > 1
        # the scorer pads every microbatch to a multiple of this: each data
        # shard a whole number of ROW_BLOCK-row blocks
        self.batch_multiple = self.data_axis * ROW_BLOCK
        self.inflight_depth = max(1, int(inflight_depth))
        self.shard_branches: Tuple[str, ...] = (
            tuple(sorted(shard_branches)) if model_axis > 1 else ())
        self._gather_fields: Tuple[str, ...] = tuple(
            sorted(SHARDABLE_BRANCHES[b] for b in self.shard_branches))
        self._cv = threading.Condition()
        self.replicas: List[_MeshReplica] = [_MeshReplica(i, m)
                                             for i, m in enumerate(meshes)]
        home = scorer.device
        if home.type == "cuda" and home.index is None:
            home = torch.device("cuda", torch.cuda.current_device())
        self._home = home
        self._place(scorer.models)
        self._rr = 0
        self.assignment_log: deque = deque(maxlen=4096)
        scorer.attach_pool(self)

    # ------------------------------------------------------------ placement
    def _place(self, models) -> None:
        """Store ``models`` (on the scorer's device) on every replica per the
        placement, on this process's positions: replicated fields once a
        device, sharded fields one block a (device, model index)."""
        specs = branch_serving_specs(models, self.model_axis, self.shard_branches)
        n = self.model_axis
        for rep in self.replicas:
            shared: Dict[torch.device, Dict[str, Any]] = {}
            # one stored set a (device, model index): positions that hold the
            # same tensors share one object
            objs: Dict[Tuple[torch.device, int], Any] = {}
            stored = {}
            for pos in rep.mesh.local_positions():
                dev, m = rep.mesh.device(pos), pos[1]
                if dev not in shared:
                    shared[dev] = {f: _move(getattr(models, f), dev) for f in _FIELDS
                                   if f not in self._gather_fields}
                if (dev, m) not in objs:
                    objs[(dev, m)] = type(models)(**shared[dev], **{f: tree_map(
                        lambda spec, leaf: _block(leaf, spec, m, n, dev),
                        getattr(specs, f), getattr(models, f))
                        for f in self._gather_fields})
                stored[pos] = objs[(dev, m)]
            with self._cv:
                rep.stored, rep.specs, rep.mega_args = stored, specs, {}

    def _params_on(self, rep: _MeshReplica, params, device: torch.device):
        if device == self._home:
            return params
        cached = rep.params
        if cached is None or cached[0] is not params:
            rep.params = cached = (params, {})
        if device not in cached[1]:
            cached[1][device] = params.to(device)
        return cached[1][device]

    # ------------------------------------------------------------- capacity
    def __len__(self) -> int:
        return len(self.replicas)

    @property
    def healthy_count(self) -> int:
        return sum(1 for r in self.replicas if r.healthy)

    def total_slots(self) -> int:
        return max(1, self.healthy_count * self.inflight_depth)

    # ------------------------------------------------------------- dispatch
    def _pick_replica(self) -> tuple:
        """Strict round-robin over healthy mesh replicas, blocking at depth
        (recorded as queue wait)."""
        with self._cv:
            n = len(self.replicas)
            for off in range(n):
                rep = self.replicas[(self._rr + off) % n]
                if rep.healthy:
                    self._rr = (self._rr + off + 1) % n
                    break
            else:
                raise RuntimeError("mesh executor has no healthy replicas")
            # rtfd-lint: allow[wall-clock] queue-wait diagnostics (host stats), not control flow
            t0 = time.perf_counter()
            while rep.inflight >= self.inflight_depth:
                if not self._cv.wait(timeout=120.0):
                    raise TimeoutError(
                        f"mesh replica {rep.idx} stuck at inflight depth "
                        f"{rep.inflight} for 120s")
                if not rep.healthy:
                    return self._pick_replica()
            # rtfd-lint: allow[wall-clock] queue-wait diagnostics (host stats), not control flow
            rep.queue_wait_s += time.perf_counter() - t0
            rep.inflight += 1
            rep.dispatched += 1
            self.assignment_log.append(rep.idx)
            return rep, rep.inflight

    def dispatch_packed(self, blobs: Dict[str, np.ndarray], spec, params,
                        model_valid: np.ndarray,
                        static: Optional[Dict[str, Any]] = None) -> MeshToken:
        """Split one packed microbatch over the next replica's data rows and
        launch each row's share on its position's stream, without waiting.
        On a multi-process mesh ``blobs`` is the global batch every process
        holds, and only this process's data rows are launched. ``static``
        (the whole batch's kernel selection) is not used: each shard takes
        the plan for its own size."""
        rep, depth = self._pick_replica()
        # rtfd-lint: allow[d2h] host bool[M] validity mask, never a device array
        token = MeshToken(rep.idx, depth, params, np.array(model_valid, bool))
        try:
            self._launch(rep, token, {k: v for k, v in blobs.items() if v is not None},
                         spec)
        except Exception:
            self._mark_failed(rep)
            raise
        return token

    def _launch(self, rep: _MeshReplica, token: MeshToken,
                blobs: Dict[str, np.ndarray], spec) -> None:
        with self._cv:
            stored, specs = rep.stored, rep.specs     # a hot swap never tears it
        n = next(iter(blobs.values())).shape[0]
        if n % self.batch_multiple:
            raise ValueError(f"a {n}-row batch does not split over the data axis "
                             f"{self.data_axis} in {ROW_BLOCK}-row blocks (pad to "
                             f"batch_multiple)")
        per = n // self.data_axis
        mv = token.model_valid
        two_hop = _has_two_hop(spec)
        kept = []
        data_rows = rep.mesh.local_data_rows()
        for d in data_rows:
            lead = (d, 0, 0)
            dev, stream = rep.mesh.device(lead), rep.mesh.stream(lead)
            rows = {k: v[d * per:(d + 1) * per] for k, v in blobs.items()}
            static = self.scorer.kernel_static(per, mv, has_two_hop=two_hop)
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(dev))
                ctx = torch.cuda.stream(stream)
            else:
                ctx = contextlib.nullcontext()
            with ctx:
                params = self._params_on(rep, token.params, dev)
                mega_args = None
                if static["mega_valid"] is not None and not self._gather_fields:
                    # the position's own models: their arguments are cached
                    with self._cv:
                        mega_args = rep.mega_args.get(dev)
                        if mega_args is None:
                            mega_args = rep.mega_args[dev] = \
                                self.scorer.mega_param_args_for(stored[lead], dev)
                out, event, launches, models, mega_args = mesh_score_packed(
                    stored, rows, spec, params, mv, scorer=self.scorer,
                    static=static, device=dev, specs=specs,
                    gather_fields=self._gather_fields, data_row=d,
                    n_model=self.model_axis, mega_args=mega_args)
            token.parts.append((out, event))
            token.launches += launches
            token.mega_shards += int(static["mega_valid"] is not None)
            kept.append((stored, models, params, mega_args))
        token.launched_with = kept
        with self._cv:
            rep.mega_served += token.mega_shards
            rep.mega_declined += len(data_rows) - token.mega_shards

    # ------------------------------------------------------------ completion
    def _mark_failed(self, rep: _MeshReplica) -> None:
        with self._cv:
            rep.failures += 1
            rep.healthy = False
            rep.inflight = max(0, rep.inflight - 1)
            self._cv.notify_all()

    def _release(self, rep: _MeshReplica) -> None:
        with self._cv:
            rep.inflight = max(0, rep.inflight - 1)
            rep.completed += 1
            self._cv.notify_all()

    def wait(self, token: MeshToken) -> torch.Tensor:
        """Block on a mesh batch's host result (its data rows joined in row
        order: on a multi-process mesh this process's rows). A failure marks
        the replica unhealthy, releases its slot and raises: a sharded batch
        has no single-position rescue copy."""
        rep = self.replicas[token.replica_idx]
        try:
            with self._cv:
                if rep.fail_next > 0:
                    rep.fail_next -= 1
                    raise RuntimeError(f"injected device fault on mesh replica {rep.idx}")
            for _, event in token.parts:
                sync.device_wait(event)
            out = torch.cat([o for o, _ in token.parts], dim=0)
        except Exception:
            self._mark_failed(rep)
            raise
        token.launched_with = None
        self._release(rep)
        return out

    # -------------------------------------------------------------- control
    def set_models(self, models) -> None:
        """Re-place a model swap replica by replica under the same placement
        on this process's positions (``models`` on the scorer's device;
        callers hold the score lock). A batch in flight keeps what it
        launched with."""
        self._place(models)

    def inject_fault(self, replica_idx: int, n: int = 1) -> None:
        """Make the next ``n`` result fetches on a replica raise."""
        with self._cv:
            self.replicas[replica_idx].fail_next += n

    # ---------------------------------------------------------------- stats
    def param_bytes(self) -> Dict[str, Dict[str, int]]:
        """Per-branch parameter bytes on mesh replica 0: the most any one of
        this process's positions stores (``per_chip``, the JAX key; its
        replicated tensors and its blocks) against the replicated equivalent
        (the full branch, what a pool replica holds), read from the stored
        tensors."""
        rep = self.replicas[0]
        with self._cv:
            stored = dict(rep.stored)
        models = self.scorer.models
        out: Dict[str, Dict[str, int]] = {}
        for branch, field in _BRANCH_FIELDS.items():
            per_pos = [sum(int(t.nbytes) for t in tree_leaves(getattr(m, field))
                           if isinstance(t, torch.Tensor))
                       for m in stored.values()]
            # rtfd-lint: allow[d2h] byte count of a host (non-tensor) leaf for the storage report, read outside the dispatch path
            full = sum(int(np.asarray(t).nbytes if not isinstance(t, torch.Tensor)
                           else t.nbytes) for t in tree_leaves(getattr(models, field)))
            out[branch] = {"per_chip": max(per_pos) if per_pos else 0,
                           "replicated": full}
        return out

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            per_replica = [{
                "index": rep.idx,
                "healthy": rep.healthy,
                "dispatched": rep.dispatched,
                "completed": rep.completed,
                "inflight": rep.inflight,
                "failures": rep.failures,
                "queue_wait_ms": round(rep.queue_wait_s * 1e3, 3),
                "devices": rep.mesh.size,
                "mega_shards_served": rep.mega_served,
                "mega_shards_declined": rep.mega_declined,
            } for rep in self.replicas]
        return {
            "kind": "mesh",
            "replicas": per_replica,
            "n_replicas": len(per_replica),
            "healthy": sum(1 for r in per_replica if r["healthy"]),
            "inflight_depth": self.inflight_depth,
            "data_axis": self.data_axis,
            "model_axis": self.model_axis,
            "dispatched": sum(r["dispatched"] for r in per_replica),
            "completed": sum(r["completed"] for r in per_replica),
        }

    def mesh_snapshot(self) -> Dict[str, Any]:
        """Payload for ``obs.metrics.sync_mesh``: the geometry, the
        per-branch placement, per-position against replicated parameter
        bytes, and the cumulative dispatch counters."""
        pb = self.param_bytes()
        st = self.stats()
        return {
            "data_axis": self.data_axis,
            "model_axis": self.model_axis,
            "replicas": len(self.replicas),
            "placement": {name: ("sharded" if name in self.shard_branches
                                 else "replicated") for name in MODEL_NAMES},
            "param_bytes": pb,
            "dispatched": {str(r["index"]): r["dispatched"] for r in st["replicas"]},
            "completed": {str(r["index"]): r["completed"] for r in st["replicas"]},
            "healthy": st["healthy"],
        }
