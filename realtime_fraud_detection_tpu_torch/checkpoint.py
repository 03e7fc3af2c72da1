"""Checkpoint and restore of the port's scorer: parameters, host state, offsets.

Port of the JAX package's ``checkpoint.py``. Layout:

    <dir>/step_<N>/{params.pt, host_state.pkl, manifest.json}

- parameters (a ``ScoringModels``) as a nested dict of CPU tensors written
  by ``torch.save`` and read back with ``torch.load(weights_only=True)``;
- host state (the scorer's velocity windows, history rings, entity graph
  and indexes, profiles, transaction cache) pickled;
- offsets and caller metadata in the JSON manifest, written last, so a
  directory without one is a torn save that ``steps()`` ignores.

Keep-N retention, ``latest_step`` and partial restore (a params-only
checkpoint gives ``host_state=None``) are the JAX manager's. The manifest
carries the JAX manager's stamps under the same keys: ``model_shapes``,
``quant_mode`` (the BERT weight form) and ``graph_mode`` (typed or
bipartite GNN); ``restore_into_scorer`` refuses a restore that crosses the
scorer's widths, quantization mode or graph mode with the JAX manager's
``ValueError`` text unless ``allow_arch_mismatch``, and re-attaches the
trainer's feature importances to the scorer's explanations: from the host
state when the checkpoint has one, else from the manifest's
``feature_importances`` (a ``train`` checkpoint), leniently, with a
warning when they do not fit the feature contract. The JAX package writes
its parameters with orbax, which cannot be read without JAX: a port
checkpoint and a JAX checkpoint are not interchangeable.

A scorer on the shared RESP tier keeps its profiles, velocity and
transaction cache on the state server (persisted by the server's own
append-only file), and those stores hold the client's socket:
``snapshot_scorer_host_state`` refuses such a scorer with a ``ValueError``
(the JAX snapshot fails on it with pickle's ``TypeError``), and
``restore_scorer_host_state`` leaves its shared stores in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import pickle
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.features.schema import EntityRowCache
from realtime_fraud_detection_tpu_torch.models.gnn import is_typed_gnn
from realtime_fraud_detection_tpu_torch.models.quant import is_quantized_bert
from realtime_fraud_detection_tpu_torch.state.shared import SharedVelocityStore

__all__ = [
    "Checkpoint",
    "CheckpointManager",
    "snapshot_scorer_host_state",
    "restore_scorer_host_state",
]

_MANIFEST = "manifest.json"
_HOST_STATE = "host_state.pkl"
_PARAMS = "params.pt"


def _cpu_tree(obj: Any) -> Any:
    """Nested dicts / lists of tensors or numpy arrays (host-quantized BERT
    leaves) -> the same structure of CPU tensors."""
    if isinstance(obj, dict):
        return {k: _cpu_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_cpu_tree(v) for v in obj]
    if not isinstance(obj, torch.Tensor):
        obj = torch.from_numpy(np.ascontiguousarray(obj))
    return obj.detach().to("cpu").contiguous()


def _models_state(models: Any) -> Dict[str, Any]:
    """A ``ScoringModels`` as a nested dict of CPU tensors (what
    ``torch.load(weights_only=True)`` reads back)."""
    return _cpu_tree({
        "trees": {f.name: getattr(models.trees, f.name)
                  for f in dataclasses.fields(models.trees)},
        "iforest": {f.name: getattr(models.iforest, f.name)
                    for f in dataclasses.fields(models.iforest)},
        "lstm": models.lstm, "gnn": models.gnn, "bert": models.bert,
    })


def _derive_model_shapes(params: Any) -> Optional[Dict[str, Any]]:
    """The restore shapes of a ``ScoringModels`` (the JAX manager's
    ``_derive_model_shapes``, same keys and values)."""
    try:
        lstm_hidden = int(params.lstm["b_gates"].shape[0]) // 4
        word_emb = params.bert["word_emb"]
        if isinstance(word_emb, dict):
            word_emb = word_emb["qe"]
        return {
            "trees": [int(params.trees.feature.shape[0]),
                      int(params.trees.leaf.shape[1]).bit_length() - 1],
            "iforest": [int(params.iforest.feature.shape[0]),
                        int(params.iforest.path_length.shape[1]).bit_length() - 1],
            "bert_hidden": int(word_emb.shape[1]),
            "bert_layers": len(params.bert["layers"]),
            "feature_dim": int(params.lstm["w_gates"].shape[0]) - lstm_hidden,
            "node_dim": int(params.gnn["w_sage1"].shape[0]) // 2,
        }
    except (KeyError, TypeError, IndexError, AttributeError):
        return None


def _derive_quant_mode(params: Any) -> Optional[Dict[str, str]]:
    """The BERT weight form (a parameter property; the tree kernels are
    program selections, not checkpoint state)."""
    if not hasattr(params, "bert"):
        return None
    return {"bert_weights": "int8" if is_quantized_bert(params.bert) else "f32"}


def _derive_graph_mode(params: Any) -> Optional[Dict[str, str]]:
    """The GNN's layout: ``typed`` (per-node-type projections) or
    ``bipartite``."""
    if not hasattr(params, "gnn"):
        return None
    return {"gnn_nodes": "typed" if is_typed_gnn(params.gnn) else "bipartite"}


@dataclasses.dataclass
class Checkpoint:
    step: int
    params: Any = None
    host_state: Any = None
    offsets: Optional[Dict[str, Any]] = None
    metadata: Optional[Dict[str, Any]] = None


class CheckpointManager:
    """Save, restore and retain checkpoints under one directory."""

    def __init__(self, directory: str | Path, keep: int = 3):
        # created by save() only: a restore-only caller (/reload-models with
        # a user-supplied path) must not create directories
        self.directory = Path(directory)
        self.keep = keep

    def _step_dir(self, step: int) -> Path:
        return self.directory / f"step_{step:010d}"

    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.directory.glob("step_*")
                      if (p / _MANIFEST).exists())     # torn saves don't count

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _resolve(self, step: Optional[int]) -> int:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return step

    # ----------------------------------------------------------------- save
    def save(self, step: int, params: Any = None, host_state: Any = None,
             offsets: Optional[Mapping[str, Any]] = None,
             metadata: Optional[Mapping[str, Any]] = None) -> Path:
        """Write one checkpoint, the manifest last (a save cut short leaves
        no manifest; the next save of the step overwrites it)."""
        d = self._step_dir(step)
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        if params is not None:
            torch.save(_models_state(params), d / _PARAMS)
        if host_state is not None:
            with open(d / _HOST_STATE, "wb") as f:
                pickle.dump(host_state, f, protocol=pickle.HIGHEST_PROTOCOL)
        # the stamps are derived fields kept out of the caller's metadata, so
        # metadata round-trips verbatim (a caller's own stamp there wins)
        meta = dict(metadata) if metadata is not None else {}
        stamps = {}
        for key, derive in (("model_shapes", _derive_model_shapes),
                            ("quant_mode", _derive_quant_mode),
                            ("graph_mode", _derive_graph_mode)):
            stamps[key] = meta.get(key)
            if params is not None and stamps[key] is None:
                stamps[key] = derive(params)
        manifest = {
            "step": step,
            "wall_time": time.time(),
            "has_params": params is not None,
            "has_host_state": host_state is not None,
            "offsets": dict(offsets) if offsets is not None else None,
            "metadata": meta or None,
            **stamps,
        }
        with open(d / _MANIFEST, "w") as f:
            json.dump(manifest, f, indent=1)
        self._retain()
        return d

    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -------------------------------------------------------------- restore
    def manifest(self, step: Optional[int] = None) -> Dict[str, Any]:
        """A checkpoint's manifest, without reading its parameters."""
        with open(self._step_dir(self._resolve(step)) / _MANIFEST) as f:
            return json.load(f)

    def check_model_shapes(self, step: Optional[int] = None, bert_config=None,
                           feature_dim: int = 64, node_dim: int = 16) -> None:
        """Raise when the manifest's recorded widths differ from the
        server's (the JAX manager's ``scoring_models_template`` check)."""
        manifest = self.manifest(step)
        meta = manifest.get("metadata") or {}
        shapes = manifest.get("model_shapes") or meta.get("model_shapes") or {}
        want = {
            "bert_hidden": None if bert_config is None else bert_config.hidden_size,
            "bert_layers": None if bert_config is None else bert_config.num_layers,
            "feature_dim": feature_dim,
            "node_dim": node_dim,
        }
        for key, expected in want.items():
            recorded = shapes.get(key)
            if (recorded is not None and expected is not None
                    and int(recorded) != int(expected)):
                raise ValueError(
                    f"checkpoint {key}={recorded} does not match the "
                    f"server's {key}={expected}; restore with a matching "
                    f"config")

    def restore(self, step: Optional[int] = None) -> Checkpoint:
        """Load a checkpoint (the latest when ``step`` is None); parameters
        come back as a ``ScoringModels`` of CPU tensors."""
        step = self._resolve(step)
        d = self._step_dir(step)
        with open(d / _MANIFEST) as f:
            manifest = json.load(f)
        params = None
        if manifest["has_params"]:
            state = torch.load(d / _PARAMS, map_location="cpu", weights_only=True)
            params = models_from_numpy(state)
        host_state = None
        if manifest["has_host_state"]:
            # this manager's own pickle, written by save()
            with open(d / _HOST_STATE, "rb") as f:
                host_state = pickle.load(f)
        return Checkpoint(step=manifest["step"], params=params,
                          host_state=host_state, offsets=manifest.get("offsets"),
                          metadata=manifest.get("metadata"))

    def restore_into_scorer(self, scorer, step: Optional[int] = None, lock=None,
                            allow_arch_mismatch: bool = False) -> Checkpoint:
        """Restore parameters and host state into a ``TorchFraudScorer``
        (``serve --checkpoint-dir`` and ``/reload-models``). The step is
        resolved once; ``lock`` (the serving score lock) makes the swap
        atomic with respect to dispatches. A checkpoint whose recorded BERT
        weight form or GNN layout crosses the scorer's configuration is
        refused unless ``allow_arch_mismatch`` (then the scorer serves the
        checkpoint's form: ``set_models`` quantizes an f32 restore into an
        int8 scorer, an int8 restore into an f32 scorer serves int8). Old
        checkpoints without the stamps restore leniently. A scorer with a
        device pool or a mesh executor attached gets the restored models
        placed through it (``set_models`` fans them out: a mesh re-splits
        its sharded branches under the same placement)."""
        step = self._resolve(step)
        manifest = self.manifest(step)
        ck_mode = (manifest.get("quant_mode") or {}).get("bert_weights")
        want_mode = scorer.quant.bert_mode()
        if ck_mode is not None and ck_mode != want_mode and not allow_arch_mismatch:
            raise ValueError(
                f"quantization-mode mismatch: checkpoint step {step} "
                f"records bert_weights={ck_mode!r} but the scorer is "
                f"configured for {want_mode!r}; restore with a matching "
                f"quant config or pass allow_arch_mismatch to serve the "
                f"checkpoint's form anyway")
        ck_graph = (manifest.get("graph_mode") or {}).get("gnn_nodes")
        want_graph = scorer.sc.graph_mode
        if ck_graph is not None and ck_graph != want_graph and not allow_arch_mismatch:
            raise ValueError(
                f"graph-mode mismatch: checkpoint step {step} records "
                f"gnn_nodes={ck_graph!r} but the scorer assembles "
                f"{want_graph!r} neighbor tensors; restore with a "
                f"matching graph_mode or pass allow_arch_mismatch "
                f"(stampless legacy checkpoints restore leniently)")
        self.check_model_shapes(step, bert_config=scorer.bert_config,
                                feature_dim=scorer.sc.feature_dim,
                                node_dim=scorer.sc.node_dim)
        ck = self.restore(step=step)
        with (lock if lock is not None else contextlib.nullcontext()):
            if ck.params is not None:
                scorer.set_models(ck.params)
            if ck.host_state is not None:
                restore_scorer_host_state(scorer, ck.host_state)
            # re-attach the trainer's gain importances (set_models cleared
            # them): a host-state snapshot carries them, a params-only
            # ``train`` checkpoint records them in its manifest
            imp = (ck.metadata or {}).get("feature_importances")
            if imp is not None and scorer._top_importances is None:
                try:
                    scorer.set_feature_importances(imp)
                except (ValueError, TypeError) as e:
                    # lenient (an old or foreign manifest) but never silent
                    logging.getLogger(__name__).warning(
                        "checkpoint step %s: feature_importances in "
                        "manifest not attachable (%s); explanations will "
                        "omit top_feature_importances", step, e)
        return ck


# --------------------------------------------------------------------------
# the scorer's host state (the reference's Redis / RocksDB state)
# --------------------------------------------------------------------------

SHARED_TIER_REFUSAL = (
    "the scorer's profiles, velocity and transaction cache live on the shared "
    "state server (persisted by its --aof); a scorer checkpoint cannot hold them")


def _on_shared_tier(scorer) -> bool:
    """Whether the scorer's stores are the shared RESP tier's."""
    return isinstance(scorer.velocity, SharedVelocityStore)


def snapshot_scorer_host_state(scorer) -> Dict[str, Any]:
    """A picklable snapshot of a ``TorchFraudScorer``'s streaming state;
    refused (``ValueError``) for a scorer on the shared tier."""
    if _on_shared_tier(scorer):
        raise ValueError(SHARED_TIER_REFUSAL)
    return {
        "profiles": scorer.profiles,
        "velocity": scorer.velocity,
        "history": scorer.history,
        "graph": scorer.graph,
        "txn_cache": scorer.txn_cache,
        "users_index": scorer._users,
        "merchants_index": scorer._merchants,
        "typed_graph": scorer.typed_graph,
        "stats": dict(scorer.stats),
        "top_importances": scorer._top_importances,
    }


def restore_scorer_host_state(scorer, state: Mapping[str, Any]) -> None:
    if not _on_shared_tier(scorer):
        # a shared-tier scorer keeps reading the server's stores
        scorer.profiles = state["profiles"]
        scorer.velocity = state["velocity"]
        scorer.txn_cache = state["txn_cache"]
    scorer.history = state["history"]
    scorer.graph = state["graph"]
    scorer._users = state["users_index"]
    scorer._merchants = state["merchants_index"]
    # the join cache is stamped with the old profile store's generation,
    # which the restored store may repeat
    scorer._join_cache = EntityRowCache()
    typed = state.get("typed_graph")
    if typed is not None and scorer.typed_graph is not None:
        # the sampler reads the scorer's store by reference: point it at the
        # restored one and drop every cached neighbourhood
        scorer.typed_graph = typed
        scorer._sampler.graph = typed
        scorer._sampler._cache.clear()
        scorer._sampler._deps.clear()
    scorer.stats.update(state["stats"])
    if state.get("top_importances") is not None:
        scorer._top_importances = dict(state["top_importances"])
