"""Named-axis collectives and ``shard_map_over``: SPMD over a port mesh.

Port of the JAX package's ``parallel/collectives.py``. JAX writes a
per-device body and runs it under ``shard_map``, with XLA collectives over
the mesh axes inside. The port keeps that form: ``shard_map_over(mesh, fn,
in_specs, out_specs)`` splits the inputs by their specs, runs ``fn`` once
per position on a thread of its own (on that position's device and, on a
card, its own CUDA stream), and stitches the outputs by ``out_specs``. The
collectives below meet the other positions at a barrier and exchange
values through shared slots; every reduction adds in axis order, so each
position computes the same bits and every run repeats them.

Values handed to another position are read on its stream after an event
the producer recorded, and kept alive for that stream
(``Tensor.record_stream``). Autograd follows the values across threads:
``torch.autograd`` differentiates through a body that was run this way, so
gradients flow through ``ppermute`` and ``all_to_all`` as through any other
op.

These functions are valid only inside ``shard_map_over``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    Mesh,
    P,
    PartitionSpec,
    block_slices,
    tree_leaves,
    tree_map,
)

__all__ = [
    "all_gather", "all_gather_seq", "all_to_all", "axis_index", "axis_size",
    "identity_spec", "pmean", "pmean_data", "ppermute", "ppermute_seq", "psum",
    "psum_data", "psum_model", "psum_scatter", "reduce_scatter_data",
    "seq_index", "seq_size", "shard_map_over",
]

BARRIER_TIMEOUT_S = 600.0

_ctx = threading.local()


class _Rendezvous:
    """The positions of one ``shard_map_over`` call: a barrier and one slot
    a position."""

    def __init__(self, mesh: Mesh, positions: List[Tuple[int, ...]]):
        self.mesh = mesh
        self.flat = {idx: k for k, idx in enumerate(positions)}
        self.barrier = threading.Barrier(len(positions))
        self.slots: List[Any] = [None] * len(positions)

    def exchange(self, idx: Tuple[int, ...], value: Any) -> Dict[Tuple[int, ...], Any]:
        """Post ``value`` (with an event on the poster's stream) and return
        every position's post."""
        event = None
        dev = self.mesh.device(idx)
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        self.slots[self.flat[idx]] = (value, event, dev)
        self.barrier.wait(BARRIER_TIMEOUT_S)
        snap = {pos: self.slots[k] for pos, k in self.flat.items()}
        self.barrier.wait(BARRIER_TIMEOUT_S)
        return snap


def _here() -> Tuple[Mesh, Tuple[int, ...], _Rendezvous]:
    try:
        return _ctx.mesh, _ctx.idx, _ctx.rdv
    except AttributeError:
        raise RuntimeError("collectives are valid only inside shard_map_over") from None


def _receive(post, my_dev: torch.device) -> Any:
    """A posted value, readable on this position's stream."""
    value, event, dev = post
    if event is not None and my_dev.type == "cuda":
        stream = torch.cuda.current_stream(my_dev)
        stream.wait_event(event)

        def keep(t):
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                t.record_stream(stream)
            return t
        tree_map(keep, value)
    return tree_map(lambda t: t.to(my_dev) if isinstance(t, torch.Tensor) else t, value)


def _gather_axis(x: Any, axis: str) -> List[Any]:
    """This position's group along ``axis``: every member's ``x``, in axis
    order, readable here."""
    mesh, idx, rdv = _here()
    snap = rdv.exchange(idx, x)
    my_dev = mesh.device(idx)
    return [_receive(snap[pos], my_dev) for pos in mesh.group(idx, axis)]


def _sum(values: List[Any]) -> Any:
    def add(*leaves):
        total = leaves[0]
        for v in leaves[1:]:
            total = total | v if total.dtype == torch.bool else total + v
        return total
    return tree_map(add, values[0], *values[1:])


def axis_index(axis: str) -> int:
    mesh, idx, _ = _here()
    return idx[mesh.axis(axis)]


def axis_size(axis: str) -> int:
    mesh, _, _ = _here()
    return mesh.shape[axis]


def psum(x: Any, axis: str) -> Any:
    """All-reduce by sum over ``axis``, added in axis order."""
    return _sum(_gather_axis(x, axis))


def pmean(x: Any, axis: str) -> Any:
    n = axis_size(axis)
    return tree_map(lambda t: t / n, psum(x, axis))


def all_gather(x: torch.Tensor, axis: str, dim: int = 0, tiled: bool = True) -> torch.Tensor:
    parts = _gather_axis(x, axis)
    return torch.cat(parts, dim=dim) if tiled else torch.stack(parts, dim=dim)


def ppermute(x: Any, axis: str, perm: Sequence[Tuple[int, int]]) -> Any:
    """Send to ``dst`` what ``src`` holds, for each ``(src, dst)`` pair; a
    position no pair sends to receives zeros."""
    parts = _gather_axis(x, axis)
    me = axis_index(axis)
    for src, dst in perm:
        if dst == me:
            return parts[src]
    return tree_map(torch.zeros_like, x)


def psum_scatter(x: torch.Tensor, axis: str, dim: int = 0, tiled: bool = True) -> torch.Tensor:
    total = psum(x, axis)
    n, k = axis_size(axis), axis_index(axis)
    chunk = total.shape[dim] // n
    out = total.narrow(dim, k * chunk, chunk)
    return out if tiled else out.squeeze(dim)


def all_to_all(x: torch.Tensor, axis: str, split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = False) -> torch.Tensor:
    """Chunk ``k`` of ``x`` along ``split_axis`` goes to member ``k``; the
    chunks received are joined along ``concat_axis`` in sender order
    (``tiled=False``: ``x`` has the axis size along ``split_axis`` and the
    result along ``concat_axis``)."""
    parts = _gather_axis(x, axis)
    me = axis_index(axis)
    n = len(parts)
    if tiled:
        chunks = [p.chunk(n, dim=split_axis)[me] for p in parts]
        return torch.cat(chunks, dim=concat_axis)
    chunks = [p.select(split_axis, me) for p in parts]
    return torch.stack(chunks, dim=concat_axis)


def psum_data(x):
    """All-reduce over the data axis (gradient sync; the allreduce of DP)."""
    return psum(x, DATA_AXIS)


def pmean_data(x):
    return pmean(x, DATA_AXIS)


def psum_model(x):
    """All-reduce over the tensor-parallel axis (Megatron row-parallel sums)."""
    return psum(x, MODEL_AXIS)


def all_gather_seq(x, axis: int = 0):
    """Gather sequence shards (context-parallel rendezvous)."""
    return all_gather(x, SEQ_AXIS, dim=axis, tiled=True)


def ppermute_seq(x, shift: int = 1):
    """Ring shift over the seq axis (ring attention's KV rotation)."""
    n = axis_size(SEQ_AXIS)
    return ppermute(x, SEQ_AXIS, [(i, (i + shift) % n) for i in range(n)])


def reduce_scatter_data(x, axis: int = 0):
    """Reduce-scatter over data (ZeRO-style sharded gradient reduction)."""
    return psum_scatter(x, DATA_AXIS, dim=axis, tiled=True)


def seq_index() -> int:
    return axis_index(SEQ_AXIS)


def seq_size() -> int:
    return axis_size(SEQ_AXIS)


def identity_spec() -> PartitionSpec:
    return P()


# ----------------------------------------------------------------- shard_map
def _specs_for(spec: Any, arg: Any) -> Any:
    """A spec tree shaped like ``arg``: one ``PartitionSpec`` applies to
    every leaf under it."""
    if isinstance(spec, PartitionSpec):
        return tree_map(lambda _: spec, arg)
    return spec


def _split(x: Any, spec: PartitionSpec, mesh: Mesh, idx: Tuple[int, ...]) -> Any:
    if x is None or isinstance(x, (int, float, bool, str)):
        return x
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t[block_slices(t.shape, spec, mesh, idx)].to(mesh.device(idx))


def _stitch(values: Dict[Tuple[int, ...], torch.Tensor], spec: PartitionSpec,
            mesh: Mesh, device: torch.device) -> torch.Tensor:
    """The global output from each position's block: blocks along a split
    dimension are joined in axis order; an axis the spec does not name is
    replicated, and its position 0 is read."""
    mapped = [(mesh.axis(name), dim) for dim, name in enumerate(spec) if name is not None]
    kept = {a for a, _ in mapped}
    cur = {idx: v.to(device) for idx, v in values.items()
           if all(idx[a] == 0 for a in range(len(idx)) if a not in kept)}
    for a, dim in mapped:
        groups: Dict[Tuple[int, ...], List[Tuple[int, torch.Tensor]]] = {}
        for idx, v in cur.items():
            groups.setdefault(idx[:a] + (0,) + idx[a + 1:], []).append((idx[a], v))
        cur = {key: torch.cat([v for _, v in sorted(lst, key=lambda kv: kv[0])], dim=dim)
               for key, lst in groups.items()}
    (out,) = cur.values()
    return out


def shard_map_over(mesh: Mesh, fn: Callable, in_specs: Any, out_specs: Any) -> Callable:
    """``fn`` run once per position of ``mesh`` on its block of every input
    (``in_specs``: a spec per argument, or a spec tree shaped like it), the
    outputs stitched per ``out_specs`` onto the first position's device."""
    def run(*args):
        positions = mesh.local_positions()
        if len(positions) != mesh.size:
            raise ValueError("shard_map_over runs over a mesh this process owns whole")
        specs = tuple(_specs_for(s, a) for s, a in zip(in_specs, args))
        local = {idx: tuple(tree_map(lambda x, s: _split(x, s, mesh, idx), a, s,
                                     is_leaf=lambda v: v is None)
                            for a, s in zip(args, specs))
                 for idx in positions}
        rdv = _Rendezvous(mesh, positions)
        results: Dict[Tuple[int, ...], Any] = {}
        errors: List[BaseException] = []
        caller = {d: torch.cuda.current_stream(d)
                  for d in {mesh.device(i) for i in positions} if d.type == "cuda"}

        def body(idx):
            _ctx.mesh, _ctx.idx, _ctx.rdv = mesh, idx, rdv
            stream = mesh.stream(idx)
            try:
                if stream is not None:
                    stream.wait_stream(caller[mesh.device(idx)])
                    with torch.cuda.stream(stream):
                        results[idx] = fn(*local[idx])
                else:
                    results[idx] = fn(*local[idx])
            except BaseException as exc:          # noqa: BLE001 - re-raised below
                errors.append(exc)
                rdv.barrier.abort()
            finally:
                del _ctx.mesh, _ctx.idx, _ctx.rdv

        threads = [threading.Thread(target=body, args=(idx,), daemon=True,
                                    name=f"spmd-{'-'.join(map(str, idx))}")
                   for idx in positions]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            real = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
            raise (real or errors)[0]
        for idx in positions:
            stream = mesh.stream(idx)
            if stream is not None:
                caller[mesh.device(idx)].wait_stream(stream)
        home = mesh.device(positions[0])
        first = results[positions[0]]
        out_tree = _specs_for(out_specs, first)
        leaves_by_pos = {idx: tree_leaves(results[idx], is_leaf=lambda v: v is None)
                         for idx in positions}
        spec_leaves = tree_leaves(out_tree)
        stitched = [_stitch({idx: leaves_by_pos[idx][k] for idx in positions}, spec, mesh, home)
                    for k, spec in enumerate(spec_leaves)]
        it = iter(stitched)
        return tree_map(lambda _: next(it), first, is_leaf=lambda v: v is None)

    return run
