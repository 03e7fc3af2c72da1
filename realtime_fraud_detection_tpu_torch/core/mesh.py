"""Device mesh construction and batch sharding helpers.

Port of the JAX package's ``core/mesh.py``. A mesh is a small class: a numpy
object array of ``torch.device``s shaped ``(data, model, seq)`` plus the axis
names, and for every position on a card a ``torch.cuda.Stream`` of its own.
The axes are the JAX package's:

- ``data``  - the batch dimension (the Flink-parallelism analog);
- ``model`` - the tensor-parallel axis (the BERT encoder, the serving
  executor's storage sharding);
- ``seq``   - the sequence / context-parallel axis (ring attention).

A device may appear more than once, as in ``scoring/device_pool.py``: N
positions on one card each launch on their own stream, so ``["cuda:0"] * 8``
is an 8-position mesh on one H100 and ``["cpu"] * 8`` the mesh the tests run
on. ``build_mesh`` with no devices takes every visible card and refuses to
run without one.

Where JAX hands out sharded arrays, the port hands out ``ShardedTensor``: the
global shape, the ``PartitionSpec`` and one tensor a position (positions on
one device share the tensor of a replicated block). ``device_put``,
``shard_batch`` and ``make_global_batch`` build them; ``gather`` stitches
one back.

Multi-process: ``init_distributed`` joins ``torch.distributed`` with the
``gloo`` backend at ``tcp://<coordinator_address>`` (nothing on the machine
names a cluster, so the caller passes the address, the world size and the
rank). ``gloo`` also on the card: two ranks on one H100 cannot share an
NCCL communicator (NCCL refuses a duplicate GPU), so cross-process tensors
go through host memory. ``build_multihost_mesh`` lays the global mesh out
process-major along ``data`` (every ``model`` x ``seq`` tile inside one
process) and refuses a ``model * seq`` that does not divide the
per-process position count, as JAX does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
AXIS_NAMES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)

__all__ = [
    "AXIS_NAMES", "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "Mesh", "MeshConfig",
    "NamedSharding", "P", "PartitionSpec", "ShardedTensor", "batch_sharding",
    "build_mesh", "build_multihost_mesh", "device_put", "init_distributed",
    "local_mesh_size", "make_global_batch", "pad_batch_to_mesh",
    "replicated_sharding", "shard_batch", "tree_leaves", "tree_map",
]


# ------------------------------------------------------------------ pytrees
def _is_node(x: Any) -> bool:
    return isinstance(x, (dict, list, tuple)) and not isinstance(x, PartitionSpec) \
        or (dataclasses.is_dataclass(x) and not isinstance(x, type))


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of nested dicts, lists, tuples and dataclasses
    (None is a leaf); ``rest`` are trees of the same structure whose leaves
    are passed alongside (a ``PartitionSpec`` is always a leaf)."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return dataclasses.replace(tree, **{
        f.name: tree_map(fn, getattr(tree, f.name),
                         *(getattr(r, f.name) for r in rest), is_leaf=is_leaf)
        for f in dataclasses.fields(tree)})


def tree_leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
                ) -> List[Any]:
    out: List[Any] = []
    tree_map(lambda x: out.append(x), tree, is_leaf=is_leaf)
    return out


# --------------------------------------------------------------- the specs
class PartitionSpec(tuple):
    """Which mesh axis splits each dimension (None: not split). Trailing
    Nones are insignificant: ``P() == P(None, None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def normalized(self) -> Tuple:
        parts = list(self)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self.normalized() == other.normalized()
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self) -> int:
        return hash(self.normalized())

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. ``data=None`` means "all remaining positions"."""

    data: int | None = None
    model: int = 1
    seq: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        ms = self.model * self.seq
        if n_devices % ms != 0:
            raise ValueError(
                f"model*seq={ms} does not divide device count {n_devices}")
        data = self.data if self.data is not None else n_devices // ms
        if data * ms != n_devices:
            raise ValueError(
                f"mesh {data}x{self.model}x{self.seq} != {n_devices} devices")
        return (data, self.model, self.seq)


def _resolve_device(d: Any) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("mesh: no CUDA device available (pass CPU "
                               "devices to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _default_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("mesh: no CUDA device available (pass devices, e.g. "
                           "['cpu'] * 8, to run on the CPU)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """Positions of a ``(data, model, seq)`` grid: the device of each, the
    process that owns it (``ranks``; all ``rank`` in one process) and, for a
    position on a card this process owns, its own CUDA stream."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = AXIS_NAMES,
                 ranks: Optional[np.ndarray] = None, rank: int = 0):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of rank {devices.ndim} for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.rank = int(rank)
        self.ranks = (np.full(devices.shape, self.rank, dtype=np.int64)
                      if ranks is None else np.asarray(ranks, dtype=np.int64))
        self.streams = np.empty(devices.shape, dtype=object)
        for idx in self.positions():
            dev = devices[idx]
            self.streams[idx] = (torch.cuda.Stream(dev)
                                 if dev.type == "cuda" and self.is_local(idx) else None)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def positions(self) -> List[Tuple[int, ...]]:
        """Every position, row-major (data outermost)."""
        return [tuple(int(i) for i in idx) for idx in np.ndindex(*self.devices.shape)]

    def is_local(self, idx: Tuple[int, ...]) -> bool:
        return int(self.ranks[idx]) == self.rank

    def local_positions(self) -> List[Tuple[int, ...]]:
        return [idx for idx in self.positions() if self.is_local(idx)]

    def device(self, idx: Tuple[int, ...]) -> torch.device:
        return self.devices[idx]

    def stream(self, idx: Tuple[int, ...]):
        return self.streams[idx]

    def axis(self, name: str) -> int:
        return self.axis_names.index(name)

    def group(self, idx: Tuple[int, ...], name: str) -> List[Tuple[int, ...]]:
        """The positions that differ from ``idx`` only along axis ``name``,
        in axis order."""
        a = self.axis(name)
        return [idx[:a] + (k,) + idx[a + 1:] for k in range(self.devices.shape[a])]

    def __repr__(self) -> str:
        return (f"Mesh({', '.join(f'{k}={v}' for k, v in self.shape.items())}, "
                f"devices={sorted({str(d) for d in self.devices.flat})})")


def build_mesh(config: MeshConfig | None = None,
               devices: Sequence[Any] | None = None) -> Mesh:
    """A 3-axis (data, model, seq) mesh over ``devices`` (every visible card
    by default). One card degrades to a (1, 1, 1) mesh, so every code path is
    the same from one position to many."""
    devs = ([_resolve_device(d) for d in devices] if devices is not None
            else _default_devices())
    config = config or MeshConfig()
    shape = config.resolve(len(devs))
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), AXIS_NAMES)


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, backend: str = "gloo") -> None:
    """Join the cross-process group: one call per process, before any
    cross-process collective. ``coordinator_address`` is ``host:port`` of
    the rendezvous (rank 0 listens there)."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=300))


def build_multihost_mesh(config: MeshConfig | None = None,
                         devices: Sequence[Any] | None = None) -> Mesh:
    """The global (data, model, seq) mesh with a PROCESS-MAJOR data axis.

    ``devices`` are this process's positions (every visible card by
    default); each process passes its own and the lists are exchanged, so
    every process builds the same global mesh and owns its slice of it.
    ``model * seq`` must divide the per-process position count or a tile
    would straddle a process boundary: refused. One process: the same as
    ``build_mesh``."""
    import torch.distributed as dist

    config = config or MeshConfig()
    local = ([_resolve_device(d) for d in devices] if devices is not None
             else _default_devices())
    if not (dist.is_available() and dist.is_initialized()):
        return build_mesh(config, local)
    world, rank = dist.get_world_size(), dist.get_rank()
    gathered: List[Any] = [None] * world
    dist.all_gather_object(gathered, [str(d) for d in local])
    n_local = min(len(g) for g in gathered)
    ms = config.model * config.seq
    if n_local % ms != 0:
        raise ValueError(
            f"model*seq={ms} does not divide the per-process device count "
            f"{n_local}: a TP/SP tile would straddle a process boundary")
    devs, owners = [], []
    for p, names in enumerate(gathered):
        devs.extend(torch.device(n) for n in names)
        owners.extend([p] * len(names))
    shape = config.resolve(len(devs))
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), AXIS_NAMES,
                ranks=np.asarray(owners).reshape(shape), rank=rank)


# ------------------------------------------------------------ sharded data
class NamedSharding:
    """A mesh and a ``PartitionSpec``: a leaf of a sharding tree."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def batch_sharding(mesh: Mesh, extra_dims: int = 0) -> NamedSharding:
    """Sharding for a [B, ...] tensor: batch over ``data``, rest replicated."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * extra_dims)))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def local_mesh_size(mesh: Mesh, axis: str = DATA_AXIS) -> int:
    return mesh.shape[axis]


def pad_batch_to_mesh(n: int, mesh: Mesh) -> int:
    """Smallest batch >= max(n, 1) divisible by the data axis size."""
    d = local_mesh_size(mesh)
    return int(math.ceil(max(n, 1) / d) * d)


def block_slices(shape: Sequence[int], spec: PartitionSpec, mesh: Mesh,
                 idx: Tuple[int, ...]) -> Tuple[slice, ...]:
    """The block of a ``shape`` array that position ``idx`` holds under
    ``spec``; a split dimension must divide evenly."""
    out = []
    for dim, size in enumerate(shape):
        name = spec[dim] if dim < len(spec) else None
        if name is None:
            out.append(slice(0, size))
            continue
        n = mesh.shape[name]
        if size % n:
            raise ValueError(f"dimension {dim} of size {size} does not split "
                             f"over the {name}-axis size {n}")
        chunk = size // n
        k = idx[mesh.axis(name)]
        out.append(slice(k * chunk, (k + 1) * chunk))
    return tuple(out)


def _as_tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


class ShardedTensor:
    """A global tensor as blocks on the positions this process owns.
    ``shards`` maps a position to its block; positions on one device that
    hold the same block share one tensor."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec, global_shape: Tuple[int, ...],
                 shards: Dict[Tuple[int, ...], torch.Tensor]):
        self.mesh = mesh
        self.spec = spec
        self.shape = tuple(global_shape)
        self.shards = shards

    @property
    def addressable_shards(self) -> List[Tuple[Tuple[slice, ...], torch.Tensor]]:
        return [(block_slices(self.shape, self.spec, self.mesh, idx), t)
                for idx, t in self.shards.items()]

    def gather(self, device: Any = None) -> torch.Tensor:
        """The global tensor on ``device`` (the first position's by
        default), from the blocks; every block must be local."""
        first = next(iter(self.shards))
        device = torch.device(device) if device is not None else self.shards[first].device
        out = None
        seen = set()
        for sl, t in self.addressable_shards:
            key = tuple((s.start, s.stop) for s in sl)
            if key in seen:
                continue
            seen.add(key)
            if out is None:
                out = torch.empty(self.shape, dtype=t.dtype, device=device)
            out[sl] = t.to(device)
        covered = sum(math.prod(b - a for a, b in key) for key in seen)
        if covered != math.prod(self.shape):
            raise ValueError("ShardedTensor.gather: some blocks live in another process")
        return out


def _place_blocks(x: torch.Tensor, spec: PartitionSpec, mesh: Mesh,
                  positions: Sequence[Tuple[int, ...]],
                  offset: Optional[Callable[[Tuple[int, ...]], Tuple[slice, ...]]] = None
                  ) -> Dict[Tuple[int, ...], torch.Tensor]:
    shards: Dict[Tuple[int, ...], torch.Tensor] = {}
    cache: Dict[Tuple, torch.Tensor] = {}
    for idx in positions:
        sl = (offset(idx) if offset is not None
              else block_slices(x.shape, spec, mesh, idx))
        dev = mesh.device(idx)
        key = (str(dev), tuple((s.start, s.stop) for s in sl))
        if key not in cache:
            cache[key] = x[sl].to(dev).contiguous()
        shards[idx] = cache[key]
    return shards


def device_put(x: Any, sharding: NamedSharding) -> Any:
    """A tensor (or numpy array, or a pytree of them) split over the
    positions this process owns per ``sharding``. Scalars and None pass
    through."""
    def put(leaf):
        if leaf is None or isinstance(leaf, (int, float, bool, str)):
            return leaf
        t = _as_tensor(leaf)
        mesh, spec = sharding.mesh, sharding.spec
        return ShardedTensor(mesh, spec, tuple(t.shape),
                             _place_blocks(t, spec, mesh, mesh.local_positions()))
    return tree_map(put, x)


def shard_batch(mesh: Mesh, tree: Any) -> Any:
    """Every [B, ...] leaf of a pytree split over the data axis; 0-d leaves
    replicated. A leading dim that does not divide the data axis is padded
    up to ``pad_batch_to_mesh`` by replicating row 0 (the staging
    convention: a pad row is a well-formed record, never zeros)."""
    d = local_mesh_size(mesh)

    def put(x):
        if x is None:
            return None
        t = _as_tensor(x)
        if t.ndim == 0:
            return device_put(t, replicated_sharding(mesh))
        n = t.shape[0]
        if n % d:
            m = pad_batch_to_mesh(n, mesh)
            t = torch.cat([t, t[:1].expand((m - n,) + tuple(t.shape[1:]))], dim=0)
        return device_put(t, batch_sharding(mesh, t.ndim - 1))

    return tree_map(put, tree)


def make_global_batch(mesh: Mesh, tree: Any, shardings: Any) -> Any:
    """A global batch from each process's local rows: one process degrades
    to ``device_put``; across processes each passes only the rows its
    positions own (its span of the process-major data axis), and a block
    split over ``data`` is cut from those rows. Replicated leaves are the
    same value in every process. Processes never exchange batch bytes."""
    import torch.distributed as dist

    multi = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    if isinstance(shardings, NamedSharding):
        shardings = tree_map(lambda _: shardings, tree)
    if not multi:
        return tree_map(lambda x, s: device_put(x, s), tree, shardings,
                        is_leaf=lambda x: x is None)
    world = dist.get_world_size()

    def put(x, s):
        if x is None:
            return None
        t = _as_tensor(x)
        spec = s.spec
        local = mesh.local_positions()
        if not spec or spec[0] != DATA_AXIS:
            return ShardedTensor(mesh, spec, tuple(t.shape),
                                 _place_blocks(t, spec, mesh, local))
        global_shape = (t.shape[0] * world,) + tuple(t.shape[1:])
        first = min(idx[mesh.axis(DATA_AXIS)] for idx in local)

        def offset(idx):
            sl = block_slices(global_shape, spec, mesh, idx)
            start = sl[0].start - first * (global_shape[0] // mesh.shape[DATA_AXIS])
            return (slice(start, start + sl[0].stop - sl[0].start),) + sl[1:]

        return ShardedTensor(mesh, spec, global_shape, _place_blocks(t, spec, mesh, local,
                                                                     offset=offset))

    return tree_map(put, tree, shardings, is_leaf=lambda x: x is None)
