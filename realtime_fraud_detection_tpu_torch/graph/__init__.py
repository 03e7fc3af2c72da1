"""The entity-graph plane of the port, the GNN branch's serve-time input.

- ``graph.store``: ``TypedEntityGraph``, the user / device / merchant / IP
  adjacency with bounded recency rings a directed edge type, kept from the
  transaction flow at write-back and carried by ``cluster/partition.py``'s
  ``PartitionState`` (snapshot, restore, digest);
- ``graph.sampler``: ``NeighborSampler``, the deterministic fixed-fan-out
  two-hop sampler across edge types, emitting the padded tensors the typed
  GNN takes, with a dependency-evicting cache;
- ``graph.fetch``: ``GraphFetchClient`` / ``GraphFetchServer``, the
  cross-partition neighbour resolution over the netbroker framing, with a
  budget and a deadline a batch and a degrade to the local subgraph;
- ``graph.drill``: ``graph-drill``, the plane's acceptance drill.
"""

from realtime_fraud_detection_tpu_torch.graph.store import (  # noqa: F401
    EDGE_TYPES,
    NODE_TYPES,
    TypedEntityGraph,
)
from realtime_fraud_detection_tpu_torch.graph.sampler import (  # noqa: F401
    NeighborSampler,
)
from realtime_fraud_detection_tpu_torch.graph.fetch import (  # noqa: F401
    GraphFetchClient,
    GraphFetchServer,
    StaleGraphGenerationError,
)

__all__ = [
    "EDGE_TYPES",
    "NODE_TYPES",
    "TypedEntityGraph",
    "NeighborSampler",
    "GraphFetchClient",
    "GraphFetchServer",
    "StaleGraphGenerationError",
]

