"""The partition-parallel worker plane of the port: the broker partition is
the unit of consumption and of state ownership.

- ``cluster.hashring``: key -> partition (the transport's crc32) and
  partition -> worker (a consistent-hash ring), and the serving
  ``ShardRouter``;
- ``cluster.partition``: the state stores behind a key-partitioned
  interface (``PartitionedStore``), with snapshot, restore and digest per
  partition;
- ``cluster.fleet``: N partition-scoped ``StreamJob`` workers in one
  consumer group with checkpointed handoff on a worker's loss
  (``WorkerFleet`` / ``HandoffStore``);
- ``cluster.drill``: ``shard-drill``, the deterministic acceptance drill.

The JAX package's network handoff store, process fleet, autoscaler and
elastic drill are not ported yet.
"""

from realtime_fraud_detection_tpu_torch.cluster.hashring import (
    HashRing,
    ShardRouter,
    partition_for_key,
)
from realtime_fraud_detection_tpu_torch.cluster.partition import (
    PartitionNotOwned,
    PartitionState,
    PartitionedStore,
)
from realtime_fraud_detection_tpu_torch.cluster.fleet import (
    ClusterWorker,
    HandoffStore,
    WorkerFleet,
)

__all__ = [
    "HashRing",
    "ShardRouter",
    "partition_for_key",
    "PartitionNotOwned",
    "PartitionState",
    "PartitionedStore",
    "ClusterWorker",
    "HandoffStore",
    "WorkerFleet",
]
