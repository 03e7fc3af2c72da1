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
- ``cluster.drill``: ``shard-drill``, the deterministic acceptance drill;
- ``cluster.handoff``: the network-served handoff store (a TCP server and
  client, crash-safe blobs, sha256-verified restore, epoch fencing) that
  outlives any worker process;
- ``cluster.autoscale``: the autoscale controller, the tuning plane's
  arrival forecast turned into a worker count (lead horizon, asymmetric
  hysteresis, a deterministic decision ledger);
- ``cluster.procfleet``: the fleet across the process boundary (workers as
  OS processes over the TCP netbroker, two-phase rebalances, graceful
  drain, recovery from a real SIGKILL);
- ``cluster.elastic_drill``: ``elastic-drill``, the process fleet's
  acceptance drill.
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
from realtime_fraud_detection_tpu_torch.cluster.handoff import (
    FencedEpochError,
    HandoffClient,
    HandoffServer,
)
from realtime_fraud_detection_tpu_torch.cluster.autoscale import (
    AutoscaleController,
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
    "HandoffServer",
    "HandoffClient",
    "FencedEpochError",
    "AutoscaleController",
]
