"""The chaos plane of the port: deterministic fault windows and the
per-layer injectors (``chaos/faults.py``), the network's link faults
(``chaos/netfaults.py``: latency, throttle, bounded drops, one-way and full
partitions in the framing transports' request path), the combined recovery
drill (``chaos/drill.py``, ``chaos-drill``) and the split-brain partition
drill (``chaos/partition_drill.py``, ``partition-drill``)."""

from realtime_fraud_detection_tpu_torch.chaos.faults import (
    BrokerReplicaOutage,
    ChaosPlan,
    ConsumerMemberKill,
    DeviceReplicaDeath,
    FaultWindow,
    LabelStall,
    SlowDevice,
    WorkerKill,
)
from realtime_fraud_detection_tpu_torch.chaos.netfaults import (
    LinkDegrade,
    LinkFaultPlane,
    LinkState,
    NetworkPartition,
    ScheduledLink,
)

__all__ = [
    "BrokerReplicaOutage",
    "ChaosPlan",
    "ConsumerMemberKill",
    "DeviceReplicaDeath",
    "FaultWindow",
    "LabelStall",
    "LinkDegrade",
    "LinkFaultPlane",
    "LinkState",
    "NetworkPartition",
    "ScheduledLink",
    "SlowDevice",
    "WorkerKill",
]
