"""The chaos plane of the port: deterministic fault windows and the
per-layer injectors (``chaos/faults.py``). The JAX package's network
faults and its chaos and partition drills are not ported yet."""

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

__all__ = [
    "BrokerReplicaOutage",
    "ChaosPlan",
    "ConsumerMemberKill",
    "DeviceReplicaDeath",
    "FaultWindow",
    "LabelStall",
    "SlowDevice",
    "WorkerKill",
]
