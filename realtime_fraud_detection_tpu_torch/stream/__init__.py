"""Streaming layer: transport, microbatch assembly, the scoring job, the
windowed analytics and joins, the Kafka wire-protocol client, the TCP log
broker and the ingress gateway.

The names the JAX package's ``stream/__init__.py`` exports.
"""

from realtime_fraud_detection_tpu_torch.stream.topics import (  # noqa: F401
    ALERTS,
    DECISIONS,
    ENRICHED,
    FEATURES,
    PREDICTIONS,
    TOPIC_SPECS,
    TRANSACTIONS,
)
from realtime_fraud_detection_tpu_torch.stream.transport import (  # noqa: F401
    Consumer,
    FaultInjector,
    InMemoryBroker,
    KafkaTransport,
    Record,
)
from realtime_fraud_detection_tpu_torch.stream.kafka import KafkaBroker  # noqa: F401
from realtime_fraud_detection_tpu_torch.stream.netbroker import (  # noqa: F401
    BrokerServer,
    HaBrokerClient,
    NetBrokerClient,
    NotEnoughReplicasError,
)
from realtime_fraud_detection_tpu_torch.stream.gateway import (  # noqa: F401
    IngressGateway,
)
from realtime_fraud_detection_tpu_torch.stream.microbatch import (  # noqa: F401
    DoubleBufferedScorer,
    MicrobatchAssembler,
)
from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob  # noqa: F401
from realtime_fraud_detection_tpu_torch.stream.windows import (  # noqa: F401
    WindowedAnalytics,
    WindowOperator,
)
from realtime_fraud_detection_tpu_torch.stream.joins import (  # noqa: F401
    MultiStreamCorrelator,
    WindowJoin,
)
