"""State of the PyTorch port: the names the JAX package's ``state/__init__.py``
exports but ``StateBackend``, a protocol no code is typed against (the in-process stores, the RESP client and server, the shared
stores, the labeled buffer, the history and graph stores, the feature store
and the metadata store)."""
from realtime_fraud_detection_tpu_torch.state.stores import (  # noqa: F401
    VelocityStore,
    ProfileStore,
    TransactionCache,
    AggregationStore,
)
from realtime_fraud_detection_tpu_torch.state.resp import (  # noqa: F401
    MiniRedisServer,
    RespClient,
)
from realtime_fraud_detection_tpu_torch.state.shared import (  # noqa: F401
    SharedAggregationStore,
    SharedProfileStore,
    SharedTransactionCache,
    SharedVelocityStore,
)
from realtime_fraud_detection_tpu_torch.state.labeled import (  # noqa: F401
    LabeledExampleBuffer,
)
from realtime_fraud_detection_tpu_torch.state.history import (  # noqa: F401
    UserHistoryStore,
    EntityGraphStore,
)
from realtime_fraud_detection_tpu_torch.state.feature_store import (  # noqa: F401
    FeatureStats,
    FeatureStore,
)
from realtime_fraud_detection_tpu_torch.state.metadata import (  # noqa: F401
    MetadataStore,
)
