"""Core of the port: the device mesh, the precision policy, batch bucketing
(the names the JAX package's ``core/__init__.py`` exports). Importing it
starts no CUDA context.
"""

from realtime_fraud_detection_tpu_torch.core.mesh import (  # noqa: F401
    MeshConfig,
    build_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
    local_mesh_size,
)
from realtime_fraud_detection_tpu_torch.core.precision import Policy, DEFAULT_POLICY  # noqa: F401
from realtime_fraud_detection_tpu_torch.core.batching import (  # noqa: F401
    BATCH_BUCKETS,
    bucket_for,
    pad_to_bucket,
    unpad,
)
