"""Scoring of the port: the fused scorer, the host pipeline, the device
pool, the mesh executor and the streaming scorer (the names the JAX
package's ``scoring/__init__.py`` exports; ``FraudScorer`` is
``TorchFraudScorer``). Importing it starts no CUDA context.
"""

from realtime_fraud_detection_tpu_torch.scoring.pipeline import (  # noqa: F401
    MODEL_NAMES,
    NUM_MODELS,
    ScoreBatch,
    ScorerConfig,
    ScoringModels,
    init_scoring_models,
    make_example_batch,
    score_fused,
    score_fused_packed,
)
from realtime_fraud_detection_tpu_torch.scoring.host_pipeline import (  # noqa: F401
    AssembledHandle,
    AssemblerStage,
)
from realtime_fraud_detection_tpu_torch.scoring.device_pool import (  # noqa: F401
    DevicePool,
)
from realtime_fraud_detection_tpu_torch.scoring.mesh_executor import (  # noqa: F401
    MeshExecutor,
)
from realtime_fraud_detection_tpu_torch.scoring.scorer import FraudScorer  # noqa: F401
