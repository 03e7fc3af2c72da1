"""Parallelism layer: sharding layouts, collectives, distributed training.

Port of the JAX package's ``parallel/``: the layout tables
(``layouts.py``), named-axis collectives and ``shard_map_over`` over a port
mesh (``collectives.py``), ring attention (``context.py``), the
expert-parallel MoE FFN (``experts.py``), the pipeline schedule
(``pipeline.py``) and the DP + TP joint train step (``train.py``).
"""

from realtime_fraud_detection_tpu_torch.parallel.context import (  # noqa: F401
    bert_context_parallel_predict,
    ring_attention,
)
from realtime_fraud_detection_tpu_torch.parallel.experts import (  # noqa: F401
    MoEConfig,
    init_moe_params,
    moe_ffn,
    moe_ffn_reference,
)
from realtime_fraud_detection_tpu_torch.parallel.layouts import (  # noqa: F401
    batch_shardings,
    bert_param_specs,
    scoring_model_specs,
    tree_specs_to_shardings,
)
from realtime_fraud_detection_tpu_torch.parallel.pipeline import (  # noqa: F401
    bert_pipeline_encode,
    pipeline_forward,
    stack_stage_params,
)
from realtime_fraud_detection_tpu_torch.parallel.train import (  # noqa: F401
    TrainBatch,
    TrainState,
    init_train_state,
    joint_loss,
    make_train_step,
    neural_param_shardings,
    shard_train_batch,
)
