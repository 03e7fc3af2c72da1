"""Closed-loop continuous-learning plane.

Port of the JAX package's ``feedback/``: delayed ground-truth labels
(``sim/simulator.py label_events``) join back to emitted predictions
(``labels.LabelJoin``), feed prequential test-then-train quality metrics
(``prequential.py``) and a bounded labeled-example buffer
(``state/labeled.py``); drift or prequential degradation triggers a retrain
whose candidate blend must pass the promotion gate before it reaches the
serving models through the /reload-models recipe (``policy.py``,
``plane.py``). ``feedback-drill`` runs the whole loop deterministically on
a virtual clock (``drill.py``), on the card unless ``--device cpu``.
"""

from realtime_fraud_detection_tpu_torch.feedback.labels import (  # noqa: F401
    LabelJoin,
    make_label_events,
)
from realtime_fraud_detection_tpu_torch.feedback.prequential import (  # noqa: F401
    FadingAUC,
    PrequentialEvaluator,
    sliding_auc,
    weighted_auc,
)
from realtime_fraud_detection_tpu_torch.feedback.policy import (  # noqa: F401
    PromotionGate,
    Retrainer,
    RetrainPolicy,
)
from realtime_fraud_detection_tpu_torch.feedback.plane import (  # noqa: F401
    FeedbackPlane,
)
from realtime_fraud_detection_tpu_torch.feedback.drill import (  # noqa: F401
    run_feedback_drill,
)
