"""The training plane of the PyTorch port (see ``neural.py`` for the loop).

``gbdt.GBDTTrainer`` (NumPy, on the host), ``neural`` (the LSTM and
GraphSAGE trainers on ``torch.optim``), ``text`` (the BERT branch on
simulated text), ``calibrate`` (Platt scaling folded into each head) and
``blend_eval`` (the blend-selection protocol behind ``quality-eval``).
"""

from realtime_fraud_detection_tpu_torch.training.gbdt import GBDTTrainer  # noqa: F401
