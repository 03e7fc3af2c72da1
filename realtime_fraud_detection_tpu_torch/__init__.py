"""PyTorch + CUDA port of the fraud scorer for one NVIDIA H100.

A second package beside ``realtime_fraud_detection_tpu`` (the JAX reference,
which it imports nothing of). This slice scores a packed microbatch end to
end: ``scoring.pipeline.score_fused_packed`` and the device half of the
streaming scorer, ``scoring.scorer.TorchFraudScorer``, with the quantized
BERT branch, flash attention and the fused epilogue running through the
hand-written kernels of ``csrc/`` (built on first use by ``ops.build``).
"""
