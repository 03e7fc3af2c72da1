"""PyTorch + CUDA port of the fraud scorer for one NVIDIA H100.

A second package beside ``realtime_fraud_detection_tpu`` (the JAX reference,
which it imports nothing of). It scores a packed microbatch end to end
(``scoring.pipeline.score_fused_packed``) with the quantized BERT branch,
flash attention, the fused epilogue and the persistent megakernel running
through the hand-written kernels of ``csrc/`` (built on first use by
``ops.build``), and runs the streaming job around it: simulator -> in-memory
broker -> ``stream.job.StreamJob`` -> ``scoring.scorer.TorchFraudScorer``
(host assembly, the device program, state write-back) -> output topics,
with the deadline-aware QoS plane (``qos``: admission, latency budgets, the
degradation ladder), the tracing plane (``obs.tracing``: per-transaction
stage spans, the SLO burn rate that gates the QoS plane) and the tuning
plane (``tuning``: the just-in-time batch closer and the online tuner)
optional in the job; ``python -m realtime_fraud_detection_tpu_torch
run-job`` is its entry point. The scoring HTTP service (``serving.app
ServingApp``: request microbatcher, prediction cache, checkpoint restore and
hot reload, drift, A/B experiments) is the other: ``python -m
realtime_fraud_detection_tpu_torch serve``. The training plane
(``training``: the GBDT and isolation-forest trainers, the neural trainers
on ``torch.optim``, Platt calibration, the blend-selection protocol) backs
the ``train``, ``validate`` and ``quality-eval`` commands. Deployed, the job
runs over the TCP log broker (``stream.netbroker``, the ``broker`` command),
fed by ``simulate --broker`` through the ingress gateway (``stream.gateway``
and its C++ queue, ``native``), with the windowed analytics
(``stream.windows``) and the enrichment blend on, a graceful drain on
SIGTERM and a resume from its checkpoint; ``alert-router`` consumes its
alerts. Across processes, ``cluster.procfleet`` runs partition-scoped
workers (``cluster-worker``) over that broker with the network handoff store
(``cluster.handoff``) and the autoscaler (``cluster.autoscale``), proved by
``elastic-drill`` and, under the link faults of ``chaos.netfaults``, by
``partition-drill``; ``chaos-drill`` runs every plane through one
correlated-failure timeline on the device pool. The mesh plane
(``core.mesh``, ``scoring.mesh_executor``, ``parallel``) splits a batch over
the ``data`` positions of a mesh and stores branches split over ``model``,
proved by ``mesh-drill``.
"""

__version__ = "0.1.0"

from realtime_fraud_detection_tpu_torch.utils.config import Config  # noqa: F401
