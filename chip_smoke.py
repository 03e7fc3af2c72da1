#!/usr/bin/env python3
"""Drive the PyTorch port of the fraud scorer on one CUDA card.

Run from the repository root on a machine with one H100:

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

1. the card's name and power limit, torch and CUDA versions; TF32 is turned
   off and checked off (the GEMM-form trees need exact f32 products);
2. build the CUDA kernels of ``realtime_fraud_detection_tpu_torch/csrc``;
3. run each kernel at the shapes its main path gives it, hold it against
   its plain PyTorch version on the card, and time the kernel, the plain
   version and a library yardstick with CUDA events (the epilogue also by
   the profiler's device time, beside an empty kernel launched on the same
   grid from the same build: the launch floor, with its wrapper's host ms
   per call and the launches of the chain's tail, ``chain_tail``): the four
   per-site kernels at the bucket-256 DistilBERT-base slice's shapes, the
   megakernel at TINY width (int8 BERT at buckets 256 and 8, f32 BERT
   once, int8 BERT once more with f32 compute; its yardstick is the
   per-site chain's device time on the same batch, as no single PyTorch
   call computes the ensemble). The
   dequant-matmul is also checked at the TINY widths and at M = 64 (a
   bucket-1 batch), flash attention also at S = 100; both print the
   profiler's device time per launch beside the CUDA-event time, and so
   does ``dequant_rows`` for each of its two sites (word, position). The
   megakernel's timings: device ms per launch at buckets 8 and 256, device
   ms with one branch on at a time, and the host ms per call of its public
   wrapper (which builds the parameter arguments each call) and of the
   scorer's packed entry (with the arguments the scorer builds once);
4. score a seeded 256-row batch through ``TorchFraudScorer`` at
   DistilBERT-base with int8 BERT and the per-site kernels on (launch
   counters reset just before, read just after), compare the packed result
   with the same models on the kernels-off plain path on the card and, at 8
   rows, with the CPU, then time batches after warm-up. Every end-to-end
   comparison here and below is held to the bf16 noise bound the port's
   kernel drill measures on the card for that configuration and tokens
   (floored at 1e-4), decisions compared on every row farther than it from
   a rung, the rows skipped printed;
5. the megakernel slice: ``TorchFraudScorer`` at TINY with int8 BERT and
   ``KernelSettings.mega()``; one bucket-256 batch launches the megakernel
   once and no per-site kernel (the counters and ``kernel_snapshot()``
   agree), and matches the kernels-off plain path;
6. honest fallbacks: on that scorer a bucket-1 batch runs the per-site
   chain (launches 1/2/12/2) and counts a megakernel fallback, and a
   DistilBERT-base batch under ``mega()`` is declined by the plan and runs
   the chain (1/6/36/2); the snapshot's ``kernel_launches`` equals the
   counters' sum each time;
7. megakernel against the per-site chain at TINY int8, buckets 8, 32, 128
   and 256: p50 / p99 per batch and txn/s, host clock, interleaved;
8. the stream: seeded simulator transactions (the ``run-job`` defaults,
   10,000 users and 5,000 merchants) through the port's ``StreamJob`` on the
   in-memory broker, batches of 256, two in flight, a fixed virtual clock:
   4,096 at TINY under ``KernelSettings.mega()`` (one megakernel launch a
   batch) and 1,024 at DistilBERT-base under ``KernelSettings.full()`` (the
   45-launch chain a batch), int8 BERT both, launch counters reset just
   before and read just after. Every record scored once with no error, lag
   0, each id once on the predictions, enriched and features topics;
   decisions and risk levels equal to the same stream through a kernels-off
   card scorer (and, at TINY, a CPU scorer) away from a rung; a re-produced
   first batch all skipped as duplicates. Prints txn/s, batch p50 / p99
   from dispatch to completion, the scorer's host stages per batch and the
   smoke's own times for response building, write-back and fan-out;
9. the typed entity graph: 2,048 transactions of a seeded stream with the
   simulator's fraud ring (rate 0.08) through ``StreamJob`` on a
   ``TorchFraudScorer`` at TINY width with typed GNN parameters,
   ``ScorerConfig(graph_mode="typed", transfer_bf16=True)``, int8 BERT and
   ``KernelSettings.mega()``: the megakernel's plan declines every batch
   (two-hop) and each batch runs the per-site chain (12 / 2 / 2 / 1
   launches), counted as a fallback. The same stream through a kernels-off
   CPU scorer; decisions held to the drill's bound at the full rung and at
   one batch of each lower QoS rung, ``rules_only`` bit-exact, the typed
   graph's digest and the sampler's counters equal. Prints the launches,
   the sampling span, the sampler's cache counters, the two-hop bytes a
   batch, txn/s and batch p50 / p99;
10. overlapped assembly: phase 8's TINY stream with
   ``JobConfig.overlap_assembly`` off, then on, in this call; every record
   emitted once, every offset committed, completions in the serial run's
   order (decisions are not compared: under overlap, which write-backs land
   before an assembly depends on timing); txn/s, p50 / p99 and host ms per
   stage of both;
11. the port's kernel drill (``KernelDrillConfig.fast()``) on the card, on
   the per-site chain and on the megakernel: both verdicts must pass;
12. the wordpiece tokenizer at full width: phase 8's DistilBERT-base stream
   (the same 1,024 transactions, ``KernelSettings.full()``, int8 BERT, the
   kernels-off card scorer as reference) with
   ``ScorerConfig(tokenizer="wordpiece")``: 1 / 6 / 36 / 2 launches a batch,
   every batch's ids and masks equal a CPU ``WordPieceTokenizer``'s on the
   same texts, the highest id inside the word table, ``dequant_rows`` at the
   word site bit-exact on a stream batch's ids; prints the tokenizer's host
   ms a batch, the token cache's counters, txn/s and batch p50 / p99 beside
   phase 8's word-tokenizer stream;
13. the QoS plane live on the card: the TINY ``mega()`` stream (int8 BERT,
   overlap off, depth 2, batches of 256) under ``QosSettings(enabled=True)``
   at the JAX defaults (budget 20 ms, margin 2 ms, watermarks 2,048 / 256,
   patience 2, up-patience 8) with admission at 25,000 txn/s and a bucket
   of 1,024. Ingest timestamps, admission and the budget run on a virtual
   clock of one 5.12 ms period a batch (256 transactions at 50,000 txn/s):
   6,100 transactions arrive in period 0 (23 batches the size trigger
   closes, then 212 the budget closes), then 64 a period for 32 periods
   (each closed by the 5 ms deadline). The ladder steps down to
   ``rules_only`` in the burst and back to ``full_ensemble`` in the
   trickle. The rung sequence, the shed ids and reasons equal the same
   schedule through a kernels-off CPU scorer; no high-priority record is
   shed; each produced id is on the predictions topic once; each batch
   launches the megakernel once with its rung's ``mega_valid`` (all false
   at ``rules_only``) and no per-site kernel; decisions within the drill's
   bound at every rung, ``rules_only`` bit-exact; the exposition carries the
   ``qos_*`` families and the budget closes. Prints per rung the batches,
   the megakernel's device ms (CUDA events behind a spin kernel, each launch
   replayed once on a second run of the schedule, whose rungs and masks must
   equal the first's) and host batch p50 / p99, the
   transitions, the sheds by priority, the close reasons and the admitted
   records' virtual latency p99 against the budget. Last, a scorer built
   from ``Config()`` + ``apply_quality_artifact("QUALITY_r05.json")`` serves
   its blend on one TINY bucket-256 batch in one megakernel launch at
   ``mega_valid`` (T, T, F, F, T), held against the kernels-off plain path.
14. the tracing plane: (a) phase 8's TINY ``mega()`` stream (4,096
   transactions, int8 BERT, batches of 256, depth 2) four times in turns,
   ``JobConfig(tracing=None)`` then ``TracingSettings(enabled=True)`` on
   ``time.monotonic``, twice each: every run one megakernel launch a batch;
   ids, order and decisions identical across the runs; one ``scored`` trace
   per scored transaction, each ending with the scorer's stages (queue,
   assemble, pack, dispatch, device_wait, finalize), ``device_wait``
   positive on every traced batch. Prints the breakdown's per-stage shares
   at p50 / p95 / p99 with the dominant stage, txn/s off and on, the plane's
   host cost a transaction (inside its calls, and the trace drill's loop)
   and the size of the exported Chrome trace
   (``chiprun_out/tiny_traced_stream.json``). (b) the SLO-burn gate: phase
   13's QoS schedule with a ``Tracer`` on the same virtual clock (objective
   20 ms; fast / slow windows 0.12 / 0.48 s, buckets of 0.01 s, so the
   burst's violations age out inside the trickle; threshold 2, patience 2,
   up-patience 4): the gate engages in the burst and releases before the
   end, holding rung 1 for a few batches after the ladder's own recovery;
   the rungs, the gate's state at each dispatch and the sheds equal a
   kernels-off CPU run's; one megakernel launch per batch with its rung's
   mask; decisions within the drill's bound at every rung, ``rules_only``
   bit-exact. Prints the rungs beside phase 13's;
15. the tuning plane: (a) the autotune drill's offered-load timeline
   (``AutotuneDrillConfig.fast()``, a compressed diurnal cycle of 3 s from
   150 to 8,000 txn/s with bursts x4, cut to its first 1.5 s to keep the
   command near 150 s: 9,508 arrivals, the trough, the ramp, one burst and
   the peak) on the seeded simulator's
   records (the drill's priority mix by amount) through ``StreamJob`` with
   ``JobConfig(qos=..., tracing=..., autotune=...)``, on the card scorer and
   on a kernels-off CPU scorer, each on a virtual clock advanced by the
   drill's service curve (2 ms + 6 us a padded row), so the close decisions
   do not depend on the device: the batch sizes, close reasons, the tuner's
   snapshot and the trace counters equal the CPU run's, decisions within the
   drill's bound; each batch of two or more rows one megakernel launch,
   each one-row batch the per-site chain (1 / 2 / 12 / 2 launches) and one
   counted megakernel fallback, the counters' growth equal to the
   snapshot's ``kernel_launches`` every batch. Prints the bucket histogram
   and the launches by bucket. (b) the same timeline paced in wall time (a
   producer thread), once with the tuning plane of ``run-job --autotune
   --qos`` fed the card's dispatch-to-completion times, once with the fixed
   5 ms deadline: each id emitted once, lag 0, no high-priority shed.
   Prints admitted p50 / p99 and txn/s, the close reasons, the tuner's
   moves, the learned T(bucket) and the measured one.
16. the scoring service: the port's ``ServingApp`` on ``127.0.0.1:0`` with
   the scorer injected (int8 BERT, the concurrency cap raised to 256 so the
   256-row body is admitted, no dedicated metrics listener; the kernels
   built before it listens), the clients in a process of their own
   (``serving/loadgen.py``, 64 keep-alive clients, one request in flight
   each, a 503 counted and retried). (a) DistilBERT-base under
   ``KernelSettings.full()``: one ``POST /batch-predict`` of 256 seeded
   transactions launches 1 / 6 / 36 / 2 (counters reset just before, read
   just after), held against the same body through a CPU port app with the
   same models (scores within the drill's bound, decisions exact off a
   rung); then 1,024 ``POST /predict``: each answered once with a 200, each
   batch the 45-launch chain; prints request p50 / p99, txn/s, the
   microbatcher's batch sizes, launches a batch, the collector's
   collections during the load and ``kernel_fallback_total``. (b) TINY
   under ``KernelSettings.mega()``: the same, each batch of two or more rows
   one megakernel launch, each one-row batch the chain (1 / 2 / 12 / 2) and
   one counted fallback; then 16 ``/predict`` one at a time, 16 one-row
   batches on the chain, the exposition's fallback total equal to the
   snapshot's; then the hot swap: a fresh app takes 1,024 ``/predict`` and,
   a quarter of them answered, ``/reload-models`` restores a port checkpoint
   of the second seed's models while the rest are in flight: every
   transaction answered once with a 200, the app's batches replayed in order
   through two kernels-off card scorers (one per model set), each answer
   equal to the replay under the set its batch was launched with, none sent
   after the reload returned answered by the old set. (c)
   ``serving.overlap_assembly`` on: the first 64 of (a)'s body sent one at a
   time as ``/predict`` to DistilBERT-base apps with overlap on and off,
   decisions equal off a rung, then 1,024 concurrent ``/predict`` on the
   overlapped app (two batches in flight), p50 / p99 and txn/s. ``/health``
   and ``/metrics/prometheus`` are read once in each part. (d) ``python -m
   realtime_fraud_detection_tpu_torch serve --mega`` in a process of its
   own: ``/health`` and the ``health-check`` command healthy, four
   ``/predict`` answered, the dedicated metrics listener read, and SIGTERM
   drains it to exit 0.
17. the training plane: (a) ``python -m realtime_fraud_detection_tpu_torch
   train --neural`` at its defaults (10,000 rows, 100 trees of depth 6, the
   LSTM at hidden 128, the GNN at 16 / 64, TINY BERT on 8,000 transactions)
   on the card and, beside it, with ``--device cpu`` (on half the cores):
   the two checkpoints' tree and isolation-forest arrays equal, the GBDT
   AUC and importances equal, each neural branch's held-out AUC (4,096
   rows of a fresh stream) within ``TRAIN_AUC_BAND``; prints the card's ms
   per optimizer step for each branch and the GBDT's host seconds. (b)
   ``validate`` on the card's checkpoint on the card and on the CPU (started
   once the card's ``train`` ends, beside the CPU's): the
   same report keys, AUCs within ``VALIDATE_AUC_TOL``; ``--min-auc 0.99``
   exits 1 unless the AUC reaches it; the textfile written; a card and a
   CPU scorer restored from it answer with the trainer's
   ``top_feature_importances``. (c) the checkpoint restored into TINY
   scorers with int8 BERT (quantized on the host): one 256-row stream batch
   under ``full()`` launches 1 / 2 / 12 / 2, under ``mega()`` the
   megakernel once, each within the drill's bound of the kernels-off plain
   path, decisions equal off a rung; then the megakernel's typed GNN:
   typed parameters from ``train_typed_gnn`` (2,048 fraud-ring
   transactions, one epoch) on a one-hop 256-row batch of a typed scorer,
   against its plain version. (d) ``quality-eval --checkpoint-dir`` at
   ``BlendEvalConfig()`` defaults on the card (started with the two
   ``train`` commands, so it runs beside the whole phase): the per-branch
   AUC, the admission, the strategy, the seconds per stage
   (``chiprun_out/quality_eval_card.json``), printed beside the earlier JAX
   artifact ``QUALITY_r05.json`` for context; then the artifact and its
   checkpoint applied together to a megakernel scorer at the artifact's
   text model (attention "reference": the flash kernel takes head width 64
   only): one 256-row batch, one megakernel launch under the artifact's
   branch mask, within the bound of the plain path.
18. the feedback plane and the quantization drill: (a) the feedback drill at
   its defaults on the card and, beside it, on the CPU (in a process of its
   own): both pass; the labels matched, the join, the buffer, the triggers
   and their reasons, the gate's verdicts, the promotions and the promoted
   blend equal; baseline / dip / recovered AUC within ``FEEDBACK_AUC_TOL``;
   the promoted trees' arrays equal; the retrains' host seconds. (b) the
   drill's promoted candidate pushed by ``promote_candidate`` mid-stream,
   with a batch in flight, into a TINY int8 ``mega()`` scorer and a
   DistilBERT-base int8 ``full()`` one under ``StreamJob``, at the drill's
   strategy and at ``stacking``: each batch launched before the swap within
   the drill's bound of a kernels-off card scorer holding the incumbent, each
   after it of one holding the promoted set (decisions off a rung), one
   megakernel launch or 1 / 6 / 36 / 2 a batch throughout, the promotion's
   host ms; a gate-rejected candidate leaves the scorer's fingerprint
   bit-identical. (c) ``run-job --feedback --mega --quant`` (15,000
   transactions at the ``run-job`` defaults) as a command on the card, the
   same without ``--feedback``, the first with ``--device cpu``: the
   feedback blocks' labels, buffer and policy counts equal, a retrain
   promoted, decisions off a rung equal; txn/s with and without the plane. (d) a DistilBERT-base
   ``full()`` ``ServingApp`` with the plane on: 256 ``/predict`` from 64
   clients (the chain a batch), their labels on ``POST /labels``, ``GET
   /quality/live``, the ``prequential_*`` / ``feedback_*`` families, 409
   with the plane off, 400 on a malformed body. (e) ``quant-drill`` at its
   defaults as a command on the card (its replay the second card run) beside
   the CPU port run, then a DistilBERT-base leg: 1,024 stream transactions
   through f32 BERT (kernels off) and int8 BERT under ``full()`` (1 / 6 / 36
   / 2 launches a batch), the divergence printed against that width's noise
   bound.
19. the job as deployed: (a) phase 8's two streams (2,048 TINY under
   ``mega()``, 512 DistilBERT-base under ``full()``, int8 BERT, batches of
   256, depth 2) through ``StreamJob`` on the card with the analytics and
   enrichment planes off, then on (``JobConfig(enable_analytics=True,
   enable_enrichment=True)``; launch counters reset just before, read just
   after: one megakernel a TINY batch, 1 / 6 / 36 / 2 a DistilBERT-base
   batch), then on through a CPU scorer: predictions within the drill's
   bound and decisions equal off a rung; the enriched topic's blended
   ``fraud_score`` and ``ensemble_score`` within the bound, enrichment
   decisions equal but where the blend lies within the bound of 0.6 or 0.95
   (counted and printed); every analytics record equal but for the
   high-risk count of a window holding a row within the bound of 0.7
   (counted); the summaries' fired windows equal the analytics topics.
   Prints txn/s and batch p50 / p99 with the planes off and on, the
   analytics plane's host us a transaction, the job's blend host ms and
   ``blend_enrichment``'s device ms a batch (CUDA events behind a spin). (b)
   each a process of its own: ``broker`` on a free port with a temporary
   ``--log-dir``; ``simulate --broker --count 1024`` through the ingress
   gateway (started before (a), finished after it; its standard error must
   say the native queue was used, none dropped); ``run-job --broker ...
   --count 0 --quant --mega --analytics --enrichment --checkpoint-dir
   --metadata-db`` on the card, SIGTERM once its first batch is on the
   predictions topic, then the same command until the group's lag is 0 and
   SIGTERM again; ``alert-router --once``. Gates: both summaries say
   ``stopped_by: SIGTERM``, the restart resumed from the first run's final
   checkpoint and skipped no duplicate, the first run stopped mid-stream;
   each of the 1,024 ids once on the predictions and on the enriched topic;
   each enriched ``ensemble_score`` equal to its prediction's ``fraud_score``
   and its ``fraud_score`` within 1e-6 of ``blend_enrichment``'s CPU version
   on the features topic's vector; the routed alerts equal the alerts topic
   and the predictions above 0.7; the summaries' fired windows equal the
   analytics topics; the sqlite store holds the job FINISHED with its
   checkpoints; every batch of both runs dispatched the megakernel, no
   fallback.
20. shared state and Kafka: (a) a ``state-server`` process on a free port
   (the port's ``MiniRedisServer``); phase 8's two streams (the first 1,024
   TINY under ``mega()``, 512 DistilBERT-base under ``full()``, int8 BERT,
   batches of
   256, depth 2) each three ways, the server flushed before each shared
   run: on the card with ``TorchFraudScorer(state_client=RespClient(...))``
   (launch counters reset just before, read just after: one megakernel a
   TINY batch, 1 / 6 / 36 / 2 a DistilBERT-base batch; the client's commands
   counted by a spy on its ``execute``), on the card with in-process stores,
   and the first batch's records on the CPU through the shared tier
   (untimed, after (c)). The shared run against the other two within the
   drill's bound, decisions equal off a rung, and whether it
   is identical to the in-process run; the server's keyspace against the
   in-process stores: every ``velocity:{user}:{window}`` count and amount,
   a ``transaction:{id}`` for every id, every ``user_transactions:{user}``
   list. Prints txn/s and batch p50 / p99 shared and local, the assembly's
   and the write-back's host ms a batch (and the slowest write-back), the
   garbage collector's ms in each run (garbage is collected before each),
   the RESP commands a batch, and first the microseconds of a RESP ``PING``
   round trip and of a one-byte TCP echo on this host's loopback. The parts
   run one after another: (a) on the card, (b), (c), (a)'s CPU runs, (d).
   (b) the TINY
   stream produced by user through ``KafkaBroker(idempotent=True,
   compression="gzip")`` into the port's ``FakeKafkaServer``; two
   ``StreamJob``s on two threads, each with its own ``mega()`` scorer,
   ``RespClient`` and Kafka client, group-managed consumers in one group
   (session 1.5 s), sharing a ``state-server --aof`` process; replica A
   dies after three completed batches (its next completion raises; its
   sockets close, no LeaveGroup) and B takes its partitions after the
   coordinator evicts it. Gates: each of the 2,048 ids on the predictions
   topic, scored once; the group's lag 0; every user's ``24hour`` count on
   the server equals the stream's; every repeat on the predictions topic a
   re-emission from the shared cache (B's other skipped duplicates were
   re-polled after the rebalance while their batch was in flight, and that
   batch emits them once: printed, with whether B's duplicates equal the
   repeats); every batch of two or more rows of both replicas one
   megakernel launch of its own scorer, a one-row batch the counted
   fallback; the server killed (SIGKILL) and restarted from its AOF with
   the same keyspace digest. Then the first 512 transactions through one
   replica over a fresh fake on the card, on the CPU and on the in-memory
   broker: the same batches on the card and the CPU, the predictions within
   the bound, whether the batches equal the in-memory broker's. Prints the
   rebalance seconds, the duplicates and the replicas' batches. (c) each a
   process of its own, the refused command started beside the job and the
   service after it: ``state-server --aof``, ``run-job --state --count
   512 --quant --mega --predictions-out`` on the card (every user's
   ``24hour`` count equals the stream's), ``serve --quant --mega`` with
   ``RTFD_STATE_ADDR`` and no ``--state`` (256 ``/predict`` from 64
   clients for users of the stream: each count rises by that user's
   requests; its standard error names the state tier), ``kill -9`` of the
   server and its restart from the AOF (the counts hold), and ``run-job
   --state ... --checkpoint-dir`` exits 2 with its reason. (d) the native
   tree scorer built from ``native/trees.cpp`` with g++ on this machine:
   its logits on (a)'s in-process TINY run's 1,024 feature rows within 1e-5
   of the plain tree path on the card.

21. the device pool and the partition-parallel fleet: (a) ``pool-drill
   --devices 4`` as a command on the card (its replicas share the card, each
   on its own stream; every check must pass); phase 8's TINY ``mega()``
   stream (its first 1,024, int8 BERT, batches of 256) through ``StreamJob`` with the
   device pool three ways: every visible card (a pool of one), 2 and 4
   replicas on the one card (launch counters reset just before, read just
   after: one megakernel launch a batch), each run in turns with the
   unpooled job at the same in-flight window (pooled, unpooled, unpooled,
   pooled, garbage collected before each): every prediction bit-equal, in
   the same order; txn/s and batch p50 / p99 of each run printed, and the
   replicas' dispatches and queue wait; the DistilBERT-base ``full()`` leg:
   4 batches of 256 through 2 replicas, all in flight, in turns with the
   unpooled scorer, bit-equal, 1 / 6 / 36 / 2 launches a batch. (b) on 2 replicas, each against
   the same pool without the fault: ``DeviceReplicaDeath`` on replica 0 for
   dispatched batches 6-10 with the job's window pinned at 2 (each id once,
   the predictions bit-equal in order, one retry, one failure, the replica
   revived, one extra megakernel launch), ``SlowDevice`` (50 ms on two
   fetches of replica 0: the predictions bit-equal in order, no retry); a
   ``set_models`` swap at batch 8 of 16 on 4 replicas with 8 batches in
   flight: each batch wholly equal to the unpooled scorer on the old models
   or on the new ones. (c) ``WorkerFleet`` of 4 ``TorchFraudScorer`` workers
   over their ``PartitionedStore``s on the card (``mega()``, int8 BERT, the
   GNN branch off in the blend: the bipartite graph is scorer-local in both
   packages), on the shard drill's timeline (``cluster/drill.py
   run_fleet``: 4,096 transactions, 12 partitions, batches closed at 128 or
   25 virtual ms, ``WorkerKill`` at 45%): each id scored once, the committed
   offsets gap free, every batch only its worker's partitions, every batch
   of 2+ rows one megakernel launch; an unsharded scorer replaying the
   fleet's batches (its cuts) in the fleet's order: fraud_score within the
   drill's 1e-4 floor, decisions equal off the cuts; handoffs and replay
   depth printed. (d) ``serve --quant --mega --device-pool`` with
   ``cluster.enabled`` as worker w0 of two, beside a plain ``serve --quant
   --mega``, each a process on the card: 64 ``/predict`` for distinct users
   w0 owns, one at a time, answered alike by both; foreign users' 421 with
   the owner, its address and the partition; ``/cluster``; the ``cluster_*``
   and ``device_pool_*`` series (64 dispatches on ``cuda:0#0``); SIGTERM,
   all exit 0.

22. the process fleet and the chaos plane: (a) three runs of the fast
   timeline at once, each on 2 replicas on the card: ``chaos-drill --fast
   --no-replay`` as a command (every check), ``run_chaos_drill`` with the
   kernels off in a process of its own, and ``run_chaos_drill`` in this
   process with ``KernelSettings(enabled=True, megakernel="cuda",
   epilogue="cuda")`` (launch counters reset just before, read just after;
   the kernels-off process launches none): every check passes in all; with the kernels
   on, each batch the megakernel's plan takes (every batch of 2+ rows) one
   megakernel launch on the launching thread and nothing else, each batch
   it declines one epilogue launch, one more for each rescue; decisions
   equal to the kernels-off run on every id scored before the first
   promotion (the flips and the largest score gap after it printed); the
   command's digest equal to the kernels-off run's (the replay, a second
   fully fresh run, bit-identical). (b) once (a) has ended, ``elastic-drill --fast`` and then ``partition-drill
   --fast`` as commands, each with nothing else running (their checks read
   the wall clock): every check passes (``processes_enough``,
   ``sigkill_real`` among them), and no ``cluster-worker`` process (from
   /proc) is ever among ``nvidia-smi --query-compute-apps=pid``, sampled
   every 0.5 s, each worker's environment hides the card
   (``CUDA_VISIBLE_DEVICES`` empty), and the card never lists more than
   this process. (c) in phase 21(d)'s processes, with worker w1 a clustered
   ``serve`` too: ``ShardIngressClient`` with both workers' URLs sends 64
   ``/predict`` for fresh users of both, each answer equal to the plain
   service's, the 421s followed printed; a second pass for the same users
   follows none.

23. the entity-graph plane and the distributed obs drill: (a) ``graph-drill
   --fast`` as a command on the card, started with (b) and finished after
   it (so it runs beside (b)'s in-process runs): every check
   against the port's CPU verdict (``GRAPH_CPU_CHECKS``, which
   ``tests/test_torch_graph_drill.py`` pins: every check true), the replay
   bit-identical on the card; the ring lift, the remote fetches and nodes,
   the degraded batches in and before the netfault window, the makespan and
   the command's seconds printed. (b) the drill's models trained on the card
   (``_train_models``), then the fast timeline's ``_run_fleet`` in process
   twice, kernels off and then with ``KernelSettings(enabled=True,
   epilogue="cuda", megakernel="cuda")`` (launch counters reset just
   before, read just after, the launching thread's own count too): each
   batch one epilogue launch and nothing else, the megakernel's plan asked
   and declined once a batch (every typed batch carries a two-hop
   frontier); decisions equal to the kernels-off run on every id farther
   than the drill's 1e-4 floor from a rung (the rows near one printed), the
   largest score gap within the floor; both runs fetch remotely and degrade
   only inside the window. (c) once (a) and (b) have ended, with nothing
   else running, ``obs-drill --fast --no-replay --rings-out D`` as a
   command: every check passes (one retry allowed when only its wall-clock
   checks failed, as JAX's test allows; printed), no ``cluster-worker`` on
   the card as in 22(b); then ``trace-export --merge D/*``: one named track
   a worker process plus ``ingress``, and as many flow starts as the
   drill's ``flow_arrows``.

24. the mesh plane on 8 positions of the card (``["cuda:0"] * 8``, each
   with its own stream; data 4 x model 2). (a), (b) and (c) run in a
   process of their own (``MESH_CHILD``) that turns cuBLAS's
   split-K off before its first product (``core/precision.py
   batch_invariant_blas``, as ``mesh-drill`` and a meshed ``serve`` do; a
   ``MeshExecutor`` on the card refuses to start without it; this process
   keeps cuBLAS's defaults). It runs (a) and (c), started with (d) just
   before phase 17 and run beside it (no check of theirs or of phase 17
   reads a clock, but phase 17's seconds are taken with the card shared),
   then, once phase 17 and (d) have ended and this process waits, (b)
   alone on the card; its launch counts (reset just before each path, read
   just after) come back then, with a bf16 cuBLAS product's time at
   M=16384 with split-K off beside this process's time for it with the
   defaults. (a)
   ``run_mesh_drill`` (``MeshDrillConfig.fast()`` at batch 256, so 64-row
   data shards against the 256-row single-position reference) with the
   kernels off, on ``full()`` and on ``mega()`` (with its bit-identical
   replay): every check of every run (bit-equality of all six placements,
   every rung, the hot swap, FIFO, the BERT bytes a position stores at most
   60% of the replicated branch), each combo's launches a mesh batch equal
   to its data axis times the single position's, only the run's kernels
   launched; then one seeded bucket-256 TINY int8 batch on a mesh storing
   every neural branch split, with ``full()`` and ``mega()``: within the
   drill's noise bound of the kernels-off mesh, no decision flip off a
   rung, bit-equal to one position, launches 4 x one position's. (c) at
   TINY width, against the single-position versions: ``ring_attention`` at
   seq 4 (2e-5), ``moe_ffn`` (2e-5), ``bert_pipeline_encode`` through the
   flash kernel (2e-3; 40 launches: 8 positions x 5 ticks), the DP + TP
   train step's loss (rtol 2e-4). (d) ``parallel/train.py
   run_two_process_step`` (two ``gloo`` processes, 2 positions each on the
   card): each process's loss within 1e-4 of one process's on the same
   global batch, its packed fused scores within 2e-5 / 2e-6, its global
   batch its own blocks. (b) DistilBERT-base ``full()`` through
   ``ServingApp`` unmeshed and with ``mesh.enabled`` (data 4 x model 2,
   ``shard_branches=["bert_text"]``) in turns after an untimed warm-up
   batch through each, 4 ``/batch-predict`` of 256 each, both sides with
   split-K off: decisions equal on every id, scores
   equal (gap 0: the 64-row shards' rows are the 256-row batch's), each
   meshed batch 4 x the 45-launch chain, ``/model-info``'s geometry; txn/s
   and batch p50 / p99 at the client for each run.

The last three lines of standard output are the kernel JSON line (all five
kernels), the ``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys
import time

import torch

# the card's published peaks (H100 SXM data sheet, dense): the roofline
# denominators of every bound_ms below
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

SEED = 0
BATCH = 256
MEGA_BUCKETS = (8, 32, 128, 256)
MEGA_TIMED_BATCHES = 50
# every end-to-end comparison (served bf16 path against the kernels-off plain
# path, the card against the CPU, the megakernel against its plain version)
# is held to the bound the port's kernel drill measures on the card for that
# configuration (``noise_bound``); these are the rows the previous fixed
# tolerance left unchecked near a rung on the same streams, printed beside
# the new counts
OLD_SKIPPED = {"TINY": "154/4096", "DistilBERT-base": "43/1024"}
# per-kernel tolerances (the reference's own, docs/kernels.md)
EPILOGUE_TOL = 1e-6
ATTENTION_TOL = 5e-5
DEQUANT_F32_TOL = 1e-5
DEQUANT_BF16_TOL = 2.0 ** -7     # one bf16 ulp of the output scale


def fail(msg: str) -> None:
    raise RuntimeError(msg)


@functools.lru_cache(maxsize=None)
def seeded_models(bert_config):
    """The seeded random model set of a width, on the host (built once; the
    scorers copy it to their device)."""
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import init_scoring_models

    return init_scoring_models(SEED, bert_config)


def bound(bytes_moved: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def noise_bound(models, bert_config, tokens, weights, valid=(True,) * 5) -> float:
    """The port's kernel drill's bf16 noise bound (``scoring/kernel_drill.py
    _noise_floor``) for these models on the card: BERT at bf16 against f32 on
    ``tokens`` ((ids, mask) pairs), times its blend share under ``valid``,
    floored at 1e-4."""
    from realtime_fraud_detection_tpu_torch.scoring.kernel_drill import _noise_floor

    return _noise_floor(models, bert_config, tokens, weights, valid)["bound"]


def near_rung(values, rungs, tol):
    """bool mask of values within ``tol`` of any rung."""
    near = torch.zeros_like(values, dtype=torch.bool)
    for r in rungs:
        near |= (values - r).abs() <= tol
    return near


def check_epilogue(params, gen):
    """The packed epilogue against its plain version on the main path's
    operands (bucket 256, five models, the last 16 rows padding), for the
    three strategies and two rungs, and once more through the JAX API's
    per-row mask; its device time beside an empty kernel on its grid; the
    wrapper's host ms per call; the chain tail's launches (``chain_tail``)."""
    from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
    from realtime_fraud_detection_tpu_torch.ops.build import check_launch, kernel_library
    from realtime_fraud_detection_tpu_torch.ops.epilogue import (
        EpilogueArgs,
        epilogue_matrix,
        epilogue_matrix_reference,
        epilogue_packed,
        epilogue_packed_reference,
        packed_columns,
    )

    if kernel_library().rtfd_epilogue_args_bytes() != ctypes.sizeof(EpilogueArgs):
        fail("EpilogueArgs: the ctypes mirror and the kernel's struct differ in size")
    dev = "cuda"
    b, m = BATCH, 5
    cols = packed_columns(m)
    ladders = [2, 3, cols["rule_ladder"].start, cols["rule_ladder"].start + 1]
    values = [c for c in range(2 * m + 10) if c not in ladders]
    preds = torch.rand((b, m), generator=gen, device=dev)
    rule = torch.rand((b,), generator=gen, device=dev)
    row_valid = torch.ones(b, dtype=torch.bool, device=dev)
    row_valid[-16:] = False
    per_row = torch.rand((b, m), generator=gen, device=dev) < 0.75
    worst = 0.0
    for strategy in (0, 1, 2):
        params.strategy = strategy
        for rung in ((True,) * m, (True, True, False, True, True)):
            got = epilogue_packed(preds, rule, params, model_valid=rung,
                                  row_valid=row_valid)
            ref = epilogue_packed_reference(preds, rule, params, model_valid=rung,
                                            row_valid=row_valid)
            torch.cuda.synchronize()
            err = float((got[:, values] - ref[:, values]).abs().max())
            if not err <= EPILOGUE_TOL:
                fail(f"epilogue strategy {strategy} rung {rung}: err {err}")
            if not torch.equal(got[:, ladders], ref[:, ladders]):
                fail(f"epilogue strategy {strategy} rung {rung}: ladder mismatch")
            worst = max(worst, err)
        got = epilogue_matrix(preds, per_row, rule, params)
        ref = epilogue_matrix_reference(preds, per_row, rule, params)
        torch.cuda.synchronize()
        err = float((got[:, [0, 1]] - ref[:, [0, 1]]).abs().max())
        if not err <= EPILOGUE_TOL or not torch.equal(got[:, [2, 3, 4 + m, 5 + m]],
                                                     ref[:, [2, 3, 4 + m, 5 + m]]):
            fail(f"epilogue_matrix strategy {strategy}: err {err} or a ladder differs")
        worst = max(worst, err)
    params.strategy = 0
    # the element-by-element store path: an even M (its row width is no
    # multiple of 4), and the packed columns inside a wider matrix
    four = EnsembleParams(weights=params.weights[:4] / params.weights[:4].sum(),
                          confidence_multipliers=params.confidence_multipliers[:4])
    wide = torch.zeros((b, 2 * m + 14), device=dev)
    for got, ref in ((epilogue_packed(preds[:, :4].contiguous(), rule, four,
                                      row_valid=row_valid),
                      epilogue_packed_reference(preds[:, :4].contiguous(), rule, four,
                                                row_valid=row_valid)),
                     (epilogue_packed(preds, rule, params, row_valid=row_valid,
                                      out=wide[:, 2:]),
                      epilogue_packed_reference(preds, rule, params,
                                                row_valid=row_valid))):
        torch.cuda.synchronize()
        got = got[:, :ref.shape[1]]
        if not (torch.equal(got[:, [2, 3, -2, -1]], ref[:, [2, 3, -2, -1]])
                and float((got - ref).abs().max()) <= EPILOGUE_TOL):
            fail(f"epilogue element-by-element path ({ref.shape[1]} columns) differs")
    if wide[:, :2].any() or wide[:, 2 + 2 * m + 10:].any():
        fail("epilogue wrote outside its columns of a wider matrix")
    host_valid = torch.ones(m, dtype=torch.bool)

    def call():
        epilogue_packed(preds, rule, params, model_valid=host_valid, row_valid=row_valid)

    ms = time_ms(call)
    dev = event_vs_device("epilogue", ms, call)
    # the launch floor: an empty kernel of the same build on the same grid
    lib, stream = kernel_library(), torch.cuda.current_stream().cuda_stream

    def empty():
        check_launch("empty kernel", lib.rtfd_empty(b, stream))

    empty_ms = time_ms(empty)
    empty_dev = event_vs_device("empty kernel (epilogue grid)", empty_ms, empty)
    host_ms = host_ms_per_call(call)
    print(f"  epilogue device {dev:.5f} ms per launch against an empty launch "
          f"{empty_dev:.5f} ms ({dev / empty_dev:.2f}x); wrapper host "
          f"{host_ms:.4f} ms per call", flush=True)
    tail_stats = chain_tail()
    print(f"  chain tail at DistilBERT-base bucket {BATCH} (branches precomputed): "
          f"{tail_stats['launches']:.0f} launches, {tail_stats['device_ms']:.4f} ms "
          f"device, {tail_stats['host_ms']:.4f} ms host: "
          + json.dumps(tail_stats["kernels"]), flush=True)
    plain = time_ms(lambda: epilogue_packed_reference(
        preds, rule, params, model_valid=host_valid, row_valid=row_valid))
    # each input read once (preds, rule, one validity byte a row), each
    # column the function produces written once (not the three key-factor
    # columns, which the caller writes); weights and thresholds ride in the
    # launch
    n_bytes = (b * m + b) * 4 + b + b * (2 * m + 7) * 4
    bound_ms, by = bound(n_bytes, b * (12 * m + 20), "f32")
    return dict(name="epilogue", route="cuda",
                source="realtime_fraud_detection_tpu_torch/csrc/epilogue.cu",
                replaces="realtime_fraud_detection_tpu/ops/epilogue.py:194",
                max_abs_err=worst, ms=ms, device_ms=dev, empty_ms=empty_ms,
                empty_device_ms=empty_dev, host_ms=host_ms,
                tail_launches=tail_stats["launches"], plain_ms=plain,
                bound_ms=bound_ms, bound_by=by, library_ms=None,
                note="library_ms: no single PyTorch call blends and ladders")


def event_vs_device(name, event_ms, fn):
    """The profiler's device ms per call beside the CUDA-event ms; a gap of
    more than 20% means back-to-back calls are bound by host time."""
    dev_ms, _ = device_ms(fn)
    gap = abs(event_ms - dev_ms) / dev_ms
    flag = " -- events and device time disagree by more than 20%" if gap > 0.2 else ""
    print(f"  {name}: {event_ms:.4f} ms by events, {dev_ms:.4f} ms device time "
          f"per launch{flag}", flush=True)
    return dev_ms


def _attention_inputs(b, s, h, d, gen):
    """[B, S, H*D] projections viewed as [B, H, S, D], as the encoder does,
    random key lengths and one fully masked row."""
    q, k, v = (torch.randn((b, s, h * d), generator=gen, device="cuda")
               .reshape(b, s, h, d).permute(0, 2, 1, 3) for _ in range(3))
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    mask = torch.arange(s, device="cuda")[None, :] < lengths[:, None]
    mask[0] = False
    return q, k, v, mask


def check_attention(cfg, gen):
    import torch.nn.functional as F

    from realtime_fraud_detection_tpu_torch.ops.attention import (
        attention_reference,
        flash_attention,
    )

    h, d = cfg.num_heads, cfg.head_dim
    worst = 0.0
    # the main path's S = 64, and an S that is not a multiple of the tile
    for b, s in ((BATCH, 64), (64, 100)):
        q, k, v, mask = _attention_inputs(b, s, h, d, gen)
        got = flash_attention(q, k, v, mask)
        ref = attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not err <= ATTENTION_TOL:
            fail(f"flash_attention B={b} S={s}: err {err}")
        if got.shape != (b, h, s, d) or got.permute(0, 2, 1, 3).stride() != (
                s * h * d, h * d, d, 1):
            fail(f"flash_attention output layout {got.shape} {got.stride()}")
        print(f"  flash_attention B={b} S={s} (row 0 fully masked): max err {err:.3e}",
              flush=True)
        worst = max(worst, err)
    q, k, v, mask = _attention_inputs(BATCH, 64, h, d, gen)
    s = 64
    ms = time_ms(lambda: flash_attention(q, k, v, mask))
    dev = event_vs_device("flash_attention", ms, lambda: flash_attention(q, k, v, mask))
    plain = time_ms(lambda: attention_reference(q, k, v, mask))
    attn_mask = mask[:, None, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask))
    n_bytes = 4 * BATCH * h * s * d * 4 + BATCH * s
    bound_ms, by = bound(n_bytes, 4 * BATCH * h * s * s * d, "f32")
    return dict(name="flash_attention", route="cuda",
                source="realtime_fraud_detection_tpu_torch/csrc/attention.cu",
                replaces="realtime_fraud_detection_tpu/ops/attention.py:75",
                max_abs_err=worst, ms=ms, device_ms=dev, plain_ms=plain,
                bound_ms=bound_ms, bound_by=by, library_ms=lib,
                note="library_ms: scaled_dot_product_attention, boolean mask")


def check_dequant_matmul(cfg, gen):
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.models.quant import quantize_dense
    from realtime_fraud_detection_tpu_torch.ops.dequant_matmul import (
        dequant_matmul,
        dequant_matmul_reference,
        dequantize_weight,
    )

    m = BATCH * 64
    hsz, ffn = cfg.hidden_size, cfg.intermediate_size
    # one encoder layer's six sites: q, k, v, o, ffn1, ffn2
    shapes = [(hsz, hsz)] * 4 + [(hsz, ffn), (ffn, hsz)]
    th, tf = TINY_CONFIG.hidden_size, TINY_CONFIG.intermediate_size
    # the TINY chain's widths; M = 64 is a bucket-1 batch (the fallback)
    checked_only = [(th, th), (th, tf), (tf, th)]
    per_shape = {}
    for kk, n in sorted(set(shapes)) + checked_only:
        w = torch.randn((kk, n), generator=gen) * 0.02
        qd = quantize_dense({"w": w, "b": torch.zeros(n)})
        qw = torch.from_numpy(qd["qw"]).cuda()
        scale = torch.from_numpy(qd["scale"]).cuda()
        b = (torch.randn((n,), generator=gen) * 0.02).cuda()
        x = torch.randn((m, kk), generator=gen).cuda()
        errs = {}
        for cd, tol, rows in ((torch.bfloat16, DEQUANT_BF16_TOL, m),
                              (torch.bfloat16, DEQUANT_BF16_TOL, 64),
                              (torch.float32, DEQUANT_F32_TOL, m)):
            got = dequant_matmul(x[:rows], qw, scale, b, compute_dtype=cd)
            ref = dequant_matmul_reference(x[:rows], qw, scale, b, cd)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            rel = err / max(1.0, float(ref.abs().max()))
            if not rel <= tol:
                fail(f"dequant_matmul [{rows},{kk}]x[{kk},{n}] {cd}: rel err {rel}")
            errs[(str(cd), rows)] = err
        print(f"  dequant_matmul {kk}x{n}: bf16 max err {errs[('torch.bfloat16', m)]:.3e}"
              f" at M={m}, {errs[('torch.bfloat16', 64)]:.3e} at M=64; f32 "
              f"{errs[('torch.float32', m)]:.3e}", flush=True)
        if (kk, n) in checked_only:
            continue
        w_bf16 = dequantize_weight(qw, scale).to(torch.bfloat16)
        x_bf16 = x.to(torch.bfloat16)
        n_bytes = m * kk * 4 + kk * n + 2 * n * 4 + m * n * 4
        bound_ms, by = bound(n_bytes, 2 * m * kk * n, "bf16")
        ms = time_ms(lambda: dequant_matmul(x, qw, scale, b))
        per_shape[(kk, n)] = dict(
            max_abs_err=max(errs[("torch.bfloat16", r)] for r in (m, 64)),
            f32_err=errs[("torch.float32", m)], ms=ms,
            device_ms=event_vs_device(f"dequant_matmul [{m},{kk}]x[{kk},{n}]", ms,
                                      lambda: dequant_matmul(x, qw, scale, b)),
            plain_ms=time_ms(lambda: dequant_matmul_reference(x, qw, scale, b)),
            library_ms=time_ms(lambda: torch.matmul(x_bf16, w_bf16)),
            bound_ms=bound_ms, bound_by=by)
        print(f"  dequant_matmul [{m},{kk}]x[{kk},{n}]: "
              + json.dumps(per_shape[(kk, n)]), flush=True)
    # per-launch means over one layer's six sites (the main path's mix)
    mean = {key: sum(per_shape[s][key] for s in shapes) / len(shapes)
            for key in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}
    by = "operations" if sum(per_shape[s]["bound_by"] == "operations"
                             for s in shapes) * 2 > len(shapes) else "bytes"
    return dict(name="dequant_matmul", route="cuda",
                source="realtime_fraud_detection_tpu_torch/csrc/dequant_matmul.cu",
                replaces="realtime_fraud_detection_tpu/ops/dequant_matmul.py:86",
                max_abs_err=max(p["max_abs_err"] for p in per_shape.values()),
                bound_by=by, **mean,
                note="times: means over one layer's six sites (4 x 768x768, "
                     "768x3072, 3072x768) at M=16384; library_ms: bf16 "
                     "torch.matmul on a pre-dequantized weight")


def check_dequant_rows(cfg, gen):
    from realtime_fraud_detection_tpu_torch.models.quant import quantize_embedding
    from realtime_fraud_detection_tpu_torch.ops.dequant_matmul import (
        dequant_rows,
        dequant_rows_reference,
    )

    import torch.nn.functional as F

    hsz = cfg.hidden_size
    word = quantize_embedding(torch.randn((cfg.vocab_size, hsz), generator=gen) * 0.02)
    pos = quantize_embedding(torch.randn((cfg.max_position_embeddings, hsz),
                                         generator=gen) * 0.02)
    sites = {}
    idx = torch.randint(0, cfg.vocab_size, (BATCH * 64,), generator=gen,
                        dtype=torch.int32).cuda()
    for site, table, ids, length in (("word", word, idx, None),
                                     ("position", pos, None, 64)):
        qe = torch.from_numpy(table["qe"]).cuda()
        sc = torch.from_numpy(table["scale"]).cuda()
        got = dequant_rows(qe, sc, idx=ids, length=length)
        ref = dequant_rows_reference(qe, sc, idx=ids, length=length)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"dequant_rows {site} site is not bit-exact")
        rows = ids.numel() if ids is not None else length
        needed = int(torch.unique(ids).numel()) if ids is not None else length
        n_bytes = (needed * hsz + needed * 4 + (rows * 4 if ids is not None else 0)
                   + rows * hsz * 4)
        bound_ms, by = bound(n_bytes, rows * hsz, "f32")
        table_f32 = qe.float() * sc[:, None]
        lookup = ids if ids is not None else torch.arange(length, device="cuda")

        def call():
            dequant_rows(qe, sc, idx=ids, length=length)

        ms = time_ms(call)
        sites[site] = dict(
            rows=rows, ms=ms, device_ms=event_vs_device(
                f"dequant_rows {site} site ({rows} rows)", ms, call),
            plain_ms=time_ms(lambda: dequant_rows_reference(
                qe, sc, idx=ids, length=length)),
            library_ms=time_ms(lambda: F.embedding(lookup, table_f32)),
            bound_ms=bound_ms, bound_by=by)
        print(f"  dequant_rows {site} site: " + json.dumps(sites[site]), flush=True)
    mean = {key: sum(s[key] for s in sites.values()) / len(sites)
            for key in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}
    return dict(name="dequant_rows", route="cuda",
                source="realtime_fraud_detection_tpu_torch/csrc/dequant_matmul.cu",
                replaces="realtime_fraud_detection_tpu/ops/dequant_matmul.py:141",
                max_abs_err=0.0, bound_by="bytes", **mean, sites=sites,
                note="times: means per launch over the word (16384 gathered "
                     "rows) and position (64 rows) sites, each site under "
                     "'sites'; library_ms: F.embedding on a pre-dequantized "
                     "f32 table")


def run_slice(ops):
    import numpy as np

    from realtime_fraud_detection_tpu_torch.models.bert import DISTILBERT_BASE
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
        make_example_batch,
        packed_width,
    )
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    models = seeded_models(DISTILBERT_BASE)
    kernels_on = TorchFraudScorer(
        Config(quant=QuantSettings.full(), kernels=KernelSettings.full()),
        models=models, bert_config=DISTILBERT_BASE, device="cuda")
    plain = TorchFraudScorer(
        Config(quant=QuantSettings.full()), models=models,
        bert_config=DISTILBERT_BASE, device="cuda")
    batch = make_example_batch(BATCH, rng=np.random.default_rng(SEED),
                               vocab_size=DISTILBERT_BASE.vocab_size)
    records = [{"transaction_id": f"txn-{i}"} for i in range(BATCH)]

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    pending = kernels_on.dispatch_assembled(batch, records)
    results = kernels_on.finalize(pending)
    launches = ops.launch_counts()
    expected = {"epilogue": 1, "flash_attention": DISTILBERT_BASE.num_layers,
                "dequant_matmul": 6 * DISTILBERT_BASE.num_layers,
                "dequant_rows": 2, "megakernel": 0}
    print(f"slice launches: {launches} (expected {expected})", flush=True)
    if launches != expected:
        fail(f"launch counts {launches} != {expected}")

    mat = pending.out.clone()
    if mat.shape != (BATCH, packed_width(5, epilogue=True)):
        fail(f"packed result shape {tuple(mat.shape)}")
    if not torch.isfinite(mat).all():
        fail("non-finite values in the packed result")
    if len(results) != BATCH or any(r["decision"] not in (
            "APPROVE", "APPROVE_WITH_MONITORING", "REVIEW", "DECLINE")
            for r in results):
        fail("malformed responses")

    ref_pending = plain.dispatch_assembled(batch, records)
    plain.finalize(ref_pending)
    ref = ref_pending.out
    tol = noise_bound(kernels_on.models, DISTILBERT_BASE,
                      [(batch.token_ids, batch.token_mask)],
                      kernels_on.ensemble_params.weights)
    prob_err = float((mat[:, 0] - ref[:, 0]).abs().max())
    if not prob_err <= tol:
        fail(f"slice probability err {prob_err} vs the plain path (bound {tol})")
    rungs = (0.3, 0.6, 0.8, 0.95, 0.7)
    far = ~(near_rung(ref[:, 0], rungs, tol) | near_rung(ref[:, 1], rungs, tol))
    if not torch.equal(mat[far][:, 2:4], ref[far][:, 2:4]):
        fail("slice decisions differ from the plain path")
    pred_err = float((mat[:, 8:13] - ref[:, 8:13]).abs().max())
    flips = int((mat[:, 2:4] != ref[:, 2:4]).any(dim=1).sum())
    print(f"slice vs plain path on the card: prob max err {prob_err:.3e}, "
          f"branch max err {pred_err:.3e}, decision/risk equal on all "
          f"{int(far.sum())} rows farther than the drill's bound {tol:.3e} from a "
          f"rung ({BATCH - int(far.sum())} skipped); rows differing anywhere: "
          f"{flips}/{BATCH}", flush=True)

    # small input: the card's kernels against the port's CPU path
    small = make_example_batch(8, rng=np.random.default_rng(SEED + 1),
                               vocab_size=DISTILBERT_BASE.vocab_size)
    cpu = TorchFraudScorer(
        Config(quant=QuantSettings.full(), kernels=KernelSettings.full()),
        models=models, bert_config=DISTILBERT_BASE, device="cpu")
    got = kernels_on.dispatch_assembled(small, records[:8])
    kernels_on.finalize(got)
    want = cpu.dispatch_assembled(small, records[:8])
    cpu.finalize(want)
    cpu_err = float((got.out[:, 0] - want.out[:, 0]).abs().max())
    small_tol = noise_bound(kernels_on.models, DISTILBERT_BASE,
                            [(small.token_ids, small.token_mask)],
                            kernels_on.ensemble_params.weights)
    if not cpu_err <= small_tol:
        fail(f"8-row batch: card vs CPU probability err {cpu_err} (bound {small_tol})")
    print(f"8-row batch, card kernels vs CPU plain path: prob max err "
          f"{cpu_err:.3e} (bound {small_tol:.3e})", flush=True)

    for _ in range(3):
        kernels_on.finalize(kernels_on.dispatch_assembled(batch, records))
    n_timed = 200
    lat = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        kernels_on.finalize(kernels_on.dispatch_assembled(batch, records))
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()

    def pct(q):
        return lat[min(len(lat) - 1, int(round(q * (len(lat) - 1))))]

    print(f"slice timing (bucket {BATCH}, DistilBERT-base, int8, kernels on, "
          f"{n_timed} batches after 3 warm-up): p50 {pct(0.5):.3f} ms, p95 "
          f"{pct(0.95):.3f} ms, p99 {pct(0.99):.3f} ms, "
          f"{BATCH * len(lat) / (sum(lat) / 1e3):.1f} txn/s", flush=True)
    profile_slice(kernels_on, batch, records)
    return launches


def _packed(batch, rows: int):
    """A host batch padded to its bucket and packed, on the card; the
    kernel's u8-view batch and the plain version's bool batch."""
    import dataclasses

    from realtime_fraud_detection_tpu_torch.core.batching import pad_to_bucket
    from realtime_fraud_detection_tpu_torch.core.packing import pack_tree, unpack_tree

    padded, mask, _ = pad_to_bucket(batch, rows)
    blobs, spec = pack_tree(dataclasses.replace(padded, valid=mask))
    dev = {k: torch.from_numpy(v).cuda() for k, v in blobs.items()}
    return dev, spec, unpack_tree(dev, spec, keep_u8=True), unpack_tree(dev, spec)


def mega_flops(models, cfg, batch) -> float:
    """Products the megakernel needs for ``batch`` (multiply-adds x 2): BERT
    with the last layer at [CLS] only, the LSTM's valid steps, the GNN and
    the heads; tree descents are compares."""
    s, h, f = int(batch.token_ids.shape[1]), cfg.hidden_size, cfg.intermediate_size
    heads, hd = cfg.num_heads, cfg.head_dim
    full_layer = 4 * s * h * h + 2 * s * h * f + heads * 2 * s * s * hd
    last_layer = 2 * s * h * h + 2 * h * h + heads * 2 * s * hd + 2 * h * f
    bert = (cfg.num_layers - 1) * full_layer + last_layer + h * h + 2 * h
    w = models.lstm["w_gates"]
    steps = int(batch.history_len.clamp(0, batch.history.shape[1]).sum())
    lstm_head = models.lstm["w_head1"].numel() + models.lstm["w_head2"].numel()
    g = models.gnn["w_sage1"].shape[1]
    k, d = batch.user_neigh_feat.shape[1:]
    gnn = (2 * k * d * g + 2 * models.gnn["w_sage2"].numel()
           + models.gnn["w_head1"].numel() + models.gnn["w_head2"].numel())
    b = int(batch.features.shape[0])
    return 2.0 * (b * (bert + lstm_head + gnn) + steps * w.numel())


def mega_models():
    """TINY models on the card from the seed: int8 BERT and f32 BERT."""
    import dataclasses

    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.models.quant import quantize_bert_params

    base = seeded_models(TINY_CONFIG)
    int8 = dataclasses.replace(base, bert=quantize_bert_params(base.bert)).to("cuda")
    return int8, base.to("cuda")


def mega_batch(rows: int):
    """The seeded ``rows``-row batch, packed on the card (see ``_packed``)."""
    import numpy as np

    from realtime_fraud_detection_tpu_torch.scoring.pipeline import make_example_batch

    batch = make_example_batch(rows, rng=np.random.default_rng(SEED + rows))
    return (batch, *_packed(batch, rows))


def host_ms_per_call(fn, reps: int = 50) -> float:
    """Host ms a call takes to return (the wrapper's checks, its argument
    fill and the launch), without waiting for the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return host


MEGA_BRANCHES = ("trees", "lstm", "bert", "gnn", "iforest")


def time_megakernel(params, models, cases) -> dict:
    """The megakernel at TINY int8 for each ``cases[rows] = (blobs, spec,
    raw)`` batch: CUDA-event ms, the profiler's device ms per launch, and
    the host ms per call (without waiting for the device) of the public
    wrapper on an unpacked batch, which builds the parameter arguments each
    call, and of the scorer's entry on the packed blobs
    (``score_fused_packed`` with the megakernel and the arguments built
    once, as ``TorchFraudScorer`` passes them); at the largest bucket also
    the device ms with one branch on at a time (the others pruned), and
    with none (rules + combine)."""
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.ops import megakernel as mk
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import score_fused_packed

    valid = torch.ones(5, dtype=torch.bool, device="cuda")

    def call(raw, rung=(True,) * 5):
        mk.fused_megakernel(models, raw, params, mega_valid=rung,
                            bert_config=TINY_CONFIG)

    def packed(blobs, spec, param_args):
        score_fused_packed(models, blobs, spec, params, valid, bert_config=TINY_CONFIG,
                           megakernel="cuda", mega_valid=(True,) * 5,
                           param_args=param_args)

    out = {}
    for rows, (blobs, spec, raw) in sorted(cases.items()):
        param_args = mk.MegaParamArgs(models, TINY_CONFIG, torch.bfloat16,
                                      mk._packed_layout(spec)[1], raw.features.device)
        ms = time_ms(lambda: call(raw))
        out[f"b{rows}"] = dict(
            ms=ms, device_ms=event_vs_device(f"megakernel TINY int8 b={rows}", ms,
                                             lambda: call(raw)),
            host_ms=host_ms_per_call(lambda: call(raw)),
            packed_host_ms=host_ms_per_call(lambda: packed(blobs, spec, param_args)))
    raw = cases[max(cases)][2]
    by_branch = {}
    for j, branch in enumerate(MEGA_BRANCHES + ("rules+combine",)):
        rung = tuple(i == j for i in range(5))
        by_branch[branch] = device_ms(lambda: call(raw, rung))[0]
    out[f"b{max(cases)}_device_ms_one_branch_on"] = by_branch
    print("  megakernel timing: " + json.dumps(out), flush=True)
    return out


def check_megakernel(params):
    """The megakernel against its plain version at TINY width (int8 BERT at
    buckets 256 and 8, f32 BERT at 256), its smem count against the plan,
    and its time against the per-site chain's on the same batch."""
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.ops import megakernel as mk
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import score_fused_packed
    from realtime_fraud_detection_tpu_torch.utils.config import (
        KernelSettings,
        QuantSettings,
    )

    int8, f32 = mega_models()
    worst = 0.0
    timed = None
    cases = {}
    # (f32 weights compute in bf16 as served; "int8 f32-compute" runs the
    # kernel's f32-compute path, which a scorer built with f32 compute takes)
    for name, models, rows, cd in (("int8", int8, BATCH, torch.bfloat16),
                                   ("int8", int8, 8, torch.bfloat16),
                                   ("f32", f32, BATCH, torch.bfloat16),
                                   ("int8 f32-compute", int8, BATCH, torch.float32)):
        batch, dev, spec, raw, plain_batch = mega_batch(rows)
        plan = mk.mega_plan(models, TINY_CONFIG, b=rows, text_len=64, seq_len=10,
                            feature_dim=64, has_two_hop=False)
        if not plan["supported"]:
            fail(f"megakernel plan declines TINY {name} at {rows}: {plan}")
        for mv in ((True,) * 5, (True, True, False, True, True)):
            got = mk.fused_megakernel(models, raw, params, mega_valid=mv,
                                      bert_config=TINY_CONFIG, compute_dtype=cd)
            ref = mk.megakernel_reference(models, plain_batch, params, mega_valid=mv,
                                          bert_config=TINY_CONFIG, compute_dtype=cd)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            tol = noise_bound(models, TINY_CONFIG, [(batch.token_ids, batch.token_mask)],
                              params.weights, mv)
            if not err <= tol:
                fail(f"megakernel TINY {name} b={rows} mv={mv}: err {err} (bound {tol})")
            far = ~(near_rung(ref[:, 0], (0.3, 0.6, 0.8, 0.95), tol)
                    | near_rung(ref[:, 1], (0.7,), tol))
            if not torch.equal(got[far][:, [2, 3, 18, 19]], ref[far][:, [2, 3, 18, 19]]):
                fail(f"megakernel TINY {name} b={rows} mv={mv}: ladder mismatch")
            pruned = [8 + j for j, on in enumerate(mv) if not on]
            if pruned and bool(got[:, pruned].any()):
                fail("megakernel: a pruned lane is not zero")
            worst = max(worst, err)
            print(f"  megakernel TINY {name} b={rows} rung {''.join('1' if v else '0' for v in mv)}:"
                  f" max err {err:.3e} (bound {tol:.3e}), ladders equal on "
                  f"{int(far.sum())}/{rows} rows away from a rung", flush=True)
        if name == "int8":
            cases[rows] = (dev, spec, raw)
        if name != "int8":
            case_ms = time_ms(lambda: mk.fused_megakernel(
                models, raw, params, mega_valid=(True,) * 5, bert_config=TINY_CONFIG,
                compute_dtype=cd))
            print(f"  megakernel TINY {name} b={rows}: {case_ms:.4f} ms", flush=True)
        if name == "int8" and rows == BATCH:
            args_smem = _kernel_smem(mk, models, raw, TINY_CONFIG)
            if args_smem != plan["smem_bytes"]:
                fail(f"megakernel smem: kernel {args_smem} != plan {plan['smem_bytes']}")
            timed = (models, batch, dev, spec, raw, plain_batch, plan)
    models, batch, dev, spec, raw, plain_batch, plan = timed
    mv = (True,) * 5
    timing = time_megakernel(params, models, cases)
    ms = timing[f"b{BATCH}"]["ms"]
    plain = time_ms(lambda: mk.megakernel_reference(
        models, plain_batch, params, mega_valid=mv, bert_config=TINY_CONFIG))
    chain_kw = dict(bert_config=TINY_CONFIG, **QuantSettings.full().static(),
                    **KernelSettings.full().static())
    valid = torch.ones(5, dtype=torch.bool, device="cuda")

    def chain():
        score_fused_packed(models, dev, spec, params, valid, **chain_kw)

    chain_ms = time_ms(chain)
    chain_device_ms, chain_launches = device_ms(chain)
    in_bytes = sum(t.numel() * t.element_size() for t in dev.values())
    n_bytes = plan["param_bytes"] + in_bytes + BATCH * 20 * 4
    flops = mega_flops(models, TINY_CONFIG, plain_batch)
    bound_ms, by = bound(n_bytes, flops, "bf16")
    print(f"  megakernel TINY int8 b={BATCH}: {ms:.4f} ms; per-site chain {chain_ms:.4f} ms"
          f" by events, {chain_device_ms:.4f} ms device busy in {chain_launches:.0f}"
          f" device launches; {flops / 1e9:.3f} GFLOP,"
          f" {n_bytes / 1e6:.3f} MB; plan {plan}", flush=True)
    return dict(name="megakernel", route="cuda",
                source="realtime_fraud_detection_tpu_torch/csrc/megakernel.cu",
                replaces="realtime_fraud_detection_tpu/ops/megakernel.py:363",
                max_abs_err=worst, ms=ms, device_ms=timing[f"b{BATCH}"]["device_ms"],
                plain_ms=plain, bound_ms=bound_ms, bound_by=by,
                library_ms=chain_device_ms, timing=timing,
                note="TINY int8 bucket 256; library_ms: the per-site chain's "
                     "device-busy ms on the same batch (no single PyTorch call)")


def _kernel_smem(mk, models, raw, cfg) -> int:
    """The kernel's own shared-memory count for these operands."""
    args = mk.MegaArgs()
    args.text_len, args.feat_dim = raw.token_ids.shape[1], raw.features.shape[1]
    args.seq_len = raw.history.shape[1]
    args.hidden, args.ffn = cfg.hidden_size, cfg.intermediate_size
    args.heads = cfg.num_heads
    args.node_dim = models.gnn["w_sage2"].shape[0] - models.gnn["w_sage1"].shape[1]
    args.lstm_hidden, args.lstm_head = models.lstm["w_head1"].shape
    args.fanout = raw.user_neigh_feat.shape[1]
    args.gnn_hidden = models.gnn["w_sage1"].shape[1]
    args.gnn_head = models.gnn["w_head1"].shape[1]
    args.n_trees = models.trees.leaf.shape[0]
    args.n_iforest = models.iforest.path_length.shape[0]
    return int(mk.kernel_library().rtfd_megakernel_smem_bytes(ctypes.addressof(args)))


def spun_ms(fn, spin_cycles: int = 4_000_000, tries: int = 4) -> tuple[float, int]:
    """Device ms of the work ``fn`` queues, by CUDA events behind a spin
    kernel (about 2 ms at H100 clocks): the card spins while the host fills
    the launch's arguments, so the start event fires with the kernel already
    queued. If the card passed the start event before ``fn`` returned, it
    waited on the host: retried with twice the spin. Returns the ms and the
    number of retries."""
    for retry in range(tries):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        late = start.query()
        end.record()
        end.synchronize()
        if not late:
            return start.elapsed_time(end), retry
        spin_cycles *= 2
    fail(f"spun_ms: the card reached the start event before the launch was "
         f"queued, {tries} times")


def device_events(fn, reps: int = 5, want: str | None = None,
                  tries: int = 3) -> list:
    """The profiler's device events (kernels and copies) over ``reps`` calls
    after one warm-up call. CUPTI drops device records now and then: a pass
    that saw no device time (or no kernel whose name holds ``want``) is
    profiled again, up to ``tries`` passes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if (sum(e.self_device_time_total for e in device) > 0
                and (want is None or any(want in e.key for e in device))):
            return device
    fail(f"the profiler saw no device time{f' in {want}' if want else ''} "
         f"in {tries} passes")


def device_ms(fn, reps: int = 5) -> tuple[float, float]:
    """Device-busy ms and device launches per call, summed over the
    kernels (and copies) the profiler records."""
    device = device_events(fn, reps)
    busy = sum(e.self_device_time_total for e in device)
    return busy / reps / 1e3, sum(e.count for e in device) / reps


TAIL_BRANCHES = ("tree_ensemble_predict", "lstm_logits", "bert_predict",
                 "gnn_logits", "iforest_predict")


def chain_tail(reps: int = 5) -> dict:
    """Launches, device ms and host ms of one ``score_fused_packed`` call at
    DistilBERT-base, bucket 256, under ``KernelSettings.full()``, with the
    batch unpacked and the five branch functions replaced by outputs
    computed beforehand: every launch from the branch stack to the packed
    result (the sigmoids on the LSTM and GNN logits included). The rung is
    a CPU bool tensor, as the scorer passes it. Uses only the pipeline's
    public entry, so it measures whichever package is imported."""
    import numpy as np

    from realtime_fraud_detection_tpu_torch.core.packing import pack_tree
    from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
    from realtime_fraud_detection_tpu_torch.models.bert import DISTILBERT_BASE
    from realtime_fraud_detection_tpu_torch.scoring import pipeline as pl
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    m = len(pl.MODEL_NAMES)
    params = EnsembleParams.from_config(Config(), pl.MODEL_NAMES).to("cuda")
    batch = pl.make_example_batch(BATCH, rng=np.random.default_rng(SEED),
                                  vocab_size=DISTILBERT_BASE.vocab_size)
    blobs, spec = pack_tree(batch)
    dev = {k: torch.from_numpy(v).cuda() for k, v in blobs.items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    stubs = {name: (lambda *a, _t=torch.rand((BATCH,), generator=gen, device="cuda"),
                    **k: _t) for name in TAIL_BRANCHES}
    unpacked = pl.unpack_tree(dev, spec)
    stubs["unpack_tree"] = lambda blobs, spec: unpacked
    saved = {name: getattr(pl, name) for name in stubs}
    models = pl.ScoringModels(**{f: None for f in pl.ScoringModels.__dataclass_fields__})
    model_valid = torch.ones(m, dtype=torch.bool)
    kw = dict(bert_config=DISTILBERT_BASE, **QuantSettings.full().static(),
              **KernelSettings.full().static())

    def call():
        return pl.score_fused_packed(models, dev, spec, params, model_valid, **kw)

    try:
        for name, fn in stubs.items():
            setattr(pl, name, fn)
        out = call()
        torch.cuda.synchronize()
        if tuple(out.shape) != (BATCH, pl.packed_width(m, epilogue=True)):
            fail(f"chain tail result shape {tuple(out.shape)}")
        events = device_events(call, reps)
        return dict(
            launches=sum(e.count for e in events) / reps,
            device_ms=sum(e.self_device_time_total for e in events) / reps / 1e3,
            host_ms=host_ms_per_call(call),
            kernels={e.key[:80]: e.count / reps for e in events})
    finally:
        for name, fn in saved.items():
            setattr(pl, name, fn)


def run_mega_slice(ops, params):
    """The megakernel slice and its honest fallbacks; returns the slice's
    launch counts."""
    import numpy as np

    from realtime_fraud_detection_tpu_torch.models.bert import DISTILBERT_BASE, TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
        make_example_batch,
        packed_width,
    )
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    models = seeded_models(TINY_CONFIG)
    mega = TorchFraudScorer(
        Config(quant=QuantSettings.full(), kernels=KernelSettings.mega()),
        models=models, bert_config=TINY_CONFIG, device="cuda")
    chain = TorchFraudScorer(
        Config(quant=QuantSettings.full(), kernels=KernelSettings.full()),
        models=models, bert_config=TINY_CONFIG, device="cuda")
    plain = TorchFraudScorer(Config(quant=QuantSettings.full()), models=models,
                             bert_config=TINY_CONFIG, device="cuda")
    batch = make_example_batch(BATCH, rng=np.random.default_rng(SEED + 7))
    records = [{"transaction_id": f"txn-{i}"} for i in range(BATCH)]

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    pending = mega.dispatch_assembled(batch, records)
    results = mega.finalize(pending)
    launches = ops.launch_counts()
    expected = {"epilogue": 0, "flash_attention": 0, "dequant_matmul": 0,
                "dequant_rows": 0, "megakernel": 1}
    print(f"mega slice launches: {launches} (expected {expected})", flush=True)
    if launches != expected:
        fail(f"mega slice launch counts {launches} != {expected}")
    snap = mega.kernel_snapshot()
    if (snap["dispatch"]["megakernel"], snap["fallback"]["megakernel"],
            snap["launches_per_batch"], snap["kernel_launches"]) != (1, 0, 1, 1):
        fail(f"mega slice kernel snapshot {snap}")
    mat = pending.out.clone()
    if mat.shape != (BATCH, packed_width(5, epilogue=True)) or not torch.isfinite(mat).all():
        fail(f"mega slice result: shape {tuple(mat.shape)} or non-finite values")
    if len(results) != BATCH:
        fail("mega slice: malformed responses")
    ref_pending = plain.dispatch_assembled(batch, records)
    plain.finalize(ref_pending)
    ref = ref_pending.out
    tol = noise_bound(mega.models, TINY_CONFIG, [(batch.token_ids, batch.token_mask)],
                      mega.ensemble_params.weights)
    prob_err = float((mat[:, 0] - ref[:, 0]).abs().max())
    if not prob_err <= tol:
        fail(f"mega slice probability err {prob_err} vs the plain path (bound {tol})")
    rungs = (0.3, 0.6, 0.8, 0.95, 0.7)
    far = ~(near_rung(ref[:, 0], rungs, tol) | near_rung(ref[:, 1], rungs, tol))
    if not torch.equal(mat[far][:, 2:4], ref[far][:, 2:4]):
        fail("mega slice decisions differ from the plain path")
    print(f"mega slice vs kernels-off plain path on the card: prob max err "
          f"{prob_err:.3e}, decision/risk equal on all {int(far.sum())} rows "
          f"farther than the drill's bound {tol:.3e} from a rung "
          f"({BATCH - int(far.sum())} skipped); snapshot {snap}", flush=True)

    # bucket 1: the plan declines, the per-site chain runs and is counted
    ops.reset_launch_counts()
    mega.finalize(mega.dispatch_assembled(
        make_example_batch(1, rng=np.random.default_rng(SEED + 1)), records[:1]))
    got = ops.launch_counts()
    want = {"epilogue": 1, "flash_attention": TINY_CONFIG.num_layers,
            "dequant_matmul": 6 * TINY_CONFIG.num_layers, "dequant_rows": 2,
            "megakernel": 0}
    snap = mega.kernel_snapshot()
    print(f"bucket-1 fallback launches: {got} (expected {want}); snapshot {snap}",
          flush=True)
    if (got != want or snap["fallback"]["megakernel"] != 1
            or snap["kernel_launches"] != sum(want.values())):
        fail("bucket-1 batch did not fall back honestly")

    # DistilBERT-base under mega(): 70 MB of int8 parameters, declined
    big = TorchFraudScorer(
        Config(quant=QuantSettings.full(), kernels=KernelSettings.mega()),
        models=seeded_models(DISTILBERT_BASE),
        bert_config=DISTILBERT_BASE, device="cuda")
    big_batch = make_example_batch(BATCH, rng=np.random.default_rng(SEED),
                                   vocab_size=DISTILBERT_BASE.vocab_size)
    ops.reset_launch_counts()
    big.finalize(big.dispatch_assembled(big_batch, records))
    got = ops.launch_counts()
    want = {"epilogue": 1, "flash_attention": DISTILBERT_BASE.num_layers,
            "dequant_matmul": 6 * DISTILBERT_BASE.num_layers, "dequant_rows": 2,
            "megakernel": 0}
    snap = big.kernel_snapshot()
    print(f"DistilBERT-base under mega(): launches {got} (expected {want}); "
          f"plan {big._mega_plan(BATCH)}; snapshot {snap}", flush=True)
    if (got != want or snap["fallback"]["megakernel"] != 1
            or snap["kernel_launches"] != sum(want.values())):
        fail("DistilBERT-base batch did not fall back honestly")
    del big

    time_mega_vs_chain(mega, chain, params)
    return launches


def time_mega_vs_chain(mega, chain, params):
    """p50 / p99 per batch and txn/s, host clock around dispatch + finalize,
    megakernel and chain interleaved batch by batch."""
    import numpy as np

    from realtime_fraud_detection_tpu_torch.scoring.pipeline import make_example_batch

    def pct(lat, q):
        return lat[min(len(lat) - 1, int(round(q * (len(lat) - 1))))]

    for rows in MEGA_BUCKETS:
        batch = make_example_batch(rows, rng=np.random.default_rng(SEED + rows))
        records = [{"transaction_id": f"txn-{i}"} for i in range(rows)]
        lat = {"mega": [], "chain": []}
        scorers = {"mega": mega, "chain": chain}
        for _ in range(3):
            for s in scorers.values():
                s.finalize(s.dispatch_assembled(batch, records))
        for _ in range(MEGA_TIMED_BATCHES):
            for name, s in scorers.items():
                t0 = time.perf_counter()
                s.finalize(s.dispatch_assembled(batch, records))
                lat[name].append((time.perf_counter() - t0) * 1e3)
        line = {}
        for name, xs in lat.items():
            xs.sort()
            line[name] = dict(p50_ms=pct(xs, 0.5), p99_ms=pct(xs, 0.99),
                              txn_per_s=rows * len(xs) / (sum(xs) / 1e3))
        if mega.kernel_snapshot()["launches_per_batch"] != 1:
            fail(f"bucket {rows}: the megakernel did not serve")
        print(f"mega vs chain, TINY int8, bucket {rows}, {MEGA_TIMED_BATCHES} batches "
              f"each after 3 warm-up: " + json.dumps(line), flush=True)


# the stream phase: the run-job defaults, a fixed virtual clock (the
# simulator's start, 2026-01-05 08:00 UTC), one batch of warm-up per stream
STREAM_USERS, STREAM_MERCHANTS = 10_000, 5_000
STREAM_NOW = 1_767_600_000.0
STREAM_WARMUP_BATCHES = 1
STREAM_PARTS = ("_build_responses", "_write_back", "_fan_out")


class StreamTimer:
    """Per-batch host timing of a ``StreamJob`` run, by wrapping the job's
    and the scorer's methods on the instances: dispatch to completion per
    batch, the hand-written launches of each batch, the smoke's own
    ``perf_counter`` around response building, write-back and fan-out, and
    inside ``assemble`` around the encoder, the feature extraction, the
    history ring, the text join and the tokenizer; plus the time the
    interpreter's garbage collector ran. The scorer's spans and these sums
    restart after the warm-up batches. ``close`` undoes the wrapping of the
    scorer module's functions and the collector callback."""

    ASSEMBLE_FUNCS = ("encode_transactions_columnar", "extract_features_host")

    def __init__(self, job, scorer, warmup: int = STREAM_WARMUP_BATCHES):
        import gc

        from realtime_fraud_detection_tpu_torch.scoring import scorer as scorer_module

        self.batches = []
        self.ctxs = []                  # the warm-up batches' contexts
        self.parts = {name: [] for name in STREAM_PARTS}
        self.inside = {name: [] for name in (
            *self.ASSEMBLE_FUNCS, "append_and_gather", "_texts_for", "encode_batch")}
        self.gc = {"ms": 0.0, "collections": [0, 0, 0]}
        self.warmup = warmup
        dispatch, complete = job.dispatch_batch, job.complete_batch

        def dispatch_batch(records, now=None):
            if len(self.batches) == warmup:
                if getattr(job, "_stage", None) is not None:
                    # overlapped assembly: let the warm-up batches' stage
                    # work finish before the spans restart
                    for ctx in self.ctxs:
                        if ctx.pending is not None:
                            ctx.pending.result()
                scorer.spans.reset()
                for xs in (*self.parts.values(), *self.inside.values()):
                    xs.clear()
                self.gc = {"ms": 0.0, "collections": [0, 0, 0]}
            t0 = time.perf_counter()
            ctx = dispatch(records, now=now)
            ctx.timing = dict(rows=len(ctx.fresh), t0=t0,
                              launches=scorer.kernel_snapshot()["kernel_launches"])
            self.batches.append(ctx.timing)
            if len(self.ctxs) < warmup:
                self.ctxs.append(ctx)
            return ctx

        def complete_batch(ctx):
            out = complete(ctx)
            ctx.timing["t1"] = time.perf_counter()
            return out

        job.dispatch_batch, job.complete_batch = dispatch_batch, complete_batch
        for owner, name in ((scorer, "_build_responses"), (scorer, "_write_back"),
                            (job, "_fan_out")):
            setattr(owner, name, self._timed(getattr(owner, name), self.parts[name]))
        for owner, name in ((scorer.history, "append_and_gather"),
                            (scorer, "_texts_for"), (scorer.tokenizer, "encode_batch")):
            setattr(owner, name, self._timed(getattr(owner, name), self.inside[name]))
        self._module = scorer_module
        self._saved = {name: getattr(scorer_module, name) for name in self.ASSEMBLE_FUNCS}
        for name, fn in self._saved.items():
            setattr(scorer_module, name, self._timed(fn, self.inside[name]))
        self._gc_t0 = None

        def on_gc(phase, info):
            if phase == "start":
                self._gc_t0 = time.perf_counter()
            elif self._gc_t0 is not None:
                self.gc["ms"] += (time.perf_counter() - self._gc_t0) * 1e3
                self.gc["collections"][info["generation"]] += 1

        self._on_gc = on_gc
        gc.callbacks.append(on_gc)

    def close(self) -> None:
        import gc

        for name, fn in self._saved.items():
            setattr(self._module, name, fn)
        gc.callbacks.remove(self._on_gc)

    @staticmethod
    def _timed(fn, sink):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sink.append((time.perf_counter() - t0) * 1e3)
        return wrapper

    def summary(self, scorer) -> dict:
        from realtime_fraud_detection_tpu_torch.obs.profiling import (
            interpolated_percentile,
        )

        timed = self.batches[self.warmup:]
        per_batch = [(b["t1"] - b["t0"]) * 1e3 for b in timed]
        lat = sorted(per_batch)
        span = timed[-1]["t1"] - timed[0]["t0"]
        stages = scorer.host_stats()["stages"]

        def mean(xs):
            return sum(xs) / len(xs)

        return {
            "timed_batches": len(timed), "warmup_batches": self.warmup,
            "txn_per_s": sum(b["rows"] for b in timed) / span,
            "batch_ms_p50": interpolated_percentile(lat, 0.5),
            "batch_ms_p99": interpolated_percentile(lat, 0.99),
            "batch_ms": per_batch,
            "host_ms_per_batch": {name: stages[name]["mean_ms"] for name in (
                "assemble", "graph", "pack", "dispatch", "device_wait")},
            "host_p50_ms_per_batch": {name: stages[name]["p50_ms"] for name in (
                "assemble", "graph", "pack", "dispatch", "device_wait")},
            "smoke_ms_per_batch": {k: mean(xs) for k, xs in self.parts.items()},
            "smoke_p50_ms_per_batch": {
                k: interpolated_percentile(sorted(xs), 0.5) for k, xs in self.parts.items()},
            "inside_assemble_ms_per_batch": {k: mean(xs) for k, xs in self.inside.items()},
            "gc_ms": self.gc["ms"], "gc_collections": self.gc["collections"],
        }


def drive_stream(records, profiles, bert_config, config, device, timed=False,
                 tokens=None, models=None, scorer_config=None, overlap=False,
                 texts=None, tracing=None, planes=False, hook=None, state_client=None,
                 broker=None):
    """The port's ``StreamJob`` over ``records`` on a fresh scorer (the
    width's seeded models unless ``models`` is given) and in-memory broker,
    at the fixed virtual clock; returns (job, broker, scorer, timer). With a
    ``tokens`` list, each batch's (ids, mask) is appended to it, with a
    ``texts`` list each batch's tokenizer input texts; with ``overlap`` the
    job runs the overlapped assembly stage (closed before this returns);
    ``tracing`` is the job's ``JobConfig.tracing``; ``planes`` turns on
    ``enable_analytics`` and ``enable_enrichment`` (the analytics flushed at
    the end); ``hook(job)`` runs once the job is built, before it runs;
    ``state_client`` puts the scorer on the shared RESP tier; ``broker``
    replaces the in-memory broker."""
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
    from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker

    scorer = TorchFraudScorer(config, models=models or seeded_models(bert_config),
                              scorer_config=scorer_config,
                              bert_config=bert_config, device=device,
                              state_client=state_client)
    scorer.seed_profiles(*profiles)
    if tokens is not None:
        assemble = scorer.assemble

        def keep_tokens(*args, **kwargs):
            batch = assemble(*args, **kwargs)
            tokens.append((batch.token_ids, batch.token_mask))
            return batch

        scorer.assemble = keep_tokens
    if texts is not None:
        texts_for = scorer._texts_for

        def keep_texts(*args, **kwargs):
            out = texts_for(*args, **kwargs)
            texts.append(out)
            return out

        scorer._texts_for = keep_texts
    broker = broker if broker is not None else InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(max_batch=BATCH, pipeline_depth=2,
                                              overlap_assembly=overlap,
                                              tracing=tracing, enable_analytics=planes,
                                              enable_enrichment=planes))
    broker.produce_batch(T.TRANSACTIONS, records, key_fn=lambda r: str(r["user_id"]))
    if hook is not None:
        hook(job)
    timer = StreamTimer(job, scorer) if timed else None
    try:
        job.run_until_drained(now=STREAM_NOW)
        if planes:
            job.analytics.flush()
    finally:
        job.close()
        if timer is not None:
            timer.close()
    return job, broker, scorer, timer


def topic_values(broker, topic):
    return [r.value for r in broker.consumer([topic], "smoke-check").poll(1 << 30)]


def check_stream_output(name, job, broker, records):
    """Every record scored once, no error, lag 0, and the predictions,
    enriched and features topics each hold the stream's ids once."""
    from collections import Counter

    from realtime_fraud_detection_tpu_torch.stream import topics as T

    want = Counter(r["transaction_id"] for r in records)
    if job.counters["scored"] != len(records) or job.counters["errors"]:
        fail(f"{name} stream: counters {job.counters}")
    if broker.lag(job.config.group_id, T.TRANSACTIONS):
        fail(f"{name} stream: lag {broker.lag(job.config.group_id, T.TRANSACTIONS)}")
    preds = topic_values(broker, T.PREDICTIONS)
    if any(p["explanation"].get("error") for p in preds):
        fail(f"{name} stream: a prediction carries an error")
    for topic in (T.PREDICTIONS, T.ENRICHED, T.FEATURES):
        if Counter(v["transaction_id"] for v in topic_values(broker, topic)) != want:
            fail(f"{name} stream: {topic} does not hold each id once")
    return preds


def compare_streams(name, preds, ref_preds, tol, label):
    """Ids in the same order; decisions and risk levels equal on every row
    whose reference probability and confidence lie farther than ``tol`` (the
    drill's bound) from a rung; fraud_score within ``tol``."""
    if [p["transaction_id"] for p in preds] != [p["transaction_id"] for p in ref_preds]:
        fail(f"{name} stream: ids differ from {label}")
    rungs = (0.3, 0.6, 0.8, 0.95, 0.7)
    prob = torch.tensor([p["fraud_probability"] for p in ref_preds], dtype=torch.float64)
    conf = torch.tensor([p["confidence"] for p in ref_preds], dtype=torch.float64)
    far = ~(near_rung(prob, rungs, tol) | near_rung(conf, rungs, tol))
    for p, q, ok in zip(preds, ref_preds, far.tolist()):
        if ok and (p["decision"], p["risk_level"]) != (q["decision"], q["risk_level"]):
            fail(f"{name} stream: {p['transaction_id']} {p['decision']}/"
                 f"{p['risk_level']} vs {label} {q['decision']}/{q['risk_level']}")
    err = max(abs(p["fraud_score"] - q["fraud_score"]) for p, q in zip(preds, ref_preds))
    if not err <= tol:
        fail(f"{name} stream: fraud_score err {err} vs {label}")
    old = (f" (under the former fixed tolerance: {OLD_SKIPPED[name]})"
           if name in OLD_SKIPPED else "")
    print(f"  {name} stream vs {label}: fraud_score max err {err:.3e}, decision and "
          f"risk equal on all {int(far.sum())}/{len(preds)} rows farther than the "
          f"drill's bound {tol:.3e} from a rung; {len(preds) - int(far.sum())}/"
          f"{len(preds)} skipped{old}", flush=True)
    return err


def run_stream(ops, name, bert_config, kernels, count, expected, cpu_reference,
               scorer_config=None):
    """The stream phase of one width: ``count`` simulator transactions
    through the port's ``StreamJob`` on the card (launch counters reset just
    before, read just after), checked, held against a kernels-off card
    scorer (and a CPU scorer) on the same stream, then the first batch
    re-produced. Returns the stream's launch counts, its timing summary, the
    card's scorer and each batch's tokens and tokenizer texts."""
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.utils.config import Config, QuantSettings

    gen = TransactionGenerator(num_users=STREAM_USERS, num_merchants=STREAM_MERCHANTS,
                               seed=SEED)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    records = gen.generate_batch(count)
    config = Config(quant=QuantSettings.full(), kernels=kernels)
    n_batches = count // BATCH

    card_tokens, texts = [], []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    job, broker, scorer, timer = drive_stream(records, profiles, bert_config, config,
                                              "cuda", timed=True, tokens=card_tokens,
                                              scorer_config=scorer_config, texts=texts)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {k: v * n_batches for k, v in expected.items()}
    per_batch = [b["launches"] for b in timer.batches]
    print(f"{name} stream: {count} txns in {len(timer.batches)} batches, launches "
          f"{launches} (expected {want}); hand-written launches per batch "
          f"{sorted(set(per_batch))}", flush=True)
    if launches != want or per_batch != [sum(expected.values())] * n_batches:
        fail(f"{name} stream: launch counts {launches} / {per_batch}")
    preds = check_stream_output(name, job, broker, records)
    timing = timer.summary(scorer)

    refs = [("a kernels-off card scorer", Config(quant=QuantSettings.full()), "cuda")]
    if cpu_reference:
        refs.append(("a CPU scorer", config, "cpu"))
    errs, tol = {}, None
    for label, ref_config, device in refs:
        tokens = []
        ref_job, ref_broker, _, _ = drive_stream(records, profiles, bert_config,
                                                 ref_config, device, tokens=tokens,
                                                 scorer_config=scorer_config)
        ref_preds = check_stream_output(f"{name} ({label})", ref_job, ref_broker,
                                        records)
        if tol is None:         # the stream's own tokens, the served models
            tol = noise_bound(scorer.models, bert_config, tokens,
                              scorer.ensemble_params.weights)
        errs[label] = compare_streams(name, preds, ref_preds, tol, label)

    # re-produce the first batch: every record is a cached duplicate
    before = dict(job.counters)
    ops.reset_launch_counts()
    broker.produce_batch(T.TRANSACTIONS, records[:BATCH],
                         key_fn=lambda r: str(r["user_id"]))
    job.run_until_drained(now=STREAM_NOW)
    skipped = job.counters["duplicates_skipped"] - before["duplicates_skipped"]
    if (skipped != BATCH or job.counters["scored"] != before["scored"]
            or sum(ops.launch_counts().values())
            or broker.lag(job.config.group_id, T.TRANSACTIONS)):
        fail(f"{name} stream replay: skipped {skipped}, counters {job.counters}")
    summary = dict(stream=name, txns=count, **timing, counters=job.counters,
                   max_err=errs, bound=tol)
    print(f"{name} stream replay of the first {BATCH} records: "
          f"{skipped} duplicates skipped, none scored", flush=True)
    print(f"{name} stream timing (host clock, {STREAM_USERS} users, "
          f"{STREAM_MERCHANTS} merchants, batch {BATCH}, pipeline depth 2): "
          + json.dumps(summary), flush=True)
    return dict(launches=launches, summary=summary, scorer=scorer, tokens=card_tokens,
                texts=texts)


# the typed-graph stream phase: the TINY default model with typed GNN
# parameters on a fraud-ring stream (the ring's default rate, 0.08), the
# typed graph's default fan-outs (16, two-hop 8), the two-hop context on the
# bf16 wire; then one batch at each lower QoS rung
TYPED_COUNT = 8 * BATCH
RUNG_LEVELS = (1, 2, 3)
# the overlap phase reruns phase 8's TINY stream, overlap off then on
OVERLAP_COUNT = 16 * BATCH


def run_typed_stream(ops):
    """The typed-graph stream through the port's ``StreamJob`` on the card
    (launch counters reset just before, read just after): every batch is
    declined by the megakernel's plan (two-hop) and runs the per-site chain;
    held against the same stream through a kernels-off CPU scorer at every
    QoS rung. Returns the stream's launch counts."""
    import numpy as np

    from realtime_fraud_detection_tpu_torch.core.batching import pad_to_bucket
    from realtime_fraud_detection_tpu_torch.core.packing import pack_tree
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.qos.ladder import LADDER_LEVELS
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
        MODEL_NAMES,
        ScorerConfig,
        init_scoring_models,
    )
    from realtime_fraud_detection_tpu_torch.scoring.scorer import _stage_bf16
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    name = "TINY typed"
    gen = TransactionGenerator(num_users=STREAM_USERS, num_merchants=STREAM_MERCHANTS,
                               seed=SEED)
    ring = gen.inject_fraud_ring()
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    records = gen.generate_batch(TYPED_COUNT)
    rung_records = {level: gen.generate_batch(BATCH) for level in RUNG_LEVELS}
    models = init_scoring_models(SEED, TINY_CONFIG, gnn_typed=True)
    sc = ScorerConfig(graph_mode="typed", transfer_bf16=True)
    config = Config(quant=QuantSettings.full(), kernels=KernelSettings.mega())
    n_batches = TYPED_COUNT // BATCH
    layers = TINY_CONFIG.num_layers
    expected = {"epilogue": 1, "flash_attention": layers, "dequant_matmul": 6 * layers,
                "dequant_rows": 2, "megakernel": 0}

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    job, broker, scorer, timer = drive_stream(records, profiles, TINY_CONFIG, config,
                                              "cuda", timed=True, models=models,
                                              scorer_config=sc)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {k: v * n_batches for k, v in expected.items()}
    per_batch = [b["launches"] for b in timer.batches]
    snap = scorer.kernel_snapshot()
    print(f"{name} stream: {TYPED_COUNT} txns ({ring.applied} ring) in "
          f"{len(timer.batches)} batches, launches {launches} (expected {want}); "
          f"hand-written launches per batch {sorted(set(per_batch))}; megakernel "
          f"dispatched {snap['dispatch']['megakernel']}, fallback "
          f"{snap['fallback']['megakernel']} (batches {n_batches})", flush=True)
    if launches != want or per_batch != [sum(expected.values())] * n_batches:
        fail(f"{name} stream: launch counts {launches} / {per_batch}")
    if (snap["dispatch"]["megakernel"] != n_batches
            or snap["fallback"] != {"dequant_matmul": 0, "epilogue": 0, "attention": 0,
                                    "megakernel": n_batches}
            or any(snap["dispatch"][k] != n_batches
                   for k in ("dequant_matmul", "epilogue", "attention"))
            or scorer._mega_args is not None):
        fail(f"{name} stream: kernel snapshot {snap}")
    preds = check_stream_output(name, job, broker, records)
    timing = timer.summary(scorer)
    host = scorer.host_stats()
    graph = scorer.graph_snapshot()

    label = "a kernels-off CPU scorer"
    tokens = []
    ref_job, ref_broker, ref_scorer, _ = drive_stream(
        records, profiles, TINY_CONFIG, Config(quant=QuantSettings.full()), "cpu",
        tokens=tokens, models=models, scorer_config=sc)
    ref_preds = check_stream_output(f"{name} ({label})", ref_job, ref_broker, records)
    weights = scorer.ensemble_params.weights
    tol = noise_bound(scorer.models, TINY_CONFIG, tokens, weights)
    errs = {"full_ensemble": compare_streams(name, preds, ref_preds, tol, label)}
    if scorer.typed_graph.digest() != ref_scorer.typed_graph.digest():
        fail(f"{name} stream: the card's typed graph differs from the CPU's")
    if graph["sampler"] != ref_scorer.graph_snapshot()["sampler"]:
        fail(f"{name} stream: sampler counters differ from the CPU's")

    # one batch at each lower rung, on both jobs alike
    for level in RUNG_LEVELS:
        rung = LADDER_LEVELS[level]
        mask = np.asarray([n not in rung.dropped_branches for n in MODEL_NAMES])
        batch = rung_records[level]
        ids = {r["transaction_id"] for r in batch}
        got = {}
        start = len(tokens)
        for side, (j, b) in (("card", (job, broker)), ("cpu", (ref_job, ref_broker))):
            j.scorer.set_degradation(mask, rules_only=rung.rules_only, level=level)
            b.produce_batch(T.TRANSACTIONS, batch, key_fn=lambda r: str(r["user_id"]))
            j.run_until_drained(now=STREAM_NOW)
            got[side] = [p for p in topic_values(b, T.PREDICTIONS)
                         if p["transaction_id"] in ids]
            if len(got[side]) != BATCH or j.counters["errors"]:
                fail(f"{name} rung {rung.name}: {side} {len(got[side])} predictions, "
                     f"counters {j.counters}")
        if rung.rules_only:
            keys = ("transaction_id", "fraud_score", "confidence", "decision", "risk_level")
            if [[p[k] for k in keys] for p in got["card"]] != \
                    [[p[k] for k in keys] for p in got["cpu"]]:
                fail(f"{name} rung {rung.name}: not bit-exact against the CPU")
            errs[rung.name] = 0.0
            print(f"  {name} rung {rung.name}: {BATCH} rows bit-exact against the CPU",
                  flush=True)
            continue
        rung_tol = noise_bound(scorer.models, TINY_CONFIG, tokens[start:], weights,
                               tuple(bool(v) for v in mask))
        errs[rung.name] = compare_streams(f"{name} rung {rung.name}", got["card"],
                                          got["cpu"], rung_tol, label)

    # the two-hop payload on the wire, from one more batch of the stream
    extra = scorer.assemble(rung_records[1], now=STREAM_NOW)
    padded, _, _ = pad_to_bucket(extra, BATCH)
    blobs, spec = pack_tree(_stage_bf16(padded))
    two_hop = sum(int(np.prod(e[2])) * (2 if e[0] == "bf16" else 1)
                  for e in spec.entries[-4:]) * BATCH
    summary = dict(stream=name, txns=TYPED_COUNT, ring_txns=ring.applied, **timing,
                   counters=job.counters, max_err=errs, bound=tol,
                   megakernel_fallback=snap["fallback"]["megakernel"],
                   batches=n_batches, launches=launches,
                   graph_ms_per_batch=host["stages"]["graph"]["mean_ms"],
                   sampler=graph["sampler"], store=graph["store"],
                   two_hop_bytes_per_batch=two_hop,
                   h2d_bytes_per_batch=sum(int(b.nbytes) for b in blobs.values()))
    print(f"{name} stream timing (host clock, {STREAM_USERS} users, "
          f"{STREAM_MERCHANTS} merchants, batch {BATCH}, pipeline depth 2, fan-out "
          f"{sc.fanout} / {sc.graph_fanout2}): " + json.dumps(summary), flush=True)
    return launches


def run_overlap(ops):
    """The TINY ``mega()`` stream (phase 8's) with the overlapped assembly
    stage off, then on, in one call. Delivery must be exact both times and
    the completions in the same order. Decisions are not compared: under
    overlap, which velocity write-backs land before a batch is assembled
    depends on timing (``scoring/host_pipeline.py``). Returns the overlap
    run's launch counts."""
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    gen = TransactionGenerator(num_users=STREAM_USERS, num_merchants=STREAM_MERCHANTS,
                               seed=SEED)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    count = OVERLAP_COUNT
    records = gen.generate_batch(count)
    config = Config(quant=QuantSettings.full(), kernels=KernelSettings.mega())
    want = {"epilogue": 0, "flash_attention": 0, "dequant_matmul": 0, "dequant_rows": 0,
            "megakernel": count // BATCH}
    runs = {}
    for overlap in (False, True):
        name = f"TINY overlap {'on' if overlap else 'off'}"
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        job, broker, scorer, timer = drive_stream(records, profiles, TINY_CONFIG, config,
                                                  "cuda", timed=True, overlap=overlap)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        if launches != want:
            fail(f"{name}: launch counts {launches} != {want}")
        preds = check_stream_output(name, job, broker, records)
        runs[overlap] = dict(order=[p["transaction_id"] for p in preds],
                             summary=timer.summary(scorer), launches=launches,
                             stage=job._stage)
    if runs[True]["order"] != runs[False]["order"]:
        fail("overlap stream: completions are not in the serial run's order")
    stage = runs[True]["stage"]
    for overlap in (False, True):
        t = runs[overlap]["summary"]
        print(f"TINY overlap {'on ' if overlap else 'off'}: {t['txn_per_s']:.1f} txn/s, "
              f"batch p50 {t['batch_ms_p50']:.2f} ms, p99 {t['batch_ms_p99']:.2f} ms; host "
              f"ms per batch {json.dumps(t['host_ms_per_batch'])}; smoke "
              f"{json.dumps(t['smoke_ms_per_batch'])}; gc {t['gc_ms']:.1f} ms", flush=True)
    print(f"overlap stream ({count} txns, {STREAM_USERS} users, batch {BATCH}, depth 2): "
          f"every record emitted once, completions in dispatch order, every offset "
          f"committed; stage busy {stage.busy_s:.3f} s over {stage.batches} batches; "
          + json.dumps({str(k): v["summary"] for k, v in runs.items()}), flush=True)
    return runs[True]["launches"]


def run_wordpiece_stream(ops, chain, word):
    """The DistilBERT-base stream of phase 8 with
    ``ScorerConfig(tokenizer="wordpiece")``: the same transactions, kernels,
    checks and kernels-off card reference (``run_stream``), plus: every
    batch's token ids and masks equal a CPU ``WordPieceTokenizer``'s on the
    same texts, the highest id lies inside the word embedding table, and
    ``dequant_rows`` at the word site on a stream batch's ids is bit-exact.
    ``word`` is phase 8's word-tokenizer stream, printed beside it. Returns
    the stream's launch counts."""
    import numpy as np

    from realtime_fraud_detection_tpu_torch.models.bert import DISTILBERT_BASE
    from realtime_fraud_detection_tpu_torch.models.wordpiece import WordPieceTokenizer
    from realtime_fraud_detection_tpu_torch.ops.dequant_matmul import (
        dequant_rows,
        dequant_rows_reference,
    )
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import ScorerConfig
    from realtime_fraud_detection_tpu_torch.utils.config import KernelSettings

    name = "DistilBERT-base wordpiece"
    sc = ScorerConfig(tokenizer="wordpiece")
    out = run_stream(ops, name, DISTILBERT_BASE, KernelSettings.full(), 4 * BATCH,
                     chain, cpu_reference=False, scorer_config=sc)
    scorer = out["scorer"]
    if not isinstance(scorer.tokenizer, WordPieceTokenizer):
        fail(f"{name}: the scorer's tokenizer is {type(scorer.tokenizer).__name__}")
    if len(out["tokens"]) != len(out["texts"]) or not out["tokens"]:
        fail(f"{name}: {len(out['tokens'])} token batches for {len(out['texts'])} texts")
    cpu = WordPieceTokenizer(max_length=sc.text_len)
    for k, ((ids, mask), texts) in enumerate(zip(out["tokens"], out["texts"])):
        want_ids, want_mask = cpu.encode_batch(texts)
        if not (np.array_equal(ids, want_ids) and np.array_equal(mask, want_mask)):
            fail(f"{name}: batch {k} tokens differ from a CPU WordPieceTokenizer's")
    table = scorer.models.bert["word_emb"]
    rows = int(table["qe"].shape[0])
    top = max(int(ids.max()) for ids, _ in out["tokens"])
    if not top < min(rows, cpu.vocab_size):
        fail(f"{name}: token id {top} outside the table ({rows} rows) or the "
             f"vocabulary ({cpu.vocab_size})")
    idx = torch.from_numpy(np.ascontiguousarray(out["tokens"][0][0], np.int32)).cuda()
    got = dequant_rows(table["qe"], table["scale"], idx=idx)
    ref = dequant_rows_reference(table["qe"], table["scale"], idx=idx)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        fail(f"{name}: dequant_rows at the word site is not bit-exact on the "
             f"stream's ids")
    pieces = int((idx >= 1000).sum())
    stats = {}
    for label, run in (("word", word), ("wordpiece", out)):
        t = run["summary"]
        stats[label] = dict(
            txn_per_s=t["txn_per_s"], batch_ms_p50=t["batch_ms_p50"],
            batch_ms_p99=t["batch_ms_p99"],
            tokenizer_ms_per_batch=t["inside_assemble_ms_per_batch"]["encode_batch"],
            token_cache=run["scorer"].host_stats()["caches"]["tokens"])
    print(f"{name}: every batch's ids and masks equal a CPU WordPieceTokenizer's "
          f"({len(out['tokens'])} batches); highest id {top} < {rows} table rows and "
          f"vocabulary {cpu.vocab_size}; dequant_rows word site bit-exact on "
          f"{idx.numel()} ids ({pieces} vocabulary pieces); "
          + json.dumps(stats), flush=True)
    return out["launches"]


# the QoS phase: the TINY mega() stream under the QoS plane at the JAX
# package's defaults, admission at half the offered rate, on a virtual clock
# of one batch period (256 transactions at the north star's 50,000 txn/s) a
# dispatched batch: a burst, then a trickle of one step a period
QOS_PERIOD_S = BATCH / 50_000.0          # 5.12 ms
QOS_BURST = 6_100                        # 23 full batches, then 212 the budget closes
QOS_TRICKLE_STEPS, QOS_TRICKLE = 32, 64
QOS_ADMISSION_RATE = 25_000.0            # txn/s of virtual time
QOS_ADMISSION_BURST = 1_024.0            # 40.96 ms of tokens at that rate
QOS_FAMILIES = ("qos_admitted_total", "qos_shed_total", "qos_ladder_level",
                "qos_ladder_transitions_total", "qos_degraded_scored_total",
                "qos_budget_remaining_seconds")


def qos_settings():
    from realtime_fraud_detection_tpu_torch.utils.config import QosSettings

    return QosSettings(enabled=True, admission_rate=QOS_ADMISSION_RATE,
                       admission_burst=QOS_ADMISSION_BURST)


def drive_qos(arrivals, profiles, config, device, models, timed=False, slo=None):
    """One run of the QoS schedule through the port's ``StreamJob`` with its
    own ``QosPlane``, pipeline depth 2, overlap off; with ``slo`` (a
    ``TracingSettings``) a ``Tracer`` on the same virtual clock closes each
    batch's traces and feeds the plane's SLO-burn gate, and each batch
    records whether the gate was engaged at its dispatch. ``arrivals[k]`` are the
    records of batch period k, produced at the period's start with that
    virtual timestamp; the assembler and the plane's clocks read the same
    virtual clock. A period dispatches at most one batch: one the size or
    budget trigger closes at the period's start, else one the deadline
    (5 ms) or budget closes at its end. Returns what the checks read: per
    dispatched batch its served rung, its ids, host ms from dispatch to
    completion and the ``mega_valid`` of each megakernel launch it made; with
    ``timed`` (on the card), each launch is replayed once on the same inputs
    and mask under ``spun_ms``, and ``kernel_ms`` holds those device ms in
    launch order."""
    from collections import deque

    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.ops import megakernel as mk
    from realtime_fraud_detection_tpu_torch.qos.plane import QosPlane
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
    from realtime_fraud_detection_tpu_torch.stream.microbatch import MicrobatchAssembler
    from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker

    scorer = TorchFraudScorer(config, models=models, bert_config=TINY_CONFIG,
                              device=device)
    scorer.seed_profiles(*profiles)
    plane = QosPlane(qos_settings())
    broker = InMemoryBroker()
    clock = [0.0]
    tracer = None
    if slo is not None:
        from realtime_fraud_detection_tpu_torch.obs.tracing import Tracer

        tracer = Tracer(slo, clock=lambda: clock[0])
    job = StreamJob(broker, scorer, JobConfig(max_batch=BATCH, pipeline_depth=2,
                                              qos=plane, tracing=tracer))
    job.assembler = MicrobatchAssembler(
        job.consumer, max_batch=BATCH, max_delay_ms=job.config.max_delay_ms,
        clock=lambda: clock[0], budget=plane.budget, budget_clock=lambda: clock[0])
    launches, kernel_ms, spin_retries = [], ([] if timed else None), [0]
    launch = mk._launch

    def spy(entry, inputs, b, dev, params, mega_valid):
        launches.append(tuple(mega_valid))
        out = launch(entry, inputs, b, dev, params, mega_valid)
        if timed:
            ms, retries = spun_ms(
                lambda: launch(entry, inputs, b, dev, params, mega_valid))
            kernel_ms.append(ms)
            spin_retries[0] += retries
        return out

    batches, in_flight = [], deque()

    def complete():
        ctx, info = in_flight.popleft()
        job.complete_batch(ctx, now=clock[0])
        info["t1"], info["t_done"] = time.perf_counter(), clock[0]

    mk._launch = spy
    try:
        k = 0
        while True:
            clock[0] = k * QOS_PERIOD_S
            for r in arrivals.get(k, ()):
                broker.produce(T.TRANSACTIONS, r, key=str(r["user_id"]),
                               timestamp=clock[0])
            batch = job.assembler.next_batch(block=False)
            if not batch:
                clock[0] = (k + 1) * QOS_PERIOD_S
                batch = job.assembler.next_batch(block=False)
            k += 1
            if not batch:
                if k > max(arrivals):
                    break           # every arrival assembled and dispatched
                continue
            before = len(launches)
            t0 = time.perf_counter()
            ctx = job.dispatch_batch(batch, now=clock[0])
            info = dict(rung=plane.effective_level(), gate=plane.slo_engaged,
                        t0=t0, rows=len(batch),
                        ids=[r.value["transaction_id"] for r in ctx.fresh],
                        launches=launches[before:],
                        kernel_launches=scorer.kernel_snapshot()["kernel_launches"]
                        if ctx.pending is not None else 0)
            batches.append(info)
            in_flight.append((ctx, info))
            while len(in_flight) >= job.config.pipeline_depth:
                complete()
        while in_flight:
            complete()
        if device != "cpu":
            torch.cuda.synchronize()
    finally:
        mk._launch = launch
    return dict(job=job, broker=broker, scorer=scorer, plane=plane, batches=batches,
                kernel_ms=kernel_ms, spin_retries=spin_retries[0], tracer=tracer)


def check_qos_run(name, card, cpu, produced):
    """The card's run of the QoS schedule against the CPU's: the same rung
    sequence, each produced id once on both predictions topics, no error,
    the same shed ids and reasons, none of high priority. Returns the card's
    sheds by id."""
    from collections import Counter

    from realtime_fraud_detection_tpu_torch.stream import topics as T

    rungs = [b["rung"] for b in card["batches"]]
    if rungs != [b["rung"] for b in cpu["batches"]]:
        fail(f"{name}: rung sequence {rungs} differs from the CPU run's "
             f"{[b['rung'] for b in cpu['batches']]}")
    preds = {side: topic_values(run["broker"], T.PREDICTIONS)
             for side, run in (("card", card), ("cpu", cpu))}
    for side, ps in preds.items():
        if Counter(p["transaction_id"] for p in ps) != Counter(produced):
            fail(f"{name}: the {side} predictions do not hold each produced id once")
        if any(p["explanation"].get("error") for p in ps):
            fail(f"{name}: a {side} prediction carries an error")
    shed = {side: {p["transaction_id"]: p["explanation"] for p in ps
                   if p["explanation"].get("shed")} for side, ps in preds.items()}
    if shed["card"] != shed["cpu"]:
        fail(f"{name}: the shed ids or reasons differ from the CPU run's")
    if not shed["card"] or any(e["priority"] == "high" for e in shed["card"].values()):
        fail(f"{name}: {len(shed['card'])} shed, high priority among them: "
             f"{Counter(e['priority'] for e in shed['card'].values())}")
    card["preds"], cpu["preds"] = preds["card"], preds["cpu"]
    return shed["card"]


def check_qos_launches(name, card, launches):
    """One megakernel launch per dispatched batch of the card's run, with
    its rung's mask, and no per-site kernel: the spy, the launch counters
    and ``kernel_snapshot()`` agree. Returns (batches scored, snapshot)."""
    from realtime_fraud_detection_tpu_torch.qos.ladder import LADDER_LEVELS
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES

    n_scored = 0
    for b in card["batches"]:
        rung = LADDER_LEVELS[b["rung"]]
        mask = tuple(n not in rung.dropped_branches for n in MODEL_NAMES)
        want = [mask] if b["ids"] else []
        if b["launches"] != want or b["kernel_launches"] != len(want):
            fail(f"{name}: a batch at {rung.name} launched {b['launches']} / "
                 f"{b['kernel_launches']}")
        n_scored += bool(b["ids"])
    want = {"epilogue": 0, "flash_attention": 0, "dequant_matmul": 0,
            "dequant_rows": 0, "megakernel": n_scored}
    snap = card["scorer"].kernel_snapshot()
    if (launches != want or snap["dispatch"]["megakernel"] != n_scored
            or any(snap["fallback"].values())
            or any(snap["dispatch"][k] for k in ("dequant_matmul", "epilogue",
                                                 "attention"))
            or snap["launches_per_batch"] != 1):
        fail(f"{name}: launches {launches} (expected {want}), snapshot {snap}")
    return n_scored, snap


def compare_qos_rungs(name, card, cpu, arrivals):
    """Decisions of the card's run against the CPU's, rung by rung: within
    the drill's bound measured on each rung's own tokens and mask,
    ``rules_only`` bit-exact. Returns the max error per rung."""
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.qos.ladder import LADDER_LEVELS
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES

    rung_of = {i: b["rung"] for b in card["batches"] for i in b["ids"]}
    scored = {side: [p for p in run["preds"] if not p["explanation"].get("shed")]
              for side, run in (("card", card), ("cpu", cpu))}
    errs = {}
    for level, rung in enumerate(LADDER_LEVELS):
        got = [p for p in scored["card"] if rung_of[p["transaction_id"]] == level]
        ref = [p for p in scored["cpu"] if rung_of[p["transaction_id"]] == level]
        if not got:
            fail(f"{name}: no batch served at {rung.name}")
        if rung.rules_only:
            keys = ("transaction_id", "fraud_score", "confidence", "decision",
                    "risk_level")
            if [[p[k] for k in keys] for p in got] != [[p[k] for k in keys] for p in ref]:
                fail(f"{name} rung {rung.name}: not bit-exact against the CPU")
            errs[rung.name] = 0.0
            print(f"  {name} rung {rung.name}: {len(got)} rows bit-exact against the "
                  f"CPU", flush=True)
            continue
        mask = tuple(n not in rung.dropped_branches for n in MODEL_NAMES)
        ids = {p["transaction_id"] for p in got}
        tol = noise_bound(card["scorer"].models, TINY_CONFIG,
                          qos_tokens(card["scorer"], arrivals, ids),
                          card["scorer"].ensemble_params.weights, mask)
        errs[rung.name] = compare_streams(f"{name} rung {rung.name}", got, ref, tol,
                                          "a kernels-off CPU run")
    return errs


def qos_schedule():
    """The QoS schedule's seeded records: (profiles, arrivals by batch
    period, the produced ids in order)."""
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator

    gen = TransactionGenerator(num_users=STREAM_USERS, num_merchants=STREAM_MERCHANTS,
                               seed=SEED)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    burst_periods = -(-QOS_BURST // BATCH)
    arrivals = {0: gen.generate_batch(QOS_BURST)}
    for k in range(burst_periods, burst_periods + QOS_TRICKLE_STEPS):
        arrivals[k] = gen.generate_batch(QOS_TRICKLE)
    produced = [r["transaction_id"] for k in sorted(arrivals) for r in arrivals[k]]
    return profiles, arrivals, produced


def run_qos(ops):
    """The QoS plane on the card: the TINY ``mega()`` stream under
    ``QosSettings(enabled=True)`` at the JAX defaults (budget 20 ms, margin
    2 ms, watermarks 2,048 / 256, patience 2, up-patience 8), admission at
    25,000 txn/s with a bucket of 1,024, on a virtual clock of 5.12 ms a
    batch period: a burst of 6,100 transactions in period 0 (23 batches the
    size trigger closes and one of 212 the budget closes), then 32 periods
    of 64 (each closed by the 5 ms deadline). The ladder steps down to
    ``rules_only`` in the burst and back to ``full_ensemble`` in the
    trickle. Gates: the rung sequence, the shed ids and every shed reason
    equal a kernels-off CPU run of the same schedule; no high-priority
    record shed; every id once on the predictions topic; one megakernel
    launch per dispatched batch with that rung's mask and no per-site
    kernel (counters and ``kernel_snapshot()`` agree); decisions within the
    drill's bound at every rung, ``rules_only`` bit-exact; the exposition's
    ``qos_*`` families and budget closes. Then the quality artifact's blend
    in one launch. Returns the card run's launch counts and rung sequence."""
    from collections import Counter

    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.obs.profiling import interpolated_percentile
    from realtime_fraud_detection_tpu_torch.qos.ladder import LADDER_LEVELS
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    name = "TINY QoS"
    profiles, arrivals, produced = qos_schedule()
    models = seeded_models(TINY_CONFIG)
    config = Config(quant=QuantSettings.full(), kernels=KernelSettings.mega())

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    card = drive_qos(arrivals, profiles, config, "cuda", models)
    launches = ops.launch_counts()
    cpu = drive_qos(arrivals, profiles, Config(quant=QuantSettings.full()), "cpu", models)

    rungs = [b["rung"] for b in card["batches"]]
    if max(rungs) != 3 or rungs[-1] != 0 or rungs[0] != 0:
        fail(f"{name}: the ladder did not step down to rules_only and back: {rungs}")
    shed = check_qos_run(name, card, cpu, produced)
    n_scored, snap = check_qos_launches(name, card, launches)
    errs = compare_qos_rungs(name, card, cpu, arrivals)

    # the exposition
    plane, job = card["plane"], card["job"]
    metrics = plane.metrics
    metrics.sync_microbatch(job.assembler.close_reasons)
    metrics.sync_kernels(snap)
    metrics.sync_host_stats(card["scorer"].host_stats())
    text = metrics.render_prometheus()
    missing = [f for f in QOS_FAMILIES if f"# TYPE {f} " not in text]
    closes = dict(job.assembler.close_reasons)
    budget_line = f'microbatch_close_reason_total{{reason="budget"}} {closes.get("budget", 0)}'
    if missing or (closes.get("budget") and budget_line not in text):
        fail(f"{name}: exposition lacks {missing} or {budget_line!r}")

    # the schedule once more on the card, each megakernel launch replayed
    # under CUDA events: the same rungs, and the device ms of each batch's
    # launch at its own rows and mask
    timed = drive_qos(arrivals, profiles, config, "cuda", models, timed=True)
    scored_batches = [b for b in timed["batches"] if b["ids"]]
    if ([b["rung"] for b in timed["batches"]] != rungs
            or [b["launches"] for b in timed["batches"]]
            != [b["launches"] for b in card["batches"]]):
        fail(f"{name}: the timed run served other rungs or masks than the first")
    it = iter(timed["kernel_ms"])
    for b in scored_batches:
        b["device_ms"] = next(it)

    # per rung: batches, megakernel device ms, host ms dispatch to completion
    per_rung = {}
    for level, rung in enumerate(LADDER_LEVELS):
        bs = [b for b in card["batches"] if b["rung"] == level and b["ids"]]
        dev = [b["device_ms"] for b in scored_batches if b["rung"] == level]
        host = sorted((b["t1"] - b["t0"]) * 1e3 for b in bs)
        per_rung[rung.name] = dict(
            batches=len(bs), rows=sum(len(b["ids"]) for b in bs),
            batch_rows=dict(Counter(b["rows"] for b in bs)),
            megakernel_device_ms=sum(dev) / max(len(dev), 1),
            megakernel_device_ms_min=min(dev, default=None),
            megakernel_device_ms_max=max(dev, default=None),
            batch_ms_p50=interpolated_percentile(host, 0.5),
            batch_ms_p99=interpolated_percentile(host, 0.99))
    sweep = rung_sweep(card["scorer"])
    lat = sorted((c - t) * 1e3 for c, t in qos_latencies(card, arrivals))
    summary = dict(
        stream=name, produced=len(produced), batches=len(card["batches"]),
        scored=job.counters["scored"], shed=job.counters["shed"],
        shed_by_priority=dict(Counter(e["priority"] for e in shed.values())),
        shed_by_reason=dict(Counter(e["shed_reason"] for e in shed.values())),
        transitions_down=plane.ladder.transitions_down,
        transitions_up=plane.ladder.transitions_up, close_reasons=closes,
        rungs=rungs, per_rung=per_rung, rung_sweep_bucket_256=sweep, max_err=errs,
        admitted_virtual_latency_ms=dict(
            p50=interpolated_percentile(lat, 0.5), p99=interpolated_percentile(lat, 0.99),
            max=lat[-1]),
        budget_ms=plane.settings.budget_ms, launches=launches,
        timing_spin_retries=timed["spin_retries"])
    print(f"{name}: rungs {rungs} equal to the CPU run's; {len(shed)} shed "
          f"(none high priority) with the CPU run's ids and reasons; one megakernel "
          f"launch with its rung's mask on each of {n_scored} batches; "
          + json.dumps(summary), flush=True)
    run_quality_artifact(ops, models)
    return dict(launches=launches, rungs=rungs)


# the tracing phase: phase 8's TINY mega() stream with tracing off and on,
# in turns; then the QoS schedule with a Tracer on its virtual clock, SLO
# windows scaled to the schedule (a fast window of ~23 batch periods, so the
# burst's violations age out inside the trickle)
TRACE_COUNT = 16 * BATCH
TRACE_RUNS = (False, True, False, True)
TRACED_STAGES = ("queue", "assemble", "pack", "dispatch", "device_wait", "finalize")
SLO_FAST_S, SLO_SLOW_S, SLO_BUCKET_S = 0.12, 0.48, 0.01
SLO_THRESHOLD, SLO_PATIENCE, SLO_UP_PATIENCE = 2.0, 2, 4


class PlaneTimer:
    """The host time spent inside the tracing plane's calls during a run:
    the tracer's ``begin`` / ``batch`` / ``finish_batch`` /
    ``finish_terminal`` (wrapped on the instance) and ``TraceBatch.mark``
    (wrapped on the class until ``close``)."""

    def __init__(self, tracer):
        from realtime_fraud_detection_tpu_torch.obs import tracing

        self.s = 0.0
        self._cls, self._mark = tracing.TraceBatch, tracing.TraceBatch.mark
        for name in ("begin", "batch", "finish_batch", "finish_terminal"):
            setattr(tracer, name, self._timed(getattr(tracer, name)))
        self._cls.mark = self._timed(self._mark)

    def _timed(self, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.s += time.perf_counter() - t0
        return wrapper

    def close(self) -> None:
        self._cls.mark = self._mark


def run_traced_stream(ops):
    """Phase 8's TINY ``mega()`` stream (int8 BERT, batches of 256, depth 2)
    with ``JobConfig(tracing=None)`` and with ``TracingSettings(enabled=True)``
    on ``time.monotonic``, in turns (off, on, off, on). Gates: every run's
    launches one megakernel a batch; ids, order and decisions of every run
    identical; one ``scored`` trace per scored transaction, each with the
    scorer's stage names, ``device_wait`` positive on every traced batch.
    Prints the breakdown's per-stage shares at p50 / p95 / p99 with the
    dominant stage, txn/s off and on, the plane's host cost a transaction
    (inside its calls, and the trace drill's loop), and the size of the
    exported Chrome trace (``chiprun_out/``). Returns the traced runs'
    launch counts (summed)."""
    import os
    from collections import Counter

    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.obs.trace_drill import (
        TraceDrillConfig,
        _measure_overhead,
    )
    from realtime_fraud_detection_tpu_torch.obs.tracing import Tracer
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
        TracingSettings,
    )

    name = "TINY traced"
    gen = TransactionGenerator(num_users=STREAM_USERS, num_merchants=STREAM_MERCHANTS,
                               seed=SEED)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    records = gen.generate_batch(TRACE_COUNT)
    config = Config(quant=QuantSettings.full(), kernels=KernelSettings.mega())
    n_batches = TRACE_COUNT // BATCH
    want = {"epilogue": 0, "flash_attention": 0, "dequant_matmul": 0, "dequant_rows": 0,
            "megakernel": n_batches}
    runs, traced_launches = [], Counter()
    for traced in TRACE_RUNS:
        tracer = (Tracer(TracingSettings(enabled=True, ring_size=2 * TRACE_COUNT))
                  if traced else None)
        plane = PlaneTimer(tracer) if traced else None
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        try:
            job, broker, scorer, timer = drive_stream(
                records, profiles, TINY_CONFIG, config, "cuda", timed=True,
                tracing=tracer)
        finally:
            if plane is not None:
                plane.close()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        if launches != want:
            fail(f"{name} ({'on' if traced else 'off'}): launches {launches} != {want}")
        if traced:
            traced_launches.update(launches)
        preds = check_stream_output(name, job, broker, records)
        runs.append(dict(traced=traced, tracer=tracer, plane_s=plane.s if traced else 0.0,
                         summary=timer.summary(scorer), job=job,
                         out=[(p["transaction_id"], p["decision"], p["risk_level"],
                               p["fraud_score"]) for p in preds]))
    base = runs[0]["out"]
    for run in runs[1:]:
        if [o[:3] for o in run["out"]] != [o[:3] for o in base]:
            fail(f"{name}: ids, order or decisions differ between tracing off and on")
    score_diff = max(abs(a[3] - b[3]) for run in runs[1:]
                     for a, b in zip(run["out"], base))

    for run in (r for r in runs if r["traced"]):
        tracer = run["tracer"]
        scored = [t for t in tracer.traces() if t.terminal == "scored"]
        if Counter(t.txn_id for t in scored) != Counter(o[0] for o in base):
            fail(f"{name}: not one scored trace per scored transaction")
        if any(list(t.stages)[-len(TRACED_STAGES):] != list(TRACED_STAGES)
               for t in scored):
            fail(f"{name}: a trace lacks the scorer's stage names")
        if any(not t.stages["device_wait"] > 0.0 for t in scored):
            fail(f"{name}: device_wait is not positive on every traced batch")
        if tracer.counters["completed"] != TRACE_COUNT or tracer.counters["errors"]:
            fail(f"{name}: tracer counters {tracer.counters}")

    last = runs[-1]
    bd = last["tracer"].breakdown()
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", "tiny_traced_stream.json")
    with open(path, "w") as f:
        json.dump(last["tracer"].export_chrome_trace(), f)
    tps = {str(traced): [r["summary"]["txn_per_s"] for r in runs if r["traced"] == traced]
           for traced in (False, True)}
    mean = {k: sum(v) / len(v) for k, v in tps.items()}
    wall_us = {str(traced): [1e6 / r["summary"]["txn_per_s"] for r in runs
                             if r["traced"] == traced] for traced in (False, True)}
    drill = _measure_overhead(TraceDrillConfig())
    summary = dict(
        stream=name, txns=TRACE_COUNT, runs=["on" if t else "off" for t in TRACE_RUNS],
        txn_per_s_off=tps["False"], txn_per_s_on=tps["True"],
        txn_per_s_change=mean["True"] / mean["False"] - 1.0,
        wall_us_per_txn_off=wall_us["False"], wall_us_per_txn_on=wall_us["True"],
        plane_us_per_txn=[r["plane_s"] / TRACE_COUNT * 1e6 for r in runs if r["traced"]],
        drill_loop_us_per_txn=drill["enabled_us_per_txn"],
        drill_noop_us_per_txn=drill["disabled_us_per_txn"],
        batch_ms_p50={("on" if r["traced"] else "off") + str(i): r["summary"]["batch_ms_p50"]
                      for i, r in enumerate(runs)},
        fraud_score_max_diff=score_diff,
        breakdown={q: dict(e2e_ms=v["e2e_ms"], tail_n=v["tail_n"], stage_ms=v["stage_ms"],
                           dominant_stage=v["dominant_stage"],
                           dominant_frac=v["dominant_frac"])
                   for q, v in bd["quantiles"].items()},
        host_ms_per_batch=last["summary"]["host_ms_per_batch"],
        gc_ms=last["summary"]["gc_ms"], chrome_trace=path,
        chrome_trace_bytes=os.path.getsize(path), launches=dict(traced_launches))
    print(f"{name}: {len(TRACE_RUNS)} runs of {TRACE_COUNT} txns, tracing off / on in "
          f"turns, ids, order and decisions identical (fraud_score max diff "
          f"{score_diff:.3e}); one scored trace per transaction with the stages "
          f"{list(TRACED_STAGES)}, device_wait > 0 on all; " + json.dumps(summary),
          flush=True)
    for q in ("p50", "p95", "p99"):
        v = bd["quantiles"][q]
        print(f"  {name} {q}: e2e {v['e2e_ms']:.3f} ms, dominant {v['dominant_stage']} "
              f"({v['dominant_frac']:.3f}); stage ms {json.dumps(v['stage_ms'])}",
              flush=True)
    return dict(traced_launches)


def run_qos_slo(ops, qos_rungs):
    """The SLO-burn gate on the card: phase 13's QoS schedule with a
    ``Tracer`` on the same virtual clock (objective 20 ms, the budget; fast /
    slow windows 0.12 / 0.48 s, buckets of 0.01 s, threshold 2, patience 2,
    up-patience 4), so each completed batch feeds its burn rate to the QoS
    plane's gate. Gates: the gate engages in the burst and is released by the
    end of the trickle; the rung sequence, the gate's state at each dispatch
    and the shed ids equal a kernels-off CPU run's; one megakernel launch per
    batch with its rung's mask; decisions within the drill's bound at every
    rung, ``rules_only`` bit-exact. Prints the rungs beside phase 13's.
    Returns the card run's launch counts."""
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
        TracingSettings,
    )

    name = "TINY QoS + SLO gate"
    profiles, arrivals, produced = qos_schedule()
    models = seeded_models(TINY_CONFIG)
    slo = TracingSettings(enabled=True, ring_size=2 * len(produced),
                          slo_objective_ms=qos_settings().budget_ms,
                          slo_fast_window_s=SLO_FAST_S, slo_slow_window_s=SLO_SLOW_S,
                          slo_bucket_s=SLO_BUCKET_S, slo_burn_threshold=SLO_THRESHOLD,
                          slo_gate_patience=SLO_PATIENCE,
                          slo_gate_up_patience=SLO_UP_PATIENCE)
    config = Config(quant=QuantSettings.full(), kernels=KernelSettings.mega())
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    card = drive_qos(arrivals, profiles, config, "cuda", models, slo=slo)
    launches = ops.launch_counts()
    cpu = drive_qos(arrivals, profiles, Config(quant=QuantSettings.full()), "cpu", models,
                    slo=slo)

    rungs = [b["rung"] for b in card["batches"]]
    gates = [b["gate"] for b in card["batches"]]
    if gates != [b["gate"] for b in cpu["batches"]]:
        fail(f"{name}: the gate's states differ from the CPU run's")
    burst = -(-QOS_BURST // BATCH)
    if not any(gates[:burst]) or gates[-1] or rungs[-1] != 0:
        fail(f"{name}: the gate did not engage in the burst and release by the end: "
             f"{gates}")
    shed = check_qos_run(name, card, cpu, produced)
    n_scored, _ = check_qos_launches(name, card, launches)
    errs = compare_qos_rungs(name, card, cpu, arrivals)
    flips = [i for i in range(1, len(gates)) if gates[i] != gates[i - 1]]
    tracer = card["tracer"]
    summary = dict(
        stream=name, batches=len(rungs), scored=card["job"].counters["scored"],
        shed=len(shed), gate_engaged_at_batch=flips[0] if flips else None,
        gate_released_at_batch=flips[-1] if len(flips) > 1 else None,
        gate_transitions=len(flips), max_err=errs, launches=launches,
        trace_counters=tracer.counters, slo=tracer.slo.snapshot(),
        held_by_gate=sum(1 for r, q in zip(rungs, qos_rungs) if r > q))
    print(f"{name}: rungs {''.join(map(str, rungs))} (phase 13: "
          f"{''.join(map(str, qos_rungs))}), gate {''.join(str(int(g)) for g in gates)}, "
          f"equal to the CPU run's with its sheds; one megakernel launch with its "
          f"rung's mask on each of {n_scored} batches; " + json.dumps(summary),
          flush=True)
    return launches


# the tuning phase: the autotune drill's offered-load timeline (a compressed
# diurnal cycle with flash-sale bursts, AutotuneDrillConfig.fast(): 150 to
# 8,000 txn/s, bursts x4), its first half cycle (the whole cycle's 15,769
# arrivals took the phase 65 s, 34 of them the CPU reference), on the seeded
# simulator's records, with the drill's priority mix by amount
AUTOTUNE_DURATION_S = 1.5
AUTOTUNE_STEP_S = 0.0005         # the drive loop's step while a batch is open
LIVE_TIMEOUT_S = 0.005           # the live loop's blocking poll
CHAIN_LAUNCHES = {"epilogue": 1, "flash_attention": 2, "dequant_matmul": 12,
                  "dequant_rows": 2, "megakernel": 0}
MEGA_LAUNCHES = {"epilogue": 0, "flash_attention": 0, "dequant_matmul": 0,
                 "dequant_rows": 0, "megakernel": 1}


def autotune_timeline():
    """(drill config, arrival times, simulator records with the drill's
    amounts, profiles, warm-up records)."""
    import dataclasses

    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.tuning.drill import (
        AutotuneDrillConfig,
        _arrivals,
    )

    cfg = dataclasses.replace(AutotuneDrillConfig.fast(),
                              duration_s=AUTOTUNE_DURATION_S)
    arrivals = _arrivals(cfg)
    gen = TransactionGenerator(num_users=STREAM_USERS, num_merchants=STREAM_MERCHANTS,
                               seed=SEED)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    records = gen.generate_batch(len(arrivals))
    for rec, (_, txn) in zip(records, arrivals):
        rec["amount"] = txn["amount"]
    warm = gen.generate_batch(sum(MEGA_BUCKETS) + 1)
    return cfg, [ts for ts, _ in arrivals], records, profiles, warm


def autotune_planes(cfg, live=False, tuned=True):
    """The drill's QoS plane (its budget, no ladder, no admission limit),
    a tracer on ``clock`` (None: ``time.monotonic``) with the drill's SLO
    windows, and the tuning plane: the drill's (serial) on the virtual
    clock, ``run-job --autotune --qos``'s in the live run."""
    from realtime_fraud_detection_tpu_torch.qos.plane import QosPlane
    from realtime_fraud_detection_tpu_torch.tuning.drill import _tuning_plane
    from realtime_fraud_detection_tpu_torch.tuning.plane import TuningPlane
    from realtime_fraud_detection_tpu_torch.utils.config import (
        QosSettings,
        TracingSettings,
        TuningSettings,
    )

    qos = QosSettings(enabled=True, budget_ms=cfg.budget_ms,
                      assemble_margin_ms=cfg.assemble_margin_ms,
                      ladder_high_backlog=1e9, ladder_low_backlog=1e8)
    slo = TracingSettings(enabled=True, ring_size=4096, slo_objective_ms=cfg.budget_ms,
                          slo_fast_window_s=0.5, slo_slow_window_s=2.0,
                          slo_bucket_s=0.05)
    tuning = None
    if tuned and live:
        settings = TuningSettings(enabled=True)
        settings.clamp_to_qos(qos)
        tuning = TuningPlane(settings)
    elif tuned:
        tuning = _tuning_plane(cfg)
    return QosPlane(qos), slo, tuning


def batch_spy(scorer, ops, batches):
    """Wrap ``scorer.dispatch``: each dispatched batch appends its rows,
    the launch counters' growth, the snapshot's ``kernel_launches`` and the
    megakernel's dispatch / fallback growth to ``batches``."""
    dispatch = scorer.dispatch

    def spy(records, now=None, **kw):
        before = ops.launch_counts()
        snap0 = scorer.kernel_snapshot()
        out = dispatch(records, now=now, **kw)
        after = ops.launch_counts()
        snap = scorer.kernel_snapshot()
        batches.append(dict(
            rows=len(records), rung=scorer.qos_level,
            launches={k: after[k] - before[k] for k in after},
            kernel_launches=snap["kernel_launches"],
            mega=(snap["dispatch"]["megakernel"] - snap0["dispatch"]["megakernel"],
                  snap["fallback"]["megakernel"] - snap0["fallback"]["megakernel"])))
        return out

    scorer.dispatch = spy


def drive_autotune(cfg, times, records, profiles, config, device, models, ops):
    """The timeline through the port's ``StreamJob`` with
    ``JobConfig(qos=..., tracing=..., autotune=...)`` on a virtual clock that
    the assembler, the budget, the tracer and the tuning plane all read; the
    drill's drive loop, the device its bucket-padded service curve (2 ms +
    6 us a padded row of virtual time a batch), so every close decision is
    the card's and the CPU's alike. Returns what the checks read."""
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.obs.tracing import Tracer
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
    from realtime_fraud_detection_tpu_torch.stream.microbatch import MicrobatchAssembler
    from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
    from realtime_fraud_detection_tpu_torch.tuning.drill import AutotuneDrillScorer

    clock = [0.0]
    vclock = lambda: clock[0]                                   # noqa: E731
    curve = AutotuneDrillScorer(cfg).cost_s
    scorer = TorchFraudScorer(config, models=models, bert_config=TINY_CONFIG,
                              device=device)
    scorer.seed_profiles(*profiles)
    tokens, batches = [], []
    assemble = scorer.assemble

    def keep_tokens(*args, **kwargs):
        batch = assemble(*args, **kwargs)
        tokens.append((batch.token_ids, batch.token_mask))
        return batch

    scorer.assemble = keep_tokens
    batch_spy(scorer, ops, batches)
    plane, slo, tuning = autotune_planes(cfg)
    broker = InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(
        max_batch=cfg.max_batch, qos=plane, tracing=Tracer(slo, clock=vclock),
        autotune=tuning))
    job.assembler = MicrobatchAssembler(
        job.consumer, max_batch=cfg.max_batch, max_delay_ms=5.0, clock=vclock,
        budget=plane.budget, budget_clock=vclock, controller=job.tuning)
    n, next_i, lat = len(times), 0, []
    t0 = time.perf_counter()
    while True:
        while next_i < n and times[next_i] <= clock[0]:
            broker.produce(T.TRANSACTIONS, records[next_i],
                           key=str(records[next_i]["user_id"]), timestamp=times[next_i])
            next_i += 1
        batch = job.assembler.next_batch(block=False)
        if not batch and next_i >= n and job.consumer.lag() == 0:
            batch = job.assembler.flush()
        if batch:
            ctx = job.dispatch_batch(batch, now=clock[0])
            clock[0] += (curve(len(ctx.fresh)) if ctx is not None and ctx.pending
                         is not None else AUTOTUNE_STEP_S)
            if ctx is not None:
                job.complete_batch(ctx, now=clock[0])
                lat += [(clock[0] - r.timestamp) * 1e3 for r in ctx.fresh]
            continue
        if next_i >= n and job.consumer.lag() == 0 and not job.assembler._pending:
            break
        if job.assembler._pending:
            clock[0] += AUTOTUNE_STEP_S
        else:
            clock[0] = (max(clock[0] + AUTOTUNE_STEP_S, times[next_i]) if next_i < n
                        else clock[0] + AUTOTUNE_STEP_S)
    if device != "cpu":
        torch.cuda.synchronize()
    return dict(job=job, broker=broker, scorer=scorer, batches=batches, tokens=tokens,
                latencies_ms=sorted(lat), host_s=time.perf_counter() - t0,
                virtual_s=clock[0], tuning=job.tuning.snapshot(),
                close_reasons=dict(sorted(job.assembler.close_reasons.items())),
                trace_counters=dict(job.tracer.counters))


def drive_live(cfg, times, records, profiles, config, models, warm, ops, tuned):
    """The timeline paced in wall time: a producer thread produces each
    record at its offset from the start (broker timestamp = wall time),
    while this thread runs the job's loop (blocking polls of 5 ms, the
    in-flight window the job's ``_inflight_depth``) until every record is
    scored. ``tuned``: the tuning plane of ``run-job --autotune --qos``, fed
    the card's measured dispatch-to-completion times; else the fixed 5 ms
    deadline. The scorer is warmed on other records at every bucket first.
    Returns what the checks and the summary read."""
    import threading
    from collections import deque

    from realtime_fraud_detection_tpu_torch.core.batching import bucket_for
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.obs.tracing import Tracer
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
    from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker

    scorer = TorchFraudScorer(config, models=models, bert_config=TINY_CONFIG,
                              device="cuda")
    scorer.seed_profiles(*profiles)
    i = 0
    for size in (1, *MEGA_BUCKETS):
        scorer.score_batch(warm[i:i + size], now=time.time())
        i += size
    torch.cuda.synchronize()
    batches = []
    batch_spy(scorer, ops, batches)
    plane, slo, tuning = autotune_planes(cfg, live=True, tuned=tuned)
    broker = InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(
        max_batch=cfg.max_batch, max_delay_ms=5.0, qos=plane, tracing=Tracer(slo),
        autotune=tuning))
    lat, service = [], {}

    def complete(ctx):
        job.complete_batch(ctx)
        done = time.time()
        lat.extend((done - r.timestamp) * 1e3 for r in ctx.fresh)
        if ctx.fresh:
            service.setdefault(bucket_for(len(ctx.fresh)), []).append(
                (done - ctx.t_dispatch) * 1e3)

    start = time.perf_counter() + 0.05

    def produce():
        for ts, rec in zip(times, records):
            wait = start + ts - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            broker.produce(T.TRANSACTIONS, rec, key=str(rec["user_id"]))

    producer = threading.Thread(target=produce, name="live-producer", daemon=True)
    producer.start()
    in_flight, depths = deque(), []
    try:
        while producer.is_alive() or job.consumer.lag() or job.assembler._pending:
            batch = job.assembler.next_batch(block=True, timeout_s=LIVE_TIMEOUT_S)
            if batch:
                in_flight.append(job.dispatch_batch(batch))
                depths.append(job._inflight_depth())
            while in_flight and (len(in_flight) >= job._inflight_depth() or not batch):
                complete(in_flight.popleft())
        while in_flight:
            complete(in_flight.popleft())
    finally:
        producer.join()
    end = time.perf_counter()
    torch.cuda.synchronize()
    return dict(job=job, broker=broker, scorer=scorer, batches=batches,
                latencies_ms=sorted(lat), wall_s=end - start, service_ms=service,
                depths=depths, tuning=job.tuning.snapshot() if job.tuning else None,
                close_reasons=dict(sorted(job.assembler.close_reasons.items())))


def run_autotune(ops):
    """The tuning plane on the card. (a) The autotune drill's timeline
    (``AutotuneDrillConfig.fast()``'s first ``AUTOTUNE_DURATION_S``) on the
    seeded simulator's records
    through ``StreamJob`` with ``JobConfig(qos=..., tracing=...,
    autotune=...)`` on the card scorer (TINY, int8 BERT, ``mega()``) and on
    a kernels-off CPU scorer, both on a virtual clock advanced by the drill's
    service curve. Gates: the batch sizes, close reasons, the tuner's
    snapshot (moves, learned T(bucket)) and the trace counts equal the CPU
    run's; decisions within the drill's bound; each batch of two or more
    rows one megakernel launch, each one-row batch the per-site chain (1 /
    2 / 12 / 2 launches) and one counted megakernel fallback, the counters'
    growth equal to the snapshot's ``kernel_launches`` every batch. Prints
    the bucket histogram and the launches by bucket. (b) The same timeline
    paced in wall time, twice: the tuning plane of ``run-job --autotune
    --qos`` (fed the card's dispatch-to-completion times), and the fixed
    5 ms deadline. Gates delivery only: each id emitted once, lag 0, no
    high-priority record shed. Prints admitted p50 / p99 and txn/s, the close
    reasons, the tuner's moves and the learned T(bucket) beside the measured
    one. Returns each run's launch counts."""
    from collections import Counter

    from realtime_fraud_detection_tpu_torch.core.batching import bucket_for
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.obs.profiling import interpolated_percentile
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    name = "TINY autotune"
    cfg, times, records, profiles, warm = autotune_timeline()
    models = seeded_models(TINY_CONFIG)
    config = Config(quant=QuantSettings.full(), kernels=KernelSettings.mega())
    ids = [r["transaction_id"] for r in records]
    out = {}

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    card = drive_autotune(cfg, times, records, profiles, config, "cuda", models, ops)
    out["autotune_timeline"] = ops.launch_counts()
    cpu = drive_autotune(cfg, times, records, profiles, Config(quant=QuantSettings.full()),
                         "cpu", models, ops)
    sizes = [b["rows"] for b in card["batches"]]
    for key in ("close_reasons", "tuning", "trace_counters", "latencies_ms"):
        if card[key] != cpu[key]:
            fail(f"{name}: {key} differs from the CPU run's")
    if sizes != [b["rows"] for b in cpu["batches"]]:
        fail(f"{name}: batch sizes differ from the CPU run's")
    if any(b["rung"] for b in card["batches"]):
        fail(f"{name}: a batch was served below the full ensemble")
    by_bucket, n_one = {}, 0
    for b in card["batches"]:
        one = b["rows"] == 1
        want = CHAIN_LAUNCHES if one else MEGA_LAUNCHES
        if (b["launches"] != want or b["kernel_launches"] != sum(want.values())
                or b["mega"] != (1, int(one))):
            fail(f"{name}: a {b['rows']}-row batch launched {b['launches']} "
                 f"(snapshot {b['kernel_launches']}, megakernel {b['mega']})")
        n_one += one
        row = by_bucket.setdefault(bucket_for(b["rows"]), Counter(batches=0))
        row["batches"] += 1
        row.update(b["launches"])
    snap = card["scorer"].kernel_snapshot()
    total = {k: sum(b["launches"][k] for b in card["batches"]) for k in CHAIN_LAUNCHES}
    if (total != out["autotune_timeline"] or snap["dispatch"]["megakernel"] != len(sizes)
            or snap["fallback"]["megakernel"] != n_one):
        fail(f"{name}: launches {out['autotune_timeline']} / {total}, snapshot {snap}")
    preds = check_stream_output(name, card["job"], card["broker"], records)
    ref = check_stream_output(f"{name} (CPU)", cpu["job"], cpu["broker"], records)
    tol = noise_bound(card["scorer"].models, TINY_CONFIG, chunked(card["tokens"]),
                      card["scorer"].ensemble_params.weights)
    err = compare_streams(name, preds, ref, tol, "a kernels-off CPU run")
    lat = card["latencies_ms"]
    timeline = dict(
        stream=name, txns=len(records), batches=len(sizes), one_row_batches=n_one,
        close_reasons=card["close_reasons"], tuner=card["tuning"]["tuner"],
        learned_service_ms=card["tuning"]["controller"]["service_ms"],
        decisions=card["tuning"]["controller"]["decisions"],
        virtual_p50_ms=interpolated_percentile(lat, 0.5),
        virtual_p99_ms=interpolated_percentile(lat, 0.99), virtual_s=card["virtual_s"],
        card_host_s=card["host_s"], cpu_host_s=cpu["host_s"], max_err=err,
        bucket_histogram={str(k): v["batches"] for k, v in sorted(by_bucket.items())},
        launches_by_bucket={str(k): dict(v) for k, v in sorted(by_bucket.items())},
        trace_counters=card["trace_counters"], launches=out["autotune_timeline"])
    print(f"{name} (a), virtual clock: {len(sizes)} batches ({n_one} of one row on the "
          f"per-site chain, the rest one megakernel launch each), sizes, close "
          f"reasons, tuner and traces equal to the CPU run's; " + json.dumps(timeline),
          flush=True)

    live = {}
    for tuned in (True, False):
        key = "autotune_live_" + ("tuned" if tuned else "static")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        run = drive_live(cfg, times, records, profiles, config, models, warm, ops, tuned)
        out[key] = ops.launch_counts()
        job, broker = run["job"], run["broker"]
        emitted = Counter(p["transaction_id"] for p in topic_values(broker, T.PREDICTIONS))
        if emitted != Counter(ids) or broker.lag(job.config.group_id, T.TRANSACTIONS):
            fail(f"{name} live ({key}): not each id emitted once, or lag left")
        shed = [p for p in topic_values(broker, T.PREDICTIONS)
                if p["explanation"].get("shed")]
        if any(p["explanation"]["priority"] == "high" for p in shed) or job.counters["errors"]:
            fail(f"{name} live ({key}): a high-priority shed or an error: {job.counters}")
        lat = run["latencies_ms"]
        live[key] = dict(
            txn_per_s=job.counters["scored"] / run["wall_s"], wall_s=run["wall_s"],
            admitted_p50_ms=interpolated_percentile(lat, 0.5),
            admitted_p99_ms=interpolated_percentile(lat, 0.99), admitted_max_ms=lat[-1],
            batches=len(run["batches"]), shed=job.counters["shed"],
            close_reasons=run["close_reasons"],
            bucket_histogram=dict(sorted(Counter(
                str(bucket_for(b["rows"])) for b in run["batches"]).items())),
            measured_service_ms={str(b): dict(n=len(v), mean=sum(v) / len(v),
                                              p50=interpolated_percentile(sorted(v), 0.5))
                                 for b, v in sorted(run["service_ms"].items())},
            inflight_depths=dict(Counter(run["depths"])), launches=out[key])
        if run["tuning"] is not None:
            live[key].update(tuner=run["tuning"]["tuner"],
                             learned_service_ms=run["tuning"]["controller"]["service_ms"],
                             decisions=run["tuning"]["controller"]["decisions"],
                             tuned_max_wait_ms=run["tuning"]["controller"]["max_wait_ms"])
    print(f"{name} (b), paced in wall time ({len(records)} txns over "
          f"{times[-1]:.2f} s, offered {len(records) / times[-1]:.0f} txn/s): each id "
          f"emitted once, lag 0, no high-priority shed; " + json.dumps(live), flush=True)
    return out


def chunked(tokens):
    """Per-batch (ids, mask) pairs regrouped into chunks of up to ``BATCH``
    rows (the noise bound runs BERT once a chunk)."""
    import numpy as np

    ids = np.concatenate([np.asarray(i) for i, _ in tokens])
    mask = np.concatenate([np.asarray(m) for _, m in tokens])
    return [(ids[k:k + BATCH], mask[k:k + BATCH]) for k in range(0, len(ids), BATCH)]


def rung_sweep(scorer, reps: int = 20) -> dict:
    """What each rung buys at one shape: one seeded TINY bucket-256 batch
    through ``dispatch_assembled`` + ``finalize`` at every rung, the
    megakernel's device ms a launch (profiler) and the host ms of the call
    (p50 over ``reps`` calls a rung, the rungs interleaved)."""
    import numpy as np

    from realtime_fraud_detection_tpu_torch.obs.profiling import interpolated_percentile
    from realtime_fraud_detection_tpu_torch.qos.ladder import LADDER_LEVELS
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
        MODEL_NAMES,
        make_example_batch,
    )

    batch = make_example_batch(BATCH, rng=np.random.default_rng(SEED + 13))
    records = [{"transaction_id": f"rung-{i}"} for i in range(BATCH)]

    def at(level):
        rung = LADDER_LEVELS[level]
        mask = np.asarray([n not in rung.dropped_branches for n in MODEL_NAMES])
        scorer.set_degradation(None if level == 0 else mask,
                               rules_only=rung.rules_only, level=level)

    def call():
        scorer.finalize(scorer.dispatch_assembled(batch, records))

    out, host = {}, {level: [] for level in range(len(LADDER_LEVELS))}
    try:
        for level, rung in enumerate(LADDER_LEVELS):
            at(level)
            kernels = [e for e in device_events(call, want="megakernel")
                       if "megakernel" in e.key]
            launches = sum(e.count for e in kernels)
            if not launches:
                fail(f"rung sweep: the profiler saw no megakernel launch at {rung.name}")
            out[rung.name] = dict(megakernel_device_ms=sum(
                e.self_device_time_total for e in kernels) / launches / 1e3,
                profiled_launches=launches)
        for _ in range(reps):
            for level in host:
                at(level)
                t0 = time.perf_counter()
                call()
                host[level].append((time.perf_counter() - t0) * 1e3)
    finally:
        scorer.set_degradation(None)
    for level, rung in enumerate(LADDER_LEVELS):
        out[rung.name]["host_ms_p50"] = interpolated_percentile(sorted(host[level]), 0.5)
    return out


def qos_tokens(scorer, arrivals, ids):
    """The (ids, mask) pairs the scorer's tokenizer gives the texts of the
    records ``ids`` (the drill's bound is measured on a rung's own tokens)."""
    records = [r for k in sorted(arrivals) for r in arrivals[k]
               if r["transaction_id"] in ids]
    merchant_ids = [str(r.get("merchant_id", "")) for r in records]
    mprofs = {m: p for m in merchant_ids
              if (p := scorer.profiles.get_merchant(m)) is not None}
    texts = scorer._texts_for(records, merchant_ids, mprofs)
    return [scorer.tokenizer.encode_batch(texts[i:i + BATCH])
            for i in range(0, len(texts), BATCH)]


def qos_latencies(run, arrivals):
    """(completion, ingest) virtual times of every admitted record: the
    budget histogram's observations, recomputed from the predictions'
    order (a batch completes when the next one is dispatched)."""
    ts = {r["transaction_id"]: k * QOS_PERIOD_S
          for k in arrivals for r in arrivals[k]}
    out = []
    for b in run["batches"]:
        out += [(b["t_done"], ts[i]) for i in b["ids"]]
    return out


def run_quality_artifact(ops, models):
    """``Config()`` + ``apply_quality_artifact`` of the committed
    ``QUALITY_r05.json``: its selected blend (trees, LSTM, isolation forest)
    is the scorer's validity, served on one TINY bucket-256 batch in one
    megakernel launch with ``mega_valid`` (T, T, F, F, T), held against the
    kernels-off plain path on the card."""
    from pathlib import Path

    import numpy as np

    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import make_example_batch
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    artifact = Path(__file__).resolve().with_name("QUALITY_r05.json")
    scorers = {}
    for label, kernels in (("mega", KernelSettings.mega()), ("plain", None)):
        config = Config(quant=QuantSettings.full())
        if kernels is not None:
            config.kernels = kernels
        weights = config.apply_quality_artifact(str(artifact))
        scorers[label] = TorchFraudScorer(config, models=models,
                                          bert_config=TINY_CONFIG, device="cuda")
    mega, plain = scorers["mega"], scorers["plain"]
    valid = tuple(bool(v) for v in mega.model_valid)
    if valid != (True, True, False, False, True):
        fail(f"quality artifact: validity {valid}")
    batch = make_example_batch(BATCH, rng=np.random.default_rng(SEED + 11))
    records = [{"transaction_id": f"qa-{i}"} for i in range(BATCH)]
    ops.reset_launch_counts()
    seen = []
    from realtime_fraud_detection_tpu_torch.ops import megakernel as mk
    launch = mk._launch

    def spy(entry, inputs, b, dev, params, mega_valid):
        seen.append(tuple(mega_valid))
        return launch(entry, inputs, b, dev, params, mega_valid)

    mk._launch = spy
    try:
        pending = mega.dispatch_assembled(batch, records)
        results = mega.finalize(pending)
    finally:
        mk._launch = launch
    got = ops.launch_counts()
    if got != {"epilogue": 0, "flash_attention": 0, "dequant_matmul": 0,
               "dequant_rows": 0, "megakernel": 1} or seen != [valid]:
        fail(f"quality artifact: launches {got}, mega_valid {seen}")
    ref_pending = plain.dispatch_assembled(batch, records)
    ref_results = plain.finalize(ref_pending)
    mat, ref = pending.out, ref_pending.out
    tol = noise_bound(mega.models, TINY_CONFIG, [(batch.token_ids, batch.token_mask)],
                      mega.ensemble_params.weights, valid)
    err = float((mat[:, 0] - ref[:, 0]).abs().max())
    rungs = (0.3, 0.6, 0.8, 0.95, 0.7)
    far = ~(near_rung(ref[:, 0], rungs, tol) | near_rung(ref[:, 1], rungs, tol))
    if not err <= tol or not torch.equal(mat[far][:, 2:4], ref[far][:, 2:4]):
        fail(f"quality artifact: prob err {err} (bound {tol}) or decisions differ")
    branches = {n for r in results for n in r["model_predictions"]}
    if branches != {n for r in ref_results for n in r["model_predictions"]} or \
            branches != {"xgboost_primary", "lstm_sequential", "isolation_forest"}:
        fail(f"quality artifact: served branches {branches}")
    print(f"quality artifact {artifact.name}: blend {json.dumps(weights)} served in one "
          f"megakernel launch with mega_valid {valid}; prob max err {err:.3e} vs the "
          f"kernels-off plain path, decision/risk equal on all {int(far.sum())}/{BATCH} "
          f"rows farther than the bound {tol:.3e} from a rung", flush=True)


# the serving phase: the port's ServingApp on 127.0.0.1:0 with the scorer
# injected, the run-job simulator's users and merchants; the concurrency cap
# raised to the body's 256 rows so /batch-predict admits it (64 clients stay
# under it), the prediction timeout to 60 s, no dedicated metrics listener
SERVE_CLIENTS = 64
SERVE_PREDICTS = 4 * BATCH
# cut from 8 batches to 4 for the command's time limit
SERVE_SWAP_PREDICTS = 4 * BATCH
SERVE_SEQUENTIAL = 64
RUNGS = (0.3, 0.6, 0.8, 0.95, 0.7)      # risk and decision rungs, confidence


class AppThread:
    """A ``ServingApp`` serving from an event loop of its own thread;
    ``start`` builds the kernels before it listens. ``request`` is one HTTP
    call on a fresh connection."""

    def __init__(self, app):
        import asyncio
        import threading

        self.app = app
        self.loop = asyncio.new_event_loop()
        self.started = threading.Event()
        self.error = None
        self.thread = threading.Thread(target=self._run, name="serving", daemon=True)

    def _run(self):
        import asyncio

        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_until_complete(self.app.start())
        except Exception as e:          # reported by __enter__
            self.error = e
            self.started.set()
            return
        self.started.set()
        self.loop.run_forever()

    def __enter__(self):
        self.thread.start()
        if not self.started.wait(600) or self.error is not None:
            fail(f"the serving app did not start: {self.error!r}")
        return self

    def __exit__(self, *exc):
        import asyncio

        asyncio.run_coroutine_threadsafe(self.app.stop(), self.loop).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)
        if self.thread.is_alive():
            fail("the serving app's thread did not stop")
        self.loop.close()

    def request(self, method, path, body=None):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.app.port, timeout=120)
        try:
            conn.request(method, path, body=json.dumps(body) if body is not None else None,
                         headers={"Content-Type": "application/json"} if body else {})
            resp = conn.getresponse()
            raw = resp.read()
        finally:
            conn.close()
        ctype = resp.getheader("Content-Type", "")
        return resp.status, (json.loads(raw) if "json" in ctype else raw.decode())


def serving_app(models, bert_config, kernels, device, profiles, overlap=False,
                tracing=False, feedback=False):
    """A ``ServingApp`` on a fresh ``TorchFraudScorer`` (int8 BERT) with the
    simulator's profiles (``feedback``: the feedback plane on)."""
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.serving.app import ServingApp
    from realtime_fraud_detection_tpu_torch.utils.config import Config, QuantSettings

    config = Config(quant=QuantSettings.full(), kernels=kernels)
    config.serving.max_concurrent_predictions = BATCH
    config.serving.prediction_timeout_seconds = 60.0
    config.serving.overlap_assembly = overlap
    config.tracing.enabled = tracing
    config.feedback.enabled = feedback
    config.monitoring.prometheus_port = 0
    scorer = TorchFraudScorer(config, models=models, bert_config=bert_config,
                              device=device)
    scorer.seed_profiles(*profiles)
    return ServingApp(config, scorer=scorer, host="127.0.0.1", port=0, device=device)


def dispatch_spy(scorer, ops, batches):
    """Wrap ``scorer.dispatch`` (the app calls it under its score lock):
    each batch appends its records, the launch counters' growth, the
    megakernel's dispatch / fallback growth and which model set it was
    launched with (the ``id`` of ``scorer.models``)."""
    dispatch = scorer.dispatch

    def spy(records, now=None, **kw):
        before = ops.launch_counts()
        snap0 = scorer.kernel_snapshot()
        models = id(scorer.models)
        out = dispatch(records, now=now, **kw)
        after = ops.launch_counts()
        snap = scorer.kernel_snapshot()
        batches.append(dict(
            records=list(records), rows=len(records), models=models,
            launches={k: after[k] - before[k] for k in after if after[k] > before[k]},
            kernel_launches=snap["kernel_launches"],
            mega_fallback=snap["fallback"]["megakernel"] - snap0["fallback"]["megakernel"]))
        return out

    scorer.dispatch = spy


def token_spy(scorer, tokens):
    assemble = scorer.assemble

    def keep(*args, **kwargs):
        batch = assemble(*args, **kwargs)
        tokens.append((batch.token_ids, batch.token_mask))
        return batch

    scorer.assemble = keep


def compare_answers(name, got, want, tol, label):
    """Answers matched by transaction id: fraud_score and confidence within
    ``tol`` (the drill's bound), decision and risk level equal on every row
    whose reference probability and confidence lie farther than ``tol``
    from a rung. Returns (max err, rows compared exactly, rows skipped)."""
    ref = {a["transaction_id"]: a for a in want}
    if sorted(ref) != sorted(a["transaction_id"] for a in got):
        fail(f"{name}: ids differ from {label}")
    err, exact = 0.0, 0
    for a in got:
        b = ref[a["transaction_id"]]
        for key in ("fraud_score", "confidence"):
            err = max(err, abs(a[key] - b[key]))
        near = any(abs(b[key] - r) <= tol for key in ("fraud_probability", "confidence")
                   for r in RUNGS)
        if not near:
            exact += 1
            if (a["decision"], a["risk_level"]) != (b["decision"], b["risk_level"]):
                fail(f"{name}: {a['transaction_id']} {a['decision']}/{a['risk_level']}"
                     f" vs {label} {b['decision']}/{b['risk_level']}")
    if not err <= tol:
        fail(f"{name}: fraud_score / confidence err {err} vs {label} (bound {tol})")
    return err, exact, len(got) - exact


def run_load_process(port, txns, progress_at=None, on_progress=None):
    """``serving/loadgen.py`` in a process of its own (the clients must not
    share the server's interpreter), its answers read back; calls
    ``on_progress`` once ``progress_at`` answers are in."""
    import os
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        txn_path, out_path = os.path.join(tmp, "txns.json"), os.path.join(tmp, "out.json")
        with open(txn_path, "w") as f:
            json.dump(txns, f)
        cmd = [sys.executable, "-m", "realtime_fraud_detection_tpu_torch.serving.loadgen",
               "--port", str(port), "--clients", str(SERVE_CLIENTS), "--txns", txn_path,
               "--out", out_path]
        if progress_at is not None:
            cmd += ["--progress-at", str(progress_at)]
        proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, text=True)
        try:
            lines = []
            for line in proc.stdout:
                if line.strip() == "progress" and on_progress is not None:
                    on_progress()
                else:
                    lines.append(line)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if rc != 0:
            fail(f"the load generator exited {rc}: {''.join(lines)[-2000:]}")
        with open(out_path) as f:
            result = json.load(f)
    ids = [t["transaction_id"] for t in txns]
    answered = [a["body"].get("transaction_id") for a in result["answers"]]
    if sorted(answered) != sorted(ids) or len(set(answered)) != len(ids):
        fail("the load: not every transaction answered exactly once")
    bad = [a for a in result["answers"] if a["status"] != 200]
    if bad:
        fail(f"the load: {len(bad)} answers not 200, e.g. {bad[0]['status']} "
             f"{bad[0]['body']}")
    return result


def load_summary(result, batches):
    """Request latency percentiles and txn/s of a load, the microbatcher's
    batch sizes and the launches a batch."""
    from collections import Counter

    from realtime_fraud_detection_tpu_torch.obs.profiling import interpolated_percentile

    lat = sorted((a["t1"] - a["t0"]) * 1e3 for a in result["answers"])
    launches = Counter(json.dumps(b["launches"], sort_keys=True) for b in batches)
    return dict(
        requests=len(lat), clients=SERVE_CLIENTS, shed_503=result["shed_503"],
        wall_s=result["wall_s"], txn_per_s=len(lat) / result["wall_s"],
        p50_ms=interpolated_percentile(lat, 0.5), p99_ms=interpolated_percentile(lat, 0.99),
        max_ms=lat[-1], batches=len(batches),
        batch_sizes=dict(sorted(Counter(b["rows"] for b in batches).items())),
        launches_per_batch={k: n for k, n in launches.most_common()},
        one_row_batches=sum(b["rows"] == 1 for b in batches))


class GcCount:
    """Collections of the interpreter's garbage collector (by generation)
    and the time they took, while inside the ``with``."""

    def __enter__(self):
        import gc

        self.ms, self.collections, self._t0 = 0.0, [0, 0, 0], None

        def on_gc(phase, info):
            if phase == "start":
                self._t0 = time.perf_counter()
            elif self._t0 is not None:
                self.ms += (time.perf_counter() - self._t0) * 1e3
                self.collections[info["generation"]] += 1

        self._cb = on_gc
        gc.callbacks.append(on_gc)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)


def prom_value(text, series):
    """The value of one sample line of a Prometheus exposition (0 if absent)."""
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.split()[-1])
    return 0.0


def check_batches(name, batches, mega, chain):
    """Each batch the chain (``full()``, or a one-row batch under ``mega()``
    with one counted fallback) or one megakernel launch, the snapshot's
    ``kernel_launches`` equal to the counters' growth."""
    for b in batches:
        one = mega and b["rows"] == 1
        want = chain if (one or not mega) else {"megakernel": 1}
        if b["launches"] != want or b["mega_fallback"] != int(one) \
                or b["kernel_launches"] != sum(want.values()):
            fail(f"{name}: a {b['rows']}-row batch launched {b['launches']} "
                 f"(snapshot {b['kernel_launches']}, fallback {b['mega_fallback']})")


def serve_part(ops, name, bert_config, models, kernels, chain, profiles, gen):
    """One width's service on the card: a ``/batch-predict`` of 256 seeded
    transactions (launch counters reset just before, read just after) held
    against the same body through a CPU port app with the same models, then
    ``SERVE_PREDICTS`` ``/predict`` from ``SERVE_CLIENTS`` clients in
    another process, traced (the tracer's ``/latency/breakdown`` of the load
    beside the clients' latencies: the difference is the HTTP path); under
    ``mega()`` then 16 ``/predict`` one at a time (one-row batches);
    ``/health`` and ``/metrics/prometheus`` read once.
    ``chain`` is the per-site chain's launches a batch; under
    ``KernelSettings.mega()`` a batch of two or more rows launches the
    megakernel once and a one-row batch runs the chain and counts a
    fallback. Returns the load's launch counts and the body."""
    mega = kernels.megakernel == "cuda"
    body = gen.generate_batch(BATCH)
    load = gen.generate_batch(SERVE_PREDICTS)
    app = serving_app(models, bert_config, kernels, "cuda", profiles, tracing=True)
    tokens, batches = [], []
    token_spy(app.scorer, tokens)
    dispatch_spy(app.scorer, ops, batches)
    with AppThread(app) as srv:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        status, out = srv.request("POST", "/batch-predict", {"transactions": body})
        torch.cuda.synchronize()
        body_launches = {k: v for k, v in ops.launch_counts().items() if v}
        want = {"megakernel": 1} if mega else chain
        if status != 200 or out["count"] != BATCH:
            fail(f"{name} /batch-predict: {status} {str(out)[:300]}")
        if body_launches != want:
            fail(f"{name} /batch-predict launches {body_launches} != {want}")
        tol = noise_bound(app.scorer.models, bert_config, tokens,
                          app.scorer.ensemble_params.weights)
        t0 = time.perf_counter()
        cpu = serving_app(models, bert_config, kernels, "cpu", profiles)
        with AppThread(cpu) as ref:
            ref_status, ref_out = ref.request("POST", "/batch-predict",
                                              {"transactions": body})
        cpu_s = time.perf_counter() - t0
        if ref_status != 200:
            fail(f"{name} CPU /batch-predict: {ref_status}")
        err, exact, skipped = compare_answers(f"{name} /batch-predict", out["results"],
                                              ref_out["results"], tol, "the CPU app")
        print(f"{name} /batch-predict of {BATCH}: launches {body_launches}; vs a CPU "
              f"port app on the same body ({cpu_s:.1f} s on the CPU): fraud_score / "
              f"confidence max err {err:.3e} (drill bound {tol:.3e}), decision and risk "
              f"equal on all {exact} rows off a rung ({skipped} skipped)", flush=True)

        batches.clear()
        ops.reset_launch_counts()
        with GcCount() as gc_count:
            result = run_load_process(app.port, load)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        summary = load_summary(result, batches)
        check_batches(f"{name} load", batches, mega, chain)
        status, bd = srv.request("GET", "/latency/breakdown")
        if status != 200 or bd["n"] != SERVE_PREDICTS:
            fail(f"{name}: /latency/breakdown {status}, {bd.get('n')} scored traces")
        summary["trace_breakdown"] = {
            q: {k: bd["quantiles"][q][k] for k in ("e2e_ms", "dominant_stage", "stage_ms")}
            for q in ("p50", "p99")}
        if mega:
            batches.clear()
            for txn in gen.generate_batch(16):
                status, out = srv.request("POST", "/predict", txn)
                if status != 200:
                    fail(f"{name} sequential /predict: {status} {out}")
            if [b["rows"] for b in batches] != [1] * 16:
                fail(f"{name} sequential /predict: batches {[b['rows'] for b in batches]}")
            check_batches(f"{name} sequential", batches, mega, chain)
            summary["sequential_one_row_batches"] = dict(
                batches=16, launches_each=batches[0]["launches"],
                fallbacks=sum(b["mega_fallback"] for b in batches))
        status, health = srv.request("GET", "/health")
        status_p, prom = srv.request("GET", "/metrics/prometheus")
        if status != 200 or health["status"] != "healthy" or status_p != 200:
            fail(f"{name}: /health {status} {health}, /metrics/prometheus {status_p}")
        snap = app.scorer.kernel_snapshot()
        fallback = prom_value(prom, 'kernel_fallback_total{site="megakernel"}')
        if mega and (fallback != snap["fallback"]["megakernel"] or fallback < 16):
            fail(f"{name}: kernel_fallback_total {fallback} != snapshot {snap['fallback']}")
        summary.update(
            gc_collections=gc_count.collections, gc_ms=gc_count.ms,
            kernel_fallback_total={s: prom_value(prom, f'kernel_fallback_total{{site="{s}"}}')
                                   for s in snap["fallback"]},
            kernel_launches_per_batch=prom_value(prom, "kernel_launches_per_batch"),
            health=health)
    print(f"{name} load: {json.dumps(summary)}", flush=True)
    return dict(launches=launches, body=body)


def run_hot_swap(ops, models, new_models, profiles, gen):
    """Phase 16(b)'s hot swap: a fresh TINY ``mega()`` app takes
    ``SERVE_SWAP_PREDICTS`` ``/predict`` from ``SERVE_CLIENTS`` clients; once a
    quarter are answered, ``/reload-models`` restores a port checkpoint of
    ``new_models`` while the rest are in flight. Every transaction answered
    once with a 200 (503s counted and retried); the batches the app
    dispatched are replayed in order through two kernels-off card scorers,
    one with each model set (the scorer's state does not depend on the
    models, so both see the app's state); each answer equals the replay
    under the set its batch was launched with, and every request sent after
    the reload returned was answered by the new set."""
    import tempfile

    from realtime_fraud_detection_tpu_torch.checkpoint import CheckpointManager
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    load = gen.generate_batch(SERVE_SWAP_PREDICTS)
    app = serving_app(models, TINY_CONFIG, KernelSettings.mega(), "cuda", profiles)
    batches, tokens = [], []
    dispatch_spy(app.scorer, ops, batches)
    token_spy(app.scorer, tokens)
    old_models = app.scorer.models
    old_id = id(old_models)
    reload = {}
    with tempfile.TemporaryDirectory() as ckdir, AppThread(app) as srv:
        CheckpointManager(ckdir).save(1, params=new_models)

        def swap():
            reload["t0"] = time.monotonic()
            reload["status"], reload["out"] = srv.request(
                "POST", "/reload-models", {"checkpoint_dir": ckdir})
            reload["t1"] = time.monotonic()

        result = run_load_process(app.port, load, progress_at=SERVE_SWAP_PREDICTS // 4,
                                  on_progress=swap)
        status, health = srv.request("GET", "/health")
        status_p, prom = srv.request("GET", "/metrics/prometheus")
        new_dev = app.scorer.models
        new_id = id(new_dev)
    if reload.get("status") != 200 or reload["out"]["source"].get("step") != 1:
        fail(f"hot swap: /reload-models {reload}")
    if status != 200 or status_p != 200 or new_id == old_id:
        fail(f"hot swap: /health {status}, /metrics/prometheus {status_p}")
    sets = {old_id: "old", new_id: "new"}
    if {b["models"] for b in batches} != set(sets):
        fail(f"hot swap: batches launched with {len({b['models'] for b in batches})} "
             f"model sets")
    # the replay: the same batches in the same order, on each model set
    refs = {}
    for label, m in (("old", models), ("new", new_models)):
        plain = TorchFraudScorer(Config(quant=QuantSettings.full()), models=m,
                                 bert_config=TINY_CONFIG, device="cuda")
        plain.seed_profiles(*profiles)
        refs[label] = {}
        for b in batches:
            for r in plain.finalize(plain.dispatch(b["records"])):
                refs[label][r["transaction_id"]] = r
    used = {r["transaction_id"]: sets[b["models"]] for b in batches for r in b["records"]}
    tol = max(noise_bound(m, TINY_CONFIG, tokens, app.scorer.ensemble_params.weights)
              for m in (old_models, new_dev))
    answers = {a["body"]["transaction_id"]: a for a in result["answers"]}
    late_old = [i for i, a in answers.items()
                if a["t0"] > reload["t1"] and used[i] != "new"]
    if late_old:
        fail(f"hot swap: {len(late_old)} requests sent after the reload returned were "
             f"answered by the old models")
    errs, counts = {}, {}
    for label in ("old", "new"):
        got = [a["body"] for i, a in answers.items() if used[i] == label]
        want = [refs[label][a["transaction_id"]] for a in got]
        counts[label] = len(got)
        errs[label] = compare_answers(f"hot swap ({label} set)", got, want, tol,
                                      f"the plain path on the {label} models")
    after_reload = sum(a["t0"] > reload["t1"] for a in answers.values())
    summary = dict(
        requests=len(answers), shed_503=result["shed_503"], batches=len(batches),
        answered_by=counts, sent_after_reload=after_reload,
        reload_ms=(reload["t1"] - reload["t0"]) * 1e3,
        max_err={k: v[0] for k, v in errs.items()},
        rows_exact={k: v[1] for k, v in errs.items()},
        rows_skipped={k: v[2] for k, v in errs.items()}, bound=tol,
        one_row_batches=sum(b["rows"] == 1 for b in batches),
        kernel_fallback_megakernel=prom_value(
            prom, 'kernel_fallback_total{site="megakernel"}'),
        health_queue_depth=health["queue_depth"])
    print(f"TINY hot swap under load: every transaction answered once with a 200, "
          f"each answer the plain path's on the set its batch was launched with, "
          f"none sent after the reload answered by the old set: {json.dumps(summary)}",
          flush=True)
    return summary


def run_overlap_serving(ops, models, chain, profiles, gen, body):
    """Phase 16(c): ``serving.overlap_assembly`` on and off, DistilBERT-base
    under ``KernelSettings.full()``: the first ``SERVE_SEQUENTIAL`` of (a)'s
    body sent one at a time as ``/predict`` to each app (fresh scorers, the
    same models and profiles), decisions equal off a rung and scores within
    the drill's bound; then ``SERVE_PREDICTS`` concurrent ``/predict`` on the
    overlapped app, two batches in flight."""
    from realtime_fraud_detection_tpu_torch.models.bert import DISTILBERT_BASE
    from realtime_fraud_detection_tpu_torch.utils.config import KernelSettings

    seq = body[:SERVE_SEQUENTIAL]
    answers, tokens = {}, []
    for overlap in (False, True):
        app = serving_app(models, DISTILBERT_BASE, KernelSettings.full(), "cuda",
                          profiles, overlap=overlap)
        if not overlap:
            token_spy(app.scorer, tokens)
            ref_models = app.scorer.models
        batches = []
        dispatch_spy(app.scorer, ops, batches)
        with AppThread(app) as srv:
            got = []
            for txn in seq:
                status, out = srv.request("POST", "/predict", txn)
                if status != 200:
                    fail(f"overlap={overlap} /predict: {status} {out}")
                got.append(out)
            answers[overlap] = got
            if any(b["launches"] != chain for b in batches):
                fail(f"overlap={overlap}: a batch launched other than {chain}")
            if overlap:
                batches.clear()
                ops.reset_launch_counts()
                with GcCount() as gc_count:
                    result = run_load_process(app.port, gen.generate_batch(SERVE_PREDICTS))
                torch.cuda.synchronize()
                launches = ops.launch_counts()
                summary = load_summary(result, batches)
                summary.update(gc_collections=gc_count.collections, gc_ms=gc_count.ms)
                if any(b["launches"] != chain for b in batches):
                    fail("overlapped load: a batch launched other than the chain")
                status, health = srv.request("GET", "/health")
                status_p, _ = srv.request("GET", "/metrics/prometheus")
                if status != 200 or status_p != 200:
                    fail(f"overlapped app: /health {status}, /metrics/prometheus {status_p}")
    tol = noise_bound(ref_models, DISTILBERT_BASE, tokens,
                      app.scorer.ensemble_params.weights)
    err, exact, skipped = compare_answers("overlapped /predict", answers[True],
                                          answers[False], tol, "two-phase off")
    print(f"DistilBERT-base sequential /predict x{SERVE_SEQUENTIAL}, overlap on vs off: "
          f"max err {err:.3e} (bound {tol:.3e}), decisions equal on {exact} rows off a "
          f"rung ({skipped} skipped); overlapped load: {json.dumps(summary)}", flush=True)
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_serve_command(gen):
    """Phase 16(d): ``python -m realtime_fraud_detection_tpu_torch serve
    --mega`` in a process of its own (a ``--config`` file moves its
    dedicated metrics listener to a free port): ``/health`` polled until it
    answers, the ``health-check`` command, four ``/predict`` and the
    dedicated listener's ``/metrics``, then SIGTERM: the service drains and
    exits 0."""
    import http.client
    import os
    import signal
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parent
    port, metrics_port = free_port(), free_port()

    def call(p, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", p, timeout=60)
        try:
            conn.request(method, path, body=json.dumps(body) if body else None)
            resp = conn.getresponse()
            return resp.status, resp.read().decode()
        finally:
            conn.close()

    with tempfile.TemporaryDirectory() as tmp:
        cfg, log = os.path.join(tmp, "serve.json"), os.path.join(tmp, "serve.log")
        with open(cfg, "w") as f:
            json.dump({"monitoring": {"prometheus_port": metrics_port}}, f)
        t0 = time.perf_counter()
        with open(log, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m", "realtime_fraud_detection_tpu_torch", "serve",
                 "--mega", "--host", "127.0.0.1", "--port", str(port), "--config", cfg],
                cwd=root, stdout=err, stderr=subprocess.STDOUT)
        try:
            while True:
                try:
                    status, _ = call(port, "GET", "/health")
                    break
                except OSError:
                    if proc.poll() is not None or time.perf_counter() - t0 > 300:
                        fail(f"serve did not come up (exit {proc.poll()}): "
                             f"{open(log).read()[-2000:]}")
                    time.sleep(0.25)
            t_up = time.perf_counter() - t0
            check = subprocess.run(
                [sys.executable, "-m", "realtime_fraud_detection_tpu_torch",
                 "health-check", "--url", f"http://127.0.0.1:{port}"],
                cwd=root, capture_output=True, text=True, timeout=120)
            answers = [call(port, "POST", "/predict", t) for t in gen.generate_batch(4)]
            m_status, m_text = call(metrics_port, "GET", "/metrics")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out = open(log).read()
    if status != 200 or check.returncode != 0 \
            or not json.loads(check.stdout.strip().splitlines()[-1])["healthy"]:
        fail(f"serve --mega: /health {status}, health-check {check.returncode} "
             f"{check.stdout[-500:]}")
    if any(a[0] != 200 for a in answers) or m_status != 200 \
            or "kernel_mega_dispatch_total" not in m_text or rc != 0:
        fail(f"serve --mega: /predict {[a[0] for a in answers]}, metrics {m_status}, "
             f"exit {rc}: {out[-2000:]}")
    decisions = [json.loads(a[1])["decision"] for a in answers]
    print(f"serve --mega (its own process): up in {t_up:.1f} s, health-check "
          f"{check.stdout.strip().splitlines()[-1][:120]}..., /predict x4 {decisions}, "
          f"dedicated /metrics 200, SIGTERM exit {rc}", flush=True)


def run_serving(ops):
    """Phase 16: the scoring service on the card (see the module docstring)."""
    import dataclasses

    from realtime_fraud_detection_tpu_torch.models.bert import DISTILBERT_BASE, TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.models.quant import quantize_bert_params
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import init_scoring_models
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.utils.config import KernelSettings

    gen = TransactionGenerator(num_users=STREAM_USERS, num_merchants=STREAM_MERCHANTS,
                               seed=SEED + 16)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    chain = {"epilogue": 1, "flash_attention": DISTILBERT_BASE.num_layers,
             "dequant_matmul": 6 * DISTILBERT_BASE.num_layers, "dequant_rows": 2}
    tiny_chain = {"epilogue": 1, "flash_attention": TINY_CONFIG.num_layers,
                  "dequant_matmul": 6 * TINY_CONFIG.num_layers, "dequant_rows": 2}
    t0 = time.perf_counter()
    base = serve_part(ops, "DistilBERT-base", DISTILBERT_BASE,
                      seeded_models(DISTILBERT_BASE), KernelSettings.full(), chain,
                      profiles, gen)
    t_a = time.perf_counter()
    tiny = serve_part(ops, "TINY mega", TINY_CONFIG, seeded_models(TINY_CONFIG),
                      KernelSettings.mega(), tiny_chain, profiles, gen)
    second = init_scoring_models(SEED + 1, TINY_CONFIG)
    swap = run_hot_swap(ops, seeded_models(TINY_CONFIG), dataclasses.replace(
        second, bert=quantize_bert_params(second.bert)), profiles, gen)
    t_b = time.perf_counter()
    overlap = run_overlap_serving(ops, seeded_models(DISTILBERT_BASE), chain, profiles,
                                  gen, base["body"])
    t_c = time.perf_counter()
    run_serve_command(gen)
    t_d = time.perf_counter()
    print(f"serving phase: (a) {t_a - t0:.1f} s, (b) {t_b - t_a:.1f} s "
          f"(hot swap: {swap['requests']} answered), (c) {t_c - t_b:.1f} s, "
          f"(d) {t_d - t_c:.1f} s", flush=True)
    return {"serve_distilbert_base": base["launches"], "serve_tiny_mega": tiny["launches"],
            "serve_overlap": overlap}


# the training phase (17): the port's train / validate / quality-eval commands
# on the card, each in a process of its own, and the trained weights served
# through every ported kernel. The CPU side of each pair runs beside the card
# side on half the machine's cores (TRAIN_CPU_THREADS), so the card process's
# host half is not starved.
TRAIN_CPU_THREADS = "4"
# |card - CPU| held-out AUC of each neural branch after ``train --neural``:
# the same data, seed and initial weights, the f32 arithmetic of two devices
# (and the card's atomic adds in the gather backward) diverging over ~70-110
# Adam steps
TRAIN_AUC_BAND = 0.05
# |card - CPU| AUC of ``validate`` on one checkpoint (the served bf16 path on
# two devices; 4,096 rows)
VALIDATE_AUC_TOL = 2e-3


def _port_proc(args, cpu: bool = False, stdout=subprocess.PIPE):
    """``python -m realtime_fraud_detection_tpu_torch <args>`` from the
    repository root, in a process of its own."""
    import os
    from pathlib import Path

    env = dict(os.environ)
    if cpu:
        env.update(OMP_NUM_THREADS=TRAIN_CPU_THREADS, MKL_NUM_THREADS=TRAIN_CPU_THREADS)
    return subprocess.Popen(
        [sys.executable, "-m", "realtime_fraud_detection_tpu_torch", *args],
        cwd=Path(__file__).resolve().parent, env=env, stdout=stdout,
        stderr=subprocess.PIPE, text=True)


def _finish(name, proc, want_rc=0, timeout=900):
    """Wait for a command; its exit code must be ``want_rc``. Returns the
    (stdout, stderr) text and the seconds it took from here."""
    t0 = time.perf_counter()
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != want_rc:
        fail(f"{name}: exit {proc.returncode} (want {want_rc}): {err[-3000:]}")
    return out or "", err, time.perf_counter() - t0


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _stderr_json(err: str, prefix: str) -> dict:
    line = [ln for ln in err.splitlines() if prefix in ln][-1]
    return json.loads(line.split(prefix, 1)[1])


def held_out_aucs(models, data, device="cuda") -> dict:
    """Held-out AUC of each neural branch of ``models`` (the plain path, the
    served bf16 products) on ``data`` (the port's dataset builders)."""
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG, bert_logits
    from realtime_fraud_detection_tpu_torch.models.gnn import gnn_logits
    from realtime_fraud_detection_tpu_torch.models.lstm import lstm_logits
    from realtime_fraud_detection_tpu_torch.training.blend_eval import _auc
    from realtime_fraud_detection_tpu_torch.training.neural import eval_logits

    dev = torch.device(device)
    m = models.to(dev)
    seqs, lens, y_seq = data["sequence"]
    graph, y_graph = data["graph"]
    ids, mask, y_text = data["text"]
    lg = eval_logits(lambda p, i, k: bert_logits(p, i, k, TINY_CONFIG), m.bert,
                      (ids, mask), dev)
    return {"lstm": _auc(y_seq, eval_logits(lstm_logits, m.lstm, (seqs, lens), dev)),
            "gnn": _auc(y_graph, eval_logits(gnn_logits, m.gnn, graph, dev)),
            "bert": _auc(y_text, lg[:, 1] - lg[:, 0])}


def held_out_data():
    """4,096 held-out rows per neural branch from a fresh seeded stream at
    the ``train`` defaults' pool sizes (seed 43: never a training seed)."""
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.training.neural import (
        build_graph_dataset,
        build_sequence_dataset,
    )
    from realtime_fraud_detection_tpu_torch.training.text import build_text_dataset

    def gen():
        return TransactionGenerator(num_users=10_000, num_merchants=5_000, seed=43)

    graph, y_graph, _ = build_graph_dataset(gen(), 4096)
    return {"sequence": build_sequence_dataset(gen(), 4096), "graph": (graph, y_graph),
            "text": build_text_dataset(gen(), 4096, max_length=64)}


def _trees_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("feature", "threshold", "leaf", "base_score"))


def _forest_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("feature", "threshold", "path_length", "c_psi"))


def served_batch(scorer, gen):
    """``BATCH`` seeded stream records assembled by ``scorer`` (its profiles
    seeded from ``gen``): the host batch and the records."""
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    records = gen.generate_batch(BATCH)
    return scorer.assemble(records), records


def compare_packed(name, got, ref, tol):
    """The packed result against the plain path's: probability and
    confidence within ``tol``, decision and risk equal on every row farther
    than ``tol`` from a rung."""
    err = float((got[:, :2] - ref[:, :2]).abs().max())
    far = ~(near_rung(ref[:, 0], (0.3, 0.6, 0.8, 0.95), tol)
            | near_rung(ref[:, 1], (0.7,), tol))
    if not err <= tol or not torch.equal(got[far][:, 2:4], ref[far][:, 2:4]):
        fail(f"{name}: prob/confidence err {err} (bound {tol}) or decisions differ")
    return err, int(far.sum())


def serve_trained(ops, ck_dir, gen):
    """17(c): the ``train --neural`` checkpoint restored into TINY scorers
    with int8 BERT (an f32 checkpoint into an int8 scorer: quantized on the
    host as ``serve --quant --allow-arch-mismatch`` does), one 256-row batch
    under ``full()`` (1 / 2 / 12 / 2 launches) and under ``mega()`` (one
    megakernel launch), each held against the kernels-off plain path on the
    same models."""
    from realtime_fraud_detection_tpu_torch.checkpoint import CheckpointManager
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    mgr = CheckpointManager(ck_dir)
    scorers = {}
    for label, kernels in (("plain", KernelSettings()), ("full", KernelSettings.full()),
                           ("mega", KernelSettings.mega())):
        s = TorchFraudScorer(Config(quant=QuantSettings.full(), kernels=kernels),
                             device="cuda")
        mgr.restore_into_scorer(s, allow_arch_mismatch=True)
        scorers[label] = s
    batch, records = served_batch(scorers["plain"], gen)
    ref = scorers["plain"].dispatch_assembled(batch, records)
    scorers["plain"].finalize(ref)
    plain = scorers["plain"]
    tol = noise_bound(plain.models, TINY_CONFIG, [(batch.token_ids, batch.token_mask)],
                      plain.ensemble_params.weights)
    want = {"full": {"epilogue": 1, "flash_attention": 2, "dequant_matmul": 12,
                     "dequant_rows": 2, "megakernel": 0},
            "mega": {"epilogue": 0, "flash_attention": 0, "dequant_matmul": 0,
                     "dequant_rows": 0, "megakernel": 1}}
    out = {}
    for label in ("full", "mega"):
        ops.reset_launch_counts()
        pending = scorers[label].dispatch_assembled(batch, records)
        scorers[label].finalize(pending)
        got = ops.launch_counts()
        if got != want[label]:
            fail(f"trained weights, {label}(): launches {got}")
        err, far = compare_packed(f"trained weights, {label}()", pending.out, ref.out,
                                  tol)
        out[label] = got
        print(f"  trained weights under {label}(): launches {json.dumps(got)}; prob max err "
              f"{err:.3e} (bound {tol:.3e}), decisions equal on {far}/{BATCH} rows away "
              f"from a rung", flush=True)
    return out


def typed_megakernel(ck_dir, gen_ring):
    """The megakernel's typed GNN on the card: typed parameters from
    ``train_typed_gnn`` (2,048 transactions of a fraud-ring stream, one
    epoch) in the trained TINY models with int8 BERT, one 256-row one-hop
    batch (a typed scorer's assembled batch without its two-hop frontiers),
    held against its plain version on the same inputs."""
    import dataclasses

    from realtime_fraud_detection_tpu_torch.checkpoint import CheckpointManager
    from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.models.quant import quantize_bert_params
    from realtime_fraud_detection_tpu_torch.ops import megakernel as mk
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES, ScorerConfig
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.training.neural import train_typed_gnn
    from realtime_fraud_detection_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    stats = {}
    gen = TransactionGenerator(num_users=2_000, num_merchants=500, seed=SEED + 19)
    gen.inject_fraud_ring()
    typed = train_typed_gnn(gen, n_transactions=2048, epochs=1, device="cuda", stats=stats)
    base = CheckpointManager(ck_dir).restore().params
    models = dataclasses.replace(base, gnn=typed, bert=quantize_bert_params(base.bert))
    assembler = TorchFraudScorer(Config(), models=models, device="cuda",
                                 scorer_config=ScorerConfig(graph_mode="typed"))
    gen_ring.inject_fraud_ring()
    assembler.seed_profiles(gen_ring.users.profiles(), gen_ring.merchants.profiles())
    for _ in range(3):          # the typed graph grows at write-back: score first
        assembler.score_batch(gen_ring.generate_batch(BATCH))
    batch = assembler.assemble(gen_ring.generate_batch(BATCH))
    one_hop = dataclasses.replace(batch, user_neigh2_feat=None, user_neigh2_mask=None,
                                  merch_neigh2_feat=None, merch_neigh2_mask=None)
    _, _, raw, plain_batch = _packed(one_hop, BATCH)
    models = models.to("cuda")
    params = EnsembleParams.from_config(Config(), MODEL_NAMES).to("cuda")
    plan = mk.mega_plan(models, TINY_CONFIG, b=BATCH, text_len=64, seq_len=10,
                        feature_dim=64, has_two_hop=False, fanout=int(raw.user_neigh_feat.shape[1]))
    if not plan["supported"] or not plan["typed_gnn"]:
        fail(f"typed megakernel: plan {plan}")
    mv = (True,) * 5
    got = mk.fused_megakernel(models, raw, params, mega_valid=mv, bert_config=TINY_CONFIG)
    ref = mk.megakernel_reference(models, plain_batch, params, mega_valid=mv,
                                  bert_config=TINY_CONFIG)
    torch.cuda.synchronize()
    gnn_col = 8 + MODEL_NAMES.index("graph_neural")
    gnn_err = float((got[:, gnn_col] - ref[:, gnn_col]).abs().max())
    tol = noise_bound(models, TINY_CONFIG, [(one_hop.token_ids, one_hop.token_mask)],
                      params.weights)
    err = float((got - ref).abs().max())
    if not (err <= tol and gnn_err <= 1e-5):
        fail(f"typed megakernel: err {err} (bound {tol}), GNN column err {gnn_err}")
    tagged = float((plain_batch.user_neigh_feat[..., 9:11].sum(-1) > 0).float().mean())
    if not tagged > 0:
        fail("typed megakernel: no device / IP neighbour rows in the batch")
    print(f"  typed GNN in the megakernel (params from train_typed_gnn, "
          f"{stats['steps']} steps at {stats['ms_per_step']:.2f} ms): one-hop batch of "
          f"{BATCH}, fanout {int(raw.user_neigh_feat.shape[1])}, {tagged:.3f} of the user "
          f"neighbour rows device/IP-tagged; GNN column max err {gnn_err:.3e} (bound 1e-5), "
          f"matrix max err {err:.3e} (bound {tol:.3e}) ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def serve_quality_artifact(ops, artifact, ck_dir, gen):
    """17(d) tail: the quality-eval artifact and its checkpoint applied
    together to a megakernel scorer at the artifact's text model, text
    length and tokenizer (int8 BERT; attention "reference": the per-site
    flash kernel takes head width 64 only, and this encoder's is 32), one
    256-row batch: one megakernel launch under the artifact's branch mask,
    against the kernels-off plain path."""
    import dataclasses

    from realtime_fraud_detection_tpu_torch.checkpoint import CheckpointManager
    from realtime_fraud_detection_tpu_torch.models.bert import BertConfig
    from realtime_fraud_detection_tpu_torch.ops import megakernel as mk
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import ScorerConfig
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    proto = json.load(open(artifact))["protocol"]
    bert_config = BertConfig(**proto["text_model"])
    sc = ScorerConfig(text_len=int(proto["text_len"]), tokenizer=proto["tokenizer"])
    scorers = {}
    for label, kernels in (("mega", dataclasses.replace(KernelSettings.mega(),
                                                        attention="reference")),
                           ("plain", KernelSettings())):
        config = Config(quant=QuantSettings.full(), kernels=kernels)
        weights = config.apply_quality_artifact(str(artifact))
        s = TorchFraudScorer(config, bert_config=bert_config, scorer_config=sc,
                             device="cuda")
        CheckpointManager(ck_dir).restore_into_scorer(s, allow_arch_mismatch=True)
        scorers[label] = s
    mega, plain = scorers["mega"], scorers["plain"]
    valid = tuple(bool(v) for v in mega.model_valid)
    batch, records = served_batch(plain, gen)
    seen = []
    launch = mk._launch

    def spy(entry, inputs, b, dev, params, mega_valid):
        seen.append(tuple(mega_valid))
        return launch(entry, inputs, b, dev, params, mega_valid)

    ops.reset_launch_counts()
    mk._launch = spy
    try:
        pending = mega.dispatch_assembled(batch, records)
        mega.finalize(pending)
    finally:
        mk._launch = launch
    got = ops.launch_counts()
    if got["megakernel"] != 1 or sum(got.values()) != 1 or seen != [valid]:
        fail(f"quality-eval artifact: launches {got}, mega_valid {seen} (want {valid})")
    ref = plain.dispatch_assembled(batch, records)
    plain.finalize(ref)
    tol = noise_bound(plain.models, bert_config, [(batch.token_ids, batch.token_mask)],
                      plain.ensemble_params.weights, valid)
    err, far = compare_packed("quality-eval artifact", pending.out, ref.out, tol)
    print(f"  quality-eval artifact + checkpoint: blend {json.dumps(weights)} "
          f"({mega.config.ensemble.strategy}) in one megakernel launch with mega_valid "
          f"{valid}; prob max err {err:.3e} (bound {tol:.3e}), decisions equal on "
          f"{far}/{BATCH} rows away from a rung", flush=True)


def run_training(ops):
    """Phase 17: the training plane on the card (see the module docstring)."""
    import tempfile
    from pathlib import Path

    from realtime_fraud_detection_tpu_torch.checkpoint import CheckpointManager
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator

    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        card_ck, cpu_ck, q_ck = (str(Path(tmp) / n) for n in ("card", "cpu", "quality"))
        artifact = out_dir / "quality_eval_card.json"
        t0 = time.perf_counter()
        try:
            # (a) train --neural on the card and on the CPU, side by side, and
            # (d) quality-eval on the card at BlendEvalConfig() defaults
            # beside the whole phase (it reads no checkpoint of (a))
            card = _port_proc(["train", "--neural", "--out", card_ck])
            cpu = _port_proc(["train", "--neural", "--device", "cpu", "--out", cpu_ck],
                             cpu=True)
            quality = _port_proc(["quality-eval", "--checkpoint-dir", q_ck,
                                  "--output", str(artifact)])
            procs += [card, cpu, quality]
            out_c, err_c, _ = _finish("train (card)", card)
            t_card = time.perf_counter() - t0
            # (b)'s commands read only the card's checkpoint: they start now,
            # beside the CPU's train
            t1 = time.perf_counter()
            prom = str(Path(tmp) / "validate.prom")
            v_card = _port_proc(["validate", "--checkpoint-dir", card_ck,
                                 "--metrics-out", prom])
            v_cpu = _port_proc(["validate", "--checkpoint-dir", card_ck, "--device", "cpu"],
                               cpu=True)
            v_gate = _port_proc(["validate", "--checkpoint-dir", card_ck,
                                 "--min-auc", "0.99"])
            procs += [v_card, v_cpu, v_gate]
            out_p, err_p, _ = _finish("train (cpu)", cpu)
            t_cpu = time.perf_counter() - t0
            rep = {"card": json.loads(out_c.strip().splitlines()[-1]),
                   "cpu": json.loads(out_p.strip().splitlines()[-1])}
            timing = {"card": _stderr_json(err_c, "train timing: "),
                      "cpu": _stderr_json(err_p, "train timing: ")}
            mc, mp = (CheckpointManager(d).restore().params for d in (card_ck, cpu_ck))
            if not (_trees_equal(mc.trees, mp.trees) and _forest_equal(mc.iforest, mp.iforest)):
                fail("train: the card's and the CPU's tree / isolation-forest arrays differ")
            if rep["card"]["auc"] != rep["cpu"]["auc"] or rep["card"][
                    "top_feature_importances"] != rep["cpu"]["top_feature_importances"]:
                fail(f"train: GBDT AUC / importances differ: {rep}")
            data = held_out_data()
            aucs = {k: held_out_aucs(m, data) for k, m in (("card", mc), ("cpu", mp))}
            gaps = {b: abs(aucs["card"][b] - aucs["cpu"][b]) for b in aucs["card"]}
            if not all(g <= TRAIN_AUC_BAND for g in gaps.values()):
                fail(f"train: held-out AUC card vs CPU {aucs} beyond {TRAIN_AUC_BAND}")
            tc = timing["card"]
            print(f"train --neural: card {t_card:.1f} s, CPU ({TRAIN_CPU_THREADS} threads) "
                  f"{t_cpu:.1f} s; trees and isolation forest equal, GBDT AUC "
                  f"{rep['card']['auc']} on both; GBDT host {tc['gbdt_host_s']:.2f} s, "
                  f"isolation forest host {tc['iforest_host_s']:.2f} s; ms per optimizer "
                  f"step on the card: " + json.dumps(
                      {b: round(tc[b]["ms_per_step"], 3) for b in ("lstm", "gnn", "bert")})
                  + " (steps " + json.dumps({b: tc[b]["steps"] for b in ("lstm", "gnn", "bert")})
                  + "), on the CPU: " + json.dumps(
                      {b: round(timing["cpu"][b]["ms_per_step"], 3)
                       for b in ("lstm", "gnn", "bert")}), flush=True)
            print("  held-out AUC (4,096 rows each, seed 43): " + json.dumps(
                {k: {b: round(v, 4) for b, v in a.items()} for k, a in aucs.items()})
                + f", |card - CPU| <= {TRAIN_AUC_BAND}", flush=True)

            # (b) validate on the card and on the CPU (started with the card's
            # checkpoint, above); --min-auc 0.99 gates
            vr = {}
            for name, p in (("card", v_card), ("cpu", v_cpu)):
                vr[name] = json.loads(_finish(f"validate ({name})", p)[0].strip().splitlines()[-1])
            gate_out, gate_err = v_gate.communicate(timeout=900)
            gate_rc = v_gate.returncode
            if not gate_out.strip():
                fail(f"validate --min-auc 0.99: exit {gate_rc}, no report: {gate_err[-2000:]}")
            gate = json.loads(gate_out.strip().splitlines()[-1])
            if list(vr["card"]) != list(vr["cpu"]) or abs(
                    vr["card"]["auc"] - vr["cpu"]["auc"]) > VALIDATE_AUC_TOL or any(
                    vr["card"][k] != vr["cpu"][k] for k in ("n", "fraud_rate", "eval_seed")):
                fail(f"validate: card {vr['card']} vs CPU {vr['cpu']}")
            if gate_rc != (0 if gate["auc"] >= 0.99 else 1) or gate["passed"] != (gate_rc == 0):
                fail(f"validate --min-auc 0.99: exit {gate_rc}, report {gate}")
            if "rtfd_validation_auc " not in open(prom).read():
                fail("validate --metrics-out: no rtfd_validation_auc")
            # a restored card scorer's explanations carry the importances
            answers = {}
            for device in ("cuda", "cpu"):
                s = TorchFraudScorer(device=device)
                CheckpointManager(card_ck).restore_into_scorer(s)
                g = TransactionGenerator(num_users=500, num_merchants=100, seed=SEED + 23)
                s.seed_profiles(g.users.profiles(), g.merchants.profiles())
                answers[device] = s.score_batch(g.generate_batch(4))
            imps = [r["explanation"].get("top_feature_importances")
                    for rs in answers.values() for r in rs]
            if any(i != rep["card"]["top_feature_importances"] for i in imps):
                fail(f"restored explanations: top_feature_importances {imps[0]}")
            print(f"validate ({time.perf_counter() - t1:.1f} s): card {json.dumps(vr['card'])}; "
                  f"CPU auc {vr['cpu']['auc']} (|diff| <= {VALIDATE_AUC_TOL}); "
                  f"--min-auc 0.99 exit {gate_rc}; restored explanations carry "
                  f"{len(imps[0])} top_feature_importances on the card and the CPU",
                  flush=True)

            # (c) the trained weights through every kernel, and the typed GNN
            gen = TransactionGenerator(num_users=10_000, num_merchants=5_000, seed=SEED + 17)
            launches = serve_trained(ops, card_ck, gen)
            typed_megakernel(card_ck, TransactionGenerator(
                num_users=2_000, num_merchants=500, seed=SEED + 29))

            # (d) quality-eval's result, then its artifact served
            out_q, err_q, t_wait = _finish("quality-eval", quality)
            result = json.loads(artifact.read_text())
            stages = _stderr_json(err_q, "seconds: ")
            print(f"quality-eval (card, BlendEvalConfig() defaults; waited {t_wait:.1f} s "
                  f"after the rest of the phase): branch AUC "
                  f"{json.dumps(result['branch_auc'])}; admission "
                  + json.dumps([(a['branch'], a['weight_scale'], a['accepted'])
                                for a in result["admission"]])
                  + f"; strategy {json.dumps(result['strategy_selection'])}; test "
                  f"{json.dumps(result['test'])}; seconds per stage "
                  + json.dumps({k: round(v, 3) for k, v in stages.items()}), flush=True)
            r05 = json.loads((Path(__file__).resolve().with_name("QUALITY_r05.json"))
                             .read_text())
            print(f"  beside QUALITY_r05.json (an earlier JAX artifact, context only): "
                  f"branch AUC {json.dumps(r05['branch_auc'])}, selected "
                  f"{json.dumps(r05['selected_blend'])}, test {json.dumps(r05['test'])}",
                  flush=True)
            serve_quality_artifact(ops, artifact, q_ck, TransactionGenerator(
                num_users=result["protocol"]["stream"]["users"],
                num_merchants=result["protocol"]["stream"]["merchants"], seed=SEED + 31))
        finally:
            _kill(procs)
    return {"trained_" + k: v for k, v in launches.items()}


# the feedback phase (18): the feedback plane and the quantization drill on
# the card. The CPU side of each comparison runs in a process of its own
# beside the card side, on half the machine's cores (TRAIN_CPU_THREADS).
# |card - CPU| of the feedback drill's baseline / dip / recovered AUCs (the
# served scores of two devices; the drill rounds them to 4 places)
FEEDBACK_AUC_TOL = 1e-3
# part (b): the TINY mega() stream of the promotion (8 batches, the swap
# before batch 4 with batch 3 in flight) and the DistilBERT-base full() one
# (4 batches, the swap before batch 2)
PROMOTE_TXNS = {"TINY": 8 * BATCH, "DistilBERT-base": 4 * BATCH}
PROMOTE_SWAP = {"TINY": 4, "DistilBERT-base": 2}
# part (c): run-job --feedback --mega --quant at the run-job defaults, cut
# from 20,000 transactions for the command's time limit (the drift trigger
# fires by 12,500 on the CPU, not by 10,000; the retrain is gated)
FEEDBACK_JOB_TXNS = 15_000
FEEDBACK_JOB_SEED = 42
# part (e): the DistilBERT-base leg of the quantization drill
QUANT_LEG_TXNS = 4 * BATCH

# the CPU feedback drill at its defaults, in a process of its own: the full
# summary, then the promoted trees and forest (host arrays) into argv[1]
FEEDBACK_DRILL_CPU = """
import json, sys, torch
from realtime_fraud_detection_tpu_torch.feedback.drill import (
    FeedbackDrillConfig, run_feedback_drill)
summary, plane, job, scorer = run_feedback_drill(
    FeedbackDrillConfig(device="cpu"), return_state=True)
t, f = scorer.models.trees, scorer.models.iforest
torch.save([t.feature, t.threshold, t.leaf, t.base_score,
            f.feature, f.threshold, f.path_length, f.c_psi], sys.argv[1])
print(json.dumps({"summary": summary, "events": list(plane.events)}))
"""


def _python_proc(code, *args, cpu=True):
    """``python -c code args`` from the repository root, in a process of its
    own (with ``cpu``, on ``TRAIN_CPU_THREADS`` threads)."""
    import os
    from pathlib import Path

    env = dict(os.environ)
    if cpu:
        env.update(OMP_NUM_THREADS=TRAIN_CPU_THREADS, MKL_NUM_THREADS=TRAIN_CPU_THREADS)
    return subprocess.Popen([sys.executable, "-c", code, *args],
                            cwd=Path(__file__).resolve().parent, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _host_leaves(models):
    t, f = models.trees, models.iforest
    return [x.detach().cpu() for x in (t.feature, t.threshold, t.leaf, t.base_score,
                                       f.feature, f.threshold, f.path_length, f.c_psi)]


def check_feedback_drills(card, card_s, cpu, cpu_s, card_leaves, cpu_leaves):
    """Part (a): the card's and the CPU's drill at their defaults. Both
    pass; the host-only quantities and the score-driven ones equal; the
    AUCs within ``FEEDBACK_AUC_TOL``; the promoted trees' arrays equal. A
    difference in a trigger or a verdict names the virtual second (the
    batch) where the two audit trails part."""
    from realtime_fraud_detection_tpu_torch.feedback.drill import compact_drill_summary

    if not (card["passed"] and cpu["passed"]):
        fail(f"feedback drill: card {compact_drill_summary(card)}, CPU "
             f"{compact_drill_summary(cpu)}")
    keys = ("labeled_total", "label_join", "buffer", "incumbent", "retrain_triggered",
            "trigger_reason", "gate_control_rejected", "gate_control_reason",
            "blend_unchanged_on_reject", "promoted", "promoted_blend", "policy",
            "events", "virtual_duration_s")
    diff = [k for k in keys if card[k] != cpu[k]]
    gate_keys = ("passed", "reason", "strategy", "holdout_n", "holdout_positives",
                 "trained_on", "select_auc", "trigger_reason")
    diff += [f"gate.{k}" for k in gate_keys if card["gate"][k] != cpu["gate"][k]]
    if diff:
        cpu_events = cpu["_events"]
        first = next((i for i, (a, b) in enumerate(zip(card["_events"], cpu_events))
                      if a.get("type") != b.get("type") or a.get("reason") != b.get("reason")
                      or a.get("passed") != b.get("passed")), None)
        where = (f"; the audit trails part at event {first}: card "
                 f"{card['_events'][first]} vs CPU {cpu_events[first]} (virtual second "
                 f"{card['_events'][first].get('ts')})" if first is not None else "")
        fail(f"feedback drill: card and CPU differ in {diff}{where}")
    aucs = {k: abs(card[k] - cpu[k]) for k in ("baseline_auc", "dip_auc", "recovered_auc")}
    aucs.update({f"gate.{k}": abs(card["gate"][k] - cpu["gate"][k])
                 for k in ("auc_as_served", "auc_candidate")})
    if not all(v <= FEEDBACK_AUC_TOL for v in aucs.values()):
        fail(f"feedback drill: AUC gaps card vs CPU {aucs} beyond {FEEDBACK_AUC_TOL}")
    if not all(torch.equal(a, b) for a, b in zip(card_leaves, cpu_leaves)):
        fail("feedback drill: the promoted trees / isolation forest differ card vs CPU")
    print(f"feedback drill (defaults): card {card_s:.1f} s, CPU ({TRAIN_CPU_THREADS} "
          f"threads, beside it) {cpu_s:.1f} s; both passed: baseline / dip / recovered "
          f"AUC card {card['baseline_auc']} / {card['dip_auc']} / {card['recovered_auc']}, "
          f"CPU {cpu['baseline_auc']} / {cpu['dip_auc']} / {cpu['recovered_auc']} "
          f"(|diff| <= {FEEDBACK_AUC_TOL}); triggers {card['policy']['triggers']} "
          f"(first {card['trigger_reason']}), gate fail / pass "
          f"{card['policy']['gate_fail']} / {card['policy']['gate_pass']}, promotions "
          f"{card['policy']['promotions']}, promoted blend "
          f"{json.dumps(card['promoted_blend'])}; labels matched "
          f"{card['label_join']['matched']} on both; join, buffer, events and the "
          f"promoted trees' arrays equal", flush=True)


def _promote_stream(records, profiles, bert_config, config, models, candidate=None,
                    swap_at=None, ops=None, spy=None, tokens=None, promote_ms=None):
    """``records`` through a depth-2 ``StreamJob`` on a fresh card scorer at
    the fixed virtual clock. ``candidate`` is promoted with
    ``promote_candidate`` before the first batch (``swap_at`` None) or right
    before batch ``swap_at`` is dispatched, while batch ``swap_at - 1`` is
    still in flight. ``spy``, a list, gets each batch's dispatch record
    (``dispatch_spy`` over ``ops``), ``promote_ms`` the host ms of the
    mid-stream promotion. Returns (predictions, scorer, config)."""
    from realtime_fraud_detection_tpu_torch.feedback.plane import promote_candidate
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
    from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker

    scorer = TorchFraudScorer(config, models=models, bert_config=bert_config,
                              device="cuda")
    scorer.seed_profiles(*profiles)
    if tokens is not None:
        token_spy(scorer, tokens)
    if candidate is not None and swap_at is None:
        promote_candidate(scorer, config, candidate)
    broker = InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(max_batch=BATCH, pipeline_depth=2))
    dispatched = [0]
    dispatch = job.dispatch_batch

    def dispatch_batch(batch, now=None):
        if candidate is not None and dispatched[0] == swap_at:
            t0 = time.perf_counter()
            promote_candidate(scorer, config, candidate)
            if promote_ms is not None:
                promote_ms.append((time.perf_counter() - t0) * 1e3)
        dispatched[0] += 1
        return dispatch(batch, now=now)

    job.dispatch_batch = dispatch_batch
    if spy is not None:
        dispatch_spy(scorer, ops, spy)
    broker.produce_batch(T.TRANSACTIONS, records, key_fn=lambda r: str(r["user_id"]))
    job.run_until_drained(now=STREAM_NOW)
    return check_stream_output("promotion", job, broker, records), scorer, config


def run_promotion(ops, name, bert_config, kernels, chain, cand, profiles, gen):
    """Part (b) at one width: the drill's promoted candidate (trees, forest,
    weights) pushed by ``promote_candidate`` into a live kernel scorer
    mid-stream, with two batches in flight, at the candidate's strategy
    and once more at the other one. Every batch launched before the swap
    equals a kernels-off card scorer holding the incumbent set, every batch
    after it one holding the promoted set (the drill's bound, decisions off
    a rung); each batch launches ``chain`` (or the megakernel once); a
    gate-rejected candidate leaves the scorer's fingerprint bit-identical.
    Returns the launch counts of the live streams."""
    from realtime_fraud_detection_tpu_torch.feedback.drill import (
        _blend_fingerprint,
        _fingerprints_equal,
    )
    from realtime_fraud_detection_tpu_torch.feedback.plane import FeedbackPlane
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        FeedbackSettings,
        QuantSettings,
    )

    mega = kernels.megakernel == "cuda"
    records = gen.generate_batch(PROMOTE_TXNS[name])
    swap = PROMOTE_SWAP[name]
    models = seeded_models(bert_config)
    quant = QuantSettings.full()
    tokens = []
    t0 = time.perf_counter()
    ref_inc, ref_scorer, _ = _promote_stream(records, profiles, bert_config,
                                             Config(quant=quant), models, tokens=tokens)
    inc_bound = noise_bound(ref_scorer.models, bert_config, tokens,
                            ref_scorer.ensemble_params.weights)
    strategies = [cand["strategy"]] + [s for s in ("stacking", "weighted_average")
                                       if s != cand["strategy"]][:1]
    launches = {k: 0 for k in ops.launch_counts()}
    lines = []
    for strategy in strategies:
        c = dict(cand, strategy=strategy)
        ref_pro, pro_scorer, _ = _promote_stream(records, profiles, bert_config,
                                                 Config(quant=quant), models, candidate=c)
        pro_bound = noise_bound(pro_scorer.models, bert_config, tokens,
                                pro_scorer.ensemble_params.weights,
                                valid=pro_scorer.model_valid)
        spy, promote_ms = [], []
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        live, scorer, config = _promote_stream(
            records, profiles, bert_config, Config(quant=quant, kernels=kernels),
            models, candidate=c, swap_at=swap, ops=ops, spy=spy, promote_ms=promote_ms)
        torch.cuda.synchronize()
        for k, v in ops.launch_counts().items():
            launches[k] += v
        pre_ids = {r["transaction_id"] for b in spy[:swap] for r in b["records"]}
        if len({b["models"] for b in spy[:swap]}) != 1 or \
                len({b["models"] for b in spy[swap:]}) != 1 or \
                spy[0]["models"] == spy[swap]["models"]:
            fail(f"{name} promotion: the batches' model sets "
                 f"{[b['models'] for b in spy]} do not change once, before batch {swap}")
        want = {"megakernel": 1} if mega else chain
        for i, b in enumerate(spy):
            if b["launches"] != want or b["kernel_launches"] != sum(want.values()) \
                    or b["mega_fallback"]:
                fail(f"{name} promotion ({strategy}): batch {i} launched "
                     f"{b['launches']} (snapshot {b['kernel_launches']}, fallback "
                     f"{b['mega_fallback']})")
        if config.ensemble.strategy != strategy or \
                scorer.ensemble_params.strategy != ("weighted_average", "voting",
                                                    "stacking").index(strategy):
            fail(f"{name} promotion: the scorer serves {config.ensemble.strategy}")
        if mega and scorer.kernel_static(BATCH)["mega_valid"] != tuple(
                bool(v) for v in scorer.model_valid):
            fail(f"{name} promotion: mega_valid does not follow the promoted validity")
        def split(preds, pre):
            return [p for p in preds if (p["transaction_id"] in pre_ids) == pre]

        err_pre = compare_streams(f"{name} promotion ({strategy}), before the swap",
                                  split(live, True), split(ref_inc, True), inc_bound,
                                  "the incumbent's kernels-off scorer")
        err_post = compare_streams(f"{name} promotion ({strategy}), after the swap",
                                   split(live, False), split(ref_pro, False), pro_bound,
                                   "the promoted set's kernels-off scorer")
        moved = max(abs(a["fraud_score"] - b["fraud_score"])
                    for a, b in zip(split(live, False), split(ref_inc, False)))
        if not moved > pro_bound:
            fail(f"{name} promotion: the promoted batches score as the incumbent "
                 f"(max move {moved})")
        # a gate-rejected candidate changes nothing on the live card scorer
        before = _blend_fingerprint(scorer, config)
        plane = FeedbackPlane(FeedbackSettings(enabled=True), scorer=scorer,
                              config=config)
        y = (torch.arange(64) % 4 == 0).double().numpy()
        verdict = plane.submit_candidate(dict(c, holdout={
            "y": y, "as_served": y, "candidate": 1.0 - y, "n": 64}), now=0.0)
        if verdict["passed"] or not _fingerprints_equal(
                before, _blend_fingerprint(scorer, config)):
            fail(f"{name} promotion: a rejected candidate changed the blend ({verdict})")
        lines.append(f"{strategy}: promotion {promote_ms[0]:.2f} ms on the host, "
                     f"before the swap max err {err_pre:.3e} (bound "
                     f"{inc_bound:.3e}), after {err_post:.3e} (bound {pro_bound:.3e}), "
                     f"scores moved up to {moved:.3f} by the swap")
    print(f"{name} promotion under {'mega()' if mega else 'full()'} ({len(records)} "
          f"txns, swap before batch {swap} with batch {swap - 1} in flight, "
          f"{time.perf_counter() - t0:.1f} s): every batch launched "
          f"{'the megakernel once' if mega else json.dumps(chain)}; "
          + "; ".join(lines) + "; a gate-rejected candidate left the card "
          "scorer's fingerprint bit-identical", flush=True)
    return launches


def _preds_file(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def plane_breakdown(argv):
    """``run-job`` through the command's entry point in this process, with
    the feedback plane's four host entries timed (class-level wrappers):
    returns the summary and the seconds in each."""
    import contextlib
    import io

    from realtime_fraud_detection_tpu_torch.__main__ import main
    from realtime_fraud_detection_tpu_torch.feedback.plane import FeedbackPlane

    spent = {name: 0.0 for name in ("on_predictions", "on_labels", "check_trigger",
                                    "react")}
    saved = {name: getattr(FeedbackPlane, name) for name in spent}

    def timed(name, fn):
        def wrapper(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0
        return wrapper

    for name in spent:
        setattr(FeedbackPlane, name, timed(name, saved[name]))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = main(argv)
    finally:
        for name, fn in saved.items():
            setattr(FeedbackPlane, name, fn)
    if rc != 0:
        fail(f"run-job in process: exit {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1]), spent


def run_feedback_job(ops, tmp):
    """Part (c): ``run-job --feedback --mega --quant`` as a command on the
    card, the same without ``--feedback``, the first once more through the
    command's entry point in this process with the plane's host entries
    timed, and the first with ``--device cpu`` (started last, finished by
    ``finish``). Returns ``finish`` and the CPU process."""
    from pathlib import Path

    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.utils.config import Config, QuantSettings

    base = ["run-job", "--count", str(FEEDBACK_JOB_TXNS), "--mega", "--quant"]
    out = {k: str(Path(tmp) / f"{k}.jsonl") for k in ("card", "plain", "cpu")}
    runs = {}
    for key, args in (("card", base + ["--feedback"]), ("plain", base)):
        t0 = time.perf_counter()
        stdout, _, _ = _finish(f"run-job ({key})", _port_proc(
            args + ["--predictions-out", out[key]]))
        runs[key] = (json.loads(stdout.strip().splitlines()[-1]),
                     time.perf_counter() - t0)
    inproc, spent = plane_breakdown(base + ["--feedback"])
    cpu = _port_proc(base + ["--feedback", "--device", "cpu",
                             "--predictions-out", out["cpu"]], cpu=True)

    # the drill's bound for the run-job scorer (seed 42, int8 TINY, the
    # default blend) on the stream's first four batches
    gen = TransactionGenerator(num_users=STREAM_USERS, num_merchants=STREAM_MERCHANTS,
                               seed=FEEDBACK_JOB_SEED, tps=1000.0)
    scorer = TorchFraudScorer(Config(quant=QuantSettings.full()), seed=FEEDBACK_JOB_SEED,
                              device="cuda")
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    recs = gen.generate_batch(4 * BATCH)
    tokens = []
    for i in range(0, len(recs), BATCH):
        b = scorer.assemble(recs[i:i + BATCH])
        tokens.append((b.token_ids, b.token_mask))
    tol = noise_bound(scorer.models, TINY_CONFIG, tokens, scorer.ensemble_params.weights)

    def finish():
        t0 = time.perf_counter()
        stdout, _, waited = _finish("run-job (cpu)", cpu)
        ref = json.loads(stdout.strip().splitlines()[-1])
        card, card_s = runs["card"]
        plain, plain_s = runs["plain"]
        fb, ref_fb = card["feedback"], ref["feedback"]
        policy_keys = ("triggers", "gate_pass", "gate_fail", "promotions")
        if (fb["labels_matched"], fb["buffer"]) != (ref_fb["labels_matched"],
                                                    ref_fb["buffer"]) or \
                any(fb["policy"][k] != ref_fb["policy"][k] for k in policy_keys) or \
                not fb["policy"]["promotions"] or \
                card["scored"] != ref["scored"] or card["counters"]["errors"]:
            fail(f"run-job --feedback: card {fb} vs CPU {ref_fb}")
        disp = card["kernels"]["dispatch"]
        if card["kernels"]["fallback"]["megakernel"] or not disp["megakernel"]:
            fail(f"run-job --feedback: kernel snapshot {card['kernels']}")
        err = compare_streams("run-job --feedback", _preds_file(out["card"]),
                              _preds_file(out["cpu"]), tol, "the CPU command")
        us = (1.0 / card["txn_per_s"] - 1.0 / plain["txn_per_s"]) * 1e6
        n = inproc["scored"]
        steady = sum(v for k, v in spent.items() if k != "react")
        if inproc["feedback"]["policy"] != {**fb["policy"], "last_trigger_ts": inproc[
                "feedback"]["policy"]["last_trigger_ts"]}:
            fail(f"run-job in process: policy {inproc['feedback']['policy']} vs the "
                 f"command's {fb['policy']}")
        print(f"run-job --feedback in this process ({inproc['txn_per_s']} txn/s): the "
              f"plane's host seconds " + json.dumps({k: round(v, 3) for k, v in
                                                     spent.items()})
              + f": {steady / n * 1e6:.2f} us a transaction without the retrain "
              f"(react: retrain, gate and promotion, {spent['react']:.2f} s)",
              flush=True)
        print(f"run-job --feedback --mega --quant ({FEEDBACK_JOB_TXNS} txns): card "
              f"{card['txn_per_s']} txn/s ({card_s:.1f} s command), without the plane "
              f"{plain['txn_per_s']} txn/s ({plain_s:.1f} s): the plane's host cost "
              f"{us:.2f} us a transaction; megakernel dispatches {disp['megakernel']}, "
              f"fallbacks 0; labels matched {fb['labels_matched']}, buffer {fb['buffer']}, "
              f"policy {json.dumps({k: fb['policy'][k] for k in policy_keys})} on the card "
              f"and the CPU (CPU {ref['txn_per_s']} txn/s, waited {waited:.1f} s); "
              f"retrain fired: {fb['policy']['triggers'] > 0}; sliding prequential "
              f"AUC card {fb['prequential_sliding']['auc']}, CPU "
              f"{ref_fb['prequential_sliding']['auc']}; fraud_score max err {err:.3e}",
              flush=True)
    return finish, cpu


def run_feedback_serving(ops, chain, profiles, gen):
    """Part (d): an in-process ``ServingApp`` at DistilBERT-base under
    ``full()`` with the feedback plane on: 256 ``/predict`` from 64 clients
    (each batch the chain), their label events on ``POST /labels``, ``GET
    /quality/live``, the ``prequential_*`` / ``feedback_*`` families on
    ``/metrics/prometheus``; ``/labels`` answers 409 with the plane off and
    400 on a malformed body. Returns the load's launch counts."""
    import http.client

    from realtime_fraud_detection_tpu_torch.models.bert import DISTILBERT_BASE
    from realtime_fraud_detection_tpu_torch.utils.config import KernelSettings

    load = gen.generate_batch(BATCH)
    app = serving_app(seeded_models(DISTILBERT_BASE), DISTILBERT_BASE,
                      KernelSettings.full(), "cuda", profiles, feedback=True)
    batches = []
    dispatch_spy(app.scorer, ops, batches)
    t0 = time.perf_counter()
    with AppThread(app) as srv:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        result = run_load_process(app.port, load)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        check_batches("feedback serving", batches, False, chain)
        events = gen.label_events(load, delay_scale=1e-4)
        status, out = srv.request("POST", "/labels", events)
        if status != 200 or out["matched"] != BATCH or out["ingested"] != BATCH:
            fail(f"feedback serving: POST /labels {status} {out}")
        status, quality = srv.request("GET", "/quality/live")
        pre = quality.get("prequential", {})
        if status != 200 or pre.get("labeled_total") != BATCH or \
                quality["buffer"]["size"] != BATCH or quality["enabled"] is not True:
            fail(f"feedback serving: GET /quality/live {status} {str(quality)[:500]}")
        status, prom = srv.request("GET", "/metrics/prometheus")
        families = sorted({ln.split()[2] for ln in prom.splitlines()
                           if ln.startswith("# TYPE ")
                           and ln.split()[2].startswith(("prequential_", "feedback_"))})
        if status != 200 or len(families) != 10 or prom_value(
                prom, 'feedback_labels_total{outcome="matched"}') != BATCH:
            fail(f"feedback serving: /metrics/prometheus families {families}")
        app.config.feedback.enabled = False
        status_off, _ = srv.request("POST", "/labels", events[:1])
        app.config.feedback.enabled = True
        conn = http.client.HTTPConnection("127.0.0.1", app.port, timeout=60)
        conn.request("POST", "/labels", body="{not json",
                     headers={"Content-Type": "application/json"})
        status_bad = conn.getresponse().status
        conn.close()
        if (status_off, status_bad) != (409, 400):
            fail(f"feedback serving: /labels answered {status_off} with the plane off "
                 f"and {status_bad} on a malformed body")
    summary = load_summary(result, batches)
    print(f"feedback serving (DistilBERT-base full(), {time.perf_counter() - t0:.1f} s): "
          f"{BATCH} /predict from {SERVE_CLIENTS} clients at {summary['txn_per_s']:.1f} "
          f"txn/s, p50 / p99 {summary['p50_ms']:.1f} / {summary['p99_ms']:.1f} ms, "
          f"{summary['batches']} batches each {json.dumps(chain)}; POST /labels matched "
          f"{out['matched']}; /quality/live sliding "
          f"{json.dumps(pre['sliding'])}; families {families}; /labels 409 off, 400 "
          f"malformed", flush=True)
    return launches


def check_quant_drill(card, card_s, cpu, cpu_s):
    """Part (e): the quantization drill at its defaults on the card (its own
    replay is the second card run) beside the CPU port run."""
    c = card["checks"]
    div = card["divergence"]
    if not (card["passed"] and c["divergence_below_noise"] and div["decision_flips"] == 0
            and card["quality"]["auc_delta"] <= 2e-3 and c["gemm_leaves_identical"]
            and card["param_bytes"]["ratio"] >= 3.5 and c["replay_bit_identical"]):
        fail(f"quant drill (card): {json.dumps(card['checks'])}")
    if not cpu["passed"]:
        fail(f"quant drill (CPU): {json.dumps(cpu['checks'])}")

    def line(s):
        return (f"divergence {s['divergence']['max']:.3e} (bound "
                f"{s['divergence']['noise_floor']['bound']:.3e}), flips "
                f"{s['divergence']['decision_flips']}, AUC f32 / int8 "
                f"{s['quality']['auc_f32']} / {s['quality']['auc_quant']} (delta "
                f"{s['quality']['auc_delta']}), max GEMM logit delta "
                f"{s['tree_oracle']['max_logit_delta']:.3e}, bytes ratio "
                f"{s['param_bytes']['ratio']}, digest {s['digest'][:16]}"
                + (f" (replay bit-identical: {s['replay']['bit_identical']})"
                   if "replay" in s else ""))
    print(f"quant drill (defaults): card {card_s:.1f} s: {line(card)}; CPU port run "
          f"({cpu_s:.1f} s): {line(cpu)}", flush=True)


def run_quant_leg(ops, profiles, gen):
    """Part (e)'s DistilBERT-base leg: ``QUANT_LEG_TXNS`` seeded stream
    transactions through an f32-BERT card scorer (``QuantSettings()``,
    kernels off: the yardstick) and an int8-BERT one (``QuantSettings.full()``
    with ``KernelSettings.full()``, 1 / 6 / 36 / 2 launches a batch). Prints
    the divergence against the noise bound of that width and the decision
    flips. Returns the int8 side's launch counts."""
    from realtime_fraud_detection_tpu_torch.models.bert import DISTILBERT_BASE
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    records = gen.generate_batch(QUANT_LEG_TXNS)
    n_batches = QUANT_LEG_TXNS // BATCH
    t0 = time.perf_counter()
    tokens = []
    f32_job, f32_broker, f32_scorer, _ = drive_stream(
        records, profiles, DISTILBERT_BASE, Config(quant=QuantSettings()), "cuda",
        tokens=tokens)
    f32 = check_stream_output("quant leg f32", f32_job, f32_broker, records)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    q_job, q_broker, _, _ = drive_stream(
        records, profiles, DISTILBERT_BASE,
        Config(quant=QuantSettings.full(), kernels=KernelSettings.full()), "cuda")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {"epilogue": 1, "flash_attention": DISTILBERT_BASE.num_layers,
            "dequant_matmul": 6 * DISTILBERT_BASE.num_layers, "dequant_rows": 2,
            "megakernel": 0}
    if launches != {k: v * n_batches for k, v in want.items()}:
        fail(f"quant leg: launches {launches}")
    q = check_stream_output("quant leg int8", q_job, q_broker, records)
    bound = noise_bound(f32_scorer.models, DISTILBERT_BASE, tokens,
                        f32_scorer.ensemble_params.weights)
    div = [abs(a["fraud_score"] - b["fraud_score"]) for a, b in zip(q, f32)]
    flips = sum(a["decision"] != b["decision"] for a, b in zip(q, f32))
    div.sort()
    print(f"quant drill, DistilBERT-base leg ({QUANT_LEG_TXNS} txns, "
          f"{time.perf_counter() - t0:.1f} s): int8 BERT under full() against f32 BERT "
          f"kernels off: max divergence {div[-1]:.3e}, p99 "
          f"{div[int(0.99 * (len(div) - 1))]:.3e} against the bf16 noise bound "
          f"{bound:.3e} of this width ({'under' if div[-1] <= bound else 'over'} it), "
          f"decision flips {flips}; int8 launches {json.dumps(launches)}", flush=True)
    return launches


def run_feedback(ops):
    """Phase 18: the feedback plane and the quantization drill on the card
    (see the module docstring). Returns the launches of its in-process
    streams by path."""
    import tempfile
    from pathlib import Path

    from realtime_fraud_detection_tpu_torch.feedback import policy
    from realtime_fraud_detection_tpu_torch.feedback.drill import (
        FeedbackDrillConfig,
        run_feedback_drill,
    )
    from realtime_fraud_detection_tpu_torch.models.bert import DISTILBERT_BASE, TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.utils.config import KernelSettings

    chain = {"epilogue": 1, "flash_attention": DISTILBERT_BASE.num_layers,
             "dequant_matmul": 6 * DISTILBERT_BASE.num_layers, "dequant_rows": 2}
    gen = TransactionGenerator(num_users=STREAM_USERS, num_merchants=STREAM_MERCHANTS,
                               seed=SEED + 41)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    procs, seconds, out = [], {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            # (a) the feedback drill at its defaults, the CPU beside the card
            t0 = time.perf_counter()
            saved = str(Path(tmp) / "cpu_drill.pt")
            cpu_drill = _python_proc(FEEDBACK_DRILL_CPU, saved)
            procs.append(cpu_drill)
            retrain, retrain_s = policy.Retrainer.retrain, []

            def timed_retrain(self, *args, **kwargs):
                t = time.perf_counter()
                try:
                    return retrain(self, *args, **kwargs)
                finally:
                    retrain_s.append(round(time.perf_counter() - t, 3))

            policy.Retrainer.retrain = timed_retrain
            try:
                card, plane, _, scorer = run_feedback_drill(
                    FeedbackDrillConfig(device="cuda"), return_state=True)
            finally:
                policy.Retrainer.retrain = retrain
            card_s = time.perf_counter() - t0
            print(f"feedback drill (card): the retrains took {retrain_s} s on the host "
                  f"(the permuted-label control, then the genuine candidate)", flush=True)
            card["_events"] = list(plane.events)
            weights = {n: mc.weight for n, mc in plane.config.models.items() if mc.enabled}
            cand = {"trees": scorer.models.trees.to("cpu"),
                    "iforest": scorer.models.iforest.to("cpu"),
                    "weights": weights, "strategy": plane.config.ensemble.strategy}
            card_leaves = _host_leaves(scorer.models)
            seconds["a_card"] = round(card_s, 1)

            # (b) the promoted candidate into live kernel scorers
            t1 = time.perf_counter()
            out["promote_tiny"] = run_promotion(
                ops, "TINY", TINY_CONFIG, KernelSettings.mega(), chain, cand, profiles, gen)
            out["promote_distilbert_base"] = run_promotion(
                ops, "DistilBERT-base", DISTILBERT_BASE, KernelSettings.full(), chain,
                cand, profiles, gen)
            seconds["b"] = round(time.perf_counter() - t1, 1)

            t_wait = time.perf_counter()
            stdout, _, _ = _finish("feedback drill (cpu)", cpu_drill)
            cpu_s = time.perf_counter() - t0
            cpu_out = json.loads(stdout.strip().splitlines()[-1])
            cpu = dict(cpu_out["summary"], _events=cpu_out["events"])
            check_feedback_drills(card, card_s, cpu, cpu_s, card_leaves, torch.load(saved))
            seconds["a_cpu_wait"] = round(time.perf_counter() - t_wait, 1)

            # (c) run-job --feedback as a command; its CPU run and the CPU
            # quant drill then run beside (d) and (e)
            t2 = time.perf_counter()
            finish_job, cpu_job = run_feedback_job(ops, tmp)
            procs.append(cpu_job)
            seconds["c_card"] = round(time.perf_counter() - t2, 1)
            t_qcpu = time.perf_counter()
            cpu_quant = _port_proc(["quant-drill", "--no-replay", "--device", "cpu"],
                                   cpu=True)
            procs.append(cpu_quant)

            # (d) the serving app with the plane on
            t3 = time.perf_counter()
            out["feedback_serving"] = run_feedback_serving(ops, chain, profiles, gen)
            seconds["d"] = round(time.perf_counter() - t3, 1)

            # (e) the quantization drill at its defaults as a command on the
            # card (its replay the second card run), then the DistilBERT leg
            t4 = time.perf_counter()
            stdout, _, _ = _finish("quant-drill (card)", _port_proc(["quant-drill"]))
            card_q = json.loads(stdout.strip().splitlines()[-2])
            card_q_s = time.perf_counter() - t4
            out["quant_leg_distilbert_base"] = run_quant_leg(ops, profiles, gen)
            stdout, _, _ = _finish("quant-drill (cpu)", cpu_quant)
            check_quant_drill(card_q, card_q_s, json.loads(stdout.strip().splitlines()[-2]),
                              time.perf_counter() - t_qcpu)
            seconds["e"] = round(time.perf_counter() - t4, 1)
            t5 = time.perf_counter()
            finish_job()
            seconds["c_cpu_wait"] = round(time.perf_counter() - t5, 1)
        finally:
            _kill(procs)
    print(f"feedback phase seconds by part: {json.dumps(seconds)}", flush=True)
    return out


# the job as deployed (phase 19): (a) phase 8's two streams with the
# analytics and enrichment planes on, card against CPU; (b) broker, simulate
# through the gateway, run-job stopped by SIGTERM and resumed, alert-router,
# each a process of its own
PLANE_DECISION_CUTS = (0.6, 0.95)        # the enrichment ladder's decision cuts
PLANE_RISK_CUTS = (0.3, 0.6, 0.8, 0.95)
HIGH_RISK_CUT = 0.7                      # stream/windows.py's high-risk count
# (a)'s streams, cut from phase 8's depth (16 and 4 batches) for the
# command's time limit: TINY to 8 batches, then to 4; DistilBERT-base to 2
PLANES_COUNT = {"TINY": 4 * BATCH, "DistilBERT-base": 2 * BATCH}
# (b)'s transactions, cut from 16 batches to 4 for the command's time limit
# (the analytics plane holds the deployed job at 36-84 txn/s on the card's
# hosts): the first run still stops after its first batch
DEPLOY_COUNT = 4 * BATCH
DEPLOY_SEED = SEED + 19
BLEND_TOL = 1e-6                         # the blend against its CPU version


def near_cut(values, cuts, tol):
    v = torch.tensor(values, dtype=torch.float64)
    return (v[:, None] - torch.tensor(cuts, dtype=torch.float64)[None, :]).abs().min(
        dim=1).values <= tol


def plane_topics():
    from realtime_fraud_detection_tpu_torch.stream.windows import ANALYTICS_TOPIC

    return sorted(set(ANALYTICS_TOPIC.values()))


def analytics_keys():
    """Each analytics topic's key field and key function (two operators
    share velocity-checks, both keyed by user)."""
    from realtime_fraud_detection_tpu_torch.stream import windows as W

    def user(t):
        return str(t.get("user_id"))

    return {"velocity-checks": ("user_id", user),
            "merchant-transactions": ("merchant_id", lambda t: str(t.get("merchant_id"))),
            "user-sessions": ("user_id", user),
            "geographic-analysis": ("geo_key", W.geo_grid_key),
            "pattern-detection": ("pattern_key", W.fraud_pattern_key),
            "transaction-metrics": ("amount_bucket", W.amount_cluster_key)}


def compare_planes(name, card, ref, tol, label):
    """The enriched topic and the analytics topics of a card run against a
    reference run on the same records: ids in order, the blended
    ``fraud_score`` and the ``ensemble_score`` within ``tol``, enrichment
    decisions equal but where the reference's blend lies within ``tol`` of
    0.6 or 0.95 (risk levels: of any cut), the other fields exact; every
    analytics record equal but for the high-risk count of a window holding a
    row within ``tol`` of 0.7. Returns the rows and windows skipped."""
    from realtime_fraud_detection_tpu_torch.state.stores import _event_time_ms
    from realtime_fraud_detection_tpu_torch.stream import topics as T

    enr, ref_enr = card[T.ENRICHED], ref[T.ENRICHED]
    if [e["transaction_id"] for e in enr] != [e["transaction_id"] for e in ref_enr]:
        fail(f"{name} planes: enriched ids differ from {label}")
    blend = [e["fraud_score"] for e in ref_enr]
    err = max(abs(e["fraud_score"] - b) for e, b in zip(enr, blend))
    ens_err = max(abs(e["ensemble_score"] - f["ensemble_score"])
                  for e, f in zip(enr, ref_enr))
    if not (err <= tol and ens_err <= tol):
        fail(f"{name} planes: blended score err {err}, ensemble err {ens_err} vs {label}")
    scored = ("fraud_score", "ensemble_score", "decision", "risk_level")
    near_dec = near_cut(blend, PLANE_DECISION_CUTS, tol).tolist()
    near_risk = near_cut(blend, PLANE_RISK_CUTS, tol).tolist()
    for e, f, nd, nr in zip(enr, ref_enr, near_dec, near_risk):
        if (not nd and e["decision"] != f["decision"]) or (
                not nr and e["risk_level"] != f["risk_level"]) or {
                k: v for k, v in e.items() if k not in scored} != {
                k: v for k, v in f.items() if k not in scored}:
            fail(f"{name} planes: enriched {e['transaction_id']} {e['decision']}/"
                 f"{e['risk_level']} vs {label} {f['decision']}/{f['risk_level']}")
    near_hr = [(e, _event_time_ms(e, None) / 1000.0) for e, b in zip(enr, blend)
               if abs(b - HIGH_RISK_CUT) <= tol]
    windows = differing = 0
    keys = analytics_keys()
    for topic in plane_topics():
        recs, ref_recs = card[topic], ref[topic]
        if len(recs) != len(ref_recs) or not recs:
            fail(f"{name} planes: {topic} holds {len(recs)} records, {label} "
                 f"{len(ref_recs)}")
        field, key_fn = keys[topic]
        windows += len(recs)
        for r, q in zip(recs, ref_recs):
            if r == q:
                continue
            if {k: v for k, v in r.items() if k != "high_risk_count"} != {
                    k: v for k, v in q.items() if k != "high_risk_count"} or not any(
                    key_fn(e) == r[field] and r["window_start"] <= ts < r["window_end"]
                    for e, ts in near_hr):
                fail(f"{name} planes: {topic} record differs from {label}: {r} vs {q}")
            differing += 1
    skipped = {"near_0.6_0.95": sum(near_dec), "near_any_cut": sum(near_risk),
               "near_0.7": len(near_hr), "windows_differing": differing,
               "windows": windows}
    print(f"  {name} planes vs {label}: blended fraud_score max err {err:.3e}, "
          f"ensemble_score {ens_err:.3e} (bound {tol:.3e}); enrichment decisions equal "
          f"on {len(enr) - skipped['near_0.6_0.95']}/{len(enr)} rows "
          f"({skipped['near_0.6_0.95']} within the bound of 0.6 / 0.95 skipped, risk "
          f"levels {skipped['near_any_cut']} near a cut); analytics {windows} windows on "
          f"{len(plane_topics())} topics, {differing} differing, each holding one of "
          f"{len(near_hr)} rows within the bound of 0.7", flush=True)
    return skipped


def run_planes(ops, name, bert_config, kernels, count, expected):
    """Phase 19(a) for one width: phase 8's stream through the card with
    the planes off, then on (launch counters reset just before, read just
    after; the analytics plane's calls and the job's blend timed), then on
    through the CPU; the card against the CPU."""
    from realtime_fraud_detection_tpu_torch.features.rules import blend_enrichment
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.utils.config import Config, QuantSettings

    gen = TransactionGenerator(num_users=STREAM_USERS, num_merchants=STREAM_MERCHANTS,
                               seed=SEED)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    records = gen.generate_batch(count)
    config = Config(quant=QuantSettings.full(), kernels=kernels)
    n_batches = count // BATCH
    _, _, off_scorer, off_timer = drive_stream(records, profiles, bert_config, config,
                                               "cuda", timed=True)
    off = off_timer.summary(off_scorer)
    spent = {"analytics_s": 0.0, "enrich_ms": [], "last": None}

    def hook(job):
        process, enrich = job.analytics.process, job._enrich

        def timed_process(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return process(*args, **kwargs)
            finally:
                spent["analytics_s"] += time.perf_counter() - t0

        def timed_enrich(results, feats):
            t0 = time.perf_counter()
            try:
                return enrich(results, feats)
            finally:
                spent["enrich_ms"].append((time.perf_counter() - t0) * 1e3)
                spent["last"] = ([r["fraud_score"] for r in results], feats[:len(results)])

        job.analytics.process, job._enrich = timed_process, timed_enrich

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    job, broker, scorer, timer = drive_stream(records, profiles, bert_config, config,
                                              "cuda", timed=True, planes=True, hook=hook)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {k: v * n_batches for k, v in expected.items()}
    per_batch = [b["launches"] for b in timer.batches]
    if launches != want or per_batch != [sum(expected.values())] * n_batches:
        fail(f"{name} planes: launch counts {launches} / {per_batch} (want {want})")
    check_stream_output(f"{name} planes", job, broker, records)
    card = {t: topic_values(broker, t) for t in (T.PREDICTIONS, T.ENRICHED,
                                                 *plane_topics())}
    fired = {k: v["fired"] for k, v in job.analytics.stats().items()}
    if sum(fired.values()) != sum(len(card[t]) for t in plane_topics()):
        fail(f"{name} planes: fired {fired} vs the analytics topics")
    on = timer.summary(scorer)

    prior, feats = spent["last"]
    prior_d = torch.tensor(prior, dtype=torch.float32, device="cuda")
    feats_d = torch.as_tensor(feats).cuda()
    blend_ms = [spun_ms(lambda: blend_enrichment(prior_d, feats_d))[0] for _ in range(5)]

    tokens = []
    ref_job, ref_broker, _, _ = drive_stream(records, profiles, bert_config, config,
                                             "cpu", tokens=tokens, planes=True)
    check_stream_output(f"{name} planes (CPU)", ref_job, ref_broker, records)
    ref = {t: topic_values(ref_broker, t) for t in (T.PREDICTIONS, T.ENRICHED,
                                                    *plane_topics())}
    tol = noise_bound(scorer.models, bert_config, tokens, scorer.ensemble_params.weights)
    err = compare_streams(f"{name} planes", card[T.PREDICTIONS], ref[T.PREDICTIONS],
                          tol, "a CPU scorer")
    skipped = compare_planes(name, card, ref, tol, "a CPU scorer")
    us = spent["analytics_s"] / count * 1e6
    summary = {"txns": count, "launches": launches,
               "txn_per_s": {"planes_on": on["txn_per_s"],
                             "planes_off": off["txn_per_s"]},
               "batch_ms_p50_p99": {"planes_on": [on["batch_ms_p50"], on["batch_ms_p99"]],
                                    "planes_off": [off["batch_ms_p50"],
                                                   off["batch_ms_p99"]]},
               "fan_out_ms_per_batch": {
                   "planes_on": on["smoke_ms_per_batch"]["_fan_out"],
                   "planes_off": off["smoke_ms_per_batch"]["_fan_out"]},
               "gc_ms": {"planes_on": on["gc_ms"], "planes_off": off["gc_ms"]},
               "gc_collections": {"planes_on": on["gc_collections"],
                                  "planes_off": off["gc_collections"]},
               "analytics_host_us_per_txn": us,
               # after the warm-up batch, whose copies initialise the f64 path
               "enrich_host_ms_p50_per_batch": sorted(
                   spent["enrich_ms"][STREAM_WARMUP_BATCHES:])[
                       (len(spent["enrich_ms"]) - STREAM_WARMUP_BATCHES) // 2],
               "blend_device_ms_per_batch": sorted(blend_ms)[len(blend_ms) // 2],
               "fired": fired, "skipped": skipped, "max_err": err, "bound": tol}
    print(f"{name} planes (batch {BATCH}, depth 2, {STREAM_USERS} users): "
          + json.dumps(summary), flush=True)
    return summary


def _broker_client(port):
    from realtime_fraud_detection_tpu_torch.stream.netbroker import NetBrokerClient

    for _ in range(600):
        try:
            return NetBrokerClient(port=port, reconnect_attempts=0, timeout_s=30.0)
        except OSError:
            time.sleep(0.05)
    fail(f"the broker on port {port} did not come up")


def _job_until(args, stop_when, procs):
    """``run-job`` with ``args`` in a process of its own, SIGTERM once
    ``stop_when()`` holds (polled every 10 ms); returns its summary, its
    standard error and its seconds."""
    import signal

    t0 = time.perf_counter()
    proc = _port_proc(args)
    procs.append(proc)
    while not stop_when():
        if proc.poll() is not None:
            fail(f"run-job exited early ({proc.returncode}): "
                 f"{proc.stderr.read()[-3000:]}")
        if time.perf_counter() - t0 > 600:
            fail("run-job: the stop condition did not hold within 600 s")
        time.sleep(0.01)
    proc.send_signal(signal.SIGTERM)
    out, err, _ = _finish("run-job --broker", proc, timeout=300)
    return json.loads(out.strip().splitlines()[-1]), err, time.perf_counter() - t0


def run_deployed(tmp, port, sim_args):
    """Phase 19(b) after the broker is up and ``simulate --broker`` has
    produced (the smoke started both before part (a)): ``run-job`` on the
    card stopped by SIGTERM after its first batch, the same command again
    until lag 0, ``alert-router --once``; the gates of the module
    docstring."""
    import re
    import sqlite3
    from collections import Counter
    from pathlib import Path

    from realtime_fraud_detection_tpu_torch.features.rules import blend_enrichment
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.windows import ANALYTICS_TOPIC

    addr = f"127.0.0.1:{port}"
    client = _broker_client(port)
    procs = []
    try:
        ck, db = str(Path(tmp) / "ck"), str(Path(tmp) / "meta.db")
        args = ["run-job", "--broker", addr, "--count", "0", "--duration", "900",
                "--quant", "--mega", "--analytics", "--enrichment", "--checkpoint-dir",
                ck, "--metadata-db", db, *sim_args]
        group = "fraud-detection-job"
        first, err1, s1 = _job_until(
            args, lambda: sum(client.end_offsets(T.PREDICTIONS)) >= BATCH, procs)
        second, err2, s2 = _job_until(
            args, lambda: client.lag(group, T.TRANSACTIONS) == 0, procs)
        t0 = time.perf_counter()
        _, router_err, _ = _finish("alert-router", _port_proc(
            ["alert-router", "--broker", addr, "--once"]))
        router_s = time.perf_counter() - t0

        final = re.search(r"final checkpoint step (\d+)", err1)
        resumed = re.search(r"resumed from checkpoint step (\d+)", err2)
        if (first.get("stopped_by"), second.get("stopped_by")) != ("SIGTERM", "SIGTERM") \
                or final is None or resumed is None \
                or final.group(1) != resumed.group(1):
            fail(f"deployed job: stop / resume: {first.get('stopped_by')}, "
                 f"{second.get('stopped_by')}; {err1[-1500:]} / {err2[-1500:]}")
        if not 0 < first["scored"] < DEPLOY_COUNT \
                or first["scored"] + second["scored"] != DEPLOY_COUNT \
                or second["counters"]["duplicates_skipped"] \
                or first["counters"]["errors"] or second["counters"]["errors"] \
                or second["lag"]:
            fail(f"deployed job: scored {first['scored']} + {second['scored']}, "
                 f"counters {first['counters']} / {second['counters']}")

        def topic(name):
            return [r.value for r in client.consumer([name], "smoke-check").poll(1 << 30)]

        preds, enriched, feats = topic(T.PREDICTIONS), topic(T.ENRICHED), topic(T.FEATURES)
        ids = Counter(p["transaction_id"] for p in preds)
        if len(ids) != DEPLOY_COUNT or set(ids.values()) != {1} or Counter(
                e["transaction_id"] for e in enriched) != ids:
            fail(f"deployed job: {len(ids)} ids on the predictions topic, "
                 f"{len(enriched)} enriched; not each once")
        score = {p["transaction_id"]: p["fraud_score"] for p in preds}
        vec = {f["transaction_id"]: f["features"] for f in feats}
        if any(e["ensemble_score"] != score[e["transaction_id"]] for e in enriched):
            fail("deployed job: an enriched ensemble_score differs from its prediction")
        blended, dec, _ = blend_enrichment(
            torch.tensor([e["ensemble_score"] for e in enriched], dtype=torch.float32),
            torch.tensor([vec[e["transaction_id"]] for e in enriched],
                         dtype=torch.float32))
        blend_err = max(abs(e["fraud_score"] - b) for e, b in zip(enriched,
                                                                   blended.tolist()))
        if not blend_err <= BLEND_TOL:
            fail(f"deployed job: enriched fraud_score vs the CPU blend err {blend_err}")
        alerts = sum(client.end_offsets(T.ALERTS))
        high = sum(p["fraud_score"] > HIGH_RISK_CUT for p in preds)
        routed = re.search(r"routed (\d+) alerts", router_err)
        if routed is None or int(routed.group(1)) != alerts or alerts != high:
            fail(f"alert-router: {router_err[-500:]}; alerts topic {alerts}, "
                 f"predictions above {HIGH_RISK_CUT}: {high}")
        fired = Counter(first["analytics"]) + Counter(second["analytics"])
        on_topics = {t: sum(client.end_offsets(t)) for t in plane_topics()}
        want = {t: sum(fired[op] for op, tt in ANALYTICS_TOPIC.items() if tt == t)
                for t in plane_topics()}
        if on_topics != want:
            fail(f"deployed job: analytics topics {on_topics}, summaries' fired {want}")
        db_conn = sqlite3.connect(db)
        jobs = db_conn.execute("select job_id, status from jobs").fetchall()
        steps = [r[0] for r in db_conn.execute(
            "select step from checkpoints order by step").fetchall()]
        db_conn.close()
        if [j[1] for j in jobs] != ["FINISHED"] or int(final.group(1)) not in steps \
                or len(steps) < 3:
            fail(f"deployed job: metadata jobs {jobs}, checkpoints {steps}")
        mega = 0
        for summary in (first, second):
            k = summary["kernels"]
            if k["fallback"]["megakernel"] or k["dispatch"]["megakernel"] != summary[
                    "counters"]["batches"]:
                fail(f"deployed job: kernel snapshot {k} over "
                     f"{summary['counters']['batches']} batches")
            mega += k["dispatch"]["megakernel"]
        print(f"deployed job (broker, simulate --broker, run-job --broker --quant --mega "
              f"--analytics --enrichment, each a process): first run scored "
              f"{first['scored']} in {first['counters']['batches']} batches, stopped by "
              f"SIGTERM ({s1:.1f} s command, {first['txn_per_s']} txn/s), final checkpoint "
              f"step {final.group(1)}; the restart resumed from it and scored "
              f"{second['scored']} in {second['counters']['batches']} batches ({s2:.1f} s, "
              f"{second['txn_per_s']} txn/s), 0 duplicates; each of {DEPLOY_COUNT} ids once "
              f"on the predictions and enriched topics; blend vs its CPU version max err "
              f"{blend_err:.3e}; alert-router routed {alerts} = the alerts topic = "
              f"predictions above 0.7 ({router_s:.1f} s); analytics "
              f"{json.dumps(on_topics)}; metadata FINISHED, checkpoints {steps}; "
              f"megakernel {mega} dispatches, 0 fallbacks", flush=True)
        client.close()
    finally:
        _kill(procs)
    return {"megakernel": mega, "epilogue": 0, "flash_attention": 0, "dequant_matmul": 0,
            "dequant_rows": 0}


def run_deployed_phase(ops):
    """Phase 19: the job as deployed (see the module docstring). Returns the
    launches by path."""
    import tempfile
    from pathlib import Path

    from realtime_fraud_detection_tpu_torch.models.bert import DISTILBERT_BASE, TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.utils.config import KernelSettings

    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        sim_args = ["--users", str(STREAM_USERS), "--merchants", str(STREAM_MERCHANTS),
                    "--seed", str(DEPLOY_SEED)]
        procs = []
        try:
            t0 = time.perf_counter()
            broker = _port_proc(["broker", "--host", "127.0.0.1", "--port", str(port),
                                 "--log-dir", str(Path(tmp) / "wal")])
            procs.append(broker)
            _broker_client(port).close()
            simulate = _port_proc(["simulate", "--broker", f"127.0.0.1:{port}",
                                   "--count", str(DEPLOY_COUNT), "--tps", "1000000",
                                   *sim_args])
            procs.append(simulate)
            t1 = time.perf_counter()
            chain = {"epilogue": 1, "flash_attention": DISTILBERT_BASE.num_layers,
                     "dequant_matmul": 6 * DISTILBERT_BASE.num_layers, "dequant_rows": 2,
                     "megakernel": 0}
            tiny = run_planes(ops, "TINY", TINY_CONFIG, KernelSettings.mega(),
                              PLANES_COUNT["TINY"],
                              {k: int(k == "megakernel") for k in chain})
            base = run_planes(ops, "DistilBERT-base", DISTILBERT_BASE,
                              KernelSettings.full(), PLANES_COUNT["DistilBERT-base"], chain)
            seconds["a"] = round(time.perf_counter() - t1, 1)
            _, err, _ = _finish("simulate --broker", simulate)
            if "native_queue=True" not in err or "dropped=0" not in err:
                fail(f"simulate --broker: the gateway's native queue was not used or "
                     f"records were dropped: {err[-1000:]}")
            print(f"simulate --broker: {err.strip().splitlines()[-1]}", flush=True)
            t2 = time.perf_counter()
            deployed = run_deployed(tmp, port, sim_args)
            seconds["b"] = round(time.perf_counter() - t2, 1)
            seconds["broker_and_simulate_start"] = round(t1 - t0, 1)
        finally:
            _kill(procs)
    print(f"deployed-job phase seconds by part: {json.dumps(seconds)}", flush=True)
    return {"tiny_planes": tiny["launches"], "distilbert_base_planes": base["launches"],
            "deployed_job": deployed}


# the shared state and Kafka phase: the RESP tier beside the in-process
# stores, two replicas in one consumer group over the Kafka wire protocol
# sharing one state server, the commands across processes, the native tree
# scorer
KAFKA_SESSION_MS = 1_500                 # a dead replica is evicted after this
KAFKA_HEARTBEAT_S = 0.2
KAFKA_KILL_AFTER = 3                     # batches replica A completes, then dies
# the single-replica card / CPU comparison, cut from 4 batches to 2 for the
# command's time limit
KAFKA_SINGLE = 2 * BATCH
# the TINY transactions of (a), (b) and (c), cut from 16 batches to 8: the
# phase is round-trip bound, and took 327 s of a 1,138 s command on a slow
# host
STATE_COUNT = 8 * BATCH
# (a)'s shared-tier streams and (c)'s run-job --state, cut again to half
# (4 and 2 batches; the TINY one was 16, then 8): round-trip bound at 62-86
# txn/s on the card's host; (b)'s two Kafka replicas keep STATE_COUNT, so
# the survivor still scores batches after the kill
SHARED_COUNT = {"TINY": 4 * BATCH, "DistilBERT-base": 2 * BATCH}
STATE_JOB_COUNT = 2 * BATCH
SHARED_CPU_BATCHES = 1                   # (a)'s CPU run: the stream's first batch (cut from 2)
SERVE_STATE_PREDICTS = BATCH
NATIVE_TREE_TOL = 1e-5


def resp_spy(client):
    """Count the commands a ``RespClient`` sends by wrapping its ``execute``
    on the instance, as ``dispatch_spy`` wraps a scorer's dispatch."""
    count = {"n": 0}
    execute = client.execute

    def spy(*args):
        count["n"] += 1
        return execute(*args)

    client.execute = spy
    return count


def shared_keyspace(client, records):
    """The server's velocity windows ({(user, window): (count, amount)}),
    the ids without a ``transaction:{id}`` and each user's id list."""
    users = sorted({str(r["user_id"]) for r in records})
    windows = {}
    for key in client.keys("velocity:*"):
        _, user, window = key.decode().split(":")
        h = client.hgetall(key.decode())
        windows[(user, window)] = (int(h["count"]), float(h["amount"]))
    cached = {k.decode().split(":", 1)[1] for k in client.keys("transaction:*")}
    missing = [r["transaction_id"] for r in records if r["transaction_id"] not in cached]
    lists = {u: [b.decode() for b in client.lrange(f"user_transactions:{u}", 0, -1)]
             for u in users}
    return windows, missing, lists


def keyspace_digest(client):
    """sha256 over the sorted live keyspace (key, value), each key read by
    the command of its kind in the shared tier's schema; the key count."""
    import hashlib

    h = hashlib.sha256()
    keys = sorted(client.keys("*"))
    for key in keys:
        prefix = key.split(b":", 1)[0]
        if prefix == b"transaction":
            value = client.execute("GET", key)
        elif prefix.endswith(b"_transactions"):
            value = client.execute("LRANGE", key, 0, -1)
        else:
            value = client.execute("HGETALL", key)
        h.update(repr((key, value)).encode())
    return h.hexdigest(), len(keys)


def start_state_server(port, procs, aof=None):
    """``state-server`` on ``port`` in a process of its own (appended to
    ``procs``), with ``aof`` as its append-only file; returns the process
    once a client connects."""
    from realtime_fraud_detection_tpu_torch.state.resp import RespClient

    proc = _port_proc(["state-server", "--host", "127.0.0.1", "--port", str(port)]
                      + (["--aof", aof] if aof else []))
    procs.append(proc)
    for _ in range(600):
        try:
            RespClient(port=port).close()
            return proc
        except OSError:
            if proc.poll() is not None:
                fail(f"state-server exited {proc.returncode}: {proc.stderr.read()}")
            time.sleep(0.05)
    fail("state-server did not come up")


def round_trips_us(port, n=5_000):
    """Microseconds a round trip on this host's loopback: a RESP ``PING`` to
    the state server on ``port``, and a one-byte TCP echo on a thread of
    this process (the floor under any request-response protocol here)."""
    import socket
    import threading

    from realtime_fraud_detection_tpu_torch.state.resp import RespClient

    client = RespClient(port=port)
    try:
        for _ in range(200):
            client.ping()
        t0 = time.perf_counter()
        for _ in range(n):
            client.ping()
        ping = (time.perf_counter() - t0) / n * 1e6
    finally:
        client.close()
    listener = socket.create_server(("127.0.0.1", 0))

    def echo():
        conn, _ = listener.accept()
        with conn:
            while data := conn.recv(64):
                conn.sendall(data)

    thread = threading.Thread(target=echo, daemon=True)
    thread.start()
    with socket.create_connection(listener.getsockname()) as sock:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        t0 = time.perf_counter()
        for _ in range(n):
            sock.sendall(b"x")
            sock.recv(64)
        echo_us = (time.perf_counter() - t0) / n * 1e6
    thread.join(timeout=10)
    listener.close()
    return {"resp_ping_us": ping, "tcp_echo_us": echo_us}


def strip_timing(preds):
    return [{k: v for k, v in p.items() if k != "processing_time_ms"} for p in preds]


def stream_profiles(gen, records):
    """The profiles of the stream's users and merchants: all a scorer reads,
    and each seeded profile costs the shared tier one round trip."""
    users = {str(r["user_id"]) for r in records}
    merchants = {str(r["merchant_id"]) for r in records}
    return ({u: p for u, p in gen.users.profiles().items() if u in users},
            {m: p for m, p in gen.merchants.profiles().items() if m in merchants})


def run_shared_stream(ops, port, name, bert_config, kernels, count, expected):
    """Phase 20(a) for one width: phase 8's stream on the card through the
    shared tier (launch counters reset just before, read just after, the
    client's commands counted) and on the card with in-process stores, the
    server flushed before the shared run. Returns the launches, the timing,
    run 2's scorer and features, and ``cpu_check``, which runs the stream's
    first ``SHARED_CPU_BATCHES`` batches on the CPU through the shared tier
    (flushed first) and holds them against run 1's. The interpreter's
    garbage is collected before each timed run, and the time its collector
    ran inside each run is printed."""
    import gc

    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.state.resp import RespClient
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.utils.config import Config, QuantSettings

    gen = TransactionGenerator(num_users=STREAM_USERS, num_merchants=STREAM_MERCHANTS,
                               seed=SEED)
    records = gen.generate_batch(count)
    profiles = stream_profiles(gen, records)
    config = Config(quant=QuantSettings.full(), kernels=kernels)
    n_batches = count // BATCH
    client, check = RespClient(port=port), RespClient(port=port)
    try:
        client.flushdb()
        spy = resp_spy(client)

        def reset_spy(job):
            spy["n"] = 0            # after the profiles were seeded

        gc.collect()        # earlier phases' garbage is not this run's
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        job, broker, scorer, timer = drive_stream(
            records, profiles, bert_config, config, "cuda", timed=True,
            state_client=client, hook=reset_spy)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        commands = spy["n"]
        want = {k: v * n_batches for k, v in expected.items()}
        per_batch = [b["launches"] for b in timer.batches]
        if launches != want or per_batch != [sum(expected.values())] * n_batches:
            fail(f"{name} shared tier: launch counts {launches} / {per_batch} "
                 f"(want {want})")
        preds = check_stream_output(f"{name} shared tier", job, broker, records)
        shared = timer.summary(scorer)
        windows, missing, lists = shared_keyspace(check, records)

        tokens = []
        gc.collect()
        _, local_broker, local, local_timer = drive_stream(
            records, profiles, bert_config, config, "cuda", timed=True, tokens=tokens)
        local_preds = topic_values(local_broker, T.PREDICTIONS)
        local_sum = local_timer.summary(local)
        want_windows = {(u, w): (int(c), a) for u, w, c, a, _ in local.velocity.entries()}
        if windows != want_windows:
            diff = sorted(set(windows.items()) ^ set(want_windows.items()))[:4]
            fail(f"{name} shared tier: {len(windows)} velocity windows on the server, "
                 f"{len(want_windows)} in process; e.g. {diff}")
        if missing:
            fail(f"{name} shared tier: {len(missing)} ids without transaction:{{id}}, "
                 f"e.g. {missing[:3]}")
        bad = [u for u, ids in lists.items()
               if ids != local.txn_cache.get_user_transactions(u)]
        if bad:
            fail(f"{name} shared tier: user_transactions lists differ for {len(bad)} "
                 f"users, e.g. {bad[0]}")

        tol = noise_bound(scorer.models, bert_config, tokens,
                          scorer.ensemble_params.weights)
        err_local = compare_streams(f"{name} shared tier", preds, local_preds, tol,
                                    "in-process stores on the card")
        identical = strip_timing(preds) == strip_timing(local_preds)
    finally:
        client.close()
        check.close()

    def cpu_check():
        """Run 3, the CPU through the shared tier (untimed), on the records
        of run 1's first batches: they are a prefix of each partition, so a
        fresh consumer polls the same batches, and each batch's predictions
        depend only on the batches before it. Returns its largest difference
        from run 1."""
        n = SHARED_CPU_BATCHES * BATCH
        ids = {p["transaction_id"] for p in preds[:n]}
        first = [r for r in records if r["transaction_id"] in ids]
        cpu_client = RespClient(port=port)
        try:
            cpu_client.flushdb()
            cpu_job, cpu_broker, _, _ = drive_stream(first, profiles, bert_config,
                                                     config, "cpu",
                                                     state_client=cpu_client)
            cpu_preds = check_stream_output(f"{name} shared tier (CPU)", cpu_job,
                                            cpu_broker, first)
        finally:
            cpu_client.close()
        return compare_streams(f"{name} shared tier, first {n}", preds[:n], cpu_preds,
                               tol, "the CPU on the shared tier")

    summary = {
        "txns": count, "launches": launches, "bound": tol,
        "max_err": {"in_process_card": err_local},
        "identical_to_in_process": identical,
        "txn_per_s": {"shared": shared["txn_per_s"], "local": local_sum["txn_per_s"]},
        "batch_ms_p50_p99": {
            "shared": [shared["batch_ms_p50"], shared["batch_ms_p99"]],
            "local": [local_sum["batch_ms_p50"], local_sum["batch_ms_p99"]]},
        "assemble_host_ms_per_batch": {
            "shared": shared["host_ms_per_batch"]["assemble"],
            "local": local_sum["host_ms_per_batch"]["assemble"]},
        "write_back_host_ms_per_batch": {
            "shared": shared["smoke_ms_per_batch"]["_write_back"],
            "local": local_sum["smoke_ms_per_batch"]["_write_back"]},
        "gc_ms": {"shared": shared["gc_ms"], "local": local_sum["gc_ms"]},
        "write_back_ms_max": {"shared": max(timer.parts["_write_back"]),
                              "local": max(local_timer.parts["_write_back"])},
        "resp_commands_per_batch": commands / n_batches,
        "resp_commands_per_txn": commands / count,
        "velocity_windows": len(windows), "users": len(lists)}
    print(f"{name} shared tier (batch {BATCH}, depth 2, {STREAM_USERS} users; the "
          f"keyspace equals the in-process stores: {len(windows)} velocity windows, "
          f"{count} cached ids, {len(lists)} user lists): " + json.dumps(summary),
          flush=True)
    features = [f["features"] for f in topic_values(local_broker, T.FEATURES)]
    return dict(launches=launches, summary=summary, scorer=local, features=features,
                cpu_check=cpu_check)


class GroupBroker:
    """A ``KafkaBroker`` whose ``consumer`` is a group-managed member with a
    short session (``StreamJob`` asks its broker for a consumer)."""

    def __init__(self, broker):
        self.broker = broker

    def __getattr__(self, name):
        return getattr(self.broker, name)

    def consumer(self, topics, group_id, faults=None):
        from realtime_fraud_detection_tpu_torch.stream.kafka_group import (
            KafkaGroupConsumer,
        )

        return KafkaGroupConsumer(self.broker, list(topics), group_id,
                                  session_timeout_ms=KAFKA_SESSION_MS,
                                  heartbeat_interval_s=KAFKA_HEARTBEAT_S)


class ReplicaDied(Exception):
    pass


def mega_spy(scorer, batches):
    """Per batch: the rows, and the growth of this scorer's own megakernel
    dispatch / fallback counts (two scorers share the launch counters)."""
    dispatch = scorer.dispatch

    def spy(records, now=None, **kw):
        snap0 = scorer.kernel_snapshot()
        out = dispatch(records, now=now, **kw)
        snap = scorer.kernel_snapshot()
        batches.append(dict(
            rows=len(records), ids=[r["transaction_id"] for r in records],
            mega=snap["dispatch"]["megakernel"] - snap0["dispatch"]["megakernel"],
            fallback=snap["fallback"]["megakernel"] - snap0["fallback"]["megakernel"]))
        return out

    scorer.dispatch = spy


def replica_thread(rep, kafka_port, redis_port, config, models, done, kill_after=None):
    """One replica: its own ``mega()`` scorer, ``RespClient``, Kafka client
    and group member; runs the job until ``done`` is set. With
    ``kill_after`` it dies once that many batches completed: its next
    completion raises, then its connections close without a LeaveGroup."""
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.state.resp import RespClient
    from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
    from realtime_fraud_detection_tpu_torch.stream.kafka import KafkaBroker

    broker = client = job = None
    try:
        broker = KafkaBroker(bootstrap=f"127.0.0.1:{kafka_port}")
        client = RespClient(port=redis_port)
        scorer = TorchFraudScorer(config, models=models, bert_config=TINY_CONFIG,
                                  device="cuda", state_client=client)
        rep["batches"], rep["cached_reemits"] = [], 0
        mega_spy(scorer, rep["batches"])
        job = StreamJob(GroupBroker(broker), scorer,
                        JobConfig(max_batch=BATCH, pipeline_depth=2))
        rep["scorer"], rep["job"] = scorer, job
        complete, emit = job.complete_batch, job._emit_cached_dups
        completed = [0]

        def complete_batch(ctx, *args, **kwargs):
            if kill_after is not None and completed[0] == kill_after:
                raise ReplicaDied
            out = complete(ctx, *args, **kwargs)
            completed[0] += 1
            return out

        def emit_cached(ctx):
            rep["cached_reemits"] += len(ctx.cached_dups)
            return emit(ctx)

        job.complete_batch, job._emit_cached_dups = complete_batch, emit_cached
        rep["ready"].set()
        while not done.is_set():
            job.run_until_drained(now=STREAM_NOW)
            time.sleep(0.02)
    except ReplicaDied:
        # process death: heartbeats stop, sockets close, no LeaveGroup
        rep["died_at"] = time.perf_counter()
        rep["completed"] = completed[0]
        job.consumer._closed.set()
        broker.close()
        client.close()
        broker = client = None
    except Exception as e:              # reported by the main thread
        rep["error"] = e
    finally:
        rep["ready"].set()
        if job is not None and kill_after is None:
            job.consumer.close()
        for c in (broker, client):
            if c is not None:
                c.close()


def run_two_replicas(ops, tmp, records, profiles, config, models):
    """Phase 20(b) 1-4: the stream produced idempotently with gzip, two
    replicas on two threads in one group sharing one state server, replica A
    killed after ``KAFKA_KILL_AFTER`` batches; the gates of the module
    docstring. Returns the launches and the printed summary."""
    import threading
    from collections import Counter
    from pathlib import Path

    from realtime_fraud_detection_tpu_torch.state.resp import RespClient
    from realtime_fraud_detection_tpu_torch.state.shared import SharedProfileStore
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.kafka import KafkaBroker
    from realtime_fraud_detection_tpu_torch.stream.kafka_fake import FakeKafkaServer

    fake = FakeKafkaServer(port=free_port()).start()
    aof, redis_port, procs = str(Path(tmp) / "state.aof"), free_port(), []
    producer = checker = client = None
    done = threading.Event()
    reps = {name: {"ready": threading.Event()} for name in ("A", "B")}
    threads = []
    try:
        redis = start_state_server(redis_port, procs, aof)
        client = RespClient(port=redis_port)
        SharedProfileStore(client).seed(*profiles)
        producer = KafkaBroker(bootstrap=f"127.0.0.1:{fake.port}", idempotent=True,
                               compression="gzip")
        t0 = time.perf_counter()
        producer.produce_batch(T.TRANSACTIONS, records, key_fn=lambda r: str(r["user_id"]))
        produce_s = time.perf_counter() - t0
        checker = KafkaBroker(bootstrap=f"127.0.0.1:{fake.port}")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t_run = time.perf_counter()
        for name, kill in (("A", KAFKA_KILL_AFTER), ("B", None)):
            t = threading.Thread(target=replica_thread, name=f"replica-{name}", args=(
                reps[name], fake.port, redis_port, config, models, done, kill))
            t.start()
            threads.append(t)
            if not reps[name]["ready"].wait(120) or "error" in reps[name]:
                fail(f"replica {name} did not start: {reps[name].get('error')}")
        n_parts = checker.partitions(T.TRANSACTIONS)
        group = reps["B"]["job"].config.group_id
        want_ids = Counter(r["transaction_id"] for r in records)
        rebalance_s = None
        deadline = time.perf_counter() + 300
        while time.perf_counter() < deadline:
            for rep in reps.values():
                if "error" in rep:
                    fail(f"a replica failed: {rep['error']!r}")
            if "died_at" in reps["A"] and rebalance_s is None:
                m = reps["B"]["job"].consumer.membership
                if m.generation >= 0 and sorted(m.assignment.get(
                        T.TRANSACTIONS, [])) == list(range(n_parts)):
                    rebalance_s = time.perf_counter() - reps["A"]["died_at"]
            if rebalance_s is not None and checker.lag(group, T.TRANSACTIONS) == 0:
                break
            time.sleep(0.05)
        else:
            fail("two replicas: the group did not drain within 300 s")
        done.set()
        for t in threads:
            t.join(timeout=60)
            if t.is_alive():
                fail(f"{t.name} did not stop")
        run_s = time.perf_counter() - t_run
        torch.cuda.synchronize()
        launches = ops.launch_counts()

        preds = topic_values(checker, T.PREDICTIONS)
        ids = Counter(p["transaction_id"] for p in preds)
        repeats = len(preds) - len(ids)
        replays = sum(bool(p["explanation"].get("replayed_from_cache")) for p in preds)
        scored_once = Counter(p["transaction_id"] for p in preds
                              if not p["explanation"].get("replayed_from_cache"))
        if set(ids) != set(want_ids) or len(ids) != len(records) \
                or set(scored_once.values()) != {1} or len(scored_once) != len(records):
            fail(f"two replicas: {len(ids)} distinct ids on the predictions topic, "
                 f"{len(scored_once)} scored, not each once")
        lag = checker.lag(group, T.TRANSACTIONS)
        if lag:
            fail(f"two replicas: the group's lag is {lag}")
        counts = Counter(str(r["user_id"]) for r in records)
        wrong = {u: (int(client.hget(f"velocity:{u}:24hour", "count") or 0), n)
                 for u, n in counts.items()
                 if int(client.hget(f"velocity:{u}:24hour", "count") or 0) != n}
        if wrong:
            fail(f"two replicas: {len(wrong)} users' 24hour counts differ from the "
                 f"stream, e.g. {list(wrong.items())[:3]}")
        # a skipped duplicate is either re-emitted from the shared cache (a
        # repeat on the topic) or was re-polled after a rebalance while its
        # batch was still in flight (that batch emits it once)
        a, b = reps["A"], reps["B"]
        b_dup = b["job"].counters["duplicates_skipped"]
        a_dup = a["job"].counters["duplicates_skipped"]
        inflight_skips = {"A": a_dup - a["cached_reemits"],
                          "B": b_dup - b["cached_reemits"]}
        if repeats != replays or repeats != a["cached_reemits"] + b["cached_reemits"] \
                or min(inflight_skips.values()) < 0:
            fail(f"two replicas: {repeats} repeats on the predictions topic, {replays} "
                 f"cache re-emissions; A skipped {a_dup} ({a['cached_reemits']} "
                 f"re-emitted), B skipped {b_dup} ({b['cached_reemits']} re-emitted)")
        mega_batches = one_row = 0
        for name, rep in reps.items():
            for batch in rep["batches"]:
                if batch["rows"] >= 2 and (batch["mega"], batch["fallback"]) != (1, 0):
                    fail(f"two replicas: a {batch['rows']}-row batch of replica {name} "
                         f"did not dispatch the megakernel ({batch})")
                if batch["rows"] == 1 and (batch["mega"], batch["fallback"]) != (1, 1):
                    fail(f"two replicas: a one-row batch of replica {name}: {batch}")
                mega_batches += batch["rows"] >= 2
                one_row += batch["rows"] == 1
        if launches["megakernel"] != mega_batches:
            fail(f"two replicas: {launches['megakernel']} megakernel launches, "
                 f"{mega_batches} batches of two or more rows")
        digest, n_keys = keyspace_digest(client)
        client.close()
        client = None
        redis.kill()                    # kill -9: nothing flushed beyond the log
        redis.wait()
        t_restart = time.perf_counter()
        start_state_server(redis_port, procs, aof)
        restart_s = time.perf_counter() - t_restart
        client = RespClient(port=redis_port)
        digest2, n_keys2 = keyspace_digest(client)
        if (digest2, n_keys2) != (digest, n_keys):
            fail(f"two replicas: the keyspace after the AOF restart ({n_keys2} keys) "
                 f"differs from before the kill ({n_keys})")
        summary = {
            "txns": len(records), "partitions": n_parts,
            "produce_idempotent_gzip_s": produce_s, "run_s": run_s,
            "replica_a": {"completed_batches": a["completed"],
                          "dispatched_batches": len(a["batches"]),
                          "scored": a["job"].counters["scored"],
                          "duplicates_skipped": a_dup,
                          "cached_reemits": a["cached_reemits"],
                          "inflight_skips": inflight_skips["A"]},
            "replica_b": {"batches": len(b["batches"]),
                          "scored": b["job"].counters["scored"],
                          "duplicates_skipped": b_dup,
                          "cached_reemits": b["cached_reemits"],
                          "inflight_skips": inflight_skips["B"],
                          "rebalances": b["job"].consumer.membership.rebalances},
            "rebalance_s": rebalance_s, "repeats_on_predictions": repeats,
            "b_duplicates_equal_repeats": b_dup == repeats,
            "megakernel_batches": mega_batches, "one_row_batches": one_row,
            "launches": launches, "aof_keys": n_keys, "aof_restart_s": restart_s,
            "aof_bytes": Path(aof).stat().st_size}
        print("two replicas over Kafka on one state server (session "
              f"{KAFKA_SESSION_MS} ms; A killed after {KAFKA_KILL_AFTER} batches, no "
              f"LeaveGroup): each of {len(records)} ids on the predictions topic, "
              f"scored once; lag 0; every user's 24hour count equals the stream's; "
              f"repeats {repeats} = cache re-emissions, each other skip a record "
              f"re-polled while its batch was in flight; the keyspace digest survives "
              f"the AOF restart: " + json.dumps(summary), flush=True)
    finally:
        done.set()
        for t in threads:
            t.join(timeout=60)
        for c in (producer, checker, client):
            if c is not None:
                c.close()
        _kill(procs)
        fake.stop()
    return launches, summary


def run_single_replica(records, profiles, config, models):
    """Phase 20(b) 5: one replica over a fresh fake on the card, the same on
    the CPU, and on the in-memory broker: the batch sequences and the
    predictions."""
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.kafka import KafkaBroker
    from realtime_fraud_detection_tpu_torch.stream.kafka_fake import FakeKafkaServer

    runs = {}
    for label, device, kafka in (("card", "cuda", True), ("cpu", "cpu", True),
                                 ("memory", "cuda", False)):
        fake = FakeKafkaServer(port=free_port()).start() if kafka else None
        broker = KafkaBroker(bootstrap=f"127.0.0.1:{fake.port}") if kafka else None
        batches, tokens = [], []
        try:
            job, broker, scorer, _ = drive_stream(
                records, profiles, TINY_CONFIG, config, device, models=models,
                broker=broker, tokens=tokens,
                hook=lambda job: mega_spy(job.scorer, batches))
            preds = check_stream_output(f"single replica ({label})", job, broker, records)
            runs[label] = dict(batches=[b["ids"] for b in batches], preds=preds,
                               tokens=tokens, scorer=scorer)
        finally:
            if kafka:
                broker.close()
                fake.stop()
    if runs["card"]["batches"] != runs["cpu"]["batches"]:
        fail("single replica over Kafka: the card and the CPU closed different batches")
    tol = noise_bound(runs["card"]["scorer"].models, TINY_CONFIG, runs["cpu"]["tokens"],
                      runs["card"]["scorer"].ensemble_params.weights)
    err = compare_streams("TINY over Kafka", runs["card"]["preds"], runs["cpu"]["preds"],
                          tol, "the CPU over Kafka")
    same = runs["card"]["batches"] == runs["memory"]["batches"]
    print(f"single replica over Kafka ({len(records)} txns): the card and the CPU closed "
          f"the same {len(runs['card']['batches'])} batches (sizes "
          f"{[len(b) for b in runs['card']['batches']]}); max err {err:.3e} (bound "
          f"{tol:.3e}); batch sequence equal to the in-memory broker's: {same}",
          flush=True)
    return {"batches": len(runs["card"]["batches"]), "max_err": err, "bound": tol,
            "same_batches_as_memory": same}


def run_state_commands(tmp):
    """Phase 20(c): ``state-server``, ``run-job --state`` and ``serve`` with
    ``RTFD_STATE_ADDR``, each a process of its own, then ``kill -9`` of the
    server and its restart from the AOF; the refusal. The refused
    ``run-job`` starts beside ``run-job --state`` (it exits before it builds
    a scorer); ``serve`` starts after the job, so that nothing else runs
    beside the job's timed run."""
    import os
    import signal
    import urllib.request
    from collections import Counter
    from pathlib import Path

    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.state.resp import RespClient

    port, http = free_port(), free_port()
    aof = str(Path(tmp) / "cmd_state.aof")
    procs, client, serve_log = [], None, None
    out = {}

    def counts():
        return {u: int(client.hget(f"velocity:{u}:24hour", "count") or 0) for u in want}

    try:
        t0 = time.perf_counter()
        server = start_state_server(port, procs, aof)
        client = RespClient(port=port)
        refused = _port_proc(["run-job", "--state", f"127.0.0.1:{port}", "--count", "8",
                              "--checkpoint-dir", str(Path(tmp) / "ck")])
        procs.append(refused)
        preds_path = str(Path(tmp) / "preds.jsonl")
        job_out, job_err, job_s = _finish("run-job --state", _port_proc(
            ["run-job", "--state", f"127.0.0.1:{port}", "--count", str(STATE_JOB_COUNT),
             "--quant", "--mega", "--predictions-out", preds_path]), timeout=600)
        summary = json.loads(job_out.strip().splitlines()[-1])
        gen = TransactionGenerator(num_users=10_000, num_merchants=5_000, seed=42,
                                   tps=1000.0)
        records = gen.generate_batch(STATE_JOB_COUNT)
        with open(preds_path) as f:
            pred_ids = [json.loads(line)["transaction_id"] for line in f]
        if sorted(pred_ids) != sorted(r["transaction_id"] for r in records) \
                or summary["counters"]["errors"] or summary["lag"]:
            fail(f"run-job --state: {len(pred_ids)} predictions, summary {summary}")
        k = summary["kernels"]
        if k["fallback"]["megakernel"] or \
                k["dispatch"]["megakernel"] != summary["counters"]["batches"]:
            fail(f"run-job --state: kernel snapshot {k}")
        want = Counter(str(r["user_id"]) for r in records)
        got = counts()
        if got != want:
            fail(f"run-job --state: {sum(got[u] != want[u] for u in want)} users' 24hour "
                 f"counts differ from the stream")
        out["run_job"] = {"command_s": job_s, "txn_per_s": summary["txn_per_s"],
                          "host_stage_mean_ms": summary["host_stage_mean_ms"],
                          "batches": summary["counters"]["batches"]}
        _, refusal, _ = _finish("run-job --state --checkpoint-dir", refused, want_rc=2,
                                timeout=120)
        if "--checkpoint-dir refused" not in refusal or "--aof" not in refusal:
            fail(f"run-job --state --checkpoint-dir: {refusal[-1000:]}")

        config_path = str(Path(tmp) / "serve.json")
        with open(config_path, "w") as f:
            json.dump({"monitoring": {"prometheus_port": 0}}, f)
        serve_log = open(Path(tmp) / "serve.err", "w+")
        serve = subprocess.Popen(
            [sys.executable, "-m", "realtime_fraud_detection_tpu_torch", "serve",
             "--host", "127.0.0.1", "--port", str(http), "--config", config_path,
             "--quant", "--mega"], cwd=Path(__file__).resolve().parent,
            env={**os.environ, "RTFD_STATE_ADDR": f"127.0.0.1:{port}"},
            stdout=subprocess.DEVNULL, stderr=serve_log, text=True)
        procs.append(serve)
        users = sorted(want)
        extra = TransactionGenerator(num_users=10_000, num_merchants=5_000,
                                     seed=SEED + 20).generate_batch(SERVE_STATE_PREDICTS)
        for i, txn in enumerate(extra):
            txn["user_id"] = users[(i * 37) % len(users)]
        for _ in range(1200):
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{http}/health", timeout=2).read()
                break
            except OSError:
                if serve.poll() is not None:
                    serve_log.seek(0)
                    fail(f"serve exited {serve.returncode}: {serve_log.read()[-2000:]}")
                time.sleep(0.1)
        result = run_load_process(http, extra)
        for txn in extra:
            want[txn["user_id"]] += 1
        got = counts()
        if got != want:
            fail(f"serve with RTFD_STATE_ADDR: {sum(got[u] != want[u] for u in want)} "
                 f"users' 24hour counts are not the stream's plus their requests")
        serve.send_signal(signal.SIGTERM)
        if serve.wait(timeout=120) != 0:
            fail(f"serve: exit {serve.returncode} after SIGTERM")
        serve_log.seek(0)
        serve_err = serve_log.read()
        if f"using shared state tier at 127.0.0.1:{port}" not in serve_err:
            fail(f"serve: standard error does not name the state tier: {serve_err[-1500:]}")
        lat = sorted((a["t1"] - a["t0"]) * 1e3 for a in result["answers"])
        out["serve"] = {"requests": len(lat), "clients": SERVE_CLIENTS,
                        "p50_ms": lat[len(lat) // 2], "p99_ms": lat[int(len(lat) * 0.99)],
                        "txn_per_s": len(lat) / result["wall_s"]}

        client.close()
        client = None
        server.kill()                       # kill -9: nothing flushed beyond the log
        server.wait()
        t_restart = time.perf_counter()
        start_state_server(port, procs, aof)
        client = RespClient(port=port)
        out["aof_restart_s"] = time.perf_counter() - t_restart
        if counts() != want:
            fail("state-server restarted from its AOF: the 24hour counts changed")
        out["users"] = len(want)
        out["seconds"] = time.perf_counter() - t0
        print("state-server + run-job --state + serve (RTFD_STATE_ADDR), each a "
              "process: every user's 24hour count equals the stream's, then the stream's "
              "plus its requests, and again after kill -9 and the AOF restart; serve "
              "names the state tier; --state with --checkpoint-dir exits 2: "
              + json.dumps(out), flush=True)
    finally:
        if client is not None:
            client.close()
        _kill(procs)
        if serve_log is not None:
            serve_log.close()
    return {"megakernel": summary["counters"]["batches"], "epilogue": 0,
            "flash_attention": 0, "dequant_matmul": 0, "dequant_rows": 0}


def check_native_trees(scorer, features):
    """Phase 20(d): the C++ tree scorer built from the repository's source,
    on run 2's TINY feature rows, against the port's plain tree path."""
    from realtime_fraud_detection_tpu_torch import native
    from realtime_fraud_detection_tpu_torch.models.trees import tree_ensemble_logits

    t0 = time.perf_counter()
    if not native.native_trees_available():
        fail(f"the native tree scorer did not build: {native._trees_error}")
    build_s = time.perf_counter() - t0
    x = torch.tensor(features, dtype=torch.float32)
    trees = scorer.models.trees
    got = torch.from_numpy(native.NativeTreeScorer(trees).logits(x.numpy()))
    want = tree_ensemble_logits(trees, x.cuda()).cpu()
    err = float((got - want).abs().max())
    if not err <= NATIVE_TREE_TOL:
        fail(f"native tree scorer: max abs err {err} vs the plain tree path")
    print(f"native tree scorer ({native.native_trees_library_path()}, built / loaded in "
          f"{build_s:.2f} s): {x.shape[0]} TINY feature rows, {trees.feature.shape[0]} "
          f"trees; logits max abs err {err:.3e} vs the plain tree path on the card "
          f"(tolerance {NATIVE_TREE_TOL})", flush=True)
    return err


def run_state_phase(ops):
    """Phase 20: the shared state tier and the Kafka wire tier (see the
    module docstring). Returns the launches by path."""
    import tempfile

    from realtime_fraud_detection_tpu_torch.models.bert import DISTILBERT_BASE, TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    seconds = {}
    t0 = time.perf_counter()
    chain = {"epilogue": 1, "flash_attention": DISTILBERT_BASE.num_layers,
             "dequant_matmul": 6 * DISTILBERT_BASE.num_layers, "dequant_rows": 2,
             "megakernel": 0}
    gen = TransactionGenerator(num_users=STREAM_USERS, num_merchants=STREAM_MERCHANTS,
                               seed=SEED)
    records = gen.generate_batch(STATE_COUNT)
    profiles = stream_profiles(gen, records)
    config = Config(quant=QuantSettings.full(), kernels=KernelSettings.mega())
    models = seeded_models(TINY_CONFIG)
    port, procs = free_port(), []
    try:
        start_state_server(port, procs)
        rtt = round_trips_us(port)
        print(f"loopback round trips on this host: {json.dumps(rtt)}", flush=True)
        tiny = run_shared_stream(ops, port, "TINY", TINY_CONFIG, KernelSettings.mega(),
                                 SHARED_COUNT["TINY"],
                                 {k: int(k == "megakernel") for k in chain})
        base = run_shared_stream(ops, port, "DistilBERT-base", DISTILBERT_BASE,
                                 KernelSettings.full(), SHARED_COUNT["DistilBERT-base"],
                                 chain)
        seconds["a_card"] = round(time.perf_counter() - t0, 1)
        # (b), (c) and (a)'s CPU runs one after another, so that nothing
        # runs beside a timed part
        with tempfile.TemporaryDirectory() as tmp:
            t1 = time.perf_counter()
            replicas, _ = run_two_replicas(ops, tmp, records, profiles, config, models)
            run_single_replica(records[:KAFKA_SINGLE], profiles, config, models)
            seconds["b"] = round(time.perf_counter() - t1, 1)
            t2 = time.perf_counter()
            run_job_state = run_state_commands(tmp)
            seconds["c"] = round(time.perf_counter() - t2, 1)
        t3 = time.perf_counter()
        cpu_errs = [tiny["cpu_check"](), base["cpu_check"]()]
        seconds["a_cpu"] = round(time.perf_counter() - t3, 1)
    finally:
        _kill(procs)
    t4 = time.perf_counter()
    check_native_trees(tiny["scorer"], tiny["features"])
    seconds["d"] = round(time.perf_counter() - t4, 1)
    seconds["total"] = round(time.perf_counter() - t0, 1)
    print(f"shared state and Kafka phase seconds by part: {json.dumps(seconds)}; "
          f"the CPU runs' max err TINY / DistilBERT-base {json.dumps(cpu_errs)}",
          flush=True)
    return {"tiny_shared_state": tiny["launches"],
            "distilbert_base_shared_state": base["launches"],
            "tiny_kafka_two_replicas": replicas, "run_job_state": run_job_state}


# the pool and fleet phase (21): phase 8's TINY mega() stream and models
# through the device pool on the one card (a pool of every visible card,
# then 2 and 4 replicas sharing it, each on its own stream), the faults on
# the pool, a fleet of real scorers and the serving router
POOL_REPLICAS = ("all", 2, 4)
POOL_BASE_BATCHES = 4                    # the DistilBERT-base leg's batches
POOL_FAULT_WINDOW = (6.0, 10.0)          # dispatched batches: replica 0 dead
POOL_SLOW_WINDOW = (4.0, 5.0)            # dispatched batches: replica 0 slowed
POOL_SLOW_S = 0.05
POOL_SWAP_BATCHES = 8                    # the hot swap: 16 batches, swap at 8
# the pooled / unpooled streams of (a), 4 runs at each replica count: cut
# from 16 batches to 8, then to 4, for the command's time limit
# (the faults and the swap keep 16)
POOL_STREAM_TXNS = 4 * BATCH
FLEET_TXNS = 16 * BATCH
FLEET_WORKERS = 4
FLEET_TOL = 1e-4                         # the shard drill's bf16 floor
# the router's and the ingress client's /predict, one at a time: cut from
# 256 to 64 for the command's time limit
ROUTER_PREDICTS = BATCH // 4


def drive_pool_stream(records, profiles, config, devices=None, depth=2, window=None,
                      make_plan=None):
    """Phase 8's TINY stream through ``StreamJob`` on a fresh scorer at the
    fixed virtual clock. With ``devices`` ("all": every visible card, or a
    list) its batches run on a ``DevicePool`` of those replicas (the job's
    window is the pool's capacity), else unpooled at pipeline ``depth``.
    ``window`` pins the job's in-flight window; ``make_plan(pool)`` gives a
    ``ChaosPlan`` on a clock that counts dispatched batches, polled before
    each dispatch. Returns (job, broker, scorer, timer, pool)."""
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.scoring.device_pool import DevicePool
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
    from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker

    scorer = TorchFraudScorer(config, models=seeded_models(TINY_CONFIG),
                              bert_config=TINY_CONFIG, device="cuda")
    scorer.seed_profiles(*profiles)
    pool = None
    if devices is not None:
        pool = DevicePool(scorer, devices=None if devices == "all" else devices)
    broker = InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(max_batch=BATCH, pipeline_depth=depth,
                                              device_pool=pool is not None))
    if window is not None:
        job._inflight_depth = lambda: window
    if make_plan is not None:
        plan, dispatch, clock = make_plan(pool), job.dispatch_batch, [0]

        def polled(batch, now=None):
            plan.poll(float(clock[0]))
            clock[0] += 1
            return dispatch(batch, now=now)

        job.dispatch_batch = polled
    broker.produce_batch(T.TRANSACTIONS, records, key_fn=lambda r: str(r["user_id"]))
    timer = StreamTimer(job, scorer)
    try:
        job.run_until_drained(now=STREAM_NOW)
    finally:
        job.close()
        timer.close()
    return job, broker, scorer, timer, pool


def pool_rows(name, job, broker, records):
    """The predictions topic as (id, fraud_score, confidence, decision, risk
    level) rows in emitted order, after ``check_stream_output``'s gates."""
    from realtime_fraud_detection_tpu_torch.stream import topics as T

    check_stream_output(name, job, broker, records)
    return [(p["transaction_id"], p["fraud_score"], p["confidence"], p["decision"],
             p["risk_level"]) for p in topic_values(broker, T.PREDICTIONS)]


def run_pool_streams(ops, records, profiles, config):
    """Phase 21(a), the TINY stream: at each replica count, pooled and the
    unpooled job at the pool's window in turns (pooled, unpooled, unpooled,
    pooled), every run's predictions bit-equal to the first's; launches a
    batch (counters reset just before each pooled run, read just after);
    txn/s and batch p50 / p99 of each run."""
    import gc

    launches, out = {}, {}
    for reps in POOL_REPLICAS:
        devices = "all" if reps == "all" else ["cuda:0"] * reps
        name = f"TINY pool {reps}"
        runs, first, window = [], None, None
        for pooled in (True, False, False, True):
            gc.collect()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            job, broker, scorer, timer, pool = drive_pool_stream(
                records, profiles, config, devices=devices if pooled else None,
                depth=window or 2)
            torch.cuda.synchronize()
            got = ops.launch_counts()
            label = name if pooled else f"{name} (unpooled, window {window})"
            rows = pool_rows(label, job, broker, records)
            if pooled:
                window = pool.total_slots()
                n_batches = len(timer.batches)
                per_batch = sorted({b["launches"] for b in timer.batches})
                if got != {k: n_batches * int(k == "megakernel") for k in got} \
                        or per_batch != [1]:
                    fail(f"{name}: launches {got}, per batch {per_batch}")
                launches[f"tiny_pool_{reps}"] = got
                st = pool.stats()
            if first is None:
                first = rows
            elif rows != first:
                fail(f"{label}: {sum(a != b for a, b in zip(rows, first))} of "
                     f"{len(rows)} rows differ from the first pooled run")
            timing = timer.summary(scorer)
            runs.append(dict(pooled=pooled, txn_per_s=timing["txn_per_s"],
                             batch_ms_p50=timing["batch_ms_p50"],
                             batch_ms_p99=timing["batch_ms_p99"], gc_ms=timing["gc_ms"]))
        out[str(reps)] = dict(replicas=len(pool), window=window, runs=runs,
                              dispatched=[d["dispatched"] for d in st["devices"]],
                              queue_wait_ms=[d["queue_wait_ms"] for d in st["devices"]])
        print(f"{name}: {len(records)} txns in {n_batches} batches on {len(pool)} "
              f"replica(s), window {window}, launches {launches[f'tiny_pool_{reps}']} "
              f"(hand-written launches a batch [1]); pooled and unpooled at window "
              f"{window} in turns, every row bit-equal: " + json.dumps(out[str(reps)]),
              flush=True)
    return launches, out


def run_pool_distilbert(ops, records, profiles):
    """Phase 21(a), the DistilBERT-base ``full()`` leg: 4 batches of 256
    through 2 replicas on the card against the unpooled scorer, all four in
    flight on both sides; the chain's launches a batch."""
    from realtime_fraud_detection_tpu_torch.models.bert import DISTILBERT_BASE
    from realtime_fraud_detection_tpu_torch.scoring.device_pool import DevicePool
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    chain = {"epilogue": 1, "flash_attention": DISTILBERT_BASE.num_layers,
             "dequant_matmul": 6 * DISTILBERT_BASE.num_layers, "dequant_rows": 2,
             "megakernel": 0}
    batches = [records[i * BATCH:(i + 1) * BATCH] for i in range(POOL_BASE_BATCHES)]
    runs = []
    # in turns: unpooled, pooled, pooled, unpooled (the first run warms the
    # DistilBERT-base path)
    for pooled in (False, True, True, False):
        scorer = TorchFraudScorer(Config(quant=QuantSettings.full(),
                                         kernels=KernelSettings.full()),
                                  models=seeded_models(DISTILBERT_BASE),
                                  bert_config=DISTILBERT_BASE, device="cuda")
        scorer.seed_profiles(*profiles)
        if pooled:
            DevicePool(scorer, devices=["cuda:0"] * 2)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        pend = [scorer.dispatch(b, now=STREAM_NOW) for b in batches]
        res = [scorer.finalize(p, now=STREAM_NOW) for p in pend]
        torch.cuda.synchronize()
        runs.append(dict(pooled=pooled, launches=ops.launch_counts(),
                            per_batch=[p.kernel_launches for p in pend],
                            ms=(time.perf_counter() - t0) * 1e3,
                            rows=[(r["transaction_id"], r["fraud_score"], r["confidence"],
                                   r["decision"], r["risk_level"]) for b in res for r in b],
                         replicas=[p.pool_token.replica_idx for p in pend]
                         if pooled else None))
    want = {k: v * POOL_BASE_BATCHES for k, v in chain.items()}
    for run in runs:
        if run["launches"] != want or run["per_batch"] != [sum(chain.values())] * 4:
            fail(f"DistilBERT-base pool ({run['pooled']}): launches {run['launches']} / "
                 f"{run['per_batch']}")
        if run["rows"] != runs[0]["rows"]:
            fail(f"DistilBERT-base pool ({run['pooled']}): rows differ from the first "
                 f"unpooled run")
    print(f"DistilBERT-base pool: {POOL_BASE_BATCHES} batches of {BATCH} on replicas "
          f"{runs[1]['replicas']}, launches {runs[1]['launches']} ({runs[1]['per_batch']} "
          f"a batch), every row of every run bit-equal; host ms for the four, unpooled / "
          f"pooled / pooled / unpooled: "
          + " / ".join(f"{r['ms']:.1f}" for r in runs), flush=True)
    return runs[1]["launches"]


def run_pool_faults(ops, records, profiles, config):
    """Phase 21(b): the faults on a pool of 2 replicas on the card, each run
    against the same pool without the fault; the hot swap."""
    from realtime_fraud_detection_tpu_torch.chaos.faults import (
        ChaosPlan,
        DeviceReplicaDeath,
        FaultWindow,
        SlowDevice,
    )

    pair = ["cuda:0"] * 2
    # replica 0 dies mid-stream: the window pinned at 2, so the interleaving
    # does not follow the healthy count and the outputs are comparable
    base_job, base_broker, *_ = drive_pool_stream(records, profiles, config,
                                                  devices=pair, window=2)
    base = pool_rows("TINY pool 2 (fault-free, window 2)", base_job, base_broker, records)

    def death(pool):
        plan = ChaosPlan([FaultWindow("replica_death", "device", *POOL_FAULT_WINDOW)])
        plan.bind("replica_death", DeviceReplicaDeath(pool, 0))
        return plan

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    job, broker, scorer, timer, pool = drive_pool_stream(
        records, profiles, config, devices=pair, window=2, make_plan=death)
    torch.cuda.synchronize()
    death_launches = ops.launch_counts()
    rows = pool_rows("TINY pool 2 (replica 0 dies)", job, broker, records)
    st = pool.stats()
    n_batches = len(timer.batches)
    if rows != base:
        fail(f"replica death: {sum(a != b for a, b in zip(rows, base))} rows differ "
             f"from the fault-free run")
    if (st["retries"] != 1 or st["devices"][0]["failures"] != 1 or st["healthy"] != 2
            or death_launches["megakernel"] != n_batches + 1):
        fail(f"replica death: stats {st}, launches {death_launches}")
    print(f"replica death (batches {POOL_FAULT_WINDOW}): each of {len(rows)} ids once, "
          f"rows bit-equal to the fault-free run in its order, retries {st['retries']}, "
          f"failures {[d['failures'] for d in st['devices']]}, revived: healthy "
          f"{st['healthy']}; megakernel launches {death_launches['megakernel']} for "
          f"{n_batches} batches (one rescue relaunch)", flush=True)

    slow_base_job, slow_base_broker, *_ = drive_pool_stream(records, profiles, config,
                                                            devices=pair)
    slow_base = pool_rows("TINY pool 2 (fault-free)", slow_base_job, slow_base_broker,
                          records)
    def slow(pool):
        plan = ChaosPlan([FaultWindow("slow_device", "device", *POOL_SLOW_WINDOW)])
        plan.bind("slow_device", SlowDevice(pool, 0, POOL_SLOW_S, n=2))
        return plan

    t0 = time.perf_counter()
    job, broker, scorer, timer, pool = drive_pool_stream(
        records, profiles, config, devices=pair, make_plan=slow)
    slow_s = time.perf_counter() - t0
    rows = pool_rows("TINY pool 2 (replica 0 slowed)", job, broker, records)
    st = pool.stats()
    if rows != slow_base or st["retries"] or st["healthy"] != 2 \
            or pool.replicas[0].slow_next:
        fail(f"slow device: rows equal {rows == slow_base}, stats {st}")
    print(f"slow device ({POOL_SLOW_S * 1e3:.0f} ms on 2 fetches of replica 0): rows "
          f"bit-equal to the fault-free run in its order (FIFO), no retry, run "
          f"{slow_s:.2f} s", flush=True)
    swap = run_pool_swap(records)
    return {"tiny_pool_replica_death": death_launches}, swap


def run_pool_swap(records):
    """Phase 21(b), the hot swap: 4 replicas on the card, ``set_models`` at
    batch 8 of 16 with 8 batches in flight; each batch equals, wholly, the
    unpooled scorer on the old models or on the new ones."""
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.scoring.device_pool import DevicePool
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import init_scoring_models
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    gen = TransactionGenerator(num_users=STREAM_USERS, num_merchants=STREAM_MERCHANTS,
                               seed=SEED)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    batches = [records[i * BATCH:(i + 1) * BATCH] for i in range(2 * POOL_SWAP_BATCHES)]
    new_models = init_scoring_models(SEED + 1, TINY_CONFIG)

    def run(models, pooled, swap):
        scorer = TorchFraudScorer(Config(quant=QuantSettings.full(),
                                         kernels=KernelSettings.mega()),
                                  models=models, bert_config=TINY_CONFIG, device="cuda")
        scorer.seed_profiles(*profiles)
        window = DevicePool(scorer, devices=["cuda:0"] * 4).total_slots() if pooled \
            else 8
        out, inflight = [], []
        for i, b in enumerate(batches):
            if swap and i == POOL_SWAP_BATCHES:
                scorer.set_models(new_models)
            inflight.append(scorer.dispatch(b, now=STREAM_NOW))
            while len(inflight) >= window:
                out.append(scorer.finalize(inflight.pop(0), now=STREAM_NOW))
        while inflight:
            out.append(scorer.finalize(inflight.pop(0), now=STREAM_NOW))
        return [[(r["transaction_id"], r["fraud_score"], r["decision"]) for r in b]
                for b in out]

    old_ref = run(seeded_models(TINY_CONFIG), False, False)
    new_ref = run(new_models, False, False)
    got = run(seeded_models(TINY_CONFIG), True, True)
    old = sum(g == o for g, o in zip(got, old_ref))
    new = sum(g == n and g != o for g, n, o in zip(got, new_ref, old_ref))
    mixed = len(got) - old - new
    if mixed or not old or not new:
        fail(f"hot swap on the pool: {old} old, {new} new, {mixed} mixed batches")
    print(f"hot swap on 4 replicas (set_models before batch {POOL_SWAP_BATCHES} of "
          f"{len(got)}, 8 in flight): {old} batches wholly on the old models, {new} "
          f"wholly on the new ones, 0 mixed", flush=True)
    return dict(old=old, new=new, mixed=mixed)


def run_real_fleet(ops, profiles, config):
    """Phase 21(c): ``WorkerFleet`` of ``FLEET_WORKERS`` ``TorchFraudScorer``
    workers, each over its ``PartitionedStore``, on the card, on the shard
    drill's timeline (``cluster/drill.py run_fleet``) with ``WorkerKill`` at
    45%; the oracle is one unsharded scorer replaying the fleet's batches (its
    cuts) in the fleet's dispatch / completion order, the dead worker's lost
    batch left out. A handoff's state replay re-assembles the committed gap
    as one batch, so its history rows carry the velocity of that moment, not
    of the original scoring (both packages): after the kill, a replayed
    user's later rows may differ from the oracle's. Every other row is held
    to the drill's floor with its decision off the cuts, and every row
    beyond the floor must belong to a replayed user."""
    import dataclasses

    from realtime_fraud_detection_tpu_torch.cluster import drill
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer

    cfg = dataclasses.replace(drill.ShardDrillConfig(), seed=SEED, num_users=STREAM_USERS,
                              num_merchants=STREAM_MERCHANTS, n_txns=FLEET_TXNS,
                              replay_check=False)
    sched = drill.build_schedule(cfg)
    models = seeded_models(TINY_CONFIG)
    log, batches, replayed = [], [], set()

    def factory(worker_id, store):
        scorer = TorchFraudScorer(config, models=models, bert_config=TINY_CONFIG,
                                  device="cuda", stores=store)
        dispatch, finalize = scorer.dispatch, scorer.finalize

        def logged_dispatch(records, now=None, trace=None):
            snap0 = scorer.kernel_snapshot()
            pending = dispatch(records, now=now, trace=trace)
            snap = scorer.kernel_snapshot()
            log.append(("dispatch", id(pending), list(records), now))
            batches.append(dict(
                worker=worker_id, rows=len(records), launches=pending.kernel_launches,
                mega=snap["dispatch"]["megakernel"] - snap0["dispatch"]["megakernel"],
                fallback=snap["fallback"]["megakernel"] - snap0["fallback"]["megakernel"]))
            return pending

        def logged_finalize(pending, now=None, lock=None):
            log.append(("finalize", id(pending), None, now))
            return finalize(pending, now=now, lock=lock)

        replay = scorer.replay_state

        def logged_replay(records, now=None):
            replayed.update(str(r["user_id"]) for r in records)
            log.append(("replay", None, None, now))
            return replay(records, now=now)

        scorer.dispatch, scorer.finalize = logged_dispatch, logged_finalize
        scorer.replay_state = logged_replay
        return scorer

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = drill.run_fleet(cfg, sched, FLEET_WORKERS, kill=True, scorer_factory=factory,
                          store_kwargs={"seq_len": 10, "feature_dim": 64},
                          profiles=profiles)
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    scored = [p for p in out["preds"] if p[3] == "scored"]
    ids = [p[0] for p in scored]
    if sorted(ids) != sorted(t["transaction_id"] for _, t in sched) or len(set(ids)) != len(ids):
        fail(f"fleet: {len(ids)} scored rows, {len(set(ids))} ids, not each of "
             f"{len(sched)} once")
    fl = out["fleet"]
    if out["committed"] != out["tx_ends"] or out["affinity_violations"] or fl["kills"] != 1:
        fail(f"fleet: committed {out['committed']} of {out['tx_ends']}, affinity "
             f"violations {out['affinity_violations']}, kills {fl['kills']}")
    multi = [b for b in batches if b["rows"] >= 2]
    if any(b["launches"] != 1 or b["mega"] != 1 or b["fallback"] for b in multi):
        fail(f"fleet: a batch of 2+ rows did not run one megakernel launch: "
             f"{[b for b in multi if b['launches'] != 1][:3]}")
    done = {key for kind, key, _, _ in log if kind == "finalize"}
    lost = sum(1 for kind, key, _, _ in log if kind == "dispatch" and key not in done)
    oracle = TorchFraudScorer(config, models=models, bert_config=TINY_CONFIG, device="cuda")
    oracle.seed_profiles(*profiles)
    t1 = time.perf_counter()
    pending, want = {}, {}
    for kind, key, records, now in log:
        if kind == "dispatch" and key in done:
            pending[key] = oracle.dispatch(records, now=now)
        elif kind == "finalize":
            for r in oracle.finalize(pending.pop(key), now=now):
                want[r["transaction_id"]] = r
    oracle_s = time.perf_counter() - t1
    # rows a handoff's replay can reach: a replayed user's, dispatched after it
    first_replay = next(i for i, e in enumerate(log) if e[0] == "replay")
    reached = {str(r["transaction_id"]) for kind, _, records, _ in log[first_replay:]
               if kind == "dispatch" for r in records if str(r["user_id"]) in replayed}
    exact = [p for p in scored if p[0] not in reached]
    err = max(abs(score - want[tid]["fraud_score"]) for tid, score, _, _ in exact)
    prob = torch.tensor([want[tid]["fraud_probability"] for tid, *_ in exact],
                        dtype=torch.float64)
    conf = torch.tensor([want[tid]["confidence"] for tid, *_ in exact], dtype=torch.float64)
    far = ~(near_rung(prob, RUNGS, FLEET_TOL) | near_rung(conf, RUNGS, FLEET_TOL))
    for (tid, _, decision, _), ok in zip(exact, far.tolist()):
        if ok and decision != want[tid]["decision"]:
            fail(f"fleet: {tid} {decision} vs the oracle's {want[tid]['decision']}")
    if not err <= FLEET_TOL:
        fail(f"fleet: fraud_score err {err} vs the cut-replay oracle")
    rebuilt = [(abs(score - want[tid]["fraud_score"]), decision == want[tid]["decision"])
               for tid, score, decision, _ in scored if tid in reached]
    beyond = sum(e > FLEET_TOL for e, _ in rebuilt)
    per_worker = {}
    for b in batches:
        per_worker[b["worker"]] = per_worker.get(b["worker"], 0) + 1
    one_row = len(batches) - len(multi)
    print(f"fleet of {FLEET_WORKERS} TorchFraudScorer workers ({cfg.n_partitions} "
          f"partitions, {len(sched)} txns, {out['kill_target']} killed at "
          f"{cfg.kill_frac:.0%}): each id scored once, offsets gap free, affinity clean; "
          f"{len(batches)} batches ({json.dumps(per_worker)}; {lost} lost with the dead "
          f"worker), every batch of 2+ rows one megakernel launch ({one_row} one-row "
          f"batches: the counted fallback), launches {launches}; handoffs "
          f"{fl['handoffs_total']} partitions {out['moved_partitions']}, replay depth "
          f"{fl['replayed_total']} records, checkpoints {fl['checkpoints_total']}, "
          f"takeover {out['handoff_pause_s']} virtual s; against the oracle replaying "
          f"the fleet's cuts: {len(exact)} rows no replay reaches, fraud_score max err "
          f"{err:.3e}, decisions equal on {int(far.sum())} of them off the cuts; "
          f"{len(rebuilt)} rows of {len(replayed)} replayed users after the kill: "
          f"{beyond} beyond the floor (max err "
          f"{max((e for e, _ in rebuilt), default=0.0):.3e}), decisions equal on "
          f"{sum(ok for _, ok in rebuilt)}; fleet {fleet_s:.1f} s, oracle "
          f"{oracle_s:.1f} s", flush=True)
    return launches


def serve_proc(port, config_path, extra, log):
    """``serve --quant --mega`` on the card in a process of its own."""
    from pathlib import Path

    return subprocess.Popen(
        [sys.executable, "-m", "realtime_fraud_detection_tpu_torch", "serve", "--quant",
         "--mega", "--host", "127.0.0.1", "--port", str(port), "--config", config_path,
         *extra], cwd=Path(__file__).resolve().parent, stdout=log, stderr=subprocess.STDOUT)


def run_router(gen):
    """Phase 21(d): ``serve --device-pool`` with ``cluster.enabled`` as worker
    w0 of two, beside a plain ``serve``, both on the card: ``ROUTER_PREDICTS``
    ``/predict`` for distinct users w0 owns, one at a time to each, answer
    for answer equal; a foreign user's 421; ``/cluster``; the ``cluster_*``
    and ``device_pool_*`` series. Phase 22(c) on the same processes and
    worker w1 (a clustered ``serve`` too): ``ShardIngressClient`` with both
    workers' URLs sends ``ROUTER_PREDICTS`` ``/predict`` for fresh users of
    both workers, each answer equal to the plain service's, the 421s it
    followed printed; a second pass for the same users follows none (the
    learned affinity). SIGTERM, all exit 0."""
    import http.client
    import os
    import signal
    import tempfile
    import threading

    from realtime_fraud_detection_tpu_torch.cluster.hashring import (
        ShardRouter,
        partition_for_key,
    )
    from realtime_fraud_detection_tpu_torch.serving.ingress_client import (
        ShardIngressClient,
    )

    def call(port, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request(method, path, body=json.dumps(body) if body is not None else None,
                         headers={"Content-Type": "application/json"} if body else {})
            resp = conn.getresponse()
            raw = resp.read().decode()
        finally:
            conn.close()
        return resp.status, raw

    ports = {"clustered": free_port(), "plain": free_port(), "w1": free_port()}
    workers = {"w0": f"http://127.0.0.1:{ports['clustered']}",
               "w1": f"http://127.0.0.1:{ports['w1']}"}
    router = ShardRouter(12, sorted(workers))
    owned, foreign, fresh, seen = [], [], [], set()
    while len(owned) < ROUTER_PREDICTS or len(foreign) < 4 \
            or len(fresh) < ROUTER_PREDICTS:
        for t in gen.generate_batch(BATCH):
            uid = str(t["user_id"])
            if uid in seen:
                continue
            seen.add(uid)
            if router.route(uid) == "w0" and len(owned) < ROUTER_PREDICTS:
                owned.append(t)
            elif len(foreign) < 4 and router.route(uid) == "w1":
                foreign.append(t)
            else:
                fresh.append(t)
    owned, foreign, fresh = (owned[:ROUTER_PREDICTS], foreign[:4],
                             fresh[:ROUTER_PREDICTS])
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        configs = {
            "clustered": {"monitoring": {"prometheus_port": 0},
                          "cluster": {"enabled": True, "worker_id": "w0",
                                      "workers": workers}},
            "plain": {"monitoring": {"prometheus_port": 0}},
            "w1": {"monitoring": {"prometheus_port": 0},
                   "cluster": {"enabled": True, "worker_id": "w1",
                               "workers": workers}}}
        logs = {}
        t0 = time.perf_counter()
        try:
            for name, cfg in configs.items():
                path = os.path.join(tmp, f"{name}.json")
                with open(path, "w") as f:
                    json.dump(cfg, f)
                logs[name] = open(os.path.join(tmp, f"{name}.log"), "w")
                procs.append(serve_proc(ports[name], path,
                                        ["--device-pool"] if name == "clustered" else [],
                                        logs[name]))
            for name, proc in zip(configs, procs):
                while True:
                    try:
                        call(ports[name], "GET", "/health")
                        break
                    except OSError:
                        if proc.poll() is not None or time.perf_counter() - t0 > 300:
                            logs[name].flush()
                            fail(f"serve ({name}) did not come up (exit {proc.poll()}): "
                                 f"{open(logs[name].name).read()[-2000:]}")
                        time.sleep(0.25)
            t_up = time.perf_counter() - t0
            answers = {name: [] for name in ("clustered", "plain")}
            for name in ("clustered", "plain"):
                t1 = time.perf_counter()
                for t in owned:
                    status, raw = call(ports[name], "POST", "/predict", t)
                    if status != 200:
                        fail(f"serve ({name}): /predict {status} {raw[:300]}")
                    answers[name].append({k: v for k, v in json.loads(raw).items()
                                          if k != "processing_time_ms"})
                answers[name + "_s"] = time.perf_counter() - t1
            misdirected = [call(ports["clustered"], "POST", "/predict", t) for t in foreign]
            c_status, c_raw = call(ports["clustered"], "GET", "/cluster")
            m_status, m_text = call(ports["clustered"], "GET", "/metrics/prometheus")
            # the client waits as long as call() does: a request it re-sent
            # after a timeout would be scored twice, and the second answer
            # would see the first one's velocity and history
            ingress = ShardIngressClient([workers["w0"], workers["w1"]], timeout_s=60.0)
            passes = []
            for n_pass in range(2):
                t1 = time.perf_counter()
                txns = [dict(t, transaction_id=f"{t['transaction_id']}-p{n_pass}")
                        for t in fresh]
                got, want, hops, errors = [], [], [], []

                def plain_answers(batch):
                    try:
                        for txn in batch:
                            status, raw = call(ports["plain"], "POST", "/predict", txn)
                            if status != 200:
                                raise RuntimeError(f"/predict {status} {raw[:300]}")
                            want.append({k: v for k, v in json.loads(raw).items()
                                         if k != "processing_time_ms"})
                    except Exception as e:  # noqa: BLE001 -- failed below
                        errors.append(repr(e))

                # the first pass one request to each side in turn, the second
                # with the plain service's calls on a thread of their own:
                # the answers must not depend on how the two sides interleave
                plain = None
                if n_pass:
                    plain = threading.Thread(target=plain_answers, args=(txns,))
                    plain.start()
                for txn in txns:
                    res = ingress.predict(txn)
                    hops.append(res.pop("_ingress")["redirects"])
                    res.pop("processing_time_ms", None)
                    got.append(res)
                    if plain is None:
                        plain_answers([txn])
                if plain is not None:
                    plain.join(timeout=600)
                if errors or len(want) != len(txns):
                    fail(f"serve (plain): {errors[:1]}, {len(want)} of {len(txns)} answers")
                passes.append(dict(got=got, want=want, hops=hops,
                                   snapshot=ingress.snapshot(),
                                   s=time.perf_counter() - t1))
            for proc in procs:
                proc.send_signal(signal.SIGTERM)
            rcs = [proc.wait(timeout=60) for proc in procs]
        finally:
            _kill(procs)
            for log in logs.values():
                log.close()
    if answers["clustered"] != answers["plain"]:
        bad = sum(a != b for a, b in zip(answers["clustered"], answers["plain"]))
        fail(f"serve --device-pool (clustered): {bad} of {len(owned)} answers differ "
             f"from the plain service")
    for t, (status, raw) in zip(foreign, misdirected):
        body = json.loads(raw)
        uid = str(t["user_id"])
        want = {"error": "wrong_shard", "owner": "w1", "location": workers["w1"],
                "partition": partition_for_key(uid, 12)}
        if status != 421 or body != want:
            fail(f"router: a foreign user's /predict gave {status} {body}, want 421 {want}")
    cluster = json.loads(c_raw)
    if c_status != 200 or cluster.get("worker_id") != "w0" \
            or cluster.get("members") != ["w0", "w1"]:
        fail(f"router: /cluster {c_status} {c_raw[:300]}")
    dispatched = [float(ln.split()[-1]) for ln in m_text.splitlines()
                  if ln.startswith('device_pool_dispatched_total{device="cuda:0#0"}')]
    if (m_status != 200 or "cluster_workers_alive 2" not in m_text
            or 'cluster_partitions_owned{worker="w0"}' not in m_text
            or dispatched != [float(ROUTER_PREDICTS)] or any(rcs)):
        fail(f"router: metrics {m_status}, device_pool dispatched {dispatched}, "
             f"exits {rcs}")
    for n_pass, ps in enumerate(passes):
        if ps["got"] != ps["want"]:
            bad = [(a, b) for a, b in zip(ps["got"], ps["want"]) if a != b]
            a, b = bad[0]
            diff = {k: (a.get(k), b.get(k)) for k in set(a) | set(b) if a.get(k) != b.get(k)}
            fail(f"ingress client pass {n_pass}: {len(bad)} of {len(fresh)} answers "
                 f"differ from the plain service; the first: {json.dumps(diff)[:1500]}")
    if passes[1]["snapshot"]["retried"]:
        fail(f"ingress client: {passes[1]['snapshot']['retried']} requests re-sent; an "
             f"answer may be a second scoring")
    followed = passes[0]["snapshot"]["redirects_followed"]
    if sum(passes[0]["hops"]) != followed or followed < 1:
        fail(f"ingress client: {sum(passes[0]['hops'])} hops, {followed} followed")
    if any(passes[1]["hops"]) \
            or passes[1]["snapshot"]["redirects_followed"] != followed:
        fail(f"ingress client: the second pass followed "
             f"{passes[1]['snapshot']['redirects_followed'] - followed} 421s")
    owners = {w: sum(router.route(str(t["user_id"])) == w for t in fresh)
              for w in sorted(workers)}
    print(f"ingress client (phase 22c; ShardIngressClient over w0 and w1): "
          f"{len(fresh)} /predict for fresh users ({json.dumps(owners)} by owner), "
          f"each answer equal to the plain service's, {followed} 421s followed "
          f"({passes[0]['s']:.2f} s, one request to each side in turn); second pass on "
          f"the learned affinity, the plain service's calls on a thread of their own: 0 "
          f"followed, answers equal ({passes[1]['s']:.2f} s); none re-sent; client "
          f"{json.dumps(passes[1]['snapshot'])}",
          flush=True)
    print(f"router (serve --quant --mega --device-pool as w0 of 2, beside a plain serve; "
          f"up in {t_up:.1f} s): {len(owned)} /predict for w0's users answered alike by "
          f"both ({answers['clustered_s']:.2f} s / {answers['plain_s']:.2f} s one at a "
          f"time), {len(foreign)} foreign users 421 with owner, location and partition, "
          f"/cluster {cluster['assignment']}, cluster_* and device_pool_* series "
          f"present, SIGTERM exits {rcs}", flush=True)


def run_pool_phase(ops):
    """Phase 21: the device pool and the partition-parallel fleet (see the
    module docstring). Returns the launches by path."""
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    seconds = {}
    t0 = time.perf_counter()
    gen = TransactionGenerator(num_users=STREAM_USERS, num_merchants=STREAM_MERCHANTS,
                               seed=SEED)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    records = gen.generate_batch(16 * BATCH)
    config = Config(quant=QuantSettings.full(), kernels=KernelSettings.mega())
    drill = _port_proc(["pool-drill", "--devices", "4"])
    out, _, drill_s = _finish("pool-drill --devices 4", drill, timeout=600)
    verdict = json.loads(out.strip().splitlines()[-1])
    if not verdict["passed"]:
        fail(f"pool-drill --devices 4: {verdict}")
    print(f"pool-drill --devices 4 on the card ({drill_s:.1f} s): "
          + json.dumps(verdict), flush=True)
    launches, streams = run_pool_streams(ops, records[:POOL_STREAM_TXNS], profiles, config)
    launches["distilbert_base_pool_2"] = run_pool_distilbert(ops, records, profiles)
    seconds["a"] = round(time.perf_counter() - t0, 1)
    t1 = time.perf_counter()
    faults, swap = run_pool_faults(ops, records, profiles, config)
    launches.update(faults)
    seconds["b"] = round(time.perf_counter() - t1, 1)
    t2 = time.perf_counter()
    fleet_config = Config(quant=QuantSettings.full(), kernels=KernelSettings.mega())
    # the bipartite entity graph is scorer-local in both packages (only the
    # typed graph is partitioned): a worker's GNN sees only its own users'
    # edges and cannot equal one scorer's, so the fleet's blend leaves it out
    fleet_config.disable_model("graph_neural")
    launches["tiny_fleet"] = run_real_fleet(ops, profiles, fleet_config)
    seconds["c"] = round(time.perf_counter() - t2, 1)
    t3 = time.perf_counter()
    run_router(TransactionGenerator(num_users=STREAM_USERS, num_merchants=STREAM_MERCHANTS,
                                    seed=SEED + 21))
    seconds["d"] = round(time.perf_counter() - t3, 1)
    seconds["total"] = round(time.perf_counter() - t0, 1)
    print(f"pool and fleet phase seconds by part: {json.dumps(seconds)}; TINY pooled "
          f"streams: {json.dumps(streams)}; hot swap {json.dumps(swap)}", flush=True)
    return launches


# the process fleet and chaos phase (22): the chaos drill's fast timeline on
# two pool replicas of the card, as a command and twice in process (kernels
# off, then the megakernel and the epilogue on); then, with nothing else
# running, the elastic and partition drills' fast timelines, whose worker
# processes score on the card's host; part (c), the shard ingress client,
# runs inside phase 21(d)'s serve processes (run_router)


def drill_on_host(name, args, out):
    """``args`` as a command while ``nvidia-smi`` lists the card's compute
    processes every 0.5 s and /proc names the drill's worker processes;
    ``out[name]`` gets the verdict, the full summary, the worker pids seen,
    the compute-app pids seen and the seconds."""
    import os
    import tempfile
    from pathlib import Path

    # output to files: a pipe nobody reads while the drill runs could fill
    # and stall it
    stdout_f, stderr_f = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "realtime_fraud_detection_tpu_torch", *args],
        cwd=Path(__file__).resolve().parent, stdout=stdout_f, stderr=stderr_f, text=True)
    workers, on_card, card_visible = set(), set(), set()
    most_apps = 0
    t0 = time.perf_counter()
    while proc.poll() is None:
        for pid in os.listdir("/proc"):
            if not pid.isdigit():
                continue
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read()
            except OSError:
                continue
            if b"cluster-worker" in cmd:
                workers.add(int(pid))
                try:
                    with open(f"/proc/{pid}/environ", "rb") as f:
                        env = f.read()
                except OSError:
                    continue
                # a process that exits between the two reads (a killed
                # worker) has no memory left and its environ reads empty:
                # that says nothing of how it was spawned
                if env and b"CUDA_VISIBLE_DEVICES=" not in env.split(b"\0"):
                    card_visible.add(int(pid))
        smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                              "--format=csv,noheader"], capture_output=True, text=True)
        if smi.returncode != 0:
            out[name] = {"error": f"nvidia-smi exit {smi.returncode}: {smi.stderr}"}
            proc.kill()
            proc.wait()
            return
        apps = [int(x) for x in smi.stdout.split() if x.strip().isdigit()]
        on_card.update(apps)
        most_apps = max(most_apps, len(apps))
        if time.perf_counter() - t0 > 420:
            proc.kill()
            proc.wait()
            out[name] = {"error": "still running after 420 s"}
            return
        time.sleep(0.5)
    stdout_f.seek(0)
    stderr_f.seek(0)
    stdout, stderr = stdout_f.read(), stderr_f.read()
    stdout_f.close()
    stderr_f.close()
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    out[name] = {"rc": proc.returncode, "stderr": stderr[-3000:],
                 "verdict": json.loads(lines[-1]) if lines else None,
                 "full": json.loads(lines[-2]) if len(lines) > 1 else None,
                 "workers": workers, "on_card": on_card, "most_apps": most_apps,
                 "card_visible": card_visible,
                 "s": time.perf_counter() - t0}


def check_host_drill(name, res, must):
    """The drill passed with every check (``must`` among them) and no worker
    pid was ever a compute process on the card."""
    if "error" in res:
        fail(f"{name}: {res['error']}")
    full = res["full"] or {}
    checks = full.get("checks") or {}
    if res["rc"] != 0 or not full.get("passed") or not all(checks.values()) \
            or not all(checks.get(k) for k in must):
        fail(f"{name}: exit {res['rc']}, checks {checks}: {res['stderr']}")
    if not res["workers"]:
        fail(f"{name}: no cluster-worker process seen while it ran")
    # the card's host may report every compute process under one pid, so the
    # count of processes at once is checked too: this process alone (a worker
    # imports torch, so the CUDA driver library is mapped in it: that says
    # nothing)
    if res["workers"] & res["on_card"] or res["card_visible"] \
            or res["most_apps"] > 1:
        fail(f"{name}: worker pids {sorted(res['workers'] & res['on_card'])} among the "
             f"card's compute processes, {sorted(res['card_visible'])} not spawned with "
             f"CUDA_VISIBLE_DEVICES empty, at most {res['most_apps']} compute processes "
             f"at once")
    print(f"{name} ({res['s']:.1f} s, its worker processes on the card's host): "
          f"every check passes ({len(checks)}); {len(res['workers'])} worker pids seen, "
          f"none among the card's compute processes (pids seen {sorted(res['on_card'])}, "
          f"at most {res['most_apps']} at once), each spawned with "
          f"CUDA_VISIBLE_DEVICES empty; "
          + json.dumps(res["verdict"]), flush=True)


def chaos_spy(batches):
    """Wrap ``TorchFraudScorer.dispatch_assembled`` (the chaos and graph
    drills build their scorers inside): per batch its rows, whether the
    megakernel's plan took it (the scorer's dispatch minus fallback counts)
    or declined it, the megakernel and epilogue launches, and the launching
    thread's total. The drills dispatch from one thread. Returns the
    function that undoes it."""
    from realtime_fraud_detection_tpu_torch import ops
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer

    orig = TorchFraudScorer.dispatch_assembled

    def spy(self, batch, records, *args, **kw):
        snap0, counts0, t0 = self.kernel_snapshot(), ops.launch_counts(), ops.thread_launches()
        out = orig(self, batch, records, *args, **kw)
        snap, counts = self.kernel_snapshot(), ops.launch_counts()
        declined = snap["fallback"]["megakernel"] - snap0["fallback"]["megakernel"]
        batches.append(dict(
            rows=len(records),
            served=(snap["dispatch"]["megakernel"] - snap0["dispatch"]["megakernel"])
            - declined, declined=declined,
            launches=ops.thread_launches() - t0,
            megakernel=counts["megakernel"] - counts0["megakernel"],
            epilogue=counts["epilogue"] - counts0["epilogue"]))
        return out

    TorchFraudScorer.dispatch_assembled = spy
    return lambda: setattr(TorchFraudScorer, "dispatch_assembled", orig)


# phase 22(a)'s kernels-off run of the chaos drill's fast timeline, in a
# process of its own beside the command and the in-process kernels-on run:
# its summary (ledger included) and that process's hand-written launches go
# to the file named by the first argument
CHAOS_OFF_RUN = """
import dataclasses, json, sys, time
from realtime_fraud_detection_tpu_torch import ops
from realtime_fraud_detection_tpu_torch.chaos.drill import (
    ChaosDrillConfig, run_chaos_drill)
t0 = time.perf_counter()
summary = run_chaos_drill(dataclasses.replace(ChaosDrillConfig.fast(),
                                              replay_check=False))
with open(sys.argv[1], "w") as f:
    json.dump({"summary": summary, "launches": ops.launch_counts(),
               "s": time.perf_counter() - t0}, f)
"""


def run_chaos_phase(ops):
    """Phase 22 (a), then (b) once (a) has ended; see the module docstring.
    Returns the launches of the kernels-on chaos run."""
    import dataclasses

    from realtime_fraud_detection_tpu_torch.chaos.drill import (
        ChaosDrillConfig,
        compact_chaos_summary,
        run_chaos_drill,
    )
    from realtime_fraud_detection_tpu_torch.utils.config import KernelSettings

    import tempfile

    t0 = time.perf_counter()
    # three runs of the fast timeline at once: the command (once), the
    # kernels-off run in a process of its own (the command's replay, a
    # second fully fresh run held to the same digest, and the reference of
    # the decisions) and the kernels-on run in this process
    command = _port_proc(["chaos-drill", "--fast", "--no-replay"])
    with tempfile.TemporaryDirectory() as tmp:
        off_path = f"{tmp}/off.json"
        off_proc = _python_proc(CHAOS_OFF_RUN, off_path, cpu=False)
        cfg = dataclasses.replace(ChaosDrillConfig.fast(), replay_check=False)
        batches = []
        undo = chaos_spy(batches)
        t1 = time.perf_counter()
        ops.reset_launch_counts()
        try:
            summary = run_chaos_drill(cfg, kernels=KernelSettings(
                enabled=True, megakernel="cuda", epilogue="cuda"))
        finally:
            launches = ops.launch_counts()
            undo()
        on = dict(summary=summary, batches=batches, launches=launches,
                  s=time.perf_counter() - t1)
        _, _, off_wait = _finish("chaos drill (kernels off, its own process)", off_proc,
                                 timeout=600)
        with open(off_path) as f:
            off = json.load(f)
    for name, run in (("off", off), ("on", on)):
        if not run["summary"]["passed"]:
            fail(f"chaos drill (kernels {name}): {compact_chaos_summary(run['summary'])}")
    out, err, cmd_s = _finish("chaos-drill --fast --no-replay", command, timeout=600)
    lines = [ln for ln in out.splitlines() if ln.strip()]
    full = json.loads(lines[-2])
    if not full["passed"] or full["digest"] != off["summary"]["digest"]:
        fail(f"chaos-drill --fast on the card: digest {full['digest']} against the "
             f"kernels-off replay's {off['summary']['digest']}; {lines[-1]}")
    print(f"chaos-drill --fast --no-replay as a command (2 replicas on the card; "
          f"{cmd_s:.1f} s waited after the in-process run): every check passes, its "
          f"digest bit-identical to the kernels-off run's (the replay); "
          + lines[-1], flush=True)

    # the kernels-on run: one megakernel launch a batch of 2+ rows, one
    # epilogue launch a batch the plan declines, nothing else
    for b in on["batches"]:
        want = (dict(megakernel=1, epilogue=0) if b["served"]
                else dict(megakernel=0, epilogue=1))
        if b["rows"] >= 2 and not b["served"] or b["launches"] != 1 \
                or {k: b[k] for k in want} != want:
            fail(f"chaos drill (kernels on): batch {b} launched other than one "
                 f"megakernel (2+ rows) or one epilogue (declined)")
    pool = on["summary"]["pool"]
    n_served = sum(b["served"] for b in on["batches"])
    n_declined = len(on["batches"]) - n_served
    if on["launches"]["megakernel"] + on["launches"]["epilogue"] \
            != len(on["batches"]) + pool["retries"] or on["launches"]["flash_attention"] \
            or on["launches"]["dequant_matmul"] or on["launches"]["dequant_rows"]:
        fail(f"chaos drill (kernels on): launches {on['launches']} for "
             f"{len(on['batches'])} batches and {pool['retries']} rescues")
    if any(off["launches"].values()):
        fail(f"chaos drill (kernels off) launched {off['launches']}")

    # decisions equal on every id scored before the first promotion
    cut = min(t for t in (on["summary"]["first_promotion_ts"],
                          off["summary"]["first_promotion_ts"], float("inf"))
              if t is not None)

    def scored(summary):
        rows = {}
        for tid, score, decision, kind, at in summary["ledger"]:
            if kind == "scored" and tid not in rows:
                rows[tid] = (score, decision, at)
        return rows

    got, want = scored(on["summary"]), scored(off["summary"])
    if set(got) != set(want):
        fail(f"chaos drill: kernels on scored {len(got)} ids, off {len(want)}")
    before = [t for t in want if want[t][2] is not None and want[t][2] < cut
              and got[t][2] is not None and got[t][2] < cut]
    flips = [t for t in before if got[t][1] != want[t][1]]
    if flips or not before:
        fail(f"chaos drill: {len(flips)} decisions of {len(before)} ids scored before "
             f"the first promotion differ with the kernels on")
    after = [t for t in want if t not in set(before)]
    gap_before = max(abs(got[t][0] - want[t][0]) for t in before)
    gap_after = max((abs(got[t][0] - want[t][0]) for t in after), default=0.0)
    flips_after = sum(got[t][1] != want[t][1] for t in after)
    a_s = time.perf_counter() - t0
    print(f"chaos drill, 2 replicas on the card, kernels off (its own process, "
          f"{off['s']:.1f} s, {off_wait:.1f} s waited after the kernels-on run) and on "
          f"(in process, {on['s']:.1f} s): every check passes in both; kernels on "
          f"{len(on['batches'])} batches of {min(b['rows'] for b in on['batches'])}-"
          f"{max(b['rows'] for b in on['batches'])} rows, {n_served} one megakernel "
          f"launch each "
          f"(every batch of 2+ rows), {n_declined} declined one epilogue launch each, "
          f"{pool['retries']} rescue relaunch; launches {json.dumps(on['launches'])}; "
          f"{len(before)} ids scored before the first promotion (t={cut:.3f} virtual s): "
          f"decisions equal, largest score gap {gap_before:.3e}; after it (not gated): "
          f"{flips_after} decision flips of {len(after)}, largest score gap "
          f"{gap_after:.3e}; phase 22 (a) {a_s:.1f} s", flush=True)

    # (b) each host drill alone: its wall-clock checks (processes_enough, the
    # session timeouts) are held with nothing else running
    results = {}
    for name, must in (("elastic-drill", ("processes_enough", "sigkill_real")),
                       ("partition-drill", ("processes_real", "zombie_fenced_produce"))):
        drill_on_host(f"{name} --fast", [name, "--fast"], results)
        check_host_drill(f"{name} --fast", results[f"{name} --fast"], must)
    print(f"phase 22 (b) {time.perf_counter() - t0 - a_s:.1f} s", flush=True)
    return {"tiny_chaos_kernels_on": {k: on["launches"].get(k, 0) for k in (
        "epilogue", "flash_attention", "dequant_matmul", "dequant_rows", "megakernel")}}


# the graph phase (23): the port's own CPU verdict of `graph-drill --fast
# --device cpu`, which tests/test_torch_graph_drill.py pins with this dict:
# every check true, healthy_not_regressed included (JAX's drill, from other
# initial GNN weights, fails that one; ROADMAP C.1)
GRAPH_CPU_CHECKS = {
    "workers_enough": True, "ring_straddles_shards": True, "zero_lost": True,
    "every_txn_scored_once": True, "zero_errors": True, "offsets_gap_free": True,
    "remote_fetch_exercised": True, "degrade_exercised_in_window": True,
    "no_degrade_before_window": True, "partition_refusals_counted": True,
    "ring_auc_lift": True, "healthy_not_regressed": True,
    "columnar_serial_bitexact": True, "replay_bit_identical": True,
}
GRAPH_TOL = 1e-4                         # the drill's bf16 floor
# the obs drill's checks that read the wall clock: the one retry JAX's test
# allows is taken only when nothing else failed
OBS_WALL_CLOCK_CHECKS = {"overhead_bounded", "slow_worker_attributed"}


def graph_fleet_facts(out):
    """Remote fetches, nodes fetched and degraded batches in and before the
    netfault window of one ``_run_fleet`` result."""
    return dict(fetches=sum(s["remote_fetch_total"] for s in out["fetch"].values()),
                nodes=sum(s["fetched_nodes_total"] for s in out["fetch"].values()),
                in_window=out["degraded_in_window"],
                before=out["degraded_pre_window"] or 0)


def run_graph_fleets(ops):
    """Phase 23 (b): the drill's models trained on the card, then its fleet
    in process with the kernels off and on. Returns the kernels-on run's
    launches."""
    import dataclasses

    from realtime_fraud_detection_tpu_torch.graph import drill as gdrill
    from realtime_fraud_detection_tpu_torch.utils.config import KernelSettings

    t0 = time.perf_counter()
    cfg = dataclasses.replace(gdrill.GraphDrillConfig.fast(), replay_check=False)
    models, bert_config = gdrill._train_models(cfg)
    train_s = time.perf_counter() - t0
    sched, _truth, _ring, profiles = gdrill._build_schedule(cfg)
    runs = {}
    for name, kernels in (("off", None),
                          ("on", KernelSettings(enabled=True, epilogue="cuda",
                                                megakernel="cuda"))):
        batches = []
        undo = chaos_spy(batches)
        t1 = time.perf_counter()
        ops.reset_launch_counts()
        thread0 = ops.thread_launches()
        try:
            out = gdrill._run_fleet(cfg, sched, profiles, models, bert_config,
                                    kernels=kernels)
        finally:
            launches = ops.launch_counts()
            thread = ops.thread_launches() - thread0
            undo()
        runs[name] = dict(out=out, batches=batches, launches=launches, thread=thread,
                          s=time.perf_counter() - t1)
        facts = graph_fleet_facts(out)
        if not (facts["fetches"] > 0 and facts["nodes"] > 0 and facts["in_window"] > 0
                and facts["before"] == 0) or out["counters"]["errors"] \
                or out["committed"] != out["tx_ends"]:
            fail(f"graph drill fleet (kernels {name}): {json.dumps(facts)}, counters "
                 f"{out['counters']}")
    on, off = runs["on"], runs["off"]
    n = len(on["batches"])
    for b in on["batches"]:
        if b["launches"] != 1 or b["epilogue"] != 1 or b["megakernel"] != 0 \
                or b["served"] or b["declined"] != 1:
            fail(f"graph drill fleet (kernels on): batch {b} launched other than one "
                 f"epilogue with the megakernel declined once")
    if on["launches"]["epilogue"] != n or on["thread"] != n or any(
            on["launches"][k] for k in ("megakernel", "flash_attention",
                                        "dequant_matmul", "dequant_rows")):
        fail(f"graph drill fleet (kernels on): launches {on['launches']} (thread "
             f"{on['thread']}) for {n} batches")
    if off["thread"] or any(off["launches"].values()):
        fail(f"graph drill fleet (kernels off) launched {off['launches']}")

    def scored(out):
        return {t: s for t, s, _tr, _g, k in out["preds"] if k == "scored"}

    got, want = scored(on["out"]), scored(off["out"])
    if set(got) != set(want) or set(on["out"]["decisions"]) != set(want):
        fail(f"graph drill fleet: kernels on scored {len(got)} ids, off {len(want)}")
    ids = sorted(want)
    ref = torch.tensor([want[t] for t in ids], dtype=torch.float64)
    gaps = (torch.tensor([got[t] for t in ids], dtype=torch.float64) - ref).abs()
    near = near_rung(ref, RUNGS, GRAPH_TOL)
    flips = [t for t, nr in zip(ids, near.tolist()) if not nr
             and on["out"]["decisions"][t] != off["out"]["decisions"][t]]
    if flips or float(gaps.max()) > GRAPH_TOL:
        fail(f"graph drill fleet: {len(flips)} decisions flip off a rung, largest score "
             f"gap {float(gaps.max()):.3e} (bound {GRAPH_TOL})")
    near_rows = [(t, want[t], got[t], off["out"]["decisions"][t],
                  on["out"]["decisions"][t]) for t, nr in zip(ids, near.tolist()) if nr]
    print(f"graph drill fleet in process (models trained on the card in {train_s:.1f} s), "
          f"kernels off ({off['s']:.1f} s) and on ({on['s']:.1f} s): {len(ids)} ids, "
          f"{n} batches of {min(b['rows'] for b in on['batches'])}-"
          f"{max(b['rows'] for b in on['batches'])} rows, each one epilogue launch and "
          f"the megakernel declined once; launches {json.dumps(on['launches'])} "
          f"(thread {on['thread']}); decisions equal on {len(ids) - len(near_rows)} ids "
          f"off a rung, largest score gap {float(gaps.max()):.3e}; rows near a rung "
          f"(id, off, on, decisions): {json.dumps(near_rows)}; fetch and degrade off "
          f"{json.dumps(graph_fleet_facts(off['out']))}, on "
          f"{json.dumps(graph_fleet_facts(on['out']))}", flush=True)
    return on["launches"]


def check_graph_command(command):
    """Phase 23 (a): the ``graph-drill --fast`` command's verdict against the
    port's CPU verdict."""
    stdout, err, cmd_s = _finish("graph-drill --fast", command, timeout=600)
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    full = json.loads(lines[-2])
    if full["checks"] != GRAPH_CPU_CHECKS or not full["passed"] \
            or full["replay_identical"] is not True:
        fail(f"graph-drill --fast on the card: checks {full['checks']} against the CPU's "
             f"{GRAPH_CPU_CHECKS}; {lines[-1]}")
    auc = full["auc"]
    print(f"graph-drill --fast as a command on the card (beside (b); {cmd_s:.1f} s "
          f"waited after it): "
          f"every check as on the CPU, the replay bit-identical; ring lift "
          f"{auc['ring_phase_lift']} (graph on {auc['ring']['graph_on']}, trees "
          f"{auc['ring']['incumbent_trees']}); healthy graph on "
          f"{auc['healthy']['graph_on']} against trees {auc['healthy']['incumbent_trees']}; "
          f"{full['remote_fetches']} remote fetches of {full['remote_nodes']} nodes; "
          f"degraded {full['degraded_in_window']} in the window, "
          f"{full['degraded_pre_window']} before it; makespan {full['makespan_s']} "
          f"virtual s; " + lines[-1], flush=True)


def run_graph_phase(ops):
    """Phase 23 (a) beside (b), then (c) alone; see the module docstring.
    Returns the launches of the kernels-on fleet run."""
    import glob
    import os
    import tempfile

    t0 = time.perf_counter()
    command = _port_proc(["graph-drill", "--fast"])
    try:
        launches = run_graph_fleets(ops)
        check_graph_command(command)
    finally:
        _kill([command])
    ab_s = time.perf_counter() - t0

    # (c) the obs drill alone: its overhead ratio and p99 attribution read
    # the wall clock
    with tempfile.TemporaryDirectory() as rings:
        name = "obs-drill --fast --no-replay"
        args = ["obs-drill", "--fast", "--no-replay", "--rings-out", rings]
        results = {}
        drill_on_host(name, args, results)
        res = results[name]
        failed = sorted(k for k, v in ((res.get("full") or {}).get("checks") or {}).items()
                        if not v)
        retried = None
        if "error" not in res and res["rc"] != 0 and failed \
                and set(failed) <= OBS_WALL_CLOCK_CHECKS:
            retried = failed
            print(f"{name}: retried once after the wall-clock checks {failed} failed "
                  f"({res['s']:.1f} s): {json.dumps(res['verdict'])}", flush=True)
            drill_on_host(name, args, results)
            res = results[name]
        check_host_drill(name, res, ("processes_real", "remote_fetch_spans",
                                     "export_tracks_and_flows"))
        full = res["full"]
        print(f"{name}: retried {retried}; overhead ratio "
              f"{full['wall']['overhead_ratio']} (traced {full['wall']['makespan_traced_s']}"
              f" s, untraced {full['wall']['makespan_untraced_s']} s); p99 dominant "
              f"{json.dumps(full['breakdown_p99'].get('dominant_worker'))} / "
              f"{json.dumps(full['breakdown_p99'].get('dominant_stage'))}", flush=True)
        merged = os.path.join(rings, "merged.json")
        t2 = time.perf_counter()
        merge = subprocess.run(
            [sys.executable, "-m", "realtime_fraud_detection_tpu_torch", "trace-export",
             "--merge", *sorted(glob.glob(os.path.join(rings, "ring_*.json"))),
             "--out", merged], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if merge.returncode != 0:
            fail(f"trace-export --merge: exit {merge.returncode}: {merge.stderr[-2000:]}")
        with open(merged) as f:
            events = json.load(f)["traceEvents"]
        tracks = [e["args"]["name"] for e in events if e.get("ph") == "M"]
        flows = sum(e.get("ph") == "s" for e in events)
        workers = [t for t in tracks if t.startswith("worker ")]
        if len(workers) != full["n_workers"] or len(tracks) != full["n_workers"] + 1 \
                or "ingress ingress" not in tracks or flows != full["flow_arrows"] \
                or not flows:
            fail(f"trace-export --merge: tracks {tracks}, {flows} flow starts against the "
                 f"drill's {full['flow_arrows']}")
        print(f"trace-export --merge of the drill's rings ({time.perf_counter() - t2:.1f} "
              f"s): tracks {json.dumps(tracks)}, {flows} flow starts as the drill's "
              f"flow_arrows; " + merge.stdout.strip(), flush=True)
    print(f"phase 23 (a) and (b) {ab_s:.1f} s, (c) {time.perf_counter() - t0 - ab_s:.1f} s",
          flush=True)
    return {"graph_drill_kernels_on": {k: launches.get(k, 0) for k in (
        "epilogue", "flash_attention", "dequant_matmul", "dequant_rows", "megakernel")}}


MESH_DEVICES = ["cuda:0"] * 8            # 8 positions on the card: data 4 x model 2
# (kernels, batch, replay): bucket 256 over data 4, 64-row shards against the
# 256-row reference
MESH_DRILL_RUNS = (("off", 256, False), ("full", 256, False), ("mega", 256, True))
MESH_SERVE_BATCHES = 4
MESH_USERS, MESH_MERCHANTS = 10_000, 5_000
ENCODER_TOL = 2e-3                       # a bf16 step of a TINY hidden state


def run_mesh_drills(ops):
    """Phase 24(a): the mesh drill in process on ``MESH_DEVICES``, every
    check of every run, the BERT bytes a position stores, each combo's
    launches a mesh batch against its data axis times the single-position
    reference's; launch counters reset just before each run, read just
    after."""
    import dataclasses

    from realtime_fraud_detection_tpu_torch.scoring.mesh_drill import (
        MeshDrillConfig,
        compact_mesh_summary,
        run_mesh_drill,
    )

    want_kernels = {"off": set(), "full": {"epilogue", "flash_attention", "dequant_matmul",
                                           "dequant_rows"}, "mega": {"megakernel"}}
    launches = {}
    for kernels, batch, replay in MESH_DRILL_RUNS:
        name = f"mesh-drill --kernels {kernels} --batch {batch}"
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        summary = run_mesh_drill(dataclasses.replace(
            MeshDrillConfig.fast(), device="cuda", kernels=kernels, batch=batch,
            replay_check=replay))
        torch.cuda.synchronize()
        got = ops.launch_counts()
        secs = time.perf_counter() - t0
        bad = sorted(k for k, v in summary["checks"].items() if not v)
        if bad or not summary["passed"]:
            diffs = {n: p.get("first_difference") for n, p in summary["placements"].items()
                     if p.get("rows_differing")}
            fail(f"{name}: checks {bad} failed; rows differing "
                 f"{ {n: p.get('rows_differing') for n, p in summary['placements'].items()} }, "
                 f"first differences {json.dumps(diffs)}")
        per_batch = {}
        for combo, p in summary["placements"].items():
            data = len(MESH_DEVICES) // 2 // p["replicas"]
            mesh, single = p["launches_per_batch"]["mesh"], p["launches_per_batch"]["single"]
            if any(mesh[k] != data * single[k] for k in single):
                fail(f"{name} {combo}: launches a mesh batch {mesh}, not {data} x the "
                     f"single position's {single}")
            per_batch[combo] = {k: v for k, v in mesh.items() if v}
        ran = {k for k, v in got.items() if v}
        if ran != want_kernels[kernels]:
            fail(f"{name}: kernels launched {got}, expected {sorted(want_kernels[kernels])}")
        if kernels != "off":
            launches[f"mesh_drill_{kernels}"] = got
        print(f"{name} ({secs:.1f} s): {json.dumps(compact_mesh_summary(summary))}; "
              f"launches a mesh batch {json.dumps(per_batch)}; megakernel shards "
              f"{json.dumps({c: p['mega_shards'] for c, p in summary['placements'].items()})}",
              flush=True)
    return launches


def mesh_kernel_parity(ops):
    """Phase 24(a): each kernel against its plain version on the mesh path:
    one seeded bucket-256 TINY int8 batch through a mesh-attached scorer
    with the kernels (``full()``, then ``mega()``) and with none; the
    scores within the drill's noise bound, decisions equal off a rung, the
    kernels' mesh output bit-equal to one position's, and the launches 4 x
    one position's."""
    import numpy as np

    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.scoring.mesh_executor import MeshExecutor
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
        ScorerConfig,
        make_example_batch,
    )
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    batch = make_example_batch(BATCH, ScorerConfig(), rng=np.random.default_rng(SEED))

    def run(kernels, mesh):
        scorer = TorchFraudScorer(Config(quant=QuantSettings.full(), kernels=kernels),
                                  models=seeded_models(TINY_CONFIG),
                                  bert_config=TINY_CONFIG, device="cuda")
        if mesh:
            MeshExecutor(scorer, devices=MESH_DEVICES, model_axis=2,
                         shard_branches=("bert_text", "graph_neural", "lstm_sequential"))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        pending = scorer.dispatch_assembled(batch, [{}] * BATCH)
        scorer.finalize(pending)
        torch.cuda.synchronize()
        return scorer, pending.out.clone(), ops.launch_counts()

    plain_scorer, plain, none = run(KernelSettings(), True)
    if any(none.values()):
        fail(f"mesh path, kernels off: launches {none}")
    tol = noise_bound(plain_scorer.models, TINY_CONFIG, [(batch.token_ids, batch.token_mask)],
                      plain_scorer.ensemble_params.weights)
    cols = [0, 1, 4] + list(range(8, 13))     # probability, confidence, rule, branches
    out = {}
    for label, kernels in (("full", KernelSettings.full()), ("mega", KernelSettings.mega())):
        _, meshed, mesh_l = run(kernels, True)
        _, single, single_l = run(kernels, False)
        err = float((meshed[:, cols] - plain[:, cols]).abs().max())
        near = near_rung(plain[:, 0], RUNGS, tol) | near_rung(plain[:, 1], RUNGS, tol)
        flips = int(((meshed[:, 2] != plain[:, 2]) & ~near).sum())
        if err > tol or flips:
            fail(f"mesh path {label}: max err {err:.3e} against the plain version "
                 f"(bound {tol:.3e}), {flips} decision flips off a rung")
        if not torch.equal(meshed, single):
            fail(f"mesh path {label}: the mesh's output is not one position's bit for bit")
        if {k: 4 * v for k, v in single_l.items()} != mesh_l or not any(mesh_l.values()):
            fail(f"mesh path {label}: launches {mesh_l}, one position {single_l}")
        out[label] = dict(max_abs_err=err, bound=tol, skipped_near_rung=int(near.sum()),
                          launches=mesh_l, single=single_l)
    print(f"mesh path against the plain version (TINY int8, bucket {BATCH}, 8 positions "
          f"data 4 x model 2, every neural branch stored split): " + json.dumps(out),
          flush=True)


def mesh_app(meshed, profiles):
    """A DistilBERT-base ``ServingApp`` (int8 BERT, ``full()``), with
    ``mesh.enabled`` over ``MESH_DEVICES`` (data 4 x model 2, BERT stored
    split) when ``meshed``."""
    from realtime_fraud_detection_tpu_torch.models.bert import DISTILBERT_BASE
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.serving.app import ServingApp
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    config = Config(quant=QuantSettings.full(), kernels=KernelSettings.full())
    config.serving.max_concurrent_predictions = BATCH
    config.serving.prediction_timeout_seconds = 60.0
    config.monitoring.prometheus_port = 0
    if meshed:
        config.mesh.enabled = True
        config.mesh.data, config.mesh.model = 4, 2
        config.mesh.shard_branches = ["bert_text"]
    scorer = TorchFraudScorer(config, models=seeded_models(DISTILBERT_BASE),
                              bert_config=DISTILBERT_BASE, device="cuda")
    scorer.seed_profiles(*profiles)
    return ServingApp(config, scorer=scorer, host="127.0.0.1", port=0, device="cuda")


def run_mesh_serving(ops, gen):
    """Phase 24(b), in ``MESH_CHILD`` (split-K off for both sides): after
    an untimed warm-up batch through each kind of app,
    ``MESH_SERVE_BATCHES`` ``/batch-predict`` of 256 through the
    DistilBERT-base service, unmeshed and meshed in turns (unmeshed, meshed,
    meshed, unmeshed): the meshed answers' decisions and scores equal to the
    unmeshed ones', the launches a batch 4 x the unmeshed chain's; txn/s and
    batch p50 / p99 at the client."""
    import numpy as np

    from realtime_fraud_detection_tpu_torch.models.bert import DISTILBERT_BASE

    profiles = (gen.users.profiles(), gen.merchants.profiles())
    bodies = [gen.generate_batch(BATCH) for _ in range(MESH_SERVE_BATCHES)]
    chain = {"epilogue": 1, "flash_attention": DISTILBERT_BASE.num_layers,
             "dequant_matmul": 6 * DISTILBERT_BASE.num_layers, "dequant_rows": 2}
    # one untimed batch through each kind of app first (its answers unused):
    # this process's first products and kernel loads
    warm = gen.generate_batch(BATCH)
    for meshed in (False, True):
        with AppThread(mesh_app(meshed, profiles)) as srv:
            if srv.request("POST", "/batch-predict", warm)[0] != 200:
                fail(f"mesh serving ({meshed}): the warm-up batch failed")
    runs, launches = [], None
    for meshed in (False, True, True, False):
        app = mesh_app(meshed, profiles)
        batches = []
        dispatch_spy(app.scorer, ops, batches)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        lat, answers = [], {}
        with AppThread(app) as srv:
            t0 = time.perf_counter()
            for body in bodies:
                t = time.perf_counter()
                status, data = srv.request("POST", "/batch-predict", body)
                lat.append((time.perf_counter() - t) * 1e3)
                if status != 200 or len(data["results"]) != BATCH:
                    fail(f"mesh serving ({meshed}): /batch-predict {status}")
                answers.update({r["transaction_id"]: r for r in data["results"]})
            wall = time.perf_counter() - t0
            _, info = srv.request("GET", "/model-info")
            _, prom = srv.request("GET", "/metrics/prometheus")
        torch.cuda.synchronize()
        got = ops.launch_counts()
        factor = 4 if meshed else 1
        want = {k: factor * v for k, v in chain.items()}
        if any(b["launches"] != want for b in batches) or len(batches) != MESH_SERVE_BATCHES:
            fail(f"mesh serving ({meshed}): launches a batch "
                 f"{[b['launches'] for b in batches]}, expected {want}")
        geometry = {"data": 4, "model": 2, "seq": 1} if meshed else \
            {"data": 1, "model": 1, "seq": 1}
        if info["mesh"] != geometry or meshed != ("mesh_model_axis_size 2" in prom):
            fail(f"mesh serving ({meshed}): /model-info mesh {info['mesh']}")
        if meshed:
            launches = got
        runs.append(dict(meshed=meshed, answers=answers, txn_per_s=len(answers) / wall,
                         p50=float(np.percentile(lat, 50)), p99=float(np.percentile(lat, 99))))
    ref = runs[0]["answers"]
    gaps = []
    for run in runs[1:]:
        if run["answers"].keys() != ref.keys():
            fail("mesh serving: the runs answered different transactions")
        for tid, r in run["answers"].items():
            q = ref[tid]
            if (r["decision"], r["risk_level"]) != (q["decision"], q["risk_level"]):
                fail(f"mesh serving: {tid} {r['decision']} against {q['decision']}")
            gaps.append(abs(r["fraud_score"] - q["fraud_score"]))
    if max(gaps) != 0.0:
        fail(f"mesh serving: largest score gap {max(gaps):.3e}, not 0 (the 64-row "
             f"shards' rows differ from the {BATCH}-row batch's with split-K off)")
    print(f"mesh serving (DistilBERT-base full(), {MESH_SERVE_BATCHES} /batch-predict of "
          f"{BATCH}, unmeshed / meshed / meshed / unmeshed, split-K off): decisions equal on all "
          f"{len(ref)} ids, largest score gap {max(gaps):.3e}; launches a meshed batch "
          f"4 x {chain}; txn/s " + " / ".join(f"{r['txn_per_s']:.1f}" for r in runs)
          + "; batch p50 / p99 ms " + " / ".join(f"{r['p50']:.1f}/{r['p99']:.1f}"
                                                  for r in runs), flush=True)
    return launches


def run_mesh_parallel(ops):
    """Phase 24(c): the parallel layer at TINY width on ``MESH_DEVICES``
    against its single-position versions: ring attention at seq=4, the MoE
    FFN, ``bert_pipeline_encode`` with the flash-attention kernel (launch
    counters reset just before, read just after), the DP + TP train step's
    loss."""
    import numpy as np

    from realtime_fraud_detection_tpu_torch.core.mesh import MeshConfig, build_mesh, tree_map
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG, bert_encode
    from realtime_fraud_detection_tpu_torch.ops.attention import attention_reference
    from realtime_fraud_detection_tpu_torch.parallel import (
        MoEConfig,
        bert_pipeline_encode,
        init_moe_params,
        init_train_state,
        joint_loss,
        make_train_step,
        moe_ffn,
        moe_ffn_reference,
        ring_attention,
    )
    from realtime_fraud_detection_tpu_torch.parallel.train import tiny_train_setup

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    res = {}
    q, k, v = (torch.randn(8, 2, 64, TINY_CONFIG.head_dim, device="cuda", generator=g)
               for _ in range(3))
    mask = torch.ones(8, 64, dtype=torch.bool, device="cuda")
    mask[:, 50:] = False
    res["ring_attention"] = float((ring_attention(build_mesh(MeshConfig(seq=4), MESH_DEVICES),
                                                  q, k, v, mask)
                                   - attention_reference(q, k, v, mask)).abs().max())
    cfg = MoEConfig(8, 16, 32, 8.0)
    mp = {key: t.cuda() for key, t in init_moe_params(SEED, cfg).items()}
    x = torch.randn(64, 16, device="cuda", generator=g)
    res["moe_ffn"] = float((moe_ffn(build_mesh(MeshConfig(model=4), MESH_DEVICES), mp, x, cfg)
                            - moe_ffn_reference(mp, x)).abs().max())
    models = seeded_models(TINY_CONFIG)
    bert = tree_map(lambda t: t.cuda(), models.bert)
    ids = torch.randint(0, TINY_CONFIG.vocab_size, (8, 64), device="cuda", generator=g)
    ids = ids.to(torch.int32)
    mask = torch.rand(8, 64, device="cuda", generator=g) > 0.3
    mask[:, 0] = True
    mesh2 = build_mesh(MeshConfig(model=2), MESH_DEVICES)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    piped = bert_pipeline_encode(mesh2, bert, ids, mask, TINY_CONFIG, n_micro=4,
                                 use_flash=True)
    torch.cuda.synchronize()
    pipe_launches = ops.launch_counts()
    res["bert_pipeline_encode"] = float(
        (piped - bert_encode(bert, ids, mask, TINY_CONFIG, use_flash=True)).abs().max())
    params, batch = tiny_train_setup(16)
    state = init_train_state(mesh2, params, lambda ps: torch.optim.SGD(ps, lr=0.1))
    _, metrics = make_train_step(bert_config=TINY_CONFIG)(state, batch)
    single = float(joint_loss(tree_map(lambda t: torch.as_tensor(t).cuda(), params),
                              tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a))
                                       .cuda(), batch), TINY_CONFIG)[0])
    res["train_step_loss"] = [metrics["loss"], single]
    if res["ring_attention"] > 2e-5 or res["moe_ffn"] > 2e-5 \
            or res["bert_pipeline_encode"] > ENCODER_TOL \
            or abs(metrics["loss"] - single) > 2e-4 * abs(single):
        fail(f"parallel layer on the card: {json.dumps(res)}")
    # 8 positions x (4 microbatches + 1 stage of fill) ticks, one layer a tick
    if pipe_launches != {**{k: 0 for k in pipe_launches}, "flash_attention": 40}:
        fail(f"bert_pipeline_encode: launches {pipe_launches}")
    print(f"parallel layer at TINY on 8 positions of the card: {json.dumps(res)} "
          f"(bounds 2e-5, 2e-5, {ENCODER_TOL}, rtol 2e-4); bert_pipeline_encode launches "
          f"{pipe_launches}", flush=True)
    return pipe_launches


def cublas_bf16_ms() -> float:
    """A bf16 product at M=16384 (``dequant_matmul``'s cuBLAS yardstick),
    mean ms over one DistilBERT-base layer's six sites by CUDA events, 20
    launches after 3 of warm-up: what split-K off costs cuBLAS, timed once in
    each process."""
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    times = []
    for k, n in [(768, 768)] * 4 + [(768, 3072), (3072, 768)]:
        x = torch.randn(16384, k, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(k, n, device="cuda", generator=g).to(torch.bfloat16)
        for _ in range(3):
            torch.matmul(x, w)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            torch.matmul(x, w)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 20)
    return sum(times) / len(times)


def run_mesh_child(ops):
    """Phase 24 in the process ``MESH_CHILD`` starts: (a) and (c) at once,
    then (b) once a line on standard input says that this process is alone
    on the card, and the split-K-off cuBLAS time. Returns the launches of
    their kernel paths and their seconds."""
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator

    t0 = time.perf_counter()
    launches = run_mesh_drills(ops)
    mesh_kernel_parity(ops)
    t_a = time.perf_counter() - t0
    launches["mesh_pipeline_flash"] = run_mesh_parallel(ops)
    res = {"a_s": round(t_a, 1), "c_s": round(time.perf_counter() - t0 - t_a, 1)}
    sys.stdin.readline()
    t1 = time.perf_counter()
    launches["mesh_serving_distilbert_base"] = run_mesh_serving(ops, TransactionGenerator(
        num_users=MESH_USERS, num_merchants=MESH_MERCHANTS, seed=SEED + 24))
    res["b_s"] = round(time.perf_counter() - t1, 1)
    res["cublas_bf16_ms"] = cublas_bf16_ms()
    return {"launches": launches, **res}


# phase 24's process: cuBLAS's split-K is turned off before its first product
# (the mesh's contract, as ``mesh-drill`` and a meshed ``serve`` turn it
# off), while this process keeps cuBLAS's defaults for every other phase
MESH_CHILD = """
import json
from realtime_fraud_detection_tpu_torch.core.precision import batch_invariant_blas
batch_invariant_blas()
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from realtime_fraud_detection_tpu_torch import ops
from realtime_fraud_detection_tpu_torch.ops.build import kernel_library
kernel_library()
print(json.dumps(cs.run_mesh_child(ops)), flush=True)
"""


def start_mesh_phase():
    """Phase 24 starts: ``MESH_CHILD`` ((a) and (c), then (b) when told) and
    the two-process step (d), each of their own, beside phase 17 (whose
    checks read no clock). ``finish_mesh_phase`` collects them. The child
    writes to files, so it never waits on a full pipe."""
    import os
    import tempfile
    import threading

    from realtime_fraud_detection_tpu_torch.parallel.train import run_two_process_step

    two_proc = {}
    worker = threading.Thread(target=lambda: two_proc.update(
        run_two_process_step(2, 2, "cuda")), name="two-process-step")
    worker.start()
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    child = subprocess.Popen([sys.executable, "-c", MESH_CHILD], stdin=subprocess.PIPE,
                             stdout=out, stderr=err, text=True,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
    return dict(t0=time.perf_counter(), child=child, out=out, err=err, worker=worker,
                two_proc=two_proc)


def finish_mesh_phase(started):
    """Once this process has nothing else on the card: waits for (d), tells
    ``MESH_CHILD`` to run (b) alone, waits for it, prints what they found
    and the bf16 cuBLAS product's time here (cuBLAS's defaults) beside its
    time there (split-K off). Returns the launches of their kernel paths."""
    started["worker"].join(600)
    two_proc = started["two_proc"]
    child = started["child"]
    if started["worker"].is_alive() or not two_proc.get("passed"):
        child.kill()
        fail(f"two-process gloo step on the card: {json.dumps(two_proc)}")
    print(f"two-process gloo step on the card ({two_proc['seconds']} s): "
          + json.dumps(two_proc["processes"]), flush=True)
    t_go = time.perf_counter()
    try:
        child.communicate("go\n", timeout=900)
    except subprocess.TimeoutExpired:
        child.kill()
        child.communicate()
    started["out"].seek(0)
    started["err"].seek(0)
    lines = started["out"].read().strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if child.returncode != 0 or not lines:
        fail(f"phase 24's process: exit {child.returncode}: "
             f"{started['err'].read()[-4000:]}")
    res = json.loads(lines[-1])
    defaults = cublas_bf16_ms()
    print(f"phase 24 (a) {res['a_s']} s and (c) {res['c_s']} s in their process, beside "
          f"phase 17; (b) {res['b_s']} s there alone, {time.perf_counter() - t_go:.1f} s "
          f"after phase 17 ended; cuBLAS bf16 product at M=16384 (one DistilBERT-base "
          f"layer's six sites, CUDA events): {defaults:.4f} ms with cuBLAS's defaults (this "
          f"process), {res['cublas_bf16_ms']:.4f} ms with split-K off (phase 24's process)",
          flush=True)
    return res["launches"]


def run_mesh_phase(ops):
    """Phase 24 alone: (a), (c), (d) and (b). Returns the launches of its
    kernel paths."""
    return finish_mesh_phase(start_mesh_phase())


def run_drills() -> dict:
    """The port's kernel drill (``KernelDrillConfig.fast()``) on the card,
    once on the per-site chain and once on the megakernel; a verdict that is
    not passed fails the run."""
    import dataclasses

    from realtime_fraud_detection_tpu_torch.scoring.kernel_drill import (
        KernelDrillConfig,
        compact_kernel_summary,
        run_kernel_drill,
    )

    verdicts = {}
    for mega in (False, True):
        name = "mega" if mega else "chain"
        t0 = time.perf_counter()
        summary = run_kernel_drill(dataclasses.replace(
            KernelDrillConfig.fast(), mega=mega, device="cuda"))
        verdicts[name] = compact_kernel_summary(summary)
        print(f"kernel drill, {name} ({time.perf_counter() - t0:.1f} s): "
              + json.dumps(verdicts[name]), flush=True)
        print(f"  divergence {json.dumps(summary['divergence'])}; rungs "
              f"{json.dumps(summary['rungs'])}; oracle "
              f"{json.dumps(summary['kernel_oracle'])}"
              + (f"; mega {json.dumps(summary['mega_oracle'])}" if mega else ""),
              flush=True)
        if not summary["passed"]:
            fail(f"kernel drill ({name}) did not pass: {verdicts[name]['checks']}")
    return verdicts


def profile_slice(scorer, batch, records, n_batches: int = 5):
    """Device time by kernel over a few batches (torch.profiler, CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_batches):
            scorer.finalize(scorer.dispatch_assembled(batch, records))
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profile over {n_batches} batches: device busy {busy_us / n_batches / 1e3:.3f}"
          f" ms/batch of {wall_us / n_batches / 1e3:.3f} ms wall "
          f"(idle share {1 - busy_us / wall_us:.3f})", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / n_batches / 1e3:8.3f} ms/batch "
              f"{e.count / n_batches:6.1f} launches/batch  {e.key[:90]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is still on")
    # wall seconds by phase, printed before the kernel line
    seconds, t_phase = {}, [time.perf_counter()]

    def lap(label):
        now = time.perf_counter()
        seconds[label] = round(now - t_phase[0], 1)
        t_phase[0] = now

    from realtime_fraud_detection_tpu_torch import ops
    from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
    from realtime_fraud_detection_tpu_torch.models.bert import DISTILBERT_BASE, TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.ops.build import build_library, kernel_library
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES
    from realtime_fraud_detection_tpu_torch.utils.config import Config, KernelSettings

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    lib = build_library(verbose=True)
    kernel_library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(SEED)
    params = EnsembleParams.from_config(Config(), MODEL_NAMES).to("cuda")
    entries = [
        check_epilogue(params, gen),
        check_attention(DISTILBERT_BASE, gen),
        check_dequant_matmul(DISTILBERT_BASE, cpu_gen),
        check_dequant_rows(DISTILBERT_BASE, cpu_gen),
        check_megakernel(params),
    ]
    for e in entries:
        dev = f", device {e['device_ms']:.4f} ms" if "device_ms" in e else ""
        print(f"kernel {e['name']}: max_abs_err {e['max_abs_err']:.3e}, "
              f"{e['ms']:.4f} ms{dev} (plain {e['plain_ms']:.4f} ms, bound "
              f"{e['bound_ms']:.4f} ms by {e['bound_by']}, library "
              f"{e['library_ms']}) -- {e.pop('note')}", flush=True)

    lap("1-3")
    launches = run_slice(ops)
    launches["megakernel"] = run_mega_slice(ops, params)["megakernel"]
    lap("4-7")
    chain = {"epilogue": 1, "flash_attention": DISTILBERT_BASE.num_layers,
             "dequant_matmul": 6 * DISTILBERT_BASE.num_layers, "dequant_rows": 2,
             "megakernel": 0}
    tiny = run_stream(ops, "TINY", TINY_CONFIG, KernelSettings.mega(), 16 * BATCH,
                      {k: int(k == "megakernel") for k in chain}, cpu_reference=True)
    word = run_stream(ops, "DistilBERT-base", DISTILBERT_BASE, KernelSettings.full(),
                      4 * BATCH, chain, cpu_reference=False)
    stream = {"tiny": tiny["launches"], "distilbert_base": word["launches"]}
    lap("8")
    stream["tiny_typed"] = run_typed_stream(ops)
    lap("9")
    stream["tiny_overlap"] = run_overlap(ops)
    lap("10")
    run_drills()
    lap("11")
    stream["distilbert_base_wordpiece"] = run_wordpiece_stream(ops, chain, word)
    lap("12")
    qos = run_qos(ops)
    stream["tiny_qos"] = qos["launches"]
    lap("13")
    stream["tiny_traced"] = run_traced_stream(ops)
    lap("14a")
    stream["tiny_qos_slo"] = run_qos_slo(ops, qos["rungs"])
    lap("14b")
    stream.update(run_autotune(ops))
    lap("15")
    stream.update(run_serving(ops))
    lap("16")
    mesh_started = start_mesh_phase()
    stream.update(run_training(ops))
    lap("17")
    stream.update(finish_mesh_phase(mesh_started))
    lap("24: (b), and the wait for (a), (c) and (d), after 17")
    stream.update(run_feedback(ops))
    lap("18")
    stream.update(run_deployed_phase(ops))
    lap("19")
    stream.update(run_state_phase(ops))
    lap("20")
    stream.update(run_pool_phase(ops))
    lap("21")
    stream.update(run_chaos_phase(ops))
    lap("22")
    stream.update(run_graph_phase(ops))
    lap("23")
    print(f"seconds by phase: {json.dumps(seconds)}", flush=True)
    for e in entries:
        e["stream_launches"] = {k: v[e["name"]] for k, v in stream.items()}
    extra = ("device_ms", "empty_ms", "empty_device_ms", "host_ms", "tail_launches",
             "sites", "timing", "stream_launches")
    kernels = [{"name": e["name"], "route": e["route"], "source": e["source"],
                "replaces": e["replaces"], "launches": launches[e["name"]],
                "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                "bound_by": e["bound_by"], "library_ms": e["library_ms"],
                **{k: e[k] for k in extra if k in e}}
               for e in entries]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
