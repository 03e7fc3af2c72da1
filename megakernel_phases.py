#!/usr/bin/env python3
"""Where the megakernel's device time goes, phase by phase, on one CUDA card.

Run from the repository root on a machine with an H100:

    python3 megakernel_phases.py [--queries 8]

It builds the kernels with ``-DMEGA_PHASES`` through the package's own
build (``ops/build.py set_defines``, into the gitignored ``build/``). In
that build ``csrc/megakernel.cu``'s ``MEGA_PHASE()`` marks become stamps:
at every phase boundary of the bf16 kernel all threads meet at a barrier
and thread 0 of block 0 records ``%globaltimer``: the start of its first
row group, before and after the LSTM, after the GNN, after the embeddings'
LN, after each dense layer, attention and LN of every BERT layer, and after
BERT. The TINY int8 megakernel then runs at buckets 256 and 8 (held against
its plain version first), and the script prints the microseconds of each
phase of block 0's first group, with the profiler's device ms per launch of
the instrumented kernel beside them. The stamps add barriers, so compare
phases within one run.

``--queries`` builds the kernel with another ``MEGA_ATT_Q`` (queries an
attention warp takes), so two attention designs can be compared.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import torch

import chip_smoke as cs

LAYER_PHASES = ("q", "k", "v", "attn", "o", "ln1", "ffn1", "ffn2", "ln2")


def phase_labels(layers: int) -> list[str]:
    """The phases between consecutive stamps of one row group."""
    return (["rules+trees+forest", "lstm", "gnn", "embeddings+ln"]
            + [f"L{li}.{p}" for li in range(layers) for p in LAYER_PHASES]
            + ["cls head"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--queries", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("megakernel_phases: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
    from realtime_fraud_detection_tpu_torch.ops import build as bd
    from realtime_fraud_detection_tpu_torch.ops import megakernel as mk
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES
    from realtime_fraud_detection_tpu_torch.utils.config import Config

    print(f"variant: {args.queries} queries an attention warp", flush=True)
    bd.set_defines("MEGA_PHASES", f"MEGA_ATT_Q={args.queries}")
    read = bd.kernel_library().rtfd_megakernel_phases
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    params = EnsembleParams.from_config(Config(), MODEL_NAMES).to("cuda")
    models, _ = cs.mega_models()
    labels = phase_labels(TINY_CONFIG.num_layers)
    buf, n = (ctypes.c_ulonglong * 256)(), ctypes.c_int()
    for rows in (cs.BATCH, 8):
        batch, _, _, raw, plain = cs.mega_batch(rows)

        def call():
            return mk.fused_megakernel(models, raw, params, mega_valid=(True,) * 5,
                                       bert_config=TINY_CONFIG)

        ref = mk.megakernel_reference(models, plain, params, mega_valid=(True,) * 5,
                                      bert_config=TINY_CONFIG)
        err = float((call() - ref).abs().max())
        tol = cs.noise_bound(models, TINY_CONFIG, [(batch.token_ids, batch.token_mask)],
                             params.weights)
        if not err <= tol:
            raise RuntimeError(f"instrumented megakernel b={rows}: err {err} (bound {tol})")
        device_ms = cs.device_ms(call)[0]
        torch.cuda.synchronize()
        bd.check_launch("rtfd_megakernel_phases", read(buf, ctypes.byref(n)))   # clear
        call()
        torch.cuda.synchronize()
        bd.check_launch("rtfd_megakernel_phases", read(buf, ctypes.byref(n)))
        stamps = list(buf)[:n.value]
        if not stamps or len(stamps) % (len(labels) + 1):
            raise RuntimeError(f"{len(stamps)} stamps for {len(labels)} phases a group")
        stamps = stamps[:len(labels) + 1]          # block 0's first row group
        print(f"b={rows}: max err {err:.3e}; instrumented kernel {device_ms:.4f} ms device "
              f"per launch; block 0, first group: {(stamps[-1] - stamps[0]) / 1e3:.1f} us",
              flush=True)
        for label, t0, t1 in zip(labels, stamps, stamps[1:]):
            print(f"  {label:20s} {(t1 - t0) / 1e3:8.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
